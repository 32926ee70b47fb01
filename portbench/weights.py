"""The benchmark's own weights, drawn on the device from the seed.

Every leaf of a configuration is drawn in a few large calls on one device
generator: one normal draw for every leaf drawn from a normal, one uniform
draw for the rest, each leaf a view into them. The distributions keep
adapters, gates, bias tables and the fusion live:
- linear weights and biases, and anything not named below: N(0, 0.02);
- LayerNorm weights: 1 + N(0, 0.1);
- fusion gates, relative and temporal bias tables: N(0, 0.5);
- class, positional and temporal embeddings: N(0, C^-1/2);
- word embeddings: N(0, 1);
- patch convolutions (weight and bias): uniform(+-1/sqrt(fan_in));
- LSTM weights and biases: uniform(+-1/sqrt(hidden));
- the linears (weight and bias) under the prefixes a configuration lists
  as `fan_in_uniform`: uniform(+-1/sqrt(fan_in)), torch's default, which
  keeps a deep head off its tanh plateaus so that its answers follow the
  inputs.
"""
from __future__ import annotations

import math
import re
from typing import Dict, Tuple

import torch

_LN = re.compile(r"(^|\.)(ln_\w+|norm\d*)\.weight$")
_TABLE = re.compile(r"(gate_[av]|bias_table(_audio)?)$")
_CONV = re.compile(r"(conv1(_audio)?\.weight|patch_embed(_audio)?\.proj\.(weight|bias))$")


def _fan_in_bound(name: str, shapes: Dict[str, Tuple[int, ...]]) -> float:
    w = shapes[name.rsplit(".", 1)[0] + ".weight"]
    return 1.0 / math.sqrt(math.prod(w[1:]))


def distribution(name: str, shapes: Dict[str, Tuple[int, ...]],
                 fan_in_uniform: Tuple[str, ...] = ()) -> Tuple[str, float, float]:
    """("normal", mean, std) or ("uniform", -bound, bound) of one leaf."""
    shape = shapes[name]
    linear = name.rsplit(".", 1)[0] + ".weight" in shapes and len(
        shapes[name.rsplit(".", 1)[0] + ".weight"]) == 2
    if _CONV.search(name) or (linear and name.startswith(fan_in_uniform)
                              and not _LN.search(name) and ".lstm." not in name):
        b = _fan_in_bound(name, shapes)
        return "uniform", -b, b
    if ".lstm." in name:
        b = 1.0 / math.sqrt(shape[-1] if name.endswith("w_hh") else shape[0] // 4)
        return "uniform", -b, b
    if _LN.search(name):
        return "normal", 1.0, 0.1
    if _TABLE.search(name):
        return "normal", 0.0, 0.5
    if "embedding" in name:
        return "normal", 0.0, shape[-1] ** -0.5
    if name.endswith("word2vec"):
        return "normal", 0.0, 1.0
    return "normal", 0.0, 0.02


def draw(shapes: Dict[str, Tuple[int, ...]], seed: int, device,
         fan_in_uniform: Tuple[str, ...] = ()) -> Dict[str, torch.Tensor]:
    """{name: float32 tensor} for every leaf of `shapes`, from `seed`."""
    device = torch.device(device)
    g = torch.Generator(device=device).manual_seed(seed)
    groups: Dict[Tuple[str, float, float], list] = {}
    for name in shapes:
        groups.setdefault(distribution(name, shapes, fan_in_uniform), []).append(name)
    out = {}
    for kind in ("normal", "uniform"):
        keys = [k for k in groups if k[0] == kind]
        total = sum(math.prod(shapes[n]) for k in keys for n in groups[k])
        flat = (torch.randn if kind == "normal" else torch.rand)(
            total, generator=g, device=device)
        ofs = 0
        for k in keys:
            size = sum(math.prod(shapes[n]) for n in groups[k])
            seg = flat[ofs:ofs + size]
            if kind == "normal":
                seg.mul_(k[2]).add_(k[1])
            else:
                seg.mul_(k[2] - k[1]).add_(k[1])
            for n in groups[k]:
                numel = math.prod(shapes[n])
                out[n] = seg[:numel].view(shapes[n])
                seg = seg[numel:]
            ofs += size
    return out
