"""The one generator of every traffic mix: a mix's data file names its
mode, its batch, how many distinct batches it cycles through (`pool`), and
each input's shape and distribution; this draws the pool from the seed on
the device, in one call an input, and hands each batch over in pinned host
memory, as a DataLoader with pin_memory gives a batch to the model.

An input's spec: {"shape": [..., "B" for the batch, ...], "dtype": ...,
"dist": one of
- "normal" (mean, std),
- "uniform" (low, high),
- "randint" (high: integers in [0, high)),
- "onehot" (classes: one class a row over the last axis, float32)}.
"""
from __future__ import annotations

from typing import Dict, List

import torch

DTYPES = {"float32": torch.float32, "uint8": torch.uint8, "int64": torch.int64}


def _draw(spec: dict, shape, g: torch.Generator, device) -> torch.Tensor:
    dist = spec["dist"]
    if dist == "normal":
        x = torch.randn(shape, generator=g, device=device) * spec["std"] + spec.get("mean", 0.0)
    elif dist == "uniform":
        lo, hi = spec["low"], spec["high"]
        x = torch.rand(shape, generator=g, device=device) * (hi - lo) + lo
    elif dist == "randint":
        x = torch.randint(0, spec["high"], shape, generator=g, device=device)
    elif dist == "onehot":
        idx = torch.randint(0, spec["classes"], shape[:-1], generator=g, device=device)
        x = torch.nn.functional.one_hot(idx, spec["classes"])
    else:
        raise ValueError(f"unknown distribution {dist!r}")
    return x.to(DTYPES[spec["dtype"]])


def batch_shape(spec: dict, B: int) -> tuple:
    return tuple(B if d == "B" else int(d) for d in spec["shape"])


def make_pool(mix: dict, seed: int, device, pin: bool = True) -> List[Dict[str, torch.Tensor]]:
    """`mix["pool"]` batches of `mix["batch"]` rows; every row of the pool is
    a fresh draw, so no two batches share a row."""
    g = torch.Generator(device=device).manual_seed(seed ^ 0x5EED)
    B, P = mix["batch"], mix["pool"]
    pool: List[Dict[str, torch.Tensor]] = [{} for _ in range(P)]
    for name, spec in mix["inputs"].items():
        shape = batch_shape(spec, B)
        whole = _draw(spec, (P * B,) + shape[1:], g, device).cpu()
        for i in range(P):
            t = whole[i * B:(i + 1) * B]
            pool[i][name] = t.pin_memory() if pin else t.clone()
    return pool

