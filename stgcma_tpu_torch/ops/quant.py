"""int8 weights for frozen-tower serving.

Port of `stgcma_tpu/ops/quant.py` (quantize_weight, quantize_linear_params,
quantize_clip_tower). Weights are per-output-channel symmetric int8; the
activations are quantized per row inside the kernels K2/K3
(ops/fused_attn.py). The JAX package's XLA path `int8_matmul` is not ported:
it floors the activation scale at 1e-12 after an exact divide, while the
kernels floor at 1e-30 and multiply by a reciprocal.
"""
from __future__ import annotations

import copy

import torch
from torch import nn

from .common import Linear, QLinear


def quantize_weight(w: torch.Tensor):
    """(out, in) float -> (int8 (out, in), float32 scale (out,)).

    Same arithmetic as the JAX version: scale = max|w| / 127 over the input
    axis, floored at 1e-12, q = clip(round_half_even(w / scale), -127, 127)."""
    wf = w.float()
    s = wf.abs().amax(dim=1) / 127.0
    s = torch.clamp_min(s, 1e-12)
    q = torch.clamp(torch.round(wf / s[:, None]), -127, 127).to(torch.int8)
    return q, s


def quantize_linear_params(p: Linear) -> QLinear:
    out_f, in_f = p.weight.shape
    ql = QLinear(in_f, out_f).to(p.weight.device)
    q, s = quantize_weight(p.weight.detach())
    ql.weight_q.copy_(q)
    ql.weight_s.copy_(s)
    ql.bias.data.copy_(p.bias.detach().float())
    return ql


def quantize_clip_tower(backbone: nn.Module) -> nn.Module:
    """A copy of the CLIP backbone with every resblock's attention in/out
    projection and MLP c_fc/c_proj quantized to int8. Adapters, gates, LN and
    embeddings stay float; the blocks route on `quantized`
    (nn/clip_vit.py)."""
    out = copy.deepcopy(backbone)
    for blk in out.resblocks:
        blk.attn.in_proj = quantize_linear_params(blk.attn.in_proj)
        blk.attn.out_proj = quantize_linear_params(blk.attn.out_proj)
        blk.mlp.c_fc = quantize_linear_params(blk.mlp.c_fc)
        blk.mlp.c_proj = quantize_linear_params(blk.mlp.c_proj)
    return out
