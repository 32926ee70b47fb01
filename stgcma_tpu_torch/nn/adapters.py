"""Bottleneck adapters — the only trainable compute inside frozen blocks.

Port of `stgcma_tpu/nn/adapters.py`. D_fc2 is zero-initialized, so a fresh
adapter is a no-op.
"""
from __future__ import annotations

from torch import nn

from ..ops.common import Linear, gelu, linear


class Adapter(nn.Module):
    def __init__(self, dim: int, mlp_ratio: float):
        super().__init__()
        hidden = int(dim * mlp_ratio)
        self.D_fc1 = Linear(dim, hidden)
        self.D_fc2 = Linear(hidden, dim)


def adapter_apply(p: Adapter, x, skip: bool):
    """skip=True -> SAdapter2 (residual); skip=False -> Adapter/T_Adapter."""
    xs = linear(p.D_fc2, gelu(linear(p.D_fc1, x)))
    return x + xs if skip else xs


def adapter_hidden(p: Adapter, x):
    """Hidden state after D_fc1 + GELU — the STG-CMA fusion operand."""
    return gelu(linear(p.D_fc1, x))


def adapter_out(p: Adapter, hidden):
    """Project the fused hidden back up."""
    return linear(p.D_fc2, hidden)
