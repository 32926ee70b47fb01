"""Convolutions and batch norm in the JAX package's channel-last layout.

Port of `stgcma_tpu/ops/conv.py`: `conv2d` (:45, the CLIP patch embed and
the AVS decoder's and PVT's convolutions, with bias, integer padding,
dilation and groups), `conv3d` (:59, the Swin patch embed), `batchnorm_init`
(:71), `batchnorm` (:80) and `batchnorm_train` (:89). The public layout
stays channel-last in and out, and a weight is kept in torch's (O, I, ...)
layout. The permutes to and from channel-first inside the functions are
views: a channel-last tensor seen as (B, C, H, W) is in torch's
`channels_last` memory format, which the convolution keeps, so a chain of
these calls makes no layout copies. Plain torch, as the JAX package leaves
convolutions to XLA.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..runtime.mesh import current_shard, sum_rows


class Conv2d(nn.Module):
    """2-D conv parameters: weight (C_out, C_in, kh, kw), bias (C_out,) or None."""

    def __init__(self, c_in: int, c_out: int, kernel_size: int, bias: bool = True):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(c_out, c_in, kernel_size, kernel_size))
        self.bias = nn.Parameter(torch.zeros(c_out)) if bias else None


class BatchNorm(nn.Module):
    """Batch-norm affine parameters (`weight`, `bias`: the JAX tree's `scale`
    and `bias`) and running statistics (buffers `running_mean`,
    `running_var`: the JAX tree's `mean` and `var`); `batchnorm_init`:
    scale 1, bias 0, mean 0, var 1."""

    def __init__(self, ch: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(ch))
        self.bias = nn.Parameter(torch.zeros(ch))
        self.register_buffer("running_mean", torch.zeros(ch))
        self.register_buffer("running_var", torch.ones(ch))


def conv2d(weight: torch.Tensor, x: torch.Tensor, stride: int = 1, padding: int = 0,
           dilation: int = 1, bias=None, groups: int = 1) -> torch.Tensor:
    """x: (B, H, W, C_in) -> (B, H', W', C_out); weight: (C_out, C_in /
    groups, kh, kw), cast to x's dtype; `padding` zeros on every side;
    `groups` as JAX's `feature_group_count` (PVT's depthwise conv). The
    bias, if any, is added after the product in the output's dtype, as the
    JAX package does (:54-55)."""
    y = F.conv2d(x.permute(0, 3, 1, 2), weight.to(x.dtype), stride=stride, padding=padding,
                 dilation=dilation, groups=groups)
    y = y.permute(0, 2, 3, 1)
    return y if bias is None else y + bias.to(y.dtype)


def conv3d(weight: torch.Tensor, bias, x: torch.Tensor, stride) -> torch.Tensor:
    """VALID conv. x: (B, D, H, W, C_in) -> (B, D', H', W', C_out); weight:
    (C_out, C_in, kd, kh, kw); bias (C_out,) or None, added after the
    product in x's dtype, as the JAX package does."""
    y = F.conv3d(x.permute(0, 4, 1, 2, 3), weight.to(x.dtype), stride=tuple(stride))
    y = y.permute(0, 2, 3, 4, 1)
    return y if bias is None else y + bias.to(y.dtype)


def batchnorm(p: BatchNorm, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Inference-mode batch norm over the last (channel) axis, in float32,
    cast back. The statistics stay in the dtype they are kept in, so on a
    bf16 server `var + eps` and its rsqrt round in bf16, as in the JAX
    package."""
    xf = x.float()
    inv = torch.rsqrt(p.running_var + eps)
    y = (xf - p.running_mean) * inv * p.weight + p.bias
    return y.to(x.dtype)


def batchnorm_train(p: BatchNorm, x: torch.Tensor, eps: float = 1e-5, momentum: float = 0.1):
    """Training-mode batch norm over every axis but the last, torch's
    semantics: the biased batch variance normalizes, the unbiased one
    enters the running update. Returns (y in x's dtype, {"mean", "var"}: the
    momentum-updated running statistics in float32). Inside a mesh step
    (`runtime/mesh.py::data_parallel`) x holds this rank's rows, and the
    mean and the variance are the global batch's: each sum is summed over
    'data' and divided by the global count, as XLA computes them over the
    whole logical batch (one process divides its own sums the same way, so a
    mesh of one computes its bits)."""
    xf = x.float()
    rows = xf.reshape(-1, xf.shape[-1])
    n = rows.shape[0] * (1 if current_shard() is None else current_shard().count)
    mean = sum_rows(rows.sum(dim=0)) / n
    var = sum_rows((rows - mean).square().sum(dim=0)) / n
    unbiased = var * n / max(n - 1, 1)
    y = (xf - mean) * torch.rsqrt(var + eps) * p.weight + p.bias
    stats = {"mean": (1 - momentum) * p.running_mean + momentum * mean,
             "var": (1 - momentum) * p.running_var + momentum * unbiased}
    return y.to(x.dtype), stats
