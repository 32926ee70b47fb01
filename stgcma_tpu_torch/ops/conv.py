"""Patch-embedding convolutions in the JAX package's channel-last layout.

Port of `stgcma_tpu/ops/conv.py::conv2d` (the CLIP patch embed) and
`conv3d` (:59, the Swin patch embed): the public layout stays channel-last in
and out, and the weight is kept in torch's (O, I, ...) layout. The permutes
to and from channel-first happen inside the functions. Plain torch, as the
JAX package leaves convolutions to XLA.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def conv2d(weight: torch.Tensor, x: torch.Tensor, stride: int) -> torch.Tensor:
    """Bias-free conv, VALID padding. x: (B, H, W, C_in) -> (B, H', W', C_out);
    weight: (C_out, C_in, kh, kw)."""
    y = F.conv2d(x.permute(0, 3, 1, 2), weight.to(x.dtype), stride=stride)
    return y.permute(0, 2, 3, 1)


def conv3d(weight: torch.Tensor, bias, x: torch.Tensor, stride) -> torch.Tensor:
    """VALID conv. x: (B, D, H, W, C_in) -> (B, D', H', W', C_out); weight:
    (C_out, C_in, kd, kh, kw); bias (C_out,) or None, added after the
    product in x's dtype, as the JAX package does."""
    y = F.conv3d(x.permute(0, 4, 1, 2, 3), weight.to(x.dtype), stride=tuple(stride))
    y = y.permute(0, 2, 3, 4, 1)
    return y if bias is None else y + bias.to(y.dtype)
