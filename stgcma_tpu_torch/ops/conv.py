"""Patch-embedding convolution in the JAX package's channel-last layout.

Port of `stgcma_tpu/ops/conv.py::conv2d` for the CLIP patch embed: the
public layout stays NHWC in and out, and the weight is kept in torch's OIHW.
The NHWC <-> NCHW permutes happen inside the function.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def conv2d(weight: torch.Tensor, x: torch.Tensor, stride: int) -> torch.Tensor:
    """Bias-free conv, VALID padding. x: (B, H, W, C_in) -> (B, H', W', C_out);
    weight: (C_out, C_in, kh, kw)."""
    y = F.conv2d(x.permute(0, 3, 1, 2), weight.to(x.dtype), stride=stride)
    return y.permute(0, 2, 3, 1)
