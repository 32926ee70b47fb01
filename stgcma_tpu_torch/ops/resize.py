"""Bilinear resize with torch's semantics, in the channel-last layout.

Port of `stgcma_tpu/ops/resize.py::resize_bilinear` (:28): the AVS decoder's
upsampling, with `align_corners` True (the feature-fusion blocks) or False
(the output head). The JAX package builds both conventions from a gather
and a lerp in float32; here `F.interpolate`, which defines them, runs on a
channel-first float32 view (torch's `channels_last` memory format: no copy
of the layout), and the result is cast back.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def resize_bilinear(x: torch.Tensor, out_h: int, out_w: int,
                    align_corners: bool = False) -> torch.Tensor:
    """x: (..., H, W, C) -> (..., out_h, out_w, C), computed in float32 and
    cast back to x's dtype; no antialiasing."""
    lead, (H, W, C) = x.shape[:-3], x.shape[-3:]
    xf = x.reshape(-1, H, W, C).float().permute(0, 3, 1, 2)
    y = F.interpolate(xf, size=(out_h, out_w), mode="bilinear", align_corners=align_corners)
    return y.permute(0, 2, 3, 1).to(x.dtype).reshape(*lead, out_h, out_w, C)
