"""Bilinear and bicubic resizes with torch's semantics, in the channel-last
layout.

Port of `stgcma_tpu/ops/resize.py`: `resize_bilinear` (:28), the AVS
decoder's upsampling, with `align_corners` True (the feature-fusion blocks)
or False (the output head); `resize_bicubic` (:68), the AVQA frames' protocol
resize; `interpolate_scale2_bilinear` (:86) and `adaptive_avg_pool` (:91).
The JAX package builds these conventions in float32 from gathers and lerps
(bicubic: 4 taps, A = -0.75, each tap index clamped, no antialias), which
re-derives torch's `upsample_bilinear2d` / `upsample_bicubic2d`. In float32
the source coordinates themselves round (one step at 600 is 6e-5), and
F.interpolate orders that arithmetic otherwise: on a 360x640 -> 224 resize of
[0, 1] values it lands up to 8e-5 from the JAX package. So the frame
transforms (data/transforms.py) take `resize_bilinear_taps` and
`resize_bicubic`, which keep the JAX arithmetic step for step (index_select
for the gathers). The AVS decoder's `resize_bilinear` stays one
F.interpolate on a channel-first float32 view (torch's `channels_last`
memory format: no copy of the layout): its maps are at most 112 wide, where
the two agree to 1e-5, and at its largest resize, (40, 112, 112, 128) ->
224^2 in float32, the four gathers and two lerps write some 6 GB of
intermediates where F.interpolate writes its 1 GB output once.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def _axis_weights(in_size: int, out_size: int, align_corners: bool, device):
    """Bilinear source taps (lo, hi) and weights along one axis, with the
    source coordinate clamped to the input (`resize.py:15`)."""
    i = torch.arange(out_size, dtype=torch.float32, device=device)
    if align_corners and out_size > 1:
        src = i * (in_size - 1) / (out_size - 1)
    else:
        src = ((i + 0.5) * (in_size / out_size) - 0.5).clamp(0.0, in_size - 1)
    lo = torch.floor(src).long()
    hi = torch.clamp(lo + 1, max=in_size - 1)
    return lo, hi, src - lo.float()


def _cubic_axis_weights(in_size: int, out_size: int, align_corners: bool, device):
    """Bicubic taps at i0 - 1 .. i0 + 2, each clamped to the input (the
    source coordinate is not), and torch's cubic-convolution weights with
    A = -0.75, the last one 1 - (w0 + w1 + w2) (`resize.py:42`)."""
    i = torch.arange(out_size, dtype=torch.float32, device=device)
    if align_corners and out_size > 1:
        src = i * (in_size - 1) / (out_size - 1)
    else:
        src = (i + 0.5) * (in_size / out_size) - 0.5
    i0 = torch.floor(src)
    t = src - i0
    A = -0.75
    w0 = ((A * (t + 1) - 5 * A) * (t + 1) + 8 * A) * (t + 1) - 4 * A
    w1 = ((A + 2) * t - (A + 3)) * t * t + 1
    u = 1 - t
    w2 = ((A + 2) * u - (A + 3)) * u * u + 1
    w3 = 1.0 - w0 - w1 - w2
    base = i0.long()
    return [torch.clamp(base + d, 0, in_size - 1) for d in (-1, 0, 1, 2)], (w0, w1, w2, w3)


def resize_bilinear(x: torch.Tensor, out_h: int, out_w: int,
                    align_corners: bool = False) -> torch.Tensor:
    """x: (..., H, W, C) -> (..., out_h, out_w, C) by F.interpolate, computed
    in float32 and cast back to x's dtype; no antialiasing."""
    lead, (H, W, C) = x.shape[:-3], x.shape[-3:]
    xf = x.reshape(-1, H, W, C).float().permute(0, 3, 1, 2)
    y = F.interpolate(xf, size=(out_h, out_w), mode="bilinear", align_corners=align_corners)
    return y.permute(0, 2, 3, 1).to(x.dtype).reshape(*lead, out_h, out_w, C)


def resize_bilinear_taps(x: torch.Tensor, out_h: int, out_w: int,
                         align_corners: bool = False) -> torch.Tensor:
    """`resize_bilinear` on the JAX package's float32 arithmetic (its
    `resize_bilinear`, :28): the frame transforms' resize."""
    xf = x.float()
    lo_h, hi_h, wh = _axis_weights(x.shape[-3], out_h, align_corners, x.device)
    lo_w, hi_w, ww = _axis_weights(x.shape[-2], out_w, align_corners, x.device)
    top, bot = xf.index_select(-3, lo_h), xf.index_select(-3, hi_h)
    rows = top + (bot - top) * wh[:, None, None]
    left, right = rows.index_select(-2, lo_w), rows.index_select(-2, hi_w)
    return (left + (right - left) * ww[:, None]).to(x.dtype)


def resize_bicubic(x: torch.Tensor, out_h: int, out_w: int,
                   align_corners: bool = False) -> torch.Tensor:
    """x: (..., H, W, C) -> (..., out_h, out_w, C) with torch's bicubic
    (A = -0.75, border-replicated taps, no antialias), separable, on the JAX
    package's float32 arithmetic, cast back to x's dtype."""
    xf = x.float()
    idx_h, w_h = _cubic_axis_weights(x.shape[-3], out_h, align_corners, x.device)
    rows = sum(xf.index_select(-3, ih) * w[:, None, None] for ih, w in zip(idx_h, w_h))
    idx_w, w_w = _cubic_axis_weights(x.shape[-2], out_w, align_corners, x.device)
    out = sum(rows.index_select(-2, iw) * w[:, None] for iw, w in zip(idx_w, w_w))
    return out.to(x.dtype)


def interpolate_scale2_bilinear(x: torch.Tensor, align_corners: bool = True) -> torch.Tensor:
    """F.interpolate(scale_factor=2, mode='bilinear') on (..., H, W, C)."""
    return resize_bilinear(x, x.shape[-3] * 2, x.shape[-2] * 2, align_corners)


def adaptive_avg_pool(x: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """torch's AdaptiveAvgPool2d on (..., H, W, C) for divisible sizes."""
    H, W = x.shape[-3], x.shape[-2]
    assert H % out_h == 0 and W % out_w == 0, "adaptive pool requires divisible sizes"
    kh, kw = H // out_h, W // out_w
    return x.reshape(*x.shape[:-3], out_h, kh, out_w, kw, x.shape[-1]).mean(dim=(-4, -2))
