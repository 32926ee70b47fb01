"""The evaluation half of the clip transforms, batched tensor math over
packed (..., T, H, W, C) clips on their own device.

Port of `stgcma_tpu/data/transforms.py`: `resize_short_side` (:32),
`center_crop` (:43), `normalize` (:49), `eval_transform` (:53),
`avqa_transform` (:60) and `avs_transform` (:72). The protocols:
- AVE (AVE/dataloader.py:159-164): short-side bilinear resize -> center crop
  -> /255 -> ImageNet normalize;
- AVQA (AVQA/dataloader.py:86-90): a direct (size, size) bicubic resize ->
  ImageNet normalize, train and eval alike;
- AVS (AVS/dataloader.py:65-72): /255 -> ImageNet normalize (frames come
  pre-sized).
The training half (RandAugment, random resized crop, random erasing, mixup)
is not ported yet.
"""
from __future__ import annotations

import numpy as np
import torch

from ..ops.resize import resize_bicubic, resize_bilinear_taps

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)


def resize_short_side(clip: torch.Tensor, size: int) -> torch.Tensor:
    """Bilinear resize (fp32) so that the short side is `size`. clip: (..., H, W, C)."""
    H, W = clip.shape[-3], clip.shape[-2]
    if H <= W:
        nh, nw = size, max(int(round(W * size / H)), size)
    else:
        nh, nw = max(int(round(H * size / W)), size), size
    return resize_bilinear_taps(clip.float(), nh, nw, align_corners=False)


def center_crop(clip: torch.Tensor, size: int) -> torch.Tensor:
    H, W = clip.shape[-3], clip.shape[-2]
    top, left = (H - size) // 2, (W - size) // 2
    return clip[..., top:top + size, left:left + size, :]


def normalize(clip01: torch.Tensor, mean=IMAGENET_MEAN, std=IMAGENET_STD) -> torch.Tensor:
    dev = clip01.device
    return (clip01 - torch.from_numpy(mean).to(dev)) / torch.from_numpy(std).to(dev)


def eval_transform(clip_uint8: torch.Tensor, size: int = 224) -> torch.Tensor:
    """(..., T, H, W, 3) uint8 -> (..., T, size, size, 3) normalized fp32."""
    x = center_crop(resize_short_side(clip_uint8, size), size)
    return normalize(x / 255.0)


def avqa_transform(clip_uint8: torch.Tensor, size: int = 224) -> torch.Tensor:
    """AVQA, train and eval: a direct (size, size) bicubic resize (aspect
    distorting, torch's interpolate) of /255 frames, then ImageNet normalize."""
    x = clip_uint8.float() / 255.0
    if x.shape[-3] != size or x.shape[-2] != size:
        x = resize_bicubic(x, size, size)
    return normalize(x)


def avs_transform(clip_uint8: torch.Tensor) -> torch.Tensor:
    """AVS, train and eval: ToTensor + ImageNet normalize only."""
    return normalize(clip_uint8.float() / 255.0)
