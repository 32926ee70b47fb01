"""Swin window geometry: partition/reverse, relative-position index, shift mask.

Port of `stgcma_tpu/ops/window.py` (reference semantics: AVE/model/
Swin_AVE.py:130-159 partition/reverse, :186-201 relative position index,
:368-391 SW-MSA attention mask). The index and mask tables are numpy
constants, as in the JAX package; the tensor functions take and return torch
tensors in the same channel-last layouts.
"""
from __future__ import annotations

import numpy as np
import torch


def window_partition(x: torch.Tensor, window_size: int) -> torch.Tensor:
    """(B, H, W, C) -> (B * nH * nW, ws*ws, C), window index fastest inside
    a frame."""
    B, H, W, C = x.shape
    ws = window_size
    x = x.reshape(B, H // ws, ws, W // ws, ws, C).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(-1, ws * ws, C).contiguous()


def window_reverse(windows: torch.Tensor, window_size: int, H: int, W: int) -> torch.Tensor:
    """(B * nH * nW, ws*ws, C) -> (B, H, W, C)."""
    ws = window_size
    nH, nW = H // ws, W // ws
    B = windows.shape[0] // (nH * nW)
    x = windows.reshape(B, nH, nW, ws, ws, -1).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(B, H, W, -1)


def relative_position_index(window_size: int) -> np.ndarray:
    """(ws*ws, ws*ws) int32 index into the (2ws-1)^2 bias table."""
    ws = window_size
    coords = np.stack(np.meshgrid(np.arange(ws), np.arange(ws), indexing="ij"))
    flat = coords.reshape(2, -1)
    rel = (flat[:, :, None] - flat[:, None, :]).transpose(1, 2, 0).astype(np.int64)
    rel[:, :, 0] += ws - 1
    rel[:, :, 1] += ws - 1
    rel[:, :, 0] *= 2 * ws - 1
    return rel.sum(-1).astype(np.int32)


def temporal_relative_index(num_t: int) -> np.ndarray:
    """(T*T,) int32 index into the (2T-1,) temporal bias table."""
    c = np.arange(num_t)
    return (c[:, None] - c[None, :] + num_t - 1).reshape(-1).astype(np.int32)


def shift_attn_mask(H: int, W: int, window_size: int, shift_size: int) -> np.ndarray:
    """(nW, N, N) float32 additive mask (0 / -100) for SW-MSA."""
    ws, ss = window_size, shift_size
    img_mask = np.zeros((1, H, W, 1), np.float32)
    cnt = 0
    for h in (slice(0, -ws), slice(-ws, -ss), slice(-ss, None)):
        for w in (slice(0, -ws), slice(-ws, -ss), slice(-ss, None)):
            img_mask[:, h, w, :] = cnt
            cnt += 1
    m = img_mask.reshape(1, H // ws, ws, W // ws, ws, 1)
    m = m.transpose(0, 1, 3, 2, 4, 5).reshape(-1, ws * ws)
    diff = m[:, None, :] - m[:, :, None]
    return np.where(diff != 0, -100.0, 0.0).astype(np.float32)


def patch_merge(x: torch.Tensor, H: int, W: int) -> torch.Tensor:
    """2x2 neighbour concat: (B, H*W, C) -> (B, H/2*W/2, 4C), in the order
    [x0, x1, x2, x3] of Swin_AVE.py:960-976 (x0 = even/even, x1 = odd/even,
    x2 = even/odd, x3 = odd/odd; row parity first)."""
    B, _, C = x.shape
    x = x.reshape(B, H, W, C)
    x = torch.cat([x[:, 0::2, 0::2], x[:, 1::2, 0::2], x[:, 0::2, 1::2], x[:, 1::2, 1::2]],
                  dim=-1)
    return x.reshape(B, -1, 4 * C)
