"""TPAVI: the temporal-pixel audio-visual non-local block ('dot' mode).

Port of `stgcma_tpu/nn/tpavi.py` (:19-76; reference AVS/model/TPAVI.py:6-152).
Every 1x1x1 Conv3d of the reference is a token-wise linear over the
channel-last map (B, T, H, W, C). The W_z BatchNorm's scale is
zero-initialized, so a fresh block is identity + LayerNorm.
"""
from __future__ import annotations

import torch
from torch import nn

from ..ops.common import LayerNorm, Linear, layernorm, linear
from ..ops.conv import BatchNorm, batchnorm, batchnorm_train


class WZ(nn.Module):
    """W_z: a linear (inter -> C) and a BatchNorm over C."""

    def __init__(self, inter: int, ch: int):
        super().__init__()
        self.conv = Linear(inter, ch)
        self.bn = BatchNorm(ch)


class TPAVI(nn.Module):
    def __init__(self, in_channels: int, audio_dim: int = 128):
        super().__init__()
        inter = max(in_channels // 2, 1)
        self.align_channel = Linear(audio_dim, in_channels)
        self.norm_layer = LayerNorm(in_channels)
        self.g = Linear(in_channels, inter)
        self.theta = Linear(in_channels, inter)
        self.phi = Linear(in_channels, inter)
        self.W_z = WZ(inter, in_channels)


def tpavi_apply(p: TPAVI, x, audio=None, train: bool = False):
    """x: (B, T, H, W, C); audio: (B, T, A) or None (video self-attention).
    Returns (z, audio_aligned or None, the updated BN statistics {"mean",
    "var"} with `train`, else None).

    'dot' mode divides the logits by the position count THW and takes no
    softmax (TPAVI.py:133-135), so the attention is linear in g and
    reassociates exactly: y = theta (phi^T g) / THW, the (THW, THW) gram never
    formed (JAX :52-67). phi^T g is summed in float32, divided, and cast to
    x's dtype. With audio, phi's map is the aligned audio broadcast over the
    H W positions of its frame, so phi is taken on the (B, T) audio rows and
    phi^T g sums, frame by frame, phi against the frame's float32 sum of g."""
    B, T, H, W, C = x.shape
    THW = T * H * W
    g_x = linear(p.g, x)
    theta_x = linear(p.theta, x).reshape(B, THW, -1)
    if audio is not None:
        audio_temp = linear(p.align_channel, audio)                   # (B, T, C)
        phi_a = linear(p.phi, audio_temp).float()                     # (B, T, inter)
        g_sum = g_x.float().sum(dim=(2, 3))                           # (B, T, inter)
        pg = torch.matmul(phi_a.transpose(1, 2), g_sum)
    else:
        audio_temp = None
        phi_x = linear(p.phi, x).reshape(B, THW, -1).float()
        pg = torch.matmul(phi_x.transpose(1, 2), g_x.reshape(B, THW, -1).float())
    pg = (pg / THW).to(x.dtype)
    y = torch.matmul(theta_x, pg).reshape(B, T, H, W, -1)
    w = linear(p.W_z.conv, y)
    if train:
        w, stats = batchnorm_train(p.W_z.bn, w)
    else:
        w, stats = batchnorm(p.W_z.bn, w), None
    return layernorm(p.norm_layer, w + x), audio_temp, stats
