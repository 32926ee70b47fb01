"""The AVS segmentation decoder: ASPP classifier, residual conv units,
FPN-style feature fusion with align_corners=True upsampling, output head.

Port of `stgcma_tpu/nn/decoder.py` (:16-83; reference
AVS/model/Swin_AVSModel.py:14-143 and :1500-1507). Every map is
channel-last (B, H, W, C) at the interface; the convolutions see it as
torch's `channels_last` memory format (ops/conv.py), so the decoder makes no
layout copies. Plain torch, as the JAX package leaves it to XLA.
"""
from __future__ import annotations

import torch
from torch import nn

from ..ops.conv import Conv2d, conv2d
from ..ops.resize import resize_bilinear

ASPP_DILATIONS = (3, 6, 12, 18)


def conv_apply(p: Conv2d, x, padding: int = 0, dilation: int = 1):
    return conv2d(p.weight, x, padding=padding, dilation=dilation, bias=p.bias)


class ASPP(nn.Module):
    """Classifier_Module: a sum of dilated 3x3 convs (Swin_AVSModel.py:14-29)."""

    def __init__(self, in_ch: int, out_ch: int, n: int = len(ASPP_DILATIONS)):
        super().__init__()
        self.convs = nn.ModuleList(Conv2d(in_ch, out_ch, 3) for _ in range(n))


class RCU(nn.Module):
    def __init__(self, features: int):
        super().__init__()
        self.conv1 = Conv2d(features, features, 3)
        self.conv2 = Conv2d(features, features, 3)


class FFB(nn.Module):
    def __init__(self, features: int):
        super().__init__()
        self.resConfUnit1 = RCU(features)
        self.resConfUnit2 = RCU(features)


class OutputConv(nn.Module):
    def __init__(self, channel: int):
        super().__init__()
        self.conv0 = Conv2d(channel, 128, 3)
        self.conv2 = Conv2d(128, 32, 3)
        self.conv4 = Conv2d(32, 1, 1)


def aspp_apply(p: ASPP, x, dilations=ASPP_DILATIONS):
    out = None
    for cp, d in zip(p.convs, dilations):
        y = conv_apply(cp, x, padding=d, dilation=d)
        out = y if out is None else out + y
    return out


def rcu_apply(p: RCU, x):
    """ResidualConvUnit (Swin_AVSModel.py:47-78): conv2(relu(conv1(relu(x))))
    + relu(x). The reference's nn.ReLU(inplace=True) rewrites its input, so
    the residual it adds is relu(x), not x; JAX keeps that, and so does the
    port."""
    xr = torch.relu(x)
    out = torch.relu(conv_apply(p.conv1, xr, padding=1))
    return conv_apply(p.conv2, out, padding=1) + xr


def ffb_apply(p: FFB, x, skip=None):
    """FeatureFusionBlock: (the skip through RCU1, added) + RCU2 + a 2x
    bilinear upsample with align_corners=True (Swin_AVSModel.py:81-111)."""
    out = x
    if skip is not None:
        out = out + rcu_apply(p.resConfUnit1, skip)
    out = rcu_apply(p.resConfUnit2, out)
    return resize_bilinear(out, out.shape[-3] * 2, out.shape[-2] * 2, align_corners=True)


def output_conv_apply(p: OutputConv, x):
    """conv3 -> 2x bilinear (align_corners=False) -> conv3 -> relu -> conv1
    (Swin_AVSModel.py:1500-1507)."""
    x = conv_apply(p.conv0, x, padding=1)
    x = resize_bilinear(x, x.shape[-3] * 2, x.shape[-2] * 2, align_corners=False)
    x = torch.relu(conv_apply(p.conv2, x, padding=1))
    return conv_apply(p.conv4, x)
