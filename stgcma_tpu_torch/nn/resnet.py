"""ResNet-18 feature extractor, channel-last, for the AVQA grounding
pretrainer (reference: AVQA/grounding_gen/visual_net.py, a torchvision
resnet copy used without its fc, nets_grd_gen.py:20).

Port of `stgcma_tpu/nn/resnet.py`: `resnet18_init` (:39) and
`resnet18_features` (:70), whose layer4 keeps stride 1, so a 224^2 input
gives 14 x 14 features. BatchNorm runs in inference mode (the grounding
pretrainer keeps the visual net frozen). Plain torch through `ops/conv.py`
(cuDNN's convolutions on the card), as the JAX package leaves these to XLA.
A torchvision state dict loads through
`checkpoint/torch_convert.py::load_resnet18`.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.common import resolve_device
from ..ops.conv import BatchNorm, Conv2d, batchnorm, conv2d

STAGES = ((64, 2), (128, 2), (256, 2), (512, 2))     # (width, blocks) a layer


class Downsample(nn.Module):
    """The 1x1 projection of a block's identity: `conv` and `bn` (torchvision's
    `downsample.0` / `downsample.1`)."""

    def __init__(self, c_in: int, c_out: int):
        super().__init__()
        self.conv = Conv2d(c_in, c_out, 1, bias=False)
        self.bn = BatchNorm(c_out)


class BasicBlock(nn.Module):
    def __init__(self, c_in: int, c_out: int, project: bool):
        super().__init__()
        self.conv1 = Conv2d(c_in, c_out, 3, bias=False)
        self.bn1 = BatchNorm(c_out)
        self.conv2 = Conv2d(c_out, c_out, 3, bias=False)
        self.bn2 = BatchNorm(c_out)
        self.downsample = Downsample(c_in, c_out) if project else None


class ResNet18(nn.Module):
    """The parameters under the JAX tree's keys: `conv1`, `bn1`,
    `layer1`..`layer4` (two `BasicBlock`s each; the first block of layers
    2-4 projects its identity)."""

    def __init__(self):
        super().__init__()
        self.conv1 = Conv2d(3, 64, 7, bias=False)
        self.bn1 = BatchNorm(64)
        c_in = 64
        for li, (width, blocks) in enumerate(STAGES):
            layer = nn.ModuleList()
            for b in range(blocks):
                layer.append(BasicBlock(c_in, width, b == 0 and li > 0))
                c_in = width
            setattr(self, f"layer{li + 1}", layer)


def resnet18_init(generator: torch.Generator = None, device="cuda") -> ResNet18:
    """A ResNet18 with the JAX `resnet18_init`'s distributions, drawn on the
    CPU from `generator` (seed 0 if none), then moved to `device`: every
    convolution uniform(+-1/sqrt(fan_in)) (torch's default), BatchNorms at
    scale 1, bias 0, mean 0, var 1."""
    device = resolve_device(device)
    g = generator if generator is not None else torch.Generator().manual_seed(0)
    model = ResNet18()
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, Conv2d):
                bound = 1.0 / math.sqrt(m.weight[0].numel())
                m.weight.uniform_(-bound, bound, generator=g)
    return model.to(device)


def _basic_block(p: BasicBlock, x, stride: int):
    identity = x
    y = torch.relu(batchnorm(p.bn1, conv2d(p.conv1.weight, x, stride=stride, padding=1)))
    y = batchnorm(p.bn2, conv2d(p.conv2.weight, y, padding=1))
    if p.downsample is not None:
        identity = batchnorm(p.downsample.bn, conv2d(p.downsample.conv.weight, x, stride=stride))
    return torch.relu(y + identity)


def resnet18_features(p: ResNet18, x):
    """x: (B, H, W, 3) normalized -> layer4 features (B, H/16, W/16, 512):
    the stem (7x7 stride-2 conv, BatchNorm, ReLU, 3x3 stride-2 max pool),
    then layers 1-4 with strides 1, 2, 2 and 1 (the grounding variant's
    stride-1 layer4)."""
    y = torch.relu(batchnorm(p.bn1, conv2d(p.conv1.weight, x, stride=2, padding=3)))
    y = F.max_pool2d(y.permute(0, 3, 1, 2), 3, stride=2, padding=1).permute(0, 2, 3, 1)
    for li in range(len(STAGES)):
        for b, blk in enumerate(getattr(p, f"layer{li + 1}")):
            y = _basic_block(blk, y, 2 if (b == 0 and li in (1, 2)) else 1)
    return y
