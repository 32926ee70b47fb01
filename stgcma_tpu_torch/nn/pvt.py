"""PVT-v2 encoder, channel-last: the backbone of the AVS baseline.

Port of `stgcma_tpu/nn/pvt.py` (reference AVS/model/pvt.py,
PyramidVisionTransformerV2, the non-'linear' variant that
AVS/model/PVT_AVSModel.py:323 wires as pvt_v2_b5): overlapping conv patch
embeds, spatial-reduction attention (a conv of kernel = stride = sr and a
LayerNorm on the keys and values), and a depthwise-conv FFN. `pvt_apply`
returns the four stage maps the AVS decoder reads (widths 64 / 128 / 320 /
512 at B5, AVSHeadConfig's vis_dim). Every LayerNorm of PVT takes eps
1e-6. The JAX package leaves all of PVT to XLA, so the port is plain torch.
"""
from __future__ import annotations

from typing import Dict, List

import torch
from torch import nn

from ..ops.common import LayerNorm, Linear, gelu, layernorm, linear
from ..ops.conv import Conv2d, conv2d

B5 = dict(embed_dims=(64, 128, 320, 512), num_heads=(1, 2, 5, 8),
          mlp_ratios=(4, 4, 4, 4), depths=(3, 6, 40, 3), sr_ratios=(8, 4, 2, 1))
B0 = dict(embed_dims=(32, 64, 160, 256), num_heads=(1, 2, 5, 8),
          mlp_ratios=(8, 8, 4, 4), depths=(2, 2, 2, 2), sr_ratios=(8, 4, 2, 1))
TINY = dict(embed_dims=(16, 32), num_heads=(1, 2), mlp_ratios=(4, 4),
            depths=(1, 1), sr_ratios=(4, 2))
LN_EPS = 1e-6


class SRAttention(nn.Module):
    """`q`, `kv` (C -> 2C), `proj`, and where sr > 1 the reduction conv `sr`
    and its LayerNorm `norm`."""

    def __init__(self, dim: int, sr: int):
        super().__init__()
        self.q = Linear(dim, dim)
        self.kv = Linear(dim, 2 * dim)
        self.proj = Linear(dim, dim)
        if sr > 1:
            self.sr = Conv2d(dim, dim, sr)
            self.norm = LayerNorm(dim)


class Mlp(nn.Module):
    """`fc1`, the depthwise 3x3 `dwconv` (weight (hidden, 1, 3, 3), the
    reference's `dwconv.dwconv`), `fc2`."""

    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = Linear(dim, hidden)
        self.dwconv = Conv2d(1, hidden, 3)
        self.fc2 = Linear(hidden, dim)


class Block(nn.Module):
    def __init__(self, dim: int, mlp_ratio: int, sr: int):
        super().__init__()
        self.norm1 = LayerNorm(dim)
        self.attn = SRAttention(dim, sr)
        self.norm2 = LayerNorm(dim)
        self.mlp = Mlp(dim, dim * mlp_ratio)


class PatchEmbed(nn.Module):
    def __init__(self, c_in: int, dim: int, ksize: int):
        super().__init__()
        self.proj = Conv2d(c_in, dim, ksize)
        self.norm = LayerNorm(dim)


class PVT(nn.Module):
    """The parameters under the JAX tree's keys: per stage i `patch_embed{i}`
    (7x7 stride 4 at stage 1, 3x3 stride 2 after), `block{i}` (a list of
    blocks) and `norm{i}`. `cfg` is one of the presets (or one with its
    depths cut) and stays on the module."""

    def __init__(self, cfg: Dict = B5, in_chans: int = 3):
        super().__init__()
        self.cfg = dict(cfg)
        for i, dim in enumerate(cfg["embed_dims"]):
            c_in = in_chans if i == 0 else cfg["embed_dims"][i - 1]
            setattr(self, f"patch_embed{i + 1}", PatchEmbed(c_in, dim, 7 if i == 0 else 3))
            setattr(self, f"block{i + 1}", nn.ModuleList(
                Block(dim, cfg["mlp_ratios"][i], cfg["sr_ratios"][i])
                for _ in range(cfg["depths"][i])))
            setattr(self, f"norm{i + 1}", LayerNorm(dim))


def dwconv(p: Conv2d, x: torch.Tensor, H: int, W: int) -> torch.Tensor:
    """Depthwise 3x3, padding 1, on (B, N, C) tokens seen as the (H, W)
    grid; the bias added after the product in x's dtype (JAX :40-48)."""
    B, N, C = x.shape
    y = conv2d(p.weight, x.reshape(B, H, W, C), padding=1, bias=p.bias, groups=C)
    return y.reshape(B, N, C)


def sra_attention(p: SRAttention, x: torch.Tensor, H: int, W: int, heads: int,
                  sr: int) -> torch.Tensor:
    """Spatial-reduction attention (JAX :80-100), rounding where JAX does: q
    times the scale rounds to x's dtype, the logits q.k^T and the softmax
    are float32 (bf16 products are exact in float32), the softmax rounds to
    x's dtype, and the product with v runs in x's dtype."""
    B, N, C = x.shape
    dh = C // heads
    q = linear(p.q, x).reshape(B, N, heads, dh).transpose(1, 2)
    if sr > 1:
        xr = conv2d(p.sr.weight, x.reshape(B, H, W, C), stride=sr, bias=p.sr.bias)
        xr = layernorm(p.norm, xr.reshape(B, -1, C), eps=LN_EPS)
    else:
        xr = x
    kv = linear(p.kv, xr).reshape(B, -1, 2, heads, dh).permute(2, 0, 3, 1, 4)
    k, v = kv[0], kv[1]
    logits = torch.matmul((q * dh ** -0.5).float(), k.float().transpose(-1, -2))
    attn = torch.softmax(logits, dim=-1).to(x.dtype)
    out = torch.matmul(attn, v).transpose(1, 2).reshape(B, N, C)
    return linear(p.proj, out)


def block_apply(p: Block, x: torch.Tensor, H: int, W: int, heads: int, sr: int) -> torch.Tensor:
    x = x + sra_attention(p.attn, layernorm(p.norm1, x, eps=LN_EPS), H, W, heads, sr)
    y = linear(p.mlp.fc1, layernorm(p.norm2, x, eps=LN_EPS))
    y = linear(p.mlp.fc2, gelu(dwconv(p.mlp.dwconv, y, H, W)))
    return x + y


def pvt_apply(model: PVT, x: torch.Tensor, cfg: Dict = None) -> List[torch.Tensor]:
    """x: (B, H, W, 3) -> the stage maps [(B, H/4, W/4, C_1), ..., (B,
    H/32, W/32, C_4)] (reference forward_features). `cfg`: the model's own
    unless given."""
    cfg = model.cfg if cfg is None else cfg
    outs = []
    for i in range(len(cfg["embed_dims"])):
        pe = getattr(model, f"patch_embed{i + 1}")
        ksize, stride = (7, 4) if i == 0 else (3, 2)
        x = conv2d(pe.proj.weight, x, stride=stride, padding=ksize // 2, bias=pe.proj.bias)
        B, H, W, C = x.shape
        x = layernorm(pe.norm, x.reshape(B, H * W, C), eps=LN_EPS)
        for bp in getattr(model, f"block{i + 1}"):
            x = block_apply(bp, x, H, W, cfg["num_heads"][i], cfg["sr_ratios"][i])
        x = layernorm(getattr(model, f"norm{i + 1}"), x, eps=LN_EPS)
        x = x.reshape(B, H, W, C)
        outs.append(x)
    return outs
