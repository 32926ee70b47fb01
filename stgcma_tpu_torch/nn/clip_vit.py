"""CLIP visual tower with ST-adapters + STG-CMA token-level fusion.

Port of `stgcma_tpu/nn/clip_vit.py` in `fusion` mode (the main path):
`_embed`, the default branch of `_t_adapt`, `_attn_ln`, `_ffn_clip`, the
non-`qf` branch of `_fusion`, `_ln_post_cls` and `clip_backbone_apply`.
The modules below only hold parameters, named as the JAX tree's keys; the
functions read them. Tokens are batch-first (BT, N, C). The attention at
both sites goes through K1 (float tower) or K2 (int8 tower), the int8 FFN
through K3 (ops/fused_attn.py). Unlike the TPU path there is no resident
pad: the video stream keeps its 197 tokens.
"""
from __future__ import annotations

import math
from typing import Dict

import torch
from torch import nn

from ..configs import ClipConfig
from ..ops.attention import cross_modal_fuse
from ..ops.common import LayerNorm, Linear, layernorm, linear, quick_gelu
from ..ops.conv import conv2d
from ..ops.fused_attn import clip_attention_block, ffn_q_megakernel
from .adapters import Adapter, adapter_apply, adapter_hidden, adapter_out


class Attn(nn.Module):
    def __init__(self, d: int):
        super().__init__()
        self.in_proj = Linear(d, 3 * d)
        self.out_proj = Linear(d, d)


class Mlp(nn.Module):
    def __init__(self, d: int):
        super().__init__()
        self.c_fc = Linear(d, 4 * d)
        self.c_proj = Linear(4 * d, d)


class ClipBlock(nn.Module):
    """One fusion-mode resblock: the frozen CLIP block plus both streams'
    adapters and the two fusion gates."""

    def __init__(self, cfg: ClipConfig):
        super().__init__()
        d, r = cfg.embed_dim, cfg.adapter_ratio
        self.ln_1 = LayerNorm(d)
        self.ln_2 = LayerNorm(d)
        self.attn = Attn(d)
        self.mlp = Mlp(d)
        self.gate_v = nn.Parameter(torch.zeros(1))
        self.gate_a = nn.Parameter(torch.zeros(1))
        for name in ("S_Adapter", "T_Adapter", "MLP_Adapter", "S_Adapter_Audio",
                     "T_Adapter_Audio", "MLP_Adapter_Audio"):
            setattr(self, name, Adapter(d, r))


class PatchConv(nn.Module):
    """Bias-free patch-embedding conv, weight (D, C_in, p, p)."""

    def __init__(self, c_in: int, d: int, patch: int):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(d, c_in, patch, patch))


class ClipBackbone(nn.Module):
    def __init__(self, cfg: ClipConfig):
        super().__init__()
        if cfg.ftmode != "fusion":
            raise NotImplementedError(
                f"ftmode {cfg.ftmode!r}: the port runs 'fusion' only so far")
        d, T = cfg.embed_dim, cfg.num_frames
        self.conv1 = PatchConv(3, d, cfg.patch_size)
        self.conv1_audio = PatchConv(1, d, cfg.patch_size)
        self.class_embedding = nn.Parameter(torch.zeros(d))
        self.positional_embedding = nn.Parameter(torch.zeros(cfg.num_patches + 1, d))
        self.positional_embedding_audio = nn.Parameter(
            torch.zeros(cfg.num_patches_audio + 1, d))
        self.temporal_embedding = nn.Parameter(torch.zeros(1, T, d))
        self.temporal_embedding_audio = nn.Parameter(torch.zeros(1, T, d))
        self.ln_pre = LayerNorm(d)
        self.ln_post = LayerNorm(d)
        self.resblocks = nn.ModuleList(ClipBlock(cfg) for _ in range(cfg.layers))


def init_clip_backbone_(bb: ClipBackbone, cfg: ClipConfig, g: torch.Generator):
    """The JAX package's initialization (`clip_backbone_init`), drawn from
    `g`: trunc_normal(0.02) linears with zero biases, zero adapter D_fc2 and
    gates, kaiming-uniform patch convs, scaled normal class/position
    embeddings, zero temporal embeddings, unit LayerNorms."""
    d = cfg.embed_dim
    with torch.no_grad():
        for conv in (bb.conv1, bb.conv1_audio):
            bound = 1.0 / math.sqrt(conv.weight[0].numel())
            conv.weight.uniform_(-bound, bound, generator=g)
        for p in (bb.class_embedding, bb.positional_embedding,
                  bb.positional_embedding_audio):
            p.normal_(0.0, d ** -0.5, generator=g)
        for m in bb.modules():
            if isinstance(m, Linear):
                nn.init.trunc_normal_(m.weight, std=0.02, a=-0.04, b=0.04,
                                      generator=g)
        for blk in bb.resblocks:
            for name in ("S_Adapter", "T_Adapter", "MLP_Adapter", "S_Adapter_Audio",
                         "T_Adapter_Audio", "MLP_Adapter_Audio"):
                getattr(blk, name).D_fc2.weight.zero_()


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------

def _embed(bb: ClipBackbone, x, conv: PatchConv, pos, t_emb, cfg: ClipConfig):
    """patchify + class token + pos embed + temporal embed + ln_pre.
    x: (B, T, H, W, C_in) -> (B*T, N+1, D)."""
    B, T = x.shape[0], x.shape[1]
    x = x.reshape((B * T,) + tuple(x.shape[2:]))
    y = conv2d(conv.weight, x, stride=cfg.patch_size)        # (BT, gh, gw, D)
    BT, D = y.shape[0], cfg.embed_dim
    y = y.reshape(BT, -1, D)
    cls = bb.class_embedding.to(y.dtype).expand(BT, 1, D)
    y = torch.cat([cls, y], dim=1) + pos.to(y.dtype)
    N = y.shape[1]
    y = y.reshape(B, T, N, D) + t_emb.to(y.dtype)[:, :, None, :]
    return layernorm(bb.ln_pre, y.reshape(BT, N, D))


def _t_adapt(blk: ClipBlock, x, heads: int, T: int, adapter: Adapter):
    """Temporal adaptation: attention over the frame axis + no-skip
    T_Adapter + residual. x: (B*T, N, C)."""
    BT, N, C = x.shape
    B = BT // T
    xt = x.reshape(B, T, N, C).transpose(1, 2).reshape(B * N, T, C).contiguous()
    attn_out = clip_attention_block(blk.attn, blk.ln_1, xt, heads)
    xt = xt + adapter_apply(adapter, attn_out, skip=False)
    return xt.reshape(B, N, T, C).transpose(1, 2).reshape(BT, N, C).contiguous()


def _ffn_clip(blk: ClipBlock, x):
    """ln_2 + MLP (QuickGELU): K3 for the int8 tower, plain torch else."""
    if blk.mlp.c_fc.quantized:
        return ffn_q_megakernel(blk.mlp, blk.ln_2, x, act="quick_gelu", keys=("c_fc", "c_proj"))
    return linear(blk.mlp.c_proj, quick_gelu(linear(blk.mlp.c_fc, layernorm(blk.ln_2, x))))


def _fusion(blk: ClipBlock, v, a, cfg: ClipConfig):
    """fusion_adapt — token-level STG-CMA (CLIP_AVE.py:359-430)."""
    h = cfg.heads
    v = _t_adapt(blk, v, h, cfg.num_frames, blk.T_Adapter)
    a = _t_adapt(blk, a, h, cfg.num_frames, blk.T_Adapter_Audio)

    vs = clip_attention_block(blk.attn, blk.ln_1, v, h)
    a_s = clip_attention_block(blk.attn, blk.ln_1, a, h)
    vs_h = adapter_hidden(blk.S_Adapter, vs)
    as_h = adapter_hidden(blk.S_Adapter_Audio, a_s)
    vs_h, as_h = cross_modal_fuse(vs_h, as_h, blk.gate_v, blk.gate_a)
    v = v + vs + adapter_out(blk.S_Adapter, vs_h)
    a = a + a_s + adapter_out(blk.S_Adapter_Audio, as_h)

    vn = _ffn_clip(blk, v)
    an = _ffn_clip(blk, a)
    vn_h = adapter_hidden(blk.MLP_Adapter, vn)
    an_h = adapter_hidden(blk.MLP_Adapter_Audio, an)
    vn_h, an_h = cross_modal_fuse(vn_h, an_h, blk.gate_v, blk.gate_a)
    v = v + vn + adapter_out(blk.MLP_Adapter, vn_h)
    a = a + an + adapter_out(blk.MLP_Adapter_Audio, an_h)
    return v, a


def clip_backbone_apply(bb: ClipBackbone, cfg: ClipConfig, a, v) -> Dict[str, torch.Tensor]:
    """Per-stream class-token features (BT, D) after ln_post.
    v: (B, T, H, W, 3); a: (B, T, La, Fa) fbank."""
    vt = _embed(bb, v, bb.conv1, bb.positional_embedding, bb.temporal_embedding, cfg)
    at = _embed(bb, a[..., None], bb.conv1_audio, bb.positional_embedding_audio,
                bb.temporal_embedding_audio, cfg)
    for blk in bb.resblocks:
        vt, at = _fusion(blk, vt, at, cfg)
    # LayerNorm is per token, so normalizing the class token alone is exact
    return {"v": layernorm(bb.ln_post, vt[:, 0]), "a": layernorm(bb.ln_post, at[:, 0])}
