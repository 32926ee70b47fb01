"""CLIP visual tower with ST-adapters + STG-CMA token-level fusion.

Port of `stgcma_tpu/nn/clip_vit.py` in its four ftmodes (`fusion`, the main
path, `multimodal`, `videoonly`, `audioonly`): `_embed`, `_t_adapt`,
`_attn_ln`, `_ffn_clip`, `_single`, `_fusion`, `clip_block_apply`,
`_ln_post_cls` and `clip_backbone_apply`, with the JAX routing in the JAX
order. The modules below only hold parameters, named as the JAX tree's keys;
the functions read them. Tokens are batch-first (BT, N, C).

By default the attention at both sites goes through K1 (float tower) or K2
(int8 tower) and the int8 FFN through K3 (ops/fused_attn.py). Four switches
of the JAX package, read at call time and off by default, select other
kernels:
- `STGCMA_CLIP_TADAPT_FUSED=1` takes the temporal stage with its T_Adapter
  in K13, `STGCMA_CLIP_WHOLE_BLOCK=1` everything after it in K12 (`fusion`
  mode only), so that a block is three kernels (ops/clip_block.py);
- `STGCMA_QFUSE_ADAPTERS=1`, for an int8 tower only, takes the three
  adapter-fused bodies of K11 at every site: the temporal attention emits
  only the T_Adapter's hidden, the spatial attention and the FFN emit their
  output and the S_Adapter's or MLP_Adapter's hidden. At the temporal site
  it goes before K13; in `fusion` mode K12 goes before it;
- `STGCMA_TV2=1` takes the temporal stage with its T_Adapter in K14, on the
  tokens in their own (B*T, N, C) layout, with none of the four transposes
  the other temporal routes make; after K11, before K13.
Unlike the JAX package on the CPU, the port takes these entry points on the
CPU too and runs their plain versions there, as every other kernel of the
port does. Unlike the TPU path there is no resident pad: the video stream
keeps its 197 tokens (257 at ViT-L/14).
"""
from __future__ import annotations

import math
import os
from typing import Dict

import torch
from torch import nn

from ..configs import ClipConfig
from ..ops.attention import cross_modal_fuse
from ..ops.common import LayerNorm, Linear, layernorm, linear, quick_gelu
from ..ops.conv import conv2d
from ..ops.clip_block import (TADAPT_MAX_FRAMES, clip_fusion_spatial_block,
                              clip_temporal_adapt_block, temporal_adapt_v2)
from ..ops.fused_attn import (BLOCK_KERNEL_MAX_HEADS, clip_attention_block,
                              clip_attn_megakernel_h, ffn_q_megakernel, ffn_qh_megakernel)
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


# ftmode -> block mode (`clip_vit.py:25`)
MODES = {"videoonly": "video_adapt", "audioonly": "audio_adapt",
         "multimodal": "multimodal_adapt_no_fusion", "fusion": "fusion_adapt"}
ADAPTER_KINDS = ("S_Adapter", "T_Adapter", "MLP_Adapter")


def adapter_names(mode: str):
    """The adapters a block of `mode` holds (`clip_block_init` :50-59): the
    video ones unless the mode is audio-only, the `_Audio` ones unless it is
    video-only."""
    if mode not in MODES.values():
        raise ValueError(f"unknown CLIP block mode {mode!r}")
    video = [] if mode == "audio_adapt" else list(ADAPTER_KINDS)
    audio = [] if mode == "video_adapt" else [k + "_Audio" for k in ADAPTER_KINDS]
    return tuple(video + audio)


class ClipBlock(nn.Module):
    """One resblock: the frozen CLIP block, the adapters of its mode and the
    two fusion gates (held in every mode, as in the JAX tree)."""

    def __init__(self, cfg: ClipConfig, mode: str = "fusion_adapt"):
        super().__init__()
        d, r = cfg.embed_dim, cfg.adapter_ratio
        self.ln_1 = LayerNorm(d)
        self.ln_2 = LayerNorm(d)
        self.attn = Attn(d)
        self.mlp = Mlp(d)
        self.gate_v = nn.Parameter(torch.zeros(1))
        self.gate_a = nn.Parameter(torch.zeros(1))
        for name in adapter_names(mode):
            setattr(self, name, Adapter(d, r))


class PatchConv(nn.Module):
    """Bias-free patch-embedding conv, weight (D, C_in, p, p)."""

    def __init__(self, c_in: int, d: int, patch: int):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(d, c_in, patch, patch))


class ClipBackbone(nn.Module):
    def __init__(self, cfg: ClipConfig):
        super().__init__()
        if cfg.ftmode not in MODES:
            raise ValueError(f"unknown CLIP ftmode {cfg.ftmode!r}; one of {sorted(MODES)}")
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
        self.resblocks = nn.ModuleList(ClipBlock(cfg, MODES[cfg.ftmode])
                                       for _ in range(cfg.layers))


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
            for name in adapter_names(MODES[cfg.ftmode]):
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


def clip_tadapt_fused_enabled() -> bool:
    """`STGCMA_CLIP_TADAPT_FUSED=1`: the temporal stage in K13 (off by default,
    `clip_vit.py:154`). Read at call time."""
    return os.environ.get("STGCMA_CLIP_TADAPT_FUSED", "0") == "1"


def clip_whole_block_enabled() -> bool:
    """`STGCMA_CLIP_WHOLE_BLOCK=1`: everything after the temporal stage of a
    fusion block in K12 (off by default, `clip_vit.py:210`). Read at call time."""
    return os.environ.get("STGCMA_CLIP_WHOLE_BLOCK", "0") == "1"


def qfuse_adapters_enabled() -> bool:
    """`STGCMA_QFUSE_ADAPTERS=1`: the int8 adapter-fused kernels K11 (off by
    default, `clip_vit.py:106`). Read at call time."""
    return os.environ.get("STGCMA_QFUSE_ADAPTERS", "0") == "1"


def tv2_enabled() -> bool:
    """`STGCMA_TV2=1`: the transpose-free temporal stage in K14 (off by
    default, `clip_vit.py:139-148`). Read at call time."""
    return os.environ.get("STGCMA_TV2", "0") == "1"


def _qfuse_adapters(blk: ClipBlock, heads: int) -> bool:
    """K11 at this block's sites (`_qfuse_adapters` :106 and the routes'
    `heads <= 16`): an int8 tower with the switch set."""
    return (blk.attn.in_proj.quantized and qfuse_adapters_enabled()
            and heads <= BLOCK_KERNEL_MAX_HEADS)


def _t_adapt(blk: ClipBlock, x, heads: int, T: int, adapter: Adapter):
    """Temporal adaptation: attention over the frame axis + no-skip
    T_Adapter + residual. With `_qfuse_adapters` K11 emits only the
    T_Adapter's hidden (`clip_vit.py:126-138`); else K14 on x as it is when
    `tv2_enabled()`, else K13 when `clip_tadapt_fused_enabled()` (K14 and
    K13 at <= 16 heads and frames), else K1/K2 and the adapter in torch.
    x: (B*T, N, C)."""
    BT, N, C = x.shape
    B = BT // T
    kernel_ok = heads <= BLOCK_KERNEL_MAX_HEADS and T <= TADAPT_MAX_FRAMES
    if tv2_enabled() and kernel_ok and not _qfuse_adapters(blk, heads):
        return temporal_adapt_v2(blk.attn, blk.ln_1, adapter, x.contiguous(), heads, T)
    xt = x.reshape(B, T, N, C).transpose(1, 2).reshape(B * N, T, C).contiguous()
    if _qfuse_adapters(blk, heads):
        h = clip_attn_megakernel_h(blk.attn, blk.ln_1, adapter, xt, heads, emit_o=False)
        dA = h.shape[-1]
        h = h.reshape(B, N, T, dA).transpose(1, 2).reshape(BT, N, dA)
        return x + linear(adapter.D_fc2, h)
    if clip_tadapt_fused_enabled() and kernel_ok:
        xt = clip_temporal_adapt_block(blk.attn, blk.ln_1, adapter, xt, heads)
    else:
        attn_out = clip_attention_block(blk.attn, blk.ln_1, xt, heads)
        xt = xt + adapter_apply(adapter, attn_out, skip=False)
    return xt.reshape(B, N, T, C).transpose(1, 2).reshape(BT, N, C).contiguous()


def _ffn_clip(blk: ClipBlock, x):
    """ln_2 + MLP (QuickGELU): K3 for the int8 tower, plain torch else."""
    if blk.mlp.c_fc.quantized:
        return ffn_q_megakernel(blk.mlp, blk.ln_2, x, act="quick_gelu", keys=("c_fc", "c_proj"))
    return linear(blk.mlp.c_proj, quick_gelu(linear(blk.mlp.c_fc, layernorm(blk.ln_2, x))))


def _single(blk: ClipBlock, x, cfg: ClipConfig, sfx: str):
    """video_adapt / audio_adapt (`clip_vit.py:178-197`): one stream through
    the temporal stage, the spatial attention with its skip adapter and the
    FFN with its no-skip adapter; with `_qfuse_adapters` both in K11, whose
    hiddens feed the adapters' up-projections. sfx: "" or "_Audio"."""
    h = cfg.heads
    x = _t_adapt(blk, x, h, cfg.num_frames, getattr(blk, "T_Adapter" + sfx))
    if _qfuse_adapters(blk, h):
        s_ad, mlp_ad = getattr(blk, "S_Adapter" + sfx), getattr(blk, "MLP_Adapter" + sfx)
        xs, xs_h = clip_attn_megakernel_h(blk.attn, blk.ln_1, s_ad, x, h, emit_o=True)
        x = x + xs + adapter_out(s_ad, xs_h)
        xn, xn_h = ffn_qh_megakernel(blk.mlp, blk.ln_2, mlp_ad, x, act="quick_gelu",
                                     keys=("c_fc", "c_proj"))
        return x + xn + adapter_out(mlp_ad, xn_h)
    x = x + adapter_apply(getattr(blk, "S_Adapter" + sfx),
                          clip_attention_block(blk.attn, blk.ln_1, x, h), skip=True)
    xn = _ffn_clip(blk, x)
    return x + xn + adapter_apply(getattr(blk, "MLP_Adapter" + sfx), xn, skip=False)


def _fusion(blk: ClipBlock, v, a, cfg: ClipConfig):
    """fusion_adapt — token-level STG-CMA (CLIP_AVE.py:359-430). After the
    temporal stage, K12 when `clip_whole_block_enabled()` (<= 16 heads); else
    the spatial attention and the FFN in K11 with `_qfuse_adapters`, which
    emit the adapters' hiddens with their outputs (`clip_vit.py:218-246`)."""
    h = cfg.heads
    v = _t_adapt(blk, v, h, cfg.num_frames, blk.T_Adapter)
    a = _t_adapt(blk, a, h, cfg.num_frames, blk.T_Adapter_Audio)

    if clip_whole_block_enabled() and h <= BLOCK_KERNEL_MAX_HEADS:
        return clip_fusion_spatial_block(blk, v, a, h)

    qf = _qfuse_adapters(blk, h)
    if qf:
        vs, vs_h = clip_attn_megakernel_h(blk.attn, blk.ln_1, blk.S_Adapter, v, h, emit_o=True)
        a_s, as_h = clip_attn_megakernel_h(blk.attn, blk.ln_1, blk.S_Adapter_Audio, a, h,
                                           emit_o=True)
    else:
        vs = clip_attention_block(blk.attn, blk.ln_1, v, h)
        a_s = clip_attention_block(blk.attn, blk.ln_1, a, h)
        vs_h = adapter_hidden(blk.S_Adapter, vs)
        as_h = adapter_hidden(blk.S_Adapter_Audio, a_s)
    vs_h, as_h = cross_modal_fuse(vs_h, as_h, blk.gate_v, blk.gate_a)
    v = v + vs + adapter_out(blk.S_Adapter, vs_h)
    a = a + a_s + adapter_out(blk.S_Adapter_Audio, as_h)

    if qf:
        ffn_keys = {"act": "quick_gelu", "keys": ("c_fc", "c_proj")}
        vn, vn_h = ffn_qh_megakernel(blk.mlp, blk.ln_2, blk.MLP_Adapter, v, **ffn_keys)
        an, an_h = ffn_qh_megakernel(blk.mlp, blk.ln_2, blk.MLP_Adapter_Audio, a, **ffn_keys)
    else:
        vn = _ffn_clip(blk, v)
        an = _ffn_clip(blk, a)
        vn_h = adapter_hidden(blk.MLP_Adapter, vn)
        an_h = adapter_hidden(blk.MLP_Adapter_Audio, an)
    vn_h, an_h = cross_modal_fuse(vn_h, an_h, blk.gate_v, blk.gate_a)
    v = v + vn + adapter_out(blk.MLP_Adapter, vn_h)
    a = a + an + adapter_out(blk.MLP_Adapter_Audio, an_h)
    return v, a


def clip_block_apply(blk: ClipBlock, x, cfg: ClipConfig, mode: str):
    """One block in `mode` (`clip_vit.py:259-269`); x is one stream's tokens,
    or the pair (v, a) in the two-stream modes."""
    if mode == "video_adapt":
        return _single(blk, x, cfg, "")
    if mode == "audio_adapt":
        return _single(blk, x, cfg, "_Audio")
    if mode == "multimodal_adapt_no_fusion":
        return _single(blk, x[0], cfg, ""), _single(blk, x[1], cfg, "_Audio")
    if mode == "fusion_adapt":
        return _fusion(blk, x[0], x[1], cfg)
    raise ValueError(mode)


def launches_per_forward(cfg: ClipConfig, quantized: bool = False) -> Dict[str, int]:
    """{kernel id: launches} of one forward of `cfg` under the switches as
    they are now (ids with no launch left out): per block and stream one
    temporal and one spatial attention site and, for an int8 tower, one FFN
    site. The temporal site: K11 with `_qfuse_adapters`, else K14 with its
    switch, else K13 with its switch, else K1/K2. The rest of a fusion
    block: K12 with its switch; else the spatial and FFN sites in K11 with
    `_qfuse_adapters`, else K1/K2 and K3 (int8 only)."""
    streams = 1 if cfg.ftmode in ("videoonly", "audioonly") else 2
    kernel_ok = cfg.heads <= BLOCK_KERNEL_MAX_HEADS
    qf = quantized and qfuse_adapters_enabled() and kernel_ok
    frames_ok = kernel_ok and cfg.num_frames <= TADAPT_MAX_FRAMES
    tv2, tadapt = tv2_enabled() and frames_ok, clip_tadapt_fused_enabled() and frames_ok
    whole = clip_whole_block_enabled() and kernel_ok and cfg.ftmode == "fusion"
    sites = streams * cfg.layers
    attn_id = "K2" if quantized else "K1"
    out = {"K12": cfg.layers if whole else 0}
    temporal = "K11" if qf else "K14" if tv2 else "K13" if tadapt else attn_id
    for kid, n in ((temporal, sites),                                          # temporal
                   ("K11" if qf else attn_id, 0 if whole else sites),          # spatial
                   ("K11" if qf else "K3", sites if quantized and not whole else 0)):   # FFN
        out[kid] = out.get(kid, 0) + n
    return {k: n for k, n in out.items() if n}


def clip_backbone_apply(bb: ClipBackbone, cfg: ClipConfig, a=None, v=None
                        ) -> Dict[str, torch.Tensor]:
    """Per-stream class-token features (BT, D) after ln_post, for the streams
    of cfg.ftmode. v: (B, T, H, W, 3); a: (B, T, La, Fa) fbank."""
    mode = MODES[cfg.ftmode]
    streams = {}
    if cfg.ftmode != "audioonly":
        streams["v"] = _embed(bb, v, bb.conv1, bb.positional_embedding, bb.temporal_embedding,
                              cfg)
    if cfg.ftmode != "videoonly":
        streams["a"] = _embed(bb, a[..., None], bb.conv1_audio, bb.positional_embedding_audio,
                              bb.temporal_embedding_audio, cfg)
    x = tuple(streams.values()) if len(streams) == 2 else next(iter(streams.values()))
    for blk in bb.resblocks:
        x = clip_block_apply(blk, x, cfg, mode)
    # LayerNorm is per token, so normalizing the class token alone is exact
    outs = x if isinstance(x, tuple) else (x,)
    return {k: layernorm(bb.ln_post, t[:, 0]) for k, t in zip(streams, outs)}
