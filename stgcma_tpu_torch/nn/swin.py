"""Swin-2D adapter backbone in its four ftmodes.

Port of `stgcma_tpu/nn/swin.py` in the reference's `video_adapt` /
`audio_adapt` (the single-stream `videoonly` / `audioonly` ftmodes,
Swin_AVE.py:394-488), `multimodal_adapt_no_fusion` (Swin_AVE.py:490-591) and
`fusion_adapt` (Swin_AVE.py:693-813, the STG-CMA exchange) modes:
`BlockStatic` and `make_block_static` (:42-78), the mode table (:82),
`_temporal_branch` (:163), `_ffn` (:190), `_spatial_windows` (:214),
`_merge_windows` (:248), `_single_stream` (:255), `_dual_no_fusion` (:271),
`_dual_fusion` (:290, with the AVQA `nega` stream), `block_apply`
(:361), the patch embed and merging (:382-407), `backbone_statics` (:410),
and the unrolled `_run_layers` (:435, with the AVS `multi_scale` taps) and
`backbone_apply` (:483, with `v_nega`).

The modules only hold parameters, named as the JAX tree's keys; the
functions read them. Tokens are batch-first (B*T, H*W, C). The kernel routes
follow the JAX package's TPU policy (ops/fused_attn.py, ops/swin_block.py):
K1 for the temporal and window attention of stages with <= 16 heads,
LayerNorm then the K8 core for more heads, K7 for a two-stream FFN whose
hidden takes >= 96 MiB (the single-stream FFN is LayerNorm then the plain
MLP: its adapter reads the normalized rows), K9 for the large norms; in
`fusion` mode K4 for the whole block after the temporal branch on grids of
<= 256 tokens, and elsewhere K5 for the per-window exchange and K6 for the
full-grid one. A tower made int8 by `ops/quant.py::quantize_swin_tower`
routes on `quantized` as JAX routes on "kernel_q": K2 in place of K1, K3 at
every two-stream FFN outside K4 (never K7, nor the plain FFN; the
single-stream FFN takes `int8_matmul`), K4's int8 variant, and
`int8_matmul` for the qkv and proj products around the K8 core; patch
embed, merging and norms stay float.
The bias and shift mask of each attention site are gathered from the
block's table on every call, as the JAX package does inside its jit; the
index and mask constants are built once per geometry and device.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List

import torch
from torch import nn

from ..configs import SwinConfig
from ..ops import window as W
from ..ops.common import LayerNorm, Linear, layernorm, linear, mlp_apply, tensor_cache
from ..ops.conv import conv3d
from ..ops.fused_attn import (block_kernel_route, cross_modal_fuse_flash,
                              cross_modal_fuse_windows, ffn_kernel_route, ffn_megakernel,
                              ffn_q_megakernel, flash_fuse_route, layernorm_fused, ln_kernel_route,
                              temporal_attention_fused, temporal_block_megakernel,
                              window_attention_fused, window_block_megakernel)
from ..ops.swin_block import swin_fusion_whole_block, swin_whole_block_enabled
from .adapters import Adapter, adapter_apply, adapter_hidden, adapter_out

# ftmode -> block mode (swin.py:82)
FTMODES = {"videoonly": "video_adapt", "audioonly": "audio_adapt",
                  "multimodal": "multimodal_adapt_no_fusion", "fusion": "fusion_adapt"}
# block mode -> the adapter-key suffixes of its streams ("" video, "_Audio" audio)
MODE_STREAMS = {"video_adapt": ("",), "audio_adapt": ("_Audio",)}


# ---------------------------------------------------------------------------
# static (non-parameter) geometry per block
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class BlockStatic:
    dim: int
    H: int
    W: int
    num_heads: int
    window_size: int
    shift_size: int
    t_attn: bool
    num_frames: int
    adapter_ratio: float
    mode: str
    use_t_adapter: bool = True
    use_s_adapter: bool = True
    use_g_adapter: bool = True


def make_block_static(cfg: SwinConfig, stage: int, block_idx: int, mode: str) -> BlockStatic:
    H, Wd = cfg.stage_resolution(stage)
    ws = cfg.window_size
    shift = 0 if block_idx % 2 == 0 else ws // 2
    # Swin_AVE.py:330-334: a window larger than the feature map shrinks to it, unshifted
    if min(H, Wd) <= ws:
        ws = min(H, Wd)
        shift = 0
    return BlockStatic(
        dim=cfg.stage_dim(stage), H=H, W=Wd, num_heads=cfg.num_heads[stage],
        window_size=ws, shift_size=shift,
        t_attn=(block_idx % 2 == 0) and cfg.use_temporal_attn,
        num_frames=cfg.num_ttokens, adapter_ratio=cfg.adapter_ratios[stage],
        mode=mode, use_t_adapter=cfg.use_t_adapter,
        use_s_adapter=cfg.use_s_adapter, use_g_adapter=cfg.use_g_adapter)


def _mode_for_ftmode(ftmode: str) -> str:
    if ftmode not in FTMODES:
        raise ValueError(f"unknown Swin ftmode {ftmode!r}: one of {tuple(FTMODES)}")
    return FTMODES[ftmode]


def backbone_statics(cfg: SwinConfig) -> List[List[BlockStatic]]:
    mode = _mode_for_ftmode(cfg.ftmode)
    return [[make_block_static(cfg, s, i, mode) for i in range(cfg.depths[s])]
            for s in range(cfg.num_layers)]


@tensor_cache
def _rel_index(ws: int, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(W.relative_position_index(ws)).to(device)


@tensor_cache
def _t_index(T: int, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(W.temporal_relative_index(T)).to(device)


@tensor_cache
def _shift_mask(H: int, Wd: int, ws: int, ss: int, device: torch.device):
    if ss == 0:
        return None
    return torch.from_numpy(W.shift_attn_mask(H, Wd, ws, ss)).to(device)


# ---------------------------------------------------------------------------
# parameter modules
# ---------------------------------------------------------------------------

class SwinAttention(nn.Module):
    def __init__(self, st: BlockStatic):
        super().__init__()
        d, h = st.dim, st.num_heads
        self.qkv = Linear(d, 3 * d)
        self.proj = Linear(d, d)
        self.relative_position_bias_table = nn.Parameter(
            torch.zeros((2 * st.window_size - 1) ** 2, h))
        if st.t_attn:
            self.temporal_position_bias_table = nn.Parameter(torch.zeros(2 * st.num_frames - 1, h))
            self.temporal_position_bias_table_audio = nn.Parameter(
                torch.zeros(2 * st.num_frames - 1, h))


class SwinMlp(nn.Module):
    def __init__(self, d: int, hidden: int):
        super().__init__()
        self.fc1 = Linear(d, hidden)
        self.fc2 = Linear(hidden, d)


class SwinBlock(nn.Module):
    """One block: the frozen Swin block (with both temporal tables), the
    fusion gates (read in `fusion` mode only; the JAX tree has them in every
    mode) and the adapters of the mode's streams (swin.py:143-160)."""

    def __init__(self, st: BlockStatic):
        super().__init__()
        d, r = st.dim, st.adapter_ratio
        self.norm1 = LayerNorm(d)
        self.norm2 = LayerNorm(d)
        self.attn = SwinAttention(st)
        self.mlp = SwinMlp(d, int(d * 4.0))
        self.gate_v = nn.Parameter(torch.zeros(1))
        self.gate_a = nn.Parameter(torch.zeros(1))
        for sfx in MODE_STREAMS.get(st.mode, ("", "_Audio")):
            if st.t_attn and st.use_t_adapter:
                setattr(self, "T_Adapter" + sfx, Adapter(d, r))
            if st.use_g_adapter:
                setattr(self, "S_Adapter" + sfx, Adapter(d, r))
            if st.use_s_adapter:
                setattr(self, "S_Adapter2" + sfx, Adapter(d, r))


class Conv3d(nn.Module):
    """Patch-embedding conv parameters: weight (C_out, C_in, pt, ph, pw), bias."""

    def __init__(self, c_in: int, c_out: int, kernel):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(c_out, c_in, *kernel))
        self.bias = nn.Parameter(torch.zeros(c_out))


class PatchEmbed(nn.Module):
    def __init__(self, cfg: SwinConfig, in_chans: int):
        super().__init__()
        self.proj = Conv3d(in_chans, cfg.embed_dim, cfg.patch_size)
        self.norm = LayerNorm(cfg.embed_dim)


class PatchMerging(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.norm = LayerNorm(4 * dim)
        self.reduction = Linear(4 * dim, 2 * dim, bias=False)


class SwinStage(nn.Module):
    def __init__(self, statics: List[BlockStatic], downsample: bool):
        super().__init__()
        self.blocks = nn.ModuleList(SwinBlock(st) for st in statics)
        self.downsample = PatchMerging(statics[0].dim) if downsample else None


class SwinBackbone(nn.Module):
    def __init__(self, cfg: SwinConfig):
        super().__init__()
        statics = backbone_statics(cfg)
        self.patch_embed = PatchEmbed(cfg, cfg.in_chans)
        self.patch_embed_audio = PatchEmbed(cfg, 1)
        self.layers = nn.ModuleList(SwinStage(statics[s], s < cfg.num_layers - 1)
                                    for s in range(cfg.num_layers))
        self.norm = LayerNorm(cfg.num_features)


# ---------------------------------------------------------------------------
# block forward pieces
# ---------------------------------------------------------------------------

def _temporal_branch(blk: SwinBlock, x, st: BlockStatic, signal: str, adapter_key: str):
    """Temporal attention over the T frame tokens + no-skip T_Adapter +
    residual (Swin_AVE.py:705-716). x: (B*T, N, C)."""
    BT, N, C = x.shape
    T = st.num_frames
    B = BT // T
    t_index = _t_index(T, x.device)
    xt = x.reshape(B, T, N, C).transpose(1, 2).reshape(B * N, T, C).contiguous()
    if block_kernel_route(st.num_heads):
        res = temporal_block_megakernel(blk.attn, blk.norm1, xt, st.num_heads, t_index,
                                        signal=signal)
    else:
        res = temporal_attention_fused(blk.attn, layernorm_fused(blk.norm1, xt),
                                       st.num_heads, t_index, signal=signal)
    if st.use_t_adapter:
        res = adapter_apply(getattr(blk, adapter_key), res, skip=False)
    xt = xt + res
    return xt.reshape(B, N, T, C).transpose(1, 2).reshape(BT, N, C)


def _ffn(blk: SwinBlock, x):
    """LN + fc1 + erf-GELU + fc2: K3 for an int8 tower whatever the hidden
    size (`swin.py:199-203`); else K7 when the hidden is large, the plain
    bf16 ops (XLA's in the JAX package) otherwise."""
    if blk.mlp.fc1.quantized:
        return ffn_q_megakernel(blk.mlp, blk.norm2, x)
    hidden = blk.mlp.fc1.weight.shape[0]
    if ffn_kernel_route(x.numel() // x.shape[-1], hidden, x.element_size()):
        return ffn_megakernel(blk.mlp, blk.norm2, x)
    return mlp_apply(blk.mlp, layernorm(blk.norm2, x))


def _spatial_windows(blk: SwinBlock, x, st: BlockStatic):
    """LN -> shift -> partition -> W-MSA. Returns the attended windows.
    LN commutes with the token-wise shift and partition, so the K1 route
    normalizes inside the kernel."""
    BT, L, C = x.shape
    ws, ss = st.window_size, st.shift_size
    mask = _shift_mask(st.H, st.W, ws, ss, x.device)
    rel = _rel_index(ws, x.device)
    kernel = block_kernel_route(st.num_heads)
    xr = (x if kernel else layernorm(blk.norm1, x)).reshape(BT, st.H, st.W, C)
    if ss > 0:
        xr = torch.roll(xr, (-ss, -ss), dims=(1, 2))
    xw = W.window_partition(xr, ws)
    if kernel:
        return window_block_megakernel(blk.attn, blk.norm1, xw, st.num_heads, rel, mask=mask)
    return window_attention_fused(blk.attn, xw, st.num_heads, rel, mask=mask)


def _merge_windows(attn_w, st: BlockStatic, BT: int):
    x = W.window_reverse(attn_w, st.window_size, st.H, st.W)
    if st.shift_size > 0:
        x = torch.roll(x, (st.shift_size, st.shift_size), dims=(1, 2))
    return x.reshape(BT, st.H * st.W, -1)


def _single_stream(blk: SwinBlock, x, st: BlockStatic, signal: str):
    """video_adapt / audio_adapt (Swin_AVE.py:394-488): the FFN is LayerNorm
    then the plain MLP (`linear_q` on an int8 tower), never K7 or K3, since
    its adapter reads the normalized rows, which K7 keeps on chip; the
    adapter's output enters at half weight."""
    sfx = "" if signal == "video" else "_Audio"
    if st.t_attn:
        x = _temporal_branch(blk, x, st, signal, "T_Adapter" + sfx)
    attn_w = _spatial_windows(blk, x, st)
    if st.use_s_adapter:
        attn_w = adapter_apply(getattr(blk, "S_Adapter2" + sfx), attn_w, skip=True)
    x = x + _merge_windows(attn_w, st, x.shape[0])
    xn = layernorm(blk.norm2, x)
    out = x + mlp_apply(blk.mlp, xn)
    if st.use_g_adapter:
        out = out + 0.5 * adapter_apply(getattr(blk, "S_Adapter" + sfx), xn, skip=False)
    return out


def _dual_no_fusion(blk: SwinBlock, v, a, st: BlockStatic):
    """multimodal_adapt_no_fusion (Swin_AVE.py:490-591). The FFN adapter
    reads the MLP *output*, without the 0.5 factor of the single-stream
    modes."""
    out = []
    for x, sfx, signal in ((v, "", "video"), (a, "_Audio", "audio")):
        if st.t_attn:
            x = _temporal_branch(blk, x, st, signal, "T_Adapter" + sfx)
        attn_w = _spatial_windows(blk, x, st)
        if st.use_s_adapter:
            attn_w = adapter_apply(getattr(blk, "S_Adapter2" + sfx), attn_w, skip=True)
        x = x + _merge_windows(attn_w, st, x.shape[0])
        xn = _ffn(blk, x)
        x = x + xn
        if st.use_g_adapter:
            x = x + adapter_apply(getattr(blk, "S_Adapter" + sfx), xn, skip=False)
        out.append(x)
    return out[0], out[1]


def _nega_block(blk: SwinBlock, x, st: BlockStatic):
    """The AVQA `nega` stream through one block (`swin.py:314-317`,
    `:352-357`): the frozen tower alone, no temporal branch and no adapter:
    W-MSA (K1 / K2 to 16 heads, else LN + the K8 core), the window merge, the
    FFN (`_ffn`: K3 on an int8 tower, K7 where the hidden is large)."""
    x = x + _merge_windows(_spatial_windows(blk, x, st), st, x.shape[0])
    return x + _ffn(blk, x)


def _dual_fusion(blk: SwinBlock, v, a, st: BlockStatic, nega=None):
    """fusion_adapt, the STG-CMA core (Swin_AVE.py:693-813): the temporal
    branch per stream, then K4 for the rest of the block on small grids;
    elsewhere W-MSA per stream, the gated bidirectional exchange of the
    spatial adapters' hiddens per window (K5), the window merge, the FFN per
    stream and the same exchange of the FFN adapters' hiddens over the full
    stage grid (K6). With `nega` (AVQA's negative visual stream,
    Swin_AVQAModel_V1.py) the block returns a third stream, `_nega_block`'s,
    which reads none of v and a."""
    if st.t_attn:
        v = _temporal_branch(blk, v, st, "video", "T_Adapter")
        a = _temporal_branch(blk, a, st, "audio", "T_Adapter_Audio")
    if swin_whole_block_enabled(st):
        v, a = swin_fusion_whole_block(blk, v, a, st)
        return (v, a) if nega is None else (v, a, _nega_block(blk, nega, st))
    attn_v, attn_a = _spatial_windows(blk, v, st), _spatial_windows(blk, a, st)
    if st.use_s_adapter:
        vs_h, as_h = cross_modal_fuse_windows(adapter_hidden(blk.S_Adapter2, attn_v),
                                              adapter_hidden(blk.S_Adapter2_Audio, attn_a),
                                              blk.gate_v, blk.gate_a)
        attn_v = attn_v + adapter_out(blk.S_Adapter2, vs_h)
        attn_a = attn_a + adapter_out(blk.S_Adapter2_Audio, as_h)
    v = v + _merge_windows(attn_v, st, v.shape[0])
    a = a + _merge_windows(attn_a, st, a.shape[0])
    vn, an = _ffn(blk, v), _ffn(blk, a)
    if st.use_g_adapter:
        vn_h, an_h = cross_modal_fuse_flash(adapter_hidden(blk.S_Adapter, vn),
                                            adapter_hidden(blk.S_Adapter_Audio, an),
                                            blk.gate_v, blk.gate_a)
        v = v + vn + adapter_out(blk.S_Adapter, vn_h)
        a = a + an + adapter_out(blk.S_Adapter_Audio, an_h)
    else:
        v, a = v + vn, a + an
    return (v, a) if nega is None else (v, a, _nega_block(blk, nega, st))


def block_apply(blk: SwinBlock, x, st: BlockStatic):
    """x is a tensor (single-stream), the pair (v, a) or, in `fusion` mode,
    the triple (v, a, v_nega)."""
    if st.mode == "video_adapt":
        return _single_stream(blk, x, st, "video")
    if st.mode == "audio_adapt":
        return _single_stream(blk, x, st, "audio")
    if st.mode == "multimodal_adapt_no_fusion":
        return _dual_no_fusion(blk, x[0], x[1], st)
    if st.mode == "fusion_adapt":
        return _dual_fusion(blk, x[0], x[1], st, *x[2:])
    raise ValueError(f"unknown Swin block mode {st.mode!r}")


# ---------------------------------------------------------------------------
# patch embed / merging / backbone
# ---------------------------------------------------------------------------

def patch_embed_apply(pe: PatchEmbed, x, cfg: SwinConfig):
    """x: (B, T, H, W, C_in) -> tokens (B*T', H'*W', C), T' = T // pt
    (PatchEmbed3D, Swin_AVE.py:1078-1124)."""
    y = conv3d(pe.proj.weight, pe.proj.bias, x, stride=cfg.patch_size)
    B, Tp, Hp, Wp, C = y.shape
    return layernorm_fused(pe.norm, y.reshape(B * Tp, Hp * Wp, C))


def patch_merging_apply(pm: PatchMerging, x, H: int, Wd: int):
    return linear(pm.reduction, layernorm_fused(pm.norm, W.patch_merge(x, H, Wd)))


def stage_apply(bb: SwinBackbone, cfg: SwinConfig, statics, s: int, x):
    """Stage s over x, a tensor, the pair (v, a) or the fusion triple (v, a,
    v_nega): its blocks, then its patch merging. Returns (x after the
    blocks, x after the merge); the two are one where the stage has no
    merge."""
    layer = bb.layers[s]
    for blk, st in zip(layer.blocks, statics[s]):
        x = block_apply(blk, x, st)
    if layer.downsample is None:
        return x, x
    H, Wd = cfg.stage_resolution(s)
    if isinstance(x, tuple):
        return x, tuple(patch_merging_apply(layer.downsample, xi, H, Wd) for xi in x)
    return x, patch_merging_apply(layer.downsample, x, H, Wd)


def _run_layers(bb: SwinBackbone, cfg: SwinConfig, statics, x, collect_multiscale=False):
    """Every stage over x (`stage_apply`). Returns (x, taps): with
    `collect_multiscale`, the visual stream before each downsample (the AVS
    taps, Swin_AVSModel.py:1811-1821), the last one through the final norm;
    else an empty list."""
    multi_scale = []
    for s in range(len(bb.layers)):
        x, merged = stage_apply(bb, cfg, statics, s, x)
        if collect_multiscale:
            v_tap = x[0] if isinstance(x, tuple) else x
            if s == cfg.num_layers - 1:
                v_tap = layernorm_fused(bb.norm, v_tap)
            multi_scale.append(v_tap)
        x = merged
    return x, multi_scale


def backbone_apply(bb: SwinBackbone, cfg: SwinConfig, a=None, v=None, v_nega=None,
                   collect_multiscale: bool = False) -> Dict[str, torch.Tensor]:
    """Normed tokens per stream, (B*T', 49, C_last) at 224^2: {"v"} in
    `videoonly` mode (no a needed), {"a"} in `audioonly` mode (no v), both
    in the two-stream modes. v: (B, T, H, W, 3) frames; a: (B, T, F, Tt)
    fbank images. In the two-stream modes `collect_multiscale` adds
    "multi_scale" (the taps of `_run_layers`), "B" and "T" (= T'). The last
    tap is the final norm of the visual stream, so "v" is that same tensor:
    one norm, not two. In `fusion` mode `v_nega` (frames as v: AVQA's
    negative visual stream) adds "v_nega", through the visual patch embed,
    every block's `_nega_block` and the final norm, and "B" and "T"."""
    statics = backbone_statics(cfg)
    if cfg.ftmode == "videoonly":
        x, _ = _run_layers(bb, cfg, statics, patch_embed_apply(bb.patch_embed, v, cfg))
        return {"v": layernorm_fused(bb.norm, x)}
    if cfg.ftmode == "audioonly":
        x, _ = _run_layers(bb, cfg, statics,
                           patch_embed_apply(bb.patch_embed_audio, a[..., None], cfg))
        return {"a": layernorm_fused(bb.norm, x)}
    x = (patch_embed_apply(bb.patch_embed, v, cfg),
         patch_embed_apply(bb.patch_embed_audio, a[..., None], cfg))
    if v_nega is not None:
        if cfg.ftmode != "fusion":
            raise ValueError(f"the nega stream takes a fusion tower, not ftmode {cfg.ftmode!r}")
        x += (patch_embed_apply(bb.patch_embed, v_nega, cfg),)
    x, taps = _run_layers(bb, cfg, statics, x, collect_multiscale)
    vt, at = x[:2]
    out = {"a": layernorm_fused(bb.norm, at)}
    if v_nega is not None:
        out.update(v_nega=layernorm_fused(bb.norm, x[2]), B=v.shape[0],
                   T=v.shape[1] // cfg.patch_size[0])
    if collect_multiscale:
        out.update(v=taps[-1], multi_scale=taps, B=v.shape[0],
                   T=v.shape[1] // cfg.patch_size[0])
    else:
        out["v"] = layernorm_fused(bb.norm, vt)
    return out


def launches_per_forward(cfg: SwinConfig, B: int, itemsize: int = 2,
                         quantized: bool = False, nega: bool = False) -> Dict[str, int]:
    """Kernel launches of one backbone forward at batch B, in a dtype of
    `itemsize` bytes, of a float tower or (`quantized`) an int8 one, derived
    from the route functions the forward calls, for cfg.num_ttokens frames a
    clip. K1 (K2 for int8), K8 and K9 run once per stream (one stream in
    the single-stream modes, two otherwise), and in the two-stream modes K7
    (K3 at every FFN outside K4 for int8); K4, K5 and K6 once per call for
    both streams; K10 twice per call (one for each direction) at a stage
    whose full-grid exchange takes its route, and it is listed only where
    it runs. The AVS taps add no launch: the last one is the final norm.
    With `nega` (a `fusion` tower with AVQA's third stream), the nega
    stream's own: at every block its window site (K1 / K2, or the K8 core
    past 16 heads) and its FFN (K3 on an int8 tower, K7 where
    `ffn_kernel_route` takes it), the K4 stages included; no temporal site;
    K9 at its patch embed, merges and final norm."""
    blk_k, ffn_k = ("K2", "K3") if quantized else ("K1", "K7")
    single = cfg.ftmode in ("videoonly", "audioonly")
    if nega and cfg.ftmode != "fusion":
        raise ValueError(f"the nega stream takes a fusion tower, not ftmode {cfg.ftmode!r}")
    per_stream = {blk_k: 0, "K8": 0, "K9": 0} if single else {blk_k: 0, ffn_k: 0, "K8": 0,
                                                               "K9": 0}
    nega_stream = dict.fromkeys(per_stream, 0)
    per_call = {"K4": 0, "K5": 0, "K6": 0, "K10": 0}
    rows = B * cfg.num_ttokens            # frames through the tower, per stream
    H, Wd = cfg.stage_resolution(0)
    embed = ln_kernel_route(rows * H * Wd * cfg.embed_dim)                      # patch embed
    per_stream["K9"] += embed
    nega_stream["K9"] += embed
    for s, stage in enumerate(backbone_statics(cfg)):
        for st in stage:
            tokens = rows * st.H * st.W
            kernel = block_kernel_route(st.num_heads)
            site = blk_k if kernel else "K8"
            ffn = not single and (quantized or ffn_kernel_route(tokens, int(st.dim * 4.0),
                                                                itemsize))
            if st.t_attn:
                per_stream[site] += 1
                per_stream["K9"] += (not kernel) and ln_kernel_route(tokens * st.dim)
            if nega:
                nega_stream[site] += 1
                nega_stream[ffn_k] += ffn
            if st.mode == "fusion_adapt" and swin_whole_block_enabled(st):
                per_call["K4"] += 1
                continue
            per_stream[site] += 1
            if not single:
                per_stream[ffn_k] += ffn
            if st.mode == "fusion_adapt":
                D = int(st.dim * st.adapter_ratio)
                per_call["K5"] += st.use_s_adapter
                if st.use_g_adapter:
                    route = flash_fuse_route(st.H * st.W, st.H * st.W, D)
                    per_call["K6"] += route == "K6"
                    per_call["K10"] += 2 * (route == "K10")
        if s < cfg.num_layers - 1:
            H, Wd = cfg.stage_resolution(s)
            merge = ln_kernel_route(rows * (H // 2) * (Wd // 2) * 4 * cfg.stage_dim(s))
            per_stream["K9"] += merge
            nega_stream["K9"] += merge
    H, Wd = cfg.stage_resolution(cfg.num_layers - 1)
    final = ln_kernel_route(rows * H * Wd * cfg.num_features)                   # final norm
    per_stream["K9"] += final
    nega_stream["K9"] += final
    counts = {k: (1 if single else 2) * int(c) + (int(nega_stream[k]) if nega else 0)
              for k, c in per_stream.items()}
    if cfg.ftmode == "fusion":
        counts.update({k: int(c) for k, c in per_call.items() if c or k != "K10"})
    return counts
