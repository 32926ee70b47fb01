"""The whole Swin fusion block K4: full-grid geometry, plain version, kernel
wrapper and entry points.

Port of `stgcma_tpu/ops/pallas_swin_block.py`: `_Geo` (:74-127, the
row-major part), `_fullgrid_naive` (:182) at the rounding points of
`_swin_block_kernel` (:245), `swin_whole_block_enabled` (:577) and
`swin_fusion_whole_block` (:592). The block after the temporal branch runs
over the full H*W grid of a stage, the windows encoded as additive masks:
W-MSA of both streams (one 2*BT slab), the S_Adapter2 hiddens with the
per-window bidirectional gated fusion, the residuals, LN2 + FFN with
erf-GELU, the S_Adapter hiddens with the unmasked full-grid fusion, the
residuals.

Left out on purpose: the window-major layout (`STGCMA_SWIN_WINMAJOR`, :427,
a TPU opt-in measured net-negative there), the NP padding of the grid to a
multiple of 16 (a TPU sublane artifact: the port works at N = H*W), the
`STGCMA_SWIN_*` switches (the policy is the module constant below) and the
int8 variant (`quantized=True`, with int8 Swin).
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from . import cuda_lib
from .attention import gather_bias
from .fused_attn import (_EPI_BF16, _EPI_BF16_RGELU, _Kernel, _attn_core, _check_cuda,
                         _check_shapes, _erf_gelu, _fuse_cuda, _gemm_bf16, _heads_attention,
                         _ln_bf16, _ln_f32, _ptr, _stream, fuse_plain)
from .window import relative_position_index

WHOLE_BLOCK_MAX_GRID = 256            # K4 for grids of <= 256 tokens (pallas_swin_block.py:587)
ADAPTERS = (("s2v", "S_Adapter2"), ("s2a", "S_Adapter2_Audio"),
            ("sv", "S_Adapter"), ("sa", "S_Adapter_Audio"))


# ---------------------------------------------------------------------------
# static full-grid geometry
# ---------------------------------------------------------------------------

class Geo:
    """Constants of one (H, W, ws, ss) block geometry over N = H*W tokens:
    `bias_index` (N, N) int32 into the relative-position table,
    `attn_mask` (N, N) fp32, -1e30 across rolled windows and -100 between
    shift regions inside a window, `fuse_mask` (N, N) fp32, -1e30 across
    rolled windows."""

    def __init__(self, H: int, W: int, ws: int, ss: int):
        N = H * W
        ii, jj = np.meshgrid(np.arange(H), np.arange(W), indexing="ij")
        # token (i, j) sits at rolled coordinates (r, c) after roll(x, (-ss, -ss))
        r = (ii - ss) % H
        c = (jj - ss) % W
        win = ((r // ws) * (W // ws) + (c // ws)).reshape(-1)
        pos = ((r % ws) * ws + (c % ws)).reshape(-1)
        same_win = win[:, None] == win[None, :]
        rel = relative_position_index(ws)
        self.N = N
        self.bias_index = rel[pos[:, None], pos[None, :]].astype(np.int32)
        attn_mask = np.where(same_win, 0.0, -1e30).astype(np.float32)
        if ss > 0:
            # the region of the shift mask is a function of the rolled coordinate
            region = np.zeros((H, W), np.int32)
            cnt = 0
            for hs in (slice(0, -ws), slice(-ws, -ss), slice(-ss, None)):
                for wsl in (slice(0, -ws), slice(-ws, -ss), slice(-ss, None)):
                    region[hs, wsl] = cnt
                    cnt += 1
            reg = region[r, c].reshape(-1)
            attn_mask += np.where(same_win & (reg[:, None] != reg[None, :]),
                                  np.float32(-100.0), np.float32(0.0))
        self.attn_mask = attn_mask
        self.fuse_mask = np.where(same_win, 0.0, -1e30).astype(np.float32)


@functools.lru_cache(maxsize=64)
def geo(H: int, W: int, ws: int, ss: int) -> Geo:
    return Geo(H, W, ws, ss)


@functools.lru_cache(maxsize=64)
def _geo_tensors(H: int, W: int, ws: int, ss: int, device: torch.device):
    g = geo(H, W, ws, ss)
    return (torch.from_numpy(g.bias_index).to(device), torch.from_numpy(g.attn_mask).to(device),
            torch.from_numpy(g.fuse_mask).to(device))


# ---------------------------------------------------------------------------
# plain version
# ---------------------------------------------------------------------------

def block_weights(blk) -> dict:
    """The tensors of a fusion-mode SwinBlock that K4 reads, by short name."""
    w = {"ln1_w": blk.norm1.weight, "ln1_b": blk.norm1.bias,
         "w_qkv": blk.attn.qkv.weight, "b_qkv": blk.attn.qkv.bias,
         "w_proj": blk.attn.proj.weight, "b_proj": blk.attn.proj.bias,
         "ln2_w": blk.norm2.weight, "ln2_b": blk.norm2.bias,
         "w1": blk.mlp.fc1.weight, "b1": blk.mlp.fc1.bias,
         "w2": blk.mlp.fc2.weight, "b2": blk.mlp.fc2.bias,
         "gate_v": blk.gate_v, "gate_a": blk.gate_a}
    for key, attr in ADAPTERS:
        ad = getattr(blk, attr)
        w.update({f"{key}_w1": ad.D_fc1.weight, f"{key}_b1": ad.D_fc1.bias,
                  f"{key}_w2": ad.D_fc2.weight, f"{key}_b2": ad.D_fc2.bias})
    return w


def _lin(x, w, b, dt):
    return (torch.matmul(x.float(), w.float().t()) + b.float()).to(dt)


def swin_block_plain(v, a, w, heads, bias, fuse_mask):
    """`_fullgrid_naive` at K4's rounding points. v, a: (BT, N, C); w:
    `block_weights`; bias: (1, h, N, N) fp32, the gathered relative-position
    bias plus `attn_mask`; fuse_mask: (N, N) fp32. Returns (vo, ao)."""
    dt = v.dtype
    BT = v.shape[0]

    def hidden(x, key):               # gelu(bf16(x.W1 + b1)), rounded again
        return _erf_gelu(_lin(x, w[f"{key}_w1"], w[f"{key}_b1"], dt).float()).to(dt)

    def adapter_out(h, key, r1, r2):  # (r1 + r2) + bf16(h.W2 + b2)
        return (r1 + r2) + _lin(h, w[f"{key}_w2"], w[f"{key}_b2"], dt)

    xn = _ln_f32(torch.cat([v, a]), w["ln1_w"], w["ln1_b"]).to(dt)
    o = _heads_attention(_lin(xn, w["w_qkv"], w["b_qkv"], dt), heads, bias, dt)
    s = _lin(o, w["w_proj"], w["b_proj"], dt)
    vs, as_ = s[:BT], s[BT:]
    vh, ah = fuse_plain(hidden(vs, "s2v"), hidden(as_, "s2a"), w["gate_v"], w["gate_a"],
                        fuse_mask)
    v1, a1 = adapter_out(vh, "s2v", v, vs), adapter_out(ah, "s2a", a, as_)
    xn2 = _ln_f32(torch.cat([v1, a1]), w["ln2_w"], w["ln2_b"]).to(dt)
    hid = _erf_gelu(_lin(xn2, w["w1"], w["b1"], dt).float()).to(dt)
    n = _lin(hid, w["w2"], w["b2"], dt)
    vn, an = n[:BT], n[BT:]
    vh2, ah2 = fuse_plain(hidden(vn, "sv"), hidden(an, "sa"), w["gate_v"], w["gate_a"])
    return adapter_out(vh2, "sv", v1, vn), adapter_out(ah2, "sa", a1, an)


# ---------------------------------------------------------------------------
# the kernel: a composition of hand-written launches
# ---------------------------------------------------------------------------

def _gemm_res2(a, w, b, r1, r2, out, s):
    """out = bf16(bf16(r1 + r2) + bf16(a . w^T + b))."""
    M, K = a.shape
    cuda_lib.check("gemm.cu", cuda_lib.lib("gemm.cu").stg_gemm_bf16_res2(
        _ptr(a), _ptr(w), _ptr(b), _ptr(r1), _ptr(r2), _ptr(out), M, w.shape[0], K, s))
    return out


def _swin_block_cuda(v, a, w, heads, bias, fuse_mask):
    if v.dim() != 3:
        raise ValueError(f"v must be (BT, N, C), got {tuple(v.shape)}")
    BT, N, C = v.shape
    Hd, D = w["w1"].shape[0], w["s2v_w1"].shape[0]
    bf, f32 = torch.bfloat16, torch.float32
    if C % heads or C // heads not in (32, 64) or N > 256:
        raise ValueError(f"K4 takes N <= 256 tokens and heads of width 32 or 64, got N={N}, "
                         f"C={C}, heads={heads}")
    if C % 8 or Hd % 8 or D not in (16, 32, 64):
        raise ValueError(f"K4 takes C and the FFN hidden in multiples of 8 and adapter "
                         f"widths 16, 32 or 64, got C={C}, hidden={Hd}, D={D}")
    _check_cuda(v, {"v": (v, bf), "a": (a, bf), "bias": (bias, f32),
                    "fuse_mask": (fuse_mask, f32), **{k: (t, bf) for k, t in w.items()}})
    shapes = {"a": (a, (BT, N, C)), "bias": (bias, (1, heads, N, N)),
              "fuse_mask": (fuse_mask, (N, N)), "ln1_w": (w["ln1_w"], (C,)),
              "ln1_b": (w["ln1_b"], (C,)), "w_qkv": (w["w_qkv"], (3 * C, C)),
              "b_qkv": (w["b_qkv"], (3 * C,)), "w_proj": (w["w_proj"], (C, C)),
              "b_proj": (w["b_proj"], (C,)), "ln2_w": (w["ln2_w"], (C,)),
              "ln2_b": (w["ln2_b"], (C,)), "w1": (w["w1"], (Hd, C)), "b1": (w["b1"], (Hd,)),
              "w2": (w["w2"], (C, Hd)), "b2": (w["b2"], (C,)),
              "gate_v": (w["gate_v"], (1,)), "gate_a": (w["gate_a"], (1,))}
    for key, _ in ADAPTERS:
        shapes.update({f"{key}_w1": (w[f"{key}_w1"], (D, C)), f"{key}_b1": (w[f"{key}_b1"], (D,)),
                       f"{key}_w2": (w[f"{key}_w2"], (C, D)), f"{key}_b2": (w[f"{key}_b2"], (C,))})
    _check_shapes(shapes)
    s = _stream(v)
    M = BT * N

    def empty(*shape):
        return torch.empty(shape, dtype=bf, device=v.device)

    def fuse(xv, xa, kv, ka, mask):    # per-stream adapter hiddens, then fuse.cu
        h = empty(2, M, D)
        _gemm_bf16(xv, w[f"{kv}_w1"], w[f"{kv}_b1"], h[0], _EPI_BF16_RGELU, s)
        _gemm_bf16(xa, w[f"{ka}_w1"], w[f"{ka}_b1"], h[1], _EPI_BF16_RGELU, s)
        return _fuse_cuda(h[0].view(BT, N, D), h[1].view(BT, N, D), w["gate_v"], w["gate_a"],
                          mask)

    def residual(fv, fa, kv, ka, rv, ra):   # per-stream adapter outputs + two residuals
        y = empty(2 * M, C)
        _gemm_res2(fv.view(M, D), w[f"{kv}_w2"], w[f"{kv}_b2"], rv[0], rv[1], y[:M], s)
        _gemm_res2(fa.view(M, D), w[f"{ka}_w2"], w[f"{ka}_b2"], ra[0], ra[1], y[M:], s)
        return y

    v2, a2 = v.view(M, C), a.view(M, C)
    xn = empty(2 * M, C)                   # LN1 of [v; a], one 2*BT slab
    _ln_bf16(v2, w["ln1_w"], w["ln1_b"], s, out=xn[:M])
    _ln_bf16(a2, w["ln1_w"], w["ln1_b"], s, out=xn[M:])
    qkv = _gemm_bf16(xn, w["w_qkv"], w["b_qkv"], empty(2 * M, 3 * C), _EPI_BF16, s)
    o = _attn_core(qkv.view(2 * BT, N, 3 * C), bias, heads, s)
    att = _gemm_bf16(o.view(2 * M, C), w["w_proj"], w["b_proj"], empty(2 * M, C), _EPI_BF16, s)
    vs, as_ = att[:M], att[M:]
    fv, fa = fuse(vs, as_, "s2v", "s2a", fuse_mask)
    x1 = residual(fv, fa, "s2v", "s2a", (v2, vs), (a2, as_))
    xn2 = _ln_bf16(x1, w["ln2_w"], w["ln2_b"], s)
    hid = _gemm_bf16(xn2, w["w1"], w["b1"], empty(2 * M, Hd), _EPI_BF16_RGELU, s)
    n = _gemm_bf16(hid, w["w2"], w["b2"], empty(2 * M, C), _EPI_BF16, s)
    fv2, fa2 = fuse(n[:M], n[M:], "sv", "sa", None)
    y = residual(fv2, fa2, "sv", "sa", (x1[:M], n[:M]), (x1[M:], n[M:]))
    return y[:M].view(BT, N, C), y[M:].view(BT, N, C)


swin_block = _Kernel("K4", "swin_block", swin_block_plain, _swin_block_cuda)


# ---------------------------------------------------------------------------
# entry points
# ---------------------------------------------------------------------------

def swin_whole_block_enabled(st) -> bool:
    """K4 policy: fusion mode, a grid of <= 256 tokens (Swin-Base stages 2-3,
    20 of 24 blocks), both fusion adapters, heads dividing the width."""
    return (st.mode == "fusion_adapt" and st.H * st.W <= WHOLE_BLOCK_MAX_GRID
            and st.use_s_adapter and st.use_g_adapter and st.dim % st.num_heads == 0)


def swin_fusion_whole_block(blk, v, a, st):
    """The post-temporal fusion block in K4. v, a: (BT, H*W, C). The bias
    is gathered from the block's table on every call, as JAX does in its
    jit; the index and masks are built once per geometry and device."""
    index, attn_mask, fuse_mask = _geo_tensors(st.H, st.W, st.window_size, st.shift_size,
                                               v.device)
    N = st.H * st.W
    v, a = v.contiguous(), a.contiguous()     # the temporal transpose is a view at B = 1
    bias = gather_bias(blk.attn.relative_position_bias_table, index, st.num_heads, N)
    bias = (bias + attn_mask)[None].contiguous()
    return swin_block(v, a, block_weights(blk), st.num_heads, bias, fuse_mask)
