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

Two variants under K4's id, as the kernel's `quantized` flag makes two
(:279-338, :402-407): `swin_block` for a float tower and `swin_block_q` for
an int8 one (`quantize_swin_tower`), where qkv, proj, fc1 and fc2 are int8
products with per-row activation quantization. The int8 variant quantizes
LN1 and LN2 after rounding them to the block's dtype (`_ln` returns it),
unlike K2/K3, which quantize the fp32 LN; its FFN hidden stays fp32 and
unrounded through erf-GELU up to its quantization; its attention core,
adapters and fusions are the float variant's.

On the card the block does the in-window work only: the TPU kernel's
window-major layout (`STGCMA_SWIN_WINMAJOR`, :427, per-window (WS, WS) grams
:255-256, :448) comes back as a window table (`Geo.table`: the token ids
grouped by window, ws^2 to a window), through which the attention core and
the masked fusion (S_Adapter2) read each window's rows in place and write
them back at the tokens' own rows; the unmasked fusion (S_Adapter) stays
full-grid. This is the same function, not an approximation: every skipped
logit is -1e30 plus a bias, whose exp is exactly 0 in fp32 (`pallas_swin_block.py:183-185`),
so only the order of the non-zero fp32 terms changes. The plain versions
keep the full grid with its (1, h, N, N) bias and (N, N) fusion mask, as the
public signatures do; the card wrapper takes the windows from the fusion
mask (`window_table`), and a mask whose zero entries do not tile the grid
into windows of one size raises. Reading by index, not permuting the rows
once at the block's entry and exit: the row-wise launches (LayerNorm, the
tower and adapter products) do not care about the order, and a permute
would be two more launches over both streams.

Left out on purpose: the NP padding of the grid to a multiple of 16 (a TPU
sublane artifact: the port works at N = H*W) and the `STGCMA_SWIN_*`
switches (the policy is the module constant below).
"""
from __future__ import annotations

import functools
import weakref

import numpy as np
import torch

from . import cuda_lib
from .attention import cross_modal_fuse, gather_bias
from .common import gelu, tensor_cache
from .fused_attn import (_EPI, _EPI_BF16, _EPI_BF16_RGELU, _EPI_Q_BF16, _GELU, _LN_EPS,
                         _Kernel, _attn_core, _attn_core_win, _check_cuda,
                         _check_shapes, _erf_gelu, _fuse_cuda, _gemm_bf16, _gemm_s8,
                         _heads_attention, _ln_f32, _ptr, _quant_rows, _stream,
                         check_attn_shape, check_fuse_width, check_gemm_operands, dense, dotq,
                         fuse_plain, heads_attention_recompute)
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
    rolled windows, `table` (nW, ws^2) int32: the tokens of each rolled
    window, ordered by their position in it."""

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
        self.table = np.lexsort((pos, win)).astype(np.int32).reshape(-1, ws * ws)


def window_table(fuse_mask: np.ndarray) -> np.ndarray:
    """(nW, n) int32: the windows of a fusion mask (0 inside a window, -1e30
    across), each window's tokens ascending, windows in the order of their
    first token. Raises where the zero entries are not windows of one size
    that tile the grid (a block of zeros for each window, nothing else)."""
    same = np.asarray(fuse_mask) == 0
    N = same.shape[0]
    first = same.argmax(axis=1)                 # each token's first window-mate
    firsts = np.unique(first)
    win = np.searchsorted(firsts, first)
    sizes = np.bincount(win)
    if (same.shape != (N, N) or len(set(sizes.tolist())) != 1
            or not np.array_equal(same, win[:, None] == win[None, :])):
        raise ValueError("K4 takes a fusion mask whose zero entries tile the grid into "
                         "windows of one size")
    return np.argsort(win, kind="stable").astype(np.int32).reshape(len(firsts), -1)


@functools.lru_cache(maxsize=64)
def geo(H: int, W: int, ws: int, ss: int) -> Geo:
    return Geo(H, W, ws, ss)


# id(fusion mask) -> (a weak reference to it, its version counter, its window
# table on its device); an entry goes with its mask
_TABLES = {}


def _version(t):
    """t's in-place version counter (an inference tensor keeps none: None)."""
    return None if t.is_inference() else t._version


def _remember_table(fuse_mask, table):
    key = id(fuse_mask)
    ref = weakref.ref(fuse_mask, lambda _, key=key: _TABLES.pop(key, None))
    _TABLES[key] = (ref, _version(fuse_mask), table)
    return table


@tensor_cache
def _geo_tensors(H: int, W: int, ws: int, ss: int, device: torch.device):
    g = geo(H, W, ws, ss)
    fuse_mask = torch.from_numpy(g.fuse_mask).to(device)
    _remember_table(fuse_mask, torch.from_numpy(g.table).to(device))
    return (torch.from_numpy(g.bias_index).to(device), torch.from_numpy(g.attn_mask).to(device),
            fuse_mask)


def _window_table_of(fuse_mask):
    """The window table of a fusion mask on its device: `Geo.table` for the
    masks of `_geo_tensors`, else read from the mask once (a copy to the
    host) and kept while the mask lives unchanged (an inference tensor is
    taken as unchanged: it counts no in-place versions)."""
    hit = _TABLES.get(id(fuse_mask))
    if hit is not None and hit[0]() is fuse_mask and hit[1] == _version(fuse_mask):
        return hit[2]
    with torch.inference_mode(False):        # kept past the request that made it
        table = torch.from_numpy(window_table(fuse_mask.cpu().numpy())).to(fuse_mask.device)
    return _remember_table(fuse_mask, table)


# ---------------------------------------------------------------------------
# plain version
# ---------------------------------------------------------------------------

# the block's four tower products: short name of the weight, its scale (int8
# only) and its bias
TOWER = (("w_qkv", "s_qkv", "b_qkv"), ("w_proj", "s_proj", "b_proj"),
         ("w1", "s1", "b1"), ("w2", "s2", "b2"))


def tower_weights(w: dict, linears) -> dict:
    """Add the tower products' operands to w under TOWER's names, one linear
    per entry of TOWER in order: the float `weight`, or the int8 `weight_q`
    with its per-output-channel scale."""
    for (wk, sk, bk), lin in zip(TOWER, linears):
        w[bk] = lin.bias
        if lin.quantized:
            w[wk], w[sk] = lin.weight_q, lin.weight_s
        else:
            w[wk] = lin.weight
    return w


def adapter_weights(w: dict, key: str, ad) -> dict:
    """Add an Adapter's two linears to w as `<key>_w1`, `_b1`, `_w2`, `_b2`."""
    w.update({f"{key}_w1": ad.D_fc1.weight, f"{key}_b1": ad.D_fc1.bias,
              f"{key}_w2": ad.D_fc2.weight, f"{key}_b2": ad.D_fc2.bias})
    return w


def block_weights(blk) -> dict:
    """The tensors of a fusion-mode SwinBlock that K4 reads, by short name.
    For an int8 tower the four products' weights are the int8 `weight_q`,
    with their per-output-channel scales under the `s_*` names of TOWER."""
    w = {"ln1_w": blk.norm1.weight, "ln1_b": blk.norm1.bias,
         "ln2_w": blk.norm2.weight, "ln2_b": blk.norm2.bias,
         "gate_v": blk.gate_v, "gate_a": blk.gate_a}
    tower_weights(w, (blk.attn.qkv, blk.attn.proj, blk.mlp.fc1, blk.mlp.fc2))
    for key, attr in ADAPTERS:
        adapter_weights(w, key, getattr(blk, attr))
    return w


def _lin(x, w, b, dt):
    return (torch.matmul(x.float(), w.float().t()) + b.float()).to(dt)


def _linq(x, w, key):
    """The int8 product of `_dotq` (fp32 x quantized per row) + bias, in fp32."""
    wk, sk, bk = key
    return dotq(x.float(), w[wk], w[sk]) + w[bk].float()


def _swin_block_plain(v, a, w, heads, bias, fuse_mask, quantized):
    dt = v.dtype
    BT = v.shape[0]

    def hidden(x, key):               # gelu(bf16(x.W1 + b1)), rounded again
        return _erf_gelu(_lin(x, w[f"{key}_w1"], w[f"{key}_b1"], dt).float()).to(dt)

    def adapter_out(h, key, r1, r2):  # (r1 + r2) + bf16(h.W2 + b2)
        return (r1 + r2) + _lin(h, w[f"{key}_w2"], w[f"{key}_b2"], dt)

    def tower(x, i):                  # the i-th tower product, rounded to dt
        wk, _, bk = TOWER[i]
        return _linq(x, w, TOWER[i]).to(dt) if quantized else _lin(x, w[wk], w[bk], dt)

    xn = _ln_f32(torch.cat([v, a]), w["ln1_w"], w["ln1_b"]).to(dt)
    o = _heads_attention(tower(xn, 0), heads, bias, dt)
    s = tower(o, 1)
    vs, as_ = s[:BT], s[BT:]
    vh, ah = fuse_plain(hidden(vs, "s2v"), hidden(as_, "s2a"), w["gate_v"], w["gate_a"],
                        fuse_mask)
    v1, a1 = adapter_out(vh, "s2v", v, vs), adapter_out(ah, "s2a", a, as_)
    xn2 = _ln_f32(torch.cat([v1, a1]), w["ln2_w"], w["ln2_b"]).to(dt)
    if quantized:                     # the fp32 hidden is quantized unrounded
        n = tower(_erf_gelu(_linq(xn2, w, TOWER[2])), 3)
    else:
        n = tower(_erf_gelu(_lin(xn2, w["w1"], w["b1"], dt).float()).to(dt), 3)
    vn, an = n[:BT], n[BT:]
    vh2, ah2 = fuse_plain(hidden(vn, "sv"), hidden(an, "sa"), w["gate_v"], w["gate_a"])
    return adapter_out(vh2, "sv", v1, vn), adapter_out(ah2, "sa", a1, an)


def swin_block_plain(v, a, w, heads, bias, fuse_mask):
    """`_fullgrid_naive` at K4's rounding points. v, a: (BT, N, C); w:
    `block_weights`; bias: (1, h, N, N) fp32, the gathered relative-position
    bias plus `attn_mask`; fuse_mask: (N, N) fp32. Returns (vo, ao)."""
    return _swin_block_plain(v, a, w, heads, bias, fuse_mask, quantized=False)


def swin_block_q_plain(v, a, w, heads, bias, fuse_mask):
    """The int8 variant (`_swin_block_kernel(quantized=True)`) at its rounding
    points: LN1 rounded to dt, then `_dotq` of it for qkv (one row
    quantization shared by every head), + bias, rounded; the float core;
    `_dotq` of the merged heads for proj; LN2 rounded, `_dotq` + b1 ->
    erf-GELU in fp32 -> `_dotq` + b2, rounded. w: `block_weights` of an int8
    block (the `s_*` scales of TOWER)."""
    return _swin_block_plain(v, a, w, heads, bias, fuse_mask, quantized=True)


def _fusion_recompute(v, a, w, attn, act, keys, fuse_mask=None):
    """The XLA reference of a whole fusion block (`_fullgrid_naive` of K4,
    `_fusion_spatial_naive` of K12) in v's dtype: `attn(x)` the attention
    of each stream; the adapter hiddens gelu(x . W1 + b1) of the first two
    adapters of `keys` fused by `cross_modal_fuse` (masked by `fuse_mask`
    where given), (x + s) + (h . W2 + b2); LN2, the FFN with `act`, the
    last two adapters' fusion unmasked, the residuals. Every product, bias
    add, activation and residual in the dtype; LayerNorm and the softmaxes in
    fp32. The same order of operations as JAX's, for its autograd to match
    JAX's vjp."""
    def hidden(x, key):
        return gelu(dense(x, w[f"{key}_w1"], w[f"{key}_b1"]))

    def up(h, key):
        return dense(h, w[f"{key}_w2"], w[f"{key}_b2"])

    def ffn(x):
        xn = _ln_f32(x, w["ln2_w"], w["ln2_b"]).to(x.dtype)
        return dense(act(dense(xn, w["w1"], w["b1"])), w["w2"], w["b2"])

    kv, ka, kv2, ka2 = keys
    vs, as_ = attn(v), attn(a)
    vh, ah = cross_modal_fuse(hidden(vs, kv), hidden(as_, ka), w["gate_v"], w["gate_a"],
                              fuse_mask)
    v = v + vs + up(vh, kv)
    a = a + as_ + up(ah, ka)
    vn, an = ffn(v), ffn(a)
    vh, ah = cross_modal_fuse(hidden(vn, kv2), hidden(an, ka2), w["gate_v"], w["gate_a"])
    return v + vn + up(vh, kv2), a + an + up(ah, ka2)


def swin_block_recompute(v, a, w, heads, bias, fuse_mask):
    """K4's backward recompute: the port of `_fullgrid_naive` (:182), which
    the JAX `_sb_bwd` (:558) differentiates: `_fusion_recompute` with
    the attention over the masked full grid (`bias` (1, h, N, N): the
    gathered table plus the window and shift masks, JAX's `bias_full`), the
    S_Adapter2 fusion masked by `fuse_mask`, erf-GELU in the FFN. The
    gradient of `bias` flows on to the table through `gather_bias`."""
    def attn(x):
        xn = _ln_f32(x, w["ln1_w"], w["ln1_b"]).to(x.dtype)
        return dense(heads_attention_recompute(dense(xn, w["w_qkv"], w["b_qkv"]), heads, bias),
                     w["w_proj"], w["b_proj"])
    return _fusion_recompute(v, a, w, attn, gelu, [k for k, _ in ADAPTERS], fuse_mask)


# ---------------------------------------------------------------------------
# the kernel: a composition of hand-written launches
# ---------------------------------------------------------------------------

def _gemm_res2(a, w, b, r1, r2, out, s):
    """out = bf16(bf16(r1 + r2) + bf16(a . w^T + b))."""
    check_gemm_operands(a, w, out, r1, r2)
    M, K = a.shape
    cuda_lib.check("gemm.cu", cuda_lib.lib("gemm.cu").stg_gemm_bf16_res2(
        _ptr(a), _ptr(w), _ptr(b), _ptr(r1), _ptr(r2), _ptr(out), M, w.shape[0], K, s))
    return out


def _ln_pair(x0, x1, ln_w, ln_b, out, s):
    """LayerNorm of the rows of x0, then of x1 (M0 rows each of C, bf16),
    into out (2 * M0, C) bf16, in one launch."""
    M0, C = x0.shape
    cuda_lib.check("rowprep.cu", cuda_lib.lib("rowprep.cu").stg_ln_bf16_pair(
        _ptr(x0), _ptr(x1), M0, _ptr(ln_w), _ptr(ln_b), _ptr(out), M0 + x1.shape[0], C, _LN_EPS,
        s))
    return out


def _ln_quant_pair(x0, x1, ln_w, ln_b, s):
    """The int8 variant's LN: LayerNorm of the rows of x0, then of x1 (bf16,
    C a multiple of 16), rounded to bf16, then row-quantized, in one launch.
    Returns (int8 codes (M, C), fp32 scales (M,))."""
    (M0, C), M = x0.shape, x0.shape[0] + x1.shape[0]
    q = torch.empty((M, C), dtype=torch.int8, device=x0.device)
    sx = torch.empty((M,), dtype=torch.float32, device=x0.device)
    cuda_lib.check("rowprep.cu", cuda_lib.lib("rowprep.cu").stg_ln_quant_rows_bf16(
        _ptr(x0), _ptr(x1), M0, _ptr(ln_w), _ptr(ln_b), _ptr(q), _ptr(sx), M, C, _LN_EPS, s))
    return q, sx


def _adapter_hidden_pair(xv, xa, wv, bv, wa, ba, out, s):
    """out[0] = bf16(gelu(bf16(xv . wv^T + bv))), out[1] likewise of xa with
    the audio adapter's weights: both streams' adapter hiddens in one launch."""
    check_gemm_operands(xv, wv, out[0], name="the adapter hidden pair")
    check_gemm_operands(xa, wa, out[1], name="the adapter hidden pair")
    M, K = xv.shape
    cuda_lib.check("adapter.cu", cuda_lib.lib("adapter.cu").stg_adapter_hidden_pair(
        _ptr(xv), _ptr(wv), _ptr(bv), _ptr(out[0]), _ptr(xa), _ptr(wa), _ptr(ba), _ptr(out[1]),
        M, wv.shape[0], K, s))
    return out


def _adapter_out_pair(fv, fa, wv, bv, wa, ba, rv, ra, out, s):
    """out rows [0, M) = bf16(bf16(rv[0] + rv[1]) + bf16(fv . wv^T + bv)),
    rows [M, 2M) likewise of fa, ra and the audio adapter: both streams'
    adapter outputs onto their two residuals in one launch."""
    M = fv.shape[0]
    check_gemm_operands(fv, wv, out[:M], *rv, name="the adapter output pair")
    check_gemm_operands(fa, wa, out[M:], *ra, name="the adapter output pair")
    cuda_lib.check("adapter.cu", cuda_lib.lib("adapter.cu").stg_adapter_out_pair(
        _ptr(fv), _ptr(wv), _ptr(bv), _ptr(rv[0]), _ptr(rv[1]), _ptr(out[:M]), _ptr(fa),
        _ptr(wa), _ptr(ba), _ptr(ra[0]), _ptr(ra[1]), _ptr(out[M:]), M, wv.shape[0],
        fv.shape[1], s))
    return out


def _fuse_win(vh, ah, gate_v, gate_a, table, s):
    """The bidirectional gated fusion of each window of vh, ah (BT, N, D)
    through `table` (nW, n), unmasked; (vo, ao) at the tokens' own rows."""
    BT, N, D = vh.shape
    nW, n = table.shape
    vo, ao = torch.empty_like(vh), torch.empty_like(ah)
    cuda_lib.check("fuse.cu", cuda_lib.lib("fuse.cu").stg_fuse_bidir_win(
        _ptr(vh), _ptr(ah), _ptr(gate_v), _ptr(gate_a), _ptr(table), nW, _ptr(vo), _ptr(ao), BT,
        N, n, D, s))
    return vo, ao


def _swin_block_cuda(v, a, w, heads, bias, fuse_mask, quantized=False):
    if v.dim() != 3:
        raise ValueError(f"v must be (BT, N, C), got {tuple(v.shape)}")
    BT, N, C = v.shape
    Hd, D = w["w1"].shape[0], w["s2v_w1"].shape[0]
    bf, f32, i8 = torch.bfloat16, torch.float32, torch.int8
    step = 16 if quantized else 8      # int8 rows of 16-byte chunks in gemm.cu
    if C % heads or N > WHOLE_BLOCK_MAX_GRID:
        raise ValueError(f"K4 takes grids of <= {WHOLE_BLOCK_MAX_GRID} tokens and C a multiple "
                         f"of heads, got N={N}, C={C}, heads={heads}")
    check_attn_shape(N, C // heads, "K4")
    check_fuse_width(D, "K4")
    if C % step or Hd % step:
        raise ValueError(f"K4 takes C and the FFN hidden in multiples of {step}, got C={C}, "
                         f"hidden={Hd}")
    int8_keys = {wk for wk, _, _ in TOWER} if quantized else set()
    scale_keys = {sk for _, sk, _ in TOWER}
    if quantized != all(k in w for k in scale_keys):
        raise ValueError(f"K4 {'int8' if quantized else 'float'} variant given the weights of "
                         f"the other one")
    _check_cuda(v, {"v": (v, bf), "a": (a, bf), "bias": (bias, f32),
                    "fuse_mask": (fuse_mask, f32),
                    **{k: (t, i8 if k in int8_keys else bf) for k, t in w.items()}})
    shapes = {"a": (a, (BT, N, C)), "bias": (bias, (1, heads, N, N)),
              "fuse_mask": (fuse_mask, (N, N)), "ln1_w": (w["ln1_w"], (C,)),
              "ln1_b": (w["ln1_b"], (C,)), "w_qkv": (w["w_qkv"], (3 * C, C)),
              "b_qkv": (w["b_qkv"], (3 * C,)), "w_proj": (w["w_proj"], (C, C)),
              "b_proj": (w["b_proj"], (C,)), "ln2_w": (w["ln2_w"], (C,)),
              "ln2_b": (w["ln2_b"], (C,)), "w1": (w["w1"], (Hd, C)), "b1": (w["b1"], (Hd,)),
              "w2": (w["w2"], (C, Hd)), "b2": (w["b2"], (C,)),
              "gate_v": (w["gate_v"], (1,)), "gate_a": (w["gate_a"], (1,))}
    if quantized:
        shapes.update({"s_qkv": (w["s_qkv"], (3 * C,)), "s_proj": (w["s_proj"], (C,)),
                       "s1": (w["s1"], (Hd,)), "s2": (w["s2"], (C,))})
    for key, _ in ADAPTERS:
        shapes.update({f"{key}_w1": (w[f"{key}_w1"], (D, C)), f"{key}_b1": (w[f"{key}_b1"], (D,)),
                       f"{key}_w2": (w[f"{key}_w2"], (C, D)), f"{key}_b2": (w[f"{key}_b2"], (C,))})
    _check_shapes(shapes)
    table = _window_table_of(fuse_mask)
    nW = table.shape[0]
    s = _stream(v)
    M = BT * N

    def empty(*shape, dtype=bf):
        return torch.empty(shape, dtype=dtype, device=v.device)

    def tower(x, i, out, gelu=False, x_amax=None, out_amax=None, codes=None):
        """The i-th tower product of TOWER into `out`: bf16 GEMM (GELU:
        rounded before and after it), or row quantization of x (bf16 or
        fp32; from its rows' max |x| `x_amax` where given; `codes`: x's
        int8 codes and scales, made already) + int8 GEMM (GELU: into an fp32
        hidden, each row's max |h| into `out_amax`)."""
        wk, sk, bk = TOWER[i]
        if not quantized:
            return _gemm_bf16(x, w[wk], w[bk], out, _EPI_BF16_RGELU if gelu else _EPI_BF16, s)
        xq, sx = codes or _quant_rows(x, s, amax=x_amax)
        return _gemm_s8(xq, sx, w[wk], w[sk], w[bk], out, _EPI[_GELU] if gelu else _EPI_Q_BF16,
                        s, amax=out_amax)

    def ln(x0, x1, key):               # LN of both streams: bf16 rows, or int8 codes
        if quantized:
            return None, _ln_quant_pair(x0, x1, w[f"{key}_w"], w[f"{key}_b"], s)
        return _ln_pair(x0, x1, w[f"{key}_w"], w[f"{key}_b"], empty(2 * M, C), s), None

    def fuse(xv, xa, kv, ka, windows):  # both adapter hiddens, then fuse.cu
        h = _adapter_hidden_pair(xv, xa, w[f"{kv}_w1"], w[f"{kv}_b1"], w[f"{ka}_w1"],
                                 w[f"{ka}_b1"], empty(2, M, D), s)
        hv, ha = h[0].view(BT, N, D), h[1].view(BT, N, D)
        if windows and nW > 1:
            return _fuse_win(hv, ha, w["gate_v"], w["gate_a"], table, s)
        return _fuse_cuda(hv, ha, w["gate_v"], w["gate_a"], None)

    def residual(fv, fa, kv, ka, rv, ra):   # both adapter outputs onto their two residuals
        return _adapter_out_pair(fv.view(M, D), fa.view(M, D), w[f"{kv}_w2"], w[f"{kv}_b2"],
                                 w[f"{ka}_w2"], w[f"{ka}_b2"], rv, ra, empty(2 * M, C), s)

    v2, a2 = v.view(M, C), a.view(M, C)
    xn, xq = ln(v2, a2, "ln1")             # LN1 of [v; a], one 2*BT slab
    qkv = tower(xn, 0, empty(2 * M, 3 * C), codes=xq).view(2 * BT, N, 3 * C)
    if nW > 1:                             # each window's own tokens
        o = _attn_core_win(qkv, bias, table, heads, s)
    else:
        o = _attn_core(qkv, bias, heads, s)
    att = tower(o.view(2 * M, C), 1, empty(2 * M, C))
    vs, as_ = att[:M], att[M:]
    fv, fa = fuse(vs, as_, "s2v", "s2a", windows=True)
    x1 = residual(fv, fa, "s2v", "s2a", (v2, vs), (a2, as_))
    xn2, xq2 = ln(x1[:M], x1[M:], "ln2")
    hmax = empty(2 * M, dtype=f32).zero_() if quantized else None   # fc1's row max |h|
    hid = tower(xn2, 2, empty(2 * M, Hd, dtype=f32 if quantized else bf), gelu=True,
                out_amax=hmax, codes=xq2)
    n_ = tower(hid, 3, empty(2 * M, C), x_amax=hmax)
    fv2, fa2 = fuse(n_[:M], n_[M:], "sv", "sa", windows=False)
    y = residual(fv2, fa2, "sv", "sa", (x1[:M], n_[:M]), (x1[M:], n_[M:]))
    return y[:M].view(BT, N, C), y[M:].view(BT, N, C)


def _swin_block_q_cuda(v, a, w, heads, bias, fuse_mask):
    return _swin_block_cuda(v, a, w, heads, bias, fuse_mask, quantized=True)


swin_block = _Kernel("K4", "swin_block", swin_block_plain, _swin_block_cuda,
                     recompute=swin_block_recompute)
swin_block_q = _Kernel("K4", "swin_block_q", swin_block_q_plain, _swin_block_q_cuda)


# ---------------------------------------------------------------------------
# entry points
# ---------------------------------------------------------------------------

def swin_whole_block_enabled(st) -> bool:
    """K4 policy: fusion mode, a grid of <= 256 tokens (Swin-Base stages 2-3,
    20 of 24 blocks), both fusion adapters, heads dividing the width."""
    return (st.mode == "fusion_adapt" and st.H * st.W <= WHOLE_BLOCK_MAX_GRID
            and st.use_s_adapter and st.use_g_adapter and st.dim % st.num_heads == 0)


def swin_fusion_whole_block(blk, v, a, st):
    """The post-temporal fusion block in K4, its int8 variant for an int8
    tower (`quantized = "kernel_q" in p["attn"]["qkv"]`, :469). v, a: (BT,
    H*W, C). The bias
    is gathered from the block's table on every call, as JAX does in its
    jit; the index and masks are built once per geometry and device."""
    index, attn_mask, fuse_mask = _geo_tensors(st.H, st.W, st.window_size, st.shift_size,
                                               v.device)
    N = st.H * st.W
    v, a = v.contiguous(), a.contiguous()     # the temporal transpose is a view at B = 1
    bias = gather_bias(blk.attn.relative_position_bias_table, index, st.num_heads, N)
    bias = (bias + attn_mask)[None].contiguous()
    kernel = swin_block_q if blk.attn.qkv.quantized else swin_block
    return kernel(v, a, block_weights(blk), st.num_heads, bias, fuse_mask)
