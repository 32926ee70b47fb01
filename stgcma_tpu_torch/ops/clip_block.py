"""The fused CLIP fusion block: K12 (everything after the temporal stage), K13
(the temporal stage with its T_Adapter) and K14 (the same temporal stage in
the tower's own layout), plain versions, kernel wrappers and entry points.

Port of `stgcma_tpu/ops/pallas_clip_block.py` and of the transpose-free
temporal kernel of `stgcma_tpu/ops/pallas_attn.py`. With K13 and K12 in use
a CLIP `fusion` block is three kernels and nothing else: K13 on the video
rows, K13 on the audio rows, K12.

- K12 `clip_fusion_block` / `clip_fusion_block_q` replaces
  `_fusion_block_kernel` (:168; `quantized=` makes the two variants): LN1 +
  spatial self-attention on both streams, the S_Adapter hiddens with the gated
  bidirectional fusion (`_xfuse` :141, unmasked), (v + vs) + S_Adapter.fc2(.),
  LN2 + MLP with QuickGELU on the rows of both streams, the MLP_Adapter hiddens
  with the second fusion, (v + vn) + MLP_Adapter.fc2(.).
- K13 `clip_tadapt` / `clip_tadapt_q` replaces `_tadapt_kernel` (:350):
  x + T_Adapter(proj(attn(LN x))) over the frame axis, T_Adapter =
  fc2(erf-GELU(fc1(.))) without skip.
- K14 `clip_tv2` / `clip_tv2_q` replaces `pallas_attn.py::_tblock_v2_kernel`
  (:1757): the same function on x (B*T, N, C) as the tower holds it, each
  token attending over its T frames, with no transpose on either side; an
  optional (heads, T, T) fp32 bias added to every token's logits; without
  an adapter the attention output alone. Its rounding points are its own
  (:1771-1837), not K13's: LN rounded to dt for the float qkv product, but
  quantized unrounded (fp32) by the int8 variant; the adapter hidden
  erf-GELU(o.W1 + b1) in fp32 on the rounded proj output o, rounded once;
  the output bf16(x + (h.W2 + b2)) in fp32, rounded once. The TPU kernel's
  T -> 16 pad, 8-token 128-wide packing and N -> 16-multiple pad are layout
  devices left out (`_tv2_pallas` :1840).

Rounding points, the same in the plain versions and on the card (dt is the
streams' dtype): LN is rounded to dt (`_ln` :38), so the int8 variants
quantize the rounded LN rows, as K4's int8 variant does and unlike K2/K3; qkv
is rounded to dt and q scaled by a dh^-1/2 rounded to dt after it; fp32
logits, exact softmax, probabilities and head outputs rounded to dt; the
proj input is the merged heads in dt. The float fc1 takes acc + bias and
QuickGELU in fp32 and rounds once; the int8 variant keeps that hidden fp32
and quantizes it unrounded (:208-212). Adapter hiddens round acc + b1 to dt,
take erf-GELU in fp32 and round again (`_adapter_h` :131); adapter outputs
round acc + b2 (`_adapter_o` :136); the residuals are dt adds in JAX's order,
(v + vs) + out. The grams stay in dt in the int8 variants (the JAX package's
int8-gram opt-in `STGCMA_Q_INT8_GRAMS` is not carried). The TPU kernel's
A&S 7.1.26 erf differs from `erff` by < 2e-7.

On the card each wrapper is a composition of the port's own hand-written
launches in one stream (`csrc/rowprep.cu` LN and row quantization,
`csrc/gemm.cu` products with their epilogues, `csrc/attn.cu` core,
`csrc/fuse.cu` fusion, `csrc/tattn.cu` the temporal product,
`csrc/rowadapt.cu` the row-owning product with the adapter): 19 launches
for K12 (23 int8); 3 for K13 (LN, the qkv product with each sequence's
attention in its epilogue, proj with the T_Adapter and the residual on the
same rows: qkv, att and the hidden never reach device memory; 4 int8: LN
and quantization of the rounded LN rows in one launch, the merged heads
quantized), 6 (8 int8) where `tattn_route` / `rowadapt_route` do not take
its shapes; 3 for K14 (LN, T over frame-strided tiles: each sequence one
token's T frames, N rows apart in the tower's layout, with no transpose;
R with K14's own rounding of the residual, `_EPI_BF16_RESF`; 4 int8: the
fp32 LN rows quantized in one launch, T, the merged heads quantized, R);
with a (heads, T, T) bias, without an adapter or at an adapter width R
does not take, 6 (7 int8; 4 / 5 without an adapter), its attention core
reading each token's T frames N rows apart (`stg_attn_core_t`); one call of a wrapper counts as one launch. No product
goes to cuBLAS.

Left out on purpose, as TPU layout devices: K12's pad of both token streams
to multiples of 16 with masked pad keys (:294-299, :86-88; the port's
attention core and fusion take any N), and K13's packing of 8 temporal rows
into one block-diagonal gram with its mask (:401-417; each row attends over
its own T frames).
"""
from __future__ import annotations

import torch

from .common import gelu, quick_gelu
from .fused_attn import (_EPI, _EPI_BF16, _EPI_BF16_GELU, _EPI_BF16_QUICKGELU, _EPI_BF16_RES1,
                         _EPI_BF16_RESF, _EPI_BF16_RGELU, _EPI_Q_BF16, _QUICK_GELU, _Kernel, _attn_core,
                         _attn_core_t, _check_cuda, _check_shapes, _erf_gelu, _fuse_cuda,
                         _gemm_bf16, _gemm_res, _gemm_s8, _heads_attention, _ln_bf16, _ln_f32,
                         _quant_rows, _rowadapt, _stream, _tattn, check_attn_shape,
                         check_fuse_width, dense, dotq, fuse_plain, heads_attention_recompute,
                         rowadapt_route, tattn_route)
from .swin_block import (TOWER, _fusion_recompute, _gemm_res2, _lin, _ln_quant_pair,
                         adapter_weights, tower_weights)

# the four adapters K12 reads: short name -> attribute of a fusion-mode ClipBlock
ADAPTERS = (("sv", "S_Adapter"), ("sa", "S_Adapter_Audio"),
            ("mv", "MLP_Adapter"), ("ma", "MLP_Adapter_Audio"))
TADAPT_MAX_FRAMES = 16                # K13 and K14 at T <= 16 (`clip_vit.py:139`, :155)


# ---------------------------------------------------------------------------
# operands
# ---------------------------------------------------------------------------

def block_weights(blk) -> dict:
    """The tensors of a fusion-mode ClipBlock that K12 reads, by short name
    (the analogue of `_flat_args` :225). For an int8 tower the four products'
    weights are the int8 `weight_q`, with their per-output-channel scales
    under the `s_*` names of TOWER."""
    w = {"ln1_w": blk.ln_1.weight, "ln1_b": blk.ln_1.bias,
         "ln2_w": blk.ln_2.weight, "ln2_b": blk.ln_2.bias,
         "gate_v": blk.gate_v, "gate_a": blk.gate_a}
    tower_weights(w, (blk.attn.in_proj, blk.attn.out_proj, blk.mlp.c_fc, blk.mlp.c_proj))
    for key, attr in ADAPTERS:
        adapter_weights(w, key, getattr(blk, attr))
    return w


def tadapt_weights(attn, ln, adapter) -> dict:
    """K13's and K14's operands: LN1, the attention's two products and one
    T_Adapter (`ad_*`; none where `adapter` is None, K14 without an
    adapter)."""
    w = tower_weights({"ln1_w": ln.weight, "ln1_b": ln.bias}, (attn.in_proj, attn.out_proj))
    return w if adapter is None else adapter_weights(w, "ad", adapter)


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def _tower_plain(x, w, i, quantized):
    """The i-th tower product of TOWER + bias in fp32: of x's values, or of
    their per-row int8 codes (`_linq` :47)."""
    wk, sk, bk = TOWER[i]
    if quantized:
        return dotq(x.float(), w[wk], w[sk]) + w[bk].float()
    return torch.matmul(x.float(), w[wk].float().t()) + w[bk].float()


def _self_attn_plain(x, w, heads, quantized):
    dt = x.dtype
    xn = _ln_f32(x, w["ln1_w"], w["ln1_b"]).to(dt)
    qkv = _tower_plain(xn, w, 0, quantized).to(dt)
    return _tower_plain(_heads_attention(qkv, heads, None, dt), w, 1, quantized).to(dt)


def _hidden_plain(x, w, key):
    """gelu(dt(x.W1 + b1)), rounded again (`_adapter_h` :131)."""
    dt = x.dtype
    return _erf_gelu(_lin(x, w[f"{key}_w1"], w[f"{key}_b1"], dt).float()).to(dt)


def _clip_block_plain(v, a, w, heads, quantized):
    dt = v.dtype
    BT, Nv, C = v.shape
    Na = a.shape[1]

    def fuse_out(xv, xa, kv, ka, rv, ra):
        vh, ah = fuse_plain(_hidden_plain(xv, w, kv), _hidden_plain(xa, w, ka),
                            w["gate_v"], w["gate_a"])
        return ((rv + xv) + _lin(vh, w[f"{kv}_w2"], w[f"{kv}_b2"], dt),
                (ra + xa) + _lin(ah, w[f"{ka}_w2"], w[f"{ka}_b2"], dt))

    vs, as_ = _self_attn_plain(v, w, heads, quantized), _self_attn_plain(a, w, heads, quantized)
    v1, a1 = fuse_out(vs, as_, "sv", "sa", v, a)
    x = torch.cat([v1.reshape(-1, C), a1.reshape(-1, C)])
    h = _tower_plain(_ln_f32(x, w["ln2_w"], w["ln2_b"]).to(dt), w, 2, quantized)
    h = h * torch.sigmoid(1.702 * h)              # QuickGELU in fp32
    if not quantized:
        h = h.to(dt)                              # the int8 hidden is quantized unrounded
    n = _tower_plain(h, w, 3, quantized).to(dt)
    vn, an = n[:BT * Nv].view(BT, Nv, C), n[BT * Nv:].view(BT, Na, C)
    return fuse_out(vn, an, "mv", "ma", v1, a1)


def fusion_block_plain(v, a, w, heads):
    """`_fusion_spatial_naive` (:257) at K12's rounding points. v (BT, Nv, C),
    a (BT, Na, C); w: `block_weights`. Returns (vo, ao)."""
    return _clip_block_plain(v, a, w, heads, quantized=False)


def fusion_block_q_plain(v, a, w, heads):
    """The int8 variant (`_fusion_block_kernel(quantized=True)`): qkv, proj,
    fc1 and fc2 are `_dotq` products of per-row int8 codes (of the rounded
    LN rows, the merged heads, the fp32 QuickGELU hidden); the core, adapters
    and fusions are the float variant's. w: `block_weights` of an int8 block."""
    return _clip_block_plain(v, a, w, heads, quantized=True)


def _tadapt_plain(x, w, heads, quantized):
    dt = x.dtype
    o = _self_attn_plain(x, w, heads, quantized)
    return x + _lin(_hidden_plain(o, w, "ad"), w["ad_w2"], w["ad_b2"], dt)


def tadapt_plain(x, w, heads):
    """`_tadapt_naive` (:392) at K13's rounding points. x (R, T, C) temporal
    rows; w: `tadapt_weights`."""
    return _tadapt_plain(x, w, heads, quantized=False)


def tadapt_q_plain(x, w, heads):
    """K13 with the int8 qkv and proj products (`_tadapt_kernel(quantized=True)`)."""
    return _tadapt_plain(x, w, heads, quantized=True)


def _tv2_plain(x, w, heads, T, bias, quantized):
    dt = x.dtype
    BT, N, C = x.shape
    B = BT // T
    xn = _ln_f32(x, w["ln1_w"], w["ln1_b"])
    qkv = _tower_plain(xn if quantized else xn.to(dt), w, 0, quantized).to(dt)
    # each token's T frames: a permute here; on the card the core's addressing
    qkv = qkv.view(B, T, N, 3 * C).transpose(1, 2).reshape(B * N, T, 3 * C)
    o = _heads_attention(qkv, heads, None if bias is None else bias[None], dt)
    o = o.view(B, N, T, C).transpose(1, 2).reshape(BT, N, C)
    o = _tower_plain(o, w, 1, quantized).to(dt)
    if "ad_w1" not in w:
        return o
    h = _erf_gelu(torch.matmul(o.float(), w["ad_w1"].float().t()) + w["ad_b1"].float()).to(dt)
    res = torch.matmul(h.float(), w["ad_w2"].float().t()) + w["ad_b2"].float()
    return (x.float() + res).to(dt)


def tv2_plain(x, w, heads, T, bias=None):
    """`_tblock_v2_kernel` (:1757) at its rounding points. x (B*T, N, C) in the
    tower's layout; w: `tadapt_weights` (without `ad_*`: the attention output
    alone); bias: (heads, T, T) fp32 or None."""
    return _tv2_plain(x, w, heads, T, bias, quantized=False)


def tv2_q_plain(x, w, heads, T, bias=None):
    """K14's int8 variant: `_dotq` products for qkv (of the unrounded fp32 LN
    rows) and proj (of the merged heads); the core and the adapter are the
    float variant's."""
    return _tv2_plain(x, w, heads, T, bias, quantized=True)


# ---------------------------------------------------------------------------
# backward recomputes: the ports of the XLA references that the JAX
# `custom_vjp` backwards differentiate, in the activations' dtype
# ---------------------------------------------------------------------------

def _self_attn_recompute(x, w, heads, bias=None):
    """LN1 (fp32, rounded to x's dtype), then the JAX `mha` of x with itself
    on the operands of w: qkv = x . W_qkv + b, the attention of
    `heads_attention_recompute` (`_tv2_naive`'s (heads, T, T) bias where
    given), proj, all in x's dtype."""
    xn = _ln_f32(x, w["ln1_w"], w["ln1_b"]).to(x.dtype)
    o = heads_attention_recompute(dense(xn, w["w_qkv"], w["b_qkv"]), heads,
                                  None if bias is None else bias[None])
    return dense(o, w["w_proj"], w["b_proj"])


def fusion_block_recompute(v, a, w, heads):
    """K12's backward recompute: the port of `_fusion_spatial_naive` (:257),
    which the JAX `_fb_bwd` differentiates: `swin_block._fusion_recompute`
    with the self-attention of each stream over its own tokens, no fusion
    mask, and QuickGELU in the FFN."""
    return _fusion_recompute(v, a, w, lambda x: _self_attn_recompute(x, w, heads),
                                  quick_gelu, [k for k, _ in ADAPTERS])


def _t_adapter(o, w):
    """T_Adapter without skip (`adapter_apply(skip=False)`) in o's dtype."""
    return dense(gelu(dense(o, w["ad_w1"], w["ad_b1"])), w["ad_w2"], w["ad_b2"])


def tadapt_recompute(x, w, heads):
    """K13's backward recompute: the port of `_tadapt_naive` (:392),
    x + T_Adapter(mha(LN x)) in x's dtype."""
    return x + _t_adapter(_self_attn_recompute(x, w, heads), w)


def tv2_recompute(x, w, heads, T, bias=None):
    """K14's backward recompute: the port of `_tv2_naive` (pallas_attn.py:1899):
    x (B*T, N, C) transposed to each token's T frames, `_tadapt_naive`'s
    function with the optional bias (without an adapter: the attention
    output alone), transposed back."""
    BT, N, C = x.shape
    B = BT // T
    xt = x.reshape(B, T, N, C).transpose(1, 2).reshape(B * N, T, C)
    out = _self_attn_recompute(xt, w, heads, bias)
    if "ad_w1" in w:
        out = xt + _t_adapter(out, w)
    return out.reshape(B, N, T, C).transpose(1, 2).reshape(BT, N, C)


# ---------------------------------------------------------------------------
# the kernels: compositions of hand-written launches
# ---------------------------------------------------------------------------

def _check_operands(x, w, heads, quantized, n_tower, adapters, name, seqs=None):
    """Shared validation of K12-K14 operands on the card (the first `n_tower`
    products of TOWER, the adapters of the given keys, the attention over
    sequences of the lengths `seqs`, by default x's middle axes); returns (C,
    Hd, D), D = 0 without adapters."""
    C = x.shape[-1]
    bf, i8 = torch.bfloat16, torch.int8
    tower = TOWER[:n_tower]
    Hd = w["w1"].shape[0] if n_tower == 4 else 0
    D = w[f"{adapters[0]}_w1"].shape[0] if adapters else 0
    step = 16 if quantized else 8      # int8 rows of 16-byte chunks in gemm.cu
    if C % heads:
        raise ValueError(f"{name}: C={C} is not a multiple of heads={heads}")
    for n in (x.shape[1:-1] if seqs is None else seqs):
        check_attn_shape(n, C // heads, name)
    if C % step or Hd % step or D % 8:
        raise ValueError(f"{name} takes C and the FFN hidden in multiples of {step} and the "
                         f"adapter width in multiples of 8, got C={C}, hidden={Hd}, D={D}")
    if quantized != all(sk in w for _, sk, _ in tower):
        raise ValueError(f"{name} {'int8' if quantized else 'float'} variant given the weights "
                         f"of the other one")
    int8_keys = {wk for wk, _, _ in tower} if quantized else set()
    _check_cuda(x, {k: (t, i8 if k in int8_keys else bf) for k, t in w.items()})
    out_f = {"w_qkv": (3 * C, C), "w_proj": (C, C), "w1": (Hd, C), "w2": (C, Hd)}
    shapes = {"ln1_w": (w["ln1_w"], (C,)), "ln1_b": (w["ln1_b"], (C,))}
    for wk, sk, bk in tower:
        shapes.update({wk: (w[wk], out_f[wk]), bk: (w[bk], out_f[wk][:1])})
        if quantized:
            shapes[sk] = (w[sk], out_f[wk][:1])
    for key in adapters:
        shapes.update({f"{key}_w1": (w[f"{key}_w1"], (D, C)), f"{key}_b1": (w[f"{key}_b1"], (D,)),
                       f"{key}_w2": (w[f"{key}_w2"], (C, D)), f"{key}_b2": (w[f"{key}_b2"], (C,))})
    _check_shapes(shapes)
    return C, Hd, D


def _tower_cuda(x, w, i, out, s, quantized, act=False, x_amax=None, out_amax=None):
    """The i-th tower product of TOWER into `out`: a bf16 GEMM (act: QuickGELU
    in fp32, rounded once), or row quantization of x (bf16 or fp32; from its
    rows' max |x| `x_amax` where given) and an int8 GEMM (act: QuickGELU into
    an fp32 hidden, each row's max |h| into `out_amax`)."""
    wk, sk, bk = TOWER[i]
    if not quantized:
        return _gemm_bf16(x, w[wk], w[bk], out, _EPI_BF16_QUICKGELU if act else _EPI_BF16, s)
    xq, sx = _quant_rows(x, s, amax=x_amax)
    return _gemm_s8(xq, sx, w[wk], w[sk], w[bk], out, _EPI[_QUICK_GELU] if act else _EPI_Q_BF16,
                    s, amax=out_amax)


def _clip_block_cuda(v, a, w, heads, quantized=False):
    if v.dim() != 3 or a.dim() != 3:
        raise ValueError(f"v and a must be (BT, N, C), got {tuple(v.shape)}, {tuple(a.shape)}")
    BT, Nv, _ = v.shape
    Na = a.shape[1]
    bf = torch.bfloat16
    C, Hd, D = _check_operands(v, w, heads, quantized, 4, [k for k, _ in ADAPTERS], "K12")
    _check_cuda(v, {"v": (v, bf), "a": (a, bf)})
    _check_shapes({"a": (a, (BT, Na, C)), "ln2_w": (w["ln2_w"], (C,)), "ln2_b": (w["ln2_b"], (C,)),
                   "gate_v": (w["gate_v"], (1,)), "gate_a": (w["gate_a"], (1,))})
    check_attn_shape(Na, C // heads, "K12")
    check_fuse_width(D, "K12")
    s = _stream(v)
    Mv, Ma = BT * Nv, BT * Na
    M = Mv + Ma

    def empty(*shape, dtype=bf):
        return torch.empty(shape, dtype=dtype, device=v.device)

    def fuse_out(x, kv, ka, r):
        """The adapter hiddens of x = [video rows; audio rows], their fusion,
        and (r + x) + fc2(.) per stream, into one slab."""
        h = empty(M, D)
        _gemm_bf16(x[:Mv], w[f"{kv}_w1"], w[f"{kv}_b1"], h[:Mv], _EPI_BF16_RGELU, s)
        _gemm_bf16(x[Mv:], w[f"{ka}_w1"], w[f"{ka}_b1"], h[Mv:], _EPI_BF16_RGELU, s)
        fv, fa = _fuse_cuda(h[:Mv].view(BT, Nv, D), h[Mv:].view(BT, Na, D), w["gate_v"],
                            w["gate_a"])
        y = empty(M, C)
        _gemm_res2(fv.view(Mv, D), w[f"{kv}_w2"], w[f"{kv}_b2"], r[0], x[:Mv], y[:Mv], s)
        _gemm_res2(fa.view(Ma, D), w[f"{ka}_w2"], w[f"{ka}_b2"], r[1], x[Mv:], y[Mv:], s)
        return y

    v2, a2 = v.view(Mv, C), a.view(Ma, C)
    xn = empty(M, C)                       # LN1 of [v rows; a rows], one slab, in bf16
    _ln_bf16(v2, w["ln1_w"], w["ln1_b"], s, out=xn[:Mv])
    _ln_bf16(a2, w["ln1_w"], w["ln1_b"], s, out=xn[Mv:])
    qkv = _tower_cuda(xn, w, 0, empty(M, 3 * C), s, quantized)
    o = empty(M, C)                        # each stream attends over its own tokens
    _attn_core(qkv[:Mv].view(BT, Nv, 3 * C), None, heads, s, out=o[:Mv].view(BT, Nv, C))
    _attn_core(qkv[Mv:].view(BT, Na, 3 * C), None, heads, s, out=o[Mv:].view(BT, Na, C))
    att = _tower_cuda(o, w, 1, empty(M, C), s, quantized)
    x1 = fuse_out(att, "sv", "sa", (v2, a2))
    xn2 = _ln_bf16(x1, w["ln2_w"], w["ln2_b"], s)
    # the (M, 4C) hidden goes through device memory between fc1 and fc2: bf16,
    # or fp32 for the int8 variant, whose per-row scale needs the whole row's
    # max |h|, which fc1's epilogue gathers into hmax
    hmax = torch.zeros(M, dtype=torch.float32, device=v.device) if quantized else None
    hid = _tower_cuda(xn2, w, 2, empty(M, Hd, dtype=torch.float32 if quantized else bf), s,
                      quantized, act=True, out_amax=hmax)
    n = _tower_cuda(hid, w, 3, empty(M, C), s, quantized, x_amax=hmax)
    y = fuse_out(n, "mv", "ma", (x1[:Mv], x1[Mv:]))
    return y[:Mv].view(BT, Nv, C), y[Mv:].view(BT, Na, C)


def _clip_block_q_cuda(v, a, w, heads):
    return _clip_block_cuda(v, a, w, heads, quantized=True)


def _tadapt_cuda(x, w, heads, quantized=False):
    if x.dim() != 3:
        raise ValueError(f"x must be (R, T, C), got {tuple(x.shape)}")
    R, T, C = x.shape
    bf = torch.bfloat16
    M = R * T
    if not (C % heads == 0 and tattn_route(T, C // heads)
            and rowadapt_route(C, w["ad_w1"].shape[0])):
        _, _, D = _check_operands(x, w, heads, quantized, 2, ["ad"], "K13")
        _check_cuda(x, {"x": (x, bf)})
        return _tadapt_composed(x.view(M, C), w, heads, T, quantized, D, _stream(x)).view(R, T, C)
    # the temporal and row-owning products' checks hold every weight; x and the
    # LN's here, read once
    if quantized != ("s_qkv" in w):
        raise ValueError(f"K13 {'int8' if quantized else 'float'} variant given the weights of "
                         f"the other one")
    _check_cuda(x, {"x": (x, bf), "ln1_w": (w["ln1_w"], bf), "ln1_b": (w["ln1_b"], bf)})
    _check_shapes({"ln1_w": (w["ln1_w"], (C,)), "ln1_b": (w["ln1_b"], (C,))})
    s = _stream(x)
    x2 = x.view(M, C)
    # LN; the temporal product (qkv and each sequence's attention, the slab on
    # chip) into the merged heads; the row-owning product: proj, the
    # T_Adapter's hidden and its up product with the residual, att and the
    # hidden on chip. The int8 variant quantizes the rounded LN rows (one
    # launch) and the merged heads
    att = torch.empty_like(x2)
    if quantized:
        xq, sx = _ln_quant_pair(x2, x2[:0], w["ln1_w"], w["ln1_b"], s)
        _tattn(xq, sx, w["w_qkv"], w["s_qkv"], w["b_qkv"], att, T, heads, s)
        a, sa = _quant_rows(att, s)
    else:
        _tattn(_ln_bf16(x2, w["ln1_w"], w["ln1_b"], s), None, w["w_qkv"], None, w["b_qkv"], att,
               T, heads, s)
        a, sa = att, None
    y = torch.empty_like(x2)
    _rowadapt(a, sa, w["w_proj"], w.get("s_proj"), w["b_proj"], w["ad_w1"], w["ad_b1"],
              _EPI_BF16_RGELU, s, up=(w["ad_w2"], w["ad_b2"], x2, y), up_epi=_EPI_BF16_RES1)
    return y.view(R, T, C)


def _tadapt_composed(x2, w, heads, T, quantized, D, s):
    """K13 where `tattn_route` or `rowadapt_route` does not take its shapes:
    LN, the qkv product, the core, proj, the adapter's two products (6
    launches, 8 int8), with qkv, att and the hidden through device memory."""
    M, C = x2.shape
    bf = torch.bfloat16
    xn = _ln_bf16(x2, w["ln1_w"], w["ln1_b"], s)
    qkv = _tower_cuda(xn, w, 0, torch.empty((M, 3 * C), dtype=bf, device=x2.device), s,
                      quantized)
    o = _attn_core(qkv.view(M // T, T, 3 * C), None, heads, s)
    att = _tower_cuda(o.view(M, C), w, 1, torch.empty_like(x2), s, quantized)
    h = _gemm_bf16(att, w["ad_w1"], w["ad_b1"], torch.empty((M, D), dtype=bf, device=x2.device),
                   _EPI_BF16_RGELU, s)
    return _gemm_res(h, w["ad_w2"], w["ad_b2"], x2, torch.empty_like(x2), _EPI_BF16_RES1, s)


def _tadapt_q_cuda(x, w, heads):
    return _tadapt_cuda(x, w, heads, quantized=True)


def _tv2_cuda(x, w, heads, T, bias=None, quantized=False):
    if x.dim() != 3:
        raise ValueError(f"x must be (B*T, N, C), got {tuple(x.shape)}")
    BT, N, C = x.shape
    if not 1 <= T <= TADAPT_MAX_FRAMES or BT % T:
        raise ValueError(f"K14 takes 1 to {TADAPT_MAX_FRAMES} frames dividing B*T={BT}, got T={T}")
    if not (bias is None and "ad_w1" in w and C % heads == 0 and tattn_route(T, C // heads)
            and rowadapt_route(C, w["ad_w1"].shape[0])):
        return _tv2_composed(x, w, heads, T, bias, quantized)
    # T's and R's checks hold every weight; x and the LN's here, read once
    if quantized != ("s_qkv" in w):
        raise ValueError(f"K14 {'int8' if quantized else 'float'} variant given the weights of "
                         f"the other one")
    bf = torch.bfloat16
    _check_cuda(x, {"x": (x, bf), "ln1_w": (w["ln1_w"], bf), "ln1_b": (w["ln1_b"], bf)})
    _check_shapes({"ln1_w": (w["ln1_w"], (C,)), "ln1_b": (w["ln1_b"], (C,))})
    s = _stream(x)
    x2 = x.view(BT * N, C)
    # LN; the temporal product over frame-strided tiles (qkv and each token's
    # attention over its T frames, N rows apart, the slab on chip) into the
    # merged heads; the row-owning product: proj, the T_Adapter's hidden and
    # its up product with the residual, rounded once. The int8 variant
    # quantizes the unrounded fp32 LN rows (:1778, one launch) and the merged heads
    att = torch.empty_like(x2)
    if quantized:
        xq, sx = _quant_rows(x2, s, w["ln1_w"], w["ln1_b"])
        _tattn(xq, sx, w["w_qkv"], w["s_qkv"], w["b_qkv"], att, T, heads, s, tokens=N)
        a, sa = _quant_rows(att, s)
    else:
        _tattn(_ln_bf16(x2, w["ln1_w"], w["ln1_b"], s), None, w["w_qkv"], None, w["b_qkv"], att,
               T, heads, s, tokens=N)
        a, sa = att, None
    y = torch.empty_like(x2)
    _rowadapt(a, sa, w["w_proj"], w.get("s_proj"), w["b_proj"], w["ad_w1"], w["ad_b1"],
              _EPI_BF16_GELU, s, up=(w["ad_w2"], w["ad_b2"], x2, y), up_epi=_EPI_BF16_RESF)
    return y.view(BT, N, C)


def _tv2_composed(x, w, heads, T, bias, quantized):
    """K14 with a (heads, T, T) bias, without an adapter (the attention
    output alone), or where `rowadapt_route` does not take its adapter
    width: LN, the qkv product, the attention core reading each token's T
    frames N rows apart, proj, the adapter's two products (6 launches, 7
    int8; 4 / 5 without an adapter), qkv, att and the hidden through device
    memory. No serving path takes it: CLIP's temporal sites have adapters
    and no bias."""
    BT, N, _ = x.shape
    bf = torch.bfloat16
    adapters = ["ad"] if "ad_w1" in w else []
    C, _, D = _check_operands(x, w, heads, quantized, 2, adapters, "K14", seqs=(T,))
    _check_cuda(x, {"x": (x, bf)})
    if bias is not None:
        _check_cuda(x, {"bias": (bias, torch.float32)})
        _check_shapes({"bias": (bias, (heads, T, T))})
    s = _stream(x)
    M = BT * N
    x2 = x.view(M, C)
    qkv = torch.empty((M, 3 * C), dtype=bf, device=x.device)
    if quantized:           # the fp32 LN rows, quantized unrounded (:1778)
        xq, sx = _quant_rows(x2, s, w["ln1_w"], w["ln1_b"])
        _gemm_s8(xq, sx, w["w_qkv"], w["s_qkv"], w["b_qkv"], qkv, _EPI_Q_BF16, s)
    else:
        _gemm_bf16(_ln_bf16(x2, w["ln1_w"], w["ln1_b"], s), w["w_qkv"], w["b_qkv"], qkv,
                   _EPI_BF16, s)
    o = _attn_core_t(qkv.view(BT // T, T, N, 3 * C), bias, heads, BT // T, T, s,
                     torch.empty_like(x2))
    att = _tower_cuda(o, w, 1, torch.empty_like(x2), s, quantized)
    if not adapters:
        return att.view(BT, N, C)
    h = _gemm_bf16(att, w["ad_w1"], w["ad_b1"], torch.empty((M, D), dtype=bf, device=x.device),
                   _EPI_BF16_GELU, s)
    return _gemm_res(h, w["ad_w2"], w["ad_b2"], x2, torch.empty_like(x2), _EPI_BF16_RESF,
                     s).view(BT, N, C)


def _tv2_q_cuda(x, w, heads, T, bias=None):
    return _tv2_cuda(x, w, heads, T, bias, quantized=True)


clip_fusion_block = _Kernel("K12", "clip_fusion_block", fusion_block_plain, _clip_block_cuda,
                            recompute=fusion_block_recompute)
clip_fusion_block_q = _Kernel("K12", "clip_fusion_block_q", fusion_block_q_plain,
                              _clip_block_q_cuda)
clip_tadapt = _Kernel("K13", "clip_tadapt", tadapt_plain, _tadapt_cuda, recompute=tadapt_recompute)
clip_tadapt_q = _Kernel("K13", "clip_tadapt_q", tadapt_q_plain, _tadapt_q_cuda)
clip_tv2 = _Kernel("K14", "clip_tv2", tv2_plain, _tv2_cuda, recompute=tv2_recompute)
clip_tv2_q = _Kernel("K14", "clip_tv2_q", tv2_q_plain, _tv2_q_cuda)


# ---------------------------------------------------------------------------
# entry points
# ---------------------------------------------------------------------------

def clip_fusion_spatial_block(blk, v, a, heads: int):
    """Everything of a CLIP fusion block after the temporal stage in K12, its
    int8 variant for an int8 tower (`clip_fusion_spatial_block` :484). v
    (BT, Nv, C), a (BT, Na, C), contiguous."""
    kernel = clip_fusion_block_q if blk.attn.in_proj.quantized else clip_fusion_block
    return kernel(v, a, block_weights(blk), heads)


def clip_temporal_adapt_block(attn, ln, adapter, x, heads: int):
    """x + T_Adapter(MHA(LN(x))) over the frame axis in K13
    (`clip_temporal_adapt_block` :475). x: (B*N, T, C), contiguous."""
    kernel = clip_tadapt_q if attn.in_proj.quantized else clip_tadapt
    return kernel(x, tadapt_weights(attn, ln, adapter), heads)


def temporal_adapt_v2(attn, ln, adapter, x, heads: int, T: int, bias=None):
    """The transpose-free temporal stage in K14, its int8 variant for an int8
    tower (`pallas_attn.py::temporal_adapt_v2` :1948): x (B*T, N, C) in the
    tower's layout, contiguous -> x + T_Adapter(MHA over the frames(LN x)),
    in the same layout; `adapter` None: the attention output alone; bias:
    (heads, T, T) fp32 or None."""
    kernel = clip_tv2_q if attn.in_proj.quantized else clip_tv2
    return kernel(x, tadapt_weights(attn, ln, adapter), heads, T, bias=bias)
