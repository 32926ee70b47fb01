"""The port's kernels K1-K3, K5-K11: wrappers, plain versions, launch counts,
and the entry points of the CLIP and Swin towers that route to them (the
whole Swin fusion block K4 is in ops/swin_block.py, the CLIP blocks K12-K14
in ops/clip_block.py).

- K1 `win_block`: LN -> x.Wqkv + b -> per-head softmax(q.dh^-1/2.k^T + bm).v
  -> merge -> .Wproj + b, in x's dtype. Replaces
  `stgcma_tpu/ops/pallas_attn.py::_win_block_kernel` (:385).
- K2 `win_block_q`: its int8 twin (fp32 LN -> row-quantized int8 qkv product
  -> bf16 qkv -> bf16 grams -> row-quantized int8 proj). Replaces
  `_win_block_q_kernel` (:1461, body `_win_block_q_core` :1425).
- K3 `ffn_q`: fp32 LN -> int8 fc1 + b1 -> QuickGELU or erf-GELU -> int8 fc2
  + b2. Replaces `_ffn_q_kernel` (:1616).
- K7 `ffn`: LN (cast to x's dtype) -> fc1 + b1 -> erf-GELU in fp32 -> hidden
  rounded to x's dtype -> fc2 + b2 (no residual: the caller adds it).
  Replaces `_ffn_kernel` (:676). On the card one launch of csrc/ffn.cu (LN,
  both products and the GELU, the (M, 4C) hidden never in device memory; its
  erf is the TPU kernel's A&S 7.1.26 polynomial, within 2e-7 of torch.erf),
  at the widths `ffn_route` takes (`check_ffn`); at the wider widths that
  the route reaches at larger batches (`ffn_composed_route`: Swin-Base's 512
  and 1024, Swin-Large's 768 and 1536) three launches, K9's LayerNorm and
  csrc/gemm.cu's fc1 with the erf-GELU epilogue and fc2, the bf16 hidden
  through device memory.
- K8 `wmsa`: the attention core alone, softmax(q.k^T + bm).v over (R, N, dh)
  rows with q scaled beforehand and a bias (P, N, N), row r taking bm[r % P].
  Replaces `_wmsa_kernel_small_bias` (:230) and `_wmsa_kernel_blocked_bias`
  (:247); one kernel takes any period P. `wmsa_qkv`, K8 at its Swin sites,
  takes the packed qkv (B_, N, 3C) as the qkv product leaves it and returns
  merged heads (B_, N, C): on the card one launch of csrc/attn.cu's core
  over the packed rows (row b, head h taking bm[(b heads + h) % P]), with
  none of the permutes, the q scaling and the merge around `wmsa`.
- K9 `layernorm`: row LayerNorm, fp32 statistics, x's dtype in and out.
  Replaces `_ln_kernel` (:755). On the card one launch of csrc/rowprep.cu's
  `ln_rows_kernel` (each row read once, 16 bytes a lane; `ln_route`: widths
  in multiples of LN_ALIGN up to LN_MAX_WIDTH), behind one pass of checks.
- K11 `win_block_qd`, `win_block_qh`, `ffn_qh`: K2 or K3 with the
  adapter's down-projection applied to the output, gelu(bf16(o).bf16(wd) +
  bd) (`_adapter_down` :1472: o and wd are cast to bf16 first, whatever x's
  dtype, the product and the erf-GELU are fp32, the hidden is rounded once).
  `win_block_qd` returns only the hidden (replaces `_win_block_qd_kernel`
  :1486, the CLIP temporal site, where the attention output feeds nothing
  but the T_Adapter); `win_block_qh` returns (o, hidden) (`_win_block_qh_kernel`
  :1503, the spatial site); `ffn_qh` returns (FFN output, MLP_Adapter hidden)
  (`_ffn_qh_kernel` :1674). On the card each ends in csrc/rowadapt.cu's
  row-owning product (`_rowadapt`): the last int8 product, o rounded to
  bf16 in its registers, the adapter's down product with the erf-GELU
  epilogue on the same rows, o written only where it is returned. Before
  it: LN + quantize, then at the temporal site (`tattn_route`) the qkv
  product with every sequence's attention in its epilogue
  (csrc/tattn.cu, `_tattn`: the qkv slab stays on chip), at the spatial
  site the int8 qkv product and the resident core; the merged heads
  quantized (4 launches `win_block_qd`, 5 `win_block_qh`); `ffn_qh` LN +
  quantize, fc1 with its fp32 hidden and row maxima, the hidden quantized
  (4). An adapter width or C that `rowadapt_route` does not take keeps
  K2's or K3's launches and one `gemm.cu` product with `EPI_BF16_GELU`.
- K5 `win_fuse` and K6 `bidir_fuse`: the bidirectional gated cross-modal
  fusion vo = vh + (gv * softmax(vh.ah^T).ah), ao = ah + (ga *
  softmax(ah.vh^T).vh), unscaled fp32 logits, probabilities rounded to the
  dtype, p.v summed in fp32, the gated term rounded before the add. One
  kernel (csrc/fuse.cu) and one plain version, `fuse_plain`, serve both; K5
  runs it over Swin windows (replaces `_win_fuse_kernel` :1222, without the
  49 -> 64 pad), K6 over the full stage grid (replaces
  `_bidir_fuse_full_kernel` :1103 and `_bidir_fuse_kernel` :1051).
- K10 `unscaled_attention`: softmax(q.k^T).v, unscaled, one direction of
  csrc/fuse.cu's loop with separate keys and values (`stg_unscaled_attn`).
  Replaces `_attn_kernel` (:137), without its Nk -> 128 pad and `nk_real`
  mask (a TPU layout device). `cross_modal_fuse_flash` calls it twice
  where a stage grid of >= 120 tokens is not a multiple of 16 (:1039-1044),
  and adds the gated terms in torch, as JAX does.

Each wrapper runs its plain PyTorch version when its input lies on the CPU,
and only then. For a CUDA tensor it launches the hand-written kernels of
`stgcma_tpu_torch/csrc/` (built on first use, ops/cuda_lib.py) or raises;
it never falls back. Each wrapper counts the calls in which it launched its
kernels in `.launches` (one per call, however many CUDA launches the call
makes).

Gradients (`_Recompute`, the counterpart of the JAX package's `custom_vjp`
pairs, e.g. `_win_block_op` :451 with `_win_block_fwd` :499 and
`_win_block_bwd` :504): where grad mode is on and a tensor argument
requires grad, a wrapper's call is one autograd node. Its forward is the
call as above (the kernel on the card, the plain version on the CPU, the
launch counted) and saves only the inputs; the value used downstream is
always the forward's. Its backward recomputes the wrapper's `recompute`
on the saved inputs under autograd and takes `torch.autograd.grad` for
exactly the inputs that need one (frozen weights get none and cost none).
That recompute is the port of the XLA recompute in the JAX `_*_bwd`: it is
not a fallback, launches none of the port's kernels, and is the only place
on the card where the plain math runs. Its products take the activations'
dtype (bf16 operands: fp32 accumulation, each result rounded), as the JAX
references' dots do: K1 `win_block_recompute` (`_win_block_naive`), K4
`swin_block.py::swin_block_recompute` (`_fullgrid_naive`), K5 and K6 the
port's own `ops/attention.py::cross_modal_fuse` (JAX's `_wf_bwd` and
`_bidir_bwd` differentiate `cross_modal_fuse`), K7 `ffn_recompute`
(`_ffn_naive`), K8 `wmsa_recompute` / `wmsa_qkv_recompute` and K10
`unscaled_attention_recompute` (the backwards `_wmsa_bwd` and `_bwd` write
out in fp32), K9 `layernorm_plain` (already `common.layernorm`'s port), K12-K14
`clip_block.py`'s `*_recompute` (`_fusion_spatial_naive`, `_tadapt_naive`,
`_tv2_naive`). The `*_plain` versions, whose products run in fp32, are the
yardstick that the kernels and these gradients are held to. The int8
wrappers (K2, K3, K11 and
the int8 variants of K4, K12-K14) have no gradient, as the JAX package
never differentiates a quantized tower: their backward raises.

Departures from the TPU kernels' layout, on purpose: no 8-row block-diagonal
packing of the T = 10 temporal sites (`pallas_attn.py:622-647, :879-905`), no
2-window packing and 49 -> 64 pad of the Swin windows (:578-608) and no
resident pad of the 197-token video stream (`clip_vit.py:366-383`) and no
257 -> 272 pad of CLIP ViT-L/14's (`pallas_attn.py:906-924`). The attention
core takes any token count up to ATTN_MAX_TOKENS (K and V resident in shared
memory up to ATTN_RESIDENT_MAX_TOKENS, streamed past it; `attn_route`) and
each row attends over its own N tokens. The bf16 and int8 products run on
csrc/gemm.cu's one TMA + wgmma loop, which takes rows of a multiple of 16
bytes (K a multiple of 8 bf16 or 16 int8), N in multiples of 8 and 16-byte
aligned operands (`check_gemm_operands`, `check_gemm_s8_operands`). The
int8 FFNs' fp32 hiddens (K3, and the int8 variants of K4 and K12) leave fc1
with each row's max |h| (an atomicMax in the epilogue), so their row
quantization reads them once (`_quant_rows(amax=)`).
The softmax divides exactly, and the activation scale uses a correctly
rounded reciprocal (the TPU kernels' `pl.reciprocal(approx=True)` is a
hardware approximation).
"""
from __future__ import annotations

import functools

import torch

from . import cuda_lib
from .attention import cross_modal_fuse, gather_bias, temporal_table
from ..runtime.profiling import annotate
from .common import gelu, linear

_QUICK_GELU, _GELU = "quick_gelu", "gelu"
_EPI = {_QUICK_GELU: 2, _GELU: 3}    # gemm.cu epilogues writing an fp32 hidden
_EPI_BF16, _EPI_Q_BF16, _EPI_BF16_GELU, _EPI_BF16_RGELU = 0, 1, 4, 5
_EPI_BF16_QUICKGELU = 7               # K12's float fc1: QuickGELU in fp32, one rounding
_EPI_BF16_RES1, _EPI_BF16_RESF = 8, 9  # bf16(r + bf16(acc + b)) (K13), bf16(r + (acc + b)) (K14)
_S8_OUT_DTYPE = {_EPI_Q_BF16: torch.bfloat16, **{e: torch.float32 for e in _EPI.values()}}
_LN_EPS = 1e-5                        # the TPU kernels' LayerNorm eps

# Swin routing thresholds of the JAX package
BLOCK_KERNEL_MAX_HEADS = 16           # K1 at <= 16 heads, else LN + K8 (swin.py:171, :224)
LN_KERNEL_MIN_ELEMS = 1 << 20         # K9 at >= 2^20 elements (pallas_attn.py:819)
FFN_KERNEL_MIN_HIDDEN_BYTES = 96 << 20   # K7 when the hidden is >= 96 MiB (swin.py:204-210)
FLASH_MIN_TOKENS = 120                # K6 from 120 tokens (pallas_attn.py:1023)
FLASH_MAX_KEY_BYTES = 16 << 20        # K6 while Na * D * 4 <= 16 MiB, else K10 (:1033-1034)
FUSE_WIDTHS = (16, 32, 48, 64, 96)    # adapter widths D that csrc/fuse.cu instantiates
                                      # (K4-K6, K12, and D = DV of K10)
FUSE_BLOCK_ROWS = 128                 # csrc/fuse.cu: query rows of a block (8 warps of 16) ...
FUSE_SMALL_ROWS = 64                  # ... or 64 (4 warps) where no direction has more rows
FUSE_KEY_TILE = 64                    # csrc/fuse.cu BK: keys of a tile, rows padded to D + 8
FUSE_STAGES = 3                       # csrc/fuse.cu kStages: key tiles in the cp.async ring
FUSE_SMS = 132                        # SMs of the H100 SXM (fuse.cu reads the card's own)
FUSE_Q_SMEM_WIDTH = 64                # csrc/fuse.cu Q_SMEM: q in shared memory from this D
ATTN_HEAD_WIDTHS = (32, 64)           # head widths dh that csrc/attn.cu instantiates
ATTN_MAX_TOKENS = 65535 * 64          # csrc/attn.cu: past ATTN_RESIDENT_MAX_TOKENS a block takes
                                      # 64 query rows, at most 65535 blocks along gridDim.y
ATTN_SMALL_MAX_TOKENS = 64            # csrc/attn.cu kSmallMaxTokens: attn_small_kernel (KT <= 4)
ATTN_SMALL_STAGES = 2                 # csrc/attn.cu kSmallStages: groups of pairs a block holds
ATTN_RESIDENT_MAX_TOKENS = 768        # csrc/attn.cu kResidentMaxTokens: K and V of a (row, head)
                                      # resident in shared memory (221,184 bytes at dh 64)
SMEM_MAX_BYTES = 232448               # shared memory one block may have on the H100
GEMM_ALIGN = 8                        # csrc/gemm.cu (TMA): K and N in multiples of 8 bf16,
                                      # 16-byte aligned bases
GEMM_S8_ALIGN = 16                    # csrc/wgmma.cuh TMA_ROW_ALIGN: K in multiples of 16 int8
GEMM_KTILE_BYTES = 128                # csrc/wgmma.cuh WG_BK_BYTES: a k-tile of 64 bf16 or 128 int8
TATTN_TILE_ROWS = 128                 # csrc/tattn.cu TATTN_BM: rows a tile of the temporal product
TATTN_MAX_FRAMES = 16                 # csrc/tattn.cu: frames a sequence on its route (a band of 16
                                      # query rows finds its keys in three 16-key tiles)
TATTN_HEAD_WIDTHS = (32, 64)          # head widths dh that csrc/tattn.cu instantiates
ROWADAPT_ROWS = 64                    # csrc/rowadapt.cu RA_BM: output rows a warpgroup owns (a
                                      # block: 64, or 128 where M fills the card)
ROWADAPT_ALIGN = 32                   # csrc/rowadapt.cu RA_ALIGN: N in multiples of 32
ROWADAPT_WIDTHS = (16, 32, 48, 64, 96)   # adapter widths D that csrc/rowadapt.cu instantiates
LN_ALIGN = 8                          # csrc/rowprep.cu ln_rows_kernel: rows of 16-byte chunks ...
LN_MAX_WIDTH = 32 * 16 * 8            # ... at most kLnMaxChunks = 16 a lane of 32 lanes a row
FFN_WIDTHS = (128, 192, 256, 384)     # csrc/ffn.cu: the FFN widths C it instantiates, hidden 4C
FFN_HIDDEN_CHUNK = 64                 # csrc/ffn.cu HC: hidden columns a step forms and consumes


# ---------------------------------------------------------------------------
# plain versions (the kernels' arithmetic in PyTorch ops)
# ---------------------------------------------------------------------------

def _ln_f32(x, w, b):
    """LayerNorm with fp32 statistics; returns fp32 (not cast back)."""
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = (xf - mean).square().mean(dim=-1, keepdim=True)
    return (xf - mean) * torch.rsqrt(var + _LN_EPS) * w.float() + b.float()


def quant_rows(xf):
    """Per-row symmetric int8 quantization of an fp32 (M, K) block, as the
    kernels do it: scale = max(|x|, 1e-30) * (1/127), q = round_half_even(
    x * (1/scale)) clamped to +-127. Returns (q as fp32 values, scale (M, 1))."""
    sx = torch.clamp_min(xf.abs().amax(dim=-1, keepdim=True), 1e-30) * (1.0 / 127.0)
    xq = torch.clamp(torch.round(xf * torch.reciprocal(sx)), -127, 127)
    return xq, sx


def dotq(xf, wq, ws):
    """fp32 activations -> row quant -> exact int8 product -> dequant (fp32).
    wq: int8 (N, K); ws: (N,). The product runs in float64, which is exact
    for int8 sums below 2^53 (float32 is not: 127^2 * 3072 > 2^24)."""
    xq, sx = quant_rows(xf)
    acc = torch.matmul(xq.double(), wq.double().t()).float()
    return acc * sx * ws.float()


def _heads_attention(qkv, heads, bias, dt):
    """qkv (B_, N, 3C) in dt -> merged heads (B_, N, C) in dt."""
    B_, N, C3 = qkv.shape
    C = C3 // 3
    dh = C // heads
    q, k, v = qkv.view(B_, N, 3, heads, dh).permute(2, 0, 3, 1, 4)
    q = q * torch.tensor(dh ** -0.5, dtype=dt)          # scale rounded to dt
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2))
    if bias is not None:
        nWb = bias.shape[0]
        logits = (logits.view(B_ // nWb, nWb, heads, N, N) + bias.float()
                  ).view(B_, heads, N, N)
    e = torch.exp(logits - logits.amax(dim=-1, keepdim=True))
    p = (e / e.sum(dim=-1, keepdim=True)).to(dt)
    o = torch.matmul(p.float(), v.float()).to(dt)
    return o.transpose(1, 2).reshape(B_, N, C)


def win_block_plain(x, ln_w, ln_b, w_qkv, b_qkv, w_proj, b_proj, heads,
                    bias=None):
    dt = x.dtype
    xn = _ln_f32(x, ln_w, ln_b).to(dt)
    qkv = (torch.matmul(xn.float(), w_qkv.float().t()) + b_qkv.float()).to(dt)
    o = _heads_attention(qkv, heads, bias, dt)
    return (torch.matmul(o.float(), w_proj.float().t()) + b_proj.float()).to(dt)


def dense(x, w, b):
    """The JAX package's float `linear` (`stgcma_tpu/ops/common.py:62`) in
    x's dtype: x . W^T rounded to the dtype (bf16 operands: fp32
    accumulation), then + b in the dtype. w in torch's (out, in) layout."""
    dt = x.dtype
    return torch.matmul(x, w.to(dt).t()) + b.to(dt)


def heads_attention_recompute(qkv, heads, bias=None):
    """The multi-head attention of the JAX XLA references that the float
    kernels' `custom_vjp` backwards differentiate (`_win_block_naive`,
    `_fullgrid_naive`, `mha`, `_tv2_naive`), on qkv (B_, N, 3C) in its dtype
    dt: q scaled by a dh^-1/2 rounded to dt, fp32 logits, the bias (nWb, h,
    N, N) fp32 added with period nWb along B_, the softmax in fp32 rounded
    to dt, p.v in dt; heads merged into (B_, N, C)."""
    dt = qkv.dtype
    B_, N, C3 = qkv.shape
    C = C3 // 3
    dh = C // heads
    q, k, v = qkv.view(B_, N, 3, heads, dh).permute(2, 0, 3, 1, 4)
    q = q * torch.tensor(dh ** -0.5, dtype=dt)          # scale rounded to dt
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2))
    if bias is not None:
        nWb = bias.shape[0]
        logits = (logits.view(B_ // nWb, nWb, heads, N, N) + bias.float()
                  ).view(B_, heads, N, N)
    p = torch.softmax(logits, dim=-1).to(dt)
    return torch.matmul(p, v).transpose(1, 2).reshape(B_, N, C)


def win_block_recompute(x, ln_w, ln_b, w_qkv, b_qkv, w_proj, b_proj, heads, bias=None):
    """K1's backward recompute: the port of `_win_block_naive` (:426), the
    XLA reference that the JAX `_win_block_bwd` differentiates. Its products
    take x's dtype (bf16 operands on the card: tensor-core products with
    fp32 accumulation, rounded once to bf16, the bias added after), the
    logits and the softmax fp32. The same bf16 x bf16 products as
    `win_block_plain`, which runs every product in fp32 and stays the
    yardstick that the kernel and this gradient are held to."""
    xn = _ln_f32(x, ln_w, ln_b).to(x.dtype)
    o = heads_attention_recompute(dense(xn, w_qkv, b_qkv), heads, bias)
    return dense(o, w_proj, b_proj)


def _win_block_q_core(x, ln_w, ln_b, wqkv_q, wqkv_s, b_qkv, wproj_q, wproj_s, b_proj,
                      heads, bias=None):
    """K2's body up to its fp32 output (`_win_block_q_core` :1425)."""
    xn = _ln_f32(x, ln_w, ln_b)
    qkv = (dotq(xn, wqkv_q, wqkv_s) + b_qkv.float()).to(torch.bfloat16)
    o = _heads_attention(qkv, heads, bias, torch.bfloat16)
    return dotq(o.float(), wproj_q, wproj_s) + b_proj.float()


def win_block_q_plain(x, ln_w, ln_b, wqkv_q, wqkv_s, b_qkv, wproj_q, wproj_s,
                      b_proj, heads, bias=None):
    return _win_block_q_core(x, ln_w, ln_b, wqkv_q, wqkv_s, b_qkv, wproj_q, wproj_s, b_proj,
                             heads, bias).to(x.dtype)


def _erf_gelu(h):
    return 0.5 * h * (1.0 + torch.erf(h * 2.0 ** -0.5))


def _ffn_q_core(x, ln_w, ln_b, w1_q, w1_s, b1, w2_q, w2_s, b2, act):
    """K3's body up to its fp32 output (`_ffn_q_kernel` :1616)."""
    xn = _ln_f32(x, ln_w, ln_b)
    h = dotq(xn, w1_q, w1_s) + b1.float()
    h = h * torch.sigmoid(1.702 * h) if act == _QUICK_GELU else _erf_gelu(h)
    return dotq(h, w2_q, w2_s) + b2.float()


def ffn_q_plain(x, ln_w, ln_b, w1_q, w1_s, b1, w2_q, w2_s, b2, act):
    return _ffn_q_core(x, ln_w, ln_b, w1_q, w1_s, b1, w2_q, w2_s, b2, act).to(x.dtype)


def _adapter_down(o, wd, bd, dt):
    """K11's adapter hidden of the fp32 output o (`_adapter_down` :1472): o
    and wd (D, C) cast to bf16 first, even when x is fp32, the product in
    fp32 + bd, erf-GELU in fp32, rounded once to dt. Not the unfused
    `adapter_hidden`, which takes o in its own dtype."""
    bf = torch.bfloat16
    h = torch.matmul(o.to(bf).float(), wd.to(bf).float().t()) + bd.float()
    return _erf_gelu(h).to(dt)


def win_block_qad_plain(x, ln_w, ln_b, wqkv_q, wqkv_s, b_qkv, wproj_q, wproj_s, b_proj,
                        wd, bd, heads, emit_o):
    """K2 with the adapter's down-projection: the hidden alone (`emit_o`
    False, `_win_block_qd_kernel`), or (o in x's dtype, hidden)
    (`_win_block_qh_kernel`)."""
    o = _win_block_q_core(x, ln_w, ln_b, wqkv_q, wqkv_s, b_qkv, wproj_q, wproj_s, b_proj, heads)
    h = _adapter_down(o, wd, bd, x.dtype)
    return (o.to(x.dtype), h) if emit_o else h


def ffn_qh_plain(x, ln_w, ln_b, w1_q, w1_s, b1, w2_q, w2_s, b2, wd, bd, act):
    """K3 that also returns the adapter hidden of its output (`_ffn_qh_kernel`)."""
    o = _ffn_q_core(x, ln_w, ln_b, w1_q, w1_s, b1, w2_q, w2_s, b2, act)
    return o.to(x.dtype), _adapter_down(o, wd, bd, x.dtype)


def ffn_plain(x, ln_w, ln_b, w1, b1, w2, b2):
    dt = x.dtype
    xn = _ln_f32(x, ln_w, ln_b).to(dt)
    h = _erf_gelu(torch.matmul(xn.float(), w1.float().t()) + b1.float()).to(dt)
    return (torch.matmul(h.float(), w2.float().t()) + b2.float()).to(dt)


def ffn_recompute(x, ln_w, ln_b, w1, b1, w2, b2):
    """K7's backward recompute: the port of `_ffn_naive` (:734), which the
    JAX `_ffn_bwd` differentiates: LayerNorm in fp32 rounded to x's dtype,
    then both products with their bias adds and the erf-GELU in x's dtype."""
    xn = _ln_f32(x, ln_w, ln_b).to(x.dtype)
    return dense(gelu(dense(xn, w1, b1)), w2, b2)


def wmsa_plain(q, k, v, bm):
    dt = q.dtype
    R, N, _ = q.shape
    P = bm.shape[0]
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2))
    logits = (logits.view(R // P, P, N, N) + bm.float()).view(R, N, N)
    e = torch.exp(logits - logits.amax(dim=-1, keepdim=True))
    p = (e / e.sum(dim=-1, keepdim=True)).to(dt)
    return torch.matmul(p.float(), v.float()).to(dt)


def _qkv_site(qkv, heads, core):
    """K8's Swin site around `core(q, k, v)`: the packed qkv (B_, N, 3C)
    taken apart into (B_ * heads, N, dh) rows (head fastest), q scaled by
    dh^-1/2 rounded to qkv's dtype, the core's rows merged back into (B_,
    N, C)."""
    B_, N, C3 = qkv.shape
    C = C3 // 3
    dh = C // heads
    q, k, v = qkv.reshape(B_, N, 3, heads, dh).permute(2, 0, 3, 1, 4)
    q = q * torch.tensor(dh ** -0.5, dtype=qkv.dtype)
    out = core(*(t.reshape(B_ * heads, N, dh) for t in (q, k, v)))
    return out.reshape(B_, heads, N, dh).transpose(1, 2).reshape(B_, N, C)


def wmsa_qkv_plain(qkv, bm, heads):
    """K8 at its Swin sites: `wmsa_plain` with the bias (P, N, N) inside
    `_qkv_site`."""
    return _qkv_site(qkv, heads, lambda q, k, v: wmsa_plain(q, k, v, bm))


def _attn_recompute(q, k, v, bias=None):
    """The recompute that the JAX `_bwd` (:209) and `_wmsa_bwd` (:330)
    write out by hand, as a function whose autograd gives their formulas:
    fp32 logits of q (R, N, dh) and k from the saved inputs, the bias (P, N,
    N) added with period P along R, the softmax in fp32, not rounded before
    p.v (unlike the forward), p.v against v in fp32, rounded to q's dtype.
    So dv = p^T g, ds = (g v^T - rowsum) * p, dq = ds k, dk = ds^T q, all
    in fp32 and each cast to its input's dtype, and the bias's gradient ds
    summed over the R / P periods (JAX's `dbm`)."""
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2))
    if bias is not None:
        R, N, M = logits.shape
        P = bias.shape[0]
        logits = (logits.view(R // P, P, N, M) + bias.float()).view(R, N, M)
    return torch.matmul(torch.softmax(logits, dim=-1), v.float()).to(q.dtype)


def wmsa_recompute(q, k, v, bm):
    """K8's backward recompute: the port of `_wmsa_bwd` (:330)."""
    return _attn_recompute(q, k, v, bm)


def wmsa_qkv_recompute(qkv, bm, heads):
    """K8's backward recompute at its Swin sites: `wmsa_recompute` inside
    `_qkv_site`, whose split, scale and merge are XLA's part of JAX's site
    (`temporal_attention_fused` :650), differentiated by autograd as JAX
    differentiates them."""
    return _qkv_site(qkv, heads, lambda q, k, v: wmsa_recompute(q, k, v, bm))


def unscaled_attention_plain(q, k, v):
    """`_attn_kernel` (:137): fp32 logits of q (B, Nq, D) against k (B, Nk,
    D), no scale, exact softmax, probabilities rounded to q's dtype, p.v
    summed in fp32 and rounded."""
    dt = q.dtype
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2))
    e = torch.exp(logits - logits.amax(dim=-1, keepdim=True))
    p = (e / e.sum(dim=-1, keepdim=True)).to(dt)
    return torch.matmul(p.float(), v.float()).to(dt)


def unscaled_attention_recompute(q, k, v):
    """K10's backward recompute: the port of the JAX `_bwd` (:209)."""
    return _attn_recompute(q, k, v)


def layernorm_plain(x, ln_w, ln_b):
    """K9's plain version, and also its backward recompute: it is already
    the port of `common.layernorm` (`stgcma_tpu/ops/common.py:72`), which
    the JAX `_ln_bwd` (:809) differentiates: fp32 statistics, (x - mean) *
    rsqrt(var + eps) * scale + bias in fp32, cast back to x's dtype
    (held bit for bit to JAX's in bf16 by
    tests/test_torch_port_train_swin.py)."""
    return _ln_f32(x, ln_w, ln_b).to(x.dtype)


def fuse_plain(vh, ah, gate_v, gate_a, mask=None):
    """The plain version of K5 and K6 (and of K4's two fusions, with `mask`
    (Nv, Na) fp32 added to the gram in both directions). vh (B, Nv, D), ah
    (B, Na, D); returns (vo, ao) in vh's dtype."""
    dt = vh.dtype
    logits = torch.matmul(vh.float(), ah.float().transpose(-1, -2))
    if mask is not None:
        logits = logits + mask.float()

    def side(lg, kv, q, gate):
        e = torch.exp(lg - lg.amax(dim=-1, keepdim=True))
        p = (e / e.sum(dim=-1, keepdim=True)).to(dt)
        return q + (gate.float() * torch.matmul(p.float(), kv.float())).to(dt)
    return side(logits, ah, vh, gate_v), side(logits.transpose(-1, -2), vh, ah, gate_a)


# ---------------------------------------------------------------------------
# launches on the card
# ---------------------------------------------------------------------------

def _check_cuda(x, named):
    """Every tensor on x's card, contiguous, of the stated dtype."""
    for name, (t, dtype) in named.items():
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
        if t.dtype != dtype:
            raise ValueError(f"{name} must be {dtype}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")


def _check_shapes(named):
    for name, (t, shape) in named.items():
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")


def _ptr(t):
    return None if t is None else t.data_ptr()


def _stream(x):
    """The raw handle of the current stream of x's card."""
    return torch._C._cuda_getCurrentRawStream(x.device.index)


def ln_route(K):
    """True where csrc/rowprep.cu's LayerNorm takes rows of K values: K a
    multiple of LN_ALIGN up to LN_MAX_WIDTH (every width of the presets:
    Swin-Base 128-2048, Swin-Large 192-3072, CLIP 768 and 1024)."""
    return 0 < K <= LN_MAX_WIDTH and K % LN_ALIGN == 0


def _ln_bf16(x2, ln_w, ln_b, s, out=None):
    """LayerNorm of bf16 rows (M, K), cast back to bf16 (into `out`, a
    contiguous (M, K) bf16 tensor, when given): K9, and the LN prologue of
    K1 and K12-K14."""
    M, K = x2.shape
    y = torch.empty_like(x2) if out is None else out
    cuda_lib.check("rowprep.cu", cuda_lib.lib("rowprep.cu").stg_ln_bf16(
        x2.data_ptr(), ln_w.data_ptr(), ln_b.data_ptr(), y.data_ptr(), M, K, _LN_EPS, s))
    return y


def _gemm_bf16(a, w, b, out, epi, s):
    """out (M, N) = epilogue(a (M, K) . w (N, K)^T + b), all bf16 and contiguous."""
    check_gemm_operands(a, w, out)
    M, K = a.shape
    cuda_lib.check("gemm.cu", cuda_lib.lib("gemm.cu").stg_gemm_bf16(
        _ptr(a), _ptr(w), _ptr(b), _ptr(out), M, w.shape[0], K, epi, s))
    return out


def _gemm_res(a, w, b, r, out, epi, s):
    """out (M, N) = epilogue(r, a (M, K) . w (N, K)^T + b): `_EPI_BF16_RESF`
    bf16(r + (acc + b)), rounded once, or `_EPI_BF16_RES1` bf16(r + bf16(acc
    + b)); all bf16 and contiguous."""
    check_gemm_operands(a, w, out, r)
    M, K = a.shape
    cuda_lib.check("gemm.cu", cuda_lib.lib("gemm.cu").stg_gemm_bf16_res(
        _ptr(a), _ptr(w), _ptr(b), _ptr(r), _ptr(out), M, w.shape[0], K, epi, s))
    return out


def _quant_rows(x2, s, ln_w=None, ln_b=None, amax=None):
    """int8 row quantization of bf16 or fp32 rows (M, K), contiguous, K a
    multiple of 16: after a LayerNorm when its weights are given (K2/K3
    prologues), or from the rows' given max |x| `amax` ((M,) fp32, as an
    fp32 epilogue of `_gemm_s8` leaves it). Returns (int8 codes, fp32
    scales)."""
    M, K = x2.shape
    if (K % GEMM_S8_ALIGN or not x2.is_contiguous() or x2.data_ptr() % 16
            or (amax is not None and (ln_w is not None or amax.dtype != torch.float32
                                      or amax.shape != (M,)))):
        raise ValueError(f"row quantization takes contiguous rows of a multiple of "
                         f"{GEMM_S8_ALIGN}, 16-byte aligned, and a given (M,) fp32 amax only "
                         f"without LN; got shape {tuple(x2.shape)}, address {x2.data_ptr():#x}")
    q = torch.empty((M, K), dtype=torch.int8, device=x2.device)
    sx = torch.empty((M,), dtype=torch.float32, device=x2.device)
    cuda_lib.check("rowprep.cu", cuda_lib.lib("rowprep.cu").stg_quant_rows(
        _ptr(x2), int(x2.dtype == torch.float32), _ptr(ln_w), _ptr(ln_b), _ptr(amax),
        _ptr(q), _ptr(sx), M, K, _LN_EPS, s))
    return q, sx


def _gemm_s8(a, sa, wq, ws, bias, out, epi, s, amax=None):
    """out (M, N) = epilogue(float(a (M, K) . wq (N, K)^T) * sa * ws + bias),
    int8 codes in; `amax` ((M,) fp32 zeros, the fp32 epilogues only) takes
    each row's max |out|."""
    check_gemm_s8_operands(a, sa, wq, ws, bias, out, epi, amax)
    M, K = a.shape
    cuda_lib.check("gemm.cu", cuda_lib.lib("gemm.cu").stg_gemm_s8(
        _ptr(a), _ptr(sa), _ptr(wq), _ptr(ws), _ptr(bias), _ptr(out), _ptr(amax),
        M, wq.shape[0], K, epi, s))
    return out


def _attn_core(qkv, bias, heads, s, out=None):
    """The attention core over a packed qkv (B_, N, 3C) into merged heads
    (B_, N, C) (`out`, contiguous bf16, when given)."""
    B_, N, C3 = qkv.shape
    C = C3 // 3
    dh = C // heads
    o = torch.empty((B_, N, C), dtype=torch.bfloat16, device=qkv.device) if out is None else out
    scale = float(torch.tensor(dh ** -0.5, dtype=torch.bfloat16))
    nWb = 1 if bias is None else bias.shape[0]
    cuda_lib.check("attn.cu", cuda_lib.lib("attn.cu").stg_attn_core(
        _ptr(qkv), _ptr(bias), nWb, _ptr(o), B_, N, heads, dh, scale, s))
    return o


def _attn_core_win(qkv, bias, table, heads, s):
    """The attention core of each window of a packed full-grid qkv (B_, N,
    3C) into merged heads (B_, N, C), on csrc/attn.cu's resident kernel:
    window w of row b is the tokens table[w] (table (nW, n) int32, nW * n =
    N, n <= ATTN_RESIDENT_MAX_TOKENS), the bias (1, heads, N, N) fp32 is read
    at their own entries and each token's output lands at its own row (K4)."""
    B_, N, C3 = qkv.shape
    C = C3 // 3
    dh = C // heads
    nW, n = table.shape
    if nW * n != N or not 1 <= n <= ATTN_RESIDENT_MAX_TOKENS or bias is None:
        raise ValueError(f"the windowed core takes a bias and windows of 1 to "
                         f"{ATTN_RESIDENT_MAX_TOKENS} tokens that tile the grid, got {nW} of "
                         f"{n} for N={N}")
    o = torch.empty((B_, N, C), dtype=torch.bfloat16, device=qkv.device)
    scale = float(torch.tensor(dh ** -0.5, dtype=torch.bfloat16))
    cuda_lib.check("attn.cu", cuda_lib.lib("attn.cu").stg_attn_core_win(
        _ptr(qkv), _ptr(bias), _ptr(table), nW, _ptr(o), B_, N, n, heads, dh, scale, s))
    return o


def _attn_core_t(qkv, bias, heads, B, T, s, out):
    """The attention core over the T frames of each token of a packed qkv
    (B, T, Ns, 3C) into merged heads `out` (B, T, Ns, C), with no transpose:
    the core reads each token's frames Ns rows apart. bias: (heads, T, T)
    fp32 or None."""
    Ns, C = qkv.shape[2], qkv.shape[3] // 3
    dh = C // heads
    scale = float(torch.tensor(dh ** -0.5, dtype=torch.bfloat16))
    cuda_lib.check("attn.cu", cuda_lib.lib("attn.cu").stg_attn_core_t(
        _ptr(qkv), _ptr(bias), _ptr(out), B, T, Ns, heads, dh, scale, s))
    return out


@functools.lru_cache(maxsize=None)
def _q_scale(dh):
    """dh^-1/2 rounded to bf16, as the cores scale q."""
    return float(torch.tensor(dh ** -0.5, dtype=torch.bfloat16))


def tattn_route(T, dh):
    """True where the temporal product (csrc/tattn.cu) takes sequences of T
    frames at head width dh: 1 <= T <= TATTN_MAX_FRAMES and dh in
    TATTN_HEAD_WIDTHS. Elsewhere the qkv product and the attention core run
    as two launches, with the qkv slab through device memory."""
    return 1 <= T <= TATTN_MAX_FRAMES and dh in TATTN_HEAD_WIDTHS


def rowadapt_route(N, D):
    """True where the row-owning product with the adapter (csrc/rowadapt.cu)
    takes output width N and adapter width D: N a multiple of
    ROWADAPT_ALIGN, D in ROWADAPT_WIDTHS."""
    return N >= ROWADAPT_ALIGN and N % ROWADAPT_ALIGN == 0 and D in ROWADAPT_WIDTHS


def ffn_route(C, H):
    """True where csrc/ffn.cu takes an FFN of width C and hidden H: C in
    FFN_WIDTHS (the K7 sites of the presets' stages 0-1: Swin-Base's 128 and
    256, Swin-Large's 192 and 384, every K7 site up to B = 8) and H = 4C."""
    return C in FFN_WIDTHS and H == 4 * C


def ffn_composed_route(C, H):
    """True where K7 runs as K9's LayerNorm and gemm.cu's fc1 (erf-GELU
    epilogue) and fc2: the widths csrc/ffn.cu does not instantiate, C a
    multiple of GEMM_ALIGN up to LN_MAX_WIDTH and H = 4C. `ffn_kernel_route`
    reaches them at the presets' stages 2-3 (Swin-Large's 768 from B = 9,
    Swin-Base's 512 from B = 16)."""
    return (not ffn_route(C, H) and H == 4 * C and ln_route(C)
            and C % GEMM_ALIGN == 0)


def check_ffn(x, ln_w, ln_b, w1, b1, w2, b2, name="K7"):
    """What csrc/ffn.cu takes: x (M, C) bf16, M >= 1; ln_w, ln_b and b2 (C,),
    w1 (H, C), b1 (H,), w2 (C, H), all bf16, on x's card, contiguous and
    16-byte aligned; `ffn_route(C, H)`. Runs before every launch: reads each
    attribute once and builds no message unless it raises."""
    bf = torch.bfloat16
    ok = x.dim() == 2 and w1.dim() == 2 and x.shape[0] >= 1
    if ok:
        (M, C), H = x.shape, w1.shape[0]
        ok = (ffn_route(C, H) and all(t.dtype == bf for t in (x, ln_w, ln_b, w1, b1, w2, b2))
              and tuple(w1.shape) == (H, C) and tuple(w2.shape) == (C, H)
              and ln_w.numel() == ln_b.numel() == b2.numel() == C and b1.numel() == H
              and _aligned(x.device, x, ln_w, ln_b, w1, b1, w2, b2))
    if not ok:
        _raise_operands(name, f"x (M, C) bf16, ln_w, ln_b, b2 (C,), w1 (H, C), b1 (H,), w2 (C, "
                        f"H), all bf16 on one card, contiguous and 16-byte aligned, C in "
                        f"{FFN_WIDTHS} and H = 4C",
                        {"x": x, "ln_w": ln_w, "ln_b": ln_b, "w1": w1, "b1": b1, "w2": w2,
                         "b2": b2})


def _aligned(dev, *ts):
    """Every tensor given (None passes) on `dev`, contiguous and 16-byte
    aligned."""
    return all(t is None or (t.device == dev and t.is_contiguous() and t.data_ptr() % 16 == 0)
               for t in ts)


def _raise_operands(name, what, named):
    got = "; ".join(f"{k} {t.dtype} {tuple(t.shape)} at {t.data_ptr():#x}"
                    for k, t in named.items() if t is not None)
    raise ValueError(f"{name} takes {what}; got {got}")


def check_tattn(a, sa, w, ws, bias, out, T, heads, tokens=0, name="the temporal product"):
    """What csrc/tattn.cu takes: rows a (M, C), bf16 (sa and ws None) or int8
    codes with sa (M,) fp32 and ws (3C,) bf16; w (3C, C) of a's dtype, bias
    (3C,) bf16, out M rows of C bf16; `tattn_route(T, C / heads)`; M a
    multiple of T (tokens 0: a sequence is T consecutive rows), or of T *
    tokens (the tower's (B T, tokens, C) layout: a sequence is one token's T
    frames); C a multiple of 8 (bf16) or 16 (int8); all on a's card,
    contiguous, 16-byte aligned. Runs before every launch: reads each
    attribute once and builds no message unless it raises."""
    i8, bf = torch.int8, torch.bfloat16
    quantized = a.dtype == i8
    ok = (a.dim() == 2 and w.dim() == 2 and heads >= 1 and tokens >= 0
          and (sa is not None) == quantized)
    if ok:
        (M, C), dh = a.shape, a.shape[1] // heads
        ok = (a.dtype in (bf, i8) and w.dtype == a.dtype and tuple(w.shape) == (3 * C, C)
              and C == heads * dh and tattn_route(T, dh) and M % (T * max(tokens, 1)) == 0
              and C % (GEMM_S8_ALIGN if quantized else GEMM_ALIGN) == 0
              and bias.dtype == bf and bias.numel() == 3 * C and out.dtype == bf
              and out.numel() == M * C and out.shape[-1] == C
              and _aligned(a.device, a, w, bias, out, sa, ws)
              and (not quantized or (sa.dtype == torch.float32 and sa.numel() == M
                                     and ws.dtype == bf and ws.numel() == 3 * C)))
    if not ok:
        _raise_operands(name, f"rows a (M, C) bf16 or int8 with their scales, w (3C, C), bias "
                        f"(3C,), out (M, C) bf16 on one card, M a multiple of T (times the "
                        f"tokens a frame, where given), 1 <= T <= {TATTN_MAX_FRAMES}, C / heads "
                        f"in {TATTN_HEAD_WIDTHS} (T={T}, heads={heads}, tokens={tokens})",
                        {"a": a, "sa": sa, "w": w, "ws": ws, "bias": bias, "out": out})


def _tattn(a, sa, w, ws, bias, out, T, heads, s, tokens=0):
    """out (M, C) = the merged heads of each sequence's attention over its T
    frames, qkv = a . w^T + bias (int8: dequantized by sa, ws) in the
    epilogue of one product; the qkv slab never reaches device memory. A
    sequence is T consecutive rows (K13, K11), or, with `tokens`, the T
    frames of one token of the tower's (B T, tokens, C) layout, `tokens` rows
    apart (K14)."""
    check_tattn(a, sa, w, ws, bias, out, T, heads, tokens)
    M, C = a.shape
    lib = cuda_lib.lib("tattn.cu")
    scale = _q_scale(C // heads)
    if sa is None:
        err = lib.stg_tattn_bf16(_ptr(a), _ptr(w), _ptr(bias), _ptr(out), M, C, T, heads, tokens,
                                 scale, s)
    else:
        err = lib.stg_tattn_s8(_ptr(a), _ptr(sa), _ptr(w), _ptr(ws), _ptr(bias), _ptr(out), M, C,
                               T, heads, tokens, scale, s)
    cuda_lib.check("tattn.cu", err)
    return out


def check_rowadapt(a, sa, w, ws, bias, wd, bd, out=None, h=None, up=None,
                   up_epi=_EPI_BF16_RES1, name="the row-owning product"):
    """What csrc/rowadapt.cu takes: a (M, K) bf16, or int8 codes with sa (M,)
    fp32 and ws (N,) bf16; w (N, K) of a's dtype, bias (N,) bf16; the
    adapter's wd (D, N) and bd (D,) bf16, `rowadapt_route(N, D)`; out and h,
    where given, M rows of N and of D in bf16; up, where given, (w2 (N, D),
    b2 (N,), x, y) with x and y M rows of N in bf16, up_epi `_EPI_BF16_RES1`
    or `_EPI_BF16_RESF`; K a multiple of 8 (bf16) or 16 (int8); all on a's
    card, contiguous and 16-byte aligned. Reads each attribute once and
    builds no message unless it raises."""
    i8, bf = torch.int8, torch.bfloat16
    quantized = a.dtype == i8
    w2, b2, x, y = up if up is not None else (None,) * 4
    ok = a.dim() == 2 and w.dim() == 2 and wd.dim() == 2 and (sa is not None) == quantized
    if ok:
        (M, K), N, D = a.shape, w.shape[0], wd.shape[0]
        ok = (a.dtype in (bf, i8) and w.dtype == a.dtype and w.shape[1] == K
              and K % (GEMM_S8_ALIGN if quantized else GEMM_ALIGN) == 0
              and rowadapt_route(N, D) and bias.dtype == bf and bias.numel() == N
              and wd.dtype == bf and wd.shape[1] == N and bd.dtype == bf and bd.numel() == D
              and (out is None or (out.dtype == bf and out.numel() == M * N))
              and (h is None or (h.dtype == bf and h.numel() == M * D))
              and (up is None or (w2.dtype == bf and tuple(w2.shape) == (N, D) and b2.dtype == bf
                                  and b2.numel() == N and x.dtype == bf and x.numel() == M * N
                                  and y.dtype == bf and y.numel() == M * N))
              and up_epi in (_EPI_BF16_RES1, _EPI_BF16_RESF)
              and _aligned(a.device, a, w, bias, wd, bd, out, h, w2, b2, x, y, sa, ws)
              and (not quantized or (sa.dtype == torch.float32 and sa.numel() == M
                                     and ws.dtype == bf and ws.numel() == N)))
    if not ok:
        _raise_operands(name, f"a (M, K) bf16 or int8 with its scales, w (N, K), bias (N,), wd "
                        f"(D, N), bd (D,), out (M, N), h (M, D), w2 (N, D), b2 (N,), x and y "
                        f"(M, N), all bf16 but the codes and sa, on one card; N a multiple of "
                        f"{ROWADAPT_ALIGN}, D in {ROWADAPT_WIDTHS}, up epilogue "
                        f"{_EPI_BF16_RES1} or {_EPI_BF16_RESF} (got {up_epi})",
                        {"a": a, "sa": sa, "w": w, "ws": ws, "bias": bias, "wd": wd, "bd": bd,
                         "out": out, "h": h, "w2": w2, "b2": b2, "x": x, "y": y})


def _rowadapt(a, sa, w, ws, bias, wd, bd, down_epi, s, out=None, h=None, up=None,
              up_epi=_EPI_BF16_RES1):
    """One launch of csrc/rowadapt.cu: o = bf16(a . w^T + bias) (int8:
    dequantized by sa, ws), into `out` where given; the adapter hidden
    down_epi(o . wd^T + bd) (`_EPI_BF16`, `_EPI_BF16_GELU` or
    `_EPI_BF16_RGELU`), into `h` where given; with up = (w2, b2, x, y), y =
    bf16(x + bf16(hidden . w2^T + b2)) (up_epi `_EPI_BF16_RES1`, K13) or
    bf16(x + (hidden . w2^T + b2)) (`_EPI_BF16_RESF`, K14). What is not
    given stays on chip."""
    check_rowadapt(a, sa, w, ws, bias, wd, bd, out, h, up, up_epi)
    M, K = a.shape
    N, D = w.shape[0], wd.shape[0]
    w2, b2, x, y = up if up is not None else (None,) * 4
    tail = (_ptr(bias), _ptr(out), _ptr(wd), _ptr(bd), _ptr(h), _ptr(w2), _ptr(b2), _ptr(x),
            _ptr(y), M, N, K, D, down_epi, up_epi, s)
    lib = cuda_lib.lib("rowadapt.cu")
    if sa is None:
        err = lib.stg_rowadapt_bf16(_ptr(a), _ptr(w), *tail)
    else:
        err = lib.stg_rowadapt_s8(_ptr(a), _ptr(sa), _ptr(w), _ptr(ws), *tail)
    cuda_lib.check("rowadapt.cu", err)


def check_attn_shape(N, dh, name="the attention core"):
    """The token counts and head widths that csrc/attn.cu takes."""
    if dh not in ATTN_HEAD_WIDTHS or not 1 <= N <= ATTN_MAX_TOKENS:
        raise ValueError(f"{name} takes 1 to {ATTN_MAX_TOKENS} tokens and heads of width in "
                         f"{ATTN_HEAD_WIDTHS}, got N={N}, dh={dh}")


def attn_route(N, dh):
    """(kernel, shared-memory bytes of one block) that csrc/attn.cu's dispatch
    (`launch_dh`) takes for N tokens at head width dh: "small"
    (attn_small_kernel: ATTN_SMALL_STAGES stages of Q, K and V of 4 / KT
    (row, head) pairs, 16 KT rows each, KT = 1, 2 or 4 key tiles of 16),
    "resident" (K and V of one pair) or "streamed" (64-key tiles of K and
    V^T); rows padded to dh + 8."""
    check_attn_shape(N, dh)
    if N <= ATTN_SMALL_MAX_TOKENS:
        kt = next(k for k in (1, 2, 4) if 16 * k >= N)
        pairs = 4 // kt
        return "small", ATTN_SMALL_STAGES * pairs * 3 * 16 * kt * (dh + 8) * 2
    if N <= ATTN_RESIDENT_MAX_TOKENS:
        return "resident", 2 * 2 * (-(-N // 16) * 16) * (dh + 8)
    return "streamed", 2 * (64 * (dh + 8) + dh * (64 + 8))


def fuse_route(nq0, nq1, D, gated=True, B=1, sms=FUSE_SMS):
    """(query rows of a block, shared-memory bytes of one block) that
    csrc/fuse.cu's launcher takes for B sequences of nq0 and nq1 tokens at
    width D on a card of `sms` SMs (the fusion: each direction's queries are
    the other's keys; K10, `gated` False: nq0 queries against nq1 keys).
    Blocks of 8 warps, or of 4 where no direction has more than
    FUSE_SMALL_ROWS query rows or where 8-warp blocks would not give every SM
    two rounds of blocks (at `fuse_min_blocks(D)` blocks an SM). Shared
    memory: the block's query rows at stride D + 8 where D >=
    FUSE_Q_SMEM_WIDTH, then a ring of min(FUSE_STAGES, the key tiles) tiles
    of FUSE_KEY_TILE keys at stride D + 8 (and as many value tiles for K10)."""
    check_fuse_width(D)
    longest = max(nq0, nq1) if gated else nq0
    blocks = B * (-(-nq0 // FUSE_BLOCK_ROWS) + (-(-nq1 // FUSE_BLOCK_ROWS) if gated else 0))
    wide = longest > FUSE_SMALL_ROWS and blocks >= 2 * fuse_min_blocks(D) * sms
    rows = FUSE_BLOCK_ROWS if wide else FUSE_SMALL_ROWS
    keys = max(nq0, nq1) if gated else nq1
    ring = min(FUSE_STAGES, -(-keys // FUSE_KEY_TILE))
    q_tile = rows * (D + 8) * 2 if D >= FUSE_Q_SMEM_WIDTH else 0
    return rows, q_tile + ring * FUSE_KEY_TILE * (D + 8) * 2 * (1 if gated else 2)


def fuse_min_blocks(D):
    """csrc/fuse.cu's blocks an SM its registers are held to (Tile::MIN_BLOCKS)."""
    return 4 if D == 16 else 2


def check_gemm_operands(a, w, out, *residuals, name="the bf16 GEMM"):
    """What csrc/gemm.cu's TMA loads and epilogue take: a (M, K) and w (N, K),
    out and each residual M rows of N (any leading shape), all row-major and
    contiguous, K and N multiples of GEMM_ALIGN (16-byte rows), every base
    16-byte aligned. Runs before every bf16 launch, so it builds no message
    unless it raises."""
    if a.dim() != 2 or w.dim() != 2 or a.shape[1] != w.shape[1]:
        raise ValueError(f"{name} takes a (M, K) and w (N, K), got {tuple(a.shape)}, "
                         f"{tuple(w.shape)}")
    (M, K), N = a.shape, w.shape[0]
    if K % GEMM_ALIGN or N % GEMM_ALIGN or min(M, K, N) < 1:
        raise ValueError(f"{name} takes K and N in multiples of {GEMM_ALIGN}, got M={M}, "
                         f"K={K}, N={N}")
    for i, t in enumerate((a, w, out) + residuals):
        rows, cols = (M, K) if i == 0 else (N, K) if i == 1 else (M, N)
        if (t.dim() < 2 or t.shape[-1] != cols or t.numel() != rows * cols
                or not t.is_contiguous() or t.data_ptr() % 16):
            key = ("a", "w", "out")[i] if i < 3 else f"residual {i - 3}"
            raise ValueError(f"{name}: {key} must be {rows} contiguous rows of {cols}, 16-byte "
                             f"aligned; got shape {tuple(t.shape)}, strides {t.stride()}, "
                             f"address {t.data_ptr():#x}")


def check_gemm_s8_operands(a, sa, w, ws, bias, out, epi, amax=None, name="the int8 GEMM"):
    """What csrc/gemm.cu's int8 product takes: codes a (M, K) and w (N, K)
    int8, K a multiple of GEMM_S8_ALIGN (16-byte rows for TMA), N of
    GEMM_ALIGN; out M rows of N, bf16 for `_EPI_Q_BF16`, fp32 for the GELU
    hiddens of `_EPI`; a, w and out row-major, contiguous and 16-byte aligned;
    scales sa (M,) fp32, ws (N,) and bias (N,) bf16, contiguous; amax, where
    given (fp32 epilogues only), (M,) fp32. Runs before every int8 launch, on
    the host's critical path of the short rows, so it reads each attribute
    once and builds no message unless it raises."""
    i8, f32, bf = torch.int8, torch.float32, torch.bfloat16
    out_dtype = _S8_OUT_DTYPE.get(epi)
    ok = (a.dim() == 2 and w.dim() == 2 and a.dtype == i8 and w.dtype == i8
          and out_dtype is not None and (amax is None or out_dtype == f32))
    if ok:
        (M, K), (N, Kw) = a.shape, w.shape
        ok = (Kw == K and K % GEMM_S8_ALIGN == 0 and N % GEMM_ALIGN == 0 and min(M, K, N) >= 1
              and out.dtype == out_dtype and out.dim() >= 2 and out.shape[-1] == N
              and out.numel() == M * N and a.is_contiguous() and w.is_contiguous()
              and out.is_contiguous() and (a.data_ptr() | w.data_ptr() | out.data_ptr()) % 16 == 0
              and sa.dtype == f32 and sa.numel() == M and sa.is_contiguous()
              and ws.dtype == bf and ws.numel() == N and ws.is_contiguous()
              and bias.dtype == bf and bias.numel() == N and bias.is_contiguous()
              and (amax is None or (amax.dtype == f32 and amax.numel() == M
                                    and amax.is_contiguous())))
    if not ok:
        named = {"a": a, "sa": sa, "w": w, "ws": ws, "bias": bias, "out": out, "amax": amax}
        got = "; ".join(f"{k} {t.dtype} {tuple(t.shape)} strides {t.stride()} at "
                        f"{t.data_ptr():#x}" for k, t in named.items() if t is not None)
        raise ValueError(f"{name} takes int8 a (M, K) and w (N, K), K a multiple of "
                         f"{GEMM_S8_ALIGN}, N of {GEMM_ALIGN}, a contiguous 16-byte aligned "
                         f"out (M, N) of {out_dtype} (epilogue {epi}), sa (M,) fp32, ws and "
                         f"bias (N,) bf16, amax (M,) fp32 for an fp32 out only; got {got}")


def check_fuse_width(D, name="the fusion kernel"):
    """The adapter widths that csrc/fuse.cu takes."""
    if D not in FUSE_WIDTHS:
        raise ValueError(f"{name} takes adapter widths in {FUSE_WIDTHS}, got D={D}")


def check_unscaled_attn(B, Nq, Nk, D, DV, name="K10"):
    """The shapes csrc/fuse.cu's `stg_unscaled_attn` takes: D = DV in
    FUSE_WIDTHS, any Nq, Nk >= 1 and B >= 1 (its launcher refuses only a
    grid past 2^31 - 1 blocks)."""
    if D != DV or D not in FUSE_WIDTHS or min(Nq, Nk, B) < 1:
        raise ValueError(f"{name} takes D = DV in {FUSE_WIDTHS} and Nq, Nk, B >= 1, got B={B}, "
                         f"Nq={Nq}, Nk={Nk}, D={D}, DV={DV}")


def _check_block(x, heads, bias, weights):
    """Shared validation of K1/K2 inputs on the card."""
    if x.dim() != 3:
        raise ValueError(f"x must be (B_, N, C), got {tuple(x.shape)}")
    B_, N, C = x.shape
    if C % heads:
        raise ValueError(f"C={C} is not a multiple of heads={heads}")
    check_attn_shape(N, C // heads)
    named = {"x": (x, torch.bfloat16), **weights}
    if bias is not None:
        named["bias"] = (bias, torch.float32)
        nWb = bias.shape[0]
        _check_shapes({"bias": (bias, (nWb, heads, N, N))})
        if B_ % nWb:
            raise ValueError(f"B_={B_} is not a multiple of the bias period {nWb}")
    _check_cuda(x, named)


KERNELS = []                          # every wrapper, in the order they are made


class _Leaf:
    """The place of the i-th tensor in a flattened argument list."""

    __slots__ = ("i",)

    def __init__(self, i):
        self.i = i


def _flatten(obj, leaves):
    """obj (arguments: tensors, dicts / lists / tuples of them, constants)
    with every tensor appended to `leaves` and replaced by its _Leaf."""
    if isinstance(obj, torch.Tensor):
        leaves.append(obj)
        return _Leaf(len(leaves) - 1)
    if isinstance(obj, dict):
        return {k: _flatten(v, leaves) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_flatten(v, leaves) for v in obj)
    return obj


def _unflatten(obj, leaves):
    if isinstance(obj, _Leaf):
        return leaves[obj.i]
    if isinstance(obj, dict):
        return {k: _unflatten(v, leaves) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_unflatten(v, leaves) for v in obj)
    return obj


class _Recompute(torch.autograd.Function):
    """One wrapper call as an autograd node: forward the call itself (kernel
    or CPU plain version, counted), backward the wrapper's `recompute` on the
    saved inputs (module docstring)."""

    @staticmethod
    def forward(ctx, kernel, spec, *leaves):
        ctx.kernel, ctx.spec = kernel, spec
        ctx.save_for_backward(*leaves)
        args, kw = _unflatten(spec, leaves)
        return kernel.run(*args, **kw)

    @staticmethod
    def backward(ctx, *grads):
        kernel = ctx.kernel
        if not kernel.differentiable:
            raise RuntimeError(f"{kernel.name} has no gradient: the JAX package never "
                               f"differentiates a quantized tower")
        need = ctx.needs_input_grad[2:]
        with annotate(kernel.span), torch.enable_grad():
            inputs = [t.detach().requires_grad_(n) for t, n in zip(ctx.saved_tensors, need)]
            args, kw = _unflatten(ctx.spec, inputs)
            out = kernel.recompute(*args, **kw)
            outs = out if isinstance(out, tuple) else (out,)
            got = iter(torch.autograd.grad(outs, [t for t, n in zip(inputs, need) if n], grads,
                                           allow_unused=True))
        return (None, None) + tuple(next(got) if n else None for n in need)


class _Kernel:
    """A kernel wrapper with its id ("K1"...), its launch count; registers
    itself in KERNELS. `recompute` is what its backward differentiates: the
    port of the XLA reference of the JAX `_*_bwd`, never the plain version
    (K9's plain version is that port). None (the int8 wrappers): a gradient
    through it raises."""

    def __init__(self, kid, fn, plain, launch, recompute=None):
        self.id = kid
        self.name = f"{fn} ({kid})"
        self.span = f"train.recompute.{kid}"      # `_Recompute.backward`'s span
        self.plain = plain
        self.recompute = recompute
        self._launch = launch
        self.differentiable = recompute is not None
        self.launches = 0
        KERNELS.append(self)

    def __call__(self, x, *args, **kw):
        if not x.is_contiguous():      # checked on every device, so that the
            raise ValueError(f"{self.name}: x must be contiguous")   # CPU tests see it
        if torch.is_grad_enabled():
            leaves = []
            spec = _flatten(((x,) + args, kw), leaves)
            if any(t.requires_grad for t in leaves):
                return _Recompute.apply(self, spec, *leaves)
        return self.run(x, *args, **kw)

    def run(self, x, *args, **kw):
        """The call without autograd: the plain version on the CPU, else the
        kernel, counted."""
        if x.device.type == "cpu":
            return self.plain(x, *args, **kw)
        dev = x.device
        if dev.type != "cuda":
            raise ValueError(f"{self.name}: no kernel for device {dev}")
        if dev.index == torch.cuda.current_device():   # no device switch to make
            out = self._launch(x, *args, **kw)
        else:
            with torch.cuda.device(dev):
                out = self._launch(x, *args, **kw)
        self.launches += 1
        return out


def _win_block_cuda(x, ln_w, ln_b, w_qkv, b_qkv, w_proj, b_proj, heads,
                    bias=None):
    B_, N, C = x.shape
    bf = torch.bfloat16
    _check_block(x, heads, bias, {
        "ln_w": (ln_w, bf), "ln_b": (ln_b, bf), "w_qkv": (w_qkv, bf),
        "b_qkv": (b_qkv, bf), "w_proj": (w_proj, bf), "b_proj": (b_proj, bf)})
    _check_shapes({"ln_w": (ln_w, (C,)), "ln_b": (ln_b, (C,)),
                   "w_qkv": (w_qkv, (3 * C, C)), "b_qkv": (b_qkv, (3 * C,)),
                   "w_proj": (w_proj, (C, C)), "b_proj": (b_proj, (C,))})
    s = _stream(x)
    M = B_ * N
    xn = _ln_bf16(x.view(M, C), ln_w, ln_b, s)
    qkv = _gemm_bf16(xn, w_qkv, b_qkv, torch.empty((M, 3 * C), dtype=bf, device=x.device),
                     _EPI_BF16, s)
    o = _attn_core(qkv.view(B_, N, 3 * C), bias, heads, s)
    return _gemm_bf16(o.view(M, C), w_proj, b_proj, torch.empty_like(x), _EPI_BF16, s)


def _win_block_q_cuda(x, ln_w, ln_b, wqkv_q, wqkv_s, b_qkv, wproj_q, wproj_s,
                      b_proj, heads, bias=None):
    B_, N, C = x.shape
    bf, i8 = torch.bfloat16, torch.int8
    _check_block(x, heads, bias, {
        "ln_w": (ln_w, bf), "ln_b": (ln_b, bf), "wqkv_q": (wqkv_q, i8),
        "wqkv_s": (wqkv_s, bf), "b_qkv": (b_qkv, bf), "wproj_q": (wproj_q, i8),
        "wproj_s": (wproj_s, bf), "b_proj": (b_proj, bf)})
    _check_shapes({"ln_w": (ln_w, (C,)), "ln_b": (ln_b, (C,)),
                   "wqkv_q": (wqkv_q, (3 * C, C)), "wqkv_s": (wqkv_s, (3 * C,)),
                   "b_qkv": (b_qkv, (3 * C,)), "wproj_q": (wproj_q, (C, C)),
                   "wproj_s": (wproj_s, (C,)), "b_proj": (b_proj, (C,))})
    s = _stream(x)
    M = B_ * N
    xq, sx = _quant_rows(x.view(M, C), s, ln_w, ln_b)
    qkv = torch.empty((B_, N, 3 * C), dtype=bf, device=x.device)
    _gemm_s8(xq, sx, wqkv_q, wqkv_s, b_qkv, qkv, _EPI_Q_BF16, s)
    o = _attn_core(qkv, bias, heads, s)
    oq, so = _quant_rows(o.view(M, C), s)
    out = torch.empty_like(x)
    _gemm_s8(oq, so, wproj_q, wproj_s, b_proj, out, _EPI_Q_BF16, s)
    return out


def _ffn_q_hidden(x, ln_w, ln_b, w1_q, w1_s, b1, w2_q, w2_s, b2, act, s):
    """K3's first launches: validation, LN + quantize, fc1 with its fp32
    hidden and row maxima, the hidden's quantization. Returns (int8 codes,
    fp32 scales) of the hidden."""
    if act not in _EPI:
        raise ValueError(f"act must be one of {sorted(_EPI)}, got {act!r}")
    if x.dim() != 2:
        raise ValueError(f"x must be (M, C), got {tuple(x.shape)}")
    M, C = x.shape
    H = w1_q.shape[0]
    bf, i8 = torch.bfloat16, torch.int8
    _check_cuda(x, {"x": (x, bf), "ln_w": (ln_w, bf), "ln_b": (ln_b, bf),
                    "w1_q": (w1_q, i8), "w1_s": (w1_s, bf), "b1": (b1, bf),
                    "w2_q": (w2_q, i8), "w2_s": (w2_s, bf), "b2": (b2, bf)})
    _check_shapes({"ln_w": (ln_w, (C,)), "ln_b": (ln_b, (C,)),
                   "w1_q": (w1_q, (H, C)), "w1_s": (w1_s, (H,)), "b1": (b1, (H,)),
                   "w2_q": (w2_q, (C, H)), "w2_s": (w2_s, (C,)), "b2": (b2, (C,))})
    if C % 16 or H % 16:
        raise ValueError(f"C={C} and hidden={H} must be multiples of 16")
    xq, sx = _quant_rows(x, s, ln_w, ln_b)
    # the fp32 hidden (M, H) goes through device memory: its per-row int8
    # scale needs the whole row's max before fc2 can start. fc1's epilogue
    # gathers each row's max |h| into hmax as it stores the hidden, so the
    # hidden's quantization reads it once
    h = torch.empty((M, H), dtype=torch.float32, device=x.device)
    hmax = torch.zeros((M,), dtype=torch.float32, device=x.device)
    _gemm_s8(xq, sx, w1_q, w1_s, b1, h, _EPI[act], s, amax=hmax)
    return _quant_rows(h, s, amax=hmax)


def _ffn_q_cuda(x, ln_w, ln_b, w1_q, w1_s, b1, w2_q, w2_s, b2, act):
    s = _stream(x)
    hq, sh = _ffn_q_hidden(x, ln_w, ln_b, w1_q, w1_s, b1, w2_q, w2_s, b2, act, s)
    out = torch.empty_like(x)
    _gemm_s8(hq, sh, w2_q, w2_s, b2, out, _EPI_Q_BF16, s)
    return out


def _adapter_operands(x, wd, bd):
    """Validation of K11's adapter operands on the card; returns its width D."""
    C, D = x.shape[-1], wd.shape[0]
    _check_cuda(x, {"wd": (wd, torch.bfloat16), "bd": (bd, torch.bfloat16)})
    _check_shapes({"wd": (wd, (D, C)), "bd": (bd, (D,))})
    return D


def _win_block_qad_cuda(x, ln_w, ln_b, wqkv_q, wqkv_s, b_qkv, wproj_q, wproj_s, b_proj,
                        wd, bd, heads, emit_o):
    D = _adapter_operands(x, wd, bd)
    B_, N, C = x.shape
    bf = torch.bfloat16
    h = torch.empty((B_, N, D), dtype=bf, device=x.device)
    if not rowadapt_route(C, D):      # K2's launches, o rounded to bf16, then the adapter product
        o = _win_block_q_cuda(x, ln_w, ln_b, wqkv_q, wqkv_s, b_qkv, wproj_q, wproj_s, b_proj,
                              heads)
        _gemm_bf16(o.view(B_ * N, C), wd, bd, h.view(B_ * N, D), _EPI_BF16_GELU, _stream(x))
        return (o, h) if emit_o else h
    # the products' checks hold every weight; x and the LN's here, read once
    _check_block(x, heads, None, {"ln_w": (ln_w, bf), "ln_b": (ln_b, bf)})
    _check_shapes({"ln_w": (ln_w, (C,)), "ln_b": (ln_b, (C,))})
    s = _stream(x)
    M = B_ * N
    xq, sx = _quant_rows(x.view(M, C), s, ln_w, ln_b)
    att = torch.empty((M, C), dtype=bf, device=x.device)      # the merged heads
    if tattn_route(N, C // heads):    # the temporal site: qkv and its cores in one launch
        _tattn(xq, sx, wqkv_q, wqkv_s, b_qkv, att, N, heads, s)
    else:                             # the spatial site: the product, then the resident core
        qkv = torch.empty((B_, N, 3 * C), dtype=bf, device=x.device)
        _gemm_s8(xq, sx, wqkv_q, wqkv_s, b_qkv, qkv, _EPI_Q_BF16, s)
        _attn_core(qkv, None, heads, s, out=att.view(B_, N, C))
    aq, sa = _quant_rows(att, s)
    o = torch.empty_like(x) if emit_o else None       # qd: o stays on chip
    _rowadapt(aq, sa, wproj_q, wproj_s, b_proj, wd, bd, _EPI_BF16_GELU, s, out=o, h=h)
    return (o, h) if emit_o else h


def _ffn_qh_cuda(x, ln_w, ln_b, w1_q, w1_s, b1, w2_q, w2_s, b2, wd, bd, act):
    D = _adapter_operands(x, wd, bd)
    h = torch.empty((x.shape[0], D), dtype=torch.bfloat16, device=x.device)
    if not rowadapt_route(x.shape[-1], D):            # K3's launches, then the adapter product
        o = _ffn_q_cuda(x, ln_w, ln_b, w1_q, w1_s, b1, w2_q, w2_s, b2, act)
        _gemm_bf16(o, wd, bd, h, _EPI_BF16_GELU, _stream(x))
        return o, h
    s = _stream(x)
    hq, sh = _ffn_q_hidden(x, ln_w, ln_b, w1_q, w1_s, b1, w2_q, w2_s, b2, act, s)
    o = torch.empty_like(x)
    _rowadapt(hq, sh, w2_q, w2_s, b2, wd, bd, _EPI_BF16_GELU, s, out=o, h=h)
    return o, h


def _ffn_composed(x, ln_w, ln_b, w1, b1, w2, b2):
    # K7 at the widths csrc/ffn.cu does not instantiate: LN, then fc1 with its
    # erf-GELU into a bf16 (M, H) hidden in device memory, then fc2
    M, C = x.shape
    H = w1.shape[0]
    bf = torch.bfloat16
    _check_cuda(x, {"x": (x, bf), "ln_w": (ln_w, bf), "ln_b": (ln_b, bf), "w1": (w1, bf),
                    "b1": (b1, bf), "w2": (w2, bf), "b2": (b2, bf)})
    _check_shapes({"ln_w": (ln_w, (C,)), "ln_b": (ln_b, (C,)), "w1": (w1, (H, C)),
                   "b1": (b1, (H,)), "w2": (w2, (C, H)), "b2": (b2, (C,))})
    s = _stream(x)
    xn = _ln_bf16(x, ln_w, ln_b, s)
    h = _gemm_bf16(xn, w1, b1, torch.empty((M, H), dtype=bf, device=x.device),
                   _EPI_BF16_GELU, s)
    return _gemm_bf16(h, w2, b2, torch.empty_like(x), _EPI_BF16, s)


def _ffn_cuda(x, ln_w, ln_b, w1, b1, w2, b2):
    if x.dim() == 2 and w1.dim() == 2 and ffn_composed_route(x.shape[1], w1.shape[0]):
        return _ffn_composed(x, ln_w, ln_b, w1, b1, w2, b2)
    # one launch: LN, fc1 chunk by chunk with its erf-GELU, fc2 accumulated; the
    # (M, 4C) hidden stays on chip
    check_ffn(x, ln_w, ln_b, w1, b1, w2, b2)
    M, C = x.shape
    out = torch.empty_like(x)
    cuda_lib.check("ffn.cu", cuda_lib.lib("ffn.cu").stg_ffn_bf16(
        _ptr(x), _ptr(ln_w), _ptr(ln_b), _ptr(w1), _ptr(b1), _ptr(w2), _ptr(b2), _ptr(out), M,
        C, _LN_EPS, _stream(x)))
    return out


def _wmsa_cuda(q, k, v, bm):
    if q.dim() != 3:
        raise ValueError(f"q must be (R, N, dh), got {tuple(q.shape)}")
    R, N, dh = q.shape
    P = bm.shape[0]
    bf = torch.bfloat16
    _check_cuda(q, {"q": (q, bf), "k": (k, bf), "v": (v, bf), "bm": (bm, torch.float32)})
    _check_shapes({"k": (k, (R, N, dh)), "v": (v, (R, N, dh)), "bm": (bm, (P, N, N))})
    check_attn_shape(N, dh)
    if R % P:
        raise ValueError(f"R={R} is not a multiple of the bias period P={P}")
    o = torch.empty_like(q)
    cuda_lib.check("attn.cu", cuda_lib.lib("attn.cu").stg_attn_qkv(
        _ptr(q), _ptr(k), _ptr(v), _ptr(bm), P, _ptr(o), R, N, dh, _stream(q)))
    return o


def _wmsa_qkv_cuda(qkv, bm, heads):
    # K8's bias (P, N, N) is the core's (P / heads, heads, N, N): row b, head h
    # takes bm[(b heads + h) % P], the row `wmsa` gives r = b heads + h
    if qkv.dim() != 3 or bm.dim() != 3 or heads < 1:
        raise ValueError(f"K8 takes qkv (B_, N, 3C) and a bias (P, N, N), got "
                         f"{tuple(qkv.shape)}, {tuple(bm.shape)}")
    B_, N, C3 = qkv.shape
    P = bm.shape[0]
    if C3 % (3 * heads) or P % heads or (B_ * heads) % P:
        raise ValueError(f"K8 takes 3C a multiple of 3 heads and a bias period P that is a "
                         f"multiple of heads={heads} and divides B_ * heads; got qkv "
                         f"{tuple(qkv.shape)}, bias {tuple(bm.shape)}")
    _check_cuda(qkv, {"qkv": (qkv, torch.bfloat16), "bm": (bm, torch.float32)})
    _check_shapes({"bm": (bm, (P, N, N))})
    check_attn_shape(N, C3 // 3 // heads, name="K8")
    return _attn_core(qkv, bm.view(P // heads, heads, N, N), heads, _stream(qkv))


def _layernorm_cuda(x, ln_w, ln_b):
    # one pass over the three tensors (the call is short: its host time counts);
    # where it fails, the checks every wrapper runs name what is wrong
    bf, dev = torch.bfloat16, x.device
    if not (x.dim() == 2 and x.dtype == bf and ln_w.dtype == bf and ln_b.dtype == bf
            and ln_w.device == dev and ln_b.device == dev and ln_w.dim() == ln_b.dim() == 1
            and ln_w.numel() == ln_b.numel() == x.shape[1] and ln_route(x.shape[1])
            and ln_w.is_contiguous() and ln_b.is_contiguous()
            and (x.data_ptr() | ln_w.data_ptr() | ln_b.data_ptr()) % 16 == 0):
        if x.dim() != 2:
            raise ValueError(f"x must be (M, C), got {tuple(x.shape)}")
        _check_cuda(x, {"x": (x, bf), "ln_w": (ln_w, bf), "ln_b": (ln_b, bf)})
        _check_shapes({"ln_w": (ln_w, (x.shape[1],)), "ln_b": (ln_b, (x.shape[1],))})
        raise ValueError(f"K9 takes rows of a multiple of {LN_ALIGN} up to {LN_MAX_WIDTH} "
                         f"values, got C={x.shape[1]}")
    return _ln_bf16(x, ln_w, ln_b, _stream(x))


def _fuse_cuda(vh, ah, gate_v, gate_a, mask=None):
    if vh.dim() != 3 or ah.dim() != 3:
        raise ValueError(f"vh and ah must be (B, N, D), got {tuple(vh.shape)}, {tuple(ah.shape)}")
    B, Nv, D = vh.shape
    Na = ah.shape[1]
    bf = torch.bfloat16
    named = {"vh": (vh, bf), "ah": (ah, bf), "gate_v": (gate_v, bf), "gate_a": (gate_a, bf)}
    shapes = {"ah": (ah, (B, Na, D)), "gate_v": (gate_v, (1,)), "gate_a": (gate_a, (1,))}
    if mask is not None:
        named["mask"] = (mask, torch.float32)
        shapes["mask"] = (mask, (Nv, Na))
    _check_cuda(vh, named)
    _check_shapes(shapes)
    check_fuse_width(D)
    vo, ao = torch.empty_like(vh), torch.empty_like(ah)
    cuda_lib.check("fuse.cu", cuda_lib.lib("fuse.cu").stg_fuse_bidir(
        _ptr(vh), _ptr(ah), _ptr(gate_v), _ptr(gate_a), _ptr(mask), _ptr(vo), _ptr(ao),
        B, Nv, Na, D, _stream(vh)))
    return vo, ao


def _unscaled_attn_cuda(q, k, v):
    if q.dim() != 3 or k.dim() != 3 or v.dim() != 3:
        raise ValueError(f"q, k, v must be (B, N, D), got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    B, Nq, D = q.shape
    Nk, DV = k.shape[1], v.shape[2]
    bf = torch.bfloat16
    _check_cuda(q, {"q": (q, bf), "k": (k, bf), "v": (v, bf)})
    _check_shapes({"k": (k, (B, Nk, D)), "v": (v, (B, Nk, DV))})
    check_unscaled_attn(B, Nq, Nk, D, DV)
    o = torch.empty_like(q)
    cuda_lib.check("fuse.cu", cuda_lib.lib("fuse.cu").stg_unscaled_attn(
        _ptr(q), _ptr(k), _ptr(v), _ptr(o), B, Nq, Nk, D, _stream(q)))
    return o


win_block = _Kernel("K1", "win_block", win_block_plain, _win_block_cuda,
                    recompute=win_block_recompute)
win_block_q = _Kernel("K2", "win_block_q", win_block_q_plain, _win_block_q_cuda)
ffn_q = _Kernel("K3", "ffn_q", ffn_q_plain, _ffn_q_cuda)
win_fuse = _Kernel("K5", "win_fuse", fuse_plain, _fuse_cuda, recompute=cross_modal_fuse)
bidir_fuse = _Kernel("K6", "bidir_fuse", fuse_plain, _fuse_cuda, recompute=cross_modal_fuse)
ffn = _Kernel("K7", "ffn", ffn_plain, _ffn_cuda, recompute=ffn_recompute)
wmsa = _Kernel("K8", "wmsa", wmsa_plain, _wmsa_cuda, recompute=wmsa_recompute)
wmsa_qkv = _Kernel("K8", "wmsa_qkv", wmsa_qkv_plain, _wmsa_qkv_cuda,
                   recompute=wmsa_qkv_recompute)
layernorm = _Kernel("K9", "layernorm", layernorm_plain, _layernorm_cuda,
                    recompute=layernorm_plain)
unscaled_attention = _Kernel("K10", "unscaled_attention", unscaled_attention_plain,
                             _unscaled_attn_cuda, recompute=unscaled_attention_recompute)
win_block_qd = _Kernel("K11", "win_block_qd", functools.partial(win_block_qad_plain, emit_o=False),
                       functools.partial(_win_block_qad_cuda, emit_o=False))
win_block_qh = _Kernel("K11", "win_block_qh", functools.partial(win_block_qad_plain, emit_o=True),
                       functools.partial(_win_block_qad_cuda, emit_o=True))
ffn_qh = _Kernel("K11", "ffn_qh", ffn_qh_plain, _ffn_qh_cuda)


def reset_launches():
    for k in KERNELS:
        k.launches = 0


def launches_by_id():
    """{kernel id: launches summed over its wrappers} (K4's two variants are
    two wrappers under one id, K11's three bodies three)."""
    out = {}
    for k in KERNELS:
        out[k.id] = out.get(k.id, 0) + k.launches
    return out


# ---------------------------------------------------------------------------
# entry points of the CLIP tower
# ---------------------------------------------------------------------------

def clip_attention_block(attn, ln, x, heads: int):
    """LN + self-attention + out-proj over the middle axis of x (B_, N, C):
    K2 for an int8 tower, K1 otherwise. Counterpart of
    `pallas_attn.py::clip_temporal_megakernel` (:867), without its packing
    and padding."""
    if attn.in_proj.quantized:
        return win_block_q(x, ln.weight, ln.bias, attn.in_proj.weight_q,
                           attn.in_proj.weight_s, attn.in_proj.bias,
                           attn.out_proj.weight_q, attn.out_proj.weight_s,
                           attn.out_proj.bias, heads)
    return win_block(x, ln.weight, ln.bias, attn.in_proj.weight,
                     attn.in_proj.bias, attn.out_proj.weight,
                     attn.out_proj.bias, heads)


def ffn_q_megakernel(mlp, ln, x, act: str = _GELU, keys=("fc1", "fc2")):
    """LN + int8 FFN over x (..., C) in K3 (`pallas_attn.py::ffn_q_megakernel`
    :1660, with its defaults: erf-GELU and the Swin keys; CLIP passes
    QuickGELU and ("c_fc", "c_proj"))."""
    shape = x.shape
    fc1, fc2 = (getattr(mlp, k) for k in keys)
    out = ffn_q(x.reshape(-1, shape[-1]), ln.weight, ln.bias,
                fc1.weight_q, fc1.weight_s, fc1.bias,
                fc2.weight_q, fc2.weight_s, fc2.bias, act)
    return out.reshape(shape)


def clip_attn_megakernel_h(attn, ln, adapter, x, heads: int, emit_o: bool):
    """LN + int8 self-attention + out-proj over the middle axis of x (B_, N,
    C), with the adapter's down-projection and GELU in K11
    (`pallas_attn.py::clip_attn_megakernel_h` :927, without its packing and
    padding): the hidden (B_, N, D) alone (`emit_o` False, the temporal
    site), or (attention output, hidden) (the spatial site). Takes an int8
    tower only, as the JAX function does."""
    if not attn.in_proj.quantized:
        raise ValueError("clip_attn_megakernel_h takes an int8 tower (quantize_clip_tower)")
    kernel = win_block_qh if emit_o else win_block_qd
    return kernel(x, ln.weight, ln.bias, attn.in_proj.weight_q, attn.in_proj.weight_s,
                  attn.in_proj.bias, attn.out_proj.weight_q, attn.out_proj.weight_s,
                  attn.out_proj.bias, adapter.D_fc1.weight, adapter.D_fc1.bias, heads)


def ffn_qh_megakernel(mlp, ln, adapter, x, act: str = _GELU, keys=("fc1", "fc2")):
    """LN + int8 FFN over x (..., C) that also returns the adapter hidden of
    its output, in K11 (`pallas_attn.py::ffn_qh_megakernel` :1724, its
    defaults as `ffn_q_megakernel`'s). Returns (FFN output, hidden (..., D))."""
    shape = x.shape
    fc1, fc2 = (getattr(mlp, k) for k in keys)
    o, h = ffn_qh(x.reshape(-1, shape[-1]), ln.weight, ln.bias,
                  fc1.weight_q, fc1.weight_s, fc1.bias, fc2.weight_q, fc2.weight_s, fc2.bias,
                  adapter.D_fc1.weight, adapter.D_fc1.bias, act)
    return o.reshape(shape), h.reshape(shape[:-1] + (h.shape[-1],))


# ---------------------------------------------------------------------------
# entry points of the Swin tower (bf16 or int8), routed as `pallas_attn.py`
# routes them
# ---------------------------------------------------------------------------

def block_kernel_route(num_heads: int) -> bool:
    """True: LN + attention + proj in K1 (K2 for an int8 tower); False: LN,
    then the K8 core with the qkv and proj products outside it, through
    `linear` (`int8_matmul` for an int8 tower) (`swin.py:171-179`,
    :224-244)."""
    return num_heads <= BLOCK_KERNEL_MAX_HEADS


def ln_kernel_route(numel: int) -> bool:
    """K9 for tensors of at least 2^20 elements (`layernorm_fused` :819)."""
    return numel >= LN_KERNEL_MIN_ELEMS


def ffn_kernel_route(rows: int, hidden: int, itemsize: int) -> bool:
    """K7 when the (rows, hidden) hidden takes >= 96 MiB (`swin.py:204-210`;
    the JAX opt-in `STGCMA_FUSED_FFN` is not honoured)."""
    return rows * hidden * itemsize >= FFN_KERNEL_MIN_HIDDEN_BYTES


def _block_kernel(attn, ln, x, heads, bm):
    """K2 when the tower is int8 (`"kernel_q" in attn_p["qkv"]`,
    `pallas_attn.py:585`, :637), else K1."""
    if attn.qkv.quantized:
        return win_block_q(x, ln.weight, ln.bias, attn.qkv.weight_q, attn.qkv.weight_s,
                           attn.qkv.bias, attn.proj.weight_q, attn.proj.weight_s,
                           attn.proj.bias, heads, bias=bm)
    return win_block(x, ln.weight, ln.bias, attn.qkv.weight, attn.qkv.bias,
                     attn.proj.weight, attn.proj.bias, heads, bias=bm)


def window_block_megakernel(attn, ln, x, num_heads: int, rel_index, mask=None):
    """LN + W-MSA / SW-MSA + proj in K1 or K2 (`pallas_attn.py:563`). x: (BT*nW,
    N, C) raw window tokens; the bias is the gathered table plus the shift
    mask, (nW, h, N, N) fp32, repeating with period nW along the windows."""
    N = x.shape[1]
    bias = gather_bias(attn.relative_position_bias_table, rel_index, num_heads, N)
    bm = bias[None] if mask is None else bias[None] + mask[:, None].float()
    return _block_kernel(attn, ln, x, num_heads, bm.contiguous())


def temporal_block_megakernel(attn, ln, x, num_heads: int, t_index, signal: str = "video"):
    """LN + temporal attention + proj in K1 or K2 (`pallas_attn.py:611`), with the
    per-modality table as a (1, h, T, T) bias. x: (B*N, T, C)."""
    T = x.shape[1]
    bias = gather_bias(temporal_table(attn, signal), t_index, num_heads, T)
    return _block_kernel(attn, ln, x, num_heads, bias[None].contiguous())


def _qkv_core(attn, x, num_heads: int, bm):
    """qkv product -> K8 over the packed qkv (`wmsa_qkv`: q scaled by a
    dh^-1/2 rounded to x's dtype, each (row, head)'s attention with its bias,
    heads merged) -> proj product. The products go through `linear`:
    `int8_matmul` for an int8 tower, as JAX's `temporal_attention_fused`
    (:650) reaches `quant.py::int8_matmul`."""
    return linear(attn.proj, wmsa_qkv(linear(attn.qkv, x), bm, num_heads))


def window_attention_fused(attn, x, num_heads: int, rel_index, mask=None):
    """W-MSA with the K8 core (`pallas_attn.py:351`). x: (B_, N, C), already
    normalized; the bias has period nW * heads, or heads without a mask."""
    N = x.shape[1]
    bias = gather_bias(attn.relative_position_bias_table, rel_index, num_heads, N)
    if mask is not None:
        bias = (bias[None] + mask[:, None].float()).reshape(-1, N, N)
    return _qkv_core(attn, x, num_heads, bias.contiguous())


def temporal_attention_fused(attn, x, num_heads: int, t_index, signal: str = "video"):
    """Temporal attention with the K8 core (`pallas_attn.py:650`): rows
    B*N*heads, bias (heads, T, T). x: (B*N, T, C), already normalized."""
    T = x.shape[1]
    bias = gather_bias(temporal_table(attn, signal), t_index, num_heads, T)
    return _qkv_core(attn, x, num_heads, bias.contiguous())


def layernorm_fused(ln, x):
    """K9 over the last axis of a large x, the plain LayerNorm below 2^20
    elements (`pallas_attn.py:819`)."""
    if not ln_kernel_route(x.numel()):
        return layernorm_plain(x, ln.weight, ln.bias)
    shape = x.shape
    return layernorm(x.reshape(-1, shape[-1]), ln.weight, ln.bias).reshape(shape)


def ffn_megakernel(mlp, ln, x):
    """LN + FFN with erf-GELU in K7 (`pallas_attn.py:834`). x: (..., C);
    returns the FFN output (the caller adds the residual)."""
    shape = x.shape
    out = ffn(x.reshape(-1, shape[-1]), ln.weight, ln.bias, mlp.fc1.weight, mlp.fc1.bias,
              mlp.fc2.weight, mlp.fc2.bias)
    return out.reshape(shape)


def cross_modal_fuse_windows(v_hidden, a_hidden, gate_v, gate_a):
    """The spatial STG-CMA exchange over window token batches (BT*nW,
    ws^2, d) in K5 (`pallas_attn.py:1308`)."""
    return win_fuse(v_hidden, a_hidden, gate_v, gate_a)


def flash_fuse_route(Nv: int, Na: int, D: int) -> str:
    """"plain" below FLASH_MIN_TOKENS (XLA's `cross_modal_fuse` in the JAX
    package), "K6" where JAX takes its bidirectional kernel, "K10" where it
    falls back to two `unscaled_attention` calls (`pallas_attn.py:1029-1044`)."""
    if Nv < FLASH_MIN_TOKENS:
        return "plain"
    if Nv % 16 == 0 and Na % 16 == 0 and D % 8 == 0 and Na * D * 4 <= FLASH_MAX_KEY_BYTES:
        return "K6"
    return "K10"


def cross_modal_fuse_flash(v_hidden, a_hidden, gate_v, gate_a):
    """The joint STG-CMA exchange over the full stage grid
    (`pallas_attn.py:1022`): K6, the plain `cross_modal_fuse` below
    FLASH_MIN_TOKENS, or two K10 calls with the gated adds in torch
    (:1039-1044: gate * a2v rounded to the dtype, then added)."""
    route = flash_fuse_route(v_hidden.shape[1], a_hidden.shape[1], v_hidden.shape[2])
    if route == "plain":
        return cross_modal_fuse(v_hidden, a_hidden, gate_v, gate_a)
    if route == "K6":
        return bidir_fuse(v_hidden, a_hidden, gate_v, gate_a)
    dt = v_hidden.dtype
    a2v = unscaled_attention(v_hidden, a_hidden, a_hidden)
    v2a = unscaled_attention(a_hidden, v_hidden, v_hidden)
    return v_hidden + gate_v.to(dt) * a2v, a_hidden + gate_a.to(dt) * v2a
