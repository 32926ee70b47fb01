"""The int8 product and row quantization of the port's Hopper kernels, on the
CPU: csrc/gemm.cu's int8 product on TMA + wgmma (s8, k32; K a multiple of
16, 16-byte aligned row-major operands, `check_gemm_s8_operands`) and
csrc/rowprep.cu's row quantization, which takes an fp32 hidden's row maxima
from the epilogue of the product that stored it.

- `check_gemm_s8_operands` refuses each operand TMA or the epilogue cannot
  take, and `_quant_rows` what the quantizer cannot.
- Each card composition that issues an int8 product (K2 at the four
  CLIP-B/16 sites, K3 with QuickGELU and erf-GELU, K11's three bodies, the
  int8 K12, K13, K14, K4 at Swin-Base stages 2 and 3, `linear_q`), run on CPU
  tensors with the CUDA launches replaced by a recorder: every product it
  hands `stg_gemm_s8` has passed the check, and every fp32 hidden is stored
  with its row maxima and quantized from them, with no second read for them.
- Maxima taken tile by tile and combined by max (as the epilogue's
  atomicMax on the bits does), then the quantization at that scale, equal
  `quant_rows` bit for bit, on rows with zeros, +-127 clamps and
  round-half-even ties.
- The int8 k-tile and K alignment the wrappers assume are gemm.cu's own
  constants, and gemm.cu has one main loop (no mma.sync).

No card is needed: the plain versions and their JAX parity are held by the
other port test files (`test_quant_rows_matches_jax_with_exact_reciprocal`
in tests/test_torch_port_kernels.py among them).
"""
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from stgcma_tpu_torch.ops import clip_block as PCB
from stgcma_tpu_torch.ops import cuda_lib
from stgcma_tpu_torch.ops import fused_attn as FA
from stgcma_tpu_torch.ops import quant as Q
from stgcma_tpu_torch.ops import swin_block as SB

from test_torch_port_hopper_limits import (_Recorder, _block_w, _empty, _ffn_q_args, _k1_args,
                                           _tadapt_w)

BF, I8, F32 = torch.bfloat16, torch.int8, torch.float32
CSRC = Path(FA.__file__).resolve().parent.parent / "csrc"
QGELU, GELU = FA._EPI[FA._QUICK_GELU], FA._EPI[FA._GELU]


# ---------------------------------------------------------------------------
# what check_gemm_s8_operands and _quant_rows refuse
# ---------------------------------------------------------------------------

def _s8_operands(M=32, N=48, K=64, epi=FA._EPI_Q_BF16):
    out = _empty(M, N, dtype=BF if epi == FA._EPI_Q_BF16 else F32)
    return (_empty(M, K, dtype=I8), _empty(M, dtype=F32), _empty(N, K, dtype=I8), _empty(N),
            _empty(N), out, epi)


def _misaligned(M, N, dtype):
    """An (M, N) view whose base lies one element past a 16-byte boundary."""
    return _empty(M * N + 16, dtype=dtype).narrow(0, 1, M * N).view(M, N)


def _swap(i, t, epi=FA._EPI_Q_BF16):
    ops = list(_s8_operands(epi=epi))
    ops[i] = t
    return ops, None


S8_REFUSED = {
    "K_not_a_multiple_of_16": lambda: ((_empty(32, 56, dtype=I8), _empty(32, dtype=F32),
                                        _empty(48, 56, dtype=I8), _empty(48), _empty(48),
                                        _empty(32, 48), FA._EPI_Q_BF16), None),
    "N_not_a_multiple_of_8": lambda: ((_empty(32, 64, dtype=I8), _empty(32, dtype=F32),
                                       _empty(44, 64, dtype=I8), _empty(44), _empty(44),
                                       _empty(32, 44), FA._EPI_Q_BF16), None),
    "a_base_misaligned": lambda: _swap(0, _misaligned(32, 64, I8)),
    "w_base_misaligned": lambda: _swap(2, _misaligned(48, 64, I8)),
    "out_base_misaligned": lambda: _swap(5, _misaligned(32, 48, BF)),
    "w_not_contiguous": lambda: _swap(2, _empty(64, 48, dtype=I8).t()),
    "a_not_contiguous": lambda: _swap(0, _empty(64, 32, dtype=I8).t()),
    "a_bf16": lambda: _swap(0, _empty(32, 64)),
    "w_bf16": lambda: _swap(2, _empty(48, 64)),
    "out_fp32_for_the_bf16_epilogue": lambda: _swap(5, _empty(32, 48, dtype=F32)),
    "out_bf16_for_an_fp32_hidden": lambda: _swap(5, _empty(32, 48), epi=QGELU),
    "out_of_another_shape": lambda: _swap(5, _empty(32, 56)),
    "sa_bf16": lambda: _swap(1, _empty(32)),
    "ws_fp32": lambda: _swap(3, _empty(48, dtype=F32)),
    "bias_too_short": lambda: _swap(4, _empty(40)),
    "unknown_epilogue": lambda: _swap(6, FA._EPI_BF16_GELU),
    "amax_with_the_bf16_epilogue": lambda: (_s8_operands(), _empty(32, dtype=F32)),
    "amax_too_short": lambda: (_s8_operands(epi=GELU), _empty(16, dtype=F32)),
    "amax_bf16": lambda: (_s8_operands(epi=QGELU), _empty(32)),
}


@pytest.mark.parametrize("case", sorted(S8_REFUSED))
def test_check_gemm_s8_operands_refuses_what_tma_cannot_take(case):
    ops, amax = S8_REFUSED[case]()
    with pytest.raises(ValueError):
        FA.check_gemm_s8_operands(*ops, amax=amax)
    # the same call on good operands passes, with and without the hidden's maxima
    FA.check_gemm_s8_operands(*_s8_operands())
    FA.check_gemm_s8_operands(*_s8_operands(epi=QGELU), amax=_empty(32, dtype=F32))


QUANT_REFUSED = {
    "K_not_a_multiple_of_16": lambda: (_empty(8, 40), {}),
    "base_misaligned": lambda: (_misaligned(8, 64, BF), {}),
    "not_contiguous": lambda: (_empty(64, 8).t(), {}),
    "amax_with_LN": lambda: (_empty(8, 64), {"ln_w": _empty(64), "ln_b": _empty(64),
                                             "amax": _empty(8, dtype=F32)}),
    "amax_too_short": lambda: (_empty(8, 64, dtype=F32), {"amax": _empty(4, dtype=F32)}),
}


@pytest.mark.parametrize("case", sorted(QUANT_REFUSED))
def test_quant_rows_refuses_what_the_quantizer_cannot_take(recorder, case):
    x, kw = QUANT_REFUSED[case]()
    with pytest.raises(ValueError):
        FA._quant_rows(x, 0, **kw)
    assert not recorder.calls


# ---------------------------------------------------------------------------
# the int8 card compositions, launches recorded instead of made
# ---------------------------------------------------------------------------

@pytest.fixture
def recorder(monkeypatch):
    rec = _Recorder()
    monkeypatch.setattr(cuda_lib, "lib", rec)
    for mod in (FA, PCB, SB, Q):
        monkeypatch.setattr(mod, "_stream", lambda x: 0)
    return rec


def _k4_q(C, heads, D, N):
    H = round(N ** 0.5)                 # K4 reads its windows (7 x 7) from the fusion mask
    fuse_mask = SB._geo_tensors(H, H, 7, 0, torch.device("cpu"))[2]
    return SB._swin_block_cuda(
        _empty(10, N, C), _empty(10, N, C), _block_w(C, D, [k for k, _ in SB.ADAPTERS], True),
        heads, _empty(1, heads, N, N, dtype=F32), fuse_mask, quantized=True)


def _linear_q(M, K, N):
    x = _empty(M, K)
    return Q._int8_matmul_cuda(x, torch.zeros(M, K), torch.ones(M, 1), _empty(N, K, dtype=I8),
                               _empty(N), _empty(N))


ADAPTER = (_empty(48, 768), _empty(48))
# (composition, fp32 hiddens it stores and quantizes): each at B = 1 (BT = T = 10)
S8_COMPOSITIONS = {
    "K2_clip_b16_video_temporal": (lambda: FA._win_block_q_cuda(
        _empty(197, 10, 768), *_k1_args(768, True), 12), 0),
    "K2_clip_b16_audio_temporal": (lambda: FA._win_block_q_cuda(
        _empty(49, 10, 768), *_k1_args(768, True), 12), 0),
    "K2_clip_b16_video_spatial": (lambda: FA._win_block_q_cuda(
        _empty(10, 197, 768), *_k1_args(768, True), 12), 0),
    "K2_clip_b16_audio_spatial": (lambda: FA._win_block_q_cuda(
        _empty(10, 49, 768), *_k1_args(768, True), 12), 0),
    "K3_clip_b16_quick_gelu": (lambda: FA._ffn_q_cuda(_empty(1970, 768), *_ffn_q_args(768),
                                                      "quick_gelu"), 1),
    "K3_swin_base_stage1_gelu": (lambda: FA._ffn_q_cuda(_empty(7840, 256), *_ffn_q_args(256),
                                                        "gelu"), 1),
    "K11_qd_clip_b16_temporal": (lambda: FA._win_block_qad_cuda(
        _empty(197, 10, 768), *_k1_args(768, True), *ADAPTER, 12, emit_o=False), 0),
    "K11_qh_clip_b16_spatial": (lambda: FA._win_block_qad_cuda(
        _empty(10, 197, 768), *_k1_args(768, True), *ADAPTER, 12, emit_o=True), 0),
    "K11_ffn_qh_clip_b16": (lambda: FA._ffn_qh_cuda(_empty(1970, 768), *_ffn_q_args(768),
                                                    *ADAPTER, "quick_gelu"), 1),
    "K12_int8_clip_b16": (lambda: PCB._clip_block_cuda(
        _empty(10, 197, 768), _empty(10, 49, 768),
        _block_w(768, 48, [k for k, _ in PCB.ADAPTERS], True), 12, quantized=True), 1),
    "K13_int8_clip_b16": (lambda: PCB._tadapt_cuda(_empty(197, 10, 768),
                                                   _tadapt_w(768, 48, True), 12,
                                                   quantized=True), 0),
    "K14_int8_clip_b16": (lambda: PCB._tv2_cuda(_empty(10, 197, 768), _tadapt_w(768, 48, True),
                                                12, 10, quantized=True), 0),
    "K4_int8_swin_base_stage2": (lambda: _k4_q(512, 16, 32, 196), 1),
    "K4_int8_swin_base_stage3": (lambda: _k4_q(1024, 32, 64, 49), 1),
    "linear_q_swin_base_stage3": (lambda: _linear_q(490, 1024, 3072), 0),
}
# argument positions of the recorded launchers
S8 = {"amax": 6, "mnk": slice(7, 10), "epi": 10}
QR = {"x_is_f32": 1, "g": 2, "amax": 4, "mk": slice(7, 9)}
# (M, N, K) of every launcher that runs an int8 product: gemm.cu's, the temporal
# product's qkv (csrc/tattn.cu, N = 3C) and the row-owning product's (csrc/rowadapt.cu)
S8_PRODUCTS = {"stg_gemm_s8": lambda a: a[S8["mnk"]],
               "stg_tattn_s8": lambda a: (a[6], 3 * a[7], a[7]),
               "stg_rowadapt_s8": lambda a: a[13:16]}


@pytest.mark.parametrize("name", sorted(S8_COMPOSITIONS))
def test_int8_compositions_give_the_product_what_it_takes(recorder, name):
    """Every int8 product of the composition has passed `check_gemm_s8_operands`
    (it would have raised) with K a multiple of 16 and N of 8; each fp32
    hidden is stored with its row maxima, and the next row quantization reads
    it once, from those maxima, without a LayerNorm; every other quantization
    forms its own maxima."""
    compose, hiddens = S8_COMPOSITIONS[name]
    compose()
    calls = recorder.calls
    products = [S8_PRODUCTS[fn](args) for fn, args in calls if fn in S8_PRODUCTS]
    assert products, "no int8 product was launched"
    for M, N, K in products:
        assert M >= 1 and N % FA.GEMM_ALIGN == 0 and K % FA.GEMM_S8_ALIGN == 0, (M, N, K)
    stored = 0
    for i, (fn, args) in enumerate(calls):
        if fn == "stg_quant_rows":
            assert args[QR["mk"]][1] % FA.GEMM_S8_ALIGN == 0
        if fn != "stg_gemm_s8" or args[S8["epi"]] == FA._EPI_Q_BF16:
            if fn == "stg_gemm_s8":
                assert args[S8["amax"]] is None
            continue
        stored += 1
        amax = args[S8["amax"]]
        assert amax is not None, "an fp32 hidden was stored without its row maxima"
        quant = next(a for f, a in calls[i + 1:] if f == "stg_quant_rows")
        assert quant[QR["amax"]] == amax and quant[QR["g"]] is None and quant[QR["x_is_f32"]] == 1
        assert quant[QR["mk"]] == (args[S8["mnk"]][0], args[S8["mnk"]][1])
    assert stored == hiddens
    given = [a for f, a in calls if f == "stg_quant_rows" and a[QR["amax"]] is not None]
    assert len(given) == hiddens


# ---------------------------------------------------------------------------
# row maxima by tiles, then the quantization: bit for bit quant_rows
# ---------------------------------------------------------------------------

def _hidden_rows(rng, H=640):
    """fp32 rows: random, all zeros, a row whose codes clamp at +-127 (the max
    element and its negative), and a row of exact round-half-even ties at a
    power-of-two scale."""
    rows = [rng.randn(H) * 3, np.zeros(H), rng.randn(H) * 1e-3]
    clamp = rng.randn(H)
    clamp[5], clamp[300] = 4.0, -4.0
    rows.append(clamp)
    amax = np.float32(127 * 2.0 ** -3)
    s = np.float32(np.float32(max(amax, np.float32(1e-30))) * np.float32(1.0 / 127.0))
    inv = np.float32(1.0) / s
    ties = np.array([(k % 126 + 0.5) * (1 if k % 2 else -1) for k in range(H)]) / float(inv)
    ties = ties.astype(np.float32)
    ties[H // 2] = amax
    rows.append(ties)
    return np.stack(rows).astype(np.float32), inv


def test_tile_maxima_combined_then_quantized_equal_quant_rows():
    h, inv = _hidden_rows(np.random.RandomState(0))
    ties = h[-1] * inv
    assert np.sum(ties == np.round(ties)) == 1 and np.sum(np.abs(ties % 1) == 0.5) > 600
    xf = torch.from_numpy(h)
    # the epilogue: each 128-column tile's row max |h|, combined by atomicMax on
    # the int bits (non-negative floats order as their bits)
    tiles = [xf[:, j:j + 128].abs().amax(-1) for j in range(0, h.shape[1], 128)]
    bits = torch.stack([t.view(torch.int32) for t in tiles]).amax(0)
    amax = bits.view(F32)
    assert torch.equal(amax, xf.abs().amax(-1))
    # the quantizer from the given maxima: one pass over the row
    sx = torch.clamp_min(amax, 1e-30) * (1.0 / 127.0)
    q = torch.clamp(torch.round(xf * torch.reciprocal(sx)[:, None]), -127, 127)
    q_ref, s_ref = FA.quant_rows(xf)
    assert torch.equal(q, q_ref) and torch.equal(sx, s_ref[:, 0])
    assert (q[1] == 0).all() and q[3].abs().max() == 127 and q[-1].abs().max() == 127
    assert (q[-1] % 2 == 0).sum() == h.shape[1] - 1     # every tie to the even code; 127


# ---------------------------------------------------------------------------
# the constants the wrappers mirror, against csrc/gemm.cu
# ---------------------------------------------------------------------------

def _constant(text, name):
    return int(re.search(rf"constexpr int {name} = (\d+);", text).group(1))


def test_int8_tile_and_alignment_constants_mirror_gemm_cu():
    gemm = (CSRC / "gemm.cu").read_text()
    text = gemm + (CSRC / "wgmma.cuh").read_text()     # the TMA + wgmma parts gemm.cu includes
    assert '#include "wgmma.cuh"' in gemm
    assert _constant(text, "WG_BK_BYTES") == FA.GEMM_KTILE_BYTES == 128
    assert _constant(text, "TMA_ROW_ALIGN") == FA.GEMM_S8_ALIGN == 2 * FA.GEMM_ALIGN
    # one 128-byte k-tile is 128 int8 or 64 bf16 values, four 32-byte wgmma steps
    assert FA.GEMM_KTILE_BYTES // _constant(text, "WG_KSTEP_BYTES") == 4
    assert "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8" in text
    assert "CU_TENSOR_MAP_DATA_TYPE_UINT8" in text
    # one main loop: the mma.sync loop and its cp.async ring are gone
    for gone in ("mma.sync", "ldmatrix", "cp.async.cg", "gemm_kernel<"):
        assert gone not in text, gone
    rowprep = (CSRC / "rowprep.cu").read_text()
    assert "K % 16" in rowprep and "amax_in" in rowprep
