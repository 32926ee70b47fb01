"""K13's and K11's redesign for Hopper on the CPU: csrc/tattn.cu's temporal
product T (the qkv product with each sequence's attention in its epilogue)
and csrc/rowadapt.cu's row-owning product R (the last tower product with the
adapter's down product, and K13's up product with the residual, on the same
rows), and the fusion kernel's batch limit (F4).

- (a) A CPU model of T's tile walk: 128-row tiles stepping by whole
  sequences (floor(128 / T) T rows), one head's q, k and v columns read as
  three slabs of W_qkv at row offsets h dh, C + h dh and 2C + h dh (the TMA
  boxes), each band of 16 query rows attending over the keys of its own
  sequence within the 48 rows from 16 before the band, rows past the tile's
  last whole sequence masked. In fp32 it equals the attention output of
  `tadapt_plain` (`_heads_attention` of the same qkv) to 1e-6 of max |plain|
  (only the order of fp32 sums differs), for T in {1, 4, 10, 16} at head
  widths 32 and 64, with a row count that is not a multiple of a tile's
  sequences; every output row is written exactly once.
- (b) `tattn_route`, `rowadapt_route` and the constants they and the
  wrappers use are csrc/tattn.cu's and csrc/rowadapt.cu's own (read by
  regex, as `test_attn_route_mirrors_attn_cu` reads attn.cu), and both
  kernels' shared memory fits: T one block an SM, R two of 64 rows or one
  of 128.
- (c) Under the recorder of tests/test_torch_port_hopper_limits.py (CUDA
  launches recorded, not made), every K13 and K11 composition at CLIP-B/16
  and CLIP-L/14 widths (T = 10, dh = 64) issues exactly the launches of its
  redesign (K13 3 float, 4 int8; K11 qd 4, qh 5, ffn_qh 4), T and R among
  them, each after its `check_*` passed; a shape the routes send elsewhere
  (T = 20 frames, an adapter width R does not take) keeps the earlier
  composition, explicitly.
- (d) F4: the fusion at a Swin-Base `fusion` request of 128 clips (81,920
  stage-0 windows, past the old 65,535 cap) passes the wrappers' checks and
  is launched with its full batch.

No numbers of the card are compared here: the plain versions and their JAX
parity are held by tests/test_torch_port_clip_block_kernels.py and
tests/test_torch_port_qfuse.py; the kernels against them on the card by
chip_smoke.py.
"""
import re
from pathlib import Path

import numpy as np
import pytest
import torch

import torch_port_helpers  # noqa: F401  (torch at two threads a worker)
from stgcma_tpu_torch.configs import clip_b16, clip_l14
from stgcma_tpu_torch.ops import clip_block as PCB
from stgcma_tpu_torch.ops import cuda_lib
from stgcma_tpu_torch.ops import fused_attn as FA
from stgcma_tpu_torch.ops import quant as Q
from stgcma_tpu_torch.ops import swin_block as SB

from test_torch_port_hopper_limits import (_Recorder, _empty, _ffn_q_args, _k1_args,
                                           _tadapt_w)

CSRC = Path(FA.__file__).resolve().parent.parent / "csrc"


# ---------------------------------------------------------------------------
# (a) the temporal product's tile walk
# ---------------------------------------------------------------------------

def tattn_model(xn, w_qkv, b_qkv, T, heads, dt=torch.float32):
    """csrc/tattn.cu's walk in torch: tiles of TATTN_TILE_ROWS rows stepping
    by whole sequences, head slabs by row offset, 16-row query bands over a
    three-key-tile window masked to each row's own sequence. Returns the
    merged heads (M, C); rows it never writes stay NaN."""
    M, C = xn.shape
    dh, BM = C // heads, FA.TATTN_TILE_ROWS
    step = (BM // T) * T
    scale = torch.tensor(dh ** -0.5, dtype=dt)
    out = torch.full((M, C), float("nan"), dtype=dt)
    for m0 in range(0, M, step):
        rows = xn[m0:m0 + BM]                       # the TMA box; past M: zero fill
        rows = torch.cat([rows, rows.new_zeros(BM - rows.shape[0], C)])
        valid = min(step, M - m0)
        for h in range(heads):
            slabs = [w_qkv[j * C + h * dh:j * C + (h + 1) * dh] for j in range(3)]
            bias = [b_qkv[j * C + h * dh:j * C + (h + 1) * dh] for j in range(3)]
            q, k, v = ((rows.float() @ s.float().t() + b.float()).to(dt)
                       for s, b in zip(slabs, bias))
            q = q * scale
            for band in range(0, BM, 16):
                if band >= valid:
                    continue
                keys = torch.arange(band - 16, band + 32)
                inside = (keys >= 0) & (keys < valid)
                r = torch.arange(band, band + 16)
                lo = (r // T) * T
                hi = torch.clamp(lo + T, max=valid)
                mask = inside & (keys[None] >= lo[:, None]) & (keys[None] < hi[:, None])
                kk = keys.clamp(0, BM - 1)
                logits = q[band:band + 16].float() @ k[kk].float().t()
                logits = logits.masked_fill(~mask, float("-inf"))
                e = torch.exp(logits - logits.amax(-1, keepdim=True))
                p = (e / e.sum(-1, keepdim=True)).to(dt)
                o = (p.float() @ v[kk].float()).to(dt)
                n = min(16, valid - band)
                out[m0 + band:m0 + band + n, h * dh:(h + 1) * dh] = o[:n]
    return out


@pytest.mark.parametrize("dh", (32, 64))
@pytest.mark.parametrize("T", (1, 4, 10, 16))
def test_tattn_tile_walk_equals_the_plain_attention(T, dh):
    rng = np.random.RandomState(T * 100 + dh)
    heads = 2
    C = heads * dh
    per_tile = FA.TATTN_TILE_ROWS // T
    R = 2 * per_tile + 3                         # not a multiple of a tile's sequences
    assert R % per_tile
    xn = torch.from_numpy(rng.randn(R * T, C).astype(np.float32))
    w_qkv = torch.from_numpy((rng.randn(3 * C, C) / C ** 0.5).astype(np.float32))
    b_qkv = torch.from_numpy((rng.randn(3 * C) * 0.1).astype(np.float32))
    got = tattn_model(xn, w_qkv, b_qkv, T, heads)
    assert not torch.isnan(got).any(), "a row of the merged heads was never written"
    # tadapt_plain's attention: the qkv of the rows, then `_heads_attention` over
    # each sequence's T frames
    qkv = (xn @ w_qkv.t() + b_qkv).view(R, T, 3 * C)
    ref = FA._heads_attention(qkv, heads, None, torch.float32).reshape(R * T, C)
    err = (got - ref).abs().max() / ref.abs().max()
    assert err <= 1e-6, float(err)


def test_tattn_tile_walk_sees_a_head_or_sequence_miswired():
    """The model's equality is not blind: taking k and v from the next
    head's slabs, or attending across two sequences, moves the output."""
    rng = np.random.RandomState(7)
    T, heads, dh = 10, 2, 32
    C, R = heads * dh, 25
    xn = torch.from_numpy(rng.randn(R * T, C).astype(np.float32))
    w = torch.from_numpy((rng.randn(3 * C, C) / C ** 0.5).astype(np.float32))
    b = torch.from_numpy((rng.randn(3 * C) * 0.1).astype(np.float32))
    ref = tattn_model(xn, w, b, T, heads)
    rolled = torch.cat([w[:C], w[C:2 * C].roll(-dh, 0), w[2 * C:].roll(-dh, 0)])
    assert (tattn_model(xn, rolled, b, T, heads) - ref).abs().max() > 0.1 * ref.abs().max()
    # sequences of 20 frames: each row also sees its neighbour sequence
    assert (tattn_model(xn, w, b, 2 * T, heads) - ref).abs().max() > 0.1 * ref.abs().max()


# ---------------------------------------------------------------------------
# (b) the routes and limits against the sources
# ---------------------------------------------------------------------------

def _constant(text, name):
    return int(re.search(rf"constexpr int {name} = (\d+);", text).group(1))


def test_tattn_route_mirrors_tattn_cu():
    text = (CSRC / "tattn.cu").read_text()
    assert _constant(text, "TATTN_BM") == FA.TATTN_TILE_ROWS
    assert _constant(text, "TATTN_MAX_FRAMES") == FA.TATTN_MAX_FRAMES == PCB.TADAPT_MAX_FRAMES
    widths = tuple(sorted(int(d) for d in re.findall(
        r"if \(C / heads == (\d+)\) return launch<Op, \d+>", text)))
    assert widths == FA.TATTN_HEAD_WIDTHS
    # three dh-row boxes of W_qkv at rows j C + h dh, one m64 x n(3 dh) product
    assert "tma_load(st + L::A_BYTES + j * L::SLAB_BYTES, &tm_w, kt * BK, j * C + h * DH," in text
    assert "static constexpr int N = 3 * DH;" in text
    assert "const int step = (TATTN_BM / T) * T;" in text
    assert "const int kbase = KT == 3 ? band - 16 : 0;" in text
    route = {(T, dh): FA.tattn_route(T, dh) for T in range(0, 20) for dh in (16, 32, 48, 64, 128)}
    assert {k for k, v in route.items() if v} == {(T, dh) for T in range(1, 17) for dh in (32, 64)}


@pytest.mark.parametrize("dh", FA.TATTN_HEAD_WIDTHS)
def test_tattn_shared_memory_fits_one_block(dh):
    """csrc/tattn.cu's TTile: the ring of TATTN_STAGES stages (128 rows of A
    and the three slabs), the staged tile at stride 3 dh + 8, the mbarriers
    and the alignment slack, within one block's shared memory."""
    text = (CSRC / "tattn.cu").read_text()
    stages, bk = _constant(text, "TATTN_STAGES"), FA.GEMM_KTILE_BYTES
    smem = (stages * (FA.TATTN_TILE_ROWS * bk + 3 * dh * bk) + FA.TATTN_TILE_ROWS * (3 * dh + 8) * 2
            + 2 * stages * 8 + 1024)
    assert "static constexpr int LDQ = N + 8;" in text
    assert smem <= FA.SMEM_MAX_BYTES, smem


def test_rowadapt_route_mirrors_rowadapt_cu():
    text = (CSRC / "rowadapt.cu").read_text()
    assert _constant(text, "RA_BM") == FA.ROWADAPT_ROWS
    assert _constant(text, "RA_ALIGN") == FA.ROWADAPT_ALIGN
    widths = tuple(int(d) for d in re.findall(r"if \(D == (\d+)\) return launch_d<Op, \d+>",
                                              text))
    assert widths == FA.ROWADAPT_WIDTHS
    # the down epilogues are gemm.cu's numbering: plain, erf-GELU, erf-GELU of the rounded sum
    assert "DOWN_BF16 = 0, DOWN_GELU = 4, DOWN_RGELU = 5" in text
    assert (FA._EPI_BF16, FA._EPI_BF16_GELU, FA._EPI_BF16_RGELU) == (0, 4, 5)
    assert FA.rowadapt_route(768, 48) and FA.rowadapt_route(1024, 64)
    assert not FA.rowadapt_route(784, 48) and not FA.rowadapt_route(768, 40)


@pytest.mark.parametrize("wgs", (1, 2))
@pytest.mark.parametrize("D", FA.ROWADAPT_WIDTHS)
def test_rowadapt_shared_memory_fits_its_blocks(D, wgs):
    """csrc/rowadapt.cu's RTile at every width, for blocks of one warpgroup
    (64 rows, two blocks an SM: each block's share of the SM's 228 KB less the
    1 KB the card reserves a block) and of two (128 rows, one block): the ring
    (4 stages to D = 48 and 3 past it, or 6) of the block's rows of A and a
    128-column chunk of W, the chunk's wd rows at stride 136 and its bias and
    scales, the mbarriers and the slack; and the hidden, w2's rows and the up
    product's output block (fp32) fit the region they reuse."""
    text = (CSRC / "rowadapt.cu").read_text()
    assert "static constexpr int STAGES = WGS == 2 ? 6 : D <= 48 ? 4 : 3;" in text
    assert "return ceil_div(M, 2 * RA_BM) >= sms * 3 / 4 ? 2 * RA_BM : RA_BM;" in text
    rows, chunk, bk = FA.ROWADAPT_ROWS * wgs, 128, FA.GEMM_KTILE_BYTES
    stages = 6 if wgs == 2 else 4 if D <= 48 else 3
    free = stages * (rows + chunk) * bk + D * (chunk + 8) * 2 + 2 * chunk * 2
    smem = free + 2 * stages * 8 + 1024
    assert smem <= (233472 // 2 - 1024 if wgs == 1 else FA.SMEM_MAX_BYTES), smem
    assert "static constexpr int YS_BYTES = BM * (RA_YB + 8) * 4;    // room for fp32" in text
    w2_rows = (free - rows * (D + 8) * 2 - rows * 72 * 4) // ((D + 8) * 2)
    assert w2_rows // FA.ROWADAPT_ALIGN * FA.ROWADAPT_ALIGN >= FA.ROWADAPT_ALIGN


# ---------------------------------------------------------------------------
# (c) the K13 and K11 compositions, launches recorded
# ---------------------------------------------------------------------------

@pytest.fixture
def recorder(monkeypatch):
    rec = _Recorder()
    monkeypatch.setattr(cuda_lib, "lib", rec)
    for mod in (FA, PCB, SB, Q):
        monkeypatch.setattr(mod, "_stream", lambda x: 0)
    rec.checked = []
    for name in ("check_tattn", "check_rowadapt"):
        real = getattr(FA, name)

        def checked(*args, _real=real, _name=name, **kw):
            _real(*args, **kw)
            rec.checked.append(_name)
        monkeypatch.setattr(FA, name, checked)
    return rec


def _site(cfg):
    C, heads, T = cfg.embed_dim, cfg.heads, cfg.num_frames
    return C, heads, T, int(C * cfg.adapter_ratio), cfg.num_patches + 1


def _compose(kind, cfg):
    """One call of the card composition at B = 1 of `cfg`'s widths."""
    C, heads, T, D, Nv = _site(cfg)
    ad = (_empty(D, C), _empty(D))
    if kind == "K13":
        return PCB._tadapt_cuda(_empty(Nv, T, C), _tadapt_w(C, D, False), heads)
    if kind == "K13_int8":
        return PCB._tadapt_cuda(_empty(Nv, T, C), _tadapt_w(C, D, True), heads, quantized=True)
    if kind == "K11_qd":
        return FA._win_block_qad_cuda(_empty(Nv, T, C), *_k1_args(C, True), *ad, heads,
                                      emit_o=False)
    if kind == "K11_qh":
        return FA._win_block_qad_cuda(_empty(T, Nv, C), *_k1_args(C, True), *ad, heads,
                                      emit_o=True)
    return FA._ffn_qh_cuda(_empty(T * Nv, C), *_ffn_q_args(C), *ad, "quick_gelu")


LAUNCHES = {
    "K13": ["stg_ln_bf16", "stg_tattn_bf16", "stg_rowadapt_bf16"],
    "K13_int8": ["stg_ln_quant_rows_bf16", "stg_tattn_s8", "stg_quant_rows", "stg_rowadapt_s8"],
    "K11_qd": ["stg_quant_rows", "stg_tattn_s8", "stg_quant_rows", "stg_rowadapt_s8"],
    "K11_qh": ["stg_quant_rows", "stg_gemm_s8", "stg_attn_core", "stg_quant_rows",
               "stg_rowadapt_s8"],
    "K11_ffn_qh": ["stg_quant_rows", "stg_gemm_s8", "stg_quant_rows", "stg_rowadapt_s8"],
}
PRESETS = {"clip_b16": clip_b16, "clip_l14": clip_l14}


@pytest.mark.parametrize("preset", sorted(PRESETS))
@pytest.mark.parametrize("kind", sorted(LAUNCHES))
def test_compositions_make_the_redesigned_launches(recorder, kind, preset):
    cfg = PRESETS[preset](ftmode="fusion", label_dim=29)
    C, heads, T, D, _ = _site(cfg)
    assert FA.tattn_route(T, C // heads) and FA.rowadapt_route(C, D)    # every preset's site
    _compose(kind, cfg)
    names = [fn for fn, _ in recorder.calls]
    assert names == LAUNCHES[kind], names
    # each T and R launch after its check passed
    assert recorder.checked == [("check_tattn" if n.startswith("stg_tattn") else "check_rowadapt")
                                for n in names if n.startswith(("stg_tattn", "stg_rowadapt"))]
    for fn, args in recorder.calls:
        if fn.startswith("stg_tattn"):
            M, Cl, Tl, h = args[4:8] if fn.endswith("bf16") else args[6:10]
            assert (Cl, Tl, h) == (C, T, heads) and M % T == 0
        if fn.startswith("stg_rowadapt"):
            M, N, K, Dl, epi = args[11:16] if fn.endswith("bf16") else args[13:18]
            assert N == C and Dl == D and K in (C, 4 * C)
            k13 = kind.startswith("K13")
            assert epi == (FA._EPI_BF16_RGELU if k13 else FA._EPI_BF16_GELU)
            up, h = (args[7], args[6]) if fn.endswith("bf16") else (args[9], args[8])
            assert (up is not None) == k13 and (h is None) == k13     # K13: y only; K11: h


ELSEWHERE = {
    # 20 frames: past the temporal product's route, K13 keeps its six launches
    "K13_T20": (lambda: PCB._tadapt_cuda(_empty(16, 20, 128), _tadapt_w(128, 16, False), 2),
                ["stg_ln_bf16", "stg_gemm_bf16", "stg_attn_core", "stg_gemm_bf16",
                 "stg_gemm_bf16", "stg_gemm_bf16_res"]),
    # adapter width 40: not one R instantiates, K11 keeps K2's launches + the product
    "K11_qd_D40": (lambda: FA._win_block_qad_cuda(_empty(16, 10, 128), *_k1_args(128, True),
                                                  _empty(40, 128), _empty(40), 2,
                                                  emit_o=False),
                   ["stg_quant_rows", "stg_gemm_s8", "stg_attn_core", "stg_quant_rows",
                    "stg_gemm_s8", "stg_gemm_bf16"]),
}


@pytest.mark.parametrize("case", sorted(ELSEWHERE))
def test_shapes_off_the_routes_keep_the_earlier_composition(recorder, case):
    compose, want = ELSEWHERE[case]
    compose()
    assert [fn for fn, _ in recorder.calls] == want
    assert not recorder.checked


def test_the_temporal_product_refuses_what_it_cannot_take(recorder):
    """`check_tattn`: T past the route, rows not a multiple of T, a width it
    does not instantiate; nothing is launched."""
    w, b = _empty(384, 128), _empty(384)
    for a, out, T, heads in ((_empty(40, 128), _empty(40, 128), 20, 2),
                             (_empty(45, 128), _empty(45, 128), 10, 2),
                             (_empty(40, 128), _empty(40, 128), 10, 1)):
        with pytest.raises(ValueError):
            FA._tattn(a, None, w, None, b, out, T, heads, 0)
    FA.check_tattn(_empty(40, 128), None, w, None, b, _empty(40, 128), 10, 2)
    assert not recorder.calls


# ---------------------------------------------------------------------------
# (d) F4: the fusion's batch at 128 clips
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("stage,D", ((0, 16), (1, 32)))
def test_f4_swin_base_fusion_at_128_clips_passes_the_checks(recorder, stage, D):
    """Swin-Base `fusion` windowed stages at 128 clips of 10 frames: K5 over
    BT * nW sequences of 49 tokens (stage 0: 81,920 windows, past the 65,535
    the kernel used to refuse). The wrapper launches with the whole batch."""
    windows = 128 * 10 * (64 if stage == 0 else 16)
    vh, ah = _empty(windows, 49, D), _empty(windows, 49, D)
    FA._fuse_cuda(vh, ah, _empty(1), _empty(1))
    (fn, args), = recorder.calls
    assert fn == "stg_fuse_bidir" and args[7:11] == (windows, 49, 49, D)


def test_f4_unscaled_attention_takes_any_batch():
    FA.check_unscaled_attn(81920, 49, 49, 16, 16)
    with pytest.raises(ValueError):
        FA.check_unscaled_attn(0, 49, 49, 16, 16)
    text = (CSRC / "fuse.cu").read_text()
    assert "65535" not in text and "FUSE_MAX_BATCH" not in FA.__dict__
    assert "windows > 0x7fffffffLL" in text and "if (b0 + b1 > 0x7fffffffLL)" in text
