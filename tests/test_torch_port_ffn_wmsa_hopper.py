"""K7 and K8 redesigned for Hopper, on the CPU.

- K8 at its Swin sites reads the packed qkv (`wmsa_qkv`): its plain version
  against the JAX package's `_wmsa_pallas` in interpret mode on the permuted
  inputs (small and blocked bias period), and `window_attention_fused` /
  `temporal_attention_fused` against JAX's at a tiny Swin stage, through
  `wmsa_qkv` and not `wmsa`; on the card (launches recorded) one launch of
  csrc/attn.cu's core over the packed rows with the bias as (P / heads,
  heads, N, N), and a bias period that is not a multiple of the heads, or a
  head width the core does not take, raises.
- K7 on the card (launches recorded) is one `stg_ffn_bf16` launch with no
  (M, 4C) tensor made; `ffn_route` / `check_ffn` mirror csrc/ffn.cu's
  widths and refuse each operand it cannot take; the wider widths
  (`ffn_composed_route`) take K9 and gemm.cu's fc1 (erf-GELU) and fc2.
- Every preset's K7 sites at B = 8 lie on `ffn_route` and its K8 sites on
  the small core (`attn_route`), within one block's shared memory and four
  blocks an SM; at every batch up to 64 each K7 width lies on one of K7's
  two routes; `launches_per_forward` of Swin-Base and Swin-Large is what it
  was.
"""
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stgcma_tpu.ops import pallas_attn as PA
from stgcma_tpu.ops import window as jax_window
from stgcma_tpu_torch.configs import swin_base, swin_large
from stgcma_tpu_torch.nn import swin
from stgcma_tpu_torch.ops import cuda_lib
from stgcma_tpu_torch.ops import fused_attn as FA
from stgcma_tpu_torch.ops.swin_block import swin_whole_block_enabled

from test_torch_port_swin_kernels import JCFG, _block, _fused
from torch_port_helpers import clear_opt_ins, rel, t

TOL = 1e-5
BF = torch.bfloat16
FFN_CU = Path(FA.__file__).resolve().parent.parent / "csrc" / "ffn.cu"
ATTN_CU = FFN_CU.with_name("attn.cu")


# ---------------------------------------------------------------------------
# K8's plain version against the JAX package
# ---------------------------------------------------------------------------

# (B_, N, heads, dh, P): P <= 128 is `_wmsa_kernel_small_bias`; P a multiple of 128,
# with B_ * heads a multiple of P, `_wmsa_kernel_blocked_bias`
WMSA_QKV = {"small_bias": (6, 10, 2, 8, 4), "blocked_bias": (64, 7, 4, 8, 256)}


@pytest.mark.parametrize("form", sorted(WMSA_QKV))
def test_wmsa_qkv_plain_matches_jax_kernel(monkeypatch, form):
    """The packed qkv taken apart and q scaled as the port does, then JAX's
    kernel, then the heads merged: `wmsa_qkv` on the CPU to 1e-5."""
    clear_opt_ins(monkeypatch)
    rng = np.random.RandomState(3)
    B_, N, heads, dh, P = WMSA_QKV[form]
    C = heads * dh
    qkv = rng.randn(B_, N, 3 * C).astype(np.float32)
    bm = (rng.randn(P, N, N) * 2).astype(np.float32)
    q, k, v = qkv.reshape(B_, N, 3, heads, dh).transpose(2, 0, 3, 1, 4)
    q = q * np.float32(dh ** -0.5)
    rows = [jnp.asarray(np.ascontiguousarray(a).reshape(B_ * heads, N, dh)) for a in (q, k, v)]
    ref = np.asarray(PA._wmsa_pallas(*rows, jnp.asarray(bm)))
    ref = ref.reshape(B_, heads, N, dh).transpose(0, 2, 1, 3).reshape(B_, N, C)
    out = FA.wmsa_qkv(t(qkv), t(bm), heads)
    assert FA.wmsa_qkv.launches == 0 and out.shape == (B_, N, C)
    assert rel(out, ref) < TOL


@pytest.fixture
def through_wmsa_qkv(monkeypatch):
    """`wmsa` must not be reached; each `wmsa_qkv` call's qkv shape is kept."""
    seen = []
    real = FA.wmsa_qkv

    def spy(qkv, bm, heads):
        seen.append(tuple(qkv.shape))
        return real(qkv, bm, heads)

    def refuse(*args):
        raise AssertionError("the Swin sites must not reach wmsa")
    monkeypatch.setattr(FA, "wmsa_qkv", spy)
    monkeypatch.setattr(FA, "wmsa", refuse)
    return seen


def test_window_attention_fused_reads_the_packed_qkv(monkeypatch, through_wmsa_qkv):
    """W-MSA with the shift mask ((nW * heads, N, N) bias) against JAX's, the
    core taking the qkv product's (B_, N, 3C) output as it is."""
    _fused(monkeypatch)
    st, p, blk = _block()
    rng = np.random.RandomState(11)
    ws, ss = st.window_size, st.shift_size
    xw = rng.randn(2 * 4, ws * ws, st.dim).astype(np.float32)
    mask = jax_window.shift_attn_mask(st.H, st.W, ws, ss)
    rel_idx = jax_window.relative_position_index(ws)
    ref = PA.window_attention_fused(p["attn"], jnp.asarray(xw), st.num_heads,
                                    jnp.asarray(rel_idx), mask=jnp.asarray(mask))
    out = FA.window_attention_fused(blk.attn, t(xw), st.num_heads, torch.from_numpy(rel_idx),
                                    mask=t(mask))
    assert through_wmsa_qkv == [(2 * 4, ws * ws, 3 * st.dim)]
    assert rel(out, ref) < TOL


@pytest.mark.parametrize("signal", ["video", "audio"])
def test_temporal_attention_fused_reads_the_packed_qkv(monkeypatch, through_wmsa_qkv, signal):
    _fused(monkeypatch)
    st, p, blk = _block()
    x = np.random.RandomState(12).randn(6, JCFG.num_frames, st.dim).astype(np.float32)
    t_idx = jax_window.temporal_relative_index(JCFG.num_frames)
    ref = PA.temporal_attention_fused(p["attn"], jnp.asarray(x), st.num_heads,
                                      jnp.asarray(t_idx), signal=signal)
    out = FA.temporal_attention_fused(blk.attn, t(x), st.num_heads, torch.from_numpy(t_idx),
                                      signal=signal)
    assert through_wmsa_qkv == [(6, JCFG.num_frames, 3 * st.dim)]
    assert rel(out, ref) < TOL


# ---------------------------------------------------------------------------
# the card wrappers, launches recorded instead of made
# ---------------------------------------------------------------------------

class _Recorder:
    def __init__(self):
        self.calls = []

    def __call__(self, src):
        return self

    def __getattr__(self, name):
        if not name.startswith("stg_"):
            raise AttributeError(name)
        return lambda *args: self.calls.append((name, args)) or 0


@pytest.fixture
def recorder(monkeypatch):
    rec = _Recorder()
    monkeypatch.setattr(cuda_lib, "lib", rec)
    monkeypatch.setattr(FA, "_stream", lambda x: 0)
    return rec


def _empty(*shape, dtype=BF):
    return torch.empty(shape, dtype=dtype)


def _ffn_operands(M, C, H=None):
    H = 4 * C if H is None else H
    return (_empty(M, C), _empty(C), _empty(C), _empty(H, C), _empty(H), _empty(C, H),
            _empty(C))


def _misaligned(*shape):
    n = int(np.prod(shape))
    return _empty(n + 8).narrow(0, 1, n).view(*shape)


@pytest.mark.parametrize("M,C", [(250880, 128), (62720, 256), (250880, 192), (62720, 384),
                                 (141120, 128), (1, 384)])
def test_ffn_on_the_card_is_one_launch(monkeypatch, recorder, M, C):
    """K7's card wrapper: one `stg_ffn_bf16` launch at (M, C), no other, and
    no (M, 4C) tensor made."""
    made = []
    for fn in ("empty", "empty_like", "zeros"):
        real = getattr(torch, fn)

        def watching(*a, real=real, **kw):
            out = real(*a, **kw)
            made.append(tuple(out.shape))
            return out
        monkeypatch.setattr(torch, fn, watching)
    args = _ffn_operands(M, C)
    made.clear()
    out = FA._ffn_cuda(*args)
    assert [name for name, _ in recorder.calls] == ["stg_ffn_bf16"]
    assert recorder.calls[0][1][8:10] == (M, C)
    assert out.shape == (M, C) and (M, 4 * C) not in made


REFUSED_FFN = {
    "width_not_instantiated": lambda: _ffn_operands(64, 100),
    "hidden_not_4C": lambda: _ffn_operands(64, 128, H=384),
    "x_fp32": lambda: (_empty(64, 128, dtype=torch.float32),) + _ffn_operands(64, 128)[1:],
    "x_misaligned": lambda: (_misaligned(64, 128),) + _ffn_operands(64, 128)[1:],
    "w2_transposed": lambda: _ffn_operands(64, 128)[:5] + (_empty(512, 128).t(), _empty(128)),
    "b1_short": lambda: _ffn_operands(64, 128)[:4] + (_empty(256),) + _ffn_operands(64, 128)[5:],
    "no_rows": lambda: _ffn_operands(0, 128),
}


@pytest.mark.parametrize("case", sorted(REFUSED_FFN))
def test_ffn_refuses_what_ffn_cu_cannot_take(recorder, case):
    """A shape or operand outside `check_ffn`'s limits, and off the
    composition's widths, raises before any launch."""
    with pytest.raises(ValueError):
        FA._ffn_cuda(*REFUSED_FFN[case]())
    assert recorder.calls == []


@pytest.mark.parametrize("C", [96, 512, 768])
def test_check_ffn_refuses_widths_ffn_cu_does_not_instantiate(C):
    with pytest.raises(ValueError, match="C in"):
        FA.check_ffn(*_ffn_operands(64, C))


# (M, C) where `ffn_kernel_route` first sends a width csrc/ffn.cu does not take to K7:
# Swin-Large stage 2 at B = 9, stage 3 at B = 17; Swin-Base stage 2 at B = 13, stage 3
# at B = 26 (T = 10 frames of 14^2 or 7^2 tokens)
COMPOSED_FFN = [(17640, 768), (8330, 1536), (25480, 512), (12740, 1024)]


@pytest.mark.parametrize("M,C", COMPOSED_FFN)
def test_ffn_wider_widths_take_the_composition(recorder, M, C):
    """K7 at a width outside FFN_WIDTHS: K9's LayerNorm, fc1 with the
    erf-GELU epilogue into a bf16 (M, 4C) hidden, fc2 with the bias only."""
    assert FA.ffn_composed_route(C, 4 * C) and not FA.ffn_route(C, 4 * C)
    out = FA._ffn_cuda(*_ffn_operands(M, C))
    assert [name for name, _ in recorder.calls] == ["stg_ln_bf16", "stg_gemm_bf16",
                                                     "stg_gemm_bf16"]
    fc1, fc2 = recorder.calls[1][1], recorder.calls[2][1]
    assert fc1[4:8] == (M, 4 * C, C, FA._EPI_BF16_GELU)
    assert fc2[4:8] == (M, C, 4 * C, FA._EPI_BF16) and fc2[0] == fc1[3]
    assert out.shape == (M, C)


def test_ffn_route_mirrors_ffn_cu():
    """The widths and the hidden step that `ffn_route` and FFN_HIDDEN_CHUNK
    mirror are the ones csrc/ffn.cu instantiates."""
    text = FFN_CU.read_text()
    widths = tuple(int(c) for c in re.findall(r"case (\d+): return launch<\1>", text))
    assert widths == FA.FFN_WIDTHS
    assert int(re.search(r"constexpr int HC = (\d+);", text).group(1)) == FA.FFN_HIDDEN_CHUNK
    assert all(FA.ffn_route(C, 4 * C) for C in FA.FFN_WIDTHS)
    assert not FA.ffn_route(128, 256) and not FA.ffn_route(512, 2048)
    assert not any(FA.ffn_composed_route(C, 4 * C) for C in FA.FFN_WIDTHS)
    assert not FA.ffn_composed_route(512, 1024) and not FA.ffn_composed_route(100, 400)


def test_wmsa_qkv_on_the_card_is_one_core_launch(recorder):
    """K8's site: one `stg_attn_core` over the packed qkv, the (P, N, N) bias
    passed as P / heads rows of (heads, N, N), output merged heads."""
    B_, N, heads, dh, P = 2560, 49, 32, 32, 32
    qkv, bm = _empty(B_, N, 3 * heads * dh), _empty(P, N, N, dtype=torch.float32)
    out = FA._wmsa_qkv_cuda(qkv, bm, heads)
    assert [name for name, _ in recorder.calls] == ["stg_attn_core"]
    args = recorder.calls[0][1]
    assert args[0] == qkv.data_ptr() and args[1] == bm.data_ptr()
    assert args[2] == P // heads and args[4:8] == (B_, N, heads, dh)
    assert out.shape == (B_, N, heads * dh)


REFUSED_WMSA = {
    "period_not_a_multiple_of_heads": (8, 10, 4, 32, 6),
    "period_not_dividing_the_rows": (3, 10, 4, 32, 8),
    "head_width_16": (8, 10, 4, 16, 4),
    "head_width_48": (8, 10, 4, 48, 4),
}


@pytest.mark.parametrize("case", sorted(REFUSED_WMSA))
def test_wmsa_qkv_refuses_what_the_core_cannot_take(recorder, case):
    B_, N, heads, dh, P = REFUSED_WMSA[case]
    qkv, bm = _empty(B_, N, 3 * heads * dh), _empty(P, N, N, dtype=torch.float32)
    with pytest.raises(ValueError):
        FA._wmsa_qkv_cuda(qkv, bm, heads)
    assert recorder.calls == []


# ---------------------------------------------------------------------------
# every preset's K7 and K8 sites
# ---------------------------------------------------------------------------

SWIN = [(f"{name}_{mode}", preset, mode) for name, preset in (("swin_base", swin_base),
                                                               ("swin_large", swin_large))
        for mode in ("fusion", "multimodal")]


def _sites(cfg, B=8):
    """(K7 widths, K8 (tokens, dh)) of one bf16 forward, by the routes `_ffn`
    and the attention branches take."""
    ffn, k8 = set(), set()
    rows = B * cfg.num_ttokens
    for stage in swin.backbone_statics(cfg):
        for st in stage:
            dh, k8_route = st.dim // st.num_heads, not FA.block_kernel_route(st.num_heads)
            if k8_route and st.t_attn:
                k8.add((st.num_frames, dh))
            if st.mode == "fusion_adapt" and swin_whole_block_enabled(st):
                continue
            if FA.ffn_kernel_route(rows * st.H * st.W, 4 * st.dim, 2):
                ffn.add(st.dim)
            if k8_route:
                k8.add((st.window_size ** 2, dh))
    return ffn, k8


@pytest.mark.parametrize("name,preset,ftmode", SWIN, ids=[s[0] for s in SWIN])
def test_presets_k7_and_k8_sites_lie_within_the_kernels_limits(monkeypatch, name, preset,
                                                               ftmode):
    """Each K7 width takes `ffn_route` (hidden 4C) and each K8 site the small
    core, whose two stages fit one block's shared memory four times an SM."""
    clear_opt_ins(monkeypatch)
    ffn, k8 = _sites(preset(ftmode=ftmode, label_dim=29))
    assert ffn and k8
    for C in ffn:
        assert FA.ffn_route(C, 4 * C), (name, C)
    for n, dh in k8:
        route, smem = FA.attn_route(n, dh)
        assert route == "small" and 4 * smem <= FA.SMEM_MAX_BYTES, (name, n, dh, route, smem)
    assert ffn == ({192, 384} if name.startswith("swin_large") else {128, 256})
    # in fusion mode the 32-head windows lie in K4, and K8 runs at the temporal sites only
    assert k8 == ({(10, 32)} if ftmode == "fusion" else {(10, 32), (49, 32)})


# the smallest batch at which each K7 width is reached (`ffn_kernel_route`: the
# hidden >= 96 MiB); in fusion mode stages 2-3 lie in K4
K7_FIRST_BATCH = {
    "swin_base_fusion": {128: 4, 256: 7},
    "swin_base_multimodal": {128: 4, 256: 7, 512: 13, 1024: 26},
    "swin_large_fusion": {192: 3, 384: 5},
    "swin_large_multimodal": {192: 3, 384: 5, 768: 9, 1536: 17},
}


@pytest.mark.parametrize("name,preset,ftmode", SWIN, ids=[s[0] for s in SWIN])
def test_presets_k7_widths_at_every_batch_take_a_hand_written_route(monkeypatch, name,
                                                                    preset, ftmode):
    """At every batch up to 64 each K7 width lies on csrc/ffn.cu's route or,
    outside FFN_WIDTHS, on the composition's: none raises."""
    clear_opt_ins(monkeypatch)
    cfg = preset(ftmode=ftmode, label_dim=29)
    first = {}
    for B in range(1, 65):
        for C in _sites(cfg, B)[0]:
            first.setdefault(C, B)
            assert FA.ffn_route(C, 4 * C) == (C in FA.FFN_WIDTHS), (name, B, C)
            assert FA.ffn_route(C, 4 * C) or FA.ffn_composed_route(C, 4 * C), (name, B, C)
    assert first == K7_FIRST_BATCH[name]


def test_small_core_smem_mirrors_attn_cu():
    """`attn_route`'s small-core bytes are attn.cu's two stages of Q, K and V
    of 4 / KT pairs at row stride dh + 8, whatever KT is."""
    text = ATTN_CU.read_text()
    assert int(re.search(r"constexpr int kSmallStages = (\d+);", text).group(1)) == \
        FA.ATTN_SMALL_STAGES
    assert "static constexpr int PAIRS = kWarps / KT;" in text
    for dh in FA.ATTN_HEAD_WIDTHS:
        sizes = {FA.attn_route(n, dh)[1] for n in range(1, FA.ATTN_SMALL_MAX_TOKENS + 1)}
        assert sizes == {FA.ATTN_SMALL_STAGES * 192 * (dh + 8) * 2}


LAUNCHES = {
    "swin_base_fusion": {"K1": 30, "K7": 8, "K8": 2, "K9": 12, "K4": 20, "K5": 4, "K6": 4},
    "swin_base_multimodal": {"K1": 66, "K7": 8, "K8": 6, "K9": 12},
    "swin_large_fusion": {"K1": 12, "K7": 8, "K8": 20, "K9": 30, "K4": 20, "K5": 4, "K6": 4},
    "swin_large_multimodal": {"K1": 12, "K7": 8, "K8": 60, "K9": 30},
}


@pytest.mark.parametrize("name,preset,ftmode", SWIN, ids=[s[0] for s in SWIN])
def test_launches_per_forward_unchanged(monkeypatch, name, preset, ftmode):
    """One K7 an FFN site and one K8 a site, as before the redesign (B = 8)."""
    clear_opt_ins(monkeypatch)
    assert swin.launches_per_forward(preset(ftmode=ftmode, label_dim=29), B=8) == LAUNCHES[name]
