"""The Swin pieces of the port against the JAX package, at tiny sizes on the CPU.

- The plain versions of K7 (`ffn`), K8 (`wmsa`, small and blocked bias) and
  K9 (`layernorm`) of stgcma_tpu_torch/ops/fused_attn.py against the JAX
  package's Pallas kernels in interpret mode (`_ffn_pallas`, `_wmsa_pallas`,
  `_ln_pallas`), and the Swin entry points (`window_block_megakernel` = K1
  with a shifted-window bias of period nW, `temporal_block_megakernel`,
  `window_attention_fused`, `temporal_attention_fused`, `layernorm_fused`,
  `ffn_megakernel`) against the JAX ones with STGCMA_FUSED_ATTN=1. The JAX
  side pads the 49-token windows to 64 and packs two into one gram, and packs
  8 temporal rows; the port does neither.
- ops/window.py against the JAX one, bit for bit.
- The plain XLA-path attention ops and conv3d.

Tolerances (max abs error over max |ref|), all in fp32: 1e-5 where the math
is the same and only the summation order of the products differs (~1e-7
relative per sum; the JAX FFN kernel's A&S erf polynomial differs from
torch.erf by < 2e-7 absolute); 0 (bit-exact) for the window geometry.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from stgcma_tpu.configs import swin_tiny_test as jax_swin_tiny_test
from stgcma_tpu.nn import swin as jax_swin
from stgcma_tpu.ops import attention as jax_attention
from stgcma_tpu.ops import conv as jax_conv
from stgcma_tpu.ops import pallas_attn as PA
from stgcma_tpu.ops import window as jax_window
from stgcma_tpu_torch.checkpoint.convert import params_from_jax
from stgcma_tpu_torch.configs import swin_tiny_test
from stgcma_tpu_torch.nn import swin
from stgcma_tpu_torch.ops import attention, conv, fused_attn as FA, window

from torch_port_helpers import clear_opt_ins, jax_lin, jax_ln, rel, t, to_numpy_tree

TOL = 1e-5


# ---------------------------------------------------------------------------
# K7, K8, K9 plain versions against the Pallas kernels
# ---------------------------------------------------------------------------

def test_ffn_plain_matches_jax_kernel(monkeypatch):
    clear_opt_ins(monkeypatch)
    rng = np.random.RandomState(1)
    M, C, H = 48, 32, 128
    ln, fc1, fc2 = jax_ln(rng, C), jax_lin(rng, C, H, s=0.3), jax_lin(rng, H, C, s=0.1)
    x = rng.randn(M, C).astype(np.float32)
    ref = PA._ffn_pallas(jnp.asarray(x), ln["scale"], ln["bias"], fc1["kernel"], fc1["bias"],
                         fc2["kernel"], fc2["bias"], "gelu")
    sd = params_from_jax({"fc1": to_numpy_tree(fc1), "fc2": to_numpy_tree(fc2),
                          "ln": to_numpy_tree(ln)})
    out = FA.ffn(t(x), sd["ln.weight"], sd["ln.bias"], sd["fc1.weight"], sd["fc1.bias"],
                 sd["fc2.weight"], sd["fc2.bias"])
    assert FA.ffn.launches == 0
    assert out.shape == (M, C)
    assert rel(out, ref) < TOL


# (R, N, dh, P): P <= 128 is `_wmsa_kernel_small_bias`, P a multiple of 128
# (with R a multiple of P) is `_wmsa_kernel_blocked_bias` (pallas_attn.py:278)
WMSA = {"small_bias": (24, 10, 8, 6), "blocked_bias": (512, 7, 4, 256)}


@pytest.mark.parametrize("form", sorted(WMSA))
def test_wmsa_plain_matches_jax_kernel(monkeypatch, form):
    clear_opt_ins(monkeypatch)
    rng = np.random.RandomState(2)
    R, N, dh, P = WMSA[form]
    q, k, v = (rng.randn(R, N, dh).astype(np.float32) for _ in range(3))
    bm = (rng.randn(P, N, N) * 2).astype(np.float32)
    ref = PA._wmsa_pallas(*(jnp.asarray(a) for a in (q, k, v, bm)))
    out = FA.wmsa(t(q), t(k), t(v), t(bm))
    assert FA.wmsa.launches == 0
    assert rel(out, ref) < TOL


@pytest.mark.parametrize("C", [128, 200])
def test_layernorm_plain_matches_jax_kernel(monkeypatch, C):
    clear_opt_ins(monkeypatch)
    rng = np.random.RandomState(3)
    ln = jax_ln(rng, C)
    x = (rng.randn(40, C) * 3 + 1).astype(np.float32)
    ref = PA._ln_pallas(jnp.asarray(x), ln["scale"], ln["bias"], 1e-5)
    sd = params_from_jax(to_numpy_tree(ln))
    out = FA.layernorm(t(x), sd["weight"], sd["bias"])
    assert FA.layernorm.launches == 0
    assert rel(out, ref) < TOL


# ---------------------------------------------------------------------------
# the Swin entry points against the JAX ones (fused, interpret mode)
# ---------------------------------------------------------------------------

JCFG = jax_swin_tiny_test(ftmode="multimodal", embed_dim=64, depths=(2,), num_heads=(2,),
                          img_size=56, num_frames=4, adapter_ratios=(0.25,))


def _block(seed=4):
    """A stage-0 block of shifted geometry (14x14 grid, window 7, shift 3,
    nW = 4), JAX params with random non-trivial leaves, and the port's
    SwinBlock holding the same weights."""
    st = jax_swin.make_block_static(JCFG, 0, 1, "multimodal_adapt_no_fusion")
    st_t = jax_swin.make_block_static(JCFG, 0, 0, "multimodal_adapt_no_fusion")
    p = jax_swin.block_init(jax.random.PRNGKey(0), st_t)
    keys = iter(jax.random.split(jax.random.PRNGKey(seed), 512))
    p = jax.tree_util.tree_map(
        lambda a: jax.random.normal(next(keys), a.shape, jnp.float32) * 0.1, p)
    for k in ("relative_position_bias_table", "temporal_position_bias_table",
              "temporal_position_bias_table_audio"):
        p["attn"][k] = p["attn"][k] * 10.0
    p["norm1"]["scale"] = p["norm1"]["scale"] + 1.0
    p["norm2"]["scale"] = p["norm2"]["scale"] + 1.0
    blk = swin.SwinBlock(swin.make_block_static(swin_tiny_test(
        ftmode="multimodal", embed_dim=64, depths=(2,), num_heads=(2,), num_frames=4,
        adapter_ratios=(0.25,)), 0, 0, "multimodal_adapt_no_fusion"))
    blk.load_state_dict(params_from_jax(to_numpy_tree(p)), strict=True)
    return st, p, blk


def _fused(monkeypatch):
    clear_opt_ins(monkeypatch)
    monkeypatch.setenv("STGCMA_FUSED_ATTN", "1")


@pytest.mark.parametrize("shifted", [True, False])
def test_window_block_megakernel_matches_jax(monkeypatch, shifted):
    """K1 with the gathered bias plus the shift mask, (nW, h, N, N) of
    period nW along the windows (the JAX side pads 49 -> 64 and packs 2)."""
    _fused(monkeypatch)
    st, p, blk = _block()
    rng = np.random.RandomState(5)
    BT, C = 2, st.dim
    x = rng.randn(BT, st.H, st.W, C).astype(np.float32)
    ws, ss = st.window_size, st.shift_size if shifted else 0
    mask = jax_window.shift_attn_mask(st.H, st.W, ws, ss) if ss else None
    xr = np.roll(x, (-ss, -ss), axis=(1, 2))
    xw = np.asarray(jax_window.window_partition(jnp.asarray(xr), ws))
    rel_idx = jax_window.relative_position_index(ws)
    ref = PA.window_block_megakernel(p["attn"], p["norm1"], jnp.asarray(xw), st.num_heads,
                                     jnp.asarray(rel_idx),
                                     mask=None if mask is None else jnp.asarray(mask))
    out = FA.window_block_megakernel(blk.attn, blk.norm1, t(xw), st.num_heads,
                                     torch.from_numpy(rel_idx),
                                     mask=None if mask is None else t(mask))
    assert out.shape == xw.shape
    assert rel(out, ref) < TOL


@pytest.mark.parametrize("signal", ["video", "audio"])
def test_temporal_block_megakernel_matches_jax(monkeypatch, signal):
    """K1 over (B*N, T, C) with the per-modality (1, h, T, T) bias (the JAX
    side packs 8 rows into one block-diagonal gram)."""
    _fused(monkeypatch)
    st, p, blk = _block()
    rng = np.random.RandomState(6)
    x = rng.randn(12, JCFG.num_frames, st.dim).astype(np.float32)
    t_idx = jax_window.temporal_relative_index(JCFG.num_frames)
    ref = PA.temporal_block_megakernel(p["attn"], p["norm1"], jnp.asarray(x), st.num_heads,
                                       jnp.asarray(t_idx), signal=signal)
    out = FA.temporal_block_megakernel(blk.attn, blk.norm1, t(x), st.num_heads,
                                       torch.from_numpy(t_idx), signal=signal)
    assert rel(out, ref) < TOL


def test_window_attention_fused_matches_jax(monkeypatch):
    """qkv product, K8 with a (nW * heads, N, N) bias, proj product."""
    _fused(monkeypatch)
    st, p, blk = _block()
    rng = np.random.RandomState(7)
    ws, ss = st.window_size, st.shift_size
    xw = rng.randn(2 * 4, ws * ws, st.dim).astype(np.float32)
    mask = jax_window.shift_attn_mask(st.H, st.W, ws, ss)
    rel_idx = jax_window.relative_position_index(ws)
    ref = PA.window_attention_fused(p["attn"], jnp.asarray(xw), st.num_heads,
                                    jnp.asarray(rel_idx), mask=jnp.asarray(mask))
    out = FA.window_attention_fused(blk.attn, t(xw), st.num_heads, torch.from_numpy(rel_idx),
                                    mask=t(mask))
    assert rel(out, ref) < TOL


@pytest.mark.parametrize("signal", ["video", "audio"])
def test_temporal_attention_fused_matches_jax(monkeypatch, signal):
    _fused(monkeypatch)
    st, p, blk = _block()
    rng = np.random.RandomState(8)
    x = rng.randn(6, JCFG.num_frames, st.dim).astype(np.float32)
    t_idx = jax_window.temporal_relative_index(JCFG.num_frames)
    ref = PA.temporal_attention_fused(p["attn"], jnp.asarray(x), st.num_heads,
                                      jnp.asarray(t_idx), signal=signal)
    out = FA.temporal_attention_fused(blk.attn, t(x), st.num_heads, torch.from_numpy(t_idx),
                                      signal=signal)
    assert rel(out, ref) < TOL


@pytest.mark.parametrize("route", ["kernel", "plain"])
def test_layernorm_fused_matches_jax(monkeypatch, route):
    """K9 at and above the threshold (lowered to 0 in both packages for the
    kernel route), the plain LayerNorm below it."""
    _fused(monkeypatch)
    st, p, blk = _block()
    x = np.random.RandomState(9).randn(3, 20, st.dim).astype(np.float32)
    min_elems = 0 if route == "kernel" else 1 << 20
    monkeypatch.setattr(FA, "LN_KERNEL_MIN_ELEMS", min_elems)
    assert FA.ln_kernel_route(x.size) == (route == "kernel")
    ref = PA.layernorm_fused(p["norm1"], jnp.asarray(x), min_elems=min_elems)
    out = FA.layernorm_fused(blk.norm1, t(x))
    assert rel(out, ref) < TOL


def test_ffn_megakernel_matches_jax(monkeypatch):
    _fused(monkeypatch)
    st, p, blk = _block()
    x = np.random.RandomState(10).randn(2, 30, st.dim).astype(np.float32)
    ref = PA.ffn_megakernel(p["mlp"], p["norm2"], jnp.asarray(x))
    out = FA.ffn_megakernel(blk.mlp, blk.norm2, t(x))
    assert rel(out, ref) < TOL


def test_routes_follow_the_jax_policy():
    assert FA.block_kernel_route(16) and not FA.block_kernel_route(17)
    assert FA.ln_kernel_route(1 << 20) and not FA.ln_kernel_route((1 << 20) - 1)
    # stage 1 of Swin-Base at B = 8: 62720 tokens x 1024 hidden x 2 bytes = 128 MB
    assert FA.ffn_kernel_route(62720, 1024, 2)
    assert not FA.ffn_kernel_route(15680, 2048, 2)      # stage 2: 64 MB
    assert FA.ffn_kernel_route(15680, 2048, 4)          # the same in fp32: 128 MB


# ---------------------------------------------------------------------------
# window geometry, bit for bit
# ---------------------------------------------------------------------------

GEOMS = [(14, 14, 7, 3), (8, 8, 4, 2), (7, 7, 7, 0), (12, 8, 4, 2)]


@pytest.mark.parametrize("H,W,ws,ss", GEOMS)
def test_window_ops_match_jax_bit_exact(H, W, ws, ss):
    rng = np.random.RandomState(H * W + ws)
    x = rng.randn(3, H, W, 5).astype(np.float32)
    xw = window.window_partition(t(x), ws)
    np.testing.assert_array_equal(xw.numpy(), np.asarray(jax_window.window_partition(x, ws)))
    back = window.window_reverse(xw, ws, H, W)
    np.testing.assert_array_equal(back.numpy(), np.asarray(
        jax_window.window_reverse(jnp.asarray(xw.numpy()), ws, H, W)))
    np.testing.assert_array_equal(back.numpy(), x)
    np.testing.assert_array_equal(window.relative_position_index(ws),
                                  jax_window.relative_position_index(ws))
    if ss:
        np.testing.assert_array_equal(window.shift_attn_mask(H, W, ws, ss),
                                      jax_window.shift_attn_mask(H, W, ws, ss))
    Hm, Wm = H // 2 * 2, W // 2 * 2            # merging takes even grids
    tokens = rng.randn(2, Hm * Wm, 6).astype(np.float32)
    np.testing.assert_array_equal(window.patch_merge(t(tokens), Hm, Wm).numpy(), np.asarray(
        jax_window.patch_merge(jnp.asarray(tokens), Hm, Wm)))


@pytest.mark.parametrize("T", [2, 10])
def test_temporal_relative_index_matches_jax(T):
    np.testing.assert_array_equal(window.temporal_relative_index(T),
                                  jax_window.temporal_relative_index(T))


# ---------------------------------------------------------------------------
# plain (XLA-path) attention ops and the patch conv
# ---------------------------------------------------------------------------

def test_window_and_temporal_attention_match_jax():
    st, p, blk = _block()
    rng = np.random.RandomState(11)
    ws = st.window_size
    xw = rng.randn(8, ws * ws, st.dim).astype(np.float32)
    mask = jax_window.shift_attn_mask(st.H, st.W, ws, st.shift_size)
    rel_idx = jax_window.relative_position_index(ws)
    ref = jax_attention.window_attention(p["attn"], jnp.asarray(xw), st.num_heads,
                                         jnp.asarray(rel_idx), mask=jnp.asarray(mask))
    out = attention.window_attention(blk.attn, t(xw), st.num_heads, torch.from_numpy(rel_idx),
                                     mask=t(mask))
    assert rel(out, ref) < TOL
    xt = rng.randn(6, JCFG.num_frames, st.dim).astype(np.float32)
    t_idx = jax_window.temporal_relative_index(JCFG.num_frames)
    ref = jax_attention.temporal_attention(p["attn"], jnp.asarray(xt), st.num_heads,
                                           jnp.asarray(t_idx), signal="audio")
    out = attention.temporal_attention(blk.attn, t(xt), st.num_heads, torch.from_numpy(t_idx),
                                       signal="audio")
    assert rel(out, ref) < TOL


def test_conv3d_matches_jax():
    rng = np.random.RandomState(12)
    p = {"kernel": jnp.asarray(rng.randn(1, 4, 4, 3, 16).astype(np.float32) * 0.2),
         "bias": jnp.asarray(rng.randn(16).astype(np.float32))}
    x = rng.randn(2, 3, 16, 12, 3).astype(np.float32)
    ref = jax_conv.conv3d(p, jnp.asarray(x), stride=(1, 4, 4))
    sd = params_from_jax(to_numpy_tree(p))
    out = conv.conv3d(sd["weight"], sd["bias"], t(x), stride=(1, 4, 4))
    assert out.shape == ref.shape == (2, 3, 4, 3, 16)
    assert rel(out, ref) < TOL
