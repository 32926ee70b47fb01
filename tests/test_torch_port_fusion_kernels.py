"""The STG-CMA fusion kernels of the port against the JAX package, at tiny
sizes on the CPU.

- K5 and K6 (`fuse_plain`, the plain version of csrc/fuse.cu) against the
  JAX kernels in interpret mode: `_win_fuse_pallas` over (R, 49, d) windows
  (the JAX side pads 49 -> 64 with a symmetric mask), `_bidir_fuse_pallas`
  in its full-gram variant and, above its 48 MB gram threshold, its tiled
  variant, and the XLA `cross_modal_fuse`.
- K4 (`swin_block_plain`, through the entry point `swin_fusion_whole_block`)
  against `_fullgrid_pallas` in interpret mode: shift 0 and > 0, a 2-head
  and a 32-head geometry.
- The full-grid geometry (`Geo`) against JAX's `_geo`, bit for bit.
- The routing of the entry points (`cross_modal_fuse_flash`,
  `swin_whole_block_enabled`).

Tolerances (max abs error over max |ref|): 1e-5 in fp32, where the math is
the same and only the summation order differs (the JAX FFN and adapter
GELU use an A&S erf polynomial within 2e-7 of torch.erf); 2e-2 in bf16,
where both sides round every stage to bf16 but at slightly different places
(the JAX tiled kernel rounds unnormalized exps, interpret-mode bf16 dots
accumulate in bf16); 0 for the geometry.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from stgcma_tpu.nn.swin import BlockStatic as JaxBlockStatic
from stgcma_tpu.nn.swin import block_init
from stgcma_tpu.ops import attention as jax_attention
from stgcma_tpu.ops import pallas_attn as PA
from stgcma_tpu.ops import pallas_swin_block as PSB
from stgcma_tpu_torch.checkpoint.convert import params_from_jax
from stgcma_tpu_torch.nn import swin
from stgcma_tpu_torch.ops import fused_attn as FA
from stgcma_tpu_torch.ops import swin_block as SB

from torch_port_helpers import clear_opt_ins, rel, t, to_numpy_tree

TOL = {"float32": 1e-5, "bfloat16": 2e-2}
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _fuse_inputs(rng, B, Nv, Na, D, scale=0.7):
    vh = (rng.randn(B, Nv, D) * scale).astype(np.float32)
    ah = (rng.randn(B, Na, D) * scale).astype(np.float32)
    gates = np.array([0.8], np.float32), np.array([-0.6], np.float32)
    return vh, ah, gates


def _both(arrays, dtype):
    jdt, tdt = DTYPES[dtype]
    return [jnp.asarray(a).astype(jdt) for a in arrays], [t(a, tdt) for a in arrays]


def _rel2(out, ref):
    return max(rel(o, np.asarray(r, np.float32)) for o, r in zip(out, ref))


# ---------------------------------------------------------------------------
# K5 and K6
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", sorted(TOL))
@pytest.mark.parametrize("D", [16, 32])
def test_win_fuse_plain_matches_jax_kernel(monkeypatch, dtype, D):
    clear_opt_ins(monkeypatch)
    vh, ah, (gv, ga) = _fuse_inputs(np.random.RandomState(D), 12, 49, 49, D)
    (jv, ja, jgv, jga), (tv, ta, tgv, tga) = _both((vh, ah, gv, ga), dtype)
    ref = PA._win_fuse_pallas(jv, ja, jgv, jga)
    FA.reset_launches()
    out = FA.cross_modal_fuse_windows(tv, ta, tgv, tga)
    assert FA.win_fuse.launches == 0                  # the plain version on the CPU
    assert out[0].dtype == DTYPES[dtype][1] and out[0].shape == vh.shape
    assert _rel2(out, ref) < TOL[dtype]


@pytest.mark.parametrize("dtype", sorted(TOL))
def test_bidir_fuse_plain_matches_jax_full_kernel_and_xla(monkeypatch, dtype):
    """K6 at Nv != Na, both multiples of 16 (the full-gram variant)."""
    clear_opt_ins(monkeypatch)
    vh, ah, (gv, ga) = _fuse_inputs(np.random.RandomState(3), 3, 144, 128, 32)
    (jv, ja, jgv, jga), (tv, ta, tgv, tga) = _both((vh, ah, gv, ga), dtype)
    out = FA.bidir_fuse(tv, ta, tgv, tga)
    assert out[0].shape == vh.shape and out[1].shape == ah.shape
    assert _rel2(out, PA._bidir_fuse_pallas(jv, ja, jgv, jga)) < TOL[dtype]
    assert _rel2(out, jax_attention.cross_modal_fuse(jv, ja, jgv, jga)) < TOL[dtype]


@pytest.mark.parametrize("dtype", sorted(TOL))
def test_bidir_fuse_plain_matches_jax_tiled_kernel(monkeypatch, dtype):
    """Above 48 MB of fp32 gram `_bidir_fuse_pallas` takes its tiled kernel
    (online column softmax over 512-row tiles, the last one padded)."""
    clear_opt_ins(monkeypatch)
    Nv, Na = 3136, 4096
    assert Nv * Na * 4 > (48 << 20)
    vh, ah, (gv, ga) = _fuse_inputs(np.random.RandomState(4), 1, Nv, Na, 16, scale=0.5)
    (jv, ja, jgv, jga), (tv, ta, tgv, tga) = _both((vh, ah, gv, ga), dtype)
    out = FA.fuse_plain(tv, ta, tgv, tga)
    assert _rel2(out, PA._bidir_fuse_pallas(jv, ja, jgv, jga)) < TOL[dtype]


def test_fuse_plain_mask_is_added_in_both_directions():
    """With a mask, each direction's softmax sees the (Nv, Na) mask as it
    sees the gram: masked keys drop out of both."""
    rng = np.random.RandomState(5)
    vh, ah, (gv, ga) = _fuse_inputs(rng, 2, 6, 6, 16)
    mask = np.where(np.arange(6)[:, None] // 3 == np.arange(6)[None, :] // 3, 0.0, -1e30)
    out = FA.fuse_plain(t(vh), t(ah), t(gv), t(ga), t(mask.astype(np.float32)))
    halves = [FA.fuse_plain(t(vh[:, s]), t(ah[:, s]), t(gv), t(ga))
              for s in (slice(0, 3), slice(3, 6))]
    for i in range(2):
        joined = torch.cat([halves[0][i], halves[1][i]], dim=1)
        assert rel(out[i], joined.numpy()) < TOL["float32"]


def test_flash_routes_follow_the_jax_policy(monkeypatch):
    """Below 120 tokens the plain `cross_modal_fuse`; K6 where JAX takes its
    bidirectional kernel; on the K10 route (JAX's fallback) two K10 calls
    and the gated adds, which match JAX's `cross_modal_fuse`."""
    clear_opt_ins(monkeypatch)
    assert FA.flash_fuse_route(119, 119, 16) == "plain"
    assert FA.flash_fuse_route(3136, 3136, 16) == "K6"
    assert FA.flash_fuse_route(784, 784, 32) == "K6"
    assert FA.flash_fuse_route(200, 200, 16) == "K10"          # 200 % 16 != 0
    assert FA.flash_fuse_route(128, 1 << 16, 128) == "K10"     # Na * D * 4 > 16 MiB
    vh, ah, (gv, ga) = _fuse_inputs(np.random.RandomState(6), 2, 64, 64, 16)
    FA.reset_launches()
    out = FA.cross_modal_fuse_flash(t(vh), t(ah), t(gv), t(ga))
    ref = jax_attention.cross_modal_fuse(*(jnp.asarray(x) for x in (vh, ah, gv, ga)))
    assert _rel2(out, ref) < TOL["float32"]
    assert FA.bidir_fuse.launches == 0
    vh, ah, _ = _fuse_inputs(np.random.RandomState(7), 1, 200, 200, 16)
    calls, plain = [], FA.unscaled_attention.plain
    monkeypatch.setattr(FA.unscaled_attention, "plain", lambda *a: calls.append(1) or plain(*a))
    out = FA.cross_modal_fuse_flash(t(vh), t(ah), t(gv), t(ga))
    ref = jax_attention.cross_modal_fuse(*(jnp.asarray(x) for x in (vh, ah, gv, ga)))
    assert _rel2(out, ref) < TOL["float32"]
    assert len(calls) == 2 and FA.bidir_fuse.launches == 0     # a2v and v2a, plain on the CPU


# ---------------------------------------------------------------------------
# K4
# ---------------------------------------------------------------------------

# (H, W, ws, ss, heads, C): a shifted and an unshifted 2-head grid, and a
# 32-head 7x7 grid like Swin-Base's stage 3
K4_GEOMS = {"2h_shift0": (8, 8, 4, 0, 2, 16), "2h_shift2": (8, 8, 4, 2, 2, 16),
            "32h_7x7": (7, 7, 7, 0, 32, 64)}


def _k4_block(H, W, ws, ss, heads, C, dtype, BT=3, seed=0):
    """JAX block params with every leaf random and non-trivial, the port's
    SwinBlock holding the same weights, inputs, and the port's static."""
    st = JaxBlockStatic(dim=C, H=H, W=W, num_heads=heads, window_size=ws, shift_size=ss,
                        t_attn=False, num_frames=2, adapter_ratio=0.25, mode="fusion_adapt")
    p = block_init(jax.random.PRNGKey(seed), st)
    keys = iter(jax.random.split(jax.random.PRNGKey(seed + 1), 256))
    p = jax.tree_util.tree_map(
        lambda a: jax.random.normal(next(keys), a.shape, jnp.float32) * 0.1, p)
    p["attn"]["relative_position_bias_table"] = p["attn"]["relative_position_bias_table"] * 10
    p["norm1"]["scale"] = p["norm1"]["scale"] + 1.0
    p["norm2"]["scale"] = p["norm2"]["scale"] + 1.0
    p["gate_v"], p["gate_a"] = p["gate_v"] * 8, p["gate_a"] * 8
    rng = np.random.RandomState(seed + 2)
    v, a = (rng.randn(BT, H * W, C).astype(np.float32) for _ in range(2))
    pst = swin.BlockStatic(dim=C, H=H, W=W, num_heads=heads, window_size=ws, shift_size=ss,
                           t_attn=False, num_frames=2, adapter_ratio=0.25, mode="fusion_adapt")
    blk = swin.SwinBlock(pst)
    blk.load_state_dict(params_from_jax(to_numpy_tree(p)), strict=True)
    jdt, tdt = DTYPES[dtype]
    p = jax.tree_util.tree_map(lambda x: x.astype(jdt), p)
    return st, p, jnp.asarray(v).astype(jdt), jnp.asarray(a).astype(jdt), \
        pst, blk.to(tdt), t(v, tdt), t(a, tdt)


@pytest.mark.parametrize("dtype", sorted(TOL))
@pytest.mark.parametrize("geom", sorted(K4_GEOMS))
def test_swin_block_plain_matches_jax_kernel(monkeypatch, dtype, geom):
    clear_opt_ins(monkeypatch)
    st, p, jv, ja, pst, blk, tv, ta = _k4_block(*K4_GEOMS[geom], dtype)
    ref = PSB._fullgrid_pallas(p, jv, ja, (st.H, st.W, st.window_size, st.shift_size,
                                           st.num_heads))
    assert SB.swin_whole_block_enabled(pst)
    FA.reset_launches()
    with torch.inference_mode():
        out = SB.swin_fusion_whole_block(blk, tv, ta, pst)
    assert SB.swin_block.launches == 0
    assert out[0].dtype == tv.dtype and out[0].shape == tv.shape
    assert _rel2(out, ref) < TOL[dtype]


def test_swin_block_plain_matches_jax_naive_mirror(monkeypatch):
    """The same block against `_fullgrid_naive` (the JAX CPU route), fp32."""
    clear_opt_ins(monkeypatch)
    st, p, jv, ja, pst, blk, tv, ta = _k4_block(*K4_GEOMS["2h_shift2"], "float32", seed=3)
    ref = PSB._fullgrid_naive(p, jv, ja, st.num_heads, PSB._geo(st.H, st.W, st.window_size,
                                                                st.shift_size))
    with torch.inference_mode():
        out = SB.swin_fusion_whole_block(blk, tv, ta, pst)
    assert _rel2(out, ref) < TOL["float32"]


def test_whole_block_policy():
    def st(H, mode="fusion_adapt", s=True, g=True, dim=512, heads=16):
        return swin.BlockStatic(dim=dim, H=H, W=H, num_heads=heads, window_size=7,
                                shift_size=0, t_attn=False, num_frames=10, adapter_ratio=0.0625,
                                mode=mode, use_s_adapter=s, use_g_adapter=g)
    assert SB.swin_whole_block_enabled(st(14)) and SB.swin_whole_block_enabled(st(16))
    assert not SB.swin_whole_block_enabled(st(28))                    # 784 > 256 tokens
    assert not SB.swin_whole_block_enabled(st(14, mode="multimodal_adapt_no_fusion"))
    assert not SB.swin_whole_block_enabled(st(14, s=False))
    assert not SB.swin_whole_block_enabled(st(14, g=False))
    assert not SB.swin_whole_block_enabled(st(14, dim=500))


# ---------------------------------------------------------------------------
# geometry, bit for bit
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("H,W,ws,ss", [(14, 14, 7, 3), (7, 7, 7, 0), (8, 8, 4, 2),
                                       (6, 6, 3, 1), (12, 8, 4, 2)])
def test_geo_matches_jax_bit_exact(H, W, ws, ss):
    ours, ref = SB.geo(H, W, ws, ss), PSB._geo(H, W, ws, ss)
    assert ours.N == ref.N == H * W
    for name in ("bias_index", "attn_mask", "fuse_mask"):
        a, b = getattr(ours, name), getattr(ref, name)
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)
