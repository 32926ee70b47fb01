"""The int8 Swin pieces of the port against the JAX package, at tiny sizes on
the CPU.

- `quantize_swin_tower` against the JAX one, bit for bit; `int8_matmul`
  (the JAX package's XLA int8 path, reached through `linear` on a quantized
  layer) against the JAX one.
- K2 (`win_block_q`) through the Swin entry points `window_block_megakernel`
  (shifted and unshifted windows, bias of period nW) and
  `temporal_block_megakernel`, K3 (`ffn_q`) with erf-GELU through
  `ffn_q_megakernel` at a Swin width, and the 32-head temporal site
  (`temporal_attention_fused`: `int8_matmul` around the K8 core), each
  against the JAX entry point with STGCMA_FUSED_ATTN=1 (Pallas in interpret
  mode; the JAX side pads and packs, the port does not).
- K4's int8 variant (`swin_block_q_plain`, through `swin_fusion_whole_block`)
  against `_fullgrid_pallas` of an int8 block in interpret mode: shift 0 and
  > 0, a 2-head and a 32-head geometry, fp32 and bf16.

Tolerances (max abs error over max |ref|):
- 0 (bit for bit) for the quantized tower, 1e-6 for `int8_matmul` (the same
  quantizer and an exact integer product on both sides: only the last ulp
  of the fp32 dequantization could differ);
- 1e-5 for the 32-head temporal site in fp32 (`int8_matmul` on both sides,
  so the same codes; the K8 core differs in summation order only);
- the int8 kernels with the JAX reciprocal made correctly rounded, as the
  port's, in fp32 inputs and outputs (`rows_agree`): every row within 1e-5,
  except rows that a one-sided rounding moved, at most 1 in 10 and each
  within 1e-2. The two sides' LayerNorms differ in the last ulp (XLA fuses
  the statistics differently inside the interpreter's jit than eagerly),
  as do the A&S erf of the JAX kernels and torch.erf (< 2e-7); where such
  a difference lands on a rounding boundary, one int8 code moves by one
  step, or in K2 (whose qkv is bf16 whatever the input) one q, k or v
  element by one bf16 step. That moves its own row, or the rows of the
  window attending to the moved key, by 1e-3 to 5e-3 (measured: 1 to 25 of
  392 window rows, 2 of 48 temporal rows, 1 of 147 K4 rows); every other
  row agrees to ~1e-7;
- the same kernels as interpret mode runs them (a bf16-emulated
  reciprocal, 2^-9 relative, which moves many codes by one step), and K4
  in bf16 (both sides round to bf16 at every stage, the codes then move at
  the rounding differences): 3e-2, quantization noise of ~1e-2.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from stgcma_tpu.configs import swin_tiny_test as jax_swin_tiny_test
from stgcma_tpu.models import ave as jax_ave
from stgcma_tpu.nn import swin as jax_swin
from stgcma_tpu.ops import pallas_attn as PA
from stgcma_tpu.ops import pallas_swin_block as PSB
from stgcma_tpu.ops import quant as jax_quant
from stgcma_tpu.ops import window as jax_window
from stgcma_tpu.ops.common import cast_tree as jax_cast_tree
from stgcma_tpu_torch.checkpoint.convert import params_from_jax, swin_ave_from_jax
from stgcma_tpu_torch.configs import swin_tiny_test
from stgcma_tpu_torch.nn import swin
from stgcma_tpu_torch.ops import common, fused_attn as FA, quant
from stgcma_tpu_torch.ops import swin_block as SB

from torch_port_helpers import clear_opt_ins, exact_reciprocal, rel, rows_agree, t, to_numpy_tree

TOL_INTERP = 3e-2
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _fused(monkeypatch, exact_recip=True):
    clear_opt_ins(monkeypatch)
    monkeypatch.setenv("STGCMA_FUSED_ATTN", "1")
    if exact_recip:
        exact_reciprocal(monkeypatch)


def _agree(out, ref, exact_recip):
    if exact_recip:
        rows_agree(out, ref)
    else:
        assert rel(out, ref) < TOL_INTERP


def _quantize_jax_block(p):
    """The block's four tower products quantized, as `quantize_swin_tower`
    does it block by block."""
    q = dict(p)
    q["attn"] = {**p["attn"], "qkv": jax_quant.quantize_linear_params(p["attn"]["qkv"]),
                 "proj": jax_quant.quantize_linear_params(p["attn"]["proj"])}
    q["mlp"] = {k: jax_quant.quantize_linear_params(p["mlp"][k]) for k in ("fc1", "fc2")}
    return q


def _port_block(pst, jax_params):
    """The port's SwinBlock with int8 tower products, holding the JAX block's
    weights (loaded strictly)."""
    blk = swin.SwinBlock(pst)
    for mod, names in ((blk.attn, ("qkv", "proj")), (blk.mlp, ("fc1", "fc2"))):
        for n in names:
            setattr(mod, n, quant.quantize_linear_params(getattr(mod, n)))
    blk.load_state_dict(params_from_jax(to_numpy_tree(jax_params)), strict=True)
    return blk


# ---------------------------------------------------------------------------
# quantize_swin_tower and int8_matmul
# ---------------------------------------------------------------------------

TINY = dict(ftmode="fusion", embed_dim=32, depths=(2, 2), num_heads=(2, 4), img_size=56,
            num_frames=2, adapter_ratios=(0.25, 0.25), label_dim=5)


def test_quantize_swin_tower_matches_jax_bit_exact():
    cfg = jax_swin_tiny_test(**TINY)
    shapes = jax.eval_shape(lambda: jax_ave.init_swin_ave(jax.random.PRNGKey(0), cfg))
    rng = np.random.RandomState(1)
    params = jax.tree_util.tree_map(
        lambda x: jnp.asarray((rng.randn(*x.shape) * 0.05).astype(np.float32)), shapes)
    model = swin_ave_from_jax(swin_tiny_test(**TINY), to_numpy_tree(params), device="cpu")
    qb = quant.quantize_swin_tower(model.backbone)
    assert not model.backbone.layers[0].blocks[0].attn.qkv.quantized      # a copy
    ref = params_from_jax(to_numpy_tree(jax_quant.quantize_swin_tower(params["backbone"])))
    ours = qb.state_dict()
    assert sorted(ours) == sorted(ref)
    assert sum(k.endswith("weight_q") for k in ours) == 4 * sum(TINY["depths"])
    for k, v in ref.items():
        assert ours[k].dtype == v.dtype, k
        np.testing.assert_array_equal(ours[k].numpy(), v.numpy(), err_msg=k)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_int8_matmul_and_linear_match_jax(dtype):
    """`int8_matmul` and `linear` on a QLinear against the JAX `int8_matmul`
    and `linear`, on (2, 5, 96) rows with an all-zero row (the 1e-12 floor)."""
    jdt, tdt = DTYPES[dtype]
    rng = np.random.RandomState(2)
    K, N = 96, 48
    x = (rng.randn(2, 5, K) * rng.rand(2, 5, 1) * 4).astype(np.float32)
    x[1, 2] = 0.0
    lin = jax_quant.quantize_linear_params(
        {"kernel": jnp.asarray(rng.randn(K, N) * 0.05, jnp.float32),
         "bias": jnp.asarray(rng.randn(N) * 0.05, jnp.float32)})
    sd = params_from_jax(to_numpy_tree(lin))
    lin = jax_cast_tree(lin, jdt)
    xj = jnp.asarray(x).astype(jdt)
    ref = jax_quant.int8_matmul(xj, lin["kernel_q"], lin["kernel_s"], bias=lin["bias"])
    from stgcma_tpu.ops.common import linear as jax_linear
    np.testing.assert_array_equal(np.asarray(jax_linear(lin, xj), np.float32),
                                  np.asarray(ref, np.float32))
    ql = common.QLinear(K, N)
    ql.load_state_dict(sd, strict=True)
    ql = ql.to(tdt)
    xt = t(x, tdt)
    out = quant.int8_matmul(xt, ql.weight_q, ql.weight_s, bias=ql.bias)
    assert out.dtype == tdt and out.shape == (2, 5, N)
    assert rel(out, np.asarray(ref, np.float32)) <= 1e-6
    assert torch.equal(common.linear(ql, xt), out)


# ---------------------------------------------------------------------------
# K2 and K3 at the Swin sites, and the int8_matmul temporal site
# ---------------------------------------------------------------------------

SWIN = dict(ftmode="multimodal", embed_dim=64, depths=(2,), num_heads=(2,), img_size=56,
            num_frames=4, adapter_ratios=(0.25,))
T = SWIN["num_frames"]


def _block(heads=2, seed=4):
    """A stage-0 int8 block (14x14 grid, window 7, shift 3 for the shifted
    block, C = 64, dh = 32 at 2 heads) with the temporal tables, JAX params
    with random non-trivial leaves, and the port's block holding them."""
    jcfg = jax_swin_tiny_test(**{**SWIN, "num_heads": (heads,)})
    pcfg = swin_tiny_test(**{**SWIN, "num_heads": (heads,)})
    st = jax_swin.make_block_static(jcfg, 0, 1, "multimodal_adapt_no_fusion")
    st_t = jax_swin.make_block_static(jcfg, 0, 0, "multimodal_adapt_no_fusion")
    p = jax_swin.block_init(jax.random.PRNGKey(0), st_t)
    keys = iter(jax.random.split(jax.random.PRNGKey(seed), 512))
    p = jax.tree_util.tree_map(
        lambda a: jax.random.normal(next(keys), a.shape, jnp.float32) * 0.1, p)
    for k in ("relative_position_bias_table", "temporal_position_bias_table",
              "temporal_position_bias_table_audio"):
        p["attn"][k] = p["attn"][k] * 10.0
    p["norm1"]["scale"] = p["norm1"]["scale"] + 1.0
    p["norm2"]["scale"] = p["norm2"]["scale"] + 1.0
    p = _quantize_jax_block(p)
    blk = _port_block(swin.make_block_static(pcfg, 0, 0, "multimodal_adapt_no_fusion"), p)
    return st, p, blk


@pytest.mark.parametrize("exact_recip", [True, False])
@pytest.mark.parametrize("shifted", [True, False])
def test_window_block_megakernel_int8_matches_jax(monkeypatch, shifted, exact_recip):
    """K2 with the gathered bias plus the shift mask, (nW, h, 49, 49) of
    period nW (JAX pads 49 -> 64 and packs two windows into one gram)."""
    _fused(monkeypatch, exact_recip)
    st, p, blk = _block()
    rng = np.random.RandomState(5)
    x = rng.randn(2, st.H, st.W, st.dim).astype(np.float32)
    ws, ss = st.window_size, st.shift_size if shifted else 0
    mask = jax_window.shift_attn_mask(st.H, st.W, ws, ss) if ss else None
    xw = np.asarray(jax_window.window_partition(
        jnp.asarray(np.roll(x, (-ss, -ss), axis=(1, 2))), ws))
    rel_idx = jax_window.relative_position_index(ws)
    ref = PA.window_block_megakernel(p["attn"], p["norm1"], jnp.asarray(xw), st.num_heads,
                                     jnp.asarray(rel_idx),
                                     mask=None if mask is None else jnp.asarray(mask))
    FA.reset_launches()
    out = FA.window_block_megakernel(blk.attn, blk.norm1, t(xw), st.num_heads,
                                     torch.from_numpy(rel_idx),
                                     mask=None if mask is None else t(mask))
    assert FA.win_block_q.launches == 0 and FA.win_block.launches == 0
    assert out.shape == xw.shape
    _agree(out, ref, exact_recip)


@pytest.mark.parametrize("exact_recip", [True, False])
@pytest.mark.parametrize("signal", ["video", "audio"])
def test_temporal_block_megakernel_int8_matches_jax(monkeypatch, signal, exact_recip):
    """K2 over (B*N, T, C) with the per-modality (1, h, T, T) bias (JAX packs
    8 rows into one block-diagonal gram)."""
    _fused(monkeypatch, exact_recip)
    st, p, blk = _block()
    x = np.random.RandomState(6).randn(12, T, st.dim).astype(np.float32)
    t_idx = jax_window.temporal_relative_index(T)
    ref = PA.temporal_block_megakernel(p["attn"], p["norm1"], jnp.asarray(x), st.num_heads,
                                       jnp.asarray(t_idx), signal=signal)
    out = FA.temporal_block_megakernel(blk.attn, blk.norm1, t(x), st.num_heads,
                                       torch.from_numpy(t_idx), signal=signal)
    _agree(out, ref, exact_recip)


@pytest.mark.parametrize("exact_recip", [True, False])
def test_ffn_q_megakernel_erf_gelu_at_swin_width_matches_jax(monkeypatch, exact_recip):
    """K3 at Swin-Base's stage-0 width (C = 128, hidden 512) with the Swin
    keys and erf-GELU, the defaults of both entry points."""
    _fused(monkeypatch, exact_recip)
    jcfg = jax_swin_tiny_test(**{**SWIN, "embed_dim": 128})
    pcfg = swin_tiny_test(**{**SWIN, "embed_dim": 128})
    st = jax_swin.make_block_static(jcfg, 0, 1, "multimodal_adapt_no_fusion")
    rng = np.random.RandomState(7)
    p = jax_swin.block_init(jax.random.PRNGKey(1), st)
    p = jax.tree_util.tree_map(lambda a: jnp.asarray(
        (rng.randn(*a.shape) * 0.1).astype(np.float32)), p)
    p["norm2"]["scale"] = p["norm2"]["scale"] + 1.0
    p["mlp"]["fc1"]["kernel"] = p["mlp"]["fc1"]["kernel"] * 3.0    # GELU over both branches
    p = _quantize_jax_block(p)
    blk = _port_block(swin.make_block_static(pcfg, 0, 1, "multimodal_adapt_no_fusion"), p)
    x = rng.randn(3, 20, 128).astype(np.float32)
    ref = PA.ffn_q_megakernel(p["mlp"], p["norm2"], jnp.asarray(x))
    out = FA.ffn_q_megakernel(blk.mlp, blk.norm2, t(x))
    assert FA.ffn_q.launches == 0
    assert out.shape == x.shape
    _agree(out, ref, exact_recip)


def test_temporal_attention_fused_int8_matches_jax(monkeypatch):
    """The 32-head temporal site: `int8_matmul` for qkv and proj (through
    `linear` on both sides), the K8 core between them."""
    _fused(monkeypatch)
    st, p, blk = _block(heads=32)
    x = np.random.RandomState(8).randn(6, T, st.dim).astype(np.float32)
    t_idx = jax_window.temporal_relative_index(T)
    ref = PA.temporal_attention_fused(p["attn"], jnp.asarray(x), st.num_heads,
                                      jnp.asarray(t_idx), signal="audio")
    FA.reset_launches()
    out = FA.temporal_attention_fused(blk.attn, t(x), st.num_heads, torch.from_numpy(t_idx),
                                      signal="audio")
    assert not FA.block_kernel_route(st.num_heads)
    assert rel(out, ref) < 1e-5


# ---------------------------------------------------------------------------
# K4's int8 variant
# ---------------------------------------------------------------------------

# (H, W, ws, ss, heads, C): a shifted and an unshifted 2-head grid, and a
# 32-head 7x7 grid like Swin-Base's stage 3 (C multiple of 16 for int8 rows)
K4_GEOMS = {"2h_shift0": (8, 8, 4, 0, 2, 32), "2h_shift2": (8, 8, 4, 2, 2, 32),
            "32h_7x7": (7, 7, 7, 0, 32, 64)}


def _k4_block(H, W, ws, ss, heads, C, dtype, BT=3, seed=0):
    """An int8 fusion block with every float leaf random and non-trivial
    (live adapters and gates), JAX params and the port's block holding the
    same weights in `dtype`, and inputs."""
    st = jax_swin.BlockStatic(dim=C, H=H, W=W, num_heads=heads, window_size=ws, shift_size=ss,
                              t_attn=False, num_frames=2, adapter_ratio=0.25,
                              mode="fusion_adapt")
    p = jax_swin.block_init(jax.random.PRNGKey(seed), st)
    keys = iter(jax.random.split(jax.random.PRNGKey(seed + 1), 256))
    p = jax.tree_util.tree_map(
        lambda a: jax.random.normal(next(keys), a.shape, jnp.float32) * 0.1, p)
    p["attn"]["relative_position_bias_table"] = p["attn"]["relative_position_bias_table"] * 10
    p["norm1"]["scale"] = p["norm1"]["scale"] + 1.0
    p["norm2"]["scale"] = p["norm2"]["scale"] + 1.0
    p["gate_v"], p["gate_a"] = p["gate_v"] * 8, p["gate_a"] * 8
    p = _quantize_jax_block(p)
    pst = swin.BlockStatic(dim=C, H=H, W=W, num_heads=heads, window_size=ws, shift_size=ss,
                           t_attn=False, num_frames=2, adapter_ratio=0.25, mode="fusion_adapt")
    jdt, tdt = DTYPES[dtype]
    blk = _port_block(pst, p).to(tdt)
    rng = np.random.RandomState(seed + 2)
    v, a = (rng.randn(BT, H * W, C).astype(np.float32) for _ in range(2))
    return (st, jax_cast_tree(p, jdt), jnp.asarray(v).astype(jdt), jnp.asarray(a).astype(jdt),
            pst, blk, t(v, tdt), t(a, tdt))


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("geom", sorted(K4_GEOMS))
def test_swin_block_q_plain_matches_jax_kernel(monkeypatch, dtype, geom):
    _fused(monkeypatch)
    st, p, jv, ja, pst, blk, tv, ta = _k4_block(*K4_GEOMS[geom], dtype)
    assert p["attn"]["qkv"]["kernel_q"].dtype == jnp.int8
    ref = PSB._fullgrid_pallas(p, jv, ja, (st.H, st.W, st.window_size, st.shift_size,
                                           st.num_heads), winmajor=False)
    FA.reset_launches()
    with torch.inference_mode():
        out = SB.swin_fusion_whole_block(blk, tv, ta, pst)
    assert SB.swin_block_q.launches == 0 and SB.swin_block.launches == 0
    assert out[0].dtype == tv.dtype and out[0].shape == tv.shape
    for o, r in zip(out, ref):
        if dtype == "float32":
            rows_agree(o, np.asarray(r))
        else:
            assert rel(o, np.asarray(r, np.float32)) < TOL_INTERP


def test_block_weights_of_an_int8_block_name_the_scales():
    """The int8 block hands K4 its int8 weights with their scales; the float
    variant's names are unchanged."""
    st, p, jv, ja, pst, blk, tv, ta = _k4_block(*K4_GEOMS["2h_shift2"], "float32")
    w = SB.block_weights(blk)
    for wk, sk, bk in SB.TOWER:
        assert w[wk].dtype == torch.int8 and w[sk].shape == w[bk].shape
    fw = SB.block_weights(swin.SwinBlock(pst))
    assert not any(sk in fw for _, sk, _ in SB.TOWER)
    assert set(w) == set(fw) | {sk for _, sk, _ in SB.TOWER}
