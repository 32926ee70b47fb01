"""The plain versions of K12 and K13 (stgcma_tpu_torch/ops/clip_block.py)
against the JAX package's Pallas kernels in interpret mode, at tiny sizes on
the CPU.

The JAX side calls `_fusion_pallas` and `_tadapt_pallas` of
`stgcma_tpu/ops/pallas_clip_block.py` directly, as
tests/test_clip_block_kernel.py does: on the CPU the JAX entry points return
the naive mirrors, not the kernels' arithmetic. The JAX kernels pad both
token streams to multiples of 16 and mask the pad keys (K12) and pack 8
temporal rows into one block-diagonal gram (K13); the port does neither. The
shapes are chosen against those devices: Nv = 37 and Na = 21 tokens (neither
a multiple of 16), R = 13 temporal rows (not a multiple of 8), T = 10 frames
(80 tokens a pack, no pad) and T = 3 (padded to 16 in JAX). Every adapter and
both gates are live (the training init zeroes D_fc2 and the gates, which
would hide the adapters and the fusion). The port's blocks hold the JAX
block's weights through `params_from_jax`, loaded strictly.

Tolerances (max abs error over max |ref|):
- float variants, fp32: 1e-5 (the same arithmetic; summation order and the
  A&S erf of the JAX kernels against torch.erf, < 2e-7);
- float variants, bf16: 2e-2 (both sides round to bf16 at the same points;
  where a sum differs in its last bit an intermediate rounds the other way,
  one bf16 step of 2^-8 relative, and a few of those add up);
- int8 variants, fp32, with the JAX reciprocal made correctly rounded as the
  port's (`rows_agree`): every row within 1e-5, except rows where a last-ulp
  difference moved one int8 code by one step, at most 1 in 10 and each
  within 1e-2;
- int8 variants in bf16, and in fp32 as interpret mode runs them (a
  bf16-emulated reciprocal, 2^-9 relative, which moves many codes by one
  step): 3e-2, quantization noise of ~1e-2.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from stgcma_tpu.configs import ClipConfig as JaxClipConfig
from stgcma_tpu.nn.clip_vit import clip_block_init
from stgcma_tpu.ops import pallas_clip_block as CB
from stgcma_tpu.ops import quant as jax_quant
from stgcma_tpu.ops.common import cast_tree as jax_cast_tree
from stgcma_tpu_torch.checkpoint.convert import params_from_jax
from stgcma_tpu_torch.configs import ClipConfig
from stgcma_tpu_torch.nn.clip_vit import ClipBlock
from stgcma_tpu_torch.ops import clip_block as PCB
from stgcma_tpu_torch.ops import fused_attn as FA
from stgcma_tpu_torch.ops import quant
from stgcma_tpu_torch.ops.swin_block import TOWER

from torch_port_helpers import clear_opt_ins, exact_reciprocal, rel, rows_agree, t, to_numpy_tree

TOL = {"float32": 1e-5, "bfloat16": 2e-2}
TOL_INTERP = 3e-2
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}
# (C, heads): 8-wide heads, whose dh^-1/2 is no power of two, and 32-wide ones
GEOMS = {"c32_h4": (32, 4), "c64_h2": (64, 2)}
TOWER_LINEARS = (("attn", "in_proj"), ("attn", "out_proj"), ("mlp", "c_fc"), ("mlp", "c_proj"))


def _jax_block(C, heads, int8, seed=0):
    """A fusion-mode CLIP block with every leaf random and non-trivial."""
    cfg = JaxClipConfig(embed_dim=C, layers=1, heads=heads, adapter_ratio=0.25, ftmode="fusion")
    shapes = jax.eval_shape(lambda: clip_block_init(jax.random.PRNGKey(0), cfg, "fusion_adapt"))
    rng = np.random.RandomState(seed)
    p = jax.tree_util.tree_map(
        lambda x: jnp.asarray((rng.randn(*x.shape) * 0.1).astype(np.float32)), shapes)
    for ln in ("ln_1", "ln_2"):
        p[ln]["scale"] = p[ln]["scale"] + 1.0
    p["gate_v"], p["gate_a"] = p["gate_v"] * 8, p["gate_a"] * 8
    p["mlp"]["c_fc"]["kernel"] = p["mlp"]["c_fc"]["kernel"] * 3.0   # QuickGELU over both branches
    if int8:
        for mod, name in TOWER_LINEARS:
            p[mod] = {**p[mod], name: jax_quant.quantize_linear_params(p[mod][name])}
    return p


def _port_block(C, heads, p, tdt):
    """The port's ClipBlock holding the JAX block's weights (loaded strictly)."""
    blk = ClipBlock(ClipConfig(embed_dim=C, layers=1, heads=heads, adapter_ratio=0.25),
                    "fusion_adapt")
    if "kernel_q" in p["attn"]["in_proj"]:
        for mod, name in TOWER_LINEARS:
            setattr(getattr(blk, mod), name,
                    quant.quantize_linear_params(getattr(getattr(blk, mod), name)))
    blk.load_state_dict(params_from_jax(to_numpy_tree(p)), strict=True)
    return blk.to(tdt)


def _setup(geom, dtype, int8, seed=0):
    C, heads = GEOMS[geom]
    jdt, tdt = DTYPES[dtype]
    p = _jax_block(C, heads, int8, seed)
    return C, heads, jdt, tdt, jax_cast_tree(p, jdt), _port_block(C, heads, p, tdt)


def _streams(C, BT=3, Nv=37, Na=21, seed=1):
    rng = np.random.RandomState(seed)
    return ((rng.randn(BT, Nv, C) * 0.5).astype(np.float32),
            (rng.randn(BT, Na, C) * 0.5).astype(np.float32))


def _no_launches():
    assert all(k.launches == 0 for k in FA.KERNELS)   # plain versions on the CPU


# ---------------------------------------------------------------------------
# K12
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("geom", sorted(GEOMS))
def test_fusion_block_plain_matches_jax_kernel(monkeypatch, geom, dtype):
    clear_opt_ins(monkeypatch)
    C, heads, jdt, tdt, p, blk = _setup(geom, dtype, int8=False)
    v, a = _streams(C)
    ref = CB._fusion_pallas(p, jnp.asarray(v).astype(jdt), jnp.asarray(a).astype(jdt), heads)
    FA.reset_launches()
    with torch.inference_mode():
        out = PCB.clip_fusion_spatial_block(blk, t(v, tdt), t(a, tdt), heads)
    _no_launches()
    for o, r, x in zip(out, ref, (v, a)):
        assert o.dtype == tdt and o.shape == x.shape
        assert rel(o, np.asarray(r, np.float32)) < TOL[dtype]


@pytest.mark.parametrize("exact_recip", [True, False])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("geom", sorted(GEOMS))
def test_fusion_block_q_plain_matches_jax_kernel(monkeypatch, geom, dtype, exact_recip):
    clear_opt_ins(monkeypatch)
    if exact_recip:
        exact_reciprocal(monkeypatch)
    C, heads, jdt, tdt, p, blk = _setup(geom, dtype, int8=True)
    assert p["mlp"]["c_fc"]["kernel_q"].dtype == jnp.int8
    v, a = _streams(C)
    ref = CB._fusion_pallas(p, jnp.asarray(v).astype(jdt), jnp.asarray(a).astype(jdt), heads)
    with torch.inference_mode():
        out = PCB.clip_fusion_spatial_block(blk, t(v, tdt), t(a, tdt), heads)
    for o, r in zip(out, ref):
        assert o.dtype == tdt
        if dtype == "float32" and exact_recip:
            rows_agree(o, np.asarray(r))
        else:
            assert rel(o, np.asarray(r, np.float32)) < TOL_INTERP


def test_fusion_block_sees_every_adapter_and_gate(monkeypatch):
    """The comparison above would notice a wiring fault: swapping the gates,
    the S- and MLP-adapters or the two streams' adapters, or zeroing the
    gates, moves the plain version's output by far more than its tolerance."""
    C, heads, _, tdt, _, blk = _setup("c32_h4", "float32", int8=False)
    v, a = (t(x) for x in _streams(C))
    w = {k: x.detach() for k, x in PCB.block_weights(blk).items()}
    ref = torch.cat([o.flatten() for o in PCB.fusion_block_plain(v, a, w, heads)])

    def swap(k1, k2):
        out = dict(w)
        for p in ("w1", "b1", "w2", "b2"):
            out[f"{k1}_{p}"], out[f"{k2}_{p}"] = w[f"{k2}_{p}"], w[f"{k1}_{p}"]
        return out
    faults = {"gates swapped": {**w, "gate_v": w["gate_a"], "gate_a": w["gate_v"]},
              "fusion off": {**w, "gate_v": w["gate_v"] * 0, "gate_a": w["gate_a"] * 0},
              "S and MLP adapters swapped": {**swap("sv", "mv"), **{
                  k: x for k, x in swap("sa", "ma").items() if k[:2] in ("sa", "ma")}},
              "stream adapters swapped": {**swap("sv", "sa"), **{
                  k: x for k, x in swap("mv", "ma").items() if k[:2] in ("mv", "ma")}}}
    for fault, wf in faults.items():
        out = torch.cat([o.flatten() for o in PCB.fusion_block_plain(v, a, wf, heads)])
        assert rel(out, ref.numpy()) > 1e-2, fault


def test_block_weights_name_the_operands():
    """Float block: weights under TOWER's names; int8 block: the int8 weights
    with their scales; the adapters of both streams and both gates."""
    C, heads, _, _, _, blk = _setup("c32_h4", "float32", int8=False)
    _, _, _, _, _, blk_q = _setup("c32_h4", "float32", int8=True)
    w, wq = PCB.block_weights(blk), PCB.block_weights(blk_q)
    assert not any(sk in w for _, sk, _ in TOWER)
    assert set(wq) == set(w) | {sk for _, sk, _ in TOWER}
    for wk, sk, bk in TOWER:
        assert wq[wk].dtype == torch.int8 and wq[sk].shape == wq[bk].shape
        assert w[wk].dtype == torch.float32
    D = C // 4
    for key, _ in PCB.ADAPTERS:
        assert w[f"{key}_w1"].shape == (D, C) and w[f"{key}_w2"].shape == (C, D)
    assert w["sv_w1"] is blk.S_Adapter.D_fc1.weight
    assert w["ma_w2"] is blk.MLP_Adapter_Audio.D_fc2.weight
    assert w["w1"] is blk.mlp.c_fc.weight and w["gate_a"] is blk.gate_a


# ---------------------------------------------------------------------------
# K13
# ---------------------------------------------------------------------------

TADAPT = {"T10_no_pad": 10, "T3_padded_to_16": 3}


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("frames", sorted(TADAPT))
@pytest.mark.parametrize("adapter", ["T_Adapter", "T_Adapter_Audio"])
def test_tadapt_plain_matches_jax_kernel(monkeypatch, adapter, frames, dtype):
    clear_opt_ins(monkeypatch)
    C, heads, jdt, tdt, p, blk = _setup("c32_h4", dtype, int8=False, seed=2)
    x = (np.random.RandomState(3).randn(13, TADAPT[frames], C) * 0.5).astype(np.float32)
    ref = CB._tadapt_pallas(p["attn"], p["ln_1"], p[adapter], jnp.asarray(x).astype(jdt), heads)
    FA.reset_launches()
    with torch.inference_mode():
        out = PCB.clip_temporal_adapt_block(blk.attn, blk.ln_1, getattr(blk, adapter), t(x, tdt),
                                            heads)
    _no_launches()
    assert out.dtype == tdt and out.shape == x.shape
    assert rel(out, np.asarray(ref, np.float32)) < TOL[dtype]
    # the T_Adapter is live: without it the output is x itself
    assert rel(out, x) > 1e-2


@pytest.mark.parametrize("exact_recip", [True, False])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("frames", sorted(TADAPT))
def test_tadapt_q_plain_matches_jax_kernel(monkeypatch, frames, dtype, exact_recip):
    clear_opt_ins(monkeypatch)
    if exact_recip:
        exact_reciprocal(monkeypatch)
    C, heads, jdt, tdt, p, blk = _setup("c64_h2", dtype, int8=True, seed=4)
    x = (np.random.RandomState(5).randn(13, TADAPT[frames], C) * 0.5).astype(np.float32)
    ref = CB._tadapt_pallas(p["attn"], p["ln_1"], p["T_Adapter"], jnp.asarray(x).astype(jdt),
                            heads)
    with torch.inference_mode():
        out = PCB.clip_temporal_adapt_block(blk.attn, blk.ln_1, blk.T_Adapter, t(x, tdt), heads)
    assert out.dtype == tdt
    if dtype == "float32" and exact_recip:
        rows_agree(out, np.asarray(ref))
    else:
        assert rel(out, np.asarray(ref, np.float32)) < TOL_INTERP


def test_tadapt_weights_name_the_operands():
    _, _, _, _, _, blk = _setup("c32_h4", "float32", int8=True)
    w = PCB.tadapt_weights(blk.attn, blk.ln_1, blk.T_Adapter_Audio)
    assert set(w) == {"ln1_w", "ln1_b", "w_qkv", "s_qkv", "b_qkv", "w_proj", "s_proj", "b_proj",
                      "ad_w1", "ad_b1", "ad_w2", "ad_b2"}
    assert w["ad_w2"] is blk.T_Adapter_Audio.D_fc2.weight and w["w_qkv"].dtype == torch.int8


# ---------------------------------------------------------------------------
# the wrappers
# ---------------------------------------------------------------------------

def test_wrappers_register_under_their_ids_and_refuse_strided_input():
    ids = {k.name: k.id for k in FA.KERNELS}
    assert ids["clip_fusion_block (K12)"] == ids["clip_fusion_block_q (K12)"] == "K12"
    assert ids["clip_tadapt (K13)"] == ids["clip_tadapt_q (K13)"] == "K13"
    assert {"K12", "K13"} <= set(FA.launches_by_id())
    C, heads, _, _, _, blk = _setup("c32_h4", "float32", int8=False)
    v, a = (t(x) for x in _streams(C))
    with pytest.raises(ValueError, match="contiguous"):
        PCB.clip_fusion_block(v.transpose(0, 1), a, PCB.block_weights(blk), heads)
    with pytest.raises(ValueError, match="contiguous"):
        PCB.clip_tadapt(v.transpose(0, 1), PCB.tadapt_weights(blk.attn, blk.ln_1, blk.T_Adapter),
                        heads)


@pytest.mark.parametrize("D", [16, 32, 48, 64])
def test_fusion_widths_cover_the_adapter_widths_of_the_models(D):
    """The widths `csrc/fuse.cu` instantiates: CLIP-B/16's 768 * 0.0625 = 48
    beside Swin-Base's 16, 32 and 64."""
    assert D in FA.FUSE_WIDTHS
    assert int(ClipConfig().embed_dim * ClipConfig().adapter_ratio) == 48
