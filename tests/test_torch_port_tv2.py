"""The transpose-free temporal kernel K14 (`STGCMA_TV2=1`) and the unscaled
attention K10 (the full-grid fusion's fallback route) against the JAX
package, at tiny sizes on the CPU.

- K14: the plain versions `tv2_plain` / `tv2_q_plain`
  (stgcma_tpu_torch/ops/clip_block.py), through the entry point
  `temporal_adapt_v2`, against `pallas_attn.py::temporal_adapt_v2`, which
  reaches `_tv2_pallas` in interpret mode on the CPU (only the JAX tower's
  `_t_adapt` refuses the route there): T = 10 and T = 3 frames (JAX pads T to
  16 and packs 8 tokens into one gram), odd token counts (JAX pads N to a
  multiple of 16), with a live T_Adapter, and with a (heads, T, T) bias and
  no adapter; float and int8, fp32 and bf16. In bf16 the plain version
  rounds where the JAX kernel does, which K13's rounding points would not.
- A tiny CLIP `fusion` AVE with `STGCMA_TV2=1`, float and int8, against a
  JAX reference that takes `temporal_adapt_v2` at every temporal site (the
  JAX `_t_adapt` monkeypatched to it) and its kernels in interpret mode for
  the rest of each block, and against the stock JAX CPU path (XLA).
- The launch counts of the CLIP tower with `STGCMA_TV2=1` under every
  combination of the other three switches, counted on a tiny forward.
- K10: `unscaled_attention_plain` against `_attn_fwd_pallas` in interpret
  mode (JAX pads the keys to 128 and masks them); the K10 route of
  `cross_modal_fuse_flash` against JAX's two-call composition; a tiny Swin
  `fusion` AVE at 84^2, whose 21x21 stage grid takes the K10 route, against
  JAX at both of its routes; the Swin launch counts with K10.

Tolerances (max abs error over max |ref|):
- float, fp32: 1e-5 (the same arithmetic; summation order, and the JAX
  kernels' A&S erf against torch.erf, < 2e-7);
- float, bf16: 2e-2 (both round to bf16 at the same points; a last-bit
  difference of a sum rounds an intermediate the other way);
- int8, fp32, with the JAX reciprocal made correctly rounded as the port's
  (`rows_agree`): every row within 1e-5 but for one-step code moves; int8 in
  bf16, or with interpret mode's bf16-emulated reciprocal: 3e-2;
- the tiny AVEs' logits, fp32: 1e-5 float; int8 1e-3 against the JAX kernels
  (room for a one-step code flip) and 1e-2 against the stock XLA path, which
  quantizes activations with another floor and an exact divide;
- bf16 serving with the switch against the default configuration of the
  port itself: 2e-2 (the two temporal routes round at other points).
"""
import dataclasses
import itertools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from stgcma_tpu.configs import ClipConfig as JaxClipConfig
from stgcma_tpu.configs import swin_tiny_test as jax_swin_tiny_test
from stgcma_tpu.models import ave as jax_ave
from stgcma_tpu.nn import clip_vit as jax_clip
from stgcma_tpu.nn.clip_vit import clip_block_init
from stgcma_tpu.ops import pallas_attn as PA
from stgcma_tpu.ops import quant as jax_quant
from stgcma_tpu.ops.common import cast_tree as jax_cast_tree
from stgcma_tpu_torch.checkpoint.convert import clip_ave_from_jax, params_from_jax, \
    swin_ave_from_jax
from stgcma_tpu_torch.configs import ClipConfig, clip_b16, swin_base, swin_tiny_test
from stgcma_tpu_torch.models.ave import apply_clip_ave, apply_swin_ave, random_clip_ave, \
    random_swin_ave
from stgcma_tpu_torch.nn import clip_vit, swin
from stgcma_tpu_torch.nn.clip_vit import ClipBlock
from stgcma_tpu_torch.ops import clip_block as PCB
from stgcma_tpu_torch.ops import fused_attn as FA
from stgcma_tpu_torch.ops import quant
from stgcma_tpu_torch.ops.fused_attn import _erf_gelu
from stgcma_tpu_torch.ops.quant import quantize_clip_tower
from stgcma_tpu_torch.ops.swin_block import _lin
from stgcma_tpu_torch.serving import MultiTaskServer

from torch_port_helpers import clear_opt_ins, exact_reciprocal, rel, rows_agree, t, \
    to_numpy_tree

TOL = {"float32": 1e-5, "bfloat16": 2e-2}
TOL_INTERP = 3e-2
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}
TOWER_LINEARS = (("attn", "in_proj"), ("attn", "out_proj"), ("mlp", "c_fc"), ("mlp", "c_proj"))
TV2 = "STGCMA_TV2"
OTHER_SWITCHES = ("STGCMA_CLIP_TADAPT_FUSED", "STGCMA_CLIP_WHOLE_BLOCK", "STGCMA_QFUSE_ADAPTERS")
TINY = dict(embed_dim=64, heads=4, layers=2, input_resolution=80, patch_size=16,
            num_frames=2, audio_tdim=48, audio_fdim=32, adapter_ratio=0.25, label_dim=7)
# a Swin fusion tower whose 21x21 stage grid (441 tokens, not a multiple of
# 16) takes the full-grid fusion's K10 route
SWIN84 = dict(img_size=84, depths=(2,), num_heads=(2,), adapter_ratios=(0.25,), ftmode="fusion",
              label_dim=7)


# ---------------------------------------------------------------------------
# K14
# ---------------------------------------------------------------------------

C, HEADS = 64, 2
# (T, N, adapter, bias): T = 10 (80 tokens a JAX pack) and T = 3 (padded to
# 16), N = 21 and 13 (padded to 32 and 16)
TV2_CASES = {"T10_adapter": (10, 21, True, False), "T3_adapter": (3, 13, True, False),
             "T10_bias_no_adapter": (10, 21, False, True)}


def _tv2_setup(dtype, int8, seed=0):
    """A JAX fusion-mode CLIP block with every leaf random (a T_Adapter whose
    GELU runs through both branches), and the port's ClipBlock holding the
    same weights, loaded strictly."""
    jdt, tdt = DTYPES[dtype]
    cfg = JaxClipConfig(embed_dim=C, layers=1, heads=HEADS, adapter_ratio=0.25, ftmode="fusion")
    shapes = jax.eval_shape(lambda: clip_block_init(jax.random.PRNGKey(0), cfg, "fusion_adapt"))
    rng = np.random.RandomState(seed)
    p = jax.tree_util.tree_map(
        lambda x: jnp.asarray((rng.randn(*x.shape) * 0.1).astype(np.float32)), shapes)
    p["ln_1"]["scale"] = p["ln_1"]["scale"] + 1.0
    p["T_Adapter"]["D_fc1"]["kernel"] = p["T_Adapter"]["D_fc1"]["kernel"] * 3.0
    blk = ClipBlock(ClipConfig(embed_dim=C, layers=1, heads=HEADS, adapter_ratio=0.25),
                    "fusion_adapt")
    if int8:
        for mod, name in TOWER_LINEARS:
            p[mod] = {**p[mod], name: jax_quant.quantize_linear_params(p[mod][name])}
            setattr(getattr(blk, mod), name,
                    quant.quantize_linear_params(getattr(getattr(blk, mod), name)))
    blk.load_state_dict(params_from_jax(to_numpy_tree(p)), strict=True)
    return jax_cast_tree(p, jdt), blk.to(tdt), jdt, tdt


def _tv2_both(case, dtype, int8):
    """(port output, JAX kernel output as fp32 numpy, x) of one K14 case."""
    T, N, with_adapter, with_bias = TV2_CASES[case]
    p, blk, jdt, tdt = _tv2_setup(dtype, int8)
    rng = np.random.RandomState(1)
    x = (rng.randn(3 * T, N, C) * 0.5).astype(np.float32)
    bias = rng.randn(HEADS, T, T).astype(np.float32) if with_bias else None
    ref = PA.temporal_adapt_v2(p["attn"], p["ln_1"], p["T_Adapter"] if with_adapter else None,
                               jnp.asarray(x).astype(jdt), HEADS, T,
                               bias=None if bias is None else jnp.asarray(bias))
    FA.reset_launches()
    with torch.inference_mode():
        out = PCB.temporal_adapt_v2(blk.attn, blk.ln_1, blk.T_Adapter if with_adapter else None,
                                    t(x, tdt), HEADS, T, bias=None if bias is None else t(bias))
    assert all(k.launches == 0 for k in FA.KERNELS)   # plain versions on the CPU
    assert out.dtype == tdt and out.shape == x.shape
    return out, np.asarray(ref, np.float32), x


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("case", sorted(TV2_CASES))
def test_tv2_plain_matches_jax_kernel(monkeypatch, case, dtype):
    clear_opt_ins(monkeypatch)
    out, ref, x = _tv2_both(case, dtype, int8=False)
    assert rel(out, ref) < TOL[dtype]
    if TV2_CASES[case][2]:          # the T_Adapter is live: x + adapter moves x
        assert rel(out, x) > 1e-2


@pytest.mark.parametrize("exact_recip", [True, False])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("case", ["T10_adapter", "T10_bias_no_adapter"])
def test_tv2_q_plain_matches_jax_kernel(monkeypatch, case, dtype, exact_recip):
    clear_opt_ins(monkeypatch)
    if exact_recip:
        exact_reciprocal(monkeypatch)
    out, ref, _ = _tv2_both(case, dtype, int8=True)
    if dtype == "float32" and exact_recip:
        rows_agree(out, ref)
    else:
        assert rel(out, ref) < TOL_INTERP


def test_tv2_rounds_at_its_own_points_not_k13s(monkeypatch):
    """In bf16 the plain version gives the JAX kernel's bits but for a few
    last-bit moves, while the same stage rounded at K13's points (the adapter
    hidden rounded before the GELU as well as after it, the adapter term
    rounded before the residual add) moves a large share of them: the
    comparison above sees the rounding points, not only the function."""
    clear_opt_ins(monkeypatch)
    T, N = TV2_CASES["T10_adapter"][:2]
    p, blk, jdt, tdt = _tv2_setup("bfloat16", int8=False)
    x = t((np.random.RandomState(1).randn(3 * T, N, C) * 0.5).astype(np.float32), tdt)
    ref = np.asarray(PA.temporal_adapt_v2(p["attn"], p["ln_1"], p["T_Adapter"],
                                          jnp.asarray(x.float().numpy()).astype(jdt), HEADS, T),
                     np.float32)
    w = {k: v.detach() for k, v in PCB.tadapt_weights(blk.attn, blk.ln_1, blk.T_Adapter).items()}
    with torch.inference_mode():
        out = PCB.tv2_plain(x, w, HEADS, T)
        o = PCB.tv2_plain(x, {k: v for k, v in w.items() if not k.startswith("ad_")}, HEADS, T)
        h = _erf_gelu(_lin(o, w["ad_w1"], w["ad_b1"], tdt).float()).to(tdt)
        at_k13_points = x + _lin(h, w["ad_w2"], w["ad_b2"], tdt)
    moved = int((out.float().numpy() != ref).sum())
    moved_k13 = int((at_k13_points.float().numpy() != ref).sum())
    assert moved < 0.01 * ref.size and moved_k13 > 0.1 * ref.size, (moved, moved_k13, ref.size)


def test_tv2_entry_routes_on_the_tower_and_refuses_strided_input(monkeypatch):
    """`temporal_adapt_v2` takes `clip_tv2_q` for an int8 tower and
    `clip_tv2` else, both under the id K14; without an adapter the weights
    carry none."""
    seen = []
    for kern in (PCB.clip_tv2, PCB.clip_tv2_q):
        def spy(*args, _plain=kern.plain, _name=kern.name, **kw):
            seen.append(_name)
            return _plain(*args, **kw)
        monkeypatch.setattr(kern, "plain", spy)
    x = t(np.random.RandomState(0).randn(6, 5, C).astype(np.float32))
    with torch.inference_mode():
        for int8 in (False, True):
            _, blk, _, _ = _tv2_setup("float32", int8)
            PCB.temporal_adapt_v2(blk.attn, blk.ln_1, blk.T_Adapter, x, HEADS, 3)
    assert seen == ["clip_tv2 (K14)", "clip_tv2_q (K14)"]
    assert PCB.clip_tv2.id == PCB.clip_tv2_q.id == "K14" and "K14" in FA.launches_by_id()
    w = PCB.tadapt_weights(blk.attn, blk.ln_1, None)
    assert not any(k.startswith("ad_") for k in w) and w["w_qkv"].dtype == torch.int8
    with pytest.raises(ValueError, match="contiguous"):
        PCB.clip_tv2(x.transpose(0, 1), w, HEADS, 3)


# ---------------------------------------------------------------------------
# the CLIP tower with STGCMA_TV2=1
# ---------------------------------------------------------------------------

def _clip_params(int8, seed=11):
    cfg = JaxClipConfig(ftmode="fusion", **TINY)
    shapes = jax.eval_shape(lambda: jax_ave.init_clip_ave(jax.random.PRNGKey(0), cfg))
    rng = np.random.RandomState(seed)
    params = jax.tree_util.tree_map(
        lambda x: jnp.asarray((rng.randn(*x.shape) * 0.05).astype(np.float32)), shapes)
    if int8:
        params = dict(params)
        params["backbone"] = jax_quant.quantize_clip_tower(params["backbone"])
    return cfg, params


def _clip_inputs(B=2, seed=7):
    rng = np.random.RandomState(seed)
    a = rng.randn(B, TINY["num_frames"], TINY["audio_tdim"], TINY["audio_fdim"])
    v = rng.randn(B, TINY["num_frames"], TINY["input_resolution"],
                  TINY["input_resolution"], 3)
    return a.astype(np.float32), v.astype(np.float32)


def _jax_clip(params, cfg, a, v):
    """The JAX tower, jitted (eager dispatch of its interpret-mode kernels is
    several times slower); the routes are read while it traces."""
    return np.asarray(jax.jit(lambda p, a, v: jax_ave.apply_clip_ave(p, cfg, a, v))(
        params, jnp.asarray(a), jnp.asarray(v)))


def _jax_tv2_reference(monkeypatch, params, cfg, a, v):
    """The JAX tower with `temporal_adapt_v2` (K14 in interpret mode) at every
    temporal site and its kernels in interpret mode for the rest of each
    block (STGCMA_FUSED_ATTN=1, no resident pad, as in the port)."""
    with monkeypatch.context() as m:
        m.setattr(jax_clip, "_t_adapt", lambda p, x, heads, T, key: PA.temporal_adapt_v2(
            p["attn"], p["ln_1"], p[key], x, heads, T))
        m.setenv("STGCMA_FUSED_ATTN", "1")
        m.setenv("STGCMA_RESIDENT_PAD", "0")
        return _jax_clip(params, cfg, a, v)


def _port_clip(monkeypatch, params, a, v):
    clear_opt_ins(monkeypatch)
    monkeypatch.setenv(TV2, "1")
    cfg = ClipConfig(ftmode="fusion", **TINY)
    model = clip_ave_from_jax(cfg, to_numpy_tree(params), device="cpu")
    seen = []
    for kern in (PCB.clip_tv2, PCB.clip_tv2_q):
        def spy(*args, _plain=kern.plain, _name=kern.name, **kw):
            seen.append(_name)
            return _plain(*args, **kw)
        monkeypatch.setattr(kern, "plain", spy)
    with torch.inference_mode():
        out = apply_clip_ave(model, cfg, t(a), t(v)).numpy()
    assert len(seen) == 2 * cfg.layers      # both temporal sites of every block
    return out


@pytest.mark.parametrize("int8", [False, True])
def test_tv2_slice_matches_jax_block_by_block_and_stock(monkeypatch, int8):
    clear_opt_ins(monkeypatch)
    if int8:
        exact_reciprocal(monkeypatch)
    cfg, params = _clip_params(int8)
    a, v = _clip_inputs()
    stock = _jax_clip(params, cfg, a, v)
    ref = _jax_tv2_reference(monkeypatch, params, cfg, a, v)
    out = _port_clip(monkeypatch, params, a, v)
    assert out.shape == (2 * TINY["num_frames"], TINY["label_dim"]) and np.isfinite(out).all()
    assert rel(out, ref) < (1e-3 if int8 else 1e-5)
    assert rel(out, stock) < (1e-2 if int8 else 1e-5)


@pytest.mark.parametrize("int8", [False, True])
def test_tv2_server_on_cpu_is_close_to_the_default_one(monkeypatch, int8):
    """bf16 serving through MultiTaskServer(device="cpu"): the switch is read
    at call time, so one server gives both temporal routes."""
    clear_opt_ins(monkeypatch)
    cfg = ClipConfig(ftmode="fusion", **TINY)
    model = random_clip_ave(cfg, 3)
    if int8:
        model.backbone = quantize_clip_tower(model.backbone)
    srv = MultiTaskServer(device="cpu")
    srv.add_clip_ave("ave", cfg, model)
    a, v = _clip_inputs(B=1)
    default = srv.predict("ave", {"a": a, "v": v})
    monkeypatch.setenv(TV2, "1")
    tv2 = srv.predict("ave", {"a": a, "v": v})
    assert tv2.dtype == np.float32 and tv2.shape == default.shape and np.isfinite(tv2).all()
    assert rel(tv2, default) < 2e-2


COMBOS = [(m, q, c) for m in ("fusion", "multimodal") for q in (False, True)
          for c in itertools.product("01", repeat=len(OTHER_SWITCHES))]


@pytest.mark.parametrize("ftmode,int8,others", COMBOS,
                         ids=[f"{m}-{'int8' if q else 'float'}-{''.join(c)}" for m, q, c in COMBOS])
def test_tv2_launch_counts_match_the_forward(monkeypatch, ftmode, int8, others):
    """With `STGCMA_TV2=1` and the other switches as given (TADAPT_FUSED,
    WHOLE_BLOCK, QFUSE_ADAPTERS), `launches_per_forward` is what a tiny
    forward calls, each wrapper counted on the CPU through its plain
    version; the temporal sites follow qfuse (int8 only) > TV2 > K13."""
    clear_opt_ins(monkeypatch)
    monkeypatch.setenv(TV2, "1")
    for k, on in zip(OTHER_SWITCHES, others):
        monkeypatch.setenv(k, on)
    calls = {}
    for kern in FA.KERNELS:
        def counted(*args, _plain=kern.plain, _id=kern.id, **kw):
            calls[_id] = calls.get(_id, 0) + 1
            return _plain(*args, **kw)
        monkeypatch.setattr(kern, "plain", counted)
    cfg = ClipConfig(ftmode=ftmode, **TINY)
    model = random_clip_ave(cfg, 0)
    if int8:
        model.backbone = quantize_clip_tower(model.backbone)
    a, v = _clip_inputs(B=1)
    with torch.inference_mode():
        apply_clip_ave(model, cfg, t(a), t(v))
    assert calls == clip_vit.launches_per_forward(cfg, quantized=int8)
    qfuse = int8 and others[2] == "1"
    assert calls.get("K14", 0) == (0 if qfuse else 2 * cfg.layers)
    assert "K13" not in calls


def test_tv2_launch_counts_of_clip_b16(monkeypatch):
    """CLIP ViT-B/16 fusion with the switch: the 24 temporal sites in K14,
    the 24 spatial ones in K1 (K2 + 24 K3 for int8); with the whole block
    K14 24 + K12 12; K11 still first for an int8 tower with QFUSE."""
    clear_opt_ins(monkeypatch)
    cfg = clip_b16(ftmode="fusion", label_dim=29)
    monkeypatch.setenv(TV2, "1")
    assert clip_vit.launches_per_forward(cfg) == {"K14": 24, "K1": 24}
    assert clip_vit.launches_per_forward(cfg, quantized=True) == {"K14": 24, "K2": 24, "K3": 24}
    monkeypatch.setenv("STGCMA_CLIP_TADAPT_FUSED", "1")
    assert clip_vit.launches_per_forward(cfg) == {"K14": 24, "K1": 24}
    monkeypatch.setenv("STGCMA_CLIP_WHOLE_BLOCK", "1")
    assert clip_vit.launches_per_forward(cfg) == {"K14": 24, "K12": 12}
    monkeypatch.setenv("STGCMA_QFUSE_ADAPTERS", "1")
    assert clip_vit.launches_per_forward(cfg, quantized=True) == {"K11": 24, "K12": 12}


def test_tv2_switch_is_read_at_call_time_and_default_off(monkeypatch):
    clear_opt_ins(monkeypatch)
    assert not clip_vit.tv2_enabled()
    monkeypatch.setenv(TV2, "1")
    assert clip_vit.tv2_enabled()


# ---------------------------------------------------------------------------
# K10
# ---------------------------------------------------------------------------

# (B, Nq, Nk, D): Nq != Nk, neither a multiple of 16, one past JAX's 256-row
# query tile and its 128-key pad
K10_SHAPES = {"37x21_d16": (2, 37, 21, 16), "300x130_d32": (1, 300, 130, 32)}


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("shape", sorted(K10_SHAPES))
def test_unscaled_attention_plain_matches_jax_kernel(monkeypatch, shape, dtype):
    clear_opt_ins(monkeypatch)
    Bk, Nq, Nk, D = K10_SHAPES[shape]
    jdt, tdt = DTYPES[dtype]
    rng = np.random.RandomState(3)
    q, k, v = (rng.randn(Bk, n, D).astype(np.float32) * 0.7 for n in (Nq, Nk, Nk))
    ref = PA._attn_fwd_pallas(*(jnp.asarray(a).astype(jdt) for a in (q, k, v)))
    FA.reset_launches()
    out = FA.unscaled_attention(t(q, tdt), t(k, tdt), t(v, tdt))
    assert FA.unscaled_attention.launches == 0
    assert out.dtype == tdt and out.shape == (Bk, Nq, D)
    assert rel(out, np.asarray(ref, np.float32)) < TOL[dtype]


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_k10_route_matches_jax_two_call_composition(monkeypatch, dtype):
    """At Nv = 130, Na = 70 (not multiples of 16) `cross_modal_fuse_flash`
    takes two K10 calls and the gated adds in torch, as
    `pallas_attn.py:1039-1044` does: against JAX's `unscaled_attention`
    twice (in interpret mode) and its gated adds, in the streams' dtype."""
    clear_opt_ins(monkeypatch)
    jdt, tdt = DTYPES[dtype]
    rng = np.random.RandomState(4)
    vh, ah = (rng.randn(2, n, 16).astype(np.float32) * 0.7 for n in (130, 70))
    gv, ga = np.array([0.8], np.float32), np.array([-0.6], np.float32)
    jv, ja, jgv, jga = (jnp.asarray(a).astype(jdt) for a in (vh, ah, gv, ga))
    ref = (jv + jgv.astype(jdt) * PA.unscaled_attention(jv, ja, ja),
           ja + jga.astype(jdt) * PA.unscaled_attention(ja, jv, jv))
    assert FA.flash_fuse_route(130, 70, 16) == "K10"
    calls = []
    for kern in (FA.unscaled_attention, FA.bidir_fuse):
        def spy(*args, _plain=kern.plain, _id=kern.id, **kw):
            calls.append(_id)
            return _plain(*args, **kw)
        monkeypatch.setattr(kern, "plain", spy)
    out = FA.cross_modal_fuse_flash(*(t(a, tdt) for a in (vh, ah, gv, ga)))
    assert calls == ["K10", "K10"]
    for o, r in zip(out, ref):
        assert o.dtype == tdt and rel(o, np.asarray(r, np.float32)) < TOL[dtype]


def _swin84_params(seed=13):
    cfg = jax_swin_tiny_test(**SWIN84)
    params = jax.eval_shape(lambda: jax_ave.init_swin_ave(jax.random.PRNGKey(0), cfg))
    rng = np.random.RandomState(seed)

    def draw(path, x):
        name = jax.tree_util.keystr(path)
        s = 1.0 if ("bias_table" in name or "gate_" in name) else 0.05
        return jnp.asarray((rng.randn(*x.shape) * s).astype(np.float32))
    return cfg, jax.tree_util.tree_map_with_path(draw, params)


def test_swin_fusion_on_the_k10_route_matches_jax(monkeypatch):
    """The tiny Swin `fusion` AVE at 84^2: its 441-token stage grid takes the
    K10 route (twice a block: a2v and v2a), against JAX with fused attention
    on (its fusions on the CPU: XLA's `cross_modal_fuse`) and off."""
    clear_opt_ins(monkeypatch)
    cfg, params = _swin84_params()
    rng = np.random.RandomState(7)
    n, T = SWIN84["img_size"], 2
    a, v = rng.randn(1, T, n, n).astype(np.float32), rng.randn(1, T, n, n, 3).astype(np.float32)
    pcfg = swin_tiny_test(**SWIN84)
    model = swin_ave_from_jax(pcfg, to_numpy_tree(params), device="cpu")
    calls = []

    def spy(*args, _plain=FA.unscaled_attention.plain, **kw):
        calls.append(1)
        return _plain(*args, **kw)
    monkeypatch.setattr(FA.unscaled_attention, "plain", spy)
    with torch.inference_mode():
        out = apply_swin_ave(model, pcfg, t(a), t(v)).numpy()
    assert len(calls) == swin.launches_per_forward(pcfg, B=1, itemsize=4)["K10"] == 4
    for fused in ("1", "0"):
        monkeypatch.setenv("STGCMA_FUSED_ATTN", fused)
        ref = jax.jit(lambda p, a, v: jax_ave.apply_swin_ave(p, cfg, a, v))(params, a, v)
        assert rel(out, np.asarray(ref)) < 1e-5, fused


def test_swin_launch_counts_count_k10(monkeypatch):
    """`launches_per_forward` counts K10 twice a block at a stage whose
    full-grid exchange takes the K10 route: the tiny tower at 84^2 against
    its counted forward, and Swin-Base cut to 168^2 (stage grids 42^2 and
    21^2, both on the K10 route) by its derived counts."""
    clear_opt_ins(monkeypatch)
    calls = {}
    for kern in FA.KERNELS:
        def counted(*args, _plain=kern.plain, _id=kern.id, **kw):
            calls[_id] = calls.get(_id, 0) + 1
            return _plain(*args, **kw)
        monkeypatch.setattr(kern, "plain", counted)
    cfg = swin_tiny_test(**SWIN84)
    rng = np.random.RandomState(0)
    a, v = rng.randn(1, 2, 84, 84).astype(np.float32), rng.randn(1, 2, 84, 84, 3).astype(np.float32)
    with torch.inference_mode():
        apply_swin_ave(random_swin_ave(cfg, 0), cfg, t(a), t(v))
    derived = swin.launches_per_forward(cfg, B=1, itemsize=4)
    assert {k: n for k, n in derived.items() if n} == calls
    assert calls["K10"] == 4 and "K6" not in calls
    cut = dataclasses.replace(swin_base(ftmode="fusion", label_dim=29), img_size=168,
                              depths=(2, 2), num_heads=(4, 8), adapter_ratios=(0.125, 0.125))
    assert swin.launches_per_forward(cut, B=8) == {
        "K1": 12, "K7": 4, "K8": 0, "K9": 6, "K4": 0, "K5": 4, "K6": 0, "K10": 8}
    # where no stage takes the route, no K10 is listed
    assert "K10" not in swin.launches_per_forward(swin_base(ftmode="fusion"), B=8)
