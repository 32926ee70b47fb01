"""The port's CLIP tower in the fused-block configuration (K13 + K12) and in
its `videoonly`, `audioonly` and `multimodal` modes against the JAX package,
at a tiny size on the CPU.

Fused configuration: `STGCMA_CLIP_TADAPT_FUSED=1` and
`STGCMA_CLIP_WHOLE_BLOCK=1`, where a `fusion` block is K13 on the video
rows, K13 on the audio rows and K12. On the CPU the JAX package does not
reach those kernels (`jax.default_backend() != "cpu"` in `_t_adapt` and
`_fusion`), so the reference is built block by block from the JAX package's
own pieces: `_embed`, `_tadapt_pallas` and `_fusion_pallas` in interpret mode
for each block, `_ln_post_cls` and the head. The same model is also held
against the stock JAX CPU path (XLA; for the int8 tower also against the JAX
kernels K2/K3 in interpret mode, the same arithmetic in fp32). The other
modes are held against `apply_clip_ave` of the JAX package with its kernels
in interpret mode (STGCMA_FUSED_ATTN=1, resident pad on) and on its XLA path.
Weights cross over through `params_from_jax` (`clip_ave_from_jax`), loaded
strictly.

Tolerances (max abs error over max |ref| of the logits):
- float towers, fp32, every reference: 1e-5 (summation order only; measured
  2.7e-7);
- int8 towers against the JAX kernels with their reciprocal made correctly
  rounded, as the port's: 1e-3 against K13 + K12 block by block (measured
  4.0e-7) and for the other modes against K2/K3, room for a one-step code
  flip; 3e-3 for the fused configuration against K2/K3 (measured 7.3e-4: the
  two sides' LayerNorms differ in the last ulp, and one int8 code moved);
- int8 towers against the stock JAX CPU path, which quantizes activations
  with another floor and an exact divide (`quant.py::int8_matmul`): 1e-2, room
  for the one-step code moves of two blocks (measured 3.1e-7: the same codes
  on these inputs);
- bf16 serving, fused against unfused configuration of the port itself: 2e-2
  (the fused float FFN rounds its hidden once, the unfused one before and
  after QuickGELU).
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from stgcma_tpu.configs import ClipConfig as JaxClipConfig
from stgcma_tpu.models import ave as jax_ave
from stgcma_tpu.nn import clip_vit as jax_clip
from stgcma_tpu.ops import pallas_clip_block as CB
from stgcma_tpu.ops.quant import quantize_clip_tower as jax_quantize_clip_tower
from stgcma_tpu_torch.checkpoint.convert import clip_ave_from_jax, params_from_jax
from stgcma_tpu_torch.configs import ClipConfig, clip_b16, clip_l14
from stgcma_tpu_torch.models.ave import (MlpHead, SingleHead, apply_clip_ave, init_clip_ave,
                                         random_clip_ave)
from stgcma_tpu_torch.nn import clip_vit
from stgcma_tpu_torch.ops import clip_block as PCB
from stgcma_tpu_torch.ops import fused_attn as FA
from stgcma_tpu_torch.ops.quant import quantize_clip_tower
from stgcma_tpu_torch.serving import MultiTaskServer

from torch_port_helpers import clear_opt_ins, exact_reciprocal, rel, t, to_numpy_tree

TINY = dict(embed_dim=64, heads=4, layers=2, input_resolution=80, patch_size=16,
            num_frames=2, audio_tdim=48, audio_fdim=32, adapter_ratio=0.25, label_dim=7)
MODES = ("fusion", "multimodal", "videoonly", "audioonly")
SWITCHES = ("STGCMA_CLIP_TADAPT_FUSED", "STGCMA_CLIP_WHOLE_BLOCK")


def _params(ftmode, int8, seed=11):
    """Random, non-trivial weights (gates and D_fc2 non-zero) from a seed."""
    cfg = JaxClipConfig(ftmode=ftmode, **TINY)
    shapes = jax.eval_shape(lambda: jax_ave.init_clip_ave(jax.random.PRNGKey(0), cfg))
    rng = np.random.RandomState(seed)
    params = jax.tree_util.tree_map(
        lambda x: jnp.asarray((rng.randn(*x.shape) * 0.05).astype(np.float32)), shapes)
    if int8:
        params = dict(params)
        params["backbone"] = jax_quantize_clip_tower(params["backbone"])
    return cfg, params


def _inputs(B=2, seed=7):
    rng = np.random.RandomState(seed)
    a = rng.randn(B, TINY["num_frames"], TINY["audio_tdim"], TINY["audio_fdim"])
    v = rng.randn(B, TINY["num_frames"], TINY["input_resolution"],
                  TINY["input_resolution"], 3)
    return a.astype(np.float32), v.astype(np.float32)


def _fused(monkeypatch, on=True):
    for k in SWITCHES:
        monkeypatch.setenv(k, "1" if on else "0")


def _port(ftmode, params, a, v):
    cfg = ClipConfig(ftmode=ftmode, **TINY)
    model = clip_ave_from_jax(cfg, to_numpy_tree(params), device="cpu")
    FA.reset_launches()
    with torch.inference_mode():
        out = apply_clip_ave(model, cfg, t(a), t(v)).numpy()
    assert all(k.launches == 0 for k in FA.KERNELS)   # plain versions on the CPU
    return out


def _jax_fused_reference(params, cfg, a, v):
    """The fused configuration block by block: the JAX package's embed, its
    K13 and K12 launchers in interpret mode, its ln_post and head."""
    T, h = cfg.num_frames, cfg.heads

    def t_adapt(p, x, key):
        BT, N, C = x.shape
        xt = x.reshape(BT // T, T, N, C).transpose(0, 2, 1, 3).reshape(-1, T, C)
        xt = CB._tadapt_pallas(p["attn"], p["ln_1"], p[key], xt, h)
        return xt.reshape(BT // T, N, T, C).transpose(0, 2, 1, 3).reshape(BT, N, C)

    @jax.jit
    def run(params, a, v):
        bp = params["backbone"]
        vt = jax_clip._embed(bp, v, "conv1", "positional_embedding", cfg)
        at = jax_clip._embed(bp, a[..., None], "conv1_audio", "positional_embedding_audio", cfg)
        for p in bp["resblocks"]:
            vt = t_adapt(p, vt, "T_Adapter")
            at = t_adapt(p, at, "T_Adapter_Audio")
            vt, at = CB._fusion_pallas(p, vt, at, h)
        pooled = jnp.concatenate([jax_clip._ln_post_cls(bp, at), jax_clip._ln_post_cls(bp, vt)],
                                 axis=-1)
        return jax_ave._mlp_head_apply(params["mlp_head"], pooled)
    return np.asarray(run(params, jnp.asarray(a), jnp.asarray(v)))


def _jax_stock(params, cfg, a, v):
    return np.asarray(jax_ave.apply_clip_ave(params, cfg, jnp.asarray(a), jnp.asarray(v)))


def _jax_kernels(monkeypatch, params, cfg, a, v):
    """The JAX package's default TPU route, its kernels in interpret mode."""
    monkeypatch.setenv("STGCMA_FUSED_ATTN", "1")
    monkeypatch.setenv("STGCMA_RESIDENT_PAD", "1")
    out = _jax_stock(params, cfg, a, v)
    monkeypatch.delenv("STGCMA_FUSED_ATTN")
    monkeypatch.delenv("STGCMA_RESIDENT_PAD")
    return out


# ---------------------------------------------------------------------------
# the fused configuration
# ---------------------------------------------------------------------------

def test_fused_float_slice_matches_jax_block_by_block_and_stock(monkeypatch):
    clear_opt_ins(monkeypatch)
    cfg, params = _params("fusion", int8=False)
    a, v = _inputs()
    ref = _jax_fused_reference(params, cfg, a, v)
    stock = _jax_stock(params, cfg, a, v)
    _fused(monkeypatch)
    out = _port("fusion", params, a, v)
    assert out.shape == (2 * TINY["num_frames"], TINY["label_dim"])
    assert rel(out, ref) < 1e-5
    assert rel(out, stock) < 1e-5


def test_fused_int8_slice_matches_jax_block_by_block_and_stock(monkeypatch):
    clear_opt_ins(monkeypatch)
    exact_reciprocal(monkeypatch)
    cfg, params = _params("fusion", int8=True)
    a, v = _inputs()
    ref = _jax_fused_reference(params, cfg, a, v)
    kernels = _jax_kernels(monkeypatch, params, cfg, a, v)
    stock = _jax_stock(params, cfg, a, v)
    _fused(monkeypatch)
    out = _port("fusion", params, a, v)
    assert np.isfinite(out).all()
    assert rel(out, ref) < 1e-3
    assert rel(out, kernels) < 3e-3
    assert rel(out, stock) < 1e-2


@pytest.mark.parametrize("int8", [False, True])
def test_fused_server_on_cpu_is_close_to_the_unfused_one(monkeypatch, int8):
    """bf16 serving through MultiTaskServer(device="cpu"): the switches are
    read at call time, so one server gives both configurations."""
    clear_opt_ins(monkeypatch)
    cfg = ClipConfig(ftmode="fusion", **TINY)
    model = random_clip_ave(cfg, 3)
    if int8:
        model.backbone = quantize_clip_tower(model.backbone)
    srv = MultiTaskServer(device="cpu")
    srv.add_clip_ave("ave", cfg, model)
    a, v = _inputs(B=1)
    unfused = srv.predict("ave", {"a": a, "v": v})
    _fused(monkeypatch)
    fused = srv.predict("ave", {"a": a, "v": v})
    assert fused.dtype == np.float32 and fused.shape == unfused.shape
    assert np.isfinite(fused).all()
    assert rel(fused, unfused) < 2e-2


# ---------------------------------------------------------------------------
# videoonly, audioonly, multimodal
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("ftmode", MODES[1:])
def test_float_modes_match_jax_kernels_and_xla(monkeypatch, ftmode):
    clear_opt_ins(monkeypatch)
    cfg, params = _params(ftmode, int8=False)
    a, v = _inputs()
    out = _port(ftmode, params, a, v)
    assert out.shape == (2 * TINY["num_frames"], TINY["label_dim"])
    assert rel(out, _jax_kernels(monkeypatch, params, cfg, a, v)) < 1e-5
    assert rel(out, _jax_stock(params, cfg, a, v)) < 1e-5
    _fused(monkeypatch)                       # K13 at the temporal sites of every mode
    assert rel(_port(ftmode, params, a, v), out) < 1e-5


@pytest.mark.parametrize("ftmode", MODES[1:])
def test_int8_modes_match_jax_kernels(monkeypatch, ftmode):
    clear_opt_ins(monkeypatch)
    exact_reciprocal(monkeypatch)
    cfg, params = _params(ftmode, int8=True)
    a, v = _inputs()
    out = _port(ftmode, params, a, v)
    assert np.isfinite(out).all()
    assert rel(out, _jax_kernels(monkeypatch, params, cfg, a, v)) < 1e-3
    _fused(monkeypatch)
    assert rel(_port(ftmode, params, a, v), out) < 1e-3


def test_single_stream_modes_need_only_their_stream(monkeypatch):
    clear_opt_ins(monkeypatch)
    a, v = _inputs(B=1)
    srv = MultiTaskServer(device="cpu", dtype=torch.float32)
    for ftmode, batch in (("videoonly", {"v": v}), ("audioonly", {"a": a})):
        cfg = ClipConfig(ftmode=ftmode, **TINY)
        model = random_clip_ave(cfg, 0)
        srv.add_clip_ave(ftmode, cfg, model)
        out = srv.predict(ftmode, batch)
        with torch.inference_mode():
            ref = apply_clip_ave(model, cfg, t(a), t(v)).numpy()
        np.testing.assert_array_equal(out, ref)


# ---------------------------------------------------------------------------
# modules, weights and routing
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("ftmode", MODES)
def test_clip_ave_from_jax_round_trip(ftmode, int8):
    """Every JAX leaf of every mode's tree lands in the port's state dict,
    which has no other entry (the mode's adapters only, the `ln`/`fc` head in
    the single-stream modes); linear kernels transposed, bit for bit."""
    cfg, params = _params(ftmode, int8)
    model = clip_ave_from_jax(ClipConfig(ftmode=ftmode, **TINY), to_numpy_tree(params), "cpu")
    sd = model.state_dict()
    leaves = jax.tree_util.tree_flatten_with_path(params)[0]
    assert len(leaves) == len(sd)
    blk, jblk = model.backbone.resblocks[0], params["backbone"]["resblocks"][0]
    assert ({n for n, _ in blk.named_children() if "Adapter" in n}
            == {k for k in jblk if "Adapter" in k} == set(clip_vit.adapter_names(
                clip_vit.MODES[ftmode])))
    assert blk.attn.in_proj.quantized == int8
    single = ftmode in ("videoonly", "audioonly")
    assert isinstance(model.mlp_head, SingleHead if single else MlpHead)
    head = "fc" if single else "fc2"
    np.testing.assert_array_equal(sd[f"mlp_head.{head}.weight"].numpy(),
                                  np.asarray(params["mlp_head"][head]["kernel"]).T)
    key = "kernel_q" if int8 else "kernel"
    np.testing.assert_array_equal(
        sd[f"backbone.resblocks.1.mlp.c_fc.{'weight_q' if int8 else 'weight'}"].numpy(),
        np.asarray(params["backbone"]["resblocks"][1]["mlp"]["c_fc"][key]).T)


@pytest.mark.parametrize("ftmode", MODES)
def test_init_and_random_clip_ave_per_mode(ftmode):
    """`init_clip_ave` follows the JAX init in every mode (the same names and
    shapes as the JAX tree, zero D_fc2 and gates); `random_clip_ave` is seeded
    and live."""
    cfg = ClipConfig(ftmode=ftmode, **TINY)
    model = init_clip_ave(cfg, torch.Generator().manual_seed(1), device="cpu")
    jax_params = jax.eval_shape(lambda: jax_ave.init_clip_ave(
        jax.random.PRNGKey(0), JaxClipConfig(ftmode=ftmode, **TINY)))
    ref = params_from_jax(jax.tree_util.tree_map(lambda x: np.zeros(x.shape, np.float32),
                                                 jax_params))
    sd = model.state_dict()
    assert sorted(sd) == sorted(ref)
    assert all(sd[k].shape == ref[k].shape for k in sd)
    for name, p in model.named_parameters():
        if ".D_fc2.weight" in name or name.endswith(("gate_v", "gate_a", ".bias")):
            assert not p.any(), name
    m1, m2 = random_clip_ave(cfg, 3), random_clip_ave(cfg, 3)
    for (n, p1), p2 in zip(m1.named_parameters(), m2.parameters()):
        assert torch.equal(p1, p2), n
        assert p1.abs().max() > 0, n
    if ftmode in ("videoonly", "audioonly"):
        assert abs(float(m1.mlp_head.ln.weight.detach().mean()) - 1.0) < 0.1


CONFIGS = [(m, q, f) for m in MODES for q in (False, True) for f in (False, True)]


@pytest.mark.parametrize("ftmode,int8,fused", CONFIGS)
def test_launch_counts_match_the_forward(monkeypatch, ftmode, int8, fused):
    """`launches_per_forward` is what the forward calls: each wrapper is
    counted on the CPU through its plain version."""
    clear_opt_ins(monkeypatch)
    _fused(monkeypatch, fused)
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
    a, v = _inputs(B=1)
    with torch.inference_mode():
        apply_clip_ave(model, cfg, t(a), t(v))
    assert calls == clip_vit.launches_per_forward(cfg, quantized=int8)
    L, streams = cfg.layers, 1 if ftmode in ("videoonly", "audioonly") else 2
    if fused and ftmode == "fusion":          # a block is three kernels and nothing else
        assert calls == {"K13": 2 * L, "K12": L}
    elif fused:
        assert calls["K13"] == streams * L and "K12" not in calls
    else:
        assert "K12" not in calls and "K13" not in calls


def test_launch_counts_of_clip_b16(monkeypatch):
    clear_opt_ins(monkeypatch)
    cfg = clip_b16(ftmode="fusion", label_dim=29)
    assert clip_vit.launches_per_forward(cfg) == {"K1": 48}
    assert clip_vit.launches_per_forward(cfg, quantized=True) == {"K2": 48, "K3": 24}
    mm = clip_b16(ftmode="multimodal", label_dim=29)
    assert clip_vit.launches_per_forward(mm) == {"K1": 48}
    _fused(monkeypatch)
    assert clip_vit.launches_per_forward(cfg) == {"K13": 24, "K12": 12}
    assert clip_vit.launches_per_forward(cfg, quantized=True) == {"K13": 24, "K12": 12}
    assert clip_vit.launches_per_forward(mm, quantized=True) == {"K2": 24, "K3": 24, "K13": 24}
    assert clip_vit.launches_per_forward(clip_l14(ftmode="fusion")) == {"K13": 48, "K12": 24}


def test_switches_are_read_at_call_time_and_default_off(monkeypatch):
    clear_opt_ins(monkeypatch)
    assert not clip_vit.clip_tadapt_fused_enabled()
    assert not clip_vit.clip_whole_block_enabled()
    monkeypatch.setenv("STGCMA_CLIP_TADAPT_FUSED", "1")
    assert clip_vit.clip_tadapt_fused_enabled() and not clip_vit.clip_whole_block_enabled()
    monkeypatch.setenv("STGCMA_CLIP_WHOLE_BLOCK", "1")
    assert clip_vit.clip_whole_block_enabled()


@pytest.mark.parametrize("switch,int8", [("STGCMA_TV2", False), ("STGCMA_TV2", True)])
def test_unported_opt_ins_raise(monkeypatch, switch, int8):
    """The JAX package's opt-in that raised while its kernel was not ported
    (hence the name): `STGCMA_TV2=1` now takes the transpose-free temporal
    kernel K14 (`clip_tv2`, `clip_tv2_q` for an int8 tower) at every temporal
    site, and no K1/K2 there, never a silent default."""
    clear_opt_ins(monkeypatch)
    monkeypatch.setenv(switch, "1")
    cfg = ClipConfig(ftmode="fusion", **TINY)
    model = random_clip_ave(cfg, 0)
    if int8:
        model.backbone = quantize_clip_tower(model.backbone)
    seen = []
    for kern in FA.KERNELS:
        def spy(*args, _plain=kern.plain, _name=kern.name, **kw):
            seen.append(_name)
            return _plain(*args, **kw)
        monkeypatch.setattr(kern, "plain", spy)
    a, v = _inputs(B=1)
    with torch.inference_mode():
        out = apply_clip_ave(model, cfg, t(a), t(v))
    assert torch.isfinite(out).all()
    L, tv2 = cfg.layers, "clip_tv2_q (K14)" if int8 else "clip_tv2 (K14)"
    spatial = ["win_block_q (K2)"] * 2 * L + ["ffn_q (K3)"] * 2 * L if int8 else \
        ["win_block (K1)"] * 2 * L
    assert sorted(seen) == sorted([tv2] * 2 * L + spatial)


def test_qfuse_switch_takes_k11_on_an_int8_tower(monkeypatch):
    """`STGCMA_QFUSE_ADAPTERS=1` on an int8 tower takes K11 at every site of
    a fusion block, and no K2 or K3 (it raised while K11 was not ported)."""
    clear_opt_ins(monkeypatch)
    monkeypatch.setenv("STGCMA_QFUSE_ADAPTERS", "1")
    cfg = ClipConfig(ftmode="fusion", **TINY)
    model = random_clip_ave(cfg, 0)
    model.backbone = quantize_clip_tower(model.backbone)
    seen = []
    for kern in FA.KERNELS:
        def spy(*args, _plain=kern.plain, _name=kern.name, **kw):
            seen.append(_name)
            return _plain(*args, **kw)
        monkeypatch.setattr(kern, "plain", spy)
    a, v = _inputs(B=1)
    with torch.inference_mode():
        out = apply_clip_ave(model, cfg, t(a), t(v))
    assert torch.isfinite(out).all()
    L = cfg.layers
    assert sorted(seen) == sorted(["win_block_qd (K11)"] * 2 * L + ["win_block_qh (K11)"] * 2 * L
                                  + ["ffn_qh (K11)"] * 2 * L)


def test_qfuse_switch_is_ignored_by_a_float_tower_as_in_jax(monkeypatch):
    """`_qfuse_adapters` (`clip_vit.py:106`) is true for an int8 tower only."""
    clear_opt_ins(monkeypatch)
    cfg = ClipConfig(ftmode="fusion", **TINY)
    model = random_clip_ave(cfg, 0)
    a, v = _inputs(B=1)
    with torch.inference_mode():
        ref = apply_clip_ave(model, cfg, t(a), t(v))
        monkeypatch.setenv("STGCMA_QFUSE_ADAPTERS", "1")
        assert torch.equal(apply_clip_ave(model, cfg, t(a), t(v)), ref)


def test_entry_points_route_on_the_tower(monkeypatch):
    """`clip_fusion_spatial_block` and `clip_temporal_adapt_block` take the
    int8 wrappers for an int8 tower, the float ones else."""
    cfg = ClipConfig(ftmode="fusion", **TINY)
    model = random_clip_ave(cfg, 0)
    qb = quantize_clip_tower(model.backbone)
    seen = []
    for kern in (PCB.clip_fusion_block, PCB.clip_fusion_block_q, PCB.clip_tadapt,
                 PCB.clip_tadapt_q):
        def spy(*args, _plain=kern.plain, _name=kern.name, **kw):
            seen.append(_name)
            return _plain(*args, **kw)
        monkeypatch.setattr(kern, "plain", spy)
    rng = np.random.RandomState(0)
    v, a = t(rng.randn(2, 5, 64).astype(np.float32)), t(rng.randn(2, 3, 64).astype(np.float32))
    with torch.inference_mode():
        for bb in (model.backbone, qb):
            blk = bb.resblocks[0]
            PCB.clip_fusion_spatial_block(blk, v, a, cfg.heads)
            PCB.clip_temporal_adapt_block(blk.attn, blk.ln_1, blk.T_Adapter, v, cfg.heads)
    assert seen == ["clip_fusion_block (K12)", "clip_tadapt (K13)",
                    "clip_fusion_block_q (K12)", "clip_tadapt_q (K13)"]
