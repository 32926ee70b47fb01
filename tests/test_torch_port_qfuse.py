"""The int8 adapter-fused kernels K11 (`STGCMA_QFUSE_ADAPTERS=1`), the
attention core past 256 tokens and the shape limits of the port's kernels
against what its launch counts promise, at tiny sizes on the CPU.

- The three K11 plain versions (`win_block_qd`, `win_block_qh`, `ffn_qh` in
  stgcma_tpu_torch/ops/fused_attn.py) against `clip_attn_megakernel_h`
  (emit_o False / True) and `ffn_qh_megakernel` of
  stgcma_tpu/ops/pallas_attn.py, whose Pallas bodies run in interpret mode
  on the CPU: the temporal site at T = 10 over 13 rows (JAX packs 8 rows
  into one gram and pads the rows to 16), the spatial site at N = 21 (JAX
  pads to 32 and masks the pad keys), the FFN site at 40 rows, fp32 and
  bf16, live adapters. The hidden is gelu(bf16(o).bf16(wd) + bd) even in
  fp32, which the fp32 case checks matters at these inputs.
- A tiny int8 CLIP AVE in `fusion` and in `multimodal` mode with the switch
  set, against the JAX package with the same switch and STGCMA_FUSED_ATTN=1
  (JAX takes K11 on the CPU only with fused attention on; the resident pad
  stays off there, as in the port). Weights cross over through
  `clip_ave_from_jax`.
- `launches_per_forward` with the switch alone, with
  `STGCMA_CLIP_WHOLE_BLOCK=1` and with `STGCMA_CLIP_TADAPT_FUSED=1`, at
  CLIP ViT-B/16 and against a counted tiny forward.
- The plain K1 at N = 257 (CLIP ViT-L/14's spatial site) against
  `clip_temporal_megakernel`, which pads to 272 and masks the pad keys.
- Every token count, head width and adapter width that a kernel counted by
  `launches_per_forward` sees at the four presets lies within the limits
  the kernels' wrappers check on the card (`check_attn_shape`,
  `check_fuse_width`, K4's `WHOLE_BLOCK_MAX_GRID`).

Tolerances (max abs error over max |ref|):
- int8 in fp32 with the JAX reciprocal made correctly rounded, as the
  port's (`rows_agree`): every row within 1e-5, except rows where a
  last-ulp difference of LayerNorm moved one int8 code or one bf16 rounding
  of o by one step, at most 1 in 10 and each within 1e-2;
- int8 in bf16: 3e-2, as for K12/K13 int8 in bf16 (a bf16 step of an
  intermediate moves codes by one step, quantization noise of ~1e-2);
- the tiny AVEs' logits in fp32: 1e-3, room for a one-step code flip;
- the plain K1 at N = 257 in fp32: 1e-5 (the same arithmetic, summation
  order only).
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from stgcma_tpu.configs import ClipConfig as JaxClipConfig
from stgcma_tpu.models import ave as jax_ave
from stgcma_tpu.ops import pallas_attn as PA
from stgcma_tpu.ops.common import cast_tree as jax_cast_tree
from stgcma_tpu.ops.quant import quantize_clip_tower as jax_quantize_clip_tower
from stgcma_tpu.ops.quant import quantize_linear_params
from stgcma_tpu_torch.checkpoint.convert import clip_ave_from_jax, params_from_jax
from stgcma_tpu_torch.configs import (ClipConfig, clip_b16, clip_l14, swin_base, swin_large)
from stgcma_tpu_torch.models.ave import apply_clip_ave, random_clip_ave
from stgcma_tpu_torch.nn import clip_vit, swin
from stgcma_tpu_torch.ops import fused_attn as FA
from stgcma_tpu_torch.ops.quant import quantize_clip_tower
from stgcma_tpu_torch.ops.swin_block import WHOLE_BLOCK_MAX_GRID, swin_whole_block_enabled

from torch_port_helpers import (clear_opt_ins, exact_reciprocal, jax_lin, jax_ln, rel,
                                rows_agree, t, to_numpy_tree)

C, HEADS, DA = 64, 2, 16
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}
TINY = dict(embed_dim=64, heads=4, layers=2, input_resolution=80, patch_size=16,
            num_frames=2, audio_tdim=48, audio_fdim=32, adapter_ratio=0.25, label_dim=7)
SWITCHES = ("STGCMA_CLIP_TADAPT_FUSED", "STGCMA_CLIP_WHOLE_BLOCK")


# ---------------------------------------------------------------------------
# the three K11 bodies
# ---------------------------------------------------------------------------

def _k11_params(seed=3):
    """LayerNorm, an int8 attention and MLP, and a live adapter (D_fc1 wide
    enough that its GELU runs through both branches)."""
    rng = np.random.RandomState(seed)
    return {"ln": jax_ln(rng, C),
            "attn": {"in_proj": quantize_linear_params(jax_lin(rng, C, 3 * C)),
                     "out_proj": quantize_linear_params(jax_lin(rng, C, C))},
            "mlp": {"c_fc": quantize_linear_params(jax_lin(rng, C, 4 * C)),
                    "c_proj": quantize_linear_params(jax_lin(rng, 4 * C, C))},
            "ad": {"D_fc1": jax_lin(rng, C, DA, 0.6), "D_fc2": jax_lin(rng, DA, C)}}


def _port_args(p, tdt):
    """The port's operands of the JAX tree: (attention args, FFN args,
    adapter (wd, bd)), the float ones in tdt, the int8 ones as they are."""
    sd = {k: (v.to(tdt) if v.is_floating_point() else v)
          for k, v in params_from_jax(to_numpy_tree(p)).items()}
    ln = (sd["ln.weight"], sd["ln.bias"])
    attn = ln + tuple(sd[f"attn.{m}.{k}"] for m in ("in_proj", "out_proj")
                      for k in ("weight_q", "weight_s", "bias"))
    ffn = ln + tuple(sd[f"mlp.{m}.{k}"] for m in ("c_fc", "c_proj")
                     for k in ("weight_q", "weight_s", "bias"))
    return attn, ffn, (sd["ad.D_fc1.weight"], sd["ad.D_fc1.bias"])


BODIES = {"qd_temporal_T10": (13, 10), "qh_spatial_N21": (3, 21), "ffn_qh_M40": (40, None)}


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("body", sorted(BODIES))
def test_k11_plain_matches_jax_kernel(monkeypatch, body, dtype):
    clear_opt_ins(monkeypatch)
    exact_reciprocal(monkeypatch)
    jdt, tdt = DTYPES[dtype]
    p = _k11_params()
    jp = jax_cast_tree(p, jdt)
    attn, ffn, (wd, bd) = _port_args(p, tdt)
    rows, n = BODIES[body]
    rng = np.random.RandomState(4)
    x = (rng.randn(rows, n, C) if n else rng.randn(rows, C)).astype(np.float32)
    xj = jnp.asarray(x).astype(jdt)
    FA.reset_launches()
    if body.startswith("qd"):
        refs = (PA.clip_attn_megakernel_h(jp["attn"], jp["ln"], jp["ad"], xj, HEADS,
                                          emit_o=False),)
        outs = (FA.win_block_qd(t(x, tdt), *attn, wd, bd, HEADS),)
    elif body.startswith("qh"):
        refs = PA.clip_attn_megakernel_h(jp["attn"], jp["ln"], jp["ad"], xj, HEADS, emit_o=True)
        outs = FA.win_block_qh(t(x, tdt), *attn, wd, bd, HEADS)
    else:
        refs = PA.ffn_qh_megakernel(jp["mlp"], jp["ln"], jp["ad"], xj, act="quick_gelu",
                                    keys=("c_fc", "c_proj"))
        outs = FA.ffn_qh(t(x, tdt), *ffn, wd, bd, "quick_gelu")
    assert all(k.launches == 0 for k in FA.KERNELS)       # plain versions on the CPU
    assert len(outs) == len(refs)
    for out, ref in zip(outs, refs):
        ref = np.asarray(ref.astype(jnp.float32))
        assert out.dtype == tdt and tuple(out.shape) == ref.shape
        if dtype == "float32":
            rows_agree(out, ref)
        else:
            assert rel(out, ref) < 3e-2
    if dtype == "float32":
        # the hidden of the fp32 output taken without the bf16 cast of
        # `_adapter_down` is not what the kernel computes
        o = (FA._win_block_q_core(t(x), *attn, HEADS) if n
             else FA._ffn_q_core(t(x), *ffn, "quick_gelu"))
        uncast = FA._erf_gelu(o @ wd.t() + bd)
        assert rel(uncast, np.asarray(refs[-1])) > 1e-4


def test_k11_entry_points_take_an_int8_tower_only():
    cfg = ClipConfig(ftmode="fusion", **TINY)
    blk = random_clip_ave(cfg, 0).backbone.resblocks[0]
    x = torch.randn(2, 5, cfg.embed_dim)
    with pytest.raises(ValueError, match="int8"):
        FA.clip_attn_megakernel_h(blk.attn, blk.ln_1, blk.S_Adapter, x, cfg.heads, emit_o=True)
    qblk = quantize_clip_tower(random_clip_ave(cfg, 0).backbone).resblocks[0]
    with torch.inference_mode():
        o, h = FA.clip_attn_megakernel_h(qblk.attn, qblk.ln_1, qblk.S_Adapter, x, cfg.heads,
                                         emit_o=True)
        hd = FA.clip_attn_megakernel_h(qblk.attn, qblk.ln_1, qblk.S_Adapter, x, cfg.heads,
                                       emit_o=False)
        n, nh = FA.ffn_qh_megakernel(qblk.mlp, qblk.ln_2, qblk.MLP_Adapter, x,
                                     act="quick_gelu", keys=("c_fc", "c_proj"))
    D = qblk.S_Adapter.D_fc1.weight.shape[0]
    assert o.shape == n.shape == x.shape and h.shape == hd.shape == nh.shape == (2, 5, D)
    assert torch.equal(h, hd)


# ---------------------------------------------------------------------------
# the slice: a tiny int8 CLIP AVE with the switch set
# ---------------------------------------------------------------------------

def _params(ftmode, seed=11):
    """Random int8-tower weights with live adapters and gates (N(0, 0.05)
    leaves; adapters' D_fc1 and D_fc2 x6, gates x8)."""
    cfg = JaxClipConfig(ftmode=ftmode, **TINY)
    shapes = jax.eval_shape(lambda: jax_ave.init_clip_ave(jax.random.PRNGKey(0), cfg))
    rng = np.random.RandomState(seed)
    params = jax.tree_util.tree_map(
        lambda x: jnp.asarray((rng.randn(*x.shape) * 0.05).astype(np.float32)), shapes)
    bp = params["backbone"]
    for blk in bp["resblocks"]:
        for k in list(blk):
            if "Adapter" in k:
                blk[k] = jax.tree_util.tree_map(lambda w: w * 6.0, blk[k])
        blk["gate_v"], blk["gate_a"] = blk["gate_v"] * 8, blk["gate_a"] * 8
    return cfg, {**params, "backbone": jax_quantize_clip_tower(bp)}


def _inputs(B=2, seed=7):
    rng = np.random.RandomState(seed)
    a = rng.randn(B, TINY["num_frames"], TINY["audio_tdim"], TINY["audio_fdim"])
    v = rng.randn(B, TINY["num_frames"], TINY["input_resolution"],
                  TINY["input_resolution"], 3)
    return a.astype(np.float32), v.astype(np.float32)


@pytest.mark.parametrize("ftmode", ["fusion", "multimodal"])
def test_qfuse_slice_matches_jax_with_the_same_switch(monkeypatch, ftmode):
    clear_opt_ins(monkeypatch)
    exact_reciprocal(monkeypatch)
    cfg, params = _params(ftmode)
    a, v = _inputs()
    monkeypatch.setenv("STGCMA_QFUSE_ADAPTERS", "1")
    monkeypatch.setenv("STGCMA_FUSED_ATTN", "1")
    ref = np.asarray(jax_ave.apply_clip_ave(params, cfg, jnp.asarray(a), jnp.asarray(v)))
    monkeypatch.delenv("STGCMA_FUSED_ATTN")
    pcfg = ClipConfig(ftmode=ftmode, **TINY)
    model = clip_ave_from_jax(pcfg, to_numpy_tree(params), device="cpu")
    calls = {}
    for kern in FA.KERNELS:
        def counted(*args, _plain=kern.plain, _id=kern.id, **kw):
            calls[_id] = calls.get(_id, 0) + 1
            return _plain(*args, **kw)
        monkeypatch.setattr(kern, "plain", counted)
    with torch.inference_mode():
        out = apply_clip_ave(model, pcfg, t(a), t(v)).numpy()
    assert calls == {"K11": 6 * cfg.layers}
    assert out.shape == ref.shape and np.isfinite(out).all()
    assert rel(out, ref) < 1e-3
    # the route is live: the same model without the switch differs
    monkeypatch.delenv("STGCMA_QFUSE_ADAPTERS")
    with torch.inference_mode():
        unfused = apply_clip_ave(model, pcfg, t(a), t(v)).numpy()
    assert rel(unfused, out) > 0


def test_launch_counts_of_clip_b16_with_qfuse(monkeypatch):
    clear_opt_ins(monkeypatch)
    monkeypatch.setenv("STGCMA_QFUSE_ADAPTERS", "1")
    cfg = clip_b16(ftmode="fusion", label_dim=29)
    lpf = clip_vit.launches_per_forward
    assert lpf(cfg, quantized=True) == {"K11": 72}     # 24 qd + 24 qh + 24 ffn_qh
    assert lpf(cfg) == {"K1": 48}                     # a float tower ignores the switch
    assert lpf(clip_b16(ftmode="multimodal"), quantized=True) == {"K11": 72}
    assert lpf(clip_b16(ftmode="videoonly"), quantized=True) == {"K11": 36}
    monkeypatch.setenv("STGCMA_CLIP_TADAPT_FUSED", "1")      # K11 goes before K13
    assert lpf(cfg, quantized=True) == {"K11": 72}
    monkeypatch.setenv("STGCMA_CLIP_WHOLE_BLOCK", "1")       # K12 goes before K11
    assert lpf(cfg, quantized=True) == {"K11": 24, "K12": 12}
    monkeypatch.setenv("STGCMA_CLIP_TADAPT_FUSED", "0")
    assert lpf(cfg, quantized=True) == {"K11": 24, "K12": 12}


@pytest.mark.parametrize("ftmode,tadapt,whole", [("fusion", "0", "1"), ("fusion", "1", "1"),
                                                 ("videoonly", "1", "0")])
def test_qfuse_launch_counts_match_the_forward(monkeypatch, ftmode, tadapt, whole):
    clear_opt_ins(monkeypatch)
    monkeypatch.setenv("STGCMA_QFUSE_ADAPTERS", "1")
    monkeypatch.setenv("STGCMA_CLIP_TADAPT_FUSED", tadapt)
    monkeypatch.setenv("STGCMA_CLIP_WHOLE_BLOCK", whole)
    calls = {}
    for kern in FA.KERNELS:
        def counted(*args, _plain=kern.plain, _id=kern.id, **kw):
            calls[_id] = calls.get(_id, 0) + 1
            return _plain(*args, **kw)
        monkeypatch.setattr(kern, "plain", counted)
    cfg = ClipConfig(ftmode=ftmode, **TINY)
    model = random_clip_ave(cfg, 0)
    model.backbone = quantize_clip_tower(model.backbone)
    a, v = _inputs(B=1)
    with torch.inference_mode():
        apply_clip_ave(model, cfg, t(a), t(v))
    assert calls == clip_vit.launches_per_forward(cfg, quantized=True)
    assert "K11" in calls and "K2" not in calls and "K3" not in calls


# ---------------------------------------------------------------------------
# the attention core past 256 tokens
# ---------------------------------------------------------------------------

def test_win_block_plain_at_257_tokens_matches_jax_kernel(monkeypatch):
    """CLIP ViT-L/14's spatial site: 16^2 + 1 tokens. JAX pads them to 272
    and masks the pad keys; the port attends over the 257 tokens."""
    clear_opt_ins(monkeypatch)
    rng = np.random.RandomState(5)
    ln = jax_ln(rng, C)
    attn = {"in_proj": jax_lin(rng, C, 3 * C), "out_proj": jax_lin(rng, C, C)}
    x = rng.randn(2, 257, C).astype(np.float32)
    ref = PA.clip_temporal_megakernel(attn, ln, jnp.asarray(x), HEADS)
    sd = params_from_jax({"attn": to_numpy_tree(attn), "ln": to_numpy_tree(ln)})
    out = FA.win_block(t(x), sd["ln.weight"], sd["ln.bias"], sd["attn.in_proj.weight"],
                       sd["attn.in_proj.bias"], sd["attn.out_proj.weight"],
                       sd["attn.out_proj.bias"], HEADS)
    assert out.shape == (2, 257, C)
    assert rel(out, ref) < 1e-5
    FA.check_attn_shape(257, C // HEADS)     # and the card takes it


# ---------------------------------------------------------------------------
# what launches_per_forward promises against what the wrappers take
# ---------------------------------------------------------------------------

def _clip_sites(cfg, quantized):
    """{kernel id: [(tokens, head width, adapter width or None for a kernel
    that runs no fusion)]} of every kernel launches_per_forward counts."""
    dh, D, T = cfg.embed_dim // cfg.heads, int(cfg.embed_dim * cfg.adapter_ratio), cfg.num_frames
    tokens = {"videoonly": [cfg.num_patches + 1], "audioonly": [cfg.num_patches_audio + 1]}.get(
        cfg.ftmode, [cfg.num_patches + 1, cfg.num_patches_audio + 1])
    sites = {}
    for kid in clip_vit.launches_per_forward(cfg, quantized):
        if kid == "K12":
            sites[kid] = [(n, dh, D) for n in tokens]
        elif kid in ("K13", "K14"):             # the temporal stage over T frames
            sites[kid] = [(T, dh, None)]
        elif kid in ("K1", "K2", "K11"):         # temporal and spatial attention sites
            sites[kid] = [(n, dh, None) for n in [T] + tokens]
        else:                                     # K3: no attention
            sites[kid] = []
    return sites


def _swin_sites(cfg, quantized):
    """The same for a Swin backbone, from the routes `launches_per_forward`
    follows (window and temporal attention in K1/K2 or K8, K4 over the stage
    grid, K5 over the windows, K6 or K10 over the grid)."""
    counts = swin.launches_per_forward(cfg, B=8, quantized=quantized)
    sites = {kid: [] for kid, n in counts.items() if n}
    for stage in swin.backbone_statics(cfg):
        for st in stage:
            dh, D = st.dim // st.num_heads, int(st.dim * st.adapter_ratio)
            attn_id = ("K2" if quantized else "K1") if FA.block_kernel_route(st.num_heads) else "K8"
            if st.t_attn:
                sites[attn_id].append((st.num_frames, dh, None))
            if st.mode == "fusion_adapt" and swin_whole_block_enabled(st):
                sites["K4"].append((st.H * st.W, dh, D))
                continue
            sites[attn_id].append((st.window_size ** 2, dh, None))
            if st.mode == "fusion_adapt":
                sites["K5"].append((st.window_size ** 2, None, D))
                route = FA.flash_fuse_route(st.H * st.W, st.H * st.W, D)
                if route in ("K6", "K10"):
                    sites[route].append((st.H * st.W, None, D))
    return sites


PRESETS = [(f"{name}_{mode}", preset, mode) for name, preset, modes in (
    ("clip_b16", clip_b16, ("fusion", "multimodal", "videoonly", "audioonly")),
    ("clip_l14", clip_l14, ("fusion", "multimodal", "videoonly", "audioonly")),
    ("swin_base", swin_base, ("fusion", "multimodal")),
    ("swin_large", swin_large, ("fusion", "multimodal"))) for mode in modes]


@pytest.mark.parametrize("name,preset,ftmode", PRESETS, ids=[p[0] for p in PRESETS])
def test_presets_lie_within_the_kernels_limits(monkeypatch, name, preset, ftmode):
    """Every configuration `launches_per_forward` counts kernels for is one
    the card takes: had this held before, CLIP ViT-L/14's 257 tokens and
    Swin-Large's adapter width 96 could not have been promised while the
    wrappers refused them."""
    clear_opt_ins(monkeypatch)
    cfg = preset(ftmode=ftmode)
    sites_of = _clip_sites if name.startswith("clip") else _swin_sites
    seen = set()
    # default routes; fused-block and QFUSE routes; the transpose-free temporal stage (K14)
    for on in ((), SWITCHES + ("STGCMA_QFUSE_ADAPTERS",), ("STGCMA_TV2",)):
        for k in SWITCHES + ("STGCMA_QFUSE_ADAPTERS", "STGCMA_TV2"):
            monkeypatch.setenv(k, "1" if k in on else "0")
        for quantized in (False, True):
            for kid, sites in sites_of(cfg, quantized).items():
                for n, dh, D in sites:
                    if dh is not None:
                        FA.check_attn_shape(n, dh, kid)
                    if D is not None and kid in ("K4", "K5", "K6", "K12"):
                        FA.check_fuse_width(D, kid)
                    if kid in ("K6", "K10"):   # K10, a2v and v2a over the grid, is K6's
                        FA.check_unscaled_attn(8 * cfg.num_ttokens, n, n, D, D)   # fallback
                    if kid == "K4":
                        assert n <= WHOLE_BLOCK_MAX_GRID
                    seen.add((kid, n, D))
    if name.startswith("clip"):
        assert ("K14", cfg.num_frames, None) in seen
    if name == "clip_l14_fusion":
        assert ("K12", 257, 64) in seen and ("K1", 257, None) in seen
    if name == "swin_large_fusion":
        assert {("K4", 196, 96), ("K5", 49, 96), ("K6", 3136, 96)} <= seen
