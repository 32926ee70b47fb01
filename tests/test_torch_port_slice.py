"""The port's serving slice (tiny CLIP fusion AVE) against the JAX package.

The JAX side runs the path the TPU runs, with its kernels in interpret mode:
STGCMA_FUSED_ATTN=1 and STGCMA_RESIDENT_PAD=1 (`_tiny_fusion_cfg` of
tests/test_resident_pad.py: a 26-token video stream, padded to 32 there and
not in the port). Weights cross over through `params_from_jax`.

Tolerances (max abs error over max |ref|):
- float, fp32, against the fused path and against the plain XLA path: 1e-5
  (summation order only; measured 2.6e-7);
- int8 with the JAX kernels' reciprocal made correctly rounded, as the
  port's: 1e-3, room for a one-step code flip (measured 2.9e-7, none);
- int8 as interpret mode runs it (bf16-emulated reciprocal): 1e-2, the
  one-step code moves accumulated over two blocks (measured 1.2e-3);
- bf16 serving, port against JAX's own bf16 server: 2e-2 — both round to
  bf16 at every op, at different places (XLA fuses, torch does not);
  measured 4.3e-3, one bf16 step of the largest logit.
The int8 path is not compared with JAX's XLA int8 path: `int8_matmul`
quantizes with another floor and an exact divide (`quant.py:41-43`).
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from stgcma_tpu.configs import ClipConfig as JaxClipConfig
from stgcma_tpu.models import ave as jax_ave
from stgcma_tpu.ops.quant import quantize_clip_tower as jax_quantize_clip_tower
from stgcma_tpu.serving import MultiTaskServer as JaxServer
from stgcma_tpu_torch.checkpoint.convert import clip_ave_from_jax
from stgcma_tpu_torch.configs import ClipConfig
from stgcma_tpu_torch.models.ave import apply_clip_ave
from stgcma_tpu_torch.ops import fused_attn as FA
from stgcma_tpu_torch.serving import MultiTaskServer

from torch_port_helpers import clear_opt_ins, exact_reciprocal, rel, t, to_numpy_tree

TINY = dict(ftmode="fusion", embed_dim=64, heads=4, layers=2, input_resolution=80,
            patch_size=16, num_frames=2, audio_tdim=48, audio_fdim=32,
            adapter_ratio=0.25, label_dim=7)


def _params(int8: bool, seed=11):
    """Random, non-trivial weights (gates and D_fc2 non-zero) from a seed."""
    cfg = JaxClipConfig(**TINY)
    params = jax_ave.init_clip_ave(jax.random.PRNGKey(0), cfg)
    keys = iter(jax.random.split(jax.random.PRNGKey(seed), 4096))
    params = jax.tree_util.tree_map(
        lambda x: jax.random.normal(next(keys), x.shape, jnp.float32) * 0.05, params)
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


def _jax_fused(monkeypatch, params, cfg, a, v):
    monkeypatch.setenv("STGCMA_FUSED_ATTN", "1")
    monkeypatch.setenv("STGCMA_RESIDENT_PAD", "1")
    return np.asarray(jax_ave.apply_clip_ave(params, cfg, jnp.asarray(a), jnp.asarray(v)))


def _port(params, a, v):
    cfg = ClipConfig(**TINY)
    model = clip_ave_from_jax(cfg, to_numpy_tree(params), device="cpu")
    FA.reset_launches()
    with torch.inference_mode():
        out = apply_clip_ave(model, cfg, t(a), t(v)).numpy()
    assert all(k.launches == 0 for k in FA.KERNELS)   # plain versions on the CPU
    return out


def test_float_slice_matches_jax_fused_and_xla(monkeypatch):
    clear_opt_ins(monkeypatch)
    cfg, params = _params(int8=False)
    a, v = _inputs()
    out = _port(params, a, v)
    assert out.shape == (2 * TINY["num_frames"], TINY["label_dim"])
    ref_fused = _jax_fused(monkeypatch, params, cfg, a, v)
    assert rel(out, ref_fused) < 1e-5
    monkeypatch.setenv("STGCMA_FUSED_ATTN", "0")
    monkeypatch.setenv("STGCMA_RESIDENT_PAD", "0")
    ref_xla = np.asarray(jax_ave.apply_clip_ave(params, cfg, jnp.asarray(a), jnp.asarray(v)))
    assert rel(out, ref_xla) < 1e-5


@pytest.mark.parametrize("exact_recip", [True, False])
def test_int8_slice_matches_jax_fused(monkeypatch, exact_recip):
    clear_opt_ins(monkeypatch)
    if exact_recip:
        exact_reciprocal(monkeypatch)
    cfg, params = _params(int8=True)
    a, v = _inputs()
    out = _port(params, a, v)
    ref = _jax_fused(monkeypatch, params, cfg, a, v)
    assert np.isfinite(out).all()
    assert rel(out, ref) < (1e-3 if exact_recip else 1e-2)


@pytest.mark.parametrize("int8", [False, True])
def test_server_on_cpu_matches_jax_server(monkeypatch, int8):
    """The port's MultiTaskServer on device="cpu": bf16 params and inputs,
    float32 numpy logits, against the JAX MultiTaskServer on the same weights
    and batch (JAX kernels in interpret mode, reciprocal made exact)."""
    clear_opt_ins(monkeypatch)
    exact_reciprocal(monkeypatch)
    monkeypatch.setenv("STGCMA_FUSED_ATTN", "1")
    monkeypatch.setenv("STGCMA_RESIDENT_PAD", "1")
    cfg, params = _params(int8=int8)
    a, v = _inputs(B=1)
    batch = {"a": a, "v": v}
    jsrv = JaxServer()
    jsrv.add_clip_ave("ave29", cfg, params)
    ref = jsrv.predict("ave29", batch)

    pcfg = ClipConfig(**TINY)
    srv = MultiTaskServer(device="cpu")
    srv.add_clip_ave("ave29", pcfg, clip_ave_from_jax(pcfg, to_numpy_tree(params), "cpu"))
    assert srv.tasks() == ["ave29"]
    out = srv.predict("ave29", batch)
    assert out.dtype == np.float32 and out.shape == ref.shape
    assert np.isfinite(out).all()
    assert rel(out, ref) < 2e-2
