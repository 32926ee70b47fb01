"""The port's elementary ops against the JAX package, the weight carry-over,
the default-device rule and the import boundary of stgcma_tpu_torch.

Float tolerances: 1e-5 relative (fp32, summation order only). The int8
weight quantization is compared bit for bit.
"""
import ast
import pathlib

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from stgcma_tpu.configs import clip_b16 as jax_clip_b16
from stgcma_tpu.nn import adapters as jax_adapters
from stgcma_tpu.ops import attention as jax_attention
from stgcma_tpu.ops import common as jax_common
from stgcma_tpu.ops import conv as jax_conv
from stgcma_tpu.ops import quant as jax_quant
from stgcma_tpu_torch.checkpoint.convert import params_from_jax
from stgcma_tpu_torch.configs import clip_b16, clip_l14, clip_tiny_test
from stgcma_tpu_torch.nn import adapters
from stgcma_tpu_torch.ops import attention, common, conv, quant

from torch_port_helpers import jax_lin, jax_ln, rel, t, to_numpy_tree

PORT = pathlib.Path(__file__).resolve().parent.parent / "stgcma_tpu_torch"


def _module(cls, tree, *args):
    m = cls(*args)
    m.load_state_dict(params_from_jax(to_numpy_tree(tree)))
    return m


def test_configs_match_jax_presets():
    from stgcma_tpu import configs as jc
    for port_fn, jax_fn in ((clip_b16, jc.clip_b16), (clip_l14, jc.clip_l14),
                            (clip_tiny_test, jc.clip_tiny_test)):
        p, j = port_fn(), jax_fn()
        for f in ("embed_dim", "layers", "heads", "patch_size", "input_resolution",
                  "num_frames", "audio_fdim", "audio_tdim", "adapter_ratio",
                  "ftmode", "label_dim", "num_patches", "num_patches_audio"):
            assert getattr(p, f) == getattr(j, f), f
    assert clip_b16().num_patches_audio + 1 == 49 == jax_clip_b16().num_patches_audio + 1


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layernorm_linear_acts_match_jax(dtype):
    rng = np.random.RandomState(0)
    x = (rng.randn(3, 5, 24) * 2).astype(np.float32)
    ln, lin = jax_ln(rng, 24), jax_lin(rng, 24, 40)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    tol = 1e-5 if dtype == "float32" else 2e-2     # bf16: one rounding, 2^-8
    jx = jnp.asarray(x).astype(jd)
    tx = t(x).to(td)
    ref = jax_common.layernorm(ln, jx)
    out = common.layernorm(_module(common.LayerNorm, ln, 24), tx)
    assert out.dtype == td and rel(out.float(), ref.astype(jnp.float32)) < tol
    ref = jax_common.linear(lin, jx)
    out = common.linear(_module(common.Linear, lin, 24, 40), tx)
    assert rel(out.float(), ref.astype(jnp.float32)) < tol
    for jf, tf in ((jax_common.gelu, common.gelu), (jax_common.quick_gelu, common.quick_gelu)):
        assert rel(tf(tx).float(), jf(jx).astype(jnp.float32)) < tol


def test_quantized_linear_refuses_plain_linear():
    """`linear` on a quantized layer takes the int8 path (`int8_matmul`, as
    the JAX `linear` routes "kernel_q"), not a float product."""
    rng = np.random.RandomState(1)
    lin = jax_lin(rng, 8, 4)
    ql = quant.quantize_linear_params(_module(common.Linear, lin, 8, 4))
    x = (rng.randn(2, 8) * 3).astype(np.float32)
    ref = jax_common.linear(jax_quant.quantize_linear_params(lin), jnp.asarray(x))
    out = common.linear(ql, t(x))
    assert rel(out, np.asarray(ref)) <= 1e-6
    plain = x @ np.asarray(lin["kernel"]) + np.asarray(lin["bias"])
    assert rel(out, plain) > 1e-4


def test_quantize_weight_bit_exact():
    rng = np.random.RandomState(2)
    w = (rng.randn(96, 40) * rng.rand(1, 40)).astype(np.float32)
    w[:, 7] = 0.0                          # the 1e-12 floor
    q_ref, s_ref = jax_quant.quantize_weight(jnp.asarray(w))
    q, s = quant.quantize_weight(t(w.T))   # port layout (out, in)
    assert q.dtype == torch.int8
    np.testing.assert_array_equal(q.numpy().T, np.asarray(q_ref))
    np.testing.assert_array_equal(s.numpy(), np.asarray(s_ref)[0])


def test_quantize_clip_tower_matches_jax():
    from stgcma_tpu.configs import ClipConfig as JaxClipConfig
    from stgcma_tpu.models import ave as jax_ave
    from stgcma_tpu_torch.checkpoint.convert import clip_ave_from_jax
    from stgcma_tpu_torch.configs import ClipConfig
    kw = dict(embed_dim=32, heads=4, layers=2, input_resolution=32, patch_size=16,
              num_frames=2, audio_tdim=32, audio_fdim=32, adapter_ratio=0.25)
    params = jax_ave.init_clip_ave(jax.random.PRNGKey(3), JaxClipConfig(**kw))
    model = clip_ave_from_jax(ClipConfig(**kw), to_numpy_tree(params), device="cpu")
    qb = quant.quantize_clip_tower(model.backbone)
    assert not model.backbone.resblocks[0].attn.in_proj.quantized   # a copy
    jq = to_numpy_tree(jax_quant.quantize_clip_tower(params["backbone"]))
    want = params_from_jax(jq)
    got = qb.state_dict()
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k].numpy(), v.numpy(), err_msg=k)


def test_patch_conv_matches_jax():
    rng = np.random.RandomState(4)
    x = rng.randn(3, 48, 32, 1).astype(np.float32)        # audio-like, ragged rows
    w = (rng.randn(16, 16, 1, 24) * 0.1).astype(np.float32)   # HWIO
    ref = jax_conv.conv2d({"kernel": jnp.asarray(w)}, jnp.asarray(x), stride=16)
    out = conv.conv2d(t(w.transpose(3, 2, 0, 1)), t(x), stride=16)
    assert out.shape == ref.shape
    assert rel(out, ref) < 1e-5


def test_adapters_match_jax():
    rng = np.random.RandomState(5)
    p = {"D_fc1": jax_lin(rng, 32, 8), "D_fc2": jax_lin(rng, 8, 32)}
    x = rng.randn(2, 7, 32).astype(np.float32)
    m = _module(adapters.Adapter, p, 32, 0.25)
    for skip in (True, False):
        ref = jax_adapters.adapter_apply(p, jnp.asarray(x), skip=skip)
        assert rel(adapters.adapter_apply(m, t(x), skip=skip), ref) < 1e-5
    h_ref = jax_adapters.adapter_hidden(p, jnp.asarray(x))
    h = adapters.adapter_hidden(m, t(x))
    assert rel(h, h_ref) < 1e-5
    assert rel(adapters.adapter_out(m, h), jax_adapters.adapter_out(p, h_ref)) < 1e-5


def test_cross_modal_fuse_matches_jax():
    rng = np.random.RandomState(6)
    vh = rng.randn(2, 13, 8).astype(np.float32)
    ah = rng.randn(2, 5, 8).astype(np.float32)
    gv, ga = np.array([0.7], np.float32), np.array([-0.4], np.float32)
    v_ref, a_ref = jax_attention.cross_modal_fuse(*map(jnp.asarray, (vh, ah, gv, ga)))
    v_out, a_out = attention.cross_modal_fuse(t(vh), t(ah), t(gv), t(ga))
    assert rel(v_out, v_ref) < 1e-5 and rel(a_out, a_ref) < 1e-5


def test_default_device_entry_points_raise_without_gpu():
    """Entry points default to device="cuda" and raise on a host without a
    card instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    from stgcma_tpu_torch.models.ave import init_clip_ave
    from stgcma_tpu_torch.serving import MultiTaskServer
    with pytest.raises(RuntimeError, match="no CUDA device"):
        MultiTaskServer()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_clip_ave(clip_tiny_test())


def test_port_imports_neither_jax_nor_the_jax_package():
    bad = []
    files = sorted(PORT.rglob("*.py")) + [PORT.parent / "chip_smoke.py"]
    for f in files:
        for node in ast.walk(ast.parse(f.read_text(), filename=str(f))):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""] if node.level == 0 else []
            else:
                continue
            for n in names:
                top = n.split(".")[0]
                if top in ("jax", "jaxlib", "flax", "stgcma_tpu"):
                    bad.append(f"{f.relative_to(PORT.parent)}: {n}")
    assert len(files) > 10
    assert not bad, bad
