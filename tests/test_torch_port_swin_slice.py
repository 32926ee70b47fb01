"""The port's Swin serving slice (tiny Swin `multimodal` AVE) against the JAX
package.

The JAX side runs the path the TPU runs, with its kernels in interpret mode
(STGCMA_FUSED_ATTN=1), and the plain XLA path. The tiny tower has a shifted
stage 0 of 2 heads (K1 for the temporal and window attention) and a last
stage of 32 heads on a 7x7 grid (window shrunk to 7, unshifted: LayerNorm
then the K8 core), like Swin-Base's stage 3. At tiny sizes K7 and K9 sit
below their thresholds in both packages; the `all_kernel_routes` case lowers
them to 0 in both (the JAX FFN through its `STGCMA_FUSED_FFN=1` switch, its
`layernorm_fused` through a wrapper with `min_elems=0`). Weights cross over
through `swin_ave_from_jax`.

Tolerances (max abs error over max |ref|):
- float, fp32, against the fused path and against the plain XLA path: 1e-5
  (summation order only);
- bf16 serving, port against JAX's own bf16 server: 2e-2 (both round to
  bf16 at every op, at different places: XLA fuses, torch does not, and the
  JAX server's XLA FFN takes GELU in bf16 where K7's plain version takes it
  in fp32).
"""
import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from stgcma_tpu.configs import swin_tiny_test as jax_swin_tiny_test
from stgcma_tpu.models import ave as jax_ave
from stgcma_tpu.nn import swin as jax_swin
from stgcma_tpu.ops import pallas_attn as PA
from stgcma_tpu.serving import MultiTaskServer as JaxServer
from stgcma_tpu_torch.checkpoint.convert import swin_ave_from_jax
from stgcma_tpu_torch.configs import swin_base, swin_large, swin_tiny_test
from stgcma_tpu_torch.models.ave import apply_swin_ave, init_swin_ave, random_swin_ave
from stgcma_tpu_torch.nn import swin
from stgcma_tpu_torch.ops import fused_attn as FA
from stgcma_tpu_torch.serving import MultiTaskServer

from torch_port_helpers import clear_opt_ins, rel, t, to_numpy_tree

TINY = dict(ftmode="multimodal", embed_dim=32, depths=(2, 2), num_heads=(2, 32),
            img_size=56, num_frames=2, adapter_ratios=(0.25, 0.25), label_dim=7)


def _params(seed=11):
    """Random, non-trivial weights (D_fc2 non-zero, live bias tables)."""
    cfg = jax_swin_tiny_test(**TINY)
    params = jax_ave.init_swin_ave(jax.random.PRNGKey(0), cfg)
    keys = iter(jax.random.split(jax.random.PRNGKey(seed), 4096))

    def draw(path, x):
        s = 1.0 if "bias_table" in jax.tree_util.keystr(path) else 0.05
        return jax.random.normal(next(keys), x.shape, jnp.float32) * s
    return cfg, jax.tree_util.tree_map_with_path(draw, params)


def _inputs(B=2, seed=7):
    rng = np.random.RandomState(seed)
    n, T = TINY["img_size"], TINY["num_frames"]
    return (rng.randn(B, T, n, n).astype(np.float32),
            rng.randn(B, T, n, n, 3).astype(np.float32))


def _port(params, a, v):
    cfg = swin_tiny_test(**TINY)
    model = swin_ave_from_jax(cfg, to_numpy_tree(params), device="cpu")
    FA.reset_launches()
    with torch.inference_mode():
        out = apply_swin_ave(model, cfg, t(a), t(v)).numpy()
    assert all(k.launches == 0 for k in FA.KERNELS)   # plain versions on the CPU
    return out


def _all_kernel_routes(monkeypatch):
    """K7 and K9 at every FFN and large-norm site, in both packages."""
    monkeypatch.setattr(FA, "LN_KERNEL_MIN_ELEMS", 0)
    monkeypatch.setattr(FA, "FFN_KERNEL_MIN_HIDDEN_BYTES", 0)
    monkeypatch.setenv("STGCMA_FUSED_FFN", "1")
    monkeypatch.setattr(jax_swin, "layernorm_fused",
                        functools.partial(PA.layernorm_fused, min_elems=0))


@pytest.mark.parametrize("routes", ["default", "all_kernel_routes"])
def test_float_slice_matches_jax_fused_and_xla(monkeypatch, routes):
    clear_opt_ins(monkeypatch)
    if routes == "all_kernel_routes":
        _all_kernel_routes(monkeypatch)
    cfg, params = _params()
    a, v = _inputs()
    out = _port(params, a, v)
    assert out.shape == (2 * TINY["num_frames"], TINY["label_dim"])
    monkeypatch.setenv("STGCMA_FUSED_ATTN", "1")
    ref_fused = np.asarray(jax_ave.apply_swin_ave(params, cfg, jnp.asarray(a), jnp.asarray(v)))
    assert rel(out, ref_fused) < 1e-5
    monkeypatch.setenv("STGCMA_FUSED_ATTN", "0")
    ref_xla = np.asarray(jax_ave.apply_swin_ave(params, cfg, jnp.asarray(a), jnp.asarray(v)))
    assert rel(out, ref_xla) < 1e-5


def test_server_on_cpu_matches_jax_server(monkeypatch):
    """The port's MultiTaskServer.add_ave on device="cpu" (bf16 params, bias
    tables included, and inputs; float32 numpy logits) against the JAX
    server on the same weights and batch (kernels in interpret mode)."""
    clear_opt_ins(monkeypatch)
    monkeypatch.setenv("STGCMA_FUSED_ATTN", "1")
    cfg, params = _params()
    a, v = _inputs(B=1)
    batch = {"a": a, "v": v}
    jsrv = JaxServer()
    jsrv.add_ave("ave29", cfg, params)
    ref = jsrv.predict("ave29", batch)

    pcfg = swin_tiny_test(**TINY)
    srv = MultiTaskServer(device="cpu")
    srv.add_ave("ave29", pcfg, swin_ave_from_jax(pcfg, to_numpy_tree(params), "cpu"))
    assert srv.tasks() == ["ave29"]
    out = srv.predict("ave29", batch)
    assert out.dtype == np.float32 and out.shape == ref.shape
    assert np.isfinite(out).all()
    assert rel(out, ref) < 2e-2


def test_swin_ave_from_jax_round_trip():
    """Every JAX leaf lands in the port's state dict, in the port's layout,
    and maps back bit for bit (linear (in, out) <-> (out, in), conv DHWIO <->
    OIDHW, LayerNorm scale <-> weight); the bias-free reduction loads
    strictly."""
    cfg, params = _params()
    model = swin_ave_from_jax(swin_tiny_test(**TINY), to_numpy_tree(params), device="cpu")
    sd = model.state_dict()
    leaves = jax.tree_util.tree_flatten_with_path(params)[0]
    assert len(leaves) == len(sd)
    for path, leaf in leaves:
        keys = [str(getattr(k, "key", getattr(k, "idx", k))) for k in path]
        last, a = keys[-1], np.asarray(leaf)
        if last == "kernel":
            last = "weight"
            a = a.T if a.ndim == 2 else a.transpose(4, 3, 0, 1, 2)
        elif last == "scale":
            last = "weight"
        got = sd[".".join(keys[:-1] + [last])]
        np.testing.assert_array_equal(got.numpy(), a)
    assert model.backbone.layers[0].downsample.reduction.bias is None
    assert model.backbone.patch_embed.proj.weight.shape == (32, 3, 1, 4, 4)


def test_launch_counts_of_swin_base_at_b8():
    """Per B = 8 bf16 forward of Swin-Base multimodal, both streams: K1 at
    the 11 temporal and 22 window sites of stages 0-2; K8 at stage 3's 1
    temporal and 2 window sites; K7 at the 4 FFNs of stages 0-1 (hidden 257
    and 128 MB; stage 2's 64 MB is below 96 MiB); K9 at the patch-embed, 3
    merge, stage-3 temporal and final norms."""
    cfg = swin_base(ftmode="multimodal", label_dim=29)
    assert swin.launches_per_forward(cfg, B=8) == {"K1": 66, "K7": 8, "K8": 6, "K9": 12}
    # Swin-Large: stage 2 has 24 heads, so its 18 blocks take the K8 route
    large = swin.launches_per_forward(swin_large(ftmode="multimodal"), B=8)
    assert large == {"K1": 2 * (2 + 4), "K7": 8, "K8": 2 * (9 + 18 + 3), "K9": 2 * (6 + 9)}


@pytest.mark.parametrize("routes", ["default", "all_kernel_routes"])
def test_launch_counts_match_the_forward(monkeypatch, routes):
    """The derived counts are the calls that the forward makes: each wrapper
    is counted on the CPU through its plain version."""
    if routes == "all_kernel_routes":
        _all_kernel_routes(monkeypatch)
    calls = {"K1": 0, "K7": 0, "K8": 0, "K9": 0}
    for name, kern in (("K1", FA.win_block), ("K7", FA.ffn), ("K8", FA.wmsa_qkv),
                       ("K9", FA.layernorm)):
        def counted(*args, _plain=kern.plain, _name=name, **kw):
            calls[_name] += 1
            return _plain(*args, **kw)
        monkeypatch.setattr(kern, "plain", counted)
    cfg = swin_tiny_test(**TINY)
    a, v = _inputs(B=2)
    with torch.inference_mode():
        apply_swin_ave(random_swin_ave(cfg, 0), cfg, t(a), t(v))
    assert calls == swin.launches_per_forward(cfg, B=2, itemsize=4)
    assert calls["K1"] > 0 and calls["K8"] > 0


@pytest.mark.parametrize("ftmode", ["audioonly", "videoonly"])
def test_unported_ftmodes_raise(ftmode):
    """What raises: an ftmode the JAX package has not. The Swin
    single-stream modes are ported: like the CLIP tower's modes of the same
    names they build the single head (their forward is held to JAX in
    tests/test_torch_port_single_stream.py)."""
    with pytest.raises(ValueError, match="unknown Swin ftmode"):
        random_swin_ave(swin_tiny_test(**{**TINY, "ftmode": ftmode + "_nega"}), 0)
    from stgcma_tpu_torch.configs import clip_tiny_test
    from stgcma_tpu_torch.models.ave import SingleHead, random_clip_ave
    cfg = swin_tiny_test(**{**TINY, "ftmode": ftmode})
    assert isinstance(random_swin_ave(cfg, 0).mlp_head, SingleHead)
    assert isinstance(random_clip_ave(clip_tiny_test(ftmode=ftmode), 0).mlp_head, SingleHead)


def test_random_swin_ave_is_seeded_and_live():
    cfg = swin_tiny_test(**TINY)
    m1, m2 = random_swin_ave(cfg, 3), random_swin_ave(cfg, 3)
    for (n, p1), p2 in zip(m1.named_parameters(), m2.parameters()):
        assert torch.equal(p1, p2), n
    blk = m1.backbone.layers[0].blocks[0]
    assert blk.S_Adapter2.D_fc2.weight.abs().max() > 0
    assert blk.attn.relative_position_bias_table.std() > 0.3


def test_init_swin_ave_follows_the_jax_init():
    """The training init of `init_swin_ave` (JAX `backbone_init`): every
    adapter a no-op (zero D_fc2), zero gates and linear biases, unit
    LayerNorms, trunc_normal(0.02) linears and bias tables within +-2 std,
    patch convs within +-1/sqrt(fan_in); the same names and shapes as the
    JAX tree, so `swin_ave_from_jax` loads the JAX init strictly."""
    from stgcma_tpu_torch.ops.common import LayerNorm, Linear
    cfg = swin_tiny_test(**TINY)
    model = init_swin_ave(cfg, torch.Generator().manual_seed(1), device="cpu")
    jax_params = jax_ave.init_swin_ave(jax.random.PRNGKey(0), jax_swin_tiny_test(**TINY))
    swin_ave_from_jax(cfg, to_numpy_tree(jax_params), device="cpu")
    for name, m in model.named_modules():
        if isinstance(m, Linear):
            if m.bias is not None:
                assert not m.bias.any(), name
            if name.endswith("D_fc2"):
                assert not m.weight.any(), name
            else:
                assert 0 < m.weight.abs().max() <= 0.04 + 1e-7, name
        elif isinstance(m, LayerNorm):
            assert torch.equal(m.weight, torch.ones_like(m.weight)) and not m.bias.any(), name
    for name, p in model.named_parameters():
        if "gate_" in name:
            assert not p.any(), name
        if name.endswith("bias_table"):
            assert 0 < p.abs().max() <= 0.04 + 1e-7, name
    for conv in (model.backbone.patch_embed.proj, model.backbone.patch_embed_audio.proj):
        bound = conv.weight[0].numel() ** -0.5
        assert 0 < conv.weight.abs().max() <= bound and 0 < conv.bias.abs().max() <= bound
