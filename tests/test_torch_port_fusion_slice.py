"""The port's Swin `fusion` serving slice (tiny Swin `fusion` AVE, the
STG-CMA exchange) against the JAX package.

The tiny tower (embed 32, depths 2/2/2, heads 2/4/32, 112^2, window 7)
covers every route of Swin-Base `fusion`: stage 0 at 28x28 on the windowed
route (K1 W-MSA, K5 per-window fusion, K6 full-grid fusion over 784
tokens), stage 1 at 14x14 on K4 (shifted and unshifted), stage 2 at 7x7 on
K4 with 32 heads (and its temporal branch on the K8 route). The JAX side
runs with STGCMA_FUSED_ATTN=1, where on the CPU the whole block takes
`_fullgrid_naive` and the fusions XLA's `cross_modal_fuse`, and with it
off, where every stage takes the windowed XLA path. Weights cross over
through `swin_ave_from_jax`.

Tolerances (max abs error over max |ref|):
- float, fp32, against both JAX paths: 1e-5 (summation order only);
- bf16 serving, port against JAX's own bf16 server: 2e-2 (both round to
  bf16 at every op, at different places: XLA fuses, torch does not).
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from stgcma_tpu.configs import swin_tiny_test as jax_swin_tiny_test
from stgcma_tpu.models import ave as jax_ave
from stgcma_tpu.serving import MultiTaskServer as JaxServer
from stgcma_tpu_torch.checkpoint.convert import swin_ave_from_jax
from stgcma_tpu_torch.configs import swin_base, swin_large, swin_tiny_test
from stgcma_tpu_torch.models.ave import apply_swin_ave, random_swin_ave
from stgcma_tpu_torch.nn import swin
from stgcma_tpu_torch.ops import fused_attn as FA
from stgcma_tpu_torch.ops import swin_block as SB
from stgcma_tpu_torch.serving import MultiTaskServer

from torch_port_helpers import clear_opt_ins, rel, t, to_numpy_tree

TINY = dict(ftmode="fusion", embed_dim=32, depths=(2, 2, 2), num_heads=(2, 4, 32),
            img_size=112, num_frames=2, adapter_ratios=(0.25, 0.25, 0.25), label_dim=7)


def _params(seed=13):
    """Random, non-trivial weights (D_fc2 and gates non-zero, live bias tables)."""
    cfg = jax_swin_tiny_test(**TINY)
    params = jax.eval_shape(lambda: jax_ave.init_swin_ave(jax.random.PRNGKey(0), cfg))
    rng = np.random.RandomState(seed)

    def draw(path, x):
        name = jax.tree_util.keystr(path)
        s = 1.0 if ("bias_table" in name or "gate_" in name) else 0.05
        return jnp.asarray((rng.randn(*x.shape) * s).astype(np.float32))
    return cfg, jax.tree_util.tree_map_with_path(draw, params)


def _inputs(B=2, seed=7):
    rng = np.random.RandomState(seed)
    n, T = TINY["img_size"], TINY["num_frames"]
    return (rng.randn(B, T, n, n).astype(np.float32),
            rng.randn(B, T, n, n, 3).astype(np.float32))


def test_float_slice_matches_jax_fused_and_xla(monkeypatch):
    clear_opt_ins(monkeypatch)
    cfg, params = _params()
    a, v = _inputs(B=1)
    pcfg = swin_tiny_test(**TINY)
    model = swin_ave_from_jax(pcfg, to_numpy_tree(params), device="cpu")
    FA.reset_launches()
    with torch.inference_mode():
        out = apply_swin_ave(model, pcfg, t(a), t(v)).numpy()
    assert all(k.launches == 0 for k in FA.KERNELS)   # plain versions on the CPU
    assert out.shape == (TINY["num_frames"], TINY["label_dim"])
    for fused in ("1", "0"):           # the routes are read while jit traces
        monkeypatch.setenv("STGCMA_FUSED_ATTN", fused)
        ref = jax.jit(lambda p, a, v: jax_ave.apply_swin_ave(p, cfg, a, v))(params, a, v)
        assert rel(out, np.asarray(ref)) < 1e-5, fused
    # the fusion is live: zero gates move the logits
    with torch.no_grad():
        for blk in (b for layer in model.backbone.layers for b in layer.blocks):
            blk.gate_v.zero_()
            blk.gate_a.zero_()
    with torch.inference_mode():
        assert rel(apply_swin_ave(model, pcfg, t(a), t(v)).numpy(), out) > 1e-3


def test_server_on_cpu_matches_jax_server(monkeypatch):
    """`MultiTaskServer.add_ave` on device="cpu" (bf16 params and inputs,
    float32 numpy logits) against the JAX server on the same weights."""
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
    out = srv.predict("ave29", batch)
    assert out.dtype == np.float32 and out.shape == ref.shape
    assert np.isfinite(out).all()
    assert rel(out, ref) < 2e-2


def test_swin_ave_from_jax_round_trip_fusion_tree():
    """The fusion tree has the keys of the multimodal one: every JAX leaf
    lands in the port's state dict in the port's layout and maps back bit
    for bit, the gates included."""
    cfg, params = _params()
    model = swin_ave_from_jax(swin_tiny_test(**TINY), to_numpy_tree(params), device="cpu")
    sd = model.state_dict()
    leaves = jax.tree_util.tree_flatten_with_path(params)[0]
    assert len(leaves) == len(sd)
    mm_cfg = jax_swin_tiny_test(**{**TINY, "ftmode": "multimodal"})
    mm = jax.eval_shape(lambda: jax_ave.init_swin_ave(jax.random.PRNGKey(0), mm_cfg))
    assert jax.tree_util.tree_structure(mm) == jax.tree_util.tree_structure(params)
    for path, leaf in leaves:
        keys = [str(getattr(k, "key", getattr(k, "idx", k))) for k in path]
        last, x = keys[-1], np.asarray(leaf)
        if last == "kernel":
            last = "weight"
            x = x.T if x.ndim == 2 else x.transpose(4, 3, 0, 1, 2)
        elif last == "scale":
            last = "weight"
        np.testing.assert_array_equal(sd[".".join(keys[:-1] + [last])].numpy(), x)
    assert model.backbone.layers[1].blocks[0].gate_v.abs().item() > 0


KERNEL_WRAPPERS = {"K1": FA.win_block, "K4": SB.swin_block, "K5": FA.win_fuse,
                   "K6": FA.bidir_fuse, "K7": FA.ffn, "K8": FA.wmsa_qkv, "K9": FA.layernorm}


def test_launch_counts_match_the_forward(monkeypatch):
    """The derived counts are the calls that the forward makes: each wrapper
    is counted on the CPU through its plain version."""
    calls = {k: 0 for k in KERNEL_WRAPPERS}
    for name, kern in KERNEL_WRAPPERS.items():
        def counted(*args, _plain=kern.plain, _name=name, **kw):
            calls[_name] += 1
            return _plain(*args, **kw)
        monkeypatch.setattr(kern, "plain", counted)
    cfg = swin_tiny_test(**TINY)
    a, v = _inputs(B=2)
    with torch.inference_mode():
        apply_swin_ave(random_swin_ave(cfg, 0), cfg, t(a), t(v))
    assert calls == swin.launches_per_forward(cfg, B=2, itemsize=4)
    assert calls == {"K1": 8, "K4": 4, "K5": 2, "K6": 2, "K7": 0, "K8": 2, "K9": 0}


def test_launch_counts_of_swin_base_fusion_at_b8():
    """Per B = 8 bf16 forward of Swin-Base fusion: K1 at the 11 temporal and
    4 windowed-spatial sites of each stream; K4 at the 20 blocks of stages
    2-3 (once a call, both streams); K5 and K6 at the 4 blocks of stages
    0-1; K7 at their FFNs; K8 at the stage-3 temporal site; K9 as in
    multimodal."""
    cfg = swin_base(ftmode="fusion", label_dim=29)
    assert swin.launches_per_forward(cfg, B=8) == {
        "K1": 30, "K4": 20, "K5": 4, "K6": 4, "K7": 8, "K8": 2, "K9": 12}
    # Swin-Large: stage 2 has 24 heads, so its temporal sites take K8
    large = swin.launches_per_forward(swin_large(ftmode="fusion"), B=8)
    assert large == {"K1": 2 * (2 + 4), "K4": 20, "K5": 4, "K6": 4, "K7": 8,
                     "K8": 2 * (9 + 1), "K9": 2 * (6 + 9)}


def test_random_swin_ave_gates_are_live():
    """Gates N(0, 0.5); the gates' std changes no other weight's draw."""
    cfg = swin_tiny_test(**TINY)
    m = random_swin_ave(cfg, 3)
    gates = torch.cat([p.flatten() for n, p in m.named_parameters() if "gate_" in n])
    assert gates.abs().max() > 0.2
    blk = m.backbone.layers[0].blocks[0]
    assert blk.S_Adapter.D_fc2.weight.std() < 0.05
