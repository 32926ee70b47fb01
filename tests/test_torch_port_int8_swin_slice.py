"""The port's int8 Swin `fusion` serving slice (a tiny Swin `fusion` AVE
with its tower made int8 by `quantize_swin_tower`) against the JAX package.

The tiny tower is the fusion slice's (embed 32, depths 2/2/2, heads 2/4/32,
112^2, window 7): stage 0 at 28x28 on the windowed route (K2 W-MSA and
temporal attention, K3 FFN, K5 and K6 fusions), stage 1 at 14x14 on K4's
int8 variant (shifted and unshifted) after a K2 temporal branch, stage 2 at
7x7 on K4's int8 variant with 32 heads after a temporal branch on the K8
route, whose qkv and proj go through `int8_matmul`. Weights cross over
through `swin_ave_from_jax`.

The JAX side runs with STGCMA_FUSED_ATTN=1 in two ways:
- its kernels, in interpret mode: on the CPU `swin_fusion_whole_block` takes
  `_fullgrid_naive` with `int8_matmul` (`pallas_swin_block.py:598-600`),
  which is not the kernel's arithmetic, so the tests route it to
  `_fullgrid_pallas` (the int8 `_swin_block_kernel`) by monkeypatching the
  module attribute that `nn/swin.py:306` imports at call time;
- as it stands on the CPU (`_fullgrid_naive`: `int8_matmul`'s quantizer,
  the FFN hidden rounded to the dtype before its GELU).

Tolerances (max abs error over max |ref|, logits; measured beside each):
- against the kernels, fp32, reciprocal made correctly rounded as in the
  port: 1e-3 (measured 6.3e-5). The kernels agree to ~1e-7 wherever no
  activation sits on a rounding boundary (tests/test_torch_port_int8_swin_
  kernels.py); a one-sided rounding moves one int8 code or one bf16 q, k
  or v element by one step, which moves some tokens by up to ~5e-3 of
  their block's output, and the pooled logits by far less;
- against the kernels as interpret mode runs them (bf16-emulated
  reciprocal: many codes move by one step): 1e-2 (measured 3.2e-4);
- against the stock CPU path: 1e-2 (measured 2.0e-4), the same kind of
  quantization noise from two quantizers (1e-12 floor and exact divide
  against 1e-30 and a reciprocal) and a differently rounded FFN hidden in
  K4's blocks;
- bf16 serving, port against JAX's own bf16 server (kernel route): 2e-2
  (measured 4.3e-3, one bf16 step of the largest logit), as for the float
  fusion slice: both round to bf16 at every op, at different places.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from stgcma_tpu.configs import swin_tiny_test as jax_swin_tiny_test
from stgcma_tpu.models import ave as jax_ave
from stgcma_tpu.ops import pallas_swin_block as PSB
from stgcma_tpu.ops import quant as jax_quant
from stgcma_tpu.serving import MultiTaskServer as JaxServer
from stgcma_tpu_torch.checkpoint.convert import swin_ave_from_jax
from stgcma_tpu_torch.configs import swin_base, swin_tiny_test
from stgcma_tpu_torch.models.ave import apply_swin_ave, random_swin_ave
from stgcma_tpu_torch.nn import swin
from stgcma_tpu_torch.ops import fused_attn as FA
from stgcma_tpu_torch.ops import swin_block as SB
from stgcma_tpu_torch.ops.quant import quantize_swin_tower
from stgcma_tpu_torch.serving import MultiTaskServer

from torch_port_helpers import clear_opt_ins, exact_reciprocal, rel, t, to_numpy_tree

TINY = dict(ftmode="fusion", embed_dim=32, depths=(2, 2, 2), num_heads=(2, 4, 32),
            img_size=112, num_frames=2, adapter_ratios=(0.25, 0.25, 0.25), label_dim=7)
TOL_EXACT, TOL_INTERP, TOL_BF16 = 1e-3, 1e-2, 2e-2


def _params(seed=13):
    """Random, non-trivial weights (D_fc2 and gates non-zero, live bias
    tables), the tower quantized by the JAX `quantize_swin_tower`."""
    cfg = jax_swin_tiny_test(**TINY)
    params = jax.eval_shape(lambda: jax_ave.init_swin_ave(jax.random.PRNGKey(0), cfg))
    rng = np.random.RandomState(seed)

    def draw(path, x):
        name = jax.tree_util.keystr(path)
        s = 1.0 if ("bias_table" in name or "gate_" in name) else 0.05
        return jnp.asarray((rng.randn(*x.shape) * s).astype(np.float32))
    params = dict(jax.tree_util.tree_map_with_path(draw, params))
    params["backbone"] = jax_quant.quantize_swin_tower(params["backbone"])
    return cfg, params


def _inputs(B=1, seed=7):
    rng = np.random.RandomState(seed)
    n, T = TINY["img_size"], TINY["num_frames"]
    return (rng.randn(B, T, n, n).astype(np.float32),
            rng.randn(B, T, n, n, 3).astype(np.float32))


def _kernel_route(monkeypatch):
    """JAX's whole block through its int8 kernel (interpret mode) on the CPU."""
    def whole_block(p, v, a, st):
        return PSB._fullgrid_pallas(p, v, a, (st.H, st.W, st.window_size, st.shift_size,
                                              st.num_heads), winmajor=False)
    monkeypatch.setattr(PSB, "swin_fusion_whole_block", whole_block)


def _jax(cfg, params, a, v):
    return np.asarray(jax.jit(lambda p, a, v: jax_ave.apply_swin_ave(p, cfg, a, v))(
        params, a, v))


def _port(params, a, v):
    pcfg = swin_tiny_test(**TINY)
    model = swin_ave_from_jax(pcfg, to_numpy_tree(params), device="cpu")
    FA.reset_launches()
    with torch.inference_mode():
        out = apply_swin_ave(model, pcfg, t(a), t(v)).numpy()
    assert all(k.launches == 0 for k in FA.KERNELS)   # plain versions on the CPU
    return model, out


@pytest.mark.parametrize("exact_recip", [True, False])
def test_int8_slice_matches_jax_kernels(monkeypatch, exact_recip):
    clear_opt_ins(monkeypatch)
    if exact_recip:
        exact_reciprocal(monkeypatch)
    monkeypatch.setenv("STGCMA_FUSED_ATTN", "1")
    _kernel_route(monkeypatch)
    cfg, params = _params()
    a, v = _inputs()
    _, out = _port(params, a, v)
    assert out.shape == (TINY["num_frames"], TINY["label_dim"]) and np.isfinite(out).all()
    assert rel(out, _jax(cfg, params, a, v)) < (TOL_EXACT if exact_recip else TOL_INTERP)


def test_int8_slice_against_jax_stock_cpu_path_and_fusion_is_live(monkeypatch):
    clear_opt_ins(monkeypatch)
    monkeypatch.setenv("STGCMA_FUSED_ATTN", "1")
    cfg, params = _params()
    a, v = _inputs()
    model, out = _port(params, a, v)
    assert rel(out, _jax(cfg, params, a, v)) < TOL_INTERP
    # the fusion is live: zero gates move the logits
    with torch.no_grad():
        for blk in (b for layer in model.backbone.layers for b in layer.blocks):
            blk.gate_v.zero_()
            blk.gate_a.zero_()
    with torch.inference_mode():
        out0 = apply_swin_ave(model, swin_tiny_test(**TINY), t(a), t(v)).numpy()
    assert rel(out0, out) > 1e-3


def test_server_on_cpu_matches_jax_server(monkeypatch):
    """`MultiTaskServer.add_ave` on device="cpu" (bf16 params, scales and
    inputs, int8 weights, float32 numpy logits) against the JAX server on
    the same int8 tree (its kernels in interpret mode, reciprocal exact)."""
    clear_opt_ins(monkeypatch)
    exact_reciprocal(monkeypatch)
    monkeypatch.setenv("STGCMA_FUSED_ATTN", "1")
    _kernel_route(monkeypatch)
    cfg, params = _params()
    a, v = _inputs()
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
    assert rel(out, ref) < TOL_BF16


def test_swin_ave_from_jax_round_trip_int8_tree():
    """Every leaf of the int8 tree lands in the port's state dict in the
    port's layout and maps back bit for bit: int8 `kernel_q` (in, out) as
    `weight_q` (out, in), `kernel_s` (1, out) as `weight_s` (out,); the
    patch embed, merging, norms, adapters and head stay float."""
    _, params = _params()
    model = swin_ave_from_jax(swin_tiny_test(**TINY), to_numpy_tree(params), device="cpu")
    sd = model.state_dict()
    leaves = jax.tree_util.tree_flatten_with_path(params)[0]
    assert len(leaves) == len(sd)
    n_q = 0
    for path, leaf in leaves:
        keys = [str(getattr(k, "key", getattr(k, "idx", k))) for k in path]
        last, x = keys[-1], np.asarray(leaf)
        if last == "kernel":
            last = "weight"
            x = x.T if x.ndim == 2 else x.transpose(4, 3, 0, 1, 2)
        elif last == "kernel_q":
            last, x, n_q = "weight_q", x.T, n_q + 1
        elif last == "kernel_s":
            last, x = "weight_s", x.reshape(-1)
        elif last == "scale":
            last = "weight"
        got = sd[".".join(keys[:-1] + [last])]
        assert got.dtype == (torch.int8 if last == "weight_q" else torch.float32)
        np.testing.assert_array_equal(got.numpy(), x)
    assert n_q == 4 * sum(TINY["depths"])
    blk = model.backbone.layers[2].blocks[0]
    assert blk.attn.qkv.quantized and blk.mlp.fc2.quantized
    assert not model.backbone.layers[0].downsample.reduction.quantized


def test_random_int8_swin_ave_is_the_quantized_float_model():
    cfg = swin_tiny_test(**TINY)
    q = random_swin_ave(cfg, 3, int8=True).state_dict()
    ref = quantize_swin_tower(random_swin_ave(cfg, 3).backbone).state_dict()
    assert {k for k in q if k.startswith("backbone.")} == {f"backbone.{k}" for k in ref}
    for k, x in ref.items():
        assert torch.equal(q[f"backbone.{k}"], x), k


KERNEL_WRAPPERS = {"K2": [FA.win_block_q], "K3": [FA.ffn_q],
                   "K4": [SB.swin_block_q, SB.swin_block], "K5": [FA.win_fuse],
                   "K6": [FA.bidir_fuse], "K8": [FA.wmsa_qkv, FA.wmsa], "K9": [FA.layernorm],
                   "K1": [FA.win_block], "K7": [FA.ffn]}


def test_launch_counts_match_the_int8_forward(monkeypatch):
    """The derived counts are the calls that the int8 forward makes: each
    wrapper is counted on the CPU through its plain version; K1, K7 and the
    float K4 are never called."""
    calls = {}
    for name, kerns in KERNEL_WRAPPERS.items():
        for kern in kerns:
            def counted(*args, _plain=kern.plain, _name=kern.name, **kw):
                calls[_name] = calls.get(_name, 0) + 1
                return _plain(*args, **kw)
            monkeypatch.setattr(kern, "plain", counted)
    cfg = swin_tiny_test(**TINY)
    a, v = _inputs(B=2)
    with torch.inference_mode():
        apply_swin_ave(random_swin_ave(cfg, 0, int8=True), cfg, t(a), t(v))
    by_id = {k: sum(calls.get(w.name, 0) for w in ws) for k, ws in KERNEL_WRAPPERS.items()}
    assert calls.get(SB.swin_block.name, 0) == 0
    want = swin.launches_per_forward(cfg, B=2, itemsize=4, quantized=True)
    assert by_id == {**{k: 0 for k in KERNEL_WRAPPERS}, **want}
    assert want == {"K2": 8, "K3": 4, "K4": 4, "K5": 2, "K6": 2, "K8": 2, "K9": 0}


def test_launch_counts_of_swin_base_fusion_int8_at_b8():
    """Per B = 8 forward of Swin-Base fusion with the int8 tower: K2 at the
    11 temporal and 4 windowed-spatial sites of each stream; K3 at the FFNs
    of stages 0-1 (any hidden size); K4 at the 20 blocks of stages 2-3; K5,
    K6, K8 and K9 as in the bf16 forward; no K1, no K7."""
    cfg = swin_base(ftmode="fusion", label_dim=29)
    assert swin.launches_per_forward(cfg, B=8, quantized=True) == {
        "K2": 30, "K3": 8, "K4": 20, "K5": 4, "K6": 4, "K8": 2, "K9": 12}
