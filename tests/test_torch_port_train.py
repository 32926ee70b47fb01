"""Training in the PyTorch port (stgcma_tpu_torch) against the JAX package on
the CPU, at tiny sizes, fp32.

- The gradient of every float kernel wrapper (K1, K4-K10, K12-K14) through
  `ops/fused_attn.py::_Recompute` (its forward the wrapper's call, its
  backward the wrapper's recompute under autograd: the plain version, K1's
  `win_block_recompute`) against `jax.grad`
  of the JAX `custom_vjp` op (whose forward runs the Pallas kernel in
  interpret mode and whose backward is the XLA recompute): every input's
  gradient at rtol 1e-3, atol 1e-4, as tests/test_pallas_attn.py holds the
  JAX ops to their naive mirrors. Each case checks that the output's
  grad_fn is the Function. Every int8 wrapper raises on a gradient. K1's
  recompute in bf16 rounds as JAX's `_win_block_naive` does (bars in its
  test's docstring).
- Losses at 1e-6 relative; the LR tables bit for bit; the optimizer's groups
  and the trainable partition name for name.
- Three train steps of `train/steps.py::make_train_step` in fp32 on a tiny
  CLIP `fusion` AVE with live weights (gates and adapter D_fc2 non-zero, so
  the fusion's gradients are not zero), against JAX's `make_train_step` on
  the same tree (carried by `params_from_jax`) and batches, no dropout:
  per-step losses within 1e-5 relative, step-1 gradients within 1e-4 x max
  |g| of each leaf, frozen leaves bit for bit. Trainable leaves after step
  3: every leaf's update within 2e-3 x the largest update in the model.
  Adam divides each gradient by its running RMS, so an element whose
  gradient is ~1e-7 of its leaf's (summation-order noise between two fp32
  programs) gets an update of order lr whatever its sign; the bar is one
  part in 500 of the largest update, where an unscaled error of 1e-4 in the
  gradients would move updates by ~1e-4 of lr.
- The head's dropout: keep rate 0.5 within 3 sigma, kept values scaled by 2.
- Checkpoint round trip bit for bit (parameters and Adam state); a Trainer
  resumed after epoch 1 reaches the straight run's masters bit for bit; the
  Trainer's result.csv and progress.json equal what JAX's Trainer writes for
  the same history.
"""
import csv
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from stgcma_tpu import configs as jax_configs
from stgcma_tpu.models import ave as jax_ave
from stgcma_tpu.nn.clip_vit import clip_block_init
from stgcma_tpu.nn.swin import BlockStatic as JaxBlockStatic
from stgcma_tpu.nn.swin import block_init
from stgcma_tpu.ops import pallas_attn as PA
from stgcma_tpu.ops import pallas_clip_block as CB
from stgcma_tpu.ops import pallas_swin_block as PSB
from stgcma_tpu.train import loop as jax_loop
from stgcma_tpu.train import losses as jax_losses
from stgcma_tpu.train import optim as jax_optim
from stgcma_tpu.train import steps as jax_steps
from stgcma_tpu_torch.checkpoint.convert import clip_ave_from_jax, params_from_jax
from stgcma_tpu_torch.checkpoint.io import load_checkpoint, save_checkpoint
from stgcma_tpu_torch.configs import ClipConfig, clip_tiny_test
from stgcma_tpu_torch.models import ave
from stgcma_tpu_torch.nn import swin
from stgcma_tpu_torch.nn.clip_vit import ClipBlock
from stgcma_tpu_torch.ops import clip_block as PCB
from stgcma_tpu_torch.ops import fused_attn as FA
from stgcma_tpu_torch.ops import quant
from stgcma_tpu_torch.ops import swin_block as SB
from stgcma_tpu_torch.train import losses, optim, steps
from stgcma_tpu_torch.train.loop import Trainer, weight_average

from torch_port_helpers import clear_opt_ins, t, to_numpy_tree

RTOL, ATOL = 1e-3, 1e-4


def _r(rng, *shape, s=1.0):
    return (rng.randn(*shape) * s).astype(np.float32)


def _leaf(a):
    return t(a).requires_grad_(True)


def _port_grads(call, named):
    """Run `call` (a wrapper's call on tensors that require grad), check that
    its outputs come from the Function, and take the gradients of sum(out^2)
    w.r.t. `named` {name: tensor} (a missing gradient is zero)."""
    out = call()
    outs = out if isinstance(out, tuple) else (out,)
    assert all(type(o.grad_fn).__name__ == "_RecomputeBackward" for o in outs)
    sum((o ** 2).sum() for o in outs).backward()
    return {n: (v.grad if v.grad is not None else torch.zeros_like(v)).numpy()
            for n, v in named.items()}


def _jgrad(fn, argnums):
    """jax.grad of fn, jitted (eager dispatch of the XLA recompute is slow)."""
    return jax.jit(jax.grad(fn, argnums=argnums))


def _jax_sq(out):
    outs = out if isinstance(out, tuple) else (out,)
    return sum((o ** 2).sum() for o in outs)


# ---------------------------------------------------------------------------
# the float wrappers' gradients against the JAX custom_vjp ops
# ---------------------------------------------------------------------------

def _case_k1():
    rng = np.random.RandomState(0)
    B_, N, C, heads, nWb = 6, 16, 32, 4, 3
    x, lw, lb = _r(rng, B_, N, C), 1 + _r(rng, C, s=0.1), _r(rng, C, s=0.1)
    wqkv, bqkv = _r(rng, C, 3 * C, s=0.1), _r(rng, 3 * C, s=0.05)
    wproj, bproj = _r(rng, C, C, s=0.1), _r(rng, C, s=0.05)
    bm = _r(rng, nWb, heads, N, N)
    named = {"x": _leaf(x), "ln_w": _leaf(lw), "ln_b": _leaf(lb), "w_qkv": _leaf(wqkv.T),
             "b_qkv": _leaf(bqkv), "w_proj": _leaf(wproj.T), "b_proj": _leaf(bproj),
             "bias": _leaf(bm)}
    n = named
    port = _port_grads(lambda: FA.win_block(n["x"], n["ln_w"], n["ln_b"], n["w_qkv"],
                                            n["b_qkv"], n["w_proj"], n["b_proj"], heads,
                                            bias=n["bias"]), named)
    g = _jgrad(lambda *a: _jax_sq(PA._win_block_op(*a, heads)), argnums=tuple(range(6)))(
        *(jnp.asarray(a) for a in (x, lw, lb, wqkv)),
        {"wproj": jnp.asarray(wproj), "bqkv": jnp.asarray(bqkv), "bproj": jnp.asarray(bproj)},
        jnp.asarray(bm))
    ref = {"x": g[0], "ln_w": g[1], "ln_b": g[2], "w_qkv": np.asarray(g[3]).T,
           "b_qkv": g[4]["bqkv"], "w_proj": np.asarray(g[4]["wproj"]).T,
           "b_proj": g[4]["bproj"], "bias": g[5]}
    return port, ref


def _case_k7():
    rng = np.random.RandomState(1)
    M, C, H = 40, 16, 64
    x, lw, lb = _r(rng, M, C), 1 + _r(rng, C, s=0.1), _r(rng, C, s=0.1)
    w1, b1, w2, b2 = _r(rng, C, H, s=0.2), _r(rng, H, s=0.1), _r(rng, H, C, s=0.2), _r(rng, C)
    named = {"x": _leaf(x), "ln_w": _leaf(lw), "ln_b": _leaf(lb), "w1": _leaf(w1.T),
             "b1": _leaf(b1), "w2": _leaf(w2.T), "b2": _leaf(b2)}
    port = _port_grads(lambda: FA.ffn(*named.values()), named)
    g = _jgrad(lambda *a: _jax_sq(PA._ffn_op(*a, "gelu")), argnums=tuple(range(7)))(
        *(jnp.asarray(a) for a in (x, lw, lb, w1, b1, w2, b2)))
    ref = dict(zip(named, (g[0], g[1], g[2], np.asarray(g[3]).T, g[4], np.asarray(g[5]).T,
                           g[6])))
    return port, ref


def _case_k9():
    rng = np.random.RandomState(2)
    x, w, b = _r(rng, 24, 32), 1 + _r(rng, 32, s=0.1), _r(rng, 32, s=0.1)
    named = {"x": _leaf(x), "w": _leaf(w), "b": _leaf(b)}
    port = _port_grads(lambda: FA.layernorm(*named.values()), named)
    g = _jgrad(lambda *a: _jax_sq(PA._ln_op(*a)), argnums=(0, 1, 2))(
        *(jnp.asarray(a) for a in (x, w, b)))
    return port, dict(zip(named, g))


def _fuse_case(wrapper, op, B, Nv, Na, D, seed):
    rng = np.random.RandomState(seed)
    arrays = (_r(rng, B, Nv, D, s=0.7), _r(rng, B, Na, D, s=0.7),
              np.array([0.8], np.float32), np.array([-0.6], np.float32))
    named = dict(zip(("vh", "ah", "gate_v", "gate_a"), (_leaf(a) for a in arrays)))
    port = _port_grads(lambda: wrapper(*named.values()), named)
    g = _jgrad(lambda *a: _jax_sq(op(*a)), argnums=(0, 1, 2, 3))(
        *(jnp.asarray(a) for a in arrays))
    return port, dict(zip(named, g))


def _case_k5():
    return _fuse_case(FA.win_fuse, PA._win_fuse_op, 6, 49, 49, 16, 3)


def _case_k6():
    return _fuse_case(FA.bidir_fuse, PA._bidir_fuse_op, 2, 48, 32, 16, 4)


def _case_k8():
    rng = np.random.RandomState(5)
    R, N, dh, P = 8, 16, 8, 4
    arrays = (_r(rng, R, N, dh), _r(rng, R, N, dh), _r(rng, R, N, dh), _r(rng, P, N, N))
    named = dict(zip(("q", "k", "v", "bm"), (_leaf(a) for a in arrays)))
    port = _port_grads(lambda: FA.wmsa(*named.values()), named)
    g = _jgrad(lambda *a: _jax_sq(PA._wmsa_attention(*a)), argnums=(0, 1, 2, 3))(
        *(jnp.asarray(a) for a in arrays))
    return port, dict(zip(named, g))


def _case_k8_qkv():
    """K8 at its Swin sites: the packed qkv taken apart, q scaled, JAX's op,
    the heads merged (as the forward test of the ffn-wmsa-hopper file)."""
    rng = np.random.RandomState(6)
    B_, N, heads, dh, P = 4, 16, 2, 8, 4
    C = heads * dh
    qkv, bm = _r(rng, B_, N, 3 * C), _r(rng, P, N, N)
    named = {"qkv": _leaf(qkv), "bm": _leaf(bm)}
    port = _port_grads(lambda: FA.wmsa_qkv(named["qkv"], named["bm"], heads), named)

    def jax_site(qkv, bm):
        q, k, v = qkv.reshape(B_, N, 3, heads, dh).transpose(2, 0, 3, 1, 4)
        q = q * np.float32(dh ** -0.5)
        rows = [a.reshape(B_ * heads, N, dh) for a in (q, k, v)]
        out = PA._wmsa_attention(*rows, bm)
        return out.reshape(B_, heads, N, dh).transpose(0, 2, 1, 3).reshape(B_, N, C)
    g = _jgrad(lambda *a: _jax_sq(jax_site(*a)), argnums=(0, 1))(jnp.asarray(qkv),
                                                                 jnp.asarray(bm))
    return port, dict(zip(named, g))


def _case_k10():
    rng = np.random.RandomState(7)
    arrays = (_r(rng, 2, 24, 16), _r(rng, 2, 40, 16), _r(rng, 2, 40, 16))
    named = dict(zip(("q", "k", "v"), (_leaf(a) for a in arrays)))
    port = _port_grads(lambda: FA.unscaled_attention(*named.values()), named)
    g = _jgrad(lambda *a: _jax_sq(PA.unscaled_attention(*a)), argnums=(0, 1, 2))(
        *(jnp.asarray(a) for a in arrays))
    return port, dict(zip(named, g))


def _clip_block(C=32, heads=4, seed=0):
    """A fusion-mode CLIP block with every leaf random and live, as a JAX
    tree and as the port's ClipBlock holding it (parameters requiring grad)."""
    cfg = jax_configs.ClipConfig(embed_dim=C, layers=1, heads=heads, adapter_ratio=0.25,
                                 ftmode="fusion")
    shapes = jax.eval_shape(lambda: clip_block_init(jax.random.PRNGKey(0), cfg, "fusion_adapt"))
    rng = np.random.RandomState(seed)
    p = jax.tree_util.tree_map(lambda x: jnp.asarray(_r(rng, *x.shape, s=0.1)), shapes)
    for ln in ("ln_1", "ln_2"):
        p[ln]["scale"] = p[ln]["scale"] + 1.0
    p["gate_v"], p["gate_a"] = p["gate_v"] * 8, p["gate_a"] * 8
    blk = ClipBlock(ClipConfig(embed_dim=C, layers=1, heads=heads, adapter_ratio=0.25),
                    "fusion_adapt")
    blk.load_state_dict(params_from_jax(to_numpy_tree(p)), strict=True)
    return p, blk


def _module_grads(module, jax_grad_tree, extra_port, extra_ref):
    """(port, ref) gradients by the port's parameter names: the module's
    .grad (zero where none), the JAX tree's mapped by `params_from_jax`."""
    ref = {k: v.numpy() for k, v in params_from_jax(to_numpy_tree(jax_grad_tree)).items()}
    port = {n: (p.grad if p.grad is not None else torch.zeros_like(p)).numpy()
            for n, p in module.named_parameters() if n in ref}
    assert set(port) == set(ref)
    port.update(extra_port)
    ref.update(extra_ref)
    return port, ref


def _case_k12():
    p, blk = _clip_block()
    rng = np.random.RandomState(8)
    v, a = _r(rng, 2, 13, 32, s=0.5), _r(rng, 2, 9, 32, s=0.5)
    xs = {"v": _leaf(v), "a": _leaf(a)}
    got = _port_grads(lambda: PCB.clip_fusion_spatial_block(blk, xs["v"], xs["a"], 4), xs)
    gp, gv, ga = _jgrad(lambda p, v, a: _jax_sq(CB._fusion_block_op(p, v, a, 4)),
                          argnums=(0, 1, 2))(p, jnp.asarray(v), jnp.asarray(a))
    return _module_grads(blk, gp, got, {"v": gv, "a": ga})


def _case_k13():
    p, blk = _clip_block(seed=1)
    x = _r(np.random.RandomState(9), 6, 5, 32, s=0.5)
    xs = {"x": _leaf(x)}
    got = _port_grads(lambda: PCB.clip_temporal_adapt_block(blk.attn, blk.ln_1, blk.T_Adapter,
                                                            xs["x"], 4), xs)
    g = _jgrad(lambda a, l, d, x: _jax_sq(CB._tadapt_op(a, l, d, x, 4)),
                 argnums=(0, 1, 2, 3))(p["attn"], p["ln_1"], p["T_Adapter"], jnp.asarray(x))
    return _module_grads(blk, {"attn": g[0], "ln_1": g[1], "T_Adapter": g[2]}, got, {"x": g[3]})


def _case_k14():
    p, blk = _clip_block(seed=2)
    T = 4
    x = _r(np.random.RandomState(10), 2 * T, 7, 32, s=0.5)
    xs = {"x": _leaf(x)}
    got = _port_grads(lambda: PCB.temporal_adapt_v2(blk.attn, blk.ln_1, blk.T_Adapter, xs["x"],
                                                    4, T), xs)
    cp = {"qkv": p["attn"]["in_proj"], "proj": p["attn"]["out_proj"]}
    g = _jgrad(lambda c, l, d, x: _jax_sq(PA._tv2_op(c, l, d, x, None, 4, T)),
                 argnums=(0, 1, 2, 3))(cp, p["ln_1"], p["T_Adapter"], jnp.asarray(x))
    tree = {"attn": {"in_proj": g[0]["qkv"], "out_proj": g[0]["proj"]}, "ln_1": g[1],
            "T_Adapter": g[2]}
    return _module_grads(blk, tree, got, {"x": g[3]})


def _swin_block(seed=0):
    H, W, ws, ss, heads, C = 8, 8, 4, 2, 2, 16
    kw = dict(dim=C, H=H, W=W, num_heads=heads, window_size=ws, shift_size=ss, t_attn=False,
              num_frames=2, adapter_ratio=0.25, mode="fusion_adapt")
    st = JaxBlockStatic(**kw)
    p = block_init(jax.random.PRNGKey(seed), st)
    keys = iter(jax.random.split(jax.random.PRNGKey(seed + 1), 256))
    p = jax.tree_util.tree_map(lambda a: jax.random.normal(next(keys), a.shape) * 0.1, p)
    p["attn"]["relative_position_bias_table"] = p["attn"]["relative_position_bias_table"] * 10
    p["norm1"]["scale"] = p["norm1"]["scale"] + 1.0
    p["norm2"]["scale"] = p["norm2"]["scale"] + 1.0
    p["gate_v"], p["gate_a"] = p["gate_v"] * 8, p["gate_a"] * 8
    pst = swin.BlockStatic(**kw)
    blk = swin.SwinBlock(pst)
    blk.load_state_dict(params_from_jax(to_numpy_tree(p)), strict=True)
    return st, p, pst, blk


def _case_k4():
    st, p, pst, blk = _swin_block()
    rng = np.random.RandomState(11)
    v, a = _r(rng, 2, 64, 16), _r(rng, 2, 64, 16)
    xs = {"v": _leaf(v), "a": _leaf(a)}
    assert SB.swin_whole_block_enabled(pst)
    got = _port_grads(lambda: SB.swin_fusion_whole_block(blk, xs["v"], xs["a"], pst), xs)
    key = (st.H, st.W, st.window_size, st.shift_size, st.num_heads)
    gp, gv, ga = _jgrad(lambda p, v, a: _jax_sq(PSB._swin_block_op(p, v, a, key)),
                          argnums=(0, 1, 2))(p, jnp.asarray(v), jnp.asarray(a))
    return _module_grads(blk, gp, got, {"v": gv, "a": ga})


GRAD_CASES = {"K1_win_block": _case_k1, "K4_swin_block": _case_k4, "K5_win_fuse": _case_k5,
              "K6_bidir_fuse": _case_k6, "K7_ffn": _case_k7, "K8_wmsa": _case_k8,
              "K8_wmsa_qkv": _case_k8_qkv, "K9_layernorm": _case_k9,
              "K10_unscaled_attention": _case_k10, "K12_clip_fusion_block": _case_k12,
              "K13_clip_tadapt": _case_k13, "K14_clip_tv2": _case_k14}


@pytest.mark.parametrize("case", sorted(GRAD_CASES))
def test_float_wrapper_gradient_matches_jax_custom_vjp(monkeypatch, case):
    clear_opt_ins(monkeypatch)
    FA.reset_launches()
    port, ref = GRAD_CASES[case]()
    assert set(port) == set(ref)
    for name in port:
        np.testing.assert_allclose(port[name], np.asarray(ref[name]), rtol=RTOL, atol=ATOL,
                                   err_msg=f"{case}: d/d{name}")
    assert np.abs(np.concatenate([g.ravel() for g in port.values()])).max() > 1e-2
    assert all(k.launches == 0 for k in FA.KERNELS)      # plain versions on the CPU


def test_recompute_backward_runs_the_plain_version_and_counts_no_launch(monkeypatch):
    """The forward is the wrapper's call (its plain version here, once); the
    backward recomputes K1's plain math once more (`win_block_recompute`,
    JAX's `_win_block_naive`), under autograd, and calls nothing else; grad
    mode off or no input requiring grad takes the call directly."""
    calls = []
    plain, recompute = FA.win_block.plain, FA.win_block.recompute
    assert recompute is FA.win_block_recompute
    monkeypatch.setattr(FA.win_block, "plain",
                        lambda *a, **k: calls.append(("plain", torch.is_grad_enabled()))
                        or plain(*a, **k))
    monkeypatch.setattr(FA.win_block, "recompute",
                        lambda *a, **k: calls.append(("recompute", torch.is_grad_enabled()))
                        or recompute(*a, **k))
    rng = np.random.RandomState(12)
    x = _leaf(_r(rng, 3, 5, 16))
    w = [t(a) for a in (1 + _r(rng, 16, s=0.1), _r(rng, 16), _r(rng, 48, 16, s=0.1),
                        _r(rng, 48), _r(rng, 16, 16, s=0.1), _r(rng, 16))]
    out = FA.win_block(x, *w, 2)
    assert calls == [("plain", False)] and out.grad_fn is not None
    out.sum().backward()
    assert calls == [("plain", False), ("recompute", True)] and x.grad is not None
    assert all(a.grad is None for a in w)                 # frozen: no gradient formed
    with torch.no_grad():
        assert FA.win_block(x, *w, 2).grad_fn is None
    assert FA.win_block(x.detach(), *w, 2).grad_fn is None
    assert len(calls) == 4


def test_k1_recompute_rounds_as_jax_naive_in_bf16():
    """K1's recompute in bf16 against JAX's `_win_block_naive` in bf16 under
    jax.vjp (the XLA recompute of `_win_block_bwd`), on the same inputs and
    upstream gradient: the output equal on at least 98% of its elements and
    within 4e-3 x max |JAX|; the gradients of x, the LayerNorm, both
    weights and the bias table within 5e-3 x max |JAX|; the two bias vectors'
    gradients, sums over every row that the two programs round at other
    points, within 3e-2."""
    rng = np.random.RandomState(14)
    B_, N, C, heads, nWb = 6, 16, 64, 4, 3
    x, lw, lb = _r(rng, B_, N, C), 1 + _r(rng, C, s=0.1), _r(rng, C, s=0.1)
    wqkv, bqkv = _r(rng, C, 3 * C, s=0.1), _r(rng, 3 * C, s=0.05)
    wproj, bproj = _r(rng, C, C, s=0.1), _r(rng, C, s=0.05)
    bm, gup = _r(rng, nWb, heads, N, N), _r(rng, B_, N, C)

    def naive(x, lw, lb, wqkv, bqkv, wproj, bproj, bm):
        attn_p = {"qkv": {"kernel": wqkv, "bias": bqkv}, "proj": {"kernel": wproj, "bias": bproj}}
        return PA._win_block_naive(x, {"scale": lw, "bias": lb}, attn_p, heads,
                                   bm.reshape(nWb * heads, N, N))
    bf = jnp.bfloat16
    want, vjp = jax.vjp(naive, *(jnp.asarray(a).astype(bf)
                                 for a in (x, lw, lb, wqkv, bqkv, wproj, bproj, bm)))
    want_g = vjp(jnp.asarray(gup).astype(bf))
    leaves = [t(a).to(torch.bfloat16).requires_grad_(True)
              for a in (x, lw, lb, wqkv.T, bqkv, wproj.T, bproj, bm)]
    out = FA.win_block_recompute(*leaves[:7], heads, bias=leaves[7])
    got_g = torch.autograd.grad(out, leaves, t(gup).to(torch.bfloat16))
    f32 = lambda a: np.asarray(jnp.asarray(a).astype(jnp.float32))     # noqa: E731
    ref, port = f32(want), out.detach().float().numpy()
    assert (port == ref).mean() >= 0.98
    assert np.abs(port - ref).max() <= 4e-3 * np.abs(ref).max()
    names = ("x", "ln_w", "ln_b", "w_qkv", "b_qkv", "w_proj", "b_proj", "bias")
    for name, g, r in zip(names, got_g, want_g):
        r = f32(r).T if name in ("w_qkv", "w_proj") else f32(r)
        bar = 3e-2 if name in ("b_qkv", "b_proj") else 5e-3
        assert np.abs(g.float().numpy() - r).max() <= bar * np.abs(r).max(), name


def _int8_block_args(rng, C=32, H=64, D=8):
    q = lambda *s: torch.from_numpy(rng.randint(-127, 128, s).astype(np.int8))  # noqa: E731
    x = _leaf(_r(rng, 4, 5, C))
    ln = [t(1 + _r(rng, C, s=0.1)), t(_r(rng, C, s=0.1))]
    blk = [q(3 * C, C), t(np.abs(_r(rng, 3 * C)) * 1e-3 + 1e-3), t(_r(rng, 3 * C, s=0.1)),
           q(C, C), t(np.abs(_r(rng, C)) * 1e-3 + 1e-3), t(_r(rng, C, s=0.1))]
    ffn = [q(H, C), t(np.abs(_r(rng, H)) * 1e-3 + 1e-3), t(_r(rng, H, s=0.1)),
           q(C, H), t(np.abs(_r(rng, C)) * 1e-3 + 1e-3), t(_r(rng, C, s=0.1))]
    ad = [_leaf(_r(rng, D, C, s=0.1)), _leaf(_r(rng, D, s=0.1))]
    return x, ln, blk, ffn, ad


def _int8_calls():
    rng = np.random.RandomState(13)
    x, ln, blk, ffn, ad = _int8_block_args(rng)
    x2 = _leaf(x.detach().reshape(-1, 32).numpy())
    calls = {"K2_win_block_q": lambda: FA.win_block_q(x, *ln, *blk, 4),
             "K3_ffn_q": lambda: FA.ffn_q(x2, *ln, *ffn, "gelu"),
             "K11_win_block_qd": lambda: FA.win_block_qd(x, *ln, *blk, *ad, 4),
             "K11_win_block_qh": lambda: FA.win_block_qh(x, *ln, *blk, *ad, 4),
             "K11_ffn_qh": lambda: FA.ffn_qh(x2, *ln, *ffn, *ad, "gelu")}
    _, cblk = _clip_block(seed=3)
    for mod, name in (("attn", "in_proj"), ("attn", "out_proj"), ("mlp", "c_fc"),
                      ("mlp", "c_proj")):
        setattr(getattr(cblk, mod), name,
                quant.quantize_linear_params(getattr(getattr(cblk, mod), name)))
    v, a = _leaf(_r(rng, 2, 13, 32)), _leaf(_r(rng, 2, 9, 32))
    xt = _leaf(_r(rng, 8, 7, 32))
    calls["K12_clip_fusion_block_q"] = lambda: PCB.clip_fusion_spatial_block(cblk, v, a, 4)
    calls["K13_clip_tadapt_q"] = lambda: PCB.clip_temporal_adapt_block(
        cblk.attn, cblk.ln_1, cblk.T_Adapter, xt, 4)
    calls["K14_clip_tv2_q"] = lambda: PCB.temporal_adapt_v2(cblk.attn, cblk.ln_1,
                                                            cblk.T_Adapter, xt, 4, 4)
    _, _, pst, sblk = _swin_block(seed=4)
    for name in ("qkv", "proj"):
        setattr(sblk.attn, name, quant.quantize_linear_params(getattr(sblk.attn, name)))
    for name in ("fc1", "fc2"):
        setattr(sblk.mlp, name, quant.quantize_linear_params(getattr(sblk.mlp, name)))
    sv, sa = _leaf(_r(rng, 2, 64, 16)), _leaf(_r(rng, 2, 64, 16))
    calls["K4_swin_block_q"] = lambda: SB.swin_fusion_whole_block(sblk, sv, sa, pst)
    return calls


INT8_CASES = ("K11_ffn_qh", "K11_win_block_qd", "K11_win_block_qh", "K12_clip_fusion_block_q",
              "K13_clip_tadapt_q", "K14_clip_tv2_q", "K2_win_block_q", "K3_ffn_q",
              "K4_swin_block_q")


@pytest.mark.parametrize("case", INT8_CASES)
def test_int8_wrapper_refuses_a_gradient(monkeypatch, case):
    """The forward runs (serving never asks for a gradient); a backward
    through an int8 wrapper raises, where it would otherwise differentiate
    the plain version."""
    clear_opt_ins(monkeypatch)
    out = _int8_calls()[case]()
    outs = out if isinstance(out, tuple) else (out,)
    assert not FA.win_block_q.differentiable and FA.win_block.differentiable
    with pytest.raises(RuntimeError, match="no gradient"):
        sum(o.float().sum() for o in outs).backward()


def test_int8_wrappers_are_every_non_differentiable_one():
    assert sorted(k.name for k in FA.KERNELS if not k.differentiable) == sorted(
        ["win_block_q (K2)", "ffn_q (K3)", "win_block_qd (K11)", "win_block_qh (K11)",
         "ffn_qh (K11)", "swin_block_q (K4)", "clip_fusion_block_q (K12)",
         "clip_tadapt_q (K13)", "clip_tv2_q (K14)"])


# ---------------------------------------------------------------------------
# losses, schedules, optimizer groups
# ---------------------------------------------------------------------------

def _rel(x, ref):
    x = x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
    ref = np.asarray(ref)
    return float(np.abs(x - ref).max() / (np.abs(ref).max() + 1e-12))


def test_losses_match_jax():
    rng = np.random.RandomState(14)
    logits, onehot = _r(rng, 20, 29, s=3.0), np.eye(29, dtype=np.float32)[rng.randint(0, 29, 20)]
    labels = onehot.reshape(2, 10, 29)
    for kind in ("CE", "BCE"):
        assert _rel(losses.ave_loss(t(logits), t(labels), kind),
                    jax_losses.ave_loss(jnp.asarray(logits), jnp.asarray(labels), kind)) < 1e-6
    qa, mp, mn = _r(rng, 4, 42, s=2.0), _r(rng, 4, 2), _r(rng, 4, 2)
    ans = rng.randint(0, 42, 4).astype(np.int32)
    for kind in ("CE", "BCE"):
        got, parts = losses.avqa_loss(t(qa), t(mp), t(mn), torch.from_numpy(ans), kind)
        ref, rparts = jax_losses.avqa_loss(*(jnp.asarray(a) for a in (qa, mp, mn, ans)), kind)
        assert _rel(got, ref) < 1e-6 and _rel(parts["loss_match"], rparts["loss_match"]) < 1e-6
    pred, gt = _r(rng, 10, 16, 16, 1, s=2.0), (rng.rand(2, 16, 16, 1) > 0.5).astype(np.float32)
    a_fea = [_r(rng, 10, 8) for _ in range(2)]
    v_map = [_r(rng, 10, 8, 8, 8), _r(rng, 10, 4, 4, 8)]
    got, parts = losses.iou_semantic_aware_loss(t(pred), t(gt), [t(a) for a in a_fea],
                                                [t(m) for m in v_map], lambda_1=0.5,
                                                count_stages=(0, 1), sa_loss_flag=True)
    ref, rparts = jax_losses.iou_semantic_aware_loss(
        jnp.asarray(pred), jnp.asarray(gt), [jnp.asarray(a) for a in a_fea],
        [jnp.asarray(m) for m in v_map], lambda_1=0.5, count_stages=(0, 1), sa_loss_flag=True)
    assert _rel(got, ref) < 1e-6 and _rel(parts["sa_loss"], rparts["sa_loss"]) < 1e-6
    masks = (rng.rand(6, 16, 16) > 0.5).astype(np.float32)
    masks[0] = 0.0                                        # an empty mask
    logit_masks = _r(rng, 6, 16, 16, s=2.0)
    assert _rel(losses.mask_iou(t(logit_masks), t(masks)),
                jax_losses.mask_iou(jnp.asarray(logit_masks), jnp.asarray(masks))) < 1e-6
    out, lab = losses.avqa_match_organize(t(mp), t(mn))
    rout, rlab = jax_losses.avqa_match_organize(jnp.asarray(mp), jnp.asarray(mn))
    assert np.array_equal(out.numpy(), np.asarray(rout))
    assert np.array_equal(lab.numpy(), np.asarray(rlab))


@pytest.mark.parametrize("args", [(1e-4, 1e-7, 10, 7, 2), (5e-3, 1e-6, 3, 5, 0),
                                  (1e-4, 1e-7, 2, 3, 5)])
def test_cosine_schedule_is_jax_table(args):
    assert np.array_equal(optim.cosine_schedule(*args), jax_optim.cosine_schedule(*args))


def test_multistep_schedule_is_jax_table():
    for args in ((1e-4, 10, 5, 0.5, 30, 4), (1e-3, 2, 3, 0.1, 12, 2)):
        assert np.array_equal(optim.multistep_schedule(*args),
                              jax_optim.multistep_schedule(*args))


def _jax_clip_tree(cfg, seed):
    """A JAX CLIP AVE tree with every leaf live: linears and embeddings
    N(0, 0.02), LayerNorm scales 1 + N(0, 0.1), gates N(0, 0.5), adapter
    D_fc2 N(0, 0.02) (not zero, as the training init has it)."""
    shapes = jax.eval_shape(lambda: jax_ave.init_clip_ave(jax.random.PRNGKey(0), cfg))
    rng = np.random.RandomState(seed)

    def draw(path, x):
        s = jax.tree_util.keystr(path)
        if "gate_" in s:
            return jnp.asarray(_r(rng, *x.shape, s=0.5))
        if "'scale'" in s:
            return jnp.asarray(1.0 + _r(rng, *x.shape, s=0.1))
        return jnp.asarray(_r(rng, *x.shape, s=0.02))
    return jax.tree_util.tree_map_with_path(draw, shapes)


def _tiny():
    jcfg = jax_configs.clip_tiny_test(ftmode="fusion", label_dim=5)
    return jcfg, clip_tiny_test(ftmode="fusion", label_dim=5)


def test_trainable_partition_and_groups_match_jax():
    jcfg, cfg = _tiny()
    tree = _jax_clip_tree(jcfg, 0)
    model = clip_ave_from_jax(cfg, to_numpy_tree(tree), device="cpu")
    for freeze in (True, False):
        full = jax.tree_util.tree_map(lambda m, x: np.full(x.shape, m),
                                      jax_optim.trainable_mask(tree, freeze), tree)
        ref = {k: bool(v.all()) for k, v in params_from_jax(full).items()}
        assert optim.trainable_mask(model, freeze) == ref
    mask = steps.init_train_state(model)
    opt = optim.build_optimizer(model, 1e-3, 10.0)
    groups = {g["name"]: g["names"] for g in opt.adam.param_groups}
    labels = optim.label_params(model)
    assert sorted(groups) == ["adapt", "head"]
    assert set(groups["head"]) == {n for n in mask if labels[n] == "head"}
    assert set(groups["adapt"]) == {n for n in mask if mask[n] and labels[n] == "adapt"}
    assert all(g["weight_decay"] == 5e-7 and g["betas"] == (0.95, 0.999) and g["eps"] == 1e-8
               for g in opt.adam.param_groups)
    assert opt.lr("adapt", 0) == 1e-3 and opt.lr("head", 7) == pytest.approx(1e-2)


# ---------------------------------------------------------------------------
# three train steps against JAX's make_train_step
# ---------------------------------------------------------------------------

def _batches(cfg, n, seed):
    rng = np.random.RandomState(seed)
    T, r = cfg.num_frames, cfg.input_resolution
    out = []
    for _ in range(n):
        labels = np.eye(cfg.label_dim, dtype=np.float32)[rng.randint(0, cfg.label_dim, 2 * T)]
        out.append({"a": _r(rng, 2, T, cfg.audio_tdim, cfg.audio_fdim),
                    "v": _r(rng, 2, T, r, r, 3), "labels": labels.reshape(2, T, -1)})
    return out


@pytest.fixture(scope="module")
def three_steps():
    jcfg, cfg = _tiny()
    tree = _jax_clip_tree(jcfg, 1)
    batches = _batches(cfg, 3, 2)
    lr = optim.cosine_schedule(1e-4, 1e-7, 1, 3)          # the reference's lr, head_lr 10
    head_lr = optim.cosine_schedule(1e-3, 1e-7, 1, 3)

    def jax_loss(p, batch, rng):
        logits = jax_ave.apply_clip_ave(p, jcfg, batch["a"], batch["v"])
        return jax_losses.ave_loss(logits, batch["labels"]), {}

    tx = jax_optim.build_optimizer(None, 1e-4, 10.0, lr_table=lr, head_lr_table=head_lr)
    tp, fp, opt_state, _ = jax_steps.init_train_state(tree, tx)
    step = jax_steps.make_train_step(jax_loss, tx, donate=False, compute_dtype=jnp.float32)
    jbatches = [{k: jnp.asarray(v) for k, v in b.items()} for b in batches]
    jgrad = jax.jit(jax.grad(lambda tp_: jax_loss(jax_optim.merge_params(tp_, fp), jbatches[0],
                                                  None)[0]))(tp)
    jlosses = []
    for b in jbatches:
        tp, opt_state, loss, _ = step(tp, fp, opt_state, b, jax.random.PRNGKey(0))
        jlosses.append(float(loss))
    jfinal = params_from_jax(to_numpy_tree(jax_optim.merge_params(tp, fp)))

    model = clip_ave_from_jax(cfg, to_numpy_tree(tree), device="cpu")
    before = {k: v.clone() for k, v in model.state_dict().items()}
    steps.init_train_state(model)
    opt = optim.build_optimizer(model, 1e-4, 10.0, lr_table=lr, head_lr_table=head_lr)

    def port_loss(m, batch, generator):
        logits = ave.apply_clip_ave(m, cfg, t(batch["a"]), t(batch["v"]), generator=generator)
        return losses.ave_loss(logits, t(batch["labels"])), {}

    train_step = steps.make_train_step(port_loss, opt, torch.float32)
    plosses, pgrad = [], None
    for b in batches:
        loss, _ = train_step(model, b)
        plosses.append(float(loss))
        if pgrad is None:
            pgrad = {n: p.grad.clone() for n, p in model.named_parameters() if p.requires_grad}
    jgrad = {k: v.numpy() for k, v in params_from_jax(to_numpy_tree(
        jax.tree_util.tree_map(lambda g: np.zeros(()) if g is None else g, jgrad,
                               is_leaf=lambda x: x is None))).items() if k in pgrad}
    return dict(model=model, before=before, jfinal=jfinal, jlosses=jlosses, plosses=plosses,
                jgrad=jgrad, pgrad=pgrad)


def test_three_train_steps_losses_match_jax(three_steps):
    for p, j in zip(three_steps["plosses"], three_steps["jlosses"]):
        assert abs(p - j) <= 1e-5 * abs(j)
    assert three_steps["plosses"][0] != three_steps["plosses"][2]


def test_first_step_gradients_match_jax(three_steps):
    pgrad, jgrad = three_steps["pgrad"], three_steps["jgrad"]
    assert set(pgrad) == set(jgrad) and len(pgrad) > 10
    live = 0
    for n, g in pgrad.items():
        ref = jgrad[n]
        scale = float(np.abs(ref).max())
        assert float(np.abs(g.numpy() - ref).max()) <= 1e-4 * scale + 1e-12, n
        live += scale > 0
    assert all(float(pgrad[n].abs().max()) > 0 for n in pgrad
               if n.endswith(("gate_v", "gate_a")) or ".D_fc1." in n)   # the fusion is live
    assert live == len(pgrad)


def test_three_train_steps_trainables_and_frozen_match_jax(three_steps):
    model, before, jfinal = three_steps["model"], three_steps["before"], three_steps["jfinal"]
    state = model.state_dict()
    moved = {n for n, p in model.named_parameters() if p.requires_grad}
    biggest = max(float((jfinal[n].float() - before[n]).abs().max()) for n in moved)
    assert biggest > 0
    for n, v in state.items():
        if n in moved:
            upd, ref = v - before[n], jfinal[n].float() - before[n]
            assert float((upd - ref).abs().max()) <= 2e-3 * biggest, n
            assert float(upd.abs().max()) > 0, n
        else:
            assert torch.equal(v, before[n]), n             # frozen: bit for bit
            assert torch.equal(jfinal[n].to(v.dtype), v), n


def test_head_dropout_keeps_half_and_scales_by_two():
    head = ave.MlpHead(8, 5)
    torch.nn.init.normal_(head.fc1.weight)
    torch.nn.init.normal_(head.fc2.weight)
    x = torch.randn(4000, 16)
    h = ave.linear(head.fc1, x)
    seen = {}
    real = ave.linear

    def spy(p, z):
        if p is head.fc2:
            seen["x"] = z
        return real(p, z)
    ave_linear = ave.linear
    ave.linear = spy
    try:
        out = ave.mlp_head_apply(head, x, generator=torch.Generator().manual_seed(0))
    finally:
        ave.linear = ave_linear
    plain = ave.mlp_head_apply(head, x)
    kept = seen["x"] != 0
    n = kept.numel()
    assert abs(kept.float().mean().item() - 0.5) < 3 * (0.25 / n) ** 0.5
    assert torch.equal(seen["x"][kept], (h * 2.0)[kept])
    assert not torch.equal(out, plain)
    assert torch.equal(plain, ave.linear(head.fc2, h))       # no generator: no dropout


# ---------------------------------------------------------------------------
# checkpoints and the Trainer
# ---------------------------------------------------------------------------

def _trainer(tmp, n_epochs, lr_mode="cosine"):
    jcfg, cfg = _tiny()
    model = clip_ave_from_jax(cfg, to_numpy_tree(_jax_clip_tree(jcfg, 3)), device="cpu")
    batches = _batches(cfg, 4, 5)

    def loss_fn(m, batch, generator):
        logits = ave.apply_clip_ave(m, cfg, t(batch["a"]), t(batch["v"]), generator=generator)
        return losses.ave_loss(logits, t(batch["labels"])), {}

    def eval_fn(m, loader):
        with torch.no_grad():
            return {"acc": float(np.mean([loss_fn(m, b, None)[0].item() for b in loader]))}

    trainer = Trainer(loss_fn=loss_fn, eval_fn=eval_fn, model=model, base_lr=1e-3,
                      head_lr_mult=10.0, n_epochs=n_epochs, steps_per_epoch=2,
                      warmup_epochs=1, exp_dir=str(tmp), compute_dtype=torch.float32,
                      lr_mode=lr_mode)
    return trainer, batches[:2], batches[2:]


def test_checkpoint_round_trip_is_bit_for_bit(tmp_path):
    trainer, train, val = _trainer(tmp_path / "a", 1)
    trainer.fit(train, val)
    save_checkpoint(str(tmp_path / "ck" / "params"), trainer.params())
    got = load_checkpoint(str(tmp_path / "ck" / "params"))
    ref = trainer.params()
    assert set(got) == set(ref)
    assert all(torch.equal(got[k], ref[k]) and got[k].dtype == ref[k].dtype for k in ref)
    opt_state = trainer.opt.state_dict()
    assert any(k.endswith("exp_avg_sq") for k in opt_state)
    save_checkpoint(str(tmp_path / "ck" / "opt"), opt_state)
    back = load_checkpoint(str(tmp_path / "ck" / "opt"))
    assert all(torch.equal(back[k], opt_state[k]) for k in opt_state)
    mixed = {"i8": torch.arange(5, dtype=torch.int8), "bf": torch.randn(3).bfloat16()}
    save_checkpoint(str(tmp_path / "ck" / "mixed"), mixed)
    back = load_checkpoint(str(tmp_path / "ck" / "mixed"))
    assert all(torch.equal(back[k], mixed[k]) and back[k].dtype == mixed[k].dtype for k in mixed)


@pytest.mark.parametrize("lr_mode", ["cosine", "plateau"])
def test_trainer_resume_reaches_the_straight_run(tmp_path, lr_mode):
    """Interrupted after epoch 1 (the same tables), then resumed: the masters,
    Adam moments and history equal the straight run's bit for bit."""
    straight, train, val = _trainer(tmp_path / "s", 2, lr_mode)
    straight.fit(train, val)
    first, _, _ = _trainer(tmp_path / "r", 2, lr_mode)
    first.n_epochs = 1
    first.fit(train, val)
    resumed, _, _ = _trainer(tmp_path / "r", 2, lr_mode)
    resumed.fit(train, val, resume=True)
    assert [h["epoch"] for h in resumed.history] == [1, 2]
    assert resumed.history == straight.history and resumed.global_step == 4
    ref = straight.trainable()
    assert all(torch.equal(p, ref[n]) for n, p in resumed.trainable().items())
    a, b = resumed.opt.state_dict(), straight.opt.state_dict()
    assert set(a) == set(b) and all(torch.equal(a[k], b[k]) for k in a)
    for name in ("result.csv", "progress.json", "state_meta.json", "models/model.2",
                 "models/best_model", "state/train_params", "state/opt_state"):
        assert os.path.exists(tmp_path / "r" / name)


def test_result_files_match_jax_trainer(tmp_path):
    """The same history gives the same result.csv and progress.json as JAX's
    Trainer (columns epoch, loss, then the metrics in first-seen order)."""
    history = [{"epoch": 1, "loss": 2.5, "acc": 0.25}, {"epoch": 2, "loss": 2.0, "acc": 0.5,
                                                          "mAP": 0.1}]
    trainer, _, _ = _trainer(tmp_path / "port", 1)
    trainer.history, trainer.best_epoch, trainer.best_metric = history, 2, 0.5
    trainer._write_results()

    class Fake:
        exp_dir = str(tmp_path / "jax")
    os.makedirs(Fake.exp_dir)
    fake = Fake()
    fake.history, fake.best_epoch, fake.best_metric = history, 2, 0.5
    jax_loop.Trainer._write_results(fake)
    for name in ("result.csv", "progress.json"):
        with open(tmp_path / "port" / name) as f, open(tmp_path / "jax" / name) as g:
            assert f.read() == g.read()
    with open(tmp_path / "port" / "result.csv") as f:
        assert next(csv.reader(f)) == ["epoch", "loss", "acc", "mAP"]


def test_weight_average_is_the_mean():
    sds = [{"w": torch.full((3,), float(i))} for i in (1, 2, 6)]
    assert torch.equal(weight_average(sds)["w"], torch.full((3,), 3.0))
