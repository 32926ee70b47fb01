"""Swin training in the PyTorch port (stgcma_tpu_torch) against the JAX
package on the CPU, at tiny sizes.

- Each float kernel's backward recompute in **bf16** against the JAX
  function that its `custom_vjp` backward differentiates or writes out,
  on the same bf16 inputs and upstream gradient: K4 `swin_block_recompute`
  against `jax.vjp` of `_fullgrid_naive`, K5 / K6 the port's
  `cross_modal_fuse` against JAX's, K7 `ffn_recompute` against
  `_ffn_naive`, K8 `wmsa_recompute` against `_wmsa_bwd` itself (with the
  bias gradient `dbm`) and `wmsa_qkv_recompute` against `jax.vjp` of JAX's
  site around `_wmsa_attention`, K10 `unscaled_attention_recompute` against
  `_bwd`, K12-K14 `clip_block.py`'s recomputes against `_fusion_spatial_naive`,
  `_tadapt_naive` and `_tv2_naive` (with an adapter, and with a bias and
  none), and K9's `layernorm_plain` against `common.layernorm`. Two
  programs that round every product, activation and residual to bf16 at
  the same points still sum in other orders and evaluate GELU, erf and exp
  in other libraries, so a few elements land one bf16 step apart and the
  steps travel downstream; XLA also adds a product's bias and takes its
  GELU before rounding once where the JAX function rounds three times.
  Bars, as max |port - JAX| over max |JAX| of each tensor (`BARS`;
  measured in brackets): the outputs within 1e-2 for K4, K12 (two fusions,
  an FFN and three residuals deep; 4.6e-3, 7.6e-3) and K7 (4.8e-3), 5e-3
  for K5, K6, K13, K14 (<= 2.1e-3), whose outputs are also equal on at
  least 95% of their elements (>= 97.9%); the gradients within 3e-2 for
  the blocks K4, K12-K14 (<= 2.0e-2), 1e-2 for K5-K7 (<= 7.4e-3) and 1e-4
  for K8 / K10, whose backwards run in fp32 from the same saved bf16
  inputs (1.5e-5). A gradient that sums over every row (the gates', a few
  biases') is summed in bf16 by XLA's CPU reduction, up to 81% from the
  port's (K12's gate_a) and 4.9x its own value from JAX's gradient in fp32
  of the same bf16 values; where the port lies past the bar, it is held to
  that fp32 gradient, no further from it than JAX's bf16 gradient is (the
  port's are 0.1% to 10% from it). K9 bit for bit.
- Each float wrapper's recompute against its plain version on **float64**
  inputs (K1, K4-K8, K10, K12-K14; the witness of `chip_smoke.py`'s
  gradient rows): with no bf16 rounding left, every leaf's gradient within
  1e-4 of its max under a random upstream gradient and under the output's
  own (measured <= 1.1e-6: both keep a few steps in fp32).
- A tiny Swin model served through `MultiTaskServer.predict` (inference
  mode), then one train step of it in the same process: the caches of
  window indices, masks and K4's geometry keep no inference tensor.
- Three fp32 train steps of a live tiny Swin `fusion` AVE (K1 at the
  windows and temporal sites, K5, K6, K4 shifted and unshifted, K8 with
  its temporal table) against JAX's `make_train_step` on the same tree
  and batches: losses within 1e-5 relative, the step-1 gradients within
  1e-4 of each leaf's max |g| (measured <= 4.3e-6), the relative and
  temporal bias tables among them; a gate's gradient, one sum over its
  block that may nearly cancel, within 1e-4 of the largest gate's (the
  last stage's second gate_v sums to 3.4e-5, 1/27 of the largest, and the
  two programs' fp32 sums differ by 5.1e-9); the trainable leaves after
  step 3 within 2e-3 of the
  largest update (Adam, as tests/test_torch_port_train.py says why), the
  frozen ones bit for bit.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from stgcma_tpu.configs import swin_tiny_test as jax_swin_tiny_test
from stgcma_tpu.models import ave as jax_ave
from stgcma_tpu.ops import attention as JA
from stgcma_tpu.ops import common as JC
from stgcma_tpu.ops import pallas_attn as PA
from stgcma_tpu.ops import pallas_clip_block as CB
from stgcma_tpu.ops import pallas_swin_block as PSB
from stgcma_tpu.train import losses as jax_losses
from stgcma_tpu.train import optim as jax_optim
from stgcma_tpu.train import steps as jax_steps
from stgcma_tpu_torch.checkpoint.convert import params_from_jax, swin_ave_from_jax
from stgcma_tpu_torch.configs import swin_tiny_test
from stgcma_tpu_torch.models import ave
from stgcma_tpu_torch.nn import swin
from stgcma_tpu_torch.ops import clip_block as PCB
from stgcma_tpu_torch.ops import fused_attn as FA
from stgcma_tpu_torch.ops import swin_block as SB
from stgcma_tpu_torch.ops.attention import cross_modal_fuse, gather_bias
from stgcma_tpu_torch.serving import MultiTaskServer
from stgcma_tpu_torch.train import losses, optim, steps

from test_torch_port_train import _clip_block, _r, _swin_block
from torch_port_helpers import clear_opt_ins, t, to_numpy_tree

BF = jnp.bfloat16


def _jb(a):
    return jnp.asarray(a).astype(BF)


def _tb(a, dtype=torch.bfloat16):
    return t(a).to(dtype).requires_grad_(True)


def _np32(a):
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _grads(outs, leaves, gups):
    """{name: fp32 numpy} gradients of `outs` w.r.t. the named leaves."""
    outs = outs if isinstance(outs, tuple) else (outs,)
    names = list(leaves)
    got = torch.autograd.grad(outs, [leaves[n] for n in names], gups, allow_unused=True)
    return {n: (np.zeros(leaves[n].shape, np.float32) if g is None else _np32(g))
            for n, g in zip(names, got)}


def _tree32(tree):
    return jax.tree_util.tree_map(lambda a: np.asarray(jnp.asarray(a).astype(jnp.float32)), tree)


def _module_grads(module, *tree_grads):
    """The port's gradients by its parameter names (each parameter's .grad),
    and JAX's gradient trees mapped by `params_from_jax`."""
    refs = [{k: v.numpy() for k, v in params_from_jax(_tree32(g)).items()} for g in tree_grads]
    port = {n: _np32(p.grad) if p.grad is not None else np.zeros(p.shape, np.float32)
            for n, p in module.named_parameters() if n in refs[0]}
    assert set(port) == set(refs[0])
    return (port, *refs)


def _bf16_module(module):
    module.to(torch.bfloat16)
    for p in module.parameters():
        p.requires_grad_(True)
        p.grad = None
    return module


def _jax_vjp(fn, primals, gups):
    """JAX's output and gradients of fn in bf16 at the bf16 `primals`, and
    its gradients in fp32 at the same values: the yardstick where XLA's CPU
    reduction sums a gradient (a gate's, a bias's) in bf16."""
    @jax.jit
    def run(primals, gups):
        want, vjp = jax.vjp(fn, *primals)
        return want, vjp(gups)

    def cast(tree, dt):
        return jax.tree_util.tree_map(lambda z: jnp.asarray(z).astype(BF).astype(dt), tree)
    want, gb = run(cast(primals, BF), cast(gups, BF))
    return want, gb, run(cast(primals, jnp.float32), cast(gups, jnp.float32))[1]


# ---------------------------------------------------------------------------
# each recompute in bf16 against its JAX function
# ---------------------------------------------------------------------------

def _case_k4():
    st, p, _, blk = _swin_block(seed=3)
    heads, N, C = st.num_heads, st.H * st.W, st.dim
    rng = np.random.RandomState(21)
    v, a, gv, ga = (_r(rng, 2, N, C) for _ in range(4))
    geo = PSB._geo(st.H, st.W, st.window_size, st.shift_size)
    want, (jp, jv, ja), (fp, fv, fa) = _jax_vjp(
        lambda p_, v_, a_: PSB._fullgrid_naive(p_, v_, a_, heads, geo), (p, v, a), (gv, ga))
    blk = _bf16_module(blk)
    index, attn_mask, fuse_mask = SB._geo_tensors(st.H, st.W, st.window_size, st.shift_size,
                                                  torch.device("cpu"))
    bias = (gather_bias(blk.attn.relative_position_bias_table, index, heads, N)
            + attn_mask)[None]
    xs = {"v": _tb(v), "a": _tb(a)}
    out = SB.swin_block_recompute(xs["v"], xs["a"], SB.block_weights(blk), heads, bias,
                                  fuse_mask)
    torch.autograd.backward(out, (t(gv).bfloat16(), t(ga).bfloat16()))
    port, ref, ref32 = _module_grads(blk, jp, fp)
    port.update({k: _np32(x.grad) for k, x in xs.items()})
    ref.update({"v": _np32(jv), "a": _np32(ja)})
    ref32.update({"v": _np32(fv), "a": _np32(fa)})
    return (out, want), port, ref, ref32


def _case_fuse(B, Nv, Na, D, seed):
    rng = np.random.RandomState(seed)
    arrays = (_r(rng, B, Nv, D, s=0.7), _r(rng, B, Na, D, s=0.7),
              np.array([0.8], np.float32), np.array([-0.6], np.float32))
    gups = (_r(rng, B, Nv, D), _r(rng, B, Na, D))
    want, gb, g32 = _jax_vjp(lambda *x: JA.cross_modal_fuse(*x), arrays, gups)
    names = ("vh", "ah", "gate_v", "gate_a")
    leaves = dict(zip(names, (_tb(x) for x in arrays)))
    out = cross_modal_fuse(*leaves.values())
    return ((out, want), _grads(out, leaves, tuple(t(g).bfloat16() for g in gups)),
            dict(zip(names, gb)), dict(zip(names, g32)))


def _case_k7():
    rng = np.random.RandomState(22)
    M, C, H = 40, 32, 128
    x, lw, lb = _r(rng, M, C), 1 + _r(rng, C, s=0.1), _r(rng, C, s=0.1)
    w1, b1, w2, b2 = (_r(rng, C, H, s=0.2), _r(rng, H, s=0.1), _r(rng, H, C, s=0.1),
                      _r(rng, C, s=0.1))
    g = _r(rng, M, C)
    want, gb, g32 = _jax_vjp(lambda *z: PA._ffn_naive(*z, "gelu"), (x, lw, lb, w1, b1, w2, b2),
                             g)
    leaves = {"x": _tb(x), "ln_w": _tb(lw), "ln_b": _tb(lb), "w1": _tb(w1.T), "b1": _tb(b1),
              "w2": _tb(w2.T), "b2": _tb(b2)}
    out = FA.ffn_recompute(*leaves.values())

    def named(j):
        return dict(zip(leaves, (j[0], j[1], j[2], _np32(j[3]).T, j[4], _np32(j[5]).T, j[6])))
    return (out, want), _grads(out, leaves, t(g).bfloat16()), named(gb), named(g32)


def _case_k8():
    """K8's backward against `_wmsa_bwd` itself (fp32 inside): the
    recompute's output is not the forward's (its probabilities are not
    rounded), so only the gradients are compared."""
    rng = np.random.RandomState(23)
    R, N, dh, P = 12, 16, 16, 4
    q, k, v, g = (_r(rng, R, N, dh) for _ in range(4))
    bm = _r(rng, P, N, N)
    j = dict(zip(("q", "k", "v", "bm"),
                 PA._wmsa_bwd((_jb(q), _jb(k), _jb(v), jnp.asarray(bm)), _jb(g))))
    leaves = {"q": _tb(q), "k": _tb(k), "v": _tb(v), "bm": _tb(bm, torch.float32)}
    out = FA.wmsa_recompute(*leaves.values())
    assert out.dtype == torch.bfloat16
    return None, _grads(out, leaves, t(g).bfloat16()), j, j


def _case_k8_site():
    rng = np.random.RandomState(24)
    B_, N, heads, dh, P = 4, 10, 4, 16, 4
    C = heads * dh
    qkv, bm, g = _r(rng, B_, N, 3 * C), _r(rng, P, N, N), _r(rng, B_, N, C)

    def site(qkv, bm):
        q, k, v = qkv.reshape(B_, N, 3, heads, dh).transpose(2, 0, 3, 1, 4)
        q = q * dh ** -0.5
        out = PA._wmsa_attention(*(x.reshape(B_ * heads, N, dh) for x in (q, k, v)),
                                 bm.astype(jnp.float32))
        return out.reshape(B_, heads, N, dh).transpose(0, 2, 1, 3).reshape(B_, N, C)
    _, vjp = jax.vjp(site, _jb(qkv), jnp.asarray(bm))
    j = dict(zip(("qkv", "bm"), jax.jit(vjp)(_jb(g))))
    leaves = {"qkv": _tb(qkv), "bm": _tb(bm, torch.float32)}
    out = FA.wmsa_qkv_recompute(leaves["qkv"], leaves["bm"], heads)
    return None, _grads(out, leaves, t(g).bfloat16()), j, j


def _case_k10():
    rng = np.random.RandomState(25)
    q, k, v, g = _r(rng, 2, 24, 16), _r(rng, 2, 40, 16), _r(rng, 2, 40, 16), _r(rng, 2, 24, 16)
    j = dict(zip("qkv", PA._bwd((_jb(q), _jb(k), _jb(v)), _jb(g))))
    leaves = {"q": _tb(q), "k": _tb(k), "v": _tb(v)}
    out = FA.unscaled_attention_recompute(*leaves.values())
    return None, _grads(out, leaves, t(g).bfloat16()), j, j


def _clip_case(seed, jax_fn, port_fn, x_shapes):
    """A live CLIP block in bf16: JAX's function of (tree, *xs) under
    jax.vjp against the port's of (block, *xs) under autograd, with one
    upstream gradient per output."""
    p, blk = _clip_block(seed=seed)
    rng = np.random.RandomState(30 + seed)
    xs = [_r(rng, *s, s=0.5) for s in x_shapes]
    shapes = jax.eval_shape(jax_fn, p, *(jnp.asarray(x) for x in xs))
    multi = isinstance(shapes, tuple)
    gups = [_r(rng, *o.shape) for o in (shapes if multi else (shapes,))]
    want, gb, g32 = _jax_vjp(jax_fn, (p, *xs), tuple(gups) if multi else gups[0])
    blk = _bf16_module(blk)
    leaves = [_tb(x) for x in xs]
    out = port_fn(blk, *leaves)
    outs = out if isinstance(out, tuple) else (out,)
    torch.autograd.backward(outs, [t(g).bfloat16() for g in gups])
    port, ref, ref32 = _module_grads(blk, gb[0], g32[0])
    for i, x in enumerate(leaves):
        port[f"x{i}"], ref[f"x{i}"], ref32[f"x{i}"] = (_np32(x.grad), _np32(gb[1 + i]),
                                                        _np32(g32[1 + i]))
    return (out, want), port, ref, ref32


def _case_k12():
    return _clip_case(4, lambda p, v, a: CB._fusion_spatial_naive({**p, "__heads__": 4}, v, a),
                      lambda b, v, a: PCB.fusion_block_recompute(v, a, PCB.block_weights(b), 4),
                      [(2, 13, 32), (2, 9, 32)])


def _case_k13():
    return _clip_case(5, lambda p, x: CB._tadapt_naive(p["attn"], p["ln_1"], p["T_Adapter"], x, 4),
                      lambda b, x: PCB.tadapt_recompute(
                          x, PCB.tadapt_weights(b.attn, b.ln_1, b.T_Adapter), 4), [(6, 5, 32)])


def _tv2_cp(p):
    return {"qkv": p["attn"]["in_proj"], "proj": p["attn"]["out_proj"]}


def _case_k14():
    T = 4
    return _clip_case(6, lambda p, x: PA._tv2_naive(_tv2_cp(p), p["ln_1"], p["T_Adapter"], x,
                                                    None, 4, T),
                      lambda b, x: PCB.tv2_recompute(
                          x, PCB.tadapt_weights(b.attn, b.ln_1, b.T_Adapter), 4, T),
                      [(2 * T, 7, 32)])


def _case_k14_bias():
    T = 4
    bias = _r(np.random.RandomState(26), 4, T, T)
    return _clip_case(7, lambda p, x: PA._tv2_naive(_tv2_cp(p), p["ln_1"], None, x,
                                                    jnp.asarray(bias), 4, T),
                      lambda b, x: PCB.tv2_recompute(
                          x, PCB.tadapt_weights(b.attn, b.ln_1, None), 4, T, t(bias)),
                      [(2 * T, 7, 32)])


CASES = {"K4_swin_block": _case_k4, "K5_win_fuse": lambda: _case_fuse(6, 49, 49, 16, 27),
         "K6_bidir_fuse": lambda: _case_fuse(2, 48, 32, 32, 28), "K7_ffn": _case_k7,
         "K8_wmsa": _case_k8, "K8_wmsa_qkv": _case_k8_site, "K10_unscaled_attention": _case_k10,
         "K12_clip_fusion_block": _case_k12, "K13_clip_tadapt": _case_k13,
         "K14_clip_tv2": _case_k14, "K14_clip_tv2_bias": _case_k14_bias}
# (output bar, share of output elements equal at least, gradient bar), the
# bars as max |port - JAX| over max |JAX| of each tensor
BARS = {"K4_swin_block": (1e-2, 0.0, 3e-2), "K12_clip_fusion_block": (1e-2, 0.0, 3e-2),
        "K7_ffn": (1e-2, 0.0, 1e-2), "K5_win_fuse": (5e-3, 0.95, 1e-2),
        "K6_bidir_fuse": (5e-3, 0.95, 1e-2), "K13_clip_tadapt": (5e-3, 0.95, 3e-2),
        "K14_clip_tv2": (5e-3, 0.95, 3e-2), "K14_clip_tv2_bias": (5e-3, 0.95, 3e-2),
        "K8_wmsa": (None, None, 1e-4), "K8_wmsa_qkv": (None, None, 1e-4),
        "K10_unscaled_attention": (None, None, 1e-4)}


def _rel(x, ref):
    x, ref = _np32(x), _np32(ref)
    return float(np.abs(x - ref).max()) / (float(np.abs(ref).max()) + 1e-30)


@pytest.mark.parametrize("case", sorted(CASES))
def test_recompute_rounds_as_its_jax_function_in_bf16(monkeypatch, case):
    clear_opt_ins(monkeypatch)
    outs, port, ref, ref32 = CASES[case]()
    out_bar, same_bar, grad_bar = BARS[case]
    if outs is not None:
        got, want = outs
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        for o, w in zip(got, want):
            assert o.dtype == torch.bfloat16
            assert _rel(o, w) <= out_bar, (case, _rel(o, w))
            assert (_np32(o) == _np32(w)).mean() >= same_bar, (case, (_np32(o) == _np32(w)).mean())
    assert set(port) == set(ref) == set(ref32)
    live = 0
    for name in port:
        r = _np32(ref[name])
        assert port[name].shape == r.shape, name
        if np.abs(r).max() == 0:
            assert np.abs(port[name]).max() == 0, f"{case}: d/d{name}"
            continue
        live += 1
        if _rel(port[name], r) > grad_bar:
            # a sum over every row (a gate's, a bias's gradient), which XLA's
            # CPU reduction accumulates in bf16: held to JAX's gradient in
            # fp32, no further from it than JAX's own bf16 gradient is
            far = max(grad_bar, _rel(r, ref32[name]))
            assert _rel(port[name], ref32[name]) <= far, (case, name, _rel(port[name], r),
                                                          _rel(port[name], ref32[name]), far)
    assert live >= min(3, len(port))


def test_k9_plain_version_is_common_layernorm_in_bf16():
    """K9's recompute is its plain version, which is already the port of the
    JAX `common.layernorm` that `_ln_bwd` differentiates: in bf16, output and
    gradients bit for bit."""
    assert FA.layernorm.recompute is FA.layernorm_plain
    rng = np.random.RandomState(29)
    x, w, b, g = _r(rng, 24, 64, s=2.0), 1 + _r(rng, 64, s=0.1), _r(rng, 64, s=0.1), _r(rng, 24, 64)
    want, vjp = jax.vjp(lambda x_, s_, b_: JC.layernorm({"scale": s_, "bias": b_}, x_),
                        _jb(x), _jb(w), _jb(b))
    leaves = {"x": _tb(x), "w": _tb(w), "b": _tb(b)}
    out = FA.layernorm_plain(*leaves.values())
    got = _grads(out, leaves, t(g).to(torch.bfloat16))
    assert np.array_equal(_np32(out), _np32(want))
    for name, r in zip(leaves, vjp(_jb(g))):
        assert np.array_equal(got[name], _np32(r)), name


def test_every_float_wrapper_recomputes_no_plain_version():
    """The backward of each float wrapper differentiates its own recompute,
    the port of its JAX reference; the plain versions stay the yardstick
    (K9's plain version is `common.layernorm`'s port, shown above)."""
    float_kernels = [k for k in FA.KERNELS if k.differentiable]
    assert sorted({k.id for k in float_kernels}) == ["K1", "K10", "K12", "K13", "K14", "K4", "K5",
                                                     "K6", "K7", "K8", "K9"]
    for k in float_kernels:
        assert (k.recompute is not k.plain) != (k.id == "K9"), k.name
    assert FA.win_fuse.recompute is cross_modal_fuse is FA.bidir_fuse.recompute


# ---------------------------------------------------------------------------
# each recompute in float64 against its plain version
# ---------------------------------------------------------------------------

def _d(rng, *shape, s=1.0):
    return torch.from_numpy(rng.randn(*shape) * s)


def _f64_k1(rng):
    C, heads, N = 32, 4, 16
    lv = dict(zip(("x", "ln_w", "ln_b", "w_qkv", "b_qkv", "w_proj", "b_proj"), (
        _d(rng, 6, N, C), 1 + _d(rng, C, s=0.1), _d(rng, C, s=0.1), _d(rng, 3 * C, C, s=0.2),
        _d(rng, 3 * C, s=0.1), _d(rng, C, C, s=0.2), _d(rng, C, s=0.1))))
    lv["table"] = _d(rng, 2 * N - 1, heads, s=0.5)
    idx = torch.from_numpy(np.abs(np.arange(N)[:, None] - np.arange(N)[None]) + 0)

    def run(fn, lv):
        bias = gather_bias(lv["table"], idx, heads, N)[None]
        return fn(*(lv[n] for n in list(lv)[:7]), heads, bias=bias)
    return FA.win_block, run, lv


def _f64_k4(rng):
    st, _, _, blk = _swin_block(seed=3)
    heads, N, C = st.num_heads, st.H * st.W, st.dim
    index, attn_mask, fuse_mask = SB._geo_tensors(st.H, st.W, st.window_size, st.shift_size,
                                                  torch.device("cpu"))
    w = {k: x.detach().double() for k, x in SB.block_weights(blk).items()}
    lv = {"v": _d(rng, 2, N, C), "a": _d(rng, 2, N, C), **w,
          "table": blk.attn.relative_position_bias_table.detach().double()}

    def run(fn, lv):
        bias = (gather_bias(lv["table"], index, heads, N) + attn_mask)[None]
        return fn(lv["v"], lv["a"], {k: lv[k] for k in w}, heads, bias, fuse_mask)
    return SB.swin_block, run, lv


def _f64_fuse(kernel):
    def case(rng):
        lv = {"vh": _d(rng, 4, 49, 16, s=0.7), "ah": _d(rng, 4, 49, 16, s=0.7),
              "gate_v": torch.tensor([0.8], dtype=torch.float64),
              "gate_a": torch.tensor([-0.6], dtype=torch.float64)}
        return kernel, lambda fn, lv: fn(*lv.values()), lv
    return case


def _f64_k7(rng):
    C, H = 32, 128
    lv = dict(zip(("x", "ln_w", "ln_b", "w1", "b1", "w2", "b2"), (
        _d(rng, 40, C), 1 + _d(rng, C, s=0.1), _d(rng, C, s=0.1), _d(rng, H, C, s=0.2),
        _d(rng, H, s=0.1), _d(rng, C, H, s=0.1), _d(rng, C, s=0.1))))
    return FA.ffn, lambda fn, lv: fn(*lv.values()), lv


def _f64_k8(rng):
    B_, N, heads, C = 4, 10, 4, 64
    lv = {"qkv": _d(rng, B_, N, 3 * C), "table": _d(rng, 2 * N - 1, heads, s=0.5)}
    idx = torch.from_numpy(np.abs(np.arange(N)[:, None] - np.arange(N)[None]))
    return FA.wmsa_qkv, lambda fn, lv: fn(lv["qkv"], gather_bias(lv["table"], idx, heads, N),
                                          heads), lv


def _f64_k10(rng):
    lv = {"q": _d(rng, 2, 24, 16), "k": _d(rng, 2, 40, 16), "v": _d(rng, 2, 40, 16)}
    return FA.unscaled_attention, lambda fn, lv: fn(*lv.values()), lv


def _f64_clip(kernel, weights, xs, *extra):
    def case(rng):
        _, blk = _clip_block(seed=4)
        w = {k: x.detach().double() for k, x in weights(blk).items()}
        lv = {**{f"x{i}": _d(rng, *s, s=0.5) for i, s in enumerate(xs)}, **w}

        def run(fn, lv):
            return fn(*(lv[f"x{i}"] for i in range(len(xs))), {k: lv[k] for k in w}, 4, *extra)
        return kernel, run, lv
    return case


def _tadapt_w(b):
    return PCB.tadapt_weights(b.attn, b.ln_1, b.T_Adapter)


F64_CASES = {
    "K1_win_block": _f64_k1, "K4_swin_block": _f64_k4, "K5_win_fuse": _f64_fuse(FA.win_fuse),
    "K6_bidir_fuse": _f64_fuse(FA.bidir_fuse), "K7_ffn": _f64_k7, "K8_wmsa_qkv": _f64_k8,
    "K10_unscaled_attention": _f64_k10,
    "K12_clip_fusion_block": _f64_clip(PCB.clip_fusion_block, PCB.block_weights,
                                       [(2, 13, 32), (2, 9, 32)]),
    "K13_clip_tadapt": _f64_clip(PCB.clip_tadapt, _tadapt_w, [(6, 5, 32)]),
    "K14_clip_tv2": _f64_clip(PCB.clip_tv2, _tadapt_w, [(8, 7, 32)], 4)}


@pytest.mark.parametrize("case", sorted(F64_CASES))
def test_recompute_differentiates_the_plain_versions_function_in_float64(monkeypatch, case):
    """The card's witness (chip_smoke.py `grad_row`) on the CPU: a wrapper's
    recompute and its plain version, both on float64 inputs (no bf16
    rounding; their fp32 steps stay fp32), give every leaf the same
    gradient within 1e-4 of its max, under a random upstream gradient and
    under the output's own (1/2 |out|^2)."""
    clear_opt_ins(monkeypatch)
    kernel, run, lv = F64_CASES[case](np.random.RandomState(40))
    lv = {n: x.detach().double().requires_grad_(True) for n, x in lv.items()}
    names = list(lv)
    rec, pln = run(kernel.recompute, lv), run(kernel.plain, lv)
    rec, pln = (o if isinstance(o, tuple) else (o,) for o in (rec, pln))
    g = torch.Generator().manual_seed(41)
    for ups in ([torch.randn(o.shape, generator=g, dtype=torch.float64) for o in pln],
                [o.detach() for o in pln]):
        got = torch.autograd.grad(rec, [lv[n] for n in names], ups, retain_graph=True,
                                  allow_unused=True)
        want = torch.autograd.grad(pln, [lv[n] for n in names], ups, retain_graph=True,
                                   allow_unused=True)
        for n, a, w in zip(names, got, want):
            assert (a is None) == (w is None), n
            if w is None:
                continue
            err, scale = (a - w).abs().max().item(), w.abs().max().item()
            assert scale > 0 and err <= 1e-4 * scale, (case, n, err / scale)


# ---------------------------------------------------------------------------
# a served request, then a train step, in one process
# ---------------------------------------------------------------------------

TINY = dict(ftmode="fusion", embed_dim=32, depths=(2, 2, 2), num_heads=(2, 4, 32),
            img_size=112, num_frames=2, adapter_ratios=(0.25, 0.25, 0.25), label_dim=7)


def _inputs(cfg, rng, B):
    n, T = cfg.img_size, cfg.num_frames
    return _r(rng, B, T, n, n), _r(rng, B, T, n, n, 3)


def test_a_served_request_then_a_train_step_in_one_process():
    """`predict` runs under torch.inference_mode; the process-wide caches it
    fills first (window indices and masks in nn/swin.py, K4's geometry and
    window tables in ops/swin_block.py) must hold ordinary tensors, which a
    later train step saves for its backward."""
    for cached in (swin._rel_index, swin._t_index, swin._shift_mask, SB._geo_tensors):
        cached.cache_clear()
    cfg = swin_tiny_test(**TINY)
    model = ave.random_swin_ave(cfg, 3)
    a, v = _inputs(cfg, np.random.RandomState(31), 1)
    srv = MultiTaskServer(device="cpu")
    srv.add_ave("swin", cfg, model)
    assert np.isfinite(srv.predict("swin", {"a": a, "v": v})).all()
    steps.init_train_state(model)
    opt = optim.build_optimizer(model, 1e-4, 10.0)
    labels = torch.eye(cfg.label_dim)[torch.arange(2) % cfg.label_dim].view(1, 2, -1)

    def loss_fn(m, batch, generator):
        logits = ave.apply_swin_ave(m, cfg, t(a).bfloat16(), t(v).bfloat16())
        return losses.ave_loss(logits, labels), {}
    loss, _ = steps.make_train_step(loss_fn, opt, torch.bfloat16)(model, None)
    assert torch.isfinite(loss)
    tables = [p for n, p in model.named_parameters() if "temporal_position_bias_table" in n]
    assert tables and all(p.grad is not None and p.grad.abs().max() > 0 for p in tables)
    cpu = torch.device("cpu")
    kept = [swin._rel_index(cfg.window_size, cpu), swin._t_index(cfg.num_frames, cpu),
            *SB._geo_tensors(7, 7, 7, 0, cpu)]
    assert all(not x.is_inference() for x in kept)


# ---------------------------------------------------------------------------
# three fp32 train steps of a tiny Swin fusion AVE against JAX's
# ---------------------------------------------------------------------------

def _jax_swin_tree(cfg, seed):
    """A JAX Swin AVE tree with every leaf live: bias tables and gates N(0,
    0.5), LayerNorm scales 1 + N(0, 0.1), the rest N(0, 0.05) (adapter D_fc2
    too, not zero as the training init has it)."""
    shapes = jax.eval_shape(lambda: jax_ave.init_swin_ave(jax.random.PRNGKey(0), cfg))
    rng = np.random.RandomState(seed)

    def draw(path, x):
        s = jax.tree_util.keystr(path)
        if "bias_table" in s or "gate_" in s:
            return jnp.asarray(_r(rng, *x.shape, s=0.5))
        if "'scale'" in s:
            return jnp.asarray(1.0 + _r(rng, *x.shape, s=0.1))
        return jnp.asarray(_r(rng, *x.shape, s=0.05))
    return jax.tree_util.tree_map_with_path(draw, shapes)


@pytest.fixture(scope="module")
def three_steps():
    jcfg, cfg = jax_swin_tiny_test(**TINY), swin_tiny_test(**TINY)
    tree = _jax_swin_tree(jcfg, 1)
    rng = np.random.RandomState(2)
    batches = []
    for _ in range(3):
        a, v = _inputs(cfg, rng, 2)
        labels = np.eye(cfg.label_dim, dtype=np.float32)[rng.randint(0, cfg.label_dim, 4)]
        batches.append({"a": a, "v": v, "labels": labels.reshape(2, 2, -1)})
    lr = optim.cosine_schedule(1e-4, 1e-7, 1, 3)
    head_lr = optim.cosine_schedule(1e-3, 1e-7, 1, 3)

    def jax_loss(p, batch, rng_):
        logits = jax_ave.apply_swin_ave(p, jcfg, batch["a"], batch["v"])
        return jax_losses.ave_loss(logits, batch["labels"]), {}

    tx = jax_optim.build_optimizer(None, 1e-4, 10.0, lr_table=lr, head_lr_table=head_lr)
    tp, fp, opt_state, _ = jax_steps.init_train_state(tree, tx)
    step = jax_steps.make_train_step(jax_loss, tx, donate=False, compute_dtype=jnp.float32)
    jb = [{k: jnp.asarray(x) for k, x in b.items()} for b in batches]
    jgrad = jax.jit(jax.grad(lambda tp_: jax_loss(jax_optim.merge_params(tp_, fp), jb[0],
                                                  None)[0]))(tp)
    jlosses = []
    for b in jb:
        tp, opt_state, loss, _ = step(tp, fp, opt_state, b, jax.random.PRNGKey(0))
        jlosses.append(float(loss))
    jfinal = params_from_jax(to_numpy_tree(jax_optim.merge_params(tp, fp)))

    model = swin_ave_from_jax(cfg, to_numpy_tree(tree), device="cpu")
    before = {k: x.clone() for k, x in model.state_dict().items()}
    steps.init_train_state(model)
    opt = optim.build_optimizer(model, 1e-4, 10.0, lr_table=lr, head_lr_table=head_lr)

    def port_loss(m, batch, generator):
        logits = ave.apply_swin_ave(m, cfg, t(batch["a"]), t(batch["v"]))
        return losses.ave_loss(logits, t(batch["labels"])), {}

    FA.reset_launches()
    train_step = steps.make_train_step(port_loss, opt, torch.float32)
    plosses, pgrad = [], None
    for b in batches:
        loss, _ = train_step(model, b)
        plosses.append(float(loss))
        if pgrad is None:
            pgrad = {n: p.grad.clone() for n, p in model.named_parameters() if p.requires_grad}
    jgrad = {k: x.numpy() for k, x in params_from_jax(to_numpy_tree(
        jax.tree_util.tree_map(lambda g: np.zeros(()) if g is None else g, jgrad,
                               is_leaf=lambda x: x is None))).items() if k in pgrad}
    return dict(model=model, before=before, jfinal=jfinal, jlosses=jlosses, plosses=plosses,
                jgrad=jgrad, pgrad=pgrad)


def test_three_swin_train_steps_losses_match_jax(three_steps):
    for p, j in zip(three_steps["plosses"], three_steps["jlosses"]):
        assert abs(p - j) <= 1e-5 * abs(j)
    assert three_steps["plosses"][0] != three_steps["plosses"][2]


def test_first_swin_step_gradients_match_jax(three_steps):
    pgrad, jgrad = three_steps["pgrad"], three_steps["jgrad"]
    assert set(pgrad) == set(jgrad) and len(pgrad) > 20
    gates = max(float(np.abs(g).max()) for n, g in jgrad.items() if "gate_" in n)
    for n, g in pgrad.items():
        scale = float(np.abs(jgrad[n]).max())
        assert scale > 0, n
        if "gate_" in n:          # one sum over its block, which may nearly cancel
            scale = max(scale, gates)
        assert float(np.abs(g.numpy() - jgrad[n]).max()) <= 1e-4 * scale, n
    tables = [n for n in pgrad if "temporal_position_bias_table" in n]
    assert len(tables) == 2 * len(TINY["depths"])     # both tables of each stage's temporal block
    assert any(n.endswith("gate_v") for n in pgrad) and any(".D_fc1." in n for n in pgrad)


def test_three_swin_train_steps_trainables_and_frozen_match_jax(three_steps):
    model, before, jfinal = three_steps["model"], three_steps["before"], three_steps["jfinal"]
    moved = {n for n, p in model.named_parameters() if p.requires_grad}
    biggest = max(float((jfinal[n].float() - before[n]).abs().max()) for n in moved)
    assert biggest > 0
    for n, x in model.state_dict().items():
        if n in moved:
            upd, ref = x - before[n], jfinal[n].float() - before[n]
            assert float((upd - ref).abs().max()) <= 2e-3 * biggest, n
        else:
            assert torch.equal(x, before[n]) and torch.equal(jfinal[n].to(x.dtype), x), n
