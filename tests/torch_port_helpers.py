"""Shared helpers of the port's CPU tests (tests/test_torch_port_*.py): the
same seeded numpy inputs go through the JAX package and stgcma_tpu_torch."""
import numpy as np
import jax
import jax.numpy as jnp
import torch

# The suite runs in several worker processes at once. torch's default of one
# intra-op thread per core in each of them oversubscribes the host, which
# starves the suite's tests that depend on timers and sleeps
# (tests/test_bench_extras.py); the port's tiny shapes gain nothing from more.
torch.set_num_threads(2)

# env switches of the JAX package that select opt-in kernel variants; the
# port follows the default path, so every comparison clears them
JAX_OPT_INS = ("STGCMA_QFUSE_ADAPTERS", "STGCMA_FUSED_FFN", "STGCMA_TV2",
               "STGCMA_CLIP_TADAPT_FUSED", "STGCMA_CLIP_WHOLE_BLOCK",
               "STGCMA_Q_INT8_GRAMS", "STGCMA_FAST_EXP", "STGCMA_Q_BF16_DEQUANT")


def clear_opt_ins(monkeypatch):
    for k in JAX_OPT_INS:
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setenv("STGCMA_EXACT_SOFTMAX", "1")


def rel(x, ref):
    """max |x - ref| / max |ref|."""
    if isinstance(x, torch.Tensor):
        x = x.detach().float()
    x, ref = np.asarray(x, np.float64), np.asarray(ref, np.float64)
    return float(np.max(np.abs(x - ref))) / (float(np.max(np.abs(ref))) + 1e-12)


def rows_agree(x, ref, tight=1e-5, loose=1e-2, frac=0.1):
    """The int8 comparison of two implementations of one arithmetic: every
    row (last axis) within `tight` of max |ref|, except rows where an
    activation lands on a rounding boundary on one side only, where one
    int8 code (or, in bf16, one rounded q, k or v element) moves by one
    step and that row, or the rows attending to the moved key, move by up
    to `loose`; those rows are at most `frac` of all. Returns (max error,
    rows beyond tight, rows) relative to max |ref|, and asserts."""
    if isinstance(x, torch.Tensor):
        x = x.detach().float()
    x = np.asarray(x, np.float64)
    ref = np.asarray(ref, np.float64).reshape(x.shape)
    d = np.abs(x - ref).reshape(-1, x.shape[-1]) / (float(np.max(np.abs(ref))) + 1e-12)
    moved = int((d.max(axis=-1) > tight).sum())
    assert d.max() <= loose and moved <= frac * d.shape[0], (float(d.max()), moved, d.shape[0])
    return float(d.max()), moved, d.shape[0]


def t(a, dtype=torch.float32):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a))).to(dtype)


def jax_lin(rng, i, o, s=0.05):
    return {"kernel": jnp.asarray(rng.randn(i, o) * s, jnp.float32),
            "bias": jnp.asarray(rng.randn(o) * 0.05, jnp.float32)}


def jax_ln(rng, c):
    return {"scale": jnp.asarray(rng.rand(c) + 0.5, jnp.float32),
            "bias": jnp.asarray(rng.randn(c) * 0.1, jnp.float32)}


def to_numpy_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def exact_reciprocal(monkeypatch):
    """Make the JAX kernels' `pl.reciprocal(approx=True)` correctly rounded.
    In interpret mode on the CPU it is emulated through bf16 (a 2^-9
    relative error, which moves int8 activation codes by one step); on the
    TPU it is a hardware approximation; the port's kernels use the correctly
    rounded reciprocal."""
    from jax.experimental import pallas as pl
    monkeypatch.setattr(pl, "reciprocal", lambda x, approx=False: 1.0 / x)
