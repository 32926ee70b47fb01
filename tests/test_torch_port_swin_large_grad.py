"""K4's backward recompute at Swin-Large stage 3 against the JAX package on
the CPU: the bf16 rounding of the port's gradient against JAX's own.

At Swin-Large's last stage (C = 1536, 48 heads, adapters of D = 96, one 7x7
window a frame) with live adapters, the fusion's unscaled logits are sums of
96 products and its softmax is sharp, so bf16 rounding alone moves a
gradient of the block several percent of its leaf's max from fp32, in JAX's
`_fullgrid_naive` as in the port's `swin_block_recompute` (on the H100 the
port's recompute sat 6.83% from plain autograd). No bar of the port's own
can say whether that distance is the rounding's or a loss of precision in
the port, so this test takes JAX's: on the same bf16 inputs and upstream
gradient, the port's bf16 recompute and JAX's bf16 `jax.vjp` of
`_fullgrid_naive`, each against JAX's gradient in fp32 of the same values.
`chip_smoke.py` holds K4's gradient row at this site at TOL_GRAD on top of
its K4_ST3_JAX_BF16, JAX's largest distance here, which this test checks
JAX's reading does not fall below.

The block as `chip_smoke.py`'s K4 rows draw it (`random_swin_ave`'s recipe:
linears N(0, 0.02), LayerNorm scales 1 + N(0, 0.1), the relative table
N(0, 0.5); `live_k4_weights`' adapters, D_fc1 N(0, (2.26 / sqrt(C) x
(32 / D)^(1/4))^2), D_fc2 N(0, 0.566^2 / D), their biases N(0, 0.1), gates
0.8 and -0.6), v and a N(0, 0.1) over 20 frames (the card's row: B = 2 at
T = 10), the upstream gradients N(0, 1). Bars, over the 31 tensor leaves, as
max |g - g_fp32| / max |g_fp32| of each (seed 0 measured; seeds 0-3 in
brackets, on this recipe):
- the mean over the leaves no larger than JAX's (0.0263 against 0.0368;
  0.72-0.85 of JAX's);
- each leaf within max(3e-2, 1.5x JAX's distance for that leaf) (the
  largest ratio 1.10; 1.10-1.37);
- the gates, one sum over every row that XLA's CPU reduction takes in
  bf16, within max(3e-2, JAX's own distance) (the port's <= 0.111 where
  JAX's reach 1.37);
- the output, against JAX's fp32 output, within max(1e-2, 1.5x JAX's bf16
  output's distance) (v 1.73e-2 against JAX's 1.79e-2, a 1.34e-2 against
  1.70e-2; 1.49e-2 and 1.62e-2 from JAX's bf16 output, where the tiny block
  of tests/test_torch_port_train_swin.py stays within 1e-2);
- JAX's largest leaf distance at least K4_ST3_JAX_BF16 (7.11e-2; 4.41-7.22%).
"""
import os
import re

import numpy as np
import jax
import jax.numpy as jnp
import torch

from stgcma_tpu.nn.swin import BlockStatic as JaxBlockStatic
from stgcma_tpu.nn.swin import block_init
from stgcma_tpu.ops import pallas_swin_block as PSB
from stgcma_tpu_torch.checkpoint.convert import params_from_jax
from stgcma_tpu_torch.nn import swin
from stgcma_tpu_torch.ops import swin_block as SB
from stgcma_tpu_torch.ops.attention import gather_bias

from test_torch_port_train_swin import _bf16_module, _jax_vjp, _module_grads, _np32, _rel, _tb
from torch_port_helpers import clear_opt_ins, t, to_numpy_tree

C, D, HEADS, GRID, FRAMES = 1536, 96, 48, 7, 20
SMOKE = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "chip_smoke.py")


def _draw(rng):
    """The leaf-wise recipe of the module docstring, keyed by JAX's path."""
    def draw(path, a):
        k = jax.tree_util.keystr(path)
        if "norm" in k and "scale" in k:
            return (1 + 0.1 * rng.randn(*a.shape)).astype(np.float32)
        if "relative_position_bias_table" in k:
            return (0.5 * rng.randn(*a.shape)).astype(np.float32)
        if "Adapter" in k:
            sd = 0.1
            if "kernel" in k:
                sd = (2.26 / C ** 0.5 * min(1.0, (32 / D) ** 0.25) if "D_fc1" in k
                      else 0.566 / D ** 0.5)
            return (sd * rng.randn(*a.shape)).astype(np.float32)
        if "gate_v" in k or "gate_a" in k:
            return np.full(a.shape, 0.8 if "gate_v" in k else -0.6, np.float32)
        return (0.02 * rng.randn(*a.shape)).astype(np.float32)
    return draw


def test_k4_recompute_at_swin_large_stage3_rounds_no_worse_than_jax(monkeypatch):
    clear_opt_ins(monkeypatch)
    kw = dict(dim=C, H=GRID, W=GRID, num_heads=HEADS, window_size=GRID, shift_size=0,
              t_attn=False, num_frames=FRAMES, adapter_ratio=D / C, mode="fusion_adapt")
    rng = np.random.RandomState(0)
    p = jax.tree_util.tree_map_with_path(_draw(rng),
                                         block_init(jax.random.PRNGKey(0), JaxBlockStatic(**kw)))
    N = GRID * GRID
    v, a = ((0.1 * rng.randn(FRAMES, N, C)).astype(np.float32) for _ in range(2))
    gv, ga = (rng.randn(FRAMES, N, C).astype(np.float32) for _ in range(2))
    geo = PSB._geo(GRID, GRID, GRID, 0)

    def fn(p_, v_, a_):
        return PSB._fullgrid_naive(p_, v_, a_, HEADS, geo)
    want, (jp, jv, ja), (fp, fv, fa) = _jax_vjp(fn, (p, v, a), (gv, ga))
    want32 = jax.jit(fn)(*jax.tree_util.tree_map(
        lambda z: jnp.asarray(z).astype(jnp.bfloat16).astype(jnp.float32), (p, v, a)))

    pst = swin.BlockStatic(**kw)
    assert SB.swin_whole_block_enabled(pst)
    blk = swin.SwinBlock(pst)
    blk.load_state_dict(params_from_jax(to_numpy_tree(p)), strict=True)
    blk = _bf16_module(blk)
    index, attn_mask, fuse_mask = SB._geo_tensors(GRID, GRID, GRID, 0, torch.device("cpu"))
    bias = (gather_bias(blk.attn.relative_position_bias_table, index, HEADS, N) + attn_mask)[None]
    xs = {"v": _tb(v), "a": _tb(a)}
    out = SB.swin_block_recompute(xs["v"], xs["a"], SB.block_weights(blk), HEADS, bias,
                                  fuse_mask)
    for o, w, w32 in zip(out, want, want32):
        assert _rel(o, w32) <= max(1e-2, 1.5 * _rel(w, w32)), (_rel(o, w32), _rel(w, w32))
    torch.autograd.backward(out, (t(gv).bfloat16(), t(ga).bfloat16()))
    port, ref, ref32 = _module_grads(blk, jp, fp)
    port.update({k: _np32(x.grad) for k, x in xs.items()})
    ref.update({"v": _np32(jv), "a": _np32(ja)})
    ref32.update({"v": _np32(fv), "a": _np32(fa)})

    dist = {n: (_rel(port[n], ref32[n]), _rel(ref[n], ref32[n])) for n in port}
    gates = {"gate_v", "gate_a"}
    tensors = {n: d for n, d in dist.items() if n not in gates}
    assert len(tensors) == 31
    for n, (mine, jax_bf16) in dist.items():
        bar = max(3e-2, jax_bf16 if n in gates else 1.5 * jax_bf16)
        assert mine <= bar, (n, mine, jax_bf16)
    assert np.mean([m for m, _ in tensors.values()]) <= np.mean([j for _, j in tensors.values()])
    # the site is sharp: JAX's own bf16 rounding moves a leaf past 3e-2 here, and
    # at least as far as the reading chip_smoke.py's K4 row adds to TOL_GRAD
    with open(SMOKE) as f:
        reading = float(re.search(r"^K4_ST3_JAX_BF16 = ([0-9.e-]+)", f.read(), re.M).group(1))
    assert max(j for _, j in tensors.values()) >= reading > 3e-2
