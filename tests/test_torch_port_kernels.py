"""The plain versions of the port's kernels K1-K3 (stgcma_tpu_torch/ops/
fused_attn.py) against the JAX package's Pallas kernels in interpret mode.

The JAX side runs as tests/test_resident_pad.py runs it: through
`clip_temporal_megakernel` (the temporal site, T = 10, packed 8 rows into one
block-diagonal gram; the spatial site with N = 26 carried under the resident
pad to 32 with `n_real`) and `ffn_q_megakernel`. The port takes the same
tokens without packing or padding.

Tolerances (max abs error over max |ref|):
- float path, fp32: 1e-5 — the math is the same, only the summation order
  of the products differs (~1e-7 relative per sum).
- int8 path with the JAX reciprocal made correctly rounded, as the port's:
  the activation codes agree except where LN's last-ulp differences land on
  a rounding boundary (measured ~1e-7 here, no flip); 1e-3 admits a
  one-step flip of a few codes, each moving an output by ~1/127 of one
  product term.
- int8 path as interpret mode runs it (bf16-emulated reciprocal, 2^-9
  relative): codes move by one step in many places, which is quantization
  noise of ~1e-2 of the output (measured 1.0-1.4e-2); the bar is 3e-2.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from stgcma_tpu.ops import pallas_attn as PA
from stgcma_tpu.ops.quant import quantize_linear_params
from stgcma_tpu_torch.checkpoint.convert import params_from_jax
from stgcma_tpu_torch.ops import fused_attn as FA

from torch_port_helpers import (clear_opt_ins, exact_reciprocal, jax_lin, jax_ln,
                                rel, t, to_numpy_tree)

C, HEADS = 128, 4


def _attn_params(rng, quantized):
    attn = {"in_proj": jax_lin(rng, C, 3 * C), "out_proj": jax_lin(rng, C, C)}
    if quantized:
        attn = {k: quantize_linear_params(v) for k, v in attn.items()}
    return attn


def _port_attn_args(attn, ln):
    sd = params_from_jax({"attn": to_numpy_tree(attn), "ln": to_numpy_tree(ln)})
    if "attn.in_proj.weight_q" in sd:
        return (sd["ln.weight"], sd["ln.bias"], sd["attn.in_proj.weight_q"],
                sd["attn.in_proj.weight_s"], sd["attn.in_proj.bias"],
                sd["attn.out_proj.weight_q"], sd["attn.out_proj.weight_s"],
                sd["attn.out_proj.bias"])
    return (sd["ln.weight"], sd["ln.bias"], sd["attn.in_proj.weight"],
            sd["attn.in_proj.bias"], sd["attn.out_proj.weight"],
            sd["attn.out_proj.bias"])


SITES = {"temporal_T10": (12, 10), "spatial_N26_resident_pad": (6, 26)}


@pytest.mark.parametrize("site", sorted(SITES))
def test_win_block_plain_matches_jax_kernel(monkeypatch, site):
    clear_opt_ins(monkeypatch)
    rng = np.random.RandomState(5)
    B_, N = SITES[site]
    ln, attn = jax_ln(rng, C), _attn_params(rng, False)
    x = rng.randn(B_, N, C).astype(np.float32) * 0.5
    if N > 16:          # JAX resident pad: pre-padded tokens, pad keys masked
        NP = -(-N // 16) * 16
        xp = jnp.pad(jnp.asarray(x), ((0, 0), (0, NP - N), (0, 0)))
        ref = PA.clip_temporal_megakernel(attn, ln, xp, HEADS, n_real=N)[:, :N]
    else:               # packed: 8 rows of T = 10 in one 80-token gram
        ref = PA.clip_temporal_megakernel(attn, ln, jnp.asarray(x), HEADS)
    out = FA.win_block(t(x), *_port_attn_args(attn, ln), HEADS)
    assert FA.win_block.launches == 0
    assert out.shape == (B_, N, C)
    assert rel(out, ref) < 1e-5


def test_win_block_plain_bias_period_matches_jax_kernel(monkeypatch):
    """The additive bias bm (nWb, heads, N, N), row b taking bm[b % nWb]."""
    clear_opt_ins(monkeypatch)
    rng = np.random.RandomState(9)
    B_, N, nWb = 6, 16, 3
    ln, attn = jax_ln(rng, C), _attn_params(rng, False)
    x = rng.randn(B_, N, C).astype(np.float32)
    bm = (rng.randn(nWb, HEADS, N, N) * 2).astype(np.float32)
    ref = PA._win_block_pallas(jnp.asarray(x), ln["scale"], ln["bias"],
                               attn["in_proj"]["kernel"], attn["in_proj"]["bias"],
                               attn["out_proj"]["kernel"], attn["out_proj"]["bias"],
                               jnp.asarray(bm), HEADS)
    out = FA.win_block(t(x), *_port_attn_args(attn, ln), HEADS, bias=t(bm))
    assert rel(out, ref) < 1e-5


@pytest.mark.parametrize("exact_recip", [True, False])
@pytest.mark.parametrize("site", sorted(SITES))
def test_win_block_q_plain_matches_jax_kernel(monkeypatch, site, exact_recip):
    clear_opt_ins(monkeypatch)
    if exact_recip:
        exact_reciprocal(monkeypatch)
    rng = np.random.RandomState(6)
    B_, N = SITES[site]
    ln, attn = jax_ln(rng, C), _attn_params(rng, True)
    x = rng.randn(B_, N, C).astype(np.float32) * 0.5
    if N > 16:
        NP = -(-N // 16) * 16
        xp = jnp.pad(jnp.asarray(x), ((0, 0), (0, NP - N), (0, 0)))
        ref = PA.clip_temporal_megakernel(attn, ln, xp, HEADS, n_real=N)[:, :N]
    else:
        ref = PA.clip_temporal_megakernel(attn, ln, jnp.asarray(x), HEADS)
    out = FA.win_block_q(t(x), *_port_attn_args(attn, ln), HEADS)
    assert FA.win_block_q.launches == 0
    assert rel(out, ref) < (1e-3 if exact_recip else 3e-2)


@pytest.mark.parametrize("exact_recip", [True, False])
@pytest.mark.parametrize("act", ["quick_gelu", "gelu"])
def test_ffn_q_plain_matches_jax_kernel(monkeypatch, act, exact_recip):
    clear_opt_ins(monkeypatch)
    if exact_recip:
        exact_reciprocal(monkeypatch)
    rng = np.random.RandomState(7)
    M, H = 40, 4 * C
    ln = jax_ln(rng, C)
    mlp = {"c_fc": quantize_linear_params(jax_lin(rng, C, H)),
           "c_proj": quantize_linear_params(jax_lin(rng, H, C))}
    x = rng.randn(2, M // 2, C).astype(np.float32)
    ref = PA.ffn_q_megakernel(mlp, ln, jnp.asarray(x), act=act,
                              keys=("c_fc", "c_proj"))
    sd = params_from_jax({"mlp": to_numpy_tree(mlp), "ln": to_numpy_tree(ln)})
    out = FA.ffn_q(t(x).reshape(M, C), sd["ln.weight"], sd["ln.bias"],
                   sd["mlp.c_fc.weight_q"], sd["mlp.c_fc.weight_s"], sd["mlp.c_fc.bias"],
                   sd["mlp.c_proj.weight_q"], sd["mlp.c_proj.weight_s"],
                   sd["mlp.c_proj.bias"], act)
    assert FA.ffn_q.launches == 0
    assert rel(out.reshape(x.shape), ref) < (1e-3 if exact_recip else 3e-2)


def test_quant_rows_matches_jax_with_exact_reciprocal(monkeypatch):
    """The row quantization itself: codes bit-identical to `_quant_rows`
    once the reciprocal is the same, scales bit-identical."""
    exact_reciprocal(monkeypatch)
    rng = np.random.RandomState(8)
    x = (rng.randn(64, 96) * rng.rand(64, 1) * 10).astype(np.float32)
    x[3] = 0.0                                  # the 1e-30 floor
    q_ref, s_ref = PA._quant_rows(jnp.asarray(x))
    q, s = FA.quant_rows(t(x))
    np.testing.assert_array_equal(q.numpy().astype(np.int8), np.asarray(q_ref))
    np.testing.assert_array_equal(s.numpy(), np.asarray(s_ref))


def test_dotq_is_exact_beyond_float32_range():
    """The plain int8 product must not round: 127 * 127 * 3072 > 2^24."""
    K = 3072
    xf = torch.full((2, K), 127.0)
    xf[1, 0] = 126.0
    wq = torch.full((1, K), 127, dtype=torch.int8)
    out = FA.dotq(xf, wq, torch.ones(1))
    _, sx = FA.quant_rows(xf)
    acc_exact = np.array([127 * 127 * K, 127 * 127 * K - 127], np.int64)
    # the exact int32 sum is rounded to fp32 once, then scaled, as in the kernels
    want = acc_exact.astype(np.float32) * sx.numpy()[:, 0]
    np.testing.assert_array_equal(out[:, 0].numpy(), want)
