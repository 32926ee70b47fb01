"""Attention ops: Swin window and temporal attention (shared weights) and the
STG-CMA bidirectional gated cross-modal fusion.

Port of `stgcma_tpu/ops/attention.py`: `qkv_attention` (:33-60),
`gather_bias` (:63), `window_attention` (:70), `temporal_attention` (:77),
`cross_modal_fuse` (:87-118, without the resident-pad key masks: the port
never pads a token stream) and `mha` (:121-167, with its int8 branch, its
additive mask and its train-time dropout). Plain torch, as the JAX package
leaves these to XLA; the kernel routes of the Swin tower are in
ops/fused_attn.py.
"""
from __future__ import annotations

import torch
from torch import nn

from ..runtime.mesh import draw_rows
from .common import Linear, linear


def qkv_attention(p, x, num_heads: int, bias=None, mask=None):
    """qkv linear -> scaled dot-product (+ bias (h, N, N), + window mask
    (nW, N, N), B_ a multiple of nW) -> proj. p holds `qkv` and `proj`."""
    B_, N, C = x.shape
    dh = C // num_heads
    qkv = linear(p.qkv, x).reshape(B_, N, 3, num_heads, dh).permute(2, 0, 3, 1, 4)
    q, k, v = qkv[0], qkv[1], qkv[2]
    q = q * torch.tensor(dh ** -0.5, dtype=x.dtype)          # scale rounded to x.dtype
    attn = torch.matmul(q.float(), k.float().transpose(-1, -2))
    if bias is not None:
        attn = attn + bias[None].float()
    if mask is not None:
        nW = mask.shape[0]
        attn = (attn.view(B_ // nW, nW, num_heads, N, N) + mask[None, :, None].float()
                ).view(B_, num_heads, N, N)
    attn = torch.softmax(attn, dim=-1).to(x.dtype)
    out = torch.matmul(attn, v).transpose(1, 2).reshape(B_, N, C)
    return linear(p.proj, out)


def gather_bias(table, index, num_heads: int, N: int):
    """Bias table lookup: table (M, h), index (N*N,) or (N, N) integer
    tensor -> (h, N, N) float32."""
    b = table.float()[index.reshape(-1).long()]
    return b.reshape(N, N, num_heads).permute(2, 0, 1)


def temporal_table(p, signal: str):
    """The per-modality temporal bias table of an attention module."""
    return (p.temporal_position_bias_table if signal == "video"
            else p.temporal_position_bias_table_audio)


def window_attention(p, x, num_heads: int, rel_index, mask=None):
    """Spatial W-MSA / SW-MSA with relative position bias (Swin_AVE.py:256-269)."""
    N = x.shape[1]
    bias = gather_bias(p.relative_position_bias_table, rel_index, num_heads, N)
    return qkv_attention(p, x, num_heads, bias=bias, mask=mask)


def temporal_attention(p, x, num_heads: int, t_index, signal: str = "video"):
    """Temporal attention over frame tokens with the per-modality bias table
    (Swin_AVE.py:244-255), with the spatial attention's qkv/proj weights."""
    T = x.shape[1]
    bias = gather_bias(temporal_table(p, signal), t_index, num_heads, T)
    return qkv_attention(p, x, num_heads, bias=bias)


def cross_modal_fuse(v_hidden, a_hidden, gate_v, gate_a, mask=None):
    """v_hidden: (B, Nv, d); a_hidden: (B, Na, d). Returns the updated
    (v_hidden, a_hidden). The logits are unscaled (no 1/sqrt(d)) and kept in
    float32; the probabilities are cast back to the hidden dtype before p.v.
    `mask` (Nv, Na), added to the logits of both directions, is the
    per-window fusion of `_fullgrid_naive`'s `fuse` (pallas_swin_block.py:210)."""
    dt = v_hidden.dtype
    logits_va = torch.matmul(v_hidden.float(), a_hidden.float().transpose(1, 2))
    if mask is not None:
        logits_va = logits_va + mask.float()
    attn_vs = torch.softmax(logits_va, dim=-1).to(dt)               # (B, Nv, Na)
    a2v = torch.matmul(attn_vs, a_hidden)
    attn_as = torch.softmax(logits_va.transpose(1, 2), dim=-1).to(dt)  # (B, Na, Nv)
    v2a = torch.matmul(attn_as, v_hidden)
    v_out = v_hidden + gate_v.to(dt) * a2v
    a_out = a_hidden + gate_a.to(dt) * v2a
    return v_out, a_out


class MultiheadAttention(nn.Module):
    """nn.MultiheadAttention's parameters: the packed `in_proj` (3C, C),
    [q; k; v] on the out dim as torch packs them, and `out_proj`."""

    def __init__(self, dim: int):
        super().__init__()
        self.in_proj = Linear(dim, 3 * dim)
        self.out_proj = Linear(dim, dim)


def attn_dropout_keep(shape, rate: float, generator: torch.Generator, device) -> torch.Tensor:
    """The keep mask of a dropout on attention weights: Bernoulli(1 - rate)
    drawn by `torch.bernoulli` from `generator` (on the generator's own
    device, then moved to `device`), as a bool tensor of `shape`; inside a
    mesh step, drawn for the global batch and sliced to this rank's rows
    (`runtime/mesh.py::draw_rows`)."""
    def draw(s):
        return torch.bernoulli(torch.full(s, 1.0 - rate, device=generator.device),
                               generator=generator)

    return draw_rows(draw, shape).to(device=device, dtype=torch.bool)


def attn_dropout_apply(attn: torch.Tensor, keep: torch.Tensor, rate: float) -> torch.Tensor:
    """attn * keep / (1 - rate) in attn's dtype, the divisor rounded to that
    dtype first, as JAX's weakly typed scalar is (:163-165)."""
    return attn * keep.to(attn.dtype) / torch.tensor(1.0 - rate, dtype=attn.dtype)


def _in_proj_heads(p: MultiheadAttention, q, k, v, C: int):
    """The q, k, v projections, each in its input's dtype. A float in_proj
    rounds its weight and bias to the input's dtype and adds the bias after
    the product; an int8 one (`QLinear`) takes `ops/quant.py::linear_q`, on
    the packed (3C, C) weight when q, k and v are one tensor, else on each
    projection's rows (JAX :135-149)."""
    ip = p.in_proj
    if ip.quantized:
        from types import SimpleNamespace

        from .quant import linear_q
        if q is k and k is v:
            qkv = linear_q(ip, q)
            return qkv[..., :C], qkv[..., C:2 * C], qkv[..., 2 * C:]

        def rows(i):
            sl = slice(i * C, (i + 1) * C)
            return SimpleNamespace(weight_q=ip.weight_q[sl], weight_s=ip.weight_s[sl],
                                   bias=ip.bias[sl])
        return linear_q(rows(0), q), linear_q(rows(1), k), linear_q(rows(2), v)
    dt = q.dtype
    w, b = ip.weight.to(dt), ip.bias.to(dt)
    return tuple(torch.matmul(x, w[i * C:(i + 1) * C].t()) + b[i * C:(i + 1) * C]
                 for i, x in enumerate((q, k, v)))


def mha(p: MultiheadAttention, q, k, v, num_heads: int, mask=None, dropout_rate: float = 0.0,
        generator: torch.Generator = None):
    """torch nn.MultiheadAttention on batch-first (B, N, C) q / k / v, with
    the JAX `mha`'s rounding points (:121-167): each projection in the
    input's dtype (`_in_proj_heads`); q scaled by dh^-1/2 rounded to that
    dtype before the product; fp32 logits, plus the additive `mask` (any
    shape that broadcasts to (B, heads, Nq, Nk)); the softmax cast back
    before p.v. With `dropout_rate` > 0 and a `generator` (training), the
    attention weights take a dropout: a keep mask drawn from the generator
    (`attn_dropout_keep`), the kept weights scaled by 1 / (1 - rate); without
    a generator no dropout, as JAX's without a key."""
    B, Nq, C = q.shape
    dh = C // num_heads
    dt = q.dtype
    qh, kh, vh = (x.reshape(B, -1, num_heads, dh).transpose(1, 2)
                  for x in _in_proj_heads(p, q, k, v, C))
    qh = qh * torch.tensor(dh ** -0.5, dtype=dt)
    attn = torch.matmul(qh.float(), kh.float().transpose(-1, -2))
    if mask is not None:
        attn = attn + mask.float()
    attn = torch.softmax(attn, dim=-1).to(dt)
    if dropout_rate > 0.0 and generator is not None:
        keep = attn_dropout_keep(attn.shape, dropout_rate, generator, attn.device)
        attn = attn_dropout_apply(attn, keep, dropout_rate)
    out = torch.matmul(attn, vh).transpose(1, 2).reshape(B, Nq, C)
    return linear(p.out_proj, out)
