"""Attention ops: Swin window and temporal attention (shared weights) and the
STG-CMA bidirectional gated cross-modal fusion.

Port of `stgcma_tpu/ops/attention.py`: `qkv_attention` (:33-60),
`gather_bias` (:63), `window_attention` (:70), `temporal_attention` (:77),
`cross_modal_fuse` (:87-118, without the resident-pad key masks: the port
never pads a token stream) and `mha` (:121-167, the float path, without
train-time dropout). Plain torch, as the JAX package leaves these to XLA;
the kernel routes of the Swin tower are in ops/fused_attn.py.
"""
from __future__ import annotations

import torch
from torch import nn

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


def mha(p: MultiheadAttention, q, k, v, num_heads: int):
    """torch nn.MultiheadAttention in eval mode on batch-first (B, N, C)
    q / k / v, with the JAX `mha`'s rounding points (:150-167): each
    projection rounded to the input's dtype, then its bias added; q scaled by
    dh^-1/2 rounded to that dtype before the product; fp32 logits and
    softmax, cast back before p.v. The JAX function's mask, int8 `kernel_q`
    branch and train-time dropout are not ported (no AVQA path passes a mask
    or reaches the other two)."""
    B, Nq, C = q.shape
    dh = C // num_heads
    dt = q.dtype
    w, b = p.in_proj.weight.to(dt), p.in_proj.bias.to(dt)

    def heads(x, i):
        y = torch.matmul(x, w[i * C:(i + 1) * C].t()) + b[i * C:(i + 1) * C]
        return y.reshape(B, -1, num_heads, dh).transpose(1, 2)
    qh, kh, vh = heads(q, 0), heads(k, 1), heads(v, 2)
    qh = qh * torch.tensor(dh ** -0.5, dtype=dt)
    attn = torch.matmul(qh.float(), kh.float().transpose(-1, -2))
    attn = torch.softmax(attn, dim=-1).to(dt)
    out = torch.matmul(attn, vh).transpose(1, 2).reshape(B, Nq, C)
    return linear(p.out_proj, out)
