"""Attention ops: Swin window and temporal attention (shared weights) and the
STG-CMA bidirectional gated cross-modal fusion.

Port of `stgcma_tpu/ops/attention.py`: `qkv_attention` (:33-60),
`gather_bias` (:63), `window_attention` (:70), `temporal_attention` (:77)
and `cross_modal_fuse` (:87-118, without the resident-pad key masks: the port
never pads a token stream). Plain torch, as the JAX package leaves these to
XLA; the kernel routes of the Swin tower are in ops/fused_attn.py.
"""
from __future__ import annotations

import torch

from .common import linear


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


def cross_modal_fuse(v_hidden, a_hidden, gate_v, gate_a):
    """v_hidden: (B, Nv, d); a_hidden: (B, Na, d). Returns the updated
    (v_hidden, a_hidden). The logits are unscaled (no 1/sqrt(d)) and kept in
    float32; the probabilities are cast back to the hidden dtype before p.v."""
    dt = v_hidden.dtype
    logits_va = torch.matmul(v_hidden.float(), a_hidden.float().transpose(1, 2))
    attn_vs = torch.softmax(logits_va, dim=-1).to(dt)               # (B, Nv, Na)
    a2v = torch.matmul(attn_vs, a_hidden)
    attn_as = torch.softmax(logits_va.transpose(1, 2), dim=-1).to(dt)  # (B, Na, Nv)
    v2a = torch.matmul(attn_as, v_hidden)
    v_out = v_hidden + gate_v.to(dt) * a2v
    a_out = a_hidden + gate_a.to(dt) * v2a
    return v_out, a_out
