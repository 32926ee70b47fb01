"""STG-CMA bidirectional gated cross-modal fusion.

Port of `stgcma_tpu/ops/attention.py::cross_modal_fuse` (:87-118) without the
resident-pad key masks: the port never pads a token stream. Plain torch, as
the JAX package leaves it to XLA.
"""
from __future__ import annotations

import torch


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
