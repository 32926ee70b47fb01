"""Plain float32 layers shared by the references: linear, LayerNorm,
multi-head attention, the adapter and the STG-CMA gated bidirectional
exchange. `W` is the weight dict, `p` a dotted prefix into it.

Under `fp8_products()` (the control: the reference in the next precision
below the configurations' bf16) every product takes float8 e4m3 operands,
each operand scaled along its contracted axis (activations per row, weights
per output channel) so that its largest magnitude is e4m3's largest, 448,
as an fp8 GEMM takes them, and summed in float32; everything else stays
float32.
"""
from __future__ import annotations

import contextlib
import contextvars
import math

import torch
import torch.nn.functional as F

_FP8 = contextvars.ContextVar("fp8_products", default=False)
E4M3_MAX = 448.0


@contextlib.contextmanager
def fp8_products(on: bool = True):
    token = _FP8.set(on)
    try:
        yield
    finally:
        _FP8.reset(token)


def fake_fp8(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """x rounded to float8 e4m3 after scaling each slice along `dim` to
    e4m3's range, scaled back; the gradient passes the rounding unchanged
    (straight through)."""
    xd = x.detach()
    s = xd.abs().amax(dim=dim, keepdim=True).clamp_min(1e-30) / E4M3_MAX
    return x + ((xd / s).to(torch.float8_e4m3fn).float() * s - xd)


def matmul(a, b):
    """a @ b; under `fp8_products`, of a in fp8 per row and b per column."""
    if _FP8.get():
        a, b = fake_fp8(a, -1), fake_fp8(b, -2)
    return torch.matmul(a, b)


def linear(W, p: str, x):
    w = W[p + ".weight"]
    b = W.get(p + ".bias")
    if _FP8.get():
        x, w = fake_fp8(x), fake_fp8(w)
    return F.linear(x, w, b)


def layernorm(W, p: str, x, eps: float = 1e-5):
    return F.layer_norm(x, x.shape[-1:], W[p + ".weight"], W[p + ".bias"], eps)


def attention(q, k, v, heads: int, bias=None):
    """Softmax attention of (R, N, C) q against (R, M, C) k, v in `heads`
    heads, scaled by dh^-1/2; `bias` broadcasts against (R, heads, N, M)."""
    R, N, C = q.shape
    M = k.shape[1]
    dh = C // heads
    qh = q.reshape(R, N, heads, dh).transpose(1, 2)
    kh = k.reshape(R, M, heads, dh).transpose(1, 2)
    vh = v.reshape(R, M, heads, dh).transpose(1, 2)
    logits = matmul(qh, kh.transpose(-1, -2)) * (1.0 / math.sqrt(dh))
    if bias is not None:
        logits = logits + bias
    p = torch.softmax(logits, dim=-1)
    return matmul(p, vh).transpose(1, 2).reshape(R, N, C)


def self_attention(W, qkv: str, proj: str, x, heads: int, bias=None):
    """The packed qkv product, `attention`, the output product."""
    C = x.shape[-1]
    t = linear(W, qkv, x)
    o = attention(t[..., :C], t[..., C:2 * C], t[..., 2 * C:], heads, bias)
    return linear(W, proj, o)


def adapter_hidden(W, p: str, x):
    return F.gelu(linear(W, p + ".D_fc1", x))


def adapter_out(W, p: str, h):
    return linear(W, p + ".D_fc2", h)


def adapter(W, p: str, x):
    """The bottleneck adapter without its skip: fc2(gelu(fc1(x)))."""
    return adapter_out(W, p, adapter_hidden(W, p, x))


def fuse(vh, ah, gate_v, gate_a):
    """STG-CMA's gated bidirectional exchange of (R, Nv, D) and (R, Na, D)
    hiddens: unscaled logits vh . ah^T, softmax over the other stream's
    tokens in each direction, each stream plus its gate times what it
    gathered."""
    logits = matmul(vh, ah.transpose(1, 2))
    a2v = matmul(torch.softmax(logits, dim=-1), ah)
    v2a = matmul(torch.softmax(logits.transpose(1, 2), dim=-1), vh)
    return vh + gate_v * a2v, ah + gate_a * v2a


def soft_cross_entropy(logits, targets):
    """Mean over rows of -sum(targets * log_softmax(logits))."""
    return -(targets * torch.log_softmax(logits, dim=-1)).sum(-1).mean()
