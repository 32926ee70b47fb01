"""Elementary tensor functions and the parameter modules they read.

Linear weights are kept in torch's (out_features, in_features) layout: the
hand-written GEMMs read both operands contiguous along the contracted axis
(`x[m, k] * w[n, k]`), which is what `mma.sync ... .row.col` wants. The JAX
package keeps (in, out); `checkpoint/convert.py` transposes on the way in.

LayerNorm computes in float32 and casts back to the input dtype, as the JAX
package does for its bf16 policy (`stgcma_tpu/ops/common.py:72-81`).
"""
from __future__ import annotations

import copy
import functools

import torch
import torch.nn.functional as F
from torch import nn


def resolve_device(device) -> torch.device:
    """The device an entry point runs on. Entry points default to "cuda";
    without a card that raises here instead of running on the CPU. The CPU
    (the kernels' plain versions) is taken only when asked for."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' to "
                           "run the plain PyTorch versions on the CPU")
    return device


def tensor_cache(fn):
    """`functools.lru_cache` for the builders of process-wide constant
    tensors (window indices, masks, K4's geometry), which never keeps an
    inference tensor: the builder runs under `torch.inference_mode(False)`.
    The first call often comes from inside `MultiTaskServer.predict`
    (`torch.inference_mode`), and a tensor made there could not be saved for
    the backward of a later train step in the same process."""
    @functools.lru_cache(maxsize=64)
    @functools.wraps(fn)
    def cached(*args):
        with torch.inference_mode(False):
            return fn(*args)
    return cached


class Linear(nn.Module):
    """Float linear layer: weight (out, in), bias (out,) or None (the Swin
    patch-merging reduction has none)."""

    quantized = False

    def __init__(self, in_features: int, out_features: int, bias: bool = True):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(out_features, in_features))
        self.bias = nn.Parameter(torch.zeros(out_features)) if bias else None


class QLinear(nn.Module):
    """int8 frozen-tower linear (ops/quant.py): weight_q int8 (out, in),
    per-output-channel scale weight_s (out,), float bias (out,)."""

    quantized = True

    def __init__(self, in_features: int, out_features: int):
        super().__init__()
        self.register_buffer("weight_q", torch.zeros(out_features, in_features,
                                                     dtype=torch.int8))
        self.register_buffer("weight_s", torch.ones(out_features))
        self.bias = nn.Parameter(torch.zeros(out_features))


class LayerNorm(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))


def linear(p: Linear, x: torch.Tensor) -> torch.Tensor:
    """x @ W^T + b in x's dtype. A quantized layer goes to
    `ops/quant.py::int8_matmul`, as `stgcma_tpu/ops/common.py:63-65` routes
    it (its own quantizer, not the one inside the int8 kernels K2-K4)."""
    if p.quantized:
        from .quant import linear_q
        return linear_q(p, x)
    bias = None if p.bias is None else p.bias.to(x.dtype)
    return F.linear(x, p.weight.to(x.dtype), bias)


def layernorm(p: LayerNorm, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm over the last axis with float32 statistics, cast back."""
    dt = x.dtype
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = (xf - mean).square().mean(dim=-1, keepdim=True)
    y = (xf - mean) * torch.rsqrt(var + eps)
    y = y * p.weight.float() + p.bias.float()
    return y.to(dt)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """Exact erf GELU."""
    return F.gelu(x)


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    """CLIP QuickGELU: x * sigmoid(1.702 x)."""
    return x * torch.sigmoid(1.702 * x)


def mlp_apply(p, x: torch.Tensor, act=gelu) -> torch.Tensor:
    """fc2(act(fc1(x))), every op in x's dtype (`stgcma_tpu/ops/common.py:106`)."""
    return linear(p.fc2, act(linear(p.fc1, x)))


def cast_tree(module: nn.Module, dtype: torch.dtype) -> nn.Module:
    """A copy of `module` with every floating parameter and buffer cast to
    `dtype`. Like the JAX `cast_tree`, this includes the int8 layers' float
    scales `weight_s`; the int8 weights themselves stay int8."""
    return copy.deepcopy(module).to(dtype)
