"""int8 weights for frozen-tower serving.

Port of `stgcma_tpu/ops/quant.py`: quantize_weight (:22), int8_matmul
(:31), quantize_linear_params (:52), linear_q (:61), quantize_clip_tower
(:71) and quantize_swin_tower (:90). Weights are per-output-channel
symmetric int8. Activations are quantized per row in two ways, as in the
JAX package, and the two are kept apart:
- inside the kernels K2-K4 (ops/fused_attn.py, ops/swin_block.py):
  scale = max(|x|, 1e-30) * (1/127), codes by a reciprocal multiply;
- in `int8_matmul`, the JAX package's XLA path (its `linear` on a quantized
  layer outside the kernels: the 32-head temporal site of the int8 Swin
  tower): scale = max(|x| / 127, 1e-12), codes by an exact divide.
"""
from __future__ import annotations

import copy

import torch
from torch import nn

from .common import Linear, QLinear
from .fused_attn import _EPI_Q_BF16, _check_cuda, _gemm_s8, _stream


def quantize_weight(w: torch.Tensor):
    """(out, in) float -> (int8 (out, in), float32 scale (out,)).

    Same arithmetic as the JAX version: scale = max|w| / 127 over the input
    axis, floored at 1e-12, q = clip(round_half_even(w / scale), -127, 127)."""
    wf = w.float()
    s = wf.abs().amax(dim=1) / 127.0
    s = torch.clamp_min(s, 1e-12)
    q = torch.clamp(torch.round(wf / s[:, None]), -127, 127).to(torch.int8)
    return q, s


def int8_matmul(x: torch.Tensor, wq: torch.Tensor, ws: torch.Tensor,
                bias: torch.Tensor) -> torch.Tensor:
    """x (..., K) bf16 or fp32; wq int8 (N, K); ws (N,); bias (N,).

    Per-row activation quantization (scale = max(|x| / 127, 1e-12), codes =
    clip(round_half_even(x / scale)) by an exact divide), an exact int8
    product with int32 sums, then acc * scale * ws + bias in fp32, cast to
    x's dtype. The quantization runs in torch on either device; the product
    runs in float64 on the CPU (exact for int8 sums below 2^53) and in
    `csrc/gemm.cu`'s `stg_gemm_s8` on the card, whose EPI_Q_BF16 epilogue
    computes the same acc * scale * ws + bias in fp32 and rounds to bf16
    (the only dtype it takes on the card)."""
    shape = x.shape
    K, N = shape[-1], wq.shape[0]
    xf = x.reshape(-1, K).float()
    sx = torch.clamp_min(xf.abs().amax(dim=-1, keepdim=True) / 127.0, 1e-12)
    xq = torch.clamp(torch.round(xf / sx), -127, 127)
    if x.device.type == "cpu":
        out = torch.matmul(xq.double(), wq.double().t()).float() * sx * ws.float()
        return (out + bias.float()).to(x.dtype).reshape(*shape[:-1], N)
    if x.device.type != "cuda":
        raise ValueError(f"int8_matmul: no kernel for device {x.device}")
    with torch.cuda.device(x.device):
        return _int8_matmul_cuda(x, xq, sx, wq, ws, bias)


def _int8_matmul_cuda(x, xq, sx, wq, ws, bias):
    """`int8_matmul`'s product on the card: the codes xq (M, K) and scales sx
    (M, 1), fp32 values from torch, into `csrc/gemm.cu`'s `stg_gemm_s8`."""
    shape, bf = x.shape, torch.bfloat16
    K, N = shape[-1], wq.shape[0]
    if x.dtype != bf:
        raise ValueError(f"int8_matmul on the card takes bf16 x, got {x.dtype}")
    if K % 16:
        raise ValueError(f"int8_matmul on the card takes K in multiples of 16, got K={K}")
    xq = xq.to(torch.int8)
    sx = sx.reshape(-1).contiguous()
    _check_cuda(xq, {"codes": (xq, torch.int8), "scales": (sx, torch.float32),
                     "wq": (wq, torch.int8), "ws": (ws, bf), "bias": (bias, bf)})
    if tuple(wq.shape) != (N, K) or tuple(ws.shape) != (N,) or tuple(bias.shape) != (N,):
        raise ValueError(f"int8_matmul: wq {tuple(wq.shape)}, ws {tuple(ws.shape)}, bias "
                         f"{tuple(bias.shape)} do not fit x (..., {K})")
    out = torch.empty((xq.shape[0], N), dtype=bf, device=x.device)
    _gemm_s8(xq, sx, wq, ws, bias, out, _EPI_Q_BF16, _stream(x))
    return out.reshape(*shape[:-1], N)


def linear_q(p: QLinear, x: torch.Tensor) -> torch.Tensor:
    """`linear` over a quantized layer (quant.py:61): `int8_matmul`."""
    return int8_matmul(x, p.weight_q, p.weight_s, p.bias)


def quantize_linear_params(p: Linear) -> QLinear:
    out_f, in_f = p.weight.shape
    ql = QLinear(in_f, out_f).to(p.weight.device)
    q, s = quantize_weight(p.weight.detach())
    ql.weight_q.copy_(q)
    ql.weight_s.copy_(s)
    ql.bias.data.copy_(p.bias.detach().float())
    return ql


def quantize_clip_tower(backbone: nn.Module) -> nn.Module:
    """A copy of the CLIP backbone with every resblock's attention in/out
    projection and MLP c_fc/c_proj quantized to int8. Adapters, gates, LN and
    embeddings stay float; the blocks route on `quantized`
    (nn/clip_vit.py)."""
    out = copy.deepcopy(backbone)
    for blk in out.resblocks:
        blk.attn.in_proj = quantize_linear_params(blk.attn.in_proj)
        blk.attn.out_proj = quantize_linear_params(blk.attn.out_proj)
        blk.mlp.c_fc = quantize_linear_params(blk.mlp.c_fc)
        blk.mlp.c_proj = quantize_linear_params(blk.mlp.c_proj)
    return out


def quantize_swin_tower(backbone: nn.Module) -> nn.Module:
    """A copy of the Swin backbone with every block's attention qkv and proj
    and MLP fc1/fc2 quantized to int8. Patch embed, merging reduction,
    norms, bias tables, adapters and gates stay float; the blocks route on
    `quantized` (nn/swin.py, ops/swin_block.py)."""
    out = copy.deepcopy(backbone)
    for layer in out.layers:
        for blk in layer.blocks:
            blk.attn.qkv = quantize_linear_params(blk.attn.qkv)
            blk.attn.proj = quantize_linear_params(blk.attn.proj)
            blk.mlp.fc1 = quantize_linear_params(blk.mlp.fc1)
            blk.mlp.fc2 = quantize_linear_params(blk.mlp.fc2)
    return out
