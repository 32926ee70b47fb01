"""Train and eval steps.

Port of `stgcma_tpu/train/steps.py`: gradients flow only into the trainable
parameters (adapters and heads: `init_train_state` sets `requires_grad` from
`trainable_mask`), bf16 compute with fp32 master parameters and fp32 Adam
state, no loss scaling (bf16 has fp32's exponent range).

How the rounding follows JAX's (`make_train_step` :21): the model keeps
every parameter in fp32. A step runs the loss through
`torch.func.functional_call` on a dict that maps each trainable name to
`master.to(compute_dtype)` (a differentiable cast) and each frozen name to
its cast, made once and reused while the model is the same object; the
BatchNorm running statistics stay fp32 and are the model's own buffers, so
momentum updates land in the model. So the forward sees the same bf16
values as JAX's `cast(train_params)` / `cast(frozen_params)`, and the
gradient of each cast leaf, formed in bf16 by autograd, reaches its fp32
master through the cast's backward, which is JAX's `g.astype(float32)`.
Frozen leaves need no gradient, so autograd forms none for them (JAX's
closed-over constants).
"""
from __future__ import annotations

import weakref
from typing import Callable, Dict

import torch
from torch import nn
from torch.func import functional_call

from .optim import Optimizer, trainable_mask


def _bn_stat(name: str) -> bool:
    parts = name.split(".")
    return "bn" in parts and parts[-1] in ("running_mean", "running_var")


class _Bound(nn.Module):
    """`fn(model, *args)` as a module's forward, so that `functional_call`
    can swap the model's tensors (named "model.<name>")."""

    def __init__(self, model: nn.Module, fn: Callable):
        super().__init__()
        self.model = model
        self.fn = fn

    def forward(self, *args):
        return self.fn(self.model, *args)


def _tensors(model: nn.Module):
    yield from model.named_parameters()
    yield from model.named_buffers()


def _cast(name: str, t: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    if not t.is_floating_point() or _bn_stat(name):
        return t
    return t.to(dtype)


def _call(model: nn.Module, fn: Callable, state: Dict[str, torch.Tensor], *args):
    return functional_call(_Bound(model, fn), {f"model.{n}": t for n, t in state.items()}, args)


def make_train_step(loss_fn: Callable, optimizer: Optimizer,
                    compute_dtype: torch.dtype = torch.bfloat16) -> Callable:
    """loss_fn(model, batch, generator) -> (loss, aux). Returns
    train_step(model, batch, generator) -> (loss, aux): the loss and its
    gradients in compute_dtype, the optimizer's update of the fp32 masters."""
    frozen = {"model": lambda: None, "state": None}

    def frozen_casts(model):
        if frozen["model"]() is not model:
            frozen["model"] = weakref.ref(model)
            frozen["state"] = {n: _cast(n, t.detach(), compute_dtype)
                               for n, t in _tensors(model) if not t.requires_grad}
        return frozen["state"]

    def train_step(model: nn.Module, batch, generator: torch.Generator = None):
        state = dict(frozen_casts(model))
        state.update({n: p.to(compute_dtype) for n, p in model.named_parameters()
                      if p.requires_grad})
        optimizer.zero_grad()
        loss, aux = _call(model, loss_fn, state, batch, generator)
        loss.backward()
        optimizer.step()
        return loss.detach(), aux

    return train_step


def make_eval_step(apply_fn: Callable, compute_dtype: torch.dtype = torch.bfloat16) -> Callable:
    """apply_fn(model, batch) -> outputs, run under no_grad on a cast of every
    floating parameter and buffer to compute_dtype (`make_eval_step` :59)."""

    @torch.no_grad()
    def eval_step(model: nn.Module, batch):
        state = {n: t.to(compute_dtype) if t.is_floating_point() else t
                 for n, t in _tensors(model)}
        return _call(model, apply_fn, state, batch)

    return eval_step


def init_train_state(model: nn.Module, freeze_base: bool = True) -> Dict[str, bool]:
    """Mark the trainable parameters (`requires_grad`) and freeze the rest;
    returns the mask. Build the optimizer after this."""
    mask = trainable_mask(model, freeze_base)
    for n, p in model.named_parameters():
        p.requires_grad_(mask[n])
    return mask
