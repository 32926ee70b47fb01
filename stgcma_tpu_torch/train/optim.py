"""Optimizer construction: the name-based trainable partition, torch Adam in
two groups, per-step LR tables.

Port of `stgcma_tpu/train/optim.py` on the port's module names (the JAX
tree's keys, dotted):
- `label_params` (:29): every parameter and buffer is 'head', 'adapt',
  'frozen' or 'buffer'. The reference's trainable names
  (AVE/traintest_adapt_ave29.py:51-61) match ADAPT_PATTERNS; the task heads
  are HEAD_ROOTS; BatchNorm running statistics (TPAVI's W_z) are 'buffer'.
  The serving path uses it to share the frozen tower between tasks
  (`serving.share_frozen_tower`);
- `trainable_mask` (:46), as the `requires_grad` flags `init_train_state`
  sets;
- `cosine_schedule` (:64) and `multistep_schedule` (:85): the same numpy
  tables, bit for bit;
- `build_optimizer` (:110): Adam(weight_decay=5e-7, betas=(0.95, 0.999),
  eps=1e-8) with L2 folded into the gradient, which is what the JAX chain
  `add_decayed_weights` -> `scale_by_adam` -> `scale_by_learning_rate` is
  (`tests/test_train.py::test_torch_adam_parity`), in two groups, 'adapt'
  and 'head', each with its own LR table; no group for 'frozen' or
  'buffer' leaves, which the JAX `multi_transform` sets to zero.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch
from torch import nn

ADAPT_PATTERNS = ("adapter", "Adapter", "temporal_embedding", "ln_post",
                  "my_tokens", "gate_", "ln_before", "temporal_position_bias_table")
HEAD_ROOTS = ("mlp_head", "avstask", "avqatask")
ADAM_BETAS, ADAM_EPS = (0.95, 0.999), 1e-8   # the reference's Adam (torch_adam :99)


def label(name: str) -> str:
    """The label of one dotted parameter or buffer name."""
    parts = name.split(".")
    if "bn" in parts and parts[-1] in ("running_mean", "running_var"):
        return "buffer"
    if any(h in parts for h in HEAD_ROOTS):
        return "head"
    if any(p in name for p in ADAPT_PATTERNS):
        return "adapt"
    return "frozen"


def label_params(model: nn.Module) -> Dict[str, str]:
    """{name: label} over the model's parameters and buffers."""
    names = [n for n, _ in model.named_parameters()] + [n for n, _ in model.named_buffers()]
    return {n: label(n) for n in names}


def trainable_mask(model: nn.Module, freeze_base: bool = True) -> Dict[str, bool]:
    """{parameter name: trainable}: 'adapt' and 'head' (and, without
    freeze_base, 'frozen' too; never 'buffer')."""
    labels = label_params(model)
    return {n: (labels[n] not in ("frozen", "buffer")) if freeze_base else labels[n] != "buffer"
            for n, _ in model.named_parameters()}


def cosine_schedule(base_lr: float, min_lr: float, epochs: int, steps_per_epoch: int,
                    warmup_epochs: int = 0, warmup_steps: int = -1,
                    start_warmup_value: float = 0.0) -> np.ndarray:
    """Per-step LR table identical to utilities/scheduler.py:5-30."""
    total = epochs * steps_per_epoch
    warmup_iters = warmup_epochs * steps_per_epoch
    if warmup_steps > 0:
        warmup_iters = warmup_steps
    warmup_iters = min(warmup_iters, total)
    warmup = np.linspace(start_warmup_value, base_lr, warmup_iters) \
        if warmup_iters > 0 else np.array([])
    n = epochs * steps_per_epoch - warmup_iters
    i = np.arange(n)
    main = min_lr + 0.5 * (base_lr - min_lr) * (1 + np.cos(np.pi * i / n))
    table = np.concatenate([warmup, main])
    if len(table) != epochs * steps_per_epoch:
        raise ValueError(f"cosine table of {len(table)} steps, expected {total}")
    return table.astype(np.float32)


def multistep_schedule(base_lr: float, start: int, step: int, decay: float,
                       epochs: int, steps_per_epoch: int) -> np.ndarray:
    """torch MultiStepLR(milestones=range(start, 1000, step), gamma=decay) as
    a per-step table (AVE/traintest_adapt_ave29.py:105-107 fallback)."""
    table = np.empty(epochs * steps_per_epoch, np.float32)
    for e in range(epochs):
        n_hit = len(range(start, e + 1, step)) if e + 1 >= start else 0
        table[e * steps_per_epoch:(e + 1) * steps_per_epoch] = base_lr * decay ** n_hit
    return table


class Optimizer:
    """torch Adam over the 'adapt' and 'head' parameters that require grad,
    one group each, with a per-step LR table a group (`step` sets every
    group's lr from its table at the optimizer's own step count, clamped to
    the table's end, then steps, as the JAX schedule reads its count)."""

    def __init__(self, model: nn.Module, base_lr: float, head_lr_mult: float = 1.0,
                 weight_decay: float = 5e-7, lr_table: np.ndarray = None,
                 head_lr_table: np.ndarray = None):
        labels = label_params(model)
        groups = []
        for name in ("adapt", "head"):
            params = [p for n, p in model.named_parameters()
                      if labels[n] == name and p.requires_grad]
            if params:
                groups.append({"params": params, "name": name,
                               "names": [n for n, p in model.named_parameters()
                                         if labels[n] == name and p.requires_grad]})
        if not groups:
            raise ValueError("no trainable parameter: call init_train_state first")
        self.base_lr, self.head_lr_mult = base_lr, head_lr_mult
        self.tables = {"adapt": lr_table, "head": head_lr_table}
        self.adam = torch.optim.Adam(groups, lr=base_lr, betas=ADAM_BETAS, eps=ADAM_EPS,
                                     weight_decay=weight_decay)
        self.count = 0

    def lr(self, group: str, count: int) -> float:
        """The LR of `group` at the `count`-th update (0-based)."""
        adapt = self.tables["adapt"]
        base = (float(adapt[min(count, len(adapt) - 1)]) if adapt is not None
                else self.base_lr)
        head = self.tables["head"]
        if group == "adapt":
            return base
        if head is not None:
            return float(head[min(count, len(head) - 1)])
        return base * self.head_lr_mult

    def step(self):
        for g in self.adam.param_groups:
            g["lr"] = self.lr(g["name"], self.count)
        self.adam.step()
        self.count += 1

    def zero_grad(self):
        self.adam.zero_grad(set_to_none=True)

    def named_parameters(self):
        for g in self.adam.param_groups:
            yield from zip(g["names"], g["params"])

    _STATE = ("step", "exp_avg", "exp_avg_sq")

    def state_dict(self) -> Dict[str, torch.Tensor]:
        """{"count": the update count, "<param>.<step|exp_avg|exp_avg_sq>":
        Adam's state}, flat, for `checkpoint.io`."""
        out = {"count": torch.tensor(self.count)}
        for n, p in self.named_parameters():
            for k, v in self.adam.state.get(p, {}).items():
                out[f"{n}.{k}"] = v
        return out

    def load_state_dict(self, state: Dict[str, torch.Tensor]):
        self.count = int(state["count"])
        for n, p in self.named_parameters():
            if f"{n}.exp_avg" in state:
                self.adam.state[p] = {k: state[f"{n}.{k}"].to(p.device if k != "step" else "cpu")
                                      for k in self._STATE}


def build_optimizer(model: nn.Module, base_lr: float, head_lr_mult: float = 1.0,
                    weight_decay: float = 5e-7, lr_table: np.ndarray = None,
                    head_lr_table: np.ndarray = None) -> Optimizer:
    """Two-group Adam: 'adapt' @ lr, 'head' @ lr * head_lr
    (AVE/traintest_adapt_ave29.py:68), frozen untouched. The reference builds
    a separate cosine table for the head group from lr * head_lr down to the
    same min_lr (:84-101): pass it as head_lr_table; without one the head
    group takes the adapt group's LR times the multiplier."""
    return Optimizer(model, base_lr, head_lr_mult, weight_decay, lr_table, head_lr_table)
