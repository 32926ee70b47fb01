"""The trainable partition of the port's parameters by name.

Port of `stgcma_tpu/train/optim.py::label_params` (:29) on the port's
module names (the JAX tree's keys, dotted): every parameter and buffer is
'head', 'adapt', 'frozen' or 'buffer'. The reference's trainable names
(AVE/traintest_adapt_ave29.py:51-61) match ADAPT_PATTERNS; the task heads
are HEAD_ROOTS; BatchNorm running statistics (TPAVI's W_z) are 'buffer'.
The serving path uses it to share the frozen tower between tasks
(`serving.share_frozen_tower`); the optimizer waits for training
(ROADMAP.md).
"""
from __future__ import annotations

from typing import Dict

from torch import nn

ADAPT_PATTERNS = ("adapter", "Adapter", "temporal_embedding", "ln_post",
                  "my_tokens", "gate_", "ln_before", "temporal_position_bias_table")
HEAD_ROOTS = ("mlp_head", "avstask", "avqatask")


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
