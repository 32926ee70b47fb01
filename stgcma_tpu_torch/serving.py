"""Batched AV serving on one device.

Port of `stgcma_tpu/serving.py::MultiTaskServer` (:49-121) with the AVE
tasks, Swin (`add_ave`) and CLIP (`add_clip_ave`, any ftmode): float parameters and float
inputs are cast to the serving dtype (bf16 by default, the int8 tower's
scales and the Swin bias tables included, as the JAX `cast_tree` does) and
the logits come back as float32 numpy. The mesh and shard options and
`serve_stream` are not ported yet (ROADMAP.md).
"""
from __future__ import annotations

from typing import Callable, Dict

import numpy as np
import torch

from .configs import ClipConfig, SwinConfig
from .models.ave import ClipAVE, SwinAVE, apply_clip_ave, apply_swin_ave
from .ops.common import cast_tree, resolve_device


class MultiTaskServer:
    """Dispatches batched inference by task name."""

    def __init__(self, dtype=torch.bfloat16, device="cuda"):
        self.dtype = dtype
        self.device = resolve_device(device)
        self._fns: Dict[str, Callable] = {}

    def add_ave(self, name: str, cfg: SwinConfig, model: SwinAVE):
        """Serve a Swin AVE `model`, float or with an int8 tower (left as it
        is: the server keeps a cast copy)."""
        m = cast_tree(model, self.dtype).to(self.device).eval()
        self._fns[name] = lambda batch: apply_swin_ave(m, cfg, batch["a"], batch["v"])

    def add_clip_ave(self, name: str, cfg: ClipConfig, model: ClipAVE):
        """Serve a CLIP AVE `model` of any ftmode, float or with an int8 tower
        (left as it is: the server keeps a cast copy). A `videoonly` task's
        batches need no "a", an `audioonly` task's no "v"."""
        m = cast_tree(model, self.dtype).to(self.device).eval()
        self._fns[name] = lambda batch: apply_clip_ave(m, cfg, batch.get("a"), batch.get("v"))

    def tasks(self):
        return sorted(self._fns)

    @torch.inference_mode()
    def predict(self, task: str, batch: Dict[str, np.ndarray]) -> np.ndarray:
        dev = {}
        for k, v in batch.items():
            t = torch.as_tensor(np.asarray(v)).to(self.device)
            dev[k] = t.to(self.dtype) if t.is_floating_point() else t
        return self._fns[task](dev).float().cpu().numpy()
