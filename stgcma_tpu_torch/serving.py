"""Batched AV serving on one device.

Port of `stgcma_tpu/serving.py::MultiTaskServer` (:49-121) with the AVE
tasks, Swin (`add_ave`) and CLIP (`add_clip_ave`), any ftmode, AVSBench
segmentation (`add_avs`) and MUSIC-AVQA (`add_avqa`): float parameters,
buffers and inputs are cast to the serving dtype (bf16 by default, the int8
tower's scales, the Swin bias tables and the BatchNorms' running statistics
included, as the JAX `cast_tree` does), integer inputs (AVQA's question) go
as they are, and the logits or mask logits come back as float32 numpy. Only
the inputs a task reads go to the card. The mesh and shard options and
`serve_stream` are not ported yet (ROADMAP.md).
"""
from __future__ import annotations

from typing import Callable, Dict, Tuple

import numpy as np
import torch

from .configs import AVQAHeadConfig, AVSHeadConfig, ClipConfig, SwinConfig
from .models.ave import ClipAVE, SwinAVE, apply_clip_ave, apply_swin_ave
from .models.avqa import AVQAModel, answer_avqa
from .models.avs import AVSModel, apply_avs
from .ops.common import cast_tree, resolve_device


class MultiTaskServer:
    """Dispatches batched inference by task name."""

    def __init__(self, dtype=torch.bfloat16, device="cuda"):
        self.dtype = dtype
        self.device = resolve_device(device)
        self._fns: Dict[str, Callable] = {}
        self._reads: Dict[str, Tuple[str, ...]] = {}    # the inputs each task copies
        self.models: Dict[str, torch.nn.Module] = {}    # the cast copy each task serves

    def add_ave(self, name: str, cfg: SwinConfig, model: SwinAVE):
        """Serve a Swin AVE `model` of any ftmode, float or with an int8 tower
        (left as it is: the server keeps a cast copy). A `videoonly` task's
        batches need no "a", an `audioonly` task's no "v"."""
        m = self.models[name] = cast_tree(model, self.dtype).to(self.device).eval()
        self._fns[name] = lambda batch: apply_swin_ave(m, cfg, batch.get("a"), batch.get("v"))
        self._reads[name] = ("a", "v")

    def add_avs(self, name: str, cfg: SwinConfig, hcfg: AVSHeadConfig, model: AVSModel):
        """Serve an AVS `model` (left as it is: the server keeps a cast copy):
        a request {"a", "v"} -> the mask logits `pred` (B*T, H, W, 1)."""
        m = self.models[name] = cast_tree(model, self.dtype).to(self.device).eval()
        self._fns[name] = lambda batch: apply_avs(m, cfg, hcfg, batch["a"], batch["v"])[0]
        self._reads[name] = ("a", "v")

    def add_clip_ave(self, name: str, cfg: ClipConfig, model: ClipAVE):
        """Serve a CLIP AVE `model` of any ftmode, float or with an int8 tower
        (left as it is: the server keeps a cast copy). A `videoonly` task's
        batches need no "a", an `audioonly` task's no "v"."""
        m = self.models[name] = cast_tree(model, self.dtype).to(self.device).eval()
        self._fns[name] = lambda batch: apply_clip_ave(m, cfg, batch.get("a"), batch.get("v"))
        self._reads[name] = ("a", "v")

    def add_avqa(self, name: str, cfg: SwinConfig, hcfg: AVQAHeadConfig, model: AVQAModel):
        """Serve an AVQA `model` (left as it is: the server keeps a cast
        copy): a request {"a", "v", "v_nega", "question"} -> out_qa (B,
        answer_dim), through `answer_avqa`, as the JAX server's compiled
        `apply_avqa(...)[0]`. out_qa does not read v_nega, so v_nega stays
        on the host."""
        m = self.models[name] = cast_tree(model, self.dtype).to(self.device).eval()
        self._fns[name] = lambda batch: answer_avqa(m, cfg, hcfg, batch["a"], batch["v"],
                                                    batch["question"])
        self._reads[name] = ("a", "v", "question")

    def tasks(self):
        return sorted(self._fns)

    @torch.inference_mode()
    def predict(self, task: str, batch: Dict[str, np.ndarray]) -> np.ndarray:
        dev = {}
        for k, v in batch.items():
            if k not in self._reads[task]:
                continue
            t = torch.as_tensor(np.asarray(v)).to(self.device)
            dev[k] = t.to(self.dtype) if t.is_floating_point() else t
        return self._fns[task](dev).float().cpu().numpy()
