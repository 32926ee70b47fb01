"""AVE-29 on a CLIP ViT tower with STG-CMA adapters.

Serving: `MultiTaskServer.add_clip_ave`, a request {"a", "v"} -> logits
(B*T, label_dim). Training: the loss of `cli/run_adapt_ave29.py` (the
device train pipeline on raw waves and uint8 frames, the model in bf16 with
the head's dropout, CE against one-hot labels a second) under
`train/steps.py::make_train_step` and `train/optim.py`'s Adam.
"""
from __future__ import annotations

import torch

from stgcma_tpu_torch.configs import ClipConfig
from stgcma_tpu_torch.data.loader import make_ave_device_pipeline
from stgcma_tpu_torch.models.ave import ClipAVE, apply_clip_ave
from stgcma_tpu_torch.ops.fbank import FbankConfig
from stgcma_tpu_torch.ops.quant import quantize_clip_tower
from stgcma_tpu_torch.train import losses

from .. import flops
from ..reference import clip_ave as ref
from ..reference import pipeline as ref_pipe
from ..reference.layers import soft_cross_entropy

TASK = "ave29"


def port_config(c: dict) -> ClipConfig:
    return ClipConfig(**c["model"])


def new_model(c: dict) -> ClipAVE:
    return ClipAVE(port_config(c))


def serve(server, model, c: dict) -> str:
    server.add_clip_ave(TASK, port_config(c), model)
    return TASK


def quantize(model: ClipAVE) -> ClipAVE:
    model.backbone = quantize_clip_tower(model.backbone)
    return model


def ref_serve(W, c: dict, batch: dict) -> torch.Tensor:
    return ref.forward(W, c["model"], batch["a"], batch["v"])


def loss_fn(c: dict, device, dtype=torch.bfloat16):
    cfg = port_config(c)
    fb = c["fbank"]
    pipe = make_ave_device_pipeline(
        FbankConfig(num_mel_bins=fb["bins"], frame_shift_ms=fb["shift_ms"]), fb["target"],
        fb["mean"], fb["std"], train=True, image_size=cfg.input_resolution, device=device)

    def fn(m, batch, generator):
        a, v = pipe(batch, generator)
        logits = apply_clip_ave(m, cfg, a.to(dtype), v.to(dtype),
                                generator=generator)
        return losses.ave_loss(logits, batch["labels"].to(a.device)), {}

    return fn


def ref_loss_chunks(W, c: dict, batch: dict, g: torch.Generator, chunk: int):
    """The step's loss in parts of `chunk` clips, with the program's draws
    made again from g: every clip's pipeline draws, then the head's
    dropout over the whole batch."""
    size = c["model"]["input_resolution"]
    v = torch.stack([ref_pipe.ave_train_clip(clip, g, size) for clip in batch["frames"]])
    a = ref_pipe.fbank(batch["wave"], **c["fbank"])
    labels = batch["labels"].float()
    B, T = labels.shape[:2]
    keep = (torch.rand((B * T, 512), generator=g) >= 0.5).to(v.device)
    for s in range(0, B, chunk):
        rows = slice(s * T, (s + chunk) * T)
        logits = ref.forward(W, c["model"], a[s:s + chunk], v[s:s + chunk], keep=keep[rows])
        tgt = labels[s:s + chunk].reshape(-1, labels.shape[-1])
        yield soft_cross_entropy(logits, tgt) * (len(tgt) / (B * T))


def count(c: dict, B: int, train: bool) -> flops.Count:
    return flops.clip_ave(c["model"], B, train)
