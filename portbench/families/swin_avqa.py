"""MUSIC-AVQA on a Swin tower with STG-CMA adapters and the QA head.

Serving: `MultiTaskServer.add_avqa`, a request {"a", "v", "question"} ->
out_qa (B, answers). Training: `cli/run_adapt_avqa.py::make_loss_fn` (the
AVQA device pipeline on the frames, the negative frames and the waves;
CE(out_qa) + 0.5 CE(match) with the QA head's attention dropout) under
`train/steps.py::make_train_step` and `train/optim.py`'s Adam.
"""
from __future__ import annotations

from types import SimpleNamespace

import torch

from stgcma_tpu_torch.configs import AVQAHeadConfig, SwinConfig
from stgcma_tpu_torch.data.loader import make_avqa_device_pipeline
from stgcma_tpu_torch.models.avqa import AVQAModel
from stgcma_tpu_torch.ops.fbank import FbankConfig
from stgcma_tpu_torch.ops.quant import quantize_swin_tower

from .. import flops
from ..reference import pipeline as ref_pipe
from ..reference import swin_avqa as ref

TASK = "avqa"


def _tuples(d: dict) -> dict:
    return {k: tuple(v) if isinstance(v, list) else v for k, v in d.items()}


def port_configs(c: dict):
    return SwinConfig(**_tuples(c["model"])), AVQAHeadConfig(**c["head"])


def new_model(c: dict) -> AVQAModel:
    return AVQAModel(*port_configs(c))


def serve(server, model, c: dict) -> str:
    cfg, hcfg = port_configs(c)
    server.add_avqa(TASK, cfg, hcfg, model)
    return TASK


def quantize(model: AVQAModel) -> AVQAModel:
    model.backbone = quantize_swin_tower(model.backbone)
    return model


def ref_serve(W, c: dict, batch: dict) -> torch.Tensor:
    return ref.serve(W, c["model"], c["head"], batch["a"], batch["v"], batch["question"])


def loss_fn(c: dict, device, dtype=torch.bfloat16):
    # imported here: the CLI loads scipy.stats, which a served cell's set-up
    # does not need
    from stgcma_tpu_torch.cli.run_adapt_avqa import make_loss_fn
    cfg, hcfg = port_configs(c)
    fb = c["fbank"]
    pipe = make_avqa_device_pipeline(
        FbankConfig(num_mel_bins=fb["bins"], frame_shift_ms=fb["shift_ms"]), fb["target"],
        fb["mean"], fb["std"], image_size=cfg.img_size, device=device)
    return make_loss_fn(cfg, hcfg, pipe, SimpleNamespace(loss="CE"), dtype)


def ref_loss_chunks(W, c: dict, batch: dict, g: torch.Generator, chunk: int):
    """The step's loss, CE(out_qa) + 0.5 CE(match), in parts of `chunk`
    clips; the QA head's dropout masks drawn from g as the program draws
    them (attn_v's, then attn_a's, over the whole batch)."""
    h = c["head"]
    B, T = batch["frames"].shape[:2]
    keep_shape = (B, h["attn_heads"], 1, T)
    keeps = [torch.bernoulli(torch.full(keep_shape, 1.0 - h["attn_dropout"]), generator=g)
             for _ in range(2)]
    a = ref_pipe.fbank(batch["wave"], **c["fbank"])
    for s in range(0, B, chunk):
        sl = slice(s, s + chunk)
        ce_qa, ce_m = ref.train_loss_terms(
            W, c["model"], h, a[sl], ref_pipe.plain_frames(batch["frames"][sl]),
            ref_pipe.plain_frames(batch["frames_nega"][sl]), batch["question"][sl],
            batch["answer"][sl], [k[sl].to(a.device) for k in keeps])
        yield ce_qa / B + 0.5 * ce_m / (2 * B * T)


def count(c: dict, B: int, train: bool) -> flops.Count:
    return flops.swin_avqa(c["model"], c["head"] | {"question_len": c["question_len"]}, B, train)
