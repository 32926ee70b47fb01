"""The evaluation device pipelines: a host batch of raw uint8 frames and
float32 wave segments -> the model's (a, v), on the server's device.

Port of `stgcma_tpu/data/loader.py`: `make_ave_device_pipeline` (:113, its
`train=False` branch), `make_avqa_device_pipeline` (:149) and
`make_avs_device_pipeline` (:169), with their default fbank statistics (the
reference launch scripts' dataset_mean / dataset_std). The fbank and the
transforms are plain torch (ops/fbank.py, data/transforms.py) and run where
the tensors lie: a host batch of numpy arrays or CPU tensors is copied to
`device` first, a batch already there is used as it is. The training branch
(RandAugment, mixup), `DataLoader` and `collate` are not ported yet.
"""
from __future__ import annotations

from typing import Callable, Dict, Tuple

import torch

from ..ops.common import resolve_device
from ..ops.fbank import SWIN_FBANK, FbankConfig, fbank_image
from . import transforms

Pipeline = Callable[[Dict[str, object]], Tuple[torch.Tensor, torch.Tensor]]


def _on(x, device: torch.device) -> torch.Tensor:
    return torch.as_tensor(x).to(device)


def _pipeline(frames_fn, fbank_cfg: FbankConfig, target_length: int, norm_mean: float,
              norm_std: float, device) -> Pipeline:
    device = resolve_device(device)

    @torch.no_grad()
    def pipe(batch):
        v = frames_fn(_on(batch["frames"], device))
        a = fbank_image(_on(batch["wave"], device), fbank_cfg, target_length, norm_mean,
                        norm_std)
        return a, v

    return pipe


def make_ave_device_pipeline(fbank_cfg: FbankConfig = SWIN_FBANK, target_length: int = 224,
                             norm_mean: float = -5.081, norm_std: float = 4.485,
                             image_size: int = 224, device="cuda") -> Pipeline:
    """AVE evaluation: frames (B, T, H, W, 3) uint8 -> v (B, T, image_size,
    image_size, 3) by `eval_transform`; wave (B, T, L) float32 -> a (B, T,
    target_length, num_mel_bins) by `fbank_image`. Returns (a, v), fp32."""
    return _pipeline(lambda f: transforms.eval_transform(f, image_size), fbank_cfg,
                     target_length, norm_mean, norm_std, device)


def make_avqa_device_pipeline(fbank_cfg: FbankConfig = SWIN_FBANK, target_length: int = 224,
                              norm_mean: float = -5.385, norm_std: float = 3.593,
                              image_size: int = 224, device="cuda") -> Pipeline:
    """AVQA, train and eval alike: `avqa_transform` (a direct bicubic resize)
    and the fbank image. Returns (a, v), fp32."""
    return _pipeline(lambda f: transforms.avqa_transform(f, image_size), fbank_cfg,
                     target_length, norm_mean, norm_std, device)


def make_avs_device_pipeline(fbank_cfg: FbankConfig = SWIN_FBANK, target_length: int = 224,
                             norm_mean: float = -5.670, norm_std: float = 3.948,
                             device="cuda") -> Pipeline:
    """AVS, train and eval alike: `avs_transform` (normalize only; frames
    come pre-sized) and the fbank image. Returns (a, v), fp32."""
    return _pipeline(transforms.avs_transform, fbank_cfg, target_length, norm_mean, norm_std,
                     device)
