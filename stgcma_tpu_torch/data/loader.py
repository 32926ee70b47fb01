"""Batching with background decode, and the device pipelines: a host batch of
raw uint8 frames and float32 wave segments -> the model's (a, v), on the
model's device.

Port of `stgcma_tpu/data/loader.py`: `collate` (:21) and `DataLoader` (:33),
copied (threads decode items in parallel; `shuffle`, `sample_weights` drawn
with replacement, `drop_last`), with `set_epoch` added so that a resumed
training run shuffles as the straight run did; `make_ave_device_pipeline`
(:113, both branches), `make_avqa_device_pipeline` (:149) and
`make_avs_device_pipeline` (:169), with their default fbank statistics (the
reference launch scripts' dataset_mean / dataset_std). The fbank and the
transforms are plain torch (ops/fbank.py, data/transforms.py) and run where
the tensors lie: a host batch of numpy arrays or CPU tensors is copied to
`device` first, a batch already there is used as it is.
"""
from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Dict, Iterator, Tuple

import numpy as np
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
                             train: bool = False, image_size: int = 224, mixup: float = 0.0,
                             device="cuda"):
    """AVE: frames (B, T, H, W, 3) uint8 -> v (B, T, image_size, image_size,
    3); wave (B, T, L) float32 -> a (B, T, target_length, num_mel_bins) by
    `fbank_image`. Returns (a, v), fp32.

    Evaluation (`train` False): pipe(batch), v by `eval_transform`.
    Training: pipe(batch, generator), each clip through `train_transform`
    with its own draws from `generator` (in batch order), then, where mixup
    > 0, the waveform mixup of the reference (AVE/dataloader.py:491-497,
    audio only, per-second Beta(10, 10) lambdas) before the fbank."""
    if not train:
        return _pipeline(lambda f: transforms.eval_transform(f, image_size), fbank_cfg,
                         target_length, norm_mean, norm_std, device)
    device = resolve_device(device)

    @torch.no_grad()
    def train_pipe(batch, generator: torch.Generator):
        frames = _on(batch["frames"], device)
        draws = [transforms.sample_train_transform(generator, clip.shape, image_size, device)
                 for clip in frames]
        v = torch.stack([transforms.train_transform_apply(clip, d, image_size)
                         for clip, d in zip(frames, draws)])
        wave = _on(batch["wave"], device)
        if mixup > 0:
            wave = transforms.mixup_apply(wave, transforms.sample_mixup(
                generator, wave.shape[0], wave.shape[1], mixup_prob=mixup))
        a = fbank_image(wave, fbank_cfg, target_length, norm_mean, norm_std)
        return a, v

    return train_pipe


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


def collate(items):
    out = {}
    for k in items[0]:
        vals = [it[k] for it in items]
        if isinstance(vals[0], np.ndarray) or np.isscalar(vals[0]) \
                or isinstance(vals[0], (int, float, np.integer, np.floating)):
            out[k] = np.stack([np.asarray(v) for v in vals])
        else:
            out[k] = vals  # e.g. qtype strings
    return out


class DataLoader:
    """Minimal prefetching loader: parallel __getitem__ decode in threads,
    FIFO batches.

    sample_weights: per-item weights for balanced sampling — each epoch draws
    len(weights) indices WITH replacement, p proportional to weight (torch
    WeightedRandomSampler semantics, AVE/run_adapt_ave29.py:101-111). Epoch
    e (counted from 0 by the iterations, or set by `set_epoch`) shuffles or
    samples from `RandomState(seed + e)`."""

    def __init__(self, dataset, batch_size: int, shuffle: bool = False,
                 num_workers: int = 8, drop_last: bool = True, seed: int = 0,
                 prefetch: int = 2, sample_weights=None):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.num_workers = num_workers
        self.drop_last = drop_last
        self.seed = seed
        self.prefetch = prefetch
        self.epoch = 0
        if sample_weights is not None:
            sample_weights = np.asarray(sample_weights, np.float64)
            if len(sample_weights) != len(dataset):
                raise ValueError("sample_weights must have one entry per dataset item")
        self.sample_weights = sample_weights

    def set_epoch(self, epoch: int):
        self.epoch = epoch

    def __len__(self):
        n = len(self.dataset) // self.batch_size
        if not self.drop_last and len(self.dataset) % self.batch_size:
            n += 1
        return n

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        if self.sample_weights is not None:
            rs = np.random.RandomState(self.seed + self.epoch)
            p = self.sample_weights / self.sample_weights.sum()
            idx = rs.choice(len(self.dataset), size=len(self.dataset), replace=True, p=p)
        else:
            idx = np.arange(len(self.dataset))
            if self.shuffle:
                np.random.RandomState(self.seed + self.epoch).shuffle(idx)
        self.epoch += 1
        batches = [idx[i:i + self.batch_size] for i in range(0, len(idx), self.batch_size)]
        if self.drop_last:
            batches = [b for b in batches if len(b) == self.batch_size]

        if self.num_workers <= 0:      # torch-DataLoader num_workers=0: load inline
            for b in batches:
                yield collate([self.dataset[j] for j in b])
            return

        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        pool = ThreadPoolExecutor(max_workers=self.num_workers)
        stop = threading.Event()

        def produce():
            try:
                for b in batches:
                    if stop.is_set():
                        return
                    q.put(collate(list(pool.map(self.dataset.__getitem__, b))))
            except Exception as e:     # handed to the consumer, which raises it
                q.put(e)
            finally:
                q.put(None)

        t = threading.Thread(target=produce, daemon=True)
        t.start()
        try:
            while True:
                batch = q.get()
                if batch is None:
                    break
                if isinstance(batch, Exception):
                    raise batch
                yield batch
        finally:
            stop.set()
            while t.is_alive():        # unblock a producer waiting on a full queue
                try:
                    q.get_nowait()
                except queue.Empty:
                    t.join(timeout=0.05)
            pool.shutdown(wait=True)
