"""CLIP tower configuration and its presets.

The port's own copy of the CLIP half of `stgcma_tpu/configs/model_configs.py`
(ClipConfig and the clip_b16 / clip_l14 / clip_tiny_test presets), so that the
port imports nothing of the JAX package.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class ClipConfig:
    """CLIP visual tower + adapters (reference: AVE/model/CLIP_AVE.py:716-1140)."""

    embed_dim: int = 768
    layers: int = 12
    heads: int = 12
    patch_size: int = 16
    input_resolution: int = 224
    num_frames: int = 10
    # audio fbank input is [T, audio_len, mel_bins] per clip-second
    audio_fdim: int = 128
    audio_tdim: int = 102
    adapter_ratio: float = 0.0625
    ftmode: str = "fusion"
    label_dim: int = 29
    ln_eps: float = 1e-5

    @property
    def num_patches(self) -> int:
        return (self.input_resolution // self.patch_size) ** 2

    @property
    def grid(self) -> int:
        return self.input_resolution // self.patch_size

    @property
    def audio_grid(self) -> Tuple[int, int]:
        # conv k=patch, s=patch, VALID over (audio_tdim rows, audio_fdim cols)
        f = (self.audio_tdim - self.patch_size) // self.patch_size + 1
        t = (self.audio_fdim - self.patch_size) // self.patch_size + 1
        return (f, t)

    @property
    def num_patches_audio(self) -> int:
        f, t = self.audio_grid
        return f * t


def clip_b16(**kw) -> ClipConfig:
    kw.setdefault("adapter_ratio", 0.0625)
    return ClipConfig(embed_dim=768, layers=12, heads=12, patch_size=16, **kw)


def clip_l14(**kw) -> ClipConfig:
    kw.setdefault("adapter_ratio", 0.0625)
    return ClipConfig(embed_dim=1024, layers=24, heads=16, patch_size=14, **kw)


def clip_tiny_test(**kw) -> ClipConfig:
    """Small config for CPU unit tests (not a reference preset)."""
    kw.setdefault("embed_dim", 32)
    kw.setdefault("layers", 2)
    kw.setdefault("heads", 4)
    kw.setdefault("patch_size", 16)
    kw.setdefault("input_resolution", 64)
    kw.setdefault("num_frames", 2)
    kw.setdefault("audio_fdim", 64)
    kw.setdefault("audio_tdim", 48)
    kw.setdefault("adapter_ratio", 0.25)
    return ClipConfig(**kw)
