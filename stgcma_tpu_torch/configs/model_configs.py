"""CLIP and Swin tower configurations and their presets.

The port's own copy of `stgcma_tpu/configs/model_configs.py` (ClipConfig,
SwinConfig, AVSHeadConfig, AVQAHeadConfig and the clip_b16 / clip_l14 / clip_tiny_test,
swin_base / swin_large / swin_tiny_test presets), so that the port imports
nothing of the JAX package.
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


@dataclasses.dataclass(frozen=True)
class SwinConfig:
    """Swin-2D adapter backbone (reference: AVE/model/Swin_AVE.py:1129-1599).

    `scan_blocks` and `use_checkpoint` are the JAX package's compile-time and
    rematerialization devices; the port keeps the fields and ignores them."""

    embed_dim: int = 128
    depths: Tuple[int, ...] = (2, 2, 18, 2)
    num_heads: Tuple[int, ...] = (4, 8, 16, 32)
    window_size: int = 7
    mlp_ratio: float = 4.0
    img_size: int = 224
    # (pt, ph, pw); the reference always uses (1, 4, 4)
    patch_size: Tuple[int, int, int] = (1, 4, 4)
    num_frames: int = 10
    in_chans: int = 3
    adapter_ratios: Tuple[float, ...] = (0.25, 0.25, 0.25, 0.25)
    qkv_bias: bool = True
    ftmode: str = "fusion"
    label_dim: int = 29
    with_nega_stream: bool = False
    ln_eps: float = 1e-5
    use_temporal_attn: bool = True
    use_t_adapter: bool = True
    use_s_adapter: bool = True
    use_g_adapter: bool = True
    use_checkpoint: bool = False
    scan_blocks: int = 0

    @property
    def num_layers(self) -> int:
        return len(self.depths)

    @property
    def num_features(self) -> int:
        return int(self.embed_dim * 2 ** (self.num_layers - 1))

    @property
    def patches_resolution(self) -> Tuple[int, int]:
        return (self.img_size // self.patch_size[1], self.img_size // self.patch_size[2])

    @property
    def num_ttokens(self) -> int:
        return self.num_frames // self.patch_size[0]

    def stage_dim(self, i: int) -> int:
        return int(self.embed_dim * 2 ** i)

    def stage_resolution(self, i: int) -> Tuple[int, int]:
        pr = self.patches_resolution
        return (pr[0] // (2 ** i), pr[1] // (2 ** i))


@dataclasses.dataclass(frozen=True)
class AVSHeadConfig:
    """AVS segmentation decoder (reference: AVS/model/Swin_AVSModel.py:1473-1894)."""

    channel: int = 256
    vis_dim: Tuple[int, ...] = (64, 128, 320, 512)
    # per-stage visual feature dims coming out of the backbone (Large: 192/384/768/1536)
    stage_dims: Tuple[int, ...] = (192, 384, 768, 1536)
    stage_resolutions: Tuple[int, ...] = (56, 28, 14, 7)
    tpavi_stages: Tuple[int, ...] = (0, 1, 2, 3)
    tpavi_va_flag: bool = True
    tpavi_vv_flag: bool = False
    audio_dim: int = 1536
    tpavi_audio_dim: int = 128
    num_frames: int = 5


@dataclasses.dataclass(frozen=True)
class AVQAHeadConfig:
    """AVQA heads (reference: AVQA/model/Swin_AVQAModel_V1.py:1420-1473)."""

    feat_dim: int = 1536
    vocab_size: int = 93
    answer_dim: int = 42
    qst_word_embed: int = 1536
    qst_hidden: int = 1536
    qst_layers: int = 1
    attn_heads: int = 4
    # train-time dropout on the QA-head attention weights (reference
    # MultiheadAttention(1536, 4, dropout=0.1), Swin_AVQAModel_V1.py:1449-1450)
    attn_dropout: float = 0.1
    grid: int = 7
    num_frames: int = 10


def swin_base(**kw) -> SwinConfig:
    """MM-Swin-*-Base (AVE/run_adapt_ave29.py:153-165)."""
    kw.setdefault("adapter_ratios", (0.125, 0.125, 0.0625, 0.0625))
    return SwinConfig(embed_dim=128, depths=(2, 2, 18, 2), num_heads=(4, 8, 16, 32), **kw)


def swin_large(**kw) -> SwinConfig:
    """MM-Swin-*-Large (AVE/run_adapt_ave29.py:167-181)."""
    kw.setdefault("adapter_ratios", (0.5, 0.25, 0.125, 0.0625))
    return SwinConfig(embed_dim=192, depths=(2, 2, 18, 2), num_heads=(6, 12, 24, 48), **kw)


def swin_tiny_test(**kw) -> SwinConfig:
    """Small config for CPU unit tests (not a reference preset)."""
    kw.setdefault("embed_dim", 16)
    kw.setdefault("depths", (2, 2))
    kw.setdefault("num_heads", (2, 4))
    kw.setdefault("img_size", 56)
    kw.setdefault("num_frames", 2)
    kw.setdefault("adapter_ratios", (0.25, 0.25))
    return SwinConfig(**kw)
