"""Kaldi-compatible log-mel filterbank, batched, on its input's device.

Port of `stgcma_tpu/ops/fbank.py`: `FbankConfig` with the two reference
presets (:34, :69-70), `fbank` (:114), `fbank_image` (:154), the VGGish
log-mel (:193) and `segment_starts` (:215). The JAX package computes this in
XLA, outside any Pallas kernel, so the port is plain torch:

    frames (Tensor.unfold) -> remove DC -> preemphasis -> hann window ->
    zero-pad to pow2 -> torch.fft.rfft power spectrum -> one fp32 product
    with the mel banks -> log(max(x, eps))

with kaldi's defaults (frame length 25 ms, preemphasis 0.97,
snip_edges=True, remove_dc_offset=True, low_freq 20, high_freq nyquist,
round_to_power_of_two). The filter banks are built in numpy, as the JAX
package builds them, and cached as numpy arrays: each call makes its own
tensor of them, so no cached tensor outlives a request made in inference
mode. On the card the mel product is fp32 only
while TF32 is off (`torch.backends.cuda.matmul.allow_tf32`, off by default).
"""
from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch
import torch.nn.functional as F

_EPS = 1.1920928955078125e-07  # torch.finfo(torch.float).eps


def _next_pow2(n: int) -> int:
    return 1 << (n - 1).bit_length()


@dataclasses.dataclass(frozen=True)
class FbankConfig:
    sample_frequency: float = 16000.0
    frame_length_ms: float = 25.0
    frame_shift_ms: float = 10.0
    num_mel_bins: int = 23
    low_freq: float = 20.0
    high_freq: float = 0.0          # <=0 -> nyquist + high_freq
    preemphasis: float = 0.97
    remove_dc_offset: bool = True
    window_type: str = "hanning"
    round_to_power_of_two: bool = True
    snip_edges: bool = True
    use_power: bool = True

    @property
    def window_shift(self) -> int:
        return int(self.sample_frequency * self.frame_shift_ms * 0.001)

    @property
    def window_size(self) -> int:
        return int(self.sample_frequency * self.frame_length_ms * 0.001)

    @property
    def padded_window_size(self) -> int:
        return _next_pow2(self.window_size) if self.round_to_power_of_two \
            else self.window_size

    def num_frames(self, num_samples: int) -> int:
        assert self.snip_edges, "only snip_edges=True (kaldi default) is implemented"
        if num_samples < self.window_size:
            return 0
        return 1 + (num_samples - self.window_size) // self.window_shift


# reference presets (AVE/dataloader.py:238-245): Swin 224 bins at a 4.4 ms
# shift (int(16000 * 4.4e-3) = 70 samples: 223 frames of a 1 s segment),
# CLIP 128 bins at 10 ms (98 frames)
SWIN_FBANK = FbankConfig(num_mel_bins=224, frame_shift_ms=4.4)
CLIP_FBANK = FbankConfig(num_mel_bins=128, frame_shift_ms=10.0)


def _feature_window(cfg: FbankConfig) -> np.ndarray:
    n = cfg.window_size
    if cfg.window_type == "hanning":
        # torch.hann_window(periodic=False): symmetric
        return 0.5 - 0.5 * np.cos(2 * np.pi * np.arange(n) / (n - 1))
    if cfg.window_type == "povey":
        return (0.5 - 0.5 * np.cos(2 * np.pi * np.arange(n) / (n - 1))) ** 0.85
    if cfg.window_type == "hamming":
        return 0.54 - 0.46 * np.cos(2 * np.pi * np.arange(n) / (n - 1))
    if cfg.window_type == "rectangular":
        return np.ones(n)
    raise ValueError(cfg.window_type)


def _mel(f):
    return 1127.0 * np.log(1.0 + f / 700.0)


@functools.lru_cache(maxsize=8)
def _mel_banks_cached(num_bins: int, padded: int, sf: float, low: float, high: float):
    """(num_fft_bins + 1, num_mel_bins) triangular filters in mel space
    (kaldi get_mel_banks, transposed for x @ banks, with kaldi's zero row
    for the nyquist bin)."""
    nyquist = 0.5 * sf
    high = high if high > 0 else nyquist + high
    num_fft_bins = padded // 2
    fft_bin_width = sf / padded
    mel_low, mel_high = _mel(low), _mel(high)
    mel_delta = (mel_high - mel_low) / (num_bins + 1)
    bins = np.arange(num_bins)[:, None]
    left = mel_low + bins * mel_delta
    center = left + mel_delta
    right = center + mel_delta
    mel_f = _mel(fft_bin_width * np.arange(num_fft_bins))[None, :]
    up = (mel_f - left) / (center - left)
    down = (right - mel_f) / (right - center)
    banks = np.maximum(0.0, np.minimum(up, down))  # (num_bins, num_fft_bins)
    banks = np.concatenate([banks, np.zeros((num_bins, 1))], axis=1)
    return banks.T.astype(np.float32)


def fbank(waveform: torch.Tensor, cfg: FbankConfig = SWIN_FBANK) -> torch.Tensor:
    """waveform (..., L) float in [-1, 1] -> log-mel (..., m, num_mel_bins),
    fp32, on waveform's device."""
    L = waveform.shape[-1]
    m = cfg.num_frames(L)
    ws, shift, padded = cfg.window_size, cfg.window_shift, cfg.padded_window_size
    lead = waveform.shape[:-1]
    x = waveform.reshape(-1, L).float()
    frames = x.unfold(-1, ws, shift)[:, :m]      # frame i: samples [i*shift, i*shift + ws)

    if cfg.remove_dc_offset:
        frames = frames - frames.mean(dim=-1, keepdim=True)
    if cfg.preemphasis != 0.0:
        prev = torch.cat([frames[..., :1], frames[..., :-1]], dim=-1)
        frames = frames - cfg.preemphasis * prev
    window = torch.from_numpy(_feature_window(cfg).astype(np.float32)).to(x.device)
    frames = frames * window
    if padded > ws:
        frames = F.pad(frames, (0, padded - ws))

    spec = torch.fft.rfft(frames, dim=-1).abs()
    if cfg.use_power:
        spec = spec.square()
    banks = torch.from_numpy(_mel_banks_cached(cfg.num_mel_bins, padded, cfg.sample_frequency,
                                               cfg.low_freq, cfg.high_freq)).to(x.device)
    mel = spec @ banks
    out = torch.log(torch.clamp_min(mel, _EPS))
    return out.reshape(*lead, m, cfg.num_mel_bins)


def fbank_image(waveform: torch.Tensor, cfg: FbankConfig, target_length: int,
                norm_mean: float, norm_std: float) -> torch.Tensor:
    """The reference's post-processing (AVE/dataloader.py:249-267): (x -
    mean) / (2 std), then the time axis zero-padded or trimmed to
    target_length. waveform (..., L) -> (..., target_length, num_mel_bins)."""
    fb = fbank(waveform, cfg)
    fb = (fb - norm_mean) / (norm_std * 2.0)
    m = fb.shape[-2]
    if m < target_length:
        fb = F.pad(fb, (0, 0, 0, target_length - m))
    elif m > target_length:
        fb = fb[..., :target_length, :]
    return fb


@functools.lru_cache(maxsize=2)
def _vggish_mel_matrix(num_bins=64, padded=512, sf=16000.0, fmin=125.0, fmax=7500.0):
    """VGGish mel matrix: HTK mel scale (2595 log10), spectrogram-bin
    centers, triangular weights, the DC bin excluded (torchvggish
    mel_features.spectrogram_to_mel_matrix)."""
    def htk_mel(f):
        return 2595.0 * np.log10(1.0 + f / 700.0)
    n_spec = padded // 2 + 1
    spec_mel = htk_mel(np.linspace(0.0, sf / 2, n_spec))
    band_edges = np.linspace(htk_mel(fmin), htk_mel(fmax), num_bins + 2)
    mat = np.zeros((n_spec, num_bins))
    for i in range(num_bins):
        lo, c, hi = band_edges[i: i + 3]
        lower = (spec_mel - lo) / (c - lo)
        upper = (hi - spec_mel) / (hi - c)
        mat[:, i] = np.maximum(0.0, np.minimum(lower, upper))
    mat[0, :] = 0.0
    return mat.astype(np.float32)


def vggish_log_mel(waveform: torch.Tensor) -> torch.Tensor:
    """VGGish log-mel: 25 ms periodic-hann frames at a 10 ms hop, magnitude
    STFT, HTK mel 125-7500 Hz, log(mel + 0.01) (the torchvggish input
    pipeline behind AVS's audio_log_mel). waveform (..., L) -> (..., m, 64)."""
    L = waveform.shape[-1]
    ws, hop, padded = 400, 160, 512
    m = 1 + (L - ws) // hop
    lead = waveform.shape[:-1]
    x = waveform.reshape(-1, L).float()
    frames = x.unfold(-1, ws, hop)[:, :m]
    window = torch.from_numpy(
        (0.5 - 0.5 * np.cos(2 * np.pi * np.arange(ws) / ws)).astype(np.float32)).to(x.device)
    frames = F.pad(frames * window, (0, padded - ws))
    mag = torch.fft.rfft(frames, dim=-1).abs()
    mel = mag @ torch.from_numpy(_vggish_mel_matrix()).to(x.device)
    return torch.log(mel + 0.01).reshape(*lead, m, 64)


def segment_starts(num_samples: int, segment_samples: int, num_segments: int,
                   margin: float = 0.1, sample_rate: int = 16000) -> np.ndarray:
    """Per-segment start indices of the reference's linspace slicing:
    linspace(0, len - sr * (segment + margin), num=num_segments)
    (AVE/dataloader.py:231-233)."""
    hi = num_samples - (segment_samples + int(margin * sample_rate))
    hi = max(hi, 0)
    return np.linspace(0, hi, num=num_segments).astype(np.int64)
