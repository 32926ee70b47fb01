"""The input pipelines in plain float32: raw waves and uint8 frames to the
model's (a, v).

- The audio: Kaldi's log-mel filterbank (25 ms frames, DC removed,
  pre-emphasis 0.97, a symmetric Hann window, zero-padded to a power of two,
  power spectrum, triangular mel banks from 20 Hz to Nyquist, log floored
  at float32's eps), normalized as (x - mean) / (2 std) and padded or cut
  to the target frames (kaiw7/STG-CMA `AVE/dataloader.py`).
- The frames at evaluation and for AVQA: /255, ImageNet normalization.
- AVE training (`AVE/dataloader.py`): timm's RandAugment
  rand-m7-n4-mstd0.5-inc1 on the frames in [0, 255], /255, normalize,
  RandomResizedCrop (scale 0.08-1, ratio 3/4-4/3, bilinear), a horizontal
  flip with p 1/2, RandomErasing (p 1/4, 'pixel' noise), the same draws
  for every frame of a clip.

The training draws are made here again from a generator seeded as the
program's, in the program's order: clip by clip, the RandAugment ops, their
magnitudes and signs, the crop box, the flip, the erasing box and the seed
of its noise.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

MEAN = (0.485, 0.456, 0.406)
STD = (0.229, 0.224, 0.225)


# ---------------------------------------------------------------------------
# audio
# ---------------------------------------------------------------------------

def _hz_to_mel(f):
    return 1127.0 * np.log(1.0 + f / 700.0)


def mel_banks(bins: int, padded: int, sf: float = 16000.0, low: float = 20.0) -> np.ndarray:
    """(padded // 2 + 1, bins) triangular filters; the Nyquist row is zero."""
    n_fft = padded // 2
    lo, hi = _hz_to_mel(low), _hz_to_mel(sf / 2)
    step = (hi - lo) / (bins + 1)
    left = lo + np.arange(bins)[:, None] * step
    f = _hz_to_mel(sf / padded * np.arange(n_fft))[None, :]
    w = np.maximum(0.0, np.minimum((f - left) / step, (left + 2 * step - f) / step))
    return np.concatenate([w, np.zeros((bins, 1))], axis=1).T.astype(np.float32)


def fbank(wave: torch.Tensor, bins: int, shift_ms: float, target: int, mean: float,
          std: float, sf: float = 16000.0) -> torch.Tensor:
    """wave (..., L) -> (..., target, bins)."""
    size, shift = int(sf * 0.025), int(sf * shift_ms * 0.001)
    padded = 1 << (size - 1).bit_length()
    lead, L = wave.shape[:-1], wave.shape[-1]
    m = 1 + (L - size) // shift
    fr = wave.reshape(-1, L).float().unfold(-1, size, shift)[:, :m]
    fr = fr - fr.mean(dim=-1, keepdim=True)
    fr = fr - 0.97 * torch.cat([fr[..., :1], fr[..., :-1]], dim=-1)
    n = torch.arange(size, dtype=torch.float64)
    win = (0.5 - 0.5 * torch.cos(2 * math.pi * n / (size - 1))).float().to(wave.device)
    spec = torch.fft.rfft(F.pad(fr * win, (0, padded - size)), dim=-1).abs().square()
    mel = spec @ torch.from_numpy(mel_banks(bins, padded, sf)).to(wave.device)
    out = torch.log(mel.clamp_min(torch.finfo(torch.float32).eps))
    out = ((out - mean) / (2.0 * std)).reshape(*lead, m, bins)
    if m < target:
        return F.pad(out, (0, 0, 0, target - m))
    return out[..., :target, :]


# ---------------------------------------------------------------------------
# frames
# ---------------------------------------------------------------------------

def normalize(x01: torch.Tensor) -> torch.Tensor:
    mean = torch.tensor(MEAN, device=x01.device)
    std = torch.tensor(STD, device=x01.device)
    return (x01 - mean) / std


def plain_frames(frames_u8: torch.Tensor) -> torch.Tensor:
    """Frames already at the model's size: /255 and normalize."""
    return normalize(frames_u8.float() / 255.0)


def _sample_affine(img, m, fill=128.0):
    """Bilinear sampling through the output-to-input map m (2, 3), pixels
    outside read `fill`, as PIL's affine transform."""
    H, W = img.shape[-3], img.shape[-2]
    gy, gx = torch.meshgrid(torch.arange(H, dtype=torch.float32, device=img.device),
                            torch.arange(W, dtype=torch.float32, device=img.device),
                            indexing="ij")
    sx = m[0][0] * gx + m[0][1] * gy + m[0][2]
    sy = m[1][0] * gx + m[1][1] * gy + m[1][2]
    x0, y0 = torch.floor(sx), torch.floor(sy)
    wx, wy = (sx - x0)[..., None], (sy - y0)[..., None]

    def at(yi, xi):
        ok = (xi >= 0) & (xi < W) & (yi >= 0) & (yi < H)
        v = img[..., yi.clamp(0, H - 1).long(), xi.clamp(0, W - 1).long(), :]
        return torch.where(ok[..., None], v, fill)

    top = at(y0, x0) + (at(y0, x0 + 1) - at(y0, x0)) * wx
    bot = at(y0 + 1, x0) + (at(y0 + 1, x0 + 1) - at(y0 + 1, x0)) * wx
    out = top + (bot - top) * wy
    inside = (sx >= -1) & (sx <= W) & (sy >= -1) & (sy <= H)
    return torch.where(inside[..., None], out, fill)


def _about_center(img, a, b, c, d):
    H, W = img.shape[-3], img.shape[-2]
    cx, cy = W / 2.0, H / 2.0
    f = [torch.as_tensor(t, dtype=torch.float32, device=img.device) for t in (a, b, c, d)]
    return _sample_affine(img, [[f[0], f[1], cx - f[0] * cx - f[1] * cy],
                                [f[2], f[3], cy - f[2] * cx - f[3] * cy]])


def _gray(img):
    return (img[..., 0] * 0.299 + img[..., 1] * 0.587 + img[..., 2] * 0.114)[..., None]


def _blend(img, other, m):
    return torch.clamp(other + (img - other) * (1.0 + 0.9 * m / 10.0), 0.0, 255.0)


def _equalize(img):
    H, W, C = img.shape[-3:]
    c = img.reshape(-1, H * W, C).transpose(1, 2)
    ci = c.clamp(0, 255).long()
    hist = torch.zeros(ci.shape[:2] + (256,), dtype=torch.long, device=img.device)
    hist.scatter_add_(-1, ci, torch.ones_like(ci))
    last = torch.where(hist > 0, torch.arange(256, device=img.device), 0).amax(-1, keepdim=True)
    step = (H * W - torch.gather(hist, -1, last)) // 255
    lut = ((torch.cumsum(hist, -1) - hist + step // 2) // step.clamp_min(1)).clamp(0, 255)
    out = torch.where(step > 0, torch.gather(lut, -1, ci).float(), c)
    return out.transpose(1, 2).reshape(img.shape)


def _rotate(img, m):
    r = torch.as_tensor(30.0 * m / 10.0 * math.pi / 180.0)
    return _about_center(img, torch.cos(r), torch.sin(r), -torch.sin(r), torch.cos(r))


def _posterize(img, m):
    shift = 8 - torch.clamp(4 - (4 * m / 10.0).to(torch.int32), 0, 8)
    return ((img.clamp(0, 255).to(torch.int32) >> shift) << shift).float()


def _contrast(img, m):
    return _blend(img, _gray(img).mean(dim=(-3, -2), keepdim=True).expand(img.shape), m)


def _sharpness(img, m):
    H, W, C = img.shape[-3:]
    k = torch.tensor([[1., 1., 1.], [1., 5., 1.], [1., 1., 1.]], device=img.device) / 13.0
    planes = img.reshape(-1, H, W, C).permute(0, 3, 1, 2).reshape(-1, 1, H, W)
    sm = F.conv2d(planes, k[None, None], padding=1).reshape(-1, C, H, W).permute(0, 2, 3, 1)
    return _blend(img, sm.reshape(img.shape), m)


def _translate(img, tx, ty):
    one, zero = torch.tensor(1.0), torch.tensor(0.0)
    return _sample_affine(img, [[one, zero, torch.as_tensor(tx, dtype=torch.float32)],
                                [zero, one, torch.as_tensor(ty, dtype=torch.float32)]])


def _autocontrast(img, m):
    lo = img.amin(dim=(-3, -2), keepdim=True)
    hi = img.amax(dim=(-3, -2), keepdim=True)
    out = ((img - lo) * (255.0 / (hi - lo).clamp_min(1e-5))).clamp(0, 255)
    return torch.where(hi > lo, out, img)


# timm's RandAugment list with the 'Increasing' variants, in its order;
# each op takes the frames in [0, 255] and the signed magnitude m
RAND_AUGMENT = (
    (_autocontrast, False),
    (lambda x, m: _equalize(x), False),
    (lambda x, m: 255.0 - x, False),
    (_rotate, True),
    (_posterize, False),
    (lambda x, m: torch.where(x < 256.0 - 256.0 * m / 10.0, x, 255.0 - x), False),
    (lambda x, m: torch.where(x < 128.0, (x + 110.0 * m / 10.0).clamp(0, 255), x), False),
    (lambda x, m: _blend(x, _gray(x).expand(x.shape), m), True),
    (_contrast, True),
    (lambda x, m: _blend(x, torch.zeros_like(x), m), True),
    (_sharpness, True),
    (lambda x, m: _about_center(x, 1.0, 0.3 * m / 10.0, 0.0, 1.0), True),
    (lambda x, m: _about_center(x, 1.0, 0.0, 0.3 * m / 10.0, 1.0), True),
    (lambda x, m: _translate(x, 0.45 * m / 10.0 * x.shape[-2], 0.0), True),
    (lambda x, m: _translate(x, 0.0, 0.45 * m / 10.0 * x.shape[-3]), True),
)


def _u(g, lo, hi):
    return torch.rand((), generator=g) * (hi - lo) + lo


def _box(g, H, W, area, ratio, lo, hi_h, hi_w, swap):
    target = H * W * _u(g, *area)
    ar = torch.exp(_u(g, math.log(ratio[0]), math.log(ratio[1])))
    a = int(torch.clamp(torch.sqrt(target * ar), lo, hi_w if not swap else hi_h).to(torch.int32))
    b = int(torch.clamp(torch.sqrt(target / ar), lo, hi_h if not swap else hi_w).to(torch.int32))
    return a, b


def ave_train_clip(clip_u8: torch.Tensor, g: torch.Generator, size: int) -> torch.Tensor:
    """One clip (T, H, W, 3) uint8 -> (T, size, size, 3), drawing from g."""
    dev = clip_u8.device
    T, H, W, C = clip_u8.shape
    ops = torch.randint(0, len(RAND_AUGMENT), (4,), generator=g)
    mags = torch.clamp(7.0 + 0.5 * torch.randn(4, generator=g), 0.0, 10.0)
    signs = torch.where(torch.rand(4, generator=g) < 0.5, 1.0, -1.0)
    w, h = _box(g, H, W, (0.08, 1.0), (3 / 4, 4 / 3), 8.0, H, W, False)
    top, left = int(torch.randint(0, max(H - h, 1), (), generator=g)), \
        int(torch.randint(0, max(W - w, 1), (), generator=g))
    flip = bool(torch.rand((), generator=g) < 0.5)
    erase = bool(torch.rand((), generator=g) < 0.25)
    eh, ew = _box(g, size, size, (0.02, 1 / 3), (0.3, 3.3), 1, size - 1, size - 1, True)
    etop = int(torch.randint(0, max(size - eh, 1), (), generator=g))
    eleft = int(torch.randint(0, max(size - ew, 1), (), generator=g))
    seed = int(torch.randint(0, 2 ** 62, (), generator=g))

    x = clip_u8.float()
    for i, m, s in zip(ops.tolist(), mags, signs):
        op, signed = RAND_AUGMENT[i]
        x = op(x, (m * (s if signed else 1.0)).to(dev))
    x = normalize(x / 255.0)
    # the crop box resized to (size, size), bilinear, half-pixel centers
    r = torch.arange(size, dtype=torch.float32, device=dev) + 0.5
    fy, fx = top + r * h / size - 0.5, left + r * w / size - 0.5
    y0, x0 = fy.floor().clamp(0, H - 1).long(), fx.floor().clamp(0, W - 1).long()
    y1, x1 = (y0 + 1).clamp(0, H - 1), (x0 + 1).clamp(0, W - 1)
    wy, wx = (fy - y0).clamp(0, 1)[:, None, None], (fx - x0).clamp(0, 1)[:, None]
    r0, r1 = x.index_select(-3, y0), x.index_select(-3, y1)
    t_ = r0.index_select(-2, x0) + (r0.index_select(-2, x1) - r0.index_select(-2, x0)) * wx
    b_ = r1.index_select(-2, x0) + (r1.index_select(-2, x1) - r1.index_select(-2, x0)) * wx
    x = t_ + (b_ - t_) * wy
    if flip:
        x = torch.flip(x, dims=(-2,))
    if erase:
        noise = torch.randn((T, size, size, C), device=dev,
                            generator=torch.Generator(device=dev).manual_seed(seed))
        x = x.clone()
        x[..., etop:etop + eh, eleft:eleft + ew, :] = noise[..., etop:etop + eh,
                                                            eleft:eleft + ew, :]
    return x
