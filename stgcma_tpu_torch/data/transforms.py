"""The clip transforms, batched tensor math over packed (..., T, H, W, C)
clips on their own device.

Port of `stgcma_tpu/data/transforms.py`. The evaluation half:
`resize_short_side` (:32), `center_crop` (:43), `normalize` (:49),
`eval_transform` (:53), `avqa_transform` (:60) and `avs_transform` (:72).
The protocols:
- AVE (AVE/dataloader.py:159-164): short-side bilinear resize -> center crop
  -> /255 -> ImageNet normalize;
- AVQA (AVQA/dataloader.py:86-90): a direct (size, size) bicubic resize ->
  ImageNet normalize, train and eval alike;
- AVS (AVS/dataloader.py:65-72): /255 -> ImageNet normalize (frames come
  pre-sized).
The training half (:83-365), AVE train (AVE/dataloader.py:346-394):
RandAugment(rand-m7-n4-mstd0.5-inc1) -> normalize -> random resized crop
(scale [.08, 1], ratio [3/4, 4/3]) -> hflip(0.5) -> RandomErasing(0.25,
'pixel'), the same draws for every frame of a clip, and the waveform mixup.

Each random function is split in two: a sampler (`sample_*`: a
torch.Generator -> its draws, op indices, magnitudes and signs, the crop
box, the flip, the erase box and noise, the mixup lambdas and partners) and
an apply (`*_apply`, or the op itself) that takes the draws, so that a
caller can give the apply draws made elsewhere. `rand_augment`,
`random_resized_crop`, `random_hflip`, `random_erasing`, `mixup_batch` and
`train_transform` sample and apply, with a generator where JAX takes a key.
The frames' arithmetic is float32 in the JAX functions' order of operations
(the affine taps, the crop's fractional coordinates, the integer casts of
the boxes, the posterize and equalize integer math), so that an apply given
JAX's draws reproduces JAX's output. The draws themselves cannot be JAX's:
`torch.Generator` is not `jax.random`.
"""
from __future__ import annotations

import math
from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.resize import resize_bicubic, resize_bilinear_taps

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)


def resize_short_side(clip: torch.Tensor, size: int) -> torch.Tensor:
    """Bilinear resize (fp32) so that the short side is `size`. clip: (..., H, W, C)."""
    H, W = clip.shape[-3], clip.shape[-2]
    if H <= W:
        nh, nw = size, max(int(round(W * size / H)), size)
    else:
        nh, nw = max(int(round(H * size / W)), size), size
    return resize_bilinear_taps(clip.float(), nh, nw, align_corners=False)


def center_crop(clip: torch.Tensor, size: int) -> torch.Tensor:
    H, W = clip.shape[-3], clip.shape[-2]
    top, left = (H - size) // 2, (W - size) // 2
    return clip[..., top:top + size, left:left + size, :]


def normalize(clip01: torch.Tensor, mean=IMAGENET_MEAN, std=IMAGENET_STD) -> torch.Tensor:
    dev = clip01.device
    return (clip01 - torch.from_numpy(mean).to(dev)) / torch.from_numpy(std).to(dev)


def eval_transform(clip_uint8: torch.Tensor, size: int = 224) -> torch.Tensor:
    """(..., T, H, W, 3) uint8 -> (..., T, size, size, 3) normalized fp32."""
    x = center_crop(resize_short_side(clip_uint8, size), size)
    return normalize(x / 255.0)


def avqa_transform(clip_uint8: torch.Tensor, size: int = 224) -> torch.Tensor:
    """AVQA, train and eval: a direct (size, size) bicubic resize (aspect
    distorting, torch's interpolate) of /255 frames, then ImageNet normalize."""
    x = clip_uint8.float() / 255.0
    if x.shape[-3] != size or x.shape[-2] != size:
        x = resize_bicubic(x, size, size)
    return normalize(x)


def avs_transform(clip_uint8: torch.Tensor) -> torch.Tensor:
    """AVS, train and eval: ToTensor + ImageNet normalize only."""
    return normalize(clip_uint8.float() / 255.0)


# ---------------------------------------------------------------------------
# affine sampling core (PIL-style inverse mapping, bilinear, gray fill)
# ---------------------------------------------------------------------------

def _f32(v, device) -> torch.Tensor:
    return torch.as_tensor(v, dtype=torch.float32, device=device)


def _affine_sample(img: torch.Tensor, inv_mat: torch.Tensor, fill: float = 128.0):
    """img: (..., H, W, C) f32; inv_mat: (2, 3) output -> input map (PIL
    convention), the same for every leading index (`_affine_sample` :83)."""
    H, W = img.shape[-3], img.shape[-2]
    dev = img.device
    gy, gx = torch.meshgrid(torch.arange(H, dtype=torch.float32, device=dev),
                            torch.arange(W, dtype=torch.float32, device=dev), indexing="ij")
    m = inv_mat.to(dev)
    sx = m[0, 0] * gx + m[0, 1] * gy + m[0, 2]
    sy = m[1, 0] * gx + m[1, 1] * gy + m[1, 2]
    x0, y0 = torch.floor(sx), torch.floor(sy)
    wx, wy = (sx - x0)[..., None], (sy - y0)[..., None]
    valid = (sx >= -1) & (sx <= W) & (sy >= -1) & (sy <= H)

    def gather(yi, xi):
        ok = (xi >= 0) & (xi < W) & (yi >= 0) & (yi < H)
        vals = img[..., torch.clamp(yi, 0, H - 1).long(), torch.clamp(xi, 0, W - 1).long(), :]
        return torch.where(ok[..., None], vals, fill)

    v00, v01 = gather(y0, x0), gather(y0, x0 + 1)
    v10, v11 = gather(y0 + 1, x0), gather(y0 + 1, x0 + 1)
    top = v00 + (v01 - v00) * wx
    bot = v10 + (v11 - v10) * wx
    out = top + (bot - top) * wy
    return torch.where(valid[..., None], out, fill)


def _center_affine(img, a, b, c, d):
    """Affine [[a, b], [c, d]] about the image center (PIL rotate / shear)."""
    H, W = img.shape[-3], img.shape[-2]
    cx, cy = W / 2.0, H / 2.0
    tx = cx - a * cx - b * cy
    ty = cy - c * cx - d * cy
    mat = torch.stack([_f32(v, img.device) for v in (a, b, tx, c, d, ty)]).view(2, 3)
    return _affine_sample(img, mat)


# ---------------------------------------------------------------------------
# RandAugment ops on (..., H, W, C) float32 in [0, 255]; m a float32 scalar
# ---------------------------------------------------------------------------

def _blend(img1, img2, factor):
    return torch.clamp(img2 + (img1 - img2) * factor, 0.0, 255.0)


def _grayscale(img):
    lum = img[..., 0] * 0.299 + img[..., 1] * 0.587 + img[..., 2] * 0.114
    return lum[..., None].expand(img.shape)


def op_identity(img, m):  # noqa: ARG001
    return img


def op_autocontrast(img, m):  # noqa: ARG001
    lo = img.amin(dim=(-3, -2), keepdim=True)
    hi = img.amax(dim=(-3, -2), keepdim=True)
    scale = 255.0 / torch.clamp_min(hi - lo, 1e-5)
    out = (img - lo) * scale
    return torch.where(hi > lo, torch.clamp(out, 0, 255), img)


def op_equalize(img, m):  # noqa: ARG001
    """PIL's equalize per frame and channel on the integer histogram:
    step = (count - last nonzero bin's count) // 255."""
    shape = img.shape
    H, W, C = shape[-3:]
    c = img.reshape(-1, H * W, C).transpose(1, 2)                  # (F, C, HW)
    ci = torch.clamp(c, 0, 255).to(torch.int64)
    hist = torch.zeros(ci.shape[:2] + (256,), dtype=torch.int64, device=img.device)
    hist.scatter_add_(-1, ci, torch.ones_like(ci))
    bins = torch.arange(256, device=img.device)
    last = torch.where(hist > 0, bins, 0).amax(dim=-1, keepdim=True)
    step = (H * W - torch.gather(hist, -1, last)) // 255
    lut = (torch.cumsum(hist, -1) - hist + step // 2) // torch.clamp_min(step, 1)
    lut = torch.clamp(lut, 0, 255)
    out = torch.where(step > 0, torch.gather(lut, -1, ci).to(img.dtype), c)
    return out.transpose(1, 2).reshape(shape)


def op_invert(img, m):  # noqa: ARG001
    return 255.0 - img


def op_rotate(img, m):
    rad = 30.0 * m / 10.0 * math.pi / 180.0
    return _center_affine(img, torch.cos(rad), torch.sin(rad), -torch.sin(rad), torch.cos(rad))


def op_posterize(img, m):
    """PosterizeIncreasing: bits 4 - int(4 m / 10) on the integer pixels."""
    bits = torch.clamp(4 - (4 * m / 10.0).to(torch.int32), 0, 8)
    shift = (8 - bits).to(torch.int32)
    q = (torch.clamp(img, 0, 255).to(torch.int32) >> shift) << shift
    return q.to(img.dtype)


def op_solarize(img, m):
    thresh = 256.0 - 256.0 * m / 10.0          # SolarizeIncreasing
    return torch.where(img < thresh, img, 255.0 - img)


def op_solarize_add(img, m):
    add = 110.0 * m / 10.0
    return torch.where(img < 128.0, torch.clamp(img + add, 0, 255), img)


def _enhance_factor(m):
    # 'Increasing' enhance: 1 + 0.9 m / 10, m signed by the sampler
    return 1.0 + 0.9 * m / 10.0


def op_color(img, m):
    return _blend(img, _grayscale(img), _enhance_factor(m))


def op_contrast(img, m):
    mean = _grayscale(img)[..., :1].mean(dim=(-3, -2), keepdim=True)
    return _blend(img, mean.expand(img.shape), _enhance_factor(m))


def op_brightness(img, m):
    return _blend(img, torch.zeros_like(img), _enhance_factor(m))


def op_sharpness(img, m):
    """Blend with the 3x3 smoothing filter [[1,1,1],[1,5,1],[1,1,1]] / 13
    over zero-padded ('SAME') channels, as the JAX op convolves."""
    shape = img.shape
    H, W, C = shape[-3:]
    k = torch.tensor([[1, 1, 1], [1, 5, 1], [1, 1, 1]], dtype=torch.float32,
                     device=img.device) / 13.0
    planes = img.reshape(-1, H, W, C).permute(0, 3, 1, 2).reshape(-1, 1, H, W)
    sm = F.conv2d(planes, k[None, None], padding=1)
    sm = sm.reshape(-1, C, H, W).permute(0, 2, 3, 1).reshape(shape)
    return _blend(img, sm, _enhance_factor(m))


def op_shear_x(img, m):
    return _center_affine(img, 1.0, 0.3 * m / 10.0, 0.0, 1.0)


def op_shear_y(img, m):
    return _center_affine(img, 1.0, 0.0, 0.3 * m / 10.0, 1.0)


def _translate(img, tx, ty):
    return _affine_sample(img, torch.stack([_f32(v, img.device)
                                            for v in (1.0, 0.0, tx, 0.0, 1.0, ty)]).view(2, 3))


def op_translate_x(img, m):
    return _translate(img, 0.45 * m / 10.0 * img.shape[-2], 0.0)


def op_translate_y(img, m):
    return _translate(img, 0.0, 0.45 * m / 10.0 * img.shape[-3])


RA_OPS = (op_autocontrast, op_equalize, op_invert, op_rotate, op_posterize,
          op_solarize, op_solarize_add, op_color, op_contrast, op_brightness,
          op_sharpness, op_shear_x, op_shear_y, op_translate_x, op_translate_y)
# ops whose magnitude can be negated (bidirectional)
_SIGNED = (0, 0, 0, 1, 0, 0, 0, 1, 1, 1, 1, 1, 1, 1, 1)


def sample_rand_augment(g: torch.Generator, num_layers: int = 4, magnitude: float = 7.0,
                        mag_std: float = 0.5) -> Dict[str, torch.Tensor]:
    """RandAugment's draws (`rand_augment` :254-258): op indices in [0, 15),
    magnitudes clip(magnitude + mag_std N(0, 1), 0, 10), signs +-1."""
    op_idx = torch.randint(0, len(RA_OPS), (num_layers,), generator=g)
    mags = torch.clamp(magnitude + mag_std * torch.randn(num_layers, generator=g), 0.0, 10.0)
    signs = torch.where(torch.rand(num_layers, generator=g) < 0.5, 1.0, -1.0)
    return {"op_idx": op_idx, "mags": mags, "signs": signs}


def rand_augment_apply(clip: torch.Tensor, draws) -> torch.Tensor:
    """The ops of `draws` in turn on every frame of clip (..., T, H, W, C)
    float32 [0, 255] (`rand_augment` :260-265)."""
    for idx, mag, sign in zip(draws["op_idx"].tolist(), draws["mags"], draws["signs"]):
        m = (mag * (sign if _SIGNED[idx] else 1.0)).to(clip.device)
        clip = RA_OPS[idx](clip, m)
    return clip


def rand_augment(g: torch.Generator, clip: torch.Tensor, num_layers: int = 4,
                 magnitude: float = 7.0, mag_std: float = 0.5) -> torch.Tensor:
    """timm 'rand-m7-n4-mstd0.5-inc1' over a whole clip, the same ops for
    every frame (`rand_augment` :245)."""
    return rand_augment_apply(clip, sample_rand_augment(g, num_layers, magnitude, mag_std))


# ---------------------------------------------------------------------------
# spatial sampling + erasing (train)
# ---------------------------------------------------------------------------

def _uniform(g, lo, hi):
    return torch.rand((), generator=g) * (hi - lo) + lo


def _randint(g, hi):
    return int(torch.randint(0, hi, (), generator=g))


def sample_resized_crop(g: torch.Generator, H: int, W: int, scale=(0.08, 1.0),
                        ratio=(3. / 4., 4. / 3.)) -> Dict[str, int]:
    """The crop box of torchvision-style RandomResizedCrop
    (`random_resized_crop` :276-287): area and log-ratio drawn in fp32, h and
    w clipped to [8, H] / [8, W] and truncated, top and left uniform."""
    target_area = H * W * _uniform(g, scale[0], scale[1])
    ar = torch.exp(_uniform(g, math.log(ratio[0]), math.log(ratio[1])))
    w = int(torch.clamp(torch.sqrt(target_area * ar), 8.0, W).to(torch.int32))
    h = int(torch.clamp(torch.sqrt(target_area / ar), 8.0, H).to(torch.int32))
    return {"top": _randint(g, max(H - h, 1)), "left": _randint(g, max(W - w, 1)),
            "h": h, "w": w}


def resized_crop_apply(clip: torch.Tensor, box: Dict[str, int], size: int = 224) -> torch.Tensor:
    """Crop `box` of clip (..., H, W, C) and resize it to (size, size) in one
    bilinear gather (`random_resized_crop` :288-304)."""
    H, W = clip.shape[-3], clip.shape[-2]
    ar = torch.arange(size, dtype=torch.float32, device=clip.device) + 0.5
    fy = box["top"] + ar * box["h"] / size - 0.5
    fx = box["left"] + ar * box["w"] / size - 0.5
    y0 = torch.clamp(torch.floor(fy), 0, H - 1).long()
    x0 = torch.clamp(torch.floor(fx), 0, W - 1).long()
    y1, x1 = torch.clamp(y0 + 1, 0, H - 1), torch.clamp(x0 + 1, 0, W - 1)
    wy = torch.clamp(fy - y0, 0.0, 1.0)[:, None, None]
    wx = torch.clamp(fx - x0, 0.0, 1.0)[:, None]
    rows0, rows1 = clip.index_select(-3, y0), clip.index_select(-3, y1)
    r0, r1 = rows0.index_select(-2, x0), rows0.index_select(-2, x1)
    r2, r3 = rows1.index_select(-2, x0), rows1.index_select(-2, x1)
    top_i = r0 + (r1 - r0) * wx
    bot_i = r2 + (r3 - r2) * wx
    return top_i + (bot_i - top_i) * wy


def random_resized_crop(g: torch.Generator, clip: torch.Tensor, size: int = 224,
                        scale=(0.08, 1.0), ratio=(3. / 4., 4. / 3.)) -> torch.Tensor:
    """RandomResizedCrop of the whole clip, the same box for every frame."""
    box = sample_resized_crop(g, clip.shape[-3], clip.shape[-2], scale, ratio)
    return resized_crop_apply(clip, box, size)


def sample_hflip(g: torch.Generator, p: float = 0.5) -> bool:
    return bool(torch.rand((), generator=g) < p)


def hflip_apply(clip: torch.Tensor, flip: bool) -> torch.Tensor:
    return torch.flip(clip, dims=(-2,)) if flip else clip


def random_hflip(g: torch.Generator, clip: torch.Tensor, p: float = 0.5) -> torch.Tensor:
    return hflip_apply(clip, sample_hflip(g, p))


def sample_erasing(g: torch.Generator, shape, device, p: float = 0.25,
                   scale=(0.02, 1. / 3.), ratio=(0.3, 3.3)) -> Dict[str, object]:
    """timm RandomErasing's draws for a clip of `shape` (..., H, W, C)
    (`random_erasing` :317-331): whether to erase, the box (h and w clipped
    to [1, H - 1] / [1, W - 1] and truncated) and, only where it erases, the
    per-pixel N(0, 1) noise of the clip's shape, drawn on `device` from a
    seed drawn from `g`."""
    H, W = shape[-3], shape[-2]
    do = bool(torch.rand((), generator=g) < p)
    target = H * W * _uniform(g, scale[0], scale[1])
    ar = torch.exp(_uniform(g, math.log(ratio[0]), math.log(ratio[1])))
    h = int(torch.clamp(torch.sqrt(target * ar), 1, H - 1).to(torch.int32))
    w = int(torch.clamp(torch.sqrt(target / ar), 1, W - 1).to(torch.int32))
    top, left = _randint(g, max(H - h, 1)), _randint(g, max(W - w, 1))
    seed = int(torch.randint(0, 2 ** 62, (), generator=g))
    noise = None
    if do:
        noise = torch.randn(tuple(shape), device=device,
                            generator=torch.Generator(device=device).manual_seed(seed))
    return {"do": do, "top": top, "left": left, "h": h, "w": w, "noise": noise}


def erasing_apply(clip: torch.Tensor, draws) -> torch.Tensor:
    """The box of `draws` replaced by its noise, in every frame ('cube')."""
    if not draws["do"]:
        return clip
    t, l, h, w = draws["top"], draws["left"], draws["h"], draws["w"]
    out = clip.clone()
    out[..., t:t + h, l:l + w, :] = draws["noise"][..., t:t + h, l:l + w, :].to(clip)
    return out


def random_erasing(g: torch.Generator, clip: torch.Tensor, p: float = 0.25,
                   scale=(0.02, 1. / 3.), ratio=(0.3, 3.3)) -> torch.Tensor:
    """timm RandomErasing mode='pixel', the same box for all frames
    (transforms/random_erasing.py:35-174)."""
    return erasing_apply(clip, sample_erasing(g, clip.shape, clip.device, p, scale, ratio))


def sample_mixup(g: torch.Generator, B: int, T: int, mixup_prob: float = 0.5,
                 alpha: float = 10.0) -> Dict[str, torch.Tensor]:
    """The mixup's draws (`mixup_batch` :358-362): Beta(alpha, alpha)
    lambdas (B, T), one a second (numpy's beta from a seed drawn from `g`:
    torch draws no Beta from a generator), whether each sample mixes, and
    each sample's partner."""
    seed = int(torch.randint(0, 2 ** 62, (), generator=g))
    lam = torch.from_numpy(np.random.default_rng(seed).beta(alpha, alpha, (B, T)).astype(
        np.float32))
    do = torch.rand(B, generator=g) < mixup_prob
    partner = torch.randint(0, B, (B,), generator=g)
    return {"lam": lam, "do": do, "partner": partner}


def mixup_apply(waves: torch.Tensor, draws) -> torch.Tensor:
    """waves (B, T, L) centered segments -> l * waves + (1 - l) *
    waves[partner], l = lam where the sample mixes, else 1."""
    dev = waves.device
    lam = torch.where(draws["do"].to(dev)[:, None], draws["lam"].to(dev, waves.dtype), 1.0)
    lam = lam[..., None]
    return lam * waves + (1 - lam) * waves[draws["partner"].to(dev)]


def mixup_batch(g: torch.Generator, waves: torch.Tensor, mixup_prob: float = 0.5,
                alpha: float = 10.0) -> torch.Tensor:
    """Reference AVE mixup (AVE/dataloader.py:204-230 + 491-497): with
    probability `mixup_prob` a sample's centered waveform is mixed with a
    random partner's, with a fresh Beta(10, 10) lambda a second; frames and
    labels are not mixed. Mixing the centered segments on the device is
    exact (`mixup_batch` :342-356)."""
    return mixup_apply(waves, sample_mixup(g, waves.shape[0], waves.shape[1], mixup_prob, alpha))


def sample_train_transform(g: torch.Generator, shape, size: int = 224, device="cpu",
                           magnitude: float = 7.0, num_layers: int = 4) -> Dict[str, object]:
    """Every draw of `train_transform` for one clip of `shape` (T, H, W, 3)."""
    H, W = shape[-3], shape[-2]
    return {"ra": sample_rand_augment(g, num_layers, magnitude),
            "crop": sample_resized_crop(g, H, W),
            "flip": sample_hflip(g),
            "erase": sample_erasing(g, tuple(shape[:-3]) + (size, size, shape[-1]), device)}


def train_transform_apply(clip_uint8: torch.Tensor, draws, size: int = 224) -> torch.Tensor:
    """(..., T, H, W, 3) uint8 -> (..., T, size, size, 3) f32 with the given
    draws: RandAugment, /255, normalize, resized crop, flip, erasing
    (`train_transform` :367)."""
    x = rand_augment_apply(clip_uint8.float(), draws["ra"])
    x = normalize(x / 255.0)
    x = resized_crop_apply(x, draws["crop"], size)
    x = hflip_apply(x, draws["flip"])
    return erasing_apply(x, draws["erase"])


def train_transform(g: torch.Generator, clip_uint8: torch.Tensor, size: int = 224,
                    magnitude: float = 7.0, num_layers: int = 4) -> torch.Tensor:
    """The reference train-time pipeline on one packed clip
    (AVE/dataloader.py:346-394): (T, H, W, 3) uint8 -> (T, size, size, 3) f32."""
    draws = sample_train_transform(g, clip_uint8.shape, size, clip_uint8.device, magnitude,
                                   num_layers)
    return train_transform_apply(clip_uint8, draws, size)
