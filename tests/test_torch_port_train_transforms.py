"""The training half of the port's clip transforms (stgcma_tpu_torch/data/
transforms.py) against the JAX package's on the CPU, given JAX's draws.

The port's samplers draw from a torch.Generator, so their draws cannot be
JAX's; each apply is therefore handed the draws JAX made, recomputed here
with `jax.random` from the same keys as the JAX function splits them, and
the whole output is compared. The JAX functions run under
`jax.disable_jit()`, op by op, as tests/test_torch_port_preprocess.py runs
the evaluation transforms.
Tolerances, on frames in [0, 255] (the ops) or normalized (train_transform):
- every RandAugment op and identity: 1e-3 absolute on [0, 255] (2^-8 of a
  grey level; an exact float32 order of operations gives ~1e-5, the
  remaining room covers a cos / sin / exp that differs in its last bit);
- `train_transform` with four RandAugment ops, the crop, the flip and the
  erasing: 1e-4 absolute on the normalized frames (1e-3 / 255 / std);
- `mixup_batch`: 1e-6 relative.
The samplers' own draws are checked for their ranges and their rates, the
train pipeline for its composition (each clip with its own draws, in batch
order, then mixup and the fbank), and the `DataLoader` copy for its order.
"""
import math

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from stgcma_tpu.data import loader as jax_loader
from stgcma_tpu.data import transforms as JT
from stgcma_tpu_torch.data import loader, transforms as T
from stgcma_tpu_torch.data.datasets import SyntheticAVE
from stgcma_tpu_torch.ops.fbank import SWIN_FBANK, fbank_image

OP_TOL, TRAIN_TOL = 1e-3, 1e-4


def _clip(seed, shape=(2, 20, 24, 3), integer=False):
    rng = np.random.RandomState(seed)
    if integer:
        return rng.randint(0, 256, shape).astype(np.float32)
    return (rng.rand(*shape) * 255).astype(np.float32)


def _jax_frames(op, clip, m):
    with jax.disable_jit():
        return np.stack([np.asarray(op(jnp.asarray(f), jnp.float32(m))) for f in clip])


OPS = [f.__name__ for f in T.RA_OPS] + ["op_identity"]
# every op at four magnitudes, and the signed ones also at a negative one
# (the others are never drawn negative)
OP_CASES = [(name, m) for i, name in enumerate(OPS) for m in (0.0, 3.7, 7.0, 10.0, -6.2)
            if m >= 0 or (i < len(T.RA_OPS) and T._SIGNED[i])]


@pytest.mark.parametrize("name,m", OP_CASES)
def test_rand_augment_op_matches_jax(name, m):
    idx = OPS.index(name)
    for integer in (True, False):
        clip = _clip(idx, integer=integer)
        ref = _jax_frames(getattr(JT, name), clip, m)
        got = getattr(T, name)(torch.from_numpy(clip), torch.tensor(m, dtype=torch.float32))
        assert got.shape == clip.shape and got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=OP_TOL, err_msg=name)


def test_equalize_and_posterize_are_integer_exact():
    """The histogram LUT and the bit shifts: bit for bit on integer frames,
    a flat frame left as it is."""
    clip = _clip(40, integer=True)
    clip[1] = 77.0                                           # one flat frame (step 0)
    for name, m in (("op_equalize", 0.0), ("op_posterize", 7.0), ("op_posterize", 2.4)):
        ref = _jax_frames(getattr(JT, name), clip, m)
        got = getattr(T, name)(torch.from_numpy(clip), torch.tensor(m))
        assert np.array_equal(got.numpy(), ref), name
    assert np.array_equal(T.op_equalize(torch.from_numpy(clip), None)[1].numpy(), clip[1])


def _np(a):
    return torch.from_numpy(np.array(a))


def _jax_draws(key, shape, size):
    """The draws `JT.train_transform(key, clip, size)` makes, as the port's
    apply takes them (its splits, in its order)."""
    Tn, H, W, C = shape
    k1, k2, k3, k4 = jax.random.split(key, 4)
    keys = jax.random.split(k1, 3)
    ra = {"op_idx": _np(jax.random.randint(keys[0], (4,), 0, 15)),
          "mags": _np(jnp.clip(7.0 + 0.5 * jax.random.normal(keys[1], (4,)), 0.0, 10.0)),
          "signs": _np(jnp.where(jax.random.bernoulli(keys[2], 0.5, (4,)), 1.0, -1.0))}
    c = jax.random.split(k2, 4)
    target = H * W * jax.random.uniform(c[0], (), minval=0.08, maxval=1.0)
    ar = jnp.exp(jax.random.uniform(c[1], (), minval=math.log(3 / 4), maxval=math.log(4 / 3)))
    w = int(jnp.clip(jnp.sqrt(target * ar), 8.0, W).astype(jnp.int32))
    h = int(jnp.clip(jnp.sqrt(target / ar), 8.0, H).astype(jnp.int32))
    crop = {"top": int(jax.random.randint(c[2], (), 0, max(H - h, 1))),
            "left": int(jax.random.randint(c[3], (), 0, max(W - w, 1))), "h": h, "w": w}
    e = jax.random.split(k4, 6)
    target = size * size * jax.random.uniform(e[1], (), minval=0.02, maxval=1 / 3)
    ar = jnp.exp(jax.random.uniform(e[2], (), minval=math.log(0.3), maxval=math.log(3.3)))
    eh = int(jnp.clip(jnp.sqrt(target * ar), 1, size - 1).astype(jnp.int32))
    ew = int(jnp.clip(jnp.sqrt(target / ar), 1, size - 1).astype(jnp.int32))
    erase = {"do": bool(jax.random.bernoulli(e[0], 0.25)),
             "top": int(jax.random.randint(e[3], (), 0, max(size - eh, 1))),
             "left": int(jax.random.randint(e[4], (), 0, max(size - ew, 1))), "h": eh, "w": ew,
             "noise": _np(jax.random.normal(e[5], (Tn, size, size, C), jnp.float32))}
    return {"ra": ra, "crop": crop, "flip": bool(jax.random.bernoulli(k3, 0.5)), "erase": erase}


@pytest.mark.parametrize("seed", range(8))
def test_train_transform_matches_jax_given_its_draws(seed):
    shape, size = (3, 40, 48, 3), 32
    clip = np.random.RandomState(100 + seed).randint(0, 256, shape).astype(np.uint8)
    key = jax.random.PRNGKey(seed)
    with jax.disable_jit():
        ref = np.asarray(JT.train_transform(key, jnp.asarray(clip), size=size))
    draws = _jax_draws(key, shape, size)
    got = T.train_transform_apply(torch.from_numpy(clip), draws, size)
    assert got.shape == (3, size, size, 3)
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=TRAIN_TOL)


def test_the_draws_cover_crop_flip_and_erasing():
    """The seeds of the test above reach a flip, an erasing and a crop
    smaller than the frame, so each part of the apply is compared."""
    draws = [_jax_draws(jax.random.PRNGKey(s), (3, 40, 48, 3), 32) for s in range(8)]
    assert any(d["flip"] for d in draws) and not all(d["flip"] for d in draws)
    assert any(d["erase"]["do"] for d in draws)
    assert any(d["crop"]["h"] < 40 for d in draws)
    assert len({int(i) for d in draws for i in d["ra"]["op_idx"]}) >= 8


@pytest.mark.parametrize("prob", [0.5, 1.0])
def test_mixup_matches_jax_given_its_draws(prob):
    waves = np.random.RandomState(7).randn(4, 3, 160).astype(np.float32)
    key = jax.random.PRNGKey(3)
    ref = np.asarray(JT.mixup_batch(key, jnp.asarray(waves), mixup_prob=prob))
    k1, k2, k3 = jax.random.split(key, 3)
    draws = {"lam": _np(jax.random.beta(k1, 10.0, 10.0, (4, 3))),
             "do": _np(jax.random.bernoulli(k2, prob, (4,))),
             "partner": _np(jax.random.randint(k3, (4,), 0, 4))}
    got = T.mixup_apply(torch.from_numpy(waves), draws)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-6, atol=1e-7)


def test_samplers_stay_in_range_and_draw_at_their_rates():
    g = torch.Generator().manual_seed(0)
    flips, erases, ops = 0, 0, set()
    for _ in range(400):
        box = T.sample_resized_crop(g, 40, 48)
        assert 8 <= box["h"] <= 40 and 8 <= box["w"] <= 48
        assert 0 <= box["top"] <= max(40 - box["h"], 0)
        assert 0 <= box["left"] <= max(48 - box["w"], 0)
        e = T.sample_erasing(g, (2, 32, 32, 3), "cpu")
        assert 1 <= e["h"] <= 31 and 1 <= e["w"] <= 31
        assert (e["noise"] is None) != e["do"]
        erases += e["do"]
        flips += T.sample_hflip(g)
        ra = T.sample_rand_augment(g)
        assert bool(((ra["mags"] >= 0) & (ra["mags"] <= 10)).all())
        ops.update(ra["op_idx"].tolist())
    assert abs(flips / 400 - 0.5) < 0.1 and abs(erases / 400 - 0.25) < 0.08
    assert ops == set(range(15))
    lam = T.sample_mixup(g, 2000, 1)["lam"]
    assert abs(float(lam.mean()) - 0.5) < 0.01 and abs(float(lam.var()) - 1 / 84) < 2e-3


def test_train_pipeline_composes_per_clip_draws_then_mixup_and_fbank():
    """pipe(batch, g) equals each clip through `train_transform` with draws
    taken from g in batch order, then the mixup's draws, then the fbank."""
    ds = SyntheticAVE(n=2, num_frames=2, size=40, label_dim=5)
    batch = loader.collate([ds[0], ds[1]])
    pipe = loader.make_ave_device_pipeline(SWIN_FBANK, 48, train=True, image_size=32,
                                           mixup=1.0, device="cpu")
    a, v = pipe(batch, torch.Generator().manual_seed(5))
    g = torch.Generator().manual_seed(5)
    frames = torch.from_numpy(batch["frames"])
    draws = [T.sample_train_transform(g, f.shape, 32, "cpu") for f in frames]
    ref_v = torch.stack([T.train_transform_apply(f, d, 32) for f, d in zip(frames, draws)])
    wave = T.mixup_apply(torch.from_numpy(batch["wave"]), T.sample_mixup(g, 2, 2, 1.0))
    ref_a = fbank_image(wave, SWIN_FBANK, 48, -5.081, 4.485)
    assert torch.equal(v, ref_v) and torch.equal(a, ref_a)
    assert v.shape == (2, 2, 32, 32, 3) and a.shape == (2, 2, 48, SWIN_FBANK.num_mel_bins)
    a2, v2 = pipe(batch, torch.Generator().manual_seed(6))
    assert not torch.equal(v, v2)
    no_mix = loader.make_ave_device_pipeline(SWIN_FBANK, 48, train=True, image_size=32,
                                             device="cpu")
    a3, _ = no_mix(batch, torch.Generator().manual_seed(5))
    assert torch.equal(a3, fbank_image(torch.from_numpy(batch["wave"]), SWIN_FBANK, 48,
                                       -5.081, 4.485))


@pytest.mark.parametrize("kw", [dict(shuffle=True), dict(shuffle=False, drop_last=False),
                                dict(sample_weights=np.arange(1, 8, dtype=np.float64))])
def test_data_loader_batches_as_jax_loader(kw):
    """The same items in the same batches as the JAX package's DataLoader,
    epoch after epoch, threads or inline; `set_epoch` rewinds the order."""
    ds = SyntheticAVE(n=7, num_frames=1, size=4, label_dim=3)
    for workers in (0, 2):
        ours = loader.DataLoader(ds, 2, num_workers=workers, **kw)
        ref = jax_loader.DataLoader(ds, 2, num_workers=workers, **kw)
        assert len(ours) == len(ref)
        for _ in range(2):
            got, want = list(ours), list(ref)
            assert len(got) == len(want)
            for b, r in zip(got, want):
                assert all(np.array_equal(b[k], r[k]) for k in r)
        ours.set_epoch(0)
        first = list(ours)
        again = list(jax_loader.DataLoader(ds, 2, num_workers=workers, **kw))
        assert all(np.array_equal(b["wave"], r["wave"]) for b, r in zip(first, again))
