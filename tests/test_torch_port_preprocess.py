"""The port's preprocessing against the JAX package's, on the CPU.

The same seeded numpy waves and uint8 frames go through `stgcma_tpu` and
`stgcma_tpu_torch` in fp32. Tolerances (max absolute difference):
- `fbank` (both presets): 1e-4 in log-mel units on every bin within 10 of
  its frame's largest, 1e-3 on all. Both are fp32: a bin 15 below its
  frame's largest (mel power ~e-7 of the frame's) moves by ~4e-4 when the
  spectrum moves by one fp32 step, in either package (3.8e-4 between them
  at this seed, and JAX 4.5e-4 / the port 0.9e-4 from a float64 kaldi
  oracle); so the port is also held no further from that oracle than
  1.25x the JAX package's distance;
- `fbank_image` (normalized by 2 std) and `vggish_log_mel`: 1e-4;
- the golden pins of `tests/fixtures/fbank_golden_*.npy`: rtol = atol =
  2e-3, as `tests/test_fbank.py::test_fbank_matches_frozen_golden` holds
  the JAX package to them;
- `segment_starts`: exact;
- the resizes: 1e-5 on values in [0, 1] (bicubic and the transforms'
  bilinear at frame sizes, the decoder's F.interpolate bilinear at its
  map sizes, both `align_corners`), `adaptive_avg_pool` 1e-6;
- the transforms and the three evaluation pipelines: 1e-5 on the
  normalized frames, 1e-4 on the fbank images, against the JAX functions
  run eagerly (`jax.disable_jit`). XLA's jit orders the resizes' source
  coordinate arithmetic otherwise: the JAX package's jitted pipeline is
  6.3e-5 from its own eager one on 240x320 frames (the port equals the
  eager one bit for bit there), so against the jitted pipeline the bar on
  the frames is 2e-4.
"""
import jax
import os

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import torch_port_helpers  # noqa: F401  (two torch threads a process)
from stgcma_tpu.data import loader as JL
from stgcma_tpu.data import transforms as JT
from stgcma_tpu.ops import fbank as JF
from stgcma_tpu.ops import resize as JR
from stgcma_tpu_torch.data import loader as PL
from stgcma_tpu_torch.data import transforms as PT
from stgcma_tpu_torch.ops import fbank as PF
from stgcma_tpu_torch.ops import resize as PR

FIX = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures")
PRESETS = {"swin": (JF.SWIN_FBANK, PF.SWIN_FBANK, 224), "clip": (JF.CLIP_FBANK, PF.CLIP_FBANK, 102)}


def _waves(seed, *lead, n=16000):
    rng = np.random.RandomState(seed)
    t = np.arange(n) / 16000.0
    tone = 0.3 * np.sin(2 * np.pi * (220.0 + 40 * rng.rand(*lead, 1)) * t)
    return (tone + 0.05 * rng.randn(*lead, n)).astype(np.float32)


def _clip(seed, *shape):
    return np.random.RandomState(seed).randint(0, 256, shape).astype(np.uint8)


def _maxabs(x, ref):
    return float(np.max(np.abs(np.asarray(x, np.float64) - np.asarray(ref, np.float64))))


@pytest.mark.parametrize("preset", sorted(PRESETS))
def test_fbank_against_jax(preset):
    jcfg, pcfg, _ = PRESETS[preset]
    assert pcfg == PF.FbankConfig(**{f: getattr(jcfg, f) for f in jcfg.__dataclass_fields__})
    wave = _waves(0, 2, 3)
    ref = np.asarray(JF.fbank(jnp.asarray(wave), jcfg))
    got = PF.fbank(torch.from_numpy(wave), pcfg)
    assert tuple(got.shape) == ref.shape == (2, 3, jcfg.num_frames(16000), jcfg.num_mel_bins)
    d = np.abs(got.numpy().astype(np.float64) - ref)
    near_peak = ref >= ref.max(axis=-1, keepdims=True) - 10.0
    assert d.max() <= 1e-3 and d[near_peak].max() <= 1e-4
    from test_fbank import numpy_kaldi_fbank
    oracle = numpy_kaldi_fbank(wave[1, 0].astype(np.float64), jcfg.num_mel_bins,
                               jcfg.frame_shift_ms)
    assert _maxabs(got[1, 0], oracle) <= 1.25 * _maxabs(ref[1, 0], oracle)


@pytest.mark.parametrize("preset", sorted(PRESETS))
def test_fbank_image_against_jax(preset):
    """Swin: 223 frames padded to 224; CLIP: 98 padded to 102; and a trim."""
    jcfg, pcfg, target = PRESETS[preset]
    wave = _waves(1, 2, 10)
    for tl in (target, 64):
        ref = np.asarray(JF.fbank_image(jnp.asarray(wave), jcfg, tl, -5.081, 4.485))
        got = PF.fbank_image(torch.from_numpy(wave), pcfg, tl, -5.081, 4.485)
        assert tuple(got.shape) == ref.shape == (2, 10, tl, jcfg.num_mel_bins)
        assert _maxabs(got, ref) <= 1e-4
    full = PF.fbank_image(torch.from_numpy(wave), pcfg, target, -5.081, 4.485)
    assert float(full[..., jcfg.num_frames(16000):, :].abs().max()) == 0.0


def test_fbank_matches_frozen_golden():
    wave = np.load(os.path.join(FIX, "fbank_golden_wave.npy"))
    for name, cfg in (("swin_224_4p4", PF.SWIN_FBANK), ("clip_128_10", PF.CLIP_FBANK)):
        golden = np.load(os.path.join(FIX, f"fbank_golden_{name}.npy"))
        np.testing.assert_allclose(PF.fbank(torch.from_numpy(wave), cfg).numpy(), golden,
                                   rtol=2e-3, atol=2e-3)


def test_mel_banks_are_the_jax_packages():
    for cfg in (PF.SWIN_FBANK, PF.CLIP_FBANK):
        args = (cfg.num_mel_bins, cfg.padded_window_size, cfg.sample_frequency, cfg.low_freq,
                cfg.high_freq)
        np.testing.assert_array_equal(PF._mel_banks_cached(*args), JF._mel_banks_cached(*args))
        np.testing.assert_array_equal(PF._feature_window(cfg), JF._feature_window(cfg))
    np.testing.assert_array_equal(PF._vggish_mel_matrix(), JF._vggish_mel_matrix())


def test_vggish_log_mel_against_jax():
    wave = _waves(2, 3, n=15360)
    ref = np.asarray(JF.vggish_log_mel(jnp.asarray(wave)))
    got = PF.vggish_log_mel(torch.from_numpy(wave))
    assert tuple(got.shape) == ref.shape == (3, 94, 64)
    assert _maxabs(got, ref) <= 1e-4


@pytest.mark.parametrize("L,seg,n", [(160700, 16000, 10), (16000, 16000, 10), (80000, 16000, 5),
                                     (3, 16000, 2), (441000, 22050, 10)])
def test_segment_starts_exact(L, seg, n):
    np.testing.assert_array_equal(PF.segment_starts(L, seg, n), JF.segment_starts(L, seg, n))


RESIZE_SHAPES = [((360, 640), (224, 224)), ((180, 320), (224, 224)), ((224, 224), (224, 224)),
                 ((251, 187), (224, 224)), ((17, 23), (40, 40))]


@pytest.mark.parametrize("align_corners", [False, True])
@pytest.mark.parametrize("in_hw,out_hw", RESIZE_SHAPES)
def test_resize_bicubic_against_jax(in_hw, out_hw, align_corners):
    """The shapes of tests/test_task_preprocess.py, with and without align_corners."""
    x = np.random.RandomState(3).rand(2, *in_hw, 3).astype(np.float32)
    ref = np.asarray(JR.resize_bicubic(jnp.asarray(x), *out_hw, align_corners=align_corners))
    got = PR.resize_bicubic(torch.from_numpy(x), *out_hw, align_corners=align_corners)
    assert tuple(got.shape) == ref.shape
    assert _maxabs(got, ref) <= 1e-5


@pytest.mark.parametrize("align_corners", [False, True])
@pytest.mark.parametrize("in_hw,out_hw", RESIZE_SHAPES)
def test_resize_bilinear_taps_against_jax(in_hw, out_hw, align_corners):
    """The frame transforms' bilinear resize, on the JAX package's arithmetic."""
    x = np.random.RandomState(3).rand(2, *in_hw, 3).astype(np.float32)
    ref = np.asarray(JR.resize_bilinear(jnp.asarray(x), *out_hw, align_corners=align_corners))
    got = PR.resize_bilinear_taps(torch.from_numpy(x), *out_hw, align_corners=align_corners)
    assert tuple(got.shape) == ref.shape
    assert _maxabs(got, ref) <= 1e-5


@pytest.mark.parametrize("align_corners", [False, True])
def test_interpolate_scale2_bilinear_against_jax(align_corners):
    x = np.random.RandomState(4).rand(2, 3, 7, 9, 5).astype(np.float32)
    ref = np.asarray(JR.interpolate_scale2_bilinear(jnp.asarray(x), align_corners))
    got = PR.interpolate_scale2_bilinear(torch.from_numpy(x), align_corners)
    assert tuple(got.shape) == ref.shape == (2, 3, 14, 18, 5)
    assert _maxabs(got, ref) <= 1e-5


def test_adaptive_avg_pool_against_jax():
    x = np.random.RandomState(5).randn(2, 14, 21, 6).astype(np.float32)
    for oh, ow in ((7, 7), (1, 1), (14, 3)):
        ref = np.asarray(JR.adaptive_avg_pool(jnp.asarray(x), oh, ow))
        got = PR.adaptive_avg_pool(torch.from_numpy(x), oh, ow)
        assert tuple(got.shape) == ref.shape
        assert _maxabs(got, ref) <= 1e-6


@pytest.mark.parametrize("hw", [(360, 640), (256, 256), (480, 270)])
def test_transforms_against_jax(hw):
    clip = _clip(6, 3, *hw, 3)
    pairs = [(JT.eval_transform(jnp.asarray(clip), 224), PT.eval_transform(torch.from_numpy(clip))),
             (JT.avqa_transform(jnp.asarray(clip), 224), PT.avqa_transform(torch.from_numpy(clip))),
             (JT.avs_transform(jnp.asarray(clip)), PT.avs_transform(torch.from_numpy(clip)))]
    for ref, got in pairs:
        assert tuple(got.shape) == np.asarray(ref).shape and got.dtype == torch.float32
        assert _maxabs(got, ref) <= 1e-5


PIPELINES = {
    "ave_swin": (lambda: JL.make_ave_device_pipeline(image_size=224),
                 lambda: PL.make_ave_device_pipeline(image_size=224, device="cpu"), (256, 256)),
    "ave_clip": (lambda: JL.make_ave_device_pipeline(JF.CLIP_FBANK, 102, image_size=224),
                 lambda: PL.make_ave_device_pipeline(PF.CLIP_FBANK, 102, image_size=224,
                                                     device="cpu"), (240, 320)),
    "avqa": (JL.make_avqa_device_pipeline,
             lambda: PL.make_avqa_device_pipeline(device="cpu"), (256, 256)),
    "avs": (JL.make_avs_device_pipeline, lambda: PL.make_avs_device_pipeline(device="cpu"),
            (224, 224)),
}


@pytest.mark.parametrize("name", sorted(PIPELINES))
def test_device_pipelines_against_jax(name):
    """The evaluation pipelines on one host batch {"frames" uint8, "wave" f32}."""
    jax_pipe, port_pipe, hw = PIPELINES[name]
    batch = {"frames": _clip(7, 2, 3, *hw, 3), "wave": _waves(8, 2, 3)}
    with jax.disable_jit():
        ja, jv = jax_pipe()(batch)
    pa, pv = port_pipe()(batch)
    assert tuple(pa.shape) == np.asarray(ja).shape and tuple(pv.shape) == np.asarray(jv).shape
    assert pa.device.type == pv.device.type == "cpu"
    assert _maxabs(pv, jv) <= 1e-5
    assert _maxabs(pa, ja) <= 1e-4
    ja, jv = jax_pipe()(batch)
    assert _maxabs(pv, jv) <= 2e-4 and _maxabs(pa, ja) <= 1e-4
    # tensors already on the pipeline's device are taken as they are
    pa2, pv2 = port_pipe()({k: torch.from_numpy(v) for k, v in batch.items()})
    assert torch.equal(pa2, pa) and torch.equal(pv2, pv)


@pytest.mark.parametrize("make", [PL.make_ave_device_pipeline, PL.make_avqa_device_pipeline,
                                  PL.make_avs_device_pipeline])
def test_pipelines_default_to_the_card(make):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is taken")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make()
