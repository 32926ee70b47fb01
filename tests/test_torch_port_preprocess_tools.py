"""The port's offline tools and single-file native decode against the JAX
package's: `tools/preprocess_avs.py::extract_frames` (PNGs equal pixel for
pixel on a GIF, read by imageio, and on mp4v / MJPG videos written by
OpenCV, read by its FFMPEG backend), `wav_to_vggish_pickle` (a long clip, a
short clip whose last second repeats, and a 22.05 kHz clip resampled
linearly; the pickles within 1e-5 of max |ref|: the port's log-mel runs an
FFT in float32 where JAX's does, in another summation order),
`tools/extract_audio.py::main` with an injected extractor (the existing wav
skipped, the undecodable video counted as failed), and
`data/native_io.py::decode_image` / `decode_wav` bit for bit against JAX's
through the same library (skipped where native/libstgcma_host.so is not
built).
"""
import os
import pickle

import numpy as np
import pytest
from scipy.io import wavfile

import torch_port_helpers  # noqa: F401  (two torch threads a process)
from stgcma_tpu.data import native_io as JN
from stgcma_tpu.tools import extract_audio as JEA
from stgcma_tpu.tools import preprocess_avs as JPA
from stgcma_tpu_torch.data import native_io as PN
from stgcma_tpu_torch.tools import extract_audio as PEA
from stgcma_tpu_torch.tools import preprocess_avs as PPA

from torch_port_helpers import rel

FIX = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures", "ave")
TOL = 1e-5


def _write_gif(path, n_frames=20, fps=4, size=32):
    from PIL import Image
    rng = np.random.RandomState(0)
    frames = [Image.fromarray(rng.randint(0, 255, (size, size, 3), np.uint8))
              for _ in range(n_frames)]
    frames[0].save(path, save_all=True, append_images=frames[1:], duration=int(1000 / fps),
                   loop=0)


def _write_cv2_video(path, fourcc, n_frames=20, fps=4, size=32):
    cv2 = pytest.importorskip("cv2")
    w = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*fourcc), fps, (size, size))
    if not w.isOpened():
        pytest.skip(f"cv2 VideoWriter cannot encode {fourcc}")
    rng = np.random.RandomState(1)
    for _ in range(n_frames):
        w.write(rng.randint(0, 255, (size, size, 3), np.uint8))
    w.release()


@pytest.mark.parametrize("container,fourcc,n_frames", [("gif", None, 20), ("gif", None, 3),
                                                       ("mp4", "mp4v", 20),
                                                       ("avi", "MJPG", 20)])
def test_extract_frames_matches_jax(tmp_path, container, fourcc, n_frames):
    from PIL import Image
    vid = str(tmp_path / f"clip.{container}")
    if fourcc is None:
        _write_gif(vid, n_frames=n_frames)
    else:
        _write_cv2_video(vid, fourcc, n_frames=n_frames)
    jdir, pdir = str(tmp_path / "jax"), str(tmp_path / "port")
    assert JPA.extract_frames(vid, jdir, "clip", num_seconds=5, size=64)
    assert PPA.extract_frames(vid, pdir, "clip", num_seconds=5, size=64)
    names = sorted(os.listdir(pdir))
    assert names == sorted(os.listdir(jdir)) == [f"clip_{i}.png" for i in range(1, 6)]
    for n in names:
        a = np.asarray(Image.open(os.path.join(pdir, n)))
        b = np.asarray(Image.open(os.path.join(jdir, n)))
        assert a.shape == (64, 64, 3)
        np.testing.assert_array_equal(a, b)


def test_preprocess_main_matches_jax(tmp_path):
    vids = tmp_path / "videos"
    vids.mkdir()
    _write_gif(str(vids / "a.gif"))
    _write_gif(str(vids / "b.gif"), n_frames=6)
    (vids / "notes.txt").write_text("not a video")
    JPA.main(["--videos_dir", str(vids), "--out_root", str(tmp_path / "jax")])
    PPA.main(["--videos_dir", str(vids), "--out_root", str(tmp_path / "port")])
    for name in ("a", "b"):
        sub = os.path.join("visual_frames", "train", name)
        got = sorted(os.listdir(tmp_path / "port" / sub))
        assert got == sorted(os.listdir(tmp_path / "jax" / sub)) and len(got) == 5
        for f in got:
            assert (tmp_path / "port" / sub / f).read_bytes() == \
                (tmp_path / "jax" / sub / f).read_bytes()


@pytest.mark.parametrize("seconds,rate", [(6.0, 16000), (3.2, 16000), (5.5, 22050)])
def test_wav_to_vggish_pickle_matches_jax(tmp_path, seconds, rate):
    rng = np.random.RandomState(2)
    n = int(seconds * rate)
    tone = np.sin(2 * np.pi * 440 * np.arange(n) / rate) * 0.3 + 0.05 * rng.randn(n)
    wav = str(tmp_path / "clip.wav")
    wavfile.write(wav, rate, (np.clip(tone, -1, 1) * 32767).astype(np.int16))
    ref = JPA.wav_to_vggish_pickle(wav, str(tmp_path / "jax.pkl"))
    out = PPA.wav_to_vggish_pickle(wav, str(tmp_path / "port" / "clip.pkl"), device="cpu")
    with open(tmp_path / "port" / "clip.pkl", "rb") as f:
        stored = pickle.load(f)
    assert isinstance(stored, np.ndarray) and stored.dtype == np.float32
    assert stored.shape == out.shape == ref.shape == (5, 1, 94, 64)
    np.testing.assert_array_equal(stored, out)
    assert rel(out, np.asarray(ref)) < TOL
    if seconds < 5:     # the seconds past the clip repeat its last full second
        last = int(seconds - 0.96) + 1
        for s in range(last, 5):
            np.testing.assert_array_equal(out[s], out[last - 1])


def test_extract_audio_counts_like_jax(tmp_path):
    vdir = tmp_path / "videos"
    vdir.mkdir()
    for n in ("clip1.mp4", "clip2.mp4", "broken.mp4"):
        (vdir / n).write_bytes(b"\x00" * 16)
    results = {}
    for tag, mod in (("jax", JEA), ("port", PEA)):
        adir = tmp_path / f"wav_{tag}"
        adir.mkdir()
        (adir / "clip1.wav").write_bytes(b"RIFF")     # there already: skipped
        calls = []

        def fake_extract(video, out, sr, calls=calls):
            if "broken" in video:
                raise RuntimeError("undecodable")
            calls.append((os.path.basename(video), os.path.basename(out), sr))
            open(out, "wb").write(b"RIFF")

        counts = mod.main(["--video_pth", str(vdir), "--save_pth", str(adir),
                           "--sample_rate", "22050"], extractor=fake_extract)
        results[tag] = (counts, calls, sorted(os.listdir(adir)))
    assert results["port"] == results["jax"]
    assert results["port"][0] == (1, 1, 1)
    assert results["port"][1] == [("clip2.mp4", "clip2.wav", 22050)]


def test_extract_audio_without_a_decoder_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(PEA, "_ffmpeg_exe", lambda: None)
    monkeypatch.setitem(__import__("sys").modules, "av", None)
    with pytest.raises(RuntimeError, match="no audio decoder"):
        PEA.get_audio_wav(str(tmp_path / "v.mp4"), str(tmp_path), "v.wav")


@pytest.mark.parametrize("kind", ["wav", "image", "missing"])
def test_native_single_file_decode_matches_jax(kind):
    if not JN.available():
        pytest.skip("native/libstgcma_host.so is not built (make -C native)")
    if kind == "wav":
        wavs = sorted(os.path.join(FIX, "raw_audio", f)
                      for f in os.listdir(os.path.join(FIX, "raw_audio")))
        for p in wavs:
            (a, sr_a), (b, sr_b) = PN.decode_wav(p), JN.decode_wav(p)
            assert sr_a == sr_b and a.dtype == np.float32 and len(a) > 0
            np.testing.assert_array_equal(a, b)
    elif kind == "image":
        if not JN.image_available():
            pytest.skip("the native library was built without the image decoder")
        d = os.path.join(FIX, "video_frames")
        jpgs = sorted(os.path.join(r, f) for r, _, fs in os.walk(d) for f in fs)
        assert jpgs
        for p in jpgs:
            a, b = PN.decode_image(p), JN.decode_image(p)
            assert a is not None and a.ndim == 3 and a.shape[-1] == 3
            np.testing.assert_array_equal(a, b)
    else:
        assert PN.decode_wav("/nonexistent.wav") is None
        assert JN.decode_wav("/nonexistent.wav") is None
        assert PN.decode_image("/nonexistent.jpg") is None
        assert JN.decode_image("/nonexistent.jpg") is None
