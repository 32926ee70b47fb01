"""AVQA audio extraction: video files -> 16 kHz mono wav.

Port of `stgcma_tpu/tools/extract_audio.py` (reference
AVQA/preprocessing/extract_audio.py:10-36: moviepy
`VideoFileClip(name).audio.write_audiofile(..., fps=16000)` over a directory,
skipping already-extracted files and continuing past undecodable videos). A
host tool: no model and no card.

Decode backends are probed in order: the `ffmpeg` binary, `imageio_ffmpeg`'s
bundled binary, then PyAV, whichever the environment provides; `extractor`
(video, wav, sample_rate) replaces them.

Usage: python -m stgcma_tpu_torch.tools.extract_audio --video_pth DIR --save_pth OUT
"""
from __future__ import annotations

import argparse
import os
import subprocess
from typing import Callable, Optional


def _ffmpeg_exe() -> Optional[str]:
    import shutil
    exe = shutil.which("ffmpeg")
    if exe:
        return exe
    try:
        import imageio_ffmpeg
        return imageio_ffmpeg.get_ffmpeg_exe()
    except Exception:
        return None


def _extract_ffmpeg(exe: str, video: str, wav: str, sr: int):
    subprocess.run(
        [exe, "-y", "-i", video, "-vn", "-acodec", "pcm_s16le",
         "-ar", str(sr), "-ac", "1", wav],
        check=True, capture_output=True)


def _extract_pyav(video: str, wav: str, sr: int):
    import numpy as np
    import av
    from scipy.io import wavfile
    with av.open(video) as c:
        stream = c.streams.audio[0]
        resampler = av.AudioResampler(format="s16", layout="mono", rate=sr)
        chunks = []
        for frame in c.decode(stream):
            for rf in resampler.resample(frame):
                chunks.append(rf.to_ndarray().reshape(-1))
    wavfile.write(wav, sr, np.concatenate(chunks).astype(np.int16))


def get_audio_wav(video_path: str, save_pth: str, audio_name: str,
                  sample_rate: int = 16000,
                  extractor: Optional[Callable] = None):
    """Extract one video's audio track to `save_pth/audio_name` (reference
    get_audio_wav, extract_audio.py:10-15)."""
    out = os.path.join(save_pth, audio_name)
    if extractor is not None:
        extractor(video_path, out, sample_rate)
        return
    exe = _ffmpeg_exe()
    if exe:
        _extract_ffmpeg(exe, video_path, out, sample_rate)
        return
    try:
        import av  # noqa: F401
    except ImportError:
        raise RuntimeError(
            "no audio decoder available: install ffmpeg, imageio-ffmpeg, or "
            "PyAV to extract wav tracks from video")
    _extract_pyav(video_path, out, sample_rate)


def main(argv=None, extractor: Optional[Callable] = None):
    p = argparse.ArgumentParser(
        description="extract 16 kHz mono wav from every video in a directory "
                    "(AVQA/preprocessing/extract_audio.py)")
    p.add_argument("--video_pth", required=True)
    p.add_argument("--save_pth", required=True)
    p.add_argument("--sample_rate", type=int, default=16000)
    args = p.parse_args(argv)

    os.makedirs(args.save_pth, exist_ok=True)
    done = failed = skipped = 0
    for video_id in sorted(os.listdir(args.video_pth)):
        name = os.path.join(args.video_pth, video_id)
        audio_name = os.path.splitext(video_id)[0] + ".wav"
        if os.path.exists(os.path.join(args.save_pth, audio_name)):
            print("already exist!")
            skipped += 1
            continue
        try:
            get_audio_wav(name, args.save_pth, audio_name, args.sample_rate,
                          extractor)
            print("finish video id: " + audio_name)
            done += 1
        except Exception:
            print("cannot load ", name)
            failed += 1
    print(f"done: {done} extracted, {skipped} skipped, {failed} failed")
    return done, skipped, failed


if __name__ == "__main__":
    main()
