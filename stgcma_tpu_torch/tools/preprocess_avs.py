"""AVS offline preprocessing: video -> per-second frames (224x224 PNG) and
VGGish log-mel pickles.

Port of `stgcma_tpu/tools/preprocess_avs.py` (reference
AVS/preprocess/{preprocess_s4.py, preprocess_ms3.py}: ffmpeg / imageio frame
sampling at 16 fps -> one png a second, torchvggish log-mel examples with
the last second repeated on a short clip). The frames are numpy, OpenCV,
imageio and PIL, as in JAX, so the PNGs are the JAX tool's pixel for pixel:
OpenCV's FFMPEG backend decodes the reference's containers (mp4 / avi / mkv
/ webm, preprocess_s4.py:24-43) and imageio the GIF and other Pillow-native
ones. The log-mel is `ops/fbank.py::vggish_log_mel` on `device` (the card
unless the caller asks for the CPU), and the pickle holds a numpy float32
(5, 1, 94, 64), so that the files either package writes read the same.

Usage: python -m stgcma_tpu_torch.tools.preprocess_avs --videos_dir DIR --out_root OUT
"""
from __future__ import annotations

import argparse
import os
import pickle
import numpy as np


def _decode_video_cv2(video_path: str):
    """(frames (T,H,W,3) RGB uint8, fps) via OpenCV/FFMPEG, or None if the
    backend can't open the container."""
    try:
        import cv2
    except ImportError:  # pragma: no cover
        return None
    cap = cv2.VideoCapture(video_path)
    if not cap.isOpened():
        return None
    fps = cap.get(cv2.CAP_PROP_FPS)
    frames = []
    while True:
        ok, f = cap.read()
        if not ok:
            break
        frames.append(f[:, :, ::-1])        # BGR -> RGB
    cap.release()
    if not frames:
        return None
    return np.stack(frames), float(fps) if fps and fps > 0 else 16.0


def extract_frames(video_path: str, out_dir: str, name: str,
                   num_seconds: int = 5, size: int = 224) -> bool:
    """1 frame per second, resized to size^2, saved {name}_{i+1}.png
    (preprocess_s4.py:24-102 sampling grid)."""
    try:
        from PIL import Image
    except ImportError:  # pragma: no cover
        print("PIL unavailable — cannot extract frames")
        return False
    decoded = None
    if not video_path.lower().endswith(".gif"):   # cv2 mishandles GIF alpha
        decoded = _decode_video_cv2(video_path)
    if decoded is not None:
        frames, fps = decoded
    else:
        try:
            import imageio.v3 as iio
            meta = iio.immeta(video_path)
            if "fps" in meta:
                fps = float(meta["fps"])
            elif meta.get("duration"):  # ms per frame (GIF-style containers)
                fps = 1000.0 / float(meta["duration"])
            else:
                fps = 16.0
            frames = iio.imread(video_path)  # (T, H, W, C)
        except Exception as e:  # pragma: no cover
            print(f"decode failed for {video_path}: {e}")
            return False
    os.makedirs(out_dir, exist_ok=True)
    total = len(frames)
    for s in range(num_seconds):
        idx = min(int(round((s + 0.5) * fps)), total - 1)
        img = Image.fromarray(frames[idx]).convert("RGB").resize(
            (size, size), Image.BILINEAR)
        img.save(os.path.join(out_dir, f"{name}_{s+1}.png"))
    return True


def wav_to_vggish_pickle(wav_path: str, out_pkl: str, num_seconds: int = 5,
                         sample_rate: int = 16000, device="cuda"):
    """5 VGGish log-mel examples, one a second, repeating the last second
    when the clip is short (preprocess_s4.py:133-142); another sample rate
    is resampled linearly first. Each example is the log-mel of the
    second's first 0.96 s alone: 94 frames of 25 ms at a 10 ms hop, as the
    JAX tool makes them (torchvggish frames the whole clip and cuts 96
    frames a second). Returns the pickled (5, 1, 94, 64) float32."""
    import torch
    from ..data.datasets import load_wav
    from ..ops.common import resolve_device
    from ..ops.fbank import vggish_log_mel

    device = resolve_device(device)
    wav, sr = load_wav(wav_path)
    wav = wav.mean(axis=0)
    if sr != sample_rate:
        # linear resample (offline tool; ffmpeg-grade resampling not required)
        n_out = int(len(wav) * sample_rate / sr)
        x_old = np.linspace(0, 1, len(wav))
        wav = np.interp(np.linspace(0, 1, n_out), x_old, wav).astype(np.float32)
    seg = int(0.96 * sample_rate)
    examples = []
    for s in range(num_seconds):
        start = s * sample_rate
        chunk = wav[start:start + seg]
        if len(chunk) < seg:
            # repeat the last full second
            if examples:
                examples.append(examples[-1])
                continue
            chunk = np.pad(chunk, (0, seg - len(chunk)))
        mel = vggish_log_mel(torch.from_numpy(np.ascontiguousarray(chunk)).to(device))
        examples.append(mel.cpu().numpy().astype(np.float32))
    arr = np.stack(examples)[:, None]  # (5, 1, 94, 64)
    os.makedirs(os.path.dirname(out_pkl) or ".", exist_ok=True)
    with open(out_pkl, "wb") as f:
        pickle.dump(arr, f)
    return arr


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--videos_dir", required=True)
    p.add_argument("--out_root", required=True)
    p.add_argument("--split", default="train")
    p.add_argument("--num_seconds", type=int, default=5)
    args = p.parse_args(argv)
    vids = [f for f in os.listdir(args.videos_dir)
            if f.endswith((".mp4", ".avi", ".mkv", ".webm", ".gif"))]
    for f in vids:
        name = os.path.splitext(f)[0]
        extract_frames(os.path.join(args.videos_dir, f),
                       os.path.join(args.out_root, "visual_frames", args.split,
                                    name),
                       name, args.num_seconds)
    print(f"processed {len(vids)} videos")


if __name__ == "__main__":
    main()
