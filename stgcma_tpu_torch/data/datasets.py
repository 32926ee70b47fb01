"""Host-side datasets and decode helpers: datasets yield raw numpy items
(uint8 frames, float32 waveforms, labels); `data/loader.py` batches them and
finishes them on the device.

Port of `stgcma_tpu/data/datasets.py`: `load_wav` (:33, the scipy decoder
behind `serving.HostDecoder`'s Python path), `load_image` (:51),
`_select_frames` (:79), `_segment_waveform` (:91), `AVEDataset` (:107) and
`SyntheticAVE` (:338). `load_image` decodes with PIL, which the JAX
package's native decoder matches bit for bit. `h5py` is imported by
`AVEDataset` alone. The AVQA and AVS datasets wait for their trainers
(ROADMAP.md).

AVE layout (AVE/dataloader.py:73-525): train/test_order.h5 'order',
labels.h5 'avadataset' one-hot [N, 10, 29], Annotations.txt '&'-separated
rows, frame directories of jpgs, 10 x 1 s wav segments.
"""
from __future__ import annotations

import os
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..ops.fbank import segment_starts


def load_wav(path: str) -> Tuple[np.ndarray, int]:
    """A wav as float32 in [-1, 1], (channels, samples) as torchaudio.load
    returns it, and its sample rate."""
    from scipy.io import wavfile
    sr, data = wavfile.read(path)
    if data.dtype == np.int16:
        data = data.astype(np.float32) / 32768.0
    elif data.dtype == np.int32:
        data = data.astype(np.float32) / 2147483648.0
    elif data.dtype == np.uint8:
        data = (data.astype(np.float32) - 128.0) / 128.0
    else:
        data = data.astype(np.float32)
    data = data.T if data.ndim == 2 else data[None]
    return data, sr


def load_image(path: str) -> np.ndarray:
    """jpg/png -> (H, W, 3) uint8."""
    from PIL import Image
    with Image.open(path) as im:
        return np.asarray(im.convert("RGB"), np.uint8)


def _select_frames(frame_dir: str, num: int) -> List[str]:
    """linspace over all jpg/png frames (AVE/dataloader.py:292-302)."""
    files = sorted(f for f in os.listdir(frame_dir)
                   if f.lower().endswith((".jpg", ".jpeg", ".png")))
    if not files:
        raise FileNotFoundError(f"no frames in {frame_dir}")
    idx = np.linspace(0, len(files) - 1, num=num).astype(int)
    return [os.path.join(frame_dir, files[i]) for i in idx]


def _segment_waveform(wav: np.ndarray, sr: int, num_segments: int,
                      seg_seconds: float) -> np.ndarray:
    """(L,) -> (num_segments, seg_samples), zero-padded; linspace starts when the
    clip is long enough (AVE/dataloader.py:229-236)."""
    seg = int(sr * seg_seconds)
    L = wav.shape[-1]
    if L > sr * (seg_seconds + 0.1):
        starts = segment_starts(L, seg, num_segments, sample_rate=sr)
    else:
        starts = np.zeros(num_segments, np.int64)
    out = np.zeros((num_segments, seg), np.float32)
    for i, s in enumerate(starts):
        chunk = wav[s: s + seg]
        out[i, : len(chunk)] = chunk
    return out


class AVEDataset:
    """Items: frames (10, H, W, 3) uint8, wave (10, 16000) f32, labels (10,
    29) one-hot f32."""

    def __init__(self, order_h5: str, labels_h5: str, frames_root: str,
                 audio_root: str, num_frames: int = 10, mode: str = "eval",
                 annotations_txt: str = ""):
        import h5py
        with h5py.File(order_h5, "r") as f:
            self.order = np.asarray(f["order"])
        with h5py.File(labels_h5, "r") as f:
            self.labels = np.asarray(f["avadataset"], np.float32)
        # Annotations.txt: '&'-separated rows, column 1 = video file name;
        # order entries index into it (AVE/dataloader.py:129 raw_gt +
        # :489 file_name = raw_gt.iloc[real_idx][1], read with header=None so
        # any header line counts as row 0, exactly like the reference).
        self.file_names: Optional[List[str]] = None
        if annotations_txt:
            with open(annotations_txt) as f:
                self.file_names = [ln.rstrip("\n").split("&")[1] for ln in f if ln.strip()]
        self.frames_root = frames_root
        self.audio_root = audio_root
        self.num_frames = num_frames
        self.mode = mode

    def __len__(self):
        return len(self.order)

    def video_ids(self) -> List[str]:
        return [str(i) for i in self.order]

    def __getitem__(self, i: int) -> Dict[str, np.ndarray]:
        vid = self.order[i]
        if self.file_names is not None:
            vid_s = self.file_names[int(vid)]
        else:
            vid_s = vid.decode() if isinstance(vid, bytes) else str(vid)
        # corrupted-sample fallbacks mirror the reference's 0.01-filled
        # substitutes + warning (AVE/dataloader.py:246-248,311-316,501-505)
        try:
            paths = _select_frames(os.path.join(self.frames_root, vid_s), self.num_frames)
            frames = np.stack([load_image(p) for p in paths])
        except (OSError, ValueError) as e:
            print(f"there is a frame loading error for {vid_s}: {e}")
            frames = np.zeros((self.num_frames, 224, 224, 3), np.uint8)
        try:
            wav, sr = load_wav(os.path.join(self.audio_root, vid_s + ".wav"))
            wav = wav.mean(axis=0)
            wav = wav - wav.mean()
            segs = _segment_waveform(wav, sr, self.num_frames, 1.0)
        except (OSError, ValueError) as e:
            print(f"there is an audio loading error for {vid_s}: {e}")
            segs = np.full((self.num_frames, 16000), 0.01, np.float32)
        return {"frames": frames, "wave": segs,
                "labels": self.labels[vid] if np.issubdtype(type(vid), np.integer)
                else self.labels[i]}


class SyntheticAVE:
    """Seeded random AVE items (tests and runs without the corpus): uint8
    frames (T, size, size, 3), wave (T, 16000) ~ N(0, 0.1), one-hot labels."""

    def __init__(self, n=32, num_frames=10, size=256, label_dim=29, seed=0):
        self.n, self.T, self.size, self.C = n, num_frames, size, label_dim
        self.seed = seed

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        rng = np.random.RandomState(self.seed + i)
        frames = rng.randint(0, 256, (self.T, self.size, self.size, 3), np.uint8)
        wave = (rng.randn(self.T, 16000) * 0.1).astype(np.float32)
        labels = np.zeros((self.T, self.C), np.float32)
        labels[np.arange(self.T), rng.randint(0, self.C, self.T)] = 1.0
        return {"frames": frames, "wave": wave, "labels": labels}
