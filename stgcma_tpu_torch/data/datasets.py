"""Host-side decode helpers.

Port of `stgcma_tpu/data/datasets.py::load_wav` (:33), the scipy decoder
behind `serving.HostDecoder`'s Python path. The datasets themselves wait
for the data loaders (ROADMAP.md).
"""
from __future__ import annotations

from typing import Tuple

import numpy as np


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
