"""ctypes binding to the native host-IO library (native/stgcma_host.cc,
built by `make -C native` into native/libstgcma_host.so): multithreaded WAV
decode with mono downmix, DC removal and segment slicing, and jpg/png
decode.

The port's own copy of `stgcma_tpu/data/native_io.py` (`available` :68,
`decode_wav_batch` :72, `image_available` :90, `decode_image_batch` :95,
and the single-file calls `decode_image` :116 and `decode_wav` :133),
with the library looked up beside this package's checkout. Where the
library is not built (it links libjpeg and libpng), `serving.HostDecoder`
takes the scipy and PIL paths instead.
"""
from __future__ import annotations

import ctypes
import os
from typing import List, Optional, Tuple

import numpy as np

_LIB_PATHS = [
    os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "..", "native",
                 "libstgcma_host.so"),
    "libstgcma_host.so",
]

_lib = None


def _load():
    global _lib
    if _lib is not None:
        return _lib
    lib = None
    for p in _LIB_PATHS:
        try:
            lib = ctypes.CDLL(os.path.abspath(p) if os.path.sep in p else p)
            break
        except OSError:
            lib = None
    if lib is None:
        _lib = False
        return False
    lib.stgcma_decode_wav_batch.restype = ctypes.c_int
    lib.stgcma_decode_wav_batch.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_float, ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_uint8),
        ctypes.c_int,
    ]
    lib.stgcma_decode_wav.restype = ctypes.c_int64
    lib.stgcma_decode_wav.argtypes = [
        ctypes.c_char_p, ctypes.POINTER(ctypes.c_float), ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int),
    ]
    try:
        lib.stgcma_decode_image_batch.restype = ctypes.c_int
        lib.stgcma_decode_image_batch.argtypes = [
            ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_uint8), ctypes.c_int,
        ]
        lib.stgcma_decode_image.restype = ctypes.c_int64
        lib.stgcma_decode_image.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
        ]
        lib._has_image = True
    except AttributeError:          # a library built before the image decoder
        lib._has_image = False
    _lib = lib
    return lib


def available() -> bool:
    return bool(_load())


def decode_wav_batch(paths: List[str], num_segments: int, seg_samples: int,
                     margin_s: float = 0.1, num_threads: int = 8
                     ) -> Tuple[np.ndarray, np.ndarray]:
    """-> (waves (B, num_segments, seg_samples) float32, ok (B,) bool)."""
    lib = _load()
    if not lib:
        raise RuntimeError("native host-IO library not built (make -C native)")
    B = len(paths)
    out = np.zeros((B, num_segments, seg_samples), np.float32)
    ok = np.zeros((B,), np.uint8)
    arr = (ctypes.c_char_p * B)(*[p.encode() for p in paths])
    lib.stgcma_decode_wav_batch(
        arr, B, num_segments, seg_samples, ctypes.c_float(margin_s),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        ok.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), num_threads)
    return out, ok.astype(bool)


def image_available() -> bool:
    lib = _load()
    return bool(lib) and getattr(lib, "_has_image", False)


def decode_image_batch(paths: List[str], height: int, width: int, num_threads: int = 8
                       ) -> Tuple[np.ndarray, np.ndarray]:
    """jpg/png files -> (frames (B, height, width, 3) uint8, ok (B,) bool).
    A frame at (height, width) decodes bit for bit as PIL does (the same
    libjpeg / libpng); another size gets a host bilinear resize."""
    lib = _load()
    if not lib or not lib._has_image:
        raise RuntimeError("native image decode not built (make -C native)")
    B = len(paths)
    out = np.zeros((B, height, width, 3), np.uint8)
    ok = np.zeros((B,), np.uint8)
    arr = (ctypes.c_char_p * B)(*[p.encode() for p in paths])
    lib.stgcma_decode_image_batch(
        arr, B, height, width, out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        ok.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), num_threads)
    return out, ok.astype(bool)


def decode_image(path: str, max_bytes: int = 64 << 20) -> Optional[np.ndarray]:
    """One jpg/png at its own size -> (H, W, 3) uint8, or None where the
    file does not decode or the library is not built."""
    lib = _load()
    if not lib or not lib._has_image:
        return None
    buf = np.zeros((max_bytes,), np.uint8)
    w, h = ctypes.c_int(0), ctypes.c_int(0)
    n = lib.stgcma_decode_image(path.encode(), buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                                max_bytes, ctypes.byref(w), ctypes.byref(h))
    if n <= 0:
        return None
    return buf[:n].reshape(h.value, w.value, 3).copy()


def decode_wav(path: str, max_seconds: float = 60.0) -> Optional[Tuple[np.ndarray, int]]:
    """One WAV, mono, at most max_seconds at 48 kHz -> (samples float32,
    sample rate), or None where it does not decode or the library is not
    built."""
    lib = _load()
    if not lib:
        return None
    max_samples = int(max_seconds * 48000)
    buf = np.zeros((max_samples,), np.float32)
    sr = ctypes.c_int(0)
    n = lib.stgcma_decode_wav(path.encode(), buf.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                              max_samples, ctypes.byref(sr))
    if n <= 0:
        return None
    return buf[:n].copy(), sr.value
