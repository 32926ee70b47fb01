"""The plain float32 reference of every configuration the benchmark runs.

Plain PyTorch only: no module of the program under test is imported here,
and nothing the program made (weights, casts, tables, pipeline output) is
read. Each function takes the benchmark's own weights, a dict of float32
tensors keyed by the dotted names the benchmark drew them under, and the
benchmark's own inputs, and works out everything else again. Every product
is float32 with TF32 off (`no_tf32`).
"""
from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def no_tf32():
    """float32 products in float32: TF32 off for matmuls and cuDNN while
    the block runs, restored after."""
    old = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old
