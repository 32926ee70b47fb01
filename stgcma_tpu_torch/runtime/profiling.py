"""Tracing and profiling: torch.profiler traces with named spans, and an
analytic counter of operations and bytes.

Port of `stgcma_tpu/runtime/profiling.py`: `trace` (:20) and `annotate`
(:29) over `torch.profiler` (the card's kernels through CUPTI where there is
one) and NVTX, `annotate` free while no session records; `cost_analysis`
(:68), which JAX reads from XLA's cost analysis, counted here op by op while
the function runs: the flops by `torch.utils.flop_counter.FlopCounterMode`,
the bytes as each aten op's inputs read once and outputs written once (views
move none), which is what XLA counts for an unfused op. The JAX package's
`StepMeters` has no counterpart: its data / DNN split timed the host's
enqueue, not the card.
"""
from __future__ import annotations

import contextlib
import os
from typing import Dict

import torch
from torch.autograd import profiler as _profiler
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import FlopCounterMode


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the block: the host's ops, and the card's kernels where CUDA
    is available. On exit the trace goes to `log_dir/trace_<pid>.json`
    (Chrome's trace format; chrome://tracing, Perfetto or TensorBoard read
    it). Yields the profiler, whose `key_averages()` sums the block by
    op."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, f"trace_{os.getpid()}.json"))


@contextlib.contextmanager
def _span(name: str):
    nvtx = torch.cuda.is_available()
    if nvtx:
        torch.cuda.nvtx.range_push(name)
    try:
        with torch.profiler.record_function(name):
            yield
    finally:
        if nvtx:
            torch.cuda.nvtx.range_pop()


_OFF = contextlib.nullcontext()


def annotate(name: str):
    """A named span, as a context manager: while a torch.profiler session
    records, a `record_function(name)` region, which sits in the session's
    Chrome trace on the clock of the card's kernels and copies, and an NVTX
    range where CUDA is available; otherwise nothing beyond reading the
    profiler's flag. The port's spans (`serve.*`, `model.*`, `data.*`,
    `train.*`) are named in PERF.md §3."""
    return _span(name) if _profiler._is_profiler_enabled else _OFF


def _nbytes(tree) -> int:
    return sum(x.numel() * x.element_size() for x in tree_leaves(tree)
               if isinstance(x, torch.Tensor))


class _ByteCounter(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.bytes = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if not func.is_view:
            self.bytes += _nbytes((args, kwargs)) + _nbytes(out)
        return out


def cost_analysis(fn, *args) -> Dict[str, float]:
    """{"flops", "bytes accessed"} of one call of fn(*args), which runs: the
    flops FlopCounterMode counts (2 a multiply-add of the products and
    convolutions), and each aten op's input and output bytes."""
    counter = _ByteCounter()
    flops = FlopCounterMode(display=False)
    with flops, counter:
        fn(*args)
    return {"flops": float(flops.get_total_flops()), "bytes accessed": float(counter.bytes)}
