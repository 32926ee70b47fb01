"""Tracing and profiling: torch.profiler traces with named regions, step
meters with the reference's per-sample total / data / DNN split, and an
analytic counter of operations and bytes.

Port of `stgcma_tpu/runtime/profiling.py`: `trace` (:20) and `annotate`
(:29) over `torch.profiler` (the card's kernels through CUPTI where there is
one) and NVTX; `StepMeters` (:34, AverageMeter wall clock, SURVEY §5,
AVE/traintest_adapt_ave29.py:19,151-186) copied; `cost_analysis` (:68),
which JAX reads from XLA's cost analysis, counted here op by op while the
function runs: the flops by `torch.utils.flop_counter.FlopCounterMode`, the
bytes as each aten op's inputs read once and outputs written once (views
move none), which is what XLA counts for an unfused op.
"""
from __future__ import annotations

import contextlib
import os
import time
from typing import Dict, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import FlopCounterMode

from ..metrics.stats import AverageMeter


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
def annotate(name: str):
    """A named region of a trace (`record_function`), and an NVTX range on
    the card's timeline where CUDA is available."""
    nvtx = torch.cuda.is_available()
    if nvtx:
        torch.cuda.nvtx.range_push(name)
    try:
        with torch.profiler.record_function(name):
            yield
    finally:
        if nvtx:
            torch.cuda.nvtx.range_pop()


class StepMeters:
    """per-sample total / data-loading / DNN-compute wall-clock, printed every
    n_print_steps like the reference engine."""

    def __init__(self, n_print_steps: int = 100):
        self.total = AverageMeter()
        self.data = AverageMeter()
        self.dnn = AverageMeter()
        self.loss = AverageMeter()
        self.n_print = n_print_steps
        self._t0 = time.time()
        self._step = 0

    def data_loaded(self, batch_size: int):
        now = time.time()
        self.data.update((now - self._t0) / batch_size, batch_size)
        self._t_data = now

    def step_done(self, batch_size: int, loss: Optional[float] = None):
        now = time.time()
        self.dnn.update((now - self._t_data) / batch_size, batch_size)
        self.total.update((now - self._t0) / batch_size, batch_size)
        if loss is not None:
            self.loss.update(loss, batch_size)
        self._t0 = now
        self._step += 1
        if self._step % self.n_print == 0:
            print(f"step {self._step}: per-sample total {self.total.avg*1e3:.2f} ms "
                  f"(data {self.data.avg*1e3:.2f} ms, dnn {self.dnn.avg*1e3:.2f} ms)"
                  f" loss {self.loss.avg:.4f}", flush=True)

    def report(self) -> Dict[str, float]:
        return {"per_sample_total_s": self.total.avg,
                "per_sample_data_s": self.data.avg,
                "per_sample_dnn_s": self.dnn.avg,
                "loss": self.loss.avg}


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
