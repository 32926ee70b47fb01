"""The device trace of a few requests or steps, reduced to numbers.

`traced(fn, n)` runs fn n times under torch.profiler (host ops and the
card's kernels through CUPTI) inside one named region, and reduces the
Chrome trace to: the region's length on the host clock, the union of the
device's activity inside it (kernels, copies, memsets), the kernels
launched, the host-to-device copies' device time, the device operations
that took most time, and the idle gaps of the device by what the host did
before the operation that ended each gap.
"""
from __future__ import annotations

import bisect
import json
import os
import tempfile
from collections import defaultdict
from typing import Callable, Dict, List, Tuple

import torch

REGION = "portbench.window"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def union_length(intervals: List[Tuple[float, float]], lo: float, hi: float) -> float:
    """Length of the union of [start, end) intervals, clipped to [lo, hi)."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        s, e = max(s, lo), min(e, hi)
        if e <= s:
            continue
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def idle_gaps(dev: List[dict], lo: float, hi: float) -> List[Tuple[float, float, dict]]:
    """(start, end, the event that ends the gap or None) of every stretch of
    [lo, hi) in which no device event runs."""
    gaps, t = [], lo
    for ev in sorted(dev, key=lambda e: e["ts"]):
        s, e = ev["ts"], ev["ts"] + ev["dur"]
        if e <= lo or s >= hi:
            continue
        if s > t:
            gaps.append((t, s, ev))
        t = max(t, e)
    if t < hi:
        gaps.append((t, hi, None))
    return gaps


def _host_op_at(ops_by_tid: Dict[int, tuple], tid, ts) -> str:
    """The innermost host op of thread tid running at ts."""
    starts, ops = ops_by_tid.get(tid, ((), ()))
    i = bisect.bisect_right(starts, ts) - 1
    best = None
    while i >= 0:
        op = ops[i]
        if op["ts"] + op["dur"] >= ts:
            best = op
            break
        i -= 1
    return best["name"] if best else "_python_"


def reduce_trace(events: List[dict]) -> dict:
    """The numbers of one traced region (times in seconds)."""
    region = [e for e in events if e.get("name") == REGION and e.get("cat") == "user_annotation"]
    if not region:
        raise RuntimeError(f"the trace holds no '{REGION}' region")
    lo = region[0]["ts"]
    hi = lo + region[0]["dur"]
    dev = [e for e in events if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS
           and e["ts"] < hi and e["ts"] + e["dur"] > lo]
    busy = union_length([(e["ts"], e["ts"] + e["dur"]) for e in dev], lo, hi)
    by_name: Dict[str, float] = defaultdict(float)
    for e in dev:
        by_name[e["name"]] += e["dur"]
    runtime = {e["args"]["correlation"]: e for e in events
               if e.get("cat") == "cuda_runtime" and "correlation" in e.get("args", {})}
    ops = sorted((e for e in events if e.get("cat") == "cpu_op" and e.get("ph") == "X"),
                 key=lambda e: e["ts"])
    by_tid: Dict[int, list] = defaultdict(list)
    for op in ops:
        by_tid[op["tid"]].append(op)
    ops_by_tid = {t: ([o["ts"] for o in v], v) for t, v in by_tid.items()}
    gap_by_op: Dict[str, float] = defaultdict(float)
    for s, e, ev in idle_gaps(dev, lo, hi):
        launch = runtime.get(ev["args"].get("correlation")) if ev else None
        name = _host_op_at(ops_by_tid, launch["tid"], launch["ts"]) if launch else "_window_end_"
        gap_by_op[name] += e - s
    us = 1e-6
    return {
        "window_s": (hi - lo) * us,
        "busy_s": busy * us,
        "kernels": sum(e["cat"] == "kernel" for e in dev),
        "h2d_s": sum(e["dur"] for e in dev
                     if e["cat"] == "gpu_memcpy" and "HtoD" in e["name"]) * us,
        "device_ops": [[n[:96], t * us] for n, t in
                       sorted(by_name.items(), key=lambda kv: -kv[1])[:10]],
        "idle_gaps": [[n[:96], t * us] for n, t in
                      sorted(gap_by_op.items(), key=lambda kv: -kv[1])[:10]],
    }


def traced(fn: Callable[[int], None], n: int) -> dict:
    """Run fn(0) .. fn(n - 1) in one traced region; returns `reduce_trace`
    of it, with "count": n."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        with torch.profiler.record_function(REGION):
            for i in range(n):
                fn(i)
            torch.cuda.synchronize()
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.remove(path)
    out = reduce_trace(events)
    out["count"] = n
    return out
