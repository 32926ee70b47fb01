"""The reductions that turn a trace and a window's walls into metrics, on
made-up data."""
from __future__ import annotations

import math
import statistics

import pytest

from portbench.trace import REGION, idle_gaps, reduce_trace, union_length


def test_union_length_merges_overlaps_and_clips_to_the_window():
    iv = [(0, 10), (5, 15), (20, 30), (29, 31), (40, 50)]
    assert union_length(iv, 0, 100) == 15 + 11 + 10
    assert union_length(iv, 8, 45) == 7 + 11 + 5
    assert union_length([], 0, 10) == 0
    assert union_length([(3, 4), (1, 2)], 0, 10) == 2


def test_idle_gaps_cover_the_window_outside_the_union():
    dev = [{"ts": 5, "dur": 5}, {"ts": 8, "dur": 10}, {"ts": 30, "dur": 5}]
    gaps = idle_gaps(dev, 0, 40)
    assert [(s, e) for s, e, _ in gaps] == [(0, 5), (18, 30), (35, 40)]
    assert gaps[1][2] is dev[2] and gaps[2][2] is None
    busy = union_length([(d["ts"], d["ts"] + d["dur"]) for d in dev], 0, 40)
    assert busy + sum(e - s for s, e, _ in gaps) == 40


def _trace():
    """A region of 100 us: two kernels and a copy, the host's ops around them."""
    ev = [{"ph": "X", "cat": "user_annotation", "name": REGION, "ts": 1000, "dur": 100,
           "tid": 1}]
    ops = [("aten::copy_", 1000, 20), ("aten::mm", 1030, 10), ("aten::add", 1060, 5)]
    for name, ts, dur in ops:
        ev.append({"ph": "X", "cat": "cpu_op", "name": name, "ts": ts, "dur": dur, "tid": 1})
    launches = [(1, 1005), (2, 1032), (3, 1062)]
    for corr, ts in launches:
        ev.append({"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": ts,
                   "dur": 2, "tid": 1, "args": {"correlation": corr}})
    ev += [{"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy HtoD (Pinned -> Device)",
            "ts": 1010, "dur": 20, "args": {"correlation": 1}},
           {"ph": "X", "cat": "kernel", "name": "gemm", "ts": 1040, "dur": 15,
            "args": {"correlation": 2}},
           {"ph": "X", "cat": "kernel", "name": "add", "ts": 1070, "dur": 10,
            "args": {"correlation": 3}},
           {"ph": "X", "cat": "kernel", "name": "outside", "ts": 2000, "dur": 10,
            "args": {"correlation": 9}}]
    return ev


def test_reduce_trace_reads_busy_launches_copies_and_gaps():
    r = reduce_trace(_trace())
    assert r["window_s"] == pytest.approx(100e-6)
    assert r["busy_s"] == pytest.approx(45e-6)
    assert r["kernels"] == 2
    assert r["h2d_s"] == pytest.approx(20e-6)
    assert r["device_ops"][0] == ["Memcpy HtoD (Pinned -> Device)", pytest.approx(20e-6)]
    gaps = dict(r["idle_gaps"])
    # 1000-1010 before the copy (launched inside aten::copy_), 1030-1040 before
    # gemm (aten::mm), 1055-1070 before add (aten::add), 1080-1100 at the end
    assert gaps == {"aten::copy_": pytest.approx(10e-6), "aten::mm": pytest.approx(10e-6),
                    "aten::add": pytest.approx(15e-6), "_window_end_": pytest.approx(20e-6)}
    idle = 1 - r["busy_s"] / r["window_s"]
    assert idle == pytest.approx(0.55)


def test_reduce_trace_needs_its_region():
    with pytest.raises(RuntimeError):
        reduce_trace([e for e in _trace() if e["name"] != REGION])


@pytest.mark.parametrize("values", [[5.0], [1.0, 2.0], list(range(1, 101)),
                                    [3.0, 1.0, 4.0, 1.0, 5.0, 9.0, 2.0, 6.0]])
@pytest.mark.parametrize("q", [50, 95])
def test_percentile_is_numpy_linear(values, q):
    import numpy as np

    from portbench.harness import percentile
    assert percentile(values, q) == pytest.approx(float(np.percentile(values, q)))


def test_percentile_of_nothing_is_nan():
    from portbench.harness import percentile
    assert math.isnan(percentile([], 95))
    assert percentile([2.0, 4.0], 50) == statistics.median([2.0, 4.0])
