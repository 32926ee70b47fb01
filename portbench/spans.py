"""The traced window's device work, idle time and host syncs, put down to the
program's spans.

The port opens named spans at its layer boundaries (`runtime/profiling.py::
annotate`: `serve.*`, `model.*`, `data.*`, `train.*`), recorded in the same
torch.profiler session as the card's kernels, copies and runtime calls, on
the same clock. `reduce_spans(events)` takes that session's Chrome trace,
with `trace.REGION` marking the window, and credits

- each device event (kernel, memcpy, memset) to the innermost span open on
  the thread that launched it, at the launch (its `cuda_runtime` or
  `cuda_driver` event, by correlation id). On a thread with no span open
  there (the autograd engine's worker outside `_Recompute`) the owner is the
  innermost span open at that time on the main thread, the one that holds
  the outermost spans; where there is none, or no launch event, `outside`;
- each idle gap (`trace.idle_gaps`) to the owner of the event that ends it;
  the gap at the window's end, which no event ends, to the innermost main
  thread span open at its start;
- each blocking runtime call (`SYNCS`) to the span open at the call, as a
  launch is.

It returns a table keyed by span name, with `outside`: `count`, `wall_ms`,
`self_ms` (the wall less the union of its direct children on its thread),
`busy_ms` (the owned device events' durations within the window),
`idle_ms`, `launches` (kernels), `syncs`, `h2d_bytes`, and `subtree`, the
owned figures over the span and its descendants (a span that opens a
thread's stack elsewhere than on the main thread descends from the main
thread's span open at its start). `outside` adds `unlinked`, the device
events with no launch event. The split is exact: summed over the rows, busy
is the device events' summed durations and idle the window less their
union. `READINGS` names the per-layer readings the table gives, a step or a
request (`reading`).

    python3 -m portbench.spans --workload <cell> --seed <n> --seconds <s>

runs a cell as `portbench.run --trace 1` does, with the window's trace also
reduced to this table, and prints the table a step or request to standard
error and the result line with a `spans` entry: the readings, and checks of
the span count and the partition.
"""
from __future__ import annotations

import bisect
import sys
from typing import Dict, List, Optional

from .trace import DEVICE_CATS, REGION, idle_gaps, union_length

PREFIXES = ("serve.", "train.", "model.", "data.")
OUTSIDE = "outside"
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")     # a runtime event wins a shared id
SYNCS = ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize",
         "cudaMemcpy")
OWNED = ("busy_ms", "idle_ms", "launches", "syncs", "h2d_bytes")
# the span that a step or a request is, by the reading's suffix
UNIT = {"train": "train.step", "serve": "serve.request"}
# reading: (row, or every row under a prefix ending in ".", figure, over the subtree)
READINGS = {
    "pipeline_ms.train": ("data.pipeline", "wall_ms", False),
    "pipeline_idle_ms.train": ("data.pipeline", "idle_ms", True),
    "backward_ms.train": ("train.backward", "busy_ms", True),
    "recompute_ms.train": ("train.recompute.", "busy_ms", False),
    "backward_idle_ms.train": ("train.backward", "idle_ms", True),
    "optim_ms.train": ("train.optim", "wall_ms", False),
    "host_syncs.train": ("train.step", "syncs", True),
    "host_syncs.serve": ("serve.request", "syncs", True),
    "head_ms.serve": ("model.head", "busy_ms", True),
}


class Span:
    __slots__ = ("name", "tid", "ts", "end", "parent", "children", "up")

    def __init__(self, e: dict):
        self.name, self.tid = e["name"], e["tid"]
        self.ts, self.end = e["ts"], e["ts"] + e["dur"]
        self.parent: Optional[Span] = None
        self.children: List[Span] = []
        self.up: tuple = ()              # distinct names of the span and its ancestors


class Spans:
    """The program's spans of one window, nested on each thread; `at(tid, t)`
    is the innermost span open on thread tid at t (None if none)."""

    def __init__(self, events: List[dict], lo: float, hi: float):
        by_tid: Dict[object, List[Span]] = {}
        for e in events:
            if (e.get("cat") == "user_annotation" and e.get("ph") == "X"
                    and e["name"].startswith(PREFIXES) and lo <= e["ts"] < hi):
                by_tid.setdefault(e["tid"], []).append(Span(e))
        self.all: List[Span] = []
        self._segs = {}
        roots_wall = {}
        for tid, spans in by_tid.items():
            spans.sort(key=lambda s: (s.ts, -s.end))
            stack, roots = [], []
            for s in spans:
                while stack and stack[-1].end <= s.ts:
                    stack.pop()
                if stack:
                    s.parent = stack[-1]
                    stack[-1].children.append(s)
                else:
                    roots.append(s)
                stack.append(s)
            segs: list = []
            for r in roots:
                self._flatten(r, segs)
            self._segs[tid] = ([g[0] for g in segs], segs)
            roots_wall[tid] = sum(r.end - r.ts for r in roots)
            self.all += spans
        self.main = max(roots_wall, key=roots_wall.get) if roots_wall else None
        for s in self.all:
            self._ancestry(s)

    @classmethod
    def _flatten(cls, s: Span, out: list):
        """[start, end) pieces of s's time, each with the innermost span."""
        cur = s.ts
        for c in s.children:
            if c.ts > cur:
                out.append((cur, c.ts, s))
            cls._flatten(c, out)
            cur = max(cur, c.end)
        if cur < s.end:
            out.append((cur, s.end, s))

    def _on(self, tid, t) -> Optional[Span]:
        starts, segs = self._segs.get(tid, ((), ()))
        i = bisect.bisect_right(starts, t) - 1
        return segs[i][2] if i >= 0 and t < segs[i][1] else None

    def at(self, tid, t) -> Optional[Span]:
        """The owner of work started on thread tid at t: its innermost span,
        else the main thread's."""
        s = self._on(tid, t)
        return s if s is not None or tid == self.main else self._on(self.main, t)

    def _ancestry(self, s: Span) -> tuple:
        if not s.up:
            above = s.parent
            if above is None and s.tid != self.main:
                above = self._on(self.main, s.ts)
            names = self._ancestry(above) if above is not None else ()
            s.up = (s.name,) + tuple(n for n in names if n != s.name)
        return s.up


def _row() -> dict:
    return {"count": 0, "wall_ms": 0.0, "self_ms": 0.0, **{k: 0 for k in OWNED},
            "subtree": {k: 0 for k in OWNED}}


def reduce_spans(events: List[dict]) -> Dict[str, dict]:
    """The table of the window's spans (module docstring)."""
    region = [e for e in events if e.get("name") == REGION and e.get("cat") == "user_annotation"]
    if not region:
        raise RuntimeError(f"the trace holds no '{REGION}' region")
    lo = region[0]["ts"]
    hi = lo + region[0]["dur"]
    spans = Spans(events, lo, hi)
    rows: Dict[str, dict] = {OUTSIDE: _row()}
    rows[OUTSIDE]["unlinked"] = 0
    for s in spans.all:
        r = rows.setdefault(s.name, _row())
        r["count"] += 1
        r["wall_ms"] += (s.end - s.ts) * 1e-3
        kids = union_length([(c.ts, c.end) for c in s.children], s.ts, s.end)
        r["self_ms"] += (s.end - s.ts - kids) * 1e-3

    def credit(owner: Optional[Span], key: str, amount):
        names = owner.up if owner is not None else (OUTSIDE,)
        rows[names[0]][key] += amount           # up[0] is the span's own name
        for n in names:
            rows[n]["subtree"][key] += amount

    launch = {}
    for e in events:
        if e.get("cat") in LAUNCH_CATS and "correlation" in e.get("args", {}):
            corr = e["args"]["correlation"]
            if e["cat"] == "cuda_runtime" or corr not in launch:
                launch[corr] = e
    dev = [e for e in events if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS
           and e["ts"] < hi and e["ts"] + e["dur"] > lo]
    owner_of = {}
    for e in dev:
        call = launch.get(e.get("args", {}).get("correlation"))
        owner = spans.at(call["tid"], call["ts"]) if call is not None else None
        if call is None:
            rows[OUTSIDE]["unlinked"] += 1
        owner_of[id(e)] = owner
        credit(owner, "busy_ms", (min(e["ts"] + e["dur"], hi) - max(e["ts"], lo)) * 1e-3)
        if e["cat"] == "kernel":
            credit(owner, "launches", 1)
        elif e["cat"] == "gpu_memcpy" and "HtoD" in e["name"]:
            credit(owner, "h2d_bytes", int(e.get("args", {}).get("bytes", 0)))
    for s, t, ev in idle_gaps(dev, lo, hi):
        owner = owner_of[id(ev)] if ev is not None else spans.at(spans.main, s)
        credit(owner, "idle_ms", (t - s) * 1e-3)
    for e in events:
        if (e.get("cat") == "cuda_runtime" and e.get("name") in SYNCS
                and lo <= e["ts"] < hi):
            credit(spans.at(e["tid"], e["ts"]), "syncs", 1)
    return rows


def reading(table: Dict[str, dict], name: str, count: int) -> Optional[float]:
    """Reading `name` of `READINGS` a step or request, over the table of a
    window of `count` steps or requests; None where the window's count of
    `train.step` or `serve.request` spans is not `count`."""
    row, figure, subtree = READINGS[name]
    n = table.get(UNIT[name.rsplit(".", 1)[1]], {}).get("count", 0)
    if n == 0 or n != count:
        return None
    rows = ([r for k, r in table.items() if k.startswith(row)] if row.endswith(".")
            else [table[row]] if row in table else [])
    return sum((r["subtree"] if subtree else r)[figure] for r in rows) / n


def lines(table: Dict[str, dict], n: int) -> List[str]:
    """The table a step or request, one line a span name, by wall."""
    cols = ("count", "wall_ms", "self_ms", "busy_ms", "idle_ms", "launches", "syncs")
    out = ["span " + " ".join(cols) + " h2d_MB | subtree busy_ms idle_ms launches syncs"]
    for k, r in sorted(table.items(), key=lambda kv: -kv[1]["wall_ms"]):
        sub = r["subtree"]
        out.append(f"{k} " + " ".join(f"{r[c] / n:.3f}" for c in cols)
                   + f" {r['h2d_bytes'] / n / 1e6:.3f} | {sub['busy_ms'] / n:.3f} "
                   f"{sub['idle_ms'] / n:.3f} {sub['launches'] / n:.1f} {sub['syncs'] / n:.1f}")
    return out


def partition_error_us(table: Dict[str, dict], events: List[dict], window_s: float,
                       busy_s: float) -> tuple:
    """(|summed busy - the device events' summed durations in the window|,
    |summed idle - (window - busy)|), in us."""
    region = next(e for e in events if e.get("name") == REGION
                  and e.get("cat") == "user_annotation")
    lo, hi = region["ts"], region["ts"] + region["dur"]
    durs = sum(min(e["ts"] + e["dur"], hi) - max(e["ts"], lo) for e in events
               if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS
               and e["ts"] < hi and e["ts"] + e["dur"] > lo)
    busy = sum(r["busy_ms"] for r in table.values()) * 1e3
    idle = sum(r["idle_ms"] for r in table.values()) * 1e3
    return abs(busy - durs), abs(idle - (window_s - busy_s) * 1e6)


def cu_launch_gaps_s(events: List[dict]) -> float:
    """Seconds of the window's idle gaps that end at a device event launched
    by `cuLaunchKernel` (a `cuda_driver` event, no `cuda_runtime` one), as
    cuBLASLt launches: `trace.reduce_trace` names those `_window_end_`."""
    region = next(e for e in events if e.get("name") == REGION
                  and e.get("cat") == "user_annotation")
    lo, hi = region["ts"], region["ts"] + region["dur"]
    runtime = {e["args"]["correlation"] for e in events
               if e.get("cat") == "cuda_runtime" and "correlation" in e.get("args", {})}
    cu = {e["args"]["correlation"] for e in events
          if e.get("cat") == "cuda_driver" and "correlation" in e.get("args", {})}
    dev = [e for e in events if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS
           and e["ts"] < hi and e["ts"] + e["dur"] > lo]
    return sum(t - s for s, t, ev in idle_gaps(dev, lo, hi) if ev is not None
               and ev.get("args", {}).get("correlation") in cu - runtime) * 1e-6


def main(argv=None) -> int:
    """`portbench.run` with the window's trace also reduced to the span table."""
    from . import run, trace

    reduce_trace, result = trace.reduce_trace, run.result

    def with_spans(events):
        out = reduce_trace(events)
        out["spans"] = reduce_spans(events)
        out["partition_error_us"] = partition_error_us(out["spans"], events, out["window_s"],
                                                       out["busy_s"])
        out["cu_launch_gaps_s"] = cu_launch_gaps_s(events)
        return out

    def with_table(reg, args, r, *rest):
        out = result(reg, args, r, *rest)
        if r.trace is None:
            return out
        table, n = r.trace["spans"], r.trace["count"]
        unit = UNIT[r.mode]
        step = table.get(unit, {"wall_ms": 0.0})
        cover = sum(table[k]["wall_ms"] for k in ("train.cast", "train.loss", "train.backward",
                                                  "train.optim") if k in table)
        print("\n".join(lines(table, n)), file=sys.stderr)
        out["spans"] = {
            "per": n, "unit_spans": table.get(unit, {}).get("count", 0),
            "readings": {k: reading(table, k, n) for k in READINGS
                         if k.endswith("." + r.mode)},
            "partition_error_us": list(r.trace["partition_error_us"]),
            "step_cover": cover / step["wall_ms"] if r.mode == "train" and step["wall_ms"]
            else None,
            "wall_ms_per": r.trace["window_s"] * 1e3 / n,
            "cu_launch_gaps_ms_per": r.trace["cu_launch_gaps_s"] * 1e3 / n,
            "rows": {k: {c: v / n for c, v in row.items() if c != "subtree"}
                     for k, row in table.items()}}
        return out

    trace.reduce_trace, run.result = with_spans, with_table
    argv = list(sys.argv[1:] if argv is None else argv)
    return run.main(argv + ["--trace", "1"])


if __name__ == "__main__":
    sys.exit(main())
