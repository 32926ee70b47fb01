"""Run one cell of the benchmark once and print its result line.

    python3 -m portbench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout that holds `BENCHMARK.json` and `portbench/`.
The last line of standard output is one JSON object: `correct`,
`attempted`, `failed`, `metrics` (the cell's end-to-end metrics with
--trace 0, its per-layer metrics with --trace 1), `device` and, traced,
`breakdown`, then `checks`, each number compared with its limit, which the
last lines of standard error repeat. Exits non-zero with no result where
there is no CUDA device or fewer than the cell needs, or where the process
has loaded JAX, Flax or the JAX package.
"""
from __future__ import annotations

import os
import sys
import time
from pathlib import Path

CHECKOUT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "stgcma_tpu")


def _process_start() -> float:
    """The wall-clock time this process started (Linux /proc), else now."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/stat") as f:
            btime = next(int(l.split()[1]) for l in f if l.startswith("btime"))
        return btime + ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, StopIteration):
        return time.time()


T_START = _process_start()

# every kernel or compiler cache of the run at a fixed place in the checkout
_CACHE = CHECKOUT / "build" / "portbench_cache"
for _var, _sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                   ("TORCHINDUCTOR_CACHE_DIR", "inductor"), ("CUDA_CACHE_PATH", "cuda")):
    os.environ[_var] = str(_CACHE / _sub)


def loaded(names=FORBIDDEN) -> list:
    """Modules of this process whose top-level name is one of `names`."""
    return sorted(m for m in list(sys.modules) if m.split(".")[0] in names)


def reference_is_plain() -> list:
    """Import the reference alone and return any module of the program it
    pulled in (it must pull in none)."""
    before = set(loaded(("stgcma_tpu_torch",)))
    import portbench.reference.clip_ave  # noqa: F401
    import portbench.reference.pipeline  # noqa: F401
    import portbench.reference.swin_avqa  # noqa: F401
    import portbench.reference.train  # noqa: F401
    return sorted(set(loaded(("stgcma_tpu_torch",))) - before)


def parse(argv):
    import argparse
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def result(reg, args, run, device_name: str, count: int) -> dict:
    """The result line's object."""
    kind = "per_layer" if args.trace else "end_to_end"
    metrics = {}
    for m in reg.metrics_of(args.workload, kind):
        v = reg.reader(m["name"]).read(run)
        if v is not None:
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    correct = all(v <= lim for v, lim in run.checks.values())
    attempted = run.requests if run.mode == "serve" else run.steps
    dev = {"platform": "gpu", "kind": device_name, "count": count,
           "memory_peak_bytes": int(run.memory_peak)}
    out = {"correct": bool(correct), "attempted": int(attempted),
           "failed": 0 if correct else int(attempted), "metrics": metrics, "device": dev}
    if args.trace:
        dev["busy_s"] = run.trace["busy_s"]
        dev["window_s"] = run.trace["window_s"]
        out["breakdown"] = {"device_ops": run.trace["device_ops"],
                            "idle_gaps": run.trace["idle_gaps"]}
    out["checks"] = {k: {"value": v, "limit": lim} for k, (v, lim) in run.checks.items()}
    return out


def main(argv=None) -> int:
    import json

    args = parse(argv)
    bench = CHECKOUT / "BENCHMARK.json"
    pulled = reference_is_plain()
    if pulled:
        print(f"the reference loaded the program's modules: {pulled}", file=sys.stderr)
        return 3
    import torch

    from portbench.registry import Registry
    reg = Registry(bench)
    chips = reg.cell(args.workload)["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"{args.workload} needs {chips} CUDA device(s); this machine has {n}",
              file=sys.stderr)
        return 2
    torch.set_num_threads(4)
    from portbench.harness import run_cell
    run = run_cell(reg, args.workload, args.seed, args.seconds, bool(args.trace),
                   "cuda", T_START)
    out = result(reg, args, run, torch.cuda.get_device_name(0), chips)
    bad = loaded()
    if bad:
        print(f"the process loaded JAX or the JAX package: {bad}", file=sys.stderr)
        return 3
    marks = [("process start", T_START)] + run.marks
    print("set-up: " + ", ".join(f"{b[0]} {b[1] - a[1]:.2f} s" for a, b in zip(marks, marks[1:])),
          file=sys.stderr)
    for k, c in out["checks"].items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
