"""The readings that a cell's limits are set from: the numbers compared, for
the program as configured and for its control, seed after seed in one
process (the kernels built once). Prints one JSON line a run.

    python3 -m portbench.calibrate --workload <name> --seeds 12 --controls 3 --seconds 2

`--controls` runs of the fp8 control, for a serving cell `--tower` runs of
the program's own int8 tower, and for a training cell `--faults` runs of
each planted fault (`harness.CONTROLS`), follow the program's, on the same
seeds.

The limits themselves are set by hand, in the configuration's file, from
these readings (`PERF.md` gives them).
"""
from __future__ import annotations

import argparse
import json
import sys
import time

from portbench.run import CHECKOUT, T_START  # noqa: F401  (sets the cache directories)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, default=12)
    p.add_argument("--controls", type=int, default=3)
    p.add_argument("--first-seed", type=int, default=4_000_000_000)
    p.add_argument("--tower", type=int, default=0)
    p.add_argument("--faults", type=int, default=0)
    p.add_argument("--seconds", type=float, default=2.0)
    args = p.parse_args(argv)
    import torch

    from portbench.harness import run_cell
    from portbench.registry import Registry
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    reg = Registry(CHECKOUT / "BENCHMARK.json")
    plan = ([(None, i) for i in range(args.seeds)] + [("fp8", i) for i in range(args.controls)]
            + [("int8_tower", i) for i in range(args.tower)]
            + [(f, i) for f in ("half", "frozen") for i in range(args.faults)])
    for control, i in plan:
        seed = args.first_seed + i
        t0 = time.time()
        run = run_cell(reg, args.workload, seed, args.seconds, False, "cuda", t0, control)
        rec = {"workload": args.workload, "seed": seed, "control": control,
               "checks": run.readings,
               "seconds": round(time.time() - t0, 1)}
        for k in ("prog_losses", "ref_losses", "worst_leaves", "still_leaves"):
            if hasattr(run, k):
                rec[k] = getattr(run, k)
        print(json.dumps(rec), flush=True)
        del run
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
