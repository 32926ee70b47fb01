"""On the card: each cell's control, the configuration's next lower
precision in the program's place, comes out not correct at the cell's own
size, on three seeds, and so does a serving cell's program with its own
int8 tower; the program as configured comes out correct on them. Run from the root of a checkout on a machine with an H100:

    python -m pytest portbench/tests/test_portbench_card.py -q -m card
"""
from __future__ import annotations

import time

import pytest

from portbench.registry import ROOT, Registry

SEEDS = (3_000_000_001, 3_000_000_002, 3_000_000_003)


def _cells():
    import json
    bench = json.loads((ROOT.parent / "BENCHMARK.json").read_text())
    return [w["name"] for w in bench["workloads"]]


@pytest.mark.card
@pytest.mark.parametrize("cell", _cells())
def test_control_fails_and_program_passes_at_the_cells_size(card, cell):
    from portbench.harness import run_cell
    reg = Registry(ROOT.parent / "BENCHMARK.json")
    for seed in SEEDS:
        controls = ("fp8", "int8_tower") if ".serve" in cell else ("fp8",)
        for control in controls:
            ctl = run_cell(reg, cell, seed, 2.0, False, card, time.time(), control=control)
            assert not all(v <= lim for v, lim in ctl.checks.values()), (seed, control, ctl.checks)
        run = run_cell(reg, cell, seed, 2.0, False, card, time.time())
        assert all(v <= lim for v, lim in run.checks.values()), (seed, run.checks)
