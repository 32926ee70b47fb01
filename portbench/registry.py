"""Everything the harness runs, found by name under one root.

- `BENCHMARK.json` at the root: the cells and the metrics;
- `configs/<name>.json`: a configuration, naming its `family`;
- `traffic/<name>.json`: a traffic mix (`traffic.py` reads it);
- `metrics/<name>.py`: a metric's reader, `read(run) -> number or None`.
A configuration, a mix or a metric is added by adding its file.
"""
from __future__ import annotations

import importlib
import importlib.util
import json
from pathlib import Path
from types import ModuleType

ROOT = Path(__file__).resolve().parent


class Registry:
    def __init__(self, bench_file: Path, root: Path = ROOT):
        self.root = Path(root)
        self.bench = json.loads(Path(bench_file).read_text())

    def cell(self, name: str) -> dict:
        for w in self.bench["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in the benchmark")

    def config(self, name: str) -> dict:
        return json.loads((self.root / "configs" / f"{name}.json").read_text())

    def traffic(self, name: str) -> dict:
        return json.loads((self.root / "traffic" / f"{name}.json").read_text())

    def family(self, name: str) -> ModuleType:
        return importlib.import_module(f"portbench.families.{name}")

    def reader(self, metric: str) -> ModuleType:
        path = self.root / "metrics" / f"{metric}.py"
        spec = importlib.util.spec_from_file_location(f"portbench_metric_{metric}", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod

    def metrics_of(self, cell: str, kind: str) -> list:
        """The `kind` ("end_to_end" or "per_layer") metrics that `cell`
        reports: those that list it, or list no cells, where the cell
        reports the end-to-end metric they move."""
        e2e = [m["name"] for m in self.bench["end_to_end"]
               if "workloads" not in m or cell in m["workloads"]]
        out = []
        for m in self.bench[kind]:
            if "workloads" in m:
                if cell in m["workloads"]:
                    out.append(m)
            elif kind == "end_to_end" or m["moves"] in e2e:
                out.append(m)
        return out
