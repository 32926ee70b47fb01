"""A configuration, a traffic mix and a metric are added by adding files: the
registry finds them by name, and a run reports the new metric."""
from __future__ import annotations

import json
import time

import pytest

from portbench.registry import ROOT, Registry


def test_every_cell_of_the_benchmark_resolves():
    reg = Registry(ROOT.parent / "BENCHMARK.json")
    for w in reg.bench["workloads"]:
        c = reg.config(w["config"])
        mix = reg.traffic(w["traffic"])
        assert reg.family(c["family"]).count(c, mix["batch"], mix["mode"] == "train").fwd > 0
        assert w["name"] == f"{w['config']}.{w['traffic']}"
        for kind in ("end_to_end", "per_layer"):
            for m in reg.metrics_of(w["name"], kind):
                assert callable(reg.reader(m["name"]).read)
    for m in reg.bench["per_layer"]:
        e2e = {e["name"]: e for e in reg.bench["end_to_end"]}[m["moves"]]
        assert set(m["workloads"]) <= set(e2e.get("workloads", m["workloads"]))


def test_files_added_in_a_new_root_are_found_and_reported(tiny_root, tmp_path):
    import shutil
    root = tmp_path / "bench"
    shutil.copytree(tiny_root, root)
    c = json.loads((root / "configs" / "tiny_clip.json").read_text())
    c["model"]["layers"] = 1
    (root / "configs" / "tiny_clip_one_layer.json").write_text(json.dumps(c))
    mix = json.loads((root / "traffic" / "tiny_clip_serve.json").read_text())
    mix["batch"] = 3
    (root / "traffic" / "three_clips.json").write_text(json.dumps(mix))
    (root / "metrics" / "requests.serve.py").write_text(
        '"""Requests completed in the window."""\n\n\ndef read(run):\n'
        '    return run.requests if run.mode == "serve" else None\n')
    bench = json.loads((root / "BENCHMARK.json").read_text())
    name = "tiny_clip_one_layer.three_clips"
    bench["workloads"].append({"name": name, "config": "tiny_clip_one_layer",
                               "traffic": "three_clips", "chips": 1, "why": "added"})
    bench["per_layer"].append({"name": "requests.serve", "unit": "count", "better": "higher",
                               "source": "host_clock", "layer": "serving",
                               "moves": "serve_clips_per_s", "workloads": [name]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))

    from portbench.harness import run_cell
    reg = Registry(root / "BENCHMARK.json", root)
    assert reg.config("tiny_clip_one_layer")["model"]["layers"] == 1
    assert [m["name"] for m in reg.metrics_of(name, "per_layer")][-1] == "requests.serve"
    run = run_cell(reg, name, 12345, 0.2, False, "cpu", time.time())
    assert run.batch == 3 and run.requests >= 1
    assert reg.reader("requests.serve").read(run) == run.requests
    assert all(v <= lim for v, lim in run.checks.values()), run.checks


def test_a_cell_not_in_the_benchmark_is_refused(tiny_reg):
    with pytest.raises(KeyError):
        tiny_reg.cell("no_such.cell")
