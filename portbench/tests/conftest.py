"""CPU tests of the benchmark, and its card tests (marked `card`), which skip
where no CUDA device is present. Run from the root of the checkout:

    python -m pytest portbench/tests -q                # here: the card tests skip
    python -m pytest portbench/tests -q -m card        # on the card
"""
from __future__ import annotations

import json
import shutil
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA device; skips without one")


@pytest.fixture
def card():
    """The CUDA device; the test skips where there is none (decided here, at
    run time, never at import)."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _shrink_clip(c: dict) -> dict:
    c["model"].update(embed_dim=32, layers=2, heads=4, input_resolution=32, num_frames=2,
                      audio_fdim=64, audio_tdim=48, adapter_ratio=0.25)
    c["fbank"].update(bins=64, target=48)
    return c


def _shrink_swin(c: dict) -> dict:
    c["model"].update(embed_dim=16, depths=[2, 2], num_heads=[2, 4], img_size=56, num_frames=2,
                      adapter_ratios=[0.25, 0.25])
    c["head"].update(feat_dim=32, qst_word_embed=32, qst_hidden=32, num_frames=2)
    c["fbank"].update(bins=56, target=56)
    return c


TINY_LIMITS = {"serve": {"logit_err_max": 0.05, "logit_err_rms": 0.05},
               "train": {"loss_gap": 0.02, "grad_gap": 0.1, "update_gap": 0.1}}

# tiny cells: name -> (config file, its shrink, traffic file, its new input shapes)
TINY = {
    "tiny_clip.serve": ("clip_b16_ave29_fusion", _shrink_clip, "serve_b32",
                        {"v": ["B", 2, 32, 32, 3], "a": ["B", 2, 48, 64]}),
    "tiny_swin.serve": ("swin_large_avqa_fusion", _shrink_swin, "serve_b8",
                        {"v": ["B", 2, 56, 56, 3], "a": ["B", 2, 56, 56]}),
    "tiny_clip.train": ("clip_b16_ave29_fusion", _shrink_clip, "train_b32",
                        {"frames": ["B", 2, 32, 32, 3], "wave": ["B", 2, 16000],
                         "labels": ["B", 2, 29]}),
    "tiny_swin.train": ("swin_large_avqa_fusion", _shrink_swin, "train_b8",
                        {"frames": ["B", 2, 56, 56, 3], "frames_nega": ["B", 2, 56, 56, 3],
                         "wave": ["B", 2, 16000]}),
}


@pytest.fixture(scope="session")
def tiny_root(tmp_path_factory) -> Path:
    """A benchmark root with the real metric readers and tiny copies of the
    real configurations and mixes (widths and batch shrunk, limits loose),
    one cell each."""
    src = ROOT / "portbench"
    root = tmp_path_factory.mktemp("tiny_bench")
    shutil.copytree(src / "metrics", root / "metrics")
    (root / "configs").mkdir()
    (root / "traffic").mkdir()
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    bench["workloads"] = []
    for cell, (cname, shrink, tname, shapes) in TINY.items():
        conf, mix = cell.split(".")
        c = shrink(json.loads((src / "configs" / f"{cname}.json").read_text()))
        c["limits"] = TINY_LIMITS
        (root / "configs" / f"{conf}.json").write_text(json.dumps(c))
        m = json.loads((src / "traffic" / f"{tname}.json").read_text())
        m.update(batch=2, ref_chunk=1, pool=4)
        for k, s in shapes.items():
            m["inputs"][k]["shape"] = s
        (root / "traffic" / f"{conf}_{mix}.json").write_text(json.dumps(m))
        bench["workloads"].append({"name": cell, "config": conf, "traffic": f"{conf}_{mix}",
                                   "chips": 1, "why": "a CPU test"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        m.pop("workloads", None)
    if not any(m["name"] == "train_clips_per_s" for m in bench["end_to_end"]):
        bench["end_to_end"].append({"name": "train_clips_per_s", "unit": "clips/s",
                                    "better": "higher", "bound": 0.05, "source": "host_clock"})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root


@pytest.fixture(scope="session")
def tiny_reg(tiny_root):
    from portbench.registry import Registry
    return Registry(tiny_root / "BENCHMARK.json", tiny_root)
