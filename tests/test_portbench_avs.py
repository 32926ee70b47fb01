"""The benchmark's AVSBench S4 configuration (`portbench/configs/
swin_large_avs_fusion.json`, family `swin_avs`) at small widths on the CPU.

A tiny copy of the configuration keeps all four Swin stages and every
decoder stage (img 64, window 4, T = 2, decoder channel 64) in a temporary
benchmark root. What decides `correct`:
- the port's float32 AVS server (`MultiTaskServer.add_avs`) equals the plain
  reference `portbench/reference/swin_avs.py` (1e-4 of the masks' spread
  over the rows; float32 reassociation reads ~1e-5);
- the sound bf16 run is correct, and a run with a mask altered in `predict`
  or with every TPAVI block skipped is not. As in the configuration, the
  largest error is the one limit; the tiny one sits between the bf16 run's
  reading (0.09 at this seed) and the fp8 control's (1.0);
- the TPAVI BatchNorms' running statistics, which the family sets, reach
  the served masks.
The reference imports nothing of the program or of JAX, and the family's
operation count matches torch's FlopCounterMode over the reference, with
TPAVI computed as the port computes it.
"""
from __future__ import annotations

import json
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from portbench import weights
from portbench.harness import build_model, leaf_shapes, run_cell
from portbench.reference import swin_avs as ref
from stgcma_tpu_torch import serving
from stgcma_tpu_torch.models import avs as avs_model
from stgcma_tpu_torch.nn.tpavi import TPAVI, tpavi_apply

torch.set_num_threads(2)
ROOT = Path(__file__).resolve().parents[1]
SEED = 2 ** 31 + 11      # past 32 signed bits, as the benchmark's seeds may be
CELL = "tiny_avs.serve"
LIMITS = {"serve": {"logit_err_max": 0.3}}


def _shrink(c: dict) -> dict:
    c["model"].update(embed_dim=16, depths=[2, 2, 2, 2], num_heads=[2, 2, 4, 4], img_size=64,
                      window_size=4, num_frames=2, adapter_ratios=[0.25] * 4)
    c["head"].update(channel=64, vis_dim=[16, 16, 32, 32], stage_dims=[16, 32, 64, 128],
                     stage_resolutions=[16, 8, 4, 2], audio_dim=128, tpavi_audio_dim=16,
                     num_frames=2)
    c["limits"] = LIMITS
    return c


@pytest.fixture(scope="module")
def tiny_root(tmp_path_factory) -> Path:
    """A benchmark root with the real metric readers and one cell: the
    AVS configuration and its mix, shrunk."""
    src = ROOT / "portbench"
    root = tmp_path_factory.mktemp("tiny_avs_bench")
    shutil.copytree(src / "metrics", root / "metrics")
    (root / "configs").mkdir()
    (root / "traffic").mkdir()
    c = _shrink(json.loads((src / "configs" / "swin_large_avs_fusion.json").read_text()))
    (root / "configs" / "tiny_avs.json").write_text(json.dumps(c))
    mix = json.loads((src / "traffic" / "serve_s4_b8.json").read_text())
    mix.update(batch=2, ref_chunk=1, pool=4)
    mix["inputs"]["a"]["shape"] = ["B", 2, 64, 64]
    mix["inputs"]["v"]["shape"] = ["B", 2, 64, 64, 3]
    (root / "traffic" / "tiny_avs_serve.json").write_text(json.dumps(mix))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    bench["workloads"] = [{"name": CELL, "config": "tiny_avs", "traffic": "tiny_avs_serve",
                           "chips": 1, "why": "a CPU test"}]
    for m in bench["end_to_end"] + bench["per_layer"]:
        m.pop("workloads", None)
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root


@pytest.fixture(scope="module")
def reg(tiny_root):
    from portbench.registry import Registry
    return Registry(tiny_root / "BENCHMARK.json", tiny_root)


def _run(reg, dtype=torch.bfloat16, control=None):
    return run_cell(reg, CELL, SEED, 0.2, False, "cpu", time.time(), control, dtype)


def _correct(run):
    return all(v <= lim for v, lim in run.checks.values())


def test_served_float32_program_equals_the_reference(reg):
    run = _run(reg, torch.float32)
    assert run.readings["logit_err_max"] < 1e-4, run.readings
    assert run.readings["logit_err_rms"] < 1e-4, run.readings
    assert run.checks["served_off_dtype"][0] == 0


def test_sound_bf16_run_is_correct(reg):
    run = _run(reg)
    assert _correct(run), run.checks


def test_fp8_control_is_not_correct(reg):
    assert not _correct(_run(reg, control="fp8"))


def _one_mask_altered(out):
    out[0] = out[0][::-1]
    return out


def _tpavi_skipped(monkeypatch):
    monkeypatch.setattr(avs_model, "tpavi_apply", lambda p, x, audio, train=False:
                        (x, None, None))


@pytest.mark.parametrize("fault", ["mask_altered", "tpavi_skipped"])
def test_broken_serving_is_not_correct(reg, monkeypatch, fault):
    if fault == "mask_altered":
        real = serving.MultiTaskServer.predict
        monkeypatch.setattr(serving.MultiTaskServer, "predict",
                            lambda self, task, batch: _one_mask_altered(
                                real(self, task, batch).copy()))
    else:
        _tpavi_skipped(monkeypatch)
    assert not _correct(_run(reg))


def test_the_int8_tower_is_refused(reg):
    with pytest.raises(NotImplementedError):
        _run(reg, control="int8_tower")


def _served(reg, c, W, batch):
    fam = reg.family(c["family"])
    server = serving.MultiTaskServer(dtype=torch.float32, device="cpu")
    task = fam.serve(server, build_model(fam, c, W), c)
    return server.predict(task, batch)


def test_running_statistics_move_the_served_masks(reg):
    c = reg.config("tiny_avs")
    fam = reg.family("swin_avs")
    W = weights.draw(leaf_shapes(fam, c), SEED, "cpu", tuple(c["fan_in_uniform"]))
    g = torch.Generator().manual_seed(0)
    batch = {"a": torch.randn(2, 2, 64, 64, generator=g) * 0.5,
             "v": torch.randn(2, 2, 64, 64, 3, generator=g)}
    out = _served(reg, c, W, batch)
    fresh = dict(c, tpavi_bn={"mean": 0.0, "var": 1.0})
    moved = _served(reg, fresh, W, batch)
    with torch.no_grad():
        want = fam.ref_serve(W, fresh, batch).numpy()
    np.testing.assert_allclose(moved, want, rtol=0, atol=1e-4 * np.abs(want).max())
    spread = np.abs(out - out.mean(axis=0)).max()
    assert np.abs(moved - out).max() > 0.2 * spread
    assert not any(k.endswith(("running_mean", "running_var"))
                   for k in fam.new_model(c).state_dict())


def test_reference_imports_neither_the_program_nor_jax():
    code = ("import sys; import portbench.reference.swin_avs; "
            "print(sorted(m for m in sys.modules if m.split('.')[0] in "
            "('stgcma_tpu_torch', 'stgcma_tpu', 'jax', 'jaxlib', 'flax')))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         timeout=120, check=True)
    assert out.stdout.strip() == "[]", out.stdout


def _port_tpavi(W, p, x, audio, T):
    """`ref.tpavi` computed by the port's `tpavi_apply` (float32)."""
    BT, C, H, W_ = x.shape
    m = TPAVI(C, audio.shape[-1])
    m.load_state_dict({k[len(p) + 1:]: v for k, v in W.items() if k.startswith(p + ".")})
    z, _, _ = tpavi_apply(m, x.reshape(BT // T, T, C, H, W_).permute(0, 1, 3, 4, 2), audio)
    return z.permute(0, 1, 4, 2, 3).reshape(BT, C, H, W_)


def test_count_matches_the_counter(reg, monkeypatch):
    c = reg.config("tiny_avs")
    fam = reg.family("swin_avs")
    m, h, B = c["model"], c["head"], 2
    T, S = m["num_frames"], m["img_size"]
    W = weights.draw(leaf_shapes(fam, c), 7, "cpu") | fam.bn_stats(c)
    g = torch.Generator().manual_seed(1)
    a, v = torch.randn(B, T, S, S, generator=g), torch.randn(B, T, S, S, 3, generator=g)
    with torch.no_grad():
        published = ref.serve(W, m, h, a, v)
        monkeypatch.setattr(ref, "tpavi", _port_tpavi)
        with FlopCounterMode(display=False) as fc:
            ported = ref.serve(W, m, h, a, v)
    torch.testing.assert_close(ported, published, rtol=0, atol=1e-5 * published.abs().max())
    assert fam.count(c, B, False).fwd == fc.get_total_flops()
