"""The port's AVE-29 trainer CLI (`stgcma_tpu_torch/cli/run_adapt_ave29.py`)
on the CPU, at `--tiny True` (`swin_tiny_test`, as the JAX CLI's `--tiny`)
with `--synthetic True` and `--device cpu`, where every kernel wrapper runs
its plain version through the recomputing autograd Function.

- `main` writes what the JAX package's tests/test_cli_smoke.py expects of
  the JAX CLI (result.csv, args.json, args.pkl, progress.json whose history
  has no `_stats`, stats_<epoch>.pickle with per-class AP), and the port's
  models/ and state_meta.json; `--resume True` continues from the saved epoch
  without redoing it; `--wa True` and `--skip_frame_agg False` run;
  `python -m` runs it.
- Its flags equal the JAX `parse_args`'s: the same option strings, and the
  same parsed values on tests/test_cli_flag_surface.py's AVE_FLAGS and on
  none, `--device` ("cuda" by default) being the one flag of the port's own;
  with the default device and no card, `main` raises before it trains.
Nothing here compares numbers: the train step's numbers are held to JAX's in
tests/test_torch_port_train.py.
"""
import argparse
import json
import os
import pickle
import subprocess
import sys

import pytest
import torch

from stgcma_tpu.cli import run_adapt_ave29 as jax_cli
from stgcma_tpu_torch.cli import run_adapt_ave29 as cli

from test_cli_flag_surface import AVE_FLAGS, _argv

TINY = ["--synthetic", "True", "--tiny", "True", "--device", "cpu", "--batch_size", "2",
        "--synthetic_n", "4", "--num_workers", "2"]
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_cli_trains_and_writes_what_the_jax_cli_writes(tmp_path):
    exp = str(tmp_path / "exp")
    trainer = cli.main(TINY + ["--n-epochs", "2", "--exp-dir", exp])
    assert [h["epoch"] for h in trainer.history] == [1, 2]
    for name in ("result.csv", "args.json", "args.pkl", "state_meta.json", "models/model.1",
                 "models/model.2", "models/best_model", "state/train_params",
                 "state/opt_state"):
        assert os.path.exists(os.path.join(exp, name)), name
    with open(os.path.join(exp, "progress.json")) as f:
        prog = json.load(f)
    assert prog["history"][0]["epoch"] == 1 and "_stats" not in prog["history"][0]
    with open(os.path.join(exp, "stats_1.pickle"), "rb") as f:
        stats = pickle.load(f)
    assert isinstance(stats, list) and "AP" in stats[0]
    with open(os.path.join(exp, "result.csv")) as f:
        assert f.readline().strip() == "epoch,loss,acc,mAP"
    assert all(torch.isfinite(torch.tensor(h["loss"])) for h in trainer.history)
    steps = trainer.step_losses        # each step's loss; an epoch's mean is its history loss
    assert len(steps) == trainer.global_step and trainer.global_step % 2 == 0
    half = trainer.global_step // 2
    assert [sum(steps[:half]) / half, sum(steps[half:]) / half] == pytest.approx(
        [h["loss"] for h in trainer.history], rel=1e-6)
    # the tiny Swin fusion tower trained on the CPU through the Function
    assert trainer.model.backbone.patch_embed.proj.weight.requires_grad is False
    assert any(p.requires_grad for n, p in trainer.model.named_parameters() if "gate_" in n)


def test_cli_resume_continues_without_redoing_epochs(tmp_path):
    exp = str(tmp_path / "exp_r")
    cli.main(TINY + ["--n-epochs", "1", "--exp-dir", exp])
    t2 = cli.main(TINY + ["--n-epochs", "2", "--resume", "True", "--exp-dir", exp])
    assert [h["epoch"] for h in t2.history] == [1, 2]
    assert t2.global_step == 4


def test_cli_weight_averaging_and_frame_aggregation(tmp_path, capsys):
    exp = str(tmp_path / "exp_wa")
    cli.main(TINY + ["--n-epochs", "2", "--exp-dir", exp, "--wa", "True", "--wa_start", "1",
                     "--wa_end", "2", "--skip_frame_agg", "False", "--mixup", "0.5"])
    out = capsys.readouterr().out
    assert "weight-averaged eval:" in out and "multi-frame acc" in out
    assert os.path.exists(os.path.join(exp, "mul_frame_res.csv"))


def test_cli_runs_as_a_module(tmp_path):
    exp = str(tmp_path / "exp_m")
    env = {**os.environ, "PYTHONPATH": ROOT}
    res = subprocess.run([sys.executable, "-m", "stgcma_tpu_torch.cli.run_adapt_ave29", *TINY,
                          "--n-epochs", "1", "--exp-dir", exp], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]
    assert "epoch 1: loss" in res.stdout
    assert os.path.exists(os.path.join(exp, "state_meta.json"))


def test_cli_defaults_to_the_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["--synthetic", "True", "--tiny", "True", "--exp-dir", str(tmp_path / "e")])


def _parsers(monkeypatch, module, argv):
    seen = []
    real = argparse.ArgumentParser.parse_args

    def spy(self, args=None, namespace=None):
        seen.append(self)
        return real(self, args, namespace)
    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", spy)
    args = module.parse_args(argv)
    return seen[-1], vars(args)


@pytest.mark.parametrize("argv", [[], _argv(AVE_FLAGS)], ids=["defaults", "AVE_FLAGS"])
def test_flag_surface_equals_the_jax_cli(monkeypatch, argv):
    port_parser, port = _parsers(monkeypatch, cli, argv)
    jax_parser, ref = _parsers(monkeypatch, jax_cli, argv)
    options = lambda p: {o for a in p._actions for o in a.option_strings}  # noqa: E731
    assert options(port_parser) - options(jax_parser) == {"--device"}
    assert options(jax_parser) <= options(port_parser)
    assert port.pop("device") == "cuda"
    assert port == ref
