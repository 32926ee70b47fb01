"""What decides `correct`, at small widths on the CPU.

- The program in float32 equals the plain reference: the reference
  computes the same functions (serving and the training step, with the
  program's draws made again).
- A run with its timed path broken underneath comes out not correct: an
  answer altered where it is produced, half of the batch left out, and for
  training a step that returns its state unchanged. The sound bf16 run of
  the same cell comes out correct.
- A served copy that departs from the configuration's dtype (the program's
  own int8 tower) comes out not correct.
- A training cell's checked steps take the rates of the CLI's warm-up.
"""
from __future__ import annotations

import time

import numpy as np
import pytest
import torch

from portbench.harness import lr_tables, run_cell
from portbench.reference.train import warmup_scale
from stgcma_tpu_torch import serving
from stgcma_tpu_torch.train import optim

SEED = 2 ** 31 + 11      # past 32 signed bits, as the benchmark's seeds may be


def _run(reg, cell, dtype=torch.bfloat16, control=None):
    return run_cell(reg, cell, SEED, 0.2, False, "cpu", time.time(), control, dtype)


def _correct(run):
    return all(v <= lim for v, lim in run.checks.values())


@pytest.mark.parametrize("cell", ["tiny_clip.serve", "tiny_swin.serve"])
def test_served_float32_program_equals_the_reference(tiny_reg, cell):
    run = _run(tiny_reg, cell, torch.float32)
    assert run.checks["logit_err_max"][0] < 1e-4, run.checks
    assert run.checks["logit_err_rms"][0] < 1e-4, run.checks


@pytest.mark.parametrize("cell", ["tiny_clip.train", "tiny_swin.train"])
def test_trained_float32_program_equals_the_reference(tiny_reg, cell):
    run = _run(tiny_reg, cell, torch.float32)
    assert run.train_leaves_match
    for k in ("loss_gap", "grad_gap", "update_gap"):
        assert run.checks[k][0] < 1e-3, (k, run.checks, run.worst_leaves)


@pytest.mark.parametrize("cell", ["tiny_clip.serve", "tiny_swin.serve", "tiny_clip.train"])
def test_sound_bf16_run_is_correct(tiny_reg, cell):
    run = _run(tiny_reg, cell)
    assert _correct(run), run.checks


def _break_predict(monkeypatch, alter):
    real = serving.MultiTaskServer.predict

    def predict(self, task, batch):
        return alter(real(self, task, batch).copy())
    monkeypatch.setattr(serving.MultiTaskServer, "predict", predict)


def _one_answer_altered(out):
    out[0] = out[0][::-1]
    return out


def _half_the_batch(out):
    half = len(out) // 2
    out[half:] = out[:len(out) - half]
    return out


@pytest.mark.parametrize("fault", [_one_answer_altered, _half_the_batch])
@pytest.mark.parametrize("cell", ["tiny_clip.serve", "tiny_swin.serve"])
def test_broken_serving_is_not_correct(tiny_reg, monkeypatch, cell, fault):
    _break_predict(monkeypatch, fault)
    assert not _correct(_run(tiny_reg, cell))


def test_training_step_that_keeps_its_state_is_not_correct(tiny_reg, monkeypatch):
    monkeypatch.setattr(optim.Optimizer, "step", lambda self: None)
    run = _run(tiny_reg, "tiny_clip.train")
    assert run.checks["update_gap"][0] == pytest.approx(1.0)
    assert not _correct(run)


def _wrap_loss(monkeypatch, fam, wrap):
    real = fam.loss_fn

    def loss_fn(c, device, dtype=torch.bfloat16):
        return wrap(real(c, device, dtype))
    monkeypatch.setattr(fam, "loss_fn", loss_fn)


def test_training_on_half_the_batch_is_not_correct(tiny_reg, monkeypatch):
    def half(fn):
        return lambda m, batch, g: fn(m, {k: v[:len(v) // 2] for k, v in batch.items()}, g)
    _wrap_loss(monkeypatch, tiny_reg.family("clip_ave"), half)
    assert not _correct(_run(tiny_reg, "tiny_clip.train"))


def test_training_loss_altered_where_produced_is_not_correct(tiny_reg, monkeypatch):
    def doubled(fn):
        def f(m, batch, g):
            loss, aux = fn(m, batch, g)
            return 2.0 * loss, aux
        return f
    _wrap_loss(monkeypatch, tiny_reg.family("clip_ave"), doubled)
    assert not _correct(_run(tiny_reg, "tiny_clip.train"))


def test_the_sample_compared_is_drawn_from_the_seed(tiny_reg, monkeypatch):
    seen = []
    real = np.random.default_rng

    def rng(seed):
        seen.append(seed)
        return real(seed)
    monkeypatch.setattr(np.random, "default_rng", rng)
    _run(tiny_reg, "tiny_clip.serve")
    assert seen == [SEED]


@pytest.mark.parametrize("cell", ["tiny_clip.serve", "tiny_swin.serve"])
def test_served_int8_tower_is_not_correct(tiny_reg, cell):
    sound, int8 = _run(tiny_reg, cell), _run(tiny_reg, cell, control="int8_tower")
    assert sound.checks["served_off_dtype"][0] == 0
    assert int8.checks["served_off_dtype"][0] > 0
    assert not _correct(int8)


def test_checked_steps_take_the_clis_warm_up_rates(tiny_reg):
    t = tiny_reg.config("tiny_clip")["train"]
    adapt, head = lr_tables(t)
    scale = warmup_scale(t, 3)
    assert scale[0] == 0.0 and 0.0 < scale[1] < scale[2] < 1e-2
    np.testing.assert_allclose(adapt[:3], [t["lr"] * k for k in scale], rtol=1e-6)
    np.testing.assert_allclose(head[:3], [t["lr"] * t["head_lr_mult"] * k for k in scale],
                               rtol=1e-6)
