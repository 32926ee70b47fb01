"""The analytic operation counts against torch's FlopCounterMode over the
plain reference, forward and training step, at small widths. The
reference is aten ops only, so the counter sees every product."""
from __future__ import annotations

import json

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from portbench import flops, weights
from portbench.reference import clip_ave as ref_clip
from portbench.reference import swin_avqa as ref_swin


def _configs(tiny_root, name):
    return json.loads((tiny_root / "configs" / f"{name}.json").read_text())


def _weights(fam, c, trainable):
    from portbench.harness import leaf_shapes
    W = weights.draw(leaf_shapes(fam, c), 7, "cpu")
    return {n: (t.clone().requires_grad_(True) if trainable(n) else t) for n, t in W.items()}


def _counted(fn):
    with FlopCounterMode(display=False) as fc:
        fn()
    return fc.get_total_flops()


@pytest.mark.parametrize("train", [False, True])
def test_clip_counts_match_the_counter(tiny_root, tiny_reg, train):
    c = _configs(tiny_root, "tiny_clip")
    m, B = c["model"], 2
    T = m["num_frames"]
    trained = (lambda n: n.startswith("mlp_head.") or any(
        p in n for p in c["train"]["adapt_patterns"])) if train else (lambda n: False)
    W = _weights(tiny_reg.family("clip_ave"), c, trained)
    a = torch.randn(B, T, m["audio_tdim"], m["audio_fdim"])
    v = torch.randn(B, T, m["input_resolution"], m["input_resolution"], 3)

    def step():
        out = ref_clip.forward(W, m, a, v)
        if train:
            out.square().mean().backward()
    count = flops.clip_ave(m, B, train)
    assert _counted(step) == count.step_flops
    assert count.bwd > 0 if train else count.bwd == 0


@pytest.mark.parametrize("train", [False, True])
def test_swin_avqa_counts_match_the_counter(tiny_root, tiny_reg, train):
    c = _configs(tiny_root, "tiny_swin")
    m, h, B = c["model"], c["head"], 2
    T, S = m["num_frames"], m["img_size"]
    trained = (lambda n: n.startswith("avqatask.") or any(
        p in n for p in c["train"]["adapt_patterns"])) if train else (lambda n: False)
    W = _weights(tiny_reg.family("swin_avqa"), c, trained)
    a, v, vn = torch.randn(B, T, S, S), torch.randn(B, T, S, S, 3), torch.randn(B, T, S, S, 3)
    q = torch.randint(0, h["vocab_size"], (B, c["question_len"]))
    ans = torch.randint(0, h["answer_dim"], (B,))

    def step():
        if train:
            qa, mt = ref_swin.train_loss_terms(W, m, h, a, v, vn, q, ans, (None, None))
            (qa + mt).backward()
        else:
            ref_swin.serve(W, m, h, a, v, q)
    count = tiny_reg.family("swin_avqa").count(c, B, train)
    assert _counted(step) == count.step_flops

