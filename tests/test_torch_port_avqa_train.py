"""MUSIC-AVQA training in the PyTorch port (stgcma_tpu_torch) against the JAX
package on the CPU, at `--tiny` size (`swin_tiny_test`, T = 2, 56^2, the
CLI's head: feat_dim 32, the 1536-wide question LSTM).

- Two fp32 train steps of `cli/run_adapt_avqa.py::make_loss_fn` (the
  pipeline on the frames and on the negative frames, `apply_avqa(train=True)`,
  `avqa_loss`) through `make_train_step`, against the JAX CLI's `loss_fn`
  (:239-249, the same body over the JAX pipeline) through JAX's
  `make_train_step`, on one live tree (`avqa_from_jax`), the head's
  attention dropout at 0 so that no draw enters: losses within 1e-5
  relative, the step-1 gradients within 1e-4 of each leaf's max |g| plus
  1e-6 of the largest gradient of all, as the AVS steps are held.
- The QA head's dropout: `apply_avqa(train=True)` given JAX's keep masks
  (the ones `jax.random.bernoulli` draws from rng_v and rng_a, split from
  the dropout key as JAX's `apply_avqa` splits it) equals JAX's
  `apply_avqa(train=True, dropout_rng=)` at 1e-5; the port's own draws keep
  ~90% of the weights, scale the kept ones by 1/0.9 exactly, come from the
  generator (one seed, one mask) and are taken attn_v first, then attn_a.
- `mha`'s int8 branch (the packed in_proj when q, k and v are one tensor,
  its row slices otherwise) and its additive mask against JAX's `mha`.
- Under `--freeze_base True` the nega stream records no autograd graph;
  under `False` it does.
- `AVQADataset` / `build_avqa_vocab` / `encode_question` against JAX's on
  the fixture tree of tests/test_datasets_real_schema.py, item for item;
  `collate` keeps each item's question type, a 2-list.
- The CLI: what tests/test_cli_smoke.py::test_avqa_cli_resume expects of
  the JAX CLI (history [1, 2] after a resume), and the resumed run at the
  straight run's masters and Adam state bit for bit; `--eval_only` on the
  saved checkpoint of epoch 2 reproducing that epoch's accuracies; `--wa`;
  the flag surface equal to the JAX `parse_args`'s plus `--device` ("cuda"
  by default), on the defaults and on tests/test_cli_flag_surface.py's
  AVQA_FLAGS; with the default device and no card, `main` raises.
"""
import argparse
import dataclasses
import json
import math
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from stgcma_tpu.cli import run_adapt_avqa as jax_cli
from stgcma_tpu.configs import AVQAHeadConfig as JaxAVQAHeadConfig
from stgcma_tpu.configs import swin_tiny_test as jax_swin_tiny_test
from stgcma_tpu.data import datasets as jax_datasets
from stgcma_tpu.data.loader import make_avqa_device_pipeline as jax_avqa_pipeline
from stgcma_tpu.models import avqa as jax_avqa
from stgcma_tpu.ops import attention as jax_attention
from stgcma_tpu.ops import quant as jax_quant
from stgcma_tpu.train import losses as jax_losses
from stgcma_tpu.train import optim as jax_optim
from stgcma_tpu.train import steps as jax_steps
from stgcma_tpu_torch.checkpoint.convert import avqa_from_jax, params_from_jax
from stgcma_tpu_torch.cli import run_adapt_avqa as cli
from stgcma_tpu_torch.data import datasets
from stgcma_tpu_torch.data.loader import DataLoader, make_avqa_device_pipeline
from stgcma_tpu_torch.models import avqa
from stgcma_tpu_torch.nn import swin
from stgcma_tpu_torch.ops import attention
from stgcma_tpu_torch.ops.common import QLinear
from stgcma_tpu_torch.ops.fbank import SWIN_FBANK
from stgcma_tpu_torch.train import optim, steps

from test_cli_flag_surface import AVQA_FLAGS, _argv
from test_datasets_real_schema import FIX
from torch_port_helpers import rel, t, to_numpy_tree

TINY = ["--synthetic", "True", "--tiny", "True", "--device", "cpu", "--batch_size", "2",
        "--num_workers", "2", "--num_frames", "2"]


def _draw(rng, path, x, hidden):
    """A leaf of the JAX AVQA tree, live: bias tables and gates N(0, 1), the
    rest of the backbone N(0, 0.05^2) (adapters' D_fc2 included); in the
    head, linear kernels N(0, 1/in), `word2vec` N(0, 1), the LSTM
    N(0, 1/H), LayerNorm scales 1 + N(0, 0.1^2), biases N(0, 0.05^2)."""
    name = jax.tree_util.keystr(path)
    if "bias_table" in name or "gate_" in name:
        a = rng.randn(*x.shape)
    elif "['backbone']" in name:
        a = rng.randn(*x.shape) * 0.05
    elif name.endswith("['kernel']"):
        a = rng.randn(*x.shape) / np.sqrt(x.shape[0])
    elif "word2vec" in name:
        a = rng.randn(*x.shape)
    elif name.endswith("['w_ih']") or name.endswith("['w_hh']"):
        a = rng.randn(*x.shape) / np.sqrt(hidden)
    elif name.endswith("['scale']"):
        a = 1.0 + 0.1 * rng.randn(*x.shape)
    else:
        a = rng.randn(*x.shape) * 0.05
    return jnp.asarray(a.astype(np.float32))


def _jax_cfgs(dropout):
    cfg = jax_swin_tiny_test(ftmode="fusion", num_frames=2)
    return cfg, JaxAVQAHeadConfig(feat_dim=cfg.num_features, grid=7, num_frames=2,
                                  attn_dropout=dropout)


def _tree(cfg, hcfg, seed=5):
    shapes = jax.eval_shape(lambda: jax_avqa.init_avqa(jax.random.PRNGKey(0), cfg, hcfg))
    rng = np.random.RandomState(seed)
    return jax.tree_util.tree_map_with_path(lambda p, x: _draw(rng, p, x, hcfg.qst_hidden),
                                            shapes)


def _batches(cfg, n_steps=2):
    ds = cli.SyntheticAVQA(2 * n_steps, 2, cfg.img_size, seed=11)
    return [{k: np.stack([ds[i][k] for i in (2 * s, 2 * s + 1)]) for k in ds[0] if k != "qtype"}
            for s in range(n_steps)]


# ---------------------------------------------------------------------------
# two train steps against the JAX CLI's loss_fn; the head's dropout
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_setup():
    args = cli.parse_args(["--tiny", "True", "--num_frames", "2"])
    jcfg, jhcfg = _jax_cfgs(0.0)
    cfg, hcfg = cli.build(args)
    hcfg = dataclasses.replace(hcfg, attn_dropout=0.0)
    tree = _tree(jcfg, jhcfg)
    jpipe = jax_avqa_pipeline(dataclasses.replace(jax_cli.SWIN_FBANK, num_mel_bins=cfg.img_size),
                              cfg.img_size, args.dataset_mean, args.dataset_std,
                              image_size=cfg.img_size)
    pipe = make_avqa_device_pipeline(dataclasses.replace(SWIN_FBANK, num_mel_bins=cfg.img_size),
                                     cfg.img_size, args.dataset_mean, args.dataset_std,
                                     image_size=cfg.img_size, device="cpu")
    return dict(args=args, jcfg=jcfg, cfg=cfg, hcfg=hcfg, tree=tree, jpipe=jpipe, pipe=pipe)


@pytest.fixture(scope="module")
def two_steps(jax_setup):
    s = jax_setup
    jcfg, jhcfg = _jax_cfgs(0.0)
    args, jpipe = s["args"], s["jpipe"]

    def jax_loss(p, batch, rng_):      # the JAX CLI's loss_fn (:239-249), its closure's values
        k1, k2, k3 = jax.random.split(rng_, 3)
        a, v = jpipe({"frames": batch["frames"], "wave": batch["wave"]}, k1)
        _, vn = jpipe({"frames": batch["frames_nega"], "wave": batch["wave"]}, k2)
        out_qa, m_pos, m_neg = jax_avqa.apply_avqa(p, jcfg, jhcfg, a, v, vn, batch["question"],
                                                   train=True, dropout_rng=k3)
        return jax_losses.avqa_loss(out_qa, m_pos, m_neg, batch["answer"], kind=args.loss)

    batches = _batches(s["cfg"])
    lr = optim.cosine_schedule(1e-4, 1e-7, 1, 2)
    head_lr = optim.cosine_schedule(1e-5, 1e-7, 1, 2)
    tx = jax_optim.build_optimizer(None, 1e-4, 0.1, lr_table=lr, head_lr_table=head_lr)
    tp, fp, opt_state, _ = jax_steps.init_train_state(s["tree"], tx)
    step = jax_steps.make_train_step(jax_loss, tx, donate=False, compute_dtype=jnp.float32)
    jb = [{k: jnp.asarray(x) for k, x in b.items()} for b in batches]
    jgrad = jax.jit(jax.grad(lambda tp_: jax_loss(jax_optim.merge_params(tp_, fp), jb[0],
                                                  jax.random.PRNGKey(0))[0]))(tp)
    jlosses = []
    for b in jb:
        tp, opt_state, loss, _ = step(tp, fp, opt_state, b, jax.random.PRNGKey(0))
        jlosses.append(float(loss))

    model = avqa_from_jax(s["cfg"], s["hcfg"], to_numpy_tree(s["tree"]), device="cpu")
    steps.init_train_state(model)
    opt = optim.build_optimizer(model, 1e-4, 0.1, lr_table=lr, head_lr_table=head_lr)
    train_step = steps.make_train_step(cli.make_loss_fn(s["cfg"], s["hcfg"], s["pipe"], args,
                                                        torch.float32), opt, torch.float32)
    plosses, pgrad = [], None
    for b in batches:
        loss, _ = train_step(model, b, torch.Generator().manual_seed(0))
        plosses.append(float(loss))
        if pgrad is None:
            pgrad = {n: torch.zeros_like(p) if p.grad is None else p.grad.clone()
                     for n, p in model.named_parameters() if p.requires_grad}
    jgrad = {k: x.numpy() for k, x in params_from_jax(to_numpy_tree(
        jax.tree_util.tree_map(lambda g: np.zeros(()) if g is None else g, jgrad,
                               is_leaf=lambda x: x is None))).items() if k in pgrad}
    return dict(jlosses=jlosses, plosses=plosses, jgrad=jgrad, pgrad=pgrad)


def test_two_avqa_train_steps_losses_match_jax(two_steps):
    for p, j in zip(two_steps["plosses"], two_steps["jlosses"]):
        assert abs(p - j) <= 1e-5 * abs(j)
    assert two_steps["plosses"][0] != two_steps["plosses"][1]


def test_first_avqa_step_gradients_match_jax(two_steps):
    pgrad, jgrad = two_steps["pgrad"], two_steps["jgrad"]
    assert set(pgrad) == set(jgrad)
    for part in ("avqatask.fc4.", "avqatask.attn_v.in_proj.", "avqatask.question_encoder.lstm.",
                 "backbone.layers.0.blocks.0.S_Adapter2.D_fc1."):
        assert any(n.startswith(part) for n in pgrad), part
    biggest = max(float(np.abs(g).max()) for g in jgrad.values())
    for n, g in pgrad.items():
        scale = float(np.abs(jgrad[n]).max())     # 0: a leaf the loss does not reach
        assert float(np.abs(g.numpy() - jgrad[n]).max()) <= 1e-4 * scale + 1e-6 * biggest, n


def test_train_dropout_matches_jax_given_its_masks(jax_setup, monkeypatch):
    """`apply_avqa(train=True)` at attn_dropout 0.1, fp32: the port given the
    keep masks JAX draws (bernoulli(0.9) from rng_v, then rng_a, the split
    of the dropout key) equals JAX's outputs; the port's own mask draws
    come attn_v first, then attn_a, each (B, heads, 1, T)."""
    s = jax_setup
    jcfg, jhcfg = _jax_cfgs(0.1)
    x = _batches(s["cfg"], 1)[0]
    a, v = s["jpipe"]({"frames": x["frames"], "wave": x["wave"]})
    _, vn = s["jpipe"]({"frames": x["frames_nega"], "wave": x["wave"]})
    key = jax.random.PRNGKey(3)
    ref = jax.jit(lambda p: jax_avqa.apply_avqa(p, jcfg, jhcfg, a, v, vn, x["question"],
                                                train=True, dropout_rng=key))(s["tree"])
    shape = (2, jhcfg.attn_heads, 1, 2)
    masks = [np.asarray(jax.random.bernoulli(k, 0.9, shape)) for k in jax.random.split(key)]
    assert not all(m.all() for m in masks)          # the draws drop something
    seen = []

    def given(shape_, rate, generator, device):
        seen.append(tuple(shape_))
        return torch.from_numpy(masks[len(seen) - 1])
    monkeypatch.setattr(attention, "attn_dropout_keep", given)
    hcfg = dataclasses.replace(s["hcfg"], attn_dropout=0.1)
    model = avqa_from_jax(s["cfg"], hcfg, to_numpy_tree(s["tree"]), device="cpu")
    ins = [t(np.asarray(z)) for z in (a, v, vn)]
    q = torch.from_numpy(x["question"].astype(np.int64))
    with torch.no_grad():
        out = avqa.apply_avqa(model, s["cfg"], hcfg, *ins, q, train=True,
                              generator=torch.Generator().manual_seed(0))
        plain = avqa.apply_avqa(model, s["cfg"], hcfg, *ins, q)
    assert seen == [shape, shape]
    for o, r in zip(out, ref):
        assert rel(o, np.asarray(r)) < 1e-5
    assert rel(plain[0], np.asarray(ref[0])) > 1e-3      # the masks moved out_qa
    with torch.no_grad():                               # no generator, or eval: no draw
        avqa.apply_avqa(model, s["cfg"], hcfg, *ins, q, train=True)
        avqa.apply_avqa(model, s["cfg"], hcfg, *ins, q, generator=torch.Generator())
    assert len(seen) == 2


def test_port_dropout_draws():
    """The port's keep masks: ~90% kept at rate 0.1, the kept weights scaled
    by 1/0.9 exactly (bit for bit with JAX's apply of the same mask), one
    seed one mask, and `mha` taking them where JAX's takes its own."""
    g = torch.Generator().manual_seed(4)
    keep = attention.attn_dropout_keep((64, 4, 1, 100), 0.1, g, "cpu")
    assert keep.dtype == torch.bool and abs(float(keep.float().mean()) - 0.9) < 0.01
    assert torch.equal(keep, attention.attn_dropout_keep((64, 4, 1, 100), 0.1,
                                                         torch.Generator().manual_seed(4), "cpu"))
    attn = torch.rand(64, 4, 1, 100)
    for dt, jdt in ((torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16)):
        got = attention.attn_dropout_apply(attn.to(dt), keep, 0.1)
        ja = jnp.asarray(attn.numpy()).astype(jdt)
        ref = ja * jnp.asarray(keep.numpy()).astype(jdt) / (1.0 - 0.1)
        assert got.dtype == dt
        assert np.array_equal(got.float().numpy(), np.asarray(ref.astype(jnp.float32)))
    assert torch.equal(attention.attn_dropout_apply(attn, keep, 0.1)[keep], attn[keep] / 0.9)


def _mha_params(rng, C):
    return {"in_proj": {"kernel": jnp.asarray(rng.randn(C, 3 * C) / np.sqrt(C), jnp.float32),
                        "bias": jnp.asarray(rng.randn(3 * C) * 0.1, jnp.float32)},
            "out_proj": {"kernel": jnp.asarray(rng.randn(C, C) / np.sqrt(C), jnp.float32),
                         "bias": jnp.asarray(rng.randn(C) * 0.1, jnp.float32)}}


@pytest.mark.parametrize("fused", [True, False], ids=["packed", "sliced"])
def test_mha_int8_branch_matches_jax(fused):
    """`mha` with an int8 in_proj (JAX's `quantize_linear_params`, carried by
    `params_from_jax` into a `QLinear`): q, k, v one tensor (the packed
    (3C, C) product) or apart (its row slices), at 1e-3 of JAX's."""
    C, heads, Bq, Nk = 32, 4, 3, 10
    rng = np.random.RandomState(21)
    p = _mha_params(rng, C)
    p["in_proj"] = jax_quant.quantize_linear_params(p["in_proj"])
    x = rng.randn(Bq, Nk, C).astype(np.float32)
    q = x if fused else rng.randn(Bq, 1, C).astype(np.float32)
    jq, jx = jnp.asarray(q), jnp.asarray(x)
    ref = jax_attention.mha(p, jx if fused else jq, jx, jx, heads)
    m = attention.MultiheadAttention(C)
    m.in_proj = QLinear(C, 3 * C)
    m.load_state_dict(params_from_jax(to_numpy_tree(p)), strict=True)
    tx = t(x)
    out = attention.mha(m, tx if fused else t(q), tx, tx, heads)
    assert out.shape == tuple(ref.shape)
    assert rel(out, np.asarray(ref)) < 1e-3


def test_mha_mask_matches_jax():
    C, heads, Bq, Nk = 32, 4, 3, 10
    rng = np.random.RandomState(22)
    p = _mha_params(rng, C)
    q, kv = rng.randn(Bq, 1, C).astype(np.float32), rng.randn(Bq, Nk, C).astype(np.float32)
    mask = np.where(rng.rand(Bq, 1, 1, Nk) > 0.3, 0.0, -1e9).astype(np.float32)
    ref = jax_attention.mha(p, jnp.asarray(q), jnp.asarray(kv), jnp.asarray(kv), heads,
                            mask=jnp.asarray(mask))
    m = attention.MultiheadAttention(C)
    m.load_state_dict(params_from_jax(to_numpy_tree(p)), strict=True)
    out = attention.mha(m, t(q), t(kv), t(kv), heads, mask=t(mask))
    assert rel(out, np.asarray(ref)) < 1e-5
    assert rel(attention.mha(m, t(q), t(kv), t(kv), heads), np.asarray(ref)) > 1e-3


@pytest.mark.parametrize("freeze_base", [True, False])
def test_nega_stream_graph_follows_freeze_base(freeze_base):
    """Under --freeze_base True the nega stream reads no trainable leaf, so
    autograd records no graph for it; under False it differentiates."""
    cfg, hcfg = cli.build(cli.parse_args(["--tiny", "True", "--num_frames", "2"]))
    model = avqa.random_avqa(cfg, hcfg, 3)
    steps.init_train_state(model, freeze_base)
    rng = np.random.RandomState(0)
    n = cfg.img_size
    a = t(rng.randn(1, 2, n, n))
    v, vn = (t(rng.randn(1, 2, n, n, 3)) for _ in range(2))
    feats = swin.backbone_apply(model.backbone, cfg, a=a, v=v, v_nega=vn)
    assert feats["v"].requires_grad and feats["a"].requires_grad
    assert feats["v_nega"].requires_grad is not freeze_base
    if not freeze_base:
        feats["v_nega"].float().square().sum().backward()
        table = model.backbone.layers[1].blocks[1].attn.relative_position_bias_table
        assert table.grad is not None and float(table.grad.abs().max()) > 0


# ---------------------------------------------------------------------------
# the dataset
# ---------------------------------------------------------------------------

def test_avqa_dataset_matches_jax():
    """Every item of the train json equal to JAX's (two videos, so each draws
    its negative from the other). The test json's two questions share one
    video: there JAX's negative draw never ends, and the port's item
    raises."""
    root = os.path.join(FIX, "avqa")
    train = os.path.join(root, "avqa-train.json")
    for split in ("avqa-train.json", "avqa-test.json"):
        args = (os.path.join(root, split), train, os.path.join(root, "frames"),
                os.path.join(root, "audio_wav"), 10, "train")
        port, ref = datasets.AVQADataset(*args), jax_datasets.AVQADataset(*args)
        assert port.word2idx == ref.word2idx and port.ans2idx == ref.ans2idx
        assert len(port) == len(ref)
        if port.n_videos < 2:
            with pytest.raises(ValueError, match="no other video"):
                port[0]
            continue
        for i in range(len(ref)):
            a, b = port[i], ref[i]
            assert set(a) == set(b)
            for k in b:
                if isinstance(b[k], np.ndarray) or np.isscalar(b[k]):
                    assert np.asarray(a[k]).dtype == np.asarray(b[k]).dtype, (i, k)
                    assert np.array_equal(a[k], b[k]), (i, k)
                else:
                    assert a[k] == b[k], (i, k)
    vocab = datasets.build_avqa_vocab(train)
    assert vocab == jax_datasets.build_avqa_vocab(train)
    for q, templ in (("How many <Object> are in the video?", "['dog']"),
                     ("Is the <Object> louder than the <Object>?", ["cat", "dog"]),
                     ("What is the first instrument that comes in?" + " x" * 10, "[]")):
        got = datasets.encode_question(q, templ, vocab[0])
        assert got.dtype == np.int32 and got.shape == (14,)
        assert np.array_equal(got, jax_datasets.encode_question(q, templ, vocab[0]))


def test_collate_carries_question_types():
    ds = cli.SyntheticAVQA(4, 2, 56)
    batch = next(iter(DataLoader(ds, 2, num_workers=0)))
    assert batch["qtype"] == [["Audio", "Counting"]] * 2
    assert batch["question"].shape == (2, 14) and batch["answer"].shape == (2,)
    assert batch["frames_nega"].shape == (2, 2, 56, 56, 3)


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------

def _same_history(a, b):
    """Two runs' histories equal, NaN (a question type with no question)
    equal to NaN."""
    return json.dumps(a, sort_keys=True) == json.dumps(b, sort_keys=True)


def test_avqa_cli_resume_reaches_the_straight_run(tmp_path):
    straight = cli.main(TINY + ["--n-epochs", "2", "--exp-dir", str(tmp_path / "s")])
    exp = str(tmp_path / "r")
    cli.main(TINY + ["--n-epochs", "1", "--exp-dir", exp])
    t2 = cli.main(TINY + ["--n-epochs", "2", "--exp-dir", exp, "--resume", "True"])
    assert [h["epoch"] for h in t2.history] == [1, 2] and t2.global_step == 4
    assert _same_history(t2.history, straight.history)
    assert all(math.isfinite(x) for x in straight.step_losses)
    for name in ("result.csv", "args.json", "args.pkl", "progress.json", "state_meta.json",
                 "models/model.1", "models/model.2", "models/best_model", "state/train_params",
                 "state/opt_state"):
        assert os.path.exists(os.path.join(exp, name)), name
    with open(os.path.join(exp, "result.csv")) as f:
        assert f.readline().strip().startswith("epoch,loss,acc,Audio Counting,")
    ref = straight.trainable()
    assert all(torch.equal(p, ref[n]) for n, p in t2.trainable().items())
    a, b = t2.opt.state_dict(), straight.opt.state_dict()
    assert set(a) == set(b) and all(torch.equal(a[k], b[k]) for k in a)


def test_avqa_cli_eval_only_reproduces_the_epoch_and_wa_runs(tmp_path, capsys):
    exp = str(tmp_path / "e")
    trainer = cli.main(TINY + ["--n-epochs", "2", "--exp-dir", exp, "--wa", "True",
                               "--wa_start", "1", "--wa_end", "2"])
    assert "weight-averaged eval:" in capsys.readouterr().out
    got = cli.main(TINY + ["--exp-dir", str(tmp_path / "eo"), "--eval_only", "True", "--ckpt",
                           os.path.join(exp, "models", "model.2")])
    last = trainer.history[-1]
    assert got["acc"] == last["acc"] and got["Overall"] == last["acc"]
    assert _same_history({k: got[k] for k in last if k in got},
                         {k: last[k] for k in last if k in got})


def _parsers(monkeypatch, module, argv):
    seen = []
    real = argparse.ArgumentParser.parse_args

    def spy(self, args=None, namespace=None):
        seen.append(self)
        return real(self, args, namespace)
    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", spy)
    args = module.parse_args(argv)
    return seen[-1], vars(args)


@pytest.mark.parametrize("argv", [[], _argv(AVQA_FLAGS)], ids=["defaults", "AVQA_FLAGS"])
def test_avqa_flag_surface_equals_the_jax_cli(monkeypatch, argv):
    port_parser, port = _parsers(monkeypatch, cli, argv)
    jax_parser, ref = _parsers(monkeypatch, jax_cli, argv)
    options = lambda p: {o for a in p._actions for o in a.option_strings}  # noqa: E731
    assert options(port_parser) - options(jax_parser) == {"--device"}
    assert options(jax_parser) <= options(port_parser)
    assert port.pop("device") == "cuda"
    assert port == ref


def test_avqa_cli_refuses_other_ftmodes_and_defaults_to_the_card(tmp_path):
    with pytest.raises(SystemExit, match="not a runnable AVQA mode"):
        cli.main(TINY + ["--ftmode", "multimodal", "--exp-dir", str(tmp_path / "m")])
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["--synthetic", "True", "--tiny", "True", "--exp-dir", str(tmp_path / "e")])
