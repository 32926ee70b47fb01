"""AVSBench training in the PyTorch port (stgcma_tpu_torch) against the JAX
package on the CPU, at `--tiny` size (`swin_tiny_test`, the two-stage
decoder of the JAX CLI's `build`, T = 2, 56^2).

- Two fp32 train steps of `cli/run_adapt_avs.py::make_loss_fn` (the
  pipeline, `apply_avs(train=True, return_state=True)`,
  `iou_semantic_aware_loss`, TPAVI's BatchNorm statistics in
  aux["state_updates"]) through `make_train_step`, the statistics copied
  into the model after each step (`apply_state_updates`), against the JAX
  CLI's `loss_fn` (:243, the same body over the JAX pipeline) through
  JAX's `make_train_step` and its Trainer's `_deep_update`, on one live
  tree (`avs_from_jax`): losses within 1e-5 relative, the step-1
  gradients within 1e-4 of each leaf's max |g| plus 1e-6 of the largest
  gradient of all (a sum that nearly cancels: TPAVI's theta bias at the
  second stage, 6.5e-6, differs by 1.1e-9, 4e-7 of the largest); TPAVI's
  W_z biases, zero in exact arithmetic ahead of a batch-statistics
  BatchNorm, within 1e-4 of the largest gradient (rounding noise in both
  programs, measured <= 1.4e-5); the running means and variances within 1e-6 relative after step 1 (measured
  <= 9.5e-8: fp32 momentum updates of fp32 buffers) and 1e-5 after step 2
  (3.2e-6: Adam turns summation-order noise in near-zero gradients into
  updates of order lr, which move step 2's batch statistics).
- `AVSDataset` / `load_mask` against JAX's on the fixture trees of
  tests/test_datasets_real_schema.py (S4 and MS3, the per-kind roots, the
  VGGish pkls): every item equal.
- The CLI writes what tests/test_cli_smoke.py::test_avs_cli_resume expects
  of the JAX CLI (history [1, 2] after a resume) and its files; the resumed
  run reaches the straight run's masters, Adam state and BatchNorm
  statistics bit for bit; `--eval_only` on the saved checkpoint of epoch 2
  reproduces that epoch's miou and writes the PNG masks; `--wa` runs.
- Its flags equal the JAX `parse_args`'s plus `--device` ("cuda" by
  default), on the defaults and on tests/test_cli_flag_surface.py's
  AVS_FLAGS; with the default device and no card, `main` raises.
- STGCMA_DETERMINISTIC=1 runs a CLI's `main` under torch's deterministic
  algorithms, restored when it returns (the switch that makes a resume on
  the card bit for bit).
"""
import argparse
import dataclasses
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from stgcma_tpu.cli import run_adapt_avs as jax_cli
from stgcma_tpu.data import datasets as jax_datasets
from stgcma_tpu.data.loader import make_avs_device_pipeline as jax_avs_pipeline
from stgcma_tpu.models import avs as jax_avs
from stgcma_tpu.train import loop as jax_loop
from stgcma_tpu.train import losses as jax_losses
from stgcma_tpu.train import optim as jax_optim
from stgcma_tpu.train import steps as jax_steps
from stgcma_tpu_torch.checkpoint.convert import avs_from_jax, params_from_jax
from stgcma_tpu_torch.checkpoint.io import load_checkpoint
from stgcma_tpu_torch.cli import run_adapt_avs as cli
from stgcma_tpu_torch.data import datasets
from stgcma_tpu_torch.data.loader import make_avs_device_pipeline
from stgcma_tpu_torch.ops.fbank import SWIN_FBANK
from stgcma_tpu_torch.train import optim, steps

from test_cli_flag_surface import AVS_FLAGS, _argv
from test_datasets_real_schema import FIX
from test_torch_port_avs_slice import _tree
from torch_port_helpers import to_numpy_tree

TINY = ["--synthetic", "True", "--tiny", "True", "--device", "cpu", "--batch_size", "2",
        "--num_workers", "2", "--num_frames", "2"]


# ---------------------------------------------------------------------------
# two train steps against the JAX CLI's loss_fn
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def two_steps():
    argv = ["--tiny", "True", "--num_frames", "2"]
    jargs, pargs = jax_cli.parse_args(argv), cli.parse_args(argv)
    jcfg, jhcfg = jax_cli.build(jargs)
    cfg, hcfg = cli.build(pargs)
    tree = _tree(lambda: jax_avs.init_avs(jax.random.PRNGKey(0), jcfg, jhcfg), 5)
    ds = cli.SyntheticAVS(4, 2, cfg.img_size, seed=11)
    batches = [{k: np.stack([ds[i][k] for i in (2 * s, 2 * s + 1)]) for k in ds[0]}
               for s in range(2)]
    jpipe = jax_avs_pipeline(dataclasses.replace(jax_cli.SWIN_FBANK, num_mel_bins=cfg.img_size),
                             cfg.img_size, jargs.dataset_mean, jargs.dataset_std)

    def jax_loss(p, batch, rng_):      # the JAX CLI's loss_fn (:243), its closure's values
        a, v = jpipe({"frames": batch["frames"], "wave": batch["wave"]}, rng_)
        pred, fmaps, afeas, bn_state = jax_avs.apply_avs(p, jcfg, jhcfg, a, v, train=True,
                                                         return_state=True)
        total, aux = jax_losses.iou_semantic_aware_loss(
            pred, batch["masks"][:, 0][..., None], afeas, fmaps, jargs.lambda_1,
            count_stages=(), sa_loss_flag=False, frames_per_clip=jargs.num_frames)
        aux = dict(aux)
        aux["state_updates"] = {"avstask": {k: {"W_z": {"bn": s}} for k, s in bn_state.items()}}
        return total, aux

    lr = optim.cosine_schedule(1e-4, 1e-7, 1, 2)
    head_lr = optim.cosine_schedule(1e-5, 1e-7, 1, 2)
    tx = jax_optim.build_optimizer(None, 1e-4, 0.1, lr_table=lr, head_lr_table=head_lr)
    tp, fp, opt_state, _ = jax_steps.init_train_state(tree, tx)
    step = jax_steps.make_train_step(jax_loss, tx, donate=False, compute_dtype=jnp.float32)
    jb = [{k: jnp.asarray(x) for k, x in b.items()} for b in batches]
    jgrad = jax.jit(jax.grad(lambda tp_: jax_loss(jax_optim.merge_params(tp_, fp), jb[0],
                                                  None)[0]))(tp)
    jlosses, jstats = [], []
    for b in jb:
        tp, opt_state, loss, aux = step(tp, fp, opt_state, b, jax.random.PRNGKey(0))
        fp = jax_loop._deep_update(fp, aux["state_updates"])
        jlosses.append(float(loss))
        jstats.append({f"avstask.{k}.W_z.bn.running_{s}": torch.from_numpy(np.asarray(st[s]))
                       for k, st in aux["state_updates"]["avstask"].items()
                       for st in (fp["avstask"][k]["W_z"]["bn"],) for s in ("mean", "var")})

    model = avs_from_jax(cfg, hcfg, to_numpy_tree(tree), device="cpu")
    steps.init_train_state(model)
    opt = optim.build_optimizer(model, 1e-4, 0.1, lr_table=lr, head_lr_table=head_lr)
    pipe = make_avs_device_pipeline(dataclasses.replace(SWIN_FBANK, num_mel_bins=cfg.img_size),
                                    cfg.img_size, pargs.dataset_mean, pargs.dataset_std,
                                    device="cpu")
    train_step = steps.make_train_step(cli.make_loss_fn(cfg, hcfg, pipe, pargs, torch.float32),
                                       opt, torch.float32)
    plosses, pstats, pgrad = [], [], None
    for b in batches:
        loss, aux = train_step(model, b)
        steps.apply_state_updates(model, aux["state_updates"])
        plosses.append(float(loss))
        pstats.append({n: x.clone() for n, x in model.named_buffers()})
        if pgrad is None:
            pgrad = {n: torch.zeros_like(p) if p.grad is None else p.grad.clone()
                     for n, p in model.named_parameters() if p.requires_grad}
    jgrad = {k: x.numpy() for k, x in params_from_jax(to_numpy_tree(
        jax.tree_util.tree_map(lambda g: np.zeros(()) if g is None else g, jgrad,
                               is_leaf=lambda x: x is None))).items() if k in pgrad}
    return dict(jlosses=jlosses, plosses=plosses, jgrad=jgrad, pgrad=pgrad, jstats=jstats,
                pstats=pstats, updates=aux["state_updates"])


def test_two_avs_train_steps_losses_match_jax(two_steps):
    for p, j in zip(two_steps["plosses"], two_steps["jlosses"]):
        assert abs(p - j) <= 1e-5 * abs(j)
    assert two_steps["plosses"][0] != two_steps["plosses"][1]


def test_first_avs_step_gradients_match_jax(two_steps):
    pgrad, jgrad = two_steps["pgrad"], two_steps["jgrad"]
    assert set(pgrad) == set(jgrad)
    assert any(n.startswith("avstask.tpavi_b1.W_z.bn.") for n in pgrad)
    assert any(n.startswith("backbone.") and ".D_fc1." in n for n in pgrad)
    biggest = max(float(np.abs(g).max()) for g in jgrad.values())
    for n, g in pgrad.items():
        if n.endswith("W_z.conv.bias"):
            # zero in exact arithmetic: it adds the same vector at every
            # position, which the batch-statistics BatchNorm after it
            # subtracts again; rounding noise in both programs
            assert max(float(g.abs().max()), float(np.abs(jgrad[n]).max())) <= 1e-4 * biggest
            continue
        scale = float(np.abs(jgrad[n]).max())     # 0: a leaf the loss does not reach
        assert float(np.abs(g.numpy() - jgrad[n]).max()) <= 1e-4 * scale + 1e-6 * biggest, n


def test_batchnorm_statistics_after_each_step_match_jax(two_steps):
    names = set(two_steps["updates"])
    assert names == {f"avstask.tpavi_b{i}.W_z.bn.running_{s}" for i in (1, 2)
                     for s in ("mean", "var")}
    for bar, pst, jst in zip((1e-6, 1e-5), two_steps["pstats"], two_steps["jstats"]):
        for n in names:
            ref = jst[n]
            assert pst[n].dtype == torch.float32
            assert float((pst[n] - ref).abs().max()) <= bar * float(ref.abs().max()), n
    first, second = two_steps["pstats"]
    assert all(not torch.equal(first[n], second[n]) for n in names)


# ---------------------------------------------------------------------------
# the dataset
# ---------------------------------------------------------------------------

def _same_items(port, ref):
    assert len(port) == len(ref)
    for i in range(len(ref)):
        a, b = port[i], ref[i]
        assert set(a) == set(b)
        for k in b:
            assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), (i, k)


@pytest.mark.parametrize("tree,csv", [("avs", "s4_meta_data.csv"),
                                      ("avs_ms3", "ms3_meta_data.csv")])
@pytest.mark.parametrize("split", ["train", "test"])
def test_avs_dataset_matches_jax(tree, csv, split):
    root = os.path.join(FIX, tree)
    args = (os.path.join(root, csv), root, split)
    _same_items(datasets.AVSDataset(*args), jax_datasets.AVSDataset(*args))


def test_avs_dataset_kind_roots_and_log_mel_match_jax(tmp_path):
    import pickle
    import shutil
    root = os.path.join(FIX, "avs")
    meta = os.path.join(root, "s4_meta_data.csv")
    for kind in ("visual_frames", "gt_masks", "audio_wav"):
        shutil.copytree(os.path.join(root, kind), tmp_path / f"alt_{kind}")
    row = datasets.AVSDataset(meta, root).rows[0]
    lm_dir = tmp_path / "lm" / "train" / row["category"]
    lm_dir.mkdir(parents=True)
    with open(lm_dir / f"{row['name']}.pkl", "wb") as f:
        pickle.dump(np.random.RandomState(0).randn(5, 1, 96, 64).astype(np.float32), f)
    kw = dict(dir_image=str(tmp_path / "alt_visual_frames"), dir_mask=str(tmp_path / "alt_gt_masks"),
              dir_audio_wav=str(tmp_path / "alt_audio_wav"), dir_audio_log_mel=str(tmp_path / "lm"))
    port, ref = (m.AVSDataset(meta, "/nonexistent", "train", **kw) for m in (datasets, jax_datasets))
    assert port.load_audio_log_mel and ref.load_audio_log_mel
    a, b = port[0], ref[0]
    assert set(a) == set(b) and all(np.array_equal(a[k], b[k]) for k in b)
    with pytest.raises(FileNotFoundError):      # decided once: item 2 has no pkl
        port[1]


def test_load_mask_matches_jax():
    path = os.path.join(FIX, "avs", "gt_masks", "train")
    png = next(os.path.join(d, f) for d, _, fs in os.walk(path) for f in sorted(fs)
               if f.endswith(".png"))
    for size in (224, 56):
        got = datasets.load_mask(png, size)
        assert got.dtype == np.float32 and np.array_equal(got, jax_datasets.load_mask(png, size))


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------

def test_avs_cli_resume_reaches_the_straight_run(tmp_path):
    straight = cli.main(TINY + ["--n-epochs", "2", "--exp-dir", str(tmp_path / "s")])
    exp = str(tmp_path / "r")
    cli.main(TINY + ["--n-epochs", "1", "--exp-dir", exp])
    t2 = cli.main(TINY + ["--n-epochs", "2", "--exp-dir", exp, "--resume", "True"])
    assert [h["epoch"] for h in t2.history] == [1, 2] and t2.global_step == 4
    assert t2.history == straight.history
    for name in ("result.csv", "args.json", "args.pkl", "progress.json", "state_meta.json",
                 "models/model.1", "models/model.2", "models/best_model", "state/train_params",
                 "state/opt_state", "state/buffers"):
        assert os.path.exists(os.path.join(exp, name)), name
    with open(os.path.join(exp, "result.csv")) as f:
        assert f.readline().strip() == "epoch,loss,miou"
    ref = straight.trainable()
    assert all(torch.equal(p, ref[n]) for n, p in t2.trainable().items())
    a, b = t2.opt.state_dict(), straight.opt.state_dict()
    assert set(a) == set(b) and all(torch.equal(a[k], b[k]) for k in a)
    bufs, ref_bufs = t2.buffers(), straight.buffers()
    assert len(bufs) == 4 and all(torch.equal(bufs[n], ref_bufs[n]) for n in bufs)
    init = cli.avs.init_avs(*cli.build(cli.parse_args(TINY)), device="cpu")
    assert all(not torch.equal(x, dict(init.named_buffers())[n]) for n, x in bufs.items())


def test_avs_cli_eval_only_reproduces_the_epoch_and_dumps_masks(tmp_path, capsys):
    exp = str(tmp_path / "e")
    trainer = cli.main(TINY + ["--n-epochs", "2", "--exp-dir", exp, "--wa", "True",
                               "--wa_start", "1", "--wa_end", "2"])
    assert "weight-averaged eval:" in capsys.readouterr().out
    masks = str(tmp_path / "masks")
    got = cli.main(TINY + ["--exp-dir", str(tmp_path / "eo"), "--eval_only", "True", "--ckpt",
                           os.path.join(exp, "models", "model.2"), "--save_mask_dir", masks])
    assert got["miou"] == trainer.history[-1]["miou"]
    assert len(os.listdir(masks)) == 2 * 2      # the test split's 2 clips x 2 frames
    sd = load_checkpoint(os.path.join(exp, "models", "model.2"))
    assert any(k.endswith("W_z.bn.running_var") for k in sd)


def _parsers(monkeypatch, module, argv):
    seen = []
    real = argparse.ArgumentParser.parse_args

    def spy(self, args=None, namespace=None):
        seen.append(self)
        return real(self, args, namespace)
    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", spy)
    args = module.parse_args(argv)
    return seen[-1], vars(args)


@pytest.mark.parametrize("argv", [[], _argv(AVS_FLAGS)], ids=["defaults", "AVS_FLAGS"])
def test_avs_flag_surface_equals_the_jax_cli(monkeypatch, argv):
    port_parser, port = _parsers(monkeypatch, cli, argv)
    jax_parser, ref = _parsers(monkeypatch, jax_cli, argv)
    options = lambda p: {o for a in p._actions for o in a.option_strings}  # noqa: E731
    assert options(port_parser) - options(jax_parser) == {"--device"}
    assert options(jax_parser) <= options(port_parser)
    assert port.pop("device") == "cuda"
    assert port == ref


def test_avs_cli_defaults_to_the_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["--synthetic", "True", "--tiny", "True", "--exp-dir", str(tmp_path / "e")])



def test_deterministic_switch_holds_for_the_cli_call_only(monkeypatch, tmp_path):
    """STGCMA_DETERMINISTIC=1 runs a CLI's `main` under torch's deterministic
    algorithms and cuDNN's, restored when it returns; unset, it changes
    nothing. The AVS CLI trains an epoch under it on the CPU."""
    from stgcma_tpu_torch.cli import common, run_adapt_ave29
    seen = []

    @common.deterministic_algorithms()
    def probe():
        seen.append((torch.are_deterministic_algorithms_enabled(),
                     torch.backends.cudnn.deterministic))
    before = (torch.are_deterministic_algorithms_enabled(), torch.backends.cudnn.deterministic)
    monkeypatch.delenv(common.DETERMINISTIC, raising=False)
    probe()
    monkeypatch.setenv(common.DETERMINISTIC, "1")
    probe()
    assert seen == [before, (True, True)]
    assert (torch.are_deterministic_algorithms_enabled(),
            torch.backends.cudnn.deterministic) == before
    for module in (cli, run_adapt_ave29):
        assert module.main.__wrapped__ is not None
    trainer = cli.main(TINY + ["--n-epochs", "1", "--exp-dir", str(tmp_path / "d")])
    assert [h["epoch"] for h in trainer.history] == [1]
    assert not torch.are_deterministic_algorithms_enabled()
