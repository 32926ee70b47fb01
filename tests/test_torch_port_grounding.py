"""The AVQA grounding pretrainer in the PyTorch port (stgcma_tpu_torch)
against the JAX package on the CPU: `nn/resnet.py`, `load_resnet18` and
`tools/grounding_gen.py`.

- ResNet-18: the basic block on tests/test_grounding_resnet.py's inputs and
  `resnet18_features` at 224^2 (stride-1 layer4: 14 x 14) within 1e-5 of
  max |JAX|, weights crossing over through `resnet18_from_jax`.
- `load_resnet18` on that test's torchvision-layout state dict: every leaf
  equal to the JAX loader's tree (through `params_from_jax`), bit for bit;
  `fc.*` and `num_batches_tracked` dropped, `module.` stripped, an unknown
  key raising.
- `apply_grounding` (match logits and attention) on that test's inputs (B =
  1, T = 2, 224^2) within 1e-5 of JAX's, `grounding_loss` at 112^2 within
  1e-5 and its head gradients within 1e-4, through `grounding_from_jax`;
  `splice_into_avqa` moving the same leaves as JAX's.
- `main --synthetic True` writing the reference layout that
  tests/test_grounding_trainer.py expects of the JAX trainer, the export
  spliced by the AVQA CLI's `--grounding_pretrained`, the heat-map dump;
  `GroundingGenDataset` item for item against JAX's; the jet colormap; the
  flag surface equal to JAX's plus `--device`; the default device raising
  without a card.
"""
import argparse
import json
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from stgcma_tpu.checkpoint import torch_convert as JTC
from stgcma_tpu.configs import AVQAHeadConfig as JaxAVQAHeadConfig
from stgcma_tpu.configs import swin_tiny_test as jax_swin_tiny_test
from stgcma_tpu.models import avqa as jax_avqa
from stgcma_tpu.nn import resnet as jax_resnet
from stgcma_tpu.tools import grounding_gen as JG
from stgcma_tpu_torch.checkpoint import torch_convert as TC
from stgcma_tpu_torch.checkpoint.convert import (avqa_from_jax, grounding_from_jax,
                                                 params_from_jax, resnet18_from_jax)
from stgcma_tpu_torch.cli import run_adapt_avqa
from stgcma_tpu_torch.nn import resnet
from stgcma_tpu_torch.tools import grounding_gen as G

from torch_port_helpers import rel, t, to_numpy_tree

TOL = 1e-5


@pytest.fixture(scope="module")
def grounding_tree():
    return to_numpy_tree(JG.init_grounding(jax.random.PRNGKey(0)))


def test_basic_block_matches_jax():
    """tests/test_grounding_resnet.py::test_basic_block_matches_torch's
    block and input (stride 2, a projected identity)."""
    torch.manual_seed(0)
    cin, cout = 8, 16
    w1, w2 = torch.randn(cout, cin, 3, 3) * 0.1, torch.randn(cout, cout, 3, 3) * 0.1
    wd = torch.randn(cout, cin, 1, 1) * 0.1
    bns = [(torch.randn(cout).abs() + 0.5, torch.randn(cout) * 0.1, torch.randn(cout) * 0.1,
            torch.randn(cout).abs() + 0.5) for _ in range(3)]
    x = torch.randn(2, cin, 14, 14).permute(0, 2, 3, 1).contiguous()
    bn = lambda g, b, m, v: {"scale": g.numpy(), "bias": b.numpy(), "mean": m.numpy(),  # noqa
                             "var": v.numpy()}
    tree = {"conv1": {"kernel": w1.permute(2, 3, 1, 0).numpy()}, "bn1": bn(*bns[0]),
            "conv2": {"kernel": w2.permute(2, 3, 1, 0).numpy()}, "bn2": bn(*bns[1]),
            "downsample": {"conv": {"kernel": wd.permute(2, 3, 1, 0).numpy()},
                           "bn": bn(*bns[2])}}
    ref = jax_resnet._basic_block(jax.tree_util.tree_map(jnp.asarray, tree),
                                  jnp.asarray(x.numpy()), stride=2)
    blk = resnet.BasicBlock(cin, cout, True)
    blk.load_state_dict(params_from_jax(tree), strict=True)
    out = resnet._basic_block(blk, x, 2)
    assert out.shape == (2, 7, 7, cout)
    assert rel(out, np.asarray(ref)) < TOL


def test_resnet18_features_match_jax():
    tree = to_numpy_tree(jax_resnet.resnet18_init(jax.random.PRNGKey(0)))
    x = np.random.RandomState(2).randn(1, 224, 224, 3).astype(np.float32)
    ref = jax.jit(jax_resnet.resnet18_features)(tree, jnp.asarray(x))
    model = resnet18_from_jax(tree, device="cpu")
    with torch.no_grad():
        out = resnet.resnet18_features(model, t(x))
    assert out.shape == (1, 14, 14, 512)
    assert rel(out, np.asarray(ref)) < TOL
    init = resnet.resnet18_init(device="cpu")        # the JAX init's distributions
    w = init.layer3[0].conv1.weight.detach()
    assert float(w.abs().max()) <= 1 / np.sqrt(128 * 9) and float(w.std()) > 0.5 / np.sqrt(
        3 * 128 * 9)
    assert torch.equal(init.layer4[1].bn2.running_var, torch.ones(512))


def _torchvision_state_dict():
    """tests/test_grounding_resnet.py::test_resnet_geometry_and_converter's."""
    rng = np.random.RandomState(0)
    sd = {"conv1.weight": rng.randn(64, 3, 7, 7).astype(np.float32)}
    for s in ("weight", "bias", "running_mean", "running_var"):
        sd[f"bn1.{s}"] = rng.rand(64).astype(np.float32)
    sd["bn1.num_batches_tracked"] = np.array(1)
    widths = [64, 128, 256, 512]
    for li, w in enumerate(widths, start=1):
        cin = widths[li - 2] if li > 1 else 64
        for b in range(2):
            base = f"layer{li}.{b}"
            c_in = cin if b == 0 else w
            sd[f"{base}.conv1.weight"] = rng.randn(w, c_in, 3, 3).astype(np.float32)
            sd[f"{base}.conv2.weight"] = rng.randn(w, w, 3, 3).astype(np.float32)
            for mod in ("bn1", "bn2"):
                for s in ("weight", "bias", "running_mean", "running_var"):
                    sd[f"{base}.{mod}.{s}"] = rng.rand(w).astype(np.float32)
            if b == 0 and li > 1:
                sd[f"{base}.downsample.0.weight"] = rng.randn(w, c_in, 1, 1).astype(np.float32)
                for s in ("weight", "bias", "running_mean", "running_var"):
                    sd[f"{base}.downsample.1.{s}"] = rng.rand(w).astype(np.float32)
    sd["fc.weight"] = rng.randn(1000, 512).astype(np.float32)
    sd["fc.bias"] = rng.randn(1000).astype(np.float32)
    return sd


def test_load_resnet18_matches_the_jax_loader():
    sd = _torchvision_state_dict()
    jtree, junexpected = JTC.load_resnet18(jax_resnet.resnet18_init(jax.random.PRNGKey(0)), sd)
    ref = params_from_jax(to_numpy_tree(jtree))
    model, unexpected = TC.load_resnet18(resnet.ResNet18(), sd, device="cpu")
    assert unexpected == junexpected == []
    got = model.state_dict()
    assert set(got) == set(ref)
    for n, x in ref.items():
        assert torch.equal(got[n], x), n
    model2, _ = TC.load_resnet18(resnet.ResNet18(), {f"module.{k}": torch.from_numpy(np.asarray(v))
                                                     for k, v in sd.items()}, device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(model2.state_dict().values(), got.values()))
    with pytest.raises(ValueError, match="unhandled resnet key"):
        TC.load_resnet18(resnet.ResNet18(), {"avgpool.weight": np.zeros(1)}, device="cpu")


def _grounding_inputs(size):
    audio = np.random.RandomState(0).randn(1, 2, 128).astype(np.float32)
    frames = np.random.RandomState(1).randn(1, 2, size, size, 3).astype(np.float32)
    return audio, frames


def test_apply_grounding_and_its_loss_match_jax(grounding_tree):
    """tests/test_grounding_resnet.py::test_grounding_head_and_splice's
    inputs (B = 1, T = 2, 224^2): the logits and attention; at 112^2 (a 7 x
    7 grid, a quarter of the work), the loss on (frames, frames + 0.1) and
    the head's gradients, the visual net frozen."""
    audio, frames = _grounding_inputs(224)
    jtree = jax.tree_util.tree_map(jnp.asarray, grounding_tree)
    ref_out, ref_att = jax.jit(lambda p: JG.apply_grounding(
        p, jnp.asarray(audio), jnp.asarray(frames), return_attention=True))(jtree)
    model = grounding_from_jax(grounding_tree, device="cpu")
    model.visual_net.requires_grad_(False)
    with torch.no_grad():
        out, att = G.apply_grounding(model, t(audio), t(frames), return_attention=True)
    assert out.shape == (2, 2) and att.shape == (2, 196)
    assert rel(out, np.asarray(ref_out)) < TOL and rel(att, np.asarray(ref_att)) < TOL
    audio, frames = _grounding_inputs(112)
    head = {k: jtree[k] for k in G.HEAD_KEYS}
    jloss, jgrad = jax.jit(jax.value_and_grad(lambda h: JG.grounding_loss(
        {**h, "visual_net": jtree["visual_net"]}, jnp.asarray(audio), jnp.asarray(frames),
        jnp.asarray(frames + 0.1))))(head)
    loss = G.grounding_loss(model, t(audio), t(frames), t(frames + 0.1))
    assert abs(loss.item() - float(jloss)) <= TOL * abs(float(jloss))
    loss.backward()
    ref = params_from_jax(to_numpy_tree(jgrad))
    for n, p in model.named_parameters():
        if n.startswith("visual_net."):
            assert p.grad is None
            continue
        assert rel(p.grad, ref[n].numpy()) < 1e-4, n


def test_splice_into_avqa_moves_what_jax_moves(grounding_tree):
    cfg = jax_swin_tiny_test(ftmode="fusion")
    hcfg = JaxAVQAHeadConfig(feat_dim=cfg.num_features)
    rng = np.random.RandomState(1)
    atree = jax.tree_util.tree_map(lambda x: rng.randn(*x.shape).astype(np.float32),
                                   jax.eval_shape(lambda: jax_avqa.init_avqa(
                                       jax.random.PRNGKey(1), cfg, hcfg)))
    ref = params_from_jax(to_numpy_tree(JG.splice_into_avqa(
        jax.tree_util.tree_map(jnp.asarray, atree), jax.tree_util.tree_map(
            jnp.asarray, grounding_tree))))
    from stgcma_tpu_torch.configs import AVQAHeadConfig, swin_tiny_test
    model = avqa_from_jax(swin_tiny_test(ftmode="fusion"),
                          AVQAHeadConfig(feat_dim=cfg.num_features), atree, device="cpu")
    before = {n: x.clone() for n, x in model.state_dict().items()}
    got = G.splice_into_avqa(model, grounding_from_jax(grounding_tree, device="cpu")).state_dict()
    moved = {n.split(".")[1] for n in got if not torch.equal(got[n], before[n])}
    assert moved == {"fc2", "fc3", "fc4"}
    assert all(torch.equal(got[n], ref[n]) for n in ref)


def test_synthetic_training_exports_the_reference_layout_and_splices(tmp_path, capsys):
    """tests/test_grounding_trainer.py's checks of the JAX trainer's export;
    then the AVQA CLI's --grounding_pretrained copies, as the JAX CLI's
    leaf-wise shape check does, fc2, fc3 and fc4 (the widths the tiny AVQA
    head shares) and fc1's bias (512 wide in both heads), nothing else."""
    save = str(tmp_path / "models")
    model = G.main(["--synthetic", "True", "--epochs", "2", "--batch-size", "2",
                    "--synthetic_n", "4", "--log-interval", "10", "--model_save_dir", save,
                    "--device", "cpu"])
    assert len(model.step_losses) == 4 and all(np.isfinite(model.step_losses))
    best = os.path.join(save, "main_grounding_gen_best.pt")
    assert os.path.exists(best) and os.path.exists(os.path.join(save, "main_grounding_gen2.pt"))
    sd = torch.load(best, map_location="cpu", weights_only=False)
    assert tuple(sd["module.fc_a1.weight"].shape) == (512, 128)
    assert tuple(sd["module.fc4.weight"].shape) == (2, 128)
    assert set(sd) == {f"module.{k}.{w}" for k in G.HEAD_KEYS for w in ("weight", "bias")}
    args = run_adapt_avqa.parse_args(["--tiny", "True", "--num_frames", "2",
                                      "--grounding_pretrained", best])
    cfg, hcfg = run_adapt_avqa.build(args)
    init = run_adapt_avqa.avqa.init_avqa(cfg, hcfg, device="cpu")
    before = {n: x.clone() for n, x in init.state_dict().items()}
    capsys.readouterr()
    got = run_adapt_avqa.load_weights(init, cfg, args, "cpu").state_dict()
    assert "grounding splice: 7 tensors (['fc1', 'fc2', 'fc3', 'fc4'])" in capsys.readouterr().out
    for n, x in got.items():
        name = n[len("avqatask."):]
        if name.split(".")[0] in ("fc2", "fc3", "fc4") or name == "fc1.bias":
            assert torch.equal(x, sd[f"module.{name}"]), n
        else:
            assert torch.equal(x, before[n]), n


def test_heatmap_dump(tmp_path):
    from PIL import Image
    d = str(tmp_path / "m")
    G.main(["--synthetic", "True", "--epochs", "1", "--batch-size", "2", "--synthetic_n", "4",
            "--model_save_dir", d, "--device", "cpu"])
    vis = str(tmp_path / "vis")
    G.main(["--synthetic", "True", "--synthetic_n", "4", "--mode", "test", "--batch-size", "2",
            "--model_save_dir", d, "--dump_heatmaps", vis, "--device", "cpu"])
    pngs = sorted(os.listdir(vis))
    assert len(pngs) == 2
    img = np.asarray(Image.open(os.path.join(vis, pngs[0])))
    assert img.shape == (224, 224, 3) and img.std() > 0


def test_grounding_dataset_matches_jax(tmp_path):
    from PIL import Image
    vids = ["vidA", "vidB"]
    train_json = tmp_path / "train.json"
    train_json.write_text(json.dumps([{"video_id": v} for v in vids for _ in range(2)]))
    audio_dir, video_dir = tmp_path / "vggish", tmp_path / "frames"
    audio_dir.mkdir()
    rng = np.random.RandomState(0)
    for v in vids:
        np.save(audio_dir / f"{v}.npy", rng.randn(10, 128).astype(np.float32))
        (video_dir / v).mkdir(parents=True)
        for i in range(10):
            Image.fromarray(rng.randint(0, 255, (32, 48, 3)).astype(np.uint8)).save(
                video_dir / v / f"{i:05d}.jpg")
    args = (str(train_json), str(train_json), str(audio_dir), str(video_dir))
    port, ref = G.GroundingGenDataset(*args), JG.GroundingGenDataset(*args)
    assert len(port) == len(ref) == 20
    for i in (3, 12, 19):
        a, b = port[i], ref[i]
        assert set(a) == set(b) and all(np.array_equal(a[k], b[k]) for k in b), i
    x = np.linspace(-0.2, 1.2, 57)
    assert np.array_equal(G._jet_rgb(x), JG._jet_rgb(x))


def test_grounding_flag_surface_and_device(monkeypatch, tmp_path):
    """The port's flags are the JAX trainer's plus `--device` ("cuda"); the
    JAX parser is caught at its parse, before it trains."""
    real = argparse.ArgumentParser.parse_args
    seen = []

    class Stop(Exception):
        pass

    def spy(self, args=None, namespace=None):
        seen.append((self, vars(real(self, args, namespace))))
        raise Stop
    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", spy)
    for main in (JG.main, G.main):
        with pytest.raises(Stop):
            main([])
    monkeypatch.undo()
    options = lambda p: {o for a in p._actions for o in a.option_strings}  # noqa: E731
    (jp, ref), (pp, port) = seen
    assert options(pp) - options(jp) == {"--device"} and options(jp) <= options(pp)
    assert port.pop("device") == "cuda" and port == ref
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        G.main(["--synthetic", "True", "--model_save_dir", str(tmp_path / "m")])
