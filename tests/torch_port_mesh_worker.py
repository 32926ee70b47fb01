"""One rank of the port's mesh checks (tests/test_torch_port_runtime.py
starts two, on one free port, under gloo on the CPU):

    STGCMA_COORDINATOR=127.0.0.1:<port> STGCMA_NUM_PROCESSES=2 STGCMA_PROCESS_ID=<rank> \
        python tests/torch_port_mesh_worker.py {server_data,server_model,train} OUT.json

Each rank brings the group up through `init_distributed`, computes the
meshless result itself (the same seeded models and batches on every rank),
runs the mesh path, and writes {name: max |mesh - single| / max |single|}
and its own checks to OUT.json. The port only; no JAX.
"""
import dataclasses
import json
import os
import sys
import tempfile
from types import SimpleNamespace

import numpy as np
import torch
import torch.distributed as dist

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
torch.set_num_threads(1)     # two ranks beside the suite's workers

from stgcma_tpu_torch.cli import run_adapt_avs as avs_cli  # noqa: E402
from stgcma_tpu_torch.configs import clip_tiny_test, swin_tiny_test  # noqa: E402
from stgcma_tpu_torch.data.datasets import SyntheticAVE  # noqa: E402
from stgcma_tpu_torch.data.loader import (collate, make_ave_device_pipeline,  # noqa: E402
                                          make_avs_device_pipeline)
from stgcma_tpu_torch.models import ave, avs  # noqa: E402
from stgcma_tpu_torch.ops.fbank import SWIN_FBANK  # noqa: E402
from stgcma_tpu_torch.runtime import mesh as M  # noqa: E402
from stgcma_tpu_torch.serving import MultiTaskServer  # noqa: E402
from stgcma_tpu_torch.train import losses  # noqa: E402
from stgcma_tpu_torch.train.loop import Trainer  # noqa: E402


def rel(x, ref):
    x, ref = np.asarray(x, np.float64), np.asarray(ref, np.float64)
    return float(np.abs(x - ref).max() / (np.abs(ref).max() + 1e-12))


def ave_tasks():
    """(add method, cfg, model, batch) of the Swin and the CLIP fusion AVE."""
    rng = np.random.RandomState(3)
    scfg = swin_tiny_test(ftmode="fusion", label_dim=7)
    ccfg = clip_tiny_test(ftmode="fusion", label_dim=7)
    sb = {"a": rng.randn(4, scfg.num_frames, scfg.img_size, scfg.img_size).astype(np.float32),
          "v": rng.randn(4, scfg.num_frames, scfg.img_size, scfg.img_size, 3).astype(np.float32)}
    cb = {"a": rng.randn(4, ccfg.num_frames, ccfg.audio_tdim, ccfg.audio_fdim).astype(np.float32),
          "v": rng.randn(4, ccfg.num_frames, ccfg.input_resolution, ccfg.input_resolution,
                         3).astype(np.float32)}
    return [("add_ave", "swin", scfg, ave.random_swin_ave(scfg, 1), sb),
            ("add_clip_ave", "clip", ccfg, ave.random_clip_ave(ccfg, 2), cb)]


def server(mesh, shard_tower, out):
    for add, name, cfg, model, batch in ave_tasks():
        single = MultiTaskServer(torch.float32, "cpu")
        getattr(single, add)(name, cfg, model)
        srv = MultiTaskServer(torch.float32, "cpu", mesh=mesh, shard_tower=shard_tower)
        getattr(srv, add)(name, cfg, model)
        want, got = single.predict(name, batch), srv.predict(name, batch)
        out[f"{name}_shape_equal"] = list(got.shape) == list(want.shape)
        out[f"{name}_rel"] = rel(got, want)
        if shard_tower:
            m = M.extent(mesh, "model")
            full, split = dict(single.models[name].named_parameters()), 0
            for n, p in srv.models[name].named_parameters():
                if n.endswith(".original"):
                    base = n.replace("parametrizations.", "").rsplit(".", 1)[0]
                    assert M.param_spec(base, full[base]) is not None, base
                    assert p.numel() * m == full[base].numel(), base
                    split += 1
            out[f"{name}_split_leaves"] = split
        try:
            srv.predict(name, {k: v[:3] for k, v in batch.items()})
            out[f"{name}_indivisible"] = "no error"
        except ValueError as e:
            out[f"{name}_indivisible"] = str(e)


def avs_step(mesh, exp):
    args = SimpleNamespace(tiny=True, ftmode="fusion", num_frames=2, use_temporal_attn=True,
                           use_t_adapter=True, use_s_adapter=True, use_g_adapter=True,
                           lambda_1=0.0, sa_loss=False, tpavi_stages=(0, 1))
    cfg, hcfg = avs_cli.build(args)
    img = cfg.img_size
    fb = dataclasses.replace(SWIN_FBANK, num_mel_bins=img)
    pipe = make_avs_device_pipeline(fb, img, device="cpu")
    ds = avs_cli.SyntheticAVS(4, args.num_frames, img, split="train")
    batch = collate([ds[i] for i in range(4)])
    model = avs.random_avs(cfg, hcfg, 4)
    trainer = Trainer(loss_fn=avs_cli.make_loss_fn(cfg, hcfg, pipe, args, torch.float32),
                      eval_fn=lambda m, b: {}, model=model, base_lr=1e-3, head_lr_mult=10.0,
                      n_epochs=1, steps_per_epoch=1, exp_dir=exp, compute_dtype=torch.float32,
                      mesh=mesh)
    trainer.train_epoch(1, [batch], torch.Generator().manual_seed(5))
    return trainer


def ave_step(mesh, exp):
    cfg = swin_tiny_test(ftmode="fusion", label_dim=7)
    img = cfg.img_size
    fb = dataclasses.replace(SWIN_FBANK, num_mel_bins=img)
    pipe = make_ave_device_pipeline(fb, img, train=True, image_size=img, mixup=0.9,
                                    device="cpu")
    ds = SyntheticAVE(n=4, num_frames=cfg.num_frames, size=img + 8, label_dim=7)
    batch = collate([ds[i] for i in range(4)])

    def loss_fn(m, b, generator):
        a, v = pipe(b, generator)
        logits = ave.apply_swin_ave(m, cfg, a, v, generator=generator)
        return losses.ave_loss(logits, torch.as_tensor(b["labels"])), {}

    trainer = Trainer(loss_fn=loss_fn, eval_fn=lambda m, b: {},
                      model=ave.random_swin_ave(cfg, 6), base_lr=1e-3, head_lr_mult=10.0,
                      n_epochs=1, steps_per_epoch=1, exp_dir=exp, compute_dtype=torch.float32,
                      mesh=mesh)
    trainer.train_epoch(1, [batch], torch.Generator().manual_seed(7))
    return trainer


def train(mesh, out):
    for name, step in (("avs", avs_step), ("ave", ave_step)):
        with tempfile.TemporaryDirectory() as d1, tempfile.TemporaryDirectory() as d2:
            single, meshed = step(None, d1), step(mesh, d2)
        a, b = single.trainable(), meshed.trainable()
        names = [n for n in sorted(a) if a[n].grad is not None]
        g_a = torch.cat([a[n].grad.reshape(-1) for n in names])
        g_b = torch.cat([b[n].grad.reshape(-1) for n in names])
        out[f"{name}_loss_rel"] = rel(meshed.step_losses, single.step_losses)
        out[f"{name}_grad_rel"] = rel(g_b, g_a)
        # Adam's first update is lr * g / (|g| + eps): where a gradient is
        # zero to rounding (TPAVI's W_z conv bias, which the BatchNorm after
        # it cancels), its sign is noise and the master moves by +-lr either
        # way; the masters are compared where |g| is above 1e-4 of max |g|
        live = g_a.abs() > 1e-4 * g_a.abs().max()
        m_a = torch.cat([a[n].detach().reshape(-1) for n in names])
        m_b = torch.cat([b[n].detach().reshape(-1) for n in names])
        out[f"{name}_master_rel"] = rel(m_b[live], m_a[live]) if live.any() else 0.0
        out[f"{name}_live_share"] = float(live.float().mean())
        out[f"{name}_buffer_rel"] = max([rel(meshed.buffers()[n], t)
                                         for n, t in single.buffers().items()] or [0.0])
        flat = torch.cat([b[n].detach().reshape(-1) for n in sorted(b)])
        parts = [torch.empty_like(flat) for _ in range(dist.get_world_size())]
        dist.all_gather(parts, flat)
        out[f"{name}_masters_equal_across_ranks"] = all(torch.equal(p, parts[0]) for p in parts)
        state = meshed.params()
        out[f"{name}_params_names_equal"] = sorted(state) == sorted(single.params())


def main():
    mode, path = sys.argv[1], sys.argv[2]
    assert M.init_distributed(), "the STGCMA_* variables were not picked up"
    assert M.init_distributed(), "a second call must be a no-op returning True"
    out = {"rank": dist.get_rank(), "backend": dist.get_backend()}
    if mode == "server_data":
        server(M.make_mesh(2, 1), False, out)
    elif mode == "server_model":
        server(M.make_mesh(1, 2), True, out)
    else:
        train(M.make_mesh(2, 1), out)
    with open(path, "w") as f:
        json.dump(out, f)
    dist.destroy_process_group()


if __name__ == "__main__":
    main()
