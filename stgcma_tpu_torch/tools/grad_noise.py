"""How far bf16 rounding moves each trainable leaf's gradient of one AVQA
train step from its fp32 gradient, on the card and on the CPU, over seeds.

    python3 -m stgcma_tpu_torch.tools.grad_noise [--seeds 0,1,2,3] [--batch 2]
        [--depths 2,2,2,2] [--out DIR]

For each seed: `random_avqa` (Swin-Large fusion at T = 10 cut to
`--depths`, live adapters, gates and tables) and a synthetic batch, both
drawn from the seed, through `cli.run_adapt_avqa.make_loss_fn` (no dropout
draw) and `make_train_step` at lr 0, as `chip_smoke.py`'s step against the
CPU runs it. The step runs once in fp32 on the CPU (the yardstick) and in
bf16 in these variants:
- `cpu`: bf16 on the CPU (every wrapper's plain version forward, its
  recompute backward);
- `card`: bf16 on the card (every kernel forward);
- `card plain`: bf16 on the card with every wrapper on its plain version
  forward (the same arithmetic as `cpu`, on the card's libraries);
- `card fp32 reductions`: `card` with cuBLAS's reduced-precision bf16
  reductions off;
- `card K<n> plain`: `card` with only kernel K<n> on its plain version, for
  each kernel the step launches;
- `card fp32 plain`: fp32 on the card, every wrapper on its plain version
  (the card's distance from the CPU where no bf16 rounding enters).
For each variant and leaf, d = max |g - g_fp32|, and against `cpu`'s d the
bar of `chip_smoke.py`'s step (0.1 of the leaf's max |g_fp32| plus 1.5 x
the CPU's d). Prints each one-element leaf (the fusion gates) per seed, a
summary per variant (leaves past that bar, the ratio d / d_cpu over the
tensors and over the gates) and writes everything to DIR/grad_noise.json
(default build/grad_noise). Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import contextlib
import copy
import dataclasses
import json
import os
import statistics
import sys
import time

import torch

from ..cli import run_adapt_avqa as cli
from ..configs import AVQAHeadConfig, swin_large
from ..data.loader import collate, make_avqa_device_pipeline
from ..models.avqa import random_avqa
from ..ops import cuda_lib
from ..ops import fused_attn as FA
from ..ops.fbank import SWIN_FBANK
from ..train import optim, steps

LEAF_TOL, NOISE = 1e-1, 1.5      # chip_smoke.py's TOL_TRAIN_LEAF and TRAIN_NOISE


@contextlib.contextmanager
def plain_forward(ids):
    """Every wrapper whose id is in `ids` runs its plain version on the card
    too (the backward is its recompute either way)."""
    routed = [k for k in FA.KERNELS if k.id in ids]
    for k in routed:
        k.run = (lambda k: lambda x, *a, **kw: k.plain(x, *a, **kw))(k)
    try:
        yield
    finally:
        for k in routed:
            del k.run


@contextlib.contextmanager
def reduced_precision_reductions(on):
    m = torch.backends.cuda.matmul
    was = m.allow_bf16_reduced_precision_reduction
    m.allow_bf16_reduced_precision_reduction = on
    try:
        yield
    finally:
        m.allow_bf16_reduced_precision_reduction = was


def step_grads(base, cfg, hcfg, batch, dev, dtype):
    """The loss and {name: fp32 gradient on the CPU} of one step at lr 0."""
    args = cli.parse_args([])
    model = copy.deepcopy(base).to(dev)
    steps.init_train_state(model)
    pipe = make_avqa_device_pipeline(SWIN_FBANK, 224, args.dataset_mean, args.dataset_std,
                                     device=dev)
    loss_fn = cli.make_loss_fn(cfg, hcfg, pipe, args, dtype)
    step = steps.make_train_step(lambda m, _, generator: loss_fn(m, batch, None),
                                 optim.build_optimizer(model, 0.0, 1.0), dtype)
    FA.reset_launches()
    loss, _ = step(model, None)
    launched = sorted(k.id for k in FA.KERNELS if k.launches)
    grads = {n: p.grad.float().cpu() for n, p in model.named_parameters()
             if p.requires_grad and p.grad is not None}
    return float(loss), grads, launched


def distances(grads, ref):
    return {n: (grads[n] - g).abs().max().item() for n, g in ref.items()}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seeds", default="0,1,2,3")
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--depths", default="2,2,2,2")
    ap.add_argument("--out", default=os.path.join("build", "grad_noise"))
    a = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("grad_noise: needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    cuda_lib.build()
    depths = tuple(int(x) for x in a.depths.split(","))
    cfg = dataclasses.replace(swin_large(ftmode="fusion", num_frames=10), depths=depths)
    hcfg = AVQAHeadConfig(feat_dim=cfg.num_features, grid=7, num_frames=10)
    bf = torch.bfloat16
    report = {"batch": a.batch, "depths": depths, "device": torch.cuda.get_device_name(0),
              "seeds": {}}
    for seed in (int(s) for s in a.seeds.split(",")):
        base = random_avqa(cfg, hcfg, seed)
        ds = cli.SyntheticAVQA(a.batch, cfg.num_frames, cfg.img_size, seed=seed)
        batch = {k: v for k, v in collate([ds[i] for i in range(a.batch)]).items()
                 if k != "qtype"}
        loss32, ref, _ = step_grads(base, cfg, hcfg, batch, "cpu", torch.float32)
        runs = {"cpu": lambda: step_grads(base, cfg, hcfg, batch, "cpu", bf)}
        card = lambda dt=bf: step_grads(base, cfg, hcfg, batch, "cuda", dt)   # noqa: E731
        runs["card"] = card
        _, _, path = card()
        every = {k.id for k in FA.KERNELS}

        def under(ctx, dt=bf):
            def run():
                with ctx():
                    return card(dt)
            return run
        runs["card plain"] = under(lambda: plain_forward(every))
        runs["card fp32 reductions"] = under(lambda: reduced_precision_reductions(False))
        for kid in path:
            runs[f"card {kid} plain"] = under(lambda kid=kid: plain_forward({kid}))
        runs["card fp32 plain"] = under(lambda: plain_forward(every), torch.float32)
        got = {}
        for name, run in runs.items():
            try:
                loss, grads, launched = run()
            except Exception as e:  # noqa: BLE001  a variant that cannot run is reported
                print(f"seed {seed} {name}: {type(e).__name__}: {e}", flush=True)
                continue
            got[name] = {"loss": loss, "launched": launched, "d": distances(grads, ref)}
        scale = {n: g.abs().max().item() for n, g in ref.items()}
        gates = sorted(n for n, g in ref.items() if g.numel() == 1)
        dc = got["cpu"]["d"]
        summary = {}
        for name, r in got.items():
            d = r["d"]
            past = [n for n in ref if d[n] > LEAF_TOL * scale[n] + NOISE * dc[n]]
            ratio = lambda ns: sorted(d[n] / max(dc[n], 1e-30) for n in ns)   # noqa: E731
            tens, gat = ratio([n for n in ref if n not in gates]), ratio(gates)
            summary[name] = {"loss": r["loss"], "launched": r["launched"], "past_bar": past,
                             "tensor_ratio_median": statistics.median(tens),
                             "tensor_ratio_max": tens[-1],
                             "gate_ratio_median": statistics.median(gat),
                             "gate_ratio_max": gat[-1], "gate_ratio_min": gat[0],
                             "gate_rel": {n: d[n] / max(scale[n], 1e-30) for n in gates}}
        report["seeds"][seed] = {"loss_fp32": loss32, "gate_fp32": {n: ref[n].item()
                                                                    for n in gates},
                                 "summary": summary}
        print(f"seed {seed}: fp32 loss {loss32:.6f}; the gates' |g_fp32| and d / |g_fp32| by "
              f"variant:", flush=True)
        names = list(summary)
        print("  " + " | ".join(["gate", "g_fp32"] + names), flush=True)
        for n in gates:
            print("  " + " | ".join([n.replace("backbone.layers.", "L"), f"{ref[n].item():.3e}"]
                                    + [f"{summary[v]['gate_rel'][n]:.3g}" for v in names]),
                  flush=True)
        for v, s in summary.items():
            print(f"  {v}: loss {s['loss']:.6f}, {len(s['past_bar'])} leaves past the bar "
                  f"{s['past_bar'][:4]}, d / d_cpu: tensors median {s['tensor_ratio_median']:.3g} "
                  f"max {s['tensor_ratio_max']:.3g}; gates min {s['gate_ratio_min']:.3g} median "
                  f"{s['gate_ratio_median']:.3g} max {s['gate_ratio_max']:.3g}", flush=True)
        print(f"  ({time.perf_counter() - t0:.1f} s)", flush=True)
    os.makedirs(a.out, exist_ok=True)
    with open(os.path.join(a.out, "grad_noise.json"), "w") as f:
        json.dump(report, f, indent=1)
    print(f"{torch.cuda.get_device_name(0)}; written {os.path.join(a.out, 'grad_noise.json')}; "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
