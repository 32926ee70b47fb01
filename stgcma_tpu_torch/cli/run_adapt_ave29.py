"""AVE-29 experiment entry point (the reference's: AVE/run_adapt_ave29.py).

Port of `stgcma_tpu/cli/run_adapt_ave29.py`: the same flag surface (model,
ftmode, lr, head_lr, n_epochs, batch_size, adapter ratios, warmup, wa
averaging, the scheduler selection, data roots, --synthetic, --tiny,
--resume) plus `--device` (default "cuda"; "cpu" runs the kernels' plain
versions), and the same flow: the train pipeline (RandAugment, crop, flip,
erasing, optional waveform mixup, fbank) on the device, the model with the
head's dropout, the AVE loss, the Trainer with its per-epoch evaluation and
checkpoints, weight averaging (--wa) and the multi-frame evaluation
(--skip_frame_agg False). `--tiny` means `swin_tiny_test`, as in JAX.

Compute is bf16 with fp32 masters (`train.steps`), in training and in
evaluation, and the pipeline's fp32 (a, v) are cast to bf16 before the
model: the port's kernels take bf16 activations. The JAX CLI passes its
fp32 pipeline output to bf16 parameters (its XLA promotes the activations
to fp32) and evaluates on the fp32 masters.

Usage (synthetic smoke on the CPU):
    python -m stgcma_tpu_torch.cli.run_adapt_ave29 --synthetic True --tiny True \
        --device cpu --n-epochs 2 --batch_size 2 --synthetic_n 4 --exp-dir /tmp/exp
"""
from __future__ import annotations

import argparse
import copy
import os

import numpy as np
import torch

from ..checkpoint.io import load_checkpoint
from ..data.datasets import AVEDataset, SyntheticAVE
from ..data.loader import DataLoader, make_ave_device_pipeline
from ..metrics.stats import calculate_stats
from ..models import ave
from ..ops.common import resolve_device
from ..ops.fbank import CLIP_FBANK, SWIN_FBANK
from ..train import losses
from ..train.loop import Trainer, weight_average
from ..train.steps import make_eval_step
from .common import (archive_args, build_ave_model, maybe_load_pretrained, seed_everything,
                     str2bool)

COMPUTE_DTYPE = torch.bfloat16


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--model", default="MM-Swin-AVE-Base")
    p.add_argument("--ftmode", default="fusion",
                   choices=["videoonly", "audioonly", "multimodal", "fusion"])
    p.add_argument("--dataset", default="ave29")
    p.add_argument("--n_class", type=int, default=29)
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--head_lr", type=float, default=50.0)
    p.add_argument("--min_lr", type=float, default=1e-7)
    p.add_argument("--warmup_epochs", type=int, default=2)
    p.add_argument("--n-epochs", "--n_epochs", dest="n_epochs", type=int, default=10)
    p.add_argument("--batch_size", "--batch-size", dest="batch_size",
                   type=int, default=2)
    p.add_argument("--adapter_ratios", type=float, nargs="*", default=None)
    p.add_argument("--freeze_base", type=str2bool, default=True)
    p.add_argument("--loss", default="CE", choices=["CE", "BCE"])
    p.add_argument("--wa", type=str2bool, default=False)
    p.add_argument("--wa_start", type=int, default=1)
    p.add_argument("--wa_end", type=int, default=5)
    p.add_argument("--exp-dir", "--exp_dir", dest="exp_dir", default="./exp/ave29")
    p.add_argument("--pretrain_path", default="")
    # parsed by the reference entry point but never consumed
    # (AVE/run_adapt_ave29.py:73 has no args.finetune_path reader) —
    # accepted and warned about below, like freqm/timem
    p.add_argument("--finetune_path", default="")
    p.add_argument("--num_workers", "--num-workers", dest="num_workers",
                   type=int, default=8)
    # fbank target frames (reference audio_conf['target_length'],
    # AVE/run_adapt_ave29.py:93); default None = derive from the model preset
    p.add_argument("--target_length", type=int, default=None)
    # 'use warmup lr scheduler' bool (reference --warmup); False forces
    # warmup_epochs to 0
    p.add_argument("--warmup", type=str2bool, default=True)
    # gate per-epoch checkpoint export (reference --save_model,
    # traintest_adapt_ave29.py:228); best checkpoint is always kept
    p.add_argument("--save_model", type=str2bool, default=True)
    p.add_argument("--dataset_mean", type=float, default=-5.081)
    p.add_argument("--dataset_std", type=float, default=4.485)
    # waveform mixup probability (reference default 0 — AVE/run_adapt_ave29.py)
    p.add_argument("--mixup", type=float, default=0.0)
    # balanced sampling (AVE/run_adapt_ave29.py:101-111): per-sample weights
    # csv -> WeightedRandomSampler-with-replacement semantics
    p.add_argument("--bal", default="none",
                   help="'bal' enables the weighted sampler (needs --weight_csv)")
    p.add_argument("--weight_file", default=None,
                   help="reference weight-file suffix (accepted; use "
                        "--weight_csv for the explicit path)")
    p.add_argument("--weight_csv", default="",
                   help="per-sample weights csv for --bal bal")
    # LR scheduler selection (AVE/traintest_adapt_ave29.py:79-107)
    p.add_argument("--lr_adapt", type=str2bool, default=False,
                   help="ReduceLROnPlateau(mode=max, factor=0.5)")
    p.add_argument("--lr_patience", type=int, default=2)
    p.add_argument("--lr_cosine_adapt", type=str2bool, default=True)
    p.add_argument("--lrscheduler_start", type=int, default=10)
    p.add_argument("--lrscheduler_step", type=int, default=5)
    p.add_argument("--lrscheduler_decay", type=float, default=0.5)
    # accepted-but-inert in the reference launch configs (freqm/timem/noise
    # are parsed by the reference entry points and passed with 0/False; label
    # smoothing is parsed and never applied) — accept and warn when set
    p.add_argument("--freqm", type=int, default=0)
    p.add_argument("--timem", type=int, default=0)
    p.add_argument("--noise", type=str2bool, default=False)
    p.add_argument("--label_smooth", type=float, default=0.0)
    # post-train multi-frame ensemble eval (AVE/run_adapt_ave29.py:230-283);
    # True skips it (the reference default path)
    p.add_argument("--skip_frame_agg", type=str2bool, default=True)
    p.add_argument("--total_frames", type=int, default=1)
    p.add_argument("--metrics", default="acc", choices=["acc", "mAP"])
    # data roots (replacing hard-coded ./STG-CMA/... paths). The reference
    # launch scripts pass the SAME files under audioset-era flag names:
    # --data-train/--data-val are the order h5 files and --label-csv is the
    # one-hot labels h5 (AVE/dataloader.py:82,120) — accepted as aliases.
    p.add_argument("--train_order_h5", "--data-train", dest="train_order_h5",
                   default="")
    p.add_argument("--test_order_h5", "--data-val", dest="test_order_h5",
                   default="")
    p.add_argument("--labels_h5", "--label-csv", dest="labels_h5", default="")
    p.add_argument("--annotations_txt", default="")
    p.add_argument("--frames_root", default="")
    p.add_argument("--audio_root", default="")
    p.add_argument("--synthetic", type=str2bool, default=False)
    p.add_argument("--synthetic_n", type=int, default=8)
    # CI-sized model override (not a reference preset)
    p.add_argument("--tiny", type=str2bool, default=False)
    p.add_argument("--resume", type=str2bool, default=False)
    # the port's one flag of its own: where the model runs ("cuda", or "cpu"
    # for the kernels' plain versions)
    p.add_argument("--device", default="cuda")
    return p.parse_args(argv)


def make_eval_fn(eval_step, pipe, label_dim):
    """eval_fn(model, loader) -> {"acc", "mAP", "_stats"} over the loader's
    batches, logits from eval_step(model, (a, v))."""
    def eval_fn(model, loader):
        outs, tgts = [], []
        for batch in loader:
            logits = eval_step(model, pipe(batch))
            outs.append(logits.float().cpu().numpy())
            tgts.append(np.asarray(batch["labels"]).reshape(-1, label_dim))
        if not outs:
            return {}
        output, target = np.concatenate(outs), np.concatenate(tgts)
        stats = calculate_stats(output, target)
        return {"acc": stats[0]["acc"],
                "mAP": float(np.nanmean([s["AP"] for s in stats])),
                # full per-class stats list: Trainer pickles it per epoch
                # (stats_<epoch>.pickle, AVE/traintest_adapt_ave29.py:243-244)
                "_stats": stats}
    return eval_fn


def frame_agg_eval(infer, model, eval_pipe, te, args):
    """Multi-frame ensemble evaluation (AVE/run_adapt_ave29.py:230-283):
    softmax / sigmoid outputs averaged over frame configurations
    (total_frames=1 in the reference), a metric per frame and ensembled,
    results in mul_frame_res.csv."""
    res, multiframe_pred, target = [], [], None
    for frame in range(args.total_frames):
        outs, tgts = [], []
        for batch in te:
            outs.append(infer(model, eval_pipe(batch)).float().cpu().numpy())
            tgts.append(np.asarray(batch["labels"]).reshape(-1, args.n_class))
        output, target = np.concatenate(outs), np.concatenate(tgts)
        stats = calculate_stats(output, target)
        if args.metrics == "acc":
            ex = output - output.max(-1, keepdims=True)
            output = np.exp(ex) / np.exp(ex).sum(-1, keepdims=True)
            cur = stats[0]["acc"]
            print(f"acc of frame {frame} is {cur:.4f}")
        else:
            output = 1.0 / (1.0 + np.exp(-output))
            cur = float(np.nanmean([s["AP"] for s in stats]))
            print(f"mAP of frame {frame} is {cur:.4f}")
        multiframe_pred.append(output)
        res.append(cur)
    mf = np.mean(multiframe_pred, axis=0)
    if args.metrics == "acc":
        ens = float(np.mean(np.argmax(target, 1) == np.argmax(mf, 1)))
        print(f"multi-frame acc is {ens:f}")
    else:
        ens = float(np.nanmean([s["AP"] for s in calculate_stats(mf, target)]))
        print(f"multi-frame mAP is {ens:.4f}")
    res.append(ens)
    np.savetxt(os.path.join(args.exp_dir, "mul_frame_res.csv"), np.asarray(res), delimiter=",")


def main(argv=None):
    args = parse_args(argv)
    device = resolve_device(args.device)
    seed_everything(0)
    archive_args(args, args.exp_dir)

    if args.tiny:
        from ..configs import swin_tiny_test
        flavor, cfg = "swin", swin_tiny_test(ftmode=args.ftmode, label_dim=args.n_class)
    else:
        flavor, cfg = build_ave_model(args.model, args.ftmode, args.n_class,
                                      args.adapter_ratios)
    init_fn = ave.init_swin_ave if flavor == "swin" else ave.init_clip_ave
    apply_raw = ave.apply_swin_ave if flavor == "swin" else ave.apply_clip_ave
    model = init_fn(cfg, generator=torch.Generator().manual_seed(0), device=device)
    model = maybe_load_pretrained(model, args.pretrain_path, flavor, cfg, device)

    fb = SWIN_FBANK if flavor == "swin" else CLIP_FBANK
    target_len = 224 if flavor == "swin" else 102
    img = cfg.img_size if flavor == "swin" else cfg.input_resolution
    if args.tiny:
        import dataclasses as _dc
        fb = _dc.replace(SWIN_FBANK, num_mel_bins=img)
        target_len = img

    if args.synthetic:
        tr_ds = SyntheticAVE(n=args.synthetic_n, num_frames=cfg.num_frames, size=img,
                             label_dim=args.n_class)
        te_ds = SyntheticAVE(n=args.synthetic_n // 2, num_frames=cfg.num_frames, size=img,
                             label_dim=args.n_class, seed=10_000)
    else:
        tr_ds = AVEDataset(args.train_order_h5, args.labels_h5, args.frames_root,
                           args.audio_root, cfg.num_frames, mode="train",
                           annotations_txt=args.annotations_txt)
        te_ds = AVEDataset(args.test_order_h5, args.labels_h5, args.frames_root,
                           args.audio_root, cfg.num_frames, mode="eval",
                           annotations_txt=args.annotations_txt)

    for flag in ("freqm", "timem", "noise", "label_smooth", "finetune_path"):
        if getattr(args, flag):
            print(f"warning: --{flag} is accepted for reference-surface "
                  "compatibility but has no effect (the reference parses it "
                  "and never consumes it in the launch configs)")
    if args.target_length is not None and args.target_length != target_len:
        print(f"warning: --target_length {args.target_length} conflicts with "
              f"the tower's audio geometry ({target_len} frames for this "
              "preset); keeping the preset")

    weights = None
    if args.bal == "bal":
        print("balanced sampler is being used")
        if not args.weight_csv:
            raise SystemExit("--bal bal requires --weight_csv (per-sample "
                             "weights, one float per line)")
        weights = np.loadtxt(args.weight_csv, delimiter=",")
    else:
        print("balanced sampler is not used")
    tr = DataLoader(tr_ds, args.batch_size, shuffle=True, num_workers=args.num_workers,
                    sample_weights=weights)
    te = DataLoader(te_ds, args.batch_size, shuffle=False, num_workers=args.num_workers,
                    drop_last=False)

    train_pipe = make_ave_device_pipeline(fb, target_len, args.dataset_mean, args.dataset_std,
                                          train=True, image_size=img, mixup=args.mixup,
                                          device=device)
    eval_pipe = make_ave_device_pipeline(fb, target_len, args.dataset_mean, args.dataset_std,
                                         train=False, image_size=img, device=device)
    dt = COMPUTE_DTYPE

    def loss_fn(m, batch, generator):
        a, v = train_pipe(batch, generator)
        logits = apply_raw(m, cfg, a.to(dt), v.to(dt), generator=generator)
        labels = torch.as_tensor(batch["labels"]).to(device)
        return losses.ave_loss(logits, labels, args.loss), {}

    infer = make_eval_step(lambda m, av: apply_raw(m, cfg, av[0].to(dt), av[1].to(dt)), dt)

    # scheduler precedence mirrors AVE/traintest_adapt_ave29.py:79-107
    lr_mode = ("plateau" if args.lr_adapt
               else "cosine" if args.lr_cosine_adapt else "multistep")
    if args.wa and not args.save_model:
        # weight averaging loads models/model.{wa_start..} after training —
        # without per-epoch checkpoints it would crash at the very end
        raise SystemExit("--wa True requires --save_model True (weight "
                         "averaging reads the per-epoch checkpoints, "
                         "AVE/run_adapt_ave29.py:203-214)")
    trainer = Trainer(
        loss_fn=loss_fn, eval_fn=make_eval_fn(infer, eval_pipe, args.n_class),
        model=model, base_lr=args.lr, head_lr_mult=args.head_lr,
        n_epochs=args.n_epochs, steps_per_epoch=max(len(tr), 1),
        warmup_epochs=args.warmup_epochs if args.warmup else 0,
        min_lr=args.min_lr, exp_dir=args.exp_dir, freeze_base=args.freeze_base,
        compute_dtype=dt, save_every_epoch=args.save_model,
        lr_mode=lr_mode, plateau_patience=args.lr_patience,
        multistep=(args.lrscheduler_start, args.lrscheduler_step, args.lrscheduler_decay))
    trainer.fit(tr, te, seed=0, resume=args.resume)

    final = trainer.model
    if args.wa:
        trees = [load_checkpoint(os.path.join(args.exp_dir, "models", f"model.{e}"))
                 for e in range(args.wa_start, min(args.wa_end, args.n_epochs) + 1)]
        final = copy.deepcopy(trainer.model)
        final.load_state_dict(weight_average(trees))
        metrics = make_eval_fn(infer, eval_pipe, args.n_class)(final, te)
        metrics.pop("_stats", None)
        print("weight-averaged eval:", metrics)

    if not args.skip_frame_agg:
        frame_agg_eval(infer, final, eval_pipe, te, args)
    print("done. best epoch", trainer.best_epoch, "best", trainer.best_metric)
    return trainer


if __name__ == "__main__":
    main()
