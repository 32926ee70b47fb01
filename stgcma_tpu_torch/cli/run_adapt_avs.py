"""AVSBench S4/MS3 experiment entry point (the reference's: AVS/run_adapt_avs.py).

Port of `stgcma_tpu/cli/run_adapt_avs.py`: the same flag surface plus
`--device` (default "cuda"; "cpu" runs the kernels' plain versions), and the
same flow: the Swin fusion backbone with the ASPP / TPAVI / FPN decoder
(`models/avs.py`), trained with the F1-IoU BCE loss (`iou_semantic_aware_loss`;
the reference's train loop takes it whatever `--loss` says), TPAVI's W_z
BatchNorms in batch-statistics mode with their running statistics updated
after each step (`aux["state_updates"]`, `Trainer`), evaluated by MIoU on the
first frame's mask (train split) or every frame's (test split), `--eval_only`
with `--ckpt`, `--wa` averaging and P-mode PNG masks (`--save_mask_dir`).
`make_avs_device_pipeline` serves training and evaluation alike (normalize
only: AVSBench frames come pre-sized). `--tiny` means `swin_tiny_test` with
a two-stage decoder, as in JAX.

Compute is bf16 with fp32 masters, the BatchNorm statistics fp32
(`train.steps`); evaluation runs in bf16 (`make_eval_step`), and the
pipeline's fp32 (a, v) are cast to bf16 before the model, as
`run_adapt_ave29` does. With STGCMA_DETERMINISTIC=1 in the environment the
run takes torch's deterministic algorithms (`common.deterministic_algorithms`):
only then does a run resumed on the card reach the straight run bit for bit.

Usage (synthetic smoke on the CPU):
    python -m stgcma_tpu_torch.cli.run_adapt_avs --synthetic True --tiny True \
        --device cpu --n-epochs 2 --batch_size 2 --num_frames 2 --exp-dir /tmp/exp
"""
from __future__ import annotations

import argparse
import copy
import dataclasses
import os

import numpy as np
import torch

from ..checkpoint.io import load_checkpoint
from ..configs import AVSHeadConfig, swin_base, swin_large, swin_tiny_test
from ..data.datasets import AVSDataset
from ..data.loader import DataLoader, make_avs_device_pipeline
from ..models import avs
from ..ops.common import resolve_device
from ..runtime.mesh import init_distributed
from ..ops.fbank import SWIN_FBANK
from ..train import losses
from ..train.loop import Trainer, weight_average
from ..train.steps import make_eval_step
from .common import (archive_args, deterministic_algorithms, maybe_load_pretrained,
                     seed_everything, str2bool)

COMPUTE_DTYPE = torch.bfloat16


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--model", default="MM-Swin-AVS-Large",
                   choices=["MM-Swin-AVS-Base", "MM-Swin-AVS-Large"])
    p.add_argument("--session", default="S4", choices=["S4", "MS3"])
    p.add_argument("--ftmode", default="fusion",
                   choices=["videoonly", "audioonly", "multimodal", "fusion"])
    p.add_argument("--dataset", default="avsbench")
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--head_lr", type=float, default=0.1)
    p.add_argument("--min_lr", type=float, default=1e-7)
    p.add_argument("--warmup_epochs", type=int, default=1)
    p.add_argument("--warmup", type=str2bool, default=True)
    p.add_argument("--n-epochs", "--n_epochs", dest="n_epochs", type=int, default=15)
    p.add_argument("--batch_size", "--batch-size", dest="batch_size", type=int, default=2)
    p.add_argument("--num_frames", type=int, default=5)
    p.add_argument("--adapter_ratios", type=float, nargs="*", default=None)
    p.add_argument("--tpavi_stages", type=int, nargs="*", default=[0, 1, 2, 3])
    p.add_argument("--sa_loss", type=str2bool, default=False)
    p.add_argument("--lambda_1", type=float, default=0.0)
    p.add_argument("--exp-dir", "--exp_dir", dest="exp_dir", default="./exp/avs")
    p.add_argument("--pretrain_path", default="")
    p.add_argument("--freeze_base", type=str2bool, default=True)
    # the reference train loop takes IouSemanticAwareLoss whatever --loss says
    # (AVS/traintest_adapt_avs.py:162); CE / BCE warn below
    p.add_argument("--loss", default="IoU", choices=["IoU", "CE", "BCE"])
    p.add_argument("--metrics", default="miou", choices=["miou", "acc", "mAP"])
    # weight averaging over the per-epoch checkpoints (AVS/run_adapt_avs.py:243-252)
    p.add_argument("--wa", type=str2bool, default=False)
    p.add_argument("--wa_start", type=int, default=1)
    p.add_argument("--wa_end", type=int, default=5)
    # scheduler selection (AVS/traintest_adapt_avs.py:82-110)
    p.add_argument("--lr_adapt", type=str2bool, default=False)
    p.add_argument("--lr_patience", type=int, default=2)
    p.add_argument("--lr_cosine_adapt", type=str2bool, default=True)
    p.add_argument("--lrscheduler_start", type=int, default=10)
    p.add_argument("--lrscheduler_step", type=int, default=5)
    p.add_argument("--lrscheduler_decay", type=float, default=0.5)
    # balanced sampler (AVS/run_adapt_avs.py:113-121)
    p.add_argument("--bal", default="none")
    p.add_argument("--weight_file", default=None)
    p.add_argument("--weight_csv", default="")
    p.add_argument("--save_model", type=str2bool, default=True)
    p.add_argument("--meta_csv", default="")
    p.add_argument("--data_root", default="")
    # the reference's per-kind data roots (AVS/run_adapt_avs.py:89-92);
    # dir_audio_log_mel (VGGish pkls) is accepted and its pkls returned with
    # each batch; the Swin trainer computes its log-mel from the wav
    p.add_argument("--dir_image", default="")
    p.add_argument("--dir_mask", default="")
    p.add_argument("--dir_audio_wav", default="")
    p.add_argument("--dir_audio_log_mel", default="")
    p.add_argument("--num_workers", "--num-workers", dest="num_workers", type=int, default=8)
    p.add_argument("--dataset_mean", type=float, default=-5.269)
    p.add_argument("--dataset_std", type=float, default=4.578)
    p.add_argument("--target_length", type=int, default=None)
    # parsed and never read by the reference AVS driver
    p.add_argument("--freqm", type=int, default=0)
    p.add_argument("--timem", type=int, default=0)
    p.add_argument("--noise", type=str2bool, default=False)
    p.add_argument("--label_smooth", type=float, default=0.0)
    p.add_argument("--mixup", type=float, default=0.0)
    p.add_argument("--finetune_path", default="")
    p.add_argument("--save_mask_dir", default="")
    p.add_argument("--synthetic", type=str2bool, default=False)
    p.add_argument("--tiny", type=str2bool, default=False)
    # mid-training resume (beyond the reference): the masters, Adam's state,
    # the LR position and the BatchNorm statistics from exp_dir/state
    p.add_argument("--resume", type=str2bool, default=False)
    # ablation switches (AVS/run_adapt_avs_ablation.sh)
    p.add_argument("--eval_only", type=str2bool, default=False)
    p.add_argument("--ckpt", default="")
    p.add_argument("--use_temporal_attn", type=str2bool, default=True)
    p.add_argument("--use_t_adapter", type=str2bool, default=True)
    p.add_argument("--use_s_adapter", type=str2bool, default=True)
    p.add_argument("--use_g_adapter", type=str2bool, default=True)
    # the port's one flag of its own: where the model runs ("cuda", or "cpu"
    # for the kernels' plain versions)
    p.add_argument("--device", default="cuda")
    return p.parse_args(argv)


class SyntheticAVS:
    """Seeded random AVS items: uint8 frames (T, size, size, 3), wave (T,
    31200) ~ N(0, 0.1), binary masks (1 for train, T for test)."""

    def __init__(self, n=4, num_frames=5, size=224, seed=0, split="train"):
        self.n, self.T, self.size, self.seed = n, num_frames, size, seed
        self.split = split

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        rng = np.random.RandomState(self.seed + i)
        k = 1 if self.split == "train" else self.T
        return {"frames": rng.randint(0, 256, (self.T, self.size, self.size, 3), np.uint8),
                "wave": (rng.randn(self.T, 31200) * 0.1).astype(np.float32),
                "masks": (rng.rand(k, self.size, self.size) > 0.5).astype(np.float32)}


def build(args):
    """(SwinConfig, AVSHeadConfig) of the flags (JAX `build` :128)."""
    abl = dict(use_temporal_attn=args.use_temporal_attn, use_t_adapter=args.use_t_adapter,
               use_s_adapter=args.use_s_adapter, use_g_adapter=args.use_g_adapter)
    if args.tiny:
        cfg = swin_tiny_test(ftmode=args.ftmode, num_frames=args.num_frames, **abl)
        hcfg = AVSHeadConfig(stage_dims=(cfg.embed_dim, cfg.embed_dim * 2),
                             stage_resolutions=(14, 7), vis_dim=(64, 128), tpavi_stages=(0, 1),
                             audio_dim=cfg.num_features, num_frames=args.num_frames)
    else:
        mk = swin_base if args.model.endswith("Base") else swin_large
        cfg = mk(ftmode=args.ftmode, num_frames=args.num_frames, **abl,
                 **({"adapter_ratios": tuple(args.adapter_ratios)} if args.adapter_ratios else {}))
        hcfg = AVSHeadConfig(stage_dims=tuple(cfg.stage_dim(i) for i in range(4)),
                             tpavi_stages=tuple(args.tpavi_stages), audio_dim=cfg.num_features,
                             num_frames=args.num_frames)
    return cfg, hcfg


def make_loss_fn(cfg, hcfg, pipe, args, dtype=COMPUTE_DTYPE):
    """loss_fn(model, batch, generator) -> (loss, aux) of the JAX CLI's
    `loss_fn` (:243): the pipeline, `apply_avs(train=True,
    return_state=True)` on (a, v) in `dtype`, `iou_semantic_aware_loss`
    against each clip's first-frame mask, and in aux["state_updates"] the
    TPAVI BatchNorms' new running statistics by buffer name."""
    def loss_fn(m, batch, generator):
        a, v = pipe({"frames": batch["frames"], "wave": batch["wave"]})
        pred, fmaps, afeas, bn_state = avs.apply_avs(m, cfg, hcfg, a.to(dtype), v.to(dtype),
                                                     train=True, return_state=True)
        gt = torch.as_tensor(np.asarray(batch["masks"])[:, 0]).to(pred.device)[..., None]
        total, aux = losses.iou_semantic_aware_loss(
            pred, gt, afeas, fmaps, args.lambda_1,
            count_stages=tuple(args.tpavi_stages) if args.sa_loss else (),
            sa_loss_flag=args.sa_loss, frames_per_clip=args.num_frames)
        aux = dict(aux)
        aux["state_updates"] = {f"avstask.{k}.W_z.bn.running_{s}": st[s].detach()
                                for k, st in bn_state.items() for s in ("mean", "var")}
        return total, aux
    return loss_fn


def make_eval_fn(infer, pipe, args):
    """eval_fn(model, loader) -> {"miou"}: the test split's every-frame masks,
    or the first frame's where a batch carries one mask a clip (:262-283),
    masks dumped as PNGs with --save_mask_dir."""
    def eval_fn(model, loader):
        ious = []
        for batch in loader:
            pred = infer(model, pipe({"frames": batch["frames"], "wave": batch["wave"]}))
            pred = pred[..., 0].float()                      # (B*T, H, W)
            masks = torch.as_tensor(np.asarray(batch["masks"])).to(pred.device)
            B = masks.shape[0]
            if masks.shape[1] == args.num_frames:            # test: every frame's mask
                ious.append(float(losses.mask_iou(pred, masks.reshape(-1, *masks.shape[2:]))))
            else:
                first = pred.reshape(B, args.num_frames, *pred.shape[1:])[:, 0]
                ious.append(float(losses.mask_iou(first, masks[:, 0])))
            if args.save_mask_dir:
                _dump_masks(pred.cpu().numpy(), args.save_mask_dir, len(ious))
        return {"miou": float(np.mean(ious)) if ious else float("nan")}
    return eval_fn


@deterministic_algorithms()
def main(argv=None):
    args = parse_args(argv)
    # multi-host bring-up (a no-op unless STGCMA_COORDINATOR / _DISTRIBUTED is set)
    init_distributed()
    device = resolve_device(args.device)
    if args.ftmode != "fusion":
        # the reference AVS model's other branches are AVE-style
        # classification heads the AVS loss cannot consume
        raise SystemExit(f"--ftmode {args.ftmode} is not a runnable AVS mode: the reference "
                         "branch returns an AVE-style classification head output the AVS loss "
                         "cannot consume; use --ftmode fusion")
    seed_everything(0)
    archive_args(args, args.exp_dir)
    cfg, hcfg = build(args)
    model = avs.init_avs(cfg, hcfg, generator=torch.Generator().manual_seed(0), device=device)
    model = maybe_load_pretrained(model, args.pretrain_path, "swin", cfg, device)

    for flag in ("freqm", "timem", "noise", "label_smooth", "mixup", "finetune_path"):
        if getattr(args, flag):
            print(f"warning: --{flag} is accepted for reference-surface compatibility but has "
                  "no effect (the reference AVS driver parses it and never consumes it)")
    if args.loss != "IoU":
        print(f"warning: --loss {args.loss} selected, but the reference AVS train loop "
              "hardcodes IouSemanticAwareLoss (traintest_adapt_avs.py:162) — training with IoU")
    if args.dir_audio_log_mel:
        print("note: --dir_audio_log_mel set; the VGGish pkls are returned with every batch "
              "(reference S4Dataset parity); the Swin trainer computes log-mel from the wav "
              "on the device and does not read them")

    img = cfg.img_size
    fb = dataclasses.replace(SWIN_FBANK, num_mel_bins=img) if args.tiny else SWIN_FBANK
    target_len = img if args.tiny else 224
    if args.target_length is not None and args.target_length != target_len:
        print(f"warning: --target_length {args.target_length} conflicts with the tower's audio "
              f"geometry ({target_len} frames for this preset); keeping the preset")

    if args.synthetic:
        tr_ds = SyntheticAVS(4, args.num_frames, img, split="train")
        te_ds = SyntheticAVS(2, args.num_frames, img, seed=99, split="test")
    else:
        dirs = dict(dir_image=args.dir_image, dir_mask=args.dir_mask,
                    dir_audio_wav=args.dir_audio_wav, dir_audio_log_mel=args.dir_audio_log_mel,
                    load_audio_log_mel=bool(args.dir_audio_log_mel))
        tr_ds = AVSDataset(args.meta_csv, args.data_root, "train", args.num_frames, **dirs)
        te_ds = AVSDataset(args.meta_csv, args.data_root, "test", args.num_frames, **dirs)

    weights = None
    if args.bal == "bal":
        print("balanced sampler is being used")
        if not args.weight_csv:
            raise SystemExit("--bal bal requires --weight_csv (per-sample weights, one float "
                             "per line)")
        weights = np.loadtxt(args.weight_csv, delimiter=",")
    else:
        print("balanced sampler is not used")
    tr = DataLoader(tr_ds, args.batch_size, shuffle=True, num_workers=args.num_workers,
                    sample_weights=weights)
    te = DataLoader(te_ds, args.batch_size, shuffle=False, drop_last=False,
                    num_workers=args.num_workers)

    # AVS protocol: ToTensor + ImageNet Normalize only, train and eval alike
    # (AVS/dataloader.py:65-72)
    pipe = make_avs_device_pipeline(fb, target_len, args.dataset_mean, args.dataset_std,
                                    device=device)
    dt = COMPUTE_DTYPE
    infer = make_eval_step(lambda m, av: avs.apply_avs(m, cfg, hcfg, av[0].to(dt),
                                                       av[1].to(dt))[0], dt)
    eval_fn = make_eval_fn(infer, pipe, args)

    if args.eval_only:
        # standalone evaluation (AVS/test.py): the checkpoint, MIoU, PNG masks
        if args.ckpt:
            model.load_state_dict(load_checkpoint(args.ckpt, device))
        metrics = eval_fn(model, te)
        print("eval:", metrics)
        return metrics

    lr_mode = "plateau" if args.lr_adapt else "cosine" if args.lr_cosine_adapt else "multistep"
    if args.wa and not args.save_model:
        raise SystemExit("--wa True requires --save_model True (weight averaging reads the "
                         "per-epoch checkpoints)")
    trainer = Trainer(
        loss_fn=make_loss_fn(cfg, hcfg, pipe, args, dt), eval_fn=eval_fn, model=model,
        base_lr=args.lr, head_lr_mult=args.head_lr, n_epochs=args.n_epochs,
        steps_per_epoch=max(len(tr), 1), warmup_epochs=args.warmup_epochs if args.warmup else 0,
        min_lr=args.min_lr, exp_dir=args.exp_dir, freeze_base=args.freeze_base,
        compute_dtype=dt, save_every_epoch=args.save_model, metric_name="miou",
        lr_mode=lr_mode, plateau_patience=args.lr_patience,
        multistep=(args.lrscheduler_start, args.lrscheduler_step, args.lrscheduler_decay))
    trainer.fit(tr, te, seed=0, resume=args.resume)
    print("done. best epoch", trainer.best_epoch, "best miou", trainer.best_metric)

    if args.wa:
        # weight averaging over the per-epoch checkpoints (AVS/run_adapt_avs.py:243-252)
        trees = [load_checkpoint(os.path.join(args.exp_dir, "models", f"model.{e}"))
                 for e in range(args.wa_start, min(args.wa_end, args.n_epochs) + 1)]
        final = copy.deepcopy(trainer.model)
        final.load_state_dict(weight_average(trees))
        print("weight-averaged eval:", eval_fn(final, te))
    return trainer


def _dump_masks(pred_logits, out_dir, batch_idx):
    """P-mode PNG masks, as AVS/test.py:41-103 saves them."""
    from PIL import Image
    os.makedirs(out_dir, exist_ok=True)
    m = (1 / (1 + np.exp(-pred_logits)) > 0.5).astype(np.uint8) * 255
    for i, frame in enumerate(m):
        Image.fromarray(frame).convert("P").save(
            os.path.join(out_dir, f"batch{batch_idx}_frame{i}.png"))


if __name__ == "__main__":
    main()
