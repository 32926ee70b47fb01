"""MUSIC-AVQA experiment entry point (the reference's: AVQA/run_adapt_avqa.py,
whose runnable branch is MM-Swin-AVQA-Large).

Port of `stgcma_tpu/cli/run_adapt_avqa.py`: the same flag surface plus
`--device` (default "cuda"; "cpu" runs the kernels' plain versions), and the
same flow: Swin-Large `fusion` at T = 10 with the AVQA head
(`models/avqa.py`), trained on CE(out_qa) + 0.5 CE(match) over the positive
and negative streams (`train/losses.py::avqa_loss`,
AVQA/traintest_adapt_avqa.py:172-179) with the QA head's attention dropout
drawn from the epoch's generator; evaluated by overall and per-type accuracy
(:289-373); `--eval_only` with `--ckpt`, `--wa` averaging, `--resume`,
`--bal` with its sample weights, `--pretrain_path` (an ImageNet Swin
checkpoint, with the grounding head of `--grounding_pretrained` spliced in
under avqatask_* names) or `--grounding_pretrained` alone (the export of
`tools/grounding_gen.py`, its matching-shaped head linears copied).
`make_avqa_device_pipeline` serves training and evaluation alike (a direct
bicubic resize and ImageNet normalization), the negative frames through
their own call. `--tiny` means `swin_tiny_test`, as in JAX.

Compute is bf16 with fp32 masters (`train.steps`), the pipeline's fp32 (a,
v, v_nega) cast to bf16 before the model, as `run_adapt_avs` does.
Evaluation runs `answer_avqa` in bf16: the two-stream tower and the head
without the match MLP, the out_qa of JAX's `apply_avqa(...)[0]`, whose
lowering drops the nega stream. A json 'type' kept as its string literal
(the reference jsons' "['Audio', 'Counting']") is read with
`ast.literal_eval` for the per-type breakdown. With STGCMA_DETERMINISTIC=1
in the environment the run takes torch's deterministic algorithms
(`common.deterministic_algorithms`). As the JAX CLI, it first calls
`runtime.mesh.init_distributed()` (the multi-host bring-up, a no-op
without the STGCMA_* variables).

Usage (synthetic smoke on the CPU):
    python -m stgcma_tpu_torch.cli.run_adapt_avqa --synthetic True --tiny True \\
        --device cpu --n-epochs 2 --batch_size 2 --num_frames 2 --exp-dir /tmp/exp
"""
from __future__ import annotations

import argparse
import ast
import copy
import dataclasses
import os

import numpy as np
import torch

from ..checkpoint.io import load_checkpoint
from ..configs import AVQAHeadConfig, swin_large, swin_tiny_test
from ..data.datasets import AVQADataset
from ..data.loader import DataLoader, make_avqa_device_pipeline
from ..metrics.stats import avqa_type_accuracy
from ..models import avqa
from ..ops.common import resolve_device
from ..runtime.mesh import init_distributed
from ..ops.fbank import SWIN_FBANK
from ..train import losses
from ..train.loop import Trainer, weight_average
from ..train.steps import make_eval_step
from .common import archive_args, deterministic_algorithms, seed_everything, str2bool

COMPUTE_DTYPE = torch.bfloat16


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--model", default="MM-Swin-AVQA-Large")
    p.add_argument("--ftmode", default="fusion",
                   choices=["videoonly", "audioonly", "multimodal", "fusion"])
    p.add_argument("--dataset", default="music-avqa")
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--head_lr", type=float, default=0.1)
    p.add_argument("--min_lr", type=float, default=1e-7)
    p.add_argument("--warmup_epochs", type=int, default=1)
    p.add_argument("--warmup", type=str2bool, default=True)
    p.add_argument("--n-epochs", "--n_epochs", dest="n_epochs", type=int, default=15)
    p.add_argument("--batch_size", "--batch-size", dest="batch_size", type=int, default=2)
    p.add_argument("--num_frames", type=int, default=10)
    p.add_argument("--adapter_ratios", type=float, nargs="*", default=None)
    p.add_argument("--exp-dir", "--exp_dir", dest="exp_dir", default="./exp/avqa")
    p.add_argument("--pretrain_path", default="")
    p.add_argument("--grounding_pretrained", default="")
    p.add_argument("--freeze_base", type=str2bool, default=True)
    p.add_argument("--loss", default="CE", choices=["CE", "BCE"])
    p.add_argument("--metrics", default="acc", choices=["acc", "mAP"])
    # weight averaging over the per-epoch checkpoints (AVQA/run_adapt_avqa.py:395-414)
    p.add_argument("--wa", type=str2bool, default=False)
    p.add_argument("--wa_start", type=int, default=1)
    p.add_argument("--wa_end", type=int, default=5)
    # scheduler selection (AVQA/traintest_adapt_avqa.py, as AVE's)
    p.add_argument("--lr_adapt", type=str2bool, default=False)
    p.add_argument("--lr_patience", type=int, default=2)
    p.add_argument("--lr_cosine_adapt", type=str2bool, default=True)
    p.add_argument("--lrscheduler_start", type=int, default=10)
    p.add_argument("--lrscheduler_step", type=int, default=5)
    p.add_argument("--lrscheduler_decay", type=float, default=0.5)
    # balanced sampler (AVQA/run_adapt_avqa.py:128-137)
    p.add_argument("--bal", default="none")
    p.add_argument("--weight_file", default=None)
    p.add_argument("--weight_csv", default="")
    p.add_argument("--save_model", type=str2bool, default=True)
    # the reference's data flags: --data_train / --data_val are the question
    # jsons, --dir_image / --dir_audio_wav the media roots (:139-158)
    p.add_argument("--train_json", "--data_train", dest="train_json", default="")
    p.add_argument("--val_json", "--data_val", dest="val_json", default="")
    p.add_argument("--frames_root", "--dir_image", dest="frames_root", default="")
    p.add_argument("--audio_root", "--dir_audio_wav", dest="audio_root", default="")
    p.add_argument("--num_workers", "--num-workers", dest="num_workers", type=int, default=8)
    p.add_argument("--dataset_mean", type=float, default=-5.269)
    p.add_argument("--dataset_std", type=float, default=4.578)
    p.add_argument("--target_length", type=int, default=None)
    # parsed and never read by the reference AVQA driver (its audio_conf
    # blocks are commented out, :111-128; finetune_path has no reader)
    p.add_argument("--freqm", type=int, default=0)
    p.add_argument("--timem", type=int, default=0)
    p.add_argument("--noise", type=str2bool, default=False)
    p.add_argument("--label_smooth", type=float, default=0.0)
    p.add_argument("--mixup", type=float, default=0.0)
    p.add_argument("--finetune_path", default="")
    p.add_argument("--eval_only", type=str2bool, default=False)
    p.add_argument("--ckpt", default="")
    p.add_argument("--synthetic", type=str2bool, default=False)
    p.add_argument("--tiny", type=str2bool, default=False)
    # mid-training resume (beyond the reference): the masters, Adam's state
    # and the LR position from exp_dir/state
    p.add_argument("--resume", type=str2bool, default=False)
    # the port's one flag of its own: where the model runs ("cuda", or "cpu"
    # for the kernels' plain versions)
    p.add_argument("--device", default="cuda")
    return p.parse_args(argv)


class SyntheticAVQA:
    """Seeded random AVQA items: uint8 frames and negative frames (T, size,
    size, 3), wave (T, 31200) ~ N(0, 0.1), a 14-word question of the 93-word
    vocabulary, one of the 42 answers, one question type."""

    def __init__(self, n=4, num_frames=10, size=224, seed=0):
        self.n, self.T, self.size, self.seed = n, num_frames, size, seed

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        rng = np.random.RandomState(self.seed + i)
        return {"frames": rng.randint(0, 256, (self.T, self.size, self.size, 3), np.uint8),
                "frames_nega": rng.randint(0, 256, (self.T, self.size, self.size, 3), np.uint8),
                "wave": (rng.randn(self.T, 31200) * 0.1).astype(np.float32),
                "question": rng.randint(0, 93, (14,)).astype(np.int32),
                "answer": np.int32(rng.randint(0, 42)),
                "qtype": ["Audio", "Counting"]}


def build(args):
    """(SwinConfig, AVQAHeadConfig) of the flags (JAX :152-160)."""
    if args.tiny:
        cfg = swin_tiny_test(ftmode=args.ftmode, num_frames=args.num_frames)
    else:
        cfg = swin_large(ftmode=args.ftmode, num_frames=args.num_frames,
                         **({"adapter_ratios": tuple(args.adapter_ratios)}
                            if args.adapter_ratios else {}))
    return cfg, AVQAHeadConfig(feat_dim=cfg.num_features, grid=7, num_frames=args.num_frames)


def _question(batch, device):
    return torch.as_tensor(np.asarray(batch["question"]), dtype=torch.long).to(device)


def make_loss_fn(cfg, hcfg, pipe, args, dtype=COMPUTE_DTYPE):
    """loss_fn(model, batch, generator) -> (loss, aux) of the JAX CLI's
    `loss_fn` (:239-249): the pipeline on (frames, wave) and on (frames_nega,
    wave), `apply_avqa(train=True)` on (a, v, v_nega) in `dtype` with the QA
    head's dropout drawn from `generator`, `avqa_loss` against the answers."""
    def loss_fn(m, batch, generator):
        a, v = pipe({"frames": batch["frames"], "wave": batch["wave"]})
        _, vn = pipe({"frames": batch["frames_nega"], "wave": batch["wave"]})
        out_qa, m_pos, m_neg = avqa.apply_avqa(m, cfg, hcfg, a.to(dtype), v.to(dtype),
                                               vn.to(dtype), _question(batch, a.device),
                                               train=True, generator=generator)
        answer = torch.as_tensor(np.asarray(batch["answer"])).to(a.device)
        return losses.avqa_loss(out_qa, m_pos, m_neg, answer, kind=args.loss)
    return loss_fn


def _qtype(t):
    return ast.literal_eval(t) if isinstance(t, str) else t


def make_eval_fn(infer, pipe):
    """eval_fn(model, loader) -> {"acc": the overall accuracy, and each
    question type's and modality's}: out_qa's argmax against the answers
    (:289-373)."""
    def eval_fn(model, loader):
        preds, answers, types = [], [], []
        for batch in loader:
            a, v = pipe({"frames": batch["frames"], "wave": batch["wave"]})
            out_qa = infer(model, (a, v, _question(batch, a.device)))
            preds.extend(out_qa.float().argmax(dim=-1).cpu().tolist())
            answers.extend(np.asarray(batch["answer"]).tolist())
            types.extend(_qtype(t) for t in batch["qtype"])
        rep = avqa_type_accuracy(preds, answers, types)
        return {"acc": rep["Overall"], **rep}
    return eval_fn


def load_weights(model, cfg, args, device):
    """--pretrain_path (with --grounding_pretrained spliced in under
    avqatask_* names, Swin_AVQAModel_V1.py:1520-1540) through
    `load_pretrained_swin2d`; or --grounding_pretrained alone, its head
    linears copied where the AVQA head holds them at the same shape (JAX
    :159-196)."""
    if args.pretrain_path:
        from ..checkpoint import torch_convert as TC
        ckpt = torch.load(args.pretrain_path, map_location="cpu", weights_only=False)
        sd = dict(ckpt.get("model", ckpt) if isinstance(ckpt, dict) else ckpt)
        if args.grounding_pretrained:
            from ..tools.grounding_gen import HEAD_KEYS
            g = torch.load(args.grounding_pretrained, map_location="cpu", weights_only=False)
            for k, v in g.items():
                name = k.replace("module.", "")
                if name.split(".")[0] in HEAD_KEYS:
                    sd["avqatask_" + name] = v
        model, unexpected = TC.load_pretrained_swin2d(model, sd, cfg, device=device)
        print(f"loaded {args.pretrain_path}; unexpected: {len(unexpected)}")
    elif args.grounding_pretrained:
        g = torch.load(args.grounding_pretrained, map_location="cpu", weights_only=False)
        held = dict(model.avqatask.named_parameters())
        spliced = []
        with torch.no_grad():
            for k, v in g.items():
                name = k.replace("module.", "")
                root, leaf = name.split(".")[0], name.split(".")[-1]
                target = held.get(f"{root}.{'weight' if leaf == 'weight' else 'bias'}")
                if target is not None and tuple(target.shape) == tuple(v.shape):
                    target.copy_(v.to(target.device, target.dtype))
                    spliced.append(name)
        print(f"grounding splice: {len(spliced)} tensors "
              f"({sorted(set(n.split('.')[0] for n in spliced))})")
    return model


@deterministic_algorithms()
def main(argv=None):
    args = parse_args(argv)
    # multi-host bring-up (a no-op unless STGCMA_COORDINATOR / _DISTRIBUTED is set)
    init_distributed()
    device = resolve_device(args.device)
    if args.ftmode != "fusion":
        # the reference AVQA model's other branches are AVE-style
        # classification heads the AVQA loss cannot consume
        raise SystemExit(f"--ftmode {args.ftmode} is not a runnable AVQA mode: the reference "
                         "branch returns an AVE-style classification head output the AVQA loss "
                         "cannot consume; use --ftmode fusion")
    seed_everything(0)
    archive_args(args, args.exp_dir)

    for flag in ("freqm", "timem", "noise", "label_smooth", "mixup", "finetune_path"):
        if getattr(args, flag):
            print(f"warning: --{flag} is accepted for reference-surface compatibility but has "
                  "no effect (the reference AVQA driver parses it and never consumes it — the "
                  "audio_conf blocks are commented out)")
    if args.metrics == "mAP":
        print("warning: --metrics mAP has no AVQA semantics (single-label answers); accuracy "
              "is reported")

    cfg, hcfg = build(args)
    model = avqa.init_avqa(cfg, hcfg, generator=torch.Generator().manual_seed(0), device=device)
    model = load_weights(model, cfg, args, device)

    img = cfg.img_size
    fb = dataclasses.replace(SWIN_FBANK, num_mel_bins=img) if args.tiny else SWIN_FBANK
    target_len = img if args.tiny else 224
    if args.target_length is not None and args.target_length != target_len:
        print(f"warning: --target_length {args.target_length} conflicts with the tower's audio "
              f"geometry ({target_len} frames for this preset); keeping the preset (the "
              "reference AVQA driver's target_length is inert — commented-out audio_conf)")

    if args.synthetic:
        tr_ds = SyntheticAVQA(4, args.num_frames, img)
        te_ds = SyntheticAVQA(2, args.num_frames, img, seed=77)
    else:
        tr_ds = AVQADataset(args.train_json, args.train_json, args.frames_root, args.audio_root,
                            args.num_frames, "train")
        te_ds = AVQADataset(args.val_json, args.train_json, args.frames_root, args.audio_root,
                            args.num_frames, "eval")
    weights = None
    if args.bal == "bal":
        print("balanced sampler is being used")
        wpath = args.weight_csv or (args.train_json[:-5] + "_weight.csv"
                                    if args.train_json else "")
        if not wpath or not os.path.exists(wpath):
            raise SystemExit("--bal bal needs --weight_csv or a <data_train>_weight.csv next to "
                             "the train json (run_adapt_avqa.py:128-137)")
        weights = np.loadtxt(wpath, delimiter=",")
    else:
        print("balanced sampler is not used")
    tr = DataLoader(tr_ds, args.batch_size, shuffle=True, num_workers=args.num_workers,
                    sample_weights=weights)
    te = DataLoader(te_ds, args.batch_size, shuffle=False, drop_last=False,
                    num_workers=args.num_workers)

    # AVQA protocol: the same preprocess for training and evaluation, a direct
    # 224^2 bicubic resize and ImageNet normalization (AVQA/dataloader.py:86-90)
    pipe = make_avqa_device_pipeline(fb, target_len, args.dataset_mean, args.dataset_std,
                                     image_size=img, device=device)
    dt = COMPUTE_DTYPE
    infer = make_eval_step(lambda m, x: avqa.answer_avqa(m, cfg, hcfg, x[0].to(dt), x[1].to(dt),
                                                         x[2]), dt)
    eval_fn = make_eval_fn(infer, pipe)

    if args.eval_only:
        # standalone per-question-type evaluation (AVQA/test.py)
        if args.ckpt:
            model.load_state_dict(load_checkpoint(args.ckpt, device))
        rep = eval_fn(model, te)
        for k, v in rep.items():
            print(f"{k}: {v}")
        return rep

    lr_mode = "plateau" if args.lr_adapt else "cosine" if args.lr_cosine_adapt else "multistep"
    if args.wa and not args.save_model:
        raise SystemExit("--wa True requires --save_model True (weight averaging reads the "
                         "per-epoch checkpoints)")
    trainer = Trainer(
        loss_fn=make_loss_fn(cfg, hcfg, pipe, args, dt), eval_fn=eval_fn, model=model,
        base_lr=args.lr, head_lr_mult=args.head_lr, n_epochs=args.n_epochs,
        steps_per_epoch=max(len(tr), 1), warmup_epochs=args.warmup_epochs if args.warmup else 0,
        min_lr=args.min_lr, exp_dir=args.exp_dir, freeze_base=args.freeze_base,
        compute_dtype=dt, save_every_epoch=args.save_model, metric_name="acc",
        lr_mode=lr_mode, plateau_patience=args.lr_patience,
        multistep=(args.lrscheduler_start, args.lrscheduler_step, args.lrscheduler_decay))
    trainer.fit(tr, te, seed=0, resume=args.resume)
    print("done. best epoch", trainer.best_epoch, "best acc", trainer.best_metric)

    if args.wa:
        # weight averaging over the per-epoch checkpoints (AVQA/run_adapt_avqa.py:395-414)
        trees = [load_checkpoint(os.path.join(args.exp_dir, "models", f"model.{e}"))
                 for e in range(args.wa_start, min(args.wa_end, args.n_epochs) + 1)]
        final = copy.deepcopy(trainer.model)
        final.load_state_dict(weight_average(trees))
        rep = eval_fn(final, te)
        print("weight-averaged eval:", {"acc": rep["acc"]})
    return trainer


if __name__ == "__main__":
    main()
