"""The training loop: epochs of batches, per-step LR tables, validation,
per-epoch and best checkpoints, weight averaging, the NaN guard, result.csv
and progress.json, step-time meters, mid-training resume.

Port of `stgcma_tpu/train/loop.py` (`Trainer` :41, `weight_average` :259),
which mirrors the reference engine (AVE/traintest_adapt_ave29.py:14-257) and
adds the resume the reference lacks (SURVEY §5). Where JAX keeps the
trainable and frozen subtrees apart, the port keeps one model whose
trainable parameters (`requires_grad`) are the fp32 masters, and a step's
`aux["state_updates"]` (TPAVI's BatchNorm statistics) are copied into its
buffers after the step (`steps.apply_state_updates`); `save_state` keeps
them beside the masters, which JAX's `save_state` does not (its resumed run
restarts them from the initial tree). Epoch e draws
its randomness (the train pipeline's augmentation, the head's dropout) from
`torch.Generator().manual_seed(seed + e)`, in place of JAX's
`fold_in(rng, e)`, and a loader with `set_epoch` is told the epoch, so a
resumed run draws what the straight run drew.

With a `mesh` (`runtime/mesh.py`, :95-100 and :149-151 of JAX's) the
frozen tower goes through `shard_params`, the masters, the Adam state and
the buffers are replicated from the mesh's first rank, each step takes this
rank's rows of the global batch (`shard_batch`) and averages the masters'
gradients over 'data' before Adam (`steps.make_train_step`), so the masters
stay bit-identical on every rank. Every rank iterates the same loader;
checkpoints gather the split leaves on every rank, and rank 0 writes them.
"""
from __future__ import annotations

import csv
import json
import os
import pickle
import time
from typing import Callable, Dict, Iterable, List, Mapping

import numpy as np
import torch
from torch import nn

from ..checkpoint.io import load_checkpoint, save_checkpoint
from ..checkpoint.torch_convert import average_params
from ..metrics.stats import AverageMeter
from ..runtime import mesh as M
from . import optim as O
from . import steps as S


class Trainer:
    def __init__(self, *, loss_fn: Callable, eval_fn: Callable, model: nn.Module,
                 base_lr: float, head_lr_mult: float = 1.0, weight_decay: float = 5e-7,
                 n_epochs: int = 10, steps_per_epoch: int = 100, warmup_epochs: int = 0,
                 min_lr: float = 1e-7, exp_dir: str = "./exp", freeze_base: bool = True,
                 compute_dtype: torch.dtype = torch.bfloat16, metric_name: str = "acc",
                 save_every_epoch: bool = True, lr_mode: str = "cosine",
                 plateau_patience: int = 2, plateau_factor: float = 0.5,
                 multistep=(10, 5, 0.5), mesh=None):
        """loss_fn(model, batch, generator) -> (loss, aux); eval_fn(model,
        batches) -> {metric: value, "_stats": per-class stats (optional)}.
        lr_mode mirrors the reference scheduler selection
        (AVE/traintest_adapt_ave29.py:79-107): 'cosine' (lr_cosine_adapt,
        the launch-config default), 'plateau' (lr_adapt -> ReduceLROnPlateau
        mode=max factor=0.5), 'multistep' (the final fallback;
        multistep=(start, step, decay)). The head group gets its own table
        from lr * head_lr (the reference builds two cosine tables with the
        same min_lr floor, :84-101)."""
        self.exp_dir = exp_dir
        os.makedirs(os.path.join(exp_dir, "models"), exist_ok=True)
        if lr_mode == "cosine":
            lr_table = O.cosine_schedule(base_lr, min_lr, n_epochs, steps_per_epoch,
                                         warmup_epochs)
            head_table = O.cosine_schedule(base_lr * head_lr_mult, min_lr, n_epochs,
                                           steps_per_epoch, warmup_epochs)
        elif lr_mode == "multistep":
            lr_table, head_table = (O.multistep_schedule(lr, multistep[0], multistep[1],
                                                         multistep[2], n_epochs, steps_per_epoch)
                                    for lr in (base_lr, base_lr * head_lr_mult))
        elif lr_mode == "plateau":
            lr_table = np.full(n_epochs * steps_per_epoch, base_lr, np.float32)
            head_table = np.full(n_epochs * steps_per_epoch, base_lr * head_lr_mult, np.float32)
        else:
            raise ValueError(f"unknown lr_mode {lr_mode}")
        self.lr_mode = lr_mode
        self.plateau_patience = plateau_patience
        self.plateau_factor = plateau_factor
        self._plateau_bad = 0
        self._plateau_best = -np.inf
        self._plateau_scale = 1.0
        self.model = model
        S.init_train_state(model, freeze_base)
        self.opt = O.build_optimizer(model, base_lr, head_lr_mult, weight_decay,
                                     lr_table=lr_table, head_lr_table=head_table)
        self.mesh = mesh
        self._writes = mesh is None or torch.distributed.get_rank() == 0
        if mesh is not None:
            M.replicate(model, mesh)
            M.shard_params(model, mesh, [n for n, p in model.named_parameters()
                                         if not p.requires_grad])
        self.step_fn = S.make_train_step(loss_fn, self.opt, compute_dtype, mesh)
        self.eval_fn = eval_fn
        self.n_epochs = n_epochs
        self.metric_name = metric_name
        self.save_every_epoch = save_every_epoch
        self.history: List[Dict] = []
        self.best_metric = -np.inf
        self.best_epoch = 0
        self.global_step = 0
        self.step_losses: List[float] = []    # each train step's loss in this run, in order

    def params(self) -> Dict[str, torch.Tensor]:
        """Every parameter and buffer of the model (the JAX merged tree),
        split leaves gathered (a collective under a mesh)."""
        if self.mesh is not None:
            return M.gathered_state_dict(self.model)
        return self.model.state_dict()

    def trainable(self) -> Dict[str, torch.Tensor]:
        """The fp32 masters by name."""
        return dict(self.opt.named_parameters())

    def _maybe_plateau(self, metric: float):
        """ReduceLROnPlateau(mode='max', factor, patience): scale both groups'
        tables when `metric` fails to improve for more than `patience` epochs.
        The Adam moments and the update count survive."""
        if self.lr_mode != "plateau":
            return
        # torch is_better, mode='max', threshold_mode='rel', threshold=1e-4
        if metric > self._plateau_best * (1.0 + 1e-4):
            self._plateau_best = metric
            self._plateau_bad = 0
            return
        self._plateau_bad += 1
        if self._plateau_bad > self.plateau_patience:
            self._plateau_bad = 0
            self._scale_tables(self.plateau_factor)
            print(f"plateau: reducing lr to {self.opt.tables['adapt'][0]:.3e}")

    def _scale_tables(self, factor: float):
        self._plateau_scale *= factor
        for g in ("adapt", "head"):
            self.opt.tables[g] = self.opt.tables[g] * factor

    def train_epoch(self, epoch: int, batches: Iterable, generator: torch.Generator) -> float:
        loss_meter, time_meter = AverageMeter(), AverageMeter()
        for batch in batches:
            t0 = time.time()
            if isinstance(batch, dict):      # drop non-array fields (AVQA qtype strings)
                batch = {k: v for k, v in batch.items()
                         if isinstance(v, (np.ndarray, torch.Tensor))}
            if self.mesh is not None:
                batch = M.shard_batch(batch, self.mesh)
            loss, aux = self.step_fn(self.model, batch, generator)
            if isinstance(aux, dict) and aux.get("state_updates"):
                S.apply_state_updates(self.model, aux["state_updates"])
            self.step_losses.append(float(loss))
            loss_meter.update(self.step_losses[-1])
            time_meter.update(time.time() - t0)
            self.global_step += 1
            if np.isnan(loss_meter.avg):      # AVE/traintest_adapt_ave29.py:187-189
                print("training diverged — NaN loss; stopping epoch")
                return float("nan")
        print(f"epoch {epoch}: loss {loss_meter.avg:.4f} ({time_meter.avg * 1000:.0f} ms/step)")
        return loss_meter.avg

    def validate(self, batches: Iterable) -> Dict[str, float]:
        return self.eval_fn(self.model, batches)

    # ---- mid-training resume (absent in the reference — SURVEY §5) ----

    def _state_dir(self):
        return os.path.join(self.exp_dir, "state")

    def buffers(self) -> Dict[str, torch.Tensor]:
        """The floating buffers a step updates (the BatchNorms' running
        statistics), by name."""
        return {n: b for n, b in self.model.named_buffers() if S.bn_stat(n)}

    def save_state(self, epoch: int):
        if not self._writes:
            return
        save_checkpoint(os.path.join(self._state_dir(), "train_params"), self.trainable())
        save_checkpoint(os.path.join(self._state_dir(), "opt_state"), self.opt.state_dict())
        save_checkpoint(os.path.join(self._state_dir(), "buffers"), self.buffers())
        with open(os.path.join(self.exp_dir, "state_meta.json"), "w") as f:
            json.dump({"epoch": epoch, "history": self.history,
                       "best_metric": float(self.best_metric), "best_epoch": self.best_epoch,
                       "global_step": self.global_step,
                       "plateau": [self._plateau_bad, float(self._plateau_best),
                                   self._plateau_scale]}, f)

    def try_restore(self) -> int:
        """The epoch to start from (1 if no state was saved); restores the
        masters, the Adam moments and count, the BatchNorms' running
        statistics, the step count, the history and the plateau state (its
        count of bad epochs, best metric and the LR scale reached)."""
        meta_path = os.path.join(self.exp_dir, "state_meta.json")
        if not os.path.exists(meta_path):
            return 1
        masters = load_checkpoint(os.path.join(self._state_dir(), "train_params"))
        with torch.no_grad():
            for n, p in self.opt.named_parameters():
                p.copy_(masters[n])
        S.apply_state_updates(self.model,
                              load_checkpoint(os.path.join(self._state_dir(), "buffers")))
        self.opt.load_state_dict(load_checkpoint(os.path.join(self._state_dir(), "opt_state")))
        with open(meta_path) as f:
            meta = json.load(f)
        self.history = meta["history"]
        self.best_metric = meta["best_metric"]
        self.best_epoch = meta["best_epoch"]
        self.global_step = meta.get("global_step", 0)
        if self.lr_mode == "plateau":
            self._plateau_bad, self._plateau_best, scale = meta["plateau"]
            self._scale_tables(scale)
        print(f"resumed from epoch {meta['epoch']}")
        return meta["epoch"] + 1

    def fit(self, train_loader, val_loader, seed: int = 0, resume: bool = False):
        start = self.try_restore() if resume else 1
        for epoch in range(start, self.n_epochs + 1):
            if hasattr(train_loader, "set_epoch"):
                train_loader.set_epoch(epoch - 1)
            loss = self.train_epoch(epoch, train_loader,
                                    torch.Generator().manual_seed(seed + epoch))
            if np.isnan(loss):
                break
            metrics = self.validate(val_loader) if val_loader is not None else {}
            stats = metrics.pop("_stats", None)
            if stats is not None and self._writes:      # AVE/traintest_adapt_ave29.py:243-244
                with open(os.path.join(self.exp_dir, f"stats_{epoch}.pickle"), "wb") as f:
                    pickle.dump(stats, f, protocol=pickle.HIGHEST_PROTOCOL)
            metric = metrics.get(self.metric_name, -loss)
            self._maybe_plateau(metric)
            self.history.append({"epoch": epoch, "loss": loss, **metrics})
            self._write_results()
            if self.save_every_epoch:
                self._save(os.path.join(self.exp_dir, "models", f"model.{epoch}"))
            if metric > self.best_metric:
                self.best_metric, self.best_epoch = metric, epoch
                self._save(os.path.join(self.exp_dir, "models", "best_model"))
            self.save_state(epoch)
        return self.history

    def _save(self, path: str):
        params = self.params()          # every rank: gathering is a collective
        if self._writes:
            save_checkpoint(path, params)

    def _write_results(self):
        if not self._writes:
            return
        # fixed column order (union of keys, epoch/loss first) + header row
        cols = ["epoch", "loss"]
        for row in self.history:
            for k in row:
                if k not in cols:
                    cols.append(k)
        with open(os.path.join(self.exp_dir, "result.csv"), "w", newline="") as f:
            w = csv.writer(f)
            w.writerow(cols)
            for row in self.history:
                w.writerow([row.get(k, "") for k in cols])
        with open(os.path.join(self.exp_dir, "progress.json"), "w") as f:
            json.dump({"history": self.history, "best_epoch": self.best_epoch,
                       "best_metric": float(self.best_metric)}, f)


def weight_average(state_dicts: List[Mapping[str, torch.Tensor]]) -> Dict[str, torch.Tensor]:
    """Post-train epoch-checkpoint averaging (AVE/run_adapt_ave29.py:203-214)."""
    return average_params(state_dicts)
