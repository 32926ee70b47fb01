"""Adam training steps of the reference, in float32.

torch's Adam as the configurations state it: the L2 term folded into the
gradient (g + wd * theta), betas (0.95, 0.999), eps 1e-8, bias-corrected
moments, a learning rate per leaf. A step's loss is the sum of the chunks
that `loss_chunks` yields (each a part of the batch's loss over a block of
its clips), so the gradient of a whole batch is formed block by block and
fits the device.
"""
from __future__ import annotations

from typing import Callable, Dict, Iterable, List, Optional, Sequence

import torch


def warmup_scale(train: dict, steps: int) -> List[float]:
    """Each of the first `steps` updates' share of its group's learning
    rate: under a configuration's `schedule`, the linear warm-up from 0 to
    the full rate over warmup_epochs x steps_per_epoch updates (the
    reference's utilities/scheduler.py, both groups alike); without one, 1."""
    s = train.get("schedule")
    if s is None:
        return [1.0] * steps
    n = s["warmup_epochs"] * s["steps_per_epoch"]
    if steps >= n:
        raise ValueError(f"{steps} checked steps reach past the {n}-step warm-up")
    return [k / (n - 1) for k in range(steps)]


def adam_steps(W0: Dict[str, torch.Tensor], lrs: Dict[str, float],
               loss_chunks: Callable[[Dict[str, torch.Tensor], int], Iterable[torch.Tensor]],
               steps: int, wd: float, betas=(0.95, 0.999), eps: float = 1e-8,
               scale: Optional[Sequence[float]] = None) -> dict:
    """Run `steps` updates of the leaves named in `lrs`, starting from W0
    (left unchanged); update t takes lrs[leaf] x scale[t] (scale 1 where
    not given). loss_chunks(W, step) yields the loss's parts of that
    step. Returns {"loss": [each step's loss], "grad": {leaf: its first
    gradient as the optimizer takes it}, "delta": {leaf: its change over the
    steps}, "raw_grad": {leaf: the loss's own first gradient}}."""
    params = {n: W0[n].detach().clone().requires_grad_(True) for n in lrs}
    m = {n: torch.zeros_like(p) for n, p in params.items()}
    v = {n: torch.zeros_like(p) for n, p in params.items()}
    out: dict = {"loss": []}
    for t in range(1, steps + 1):
        W = dict(W0)
        W.update(params)
        total = 0.0
        for part in loss_chunks(W, t - 1):
            part.backward()
            total += float(part.detach())
        out["loss"].append(total)
        with torch.no_grad():
            for n, p in params.items():
                g = p.grad + wd * p
                if t == 1:
                    out.setdefault("grad", {})[n] = g.clone()
                    out.setdefault("raw_grad", {})[n] = p.grad.clone()
                m[n].mul_(betas[0]).add_(g, alpha=1 - betas[0])
                v[n].mul_(betas[1]).addcmul_(g, g, value=1 - betas[1])
                denom = (v[n] / (1 - betas[1] ** t)).sqrt_().add_(eps)
                lr = lrs[n] * (1.0 if scale is None else scale[t - 1])
                p.addcdiv_(m[n], denom, value=-lr / (1 - betas[0] ** t))
                p.grad = None
    out["delta"] = {n: (params[n].detach() - W0[n]) for n in params}
    return out


def leaf_gaps(prog: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor],
              leaves: List[str]) -> Dict[str, float]:
    """{leaf: |norm(prog) - norm(ref)| over the larger of that leaf's
    reference norm and the median leaf's}; a leaf the program lacks has
    norm 0."""
    refn = {n: float(torch.linalg.vector_norm(ref[n].float())) for n in leaves}
    med = sorted(refn.values())[len(refn) // 2]
    return {n: abs((float(torch.linalg.vector_norm(prog[n].float())) if n in prog else 0.0)
                   - refn[n]) / max(refn[n], med, 1e-30) for n in leaves}
