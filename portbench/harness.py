"""One run of one cell: set-up, the measured window, the traced requests or
steps, and the comparison with the plain reference that decides `correct`.

Serving (a mix of mode "serve"): one client, closed loop. Each request is
`MultiTaskServer.predict` on the next batch of the pool (pinned host
memory in, float32 logits out). Set-up ends after each batch of the pool
has been served once. After the window, a sample of the window's requests
drawn from the seed is compared with the reference on the same inputs,
and the served copy's tensors are held to the run's dtype.

Training (mode "train"): the configuration's step (its loss under
`train/steps.py::make_train_step`, Adam over the adapters and the head at
the rates of the CLI's schedule where the configuration gives one),
driven from the seed through its first `checked_steps` steps in set-up on
batches whose rows all differ, then through the window. After the window
the reference takes the same steps from the same weights, batches and
draws, and each step's loss, the first gradient as Adam holds it and the
change of each leaf over the checked steps are compared.
"""
from __future__ import annotations

import itertools
import math
import statistics
import time
from types import SimpleNamespace
from typing import Dict, List, Optional

import numpy as np
import torch

from stgcma_tpu_torch.serving import MultiTaskServer
from stgcma_tpu_torch.train.optim import ADAM_BETAS, build_optimizer, cosine_schedule
from stgcma_tpu_torch.train.steps import init_train_state, make_train_step

from . import traffic, weights
from .reference import no_tf32
from .reference.layers import fp8_products
from .reference.train import adam_steps, leaf_gaps, warmup_scale
from .trace import traced

# what sets a cell's upper readings, in the program's place: "fp8", the
# reference with float8 operands in every product; "int8_tower", the
# program's own int8 frozen tower (serving only); and for training, the
# reference with a fault planted: "half" (each step's loss over half of its
# batch), "frozen" (a step that leaves its state as it was)
CONTROLS = ("fp8", "int8_tower", "half", "frozen")


def percentile(values: List[float], q: float) -> float:
    """The q-th percentile of values, linear between the closest ranks."""
    v = sorted(values)
    if not v:
        return math.nan
    x = (len(v) - 1) * q / 100.0
    lo = math.floor(x)
    hi = min(lo + 1, len(v) - 1)
    return v[lo] + (v[hi] - v[lo]) * (x - lo)


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize()


def build_model(fam, c: dict, W: Dict[str, torch.Tensor]):
    """The program's model of configuration c, made on the meta device and
    given the benchmark's tensors as its parameters (no copy)."""
    with torch.device("meta"):
        model = fam.new_model(c)
    model.load_state_dict(W, strict=True, assign=True)
    return model


def leaf_shapes(fam, c: dict) -> Dict[str, tuple]:
    with torch.device("meta"):
        model = fam.new_model(c)
    return {n: tuple(p.shape) for n, p in model.named_parameters()}


def _on(batch: dict, device) -> dict:
    return {k: v.to(device) for k, v in batch.items()}


def off_dtype(model: torch.nn.Module, dtype: torch.dtype) -> int:
    """How many tensors of a served model are held in neither the run's
    compute dtype nor an index type: a float of another width, or an 8-bit
    integer (a quantized weight). The configuration states its dtype; a
    served copy that departs from it is not what the cell measures."""
    index = (torch.int16, torch.int32, torch.int64, torch.bool)
    return sum(1 for t in itertools.chain(model.parameters(), model.buffers())
               if t.dtype != dtype and t.dtype not in index)


def lr_tables(t: dict):
    """The program's per-step tables of the adapters' and the head's
    learning rates, as the CLI's Trainer builds them from its `schedule`
    (cosine after a linear warm-up from 0); (None, None), a constant rate,
    where the configuration gives none."""
    s = t.get("schedule")
    if s is None:
        return None, None
    return tuple(cosine_schedule(lr, s["min_lr"], s["epochs"], s["steps_per_epoch"],
                                 s["warmup_epochs"])
                 for lr in (t["lr"], t["lr"] * t["head_lr_mult"]))


def _trainable(c: dict, names) -> Dict[str, str]:
    """{leaf: "head" or "adapt"} of the leaves the configuration trains."""
    t = c["train"]
    out = {}
    for n in names:
        if any(n.startswith(p) for p in t["head_prefixes"]):
            out[n] = "head"
        elif any(p in n for p in t["adapt_patterns"]):
            out[n] = "adapt"
    return out


def run_cell(reg, name: str, seed: int, seconds: float, trace: bool, device,
             t_start: float, control: Optional[str] = None,
             dtype: torch.dtype = torch.bfloat16) -> SimpleNamespace:
    """One run of cell `name`. Returns the run's record: its counts and
    times, the trace's numbers, the memory peak, and `checks`: {number:
    (value, limit)}. `dtype` is the program's compute dtype: the
    configuration's bf16, or float32 as a witness beside the reference."""
    device = torch.device(device)
    cell = reg.cell(name)
    c = reg.config(cell["config"])
    mix = reg.traffic(cell["traffic"])
    fam = reg.family(c["family"])
    if control is not None and control not in CONTROLS:
        raise ValueError(f"unknown control {control!r}; one of {CONTROLS}")
    run = SimpleNamespace(mode=mix["mode"], batch=mix["batch"], trace=None, control=control,
                          dtype=dtype,
                          count=fam.count(c, mix["batch"], mix["mode"] == "train"))
    marks = [("start", time.time())]
    W = weights.draw(leaf_shapes(fam, c), seed, device, tuple(c.get("fan_in_uniform", ())))
    _sync(device)
    marks.append(("weights", time.time()))
    pool = traffic.make_pool(mix, seed, device, pin=device.type == "cuda")
    marks.append(("traffic", time.time()))
    run.marks = marks
    body = _serve if mix["mode"] == "serve" else _train
    body(run, fam, c, mix, W, pool, seed, seconds, trace, device, t_start)
    return run


def _peak(device) -> int:
    return torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

def _serve(run, fam, c, mix, W, pool, seed, seconds, trace, device, t_start):
    model = build_model(fam, c, W)
    if run.control == "int8_tower":
        model = fam.quantize(model)
    server = MultiTaskServer(dtype=run.dtype, device=device)
    task = fam.serve(server, model, c)
    off = off_dtype(server.models[task], run.dtype)
    del model
    run.marks.append(("server", time.time()))
    for b in pool:                                # every shape of the window, built
        server.predict(task, b)
    _sync(device)
    run.marks.append(("warm-up", time.time()))
    run.setup_s = time.time() - t_start
    outs, lat = [], []
    t0 = time.perf_counter()
    while True:
        ts = time.perf_counter()
        outs.append(server.predict(task, pool[len(outs) % len(pool)]))
        te = time.perf_counter()
        lat.append((te - ts) * 1e3)
        if te - t0 >= seconds:
            break
    run.window_s = te - t0
    run.requests = len(outs)
    run.clips = len(outs) * mix["batch"]
    run.latencies_ms = lat
    run.memory_peak = _peak(device)
    if trace:
        run.trace = traced(lambda k: server.predict(task, pool[k % len(pool)]),
                           mix["trace_requests"])
    del server
    if device.type == "cuda":
        torch.cuda.empty_cache()
    run.readings = _check_serve(fam, c, mix, W, pool, outs, seed, device, run.control == "fp8")
    run.readings["served_off_dtype"] = float(off)
    run.checks = {k: (run.readings[k], lim) for k, lim in c["limits"]["serve"].items()}
    run.checks["served_off_dtype"] = (float(off), 0.0)


def _reference_logits(fam, c, mix, W, batch) -> torch.Tensor:
    """The reference's logits of one request, `ref_chunk` clips at a time."""
    B, step = mix["batch"], mix["ref_chunk"]
    with torch.no_grad(), no_tf32():
        return torch.cat([fam.ref_serve(W, c, {n: t[s:s + step] for n, t in batch.items()})
                          .float() for s in range(0, B, step)]).cpu()


def _check_serve(fam, c, mix, W, pool, outs, seed, device, control=False) -> Dict[str, float]:
    """A sample of the window's requests, drawn from the seed, against the
    reference on their inputs: the largest logit error, and the error's RMS,
    each over the same measure of the reference's logits less their mean
    over the request's rows, the part that the inputs decide (with random
    weights a large common part would otherwise hide a wrong row). With
    `control`, the fp8 reference's logits stand in the program's place."""
    rng = np.random.default_rng(seed)
    picks = sorted(rng.choice(len(outs), size=min(mix["sample"], len(outs)), replace=False))
    refs: Dict[int, torch.Tensor] = {}
    ctls: Dict[int, torch.Tensor] = {}
    err_max = err_rms = 0.0
    finite = True
    for i in picks:
        k = i % len(pool)
        if k not in refs:
            batch = _on(pool[k], device)
            refs[k] = _reference_logits(fam, c, mix, W, batch)
            if control:
                with fp8_products():
                    ctls[k] = _reference_logits(fam, c, mix, W, batch)
        ref = refs[k].double()
        out = ctls[k].double() if control else torch.from_numpy(np.asarray(outs[i])).double()
        finite &= bool(torch.isfinite(out).all())
        d, spread = out - ref, ref - ref.mean(dim=0)
        err_max = max(err_max, float(d.abs().max() / spread.abs().max()))
        err_rms = max(err_rms, float(d.square().mean().sqrt() / spread.square().mean().sqrt()))
    return {"logit_err_max": err_max if finite else math.inf,
            "logit_err_rms": err_rms if finite else math.inf}


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------

def _train(run, fam, c, mix, W, pool, seed, seconds, trace, device, t_start):
    model = build_model(fam, c, W)
    mask = init_train_state(model, freeze_base=True)
    roles = _trainable(c, W)
    leaves = sorted(roles)
    run.train_leaves_match = sorted(n for n, m in mask.items() if m) == leaves
    W0 = dict(W)
    W0.update({n: W[n].detach().clone() for n in leaves})
    t = c["train"]
    opt = build_optimizer(model, t["lr"], t["head_lr_mult"], t["weight_decay"], *lr_tables(t))
    step = make_train_step(fam.loss_fn(c, device, run.dtype), opt, run.dtype)
    gen = torch.Generator().manual_seed(seed)
    run.marks.append(("model", time.time()))
    n_check = mix["checked_steps"]
    losses, first_grad = [], {}
    for k in range(n_check):
        loss, _ = step(model, pool[k], gen)
        losses.append(float(loss))
        if k == 0:
            st = opt.adam.state
            first_grad = {n: st[p]["exp_avg"] / (1 - ADAM_BETAS[0])
                          for n, p in opt.named_parameters() if p in st}
    after = {n: p.detach().clone() for n, p in opt.named_parameters()}
    _sync(device)
    run.marks.append(("checked steps", time.time()))
    run.setup_s = time.time() - t_start
    steps = 0
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        step(model, pool[(n_check + steps) % len(pool)], gen)
        steps += 1
    _sync(device)
    run.window_s = time.perf_counter() - t0
    run.steps = steps
    run.clips = steps * mix["batch"]
    run.memory_peak = _peak(device)
    if trace:
        run.trace = traced(lambda k: step(model, pool[k % len(pool)], gen), mix["trace_steps"])
    del model, opt, step
    if device.type == "cuda":
        torch.cuda.empty_cache()
    delta = {n: after[n] - W0[n] for n in after}
    run.readings = _check_train(fam, c, mix, W0, pool, roles, seed, device, losses, first_grad,
                                delta, run)
    run.checks = {k: (run.readings[k], lim) for k, lim in c["limits"]["train"].items()}
    if not run.train_leaves_match:
        run.checks["train_leaves"] = (1.0, 0.0)


def _check_train(fam, c, mix, W0, pool, roles, seed, device, losses, first_grad, delta,
                 run) -> Dict[str, float]:
    """The reference's checked steps from the same weights, batches and
    draws; each number is the program's distance from it: the largest
    relative gap of a step's loss; the gap of each leaf's first gradient
    as Adam holds it, and of its change over the steps (leaves whose
    reference gradient is under a thousandth of the median leaf's left out
    of the change: Adam moves them by round-off), each against the larger
    of that leaf's reference norm and the median leaf's, by the worst leaf
    and by the median one. A control (`CONTROLS`) stands in the program's
    place."""
    t = c["train"]
    lrs = {n: t["lr"] * (t["head_lr_mult"] if r == "head" else 1.0) for n, r in roles.items()}
    n_check = mix["checked_steps"]
    batches = [_on(pool[k], device) for k in range(n_check)]

    def reference(fp8=False, rows=None, lr=1.0):
        g = torch.Generator().manual_seed(seed)
        feed = batches if rows is None else [{k: v[:rows] for k, v in b.items()}
                                             for b in batches]
        with no_tf32(), fp8_products(fp8):
            return adam_steps(W0, {n: lr * x for n, x in lrs.items()}, lambda W, k:
                              fam.ref_loss_chunks(W, c, feed[k], g, mix["ref_chunk"]),
                              n_check, t["weight_decay"], ADAM_BETAS,
                              scale=warmup_scale(t, n_check))

    ref = reference()
    if run.control in ("fp8", "half"):
        ctl = reference(fp8=True) if run.control == "fp8" else reference(rows=mix["batch"] // 2)
        losses, first_grad, delta = ctl["loss"], ctl["grad"], ctl["delta"]
    elif run.control == "frozen":
        losses = reference(lr=0.0)["loss"]
        first_grad, delta = {}, {n: torch.zeros_like(W0[n]) for n in roles}
    leaves = sorted(roles)
    norms = {n: float(torch.linalg.vector_norm(ref["raw_grad"][n])) for n in leaves}
    med = sorted(norms.values())[len(norms) // 2]
    moving = [n for n in leaves if norms[n] >= 1e-3 * med]
    grad = leaf_gaps(first_grad, ref["grad"], leaves)
    upd = leaf_gaps(delta, ref["delta"], moving)
    run.ref_losses, run.prog_losses = ref["loss"], losses
    run.worst_leaves = {"grad": max(grad, key=grad.get), "update": max(upd, key=upd.get)}
    run.still_leaves = sorted(set(leaves) - set(moving))
    finite = all(math.isfinite(x) for x in losses)
    return {"loss_gap": max(abs(p - r) / abs(r) for p, r in zip(losses, ref["loss"]))
            if finite else math.inf,
            "grad_gap": max(grad.values()), "grad_gap_median": statistics.median(grad.values()),
            "update_gap": max(upd.values()),
            "update_gap_median": statistics.median(upd.values())}
