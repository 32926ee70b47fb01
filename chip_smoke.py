#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (stgcma_tpu_torch) once on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one or more lines each; any failure exits non-zero before the last
line:
  1. environment: torch and CUDA versions, the card's name and power limit;
  2. build: nvcc builds the kernels of stgcma_tpu_torch/csrc/ (in parallel);
  3. kernels: K1 (bf16 attention block), K2 (its int8 twin) and K3 (int8
     FFN) against their plain PyTorch versions on the card, at the B = 8
     shapes of the main path, with the stated tolerance, and timed beside
     their bound and a yardstick composed of PyTorch's own calls;
  4. slice: MultiTaskServer(device="cuda") serving AVE-29 with CLIP ViT-B/16
     in fusion mode at full width (12 layers, C = 768, T = 10 frames at
     224^2, 102x128 fbank audio), random seeded weights, one bf16 task and
     one int8 task; a few B = 8 requests; launch counts per forward; B = 1
     logits held against the same model on the CPU (plain versions);
     clips/s per mode.
The line before the last is one JSON object {"kernels": [...]}; the last is
{"ok": true, "device": {...}}. Without a CUDA device it exits 1 at once.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

SEED = 0
B = 8
TOL_KERNEL = 2e-2    # max |kernel - plain| / max |plain|, bf16 outputs: a few
                     # bf16 steps where an intermediate rounds the other way
TOL_SLICE = 5e-2     # max |card - cpu| / max |cpu| over the logits, bf16 through
                     # 12 blocks on two devices (different sum orders everywhere)
H100_BF16, H100_INT8, H100_BYTES = 989e12, 1979e12, 3.35e12   # dense peaks, 700 W


def log(msg):
    print(msg, flush=True)


def fail(msg):
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def smi_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 else "nvidia-smi failed"


def cuda_ms(fn, iters, warmup=2):
    import torch
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------

def make_block_inputs(g, Bq, N, C, heads, int8, nWb=0):
    import torch
    from stgcma_tpu_torch.ops.quant import quantize_weight
    dev, bf = "cuda", torch.bfloat16

    def rnd(*shape, std=1.0):
        return torch.randn(*shape, generator=g, device=dev) * std

    x = rnd(Bq, N, C).to(bf)
    ln_w, ln_b = (1 + rnd(C, std=0.1)).to(bf), rnd(C, std=0.02).to(bf)
    w_qkv, w_proj = rnd(3 * C, C, std=0.02), rnd(C, C, std=0.02)
    b_qkv, b_proj = rnd(3 * C, std=0.02).to(bf), rnd(C, std=0.02).to(bf)
    bias = rnd(nWb, heads, N, N, std=1.0) if nWb else None
    if not int8:
        return (x, ln_w, ln_b, w_qkv.to(bf), b_qkv, w_proj.to(bf), b_proj), bias
    qq, qs = quantize_weight(w_qkv)
    pq, ps = quantize_weight(w_proj)
    return (x, ln_w, ln_b, qq, qs.to(bf), b_qkv, pq, ps.to(bf), b_proj), bias


def make_ffn_inputs(g, M, C):
    import torch
    from stgcma_tpu_torch.ops.quant import quantize_weight
    dev, bf = "cuda", torch.bfloat16

    def rnd(*shape, std=1.0):
        return torch.randn(*shape, generator=g, device=dev) * std

    x = rnd(M, C).to(bf)
    ln_w, ln_b = (1 + rnd(C, std=0.1)).to(bf), rnd(C, std=0.02).to(bf)
    w1q, s1 = quantize_weight(rnd(4 * C, C, std=0.02))
    w2q, s2 = quantize_weight(rnd(C, 4 * C, std=0.02))
    return (x, ln_w, ln_b, w1q, s1.to(bf), rnd(4 * C, std=0.02).to(bf),
            w2q, s2.to(bf), rnd(C, std=0.02).to(bf))


def block_bound(Bq, N, C, heads, int8, nWb):
    """Least time: max(bytes / HBM rate, operations / peak rate of their type).
    Bytes: x read, out written, weights/biases/scales/LN params read once."""
    M, dh = Bq * N, C // heads
    proj_ops = 2 * M * C * 3 * C + 2 * M * C * C
    gram_ops = 2 * 2 * Bq * heads * N * N * dh
    wbytes = (4 * C * C) * (1 if int8 else 2) + (4 * C) * 2 * (2 if int8 else 1) + 2 * C * 2
    nbytes = 2 * M * C * 2 + wbytes + (nWb * heads * N * N * 4 if nWb else 0)
    t_ops = (proj_ops / (H100_INT8 if int8 else H100_BF16) + gram_ops / H100_BF16)
    t_bytes = nbytes / H100_BYTES
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def ffn_bound(M, C):
    H = 4 * C
    ops = 2 * 2 * M * C * H
    nbytes = 2 * M * C * 2 + 2 * C * H + (H + C) * 2 * 2 + 2 * C * 2
    t_ops, t_bytes = ops / H100_INT8, nbytes / H100_BYTES
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def library_qmm(a, wq, ws, b):
    """Row-quantized int8 product through torch._int_mm, dequantized in fp32."""
    import torch
    af = a.float()
    s = af.abs().amax(-1, keepdim=True).clamp_min(1e-30) / 127
    aq = torch.round(af / s).clamp(-127, 127).to(torch.int8)
    return torch._int_mm(aq, wq.t()).float() * s * ws.float() + b.float()


def library_block(args, heads, int8):
    """The same function from PyTorch's own calls (timed only, never used by
    the port): layer_norm, linear or _int_mm, scaled_dot_product_attention."""
    import torch
    import torch.nn.functional as F
    x = args[0]
    Bq, N, C = x.shape
    dh = C // heads

    def run():
        xn = F.layer_norm(x, (C,), args[1], args[2])
        if int8:
            qkv = library_qmm(xn.view(-1, C), args[3], args[4], args[5]).to(torch.bfloat16)
        else:
            qkv = F.linear(xn, args[3], args[4])
        q, k, v = qkv.view(Bq, N, 3, heads, dh).permute(2, 0, 3, 1, 4)
        o = F.scaled_dot_product_attention(q, k, v).transpose(1, 2).reshape(Bq * N, C)
        if int8:
            return library_qmm(o, args[6], args[7], args[8]).to(torch.bfloat16)
        return F.linear(o, args[5], args[6])
    return run


def library_ffn(args, act):
    import torch
    import torch.nn.functional as F
    x, C = args[0], args[0].shape[1]

    def run():
        h = library_qmm(F.layer_norm(x, (C,), args[1], args[2]), args[3], args[4], args[5])
        h = h * torch.sigmoid(1.702 * h) if act == "quick_gelu" else F.gelu(h)
        return library_qmm(h, args[6], args[7], args[8]).to(torch.bfloat16)
    return run


def check_kernel(name, kernel, plain, args, kw, bound, library):
    import torch
    out = kernel(*args, **kw)
    torch.cuda.synchronize()
    ref = plain(*args, **kw)
    if not torch.isfinite(out).all():
        fail(f"{name}: non-finite kernel output")
    err = (out.float() - ref.float()).abs().max().item()
    scale = ref.float().abs().max().item()
    if not err <= TOL_KERNEL * scale:
        fail(f"{name}: max |kernel - plain| = {err:.4g} > {TOL_KERNEL} * {scale:.4g}")
    ms = cuda_ms(lambda: kernel(*args, **kw), iters=20)
    plain_ms = cuda_ms(lambda: plain(*args, **kw), iters=3, warmup=1)
    try:
        library_ms = cuda_ms(library, iters=20)
    except RuntimeError as e:        # a yardstick only; the port never calls it
        log(f"  {name}: library yardstick unavailable: {e}")
        library_ms = None
    bound_ms, bound_by = bound
    lib_s = "null" if library_ms is None else f"{library_ms:.4f}"
    log(f"  {name}: max_abs_err {err:.4g} (max |plain| {scale:.4g}, tol {TOL_KERNEL} rel) "
        f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, library {lib_s} ms, "
        f"bound {bound_ms:.4f} ms ({bound_by})")
    return {"shape": name, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": library_ms}


def phase_kernels(cfg):
    import torch
    from stgcma_tpu_torch.ops import fused_attn as FA
    g = torch.Generator(device="cuda").manual_seed(SEED)
    C, heads, T = cfg.embed_dim, cfg.heads, cfg.num_frames
    Nv, Na = cfg.num_patches + 1, cfg.num_patches_audio + 1
    sites = [("video temporal", B * Nv, T), ("audio temporal", B * Na, T),
             ("video spatial", B * T, Nv), ("audio spatial", B * T, Na)]
    results = {"K1": [], "K2": [], "K3": []}
    for kname, kernel, plain, int8 in (("K1", FA.win_block, FA.win_block_plain, False),
                                       ("K2", FA.win_block_q, FA.win_block_q_plain, True)):
        for site, Bq, N in sites:
            args, _ = make_block_inputs(g, Bq, N, C, heads, int8)
            results[kname].append(check_kernel(
                f"{kname} {site} {(Bq, N, C)}", kernel, plain, args + (heads,), {},
                block_bound(Bq, N, C, heads, int8, 0), library_block(args, heads, int8)))
    Bq, N, nWb = B * T, Na, 4
    args, bias = make_block_inputs(g, Bq, N, C, heads, False, nWb=nWb)
    results["K1"].append(check_kernel(
        f"K1 bias period {nWb} {(Bq, N, C)}", FA.win_block, FA.win_block_plain,
        args + (heads,), {"bias": bias}, block_bound(Bq, N, C, heads, False, nWb),
        library_block(args, heads, False)))
    for site, M, act in (("video", B * T * Nv, "quick_gelu"), ("audio", B * T * Na, "quick_gelu"),
                         ("audio erf-GELU", B * T * Na, "gelu")):
        args = make_ffn_inputs(g, M, C)
        results["K3"].append(check_kernel(
            f"K3 {site} {(M, C)}", FA.ffn_q, FA.ffn_q_plain, args + (act,), {},
            ffn_bound(M, C), library_ffn(args, act)))
    return results


# ---------------------------------------------------------------------------
# phase 4: the slice
# ---------------------------------------------------------------------------

def phase_slice(cfg, smi):
    import numpy as np
    import torch
    from stgcma_tpu_torch.models.ave import random_clip_ave
    from stgcma_tpu_torch.ops import fused_attn as FA
    from stgcma_tpu_torch.ops.quant import quantize_clip_tower
    from stgcma_tpu_torch.serving import MultiTaskServer

    t0 = time.perf_counter()
    model = random_clip_ave(cfg, SEED)
    model_q = random_clip_ave(cfg, SEED)
    model_q.backbone = quantize_clip_tower(model_q.backbone)
    srv = MultiTaskServer(device="cuda")
    srv.add_clip_ave("ave29_bf16", cfg, model)
    srv.add_clip_ave("ave29_int8", cfg, model_q)
    log(f"  set-up: random weights, int8 tower, server on the card: "
        f"{time.perf_counter() - t0:.1f} s; tasks {srv.tasks()}")

    rng = np.random.RandomState(SEED)

    def batch(b):
        return {"a": rng.randn(b, cfg.num_frames, cfg.audio_tdim, cfg.audio_fdim).astype(np.float32),
                "v": rng.randn(b, cfg.num_frames, cfg.input_resolution,
                               cfg.input_resolution, 3).astype(np.float32)}

    requests = [batch(B) for _ in range(4)]
    # 4 attention sites (temporal/spatial x video/audio) and 2 FFNs a block:
    # 48 K1, or 48 K2 + 24 K3, a forward at 12 layers
    L = cfg.layers
    want = {"ave29_bf16": {"K1": 4 * L, "K2": 0, "K3": 0},
            "ave29_int8": {"K1": 0, "K2": 4 * L, "K3": 2 * L}}
    kernels = {"K1": FA.win_block, "K2": FA.win_block_q, "K3": FA.ffn_q}
    totals = {k: 0 for k in kernels}
    clips = {}
    for task in srv.tasks():
        # the main path: counts set to 0 just before, read just after
        times = []
        for i, req in enumerate(requests):
            FA.reset_launches()
            t1 = time.perf_counter()
            out = srv.predict(task, req)
            times.append(time.perf_counter() - t1)
            got = {k: kern.launches for k, kern in kernels.items()}
            if got != want[task]:
                fail(f"{task} request {i}: launches {got}, expected {want[task]} per forward")
            for k in kernels:
                totals[k] += got[k]
            if out.shape != (B * cfg.num_frames, cfg.label_dim) or not np.isfinite(out).all():
                fail(f"{task}: logits of shape {out.shape}, finite={np.isfinite(out).all()}")
        steady = sorted(times[1:])
        med = steady[len(steady) // 2]
        clips[task] = B / med
        log(f"  {task}: {len(requests)} requests of B={B}, logits {out.shape} finite; "
            f"launches per forward {want[task]}; first request {times[0] * 1e3:.1f} ms, "
            f"median of the other {len(steady)} {med * 1e3:.2f} ms (min {steady[0] * 1e3:.2f}, "
            f"max {steady[-1] * 1e3:.2f}) = {clips[task]:.2f} clips/s on {smi}")
    for k, n in totals.items():
        if n == 0:
            fail(f"{k} was launched no time on the main path")

    # B = 1: the card against the same port model on the CPU (plain versions)
    cpu = MultiTaskServer(device="cpu")
    cpu.add_clip_ave("ave29_bf16", cfg, model)
    cpu.add_clip_ave("ave29_int8", cfg, model_q)
    one = batch(1)
    for task in srv.tasks():
        t1 = time.perf_counter()
        ref = cpu.predict(task, one)
        cpu_s = time.perf_counter() - t1
        got = srv.predict(task, one)
        err = float(np.abs(got - ref).max())
        scale = float(np.abs(ref).max())
        if not err <= TOL_SLICE * scale:
            fail(f"{task} B=1: max |card - cpu| = {err:.4g} > {TOL_SLICE} * {scale:.4g}")
        log(f"  {task} B=1 card vs CPU: max_abs_err {err:.4g} (max |cpu| {scale:.4g}, "
            f"tol {TOL_SLICE} rel; CPU forward {cpu_s:.1f} s)")
    return totals, clips


def main():
    try:
        import torch
    except ImportError:
        fail("torch is not installed")
    if not torch.cuda.is_available():
        fail("no CUDA device: this script drives the port on the GPU only")
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    try:
        from stgcma_tpu_torch.configs import clip_b16
        from stgcma_tpu_torch.ops import cuda_lib
    except ImportError as e:
        fail(f"the port package is not beside this script: {e}")
    torch.backends.cuda.matmul.allow_tf32 = False    # plain versions: true fp32
    torch.backends.cudnn.allow_tf32 = False

    smi = smi_line()
    log(f"[1/4] environment: python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}, device {torch.cuda.get_device_name(0)} "
        f"x{torch.cuda.device_count()}; nvidia-smi: {smi}")

    t0 = time.perf_counter()
    out_dir = cuda_lib.build()
    for src in cuda_lib.SIGNATURES:
        cuda_lib.lib(src)
    log(f"[2/4] build: {len(cuda_lib.SIGNATURES)} sources built in parallel and loaded in "
        f"{time.perf_counter() - t0:.1f} s -> {out_dir}")
    for src in cuda_lib.SIGNATURES:
        logf = out_dir / f"{src}.log"
        if logf.exists():
            for line in logf.read_text().splitlines():
                if "registers" in line or "spill" in line:
                    log(f"  {src}: {line.strip()}")

    cfg = clip_b16(ftmode="fusion", label_dim=29)
    log(f"[3/4] kernels against their plain versions (bf16, B={B}, tol {TOL_KERNEL} rel)")
    results = phase_kernels(cfg)

    log(f"[4/4] slice: CLIP ViT-B/16 fusion AVE-29, {cfg.layers} layers, C={cfg.embed_dim}, "
        f"T={cfg.num_frames}, bf16 and int8 towers")
    totals, clips = phase_slice(cfg, smi)

    meta = {
        "K1": ("K1 win_block (bf16 attention block)", "stgcma_tpu/ops/pallas_attn.py:385",
               ["gemm.cu", "attn.cu", "rowprep.cu"]),
        "K2": ("K2 win_block_q (int8 attention block)", "stgcma_tpu/ops/pallas_attn.py:1461",
               ["gemm.cu", "attn.cu", "rowprep.cu"]),
        "K3": ("K3 ffn_q (int8 FFN)", "stgcma_tpu/ops/pallas_attn.py:1616",
               ["gemm.cu", "rowprep.cu"]),
    }
    kernels = []
    for k, rows in results.items():
        name, replaces, srcs = meta[k]
        head = rows[2] if k != "K3" else rows[0]     # video spatial / video FFN
        kernels.append({"name": name, "route": "cuda", "source": "stgcma_tpu_torch/csrc",
                        "sources": [f"stgcma_tpu_torch/csrc/{s}" for s in srcs],
                        "replaces": replaces, "launches": totals[k], **head,
                        "shapes": rows})
    log("clips/s: " + ", ".join(f"{t} {c:.2f}" for t, c in clips.items()) + f" on {smi}")
    log(smi)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
