"""The parts that K1-K4 and K11-K14 share, alone on the card, the K1, K2,
K3 and K12 rows that carry them, and K7 and the small attention core.

    python3 stgcma_tpu_torch/tools/bench_parts.py [--tree DIR] [--label NAME]
        [--out chiprun_out/bench_parts] [--only SUBSTR,...]

Rows, at B = 8 of the main path (AVE-29 CLIP ViT-B/16 fusion) unless named:
- csrc/gemm.cu's bf16 product at the tower's shapes: qkv (15760, 2304, 768),
  proj (15760, 768, 768), fc1 with QuickGELU (19680, 3072, 768) and fc2
  (19680, 768, 3072) over both streams as K12 runs them, the adapter
  products at N = 48 (erf-GELU of the rounded hidden) and K = 48 (onto two
  residuals);
- csrc/gemm.cu's int8 product (int8 codes in, exact int32 sums) at K2's and
  K3's CLIP-B/16 video shapes: qkv (15760, 2304, 768) and proj (15760, 768,
  768) with the bf16 epilogue, fc1 with the fp32 QuickGELU hidden and its
  row maxima (15760, 3072, 768) and fc2 (15760, 768, 3072), and Swin-Base
  stage 0's qkv (250880, 384, 128), one k-tile; each with TOP/s and
  torch._int_mm on the same codes plus the fp32 dequant as the yardstick;
  csrc/rowprep.cu's row quantization of the LN rows (15760, 768) and of the
  fp32 hidden (15760, 3072), from its given row maxima where the tree takes
  them and from its own (12 KB rows: staged in shared memory);
- csrc/attn.cu's attention core over a packed qkv: (80, 197, 768) h12,
  (80, 257, 1024) h16 (CLIP ViT-L/14), (160, 196, 512) h16 with a
  (1, 16, 196, 196) bias (K4 at Swin-Base stage 2) and (16, 1000, 768) h12,
  past the resident limit (the streamed kernel);
- K1 at the CLIP-B/16 video spatial site (80, 197, 768) and at CLIP-L/14's
  (80, 257, 1024) h16, and K12 (bf16) at v (80, 197, 768), a (80, 49, 768);
  K2 (int8) at the CLIP-B/16 video spatial (80, 197, 768) and temporal
  (1576, 10, 768) sites and at the audio ones (80, 49, 768), (392, 10, 768),
  K3 (int8, QuickGELU) at the video (15760, 768) and audio (3920, 768) rows,
  K11's spatial body (video, audio) and FFN body (video), the int8 K12 and
  K13 (video and audio rows);
- the Swin fusion kernels (`swin_fuse_cases`): K4 float and int8 at
  Swin-Base stage 2 unshifted and shifted (80, 196, 512) h16 D 32 and stage 3
  (80, 49, 1024) h32 D 64, K4 float at Swin-Large stage 2 (80, 196, 768) h24
  D 96, each with live adapters and gates; K6 at Swin-Base stages 0-1
  (80, 3136, 16), (80, 784, 32) and Swin-Large's (80, 3136, 96), (80, 784,
  96); K5 at Swin-Large's windows (5120, 49, 96), (1280, 49, 96); K10 at
  (80, 1764, 16); K4's attention core alone at Swin-Base stage 2 shifted
  (160, 196, 512) h16 with its bias (relative positions + the window and
  shift mask), over the full grid and, where the tree has it, over each
  window's 49 tokens (`_attn_core_win`). Each with its bound (the exps at
  16 a clock an SM on the special function units beside the tensor and
  byte terms), its library yardstick where one exists (SDPA) and `graph_ms`;
- K13 (float) at the CLIP-B/16 video (1576, 10, 768) and audio (392, 10,
  768) rows and CLIP-L/14's video rows (2056, 10, 1024), K14 (float and
  int8) at the CLIP-B/16 video (80, 197, 768) and audio (80, 49, 768) rows
  in the tower's layout, K11's temporal body
  at the CLIP-B/16 video and audio rows (`tadapt_cases`), and, where the tree
  has them, csrc/tattn.cu's temporal product T alone (bf16 and int8, the
  video rows: qkv and each sequence's attention; and at K14's frame-strided
  layout, (80, 197, 768) as the tower holds it) and csrc/rowadapt.cu's
  row-owning product R alone (K13's: proj, the T_Adapter and the residual;
  K14's, with the residual rounded once; K11 qd's: the int8 proj and the
  adapter hidden), each with `graph_ms`;
- K8 at Swin-Base stage 3's temporal site, K9 at Swin-Base's six norm
  sites (five shapes) and Swin-Large's patch-embed and widest merge norm
  (3920, 3072), each also through its bare launcher (`bare_ms`): what the
  wrapper's host work adds to a short kernel. These, K2, K3, K11 and the int8 K12, K13 rows (and
  their audio rows at M = 3920) also give `graph_ms`: the device time of one
  call replayed from a CUDA graph, with no host work;
- K7 (csrc/ffn.cu) at every FFN site of the presets (`FFN_SHAPES`: Swin-Base
  stages 0-1, Swin-Large stages 0-1, Swin-Base 168^2 stage 0) and
  csrc/attn.cu's small core (N <= 64) alone at K8's two Swin stage-3 sites,
  K1's CLIP-B/16 temporal and audio spatial pairs and Swin stage 0 windows,
  with K8's whole site from the packed qkv to merged heads (`wmsa_qkv`, or
  the copies around `wmsa` in a tree without it), each with `graph_ms`.

Each row is first held against its plain PyTorch version (max |kernel -
plain| <= 2e-2 max |plain|, 3e-2 for K11 and the int8 K12 and K13; the int8
products with the bf16 epilogue must equal it bit for bit, the fp32 GELU
hiddens lie within 1e-6 of it, for the ulps of erff / expf, and their row
maxima equal those of the stored hidden; the script exits 1 if a row is not
held), then timed with CUDA events (the
mean of 20 calls after 3; its plain version, `plain_ms`, of 3 after 1). With --tree the package is imported from another
checkout, e.g. an earlier commit unpacked with `git archive` into a
directory .gitignore lists, so that two versions run in one chip call in
turns (each builds its own kernels); every int8 product row carries a
digest of its output's bytes, and each run compares its digests with those
of the runs already in OUT (exit 1 if an int8 product differs by a bit).
With --only just the rows whose name holds one of the given substrings run.
Prints one JSON object a row and writes them to OUT/LABEL.json. Needs a
CUDA device.
"""
from __future__ import annotations

import argparse
import hashlib
import inspect
import json
import os
import sys
from pathlib import Path

TOL = 2e-2
TOL_S8_F32 = 1e-6                            # the int8 products' fp32 GELU hiddens
TOL_Q = 3e-2                                 # K11, the int8 K4, K12, K13 and K4 at Swin-Large
                                             # (chip_smoke.py's bars)
SFU_PER_SM_CLOCK, H100_SMS = 16, 132         # exps a clock an SM (special function units)
H100_BF16, H100_INT8, H100_BYTES = 989e12, 1979e12, 3.35e12   # dense peaks, HBM rate, 700 W
# (row, M, N, K, epilogue): epilogue of csrc/gemm.cu, "res2" through stg_gemm_bf16_res2
GEMM_SHAPES = (("qkv", 15760, 2304, 768, "bf16"), ("proj", 15760, 768, 768, "bf16"),
               ("fc1 QuickGELU", 19680, 3072, 768, "quickgelu"), ("fc2", 19680, 768, 3072, "bf16"),
               ("adapter fc1 N=48", 15760, 48, 768, "rgelu"),
               ("adapter fc2 K=48", 15760, 768, 48, "res2"))
# (row, M, N, K, epilogue) of the int8 product: "bf16" (EPI_Q_BF16) or "quickgelu"
# (the fp32 QuickGELU hidden)
S8_SHAPES = (("qkv", 15760, 2304, 768, "bf16"), ("proj", 15760, 768, 768, "bf16"),
             ("fc1 QuickGELU fp32", 15760, 3072, 768, "quickgelu"),
             ("fc2", 15760, 768, 3072, "bf16"), ("Swin st.0 qkv K=128", 250880, 384, 128, "bf16"))
# (row, B_, N, C, heads, bias)
CORE_SHAPES = (("CLIP-B/16 spatial", 80, 197, 768, 12, False),
               ("CLIP-L/14 spatial", 80, 257, 1024, 16, False),
               ("Swin-Base st.2 K4 grid, bias", 160, 196, 512, 16, True),
               ("streamed", 16, 1000, 768, 12, False))


# K7 at every site of the presets: (row, M, C), hidden 4C
FFN_SHAPES = (("Swin-Base st.0", 250880, 128), ("Swin-Base st.1", 62720, 256),
              ("Swin-Large st.0", 250880, 192), ("Swin-Large st.1", 62720, 384),
              ("Swin-Base 168^2 st.0", 141120, 128))
# csrc/attn.cu's small core (N <= 64) over a packed qkv: (row, B_, N, C, heads, bias period
# of the windows or None)
SMALL_CORE_SHAPES = (("K8 Swin st.3 windows", 80, 49, 1024, 32, 1),
                     ("K8 Swin st.3 temporal", 392, 10, 1024, 32, 1),
                     ("K1 CLIP-B/16 temporal pairs", 1576, 10, 768, 12, None),
                     ("K1 CLIP-B/16 audio spatial pairs", 80, 49, 768, 12, None),
                     ("K1 Swin st.0 windows", 5120, 49, 128, 4, 64))
# instructions of one erf-GELU of csrc/ffn.cu (`erf_gelu`, A&S 7.1.26: 2 of them on the
# special function unit) on sm_90a: those of a kernel y[i] = gelu(x[i]) less those of y[i]
# = x[i], in the SASS that `python3 stgcma_tpu_torch/tools/gelu_sass.py` counts (26; with
# erff, 32)
GELU_INSTRUCTIONS = 26
H100_FP32_INSTR = 33.5e12                    # fp32 instructions a second: 67 TFLOP/s counts an
                                             # fma as two


def ffn_bound(M, C, H):
    """(least ms, what bounds it) of K7: the two products' tensor flops, the
    erf-GELU's fp32 instructions (GELU_INSTRUCTIONS each of M H), or x and
    out through HBM with the weights read once."""
    t_tensor = 2 * 2 * M * C * H / H100_BF16
    t_gelu = M * H * GELU_INSTRUCTIONS / H100_FP32_INSTR
    t_bytes = (2 * M * C * 2 + 2 * C * H * 2 + (H + 3 * C) * 2) / H100_BYTES
    t_ops = max(t_tensor, t_gelu)
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def cuda_ms(fn, iters=20, warmup=3):
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


def graph_ms(fn, iters=20):
    """The device time of one call of fn without the host's: its launches
    captured once in a CUDA graph (after a warm-up on a side stream, so that
    every one-time set-up is done), the graph replayed."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(2):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    return cuda_ms(graph.replay, iters)


def bound_ms(flops, nbytes, peak=H100_BF16, exps=0, sfu=1.0):
    """(least ms, what bounds it): the tensor flops at `peak`, the exps at
    `sfu` a second, or the bytes at the HBM rate."""
    t_ops = max(flops / peak, exps / sfu)
    t_bytes = nbytes / H100_BYTES
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def sfu_rate():
    """exps a second: 16 a clock an SM x 132 SMs x the card's maximum SM clock."""
    import subprocess
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                          "--format=csv,noheader,nounits"], capture_output=True, text=True,
                         timeout=60)
    return SFU_PER_SM_CLOCK * H100_SMS * float(out.stdout.strip().splitlines()[0]) * 1e6


def gemm_plain(a, w, b, epi, r1=None, r2=None):
    """The product and epilogue in fp32 torch ops, rounded where gemm.cu's
    `store<EPI>` rounds."""
    import torch
    import torch.nn.functional as F
    bf = torch.bfloat16
    v = a.float() @ w.float().t() + b.float()
    if epi == "quickgelu":
        return (v * torch.sigmoid(1.702 * v)).to(bf)
    if epi == "gelu":
        return F.gelu(v).to(bf)
    if epi == "rgelu":
        return F.gelu(v.to(bf).float()).to(bf)
    if epi == "res2":
        return ((r1.float() + r2.float()).to(bf).float() + v.to(bf).float()).to(bf)
    return v.to(bf)


def gemm_cases(g):
    """[{row, fn, plain, library, flops, bound}] of csrc/gemm.cu's bf16 product
    at GEMM_SHAPES, inputs from the generator g on the card."""
    import torch
    import torch.nn.functional as F
    from stgcma_tpu_torch.ops import fused_attn as FA
    from stgcma_tpu_torch.ops import swin_block as SB
    bf, dev = torch.bfloat16, "cuda"
    epi_id = {"bf16": FA._EPI_BF16, "quickgelu": FA._EPI_BF16_QUICKGELU,
              "gelu": FA._EPI_BF16_GELU, "rgelu": FA._EPI_BF16_RGELU}
    cases = []
    for row, M, N, K, epi in GEMM_SHAPES:
        a = torch.randn(M, K, generator=g, device=dev).to(bf)
        w = (torch.randn(N, K, generator=g, device=dev) * K ** -0.5).to(bf)
        b = (torch.randn(N, generator=g, device=dev) * 0.1).to(bf)
        out = torch.empty(M, N, dtype=bf, device=dev)
        rs = ()
        if epi == "res2":
            rs = tuple(torch.randn(M, N, generator=g, device=dev).to(bf) for _ in range(2))

        def fn(a=a, w=w, b=b, out=out, epi=epi, rs=rs):
            s = torch.cuda.current_stream().cuda_stream
            if epi == "res2":
                return SB._gemm_res2(a, w, b, rs[0], rs[1], out, s)
            return FA._gemm_bf16(a, w, b, out, epi_id[epi], s)
        nbytes = 2 * (M * K + N * K + M * N * (1 + len(rs)))
        cases.append({"row": f"gemm.cu bf16 {row} {(M, N, K)}", "fn": fn,
                      "plain": lambda a=a, w=w, b=b, epi=epi, rs=rs: gemm_plain(a, w, b, epi, *rs),
                      "library": lambda a=a, w=w, b=b: F.linear(a, w, b),
                      "flops": 2 * M * N * K, "bound": bound_ms(2 * M * N * K, nbytes)})
    return cases


def s8_plain(a, sa, w, ws, b, epi):
    """The int8 product in float64 (exact for these sums), then gemm.cu's epilogue
    in fp32 torch ops, one rounding each: float(acc) * sa * ws + b, then bf16 or
    QuickGELU."""
    import torch
    acc = torch.matmul(a.double(), w.double().t()).float()
    v = acc * sa[:, None] * ws.float() + b.float()
    return v * torch.sigmoid(1.702 * v) if epi == "quickgelu" else v.to(torch.bfloat16)


def _digest(t):
    import torch
    return hashlib.sha256(t.contiguous().view(torch.uint8).cpu().numpy().tobytes()).hexdigest()


def s8_cases(g):
    """[{row, fn, plain, library, flops, bound, exact}] of csrc/gemm.cu's int8
    product at S8_SHAPES on random int8 codes, and of csrc/rowprep.cu's row
    quantization at K3's CLIP-B/16 video rows. `fn` calls the tree's
    `_gemm_s8` positionally, as both trees take it; the fp32 hidden gets its
    row maxima where the tree's `_gemm_s8` takes `amax`."""
    import torch
    import torch.nn.functional as F
    from stgcma_tpu_torch.ops import fused_attn as FA
    dev = "cuda"
    takes_amax = "amax" in inspect.signature(FA._gemm_s8).parameters
    cases = []
    for row, M, N, K, epi in S8_SHAPES:
        a = torch.randint(-127, 128, (M, K), generator=g, device=dev, dtype=torch.int8)
        w = torch.randint(-127, 128, (N, K), generator=g, device=dev, dtype=torch.int8)
        sa = torch.rand(M, generator=g, device=dev) * 0.02 + 1e-3
        ws = (torch.rand(N, generator=g, device=dev) * 0.002 + 1e-4).to(torch.bfloat16)
        b = (torch.randn(N, generator=g, device=dev) * 0.1).to(torch.bfloat16)
        f32 = epi == "quickgelu"
        out = torch.empty(M, N, dtype=torch.float32 if f32 else torch.bfloat16, device=dev)
        amax = torch.zeros(M, device=dev) if f32 and takes_amax else None
        epi_id = FA._EPI[FA._QUICK_GELU] if f32 else FA._EPI_Q_BF16

        def fn(a=a, sa=sa, w=w, ws=ws, b=b, out=out, epi_id=epi_id, amax=amax):
            s = torch.cuda.current_stream().cuda_stream
            if amax is None:
                FA._gemm_s8(a, sa, w, ws, b, out, epi_id, s)
            else:
                amax.zero_()
                FA._gemm_s8(a, sa, w, ws, b, out, epi_id, s, amax=amax)
            return out

        def library(a=a, sa=sa, w=w, ws=ws, b=b, f32=f32):
            v = torch._int_mm(a, w.t()).float() * sa[:, None] * ws.float() + b.float()
            return v * torch.sigmoid(1.702 * v) if f32 else v.to(torch.bfloat16)
        nbytes = M * K + N * K + M * N * out.element_size() + 4 * M + 4 * N
        cases.append({"row": f"gemm.cu int8 {row} {(M, N, K)}", "fn": fn, "amax": amax,
                      "plain": lambda a=a, sa=sa, w=w, ws=ws, b=b, epi=epi: s8_plain(
                          a, sa, w, ws, b, epi),
                      "library": library, "flops": 2 * M * N * K, "exact": not f32,
                      "bound": bound_ms(2 * M * N * K, nbytes, H100_INT8)})
    M, C, H = 15760, 768, 3072
    x = torch.randn(M, C, generator=g, device=dev).to(torch.bfloat16)
    lw = (1 + 0.1 * torch.randn(C, generator=g, device=dev)).to(torch.bfloat16)
    lb = (0.02 * torch.randn(C, generator=g, device=dev)).to(torch.bfloat16)
    h = torch.randn(M, H, generator=g, device=dev)
    hmax = h.abs().amax(-1)
    takes_given = "amax" in inspect.signature(FA._quant_rows).parameters

    def quant_plain(xf):
        q, sx = FA.quant_rows(xf)
        return q, sx.view(-1)

    def quant_hidden():
        s = torch.cuda.current_stream().cuda_stream
        return FA._quant_rows(h, s, amax=hmax) if takes_given else FA._quant_rows(h, s)

    def library_quant(xf, amax=None):
        """Row quantization from PyTorch's own calls (timed only)."""
        sx = (xf.abs().amax(-1) if amax is None else amax).clamp_min(1e-30) / 127
        return torch.round(xf / sx[:, None]).clamp(-127, 127).to(torch.int8), sx
    cases += [
        {"row": f"rowprep.cu LN + row quantization {(M, C)} bf16",
         "fn": lambda: FA._quant_rows(x, torch.cuda.current_stream().cuda_stream, lw, lb),
         "plain": lambda: quant_plain(FA._ln_f32(x, lw, lb)),
         "library": lambda: library_quant(F.layer_norm(x.float(), (C,), lw.float(), lb.float())),
         "bound": bound_ms(0, 2 * M * C + M * C + 4 * M)},
        {"row": f"rowprep.cu row quantization of the fp32 hidden {(M, H)}"
                f"{', given row maxima' if takes_given else ''}",
         "fn": quant_hidden, "plain": lambda: quant_plain(h),
         "library": lambda: library_quant(h, hmax),
         "bound": bound_ms(0, 4 * M * H + M * H + 8 * M)},
        {"row": f"rowprep.cu row quantization of the fp32 hidden {(M, H)}, own row maxima",
         "fn": lambda: FA._quant_rows(h, torch.cuda.current_stream().cuda_stream),
         "plain": lambda: quant_plain(h), "library": lambda: library_quant(h),
         "bound": bound_ms(0, 4 * M * H + M * H + 4 * M)}]
    return cases


def int8_block_cases(g):
    """K2 at the CLIP-B/16 video spatial (80, 197, 768) and temporal (1576,
    10, 768) sites and K3 (QuickGELU) at the video rows (15760, 768), weights
    N(0, 0.02^2) quantized per output channel, LN weights near 1; K11's
    spatial and FFN bodies at the same rows with an adapter of width 48; the
    int8 K12 at v (80, 197, 768), a (80, 49, 768) and K13 at the video rows
    (1576, 10, 768) on the int8 tower of `random_clip_ave` (block 0)."""
    import dataclasses
    import torch
    from stgcma_tpu_torch.configs import clip_b16
    from stgcma_tpu_torch.models.ave import random_clip_ave
    from stgcma_tpu_torch.ops import clip_block as PCB
    from stgcma_tpu_torch.ops import fused_attn as FA
    from stgcma_tpu_torch.ops.common import cast_tree
    from stgcma_tpu_torch.ops.quant import quantize_clip_tower, quantize_weight
    bf, dev, C, heads = torch.bfloat16, "cuda", 768, 12

    def rnd(*shape, std=1.0):
        return torch.randn(*shape, generator=g, device=dev) * std

    def qw(n, k):
        q, s = quantize_weight(rnd(n, k, std=0.02))
        return q, s.to(bf)
    ln = ((1 + rnd(C, std=0.1)).to(bf), rnd(C, std=0.02).to(bf))
    wqkv, wproj = qw(3 * C, C), qw(C, C)
    block = (*ln, *wqkv, rnd(3 * C, std=0.02).to(bf), *wproj, rnd(C, std=0.02).to(bf), heads)
    cases = []
    for site, Bq, N in (("video spatial", 80, 197), ("video temporal", 1576, 10)):
        x = rnd(Bq, N, C).to(bf)
        cases.append({"row": f"K2 CLIP-B/16 {site} {(Bq, N, C)} h{heads}",
                      "fn": lambda x=x: FA.win_block_q(x, *block),
                      "plain": lambda x=x: FA.win_block_q_plain(x, *block)})
    w1, w2 = qw(4 * C, C), qw(C, 4 * C)
    ffn = (*ln, *w1, rnd(4 * C, std=0.02).to(bf), *w2, rnd(C, std=0.02).to(bf), "quick_gelu")
    x = rnd(80 * 197, C).to(bf)
    cases.append({"row": f"K3 CLIP-B/16 video {tuple(x.shape)} QuickGELU",
                  "fn": lambda: FA.ffn_q(x, *ffn), "plain": lambda: FA.ffn_q_plain(x, *ffn)})
    ad = (rnd(48, C, std=C ** -0.5).to(bf), rnd(48, std=0.1).to(bf))
    xs = rnd(80, 197, C).to(bf)
    qh = block[:-1] + ad + (heads,)
    cases += [{"row": f"K11 qh CLIP-B/16 video spatial {tuple(xs.shape)} D 48",
               "fn": lambda: FA.win_block_qh(xs, *qh),
               "plain": lambda: FA.win_block_qh.plain(xs, *qh), "tol": TOL_Q},
              {"row": f"K11 ffn_qh CLIP-B/16 video {tuple(x.shape)} D 48",
               "fn": lambda: FA.ffn_qh(x, *ffn[:-1], *ad, "quick_gelu"),
               "plain": lambda: FA.ffn_qh_plain(x, *ffn[:-1], *ad, "quick_gelu"), "tol": TOL_Q}]
    cfg = clip_b16(ftmode="fusion", label_dim=29)
    bb = random_clip_ave(dataclasses.replace(cfg, layers=1), 0).backbone
    blk = cast_tree(quantize_clip_tower(bb).resblocks[0], bf).to(dev)
    w = PCB.block_weights(blk)
    v, a = (rnd(80, n, C, std=0.1).to(bf) for n in (197, 49))
    cases.append({"row": f"K12 int8 CLIP-B/16 v {tuple(v.shape)} a {tuple(a.shape)} h{heads}",
                  "fn": lambda: PCB.clip_fusion_block_q(v, a, w, heads),
                  "plain": lambda: PCB.fusion_block_q_plain(v, a, w, heads), "tol": TOL_Q})
    wt = PCB.tadapt_weights(blk.attn, blk.ln_1, blk.T_Adapter)
    xt = rnd(1576, 10, C, std=0.1).to(bf)
    cases.append({"row": f"K13 int8 CLIP-B/16 video rows {tuple(xt.shape)} h{heads}",
                  "fn": lambda xt=xt, wt=wt: PCB.clip_tadapt_q(xt, wt, heads),
                  "plain": lambda xt=xt, wt=wt: PCB.tadapt_q_plain(xt, wt, heads), "tol": TOL_Q})
    # the audio rows (M = 3920), where the launches' host work can exceed the kernels'
    for site, Bq, N in (("audio spatial", 80, 49), ("audio temporal", 392, 10)):
        xa = rnd(Bq, N, C).to(bf)
        cases.append({"row": f"K2 CLIP-B/16 {site} {(Bq, N, C)} h{heads}",
                      "fn": lambda xa=xa: FA.win_block_q(xa, *block),
                      "plain": lambda xa=xa: FA.win_block_q_plain(xa, *block)})
    xa = rnd(80, 49, C).to(bf)
    cases += [{"row": f"K3 CLIP-B/16 audio {(3920, C)} QuickGELU",
               "fn": lambda: FA.ffn_q(xa.view(-1, C), *ffn),
               "plain": lambda: FA.ffn_q_plain(xa.view(-1, C), *ffn)},
              {"row": f"K11 qh CLIP-B/16 audio spatial {tuple(xa.shape)} D 48",
               "fn": lambda: FA.win_block_qh(xa, *qh),
               "plain": lambda: FA.win_block_qh.plain(xa, *qh), "tol": TOL_Q}]
    xt = rnd(392, 10, C, std=0.1).to(bf)
    wt = PCB.tadapt_weights(blk.attn, blk.ln_1, blk.T_Adapter_Audio)
    cases.append({"row": f"K13 int8 CLIP-B/16 audio rows {tuple(xt.shape)} h{heads}",
                  "fn": lambda: PCB.clip_tadapt_q(xt, wt, heads),
                  "plain": lambda: PCB.tadapt_q_plain(xt, wt, heads), "tol": TOL_Q})
    for case in cases:
        case["graph"] = True
    return cases


def core_cases(g):
    """[{row, fn, plain, library, flops, bound}] of csrc/attn.cu's core over a
    packed qkv at CORE_SHAPES (plain: `_heads_attention`, the kernels'
    arithmetic; library: scaled_dot_product_attention)."""
    import torch
    import torch.nn.functional as F
    from stgcma_tpu_torch.ops import fused_attn as FA
    bf, dev = torch.bfloat16, "cuda"
    cases = []
    for row, B_, N, C, heads, with_bias in CORE_SHAPES:
        dh = C // heads
        qkv = torch.randn(B_, N, 3 * C, generator=g, device=dev).to(bf)
        bias = (torch.randn(1, heads, N, N, generator=g, device=dev) if with_bias else None)
        out = torch.empty(B_, N, C, dtype=bf, device=dev)

        def library(qkv=qkv, bias=bias, B_=B_, N=N, heads=heads, dh=dh):
            q, k, v = qkv.view(B_, N, 3, heads, dh).permute(2, 0, 3, 1, 4)
            mask = None if bias is None else bias.to(bf)
            return F.scaled_dot_product_attention(q, k, v, attn_mask=mask)
        flops = 4 * B_ * heads * N * N * dh
        nbytes = 2 * B_ * N * 4 * C + (0 if bias is None else 4 * heads * N * N)
        cases.append({
            "row": f"attn.cu core {row} {(B_, N, C)} h{heads}",
            "fn": lambda qkv=qkv, bias=bias, heads=heads, out=out: FA._attn_core(
                qkv, bias, heads, torch.cuda.current_stream().cuda_stream, out=out),
            "plain": lambda qkv=qkv, bias=bias, heads=heads: FA._heads_attention(
                qkv, heads, bias, bf),
            "library": library, "flops": flops, "bound": bound_ms(flops, nbytes)})
    return cases


def _k4_weights(g, C, D, int8):
    """A K4 block's weights on the card: LN near 1, the tower N(0, 0.02^2)
    (quantized per output channel for int8), live adapters drawn as
    chip_smoke.py's `live_k4_weights` draws them, gates 0.8 and -0.6."""
    import torch
    from stgcma_tpu_torch.ops import swin_block as SB
    from stgcma_tpu_torch.ops.quant import quantize_weight
    bf, dev = torch.bfloat16, "cuda"

    def rnd(*shape, std=1.0):
        return (torch.randn(*shape, generator=g, device=dev) * std).to(bf)
    w = {"ln1_w": 1 + rnd(C, std=0.1), "ln1_b": rnd(C, std=0.02), "ln2_w": 1 + rnd(C, std=0.1),
         "ln2_b": rnd(C, std=0.02), "gate_v": torch.full((1,), 0.8, dtype=bf, device=dev),
         "gate_a": torch.full((1,), -0.6, dtype=bf, device=dev)}
    for (wk, sk, bk), (n, k) in zip(SB.TOWER, ((3 * C, C), (C, C), (4 * C, C), (C, 4 * C))):
        wt = torch.randn(n, k, generator=g, device=dev) * 0.02
        w[bk] = rnd(n, std=0.02)
        if int8:
            q, sc = quantize_weight(wt)
            w[wk], w[sk] = q, sc.to(bf)
        else:
            w[wk] = wt.to(bf)
    std1 = 2.26 / C ** 0.5 * min(1.0, (32 / D) ** 0.25)
    for key, _ in SB.ADAPTERS:
        w.update({f"{key}_w1": rnd(D, C, std=std1), f"{key}_b1": rnd(D, std=0.1),
                  f"{key}_w2": rnd(C, D, std=0.566 / D ** 0.5), f"{key}_b2": rnd(C, std=0.1)})
    return w


def _k4_bias(g, H, ss, heads):
    """K4's (1, heads, H^2, H^2) bias on the card, a random relative-position
    table (std 0.02) gathered plus the window and shift mask of an (H, H) grid
    of 7 x 7 windows shifted by ss, and the grid's fusion mask."""
    import torch
    from stgcma_tpu_torch.ops import swin_block as SB
    from stgcma_tpu_torch.ops.attention import gather_bias
    index, attn_mask, fuse_mask = SB._geo_tensors(H, H, 7, ss, torch.device("cuda"))
    table = torch.randn(13 * 13, heads, generator=g, device="cuda") * 0.02
    bias = (gather_bias(table, index, heads, H * H) + attn_mask)[None].contiguous()
    return bias, fuse_mask


def swin_fuse_cases(g):
    """K4, K5, K6, K10 and K4's attention core at the Swin fusion shapes
    (module docstring), inputs from the generator g on the card."""
    import torch
    import torch.nn.functional as F
    from stgcma_tpu_torch.ops import fused_attn as FA
    from stgcma_tpu_torch.ops import swin_block as SB
    bf, dev, BT = torch.bfloat16, "cuda", 80
    sfu = sfu_rate()
    cases = []

    def rnd(*shape, std=1.0):
        return (torch.randn(*shape, generator=g, device=dev) * std).to(bf)

    # K4: (tag, C, heads, D, H, shift, int8, tol)
    for tag, C, heads, D, H, ss, int8, tol in (
            ("Swin-Base st.2", 512, 16, 32, 14, 0, False, TOL),
            ("Swin-Base st.2 shifted", 512, 16, 32, 14, 3, False, TOL),
            ("Swin-Base st.3", 1024, 32, 64, 7, 0, False, TOL),
            ("int8 Swin-Base st.2", 512, 16, 32, 14, 0, True, TOL_Q),
            ("int8 Swin-Base st.2 shifted", 512, 16, 32, 14, 3, True, TOL_Q),
            ("int8 Swin-Base st.3", 1024, 32, 64, 7, 0, True, TOL_Q),
            ("Swin-Large st.2", 768, 24, 96, 14, 0, False, TOL_Q)):
        N = H * H
        w = _k4_weights(g, C, D, int8)
        bias, fuse_mask = _k4_bias(g, H, ss, heads)
        v, a = rnd(BT, N, C, std=0.1), rnd(BT, N, C, std=0.1)
        args = (v, a, w, heads, bias, fuse_mask)
        kernel = SB.swin_block_q if int8 else SB.swin_block
        cases.append({"row": f"K4 {tag} {(BT, N, C)} h{heads} D {D}",
                      "fn": lambda kernel=kernel, args=args: kernel(*args),
                      "plain": lambda kernel=kernel, args=args: kernel.plain(*args),
                      "tol": tol, "graph": True})
    # K6, K5, K10: (row, kernel, (B, Nv, Na, D))
    gv = torch.full((1,), 0.8, dtype=bf, device=dev)
    ga = torch.full((1,), -0.6, dtype=bf, device=dev)
    for row, kernel, (B, Nv, Na, D) in (
            ("K6 Swin-Base st.0 full grid", FA.bidir_fuse, (BT, 3136, 3136, 16)),
            ("K6 Swin-Base st.1 full grid", FA.bidir_fuse, (BT, 784, 784, 32)),
            ("K6 Swin-Large st.0 full grid", FA.bidir_fuse, (BT, 3136, 3136, 96)),
            ("K6 Swin-Large st.1 full grid", FA.bidir_fuse, (BT, 784, 784, 96)),
            ("K5 Swin-Large st.0 windows", FA.win_fuse, (5120, 49, 49, 96)),
            ("K5 Swin-Large st.1 windows", FA.win_fuse, (1280, 49, 49, 96)),
            ("K10", FA.unscaled_attention, (BT, 1764, 1764, 16))):
        vh, ah = rnd(B, Nv, D, std=0.7), rnd(B, Na, D, std=0.7)
        if kernel is FA.unscaled_attention:
            vv = rnd(B, Na, D, std=0.7)
            args = (vh, ah, vv)
            lib = (lambda vh=vh, ah=ah, vv=vv:
                   F.scaled_dot_product_attention(vh, ah, vv, scale=1.0))
            flops, exps, nbytes = 4 * B * Nv * Na * D, B * Nv * Na, 2 * B * D * (2 * Nv + 2 * Na)
        else:
            args = (vh, ah, gv, ga)
            lib = (lambda vh=vh, ah=ah: (
                vh + gv * F.scaled_dot_product_attention(vh, ah, ah, scale=1.0),
                ah + ga * F.scaled_dot_product_attention(ah, vh, vh, scale=1.0)))
            flops, exps, nbytes = 6 * B * Nv * Na * D, B * Nv * Na, 4 * B * (Nv + Na) * D
        cases.append({"row": f"{row} {(B, Nv, D)}" + (f" ah {(B, Na, D)}" if Na != Nv else ""),
                      "fn": lambda kernel=kernel, args=args: kernel(*args),
                      "plain": lambda kernel=kernel, args=args: kernel.plain(*args),
                      "library": lib, "graph": True,
                      "bound": bound_ms(flops, nbytes, exps=exps, sfu=sfu)})
    return cases + k4_core_cases(g, sfu)


def k4_core_cases(g, sfu):
    """K4's attention core alone at Swin-Base stage 2 shifted, (160, 196, 512)
    h16 with its bias (relative positions + the window and shift mask): over
    the full grid (`_attn_core`) and, where the tree has it, over each
    window's 49 tokens (`_attn_core_win`); plain `_heads_attention` over the
    full grid with the bias (the same function), library SDPA with the bias
    as a float mask."""
    import torch
    import torch.nn.functional as F
    from stgcma_tpu_torch.ops import fused_attn as FA
    from stgcma_tpu_torch.ops import swin_block as SB
    bf, dev, BT = torch.bfloat16, "cuda", 80
    heads, C, H = 16, 512, 14
    N, dh, n = H * H, C // heads, 49
    bias, fuse_mask = _k4_bias(g, H, 3, heads)
    qkv = torch.randn(2 * BT, N, 3 * C, generator=g, device=dev).to(bf)

    def library():
        q, k, v = qkv.view(2 * BT, N, 3, heads, dh).permute(2, 0, 3, 1, 4)
        return F.scaled_dot_product_attention(q, k, v, attn_mask=bias.to(bf))
    windows = [("full grid", N * N)]
    if hasattr(FA, "_attn_core_win"):
        windows.append(("in-window", N * n))
    cases = []
    for tag, entries in windows:
        if tag == "in-window":
            win_table = SB._window_table_of(fuse_mask)
            fn = lambda: FA._attn_core_win(qkv, bias, win_table, heads,  # noqa: E731
                                           torch.cuda.current_stream().cuda_stream)
        else:
            fn = lambda: FA._attn_core(qkv, bias, heads,  # noqa: E731
                                       torch.cuda.current_stream().cuda_stream)
        flops = 4 * 2 * BT * heads * entries * dh
        nbytes = 2 * 2 * BT * N * 4 * C + 4 * heads * entries
        cases.append({"row": f"K4 core Swin-Base st.2 shifted {tag} {(2 * BT, N, C)} h{heads}",
                      "fn": fn, "plain": lambda: FA._heads_attention(qkv, heads, bias, bf),
                      "library": library, "flops": flops, "graph": True,
                      "bound": bound_ms(flops, nbytes, exps=2 * BT * heads * entries, sfu=sfu)})
    return cases


def block_cases(g):
    """K1 at the CLIP-B/16 video spatial site and at CLIP-L/14's 257 tokens,
    K12 (bf16) at CLIP-B/16's v and a rows: the towers of `random_clip_ave`
    (block 0), inputs at std 0.1."""
    import dataclasses
    import torch
    from stgcma_tpu_torch.configs import clip_b16, clip_l14
    from stgcma_tpu_torch.models.ave import random_clip_ave
    from stgcma_tpu_torch.ops import clip_block as PCB
    from stgcma_tpu_torch.ops import fused_attn as FA
    from stgcma_tpu_torch.ops.common import cast_tree
    bf, dev = torch.bfloat16, "cuda"
    cases = []
    for tag, cfg in (("CLIP-B/16", clip_b16(ftmode="fusion", label_dim=29)),
                     ("CLIP-L/14", clip_l14(ftmode="fusion", label_dim=29))):
        blk = cast_tree(random_clip_ave(dataclasses.replace(cfg, layers=1), 0)
                        .backbone.resblocks[0], bf).to(dev)
        w = PCB.block_weights(blk)
        C, heads, BT = cfg.embed_dim, cfg.heads, 8 * cfg.num_frames
        Nv, Na = cfg.num_patches + 1, cfg.num_patches_audio + 1
        v = (torch.randn(BT, Nv, C, generator=g, device=dev) * 0.1).to(bf)
        args = (v, w["ln1_w"], w["ln1_b"], w["w_qkv"], w["b_qkv"], w["w_proj"], w["b_proj"],
                heads)
        cases.append({"row": f"K1 {tag} video spatial {(BT, Nv, C)} h{heads}",
                      "fn": lambda args=args: FA.win_block(*args),
                      "plain": lambda args=args: FA.win_block_plain(*args)})
        if tag == "CLIP-B/16":
            a = (torch.randn(BT, Na, C, generator=g, device=dev) * 0.1).to(bf)
            cases.append({"row": f"K12 {tag} v {(BT, Nv, C)} a {(BT, Na, C)} h{heads}",
                          "fn": lambda v=v, a=a, w=w, h=heads: PCB.clip_fusion_block(v, a, w, h),
                          "plain": lambda v=v, a=a, w=w, h=heads: PCB.fusion_block_plain(
                              v, a, w, h)})
    return cases


def tadapt_cases(g, sfu):
    """K13 (float) at the CLIP-B/16 video (1576, 10, 768) and audio (392, 10,
    768) rows and at CLIP-L/14's video rows (2056, 10, 1024), K14 (float and
    int8) at the CLIP-B/16 video and audio rows of the tower's layout, and
    K11's temporal body (int8, D 48) at the CLIP-B/16 video and audio rows,
    on block 0 of `random_clip_ave` (the int8 K13 rows and K11's other
    bodies are `int8_block_cases`'); where the tree has them, csrc/tattn.cu's
    temporal product T alone (bf16 and int8 at the video rows: qkv and each
    sequence's attention, the merged heads out; and at K14's frame-strided
    layout) and csrc/rowadapt.cu's row-owning product R alone (K13's: proj,
    the T_Adapter and the residual, bf16; K14's, its residual rounded once;
    K11 qd's: the int8 proj and the adapter hidden; K11 ffn_qh's: the int8
    fc2 at K = 3072 with o and the hidden), each with its bound and a
    library yardstick (`F.linear` / `torch._int_mm` and SDPA)."""
    import dataclasses
    import torch
    import torch.nn.functional as F
    from stgcma_tpu_torch.configs import clip_b16, clip_l14
    from stgcma_tpu_torch.models.ave import random_clip_ave
    from stgcma_tpu_torch.ops import clip_block as PCB
    from stgcma_tpu_torch.ops import fused_attn as FA
    from stgcma_tpu_torch.ops.common import cast_tree
    from stgcma_tpu_torch.ops.quant import quantize_clip_tower
    bf, dev, T = torch.bfloat16, "cuda", 10

    def rnd(*shape, std=1.0):
        return torch.randn(*shape, generator=g, device=dev) * std

    def block(cfg, int8=False):
        bb = random_clip_ave(dataclasses.replace(cfg, layers=1), 0).backbone
        return cast_tree((quantize_clip_tower(bb) if int8 else bb).resblocks[0], bf).to(dev)
    cases = []
    b16, l14 = clip_b16(ftmode="fusion", label_dim=29), clip_l14(ftmode="fusion", label_dim=29)
    for tag, cfg, sites in (("CLIP-B/16", b16, (("video", 1576), ("audio", 392))),
                            ("CLIP-L/14", l14, (("video", 2056),))):
        blk = block(cfg)
        for site, R in sites:
            ad = blk.T_Adapter if site == "video" else blk.T_Adapter_Audio
            wt = PCB.tadapt_weights(blk.attn, blk.ln_1, ad)
            x = rnd(R, T, cfg.embed_dim, std=0.1).to(bf)
            cases.append({"row": f"K13 {tag} {site} rows {tuple(x.shape)} h{cfg.heads}",
                          "fn": lambda x=x, wt=wt, h=cfg.heads: PCB.clip_tadapt(x, wt, h),
                          "plain": lambda x=x, wt=wt, h=cfg.heads: PCB.tadapt_plain(x, wt, h),
                          "graph": True})
    C, heads, D = b16.embed_dim, b16.heads, 48
    q = block(b16, int8=True)
    for int8, blk in ((False, block(b16)), (True, q)):    # K14 in the tower's (B T, N, C) layout
        kernel = PCB.clip_tv2_q if int8 else PCB.clip_tv2
        for site, N in (("video", b16.num_patches + 1), ("audio", b16.num_patches_audio + 1)):
            ad = blk.T_Adapter if site == "video" else blk.T_Adapter_Audio
            wt = PCB.tadapt_weights(blk.attn, blk.ln_1, ad)
            x = rnd(8 * T, N, C, std=0.1).to(bf)
            cases.append({"row": f"K14{' int8' if int8 else ''} CLIP-B/16 {site} rows "
                                 f"{tuple(x.shape)} h{heads}",
                          "fn": lambda x=x, wt=wt, k=kernel: k(x, wt, heads, T),
                          "plain": lambda x=x, wt=wt, k=kernel: k.plain(x, wt, heads, T),
                          "tol": TOL_Q if int8 else TOL, "graph": True})
    qd = (q.ln_1.weight, q.ln_1.bias, q.attn.in_proj.weight_q, q.attn.in_proj.weight_s,
          q.attn.in_proj.bias, q.attn.out_proj.weight_q, q.attn.out_proj.weight_s,
          q.attn.out_proj.bias, rnd(D, C, std=C ** -0.5).to(bf), rnd(D, std=0.1).to(bf), heads)
    for site, R in (("video", 1576), ("audio", 392)):
        x = rnd(R, T, C).to(bf)
        cases.append({"row": f"K11 qd CLIP-B/16 {site} temporal {tuple(x.shape)} D {D}",
                      "fn": lambda x=x: FA.win_block_qd(x, *qd),
                      "plain": lambda x=x: FA.win_block_qd.plain(x, *qd), "tol": TOL_Q,
                      "graph": True})
    if not hasattr(FA, "_tattn"):
        return cases
    # T and R alone at the CLIP-B/16 video rows, M = 15760
    R, M = 1576, 1576 * T

    def cur():               # the stream at call time (a CUDA graph captures on its own)
        return torch.cuda.current_stream().cuda_stream
    fb = block(b16)
    w = PCB.tadapt_weights(fb.attn, fb.ln_1, fb.T_Adapter)
    wq = PCB.tadapt_weights(q.attn, q.ln_1, q.T_Adapter)
    a = rnd(M, C).to(bf)
    codes = torch.randint(-127, 128, (M, C), generator=g, device=dev, dtype=torch.int8)
    sa = rnd(M).abs() * 0.02 + 1e-3
    att = torch.empty(M, C, dtype=bf, device=dev)

    def attend(qkv):
        return FA._heads_attention(qkv.view(R, T, 3 * C), heads, None, bf).view(M, C)

    def sdpa(qkv):
        qq, kk, vv = qkv.view(R, T, 3, heads, C // heads).permute(2, 0, 3, 1, 4)
        return F.scaled_dot_product_attention(qq, kk, vv)

    def deq(a8, s8, w8, ws8, b8):
        """The int8 product from PyTorch's own calls: `torch._int_mm`, the
        fp32 dequant and bias, bf16 (timed only)."""
        return (torch._int_mm(a8, w8.t()).float() * s8[:, None] * ws8.float()
                + b8.float()).to(bf)
    grams = 4 * R * T * T * C
    t_bytes = 2 * (2 * M * C + 3 * C * C)
    cases += [
        {"row": f"tattn.cu T bf16 CLIP-B/16 video rows ({M}, {3 * C}, {C}) h{heads}",
         "fn": lambda: FA._tattn(a, None, w["w_qkv"], None, w["b_qkv"], att, T, heads, cur()),
         "plain": lambda: attend(gemm_plain(a, w["w_qkv"], w["b_qkv"], "bf16")),
         "library": lambda: sdpa(F.linear(a, w["w_qkv"], w["b_qkv"])),
         "flops": 2 * M * 3 * C * C + grams, "graph": True,
         "bound": bound_ms(2 * M * 3 * C * C + grams, t_bytes, exps=R * heads * T * T,
                           sfu=sfu)},
        {"row": f"tattn.cu T int8 CLIP-B/16 video rows ({M}, {3 * C}, {C}) h{heads}",
         "fn": lambda: FA._tattn(codes, sa, wq["w_qkv"], wq["s_qkv"], wq["b_qkv"], att, T, heads,
                                 cur()),
         "plain": lambda: attend(s8_plain(codes, sa, wq["w_qkv"], wq["s_qkv"], wq["b_qkv"],
                                          "bf16")),
         "library": lambda: sdpa(deq(codes, sa, wq["w_qkv"], wq["s_qkv"], wq["b_qkv"])),
         "tol": TOL_Q, "graph": True,
         "bound": max(bound_ms(2 * M * 3 * C * C, 3 * M * C + 3 * C * C + 4 * M,
                               peak=H100_INT8, exps=R * heads * T * T, sfu=sfu),
                      bound_ms(grams, 0))}]
    wd, bd, w2, b2 = w["ad_w1"], w["ad_b1"], w["ad_w2"], w["ad_b2"]
    x, y = rnd(M, C, std=0.1).to(bf), torch.empty(M, C, dtype=bf, device=dev)
    h = torch.empty(M, D, dtype=bf, device=dev)

    def r():
        FA._rowadapt(a, None, w["w_proj"], None, w["b_proj"], wd, bd, FA._EPI_BF16_RGELU, cur(),
                     up=(w2, b2, x, y))
        return y

    def r_plain():
        o = gemm_plain(a, w["w_proj"], w["b_proj"], "bf16")
        hid = gemm_plain(o, wd, bd, "rgelu")
        return (x.float() + gemm_plain(hid, w2, b2, "bf16").float()).to(bf)

    def r_library():
        o = F.linear(a, w["w_proj"], w["b_proj"])
        return x + F.linear(F.gelu(F.linear(o, wd, bd)), w2, b2)

    def rq():
        FA._rowadapt(codes, sa, wq["w_proj"], wq["s_proj"], wq["b_proj"], qd[8], qd[9],
                     FA._EPI_BF16_GELU, cur(), h=h)
        return h

    def rq_plain():
        o = s8_plain(codes, sa, wq["w_proj"], wq["s_proj"], wq["b_proj"], "bf16")
        return F.gelu(o.float() @ qd[8].float().t() + qd[9].float()).to(bf)
    codes4 = torch.randint(-127, 128, (M, 4 * C), generator=g, device=dev, dtype=torch.int8)
    w2q = q.mlp.c_proj                      # fc2: int8 (C, 4C) with its scales
    o4 = torch.empty(M, C, dtype=bf, device=dev)

    def rf():
        FA._rowadapt(codes4, sa, w2q.weight_q, w2q.weight_s, w2q.bias, qd[8], qd[9],
                     FA._EPI_BF16_GELU, cur(), out=o4, h=h)
        return o4, h

    def rf_plain():
        o = s8_plain(codes4, sa, w2q.weight_q, w2q.weight_s, w2q.bias, "bf16")
        return o, F.gelu(o.float() @ qd[8].float().t() + qd[9].float()).to(bf)
    r_flops = 2 * M * C * C + 4 * M * C * D
    cases += [
        {"row": f"rowadapt.cu R bf16 K13 CLIP-B/16 video rows ({M}, {C}, {C}) D {D}",
         "fn": r, "plain": r_plain, "library": r_library, "flops": r_flops, "graph": True,
         "bound": bound_ms(r_flops, 2 * (3 * M * C + C * C + 2 * C * D))},
        {"row": f"rowadapt.cu R int8 K11 qd CLIP-B/16 video rows ({M}, {C}, {C}) D {D}",
         "fn": rq, "plain": rq_plain, "tol": TOL_Q, "graph": True,
         "library": lambda: F.gelu(F.linear(deq(codes, sa, wq["w_proj"], wq["s_proj"],
                                                wq["b_proj"]), qd[8], qd[9])),
         "bound": max(bound_ms(2 * M * C * C, M * C + C * C + 2 * M * D + 4 * M, peak=H100_INT8),
                      bound_ms(2 * M * C * D, 0))},
        {"row": f"rowadapt.cu R int8 K11 ffn_qh fc2 CLIP-B/16 video ({M}, {C}, {4 * C}) D {D}",
         "fn": rf, "plain": rf_plain, "tol": TOL_Q, "graph": True,
         "library": lambda: (lambda o: (o, F.gelu(F.linear(o, qd[8], qd[9]))))(
             deq(codes4, sa, w2q.weight_q, w2q.weight_s, w2q.bias)),
         "bound": max(bound_ms(2 * M * C * 4 * C, 4 * M * C + 4 * C * C + 2 * M * (C + D) + 4 * M,
                               peak=H100_INT8), bound_ms(2 * M * C * D, 0))}]
    if "tokens" not in inspect.signature(FA._tattn).parameters:
        return cases
    # K14's: T over frame-strided tiles of the tower's (B T, N, C) layout at the
    # CLIP-B/16 video rows (B = 8, N = 197: M = 15760), and R with K14's rounding
    B, N = 8, 197

    def attend_v2(qkv):
        qkv = qkv.view(B, T, N, 3 * C).transpose(1, 2).reshape(B * N, T, 3 * C)
        o = FA._heads_attention(qkv, heads, None, bf)
        return o.view(B, N, T, C).transpose(1, 2).reshape(M, C)

    def sdpa_v2(qkv):
        qq, kk, vv = qkv.view(B, T, N, 3, heads, C // heads).permute(3, 0, 2, 4, 1, 5)
        return F.scaled_dot_product_attention(*(t.reshape(B * N, heads, T, -1)
                                                for t in (qq, kk, vv)))

    def rv2():
        FA._rowadapt(a, None, w["w_proj"], None, w["b_proj"], wd, bd, FA._EPI_BF16_GELU, cur(),
                     up=(w2, b2, x, y), up_epi=FA._EPI_BF16_RESF)
        return y

    def rv2_plain():
        hid = gemm_plain(gemm_plain(a, w["w_proj"], w["b_proj"], "bf16"), wd, bd, "gelu")
        return (x.float() + (hid.float() @ w2.float().t() + b2.float())).to(bf)
    cases += [
        {"row": f"tattn.cu T bf16 K14 CLIP-B/16 video rows ({M}, {3 * C}, {C}) h{heads} N {N}",
         "fn": lambda: FA._tattn(a, None, w["w_qkv"], None, w["b_qkv"], att, T, heads, cur(),
                                 tokens=N),
         "plain": lambda: attend_v2(gemm_plain(a, w["w_qkv"], w["b_qkv"], "bf16")),
         "library": lambda: sdpa_v2(F.linear(a, w["w_qkv"], w["b_qkv"])),
         "flops": 2 * M * 3 * C * C + grams, "graph": True,
         "bound": bound_ms(2 * M * 3 * C * C + grams, t_bytes, exps=R * heads * T * T,
                           sfu=sfu)},
        {"row": f"tattn.cu T int8 K14 CLIP-B/16 video rows ({M}, {3 * C}, {C}) h{heads} N {N}",
         "fn": lambda: FA._tattn(codes, sa, wq["w_qkv"], wq["s_qkv"], wq["b_qkv"], att, T, heads,
                                 cur(), tokens=N),
         "plain": lambda: attend_v2(s8_plain(codes, sa, wq["w_qkv"], wq["s_qkv"], wq["b_qkv"],
                                             "bf16")),
         "library": lambda: sdpa_v2(deq(codes, sa, wq["w_qkv"], wq["s_qkv"], wq["b_qkv"])),
         "tol": TOL_Q, "graph": True,
         "bound": max(bound_ms(2 * M * 3 * C * C, 3 * M * C + 3 * C * C + 4 * M,
                               peak=H100_INT8, exps=R * heads * T * T, sfu=sfu),
                      bound_ms(grams, 0))},
        {"row": f"rowadapt.cu R bf16 K14 (RESF) CLIP-B/16 video rows ({M}, {C}, {C}) D {D}",
         "fn": rv2, "plain": rv2_plain, "library": r_library, "flops": r_flops, "graph": True,
         "bound": bound_ms(r_flops, 2 * (3 * M * C + C * C + 2 * C * D))}]
    return cases


def ffn_cases(g):
    """K7 at FFN_SHAPES: x N(0, 1), LN weights near 1, W1 N(0, 0.05^2), W2
    N(0, 0.02^2); plain `ffn_plain`, library F.layer_norm, F.linear, F.gelu,
    F.linear; each with `graph_ms`."""
    import torch
    import torch.nn.functional as F
    from stgcma_tpu_torch.ops import fused_attn as FA
    bf, dev = torch.bfloat16, "cuda"

    def rnd(*shape, std=1.0):
        return torch.randn(*shape, generator=g, device=dev) * std
    cases = []
    for row, M, C in FFN_SHAPES:
        H = 4 * C
        args = (rnd(M, C).to(bf), (1 + rnd(C, std=0.1)).to(bf), rnd(C, std=0.02).to(bf),
                rnd(H, C, std=0.05).to(bf), rnd(H, std=0.02).to(bf), rnd(C, H, std=0.02).to(bf),
                rnd(C, std=0.02).to(bf))

        def library(a=args, C=C):
            return F.linear(F.gelu(F.linear(F.layer_norm(a[0], (C,), a[1], a[2]), a[3], a[4])),
                            a[5], a[6])
        cases.append({"row": f"K7 {row} FFN {(M, C)} hidden {H}",
                      "fn": lambda a=args: FA.ffn(*a), "plain": lambda a=args: FA.ffn_plain(*a),
                      "library": library, "graph": True, "flops": 4 * M * C * H,
                      "bound": ffn_bound(M, C, H)})
    return cases


def _wmsa_site(FA, qkv, bm, heads):
    """K8's site from the packed qkv to merged heads: `wmsa_qkv` where the tree
    has it, else the copies around `wmsa` that `_qkv_core` made (q scaled, q,
    k, v made contiguous, heads merged back)."""
    import torch
    if hasattr(FA, "wmsa_qkv"):
        return FA.wmsa_qkv(qkv, bm, heads)
    B_, N, C3 = qkv.shape
    C = C3 // 3
    dh = C // heads
    t = qkv.reshape(B_, N, 3, heads, dh).permute(2, 0, 3, 1, 4)
    q = t[0] * torch.tensor(dh ** -0.5, dtype=qkv.dtype)
    q, k, v = (x.reshape(B_ * heads, N, dh).contiguous() for x in (q, t[1], t[2]))
    out = FA.wmsa(q, k, v, bm)
    return out.reshape(B_, heads, N, dh).transpose(1, 2).reshape(B_, N, C)


def small_core_cases(g):
    """csrc/attn.cu's small core (N <= 64) alone at SMALL_CORE_SHAPES
    (`_attn_core` over a packed qkv, the bias (period, heads, N, N) N(0, 1)
    where the site has one), and K8's whole site at Swin-Base stage 3 from the
    packed qkv to merged heads (`_wmsa_site`), each against `_heads_attention`
    / `wmsa_qkv_plain`'s arithmetic, with SDPA as the yardstick and
    `graph_ms`."""
    import torch
    import torch.nn.functional as F
    from stgcma_tpu_torch.ops import fused_attn as FA
    bf, dev = torch.bfloat16, "cuda"
    cases = []
    for row, B_, N, C, heads, period in SMALL_CORE_SHAPES:
        dh = C // heads
        qkv = torch.randn(B_, N, 3 * C, generator=g, device=dev).to(bf)
        bias = (None if period is None
                else torch.randn(period, heads, N, N, generator=g, device=dev))

        def library(qkv=qkv, bias=bias, B_=B_, N=N, heads=heads, dh=dh, P=period):
            if bias is None:
                q, k, v = qkv.view(B_, N, 3, heads, dh).permute(2, 0, 3, 1, 4)
                return F.scaled_dot_product_attention(q, k, v)
            q, k, v = qkv.view(B_ // P, P, N, 3, heads, dh).permute(3, 0, 1, 4, 2, 5)
            return F.scaled_dot_product_attention(q, k, v, attn_mask=bias.to(bf))
        flops = 4 * B_ * heads * N * N * dh
        nbytes = 2 * B_ * N * 4 * C + (0 if bias is None else 4 * bias.numel())
        cases.append({
            "row": f"attn.cu small core {row} {(B_, N, C)} h{heads}",
            "fn": lambda qkv=qkv, bias=bias, heads=heads: FA._attn_core(
                qkv, bias, heads, torch.cuda.current_stream().cuda_stream),
            "plain": lambda qkv=qkv, bias=bias, heads=heads: FA._heads_attention(
                qkv, heads, bias, bf),
            "library": library, "flops": flops, "graph": True, "bound": bound_ms(flops, nbytes)})
        if row.startswith("K8"):
            bm = bias.view(-1, N, N)
            cases.append({
                "row": f"K8 site {row[3:]} packed qkv -> merged heads {(B_, N, C)} h{heads}",
                "fn": lambda qkv=qkv, bm=bm, heads=heads: _wmsa_site(FA, qkv, bm, heads),
                "plain": lambda qkv=qkv, bm=bm, heads=heads: _wmsa_site_plain(FA, qkv, bm, heads),
                "library": library, "flops": flops, "graph": True,
                "bound": bound_ms(flops, nbytes)})
    return cases


def _wmsa_site_plain(FA, qkv, bm, heads):
    """`_wmsa_site` through the plain `wmsa` (`wmsa_qkv_plain`'s arithmetic, in
    either tree)."""
    import torch
    B_, N, C3 = qkv.shape
    C = C3 // 3
    dh = C // heads
    t = qkv.reshape(B_, N, 3, heads, dh).permute(2, 0, 3, 1, 4)
    q = t[0] * torch.tensor(dh ** -0.5, dtype=qkv.dtype)
    q, k, v = (x.reshape(B_ * heads, N, dh) for x in (q, t[1], t[2]))
    out = FA.wmsa_plain(q, k, v, bm)
    return out.reshape(B_, heads, N, dh).transpose(1, 2).reshape(B_, N, C)


def host_cases(g):
    """Short kernels timed through their wrapper and through the bare
    launcher (ctypes, no checks): K8 at Swin-Base stage 3's temporal site
    (12544, 10, 32), period 32, and K9 at Swin-Base's norms at B = 8: the
    patch embed (250880, 128), the merges 0 -> 1 (62720, 512), 1 -> 2
    (15680, 1024), 2 -> 3 (3920, 2048), stage 3's temporal and final norms
    (3920, 1024), and Swin-Large's patch embed (250880, 192) and 2 -> 3
    merge (3920, 3072). Where the wrapper's time exceeds the bare launch's,
    the host's Python, not the kernel, sets the row's time; `graph_ms` is
    the device's alone."""
    import torch
    from stgcma_tpu_torch.ops import cuda_lib
    from stgcma_tpu_torch.ops import fused_attn as FA
    bf, dev = torch.bfloat16, "cuda"
    R, n, dh, P = 12544, 10, 32, 32
    q, k, v = (torch.randn(R, n, dh, generator=g, device=dev).to(bf) for _ in range(3))
    bm = torch.randn(P, n, n, generator=g, device=dev)
    o = torch.empty_like(q)

    def bare_k8():
        cuda_lib.lib("attn.cu").stg_attn_qkv(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                             bm.data_ptr(), P, o.data_ptr(), R, n, dh,
                                             torch.cuda.current_stream().cuda_stream)
        return o

    def k9(name, M, C):
        x = torch.randn(M, C, generator=g, device=dev).to(bf)
        lw, lb = torch.ones(C, device=dev, dtype=bf), torch.zeros(C, device=dev, dtype=bf)
        y = torch.empty_like(x)

        def bare():
            cuda_lib.lib("rowprep.cu").stg_ln_bf16(x.data_ptr(), lw.data_ptr(), lb.data_ptr(),
                                                   y.data_ptr(), M, C, 1e-5,
                                                   torch.cuda.current_stream().cuda_stream)
            return y
        return {"row": f"K9 {name} {(M, C)}", "fn": lambda: FA.layernorm(x, lw, lb),
                "bare": bare, "graph": True, "plain": lambda: FA.layernorm_plain(x, lw, lb)}
    return [{"row": f"K8 Swin stage 3 temporal {(R, n, dh)} period {P}",
             "fn": lambda: FA.wmsa(q, k, v, bm), "bare": bare_k8, "graph": True,
             "plain": lambda: FA.wmsa_plain(q, k, v, bm)},
            k9("patch-embed norm", 250880, 128), k9("merge norm 0->1", 62720, 512),
            k9("merge norm 1->2", 15680, 1024), k9("merge norm 2->3", 3920, 2048),
            k9("stage-3 temporal / final norm", 3920, 1024),
            k9("Swin-Large patch-embed norm", 250880, 192),
            k9("Swin-Large merge norm 2->3", 3920, 3072)]


def _flat(out):
    import torch
    outs = out if isinstance(out, tuple) else (out,)
    return torch.cat([o.float().flatten() for o in outs])


def held(case):
    """max |kernel - plain| / max |plain| of one case (its kernel on the card);
    inf where the kernel's output is not finite or, for an int8 product with
    row maxima, where they are not the stored hidden's."""
    import torch
    out = _flat(case["fn"]())
    torch.cuda.synchronize()
    ref = _flat(case["plain"]())
    if not torch.isfinite(out).all():
        return float("inf")
    if case.get("amax") is not None and not torch.equal(
            case["amax"], case["fn"]().abs().amax(-1)):
        return float("inf")
    return (out - ref).abs().max().item() / ref.abs().max().item()


def same_bits(out_dir, label, rows):
    """{other label: True if every int8 product row of this run has the digest
    of the same row in OUT/<other label>.json}."""
    digests = {r["row"]: r["digest"] for r in rows if "digest" in r}
    verdict = {}
    for f in sorted(Path(out_dir).glob("*.json")):
        if f.stem == label:
            continue
        other = {r["row"]: r.get("digest") for r in json.loads(f.read_text())}
        verdict[f.stem] = all(other.get(row) == d for row, d in digests.items())
    return verdict


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", default=str(Path(__file__).resolve().parents[2]),
                    help="checkout whose stgcma_tpu_torch is timed")
    ap.add_argument("--label", default="change")
    ap.add_argument("--out", default="chiprun_out/bench_parts")
    ap.add_argument("--only", default="",
                    help="comma-separated substrings: only the rows whose name holds one")
    args = ap.parse_args(argv)
    sys.path.insert(0, os.path.abspath(args.tree))
    import torch
    if not torch.cuda.is_available():
        print("bench_parts: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    from stgcma_tpu_torch.ops import cuda_lib
    cuda_lib.build()
    g = torch.Generator(device="cuda").manual_seed(0)
    rows, ok = [], True
    with torch.inference_mode():
        only = [o for o in args.only.split(",") if o]
        for case in (gemm_cases(g) + s8_cases(g) + core_cases(g) + block_cases(g)
                     + int8_block_cases(g) + tadapt_cases(g, sfu_rate()) + host_cases(g)
                     + swin_fuse_cases(g) + ffn_cases(g) + small_core_cases(g)):
            if only and not any(o in case["row"] for o in only):
                continue
            err = held(case)
            tol = case.get("tol", 0.0 if case.get("exact") else TOL_S8_F32 if "amax" in case
                           else TOL)
            ms = cuda_ms(case["fn"])
            row = {"label": args.label, "row": case["row"], "ms": ms, "rel_err": err, "tol": tol,
                   "plain_ms": cuda_ms(case["plain"], iters=3, warmup=1)}
            if "amax" in case:
                row["digest"] = _digest(case["fn"]())
            if "bare" in case:
                row["bare_ms"] = cuda_ms(case["bare"])
            if case.get("graph"):
                try:
                    row["graph_ms"] = graph_ms(case["fn"])
                except RuntimeError as e:    # a measurement only: the row stands without it
                    row["graph_error"] = str(e)[:200]
            if "bound" in case:
                row["bound_ms"], row["bound_by"] = case["bound"]
            if "flops" in case:
                row["tflops"] = case["flops"] / ms / 1e9
            if "library" in case:
                row["library_ms"] = cuda_ms(case["library"])
            ok &= err <= tol
            rows.append(row)
            print(json.dumps(row), flush=True)
            del case
    Path(args.out).mkdir(parents=True, exist_ok=True)
    (Path(args.out) / f"{args.label}.json").write_text(json.dumps(rows, indent=1))
    if not ok:
        print("bench_parts: a row is not held to its plain version", file=sys.stderr)
    verdict = same_bits(args.out, args.label, rows)
    print(json.dumps({"label": args.label, "int8_products_same_bits_as": verdict}), flush=True)
    if not all(verdict.values()):
        print("bench_parts: an int8 product differs in its bits from another run's",
              file=sys.stderr)
        ok = False
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
