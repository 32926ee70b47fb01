"""The two parts that K1-K4, K7 and K11-K14 share, alone on the card, and
the K1 and K12 rows that carry them.

    python3 stgcma_tpu_torch/tools/bench_parts.py [--tree DIR] [--label NAME]
        [--out chiprun_out/bench_parts]

Rows, at B = 8 of the main path (AVE-29 CLIP ViT-B/16 fusion) unless named:
- csrc/gemm.cu's bf16 product at the tower's shapes: qkv (15760, 2304, 768),
  proj (15760, 768, 768), fc1 with QuickGELU (19680, 3072, 768) and fc2
  (19680, 768, 3072) over both streams as K12 runs them, the adapter
  products at N = 48 (erf-GELU of the rounded hidden) and K = 48 (onto two
  residuals), and Swin-Base stage 0's FFN fc1 at K = 128 (250880, 512, 128);
- csrc/attn.cu's attention core over a packed qkv: (80, 197, 768) h12,
  (80, 257, 1024) h16 (CLIP ViT-L/14), (160, 196, 512) h16 with a
  (1, 16, 196, 196) bias (K4 at Swin-Base stage 2) and (16, 1000, 768) h12,
  past the resident limit (the streamed kernel);
- K1 at the CLIP-B/16 video spatial site (80, 197, 768) and at CLIP-L/14's
  (80, 257, 1024) h16, and K12 (bf16) at v (80, 197, 768), a (80, 49, 768);
- K8 at Swin-Base stage 3's temporal site and K9 at its 2 -> 3 merge norm,
  each also through its bare launcher (`bare_ms`): what the wrapper's host
  work adds to a short kernel.

Each row is first held against its plain PyTorch version (max |kernel -
plain| <= 2e-2 max |plain|; the script exits 1 if one is not), then timed
with CUDA events (the mean of 20 calls after 3). With --tree the package is
imported from another checkout, e.g. an earlier commit unpacked with `git
archive` into a directory .gitignore lists, so that two versions run in one
chip call in turns (each builds its own kernels). Prints one JSON object a
row and writes them to OUT/LABEL.json. Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
from pathlib import Path

TOL = 2e-2
H100_BF16, H100_BYTES = 989e12, 3.35e12      # dense peak and HBM rate, 700 W
# (row, M, N, K, epilogue): epilogue of csrc/gemm.cu, "res2" through stg_gemm_bf16_res2
GEMM_SHAPES = (("qkv", 15760, 2304, 768, "bf16"), ("proj", 15760, 768, 768, "bf16"),
               ("fc1 QuickGELU", 19680, 3072, 768, "quickgelu"), ("fc2", 19680, 768, 3072, "bf16"),
               ("adapter fc1 N=48", 15760, 48, 768, "rgelu"),
               ("adapter fc2 K=48", 15760, 768, 48, "res2"),
               ("Swin st.0 fc1 K=128", 250880, 512, 128, "gelu"))
# (row, B_, N, C, heads, bias)
CORE_SHAPES = (("CLIP-B/16 spatial", 80, 197, 768, 12, False),
               ("CLIP-L/14 spatial", 80, 257, 1024, 16, False),
               ("Swin-Base st.2 K4 grid, bias", 160, 196, 512, 16, True),
               ("streamed", 16, 1000, 768, 12, False))


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


def bound_ms(flops, nbytes):
    t_ops, t_bytes = flops / H100_BF16, nbytes / H100_BYTES
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


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


def host_cases(g):
    """Two short kernels timed through their wrapper and through the bare
    launcher (ctypes, no checks): K8 at Swin-Base stage 3's temporal site
    (12544, 10, 32), period 32, and K9 at the 2 -> 3 patch merge (3920, 2048).
    Where the wrapper's time exceeds the bare launch's, the host's Python,
    not the kernel, sets the row's time."""
    import torch
    from stgcma_tpu_torch.ops import cuda_lib
    from stgcma_tpu_torch.ops import fused_attn as FA
    bf, dev = torch.bfloat16, "cuda"
    R, n, dh, P = 12544, 10, 32, 32
    q, k, v = (torch.randn(R, n, dh, generator=g, device=dev).to(bf) for _ in range(3))
    bm = torch.randn(P, n, n, generator=g, device=dev)
    o = torch.empty_like(q)
    M, C = 3920, 2048
    x = torch.randn(M, C, generator=g, device=dev).to(bf)
    lw, lb = torch.ones(C, device=dev, dtype=bf), torch.zeros(C, device=dev, dtype=bf)
    y = torch.empty_like(x)

    def bare_k8():
        cuda_lib.lib("attn.cu").stg_attn_qkv(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                             bm.data_ptr(), P, o.data_ptr(), R, n, dh,
                                             torch.cuda.current_stream().cuda_stream)
        return o

    def bare_k9():
        cuda_lib.lib("rowprep.cu").stg_ln_bf16(x.data_ptr(), lw.data_ptr(), lb.data_ptr(),
                                               y.data_ptr(), M, C, 1e-5,
                                               torch.cuda.current_stream().cuda_stream)
        return y
    return [{"row": f"K8 Swin stage 3 temporal {(R, n, dh)} period {P}",
             "fn": lambda: FA.wmsa(q, k, v, bm), "bare": bare_k8,
             "plain": lambda: FA.wmsa_plain(q, k, v, bm)},
            {"row": f"K9 merge norm 2->3 {(M, C)}", "fn": lambda: FA.layernorm(x, lw, lb),
             "bare": bare_k9, "plain": lambda: FA.layernorm_plain(x, lw, lb)}]


def _flat(out):
    import torch
    outs = out if isinstance(out, tuple) else (out,)
    return torch.cat([o.float().flatten() for o in outs])


def held(case):
    """max |kernel - plain| / max |plain| of one case (its kernel on the card)."""
    import torch
    out = _flat(case["fn"]())
    torch.cuda.synchronize()
    ref = _flat(case["plain"]())
    if not torch.isfinite(out).all():
        return float("inf")
    return (out - ref).abs().max().item() / ref.abs().max().item()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", default=str(Path(__file__).resolve().parents[2]),
                    help="checkout whose stgcma_tpu_torch is timed")
    ap.add_argument("--label", default="change")
    ap.add_argument("--out", default="chiprun_out/bench_parts")
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
        for case in gemm_cases(g) + core_cases(g) + block_cases(g) + host_cases(g):
            err = held(case)
            ms = cuda_ms(case["fn"])
            row = {"label": args.label, "row": case["row"], "ms": ms, "rel_err": err}
            if "bare" in case:
                row["bare_ms"] = cuda_ms(case["bare"])
            if "flops" in case:
                row["tflops"] = case["flops"] / ms / 1e9
                row["bound_ms"], row["bound_by"] = case["bound"]
                row["library_ms"] = cuda_ms(case["library"])
            ok &= err <= TOL
            rows.append(row)
            print(json.dumps(row), flush=True)
            del case
    Path(args.out).mkdir(parents=True, exist_ok=True)
    (Path(args.out) / f"{args.label}.json").write_text(json.dumps(rows, indent=1))
    if not ok:
        print(f"bench_parts: a row is past {TOL} of max |plain|", file=sys.stderr)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
