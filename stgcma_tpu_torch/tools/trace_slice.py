"""Where the time of one serving forward goes on the card.

    python3 -m stgcma_tpu_torch.tools.trace_slice [--model clip|swin|swin-fusion|avs|avqa]
        [--int8] [--preset swin_base|swin_large|clip_b16|clip_l14] [--fused] [--qfuse] [--tv2]
        [--seed 0] [--out DIR]

Serves AVE-29 through the port's MultiTaskServer at full width, random
seeded weights: `clip` (default) is CLIP ViT-B/16 in fusion mode (ViT-L/14
with `--preset clip_l14`), bf16 and int8 towers; `swin` is Swin-Base in
multimodal mode; `swin-fusion` is Swin-Base in fusion mode (the STG-CMA
exchange), or Swin-Large with `--preset swin_large`; the Swin models serve a
bf16 tower, or with `--int8` the tower made int8 by `quantize_swin_tower`.
`avs` serves AVSBench segmentation (`add_avs`): Swin-Large fusion (or
Swin-Base with `--preset swin_base`) at T = 5 frames with its multi-scale
taps, TPAVI and the FPN decoder, bf16. `avqa` serves MUSIC-AVQA
(`add_avqa`): Swin-Large fusion (or Swin-Base) at T = 10 frames with the
question LSTM, grounding and QA attention, bf16 or with `--int8`; its
request carries v_nega, which the server leaves on the host. For `avqa` it
also traces the tower with v_nega (the three-output forward of training)
and each stage (`swin.stage_apply`) over the fused pair and over the
triple, so that the nega stream's device time splits by stage.
With `--fused` the CLIP model also serves
both towers in the fused-block configuration (STGCMA_CLIP_TADAPT_FUSED=1 and
STGCMA_CLIP_WHOLE_BLOCK=1: K13 twice and K12 once a block); with `--qfuse`
it also serves the int8 tower with the adapter-fused kernels
(STGCMA_QFUSE_ADAPTERS=1: K11 at the six sites of a block); with `--tv2` it
also serves both towers with the transpose-free temporal stage
(STGCMA_TV2=1: K14 at the two temporal sites of a block) and lists each
task's copy kernels by name, the layout copies of the temporal transposes
among them, which K14 does without. With `--fused` or `--qfuse` each task's
library kernels (cuBLAS, cuDNN, PyTorch's attention) are listed by name: in
the fused configuration only the embed's convolutions and the head's two
linears remain, whatever the depth. For each task it
prints the median wall time of 5 untraced B = 8 requests, then traces
one request with torch.profiler and prints its wall (the `serve.request`
span), the device time of the work it launched (and without the
host-to-device copies of the inputs), the share of its wall that covers
(the rest is the device idle, waiting on the host), the request's device
time split by the port's spans into the copy in (`serve.copy_in`), the
tower (`model.tower`), the head (`model.head`) and the copy out
(`serve.copy_out`), and the kernels that took the most device time. The
Chrome trace of each mode is written to DIR (default build/trace). Needs a
CUDA device.
"""
from __future__ import annotations

import argparse
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from ..configs import AVQAHeadConfig, AVSHeadConfig, clip_b16, clip_l14, swin_base, swin_large
from ..models.ave import random_clip_ave, random_swin_ave
from ..models.avqa import random_avqa
from ..models.avs import random_avs
from ..nn import swin
from ..ops.quant import quantize_clip_tower
from ..serving import MultiTaskServer

B, REQUESTS = 8, 5
CLIP_SWITCHES = ("STGCMA_CLIP_TADAPT_FUSED", "STGCMA_CLIP_WHOLE_BLOCK")
QFUSE = "STGCMA_QFUSE_ADAPTERS"
TV2 = "STGCMA_TV2"
# kernel-name fragments of PyTorch's copy kernels (`.contiguous()` of a transposed view, cat)
COPY_KERNELS = ("copy", "cat")
# kernel-name fragments of library kernels: cuBLAS/CUTLASS GEMMs, cuDNN, PyTorch's attention
LIBRARY_KERNELS = ("cublas", "nvjet", "cutlass", "cudnn", "xmma", "gemm", "gemv", "fmha",
                   "flash", "attention", "convolve", "nchwtonhwc", "nhwctonchw", "nhwcaddpadding")
# kernel-name fragments of the port's own kernels (stgcma_tpu_torch/csrc/)
PORT_KERNELS = ("gemm_wgmma_kernel", "attn_small_kernel", "attn_resident_kernel",
                "attn_stream_kernel", "quant_rows_kernel", "ln_rows_kernel", "fuse_kernel",
                "pair_kernel", "tattn_kernel", "rowadapt_kernel", "ffn_kernel")
# the request's spans (`serving.py::MultiTaskServer.predict`, `models/*.py`)
SPLIT = ("serve.copy_in", "model.tower", "model.head", "serve.copy_out")
SPANS = ("serve.", "model.")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--model", choices=("clip", "swin", "swin-fusion", "avs", "avqa"),
                    default="clip")
    ap.add_argument("--int8", action="store_true", help="serve the Swin tower in int8")
    ap.add_argument("--preset", choices=("swin_base", "swin_large", "clip_b16", "clip_l14"),
                    default=None, help="the model's preset (clip_b16, swin_base; avs and avqa: "
                                       "swin_large)")
    ap.add_argument("--fused", action="store_true",
                    help="also serve the CLIP model in the fused-block configuration")
    ap.add_argument("--qfuse", action="store_true",
                    help="also serve the CLIP int8 tower with the adapter-fused kernels (K11)")
    ap.add_argument("--tv2", action="store_true",
                    help="also serve the CLIP model with the transpose-free temporal stage (K14)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default="build/trace")
    args = ap.parse_args(argv)
    if args.int8 and args.model in ("clip", "avs"):
        ap.error("--int8 takes a Swin AVE or the AVQA model (clip serves its bf16 and int8 "
                 "towers already)")
    preset = args.preset or {"clip": "clip_b16", "avs": "swin_large",
                             "avqa": "swin_large"}.get(args.model, "swin_base")
    if preset.startswith("clip") != (args.model == "clip"):
        ap.error(f"--preset {preset} does not fit --model {args.model}")
    if (args.fused or args.qfuse or args.tv2) and args.model != "clip":
        ap.error("--fused, --qfuse and --tv2 take the CLIP model")
    if not torch.cuda.is_available():
        print("trace_slice: no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    srv = MultiTaskServer(device="cuda")
    rng = np.random.RandomState(args.seed)
    make = {"swin_base": swin_base, "swin_large": swin_large, "clip_b16": clip_b16,
            "clip_l14": clip_l14}[preset]
    avs = avqa = None
    if args.model == "avqa":
        cfg = make(ftmode="fusion", num_frames=10)
        hcfg = AVQAHeadConfig(feat_dim=cfg.num_features, grid=7, num_frames=cfg.num_frames)
        task = f"avqa_{preset}_fusion_{'int8' if args.int8 else 'bf16'}"
        srv.add_avqa(task, cfg, hcfg, random_avqa(cfg, hcfg, args.seed, int8=args.int8))
        avqa = cfg
        n, T = cfg.img_size, cfg.num_frames
        batch = {"a": rng.randn(B, T, n, n).astype(np.float32),
                 "v": rng.randn(B, T, n, n, 3).astype(np.float32),
                 "v_nega": rng.randn(B, T, n, n, 3).astype(np.float32),
                 "question": rng.randint(0, hcfg.vocab_size, (B, 14)).astype(np.int64)}
    elif args.model == "avs":
        cfg = make(ftmode="fusion", num_frames=5)
        hcfg = AVSHeadConfig(stage_dims=tuple(cfg.stage_dim(i) for i in range(cfg.num_layers)),
                             audio_dim=cfg.num_features, num_frames=cfg.num_frames)
        model = random_avs(cfg, hcfg, args.seed)
        srv.add_avs(f"avs_{preset}_fusion_bf16", cfg, hcfg, model)
        avs = cfg
        n = cfg.img_size
        batch = {"a": rng.randn(B, cfg.num_frames, n, n).astype(np.float32),
                 "v": rng.randn(B, cfg.num_frames, n, n, 3).astype(np.float32)}
    elif args.model in ("swin", "swin-fusion"):
        ftmode = "multimodal" if args.model == "swin" else "fusion"
        cfg = make(ftmode=ftmode, label_dim=29)
        srv.add_ave(f"{preset}_{ftmode}_{'int8' if args.int8 else 'bf16'}", cfg,
                    random_swin_ave(cfg, args.seed, int8=args.int8))
        n = cfg.img_size
        batch = {"a": rng.randn(B, cfg.num_frames, n, n).astype(np.float32),
                 "v": rng.randn(B, cfg.num_frames, n, n, 3).astype(np.float32)}
    else:
        cfg = make(ftmode="fusion", label_dim=29)
        model = random_clip_ave(cfg, args.seed)
        model_q = random_clip_ave(cfg, args.seed)
        model_q.backbone = quantize_clip_tower(model_q.backbone)
        srv.add_clip_ave("bf16", cfg, model)
        srv.add_clip_ave("int8", cfg, model_q)
        if args.fused:                  # the switches are read at call time
            srv.add_clip_ave("fused_bf16", cfg, model)
            srv.add_clip_ave("fused_int8", cfg, model_q)
        if args.qfuse:
            srv.add_clip_ave("qfuse_int8", cfg, model_q)
        if args.tv2:
            srv.add_clip_ave("tv2_bf16", cfg, model)
            srv.add_clip_ave("tv2_int8", cfg, model_q)
        batch = {"a": rng.randn(B, cfg.num_frames, cfg.audio_tdim,
                                cfg.audio_fdim).astype(np.float32),
                 "v": rng.randn(B, cfg.num_frames, cfg.input_resolution,
                                cfg.input_resolution, 3).astype(np.float32)}
    os.makedirs(args.out, exist_ok=True)
    print(f"card: {smi}; B={B}, seed {args.seed}")
    for task in srv.tasks():
        for k in CLIP_SWITCHES:
            os.environ[k] = "1" if task.startswith("fused_") else "0"
        os.environ[QFUSE] = "1" if task.startswith("qfuse_") else "0"
        os.environ[TV2] = "1" if task.startswith("tv2_") else "0"
        srv.predict(task, batch)                          # warm-up
        walls = []
        for _ in range(REQUESTS):
            t0 = time.perf_counter()
            srv.predict(task, batch)
            walls.append(time.perf_counter() - t0)
        wall = statistics.median(walls)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            srv.predict(task, batch)
        prof.export_chrome_trace(os.path.join(args.out, f"{task}.json"))
        avg = prof.key_averages()
        # device-side rows only (kernels, copies): the CPU ops' rows repeat them
        rows = [e for e in avg if e.device_type == DeviceType.CUDA and not e.key.startswith(SPANS)]
        # a span's device time: the work launched inside it, its children's too
        span = {e.key: e for e in avg if e.device_type == DeviceType.CPU and e.key.startswith(SPANS)}
        req = span["serve.request"]
        dev_us, req_us = req.device_time_total, req.cpu_time_total
        h2d_us = sum(e.self_device_time_total for e in rows if "HtoD" in e.key)
        port = [e for e in rows if any(k in e.key for k in PORT_KERNELS)]
        port_us = sum(e.self_device_time_total for e in port)
        library = [e for e in rows if e not in port
                   and any(k in e.key.lower() for k in LIBRARY_KERNELS)]
        print(f"[{task}] untraced request: median {wall * 1e3:.2f} ms of {len(walls)} "
              f"(min {min(walls) * 1e3:.2f}, max {max(walls) * 1e3:.2f}) = "
              f"{B / wall:.2f} clips/s")
        print(f"[{task}] traced request: {req_us / 1e3:.2f} ms, device time {dev_us / 1e3:.2f} "
              f"ms = {100 * dev_us / req_us:.1f}% of it, "
              f"{(dev_us - h2d_us) / 1e3:.2f} ms without the host-to-device copies; "
              f"port kernels {port_us / 1e3:.2f} ms ({100 * port_us / max(dev_us, 1):.1f}% "
              f"of device time)")
        print(f"[{task}] split of its device time: " + ", ".join(
            f"{k} {span[k].device_time_total / 1e3:.3f} ms" for k in SPLIT if k in span))
        if args.fused or args.qfuse:
            print(f"[{task}] library kernels: {sum(e.count for e in library)} launches, "
                  f"{sum(e.self_device_time_total for e in library) / 1e3:.3f} ms: "
                  + "; ".join(f"x{e.count} {e.key[:60]}" for e in library))
        if args.tv2:
            copies = [e for e in rows if any(k in e.key.lower() for k in COPY_KERNELS)]
            print(f"[{task}] copy kernels: {sum(e.count for e in copies)} launches, "
                  f"{sum(e.self_device_time_total for e in copies) / 1e3:.3f} ms: "
                  + "; ".join(f"x{e.count} {e.self_device_time_total / 1e3:.3f} ms {e.key[:80]}"
                              for e in copies))
        for e in sorted(rows, key=lambda e: -e.self_device_time_total)[:20]:
            print(f"    {e.self_device_time_total / 1e3:9.3f} ms  x{e.count:<5d} "
                  f"{e.key[:110]}")
        if avs is not None:
            print(f"[{task}] {B * avs.num_ttokens / wall:.2f} masks/s untraced ({B} clips of "
                  f"{avs.num_ttokens} frames)")
        if avqa is not None:
            a, v = (torch.as_tensor(batch[k]).to("cuda", torch.bfloat16) for k in ("a", "v"))
            trace_nega_stages(task, avqa, srv.models[task], a, v, batch, args.out)
    return 0


def _device_rows(fn, path):
    """The device-side rows (kernels, copies) of one traced call of fn, and
    the call's result."""
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        out = fn()
        torch.cuda.synchronize()
    prof.export_chrome_trace(path)
    return [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA], out


def trace_nega_stages(task, cfg, model, a, v, batch, out_dir):
    """The device time of the tower with and without the nega stream, and of
    each stage (`swin.stage_apply`, its blocks and merge) over the fused pair
    and over the triple: the nega stream's time is the difference."""
    bb, statics = model.backbone, swin.backbone_statics(cfg)
    vn = torch.as_tensor(batch["v_nega"]).to("cuda", torch.bfloat16)
    path = os.path.join(out_dir, f"{task}_stage.json")

    def device_ms(fn):
        fn()                                              # warm-up
        return sum(e.self_device_time_total for e in _device_rows(fn, path)[0]) / 1e3
    with torch.inference_mode():
        two = device_ms(lambda: swin.backbone_apply(bb, cfg, a=a, v=v))
        three = device_ms(lambda: swin.backbone_apply(bb, cfg, a=a, v=v, v_nega=vn))
        pair = (swin.patch_embed_apply(bb.patch_embed, v, cfg),
                swin.patch_embed_apply(bb.patch_embed_audio, a[..., None], cfg))
        triple = pair + (swin.patch_embed_apply(bb.patch_embed, vn, cfg),)
        by_stage = []
        for s in range(cfg.num_layers):
            by_stage.append([device_ms(lambda s=s, x=x: swin.stage_apply(bb, cfg, statics, s, x))
                             for x in (pair, triple)])
            pair, triple = (swin.stage_apply(bb, cfg, statics, s, x)[1] for x in (pair, triple))
    print(f"[{task}] the three-output tower (with v_nega) {three:.2f} ms of device time against "
          f"{two:.2f} ms: {three / two:.3f}x; by stage (blocks and merge), the fused pair / the "
          f"triple / the nega stream's share of one fused stream: "
          + "; ".join(f"{p:.2f} / {t:.2f} / {2 * (t - p) / p:.2f}" for p, t in by_stage))


if __name__ == "__main__":
    sys.exit(main())
