#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (stgcma_tpu_torch) once on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one or more lines each; any failure exits non-zero before the last
line:
  1. environment: torch and CUDA versions, the card's name and power limit;
  2. build: nvcc builds the kernels of stgcma_tpu_torch/csrc/ (in parallel);
  3. kernels against their plain PyTorch versions on the card, at the B = 8
     shapes of the paths, with the stated tolerance, each timed beside its
     bound and a yardstick composed of PyTorch's own calls: K1 (bf16
     attention block), K2 (its int8 twin) and K3 (int8 FFN) at the CLIP
     sites; K1 at the Swin window sites (with their bias and shift mask) and
     temporal sites, K7 (bf16 FFN: csrc/ffn.cu, one launch a call, counted)
     at Swin-Base's and Swin-Large's stage 0-1 FFNs and Swin-Base 168^2's stage 0
     (a tail row block), with two faults at stage 0 (its last hidden chunk
     skipped, b1 dropped), and at Swin-Large's stage 2 FFN at B = 9 (C = 768,
     where the route first sends it to K7: K9 + gemm.cu's fc1 and fc2, three
     launches a call, counted), K8 (window-attention core, small and blocked bias,
     and as the Swin sites run it, `wmsa_qkv` from the packed qkv, one launch
     of the small core a call, with its fault: every head's bias read at head
     0) and K9 (LayerNorm) at the Swin sites (K9 also at
     Swin-Large's, with each row's device time alone); K4 (the whole Swin
     fusion block, with live adapters and gates, and once more with each of
     its wiring faults, which must fail the check) at stages 2 (shifted and
     unshifted) and 3, K5 (per-window fusion) and K6 (full-grid fusion) at
     stages 0 and 1, and K6 at one odd shape (Nv != Na, neither a multiple
     of the kernel's 64-row tile); for the int8 Swin tower, K2 at the five
     Swin sites (stage 0-1 shifted windows, stage 0-2 temporal), K3 with
     erf-GELU at the stage 0-1 FFNs and K4's int8 variant (live adapters and
     gates, and its five wiring faults) at stages 2 and 3; for the fused CLIP
     block, K12 (everything after the temporal stage of a CLIP fusion block,
     float and int8, live adapters and gates, and its five wiring faults) at
     v (80, 197, 768) / a (80, 49, 768) and K13 (the temporal stage with a
     live T_Adapter, float and int8) at the video and audio rows; K11's three
     int8 adapter-fused bodies at the CLIP sites (the hidden-only temporal
     body at (1576 / 392, 10, 768), the spatial body at (80, 197 / 49, 768),
     the FFN body at (15760 / 3920, 768)), each with a live adapter and once
     more with each of its two wiring faults (the S and MLP adapters swapped,
     the hidden taken before the GELU); K13 and K11 run on csrc/tattn.cu's
     temporal product T (qkv with each sequence's attention in its
     epilogue) and csrc/rowadapt.cu's row-owning product R (the last tower
     product with the adapter on the same rows), each call making exactly
     LAUNCHES_PER_CALL launches (counted at the launchers), and K13 at the
     video rows and K11's temporal body at the video rows once more with
     each of T's two wiring faults (the attention over the whole 128-row
     tile instead of each sequence; q of head h paired with k and v of head
     h + 1), which must fail the check; for the repairs of the larger
     presets, K1 and K2 at CLIP ViT-L/14's 257 tokens (80, 257, 1024) h16,
     K12 and K13, float and int8, at the ViT-L/14 shapes (v (80, 257, 1024),
     a (80, 64, 1024), D 64), and K5, K6 and K4 at Swin-Large's adapter width
     96 (K5 (5120 / 1280, 49, 96), K6 (80, 3136 / 784, 96), K4 at stage 2
     (80, 196, 768) h24 and stage 3 (80, 49, 1536) h48); K14 (the temporal
     stage in the tower's own layout, on T over frame-strided tiles and R
     with its own rounding of the residual, LAUNCHES_PER_CALL a call), float
     and int8, at the CLIP-B/16 video and audio rows (80, 197 / 49, 768), T
     = 10, with a live T_Adapter and, at the video rows, its three wiring
     faults (T over token-contiguous tiles, the T_Adapter skipped, R's
     residual rounded twice), float at the CLIP-L/14 video rows (80, 257,
     1024) and with a (16, 10, 10) bias and no adapter at (80, 196, 512) h16
     (the earlier composition); K10 (unscaled attention)
     through the K10 route of the full-grid fusion at K6's odd shape and at
     the stage grids of Swin-Base cut to 168^2 ((80, 1764, 16), (80, 441,
     32)), with its fault (the dh^-1/2 scale applied); at the shapes the
     AVS path adds (Swin-Large fusion, T = 5 frames, 40 a stream): K1 at the
     stage 0-1 temporal sites (25088, 5, 192) h6 and (6272, 5, 384) h12,
     the K8 site at the stage 2-3 temporal sites (1568, 5, 3 x 768) h24 and
     (392, 5, 3 x 1536) h48, K6 at (40, 3136, 96) and K4 at stage 2
     (shifted) over 40 frames with its wiring faults; at the shapes the
     AVQA paths add (Swin-Large fusion, T = 10, 80 frames a stream;
     `phase_avqa_kernels`): the K8 site at the nega stream's windows
     (stage 2 shifted (320, 49, 3 x 768) h24, bias period 96 with the shift
     mask; stage 3 (80, 49, 3 x 1536) h48, period 48) with its fault, K1 at
     the stage 0-1 shifted windows and T = 10 temporal sites, and the int8
     Swin-Large tower: K2 at the same four sites, K3 with erf-GELU at the
     stage 0-1 FFNs and at the nega stream's stage 2-3 FFNs (15680 / 3920
     rows of C = 768 / 1536), K4's int8 variant at D = 96 (stage 2 shifted
     and unshifted; stage 3 held by F5's bar, the kernel and its bf16 plain
     version each against the block in fp32) with its five wiring faults, and `int8_matmul`
     at the stage 2-3 qkv and proj around the K8 site; for the int8 CLIP
     ViT-L/14 tower (`phase_l14_int8_kernels`), K2 at the video and audio
     temporal sites (2056 / 512, 10, 1024) and the audio spatial site (80,
     64, 1024) h16, K3 with QuickGELU at (20560 / 5120, 1024); and the two parts
     those kernels share, alone (stgcma_tpu_torch/tools/bench_parts.py):
     csrc/gemm.cu's bf16 product (TMA + wgmma) at the main path's qkv,
     proj, fc1 with QuickGELU and fc2 (K = 3072) shapes, the adapter
     products at N = 48 and K = 48, each with its
     TFLOP/s and F.linear as the yardstick, and csrc/attn.cu's attention
     core at (80, 197, 768) h12, (80, 257, 1024) h16 and K4's (160, 196,
     512) h16 with a bias (K and V resident in shared memory) and at
     (16, 1000, 768) h12 (past the resident limit: the streamed kernel),
     with scaled_dot_product_attention as the yardstick, and K4's core over
     (160, 196, 512) h16 with its shifted-window bias once more over each
     window's 49 tokens (the core K4 runs); and csrc/gemm.cu's
     int8 product (the same TMA + wgmma loop, s8 k32) at K2's and K3's
     CLIP-B/16 video shapes (qkv, proj, fc1 with the fp32 QuickGELU hidden
     and its row maxima, fc2 at K = 3072) and Swin's K = 128 qkv, each with
     its TOP/s and torch._int_mm as the yardstick (the bf16-epilogue rows
     must equal their plain version bit for bit), and csrc/rowprep.cu's
     one-read row quantization of the LN rows and of the fp32 hidden from
     its given row maxima, listed under K2 and K3;
  4. slices, each driven through MultiTaskServer(device="cuda") with random
     seeded weights, a few B = 8 requests, the launch counts of every kernel
     per forward, and clips/s:
     - AVE-29 with CLIP ViT-B/16 in fusion mode at full width (12 layers,
       C = 768, T = 10 frames at 224^2, 102x128 fbank audio), a bf16 and an
       int8 task, the same two models in the fused-block configuration
       (STGCMA_CLIP_TADAPT_FUSED=1 and STGCMA_CLIP_WHOLE_BLOCK=1: K13 twice
       and K12 once a block, no K1-K3), and the int8 model with the
       adapter-fused kernels (`ave29_clip_qfuse_int8`,
       STGCMA_QFUSE_ADAPTERS=1: K11 at the six sites of a block, no K2 or
       K3), and both towers with the transpose-free temporal stage
       (`ave29_clip_tv2_bf16` / `_int8`, STGCMA_TV2=1: K14 at the two
       temporal sites of a block); the B = 8 logits of the last five are held
       against the default configuration's on the card; every model runs
       with live adapters and
       gates, the B = 1 logits are held against the same model on the CPU
       (plain versions), and zeroing the gates must move the card's logits;
       one `multimodal` bf16 task at depth 2;
     - AVE-29 with CLIP ViT-L/14 in fusion mode at full width and depth (24
       layers, C = 1024, 257 video and 64 audio tokens), bf16 and with the
       int8 tower, each in the default and the fused-block configuration,
       fused held against default on the card, B = 1 against the CPU at
       depth 2 (the plain versions' forward at full depth costs more than
       the rest of the script);
     - AVE-29 with Swin-Base at full width and depth (depths 2/2/18/2, C =
       128..1024, T = 10 frames at 224^2, 224x224 fbank audio), bf16, in
       multimodal mode (no fusion) and in fusion mode (the STG-CMA exchange),
       and in fusion mode with the int8 tower (`quantize_swin_tower`), B = 1
       against the CPU; and Swin-Large fusion bf16 at full width and depth
       (C = 192..1536, adapter width 96 at every stage, 24 and 48 heads at
       stages 2-3), B = 1 against the CPU at depths 2/2/2/2; and Swin-Base
       fusion bf16 cut to 168^2 and depths 2/2 (`ave29_swin_k10_bf16`), whose
       stage grids of 42^2 and 21^2 tokens take the full-grid fusion's K10
       route, B = 1 against the CPU. The fusion models run with live fusion
       adapters and gates, and zeroing the gates must move the card's B = 1
       logits beyond the tolerance; Swin-Base `videoonly` and `audioonly`
       (one stream, LayerNorm then the plain MLP at every FFN: K1, K8 and
       K9 only) at full width and depth, B = 1 against the CPU;
     - AVSBench segmentation (`add_avs`) on Swin-Large fusion at full width
       and depth, T = 5 frames, B = 8 clips: the tower with its multi-scale
       taps, TPAVI at the four stages and the FPN decoder, mask logits
       (40, 224, 224, 1), exact launches of the tower, clips/s and masks/s;
       B = 1 against the CPU at depths 2/2/2/2; zeroing the fusion gates, and
       separately every TPAVI BatchNorm scale, must move the card's masks
       beyond the tolerance;
     - MUSIC-AVQA (`add_avqa`) on Swin-Large fusion at full width and depth,
       T = 10 frames, B = 8 requests {a, v, v_nega, question}, bf16 and with
       the int8 tower: answer logits (8, 42), exact launches of the
       two-stream tower (the server computes out_qa alone, as the JAX
       server's compiled program does: no nega stream, no match MLP; the
       head launches none of the port's kernels), clips/s, the head's tanh
       inputs live; B = 1 against the CPU at depths 2/2/2/2; zeroing the
       fusion gates must move out_qa; on the same served models the
       three-output forward (`apply_avqa`: the nega stream and both match
       heads) with exactly `launches_per_forward(nega=True)`, new negative
       frames moving out_match_nega alone (out_qa and out_match_posi bit
       for bit), and its three outputs at B = 1 against the CPU at depths
       2/2/2/2;
     - the stream (`phase_stream`): CLIP ViT-B/16 fusion at full width and
       depth built through `load_pretrained_clip` from a random OpenAI-layout
       visual state dict (`proj` dropped) over live adapters, gates and head,
       bf16 and with the int8 tower quantized after the load; 2B + 3
       requests of 10 s 16 kHz WAVs (tones with seeded noise, written to a
       temporary directory) and uint8 frames (10, 256, 256, 3) through
       `serve_stream` at batch_size B (`HostDecoder`: native where `make -C
       native` builds, scipy otherwise; the host batch pinned; the fbank and
       the frame transforms on the card): ids complete and in order, the
       tail padded and dropped, launches = forwards x launches_per_forward,
       the tail request against the CPU pipeline and the CPU model; the
       AVE, AVQA and AVS pipelines on the card against the CPU (fbank 1e-3,
       frames 1e-5); the H2D bytes and ms of the stream's copy against
       `predict`'s float copy; streamed and `predict` clips/s; a second task
       on the same frozen tower (`share_frozen_tower`: every frozen leaf
       shares storage, the logits do not move);
     - training (`phase_train`): AVE-29 on CLIP ViT-B/16 fusion at full width
       (12 layers, C = 768, T = 10), B = TRAIN_B = 2, bf16 compute with fp32
       masters. Gradient rows (`grad_row`: the kernel through
       `fused_attn._Recompute`, its forward held to its plain version at the
       kernel's bar, the backward launching nothing; the witness: the
       recompute and the plain version on float64 copies of the inputs give
       every leaf the same gradient within TOL_GRAD_F64 under a random
       upstream gradient and under 1/2 |out|^2; every leaf's bf16 gradient
       through the recompute held to plain autograd of the plain version
       (fp32 products), a tensor under the random upstream gradient, a gate
       under 1/2 |out|^2, the other pairing logged; times beside plain
       autograd's, PyTorch's own composition and the bound) of K1 at its
       four sites ((394, 10, 768), (98, 10, 768), (20, 197, 768), (20, 49,
       768); TOL_KERNEL for the forward and the gradients);
       `cli.run_adapt_ave29.main --synthetic True --n-epochs 2 --lr_adapt
       True` on the card, the straight run (4 steps of the train pipeline on
       the card, the head's dropout, Adam; 2 eval batches): finite step
       losses, every trainable leaf moved, every frozen leaf bit for bit, K1
       exactly 48 x forwards and no other kernel, its files written
       (`check_cli_run`); a run resumed after epoch 1 against it (plateau
       LR, whose table does not depend on the epoch count; TOL_RESUME); one
       train step at depth 2 against the CPU's fp32 plain path on live
       weights (`step_against_cpu`: loss and all gradients within
       TOL_KERNEL, each leaf within TOL_TRAIN_LEAF); the train step's wall
       ms, its spans between CUDA events and its kernel time (torch.profiler)
       split into pipeline, forward, backward and Adam, clips/s, peak memory
       and the device's busy share;
     - Swin training (`phase_train_swin`): AVE-29 on Swin-Base fusion
       (BASELINE.json configs[1]'s tower) at full width and depth, B =
       TRAIN_B, bf16 compute with fp32 masters. Gradient rows (TOL_GRAD) of
       K1 at the stage 0-1 shifted windows and temporal sites (the trainable
       temporal table a leaf, its gradient through `gather_bias`'s index
       backward), K4 at stage 2 unshifted and shifted and stage 3 (live
       adapters and gates, the relative table a leaf), K5 and K6 at stages
       0-1, K7 at the stage-0 FFN's shape, the K8 site at stage 3's temporal
       branch and K9 at every norm; `cli.run_adapt_ave29.main --model
       MM-Swin-AVE-Base`, the straight run, as CLIP's (`launches_per_forward`
       x forwards); a resumed run against it (TOL_RESUME; the leaves that
       differ named); one step at depths 2/2/2/2 against the CPU; the step's
       times;
     - AVS training (`phase_train_avs`): `cli.run_adapt_avs.main` at its
       defaults (Swin-Large fusion, T = 5, TPAVI at all four stages) at B =
       TRAIN_B: the K8 site's gradient rows at the stage 2-3 temporal sites
       (the bias gradient dbm reaching the temporal table); the straight run
       as above; `--eval_only` on its best checkpoint reproducing its best
       miou; under STGCMA_DETERMINISTIC=1 (the CLIs' switch for torch's
       deterministic algorithms) a straight run and a run resumed after
       epoch 1 (TOL_RESUME), their BatchNorm statistics too; two steps at
       depths 2/2/2/2 against the CPU (the CLI's loss, TPAVI's BatchNorm on
       batch statistics) with the BatchNorm statistics after them, and one
       with that BatchNorm on its running statistics, where the audio
       branch's gradient does not cancel; in both a CPU bf16 step measures
       what bf16 rounding alone does to each leaf (ZERO_SHARE: zero to
       rounding; the bar TOL_TRAIN_LEAF plus TRAIN_NOISE x that distance,
       the larger of two roundings' for a leaf below its own);
       the step's times;
     - AVQA training (`phase_train_avqa`): `cli.run_adapt_avqa.main` at its
       defaults (Swin-Large fusion, T = 10, the AVQA head with its attention
       dropout) at B = TRAIN_B: gradient rows at AVQA's sites (K1 at the
       stage 0-1 shifted windows and T = 10 temporal sites, K4 at stage 2
       unshifted and shifted and stage 3 over 20 frames, K5 and K6 at D = 96,
       the K8 site at the stage 2-3 temporal branches and, as under
       --freeze_base False, at the nega stream's windows with the relative
       table a leaf; stage 3's K4 row held against the same recompute on
       the CPU); the straight run (`launches_per_forward(nega=True)` x
       train steps plus the two-stream eval forwards' launches, exactly),
       `--eval_only` on its best checkpoint reproducing its best accuracy;
       under STGCMA_DETERMINISTIC=1 a straight run and a run resumed after
       epoch 1 against it (TOL_RESUME); one step at depths 2/2/2/2 and B =
       TRAIN_B against the CPU (the CLI's loss, dropout off;
       `step_against_cpu`'s CPU bf16 rule); the step's times, and its
       forward split into the fused tower, the nega stream and the head,
       with the memory the nega stream keeps for the backward (none under
       freeze_base); `tools.grounding_gen.main --synthetic True` on the
       card;
     - `phase_grad_kernels` (phase 3): K10's gradient row at its Swin-Base
       168^2 check site and K12's, K13's and K14's at the CLIP-B/16 fusion
       check sites at B = TRAIN_B, so that every recompute has run on the
       card;
     - the PVT-v2-b5 AVS baseline (`phase_avs_pvt`): depths 3/6/40/3 at
       224^2, B = 8 clips x T = 5, random weights and VGGish-shaped audio
       features; bf16 against the card's fp32 (TOL_PVT_BF16), the
       train-mode forward with its BatchNorm statistics, fp32 against the
       CPU at depths 1/1/2/1 (TOL_PVT_FP32); wall, device ms, busy share,
       peak memory, launches, `cost_analysis`'s flops and TFLOP/s; and
       `runtime/profiling.py`'s trace around one forward holding its
       annotated region and the card's kernels;
     - the mesh (`phase_mesh`): an NCCL world of one through
       `init_distributed` and `make_mesh(1, 1)`: Swin-Base fusion served
       with `shard_tower` (every split leaf gathered where read) equal to
       the meshless server bit for bit with the same launches, and one AVS
       train step at depths 2/2/2/2 with the mesh equal to the step without
       it bit for bit under torch's deterministic algorithms.
The script logs its total wall time. The line before the last is one JSON
object {"kernels": [...]}; the last is {"ok": true, "device": {...}}. The
training path's launches (set to 0 just before its CLI run, read just after
it) add K1 288 to the kernels line's totals; the Swin, AVS and AVQA
training runs add theirs, and the mesh server's forward its K1, K4-K9.
Without a CUDA device it exits 1 at once.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import os
import subprocess
import sys
import time

SEED = 0
B = 8
TOL_KERNEL = 2e-2    # max |kernel - plain| / max |plain|, bf16 outputs: a few
                     # bf16 steps where an intermediate rounds the other way
TOL_KERNEL_Q = 3e-2  # the int8 variants of K4, K12, K13 and K11: where a bf16 intermediate
                     # rounds the other way before one of their row quantizations, codes
                     # move by one step; ~1 bf16 step of max |plain| more than the float K4
TOL_K4_LARGE = 3e-2  # the float K4 at Swin-Large (C = 768 / 1536, D = 96): the FFN output
                     # that feeds the second fusion's adapter is ~3x Swin-Base stage 2's at
                     # the same random tower, which sharpens the fusion's unscaled softmax,
                     # so a one-ulp bf16 flip of a hidden moves a fused row by several bf16
                     # steps (stage 3: 2.04% of max |plain| where Swin-Base stays at ~1.1%);
                     # the log counts the outputs past TOL_KERNEL
TOL_K4Q_LARGE = 1e-1  # K4's int8 variant at Swin-Large stage 3 (C = 1536, D = 96, the fusion
                      # over each frame's 49 tokens): int8 codes that the kernel and its plain
                      # version round the other way feed the sharp fusion softmax that
                      # TOL_K4_LARGE names, in steps of max / 127 instead of one bf16 ulp. On
                      # an H100 the plain version itself moves by 4.4% of max |plain| when
                      # 0.01% of v's elements move by one bf16 ulp, and the kernel sat 4.1%,
                      # 4.8% and 6.8% from it on three draws (923 of 12 M outputs past 2e-2),
                      # but 1.7% with the gates zeroed and 1.6% with D_fc1 halved; so the row
                      # logs that noise floor, and the same block with D_fc1 halved is held
                      # at TOL_KERNEL_Q beside it. Since F5 was settled (F5_FACTOR) this is
                      # only the cap of the row's bar
F5_FACTOR = 1.5      # ROADMAP F5: the int8 K4 at Swin-Large stage 3 may sit at most this many
                     # times as far from the block's fp32 plain version as its bf16 plain
                     # version does; its kernel-vs-plain bar is then (1 + F5_FACTOR) x the
                     # plain version's distance (the triangle bound), capped at TOL_K4Q_LARGE
TRAIN_B, TRAIN_N = 2, 4   # phase_train: the reference's batch size; synthetic items (2 steps
                          # an epoch, one eval batch of the TRAIN_N // 2 eval items)
TOL_TRAIN_LEAF = 1e-1  # one train step at depth 2, card bf16 vs CPU fp32: each trainable leaf's
                       # gradient within this share of its own max |cpu| (the scalar gates'
                       # gradients sum a product over every token and both streams, so their
                       # bf16 rounding does not average out as a matrix's does; a term missing
                       # from the backward moves a leaf by its whole size); all gradients
                       # together are held at TOL_KERNEL
ZERO_SHARE = 1e-2    # a step's leaf is zero to rounding where its fp32 gradient is at most this
                     # share of the CPU's bf16 distance from it (TPAVI's W_z conv biases: their
                     # fp32 gradient sat at 1.1e-4 to 1.3e-4 of that distance, every other
                     # leaf at 0.74 or more, on the H100)
TRAIN_NOISE = 1.5    # with a CPU bf16 step: each leaf within TOL_TRAIN_LEAF of its max plus this
                     # many times the CPU's own bf16 distance (the card sat at 0.04-1.67 of it
                     # where that distance passed TOL_TRAIN_LEAF, on the H100)
TOL_GRAD = 3e-2      # a gradient row: each leaf's gradient through the recompute (bf16
                     # products, fp32 accumulation, as the JAX references' dots) within this
                     # share of its own max |plain| from plain autograd of the plain version
                     # (every product in fp32); a term missing from a backward moves a leaf
                     # by its whole size
K4_ST3_JAX_BF16 = 7.1e-2  # the distance JAX's own bf16 backward of `_fullgrid_naive` sits from
                     # its fp32 gradient at Swin-Large stage 3 (C = 1536, D = 96, a sharp fusion
                     # softmax): its largest leaf's, as a share of that leaf's max, on the CPU
                     # (tests/test_torch_port_swin_large_grad.py reads 5.77e-2 and holds the
                     # port's recompute no farther from fp32 than JAX's). K4's gradient row
                     # there is held at TOL_GRAD on top of it: bf16 rounding alone moves the
                     # port's recompute 6.83% from plain autograd on the H100, 7.14% on the
                     # CPU, and the card's recompute 4.53% from the CPU's on the same inputs
TOL_GRAD_F64 = 1e-2  # a gradient row's witness: the recompute and the plain version on
                     # float64 copies of the inputs (their fp32 steps stay fp32), each leaf's
                     # gradient within this share of its max (on the H100 <= 1.1e-5, and 7.0e-4
                     # for K6 st.0's gate under a random upstream gradient, a sum that cancels
                     # to 1e-3 of its terms); a term missing from a backward moves a leaf by
                     # its whole size
SWIN_AVE = "MM-Swin-AVE-Base"   # phase_train_swin: BASELINE.json configs[1]'s tower
TOL_RESUME = 1e-2    # a run resumed after epoch 1: max |resumed - straight| over the masters
                     # within this share of the run's largest update (bf16 sums in another
                     # order would move them by far less; a moment or an LR not restored
                     # moves them by the size of an update)
TOL_SLICE = 5e-2     # max |card - cpu| / max |cpu| over the logits, bf16 through
                     # 12 or 24 blocks on two devices (different sum orders everywhere)
H100_BF16, H100_INT8, H100_BYTES = 989e12, 1979e12, 3.35e12   # dense peaks, 700 W
H100_FP32 = 67e12    # fp32 outside the tensor cores (LayerNorm arithmetic)
TOL_FUSED = 5e-2     # max |fused - unfused| / max |unfused| over the B = 8 logits on the
                     # card: the two configurations round to bf16 at other points (the
                     # FFN hidden, the adapters, the fusion) through 12 blocks
TOL_K14_MOVED = 0.2  # the share of K14's float outputs that may differ from the plain version's
                     # bits (both round at the same points; a last-bit difference of an fp32
                     # sum rounds an intermediate the other way); K14 with its residual
                     # rounded twice must move more of them, though each by one bf16 step
                     # (on an H100 at the CLIP-B/16 video rows: 0.092 against 0.32)
# CUDA launches a call of the redesigned K13 / K11 / K14 wrappers makes (csrc/tattn.cu's
# temporal product T, csrc/rowadapt.cu's row-owning product R): K13 and K14 LN, T, R (int8:
# LN + quantize, T, quantize, R); K11 qd (temporal) LN + quantize, T, quantize, R; qh
# (spatial) LN + quantize, qkv, core, quantize, R; ffn_qh LN + quantize, fc1, quantize, R
LAUNCHES_PER_CALL = {"clip_tadapt": 3, "clip_tadapt_q": 4, "clip_tv2": 3, "clip_tv2_q": 4,
                     "win_block_qd": 4, "win_block_qh": 5, "ffn_qh": 4}
KERNELS = ("K1", "K2", "K3", "K4", "K5", "K6", "K7", "K8", "K9", "K10", "K11", "K12", "K13",
           "K14")
CLIP_SWITCHES = ("STGCMA_CLIP_TADAPT_FUSED", "STGCMA_CLIP_WHOLE_BLOCK")
QFUSE = "STGCMA_QFUSE_ADAPTERS"
TV2 = "STGCMA_TV2"
# each kernel's name in the kernels line, the TPU kernel it replaces, and its
# CUDA sources in stgcma_tpu_torch/csrc/
META = {
    "K1": ("K1 win_block (bf16 attention block)", "stgcma_tpu/ops/pallas_attn.py:385",
           ["gemm.cu", "attn.cu", "rowprep.cu"]),
    "K2": ("K2 win_block_q (int8 attention block)", "stgcma_tpu/ops/pallas_attn.py:1461",
           ["gemm.cu", "attn.cu", "rowprep.cu"]),
    "K3": ("K3 ffn_q (int8 FFN)", "stgcma_tpu/ops/pallas_attn.py:1616",
           ["gemm.cu", "rowprep.cu"]),
    "K4": ("K4 swin_block + swin_block_q (whole Swin fusion block, bf16 and int8 variants)",
           "stgcma_tpu/ops/pallas_swin_block.py:245",
           ["rowprep.cu", "gemm.cu", "attn.cu", "fuse.cu", "adapter.cu"]),
    "K5": ("K5 win_fuse (per-window fusion)", "stgcma_tpu/ops/pallas_attn.py:1222", ["fuse.cu"]),
    "K6": ("K6 bidir_fuse (full-grid fusion)", "stgcma_tpu/ops/pallas_attn.py:1103",
           ["fuse.cu"]),
    "K7": ("K7 ffn (bf16 FFN)", "stgcma_tpu/ops/pallas_attn.py:676",
           ["ffn.cu", "rowprep.cu", "gemm.cu"]),
    "K8": ("K8 wmsa (window-attention core)", "stgcma_tpu/ops/pallas_attn.py:230", ["attn.cu"]),
    "K9": ("K9 layernorm", "stgcma_tpu/ops/pallas_attn.py:755", ["rowprep.cu"]),
    "K10": ("K10 unscaled_attention (softmax(q.k^T).v, unscaled: the full-grid fusion's route "
            "where a stage grid is not a multiple of 16)", "stgcma_tpu/ops/pallas_attn.py:137",
            ["fuse.cu"]),
    "K11": ("K11 win_block_qd + win_block_qh + ffn_qh (int8 attention block or FFN with the "
            "adapter's down-projection and GELU; pallas_attn.py:1486, :1503, :1674)",
            "stgcma_tpu/ops/pallas_attn.py:1486",
            ["rowprep.cu", "tattn.cu", "rowadapt.cu", "gemm.cu", "attn.cu"]),
    "K12": ("K12 clip_fusion_block + clip_fusion_block_q (whole CLIP fusion block after the "
            "temporal stage, bf16 and int8 variants)", "stgcma_tpu/ops/pallas_clip_block.py:168",
            ["rowprep.cu", "gemm.cu", "attn.cu", "fuse.cu"]),
    "K13": ("K13 clip_tadapt + clip_tadapt_q (temporal stage + T_Adapter, bf16 and int8 "
            "variants)", "stgcma_tpu/ops/pallas_clip_block.py:350",
            ["rowprep.cu", "tattn.cu", "rowadapt.cu"]),
    "K14": ("K14 clip_tv2 + clip_tv2_q (temporal stage + T_Adapter in the tower's (B*T, N, C) "
            "layout, no transposes, bf16 and int8 variants)", "stgcma_tpu/ops/pallas_attn.py:1757",
            ["rowprep.cu", "tattn.cu", "rowadapt.cu", "gemm.cu", "attn.cu"]),
}


_START = time.perf_counter()


def log(msg):
    """Print a line; a phase's heading ("[n/4] ...") with the script's time so far."""
    if msg.startswith("["):
        msg += f"  ({time.perf_counter() - _START:.1f} s into the script)"
    print(msg, flush=True)


def fail(msg):
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def smi_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 else "nvidia-smi failed"


def launches():
    """{"K1": launches, ...} of every kernel, summed over its wrappers (K4,
    K12, K13 and K14 have a bf16 and an int8 one, K11 three bodies)."""
    from stgcma_tpu_torch.ops import clip_block  # noqa: F401  (registers K12-K14)
    from stgcma_tpu_torch.ops import fused_attn as FA
    from stgcma_tpu_torch.ops import swin_block  # noqa: F401  (registers K4)
    by_id = FA.launches_by_id()
    return {k: by_id.get(k, 0) for k in KERNELS}


def sfu_rate():
    """exps per second: 16 per clock per SM x 132 SMs x the card's maximum SM clock."""
    from stgcma_tpu_torch.tools import bench_parts
    return bench_parts.sfu_rate()


def kernel_ms(fn, iters=3):
    """The card's kernel ms a call of fn (torch.profiler, the card's events
    only), after one call to warm up."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    return sum(e.time_range.end - e.time_range.start for e in prof.events()
               if e.device_type == DeviceType.CUDA) / 1e3 / iters


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


def _bound(t_tensor, t_exp, t_bytes, grad=False):
    """(least ms, what bounds it) of a function whose products take t_tensor
    s, its exps t_exp s and its bytes t_bytes s. With `grad`, of its forward
    and backward: three times the products (the forward's, and the
    backward's two for each: the input's gradient and the weight's), the
    exps once (the probabilities kept), twice the bytes (the inputs read
    again and each gradient written, as large as its input)."""
    t_ops = max(3 * t_tensor if grad else t_tensor, t_exp)
    t_bytes = 2 * t_bytes if grad else t_bytes
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


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


def library_block(args, heads, int8, bias=None):
    """The same function from PyTorch's own calls (timed only, never used by
    the port): layer_norm, linear or _int_mm, scaled_dot_product_attention
    (with the bias (nWb, h, N, N) as a float attn_mask)."""
    import torch
    import torch.nn.functional as F
    x = args[0]
    Bq, N, C = x.shape
    dh = C // heads
    P = 1 if bias is None else bias.shape[0]

    def run():
        xn = F.layer_norm(x, (C,), args[1], args[2])
        if int8:
            qkv = library_qmm(xn.view(-1, C), args[3], args[4], args[5]).to(torch.bfloat16)
        else:
            qkv = F.linear(xn, args[3], args[4])
        if bias is None:
            q, k, v = qkv.view(Bq, N, 3, heads, dh).permute(2, 0, 3, 1, 4)
            o = F.scaled_dot_product_attention(q, k, v)
        else:     # windows grouped by the bias period, which the mask broadcasts over
            q, k, v = qkv.view(Bq // P, P, N, 3, heads, dh).permute(3, 0, 1, 4, 2, 5)
            o = F.scaled_dot_product_attention(q, k, v, attn_mask=bias.to(x.dtype))
        o = o.transpose(-3, -2).reshape(Bq * N, C)
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


def _flat(out):
    """One fp32 vector of a kernel's output (a tensor, or a tuple of them)."""
    import torch
    outs = out if isinstance(out, tuple) else (out,)
    return torch.cat([o.float().flatten() for o in outs])


def check_kernel(name, kernel, plain, args, kw, bound, library, tol=TOL_KERNEL):
    import torch
    out = _flat(kernel(*args, **kw))
    torch.cuda.synchronize()
    ref = _flat(plain(*args, **kw))
    if not torch.isfinite(out).all():
        fail(f"{name}: non-finite kernel output")
    err = (out - ref).abs().max().item()
    scale = ref.abs().max().item()
    past = ""
    if tol > TOL_KERNEL:             # how many elements need the wider bar
        n = int(((out - ref).abs() > TOL_KERNEL * scale).sum())
        past = f", {n} of {out.numel()} elements past {TOL_KERNEL}"
    del out, ref
    if not err <= tol * scale:
        fail(f"{name}: max |kernel - plain| = {err:.4g} > {tol} * {scale:.4g}{past}")
    ms = cuda_ms(lambda: kernel(*args, **kw), iters=20)
    plain_ms = cuda_ms(lambda: plain(*args, **kw), iters=3, warmup=1)
    library_ms = None                # no one PyTorch call computes the function
    try:
        if library is not None:
            library_ms = cuda_ms(library, iters=20)
    except RuntimeError as e:        # a yardstick only; the port never calls it
        log(f"  {name}: library yardstick unavailable: {e}")
    bound_ms, bound_by = bound
    lib_s = "null" if library_ms is None else f"{library_ms:.4f}"
    log(f"  {name}: max_abs_err {err:.4g} (max |plain| {scale:.4g}, tol {tol} rel{past}) "
        f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, library {lib_s} ms, "
        f"bound {bound_ms:.4f} ms ({bound_by})")
    return {"shape": name, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": library_ms}


def phase_parts():
    """csrc/gemm.cu's bf16 product and csrc/attn.cu's attention core alone, at
    the shapes of `tools/bench_parts.py`, against their plain versions, listed
    under K1, whose launches they make on the main path; and csrc/gemm.cu's
    int8 product and csrc/rowprep.cu's row quantization alone, listed under K2
    (qkv, proj, Swin's K = 128 qkv, the LN rows) and K3 (fc1 with its fp32
    QuickGELU hidden and row maxima, fc2, the hidden's quantization). An int8
    product with the bf16 epilogue must equal its plain version bit for bit;
    the fp32 hidden lies within 1e-6 of max |plain| (erff / expf ulps) and its
    row maxima must be those of the stored hidden. K4's attention core alone
    at Swin-Base stage 2 shifted, over the full grid and over each window's
    49 tokens (`_attn_core_win`, the core K4 runs), is listed under K4."""
    import torch
    from stgcma_tpu_torch.tools import bench_parts
    g = torch.Generator(device="cuda").manual_seed(SEED + 7)
    rows = {"K1": [], "K2": [], "K3": [], "K4": []}
    with torch.inference_mode():
        for case in bench_parts.gemm_cases(g) + bench_parts.core_cases(g):
            row = check_kernel(case["row"], case["fn"], case["plain"], (), {}, case["bound"],
                               case["library"])
            row["tflops"] = case["flops"] / row["ms"] / 1e9
            log(f"  {case['row']}: {row['tflops']:.1f} TFLOP/s")
            rows["K1"].append(row)
            del case
        for case in bench_parts.s8_cases(g):
            tol = 0.0 if case.get("exact") else bench_parts.TOL_S8_F32
            if "amax" not in case:
                tol = TOL_KERNEL     # row quantization: an LN code may move by one step
            row = check_kernel(case["row"], case["fn"], case["plain"], (), {}, case["bound"],
                               case.get("library"), tol=tol)
            if case.get("amax") is not None:
                hidden = case["fn"]()
                if not torch.equal(case["amax"], hidden.abs().amax(-1)):
                    fail(f"{case['row']}: the epilogue's row maxima are not the hidden's")
                log(f"  {case['row']}: row maxima equal those of the stored hidden")
            if "flops" in case:
                row["tops"] = case["flops"] / row["ms"] / 1e9
                log(f"  {case['row']}: {row['tops']:.1f} TOP/s")
            k3 = any(t in case["row"] for t in ("fc1", "fc2", "hidden"))
            rows["K3" if k3 else "K2"].append(row)
            del case
        for case in bench_parts.k4_core_cases(g, sfu_rate()):
            row = check_kernel(case["row"], case["fn"], case["plain"], (), {}, case["bound"],
                               case["library"])
            row["tflops"] = case["flops"] / row["ms"] / 1e9
            rows["K4"].append(row)
    return rows


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


def adapter_operands(g, C, D):
    """A live adapter's D_fc1 (D, C) and its bias, bf16, drawn as
    `live_k4_weights` draws them: N(0, 2.26^2 / C) and N(0, 0.1)."""
    import torch
    bf = torch.bfloat16
    return ((torch.randn(D, C, generator=g, device="cuda") * (2.26 / C ** 0.5)).to(bf),
            (torch.randn(D, generator=g, device="cuda") * 0.1).to(bf))


def k11_bound(M, C, D, tower_ops, gram_ops, wbytes, emit_o):
    """K11 per call: K2's or K3's work (int8 tower products, bf16 grams) and
    the adapter product (M, C) x (C, D) on the tensor cores; x read, o (where
    it is emitted) and the hidden written once, the weights read once."""
    t_ops = tower_ops / H100_INT8 + (gram_ops + 2 * M * C * D) / H100_BF16
    nbytes = M * C * 2 * (2 if emit_o else 1) + M * D * 2 + wbytes + (D * C + D) * 2
    t_bytes = nbytes / H100_BYTES
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def library_k11(kind, args, heads):
    """K2's or K3's composition from PyTorch's own calls (`_int_mm`), then
    `F.linear` and `F.gelu` for the hidden (timed only)."""
    import torch.nn.functional as F
    wd, bd = args[-3], args[-2]
    if kind == "ffn_qh":
        base = library_ffn(args[:9], "quick_gelu")
    else:
        inner = library_block(args[:9], heads, True)

        def base():
            return inner().view(args[0].shape)

    def run():
        o = base()
        h = F.gelu(F.linear(o, wd, bd))
        return h if kind == "qd" else (o, h)
    return run


@contextlib.contextmanager
def hidden_before_gelu():
    """K11's adapter product with the plain epilogue in place of the erf-GELU
    one: the hidden taken before the GELU."""
    from stgcma_tpu_torch.ops import fused_attn as FA
    real = FA._EPI_BF16_GELU
    FA._EPI_BF16_GELU = FA._EPI_BF16
    try:
        yield
    finally:
        FA._EPI_BF16_GELU = real


def check_k11_faults(name, kernel, plain, args, other, tol):
    """The K11 check fails where it must: K11 with the S and MLP adapters
    swapped (run with `other`, the other adapter's D_fc1) and K11 taking its
    hidden before the GELU are held to the plain version on the true inputs,
    and must differ by more than the tolerance."""
    import torch
    ref = _flat(plain(*args))
    scale = ref.abs().max().item()
    runs = {"S and MLP adapters swapped": lambda: kernel(*args[:-3], *other, args[-1]),
            "hidden taken before the GELU": lambda: kernel(*args)}
    moved = {}
    for fault, run in runs.items():
        with (hidden_before_gelu() if "GELU" in fault else contextlib.nullcontext()):
            out = _flat(run())
        torch.cuda.synchronize()
        moved[fault] = (out - ref).abs().max().item() / scale
        if not moved[fault] > tol:
            fail(f"{name}: a K11 with '{fault}' passes the check ({moved[fault]:.4g} of "
                 f"max |plain| from the plain version, tol {tol})")
    log(f"  {name}: K11 with a fault vs plain (rel, must exceed {tol}): "
        + ", ".join(f"{k} {x:.4g}" for k, x in moved.items()))
    return moved


@contextlib.contextmanager
def counted_launches():
    """The names of the port's CUDA launchers called inside (each launcher
    call is one CUDA launch)."""
    from stgcma_tpu_torch.ops import cuda_lib
    real, calls = cuda_lib.lib, []

    class Counting:
        def __init__(self, lib):
            self._lib = lib

        def __getattr__(self, name):
            fn = getattr(self._lib, name)
            if not name.startswith("stg_") or name == "stg_error_string":
                return fn

            def call(*args):
                calls.append(name)
                return fn(*args)
            return call
    cuda_lib.lib = lambda src: Counting(real(src))
    try:
        yield calls
    finally:
        cuda_lib.lib = real


def check_launches(name, kernel, args, want_t):
    """One call of the wrapper makes exactly LAUNCHES_PER_CALL of its kind,
    R (csrc/rowadapt.cu) among them, and T (csrc/tattn.cu) where `want_t`."""
    import torch
    key = next(k for k in LAUNCHES_PER_CALL if kernel.name.startswith(k + " "))
    with counted_launches() as calls:
        kernel(*args)
    torch.cuda.synchronize()
    if len(calls) != LAUNCHES_PER_CALL[key]:
        fail(f"{name}: {len(calls)} launches a call ({calls}), expected {LAUNCHES_PER_CALL[key]}")
    if not any(c.startswith("stg_rowadapt") for c in calls) or (
            want_t != any(c.startswith("stg_tattn") for c in calls)):
        fail(f"{name}: launches {calls} miss the row-owning product or take the temporal one "
             f"{'not ' if want_t else ''}where they must")
    log(f"  {name}: {len(calls)} launches a call: {', '.join(calls)}")
    return len(calls)


@contextlib.contextmanager
def tattn_over_whole_tile():
    """The temporal product attending over all the whole sequences of its
    128-row tile instead of each sequence: launched with the tile's span as
    its frame count (patched where K13 and K11 call it)."""
    from stgcma_tpu_torch.ops import clip_block as PCB
    from stgcma_tpu_torch.ops import cuda_lib
    from stgcma_tpu_torch.ops import fused_attn as FA
    real = (PCB._tattn, FA._tattn)

    def faulty(a, sa, w, ws, bias, out, T, heads, s):
        span = (FA.TATTN_TILE_ROWS // T) * T
        M, C = a.shape
        lib, p, scale = cuda_lib.lib("tattn.cu"), FA._ptr, FA._q_scale(C // heads)
        if sa is None:          # sequences of consecutive rows (no token count)
            err = lib.stg_tattn_bf16(p(a), p(w), p(bias), p(out), M, C, span, heads, 0, scale, s)
        else:
            err = lib.stg_tattn_s8(p(a), p(sa), p(w), p(ws), p(bias), p(out), M, C, span, heads,
                                   0, scale, s)
        cuda_lib.check("tattn.cu", err)
        return out
    PCB._tattn = FA._tattn = faulty
    try:
        yield
    finally:
        PCB._tattn, FA._tattn = real


def kv_of_next_head(wqkv, C, heads):
    """W_qkv (or its bias, its scales) with the k and v rows of head h taken
    from head h + 1: what a temporal product pairing q of head h with k and v
    of head h + 1 computes on the true weights."""
    import torch
    dh = C // heads
    return torch.cat([wqkv[:C], wqkv[C:2 * C].roll(-dh, 0), wqkv[2 * C:].roll(-dh, 0)])


def check_t_faults(name, run, plain_out, tol, next_head_args):
    """The check fails where it must for the temporal product's wiring: the
    attention over the whole tile (the wrapper run under
    `tattn_over_whole_tile`) and q of head h with k, v of head h + 1 (`run`
    on `next_head_args`) are held to the plain version on the true inputs
    and must differ by more than the tolerance."""
    import torch
    ref = _flat(plain_out)
    scale = ref.abs().max().item()
    moved = {}
    with tattn_over_whole_tile():
        out = _flat(run())
    torch.cuda.synchronize()
    moved["T attends over the whole tile"] = (out - ref).abs().max().item() / scale
    out = _flat(run(*next_head_args))
    torch.cuda.synchronize()
    moved["T pairs q of head h with k, v of head h + 1"] = (out - ref).abs().max().item() / scale
    for fault, m in moved.items():
        if not m > tol:
            fail(f"{name}: a temporal product with '{fault}' passes the check ({m:.4g} of max "
                 f"|plain| from the plain version, tol {tol})")
    log(f"  {name}: T with a fault vs plain (rel, must exceed {tol}): "
        + ", ".join(f"{k} {x:.4g}" for k, x in moved.items()))
    return moved


def phase_k11_kernels(cfg):
    """K11's three bodies at the sites of CLIP ViT-B/16 fusion with the int8
    tower at B = 8: the temporal hidden-only body at the video and audio
    rows, the spatial body emitting (o, hidden) at the video and audio
    frames, the FFN body at the video and audio tokens; each with a live
    adapter, and once more with each of its two wiring faults."""
    import torch
    from stgcma_tpu_torch.ops import fused_attn as FA
    g = torch.Generator(device="cuda").manual_seed(SEED + 5)
    C, heads, T = cfg.embed_dim, cfg.heads, cfg.num_frames
    D, dh = int(C * cfg.adapter_ratio), C // heads
    Nv, Na = cfg.num_patches + 1, cfg.num_patches_audio + 1
    wattn = 4 * C * C + 4 * C * 2 * 2 + 2 * C * 2         # int8 weights, bf16 scales, biases, LN
    wffn = 8 * C * C + 5 * C * 2 * 2 + 2 * C * 2
    sites = [("qd", "video temporal", B * Nv, T), ("qd", "audio temporal", B * Na, T),
             ("qh", "video spatial", B * T, Nv), ("qh", "audio spatial", B * T, Na),
             ("ffn_qh", "video", B * T * Nv, None), ("ffn_qh", "audio", B * T * Na, None)]
    kernels = {"qd": FA.win_block_qd, "qh": FA.win_block_qh, "ffn_qh": FA.ffn_qh}
    rows = []
    for kind, site, Bq, N in sites:
        kernel = kernels[kind]
        plain = kernel.plain
        if N is None:
            M, shape = Bq, (Bq, C)
            args = make_ffn_inputs(g, M, C) + adapter_operands(g, C, D) + ("quick_gelu",)
            bound = k11_bound(M, C, D, 16 * M * C * C, 0, wffn, True)
        else:
            M, shape = Bq * N, (Bq, N, C)
            base, _ = make_block_inputs(g, Bq, N, C, heads, True)
            args = base + adapter_operands(g, C, D) + (heads,)
            bound = k11_bound(M, C, D, 8 * M * C * C, 4 * Bq * heads * N * N * dh, wattn,
                              kind == "qh")
        name = f"K11 {kind} {site} {shape} D {D}"
        row = check_kernel(name, kernel, plain, args, {}, bound, library_k11(kind, args, heads),
                           TOL_KERNEL_Q)
        row["faults_rel"] = check_k11_faults(name, kernel, plain, args,
                                             adapter_operands(g, C, D), TOL_KERNEL_Q)
        row["launches_per_call"] = check_launches(name, kernel, args, kind == "qd")
        if kind == "qd" and site.startswith("video"):
            nxt = args[:3] + tuple(kv_of_next_head(t, C, heads) for t in args[3:6]) + args[6:]
            row["faults_rel"].update(check_t_faults(
                name, lambda *a: kernel(*(a or args)), plain(*args), TOL_KERNEL_Q, nxt))
        rows.append(row)
        del args
    return {"K11": rows}


def phase_l14_kernels(cfg):
    """K1 and K2 at CLIP ViT-L/14's spatial site, 257 tokens (the attention
    core's key-streaming kernel), at B = 8."""
    import torch
    from stgcma_tpu_torch.ops import fused_attn as FA
    g = torch.Generator(device="cuda").manual_seed(SEED + 6)
    C, heads = cfg.embed_dim, cfg.heads
    Bq, N = B * cfg.num_frames, cfg.num_patches + 1
    results = {"K1": [], "K2": []}
    for kname, kernel, plain, int8 in (("K1", FA.win_block, FA.win_block_plain, False),
                                       ("K2", FA.win_block_q, FA.win_block_q_plain, True)):
        args, _ = make_block_inputs(g, Bq, N, C, heads, int8)
        results[kname].append(check_kernel(
            f"{kname} CLIP-L/14 video spatial {(Bq, N, C)} h{heads}", kernel, plain,
            args + (heads,), {}, block_bound(Bq, N, C, heads, int8, 0),
            library_block(args, heads, int8)))
    return results


def swin_bias(g, heads, N, index, mask=None):
    """A bias of the Swin path from the port's own functions: a random table
    (std 0.5) gathered to (h, N, N) fp32, plus the shift mask (nW, N, N)
    when given -> (nW or 1, h, N, N)."""
    import torch
    from stgcma_tpu_torch.ops.attention import gather_bias
    table = torch.randn(int(index.max()) + 1, heads, generator=g, device="cuda") * 0.5
    bias = gather_bias(table.to(torch.bfloat16), index, heads, N)[None]
    return (bias if mask is None else bias + mask[:, None]).contiguous()


def ffn_bf16_bound(M, C, H):
    """K7's least time: the larger of the two products' bf16 tensor flops, the
    erf-GELU's fp32 instructions (`bench_parts.GELU_INSTRUCTIONS` for each of
    the M H hidden values, counted in the SASS by tools/gelu_sass.py) and x,
    out and the weights through HBM once."""
    from stgcma_tpu_torch.tools import bench_parts
    return bench_parts.ffn_bound(M, C, H)


def library_wmsa_qkv(qkv, bm, heads):
    """K8's site from PyTorch's own calls (timed only): the permuted view of
    the packed qkv into scaled_dot_product_attention with the bias as a float
    mask (P / heads rows of it broadcast over the rows), heads merged."""
    import torch.nn.functional as F
    B_, N, C3 = qkv.shape
    C = C3 // 3
    dh, G = C // heads, bm.shape[0] // heads

    def run():
        q, k, v = qkv.view(B_ // G, G, N, 3, heads, dh).permute(3, 0, 1, 4, 2, 5)
        o = F.scaled_dot_product_attention(q, k, v, attn_mask=bm.view(G, heads, N, N).to(
            qkv.dtype))
        return o.transpose(-3, -2).reshape(B_, N, C)
    return run


def check_one_launch(name, kernel, args, launcher):
    """One call of the wrapper makes exactly one CUDA launch, of `launcher`."""
    return check_launch_sequence(name, kernel, args, [launcher])


def check_launch_sequence(name, kernel, args, launchers):
    """One call of the wrapper makes exactly the CUDA launches `launchers`,
    in that order."""
    import torch
    with counted_launches() as calls:
        kernel(*args)
    torch.cuda.synchronize()
    if calls != launchers:
        fail(f"{name}: launches {calls} a call, expected {launchers}")
    log(f"  {name}: {len(calls)} launch{'es' if len(calls) > 1 else ''} a call: "
        f"{', '.join(calls)}")
    return len(calls)


def check_faults(name, kernel, plain, args, faults, tol=TOL_KERNEL):
    """The kernel check fails where it must: the kernel run on the arguments
    of each fault (the inputs that make it compute what a kernel with that
    fault would: a hidden chunk's weights zeroed, a bias dropped, every head's
    bias at head 0) differs from the plain version on the true arguments by
    more than the tolerance."""
    import torch
    ref = _flat(plain(*args))
    scale = ref.abs().max().item()
    moved = {}
    for fault, fargs in faults.items():
        out = _flat(kernel(*fargs))
        torch.cuda.synchronize()
        moved[fault] = (out - ref).abs().max().item() / scale
        if not moved[fault] > tol:
            fail(f"{name}: a kernel with '{fault}' passes the check ({moved[fault]:.4g} of max "
                 f"|plain|, tol {tol})")
    log(f"  {name}: faults vs plain (rel, must exceed {tol}): "
        + ", ".join(f"{k} {v:.4g}" for k, v in moved.items()))
    return moved


def wmsa_bound(R, N, dh, P, grad=False):
    ops = 2 * 2 * R * N * N * dh
    nbytes = 4 * R * N * dh * 2 + P * N * N * 4
    return _bound(ops / H100_BF16, 0.0, nbytes / H100_BYTES, grad)


def ln_bound(M, C, grad=False):
    return _bound(8 * M * C / H100_FP32, 0.0, (2 * M * C * 2 + 2 * C * 2) / H100_BYTES, grad)


def k9_sites(cfg, b=B):
    """(site, rows, width) of the LayerNorms of one Swin stream at B clips of
    cfg.num_ttokens frames: the patch embed's, the three merges', the
    temporal norm of each stage with more heads than K1 takes (LN + the K8
    core: stage 3 of Swin-Base, stages 2-3 of Swin-Large) and the final
    norm."""
    from stgcma_tpu_torch.ops.fused_attn import block_kernel_route
    rows, T = b * cfg.num_ttokens, cfg.num_ttokens
    H0, _ = cfg.stage_resolution(0)
    sites = [("patch-embed norm", rows * H0 * H0, cfg.embed_dim)]
    for s in range(cfg.num_layers - 1):
        Hs, _ = cfg.stage_resolution(s)
        sites.append((f"merge norm {s}->{s + 1}", rows * (Hs // 2) ** 2, 4 * cfg.stage_dim(s)))
    for s in range(cfg.num_layers):
        if not block_kernel_route(cfg.num_heads[s]):
            Hs, _ = cfg.stage_resolution(s)
            sites.append((f"stage-{s} temporal norm", b * Hs * Hs * T, cfg.stage_dim(s)))
    H, _ = cfg.stage_resolution(cfg.num_layers - 1)
    return sites + [("final norm", rows * H * H, cfg.num_features)]


def k1_swin_rows(cfg, g, tower, windows, temporal):
    """K1 at the shifted-window sites of the stages `windows` and the
    temporal sites of the stages `temporal` of `cfg` at B clips of
    cfg.num_ttokens frames, each against its plain version."""
    import torch
    from stgcma_tpu_torch.ops import fused_attn as FA
    from stgcma_tpu_torch.ops import window
    dev = "cuda"
    T, ws = cfg.num_ttokens, cfg.window_size
    N = ws * ws
    rel = torch.from_numpy(window.relative_position_index(ws)).to(dev)
    t_idx = torch.from_numpy(window.temporal_relative_index(T)).to(dev)
    rows = []
    for s in windows:
        H, _ = cfg.stage_resolution(s)
        C, heads = cfg.stage_dim(s), cfg.num_heads[s]
        mask = torch.from_numpy(window.shift_attn_mask(H, H, ws, ws // 2)).to(dev)
        bm = swin_bias(g, heads, N, rel, mask)
        Bq = B * T * bm.shape[0]
        args, _ = make_block_inputs(g, Bq, N, C, heads, False)
        rows.append(check_kernel(
            f"K1 {tower} stage {s} shifted windows {(Bq, N, C)} h{heads} period {bm.shape[0]}",
            FA.win_block, FA.win_block_plain, args + (heads,), {"bias": bm},
            block_bound(Bq, N, C, heads, False, bm.shape[0]),
            library_block(args, heads, False, bm)))
        del args
    for s in temporal:
        H, _ = cfg.stage_resolution(s)
        C, heads = cfg.stage_dim(s), cfg.num_heads[s]
        bm = swin_bias(g, heads, T, t_idx)
        Bq = B * H * H
        args, _ = make_block_inputs(g, Bq, T, C, heads, False)
        rows.append(check_kernel(
            f"K1 {tower} stage {s} temporal T={T} {(Bq, T, C)} h{heads}", FA.win_block,
            FA.win_block_plain, args + (heads,), {"bias": bm},
            block_bound(Bq, T, C, heads, False, 1), library_block(args, heads, False, bm)))
        del args
    return rows


def k7_row(g, name, M, C, faults=False):
    """K7 at (M, C) (hidden 4C) against its plain version, with its device
    time alone and its launches a call (one of csrc/ffn.cu, or the
    three-launch composition at the widths ffn.cu does not instantiate);
    b1 ~ N(0, 1), so that a K7 without it fails the check; with `faults`,
    the two wiring faults that must fail it."""
    from stgcma_tpu_torch.tools import bench_parts
    import torch
    import torch.nn.functional as F
    from stgcma_tpu_torch.ops import fused_attn as FA
    bf = torch.bfloat16

    def rnd(*shape, std=1.0):
        return torch.randn(*shape, generator=g, device="cuda") * std
    Hd = 4 * C
    args = (rnd(M, C).to(bf), (1 + rnd(C, std=0.1)).to(bf), rnd(C, std=0.02).to(bf),
            rnd(Hd, C, std=0.05).to(bf), rnd(Hd).to(bf),
            rnd(C, Hd, std=0.02).to(bf), rnd(C, std=0.02).to(bf))

    def library(a=args):
        return F.linear(F.gelu(F.linear(F.layer_norm(a[0], (C,), a[1], a[2]), a[3], a[4])),
                        a[5], a[6])
    name = f"{name} {(M, C)} hidden {Hd}"
    row = check_kernel(name, FA.ffn, FA.ffn_plain, args, {}, ffn_bf16_bound(M, C, Hd), library)
    row["graph_ms"] = bench_parts.graph_ms(lambda a=args: FA.ffn(*a))
    row["launches_per_call"] = check_launch_sequence(
        name, FA.ffn, args, ["stg_ffn_bf16"] if FA.ffn_route(C, Hd)
        else ["stg_ln_bf16", "stg_gemm_bf16", "stg_gemm_bf16"])
    if faults:
        w2 = args[5].clone()
        w2[:, -FA.FFN_HIDDEN_CHUNK:] = 0
        row["faults"] = check_faults(name, FA.ffn, FA.ffn_plain, args, {
            "last hidden chunk skipped": args[:5] + (w2, args[6]),
            "b1 dropped": args[:4] + (torch.zeros_like(args[4]),) + args[5:]})
    log(f"  {name}: device alone (CUDA graph) {row['graph_ms']:.4f} ms")
    return row


def k9_rows(cfg, g, tower):
    """K9 at every norm site of one stream of `cfg` (`k9_sites`) against its
    plain version, each with its device time alone."""
    from stgcma_tpu_torch.tools import bench_parts
    import torch
    import torch.nn.functional as F
    from stgcma_tpu_torch.ops import fused_attn as FA
    bf = torch.bfloat16

    def rnd(*shape, std=1.0):
        return torch.randn(*shape, generator=g, device="cuda") * std
    rows = []
    for site, M, Cn in k9_sites(cfg):
        args = (rnd(M, Cn, std=2.0).to(bf), (1 + rnd(Cn, std=0.1)).to(bf),
                rnd(Cn, std=0.02).to(bf))

        def library(a=args, Cn=Cn):
            return F.layer_norm(a[0], (Cn,), a[1], a[2])
        name = f"K9 {tower}{site} {(M, Cn)}"
        row = check_kernel(name, FA.layernorm, FA.layernorm_plain, args, {}, ln_bound(M, Cn),
                           library)
        row["graph_ms"] = bench_parts.graph_ms(lambda a=args: FA.layernorm(*a))
        log(f"  {name}: device alone (CUDA graph) {row['graph_ms']:.4f} ms")
        rows.append(row)
        del args
    return rows


def phase_swin_kernels(cfg, large_cfg):
    """K1, K7, K8 and K9 at the shapes of Swin-Base multimodal at B = 8, K7
    also at Swin-Large's two FFN sites, Swin-Base 168^2's stage 0 and
    Swin-Large's stage 2 at B = 9 (its three-launch composition), K8 also
    as its sites run it (`wmsa_qkv`, from the packed qkv), and K9 at
    Swin-Large's norms; each K7, K8 site and K9 row also with its device time
    alone (its launch replayed from a CUDA graph: no host work); K7 and the K8
    site in one launch a call, each with its faults."""
    from stgcma_tpu_torch.tools import bench_parts
    import torch
    import torch.nn.functional as F
    from stgcma_tpu_torch.ops import fused_attn as FA
    from stgcma_tpu_torch.ops import window
    g = torch.Generator(device="cuda").manual_seed(SEED + 1)
    dev, bf = "cuda", torch.bfloat16
    T, ws = cfg.num_ttokens, cfg.window_size
    N = ws * ws
    rel = torch.from_numpy(window.relative_position_index(ws)).to(dev)
    t_idx = torch.from_numpy(window.temporal_relative_index(T)).to(dev)

    def rnd(*shape, std=1.0):
        return torch.randn(*shape, generator=g, device=dev) * std

    stages = range(cfg.num_layers - 1)           # stages 0-2: K1
    results = {"K1": k1_swin_rows(cfg, g, "Swin", stages, stages), "K7": [], "K8": [], "K9": []}

    # K7 at the FFNs of stages 0-1 of Swin-Base and Swin-Large, at stage 0 of
    # Swin-Base at 168^2 (141,120 rows: a tail row block), and at Swin-Large's stage 2
    # at B = 9 (17,640 rows of C = 768: the smallest batch at which the route sends a
    # width that csrc/ffn.cu does not instantiate to K7)
    k7_sites = [("", s, B * T * cfg.stage_resolution(s)[0] ** 2, cfg.stage_dim(s)) for s in (0, 1)]
    k7_sites += [("Swin-Large ", s, B * T * large_cfg.stage_resolution(s)[0] ** 2,
                  large_cfg.stage_dim(s)) for s in (0, 1)]
    k7_sites.append(("Swin-Base 168^2 ", 0, B * T * (168 // 4) ** 2, cfg.stage_dim(0)))
    k7_sites.append(("Swin-Large B = 9 ", 2, 9 * T * large_cfg.stage_resolution(2)[0] ** 2,
                     large_cfg.stage_dim(2)))
    for tag, s, M, C in k7_sites:
        results["K7"].append(k7_row(g, f"K7 {tag}stage {s} FFN", M, C,
                                    faults=not tag and s == 0))

    s3 = cfg.num_layers - 1                      # K8 at stage 3 (32 heads)
    H, _ = cfg.stage_resolution(s3)
    C, heads = cfg.stage_dim(s3), cfg.num_heads[s3]
    dh = C // heads
    scale = float(torch.tensor(dh ** -0.5, dtype=bf))
    k8_sites = [("spatial", B * T * heads, N, swin_bias(g, heads, N, rel)[0]),
                ("temporal", B * H * H * heads, T, swin_bias(g, heads, T, t_idx)[0]),
                ("blocked bias", B * T * heads, N, rnd(256, N, N, std=2.0))]
    for site, R, n, bm in k8_sites:
        q = (rnd(R, n, dh) * scale).to(bf)
        k, v = rnd(R, n, dh).to(bf), rnd(R, n, dh).to(bf)
        P = bm.shape[0]

        def library(q=q, k=k, v=v, bm=bm, R=R, n=n, P=P):
            shp = (R // P, P, n, dh)
            return F.scaled_dot_product_attention(q.view(shp), k.view(shp), v.view(shp),
                                                  attn_mask=bm.to(bf), scale=1.0)
        results["K8"].append(check_kernel(
            f"K8 Swin stage 3 {site} {(R, n, dh)} period {P}", FA.wmsa, FA.wmsa_plain,
            (q, k, v, bm), {}, wmsa_bound(R, n, dh, P), library))
    # K8 as the Swin sites run it: the packed qkv in, merged heads out, one launch; and
    # once more with every head's bias read at head 0, which must fail the check
    for site, R, n, bm in k8_sites[:2]:
        qkv = rnd(R // heads, n, 3 * C).to(bf)
        args = (qkv, bm, heads)
        name = f"K8 wmsa_qkv Swin stage 3 {site} {tuple(qkv.shape)} h{heads} period {bm.shape[0]}"
        row = check_kernel(name, FA.wmsa_qkv, FA.wmsa_qkv_plain, args, {},
                           wmsa_bound(R, n, dh, bm.shape[0]), library_wmsa_qkv(*args))
        row["graph_ms"] = bench_parts.graph_ms(lambda a=args: FA.wmsa_qkv(*a))
        row["launches_per_call"] = check_one_launch(name, FA.wmsa_qkv, args, "stg_attn_core")
        head0 = bm.view(-1, heads, n, n)[:, :1].expand(-1, heads, n, n).reshape(bm.shape)
        row["faults"] = check_faults(name, FA.wmsa_qkv, FA.wmsa_qkv_plain, args, {
            "every head's bias at head 0": (qkv, head0.contiguous(), heads)})
        log(f"  {name}: device alone (CUDA graph) {row['graph_ms']:.4f} ms")
        results["K8"].append(row)

    for tag, c in (("", cfg), ("Swin-Large ", large_cfg)):   # K9 at the norms of a stream
        results["K9"] += k9_rows(c, g, tag)
    return results


def fuse_bound(B, Nv, Na, D, sfu, grad=False):
    """The fusion of K5/K6: vh, ah read and vo, ao written once; the gram and
    the two probability products on the tensor cores; one exp per gram
    entry on the special function units (the TPU kernel derives the second
    direction from the same exps). Operations bound it where either the
    tensor time or the exp time exceeds the byte time."""
    nbytes = 2 * 2 * B * (Nv + Na) * D
    return _bound(3 * 2 * B * Nv * Na * D / H100_BF16, B * Nv * Na / sfu, nbytes / H100_BYTES,
                  grad)


def library_fuse(vh, ah, gv, ga):
    """scaled_dot_product_attention (scale 1) in both directions and the gated adds."""
    import torch.nn.functional as F

    def run():
        a2v = F.scaled_dot_product_attention(vh, ah, ah, scale=1.0)
        v2a = F.scaled_dot_product_attention(ah, vh, vh, scale=1.0)
        return vh + gv * a2v, ah + ga * v2a
    return run


def block_k4_bound(BT, N, C, heads, D, sfu, int8=False, window=None, grad=False):
    """K4 per call, both streams: qkv, proj, FFN (hidden 4C), attention
    grams and adapters on the tensor cores (the four tower products at the
    int8 rate in the int8 variant), plus both fusions; one exp per attention
    and fusion gram entry on the special function units. Bytes: v, a read
    and both outputs written once, the weights (int8 tower weights and their
    bf16 scales in the int8 variant), the bias and mask. `window` = ws^2:
    the attention and the masked fusion count the in-window grams only
    (N / ws^2 windows of ws^4 entries in place of N^2; the bias read at those
    entries, no mask), as the function needs; without it, the full-grid count
    of the kernels before the in-window design. The unmasked fusion is N^2
    either way."""
    M = BT * N
    grams = N * window if window else N * N       # attention / masked-fusion entries a row
    tower = 2 * (2 * M * C * 3 * C + 2 * M * C * C + 2 * 2 * M * C * 4 * C)
    rest = (2 * (4 * BT * grams * C + 4 * 2 * M * C * D)
            + 3 * 2 * BT * (grams + N * N) * D)
    exps = 2 * BT * heads * grams + BT * (grams + N * N)
    tower_bytes = 12 * C * C + 9 * C * 2 if int8 else 2 * 12 * C * C
    wbytes = tower_bytes + 2 * 8 * C * D + heads * grams * 4 + (0 if window else N * N * 4)
    t_tensor = tower / (H100_INT8 if int8 else H100_BF16) + rest / H100_BF16
    return _bound(t_tensor, exps / sfu, (4 * M * C * 2 + wbytes) / H100_BYTES, grad)


def library_k4(v, a, w, heads, bias, fuse_mask):
    """layer_norm, linear (or `torch._int_mm` for the int8 variant's tower
    products), scaled_dot_product_attention with a float mask and gelu: the
    same block from PyTorch's own calls (timed only)."""
    import torch
    import torch.nn.functional as F
    BT, N, C = v.shape
    dh = C // heads
    bm, fm = bias.to(v.dtype), fuse_mask.to(v.dtype)
    int8 = "s_qkv" in w

    def tower(x, wk, sk, bk, gelu=False):
        if not int8:
            y = F.linear(x, w[wk], w[bk])
            return F.gelu(y) if gelu else y
        y = library_qmm(x.reshape(-1, x.shape[-1]), w[wk], w[sk], w[bk])
        y = F.gelu(y) if gelu else y.to(v.dtype)
        return y.view(*x.shape[:-1], -1)

    def fuse(xv, xa, kv, ka, mask):
        hv = F.gelu(F.linear(xv, w[f"{kv}_w1"], w[f"{kv}_b1"]))
        ha = F.gelu(F.linear(xa, w[f"{ka}_w1"], w[f"{ka}_b1"]))
        a2v = F.scaled_dot_product_attention(hv, ha, ha, attn_mask=mask, scale=1.0)
        v2a = F.scaled_dot_product_attention(ha, hv, hv, attn_mask=mask, scale=1.0)
        return hv + w["gate_v"] * a2v, ha + w["gate_a"] * v2a

    def run():
        xn = F.layer_norm(torch.cat([v, a]), (C,), w["ln1_w"], w["ln1_b"])
        q, k, vv = tower(xn, "w_qkv", "s_qkv", "b_qkv").view(2 * BT, N, 3, heads, dh
                                                            ).permute(2, 0, 3, 1, 4)
        o = F.scaled_dot_product_attention(q, k, vv, attn_mask=bm)
        vs, as_ = tower(o.transpose(1, 2).reshape(2 * BT, N, C), "w_proj", "s_proj",
                        "b_proj").chunk(2)
        fv, fa = fuse(vs, as_, "s2v", "s2a", fm)
        v1 = v + vs + F.linear(fv, w["s2v_w2"], w["s2v_b2"])
        a1 = a + as_ + F.linear(fa, w["s2a_w2"], w["s2a_b2"])
        xn2 = F.layer_norm(torch.cat([v1, a1]), (C,), w["ln2_w"], w["ln2_b"])
        vn, an = tower(tower(xn2, "w1", "s1", "b1", gelu=True), "w2", "s2", "b2").chunk(2)
        fv, fa = fuse(vn, an, "sv", "sa", None)
        return (v1 + vn + F.linear(fv, w["sv_w2"], w["sv_b2"]),
                a1 + an + F.linear(fa, w["sa_w2"], w["sa_b2"]))
    return run


def live_k4_weights(w, g, keys=("s2v", "s2a", "sv", "sa")):
    """K4's weights (K12's or K13's with their adapter `keys`) with the
    adapters and the gates drawn where the fusion moves the block's output:
    with the tower's N(0, 0.02) adapters it
    moves it by ~1e-3, under the check's tolerance. D_fc1 N(0, 2.26^2 / C)
    and D_fc2 N(0, 0.566^2 / D) (both 0.1 at stage 2, C = 512 and D = 32),
    their biases N(0, 0.1), gates 0.8 and -0.6 as at K5 and K6. Above D = 32
    D_fc1's std carries a factor (32 / D)^(1/4), so that the fusion's
    unscaled logits, sums over D products of two hiddens, keep their spread
    at D = 32: wider, the softmax turns so sharp that a one-ulp bf16 flip of
    a hidden moves a fused row by several percent (Swin-Large stage 3, D =
    96: 104 of 12 M outputs past 2e-2 as drawn without it, none with it)."""
    import torch
    C, D = w["w_qkv"].shape[1], w[f"{keys[0]}_w1"].shape[0]
    std = {"w1": 2.26 / C ** 0.5 * min(1.0, (32 / D) ** 0.25), "w2": 0.566 / D ** 0.5,
           "b1": 0.1, "b2": 0.1}
    live = dict(w)
    for key in keys:
        for p, sd in std.items():
            t = w[f"{key}_{p}"]
            live[f"{key}_{p}"] = (torch.randn(t.shape, generator=g, device=t.device) * sd
                                  ).to(t.dtype)
    if "gate_v" in w:
        live["gate_v"] = torch.full_like(w["gate_v"], 0.8)
        live["gate_a"] = torch.full_like(w["gate_a"], -0.6)
    return live


def k4_faults(w, fuse_mask):
    """{fault: (weights, fuse_mask)} on which K4 computes what a K4 with that
    wiring fault would compute on the true ones."""
    swapped = dict(w)
    for kv, ka in (("s2v", "s2a"), ("sv", "sa")):
        for p in ("w1", "b1", "w2", "b2"):
            swapped[f"{kv}_{p}"], swapped[f"{ka}_{p}"] = w[f"{ka}_{p}"], w[f"{kv}_{p}"]
    zero = {k: w[k] * 0 for k in ("gate_v", "gate_a", "sv_w2", "sv_b2", "sa_w2", "sa_b2")}
    faults = {"fusion off": ({**w, "gate_v": zero["gate_v"], "gate_a": zero["gate_a"]},
                             fuse_mask),
              "gates swapped": ({**w, "gate_v": w["gate_a"], "gate_a": w["gate_v"]}, fuse_mask),
              "stream adapters swapped": (swapped, fuse_mask),
              "second adapter output dropped": ({**w, **{k: zero[k] for k in (
                  "sv_w2", "sv_b2", "sa_w2", "sa_b2")}}, fuse_mask)}
    if bool((fuse_mask != 0).any()):       # a grid of one window has no fusion mask
        faults["fusion mask ignored"] = (w, fuse_mask * 0)
    return faults


def check_k4_faults(name, args, kernel, plain, tol):
    """The K4 check fails where it must: K4 (`kernel`, either variant) run on
    the inputs of each fault of `k4_faults` (what a K4 with that fault
    computes) is held to its plain version on the true inputs, and must
    differ by more than the tolerance. Returns {fault: max |faulty kernel -
    plain| / max |plain|}."""
    import torch
    v, a, w, heads, bias, fuse_mask = args
    ref = _flat(plain(*args))
    scale = ref.abs().max().item()
    moved = {}
    for fault, (wf, fm) in k4_faults(w, fuse_mask).items():
        out = _flat(kernel(v, a, wf, heads, bias, fm))
        torch.cuda.synchronize()
        moved[fault] = (out - ref).abs().max().item() / scale
        if not moved[fault] > tol:
            fail(f"{name}: a K4 with '{fault}' passes the check ({moved[fault]:.4g} of "
                 f"max |plain| from the plain version, tol {tol})")
    log(f"  {name}: K4 with a fault vs plain (rel, must exceed {tol}): "
        + ", ".join(f"{k} {x:.4g}" for k, x in moved.items()))
    return moved


def phase_fusion_kernels(cfg, tower="Swin", odd=True, k4_tol=TOL_KERNEL):
    """K4, K5 and K6 at the shapes of `cfg` (Swin-Base, or Swin-Large with
    its adapter width 96 at every stage) fusion at B = 8, and with `odd` K6
    at one odd shape. `tower` names the tower in the rows' names; K4 is held
    at `k4_tol`."""
    import torch
    from stgcma_tpu_torch.ops import fused_attn as FA
    g = torch.Generator(device="cuda").manual_seed(SEED + 2)
    dev, bf = "cuda", torch.bfloat16
    sfu = sfu_rate()
    log(f"  special function units: {sfu / 1e12:.3f} T exps/s (16 x 132 SMs x max SM clock)")
    BT = B * cfg.num_ttokens
    gv = torch.tensor([0.8], dtype=bf, device=dev)
    ga = torch.tensor([-0.6], dtype=bf, device=dev)

    def hidden(*shape):
        return (torch.randn(*shape, generator=g, device=dev) * 0.7).to(bf)

    results = {"K4": [], "K5": [], "K6": []}
    ws = cfg.window_size
    for s in (0, 1):
        H, _ = cfg.stage_resolution(s)
        D = int(cfg.stage_dim(s) * cfg.adapter_ratios[s])
        R = BT * (H // ws) ** 2
        vh, ah = hidden(R, ws * ws, D), hidden(R, ws * ws, D)
        results["K5"].append(check_kernel(
            f"K5 {tower} stage {s} windows {(R, ws * ws, D)}", FA.win_fuse, FA.fuse_plain,
            (vh, ah, gv, ga), {}, fuse_bound(R, ws * ws, ws * ws, D, sfu),
            library_fuse(vh, ah, gv, ga)))
    for s in (0, 1):
        H, _ = cfg.stage_resolution(s)
        D = int(cfg.stage_dim(s) * cfg.adapter_ratios[s])
        vh, ah = hidden(BT, H * H, D), hidden(BT, H * H, D)
        with torch.inference_mode():
            results["K6"].append(check_kernel(
                f"K6 {tower} stage {s} full grid {(BT, H * H, D)}", FA.bidir_fuse,
                FA.fuse_plain,
                (vh, ah, gv, ga), {}, fuse_bound(BT, H * H, H * H, D, sfu),
                library_fuse(vh, ah, gv, ga)))
    if odd:
        Bo, Nv, Na, D = 3, 300, 170, 16        # the kernel's own tiling at ragged edges
        vh, ah = hidden(Bo, Nv, D), hidden(Bo, Na, D)
        results["K6"].append(check_kernel(
            f"K6 odd shape vh {(Bo, Nv, D)} ah {(Bo, Na, D)}", FA.bidir_fuse, FA.fuse_plain,
            (vh, ah, gv, ga), {}, fuse_bound(Bo, Nv, Na, D, sfu), library_fuse(vh, ah, gv, ga)))

    results["K4"] = k4_rows(cfg, g, sfu, int8=False, tower=tower, tol=k4_tol)
    return results


def k4_rows(cfg, g, sfu, int8, tower="Swin", tol=None, stage3_tol=None):
    """K4 (its int8 variant for `int8`) at stage 2 unshifted and shifted and
    stage 3 of `cfg`, the block's tower from `random_swin_ave` (quantized for
    int8) with live adapters and gates, and the five wiring faults; stage 3
    held at `stage3_tol` where given."""
    import torch
    from stgcma_tpu_torch.models.ave import random_swin_ave
    from stgcma_tpu_torch.nn.swin import backbone_statics
    from stgcma_tpu_torch.ops import swin_block as SB
    from stgcma_tpu_torch.ops.attention import gather_bias
    from stgcma_tpu_torch.ops.common import cast_tree
    dev, bf = "cuda", torch.bfloat16
    BT = B * cfg.num_ttokens
    kernel, plain = ((SB.swin_block_q, SB.swin_block_q_plain) if int8
                     else (SB.swin_block, SB.swin_block_plain))
    tol = tol or (TOL_KERNEL_Q if int8 else TOL_KERNEL)
    model = random_swin_ave(cfg, SEED, int8=int8)
    statics = backbone_statics(cfg)
    rows = []
    for s, i in ((2, 0), (2, 1), (3, 0)):       # stage 2 unshifted and shifted, stage 3
        st = statics[s][i]
        row_tol = stage3_tol if s == 3 and stage3_tol else tol
        blk = cast_tree(model.backbone.layers[s].blocks[i], bf).to(dev)
        index, attn_mask, fuse_mask = SB._geo_tensors(st.H, st.W, st.window_size,
                                                      st.shift_size, torch.device(dev))
        N, C = st.H * st.W, st.dim
        bias = gather_bias(blk.attn.relative_position_bias_table, index, st.num_heads, N)
        bias = (bias + attn_mask)[None].contiguous()
        w = live_k4_weights(SB.block_weights(blk), g)
        # residual streams at std 0.1: LN1 and LN2 make the block's inner
        # work the same at any scale, and the block's own terms, the fusion's
        # among them, set max |plain| rather than the residual passing through
        v = (torch.randn(BT, N, C, generator=g, device=dev) * 0.1).to(bf)
        a = (torch.randn(BT, N, C, generator=g, device=dev) * 0.1).to(bf)
        D = w["s2v_w1"].shape[0]
        name = (f"K4{' int8' if int8 else ''} {tower} stage {s} block {i} {(BT, N, C)} "
                f"h{st.num_heads} shift {st.shift_size} D {D}")
        args = (v, a, w, st.num_heads, bias, fuse_mask)
        with torch.inference_mode():
            floor = plain_noise_floor(plain, args, g)
            log(f"  {name}: the plain version moves {floor:.4g} of max |plain| when 0.01% of "
                f"v's elements move by one bf16 ulp")
            f5 = None
            if row_tol != tol:              # F5: kernel and plain against the block in fp32
                row_tol, f5 = f5_bar(name, kernel, plain, args, row_tol)
            row = check_kernel(name, kernel, plain, args, {},
                               block_k4_bound(BT, N, C, st.num_heads, D, sfu, int8,
                                              window=st.window_size ** 2),
                               library_k4(v, a, w, st.num_heads, bias, fuse_mask), row_tol)
            row["noise_floor_rel"] = floor
            if f5:
                row["f5"] = f5
            row["bound_fullgrid_ms"] = block_k4_bound(BT, N, C, st.num_heads, D, sfu, int8)[0]
            log(f"  {name}: full-grid bound {row['bound_fullgrid_ms']:.4f} ms")
            row["faults_rel"] = check_k4_faults(name, args, kernel, plain, row_tol)
            if row_tol != tol:              # the same block with a softer fusion softmax
                soft = {**w, **{f"{k}_w1": w[f"{k}_w1"] * 0.5 for k in ("s2v", "s2a", "sv", "sa")}}
                sargs = (v, a, soft, st.num_heads, bias, fuse_mask)
                floor = plain_noise_floor(plain, sargs, g)
                log(f"  {name}, D_fc1 halved: the plain version moves {floor:.4g} under the same "
                    f"flips")
                row["d_fc1_halved"] = check_kernel(f"{name}, D_fc1 halved", kernel, plain, sargs,
                                                   {}, (row["bound_ms"], row["bound_by"]), None,
                                                   tol)
        rows.append(row)
    return rows


def f5_bar(name, kernel, plain, args, cap):
    """ROADMAP F5: the kernel (int8 K4 at Swin-Large stage 3) and its bf16
    plain version, each against the same block's plain version in fp32 on
    the same inputs and int8 weights (bf16 values widened exactly). The
    kernel must be no further from it than F5_FACTOR x the plain version's
    distance d_p; it then holds the kernel-vs-plain row at (1 + F5_FACTOR)
    d_p (the triangle bound), no looser than `cap`. Returns (bar, the two
    distances)."""
    v, a, w = args[:3]
    w32 = {k: t.float() if t.is_floating_point() else t for k, t in w.items()}
    ref = _flat(plain(v.float(), a.float(), w32, *args[3:]))
    scale = ref.abs().max()
    d_k = ((_flat(kernel(*args)) - ref).abs().max() / scale).item()
    p = _flat(plain(*args))
    d_p = ((p - ref).abs().max() / scale).item()
    bar = min(cap, (1 + F5_FACTOR) * d_p * (scale / p.abs().max()).item())
    log(f"  {name}: F5, against the same block in fp32: kernel {d_k:.4g}, bf16 plain {d_p:.4g} "
        f"of max |fp32| (ratio {d_k / d_p:.3f}, must be <= {F5_FACTOR}); kernel vs plain held "
        f"at {bar:.4g} = min({cap}, (1 + {F5_FACTOR}) x {d_p:.4g} rescaled)")
    if not d_k <= F5_FACTOR * d_p:
        fail(f"{name}: the kernel sits {d_k:.4g} from the fp32 block, more than {F5_FACTOR} x "
             f"its plain version's {d_p:.4g}: a fault, not bf16 noise (ROADMAP F5)")
    return bar, {"kernel_vs_fp32": d_k, "plain_vs_fp32": d_p, "bar": bar}


def plain_noise_floor(plain, args, g, frac=1e-4):
    """max |plain(v') - plain(v)| / max |plain(v)|, v' = v with `frac` of its
    elements moved by one bf16 ulp: how far rounding noise at the block's
    input carries to its output, the floor under any kernel-vs-plain bar."""
    import torch
    v = args[0]
    moved = torch.rand(v.shape, generator=g, device=v.device) < frac
    v2 = torch.where(moved, (v.view(torch.int16) + 1).view(v.dtype), v)
    ref = _flat(plain(*args))
    return ((_flat(plain(v2, *args[1:])) - ref).abs().max() / ref.abs().max()).item()


def phase_int8_swin_kernels(cfg):
    """The kernels of the int8 Swin-Base fusion tower at B = 8: K2 at the
    stage 0-1 shifted windows (bias period nW) and the stage 0-2 temporal
    sites, K3 with erf-GELU at the stage 0-1 FFNs, K4's int8 variant."""
    import torch
    from stgcma_tpu_torch.ops import fused_attn as FA
    from stgcma_tpu_torch.ops import window
    g = torch.Generator(device="cuda").manual_seed(SEED + 3)
    dev = "cuda"
    T, ws = cfg.num_ttokens, cfg.window_size
    N = ws * ws
    rel = torch.from_numpy(window.relative_position_index(ws)).to(dev)
    t_idx = torch.from_numpy(window.temporal_relative_index(T)).to(dev)
    results = {"K2": [], "K3": []}
    sites = []
    for s in (0, 1):
        H, _ = cfg.stage_resolution(s)
        mask = torch.from_numpy(window.shift_attn_mask(H, H, ws, ws // 2)).to(dev)
        sites.append((f"stage {s} shifted windows", s, N, swin_bias(g, cfg.num_heads[s], N, rel,
                                                                    mask)))
    for s in (0, 1, 2):
        sites.append((f"stage {s} temporal", s, T, swin_bias(g, cfg.num_heads[s], T, t_idx)))
    for site, s, n, bm in sites:
        H, _ = cfg.stage_resolution(s)
        C, heads = cfg.stage_dim(s), cfg.num_heads[s]
        Bq = B * T * bm.shape[0] if n == N else B * H * H
        args, _ = make_block_inputs(g, Bq, n, C, heads, True)
        results["K2"].append(check_kernel(
            f"K2 Swin {site} {(Bq, n, C)} h{heads} period {bm.shape[0]}", FA.win_block_q,
            FA.win_block_q_plain, args + (heads,), {"bias": bm},
            block_bound(Bq, n, C, heads, True, bm.shape[0]),
            library_block(args, heads, True, bm)))
    for s in (0, 1):
        H, _ = cfg.stage_resolution(s)
        M, C = B * T * H * H, cfg.stage_dim(s)
        args = make_ffn_inputs(g, M, C)
        results["K3"].append(check_kernel(
            f"K3 Swin stage {s} FFN erf-GELU {(M, C)} hidden {4 * C}", FA.ffn_q, FA.ffn_q_plain,
            args + ("gelu",), {}, ffn_bound(M, C), library_ffn(args, "gelu")))
        del args
    results["K4"] = k4_rows(cfg, g, sfu_rate(), int8=True)
    return results


def clip_block_bound(BT, Nv, Na, C, heads, D, sfu, int8, grad=False):
    """K12 per call, both streams: qkv, proj and the FFN (hidden 4C) over the
    BT * (Nv + Na) rows (at the int8 rate in the int8 variant), the attention
    grams of each stream, the eight adapter products and both fusions on the
    tensor cores; one exp per attention and fusion gram entry on the special
    function units. Bytes: v, a read and both outputs written once, the tower
    weights (int8 with their bf16 scales in the int8 variant), the adapters."""
    M = BT * (Nv + Na)
    tower = 2 * M * C * 3 * C + 2 * M * C * C + 2 * 2 * M * C * 4 * C
    rest = (4 * BT * (Nv * Nv + Na * Na) * C + 8 * M * C * D + 2 * 3 * 2 * BT * Nv * Na * D)
    exps = BT * heads * (Nv * Nv + Na * Na) + 2 * BT * Nv * Na
    wbytes = (12 * C * C + 9 * C * 2 if int8 else 2 * 12 * C * C) + 2 * 8 * C * D
    return _bound(tower / (H100_INT8 if int8 else H100_BF16) + rest / H100_BF16, exps / sfu,
                  (2 * M * C * 2 + wbytes) / H100_BYTES, grad)


def tadapt_bound(R, T, C, heads, D, sfu, int8, grad=False):
    """K13 per call: qkv and proj over the R * T rows (int8 rate in the int8
    variant), the T x T grams, the two adapter products; x read and written
    once, the weights once."""
    M = R * T
    tower = 2 * M * C * 3 * C + 2 * M * C * C
    rest = 4 * R * T * T * C + 4 * M * C * D
    wbytes = (4 * C * C + 4 * C * 2 if int8 else 2 * 4 * C * C) + 2 * 2 * C * D
    return _bound(tower / (H100_INT8 if int8 else H100_BF16) + rest / H100_BF16,
                  R * heads * T * T / sfu, (2 * M * C * 2 + wbytes) / H100_BYTES, grad)


def _library_tower(w, int8):
    """A tower product from PyTorch's own calls: `F.linear`, or the
    row-quantized `torch._int_mm` for an int8 tower (fp32 out)."""
    import torch.nn.functional as F

    def tower(x, wk, sk, bk):
        if not int8:
            return F.linear(x, w[wk], w[bk])
        return library_qmm(x.reshape(-1, x.shape[-1]), w[wk], w[sk], w[bk]
                           ).view(*x.shape[:-1], -1)
    return tower


def _library_attn(x, w, heads, tower):
    """layer_norm -> qkv -> scaled_dot_product_attention -> proj, in x's dtype."""
    import torch.nn.functional as F
    B_, N, C = x.shape
    xn = F.layer_norm(x, (C,), w["ln1_w"], w["ln1_b"])
    q, k, v = tower(xn, "w_qkv", "s_qkv", "b_qkv").to(x.dtype).view(
        B_, N, 3, heads, C // heads).permute(2, 0, 3, 1, 4)
    o = F.scaled_dot_product_attention(q, k, v).transpose(1, 2).reshape(B_, N, C)
    return tower(o, "w_proj", "s_proj", "b_proj").to(x.dtype)


def library_k12(v, a, w, heads):
    """K12 from PyTorch's own calls (timed only): layer_norm, linear or
    `torch._int_mm`, scaled_dot_product_attention (scale 1 for the fusions),
    gelu and the sigmoid of QuickGELU."""
    import torch
    import torch.nn.functional as F
    int8 = "s_qkv" in w
    tower = _library_tower(w, int8)
    BT, Nv, C = v.shape

    def fuse_out(xv, xa, kv, ka, rv, ra):
        hv = F.gelu(F.linear(xv, w[f"{kv}_w1"], w[f"{kv}_b1"]))
        ha = F.gelu(F.linear(xa, w[f"{ka}_w1"], w[f"{ka}_b1"]))
        fv = hv + w["gate_v"] * F.scaled_dot_product_attention(hv, ha, ha, scale=1.0)
        fa = ha + w["gate_a"] * F.scaled_dot_product_attention(ha, hv, hv, scale=1.0)
        return (rv + xv + F.linear(fv, w[f"{kv}_w2"], w[f"{kv}_b2"]),
                ra + xa + F.linear(fa, w[f"{ka}_w2"], w[f"{ka}_b2"]))

    def run():
        vs, as_ = _library_attn(v, w, heads, tower), _library_attn(a, w, heads, tower)
        v1, a1 = fuse_out(vs, as_, "sv", "sa", v, a)
        x = torch.cat([v1.view(-1, C), a1.view(-1, C)])
        h = tower(F.layer_norm(x, (C,), w["ln2_w"], w["ln2_b"]), "w1", "s1", "b1")
        n = tower(h * torch.sigmoid(1.702 * h), "w2", "s2", "b2").to(v.dtype)
        vn, an = n[:BT * Nv].view(BT, Nv, C), n[BT * Nv:].view(BT, -1, C)
        return fuse_out(vn, an, "mv", "ma", v1, a1)
    return run


def library_k13(x, w, heads):
    import torch.nn.functional as F
    tower = _library_tower(w, "s_qkv" in w)

    def run():
        o = _library_attn(x, w, heads, tower)
        return x + F.linear(F.gelu(F.linear(o, w["ad_w1"], w["ad_b1"])), w["ad_w2"], w["ad_b2"])
    return run


def k12_faults(w):
    """{fault: weights} on which K12 computes what a K12 with that wiring
    fault would compute on the true ones."""
    def swap(src, pairs):
        out = dict(src)
        for k1, k2 in pairs:
            for p in ("w1", "b1", "w2", "b2"):
                out[f"{k1}_{p}"], out[f"{k2}_{p}"] = src[f"{k2}_{p}"], src[f"{k1}_{p}"]
        return out
    return {"fusion skipped": {**w, "gate_v": w["gate_v"] * 0, "gate_a": w["gate_a"] * 0},
            "gates swapped": {**w, "gate_v": w["gate_a"], "gate_a": w["gate_v"]},
            "S and MLP adapters swapped": swap(w, (("sv", "mv"), ("sa", "ma"))),
            "video and audio adapters swapped": swap(w, (("sv", "sa"), ("mv", "ma")))}


@contextlib.contextmanager
def second_ln_skipped():
    """K12's composition with its third LayerNorm launch (LN2; the first two
    are LN1 of the video and the audio rows) replaced by a copy."""
    from stgcma_tpu_torch.ops import clip_block as PCB
    real, calls = PCB._ln_bf16, []

    def faulty(x2, ln_w, ln_b, s, out=None):
        calls.append(1)
        if len(calls) != 3:
            return real(x2, ln_w, ln_b, s, out=out)
        return x2.clone() if out is None else out.copy_(x2)
    PCB._ln_bf16 = faulty
    try:
        yield
    finally:
        PCB._ln_bf16 = real
    if len(calls) != 3:
        fail(f"K12 made {len(calls)} LayerNorm launches, expected 3")


def check_k12_faults(name, args, kernel, plain, tol):
    """The K12 check fails where it must: K12 (`kernel`, either variant) with
    each wiring fault (run on the inputs of `k12_faults`, or with its second
    LayerNorm skipped) is held to its plain version on the true inputs, and
    must differ by more than the tolerance."""
    import torch
    v, a, w, heads = args
    ref = _flat(plain(*args))
    scale = ref.abs().max().item()
    moved = {}

    def hold(fault, out):
        torch.cuda.synchronize()
        moved[fault] = (_flat(out) - ref).abs().max().item() / scale
        if not moved[fault] > tol:
            fail(f"{name}: a K12 with '{fault}' passes the check ({moved[fault]:.4g} of "
                 f"max |plain| from the plain version, tol {tol})")
    for fault, wf in k12_faults(w).items():
        hold(fault, kernel(v, a, wf, heads))
    with second_ln_skipped():
        hold("second LN skipped", kernel(v, a, w, heads))
    log(f"  {name}: K12 with a fault vs plain (rel, must exceed {tol}): "
        + ", ".join(f"{k} {x:.4g}" for k, x in moved.items()))
    return moved


def phase_clip_block_kernels(cfg, tag=""):
    """K12 and K13, float and int8, at the shapes of `cfg` (CLIP ViT-B/16 or
    ViT-L/14) fusion at B = 8: the first block's tower from `random_clip_ave`
    (quantized for int8) with live adapters and gates; K12 once more with
    each of its wiring faults. `tag` prefixes the rows' names."""
    import torch
    from stgcma_tpu_torch.models.ave import random_clip_ave
    from stgcma_tpu_torch.ops import clip_block as PCB
    from stgcma_tpu_torch.ops.common import cast_tree
    from stgcma_tpu_torch.ops.quant import quantize_clip_tower
    g = torch.Generator(device="cuda").manual_seed(SEED + 4)
    dev, bf = "cuda", torch.bfloat16
    sfu = sfu_rate()
    C, heads, T = cfg.embed_dim, cfg.heads, cfg.num_frames
    Nv, Na, BT = cfg.num_patches + 1, cfg.num_patches_audio + 1, B * cfg.num_frames
    results = {"K12": [], "K13": []}

    def stream(*shape):
        # residual streams at std 0.1, as at K4: the LNs make the inner work
        # the same at any scale, and the block's own terms set max |plain|
        return (torch.randn(*shape, generator=g, device=dev) * 0.1).to(bf)

    for int8 in (False, True):
        # one block: the draws of block 0 come before those of any later block
        bb = random_clip_ave(dataclasses.replace(cfg, layers=1), SEED).backbone
        blk = cast_tree((quantize_clip_tower(bb) if int8 else bb).resblocks[0], bf).to(dev)
        tol = TOL_KERNEL_Q if int8 else TOL_KERNEL
        qtag = " int8" if int8 else ""
        w = live_k4_weights(PCB.block_weights(blk), g, [k for k, _ in PCB.ADAPTERS])
        D = w["sv_w1"].shape[0]
        kernel, plain = ((PCB.clip_fusion_block_q, PCB.fusion_block_q_plain) if int8
                         else (PCB.clip_fusion_block, PCB.fusion_block_plain))
        v, a = stream(BT, Nv, C), stream(BT, Na, C)
        name = f"K12{qtag} {tag}v {(BT, Nv, C)} a {(BT, Na, C)} h{heads} D {D}"
        args = (v, a, w, heads)
        with torch.inference_mode():
            row = check_kernel(name, kernel, plain, args, {},
                               clip_block_bound(BT, Nv, Na, C, heads, D, sfu, int8),
                               library_k12(v, a, w, heads), tol)
            row["faults_rel"] = check_k12_faults(name, args, kernel, plain, tol)
        results["K12"].append(row)
        del v, a, args

        kernel, plain = ((PCB.clip_tadapt_q, PCB.tadapt_q_plain) if int8
                         else (PCB.clip_tadapt, PCB.tadapt_plain))
        for site, adapter, R in (("video rows", blk.T_Adapter, B * Nv),
                                 ("audio rows", blk.T_Adapter_Audio, B * Na)):
            wt = live_k4_weights(PCB.tadapt_weights(blk.attn, blk.ln_1, adapter), g, ["ad"])
            x = stream(R, T, C)
            name = f"K13{qtag} {tag}{site} {(R, T, C)} h{heads} D {D}"
            with torch.inference_mode():
                row = check_kernel(name, kernel, plain, (x, wt, heads), {},
                                   tadapt_bound(R, T, C, heads, D, sfu, int8),
                                   library_k13(x, wt, heads), tol)
                # the T_Adapter is live: without it K13 returns x itself
                moved = (kernel(x, wt, heads).float() - x.float()).abs().max().item()
                scale = plain(x, wt, heads).float().abs().max().item()
            if not moved > tol * scale:
                fail(f"{name}: the T_Adapter moves x by {moved:.4g}, not beyond {tol} * "
                     f"{scale:.4g}: the check is blind to the kernel")
            row["adapter_moves_rel"] = moved / scale
            with torch.inference_mode():
                row["launches_per_call"] = check_launches(name, kernel, (x, wt, heads), True)
                if site == "video rows":
                    nxt = {**wt, **{k: kv_of_next_head(wt[k], C, heads)
                                    for k in ("w_qkv", "b_qkv", "s_qkv") if k in wt}}
                    row["faults_rel"] = check_t_faults(
                        name, lambda *a: kernel(*(a or (x, wt, heads))), plain(x, wt, heads),
                        tol, (x, nxt, heads))
            results["K13"].append(row)
    return results


def library_k14(x, w, heads, T, bias):
    """K14 from PyTorch's own calls (timed only): layer_norm, linear (or
    `torch._int_mm`), scaled_dot_product_attention over a permuted view of
    each token's T frames (the bias as a float mask), linear, gelu, linear."""
    import torch.nn.functional as F
    tower = _library_tower(w, "s_qkv" in w)
    BT, N, C = x.shape
    dh = C // heads
    mask = None if bias is None else bias.to(x.dtype)

    def run():
        qkv = tower(F.layer_norm(x, (C,), w["ln1_w"], w["ln1_b"]), "w_qkv", "s_qkv", "b_qkv")
        q, k, v = (t.reshape(-1, heads, T, dh) for t in qkv.to(x.dtype).view(
            BT // T, T, N, 3, heads, dh).permute(3, 0, 2, 4, 1, 5))     # (B * N, h, T, dh)
        o = F.scaled_dot_product_attention(q, k, v, attn_mask=mask)
        o = o.view(BT // T, N, heads, T, dh).permute(0, 3, 1, 2, 4).reshape(BT, N, C)
        o = tower(o, "w_proj", "s_proj", "b_proj")
        if "ad_w1" not in w:
            return o.to(x.dtype)
        h = F.gelu(F.linear(o.to(x.dtype), w["ad_w1"], w["ad_b1"]))
        return x + F.linear(h, w["ad_w2"], w["ad_b2"])
    return run


@contextlib.contextmanager
def k14_core_over_tokens():
    """K14's temporal product T run over token-contiguous tiles (each
    sequence T consecutive rows: T tokens of one frame, as K13's layout
    would have it) in place of frame-strided ones (the T frames of each
    token, N rows apart)."""
    from stgcma_tpu_torch.ops import clip_block as PCB
    real = PCB._tattn

    def faulty(a, sa, w, ws, bias, out, T, heads, s, tokens=0):
        return real(a, sa, w, ws, bias, out, T, heads, s)
    PCB._tattn = faulty
    try:
        yield
    finally:
        PCB._tattn = real


@contextlib.contextmanager
def k14_residual_rounded_twice():
    """K14's row-owning product R with K13's up epilogue, bf16(x + bf16(acc +
    b2)), in place of its own, bf16(x + (acc + b2))."""
    from stgcma_tpu_torch.ops import clip_block as PCB
    from stgcma_tpu_torch.ops import fused_attn as FA
    real = PCB._EPI_BF16_RESF
    PCB._EPI_BF16_RESF = FA._EPI_BF16_RES1
    try:
        yield
    finally:
        PCB._EPI_BF16_RESF = real


def share_moved(out, ref):
    """The share of outputs whose bits differ from the plain version's."""
    return float((out.float() != ref.float()).float().mean())


def check_k14_faults(name, args, kernel, plain, tol, bits):
    """The K14 check fails where it must: K14 with its temporal product over
    token-contiguous tiles (`k14_core_over_tokens`: each sequence T tokens of
    one frame) and K14 without its T_Adapter (the adapter's output weights
    zeroed: x itself comes out) differ from the plain version on the true
    inputs by more than the tolerance; with `bits` (the float variant) K14
    moves at most TOL_K14_MOVED of its outputs' bits from the plain
    version's, and K14 with its residual rounded twice (R's up epilogue
    given K13's rounding) more."""
    import torch
    x, w, heads, T = args
    ref = plain(*args)
    scale = ref.float().abs().max().item()
    no_adapter = {**w, "ad_w2": w["ad_w2"] * 0, "ad_b2": w["ad_b2"] * 0}
    runs = {"T over token-contiguous tiles": (k14_core_over_tokens, w),
            "T_Adapter skipped": (contextlib.nullcontext, no_adapter)}
    moved = {}
    for fault, (ctx, wf) in runs.items():
        with ctx():
            out = kernel(x, wf, heads, T)
        torch.cuda.synchronize()
        moved[fault] = (out.float() - ref.float()).abs().max().item() / scale
        if not moved[fault] > tol:
            fail(f"{name}: a K14 with '{fault}' passes the check ({moved[fault]:.4g} of "
                 f"max |plain| from the plain version, tol {tol})")
    if bits:
        own = share_moved(kernel(*args), ref)
        with k14_residual_rounded_twice():
            twice = share_moved(kernel(*args), ref)
        if not own <= TOL_K14_MOVED < twice:
            fail(f"{name}: K14 moves {own:.4g} of its outputs' bits from the plain version, "
                 f"K14 with its residual rounded twice {twice:.4g}: the bar {TOL_K14_MOVED} "
                 f"does not separate them")
        moved["outputs moved (share)"] = own
        moved["residual rounded twice (share of outputs moved)"] = twice
    log(f"  {name}: K14 with a fault vs plain (rel, must exceed {tol}; shares of outputs "
        f"moved against {TOL_K14_MOVED}): " + ", ".join(f"{k} {v:.4g}" for k, v in moved.items()))
    return moved


def phase_tv2_kernels(cfg, l14_cfg):
    """K14, float and int8, at the rows of CLIP ViT-B/16 fusion at B = 8 in
    the tower's layout (video (80, 197, 768), audio (80, 49, 768), T = 10)
    with a live T_Adapter, and its three wiring faults at the video rows;
    float at CLIP ViT-L/14's video rows (80, 257, 1024) h16; float with a
    (heads, T, T) bias and no adapter at Swin-Base stage 2's (80, 196, 512)
    h16 rows."""
    import torch
    from stgcma_tpu_torch.models.ave import random_clip_ave
    from stgcma_tpu_torch.ops import clip_block as PCB
    from stgcma_tpu_torch.ops.common import cast_tree
    from stgcma_tpu_torch.ops.quant import quantize_clip_tower
    g = torch.Generator(device="cuda").manual_seed(SEED + 7)
    dev, bf = "cuda", torch.bfloat16
    sfu = sfu_rate()
    rows = []

    def stream(*shape):
        return (torch.randn(*shape, generator=g, device=dev) * 0.1).to(bf)

    def block(c, int8):
        bb = random_clip_ave(dataclasses.replace(c, layers=1), SEED).backbone
        return cast_tree((quantize_clip_tower(bb) if int8 else bb).resblocks[0], bf).to(dev)

    T = cfg.num_frames
    for c, tag, int8s in ((cfg, "", (False, True)), (l14_cfg, "CLIP-L/14 ", (False,))):
        C, heads = c.embed_dim, c.heads
        sites = [("video", c.num_patches + 1)] + ([("audio", c.num_patches_audio + 1)]
                                                   if not tag else [])
        for int8 in int8s:
            blk = block(c, int8)
            kernel, plain = ((PCB.clip_tv2_q, PCB.tv2_q_plain) if int8
                             else (PCB.clip_tv2, PCB.tv2_plain))
            tol = TOL_KERNEL_Q if int8 else TOL_KERNEL
            for site, N in sites:
                adapter = blk.T_Adapter if site == "video" else blk.T_Adapter_Audio
                w = live_k4_weights(PCB.tadapt_weights(blk.attn, blk.ln_1, adapter), g, ["ad"])
                D = w["ad_w1"].shape[0]
                x = stream(B * T, N, C)
                name = (f"K14{' int8' if int8 else ''} {tag}{site} rows {(B * T, N, C)} "
                        f"h{heads} D {D}")
                args = (x, w, heads, T)
                with torch.inference_mode():
                    row = check_kernel(name, kernel, plain, args, {},
                                       tadapt_bound(B * N, T, C, heads, D, sfu, int8),
                                       library_k14(x, w, heads, T, None), tol)
                    row["launches_per_call"] = check_launches(name, kernel, args, True)
                    if site == "video" and not tag:
                        row["faults"] = check_k14_faults(name, args, kernel, plain, tol, not int8)
                rows.append(row)
    # a Swin-like temporal stage: a (heads, T, T) bias and no adapter
    C, heads, N = 512, 16, 196
    bb = random_clip_ave(dataclasses.replace(cfg, layers=1, embed_dim=C, heads=heads),
                         SEED).backbone
    blk = cast_tree(bb.resblocks[0], bf).to(dev)
    w = PCB.tadapt_weights(blk.attn, blk.ln_1, None)
    bias = torch.randn(heads, T, T, generator=g, device=dev)
    x = stream(B * T, N, C)
    with torch.inference_mode():
        rows.append(check_kernel(
            f"K14 bias {(heads, T, T)}, no adapter, rows {(B * T, N, C)} h{heads}", PCB.clip_tv2,
            PCB.tv2_plain, (x, w, heads, T), {"bias": bias},
            tadapt_bound(B * N, T, C, heads, 0, sfu, False), library_k14(x, w, heads, T, bias)))
    return {"K14": rows}


def k10_bound(Bk, Nq, Nk, D, sfu, grad=False):
    """One K10 call: q, k, v read and o written once; q.k^T and p.v on the
    tensor cores; one exp per logit on the special function units."""
    nbytes = 2 * Bk * (2 * Nq + 2 * Nk) * D
    return _bound(2 * 2 * Bk * Nq * Nk * D / H100_BF16, Bk * Nq * Nk / sfu, nbytes / H100_BYTES,
                  grad)


def k10_route_plain(vh, ah, gate_v, gate_a):
    """The K10 route of `cross_modal_fuse_flash` with the plain version in
    place of the kernel."""
    from stgcma_tpu_torch.ops import fused_attn as FA
    dt = vh.dtype
    return (vh + gate_v.to(dt) * FA.unscaled_attention_plain(vh, ah, ah),
            ah + gate_a.to(dt) * FA.unscaled_attention_plain(ah, vh, vh))


def phase_k10_kernels(cfg):
    """K10 at B = 8: the full-grid fusion through `cross_modal_fuse_flash`,
    asserted to take the K10 route (two K10 launches), against the same
    route with the plain version, at K6's odd shape vh (3, 300, 16), ah (3,
    170, 16) and at the stage grids of Swin-Base cut to 168^2, (80, 1764, 16)
    and (80, 441, 32); one K10 call (a2v) timed; and a K10 that applied the
    dh^-1/2 scale (run on q scaled by it) must fail the check."""
    import torch
    from stgcma_tpu_torch.ops import fused_attn as FA
    g = torch.Generator(device="cuda").manual_seed(SEED + 8)
    dev, bf = "cuda", torch.bfloat16
    sfu = sfu_rate()
    gv = torch.tensor([0.8], dtype=bf, device=dev)
    ga = torch.tensor([-0.6], dtype=bf, device=dev)
    BT = B * cfg.num_ttokens
    shapes = [(3, 300, 170, 16)]
    for s in range(len(cfg.depths)):
        H, _ = cfg.stage_resolution(s)
        shapes.append((BT, H * H, H * H, int(cfg.stage_dim(s) * cfg.adapter_ratios[s])))
    rows = []
    for Bk, Nv, Na, D in shapes:
        vh = (torch.randn(Bk, Nv, D, generator=g, device=dev) * 0.7).to(bf)
        ah = (torch.randn(Bk, Na, D, generator=g, device=dev) * 0.7).to(bf)
        name = f"K10 vh {(Bk, Nv, D)} ah {(Bk, Na, D)}"
        if FA.flash_fuse_route(Nv, Na, D) != "K10":
            fail(f"{name}: cross_modal_fuse_flash takes {FA.flash_fuse_route(Nv, Na, D)}, not K10")
        with torch.inference_mode():
            FA.reset_launches()
            out = _flat(FA.cross_modal_fuse_flash(vh, ah, gv, ga))
            torch.cuda.synchronize()
            if FA.unscaled_attention.launches != 2 or FA.bidir_fuse.launches:
                fail(f"{name}: the route launched K10 {FA.unscaled_attention.launches} times and "
                     f"K6 {FA.bidir_fuse.launches} times, expected 2 and 0")
            ref = _flat(k10_route_plain(vh, ah, gv, ga))
            route_err = (out - ref).abs().max().item() / ref.abs().max().item()
            if not route_err <= TOL_KERNEL:
                fail(f"{name}: the K10 route is {route_err:.4g} of max |plain| from the plain "
                     f"route, tol {TOL_KERNEL}")
            del out, ref

            def library(vh=vh, ah=ah):
                return torch.nn.functional.scaled_dot_product_attention(vh, ah, ah, scale=1.0)
            row = check_kernel(f"{name}, a2v", FA.unscaled_attention, FA.unscaled_attention_plain,
                               (vh, ah, ah), {}, k10_bound(Bk, Nv, Na, D, sfu), library)
            ref = FA.unscaled_attention_plain(vh, ah, ah).float()
            scaled = FA.unscaled_attention((vh * D ** -0.5).to(bf), ah, ah).float()
            torch.cuda.synchronize()
            moved = (scaled - ref).abs().max().item() / ref.abs().max().item()
        if not moved > TOL_KERNEL:
            fail(f"{name}: a K10 that applies the dh^-1/2 scale passes the check ({moved:.4g} of "
                 f"max |plain| from the plain version, tol {TOL_KERNEL})")
        log(f"  {name}: the route (both directions and the gated adds) {route_err:.4g} of max "
            f"|plain| from the plain route; K10 with the dh^-1/2 scale vs plain {moved:.4g} (rel, "
            f"must exceed {TOL_KERNEL})")
        row.update({"route_rel_err": route_err, "faults_rel": {"dh^-1/2 scale applied": moved}})
        rows.append(row)
        del vh, ah, ref, scaled
    return {"K10": rows}


# ---------------------------------------------------------------------------
# phase 4: the slices
# ---------------------------------------------------------------------------

def phase_avs_kernels(cfg):
    """Every kernel of the AVS path (Swin-Large fusion, T = 5 frames, B = 8:
    40 frames a stream) at the shapes it gives them: K1 at the stage 0-1
    shifted windows and temporal sites (5 tokens: one 16-key tile, 11 keys
    masked), K5 and K6 at stages 0-1 and K4 at stage 2 (unshifted and
    shifted) and stage 3 with its wiring faults (`phase_fusion_kernels`),
    K7 at the stage-0 FFN, the K8 site (`wmsa_qkv`, one launch) at the
    stage 2-3 temporal sites, and K9 at every norm of a stream."""
    import torch
    from stgcma_tpu_torch.tools import bench_parts
    from stgcma_tpu_torch.ops import fused_attn as FA
    from stgcma_tpu_torch.ops import window
    tower = "Swin-Large AVS"
    results = phase_fusion_kernels(cfg, tower=tower, odd=False, k4_tol=TOL_K4_LARGE)
    g = torch.Generator(device="cuda").manual_seed(SEED + 9)
    dev, bf = "cuda", torch.bfloat16
    T = cfg.num_ttokens
    results["K1"] = k1_swin_rows(cfg, g, tower, (0, 1), (0, 1))
    t_idx = torch.from_numpy(window.temporal_relative_index(T)).to(dev)
    results["K8"] = []
    for s in (2, 3):
        H, _ = cfg.stage_resolution(s)
        C, heads = cfg.stage_dim(s), cfg.num_heads[s]
        bm = swin_bias(g, heads, T, t_idx)[0]
        qkv = (torch.randn(B * H * H, T, 3 * C, generator=g, device=dev)).to(bf)
        args = (qkv, bm, heads)
        name = f"K8 wmsa_qkv {tower} stage {s} temporal T={T} {tuple(qkv.shape)} h{heads}"
        row = check_kernel(name, FA.wmsa_qkv, FA.wmsa_qkv_plain, args, {},
                           wmsa_bound(B * H * H * heads, T, C // heads, heads),
                           library_wmsa_qkv(*args))
        row["graph_ms"] = bench_parts.graph_ms(lambda a=args: FA.wmsa_qkv(*a))
        row["launches_per_call"] = check_one_launch(name, FA.wmsa_qkv, args, "stg_attn_core")
        log(f"  {name}: device alone (CUDA graph) {row['graph_ms']:.4f} ms")
        results["K8"].append(row)
    H0, _ = cfg.stage_resolution(0)          # the one FFN whose hidden reaches the K7 route
    results["K7"] = [k7_row(g, f"K7 {tower} stage 0 FFN", B * T * H0 * H0, cfg.stage_dim(0))]
    results["K9"] = k9_rows(cfg, g, f"{tower} ")
    return results


def k8_site_row(g, name, qkv, bm, heads, faults=True):
    """The K8 site (`wmsa_qkv`: the packed qkv in, merged heads out) at one
    shape with its bias `bm` (P, N, N), against its plain version, with its
    device time alone and its one launch a call; with `faults`, once more
    with every head's bias read at head 0, which must fail the check."""
    from stgcma_tpu_torch.tools import bench_parts
    from stgcma_tpu_torch.ops import fused_attn as FA
    B_, n, C3 = qkv.shape
    dh = C3 // 3 // heads
    args = (qkv, bm, heads)
    row = check_kernel(name, FA.wmsa_qkv, FA.wmsa_qkv_plain, args, {},
                       wmsa_bound(B_ * heads, n, dh, bm.shape[0]), library_wmsa_qkv(*args))
    row["graph_ms"] = bench_parts.graph_ms(lambda a=args: FA.wmsa_qkv(*a))
    row["launches_per_call"] = check_one_launch(name, FA.wmsa_qkv, args, "stg_attn_core")
    if faults:
        head0 = bm.view(-1, heads, n, n)[:, :1].expand(-1, heads, n, n).reshape(bm.shape)
        row["faults"] = check_faults(name, FA.wmsa_qkv, FA.wmsa_qkv_plain, args, {
            "every head's bias at head 0": (qkv, head0.contiguous(), heads)})
    log(f"  {name}: device alone (CUDA graph) {row['graph_ms']:.4f} ms")
    return row


def int8_matmul_plain(x, wq, ws, bias):
    """`int8_matmul`'s arithmetic in plain torch on the card: the same row
    quantization, the exact int8 sums in float64, acc * scale * ws + bias in
    fp32, rounded to x's dtype."""
    import torch
    xf = x.float()
    sx = torch.clamp_min(xf.abs().amax(dim=-1, keepdim=True) / 127.0, 1e-12)
    xq = torch.clamp(torch.round(xf / sx), -127, 127)
    acc = torch.matmul(xq.double(), wq.double().t()).float()
    return (acc * sx * ws.float() + bias.float()).to(x.dtype)


def int8_matmul_rows(g, cfg, tower):
    """`ops/quant.py::int8_matmul` (csrc/gemm.cu's int8 product behind torch's
    row quantization) at the qkv and proj products around the K8 site of the
    int8 tower's stages with more heads than K2 takes: the temporal site and
    the nega stream's windows both give B * T * H * W rows of C."""
    import torch
    from stgcma_tpu_torch.ops.fused_attn import block_kernel_route
    from stgcma_tpu_torch.ops.quant import int8_matmul, quantize_weight
    bf = torch.bfloat16
    rows = []
    for s in range(cfg.num_layers):
        if block_kernel_route(cfg.num_heads[s]):
            continue
        H, _ = cfg.stage_resolution(s)
        M, C = B * cfg.num_ttokens * H * H, cfg.stage_dim(s)
        x = torch.randn(M, C, generator=g, device="cuda").to(bf)
        for prod, N in (("qkv", 3 * C), ("proj", C)):
            wq, ws = quantize_weight(torch.randn(N, C, generator=g, device="cuda") * 0.02)
            args = (x, wq, ws.to(bf), (torch.randn(N, generator=g, device="cuda") * 0.02).to(bf))
            t_ops = 2 * M * N * C / H100_INT8
            t_bytes = (M * C * 2 + M * N * 2 + N * C + N * 4) / H100_BYTES
            bound = (1e3 * max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes")
            rows.append(check_kernel(
                f"int8_matmul {tower} stage {s} {prod} {(M, N, C)}", int8_matmul,
                int8_matmul_plain, args, {}, bound,
                lambda a=args: library_qmm(a[0], a[1], a[2], a[3]).to(bf)))
            del args
    return rows


def phase_avqa_kernels(cfg):
    """Every kernel of the AVQA paths (Swin-Large fusion, T = 10 frames, B = 8:
    80 frames a stream) at the shapes no other row holds: the K8 site at the
    nega stream's windows (stage 2 shifted: 320 windows, the bias of period
    4 windows x 24 heads with the shift mask; stage 3: one unshifted window
    a frame, 48 heads), with its fault; K1 at the stage 0-1 shifted windows
    and T = 10 temporal sites; and the int8 tower: K2 at the same four
    sites, K3 (erf-GELU) at the stage 0-1 FFNs and at the nega stream's
    stage 2-3 FFNs (C = 768 / 1536: the int8 tower takes K3 at every FFN
    outside K4, the nega stream's included), K4's int8 variant at stage 2
    (unshifted and shifted) and stage 3 with its five wiring faults, and
    `int8_matmul` at the stage 2-3 qkv and proj around the K8 site."""
    import torch
    from stgcma_tpu_torch.ops import fused_attn as FA
    from stgcma_tpu_torch.ops import window
    tower = "Swin-Large AVQA"
    g = torch.Generator(device="cuda").manual_seed(SEED + 10)
    dev, bf = "cuda", torch.bfloat16
    T, ws = cfg.num_ttokens, cfg.window_size
    N = ws * ws
    rel = torch.from_numpy(window.relative_position_index(ws)).to(dev)
    t_idx = torch.from_numpy(window.temporal_relative_index(T)).to(dev)
    results = {"K1": k1_swin_rows(cfg, g, tower, (0, 1), (0, 1)), "K8": []}
    for s, shift in ((2, ws // 2), (3, 0)):          # the nega stream's K8 windows
        H, _ = cfg.stage_resolution(s)
        if H <= ws:                                   # a window as large as the map: unshifted
            shift = 0
        C, heads = cfg.stage_dim(s), cfg.num_heads[s]
        mask = (torch.from_numpy(window.shift_attn_mask(H, H, ws, shift)).to(dev) if shift
                else None)
        bm = swin_bias(g, heads, N, rel, mask).reshape(-1, N, N).contiguous()
        qkv = torch.randn(B * T * (H // ws) ** 2, N, 3 * C, generator=g, device=dev).to(bf)
        results["K8"].append(k8_site_row(
            g, f"K8 wmsa_qkv {tower} nega stage {s} windows shift {shift} {tuple(qkv.shape)} "
               f"h{heads} period {bm.shape[0]}", qkv, bm, heads))
        del qkv
    # the int8 tower: K2 at the K1 sites of stages 0-1
    results["K2"] = []
    sites = []
    for s in (0, 1):
        H, _ = cfg.stage_resolution(s)
        mask = torch.from_numpy(window.shift_attn_mask(H, H, ws, ws // 2)).to(dev)
        sites.append((f"stage {s} shifted windows", s, N,
                      swin_bias(g, cfg.num_heads[s], N, rel, mask)))
        sites.append((f"stage {s} temporal T={T}", s, T, swin_bias(g, cfg.num_heads[s], T, t_idx)))
    for site, s, n, bm in sites:
        H, _ = cfg.stage_resolution(s)
        C, heads = cfg.stage_dim(s), cfg.num_heads[s]
        Bq = B * T * bm.shape[0] if n == N else B * H * H
        args, _ = make_block_inputs(g, Bq, n, C, heads, True)
        results["K2"].append(check_kernel(
            f"K2 {tower} {site} {(Bq, n, C)} h{heads} period {bm.shape[0]}", FA.win_block_q,
            FA.win_block_q_plain, args + (heads,), {"bias": bm},
            block_bound(Bq, n, C, heads, True, bm.shape[0]),
            library_block(args, heads, True, bm)))
        del args
    results["K2"] += int8_matmul_rows(g, cfg, f"{tower} int8")
    results["K3"] = []
    for s in range(cfg.num_layers):                   # stages 0-1, and the nega stream's 2-3
        H, _ = cfg.stage_resolution(s)
        M, C = B * T * H * H, cfg.stage_dim(s)
        args = make_ffn_inputs(g, M, C)
        results["K3"].append(check_kernel(
            f"K3 {tower}{' nega' if s > 1 else ''} stage {s} FFN erf-GELU {(M, C)} hidden "
            f"{4 * C}", FA.ffn_q, FA.ffn_q_plain, args + ("gelu",), {}, ffn_bound(M, C),
            library_ffn(args, "gelu")))
        del args
    results["K4"] = k4_rows(cfg, g, sfu_rate(), int8=True, tower=tower,
                            stage3_tol=TOL_K4Q_LARGE)
    return results


def phase_l14_int8_kernels(cfg):
    """The int8 CLIP ViT-L/14 tower's K2 and K3 at the shapes no other row
    holds, B = 8: K2 at the video and audio temporal sites (2056 / 512, 10,
    1024) h16 and the audio spatial site (80, 64, 1024) (the video spatial
    site is `phase_l14_kernels`'), K3 (QuickGELU, a 20560 x 4096 fp32 hidden)
    at the video and audio rows (20560 / 5120, 1024)."""
    import torch
    from stgcma_tpu_torch.ops import fused_attn as FA
    g = torch.Generator(device="cuda").manual_seed(SEED + 11)
    C, heads, T = cfg.embed_dim, cfg.heads, cfg.num_frames
    Nv, Na = cfg.num_patches + 1, cfg.num_patches_audio + 1
    results = {"K2": [], "K3": []}
    for site, Bq, N in (("video temporal", B * Nv, T), ("audio temporal", B * Na, T),
                        ("audio spatial", B * T, Na)):
        args, _ = make_block_inputs(g, Bq, N, C, heads, True)
        results["K2"].append(check_kernel(
            f"K2 CLIP-L/14 {site} {(Bq, N, C)} h{heads}", FA.win_block_q, FA.win_block_q_plain,
            args + (heads,), {}, block_bound(Bq, N, C, heads, True, 0),
            library_block(args, heads, True)))
        del args
    for site, M in (("video", B * T * Nv), ("audio", B * T * Na)):
        args = make_ffn_inputs(g, M, C)
        results["K3"].append(check_kernel(
            f"K3 CLIP-L/14 {site} {(M, C)} hidden {4 * C}", FA.ffn_q, FA.ffn_q_plain,
            args + ("quick_gelu",), {}, ffn_bound(M, C), library_ffn(args, "quick_gelu")))
        del args
    return results


@contextlib.contextmanager
def environment(values):
    """The environment variables `values` ({name: str}) set for the block,
    each restored after it: the port's switches, read at call time."""
    old = {k: os.environ.get(k) for k in values}
    os.environ.update(values)
    try:
        yield
    finally:
        for k, val in old.items():
            if val is None:
                del os.environ[k]
            else:
                os.environ[k] = val


def clip_switches(task):
    """The two switches of the fused CLIP block on for a task whose name has
    `_fused_`, STGCMA_QFUSE_ADAPTERS (K11) for one with `_qfuse_`, STGCMA_TV2
    (K14) for one with `_tv2_`, each off for any other task."""
    want = {**{k: "_fused_" in task for k in CLIP_SWITCHES}, QFUSE: "_qfuse_" in task,
            TV2: "_tv2_" in task}
    return environment({k: "1" if on else "0" for k, on in want.items()})


def predict(srv, task, batch):
    with clip_switches(task):
        return srv.predict(task, batch)


def drive(srv, requests, want, smi):
    """The main path of each task: every launch count set to 0 just before a
    request and read just after; B = 8 logits finite and of the expected
    shape. Returns ({kernel: launches summed over all requests}, {task:
    clips/s}, {task: the last request's logits})."""
    import numpy as np
    from stgcma_tpu_torch.ops import fused_attn as FA
    totals = {k: 0 for k in KERNELS}
    clips, last = {}, {}
    for task, (reqs, shape) in requests.items():
        times = []
        for i, req in enumerate(reqs):
            FA.reset_launches()
            t1 = time.perf_counter()
            out = predict(srv, task, req)
            times.append(time.perf_counter() - t1)
            got = launches()
            if got != want[task]:
                fail(f"{task} request {i}: launches {got}, expected {want[task]} per forward")
            for k in KERNELS:
                totals[k] += got[k]
            if out.shape != shape or not np.isfinite(out).all():
                fail(f"{task}: logits of shape {out.shape}, finite={np.isfinite(out).all()}")
        steady = sorted(times[1:])
        med = steady[len(steady) // 2]
        clips[task] = B / med
        last[task] = out
        log(f"  {task}: {len(reqs)} requests of B={B}, logits {out.shape} finite; "
            f"launches per forward {want[task]}; first request {times[0] * 1e3:.1f} ms, "
            f"median of the other {len(steady)} {med * 1e3:.2f} ms (min {steady[0] * 1e3:.2f}, "
            f"max {steady[-1] * 1e3:.2f}) = {clips[task]:.2f} clips/s on {smi}")
    return totals, clips, last


def check_against_cpu(srv, cpu, one):
    """B = 1: the card against the same port model on the CPU (plain
    versions). Returns {task: the card's B = 1 logits}."""
    import numpy as np
    cards = {}
    for task in cpu.tasks():
        t1 = time.perf_counter()
        ref = predict(cpu, task, one)
        cpu_s = time.perf_counter() - t1
        got = predict(srv, task, one)
        err = float(np.abs(got - ref).max())
        scale = float(np.abs(ref).max())
        if not err <= TOL_SLICE * scale:
            fail(f"{task} B=1: max |card - cpu| = {err:.4g} > {TOL_SLICE} * {scale:.4g}")
        log(f"  {task} B=1 card vs CPU: max_abs_err {err:.4g} (max |cpu| {scale:.4g}, "
            f"tol {TOL_SLICE} rel; CPU forward {cpu_s:.1f} s)")
        cards[task] = got
    return cards


def live_fusion_adapters_(model, seed):
    """In place: every block's four fusion adapters (S_Adapter2, S_Adapter
    and their audio twins) and gates drawn by `live_k4_weights`, so that the
    exchange moves the logits well beyond the card-vs-CPU tolerance (with
    `random_swin_ave`'s N(0, 0.02) adapters it does not). Returns the model."""
    import torch
    from stgcma_tpu_torch.ops.swin_block import block_weights
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for layer in model.backbone.layers:
            for blk in layer.blocks:
                w = block_weights(blk)
                for k, t in live_k4_weights(w, g).items():
                    if t is not w[k]:
                        w[k].copy_(t)
    return model


def live_clip_adapters_(model, seed):
    """In place: every CLIP block's six adapters (the four fusion adapters
    and both T_Adapters) and gates drawn by `live_k4_weights`, so that the
    exchange and the temporal adapters move the logits well beyond the
    card-vs-CPU tolerance (`random_clip_ave` draws the gates N(0, 0.5) but
    every adapter linear N(0, 0.02)). Returns the model."""
    import torch
    from stgcma_tpu_torch.ops import clip_block as PCB
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for blk in model.backbone.resblocks:
            sets = [(PCB.block_weights(blk), [k for k, _ in PCB.ADAPTERS])]
            sets += [(PCB.tadapt_weights(blk.attn, blk.ln_1, ad), ["ad"])
                     for ad in (blk.T_Adapter, blk.T_Adapter_Audio)]
            for w, keys in sets:
                for k, t in live_k4_weights(w, g, keys).items():
                    if t is not w[k]:
                        w[k].copy_(t)
    return model


def zero_gates_(m):
    if hasattr(m, "gate_v"):
        m.gate_v.zero_()
        m.gate_a.zero_()


def check_fusion_is_live(srv, cfg, model, task, one, card, add=None, zero_=zero_gates_,
                         what="the gates"):
    """The B = 1 check sees the exchange: the same model with every gate
    zeroed (or with `zero_` applied to each of its modules: `what`) must move
    the card's logits beyond the card-vs-CPU tolerance. `add`: the server's
    method that takes the model (`srv.add_ave` if none)."""
    import copy
    import numpy as np
    import torch
    zero = copy.deepcopy(model)
    with torch.no_grad():
        for m in zero.modules():
            zero_(m)
    name = f"{task}_{zero_.__name__}"
    (add or srv.add_ave)(name, cfg, zero)
    move = np.abs(predict(srv, name, one) - card)
    moved, scale = float(move.max()), float(np.abs(card).max())
    if not moved > TOL_SLICE * scale:
        fail(f"{task} B=1: zeroing {what} moves the card's logits by {moved:.4g}, not "
             f"beyond {TOL_SLICE} * {scale:.4g}: the check is blind to them")
    log(f"  {task} B=1 with {what} zeroed: logits move {moved:.6g} at most, "
        f"{float(move.mean()):.6g} on average, on the card ({moved / scale:.4g} of max "
        f"|logit|, must exceed {TOL_SLICE})")


def clip_batch(cfg, rng, b):
    """One request of b clips for a CLIP AVE: fbank audio and frames, fp32."""
    import numpy as np
    T, n = cfg.num_frames, cfg.input_resolution
    return {"a": rng.randn(b, T, cfg.audio_tdim, cfg.audio_fdim).astype(np.float32),
            "v": rng.randn(b, T, n, n, 3).astype(np.float32)}


def phase_clip_slice(cfg, smi):
    """CLIP ViT-B/16 fusion, bf16 and int8 towers, each in the default
    configuration (K1, or K2 + K3), in the fused-block one (K13 + K12) and
    with the transpose-free temporal stage (K14 at the temporal sites), and
    the int8 tower with the adapter-fused kernels (K11 alone)."""
    import numpy as np
    from stgcma_tpu_torch.models.ave import random_clip_ave
    from stgcma_tpu_torch.nn.clip_vit import launches_per_forward
    from stgcma_tpu_torch.ops.quant import quantize_clip_tower
    from stgcma_tpu_torch.serving import MultiTaskServer

    t0 = time.perf_counter()
    model = live_clip_adapters_(random_clip_ave(cfg, SEED), SEED)
    model_q = live_clip_adapters_(random_clip_ave(cfg, SEED), SEED)
    model_q.backbone = quantize_clip_tower(model_q.backbone)
    models = {"ave29_bf16": model, "ave29_int8": model_q,
              "ave29_clip_fused_bf16": model, "ave29_clip_fused_int8": model_q,
              "ave29_clip_qfuse_int8": model_q,
              "ave29_clip_tv2_bf16": model, "ave29_clip_tv2_int8": model_q}
    srv = MultiTaskServer(device="cuda")
    cpu = MultiTaskServer(device="cpu")
    for task, m in models.items():
        srv.add_clip_ave(task, cfg, m)
        cpu.add_clip_ave(task, cfg, m)
    log(f"  set-up: random weights with live adapters and gates, int8 tower, server on the "
        f"card: {time.perf_counter() - t0:.1f} s; tasks {srv.tasks()}")

    rng = np.random.RandomState(SEED)

    def batch(b):
        return clip_batch(cfg, rng, b)

    shape = (B * cfg.num_frames, cfg.label_dim)
    reqs = [batch(B) for _ in range(4)]          # the same requests for every task
    requests = {task: (reqs, shape) for task in models}
    # 4 attention sites (temporal/spatial x video/audio) and 2 FFNs a block:
    # 48 K1, or 48 K2 + 24 K3, a forward at 12 layers; fused: the 2 temporal
    # stages in K13 and the rest of the block in K12, and no K1, K2 or K3;
    # qfuse: the 6 sites of a block in K11 (2 qd, 2 qh, 2 ffn_qh), no K2 or K3;
    # tv2: the 2 temporal sites of a block in K14, the others as by default
    L = cfg.layers
    none = {k: 0 for k in KERNELS}
    want = {"ave29_bf16": {**none, "K1": 4 * L},
            "ave29_int8": {**none, "K2": 4 * L, "K3": 2 * L},
            "ave29_clip_fused_bf16": {**none, "K13": 2 * L, "K12": L},
            "ave29_clip_fused_int8": {**none, "K13": 2 * L, "K12": L},
            "ave29_clip_qfuse_int8": {**none, "K11": 6 * L},
            "ave29_clip_tv2_bf16": {**none, "K14": 2 * L, "K1": 2 * L},
            "ave29_clip_tv2_int8": {**none, "K14": 2 * L, "K2": 2 * L, "K3": 2 * L}}
    for task, w in want.items():                 # the policy functions say the same
        with clip_switches(task):
            derived = launches_per_forward(cfg, quantized=task.endswith("int8"))
        if {k: n for k, n in w.items() if n} != derived:
            fail(f"{task}: launches_per_forward gives {derived}, expected {w}")
    totals, clips, last = drive(srv, requests, want, smi)
    for task, base in (("ave29_clip_fused_bf16", "ave29_bf16"),   # card vs card: against
                       ("ave29_clip_fused_int8", "ave29_int8"),   # the default configuration
                       ("ave29_clip_qfuse_int8", "ave29_int8"),
                       ("ave29_clip_tv2_bf16", "ave29_bf16"),
                       ("ave29_clip_tv2_int8", "ave29_int8")):
        hold_logits(task, base, last, clips)
    one = batch(1)
    cards = check_against_cpu(srv, cpu, one)
    for task, m in models.items():
        check_fusion_is_live(srv, cfg, m, task, one, cards[task], add=srv.add_clip_ave)
    return totals, clips


def hold_logits(task, base, last, clips):
    """Card vs card: the last B = 8 logits of `task` within TOL_FUSED of those
    of `base`, the same model in the default configuration."""
    import numpy as np
    ref, got = last[base], last[task]
    err, scale = float(np.abs(got - ref).max()), float(np.abs(ref).max())
    if not err <= TOL_FUSED * scale:
        fail(f"{task} B={B}: max |{task} - {base}| = {err:.4g} > {TOL_FUSED} * {scale:.4g}")
    log(f"  {task} B={B} against {base} on the card: max_abs_err {err:.4g} (max |{base}| "
        f"{scale:.4g}, tol {TOL_FUSED} rel); {clips[task]:.2f} against {clips[base]:.2f} clips/s")


def phase_clip_l14_slice(cfg, smi, cpu_layers=2):
    """CLIP ViT-L/14 fusion (257 video and 64 audio tokens, 16 heads, C =
    1024), bf16 and with the int8 tower (`quantize_clip_tower`), each in the
    default configuration (K1, or K2 + K3, at all four sites, the spatial
    video site through the key-streaming attention core) and in the
    fused-block one (K13 + K12, whose video attention streams too); exact
    launches from `launches_per_forward`, fused held against default on the
    card. The B = 1 check against the CPU runs the same four tasks on a model
    cut to `cpu_layers` layers: at full depth the plain versions' forward
    costs more than the rest of this script."""
    from stgcma_tpu_torch.models.ave import random_clip_ave
    from stgcma_tpu_torch.nn.clip_vit import launches_per_forward
    from stgcma_tpu_torch.ops.quant import quantize_clip_tower
    from stgcma_tpu_torch.serving import MultiTaskServer
    import numpy as np
    t0 = time.perf_counter()
    cut_cfg = dataclasses.replace(cfg, layers=cpu_layers)
    models, cuts = {}, {}
    for dt in ("bf16", "int8"):
        for c, into in ((cfg, models), (cut_cfg, cuts)):
            m = live_clip_adapters_(random_clip_ave(c, SEED), SEED)
            if dt == "int8":
                m.backbone = quantize_clip_tower(m.backbone)
            into[dt] = m
    srv, cpu = MultiTaskServer(device="cuda"), MultiTaskServer(device="cpu")
    tasks = ("ave29_clip_l14_bf16", "ave29_clip_l14_fused_bf16", "ave29_clip_l14_int8",
             "ave29_clip_l14_fused_int8")
    for task in tasks:
        dt = task[-4:]
        srv.add_clip_ave(task, cfg, models[dt])
        for server in (srv, cpu):          # the switches follow `_fused_` in the name
            server.add_clip_ave(f"{task}_depth{cpu_layers}", cut_cfg, cuts[dt])
    log(f"  set-up: random weights with live adapters and gates, int8 tower, server on the "
        f"card: {time.perf_counter() - t0:.1f} s")
    rng = np.random.RandomState(SEED)
    reqs = [clip_batch(cfg, rng, B) for _ in range(3)]
    requests = {task: (reqs, (B * cfg.num_frames, cfg.label_dim)) for task in tasks}
    want = {}
    for task in tasks:
        with clip_switches(task):
            want[task] = {**{k: 0 for k in KERNELS},
                          **launches_per_forward(cfg, quantized=task.endswith("int8"))}
    totals, clips, last = drive(srv, requests, want, smi)
    hold_logits(tasks[1], tasks[0], last, clips)
    hold_logits(tasks[3], tasks[2], last, clips)
    check_against_cpu(srv, cpu, clip_batch(cfg, rng, 1))
    return totals, clips


def phase_clip_multimodal_slice(cfg, smi):
    """CLIP ViT-B/16 in `multimodal` mode (two streams, no exchange) at full
    width, bf16, depth cut to `cfg.layers`: K1 at the temporal and spatial
    site of each stream, none of K12/K13; B = 1 card vs CPU."""
    import numpy as np
    from stgcma_tpu_torch.models.ave import random_clip_ave
    from stgcma_tpu_torch.serving import MultiTaskServer
    task = "ave29_clip_mm_bf16"
    model = random_clip_ave(cfg, SEED)
    srv, cpu = MultiTaskServer(device="cuda"), MultiTaskServer(device="cpu")
    srv.add_clip_ave(task, cfg, model)
    cpu.add_clip_ave(task, cfg, model)
    rng = np.random.RandomState(SEED)

    def batch(b):
        return clip_batch(cfg, rng, b)

    requests = {task: ([batch(B) for _ in range(3)], (B * cfg.num_frames, cfg.label_dim))}
    want = {task: {**{k: 0 for k in KERNELS}, "K1": 4 * cfg.layers}}
    totals, clips, _ = drive(srv, requests, want, smi)
    check_against_cpu(srv, cpu, batch(1))
    return totals, clips


def phase_swin_slice(cfg, smi, int8=False, preset="", cpu_depths=None, task=None):
    """A Swin AVE-29 task (`preset`: "" for Swin-Base, "large_" for Swin-Large;
    `task`: the task's name, if not the one these make)
    through MultiTaskServer, exact launches, the B = 1 logits against the
    CPU (with `cpu_depths`, of the same configuration cut to those depths,
    where the full one's plain forward costs too much), and for a fusion
    model a check that zeroing the gates moves the card's logits."""
    import numpy as np
    from stgcma_tpu_torch.models.ave import random_swin_ave
    from stgcma_tpu_torch.nn.swin import launches_per_forward
    from stgcma_tpu_torch.serving import MultiTaskServer

    mode = {"multimodal": "mm", "fusion": "fusion", "videoonly": "video",
            "audioonly": "audio"}[cfg.ftmode]
    task = task or f"ave29_swin_{preset}{mode}_{'int8' if int8 else 'bf16'}"
    t0 = time.perf_counter()
    model = random_swin_ave(cfg, SEED, int8=int8)
    if cfg.ftmode == "fusion":
        live_fusion_adapters_(model, SEED)
    srv = MultiTaskServer(device="cuda")
    srv.add_ave(task, cfg, model)
    log(f"  set-up: random weights{', int8 tower' if int8 else ''}"
        f"{', live fusion adapters' if cfg.ftmode == 'fusion' else ''}, server on the card: "
        f"{time.perf_counter() - t0:.1f} s")
    rng = np.random.RandomState(SEED)
    n, T = cfg.img_size, cfg.num_frames

    def batch(b):
        return {"a": rng.randn(b, T, n, n).astype(np.float32),
                "v": rng.randn(b, T, n, n, 3).astype(np.float32)}

    requests = {task: ([batch(B) for _ in range(4)], (B * cfg.num_ttokens, cfg.label_dim))}
    want = {task: {**{k: 0 for k in KERNELS}, **launches_per_forward(cfg, B, quantized=int8)}}
    totals, clips, _ = drive(srv, requests, want, smi)
    one = batch(1)
    cpu = MultiTaskServer(device="cpu")
    if cpu_depths is None:
        cpu.add_ave(task, cfg, model)
        card = check_against_cpu(srv, cpu, one)[task]
    else:
        cut_cfg = dataclasses.replace(cfg, depths=cpu_depths)
        cut = random_swin_ave(cut_cfg, SEED, int8=int8)
        if cfg.ftmode == "fusion":
            live_fusion_adapters_(cut, SEED)
        cut_task = f"{task}_depths{''.join(map(str, cpu_depths))}"
        for server in (srv, cpu):
            server.add_ave(cut_task, cut_cfg, cut)
        check_against_cpu(srv, cpu, one)
        card = predict(srv, task, one)
        if not np.isfinite(card).all():
            fail(f"{task} B=1: non-finite logits")
    if cfg.ftmode == "fusion":
        check_fusion_is_live(srv, cfg, model, task, one, card)
    return totals, clips


def zero_bn_scales_(m):
    from stgcma_tpu_torch.ops.conv import BatchNorm
    if isinstance(m, BatchNorm):
        m.weight.zero_()


def phase_avs_slice(cfg, hcfg, smi, cpu_depths=(2, 2, 2, 2)):
    """AVSBench segmentation on Swin-Large fusion with its multi-scale taps,
    TPAVI and the FPN decoder (`add_avs`): B = 8 clips of T = 5 frames, the
    exact launches of the tower (the decoder makes none of the port's), mask
    logits (B*T, 224, 224, 1) finite; B = 1 held against the same
    configuration on the CPU cut to `cpu_depths`; zeroing the fusion gates,
    and separately the TPAVI BatchNorm scales, must move the card's masks."""
    import numpy as np
    from stgcma_tpu_torch.models.avs import random_avs
    from stgcma_tpu_torch.nn.swin import launches_per_forward
    from stgcma_tpu_torch.serving import MultiTaskServer

    task = "avs_swin_large_fusion_bf16"
    t0 = time.perf_counter()
    model = live_fusion_adapters_(random_avs(cfg, hcfg, SEED), SEED)
    srv = MultiTaskServer(device="cuda")
    srv.add_avs(task, cfg, hcfg, model)
    log(f"  set-up: random weights with live fusion adapters, gates and TPAVI BatchNorms, "
        f"server on the card: {time.perf_counter() - t0:.1f} s")
    rng = np.random.RandomState(SEED)
    n, T = cfg.img_size, cfg.num_frames

    def batch(b):
        return {"a": rng.randn(b, T, n, n).astype(np.float32),
                "v": rng.randn(b, T, n, n, 3).astype(np.float32)}

    shape = (B * cfg.num_ttokens, n, n, 1)
    requests = {task: ([batch(B) for _ in range(4)], shape)}
    want = {task: {**{k: 0 for k in KERNELS}, **launches_per_forward(cfg, B)}}
    totals, clips, _ = drive(srv, requests, want, smi)
    log(f"  {task}: {clips[task]:.2f} clips/s = {clips[task] * cfg.num_ttokens:.2f} masks/s "
        f"(frames segmented a second) on {smi}")
    one = batch(1)
    cut_cfg = dataclasses.replace(cfg, depths=cpu_depths)
    cut = live_fusion_adapters_(random_avs(cut_cfg, hcfg, SEED), SEED)
    cut_task = f"{task}_depths{''.join(map(str, cpu_depths))}"
    cpu = MultiTaskServer(device="cpu")
    for server in (srv, cpu):
        server.add_avs(cut_task, cut_cfg, hcfg, cut)
    check_against_cpu(srv, cpu, one)
    card = predict(srv, task, one)
    if card.shape != (cfg.num_ttokens, n, n, 1) or not np.isfinite(card).all():
        fail(f"{task} B=1: masks of shape {card.shape}, finite={np.isfinite(card).all()}")
    def add(name, c, m):
        srv.add_avs(name, c, hcfg, m)
    check_fusion_is_live(srv, cfg, model, task, one, card, add=add)
    # each TPAVI then passes LN(x + its BatchNorm's bias)
    check_fusion_is_live(srv, cfg, model, task, one, card, add=add, zero_=zero_bn_scales_,
                         what="the TPAVI BatchNorm scales")
    return totals, clips


def avqa_batch(cfg, hcfg, rng, b):
    """One AVQA request of b clips: fbank images, frames, the negative frames
    (fp32) and a question of 14 words (int64)."""
    import numpy as np
    n, T = cfg.img_size, cfg.num_frames
    return {"a": rng.randn(b, T, n, n).astype(np.float32),
            "v": rng.randn(b, T, n, n, 3).astype(np.float32),
            "v_nega": rng.randn(b, T, n, n, 3).astype(np.float32),
            "question": rng.randint(0, hcfg.vocab_size, (b, 14)).astype(np.int64)}


def card_inputs(batch, dtype, device):
    """The request's arrays on `device`: frames and fbanks in `dtype`, the
    question as it is."""
    import torch
    out = {}
    for k, x in batch.items():
        t = torch.as_tensor(x).to(device)
        out[k] = t.to(dtype) if t.is_floating_point() else t
    return out


def three_outputs(model, cfg, hcfg, x):
    """`apply_avqa` on the inputs `x` (already on the model's device)."""
    import torch
    from stgcma_tpu_torch.models.avqa import apply_avqa
    with torch.inference_mode():
        return apply_avqa(model, cfg, hcfg, x["a"], x["v"], x["v_nega"], x["question"])


def check_three_output_path(srv, task, cfg, hcfg, rng, int8):
    """The three-output forward (`apply_avqa`, the nega stream and both match
    MLPs) on the server's own cast model at B = 8: shapes (B, 42), (B*T, 2),
    (B*T, 2), finite, exactly `launches_per_forward(nega=True)`; and for the
    bf16 model, new negative frames move out_match_nega and leave out_qa and
    out_match_posi bit for bit. Returns (launches, ms of one forward)."""
    import torch
    from stgcma_tpu_torch.nn.swin import launches_per_forward
    from stgcma_tpu_torch.ops import fused_attn as FA
    model = srv.models[task]
    x = card_inputs(avqa_batch(cfg, hcfg, rng, B), srv.dtype, "cuda")
    three_outputs(model, cfg, hcfg, x)                       # warm-up
    torch.cuda.synchronize()
    FA.reset_launches()
    t1 = time.perf_counter()
    outs = three_outputs(model, cfg, hcfg, x)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t1) * 1e3
    got = launches()
    want = {**{k: 0 for k in KERNELS}, **launches_per_forward(cfg, B, quantized=int8, nega=True)}
    if got != want:
        fail(f"{task} three outputs: launches {got}, expected {want} per forward")
    shapes = ((B, hcfg.answer_dim), (B * cfg.num_ttokens, 2), (B * cfg.num_ttokens, 2))
    for o, shape in zip(outs, shapes):
        if tuple(o.shape) != shape or not bool(torch.isfinite(o).all()):
            fail(f"{task} three outputs: {tuple(o.shape)} for {shape}, finite="
                 f"{bool(torch.isfinite(o).all())}")
    log(f"  {task} three outputs (apply_avqa, nega stream): shapes {[tuple(o.shape) for o in outs]}"
        f" finite; launches per forward {want}; {ms:.2f} ms a B={B} forward on the card")
    if not int8:
        y = dict(x, v_nega=card_inputs(avqa_batch(cfg, hcfg, rng, B), srv.dtype, "cuda")["v_nega"])
        moved = three_outputs(model, cfg, hcfg, y)
        same = [bool(torch.equal(moved[i], outs[i])) for i in (0, 1)]
        nega_moved = float((moved[2] - outs[2]).abs().max() / outs[2].abs().max())
        if not all(same) or not nega_moved > TOL_SLICE:
            fail(f"{task} three outputs with new negative frames: out_qa, out_match_posi "
                 f"bit-identical {same}, out_match_nega moved {nega_moved:.4g} of max (must "
                 f"exceed {TOL_SLICE})")
        log(f"  {task} new negative frames: out_qa and out_match_posi bit-identical, "
            f"out_match_nega moves {nega_moved:.4g} of its max")
    return got, ms


def check_three_outputs_against_cpu(task, cfg, hcfg, cut_model, one):
    """B = 1: `apply_avqa`'s three outputs on the card against the same cut
    model on the CPU, each within TOL_SLICE of its max, both cast to bf16."""
    import torch
    from stgcma_tpu_torch.ops.common import cast_tree
    bf = torch.bfloat16
    cpu_m = cast_tree(cut_model, bf).eval()
    card_m = cast_tree(cut_model, bf).to("cuda").eval()
    t1 = time.perf_counter()
    ref = three_outputs(cpu_m, cfg, hcfg, card_inputs(one, bf, "cpu"))
    cpu_s = time.perf_counter() - t1
    got = three_outputs(card_m, cfg, hcfg, card_inputs(one, bf, "cuda"))
    for name, o, r in zip(("out_qa", "out_match_posi", "out_match_nega"), got, ref):
        err = float((o.float().cpu() - r.float()).abs().max())
        scale = float(r.float().abs().max())
        if not err <= TOL_SLICE * scale:
            fail(f"{task} three outputs B=1 {name}: max |card - cpu| = {err:.4g} > "
                 f"{TOL_SLICE} * {scale:.4g}")
        log(f"  {task} three outputs B=1 {name} card vs CPU: max_abs_err {err:.4g} (max |cpu| "
            f"{scale:.4g}, tol {TOL_SLICE} rel; CPU forward {cpu_s:.1f} s)")


def head_is_live(srv, task, cfg, hcfg, batch):
    """The share of tanh(fc_fusion(...) * qst_feature), fc_ans's input, below
    0.99 in magnitude on the card at B = 8; a saturated head would hide the
    tower from out_qa. Fails under one half."""
    import torch
    from stgcma_tpu_torch.models import avqa
    from stgcma_tpu_torch.nn import swin
    m, hp = srv.models[task], srv.models[task].avqatask
    x = card_inputs(batch, srv.dtype, "cuda")
    with torch.inference_mode():
        feats = swin.backbone_apply(m.backbone, cfg, a=x["a"], v=x["v"])
        audio = avqa.audio_features(hp, feats["a"])
        qst = avqa.apply_qst_encoder(hp.question_encoder, x["question"], hcfg)
        grd = avqa._grounding(hp, audio, feats["v"], hcfg)
        comb = avqa.qa_combined(hp, hcfg, qst, grd, audio, B, cfg.num_ttokens)
    live = float((comb.float().abs() < 0.99).float().mean())
    if not live >= 0.5:
        fail(f"{task}: only {live:.3f} of tanh(fc_fusion * qst) below 0.99: the head saturates")
    log(f"  {task}: {live:.4f} of fc_ans's inputs below 0.99 in magnitude (the head is live)")


def phase_avqa_slice(cfg, hcfg, smi, cpu_depths=(2, 2, 2, 2)):
    """MUSIC-AVQA on Swin-Large fusion at T = 10 (`add_avqa`), bf16 and with
    the int8 tower: B = 8 requests {a, v, v_nega, question}, out_qa (8, 42)
    finite, exactly the two-stream tower's launches (no nega stream; the head
    makes none of the port's); B = 1 against the CPU at `cpu_depths`; zeroing
    the fusion gates must move out_qa; and on the same served models, the
    three-output forward (`check_three_output_path`, its B = 1 against the
    CPU at `cpu_depths` for the bf16 model)."""
    import numpy as np
    from stgcma_tpu_torch.models.avqa import random_avqa
    from stgcma_tpu_torch.nn.swin import launches_per_forward
    from stgcma_tpu_torch.serving import MultiTaskServer

    tasks = {"avqa_swin_large_fusion_bf16": False, "avqa_swin_large_fusion_int8": True}
    t0 = time.perf_counter()
    models = {task: live_fusion_adapters_(random_avqa(cfg, hcfg, SEED, int8=int8), SEED)
              for task, int8 in tasks.items()}
    srv, cpu = MultiTaskServer(device="cuda"), MultiTaskServer(device="cpu")
    for task in tasks:
        srv.add_avqa(task, cfg, hcfg, models[task])
    log(f"  set-up: random weights with live fusion adapters and gates, int8 tower, server on "
        f"the card: {time.perf_counter() - t0:.1f} s")
    rng = np.random.RandomState(SEED)
    reqs = [avqa_batch(cfg, hcfg, rng, B) for _ in range(4)]
    requests = {task: (reqs, (B, hcfg.answer_dim)) for task in tasks}
    want = {task: {**{k: 0 for k in KERNELS}, **launches_per_forward(cfg, B, quantized=int8)}
            for task, int8 in tasks.items()}
    totals, clips, _ = drive(srv, requests, want, smi)
    for task in tasks:
        head_is_live(srv, task, cfg, hcfg, reqs[0])
    one = avqa_batch(cfg, hcfg, rng, 1)
    cut_cfg = dataclasses.replace(cfg, depths=cpu_depths)
    cuts = {}
    for task, int8 in tasks.items():
        cuts[task] = live_fusion_adapters_(random_avqa(cut_cfg, hcfg, SEED, int8=int8), SEED)
        for server in (srv, cpu):
            server.add_avqa(f"{task}_depths{''.join(map(str, cpu_depths))}", cut_cfg, hcfg,
                            cuts[task])
    check_against_cpu(srv, cpu, one)

    def add(name, c, m):
        srv.add_avqa(name, c, hcfg, m)
    for task in tasks:
        card = predict(srv, task, one)
        if card.shape != (1, hcfg.answer_dim) or not np.isfinite(card).all():
            fail(f"{task} B=1: out_qa of shape {card.shape}, finite={np.isfinite(card).all()}")
        check_fusion_is_live(srv, cfg, models[task], task, one, card, add=add)
    for task, int8 in tasks.items():
        got, _ = check_three_output_path(srv, task, cfg, hcfg, rng, int8)
        totals = {k: totals[k] + got[k] for k in KERNELS}
    check_three_outputs_against_cpu("avqa_swin_large_fusion_bf16", cut_cfg, hcfg,
                                    cuts["avqa_swin_large_fusion_bf16"], one)
    return totals, clips


# ---------------------------------------------------------------------------
# phase 4: the stream, from a reference checkpoint and raw media to logits
# ---------------------------------------------------------------------------

def openai_visual_state_dict(cfg, seed):
    """A random OpenAI-layout CLIP visual tower at cfg's widths (numpy, from
    `seed`): conv1, class and positional embeddings, ln_pre / ln_post, the
    resblocks' packed in_proj, out_proj, ln_1 / ln_2, mlp.c_fc / c_proj, and
    `proj`, which the loader drops. Linears N(0, 0.02), LayerNorm weights
    1 + N(0, 0.1), embeddings N(0, C^-1/2), conv1 uniform(+-1/sqrt(fan_in)),
    as `random_clip_ave` draws them."""
    import numpy as np
    rng = np.random.default_rng(seed)
    d, p = cfg.embed_dim, cfg.patch_size

    def n(*shape, std=0.02, mean=0.0):
        return (mean + std * rng.standard_normal(shape, dtype=np.float32)).astype(np.float32)
    bound = (3 * p * p) ** -0.5
    sd = {"conv1.weight": rng.uniform(-bound, bound, (d, 3, p, p)).astype(np.float32),
          "class_embedding": n(d, std=d ** -0.5),
          "positional_embedding": n(cfg.num_patches + 1, d, std=d ** -0.5),
          "ln_pre.weight": n(d, std=0.1, mean=1.0), "ln_pre.bias": n(d),
          "ln_post.weight": n(d, std=0.1, mean=1.0), "ln_post.bias": n(d),
          "proj": n(d, 512)}
    for i in range(cfg.layers):
        pre = f"transformer.resblocks.{i}"
        sd.update({f"{pre}.attn.in_proj_weight": n(3 * d, d), f"{pre}.attn.in_proj_bias": n(3 * d),
                   f"{pre}.attn.out_proj.weight": n(d, d), f"{pre}.attn.out_proj.bias": n(d),
                   f"{pre}.ln_1.weight": n(d, std=0.1, mean=1.0), f"{pre}.ln_1.bias": n(d),
                   f"{pre}.ln_2.weight": n(d, std=0.1, mean=1.0), f"{pre}.ln_2.bias": n(d),
                   f"{pre}.mlp.c_fc.weight": n(4 * d, d), f"{pre}.mlp.c_fc.bias": n(4 * d),
                   f"{pre}.mlp.c_proj.weight": n(d, 4 * d), f"{pre}.mlp.c_proj.bias": n(d)})
    return sd


def write_wavs(dirname, count, seconds, seed):
    """`count` WAV files of `seconds` s at 16 kHz, int16: a tone of its own
    pitch with seeded noise. Returns their paths."""
    import numpy as np
    from scipy.io import wavfile
    rng = np.random.RandomState(seed)
    t = np.arange(int(16000 * seconds)) / 16000.0
    paths = []
    for i in range(count):
        x = 0.3 * np.sin(2 * np.pi * (220.0 + 110.0 * i) * t) + 0.05 * rng.randn(t.size)
        path = os.path.join(dirname, f"clip{i}.wav")
        wavfile.write(path, 16000, (np.clip(x, -1, 1) * 32767).astype(np.int16))
        paths.append(path)
    return paths


def build_native_decoder():
    """`make -C native` (the native WAV / jpg / png decoder links libjpeg and
    libpng, which a machine may lack). Returns a line saying what happened."""
    here = os.path.dirname(os.path.abspath(__file__))
    try:
        out = subprocess.run(["make", "-C", os.path.join(here, "native")], capture_output=True,
                             text=True, timeout=120)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"not built ({e})"
    if out.returncode != 0:
        return f"not built (make: {(out.stderr or out.stdout).strip().splitlines()[-1:]})"
    return "built"


def hold_pipeline(name, pipe_card, pipe_cpu, host, smi):
    """A device pipeline on the card against the same on the CPU, on one
    host batch: the fbank image within 1e-3 absolute (normalized log-mel
    units), the frames within 1e-5 absolute. Returns the card's pipeline ms."""
    import torch
    card = {k: torch.from_numpy(v).to("cuda") for k, v in host.items()}
    a, v = pipe_card(card)
    ra, rv = pipe_cpu(host)
    err_a = float((a.cpu() - ra).abs().max())
    err_v = float((v.cpu() - rv).abs().max())
    if not (err_a <= 1e-3 and err_v <= 1e-5 and a.shape == ra.shape and v.shape == rv.shape):
        fail(f"{name} pipeline card vs CPU: fbank {err_a:.4g} (tol 1e-3), frames {err_v:.4g} "
             f"(tol 1e-5), shapes {tuple(a.shape)} / {tuple(ra.shape)}, {tuple(v.shape)} / "
             f"{tuple(rv.shape)}")
    ms = cuda_ms(lambda: pipe_card(card), iters=10)
    log(f"  {name} pipeline card vs CPU on one host batch (frames {host['frames'].shape} uint8, "
        f"wave {host['wave'].shape} f32): a {tuple(a.shape)} max_abs_err {err_a:.4g} (tol 1e-3), "
        f"v {tuple(v.shape)} max_abs_err {err_v:.4g} (tol 1e-5); {ms:.3f} ms on the card, {smi}")
    return ms


def phase_stream(cfg, avqa_cfg, avs_cfg, smi):
    """CLIP ViT-B/16 fusion from a reference (OpenAI-layout) visual state dict
    through `load_pretrained_clip`, live adapters and gates, served bf16 and
    with the int8 tower; 2B + 3 = 19 requests of 10 s WAVs and uint8 frames
    through `serve_stream` (HostDecoder, pinned H2D, the AVE device pipeline
    on the card, `predict`) at batch_size B, the tail padded. Returns
    ({kernel: launches}, {task: clips/s})."""
    import copy
    import tempfile
    import numpy as np
    import torch
    from stgcma_tpu_torch.checkpoint.torch_convert import load_pretrained_clip
    from stgcma_tpu_torch.data.loader import (make_ave_device_pipeline,
                                              make_avqa_device_pipeline,
                                              make_avs_device_pipeline)
    from stgcma_tpu_torch.models.ave import random_clip_ave
    from stgcma_tpu_torch.nn.clip_vit import launches_per_forward
    from stgcma_tpu_torch.ops import fused_attn as FA
    from stgcma_tpu_torch.ops.fbank import CLIP_FBANK, SWIN_FBANK
    from stgcma_tpu_torch.ops.quant import quantize_clip_tower
    from stgcma_tpu_torch.serving import (HostDecoder, MultiTaskServer, StreamRequest,
                                          serve_stream, share_frozen_tower)
    from stgcma_tpu_torch.train.optim import label
    t0 = time.perf_counter()
    native = build_native_decoder()
    sd = openai_visual_state_dict(cfg, SEED)
    # adapters, gates and head drawn live first: the load keeps what the state dict lacks
    model, unexpected = load_pretrained_clip(live_clip_adapters_(random_clip_ave(cfg, SEED), SEED),
                                             sd, cfg, device="cuda")
    if unexpected or model.backbone.positional_embedding.device.type != "cuda":
        fail(f"load_pretrained_clip: unexpected {unexpected}, on "
             f"{model.backbone.positional_embedding.device}")
    model_q = copy.deepcopy(model)
    model_q.backbone = quantize_clip_tower(model_q.backbone)
    tasks = {"stream_clip_bf16": (model, False), "stream_clip_int8": (model_q, True)}
    srv, cpu = MultiTaskServer(device="cuda"), MultiTaskServer(device="cpu")
    for task, (m, _) in tasks.items():
        srv.add_clip_ave(task, cfg, m)
        cpu.add_clip_ave(task, cfg, m)
    T, n = cfg.num_frames, cfg.input_resolution
    pipe = make_ave_device_pipeline(CLIP_FBANK, cfg.audio_tdim, image_size=n, device="cuda")
    pipe_cpu = make_ave_device_pipeline(CLIP_FBANK, cfg.audio_tdim, image_size=n, device="cpu")
    pipelines = {task: (lambda h: dict(zip("av", pipe(h)))) for task in tasks}
    decoder = HostDecoder(num_segments=T, seg_samples=16000)
    log(f"  set-up: OpenAI-layout ViT-B/16 visual state dict ({len(sd)} entries, proj dropped) "
        f"through load_pretrained_clip onto the card, live adapters and gates, int8 tower "
        f"after the load; native decoder {native}: HostDecoder takes the "
        f"{'native' if decoder.native else 'scipy'} WAV decoder; "
        f"{time.perf_counter() - t0:.1f} s")
    rng = np.random.RandomState(SEED)
    n_req = 2 * B + 3
    frames = [rng.randint(0, 256, (T, 256, 256, 3), dtype=np.uint8) for _ in range(n_req)]
    with tempfile.TemporaryDirectory() as tmp:
        wavs = write_wavs(tmp, 4, 10.0, SEED)

        def requests(task):
            return [StreamRequest(task=task, wav_path=wavs[i % len(wavs)], frames=frames[i],
                                  rid=i) for i in range(n_req)]
        t1 = time.perf_counter()
        host = decoder(requests("")[:B])                 # one host batch, for the checks
        log(f"  HostDecoder alone, {B} requests ({'native' if decoder.native else 'scipy'} "
            f"WAVs, frames stacked): {(time.perf_counter() - t1) * 1e3:.1f} ms on the host")
        tail = decoder(requests("")[-1:])
        a, v = (x.cpu().numpy() for x in pipe({k: torch.from_numpy(x).cuda()
                                               for k, x in host.items()}))
        totals, clips = {k: 0 for k in KERNELS}, {}
        for task, (_, int8) in tasks.items():
            with clip_switches(task):
                list(serve_stream(srv, pipelines, requests(task)[:B], batch_size=B,
                                  decoder=decoder, device="cuda"))   # warm-up, not counted
                torch.cuda.synchronize()
                FA.reset_launches()
                stats = []
                t1 = time.perf_counter()
                outs = list(serve_stream(srv, pipelines, requests(task), batch_size=B,
                                         decoder=decoder, device="cuda", stats=stats))
                torch.cuda.synchronize()
                wall = time.perf_counter() - t1
                got = launches()
                per = launches_per_forward(cfg, quantized=int8)
            want = {k: len(outs) * per.get(k, 0) for k in KERNELS}
            if got != want:
                fail(f"{task} stream: launches {got}, expected {want} ({len(outs)} forwards)")
            totals = {k: totals[k] + got[k] for k in KERNELS}
            rids = [r for ids, _ in outs for r in ids]
            if rids != list(range(n_req)) or [len(ids) for ids, _ in outs] != [B, B, 3]:
                fail(f"{task} stream: request ids {[ids for ids, _ in outs]}")
            for ids, o in outs:
                if o.shape != (len(ids) * T, cfg.label_dim) or not np.isfinite(o).all():
                    fail(f"{task} stream: logits {o.shape} for {len(ids)} requests, finite="
                         f"{np.isfinite(o).all()}")
            clips[task] = n_req / wall
            dec_ms = [round(s["decode_ms"], 1) for s in stats]
            stage_ms = [round(s["stage_ms"], 1) for s in stats]
            log(f"  {task}: serve_stream of {n_req} requests at batch_size {B} (tail of 3 padded "
                f"and dropped): ids complete and in order, logits {[o.shape for _, o in outs]} "
                f"finite; launches {got} = {len(outs)} x launches_per_forward; "
                f"{wall * 1e3:.1f} ms = {clips[task]:.2f} streamed clips/s; host decode "
                f"{dec_ms} ms a batch ({'native' if decoder.native else 'scipy'} WAVs), then "
                f"padding and pinning {stage_ms} ms ({stats[0]['h2d_bytes'] / 1e6:.2f} MB a "
                f"batch to the card); {smi}")
            # the streamed logits against the CPU pipeline and the CPU model, on the tail request
            ref = predict(cpu, task, dict(zip("av", (x.numpy() for x in pipe_cpu(tail)))))
            card = outs[-1][1][-T:]
            err, scale = float(np.abs(card - ref).max()), float(np.abs(ref).max())
            if not err <= TOL_SLICE * scale:
                fail(f"{task} stream rid {n_req - 1}: max |stream - cpu| = {err:.4g} > "
                     f"{TOL_SLICE} * {scale:.4g}")
            log(f"  {task} stream rid {n_req - 1} (the padded tail's last) against the CPU "
                f"pipeline and the CPU model: max_abs_err {err:.4g} (max |cpu| {scale:.4g}, "
                f"tol {TOL_SLICE} rel)")
            # predict's own clips/s on the same model, with float inputs from the host
            times = []
            for _ in range(4):
                t1 = time.perf_counter()
                predict(srv, task, {"a": a, "v": v})
                times.append(time.perf_counter() - t1)
            med = sorted(times[1:])[1]
            on_card = dict(zip("av", pipe({k: torch.from_numpy(x).cuda() for k, x in host.items()})))
            with clip_switches(task):
                model_ms = cuda_ms(lambda: srv.predict(task, on_card), iters=5)
            log(f"  {task}: predict of B={B} float (a, v) from the host: median {med * 1e3:.2f} "
                f"ms = {B / med:.2f} clips/s beside {clips[task]:.2f} streamed; predict of the "
                f"pipeline's (a, v) already on the card {model_ms:.2f} ms; {smi}")
    # the two copies to the card: the stream's pinned uint8 frames + f32 waves, predict's floats
    pinned = {k: torch.from_numpy(x).pin_memory() for k, x in host.items()}
    s_bytes = sum(x.numel() * x.element_size() for x in pinned.values())
    s_ms = cuda_ms(lambda: [x.to("cuda", non_blocking=True) for x in pinned.values()], iters=10)
    p_bytes = a.nbytes + v.nbytes
    p_ms = cuda_ms(lambda: [torch.as_tensor(x).to("cuda") for x in (a, v)], iters=5)
    log(f"  H2D a batch of B={B}: the stream's pinned uint8 frames + f32 waves {s_bytes / 1e6:.2f} "
        f"MB in {s_ms:.3f} ms ({s_bytes / s_ms / 1e6:.1f} GB/s) against predict's pageable f32 "
        f"(a, v) {p_bytes / 1e6:.2f} MB in {p_ms:.3f} ms ({p_bytes / p_ms / 1e6:.1f} GB/s); {smi}")
    # the device pipelines on the card against the CPU, at their B = 8 input shapes
    hold_pipeline("AVE CLIP (CLIP_FBANK, eval_transform)", pipe, pipe_cpu, host, smi)
    prng = np.random.RandomState(SEED + 1)
    for name, make, c, hw in (("AVQA (SWIN_FBANK, bicubic)", make_avqa_device_pipeline,
                               avqa_cfg, 256),
                              ("AVS (SWIN_FBANK, normalize)", make_avs_device_pipeline, avs_cfg,
                               avs_cfg.img_size)):
        hb = {"frames": prng.randint(0, 256, (B, c.num_frames, hw, hw, 3), dtype=np.uint8),
              "wave": host["wave"][:, :c.num_frames].copy()}
        hold_pipeline(name, make(SWIN_FBANK, c.img_size, device="cuda"),
                      make(SWIN_FBANK, c.img_size, device="cpu"), hb, smi)
    # two tasks on one frozen tower: a second bf16 task with adapters and head of its own
    other = live_clip_adapters_(copy.deepcopy(model).cpu(), SEED + 1)
    g = torch.Generator().manual_seed(SEED + 2)
    with torch.no_grad():
        for p in other.mlp_head.parameters():
            p.normal_(0.0, 0.02, generator=g)
    srv.add_clip_ave("stream_clip_bf16_b", cfg, other)
    one = {"a": a[:1], "v": v[:1]}
    before = {t: predict(srv, t, one) for t in ("stream_clip_bf16", "stream_clip_bf16_b")}
    canon, mine = srv.models["stream_clip_bf16"], srv.models["stream_clip_bf16_b"]
    free0 = torch.cuda.memory_allocated()
    share_frozen_tower(canon, {"b": mine})
    freed = free0 - torch.cuda.memory_allocated()
    held = dict(mine.backbone.named_parameters())
    ref_held = dict(canon.backbone.named_parameters())
    shared = [k for k, t in held.items() if t.data_ptr() == ref_held[k].data_ptr()]
    frozen = [k for k in held if label(f"backbone.{k}") == "frozen"]
    if sorted(shared) != sorted(frozen):
        fail(f"share_frozen_tower: {len(shared)} leaves share storage, {len(frozen)} frozen")
    after = {t: predict(srv, t, one) for t in before}
    moved = {t: float(np.abs(after[t] - before[t]).max()) for t in before}
    if any(moved.values()):
        fail(f"share_frozen_tower moved the logits: {moved}")
    differ = float(np.abs(after["stream_clip_bf16"] - after["stream_clip_bf16_b"]).max())
    log(f"  share_frozen_tower: {len(shared)} frozen tower leaves of stream_clip_bf16_b share "
        f"storage with stream_clip_bf16 (every frozen leaf; adapters, gates, embeddings' "
        f"temporal tables and heads its own), {freed / 2 ** 20:.1f} MiB freed on the card; "
        f"logits bit for bit unchanged, the two tasks' differ by {differ:.4g}")
    return totals, clips


# ---------------------------------------------------------------------------
# phase 5: AVE-29 training on CLIP ViT-B/16 fusion
# ---------------------------------------------------------------------------

def k1_grad_bound(Bq, N, C, heads):
    """Least time of K1's forward and backward at (Bq, N, C): the forward's
    operations and three times them for the backward's products (dx and
    dW of each product, dq, dk, dv and the probabilities' of each gram);
    bytes: x, the weights and the upstream gradient read once, dx and the
    weights' gradients written once."""
    M, dh = Bq * N, C // heads
    ops = 3 * (2 * M * C * 4 * C + 2 * 2 * Bq * heads * N * N * dh)
    nbytes = 3 * M * C * 2 + 2 * (4 * C * C + 7 * C) * 2
    t_ops, t_bytes = ops / H100_BF16, nbytes / H100_BYTES
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def tick(t0, what):
    log(f"  ({time.perf_counter() - t0:.1f} s into the phase: {what} done)")


def grad_row(name, kernel, plain, run, leaves, bound, library=None, tol=TOL_KERNEL,
             grad_tol=TOL_GRAD):
    """A kernel through `fused_attn._Recompute` on the card: `run(fn, lv)`
    calls `fn` (the wrapper, its plain version or its recompute) on the
    row's inputs, taking the leaves from `lv` ({name: tensor}, as `leaves`:
    the inputs that take a gradient, a bias table among them where the call
    gathers its bias). The forward is held to the plain version within
    `tol` of max |plain|; the backward launches no kernel. Two upstream
    gradients: "rand", N(0, 1) in the output's dtype, and "out", the
    kernel's output (the gradient of 1/2 |out|^2).
    - The witness: the recompute and the plain version, both on float64
      copies of the inputs (no bf16 rounding anywhere; their fp32 steps stay
      fp32), give every leaf the same gradient within TOL_GRAD_F64 of its
      max under both upstream gradients: the backward differentiates the
      plain version's function, so a term missing from it fails here.
    - Precision: the bf16 recompute against plain autograd of the plain
      version in bf16 (its products in fp32), each leaf within `grad_tol`
      of its own max: a tensor under "rand", a one-element leaf (a gate)
      under "out". A gate's gradient is one sum over every element of the
      call: "rand" cancels it to ~1/sqrt(n) of its terms, where the bf16
      products' rounding, which does not cancel, is of the terms' size.
      Under "out" a leaf that feeds the output through LN1 (v, x) sums the
      output's own large term against the LayerNorm backward's, which
      cancel the same way. The other pairing's distances are logged, not
      held; the witness holds it.
    max_abs_err is the larger of the forward's and the held gradients'
    absolute errors. Times: the Function's forward + backward and backward
    alone, plain autograd's, `library()` (PyTorch's own calls, timed only)
    under autograd, and the backward's kernel ms (torch.profiler)."""
    import torch
    names = list(leaves)
    xs = [leaves[n] for n in names]

    def outs_of(fn, lv=leaves):
        out = fn() if fn is library else run(fn, lv)
        return out if isinstance(out, tuple) else (out,)

    def grads(outs, ups, wrt=xs, retain=True):
        got = torch.autograd.grad(outs, wrt, ups, retain_graph=retain, allow_unused=True)
        return [torch.zeros_like(x) if d is None else d for x, d in zip(wrt, got)]

    outs = outs_of(kernel)
    if any(type(o.grad_fn).__name__ != "_RecomputeBackward" for o in outs):
        fail(f"{name}: the output's grad_fn is {outs[0].grad_fn}, not the Function")
    g = torch.Generator(device="cuda").manual_seed(SEED + 9)
    ups = {"rand": [torch.randn(o.shape, generator=g, device="cuda").to(o.dtype) for o in outs],
           "out": [o.detach() for o in outs]}
    gups = ups["rand"]
    before = kernel.launches
    got = {k: grads(outs, u) for k, u in ups.items()}
    torch.cuda.synchronize()
    if kernel.launches != before:
        fail(f"{name}: the backward launched the kernel")
    ref_outs = outs_of(plain)
    fwd = _flat(tuple(o.detach() for o in outs))
    fref = _flat(tuple(o.detach() for o in ref_outs))
    fwd_err, fwd_scale = (fwd - fref).abs().max().item(), fref.abs().max().item()
    if not (torch.isfinite(fwd).all() and fwd_err <= tol * fwd_scale):
        fail(f"{name}: forward max |kernel - plain| = {fwd_err:.4g} > {tol} * {fwd_scale:.4g}")
    del fwd, fref
    ref = {k: grads(ref_outs, u) for k, u in ups.items()}

    def rel(a, r):
        err, scale = (a.float() - r.float()).abs().max().item(), r.float().abs().max().item()
        return err, scale, err / max(scale, 1e-30)
    lv64 = {n: _leaf(x.detach().double()) for n, x in leaves.items()}
    xs64 = [lv64[n] for n in names]
    r64, p64 = outs_of(kernel.recompute, lv64), outs_of(plain, lv64)
    witness = 0.0
    for k, u in ups.items():
        u64 = [t.double() for t in u]
        for n, a, r in zip(names, grads(r64, u64, xs64), grads(p64, u64, xs64)):
            err, scale, e = rel(a, r)
            if not (torch.isfinite(a).all() and err <= TOL_GRAD_F64 * scale):
                fail(f"{name}: the float64 witness under the '{k}' upstream gradient: d/d{n} "
                     f"max |recompute - plain| = {err:.4g} > {TOL_GRAD_F64} * {scale:.4g}")
            witness = max(witness, e)
    del r64, p64, lv64, xs64
    errs, other = [], []
    for i, n in enumerate(names):
        held = "out" if xs[i].numel() == 1 else "rand"
        err, scale, e = rel(got[held][i], ref[held][i])
        if not (torch.isfinite(got[held][i]).all() and err <= grad_tol * scale):
            fail(f"{name}: d/d{n} under the '{held}' upstream gradient max |Function - plain| = "
                 f"{err:.4g} > {grad_tol} * {scale:.4g}")
        errs.append((n, err, scale, held))
        o = "rand" if held == "out" else "out"
        other.append((n, rel(got[o][i], ref[o][i])[2], o))
    del got, ref
    ms = cuda_ms(lambda: grads(outs_of(kernel), gups, retain=False), 5)
    bwd_ms = cuda_ms(lambda: grads(outs, gups), 5)
    plain_ms = cuda_ms(lambda: grads(outs_of(plain), gups, retain=False), 2, warmup=1)
    plain_bwd_ms = cuda_ms(lambda: grads(ref_outs, gups), 2, warmup=1)
    library_ms = None
    if library is not None:
        try:
            library_ms = cuda_ms(lambda: grads(outs_of(library), gups, retain=False), 5)
        except RuntimeError as e:          # a yardstick only; the port never calls it
            log(f"  {name}: library yardstick unavailable: {e}")
    bwd_kernels = kernel_ms(lambda: grads(outs, gups), iters=2)
    plain_bwd_kernels = kernel_ms(lambda: grads(ref_outs, gups), iters=1)
    bound_ms, bound_by = bound
    worst = max(errs, key=lambda e: e[1] / max(e[2], 1e-30))
    lib_s = "null" if library_ms is None else f"{library_ms:.4f}"
    log(f"  {name}: forward {fwd_err:.3g} ({fwd_err / fwd_scale:.2e} rel, tol {tol}); gradients "
        + ", ".join(f"d{n} {e / max(s, 1e-30):.2e} ({h})" for n, e, s, h in errs)
        + f" rel (tol {grad_tol}); not held: "
        + ", ".join(f"d{n} {e:.2e} ({h})" for n, e, h in other)
        + f"; float64 witness {witness:.2e} (tol {TOL_GRAD_F64}); forward + backward {ms:.4f} ms "
        f"(backward {bwd_ms:.4f}, {bwd_kernels:.4f} of kernels), plain autograd {plain_ms:.4f} ms "
        f"(backward {plain_bwd_ms:.4f}, {plain_bwd_kernels:.4f} of kernels), library {lib_s} ms, "
        f"bound {bound_ms:.4f} ms ({bound_by})")
    return {"shape": f"{name}, forward + recompute backward", "max_abs_err": max(
        [fwd_err] + [e for _, e, _, _ in errs]), "forward_rel_err": fwd_err / fwd_scale,
        "grad_max_rel_err": worst[1] / max(worst[2], 1e-30), "grad_worst_leaf": worst[0],
        "grad_other_max_rel_err": max(e for _, e, _ in other), "grad_f64_witness": witness,
        "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
        "library_ms": library_ms, "backward_ms": bwd_ms, "plain_backward_ms": plain_bwd_ms,
        "backward_kernel_ms": bwd_kernels, "plain_backward_kernel_ms": plain_bwd_kernels}


def _leaf(t):
    return t.detach().clone().requires_grad_(True)


def _rnd(g, *shape, std=1.0, dtype=None):
    import torch
    t = torch.randn(*shape, generator=g, device="cuda") * std
    return t if dtype is None else t.to(dtype)


def k1_grad_rows(cfg, b):
    """`grad_row` of K1 at the four CLIP-B/16 fusion sites at B = b, its bars
    TOL_KERNEL for the forward and the gradients alike; library: PyTorch's
    own layer_norm / linear / scaled_dot_product_attention composition."""
    import torch
    from stgcma_tpu_torch.ops import fused_attn as FA
    T, C, h = cfg.num_frames, cfg.embed_dim, cfg.heads
    Nv, Na = cfg.num_patches + 1, cfg.num_patches_audio + 1
    sites = {"video temporal": (b * Nv, T), "audio temporal": (b * Na, T),
             "video spatial": (b * T, Nv), "audio spatial": (b * T, Na)}
    g = torch.Generator(device="cuda").manual_seed(SEED)
    names = ("x", "ln_w", "ln_b", "w_qkv", "b_qkv", "w_proj", "b_proj")
    rows = []
    for site, (Bq, N) in sites.items():
        args, _ = make_block_inputs(g, Bq, N, C, h, int8=False)
        leaves = dict(zip(names, (_leaf(a) for a in args)))

        def run(fn, lv):
            return fn(*lv.values(), h)

        def library(lv=leaves, Bq=Bq, N=N):
            return library_block(list(lv.values()), h, False)().view(Bq, N, C)
        rows.append(grad_row(f"K1 CLIP {site} {(Bq, N, C)} h{h}", FA.win_block,
                             FA.win_block_plain, run, leaves, k1_grad_bound(Bq, N, C, h),
                             library, tol=TOL_KERNEL, grad_tol=TOL_KERNEL))
        del leaves, args
    return rows


def train_cli(exp, *flags, model="MM-CLIP-AVE-Base"):
    """`cli.run_adapt_ave29.main` on `model` (CLIP ViT-B/16 by default) in
    fusion mode at full width on the card, synthetic AVE at B = TRAIN_B."""
    from stgcma_tpu_torch.cli import run_adapt_ave29
    with contextlib.redirect_stdout(sys.stderr):     # the CLI's own prints
        return run_adapt_ave29.main(
            ["--model", model, "--ftmode", "fusion", "--synthetic", "True",
             "--batch_size", str(TRAIN_B), "--synthetic_n", str(TRAIN_N), "--num_workers", "2",
             "--device", "cuda", "--exp-dir", exp, *flags])


def check_cli_run(label, trainer, init, want_of, n_launched, rounding_zero=()):
    """The straight CLI run on the card (2 epochs of TRAIN_N // TRAIN_B
    steps, one eval batch an epoch: AVE's and AVS's synthetic test splits
    hold TRAIN_B items): finite step losses, every trainable leaf that the
    loss reaches moved, every frozen parameter bit for bit as the CLI's
    init left it, the launches exactly `want_of(forwards)` (the path's
    launches a forward x its forwards, train and eval), its files
    written."""
    import torch
    losses = trainer.step_losses
    if not losses or not all(map(math.isfinite, losses)):
        fail(f"{label}: a non-finite step loss in {losses}")
    start = dict(init.named_parameters())
    moved, frozen = 0, 0
    unreached = []                 # trainable leaves the loss does not reach (no gradient)
    zeroed = []                    # leaves of `rounding_zero` whose bf16 gradient stayed 0
    for n, p in trainer.model.named_parameters():
        same = torch.equal(p, start[n])
        if p.requires_grad and same and p.grad is not None:
            if n in rounding_zero and not p.grad.any():
                zeroed.append(n)
                continue
            fail(f"{label}: the trainable leaf {n} did not move")
        if not p.requires_grad and not same:
            fail(f"{label}: the frozen leaf {n} changed")
        if p.requires_grad and p.grad is None:
            unreached.append(n)
        moved, frozen = moved + (p.requires_grad and not same), frozen + (not p.requires_grad)
    forwards = trainer.global_step + trainer.n_epochs
    want = want_of(forwards)
    if n_launched != want:
        fail(f"{label}: launches {n_launched}, expected {want} ({forwards} forwards)")
    for name in ("result.csv", "progress.json", "state_meta.json", "models/model.1",
                 "models/best_model", "state/train_params", "state/opt_state", "state/buffers"):
        if not os.path.exists(os.path.join(trainer.exp_dir, name)):
            fail(f"{label}: {name} was not written")
    log(f"  {label} CLI ({trainer.lr_mode} LR): {trainer.global_step} steps + "
        f"{trainer.n_epochs} eval batches, step losses "
        f"{', '.join(f'{x:.4f}' for x in losses)}, history "
        f"{[{k: round(v, 5) for k, v in h.items()} for h in trainer.history]}; {moved} "
        f"trainable leaves moved ({len(unreached)} the loss does not reach, unmoved"
        + (f": {', '.join(unreached)}" if unreached else "")
        + (f"; {len(zeroed)} whose bf16 gradient rounds to 0 at every step, unmoved: "
           f"{', '.join(zeroed)}" if zeroed else "") + f"), {frozen} frozen leaves "
        f"bit for bit; launches "
        f"{ {k: v for k, v in n_launched.items() if v} } = the path's launches a forward x "
        f"{forwards} forwards, exactly; result.csv, progress.json, state_meta.json, models/, "
        f"state/ written")


def check_resume(straight, resumed, init):
    """A run resumed after epoch 1 against the straight run: every master
    within TOL_RESUME x the largest update of the straight run; the leaves
    that differ named."""
    a, b = straight.trainable(), resumed.trainable()
    if set(a) != set(b):
        fail("train resume: the two runs train other leaves")
    moved = sorted(((a[n] - b[n]).abs().max().item(), n) for n in a)[::-1]
    moved = [(d, n) for d, n in moved if d > 0]
    diff = moved[0][0] if moved else 0.0
    update = max((a[n] - init[n]).abs().max().item() for n in a)
    if not (update > 0 and diff <= TOL_RESUME * update):
        fail(f"train resume: max |resumed - straight| = {diff:.4g} > {TOL_RESUME} x the "
             f"largest update {update:.4g}")
    if [h["epoch"] for h in resumed.history] != [1, 2]:
        fail(f"train resume: history epochs {[h['epoch'] for h in resumed.history]}")
    log(f"  resume ({straight.lr_mode} LR): epoch 1, then --resume True to epoch 2, against 2 "
        f"epochs straight: max |resumed - straight| over the masters {diff:.4g} (largest update "
        f"{update:.4g}, tol {TOL_RESUME} x it); {len(moved)} of {len(a)} leaves differ"
        + (": " + ", ".join(f"{n} {d:.3g}" for d, n in moved[:4]) if moved else ""))


def resumed_buffers(straight, resumed, init):
    """The BatchNorm statistics of a run resumed after epoch 1 against the
    straight run's, within TOL_RESUME x their largest change from init."""
    a, b = straight.buffers(), resumed.buffers()
    start = dict(init.named_buffers())
    diff = max((a[n] - b[n]).abs().max().item() for n in a)
    change = max((a[n] - start[n].to(a[n].device)).abs().max().item() for n in a)
    if not (change > 0 and diff <= TOL_RESUME * change):
        fail(f"train resume: BatchNorm statistics max |resumed - straight| = {diff:.4g} > "
             f"{TOL_RESUME} x their largest change {change:.4g}")
    log(f"  resume: the {len(a)} BatchNorm statistics max |resumed - straight| {diff:.4g} "
        f"(largest change from init {change:.4g}, tol {TOL_RESUME} x it)")


def step_against_cpu(label, base, make_loss, want, n_steps=1, stats=False, cpu_bf16=False):
    """`n_steps` train steps of `base` (live weights) at lr 0, on the card in
    bf16 and on the CPU in fp32 (the plain versions): the first step's loss
    within TOL_KERNEL of |cpu|, all gradients together within TOL_KERNEL of
    their max |cpu|, each trainable leaf's within TOL_TRAIN_LEAF of its own
    max |cpu|, the card's first step launching exactly `want`; with
    `stats`, the BatchNorm running statistics after the last step within
    TOL_KERNEL of max |cpu| (the momentum updates copied in after each
    step, as the Trainer does). With `cpu_bf16`, the same first step on the
    CPU in bf16 too: its distance d from the fp32 step is what bf16
    rounding alone does to a leaf. A leaf whose fp32 gradient is at most
    ZERO_SHARE x d is zero to rounding (TPAVI's W_z conv biases, zero in
    exact arithmetic ahead of a batch-statistics BatchNorm): named, held
    only within all the gradients together. Every other leaf's bar is
    TOL_TRAIN_LEAF of its max plus TRAIN_NOISE x d (AVS's audio branch
    reaches the loss through TPAVI's sums over every position, where bf16
    moves it by 10-130% on the CPU; `phase_train_avs` also holds it in a
    step where those sums do not cancel), where d, for a leaf whose fp32
    gradient is below d (its bf16 gradient mostly rounding), is the larger
    of two roundings' distances: the CPU's and that of the same step on the
    card with every wrapper on its plain version (`tools.grad_noise`'s
    `card plain`). Such a leaf's distance is one draw of a rounding larger
    than its value, and one draw does not scale it: over 4 seeds of the
    AVQA step, 15 of 64 gates on the card and 17 of 64 in `card plain` sat
    past 1.5x the CPU's distance (PERF.md, PR 19)."""
    import copy
    import torch
    from stgcma_tpu_torch.ops import fused_attn as FA
    from stgcma_tpu_torch.tools.grad_noise import plain_forward
    from stgcma_tpu_torch.train import optim, steps

    def first_step(dev, dt, n):
        model = copy.deepcopy(base).to(dev)
        steps.init_train_state(model)
        step = steps.make_train_step(make_loss(dev, dt), optim.build_optimizer(model, 0.0, 1.0),
                                     dt)
        for i in range(n):
            FA.reset_launches()
            loss, aux = step(model, None)
            if aux.get("state_updates"):
                steps.apply_state_updates(model, aux["state_updates"])
            if i == 0:
                first = (float(loss), {n: p.grad.float().cpu() for n, p in model.named_parameters()
                                       if p.requires_grad and p.grad is not None}, launches())
        bufs = {n: b.float().cpu() for n, b in model.named_buffers() if steps.bn_stat(n)}
        return first + (bufs,)
    runs = [("cuda", torch.bfloat16, n_steps), ("cpu", torch.float32, n_steps)]
    out = [first_step(*r) for r in runs + ([("cpu", torch.bfloat16, 1)] if cpu_bf16 else [])]
    (lc, gc, nc, bc), (lp, gp, _, bp) = out[:2]
    gb = out[2][1] if cpu_bf16 else None
    if nc != want:
        fail(f"{label}: launches {nc}, expected {want}")
    if not abs(lc - lp) <= TOL_KERNEL * abs(lp):
        fail(f"{label}: loss card {lc:.6g} vs cpu {lp:.6g}")
    if set(gc) != set(gp) or (gb is not None and set(gb) != set(gp)):
        fail(f"{label}: the card and the CPU give gradients to other leaves")
    dist = {n: (gb[n] - ref).abs().max().item() if gb is not None else 0.0
            for n, ref in gp.items()}
    below = [n for n, ref in gp.items() if ref.abs().max().item() < dist[n]]
    plain = {}                     # the card's plain versions' distance, for the leaves below d
    if below:
        with plain_forward({k.id for k in FA.KERNELS}):
            gpl = first_step("cuda", torch.bfloat16, 1)[1]
        plain = {n: (gpl[n] - gp[n]).abs().max().item() for n in below}
    worst, zero, noisy, live = (0.0, "", 0.0, 0.0), [], [], (math.inf, "")
    held_below = []
    for n, ref in gp.items():
        err, scale = (gc[n] - ref).abs().max().item(), ref.abs().max().item()
        rounding = max(dist[n], plain.get(n, 0.0))
        if gb is not None and scale <= ZERO_SHARE * dist[n]:
            zero.append((dist[n] / max(scale, 1e-30), n, err / max(dist[n], 1e-30)))
            continue
        live = min(live, (scale / max(dist[n], 1e-30), n))
        bar = TOL_TRAIN_LEAF * scale + TRAIN_NOISE * rounding
        if not (scale > 0 and err <= bar):
            fail(f"{label}: d/d{n} max |card - cpu| = {err:.4g} > {bar:.4g} = {TOL_TRAIN_LEAF} * "
                 f"{scale:.4g} + {TRAIN_NOISE} * {rounding:.4g} (the "
                 + ("larger of the CPU's and the card's plain versions' bf16 distances: "
                    f"{dist[n]:.4g}, {plain[n]:.4g})" if n in plain else "CPU's bf16 distance)"))
        worst = max(worst, (err / bar, n, err / scale, bar / scale))
        if n in plain:
            held_below.append((n, scale, dist[n], plain[n], err))
        if dist[n] > TOL_TRAIN_LEAF * scale:
            noisy.append((dist[n] / scale, n, err / scale))
    every = torch.cat([g.flatten() for g in gp.values()])
    err = torch.cat([gc[n].flatten() for n in gp]).sub(every).abs().max().item()
    scale = every.abs().max().item()
    if not err <= TOL_KERNEL * scale:
        fail(f"{label}: max |card - cpu| over every gradient = {err:.4g} > {TOL_KERNEL} * "
             f"{scale:.4g}")
    msg = ""
    if stats:
        serr = max((bc[n] - bp[n]).abs().max().item() / bp[n].abs().max().item() for n in bp)
        if not (bp and serr <= TOL_KERNEL):
            fail(f"{label}: BatchNorm statistics after {n_steps} steps {serr:.4g} of max |cpu| "
                 f"from the CPU's, tol {TOL_KERNEL}")
        msg = (f"; the {len(bp)} BatchNorm statistics after {n_steps} steps {serr:.3e} of max "
               f"|cpu| (tol {TOL_KERNEL})")
    if gb is not None:
        noisy.sort(reverse=True)
        msg += (f"; {len(zero)} leaves zero to rounding (fp32 gradient <= {ZERO_SHARE} x the "
                f"CPU's bf16 distance), held only within all: "
                + ", ".join(f"{n} (CPU bf16 {r:.3g}x its fp32 max, card {c:.3g}x the CPU's bf16 "
                            f"distance)" for r, n, c in sorted(zero)[::-1])
                + f"; every other leaf's fp32 gradient at least {live[0]:.3g} x the CPU's bf16 "
                f"distance ({live[1]}); {len(held_below)} below it, held by the larger of the "
                f"CPU's and the card's plain versions' distances"
                + "".join(f", {n} (fp32 {s_:.3g}, CPU bf16 {d_:.3g}, card plain {p_:.3g}, card "
                          f"{e_:.3g})" for n, s_, d_, p_, e_ in held_below)
                + f"; {len(noisy)} leaves that bf16 rounding moves past "
                f"{TOL_TRAIN_LEAF} of their max on the CPU, the largest "
                + ", ".join(f"{n} CPU bf16 {r:.3g}, card {c:.3g}" for r, n, c in noisy[:6]))
    log(f"  {label}, card bf16 vs CPU fp32 on live weights: loss {lc:.6f} vs {lp:.6f} "
        f"({abs(lc - lp) / abs(lp):.2e} rel, tol {TOL_KERNEL}); {len(gp)} trainable leaves' "
        f"gradients: {err / scale:.3e} of max |cpu| over all (tol {TOL_KERNEL}), the leaf nearest "
        f"its bar {worst[1]}: {worst[2]:.3e} of its own max (its bar {worst[3]:.3g}: "
        f"{TOL_TRAIN_LEAF}" + (f" + {TRAIN_NOISE} x the CPU's bf16 distance" if gb is not None
                              else "") + f"); launches { {k: v for k, v in nc.items() if v} }{msg}")


def port_kernel_names():
    """The names of every __global__ function in the port's CUDA sources."""
    import re
    csrc = os.path.join(os.path.dirname(os.path.abspath(__file__)), "stgcma_tpu_torch", "csrc")
    kernel = re.compile(r"__global__\s+void\s+(?:__launch_bounds__\([^()]*\)\s*)?(\w+)\s*\(")
    names = set()
    for f in os.listdir(csrc):
        if f.endswith(".cu"):
            with open(os.path.join(csrc, f)) as fh:
                names.update(kernel.findall(fh.read()))
    return names


def profile_train_step(title, model, opt, pipe, forward, batch, smi, steps_timed=5,
                       recompute=None):
    """A train step on the card through `make_train_step` (bf16 compute, fp32
    masters, Adam): `pipe(batch, generator)` -> (a, v), `forward(model, a,
    v, generator)` -> the loss. Wall ms, the span of each part between CUDA
    events (pipeline, forward, backward, Adam), clips/s, peak memory; then
    one step under torch.profiler (reading a step's trace takes 5-11 s on
    the H100's host): kernel ms a step, split into the
    pipeline's, the forward's (its torch ops' kernels and the port's, told
    by name), Adam's and the backward's (the rest), and the device's busy
    share. `recompute` (ms, calls, kernel): one kernel's recompute estimated
    from its gradient rows."""
    import re
    import statistics
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function
    from stgcma_tpu_torch.train import steps
    ev = {}

    def mark(key):
        ev[key] = torch.cuda.Event(enable_timing=True)
        ev[key].record()

    def loss_fn(m, b, generator):
        mark("start")
        with record_function("train: pipeline"):
            a, v = pipe(b, generator)
        mark("pipeline")
        with record_function("train: forward"):
            loss = forward(m, a, v, generator)
        mark("forward")
        return loss, {}
    real_step = opt.step

    def adam():
        mark("backward")
        with record_function("train: Adam"):
            real_step()
        mark("adam")
    opt.step = adam
    step = steps.make_train_step(loss_fn, opt, torch.bfloat16)
    g = torch.Generator().manual_seed(SEED)
    for _ in range(2):
        step(model, batch, g)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    walls, parts = [], []
    for _ in range(steps_timed):
        t0 = time.perf_counter()
        loss, _ = step(model, batch, g)
        float(loss)
        torch.cuda.synchronize()
        walls.append(1e3 * (time.perf_counter() - t0))
        keys = ("start", "pipeline", "forward", "backward", "adam")
        parts.append([ev[a].elapsed_time(ev[b]) for a, b in zip(keys, keys[1:])])
    peak = torch.cuda.max_memory_allocated()
    wall = statistics.median(walls)
    spans = [statistics.median(p[i] for p in parts) for i in range(4)]
    log(f"  train step {title}, B={TRAIN_B}, bf16 compute, fp32 masters, on {smi}: wall "
        f"{wall:.2f} ms (median of {steps_timed}; {', '.join(f'{w:.2f}' for w in walls)}), "
        f"{TRAIN_B * 1e3 / wall:.2f} clips/s; spans between events: pipeline {spans[0]:.2f} ms, "
        f"forward {spans[1]:.2f}, backward {spans[2]:.2f}, Adam {spans[3]:.2f}; peak memory "
        f"{peak / 2 ** 30:.2f} GiB")
    n = 1
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            float(step(model, batch, g)[0])
        torch.cuda.synchronize()
        prof_wall = 1e3 * (time.perf_counter() - t0) / n
    t_read = time.perf_counter()
    opt.step = real_step
    # the port's kernels, launched through ctypes, hang under no torch op: they
    # are told by name (all of them run in the forward); a range's other
    # kernels are its torch ops'
    port = re.compile(r"\b(" + "|".join(sorted(port_kernel_names())) + r")\b")
    dev, ours, part = 0.0, 0.0, {"pipeline": 0.0, "forward": 0.0, "Adam": 0.0}
    for e in prof.events():
        if e.device_type == DeviceType.CPU:
            name = e.name[len("train: "):] if e.name.startswith("train: ") else None
            if name in part:
                part[name] += e.device_time_total / 1e3 / n
        elif not e.name.startswith("train: "):     # not a range's span on the card
            ms = (e.time_range.end - e.time_range.start) / 1e3 / n
            dev += ms
            if port.search(e.name):
                ours += ms
    if dev <= 0:
        log("  torch.profiler: no kernel on the card; the split is not measured")
        return {"wall_ms": wall, "peak_gib": peak / 2 ** 30}
    back = dev - part["pipeline"] - part["forward"] - ours - part["Adam"]
    extra = ""
    if recompute is not None:
        rms, calls, kid = recompute
        extra = (f" ({kid}'s recompute {rms:.2f}, from the gradient rows' backward kernels at "
                 f"the step's {calls} calls; plain autograd of the rest {back - rms:.2f})")
    log(f"  profiled (one step, {prof_wall:.2f} ms under the profiler, {smi}): kernels "
        f"{dev:.2f} ms a step = {100 * dev / prof_wall:.1f}% busy ({100 * dev / wall:.1f}% of the "
        f"untraced median); pipeline {part['pipeline']:.2f} ms, forward "
        f"{part['forward'] + ours:.2f} (the port's kernels {ours:.2f}), backward {back:.2f}"
        f"{extra}, Adam {part['Adam']:.2f}; the trace read in {time.perf_counter() - t_read:.1f} s")
    return {"wall_ms": wall, "peak_gib": peak / 2 ** 30, "kernels_ms": dev,
            "busy": dev / prof_wall}


def time_train_step(cfg, smi, k1_rows, steps_timed=5):
    """`profile_train_step` on CLIP ViT-B/16 fusion at full width, B =
    TRAIN_B, the CLI's path (the train pipeline on the card); K1's
    recompute estimated from the gradient rows' backward kernel ms over the
    step's 4 x layers calls."""
    import torch
    from stgcma_tpu_torch.data.datasets import SyntheticAVE
    from stgcma_tpu_torch.data.loader import collate, make_ave_device_pipeline
    from stgcma_tpu_torch.models.ave import apply_clip_ave, random_clip_ave
    from stgcma_tpu_torch.ops.fbank import CLIP_FBANK
    from stgcma_tpu_torch.train import losses, optim, steps
    model = live_clip_adapters_(random_clip_ave(cfg, SEED), SEED).to("cuda")
    steps.init_train_state(model)
    pipe = make_ave_device_pipeline(CLIP_FBANK, 102, train=True, image_size=224, device="cuda")
    ds = SyntheticAVE(n=TRAIN_B, num_frames=cfg.num_frames, size=224, label_dim=cfg.label_dim)
    batch = collate([ds[i] for i in range(TRAIN_B)])
    labels = torch.from_numpy(batch["labels"]).to("cuda")
    recompute = cfg.layers * sum(r["backward_kernel_ms"] for r in k1_rows)   # a call a site
    return profile_train_step(
        f"CLIP ViT-B/16 fusion, {cfg.layers} layers", model,
        optim.build_optimizer(model, 1e-4, 50.0), pipe,
        lambda m, a, v, gen: losses.ave_loss(apply_clip_ave(
            m, cfg, a.to(torch.bfloat16), v.to(torch.bfloat16), generator=gen), labels), batch,
        smi, steps_timed, recompute=(recompute, 4 * cfg.layers, "K1"))


def phase_train(cfg, smi, cut_layers=2):
    """AVE-29 training on CLIP ViT-B/16 fusion at full width (12 layers, C =
    768, T = 10), B = TRAIN_B, bf16 compute with fp32 masters: K1's gradient
    at its four sites; the CLI's straight 2-epoch run (plateau LR) with
    exact K1 launches; a run resumed after epoch 1 against it; one step at
    depth `cut_layers` against the CPU; the step's times. Returns (K1's
    gradient rows, the launches of the CLI's training run: the path's own)."""
    import tempfile
    import numpy as np
    import torch
    from stgcma_tpu_torch.models.ave import apply_clip_ave, init_clip_ave, random_clip_ave
    from stgcma_tpu_torch.ops import fused_attn as FA
    from stgcma_tpu_torch.train import losses
    t0 = time.perf_counter()
    rows = k1_grad_rows(cfg, TRAIN_B)

    def init():
        return init_clip_ave(cfg, generator=torch.Generator().manual_seed(0), device="cuda")

    def k1_only(n):
        return {**{k: 0 for k in KERNELS}, "K1": n}
    with tempfile.TemporaryDirectory() as tmp:
        FA.reset_launches()
        straight = train_cli(os.path.join(tmp, "b"), "--n-epochs", "2", "--lr_adapt", "True")
        totals = launches()
        check_cli_run("train CLIP ViT-B/16", straight, init(),
                      lambda forwards: k1_only(4 * cfg.layers * forwards), totals)
        train_cli(os.path.join(tmp, "c"), "--n-epochs", "1", "--lr_adapt", "True")
        resumed = train_cli(os.path.join(tmp, "c"), "--n-epochs", "2", "--lr_adapt", "True",
                            "--resume", "True")
        check_resume(straight, resumed, dict(init().named_parameters()))
        del straight, resumed
    cut = dataclasses.replace(cfg, layers=cut_layers)
    rng = np.random.RandomState(SEED)
    batch = clip_batch(cut, rng, TRAIN_B)
    labels = np.eye(cut.label_dim, dtype=np.float32)[rng.randint(0, cut.label_dim,
                                                                TRAIN_B * cut.num_frames)]

    def make_loss(dev, dt):
        a, v, y = (torch.from_numpy(x).to(dev) for x in (batch["a"], batch["v"], labels))
        return lambda m, _, generator: (losses.ave_loss(
            apply_clip_ave(m, cut, a.to(dt), v.to(dt), generator=generator),
            y.view(TRAIN_B, cut.num_frames, -1)), {})
    step_against_cpu(f"one train step at depth {cut_layers}, B={TRAIN_B}",
                     live_clip_adapters_(random_clip_ave(cut, SEED), SEED), make_loss,
                     k1_only(4 * cut_layers))
    time_train_step(cfg, smi, rows)
    log(f"  phase_train: {time.perf_counter() - t0:.1f} s")
    return rows, totals


# ---------------------------------------------------------------------------
# phase 6: Swin training — AVE-29 on Swin-Base fusion and AVSBench on
# Swin-Large, every float kernel's recompute on the card
# ---------------------------------------------------------------------------

def k1_swin_grad_rows(cfg, b, g, tower):
    """K1 at Swin sites at B = b: the shifted windows of stages 0-1 (bias:
    a random table gathered, plus the shift mask) and the temporal sites of
    stages 0-1, whose trainable per-modality table (random, std 0.5) is a
    leaf: its gradient flows from K1's recompute through `gather_bias`'s
    index backward (an accumulating index_put on the card)."""
    import torch
    from stgcma_tpu_torch.ops import fused_attn as FA
    from stgcma_tpu_torch.ops import window
    from stgcma_tpu_torch.ops.attention import gather_bias
    T, ws = cfg.num_ttokens, cfg.window_size
    rel = torch.from_numpy(window.relative_position_index(ws)).cuda()
    t_idx = torch.from_numpy(window.temporal_relative_index(T)).cuda()
    names = ("x", "ln_w", "ln_b", "w_qkv", "b_qkv", "w_proj", "b_proj")
    rows = []
    for s, temporal in ((0, False), (1, False), (0, True), (1, True)):
        H, _ = cfg.stage_resolution(s)
        C, heads = cfg.stage_dim(s), cfg.num_heads[s]
        if temporal:
            N, Bq, idx, mask = T, b * H * H, t_idx, None
        else:
            N, idx = ws * ws, rel
            mask = torch.from_numpy(window.shift_attn_mask(H, H, ws, ws // 2)).cuda()
            Bq = b * T * mask.shape[0]
        args, _ = make_block_inputs(g, Bq, N, C, heads, False)
        leaves = dict(zip(names, (_leaf(a) for a in args)))
        leaves["table"] = _leaf(_rnd(g, int(idx.max()) + 1, heads, std=0.5,
                                     dtype=torch.bfloat16))

        def run(fn, lv, idx=idx, mask=mask, N=N, heads=heads):
            bias = gather_bias(lv["table"], idx, heads, N)[None]
            bias = (bias if mask is None else bias + mask[:, None]).contiguous()
            return fn(*(lv[n] for n in names), heads, bias=bias)

        def library(lv=leaves, Bq=Bq, N=N, C=C, heads=heads, idx=idx, mask=mask):
            bias = gather_bias(lv["table"], idx, heads, N)[None]
            bias = (bias if mask is None else bias + mask[:, None]).contiguous()
            return library_block([lv[n] for n in names], heads, False, bias)().view(Bq, N, C)
        site = f"temporal T={T}" if temporal else "shifted windows"
        rows.append(grad_row(f"K1 {tower} stage {s} {site} {(Bq, N, C)} h{heads}", FA.win_block,
                             FA.win_block_plain, run, leaves, k1_grad_bound(Bq, N, C, heads),
                             library))
        del leaves
    return rows


def k4_grad_rows(cfg, b, g, sfu, tower, tol, sharp_stage3=False):
    """K4 at stage 2 unshifted and shifted and stage 3 at B = b, the block of
    `random_swin_ave` with live adapters and gates (`live_k4_weights`), every
    float operand a leaf, the relative-position table too (its bias gathered
    in the call, the window and shift masks added, as
    `swin_fusion_whole_block` does). With `sharp_stage3` (Swin-Large, C =
    1536 and D = 96 at stage 3, whose sharp fusion softmax carries bf16
    rounding through the backward) the stage-3 row's gradients are held at
    TOL_GRAD on top of K4_ST3_JAX_BF16, JAX's own bf16 distance there, and
    stage 3 runs once more with D_fc1 halved (a softer fusion softmax) at
    TOL_GRAD alone."""
    import torch
    from stgcma_tpu_torch.models.ave import random_swin_ave
    from stgcma_tpu_torch.nn.swin import backbone_statics
    from stgcma_tpu_torch.ops import swin_block as SB
    from stgcma_tpu_torch.ops.attention import gather_bias
    from stgcma_tpu_torch.ops.common import cast_tree
    bf = torch.bfloat16
    BT = b * cfg.num_ttokens
    model = random_swin_ave(dataclasses.replace(cfg, depths=cfg.depths[:3] + (1,)), SEED)
    statics = backbone_statics(cfg)
    rows = []
    sites = [(2, 0, False), (2, 1, False), (3, 0, False)] + ([(3, 0, True)] if sharp_stage3
                                                             else [])
    for s, i, halved in sites:
        st = statics[s][i]
        blk = cast_tree(model.backbone.layers[s].blocks[i], bf).cuda()
        geo = {dev: SB._geo_tensors(st.H, st.W, st.window_size, st.shift_size, torch.device(dev))
               for dev in ("cuda", "cpu")}
        N, C = st.H * st.W, st.dim
        w = live_k4_weights(SB.block_weights(blk), g)
        if halved:
            w.update({f"{k}_w1": w[f"{k}_w1"] * 0.5 for k in ("s2v", "s2a", "sv", "sa")})
        w = {k: _leaf(t) for k, t in w.items()}
        leaves = {"v": _leaf(_rnd(g, BT, N, C, std=0.1, dtype=bf)),
                  "a": _leaf(_rnd(g, BT, N, C, std=0.1, dtype=bf)), **w,
                  "table": _leaf(blk.attn.relative_position_bias_table)}

        def bias_of(lv, st=st, geo=geo, N=N):
            index, attn_mask, _ = geo[lv["v"].device.type]
            return (gather_bias(lv["table"], index, st.num_heads, N) + attn_mask)[None].contiguous()

        def run(fn, lv, st=st, geo=geo, bias_of=bias_of):
            return fn(lv["v"], lv["a"], {k: lv[k] for k in w}, st.num_heads, bias_of(lv),
                      geo[lv["v"].device.type][2])

        def library(lv=leaves, st=st, geo=geo, bias_of=bias_of):
            return library_k4(lv["v"], lv["a"], {k: lv[k] for k in w}, st.num_heads,
                              bias_of(lv), geo["cuda"][2])()
        D = w["s2v_w1"].shape[0]
        rows.append(grad_row(
            f"K4 {tower} stage {s} block {i} {(BT, N, C)} h{st.num_heads} shift {st.shift_size} "
            f"D {D}" + (", D_fc1 halved" if halved else ""), SB.swin_block, SB.swin_block_plain,
            run, leaves,
            block_k4_bound(BT, N, C, st.num_heads, D, sfu, window=st.window_size ** 2, grad=True),
            library, tol, grad_tol=TOL_GRAD + (K4_ST3_JAX_BF16 if sharp_stage3 and s == 3
                                                and not halved else 0.0)))
        del leaves, w
    return rows


def fuse_grad_rows(cfg, b, g, sfu, tower):
    """K5 over the windows and K6 over the full grid of stages 0-1 at B = b,
    hiddens N(0, 0.7), gates 0.8 and -0.6, all four leaves."""
    import torch
    from stgcma_tpu_torch.ops import fused_attn as FA
    bf = torch.bfloat16
    BT, ws = b * cfg.num_ttokens, cfg.window_size
    rows = {"K5": [], "K6": []}
    for kid, kernel in (("K5", FA.win_fuse), ("K6", FA.bidir_fuse)):
        for s in (0, 1):
            H, _ = cfg.stage_resolution(s)
            D = int(cfg.stage_dim(s) * cfg.adapter_ratios[s])
            R, n = (BT * (H // ws) ** 2, ws * ws) if kid == "K5" else (BT, H * H)
            leaves = {"vh": _leaf(_rnd(g, R, n, D, std=0.7, dtype=bf)),
                      "ah": _leaf(_rnd(g, R, n, D, std=0.7, dtype=bf)),
                      "gate_v": _leaf(torch.tensor([0.8], dtype=bf, device="cuda")),
                      "gate_a": _leaf(torch.tensor([-0.6], dtype=bf, device="cuda"))}

            def run(fn, lv):
                return fn(lv["vh"], lv["ah"], lv["gate_v"], lv["gate_a"])
            site = "windows" if kid == "K5" else "full grid"
            rows[kid].append(grad_row(
                f"{kid} {tower} stage {s} {site} {(R, n, D)}", kernel, FA.fuse_plain, run, leaves,
                fuse_bound(R, n, n, D, sfu, grad=True),
                lambda lv=leaves: library_fuse(lv["vh"], lv["ah"], lv["gate_v"], lv["gate_a"])()))
            del leaves
    return rows


def k7_grad_row(g, name, M, C):
    """K7 at (M, C), hidden 4C, every operand a leaf."""
    import torch
    import torch.nn.functional as F
    from stgcma_tpu_torch.ops import fused_attn as FA
    bf, Hd = torch.bfloat16, 4 * C
    leaves = dict(zip(("x", "ln_w", "ln_b", "w1", "b1", "w2", "b2"), (_leaf(t) for t in (
        _rnd(g, M, C, dtype=bf), (1 + _rnd(g, C, std=0.1)).to(bf), _rnd(g, C, std=0.02, dtype=bf),
        _rnd(g, Hd, C, std=0.05, dtype=bf), _rnd(g, Hd, dtype=bf),
        _rnd(g, C, Hd, std=0.02, dtype=bf), _rnd(g, C, std=0.02, dtype=bf)))))

    def run(fn, lv):
        return fn(*lv.values())

    def library():
        a = list(leaves.values())
        return F.linear(F.gelu(F.linear(F.layer_norm(a[0], (C,), a[1], a[2]), a[3], a[4])), a[5],
                        a[6])
    t_tensor = 2 * 2 * M * C * Hd / H100_BF16
    t_bytes = (2 * M * C * 2 + 2 * C * Hd * 2 + (Hd + 3 * C) * 2) / H100_BYTES
    return grad_row(f"{name} {(M, C)} hidden {Hd}", FA.ffn, FA.ffn_plain, run, leaves,
                    _bound(t_tensor, 0.0, t_bytes, grad=True), library)


def k9_grad_rows(cfg, b, g, tower):
    """K9 at every norm site of one stream of `cfg` at B = b (`k9_sites`)."""
    import torch
    import torch.nn.functional as F
    from stgcma_tpu_torch.ops import fused_attn as FA
    bf = torch.bfloat16
    rows = []
    for site, M, Cn in k9_sites(cfg, b):
        leaves = {"x": _leaf(_rnd(g, M, Cn, std=2.0, dtype=bf)),
                  "ln_w": _leaf((1 + _rnd(g, Cn, std=0.1)).to(bf)),
                  "ln_b": _leaf(_rnd(g, Cn, std=0.02, dtype=bf))}

        def run(fn, lv):
            return fn(lv["x"], lv["ln_w"], lv["ln_b"])
        rows.append(grad_row(f"K9 {tower} {site} {(M, Cn)}", FA.layernorm, FA.layernorm_plain,
                             run, leaves, ln_bound(M, Cn, grad=True),
                             lambda lv=leaves, Cn=Cn: F.layer_norm(lv["x"], (Cn,), lv["ln_w"],
                                                                    lv["ln_b"])))
        del leaves
    return rows


def k8_grad_rows(cfg, b, g, tower):
    """The K8 site at the temporal branches that take it (more than 16 heads)
    at B = b: the packed qkv (B * H * W, T, 3C) and the trainable temporal
    table (random, std 0.5) as leaves; the bias (heads, T, T) gathered in the
    call, so that K8's bias gradient (dbm, summed over the rows as
    `_wmsa_bwd` sums it) reaches the table through `gather_bias`."""
    import torch
    from stgcma_tpu_torch.ops import fused_attn as FA
    from stgcma_tpu_torch.ops import window
    from stgcma_tpu_torch.ops.attention import gather_bias
    T = cfg.num_ttokens
    t_idx = torch.from_numpy(window.temporal_relative_index(T)).cuda()
    rows = []
    for s in range(cfg.num_layers):
        if FA.block_kernel_route(cfg.num_heads[s]):
            continue
        H, _ = cfg.stage_resolution(s)
        C, heads = cfg.stage_dim(s), cfg.num_heads[s]
        Bq = b * H * H
        leaves = {"qkv": _leaf(_rnd(g, Bq, T, 3 * C, dtype=torch.bfloat16)),
                  "table": _leaf(_rnd(g, 2 * T - 1, heads, std=0.5, dtype=torch.bfloat16))}

        def bias_of(lv, heads=heads):
            return gather_bias(lv["table"], t_idx, heads, T).contiguous()

        def run(fn, lv, heads=heads, bias_of=bias_of):
            return fn(lv["qkv"], bias_of(lv), heads)
        rows.append(grad_row(
            f"K8 {tower} stage {s} temporal T={T} {(Bq, T, 3 * C)} h{heads}", FA.wmsa_qkv,
            FA.wmsa_qkv_plain, run, leaves, wmsa_bound(Bq * heads, T, C // heads, heads, grad=True),
            lambda lv=leaves, heads=heads, bias_of=bias_of: library_wmsa_qkv(
                lv["qkv"], bias_of(lv), heads)()))
        del leaves
    return rows


def phase_grad_kernels(cfg, k10_cfg):
    """The gradient rows of K10 (its Swin-Base 168^2 check site at B = 8,
    (80, 1764, 16)) and of K12, K13, K14 at the CLIP-B/16 fusion check sites
    at B = TRAIN_B, with live adapters and gates: every new recompute runs on
    the card once."""
    import torch
    import torch.nn.functional as F
    from stgcma_tpu_torch.models.ave import random_clip_ave
    from stgcma_tpu_torch.ops import clip_block as PCB
    from stgcma_tpu_torch.ops import fused_attn as FA
    from stgcma_tpu_torch.ops.common import cast_tree
    g = torch.Generator(device="cuda").manual_seed(SEED + 10)
    bf = torch.bfloat16
    sfu = sfu_rate()
    out = {"K10": [], "K12": [], "K13": [], "K14": []}
    BT = B * k10_cfg.num_ttokens
    H, _ = k10_cfg.stage_resolution(0)
    D = int(k10_cfg.stage_dim(0) * k10_cfg.adapter_ratios[0])
    leaves = {n: _leaf(_rnd(g, BT, H * H, D, std=0.7, dtype=bf)) for n in ("q", "k")}
    leaves["v"] = leaves["k"]

    def run10(fn, lv):
        return fn(lv["q"], lv["k"], lv["k"])
    out["K10"].append(grad_row(
        f"K10 Swin-Base 168^2 stage 0 grid {(BT, H * H, D)}, a2v", FA.unscaled_attention,
        FA.unscaled_attention_plain, run10, {"q": leaves["q"], "k": leaves["k"]},
        k10_bound(BT, H * H, H * H, D, sfu, grad=True),
        lambda: F.scaled_dot_product_attention(leaves["q"], leaves["k"], leaves["k"], scale=1.0)))
    del leaves

    C, heads, T = cfg.embed_dim, cfg.heads, cfg.num_frames
    Nv, Na, BT = cfg.num_patches + 1, cfg.num_patches_audio + 1, TRAIN_B * cfg.num_frames
    blk = cast_tree(random_clip_ave(dataclasses.replace(cfg, layers=1), SEED).backbone
                    .resblocks[0], bf).cuda()
    w = {k: _leaf(t) for k, t in live_k4_weights(PCB.block_weights(blk), g,
                                                   [k for k, _ in PCB.ADAPTERS]).items()}
    D = w["sv_w1"].shape[0]
    lv = {"v": _leaf(_rnd(g, BT, Nv, C, std=0.1, dtype=bf)),
          "a": _leaf(_rnd(g, BT, Na, C, std=0.1, dtype=bf)), **w}
    out["K12"].append(grad_row(
        f"K12 v {(BT, Nv, C)} a {(BT, Na, C)} h{heads} D {D}", PCB.clip_fusion_block,
        PCB.fusion_block_plain, lambda fn, x: fn(x["v"], x["a"], {k: x[k] for k in w}, heads), lv,
        clip_block_bound(BT, Nv, Na, C, heads, D, sfu, False, grad=True),
        lambda: library_k12(lv["v"], lv["a"], {k: lv[k] for k in w}, heads)()))
    del lv, w
    wt = {k: _leaf(t) for k, t in live_k4_weights(
        PCB.tadapt_weights(blk.attn, blk.ln_1, blk.T_Adapter), g, ["ad"]).items()}
    R = TRAIN_B * Nv
    lv = {"x": _leaf(_rnd(g, R, T, C, std=0.1, dtype=bf)), **wt}
    out["K13"].append(grad_row(
        f"K13 video rows {(R, T, C)} h{heads} D {D}", PCB.clip_tadapt, PCB.tadapt_plain,
        lambda fn, x: fn(x["x"], {k: x[k] for k in wt}, heads), lv,
        tadapt_bound(R, T, C, heads, D, sfu, False, grad=True),
        lambda: library_k13(lv["x"], {k: lv[k] for k in wt}, heads)()))
    lv = {"x": _leaf(_rnd(g, BT, Nv, C, std=0.1, dtype=bf)), **wt}
    out["K14"].append(grad_row(
        f"K14 video rows {(BT, Nv, C)} h{heads} T {T} D {D}", PCB.clip_tv2, PCB.tv2_plain,
        lambda fn, x: fn(x["x"], {k: x[k] for k in wt}, heads, T), lv,
        tadapt_bound(TRAIN_B * Nv, T, C, heads, D, sfu, False, grad=True),
        lambda: library_k14(lv["x"], {k: lv[k] for k in wt}, heads, T, None)()))
    return out


def swin_launches(cfg, batches):
    """{kernel: launches} of forwards at the batch sizes `batches`."""
    from stgcma_tpu_torch.nn.swin import launches_per_forward
    want = {k: 0 for k in KERNELS}
    for b in batches:
        for k, v in launches_per_forward(cfg, b).items():
            want[k] += v
    return want


def swin_clip_batch(cfg, rng, b):
    """Random (a, v) of a Swin AVE (a (b, T, 224, 224), v (b, T, 224, 224, 3))
    and one-hot labels (b, T, label_dim)."""
    import numpy as np
    n, T = cfg.img_size, cfg.num_frames
    labels = np.eye(cfg.label_dim, dtype=np.float32)[rng.randint(0, cfg.label_dim, b * T)]
    return (rng.randn(b, T, n, n).astype(np.float32), rng.randn(b, T, n, n, 3).astype(np.float32),
            labels.reshape(b, T, -1))


def phase_train_swin(cfg, smi, cut_depths=(2, 2, 2, 2)):
    """AVE-29 training on Swin-Base fusion (`BASELINE.json` configs[1]'s
    tower) at full width and depth, B = TRAIN_B, bf16 compute with fp32
    masters: gradient rows of K1 (stage 0-1 windows and temporal sites, the
    temporal table's gradient through `gather_bias`), K4 (stage 2 unshifted
    and shifted, stage 3), K5, K6, K7 (the stage-0 FFN's shape; at B = 2 the
    route sends no FFN to K7), K8 (stage 3's temporal site) and K9; the
    CLI's straight 2-epoch run (plateau LR) with exact launches; a run
    resumed after epoch 1 against it; one step at depths `cut_depths`
    against the CPU; the step's times. Returns (rows by kernel, the CLI
    run's launches, the step's times)."""
    import tempfile
    import numpy as np
    import torch
    from stgcma_tpu_torch.data.datasets import SyntheticAVE
    from stgcma_tpu_torch.data.loader import collate, make_ave_device_pipeline
    from stgcma_tpu_torch.models.ave import apply_swin_ave, init_swin_ave, random_swin_ave
    from stgcma_tpu_torch.ops import fused_attn as FA
    from stgcma_tpu_torch.ops.fbank import SWIN_FBANK
    from stgcma_tpu_torch.train import losses, optim, steps
    t0 = time.perf_counter()
    g = torch.Generator(device="cuda").manual_seed(SEED + 11)
    sfu = sfu_rate()
    tower = "Swin-Base"
    H0, _ = cfg.stage_resolution(0)
    rows = {"K1": k1_swin_grad_rows(cfg, TRAIN_B, g, tower),
            "K4": k4_grad_rows(cfg, TRAIN_B, g, sfu, tower, TOL_KERNEL),
            **fuse_grad_rows(cfg, TRAIN_B, g, sfu, tower),
            "K7": [k7_grad_row(g, f"K7 {tower} stage 0 FFN", TRAIN_B * cfg.num_ttokens * H0 * H0,
                               cfg.embed_dim)],
            "K8": k8_grad_rows(cfg, TRAIN_B, g, tower),
            "K9": k9_grad_rows(cfg, TRAIN_B, g, f"{tower} ")}
    tick(t0, "the gradient rows")

    def init():
        return init_swin_ave(cfg, generator=torch.Generator().manual_seed(0), device="cuda")
    with tempfile.TemporaryDirectory() as tmp:
        FA.reset_launches()
        straight = train_cli(os.path.join(tmp, "b"), "--n-epochs", "2", "--lr_adapt", "True",
                             model=SWIN_AVE)
        totals = launches()
        check_cli_run("train Swin-Base", straight, init(),
                      lambda forwards: swin_launches(cfg, [TRAIN_B] * forwards), totals)
        train_cli(os.path.join(tmp, "c"), "--n-epochs", "1", "--lr_adapt", "True", model=SWIN_AVE)
        resumed = train_cli(os.path.join(tmp, "c"), "--n-epochs", "2", "--lr_adapt", "True",
                            "--resume", "True", model=SWIN_AVE)
        check_resume(straight, resumed, dict(init().named_parameters()))
        del straight, resumed
    tick(t0, "the CLI runs")
    cut = dataclasses.replace(cfg, depths=cut_depths)
    a, v, y = swin_clip_batch(cut, np.random.RandomState(SEED), TRAIN_B)

    def make_loss(dev, dt):
        ta, tv, ty = (torch.from_numpy(x).to(dev) for x in (a, v, y))
        return lambda m, _, generator: (losses.ave_loss(
            apply_swin_ave(m, cut, ta.to(dt), tv.to(dt), generator=generator), ty), {})
    step_against_cpu(f"one train step at depths {cut_depths}, B={TRAIN_B}",
                     random_swin_ave(cut, SEED), make_loss, swin_launches(cut, [TRAIN_B]))
    tick(t0, "the step against the CPU")
    model = random_swin_ave(cfg, SEED).to("cuda")
    steps.init_train_state(model)
    pipe = make_ave_device_pipeline(SWIN_FBANK, 224, train=True, image_size=224, device="cuda")
    ds = SyntheticAVE(n=TRAIN_B, num_frames=cfg.num_frames, size=224, label_dim=cfg.label_dim)
    batch = collate([ds[i] for i in range(TRAIN_B)])
    labels = torch.from_numpy(batch["labels"]).to("cuda")
    timing = profile_train_step(
        f"Swin-Base fusion, depths {cfg.depths}", model, optim.build_optimizer(model, 1e-4, 50.0),
        pipe, lambda m, a_, v_, gen: losses.ave_loss(apply_swin_ave(
            m, cfg, a_.to(torch.bfloat16), v_.to(torch.bfloat16), generator=gen), labels),
        batch, smi)
    del model
    log(f"  phase_train_swin: {time.perf_counter() - t0:.1f} s")
    return rows, totals, timing


def avs_cli(exp, *flags):
    """`cli.run_adapt_avs.main` at its defaults (Swin-Large fusion, T = 5,
    TPAVI at all four stages) on the card, synthetic AVS at B = TRAIN_B."""
    from stgcma_tpu_torch.cli import run_adapt_avs
    with contextlib.redirect_stdout(sys.stderr):
        return run_adapt_avs.main(["--synthetic", "True", "--batch_size", str(TRAIN_B),
                                   "--num_workers", "2", "--device", "cuda", "--exp-dir", exp,
                                   *flags])


def phase_train_avs(cfg, hcfg, smi, cut_depths=(2, 2, 2, 2)):
    """AVSBench training through the port's `run_adapt_avs` on Swin-Large
    fusion at T = 5 with TPAVI at all four stages, full width and depth, B =
    TRAIN_B: K8's gradient rows at the stage 2-3 temporal sites (the bias
    gradient dbm reaching the temporal table); the CLI's straight 2-epoch
    run (plateau LR) with exact launches; `--eval_only` on its saved best
    checkpoint reproducing its best miou; under STGCMA_DETERMINISTIC=1 a
    straight run and a run resumed after epoch 1 against it (TOL_RESUME),
    the BatchNorm statistics too; two steps at depths `cut_depths` against
    the CPU, the BatchNorm statistics after them, and one step with TPAVI's
    BatchNorm on its running statistics (`step_against_cpu`'s `cpu_bf16`
    rule in both); the step's times. Returns
    (rows, the CLI run's launches, the step's times)."""
    import tempfile
    import torch
    from stgcma_tpu_torch.cli import run_adapt_avs as cli
    from stgcma_tpu_torch.cli.common import DETERMINISTIC
    from stgcma_tpu_torch.data.loader import collate, make_avs_device_pipeline
    from stgcma_tpu_torch.models.avs import apply_avs, init_avs, random_avs
    from stgcma_tpu_torch.ops import fused_attn as FA
    from stgcma_tpu_torch.ops.fbank import SWIN_FBANK
    from stgcma_tpu_torch.train import losses, optim, steps
    t0 = time.perf_counter()
    g = torch.Generator(device="cuda").manual_seed(SEED + 12)
    rows = {"K8": k8_grad_rows(cfg, TRAIN_B, g, "Swin-Large AVS")}
    tick(t0, "the gradient rows")

    def init():
        return init_avs(cfg, hcfg, generator=torch.Generator().manual_seed(0), device="cuda")
    with tempfile.TemporaryDirectory() as tmp:
        FA.reset_launches()
        straight = avs_cli(os.path.join(tmp, "b"), "--n-epochs", "2", "--lr_adapt", "True")
        totals = launches()
        check_cli_run("train AVS Swin-Large", straight, init(),
                      lambda forwards: swin_launches(cfg, [TRAIN_B] * forwards), totals)
        got = avs_cli(os.path.join(tmp, "e"), "--eval_only", "True", "--ckpt",
                      os.path.join(straight.exp_dir, "models", "best_model"))["miou"]
        if not abs(got - straight.best_metric) <= 1e-6:
            fail(f"AVS --eval_only on models/best_model: miou {got} against the run's best "
                 f"{straight.best_metric} (epoch {straight.best_epoch})")
        log(f"  AVS --eval_only --ckpt models/best_model: miou {got:.6f}, the run's best "
            f"{straight.best_metric:.6f} (epoch {straight.best_epoch} of {straight.n_epochs})")
        tick(t0, "the AVS CLI run and --eval_only")
        with environment({DETERMINISTIC: "1"}):      # the CLIs' switch
            straight = avs_cli(os.path.join(tmp, "d"), "--n-epochs", "2", "--lr_adapt", "True")
            avs_cli(os.path.join(tmp, "c"), "--n-epochs", "1", "--lr_adapt", "True")
            resumed = avs_cli(os.path.join(tmp, "c"), "--n-epochs", "2", "--lr_adapt", "True",
                              "--resume", "True")
        start = init()
        log("  the resume under STGCMA_DETERMINISTIC=1 (torch's deterministic algorithms):")
        check_resume(straight, resumed, dict(start.named_parameters()))
        resumed_buffers(straight, resumed, start)
        del straight, resumed, start
    tick(t0, "the resume")
    cut = dataclasses.replace(cfg, depths=cut_depths)
    args = cli.parse_args([])
    ds = cli.SyntheticAVS(TRAIN_B, cfg.num_frames, cfg.img_size, seed=SEED)
    batch = collate([ds[i] for i in range(TRAIN_B)])

    def make_loss(dev, dt):
        pipe = make_avs_device_pipeline(SWIN_FBANK, 224, args.dataset_mean, args.dataset_std,
                                        device=dev)
        loss_fn = cli.make_loss_fn(cut, hcfg, pipe, args, dt)
        return lambda m, _, generator: loss_fn(m, batch, generator)
    step_against_cpu(f"two AVS train steps at depths {cut_depths}, B={TRAIN_B}",
                     random_avs(cut, hcfg, SEED), make_loss, swin_launches(cut, [TRAIN_B]),
                     n_steps=2, stats=True, cpu_bf16=True)

    def make_running_loss(dev, dt):
        pipe = make_avs_device_pipeline(SWIN_FBANK, 224, args.dataset_mean, args.dataset_std,
                                        device=dev)
        gt = torch.from_numpy(batch["masks"][:, 0]).to(dev)[..., None]

        def loss_fn(m, _, generator):
            a, v = pipe({"frames": batch["frames"], "wave": batch["wave"]})
            pred, fmaps, afeas = apply_avs(m, cut, hcfg, a.to(dt), v.to(dt), train=False)
            return losses.iou_semantic_aware_loss(pred, gt, afeas, fmaps,
                                                  frames_per_clip=cut.num_frames)[0], {}
        return loss_fn
    step_against_cpu(f"one AVS step at depths {cut_depths}, B={TRAIN_B}, TPAVI's BatchNorm on "
                     f"its running statistics", random_avs(cut, hcfg, SEED), make_running_loss,
                     swin_launches(cut, [TRAIN_B]), cpu_bf16=True)
    tick(t0, "the steps against the CPU")
    model = random_avs(cfg, hcfg, SEED).to("cuda")
    steps.init_train_state(model)
    pipe = make_avs_device_pipeline(SWIN_FBANK, 224, args.dataset_mean, args.dataset_std,
                                    device="cuda")
    gt = torch.from_numpy(batch["masks"][:, 0]).to("cuda")[..., None]

    def forward(m, a_, v_, gen):
        pred, fmaps, afeas, _ = apply_avs(m, cfg, hcfg, a_.to(torch.bfloat16),
                                          v_.to(torch.bfloat16), train=True, return_state=True)
        return losses.iou_semantic_aware_loss(pred, gt, afeas, fmaps,
                                              frames_per_clip=cfg.num_frames)[0]
    timing = profile_train_step(
        f"AVS Swin-Large fusion T={cfg.num_frames}, depths {cfg.depths}", model,
        optim.build_optimizer(model, 1e-4, 0.1), lambda b, gen: pipe(b), forward, batch, smi)
    del model
    log(f"  phase_train_avs: {time.perf_counter() - t0:.1f} s")
    return rows, totals, timing


def avqa_cli(exp, *flags):
    """`cli.run_adapt_avqa.main` at its defaults (Swin-Large fusion, T = 10,
    the AVQA head, the QA head's dropout) on the card, synthetic AVQA at B =
    TRAIN_B."""
    from stgcma_tpu_torch.cli import run_adapt_avqa
    with contextlib.redirect_stdout(sys.stderr):
        return run_adapt_avqa.main(["--synthetic", "True", "--batch_size", str(TRAIN_B),
                                    "--num_workers", "2", "--device", "cuda", "--exp-dir", exp,
                                    *flags])


def avqa_launches(cfg, train_forwards, eval_forwards):
    """{kernel: launches} of `train_forwards` three-stream forwards (the nega
    stream's too) and `eval_forwards` two-stream ones (`answer_avqa`), each
    at B = TRAIN_B."""
    from stgcma_tpu_torch.nn.swin import launches_per_forward
    want = {k: 0 for k in KERNELS}
    for n, nega in ((train_forwards, True), (eval_forwards, False)):
        for k, v in launches_per_forward(cfg, TRAIN_B, nega=nega).items():
            want[k] += n * v
    return want


def k8_nega_grad_rows(cfg, b, g, tower):
    """The K8 site at the nega stream's windows at B = b, as under
    --freeze_base False, where its relative-position table trains: stage 2
    shifted (the bias of period nW x heads, the shift mask folded in) and
    stage 3 (one window a frame); leaves the packed qkv and the table, the
    bias gathered in the call as `window_attention_fused` gathers it."""
    import torch
    from stgcma_tpu_torch.ops import fused_attn as FA
    from stgcma_tpu_torch.ops import window
    from stgcma_tpu_torch.ops.attention import gather_bias
    ws = cfg.window_size
    N = ws * ws
    rel = torch.from_numpy(window.relative_position_index(ws)).cuda()
    rows = []
    for s, shift in ((2, ws // 2), (3, 0)):
        H, _ = cfg.stage_resolution(s)
        shift = shift if H > ws else 0
        C, heads = cfg.stage_dim(s), cfg.num_heads[s]
        mask = (torch.from_numpy(window.shift_attn_mask(H, H, ws, shift)).cuda() if shift
                else None)
        Bq = b * cfg.num_ttokens * (H // ws) ** 2
        leaves = {"qkv": _leaf(_rnd(g, Bq, N, 3 * C, dtype=torch.bfloat16)),
                  "table": _leaf(_rnd(g, int(rel.max()) + 1, heads, std=0.5,
                                      dtype=torch.bfloat16))}

        def bias_of(lv, heads=heads, mask=mask):
            bias = gather_bias(lv["table"], rel, heads, N)
            if mask is not None:
                bias = (bias[None] + mask[:, None].float()).reshape(-1, N, N)
            return bias.contiguous()

        def run(fn, lv, heads=heads, bias_of=bias_of):
            return fn(lv["qkv"], bias_of(lv), heads)
        P = heads * (1 if mask is None else mask.shape[0])
        rows.append(grad_row(
            f"K8 {tower} nega stage {s} windows shift {shift} {(Bq, N, 3 * C)} h{heads} "
            f"period {P} (--freeze_base False)", FA.wmsa_qkv, FA.wmsa_qkv_plain, run, leaves,
            wmsa_bound(Bq * heads, N, C // heads, P, grad=True),
            lambda lv=leaves, heads=heads, bias_of=bias_of: library_wmsa_qkv(
                lv["qkv"], bias_of(lv), heads)()))
        del leaves
    return rows


def avqa_forward_split(cfg, hcfg, model, a, v, vn, q, smi):
    """The AVQA train forward split into its parts on the card (bf16 casts
    of the masters, B = TRAIN_B, under autograd as the train step runs it):
    the device ms (torch.profiler) and the host span of the two-stream tower,
    the three-stream tower (`backbone_apply` with v_nega: the nega stream is
    the difference) and the whole `apply_avqa` (the head and match MLPs: the
    difference from the three-stream tower), with the memory each tower
    keeps for the backward (allocated after the forward, the graph alive).
    The nega stream reads only frozen leaves, so the three-stream tower may
    keep no more than its output beside the two-stream one's (fails past 64
    MiB). Its split by stage at the served B = 8 is
    `tools/trace_slice.py --model avqa`'s."""
    import torch
    from stgcma_tpu_torch.models import avqa
    from stgcma_tpu_torch.nn import swin
    from stgcma_tpu_torch.ops.common import cast_tree
    from stgcma_tpu_torch.train import steps
    m = cast_tree(model, torch.bfloat16)
    steps.init_train_state(m)
    bb = m.backbone
    parts = {"two-stream tower": lambda: swin.backbone_apply(bb, cfg, a=a, v=v),
             "three-stream tower": lambda: swin.backbone_apply(bb, cfg, a=a, v=v, v_nega=vn),
             "apply_avqa": lambda: avqa.apply_avqa(m, cfg, hcfg, a, v, vn, q, train=True,
                                                   generator=torch.Generator().manual_seed(0))}
    out = {}
    for name, fn in parts.items():
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        res = fn()
        torch.cuda.synchronize()
        kept = torch.cuda.memory_allocated() - base
        if name == "three-stream tower" and res["v_nega"].requires_grad:
            fail("AVQA: the nega stream recorded an autograd graph under freeze_base")
        del res
        out[name] = (kernel_ms(fn), cuda_ms(fn, 3, warmup=1), kept)
    two, three, whole = out["two-stream tower"], out["three-stream tower"], out["apply_avqa"]
    if three[2] - two[2] > 64 * 2 ** 20:
        fail(f"AVQA: the three-stream tower keeps {(three[2] - two[2]) / 2 ** 20:.1f} MiB more "
             f"for the backward than the two-stream one: the nega stream kept a graph")
    nega = [three[k] - two[k] for k in (0, 1)]
    head = [whole[k] - three[k] for k in (0, 1)]
    log(f"  AVQA train forward split, B={TRAIN_B}, under autograd, on {smi}: device ms (host "
        f"span ms): two-stream tower {two[0]:.2f} ({two[1]:.2f}), keeping "
        f"{two[2] / 2 ** 30:.3f} GiB for the backward; three-stream tower {three[0]:.2f} "
        f"({three[1]:.2f}) = {three[0] / two[0]:.3f}x, keeping {three[2] / 2 ** 30:.3f} GiB (the "
        f"nega stream {(three[2] - two[2]) / 2 ** 20:.1f} MiB: its output); the nega stream "
        f"{nega[0]:.2f} ({nega[1]:.2f}) = {2 * nega[0] / two[0]:.2f} of one fused stream; "
        f"apply_avqa {whole[0]:.2f} ({whole[1]:.2f}): the head and match MLPs {head[0]:.2f} "
        f"({head[1]:.2f})")
    split = {f"{n} device ms": v[0] for n, v in out.items()}
    split.update({f"{n} span ms": v[1] for n, v in out.items()})
    del m
    return split


def phase_train_avqa(cfg, hcfg, smi, cut_depths=(2, 2, 2, 2)):
    """MUSIC-AVQA training through the port's `run_adapt_avqa` on Swin-Large
    fusion at T = 10 (20 frames a stream at B = TRAIN_B, the nega stream a
    third), full width and depth: gradient rows at AVQA's sites; the CLI's
    straight 2-epoch run (plateau LR) with exact launches, `--eval_only` on
    its best checkpoint reproducing its best accuracy; under
    STGCMA_DETERMINISTIC=1 a straight run and a run resumed after epoch 1
    against it (TOL_RESUME); one step at depths `cut_depths` and B =
    TRAIN_B against the CPU (`step_against_cpu`'s `cpu_bf16` rule); the
    step's times and its forward's split; the grounding pretrainer on the
    card. Returns (rows, the CLI run's launches, the step's times)."""
    import tempfile
    import numpy as np
    import torch
    from stgcma_tpu_torch.cli import run_adapt_avqa as cli
    from stgcma_tpu_torch.cli.common import DETERMINISTIC
    from stgcma_tpu_torch.data.loader import collate, make_avqa_device_pipeline
    from stgcma_tpu_torch.models.avqa import apply_avqa, init_avqa, random_avqa
    from stgcma_tpu_torch.nn.swin import launches_per_forward
    from stgcma_tpu_torch.ops import fused_attn as FA
    from stgcma_tpu_torch.ops.fbank import SWIN_FBANK
    from stgcma_tpu_torch.tools import grounding_gen
    from stgcma_tpu_torch.train import losses, optim, steps
    t0 = time.perf_counter()
    g = torch.Generator(device="cuda").manual_seed(SEED + 13)
    sfu = sfu_rate()
    tower = "Swin-Large AVQA"
    k4_cfg = dataclasses.replace(cfg, depths=cut_depths)     # K4's blocks: stage 2's first two
    rows = {"K1": k1_swin_grad_rows(cfg, TRAIN_B, g, tower),
            "K4": k4_grad_rows(k4_cfg, TRAIN_B, g, sfu, tower, TOL_K4_LARGE, sharp_stage3=True),
            **fuse_grad_rows(cfg, TRAIN_B, g, sfu, tower),
            "K8": k8_grad_rows(cfg, TRAIN_B, g, tower) + k8_nega_grad_rows(cfg, TRAIN_B, g,
                                                                           tower)}
    tick(t0, "the gradient rows")

    def init():
        return init_avqa(cfg, hcfg, generator=torch.Generator().manual_seed(0), device="cuda")
    with tempfile.TemporaryDirectory() as tmp:
        FA.reset_launches()
        straight = avqa_cli(os.path.join(tmp, "b"), "--n-epochs", "2", "--lr_adapt", "True")
        totals = launches()
        steps_run, evals = straight.global_step, straight.n_epochs    # one eval batch an epoch
        # the balanced match CE's gradient of fc4's bias, mean(p) - 1/2 a class, is a
        # sum of (p - y) / n rounded to bf16, +-1/2n wherever p lies within 2^-9 of 1/2:
        # at init_avqa's weights the pairs cancel to 0 at every step
        check_cli_run("train AVQA Swin-Large", straight, init(),
                      lambda forwards: avqa_launches(cfg, steps_run, evals), totals,
                      rounding_zero=("avqatask.fc4.bias",))
        got = avqa_cli(os.path.join(tmp, "e"), "--eval_only", "True", "--ckpt",
                       os.path.join(straight.exp_dir, "models", "best_model"))["acc"]
        if got != straight.best_metric:
            fail(f"AVQA --eval_only on models/best_model: acc {got} against the run's best "
                 f"{straight.best_metric} (epoch {straight.best_epoch})")
        log(f"  AVQA --eval_only --ckpt models/best_model: acc {got}, the run's best "
            f"{straight.best_metric} (epoch {straight.best_epoch} of {straight.n_epochs})")
        tick(t0, "the AVQA CLI run and --eval_only")
        with environment({DETERMINISTIC: "1"}):      # the CLIs' switch
            straight = avqa_cli(os.path.join(tmp, "d"), "--n-epochs", "2", "--lr_adapt", "True")
            avqa_cli(os.path.join(tmp, "c"), "--n-epochs", "1", "--lr_adapt", "True")
            resumed = avqa_cli(os.path.join(tmp, "c"), "--n-epochs", "2", "--lr_adapt", "True",
                               "--resume", "True")
        log("  the resume under STGCMA_DETERMINISTIC=1 (torch's deterministic algorithms):")
        check_resume(straight, resumed, dict(init().named_parameters()))
        del straight, resumed
    tick(t0, "the resume")
    cut = dataclasses.replace(cfg, depths=cut_depths)
    args = cli.parse_args([])
    ds = cli.SyntheticAVQA(TRAIN_B, cfg.num_frames, cfg.img_size, seed=SEED)
    batch = {k: v for k, v in collate([ds[i] for i in range(TRAIN_B)]).items() if k != "qtype"}

    def make_loss(dev, dt):
        pipe = make_avqa_device_pipeline(SWIN_FBANK, 224, args.dataset_mean, args.dataset_std,
                                         device=dev)
        loss_fn = cli.make_loss_fn(cut, hcfg, pipe, args, dt)
        return lambda m, _, generator: loss_fn(m, batch, None)      # no dropout draw
    want = {k: 0 for k in KERNELS}
    want.update(launches_per_forward(cut, TRAIN_B, nega=True))
    step_against_cpu(f"one AVQA train step at depths {cut_depths}, B={TRAIN_B}",
                     random_avqa(cut, hcfg, SEED), make_loss, want, cpu_bf16=True)
    tick(t0, "the step against the CPU")
    model = random_avqa(cfg, hcfg, SEED).to("cuda")
    steps.init_train_state(model)
    pipe = make_avqa_device_pipeline(SWIN_FBANK, 224, args.dataset_mean, args.dataset_std,
                                     device="cuda")
    q = torch.from_numpy(batch["question"].astype(np.int64)).cuda()
    answer = torch.from_numpy(batch["answer"]).cuda()

    def pipes(b, gen):
        a_, v_ = pipe({"frames": b["frames"], "wave": b["wave"]})
        return a_, (v_, pipe({"frames": b["frames_nega"], "wave": b["wave"]})[1])

    def forward(m, a_, vv, gen):
        bf = torch.bfloat16
        out = apply_avqa(m, cfg, hcfg, a_.to(bf), vv[0].to(bf), vv[1].to(bf), q, train=True,
                         generator=gen)
        return losses.avqa_loss(*out, answer)[0]
    tick(t0, "the full-size model")
    timing = profile_train_step(
        f"AVQA Swin-Large fusion T={cfg.num_frames} with the nega stream, depths {cfg.depths} "
        f"(pipeline: two calls)", model, optim.build_optimizer(model, 1e-4, 0.1), pipes, forward,
        batch, smi)
    tick(t0, "the profiled step")
    a_, (v_, vn_) = pipes(batch, None)
    bf = torch.bfloat16
    timing.update(avqa_forward_split(cfg, hcfg, model, a_.to(bf), v_.to(bf), vn_.to(bf), q, smi))
    del model, a_, v_, vn_
    tick(t0, "the step's times")
    with tempfile.TemporaryDirectory() as tmp, contextlib.redirect_stdout(sys.stderr):
        t1 = time.perf_counter()
        grd = grounding_gen.main(["--synthetic", "True", "--epochs", "2", "--batch-size", "4",
                                  "--synthetic_n", "8", "--model_save_dir", tmp,
                                  "--device", "cuda"])
        best = os.path.join(tmp, "main_grounding_gen_best.pt")
        exported = torch.load(best, map_location="cpu", weights_only=False)
    losses_ = grd.step_losses
    if len(losses_) != 4 or not all(map(math.isfinite, losses_)):
        fail(f"grounding_gen on the card: step losses {losses_}")
    if set(exported) != {f"module.{k}.{w}" for k in grounding_gen.HEAD_KEYS
                         for w in ("weight", "bias")}:
        fail(f"grounding_gen on the card: export keys {sorted(exported)}")
    log(f"  tools.grounding_gen.main --synthetic True on the card (ResNet-18 at 224^2, 2 epochs "
        f"of 2 steps at batch 4): losses {', '.join(f'{x:.4f}' for x in losses_)}, the "
        f"reference-layout export written, {time.perf_counter() - t1:.1f} s")
    del grd
    log(f"  phase_train_avqa: {time.perf_counter() - t0:.1f} s")
    return rows, totals, timing

TOL_PVT_FP32 = 1e-3  # phase_avs_pvt: the card's fp32 mask logits against the CPU's at a cut
                     # depth, max |card - cpu| / max |cpu| (cuDNN's fp32 convolutions sum in
                     # another order, TF32 off)
TOL_PVT_BF16 = TOL_SLICE  # phase_avs_pvt: the card's bf16 mask logits against its own fp32 at
                     # full depth, max |bf16 - fp32| / max |fp32|: bf16 through PVT's 52 blocks
                     # and some 15 rounded decoder layers; the H100 read 2.23% (2e-2 missed), and
                     # the JAX package's own bf16 sits 2.6-3.3% from its fp32 on the CPU at
                     # depths 1/1/2/1 (tests/test_torch_port_pvt.py)
PVT_CUT = (1, 1, 2, 1)


def phase_avs_pvt(smi, b=B, cut_depths=PVT_CUT):
    """The PVT-v2-b5 AVS baseline (`models/avs.py::apply_avs_pvt`) at full
    size on the card: depths (3, 6, 40, 3), 224^2, b clips of T = 5 frames,
    `random_avs_pvt` weights, synthetic (b, 5, 128) VGGish features (the
    VGGish network is in neither package). The bf16 forward (mask logits
    (b*5, 224, 224, 1) finite; none of the port's kernels: PVT and the
    decoder are plain torch, as XLA in JAX) held to the card's fp32 at
    TOL_PVT_BF16; the train-mode forward with the four TPAVI BatchNorms'
    statistics; the card's fp32 against the CPU's at `cut_depths` on one
    clip (TOL_PVT_FP32); the bf16 forward's median wall, device ms and busy
    share (torch.profiler), peak memory, CUDA launches, `cost_analysis`'s
    flops and the achieved TFLOP/s; and `runtime/profiling.py`'s `trace`
    and `annotate` around one forward, whose exported trace must hold the
    region and CUDA kernels."""
    import statistics
    import tempfile
    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from stgcma_tpu_torch.configs import AVSHeadConfig
    from stgcma_tpu_torch.models.avs import apply_avs_pvt, random_avs_pvt
    from stgcma_tpu_torch.nn import pvt
    from stgcma_tpu_torch.ops import fused_attn as FA
    from stgcma_tpu_torch.ops.common import cast_tree
    from stgcma_tpu_torch.runtime import profiling as P
    t0 = time.perf_counter()
    T = 5
    hcfg = AVSHeadConfig(num_frames=T)          # vis_dim (64, 128, 320, 512), TPAVI at all four
    host = random_avs_pvt(hcfg, SEED)
    m32 = host.to("cuda").eval()
    m16 = cast_tree(m32, torch.bfloat16)
    n_par = sum(p.numel() for p in m32.parameters())
    rng = np.random.RandomState(SEED)
    frames = torch.from_numpy(rng.randn(b * T, 224, 224, 3).astype(np.float32)).cuda()
    audio = torch.from_numpy(rng.randn(b, T, 128).astype(np.float32)).cuda()
    f16, a16 = frames.bfloat16(), audio.bfloat16()
    log(f"  set-up: PVT-v2-b5 AVS ({n_par / 1e6:.1f} M parameters, encoder depths "
        f"{m32.encoder.cfg['depths']}), random weights on the card: "
        f"{time.perf_counter() - t0:.1f} s")

    def run16():
        return apply_avs_pvt(m16, hcfg, a16, f16)[0]

    with torch.no_grad():
        FA.reset_launches()
        out16 = run16()
        torch.cuda.synchronize()
        got = launches()
        if any(got.values()):
            fail(f"avs_pvt: the forward launched the port's kernels {got}; PVT reaches none")
        shape = (b * T, 224, 224, 1)
        if tuple(out16.shape) != shape or not torch.isfinite(out16).all():
            fail(f"avs_pvt bf16: masks of shape {tuple(out16.shape)}, finite="
                 f"{bool(torch.isfinite(out16).all())}")
        out32 = apply_avs_pvt(m32, hcfg, audio, frames)[0]
        err = float((out16.float() - out32).abs().max() / out32.abs().max())
        if not err <= TOL_PVT_BF16:
            fail(f"avs_pvt: bf16 against fp32 on the card at full depth {err:.4g} > "
                 f"{TOL_PVT_BF16}")
        log(f"  avs_pvt b={b} clips x T={T}: mask logits {shape} finite, no port kernel "
            f"launched; bf16 vs the card's fp32 at full depth: {err:.4g} of max |fp32| "
            f"(tol {TOL_PVT_BF16})")
        pred, _, afeas, state = apply_avs_pvt(m16, hcfg, a16, f16, train=True,
                                              return_state=True)
        want = sorted(f"tpavi_b{i + 1}" for i in hcfg.tpavi_stages)
        if sorted(state) != want or not torch.isfinite(pred).all() or not all(
                torch.isfinite(st[k]).all() for st in state.values() for k in ("mean", "var")):
            fail(f"avs_pvt train-mode forward: BatchNorm state {sorted(state)}, finite pred "
                 f"{bool(torch.isfinite(pred).all())}")
        moved = max(float((st["var"] - getattr(m16.avstask, k).W_z.bn.running_var.float())
                          .abs().max()) for k, st in state.items())
        log(f"  avs_pvt train mode: pred finite, BatchNorm statistics of {want} returned "
            f"(running var moved by up to {moved:.4g})")
        del out32, pred, afeas, state
        cut_cfg = dict(pvt.B5, depths=cut_depths)
        cut = random_avs_pvt(hcfg, SEED, pvt_cfg=cut_cfg)
        t1 = time.perf_counter()
        ref = apply_avs_pvt(cut, hcfg, audio[:1].cpu(), frames[:T].cpu())[0]
        cpu_s = time.perf_counter() - t1
        card = apply_avs_pvt(cut.to("cuda"), hcfg, audio[:1], frames[:T])[0].cpu()
        err = float((card - ref).abs().max() / ref.abs().max())
        if not err <= TOL_PVT_FP32:
            fail(f"avs_pvt fp32 at depths {cut_depths}: card vs CPU {err:.4g} > {TOL_PVT_FP32}")
        log(f"  avs_pvt fp32 at depths {cut_depths}, 1 clip: card vs CPU {err:.4g} of max |cpu| "
            f"(tol {TOL_PVT_FP32}; CPU forward {cpu_s:.1f} s)")
        del cut, card, ref
        for _ in range(2):
            run16()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        walls = []
        for _ in range(7):
            t1 = time.perf_counter()
            run16()
            torch.cuda.synchronize()
            walls.append(1e3 * (time.perf_counter() - t1))
        peak = torch.cuda.max_memory_allocated()
        wall = statistics.median(walls)
        flops = P.cost_analysis(run16)["flops"]
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t1 = time.perf_counter()
            run16()
            torch.cuda.synchronize()
            prof_wall = 1e3 * (time.perf_counter() - t1)
        kern = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
        dev = sum(e.time_range.end - e.time_range.start for e in kern) / 1e3
        log(f"  avs_pvt bf16 forward, b={b} clips x T={T} at 224^2 on {smi}: median wall "
            f"{wall:.2f} ms of 7 ({', '.join(f'{w:.2f}' for w in walls)}) = "
            f"{b * 1e3 / wall:.2f} clips/s = {b * T * 1e3 / wall:.1f} masks/s; device "
            f"{dev:.2f} ms in {len(kern)} CUDA launches = {100 * dev / prof_wall:.1f}% busy "
            f"(one forward under torch.profiler, {prof_wall:.2f} ms); peak memory "
            f"{peak / 2 ** 30:.2f} GiB; cost_analysis {flops / 1e12:.3f} TFLOP a forward = "
            f"{flops / dev / 1e9:.1f} TFLOP/s over the device time, "
            f"{flops / wall / 1e9:.1f} TFLOP/s over the wall")
        with tempfile.TemporaryDirectory() as d:
            with P.trace(d):
                with P.annotate("avs_pvt_forward"):
                    run16()
                torch.cuda.synchronize()
            files = [f for f in os.listdir(d) if f.endswith(".json")]
            if len(files) != 1:
                fail(f"profiling.trace wrote {files} into its directory")
            with open(os.path.join(d, files[0])) as f:
                events = json.load(f)["traceEvents"]
        region = [e for e in events if e.get("name") == "avs_pvt_forward"]
        kernels = [e for e in events if e.get("cat") == "kernel"]
        if not region or not kernels:
            fail(f"profiling.trace: {len(region)} events of the annotated region, "
                 f"{len(kernels)} CUDA kernel events")
        log(f"  runtime.profiling: trace + annotate around one forward: {len(events)} events, "
            f"the region 'avs_pvt_forward' {len(region)}x, {len(kernels)} CUDA kernels")
    del m16, m32, host
    torch.cuda.empty_cache()
    log(f"  phase_avs_pvt: {time.perf_counter() - t0:.1f} s")
    return {"wall_ms": wall, "device_ms": dev, "busy": dev / prof_wall, "peak_gib": peak / 2 ** 30,
            "cuda_launches": len(kern), "flops": flops}


def free_port():
    import socket
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def phase_mesh(cfg, avs_cfg, avs_hcfg, smi, cut_depths=(2, 2, 2, 2)):
    """`runtime/mesh.py` on the card: a world of one under NCCL through
    `init_distributed` (STGCMA_COORDINATOR=127.0.0.1:<free port>,
    STGCMA_NUM_PROCESSES=1, STGCMA_PROCESS_ID=0) and `make_mesh(1, 1)`.
    Swin-Base fusion (`cfg`) served by `MultiTaskServer(mesh=...,
    shard_tower=True)`, every split leaf read through its gather, B = 8:
    the logits equal the meshless server's bit for bit, with the same
    launches (K1, K4-K9); one AVS train step at `cut_depths`, B = TRAIN_B,
    with the mesh (the frozen tower sharded, the masters' gradients
    averaged over 'data', TPAVI's BatchNorm summed over it), under torch's
    deterministic algorithms: the loss and the masters equal the step
    without the mesh bit for bit. The group is destroyed after. Returns the
    served forward's launches."""
    import tempfile
    import numpy as np
    import torch
    import torch.distributed as dist
    from stgcma_tpu_torch.cli import run_adapt_avs as cli
    from stgcma_tpu_torch.cli.common import DETERMINISTIC, deterministic_algorithms
    from stgcma_tpu_torch.data.loader import collate, make_avs_device_pipeline
    from stgcma_tpu_torch.models.ave import random_swin_ave
    from stgcma_tpu_torch.models.avs import random_avs
    from stgcma_tpu_torch.nn.swin import launches_per_forward
    from stgcma_tpu_torch.ops import fused_attn as FA
    from stgcma_tpu_torch.ops.fbank import SWIN_FBANK
    from stgcma_tpu_torch.runtime import mesh as M
    from stgcma_tpu_torch.serving import MultiTaskServer
    from stgcma_tpu_torch.train.loop import Trainer
    t0 = time.perf_counter()
    with environment({"STGCMA_COORDINATOR": f"127.0.0.1:{free_port()}",
                      "STGCMA_NUM_PROCESSES": "1", "STGCMA_PROCESS_ID": "0"}):
        if not M.init_distributed():
            fail("init_distributed did not take the STGCMA_* variables")
    try:
        if dist.get_backend() != "nccl" or dist.get_world_size() != 1:
            fail(f"mesh: backend {dist.get_backend()}, world {dist.get_world_size()}; "
                 f"expected NCCL, 1")
        mesh = M.make_mesh(1, 1)
        task = "ave29_swin_base_fusion_mesh"
        model = live_fusion_adapters_(random_swin_ave(cfg, SEED), SEED)
        plain = MultiTaskServer(device="cuda")
        plain.add_ave(task, cfg, model)
        srv = MultiTaskServer(device="cuda", mesh=mesh, shard_tower=True)
        srv.add_ave(task, cfg, model)
        del model
        split = sum(n.endswith(".original") for n, _ in srv.models[task].named_parameters())
        rng = np.random.RandomState(SEED)
        n, T = cfg.img_size, cfg.num_frames
        batch = {"a": rng.randn(B, T, n, n).astype(np.float32),
                 "v": rng.randn(B, T, n, n, 3).astype(np.float32)}
        want = {**{k: 0 for k in KERNELS}, **launches_per_forward(cfg, B)}
        ref = predict(plain, task, batch)
        FA.reset_launches()
        t1 = time.perf_counter()
        got = predict(srv, task, batch)
        mesh_s = time.perf_counter() - t1
        counts = launches()
        if counts != want:
            fail(f"mesh server: launches {counts}, expected {want}")
        if got.shape != ref.shape or not np.array_equal(got, ref):
            fail(f"mesh server: logits {got.shape} differ from the meshless server's by "
                 f"{float(np.abs(got - ref).max()) if got.shape == ref.shape else 'shape'}")
        FA.reset_launches()
        t1 = time.perf_counter()
        predict(srv, task, batch)
        mesh_s2 = time.perf_counter() - t1
        t1 = time.perf_counter()
        predict(plain, task, batch)
        plain_s = time.perf_counter() - t1
        ran = ", ".join(f"{k} {v}" for k, v in counts.items() if v)
        log(f"  mesh server (NCCL world of 1, mesh (1, 1), shard_tower): Swin-Base fusion B={B}, "
            f"{split} split leaves each gathered where read; logits equal the meshless "
            f"server's bit for bit; launches {ran}; "
            f"{mesh_s * 1e3:.1f} ms first, {mesh_s2 * 1e3:.1f} ms after, meshless "
            f"{plain_s * 1e3:.1f} ms on {smi}")
        del plain, srv
        cut = dataclasses.replace(avs_cfg, depths=cut_depths)
        args = cli.parse_args([])
        ds = cli.SyntheticAVS(TRAIN_B, cut.num_frames, cut.img_size, seed=SEED)
        batch = collate([ds[i] for i in range(TRAIN_B)])
        pipe = make_avs_device_pipeline(SWIN_FBANK, 224, args.dataset_mean, args.dataset_std,
                                        device="cuda")
        runs = []
        with tempfile.TemporaryDirectory() as tmp, environment({DETERMINISTIC: "1"}), \
                deterministic_algorithms():
            for i, m in enumerate((None, mesh)):
                tr = Trainer(loss_fn=cli.make_loss_fn(cut, avs_hcfg, pipe, args),
                             eval_fn=lambda *_: {}, model=random_avs(cut, avs_hcfg, SEED).cuda(),
                             base_lr=1e-4, head_lr_mult=10.0, n_epochs=1, steps_per_epoch=1,
                             exp_dir=os.path.join(tmp, str(i)), mesh=m)
                with contextlib.redirect_stdout(sys.stderr):
                    tr.train_epoch(1, [batch], torch.Generator().manual_seed(SEED))
                runs.append(tr)
        (a, b_), (la, lb) = [r.trainable() for r in runs], [r.step_losses for r in runs]
        diff = max(float((a[k] - b_[k]).detach().abs().max()) for k in a)
        bufs = max(float((runs[0].buffers()[k] - runs[1].buffers()[k]).abs().max())
                   for k in runs[0].buffers())
        if la != lb or diff != 0.0 or bufs != 0.0:
            fail(f"mesh train step: loss {lb} against {la}, masters differ by {diff:.4g}, "
                 f"BatchNorm statistics by {bufs:.4g}")
        log(f"  mesh train step: AVS Swin-Large fusion at depths {cut_depths}, B={TRAIN_B}, "
            f"bf16 compute, the frozen tower sharded over 'model', gradients averaged over "
            f"'data': loss {la[0]:.6f}, the masters and the TPAVI BatchNorm statistics equal "
            f"the meshless step's bit for bit (torch's deterministic algorithms)")
        del runs
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    torch.cuda.empty_cache()
    log(f"  phase_mesh: {time.perf_counter() - t0:.1f} s")
    return counts


def main():
    try:
        import torch
    except ImportError:
        fail("torch is not installed")
    if not torch.cuda.is_available():
        fail("no CUDA device: this script drives the port on the GPU only")
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    try:
        from stgcma_tpu_torch.configs import (AVQAHeadConfig, AVSHeadConfig, clip_b16, clip_l14,
                                              swin_base, swin_large)
        from stgcma_tpu_torch.ops import cuda_lib
    except ImportError as e:
        fail(f"the port package is not beside this script: {e}")
    torch.backends.cuda.matmul.allow_tf32 = False    # plain versions: true fp32
    torch.backends.cudnn.allow_tf32 = False

    t_start = time.perf_counter()
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
    l14_cfg = clip_l14(ftmode="fusion", label_dim=29)
    swin_cfg = swin_base(ftmode="multimodal", label_dim=29)
    fusion_cfg = swin_base(ftmode="fusion", label_dim=29)
    large_cfg = swin_large(ftmode="fusion", label_dim=29)
    # Swin-Base cut to 168^2 and two stages: stage grids of 42^2 and 21^2 tokens,
    # neither a multiple of 16, so both full-grid exchanges take the K10 route
    k10_cfg = dataclasses.replace(fusion_cfg, img_size=168, depths=(2, 2), num_heads=(4, 8),
                                  adapter_ratios=(0.125, 0.125))
    # AVS (cli/run_adapt_avs.py's default): Swin-Large fusion, T = 5, and its decoder
    avs_cfg = swin_large(ftmode="fusion", num_frames=5)
    avs_hcfg = AVSHeadConfig(stage_dims=tuple(avs_cfg.stage_dim(i) for i in range(4)),
                             audio_dim=avs_cfg.num_features, num_frames=5)
    # AVQA (cli/run_adapt_avqa.py's default): Swin-Large fusion, T = 10, and its head
    avqa_cfg = swin_large(ftmode="fusion", num_frames=10)
    avqa_hcfg = AVQAHeadConfig(feat_dim=avqa_cfg.num_features, grid=7, num_frames=10)
    log(f"[3/4] kernels against their plain versions (bf16, B={B}, tol {TOL_KERNEL} rel, "
        f"{TOL_KERNEL_Q} for the int8 variants of K4, K12, K13, for K11 and for K4 at "
        f"Swin-Large; K4's int8 variant at Swin-Large stage 3 at (1 + {F5_FACTOR}) x its plain "
        f"version's distance from the block in fp32, at most {TOL_K4Q_LARGE})")
    results = phase_kernels(cfg)
    phases = (lambda: phase_swin_kernels(swin_cfg, large_cfg),
              lambda: phase_fusion_kernels(fusion_cfg),
              lambda: phase_int8_swin_kernels(fusion_cfg), lambda: phase_clip_block_kernels(cfg),
              lambda: phase_k11_kernels(cfg), lambda: phase_l14_kernels(l14_cfg),
              lambda: phase_clip_block_kernels(l14_cfg, tag="CLIP-L/14 "),
              lambda: phase_fusion_kernels(large_cfg, tower="Swin-Large", odd=False,
                                           k4_tol=TOL_K4_LARGE),
              lambda: phase_tv2_kernels(cfg, l14_cfg), lambda: phase_k10_kernels(k10_cfg),
              lambda: phase_avs_kernels(avs_cfg), lambda: phase_avqa_kernels(avqa_cfg),
              lambda: phase_l14_int8_kernels(l14_cfg), phase_parts,
              lambda: phase_grad_kernels(cfg, k10_cfg))
    for phase in phases:
        for k, rows in phase().items():
            results.setdefault(k, []).extend(rows)

    log(f"[4/4] slice: CLIP ViT-B/16 fusion AVE-29, {cfg.layers} layers, C={cfg.embed_dim}, "
        f"T={cfg.num_frames}, bf16 and int8 towers, default, fused-block, adapter-fused (int8) "
        f"and transpose-free temporal (K14) configurations")
    totals, clips = phase_clip_slice(cfg, smi)
    mm_cfg = dataclasses.replace(cfg, ftmode="multimodal", layers=2)
    log(f"[4/4] slice: CLIP ViT-B/16 multimodal AVE-29, depth cut to {mm_cfg.layers} layers, "
        f"C={mm_cfg.embed_dim}, bf16")
    mm_totals, mm_clips = phase_clip_multimodal_slice(mm_cfg, smi)
    clips.update(mm_clips)
    totals = {k: totals[k] + mm_totals[k] for k in KERNELS}
    log(f"[4/4] slice: CLIP ViT-L/14 fusion AVE-29, {l14_cfg.layers} layers, "
        f"C={l14_cfg.embed_dim}, {l14_cfg.num_patches + 1} video tokens, bf16 and int8 towers, "
        f"default and fused-block configurations")
    l14_totals, l14_clips = phase_clip_l14_slice(l14_cfg, smi)
    clips.update(l14_clips)
    totals = {k: totals[k] + l14_totals[k] for k in KERNELS}
    single = [swin_base(ftmode=m, label_dim=29) for m in ("videoonly", "audioonly")]
    for scfg, int8, preset, task in ((swin_cfg, False, "", None), (fusion_cfg, False, "", None),
                                     (fusion_cfg, True, "", None),
                                     (large_cfg, False, "large_", None),
                                     (k10_cfg, False, "", "ave29_swin_k10_bf16"),
                                     (single[0], False, "", None), (single[1], False, "", None)):
        log(f"[4/4] slice: Swin-{'Large' if preset else 'Base'} {scfg.ftmode} AVE-29, depths "
            f"{scfg.depths}, C={scfg.embed_dim}..{scfg.num_features}, T={scfg.num_frames}, "
            f"{scfg.img_size}^2, {'int8 tower' if int8 else 'bf16'}")
        swin_totals, swin_clips = phase_swin_slice(scfg, smi, int8, preset,
                                                   cpu_depths=(2, 2, 2, 2) if preset else None,
                                                   task=task)
        clips.update(swin_clips)
        totals = {k: totals[k] + swin_totals[k] for k in KERNELS}
    log(f"[4/4] slice: AVSBench segmentation, Swin-Large {avs_cfg.ftmode} with its multi-scale "
        f"taps, TPAVI at stages {avs_hcfg.tpavi_stages} and the FPN decoder, depths "
        f"{avs_cfg.depths}, C={avs_cfg.embed_dim}..{avs_cfg.num_features}, T={avs_cfg.num_frames}, "
        f"{avs_cfg.img_size}^2, bf16")
    avs_totals, avs_clips = phase_avs_slice(avs_cfg, avs_hcfg, smi)
    clips.update(avs_clips)
    totals = {k: totals[k] + avs_totals[k] for k in KERNELS}
    log(f"[4/4] slice: MUSIC-AVQA, Swin-Large {avqa_cfg.ftmode} with the question LSTM, "
        f"grounding and QA attention, depths {avqa_cfg.depths}, C={avqa_cfg.embed_dim}.."
        f"{avqa_cfg.num_features}, T={avqa_cfg.num_frames}, {avqa_cfg.img_size}^2, bf16 and int8 "
        f"towers; the three-output path with the nega stream")
    avqa_totals, avqa_clips = phase_avqa_slice(avqa_cfg, avqa_hcfg, smi)
    clips.update(avqa_clips)
    totals = {k: totals[k] + avqa_totals[k] for k in KERNELS}
    log(f"[4/4] stream: CLIP ViT-B/16 fusion AVE-29 from a reference visual state dict "
        f"(load_pretrained_clip), {cfg.layers} layers, T={cfg.num_frames}, bf16 and int8 towers; "
        f"{2 * B + 3} requests of 10 s WAVs and uint8 frames through serve_stream at batch_size "
        f"{B}, the fbank and the frame transforms on the card")
    stream_totals, stream_clips = phase_stream(cfg, avqa_cfg, avs_cfg, smi)
    clips.update(stream_clips)
    totals = {k: totals[k] + stream_totals[k] for k in KERNELS}
    log(f"[4/4] train: AVE-29 training on CLIP ViT-B/16 fusion through cli.run_adapt_ave29, "
        f"{cfg.layers} layers, C={cfg.embed_dim}, T={cfg.num_frames}, B={TRAIN_B}, bf16 compute "
        f"with fp32 masters, K1 forward and its recomputing backward")
    train_rows, train_totals = phase_train(cfg, smi)
    results["K1"].extend(train_rows)
    totals = {k: totals[k] + train_totals[k] for k in KERNELS}
    log(f"[4/4] train: AVE-29 training on Swin-Base fusion through cli.run_adapt_ave29, depths "
        f"{fusion_cfg.depths}, C={fusion_cfg.embed_dim}..{fusion_cfg.num_features}, "
        f"T={fusion_cfg.num_frames}, B={TRAIN_B}, bf16 compute with fp32 masters, every float "
        f"kernel's recompute in its backward")
    swin_rows, swin_totals, _ = phase_train_swin(fusion_cfg, smi)
    log(f"[4/4] train: AVSBench training on Swin-Large fusion through cli.run_adapt_avs, T="
        f"{avs_cfg.num_frames}, TPAVI at stages {avs_hcfg.tpavi_stages}, B={TRAIN_B}")
    avs_rows, avs_totals, _ = phase_train_avs(avs_cfg, avs_hcfg, smi)
    log(f"[4/4] train: MUSIC-AVQA training on Swin-Large fusion through cli.run_adapt_avqa, T="
        f"{avqa_cfg.num_frames} with the nega stream, B={TRAIN_B}; the grounding pretrainer")
    avqa_rows, avqa_train_totals, _ = phase_train_avqa(avqa_cfg, avqa_hcfg, smi)
    for rows in (swin_rows, avs_rows, avqa_rows):
        for k, r in rows.items():
            results[k].extend(r)
    totals = {k: totals[k] + swin_totals[k] + avs_totals[k] + avqa_train_totals[k]
              for k in KERNELS}
    log(f"[4/4] slice: the PVT-v2-b5 AVS baseline, depths {(3, 6, 40, 3)}, 224^2, B={B} clips "
        f"x T=5, bf16 and fp32, eval and train mode; the profiler around one forward")
    phase_avs_pvt(smi)
    log(f"[4/4] mesh: NCCL world of one through init_distributed, make_mesh(1, 1); Swin-Base "
        f"fusion served with shard_tower, one AVS train step with the mesh")
    mesh_totals = phase_mesh(fusion_cfg, avs_cfg, avs_hcfg, smi)
    totals = {k: totals[k] + mesh_totals[k] for k in KERNELS}

    kernels = []
    for k in KERNELS:
        rows = results[k]
        name, replaces, srcs = META[k]
        launches = totals[k]
        if launches == 0:
            fail(f"{k} was launched no time on the main paths")
        head = rows[2] if k in ("K1", "K2") else rows[0]   # CLIP video spatial / first site
        kernels.append({"name": name, "route": "cuda", "source": "stgcma_tpu_torch/csrc",
                        "sources": [f"stgcma_tpu_torch/csrc/{s}" for s in srcs],
                        "replaces": replaces, "launches": launches, **head,
                        "shapes": rows})
    log("clips/s: " + ", ".join(f"{t} {c:.2f}" for t, c in clips.items()) + f" on {smi}")
    log(f"total wall time {time.perf_counter() - t_start:.1f} s")
    log(smi)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
