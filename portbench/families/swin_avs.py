"""AVSBench S4 segmentation on a Swin fusion tower with STG-CMA adapters
and the ASPP / TPAVI / FPN decoder.

Serving: `MultiTaskServer.add_avs`, a request {"a", "v"} -> the mask
logits (B*T, H, W, 1), replayed as a CUDA graph on the card (`graph`): at
40 frames the tower's ~1000 launches take the host about as long as the
card takes to run them, so the eager path lets the host's jitter into the
card's time. Serving only: no cell trains this family, and the port has no
int8 AVS tower.

Each TPAVI's W_z BatchNorm keeps running statistics, which a deployment
loads from its checkpoint and the benchmark does not draw: they are a fixed
function of the configuration (`bn_stats`, from its `tpavi_bn`). The
program's model holds them as buffers left out of its state dict, so that
the benchmark's strict load of the drawn parameters passes; `serve` fills
them on the device before the server takes its copy, and `ref_serve` gives
the reference the same values.
"""
from __future__ import annotations

from typing import Dict

import torch

from stgcma_tpu_torch.configs import AVSHeadConfig, SwinConfig
from stgcma_tpu_torch.models.avs import AVSModel
from stgcma_tpu_torch.ops.conv import BatchNorm

from .. import flops
from ..reference import swin_avs as ref
from .swin_avqa import _tuples

TASK = "avs"
STATS = ("running_mean", "running_var")


def port_configs(c: dict):
    return SwinConfig(**_tuples(c["model"])), AVSHeadConfig(**_tuples(c["head"]))


def new_model(c: dict) -> AVSModel:
    model = AVSModel(*port_configs(c))
    for m in model.modules():
        if isinstance(m, BatchNorm):
            for name in STATS:
                t = m._buffers.pop(name)
                m.register_buffer(name, t, persistent=False)
    return model


def bn_stats(c: dict, device="cpu") -> Dict[str, torch.Tensor]:
    """{"avstask.tpavi_b{i}.W_z.bn.running_mean" / "running_var": float32}
    of every TPAVI stage: channel k's mean `mean` * sin(k + 1), its
    variance `var` * (1 + sin(2k + 1) / 2)."""
    t = c["tpavi_bn"]
    k = torch.arange(c["head"]["channel"], dtype=torch.float64)
    mean = (t["mean"] * torch.sin(k + 1)).float().to(device)
    var = (t["var"] * (1 + torch.sin(2 * k + 1) / 2)).float().to(device)
    out = {}
    for i in c["head"]["tpavi_stages"]:
        p = f"avstask.tpavi_b{i + 1}.W_z.bn"
        out[f"{p}.running_mean"], out[f"{p}.running_var"] = mean, var
    return out


def serve(server, model, c: dict) -> str:
    device = next(model.parameters()).device
    stats = bn_stats(c, device)
    for name, m in model.named_modules():
        if isinstance(m, BatchNorm):
            for s in STATS:
                setattr(m, s, stats[f"{name}.{s}"])
    cfg, hcfg = port_configs(c)
    server.add_avs(TASK, cfg, hcfg, model, graph=server.device.type == "cuda")
    return TASK


def quantize(model: AVSModel) -> AVSModel:
    raise NotImplementedError("the port serves no int8 AVS tower")


def ref_serve(W, c: dict, batch: dict) -> torch.Tensor:
    W = W | bn_stats(c, batch["v"].device)
    return ref.serve(W, c["model"], c["head"], batch["a"], batch["v"])


def _conv(cnt: flops.Count, M: int, c_out: int, c_in: int, taps: int):
    """A convolution of `taps` kernel positions over M output positions: the
    products of (M, c_out, taps * c_in), reading its bf16 input and weight
    and writing its output once."""
    cnt._add(2 * M * c_out * taps * c_in, 2 * (M * c_in + c_out * taps * c_in + M * c_out), 0)


def count(c: dict, B: int, train: bool) -> flops.Count:
    """The served forward: the two-stream tower as `flops.swin_avqa` counts
    it, then the decoder's linears, convolutions and TPAVI's products as the
    port computes them (phi on the frames' audio rows, phi^T g over each
    frame's summed g, then theta times it)."""
    if train:
        raise NotImplementedError("no cell trains this family")
    cfg, h = c["model"], c["head"]
    cnt = flops.Count(False)
    T, C0 = cfg["num_frames"], cfg["embed_dim"]
    BT = B * T
    H0 = cfg["img_size"] // cfg["patch_size"][1]
    k = cfg["patch_size"][1] * cfg["patch_size"][2]
    cnt.conv(BT * H0 * H0, C0, 3 * k)
    cnt.conv(BT * H0 * H0, C0, k)
    for s, depth in enumerate(cfg["depths"]):
        C, heads, H = C0 * 2 ** s, cfg["num_heads"][s], H0 // 2 ** s
        ws = min(cfg["window_size"], H)
        D = int(C * cfg["adapter_ratios"][s])
        M, n = BT * H * H, ws * ws
        for i in range(depth):
            for _ in range(2):
                flops._swin_stream_block(cnt, M, M // n, n, C, heads, T, D, i % 2 == 0, False)
            cnt.fuse(M // n, n, n, D)
            cnt.fuse(BT, H * H, H * H, D)
        if s < len(cfg["depths"]) - 1:
            for _ in range(2):
                cnt.mm(BT * (H // 2) ** 2, 2 * C, 4 * C)
    ch, A = h["channel"], h["tpavi_audio_dim"]
    inter = ch // 2
    cnt.mm(BT, A, h["audio_dim"])                                  # audio_linear
    for i, (r, c_s, vd) in enumerate(zip(h["stage_resolutions"], h["stage_dims"], h["vis_dim"])):
        M = BT * r * r
        cnt.mm(M, vd, c_s)                                         # x{i}_linear
        for _ in ref.ASPP_DILATIONS:
            _conv(cnt, M, ch, vd, 9)
        if i in h["tpavi_stages"]:
            cnt.mm(BT, ch, A)                                      # align_channel
            cnt.mm(BT, inter, ch)                                  # phi
            cnt.mm(M, inter, ch)                                   # g
            cnt.mm(M, inter, ch)                                   # theta
            cnt.mm(B * inter, inter, T)                            # phi^T g
            cnt.mm(M, inter, inter)                                # theta (phi^T g)
            cnt.mm(M, ch, inter)                                   # W_z
        # the stage's fusion block: RCU1 on the skip (not at the last stage), RCU2
        for _ in range(2 if i == len(h["stage_dims"]) - 1 else 4):
            _conv(cnt, M, ch, ch, 9)
    r = 2 * h["stage_resolutions"][0]
    _conv(cnt, BT * r * r, 128, ch, 9)                             # the output head
    _conv(cnt, BT * 4 * r * r, 32, 128, 9)
    _conv(cnt, BT * 4 * r * r, 1, 32, 1)
    return cnt
