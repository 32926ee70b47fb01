"""AVSBench S4/MS3 segmentation: the Swin fusion backbone with its
multi-scale taps, and the ASPP / TPAVI / FPN decoder.

Port of `stgcma_tpu/models/avs.py`: `init_avs_head` / `init_avs` (:22-41)
and `apply_avs` (:101-156), reference SwinTransformer2D_Adapter_AVS
(AVS/model/Swin_AVSModel.py:1266-1894). I/O: a (B, T, 224, 224), v (B, T,
224, 224, 3) -> (pred (B*T, 224, 224, 1), feature_map_list 4 x (B*T, h, w,
256), a_fea_list 4 x (B, T, 256)). And the PVT-v2-b5 baseline, `init_avs_pvt`
/ `apply_avs_pvt` (:44-98; reference AVS/model/PVT_AVSModel.py:323, left
unwired there): the `nn/pvt.py` encoder, whose stage widths are the
decoder's vis_dim, under the same decoder without its stage and audio
linears, TPAVI reading VGGish features (B, T, 128) as they are.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional

import torch
from torch import nn

from ..configs import AVSHeadConfig, SwinConfig
from ..nn import pvt, swin
from ..nn.decoder import (ASPP, FFB, OutputConv, aspp_apply, ffb_apply,
                          output_conv_apply)
from ..nn.tpavi import TPAVI, tpavi_apply
from ..ops.common import LayerNorm, Linear, linear, resolve_device
from ..ops.conv import BatchNorm, Conv2d
from ..runtime.profiling import annotate
from .ave import init_swin_, random_swin_


class AVSHead(nn.Module):
    """The decoder's parameters under the JAX tree's keys: per stage
    `x{i}_linear` (stage width -> vis_dim), `conv{i}` (ASPP -> channel),
    `path{i}` (feature fusion); `audio_linear`; `tpavi_b{i}` at the TPAVI
    stages; `output_conv`."""

    def __init__(self, hcfg: AVSHeadConfig):
        super().__init__()
        for i, (c, vd) in enumerate(zip(hcfg.stage_dims, hcfg.vis_dim)):
            setattr(self, f"x{i + 1}_linear", Linear(c, vd))
            setattr(self, f"conv{i + 1}", ASPP(vd, hcfg.channel))
            setattr(self, f"path{i + 1}", FFB(hcfg.channel))
        self.audio_linear = Linear(hcfg.audio_dim, hcfg.tpavi_audio_dim)
        for i in hcfg.tpavi_stages:
            setattr(self, f"tpavi_b{i + 1}", TPAVI(hcfg.channel, hcfg.tpavi_audio_dim))
        self.output_conv = OutputConv(hcfg.channel)


class AVSModel(nn.Module):
    def __init__(self, cfg: SwinConfig, hcfg: AVSHeadConfig):
        super().__init__()
        if cfg.ftmode not in ("multimodal", "fusion"):
            raise ValueError(f"AVS takes a two-stream Swin tower, not ftmode {cfg.ftmode!r}")
        self.backbone = swin.SwinBackbone(cfg)
        self.avstask = AVSHead(hcfg)


class PVTAVSHead(nn.Module):
    """The PVT baseline's decoder: `conv{i}` (ASPP on the stage map, whose
    width is already vis_dim), `path{i}`, `tpavi_b{i}` at the TPAVI stages
    and `output_conv`; no `x{i}_linear` and no `audio_linear`."""

    def __init__(self, hcfg: AVSHeadConfig):
        super().__init__()
        for i, vd in enumerate(hcfg.vis_dim):
            setattr(self, f"conv{i + 1}", ASPP(vd, hcfg.channel))
            setattr(self, f"path{i + 1}", FFB(hcfg.channel))
        for i in hcfg.tpavi_stages:
            setattr(self, f"tpavi_b{i + 1}", TPAVI(hcfg.channel, hcfg.tpavi_audio_dim))
        self.output_conv = OutputConv(hcfg.channel)


class PVTAVSModel(nn.Module):
    """`encoder` (PVT, B5 unless `pvt_cfg` cuts it) and `avstask`."""

    def __init__(self, hcfg: AVSHeadConfig, pvt_cfg=pvt.B5):
        super().__init__()
        self.encoder = pvt.PVT(pvt_cfg)
        self.avstask = PVTAVSHead(hcfg)


def apply_avs_pvt(model: PVTAVSModel, hcfg: AVSHeadConfig, audio_feat, frames, train=False,
                  return_state=False):
    """audio_feat: (B, T, 128) VGGish features; frames: (B*T, H, W, 3).
    Returns (pred, feature_map_list, a_fea_list) as `apply_avs` does, and
    the TPAVI BatchNorms' updated statistics with `return_state` (filled
    only with `train`). TPAVI runs at every `tpavi_stages` entry, whatever
    `tpavi_va_flag` says, as in JAX (:72-98)."""
    hp = model.avstask
    maps = pvt.pvt_apply(model.encoder, frames)
    feature_map_list = [aspp_apply(getattr(hp, f"conv{i + 1}"), m) for i, m in enumerate(maps)]
    B, T = audio_feat.shape[0], audio_feat.shape[1]
    a_fea_list: List[Optional[torch.Tensor]] = [None] * 4
    bn_state: Dict[str, Dict[str, torch.Tensor]] = {}
    for i in hcfg.tpavi_stages:
        BT, H, W, C = feature_map_list[i].shape
        z, a_fea, stats = tpavi_apply(getattr(hp, f"tpavi_b{i + 1}"),
                                      feature_map_list[i].reshape(B, T, H, W, C), audio_feat,
                                      train=train)
        if stats is not None:
            bn_state[f"tpavi_b{i + 1}"] = stats
        a_fea_list[i] = a_fea
        feature_map_list[i] = z.reshape(BT, H, W, C)
    x = ffb_apply(hp.path4, feature_map_list[3])
    for i in (2, 1, 0):
        x = ffb_apply(getattr(hp, f"path{i + 1}"), x, feature_map_list[i])
    pred = output_conv_apply(hp.output_conv, x)
    feature_map_list = [torch.relu(fm) for fm in feature_map_list]
    if return_state:
        return pred, feature_map_list, a_fea_list, bn_state
    return pred, feature_map_list, a_fea_list


def apply_avs(model: AVSModel, cfg: SwinConfig, hcfg: AVSHeadConfig, a, v, train=False,
              return_state=False):
    """The fusion forward (Swin_AVSModel.py:1790-1894). Returns (pred,
    feature_map_list, a_fea_list), and the TPAVI BatchNorms' updated
    running statistics {"tpavi_b{i}": {"mean", "var"}} with `return_state`
    (filled only with `train`, which normalizes by the batch statistics).
    The returned maps are relu(map), as the reference's in-place ReLU inside
    the residual conv units leaves them for its caller."""
    with annotate("model.tower"):
        feats = swin.backbone_apply(model.backbone, cfg, a=a, v=v, collect_multiscale=True)
    with annotate("model.head"):
        return avs_head_apply(model.avstask, hcfg, feats, train, return_state)


def avs_head_apply(hp: AVSHead, hcfg: AVSHeadConfig, feats, train=False, return_state=False):
    """The decoder over `backbone_apply(..., collect_multiscale=True)`'s
    output; returns as `apply_avs` does."""
    B, T = feats["B"], feats["T"]
    # pooled audio per frame -> the TPAVI conditioning
    audio_feature = linear(hp.audio_linear, feats["a"].mean(dim=1).reshape(B, T, -1))
    feature_map_list = []
    for i, tap in enumerate(feats["multi_scale"]):
        r = hcfg.stage_resolutions[i]
        x = linear(getattr(hp, f"x{i + 1}_linear"), tap.reshape(tap.shape[0], r, r, -1))
        feature_map_list.append(aspp_apply(getattr(hp, f"conv{i + 1}"), x))
    n = len(hcfg.stage_dims)
    a_fea_list: List[Optional[torch.Tensor]] = [None] * n
    bn_state: Dict[str, Dict[str, torch.Tensor]] = {}
    for i in hcfg.tpavi_stages:
        if not hcfg.tpavi_va_flag:
            continue
        BT, H, W, C = feature_map_list[i].shape
        z, a_fea, stats = tpavi_apply(getattr(hp, f"tpavi_b{i + 1}"),
                                      feature_map_list[i].reshape(B, T, H, W, C),
                                      audio_feature, train=train)
        if stats is not None:
            bn_state[f"tpavi_b{i + 1}"] = stats
        a_fea_list[i] = a_fea
        feature_map_list[i] = z.reshape(BT, H, W, C)
    # FPN top-down decode, each path upsampling 2x (path4 -> path1, :1887-1890)
    x = ffb_apply(getattr(hp, f"path{n}"), feature_map_list[-1])
    for i in range(n - 2, -1, -1):
        x = ffb_apply(getattr(hp, f"path{i + 1}"), x, feature_map_list[i])
    pred = output_conv_apply(hp.output_conv, x)
    feature_map_list = [torch.relu(fm) for fm in feature_map_list]
    if return_state:
        return pred, feature_map_list, a_fea_list, bn_state
    return pred, feature_map_list, a_fea_list


def _uniform_(p, bound, g):
    p.uniform_(-bound, bound, generator=g)


def init_avs(cfg: SwinConfig, hcfg: AVSHeadConfig, generator: torch.Generator = None,
             device="cuda") -> AVSModel:
    """An AVSModel with the JAX package's initialization, drawn on the CPU
    from `generator` (seed 0 if none), then moved to `device`: the backbone
    as `init_swin_ave`'s; the stage and audio linears trunc_normal(0.02) with
    zero biases (`linear_init`); the ASPP convs N(0, 0.01) and the other
    convs uniform(+-1/sqrt(fan_in)), their biases uniform(+-1/sqrt(fan_in))
    (`conv2d_init`); TPAVI's linears torch's default, uniform(+-1/sqrt(in))
    weights and biases; unit LayerNorms; and the W_z BatchNorm with a zero
    scale, so that a fresh TPAVI is identity + LayerNorm."""
    device = resolve_device(device)
    g = generator if generator is not None else torch.Generator().manual_seed(0)
    model = AVSModel(cfg, hcfg)
    init_swin_(model.backbone, g)
    _init_head_(model.avstask, g)
    return model.to(device)


@torch.no_grad()
def _init_head_(head: nn.Module, g: torch.Generator):
    """The decoder's initialization, as `init_avs` describes it."""
    for name, m in head.named_modules():
        top = name.split(".")[0]
        if isinstance(m, Conv2d) or isinstance(m, Linear) and top.startswith("tpavi_b"):
            bound = m.weight[0].numel() ** -0.5
            if top.startswith("conv"):                       # ASPP: N(0, 0.01)
                m.weight.normal_(0.0, 0.01, generator=g)
            else:
                _uniform_(m.weight, bound, g)
            _uniform_(m.bias, bound, g)
        elif isinstance(m, Linear):
            nn.init.trunc_normal_(m.weight, std=0.02, a=-0.04, b=0.04, generator=g)
        elif isinstance(m, BatchNorm):
            m.weight.zero_()


def random_avs(cfg: SwinConfig, hcfg: AVSHeadConfig, seed: int) -> AVSModel:
    """An AVSModel on the CPU with every leaf drawn from one seeded
    generator, for smoke runs and measurements: the backbone as
    `random_swin_ave`'s (live adapters, gates and bias tables); in the head,
    every conv and linear weight and bias uniform(+-1/sqrt(fan_in)) (torch's
    default, which keeps the maps' scale through the decoder), LayerNorm
    weights 1 + N(0, 0.1) and biases N(0, 0.02), and each TPAVI BatchNorm
    live: scale 1 + N(0, 0.2), bias N(0, 0.1), running mean N(0, 0.1),
    running variance uniform(0.5, 1.5)."""
    g = torch.Generator().manual_seed(seed)
    model = AVSModel(cfg, hcfg)
    random_swin_(model.backbone, g)
    _random_(model.avstask, g)
    return model


@torch.no_grad()
def _random_(module: nn.Module, g: torch.Generator):
    """Every conv and linear weight and bias uniform(+-1/sqrt(fan_in)),
    LayerNorms and BatchNorms live, as `random_avs` describes its head."""
    for m in module.modules():
        if isinstance(m, (Conv2d, Linear)):
            bound = 1.0 / math.sqrt(m.weight[0].numel())
            _uniform_(m.weight, bound, g)
            _uniform_(m.bias, bound, g)
        elif isinstance(m, LayerNorm):
            m.weight.normal_(1.0, 0.1, generator=g)
            m.bias.normal_(0.0, 0.02, generator=g)
        elif isinstance(m, BatchNorm):
            m.weight.normal_(1.0, 0.2, generator=g)
            m.bias.normal_(0.0, 0.1, generator=g)
            m.running_mean.normal_(0.0, 0.1, generator=g)
            m.running_var.uniform_(0.5, 1.5, generator=g)


@torch.no_grad()
def _init_pvt_(enc: pvt.PVT, g: torch.Generator):
    """PVT's initialization (JAX `pvt_init`): every conv weight
    N(0, 2 / fan_out) with fan_out = kh kw C_out / groups (9 for the
    depthwise conv) and a zero bias;
    linears trunc_normal(0.02) with zero biases; unit LayerNorms."""
    for name, m in enc.named_modules():
        if isinstance(m, Conv2d):
            c_out, _, kh, kw = m.weight.shape
            fan_out = kh * kw * (1 if name.endswith("dwconv") else c_out)
            m.weight.normal_(0.0, math.sqrt(2.0 / fan_out), generator=g)
            m.bias.zero_()
        elif isinstance(m, Linear):
            nn.init.trunc_normal_(m.weight, std=0.02, a=-0.04, b=0.04, generator=g)
            m.bias.zero_()


def init_avs_pvt(hcfg: AVSHeadConfig, generator: torch.Generator = None, device="cuda",
                 pvt_cfg=pvt.B5) -> PVTAVSModel:
    """A PVTAVSModel with the JAX `init_avs_pvt` distributions, drawn on the
    CPU from `generator` (seed 0 if none), then moved to `device`: the
    encoder as `pvt_init`'s (`_init_pvt_`), the decoder as `init_avs`'s."""
    device = resolve_device(device)
    g = generator if generator is not None else torch.Generator().manual_seed(0)
    model = PVTAVSModel(hcfg, pvt_cfg)
    _init_pvt_(model.encoder, g)
    _init_head_(model.avstask, g)
    return model.to(device)


def random_avs_pvt(hcfg: AVSHeadConfig, seed: int, pvt_cfg=pvt.B5) -> PVTAVSModel:
    """A PVTAVSModel on the CPU with every leaf drawn from one seeded
    generator, for smoke runs and measurements: the encoder and the decoder
    as `random_avs`'s head (uniform(+-1/sqrt(fan_in)) convs and linears,
    live LayerNorms and BatchNorms)."""
    g = torch.Generator().manual_seed(seed)
    model = PVTAVSModel(hcfg, pvt_cfg)
    _random_(model, g)
    return model
