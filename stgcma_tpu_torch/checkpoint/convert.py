"""Carry JAX parameter trees over to the port's modules.

`params_from_jax(tree)` takes a JAX param tree as nested dicts / lists of
numpy arrays (float leaves, or the int8 `kernel_q` with its `kernel_s`) and
returns the port's state dict. Layouts the port keeps:

- linear `kernel` (in, out) -> `weight` (out, in), torch's layout, which the
  GEMMs read K-contiguous; `bias` as it is;
- int8 `kernel_q` (in, out) -> `weight_q` (out, in); `kernel_s` (1, out) ->
  `weight_s` (out,);
- conv `kernel` HWIO -> `weight` OIHW (PVT's depthwise (3, 3, 1, C) ->
  (C, 1, 3, 3)), and DHWIO -> OIDHW (the Swin patch embed's (pt, ph, pw,
  I, O));
- LayerNorm and BatchNorm `scale` -> `weight`; the BatchNorm running
  statistics `mean` -> buffer `running_mean`, `var` -> `running_var`
  (`bias` keeps its name);
- the LSTM's `w_ih` (in, 4H) and `w_hh` (H, 4H) -> torch's (4H, in) and
  (4H, H) (an attention's packed `in_proj` kernel (C, 3C) is a linear
  kernel: (3C, C));
- every other leaf (embeddings such as AVQA's `word2vec`, gates) keeps its
  name and shape.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from ..configs import AVQAHeadConfig, AVSHeadConfig, ClipConfig, SwinConfig
from ..models.ave import ClipAVE, SwinAVE
from ..models.avqa import AVQAModel
from ..models.avs import AVSModel, PVTAVSModel
from ..nn import pvt
from ..nn.resnet import ResNet18
from ..ops.common import resolve_device
from ..ops.quant import quantize_clip_tower, quantize_swin_tower


def _leaf(key: str, a: np.ndarray):
    if key == "kernel" and a.ndim == 2:
        return "weight", a.T
    if key == "kernel" and a.ndim == 4:
        return "weight", a.transpose(3, 2, 0, 1)
    if key == "kernel" and a.ndim == 5:
        return "weight", a.transpose(4, 3, 0, 1, 2)
    if key == "kernel_q":
        return "weight_q", a.T
    if key == "kernel_s":
        return "weight_s", a.reshape(-1)
    if key == "scale":
        return "weight", a
    if key in ("mean", "var"):
        return f"running_{key}", a
    if key in ("w_ih", "w_hh"):
        return key, a.T
    return key, a


def params_from_jax(tree: Any, prefix: str = "") -> Dict[str, torch.Tensor]:
    """Nested dicts/lists of numpy arrays -> {dotted name: tensor}."""
    out: Dict[str, torch.Tensor] = {}
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    for k, v in items:
        if isinstance(v, (dict, list, tuple)):
            out.update(params_from_jax(v, f"{prefix}{k}."))
        else:
            name, a = _leaf(str(k), np.asarray(v))
            out[prefix + name] = torch.from_numpy(np.array(a, order="C"))
    return out


def clip_ave_from_jax(cfg: ClipConfig, tree: Any, device="cuda") -> ClipAVE:
    """A ClipAVE of cfg.ftmode holding the JAX tree's weights (float, or an
    int8 tower made by the JAX `quantize_clip_tower`). Loads strictly: the
    tree of each mode has that mode's adapters only, and the single-stream
    modes the `ln`/`fc` head in place of `fc1`/`fc2`."""
    device = resolve_device(device)
    state = params_from_jax(tree)
    model = ClipAVE(cfg)
    if any(k.endswith("weight_q") for k in state):
        model.backbone = quantize_clip_tower(model.backbone)
    model.load_state_dict(state, strict=True)
    return model.to(device)


def _load_swin(model, tree: Any, device):
    """`model` (with a Swin `backbone`) holding the tree's weights, loaded
    strictly, its tower quantized first where the tree's is int8."""
    device = resolve_device(device)
    state = params_from_jax(tree)
    if any(k.endswith("weight_q") for k in state):
        model.backbone = quantize_swin_tower(model.backbone)
    model.load_state_dict(state, strict=True)
    return model.to(device)


def swin_ave_from_jax(cfg: SwinConfig, tree: Any, device="cuda") -> SwinAVE:
    """A SwinAVE of cfg.ftmode holding the JAX tree's weights (float, or an
    int8 tower made by the JAX `quantize_swin_tower`). Loads strictly: every
    leaf of the tree is a parameter or buffer of the port and the other way
    round (the bias-free patch-merging `reduction` included; a single-stream
    tree has that stream's adapters only and the `ln`/`fc` head)."""
    return _load_swin(SwinAVE(cfg), tree, device)


def avs_from_jax(cfg: SwinConfig, hcfg: AVSHeadConfig, tree: Any, device="cuda") -> AVSModel:
    """An AVSModel holding the JAX `init_avs` tree's weights, loaded
    strictly: the Swin backbone as in `swin_ave_from_jax`, the decoder's
    convs HWIO -> OIHW, the TPAVI BatchNorms' `scale` / `bias` / `mean` /
    `var` -> `weight` / `bias` / `running_mean` / `running_var`."""
    return _load_swin(AVSModel(cfg, hcfg), tree, device)


def avs_pvt_from_jax(hcfg: AVSHeadConfig, tree: Any, device="cuda",
                     pvt_cfg=pvt.B5) -> PVTAVSModel:
    """A PVTAVSModel holding the JAX `init_avs_pvt` tree's weights, loaded
    strictly: the encoder's convs HWIO -> OIHW (the depthwise (3, 3, 1, C)
    -> (C, 1, 3, 3)), its linears (in, out) -> (out, in), the decoder as in
    `avs_from_jax`. `pvt_cfg` names the encoder's depths where the tree's
    are cut."""
    model = PVTAVSModel(hcfg, pvt_cfg)
    model.load_state_dict(params_from_jax(tree), strict=True)
    return model.to(resolve_device(device))


def avqa_from_jax(cfg: SwinConfig, hcfg: AVQAHeadConfig, tree: Any, device="cuda") -> AVQAModel:
    """An AVQAModel holding the JAX `init_avqa` tree's weights, loaded
    strictly: the Swin backbone as in `swin_ave_from_jax` (float, or an int8
    tower), the attentions' packed `in_proj` (C, 3C) -> (3C, C), the LSTM's
    `w_ih` / `w_hh` transposed to torch's layout, `word2vec` as it is."""
    return _load_swin(AVQAModel(cfg, hcfg), tree, device)


def resnet18_from_jax(tree: Any, device="cuda") -> ResNet18:
    """A ResNet18 holding the JAX `resnet18_init` tree's weights, loaded
    strictly: convs HWIO -> OIHW, the BatchNorms' `scale` / `bias` / `mean` /
    `var` -> `weight` / `bias` / `running_mean` / `running_var`, the
    downsample's `conv` / `bn` as they are."""
    model = ResNet18()
    model.load_state_dict(params_from_jax(tree), strict=True)
    return model.to(resolve_device(device))


def grounding_from_jax(tree: Any, device="cuda"):
    """A `tools/grounding_gen.py::GroundingModel` holding the JAX
    `init_grounding` tree's weights (the head's linears and `visual_net`),
    loaded strictly."""
    from ..tools.grounding_gen import GroundingModel
    model = GroundingModel()
    model.load_state_dict(params_from_jax(tree), strict=True)
    return model.to(resolve_device(device))
