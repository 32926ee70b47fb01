"""Reference (PyTorch-layout) state dicts -> the port's modules, directly.

Port of `stgcma_tpu/checkpoint/torch_convert.py` without its JAX layouts:
the port's modules are named as the JAX tree's keys (`checkpoint/convert.py`)
and keep torch's layouts, so a reference entry lands under the JAX path's
dotted name with its array as it is: linear (out, in), conv OIHW / OIDHW,
the LSTM's (4H, in) / (4H, H), CLIP's packed `in_proj_weight` (3C, C) as the
port's `attn.in_proj` weight. Only the reference's 1x1x1 convolutions that
the port holds as linears (TPAVI's g / theta / phi / W_z.0) are reshaped to
(out, in), and the surgeries of the pretrained loaders are done in numpy as
the JAX package does them.

- `translate_swin_key` (:128) with the task heads it routes to: the AVE
  `mlp_head` (:175), AVSBench `avstask_*` (:189, TPAVI :232) and MUSIC-AVQA
  `avqatask_*` (:257); DataParallel `module.` prefixes are dropped and the
  reference's buffers skipped (:124);
- `merge_into` (:308): strict shapes, fp32, the list of entries the model
  does not hold (torch's unexpected keys), leaves missing from the state
  dict keep their values; a model whose tower is already int8 is refused
  (load first, then `quantize_*_tower`);
- `load_pretrained_swin2d` (:325) with `inflate_patch_embed` (:87) and
  `audio_patch_embed_from_video` (:95), `load_reference_swin` (:356);
- `derive_clip_audio_pos_embed` (:370), `load_pretrained_clip` (:398, `proj`
  dropped) and `load_reference_clip` (:452);
- `load_resnet18` (:508), the grounding pretrainer's visual net;
- `load_pvt_v2` (:545), the AVS baseline's PVT-v2 encoder;
- `average_params` (:611).
The port has no resident pad, so the positional embeddings keep 197 rows
(257 at ViT-L/14). Each loader returns (model, unexpected) with the model
on `device`, the card unless the caller asks for the CPU.
"""
from __future__ import annotations

import re
from typing import Dict, List, Mapping, Tuple

import numpy as np
import torch

from ..ops.common import resolve_device

Entries = List[Tuple[str, np.ndarray]]


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        if x.dtype == torch.bfloat16:
            x = x.float()
        x = x.numpy()
    return np.asarray(x)


def _conv1x1_to_linear(w) -> np.ndarray:
    """A 1x1(x1) conv weight (out, in, 1[, 1[, 1]]) -> a linear weight (out, in)."""
    w = _np(w)
    return w.reshape(w.shape[0], w.shape[1])


def _wb(leaf: str) -> str:
    """A reference LayerNorm / Linear / conv leaf keeps its torch name."""
    return "weight" if leaf == "weight" else "bias"


def inflate_patch_embed(w2d, pt: int) -> np.ndarray:
    """2D -> 3D patch embed: unsqueeze depth, repeat pt, / pt (Swin_AVE.py:1373-1374).
    (C, 3, 4, 4) -> OIDHW (C, 3, pt, 4, 4)."""
    w = _np(w2d)[:, :, None]
    return np.repeat(w, pt, axis=2) / pt


def audio_patch_embed_from_video(w2d, pt: int) -> np.ndarray:
    """The audio patch embed: the mean over RGB of the INFLATED video weight
    (already divided by pt), as Swin_AVE.py:1376 composes it. -> OIDHW
    (C, 1, pt, 4, 4)."""
    return inflate_patch_embed(w2d, pt).mean(axis=1, keepdims=True)


# ---------------------------------------------------------------------------
# Swin key translation
# ---------------------------------------------------------------------------

_SKIP_PATTERNS = (
    "relative_position_index", "relative_coords", "attn_mask",
    "t_relative_coords", "num_batches_tracked", "head.weight", "head.bias",
)


def _is_skipped(key: str) -> bool:
    return any(p in key for p in _SKIP_PATTERNS)


def translate_swin_key(key: str, value, prefix: str = "backbone.",
                       dual_head: bool = True) -> Entries:
    """One reference Swin-model entry -> [(port name, array)]: the backbone,
    the AVE `mlp_head`, `avstask_*` and `avqatask_*`; [] for buffers the
    port does not hold."""
    if key.startswith("module."):
        key = key[len("module."):]
    if _is_skipped(key):
        return []
    v = _np(value)
    if key.startswith("avstask_"):
        return _translate_avs_key(key[len("avstask_"):], v)
    if key.startswith("avqatask_"):
        return _translate_avqa_key(key[len("avqatask_"):], v)
    if key.startswith("mlp_head."):
        return _translate_mlp_head(key, v, dual_head)

    parts = key.split(".")
    leaf = parts[-1]
    if "patch_embed" in parts[0] and "proj" in key:
        if leaf == "weight" and v.ndim != 5:
            raise ValueError("2D patch embed needs load_pretrained_swin2d surgery")
        return [(f"{prefix}{parts[0]}.proj.{_wb(leaf)}", v)]
    path = prefix + ".".join(parts[:-1])
    if leaf == "weight":
        if v.ndim not in (1, 2):     # LayerNorm, Linear (reduction, qkv, D_fc*, fc*)
            raise ValueError(f"unhandled weight shape {v.shape} for {key}")
        return [(f"{path}.weight", v)]
    if leaf == "bias":
        return [(f"{path}.bias", v)]
    return [(prefix + key, v)]       # parameters addressed directly: bias tables, gates


def _translate_mlp_head(key: str, v, dual_head: bool) -> Entries:
    _, idx, leaf = key.split(".")
    if dual_head:                    # Sequential(Linear, Dropout, Linear) (Swin_AVE.py:1320-1322)
        name = {"0": "fc1", "2": "fc2"}[idx]
    else:                            # Sequential(LayerNorm, Linear)
        name = "ln" if idx == "0" else "fc"
    return [(f"mlp_head.{name}.{_wb(leaf)}", v)]


def _translate_avs_key(key: str, v) -> Entries:
    """avstask_* -> avstask.* (AVS/model/Swin_AVSModel.py:1473-1507)."""
    pre = "avstask."
    m = re.match(r"conv(\d)\.conv2d_list\.(\d+)\.(weight|bias)", key)      # ASPP
    if m:
        i, k, wl = m.groups()
        return [(f"{pre}conv{i}.convs.{k}.{wl}", v)]
    m = re.match(r"path(\d)\.resConfUnit(\d)\.conv(\d)\.(weight|bias)", key)
    if m:
        i, j, k, wl = m.groups()
        return [(f"{pre}path{i}.resConfUnit{j}.conv{k}.{wl}", v)]
    m = re.match(r"output_conv\.(\d)\.(weight|bias)", key)                 # Sequential 0, 2, 4
    if m:
        i, wl = m.groups()
        return [(f"{pre}output_conv.conv{i}.{wl}", v)]
    m = re.match(r"tpavi_b(\d)\.(.+)", key)
    if m:
        i, rest = m.groups()
        return _translate_tpavi_key(rest, v, f"{pre}tpavi_b{i}.")
    return [(pre + key, v)]          # x{i}_linear, audio_linear


def _translate_tpavi_key(key: str, v, prefix: str) -> Entries:
    """TPAVI's 1x1x1 Conv3d -> linear; W_z = Sequential(conv, bn) (TPAVI.py:37-73)."""
    parts = key.split(".")
    leaf = parts[-1]
    if parts[0] in ("g", "theta", "phi") or parts[:2] == ["W_z", "0"]:
        name = "W_z.conv" if parts[0] == "W_z" else parts[0]
        return [(f"{prefix}{name}.{_wb(leaf)}",
                 _conv1x1_to_linear(v) if leaf == "weight" else v)]
    if parts[0] in ("align_channel", "norm_layer"):
        return [(f"{prefix}{parts[0]}.{_wb(leaf)}", v)]
    if parts[0] == "W_z" and leaf in ("weight", "bias", "running_mean", "running_var"):
        return [(f"{prefix}W_z.bn.{leaf}", v)]
    raise ValueError(f"unhandled TPAVI key {key}")


def _translate_avqa_key(key: str, v) -> Entries:
    """avqatask_* -> avqatask.* (AVQA/model/Swin_AVQAModel_V1.py:1420-1473)."""
    pre = "avqatask."
    parts = key.split(".")
    m = re.match(r"(attn_[av])\.(in_proj_weight|in_proj_bias|out_proj\.weight|out_proj\.bias)",
                 key)
    if m:
        name, rest = m.groups()
        tgt = {"in_proj_weight": "in_proj.weight", "in_proj_bias": "in_proj.bias"}.get(rest, rest)
        return [(f"{pre}{name}.{tgt}", v)]
    if parts[0] == "question_encoder":
        sub = parts[1]
        if sub == "word2vec":
            return [(f"{pre}question_encoder.word2vec", v)]
        if sub == "lstm":
            kind, gate, layer = re.match(r"(weight|bias)_(ih|hh)_l(\d+)", parts[2]).groups()
            return [(f"{pre}question_encoder.lstm.layers.{layer}."
                     f"{'w' if kind == 'weight' else 'b'}_{gate}", v)]
        if sub == "fc":
            return [(f"{pre}question_encoder.fc.{_wb(parts[-1])}", v)]
    return [(pre + key, v)]          # norms, linears, other parameters as they are


# ---------------------------------------------------------------------------
# merge and the loaders
# ---------------------------------------------------------------------------

def _holds_int8(model: torch.nn.Module) -> bool:
    return any(getattr(m, "quantized", False) for m in model.modules())


def merge_into(model: torch.nn.Module, entries: Mapping[str, np.ndarray],
               strict_shapes: bool = True) -> Tuple[torch.nn.Module, List[str]]:
    """Copy {port name: array} into the model's parameters and buffers as
    fp32, in place. Returns (model, unexpected): the names the model does
    not hold. A shape mismatch raises; leaves the entries do not name keep
    their values. A model with an int8 tower is refused: the reference's
    float weights load before `quantize_*_tower`."""
    if _holds_int8(model):
        raise ValueError("the model's tower is int8: load the float weights first, "
                         "then quantize_clip_tower / quantize_swin_tower")
    held = dict(model.named_parameters())
    held.update(model.named_buffers())
    unexpected = []
    with torch.no_grad():
        for name, arr in entries.items():
            if name not in held:
                unexpected.append(name)
                continue
            cur = held[name]
            if strict_shapes and tuple(cur.shape) != tuple(arr.shape):
                raise ValueError(f"shape mismatch at {name}: model {tuple(cur.shape)} vs "
                                 f"checkpoint {tuple(arr.shape)}")
            cur.copy_(torch.from_numpy(np.array(arr, dtype=np.float32)).reshape(cur.shape))
    return model, unexpected


def _merged(model, entries, device):
    device = resolve_device(device)
    model, unexpected = merge_into(model, entries)
    return model.to(device), unexpected


def load_pretrained_swin2d(model, state_dict, cfg, prefix: str = "backbone.", device="cuda"):
    """An ImageNet-22k Swin checkpoint (timm layout, 2D patch embed) into a
    Swin model, with Swin_AVE.py:1369-1379's surgeries: the video patch
    embed inflated to 3D, the audio one the RGB mean of it, the patch-embed
    bias and norm copied to both. Adapters, gates and temporal tables keep
    their values."""
    pt = cfg.patch_size[0]
    entries: Dict[str, np.ndarray] = {}
    for key, v in state_dict.items():
        v = _np(v)
        if key == "patch_embed.proj.weight":
            entries[f"{prefix}patch_embed.proj.weight"] = inflate_patch_embed(v, pt)
            entries[f"{prefix}patch_embed_audio.proj.weight"] = audio_patch_embed_from_video(v, pt)
        elif key in ("patch_embed.proj.bias", "patch_embed.norm.weight", "patch_embed.norm.bias"):
            rest = key[len("patch_embed."):]
            entries[f"{prefix}patch_embed.{rest}"] = v
            entries[f"{prefix}patch_embed_audio.{rest}"] = v
        else:
            entries.update(translate_swin_key(key, v, prefix=prefix))
    return _merged(model, entries, device)


def load_reference_swin(model, state_dict, dual_head: bool = True, prefix: str = "backbone.",
                        device="cuda"):
    """A fine-tuned reference Swin checkpoint (AVE, AVQA or AVS, possibly
    with DataParallel `module.` prefixes) into the port's model of it."""
    entries: Dict[str, np.ndarray] = {}
    for key, v in state_dict.items():
        entries.update(translate_swin_key(key, v, prefix=prefix, dual_head=dual_head))
    return _merged(model, entries, device)


def derive_clip_audio_pos_embed(pos_embed: np.ndarray, cfg) -> np.ndarray:
    """positional_embedding_audio from the visual one: the class row, then a
    center crop of the (grid x grid) map to the audio patch grid
    (CLIP_AVE.py:828-850), with the reference's get_shape_a dims
    (f = (fdim - 16) / patch + 1, t = (tdim - 16) / patch + 1), transposed
    against the audio token grid as the reference has them."""
    hw, d = cfg.grid, cfg.embed_dim
    f_dim = (cfg.audio_fdim - 16) // cfg.patch_size + 1
    t_dim = (cfg.audio_tdim - 16) // cfg.patch_size + 1
    if t_dim > hw or f_dim > hw:
        raise NotImplementedError("audio grid larger than the visual grid")
    grid = pos_embed[1:].reshape(hw, hw, d)
    s = hw // 2 - t_dim // 2
    grid = grid[:, s:s + t_dim, :]
    s = hw // 2 - f_dim // 2
    grid = grid[s:s + f_dim, :, :]
    return np.concatenate([pos_embed[:1], grid.reshape(f_dim * t_dim, d)], axis=0)


def _clip_block_key(key: str, v, prefix: str) -> Entries:
    """A frozen CLIP resblock entry (attn in_proj / out_proj, ln_1, ln_2,
    mlp.c_fc / c_proj) -> the port's name, or [] if it is none of these."""
    if key in ("attn.in_proj_weight", "attn.in_proj_bias"):
        return [(f"{prefix}attn.in_proj.{key.rsplit('_', 1)[1]}", v)]
    if re.fullmatch(r"(attn\.out_proj|ln_1|ln_2|mlp\.c_fc|mlp\.c_proj)\.(weight|bias)", key):
        return [(prefix + key, v)]
    return []


def load_pretrained_clip(model, visual_state_dict, cfg, prefix: str = "backbone.",
                         device="cuda"):
    """An OpenAI CLIP visual tower into a ClipAVE, with CLIP_AVE.py:816-850's
    surgeries: conv1_audio the sum of conv1 over RGB, the audio positional
    embedding cropped from the visual one; `proj` dropped."""
    entries: Dict[str, np.ndarray] = {}
    for key, v in visual_state_dict.items():
        if key == "proj":
            continue
        v = _np(v)
        if key == "conv1.weight":
            entries[f"{prefix}conv1.weight"] = v
            entries[f"{prefix}conv1_audio.weight"] = v.sum(axis=1, keepdims=True)
        elif key == "class_embedding":
            entries[prefix + key] = v
        elif key == "positional_embedding":
            entries[prefix + key] = v
            entries[f"{prefix}positional_embedding_audio"] = derive_clip_audio_pos_embed(v, cfg)
        elif re.fullmatch(r"(ln_pre|ln_post)\.(weight|bias)", key):
            entries[prefix + key] = v
        else:
            m = re.match(r"transformer\.resblocks\.(\d+)\.(.+)", key)
            sub = _clip_block_key(m.group(2), v, f"{prefix}resblocks.{m.group(1)}.") if m else []
            if not sub:
                raise ValueError(f"unhandled CLIP key {key}")
            entries.update(sub)
    return _merged(model, entries, device)


def _clip_block_generic(key: str, v, prefix: str) -> Entries:
    """A fine-tuned resblock entry: the frozen block's, or an adapter's
    linear or a gate, each under its own name."""
    return _clip_block_key(key, v, prefix) or [(prefix + key, v)]


def load_reference_clip(model, state_dict, cfg, dual_head: bool = True,
                        prefix: str = "backbone.", device="cuda"):
    """A fine-tuned MM_CLIP_AVE checkpoint into a ClipAVE."""
    entries: Dict[str, np.ndarray] = {}
    for key, v in state_dict.items():
        if key.startswith("module."):
            key = key[len("module."):]
        v = _np(v)
        if key.startswith("mlp_head."):
            entries.update(_translate_mlp_head(key, v, dual_head))
        elif key in ("class_embedding", "positional_embedding", "positional_embedding_audio",
                     "temporal_embedding", "temporal_embedding_audio", "conv1.weight",
                     "conv1_audio.weight") or re.fullmatch(r"(ln_pre|ln_post)\.(weight|bias)",
                                                           key):
            entries[prefix + key] = v
        else:
            m = re.match(r"transformer\.resblocks\.(\d+)\.(.+)", key)
            if not m:
                raise ValueError(f"unhandled reference CLIP key {key}")
            entries.update(_clip_block_generic(m.group(2), v,
                                               f"{prefix}resblocks.{m.group(1)}."))
    return _merged(model, entries, device)


def load_resnet18(model, state_dict, prefix: str = "", device="cuda"):
    """A torchvision resnet18 state dict into `nn/resnet.py::ResNet18`
    (`load_resnet18` :508): `fc.*` and `num_batches_tracked` dropped, a
    DataParallel `module.` prefix too; `downsample.0` / `downsample.1` ->
    `downsample.conv` / `downsample.bn`; every other name kept. A key
    outside conv1 / bn1 / layer1-4 raises."""
    entries: Dict[str, np.ndarray] = {}
    for key, v in state_dict.items():
        if key.startswith("module."):
            key = key[len("module."):]
        if key.startswith("fc.") or "num_batches_tracked" in key:
            continue
        parts = key.split(".")
        if parts[0] in ("conv1", "bn1") or re.fullmatch(r"layer[1-4]", parts[0]):
            if len(parts) > 3 and parts[2] == "downsample":
                parts[3] = {"0": "conv", "1": "bn"}.get(parts[3], parts[3])
            entries[prefix + ".".join(parts)] = _np(v)
        else:
            raise ValueError(f"unhandled resnet key {key}")
    return _merged(model, entries, device)


_PVT_KEY = re.compile(r"(patch_embed\d\.(proj|norm)|norm\d|block\d\.\d+\.(norm1|norm2|"
                      r"attn\.(q|kv|proj|sr|norm)|mlp\.(fc1|dwconv\.dwconv|fc2)))\.(weight|bias)")


def load_pvt_v2(model, state_dict, prefix: str = "", device="cuda"):
    """A reference pvt_v2_b* state dict (AVS/model/pvt.py) into `nn/pvt.py::
    PVT` (`load_pvt_v2` :545; prefix "encoder." for a PVTAVSModel): a
    DataParallel `module.` prefix and the classifier `head.*` dropped,
    `mlp.dwconv.dwconv.*` -> `mlp.dwconv.*`, every other name and layout
    kept (torch's own). A key outside the patch embeds, blocks and stage
    norms raises."""
    entries: Dict[str, np.ndarray] = {}
    for key, v in state_dict.items():
        if key.startswith("module."):
            key = key[len("module."):]
        if key.startswith("head."):
            continue
        if not _PVT_KEY.fullmatch(key):
            raise ValueError(f"unhandled pvt key {key}")
        entries[prefix + key.replace("mlp.dwconv.dwconv.", "mlp.dwconv.")] = _np(v)
    return _merged(model, entries, device)


def average_params(state_dicts: List[Mapping[str, torch.Tensor]]) -> Dict[str, torch.Tensor]:
    """The elementwise mean of state dicts (the reference's post-training
    weight averaging, AVE/run_adapt_ave29.py:203-214): sum(xs) / n."""
    n = float(len(state_dicts))
    return {k: sum(sd[k] for sd in state_dicts) / n for k in state_dicts[0]}
