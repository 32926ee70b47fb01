"""AVE-29 audio-visual event localization, CLIP and Swin flavors.

Port of `stgcma_tpu/models/ave.py`: the CLIP half (:20-37, :69-84) and the
Swin half (:44-62), each in its four ftmodes, float or int8 towers. The
two-stream modes carry the dual MLP head Linear(2C, 512) -> Dropout(0.5) ->
Linear(512, label_dim), the dropout only where a training generator is
given; `videoonly` and `audioonly` the single-stream head LayerNorm(C) ->
Linear(C, label_dim). I/O: CLIP a (B, T,
102, 128), Swin a (B, T, 224, 224); v (B, T, 224, 224, 3) -> logits (B*T,
label_dim).
"""
from __future__ import annotations

import torch
from torch import nn

from ..configs import ClipConfig, SwinConfig
from ..nn import swin
from ..nn.clip_vit import ClipBackbone, clip_backbone_apply, init_clip_backbone_
from ..ops.common import LayerNorm, Linear, layernorm, linear, resolve_device
from ..ops.quant import quantize_swin_tower


class MlpHead(nn.Module):
    def __init__(self, in_dim: int, label_dim: int):
        super().__init__()
        self.fc1 = Linear(2 * in_dim, 512)
        self.fc2 = Linear(512, label_dim)


class SingleHead(nn.Module):
    """The single-stream head (`_mlp_head_init(dual=False)` :27)."""

    def __init__(self, in_dim: int, label_dim: int):
        super().__init__()
        self.ln = LayerNorm(in_dim)
        self.fc = Linear(in_dim, label_dim)


HEAD_DROPOUT = 0.5                    # the dual head's Dropout (Swin_AVE.py:1319-1325)


def mlp_head_apply(head, x, generator: torch.Generator = None):
    """`_mlp_head_apply` (:30): fc2(dropout(fc1(x))), or fc(ln(x)). With a
    `generator` (training) fc1's output goes through inverted dropout, each
    value kept with probability 1 - HEAD_DROPOUT and scaled by 1 / (1 -
    HEAD_DROPOUT) in its dtype (:33-35); the keep mask is drawn on the
    generator's device. Without one (serving) there is no dropout."""
    if not isinstance(head, MlpHead):
        return linear(head.fc, layernorm(head.ln, x))
    x = linear(head.fc1, x)
    if generator is not None:
        keep = torch.rand(x.shape, generator=generator, device=generator.device) >= HEAD_DROPOUT
        x = torch.where(keep.to(x.device), x / (1.0 - HEAD_DROPOUT), 0.0).to(x.dtype)
    return linear(head.fc2, x)


class ClipAVE(nn.Module):
    def __init__(self, cfg: ClipConfig):
        super().__init__()
        self.backbone = ClipBackbone(cfg)
        dual = cfg.ftmode in ("multimodal", "fusion")
        self.mlp_head = (MlpHead if dual else SingleHead)(cfg.embed_dim, cfg.label_dim)


def init_clip_ave(cfg: ClipConfig, generator: torch.Generator = None,
                  device="cuda") -> ClipAVE:
    """A ClipAVE with the JAX package's initialization, drawn on the CPU from
    `generator` (seed 0 if none), then moved to `device`."""
    device = resolve_device(device)
    g = generator if generator is not None else torch.Generator().manual_seed(0)
    model = ClipAVE(cfg)
    init_clip_backbone_(model.backbone, cfg, g)
    with torch.no_grad():
        for lin in model.mlp_head.children():
            if isinstance(lin, Linear):
                nn.init.trunc_normal_(lin.weight, std=0.02, a=-0.04, b=0.04, generator=g)
    return model.to(device)


def apply_clip_ave(model: ClipAVE, cfg: ClipConfig, a=None, v=None,
                   generator: torch.Generator = None):
    """Forward in cfg.ftmode: the class-token features of the mode's streams,
    concatenated as (a, v) in the two-stream modes, through the head
    (`apply_clip_ave` :76; `generator`: the head's training dropout, as JAX's
    `rng`). `videoonly` needs no a, `audioonly` no v. Returns logits (B*T,
    label_dim)."""
    feats = clip_backbone_apply(model.backbone, cfg, a=a, v=v)
    if cfg.ftmode == "videoonly":
        pooled = feats["v"]
    elif cfg.ftmode == "audioonly":
        pooled = feats["a"]
    else:
        pooled = torch.cat([feats["a"], feats["v"]], dim=-1)
    return mlp_head_apply(model.mlp_head, pooled, generator)


def random_clip_ave(cfg: ClipConfig, seed: int) -> ClipAVE:
    """A ClipAVE of cfg.ftmode on the CPU with every leaf drawn from one seeded
    generator, for smoke runs and measurements: linears N(0, 0.02), LayerNorm
    weights 1 + N(0, 0.1), gates N(0, 0.5), embeddings N(0, C^-1/2), patch
    convs uniform(+-1/sqrt(fan_in)). Unlike the training init, the gates and
    the adapters' D_fc2 are non-zero, so fusion and adapters are live."""
    g = torch.Generator().manual_seed(seed)
    model = ClipAVE(cfg)
    with torch.no_grad():
        for name, p in model.named_parameters():
            leaf = name.rsplit(".", 1)[-1]
            if name.startswith("backbone.conv1"):
                bound = p[0].numel() ** -0.5
                p.uniform_(-bound, bound, generator=g)
            elif "embedding" in name:
                p.normal_(0.0, cfg.embed_dim ** -0.5, generator=g)
            elif leaf in ("gate_v", "gate_a"):
                p.normal_(0.0, 0.5, generator=g)
            elif (".ln_" in f".{name}" or name == "mlp_head.ln.weight") and leaf == "weight":
                p.normal_(1.0, 0.1, generator=g)
            else:
                p.normal_(0.0, 0.02, generator=g)
    return model


# ---------------------------------------------------------------------------
# Swin flavor
# ---------------------------------------------------------------------------

class SwinAVE(nn.Module):
    def __init__(self, cfg: SwinConfig):
        super().__init__()
        self.backbone = swin.SwinBackbone(cfg)
        dual = cfg.ftmode in ("multimodal", "fusion")
        self.mlp_head = (MlpHead if dual else SingleHead)(cfg.num_features, cfg.label_dim)


def _uniform_patch_convs_(bb: swin.SwinBackbone, g: torch.Generator):
    """uniform(+-1/sqrt(fan_in)) patch-conv weights and biases (conv3d_init)."""
    for conv in (bb.patch_embed.proj, bb.patch_embed_audio.proj):
        bound = conv.weight[0].numel() ** -0.5
        conv.weight.uniform_(-bound, bound, generator=g)
        conv.bias.uniform_(-bound, bound, generator=g)


def _backbone(module: nn.Module) -> swin.SwinBackbone:
    """`module`'s backbone: module.backbone, or `module` itself."""
    return getattr(module, "backbone", module)


def init_swin_(module: nn.Module, g: torch.Generator):
    """In place, the JAX package's Swin initialization (`swin.backbone_init`,
    `linear_init`): the backbone's patch convs and their biases
    uniform(+-1/sqrt(fan_in)), then every bias table and 2-D weight of
    `module` (a SwinAVE or a backbone) trunc_normal(0.02), and every adapter
    D_fc2 zero; biases, gates and LayerNorms keep their construction values
    (zero, zero, unit)."""
    with torch.no_grad():
        _uniform_patch_convs_(_backbone(module), g)
        for name, p in module.named_parameters():
            if name.endswith("bias_table") or (p.dim() == 2 and name.endswith(".weight")):
                nn.init.trunc_normal_(p, std=0.02, a=-0.04, b=0.04, generator=g)
        for name, p in module.named_parameters():
            if ".D_fc2." in name:
                p.zero_()


def init_swin_ave(cfg: SwinConfig, generator: torch.Generator = None,
                  device="cuda") -> SwinAVE:
    """A SwinAVE of cfg.ftmode with the JAX package's initialization
    (`swin.backbone_init`, `_mlp_head_init`), drawn on the CPU from
    `generator` (seed 0 if none), then moved to `device`: trunc_normal(0.02)
    linears and bias tables, zero biases, zero adapter D_fc2 and gates,
    uniform(+-1/sqrt(fan_in)) patch convs and their biases, unit LayerNorms
    (the single-stream head's `ln` among them)."""
    device = resolve_device(device)
    g = generator if generator is not None else torch.Generator().manual_seed(0)
    model = SwinAVE(cfg)
    init_swin_(model, g)
    return model.to(device)


def apply_swin_ave(model: SwinAVE, cfg: SwinConfig, a=None, v=None,
                   generator: torch.Generator = None):
    """Forward in cfg.ftmode: the tokens of each stream are averaged; in the
    two-stream modes the two are concatenated as (a, v) (Swin_AVE.py:1596).
    `videoonly` needs no a, `audioonly` no v; `generator` as in
    `apply_clip_ave`. Returns logits (B*T, label_dim)."""
    feats = swin.backbone_apply(model.backbone, cfg, a=a, v=v)
    if cfg.ftmode == "videoonly":
        pooled = feats["v"].mean(dim=1)
    elif cfg.ftmode == "audioonly":
        pooled = feats["a"].mean(dim=1)
    else:
        pooled = torch.cat([feats["a"].mean(dim=1), feats["v"].mean(dim=1)], dim=-1)
    return mlp_head_apply(model.mlp_head, pooled, generator)


def random_swin_(module: nn.Module, g: torch.Generator):
    """In place, `random_swin_ave`'s draws over every parameter of `module`
    (a SwinAVE or a backbone), in the order of `named_parameters`, then the
    backbone's patch convs."""
    norms = {id(m.weight) for m in module.modules() if isinstance(m, LayerNorm)}
    with torch.no_grad():
        for name, p in module.named_parameters():
            if id(p) in norms:
                p.normal_(1.0, 0.1, generator=g)
            elif name.endswith("bias_table") or name.rsplit(".", 1)[-1] in ("gate_v", "gate_a"):
                p.normal_(0.0, 0.5, generator=g)
            else:
                p.normal_(0.0, 0.02, generator=g)
        _uniform_patch_convs_(_backbone(module), g)


def random_swin_ave(cfg: SwinConfig, seed: int, int8: bool = False) -> SwinAVE:
    """A SwinAVE of cfg.ftmode on the CPU with every leaf drawn from one
    seeded generator, for smoke runs and measurements: linears N(0, 0.02),
    LayerNorm weights 1 + N(0, 0.1), relative and temporal bias tables N(0,
    0.5), fusion gates N(0, 0.5), patch convs uniform(+-1/sqrt(fan_in)). Unlike the training
    init, the adapters' D_fc2, the gates and the bias tables are far from
    zero, so adapters, fusion and biases are live. `normal_` takes the same
    draws whatever its std, so the gates' std moves no other weight. With
    `int8`, the same model with its tower quantized (`quantize_swin_tower`)."""
    model = SwinAVE(cfg)
    random_swin_(model, torch.Generator().manual_seed(seed))
    if int8:
        model.backbone = quantize_swin_tower(model.backbone)
    return model
