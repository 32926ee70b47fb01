"""AVSBench S4 segmentation on Swin-Large with STG-CMA fusion adapters, plain float32.

The model of arXiv:2207.05042 (AVSBench's audio-visual segmentation) on the
two-stream Swin fusion tower, as kaiw7/STG-CMA adapts it
(`AVS/model/Swin_AVSModel.py:1473-1894`, `AVS/model/TPAVI.py`):

- the tower: `swin_avqa.py`'s blocks, patch embeds and merges over both
  streams; the visual stream's four taps before each downsample, the last
  through the final norm, and the final-normed audio tokens;
- `audio_linear` on the mean of each frame's audio tokens;
- per stage `x{i}_linear` (stage width -> vis_dim) and an ASPP classifier
  (a sum of 3x3 convolutions dilated 3, 6, 12, 18);
- TPAVI at every stage in 'dot' mode: g, theta, phi as 1x1x1 Conv3d, phi
  over the aligned audio repeated over each frame's H W positions, the
  (THW, THW) gram theta phi^T divided by THW with no softmax, times g; W_z
  (Conv3d, then BatchNorm3d from its running statistics), plus x, LayerNorm;
- the FPN top-down path: each FeatureFusionBlock is the skip through a
  residual conv unit added, a second residual conv unit and a 2x bilinear
  upsample with align_corners; the output head a 3x3 conv, a 2x bilinear
  upsample (align_corners False), a 3x3 conv, ReLU and a 1x1 conv.

Departures from the published code, none of which changes a number:
- each residual conv unit adds relu(x), not x: the published unit's
  nn.ReLU(inplace=True) rewrites its input before the skip adds it;
- the batch is computed `chunk` clips at a time by the caller;
- a Conv3d of kernel 1 is taken on the channel-first map as published, a
  Linear's (out, in) weight viewed as its (out, in, 1, 1, 1) kernel.

Under `layers.fp8_products()` every convolution, like every product,
takes float8 e4m3 operands: the input scaled per position over its
channels, the weight per output channel.

Inputs: a (B, T, 224, 224) fbank images, v (B, T, 224, 224, 3) normalized
frames. Output: the mask logits (B*T, 224, 224, 1).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .layers import _FP8, fake_fp8, layernorm, linear, matmul
from .swin_avqa import BB, _patch_embed, _patch_merge, block

HP = "avstask"
ASPP_DILATIONS = (3, 6, 12, 18)


def tower(W, cfg, a, v):
    """(the final-normed audio tokens (B*T, n, C), the four visual taps
    (B*T, H_s * W_s, C_s))."""
    v = _patch_embed(W, f"{BB}.patch_embed", v, cfg)
    a = _patch_embed(W, f"{BB}.patch_embed_audio", a[..., None], cfg)
    taps = []
    last = len(cfg["depths"]) - 1
    for s, depth in enumerate(cfg["depths"]):
        for i in range(depth):
            v, a, _ = block(W, cfg, s, i, v, a)
        if s < last:
            taps.append(v)
            H = cfg["img_size"] // cfg["patch_size"][1] // 2 ** s
            v, a = _patch_merge(W, s, v, H), _patch_merge(W, s, a, H)
    fn = f"{BB}.norm"
    taps.append(layernorm(W, fn, v))
    return layernorm(W, fn, a), taps


def _conv(W, p, x, conv, **kw):
    """`conv` (F.conv2d or F.conv3d) of the channel-first x with p's weight
    and bias; a 2-D weight is a kernel of size 1."""
    w, b = W[f"{p}.weight"], W[f"{p}.bias"]
    w = w.reshape(w.shape + (1,) * (x.dim() - w.dim()))
    if _FP8.get():
        x = fake_fp8(x, 1)
        w = fake_fp8(w.reshape(len(w), -1)).reshape(w.shape)
    return conv(x, w, b, **kw)


def conv2d(W, p, x, padding=0, dilation=1):
    return _conv(W, p, x, F.conv2d, padding=padding, dilation=dilation)


def aspp(W, p, x):
    """Classifier_Module: the sum of the dilated 3x3 convolutions."""
    out = conv2d(W, f"{p}.convs.0", x, ASPP_DILATIONS[0], ASPP_DILATIONS[0])
    for k, d in enumerate(ASPP_DILATIONS[1:], 1):
        out = out + conv2d(W, f"{p}.convs.{k}", x, d, d)
    return out


def tpavi(W, p, x, audio, T):
    """TPAVIModule.forward in 'dot' mode with audio, eval. x (B*T, C, H, W),
    audio (B, T, A) -> (B*T, C, H, W), as Swin_AVSModel's tpavi_va reshapes
    around it."""
    BT, C, H, W_ = x.shape
    B = BT // T
    x = x.reshape(B, T, C, H, W_).permute(0, 2, 1, 3, 4)                 # (B, C, T, H, W)
    audio_temp = linear(W, f"{p}.align_channel", audio)                  # (B, T, C)
    audio = audio_temp.permute(0, 2, 1)[..., None, None].repeat(1, 1, 1, H, W_)
    inter = W[f"{p}.g.weight"].shape[0]

    def rows(name, t):                                                   # (B, THW, inter)
        return _conv(W, f"{p}.{name}", t, F.conv3d).reshape(B, inter, -1).permute(0, 2, 1)

    g_x, theta_x, phi_x = rows("g", x), rows("theta", x), rows("phi", audio)
    f = matmul(theta_x, phi_x.permute(0, 2, 1))                          # (B, THW, THW)
    y = matmul(f / f.shape[-1], g_x)
    y = y.permute(0, 2, 1).reshape(B, inter, T, H, W_)
    w_y = _conv(W, f"{p}.W_z.conv", y, F.conv3d)
    bn = f"{p}.W_z.bn"
    w_y = F.batch_norm(w_y, W[f"{bn}.running_mean"], W[f"{bn}.running_var"],
                       W[f"{bn}.weight"], W[f"{bn}.bias"], training=False, eps=1e-5)
    z = layernorm(W, f"{p}.norm_layer", (w_y + x).permute(0, 2, 3, 4, 1))   # (B, T, H, W, C)
    return z.permute(0, 1, 4, 2, 3).reshape(BT, C, H, W_)


def rcu(W, p, x):
    """ResidualConvUnit: conv2(relu(conv1(relu(x)))) + relu(x) (the module
    docstring says why relu(x))."""
    xr = torch.relu(x)
    out = torch.relu(conv2d(W, f"{p}.conv1", xr, 1))
    return conv2d(W, f"{p}.conv2", out, 1) + xr


def ffb(W, p, x, skip=None):
    """FeatureFusionBlock."""
    out = x
    if skip is not None:
        out = out + rcu(W, f"{p}.resConfUnit1", skip)
    out = rcu(W, f"{p}.resConfUnit2", out)
    return F.interpolate(out, scale_factor=2, mode="bilinear", align_corners=True)


def output_conv(W, x):
    p = f"{HP}.output_conv"
    x = conv2d(W, f"{p}.conv0", x, 1)
    x = F.interpolate(x, scale_factor=2, mode="bilinear", align_corners=False)
    x = torch.relu(conv2d(W, f"{p}.conv2", x, 1))
    return conv2d(W, f"{p}.conv4", x)


def decode(W, hcfg, f_a, taps, B, T):
    """The decoder over the tower's outputs: the mask logits (B*T, 1, H, W)
    at four times the first tap's resolution."""
    audio = linear(W, f"{HP}.audio_linear", f_a.mean(dim=1).reshape(B, T, -1))
    maps = []
    for i, tap in enumerate(taps):
        r = hcfg["stage_resolutions"][i]
        x = linear(W, f"{HP}.x{i + 1}_linear", tap.reshape(tap.shape[0], r, r, -1))
        maps.append(aspp(W, f"{HP}.conv{i + 1}", x.permute(0, 3, 1, 2)))
    for i in hcfg["tpavi_stages"]:
        maps[i] = tpavi(W, f"{HP}.tpavi_b{i + 1}", maps[i], audio, T)
    n = len(maps)
    x = ffb(W, f"{HP}.path{n}", maps[-1])
    for i in range(n - 2, -1, -1):
        x = ffb(W, f"{HP}.path{i + 1}", x, maps[i])
    return output_conv(W, x)


def serve(W, cfg, hcfg, a, v):
    """The mask logits (B*T, 224, 224, 1) of a served request. W holds the
    TPAVI BatchNorms' running statistics beside the benchmark's weights."""
    f_a, taps = tower(W, cfg, a, v)
    B, T = v.shape[:2]
    return decode(W, hcfg, f_a, taps, B, T).permute(0, 2, 3, 1)
