"""AVE-29 on CLIP ViT-B/16 with STG-CMA fusion adapters, plain float32.

The forward of arXiv:2103.00020's visual tower (pre-LN blocks, QuickGELU
MLP, class token, learned positions) run over both streams, with the
STG-CMA additions of kaiw7/STG-CMA `AVE/model/CLIP_AVE.py` in its `fusion`
mode: per-frame temporal embeddings; in each block a temporal attention
over the T frames of each token (the block's own attention weights) with a
T_Adapter added to it, then the spatial attention and the MLP, each with its
adapter hidden exchanged between the streams (`layers.fuse`, frame by
frame) before the adapter's up-projection; the class tokens through ln_post;
the dual head fc2(dropout(fc1([a, v]))).

Inputs: v (B, T, H, W, 3) normalized frames, a (B, T, 102, 128) fbank
images. Output: logits (B*T, label_dim).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .layers import adapter, adapter_hidden, adapter_out, fuse, layernorm, linear, self_attention

BB = "backbone"


def _embed(W, cfg, x, conv, pos, t_emb):
    """(B, T, H, W, Cin) -> (B*T, 1 + patches, C) after ln_pre."""
    B, T = x.shape[:2]
    y = F.conv2d(x.reshape((B * T,) + x.shape[2:]).permute(0, 3, 1, 2), W[conv],
                 stride=cfg["patch_size"])
    y = y.flatten(2).transpose(1, 2)                                   # (BT, P, C)
    C = y.shape[-1]
    cls = W[f"{BB}.class_embedding"].expand(B * T, 1, C)
    y = torch.cat([cls, y], dim=1) + W[pos]
    N = y.shape[1]
    y = y.reshape(B, T, N, C) + W[t_emb][:, :, None, :]
    return layernorm(W, f"{BB}.ln_pre", y.reshape(B * T, N, C))


def _attn(W, p, x, heads):
    return self_attention(W, f"{p}.attn.in_proj", f"{p}.attn.out_proj",
                          layernorm(W, f"{p}.ln_1", x), heads)


def _temporal(W, p, x, T, heads, ad):
    BT, N, C = x.shape
    B = BT // T
    xt = x.reshape(B, T, N, C).transpose(1, 2).reshape(B * N, T, C)
    xt = xt + adapter(W, f"{p}.{ad}", _attn(W, p, xt, heads))
    return xt.reshape(B, N, T, C).transpose(1, 2).reshape(BT, N, C)


def _mlp(W, p, x):
    h = linear(W, f"{p}.mlp.c_fc", layernorm(W, f"{p}.ln_2", x))
    return linear(W, f"{p}.mlp.c_proj", h * torch.sigmoid(1.702 * h))


def _exchange(W, p, v, a, vo, ao, ad_v, ad_a):
    """v + vo + up(fused hidden of vo), and the same for a."""
    gv, ga = W[f"{p}.gate_v"], W[f"{p}.gate_a"]
    vh, ah = fuse(adapter_hidden(W, f"{p}.{ad_v}", vo), adapter_hidden(W, f"{p}.{ad_a}", ao),
                  gv, ga)
    return v + vo + adapter_out(W, f"{p}.{ad_v}", vh), a + ao + adapter_out(W, f"{p}.{ad_a}", ah)


def block(W, cfg, i, v, a):
    p, h, T = f"{BB}.resblocks.{i}", cfg["heads"], cfg["num_frames"]
    v = _temporal(W, p, v, T, h, "T_Adapter")
    a = _temporal(W, p, a, T, h, "T_Adapter_Audio")
    v, a = _exchange(W, p, v, a, _attn(W, p, v, h), _attn(W, p, a, h),
                     "S_Adapter", "S_Adapter_Audio")
    return _exchange(W, p, v, a, _mlp(W, p, v), _mlp(W, p, a),
                     "MLP_Adapter", "MLP_Adapter_Audio")


def features(W, cfg, a, v):
    """The head's input: [ln_post(a's class token), ln_post(v's)] (B*T, 2C)."""
    v = _embed(W, cfg, v, f"{BB}.conv1.weight", f"{BB}.positional_embedding",
               f"{BB}.temporal_embedding")
    a = _embed(W, cfg, a[..., None], f"{BB}.conv1_audio.weight",
               f"{BB}.positional_embedding_audio", f"{BB}.temporal_embedding_audio")
    for i in range(cfg["layers"]):
        v, a = block(W, cfg, i, v, a)
    return torch.cat([layernorm(W, f"{BB}.ln_post", a[:, 0]),
                      layernorm(W, f"{BB}.ln_post", v[:, 0])], dim=-1)


def head(W, x, keep=None):
    """fc2(fc1(x)), with inverted dropout (rate 1/2) where a keep mask is given."""
    x = linear(W, "mlp_head.fc1", x)
    if keep is not None:
        x = torch.where(keep, x * 2.0, torch.zeros_like(x))
    return linear(W, "mlp_head.fc2", x)


def forward(W, cfg, a, v, keep=None):
    return head(W, features(W, cfg, a, v), keep)
