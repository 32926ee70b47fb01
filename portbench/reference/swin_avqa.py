"""MUSIC-AVQA on Swin-Large with STG-CMA fusion adapters, plain float32.

The tower is arXiv:2103.14030's Swin (4x4 patch embed, shifted 7x7 windows
with a relative-position bias, patch merging, four stages) run frame by
frame over both streams, with the STG-CMA additions of kaiw7/STG-CMA
`AVQA/model/Swin_AVQAModel_V1.py` in its fusion mode: in every even block a
temporal attention over the T frames of each token (the block's attention
weights, one temporal bias table a stream) plus a T_Adapter; the window
attention's S_Adapter2 hiddens exchanged between the streams window by
window, the MLP's S_Adapter hiddens over the whole stage grid; and the
negative visual stream, which runs the frozen tower alone. The head: the
question LSTM encoder, audio-visual grounding, the match MLP and the
question-as-query attention QA head.

Inputs: a (B, T, 224, 224) fbank images, v and v_nega (B, T, 224, 224, 3)
normalized frames, question (B, L) integer ids.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .layers import (adapter, adapter_hidden, adapter_out, fuse, layernorm, linear, matmul,
                     self_attention)

BB = "backbone"
HP = "avqatask"


def stage_geometry(cfg, s, i):
    """(H, W, window, shift, temporal) of block i of stage s."""
    H = W_ = cfg["img_size"] // cfg["patch_size"][1] // 2 ** s
    ws, ss = cfg["window_size"], 0 if i % 2 == 0 else cfg["window_size"] // 2
    if H <= ws:
        ws, ss = H, 0
    return H, W_, ws, ss, i % 2 == 0


def rel_index(ws, device):
    c = torch.stack(torch.meshgrid(torch.arange(ws), torch.arange(ws), indexing="ij")).flatten(1)
    rel = (c[:, :, None] - c[:, None, :]).permute(1, 2, 0) + (ws - 1)
    return (rel[..., 0] * (2 * ws - 1) + rel[..., 1]).to(device)


def shift_mask(H, W_, ws, ss, device):
    """(nW, ws^2, ws^2): -100 between tokens of different shift regions."""
    img = torch.zeros(H, W_)
    cnt = 0
    for hs in (slice(0, -ws), slice(-ws, -ss), slice(-ss, None)):
        for wsl in (slice(0, -ws), slice(-ws, -ss), slice(-ss, None)):
            img[hs, wsl] = cnt
            cnt += 1
    m = img.reshape(H // ws, ws, W_ // ws, ws).permute(0, 2, 1, 3).reshape(-1, ws * ws)
    return torch.where(m[:, None, :] != m[:, :, None], -100.0, 0.0).to(device)


def partition(x, ws):
    B, H, W_, C = x.shape
    x = x.reshape(B, H // ws, ws, W_ // ws, ws, C).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(-1, ws * ws, C)


def reverse(w, ws, H, W_):
    B = w.shape[0] // ((H // ws) * (W_ // ws))
    x = w.reshape(B, H // ws, W_ // ws, ws, ws, -1).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(B, H * W_, -1)


def _windows(W, p, x, geo, heads):
    """LN, shift, partition, window attention with its bias: (BT*nW, ws^2, C)."""
    H, W_, ws, ss, _ = geo
    BT, _, C = x.shape
    xr = layernorm(W, f"{p}.norm1", x).reshape(BT, H, W_, C)
    if ss:
        xr = torch.roll(xr, (-ss, -ss), dims=(1, 2))
    xw = partition(xr, ws)
    idx = rel_index(ws, x.device)
    bias = W[f"{p}.attn.relative_position_bias_table"][idx.reshape(-1)]
    bias = bias.reshape(ws * ws, ws * ws, heads).permute(2, 0, 1)           # (h, n, n)
    if ss:
        nW = shift_mask(H, W_, ws, ss, x.device)
        bias = (bias[None] + nW[:, None]).repeat(BT, 1, 1, 1)
    return self_attention(W, f"{p}.attn.qkv", f"{p}.attn.proj", xw, heads, bias)


def _merge(w, geo, BT):
    H, W_, ws, ss, _ = geo
    x = reverse(w, ws, H, W_).reshape(BT, H, W_, -1)
    if ss:
        x = torch.roll(x, (ss, ss), dims=(1, 2))
    return x.reshape(BT, H * W_, -1)


def _temporal(W, p, x, T, heads, table, ad):
    BT, N, C = x.shape
    B = BT // T
    xt = x.reshape(B, T, N, C).transpose(1, 2).reshape(B * N, T, C)
    t = torch.arange(T, device=x.device)
    bias = W[f"{p}.attn.{table}"][(t[:, None] - t[None, :] + T - 1).reshape(-1)]
    bias = bias.reshape(T, T, heads).permute(2, 0, 1)
    res = self_attention(W, f"{p}.attn.qkv", f"{p}.attn.proj", layernorm(W, f"{p}.norm1", xt),
                         heads, bias)
    xt = xt + adapter(W, f"{p}.{ad}", res)
    return xt.reshape(B, N, T, C).transpose(1, 2).reshape(BT, N, C)


def _ffn(W, p, x):
    h = F.gelu(linear(W, f"{p}.mlp.fc1", layernorm(W, f"{p}.norm2", x)))
    return linear(W, f"{p}.mlp.fc2", h)


def block(W, cfg, s, i, v, a, nega=None):
    p = f"{BB}.layers.{s}.blocks.{i}"
    geo = stage_geometry(cfg, s, i)
    heads, T = cfg["num_heads"][s], cfg["num_frames"]
    gv, ga = W[f"{p}.gate_v"], W[f"{p}.gate_a"]
    if geo[4]:
        v = _temporal(W, p, v, T, heads, "temporal_position_bias_table", "T_Adapter")
        a = _temporal(W, p, a, T, heads, "temporal_position_bias_table_audio",
                      "T_Adapter_Audio")
    wv, wa = _windows(W, p, v, geo, heads), _windows(W, p, a, geo, heads)
    hv, ha = fuse(adapter_hidden(W, f"{p}.S_Adapter2", wv),
                  adapter_hidden(W, f"{p}.S_Adapter2_Audio", wa), gv, ga)
    v = v + _merge(wv + adapter_out(W, f"{p}.S_Adapter2", hv), geo, v.shape[0])
    a = a + _merge(wa + adapter_out(W, f"{p}.S_Adapter2_Audio", ha), geo, a.shape[0])
    vn, an = _ffn(W, p, v), _ffn(W, p, a)
    hv, ha = fuse(adapter_hidden(W, f"{p}.S_Adapter", vn),
                  adapter_hidden(W, f"{p}.S_Adapter_Audio", an), gv, ga)
    v = v + vn + adapter_out(W, f"{p}.S_Adapter", hv)
    a = a + an + adapter_out(W, f"{p}.S_Adapter_Audio", ha)
    if nega is not None:
        nega = nega + _merge(_windows(W, p, nega, geo, heads), geo, nega.shape[0])
        nega = nega + _ffn(W, p, nega)
    return v, a, nega


def _patch_embed(W, p, x, cfg):
    """(B, T, H, W, Cin) -> (B*T, H/4 * W/4, C) after the embed's norm."""
    B, T = x.shape[:2]
    pt, ph, pw = cfg["patch_size"]
    y = F.conv3d(x.permute(0, 4, 1, 2, 3), W[f"{p}.proj.weight"], W[f"{p}.proj.bias"],
                 stride=(pt, ph, pw))
    y = y.permute(0, 2, 3, 4, 1)
    return layernorm(W, f"{p}.norm", y.reshape(B * T // pt, -1, y.shape[-1]))


def _patch_merge(W, s, x, H):
    B, _, C = x.shape
    x = x.reshape(B, H, H, C)
    x = torch.cat([x[:, 0::2, 0::2], x[:, 1::2, 0::2], x[:, 0::2, 1::2], x[:, 1::2, 1::2]], -1)
    p = f"{BB}.layers.{s}.downsample"
    return linear(W, f"{p}.reduction", layernorm(W, f"{p}.norm", x.reshape(B, -1, 4 * C)))


def tower(W, cfg, a, v, v_nega=None):
    """The final-normed tokens of each stream: (a, v, v_nega or None)."""
    v = _patch_embed(W, f"{BB}.patch_embed", v, cfg)
    a = _patch_embed(W, f"{BB}.patch_embed_audio", a[..., None], cfg)
    nega = None if v_nega is None else _patch_embed(W, f"{BB}.patch_embed", v_nega, cfg)
    for s, depth in enumerate(cfg["depths"]):
        for i in range(depth):
            v, a, nega = block(W, cfg, s, i, v, a, nega)
        if s < len(cfg["depths"]) - 1:
            H = cfg["img_size"] // cfg["patch_size"][1] // 2 ** s
            v, a = _patch_merge(W, s, v, H), _patch_merge(W, s, a, H)
            nega = None if nega is None else _patch_merge(W, s, nega, H)
    fn = f"{BB}.norm"
    return (layernorm(W, fn, a), layernorm(W, fn, v),
            None if nega is None else layernorm(W, fn, nega))


# ---------------------------------------------------------------------------
# the head
# ---------------------------------------------------------------------------

def _l2norm(x, dim):
    return x / torch.linalg.vector_norm(x, dim=dim, keepdim=True).clamp_min(1e-12)


def question(W, q):
    """Question ids (B, L) -> (B, C): tanh of the embedded words through the
    LSTM (torch's gate order i, f, g, o), tanh of [h_n, c_n], fc."""
    p = f"{HP}.question_encoder"
    x = torch.tanh(W[f"{p}.word2vec"][q])                                   # (B, L, E)
    l = 0
    wi, wh = W[f"{p}.lstm.layers.{l}.w_ih"], W[f"{p}.lstm.layers.{l}.w_hh"]
    b = W[f"{p}.lstm.layers.{l}.b_ih"] + W[f"{p}.lstm.layers.{l}.b_hh"]
    Hd = wh.shape[1]
    h = x.new_zeros(x.shape[0], Hd)
    c = x.new_zeros(x.shape[0], Hd)
    xw = matmul(x, wi.t())
    for t in range(x.shape[1]):
        g = xw[:, t] + matmul(h, wh.t()) + b
        i_, f_, g_, o_ = g[:, :Hd], g[:, Hd:2 * Hd], g[:, 2 * Hd:3 * Hd], g[:, 3 * Hd:]
        c = torch.sigmoid(f_) * c + torch.sigmoid(i_) * torch.tanh(g_)
        h = torch.sigmoid(o_) * torch.tanh(c)
    return linear(W, f"{p}.fc", torch.tanh(torch.cat([h, c], dim=-1)))


def audio_feature(W, f_a):
    return linear(W, f"{HP}.fc_a2", torch.relu(f_a.mean(dim=1)))


def grounding(W, audio_feat, f_v):
    v_before = f_v.mean(dim=1)
    v_feat = _l2norm(f_v, 2)
    a_n = _l2norm(audio_feat, 1)
    p = torch.softmax(matmul(v_feat, a_n[:, :, None])[..., 0], dim=-1)
    grd = matmul(p[:, None, :], v_feat)[:, 0]
    return linear(W, f"{HP}.fc_gl", torch.tanh(torch.cat([v_before, grd], dim=-1)))


def match(W, audio_feat, grd):
    x = torch.cat([audio_feat, grd], dim=-1)
    for k in ("fc1", "fc2", "fc3"):
        x = torch.relu(linear(W, f"{HP}.{k}", x))
    return linear(W, f"{HP}.fc4", x)


def _mha(W, p, q, kv, heads, keep=None, rate=0.1):
    """nn.MultiheadAttention(batch_first) of q (B, 1, C) over kv (B, T, C);
    where `keep` is given, dropout on the weights (rate `rate`)."""
    C = q.shape[-1]
    w, b = W[f"{p}.in_proj.weight"], W[f"{p}.in_proj.bias"]
    qh = matmul(q, w[:C].t()) + b[:C]
    kh = matmul(kv, w[C:2 * C].t()) + b[C:2 * C]
    vh = matmul(kv, w[2 * C:].t()) + b[2 * C:]
    B, dh = q.shape[0], C // heads
    qh, kh, vh = (t.reshape(B, -1, heads, dh).transpose(1, 2) for t in (qh, kh, vh))
    att = torch.softmax(matmul(qh, kh.transpose(-1, -2)) * dh ** -0.5, dim=-1)
    if keep is not None:
        att = att * keep / (1.0 - rate)
    o = matmul(att, vh).transpose(1, 2).reshape(B, -1, C)
    return linear(W, f"{p}.out_proj", o)


def answer(W, hcfg, qst, grd, audio_feat, B, T, keeps=(None, None)):
    """out_qa (B, answers); keeps: the dropout masks of attn_v, attn_a."""
    d, h = hcfg["feat_dim"], hcfg["attn_heads"]
    xq = qst[:, None]
    v_seq, a_seq = grd.reshape(B, T, d), audio_feat.reshape(B, T, d)
    v_att = _mha(W, f"{HP}.attn_v", xq, v_seq, h, keeps[0], hcfg["attn_dropout"])[:, 0]
    v_att = layernorm(W, f"{HP}.norm1", v_att + linear(
        W, f"{HP}.linear12", torch.relu(linear(W, f"{HP}.linear11", v_att))))
    a_att = _mha(W, f"{HP}.attn_a", xq, a_seq, h, keeps[1], hcfg["attn_dropout"])[:, 0]
    a_att = layernorm(W, f"{HP}.norm2", a_att + linear(
        W, f"{HP}.linear22", torch.relu(linear(W, f"{HP}.linear21", a_att))))
    feat = torch.cat([a_att + a_seq.mean(dim=1), v_att + v_seq.mean(dim=1)], dim=-1)
    feat = torch.tanh(linear(W, f"{HP}.fc_fusion", torch.tanh(feat)) * qst)
    return linear(W, f"{HP}.fc_ans", feat)


def serve(W, cfg, hcfg, a, v, q):
    """out_qa of a served request (no negative stream)."""
    f_a, f_v, _ = tower(W, cfg, a, v, None)
    af = audio_feature(W, f_a)
    B, T = v.shape[:2]
    return answer(W, hcfg, question(W, q), grounding(W, af, f_v), af, B, T)


def train_loss_terms(W, cfg, hcfg, a, v, v_nega, q, answers, keeps):
    """(sum of the QA cross-entropies, sum of the match cross-entropies) of
    these clips: the answer against out_qa, and the positive (label 1) and
    negative (label 0) match logits of every frame."""
    f_a, f_v, f_n = tower(W, cfg, a, v, v_nega)
    af = audio_feature(W, f_a)
    B, T = v.shape[:2]
    grd = grounding(W, af, f_v)
    qa = answer(W, hcfg, question(W, q), grd, af, B, T, keeps)
    m_pos, m_neg = match(W, af, grd), match(W, af, grounding(W, af, f_n))
    ce_qa = F.cross_entropy(qa, answers.long(), reduction="sum")
    ce_m = (F.cross_entropy(m_pos, torch.ones(len(m_pos), dtype=torch.long,
                                              device=m_pos.device), reduction="sum")
            + F.cross_entropy(m_neg, torch.zeros(len(m_neg), dtype=torch.long,
                                                 device=m_neg.device), reduction="sum"))
    return ce_qa, ce_m
