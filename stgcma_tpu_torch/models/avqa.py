"""MUSIC-AVQA: the Swin fusion backbone with the negative visual stream,
the question LSTM encoder, audio-visual grounding, the match head and the
question-conditioned attention QA head.

Port of `stgcma_tpu/models/avqa.py` (:1-165), reference
SwinTransformer2D_Adapter_AVQA (AVQA/model/Swin_AVQAModel_V1.py:1220-1903).
I/O: a (B, T, 224, 224), v / v_nega (B, T, 224, 224, 3), question (B, 14)
integer -> (out_qa (B, 42), out_match_posi (B*T, 2), out_match_nega (B*T,
2)). `answer_avqa` computes out_qa alone, which is what the JAX server's
compiled program keeps of `apply_avqa` (`serving.py:94-100` jits
`apply_avqa(...)[0]`; out_qa reads neither v_nega nor the match MLP, so XLA
drops the third tower stream and both match heads); the three-output path
feeds the A/V matching loss of training.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from ..configs import AVQAHeadConfig, SwinConfig
from ..nn import swin
from ..nn.lstm import LSTM, lstm_apply
from ..ops.attention import MultiheadAttention, mha
from ..ops.common import LayerNorm, Linear, layernorm, linear, resolve_device
from ..ops.quant import quantize_swin_tower
from ..runtime.profiling import annotate
from .ave import init_swin_, random_swin_


class QstEncoder(nn.Module):
    """QstEncoder(93, 1536, 1536, 1, 1536) (Swin_AVQAModel_V1.py:37-59): the
    word embedding `word2vec` (vocab, E), the LSTM and `fc` (2 layers H ->
    feat_dim)."""

    def __init__(self, hcfg: AVQAHeadConfig):
        super().__init__()
        self.word2vec = nn.Parameter(torch.zeros(hcfg.vocab_size, hcfg.qst_word_embed))
        self.lstm = LSTM(hcfg.qst_word_embed, hcfg.qst_hidden, hcfg.qst_layers)
        self.fc = Linear(2 * hcfg.qst_layers * hcfg.qst_hidden, hcfg.feat_dim)


class AVQAHead(nn.Module):
    """The head's parameters under the JAX tree's keys (`init_avqa_head`)."""

    def __init__(self, hcfg: AVQAHeadConfig):
        super().__init__()
        d = hcfg.feat_dim
        self.fc_a2 = Linear(d, d)
        self.fc_gl = Linear(2 * d, d)
        self.fc1 = Linear(2 * d, 512)
        self.fc2 = Linear(512, 256)
        self.fc3 = Linear(256, 128)
        self.fc4 = Linear(128, 2)
        self.linear11 = Linear(d, d)
        self.linear12 = Linear(d, d)
        self.linear21 = Linear(d, d)
        self.linear22 = Linear(d, d)
        self.norm1 = LayerNorm(d)
        self.norm2 = LayerNorm(d)
        self.attn_a = MultiheadAttention(d)
        self.attn_v = MultiheadAttention(d)
        self.question_encoder = QstEncoder(hcfg)
        self.fc_fusion = Linear(2 * d, d)
        self.fc_ans = Linear(d, hcfg.answer_dim)


class AVQAModel(nn.Module):
    def __init__(self, cfg: SwinConfig, hcfg: AVQAHeadConfig):
        super().__init__()
        if cfg.ftmode != "fusion":
            raise ValueError(f"AVQA takes a fusion Swin tower, not ftmode {cfg.ftmode!r}")
        if hcfg.feat_dim != cfg.num_features:
            raise ValueError(f"the head's feat_dim {hcfg.feat_dim} is not the tower's width "
                             f"{cfg.num_features}")
        self.backbone = swin.SwinBackbone(cfg)
        self.avqatask = AVQAHead(hcfg)


# ---------------------------------------------------------------------------
# the head's pieces
# ---------------------------------------------------------------------------

def _l2norm(x, dim):
    """x / max(||x||, 1e-12): the norm in fp32, cast to x's dtype before the
    divide (avqa.py:23-25)."""
    n = torch.linalg.vector_norm(x.float(), dim=dim, keepdim=True)
    return x / n.clamp_min(1e-12).to(x.dtype)


def apply_qst_encoder(p: QstEncoder, question, hcfg: AVQAHeadConfig):
    """question (B, L) integer -> (B, feat_dim) (avqa.py:38-47): tanh of the
    embedded words, seq-first through the LSTM, tanh of [h_n, c_n], fc."""
    emb = torch.tanh(F.embedding(question, p.word2vec)).transpose(0, 1)    # (L, B, E)
    _, (h, c) = lstm_apply(p.lstm, emb)
    q = torch.cat([h, c], dim=2)                                          # (layers, B, 2H)
    q = torch.tanh(q.transpose(0, 1).reshape(q.shape[1], -1))
    return linear(p.fc, q)


def audio_features(hp: AVQAHead, f_a):
    """fc_a2(relu(the mean audio token)): (B*T, N, C) -> (B*T, C)."""
    return linear(hp.fc_a2, torch.relu(f_a.mean(dim=1)))


def _grounding(hp: AVQAHead, audio_feat, f_v, hcfg: AVQAHeadConfig):
    """Normalized dot-product grounding (Swin_AVQAModel_V1.py:1806-1840):
    f_v (B*T, grid^2, C) tokens, audio_feat (B*T, C) -> (B*T, C)."""
    visual = f_v.reshape(f_v.shape[0], hcfg.grid * hcfg.grid, hcfg.feat_dim)
    v_before = visual.mean(dim=1)                                         # avgpool
    v_feat = _l2norm(visual, 2)
    a_n = _l2norm(audio_feat[:, :, None], 1)                             # (BT, C, 1)
    x2_va = torch.matmul(v_feat, a_n)[..., 0]                            # (BT, HW)
    x2_p = torch.softmax(x2_va.float(), dim=-1).to(v_feat.dtype)
    grd = torch.matmul(x2_p[:, None], v_feat)[:, 0]                      # (BT, C)
    return linear(hp.fc_gl, torch.tanh(torch.cat([v_before, grd], dim=-1)))


def _match(hp: AVQAHead, audio_feat, grd):
    """The 4-layer A/V match MLP (:1841-1866) -> (B*T, 2)."""
    feat = torch.cat([audio_feat, grd], dim=-1)
    for fc in (hp.fc1, hp.fc2, hp.fc3):
        feat = torch.relu(linear(fc, feat))
    return linear(hp.fc4, feat)


def _grounding_and_match(hp: AVQAHead, audio_feat, f_v, hcfg: AVQAHeadConfig):
    """`_grounding_and_match` (avqa.py:87-106): (grounded visual, match logits)."""
    grd = _grounding(hp, audio_feat, f_v, hcfg)
    return grd, _match(hp, audio_feat, grd)


def qa_combined(hp: AVQAHead, hcfg: AVQAHeadConfig, qst_feature, grd, audio_feat, B, T,
                generator: torch.Generator = None):
    """The question-as-query attention over the grounded visual and the audio
    sequences (:1873-1891), up to tanh(fc_fusion(...) * qst_feature): (B, C),
    the input of fc_ans. With a `generator` (training) both attentions take
    the dropout of `hcfg.attn_dropout` on their weights, attn_v's mask drawn
    first, then attn_a's (JAX splits its key into rng_v, rng_a, :145-155)."""
    d = hcfg.feat_dim
    drop = hcfg.attn_dropout if generator is not None else 0.0
    xq = qst_feature[:, None, :]                                          # (B, 1, C)
    v_seq = grd.reshape(B, T, d)
    a_seq = audio_feat.reshape(B, T, d)
    v_att = mha(hp.attn_v, xq, v_seq, v_seq, hcfg.attn_heads, dropout_rate=drop,
                generator=generator)[:, 0]
    src = linear(hp.linear12, torch.relu(linear(hp.linear11, v_att)))
    v_att = layernorm(hp.norm1, v_att + src)
    a_att = mha(hp.attn_a, xq, a_seq, a_seq, hcfg.attn_heads, dropout_rate=drop,
                generator=generator)[:, 0]
    src = linear(hp.linear22, torch.relu(linear(hp.linear21, a_att)))
    a_att = layernorm(hp.norm2, a_att + src)
    feat = torch.cat([a_att + a_seq.mean(dim=1), v_att + v_seq.mean(dim=1)], dim=-1)
    feat = linear(hp.fc_fusion, torch.tanh(feat))
    return torch.tanh(feat * qst_feature)


def _qa(hp: AVQAHead, hcfg: AVQAHeadConfig, qst_feature, grd, audio_feat, B, T,
        generator: torch.Generator = None):
    """out_qa (B, answer_dim)."""
    return linear(hp.fc_ans, qa_combined(hp, hcfg, qst_feature, grd, audio_feat, B, T,
                                         generator))


def answer_head_apply(hp: AVQAHead, hcfg: AVQAHeadConfig, feats, question, B, T):
    """out_qa from the two-stream tower's {"v", "a"}: the question encoder,
    the grounding of the positive stream and the two attentions; no match
    MLP."""
    audio_feat = audio_features(hp, feats["a"])
    qst = apply_qst_encoder(hp.question_encoder, question, hcfg)
    return _qa(hp, hcfg, qst, _grounding(hp, audio_feat, feats["v"], hcfg), audio_feat, B, T)


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------

def apply_avqa(model: AVQAModel, cfg: SwinConfig, hcfg: AVQAHeadConfig, a, v, v_nega,
               question, train: bool = False, generator: torch.Generator = None):
    """The fusion forward with the three tower streams (avqa.py:109-165).
    Returns (out_qa, out_match_posi, out_match_nega). With `train` and a
    `generator` the QA head's two attentions take their dropout
    (`qa_combined`); otherwise the forward is deterministic. The nega
    stream reads only frozen parameters under `freeze_base` (no temporal
    branch, no adapter; the relative-position tables frozen), so autograd
    records no graph for it there; the match MLP over it does."""
    with annotate("model.tower"):
        feats = swin.backbone_apply(model.backbone, cfg, a=a, v=v, v_nega=v_nega)
    with annotate("model.head"):
        hp = model.avqatask
        audio_feat = audio_features(hp, feats["a"])
        qst = apply_qst_encoder(hp.question_encoder, question, hcfg)
        grd_posi, out_match_posi = _grounding_and_match(hp, audio_feat, feats["v"], hcfg)
        _, out_match_nega = _grounding_and_match(hp, audio_feat, feats["v_nega"], hcfg)
        out_qa = _qa(hp, hcfg, qst, grd_posi, audio_feat, feats["B"], feats["T"],
                     generator if train else None)
    return out_qa, out_match_posi, out_match_nega


def answer_avqa(model: AVQAModel, cfg: SwinConfig, hcfg: AVQAHeadConfig, a, v, question):
    """out_qa alone, as `apply_avqa(...)[0]`: the two-stream tower (no nega
    stream) and `answer_head_apply`. This is what the server runs."""
    with annotate("model.tower"):
        feats = swin.backbone_apply(model.backbone, cfg, a=a, v=v)
    with annotate("model.head"):
        return answer_head_apply(model.avqatask, hcfg, feats, question, v.shape[0],
                                 v.shape[1] // cfg.patch_size[0])


# ---------------------------------------------------------------------------
# construction
# ---------------------------------------------------------------------------

def _head_linears(hp: AVQAHead):
    """Every Linear of the head, the attentions' in_proj / out_proj included."""
    return [m for m in hp.modules() if isinstance(m, Linear)]


def init_avqa(cfg: SwinConfig, hcfg: AVQAHeadConfig, generator: torch.Generator = None,
              device="cuda") -> AVQAModel:
    """An AVQAModel with the JAX package's initialization (`init_avqa`),
    drawn on the CPU from `generator` (seed 0 if none), then moved to
    `device`: the backbone as `init_swin_ave`'s; every head linear (the
    attentions' packed in_proj among them) trunc_normal(0.02) with zero
    biases; `word2vec` trunc_normal(0.02); the LSTM's weights and biases
    uniform(+-1/sqrt(H)); unit LayerNorms."""
    device = resolve_device(device)
    g = generator if generator is not None else torch.Generator().manual_seed(0)
    model = AVQAModel(cfg, hcfg)
    init_swin_(model.backbone, g)
    hp = model.avqatask
    with torch.no_grad():
        for m in _head_linears(hp):
            nn.init.trunc_normal_(m.weight, std=0.02, a=-0.04, b=0.04, generator=g)
        qe = hp.question_encoder
        nn.init.trunc_normal_(qe.word2vec, std=0.02, a=-0.04, b=0.04, generator=g)
        bound = 1.0 / math.sqrt(hcfg.qst_hidden)
        for p in qe.lstm.parameters():
            p.uniform_(-bound, bound, generator=g)
    return model.to(device)


def random_avqa(cfg: SwinConfig, hcfg: AVQAHeadConfig, seed: int, int8: bool = False
                ) -> AVQAModel:
    """An AVQAModel on the CPU with every leaf drawn from one seeded
    generator, for smoke runs and measurements: the backbone as
    `random_swin_ave`'s (live adapters, gates and bias tables); in the head,
    every linear's weight and bias uniform(+-1/sqrt(fan_in)) (torch's
    default), `word2vec` N(0, 1), the LSTM uniform(+-1/sqrt(H)) (torch's
    default), LayerNorm weights 1 + N(0, 0.1) and biases N(0, 0.02). At
    these scales the head is live: tanh(fc_fusion(...) * qst_feature), the
    input of fc_ans, stays off its +-1 plateau for nearly every entry, so
    the answer logits follow the tower (tests/test_torch_port_avqa_slice.py).
    With `int8`, the same model with its tower quantized
    (`quantize_swin_tower`)."""
    g = torch.Generator().manual_seed(seed)
    model = AVQAModel(cfg, hcfg)
    random_swin_(model.backbone, g)
    hp = model.avqatask
    with torch.no_grad():
        for m in _head_linears(hp):
            bound = 1.0 / math.sqrt(m.weight.shape[1])
            m.weight.uniform_(-bound, bound, generator=g)
            m.bias.uniform_(-bound, bound, generator=g)
        for m in (hp.norm1, hp.norm2):
            m.weight.normal_(1.0, 0.1, generator=g)
            m.bias.normal_(0.0, 0.02, generator=g)
        qe = hp.question_encoder
        qe.word2vec.normal_(0.0, 1.0, generator=g)
        bound = 1.0 / math.sqrt(hcfg.qst_hidden)
        for p in qe.lstm.parameters():
            p.uniform_(-bound, bound, generator=g)
    if int8:
        model.backbone = quantize_swin_tower(model.backbone)
    return model
