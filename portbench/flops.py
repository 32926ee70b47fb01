"""Operations and bytes of each configuration's forward and training step,
counted from its shapes, whatever implements them.

A product (M, N, K) is 2 M N K operations and reads its two bf16 operands
and writes its bf16 output once; an attention core over R rows of n query
and m key tokens is its two products, and reads q, k, v and writes o once;
STG-CMA's exchange of (R, Nv, D) and (R, Na, D) hiddens is its three
products (the logits, then one gather each way), and reads and writes both
hiddens once. A training step adds, for each product, the gradient of each
operand that needs one: of its input where anything below it is trained,
of its weight where that weight is trained; recomputation is not counted.
The patch convolutions take no gradient (the raw inputs and the frozen
convolutions need none).

`roofline_s` is the least time the card could spend on these products and
cores: the sum over them of the larger of operations / PEAK_FLOPS and
bytes / PEAK_BYTES (NVIDIA H100 SXM, dense bf16, 700 W).
"""
from __future__ import annotations

PEAK_FLOPS = 989e12        # bf16 dense, tensor cores
PEAK_BYTES = 3.35e12       # HBM3


class Count:
    def __init__(self, train: bool):
        self.train = train
        self.fwd = 0
        self.bwd = 0
        self.roofline_s = 0.0

    def _add(self, flops, nbytes, grads):
        self.fwd += flops
        self.bwd += grads
        self.roofline_s += max(flops / PEAK_FLOPS, nbytes / PEAK_BYTES)

    def mm(self, M, N, K, grad_in=True, grad_w=False):
        f = 2 * M * N * K
        g = f * ((grad_in and self.train) + (grad_w and self.train))
        self._add(f, 2 * (M * K + N * K + M * N), g)

    def conv(self, M, N, K):
        self.mm(M, N, K, grad_in=False, grad_w=False)

    def attn(self, R, heads, n, m, dh, grad_qk=True, grad_p=True, grad_v=True):
        """Softmax attention: logits q.k^T and p.v in `heads` heads."""
        f = 2 * R * heads * n * m * dh
        g = f * (2 * grad_qk + grad_p + grad_v) if self.train else 0
        self._add(2 * f, 2 * R * heads * dh * (2 * n + 2 * m), g)

    def fuse(self, R, nv, na, D):
        """STG-CMA's gated exchange: logits, then a2v and v2a."""
        f = 2 * R * nv * na * D
        self._add(3 * f, 2 * 2 * R * D * (nv + na), 6 * f if self.train else 0)

    @property
    def step_flops(self):
        return self.fwd + self.bwd


# ---------------------------------------------------------------------------
# AVE-29, CLIP ViT fusion
# ---------------------------------------------------------------------------

def clip_ave(cfg: dict, B: int, train: bool = False) -> Count:
    c = Count(train)
    T, C, h, p = cfg["num_frames"], cfg["embed_dim"], cfg["heads"], cfg["patch_size"]
    D = int(C * cfg["adapter_ratio"])
    BT = B * T
    gv = (cfg["input_resolution"] // p) ** 2
    ga = (((cfg["audio_tdim"] - p) // p + 1) * ((cfg["audio_fdim"] - p) // p + 1))
    c.conv(BT * gv, C, 3 * p * p)
    c.conv(BT * ga, C, p * p)
    streams = (1 + gv, 1 + ga)
    for _ in range(cfg["layers"]):
        for N in streams:
            M = BT * N
            c.mm(M, 3 * C, C)                              # temporal site
            c.attn(B * N, h, T, T, C // h)
            c.mm(M, C, C)
            c.mm(M, D, C, grad_w=True)                     # T_Adapter
            c.mm(M, C, D, grad_w=True)
            c.mm(M, 3 * C, C)                              # spatial site
            c.attn(BT, h, N, N, C // h)
            c.mm(M, C, C)
            c.mm(M, 4 * C, C)                              # MLP
            c.mm(M, C, 4 * C)
            for _ in range(2):                             # S_ and MLP_Adapter
                c.mm(M, D, C, grad_w=True)
                c.mm(M, C, D, grad_w=True)
        c.fuse(BT, streams[0], streams[1], D)
        c.fuse(BT, streams[0], streams[1], D)
    c.mm(BT, 512, 2 * C, grad_w=True)                      # the head
    c.mm(BT, cfg["label_dim"], 512, grad_w=True)
    return c


# ---------------------------------------------------------------------------
# MUSIC-AVQA, Swin fusion with the negative stream
# ---------------------------------------------------------------------------

def _swin_stream_block(c, M, R_win, n, C, h, T, D, t_attn, first):
    """One block of one adapted stream. `first`: this block's input needs
    no gradient (the block right after the patch embed), so its temporal
    site trains only the bias table and the adapter."""
    if t_attn:
        c.mm(M, 3 * C, C, grad_in=not first)
        c.attn(M // T, h, T, T, C // h, grad_qk=not first, grad_p=True, grad_v=not first)
        c.mm(M, C, C)
        c.mm(M, D, C, grad_w=True)
        c.mm(M, C, D, grad_w=True)
    c.mm(M, 3 * C, C)
    c.attn(R_win, h, n, n, C // h)
    c.mm(M, C, C)
    c.mm(M, D, C, grad_w=True)                             # S_Adapter2
    c.mm(M, C, D, grad_w=True)
    c.mm(M, 4 * C, C)
    c.mm(M, C, 4 * C)
    c.mm(M, D, C, grad_w=True)                             # S_Adapter
    c.mm(M, C, D, grad_w=True)


def _swin_nega_block(c, M, R_win, n, C, h):
    c.mm(M, 3 * C, C, grad_in=False)
    c.attn(R_win, h, n, n, C // h, grad_qk=False, grad_p=False, grad_v=False)
    c.mm(M, C, C, grad_in=False)
    c.mm(M, 4 * C, C, grad_in=False)
    c.mm(M, C, 4 * C, grad_in=False)


def _head_mm(c, rows, n_out, n_in):
    c.mm(rows, n_out, n_in, grad_w=True)


def swin_avqa(cfg: dict, hcfg: dict, B: int, train: bool = False) -> Count:
    """Serving (train False): the two adapted streams and the QA head.
    Training: also the negative stream and the two match MLPs."""
    c = Count(train)
    T, C0 = cfg["num_frames"], cfg["embed_dim"]
    BT = B * T
    H0 = cfg["img_size"] // cfg["patch_size"][1]
    k = cfg["patch_size"][1] * cfg["patch_size"][2]
    c.conv(BT * H0 * H0, C0, 3 * k)
    c.conv(BT * H0 * H0, C0, k)
    if train:
        c.conv(BT * H0 * H0, C0, 3 * k)
    first = True
    for s, depth in enumerate(cfg["depths"]):
        C, h, H = C0 * 2 ** s, cfg["num_heads"][s], H0 // 2 ** s
        ws = min(cfg["window_size"], H)
        D = int(C * cfg["adapter_ratios"][s])
        M, n = BT * H * H, ws * ws
        R_win = M // n
        for i in range(depth):
            for _ in range(2):
                _swin_stream_block(c, M, R_win, n, C, h, T, D, i % 2 == 0, first)
            c.fuse(R_win, n, n, D)
            c.fuse(BT, H * H, H * H, D)
            if train:
                _swin_nega_block(c, M, R_win, n, C, h)
            first = False
        if s < len(cfg["depths"]) - 1:
            Mm = BT * (H // 2) ** 2
            c.mm(Mm, 2 * C, 4 * C)
            c.mm(Mm, 2 * C, 4 * C)
            if train:
                c.mm(Mm, 2 * C, 4 * C, grad_in=False)
    _avqa_head(c, cfg, hcfg, B, T, H0 // 2 ** (len(cfg["depths"]) - 1))
    return c


def _map(c, R, n, C, grad_a, grad_b):
    """One batched product of (R, n, C) with (R, C) -> (R, n) or its
    transpose, the grounding's two steps."""
    f = 2 * R * n * C
    c._add(f, 2 * (R * n * C + R * C + R * n), f * (grad_a + grad_b) if c.train else 0)


def _avqa_head(c, cfg, hcfg, B, T, grid):
    d, Hq, E = hcfg["feat_dim"], hcfg["qst_hidden"], hcfg["qst_word_embed"]
    L = hcfg["question_len"]
    BT, n = B * T, grid * grid
    _head_mm(c, BT, d, d)                                  # fc_a2
    c.mm(B * L, 4 * Hq, E, grad_w=True)                    # the LSTM's input products
    for t in range(L):                                     # its recurrent ones
        c.mm(B, 4 * Hq, Hq, grad_in=t > 0, grad_w=True)
    _head_mm(c, B, d, 2 * Hq)                              # fc
    streams = ((True, True),) + (((False, True),) if c.train else ())
    for grad_v, match in streams:                          # positive, negative
        _map(c, BT, n, d, grad_v, True)
        _map(c, BT, n, d, True, grad_v)
        _head_mm(c, BT, d, 2 * d)                          # fc_gl
        if c.train:
            for n_out, n_in in ((512, 2 * d), (256, 512), (128, 256), (2, 128)):
                _head_mm(c, BT, n_out, n_in)
    heads = hcfg["attn_heads"]
    for _ in range(2):                                     # attn_v, attn_a
        _head_mm(c, B, d, d)                               # q
        _head_mm(c, BT, d, d)                              # k
        _head_mm(c, BT, d, d)                              # v
        c.attn(B, heads, 1, T, d // heads)
        _head_mm(c, B, d, d)                               # out_proj
        _head_mm(c, B, d, d)                               # linear11 / 21
        _head_mm(c, B, d, d)                               # linear12 / 22
    _head_mm(c, B, d, 2 * d)                               # fc_fusion
    _head_mm(c, B, hcfg["answer_dim"], d)                  # fc_ans
