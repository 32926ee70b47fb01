"""K14's and K9's redesign for Hopper on the CPU: K14 (the transpose-free
temporal stage, `STGCMA_TV2=1`) on csrc/tattn.cu's temporal product T over
frame-strided tiles and csrc/rowadapt.cu's row-owning product R with K14's
own rounding of the residual, and K9 (LayerNorm) on csrc/rowprep.cu's
`ln_rows_kernel`, each row read once in 16-byte chunks.

- (a) A CPU model of T's frame-strided tile walk: a tile is ntok tokens by
  the T frames of one clip of the tower's (B T, N, C) layout (ntok =
  ceil(N / ceil(N / floor(128 / T))), tokens past N zero-filled, the rows of
  the 128-row tile past ntok T zeros), loaded frame-major (row t ntok + j,
  the 3-D TMA box), one head's q, k and v slabs read at their row offsets of
  W_qkv, each accumulator row staged at row j T + t (sequence-major), then
  K13's bands: 16 query rows over the keys of their own sequence within the
  48 rows from 16 before the band, masked past the tile's whole sequences;
  staged row r written to row (b T + r % T) N + n0 + r / T. In fp32 it
  equals `_heads_attention` over the permuted view (what `tv2_plain` does)
  to 1e-6 of max |plain| (only the order of fp32 sums differs), for T in {1,
  4, 10, 16}, N in {49, 197, 257} and head widths 32 and 64; every output
  row is written exactly once. The same walk without the permutation (K13's
  bands over the frame-major rows) is seen by the same comparison.
- (b) Under the recorder of tests/test_torch_port_hopper_limits.py (CUDA
  launches recorded, not made), K14 at CLIP-B/16 and CLIP-L/14 widths makes
  exactly 3 launches float (LN, `stg_tattn_bf16` with the frame stride N,
  `stg_rowadapt_bf16` with erf-GELU rounded once and the RESF up epilogue)
  and 4 int8 (the fp32 LN rows quantized, T, the merged heads quantized, R),
  each T and R launch after its check passed; a (heads, T, T) bias, no
  adapter (proj on gemm.cu) or an adapter width R does not take keeps the
  earlier composition; T = 20 is refused
  (the JAX kernel pads T to 16), with nothing launched. R's up epilogues
  and T's frame-strided tile are read from the sources (regex).
- (c) A CPU model of the new LayerNorm kernel's chunk and lane order (the
  lanes a row as its dispatch picks them, a lane's chunks summed in order,
  then a butterfly over the row's lanes, each lane with its own statistics)
  equals `layernorm_plain` to 1e-6 in fp32 at every width the presets use,
  and `ln_route` takes all of them; the dispatch and its limits are read
  from csrc/rowprep.cu.
- (d) K9's card wrapper raises on each bad input as before (device, dtype,
  shape, contiguity, alignment) and on a width off its route, launching
  nothing, and makes one `stg_ln_bf16` launch for good inputs.

No numbers of the card are compared here: the plain versions' parity with
the JAX kernels is held by tests/test_torch_port_tv2.py and
tests/test_torch_port_swin_kernels.py, the kernels against them on the card
by chip_smoke.py.
"""
import re
from pathlib import Path

import numpy as np
import pytest
import torch

import torch_port_helpers  # noqa: F401  (torch at two threads a worker)
from stgcma_tpu_torch.configs import clip_b16, clip_l14, swin_base, swin_large
from stgcma_tpu_torch.ops import clip_block as PCB
from stgcma_tpu_torch.ops import cuda_lib
from stgcma_tpu_torch.ops import fused_attn as FA
from stgcma_tpu_torch.ops import quant as Q
from stgcma_tpu_torch.ops import swin_block as SB

from test_torch_port_hopper_limits import _Recorder, _empty, _tadapt_w

CSRC = Path(FA.__file__).resolve().parent.parent / "csrc"


# ---------------------------------------------------------------------------
# (a) T's frame-strided tile walk
# ---------------------------------------------------------------------------

def tile_tokens(N, T):
    """(tiles a clip, tokens a tile) of csrc/tattn.cu's frame-strided walk."""
    tpc = -(-N // (FA.TATTN_TILE_ROWS // T))
    return tpc, -(-N // tpc)


def tattn_v2_model(a, w_qkv, b_qkv, T, N, heads, permute=True):
    """csrc/tattn.cu's frame-strided walk in fp32 torch. Returns the merged
    heads (M, C); rows it never writes stay NaN."""
    M, C = a.shape
    B, dh, BM = M // (T * N), C // heads, FA.TATTN_TILE_ROWS
    tpc, ntok = tile_tokens(N, T)
    span = ntok * T
    scale = dh ** -0.5
    a4 = a.view(B, T, N, C)
    out = torch.full((M, C), float("nan"))
    ra = torch.arange(BM)
    # staged row of accumulator row r: t ntok + j -> j T + t
    perm = torch.where(ra < span, (ra % ntok) * T + ra // ntok, ra) if permute else ra
    for b in range(B):
        for ti in range(tpc):
            n0 = ti * ntok
            nv = min(ntok, N - n0)
            valid = nv * T
            box = a.new_zeros(T, ntok, C)           # the 3-D box: tokens past N zero-filled
            box[:, :nv] = a4[b, :, n0:n0 + nv]
            rows = a.new_zeros(BM, C)               # rows no box reaches: zeros
            rows[:span] = box.reshape(span, C)      # frame-major: row t ntok + j
            for h in range(heads):
                q, k, v = (rows @ w_qkv[j * C + h * dh:j * C + (h + 1) * dh].t()
                           + b_qkv[j * C + h * dh:j * C + (h + 1) * dh] for j in range(3))
                staged = [torch.empty_like(t) for t in (q, k, v)]
                for st, t in zip(staged, (q * scale, k, v)):
                    st[perm] = t
                q, k, v = staged
                for band in range(0, BM, 16):
                    if band >= valid:
                        continue
                    keys = torch.arange(band - 16, band + 32)
                    r = torch.arange(band, band + 16)
                    lo = (r // T) * T
                    hi = torch.clamp(lo + T, max=valid)
                    mask = ((keys >= 0) & (keys < valid) & (keys[None] >= lo[:, None])
                            & (keys[None] < hi[:, None]))
                    kk = keys.clamp(0, BM - 1)
                    logits = (q[band:band + 16] @ k[kk].t()).masked_fill(~mask, float("-inf"))
                    e = torch.exp(logits - logits.amax(-1, keepdim=True))
                    o = (e / e.sum(-1, keepdim=True)) @ v[kk]
                    for i in range(min(16, valid - band)):
                        rr = band + i
                        g = (b * T + rr % T) * N + n0 + rr // T
                        assert torch.isnan(out[g, h * dh]), "a row written twice"
                        out[g, h * dh:(h + 1) * dh] = o[i]
    return out


def tv2_attention(a, w_qkv, b_qkv, T, N, heads):
    """`tv2_plain`'s attention in fp32: the qkv of the rows, permuted to each
    token's T frames, `_heads_attention`, permuted back."""
    M, C = a.shape
    B = M // (T * N)
    qkv = (a @ w_qkv.t() + b_qkv).view(B, T, N, 3 * C).transpose(1, 2).reshape(B * N, T, 3 * C)
    o = FA._heads_attention(qkv, heads, None, torch.float32)
    return o.view(B, N, T, C).transpose(1, 2).reshape(M, C)


def _tv2_inputs(seed, T, N, C, B=2):
    rng = np.random.RandomState(seed)
    a = torch.from_numpy(rng.randn(B * T * N, C).astype(np.float32))
    w = torch.from_numpy((rng.randn(3 * C, C) / C ** 0.5).astype(np.float32))
    b = torch.from_numpy((rng.randn(3 * C) * 0.1).astype(np.float32))
    return a, w, b


@pytest.mark.parametrize("dh", (32, 64))
@pytest.mark.parametrize("N", (49, 197, 257))
@pytest.mark.parametrize("T", (1, 4, 10, 16))
def test_frame_strided_walk_equals_the_plain_attention(T, N, dh):
    heads = 2
    a, w, b = _tv2_inputs(T * 1000 + N + dh, T, N, heads * dh)
    got = tattn_v2_model(a, w, b, T, N, heads)
    assert not torch.isnan(got).any(), "a row of the merged heads was never written"
    ref = tv2_attention(a, w, b, T, N, heads)
    err = (got - ref).abs().max() / ref.abs().max()
    assert err <= 1e-6, float(err)


@pytest.mark.parametrize("T,N", ((10, 197), (4, 49)))
def test_frame_strided_walk_without_the_permutation_is_seen(T, N):
    """K13's bands over the frame-major rows of the box (each 'sequence' T
    tokens of one frame) move the output far past the bar."""
    heads = 2
    a, w, b = _tv2_inputs(11, T, N, 64)
    ref = tv2_attention(a, w, b, T, N, heads)
    got = tattn_v2_model(a, w, b, T, N, heads, permute=False)
    assert (got - ref).abs().max() > 0.1 * ref.abs().max()


def test_tile_tokens_mirror_tattn_cu():
    """The walk's tiles are tattn.cu's: tiles of a clip and tokens a tile as
    its launcher forms them, the 3-D box at (k, tokens, frames), the staged
    row map; the B/16 and L/14 rows give 12 tokens (120 rows) at N = 197 and
    257 and 10 at N = 49."""
    text = (CSRC / "tattn.cu").read_text()
    assert "const int tpc = ceil_div(N, TATTN_BM / T);" in text
    assert "const int ntok = ceil_div(N, tpc);" in text
    assert "err = tensor_map_3d<Op>(&tm_a, A, M / N, N, C, T, ntok);" in text
    assert ("tma_load_3d(st, &tm_a, kt * BK, (bi % tpc) * ntok, (bi / tpc) * T, &full[s]);"
            in text)
    assert "FS && r < span ? (r % ntok) * T + r / ntok : r" in text
    assert "static_cast<size_t>(b * T + r % T) * N + n0 + r / T" in text
    assert "(N > 0 && (T > TATTN_MAX_FRAMES || M % (T * N)))" in text
    assert tile_tokens(197, 10) == (17, 12) and tile_tokens(257, 10) == (22, 12)
    assert tile_tokens(49, 10) == (5, 10)
    for T in range(1, FA.TATTN_MAX_FRAMES + 1):
        for N in (1, 49, 196, 197, 257, 1000):
            tpc, ntok = tile_tokens(N, T)
            assert ntok * T <= FA.TATTN_TILE_ROWS and ntok <= 256 and (tpc - 1) * ntok < N


# ---------------------------------------------------------------------------
# (b) the K14 compositions, launches recorded
# ---------------------------------------------------------------------------

@pytest.fixture
def recorder(monkeypatch):
    rec = _Recorder()
    monkeypatch.setattr(cuda_lib, "lib", rec)
    for mod in (FA, PCB, SB, Q):
        monkeypatch.setattr(mod, "_stream", lambda x: 0)
    rec.checked = []
    for name in ("check_tattn", "check_rowadapt"):
        real = getattr(FA, name)

        def checked(*args, _real=real, _name=name, **kw):
            _real(*args, **kw)
            rec.checked.append(_name)
        monkeypatch.setattr(FA, name, checked)
    return rec


LAUNCHES = {False: ["stg_ln_bf16", "stg_tattn_bf16", "stg_rowadapt_bf16"],
            True: ["stg_quant_rows", "stg_tattn_s8", "stg_quant_rows", "stg_rowadapt_s8"]}
PRESETS = {"clip_b16": clip_b16, "clip_l14": clip_l14}


@pytest.mark.parametrize("int8", (False, True))
@pytest.mark.parametrize("site", ("video", "audio"))
@pytest.mark.parametrize("preset", sorted(PRESETS))
def test_k14_makes_the_redesigned_launches(recorder, preset, site, int8):
    cfg = PRESETS[preset](ftmode="fusion", label_dim=29)
    C, heads, T = cfg.embed_dim, cfg.heads, cfg.num_frames
    D = int(C * cfg.adapter_ratio)
    N = cfg.num_patches + 1 if site == "video" else cfg.num_patches_audio + 1
    assert FA.tattn_route(T, C // heads) and FA.rowadapt_route(C, D)
    PCB._tv2_cuda(_empty(T, N, C), _tadapt_w(C, D, int8), heads, T, quantized=int8)
    names = [fn for fn, _ in recorder.calls]
    assert names == LAUNCHES[int8], names
    assert recorder.checked == ["check_tattn", "check_rowadapt"]
    for fn, args in recorder.calls:
        if fn.startswith("stg_tattn"):
            M, Cl, Tl, h, tokens = args[4:9] if fn.endswith("bf16") else args[6:11]
            assert (M, Cl, Tl, h, tokens) == (T * N, C, T, heads, N)
        if fn.startswith("stg_rowadapt"):
            tail = args[3:] if fn.endswith("bf16") else args[5:]
            o, h, w2 = tail[0], tail[3], tail[4]
            M, Nl, K, Dl, down, up = tail[8:14]
            assert (M, Nl, K, Dl) == (T * N, C, C, D) and o is None and h is None
            assert w2 is not None and (down, up) == (FA._EPI_BF16_GELU, FA._EPI_BF16_RESF)
    if int8:        # the bf16 rows' LN, quantized unrounded; then the merged heads alone
        first, third = recorder.calls[0][1], recorder.calls[2][1]
        assert first[1] == 0 and first[2] is not None and third[2] is None


OFF_ROUTE = {
    # a (heads, T, T) bias: LN, qkv, the core reading each token's frames N rows apart, proj
    "bias_no_adapter": (lambda: PCB._tv2_cuda(
        _empty(10, 196, 512), _tadapt_w(512, 64, False, adapter=False), 16, 10,
        bias=_empty(16, 10, 10, dtype=torch.float32)),
        ["stg_ln_bf16", "stg_gemm_bf16", "stg_attn_core_t", "stg_gemm_bf16"]),
    "bias_adapter": (lambda: PCB._tv2_cuda(
        _empty(10, 197, 768), _tadapt_w(768, 48, False), 12, 10,
        bias=_empty(12, 10, 10, dtype=torch.float32)),
        ["stg_ln_bf16", "stg_gemm_bf16", "stg_attn_core_t", "stg_gemm_bf16", "stg_gemm_bf16",
         "stg_gemm_bf16_res"]),
    "bias_adapter_int8": (lambda: PCB._tv2_cuda(
        _empty(10, 49, 768), _tadapt_w(768, 48, True), 12, 10,
        bias=_empty(12, 10, 10, dtype=torch.float32), quantized=True),
        ["stg_quant_rows", "stg_gemm_s8", "stg_attn_core_t", "stg_quant_rows", "stg_gemm_s8",
         "stg_gemm_bf16", "stg_gemm_bf16_res"]),
    # no adapter (the attention output alone; no serving path): proj on gemm.cu
    "no_adapter": (lambda: PCB._tv2_cuda(
        _empty(10, 197, 768), _tadapt_w(768, 48, False, adapter=False), 12, 10),
        ["stg_ln_bf16", "stg_gemm_bf16", "stg_attn_core_t", "stg_gemm_bf16"]),
    "no_adapter_int8": (lambda: PCB._tv2_cuda(
        _empty(10, 197, 768), _tadapt_w(768, 48, True, adapter=False), 12, 10, quantized=True),
        ["stg_quant_rows", "stg_gemm_s8", "stg_attn_core_t", "stg_quant_rows", "stg_gemm_s8"]),
    # adapter width 40: not one R instantiates
    "adapter_D40": (lambda: PCB._tv2_cuda(_empty(10, 49, 128), _tadapt_w(128, 40, False), 2, 10),
                    ["stg_ln_bf16", "stg_gemm_bf16", "stg_attn_core_t", "stg_gemm_bf16",
                     "stg_gemm_bf16", "stg_gemm_bf16_res"]),
}


@pytest.mark.parametrize("case", sorted(OFF_ROUTE))
def test_k14_off_the_route_keeps_the_earlier_composition(recorder, case):
    compose, want = OFF_ROUTE[case]
    compose()
    assert [fn for fn, _ in recorder.calls] == want
    assert not recorder.checked
    res = [args for fn, args in recorder.calls if fn == "stg_gemm_bf16_res"]
    assert all(args[8] == FA._EPI_BF16_RESF for args in res)     # K14's own rounding


def test_k14_refuses_twenty_frames(recorder):
    """The JAX kernel pads T to 16 (`_tv2_pallas` :1851), so K14 takes at most
    16 frames on either route; K13 at T = 20 keeps its composition
    (tests/test_torch_port_tadapt_hopper.py)."""
    with pytest.raises(ValueError):
        PCB._tv2_cuda(_empty(20, 197, 768), _tadapt_w(768, 48, False), 12, 20)
    assert not recorder.calls


def test_the_frame_strided_product_refuses_what_it_cannot_take(recorder):
    """`check_tattn` with a frame stride: rows not a multiple of T times the
    tokens a frame; a weight on another device; nothing is launched."""
    w, b = _empty(384, 128), _empty(384)
    with pytest.raises(ValueError):
        FA._tattn(_empty(10 * 49 + 10, 128), None, w, None, b, _empty(500, 128), 10, 2, 0,
                  tokens=49)
    with pytest.raises(ValueError):
        FA._tattn(_empty(490, 128), None, torch.empty(384, 128, dtype=torch.bfloat16,
                                                      device="meta"), None, b,
                  _empty(490, 128), 10, 2, 0, tokens=49)
    FA.check_tattn(_empty(490, 128), None, w, None, b, _empty(490, 128), 10, 2, tokens=49)
    assert not recorder.calls


def test_row_adapt_up_epilogues_mirror_rowadapt_cu():
    """R's up epilogues are gemm.cu's numbers, K13's RES1 and K14's RESF, and
    its check refuses any other; the y block is staged in bf16 for RES1,
    which rounds it, and in fp32 for RESF."""
    text = (CSRC / "rowadapt.cu").read_text()
    up = re.search(r"enum UpEpi \{ UP_RES1 = (\d+), UP_RESF = (\d+) \};", text)
    assert (int(up.group(1)), int(up.group(2))) == (FA._EPI_BF16_RES1, FA._EPI_BF16_RESF)
    gemm = (CSRC / "gemm.cu").read_text()
    assert f"EPI_BF16_RES1 = {FA._EPI_BF16_RES1}," in gemm
    assert f"EPI_BF16_RESF = {FA._EPI_BF16_RESF}" in gemm
    assert "const bool round_u = p.up_epi == UP_RES1;             // warp-uniform" in text
    assert "pack_bf16x2(v0, v1);" in text and "make_float2(v0, v1);" in text
    assert "(p.up_epi != UP_RES1 && p.up_epi != UP_RESF)" in text
    a, w, bias, wd, bd = _empty(64, 128), _empty(128, 128), _empty(128), _empty(48, 128), _empty(48)
    up = (_empty(128, 48), _empty(128), _empty(64, 128), _empty(64, 128))
    for epi in (FA._EPI_BF16_RES1, FA._EPI_BF16_RESF):
        FA.check_rowadapt(a, None, w, None, bias, wd, bd, up=up, up_epi=epi)
    with pytest.raises(ValueError):             # gemm.cu's EPI_BF16_RES2: not an up epilogue
        FA.check_rowadapt(a, None, w, None, bias, wd, bd, up=up, up_epi=6)


# ---------------------------------------------------------------------------
# (c) the LayerNorm kernel's chunk and lane order
# ---------------------------------------------------------------------------

def ln_lanes(K):
    """(lanes a row, chunks a lane) of csrc/rowprep.cu's `ln_rows` dispatch."""
    n16 = K // 8
    if n16 % 32 == 0:
        return 32, n16 // 32
    if n16 % 16 == 0:
        return 16, n16 // 16
    if n16 <= 8 * 16:
        return 8, -(-n16 // 8)
    return 32, -(-n16 // 32)


def _butterfly(v, lanes):
    """Each lane's sum over its row's lanes, as the xor shuffles form it."""
    idx = np.arange(lanes)
    o = lanes // 2
    while o:
        v = (v + v[:, idx ^ o]).astype(np.float32)
        o //= 2
    return v


def ln_model(x, g, b, eps=FA._LN_EPS):
    """`ln_rows_kernel` in fp32 numpy: chunk i = c lanes + sub of lane sub,
    a lane's chunks summed in order, the butterfly, the centred variance of
    the chunks inside the row, y = ((x - mean) rstd) g + b, each lane with
    its own statistics."""
    M, K = x.shape
    lanes, ch = ln_lanes(K)
    f32 = np.float32
    xf = np.zeros((M, ch * lanes * 8), f32)
    xf[:, :K] = x
    chunks = xf.reshape(M, ch, lanes, 8)
    inside = (np.arange(ch)[:, None] * lanes + np.arange(lanes)[None]) < K // 8   # (ch, lanes)
    s = np.zeros((M, lanes), f32)
    for c in range(ch):
        for e in range(8):
            s = (s + chunks[:, c, :, e]).astype(f32)
    mean = (_butterfly(s, lanes) / f32(K)).astype(f32)
    v = np.zeros((M, lanes), f32)
    for c in range(ch):
        for e in range(8):
            d = (chunks[:, c, :, e] - mean).astype(f32)
            v = np.where(inside[c], (v + (d * d).astype(f32)).astype(f32), v)
    rstd = (f32(1) / np.sqrt((_butterfly(v, lanes) / f32(K) + f32(eps)).astype(f32))).astype(f32)
    gp = np.zeros(ch * lanes * 8, f32)
    bp = np.zeros(ch * lanes * 8, f32)
    gp[:K], bp[:K] = g, b
    gc, bc = gp.reshape(ch, lanes, 8), bp.reshape(ch, lanes, 8)
    y = ((((chunks - mean[:, None, :, None]).astype(f32) * rstd[:, None, :, None]).astype(f32)
          * gc[None]).astype(f32) + bc[None]).astype(f32)
    return y.reshape(M, -1)[:, :K]


def preset_ln_widths():
    """Every LayerNorm width of the presets: Swin's patch embed, stage and
    merge norms, CLIP's pre/post and block norms."""
    widths = set()
    for preset in (swin_base, swin_large):
        cfg = preset(ftmode="fusion")
        widths.add(cfg.embed_dim)
        for s in range(cfg.num_layers):
            widths.add(cfg.stage_dim(s))
            if s < cfg.num_layers - 1:
                widths.add(4 * cfg.stage_dim(s))
    for preset in (clip_b16, clip_l14):
        widths.add(preset(ftmode="fusion").embed_dim)
    return sorted(widths)


@pytest.mark.parametrize("K", preset_ln_widths())
def test_ln_lane_order_equals_the_plain_layernorm(K):
    rng = np.random.RandomState(K)
    x = (rng.randn(6, K) * 2 + 0.5).astype(np.float32)
    g = (1 + rng.randn(K) * 0.1).astype(np.float32)
    b = (rng.randn(K) * 0.02).astype(np.float32)
    ref = FA.layernorm_plain(torch.from_numpy(x), torch.from_numpy(g), torch.from_numpy(b))
    got = torch.from_numpy(ln_model(x, g, b))
    assert FA.ln_route(K)
    lanes, ch = ln_lanes(K)
    assert ch <= 16 and (lanes * ch * 8 == K or lanes == 8)      # no idle lane but at odd widths
    err = (got - ref).abs().max() / ref.abs().max()
    assert err <= 1e-6, float(err)


def test_ln_widths_cover_the_presets_and_mirror_rowprep_cu():
    widths = preset_ln_widths()
    assert {128, 192, 768, 1024, 2048, 3072} <= set(widths)
    assert all(FA.ln_route(K) for K in widths)
    assert not FA.ln_route(12) and not FA.ln_route(FA.LN_MAX_WIDTH + 8)
    text = (CSRC / "rowprep.cu").read_text()
    assert re.search(r"constexpr int kLnMaxChunks = (\d+);", text).group(1) == "16"
    assert FA.LN_MAX_WIDTH == 32 * 16 * 8 and FA.LN_ALIGN == 8
    for line in ("if (n16 % 32 == 0) return launch_ln_ch<32>(n16 / 32,",
                 "if (n16 % 16 == 0) return launch_ln_ch<16>(n16 / 16,",
                 "if (n16 <= 8 * kLnMaxChunks)",
                 "return launch_ln_ch<8>(ceil_div(n16, 8),",
                 "return launch_ln_ch<32>(ceil_div(n16, 32),",
                 "held[c] = live && i < n16 ? __ldg(xr + i) : make_uint4(0, 0, 0, 0);",
                 "load_params<8>(g + i * 8, gf);", "yr[i] = out;"):
        assert line in text, line
    assert "ln_bf16_kernel" not in text          # one LayerNorm kernel: the one read
    assert [ln_lanes(K) for K in (128, 192, 256, 512, 768, 3072)] == [
        (16, 1), (8, 3), (32, 1), (32, 2), (32, 3), (32, 12)]


# ---------------------------------------------------------------------------
# (d) K9's card wrapper: checks in one pass, one launch
# ---------------------------------------------------------------------------

def _ln_args(M=64, K=256):
    return _empty(M, K), _empty(K), _empty(K)


def _misaligned(M, K):
    return torch.empty(M * K + 1, dtype=torch.bfloat16)[1:].view(M, K)


BAD_LN = {
    "x_float32": lambda: (_empty(64, 256, dtype=torch.float32), _empty(256), _empty(256)),
    "ln_w_float32": lambda: (_empty(64, 256), _empty(256, dtype=torch.float32), _empty(256)),
    "ln_b_shape": lambda: (_empty(64, 256), _empty(256), _empty(264)),
    "ln_w_other_device": lambda: (_empty(64, 256), torch.empty(256, dtype=torch.bfloat16,
                                                                device="meta"), _empty(256)),
    "ln_b_strided": lambda: (_empty(64, 256), _empty(256), _empty(512)[::2]),
    "x_misaligned": lambda: (_misaligned(64, 256), _empty(256), _empty(256)),
    "x_3d": lambda: (_empty(4, 16, 256), _empty(256), _empty(256)),
    "width_off_route": lambda: (_empty(64, 12), _empty(12), _empty(12)),
    "width_past_route": lambda: (_empty(4, FA.LN_MAX_WIDTH + 8), _empty(FA.LN_MAX_WIDTH + 8),
                                 _empty(FA.LN_MAX_WIDTH + 8)),
}


@pytest.mark.parametrize("case", sorted(BAD_LN))
def test_k9_wrapper_raises_on_each_bad_input(recorder, case):
    with pytest.raises(ValueError):
        FA._layernorm_cuda(*BAD_LN[case]())
    assert not recorder.calls


def test_k9_wrapper_makes_one_launch(recorder):
    x, w, b = _ln_args(3920, 2048)
    y = FA._layernorm_cuda(x, w, b)
    (fn, args), = recorder.calls
    assert fn == "stg_ln_bf16" and args[4:6] == (3920, 2048) and args[6] == FA._LN_EPS
    assert args[3] == y.data_ptr() and y.shape == x.shape and y.dtype == x.dtype
    with pytest.raises(ValueError):             # the wrapper itself: x must be contiguous
        FA.layernorm(_empty(64, 512)[:, :256], w[:256], b[:256])
