"""The limits of the port's Hopper kernels against what its wrappers and
presets give them, on the CPU: csrc/gemm.cu's bf16 products on TMA + wgmma
(K and N multiples of 8, 16-byte aligned row-major operands,
`check_gemm_operands`) and csrc/attn.cu's three attention kernels (small,
K and V resident in shared memory, streamed; `attn_route` mirrors the
dispatch and says how much shared memory a block takes).

- `check_gemm_operands` refuses each operand TMA cannot take.
- Each card composition that issues a bf16 product (K1, K4, K7, K11-K14,
  float and int8 where both exist), run on CPU tensors at a preset's widths
  with the CUDA launches replaced by a recorder: every slice it hands
  gemm.cu passes `check_gemm_operands` (the launch wrappers call it first),
  and every attention core it launches takes a route whose shared memory
  fits one block (232,448 bytes on the H100).
- The constants `attn_route` mirrors are the ones in csrc/attn.cu.
- Every bf16 product and attention core that `launches_per_forward` counts
  at the four presets, under every switch combination, lies within those
  limits, and no preset reaches the streamed kernel.

No numbers are compared: the plain versions do not change with the kernels,
and their parity with the JAX package is held by the other port test files.
"""
import re
from pathlib import Path

import pytest
import torch

from stgcma_tpu_torch.configs import clip_b16, clip_l14, swin_base, swin_large
from stgcma_tpu_torch.nn import clip_vit, swin
from stgcma_tpu_torch.ops import clip_block as PCB
from stgcma_tpu_torch.ops import cuda_lib
from stgcma_tpu_torch.ops import fused_attn as FA
from stgcma_tpu_torch.ops import swin_block as SB
from stgcma_tpu_torch.ops.swin_block import swin_whole_block_enabled

from torch_port_helpers import clear_opt_ins

BF, I8 = torch.bfloat16, torch.int8
ATTN_CU = Path(FA.__file__).resolve().parent.parent / "csrc" / "attn.cu"
SWITCHES = ("STGCMA_CLIP_TADAPT_FUSED", "STGCMA_CLIP_WHOLE_BLOCK", "STGCMA_QFUSE_ADAPTERS",
            "STGCMA_TV2")


def _empty(*shape, dtype=BF):
    return torch.empty(shape, dtype=dtype)


# ---------------------------------------------------------------------------
# what check_gemm_operands refuses
# ---------------------------------------------------------------------------

def _operands(M=32, N=48, K=64):
    return _empty(M, K), _empty(N, K), _empty(M, N)


def _misaligned(M, N):
    """An (M, N) bf16 view whose base lies 2 bytes past a 16-byte boundary."""
    return _empty(M * N + 8).narrow(0, 1, M * N).view(M, N)


REFUSED = {
    "K_not_a_multiple_of_8": lambda: (_empty(32, 60), _empty(48, 60), _empty(32, 48)),
    "N_not_a_multiple_of_8": lambda: (_empty(32, 64), _empty(44, 64), _empty(32, 44)),
    "a_base_misaligned": lambda: (_misaligned(32, 64), *_operands()[1:]),
    "w_not_contiguous": lambda: (_empty(32, 64), _empty(64, 48).t(), _empty(32, 48)),
    "out_of_another_shape": lambda: (*_operands()[:2], _empty(32, 56)),
    "residual_misaligned": lambda: (*_operands(), _misaligned(32, 48)),
}


@pytest.mark.parametrize("case", sorted(REFUSED))
def test_check_gemm_operands_refuses_what_tma_cannot_take(case):
    a, w, out, *rs = REFUSED[case]()
    with pytest.raises(ValueError):
        FA.check_gemm_operands(a, w, out, *rs)
    FA.check_gemm_operands(*_operands())          # the same call on good operands passes


# ---------------------------------------------------------------------------
# the card compositions, launches recorded instead of made
# ---------------------------------------------------------------------------

class _Recorder:
    """Stands for every loaded CUDA library: each launcher records its
    arguments and reports success."""

    def __init__(self):
        self.calls = []

    def __call__(self, src):
        return self

    def __getattr__(self, name):
        if not name.startswith("stg_"):
            raise AttributeError(name)
        return lambda *args: self.calls.append((name, args)) or 0


@pytest.fixture
def recorder(monkeypatch):
    rec = _Recorder()
    monkeypatch.setattr(cuda_lib, "lib", rec)
    for mod in (FA, PCB, SB):
        monkeypatch.setattr(mod, "_stream", lambda x: 0)
    return rec


def _tower(C, Hd, quantized, n=4):
    """The first n products of TOWER: int8 weights with bf16 scales, or bf16."""
    shapes = [(3 * C, C), (C, C), (Hd, C), (C, Hd)][:n]
    w = {}
    for (wk, sk, bk), shape in zip(SB.TOWER, shapes):
        w[wk] = _empty(*shape, dtype=I8 if quantized else BF)
        w[bk] = _empty(shape[0])
        if quantized:
            w[sk] = _empty(shape[0])
    return w


def _adapter(w, key, C, D):
    w.update({f"{key}_w1": _empty(D, C), f"{key}_b1": _empty(D), f"{key}_w2": _empty(C, D),
              f"{key}_b2": _empty(C)})
    return w


def _block_w(C, D, adapters, quantized):
    w = {k: _empty(C) for k in ("ln1_w", "ln1_b", "ln2_w", "ln2_b")}
    w.update(gate_v=_empty(1), gate_a=_empty(1), **_tower(C, 4 * C, quantized))
    for key in adapters:
        _adapter(w, key, C, D)
    return w


def _tadapt_w(C, D, quantized, adapter=True):
    w = {"ln1_w": _empty(C), "ln1_b": _empty(C), **_tower(C, 4 * C, quantized, n=2)}
    return _adapter(w, "ad", C, D) if adapter else w


def _k1_args(C, quantized):
    if quantized:
        return (_empty(C), _empty(C), _empty(3 * C, C, dtype=I8), _empty(3 * C),
                _empty(3 * C), _empty(C, C, dtype=I8), _empty(C), _empty(C))
    return _empty(C), _empty(C), _empty(3 * C, C), _empty(3 * C), _empty(C, C), _empty(C)


def _ffn_q_args(C):
    return (_empty(C), _empty(C), _empty(4 * C, C, dtype=I8), _empty(4 * C), _empty(4 * C),
            _empty(C, 4 * C, dtype=I8), _empty(C), _empty(C))


def _fuse_mask(H, ss, ws=7):
    """K4's fusion mask of an (H, H) grid of windows of ws^2 tokens (it
    carries the windows that K4's core and masked fusion read)."""
    return SB._geo_tensors(H, H, ws, ss, torch.device("cpu"))[2]


# (kernel, preset, widths): each a call of the card composition at B = 1 (BT = T = 10)
COMPOSITIONS = {
    "K1_clip_b16_spatial": lambda: FA._win_block_cuda(_empty(10, 197, 768), *_k1_args(768, False),
                                                      12),
    "K1_clip_l14_spatial": lambda: FA._win_block_cuda(_empty(10, 257, 1024),
                                                      *_k1_args(1024, False), 16),
    "K11_qd_clip_b16_temporal": lambda: FA._win_block_qad_cuda(
        _empty(197, 10, 768), *_k1_args(768, True), _empty(48, 768), _empty(48), 12,
        emit_o=False),
    "K11_qh_clip_b16_spatial": lambda: FA._win_block_qad_cuda(
        _empty(10, 197, 768), *_k1_args(768, True), _empty(48, 768), _empty(48), 12,
        emit_o=True),
    "K11_ffn_qh_clip_b16": lambda: FA._ffn_qh_cuda(
        _empty(1970, 768), *_ffn_q_args(768), _empty(48, 768), _empty(48), "quick_gelu"),
    "K12_clip_b16": lambda: PCB._clip_block_cuda(
        _empty(10, 197, 768), _empty(10, 49, 768), _block_w(768, 48, ["sv", "sa", "mv", "ma"],
                                                            False), 12),
    "K12_int8_clip_b16": lambda: PCB._clip_block_cuda(
        _empty(10, 197, 768), _empty(10, 49, 768), _block_w(768, 48, ["sv", "sa", "mv", "ma"],
                                                            True), 12, quantized=True),
    "K12_clip_l14": lambda: PCB._clip_block_cuda(
        _empty(10, 257, 1024), _empty(10, 64, 1024),
        _block_w(1024, 64, ["sv", "sa", "mv", "ma"], False), 16),
    "K13_clip_b16": lambda: PCB._tadapt_cuda(_empty(197, 10, 768), _tadapt_w(768, 48, False), 12),
    "K13_int8_clip_b16": lambda: PCB._tadapt_cuda(_empty(49, 10, 768), _tadapt_w(768, 48, True),
                                                  12, quantized=True),
    "K14_clip_b16": lambda: PCB._tv2_cuda(_empty(10, 197, 768), _tadapt_w(768, 48, False), 12,
                                          10),
    "K14_int8_clip_l14": lambda: PCB._tv2_cuda(_empty(10, 257, 1024), _tadapt_w(1024, 64, True),
                                               16, 10, quantized=True),
    "K14_bias_no_adapter": lambda: PCB._tv2_cuda(
        _empty(10, 196, 512), _tadapt_w(512, 64, False, adapter=False), 16, 10,
        bias=_empty(16, 10, 10, dtype=torch.float32)),
    "K4_swin_base_stage2": lambda: SB._swin_block_cuda(
        _empty(10, 196, 512), _empty(10, 196, 512), _block_w(512, 32, [k for k, _ in SB.ADAPTERS],
                                                             False), 16,
        _empty(1, 16, 196, 196, dtype=torch.float32), _fuse_mask(14, 3)),
    "K4_int8_swin_base_stage3": lambda: SB._swin_block_cuda(
        _empty(10, 49, 1024), _empty(10, 49, 1024),
        _block_w(1024, 64, [k for k, _ in SB.ADAPTERS], True), 32,
        _empty(1, 32, 49, 49, dtype=torch.float32), _fuse_mask(7, 0), quantized=True),
    "K4_swin_large_stage2": lambda: SB._swin_block_cuda(
        _empty(10, 196, 768), _empty(10, 196, 768), _block_w(768, 96, [k for k, _ in SB.ADAPTERS],
                                                             False), 24,
        _empty(1, 24, 196, 196, dtype=torch.float32), _fuse_mask(14, 0)),
    "K7_swin_base_stage0": lambda: FA._ffn_cuda(_empty(31360, 128), _empty(128), _empty(128),
                                                _empty(512, 128), _empty(512), _empty(128, 512),
                                                _empty(128)),
}
# (N, dh) of each attention launcher's arguments
CORE_ARGS = {"stg_attn_core": lambda a: (a[5], a[7]), "stg_attn_core_t": lambda a: (a[4], a[7]),
             "stg_attn_qkv": lambda a: (a[7], a[8]), "stg_attn_core_win": lambda a: (a[7], a[9])}
# (M, N, K) of each launcher's arguments that runs a product on the tensor cores (K4's
# adapter pairs: csrc/adapter.cu; the temporal product: csrc/tattn.cu, N = 3C; the
# row-owning product: csrc/rowadapt.cu, whose adapter products are bf16 in either variant)
GEMMS = {"stg_gemm_bf16": lambda a: a[4:7], "stg_gemm_bf16_res": lambda a: a[5:8],
         "stg_gemm_bf16_res2": lambda a: a[6:9], "stg_adapter_hidden_pair": lambda a: a[8:11],
         "stg_adapter_out_pair": lambda a: a[12:15],
         "stg_tattn_bf16": lambda a: (a[4], 3 * a[5], a[5]),
         "stg_tattn_s8": lambda a: (a[6], 3 * a[7], a[7]),
         "stg_rowadapt_bf16": lambda a: a[11:14], "stg_rowadapt_s8": lambda a: a[13:16],
         "stg_ffn_bf16": lambda a: (a[8], 4 * a[9], a[9])}
# (M, C, T, heads) of the temporal product's arguments: its attention over T frames
TATTN_ARGS = {"stg_tattn_bf16": lambda a: a[4:8], "stg_tattn_s8": lambda a: a[6:10]}


@pytest.mark.parametrize("name", sorted(COMPOSITIONS))
def test_card_compositions_give_the_kernels_what_they_take(recorder, name):
    """Every operand the composition hands the bf16 GEMM has passed
    `check_gemm_operands` (it would have raised), with K and N multiples of 8,
    and likewise every temporal and row-owning product its check; every
    attention core fits one block's shared memory, and every temporal
    product's sequences lie on `tattn_route`."""
    COMPOSITIONS[name]()
    gemms = [args for fn, args in recorder.calls if fn in GEMMS]
    assert gemms, "no bf16 product was launched"
    for fn, args in recorder.calls:
        if fn in GEMMS:
            M, N, K = GEMMS[fn](args)
            assert M >= 1 and N % FA.GEMM_ALIGN == 0 and K % FA.GEMM_ALIGN == 0, (fn, M, N, K)
        if fn in CORE_ARGS:
            N, dh = CORE_ARGS[fn](args)
            route, smem = FA.attn_route(N, dh)
            assert smem <= FA.SMEM_MAX_BYTES and route != "streamed", (N, dh, route, smem)
        if fn in TATTN_ARGS:
            M, C, T, heads = TATTN_ARGS[fn](args)
            assert M % T == 0 and FA.tattn_route(T, C // heads), (M, C, T, heads)
    if not name.startswith(("K7", "K11_ffn")):
        assert any(fn in CORE_ARGS or fn in TATTN_ARGS for fn, _ in recorder.calls)


# ---------------------------------------------------------------------------
# attn_route against csrc/attn.cu
# ---------------------------------------------------------------------------

def _cu_constant(text, name):
    return int(re.search(rf"constexpr int {name} = (\d+);", text).group(1))


def test_attn_route_mirrors_attn_cu():
    """The limits `attn_route` mirrors are csrc/attn.cu's own, and its
    shared-memory sums are the kernels' layouts: the small kernel's two
    stages of Q, K and V of up to four pairs, the resident K and V of one pair at row stride
    dh + 8, the streamed kernel's 64-key tiles."""
    text = ATTN_CU.read_text()
    assert _cu_constant(text, "kSmallMaxTokens") == FA.ATTN_SMALL_MAX_TOKENS
    assert _cu_constant(text, "kResidentMaxTokens") == FA.ATTN_RESIDENT_MAX_TOKENS
    assert _cu_constant(text, "kWarps") == 4 and _cu_constant(text, "kStreamKeys") == 64
    assert "static constexpr int LD = DH + 8;" in text
    assert "if (a.N <= kSmallMaxTokens)" in text and "if (a.N <= kResidentMaxTokens)" in text
    assert FA.attn_route(10, 64) == ("small", 2 * 4 * 3 * 16 * 72 * 2)
    assert FA.attn_route(64, 32) == ("small", 2 * 1 * 3 * 64 * 40 * 2)
    assert FA.attn_route(197, 64) == ("resident", 2 * 2 * 208 * 72)
    assert FA.attn_route(257, 64) == ("resident", 2 * 2 * 272 * 72)
    assert FA.attn_route(196, 32) == ("resident", 2 * 2 * 208 * 40)
    assert FA.attn_route(769, 64) == ("streamed", 2 * (64 * 72 + 64 * 72))


@pytest.mark.parametrize("dh", FA.ATTN_HEAD_WIDTHS)
def test_attn_routes_fit_one_block_at_every_token_count(dh):
    routes = [FA.attn_route(n, dh) for n in range(1, 2 * FA.ATTN_RESIDENT_MAX_TOKENS)]
    assert all(smem <= FA.SMEM_MAX_BYTES for _, smem in routes)
    names = [r for r, _ in routes]
    small, resident = FA.ATTN_SMALL_MAX_TOKENS, FA.ATTN_RESIDENT_MAX_TOKENS
    assert names == (["small"] * small + ["resident"] * (resident - small)
                     + ["streamed"] * (len(names) - resident))
    with pytest.raises(ValueError):
        FA.attn_route(FA.ATTN_MAX_TOKENS + 1, dh)


# ---------------------------------------------------------------------------
# every preset's products and cores
# ---------------------------------------------------------------------------

def _clip_work(cfg, quantized):
    """{kernel id: ([(N, K) of its bf16 products], [(tokens, dh) of its cores])}
    of every kernel `launches_per_forward` counts."""
    C, T = cfg.embed_dim, cfg.num_frames
    dh, D = C // cfg.heads, int(C * cfg.adapter_ratio)
    tokens = {"videoonly": [cfg.num_patches + 1], "audioonly": [cfg.num_patches_audio + 1]}.get(
        cfg.ftmode, [cfg.num_patches + 1, cfg.num_patches_audio + 1])
    tower = [] if quantized else [(3 * C, C), (C, C), (4 * C, C), (C, 4 * C)]
    adapters = [(D, C), (C, D)]
    work = {}
    for kid in clip_vit.launches_per_forward(cfg, quantized):
        sites = [(n, dh) for n in [T] + tokens]
        work[kid] = {"K1": (tower[:2], sites), "K2": ([], sites), "K3": ([], []),
                     "K11": ([(D, C)], sites),
                     "K12": (tower + adapters, [(n, dh) for n in tokens]),
                     "K13": (tower[:2] + adapters, [(T, dh)]),
                     "K14": (tower[:2] + adapters, [(T, dh)])}[kid]
    return work


def _swin_work(cfg, quantized):
    counts = swin.launches_per_forward(cfg, B=8, quantized=quantized)
    work = {kid: ([], []) for kid, n in counts.items() if n}
    for stage in swin.backbone_statics(cfg):
        for st in stage:
            C, dh, D = st.dim, st.dim // st.num_heads, int(st.dim * st.adapter_ratio)
            tower = [] if quantized else [(3 * C, C), (C, C), (4 * C, C), (C, 4 * C)]
            attn_id = ("K2" if quantized else "K1") if FA.block_kernel_route(st.num_heads) else "K8"
            if attn_id == "K1":
                work[attn_id][0].extend(tower[:2])
            if st.t_attn:
                work[attn_id][1].append((st.num_frames, dh))
            if st.mode == "fusion_adapt" and swin_whole_block_enabled(st):
                work["K4"][0].extend(tower + [(D, C), (C, D)])
                work["K4"][1].append((st.window_size ** 2, dh))     # its core over each window
                continue
            work[attn_id][1].append((st.window_size ** 2, dh))
            if "K7" in work:
                work["K7"][0].extend(tower[2:])
    return work


PRESETS = [(f"{name}_{mode}", preset, mode) for name, preset, modes in (
    ("clip_b16", clip_b16, ("fusion", "multimodal", "videoonly", "audioonly")),
    ("clip_l14", clip_l14, ("fusion", "multimodal", "videoonly", "audioonly")),
    ("swin_base", swin_base, ("fusion", "multimodal", "videoonly", "audioonly")),
    ("swin_large", swin_large, ("fusion", "multimodal")),
    # AVS: Swin-Large fusion at T = 5 (every temporal core over 5 tokens)
    ("swin_large_avs", lambda **kw: swin_large(num_frames=5, **kw), ("fusion",)))
    for mode in modes]


@pytest.mark.parametrize("name,preset,ftmode", PRESETS, ids=[p[0] for p in PRESETS])
def test_presets_products_and_cores_lie_within_the_hopper_limits(monkeypatch, name, preset,
                                                                 ftmode):
    """Under the default routes, the fused-block and QFUSE routes and the
    transpose-free temporal stage, float and int8: each bf16 product passes
    `check_gemm_operands` at its (N, K), and each attention core takes the
    small or the resident kernel within one block's shared memory."""
    clear_opt_ins(monkeypatch)
    cfg = preset(ftmode=ftmode)
    work_of = _clip_work if name.startswith("clip") else _swin_work
    products, cores = set(), set()
    for on in ((), SWITCHES[:3], ("STGCMA_TV2",)):
        for k in SWITCHES:
            monkeypatch.setenv(k, "1" if k in on else "0")
        for quantized in (False, True):
            for kid, (prods, sites) in work_of(cfg, quantized).items():
                products.update(prods)
                cores.update(sites)
    for N, K in products:
        FA.check_gemm_operands(_empty(16, K), _empty(N, K), _empty(16, N),
                               name=f"{name} product (N={N}, K={K})")
    for n, dh in cores:
        route, smem = FA.attn_route(n, dh)
        assert route in ("small", "resident") and smem <= FA.SMEM_MAX_BYTES, (n, dh, route)
    assert products and cores
    if name == "clip_l14_fusion":
        assert (257, 64) in cores and (64, 64) in cores
    if name == "swin_large_fusion":
        assert (96, 768) in products and (49, 32) in cores
    if name == "swin_large_avs_fusion":
        assert (5, 32) in cores and (10, 32) not in cores
