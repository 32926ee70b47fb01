"""K4 over its windows and the fusion kernel's limits, on the CPU.

On the card the whole Swin fusion block K4 (ops/swin_block.py) does the
in-window work only: its attention core and its masked fusion (S_Adapter2)
read each window's rows through a window table (`Geo.table`, or
`window_table` of the fusion mask), where the plain versions run over the
full grid with the windows as additive masks.

- (a) For every K4 geometry of the Swin-Base and Swin-Large presets,
  shifted and unshifted: the table is a permutation of the grid with ws^2
  tokens a window, every pair it skips is exactly -1e30 in `attn_mask` and
  `fuse_mask`, every -100 shift entry lies inside a window, and the table
  read back from the fusion mask holds the same windows. A mask whose zero
  entries are not windows of one size raises.
- (b) The block evaluated in plain torch through the table (the attention
  over each window's rows with the bias at their own entries, the masked
  fusion per window, everything else as it is) equals `swin_block_plain` in
  fp32 to 1e-6 of max |plain| (only the order of the non-zero fp32 terms
  differs), shifted and unshifted; the int8 variant equals
  `swin_block_q_plain` to the 1e-3 the int8 paths are held to (`rows_agree`:
  a reordered fp32 sum may move one int8 code).
- (c) Under the recorder of tests/test_torch_port_hopper_limits.py (the
  CUDA launches recorded, not made), the card composition of K4 at
  Swin-Base stages 2 (shifted) and 3 and Swin-Large stage 2, float and int8:
  at most 13 launches a float call and 16 an int8 one (the memset of fc1's
  row maxima counted), the attention core at ws^2 tokens, the masked
  fusion per window, and the launch arguments within the kernels' limits;
  the constants `fuse_route` and the wrappers mirror are csrc/fuse.cu's and
  csrc/adapter.cu's own.
"""
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from stgcma_tpu_torch.configs import swin_base, swin_large
from stgcma_tpu_torch.nn import swin
from stgcma_tpu_torch.ops import fused_attn as FA
from stgcma_tpu_torch.ops import swin_block as SB
from stgcma_tpu_torch.ops.attention import gather_bias
from stgcma_tpu_torch.ops.quant import quantize_weight

from test_torch_port_hopper_limits import _block_w, _empty, recorder  # noqa: F401
from torch_port_helpers import rel, rows_agree

CSRC = Path(FA.__file__).resolve().parent.parent / "csrc"
CPU = torch.device("cpu")


def _k4_geometries():
    """(preset, stage, H, W, ws, ss) of every K4 block geometry of the two presets."""
    out = set()
    for name, preset in (("swin_base", swin_base), ("swin_large", swin_large)):
        for s, stage in enumerate(swin.backbone_statics(preset(ftmode="fusion"))):
            for st in stage:
                if SB.swin_whole_block_enabled(st):
                    out.add((name, s, st.H, st.W, st.window_size, st.shift_size))
    return sorted(out)


GEOMETRIES = _k4_geometries()


def test_k4_geometries_cover_both_presets_shifted_and_not():
    assert {(p, s, ss) for p, s, _, _, _, ss in GEOMETRIES} == {
        (p, s, ss) for p in ("swin_base", "swin_large") for s, ss in ((2, 0), (2, 3), (3, 0))}


# ---------------------------------------------------------------------------
# (a) the window table against the masks
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("preset,stage,H,W,ws,ss", GEOMETRIES,
                         ids=[f"{g[0]}_stage{g[1]}_shift{g[5]}" for g in GEOMETRIES])
def test_window_table_matches_the_masks(preset, stage, H, W, ws, ss):
    g = SB.geo(H, W, ws, ss)
    N = H * W
    table = g.table
    assert table.shape == (N // (ws * ws), ws * ws) and table.dtype == np.int32
    assert np.array_equal(np.sort(table.reshape(-1)), np.arange(N))
    win = np.empty(N, np.int64)
    win[table.reshape(-1)] = np.repeat(np.arange(table.shape[0]), ws * ws)
    inside = win[:, None] == win[None, :]
    assert np.all(g.attn_mask[~inside] == np.float32(-1e30))
    assert np.all(g.fuse_mask[~inside] == np.float32(-1e30))
    assert np.all(g.fuse_mask[inside] == 0)
    shift = g.attn_mask == np.float32(-100.0)
    assert np.all(inside[shift]) and np.all(g.attn_mask[inside & ~shift] == 0)
    assert shift.any() == (ss > 0)
    derived = SB.window_table(g.fuse_mask)
    assert sorted(map(sorted, derived.tolist())) == sorted(map(sorted, table.tolist()))


def test_window_table_refuses_masks_that_are_not_windows():
    g = SB.geo(14, 14, 7, 3)
    uneven = g.fuse_mask.copy()
    uneven[0, 1:] = np.float32(-1e30)          # token 0 alone, its window-mates not
    uneven[1:, 0] = np.float32(-1e30)
    with pytest.raises(ValueError):
        SB.window_table(uneven)
    broken = g.fuse_mask.copy()
    broken[0, g.table[1, 0]] = 0                # one entry across two windows
    with pytest.raises(ValueError):
        SB.window_table(broken)
    assert SB.window_table(np.zeros((49, 49), np.float32)).shape == (1, 49)


# ---------------------------------------------------------------------------
# (b) the block through the table in plain torch
# ---------------------------------------------------------------------------

def _weights(rng, C, D, quantized):
    """A fusion block's weights in fp32 (the tower int8 with fp32 scales where
    `quantized`), adapters and gates live."""
    def n(*shape, std=1.0):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32) * std)
    w = {"ln1_w": 1 + n(C, std=0.1), "ln1_b": n(C, std=0.1), "ln2_w": 1 + n(C, std=0.1),
         "ln2_b": n(C, std=0.1), "gate_v": torch.tensor([0.8]), "gate_a": torch.tensor([-0.6])}
    for (wk, sk, bk), (o, i) in zip(SB.TOWER, ((3 * C, C), (C, C), (4 * C, C), (C, 4 * C))):
        wt = n(o, i, std=i ** -0.5)
        w[bk] = n(o, std=0.1)
        if quantized:
            w[wk], w[sk] = quantize_weight(wt)
        else:
            w[wk] = wt
    for key, _ in SB.ADAPTERS:
        w.update({f"{key}_w1": n(D, C, std=2.26 / C ** 0.5), f"{key}_b1": n(D, std=0.1),
                  f"{key}_w2": n(C, D, std=0.566 / D ** 0.5), f"{key}_b2": n(C, std=0.1)})
    return w


def _through_table(table):
    """`_heads_attention` over each window's rows (the bias at their own
    entries) and `fuse_plain` per window where it is given the fusion mask:
    the card composition's order of work, in plain torch."""
    nW, n = table.shape
    idx = torch.from_numpy(table.reshape(-1)).long()

    def gather(x):
        return x[:, idx].reshape(x.shape[0] * nW, n, x.shape[-1])

    def scatter(xw, like):
        out = torch.empty_like(like)
        out[:, idx] = xw.reshape(like.shape[0], -1, xw.shape[-1])
        return out

    def attention(qkv, heads, bias, dt):
        bw = bias[0][:, idx][:, :, idx].reshape(heads, nW, n, nW, n)
        bw = bw.diagonal(dim1=1, dim2=3).permute(3, 0, 1, 2).contiguous()   # (nW, h, n, n)
        o = FA._heads_attention(gather(qkv), heads, bw, dt)
        return scatter(o, qkv[..., : qkv.shape[-1] // 3])

    def fuse(vh, ah, gate_v, gate_a, mask=None):
        if mask is None:
            return FA.fuse_plain(vh, ah, gate_v, gate_a)
        vo, ao = FA.fuse_plain(gather(vh), gather(ah), gate_v, gate_a)
        return scatter(vo, vh), scatter(ao, ah)
    return attention, fuse


@pytest.mark.parametrize("quantized", [False, True], ids=["float", "int8"])
@pytest.mark.parametrize("ss", [0, 3])
def test_block_through_the_table_equals_the_full_grid(monkeypatch, ss, quantized):
    rng = np.random.default_rng(10 + ss + quantized)
    H = W = 14
    ws, C, heads, D, BT = 7, 32, 2, 16, 2
    N = H * W
    index, attn_mask, fuse_mask = SB._geo_tensors(H, W, ws, ss, CPU)
    rel_table = torch.from_numpy(rng.standard_normal(((2 * ws - 1) ** 2, heads))
                                 .astype(np.float32))
    bias = (gather_bias(rel_table, index, heads, N) + attn_mask)[None].contiguous()
    w = _weights(rng, C, D, quantized)
    v = torch.from_numpy(rng.standard_normal((BT, N, C)).astype(np.float32))
    a = torch.from_numpy(rng.standard_normal((BT, N, C)).astype(np.float32))
    plain = SB.swin_block_q_plain if quantized else SB.swin_block_plain
    ref = plain(v, a, w, heads, bias, fuse_mask)
    attention, fuse = _through_table(SB.geo(H, W, ws, ss).table)
    monkeypatch.setattr(SB, "_heads_attention", attention)
    monkeypatch.setattr(SB, "fuse_plain", fuse)
    out = plain(v, a, w, heads, bias, fuse_mask)
    for o, r in zip(out, ref):
        if quantized:
            rows_agree(o, r.numpy(), tight=1e-6, loose=1e-3)
        else:
            assert rel(o, r.numpy()) <= 1e-6


# ---------------------------------------------------------------------------
# (c) the card composition under the recorder
# ---------------------------------------------------------------------------

K4_CASES = {   # (C, heads, D, H, ss) of Swin-Base stages 2 (shifted) and 3, Swin-Large stage 2
    "swin_base_stage2_shifted": (512, 16, 32, 14, 3),
    "swin_base_stage3": (1024, 32, 64, 7, 0),
    "swin_large_stage2": (768, 24, 96, 14, 0),
}
# (N, tokens of the grid) of each attention launcher's arguments
CORES = {"stg_attn_core": lambda a: (a[5], a[5]), "stg_attn_core_win": lambda a: (a[7], a[6])}


@pytest.mark.parametrize("quantized", [False, True], ids=["float", "int8"])
@pytest.mark.parametrize("case", sorted(K4_CASES))
def test_k4_launches_on_the_card(recorder, monkeypatch, case, quantized):  # noqa: F811
    C, heads, D, H, ss = K4_CASES[case]
    N, ws, BT = H * H, 7, 10
    memsets = []
    zero_ = torch.Tensor.zero_
    monkeypatch.setattr(torch.Tensor, "zero_", lambda t: memsets.append(t.shape) or zero_(t))
    _, _, fuse_mask = SB._geo_tensors(H, H, ws, ss, CPU)
    SB._swin_block_cuda(_empty(BT, N, C), _empty(BT, N, C),
                        _block_w(C, D, [k for k, _ in SB.ADAPTERS], quantized), heads,
                        _empty(1, heads, N, N, dtype=torch.float32), fuse_mask,
                        quantized=quantized)
    names = [fn for fn, _ in recorder.calls]
    launches = len(names) + len(memsets)
    assert launches <= (16 if quantized else 13), names
    assert len(memsets) == int(quantized)
    cores = [(fn, CORES[fn](args)) for fn, args in recorder.calls if fn in CORES]
    assert len(cores) == 1 and cores[0][1] == (ws * ws, N), cores
    assert names.count("stg_ln_quant_rows_bf16" if quantized else "stg_ln_bf16_pair") == 2
    assert names.count("stg_adapter_hidden_pair") == 2 and names.count("stg_adapter_out_pair") == 2
    fusions = [(fn, args) for fn, args in recorder.calls if fn.startswith("stg_fuse_bidir")]
    if N > ws * ws:       # the masked fusion per window, the unmasked one over the grid
        assert [fn for fn, _ in fusions] == ["stg_fuse_bidir_win", "stg_fuse_bidir"]
        win = fusions[0][1]
        assert (win[5], win[8], win[9], win[10], win[11]) == (N // (ws * ws), BT, N, ws * ws, D)
    else:                 # one window: both fusions over the grid, unmasked
        assert [fn for fn, _ in fusions] == ["stg_fuse_bidir"] * 2
    assert all(args[4] is None for fn, args in fusions if fn == "stg_fuse_bidir")
    for fn, args in recorder.calls:
        if fn == "stg_adapter_hidden_pair":
            M, Dh, K = args[8:11]
            assert (M, Dh, K) == (BT * N, D, C) and Dh in FA.FUSE_WIDTHS
        if fn == "stg_adapter_out_pair":
            M, Nn, K = args[12:15]
            assert (M, Nn, K) == (BT * N, C, D) and Nn % 8 == 0 and K % 8 == 0


def test_k4_takes_any_windows_that_tile_the_grid(recorder):  # noqa: F811
    """Two windows of 72 tokens (past the small kernel's 64) go to the windowed
    core at 72 tokens; a mask whose zero entries are not windows raises
    before any launch."""
    C, heads, D = 512, 16, 32
    N = 12 * 12
    win = np.arange(N) // 72
    mask = torch.from_numpy(np.where(win[:, None] == win[None, :], 0.0, -1e30).astype(np.float32))
    args = (_empty(2, N, C), _empty(2, N, C), _block_w(C, D, [k for k, _ in SB.ADAPTERS], False),
            heads, _empty(1, heads, N, N, dtype=torch.float32))
    SB._swin_block_cuda(*args, mask)
    cores = [CORES[fn](a) for fn, a in recorder.calls if fn in CORES]
    assert cores == [(72, N)]
    recorder.calls.clear()
    mask[0, 100] = 0                           # token 0 also sees a token of the other window
    with pytest.raises(ValueError, match="windows of one size"):
        SB._swin_block_cuda(*args, mask)
    assert not recorder.calls


def _cu_constant(text, name):
    return int(re.search(rf"constexpr int {name} = (\d+);", text).group(1))


def test_fuse_route_mirrors_fuse_cu():
    """The tile constants `fuse_route` mirrors are csrc/fuse.cu's own, and its
    shared-memory sums are the ring's: three key tiles of 64 rows at row
    stride D + 8 (and as many value tiles for K10), within one block's."""
    text = (CSRC / "fuse.cu").read_text()
    assert _cu_constant(text, "kMaxWarps") * 16 == FA.FUSE_BLOCK_ROWS
    assert _cu_constant(text, "kSmallRows") == FA.FUSE_SMALL_ROWS
    assert _cu_constant(text, "BK") == FA.FUSE_KEY_TILE
    assert _cu_constant(text, "kStages") == FA.FUSE_STAGES
    assert "static constexpr int LD = D + 8;" in text and "vt[" not in text
    assert "cp_async16(kd" in text and "ldsm_x4_t(bv" in text
    widths = tuple(int(d) for d in re.findall(r"if \(D == (\d+)\) return launch<", text))
    assert widths == FA.FUSE_WIDTHS
    assert "65535" not in text and "if (b0 + b1 > 0x7fffffffLL)" in text   # F4: the grid's bound
    assert "static constexpr int MIN_BLOCKS = D == 16 ? 4 : 2;" in text
    assert [FA.fuse_min_blocks(D) for D in FA.FUSE_WIDTHS] == [4, 2, 2, 2, 2]
    assert f"static constexpr bool Q_SMEM = D >= {FA.FUSE_Q_SMEM_WIDTH};" in text
    assert "2LL * Tile<D>::MIN_BLOCKS * sm_count()" in text
    assert FA.fuse_route(3136, 3136, 96, True, B=80) == (128, (128 + 3 * 64) * 104 * 2)
    assert FA.fuse_route(3136, 3136, 16, True, B=80) == (128, 3 * 64 * 24 * 2)
    assert FA.fuse_route(49, 49, 32, True, B=320) == (64, 64 * 40 * 2)         # one key tile
    assert FA.fuse_route(49, 49, 96, True, B=5120) == (64, (64 + 64) * 104 * 2)
    assert FA.fuse_route(197, 49, 48, True, B=80) == (64, 3 * 64 * 56 * 2)     # 240 blocks
    assert FA.fuse_route(1764, 1764, 16, False, B=80) == (128, 2 * 3 * 64 * 24 * 2)
    assert FA.fuse_route(441, 441, 32, False, B=80) == (64, 2 * 3 * 64 * 40 * 2)   # 320 blocks
    assert FA.fuse_route(1764, 1764, 96, False, B=80) == (128, (128 + 2 * 3 * 64) * 104 * 2)
    assert "const int ring = ceil_div(nk, BK) < kStages ? ceil_div(nk, BK) : kStages;" in text
    for D in FA.FUSE_WIDTHS:
        for gated in (True, False):
            assert FA.fuse_route(4096, 4096, D, gated)[1] <= FA.SMEM_MAX_BYTES
    adapter = (CSRC / "adapter.cu").read_text()
    hidden = tuple(int(d) for d in re.findall(r"if \(D == (\d+)\) return launch<\d+, EPI_RGELU",
                                              adapter))
    assert hidden == FA.FUSE_WIDTHS


@pytest.mark.parametrize("D", FA.FUSE_WIDTHS)
def test_fuse_route_takes_blocks_of_four_warps_for_short_directions(D):
    """128-row blocks only where a direction is longer than 64 rows and they
    give every SM two rounds; K6's full grids at B = 8 (80 frames) always."""
    rows = [FA.fuse_route(n, n, D, True, B=80)[0] for n in (1, 49, 64, 65, 784, 3136)]
    assert rows == [64, 64, 64, 64, 128, 128]
    assert FA.fuse_route(784, 784, D, True, B=1)[0] == 64                  # 14 blocks
    assert FA.fuse_route(49, 3136, D, True, B=80)[0] == 128   # the longer direction decides
    with pytest.raises(ValueError):
        FA.fuse_route(49, 49, D + 1)
