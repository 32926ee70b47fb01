"""The port's Swin single-stream AVE modes (`videoonly`, `audioonly`)
against the JAX package.

The tiny tower is the Swin slice's (embed 32, depths 2/2, heads 2/32, 56^2,
window 7, T = 2): a shifted stage 0 of 2 heads (K1 for the temporal and
window attention) and a 7x7 stage of 32 heads (LayerNorm then the K8 core).
The single-stream block reads its own stream's adapters only, takes its
FFN as LayerNorm then the plain MLP (never K7; `linear_q` on an int8 tower,
never K3) and adds its FFN adapter, which reads the normalized rows, at
half weight. The JAX side runs with STGCMA_FUSED_ATTN=1 (its kernels in
interpret mode) and 0 (the plain XLA path). Weights cross over through
`swin_ave_from_jax`.

Tolerances (max abs error over max |ref|; measured beside each):
- float, fp32, against both JAX paths: 1e-5 (summation order only;
  measured 1.3e-7 videoonly, 9.5e-8 audioonly);
- int8 tower, fp32, against JAX's path on the CPU: 1e-2, as for the int8
  fusion slice (two quantizers: their floors and divides differ, so an
  activation on a rounding boundary moves one int8 code; measured 4.2e-5
  and 3.9e-5);
- bf16 serving, port against JAX's own bf16 server: 2e-2 (both round to
  bf16 at every op, at different places; measured 5.0e-3 and 2.7e-3).
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from stgcma_tpu.configs import swin_tiny_test as jax_swin_tiny_test
from stgcma_tpu.models import ave as jax_ave
from stgcma_tpu.ops import quant as jax_quant
from stgcma_tpu.serving import MultiTaskServer as JaxServer
from stgcma_tpu_torch.checkpoint.convert import swin_ave_from_jax
from stgcma_tpu_torch.configs import swin_base, swin_large, swin_tiny_test
from stgcma_tpu_torch.models.ave import (SingleHead, apply_swin_ave, init_swin_ave,
                                         random_swin_ave)
from stgcma_tpu_torch.nn import swin
from stgcma_tpu_torch.ops import fused_attn as FA
from stgcma_tpu_torch.serving import MultiTaskServer

from torch_port_helpers import clear_opt_ins, rel, t, to_numpy_tree

TINY = dict(embed_dim=32, depths=(2, 2), num_heads=(2, 32), img_size=56, num_frames=2,
            adapter_ratios=(0.25, 0.25), label_dim=7)
MODES = ("videoonly", "audioonly")
TOL, TOL_INT8, TOL_BF16 = 1e-5, 1e-2, 2e-2


def _params(ftmode, seed=11, int8=False):
    """Random, non-trivial weights (D_fc2 non-zero, live bias tables), drawn
    with numpy on the shapes of the JAX init; with `int8` the tower
    quantized by the JAX `quantize_swin_tower`."""
    cfg = jax_swin_tiny_test(ftmode=ftmode, **TINY)
    shapes = jax.eval_shape(lambda: jax_ave.init_swin_ave(jax.random.PRNGKey(0), cfg))
    rng = np.random.RandomState(seed)

    def draw(path, x):
        s = 1.0 if "bias_table" in jax.tree_util.keystr(path) else 0.05
        return jnp.asarray((rng.randn(*x.shape) * s).astype(np.float32))
    params = dict(jax.tree_util.tree_map_with_path(draw, shapes))
    if int8:
        params["backbone"] = jax_quant.quantize_swin_tower(params["backbone"])
    return cfg, params


def _batch(ftmode, B=2, seed=7):
    """The mode's one input: fbank images for audioonly, frames for videoonly."""
    rng = np.random.RandomState(seed)
    n, T = TINY["img_size"], TINY["num_frames"]
    if ftmode == "audioonly":
        return {"a": rng.randn(B, T, n, n).astype(np.float32)}
    return {"v": rng.randn(B, T, n, n, 3).astype(np.float32)}


def _jax_logits(cfg, params, batch):
    fn = jax.jit(lambda p, a, v: jax_ave.apply_swin_ave(p, cfg, a, v))
    return np.asarray(fn(params, batch.get("a"), batch.get("v")))


def _port_logits(ftmode, params, batch):
    cfg = swin_tiny_test(ftmode=ftmode, **TINY)
    model = swin_ave_from_jax(cfg, to_numpy_tree(params), device="cpu")
    FA.reset_launches()
    with torch.inference_mode():
        out = apply_swin_ave(model, cfg, **{k: t(x) for k, x in batch.items()}).numpy()
    assert all(k.launches == 0 for k in FA.KERNELS)   # plain versions on the CPU
    return out


@pytest.mark.parametrize("ftmode", MODES)
def test_single_stream_matches_jax_fused_and_xla(monkeypatch, ftmode):
    clear_opt_ins(monkeypatch)
    cfg, params = _params(ftmode)
    batch = _batch(ftmode)
    out = _port_logits(ftmode, params, batch)
    assert out.shape == (2 * TINY["num_frames"], TINY["label_dim"])
    for fused in ("1", "0"):           # the routes are read while jit traces
        monkeypatch.setenv("STGCMA_FUSED_ATTN", fused)
        assert rel(out, _jax_logits(cfg, params, batch)) < TOL, fused


@pytest.mark.parametrize("ftmode", MODES)
def test_single_stream_int8_tower_matches_jax(monkeypatch, ftmode):
    """The JAX int8 tree (`kernel_q` / `kernel_s`) through swin_ave_from_jax:
    K2 at the attention sites of stage 0, `int8_matmul` around the K8 core
    and in the FFN (JAX's `mlp_apply` is XLA on an int8 tower too)."""
    clear_opt_ins(monkeypatch)
    monkeypatch.setenv("STGCMA_FUSED_ATTN", "1")
    cfg, params = _params(ftmode, int8=True)
    batch = _batch(ftmode)
    out = _port_logits(ftmode, params, batch)
    assert rel(out, _jax_logits(cfg, params, batch)) < TOL_INT8


@pytest.mark.parametrize("ftmode", MODES)
def test_single_stream_server_on_cpu_matches_jax_server(monkeypatch, ftmode):
    """`MultiTaskServer.add_ave` on device="cpu" with the mode's one input
    (bf16 parameters and input, float32 numpy logits) against the JAX bf16
    server, which is handed a dummy for the input the mode does not read."""
    clear_opt_ins(monkeypatch)
    monkeypatch.setenv("STGCMA_FUSED_ATTN", "1")
    cfg, params = _params(ftmode, seed=5)
    batch = _batch(ftmode, B=1)
    other = {"a": "v", "v": "a"}[next(iter(batch))]
    jsrv = JaxServer()
    jsrv.add_ave("ave29", cfg, params)
    ref = jsrv.predict("ave29", {**batch, other: np.zeros((1,), np.float32)})
    pcfg = swin_tiny_test(ftmode=ftmode, **TINY)
    srv = MultiTaskServer(device="cpu")
    srv.add_ave("ave29", pcfg, swin_ave_from_jax(pcfg, to_numpy_tree(params), "cpu"))
    out = srv.predict("ave29", batch)
    assert out.dtype == np.float32 and out.shape == ref.shape
    assert rel(out, ref) < TOL_BF16


@pytest.mark.parametrize("ftmode", MODES)
def test_single_stream_tree_round_trip(ftmode):
    """The single-stream tree holds its stream's adapters only (T_Adapter,
    S_Adapter2, S_Adapter, with the `_Audio` suffix for audio), the gates
    (unread) and the `ln` / `fc` head: the strict load takes it, every leaf
    maps back bit for bit, and the other stream's adapters are absent."""
    cfg, params = _params(ftmode)
    model = swin_ave_from_jax(swin_tiny_test(ftmode=ftmode, **TINY), to_numpy_tree(params), "cpu")
    sd = model.state_dict()
    leaves = jax.tree_util.tree_flatten_with_path(params)[0]
    assert len(leaves) == len(sd)
    for path, leaf in leaves:
        keys = [str(getattr(k, "key", getattr(k, "idx", k))) for k in path]
        last, x = keys[-1], np.asarray(leaf)
        if last == "kernel":
            last = "weight"
            x = x.T if x.ndim == 2 else x.transpose(4, 3, 0, 1, 2)
        elif last == "scale":
            last = "weight"
        np.testing.assert_array_equal(sd[".".join(keys[:-1] + [last])].numpy(), x)
    own, other = ("", "_Audio") if ftmode == "videoonly" else ("_Audio", "")
    children = {n for n, _ in model.backbone.layers[0].blocks[0].named_children()}
    for name in ("T_Adapter", "S_Adapter2", "S_Adapter"):
        assert name + own in children and name + other not in children
    assert isinstance(model.mlp_head, SingleHead)


@pytest.mark.parametrize("ftmode", MODES)
def test_single_stream_launch_counts_match_the_forward(monkeypatch, ftmode):
    """The calls of each wrapper in one single-stream forward are
    `launches_per_forward`'s (one stream), with K7 and K9 at threshold 0:
    the FFN still takes neither K7 nor K3 (its adapter reads the normalized
    rows), and K9 runs at the patch embed, the merge, the stage-1 temporal
    norm and the final norm."""
    calls = {k: 0 for k in ("K1", "K3", "K7", "K8", "K9")}
    for name, kern in (("K1", FA.win_block), ("K3", FA.ffn_q), ("K7", FA.ffn),
                       ("K8", FA.wmsa_qkv), ("K9", FA.layernorm)):
        def counted(*args, _plain=kern.plain, _name=name, **kw):
            calls[_name] += 1
            return _plain(*args, **kw)
        monkeypatch.setattr(kern, "plain", counted)
    monkeypatch.setattr(FA, "LN_KERNEL_MIN_ELEMS", 0)
    monkeypatch.setattr(FA, "FFN_KERNEL_MIN_HIDDEN_BYTES", 0)
    cfg = swin_tiny_test(ftmode=ftmode, **TINY)
    with torch.inference_mode():
        apply_swin_ave(random_swin_ave(cfg, 0), cfg,
                       **{k: t(x) for k, x in _batch(ftmode).items()})
    want = swin.launches_per_forward(cfg, B=2, itemsize=4)
    assert {k: n for k, n in calls.items() if n} == want
    assert want == {"K1": 3, "K8": 3, "K9": 4}


def test_launch_counts_of_single_stream_presets_at_b8():
    """Swin-Base videoonly / audioonly per B = 8 forward (T = 10), one
    stream: K1 at the 11 temporal and 22 window sites of stages 0-2 (4 / 8
    / 16 heads), K8 at stage 3's temporal and two window sites (32 heads),
    K9 at the patch embed, 3 merges, stage 3's temporal norm and the final
    norm; no K7 whatever the hidden size. The int8 tower: K2 in K1's place,
    no K3. Swin-Large (24 heads at stage 2): its stage-2 sites take K8."""
    for ftmode in MODES:
        cfg = swin_base(ftmode=ftmode)
        assert swin.launches_per_forward(cfg, B=8) == {"K1": 33, "K8": 3, "K9": 6}
        assert swin.launches_per_forward(cfg, B=64) == {"K1": 33, "K8": 3, "K9": 6}
        assert swin.launches_per_forward(cfg, B=8, quantized=True) == {"K2": 33, "K8": 3,
                                                                        "K9": 6}
        assert swin.launches_per_forward(swin_large(ftmode=ftmode), B=8) == {
            "K1": 6, "K8": 9 + 18 + 3, "K9": 6 + 9}


@pytest.mark.parametrize("ftmode", MODES)
def test_single_stream_models_build_their_head_and_stream(ftmode):
    """init_swin_ave and random_swin_ave build the single head and one
    stream's adapters; the init zeroes D_fc2 (a fresh adapter is a no-op)
    and keeps the head's LayerNorm at unit."""
    cfg = swin_tiny_test(ftmode=ftmode, **TINY)
    m = init_swin_ave(cfg, device="cpu")
    assert isinstance(m.mlp_head, SingleHead)
    assert torch.equal(m.mlp_head.ln.weight, torch.ones(cfg.num_features))
    sfx = "" if ftmode == "videoonly" else "_Audio"
    blk = m.backbone.layers[0].blocks[0]
    assert float(getattr(blk, "S_Adapter" + sfx).D_fc2.weight.detach().abs().max()) == 0.0
    r = random_swin_ave(cfg, 1)
    assert isinstance(r.mlp_head, SingleHead)
    live = getattr(r.backbone.layers[0].blocks[0], "S_Adapter" + sfx).D_fc2.weight
    assert float(live.detach().std()) > 0
