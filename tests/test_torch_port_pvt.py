"""The port's PVT-v2 encoder and PVT AVS baseline against the JAX package:
`sra_attention` (sr > 1 and sr = 1), `dwconv`, `pvt_apply` at TINY and at
B5's widths, heads and sr ratios with the depths cut to (1, 1, 2, 1) at
64^2, `apply_avs_pvt` in eval and in train mode with the TPAVI BatchNorms'
statistics, `load_pvt_v2` leaf for leaf against JAX's on the synthetic
reference state dict of tests/test_pvt.py, and `avs_pvt_from_jax`.

Every leaf is drawn live from a numpy seed (LayerNorm scales 1 + N(0, 0.1),
biases N(0, 0.05), conv kernels N(0, 1/fan_in), linear kernels N(0, 1/in))
and crosses over through `params_from_jax`.

Tolerances (max abs error over max |ref|): fp32 1e-5 (summation order
only), the updated BatchNorm statistics included; bf16 2e-2 (both sides
round at every op, torch's linear adding its bias before the rounding,
XLA's after). In train mode the returned maps are not compared: TPAVI's
BatchNorm divides each channel by its batch deviation over the 8 to 128
rows of a 64^2 pair of frames, which blows a 1e-6 difference up to 1e-4 at
some channels; the mask logits, the audio features and the statistics are
held at 1e-5, as in tests/test_torch_port_avs_slice.py. The JAX side runs
under `jax.jit` (op by op, the AVS forward takes 26 s on the CPU).

The bf16 cases run torch's own CPU convolution with oneDNN switched off:
oneDNN's bf16 convolution in this torch (2.13, CPU) returns wrong sums at
some shapes, TINY's spatial-reduction conv among them (C = 16, kernel =
stride = 4: 1.17 of max |ref| from the float64 result, where the native
kernel sits at 3e-3); the card runs cuDNN.
"""
import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from stgcma_tpu.checkpoint import torch_convert as JTC
from stgcma_tpu.configs import AVSHeadConfig as JaxAVSHeadConfig
from stgcma_tpu.models import avs as jax_avs
from stgcma_tpu.nn import pvt as jax_pvt
from stgcma_tpu.ops.common import cast_tree as jax_cast_tree
from stgcma_tpu_torch.checkpoint.convert import avs_pvt_from_jax, params_from_jax
from stgcma_tpu_torch.checkpoint.torch_convert import load_pvt_v2
from stgcma_tpu_torch.configs import AVSHeadConfig
from stgcma_tpu_torch.models.avs import (PVTAVSModel, apply_avs_pvt, init_avs_pvt,
                                         random_avs_pvt)
from stgcma_tpu_torch.nn import pvt
from stgcma_tpu_torch.ops.common import cast_tree

from torch_port_helpers import rel, t


def _bf16_convs():
    return torch.backends.mkldnn.flags(enabled=False)


TOL, TOL_BF16 = 1e-5, 2e-2
B5_CUT = dict(pvt.B5, depths=(1, 1, 2, 1))
HEAD = dict(tpavi_stages=(0, 1, 2, 3), num_frames=2)


def _live(tree, seed):
    """Every leaf of a JAX tree drawn anew from a numpy seed."""
    rng = np.random.RandomState(seed)

    def draw(path, x):
        name = jax.tree_util.keystr(path)
        if name.endswith("['var']"):
            a = rng.uniform(0.5, 1.5, x.shape)
        elif name.endswith("['kernel']") and len(x.shape) == 4:
            a = rng.randn(*x.shape) / np.sqrt(np.prod(x.shape[:3]))
        elif name.endswith("['kernel']"):
            a = rng.randn(*x.shape) / np.sqrt(x.shape[0])
        elif name.endswith("['scale']") and "['bn']" in name:
            a = 1.0 + 0.5 * rng.randn(*x.shape)
        elif name.endswith("['scale']"):
            a = 1.0 + 0.1 * rng.randn(*x.shape)
        else:
            a = 0.05 * rng.randn(*x.shape)
        return jnp.asarray(a.astype(np.float32))

    return jax.tree_util.tree_map_with_path(draw, tree)


def _encoder(cfg, seed):
    """(JAX tree, port PVT) holding the same live weights."""
    tree = _live(jax_pvt.pvt_init(jax.random.PRNGKey(seed), cfg), seed)
    model = pvt.PVT(cfg)
    model.load_state_dict(params_from_jax(jax.tree_util.tree_map(np.asarray, tree)),
                          strict=True)
    return tree, model


def test_dwconv_matches_jax():
    rng = np.random.RandomState(0)
    C, H, W = 12, 6, 5
    p = {"kernel": jnp.asarray(rng.randn(3, 3, 1, C), jnp.float32),
         "bias": jnp.asarray(rng.randn(C), jnp.float32)}
    x = rng.randn(2, H * W, C).astype(np.float32)
    ref = jax_pvt._dwconv(p, jnp.asarray(x), H, W)
    m = pvt.Mlp(4, C)
    m.load_state_dict(params_from_jax({"fc1": {"kernel": np.zeros((4, C), np.float32),
                                               "bias": np.zeros(C, np.float32)},
                                       "dwconv": jax.tree_util.tree_map(np.asarray, p),
                                       "fc2": {"kernel": np.zeros((C, 4), np.float32),
                                               "bias": np.zeros(4, np.float32)}}))
    assert tuple(m.dwconv.weight.shape) == (C, 1, 3, 3)
    out = pvt.dwconv(m.dwconv, t(x), H, W)
    assert rel(out, ref) < TOL


@pytest.mark.parametrize("sr", [4, 1])
def test_sra_attention_matches_jax(sr):
    dim, heads, H, W = 16, 2, 8, 8
    tree = _live(jax_pvt._block_init(jax.random.PRNGKey(sr), dim, heads, 4, sr), sr)
    blk = pvt.Block(dim, 4, sr)
    blk.load_state_dict(params_from_jax(jax.tree_util.tree_map(np.asarray, tree)), strict=True)
    x = np.random.RandomState(1).randn(2, H * W, dim).astype(np.float32)
    ref = jax_pvt._sra_attention(tree["attn"], jnp.asarray(x), H, W, heads, sr)
    assert rel(pvt.sra_attention(blk.attn, t(x), H, W, heads, sr), ref) < TOL
    ref = jax_pvt._block_apply(tree, jnp.asarray(x), H, W, heads, sr, 4)
    assert rel(pvt.block_apply(blk, t(x), H, W, heads, sr), ref) < TOL


@pytest.mark.parametrize("preset,dtype", [("TINY", "fp32"), ("B5_CUT", "fp32"),
                                          ("TINY", "bf16"), ("B5_CUT", "bf16")])
def test_pvt_apply_matches_jax(preset, dtype):
    cfg = {"TINY": pvt.TINY, "B5_CUT": B5_CUT}[preset]
    tree, model = _encoder(cfg, 3)
    x = np.random.RandomState(4).randn(2, 64, 64, 3).astype(np.float32)
    fn = jax.jit(functools.partial(jax_pvt.pvt_apply, cfg=cfg))
    if dtype == "bf16":
        refs = fn(jax_cast_tree(tree, jnp.bfloat16), jnp.asarray(x, jnp.bfloat16))
        with _bf16_convs():
            outs = pvt.pvt_apply(cast_tree(model, torch.bfloat16), t(x, torch.bfloat16))
    else:
        refs = fn(tree, jnp.asarray(x))
        outs = pvt.pvt_apply(model, t(x))
    assert len(outs) == len(cfg["embed_dims"])
    for i, (o, r) in enumerate(zip(outs, refs)):
        assert tuple(o.shape) == r.shape == (2, 16 >> i, 16 >> i, cfg["embed_dims"][i])
        assert rel(o, np.asarray(r, np.float32)) < (TOL_BF16 if dtype == "bf16" else TOL), i


def _avs_models(seed=5):
    hcfg, jhcfg = AVSHeadConfig(**HEAD), JaxAVSHeadConfig(**HEAD)
    tree = jax_avs.init_avs_pvt(jax.random.PRNGKey(seed), jhcfg)
    tree["encoder"] = jax_pvt.pvt_init(jax.random.PRNGKey(seed), B5_CUT)
    tree = _live(tree, seed)
    model = avs_pvt_from_jax(hcfg, jax.tree_util.tree_map(np.asarray, tree), device="cpu",
                             pvt_cfg=B5_CUT)
    return hcfg, jhcfg, tree, model


def _jax_avs_pvt(tree, jhcfg, audio, frames, train=False):
    fn = jax.jit(functools.partial(jax_avs.apply_avs_pvt, hcfg=jhcfg, train=train,
                                   return_state=True))
    return fn(tree, audio_feat=jnp.asarray(audio), frames=jnp.asarray(frames))


@pytest.mark.parametrize("train", [False, True])
def test_apply_avs_pvt_matches_jax(train):
    hcfg, jhcfg, tree, model = _avs_models()
    rng = np.random.RandomState(6)
    audio = rng.randn(1, 2, 128).astype(np.float32)
    frames = rng.randn(2, 64, 64, 3).astype(np.float32)
    ref = _jax_avs_pvt(tree, jhcfg, audio, frames, train)
    out = apply_avs_pvt(model, hcfg, t(audio), t(frames), train=train, return_state=True)
    assert tuple(out[0].shape) == ref[0].shape == (2, 64, 64, 1)
    assert rel(out[0], ref[0]) < TOL
    for i, (fm, r) in enumerate(zip(out[1], ref[1])):
        assert fm.shape == r.shape == (2, 16 >> i, 16 >> i, hcfg.channel)
        assert train or rel(fm, r) < TOL, i
    for af, r in zip(out[2], ref[2]):
        assert af.shape == r.shape == (1, 2, hcfg.channel)
        assert rel(af, r) < TOL
    assert sorted(out[3]) == sorted(ref[3]) == (
        [f"tpavi_b{i + 1}" for i in HEAD["tpavi_stages"]] if train else [])
    for k, stats in out[3].items():
        for s in ("mean", "var"):
            assert rel(stats[s], ref[3][k][s]) < TOL, (k, s)


def test_apply_avs_pvt_bf16_rounds_as_jax():
    """bf16 through the whole baseline: the encoder's five blocks, ASPP,
    TPAVI and some 15 rounded decoder layers put each side's bf16 mask
    logits 2.5-4% of max |ref| from its own fp32 ones (JAX 2.6e-2, port
    4.0e-2 at this seed; 3.3e-2 and 2.6e-2 at seed 7), so 2e-2 between the
    two bf16 outputs is below bf16's own noise here. The port's bf16 is held
    instead to JAX's fp32 no farther than twice JAX's own bf16 distance
    from it: a rounding left out or a wrong cast moves it far beyond."""
    hcfg, jhcfg, tree, model = _avs_models()
    rng = np.random.RandomState(8)
    audio = rng.randn(1, 2, 128).astype(np.float32)
    frames = rng.randn(2, 64, 64, 3).astype(np.float32)
    ref = np.asarray(_jax_avs_pvt(tree, jhcfg, audio, frames)[0])
    jax16 = np.asarray(_jax_avs_pvt(jax_cast_tree(tree, jnp.bfloat16), jhcfg,
                                    audio.astype(jnp.bfloat16),
                                    frames.astype(jnp.bfloat16))[0], np.float32)
    with _bf16_convs():
        out = apply_avs_pvt(cast_tree(model, torch.bfloat16), hcfg, t(audio, torch.bfloat16),
                            t(frames, torch.bfloat16))[0]
    assert out.dtype == torch.bfloat16
    assert rel(out, ref) < 2 * rel(jax16, ref)


def _reference_state_dict(cfg, seed=0):
    """tests/test_pvt.py's synthetic pvt_v2 state dict (the reference's names
    and torch layouts), with a classifier head and a DataParallel prefix."""
    rng = np.random.RandomState(seed)
    sd = {}
    for i, dim in enumerate(cfg["embed_dims"]):
        cin = 3 if i == 0 else cfg["embed_dims"][i - 1]
        ks = 7 if i == 0 else 3
        sd[f"patch_embed{i+1}.proj.weight"] = rng.randn(dim, cin, ks, ks).astype(np.float32)
        for k in ("patch_embed{}.proj.bias", "patch_embed{}.norm.weight",
                  "patch_embed{}.norm.bias", "norm{}.weight", "norm{}.bias"):
            sd[k.format(i + 1)] = rng.randn(dim).astype(np.float32)
        hid, sr = dim * cfg["mlp_ratios"][i], cfg["sr_ratios"][i]
        for j in range(cfg["depths"][i]):
            b = f"block{i+1}.{j}"
            shapes = {"norm1.weight": (dim,), "norm1.bias": (dim,), "norm2.weight": (dim,),
                      "norm2.bias": (dim,), "attn.q.weight": (dim, dim), "attn.q.bias": (dim,),
                      "attn.kv.weight": (2 * dim, dim), "attn.kv.bias": (2 * dim,),
                      "attn.proj.weight": (dim, dim), "attn.proj.bias": (dim,),
                      "mlp.fc1.weight": (hid, dim), "mlp.fc1.bias": (hid,),
                      "mlp.dwconv.dwconv.weight": (hid, 1, 3, 3),
                      "mlp.dwconv.dwconv.bias": (hid,), "mlp.fc2.weight": (dim, hid),
                      "mlp.fc2.bias": (dim,)}
            if sr > 1:
                shapes.update({"attn.sr.weight": (dim, dim, sr, sr), "attn.sr.bias": (dim,),
                               "attn.norm.weight": (dim,), "attn.norm.bias": (dim,)})
            for k, shp in shapes.items():
                sd[f"{b}.{k}"] = rng.randn(*shp).astype(np.float32)
    sd["head.weight"] = rng.randn(10, cfg["embed_dims"][-1]).astype(np.float32)
    sd["head.bias"] = rng.randn(10).astype(np.float32)
    return {f"module.{k}": v for k, v in sd.items()}


@pytest.mark.parametrize("preset", ["TINY", "B5_CUT"])
def test_load_pvt_v2_matches_jax(preset):
    cfg = {"TINY": pvt.TINY, "B5_CUT": B5_CUT}[preset]
    sd = _reference_state_dict(cfg)
    jtree, junexp = JTC.load_pvt_v2(jax_pvt.pvt_init(jax.random.PRNGKey(0), cfg), sd)
    model, unexpected = load_pvt_v2(pvt.PVT(cfg), sd, device="cpu")
    assert unexpected == junexp == []
    want = params_from_jax(jax.tree_util.tree_map(np.asarray, jtree))
    got = model.state_dict()
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        assert torch.equal(got[k], v), k
    # under a PVTAVSModel's prefix
    hcfg = AVSHeadConfig(**HEAD)
    model, unexpected = load_pvt_v2(PVTAVSModel(hcfg, cfg if preset == "B5_CUT" else B5_CUT)
                                    if preset == "B5_CUT" else PVTAVSModel(hcfg, B5_CUT),
                                    sd if preset == "B5_CUT" else _reference_state_dict(B5_CUT),
                                    prefix="encoder.", device="cpu")
    assert unexpected == []


@pytest.mark.parametrize("bad", ["block1.0.attn.foo.weight", "block1.0.mlp.dwconv.weight",
                                 "cls_token"])
def test_load_pvt_v2_refuses_unknown_keys(bad):
    sd = _reference_state_dict(pvt.TINY)
    sd[bad] = np.zeros(3, np.float32)
    with pytest.raises(ValueError, match="unhandled pvt"):
        JTC.load_pvt_v2(jax_pvt.pvt_init(jax.random.PRNGKey(0), pvt.TINY), sd)
    with pytest.raises(ValueError, match="unhandled pvt key"):
        load_pvt_v2(pvt.PVT(pvt.TINY), sd, device="cpu")


def test_avs_pvt_init_and_random():
    """The initializations build the B5 model with the JAX tree's leaves and
    shapes; `init_avs_pvt`'s distributions are JAX's (each leaf's std within
    a tenth, zero biases, the zero TPAVI BatchNorm scales)."""
    hcfg = AVSHeadConfig(**HEAD)
    jtree = jax_avs.init_avs_pvt(jax.random.PRNGKey(0), JaxAVSHeadConfig(**HEAD))
    want = params_from_jax(jax.tree_util.tree_map(np.asarray, jtree))
    model = init_avs_pvt(hcfg, torch.Generator().manual_seed(0), device="cpu")
    got = model.state_dict()
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        assert got[k].shape == v.shape, k
        if v.numel() > 1 and float(v.std()) == 0:
            assert torch.equal(got[k], v), k
        elif v.numel() > 200:
            assert abs(float(got[k].std()) / float(v.std()) - 1) < 0.1, k
    rnd = random_avs_pvt(hcfg, 0, pvt_cfg=B5_CUT)
    assert all(torch.isfinite(p).all() for p in rnd.parameters())
    assert float(rnd.avstask.tpavi_b1.W_z.bn.weight.abs().min()) > 0
