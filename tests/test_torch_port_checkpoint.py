"""The port's reference-checkpoint loaders against the JAX package's.

Synthetic state dicts in the reference's (PyTorch) layout, as in
tests/test_convert.py: a timm Swin with a 2D patch embed and an OpenAI CLIP
visual tower for the pretrained loaders; for the fine-tuned loaders, the
whole reference model of each task (AVE fusion and single-stream,
AVSBench with its ASPP / FPN / output head and TPAVI 1x1x1 convolutions,
MUSIC-AVQA with its packed attentions and LSTM, CLIP fusion with adapters
and gates), with the reference's buffers (relative_position_index,
attn_mask, num_batches_tracked) that both loaders skip, one key that no
model holds, and DataParallel `module.` prefixes. Each dict goes through
the JAX loader (its tree then through `params_from_jax`) and through the
port's loader on the same initial weights; the two must agree leaf for
leaf, bit for bit, and list the same unexpected keys. A shape mismatch
raises in both. Then the tiny Swin fusion AVE, AVS and CLIP AVE loaded
each way run forward, fp32, the JAX model in the JAX package and the port's
in the port: logits within 1e-5 of max |ref| (summation order only).
"""
import re

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import torch_port_helpers  # noqa: F401  (two torch threads a process)
from stgcma_tpu import configs as JC
from stgcma_tpu.checkpoint import torch_convert as JTC
from stgcma_tpu.models import ave as jax_ave
from stgcma_tpu.models import avqa as jax_avqa
from stgcma_tpu.models import avs as jax_avs
from stgcma_tpu_torch import configs as PC
from stgcma_tpu_torch.checkpoint import convert as CV
from stgcma_tpu_torch.checkpoint import torch_convert as PTC
from stgcma_tpu_torch.models.ave import apply_clip_ave, apply_swin_ave
from stgcma_tpu_torch.models.avs import apply_avs
from stgcma_tpu_torch.ops.quant import quantize_clip_tower, quantize_swin_tower

from torch_port_helpers import clear_opt_ins, rel, t, to_numpy_tree

SWIN = dict(num_frames=2, label_dim=7)
AVS_HEAD = dict(stage_dims=(16, 32), stage_resolutions=(14, 7), vis_dim=(64, 128),
                tpavi_stages=(0, 1), audio_dim=32, num_frames=2)
AVQA_HEAD = dict(feat_dim=32, qst_word_embed=16, qst_hidden=16, num_frames=2)
CLIP = dict(num_frames=2, label_dim=7)
TOL = 1e-5


def _init_tree(init, seed):
    """The JAX model's tree with every leaf drawn N(0, 0.05^2) (BatchNorm
    variances uniform(0.5, 1.5)), as numpy."""
    rng = np.random.RandomState(seed)

    def draw(path, x):
        if jax.tree_util.keystr(path).endswith("['var']"):
            return rng.uniform(0.5, 1.5, x.shape).astype(np.float32)
        return (rng.randn(*x.shape) * 0.05).astype(np.float32)
    return jax.tree_util.tree_map_with_path(draw, jax.eval_shape(init))


CASES = {  # name -> (JAX config and init, port config and model from a JAX tree)
    "swin_fusion": (lambda: JC.swin_tiny_test(ftmode="fusion", **SWIN), None,
                    lambda c, h: (lambda: jax_ave.init_swin_ave(jax.random.PRNGKey(0), c)),
                    lambda c, h, tree: CV.swin_ave_from_jax(c, tree, "cpu")),
    "swin_videoonly": (lambda: JC.swin_tiny_test(ftmode="videoonly", **SWIN), None,
                       lambda c, h: (lambda: jax_ave.init_swin_ave(jax.random.PRNGKey(0), c)),
                       lambda c, h, tree: CV.swin_ave_from_jax(c, tree, "cpu")),
    "avs": (lambda: JC.swin_tiny_test(ftmode="fusion", **SWIN), "avs",
            lambda c, h: (lambda: jax_avs.init_avs(jax.random.PRNGKey(0), c, h)),
            lambda c, h, tree: CV.avs_from_jax(c, h, tree, "cpu")),
    "avqa": (lambda: JC.swin_tiny_test(ftmode="fusion", **SWIN), "avqa",
             lambda c, h: (lambda: jax_avqa.init_avqa(jax.random.PRNGKey(0), c, h)),
             lambda c, h, tree: CV.avqa_from_jax(c, h, tree, "cpu")),
    "clip_fusion": (lambda: JC.clip_tiny_test(ftmode="fusion", **CLIP), None,
                    lambda c, h: (lambda: jax_ave.init_clip_ave(jax.random.PRNGKey(0), c)),
                    lambda c, h, tree: CV.clip_ave_from_jax(c, tree, "cpu")),
}


def _setup(case, seed=0):
    """(JAX cfg, head cfg, port cfg, port head cfg, the JAX tree as jnp
    arrays, the port model on the same weights)."""
    jcfg_fn, head, init, port_model = CASES[case]
    jcfg = jcfg_fn()
    pcfg = (PC.clip_tiny_test if case.startswith("clip") else PC.swin_tiny_test)(
        ftmode=jcfg.ftmode, **(CLIP if case.startswith("clip") else SWIN))
    jh = ph = None
    if head == "avs":
        jh, ph = JC.AVSHeadConfig(**AVS_HEAD), PC.AVSHeadConfig(**AVS_HEAD)
    elif head == "avqa":
        jh, ph = JC.AVQAHeadConfig(**AVQA_HEAD), PC.AVQAHeadConfig(**AVQA_HEAD)
    tree = _init_tree(init(jcfg, jh), seed)
    model = port_model(pcfg, ph, tree)
    return jcfg, jh, pcfg, ph, jax.tree_util.tree_map(jnp.asarray, tree), model


def _port_name(path):
    """A JAX path -> the port's name (`params_from_jax`'s leaf renames)."""
    *stem, leaf = path.split("/")
    leaf = {"kernel": "weight", "scale": "weight", "mean": "running_mean",
            "var": "running_var", "kernel_q": "weight_q", "kernel_s": "weight_s"}.get(leaf, leaf)
    return ".".join(stem + [leaf])


def _reference_key(name, a):
    """The port's name and array -> the reference's key and array (the
    layout the reference models' state_dict() has)."""
    if name.startswith("backbone."):
        return name[len("backbone."):], a
    if name.startswith("mlp_head."):
        idx = {"fc1": "0", "fc2": "2", "ln": "0", "fc": "1"}[name.split(".")[1]]
        return f"mlp_head.{idx}.{name.split('.')[2]}", a
    if name.startswith("avstask."):
        k = name[len("avstask."):]
        if re.match(r"tpavi_b\d\.(g|theta|phi|W_z\.conv)\.weight$", k):
            a = a[:, :, None, None, None]                       # a 1x1x1 Conv3d
        k = re.sub(r"^conv(\d)\.convs\.", r"conv\1.conv2d_list.", k)
        k = re.sub(r"^output_conv\.conv(\d)\.", r"output_conv.\1.", k)
        return "avstask_" + k.replace("W_z.conv.", "W_z.0.").replace("W_z.bn.", "W_z.1."), a
    assert name.startswith("avqatask."), name
    k = name[len("avqatask."):]
    k = re.sub(r"^(attn_[av])\.in_proj\.(weight|bias)$", r"\1.in_proj_\2", k)
    k = re.sub(r"lstm\.layers\.(\d+)\.w_(ih|hh)$", r"lstm.weight_\2_l\1", k)
    k = re.sub(r"lstm\.layers\.(\d+)\.b_(ih|hh)$", r"lstm.bias_\2_l\1", k)
    return "avqatask_" + k.replace("question_encoder.word2vec", "question_encoder.word2vec.weight"), a


def _reference_state_dict(model, seed, module_prefix=False, clip=False):
    """A fine-tuned reference checkpoint of `model`'s architecture with new
    random weights, the reference's extra buffers and one unknown key."""
    rng = np.random.RandomState(seed)
    sd = {}
    for name, cur in model.state_dict().items():
        a = rng.uniform(0.5, 1.5, cur.shape) if name.endswith("running_var") \
            else rng.randn(*cur.shape) * 0.05
        if clip and name.startswith("backbone."):
            key = name[len("backbone."):].replace("resblocks.", "transformer.resblocks.")
            key = key.replace("attn.in_proj.", "attn.in_proj_")
        else:
            key, a = _reference_key(name, a)
        sd[key] = a.astype(np.float32)
    if clip:
        sd["transformer.resblocks.0.bogus_scale"] = np.ones(3, np.float32)
    else:
        sd["layers.0.blocks.0.attn.relative_position_index"] = np.zeros((49, 49), np.int64)
        sd["layers.0.blocks.1.attn_mask"] = np.zeros((4, 49, 49), np.float32)
        sd["layers.0.blocks.0.bogus_scale"] = np.ones(3, np.float32)
        if any(k.startswith("avstask_") for k in sd):
            sd["avstask_tpavi_b1.W_z.1.num_batches_tracked"] = np.zeros((), np.int64)
    if module_prefix:
        sd = {f"module.{k}": v for k, v in sd.items()}
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in sd.items()}


def _swin_2d_state_dict(cfg, seed):
    """A timm Swin checkpoint (2D patch embed, ImageNet head), as
    tests/test_convert.py::test_full_pretrained_load_into_tiny_tree builds it."""
    rng = np.random.RandomState(seed)
    C = cfg.embed_dim

    def r(*s):
        return rng.randn(*s).astype(np.float32)
    sd = {"patch_embed.proj.weight": r(C, 3, 4, 4), "patch_embed.proj.bias": r(C),
          "patch_embed.norm.weight": r(C), "patch_embed.norm.bias": r(C),
          "norm.weight": r(cfg.num_features), "norm.bias": r(cfg.num_features),
          "head.weight": r(1000, cfg.num_features), "head.bias": r(1000)}
    for s in range(cfg.num_layers):
        dim = cfg.stage_dim(s)
        for b in range(cfg.depths[s]):
            pre = f"layers.{s}.blocks.{b}"
            for k in ("norm1", "norm2"):
                sd[f"{pre}.{k}.weight"], sd[f"{pre}.{k}.bias"] = r(dim), r(dim)
            sd[f"{pre}.attn.qkv.weight"], sd[f"{pre}.attn.qkv.bias"] = r(3 * dim, dim), r(3 * dim)
            sd[f"{pre}.attn.proj.weight"], sd[f"{pre}.attn.proj.bias"] = r(dim, dim), r(dim)
            sd[f"{pre}.attn.relative_position_bias_table"] = r(169, cfg.num_heads[s])
            sd[f"{pre}.attn.relative_position_index"] = np.zeros((49, 49), np.int64)
            sd[f"{pre}.mlp.fc1.weight"], sd[f"{pre}.mlp.fc1.bias"] = r(4 * dim, dim), r(4 * dim)
            sd[f"{pre}.mlp.fc2.weight"], sd[f"{pre}.mlp.fc2.bias"] = r(dim, 4 * dim), r(dim)
        if s < cfg.num_layers - 1:
            sd[f"layers.{s}.downsample.norm.weight"] = r(4 * dim)
            sd[f"layers.{s}.downsample.norm.bias"] = r(4 * dim)
            sd[f"layers.{s}.downsample.reduction.weight"] = r(2 * dim, 4 * dim)
    return sd


def _clip_visual_state_dict(cfg, seed):
    """An OpenAI CLIP visual tower, as test_convert.py::test_full_clip_pretrained_load."""
    rng = np.random.RandomState(seed)
    d = cfg.embed_dim

    def r(*s):
        return rng.randn(*s).astype(np.float32)
    sd = {"conv1.weight": r(d, 3, 16, 16), "class_embedding": r(d),
          "positional_embedding": r(cfg.num_patches + 1, d), "ln_pre.weight": r(d),
          "ln_pre.bias": r(d), "ln_post.weight": r(d), "ln_post.bias": r(d), "proj": r(d, 512)}
    for i in range(cfg.layers):
        pre = f"transformer.resblocks.{i}"
        sd[f"{pre}.attn.in_proj_weight"], sd[f"{pre}.attn.in_proj_bias"] = r(3 * d, d), r(3 * d)
        sd[f"{pre}.attn.out_proj.weight"], sd[f"{pre}.attn.out_proj.bias"] = r(d, d), r(d)
        for k in ("ln_1", "ln_2"):
            sd[f"{pre}.{k}.weight"], sd[f"{pre}.{k}.bias"] = r(d), r(d)
        sd[f"{pre}.mlp.c_fc.weight"], sd[f"{pre}.mlp.c_fc.bias"] = r(4 * d, d), r(4 * d)
        sd[f"{pre}.mlp.c_proj.weight"], sd[f"{pre}.mlp.c_proj.bias"] = r(d, 4 * d), r(d)
    return sd


def _load_both(kind, case, module_prefix=False):
    """The same state dict through both loaders. Returns (JAX cfg, head cfg,
    port cfg, port head cfg, the JAX tree loaded, the port model loaded,
    JAX unexpected (as port names), port unexpected)."""
    jcfg, jh, pcfg, ph, jtree, model = _setup(case)
    if kind == "pretrained_swin":
        sd = _swin_2d_state_dict(jcfg, seed=3)
        jtree, junexp = JTC.load_pretrained_swin2d(jtree, sd, jcfg)
        model, punexp = PTC.load_pretrained_swin2d(model, sd, pcfg, device="cpu")
    elif kind == "pretrained_clip":
        sd = _clip_visual_state_dict(jcfg, seed=5)
        jtree, junexp = JTC.load_pretrained_clip(jtree, sd, jcfg)
        model, punexp = PTC.load_pretrained_clip(model, sd, pcfg, device="cpu")
    elif kind == "reference_clip":
        sd = _reference_state_dict(model, 9, module_prefix, clip=True)
        jtree, junexp = JTC.load_reference_clip(jtree, sd, jcfg)
        model, punexp = PTC.load_reference_clip(model, sd, pcfg, device="cpu")
    else:
        dual = jcfg.ftmode in ("multimodal", "fusion")
        sd = _reference_state_dict(model, 7, module_prefix)
        jtree, junexp = JTC.load_reference_swin(jtree, sd, dual_head=dual)
        model, punexp = PTC.load_reference_swin(model, sd, dual_head=dual, device="cpu")
    return jcfg, jh, pcfg, ph, jtree, model, [_port_name(p) for p in junexp], punexp


LOADS = [("pretrained_swin", "swin_fusion", False), ("pretrained_swin", "avs", False),
         ("reference_swin", "swin_fusion", False), ("reference_swin", "swin_fusion", True),
         ("reference_swin", "swin_videoonly", False), ("reference_swin", "avs", False),
         ("reference_swin", "avs", True), ("reference_swin", "avqa", False),
         ("reference_swin", "avqa", True), ("pretrained_clip", "clip_fusion", False),
         ("reference_clip", "clip_fusion", False), ("reference_clip", "clip_fusion", True)]


@pytest.mark.parametrize("kind,case,module_prefix", LOADS)
def test_loaders_match_jax_bit_for_bit(kind, case, module_prefix):
    *_, jtree, model, junexp, punexp = _load_both(kind, case, module_prefix)
    want = CV.params_from_jax(to_numpy_tree(jtree))
    got = model.state_dict()
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and torch.equal(got[k], want[k]), k
    assert punexp == junexp
    if kind.startswith("reference"):
        assert punexp == [("backbone.resblocks.0.bogus_scale" if case.startswith("clip")
                           else "backbone.layers.0.blocks.0.bogus_scale")]
    else:
        assert punexp == []


def test_pretrained_loads_keep_what_the_checkpoint_lacks():
    """Adapters, gates and temporal tables keep their values; the surgeries:
    the video patch embed inflated, the audio one the RGB mean of it; CLIP's
    audio conv the RGB sum, its audio positional embedding cropped."""
    jcfg, _, pcfg, _, _, model = _setup("swin_fusion")
    before = {k: v.clone() for k, v in model.state_dict().items()}
    sd = _swin_2d_state_dict(jcfg, seed=3)
    model, _ = PTC.load_pretrained_swin2d(model, sd, pcfg, device="cpu")
    after = model.state_dict()
    for k, v in before.items():
        if any(p in k for p in ("Adapter", "gate_", "temporal_position_bias_table")):
            assert torch.equal(after[k], v), k
    w = torch.from_numpy(sd["patch_embed.proj.weight"])
    assert torch.equal(after["backbone.patch_embed.proj.weight"][:, :, 0], w)
    assert torch.allclose(after["backbone.patch_embed_audio.proj.weight"][:, 0, 0], w.mean(1))
    jcfg, _, pcfg, _, _, model = _setup("clip_fusion")
    sd = _clip_visual_state_dict(jcfg, seed=5)
    model, _ = PTC.load_pretrained_clip(model, sd, pcfg, device="cpu")
    bb = model.backbone
    assert torch.equal(bb.conv1_audio.weight, torch.from_numpy(sd["conv1.weight"].sum(1, keepdims=True)))
    assert bb.positional_embedding.shape[0] == pcfg.num_patches + 1
    np.testing.assert_array_equal(bb.positional_embedding_audio.detach().numpy(),
                                  JTC.derive_clip_audio_pos_embed(sd["positional_embedding"], jcfg))


@pytest.mark.parametrize("case", ["swin_fusion", "clip_fusion"])
def test_shape_mismatch_raises_in_both(case):
    jcfg, _, pcfg, _, jtree, model = _setup(case)
    sd = _reference_state_dict(model, 7, clip=case.startswith("clip"))
    key = next(k for k in sd if k.endswith("ln_post.weight") or k.endswith("norm.weight"))
    sd[key] = torch.zeros(sd[key].shape[0] + 1)
    load_j = JTC.load_reference_clip if case.startswith("clip") else JTC.load_reference_swin
    load_p = PTC.load_reference_clip if case.startswith("clip") else PTC.load_reference_swin
    extra = (jcfg,) if case.startswith("clip") else ()
    with pytest.raises(ValueError, match="shape mismatch"):
        load_j(jtree, sd, *extra)
    with pytest.raises(ValueError, match="shape mismatch"):
        load_p(model, sd, *((pcfg,) if extra else ()), device="cpu")


def test_a_load_into_an_int8_tower_raises():
    for case, quantize in (("swin_fusion", quantize_swin_tower),
                           ("clip_fusion", quantize_clip_tower)):
        _, _, pcfg, _, _, model = _setup(case)
        sd = _reference_state_dict(model, 7, clip=case.startswith("clip"))
        model.backbone = quantize(model.backbone)
        load = PTC.load_reference_clip if case.startswith("clip") else PTC.load_reference_swin
        with pytest.raises(ValueError, match="int8"):
            load(model, sd, *((pcfg,) if case.startswith("clip") else ()), device="cpu")


def test_loaders_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is taken")
    _, _, pcfg, _, _, model = _setup("swin_fusion")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PTC.load_reference_swin(model, {})
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PTC.load_pretrained_swin2d(model, {}, pcfg)


def test_average_params_matches_jax():
    rng = np.random.RandomState(11)
    trees = [{"a": rng.randn(3, 4).astype(np.float32), "b": [rng.randn(5).astype(np.float32)]}
             for _ in range(3)]
    want = JTC.average_params([jax.tree_util.tree_map(jnp.asarray, tr) for tr in trees])
    got = PTC.average_params([CV.params_from_jax(tr) for tr in trees])
    ref = CV.params_from_jax(to_numpy_tree(want))
    assert sorted(got) == sorted(ref)
    for k in ref:
        assert torch.equal(got[k], ref[k]), k


def _inputs(case, pcfg, B=1, seed=7):
    rng = np.random.RandomState(seed)
    T = pcfg.num_frames
    if case.startswith("clip"):
        n = pcfg.input_resolution
        return (rng.randn(B, T, pcfg.audio_tdim, pcfg.audio_fdim).astype(np.float32),
                rng.randn(B, T, n, n, 3).astype(np.float32))
    n = pcfg.img_size
    return (rng.randn(B, T, n, n).astype(np.float32),
            rng.randn(B, T, n, n, 3).astype(np.float32))


@pytest.mark.parametrize("kind,case", [("reference_swin", "swin_fusion"),
                                       ("reference_swin", "avs"),
                                       ("reference_clip", "clip_fusion")])
def test_loaded_models_match_jax_forward(monkeypatch, kind, case):
    clear_opt_ins(monkeypatch)
    monkeypatch.setenv("STGCMA_FUSED_ATTN", "0")
    monkeypatch.setenv("STGCMA_RESIDENT_PAD", "0")
    jcfg, jh, pcfg, ph, jtree, model, _, _ = _load_both(kind, case)
    a, v = _inputs(case, pcfg)
    with torch.inference_mode():
        if case == "avs":
            ref = jax.jit(lambda p, a, v: jax_avs.apply_avs(p, jcfg, jh, a, v)[0])(jtree, a, v)
            got = apply_avs(model, pcfg, ph, t(a), t(v))[0]
        elif case.startswith("clip"):
            ref = jax.jit(lambda p, a, v: jax_ave.apply_clip_ave(p, jcfg, a, v))(jtree, a, v)
            got = apply_clip_ave(model, pcfg, t(a), t(v))
        else:
            ref = jax.jit(lambda p, a, v: jax_ave.apply_swin_ave(p, jcfg, a, v))(jtree, a, v)
            got = apply_swin_ave(model, pcfg, t(a), t(v))
    ref = np.asarray(ref)
    assert tuple(got.shape) == ref.shape and np.isfinite(ref).all()
    assert rel(got, ref) <= TOL
