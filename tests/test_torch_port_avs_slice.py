"""The port's AVSBench segmentation slice against the JAX package: the
decoder's pieces (conv2d with bias, padding and dilation, batch norm in
eval and train, bilinear resize, TPAVI, ASPP / RCU / FFB / output head),
the Swin backbone's multi-scale taps, and the whole `apply_avs` on a tiny
fusion tower, weights crossing over through `avs_from_jax`.

The tiny tower is the fusion slice's (embed 32, depths 2/2/2, heads 2/4/32,
112^2, window 7, T = 2) with a head of three stages at 28 / 14 / 7
(vis_dim 64 / 128 / 320, TPAVI at all three, channel 256): pred (B*T, 112,
112, 1). The JAX side runs with STGCMA_FUSED_ATTN=1 (the TPU's routes; on
the CPU they take their XLA mirrors), as the fusion slice's tests run it.

Tolerances (max abs error over max |ref|):
- fp32 pieces and the whole slice: 1e-5 (summation order only; the
  convolutions, TPAVI's reassociated product and the resize add in other
  orders); the updated BatchNorm statistics: 1e-6;
- bf16 serving, port against JAX's own bf16 server: 2e-2. Both round to
  bf16 at every op, at different places (torch's linear adds its bias
  before rounding, XLA's after), and the decoder is some 15 rounded layers
  deep: at this tower and weight seed 21 the largest error of the 25,088
  logits is 1.8e-2 of max |ref|, while each side's bf16 against its own
  fp32 is 1.9e-2 (port) and 1.8e-2 (JAX), so the bound sits at bf16's own
  noise floor.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from stgcma_tpu.configs import AVSHeadConfig as JaxAVSHeadConfig
from stgcma_tpu.configs import swin_tiny_test as jax_swin_tiny_test
from stgcma_tpu.models import avs as jax_avs
from stgcma_tpu.nn import decoder as jax_decoder
from stgcma_tpu.nn import swin as jax_swin
from stgcma_tpu.nn import tpavi as jax_tpavi
from stgcma_tpu.ops import conv as jax_conv
from stgcma_tpu.ops import resize as jax_resize
from stgcma_tpu.serving import MultiTaskServer as JaxServer
from stgcma_tpu_torch.checkpoint.convert import avs_from_jax, params_from_jax
from stgcma_tpu_torch.configs import AVSHeadConfig, swin_large, swin_tiny_test
from stgcma_tpu_torch.models.avs import apply_avs, init_avs, random_avs
from stgcma_tpu_torch.nn import decoder, swin, tpavi
from stgcma_tpu_torch.ops import conv, fused_attn as FA, resize
from stgcma_tpu_torch.ops import swin_block as SB
from stgcma_tpu_torch.ops.common import layernorm
from stgcma_tpu_torch.serving import MultiTaskServer

from torch_port_helpers import clear_opt_ins, rel, t, to_numpy_tree

TINY = dict(ftmode="fusion", embed_dim=32, depths=(2, 2, 2), num_heads=(2, 4, 32),
            img_size=112, num_frames=2, adapter_ratios=(0.25, 0.25, 0.25), label_dim=7)
HEAD = dict(stage_dims=(32, 64, 128), stage_resolutions=(28, 14, 7), vis_dim=(64, 128, 320),
            tpavi_stages=(0, 1, 2), audio_dim=128, num_frames=2)
TOL, TOL_STATS, TOL_BF16 = 1e-5, 1e-6, 2e-2


def _draw(rng, path, x):
    """A leaf of a JAX tree drawn from `rng`: conv kernels N(0, 1/fan_in),
    linear kernels outside the Swin backbone N(0, 1/in) (so that TPAVI's
    attention term is of the map's order), bias tables and gates N(0, 1),
    BatchNorm scales N(1, 0.5) and running variances uniform(0.5, 1.5),
    everything else N(0, 0.05^2)."""
    name = jax.tree_util.keystr(path)
    if name.endswith("['var']"):
        a = rng.uniform(0.5, 1.5, x.shape)
    elif name.endswith("['kernel']") and len(x.shape) == 4:
        a = rng.randn(*x.shape) / np.sqrt(np.prod(x.shape[:3]))
    elif name.endswith("['kernel']") and "['backbone']" not in name:
        a = rng.randn(*x.shape) / np.sqrt(x.shape[0])
    elif "bias_table" in name or "gate_" in name:
        a = rng.randn(*x.shape)
    elif "['bn']['scale']" in name:
        a = 1.0 + 0.5 * rng.randn(*x.shape)
    else:
        a = rng.randn(*x.shape) * 0.05
    return jnp.asarray(a.astype(np.float32))


def _tree(init, seed):
    rng = np.random.RandomState(seed)
    shapes = jax.eval_shape(init)
    return jax.tree_util.tree_map_with_path(lambda p, x: _draw(rng, p, x), shapes)


def _model_params(seed=13):
    cfg, hcfg = jax_swin_tiny_test(**TINY), JaxAVSHeadConfig(**HEAD)
    return cfg, hcfg, _tree(lambda: jax_avs.init_avs(jax.random.PRNGKey(0), cfg, hcfg), seed)


def _inputs(B=1, seed=7):
    rng = np.random.RandomState(seed)
    n, T = TINY["img_size"], TINY["num_frames"]
    return (rng.randn(B, T, n, n).astype(np.float32),
            rng.randn(B, T, n, n, 3).astype(np.float32))


def _port_cfgs():
    return swin_tiny_test(**TINY), AVSHeadConfig(**HEAD)


# ---------------------------------------------------------------------------
# the decoder's pieces
# ---------------------------------------------------------------------------

CONV_CASES = [  # (kernel, padding, dilation, stride, bias)
    (3, 1, 1, 1, True), (3, 3, 3, 1, True), (3, 6, 6, 1, True), (3, 12, 12, 1, True),
    (3, 18, 18, 1, True), (1, 0, 1, 1, True), (3, 1, 1, 1, False), (4, 0, 1, 4, False)]


@pytest.mark.parametrize("k,pad,dil,stride,bias", CONV_CASES)
def test_conv2d_matches_jax(k, pad, dil, stride, bias):
    """conv2d with bias (added after the product), integer padding and
    dilation, channel-last in and out, HWIO -> OIHW."""
    rng = np.random.RandomState(k + pad + dil)
    x = rng.randn(2, 20, 20, 6).astype(np.float32)
    p = {"kernel": jnp.asarray(rng.randn(k, k, 6, 5).astype(np.float32))}
    if bias:
        p["bias"] = jnp.asarray(rng.randn(5).astype(np.float32))
    ref = jax_conv.conv2d(p, jnp.asarray(x), stride=stride, padding=pad, dilation=dil)
    sd = params_from_jax(to_numpy_tree(p))
    out = conv.conv2d(sd["weight"], t(x), stride=stride, padding=pad, dilation=dil,
                      bias=sd.get("bias"))
    assert out.shape == ref.shape
    assert rel(out, ref) < TOL


def _bn(rng, c, stats_dtype=jnp.float32):
    p = {"scale": rng.randn(c) * 0.5 + 1.0, "bias": rng.randn(c) * 0.1,
         "mean": rng.randn(c) * 0.3, "var": rng.uniform(0.2, 2.0, c)}
    return {k: jnp.asarray(v.astype(np.float32)).astype(stats_dtype) for k, v in p.items()}


def _port_bn(p, dtype=torch.float32):
    m = conv.BatchNorm(p["scale"].shape[0])
    m.load_state_dict({k: v.to(dtype) for k, v in params_from_jax(
        {k: np.asarray(v.astype(jnp.float32)) for k, v in p.items()}).items()})
    return m.to(dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_batchnorm_matches_jax(dtype):
    """Inference-mode batch norm in float32, cast back; in bf16 the
    statistics stay bf16, so var + eps and its rsqrt round in bf16 on both
    sides."""
    rng = np.random.RandomState(3)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    p = _bn(rng, 12, jdt)
    x = rng.randn(2, 5, 7, 12).astype(np.float32) * 2
    ref = np.asarray(jax_conv.batchnorm(p, jnp.asarray(x).astype(jdt)).astype(jnp.float32))
    out = conv.batchnorm(_port_bn(p, tdt), t(x, tdt)).float()
    assert out.dtype == torch.float32
    assert rel(out, ref) < (TOL if dtype == "float32" else TOL_BF16)


def test_batchnorm_train_matches_jax():
    """Training mode: the biased batch variance normalizes, the momentum
    update takes the unbiased one; both statistics to 1e-6."""
    rng = np.random.RandomState(4)
    p = _bn(rng, 12)
    x = (rng.randn(2, 5, 7, 12) * 1.5 + 0.7).astype(np.float32)
    ref, ref_stats = jax_conv.batchnorm_train(p, jnp.asarray(x))
    out, stats = conv.batchnorm_train(_port_bn(p), t(x))
    assert rel(out, ref) < TOL
    for k in ("mean", "var"):
        assert rel(stats[k], ref_stats[k]) < TOL_STATS, k
    # the update moved the statistics away from the stored ones
    assert rel(stats["var"], p["var"]) > 1e-3


@pytest.mark.parametrize("align_corners", [True, False])
@pytest.mark.parametrize("hw,out", [((7, 7), (14, 14)), ((5, 9), (13, 11)), ((13, 7), (7, 4)),
                                    ((1, 3), (3, 6))])
def test_resize_bilinear_matches_jax(align_corners, hw, out):
    """Both conventions, up and down, at odd sizes, with two leading axes."""
    rng = np.random.RandomState(hw[0] * 31 + out[1])
    x = rng.randn(2, 3, *hw, 4).astype(np.float32)
    ref = jax_resize.resize_bilinear(jnp.asarray(x), *out, align_corners=align_corners)
    got = resize.resize_bilinear(t(x), *out, align_corners=align_corners)
    assert got.shape == ref.shape
    assert rel(got, ref) < TOL


def test_resize_bilinear_bf16_rounds_once():
    """bf16 in: the interpolation runs in float32 and rounds once."""
    x = torch.randn(1, 5, 6, 3, generator=torch.Generator().manual_seed(0)).to(torch.bfloat16)
    got = resize.resize_bilinear(x, 10, 12, align_corners=True)
    ref = resize.resize_bilinear(x.float(), 10, 12, align_corners=True).to(torch.bfloat16)
    assert got.dtype == torch.bfloat16 and torch.equal(got, ref)


def _tpavi_params(seed, C=16, A=8):
    return _tree(lambda: jax_tpavi.tpavi_init(jax.random.PRNGKey(0), C, A), seed)


def _port_tpavi(p, C=16, A=8):
    m = tpavi.TPAVI(C, A)
    m.load_state_dict(params_from_jax(to_numpy_tree(p)), strict=True)
    return m


@pytest.mark.parametrize("train", [False, True])
@pytest.mark.parametrize("with_audio", [True, False])
def test_tpavi_matches_jax(train, with_audio):
    """TPAVI 'dot' mode with a live W_z BatchNorm, in eval and train, with
    the audio conditioning and without it (video self-attention): z, the
    aligned audio and the updated statistics."""
    rng = np.random.RandomState(5)
    p = _tpavi_params(11)
    x = rng.randn(2, 3, 5, 6, 16).astype(np.float32)
    audio = rng.randn(2, 3, 8).astype(np.float32) if with_audio else None
    z_ref, a_ref, st_ref = jax_tpavi.tpavi_apply(
        p, jnp.asarray(x), None if audio is None else jnp.asarray(audio), train=train)
    m = _port_tpavi(p)
    with torch.no_grad():
        z, a_al, stats = tpavi.tpavi_apply(m, t(x), None if audio is None else t(audio),
                                           train=train)
    assert rel(z, z_ref) < TOL
    if with_audio:
        assert rel(a_al, a_ref) < TOL
    else:
        assert a_al is None and a_ref is None
    if train:
        for k in ("mean", "var"):
            assert rel(stats[k], st_ref[k]) < TOL_STATS, k
    else:
        assert stats is None and st_ref is None
    # the attention term is live: other audio, or another map, moves z beyond the map's own
    # change (LN(x + ...) with the map alone changed at one frame moves the others)
    with torch.no_grad():
        if with_audio:
            z2, _, _ = tpavi.tpavi_apply(m, t(x), t(rng.randn(*audio.shape)), train=train)
            assert rel(z2, z) > 1e-2
        x2 = x.copy()
        x2[:, 0] = rng.randn(*x2[:, 0].shape)
        z2, _, _ = tpavi.tpavi_apply(m, t(x2), None if audio is None else t(audio), train=train)
        assert rel(z2[:, 1:], z[:, 1:]) > 1e-2


def test_tpavi_never_forms_the_gram(monkeypatch):
    """The 'dot' product reassociates: no product of THW x THW is formed."""
    seen = []
    real = torch.matmul

    def spy(a, b):
        seen.append((tuple(a.shape), tuple(b.shape)))
        return real(a, b)
    monkeypatch.setattr(torch, "matmul", spy)
    m = _port_tpavi(_tpavi_params(1))
    x = torch.randn(1, 2, 6, 6, 16)
    for audio in (torch.randn(1, 2, 8), None):
        tpavi.tpavi_apply(m, x, audio)
    THW = 2 * 36
    assert seen and not any(a[-2] == THW and b[-1] == THW for a, b in seen)


def test_init_avs_tpavi_is_identity_plus_layernorm():
    """A fresh TPAVI (zero BN scale and bias) returns LN(x)."""
    pcfg, phcfg = _port_cfgs()
    m = init_avs(pcfg, phcfg, device="cpu")
    blk = m.avstask.tpavi_b1
    assert float(blk.W_z.bn.weight.detach().abs().max()) == 0.0
    x = torch.randn(1, 2, 4, 4, 256)
    with torch.no_grad():
        z, _, _ = tpavi.tpavi_apply(blk, x, torch.randn(1, 2, 128))
        assert rel(z, layernorm(blk.norm_layer, x)) < TOL
    # the ASPP convs are N(0, 0.01), the other convs kaiming-uniform
    assert float(m.avstask.conv1.convs[0].weight.detach().std()) < 0.02
    assert float(m.avstask.path1.resConfUnit1.conv1.weight.detach().std()) > 0.01


def _decoder_cases():
    rng = np.random.RandomState(9)
    C = 8

    def tree(fn):
        return _tree(fn, rng.randint(1 << 30))
    x = rng.randn(2, 6, 7, C).astype(np.float32)
    skip = rng.randn(2, 6, 7, C).astype(np.float32)
    key = jax.random.PRNGKey(0)
    return [
        ("aspp", tree(lambda: jax_decoder.aspp_init(key, C, 5)), decoder.ASPP(C, 5),
         jax_decoder.aspp_apply, decoder.aspp_apply, (x,)),
        ("rcu", tree(lambda: jax_decoder.rcu_init(key, C)), decoder.RCU(C),
         jax_decoder.rcu_apply, decoder.rcu_apply, (x,)),
        ("ffb", tree(lambda: jax_decoder.ffb_init(key, C)), decoder.FFB(C),
         jax_decoder.ffb_apply, decoder.ffb_apply, (x,)),
        ("ffb_skip", tree(lambda: jax_decoder.ffb_init(key, C)), decoder.FFB(C),
         jax_decoder.ffb_apply, decoder.ffb_apply, (x, skip)),
        ("output_conv", tree(lambda: jax_decoder.output_conv_init(key, C)), decoder.OutputConv(C),
         jax_decoder.output_conv_apply, decoder.output_conv_apply, (x,))]


@pytest.mark.parametrize("case", range(5), ids=["aspp", "rcu", "ffb", "ffb_skip", "output_conv"])
def test_decoder_pieces_match_jax(case):
    """ASPP (dilations 3/6/12/18 over a 6x7 map: most taps in the padding),
    the residual conv unit with its relu(x) residual, the fusion block with
    and without its skip (2x, align_corners=True), the output head (2x,
    align_corners=False)."""
    name, p, m, jax_fn, port_fn, args = _decoder_cases()[case]
    m.load_state_dict(params_from_jax(to_numpy_tree(p)), strict=True)
    ref = jax_fn(p, *map(jnp.asarray, args))
    out = port_fn(m, *map(t, args))
    assert out.shape == ref.shape, name
    assert rel(out, ref) < TOL, name


def test_rcu_adds_relu_of_its_input():
    """The residual is relu(x) (the reference's in-place ReLU), not x."""
    m = decoder.RCU(4)
    x = -torch.ones(1, 3, 3, 4)             # relu(x) = 0, convs of 0 = their biases
    with torch.no_grad():
        m.conv2.bias.fill_(0.25)
    assert torch.equal(decoder.rcu_apply(m, x), torch.full((1, 3, 3, 4), 0.25))


# ---------------------------------------------------------------------------
# the whole slice
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_reference():
    """The JAX tiny AVS's taps, eval outputs and train-mode BN state, from
    one jitted program, and the tree it ran on."""
    mp = pytest.MonkeyPatch()
    try:
        clear_opt_ins(mp)
        mp.setenv("STGCMA_FUSED_ATTN", "1")
        cfg, hcfg, params = _model_params()
        a, v = _inputs(B=1)

        def run(p, a, v):
            feats = jax_swin.backbone_apply(p["backbone"], cfg, a=a, v=v,
                                            collect_multiscale=True)
            ev = jax_avs.apply_avs(p, cfg, hcfg, a, v)
            tr = jax_avs.apply_avs(p, cfg, hcfg, a, v, train=True, return_state=True)
            return feats, ev, tr
        feats, ev, tr = jax.jit(run)(params, a, v)
        return {"params": to_numpy_tree(params), "a": a, "v": v,
                "feats": jax.tree_util.tree_map(np.asarray, feats),
                "eval": jax.tree_util.tree_map(np.asarray, ev),
                "train": jax.tree_util.tree_map(np.asarray, tr)}
    finally:
        mp.undo()


def _port_model(ref):
    pcfg, phcfg = _port_cfgs()
    return pcfg, phcfg, avs_from_jax(pcfg, phcfg, ref["params"], device="cpu")


def test_multiscale_taps_match_jax(jax_reference):
    """backbone_apply(collect_multiscale=True): each stage's visual stream
    before its downsample, the last through the final norm, which is the
    returned "v" itself; "a", "B" and "T" as JAX returns them."""
    ref = jax_reference
    pcfg, _, model = _port_model(ref)
    with torch.inference_mode():
        feats = swin.backbone_apply(model.backbone, pcfg, a=t(ref["a"]), v=t(ref["v"]),
                                    collect_multiscale=True)
    taps = feats["multi_scale"]
    assert len(taps) == len(ref["feats"]["multi_scale"]) == 3
    for i, (got, want) in enumerate(zip(taps, ref["feats"]["multi_scale"])):
        assert got.shape == want.shape, i
        assert rel(got, want) < TOL, i
    assert feats["v"] is taps[-1]
    assert rel(feats["a"], ref["feats"]["a"]) < TOL
    assert (feats["B"], feats["T"]) == (1, TINY["num_frames"])


def test_apply_avs_matches_jax(jax_reference):
    """pred, every feature map (relu'd) and every a_fea in fp32, through
    avs_from_jax."""
    ref = jax_reference
    pcfg, phcfg, model = _port_model(ref)
    FA.reset_launches()
    with torch.inference_mode():
        pred, fmaps, afeas = apply_avs(model, pcfg, phcfg, t(ref["a"]), t(ref["v"]))
    assert all(k.launches == 0 for k in FA.KERNELS)    # plain versions on the CPU
    r_pred, r_fmaps, r_afeas = ref["eval"]
    assert pred.shape == r_pred.shape == (TINY["num_frames"], 112, 112, 1)
    assert rel(pred, r_pred) < TOL
    for i, (got, want) in enumerate(zip(fmaps, r_fmaps)):
        assert got.shape == want.shape and float(got.min()) >= 0, i
        assert rel(got, want) < TOL, i
    for i, (got, want) in enumerate(zip(afeas, r_afeas)):
        assert got.shape == want.shape == (1, TINY["num_frames"], 256), i
        assert rel(got, want) < TOL, i


def test_apply_avs_train_state_matches_jax(jax_reference):
    """train=True, return_state=True: pred with batch statistics, and each
    TPAVI's momentum-updated running statistics."""
    ref = jax_reference
    pcfg, phcfg, model = _port_model(ref)
    with torch.inference_mode():
        pred, _, _, state = apply_avs(model, pcfg, phcfg, t(ref["a"]), t(ref["v"]), train=True,
                                      return_state=True)
    r_pred, _, _, r_state = ref["train"]
    assert rel(pred, r_pred) < TOL
    assert sorted(state) == sorted(r_state) == ["tpavi_b1", "tpavi_b2", "tpavi_b3"]
    for blk, st in r_state.items():
        for k in ("mean", "var"):
            assert rel(state[blk][k], st[k]) < TOL_STATS, (blk, k)
    with torch.inference_mode():
        out = apply_avs(model, pcfg, phcfg, t(ref["a"]), t(ref["v"]), return_state=True)
    assert out[3] == {}


def test_avs_server_on_cpu_matches_jax_server(monkeypatch):
    """`MultiTaskServer.add_avs` on device="cpu" (bf16 parameters, BN
    statistics and inputs; float32 numpy masks) against JAX's bf16 server."""
    clear_opt_ins(monkeypatch)
    monkeypatch.setenv("STGCMA_FUSED_ATTN", "1")
    cfg, hcfg, params = _model_params(seed=21)
    a, v = _inputs(B=1, seed=3)
    batch = {"a": a, "v": v}
    jsrv = JaxServer()
    jsrv.add_avs("avs", cfg, hcfg, params)
    ref = jsrv.predict("avs", batch)
    pcfg, phcfg = _port_cfgs()
    srv = MultiTaskServer(device="cpu")
    srv.add_avs("avs", pcfg, phcfg, avs_from_jax(pcfg, phcfg, to_numpy_tree(params), "cpu"))
    out = srv.predict("avs", batch)
    assert out.dtype == np.float32 and out.shape == ref.shape
    assert np.isfinite(out).all()
    assert rel(out, ref) < TOL_BF16


def test_avs_from_jax_round_trip():
    """Every leaf of the JAX AVS tree lands in the port's state dict, the
    BatchNorms' scale / mean / var as weight / running_mean / running_var
    and the decoder's HWIO kernels as OIHW."""
    cfg, hcfg, params = _model_params()
    pcfg, phcfg = _port_cfgs()
    model = avs_from_jax(pcfg, phcfg, to_numpy_tree(params), device="cpu")
    sd = model.state_dict()
    leaves = jax.tree_util.tree_flatten_with_path(params)[0]
    assert len(leaves) == len(sd)
    bn = params["avstask"]["tpavi_b2"]["W_z"]["bn"]
    pre = "avstask.tpavi_b2.W_z.bn."
    for jk, pk in (("scale", "weight"), ("bias", "bias"), ("mean", "running_mean"),
                   ("var", "running_var")):
        np.testing.assert_array_equal(sd[pre + pk].numpy(), np.asarray(bn[jk]))
    k = np.asarray(params["avstask"]["conv3"]["convs"][2]["kernel"])
    np.testing.assert_array_equal(sd["avstask.conv3.convs.2.weight"].numpy(),
                                  k.transpose(3, 2, 0, 1))
    assert "running_var" in dict(model.avstask.tpavi_b1.W_z.bn.named_buffers())


def test_avs_entry_points_need_a_card_unless_asked_for_the_cpu():
    """No fallback: `init_avs` and `avs_from_jax` default to the card and
    raise without one; an AVS tower must be a two-stream one."""
    pcfg, phcfg = _port_cfgs()
    with pytest.raises(ValueError, match="two-stream"):
        random_avs(swin_tiny_test(**{**TINY, "ftmode": "videoonly"}), phcfg, 0)
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_avs(pcfg, phcfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        avs_from_jax(pcfg, phcfg, {})


def test_random_avs_tpavi_and_fusion_are_live():
    """random_avs: seeded; its TPAVI BatchNorms live (non-zero scale,
    positive variances), so that zeroing every BN scale, or every fusion
    gate, moves pred."""
    pcfg, phcfg = _port_cfgs()
    m = random_avs(pcfg, phcfg, 0)
    m2 = random_avs(pcfg, phcfg, 0)
    for (n, p1), p2 in zip(m.state_dict().items(), m2.state_dict().values()):
        assert torch.equal(p1, p2), n
    bns = [mod for mod in m.modules() if isinstance(mod, conv.BatchNorm)]
    assert len(bns) == 3
    assert all(float(b.weight.detach().abs().min()) > 0 and float(b.running_var.min()) > 0
               for b in bns)
    a, v = map(t, _inputs(B=1))
    with torch.inference_mode():
        pred = apply_avs(m, pcfg, phcfg, a, v)[0]
        for b in bns:
            b.weight.zero_()
        no_tpavi = apply_avs(m, pcfg, phcfg, a, v)[0]
        m = random_avs(pcfg, phcfg, 0)
        for layer in m.backbone.layers:
            for blk in layer.blocks:
                blk.gate_v.zero_()
                blk.gate_a.zero_()
        no_gates = apply_avs(m, pcfg, phcfg, a, v)[0]
    assert rel(no_tpavi, pred) > 5e-2
    assert rel(no_gates, pred) > 1e-3


# ---------------------------------------------------------------------------
# launch counts
# ---------------------------------------------------------------------------

KERNEL_WRAPPERS = {"K1": FA.win_block, "K4": SB.swin_block, "K5": FA.win_fuse,
                   "K6": FA.bidir_fuse, "K7": FA.ffn, "K8": FA.wmsa_qkv, "K9": FA.layernorm}


def test_avs_launch_counts_match_the_forward(monkeypatch):
    """The tiny AVS at T = 5 (every temporal site over 5 tokens): the calls
    of each wrapper during apply_avs are `launches_per_forward`'s, the
    multi-scale taps adding none (the last tap is the final norm)."""
    calls = {k: 0 for k in KERNEL_WRAPPERS}
    for name, kern in KERNEL_WRAPPERS.items():
        def counted(*args, _plain=kern.plain, _name=name, **kw):
            calls[_name] += 1
            return _plain(*args, **kw)
        monkeypatch.setattr(kern, "plain", counted)
    # K9 from 2^14 elements, so that the final norm (and the tap it is) counts
    monkeypatch.setattr(FA, "LN_KERNEL_MIN_ELEMS", 1 << 14)
    pcfg = swin_tiny_test(**{**TINY, "num_frames": 5})
    phcfg = AVSHeadConfig(**{**HEAD, "num_frames": 5})
    rng = np.random.RandomState(0)
    a = rng.randn(1, 5, 112, 112).astype(np.float32)
    v = rng.randn(1, 5, 112, 112, 3).astype(np.float32)
    with torch.inference_mode():
        pred = apply_avs(random_avs(pcfg, phcfg, 0), pcfg, phcfg, t(a), t(v))[0]
    assert pred.shape == (5, 112, 112, 1)
    want = swin.launches_per_forward(pcfg, B=1, itemsize=4)
    assert calls == want
    assert want["K9"] > 0 and want["K8"] == 2 and want["K1"] == 8


def test_launch_counts_of_swin_large_avs_at_b8():
    """Swin-Large fusion at the AVS shape (T = 5, B = 8, bf16): 40 frames a
    stream. K1 at the 4 temporal and 4 windowed sites of stages 0-1 (6 / 12
    heads); K8 at the 9 + 1 temporal sites of stages 2-3 (24 / 48 heads);
    K4 at the 20 blocks of stages 2-3; K5 and K6 at the 4 blocks of stages
    0-1; K7 at the 2 stage-0 FFNs of each stream (184 MiB hidden; stage 1's
    92 MiB stays plain); K9 at each stream's patch-embed, 3 merges, 10
    stage-2/3 temporal norms and final norm."""
    cfg = swin_large(ftmode="fusion", num_frames=5)
    assert swin.launches_per_forward(cfg, B=8) == {
        "K1": 2 * 6, "K4": 20, "K5": 4, "K6": 4, "K7": 2 * 2, "K8": 2 * 10, "K9": 2 * 15}
    # T = 10 (AVE): stage 1's FFN hidden doubles to 184 MiB and takes K7 as well
    assert swin.launches_per_forward(swin_large(ftmode="fusion"), B=8)["K7"] == 8
