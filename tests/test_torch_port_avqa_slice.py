"""The port's MUSIC-AVQA slice against the JAX package: the LSTM, `mha`,
the Swin backbone's third (`nega`) stream, the whole three-output
`apply_avqa`, the served `answer_avqa` and `add_avqa`, the int8 tower and
the launch counts, weights crossing over through `avqa_from_jax`.

The tiny tower is the AVS slice's (embed 32, depths 2/2/2, heads 2/4/32,
112^2, window 7, T = 2, final grid 7): the nega stream takes K1's route at
stages 0-1 (the windowed stage 0 and the K4 stage 1, 4 heads) and LN + the
K8 core at the 32-head K4 stage 2. The head is narrow: feat_dim 128 (the
tower's width), an LSTM 64 -> 64, 4 attention heads, vocabulary 93, 42
answers. The JAX side runs with STGCMA_FUSED_ATTN=1 (the TPU's routes; on
the CPU they take their XLA mirrors), as the fusion slice's tests run it.
The JAX tree's head is drawn live: linear kernels N(0, 1/in), `word2vec`
N(0, 1), the LSTM N(0, 1/H), LayerNorm scales 1 + N(0, 0.1^2); so is
`random_avqa`'s (torch's default draws, `word2vec` N(0, 1)), whose
tanh(fc_fusion(...) * qst_feature), the input of fc_ans, stays below 0.99
in magnitude for nearly every entry (checked below): a saturated tanh would
hide the tower from out_qa, and "zeroing the gates moves out_qa" would
prove nothing.

Tolerances (max abs error over max |ref|):
- fp32 pieces (LSTM, `mha`, the three tower streams) and the three outputs
  of `apply_avqa`: 1e-5 (summation order only);
- bf16 LSTM and `mha` against JAX in bf16: 2e-2 (both round at the same
  points; fp32 sums of a different order flip a bf16 rounding here and
  there, which the 14 recurrent steps carry on);
- bf16 serving, port against JAX's own bf16 server: 2e-2, as the other
  slices' servers. Both round to bf16 at every op, at different places
  (torch's linear adds its bias before rounding, XLA's after), and the
  answer logits sit some 25 rounded layers deep: 14 LSTM steps, the
  grounding's two l2-norms and softmax, two attentions with their
  LayerNorms, three tanh. At this tower and weight seed the largest error
  of the 84 logits is 7.8e-3 of max |ref| (the test prints it), where each
  side's bf16 against its own fp32 sits at 5.7e-3 (port) and 6.1e-3 (JAX),
  bf16's own noise at this depth;
- the int8 tower (JAX `quantize_swin_tower`, its whole block on its int8
  kernel in interpret mode, reciprocal exact): the three outputs at 1e-3,
  as the int8 Swin slice's logits (measured 1.3e-4 / 1.3e-4 / 2.9e-5);
  each stream's features at 1e-2 (measured 8.1e-3 v, 2.5e-3 a, 3.8e-3
  v_nega). `rows_agree`, which holds one int8 kernel's rows, does not fit
  a whole int8 tower: there every row moves (98 of 98 in v, median 2.6e-3
  of max |ref|), since a code that one side rounds the other way in an
  early layer reaches every later row through the attentions and the
  fusions; so the streams are held by their largest error, as the int8
  Swin slice holds its logits against JAX's stock CPU path.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from stgcma_tpu.configs import AVQAHeadConfig as JaxAVQAHeadConfig
from stgcma_tpu.configs import swin_tiny_test as jax_swin_tiny_test
from stgcma_tpu.models import avqa as jax_avqa
from stgcma_tpu.nn import lstm as jax_lstm
from stgcma_tpu.nn import swin as jax_swin
from stgcma_tpu.ops import attention as jax_attention
from stgcma_tpu.ops import pallas_swin_block as PSB
from stgcma_tpu.ops import quant as jax_quant
from stgcma_tpu.serving import MultiTaskServer as JaxServer
from stgcma_tpu_torch.checkpoint.convert import avqa_from_jax, params_from_jax
from stgcma_tpu_torch.configs import AVQAHeadConfig, swin_large, swin_tiny_test
from stgcma_tpu_torch.models import avqa
from stgcma_tpu_torch.models.avqa import (answer_avqa, apply_avqa, init_avqa, qa_combined,
                                          random_avqa)
from stgcma_tpu_torch.nn import lstm, swin
from stgcma_tpu_torch.ops import attention
from stgcma_tpu_torch.ops import fused_attn as FA
from stgcma_tpu_torch.ops import swin_block as SB
from stgcma_tpu_torch.serving import MultiTaskServer

from torch_port_helpers import clear_opt_ins, exact_reciprocal, rel, t, to_numpy_tree

TINY = dict(ftmode="fusion", embed_dim=32, depths=(2, 2, 2), num_heads=(2, 4, 32),
            img_size=112, num_frames=2, adapter_ratios=(0.25, 0.25, 0.25), label_dim=7)
HEAD = dict(feat_dim=128, qst_word_embed=64, qst_hidden=64, num_frames=2)
TOL, TOL_BF16, TOL_Q, TOL_Q_FEATS = 1e-5, 2e-2, 1e-3, 1e-2
QLEN = 14


def _draw(rng, path, x):
    """A leaf of the JAX AVQA tree: bias tables and gates N(0, 1), the rest
    of the backbone N(0, 0.05^2); in the head, linear kernels (the packed
    in_proj among them) N(0, 1/in), `word2vec` N(0, 1), the LSTM's weights
    N(0, 1/H), LayerNorm scales 1 + N(0, 0.1^2), biases N(0, 0.05^2)."""
    name = jax.tree_util.keystr(path)
    if "bias_table" in name or "gate_" in name:
        a = rng.randn(*x.shape)
    elif "['backbone']" in name:
        a = rng.randn(*x.shape) * 0.05
    elif name.endswith("['kernel']"):
        a = rng.randn(*x.shape) / np.sqrt(x.shape[0])
    elif "word2vec" in name:
        a = rng.randn(*x.shape)
    elif name.endswith("['w_ih']") or name.endswith("['w_hh']"):
        a = rng.randn(*x.shape) / np.sqrt(HEAD["qst_hidden"])
    elif name.endswith("['scale']"):
        a = 1.0 + 0.1 * rng.randn(*x.shape)
    else:
        a = rng.randn(*x.shape) * 0.05
    return jnp.asarray(a.astype(np.float32))


def _model_params(seed=13):
    cfg, hcfg = jax_swin_tiny_test(**TINY), JaxAVQAHeadConfig(**HEAD)
    shapes = jax.eval_shape(lambda: jax_avqa.init_avqa(jax.random.PRNGKey(0), cfg, hcfg))
    rng = np.random.RandomState(seed)
    return cfg, hcfg, jax.tree_util.tree_map_with_path(lambda p, x: _draw(rng, p, x), shapes)


def _inputs(B=2, seed=7):
    rng = np.random.RandomState(seed)
    n, T = TINY["img_size"], TINY["num_frames"]
    return {"a": rng.randn(B, T, n, n).astype(np.float32),
            "v": rng.randn(B, T, n, n, 3).astype(np.float32),
            "v_nega": rng.randn(B, T, n, n, 3).astype(np.float32),
            "question": rng.randint(0, HEAD.get("vocab_size", 93), (B, QLEN)).astype(np.int32)}


def _port_cfgs():
    return swin_tiny_test(**TINY), AVQAHeadConfig(**HEAD)


def _port_inputs(x):
    return (t(x["a"]), t(x["v"]), t(x["v_nega"]),
            torch.from_numpy(x["question"].astype(np.int64)))


# ---------------------------------------------------------------------------
# the pieces
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype,layers", [("float32", 1), ("float32", 2), ("bfloat16", 1)])
def test_lstm_matches_jax(dtype, layers):
    """`lstm_apply`: torch's gate order, seq-first, the JAX (in, 4H) weights
    transposed to (4H, in) by `params_from_jax`; outputs and (h_n, c_n)."""
    E, H, L, Bq = 24, 16, QLEN, 3
    p = jax_lstm.lstm_init(jax.random.PRNGKey(layers), E, H, layers)
    x = np.random.RandomState(1).randn(L, Bq, E).astype(np.float32)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    ys, (h, c) = jax_lstm.lstm_apply(p, jnp.asarray(x).astype(jdt), H)
    m = lstm.LSTM(E, H, layers)
    m.load_state_dict(params_from_jax(to_numpy_tree(p)), strict=True)
    assert tuple(m.layers[0].w_ih.shape) == (4 * H, E)
    out, (ph, pc) = lstm.lstm_apply(m, t(x, tdt))
    tol = TOL if dtype == "float32" else TOL_BF16
    for got, want in ((out, ys), (ph, h), (pc, c)):
        want = np.asarray(want.astype(jnp.float32))
        assert got.dtype == tdt and got.shape == want.shape
        assert rel(got, want) < tol


def test_lstm_matches_torch_nn_lstm():
    """In fp32 the port's LSTM is torch's nn.LSTM (the reference's module)
    on the same packed weights."""
    E, H = 20, 12
    ref = torch.nn.LSTM(E, H, 2)
    m = lstm.LSTM(E, H, 2)
    with torch.no_grad():
        for i, layer in enumerate(m.layers):
            for k in ("w_ih", "w_hh", "b_ih", "b_hh"):
                getattr(layer, k).copy_(getattr(ref, f"{k.replace('w_', 'weight_').replace('b_', 'bias_')}_l{i}"))
    x = torch.randn(QLEN, 3, E)
    want, (h, c) = ref(x)
    got, (ph, pc) = lstm.lstm_apply(m, x)
    for g, w in ((got, want), (ph, h), (pc, c)):
        assert rel(g, w.detach()) < TOL


@pytest.mark.parametrize("dtype,Nk", [("float32", 2), ("float32", 10), ("bfloat16", 10)])
def test_mha_matches_jax(dtype, Nk):
    """`mha` on batch-first (B, 1, C) queries over (B, Nk, C) keys, as the QA
    head calls it, torch's packed in_proj (3C, C) from the JAX (C, 3C)."""
    C, heads, Bq = 32, 4, 3
    rng = np.random.RandomState(Nk)
    p = {"in_proj": {"kernel": jnp.asarray(rng.randn(C, 3 * C) / np.sqrt(C), jnp.float32),
                     "bias": jnp.asarray(rng.randn(3 * C) * 0.1, jnp.float32)},
         "out_proj": {"kernel": jnp.asarray(rng.randn(C, C) / np.sqrt(C), jnp.float32),
                      "bias": jnp.asarray(rng.randn(C) * 0.1, jnp.float32)}}
    q = rng.randn(Bq, 1, C).astype(np.float32)
    kv = rng.randn(Bq, Nk, C).astype(np.float32)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    ref = jax_attention.mha(p, jnp.asarray(q).astype(jdt), jnp.asarray(kv).astype(jdt),
                            jnp.asarray(kv).astype(jdt), heads)
    m = attention.MultiheadAttention(C)
    m.load_state_dict(params_from_jax(to_numpy_tree(p)), strict=True)
    assert tuple(m.in_proj.weight.shape) == (3 * C, C)
    m = m.to(tdt)
    out = attention.mha(m, t(q, tdt), t(kv, tdt), t(kv, tdt), heads)
    assert out.dtype == tdt and out.shape == (Bq, 1, C)
    assert rel(out, np.asarray(ref.astype(jnp.float32))) < (
        TOL if dtype == "float32" else TOL_BF16)


# ---------------------------------------------------------------------------
# the whole slice
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_reference():
    """The JAX tiny AVQA's three tower streams and three outputs, fp32, from
    one jitted program, and the tree it ran on."""
    mp = pytest.MonkeyPatch()
    try:
        clear_opt_ins(mp)
        mp.setenv("STGCMA_FUSED_ATTN", "1")
        cfg, hcfg, params = _model_params()
        x = _inputs()

        def run(p, a, v, vn, q):
            feats = jax_swin.backbone_apply(p["backbone"], cfg, a=a, v=v, v_nega=vn)
            return feats, jax_avqa.apply_avqa(p, cfg, hcfg, a, v, vn, q)
        feats, outs = jax.jit(run)(params, x["a"], x["v"], x["v_nega"], x["question"])
        return {"params": to_numpy_tree(params), "x": x,
                "feats": jax.tree_util.tree_map(np.asarray, feats),
                "outs": jax.tree_util.tree_map(np.asarray, outs)}
    finally:
        mp.undo()


def _port_model(ref):
    pcfg, phcfg = _port_cfgs()
    return pcfg, phcfg, avqa_from_jax(pcfg, phcfg, ref["params"], device="cpu")


def test_backbone_nega_stream_matches_jax(jax_reference):
    """backbone_apply(v_nega=): "v", "a" and "v_nega" through the final norm,
    "B" and "T", as JAX returns them."""
    ref = jax_reference
    pcfg, _, model = _port_model(ref)
    a, v, vn, _ = _port_inputs(ref["x"])
    with torch.inference_mode():
        feats = swin.backbone_apply(model.backbone, pcfg, a=a, v=v, v_nega=vn)
    for k in ("v", "a", "v_nega"):
        assert feats[k].shape == ref["feats"][k].shape == (2 * TINY["num_frames"], 49, 128), k
        assert rel(feats[k], ref["feats"][k]) < TOL, k
    assert (feats["B"], feats["T"]) == (2, TINY["num_frames"])
    # the third stream is the negative frames' own: v and a do not read it
    with torch.inference_mode():
        two = swin.backbone_apply(model.backbone, pcfg, a=a, v=v)
    assert torch.equal(two["v"], feats["v"]) and torch.equal(two["a"], feats["a"])


def test_apply_avqa_matches_jax(jax_reference):
    """out_qa (B, 42), out_match_posi and out_match_nega (B*T, 2) in fp32,
    through avqa_from_jax, on the plain versions."""
    ref = jax_reference
    pcfg, phcfg, model = _port_model(ref)
    FA.reset_launches()
    with torch.inference_mode():
        outs = apply_avqa(model, pcfg, phcfg, *_port_inputs(ref["x"]))
    assert all(k.launches == 0 for k in FA.KERNELS)    # plain versions on the CPU
    shapes = ((2, 42), (2 * TINY["num_frames"], 2), (2 * TINY["num_frames"], 2))
    for got, want, shape in zip(outs, ref["outs"], shapes):
        assert got.shape == want.shape == shape
        assert rel(got, want) < TOL


def test_answer_avqa_is_apply_avqa_without_the_nega_stream(jax_reference, monkeypatch):
    """`answer_avqa` returns apply_avqa(...)[0] bit for bit, and runs no nega
    block, no nega patch embed and no match MLP (spies on `_nega_block` and
    `_match`); apply_avqa runs the nega stream at every block."""
    ref = jax_reference
    pcfg, phcfg, model = _port_model(ref)
    calls = {"nega": 0, "match": 0}
    nega_block, match = swin._nega_block, avqa._match

    def spy_nega(*args, **kw):
        calls["nega"] += 1
        return nega_block(*args, **kw)

    def spy_match(*args, **kw):
        calls["match"] += 1
        return match(*args, **kw)
    monkeypatch.setattr(swin, "_nega_block", spy_nega)
    monkeypatch.setattr(avqa, "_match", spy_match)
    a, v, vn, q = _port_inputs(ref["x"])
    with torch.inference_mode():
        served = answer_avqa(model, pcfg, phcfg, a, v, q)
        assert calls == {"nega": 0, "match": 0}
        full = apply_avqa(model, pcfg, phcfg, a, v, vn, q)
    assert calls == {"nega": sum(TINY["depths"]), "match": 2}
    assert torch.equal(served, full[0])


def _jax_server(cfg, hcfg, params, x):
    jsrv = JaxServer()
    jsrv.add_avqa("avqa", cfg, hcfg, params)
    return jsrv.predict("avqa", x)


def test_avqa_server_on_cpu_matches_jax_server(monkeypatch):
    """`MultiTaskServer.add_avqa` on device="cpu" (bf16 parameters and
    frames, the question as int32, float32 numpy answers) against JAX's bf16
    server on the same tree; the measured error is printed."""
    clear_opt_ins(monkeypatch)
    monkeypatch.setenv("STGCMA_FUSED_ATTN", "1")
    cfg, hcfg, params = _model_params(seed=21)
    x = _inputs(seed=3)
    ref = _jax_server(cfg, hcfg, params, x)
    pcfg, phcfg = _port_cfgs()
    srv = MultiTaskServer(device="cpu")
    srv.add_avqa("avqa", pcfg, phcfg, avqa_from_jax(pcfg, phcfg, to_numpy_tree(params), "cpu"))
    out = srv.predict("avqa", x)
    assert out.dtype == np.float32 and out.shape == ref.shape == (2, 42)
    assert np.isfinite(out).all()
    err = rel(out, ref)
    print(f"bf16 server, port vs JAX: {err:.3g} of max |ref|")
    assert err < TOL_BF16


def test_jax_server_program_drops_the_nega_stream(monkeypatch):
    """What `answer_avqa` mirrors: the JAX server jits `apply_avqa(...)[0]`,
    and its lowered program holds 2 convolutions (the v and a patch embeds)
    where the full three-output function holds 3 (v_nega's too): out_qa
    reads neither the nega stream nor the match heads, so XLA drops them."""
    clear_opt_ins(monkeypatch)
    monkeypatch.setenv("STGCMA_FUSED_ATTN", "1")
    cfg, hcfg, params = _model_params()
    x = _inputs(B=1)
    args = (params, x["a"], x["v"], x["v_nega"], x["question"])

    def convolutions(fn):
        return jax.jit(fn).lower(*args).as_text().count("stablehlo.convolution")
    served = convolutions(lambda p, a, v, vn, q: jax_avqa.apply_avqa(p, cfg, hcfg, a, v, vn, q)[0])
    full = convolutions(lambda p, a, v, vn, q: jax_avqa.apply_avqa(p, cfg, hcfg, a, v, vn, q))
    assert (served, full) == (2, 3)


def test_avqa_server_reads_only_its_inputs(monkeypatch):
    """The server copies a, v and the question, not v_nega (which out_qa does
    not read), and takes the question as int32 or int64 without a cast."""
    pcfg, phcfg = _port_cfgs()
    srv = MultiTaskServer(device="cpu")
    srv.add_avqa("avqa", pcfg, phcfg, random_avqa(pcfg, phcfg, 0))
    x = _inputs(B=1)
    seen = []
    as_tensor = torch.as_tensor

    def spy(data, *args, **kw):
        seen.append(id(data))
        return as_tensor(data, *args, **kw)
    monkeypatch.setattr(torch, "as_tensor", spy)
    out32 = srv.predict("avqa", x)
    assert id(x["v_nega"]) not in seen and len(seen) == 3
    out64 = srv.predict("avqa", {**x, "question": x["question"].astype(np.int64)})
    assert np.array_equal(out32, out64) and out32.shape == (1, 42)


@pytest.fixture(scope="module")
def jax_int8_reference():
    """The JAX tiny AVQA with its tower made int8 by `quantize_swin_tower`,
    its whole block on the int8 kernel in interpret mode, reciprocal exact:
    the three streams and the three outputs, fp32."""
    mp = pytest.MonkeyPatch()
    try:
        clear_opt_ins(mp)
        exact_reciprocal(mp)
        mp.setenv("STGCMA_FUSED_ATTN", "1")

        def whole_block(p, v, a, st):
            return PSB._fullgrid_pallas(p, v, a, (st.H, st.W, st.window_size, st.shift_size,
                                                  st.num_heads), winmajor=False)
        mp.setattr(PSB, "swin_fusion_whole_block", whole_block)
        cfg, hcfg, params = _model_params(seed=5)
        params = dict(params)
        params["backbone"] = jax_quant.quantize_swin_tower(params["backbone"])
        x = _inputs(B=1, seed=9)

        def run(p, a, v, vn, q):
            feats = jax_swin.backbone_apply(p["backbone"], cfg, a=a, v=v, v_nega=vn)
            return feats, jax_avqa.apply_avqa(p, cfg, hcfg, a, v, vn, q)
        feats, outs = jax.jit(run)(params, x["a"], x["v"], x["v_nega"], x["question"])
        return {"params": to_numpy_tree(params), "x": x,
                "feats": jax.tree_util.tree_map(np.asarray, feats),
                "outs": jax.tree_util.tree_map(np.asarray, outs)}
    finally:
        mp.undo()


def test_int8_tower_matches_jax(jax_int8_reference):
    """The int8 tree loads into an int8 port tower (`QLinear`s); the three
    streams within 1e-2, the three outputs within 1e-3."""
    ref = jax_int8_reference
    pcfg, phcfg, model = _port_model(ref)
    assert model.backbone.layers[0].blocks[0].mlp.fc1.quantized
    a, v, vn, q = _port_inputs(ref["x"])
    with torch.inference_mode():
        feats = swin.backbone_apply(model.backbone, pcfg, a=a, v=v, v_nega=vn)
        outs = apply_avqa(model, pcfg, phcfg, a, v, vn, q)
    for k in ("v", "a", "v_nega"):
        assert rel(feats[k], ref["feats"][k]) < TOL_Q_FEATS, k
    for got, want in zip(outs, ref["outs"]):
        assert got.shape == want.shape
        assert rel(got, want) < TOL_Q


def test_avqa_from_jax_round_trip():
    """Every leaf of the JAX AVQA tree lands in the port's state dict: the
    LSTM's (in, 4H) weights as (4H, in), in_proj's (C, 3C) as (3C, C),
    `word2vec` as it is."""
    cfg, hcfg, params = _model_params()
    pcfg, phcfg = _port_cfgs()
    model = avqa_from_jax(pcfg, phcfg, to_numpy_tree(params), device="cpu")
    sd = model.state_dict()
    assert len(jax.tree_util.tree_leaves(params)) == len(sd)
    hp = params["avqatask"]
    lay = hp["question_encoder"]["lstm"]["layers"][0]
    pre = "avqatask.question_encoder."
    np.testing.assert_array_equal(sd[pre + "lstm.layers.0.w_ih"].numpy(), np.asarray(lay["w_ih"]).T)
    np.testing.assert_array_equal(sd[pre + "lstm.layers.0.w_hh"].numpy(), np.asarray(lay["w_hh"]).T)
    np.testing.assert_array_equal(sd[pre + "word2vec"].numpy(),
                                  np.asarray(hp["question_encoder"]["word2vec"]))
    np.testing.assert_array_equal(sd["avqatask.attn_v.in_proj.weight"].numpy(),
                                  np.asarray(hp["attn_v"]["in_proj"]["kernel"]).T)


def test_init_avqa_matches_the_jax_init_statistics():
    """`init_avqa` draws as the JAX `init_avqa` does: trunc_normal(0.02)
    head linears with zero biases, uniform(+-1/sqrt(H)) LSTM, unit
    LayerNorms; seeded by its generator."""
    pcfg, phcfg = _port_cfgs()
    m = init_avqa(pcfg, phcfg, torch.Generator().manual_seed(1), device="cpu").requires_grad_(False)
    hp = m.avqatask
    assert float(hp.fc_gl.weight.abs().max()) <= 0.04 and float(hp.fc_gl.bias.abs().max()) == 0
    assert float(hp.attn_a.in_proj.weight.abs().max()) <= 0.04
    w = hp.question_encoder.lstm.layers[0].w_hh
    assert float(w.abs().max()) <= HEAD["qst_hidden"] ** -0.5
    assert torch.equal(hp.norm1.weight, torch.ones(HEAD["feat_dim"]))
    m2 = init_avqa(pcfg, phcfg, torch.Generator().manual_seed(1), device="cpu")
    assert all(torch.equal(p, q) for p, q in zip(m.state_dict().values(),
                                                 m2.state_dict().values()))


def test_avqa_entry_points_need_a_card_unless_asked_for_the_cpu():
    """No fallback: `init_avqa` and `avqa_from_jax` default to the card and
    raise without one; AVQA takes a fusion tower whose width is feat_dim."""
    pcfg, phcfg = _port_cfgs()
    with pytest.raises(ValueError, match="fusion"):
        random_avqa(swin_tiny_test(**{**TINY, "ftmode": "multimodal"}), phcfg, 0)
    with pytest.raises(ValueError, match="feat_dim"):
        random_avqa(pcfg, AVQAHeadConfig(**{**HEAD, "feat_dim": 64}), 0)
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_avqa(pcfg, phcfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        avqa_from_jax(pcfg, phcfg, {})


def test_random_avqa_is_live():
    """random_avqa: seeded; |tanh(fc_fusion(...) * qst_feature)| < 0.99 for
    at least 95% of the entries; zeroing the fusion gates moves out_qa;
    changing v_nega moves out_match_nega only (out_qa and out_match_posi
    bit-identical)."""
    pcfg, phcfg = _port_cfgs()
    m = random_avqa(pcfg, phcfg, 0)
    m2 = random_avqa(pcfg, phcfg, 0)
    assert all(torch.equal(p, q) for p, q in zip(m.state_dict().values(),
                                                 m2.state_dict().values()))
    a, v, vn, q = _port_inputs(_inputs())
    hp = m.avqatask
    with torch.inference_mode():
        feats = swin.backbone_apply(m.backbone, pcfg, a=a, v=v)
        audio_feat = avqa.audio_features(hp, feats["a"])
        qst = avqa.apply_qst_encoder(hp.question_encoder, q, phcfg)
        grd = avqa._grounding(hp, audio_feat, feats["v"], phcfg)
        combined = qa_combined(hp, phcfg, qst, grd, audio_feat, 2, TINY["num_frames"])
        assert float((combined.abs() < 0.99).float().mean()) >= 0.95
        outs = apply_avqa(m, pcfg, phcfg, a, v, vn, q)
        moved = apply_avqa(m, pcfg, phcfg, a, v, vn * 0.5 + 0.3, q)
        for layer in m2.backbone.layers:
            for blk in layer.blocks:
                blk.gate_v.zero_()
                blk.gate_a.zero_()
        no_gates = answer_avqa(m2, pcfg, phcfg, a, v, q)
    assert torch.equal(moved[0], outs[0]) and torch.equal(moved[1], outs[1])
    assert rel(moved[2], outs[2]) > 1e-2
    assert rel(no_gates, outs[0]) > 1e-3


def test_random_avqa_int8_is_the_quantized_float_model():
    pcfg, phcfg = _port_cfgs()
    q = random_avqa(pcfg, phcfg, 3, int8=True)
    f = random_avqa(pcfg, phcfg, 3)
    from stgcma_tpu_torch.ops.quant import quantize_swin_tower
    ref = quantize_swin_tower(f.backbone).state_dict()
    for k, val in q.backbone.state_dict().items():
        assert torch.equal(val, ref[k]), k
    assert all(torch.equal(p, r) for p, r in zip(q.avqatask.state_dict().values(),
                                                 f.avqatask.state_dict().values()))


# ---------------------------------------------------------------------------
# launch counts
# ---------------------------------------------------------------------------

KERNEL_WRAPPERS = {"K1": [FA.win_block], "K2": [FA.win_block_q], "K3": [FA.ffn_q],
                   "K4": [SB.swin_block, SB.swin_block_q], "K5": [FA.win_fuse],
                   "K6": [FA.bidir_fuse], "K7": [FA.ffn], "K8": [FA.wmsa_qkv],
                   "K9": [FA.layernorm]}


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("nega", [False, True])
def test_launch_counts_match_the_forward(monkeypatch, int8, nega):
    """The wrappers' calls during `apply_avqa` (nega) or `answer_avqa` are
    `launches_per_forward(nega=...)`'s, with K7 and K9 taken at every site
    (their thresholds lowered to 0); the head calls no wrapper."""
    calls = {k: 0 for k in KERNEL_WRAPPERS}
    for name, kerns in KERNEL_WRAPPERS.items():
        for kern in kerns:
            def counted(*args, _plain=kern.plain, _name=name, **kw):
                calls[_name] += 1
                return _plain(*args, **kw)
            monkeypatch.setattr(kern, "plain", counted)
    monkeypatch.setattr(FA, "LN_KERNEL_MIN_ELEMS", 0)
    monkeypatch.setattr(FA, "FFN_KERNEL_MIN_HIDDEN_BYTES", 0)
    pcfg, phcfg = _port_cfgs()
    m = random_avqa(pcfg, phcfg, 0, int8=int8)
    a, v, vn, q = _port_inputs(_inputs(B=1))
    with torch.inference_mode():
        out = apply_avqa(m, pcfg, phcfg, a, v, vn, q)[0] if nega else answer_avqa(
            m, pcfg, phcfg, a, v, q)
    assert out.shape == (1, 42)
    want = swin.launches_per_forward(pcfg, B=1, itemsize=4, quantized=int8, nega=nega)
    assert {k: n for k, n in calls.items() if n or k in want} == want
    blk = "K2" if int8 else "K1"
    # two streams, each: 4 K1 / K2 sites (3 temporal, 1 window at stage 0), 1 K8 (the
    # stage 2 temporal site), 2 FFNs (stage 0), 5 norms (embed, 2 merges, the stage 2
    # temporal norm, final); the nega stream: 4 K1 / K2 window sites (stages 0-1), 2 K8
    # (stage 2 windows), 6 FFNs, 4 norms
    assert want[blk] == 8 + 4 * nega and want["K8"] == 2 + 2 * nega
    assert want["K3" if int8 else "K7"] == 4 + 6 * nega and want["K9"] == 2 * 5 + 4 * nega


def test_launch_counts_of_swin_large_avqa_at_b8():
    """Swin-Large fusion at the AVQA shape (T = 10, B = 8: 80 frames a
    stream). Served (two streams): K1 at the 4 temporal and 4 windowed sites
    of stages 0-1 a stream, K4 20, K5 4, K6 4, K7 at the 4 stage 0-1 FFNs a
    stream, K8 at the 10 stage 2-3 temporal sites a stream, K9 15 a stream.
    The nega stream adds K1 at its 4 stage 0-1 window sites, K7 at its 4
    stage 0-1 FFNs (its stage 2-3 FFNs stay under the 96 MiB route: 92 MiB
    at stage 2), the K8 site at its 20 stage 2-3 windows (shifted at stage
    2: bias period 4 windows x 24 heads) and K9 at 5 norms; on the int8
    tower K3 at all 24 of its FFNs."""
    cfg = swin_large(ftmode="fusion")
    served = {"K1": 12, "K4": 20, "K5": 4, "K6": 4, "K7": 8, "K8": 20, "K9": 30}
    assert swin.launches_per_forward(cfg, B=8) == served
    assert swin.launches_per_forward(cfg, B=8, nega=True) == {
        **served, "K1": 16, "K7": 12, "K8": 40, "K9": 35}
    assert swin.launches_per_forward(cfg, B=8, quantized=True, nega=True) == {
        "K2": 16, "K3": 8 + 24, "K4": 20, "K5": 4, "K6": 4, "K8": 40, "K9": 35}
    with pytest.raises(ValueError, match="fusion"):
        swin.launches_per_forward(swin_large(ftmode="multimodal"), B=8, nega=True)
