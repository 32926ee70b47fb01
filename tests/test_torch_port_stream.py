"""The port's streaming serving against the JAX package's, on the CPU.

`serve_stream` runs the WAVs of tests/fixtures/ave/raw_audio with seeded
uint8 frames, 5 requests at batch_size 2 (a padded tail of 1), through
`HostDecoder` (the native decoder where native/libstgcma_host.so is built,
scipy where not, the same one on both sides), the evaluation device
pipelines and the server, on a tiny fp32 Swin fusion AVE and a tiny AVQA
with question ids as extras; the JAX `serve_stream` runs the same weights.
The same request ids must come back in the same order, and the outputs
agree to 1e-4 of max |ref|: the JAX pipeline is jitted, and XLA orders its
resize's source coordinates otherwise (6.3e-5 on the frames,
tests/test_torch_port_preprocess.py), which the fp32 towers carry to the
logits. Also: the decoder's errors, `frame_paths` through PIL, OpenCV's
`video_requests`, `share_frozen_tower` on the served models, `predict` on
tensors, and the native binding (skipped where the library is not built).
"""
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import torch_port_helpers  # noqa: F401  (two torch threads a process)
from stgcma_tpu import configs as JC
from stgcma_tpu import serving as JS
from stgcma_tpu.data import loader as JL
from stgcma_tpu.data import native_io as JN
from stgcma_tpu.models import ave as jax_ave
from stgcma_tpu.models import avqa as jax_avqa
from stgcma_tpu.ops import fbank as JF
from stgcma_tpu_torch import configs as PC
from stgcma_tpu_torch import serving as PS
from stgcma_tpu_torch.checkpoint import convert as CV
from stgcma_tpu_torch.data import loader as PL
from stgcma_tpu_torch.data import native_io as PN
from stgcma_tpu_torch.ops import fbank as PF
from stgcma_tpu_torch.ops.quant import quantize_swin_tower
from stgcma_tpu_torch.train.optim import label

from torch_port_helpers import clear_opt_ins, rel, to_numpy_tree

FIX = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures", "ave")
WAVS = sorted(os.path.join(FIX, "raw_audio", f) for f in os.listdir(os.path.join(FIX, "raw_audio")))
JPGS = sorted(os.path.join(FIX, "video_frames", "fx_e5f6", f)
              for f in os.listdir(os.path.join(FIX, "video_frames", "fx_e5f6")))[:2]
SWIN = dict(ftmode="fusion", num_frames=2, label_dim=7)
AVQA_HEAD = dict(feat_dim=32, qst_word_embed=16, qst_hidden=16, num_frames=2)
TOL = 1e-4
N_REQ, BATCH = 5, 2


def _tree(init, seed):
    rng = np.random.RandomState(seed)

    def draw(path, x):
        name = jax.tree_util.keystr(path)
        scale = 1.0 if "gate_" in name or "word2vec" in name else 0.05
        return jnp.asarray((rng.randn(*x.shape) * scale).astype(np.float32))
    return jax.tree_util.tree_map_with_path(draw, jax.eval_shape(init))


def _requests(module, task, extras=False, hw=64):
    rng = np.random.RandomState(0)
    return [module.StreamRequest(
        task=task, wav_path=WAVS[i % len(WAVS)], rid=i,
        frames=rng.randint(0, 256, (SWIN["num_frames"], hw, hw, 3), dtype=np.uint8),
        extras={"question": rng.randint(0, 93, (14,)).astype(np.int64)} if extras else None)
        for i in range(N_REQ)]


def _check_stream(jouts, pouts, rows_per_req):
    assert [r for r, _ in pouts] == [r for r, _ in jouts]
    assert [r for rids, _ in pouts for r in rids] == list(range(N_REQ))
    for (rids, p), (_, j) in zip(pouts, jouts):
        assert p.shape == j.shape == (len(rids) * rows_per_req, p.shape[1])
        assert p.dtype == np.float32 and np.isfinite(p).all()
    got = np.concatenate([p for _, p in pouts])
    ref = np.concatenate([j for _, j in jouts])
    assert rel(got, ref) <= TOL, rel(got, ref)


def test_serve_stream_swin_ave_matches_jax(monkeypatch):
    clear_opt_ins(monkeypatch)
    jcfg, pcfg = JC.swin_tiny_test(**SWIN), PC.swin_tiny_test(**SWIN)
    tree = _tree(lambda: jax_ave.init_swin_ave(jax.random.PRNGKey(0), jcfg), 3)
    n = jcfg.img_size
    jsrv = JS.MultiTaskServer(dtype=jnp.float32)
    jsrv.add_ave("ave", jcfg, tree)
    jpipe = JL.make_ave_device_pipeline(JF.FbankConfig(num_mel_bins=n), n, image_size=n)
    jouts = list(JS.serve_stream(
        jsrv, {"ave": lambda h: dict(zip("av", jpipe({"frames": h["frames"], "wave": h["wave"]})))},
        _requests(JS, "ave"), batch_size=BATCH, decoder=JS.HostDecoder(num_segments=2)))

    psrv = PS.MultiTaskServer(dtype=torch.float32, device="cpu")
    psrv.add_ave("ave", pcfg, CV.swin_ave_from_jax(pcfg, to_numpy_tree(tree), "cpu"))
    ppipe = PL.make_ave_device_pipeline(PF.FbankConfig(num_mel_bins=n), n, image_size=n,
                                        device="cpu")
    stats = []
    dec = PS.HostDecoder(num_segments=2)
    assert dec.native == JN.available() == PN.available()
    pouts = list(PS.serve_stream(psrv, {"ave": lambda h: dict(zip("av", ppipe(h)))},
                                 _requests(PS, "ave"), batch_size=BATCH, decoder=dec,
                                 device="cpu", stats=stats))
    _check_stream(jouts, pouts, jcfg.num_frames)
    assert [s["n"] for s in stats] == [2, 2, 1]
    per_req = 2 * 64 * 64 * 3 + 2 * 16000 * 4          # uint8 frames + float32 waves
    assert all(s["h2d_bytes"] == BATCH * per_req and min(s["decode_ms"], s["stage_ms"]) >= 0
               for s in stats)


def test_serve_stream_avqa_with_question_extras_matches_jax(monkeypatch):
    clear_opt_ins(monkeypatch)
    jcfg, pcfg = JC.swin_tiny_test(**SWIN), PC.swin_tiny_test(**SWIN)
    jh, ph = JC.AVQAHeadConfig(**AVQA_HEAD), PC.AVQAHeadConfig(**AVQA_HEAD)
    tree = _tree(lambda: jax_avqa.init_avqa(jax.random.PRNGKey(0), jcfg, jh), 5)
    n = jcfg.img_size
    fb = dict(num_mel_bins=n, frame_shift_ms=4.4)
    jsrv = JS.MultiTaskServer(dtype=jnp.float32)
    jsrv.add_avqa("avqa", jcfg, jh, tree)
    jpipe = JL.make_avqa_device_pipeline(JF.FbankConfig(**fb), n, image_size=n)

    def jax_batch(h):            # out_qa reads no v_nega; JAX's server takes one
        a, v = jpipe({"frames": h["frames"], "wave": h["wave"]})
        return {"a": a, "v": v, "v_nega": v, "question": h["question"]}
    jouts = list(JS.serve_stream(jsrv, {"avqa": jax_batch}, _requests(JS, "avqa", True),
                                 batch_size=BATCH, decoder=JS.HostDecoder(num_segments=2)))

    psrv = PS.MultiTaskServer(dtype=torch.float32, device="cpu")
    psrv.add_avqa("avqa", pcfg, ph, CV.avqa_from_jax(pcfg, ph, to_numpy_tree(tree), "cpu"))
    ppipe = PL.make_avqa_device_pipeline(PF.FbankConfig(**fb), n, image_size=n, device="cpu")

    def port_batch(h):
        assert h["question"].dtype == torch.int64 and h["frames"].dtype == torch.uint8
        a, v = ppipe(h)
        return {"a": a, "v": v, "question": h["question"]}
    pouts = list(PS.serve_stream(psrv, {"avqa": port_batch}, _requests(PS, "avqa", True),
                                 batch_size=BATCH, decoder=PS.HostDecoder(num_segments=2),
                                 device="cpu"))
    _check_stream(jouts, pouts, 1)


def test_decoder_errors():
    """Heterogeneous extras within a micro-batch, and a request with neither
    frames nor frame_paths, raise; homogeneous extras stack."""
    dec = PS.HostDecoder(num_segments=2)
    frames = np.zeros((2, 16, 16, 3), np.uint8)
    q = np.zeros((14,), np.int64)
    mixed = [[PS.StreamRequest("avqa", WAVS[0], frames, {"question": q}, 0),
              PS.StreamRequest("avqa", WAVS[0], frames, None, 1)],
             [PS.StreamRequest("avqa", WAVS[0], frames, {"question": q}, 0),
              PS.StreamRequest("avqa", WAVS[0], frames, {"other": q}, 1)]]
    for reqs in mixed:
        with pytest.raises(ValueError, match="heterogeneous extras"):
            dec(reqs)
    batch = dec([PS.StreamRequest("avqa", WAVS[0], frames, {"question": q}, i) for i in range(2)])
    assert batch["question"].shape == (2, 14) and batch["wave"].shape == (2, 2, 16000)
    with pytest.raises(ValueError, match="rid=7"):
        dec([PS.StreamRequest("ave", WAVS[0], rid=7)])


def test_frame_paths_through_pil(monkeypatch):
    """Without the native image decoder, frame_paths decode through PIL at
    the staging geometry, as the JAX decoder's PIL path does, bit for bit."""
    from PIL import Image
    monkeypatch.setattr(PN, "image_available", lambda: False)
    monkeypatch.setattr(JN, "image_available", lambda: False)
    reqs = [PS.StreamRequest("ave", WAVS[0], frame_paths=JPGS, rid=0),
            PS.StreamRequest("ave", WAVS[1], rid=1,
                             frames=np.full((2, 48, 40, 3), 7, np.uint8))]
    got = PS.HostDecoder(num_segments=2, frame_hw=(48, 40))(reqs)
    ref = JS.HostDecoder(num_segments=2, frame_hw=(48, 40))(
        [JS.StreamRequest(r.task, r.wav_path, r.frames, r.extras, r.rid, r.frame_paths)
         for r in reqs])
    assert got["frames"].shape == (2, 2, 48, 40, 3)
    np.testing.assert_array_equal(got["frames"], ref["frames"])
    np.testing.assert_array_equal(got["wave"], ref["wave"])
    with Image.open(JPGS[1]) as im:
        want = np.asarray(im.convert("RGB").resize((40, 48), Image.BILINEAR), np.uint8)
    np.testing.assert_array_equal(got["frames"][0, 1], want)


def test_video_requests_match_jax(tmp_path):
    cv2 = pytest.importorskip("cv2")
    rng = np.random.RandomState(0)
    vids = []
    for k in range(2):
        p = str(tmp_path / f"clip{k}.mp4")
        w = cv2.VideoWriter(p, cv2.VideoWriter_fourcc(*"mp4v"), 4.0, (64, 48))
        assert w.isOpened()
        for _ in range(12):
            w.write(rng.randint(0, 255, (48, 64, 3), dtype=np.uint8))
        w.release()
        vids.append(p)
    items = [(vids[i], WAVS[i], {"question": np.arange(3)}) for i in range(2)]
    got = list(PS.video_requests("ave", items, num_frames=3, frame_hw=(32, 40), start_rid=5))
    ref = list(JS.video_requests("ave", items, num_frames=3, frame_hw=(32, 40), start_rid=5))
    assert [r.rid for r in got] == [5, 6] == [r.rid for r in ref]
    for g, r in zip(got, ref):
        assert g.frames.shape == (3, 32, 40, 3) and g.wav_path == r.wav_path
        np.testing.assert_array_equal(g.frames, r.frames)
        assert g.extras is r.extras
    with pytest.raises(ValueError, match="cannot open"):
        list(PS.video_requests("ave", [(str(tmp_path / "missing.mp4"), WAVS[0])]))


def _shared(canonical, other):
    """The backbone names whose tensor is the canonical model's."""
    canon = dict(canonical.backbone.named_parameters())
    canon.update(canonical.backbone.named_buffers())
    mine = dict(other.backbone.named_parameters())
    mine.update(other.backbone.named_buffers())
    return {k for k, v in mine.items() if k in canon and v is canon[k]}


def _jax_shared(canonical, other):
    """The same set from the JAX `share_frozen_tower`, in the port's names."""
    rename = {"kernel": "weight", "scale": "weight", "mean": "running_mean",
              "var": "running_var", "kernel_q": "weight_q", "kernel_s": "weight_s"}
    out = JS.share_frozen_tower(canonical, {"o": other})["o"]
    flat = jax.tree_util.tree_flatten_with_path
    canon = {jax.tree_util.keystr(p): x for p, x in flat(canonical["backbone"])[0]}
    shared = set()
    for p, x in flat(out["backbone"])[0]:
        if canon.get(jax.tree_util.keystr(p)) is x:
            parts = [str(getattr(k, "key", getattr(k, "idx", k))) for k in p]
            shared.add(".".join(parts[:-1] + [rename.get(parts[-1], parts[-1])]))
    return shared


@pytest.mark.parametrize("int8", [False, True])
def test_share_frozen_tower_on_the_served_models(int8):
    """Two tasks on one frozen tower (an AVE and an AVS model, the second's
    adapters, gates, head and BatchNorm statistics its own): after sharing,
    every frozen leaf of the served AVS model whose name and shape match is
    the AVE model's tensor (the same storage), exactly the leaves the JAX
    `share_frozen_tower` aliases; nothing else is; the logits do not move.
    With the AVS tower int8, only its leaves that the float tower also holds
    (LayerNorms, biases, tables, patch embeds) are shared."""
    from stgcma_tpu.models import avs as jax_avs
    from stgcma_tpu_torch.models.avs import AVSModel
    head = dict(stage_dims=(16, 32), stage_resolutions=(14, 7), vis_dim=(64, 128),
                tpavi_stages=(0, 1), audio_dim=32, num_frames=2)
    jcfg, pcfg = JC.swin_tiny_test(**SWIN), PC.swin_tiny_test(**SWIN)
    ave_tree = _tree(lambda: jax_ave.init_swin_ave(jax.random.PRNGKey(0), jcfg), 3)
    avs_tree = _tree(lambda: jax_avs.init_avs(jax.random.PRNGKey(0), jcfg,
                                              JC.AVSHeadConfig(**head)), 4)
    # the AVS task fine-tuned from the same frozen tower: its frozen leaves are the AVE's
    ave_model = CV.swin_ave_from_jax(pcfg, to_numpy_tree(ave_tree), "cpu")
    avs_model = CV.avs_from_jax(pcfg, PC.AVSHeadConfig(**head), to_numpy_tree(avs_tree), "cpu")
    with torch.no_grad():
        canon = dict(ave_model.backbone.named_parameters())
        for k, v in avs_model.backbone.named_parameters():
            if label(f"backbone.{k}") == "frozen":
                v.copy_(canon[k])
    if int8:
        avs_model.backbone = quantize_swin_tower(avs_model.backbone)
    srv = PS.MultiTaskServer(dtype=torch.float32, device="cpu")
    srv.add_ave("ave", pcfg, ave_model)
    srv.add_avs("avs", pcfg, PC.AVSHeadConfig(**head), avs_model)
    rng = np.random.RandomState(1)
    n = pcfg.img_size
    batch = {"a": rng.randn(1, 2, n, n).astype(np.float32),
             "v": rng.randn(1, 2, n, n, 3).astype(np.float32)}
    before = {t_: srv.predict(t_, batch) for t_ in srv.tasks()}
    assert _shared(srv.models["ave"], srv.models["avs"]) == set()
    PS.share_frozen_tower(srv.models["ave"], {"avs": srv.models["avs"]})
    shared = _shared(srv.models["ave"], srv.models["avs"])
    for t_ in srv.tasks():
        np.testing.assert_array_equal(srv.predict(t_, batch), before[t_])
    ave_bb, avs_bb = srv.models["ave"].backbone, srv.models["avs"].backbone
    held = dict(avs_bb.named_parameters())
    held.update(avs_bb.named_buffers())
    ave_held = dict(ave_bb.named_parameters())
    ave_held.update(ave_bb.named_buffers())
    for k in shared:
        assert held[k].data_ptr() == ave_held[k].data_ptr()
        assert label(f"backbone.{k}") == "frozen"
    for k, v in held.items():
        if k not in shared and k in ave_held:
            assert v.data_ptr() != ave_held[k].data_ptr(), k
    assert any("Adapter" in k for k in held) and not any("Adapter" in k for k in shared)
    assert not any("gate_" in k for k in shared)
    assert any(k.endswith("qkv.weight") for k in shared) == (not int8)
    # the JAX rule on the same trees gives the same set
    j_ave, j_avs = to_numpy_tree(ave_tree), to_numpy_tree(avs_tree)
    if int8:
        from stgcma_tpu.ops.quant import quantize_swin_tower as jq
        j_avs = dict(j_avs, backbone=to_numpy_tree(jq(j_avs["backbone"])))
    assert shared == _jax_shared(j_ave, j_avs)


LABEL_CASES = ["swin_fusion", "swin_videoonly", "avs", "avqa", "clip_fusion"]


@pytest.mark.parametrize("case", LABEL_CASES)
def test_label_params_matches_jax(case):
    """`train/optim.py::label_params` on the port's names labels every
    parameter and buffer as the JAX `label_params` labels the tree's leaf."""
    from stgcma_tpu.models import avs as jax_avs
    from stgcma_tpu.train.optim import label_params as jax_label_params
    from stgcma_tpu_torch.train.optim import label_params
    head = dict(stage_dims=(16, 32), stage_resolutions=(14, 7), vis_dim=(64, 128),
                tpavi_stages=(0, 1), audio_dim=32, num_frames=2)
    if case.startswith("clip"):
        jcfg, pcfg = JC.clip_tiny_test(ftmode="fusion"), PC.clip_tiny_test(ftmode="fusion")
        tree = _tree(lambda: jax_ave.init_clip_ave(jax.random.PRNGKey(0), jcfg), 1)
        model = CV.clip_ave_from_jax(pcfg, to_numpy_tree(tree), "cpu")
    else:
        mode = "videoonly" if case == "swin_videoonly" else "fusion"
        jcfg, pcfg = JC.swin_tiny_test(**{**SWIN, "ftmode": mode}), \
            PC.swin_tiny_test(**{**SWIN, "ftmode": mode})
        if case == "avs":
            jh, ph = JC.AVSHeadConfig(**head), PC.AVSHeadConfig(**head)
            tree = _tree(lambda: jax_avs.init_avs(jax.random.PRNGKey(0), jcfg, jh), 1)
            model = CV.avs_from_jax(pcfg, ph, to_numpy_tree(tree), "cpu")
        elif case == "avqa":
            jh, ph = JC.AVQAHeadConfig(**AVQA_HEAD), PC.AVQAHeadConfig(**AVQA_HEAD)
            tree = _tree(lambda: jax_avqa.init_avqa(jax.random.PRNGKey(0), jcfg, jh), 1)
            model = CV.avqa_from_jax(pcfg, ph, to_numpy_tree(tree), "cpu")
        else:
            tree = _tree(lambda: jax_ave.init_swin_ave(jax.random.PRNGKey(0), jcfg), 1)
            model = CV.swin_ave_from_jax(pcfg, to_numpy_tree(tree), "cpu")
    rename = {"kernel": "weight", "scale": "weight", "mean": "running_mean", "var": "running_var"}
    want = {}
    for p, lab in jax.tree_util.tree_flatten_with_path(jax_label_params(tree))[0]:
        parts = [str(getattr(k, "key", getattr(k, "idx", k))) for k in p]
        want[".".join(parts[:-1] + [rename.get(parts[-1], parts[-1])])] = lab
    got = label_params(model)
    assert got == want
    assert {"frozen", "adapt", "head"} <= set(got.values())


def test_predict_takes_tensors_as_they_are():
    """numpy arrays and tensors give the same outputs; a bf16 server casts
    float tensors to bf16 and keeps integer ones."""
    cfg = PC.swin_tiny_test(**SWIN)
    jcfg = JC.swin_tiny_test(**SWIN)
    tree = to_numpy_tree(_tree(lambda: jax_ave.init_swin_ave(jax.random.PRNGKey(0), jcfg), 3))
    rng = np.random.RandomState(2)
    n = cfg.img_size
    batch = {"a": rng.randn(2, 2, n, n).astype(np.float32),
             "v": rng.randn(2, 2, n, n, 3).astype(np.float32)}
    for dtype in (torch.float32, torch.bfloat16):
        srv = PS.MultiTaskServer(dtype=dtype, device="cpu")
        srv.add_ave("ave", cfg, CV.swin_ave_from_jax(cfg, tree, "cpu"))
        ref = srv.predict("ave", batch)
        for conv in (torch.from_numpy, lambda x: torch.from_numpy(x).double(),
                     lambda x: torch.from_numpy(x).to(dtype)):
            out = srv.predict("ave", {k: conv(v) for k, v in batch.items()})
            assert out.dtype == np.float32
            np.testing.assert_array_equal(out, ref)


def test_stream_entry_points_need_a_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is taken")
    srv = PS.MultiTaskServer(dtype=torch.float32, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        list(PS.serve_stream(srv, {}, []))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PS.MultiTaskServer()
    other = PS.MultiTaskServer(dtype=torch.float32, device="cpu")
    other.device = torch.device("meta")
    with pytest.raises(ValueError, match="server runs on"):
        list(PS.serve_stream(other, {}, [], device="cpu"))


@pytest.mark.skipif(not JN.available(), reason="native/libstgcma_host.so is not built "
                                               "(make -C native)")
def test_native_binding_matches_jax():
    """The port's ctypes binding decodes as the JAX package's, bit for bit,
    through the same library."""
    w_p, ok_p = PN.decode_wav_batch(WAVS + ["/nonexistent.wav"], 3, 16000)
    w_j, ok_j = JN.decode_wav_batch(WAVS + ["/nonexistent.wav"], 3, 16000)
    np.testing.assert_array_equal(w_p, w_j)
    np.testing.assert_array_equal(ok_p, ok_j)
    assert ok_p.tolist() == [True] * len(WAVS) + [False]
    if PN.image_available():
        f_p, fok_p = PN.decode_image_batch(JPGS, 48, 40)
        f_j, fok_j = JN.decode_image_batch(JPGS, 48, 40)
        np.testing.assert_array_equal(f_p, f_j)
        assert fok_p.all() and fok_j.all()
