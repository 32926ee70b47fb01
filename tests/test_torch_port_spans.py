"""The port's spans and the benchmark's reduction of them, on the CPU.

`runtime/profiling.py::annotate` calls neither `record_function` nor NVTX
while no profiler records, and opens both while one does. Under
torch.profiler one training step of a tiny CLIP fusion AVE (the device train
pipeline, the CPU's plain kernel versions under `_Recompute`) gives the
tree `train.step` > {`train.cast`, `train.loss` > {`data.pipeline`,
`model.tower`, `model.head`}, `train.backward` > `train.recompute.K*`,
`train.optim`}, and one `predict` gives `serve.request` > {`serve.copy_in`,
`serve.forward` > {`model.tower`, `model.head`}, `serve.copy_out`}, with the
aten ops of each inside its interval. A tiny AVS `predict` (four Swin stages,
every decoder stage) opens `model.head`'s five children in order, and
nothing while no profiler records.

`portbench/spans.py` on a made-up trace of one step whose every figure is
worked out by hand: a launch belongs to the span open at the launch, not at
the kernel's run; the autograd worker's launches outside `_Recompute` fall
to the main thread's span; the gap at the window's end; `self_ms`; the
blocking runtime calls; readings a step, None when the count of steps
disagrees. On random traces (overlapping device events, spans on two
threads) busy and idle partition the window exactly against
`trace.reduce_trace`, whose numbers the spans leave as they were.
"""
import json
import random

import numpy as np
import pytest
import torch

from portbench import spans as SP
from portbench.trace import REGION, reduce_trace
from stgcma_tpu_torch.configs import AVSHeadConfig, clip_tiny_test, swin_tiny_test
from stgcma_tpu_torch.data.loader import make_ave_device_pipeline
from stgcma_tpu_torch.models.ave import apply_clip_ave, random_clip_ave
from stgcma_tpu_torch.models.avs import random_avs
from stgcma_tpu_torch.ops.fbank import FbankConfig
from stgcma_tpu_torch.runtime.profiling import annotate
from stgcma_tpu_torch.serving import MultiTaskServer
from stgcma_tpu_torch.train import losses, optim, steps

torch.set_num_threads(2)
TOL_US = 1e-3       # the acceptance bar of the partition is 1 us


# ---------------------------------------------------------------------------
# the program's spans
# ---------------------------------------------------------------------------

def _raise(*a, **k):
    raise AssertionError("called while no profiler records")


def _tiny():
    cfg = clip_tiny_test(ftmode="fusion")
    return cfg, random_clip_ave(cfg, 0)


def _ave_batch(cfg, B=2, seed=0):
    rng = np.random.RandomState(seed)
    T, r = cfg.num_frames, cfg.input_resolution
    return {"a": rng.randn(B, T, cfg.audio_tdim, cfg.audio_fdim).astype(np.float32),
            "v": rng.randn(B, T, r, r, 3).astype(np.float32)}


def _trace(fn, tmp_path):
    """The Chrome trace events of fn() under torch.profiler, inside the
    benchmark's window region."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with torch.profiler.record_function(REGION):
            fn()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    return json.loads(path.read_text())["traceEvents"]


def _tree(events):
    """{name: {names of the spans it directly holds}} of the window's spans."""
    region = next(e for e in events if e.get("name") == REGION)
    tree = {}
    for s in SP.Spans(events, region["ts"], region["ts"] + region["dur"]).all:
        tree.setdefault(s.name, set()).update(c.name for c in s.children)
    return tree


def test_annotate_off_calls_neither_record_function_nor_nvtx(monkeypatch):
    monkeypatch.setattr(torch.profiler, "record_function", _raise)
    monkeypatch.setattr(torch.cuda.nvtx, "range_push", _raise)
    monkeypatch.setattr(torch.cuda.nvtx, "range_pop", _raise)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    with annotate("serve.request"):
        pass
    cfg, model = _tiny()
    srv = MultiTaskServer(dtype=torch.float32, device="cpu")
    srv.add_clip_ave("ave", cfg, model)
    assert srv.predict("ave", _ave_batch(cfg)).shape == (2 * cfg.num_frames, cfg.label_dim)


def test_annotate_on_opens_record_function_and_nvtx(monkeypatch, tmp_path):
    calls = []
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda.nvtx, "range_push", lambda n: calls.append(("push", n)))
    monkeypatch.setattr(torch.cuda.nvtx, "range_pop", lambda: calls.append(("pop",)))

    def body():
        with annotate("train.optim"):
            torch.ones(4).sum()
    events = _trace(body, tmp_path)
    assert calls == [("push", "train.optim"), ("pop",)]
    span = [e for e in events if e.get("name") == "train.optim"
            and e.get("cat") == "user_annotation"]
    assert len(span) == 1
    ops = [e for e in events if e.get("cat") == "cpu_op" and e["name"] == "aten::sum"]
    assert ops and span[0]["ts"] <= ops[0]["ts"] <= span[0]["ts"] + span[0]["dur"]


def test_train_step_span_tree(tmp_path):
    cfg, model = _tiny()
    steps.init_train_state(model)
    opt = optim.build_optimizer(model, 1e-4, 10.0)
    pipe = make_ave_device_pipeline(FbankConfig(num_mel_bins=cfg.audio_fdim), cfg.audio_tdim,
                                    train=True, image_size=cfg.input_resolution, device="cpu")

    def loss_fn(m, batch, g):
        a, v = pipe(batch, g)
        return losses.ave_loss(apply_clip_ave(m, cfg, a, v, generator=g), batch["labels"]), {}

    step = steps.make_train_step(loss_fn, opt, torch.float32)
    rng = np.random.RandomState(0)
    B, T = 2, cfg.num_frames
    batch = {"frames": torch.from_numpy(rng.randint(0, 256, (B, T, 72, 72, 3)).astype(np.uint8)),
             "wave": torch.from_numpy((rng.rand(B, T, 16000) - 0.5).astype(np.float32)),
             "labels": torch.from_numpy(np.eye(cfg.label_dim, dtype=np.float32)[
                 rng.randint(0, cfg.label_dim, (B, T))])}
    events = _trace(lambda: step(model, batch, torch.Generator().manual_seed(0)), tmp_path)
    tree = _tree(events)
    recomputes = {n for n in tree if n.startswith("train.recompute.K")}
    assert recomputes, "no _Recompute backward ran"
    assert tree["train.step"] == {"train.cast", "train.loss", "train.backward", "train.optim"}
    assert tree["train.loss"] == {"data.pipeline", "model.tower", "model.head"}
    assert tree["train.backward"] == recomputes
    table = SP.reduce_spans(events)
    assert table["train.step"]["count"] == 1 and table["data.pipeline"]["count"] == 1
    parts = sum(table[k]["wall_ms"] for k in tree["train.step"])
    assert parts >= 0.95 * table["train.step"]["wall_ms"]


def test_predict_span_tree_on_the_clock_of_its_ops(tmp_path):
    cfg, model = _tiny()
    srv = MultiTaskServer(dtype=torch.float32, device="cpu")
    srv.add_clip_ave("ave", cfg, model)
    batch = _ave_batch(cfg)
    srv.predict("ave", batch)
    events = _trace(lambda: srv.predict("ave", batch), tmp_path)
    tree = _tree(events)
    assert tree["serve.request"] == {"serve.copy_in", "serve.forward", "serve.copy_out"}
    assert tree["serve.forward"] == {"model.tower", "model.head"}
    spans = {e["name"]: e for e in events if e.get("cat") == "user_annotation"}
    ops = [e for e in events if e.get("cat") == "cpu_op"]

    def inside(span, op_names):
        s = spans[span]
        return [o for o in ops if o["name"] in op_names and o["tid"] == s["tid"]
                and s["ts"] <= o["ts"] and o["ts"] + o["dur"] <= s["ts"] + s["dur"]]
    assert inside("serve.copy_in", {"aten::to"})
    assert inside("model.tower", {"aten::conv2d"}) and inside("model.tower", {"aten::softmax"})
    assert inside("model.head", {"aten::cat"}) and inside("model.head", {"aten::linear"})
    assert inside("serve.copy_out", {"aten::to"})
    req = spans["serve.request"]
    assert all(req["ts"] <= spans[n]["ts"] and spans[n]["ts"] + spans[n]["dur"]
               <= req["ts"] + req["dur"] for n in ("serve.copy_in", "serve.forward",
                                                   "model.tower", "model.head",
                                                   "serve.copy_out"))


AVS_HEAD_SPANS = ["model.head.audio", "model.head.taps", "model.head.tpavi", "model.head.fpn",
                  "model.head.out"]


def _avs_server():
    cfg = swin_tiny_test(ftmode="fusion", depths=(2, 2, 2, 2), num_heads=(2, 2, 4, 4),
                         img_size=64, window_size=4, adapter_ratios=(0.25,) * 4)
    hcfg = AVSHeadConfig(channel=16, vis_dim=(8, 8, 16, 16), stage_dims=(16, 32, 64, 128),
                         stage_resolutions=(16, 8, 4, 2), audio_dim=128, tpavi_audio_dim=8,
                         num_frames=2)
    srv = MultiTaskServer(dtype=torch.float32, device="cpu")
    srv.add_avs("avs", cfg, hcfg, random_avs(cfg, hcfg, 0))
    rng = np.random.RandomState(0)
    batch = {"a": rng.randn(1, 2, 64, 64).astype(np.float32),
             "v": rng.randn(1, 2, 64, 64, 3).astype(np.float32)}
    return srv, batch


def test_avs_head_spans_in_order_under_model_head(monkeypatch, tmp_path):
    srv, batch = _avs_server()
    events = _trace(lambda: srv.predict("avs", batch), tmp_path)
    tree = _tree(events)
    assert tree["serve.forward"] == {"model.tower", "model.head"}
    assert tree["model.head"] == set(AVS_HEAD_SPANS)
    spans = sorted((e for e in events if e.get("cat") == "user_annotation"
                    and e["name"].startswith("model.head.")), key=lambda e: e["ts"])
    assert [e["name"] for e in spans] == AVS_HEAD_SPANS
    head = next(e for e in events if e.get("name") == "model.head")
    assert all(head["ts"] <= e["ts"] and e["ts"] + e["dur"] <= head["ts"] + head["dur"]
               for e in spans)
    convs = [e for e in events if e.get("cat") == "cpu_op" and e["name"] == "aten::conv2d"
             and head["ts"] <= e["ts"] <= head["ts"] + head["dur"]]
    inside = [e for e in convs if any(s["ts"] <= e["ts"] <= s["ts"] + s["dur"] for s in spans)]
    assert convs and inside == convs
    # and with no profiler recording, nothing is opened
    monkeypatch.setattr(torch.profiler, "record_function", _raise)
    monkeypatch.setattr(torch.cuda.nvtx, "range_push", _raise)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert srv.predict("avs", batch).shape == (2, 64, 64, 1)


# ---------------------------------------------------------------------------
# portbench/spans.py on a made-up step (us; every figure worked out by hand)
# ---------------------------------------------------------------------------

MAIN, WORKER = 1, 2


def _x(cat, name, ts, dur, tid=MAIN, **args):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "tid": tid}
    if args:
        e["args"] = args
    return e


def _step_trace():
    """A 1000 us window, one step: spans on the main thread, the autograd
    worker's recompute span, launches by correlation id."""
    ev = [_x("user_annotation", REGION, 0, 1000)]
    for name, ts, end, tid in (("train.step", 10, 900, MAIN), ("train.cast", 10, 50, MAIN),
                               ("train.loss", 50, 400, MAIN), ("data.pipeline", 50, 200, MAIN),
                               ("model.tower", 200, 350, MAIN), ("model.head", 350, 400, MAIN),
                               ("train.backward", 400, 800, MAIN),
                               ("train.recompute.K1", 500, 600, WORKER),
                               ("train.optim", 800, 890, MAIN)):
        ev.append(_x("user_annotation", name, ts, end - ts, tid))
    ev.append(_x("user_annotation", "Optimizer.step#Adam.step", 805, 80))   # not the program's
    launches = [  # (correlation, launching thread, launch time, api, device event)
        (7, MAIN, 55, "cudaMemcpyAsync",
         _x("gpu_memcpy", "Memcpy HtoD (Pinned -> Device)", 55, 40, 7, correlation=7,
            bytes=4096)),
        (1, MAIN, 60, "cudaLaunchKernel", _x("kernel", "pipe", 100, 50, 7, correlation=1)),
        (2, MAIN, 210, "cudaLaunchKernel", _x("kernel", "tower", 220, 80, 7, correlation=2)),
        # launched in the head, run while the backward holds the host
        (3, MAIN, 360, "cudaLaunchKernel", _x("kernel", "head", 410, 20, 7, correlation=3)),
        # the autograd worker outside _Recompute, then inside it
        (4, WORKER, 450, "cudaLaunchKernel", _x("kernel", "bwd", 460, 40, 7, correlation=4)),
        (5, WORKER, 550, "cudaLaunchKernel", _x("kernel", "recompute", 560, 60, 7,
                                                correlation=5)),
        (6, MAIN, 810, "cuLaunchKernel", _x("kernel", "adam", 820, 30, 7, correlation=6)),
    ]
    for corr, tid, ts, api, dev in launches:
        cat = "cuda_driver" if api.startswith("cu") and not api.startswith("cuda") \
            else "cuda_runtime"
        ev += [_x(cat, api, ts, 3, tid, correlation=corr), dev]
    ev.append(_x("kernel", "no launch event", 625, 10, 7, correlation=99))
    ev += [_x("cuda_runtime", "cudaStreamSynchronize", 380, 5, MAIN, correlation=20),
           _x("cuda_runtime", "cudaMemcpy", 812, 5, MAIN, correlation=21),
           _x("cuda_runtime", "cudaDeviceSynchronize", 950, 5, MAIN, correlation=22)]
    return ev


def _ms(us):
    return pytest.approx(us * 1e-3, abs=1e-9)


def test_launch_belongs_to_the_span_open_at_the_launch():
    t = SP.reduce_spans(_step_trace())
    assert t["model.head"]["busy_ms"] == _ms(20) and t["model.head"]["launches"] == 1
    assert t["model.head"]["idle_ms"] == _ms(110)      # the gap 300-410 its kernel ends
    assert t["data.pipeline"]["busy_ms"] == _ms(90)     # the copy and its kernel
    assert t["data.pipeline"]["idle_ms"] == _ms(55 + 5)
    assert t["data.pipeline"]["h2d_bytes"] == 4096 and t["data.pipeline"]["launches"] == 1
    assert t["model.tower"]["busy_ms"] == _ms(80) and t["model.tower"]["idle_ms"] == _ms(70)
    assert t["train.optim"]["launches"] == 1            # a cuLaunchKernel launch
    assert t["outside"]["busy_ms"] == _ms(10) and t["outside"]["unlinked"] == 1
    assert "Optimizer.step#Adam.step" not in t


def test_autograd_worker_falls_back_to_the_main_thread_span():
    t = SP.reduce_spans(_step_trace())
    assert t["train.backward"]["busy_ms"] == _ms(40)
    assert t["train.backward"]["idle_ms"] == _ms(30)
    assert t["train.recompute.K1"]["busy_ms"] == _ms(60)
    assert t["train.recompute.K1"]["idle_ms"] == _ms(60)
    sub = t["train.backward"]["subtree"]
    assert sub["busy_ms"] == _ms(100) and sub["idle_ms"] == _ms(90) and sub["launches"] == 2
    assert SP.reading(t, "recompute_ms.train", 1) == _ms(60)
    assert SP.reading(t, "backward_ms.train", 1) == _ms(100)


@pytest.mark.parametrize("spans_kept", [True, False])
def test_window_end_gap(spans_kept):
    ev = _step_trace()
    if not spans_kept:
        ev = [e for e in ev if e["name"] == REGION or not e["name"].startswith(SP.PREFIXES)]
    t = SP.reduce_spans(ev)
    if spans_kept:     # 850-1000 starts inside train.optim; 635-820 ends at its kernel
        assert t["train.optim"]["idle_ms"] == _ms(185 + 150)
        assert t["outside"]["idle_ms"] == _ms(5)
    else:
        assert set(t) == {"outside"} and t["outside"]["idle_ms"] == _ms(670)


def test_self_ms_is_the_wall_less_direct_children_on_the_thread():
    t = SP.reduce_spans(_step_trace())
    assert t["train.step"]["wall_ms"] == _ms(890) and t["train.step"]["self_ms"] == _ms(10)
    assert t["train.loss"]["self_ms"] == _ms(0)
    assert t["train.backward"]["self_ms"] == _ms(400)     # the recompute is on the worker
    assert t["model.head"]["self_ms"] == _ms(50)


def test_syncs_are_the_blocking_runtime_calls():
    t = SP.reduce_spans(_step_trace())
    assert t["model.head"]["syncs"] == 1 and t["train.optim"]["syncs"] == 1
    assert t["outside"]["syncs"] == 1 and t["data.pipeline"]["syncs"] == 0  # cudaMemcpyAsync
    assert t["train.step"]["subtree"]["syncs"] == 2
    assert SP.reading(t, "host_syncs.train", 1) == 2


def test_reading_is_none_where_the_step_count_disagrees():
    t = SP.reduce_spans(_step_trace())
    assert SP.reading(t, "pipeline_ms.train", 1) == _ms(150)
    assert SP.reading(t, "pipeline_idle_ms.train", 1) == _ms(60)
    assert SP.reading(t, "optim_ms.train", 1) == _ms(90)
    assert SP.reading(t, "backward_idle_ms.train", 1) == _ms(90)
    assert SP.reading(t, "pipeline_ms.train", 2) is None
    assert SP.reading(t, "head_ms.serve", 1) is None     # no serve.request span
    bare = [e for e in _step_trace() if not e["name"].startswith(SP.PREFIXES)]
    assert all(SP.reading(SP.reduce_spans(bare), k, 1) is None for k in SP.READINGS)


def _random_trace(seed):
    """Random nested spans on the main thread and recompute spans on a
    worker, launches from both, device events that may overlap (two
    streams), syncs."""
    rnd = random.Random(seed)
    ev = [_x("user_annotation", REGION, 1000.0, 5000.0)]
    t, corr = 1010.0, 0
    for _ in range(3):
        start = t
        names = ["train.cast", "train.loss", "train.backward", "train.optim"]
        for n in names:
            d = rnd.uniform(50, 350)
            ev.append(_x("user_annotation", n, t, d))
            if n == "train.loss":
                ev.append(_x("user_annotation", "data.pipeline", t + 1, d / 3))
                ev.append(_x("user_annotation", "model.tower", t + 2 + d / 3, d / 3))
            if n == "train.backward":
                ev.append(_x("user_annotation", "train.recompute.K4", t + 5, d / 2, WORKER))
            for _ in range(rnd.randint(2, 8)):
                corr += 1
                tid = rnd.choice([MAIN, WORKER])
                ts = rnd.uniform(t, t + d)
                ev.append(_x("cuda_runtime", "cudaLaunchKernel", ts, 2.5, tid,
                             correlation=corr))
                ev.append(_x(rnd.choice(["kernel", "gpu_memcpy", "gpu_memset"]),
                             rnd.choice(["k", "Memcpy HtoD", "Memset"]), ts + rnd.uniform(1, 400),
                             rnd.uniform(0.5, 120), 7 + rnd.randint(0, 1), correlation=corr,
                             bytes=1024))
            if rnd.random() < 0.5:
                ev.append(_x("cuda_runtime", "cudaStreamSynchronize", t + d / 2, 1.0, MAIN,
                             correlation=10_000 + corr))
            t += d
        ev.insert(1, _x("user_annotation", "train.step", start, t - start))
        t += rnd.uniform(0, 30)
    return ev


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_busy_and_idle_partition_the_window_exactly(seed):
    ev = _random_trace(seed)
    r, t = reduce_trace(ev), SP.reduce_spans(ev)
    busy_err, idle_err = SP.partition_error_us(t, ev, r["window_s"], r["busy_s"])
    assert busy_err < TOL_US and idle_err < TOL_US
    assert sum(row["launches"] for row in t.values()) == r["kernels"]
    assert t["train.step"]["count"] == 3
    # each owned figure once among the rows; a subtree holds its descendants'
    for k in SP.OWNED:
        roots = t["train.step"]["subtree"][k] + t["outside"][k]
        assert roots == pytest.approx(sum(row[k] for row in t.values()))


def test_reduce_trace_is_unchanged_by_the_spans():
    ev = _random_trace(5) + _step_trace()[1:]
    bare = [e for e in ev if e.get("cat") != "user_annotation" or e["name"] == REGION]
    assert reduce_trace(ev) == reduce_trace(bare)


def test_cu_launch_kernel_launches_are_read():
    ev = _step_trace()
    assert SP.cu_launch_gaps_s(ev) == pytest.approx(185e-6)
    # trace.py names each gap whose ending event it finds no runtime launch for
    # after the window's end: the cuLaunchKernel one, the unlinked kernel, the end
    assert dict(reduce_trace(ev)["idle_gaps"])["_window_end_"] == pytest.approx(
        (185 + 5 + 150) * 1e-6)
    assert SP.reduce_spans(ev)["train.optim"]["launches"] == 1
