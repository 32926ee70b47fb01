"""The port's runtime against the JAX package's: `runtime/profiling.py`
(`cost_analysis` reading XLA's 524288 flops and 49152 bytes
for a (64, 64) fp32 matmul, `trace` / `annotate` writing a trace that holds
the region) and `runtime/mesh.py` (`param_spec` on every 2-D leaf of the
tiny Swin and CLIP fusion AVE, the split dim mapped through the (in, out)
-> (out, in) transpose; `init_distributed` without an environment), and
that every JAX module has its port counterpart.

The mesh itself runs in two processes under gloo on one free port,
brought up by `init_distributed` from the STGCMA_* variables
(tests/torch_port_mesh_worker.py; each run bounded by a 120 s timeout, its
processes killed on failure): the server at (data 2, model 1) and at
(data 1, model 2) with `shard_tower` against the meshless server, within
2e-5 of max |ref| in fp32 (JAX's tests/test_serving_sharded.py bar), each
split leaf storing half its elements on each rank, and a batch that does
not divide the data extent refused; one train step of the tiny AVS (TPAVI's
train-mode BatchNorm over the global batch) and of the tiny Swin AVE (the
train pipeline with its draws and the waveform mixup, the head's dropout)
at (data 2, model 1) against the step of one process on the whole batch:
the loss, all the gradients together, the BatchNorm statistics and the
masters within 1e-5 in fp32 (the masters where the gradient is not zero to
rounding: there Adam's first update takes the sign of rounding noise), and
the masters bit-identical across the ranks.
"""
import json
import os
import socket
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import jax
import pytest
import torch

import torch_port_helpers  # noqa: F401  (two torch threads a process)
from stgcma_tpu.configs import clip_tiny_test as jax_clip_tiny, swin_tiny_test as jax_swin_tiny
from stgcma_tpu.models import ave as jax_ave
from stgcma_tpu.runtime import mesh as JM
from stgcma_tpu.runtime import profiling as JP
from stgcma_tpu_torch.checkpoint.convert import _leaf
from stgcma_tpu_torch.configs import clip_tiny_test, swin_tiny_test
from stgcma_tpu_torch.models.ave import ClipAVE, SwinAVE
from stgcma_tpu_torch.runtime import mesh as PM
from stgcma_tpu_torch.runtime import profiling as PP

REPO = Path(__file__).resolve().parent.parent
WORKER = REPO / "tests" / "torch_port_mesh_worker.py"
TOL_SERVE, TOL_STEP = 2e-5, 1e-5
# the JAX modules whose port counterpart keeps another file name
RENAMED = {"ops/pallas_attn.py": "ops/fused_attn.py",
           "ops/pallas_clip_block.py": "ops/clip_block.py",
           "ops/pallas_swin_block.py": "ops/swin_block.py"}


def test_every_jax_module_has_a_port_counterpart():
    jax_root, port_root = REPO / "stgcma_tpu", REPO / "stgcma_tpu_torch"
    missing = []
    for f in sorted(jax_root.rglob("*.py")):
        rel = f.relative_to(jax_root).as_posix()
        if not (port_root / RENAMED.get(rel, rel)).is_file():
            missing.append(rel)
    assert not missing, missing


def test_cost_analysis_matches_jax():
    x = np.random.RandomState(0).randn(64, 64).astype(np.float32)
    want = JP.cost_analysis(lambda a: a @ a, jax.numpy.asarray(x))
    got = PP.cost_analysis(lambda a: a @ a, torch.from_numpy(x))
    assert got == want == {"flops": 524288.0, "bytes accessed": 49152.0}


def test_cost_analysis_counts_no_view_bytes():
    x = torch.randn(32, 16)
    got = PP.cost_analysis(lambda a: a.reshape(-1)[:256].sum(), x)
    assert got == {"flops": 0.0, "bytes accessed": 256 * 4 + 4}   # the sum reads its view


def test_trace_holds_the_annotated_region(tmp_path):
    x = torch.randn(32, 32)
    with PP.trace(str(tmp_path)) as prof:
        with PP.annotate("pvt_forward_region"):
            (x @ x).sum()
    files = list(tmp_path.glob("trace_*.json"))
    assert len(files) == 1
    events = json.loads(files[0].read_text())["traceEvents"]
    assert any(e.get("name") == "pvt_forward_region" for e in events)
    assert any(e.key == "pvt_forward_region" for e in prof.key_averages())


def _jax_path(path) -> str:
    """The path string JAX's `shard_params` gives `param_spec`."""
    s = jax.tree_util.keystr(path)
    return s.replace("']['", "/").strip("[']").replace("'][", "/").replace("][", "/")


def _port_name(path, leaf) -> str:
    keys = [str(getattr(k, "key", getattr(k, "idx", k))) for k in path]
    return ".".join(keys[:-1] + [_leaf(keys[-1], np.asarray(leaf))[0]])


@pytest.mark.parametrize("tower", ["swin", "clip"])
def test_param_spec_matches_jax(tower):
    if tower == "swin":
        tree = jax_ave.init_swin_ave(jax.random.PRNGKey(0), jax_swin_tiny(ftmode="fusion"))
        model = SwinAVE(swin_tiny_test(ftmode="fusion"))
    else:
        tree = jax_ave.init_clip_ave(jax.random.PRNGKey(0), jax_clip_tiny(ftmode="fusion"))
        model = ClipAVE(clip_tiny_test(ftmode="fusion"))
    held = dict(model.named_parameters())
    to_dim = {(): None, (None, "model"): 0, ("model", None): 1}
    seen = {0: 0, 1: 0, None: 0}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        if leaf.ndim != 2:
            continue
        name = _port_name(path, leaf)
        want = to_dim[tuple(JM.param_spec(_jax_path(path), leaf))]
        got = PM.param_spec(name, held[name])
        assert got == want, (name, got, want)
        if got is not None:     # the split dim is the same axis of the weight
            assert held[name].shape[got] == leaf.shape[1 - got]
        seen[got] += 1
    assert seen[0] and seen[1] and seen[None]


def test_init_distributed_without_environment(monkeypatch):
    for k in ("STGCMA_COORDINATOR", "STGCMA_NUM_PROCESSES", "STGCMA_PROCESS_ID",
              "STGCMA_DISTRIBUTED"):
        monkeypatch.delenv(k, raising=False)
    assert not torch.distributed.is_initialized()
    assert PM.init_distributed() is False
    assert not torch.distributed.is_initialized()
    with pytest.raises(RuntimeError, match="init_distributed"):
        PM.make_mesh(1, 1)
    with pytest.raises(ValueError, match="num_processes"):
        PM.init_distributed(coordinator="127.0.0.1:1")


def test_mesh_helpers_outside_a_step_are_identities():
    x = torch.arange(12.0).reshape(4, 3)
    assert PM.current_shard() is None
    assert PM.gather_rows(x) is x and PM.local_rows(x) is x and PM.sum_rows(x) is x
    g = torch.Generator().manual_seed(0)
    want = torch.rand(4, 3, generator=torch.Generator().manual_seed(0))
    assert torch.equal(PM.draw_rows(lambda s: torch.rand(s, generator=g), (4, 3)), want)
    assert PM.draw_items(lambda: 1, 3) == [1, 1, 1]


def test_draws_inside_a_mesh_step_are_the_global_batchs_rows():
    """With this rank holding block 1 of 2, a head-dropout draw, an
    attention-dropout keep mask and a per-clip draw are the second half of
    what one process draws for the whole batch, and the generator ends where
    it does there."""
    from stgcma_tpu_torch.ops.attention import attn_dropout_keep
    g_one, g_mesh = torch.Generator().manual_seed(3), torch.Generator().manual_seed(3)
    whole = [torch.rand((4, 6), generator=g_one),
             attn_dropout_keep((4, 2, 1, 5), 0.3, g_one, "cpu"),
             [int(torch.randint(0, 99, (), generator=g_one)) for _ in range(4)]]
    token = PM._SHARD.set(PM.RowShard(1, 2, None))
    try:
        got = [PM.draw_rows(lambda s: torch.rand(s, generator=g_mesh), (2, 6)),
               attn_dropout_keep((2, 2, 1, 5), 0.3, g_mesh, "cpu"),
               PM.draw_items(lambda: int(torch.randint(0, 99, (), generator=g_mesh)), 2)]
    finally:
        PM._SHARD.reset(token)
    assert torch.equal(got[0], whole[0][2:]) and torch.equal(got[1], whole[1][2:])
    assert got[2] == whole[2][2:]
    assert torch.equal(torch.rand(3, generator=g_mesh), torch.rand(3, generator=g_one))


@pytest.mark.parametrize("cli", ["run_adapt_ave29", "run_adapt_avs", "run_adapt_avqa"])
def test_clis_bring_up_the_group_first(cli, monkeypatch):
    """As the JAX CLIs (:146, :155, :121), each port CLI's main calls
    `init_distributed()` right after parsing its flags, before anything
    touches a device."""
    import importlib

    class First(Exception):
        pass

    mod = importlib.import_module(f"stgcma_tpu_torch.cli.{cli}")

    def bring_up():
        raise First

    monkeypatch.setattr(mod, "init_distributed", bring_up)
    monkeypatch.setattr(mod, "resolve_device", lambda *_: pytest.fail("device before group"))
    with pytest.raises(First):
        mod.main(["--synthetic", "True", "--tiny", "True"])


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _run_mesh(mode, tmp_path, timeout=120):
    """Two ranks of the worker on one free port; their JSON results."""
    port, procs = _free_port(), []
    outs = [tmp_path / f"rank{r}.json" for r in range(2)]
    for r in range(2):
        env = dict(os.environ, STGCMA_COORDINATOR=f"127.0.0.1:{port}", STGCMA_NUM_PROCESSES="2",
                   STGCMA_PROCESS_ID=str(r))
        env.pop("STGCMA_DISTRIBUTED", None)
        procs.append(subprocess.Popen([sys.executable, str(WORKER), mode, str(outs[r])],
                                      stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                      env=env, text=True))
    deadline, logs = time.monotonic() + timeout, []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=max(deadline - time.monotonic(), 1))[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, p in enumerate(procs):
        assert p.returncode == 0, f"rank {r} failed:\n{logs[r][-4000:]}"
    return [json.loads(o.read_text()) for o in outs]


@pytest.mark.parametrize("mode", ["server_data", "server_model"])
def test_mesh_server_matches_the_meshless_server(tmp_path, mode):
    results = _run_mesh(mode, tmp_path)
    for r, res in enumerate(results):
        assert res["rank"] == r and res["backend"] == "gloo"
        for task in ("swin", "clip"):
            assert res[f"{task}_shape_equal"]
            assert res[f"{task}_rel"] <= TOL_SERVE, (task, res)
            if mode == "server_data":
                assert "data extent 2" in res[f"{task}_indivisible"]
            else:
                assert res[f"{task}_split_leaves"] > 0
                assert res[f"{task}_indivisible"] == "no error"   # data extent 1


def test_mesh_train_steps_match_one_process(tmp_path):
    results = _run_mesh("train", tmp_path)
    for res in results:
        for task in ("avs", "ave"):
            for k in ("loss_rel", "grad_rel", "master_rel", "buffer_rel"):
                assert res[f"{task}_{k}"] <= TOL_STEP, (task, k, res)
            assert res[f"{task}_live_share"] > 0.5
            assert res[f"{task}_masters_equal_across_ranks"]
            assert res[f"{task}_params_names_equal"]
    assert results[0] == {**results[1], "rank": 0}
