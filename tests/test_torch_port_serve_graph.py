"""`MultiTaskServer.add_avs(..., graph=True)`: the forward replayed as a CUDA
graph (`serving.py::GraphedForward`).

On the CPU: the option is refused off the card and under a mesh, and
`GraphedForward`'s bookkeeping (one eager call and one capture a set of
input shapes, the batch copied into the graph's inputs, the graph's output
returned) is held with torch's graph API stood in for. On the card
(skipped without CUDA): a Swin-Large fusion AVS server at depth 2 a stage
gives graphed masks equal to its eager masks bit for bit, request after
request, at two batch sizes.

Run the card tests on the card:
    python -m pytest --noconftest -m card tests/test_torch_port_serve_graph.py -q
"""
import contextlib
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from stgcma_tpu_torch import serving
from stgcma_tpu_torch.configs import AVSHeadConfig, swin_tiny_test
from stgcma_tpu_torch.models.avs import random_avs
from stgcma_tpu_torch.serving import GraphedForward, MultiTaskServer


def _tiny_avs():
    cfg = swin_tiny_test(ftmode="fusion", depths=(2, 2, 2, 2), num_heads=(2, 2, 4, 4),
                         img_size=64, window_size=4, adapter_ratios=(0.25,) * 4)
    hcfg = AVSHeadConfig(channel=16, vis_dim=(8, 8, 16, 16), stage_dims=(16, 32, 64, 128),
                         stage_resolutions=(16, 8, 4, 2), audio_dim=128, tpavi_audio_dim=8,
                         num_frames=2)
    return cfg, hcfg, random_avs(cfg, hcfg, 0)


def _batch(seed, B=2, hw=64):
    rng = np.random.RandomState(seed)
    return {"a": rng.randn(B, 2, hw, hw).astype(np.float32),
            "v": rng.randn(B, 2, hw, hw, 3).astype(np.float32)}


def test_graph_refused_off_the_card():
    cfg, hcfg, model = _tiny_avs()
    srv = MultiTaskServer(dtype=torch.float32, device="cpu")
    with pytest.raises(ValueError, match="CUDA server"):
        srv.add_avs("avs", cfg, hcfg, model, graph=True)
    srv.add_avs("avs", cfg, hcfg, model)          # the eager path is unchanged
    assert srv.predict("avs", _batch(0)).shape == (4, 64, 64, 1)


class _FakeGraph:
    replays = 0

    def replay(self):
        type(self).replays += 1


class _FakeStream:
    def wait_stream(self, other):
        pass


@pytest.fixture
def fake_graphs(monkeypatch):
    """torch's CUDA graph API stood in for: a capture runs fn eagerly, a
    replay only counts."""
    _FakeGraph.replays = 0
    monkeypatch.setattr(torch.cuda, "CUDAGraph", _FakeGraph)
    monkeypatch.setattr(torch.cuda, "graph", lambda g: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "Stream", _FakeStream)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda: _FakeStream())
    monkeypatch.setattr(torch.cuda, "stream", lambda s: contextlib.nullcontext())
    return _FakeGraph


@pytest.mark.parametrize("shapes", [[(2, 3)], [(2, 3), (4, 3)], [(2, 3), (4, 3), (2, 3)]])
def test_graphed_forward_captures_once_a_shape(fake_graphs, shapes):
    seen = []

    def fn(batch):
        seen.append(batch["x"])
        return batch["x"] * 2

    g = GraphedForward(fn)
    for i, shape in enumerate(shapes):
        x = torch.full(shape, float(i))
        out = g({"x": x})
        graph, inputs, static_out = g.graphs[(("x", shape, torch.float32),)]
        assert out is static_out and torch.equal(inputs["x"], x)
        assert inputs["x"] is not x                  # the graph's own input
    n = len(set(shapes))
    assert len(g.graphs) == n and len(seen) == 2 * n   # a warm-up and a capture a shape
    assert all(t is g.graphs[(("x", t.shape, torch.float32),)][1]["x"] for t in seen)
    assert fake_graphs.replays == len(shapes)


def test_graph_refused_under_a_mesh(monkeypatch):
    srv = MultiTaskServer(dtype=torch.float32, device="cpu")
    monkeypatch.setattr(srv, "device", torch.device("cuda"))
    srv.mesh = object()
    with pytest.raises(ValueError, match="without a mesh"):
        srv._graphed(lambda batch: batch)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: CUDA graphs run on the card only")
    return torch.device("cuda")


def _card_avs():
    """The benchmark's Swin-Large AVS configuration at depth 2 a stage and
    T = 2: the widths the card's kernels take."""
    from portbench.families import swin_avs
    c = json.loads((Path(__file__).resolve().parents[1] / "portbench" / "configs"
                    / "swin_large_avs_fusion.json").read_text())
    c["model"] = c["model"] | {"depths": [2, 2, 2, 2], "num_frames": 2}
    c["head"] = c["head"] | {"num_frames": 2}
    cfg, hcfg = swin_avs.port_configs(c)
    return cfg, hcfg, random_avs(cfg, hcfg, 0)


@pytest.mark.card
def test_graphed_avs_equals_eager_on_the_card(card):
    cfg, hcfg, model = _card_avs()
    srv = MultiTaskServer(dtype=torch.bfloat16, device=card)
    srv.add_avs("eager", cfg, hcfg, model)
    srv.add_avs("graph", cfg, hcfg, model, graph=True)
    for seed, B in ((0, 2), (1, 2), (2, 1), (3, 2), (4, 1)):
        batch = _batch(seed, B, 224)
        want = srv.predict("eager", batch)
        got = srv.predict("graph", batch)
        assert got.shape == want.shape == (2 * B, 224, 224, 1)
        np.testing.assert_array_equal(got, want)
    assert len(srv._fns["graph"].graphs) == 2
    torch.cuda.synchronize()
    assert isinstance(srv._fns["graph"], serving.GraphedForward)
