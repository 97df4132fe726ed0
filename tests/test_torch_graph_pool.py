# -*- coding: utf-8 -*-
"""PyTorch port: the order a replica's CUDA-graph pool is built in, on the
CPU.

A replica's graphs share one memory pool whose segments stay while the
graphs live, so ``warmup`` captures its keys largest first
(``engine/synthesizer.py::footprint``), and a warmup that brings a key
larger than every key the pool holds rebuilds the pool: the held graphs
and the new ones captured again, largest first, under the engine's lock
(``_Replica._recapture``). On the CPU a ``StageGraph`` runs eagerly, so the
captures (``_Replica._capture``) and the rebuilds with what they capture
(``StageGraph.capture``) are recorded here with a monkeypatch; the
bookkeeping around them is the card's."""
import numpy as np
import pytest
import torch

from illufly_tts_tpu_torch.engine import graphs
from illufly_tts_tpu_torch.engine import synthesizer as engine
from illufly_tts_tpu_torch.engine.graphs import StageGraph
from illufly_tts_tpu_torch.engine.synthesizer import Synthesizer, footprint
from illufly_tts_tpu_torch.parallel.mesh import make_mesh
from tests.test_torch_params import port_config

torch.set_num_threads(2)

BUCKETS = dict(token_buckets=(16, 32), frame_buckets=(32, 64, 128))
TEXTS = ["ni→xau↓", "tsʰɤ↘ʂɨ↘i↗kɤ↘"]


def _port(**kw):
    s = Synthesizer(port_config(), seed=3, device="cpu", **BUCKETS, **kw)
    s.register_random_voice("v", seed=3)
    return s


@pytest.fixture
def recorded(monkeypatch):
    """-> the calls of ``_Replica._capture`` (replica, key, capture), and
    each pool rebuild (``_Replica._recapture``) as (replica, the graphs it
    captured, in order: ``StageGraph.capture``)."""
    calls = {"capture": [], "rebuilds": []}
    capture = engine._Replica._capture
    recapture = engine._Replica._recapture
    graph_capture = StageGraph.capture
    rebuilding = []

    def spy_capture(rep, key, inputs, **kw):
        calls["capture"].append((rep, key, kw.get("capture", True)))
        return capture(rep, key, inputs, **kw)

    def spy_recapture(rep, fresh):
        calls["rebuilds"].append((rep, []))
        rebuilding.append(rep)
        try:
            return recapture(rep, fresh)
        finally:
            rebuilding.pop()

    def spy_graph_capture(graph, pool):
        if rebuilding:
            calls["rebuilds"][-1][1].append(graph)
        return graph_capture(graph, pool)

    monkeypatch.setattr(engine._Replica, "_capture", spy_capture)
    monkeypatch.setattr(engine._Replica, "_recapture", spy_recapture)
    monkeypatch.setattr(StageGraph, "capture", spy_graph_capture)
    return calls


def _recaptured_keys(rep, graphs):
    """The keys of ``rep``'s re-captured ``graphs``, in order."""
    key_of = {id(g): k for k, g in rep._graphs.items()}
    return [key_of[id(g)] for g in graphs]


def test_footprint_orders_generator_frames_then_frames_then_tokens():
    assert footprint((4, 256, 4096, "pcm16")) > footprint(
        (4, 64, 4096, "pcm16")) > footprint((4, 256, 3072, "pcm16"))
    # batch x frames, not frames alone
    assert footprint((4, 64, 1024, "f32")) > footprint((1, 256, 2048, "f32"))
    # a window runs the Generator on its window and halos only
    assert footprint((1, 32, 128, "pcm16")) > footprint(
        ("win", 1, 4096, 128, 32)) > footprint(("prep", 8, 256, 4096))
    # the prepare runs no Generator; stage A neither, nor any frames
    assert footprint(("prep", 1, 16, 64)) > footprint((64, 512))
    assert footprint((8, 256)) > footprint((4, 256)) == footprint((8, 128))


def test_warmup_captures_largest_first(recorded):
    s = _port()
    s.warmup(batch_sizes=(1, 2), token_sizes=(16, 32), frame_sizes=(32, 64),
             formats=("pcm16", "f32"))
    order = [key for _, key, _ in recorded["capture"]]
    b_keys = [(b, t, f, fmt)
              for b, t, f in ((2, 32, 64), (2, 16, 64), (1, 32, 64),
                              (2, 32, 32), (1, 16, 64), (2, 16, 32),
                              (1, 32, 32), (1, 16, 32))
              for fmt in ("pcm16", "f32")]
    assert order == b_keys + [(2, 32), (1, 32), (2, 16), (1, 16)]
    assert all(capture for _, _, capture in recorded["capture"])
    assert recorded["rebuilds"] == [] and s.last_recapture is None
    assert set(s._graphs) == set(order) and s.graph_replays == {}
    # keys warmed already are not captured again
    s.warmup(batch_sizes=(2,), token_sizes=(32,), frame_sizes=(64,))
    assert len(recorded["capture"]) == len(order)


def test_larger_warmup_recaptures_the_union_largest_first(recorded):
    """A warmup whose key is larger than every held key (a stream's
    included) warms its keys only, then re-captures the held keys and its
    own, largest first; keys, replay counts and renders stay."""
    s, cold = _port(), _port()
    voices = ["v"] * 2
    h = s.dispatch(TEXTS, voices)
    ref = s.collect(h)
    big = (h.b_bucket, h.t_bucket, h.f_bucket, "pcm16")
    assert big[0] == 2 and big[2] >= 32
    s.warmup(batch_sizes=(1,), token_sizes=(16,), frame_sizes=(32,))
    windowed = np.concatenate(list(s.stream_decode(
        s.dispatch(TEXTS[:1], ["v"]), 16, 4, exact=False)), axis=1)
    s.collect(s.dispatch(TEXTS[:1], ["v"]))
    held = set(s._graphs)
    assert {k[0] for k in held if isinstance(k[0], str)} == {"prep", "win"}
    replays = dict(s.graph_replays)
    n_captures = len(recorded["capture"])

    s.warmup(batch_sizes=(2,), token_sizes=(16,), frame_sizes=(big[2],))
    fresh = recorded["capture"][n_captures:]
    assert [(key, capture) for _, key, capture in fresh] == [
        (big, False), ((2, 16), False)]
    [(rep, graphs)] = recorded["rebuilds"]
    order = _recaptured_keys(s, graphs)
    assert rep is s
    union = held | {big, (2, 16)}
    assert set(order) == union and len(order) == len(union)
    assert order == sorted(union, key=footprint, reverse=True)
    assert order[0] == big and s.last_recapture["keys"] == order
    assert s.last_recapture["lock_s"] >= 0.0
    assert set(s._graphs) == union and dict(s.graph_replays) == replays

    got = s.collect(s.dispatch(TEXTS, voices))
    assert s.graph_replays[big] == 1 and s.graph_replays[(2, 16)] == 1
    for a, b, c in zip(got, ref, cold.collect(cold.dispatch(TEXTS, voices))):
        assert a.tobytes() == b.tobytes() == c.tobytes()
    again = np.concatenate(list(s.stream_decode(
        s.dispatch(TEXTS[:1], ["v"]), 16, 4, exact=False)), axis=1)
    assert again.tobytes() == windowed.tobytes()


def test_smaller_warmup_and_first_use_keys_do_not_recapture(recorded):
    """Keys no larger than the pool's largest are captured into it; a
    stream key at its first use is captured into the pool as it stands,
    even one larger than every held key (a window of two rows over a pool
    of one-row keys)."""
    s = _port()
    s.warmup(batch_sizes=(1,), token_sizes=(16,), frame_sizes=(32,))
    s.warmup(batch_sizes=(1,), token_sizes=(16,), frame_sizes=(32,),
             formats=("f32", "mulaw8k"))
    assert [key for _, key, _ in recorded["capture"]][-2:] == [
        (1, 16, 32, "f32"), (1, 16, 32, "mulaw8k")]
    largest = max(map(footprint, s._graphs))
    h = s.dispatch(TEXTS, ["v"] * 2)
    chunks = list(s.stream_decode(h, 16, 4, exact=False))
    assert chunks
    win = [key for _, key, _ in recorded["capture"] if key[0] == "win"]
    assert len(win) == 1 and footprint(win[0]) > largest
    assert recorded["rebuilds"] == [] and s.last_recapture is None


def test_each_replica_recaptures_its_own_pool(recorded):
    """Under a 2-replica 'data' mesh each replica warms its rows of every
    batch and rebuilds its own pool from its own keys."""
    s = _port(mesh=make_mesh(n_data=2, devices=["cpu"] * 2))
    rep0, rep1 = s._replicas
    s.warmup(batch_sizes=(2,), token_sizes=(16,), frame_sizes=(32,))
    assert set(rep0._graphs) == set(rep1._graphs) == {
        (1, 16), (1, 16, 32, "pcm16")}
    s.warmup(batch_sizes=(4,), token_sizes=(16,), frame_sizes=(64,))
    want = [(2, 16, 64, "pcm16"), (1, 16, 32, "pcm16"), (2, 16), (1, 16)]
    assert [rep for rep, _ in recorded["rebuilds"]] == [rep0, rep1]
    for rep, graphs in recorded["rebuilds"]:
        assert _recaptured_keys(rep, graphs) == want
        assert rep.last_recapture["keys"] == want
    assert not set(map(id, rep0._graphs.values())) & set(
        map(id, rep1._graphs.values()))
    assert len(s.collect(s.dispatch(TEXTS * 2, ["v"] * 4))) == 4
    assert rep0.graph_replays[(2, 16)] == rep1.graph_replays[(2, 16)] == 1


@pytest.mark.parametrize("conf,want", [
    ("", ["expandable_segments:True"]),
    ("max_split_size_mb:512", ["expandable_segments:True"]),
    ("expandable_segments:False", []),
])
def test_expandable_segments_once_unless_the_environment_names_it(
        monkeypatch, conf, want):
    """The first engine on a card makes the allocator's segments
    expandable, once per process; a ``PYTORCH_CUDA_ALLOC_CONF`` that names
    the option keeps its say."""
    calls = []
    monkeypatch.setattr(torch.cuda.memory, "_set_allocator_settings",
                        calls.append)
    monkeypatch.setattr(graphs, "_EXPANDABLE", False)
    monkeypatch.setenv("PYTORCH_CUDA_ALLOC_CONF", conf)
    _port()  # an engine on the CPU leaves the allocator alone
    assert calls == [] and not graphs._EXPANDABLE
    graphs.expandable_segments()
    graphs.expandable_segments()
    assert calls == want
