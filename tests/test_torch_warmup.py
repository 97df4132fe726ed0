# -*- coding: utf-8 -*-
"""PyTorch port: the engine's warmup (``compile_stage_a/b``, ``warmup``,
``warmup_staged``, ``absorb_drain``, ``_narrow_inventory``), the launch
tally of a capture, ``device_trace`` and ``TTS_WARMUP`` on the HTTP and
MCP servers, on the CPU.

On the CPU no graph is captured: a warmed key runs its stage eagerly
through the same ``StageGraph.run`` and counts its replays, so the
bookkeeping here is the card's. The inventory logic is held against the
JAX engine on the same arguments, with the JAX compiles stubbed out (the
narrowing, pinning and restoring happen outside them). The JAX engine's
two faults in ``warmup_staged`` (ADVICE.md) are asserted as divergences:
the port's throwaway run neither swallows a concurrent first batch nor
leaves its ``__warmup__`` voice registered."""
import os
import threading
import time

import numpy as np
import pytest
import torch
from aiohttp.test_utils import TestClient, TestServer

from illufly_tts_tpu.engine.buckets import BATCH_BUCKETS
from illufly_tts_tpu.engine.synthesizer import Synthesizer as JaxSynthesizer
from illufly_tts_tpu_torch.api import auth as port_auth
from illufly_tts_tpu_torch.api import endpoints as port_endpoints
from illufly_tts_tpu_torch.engine import graphs
from illufly_tts_tpu_torch.engine.synthesizer import FORMATS, Synthesizer
from illufly_tts_tpu_torch.mcp import protocol as port_protocol
from illufly_tts_tpu_torch.mcp import server as port_server
from illufly_tts_tpu_torch.ops import adain_snake_conv as asc
from illufly_tts_tpu_torch.ops import capture_tally
from illufly_tts_tpu_torch.ops import istft_oa as oa
from illufly_tts_tpu_torch.pipeline import CachedTTSPipeline
from illufly_tts_tpu_torch.utils.profiling import device_trace
from tests.test_model import tiny_config
from tests.test_torch_params import port_config

torch.set_num_threads(2)

BUCKETS = dict(token_buckets=(16, 32), frame_buckets=(32, 64, 128))
TEXTS = ["ni→xau↓", "tsʰɤ↘ʂɨ↘i↗kɤ↘"]


def _port(**buckets):
    s = Synthesizer(port_config(), seed=3, device="cpu",
                    **(buckets or BUCKETS))
    s.register_random_voice("v", seed=3)
    return s


@pytest.fixture(scope="module")
def jax_synth():
    """One JAX engine whose compiles are never run (the tests stub them
    per instance attribute and reset its inventory)."""
    return JaxSynthesizer(config=tiny_config(), **BUCKETS)


def _stub_jax(jax_synth, monkeypatch, calls):
    monkeypatch.setattr(jax_synth, "compile_stage_a",
                        lambda b, t: calls.append((b, t)) or 0.0)
    monkeypatch.setattr(jax_synth, "compile_stage_b",
                        lambda b, t, f, fmt="pcm16":
                        calls.append((b, t, f, fmt)) or 0.0)
    for name, value in BUCKETS.items():
        monkeypatch.setattr(jax_synth, name, value)
    monkeypatch.setattr(jax_synth, "batch_buckets", BATCH_BUCKETS)


def _inventory(s):
    return s.batch_buckets, s.token_buckets, s.frame_buckets


def _launch_counts():
    return {"istft_oa": oa.launches, "istft_head_bf16": oa.launches_bf16,
            **asc.launches, **asc.launches_bf16}


@pytest.mark.parametrize("inventory,preferred", [
    ((16, 32, 64), (32,)),
    ((16, 32, 64), (64, 256)),            # 256 is not in the inventory
    ((64, 128, 256, 512), (64, 256)),
    ((64, 128, 256, 512), (1000,)),       # none is: the whole inventory
    ((64, 128, 256, 512, 1024, 4096), (512, 256)),
    ((1, 2, 4, 8, 16), (8,)),
])
def test_narrow_inventory_matches_jax(inventory, preferred):
    assert (Synthesizer._narrow_inventory(inventory, preferred)
            == JaxSynthesizer._narrow_inventory(inventory, preferred))


@pytest.mark.parametrize("kw", [
    dict(batch_sizes=(1, 4), token_sizes=(16,), frame_sizes=(32, 64)),
    dict(batch_sizes=(2,), token_sizes=(32, 64), frame_sizes=None),
    dict(batch_sizes=(1,), token_sizes=(16,), frame_sizes=(256,),
         formats=("pcm16", "mulaw8k")),
])
def test_warmup_narrow_matches_jax(kw, jax_synth, monkeypatch):
    """``warmup(narrow=True)`` leaves the JAX engine's inventory and warms
    the keys the JAX engine compiles."""
    calls = []
    _stub_jax(jax_synth, monkeypatch, calls)
    jax_synth.warmup(narrow=True, **kw)
    port = _port()
    port.warmup(narrow=True, **kw)
    assert _inventory(port) == _inventory(jax_synth)
    assert set(port._graphs) == set(calls)
    assert port.graph_replays == {}  # warming replays nothing


def test_absorb_drain_warmed_format_with_args(monkeypatch):
    """Mirrors ``tests/test_synthesizer.py``: ``absorb_drain(batch=,
    tokens=)`` runs the warmed format for that shape (an engine that warmed
    f32 serves no pcm16 stage B for it) and warms no key."""
    s = _port(token_buckets=(16,), frame_buckets=(32, 64))
    s.warmup(batch_sizes=(1,), token_sizes=(16,), frame_sizes=(32, 64),
             formats=("f32",))
    keys = set(s._graphs)
    fmts = []
    stage_b = s._stage_b
    monkeypatch.setattr(s, "_stage_b",
                        lambda *a: fmts.append(a[-1]) or stage_b(*a))
    s.absorb_drain(batch=1, tokens=16)
    assert set(s._graphs) == keys
    assert fmts and set(fmts) == {"f32"}
    assert s.graph_replays[(1, 16)] == 1


def test_absorb_drain():
    """Mirrors ``tests/test_synthesizer.py``: one throwaway call, no temp
    voice left behind, a duration; ``warmup(absorb=True)`` records it.
    The port's drain does not count as a first served batch."""
    s = _port()
    voices_before = set(s.list_voices())
    dt = s.absorb_drain()
    assert isinstance(dt, float) and dt >= 0.0
    assert set(s.list_voices()) == voices_before
    assert "__drain__" not in s._voices
    s.warmup(batch_sizes=(1,), token_sizes=(16,), frame_sizes=(32,),
             absorb=True)
    assert s.last_drain_s is not None and s.last_drain_s >= 0.0
    assert not s._first_serve.is_set()


@pytest.mark.parametrize("narrow", [False, True])
def test_warmup_staged_pins_then_restores_as_jax(narrow, jax_synth,
                                                 monkeypatch):
    """The primary key first and the inventory pinned to it; the
    background thread waits for the first collect, warms the rest and
    restores the JAX engine's full inventory. No ``__warmup__`` voice is
    left (the JAX engine leaves one: a divergence)."""
    kw = dict(batch_sizes=(1, 2), token_sizes=(16, 32),
              frame_sizes=(32, 64), absorb=True, narrow=narrow)
    calls = []
    _stub_jax(jax_synth, monkeypatch, calls)
    monkeypatch.setattr(jax_synth, "synthesize_batch", lambda *a, **k: [])
    monkeypatch.setattr(jax_synth, "absorb_drain", lambda **k: 0.0)
    monkeypatch.setattr(jax_synth, "_voices", {})
    _, jax_thread = jax_synth.warmup_staged(defer_background=0.01, **kw)
    jax_pinned = _inventory(jax_synth)
    jax_thread.join(timeout=60)
    assert not jax_thread.is_alive()
    assert "__warmup__" in jax_synth._voices  # the JAX engine's leftover

    s = _port()
    pri_s, thread = s.warmup_staged(defer_background=120.0, **kw)
    assert pri_s > 0.0 and set(s.last_warmup_phases) == {
        "capture_s", "first_run_s", "aot_s", "load_exec_s"}
    phases = s.last_warmup_phases
    assert phases["aot_s"] == round(phases["capture_s"], 1)
    assert phases["load_exec_s"] == round(phases["first_run_s"], 1)
    assert _inventory(s) == jax_pinned == ((2,), (32,), (64,))
    assert set(s._graphs) == {(2, 32), (2, 32, 64, "pcm16")}
    assert "__warmup__" not in s._voices
    assert "__warmup__" not in s.list_voices()
    # the drain and the throwaway run did not release the background pass
    time.sleep(0.3)
    assert thread.is_alive() and not s._first_serve.is_set()
    h = s.dispatch(TEXTS[:1], ["v"])
    assert (h.b_bucket, h.t_bucket) == (2, 32)  # padded to the primary key
    s.collect(h)
    assert s.graph_replays[(2, 32)] >= 1
    assert s.graph_replays[(2, 32, 64, "pcm16")] >= 1
    thread.join(timeout=120)
    assert not thread.is_alive()
    assert _inventory(s) == _inventory(jax_synth)
    assert set(s._graphs) == {
        *((b, t) for b in (1, 2) for t in (16, 32)),
        *((b, t, f, "pcm16") for b in (1, 2) for t in (16, 32)
          for f in (32, 64))}
    assert set(calls) == set(s._graphs)


def test_staged_throwaway_keeps_a_concurrent_first_batch(jax_synth,
                                                         monkeypatch):
    """A batch another thread collects during the throwaway run releases
    the background pass on the port. The JAX engine swaps the event for
    the throwaway run and drops that release (ADVICE.md): a divergence."""
    kw = dict(batch_sizes=(1,), token_sizes=(16,), frame_sizes=(32,))
    _stub_jax(jax_synth, monkeypatch, [])
    monkeypatch.setattr(jax_synth, "_first_serve", threading.Event())

    def jax_traffic(*a, **k):  # a concurrent collect's release
        t = threading.Thread(target=jax_synth._first_serve.set)
        t.start()
        t.join(10)
        return []

    monkeypatch.setattr(jax_synth, "synthesize_batch", jax_traffic)
    _, jax_thread = jax_synth.warmup_staged(defer_background=0.01, **kw)
    assert not jax_synth._first_serve.is_set()
    jax_thread.join(timeout=60)

    s = _port()
    throwaway = s.synthesize_batch

    def with_traffic(*a, **k):
        t = threading.Thread(
            target=lambda: s.collect(s.dispatch(TEXTS[:1], ["v"])))
        t.start()
        t.join(60)
        return throwaway(*a, **k)

    monkeypatch.setattr(s, "synthesize_batch", with_traffic)
    _, thread = s.warmup_staged(defer_background=120.0, **kw)
    assert s._first_serve.is_set()
    thread.join(timeout=60)
    assert not thread.is_alive()


@pytest.mark.parametrize("fmt", FORMATS)
def test_warmed_render_equals_unwarmed(fmt):
    """Replayed keys give the eager render bit for bit: batch, exact
    stream (from a replayed handle) and windowed stream. The windowed
    stream's keys are recorded at first use in both engines; no batch key
    of the unwarmed engine replays."""
    buckets = dict(token_buckets=(32,), frame_buckets=(64,),
                   batch_buckets=(2,))
    cold, warm = _port(**buckets), _port(**buckets)
    warm.warmup(batch_sizes=(2,), token_sizes=(32,), frame_sizes=(64,),
                formats=(fmt,))
    voices = ["v"] * 2
    for s in (cold, warm):
        s.out = s.collect(s.dispatch(TEXTS, voices, fmt=fmt))
        s.exact = np.concatenate(list(s.stream_decode(
            s.dispatch(TEXTS, voices, fmt=fmt), window_frames=16)), axis=1)
        s.windowed = np.concatenate(list(s.stream_decode(
            s.dispatch(TEXTS, voices, fmt=fmt), 16, 4, exact=False)), axis=1)
    assert warm.graph_replays[(2, 32, 64, fmt)] == 2
    assert warm.graph_replays[(2, 32)] == 3
    stream_keys = {("prep", 2, 32, 64): 1, ("win", 2, 64, 32, 8): 4}
    assert cold.graph_replays == stream_keys
    assert {k: warm.graph_replays[k] for k in stream_keys} == stream_keys
    for a, b in zip(cold.out, warm.out):
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
    assert cold.exact.tobytes() == warm.exact.tobytes()
    for i, clip in enumerate(warm.out):
        assert warm.exact[i, : clip.size].tobytes() == clip.tobytes()
    assert cold.windowed.tobytes() == warm.windowed.tobytes()


def test_handles_own_their_stage_outputs():
    """Two batches dispatched on one warmed key before either decodes (the
    scheduler's order) each keep their own stage-A outputs and audio."""
    s = _port()
    s.warmup(batch_sizes=(1,), token_sizes=(16,), frame_sizes=(32, 64, 128))
    alone = [s.collect(s.dispatch([t], ["v"]))[0] for t in TEXTS]
    h1, h2 = (s.dispatch([t], ["v"]) for t in TEXTS)
    s.launch_decode(h2)
    both = [s.collect(h1)[0], s.collect(h2)[0]]
    assert [a.tobytes() for a in alone] == [b.tobytes() for b in both]


def test_load_params_drops_the_graphs(tmp_path):
    s = _port()
    s.warmup(batch_sizes=(1,), token_sizes=(16,), frame_sizes=(32, 64, 128),
             formats=("f32",))
    path = str(tmp_path / "w.msgpack")
    fresh = Synthesizer(port_config(), seed=11, device="cpu", **BUCKETS)
    fresh.register_random_voice("v", seed=3)
    fresh.save_params(path)
    s.load_params(path)
    assert s._graphs == {}
    replays = dict(s.graph_replays)
    got = s.synthesize_batch(TEXTS, ["v"] * 2, fmt="f32")
    want = fresh.synthesize_batch(TEXTS, ["v"] * 2, fmt="f32")
    assert dict(s.graph_replays) == replays  # nothing replayed
    assert [a.tobytes() for a in got] == [b.tobytes() for b in want]


def test_capture_tally_and_replayed_launches(monkeypatch):
    """A capturing thread's launch counts go to its tally, another
    thread's to the counters; ``add_launches`` adds a tally per replay."""
    monkeypatch.setattr(oa, "launches", 0)
    monkeypatch.setattr(oa, "launches_bf16", 0)
    for table in (asc.launches, asc.launches_bf16):
        for name in table:
            monkeypatch.setitem(table, name, 0)
    with capture_tally.captured() as tally:
        asc.count_launch("adain_snake_conv")
        asc.count_launch("adain_snake_conv_carry", 3)
        asc.count_launch("adain_snake_conv_bf16", 2)
        oa.count_launch()
        oa.count_launch(bf16=True)
        other = threading.Thread(
            target=lambda: asc.count_launch("adain_snake_conv", 5))
        other.start()
        other.join(10)
    assert tally == {"adain_snake_conv": 1, "adain_snake_conv_carry": 3,
                     "adain_snake_conv_bf16": 2, "istft_oa": 1,
                     "istft_head_bf16": 1}
    base = _launch_counts()
    assert base["adain_snake_conv"] == 5
    assert sum(base.values()) == 5
    graphs.add_launches(tally)
    graphs.add_launches(tally, times=2)
    after = _launch_counts()
    assert {k: after[k] - base[k] for k in after} == {
        k: 3 * tally.get(k, 0) for k in after}


def test_device_trace_writes_a_trace(tmp_path, monkeypatch):
    with device_trace(str(tmp_path), device="cpu") as prof:
        torch.ones(64).sum()
    files = os.listdir(tmp_path)
    assert len(files) == 1 and files[0].endswith(".json")
    assert (tmp_path / files[0]).stat().st_size > 0
    assert len(prof.key_averages()) > 0
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        with device_trace(str(tmp_path / "cuda")):
            pass


def _serving_synth():
    return Synthesizer(port_config(), seed=5, device="cpu",
                       token_buckets=(64,), frame_buckets=(128,),
                       batch_buckets=(1, 8))


async def test_startup_warmup_env_on_the_port_engine(tmp_path, monkeypatch):
    """Mirrors ``tests/test_api.py::test_startup_warmup_env`` with the
    port's engine: ``TTS_WARMUP=1`` calls its ``warmup_staged`` once with
    the JAX server's arguments; the first request replays the primary key,
    and the background pass then warms the rest."""
    monkeypatch.setenv("TTS_WARMUP", "1")
    monkeypatch.setenv("FASTAPI_SECRET_KEY", "test-secret")
    monkeypatch.delenv("TTS_DEV_MODE", raising=False)
    synth = _serving_synth()
    calls = []
    staged = synth.warmup_staged

    def spy(**kw):
        out = staged(**kw)
        calls.append((kw, out[1]))
        return out

    monkeypatch.setattr(synth, "warmup_staged", spy)
    app = port_endpoints.create_app(
        output_dir=str(tmp_path), pipeline=CachedTTSPipeline(synthesizer=synth),
        batch_size=8, max_wait_time=0.02)
    client = TestClient(TestServer(app))
    await client.start_server()
    try:
        assert len(calls) == 1
        kw, thread = calls[0]
        assert kw["absorb"] is True and kw["narrow"] is True
        assert kw["batch_sizes"] == (1, 8)
        assert set(kw["frame_sizes"]) == {256, 512}
        primary = [k for k in synth._graphs if len(k) == 4]
        assert len(primary) == 1 and primary[0][:3] == (8, 64, 128)
        # the drain and the throwaway run replayed it once each
        assert synth.graph_replays == {(8, 64): 2, primary[0]: 2}
        assert not synth._first_serve.is_set() and thread.is_alive()
        token = port_auth.create_access_token("u")
        resp = await client.post(
            "/api/tts", json={"text": "你好。"},
            headers={"Authorization": f"Bearer {token}"})
        assert resp.status == 200, await resp.text()
        assert synth.graph_replays[(8, 64)] == 3
        assert synth.graph_replays[primary[0]] == 3
        thread.join(timeout=120)
        assert not thread.is_alive()
        assert synth.batch_buckets == (1, 8)
        assert {k[0] for k in synth._graphs} == {1, 8}
    finally:
        await client.close()


async def test_mcp_startup_warmup_env_on_the_port_engine(tmp_path,
                                                         monkeypatch):
    """The MCP server's counterpart: ``TTS_WARMUP=1`` warms the port's
    engine through ``warmup`` (the JAX server's arguments; narrowed to the
    engine's own inventory), and a tool call then replays."""
    monkeypatch.setenv("TTS_WARMUP", "1")
    synth = _serving_synth()
    calls = []
    warmup = synth.warmup
    monkeypatch.setattr(synth, "warmup",
                        lambda **kw: calls.append(kw) or warmup(**kw))
    backend = port_server.ManagerBackend(
        pipeline=CachedTTSPipeline(synthesizer=synth),
        output_dir=str(tmp_path), max_wait_time=0.02, batch_size=8)
    server = port_server.MCPServer(backend)
    try:
        await backend.start()
        assert len(calls) == 1
        assert calls[0]["absorb"] is True and calls[0]["narrow"] is True
        assert calls[0]["batch_sizes"] == (1, 8)
        assert set(calls[0]["frame_sizes"]) == {256, 512}
        assert set(synth._graphs) == {(1, 64), (8, 64),
                                      (1, 64, 128, "pcm16"),
                                      (8, 64, 128, "pcm16")}
        assert synth.last_drain_s is not None
        before = sum(synth.graph_replays.values())
        reply = await server.handle_message(port_protocol.request(
            1, "tools/call", {"name": "text_to_speech",
                              "arguments": {"text": "你好。"}}))
        result = port_protocol.parse_content_text(reply["result"])
        assert result["status"] == "success", result
        assert sum(synth.graph_replays.values()) == before + 2
    finally:
        await backend.stop()
