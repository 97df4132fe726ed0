# -*- coding: utf-8 -*-
"""PyTorch port: ``TIMERS``, the one span recorder (``utils/profiling.py``).

Off (no profiler running) a span adds to its totals and nothing else; under
a ``torch.profiler`` it is kept with its batch and parent on the profiler's
own clock. The engine's ``dispatch``/``launch``/``collect``/``model`` mean
the same on the blocking and the split paths; the scheduler records its
four waits; the audio cache counts its hits; the engine records no device
event on the CPU or while a stream captures."""
import asyncio
import sys
import threading
import time
from collections import Counter

import numpy as np
import pytest
import torch
from torch.autograd import profiler as autograd_profiler
from torch.profiler import ProfilerActivity, profile

from illufly_tts_tpu_torch.engine.synthesizer import Synthesizer
from illufly_tts_tpu_torch.pipeline import CachedTTSPipeline
from illufly_tts_tpu_torch.runtime.scheduler import TTSServiceManager
from illufly_tts_tpu_torch.utils import profiling
from illufly_tts_tpu_torch.utils.profiling import TIMERS, StageTimers
from tests.test_torch_params import port_config

torch.set_num_threads(2)

MODEL_SPANS = ("dispatch", "launch", "collect", "model")


def _cpu_profiler():
    return profile(activities=[ProfilerActivity.CPU])


@pytest.fixture(scope="module")
def pipe():
    synth = Synthesizer(port_config(), seed=5, device="cpu",
                        token_buckets=(32, 64), frame_buckets=(64, 128))
    synth.register_random_voice("zf_001", seed=5)
    return CachedTTSPipeline(synthesizer=synth)


def test_the_recording_flag_is_the_profilers():
    """``recording()`` reads ``torch.autograd.profiler._is_profiler_enabled``,
    which a ``torch.profiler`` sets while it runs: a torch that renames or
    drops the flag fails here."""
    assert isinstance(autograd_profiler._is_profiler_enabled, bool)
    assert not TIMERS.recording()
    with _cpu_profiler():
        assert autograd_profiler._is_profiler_enabled is True
        assert TIMERS.recording()
    assert autograd_profiler._is_profiler_enabled is False
    assert not TIMERS.recording()


def test_off_counts_totals_and_records_nothing(monkeypatch):
    opened = []
    monkeypatch.setattr(torch.profiler, "record_function",
                        lambda name: opened.append(name))
    t = StageTimers()
    for _ in range(3):
        with t.track("frontend", batch=7) as span:
            time.sleep(0.001)
        assert span.t0_ns is None and span.seconds >= 0.001
    t.add("queue_wait", 0.5, t0_ns=1, t1_ns=2, batch="task")
    assert t.count["frontend"] == 3 and t.total["frontend"] >= 0.003
    assert t.count["queue_wait"] == 1 and t.total["queue_wait"] == 0.5
    assert t.spans() == [] and opened == [] and t.dropped == 0
    assert t.current_batch() is None
    assert set(t.snapshot()) == {"frontend", "queue_wait"}


def test_spans_bracket_the_profilers_events():
    """Each span's (t0_ns, t1_ns) holds the kineto event of a
    ``record_function`` opened inside it: the spans are on the profiler's
    clock. Nested spans take their parent's name and batch."""
    t = StageTimers()
    with _cpu_profiler() as prof:
        for i in range(3):
            with t.track("outer", batch=i):
                with t.track("inner"):
                    assert t.current_batch() == i
                    with torch.profiler.record_function(f"probe_{i}"):
                        torch.ones(64).sum()
    events = {e.name(): e for e in prof.profiler.kineto_results.events()}
    inner = [s for s in t.spans() if s.name == "inner"]
    assert [(s.batch, s.parent) for s in inner] == [(0, "outer"),
                                                    (1, "outer"),
                                                    (2, "outer")]
    for s in inner:
        probe = events[f"probe_{s.batch}"]
        end = probe.start_ns() + probe.duration_ns()
        assert s.t0_ns <= probe.start_ns() <= end <= s.t1_ns
    # the spans' own record_function events are in the trace too
    assert {"outer", "inner"} <= set(events)
    outer = [s for s in t.spans() if s.name == "outer"]
    assert all(o.t0_ns <= i.t0_ns <= i.t1_ns <= o.t1_ns
               for o, i in zip(outer, inner))
    assert t.count["inner"] == 3


def test_a_full_ring_counts_what_it_drops():
    t = StageTimers(capacity=4)
    with _cpu_profiler():
        for _ in range(10):
            with t.track("s"):
                pass
        t.add("w", 0.1, t0_ns=5)
    assert len(t.spans()) == 4 and t.dropped == 7
    assert t.count["s"] == 10 and t.count["w"] == 1
    t.clear()
    assert t.spans() == [] and t.dropped == 0 and t.count["s"] == 10


def test_totals_exact_under_threads():
    t = StageTimers()
    n_threads, n_spans = 8, 2000
    start = threading.Barrier(n_threads)
    old = sys.getswitchinterval()

    def work():
        start.wait()
        for _ in range(n_spans):
            with t.track("a"):
                pass
            t.add("b", 1.0)

    try:
        sys.setswitchinterval(1e-6)
        threads = [threading.Thread(target=work) for _ in range(n_threads)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=120)
        assert not any(th.is_alive() for th in threads)
    finally:
        sys.setswitchinterval(old)
    assert t.count["a"] == t.count["b"] == n_threads * n_spans
    assert t.total["b"] == float(n_threads * n_spans)


class _Event:
    """A CUDA event's stand-in: its time in ms, passed once ``done``."""

    def __init__(self, ms, done=True):
        self.ms, self.done = ms, done

    def query(self):
        return self.done

    def elapsed_time(self, other):
        return other.ms - self.ms


def test_device_pairs_resolve_once_passed_and_never_wait():
    t = StageTimers()
    t.add_device("stage_a", _Event(10.0), _Event(12.5), 1, "cuda:0")
    t.add_device("stage_b", _Event(12.5), _Event(20.0), 1, "cuda:0")
    late = _Event(26.0, done=False)
    t.add_device("stage_a", _Event(21.0), late, 2, "cuda:0")
    spans = t.device_spans()
    assert [(s.name, s.start_ms, s.ms, s.batch) for s in spans] == [
        ("stage_a", 0.0, 2.5, 1), ("stage_b", 2.5, 7.5, 1)]
    late.done = True
    assert t.device_spans()[-1] == profiling.DeviceSpan(
        "stage_a", 11.0, 5.0, 2, "cuda:0")


def test_no_device_event_on_the_cpu_or_while_capturing(monkeypatch):
    with _cpu_profiler():
        assert TIMERS.device_start("stage_a", torch.device("cpu")) is None
        monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                            lambda: True)
        assert TIMERS.device_start("stage_a", torch.device("cuda")) is None


def test_a_warmed_cpu_engine_records_no_device_event(pipe):
    """On the CPU a warmed key replays through ``StageGraph.run`` with no
    graph: host spans, no device span."""
    synth = pipe.synthesizer
    synth.warmup(batch_sizes=(1,), token_sizes=(32,), frame_sizes=(64,))
    TIMERS.clear()
    with _cpu_profiler():
        h = synth.dispatch(["ni→xau"], ["zf_001"])
        synth.collect(h)
    assert sum(synth.graph_replays.values()) >= 1
    assert TIMERS.device_spans() == [] and not TIMERS._marks
    assert {s.name for s in TIMERS.spans()} >= set(MODEL_SPANS)


def _batch_spans(run):
    """Run ``run()`` under a profiler -> (its spans of the model, the
    totals and counts it added)."""
    TIMERS.clear()
    before = {k: (TIMERS.count[k], TIMERS.total[k]) for k in MODEL_SPANS}
    with _cpu_profiler():
        run()
    added = {k: (TIMERS.count[k] - before[k][0],
                 TIMERS.total[k] - before[k][1]) for k in MODEL_SPANS}
    return [s for s in TIMERS.spans() if s.name in MODEL_SPANS], added


@pytest.mark.parametrize("path", ["blocking", "split", "timestamps"])
def test_model_spans_mean_the_same_on_every_path(pipe, path):
    texts, voices = ["你好。", "今天天气很好。"], ["zf_001"] * 2

    def run():
        uncached = super(CachedTTSPipeline, pipe)  # every row computed
        if path == "blocking":
            uncached.batch_process_texts(texts, voices)
        elif path == "timestamps":
            pipe.batch_process_texts_with_timestamps(texts, voices)
        else:
            h = uncached.dispatch_texts(texts, voices)
            uncached.launch_decode(h)
            uncached.collect_batch(h)

    spans, added = _batch_spans(run)
    assert Counter(s.name for s in spans) == {k: 1 for k in MODEL_SPANS}
    by = {s.name: s for s in spans}
    assert len({s.batch for s in spans}) == 1 and spans[0].batch is not None
    for child in ("dispatch", "launch", "collect"):
        assert by[child].parent == "model"
    assert by["dispatch"].t1_ns <= by["launch"].t0_ns
    assert by["launch"].t1_ns <= by["collect"].t0_ns
    assert by["model"].t0_ns == by["dispatch"].t0_ns
    assert by["model"].t1_ns >= by["collect"].t1_ns
    assert all(added[k][0] == 1 for k in MODEL_SPANS)
    children = sum(added[k][1] for k in ("dispatch", "launch", "collect"))
    assert added["model"][1] == pytest.approx(children, rel=1e-9)


def test_audio_cache_counts_hits_and_misses(pipe):
    pipe.clear_caches()
    for key in [k for k in pipe.cache_stats if k.startswith("audio_")]:
        pipe.cache_stats[key] = 0
    texts, voices = ["缓存。", "缓存。", "另一句。"], ["zf_001"] * 3
    pipe.batch_process_texts(texts, voices)
    stats = pipe.get_cache_stats()
    assert (stats["audio_hits"], stats["audio_misses"]) == (0, 3)
    h = pipe.dispatch_texts(texts[:2], voices[:2])
    pipe.launch_decode(h)
    pipe.collect_batch(h)
    stats = pipe.get_cache_stats()
    assert (stats["audio_hits"], stats["audio_misses"]) == (2, 3)
    assert stats["audio_hit_rate"] == pytest.approx(0.4)
    assert not any(k.startswith("voice") for k in stats)


class _StubPipeline:
    """The split-phase surface, each phase a fixed sleep."""

    sample_rate = 24000
    supports_split_phase = True

    def load_voice(self, voice_id):
        return np.zeros((1, 256), np.float32)

    def dispatch_texts(self, texts, voice_ids, speeds=None,
                       output_format="f32"):
        time.sleep(0.01)
        return list(texts)

    def launch_decode(self, handle):
        return handle

    def collect_batch(self, handle, output_format="f32"):
        time.sleep(0.2)
        return [np.zeros(2400, np.float32) for _ in handle]


async def test_scheduler_waits():
    """One task alone waits out the whole coalescing window; two more
    users' tasks, in one batch behind the first batch's collect, wait for
    the head of the decode queue; every task whose poller ran before it
    finished records its ``poll_wait``."""
    window = 0.2
    manager = TTSServiceManager(pipeline=_StubPipeline(), batch_size=2,
                                max_wait_time=window)
    TIMERS.clear()
    await manager.start()
    try:
        with _cpu_profiler():
            first = await manager.submit_task("a", user_id="u1")
            await asyncio.sleep(window + 0.02)
            more = [await manager.submit_task(x, user_id=u)
                    for x, u in (("b", "u2"), ("c", "u3"))]
            ids = [first] + more

            async def drain(tid):
                return [c async for c in manager.stream_result(tid)]

            assert all(await asyncio.gather(*map(drain, ids)))
    finally:
        await manager.shutdown()
    spans = TIMERS.spans()
    by = {(s.name, s.batch): s for s in spans}
    for tid in ids:
        task = manager.tasks[tid]
        status = task.to_status_dict()
        assert (status["created_at"] <= status["dispatched_at"]
                <= status["completed_at"])
        q, c = by[("queue_wait", tid)], by[("coalesce_wait", tid)]
        assert c.parent == "queue_wait" and q.t0_ns <= c.t0_ns <= c.t1_ns
        assert c.t1_ns == q.t1_ns
        assert ("head_wait", tid) in by and ("poll_wait", tid) in by
    alone = by[("coalesce_wait", first)]
    assert window * 0.9e9 <= alone.t1_ns - alone.t0_ns <= (window + 0.1) * 1e9
    assert manager.tasks[first].coalesce_s >= window * 0.9
    for tid in more:
        # at most the moment between the two submits in the window, then
        # the first batch's collect ahead of theirs
        assert manager.tasks[tid].coalesce_s < window / 2
        head = by[("head_wait", tid)]
        assert head.t1_ns - head.t0_ns >= 0.05e9
    stages = manager.stats()["stage_timers"]
    assert {"queue_wait", "coalesce_wait", "head_wait",
            "poll_wait"} <= set(stages)
    poll = by[("poll_wait", first)]
    assert 0 <= poll.t1_ns - poll.t0_ns <= 0.5e9
