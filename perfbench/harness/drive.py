"""Deployments and their windows, one per ``deployment.kind`` of a cell:

- ``scheduler``: ``TTSServiceManager`` over ``CachedTTSPipeline``, as
  ``serve`` runs them; requests submitted on their schedule
  (``submit_task``) and their audio awaited through ``stream_result``, as
  the HTTP handlers wait;
- ``stream``: ``CachedTTSPipeline.stream_process``, windowed, one stream
  after another;
- ``offline``: ``CachedTTSPipeline.dispatch_texts`` / ``launch_decode`` /
  ``collect_batch`` over batches, later batches' stages launched before
  this batch is collected (``ahead_batches`` deep).

Each ``setup`` builds and warms the system; each ``window`` drives it for
the run's seconds and returns one record per request."""
from __future__ import annotations

import asyncio
import time
from typing import Callable, Dict, List

import numpy as np


class Session:
    """What a deployment holds between set-up and check."""

    def __init__(self, **kw):
        self.__dict__.update(kw)


# ---- scheduler ---------------------------------------------------------------


def setup_scheduler(s: Session) -> None:
    from illufly_tts_tpu_torch.runtime.scheduler import TTSServiceManager

    dep = s.cell["deployment"]
    s.synth.warmup(**{k: tuple(v) if isinstance(v, list) else v
                      for k, v in dep["warmup"].items()})
    s.manager = TTSServiceManager(pipeline=s.pipe,
                                  batch_size=dep["batch_size"],
                                  max_wait_time=dep["max_wait_time"])
    s.loop = asyncio.new_event_loop()
    s.loop.run_until_complete(s.manager.start())
    prefill = [r for r in s.prefill]
    if prefill:
        # the prompts every client asks for, served once before traffic, as
        # a deployment that has run a while holds them
        s.loop.run_until_complete(_serve_all(s, prefill, None))


async def _serve_all(s: Session, requests, t0, deadline=None):
    fmt = s.cell["deployment"]["output_format"]
    out: List[dict] = [None] * len(requests)

    async def one(i, r):
        if t0 is not None:
            await asyncio.sleep(max(0.0, t0 + r["due"] - time.perf_counter()))
        due = time.perf_counter() if t0 is None else t0 + r["due"]
        sent = time.perf_counter()
        audio = None
        try:
            tid = await s.manager.submit_task(
                r["text"], voice_id=s.voice_names[r["voice"]],
                user_id=r.get("user"), output_format=fmt)
            parts = [c async for c in s.manager.stream_result(tid)]
            if s.manager.tasks[tid].status.value == "completed" and parts:
                audio = np.concatenate(parts)
        except Exception as exc:  # the request failed: counted, not raised
            s.errors.append(repr(exc))
        done = time.perf_counter()
        out[i] = {**r, "audio": audio, "latency": done - due,
                  "late": sent - due, "done": done}

    tasks = [asyncio.ensure_future(one(i, r)) for i, r in enumerate(requests)]
    await asyncio.wait(tasks, timeout=deadline)
    for t in tasks:
        if not t.done():
            t.cancel()
    return out


def window_scheduler(s: Session, seconds: float, tracer):
    """The whole window is traced: the scheduler's worker threads launch
    work concurrently, and a profiler stopped under them hung a run."""
    t0 = time.perf_counter()
    tracer.start()
    recs = s.loop.run_until_complete(
        _serve_all(s, s.requests, t0, deadline=seconds + 60.0))
    s.window_s = seconds
    s.t_end = time.perf_counter()
    return [r if r is not None else {**q, "audio": None, "latency": None}
            for r, q in zip(recs, s.requests)]


def close_scheduler(s: Session) -> None:
    s.loop.run_until_complete(s.manager.shutdown())
    s.loop.close()


# ---- stream -------------------------------------------------------------------


def setup_stream(s: Session) -> None:
    """Every (tokens, frames) stream key the seed's texts reach is
    captured before the window: stage A over the texts in batches gives
    each text's frame total, hence its key; one text of each key streams
    once."""
    from illufly_tts_tpu_torch.engine.buckets import pick

    dep = s.cell["deployment"]
    synth = s.synth
    seen: Dict[tuple, dict] = {}
    s.recorder.on = False
    for k in range(0, len(s.requests), 32):
        group = s.requests[k:k + 32]
        h = synth.dispatch([r["ipa"] for r in group],
                           [s.voice_names[r["voice"]] for r in group],
                           keep_durations=True)
        totals = h.host_pred_dur.numpy().sum(axis=1)
        for r, total in zip(group, totals):
            key = (pick(synth.token_buckets, len(r["ipa"]) + 2),
                   pick(synth.frame_buckets, int(total)))
            seen.setdefault(key, r)
    s.recorder.on = True
    for r in seen.values():
        _stream_one(s, r, dep)
    s.recorder.batches.clear()
    s.stream_keys = sorted(seen)


def _stream_one(s: Session, r: dict, dep: dict) -> dict:
    t = time.perf_counter()
    first, parts, audio = None, [], None
    try:
        for chunk in s.pipe.stream_process(
                r["text"], voice_id=s.voice_names[r["voice"]],
                window_frames=dep["window_frames"],
                halo_frames=dep["halo_frames"], exact=False):
            if first is None:
                first = time.perf_counter() - t
            parts.append(chunk)
        audio = np.concatenate(parts) if parts else None
    except ValueError as exc:  # a stream the engine cannot window
        s.errors.append(repr(exc))
    s.recorder.close_all()
    return {**r, "audio": audio, "first_audio": first, "sent": t,
            "done": time.perf_counter()}


def window_stream(s: Session, seconds: float, tracer):
    dep = s.cell["deployment"]
    out = []
    t0 = time.perf_counter()
    tracer.start()
    for r in s.requests:
        if time.perf_counter() - t0 >= seconds:
            break
        out.append(_stream_one(s, r, dep))
        tracer.due()
    s.t_end = time.perf_counter()
    s.window_s = s.t_end - t0
    if len(out) == len(s.requests):
        raise RuntimeError("the stream mix ran out of texts inside the "
                           "window: raise its 'streams'")
    return out


# ---- offline ------------------------------------------------------------------


def setup_offline(s: Session) -> None:
    dep = s.cell["deployment"]
    s.synth.warmup(**{k: tuple(v) if isinstance(v, list) else v
                      for k, v in dep["warmup"].items()})
    s.batch = s.mix["batch"]


def window_offline(s: Session, seconds: float, tracer):
    """Batches kept ``ahead_batches`` deep (the deployment's; 1 where it
    gives none) at each of two lags: a batch's stage B is launched once
    that many later batches have their stage A dispatched, and collected
    once that many later batches are launched. Stage B waits for its own
    stage A's frame totals, which the device reaches only after every
    stage B queued before it, so the device keeps about ``ahead_batches``
    renders queued while the host frontends the batches behind them, and
    a host that stands still for less than that costs no device time.
    When the window's time is up nothing more is dispatched; every batch
    dispatched is launched and collected, and the clock read after."""
    from collections import deque

    fmt = s.cell["deployment"]["output_format"]
    ahead = int(s.cell["deployment"].get("ahead_batches", 1))
    batches = [s.requests[i:i + s.batch]
               for i in range(0, len(s.requests), s.batch)]
    voices = [s.voice_names[0]] * s.batch
    staged, launched = deque(), deque()  # (batch, dispatch time, handle)
    out = []

    def collect():
        b, sent, h = launched.popleft()
        audios = s.pipe.collect_batch(h, fmt)
        done = time.perf_counter()
        out.extend({**r, "audio": a, "sent": sent, "done": done}
                   for r, a in zip(b, audios))
        tracer.due()

    def launch():
        item = staged.popleft()
        s.pipe.launch_decode(item[2])
        launched.append(item)
        if len(launched) > ahead:
            collect()

    t0 = time.perf_counter()
    tracer.start()
    for b in batches:
        if time.perf_counter() - t0 >= seconds:
            break
        sent = time.perf_counter()
        staged.append((b, sent, s.pipe.dispatch_texts(
            [r["text"] for r in b], voices[:len(b)], output_format=fmt)))
        if len(staged) > ahead:
            launch()
    while staged:
        launch()
    while launched:
        collect()
    s.t_end = time.perf_counter()
    s.window_s = s.t_end - t0
    if len(out) == len(s.requests):
        raise RuntimeError("the offline mix ran out of batches inside the "
                           "window: raise its 'batches'")
    return out


KINDS: Dict[str, Dict[str, Callable]] = {
    "scheduler": {"setup": setup_scheduler, "window": window_scheduler,
                  "close": close_scheduler},
    "stream": {"setup": setup_stream, "window": window_stream},
    "offline": {"setup": setup_offline, "window": window_offline},
}
