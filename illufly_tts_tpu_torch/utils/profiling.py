# -*- coding: utf-8 -*-
"""Observability: ``TIMERS``, the port's one recorder of spans, and
``device_trace``, a ``torch.profiler`` trace of the card (the JAX
package's ``tpu_trace`` traces its TPU with ``jax.profiler``).

``TIMERS`` (a ``StageTimers``, copied from the JAX package's
``utils/profiling.py`` and extended) keeps, always, the seconds and the
count of every span name and an exponential moving average of its seconds:
``snapshot()`` is what the scheduler's ``stats()`` hands ``/tts/stats`` and
``/metrics``. While a ``torch.profiler`` runs (``recording()``) it also
keeps the spans themselves, each ``Span(name, t0_ns, t1_ns, batch,
parent)`` on ``time.time_ns()``, the clock the profiler stamps its events
with, in a bounded ring, and opens ``torch.profiler.record_function`` over
each, so that a CPU trace shows them beside the kernels. The engine adds
device spans: a CUDA event pair around each replayed stage, resolved into
``DeviceSpan(name, start_ms, ms, batch, device)`` once the device has
passed both events. Off, a span costs one flag read beyond its totals.

Span names (PERF.md §3 names the reader of each):
- pipeline: ``frontend``;
- engine, one set per batch: ``dispatch`` (stage A's host work and
  launch), ``launch`` (the frame-total wait and stage B's launch),
  ``collect`` (the audio wait, the trim and the expand), and ``model``,
  their parent, from the dispatch's start to the collect's end, whose
  total adds its three children's seconds; ``stream_prepare`` and
  ``stream_window`` for a windowed stream's stages;
- device: ``stage_a`` and ``stage_b``, each replayed stage's CUDA events;
- scheduler, one each per task: ``queue_wait`` (created to selected),
  ``coalesce_wait`` (the part of it in the coalescing window),
  ``head_wait`` (its batch's wait for the head of the decode queue) and
  ``poll_wait`` (completed to ``stream_result``'s poller seeing it).

Counters kept elsewhere join the snapshot through ``add_reader``, read
only when a snapshot is taken: ``bf16_conv_columns``, the bf16 fused
convs' column tiles computed against their grids' tiles, and the share
of the columns computed (``ops/adain_snake_conv.py::columns_tally``, a
device counter on each card, summed over the cards they ran on)."""
from __future__ import annotations

import contextlib
import itertools
import logging
import os
import threading
import time
from collections import defaultdict, deque
from typing import Callable, Dict, Iterator, List, NamedTuple, Optional

import torch
from torch.autograd import profiler as _autograd_profiler

logger = logging.getLogger(__name__)


class Span(NamedTuple):
    """A host span: ``t0_ns``/``t1_ns`` on ``time.time_ns()``; ``batch``
    the engine's batch id or the scheduler's task id; ``parent`` the
    enclosing span's name."""
    name: str
    t0_ns: int
    t1_ns: int
    batch: Optional[object]
    parent: Optional[str]


class DeviceSpan(NamedTuple):
    """A stage on the device: ``start_ms`` after the first device span of
    its device since the recorder was cleared, ``ms`` long."""
    name: str
    start_ms: float
    ms: float
    batch: Optional[object]
    device: str


class _Track:
    """One open span (``StageTimers.track``): after the block, its
    ``seconds``, and its start on the profiler's clock (``t0_ns``, None
    while not recording)."""

    __slots__ = ("timers", "stage", "batch", "parent", "start", "seconds",
                 "t0_ns", "record")

    def __init__(self, timers, stage, batch, parent):
        self.timers, self.stage = timers, stage
        self.batch, self.parent = batch, parent
        self.seconds = 0.0
        self.t0_ns = self.record = None

    def __enter__(self) -> "_Track":
        if _autograd_profiler._is_profiler_enabled:
            self.timers._open(self)
        self.start = time.perf_counter()
        return self

    def __exit__(self, *exc) -> None:
        self.seconds = time.perf_counter() - self.start
        if self.record is not None:
            self.timers._close(self)
        self.timers._add(self.stage, self.seconds)


class StageTimers:
    """Seconds, counts and an exponential moving average per span name,
    always; the spans themselves while a ``torch.profiler`` runs."""

    def __init__(self, alpha: float = 0.2, capacity: int = 1 << 16):
        self.alpha = alpha
        self.ewma: Dict[str, float] = {}
        self.count: Dict[str, int] = defaultdict(int)
        self.total: Dict[str, float] = defaultdict(float)
        self._spans: deque = deque(maxlen=capacity)
        self._marks: deque = deque(maxlen=capacity)  # unresolved pairs
        self._device: deque = deque(maxlen=capacity)
        self._origin: Dict[str, object] = {}  # device -> its first event
        self.dropped = 0  # spans and device spans a full ring pushed out
        self._lock = threading.Lock()
        self._local = threading.local()  # the thread's open spans
        self._ids = itertools.count(1)
        # name -> a reader of a counter kept elsewhere (a dict, or None
        # while it has nothing to report), called by ``snapshot``
        self._readers: Dict[str, Callable[[], Optional[dict]]] = {}

    def add_reader(self, name: str,
                   read: Callable[[], Optional[dict]]) -> None:
        """Report ``read()`` under ``name`` in every ``snapshot`` (left out
        while it returns None)."""
        self._readers[name] = read

    @staticmethod
    def recording() -> bool:
        """True while a ``torch.profiler`` (or the autograd profiler)
        runs."""
        return _autograd_profiler._is_profiler_enabled

    def batch_id(self) -> int:
        """A new batch's id, which its spans share."""
        return next(self._ids)

    def current_batch(self):
        """The batch of the innermost span open on this thread (None when
        none, or while not recording)."""
        stack = getattr(self._local, "stack", None)
        return stack[-1][1] if stack else None

    def _push(self, ring: deque, item) -> None:
        with self._lock:
            if len(ring) == ring.maxlen:
                self.dropped += 1
            ring.append(item)

    def _add(self, stage: str, elapsed: float) -> None:
        with self._lock:
            prev = self.ewma.get(stage)
            self.ewma[stage] = (
                elapsed if prev is None
                else self.alpha * elapsed + (1 - self.alpha) * prev
            )
            self.count[stage] += 1
            self.total[stage] += elapsed

    def track(self, stage: str, batch=None,
              parent: Optional[str] = None) -> _Track:
        """Time a ``with`` block as one ``stage`` span. While recording,
        the span is kept with ``batch`` (else the enclosing span's on this
        thread) and ``parent`` (else the enclosing span's name), and a
        ``record_function(stage)`` is open over the block."""
        return _Track(self, stage, batch, parent)

    def _open(self, span: _Track) -> None:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        if stack:
            if span.batch is None:
                span.batch = stack[-1][1]
            if span.parent is None:
                span.parent = stack[-1][0]
        stack.append((span.stage, span.batch))
        span.t0_ns = time.time_ns()
        span.record = torch.profiler.record_function(span.stage)
        span.record.__enter__()

    def _close(self, span: _Track) -> None:
        span.record.__exit__(None, None, None)
        t1_ns = time.time_ns()
        self._local.stack.pop()
        self._push(self._spans, Span(span.stage, span.t0_ns, t1_ns,
                                     span.batch, span.parent))

    def add(self, stage: str, seconds: float, t0_ns: Optional[int] = None,
            t1_ns: Optional[int] = None, batch=None,
            parent: Optional[str] = None) -> None:
        """Count a span timed elsewhere; kept as a span too while
        recording, when its start is known (its end defaults to now)."""
        self._add(stage, seconds)
        if t0_ns is not None and _autograd_profiler._is_profiler_enabled:
            self._push(self._spans, Span(
                stage, t0_ns, time.time_ns() if t1_ns is None else t1_ns,
                batch, parent))

    def device_start(self, stage: str, device: torch.device):
        """While recording, on CUDA and not capturing: record a timing
        event on ``device``'s current stream and return the open device
        span for ``device_end``; else None. Record the pair where no other
        thread's work on the stream can fall between them."""
        if (not _autograd_profiler._is_profiler_enabled
                or device.type != "cuda"
                or torch.cuda.is_current_stream_capturing()):
            return None
        stream = torch.cuda.current_stream(device)
        start = torch.cuda.Event(enable_timing=True)
        start.record(stream)
        return stage, self.current_batch(), str(device), stream, start

    def device_end(self, opened) -> None:
        """Close a span ``device_start`` opened: its end event on the same
        stream. Nothing waits: the pair is resolved once the device has
        passed it (``device_spans``)."""
        stage, batch, device, stream, start = opened
        end = torch.cuda.Event(enable_timing=True)
        end.record(stream)
        self.add_device(stage, start, end, batch, device)

    def add_device(self, stage: str, start, end, batch,
                   device: str) -> None:
        """Keep a recorded pair of events (``query()``,
        ``elapsed_time(other)`` in ms) as a device span to resolve."""
        self._push(self._marks, (stage, batch, device, start, end))

    def device_spans(self) -> List[DeviceSpan]:
        """The device spans whose events the device has passed, oldest
        first; pairs it has not reached stay for a later call. Never
        waits for the device."""
        with self._lock:
            while self._marks and self._marks[0][4].query():
                stage, batch, device, start, end = self._marks.popleft()
                origin = self._origin.setdefault(device, start)
                if len(self._device) == self._device.maxlen:
                    self.dropped += 1
                self._device.append(DeviceSpan(
                    stage, origin.elapsed_time(start),
                    start.elapsed_time(end), batch, device))
            return list(self._device)

    def spans(self) -> List[Span]:
        """The host spans kept, oldest first."""
        with self._lock:
            return list(self._spans)

    def clear(self) -> None:
        """Drop the kept spans, pairs and device origins (not the
        totals)."""
        with self._lock:
            self._spans.clear()
            self._marks.clear()
            self._device.clear()
            self._origin.clear()
            self.dropped = 0

    def snapshot(self) -> Dict[str, Dict[str, float]]:
        """Each span name's ``ewma_s``, ``count`` and ``total_s``; then each
        reader's counters under its name."""
        with self._lock:
            out = {
                stage: {
                    "ewma_s": self.ewma[stage],
                    "count": self.count[stage],
                    "total_s": self.total[stage],
                }
                for stage in self.ewma
            }
        for name, read in list(self._readers.items()):
            value = read()
            if value is not None:
                out[name] = value
        return out


TIMERS = StageTimers()


@contextlib.contextmanager
def device_trace(log_dir: str, device="cuda") -> Iterator[object]:
    """Trace the block with ``torch.profiler`` and write a Chrome trace
    (``chrome://tracing``, Perfetto) into ``log_dir``: CPU and CUDA
    activity for a CUDA ``device``, CPU activity alone for ``"cpu"``.
    Yields the profiler (``key_averages()`` after the block). The port's
    counterpart of the JAX package's ``tpu_trace``. ``TIMERS`` records
    its spans while it runs, so the trace shows them beside the kernels.
    Raises for a CUDA device on a host without one."""
    from torch.profiler import ProfilerActivity, profile

    dev = torch.device(device)
    activities = [ProfilerActivity.CPU]
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("device_trace: no CUDA device; pass "
                               "device='cpu' to trace the CPU")
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    path = os.path.join(log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json")
    prof.export_chrome_trace(path)
    logger.info("profiler trace written to %s", path)
