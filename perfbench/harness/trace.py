"""The ``--trace 1`` run's device trace: ``torch.profiler`` over the first
``TRACE_SECONDS`` of the window (the whole window where other threads
launch the work), CUDA activity only (the device's operations and the CUDA runtime calls
that the host made), read in memory and never written to disk.

- ``busy_s``: the union of the device's operation intervals (kernels,
  copies, fills): overlapping kernels count once;
- ``classes``: device seconds and launches by kernel class (the family's
  ``TRACE_CLASSES``, then ``CLASSES``; first match wins), for the kernels'
  rooflines;
- ``breakdown``: the ten device operations that took most time, and the
  idle time between device operations by the CUDA runtime call the host
  was in at the gap's middle ("host" where it was in none: Python, the
  pipeline, the scheduler's waits)."""
from __future__ import annotations

import heapq
import re
import time
from collections import defaultdict
from typing import Dict, List, Tuple

# the library's kernels, after the family's own (``TRACE_CLASSES``)
CLASSES = (
    ("lstm", r"(?i)rnn|lstm"),
    ("conv_gemm", r"(?i)conv|gemm|xmma|cutlass|implicit|sm90|wgrad|dgrad"),
    ("memcpy", r"(?i)memcpy|memset"),
    ("elementwise", r"(?i)elementwise|reduce|vectorized|unrolled|index"
                    r"|gather|scan|cat|copy|fill|softmax|norm"),
)


def compile_classes(family_classes=()) -> List[tuple]:
    """(name, compiled pattern) of ``family_classes``, then ``CLASSES``."""
    return [(name, re.compile(pat))
            for name, pat in tuple(family_classes) + CLASSES]


def kernel_class(name: str, compiled: List[tuple]) -> str:
    for cls, pat in compiled:
        if pat.search(name):
            return cls
    return "other"


# seconds of the window a single-threaded window traces, from its start: a
# 45 s trace of the stream cell held millions of events and took minutes
# to read. A window whose work runs on other threads is traced whole and
# stopped after it (``drive.window_scheduler``).
TRACE_SECONDS = 10.0


class Tracer:
    """``torch.profiler`` (CUDA activity) from ``start`` until the first
    ``due`` call ``TRACE_SECONDS`` after it (or ``stop``); the device is
    synchronized before the profiler stops. ``seconds`` is the traced
    window's length; ``resumed`` the host clock once the profiler has
    stopped, from which the window runs untraced (``None`` until then).
    ``classes``: the family's kernel classes (``TRACE_CLASSES``)."""

    def __init__(self, enabled: bool, classes=()):
        self.classes = compile_classes(classes)
        self.prof = None
        self.seconds = None
        self.t0 = None
        self.resumed = None
        if enabled:
            from torch.profiler import ProfilerActivity, profile

            self.prof = profile(activities=[ProfilerActivity.CUDA])

    def start(self) -> None:
        if self.prof is not None:
            self.prof.start()
            self.t0 = time.perf_counter()

    def due(self) -> None:
        if self.t0 is not None and self.seconds is None and \
                time.perf_counter() - self.t0 >= TRACE_SECONDS:
            self.stop()

    def stop(self) -> None:
        if self.t0 is None or self.seconds is not None:
            return
        import torch

        torch.cuda.synchronize()
        self.seconds = time.perf_counter() - self.t0
        self.prof.stop()
        self.resumed = time.perf_counter()

    def summary(self):
        return None if self.prof is None else summarize(
            self.prof, self.seconds, self.classes)


def _events(prof) -> Tuple[List[tuple], List[tuple]]:
    """-> (device events, host events) as (start_ns, end_ns, name)."""
    from torch.autograd import DeviceType

    dev, host = [], []
    for e in prof.profiler.kineto_results.events():
        start = e.start_ns()
        end = start + e.duration_ns()
        if e.device_type() == DeviceType.CUDA:
            dev.append((start, end, e.name()))
        elif e.device_type() == DeviceType.CPU and e.duration_ns() > 0:
            host.append((start, end, e.name()))
    return dev, host


def summarize(prof, window_s: float, classes: List[tuple]) -> Dict:
    """``prof``'s device work over a window of ``window_s`` host seconds
    (the profiler ran around the window alone), by ``classes``
    (``compile_classes``)."""
    dev, host = _events(prof)
    dev.sort()
    busy, gaps, cur_s, cur_e = 0, [], None, None
    for s, e, _ in dev:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
                gaps.append((cur_e, s))
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    by_name: Dict[str, float] = defaultdict(float)
    by_class: Dict[str, List[float]] = defaultdict(lambda: [0.0, 0])
    for s, e, n in dev:
        by_name[n] += (e - s) * 1e-9
        c = by_class[kernel_class(n, classes)]
        c[0] += (e - s) * 1e-9
        c[1] += 1
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    return {
        "busy_s": busy * 1e-9,
        "window_s": window_s,
        "classes": {k: {"seconds": v[0], "launches": v[1]}
                    for k, v in by_class.items()},
        "breakdown": {"device_ops": [[n[:160], s] for n, s in top],
                      "idle_gaps": _idle_by_host(gaps, host)},
    }


def _idle_by_host(gaps, host) -> List[list]:
    """Idle seconds by the innermost host call (the latest-starting one
    still running) at each gap's middle ("host" where none runs), the ten
    largest. One sweep over the gaps by their middles."""
    host = sorted(host)
    totals: Dict[str, float] = defaultdict(float)
    active: list = []  # (-start, end, name): the latest start on top
    i = 0
    for mid, s, e in sorted(((s + e) // 2, s, e) for s, e in gaps):
        while i < len(host) and host[i][0] <= mid:
            heapq.heappush(active, (-host[i][0], host[i][1], host[i][2]))
            i += 1
        # an operation that ended before this middle ended before every
        # later one too
        while active and active[0][1] < mid:
            heapq.heappop(active)
        label = active[0][2] if active else "host"
        totals[label[:120]] += (e - s) * 1e-9
    return [[k, v] for k, v in sorted(totals.items(), key=lambda kv: -kv[1])
            [:10]]


def untraced(run):
    """The part of a traced window after the profiler stopped: (the
    records of the work dispatched from then on, its seconds to the
    window's end), or None where the profiler ran to the window's end.
    A rate read by the host's clock is read there, clear of the profiler's
    slowdown and of its stop."""
    t = getattr(run, "trace_resumed", None)
    if t is None or t >= run.t_end:
        return None
    recs = [r for r in run.records
            if r.get("sent") is not None and r["sent"] >= t]
    return (recs, run.t_end - t) if recs else None
