# -*- coding: utf-8 -*-
"""Prometheus text-exposition rendering of the serving stats.

The reference surfaces its counters only in logs (SURVEY §5: cache stats at
pipeline.py:694-704, ad-hoc wall timing at service.py:345-371). Here the
same numbers the JSON `/tts/stats` endpoint reports are also rendered in
the Prometheus exposition format (version 0.0.4) at `GET /metrics`, so a
production deployment scrapes the instance directly — no sidecar exporter.

Stateless: takes the `TTSServiceManager.stats()` dict and renders it.
Counter semantics follow Prometheus conventions (`_total` suffix,
monotonically increasing since process start); the rest are gauges.
"""
from __future__ import annotations

import math
from typing import Any, Dict, List

# scheduler counter key -> (metric name, help text)
_COUNTERS = {
    "submitted": ("tts_tasks_submitted_total", "Tasks accepted by submit_task"),
    "completed": ("tts_tasks_completed_total", "Tasks finished with audio"),
    "failed": ("tts_tasks_failed_total", "Tasks that ended FAILED"),
    "canceled": ("tts_tasks_canceled_total", "Tasks canceled while pending"),
    "batches": ("tts_batches_total", "Device batches executed"),
    "audio_seconds": ("tts_audio_seconds_total", "Audio seconds synthesized"),
    "batch_seconds": ("tts_batch_seconds_total",
                      "Wall seconds spent in device batches"),
}

_GAUGES = {
    "pending": ("tts_pending_tasks", "Tasks waiting for a batch slot"),
    "throughput_x_realtime": (
        "tts_throughput_x_realtime",
        "audio_seconds_total / batch_seconds_total since start",
    ),
}


def _num(v: Any) -> str:
    """Prometheus sample value: integers bare, floats repr'd, non-finite
    as +Inf/-Inf/NaN."""
    if isinstance(v, bool):
        return "1" if v else "0"
    f = float(v)
    if math.isnan(f):
        return "NaN"
    if math.isinf(f):
        return "+Inf" if f > 0 else "-Inf"
    if f == int(f) and abs(f) < 2**53:
        return str(int(f))
    return repr(f)


def _esc(label: str) -> str:
    return label.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def render_prometheus(stats: Dict[str, Any]) -> str:
    """Render a `TTSServiceManager.stats()` dict to exposition text."""
    lines: List[str] = []

    def emit(name: str, help_: str, typ: str, samples) -> None:
        lines.append(f"# HELP {name} {help_}")
        lines.append(f"# TYPE {name} {typ}")
        for labels, value in samples:
            if labels:
                body = ",".join(f'{k}="{_esc(str(v))}"'
                                for k, v in sorted(labels.items()))
                lines.append(f"{name}{{{body}}} {_num(value)}")
            else:
                lines.append(f"{name} {_num(value)}")

    for key, (name, help_) in _COUNTERS.items():
        if key in stats:
            emit(name, help_, "counter", [({}, stats[key])])
    for key, (name, help_) in _GAUGES.items():
        if key in stats:
            emit(name, help_, "gauge", [({}, stats[key])])

    cache = stats.get("cache")
    if isinstance(cache, dict):
        kinds = sorted({k.rsplit("_", 1)[0] for k in cache
                        if k.endswith(("_hits", "_misses"))})
        if kinds:
            emit("tts_cache_hits_total", "Pipeline cache hits", "counter",
                 [({"kind": k}, cache.get(f"{k}_hits", 0)) for k in kinds])
            emit("tts_cache_misses_total", "Pipeline cache misses", "counter",
                 [({"kind": k}, cache.get(f"{k}_misses", 0)) for k in kinds])
            rated = [k for k in kinds if f"{k}_hit_rate" in cache]
            if rated:
                emit("tts_cache_hit_rate",
                     "hits / (hits + misses) since start", "gauge",
                     [({"kind": k}, cache[f"{k}_hit_rate"]) for k in rated])

    timers = stats.get("stage_timers")
    timers = timers if isinstance(timers, dict) else {}
    columns = timers.get("bf16_conv_columns")
    if isinstance(columns, dict):
        emit("tts_bf16_conv_tiles_computed_total",
             "Column tiles the bf16 fused convs computed, all cards",
             "counter",
             [({}, columns["computed_tiles"])])
        emit("tts_bf16_conv_tiles_grid_total",
             "Column tiles of the bf16 fused convs' whole grids, all cards",
             "counter",
             [({}, columns["grid_tiles"])])
        if columns.get("computed_share") is not None:
            emit("tts_bf16_conv_computed_share",
                 "Share of the bf16 fused convs' columns computed", "gauge",
                 [({}, columns["computed_share"])])
    stages = sorted(s for s, v in timers.items()
                    if isinstance(v, dict) and "count" in v)
    if stages:
        emit("tts_stage_seconds_total",
             "Wall seconds per pipeline stage", "counter",
             [({"stage": s}, timers[s].get("total_s", 0.0)) for s in stages])
        emit("tts_stage_invocations_total",
             "Invocations per pipeline stage", "counter",
             [({"stage": s}, timers[s].get("count", 0)) for s in stages])
        emit("tts_stage_ewma_seconds",
             "Exponentially weighted moving average stage latency", "gauge",
             [({"stage": s}, timers[s].get("ewma_s", 0.0)) for s in stages])

    return "\n".join(lines) + "\n"
