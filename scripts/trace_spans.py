"""What the port's span recorder (``utils/profiling.py::TIMERS``) costs and
shows on the card, through the benchmark's own deployments
(``perfbench/harness``):

- ``cost``: ns per span with recording off, on under the benchmark's
  CUDA-only tracer and on under a CPU + CUDA profiler, and ns per stage
  device span (its CUDA event pair) and per resolution;
- ``offline``: the ``bf16-offline-b32`` cell's window under the benchmark's
  ``Tracer`` ``--repeats`` times with recording on and as often with it
  forced off, in turns (on, off, off, on, ...): Generator passes per traced
  second and the device's idle share of each; and from the recorded
  windows the three ``program_span`` metrics, the sum of the stage
  intervals against the trace's busy seconds less its copies and against
  the window, and the shared clock: each ``dispatch`` and ``launch`` span
  against the ``cudaGraphLaunch`` runtime events it made;
- ``serve``: a held-back scheduler cell (``f32-serve-repeat``) traced
  whole, each task's latency taken apart into the scheduler's waits
  (``queue_wait`` with ``coalesce_wait`` in it, ``head_wait``,
  ``poll_wait``) and the rest, for the tasks above the 90th percentile
  and for all.

    python3 scripts/trace_spans.py --parts cost,offline,serve --seed 2147483711

Needs a CUDA card; prints one JSON object and writes it to ``--out``."""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def log(*parts):
    print("[trace_spans]", *parts, file=sys.stderr, flush=True)


def card():
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20).stdout.strip()
    except (OSError, subprocess.SubprocessError) as exc:
        return repr(exc)


def quartiles(xs):
    if len(xs) < 2:
        return xs
    return [round(q, 3) for q in statistics.quantiles(xs, n=4)]


def per_ns(fn, n):
    t0 = time.perf_counter_ns()
    for _ in range(n):
        fn()
    return (time.perf_counter_ns() - t0) / n


# ---- cost --------------------------------------------------------------------


def spans(t):
    def one():
        with t.track("x"):
            pass
    return one


def cost(parent=None, n=100_000):
    """``parent``: another checkout, whose ``StageTimers`` is timed off
    beside this one's."""
    import importlib.util

    import torch
    from torch.profiler import ProfilerActivity, profile

    from illufly_tts_tpu_torch.utils.profiling import StageTimers

    dev = torch.device("cuda")
    out = {}
    if parent:
        spec = importlib.util.spec_from_file_location(
            "parent_profiling", os.path.join(
                parent, "illufly_tts_tpu_torch", "utils", "profiling.py"))
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        out["parent_span_off_ns"] = min(
            per_ns(spans(module.StageTimers()), n) for _ in range(3))

    t = StageTimers()
    out["span_off_ns"] = min(per_ns(spans(t), n) for _ in range(3))
    for label, acts in (("cuda_only", [ProfilerActivity.CUDA]),
                        ("cpu_cuda", [ProfilerActivity.CPU,
                                      ProfilerActivity.CUDA])):
        t = StageTimers(capacity=4 * n)
        with profile(activities=acts):
            assert t.recording()
            out[f"span_on_{label}_ns"] = per_ns(spans(t), n)

            def pair():
                t.device_end(t.device_start("stage_b", dev))
            m = n // 10
            out[f"pair_on_{label}_ns"] = per_ns(pair, m)
            torch.cuda.synchronize()
            t0 = time.perf_counter_ns()
            got = len(t.device_spans())
            out[f"resolve_{label}_ns"] = (time.perf_counter_ns() - t0) / got
        out[f"dropped_{label}"] = t.dropped
    return out


# ---- the benchmark's deployments ------------------------------------------------


def session(cell_name, seed, seconds):
    import torch

    from perfbench.harness import (configs, deploy, drive, frontend,
                                   registry, traffic, weights)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cell = registry.load_json("workloads", cell_name)
    cfg = configs.load(cell["config"])
    mix = registry.load_json("traffic", cell["traffic"])
    tables = frontend.load_tables()
    dev = torch.device("cuda")
    params = weights.make(cfg, seed, dev)
    packs = weights.voices(cfg, seed, mix["voices"], dev)
    synth = deploy.synthesizer(cfg, params, dev,
                               **cell["deployment"].get("buckets", {}))
    del params
    names = deploy.register_voices(synth, packs)
    requests, prefill = traffic.generate(mix, seed, seconds, tables, None)
    s = drive.Session(cell=cell, mix=mix, synth=synth,
                      pipe=deploy.pipeline(synth, tables), recorder=None,
                      requests=requests, prefill=prefill, voice_names=names,
                      errors=[], manager=None)
    kind = drive.KINDS[cell["deployment"]["kind"]]
    kind["setup"](s)
    torch.cuda.synchronize()
    return s, kind


def offline(seed, repeats, seconds):
    import torch

    from perfbench.harness import trace
    from perfbench.spans import device_ms
    from illufly_tts_tpu_torch.utils import profiling

    s, kind = session("bf16-offline-b32", seed, seconds + 30)
    flag = profiling._autograd_profiler
    forced_off = type("Off", (), {"_is_profiler_enabled": False})
    windows = []
    # a first window warms the frontend's own memos; then on and off in
    # turns
    s.pipe.clear_caches()
    kind["window"](s, seconds, trace.Tracer(False))
    order = [True, False, False, True] * ((repeats + 1) // 2)
    for on in order[: 2 * repeats]:
        s.pipe.clear_caches()  # every window renders its batches
        profiling.TIMERS.clear()
        if not on:
            profiling._autograd_profiler = forced_off
        tracer = trace.Tracer(True)
        try:
            kind["window"](s, seconds, tracer)
            torch.cuda.synchronize()
            tracer.stop()
        finally:
            profiling._autograd_profiler = flag
        summary = tracer.summary()
        row = {"recording": on, "window_s": summary["window_s"],
               "busy_s": summary["busy_s"],
               "idle_share": 100 * (1 - summary["busy_s"]
                                    / summary["window_s"]),
               "passes_per_s": summary["classes"]["istft"]["launches"]
               / summary["window_s"],
               "memcpy_s": summary["classes"].get("memcpy",
                                                  {}).get("seconds", 0.0)}
        if on:
            run = type("Run", (), {"trace": summary})
            ms = device_ms(run)
            inside = sum(map(sum, ms.values())) / 1e3
            row.update(
                stage_a_device_ms=statistics.median(ms["stage_a"]),
                stage_b_device_ms=statistics.median(ms["stage_b"]),
                stage_a_quartiles=quartiles(ms["stage_a"]),
                stage_b_quartiles=quartiles(ms["stage_b"]),
                stages=[len(ms["stage_a"]), len(ms["stage_b"])],
                stage_sum_s=inside,
                outside_stage_share=100 * (1 - inside / summary["window_s"]),
                busy_less_memcpy_s=summary["busy_s"] - row["memcpy_s"],
                dropped=profiling.TIMERS.dropped,
                clock=clock(tracer.prof, profiling.TIMERS.spans()))
        log(json.dumps(row))
        windows.append(row)
        del tracer
    return windows


def clock(prof, spans, slack_ns=100_000):
    """Each ``dispatch`` / ``launch`` span against the ``cudaGraphLaunch``
    runtime events inside it (``slack_ns`` either side), and every
    ``cudaGraphLaunch`` against the spans."""
    from torch.autograd import DeviceType

    launches, names = [], set()
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CPU:
            names.add(e.name())
            if e.name() == "cudaGraphLaunch":
                launches.append((e.start_ns(), e.start_ns()
                                 + e.duration_ns()))
    launches.sort()
    out = {"graph_launches": len(launches),
           "span_events_in_trace": sorted(n for n in names if n in (
               "dispatch", "launch", "collect", "model", "frontend"))}
    covered = set()
    for name in ("dispatch", "launch"):
        mine = [sp for sp in spans if sp.name == name]
        inside = []
        for sp in mine:
            got = [i for i, (a, b) in enumerate(launches)
                   if sp.t0_ns - slack_ns <= a and b <= sp.t1_ns + slack_ns]
            covered.update(got)
            inside.append(len(got))
            if got:  # how close the span's edges come to its launch
                a, b = launches[got[0]]
                out.setdefault(f"{name}_margin_us", []).append(
                    min(a - sp.t0_ns, sp.t1_ns - b) / 1e3)
        out[f"{name}_spans"] = len(mine)
        out[f"{name}_with_one_launch"] = sum(1 for k in inside if k == 1)
        out[f"{name}_with_none"] = sum(1 for k in inside if k == 0)
        margins = out.pop(f"{name}_margin_us", [])
        out[f"{name}_least_margin_us"] = min(margins) if margins else None
    out["launches_in_no_span"] = len(launches) - len(covered)
    return out


# ---- serve -----------------------------------------------------------------------


def serve(seed, seconds, cell="f32-serve-repeat"):
    import numpy as np
    import torch

    from perfbench.harness import trace
    from illufly_tts_tpu_torch.utils.profiling import TIMERS

    s, kind = session(cell, seed, seconds)
    TIMERS.clear()
    began = time.time()  # the prompts served in set-up came before
    tracer = trace.Tracer(True)
    recs = kind["window"](s, seconds, tracer)
    torch.cuda.synchronize()
    tracer.stop()
    summary = tracer.summary()
    spans = {}
    for sp in TIMERS.spans():
        if sp.name in ("queue_wait", "coalesce_wait", "head_wait",
                       "poll_wait"):
            spans[(sp.name, sp.batch)] = (sp.t1_ns - sp.t0_ns) / 1e6
    tasks = []
    for task in s.manager.tasks.values():
        if (task.created_at < began or task.dispatched_at is None
                or task.completed_at is None):
            continue
        poll = spans.get(("poll_wait", task.task_id), 0.0)
        total = (task.completed_at - task.created_at) * 1e3 + poll
        parts = {k: spans.get((k, task.task_id), 0.0)
                 for k in ("queue_wait", "coalesce_wait", "head_wait")}
        parts["poll_wait"] = poll
        parts["service"] = ((task.completed_at - task.dispatched_at) * 1e3
                            - parts["head_wait"])
        tasks.append((total, parts))
    kind["close"](s)
    lat = [r["latency"] * 1e3 for r in recs if r.get("audio") is not None]
    totals = sorted(t for t, _ in tasks)
    cut = np.percentile(totals, 90)

    def mean_parts(rows):
        keys = rows[0][1].keys()
        return {k: round(float(np.mean([p[k] for _, p in rows])), 2)
                for k in keys}

    tail = [row for row in tasks if row[0] >= cut]
    return {"cell": cell, "seed": seed, "requests": len(recs),
            "request_p50_ms": float(np.percentile(lat, 50)),
            "request_p95_ms": float(np.percentile(lat, 95)),
            "task_p95_ms": float(np.percentile(totals, 95)),
            "tasks": len(tasks), "tail_tasks": len(tail),
            "all_mean_ms": mean_parts(tasks),
            "tail_mean_ms": mean_parts(tail),
            "idle_share": 100 * (1 - summary["busy_s"]
                                 / summary["window_s"]),
            "stage_timers": {k: v for k, v in TIMERS.snapshot().items()
                             if k.endswith("_wait")}}


def main(argv):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--parts", default="cost,offline,serve")
    p.add_argument("--seed", type=int, default=2147483711)
    p.add_argument("--repeats", type=int, default=2)
    p.add_argument("--seconds", type=float, default=14.0)
    p.add_argument("--serve-seconds", type=float, default=30.0)
    p.add_argument("--serve-seeds", type=int, default=1)
    p.add_argument("--parent", default=None,
                   help="a checkout whose StageTimers is timed beside")
    p.add_argument("--out", default=os.path.join(ROOT, "chiprun_out",
                                                 "trace_spans.json"))
    args = p.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        log("needs a CUDA card")
        return 2
    from torch.autograd import profiler as autograd_profiler

    parts = args.parts.split(",")
    result = {"card": card(), "torch": torch.__version__,
              "cuda": torch.version.cuda,
              "flag": hasattr(autograd_profiler, "_is_profiler_enabled")}
    log(json.dumps(result))
    if "cost" in parts:
        result["cost"] = cost(args.parent)
        log(json.dumps(result["cost"]))
    if "offline" in parts:
        result["offline"] = offline(args.seed, args.repeats, args.seconds)
    if "serve" in parts:
        result["serve"] = [serve(args.seed + k, args.serve_seconds)
                           for k in range(args.serve_seeds)]
        for row in result["serve"]:
            log(json.dumps(row))
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(result, f, indent=1)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
