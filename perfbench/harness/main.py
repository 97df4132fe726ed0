"""One run of one cell: set up, measure for ``--seconds``, check, print.

The last line of standard output is the result, one JSON object; the last
lines of standard error are the numbers that decided ``correct``, each
beside its limit."""
from __future__ import annotations

import argparse
import gc
import json
import os
import subprocess
import sys
import time
from types import SimpleNamespace

import numpy as np

from . import check, configs, deploy, drive, frontend, registry, trace, traffic

FORBIDDEN = {"jax", "jaxlib", "flax", "illufly_tts_tpu"}


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--rate", type=float, default=None,
                   help="requests/s in place of the mix's (the knee sweep)")
    return p.parse_args(argv)


def log(*parts) -> None:
    print("[perfbench]", *parts, file=sys.stderr, flush=True)


def counters(s, family) -> dict:
    from illufly_tts_tpu_torch.engine.synthesizer import stage_kind
    from illufly_tts_tpu_torch.utils.profiling import TIMERS

    out = {"frontend_s": TIMERS.total.get("frontend", 0.0),
           "replays_b": sum(v for k, v in s.synth.graph_replays.items()
                            if stage_kind(k) == "b"),
           "generator_passes": family.generator_passes()}
    if getattr(s, "manager", None) is not None:
        out["manager"] = dict(s.manager.counters)
    return out


def diagnostics(recs, window_s: float) -> str:
    """One line on how the window went: requests done, failed, and (open
    loop) the median latency in each third of the window and the
    generator's worst lateness, which show a backlog that grows."""
    done = [r for r in recs if r.get("audio") is not None]
    line = (f"window {window_s:.3f} s: {len(recs)} requests, {len(done)} "
            f"done, {len(recs) - len(done)} failed")
    lat = [r for r in done if r.get("latency") is not None]
    if lat:
        thirds = [[r["latency"] for r in lat
                   if k * window_s / 3 <= r["due"] < (k + 1) * window_s / 3]
                  for k in range(3)]
        line += "; latency p50 / p95 by third " + " ".join(
            f"{np.median(t) * 1e3:.1f}/{np.percentile(t, 95) * 1e3:.1f}"
            if t else "-" for t in thirds)
        line += f" ms; worst lateness {max(r['late'] for r in lat) * 1e3:.1f} ms"
    return line


def card_line() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20).stdout.strip()
    except (OSError, subprocess.SubprocessError) as exc:
        return f"nvidia-smi: {exc!r}"


def run(args, t_start: float, device: str = "cuda", overrides=None) -> int:
    """``device`` and ``overrides`` (a configuration dict of sizes in place
    of the cell's, traffic and deployment keys in place of the mix's and
    the cell's) serve the CPU tests. The model family is the cell's
    configuration's."""
    import torch

    overrides = overrides or {}
    cell = registry.load_json("workloads", args.workload)
    cell["deployment"] = {**cell["deployment"],
                          **overrides.get("deployment", {})}
    bench = registry.benchmark()
    wanted = registry.metrics_of(args.workload, bench)
    if device == "cuda":
        if not torch.cuda.is_available() or \
                torch.cuda.device_count() < cell["chips"]:
            log(f"needs {cell['chips']} CUDA device(s); found "
                f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
            return 2
        log("card:", card_line())
        torch.zeros(1, device="cuda")
        log(f"CUDA ready at {time.perf_counter() - t_start:.3f} s")
    # float32 means float32: cuDNN's TF32 is on by default
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    family = configs.family(cell["config"])
    cfg = overrides.get("config") or configs.load(cell["config"])
    mix = {**registry.load_json("traffic", cell["traffic"]),
           **overrides.get("traffic", {})}
    tables = frontend.load_tables()
    dev = torch.device(device)

    params = family.make(cfg, args.seed, dev)
    packs = family.voices(cfg, args.seed, mix["voices"], dev)
    log(f"weights at {time.perf_counter() - t_start:.3f} s")
    synth = family.engine(cfg, params, dev,
                          **cell["deployment"].get("buckets", {}))
    del params
    names = deploy.register_voices(synth, packs)
    log(f"engine at {time.perf_counter() - t_start:.3f} s")
    requests, prefill = traffic.generate(mix, args.seed, args.seconds, tables,
                                         args.rate)
    log(f"traffic at {time.perf_counter() - t_start:.3f} s")
    s = drive.Session(cell=cell, mix=mix, synth=synth,
                      pipe=deploy.pipeline(synth, tables),
                      recorder=deploy.Recorder(synth, family.row_extras),
                      requests=requests, prefill=prefill, voice_names=names,
                      errors=[], manager=None)
    kind = drive.KINDS[cell["deployment"]["kind"]]
    kind["setup"](s)
    s.errors.clear()  # set-up's own (a warm stream the engine refuses)
    if device == "cuda":
        torch.cuda.synchronize()
    before = counters(s, family)
    setup_s = time.perf_counter() - t_start
    log(f"set-up {setup_s:.3f} s; {len(requests)} requests ready")

    tracer = trace.Tracer(bool(args.trace), family.TRACE_CLASSES)
    recs = kind["window"](s, args.seconds, tracer)
    if device == "cuda":
        torch.cuda.synchronize()
    tracer.stop()  # a window shorter than the trace
    after = counters(s, family)
    log(diagnostics(recs, s.window_s))
    peak = int(torch.cuda.max_memory_allocated(dev)) if device == "cuda" else 0
    t_read = time.perf_counter()
    summary = tracer.summary()
    resumed = tracer.resumed
    del tracer
    if summary is not None:
        log(f"trace of {summary['window_s']:.3f} s read in "
            f"{time.perf_counter() - t_read:.3f} s")
    if "close" in kind:
        kind["close"](s)
    rows = s.recorder.rows()
    s.recorder.release()
    errors = s.errors

    result_run = SimpleNamespace(
        cell=cell, name=args.workload, family=family, cfg=cfg, mix=mix,
        setup_s=setup_s, window_s=s.window_s, t_end=s.t_end,
        trace_resumed=resumed, records=recs, before=before, after=after,
        trace=summary, sample_rate=cfg["sample_rate"],
        samples_per_frame=family.samples_per_frame(cfg),
        deployment=cell["deployment"])
    metrics = {}
    group = "per_layer" if args.trace else "end_to_end"
    for m in wanted[group]:
        value = registry.reader(m["name"])(result_run)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}

    # the program's state goes before the reference runs
    del s, synth, kind
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()
    params = family.make(cfg, args.seed, dev)
    judge = family.Judge(cfg, params, packs)
    form = dict(cell["check"]["form"])
    sample = check.pick_sample(recs, cell["check"]["sample"], args.seed)
    worst = []
    t_check = time.perf_counter()
    numbers = check.judge(recs, rows, judge, form, sample, names,
                          worst=worst)
    log(f"check of {len(sample)} answers in "
        f"{time.perf_counter() - t_check:.3f} s; worst: " + "; ".join(
            f"#{i} {n} ids wave {w:.3g} mel {m:.3g}"
            for w, m, i, n in sorted(worst, reverse=True)[:3]))
    limits = cell["check"]["limits"]
    correct = check.verdict(numbers, limits)

    found = sorted({m.split(".")[0] for m in sys.modules} & FORBIDDEN)
    if found:
        log(f"modules that must not load were loaded: {found}")
        return 3
    failed = sum(1 for r in recs if r.get("audio") is None)
    if errors:
        log(f"{len(errors)} failed requests, first: {errors[0][:300]}")
    device_info = {"platform": "gpu" if device == "cuda" else device,
                   "kind": torch.cuda.get_device_name(0)
                   if device == "cuda" else device,
                   "count": cell["chips"], "memory_peak_bytes": peak}
    out = {"correct": bool(correct), "attempted": len(recs),
           "failed": failed, "metrics": metrics, "device": device_info}
    if summary is not None:
        device_info["busy_s"] = summary["busy_s"]
        device_info["window_s"] = summary["window_s"]
        out["breakdown"] = summary["breakdown"]
    out["checks"] = {k: {"value": numbers[k], "limit": limits[k]}
                     for k in limits}
    log("not compared: " + ", ".join(f"{k} {numbers[k]!r}" for k in numbers
                                     if k not in limits))
    for k in limits:
        log(f"check {k} {numbers[k]!r} limit {limits[k]!r}")
    log(f"run ends at {time.perf_counter() - t_start:.3f} s")
    print(json.dumps(out), flush=True)
    return 0


def main(argv, t_start: float) -> int:
    args = parse(argv)
    root = registry.ROOT
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton")):
        os.environ[var] = os.path.join(root, "build", sub)
    return run(args, t_start)
