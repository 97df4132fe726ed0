#!/usr/bin/env python
# -*- coding: utf-8 -*-
"""Where the PyTorch port's device time goes, on one CUDA card.

    python3 scripts/profile_torch_port.py [--out FILE]
    python3 scripts/profile_torch_port.py --streams-of DIR [--out FILE]

Builds the port's ``Synthesizer(KokoroConfig(), seed=0)`` on the card
(float32, TF32 off), warms each request once, then runs each request
under ``torch.profiler`` (``utils/profiling.py::device_trace``, whose
Chrome trace lands in the git-ignored ``build/``) and reports: wall time,
device busy time (sum of
kernel times; one stream), the device idle share ``1 - busy / wall``,
kernel time by class (each hand-written kernel its own class), and the top
kernels.

Each request is also timed without the profiler first (host clock to a
synchronize, median of 5: ``wall_ms_unprofiled_median``).

Requests: ``b1`` (one zh string, 807 frames, frame bucket 1024) and ``b8``
(eight strings of ~18 tokens, frame bucket 512), each ``dispatch ->
collect`` in pcm16; and ``b1_stream``, the ``b1`` string streamed windowed
(64-frame windows with 16-frame halos) by the eager loop the engine ran
before its stream stages became graphs (``chip_smoke.eager_windowed_stream``:
``decode_prepare``, then ``decode_window`` per window with a host-int start
and a blocking copy), which also reports the time to the first chunk and
the device span of ``decode_prepare`` and of each window's Generator
(``decode_window``), between CUDA events recorded around each call (idle
gaps included); ``b1_stream_graph``, the same stream through
``stream_decode(exact=False)``, whose prepare and window graphs its warm
run captured, so that every stage replays (and each window's copy to the
host starts one window ahead); and
``bench_bf16``, bench.py's serving shape (32 copies of a 250-character zh
text, token bucket 256, frame bucket 512) in pcm16 on a
``KokoroConfig(dtype=torch.bfloat16)`` engine with the same weights, so
the bf16 render's device time splits by class too (its conv kernels in
the ``*_bf16`` classes); then ``b1_graph`` and ``b8_graph``, the ``b1`` and
``b8`` requests again after ``Synthesizer.warmup`` captured their keys
(pcm16) as CUDA graphs, so that each stage replays (``graph_replays``
reports the replays the request made). Last, ``b1_stream`` and
``b1_stream_graph`` are profiled again in turns, ``STREAM_TURNS`` times
each (``stream_turns``: device busy ms and the fused convs' ms of each
run), since one profiled run of each is not enough to compare their
device time.
Every request also reports the kernel wrappers' own launch counts, and the
kernels that ran just before each iSTFT kernel launch on the device
timeline (from the profiler's trace): on the Generator's tail that is
conv_post's convolution, with no elementwise or copy kernel between. Seed
0's random weights give ~25 frames per token. Prints one JSON line;
``--out`` also writes it to a file.

``--streams-of DIR`` instead times the windowed streams of the port in the
checkout ``DIR`` (imported from there; ``.`` for this one), so that two
checkouts can be timed on one card, each in its own process, in turns (A,
B, B, A): ``Synthesizer(KokoroConfig(dtype=...), seed=0)`` with TF32 off
and cuDNN's deterministic algorithms streams ``chip_smoke.py``'s zh_1 and
mixed_4 requests in float32 and zh_1 in bfloat16 through
``stream_decode(exact=False)``, 64-frame windows with 16-frame halos: one
warm stream (where the stream's stages are graphs, it captures them), then
``UNPROFILED_REPS`` timed ones, host clock from ``dispatch`` to the first
chunk and to the last. Per stream: the times, their medians, the windows
and the sha256 of the chunks' bytes (to compare checkouts bitwise).
"""
from __future__ import annotations

import argparse
import json
import os
import glob
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
BUILD = os.path.join(ROOT, "build")  # git-ignored scratch for the trace

CLASSES = (  # first match wins
    ("istft_oa", r"istft_oa"),
    ("adain_snake_conv_carry_bf16", r"adain_snake_conv_carry_bf16"),
    ("adain_snake_conv_bf16", r"adain_snake_conv_tile_bf16"),
    ("adain_snake_conv_carry", r"adain_snake_conv_carry"),
    ("adain_snake_conv", r"adain_snake_conv_tile"),
    # the AdaIN statistics pass, both launches, f32 and bf16 x
    ("adain_fold", r"chunk_moments|finish_rows"),
    # the weight split both conv wrappers launch before their kernel
    ("conv_weight_split", r"split_weights_kernel"),
    ("lstm", r"(?i)rnn|lstm"),
    ("conv_gemm", r"(?i)conv|gemm|xmma|cutlass|implicit|sm90|wgrad|dgrad"),
    ("elementwise_reduce", r"(?i)elementwise|reduce|vectorized|unrolled"
                           r"|index|gather|scan|cat|copy|fill|softmax|norm"),
)

REQUESTS = {
    "b1": ["ni→xau↓ma, tsʰɤ↘ʂɨ↘i↗kɤ↘tʰəst."],
    "b8": ["ni→xau↓ma tʰjɛn→.", "hello wɝld, ðɪs.",
           "tsʰɤ↘ʂɨ↘i↗kɤ↘ ðə.", "tʃən→pu↗tsʰwo↘ hi."] * 2,
}
STREAM = ("b1_stream", "b1", 64, 16)  # name, texts, window, halo frames
STREAM_GRAPH = "b1_stream_graph"
# bench.py's serving shape: 32 copies of a 250-character zh text
BENCH = ("bench_bf16", ("ni↗xau↓ma, tsʰɤ↘ʂɨ↘i↗kɤ↘tʰəst. " * 12)[:250],
         32, 256, 512)  # name, text, batch, token bucket, frame bucket
SPANS = ("decode_prepare", "decode_window")
UNPROFILED_REPS = 5  # timed runs of each request before the profiled one
STREAM_TURNS = 3  # profiled runs of each stream form, in turns, at the end


def spanned(fn, spans, torch):
    """``fn`` with a pair of CUDA events recorded around each call."""
    def call(*args, **kwargs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn(*args, **kwargs)
        end.record()
        spans.append((start, end))
        return out
    return call


def kernel_times(prof, torch):
    """[(kernel name, device us, count)] for every device kernel."""
    cuda = torch.autograd.DeviceType.CUDA
    out = []
    for evt in prof.key_averages():
        if getattr(evt, "device_type", None) != cuda:
            continue
        us = getattr(evt, "self_device_time_total", None)
        if us is None:
            us = evt.self_cuda_time_total
        if us > 0:
            out.append((evt.key, float(us), int(evt.count)))
    return sorted(out, key=lambda r: -r[1])


def before_istft(trace_dir, depth=2):
    """{names of the ``depth`` kernels before an iSTFT kernel, in order:
    count} over the device kernels of the Chrome trace in ``trace_dir``,
    ordered by start time."""
    (path,) = glob.glob(os.path.join(trace_dir, "*.json"))
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    kernels = sorted((e["ts"], e["name"]) for e in events
                     if e.get("cat") == "kernel" and e.get("ph") == "X")
    names = [name for _, name in kernels]
    out = {}
    for i, name in enumerate(names):
        if re.search(CLASSES[0][1], name):
            key = " | ".join(n[:150] for n in names[max(0, i - depth):i])
            out[key] = out.get(key, 0) + 1
    return out


def card_name() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
    ).stdout.strip().splitlines()[0]


def time_streams(checkout: str) -> dict:
    """``--streams-of``: the windowed streams of the port in ``checkout``,
    timed (see the module's docstring)."""
    import hashlib
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "_smoke_texts", os.path.join(ROOT, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    texts = {"zh_1": [smoke.ZH],
             "mixed_4": [smoke.ZH, smoke.MIXED, smoke.EN,
                         smoke.ZH + " " + smoke.EN]}
    sys.path.insert(0, os.path.abspath(checkout))
    import torch

    from illufly_tts_tpu_torch.engine.synthesizer import Synthesizer
    from illufly_tts_tpu_torch.model.config import KokoroConfig

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    window, halo = STREAM[2:]
    card = card_name()

    def stream(engine, batch):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        h = engine.dispatch(batch, ["v"] * len(batch), fmt="f32")
        gen = engine.stream_decode(h, window, halo, exact=False)
        chunks = [next(gen)]
        first_ms = (time.perf_counter() - t0) * 1e3
        chunks += list(gen)
        return (b"".join(c.tobytes() for c in chunks), len(chunks),
                first_ms, (time.perf_counter() - t0) * 1e3)

    out = {"checkout": os.path.abspath(checkout), "card": card,
           "window_frames": window, "halo_frames": halo, "streams": {}}
    for dtype in (torch.float32, torch.bfloat16):
        engine = Synthesizer(KokoroConfig(dtype=dtype), seed=0)
        engine.register_random_voice("v", seed=0)
        for name in (("zh_1", "mixed_4") if dtype == torch.float32
                     else ("zh_1",)):
            label = name if dtype == torch.float32 else f"{name} bf16"
            t0 = time.perf_counter()
            data, windows, _, _ = stream(engine, texts[name])
            warm_s = time.perf_counter() - t0
            runs = [stream(engine, texts[name])
                    for _ in range(UNPROFILED_REPS)]
            first = [r[2] for r in runs]
            whole = [r[3] for r in runs]
            out["streams"][label] = {
                "windows": windows,
                "sha256": hashlib.sha256(data).hexdigest(),
                "repeats_bitwise_equal": all(r[0] == data for r in runs),
                "warm_stream_s": warm_s, "first_chunk_ms": first,
                "all_chunks_ms": whole,
                "first_chunk_median_ms": statistics.median(first),
                "all_chunks_median_ms": statistics.median(whole)}
            print(f"{label}: {windows} windows, first chunk / whole stream "
                  f"ms, medians of {UNPROFILED_REPS}: "
                  f"{statistics.median(first):.1f} / "
                  f"{statistics.median(whole):.1f} ({card})",
                  file=sys.stderr)
        del engine
        torch.cuda.empty_cache()
    return out


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--out", default=None)
    parser.add_argument("--streams-of", default=None, metavar="DIR")
    args = parser.parse_args()

    import dataclasses

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    if args.streams_of:
        result = time_streams(args.streams_of)
        write(result, args.out)
        return 0
    from chip_smoke import eager_windowed_stream
    from illufly_tts_tpu_torch.engine.synthesizer import Synthesizer
    from illufly_tts_tpu_torch.model.config import KokoroConfig
    from illufly_tts_tpu_torch.model.params import export_flax_params
    from illufly_tts_tpu_torch.ops import adain_moments as am
    from illufly_tts_tpu_torch.ops import adain_snake_conv as asc
    from illufly_tts_tpu_torch.ops import istft_oa as oa
    from illufly_tts_tpu_torch.utils.profiling import device_trace

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_name()
    synth = Synthesizer(KokoroConfig(), seed=0)
    synth.register_random_voice("v", seed=0)
    spans = {name: [] for name in SPANS}
    prepare, window = (spanned(getattr(synth.net, name), spans[name], torch)
                       for name in SPANS)
    result = {"card": card, "torch": torch.__version__, "requests": {}}

    def batch(texts, voices):
        h = synth.dispatch(texts, voices)
        synth.collect(h)
        return h, {}

    bf16 = Synthesizer(dataclasses.replace(synth.config, dtype=torch.bfloat16),
                       params=export_flax_params(synth.model),
                       token_buckets=(BENCH[3],), frame_buckets=(BENCH[4],))
    bf16.register_random_voice("v", seed=0)

    def bench(texts, voices):
        h = bf16.dispatch(texts, voices, fmt="pcm16")
        bf16.collect(h)
        return h, {}

    def stream(texts, voices):
        t0 = time.perf_counter()
        h = synth.dispatch(texts, voices)
        gen = eager_windowed_stream(torch, np, synth, h, STREAM[2],
                                    STREAM[3], prepare, window)
        next(gen)
        first_ms = (time.perf_counter() - t0) * 1e3
        return h, {"windows": 1 + len(list(gen)),
                   "first_chunk_ms": first_ms}

    def stream_graph(texts, voices):
        before = sum(synth.graph_replays.values())
        t0 = time.perf_counter()
        h = synth.dispatch(texts, voices)
        gen = synth.stream_decode(h, STREAM[2], STREAM[3], exact=False)
        next(gen)
        first_ms = (time.perf_counter() - t0) * 1e3
        return h, {"windows": 1 + len(list(gen)),
                   "first_chunk_ms": first_ms,
                   "graph_replays": sum(synth.graph_replays.values())
                   - before}

    def replayed(texts, voices):
        before = sum(synth.graph_replays.values())
        h, extra = batch(texts, voices)
        extra["graph_replays"] = sum(synth.graph_replays.values()) - before
        return h, extra

    runs = [(name, texts, batch) for name, texts in REQUESTS.items()]
    runs.append((STREAM[0], REQUESTS[STREAM[1]], stream))
    runs.append((BENCH[0], [BENCH[1]] * BENCH[2], bench))
    runs += [(f"{name}_graph", texts, replayed)
             for name, texts in REQUESTS.items()]
    runs.append((STREAM_GRAPH, REQUESTS[STREAM[1]], stream_graph))
    os.makedirs(BUILD, exist_ok=True)
    for name, texts, run in runs:
        voices = ["v"] * len(texts)
        if run is replayed:  # capture the eager run's keys first
            done = result["requests"][name.removesuffix("_graph")]
            synth.warmup(batch_sizes=(done["b_bucket"],),
                         token_sizes=(done["t_bucket"],),
                         frame_sizes=(done["f_bucket"],))
        run(texts, voices)  # warm (b1_stream_graph's captures its graphs)
        unprofiled = []
        for _ in range(UNPROFILED_REPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            run(texts, voices)
            torch.cuda.synchronize()
            unprofiled.append((time.perf_counter() - t0) * 1e3)
        oa.launches = oa.launches_bf16 = 0
        for table in (asc.launches, asc.launches_bf16, am.launches,
                      am.launches_bf16):
            table.update({k: 0 for k in table})
        for span in spans.values():
            span.clear()
        trace_dir = tempfile.mkdtemp(dir=BUILD)
        with device_trace(trace_dir) as prof:
            t0 = time.perf_counter()
            h, extra = run(texts, voices)
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
        extra["launches"] = {"istft_oa": oa.launches, **asc.launches,
                             "istft_head_bf16": oa.launches_bf16,
                             **asc.launches_bf16, **am.launches,
                             **am.launches_bf16}
        for key, span in spans.items():
            if span:
                extra[f"{key}_span_ms_each"] = sum(
                    s.elapsed_time(e) for s, e in span) / len(span)
                extra[f"{key}_calls"] = len(span)
        kernels = kernel_times(prof, torch)
        extra["kernels_before_istft"] = before_istft(trace_dir)
        shutil.rmtree(trace_dir)
        busy = sum(us for _, us, _ in kernels)
        by_class = {c: 0.0 for c, _ in CLASSES}
        by_class["other"] = 0.0
        for kname, us, _ in kernels:
            cls = next((c for c, pat in CLASSES if re.search(pat, kname)),
                       "other")
            by_class[cls] += us
        result["requests"][name] = {
            "batch": len(texts), "b_bucket": h.b_bucket,
            "t_bucket": h.t_bucket,
            "f_bucket": h.f_bucket,
            "frames": [int(t) for t in h.fitted_totals[: h.n]],
            "wall_ms": wall_us / 1e3,
            "wall_ms_unprofiled": unprofiled,
            "wall_ms_unprofiled_median": statistics.median(unprofiled),
            "device_busy_ms": busy / 1e3,
            "device_idle_share": 1.0 - busy / wall_us,
            "kernel_ms_by_class": {k: v / 1e3 for k, v in by_class.items()},
            "top_kernels": [
                {"name": k[:120], "ms": us / 1e3, "count": n}
                for k, us, n in kernels[:12]
            ],
            **extra,
        }
    result["stream_turns"] = []
    for rep in range(STREAM_TURNS):
        for name, run in ((STREAM[0], stream), (STREAM_GRAPH, stream_graph)):
            trace_dir = tempfile.mkdtemp(dir=BUILD)
            torch.cuda.synchronize()
            with device_trace(trace_dir) as prof:
                run(REQUESTS[STREAM[1]], ["v"])
                torch.cuda.synchronize()
            shutil.rmtree(trace_dir)
            kernels = kernel_times(prof, torch)
            result["stream_turns"].append({
                "turn": rep, "request": name,
                "device_busy_ms": sum(us for _, us, _ in kernels) / 1e3,
                "fused_conv_ms": sum(us for k, us, _ in kernels
                                     if "adain_snake_conv" in k) / 1e3})
    write(result, args.out)
    return 0


def write(result: dict, out: str = None) -> None:
    """Print ``result`` as one JSON line, and write it to ``out`` too."""
    line = json.dumps(result)
    print(line)
    if out:
        os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
        with open(out, "w") as f:
            f.write(line + "\n")


if __name__ == "__main__":
    sys.exit(main())
