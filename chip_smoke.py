# -*- coding: utf-8 -*-
"""Smoke run of the PyTorch port on one CUDA card (H100, sm_90a).

    python3 chip_smoke.py

From the root of a checkout. It
1. reports torch/CUDA versions and the card's name and power limit, and
   turns TF32 off for matrix products and convolutions (float32 throughout);
2. builds every CUDA kernel of the port from ``illufly_tts_tpu_torch/csrc``
   (one nvcc per source, all at once) and reports the build time;
3. holds each kernel against its plain PyTorch version on the card
   (max-abs tolerance stated per kernel) and times both with CUDA events;
4. drives the main path — ``Synthesizer.synthesize_batch`` and
   ``dispatch -> launch_decode -> collect`` at the full ``KokoroConfig()``
   with seeded random weights and a random voice — on a few requests, in
   pcm16 and f32, and checks lengths, finiteness, non-silence and that each
   kernel was launched once per stage B;
5. holds the port on the card against the port on the CPU at full width
   (B=2, frame bucket 128), both stage Bs fed the card's stage-A outputs.

It prints a ``{"kernels": [...]}`` JSON line and, last, ``{"ok": true,
"device": {...}}``. Any failed check exits non-zero with no result line;
so does a host without CUDA, or a directory without the port's package.
"""
from __future__ import annotations

import json
import math
import os
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))

# H100 SXM published peaks (NVIDIA data sheet): HBM bytes/s, f32 (non
# tensor-core) operations/s
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12

ISTFT_TOL = 1e-4       # max-abs, as the JAX package holds its Pallas iSTFT
CPU_GPU_TOL = 5e-3     # rms/scale, the golden-audio gate's waveform bound

ZH = "ni→xau↓ma, tsʰɤ↘ʂɨ↘i↗kɤ↘tʰəst."
MIXED = "tʰjɛn→tʃʰi↘tʃən→pu↗tsʰwo↘. hello wɝld."
EN = "ðɪs ɪz ə smˈoʊk tˈɛst ʌv ðə pˈɔɹt."


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, reps, flush):
    """Median device time of ``fn`` in ms over ``reps`` runs, each after a
    write of ``flush`` (larger than L2) so inputs come from device memory;
    the flush also keeps the card busy while the host enqueues ``fn``."""
    import torch

    times = []
    for _ in range(reps):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def istft_inputs(torch, batch, frames, seed, zero=False):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    shape = (batch, frames, 11)
    if zero:
        return (torch.zeros(shape, device="cuda"),
                torch.zeros(shape, device="cuda"))
    mag = torch.randn(shape, device="cuda", generator=gen).abs()
    phase = (torch.rand(shape, device="cuda", generator=gen) * 2 - 1) * math.pi
    return mag, phase


def check_istft(torch, oa, shapes):
    """Kernel vs plain at each (batch, frames, zero) -> max abs error."""
    worst = 0.0
    for i, (batch, frames, zero) in enumerate(shapes):
        mag, phase = istft_inputs(torch, batch, frames, seed=i, zero=zero)
        out = oa.istft_oa(mag, phase)
        torch.cuda.synchronize()
        ref = oa.istft_oa_plain(mag, phase)
        if out.shape != (batch, frames * 5):
            fail(f"istft_oa shape {tuple(out.shape)} at {(batch, frames)}")
        err = float((out - ref).abs().max())
        if zero and float(out.abs().max()) != 0.0:
            fail("istft_oa: zero input gave nonzero audio")
        log(f"  istft_oa [{batch}, {frames}, 11]{' zero' if zero else ''}:"
            f" max|kernel - plain| = {err:.3e}")
        if not err <= ISTFT_TOL:
            fail(f"istft_oa disagrees with plain at {(batch, frames)}: {err}")
        worst = max(worst, err)
    return worst


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke run needs a "
             "CUDA card")
    sys.path.insert(0, HERE)
    try:
        import numpy as np

        from illufly_tts_tpu_torch.engine.synthesizer import Synthesizer
        from illufly_tts_tpu_torch.model.config import KokoroConfig
        from illufly_tts_tpu_torch.ops import cuda_build
        from illufly_tts_tpu_torch.ops import istft_oa as oa
    except ImportError as exc:
        fail(f"the port's package is not beside this script: {exc}")

    # ---- 1. environment ---------------------------------------------------
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()
    log(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}, device {torch.cuda.get_device_name(0)}")
    log("TF32 off: torch.backends.cuda.matmul.allow_tf32 = False, "
        "torch.backends.cudnn.allow_tf32 = False")
    card = smi[0] if smi else "nvidia-smi gave nothing"
    log(card)

    # ---- 2. build ------------------------------------------------------------
    t0 = time.perf_counter()
    info = cuda_build.build(["istft_oa"])
    log(f"kernels built in {time.perf_counter() - t0:.2f} s")
    for name, rec in info.items():
        for line in rec["log"].splitlines():
            if "registers" in line or "bytes" in line:
                log(f"  {name}: {line.strip()}")

    # ---- 3. kernel vs plain -----------------------------------------------
    log("istft_oa kernel vs plain (|randn| magnitudes, uniform phases):")
    max_err = check_istft(torch, oa, [
        (8, 61440, False),  # B=8 at frame bucket 512 (120 frames per frame)
        (3, 1000, False),   # ragged: not a multiple of the 128-frame tile
        (2, 37, False),     # smaller than one tile
        (1, 4096, False),   # B=1
        (2, 256, True),     # zero input
    ])
    mag, phase = istft_inputs(torch, 8, 61440, seed=99)
    flush = torch.empty(64 * 2 ** 20, device="cuda")  # 256 MB > 50 MB L2
    for _ in range(3):
        oa.istft_oa(mag, phase)
        oa.istft_oa_plain(mag, phase)
    kernel_ms = cuda_ms(lambda: oa.istft_oa(mag, phase), 50, flush)
    plain_ms = cuda_ms(lambda: oa.istft_oa_plain(mag, phase), 20, flush)
    batch, frames = mag.shape[:2]
    n_bytes = 2 * mag.numel() * 4 + batch * frames * 5 * 4
    n_ops = batch * frames * 5 * 88 * 2  # 88 FMAs per output sample
    bound_ms = max(n_bytes / HBM_BYTES_PER_S, n_ops / F32_OPS_PER_S) * 1e3
    bound_by = ("bytes" if n_bytes / HBM_BYTES_PER_S
                >= n_ops / F32_OPS_PER_S else "operations")
    log(f"istft_oa at [8, 61440, 11]: kernel {kernel_ms:.4f} ms, plain "
        f"{plain_ms:.4f} ms, bound {bound_ms * 1e3:.2f} us ({bound_by}: "
        f"{n_bytes / 1e6:.1f} MB), library: none (torch.istft(center=False) "
        "refuses the zero window envelope at sample 0)")

    # ---- 4. main path -----------------------------------------------------------
    t0 = time.perf_counter()
    synth = Synthesizer(KokoroConfig(), seed=0)
    synth.register_random_voice("smoke_voice", seed=0)
    log(f"Synthesizer(KokoroConfig(), seed=0) on {synth.device} in "
        f"{time.perf_counter() - t0:.1f} s")
    long_zh = " ".join([ZH, MIXED, ZH, MIXED, ZH])
    long_en = " ".join([EN, MIXED, EN, ZH])
    requests = {
        "zh_1": [ZH],
        "mixed_4": [ZH, MIXED, EN, ZH + " " + EN],
        "long_8": [long_zh, long_en] * 4,
    }
    failures = []

    def serve(texts, fmt):
        h = synth.dispatch(texts, ["smoke_voice"] * len(texts), fmt=fmt)
        out = synth.collect(h)
        return h, out

    for texts in requests.values():  # warm pass
        synth.synthesize_batch(texts, ["smoke_voice"] * len(texts))
    torch.cuda.synchronize()

    oa.launches = 0
    stage_b_runs = 0
    main_shapes = set()
    timings = {}
    buckets = {}
    for name, texts in requests.items():
        torch.cuda.reset_peak_memory_stats()
        for fmt in ("pcm16", "f32"):
            before = oa.launches
            t0 = time.perf_counter()
            h, out = serve(texts, fmt)
            wall = time.perf_counter() - t0
            stage_b_runs += 1
            main_shapes.add((h.b_bucket, h.f_bucket * 120))
            if oa.launches - before != 1:
                failures.append(f"{name}/{fmt}: istft_oa launched "
                                f"{oa.launches - before} times in 1 stage B")
            for i, wave in enumerate(out):
                want = int(h.fitted_totals[i]) * 600
                if wave.shape != (want,):
                    failures.append(f"{name}/{fmt}[{i}]: {wave.shape} != "
                                    f"({want},)")
                if not np.isfinite(wave).all():
                    failures.append(f"{name}/{fmt}[{i}]: non-finite audio")
                if float(np.abs(wave).max()) <= 1e-4:
                    failures.append(f"{name}/{fmt}[{i}]: silent")
            if fmt == "pcm16":
                timings[name] = wall
                buckets[name] = (h.t_bucket, h.f_bucket)
                log(f"request {name}: B={len(texts)} (bucket {h.b_bucket}), "
                    f"T_bucket={h.t_bucket}, F_bucket={h.f_bucket}, frames "
                    f"{[int(t) for t in h.fitted_totals[: h.n]]}, audio "
                    f"{sum(w.size for w in out) / 24000:.1f} s, wall "
                    f"{wall * 1e3:.1f} ms (pcm16, warm)")
        log(f"  peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f}"
            " GiB")
    launches = oa.launches
    log(f"main path: {stage_b_runs} stage B runs, istft_oa launches "
        f"{launches}")
    if launches == 0 or launches != stage_b_runs:
        failures.append(f"istft_oa launches {launches} != stage B runs "
                        f"{stage_b_runs}")
    t_long, f_long = buckets["long_8"]
    if t_long < 128 or f_long < 512:
        failures.append(f"long_8 reached T_bucket={t_long}, F_bucket="
                        f"{f_long}; wanted >= 128 and >= 512")

    log("istft_oa kernel vs plain at the main path's shapes:")
    max_err = max(max_err, check_istft(
        torch, oa, [(b, f, False) for b, f in sorted(main_shapes)]))

    # ---- 5. card vs CPU -----------------------------------------------------------
    t0 = time.perf_counter()
    cpu = Synthesizer(KokoroConfig(), seed=0, device="cpu")
    cpu.register_random_voice("smoke_voice", seed=0)
    texts = [ZH, MIXED]
    with torch.inference_mode():
        hg = synth.dispatch(texts, ["smoke_voice"] * 2, fmt="f32")
        hc = cpu.dispatch(texts, ["smoke_voice"] * 2, fmt="f32")
        n_diff = int((hg.pred_dur.cpu() != hc.pred_dur).sum())
        args = (hg.ids, hg.mask, hg.d, hg.pred_dur, hg.ref, hg.pitch)
        wave_g, _ = synth._stage_b(*args, 128, "f32")
        wave_c, _ = cpu._stage_b(*(a.cpu() for a in args), 128, "f32")
    wave_g = wave_g.cpu().numpy()
    wave_c = wave_c.numpy()
    rms = float(np.sqrt(np.mean((wave_g - wave_c) ** 2)))
    scale = float(np.sqrt(np.mean(wave_c ** 2))) + 1e-9
    log(f"card vs CPU (full width, B=2, F_bucket=128): rms/scale "
        f"{rms / scale:.3e} (limit {CPU_GPU_TOL}), stage-A pred_dur entries "
        f"that differ: {n_diff} of {hg.pred_dur.numel()}, "
        f"{time.perf_counter() - t0:.1f} s")
    if not rms / scale < CPU_GPU_TOL:
        failures.append(f"card vs CPU rms/scale {rms / scale}")

    if failures:
        for f in failures:
            print(f"FAIL: {f}", file=sys.stderr)
        sys.exit(1)

    log(json.dumps({"kernels": [{
        "name": "istft_oa",
        "route": "cuda",
        "source": "illufly_tts_tpu_torch/csrc/istft_oa.cu",
        "replaces": "illufly_tts_tpu/ops/pallas/istft_oa.py:88",
        "launches": launches,
        "stage_b_runs": stage_b_runs,
        "launches_per_stage_b": launches / stage_b_runs,
        "max_abs_err": max_err,
        "ms": kernel_ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": None,
        "library_note": "no single PyTorch call computes it: "
                        "torch.istft(center=False) refuses the zero window "
                        "envelope at sample 0 (NOLA check)",
        "shape": [8, 61440, 11],
        "card": card,
    }]}))
    log(json.dumps({"requests_wall_ms": {
        k: v * 1e3 for k, v in timings.items()}}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)


if __name__ == "__main__":
    main()
