# -*- coding: utf-8 -*-
"""``chip_smoke.py`` phase 10's gradient comparison, repeated, on one CUDA
card.

    python3 scripts/grad_check_repeat.py [--runs 10] [--out FILE]

Each run trains a fresh copy of the engine's seeded random weights
(``Synthesizer(KokoroConfig(), seed=0)``) for 3 ``train()`` steps at the
JAX ``train`` CLI's defaults (B=8, 64 tokens, 128 frames), as phase 10
does, then compares one batch's gradients through the kernels with those
through the plain versions three times: as phase 10 does (the Generator's
noise blocks and the F0/N towers' and the trunk's ``AdaIN1d`` moments
plain in both passes, ``chip_smoke.NOISE_BLOCK`` and
``chip_smoke.gradient_passes``); with the noise blocks through the kernels
too (``noise_blocks_kernel``, the comparison before that repair); and with
the front's ``AdaIN1d`` moments through the AdaIN pass's kernel too
(``front_kernel``). Prints each run's worst and median relative L2 over
the non-degenerate leaves, then one JSON line with every run, the worst
readings and the card's name and power limit (also written to ``--out``).
Exits 1 if a run fails phase 10's check (``GRAD_TOL``, the degenerate
leaves' bound, no zero gradients).

Before the runs it measures what the comparison rests on: one fused conv
at the training shape [8, 128, 15360, k=11, d=5] through the f32 kernel
and through the plain version (cuDNN) against float64 (max and rms error
over the output's peak and rms); and, on the first run's weights, each
gradient pass repeated with the noise blocks through the kernels (the
worst and median relative L2 over the leaves outside ``DEGENERATE``
between two passes through the kernels, two through the plain versions,
and the plain versions with ``cudnn.deterministic`` against without).
"""
from __future__ import annotations

import argparse
import copy
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def conv_errors(torch, asc):
    """The f32 kernel and the plain version (cuDNN f32) of one fused conv
    at the training shape against float64: {version: (max error / peak,
    rms error / rms)}."""
    import math

    gen = torch.Generator(device="cuda").manual_seed(0)

    def randn(*shape):
        return torch.randn(shape, device="cuda", generator=gen)

    batch, channels, length, k, d = 8, 128, 15360, 11, 5
    args = (randn(batch, channels, length) * 0.5,
            torch.ones(batch, length, device="cuda"),
            1.0 + 0.1 * randn(batch, channels), 0.1 * randn(batch, channels),
            randn(channels).abs() + 0.5,
            randn(k, channels, channels) / math.sqrt(channels * k),
            0.1 * randn(channels))
    ref = asc.adain_snake_conv_plain(*(t.double() for t in args), k, d)
    out = {}
    for name, fn in (("kernel", asc.adain_snake_conv),
                     ("plain", asc.adain_snake_conv_plain)):
        err = fn(*args, k, d).double() - ref
        out[name] = (float(err.abs().max() / ref.abs().max()),
                     float(err.square().mean().sqrt()
                           / ref.square().mean().sqrt()))
    return out


def repeats(torch, smoke, model, batch, frames, layers, vocoder, asc, oa):
    """Each gradient pass twice on the same weights and batch, and the plain
    pass with deterministic cuDNN: {comparison: (worst, median) relative L2
    over the leaves outside ``DEGENERATE``}."""
    import re
    import statistics

    degenerate = re.compile(smoke.DEGENERATE)

    def worst(a, b):
        errs = [float((a[n] - g).norm()) / max(float(g.norm()), 1e-30)
                for n, g in b.items() if not degenerate.search(n)]
        return max(errs), statistics.median(errs)

    first = smoke.gradient_passes(torch, model, batch, frames, layers,
                                  vocoder, asc, oa, noise_blocks_plain=False)
    second = smoke.gradient_passes(torch, model, batch, frames, layers,
                                   vocoder, asc, oa,
                                   noise_blocks_plain=False)
    torch.backends.cudnn.deterministic = True
    try:
        det = smoke.gradient_passes(torch, model, batch, frames, layers,
                                    vocoder, asc, oa,
                                    noise_blocks_plain=False)
    finally:
        torch.backends.cudnn.deterministic = False
    return {"kernels_twice": worst(first[0], second[0]),
            "plain_twice": worst(first[1], second[1]),
            "plain_deterministic_cudnn": worst(det[1], first[1]),
            "kernels_vs_plain_deterministic_cudnn": worst(det[0], det[1])}


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--runs", type=int, default=10)
    parser.add_argument("--out", default=None)
    args = parser.parse_args()
    import torch

    if not torch.cuda.is_available():
        sys.exit("no CUDA card: the comparison runs the kernels on one")
    import chip_smoke as smoke
    from illufly_tts_tpu_torch.engine.synthesizer import Synthesizer
    from illufly_tts_tpu_torch.model import layers, vocoder
    from illufly_tts_tpu_torch.model.config import KokoroConfig
    from illufly_tts_tpu_torch.ops import adain_snake_conv as asc
    from illufly_tts_tpu_torch.ops import istft_oa as oa
    from illufly_tts_tpu_torch.training import loop

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    init = Synthesizer(KokoroConfig(), seed=0).model
    shape = smoke.TRAIN
    runs, failed = [], False
    diagnosis = {"forward_vs_float64": conv_errors(torch, asc)}
    print(f"one fused conv at [8, 128, 15360, 11, 5] against float64: "
          f"{diagnosis['forward_vs_float64']}", flush=True)
    for run in range(args.runs):
        model = copy.deepcopy(init)
        drawn, synthetic = [], loop.synthetic_batches

        def keep(*a, **kw):
            for item in synthetic(*a, **kw):
                drawn.append(item)
                yield item

        loop.synthetic_batches = keep
        try:
            loop.train(model, steps=3, batch_size=shape["batch"],
                       tokens=shape["tokens"], frames=shape["frames"],
                       log_every=0)
        finally:
            loop.synthetic_batches = synthetic
        row = {}
        if run == 0:
            diagnosis["repeats"] = repeats(torch, smoke, model, drawn[0],
                                           shape["frames"], layers, vocoder,
                                           asc, oa)
            print(f"each pass repeated ((worst, median) relative L2): "
                  f"{diagnosis['repeats']}", flush=True)
        for label, noise_plain, front_plain in (
                ("phase10", True, True), ("noise_blocks_kernel", False, True),
                ("front_kernel", True, False)):
            through, plain = smoke.gradient_passes(
                torch, model, drawn[0], shape["frames"], layers, vocoder,
                asc, oa, noise_blocks_plain=noise_plain,
                front_plain=front_plain)
            summary, wrong = smoke.compare_gradients(through, plain)
            row[label] = {key: summary[key] for key in (
                "worst_rel_l2", "worst_leaf", "median_rel_l2")}
            if label == "phase10" and wrong:
                row["failed"] = wrong
                failed = True
            del through, plain
        runs.append(row)
        print(f"run {run}: phase 10's comparison worst "
              f"{row['phase10']['worst_rel_l2']:.3e} "
              f"({row['phase10']['worst_leaf']}), median "
              f"{row['phase10']['median_rel_l2']:.3e}; noise blocks through "
              f"the kernels too: worst "
              f"{row['noise_blocks_kernel']['worst_rel_l2']:.3e} "
              f"({row['noise_blocks_kernel']['worst_leaf']}), median "
              f"{row['noise_blocks_kernel']['median_rel_l2']:.3e}; the "
              f"front's AdaIN1d through the kernel too: worst "
              f"{row['front_kernel']['worst_rel_l2']:.3e} "
              f"({row['front_kernel']['worst_leaf']})"
              f"{'; FAILED ' + str(row['failed']) if 'failed' in row else ''}",
              flush=True)
        del model
        torch.cuda.empty_cache()
    out = {"runs": runs, "diagnosis": diagnosis, "tolerance": smoke.GRAD_TOL,
           "worst": max(r["phase10"]["worst_rel_l2"] for r in runs),
           "worst_noise_blocks_kernel": max(
               r["noise_blocks_kernel"]["worst_rel_l2"] for r in runs),
           "worst_front_kernel": max(
               r["front_kernel"]["worst_rel_l2"] for r in runs),
           "card": card}
    line = json.dumps(out)
    print(line, flush=True)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
