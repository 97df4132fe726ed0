# -*- coding: utf-8 -*-
"""The bf16 fused convs and the AdaIN pass with and without row extents,
timed by CUDA-graph replay on one CUDA card, for a comparison of two
checkouts.

    python3 scripts/conv_extents.py [--package-root DIR] [--replays N]
                                    [--out FILE]

Times, on the ``illufly_tts_tpu_torch`` package in DIR (default: this
checkout):

- ``pass``: a Generator pass's 48 bf16 fused convs at B=32, F 512 (the
  offline cell's shape), the 48 launches in one graph; ``pass_f32``: a
  float32 Generator pass's 48 convs and 48 AdaIN passes at B=4, F 512 (the
  float32 serving cells' largest batch), with a ragged mask and no
  extents, as a float32 Generator runs them;
- ``single``: single launches of both forms at k 11 (d 1 and 5) at both
  stages, B=32;
- ``fold``: the AdaIN pass on bf16 x at both stages, B=32; on float32 x,
  without extents, at B=4 and the B=1 stream windows;
- ``full_mask``: the AdaIN pass and both forms under all-ones masks at
  B=8, F 512 and the B=1 stream windows (64 + 2 x 16 frames), bf16 x.

The bf16 rows come in three modes where the package takes row extents
(``cell``: the offline cell's rows, 120-510 of 512 frames; ``full``: full
extents; ``none``), in ``none`` alone where it does not (``full_mask``:
``none`` and ``full``). A single launch is captured 20 times back to back
into one graph; each figure is the median over ``--replays`` replays of a
replay's device time (CUDA events) over its launches. The columns tally
over one pass is read in each mode. To compare with another commit,
unpack it with ``git archive <commit> | tar -x -C build/parent`` and run
``--package-root build/parent`` in a process of its own, in turns with
this checkout (parent, this, this, parent) in one session on the card.
TF32 is off. Prints each row and, last, a JSON line (also written to
FILE).
"""
from __future__ import annotations

import argparse
import json
import math
import os
import statistics
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PER_GRAPH = 20  # launches a graph, for a single launch
CELL_FRAMES = (120, 511)  # the offline cell's rows: 40-170 ids, 3 frames an id
STREAM = ((1, 256, 1920), (1, 128, 11520))  # the B=1 stream windows


def generator_convs(cfg, frames=512):
    """(form, C, L, k, d) of the 48 fused conv launches of one Generator
    pass at ``frames`` frames (its 2 F columns upsampled)."""
    net = cfg.istftnet
    out, length, channels = [], 2 * frames, net.upsample_initial_channel
    for i, u in enumerate(net.upsample_rates):
        length, channels = length * u, channels // 2
        last = i + 1 == len(net.upsample_rates)
        blocks = [(11 if last else 7, (1, 3, 5))] + [
            (k, tuple(dils)) for k, dils in zip(
                net.resblock_kernel_sizes, net.resblock_dilation_sizes)]
        for k, dils in blocks:
            for d in dils:
                out += [("carry", channels, length, k, d),
                        ("tile", channels, length, k, 1)]
    return out


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--package-root", default=REPO,
                        help="checkout holding illufly_tts_tpu_torch/")
    parser.add_argument("--replays", type=int, default=30)
    parser.add_argument("--out", default=None, help="JSON summary file")
    args = parser.parse_args()
    sys.path.insert(0, os.path.abspath(args.package_root))
    import torch

    import illufly_tts_tpu_torch
    from illufly_tts_tpu_torch.model.config import KokoroConfig
    from illufly_tts_tpu_torch.ops import adain_moments as am
    from illufly_tts_tpu_torch.ops import adain_snake_conv as asc
    from illufly_tts_tpu_torch.ops import cuda_build

    if not torch.cuda.is_available():
        sys.exit("conv_extents: no CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip()
    print(f"package {os.path.dirname(illufly_tts_tpu_torch.__file__)}; "
          f"{card}", flush=True)
    info = cuda_build.build(["adain_snake_conv", "adain_moments"])
    for name, rec in info.items():  # ptxas: each kernel's registers
        for line in rec["log"].splitlines():
            if "registers" in line:
                print(f"  {name}: {line.strip()}", flush=True)
    extents = hasattr(asc, "mask_extent")
    modes = ("cell", "full", "none") if extents else ("none",)
    gen = torch.Generator(device="cuda").manual_seed(1234)

    def randn(*shape):
        return torch.randn(shape, device="cuda", generator=gen)

    def graph_ms(fn, per_graph=PER_GRAPH):
        """Median device ms of ``fn`` over the replays of a graph that
        holds it ``per_graph`` times."""
        fn()
        torch.cuda.synchronize()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for _ in range(per_graph):
                fn()
        graph.replay()
        torch.cuda.synchronize()
        times = []
        for _ in range(args.replays):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            graph.replay()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end) / per_graph)
        del graph
        return statistics.median(times)

    def row_mask(rows, length):
        cols = torch.arange(length, device="cuda")[None, :]
        return (cols < torch.tensor(rows, device="cuda")[:, None]).float()

    def cell_rows(batch, length):
        frames = torch.randint(*CELL_FRAMES, (batch,),
                               generator=torch.Generator().manual_seed(901))
        return [int(f) * length // 512 for f in frames]

    def inputs(batch, channels, length, dtype, mask):
        return (randn(batch, channels, length).to(dtype) * 0.5, mask,
                1.0 + 0.1 * randn(batch, channels), 0.1 * randn(batch, channels),
                randn(channels).abs() + 0.5)

    def weights(channels, k, bf16):
        w = randn(k, channels, channels) / math.sqrt(channels * k)
        return (asc.pack_weights(w) if bf16 else w), 0.1 * randn(channels)

    def extent_kw(mode, mask):
        """The keywords of a launch in ``mode``, made before any capture."""
        if mode == "none":
            return {}
        ext = asc.mask_extent(mask)
        return {"extent": ext if mode == "cell"
                else torch.full_like(ext, mask.shape[1])}

    fns = {"tile": asc.adain_snake_conv, "carry": asc.adain_snake_conv_carry}
    out = {"package_root": args.package_root, "card": card,
           "extents": extents, "replays": args.replays, "pass": {},
           "computed_share": {}, "single": [], "fold": [], "full_mask": []}

    # a bf16 Generator pass at B=32, F 512, the cell's rows
    cfg = KokoroConfig()
    convs = generator_convs(cfg)
    stage = {}
    for _, channels, length, _, _ in convs:
        if (channels, length) not in stage:
            mask = row_mask(cell_rows(32, length), length)
            stage[(channels, length)] = inputs(32, channels, length,
                                               torch.bfloat16, mask)
    held = {(c, k): weights(c, k, True) for _, c, _, k, _ in convs}
    kws = {(key, mode): extent_kw(mode, x[1]) for key, x in stage.items()
           for mode in modes}

    def bf16_pass(mode):
        for form, channels, length, k, d in convs:
            fns[form](*stage[(channels, length)], *held[(channels, k)], k, d,
                      **kws[((channels, length), mode)])

    for mode in modes:
        out["pass"][mode] = graph_ms(lambda: bf16_pass(mode), 1)
        if extents:  # the tally over one pass: its share of the tiles
            torch.cuda.synchronize()
            before = asc.columns_tally()
            bf16_pass(mode)
            torch.cuda.synchronize()
            after = asc.columns_tally()
            out["computed_share"][mode] = (
                (after["computed_tiles"] - before["computed_tiles"])
                / (after["grid_tiles"] - before["grid_tiles"]))
    print("a Generator pass's 48 bf16 convs at B=32, F 512: "
          + ", ".join(f"{m} {ms:.4f} ms" for m, ms in out["pass"].items())
          + "; computed share: " + ", ".join(
              f"{m} {v:.4f}" for m, v in out["computed_share"].items()),
          flush=True)
    for (channels, length), x in sorted(stage.items()):
        for form, d in (("tile", 1), ("carry", 5)):
            row = {"conv": [form, 32, channels, length, 11, d]}
            for mode in modes:
                kw = kws[((channels, length), mode)]
                row[mode] = graph_ms(lambda: fns[form](
                    *x, *held[(channels, 11)], 11, d, **kw))
            out["single"].append(row)
        gamma, beta = (0.3 * randn(2, 32, channels)).unbind(0)
        row = {"fold": ["bf16", 32, channels, length]}
        for mode in modes:
            kw = kws[((channels, length), mode)]
            row[mode] = graph_ms(lambda: am.adain_fold(
                x[0], x[1], gamma, beta, **kw))
        out["fold"].append(row)
    del stage, held, kws

    # a float32 Generator pass at B=4, F 512, ragged rows, no extents
    stage = {}
    for _, channels, length, _, _ in convs:
        if (channels, length) not in stage:
            mask = row_mask(cell_rows(4, length), length)
            x = inputs(4, channels, length, torch.float32, mask)
            stage[(channels, length)] = (x, *(0.3 * randn(2, 4, channels))
                                         .unbind(0))
    held = {(c, k): weights(c, k, False) for _, c, _, k, _ in convs}

    def f32_pass():
        for form, channels, length, k, d in convs:
            x, gamma, beta = stage[(channels, length)]
            am.adain_fold(x[0], x[1], gamma, beta)
            fns[form](*x, *held[(channels, k)], k, d)

    out["pass_f32"] = graph_ms(f32_pass, 1)
    print(f"a float32 Generator pass's 48 convs and AdaIN passes at B=4, "
          f"F 512: {out['pass_f32']:.4f} ms", flush=True)
    for (channels, length), (x, gamma, beta) in sorted(stage.items()):
        out["fold"].append({"fold": ["f32", 4, channels, length],
                            "none": graph_ms(lambda: am.adain_fold(
                                x[0], x[1], gamma, beta))})
    del stage, held
    for batch, channels, length in STREAM:
        x = inputs(batch, channels, length, torch.float32,
                   torch.ones(batch, length, device="cuda"))
        gamma, beta = (0.3 * randn(2, batch, channels)).unbind(0)
        out["fold"].append({"fold": ["f32", batch, channels, length],
                            "none": graph_ms(lambda: am.adain_fold(
                                x[0], x[1], gamma, beta))})

    # full masks: B=8 at F 512 and the B=1 stream windows
    for batch, channels, length in ((8, 256, 10240), (8, 128, 61440),
                                    *STREAM):
        x = inputs(batch, channels, length, torch.bfloat16,
                   torch.ones(batch, length, device="cuda"))
        gamma, beta = (0.3 * randn(2, batch, channels)).unbind(0)
        row = {"fold": ["bf16", batch, channels, length]}
        for mode in ("none", "full") if extents else ("none",):
            kw = extent_kw(mode, x[1])
            row[mode] = graph_ms(lambda: am.adain_fold(x[0], x[1], gamma,
                                                       beta, **kw))
        out["full_mask"].append(row)
        for form, d in (("tile", 1), ("carry", 5 if length > 2000 else 3)):
            k = 7 if length == 1920 else 11
            w = weights(channels, k, True)
            row = {"conv": [form, batch, channels, length, k, d]}
            for mode in ("none", "full") if extents else ("none",):
                kw = extent_kw(mode, x[1])
                row[mode] = graph_ms(lambda: fns[form](*x, *w, k, d, **kw))
            out["full_mask"].append(row)
    for row in out["single"] + out["fold"] + out["full_mask"]:
        print("  " + json.dumps(row), flush=True)
    line = json.dumps(out)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as fh:
            fh.write(line + "\n")
    print(line, flush=True)


if __name__ == "__main__":
    main()
