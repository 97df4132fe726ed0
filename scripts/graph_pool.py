# -*- coding: utf-8 -*-
"""Phase 15 of ``chip_smoke.py`` alone: the CUDA-graph pool of a
checkout's engine, on one CUDA card.

    python3 scripts/graph_pool.py [--package-root DIR] [--out FILE]

Runs ``chip_smoke.pool_phase`` (``warmup()`` with the JAX engine's default
arguments on a fresh engine, two first-use windowed streams after it, the
largest key captured alone beside its stage run eagerly) on the checkout in
DIR (default: this one), its ``illufly_tts_tpu_torch`` package with its own
``chip_smoke.py``, so that each checkout's engine is measured by the phase
that counts its kernels: unpack another commit with ``git archive <commit>
| tar -x -C build/parent`` and pass ``--package-root build/parent``. TF32
is off, as in
``chip_smoke.py``. Prints the phase's lines, the card's name and power
limit and, last, the phase's JSON summary (also written to FILE); exits 1
if one of its checks failed.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--package-root", default=REPO,
                        help="checkout holding illufly_tts_tpu_torch/ and "
                        "chip_smoke.py")
    parser.add_argument("--out", default=None, help="JSON summary file")
    args = parser.parse_args()
    sys.path.insert(0, REPO)
    sys.path.insert(0, os.path.abspath(args.package_root))
    import numpy as np
    import torch

    import chip_smoke
    from illufly_tts_tpu_torch.model.config import KokoroConfig

    if not torch.cuda.is_available():
        chip_smoke.fail("no CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip()
    import illufly_tts_tpu_torch
    print(f"package {os.path.dirname(illufly_tts_tpu_torch.__file__)}; "
          f"{card}", flush=True)
    failures = []
    out = chip_smoke.pool_phase(torch, np, KokoroConfig(),
                                chip_smoke.REQUESTS, card, failures)
    out["package_root"] = args.package_root
    out["failures"] = failures
    line = json.dumps(out)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as fh:
            fh.write(line + "\n")
    for failure in failures:
        print(f"FAIL: {failure}", file=sys.stderr)
    print(card, flush=True)
    print(line, flush=True)
    sys.exit(1 if failures else 0)


if __name__ == "__main__":
    main()
