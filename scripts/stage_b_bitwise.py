# -*- coding: utf-8 -*-
"""Stage B's audio at the offline cell's shape, hashed, for a bitwise
comparison of two checkouts on one CUDA card.

    python3 scripts/stage_b_bitwise.py --out A.json [--package-root DIR]
                                       [--seed N] [--batches 4]
    python3 scripts/stage_b_bitwise.py --compare A.json B.json

Builds the engine as ``perfbench`` builds the ``bf16-offline-b32`` cell
(its configuration, seeded weights and voice, buckets B=32, T 256, F 512,
CUDA graphs warmed for pcm16 and f32) on the ``illufly_tts_tpu_torch``
package in DIR (default: this checkout), renders ``--batches`` batches of
the cell's seeded texts through ``dispatch_texts`` / ``launch_decode`` /
``collect_batch`` in both formats, and writes each answer's sha256 and
length (and each batch's f32 byte counts) to the JSON file. Unpack another
commit with ``git archive <commit> | tar -x -C build/parent`` and run each
checkout in its own process; ``--compare`` then exits 1 unless every
answer's bytes agree. TF32 is off, as in the benchmark.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CELL = "bf16-offline-b32"


def render(args) -> dict:
    sys.path.insert(0, REPO)  # perfbench
    sys.path.insert(0, os.path.abspath(args.package_root))
    import numpy as np
    import torch

    import illufly_tts_tpu_torch
    from perfbench.harness import configs, deploy, frontend, registry
    from perfbench.harness import traffic, weights

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    cell = registry.load_json("workloads", CELL)
    cfg = configs.load(cell["config"])
    mix = registry.load_json("traffic", cell["traffic"])
    tables = frontend.load_tables()
    params = weights.make(cfg, args.seed, dev)
    packs = weights.voices(cfg, args.seed, mix["voices"], dev)
    synth = deploy.synthesizer(cfg, params, dev,
                               **cell["deployment"]["buckets"])
    del params
    names = deploy.register_voices(synth, packs)
    warm = dict(cell["deployment"]["warmup"], formats=["pcm16", "f32"])
    synth.warmup(**{k: tuple(v) if isinstance(v, list) else v
                    for k, v in warm.items()})
    pipe = deploy.pipeline(synth, tables)
    requests, _ = traffic.generate(mix, args.seed, 60.0, tables)
    batch = mix["batch"]
    out = {"package": os.path.dirname(illufly_tts_tpu_torch.__file__),
           "seed": args.seed, "card": subprocess.run(
               ["nvidia-smi", "--query-gpu=name,power.limit",
                "--format=csv,noheader"], capture_output=True, text=True,
               timeout=60).stdout.strip(), "answers": {}, "bytes": []}
    for i in range(args.batches):
        texts = [r["text"] for r in requests[i * batch:(i + 1) * batch]]
        for fmt in ("pcm16", "f32"):
            handle = pipe.dispatch_texts(texts, [names[0]] * len(texts),
                                         output_format=fmt)
            pipe.launch_decode(handle)
            audios = pipe.collect_batch(handle, fmt)
            for j, audio in enumerate(audios):
                raw = np.ascontiguousarray(audio).tobytes()
                out["answers"][f"{i}.{j}.{fmt}"] = [
                    hashlib.sha256(raw).hexdigest(), len(raw)]
        out["bytes"].append([out["answers"][f"{i}.{j}.f32"][1]
                             for j in range(len(texts))])
    return out


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--package-root", default=REPO)
    parser.add_argument("--seed", type=int, default=2147483901)
    parser.add_argument("--batches", type=int, default=4)
    parser.add_argument("--out", default=None)
    parser.add_argument("--compare", nargs=2, default=None)
    args = parser.parse_args()
    if args.compare:
        a, b = (json.load(open(p)) for p in args.compare)
        differ = sorted(k for k in a["answers"]
                        if a["answers"][k] != b["answers"].get(k))
        same = len(a["answers"]) - len(differ)
        print(json.dumps({"answers": len(a["answers"]), "bitwise_equal": same,
                          "differ": differ[:20], "seed": a["seed"],
                          "card": a["card"]}))
        sys.exit(1 if differ or a["answers"].keys() != b["answers"].keys()
                 else 0)
    out = render(args)
    line = json.dumps(out)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as fh:
            fh.write(line + "\n")
    print(f"{len(out['answers'])} answers hashed; {out['card']}", flush=True)


if __name__ == "__main__":
    main()
