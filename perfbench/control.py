"""The control of a cell's comparison: the plain reference, its products'
operands rounded to the precision below the configuration's (TF32 for
float32, fp8 for bfloat16), put in the program's place and judged as a run
judges the program: the same traffic, the same sample, the same numbers.

    python3 perfbench/control.py --workload <cell> --seeds 1,2,3

prints one JSON line per seed with every number; a limit has to lie below
what the control reads (``PERF.md``, Limits). It runs on the card at the
cell's own size and needs no window: the control renders the sample
alone."""
import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from perfbench.harness import check, configs, frontend, registry, traffic  # noqa: E402

DEFAULT_FRAMES = (64, 128, 192, 256, 384, 512, 768, 1024, 1536, 2048, 3072,
                  4096)


def readings(cell_name: str, seed: int, device: str = "cuda",
             cfg=None, mix_override=None, sample=None) -> dict:
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cell = registry.load_json("workloads", cell_name)
    family = configs.family(cell["config"])
    cfg = cfg or configs.load(cell["config"])
    mix = {**registry.load_json("traffic", cell["traffic"]),
           **(mix_override or {})}
    tables = frontend.load_tables()
    requests, _ = traffic.generate(mix, seed, 30.0, tables)
    params = family.make(cfg, seed, device)
    packs = family.voices(cfg, seed, mix["voices"], device)
    names = [f"bench_{i}" for i in range(len(packs))]
    ref = family.Judge(cfg, params, packs)
    control = family.Judge(cfg, params, packs, check.CONTROLS[cfg["dtype"]])
    form = cell["check"]["form"]
    buckets = cell["deployment"].get("buckets", {}).get("frame_buckets") \
        or DEFAULT_FRAMES
    picked = check.pick_sample(requests, sample or cell["check"]["sample"],
                               seed, size=lambda a: len(a["ipa"]))
    t0 = time.perf_counter()
    answers, rows = check.control_answers(picked, control, form, buckets,
                                          names)
    numbers = check.judge(answers, rows, ref, form, answers, names)
    return {"workload": cell_name, "seed": seed, "control": cfg["dtype"],
            "answers": len(answers), "seconds": time.perf_counter() - t0,
            **numbers}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    args = p.parse_args(argv)
    for seed in (int(x) for x in args.seeds.split(",")):
        print(json.dumps(readings(args.workload, seed)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
