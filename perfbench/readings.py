"""The numbers that decide ``correct``, read from the program on many seeds
in one process: for each seed a whole run of the cell (its own weights,
engine, warmup, a window at the cell's load and sizes, the check), its
result line printed as ``run.py`` prints it. For setting a limit from the
program's readings (``PERF.md``, Limits), where a new process per seed
would cost more than its window.

    python3 perfbench/readings.py --workload <cell> --seeds 1,2,3 --seconds 5
"""
import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from perfbench.harness import main as harness  # noqa: E402


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, required=True)
    args = p.parse_args(argv)
    for seed in args.seeds.split(","):
        rc = harness.main(["--workload", args.workload, "--seed", seed,
                           "--seconds", str(args.seconds), "--trace", "0"],
                          time.perf_counter())
        if rc:
            return rc
    return 0


if __name__ == "__main__":
    sys.exit(main())
