"""Shared pieces of the benchmark's CPU tests."""
import contextlib
import io
import json
import time

import pytest
import torch

from perfbench.harness import configs, main, registry


def tiny_sizes(cell: str) -> dict:
    """The sizes the CPU tests run ``cell`` at: its configuration's
    family's ``tiny``, in the configuration's compute type."""
    config = registry.load_json("workloads", cell)["config"]
    return configs.family(config).tiny(configs.load(config)["dtype"])


# what the CPU renders in a tiny window, by the mix's kind: 6 offline
# batches, 3 requests a second, 40 streams
TINY_TRAFFIC = {
    "offline_batches": {"batches": 6},
    "open_poisson": {"rate_per_s": 3.0},
    "closed_stream": {"streams": 40},
}


def tiny_overrides(cell: str) -> dict:
    """{"traffic", "deployment"}: the keys that take ``cell``'s mix and
    deployment down to a tiny run, found by the mix's ``kind``. A mix of
    fixed prompts draws 4 of them, a fifth of the requests new; an offline
    queue is two batches deep."""
    spec = registry.load_json("workloads", cell)
    mix = registry.load_json("traffic", spec["traffic"])
    traffic = dict(TINY_TRAFFIC[mix["kind"]])
    if "prompts" in mix:
        traffic["prompts"] = {**mix["prompts"], "count": 4,
                              "unique_share": 0.2}
    deployment = {"ahead_batches": 2} \
        if "ahead_batches" in spec["deployment"] else {}
    return {"traffic": traffic, "deployment": deployment}


def tiny_run(cell: str, seconds: float = 2.0, seed: int = 3000000123,
             trace: int = 0) -> dict:
    """One run of ``cell`` on the CPU at its family's tiny sizes: the whole
    harness but the look for a card. -> the result line, parsed."""
    torch.set_num_threads(2)
    args = main.parse(["--workload", cell, "--seed", str(seed),
                       "--seconds", str(seconds), "--trace", str(trace)])
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = main.run(args, time.perf_counter(), device="cpu",
                      overrides={"config": tiny_sizes(cell),
                                 **tiny_overrides(cell)})
    assert rc == 0, out.getvalue()
    return json.loads(out.getvalue().strip().splitlines()[-1])


def need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
