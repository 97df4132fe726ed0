"""Shared pieces of the benchmark's CPU tests."""
import contextlib
import io
import json
import time

import pytest
import torch

from perfbench.harness import main

def tiny_config(dtype: str = "float32") -> dict:
    """A configuration small enough for the CPU tests: the stack's shape
    with narrow layers."""
    return {
        "n_token": 256, "hidden_dim": 32, "style_dim": 16, "max_dur": 10,
        "n_layer": 2, "text_encoder_kernel_size": 5, "sample_rate": 24000,
        "albert": {"vocab_size": 256, "embedding_size": 16, "hidden_size": 32,
                   "num_heads": 4, "intermediate_size": 64, "num_layers": 2,
                   "max_position": 512},
        "istftnet": {"upsample_rates": (10, 6),
                     "upsample_kernel_sizes": (20, 12),
                     "upsample_initial_channel": 32,
                     "resblock_kernel_sizes": (3, 7),
                     "resblock_dilation_sizes": ((1, 3), (1, 3)),
                     "gen_istft_n_fft": 20, "gen_istft_hop_size": 5},
        "dtype": dtype, "duration_bias": -1.0, "magnitude_gain": 0.05,
        "f0_gain": 0.1,
    }


TINY_TRAFFIC = {
    "f32-serve-poisson": {"rate_per_s": 3.0},
    "f32-serve-repeat": {"rate_per_s": 3.0,
                         "prompts": {"count": 4, "zipf": 1.0,
                                     "unique_share": 0.2}},
    "f32-stream-windowed": {"streams": 40},
    "bf16-offline-b32": {"batches": 6},
}

# the offline cell's queue two batches deep: 6 batches are what the CPU
# renders in a tiny window
TINY_DEPLOYMENT = {"bf16-offline-b32": {"ahead_batches": 2}}


def tiny_run(cell: str, seconds: float = 2.0, seed: int = 3000000123,
             trace: int = 0) -> dict:
    """One run of ``cell`` on the CPU at the tiny configuration: the whole
    harness but the look for a card. -> the result line, parsed."""
    torch.set_num_threads(2)
    cfg = tiny_config("bfloat16" if "bf16" in cell else "float32")
    args = main.parse(["--workload", cell, "--seed", str(seed),
                       "--seconds", str(seconds), "--trace", str(trace)])
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = main.run(args, time.perf_counter(), device="cpu",
                      overrides={"config": cfg,
                                 "traffic": TINY_TRAFFIC[cell],
                                 "deployment": TINY_DEPLOYMENT.get(cell, {})})
    assert rc == 0, out.getvalue()
    return json.loads(out.getvalue().strip().splitlines()[-1])


def need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
