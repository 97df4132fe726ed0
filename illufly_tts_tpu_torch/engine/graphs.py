# -*- coding: utf-8 -*-
"""The engine's stages as CUDA graphs, one per serving key.

The JAX engine compiles one XLA program per serving key before traffic
(``warmup``): stage A per ``(batch, tokens)``, stage B per ``(batch, tokens,
frames, fmt)``; and the windowed stream's two programs at their first use,
the prepare per ``("prep", batch, tokens, frames)`` and the window per
``("win", batch, window, halo)``, one program for every window position.
The port has nothing to compile, but an eager stage pays Python and one
launch per op on every call. Its counterpart of a compiled program is a
stage captured as a CUDA graph: one replay launches every kernel of the
stage, the three hand-written kernels among them.

A ``StageGraph`` is
- **static inputs**, allocated before the capture (outside the graph pool);
  each run copies its inputs into them;
- **one eager warm pass** on the engine's side stream, which makes what a
  capture may not: the nvcc builds (``ops/cuda_build.py``), the STFT tables
  (``ops/stft.py::_table``), the SM count, the bfloat16 packed weights, the
  cuBLAS workspace of that stream;
- **the graph**, captured on that stream into the one memory pool all of
  the replica's graphs share (a private pool per graph would hold the
  largest stage's intermediates once per key), under the engine's lock.
  ``capture`` also captures it again, on the same static inputs and with
  no warm pass, into a new pool: the engine rebuilds a replica's pool
  largest key first when a warmup brings a key larger than every key the
  pool holds (``engine/synthesizer.py::_Replica._warm``);
- **its outputs**, which each run clones before the lock is released: the
  next replay of any graph in the shared pool may reuse their memory;
- **its launches** of each hand-written kernel, which the capture tallied
  (``ops/capture_tally.py``) and each replay adds to the wrappers' counts;
- **the allocator's state** (``torch.cuda.memory_stats``: reserved and
  allocated bytes, segments) just before and just after the capture, so
  that the pool's growth can be laid to a key. ``torch.cuda.graph`` begins
  by releasing the allocator's unused cached blocks; "before" is taken
  after doing the same, so that the difference is the capture's own.

Every step (warm pass, capture, replay) runs under its inputs' device, so
that a replica on another card captures and replays there. On the CPU
there is no graph: ``run`` computes the stage eagerly, so the engine's
warmed keys and their bookkeeping work the same there.
"""
from __future__ import annotations

import os
import time
from typing import Callable, Dict, Optional, Sequence, Tuple

import torch

from ..ops import adain_moments as am
from ..ops import adain_snake_conv as asc
from ..ops import istft_oa as oa
from ..ops.capture_tally import captured


def add_launches(tally: Dict[str, int], times: int = 1) -> None:
    """Add ``times`` x ``tally`` (``{kernel name: launches}``, as
    ``captured()`` yields it) to the wrappers' launch counts."""
    for name, n in tally.items():
        if name in ("istft_oa", "istft_head_bf16"):
            oa.count_launch(name == "istft_head_bf16", n * times)
        elif name in ("adain_fold", "adain_fold_bf16"):
            am.count_launch(name, n * times)
        else:
            asc.count_launch(name, n * times)


_EXPANDABLE = False  # set once per process


def expandable_segments() -> None:
    """Let the CUDA caching allocator grow a segment in place
    (``expandable_segments``) instead of adding a fixed segment for each
    request that no free block holds, segments that never merge: a stage
    then reserves about its allocated peak, captured into a pool as run
    eagerly (1.07x where fixed segments reserved 1.43x, PERF.md §6). Once
    per process, from the first engine on a card, unless
    ``PYTORCH_CUDA_ALLOC_CONF`` names the option; segments made before
    keep their kind."""
    global _EXPANDABLE
    if _EXPANDABLE:
        return
    _EXPANDABLE = True
    if "expandable_segments" not in os.environ.get("PYTORCH_CUDA_ALLOC_CONF",
                                                   ""):
        torch.cuda.memory._set_allocator_settings("expandable_segments:True")


def allocator_state(device) -> Dict[str, int]:
    """The caching allocator's reserved and allocated bytes and its
    segment count on ``device``, all pools together."""
    stats = torch.cuda.memory_stats(device)
    return {"reserved_bytes": stats.get("reserved_bytes.all.current", 0),
            "allocated_bytes": stats.get("allocated_bytes.all.current", 0),
            "segments": stats.get("segment.all.current", 0)}


class StageGraph:
    """One stage at one serving key: ``fn(*inputs) -> tuple of tensors``
    captured on ``inputs``' shapes and types (``fn`` must take no decision
    on the host from its inputs' values)."""

    def __init__(self, fn: Callable, inputs: Sequence[torch.Tensor],
                 stream: Optional[torch.cuda.Stream] = None,
                 cpu_pass: bool = True):
        """Warm ``fn`` once on ``inputs``: on CUDA on ``stream``, on static
        copies of them, then ``capture``; on the CPU only with ``cpu_pass``
        (a key captured at its first use runs at once anyway)."""
        self.fn = fn
        self.graph = self.outputs = self.static = None
        self.launches: Dict[str, int] = {}
        self.lock_s = 0.0  # seconds the capture held the lock
        self.memory: Dict[str, Dict[str, int]] = {}
        t0 = time.perf_counter()
        if not inputs[0].is_cuda:
            if cpu_pass:
                fn(*inputs)
            self.warm_s = time.perf_counter() - t0
            return
        self.device = device = inputs[0].device
        self.stream = stream
        # every step on the inputs' device (the kernels' C launches and the
        # capture work on the runtime's current one)
        with torch.cuda.device(device):
            self.static = tuple(x.clone() for x in inputs)
            stream.wait_stream(torch.cuda.current_stream(device))
            with torch.cuda.stream(stream):
                fn(*self.static)
            # wait here, not under the lock: the capture begins by
            # synchronizing the device, which would otherwise wait for this
            # pass with the lock
            stream.synchronize()
        self.warm_s = time.perf_counter() - t0

    def release(self) -> None:
        """Drop the graph and its outputs: their blocks go back to the
        pool, which returns to the device once no graph uses it (at the
        next ``torch.cuda.empty_cache``)."""
        self.graph = self.outputs = None

    def capture(self, pool) -> None:
        """Capture the stage into ``pool`` on its static inputs, replacing
        the graph it held (a re-capture into a rebuilt pool): no warm pass
        again, since the first made what a capture may not. Records the
        capture's seconds (``lock_s``), the allocator's state and the
        launch tally. A capture that fails raises. Hold the engine's
        lock. On the CPU there is nothing to capture."""
        if self.static is None:
            return
        self.release()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.device(self.device):
            t0 = time.perf_counter()
            torch.cuda.empty_cache()  # as the capture's start does
            self.memory["before"] = allocator_state(self.device)
            with captured() as tally, torch.cuda.graph(
                    graph, pool=pool, stream=self.stream,
                    capture_error_mode="thread_local"):
                outputs = tuple(self.fn(*self.static))
            self.memory["after"] = allocator_state(self.device)
            self.lock_s = time.perf_counter() - t0
        self.graph, self.outputs, self.launches = graph, outputs, tally

    def run(self, inputs: Sequence[torch.Tensor]) -> Tuple[torch.Tensor, ...]:
        """The stage's outputs for ``inputs``: on CUDA copied into the
        static inputs, replayed and cloned (hold the engine's lock); on the
        CPU computed."""
        if self.graph is None:
            return tuple(self.fn(*inputs))
        with torch.cuda.device(self.device):
            for static, x in zip(self.static, inputs):
                static.copy_(x)
            self.graph.replay()
            add_launches(self.launches)
            return tuple(out.clone() for out in self.outputs)
