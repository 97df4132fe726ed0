# -*- coding: utf-8 -*-
"""Kernel launches made while a CUDA graph is captured.

The kernel wrappers count each launch when Python calls them
(``count_launch`` in ``ops/istft_oa.py``, ``ops/adain_snake_conv.py`` and
``ops/adain_moments.py``).
A capture runs the wrappers but executes no kernel, and a replay executes
the kernels but runs no Python. So while this thread captures
(``captured()``), its wrappers' counts go into the capture's own tally
instead of the shared counters; the engine adds that tally to the counters
on every replay (``engine/graphs.py``). Counts from other threads, which
may launch eagerly during a capture, are not affected.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Dict, Iterator

_local = threading.local()


@contextlib.contextmanager
def captured() -> Iterator[Dict[str, int]]:
    """Route this thread's launch counts into the yielded tally
    ``{kernel name: launches}`` until the block ends."""
    tally: Dict[str, int] = {}
    _local.tally = tally
    try:
        yield tally
    finally:
        _local.tally = None


def tallied(name: str, n: int) -> bool:
    """Add ``n`` launches of ``name`` to this thread's capture tally, if it
    is capturing; -> whether it was."""
    tally = getattr(_local, "tally", None)
    if tally is None:
        return False
    tally[name] = tally.get(name, 0) + n
    return True
