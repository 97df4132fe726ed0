# -*- coding: utf-8 -*-
"""Checkpoint/resume for training state (parameters + optimizer + step):
the PyTorch port of ``illufly_tts_tpu/training/checkpoint.py``.

The JAX package writes an orbax checkpoint per step; orbax is not on the
card's machine, so the port writes ``torch.save({"params", "opt_state",
"step"})`` (``params``: the module's ``state_dict``; ``opt_state``: the
optimizer's) to ``state.pt`` in the same ``step_%08d`` directories. The
file is written under a temporary name and renamed, so a reader never sees
half of one. Inference weights use the lighter flax msgpack
(``engine/synthesizer.py::save_params``)."""
from __future__ import annotations

import logging
import os
from typing import Optional

import torch

logger = logging.getLogger(__name__)

STATE_FILE = "state.pt"


def save_train_state(directory: str, step: int, model: torch.nn.Module,
                     optimizer: torch.optim.Optimizer) -> str:
    path = os.path.abspath(os.path.join(directory, f"step_{step:08d}"))
    os.makedirs(path, exist_ok=True)
    target = os.path.join(path, STATE_FILE)
    torch.save({"params": model.state_dict(),
                "opt_state": optimizer.state_dict(), "step": step},
               target + ".tmp")
    os.replace(target + ".tmp", target)
    logger.info("saved train state at step %d -> %s", step, path)
    return path


def latest_checkpoint(directory: str) -> Optional[str]:
    if not os.path.isdir(directory):
        return None
    steps = sorted(d for d in os.listdir(directory) if d.startswith("step_")
                   and os.path.exists(os.path.join(directory, d, STATE_FILE)))
    return os.path.join(directory, steps[-1]) if steps else None


def restore_train_state(path: str, model: torch.nn.Module,
                        optimizer: torch.optim.Optimizer) -> int:
    """Load the state saved under ``path`` into ``model`` and ``optimizer``
    (onto their devices) -> its step."""
    state = torch.load(os.path.join(path, STATE_FILE), map_location="cpu",
                       weights_only=True)
    model.load_state_dict(state["params"])
    optimizer.load_state_dict(state["opt_state"])
    return int(state["step"])
