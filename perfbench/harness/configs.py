"""A configuration file (``perfbench/configs/<name>.json``): its model
family, named by its ``"family"`` key (``perfbench/families/<family>.py``),
and the model's sizes, which that family reads from the file."""
from __future__ import annotations

import json

from . import registry


def _read(name: str) -> dict:
    with open(registry.path("configs", name)) as f:
        raw = json.load(f)
    if "family" not in raw:
        raise ValueError(f"configuration {name!r} names no 'family'")
    return raw


def family_name(name: str) -> str:
    return _read(name)["family"]


def family(name: str):
    """The family module of configuration ``name``."""
    return registry.family(family_name(name))


def load(name: str) -> dict:
    """Configuration ``name`` as its family's sizes."""
    raw = _read(name)
    return registry.family(raw["family"]).sizes(raw)
