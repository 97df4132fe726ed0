"""Everything the harness runs is found by name: a cell in
``perfbench/workloads/<cell>.json``, a configuration in
``perfbench/configs/<name>.json``, a traffic mix in
``perfbench/traffic/<mix>.json`` (read by the generator its ``kind`` names,
``perfbench/harness/traffic.py``), a metric's reader in
``perfbench/metrics/<metric>.py``, and a model family, which a
configuration names, in ``perfbench/families/<family>.py``.
``BENCHMARK.json`` at the root of the checkout says which metrics a cell
reports."""
from __future__ import annotations

import importlib.util
import json
import os
from typing import Dict, List

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)
KINDS = {"workloads": ".json", "configs": ".json", "traffic": ".json",
         "metrics": ".py", "families": ".py"}
_FAMILIES: Dict[str, object] = {}  # path -> module, loaded once a process


def path(kind: str, name: str) -> str:
    return os.path.join(BENCH_DIR, kind, name + KINDS[kind])


def names(kind: str) -> List[str]:
    ext = KINDS[kind]
    return sorted(f[: -len(ext)] for f in os.listdir(os.path.join(BENCH_DIR, kind))
                  if f.endswith(ext) and not f.startswith("_"))


def load_json(kind: str, name: str) -> dict:
    with open(path(kind, name)) as f:
        return json.load(f)


def reader(metric: str):
    """The ``read(run)`` function of ``perfbench/metrics/<metric>.py``."""
    spec = importlib.util.spec_from_file_location(
        f"perfbench_metric_{metric.replace('.', '_').replace('-', '_')}",
        path("metrics", metric))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def family(name: str):
    """The module ``perfbench/families/<name>.py``: the sizes, seeded
    weights, engine, reference, encoder and operation counts of one model
    family (``perfbench/families/kokoro.py`` lists what a family holds)."""
    where = path("families", name)
    module = _FAMILIES.get(where)
    if module is None:
        spec = importlib.util.spec_from_file_location(
            f"perfbench_family_{name.replace('.', '_').replace('-', '_')}",
            where)
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        _FAMILIES[where] = module
    return module


def benchmark(root: str = ROOT) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def metrics_of(cell: str, bench: dict) -> Dict[str, List[dict]]:
    """{"end_to_end": [...], "per_layer": [...]}: the metrics ``cell``
    reports. An end-to-end metric with a ``workloads`` list only in those
    cells, one without in every cell; a per-layer metric in the cells its
    ``workloads`` lists, or, without the list, in every cell that reports
    the end-to-end metric it moves."""
    e2e = [m for m in bench["end_to_end"]
           if "workloads" not in m or cell in m["workloads"]]
    mine = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"]
             if (cell in m["workloads"] if "workloads" in m
                 else m["moves"] in mine)]
    return {"end_to_end": e2e, "per_layer": layer}
