# -*- coding: utf-8 -*-
"""Re-run the JAX package's test cases against the PyTorch port's modules.

A JAX suite names its modules at import (``from illufly_tts_tpu.api.endpoints
import create_app``) and, in some cases, inside the test body. ``collect``
lists a suite's cases, one id per parametrized combination (``slow`` cases
left out, as Tier-1 leaves them out, unless ``include_slow``: a case that
is slow for its JAX compiles can be cheap on the port); ``use_port_globals``
swaps the port's objects into the suite's module globals and
``use_port_modules`` the port's modules into ``sys.modules`` (and onto the
JAX parent package), so the function-local imports find them too;
``use_port_engine`` does both for the engine, pipeline and scheduler, with
the port's ``Synthesizer`` on the CPU and ``tiny_config`` giving the port's
config; ``run`` calls one case, async or not, with the fixtures it asks
for. Everything is undone by ``monkeypatch``."""
from __future__ import annotations

import asyncio
import importlib
import inspect
import itertools
import sys
from typing import Dict, List, Tuple


def _expand(qualname: str, fn,
            include_slow: bool = False) -> List[Tuple[str, Tuple[str, dict]]]:
    marks = getattr(fn, "pytestmark", [])
    if not include_slow and any(m.name == "slow" for m in marks):
        return []
    grids = []
    for m in marks:
        if m.name != "parametrize":
            continue
        names, values = m.args[0], m.args[1]
        if isinstance(names, str):
            names = [n.strip() for n in names.split(",")]
        rows = [v if len(names) > 1 else (v,) for v in values]
        grids.append([dict(zip(names, row)) for row in rows])
    if not grids:
        return [(qualname, (qualname, {}))]
    out = []
    for combo in itertools.product(*grids):
        params = {k: v for d in combo for k, v in d.items()}
        tag = "-".join(str(v) for v in params.values())
        out.append((f"{qualname}[{tag}]", (qualname, params)))
    return out


def collect(module, exclude=(), include_slow=False
            ) -> Dict[str, Tuple[str, dict]]:
    """Case id -> (qualified name, parameters) for every test function and
    ``Test*`` class method defined in ``module``, minus ``exclude`` (bare
    function or method names)."""
    cases: Dict[str, Tuple[str, dict]] = {}
    for name, obj in vars(module).items():
        if (name.startswith("test_") and inspect.isfunction(obj)
                and obj.__module__ == module.__name__):
            if name not in exclude:
                cases.update(_expand(name, obj, include_slow))
        elif name.startswith("Test") and inspect.isclass(obj):
            for mname, meth in vars(obj).items():
                if (mname.startswith("test_") and inspect.isfunction(meth)
                        and mname not in exclude):
                    cases.update(_expand(f"{name}::{mname}", meth,
                                         include_slow))
    return cases


def use_port_globals(monkeypatch, module, port, names) -> None:
    for name in names:
        monkeypatch.setattr(module, name, getattr(port, name))


def use_port_modules(monkeypatch, mapping: Dict[str, str]) -> None:
    """``{JAX module name: port module name}``: imports of the JAX name
    inside a test body resolve to the port's module."""
    for jax_name, port_name in mapping.items():
        port = importlib.import_module(port_name)
        parent, _, child = jax_name.rpartition(".")
        importlib.import_module(parent)
        monkeypatch.setitem(sys.modules, jax_name, port)
        monkeypatch.setattr(sys.modules[parent], child, port, raising=False)


PORT_ENGINE_MODULES = {
    f"illufly_tts_tpu.{name}": f"illufly_tts_tpu_torch.{name}"
    for name in ("engine.synthesizer", "pipeline", "runtime.scheduler")
}


def cpu_synthesizer():
    """The port's ``Synthesizer`` with ``device="cpu"`` by default (the
    JAX suites construct it without a device)."""
    from illufly_tts_tpu_torch.engine.synthesizer import Synthesizer

    class CpuSynthesizer(Synthesizer):
        def __init__(self, *args, device="cpu", **kwargs):
            super().__init__(*args, device=device, **kwargs)

    return CpuSynthesizer


def use_port_engine(monkeypatch, module=None, names=(), extra=None) -> None:
    """The port's engine, pipeline and scheduler (and ``extra`` modules,
    ``{JAX name: port name}``) behind the JAX names; the port's
    ``Synthesizer`` defaults to the CPU; ``tests.test_model.tiny_config``
    gives the port's config of the same dimensions. ``names`` of the
    suite ``module``'s globals are swapped for the port's objects of the
    same name (``Synthesizer``, ``tiny_config`` and the pipeline and
    scheduler classes)."""
    import tests.test_model
    from illufly_tts_tpu_torch import pipeline
    from illufly_tts_tpu_torch.engine import synthesizer
    from illufly_tts_tpu_torch.runtime import scheduler
    from tests.test_torch_params import port_config

    cpu = cpu_synthesizer()
    monkeypatch.setattr(synthesizer, "Synthesizer", cpu)
    monkeypatch.setattr(tests.test_model, "tiny_config", port_config)
    use_port_modules(monkeypatch, {**PORT_ENGINE_MODULES, **(extra or {})})
    port = {"Synthesizer": cpu, "tiny_config": port_config,
            "TTSPipeline": pipeline.TTSPipeline,
            "CachedTTSPipeline": pipeline.CachedTTSPipeline,
            "TTSServiceManager": scheduler.TTSServiceManager}
    for name in names:
        monkeypatch.setattr(module, name, port[name])


def run(module, case: Tuple[str, dict], **fixtures) -> None:
    """Call one collected case with the fixtures its signature names."""
    qualname, params = case
    owner, _, name = qualname.rpartition("::")
    fn = (getattr(getattr(module, owner)(), name) if owner
          else getattr(module, name))
    wanted = inspect.signature(fn).parameters
    kwargs = {k: v for k, v in {**fixtures, **params}.items() if k in wanted}
    result = fn(**kwargs)
    if inspect.iscoroutine(result):
        loop = asyncio.new_event_loop()
        try:
            loop.run_until_complete(result)
        finally:
            loop.close()
