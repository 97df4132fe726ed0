# -*- coding: utf-8 -*-
"""PyTorch port: the FastAPI mount shim (``api/fastapi_compat.py``).

Every case of ``tests/test_fastapi_compat.py`` runs again on the port's
shim, imported fresh against that file's stub ``fastapi``, with the port's
MCP client module behind the import its cases patch. Then the engine half:
the local mode's info route reports the running engine's device."""
import importlib
import sys
import types

import pytest
import torch

from tests import test_fastapi_compat as jax_cases
from tests import torch_port_cases as port_cases

torch.set_num_threads(2)

CASES = port_cases.collect(jax_cases)
SHIM = "illufly_tts_tpu_torch.api.fastapi_compat"


@pytest.fixture()
def port_compat(monkeypatch):
    """The port's shim, imported freshly against the stub fastapi."""
    stub = types.ModuleType("fastapi")
    stub.FastAPI = jax_cases._App
    stub.APIRouter = jax_cases._Router
    stub.HTTPException = jax_cases._HTTPException
    stub.Request = jax_cases._Request
    monkeypatch.setitem(sys.modules, "fastapi", stub)
    sys.modules.pop(SHIM, None)
    yield importlib.import_module(SHIM)
    sys.modules.pop(SHIM, None)


def test_all_fastapi_compat_cases_collected():
    assert len(CASES) == 4, sorted(CASES)


@pytest.mark.parametrize("case", sorted(CASES))
def test_fastapi_compat_case_on_the_port(case, port_compat, monkeypatch):
    port_cases.use_port_modules(monkeypatch, {
        "illufly_tts_tpu.client.mcp_client":
            "illufly_tts_tpu_torch.client.mcp_client",
    })
    port_cases.run(jax_cases, CASES[case], compat=port_compat,
                   monkeypatch=monkeypatch)


async def test_local_mode_info_reports_engine_device(port_compat,
                                                     monkeypatch):
    """Local mode builds the scheduler in-process; its info route names
    the engine's device, not a fixed string."""
    from illufly_tts_tpu_torch.runtime import scheduler

    class Engine:
        device = torch.device("cpu")

        def is_voice_loaded(self, voice_id):
            return True

    class Manager:
        def __init__(self, **kwargs):
            self.pipeline = types.SimpleNamespace(synthesizer=Engine())

        async def start(self):
            pass

        async def shutdown(self):
            pass

    monkeypatch.setattr(scheduler, "TTSServiceManager", Manager)
    app = port_compat.FastAPI()
    port_compat.mount_tts_service(app, require_user=lambda: {"user_id": "u"})
    for hook in app.events["startup"]:
        await hook()
    info = await app.routes[("GET", "/api/tts/info")](jax_cases._Request())
    assert info["device"] == "cpu"
    for hook in app.events["shutdown"]:
        await hook()
