# -*- coding: utf-8 -*-
"""PyTorch port: the client-only half of the split deployment imports
neither torch nor jax.

Both cases of ``tests/test_client_only_imports.py`` run again with their
subprocess bodies naming the port's modules and the blocker refusing
``torch`` besides the jax stack: the port's MCP client and gateway import
with numpy blocked too, and the FastAPI shim's remote mode imports against
that file's stub fastapi."""
import pytest

from tests import test_client_only_imports as jax_cases
from tests import torch_port_cases as port_cases

CASES = port_cases.collect(jax_cases)
_jax_run = jax_cases._run


def _run_on_the_port(prelude: str, body: str):
    assert "BLOCKED = (" in prelude
    prelude = prelude.replace("BLOCKED = (", 'BLOCKED = ("torch", ', 1)
    return _jax_run(prelude,
                    body.replace("illufly_tts_tpu.", "illufly_tts_tpu_torch."))


def test_all_client_only_cases_collected():
    assert len(CASES) == 2, sorted(CASES)


@pytest.mark.parametrize("case", sorted(CASES))
def test_client_only_case_on_the_port(case, monkeypatch):
    monkeypatch.setattr(jax_cases, "_run", _run_on_the_port)
    port_cases.run(jax_cases, CASES[case], monkeypatch=monkeypatch)


def test_blocker_refuses_torch():
    proc = _run_on_the_port(
        jax_cases._blocker('("jax",)'),
        "import torch\n",
    )
    assert proc.returncode != 0
    assert "BLOCKED" in proc.stderr


def test_router_imports_without_torch():
    """The replica router, like the gateway, runs on a host without the
    engine stack: it imports with torch, the jax stack and numpy blocked."""
    proc = _run_on_the_port(
        jax_cases._blocker('("jax", "jaxlib", "flax", "numpy")'),
        "from illufly_tts_tpu.api.router import create_router_app\n"
        "app = create_router_app(['http://h:1'])\n"
        "print('ROUTER OK')\n",
    )
    assert proc.returncode == 0, proc.stderr
    assert "ROUTER OK" in proc.stdout
