# -*- coding: utf-8 -*-
"""PyTorch port: the multi-replica router (``api/router.py``).

Every case of ``tests/test_router.py`` (rendezvous hashing, sticky routing
and failover, 503 with no replica, the OpenAI route) runs again with the
port's ``Backend``, ``_hrw_pick`` and ``create_router_app`` in that file's
globals."""
import pytest

from illufly_tts_tpu_torch.api import router as port_router
from tests import test_router as jax_cases
from tests import torch_port_cases as port_cases

CASES = port_cases.collect(jax_cases)


def test_all_router_cases_collected():
    assert len(CASES) == 4, sorted(CASES)


@pytest.mark.parametrize("case", sorted(CASES))
def test_router_case_on_the_port(case, monkeypatch):
    port_cases.use_port_globals(monkeypatch, jax_cases, port_router,
                                ("Backend", "_hrw_pick", "create_router_app"))
    port_cases.run(jax_cases, CASES[case], monkeypatch=monkeypatch)
