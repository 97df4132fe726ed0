# -*- coding: utf-8 -*-
"""PyTorch port: the MCP split deployment (``mcp/``, ``client/``,
``api/gateway.py``, ``api/mcp_server.py``).

Every case of ``tests/test_mcp.py`` runs again with the port's protocol,
``MCPServer``, ``FakeBackend`` and ``TOOLS`` in that file's globals, the
port's client, gateway and auth behind the imports its cases make inside
their bodies, and the stdio subprocess started as
``python -m illufly_tts_tpu_torch.api.mcp_server`` (``TTS_FAKE_BACKEND=1``,
as there: no model is built). Then the port's ``ManagerBackend`` over the
port's pipeline answers a tool call with the device the engine runs on."""
import base64
import sys

import pytest
import torch

from illufly_tts_tpu_torch.mcp import protocol as port_protocol
from illufly_tts_tpu_torch.mcp import server as port_server
from illufly_tts_tpu_torch.pipeline import CachedTTSPipeline
from tests import test_mcp as jax_cases
from tests import torch_port_cases as port_cases

torch.set_num_threads(2)

CASES = port_cases.collect(jax_cases)

PORT_MODULES = {
    f"illufly_tts_tpu.{name}": f"illufly_tts_tpu_torch.{name}"
    for name in ("client.mcp_client", "api.gateway", "api.auth")
}


def _port_server_cmdline():
    return sys.executable, [
        "-m", "illufly_tts_tpu_torch.api.mcp_server", "--transport", "stdio",
    ]


def test_all_mcp_cases_collected():
    assert len(CASES) == 10, sorted(CASES)


@pytest.mark.parametrize("case", sorted(CASES))
def test_mcp_case_on_the_port(case, monkeypatch, tmp_path):
    monkeypatch.setattr(jax_cases, "p", port_protocol)
    port_cases.use_port_globals(monkeypatch, jax_cases, port_server,
                                ("FakeBackend", "MCPServer", "TOOLS"))
    monkeypatch.setattr(jax_cases, "_fake_server_cmdline",
                        _port_server_cmdline)
    port_cases.use_port_modules(monkeypatch, PORT_MODULES)
    port_cases.run(jax_cases, CASES[case], monkeypatch=monkeypatch,
                   tmp_path=tmp_path)


async def test_manager_backend_on_the_port_pipeline(tmp_path, monkeypatch):
    """``ManagerBackend(pipeline=...)``: a text_to_speech tool call renders
    a WAV through the port's scheduler and engine, and get_info names the
    engine's device."""
    from tests.test_torch_params import port_config

    from illufly_tts_tpu_torch.engine.synthesizer import Synthesizer

    monkeypatch.delenv("TTS_WARMUP", raising=False)
    synth = Synthesizer(port_config(), seed=5, device="cpu",
                        token_buckets=(64,), frame_buckets=(128,),
                        batch_buckets=(1, 4))
    backend = port_server.ManagerBackend(
        pipeline=CachedTTSPipeline(synthesizer=synth),
        output_dir=str(tmp_path), max_wait_time=0.02)
    server = port_server.MCPServer(backend)
    try:
        reply = await server.handle_message(port_protocol.request(
            1, "tools/call", {"name": "text_to_speech",
                              "arguments": {"text": "你好。"}}))
        result = port_protocol.parse_content_text(reply["result"])
        assert result["status"] == "success", result
        assert base64.b64decode(result["audio_base64"])[:4] == b"RIFF"
        reply = await server.handle_message(port_protocol.request(
            2, "tools/call", {"name": "get_info", "arguments": {}}))
        info = port_protocol.parse_content_text(reply["result"])
        assert info["device"] == "cpu"
    finally:
        await backend.stop()
