# -*- coding: utf-8 -*-
"""PyTorch port: the HTTP surface (``api/endpoints.py``, JWT, dev mode).

Every case of ``tests/test_api.py`` runs again with the port's
``create_app``, ``create_access_token``, ``get_jwt_secret_key`` and
``jwt_hs256`` in that file's globals, and the port's modules behind the
imports its cases make inside their bodies. Then one zh text goes over
HTTP through the JAX ``create_app`` on the JAX ``CachedTTSPipeline`` and
through the port's on the port's, on the same parameters, as WAV and as
FLAC: the decoded audio agrees within the golden gate (rms/scale < 5e-3)
and the JSON envelopes carry the same keys, ``sample_rate`` and
``format``. The info route reports the engine's device."""
import base64
import os

import numpy as np
import pytest
import torch
from aiohttp.test_utils import TestClient, TestServer

from illufly_tts_tpu.api.auth import create_access_token as jax_token
from illufly_tts_tpu.api.endpoints import create_app as jax_create_app
from illufly_tts_tpu_torch.api import auth as port_auth
from illufly_tts_tpu_torch.api import endpoints as port_endpoints
from illufly_tts_tpu_torch.api import jwt_hs256 as port_jwt
from illufly_tts_tpu_torch.audio.flac import decode_flac
from illufly_tts_tpu_torch.audio.wav import decode_wav
from tests import test_api as jax_cases
from tests import torch_port_cases as port_cases
from tests.test_torch_pipeline import ZH, _close, pipes  # noqa: F401

torch.set_num_threads(2)

CASES = port_cases.collect(jax_cases)

PORT_MODULES = {
    f"illufly_tts_tpu.{name}": f"illufly_tts_tpu_torch.{name}"
    for name in ("api.auth", "api.dev_mode", "api.endpoints", "api.jwt_hs256",
                 "audio.wav", "audio.flac")
}


def test_all_api_cases_collected():
    assert len(CASES) == 37, sorted(CASES)


@pytest.mark.parametrize("case", sorted(CASES))
def test_api_case_on_the_port(case, monkeypatch, tmp_path):
    monkeypatch.setattr(jax_cases, "jwt", port_jwt)
    port_cases.use_port_globals(monkeypatch, jax_cases, port_auth,
                                ("create_access_token", "get_jwt_secret_key"))
    port_cases.use_port_globals(monkeypatch, jax_cases, port_endpoints,
                                ("create_app",))
    port_cases.use_port_modules(monkeypatch, PORT_MODULES)
    port_cases.run(jax_cases, CASES[case], monkeypatch=monkeypatch,
                   tmp_path=tmp_path)


async def _post_both(app, token, text):
    client = TestClient(TestServer(app))
    await client.start_server()
    try:
        out = {}
        for fmt in ("wav", "flac"):
            resp = await client.post(
                "/api/tts", json={"text": text, "voice_id": "v",
                                  "format": fmt},
                headers={"Authorization": f"Bearer {token}"})
            assert resp.status == 200, await resp.text()
            out[fmt] = await resp.json()
        resp = await client.get(
            "/api/tts/info", headers={"Authorization": f"Bearer {token}"})
        assert resp.status == 200
        out["info"] = await resp.json()
        return out
    finally:
        await client.close()


async def test_http_end_to_end_matches_jax(pipes, tmp_path,  # noqa: F811
                                           monkeypatch):
    """The same zh text POSTed to both servers, each over its own package's
    pipeline on shared parameters, as WAV and as FLAC."""
    monkeypatch.delenv("TTS_DEV_MODE", raising=False)
    monkeypatch.setenv("FASTAPI_SECRET_KEY", "e2e-secret")
    jax_pipe, port_pipe = pipes
    got = {}
    for name, make, token, pipe in (
            ("jax", jax_create_app, jax_token("u"), jax_pipe),
            ("port", port_endpoints.create_app,
             port_auth.create_access_token("u"), port_pipe)):
        app = make(output_dir=str(tmp_path / name), pipeline=pipe,
                   max_wait_time=0.02, register_default_voice=False)
        got[name] = await _post_both(app, token, ZH)
    for fmt in ("wav", "flac"):
        jax_body, port_body = got["jax"][fmt], got["port"][fmt]
        assert set(port_body) == set(jax_body)
        for key in ("status", "sample_rate", "format"):
            assert port_body[key] == jax_body[key], key
    audio = {}
    for name in ("jax", "port"):
        wav = base64.b64decode(got[name]["wav"]["audio_base64"])
        _, rate = decode_wav(wav)
        pcm = np.frombuffer(wav[44:], "<i2")
        flac, flac_rate = decode_flac(base64.b64decode(
            got[name]["flac"]["audio_base64"]))
        assert rate == flac_rate == 24000
        # FLAC is lossless: the same samples as the WAV body
        assert np.array_equal(flac, pcm)
        audio[name] = pcm
    _close(audio["port"], audio["jax"])
    assert got["port"]["info"]["device"] == "cpu"


async def test_info_reports_requested_device_before_the_engine(tmp_path):
    """Before startup builds the engine, the configured device shows: the
    one asked for, or cuda."""
    assert port_endpoints.create_app(
        output_dir=str(tmp_path))["config"]["device"] == "cuda"
    assert port_endpoints.create_app(
        output_dir=str(tmp_path), device="cpu")["config"]["device"] == "cpu"


async def test_create_app_without_cuda_raises(tmp_path, monkeypatch):
    """No silent CPU fallback: with no CUDA device and no device='cpu', the
    app's startup raises as the engine does."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    app = port_endpoints.create_app(output_dir=str(tmp_path))
    client = TestClient(TestServer(app))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        await client.start_server()
    await client.close()


async def test_warmup_knob_warns_without_engine_warmup(tmp_path, monkeypatch,
                                                       caplog):
    """TTS_WARMUP on a pipeline whose synthesizer has no ``warmup`` logs
    that the knob does nothing for it, and the server still starts."""
    monkeypatch.setenv("TTS_WARMUP", "1")
    monkeypatch.setenv("FASTAPI_SECRET_KEY", "test-secret")
    app = port_endpoints.create_app(output_dir=str(tmp_path),
                                    pipeline=jax_cases.FakePipeline(),
                                    max_wait_time=0.02)
    client = TestClient(TestServer(app))
    with caplog.at_level("WARNING", logger=port_endpoints.logger.name):
        await client.start_server()
    await client.close()
    assert any("has no warmup: the knob does nothing" in r.getMessage()
               for r in caplog.records)


def test_port_env_and_prometheus_helpers(tmp_path, monkeypatch):
    """The copies of ``utils/env.py`` and ``utils/prometheus.py`` behave as
    the JAX package's on the same input."""
    from illufly_tts_tpu.utils import env as jax_env
    from illufly_tts_tpu.utils.prometheus import render_prometheus as jax_r
    from illufly_tts_tpu_torch.utils import env as port_env
    from illufly_tts_tpu_torch.utils.prometheus import render_prometheus

    path = tmp_path / ".env"
    path.write_text("# c\nA_PORT_KEY='1'\nB_PORT_KEY = two\nnoeq\n")
    for key in ("A_PORT_KEY", "B_PORT_KEY"):
        monkeypatch.delenv(key, raising=False)
    assert port_env.load_dotenv(str(path)) == 2
    assert os.environ["A_PORT_KEY"] == "1"
    assert os.environ["B_PORT_KEY"] == "two"
    assert jax_env.load_dotenv(str(path)) == 0  # already set
    stats = {"submitted": 3, "completed": 2, "pending": 1,
             "throughput_x_realtime": float("inf"),
             "cache": {"audio_hits": 1, "audio_misses": 2,
                       "audio_hit_rate": 1 / 3},
             "stage_timers": {"model": {"total_s": 0.5, "count": 2,
                                        "ewma_s": 0.25}}}
    assert render_prometheus(stats) == jax_r(stats)
