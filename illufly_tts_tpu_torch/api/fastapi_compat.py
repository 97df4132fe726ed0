# -*- coding: utf-8 -*-
"""FastAPI mount shim — preserves the reference's integration surface
(``mount_tts_service(app, ...)``, reference src/illufly_tts/api/endpoints.py:43)
for hosts that run FastAPI. Import requires fastapi to be installed."""
from __future__ import annotations

import asyncio
import logging
import os
import tempfile
from typing import Optional

from fastapi import APIRouter, FastAPI, HTTPException, Request
from pydantic import BaseModel

from .auth import AuthError, authenticate
from .http_common import is_client_fault
from .dev_mode import generate_dev_token, is_dev_mode

# NB: the engine stack (runtime.scheduler -> pipeline -> torch) is imported
# lazily inside the LOCAL-mode startup/handlers only — in remote proxy
# mode this shim must import on a web host that has just fastapi+aiohttp
# (the split deployment this mode exists for).

logger = logging.getLogger(__name__)


class TextToSpeechRequest(BaseModel):
    text: str
    voice_id: str = "zf_001"
    speed: float = 1.0
    pitch: float = 1.0
    # float like the scheduler's TTSTask.sequence_id (time.time()-style
    # ids must not 422 here when the aiohttp mount accepts them)
    sequence_id: Optional[float] = None
    cancel_pending: bool = False


def _user_of(request: Request):
    try:
        return authenticate(
            dict(request.headers), dict(request.cookies),
            dict(request.query_params),
        )
    except AuthError as exc:
        raise HTTPException(status_code=exc.status, detail=exc.detail)


async def _call_user_hook(require_user):
    """Run a host-supplied auth callable (reference README.md:75-80: a
    zero-arg async ``get_current_user``). Sync callables and plain dicts
    returned from them are accepted too."""
    result = require_user()
    if asyncio.iscoroutine(result):
        result = await result
    return result or {}


def mount_tts_service(
    app: FastAPI,
    repo_id: str = "",
    voices_dir: Optional[str] = None,
    device: Optional[str] = None,
    batch_size: int = 4,
    max_wait_time: float = 0.2,
    chunk_size: int = 200,
    output_dir: Optional[str] = None,
    prefix: str = "/api",
    require_user=None,
    host: Optional[str] = None,
    port: Optional[int] = None,
    process_command: Optional[str] = None,
    process_args: Optional[list] = None,
) -> None:
    """Mount the TTS routes on a host FastAPI app.

    Two modes, matching the reference README's integration example
    (README.md:67-89):

    - **local engine** (default): constructs a ``TTSServiceManager``
      owning the engine in-process (on CUDA unless ``device="cpu"``).
    - **remote proxy**: pass ``host``/``port`` (SSE) or
      ``process_command``/``process_args`` (stdio subprocess) and the
      routes forward to that MCP TTS server instead — the split
      deployment where the GPU box runs ``python -m illufly_tts_tpu_torch
      server`` and the web app mounts only this shim.

    ``require_user`` overrides the built-in JWT/dev-mode auth with the
    host app's own logic: any callable (sync or async, zero-arg)
    returning a user dict with ``user_id``.
    """
    router = APIRouter()
    remote = bool(host or port or process_command)
    if not output_dir:
        output_dir = os.path.join(tempfile.gettempdir(), "illufly_tts_output")
        os.makedirs(output_dir, exist_ok=True)

    async def resolve_user(request: Request):
        if require_user is not None:
            return await _call_user_hook(require_user)
        return _user_of(request)

    @app.on_event("startup")
    async def startup():
        if remote:
            from ..client.mcp_client import TTSMcpClient

            client = TTSMcpClient(
                process_command=process_command, process_args=process_args,
                host=host, port=port,
            )
            await client.connect()
            app.state.mcp_client = client
            return
        from ..runtime.scheduler import TTSServiceManager

        app.state.service_manager = TTSServiceManager(
            repo_id=repo_id, voices_dir=voices_dir, device=device,
            batch_size=batch_size, max_wait_time=max_wait_time,
            chunk_size=chunk_size, output_dir=output_dir,
        )
        synth = app.state.service_manager.pipeline.synthesizer
        if not synth.is_voice_loaded("zf_001"):
            synth.register_random_voice("zf_001", seed=42)
        await app.state.service_manager.start()

    async def _proxy_tts(body: TextToSpeechRequest):
        result = await app.state.mcp_client.text_to_speech(
            text=body.text, voice=body.voice_id, speed=body.speed,
            pitch=body.pitch,
        )
        if not isinstance(result, dict):
            raise HTTPException(status_code=502,
                                detail="malformed MCP response")
        if result.get("status") not in (None, "success"):
            err = result.get("error") or "processing failed"
            code = (400 if is_client_fault(err)
                    else 504 if result.get("timeout") else 500)
            raise HTTPException(status_code=code, detail=err)
        return result

    @router.post("/tts")
    async def text_to_speech(body: TextToSpeechRequest, request: Request):
        user = await resolve_user(request)
        if remote:
            return await _proxy_tts(body)
        from .endpoints import _process_tts_request

        manager = app.state.service_manager
        user_id = user.get("user_id")
        if body.cancel_pending and user_id:
            await manager.cancel_user_pending_tasks(user_id)
        try:
            result = await _process_tts_request(
                manager, body.text, body.voice_id, user_id,
                body.sequence_id, body.speed, pitch=body.pitch,
            )
        except ValueError as exc:  # submit-time range/capability checks
            raise HTTPException(status_code=400, detail=str(exc))
        if result["status"] == "error":
            err = result["error"] or "synthesis failed"
            # voice problems are the caller's fault; device/batch errors
            # are server faults and must be 5xx (see endpoints.py)
            code = (400 if is_client_fault(err)
                    else 504 if result.get("timeout") else 500)
            raise HTTPException(status_code=code, detail=err)
        return result

    @router.get("/tts/voices")
    async def get_voices(request: Request):
        await resolve_user(request)
        if remote:
            return {"voices": await app.state.mcp_client.list_voices()}
        names = app.state.service_manager.pipeline.list_voices() or ["zf_001"]
        return {"voices": [
            {"id": n, "name": n, "description": f"voice {n}"}
            for n in names if not n.startswith("__")
        ]}

    @router.get("/tts/info")
    async def get_info(request: Request):
        await resolve_user(request)
        if remote:
            info = await app.state.mcp_client.get_info()
            return info if isinstance(info, dict) else {}
        engine = app.state.service_manager.pipeline.synthesizer
        engine_device = getattr(engine, "device", None)
        return {
            "service": "illufly-tts-tpu-service",
            "version": "0.1.0",
            "model": repo_id or "kokoro-82M-class (random init)",
            # the running engine's device, else the one asked for
            "device": (str(engine_device) if engine_device is not None
                       else device or "cuda"),
            "batch_size": batch_size,
            "max_wait_time": max_wait_time,
            "chunk_size": chunk_size,
        }

    app.include_router(router, prefix=prefix)

    if is_dev_mode():
        dev = APIRouter()

        @dev.post("/dev/token")
        async def dev_token(body: dict = None):
            body = body or {}
            user_id = body.get("user_id", "dev_user")
            minutes = int(body.get("expire_minutes", 60 * 24))
            return {
                "access_token": generate_dev_token(user_id, minutes),
                "token_type": "bearer",
                "user_id": user_id,
                "expires_in": minutes * 60,
            }

        @dev.get("/dev/status")
        async def dev_status():
            return {"dev_mode": True}

        app.include_router(dev, prefix=prefix)

    @app.on_event("shutdown")
    async def shutdown():
        if hasattr(app.state, "service_manager"):
            await app.state.service_manager.shutdown()
        if hasattr(app.state, "mcp_client"):
            await app.state.mcp_client.close()
