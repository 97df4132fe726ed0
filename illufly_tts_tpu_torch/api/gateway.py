# -*- coding: utf-8 -*-
"""HTTP API gateway backed by a remote (or subprocess) MCP TTS server.

The split-deployment front half (reference README.md:53-55: ``python -m
illufly_tts api --server-host=... --server-port=...``): serves the same
routes and JSON schema as api/endpoints.py, but instead of owning a local
engine it forwards every request through an MCP client. The same JWT /
dev-mode auth applies at this edge.
"""
from __future__ import annotations

import logging
from typing import Any, Dict, Optional

from aiohttp import web

from ..client.mcp_client import TTSMcpClient
from .auth import AuthError, authenticate
from .dev_endpoints import add_dev_routes
from .dev_mode import is_dev_mode
from .http_common import is_client_fault as _is_client_fault
from .http_common import json_object as _json_object
from .http_common import parse_pitch as _parse_pitch
from .http_common import parse_speed as _parse_speed

logger = logging.getLogger(__name__)


def _require_user(request: web.Request) -> Dict[str, Any]:
    try:
        return authenticate(request.headers, request.cookies, request.query)
    except AuthError as exc:
        raise web.HTTPUnauthorized(
            reason=exc.detail
        ) if exc.status == 401 else web.HTTPForbidden(reason=exc.detail)


def create_gateway_app(
    server_host: Optional[str] = None,
    server_port: Optional[int] = None,
    process_command: Optional[str] = None,
    process_args: Optional[list] = None,
    prefix: str = "/api",
    client: Optional[TTSMcpClient] = None,
) -> web.Application:
    """aiohttp app forwarding /tts traffic to an MCP server.

    Pass ``server_host``/``server_port`` for a remote SSE server, or
    ``process_command``/``process_args`` to spawn a stdio subprocess
    (both modes the reference documents)."""
    app = web.Application()

    async def startup(app: web.Application) -> None:
        c = client or TTSMcpClient(
            process_command=process_command,
            process_args=process_args,
            host=server_host,
            port=server_port,
        )
        await c.connect()
        app["mcp_client"] = c
        logger.info("gateway connected to MCP server")

    async def cleanup(app: web.Application) -> None:
        c = app.get("mcp_client")
        if c is not None:
            await c.close()

    app.on_startup.append(startup)
    app.on_cleanup.append(cleanup)

    async def text_to_speech(request: web.Request) -> web.Response:
        _require_user(request)
        body = await _json_object(request)
        text = body.get("text")
        if not text:
            raise web.HTTPBadRequest(reason="missing 'text'")
        c: TTSMcpClient = request.app["mcp_client"]
        result = await c.text_to_speech(
            text=text,
            voice=body.get("voice_id", "zf_001"),
            speed=_parse_speed(body),
            pitch=_parse_pitch(body),
        )
        if not isinstance(result, dict):
            raise web.HTTPBadGateway(reason="malformed MCP response")
        if result.get("status") != "success":
            err = result.get("error") or "processing failed"
            # voice problems are client errors; the rest are server-side
            if _is_client_fault(err):
                raise web.HTTPBadRequest(reason=err)
            if result.get("timeout"):
                raise web.HTTPGatewayTimeout(reason=err)
            raise web.HTTPInternalServerError(reason=err)
        return web.json_response(result)

    async def get_voices(request: web.Request) -> web.Response:
        _require_user(request)
        c: TTSMcpClient = request.app["mcp_client"]
        return web.json_response({"voices": await c.list_voices()})

    async def get_info(request: web.Request) -> web.Response:
        _require_user(request)
        c: TTSMcpClient = request.app["mcp_client"]
        info = await c.get_info()
        return web.json_response(info if isinstance(info, dict) else {})

    app.router.add_post(f"{prefix}/tts", text_to_speech)
    app.router.add_get(f"{prefix}/tts/voices", get_voices)
    app.router.add_get(f"{prefix}/tts/info", get_info)
    if is_dev_mode():
        add_dev_routes(app, prefix)
    return app
