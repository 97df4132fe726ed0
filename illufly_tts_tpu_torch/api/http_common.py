# -*- coding: utf-8 -*-
"""Engine-free HTTP request helpers shared by the local-engine API
(endpoints.py) and the MCP gateway (gateway.py).

Lives in its own module so the gateway — the client-only half of the
split deployment (reference README.md:53-55) — never imports the
scheduler/engine stack (and therefore torch) just to parse a request body.
"""
from __future__ import annotations

from typing import Any, Dict

from aiohttp import web


async def json_object(request: web.Request) -> Dict[str, Any]:
    """Parse the request body as a JSON OBJECT or raise 400 (a bare
    string/array is valid JSON and would otherwise 500 on .get)."""
    try:
        body = await request.json()
    except Exception:
        raise web.HTTPBadRequest(reason="invalid JSON body")
    if not isinstance(body, dict):
        raise web.HTTPBadRequest(reason="JSON body must be an object")
    return body


def parse_speed(body: Dict[str, Any]) -> float:
    try:
        return float(body.get("speed", 1.0))
    except (TypeError, ValueError):
        raise web.HTTPBadRequest(reason="'speed' must be a number")


def parse_pitch(body: Dict[str, Any]) -> float:
    try:
        return float(body.get("pitch", 1.0))
    except (TypeError, ValueError):
        raise web.HTTPBadRequest(reason="'pitch' must be a number")


def is_client_fault(err: str) -> bool:
    """Classify a pipeline/scheduler error message as caller-fault (4xx)
    vs server-fault (5xx). One place so every surface (aiohttp, gateway,
    FastAPI shim) agrees: unknown voices and out-of-range speed/pitch
    are the caller's doing; device/compile/batch errors are not.

    Speed/pitch match the EXACT submit-time validation messages — a bare
    'speed'/'pitch' substring would reclassify server-side batch errors
    that merely mention the operand (e.g. 'speeds length mismatch')."""
    low = (err or "").lower()
    return (
        "voice" in low
        or "pitch must be within" in low
        or "pitch is not supported" in low
        or "speed must be within" in low
    )
