# -*- coding: utf-8 -*-
"""Dev-mode endpoints: token minting + status
(capability parity with reference src/illufly_tts/api/dev_endpoints.py:20-66).
"""
from __future__ import annotations

import os

from aiohttp import web

from .dev_mode import generate_dev_token, get_dev_secret_key, is_dev_mode


def add_dev_routes(app: web.Application, prefix: str = "/api") -> None:
    async def dev_token(request: web.Request) -> web.Response:
        if not is_dev_mode():
            raise web.HTTPForbidden(reason="dev mode disabled")
        try:
            body = await request.json()
        except Exception:
            body = {}
        user_id = body.get("user_id", "dev_user")
        expire_minutes = int(body.get("expire_minutes", 60 * 24))
        token = generate_dev_token(user_id, expire_minutes)
        return web.json_response({
            "access_token": token,
            "token_type": "bearer",
            "user_id": user_id,
            "expires_in": expire_minutes * 60,
        })

    async def dev_status(request: web.Request) -> web.Response:
        return web.json_response({
            "dev_mode": is_dev_mode(),
            "dev_secret_configured": bool(
                os.environ.get("TTS_DEV_SECRET_KEY")
            ),
            "default_secret_in_use": get_dev_secret_key()
            == "tts-dev-secret-key",
        })

    app.router.add_post(f"{prefix}/dev/token", dev_token)
    app.router.add_get(f"{prefix}/dev/status", dev_status)
