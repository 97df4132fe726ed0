# -*- coding: utf-8 -*-
"""Developer-mode auth bypass.

Capability parity with the reference (src/illufly_tts/api/dev_mode.py:16-209):
TTS_DEV_MODE env gate; accepts the literal 'dev_token', dev-key-signed JWTs,
unverified JWTs carrying a user_id, X-Dev-Secret-Key/X-Dev-User headers,
?dev_token=true, a Swagger-referer bypass, else a default dev user."""
from __future__ import annotations

import logging
import os
import time
from typing import Any, Dict, Mapping, Optional

from . import jwt_hs256 as jwt

logger = logging.getLogger(__name__)


def header_get(
    headers: Mapping[str, str], name: str, default: str = ""
) -> str:
    """Case-insensitive header lookup. aiohttp passes CIMultiDict (native
    case-insensitive); FastAPI/Starlette hosts may pass plain dicts with
    lowercased keys (fastapi_compat), so fall back to a scan."""
    value = headers.get(name)
    if value is not None:
        return value
    lname = name.lower()
    value = headers.get(lname)
    if value is not None:
        return value
    for key, val in headers.items():
        if key.lower() == lname:
            return val
    return default


DEV_SECRET_KEY_ENV = "TTS_DEV_SECRET_KEY"
DEFAULT_DEV_SECRET = "tts-dev-secret-key"
DEFAULT_DEV_USER = {
    "user_id": "dev_user",
    "username": "developer",
    "roles": ["user", "admin"],
    "dev_mode": True,
}


def is_dev_mode() -> bool:
    return os.environ.get("TTS_DEV_MODE", "").lower() in (
        "1", "true", "yes", "on",
    )


def get_dev_secret_key() -> str:
    return os.environ.get(DEV_SECRET_KEY_ENV, DEFAULT_DEV_SECRET)


def generate_dev_token(
    user_id: str = "dev_user", expire_minutes: int = 60 * 24
) -> str:
    payload = {
        "user_id": user_id,
        "username": f"dev_{user_id}",
        "roles": ["user", "admin"],
        "dev_mode": True,
        "exp": time.time() + expire_minutes * 60,
    }
    return jwt.encode(payload, get_dev_secret_key())


def verify_token_dev_mode(token: str) -> Dict[str, Any]:
    """Lenient token verification for dev mode."""
    if token == "dev_token":
        return dict(DEFAULT_DEV_USER)
    try:
        return jwt.decode(token, get_dev_secret_key())
    except jwt.JWTError:
        pass
    try:
        unverified = jwt.decode(
            token, options={"verify_signature": False, "verify_exp": False}
        )
        if unverified.get("user_id"):
            logger.warning(
                "dev mode: accepting unverified token for %s",
                unverified["user_id"],
            )
            return unverified
    except jwt.JWTError:
        pass
    return dict(DEFAULT_DEV_USER)


def handle_dev_auth(
    headers: Mapping[str, str],
    query: Mapping[str, str],
    token: Optional[str],
) -> Optional[Dict[str, Any]]:
    """Dev-mode request-level bypass. Returns a user dict or None."""
    if not is_dev_mode():
        return None
    if header_get(headers, "X-Dev-Secret-Key") == get_dev_secret_key():
        user_id = header_get(headers, "X-Dev-User", "dev_user")
        return {
            "user_id": user_id,
            "username": f"dev_{user_id}",
            "roles": ["user", "admin"],
            "dev_mode": True,
        }
    if query.get("dev_token") == "true":
        return dict(DEFAULT_DEV_USER)
    referer = header_get(headers, "Referer")
    if "/docs" in referer or "/redoc" in referer:
        return dict(DEFAULT_DEV_USER)
    if token:
        return verify_token_dev_mode(token)
    return dict(DEFAULT_DEV_USER)
