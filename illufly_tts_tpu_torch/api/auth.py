# -*- coding: utf-8 -*-
"""JWT auth (cookie or bearer header), framework-agnostic.

Capability parity with the reference (src/illufly_tts/api/auth.py:10-167):
env config FASTAPI_SECRET_KEY / FASTAPI_ALGORITHM /
JWT_ACCESS_TOKEN_EXPIRE_MINUTES / JWT_COOKIE_NAME, HS256 verification,
role checks, dev-mode delegation."""
from __future__ import annotations

import logging
import os
from typing import Any, Dict, List, Mapping, Optional

from . import jwt_hs256 as jwt
from .dev_mode import (
    handle_dev_auth,
    header_get,
    is_dev_mode,
    verify_token_dev_mode,
)

logger = logging.getLogger(__name__)

JWT_ALGORITHM = os.environ.get("FASTAPI_ALGORITHM", "HS256")
JWT_ACCESS_TOKEN_EXPIRE_MINUTES = int(
    os.environ.get("JWT_ACCESS_TOKEN_EXPIRE_MINUTES", "60")
)
JWT_COOKIE_NAME = os.environ.get("JWT_COOKIE_NAME", "access_token")


class AuthError(Exception):
    def __init__(self, status: int, detail: str):
        super().__init__(detail)
        self.status = status
        self.detail = detail


def get_jwt_secret_key() -> str:
    key = os.environ.get("FASTAPI_SECRET_KEY", "MY-SECRET-KEY")
    if key.startswith('"') and key.endswith('"'):
        key = key.strip('"')
    return key


class TokenVerifier:
    @staticmethod
    def verify_token(token: str) -> Dict[str, Any]:
        if is_dev_mode():
            return verify_token_dev_mode(token)
        try:
            return jwt.decode(token, get_jwt_secret_key())
        except jwt.ExpiredSignatureError as exc:
            raise AuthError(401, "token expired") from exc
        except jwt.JWTError as exc:
            raise AuthError(401, f"invalid token: {exc}") from exc


def extract_token(
    headers: Mapping[str, str], cookies: Mapping[str, str]
) -> Optional[str]:
    auth_header = header_get(headers, "Authorization")
    if auth_header.startswith("Bearer "):
        return auth_header[7:]
    return cookies.get(JWT_COOKIE_NAME)


def authenticate(
    headers: Mapping[str, str],
    cookies: Mapping[str, str],
    query: Mapping[str, str],
    required_roles: Optional[List[str]] = None,
) -> Dict[str, Any]:
    """Resolve the request's user, honoring dev mode. Raises AuthError."""
    token = extract_token(headers, cookies)
    if is_dev_mode():
        user = handle_dev_auth(headers, query, token)
        if user is not None:
            return user
    if not token:
        raise AuthError(401, "not authenticated")
    user = TokenVerifier.verify_token(token)
    if required_roles:
        roles = user.get("roles", [])
        if not any(r in roles for r in required_roles):
            raise AuthError(403, "insufficient permissions")
    return user


def create_access_token(
    user_id: str,
    roles: Optional[List[str]] = None,
    expire_minutes: Optional[int] = None,
) -> str:
    import time

    # `is None`, not falsy: expire_minutes=0 means an already-expired
    # token (tests mint these), not the default lifetime
    minutes = (
        JWT_ACCESS_TOKEN_EXPIRE_MINUTES if expire_minutes is None
        else expire_minutes
    )
    payload = {
        "user_id": user_id,
        "roles": roles or ["user"],
        "exp": time.time() + minutes * 60,
    }
    return jwt.encode(payload, get_jwt_secret_key())
