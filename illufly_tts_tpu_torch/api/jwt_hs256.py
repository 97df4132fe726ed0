# -*- coding: utf-8 -*-
"""Minimal JWT (HS256) encode/verify — the pyjwt capability the reference
relies on (reference: src/illufly_tts/api/auth.py:1), implemented on the
stdlib since pyjwt is not available in this environment."""
from __future__ import annotations

import base64
import hashlib
import hmac
import json
import time
from typing import Any, Dict, Optional


class JWTError(Exception):
    pass


class ExpiredSignatureError(JWTError):
    pass


class InvalidSignatureError(JWTError):
    pass


def _b64url_encode(data: bytes) -> str:
    return base64.urlsafe_b64encode(data).rstrip(b"=").decode("ascii")


def _b64url_decode(data: str) -> bytes:
    padding = "=" * (-len(data) % 4)
    return base64.urlsafe_b64decode(data + padding)


def encode(
    payload: Dict[str, Any], key: str, algorithm: str = "HS256"
) -> str:
    if algorithm != "HS256":
        raise JWTError(f"unsupported algorithm: {algorithm}")
    header = {"alg": "HS256", "typ": "JWT"}
    segments = [
        _b64url_encode(json.dumps(header, separators=(",", ":")).encode()),
        _b64url_encode(json.dumps(payload, separators=(",", ":")).encode()),
    ]
    signing_input = ".".join(segments).encode("ascii")
    signature = hmac.new(
        key.encode("utf-8"), signing_input, hashlib.sha256
    ).digest()
    segments.append(_b64url_encode(signature))
    return ".".join(segments)


def decode(
    token: str,
    key: Optional[str] = None,
    algorithms=None,
    options: Optional[Dict[str, bool]] = None,
) -> Dict[str, Any]:
    options = options or {}
    verify_signature = options.get("verify_signature", True)
    verify_exp = options.get("verify_exp", True)
    try:
        header_b64, payload_b64, sig_b64 = token.split(".")
        payload = json.loads(_b64url_decode(payload_b64))
    except Exception as exc:
        raise JWTError(f"malformed token: {exc}") from exc
    if verify_signature:
        if not key:
            raise InvalidSignatureError("no key provided")
        signing_input = f"{header_b64}.{payload_b64}".encode("ascii")
        expected = hmac.new(
            key.encode("utf-8"), signing_input, hashlib.sha256
        ).digest()
        try:
            # malformed base64 in the SIGNATURE segment must surface as a
            # JWTError (-> 401), not binascii.Error (-> 500)
            actual = _b64url_decode(sig_b64)
        except Exception as exc:
            raise InvalidSignatureError(
                f"malformed signature: {exc}"
            ) from exc
        if not hmac.compare_digest(expected, actual):
            raise InvalidSignatureError("signature mismatch")
    if verify_exp and "exp" in payload:
        try:
            exp = float(payload["exp"])
        except (TypeError, ValueError) as exc:
            # a non-numeric exp claim is a malformed token, not a 500
            raise JWTError(f"invalid exp claim: {exc}") from exc
        if time.time() > exp:
            raise ExpiredSignatureError("token expired")
    return payload
