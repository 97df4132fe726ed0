# -*- coding: utf-8 -*-
"""JSON-RPC 2.0 framing + the MCP message shapes this framework speaks.

Covers the slice of MCP used by the reference's split deployment
(server.log:14-37): ``initialize`` handshake, ``notifications/initialized``,
``tools/list`` and ``tools/call``. Transport framing is newline-delimited
JSON for stdio and SSE events for HTTP (see server.py / client code).
"""
from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

JSONRPC_VERSION = "2.0"
PROTOCOL_VERSION = "2024-11-05"

# JSON-RPC error codes
PARSE_ERROR = -32700
INVALID_REQUEST = -32600
METHOD_NOT_FOUND = -32601
INVALID_PARAMS = -32602
INTERNAL_ERROR = -32603


@dataclass
class ToolDef:
    """A tool the server exposes via tools/list."""

    name: str
    description: str
    input_schema: Dict[str, Any] = field(default_factory=dict)

    def to_wire(self) -> Dict[str, Any]:
        return {
            "name": self.name,
            "description": self.description,
            "inputSchema": self.input_schema or {
                "type": "object", "properties": {}
            },
        }


def request(msg_id: Any, method: str,
            params: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
    msg: Dict[str, Any] = {
        "jsonrpc": JSONRPC_VERSION, "id": msg_id, "method": method,
    }
    if params is not None:
        msg["params"] = params
    return msg


def notification(method: str,
                 params: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
    msg: Dict[str, Any] = {"jsonrpc": JSONRPC_VERSION, "method": method}
    if params is not None:
        msg["params"] = params
    return msg


def response(msg_id: Any, result: Any) -> Dict[str, Any]:
    return {"jsonrpc": JSONRPC_VERSION, "id": msg_id, "result": result}


def error_response(msg_id: Any, code: int, message: str) -> Dict[str, Any]:
    return {
        "jsonrpc": JSONRPC_VERSION,
        "id": msg_id,
        "error": {"code": code, "message": message},
    }


def text_content(payload: Any) -> List[Dict[str, Any]]:
    """Wrap a python object as MCP text content (JSON-encoded, matching the
    reference client's expectation of a JSON string in content[0].text)."""
    text = payload if isinstance(payload, str) else json.dumps(
        payload, ensure_ascii=False
    )
    return [{"type": "text", "text": text}]


def parse_content_text(result: Dict[str, Any]) -> Any:
    """Extract content[0].text from a tools/call result; JSON-decode when
    possible (the server encodes structured results as JSON strings)."""
    content = result.get("content") or []
    for item in content:
        if item.get("type") == "text":
            text = item.get("text", "")
            try:
                return json.loads(text)
            except (ValueError, TypeError):
                return text
    return None


def encode_line(msg: Dict[str, Any]) -> bytes:
    """stdio framing: one JSON message per line."""
    return (json.dumps(msg, ensure_ascii=False) + "\n").encode("utf-8")


def decode_line(line: bytes) -> Optional[Dict[str, Any]]:
    line = line.strip()
    if not line:
        return None
    return json.loads(line.decode("utf-8"))
