# -*- coding: utf-8 -*-
"""Lightweight TTS client package (split deployment, client side).

Mirrors the reference's documented ``illufly_tts.client`` surface
(README.md:92-96): an MCP client that reaches a TTS MCP server either by
spawning it as a subprocess (stdio transport) or over HTTP SSE."""
from .mcp_client import TTSMcpClient  # noqa: F401
