# -*- coding: utf-8 -*-
"""Minimal MCP (Model Context Protocol) implementation for split deployment.

The reference documents a three-way split (README.md:44-66, server.log:4-37):
an MCP server process owning the TTS engine, an HTTP API gateway that talks
to it as an MCP client, and a command-line client — all built on the ``mcp``
pip package, which is absent from this image. This package implements the
needed slice of the protocol (JSON-RPC 2.0; initialize / tools/list /
tools/call; stdio and SSE transports) on the stdlib + aiohttp.
"""
from .protocol import JSONRPC_VERSION, PROTOCOL_VERSION  # noqa: F401
