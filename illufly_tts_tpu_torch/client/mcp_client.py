# -*- coding: utf-8 -*-
"""MCP client for the TTS server (split deployment).

Restores the reference's ``src/illufly_tts/client/mcp_client.py``
capability (README.md:94, runtime trace server.log:5-37) without the
``mcp`` pip dependency: JSON-RPC 2.0 with the initialize handshake, then
``tools/call``. Two connection modes, matching the reference flags:

- stdio subprocess: ``TTSMcpClient(process_command="python",
  process_args=["-m", "illufly_tts_tpu_torch.api.mcp_server", ...])`` spawns the
  server and speaks newline-delimited JSON on its pipes;
- SSE: ``TTSMcpClient(host=..., port=...)`` opens ``GET /sse``, reads the
  session's message endpoint from the first event, POSTs requests there and
  resolves replies from the event stream.
"""
from __future__ import annotations

import asyncio
import contextlib
import itertools
import json
import logging
import os
from typing import Any, Dict, List, Optional

from ..mcp import protocol as p

logger = logging.getLogger(__name__)


class MCPError(RuntimeError):
    pass


class TTSMcpClient:
    def __init__(
        self,
        process_command: Optional[str] = None,
        process_args: Optional[List[str]] = None,
        host: Optional[str] = None,
        port: Optional[int] = None,
        use_stdio: Optional[bool] = None,
        timeout: float = 900.0,
        token: Optional[str] = None,
    ) -> None:
        # default timeout covers a cold first call of the server (the
        # reference's compile of the serving buckets can exceed 300 s)
        if use_stdio is None:
            use_stdio = process_command is not None
        self.use_stdio = use_stdio
        # shared secret for a TTS_MCP_TOKEN-gated SSE server; defaults
        # to the same env var so client and server read one knob
        self.token = token if token is not None else os.environ.get(
            "TTS_MCP_TOKEN", ""
        )
        self.process_command = process_command
        self.process_args = list(process_args or [])
        self.host = host
        self.port = port
        self.timeout = timeout
        self._ids = itertools.count(1)
        self._pending: Dict[Any, asyncio.Future] = {}
        self._proc: Optional[asyncio.subprocess.Process] = None
        self._reader_task: Optional[asyncio.Task] = None
        self._session = None           # aiohttp.ClientSession (sse mode)
        self._sse_resp = None
        self._endpoint: Optional[str] = None
        self._connected = False

    # ------------------------------------------------------------------
    # connection
    # ------------------------------------------------------------------

    async def connect(self) -> None:
        if self._connected:
            return
        if self._proc is not None or self._session is not None:
            # a previous half-open attempt (e.g. _initialize timeout)
            # left transports up — tear them down or a retry would spawn
            # a SECOND server subprocess racing the first on _pending
            await self.close()
        try:
            if self.use_stdio:
                await self._connect_stdio()
            else:
                await self._connect_sse()
            await self._initialize()
        except BaseException:
            await self.close()  # no leaked sessions/subprocesses
            raise
        self._connected = True
        logger.info("MCP client connected (stdio=%s)", self.use_stdio)

    async def _connect_stdio(self) -> None:
        if not self.process_command:
            raise MCPError("stdio mode needs process_command")
        self._proc = await asyncio.create_subprocess_exec(
            self.process_command, *self.process_args,
            stdin=asyncio.subprocess.PIPE,
            stdout=asyncio.subprocess.PIPE,
            # one tools/call reply line carries a whole base64 WAV —
            # asyncio's default 64 KiB stream limit would kill readline
            limit=512 * 1024 * 1024,
        )
        self._reader_task = asyncio.ensure_future(self._stdio_read_loop())

    async def _stdio_read_loop(self) -> None:
        assert self._proc is not None and self._proc.stdout is not None
        try:
            while True:
                line = await self._proc.stdout.readline()
                if not line:
                    break
                try:
                    msg = p.decode_line(line)
                except ValueError:
                    logger.warning(
                        "non-JSON line from server: %r", line[:200]
                    )
                    continue
                if msg is not None:
                    self._dispatch(msg)
        finally:
            # whatever ends the loop (EOF, oversize line, cancel),
            # don't leave callers hanging until their timeout
            self._fail_pending(MCPError("server stdio stream closed"))

    async def _connect_sse(self) -> None:
        if not self.host or not self.port:
            raise MCPError("sse mode needs host and port")
        import aiohttp

        headers = (
            {"Authorization": f"Bearer {self.token}"} if self.token else {}
        )
        self._session = aiohttp.ClientSession(headers=headers)
        url = f"http://{self.host}:{self.port}/sse"
        self._sse_resp = await self._session.get(
            url, timeout=aiohttp.ClientTimeout(total=None)
        )
        self._sse_resp.raise_for_status()
        endpoint_fut: asyncio.Future = asyncio.get_event_loop().create_future()
        self._reader_task = asyncio.ensure_future(
            self._sse_read_loop(endpoint_fut)
        )
        self._endpoint = await asyncio.wait_for(endpoint_fut, self.timeout)

    async def _sse_read_loop(self, endpoint_fut: asyncio.Future) -> None:
        assert self._sse_resp is not None
        event: Optional[str] = None
        data_lines: List[str] = []

        def feed(line: str) -> None:
            nonlocal event, data_lines
            if line.startswith("event:"):
                event = line[6:].strip()
            elif line.startswith("data:"):
                data_lines.append(line[5:].strip())
            elif line == "":
                data = "\n".join(data_lines)
                data_lines = []
                if event == "endpoint" and not endpoint_fut.done():
                    endpoint_fut.set_result(data)
                elif event == "message" and data:
                    with contextlib.suppress(ValueError):
                        self._dispatch(json.loads(data))
                event = None

        try:
            # manual buffering: one `data:` line can carry a whole base64
            # WAV, far past any line-iterator limit
            buf = b""
            async for chunk in self._sse_resp.content.iter_any():
                buf += chunk
                while b"\n" in buf:
                    raw, buf = buf.split(b"\n", 1)
                    feed(raw.decode("utf-8").rstrip("\r"))
        except (asyncio.CancelledError, Exception) as exc:
            if not endpoint_fut.done():
                endpoint_fut.set_exception(
                    exc if isinstance(exc, Exception)
                    else MCPError("sse stream closed")
                )
        self._fail_pending(MCPError("sse stream closed"))

    def _dispatch(self, msg: Dict[str, Any]) -> None:
        fut = self._pending.pop(msg.get("id"), None)
        if fut is not None and not fut.done():
            fut.set_result(msg)

    def _fail_pending(self, exc: Exception) -> None:
        for fut in self._pending.values():
            if not fut.done():
                fut.set_exception(exc)
        self._pending.clear()

    # ------------------------------------------------------------------
    # protocol
    # ------------------------------------------------------------------

    async def _send(self, msg: Dict[str, Any]) -> None:
        if self.use_stdio:
            assert self._proc is not None and self._proc.stdin is not None
            self._proc.stdin.write(p.encode_line(msg))
            await self._proc.stdin.drain()
        else:
            assert self._session is not None and self._endpoint is not None
            url = f"http://{self.host}:{self.port}{self._endpoint}"
            resp = await self._session.post(url, json=msg)
            status = resp.status
            resp.release()
            if status >= 400:
                # fail fast: a swallowed 401/404 here left the caller
                # waiting out the full request timeout
                raise MCPError(f"POST {self._endpoint} -> HTTP {status}")

    async def _request(self, method: str,
                       params: Optional[Dict[str, Any]] = None) -> Any:
        msg_id = next(self._ids)
        fut: asyncio.Future = asyncio.get_event_loop().create_future()
        self._pending[msg_id] = fut
        try:
            await self._send(p.request(msg_id, method, params))
            reply = await asyncio.wait_for(fut, self.timeout)
        finally:
            # drop the slot on timeout/cancel too — a late reply must not
            # land in a dead future, and _pending must not grow unbounded
            self._pending.pop(msg_id, None)
        if "error" in reply:
            err = reply["error"]
            raise MCPError(f"{err.get('code')}: {err.get('message')}")
        return reply.get("result")

    async def _initialize(self) -> None:
        await self._request("initialize", {
            "protocolVersion": p.PROTOCOL_VERSION,
            "capabilities": {},
            "clientInfo": {"name": "illufly-tts-tpu-client",
                           "version": "0.1.0"},
        })
        await self._send(p.notification("notifications/initialized"))

    # ------------------------------------------------------------------
    # tool surface
    # ------------------------------------------------------------------

    async def list_tools(self) -> List[Dict[str, Any]]:
        await self.connect()
        result = await self._request("tools/list")
        return result.get("tools", [])

    async def call_tool(self, name: str,
                        arguments: Dict[str, Any]) -> Any:
        await self.connect()
        result = await self._request(
            "tools/call", {"name": name, "arguments": arguments}
        )
        return p.parse_content_text(result)

    async def text_to_speech(self, text: str, voice: str = "zf_001",
                             speed: float = 1.0,
                             return_timestamps: bool = False,
                             pitch: float = 1.0,
                             ) -> Dict[str, Any]:
        args: Dict[str, Any] = {
            "text": text, "voice": voice, "speed": speed,
        }
        if pitch != 1.0:  # older servers lack the knob; omit when neutral
            args["pitch"] = pitch
        if return_timestamps:
            args["return_timestamps"] = True
        return await self.call_tool("text_to_speech", args)

    async def list_voices(self) -> List[Dict[str, Any]]:
        result = await self.call_tool("list_voices", {})
        if isinstance(result, dict):
            return result.get("voices", [])
        return result or []

    async def get_info(self) -> Dict[str, Any]:
        return await self.call_tool("get_info", {})

    # ------------------------------------------------------------------

    async def close(self) -> None:
        self._connected = False
        if self._reader_task is not None:
            self._reader_task.cancel()
            with contextlib.suppress(asyncio.CancelledError, Exception):
                await self._reader_task
        if self._proc is not None:
            if self._proc.stdin is not None:
                with contextlib.suppress(Exception):
                    self._proc.stdin.close()
            with contextlib.suppress(asyncio.TimeoutError):
                await asyncio.wait_for(self._proc.wait(), 5.0)
            if self._proc.returncode is None:
                self._proc.terminate()
                with contextlib.suppress(Exception):
                    await asyncio.wait_for(self._proc.wait(), 5.0)
            if self._proc.returncode is None:
                # SIGTERM ignored (e.g. wedged in a compile): escalate —
                # never leave an orphaned device-holding server behind
                with contextlib.suppress(Exception):
                    self._proc.kill()
                    await self._proc.wait()
            self._proc = None
        if self._sse_resp is not None:
            with contextlib.suppress(Exception):
                self._sse_resp.close()
            self._sse_resp = None
        if self._session is not None:
            with contextlib.suppress(Exception):
                await self._session.close()
            self._session = None

    async def __aenter__(self) -> "TTSMcpClient":
        await self.connect()
        return self

    async def __aexit__(self, *exc: Any) -> None:
        await self.close()
