# -*- coding: utf-8 -*-
"""MCP server owning the TTS engine (split deployment, server side).

Restores the reference's documented-but-absent ``python -m illufly_tts
server`` capability (README.md:49-51; runtime trace server.log:4 shows the
real flag surface: ``--repo-id --batch-size --max-wait-time --chunk-size
--transport stdio``). Tools exposed (names match the reference trace,
server.log:24): ``text_to_speech``, ``list_voices``, ``get_info``.

Transports:
- ``stdio``: newline-delimited JSON-RPC over stdin/stdout (logging goes to
  stderr so the protocol stream stays clean);
- ``sse``: aiohttp app — ``GET /sse`` opens a text/event-stream whose first
  event announces the session's message endpoint; the client POSTs JSON-RPC
  to it and responses are pushed down the stream (MCP HTTP+SSE transport).
"""
from __future__ import annotations

import asyncio
import contextlib
import json
import logging
import sys
import uuid
from typing import Any, Dict, Optional

from . import protocol as p

logger = logging.getLogger(__name__)

TOOLS = [
    p.ToolDef(
        "text_to_speech",
        "Synthesize speech from text; returns JSON with base64 WAV audio.",
        {
            "type": "object",
            "properties": {
                "text": {"type": "string"},
                "voice": {"type": "string", "default": "zf_001"},
                "speed": {"type": "number", "default": 1.0},
                "pitch": {"type": "number", "default": 1.0},
                "return_timestamps": {"type": "boolean", "default": False},
            },
            "required": ["text"],
        },
    ),
    p.ToolDef("list_voices", "List available voice ids.", {
        "type": "object", "properties": {},
    }),
    p.ToolDef("get_info", "Service configuration and model info.", {
        "type": "object", "properties": {},
    }),
]


class ManagerBackend:
    """Adapts a runtime TTSServiceManager to the tool surface."""

    def __init__(self, **manager_kwargs: Any) -> None:
        # lazy import: keeps `--help`, tests and the client install light
        from ..runtime.scheduler import TTSServiceManager

        self._manager = TTSServiceManager(**manager_kwargs)
        self._started = False
        self.config = {
            k: manager_kwargs.get(k)
            for k in ("repo_id", "device", "batch_size", "max_wait_time",
                      "chunk_size")
        }

    async def start(self) -> None:
        if not self._started:
            import asyncio
            import os

            synth = self._manager.pipeline.synthesizer
            if not synth.is_voice_loaded("zf_001"):
                synth.register_random_voice("zf_001", seed=42)
            if os.environ.get("TTS_WARMUP", "").lower() in (
                "1", "true", "yes"
            ):
                # same deployment knob as the HTTP server: capture the
                # serving keys' CUDA graphs and narrow the bucket inventory
                # to them, so MCP traffic replays (Synthesizer.warmup)
                warmup = getattr(synth, "warmup", None)
                if not callable(warmup):
                    logger.warning(
                        "TTS_WARMUP is set, but this pipeline's synthesizer "
                        "has no warmup: the knob does nothing for it"
                    )
                else:
                    batch = self.config.get("batch_size") or 4
                    await asyncio.to_thread(
                        lambda: warmup(
                            batch_sizes=tuple(sorted({1, batch})),
                            token_sizes=(64, 256),
                            frame_sizes=(256, 512),
                            absorb=True,
                            narrow=True,
                        )
                    )
            await self._manager.start()
            self._started = True

    async def stop(self) -> None:
        if self._started:
            await self._manager.shutdown()
            self._started = False

    async def text_to_speech(self, text: str, voice: str = "zf_001",
                             speed: float = 1.0,
                             return_timestamps: bool = False,
                             pitch: float = 1.0,
                             ) -> Dict[str, Any]:
        from ..api.endpoints import _process_tts_request

        await self.start()
        try:
            return await _process_tts_request(
                self._manager, text, voice, user_id="mcp",
                sequence_id=None, speed=speed,
                return_timestamps=return_timestamps, pitch=pitch,
            )
        except ValueError as exc:  # submit-time range/capability checks
            return {"status": "error", "error": str(exc)}

    async def list_voices(self) -> Dict[str, Any]:
        names = self._manager.pipeline.list_voices() or ["zf_001"]
        return {"voices": [
            {"id": n, "name": n} for n in names if not n.startswith("__")
        ]}

    async def get_info(self) -> Dict[str, Any]:
        cfg = self.config
        device = getattr(self._manager.pipeline.synthesizer, "device", None)
        return {
            "service": "illufly-tts-tpu-mcp",
            "model": cfg.get("repo_id") or "kokoro-82M-class (random init)",
            # the running engine's device, else the one asked for
            "device": (str(device) if device is not None
                       else cfg.get("device") or "cuda"),
            "batch_size": cfg.get("batch_size"),
            "max_wait_time": cfg.get("max_wait_time"),
            "chunk_size": cfg.get("chunk_size"),
            "sample_rate": self._manager.pipeline.sample_rate,
        }


class FakeBackend:
    """Protocol-test backend: real WAV bytes, no model (TTS_FAKE_BACKEND=1).

    Lets the stdio/SSE transports be exercised end-to-end in seconds —
    the subprocess never imports torch or builds a model."""

    sample_rate = 24000

    async def text_to_speech(self, text: str, voice: str = "zf_001",
                             speed: float = 1.0,
                             return_timestamps: bool = False,
                             pitch: float = 1.0,
                             ) -> Dict[str, Any]:
        import base64
        import struct

        if not 0.25 <= pitch <= 4.0:  # same contract as the real backend
            return {"status": "error",
                    "error": "pitch must be within [0.25, 4.0]"}

        if not text:
            return {"status": "error", "error": "missing text"}
        n = min(len(text) * 240, 480000)  # 10ms of silence per char
        data = b"\x00\x00" * n
        header = (
            b"RIFF" + struct.pack("<I", 36 + len(data)) + b"WAVEfmt "
            + struct.pack("<IHHIIHH", 16, 1, 1, self.sample_rate,
                          self.sample_rate * 2, 2, 16)
            + b"data" + struct.pack("<I", len(data))
        )
        out = {
            "status": "success",
            "task_id": "fake",
            "audio_base64": base64.b64encode(header + data).decode("ascii"),
            "sample_rate": self.sample_rate,
        }
        if return_timestamps:
            out["timestamps"] = [{
                "text": text, "phonemes": "x",
                "start_s": 0.0,
                "end_s": round(n / self.sample_rate, 4),
            }]
        return out

    async def list_voices(self) -> Dict[str, Any]:
        return {"voices": [{"id": "zf_001", "name": "zf_001"}]}

    async def get_info(self) -> Dict[str, Any]:
        return {"service": "illufly-tts-tpu-mcp", "fake": True,
                "sample_rate": self.sample_rate}


class MCPServer:
    """Transport-independent MCP message dispatcher around a backend.

    ``backend`` needs async ``text_to_speech(text, voice, speed)``,
    ``list_voices()``, ``get_info()`` and optional ``start``/``stop``.
    """

    def __init__(self, backend: Any,
                 server_name: str = "illufly-tts-tpu") -> None:
        self.backend = backend
        self.server_name = server_name
        self.initialized = False

    async def handle_message(
        self, msg: Dict[str, Any]
    ) -> Optional[Dict[str, Any]]:
        method = msg.get("method")
        msg_id = msg.get("id")
        if method is None:
            return None  # a response echoed back at us; ignore
        if msg_id is None:
            # notification
            if method == "notifications/initialized":
                self.initialized = True
            return None
        try:
            params = msg.get("params") or {}
            if method == "initialize":
                result: Any = {
                    "protocolVersion": p.PROTOCOL_VERSION,
                    "capabilities": {"tools": {}},
                    "serverInfo": {
                        "name": self.server_name, "version": "0.1.0",
                    },
                }
            elif method == "ping":
                result = {}
            elif method == "tools/list":
                result = {"tools": [t.to_wire() for t in TOOLS]}
            elif method == "tools/call":
                result = await self._call_tool(
                    params.get("name", ""), params.get("arguments") or {}
                )
            else:
                return p.error_response(
                    msg_id, p.METHOD_NOT_FOUND, f"unknown method {method}"
                )
            return p.response(msg_id, result)
        except Exception as exc:  # tool errors travel as JSON-RPC errors
            logger.exception("error handling %s", method)
            return p.error_response(msg_id, p.INTERNAL_ERROR, str(exc))

    async def _call_tool(self, name: str,
                         args: Dict[str, Any]) -> Dict[str, Any]:
        if name == "text_to_speech":
            kwargs: Dict[str, Any] = {}
            if args.get("return_timestamps"):
                kwargs["return_timestamps"] = True
            if "pitch" in args:
                kwargs["pitch"] = float(args["pitch"])
            payload = await self.backend.text_to_speech(
                text=args.get("text", ""),
                voice=args.get("voice", args.get("voice_id", "zf_001")),
                speed=float(args.get("speed", 1.0)),
                **kwargs,
            )
        elif name == "list_voices":
            payload = await self.backend.list_voices()
        elif name == "get_info":
            payload = await self.backend.get_info()
        else:
            return {
                "content": p.text_content({
                    "status": "error", "error": f"unknown tool {name}",
                }),
                "isError": True,
            }
        is_error = (
            isinstance(payload, dict) and payload.get("status") == "error"
        )
        return {"content": p.text_content(payload), "isError": is_error}

    # ------------------------------------------------------------------
    # stdio transport
    # ------------------------------------------------------------------

    async def serve_stdio(self) -> None:
        """Speak newline-delimited JSON-RPC on stdin/stdout until EOF.

        IO runs blocking reads/writes in the default executor — works for
        pipes, terminals AND redirected files (loop.connect_write_pipe
        rejects regular files)."""
        loop = asyncio.get_event_loop()
        stdin = sys.stdin.buffer
        stdout = sys.stdout.buffer

        def write_msg(msg: Dict[str, Any]) -> None:
            stdout.write(p.encode_line(msg))
            stdout.flush()

        start = getattr(self.backend, "start", None)
        if callable(start):
            await start()
        try:
            while True:
                line = await loop.run_in_executor(None, stdin.readline)
                if not line:
                    break
                try:
                    msg = p.decode_line(line)
                except ValueError:
                    await loop.run_in_executor(
                        None, write_msg,
                        p.error_response(None, p.PARSE_ERROR, "bad JSON"),
                    )
                    continue
                if msg is None:
                    continue
                reply = await self.handle_message(msg)
                if reply is not None:
                    await loop.run_in_executor(None, write_msg, reply)
        finally:
            stop = getattr(self.backend, "stop", None)
            if callable(stop):
                await stop()

    # ------------------------------------------------------------------
    # SSE transport
    # ------------------------------------------------------------------

    def create_sse_app(self):
        """aiohttp app implementing the MCP HTTP+SSE transport.

        Auth: the SSE transport sits behind no JWT gateway, so a shared
        secret gates it when exposed beyond loopback — set
        ``TTS_MCP_TOKEN`` and clients must send
        ``Authorization: Bearer <token>`` on /sse and /messages (or
        ``?token=`` for EventSource clients that can't set headers).
        Unset = open (safe with the 127.0.0.1 default bind)."""
        import hmac
        import os

        from aiohttp import web

        expected = os.environ.get("TTS_MCP_TOKEN", "")

        def _authorized(request: web.Request) -> bool:
            if not expected:
                return True
            header = request.headers.get("Authorization", "")
            supplied = header[7:] if header.startswith("Bearer ") else \
                request.query.get("token", "")
            return hmac.compare_digest(supplied, expected)

        sessions: Dict[str, asyncio.Queue] = {}
        # strong refs: asyncio keeps only weak refs to tasks, and the
        # 202-then-push pattern would otherwise let GC drop an in-flight
        # tools/call before its reply reaches the queue
        inflight: set = set()

        async def sse(request: web.Request) -> web.StreamResponse:
            if not _authorized(request):
                raise web.HTTPUnauthorized(reason="bad or missing token")
            session_id = uuid.uuid4().hex
            queue: asyncio.Queue = asyncio.Queue()
            sessions[session_id] = queue
            resp = web.StreamResponse(headers={
                "Content-Type": "text/event-stream",
                "Cache-Control": "no-cache",
                "Connection": "keep-alive",
            })
            await resp.prepare(request)
            endpoint = f"/messages?session_id={session_id}"
            await resp.write(
                f"event: endpoint\ndata: {endpoint}\n\n".encode()
            )
            try:
                while True:
                    msg = await queue.get()
                    if msg is None:
                        break
                    data = json.dumps(msg, ensure_ascii=False)
                    await resp.write(
                        f"event: message\ndata: {data}\n\n".encode()
                    )
            except (ConnectionResetError, asyncio.CancelledError):
                pass
            finally:
                sessions.pop(session_id, None)
            return resp

        async def messages(request: web.Request) -> web.Response:
            if not _authorized(request):
                raise web.HTTPUnauthorized(reason="bad or missing token")
            session_id = request.query.get("session_id", "")
            queue = sessions.get(session_id)
            if queue is None:
                return web.json_response(
                    {"error": "unknown session"}, status=404
                )
            try:
                msg = await request.json()
            except Exception:
                return web.json_response({"error": "bad JSON"}, status=400)

            async def process() -> None:
                reply = await self.handle_message(msg)
                if reply is not None:
                    await queue.put(reply)

            task = asyncio.ensure_future(process())
            inflight.add(task)
            task.add_done_callback(inflight.discard)
            return web.Response(status=202, text="Accepted")

        app = web.Application()
        app.router.add_get("/sse", sse)
        app.router.add_post("/messages", messages)

        async def on_startup(app):
            start = getattr(self.backend, "start", None)
            if callable(start):
                await start()

        async def on_cleanup(app):
            for q in sessions.values():
                with contextlib.suppress(Exception):
                    q.put_nowait(None)
            stop = getattr(self.backend, "stop", None)
            if callable(stop):
                await stop()

        app.on_startup.append(on_startup)
        app.on_cleanup.append(on_cleanup)
        return app

    def serve_sse(self, host: str = "127.0.0.1", port: int = 31572) -> None:
        # loopback default: unlike the JWT-gated HTTP server, the SSE
        # transport's only auth is the optional TTS_MCP_TOKEN — exposing
        # it beyond this host must be an explicit --host choice
        from aiohttp import web

        web.run_app(self.create_sse_app(), host=host, port=port,
                    print=lambda *_: None)


def run_server(
    transport: str = "stdio",
    host: str = "127.0.0.1",
    port: int = 31572,
    backend: Optional[Any] = None,
    **manager_kwargs: Any,
) -> None:
    """Entry point used by the CLI ``server`` command and by
    ``python -m illufly_tts_tpu_torch.api.mcp_server``.

    ``backend`` overrides the engine (tests use a stub; ``TTS_FAKE_BACKEND=1``
    selects one too, so protocol round-trips don't need a model build)."""
    import os

    logging.basicConfig(
        stream=sys.stderr, level=logging.INFO,
        format="%(asctime)s [%(levelname)s] %(name)s - %(message)s",
    )
    if backend is None and os.environ.get("TTS_FAKE_BACKEND", "") in (
        "1", "true", "yes"
    ):
        backend = FakeBackend()
    if backend is None:
        backend = ManagerBackend(**manager_kwargs)
    server = MCPServer(backend)
    if transport == "stdio":
        asyncio.run(server.serve_stdio())
    elif transport == "sse":
        server.serve_sse(host, port)
    else:
        raise ValueError(f"unknown transport {transport!r}")
