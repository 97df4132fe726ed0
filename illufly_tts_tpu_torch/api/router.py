# -*- coding: utf-8 -*-
"""Multi-host replica router (serving over DCN).

The model is 82M params — one chip holds it easily, so the honest
multi-host design is replica serving (SURVEY §2 parallelism table /
§5 distributed note): each host runs ``serve`` on its own chip(s), and
this router spreads HTTP traffic across them.

Semantics preserved from the single-host scheduler:
- per-user ordering: requests are routed by a stable hash of the
  authenticated user (falling back to the client IP), so one user's
  sequence-ordered tasks land on one replica's scheduler and keep its
  sequence_id/fairness guarantees;
- failover: replicas are health-checked (GET /tts/info); a down replica's
  users re-hash onto the survivors (HRW hashing — only the failed
  replica's users move);
- aggregation: /tts/stats merges all replicas; /tts/voices and /tts/info
  proxy a healthy replica.

Auth passes through verbatim — replicas enforce JWT/dev-mode themselves,
so the router needs no secrets.
"""
from __future__ import annotations

import asyncio
import contextlib
import hashlib
import logging
import time
from typing import Dict, List, Optional

from aiohttp import web

logger = logging.getLogger(__name__)

HOP_HEADERS = {
    "host", "content-length", "transfer-encoding", "connection",
    "keep-alive",
}


class Backend:
    def __init__(self, base_url: str) -> None:
        self.base_url = base_url.rstrip("/")
        self.healthy = True
        self.last_check = 0.0
        self.inflight = 0

    def __repr__(self) -> str:
        state = "up" if self.healthy else "DOWN"
        return f"<Backend {self.base_url} {state} inflight={self.inflight}>"


def _hrw_pick(backends: List[Backend], key: str) -> Optional[Backend]:
    """Highest-random-weight (rendezvous) hash: stable per-key choice,
    minimal movement when a replica dies."""
    alive = [b for b in backends if b.healthy]
    if not alive:
        return None
    best, best_score = None, -1
    for b in alive:
        h = hashlib.sha1(f"{key}|{b.base_url}".encode()).digest()
        score = int.from_bytes(h[:8], "big")
        if score > best_score:
            best, best_score = b, score
    return best


def create_router_app(
    backends: List[str],
    prefix: str = "/api",
    health_interval: float = 5.0,
    request_timeout: float = 600.0,
) -> web.Application:
    import aiohttp

    app = web.Application()
    pool = [Backend(b if "://" in b else f"http://{b}") for b in backends]
    app["backends"] = pool

    async def startup(app: web.Application) -> None:
        app["session"] = aiohttp.ClientSession(
            timeout=aiohttp.ClientTimeout(total=request_timeout)
        )
        app["health_task"] = asyncio.ensure_future(health_loop(app))

    async def cleanup(app: web.Application) -> None:
        task = app.get("health_task")
        if task is not None:
            task.cancel()
            with contextlib.suppress(asyncio.CancelledError, Exception):
                await task
        session = app.get("session")
        if session is not None:
            await session.close()

    app.on_startup.append(startup)
    app.on_cleanup.append(cleanup)

    async def check_backend(app: web.Application, b: Backend) -> None:
        session: aiohttp.ClientSession = app["session"]
        try:
            async with session.get(
                f"{b.base_url}{prefix}/tts/info",
                timeout=aiohttp.ClientTimeout(total=3.0),
            ) as resp:
                ok = resp.status < 500
        except Exception:
            ok = False
        if ok != b.healthy:
            logger.warning("backend %s -> %s", b.base_url,
                           "healthy" if ok else "DOWN")
        b.healthy = ok
        b.last_check = time.time()

    async def health_loop(app: web.Application) -> None:
        while True:
            await asyncio.gather(
                *(check_backend(app, b) for b in app["backends"])
            )
            await asyncio.sleep(health_interval)

    def route_key(request: web.Request) -> str:
        """Stable per-user key: the JWT's user claim when decodable (so
        the SAME user keeps the SAME replica across token renewals — the
        raw token re-hashes on refresh and breaks sequence ordering),
        else the raw token, else the declared user, else the peer."""
        auth = request.headers.get("Authorization", "")
        token = auth[7:] if auth.startswith("Bearer ") else \
            request.cookies.get("access_token")
        if token:
            try:
                from . import jwt_hs256

                payload = jwt_hs256.decode(
                    token, options={"verify_signature": False}
                )
                uid = payload.get("user_id") or payload.get("sub")
                if uid:
                    return str(uid)
            except Exception:
                pass  # opaque token: fall back to hashing it directly
            return token
        dev_user = request.headers.get("X-Dev-User")
        if dev_user:
            return dev_user
        peer = request.remote or "anon"
        return peer

    async def proxy(request: web.Request, b: Backend) -> web.StreamResponse:
        session: aiohttp.ClientSession = request.app["session"]
        url = f"{b.base_url}{request.rel_url}"
        headers = {
            k: v for k, v in request.headers.items()
            if k.lower() not in HOP_HEADERS
        }
        body = await request.read()
        b.inflight += 1
        try:
            try:
                upstream_cm = session.request(
                    request.method, url, headers=headers, data=body,
                    allow_redirects=False,
                )
                upstream = await upstream_cm.__aenter__()
            except Exception as exc:
                # could not reach the replica at all: demote it + 502
                logger.error("proxy to %s failed: %s", b.base_url, exc)
                b.healthy = False
                raise web.HTTPBadGateway(reason=f"replica failed: {exc}")
            try:
                out_headers = {
                    k: v for k, v in upstream.headers.items()
                    if k.lower() not in HOP_HEADERS
                }
                resp = web.StreamResponse(
                    status=upstream.status, headers=out_headers
                )
                await resp.prepare(request)
                # classify failures by the OPERATION, not the exception
                # type: on aiohttp >=3.10 a client abort raises
                # ClientConnectionResetError from resp.write, which IS a
                # ClientError — type-based branches demoted a healthy
                # replica whenever the CLIENT hung up
                try:
                    async for chunk in upstream.content.iter_chunked(
                        64 * 1024
                    ):
                        try:
                            await resp.write(chunk)  # -> CLIENT
                        except (
                            aiohttp.ClientError, ConnectionError, OSError
                        ):
                            # client went away; the replica is fine —
                            # demoting would needlessly re-hash its
                            # sticky users
                            logger.info("client disconnected mid-stream")
                            return resp
                    try:
                        await resp.write_eof()  # -> CLIENT
                    except (
                        aiohttp.ClientError, ConnectionError, OSError
                    ):
                        logger.info("client disconnected at eof")
                except (
                    aiohttp.ClientError, asyncio.TimeoutError,
                    TimeoutError, ConnectionError, OSError,
                ) as exc:
                    # UPSTREAM read died or hung: status already sent, so
                    # the body is truncated; log + demote, don't 502.
                    # (TimeoutError is an OSError subclass on py3.11+.)
                    logger.error(
                        "replica %s failed mid-stream: %s", b.base_url, exc
                    )
                    b.healthy = False
                return resp
            finally:
                await upstream_cm.__aexit__(None, None, None)
        finally:
            b.inflight -= 1

    async def handle_sticky(request: web.Request) -> web.StreamResponse:
        b = _hrw_pick(request.app["backends"], route_key(request))
        if b is None:
            raise web.HTTPServiceUnavailable(reason="no healthy replicas")
        return await proxy(request, b)

    async def handle_any(request: web.Request) -> web.StreamResponse:
        alive = [b for b in request.app["backends"] if b.healthy]
        if not alive:
            raise web.HTTPServiceUnavailable(reason="no healthy replicas")
        b = min(alive, key=lambda x: x.inflight)
        return await proxy(request, b)

    async def stats(request: web.Request) -> web.Response:
        session: aiohttp.ClientSession = request.app["session"]
        fwd_headers = {
            k: v for k, v in request.headers.items()
            if k.lower() not in HOP_HEADERS
        }

        async def fetch(b: Backend) -> Dict:
            if not b.healthy:
                return {"healthy": False}
            try:
                async with session.get(
                    f"{b.base_url}{prefix}/tts/stats",
                    headers=fwd_headers,
                    timeout=aiohttp.ClientTimeout(total=5.0),
                ) as resp:
                    return {"healthy": True, **(await resp.json())}
            except Exception as exc:
                return {"healthy": False, "error": str(exc)}

        backends = request.app["backends"]
        # concurrent: a hung-but-marked-healthy replica costs 5 s total,
        # not 5 s per replica
        results = await asyncio.gather(*(fetch(b) for b in backends))
        merged = {
            b.base_url: r for b, r in zip(backends, results)
        }
        return web.json_response({
            "replicas": merged,
            "alive": sum(
                1 for b in request.app["backends"] if b.healthy
            ),
        })

    app.router.add_post(f"{prefix}/tts", handle_sticky)
    app.router.add_post(f"{prefix}/tts/stream", handle_sticky)
    # OpenAI-compatible surface rides the same sticky routing (the
    # backend keys fairness/stickiness on the same JWT user)
    app.router.add_post("/v1/audio/speech", handle_sticky)
    app.router.add_get(f"{prefix}/tts/voices", handle_any)
    app.router.add_get(f"{prefix}/tts/info", handle_any)
    app.router.add_get(f"{prefix}/tts/stats", stats)
    return app
