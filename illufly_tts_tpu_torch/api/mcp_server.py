# -*- coding: utf-8 -*-
"""Runnable MCP server module — the module path the reference spawns
(server.log:4: ``python -m illufly_tts.api.mcp_server --repo-id ...
--batch-size=4 --max-wait-time=0.2 --chunk-size=200 --transport stdio``).

``python -m illufly_tts_tpu_torch.api.mcp_server [flags]`` starts the TTS MCP
server; same flag surface as the trace plus ``--voices-dir/--device/--host/
--port``. Implementation lives in mcp/server.py.
"""
from __future__ import annotations

import argparse

from ..mcp.server import run_server


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(
        prog="illufly_tts_tpu_torch.api.mcp_server",
        description="TTS MCP server (stdio or SSE transport)",
    )
    parser.add_argument("--repo-id", default="", help="model params path")
    parser.add_argument("--voices-dir", default=None)
    parser.add_argument("--device", default=None,
                        help="engine device (default cuda; cpu when asked)")
    parser.add_argument("--batch-size", type=int, default=4)
    parser.add_argument("--max-wait-time", type=float, default=0.2)
    parser.add_argument("--chunk-size", type=int, default=200)
    parser.add_argument("--output-dir", default=None)
    parser.add_argument("--transport", choices=("stdio", "sse"),
                        default="stdio")
    # loopback default: the SSE transport's only auth is TTS_MCP_TOKEN
    parser.add_argument("--host", default="127.0.0.1")
    parser.add_argument("--port", type=int, default=31572)
    args = parser.parse_args(argv)
    run_server(
        transport=args.transport,
        host=args.host,
        port=args.port,
        repo_id=args.repo_id,
        voices_dir=args.voices_dir,
        device=args.device,
        batch_size=args.batch_size,
        max_wait_time=args.max_wait_time,
        chunk_size=args.chunk_size,
        output_dir=args.output_dir,
    )


if __name__ == "__main__":
    main()
