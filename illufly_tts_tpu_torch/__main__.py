# -*- coding: utf-8 -*-
"""CLI: ``python -m illufly_tts_tpu_torch serve`` — flag parity with the
reference (reference: src/illufly_tts/__main__.py:23-142). Serves over
aiohttp (uvicorn/fastapi are optional in this environment).

``--device`` goes to the engine (or the trained model): CUDA by default,
the CPU only when ``--device cpu`` is passed. Without a CUDA device and
without that flag the engine raises. ``serve --dp N`` and ``train --dp N``
(N > 1) run one replica per device of an N-way 'data' mesh
(``parallel/mesh.py``) over the host's CUDA devices, or over ``--device``
alone where it names one; too few devices fail as the JAX CLI's
``make_mesh`` assert does. As in the JAX CLI, no flag sets a 'model'
axis: a tensor-parallel mesh is built in Python
(``Synthesizer(mesh=make_mesh(n_data, n_model))``, ``train(mesh=...)``)."""
from __future__ import annotations

import logging
import os
import sys

import click

from .utils.env import load_dotenv

load_dotenv()

logging.basicConfig(
    level=logging.INFO,
    format="%(asctime)s [%(levelname)s] %(name)s: %(message)s",
)
logger = logging.getLogger("illufly_tts_tpu_torch")

_DEVICE_HELP = "engine device: cuda (default) or cpu"


def _dp_mesh(dp: int, device):
    """The N-way 'data' mesh of ``--dp N`` (None for N <= 1): over every
    CUDA device of the host, or over ``device`` alone where it names one
    other than plain ``cuda`` (an AssertionError for N > 1 then)."""
    if not dp or dp <= 1:
        return None
    from .parallel.mesh import make_mesh

    return make_mesh(n_data=dp,
                     devices=None if device in (None, "cuda") else [device])


@click.group()
def cli():
    """illufly-tts-tpu, PyTorch/CUDA port: Chinese-first TTS service."""


@cli.command()
@click.option("--host", default="0.0.0.0", help="bind host")
@click.option("--port", default=31572, type=int, help="bind port")
@click.option("--repo-id", default="", help="model params path (empty = random init)")
@click.option("--voices-dir", default=None, help="voice pack directory")
@click.option("--device", default=None, help=_DEVICE_HELP)
@click.option("--batch-size", default=4, type=int, help="max batch per step")
@click.option("--max-wait-time", default=0.2, type=float, help="batching window (s)")
@click.option("--chunk-size", default=200, type=int, help="long-text chunk chars")
@click.option("--output-dir", default=None, help="wav output directory")
@click.option("--debug-output", is_flag=True, help="dump per-task debug wavs")
@click.option("--zh-dict", default=None, help="custom zh pronunciation dict")
@click.option("--en-dict", default=None, help="custom en pronunciation dict")
@click.option("--dp", default=0, type=int,
              help="data-parallel serving over N devices (0 = single "
                   "device)")
@click.option("--audio-wire", default=None,
              type=click.Choice(["mulaw24k"]),
              help="device->host wire codec for PCM outputs (mulaw24k: "
                   "half the transfer, G.711 8-bit quality at 24 kHz)")
@click.option("--british", is_flag=True, envvar="TTS_BRITISH",
              help="GB English pronunciation (reference "
                   "EnglishG2P(british=True))")
@click.option("--frontend-workers", default=0, type=int,
              envvar="TTS_FRONTEND_WORKERS",
              help="shard the GIL-bound text frontend across N worker "
                   "processes so big-batch G2P overlaps the device loop "
                   "(0 = inline)")
def serve(host, port, repo_id, voices_dir, device, batch_size, max_wait_time,
          chunk_size, output_dir, debug_output, zh_dict, en_dict, dp,
          audio_wire, british, frontend_workers):
    """Start the TTS HTTP service."""
    if frontend_workers and frontend_workers > 0:
        # pipeline construction (here or inside create_app) reads the env
        os.environ["TTS_FRONTEND_WORKERS"] = str(frontend_workers)
    from aiohttp import web

    from .api.endpoints import create_app

    if zh_dict:
        from .frontend.g2p.custom_dict import load_zh_dict

        load_zh_dict(zh_dict)
    if en_dict:
        from .frontend.g2p.custom_dict import load_en_dict

        load_en_dict(en_dict)
    if debug_output:
        os.environ["TTS_DEBUG_OUTPUT"] = "1"
    from .api.auth import get_jwt_secret_key
    from .api.dev_mode import is_dev_mode

    loopback = host in ("127.0.0.1", "localhost", "::1")
    if is_dev_mode():
        logger.warning("=" * 60)
        logger.warning("DEV MODE ENABLED — authentication is relaxed")
        if not loopback:
            logger.warning(
                "binding %s with dev mode ON: every request authenticates "
                "as admin. Unset TTS_DEV_MODE or bind 127.0.0.1.", host,
            )
        logger.warning("=" * 60)
    elif get_jwt_secret_key() == "MY-SECRET-KEY" and not loopback:
        logger.warning(
            "FASTAPI_SECRET_KEY is the default value on a non-loopback bind "
            "(%s) — JWTs are forgeable. Set FASTAPI_SECRET_KEY.", host,
        )

    pipeline = None
    mesh = _dp_mesh(dp, device)
    if mesh is not None:
        from .pipeline import CachedTTSPipeline

        logger.info("data-parallel serving over %d devices", dp)
        pipeline = CachedTTSPipeline(
            repo_id=repo_id, voices_dir=voices_dir, device=device,
            mesh=mesh, wire_format=audio_wire, british=british,
        )
    cors_origins = os.environ.get("TTS_CORS_ORIGINS", "")
    app = create_app(
        repo_id=repo_id,
        voices_dir=voices_dir,
        device=device,
        batch_size=batch_size,
        max_wait_time=max_wait_time,
        chunk_size=chunk_size,
        output_dir=output_dir,
        pipeline=pipeline,
        wire_format=audio_wire,
        british=british,
    )
    if cors_origins:
        from .api.endpoints import make_cors_middleware

        app.middlewares.append(make_cors_middleware(cors_origins))

    logger.info("serving on %s:%d", host, port)
    web.run_app(app, host=host, port=port)


@cli.command()
@click.argument("text")
@click.option("--output", "-o", default="output.wav",
              help="output path (.wav, or .flac for lossless FLAC)")
@click.option("--voice-id", default="zf_001", help="voice id")
@click.option("--speed", default=1.0, type=float, help="speech speed")
@click.option("--repo-id", default="", help="model params path")
@click.option("--voices-dir", default=None, help="voice pack directory")
@click.option("--device", default=None, help=_DEVICE_HELP)
@click.option("--zh-dict", default=None, help="custom zh pronunciation dict")
@click.option("--en-dict", default=None,
              help="custom en dict (text lines or misaki-format JSON)")
@click.option("--segment/--no-segment", default=False,
              help="split long text into sentence segments")
@click.option("--stream", is_flag=True,
              help="intra-utterance streaming decode: write audio chunks "
                   "to the wav as the decoder renders them (bit-exact "
                   "mode by default — the full utterance renders before "
                   "the first chunk; add --low-latency for windowed "
                   "first-audio-after-one-window delivery)")
@click.option("--low-latency", is_flag=True,
              help="with --stream: windowed decode (exact=False) — first "
                   "audio lands after one decode window at the cost of "
                   "window-seam approximation vs the full render")
@click.option("--timestamps", is_flag=True,
              help="also write word-level timestamps (from the duration "
                   "predictor's rendered alignment) to OUTPUT.json")
@click.option("--british", is_flag=True, envvar="TTS_BRITISH",
              help="GB English pronunciation")
@click.option("--pitch", default=1.0, type=float,
              help="F0 scale (1.0 = neutral; 0.25-4.0)")
def synth(text, output, voice_id, speed, repo_id, voices_dir, device,
          zh_dict, en_dict, segment, stream, low_latency, timestamps,
          british, pitch):
    """Synthesize TEXT to a wav file (local, no server)."""
    if zh_dict:
        from .frontend.g2p.custom_dict import load_zh_dict

        load_zh_dict(zh_dict)
    if en_dict:
        from .frontend.g2p.custom_dict import load_en_dict

        load_en_dict(en_dict)
    from .pipeline import CachedTTSPipeline

    pipe = CachedTTSPipeline(repo_id=repo_id, voices_dir=voices_dir,
                             device=device, british=british)
    if not pipe.synthesizer.is_voice_loaded(voice_id):
        logger.warning(
            "voice %s not found; using a synthetic random voice", voice_id
        )
        pipe.synthesizer.register_random_voice(voice_id, seed=42)
    if stream:
        import time as _time

        import numpy as np

        from .audio.wav import save_audio

        chunks = []
        t0 = _time.perf_counter()
        ttfa = None
        if timestamps:
            # stamps are known at dispatch — before any audio renders
            words, gen = pipe.stream_process_with_timestamps(
                text, voice_id=voice_id, speed=speed, pitch=pitch,
                exact=not low_latency,
            )
            import json as _json

            ts_path = os.path.splitext(output)[0] + ".json"
            with open(ts_path, "w", encoding="utf-8") as f:
                _json.dump({"words": words}, f, ensure_ascii=False,
                           indent=1)
            click.echo(
                f"wrote {ts_path}: {len(words)} word timestamps "
                f"({_time.perf_counter() - t0:.3f}s, before first audio)"
            )
        else:
            gen = pipe.stream_process(text, voice_id=voice_id, speed=speed,
                                      pitch=pitch,
                                      exact=not low_latency)
        for chunk in gen:
            if ttfa is None:
                ttfa = _time.perf_counter() - t0
                click.echo(f"first audio after {ttfa:.3f}s")
            chunks.append(chunk)
        audio = np.concatenate(chunks) if chunks else np.zeros(
            0, np.float32
        )
        save_audio(output, audio, pipe.sample_rate)
    elif timestamps:
        import json as _json

        audio, words = pipe.process_with_timestamps(
            text, voice_id=voice_id, speed=speed, output_path=output,
            pitch=pitch,
        )
        ts_path = os.path.splitext(output)[0] + ".json"
        with open(ts_path, "w", encoding="utf-8") as f:
            _json.dump({"words": words}, f, ensure_ascii=False, indent=1)
        click.echo(f"wrote {ts_path}: {len(words)} word timestamps")
    else:
        audio = pipe.process(text, voice_id=voice_id, speed=speed,
                             output_path=output, segment_text=segment,
                             pitch=pitch)
    click.echo(
        f"wrote {output}: {audio.size / pipe.sample_rate:.2f}s at "
        f"{pipe.sample_rate} Hz"
    )


@cli.command()
@click.option("--repo-id", default="", help="model params path")
@click.option("--voices-dir", default=None, help="voice pack directory")
@click.option("--device", default=None, help=_DEVICE_HELP)
@click.option("--batch-size", default=4, type=int)
@click.option("--max-wait-time", default=0.2, type=float)
@click.option("--chunk-size", default=200, type=int)
@click.option("--transport", default="stdio",
              type=click.Choice(["stdio", "sse"]), help="MCP transport")
@click.option("--host", default="127.0.0.1",
              help="bind host (sse; loopback default — the SSE transport "
                   "has no JWT, gate with TTS_MCP_TOKEN before exposing)")
@click.option("--port", default=31572, type=int, help="bind port (sse)")
def server(repo_id, voices_dir, device, batch_size, max_wait_time,
           chunk_size, transport, host, port):
    """Start the MCP TTS server (split deployment, engine side).

    Reference: README.md:49-51 / server.log:4 —
    ``python -m illufly_tts server --transport=sse --port=31572``."""
    from .mcp.server import run_server

    run_server(
        transport=transport, host=host, port=port,
        repo_id=repo_id, voices_dir=voices_dir, device=device,
        batch_size=batch_size, max_wait_time=max_wait_time,
        chunk_size=chunk_size,
    )


@cli.command()
@click.option("--host", default="0.0.0.0", help="gateway bind host")
@click.option("--port", default=31571, type=int, help="gateway bind port")
@click.option("--server-host", default=None, help="remote MCP server host")
@click.option("--server-port", default=31572, type=int,
              help="remote MCP server port")
@click.option("--process-command", default=None,
              help="spawn the MCP server as a subprocess instead")
@click.option("--process-args", default=None,
              help="comma-separated args for --process-command")
def api(host, port, server_host, server_port, process_command, process_args):
    """Start the HTTP API gateway backed by a remote MCP server.

    Reference: README.md:53-55 — ``python -m illufly_tts api
    --server-host=tts-server-ip --server-port=31572``."""
    from aiohttp import web

    from .api.gateway import create_gateway_app

    if not server_host and not process_command:
        raise click.UsageError(
            "pass --server-host (SSE) or --process-command (stdio subprocess)"
        )
    app = create_gateway_app(
        server_host=server_host,
        server_port=server_port,
        process_command=process_command,
        process_args=process_args.split(",") if process_args else None,
    )
    logger.info("gateway on %s:%d -> MCP %s", host, port,
                server_host or process_command)
    web.run_app(app, host=host, port=port)


def _tiny_cfg():
    """Tiny model config shared by the smoke/CI paths of train/convert."""
    from .model.config import AlbertConfig, IstftNetConfig, KokoroConfig

    return KokoroConfig(
        n_token=64, hidden_dim=64, style_dim=32, max_dur=10, n_layer=2,
        albert=AlbertConfig(
            vocab_size=64, embedding_size=32, hidden_size=128,
            num_heads=4, intermediate_size=256, num_layers=2,
            max_position=128,
        ),
        istftnet=IstftNetConfig(
            upsample_rates=(10, 6), upsample_kernel_sizes=(20, 12),
            upsample_initial_channel=128,
            resblock_kernel_sizes=(3,),
            resblock_dilation_sizes=((1, 3),),
        ),
    )


@cli.command()
@click.argument("checkpoint", type=click.Path(exists=True, dir_okay=False))
@click.option("--output", "-o", default=None,
              help="output weights path (.msgpack; default: CHECKPOINT "
                   "with the extension swapped)")
@click.option("--voices-dir", default=None,
              help="also convert every .pt voice pack in this directory "
                   "to .npy")
@click.option("--voices-output", default=None,
              help="output directory for converted voice packs "
                   "(default: --voices-dir in place)")
@click.option("--device", default=None, help=_DEVICE_HELP)
@click.option("--tiny", is_flag=True, hidden=True)
def convert(checkpoint, output, voices_dir, voices_output, device, tiny):
    """Convert a torch Kokoro checkpoint to flax msgpack weights.

    One-time migration step for reference users (their HF checkpoint —
    hexgrad/Kokoro-82M-v1.1-zh `*.pth` + config.json vocab table — works
    directly): `serve`/`synth` also accept the .pth itself via --repo-id,
    but the converted .msgpack skips the name/layout mapping on every
    start, and the JAX package loads it too. The weights are loaded onto
    --device on the way (CUDA by default)."""
    from .engine.synthesizer import Synthesizer
    from .model.config import KokoroConfig

    synth_engine = Synthesizer(config=_tiny_cfg() if tiny
                               else KokoroConfig(), device=device)
    if output is None:
        output = os.path.splitext(checkpoint)[0] + ".msgpack"
    synth_engine.load_params(checkpoint)  # raises ConversionError w/ lists
    synth_engine.save_params(output)
    click.echo(f"wrote {output}")

    if voices_dir:
        import numpy as np
        import torch

        out_dir = voices_output or voices_dir
        os.makedirs(out_dir, exist_ok=True)
        n = 0
        for name in sorted(os.listdir(voices_dir)):
            if not name.endswith(".pt"):
                continue
            pack = torch.load(
                os.path.join(voices_dir, name), map_location="cpu",
                weights_only=True,
            ).numpy().astype(np.float32)
            np.save(os.path.join(out_dir, name[:-3] + ".npy"), pack)
            n += 1
        click.echo(f"converted {n} voice packs -> {out_dir}")


@cli.command("train-voice")
@click.option("--data", "data_dir", required=True,
              help="dataset dir of the target speaker "
                   "(metadata.csv+wavs/ or paired wav+txt)")
@click.option("--output", "-o", required=True,
              help="output voice pack (.npy, standard [510,1,256] "
                   "length-indexed layout)")
@click.option("--repo-id", default="",
              help="model weights (.msgpack or torch .pt/.pth); "
                   "random init if omitted")
@click.option("--steps", default=200, type=int, help="Adam steps")
@click.option("--lr", default=5e-2, type=float)
@click.option("--batch-size", default=4, type=int)
@click.option("--tokens", default=128, type=int)
@click.option("--frames", default=256, type=int)
@click.option("--init-voice", default=None,
              help="warm-start from an existing voice id (resolved via "
                   "--voices-dir) or a pack file path")
@click.option("--voices-dir", default=None)
@click.option("--device", default=None, help=_DEVICE_HELP)
@click.option("--seed", default=0, type=int)
@click.option("--tiny", is_flag=True, hidden=True)
def train_voice(data_dir, output, repo_id, steps, lr, batch_size, tokens,
                frames, init_voice, voices_dir, device, seed, tiny):
    """Learn a NEW VOICE from a few recordings of a speaker.

    The model weights stay frozen; only the 256-d AdaIN style vector
    (128 decoder + 128 prosody, reference kmodel.py:82-84) optimizes
    against mel-L1 + multi-res STFT on the recordings. The result is a
    standard voice pack usable everywhere a shipped voice is (serve,
    synth, MCP, blend specs)."""
    import numpy as np

    from .engine.synthesizer import Synthesizer
    from .model.config import KokoroConfig
    from .training.data import SpeechDataset, dataset_batches, prefetch
    from .training.voice_adapt import adapt_voice, style_to_pack

    engine = Synthesizer(config=_tiny_cfg() if tiny else KokoroConfig(),
                         voices_dir=voices_dir, device=device)
    if repo_id:
        if not os.path.isfile(repo_id):
            # a typo'd path or an HF repo id would silently adapt
            # against RANDOM weights and write a garbage pack
            raise click.ClickException(
                f"--repo-id {repo_id!r} is not a readable weights file "
                "(.msgpack or torch .pt/.pth)"
            )
        engine.load_params(repo_id)
    cfg = engine.config

    init = None
    if init_voice:
        if os.path.isfile(init_voice):
            pack = np.load(init_voice)
        else:
            pack = engine.load_voice(init_voice)
        # packs are length-indexed [L,1,256]; the mean over lengths is
        # the natural single-vector summary to warm-start from
        init = np.asarray(pack, np.float32).reshape(
            pack.shape[0], -1
        ).mean(axis=0)

    dataset = SpeechDataset(
        data_dir, sample_rate=cfg.sample_rate,
        style_dim=2 * cfg.style_dim,
        samples_per_frame=cfg.samples_per_frame,
    )
    batches = prefetch(dataset_batches(
        dataset, batch_size, tokens, frames, cfg.samples_per_frame,
        seed=seed, vocab_size=cfg.albert.vocab_size,
    ))
    style, metrics = adapt_voice(
        engine.model, batches, steps=steps, learning_rate=lr,
        frames=frames, init=init, spectral=True,
    )
    np.save(output, style_to_pack(style))
    click.echo(f"wrote {output} ({metrics})")


@cli.command()
@click.option("--steps", default=100, type=int, help="optimizer steps")
@click.option("--batch-size", default=8, type=int)
@click.option("--tokens", default=64, type=int, help="token bucket")
@click.option("--frames", default=128, type=int, help="frame budget")
@click.option("--lr", default=1e-4, type=float)
@click.option("--checkpoint-dir", default=None,
              help="checkpoint directory (step_%08d/state.pt)")
@click.option("--resume", is_flag=True,
              help="resume from the latest checkpoint in --checkpoint-dir")
@click.option("--checkpoint-every", default=100, type=int)
@click.option("--dp", default=0, type=int,
              help="data-parallel over N devices (0 = single device)")
@click.option("--device", default=None, help=_DEVICE_HELP)
@click.option("--tiny", is_flag=True,
              help="tiny model config (smoke runs / CI)")
@click.option("--seed", default=0, type=int)
@click.option("--data", "data_dir", default=None,
              help="dataset dir (metadata.csv+wavs/ or paired wav+txt); "
                   "switches to the mel-L1 + multi-res-STFT objective")
@click.option("--adversarial", is_flag=True,
              help="add the HiFi-GAN LSGAN objective (MultiPeriod + "
                   "MultiResolution discriminators, feature matching)")
@click.option("--disc-lr", default=2e-4, type=float,
              help="discriminator learning rate (with --adversarial)")
def train(steps, batch_size, tokens, frames, lr, checkpoint_dir, resume,
          checkpoint_every, dp, device, tiny, seed, data_dir, adversarial,
          disc_lr):
    """Train the model (teacher-distillation on synthetic data by
    default, real speech data via --data; the reference ships no
    training code). The weights start from the port's seeded random init
    (``model/params.py::random_flax_params``), not flax's ``model.init``."""
    from .engine.synthesizer import resolve_device
    from .model.config import KokoroConfig
    from .model.kokoro import KokoroModel
    from .model.params import load_flax_params, random_flax_params
    from .training.loop import train as run_train

    cfg = _tiny_cfg() if tiny else KokoroConfig()
    model = KokoroModel(cfg)
    load_flax_params(model, random_flax_params(model, seed))
    mesh = _dp_mesh(dp, device)
    model.to(resolve_device(device) if mesh is None
             else mesh.data_devices[0])
    _, _, metrics = run_train(
        model, steps=steps, batch_size=batch_size, tokens=tokens,
        frames=frames, learning_rate=lr, mesh=mesh,
        checkpoint_dir=checkpoint_dir,
        resume=resume, checkpoint_every=checkpoint_every, seed=seed,
        data_dir=data_dir, adversarial=adversarial, disc_lr=disc_lr,
    )
    click.echo(f"done: {metrics}")


@cli.command()
@click.option("--host", default="0.0.0.0", help="router bind host")
@click.option("--port", default=31570, type=int, help="router bind port")
@click.option("--backends", required=True,
              help="comma-separated replica base URLs (host:port or http://...)")
@click.option("--health-interval", default=5.0, type=float,
              help="replica health-check period (s)")
def router(host, port, backends, health_interval):
    """Route traffic across multi-host serve replicas (DCN scale-out).

    Each replica runs ``python -m illufly_tts_tpu_torch serve`` on its
    own host/devices; the router adds per-user-sticky distribution (preserves
    scheduler sequence ordering), health-based failover, and merged
    /tts/stats."""
    from aiohttp import web

    from .api.router import create_router_app

    backend_list = [b.strip() for b in backends.split(",") if b.strip()]
    app = create_router_app(backend_list, health_interval=health_interval)
    logger.info("routing %s:%d -> %s", host, port, backend_list)
    web.run_app(app, host=host, port=port)


@cli.group()
def client():
    """Command-line MCP client (reference README.md:59-65)."""


def _make_client(process_command, process_args, server_host, server_port):
    from .client.mcp_client import TTSMcpClient

    if not process_command and not server_host:
        # default: spawn this package's own MCP server locally
        process_command = sys.executable
        process_args = (
            "-m,illufly_tts_tpu_torch.api.mcp_server,--transport,stdio"
        )
    return TTSMcpClient(
        process_command=process_command,
        process_args=process_args.split(",") if process_args else None,
        host=server_host,
        port=server_port,
    )


@client.command()
@click.argument("text")
@click.option("--output", "-o", default="output.wav", help="output wav path")
@click.option("--voice-id", default="zf_001")
@click.option("--speed", default=1.0, type=float)
@click.option("--process-command", default=None,
              help="server subprocess executable (stdio mode)")
@click.option("--process-args", default=None,
              help="comma-separated subprocess args")
@click.option("--server-host", default=None, help="SSE server host")
@click.option("--server-port", default=31572, type=int)
@click.option("--timestamps", is_flag=True,
              help="also write word-level timestamps to OUTPUT.json")
@click.option("--pitch", default=1.0, type=float,
              help="F0 scale (1.0 = neutral)")
def speak(text, output, voice_id, speed, process_command, process_args,
          server_host, server_port, timestamps, pitch):
    """Synthesize TEXT via an MCP server and save the wav."""
    import asyncio
    import base64

    async def run():
        c = _make_client(process_command, process_args,
                         server_host, server_port)
        async with c:
            result = await c.text_to_speech(
                text, voice_id, speed, return_timestamps=timestamps,
                pitch=pitch,
            )
        if not isinstance(result, dict) or result.get("status") != "success":
            err = result.get("error") if isinstance(result, dict) else result
            raise click.ClickException(f"synthesis failed: {err}")
        wav = base64.b64decode(result["audio_base64"])
        with open(output, "wb") as f:
            f.write(wav)
        if timestamps:
            import json as _json

            ts_path = os.path.splitext(output)[0] + ".json"
            with open(ts_path, "w", encoding="utf-8") as f:
                _json.dump({"words": result.get("timestamps") or []},
                           f, ensure_ascii=False, indent=1)
            click.echo(f"wrote {ts_path}")
        click.echo(f"wrote {output} ({len(wav)} bytes, "
                   f"{result.get('sample_rate')} Hz)")

    asyncio.run(run())


@client.command()
@click.option("--process-command", default=None)
@click.option("--process-args", default=None)
@click.option("--server-host", default=None)
@click.option("--server-port", default=31572, type=int)
def voices(process_command, process_args, server_host, server_port):
    """List voices available on an MCP server."""
    import asyncio

    async def run():
        c = _make_client(process_command, process_args,
                         server_host, server_port)
        async with c:
            for v in await c.list_voices():
                click.echo(f"{v.get('id')}\t{v.get('name', '')}")

    asyncio.run(run())


def main():
    if len(sys.argv) == 1:
        sys.argv.append("serve")
    cli()


if __name__ == "__main__":
    main()
