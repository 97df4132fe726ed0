# -*- coding: utf-8 -*-
"""Smoke run of the PyTorch port on one CUDA card (H100, sm_90a).

    python3 chip_smoke.py

From the root of a checkout. It
1. reports torch/CUDA versions and the card's name and power limit, and
   turns TF32 off for matrix products and convolutions (float32 throughout);
2. builds every CUDA kernel of the port from ``illufly_tts_tpu_torch/csrc``
   (one nvcc per source, all at once) and reports the build time and each
   kernel's registers, shared memory and spills;
3. holds each kernel against its plain PyTorch version on the card
   (tolerance stated per kernel) and times kernel, plain version and, where
   there is one, the nearest single PyTorch call, with CUDA events, beside
   the kernel's bound (the conv kernels' at four shapes, the halo tile's at
   each column tile, and the carry kernel's walking chunks beside one-tile
   chunks; the iSTFT kernel's two entries, the head from conv_post's raw
   output and the polar one, at the timed and stream-window shapes, beside
   the eager route the head replaced and ``torch.istft``);
4. drives the batch path — ``Synthesizer.synthesize_batch`` and
   ``dispatch -> launch_decode -> collect`` at the full ``KokoroConfig()``
   with seeded random weights and a random voice — on three requests in
   pcm16, f32, mulaw8k and mulaw24k, and checks lengths, finiteness,
   non-silence and that every kernel ran as often as each stage B runs it
   (the iSTFT kernel once per Generator pass);
5. drives the streaming path: exact streams concatenate bit for bit to
   ``collect()``; a windowed stream gives finite, non-silent chunks of the
   right count and length, with every kernel launched per window as per
   stage B; and the mulaw24k bytes equal ``mulaw_encode_np`` of the card's
   own int16 rendering; then holds each kernel against its plain version
   at the shapes both paths gave it;
6. holds the port on the card against the port on the CPU at full width
   (B=2, frame bucket 128), both stage Bs fed the card's stage-A outputs.

It prints a ``{"kernels": [...]}`` JSON line and, last, ``{"ok": true,
"device": {...}}``. Any failed check exits non-zero with no result line;
so does a host without CUDA, or a directory without the port's package.
"""
from __future__ import annotations

import json
import math
import os
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))

# H100 SXM published peaks (NVIDIA data sheet): HBM bytes/s, f32 (non
# tensor-core) operations/s, dense TF32 tensor-core operations/s
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
TF32_OPS_PER_S = 495e12

ISTFT_TOL = 1e-4       # max-abs, as the JAX package holds its Pallas iSTFT
# the head entry: max-abs over (1 + max|plain|), since magnitudes reach
# e^8 ~ 2981 (exp of the clipped log-magnitude)
HEAD_TOL = 1e-4
# per frame, the head kernel's f32 arithmetic: 191 FMAs (the folded bases)
# plus 19 + 15 adds, 5 envelope and 22 polar products; its 44 SFU
# transcendentals are not counted
ISTFT_OPS_PER_FRAME = 2 * 191 + 19 + 15 + 5 + 22
CONV_TOL = 1e-4        # max-abs over (1 + max|plain|): f32 sums of C k terms
CPU_GPU_TOL = 5e-3     # rms/scale, the golden-audio gate's waveform bound

ZH = "ni→xau↓ma, tsʰɤ↘ʂɨ↘i↗kɤ↘tʰəst."
MIXED = "tʰjɛn→tʃʰi↘tʃən→pu↗tsʰwo↘. hello wɝld."
EN = "ðɪs ɪz ə smˈoʊk tˈɛst ʌv ðə pˈɔɹt."
FORMATS = ("pcm16", "f32", "mulaw8k", "mulaw24k")
STREAM_WINDOW, STREAM_HALO = 64, 16   # model frames

# the fused AdaIN-Snake-conv kernels: wrapper name -> (TPU kernel it
# replaces, the residual-block conv it runs)
CONV_KERNELS = {
    "adain_snake_conv": ("illufly_tts_tpu/ops/pallas/fused_conv.py:92",
                         "conv2_j (dilation 1)"),
    "adain_snake_conv_carry": ("illufly_tts_tpu/ops/pallas/carry_conv.py:110",
                               "conv1_j (dilation d_j)"),
}
# the timed shape: B=8 at frame bucket 512, the Generator's last stage
TIMED = {"batch": 8, "channels": 128, "length": 61440, "kernel": 11,
         "dilation": {"adain_snake_conv": 1, "adain_snake_conv_carry": 5}}
# more timed (B, C, L, k, d): b8's stage 0 (d as at the timed shape), and
# the two stages of a B=1 stream window (64 + 2 * 16 frames)
MORE_SHAPES = ((8, 256, 10240, 11, None), (1, 256, 1920, 7, 3),
               (1, 128, 11520, 11, 5))


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, reps, flush):
    """Median device time of ``fn`` in ms over ``reps`` runs, each after a
    write of ``flush`` (larger than L2) so inputs come from device memory;
    the flush also keeps the card busy while the host enqueues ``fn``."""
    import torch

    times = []
    for _ in range(reps):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bound(n_bytes, n_ops, ops_per_s=F32_OPS_PER_S):
    """(least ms on the card, what bounds it)."""
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, n_ops / ops_per_s
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def istft_inputs(torch, batch, frames, seed, zero=False):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    shape = (batch, frames, 11)
    if zero:
        return (torch.zeros(shape, device="cuda"),
                torch.zeros(shape, device="cuda"))
    mag = torch.randn(shape, device="cuda", generator=gen).abs()
    phase = (torch.rand(shape, device="cuda", generator=gen) * 2 - 1) * math.pi
    return mag, phase


def check_istft(torch, oa, shapes):
    """Kernel vs plain at each (batch, frames, zero) -> max abs error."""
    worst = 0.0
    for i, (batch, frames, zero) in enumerate(shapes):
        mag, phase = istft_inputs(torch, batch, frames, seed=i, zero=zero)
        out = oa.istft_oa(mag, phase)
        torch.cuda.synchronize()
        ref = oa.istft_oa_plain(mag, phase)
        if out.shape != (batch, frames * 5):
            fail(f"istft_oa shape {tuple(out.shape)} at {(batch, frames)}")
        err = float((out - ref).abs().max())
        if zero and float(out.abs().max()) != 0.0:
            fail("istft_oa: zero input gave nonzero audio")
        log(f"  istft_oa [{batch}, {frames}, 11]{' zero' if zero else ''}:"
            f" max|kernel - plain| = {err:.3e}")
        if not err <= ISTFT_TOL:
            fail(f"istft_oa disagrees with plain at {(batch, frames)}: {err}")
        worst = max(worst, err)
    return worst


def head_inputs(torch, batch, frames, seed, edges=False):
    """conv_post-like raw output [B, 22, L]: log-magnitudes ~N(0, 4), raw
    phases ~N(0, 9). ``edges``: log-magnitudes ~N(0, 100) (beyond both clip
    edges, -12 and 8) and one NaN (a phase channel of the last row's middle
    frame, when L >= 8)."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn((batch, 22, frames), device="cuda", generator=gen)
    x[:, :11] *= 10.0 if edges else 2.0
    x[:, 11:] *= 3.0
    if edges and frames >= 8:
        x[-1, 15, frames // 2] = float("nan")
    return x


def check_head(torch, oa, shapes):
    """Head kernel vs ``istft_head_plain`` at each (batch, frames, edges)
    -> max abs error over the finite samples. NaN must land in the same
    samples; audio sample 0 must be exactly 0."""
    worst = 0.0
    for i, (batch, frames, edges) in enumerate(shapes):
        x = head_inputs(torch, batch, frames, seed=100 + i, edges=edges)
        out = oa.istft_head(x)
        torch.cuda.synchronize()
        ref = oa.istft_head_plain(x)
        if out.shape != (batch, frames * 5):
            fail(f"istft_head shape {tuple(out.shape)} at {(batch, frames)}")
        nan = torch.isnan(ref)
        if not torch.equal(torch.isnan(out), nan):
            fail(f"istft_head: NaN samples differ from plain at "
                 f"{(batch, frames)}")
        if edges and frames >= 8 and not bool(nan.any()):
            fail("istft_head: the NaN input gave no NaN sample")
        if not bool((out[:, 0] == 0).all()):
            fail(f"istft_head: audio sample 0 is not 0 at {(batch, frames)}")
        fin = ~nan
        err = float((out[fin] - ref[fin]).abs().max())
        tol = HEAD_TOL * (1.0 + float(ref[fin].abs().max()))
        log(f"  istft_head [{batch}, 22, {frames}]"
            f"{' beyond the clip edges + NaN' if edges else ''}: "
            f"max|kernel - plain| = {err:.3e} (tolerance {tol:.3e})")
        if not err <= tol:
            fail(f"istft_head disagrees with plain at {(batch, frames)}: "
                 f"{err} > {tol}")
        worst = max(worst, err)
    return worst


def time_istft(torch, oa, flush):
    """Both entries of the iSTFT kernel, timed: the head at [8, 22, 61440]
    and at a B=1 stream window [1, 22, 11520], the polar entry at
    [8, 61440, 11]. Beside each: its plain version, the bound, the eager
    route the head replaced (clamp/exp, pi * sin, two channels-last copies,
    the polar kernel) and torch.istft(center=True) on the same spectrum,
    which is not the same function (it drops the first n_fft/2 samples and
    keeps F * hop - hop). Last, a [1, 22, 4] head and a 4-float add: the
    floor of this timing method."""
    def eager(x):
        mag = torch.exp(torch.clamp(x[:, :11], -12.0, 8.0))
        phase = math.pi * torch.sin(x[:, 11:])
        return oa.istft_oa(mag.transpose(1, 2).contiguous(),
                           phase.transpose(1, 2).contiguous())

    window = torch.hann_window(20, periodic=True, device="cuda")

    def nearest(spec):
        return lambda: torch.istft(spec, 20, 5, 20, window, center=True)

    def measure(calls, reps):
        for call in calls.values():
            call()
        return {key: cuda_ms(call, reps, flush) for key, call in calls.items()}

    def bounds(row, batch, frames, in_bytes):
        row["bound_ms"], row["bound_by"] = bound(
            in_bytes + batch * frames * 5 * 4,
            batch * frames * ISTFT_OPS_PER_FRAME)
        row["shape"] = [batch, frames]
        return row

    out = {}
    for name, (batch, frames) in (("head", (8, 61440)),
                                  ("head_window", (1, 11520))):
        x = head_inputs(torch, batch, frames, seed=99)
        spec = torch.polar(torch.exp(torch.clamp(x[:, :11], -12.0, 8.0)),
                           math.pi * torch.sin(x[:, 11:]))
        out[name] = bounds(measure({
            "ms": lambda: oa.istft_head(x),
            "plain_ms": lambda: oa.istft_head_plain(x),
            "eager_route_ms": lambda: eager(x),
            "nearest_call_ms": nearest(spec),
        }, 50 if batch > 1 else 100), batch, frames, x.numel() * 4)
    mag, phase = istft_inputs(torch, 8, 61440, seed=99)
    spec = torch.polar(mag, phase).transpose(1, 2).contiguous()
    out["polar"] = bounds(measure({
        "ms": lambda: oa.istft_oa(mag, phase),
        "plain_ms": lambda: oa.istft_oa_plain(mag, phase),
        "nearest_call_ms": nearest(spec),
    }, 50), 8, 61440, 2 * mag.numel() * 4)
    tiny = head_inputs(torch, 1, 4, seed=98)
    four = torch.zeros(4, device="cuda")
    out["floor"] = measure({"head_1x22x4_ms": lambda: oa.istft_head(tiny),
                            "torch_add_4_floats_ms": lambda: four.add_(1.0)},
                           100)
    for name in ("head", "head_window", "polar"):
        row = out[name]
        log(f"istft {name} at {row['shape']}: kernel {row['ms']:.4f} ms, "
            f"plain {row['plain_ms']:.4f} ms, bound {row['bound_ms']:.4f} "
            f"ms ({row['bound_by']}, {row['bound_ms'] / row['ms']:.0%} of "
            "it reached)"
            + (f", eager route {row['eager_route_ms']:.4f} ms"
               if "eager_route_ms" in row else "")
            + f", torch.istft(center=True) {row['nearest_call_ms']:.4f} ms "
            "(not the same function)")
    log(f"timing floor: a [1, 22, 4] head {out['floor']['head_1x22x4_ms']:.4f}"
        f" ms, a 4-float torch add {out['floor']['torch_add_4_floats_ms']:.4f}"
        " ms")
    return out


def conv_inputs(torch, batch, channels, length, kernel, seed,
                zero_mask=False):
    """x, mask (odd rows keep their first ~2/3), scale, shift, alpha, w
    [k, C, C], b for the fused conv at one shape."""
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def randn(*shape):
        return torch.randn(shape, device="cuda", generator=gen)

    x = randn(batch, channels, length) * 0.5
    keep = torch.tensor([length if i % 2 == 0 else max(1, length * 2 // 3)
                         for i in range(batch)], device="cuda")
    mask = (torch.arange(length, device="cuda")[None, :]
            < keep[:, None]).float()
    if zero_mask:
        mask.zero_()
    return (x, mask.contiguous(), 1.0 + 0.1 * randn(batch, channels),
            0.1 * randn(batch, channels), randn(channels).abs() + 0.5,
            randn(kernel, channels, channels) / math.sqrt(channels * kernel),
            0.1 * randn(channels))


def check_conv(torch, asc, name, cases):
    """Kernel ``name`` vs plain at each (batch, C, L, k, d, zero_mask) ->
    max abs error. With an all-zero mask the output must be the bias."""
    fn = getattr(asc, name)
    worst = 0.0
    for i, (batch, channels, length, k, d, zero) in enumerate(cases):
        args = conv_inputs(torch, batch, channels, length, k, i, zero)
        out = fn(*args, k, d)
        torch.cuda.synchronize()
        ref = asc.adain_snake_conv_plain(*args, k, d)
        err = float((out - ref).abs().max())
        tol = CONV_TOL * (1.0 + float(ref.abs().max()))
        if out.shape != (batch, channels, length):
            fail(f"{name} shape {tuple(out.shape)}")
        if zero and not torch.equal(out, args[-1][None, :, None].expand_as(
                out)):
            fail(f"{name}: an all-zero mask did not give the bias exactly")
        if not err <= tol:
            fail(f"{name} disagrees with plain at {cases[i]}: {err} > {tol}")
        worst = max(worst, err)
        del args, out, ref
    log(f"  {name}: {len(cases)} shapes, max|kernel - plain| = "
        f"{worst:.3e} (each within {CONV_TOL} * (1 + max|plain|))")
    return worst


def time_conv(torch, F, asc, name, flush, shape, reps=20):
    """Kernel, plain and cuDNN-conv ms at (B, C, L, k, d) + its bounds: the
    3xTF32 tensor-core bound of the kernels' arithmetic (three TF32
    products per multiply-add) and the f32 CUDA-core bound beside it."""
    batch, channels, length, k, d = shape
    args = conv_inputs(torch, batch, channels, length, k, seed=99)
    fn = getattr(asc, name)
    h = torch.randn_like(args[0])  # an activated input for cuDNN alone
    w_t = args[5].permute(2, 1, 0).contiguous()
    pad = (k - 1) * d // 2
    calls = {
        "ms": lambda: fn(*args, k, d),
        "plain_ms": lambda: asc.adain_snake_conv_plain(*args, k, d),
        "library_ms": lambda: F.conv1d(h, w_t, args[6], padding=pad,
                                       dilation=d),
    }
    for call in calls.values():
        call()
    out = {key: cuda_ms(call, reps, flush) for key, call in calls.items()}
    n_bytes = (2 * args[0].numel() + args[1].numel() + args[5].numel()) * 4
    n_ops = 2 * batch * length * channels * channels * k
    out["bound_ms"], out["bound_by"] = bound(n_bytes, 3 * n_ops,
                                             TF32_OPS_PER_S)
    out["bound_f32_ms"], _ = bound(n_bytes, n_ops)
    out["shape"] = [batch, channels, length, k, d]
    out["tile_len"] = asc.column_tile(batch, channels, length,
                                      torch.cuda.get_device_properties(0)
                                      .multi_processor_count)
    log(f"{name} at B={batch}, C={channels}, L={length}, k={k}, d={d} "
        f"({out['tile_len']}-column tiles): kernel {out['ms']:.4f} ms, "
        f"plain {out['plain_ms']:.4f} ms, cuDNN conv alone "
        f"{out['library_ms']:.4f} ms, bound {out['bound_ms']:.4f} ms "
        f"(3xTF32 {out['bound_by']}; f32 {out['bound_f32_ms']:.4f} ms)")
    return out


def time_carry_walk(torch, asc, flush, shape):
    """The carry kernel's walking chunks (the wrapper's choice where the
    carry buffer fits: about one wave of CTAs, one per SM) against one-tile
    chunks, which carry nothing; both must give the same bits."""
    batch, channels, length, k, d = shape
    args = conv_inputs(torch, batch, channels, length, k, seed=99)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    tile_len = asc.column_tile(batch, channels, length, sms)
    walk = asc.carry_tiles_per_chunk(batch, channels, channels, length, k, d,
                                     sms, tile_len)
    if walk == 1:
        fail(f"carry kernel: no walking chunks at {list(shape)}")
    fn = asc._library().adain_snake_conv_carry_f32

    def launch(per_chunk):
        return asc._launch(fn, *args, k, d, tile_len, per_chunk)

    if not torch.equal(launch(walk), launch(1)):
        fail(f"carry kernel: {walk}-tile chunks differ from one-tile chunks")
    out = {"shape": list(shape),
           "one_tile_chunks_ms": cuda_ms(lambda: launch(1), 20, flush),
           "walking_chunks_ms": cuda_ms(lambda: launch(walk), 20, flush),
           "walking_tiles_per_chunk": walk}
    log(f"adain_snake_conv_carry at {list(shape)}: one-tile chunks "
        f"{out['one_tile_chunks_ms']:.4f} ms, {walk}-tile walking chunks "
        f"{out['walking_chunks_ms']:.4f} ms (bitwise equal; the wrapper "
        "walks)")
    return out


def time_tile_lens(torch, asc, flush, shape):
    """The halo-tile kernel at each column tile, one tile a CTA: the source
    of the wrapper's ``TILE_COST``."""
    batch, channels, length, k, d = shape
    args = conv_inputs(torch, batch, channels, length, k, seed=99)
    fn = asc._library().adain_snake_conv_f32
    out = {}
    for tile_len in asc.TILE_LENS:
        asc._launch(fn, *args, k, d, tile_len, 1)
        out[tile_len] = cuda_ms(lambda: asc._launch(fn, *args, k, d,
                                                    tile_len, 1), 10, flush)
    tiles = {tl: -(-length // tl) for tl in out}
    log(f"adain_snake_conv at {list(shape)} by column tile: " + ", ".join(
        f"{tl}: {ms:.4f} ms ({ms / out[128] * tiles[128] / tiles[tl]:.2f} "
        "of a 128-column CTA's time)" for tl, ms in out.items()))
    return {"shape": list(shape), "ms_by_tile_len": out}


def recorded(fn, shapes):
    """``fn`` that also records each call's (B, C_in, L, k, d)."""
    def call(x, mask, scale, shift, alpha, w, b, kernel, dilation=1):
        shapes.add((x.shape[0], x.shape[1], x.shape[2], kernel, dilation))
        return fn(x, mask, scale, shift, alpha, w, b, kernel, dilation)
    return call


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke run needs a "
             "CUDA card")
    sys.path.insert(0, HERE)
    try:
        import numpy as np
        import torch.nn.functional as F

        from illufly_tts_tpu_torch.audio.telephony import (
            mulaw_decode_np,
            mulaw_encode_np,
        )
        from illufly_tts_tpu_torch.engine.synthesizer import Synthesizer
        from illufly_tts_tpu_torch.model import layers, vocoder
        from illufly_tts_tpu_torch.model.config import KokoroConfig
        from illufly_tts_tpu_torch.ops import adain_snake_conv as asc
        from illufly_tts_tpu_torch.ops import cuda_build
        from illufly_tts_tpu_torch.ops import istft_oa as oa
    except ImportError as exc:
        fail(f"the port's package is not beside this script: {exc}")

    # ---- 1. environment ---------------------------------------------------
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()
    log(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}, device {torch.cuda.get_device_name(0)}")
    log("TF32 off: torch.backends.cuda.matmul.allow_tf32 = False, "
        "torch.backends.cudnn.allow_tf32 = False")
    card = smi[0] if smi else "nvidia-smi gave nothing"
    log(card)

    # ---- 2. build ------------------------------------------------------------
    t0 = time.perf_counter()
    info = cuda_build.build(["istft_oa", "adain_snake_conv"])
    log(f"kernels built in {time.perf_counter() - t0:.2f} s")
    for name, rec in info.items():
        for line in rec["log"].splitlines():
            if any(key in line for key in ("entry function", "registers",
                                           "spill")):
                log(f"  {name}: {line.strip()}")

    # ---- 3. kernels vs plain -------------------------------------------------
    flush = torch.empty(64 * 2 ** 20, device="cuda")  # 256 MB > 50 MB L2
    log("istft_oa kernel vs plain (|randn| magnitudes, uniform phases):")
    istft_err = check_istft(torch, oa, [
        (8, 61440, False),  # B=8 at frame bucket 512 (120 frames per frame)
        (3, 1000, False),   # ragged: not a multiple of the 128-frame tile
        (2, 37, False),     # smaller than one tile
        (1, 4096, False),   # B=1
        (2, 256, True),     # zero input
    ])
    log("istft_head kernel vs plain (conv_post-like raw output):")
    head_err = check_head(torch, oa, [
        (8, 61440, False),   # B=8 at frame bucket 512
        (1, 11520, False),   # a B=1 stream window (64 + 2 * 16 frames)
        (1, 1, False),       # ragged: one frame
        (2, 37, False),      # shorter than one 252-frame tile
        (3, 1001, False),    # not a multiple of the tile or of 4
        (2, 4096, True),     # beyond both clip edges, one NaN
        (3, 1001, True),
    ])
    istft = time_istft(torch, oa, flush)

    cfg = KokoroConfig()
    # every (k, d) the config's residual blocks use, at both stages' widths
    inventory = sorted({(k, d) for k in (3, 7, 11) for d in (1, 3, 5)})
    stages = ((256, 10240), (128, 61440))  # (C, L) at B=8, F 512
    cases = [(8, c, length, k, d, False) for c, length in stages
             for k, d in inventory] + [
        (3, 128, 1000, 7, 3, False),   # ragged: not a multiple of the tile
        (2, 256, 37, 11, 5, False),    # shorter than a tile, > the halo
        (1, 128, 11520, 11, 5, False),  # B=1, a stream window's stage 1
        (1, 256, 1920, 7, 3, False),   # B=1, a stream window's stage 0
        (2, 256, 640, 3, 1, True),     # all-zero mask: the bias exactly
    ]
    log("fused conv kernels vs plain (odd rows masked after 2/3):")
    conv = {name: {"max_abs_err": check_conv(torch, asc, name, cases)}
            for name in CONV_KERNELS}
    for name in CONV_KERNELS:
        d = TIMED["dilation"][name]
        conv[name].update(time_conv(torch, F, asc, name, flush, (
            TIMED["batch"], TIMED["channels"], TIMED["length"],
            TIMED["kernel"], d)))
        conv[name]["more_shapes"] = [
            time_conv(torch, F, asc, name, flush,
                      (*shape[:4], shape[4] or d), reps=10)
            for shape in MORE_SHAPES]
    carry = conv["adain_snake_conv_carry"]
    # walking needs its carry buffer beside the two stage buffers: k <= 7
    # at C = 128 (at the timed k = 11, d = 5 the wrapper launches one-tile
    # chunks)
    carry["chunks"] = [time_carry_walk(torch, asc, flush, shape)
                       for shape in ((8, 128, 61440, 7, 3),
                                     (8, 128, 61440, 3, 5))]
    conv["adain_snake_conv"]["tile_lens"] = [
        time_tile_lens(torch, asc, flush, shape) for shape in
        (conv["adain_snake_conv"]["shape"], (1, 256, 1920, 7, 3))]

    # ---- 4. batch path ---------------------------------------------------------
    t0 = time.perf_counter()
    synth = Synthesizer(cfg, seed=0)
    synth.register_random_voice("smoke_voice", seed=0)
    log(f"Synthesizer(KokoroConfig(), seed=0) on {synth.device} in "
        f"{time.perf_counter() - t0:.1f} s")
    net = cfg.istftnet
    conv_per_generator = len(net.upsample_rates) * (
        3 + sum(len(d) for d in net.resblock_dilation_sizes))  # 24
    long_zh = " ".join([ZH, MIXED, ZH, MIXED, ZH])
    long_en = " ".join([EN, MIXED, EN, ZH])
    requests = {
        "zh_1": [ZH],
        "mixed_4": [ZH, MIXED, EN, ZH + " " + EN],
        "long_8": [long_zh, long_en] * 4,
    }
    failures = []
    conv_shapes = {name: set() for name in CONV_KERNELS}
    for name in CONV_KERNELS:  # the blocks call through the module names
        setattr(layers, name, recorded(getattr(asc, name), conv_shapes[name]))
    head_shapes = set()

    def head_recorded(x, n_fft, hop):
        head_shapes.add((x.shape[0], x.shape[2]))
        return oa.istft_head(x, n_fft, hop)

    vocoder.istft_head = head_recorded

    def voices(texts):
        return ["smoke_voice"] * len(texts)

    def reset_counts():
        oa.launches = 0
        for name in asc.launches:
            asc.launches[name] = 0

    def check_counts(label, generator_runs):
        counts = {"istft_oa": oa.launches, **asc.launches}
        want = {"istft_oa": generator_runs,
                **{name: conv_per_generator * generator_runs
                   for name in CONV_KERNELS}}
        log(f"{label}: {generator_runs} Generator runs, launches {counts}")
        for name, n in counts.items():
            if n == 0 or n != want[name]:
                failures.append(f"{label}: {name} launched {n} times, "
                                f"want {want[name]}")
        return counts

    def check_wave(label, wave, want):
        if wave.shape != (want,):
            failures.append(f"{label}: {wave.shape} != ({want},)")
        if wave.dtype == np.uint8:
            wave = mulaw_decode_np(wave)
        if not np.isfinite(wave).all():
            failures.append(f"{label}: non-finite audio")
        if float(np.abs(wave).max()) <= 1e-4:
            failures.append(f"{label}: silent")

    for texts in requests.values():  # warm pass
        synth.synthesize_batch(texts, voices(texts))
    torch.cuda.synchronize()

    reset_counts()
    stage_b_runs = 0
    timings = {}
    buckets = {}
    for name, texts in requests.items():
        torch.cuda.reset_peak_memory_stats()
        for fmt in FORMATS:
            t0 = time.perf_counter()
            h = synth.dispatch(texts, voices(texts), fmt=fmt)
            out = synth.collect(h)
            wall = time.perf_counter() - t0
            stage_b_runs += 1
            per_frame = 200 if fmt == "mulaw8k" else 600
            for i, wave in enumerate(out):
                check_wave(f"{name}/{fmt}[{i}]", wave,
                           int(h.fitted_totals[i]) * per_frame)
            if fmt.startswith("mulaw"):
                wire = h.audio.numpy()
                if wire.dtype != np.uint8 or wire.shape[1] != (
                        h.f_bucket * per_frame):
                    failures.append(f"{name}/{fmt}: wire {wire.dtype} "
                                    f"{wire.shape}")
            timings.setdefault(name, {})[fmt] = wall * 1e3
            if fmt == "pcm16":
                buckets[name] = (h.t_bucket, h.f_bucket)
                log(f"request {name}: B={len(texts)} (bucket {h.b_bucket}), "
                    f"T_bucket={h.t_bucket}, F_bucket={h.f_bucket}, frames "
                    f"{[int(t) for t in h.fitted_totals[: h.n]]}, audio "
                    f"{sum(w.size for w in out) / 24000:.1f} s")
        log(f"  wall ms (warm) " + ", ".join(
            f"{fmt} {ms:.1f}" for fmt, ms in timings[name].items())
            + f"; peak device memory "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    counts = check_counts("batch path", stage_b_runs)
    t_long, f_long = buckets["long_8"]
    if t_long < 128 or f_long < 512:
        failures.append(f"long_8 reached T_bucket={t_long}, F_bucket="
                        f"{f_long}; wanted >= 128 and >= 512")

    # ---- 5. streaming path ------------------------------------------------------
    texts = requests["mixed_4"]
    # run-to-run bit equality needs cuDNN's deterministic algorithms (the
    # transposed convs may otherwise sum in another order each run)
    torch.backends.cudnn.deterministic = True
    for fmt in ("f32", "pcm16"):
        h = synth.dispatch(texts, voices(texts), fmt=fmt)
        stream = np.concatenate(list(synth.stream_decode(
            h, window_frames=STREAM_WINDOW)), axis=1)
        fresh = synth.collect(synth.dispatch(texts, voices(texts), fmt=fmt))
        same = synth.collect(h)
        equal = all(stream[i, : clip.size].tobytes() == clip.tobytes()
                    == same[i].tobytes() for i, clip in enumerate(fresh))
        log(f"exact stream (mixed_4, {fmt}, {STREAM_WINDOW}-frame chunks) "
            f"bitwise equal to collect() of the same and of a fresh "
            f"dispatch: {equal}")
        if not equal:
            failures.append(f"exact stream {fmt} differs from collect()")
    h = synth.dispatch(texts, voices(texts), fmt="f32")
    args = (h.ids, h.mask, h.d, h.pred_dur, h.ref, h.pitch,
            synth._pick_f_bucket(h))
    with torch.inference_mode():
        codes = synth._stage_b(*args, "mulaw24k")[0].cpu().numpy()
        pcm = synth._stage_b(*args, "pcm16")[0].cpu().numpy()
    same_codes = np.array_equal(codes, mulaw_encode_np(pcm))
    log(f"mulaw24k bytes == mulaw_encode_np(the card's int16 render): "
        f"{same_codes}")
    if not same_codes:
        failures.append("mulaw24k bytes differ from mulaw_encode_np(pcm16)")
    torch.backends.cudnn.deterministic = False

    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()  # from dispatch, as the render's wall time
    h = synth.dispatch(texts, voices(texts), fmt="f32")
    gen = synth.stream_decode(h, STREAM_WINDOW, STREAM_HALO, exact=False)
    chunks = [next(gen)]
    first_ms = (time.perf_counter() - t0) * 1e3
    chunks += list(gen)
    stream_ms = (time.perf_counter() - t0) * 1e3
    windows = h.f_bucket // STREAM_WINDOW
    max_total = int(h.fitted_totals[: h.n].max())
    want_lens = [min(STREAM_WINDOW, max_total - lo) * 600
                 for lo in range(0, max_total, STREAM_WINDOW)]
    stream_counts = check_counts("windowed stream", len(chunks))
    if [c.shape for c in chunks] != [(h.n, n) for n in want_lens]:
        failures.append(f"windowed chunks {[c.shape for c in chunks]}, "
                        f"want {want_lens}")
    for i, c in enumerate(chunks):
        if not np.isfinite(c).all() or float(np.abs(c).max()) <= 1e-4:
            failures.append(f"windowed chunk {i}: non-finite or silent")
    log(f"windowed stream (mixed_4, window {STREAM_WINDOW} + halo "
        f"{STREAM_HALO} frames, F_bucket {h.f_bucket} = {windows} windows): "
        f"{len(chunks)} chunks, first after {first_ms:.1f} ms, all after "
        f"{stream_ms:.1f} ms; full render (pcm16, section 4) "
        f"{timings['mixed_4']['pcm16']:.1f} ms")
    for name in CONV_KERNELS:
        setattr(layers, name, getattr(asc, name))
    vocoder.istft_head = oa.istft_head

    log("kernels vs plain at the shapes both paths gave them:")
    for name in CONV_KERNELS:
        err = check_conv(torch, asc, name, [
            (*shape, False) for shape in sorted(conv_shapes[name])])
        conv[name]["max_abs_err"] = max(conv[name]["max_abs_err"], err)
    head_err = max(head_err, check_head(
        torch, oa, [(b, f, False) for b, f in sorted(head_shapes)]))

    # ---- 6. card vs CPU -----------------------------------------------------------
    t0 = time.perf_counter()
    cpu = Synthesizer(cfg, seed=0, device="cpu")
    cpu.register_random_voice("smoke_voice", seed=0)
    texts = [ZH, MIXED]
    with torch.inference_mode():
        hg = synth.dispatch(texts, voices(texts), fmt="f32")
        hc = cpu.dispatch(texts, voices(texts), fmt="f32")
        n_diff = int((hg.pred_dur.cpu() != hc.pred_dur).sum())
        args = (hg.ids, hg.mask, hg.d, hg.pred_dur, hg.ref, hg.pitch)
        wave_g, _ = synth._stage_b(*args, 128, "f32")
        wave_c, _ = cpu._stage_b(*(a.cpu() for a in args), 128, "f32")
    wave_g = wave_g.cpu().numpy()
    wave_c = wave_c.numpy()
    rms = float(np.sqrt(np.mean((wave_g - wave_c) ** 2)))
    scale = float(np.sqrt(np.mean(wave_c ** 2))) + 1e-9
    log(f"card vs CPU (full width, B=2, F_bucket=128): rms/scale "
        f"{rms / scale:.3e} (limit {CPU_GPU_TOL}), stage-A pred_dur entries "
        f"that differ: {n_diff} of {hg.pred_dur.numel()}, "
        f"{time.perf_counter() - t0:.1f} s")
    if not rms / scale < CPU_GPU_TOL:
        failures.append(f"card vs CPU rms/scale {rms / scale}")

    if failures:
        for f in failures:
            print(f"FAIL: {f}", file=sys.stderr)
        sys.exit(1)

    head = istft["head"]
    rows = [{
        "name": "istft_oa",
        "route": "cuda",
        "source": "illufly_tts_tpu_torch/csrc/istft_oa.cu",
        "replaces": "illufly_tts_tpu/ops/pallas/istft_oa.py:88",
        "launches": counts["istft_oa"],
        "launches_stream": stream_counts["istft_oa"],
        "stage_b_runs": stage_b_runs,
        "entry": "istft_head (conv_post's raw [B, 22, L] -> audio)",
        "max_abs_err": head_err,
        **{key: head[key] for key in ("ms", "plain_ms", "bound_ms",
                                      "bound_by", "eager_route_ms",
                                      "nearest_call_ms", "shape")},
        "library_ms": None,
        "library_note": "no single PyTorch call computes it: "
                        "torch.istft(center=False) refuses the zero window "
                        "envelope at sample 0 (NOLA check); nearest_call_ms "
                        "is torch.istft(center=True) on the same spectrum, "
                        "not the same function",
        "eager_route_note": "the Generator's head before this kernel: "
                            "clamp/exp, pi * sin, two channels-last copies, "
                            "then the polar entry",
        "window": istft["head_window"],
        "polar": {"entry": "istft_oa (mag, phase) [B, F, 11]",
                  "max_abs_err": istft_err, **istft["polar"]},
        "timing_floor": istft["floor"],
        "card": card,
    }]
    for name, (replaces, role) in CONV_KERNELS.items():
        rows.append({
            "name": name,
            "route": "cuda",
            "source": "illufly_tts_tpu_torch/csrc/adain_snake_conv.cu",
            "replaces": replaces,
            "launches": counts[name],
            "launches_stream": stream_counts[name],
            "stage_b_runs": stage_b_runs,
            "role": role,
            **conv[name],
            "library_note": "F.conv1d (cuDNN, TF32 off) alone on an "
                            "already activated input, with the bias",
            "bound_note": "3xTF32 tensor cores (3 x 2 B L C^2 k / 495e12); "
                          "bound_f32_ms: f32 CUDA cores (/ 67e12)",
            "card": card,
        })
    log(json.dumps({"kernels": rows}))
    log(json.dumps({"requests_wall_ms": timings,
                    "stream_first_chunk_ms": first_ms,
                    "stream_all_chunks_ms": stream_ms}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)


if __name__ == "__main__":
    main()
