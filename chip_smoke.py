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
   (B=2, frame bucket 128), both stage Bs fed the card's stage-A outputs;
7. serves text: ``TTSServiceManager(batch_size=4)`` over
   ``CachedTTSPipeline`` on phase 4's Synthesizer takes eight tasks from
   three users (zh with a date and a temperature, en with a time, a date
   and money, mixed zh/en, a blended voice, mulaw8k, word timestamps) and
   then a repeat of the first, and checks that every task completes in its
   user's sequence order with finite, non-silent audio of the length its
   fitted frames give, monotone timestamps within the audio, the IPA handed
   to ``dispatch`` equal to ``FRONTEND_TABLE``'s, every kernel launched as
   often as the Generator passes give, and no launch for the repeat (an
   audio-cache hit); then a ~260-character paragraph through
   ``process(segment_text=True)`` and one windowed ``stream_process``. On
   a host without ``jieba`` (which the Chinese G2P imports) the G2P's
   outputs come from ``FRONTEND_TABLE``; the normalizers, the pipeline, the
   scheduler and the model run as they are;
8. serves HTTP and MCP: first it times ``launch_decode`` on the host for a
   plain and a timestamped handle at long_8's shape beside that stage B's
   CUDA-event span (a timestamped launch must not wait for its own stage
   B); then the port's ``create_app`` over phase 7's pipeline, on
   loopback with a bearer token, answers ten requests one at a time
   (``/api/tts`` as WAV for a zh and a mixed text, as FLAC and as mulaw8k,
   ``/v1/audio/speech`` as FLAC, ``/api/tts/stream``, info, voices,
   ``/metrics`` and a repeat that the audio cache answers), and the port's
   MCP server over SSE answers ``text_to_speech`` and ``list_voices`` from
   the port's client. WAV bodies must equal the engine's own B=1 pcm16
   render bit for bit, FLAC bodies decode (CRC and MD5 checked) to the same
   samples, the mulaw8k payload equals the engine's bytes, the info route
   names a cuda device, the FLAC encoder is the native one, and every
   request launches the kernels exactly as often as its Generator passes
   give (none for the cache hits). Each request's client wall time, the
   server's FLAC encoding time and the share of the scheduler poll's 50 ms
   step are printed beside the card's name and power limit;
9. moves weights: ``save_params`` writes the engine's seeded weights as
   flax msgpack and ``load_params`` reads them into a second Synthesizer on
   the card: parameters and a B=1 pcm16 render must be bitwise equal
   (``load_params`` timed on the host);
10. trains at the full ``KokoroConfig()`` with the JAX ``train`` CLI's
   defaults (B=8, 64 tokens, 128 frames): ``train()`` for 3 steps on its
   synthetic-teacher batches (finite losses; step 0 against the port on the
   CPU on the same batch and weights), one batch's gradients through the
   kernels (``ops/kernel_grad.py``) against those through the plain
   versions (every leaf within ``GRAD_TOL``; the Generator's resblock convs,
   alphas and AdaIN fcs non-zero), forward/backward ms per step and each
   kernel's backward recompute at the training shape, one adversarial step,
   a checkpoint resumed (the next step's loss equal to an uninterrupted
   run's), and 3 ``adapt_voice`` steps on ``rendered_batches`` (a finite
   style, a non-zero style gradient). Every teacher-forced forward must
   launch each kernel as one Generator pass does; the backward launches
   none.

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
# phase 10: the JAX train CLI's defaults; step 0's duration loss, card vs
# CPU (stage A is plain f32 on both); each gradient leaf, through the
# kernels vs through the plain versions (relative L2: the 3xTF32 forward's
# ~1e-5 relative error per conv, grown through 48 convs and the exp head);
# the loss of the second step after a resume (the first is bitwise equal)
TRAIN = {"batch": 8, "tokens": 64, "frames": 128}
STEP0_DUR_TOL = 1e-4
GRAD_TOL = 1e-2
RESUME_STEP4_TOL = 1e-4
# leaves whose gradient is no stable number, held to 1e-3 of the global
# norm instead (tests/test_torch_training.py): the bias of a conv whose
# output goes through an instance norm (analytically zero), and the noise
# convs fed the spectrum of a silent harmonic source
DEGENERATE = r"\.conv1(_\d)?\.bias$|\.noise_conv_\d\."

ZH = "ni→xau↓ma, tsʰɤ↘ʂɨ↘i↗kɤ↘tʰəst."
MIXED = "tʰjɛn→tʃʰi↘tʃən→pu↗tsʰwo↘. hello wɝld."
EN = "ðɪs ɪz ə smˈoʊk tˈɛst ʌv ðə pˈɔɹt."
FORMATS = ("pcm16", "f32", "mulaw8k", "mulaw24k")
STREAM_WINDOW, STREAM_HALO = 64, 16   # model frames

# phase 7, text in: the scheduler's tasks as (user, sequence_id, text,
# voice, output format, word timestamps); REPEAT, sent once they are done,
# repeats the first and must come from the pipeline's audio cache
BLEND = "smoke_voice*0.7+smoke_voice_b*0.3"
TASKS = (
    ("alice", 1, "今天是2024年3月5日，气温25℃。", "smoke_voice", "pcm16",
     False),
    ("bob", 1, "The meeting starts at 3:30 PM on June 1st and costs $42.",
     "smoke_voice", "pcm16", False),
    ("carol", 1, "我们用Python写了一个TTS服务，效果很好。", "smoke_voice",
     "pcm16", False),
    ("alice", 2, "请在下午三点之前提交报告。", BLEND, "pcm16", False),
    ("bob", 2, "Please hold the line, your call is important to us.",
     "smoke_voice", "mulaw8k", False),
    ("carol", 2, "今天天气真好，我们去公园散步。", "smoke_voice", "pcm16", True),
    ("alice", 3, "欢迎使用语音合成服务。", "smoke_voice", "f32", False),
    ("bob", 3, "Thank you for calling, goodbye.", "smoke_voice", "f32", False),
)
REPEAT = ("alice", 4) + TASKS[0][2:]
WARM_TEXTS = ("预热一下。", "Warm up once.")
PARAGRAPH = (
    "清晨六点，城市还没有完全醒来。街道两旁的路灯依次熄灭，早餐店的老板已经忙着"
    "蒸包子、煮豆浆。公交车载着第一批乘客驶过大桥，江面上飘着薄薄的雾。七点半以"
    "后，上班的人越来越多，地铁站里排起了长队。学校门口，家长们叮嘱孩子注意安全，"
    "老师微笑着迎接每一位学生。中午的阳光很温暖，公园里有人下棋，有人散步，还有人"
    "坐在长椅上读报纸。到了傍晚，商场的灯光亮起来，年轻人约朋友一起吃饭、看电影。"
    "据统计，这座城市去年接待游客超过3200万人次，比前年增长了12.5%。夜深了，城"
    "市慢慢安静下来，只有远处的货车还在运送明天需要的蔬菜和水果。"
)
STREAM_TEXT = ("欢迎收听今天的新闻。This is the evening report, with the "
               "weather and the traffic.")
# every text phase 7 hands the frontend, in the order frontend_table walks
FRONTEND_TEXTS = (WARM_TEXTS + tuple(task[2] for task in TASKS)
                  + (PARAGRAPH, STREAM_TEXT))

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


def recorded_head(fn, shapes):
    """The iSTFT head ``fn`` that also records each call's (B, L)."""
    def call(x, n_fft, hop):
        shapes.add((x.shape[0], x.shape[2]))
        return fn(x, n_fft, hop)
    return call


def record_shapes(layers, vocoder, asc, oa):
    """Route the Generator's kernel calls through recorders -> (conv shapes
    by kernel, head shapes); ``unrecord`` routes them back."""
    conv_shapes = {name: set() for name in CONV_KERNELS}
    for name in CONV_KERNELS:  # the blocks call through the module names
        setattr(layers, name, recorded(getattr(asc, name), conv_shapes[name]))
    head_shapes = set()
    vocoder.istft_head = recorded_head(oa.istft_head, head_shapes)
    return conv_shapes, head_shapes


def unrecord(layers, vocoder, asc, oa):
    for name in CONV_KERNELS:
        setattr(layers, name, getattr(asc, name))
    vocoder.istft_head = oa.istft_head


def frontend_table(pipe):
    """The text frontend's whole output for phase 7: ``{"normalized":
    {text: preprocess_text(text)}, "g2p": {G2P input: [phonemes, IPA]},
    "words": {G2P input: word IPA pairs}}`` for ``FRONTEND_TEXTS`` (words
    for the timestamped tasks' texts), through the frontend of ``pipe``, a
    frontend-only ``TTSPipeline`` (the port's or the JAX package's: both
    take the same calls). The paragraph goes through ``segment_text`` and
    ``_ipa_within_budget`` as ``process(..., segment_text=True)`` sends
    it, which split it into G2P inputs."""
    g2p = pipe.g2p
    inputs = []

    class Recorder:
        def text_to_phonemes(self, text):
            inputs.append(text)
            return g2p.text_to_phonemes(text)

        def convert_to_ipa(self, phonemes):
            return g2p.convert_to_ipa(phonemes)

    normalized = {text: pipe.preprocess_text(text) for text in FRONTEND_TEXTS}
    pipe.g2p = Recorder()
    try:
        for text, norm in normalized.items():
            if text == PARAGRAPH:
                for segment in pipe.segment_text(norm):
                    pipe._ipa_within_budget(segment)
            else:
                pipe.text_to_phonemes(norm)
    finally:
        pipe.g2p = g2p
    table = {}
    for text in inputs:
        phonemes = g2p.text_to_phonemes(text)
        table[text] = [phonemes, g2p.convert_to_ipa(phonemes)]
    words = {normalized[task[2]]: [list(w) for w in g2p.text_to_ipa_words(
        normalized[task[2]])] for task in TASKS if task[5]}
    return {"normalized": normalized, "g2p": table, "words": words}


class FrozenG2P:
    """``ChineseG2P``'s outputs for phase 7's G2P inputs, read from
    ``FRONTEND_TABLE`` (the JAX package's frontend froze them; see
    ``frontend_table``). It stands in for the G2P on a host without
    ``jieba``, which the Chinese G2P imports; a text outside the table
    raises KeyError."""

    def __init__(self, table):
        self.table = table
        self.ipa = dict(table["g2p"].values())

    def text_to_phonemes(self, text):
        return self.table["g2p"][text][0]

    def convert_to_ipa(self, phonemes):
        return self.ipa[phonemes]

    def text_to_ipa_words(self, text):
        return [tuple(w) for w in self.table["words"][text]]


def frozen_frontend(pipeline_cls):
    """``pipeline_cls`` with the real normalizers and ``FrozenG2P``."""
    from illufly_tts_tpu_torch import pipeline as pmod

    class FrozenFrontendPipeline(pipeline_cls):
        def _init_frontend(self, british):
            self.british = british
            self.en_g2p = self.en_callback = None
            self.g2p = FrozenG2P(FRONTEND_TABLE)
            self.zh_normalizer = pmod.ZhTextNormalizer()
            self.en_normalizer = pmod.EnTextNormalizer()

    return FrozenFrontendPipeline


def text_pipeline(synth, failures):
    """The ``CachedTTSPipeline`` phases 7 and 8 serve text with, on
    ``synth``: with the live frontend where ``jieba`` imports (held to
    ``FRONTEND_TABLE``), else with ``FrozenG2P``. -> (pipeline, which
    frontend)."""
    from illufly_tts_tpu_torch.pipeline import CachedTTSPipeline, TTSPipeline

    try:
        import jieba  # noqa: F401  (the Chinese G2P needs it)
    except ImportError:
        jieba = None
    if jieba is None:
        log("frontend: frozen table (jieba absent on this host)")
        pipe_cls = frozen_frontend(CachedTTSPipeline)
    else:
        live = TTSPipeline.__new__(TTSPipeline)
        live._init_frontend_only()
        same = frontend_table(live) == FRONTEND_TABLE
        log(f"frontend: live (jieba {jieba.__version__}); its output for "
            f"phase 7's texts equals the frozen table: {same}")
        if not same:
            failures.append("the live frontend differs from FRONTEND_TABLE")
        pipe_cls = CachedTTSPipeline
    t0 = time.perf_counter()
    synth.register_random_voice("smoke_voice_b", seed=1)
    pipe = pipe_cls(synthesizer=synth)
    log(f"{pipe_cls.__name__}(synthesizer=synth) in "
        f"{time.perf_counter() - t0:.2f} s")
    return pipe, "frozen table" if jieba is None else "live"


def serving_phase(torch, np, synth, pipe, frontend, oa, asc,
                  conv_per_generator, card, failures, check_wave):
    """Phase 7: text requests through ``TTSServiceManager`` and
    ``CachedTTSPipeline`` on the card, then a segmented paragraph through
    ``process`` and a windowed ``stream_process``. -> the summary dict."""
    import asyncio
    import tempfile

    from illufly_tts_tpu_torch.pipeline import MAX_PHONEMES
    from illufly_tts_tpu_torch.runtime.scheduler import (
        TaskStatus,
        TTSServiceManager,
    )

    g2p_table = FRONTEND_TABLE["g2p"]
    t0 = time.perf_counter()
    pipe.batch_process_texts(list(WARM_TEXTS), ["smoke_voice"] * 2)
    torch.cuda.synchronize()
    log(f"warm pass (frontend first use + one batch): "
        f"{time.perf_counter() - t0:.2f} s")
    for text in FRONTEND_TEXTS:
        if pipe.preprocess_text(text) != FRONTEND_TABLE["normalized"][text]:
            failures.append(f"normalized text differs from the table: "
                            f"{text!r}")

    # every Generator pass of stage B, and what reaches dispatch
    passes, dispatched = [], []
    stage_b, dispatch = synth._stage_b, synth.dispatch

    def counted_stage_b(*args):
        passes.append(1)
        return stage_b(*args)

    def recorded_dispatch(phonemes_list, voice_ids, *args, **kw):
        handle = dispatch(phonemes_list, voice_ids, *args, **kw)
        dispatched.append((list(phonemes_list), list(voice_ids), handle))
        return handle

    def reset():
        oa.launches = 0
        for name in asc.launches:
            asc.launches[name] = 0
        passes.clear()
        dispatched.clear()

    def counts(label, generator_passes):
        got = {"istft_oa": oa.launches, **asc.launches}
        want = {"istft_oa": generator_passes,
                **{name: conv_per_generator * generator_passes
                   for name in asc.launches}}
        log(f"{label}: {generator_passes} Generator passes, launches {got}")
        if got != want:
            failures.append(f"{label}: launches {got}, want {want}")
        return got

    def frames_of():
        """(IPA, voice) -> fitted frames, over this run's dispatches."""
        return {(ipa, voice): int(h.fitted_totals[i])
                for ipa_list, voices, h in dispatched
                for i, (ipa, voice) in enumerate(zip(ipa_list, voices))}

    def expected_ipa(text):
        return g2p_table[FRONTEND_TABLE["normalized"][text]][1][
            :MAX_PHONEMES]

    async def run(manager, tasks):
        """Submit ``tasks`` and wait for them -> [(task, submit time)]."""
        sent = []
        for user, seq, text, voice, fmt, stamps in tasks:
            t_submit = time.time()
            tid = await manager.submit_task(
                text, voice, user_id=user, sequence_id=seq,
                output_format=fmt, return_timestamps=stamps)
            sent.append((manager.tasks[tid], t_submit))
        deadline = time.monotonic() + 300.0
        while any(task.status in (TaskStatus.PENDING, TaskStatus.PROCESSING)
                  for task, _ in sent):
            if time.monotonic() > deadline:
                raise TimeoutError("phase 7 tasks did not finish in 300 s")
            await asyncio.sleep(0.005)
        return sent

    async def serve(out_dir):
        manager = TTSServiceManager(pipeline=pipe, batch_size=4,
                                    output_dir=out_dir)
        await manager.start()
        try:
            reset()
            first = await run(manager, TASKS)
            torch.cuda.synchronize()
            served = (counts("serving path (8 text requests)", len(passes)),
                      len(passes), frames_of(), list(dispatched))
            reset()
            repeat = await run(manager, [REPEAT])
            cached = counts("cache-hit request", 0)
            if passes or dispatched:
                failures.append("the cache-hit request reached the "
                                "Synthesizer")
            return manager.stats(), first, repeat, served, cached
        finally:
            await manager.shutdown()

    synth._stage_b, synth.dispatch = counted_stage_b, recorded_dispatch
    try:
        with tempfile.TemporaryDirectory() as out_dir:
            stats, first, repeat, served, cached = asyncio.run(
                serve(out_dir))

        launches, generator_passes, frames, sent_batches = served
        per_task = []
        for (task, t_submit), spec in zip(first + repeat, TASKS + (REPEAT,)):
            user, seq, text, voice, fmt, stamps = spec
            label = (f"task {user}/{seq} ({fmt}"
                     f"{', timestamps' if stamps else ''}"
                     f"{', blend' if voice == BLEND else ''})")
            wall_ms = ((task.completed_at or time.time()) - t_submit) * 1e3
            per_task.append({"user": user, "sequence_id": seq, "format": fmt,
                             "voice": voice, "timestamps": stamps,
                             "status": task.status.value,
                             "wall_ms": wall_ms})
            log(f"  {label}: {task.status.value} in {wall_ms:.1f} ms "
                "(submit_task to result, host clock)")
            if task.status != TaskStatus.COMPLETED:
                failures.append(f"{label}: {task.status.value} "
                                f"({task.error})")
                continue
            ipa = expected_ipa(text)
            n_frames = frames.get((ipa, voice))
            if n_frames is None:
                failures.append(f"{label}: its frozen-table IPA never "
                                "reached dispatch")
                continue
            audio = task.audio_chunks[0]
            check_wave(label, audio,
                        n_frames * (200 if fmt == "mulaw8k" else 600))
            if stamps:
                words = task.timestamps or []
                dur = audio.size / 24000
                ends = [0.0] + [w["end_s"] for w in words]
                if not words or any(
                        not (ends[i] - 1e-6 <= w["start_s"] <= w["end_s"]
                             <= dur + 1e-6) for i, w in enumerate(words)):
                    failures.append(f"{label}: timestamps not monotone "
                                    f"within the audio: {words}")
                log(f"    {len(words)} words, last ends at "
                    f"{words[-1]['end_s'] if words else None} s of "
                    f"{dur:.3f} s")
        if not np.array_equal(first[0][0].audio_chunks[0],
                              repeat[0][0].audio_chunks[0]):
            failures.append("the cache-hit request's audio differs from "
                            "the first")
        sent_ipa = {ipa for ipa_list, _, _ in sent_batches
                    for ipa in ipa_list}
        want_ipa = {expected_ipa(task[2]) for task in TASKS}
        log(f"IPA handed to dispatch equals the frozen table's for all "
            f"{len(want_ipa)} texts: {sent_ipa == want_ipa}; batches "
            f"{[len(b[0]) for b in sent_batches]}")
        if sent_ipa != want_ipa:
            failures.append(f"dispatched IPA {sorted(sent_ipa)} != table "
                            f"{sorted(want_ipa)}")
        for user in {task[0] for task in TASKS}:
            done = [task.completed_at or 0.0
                    for (task, _), spec in zip(first + repeat,
                                               TASKS + (REPEAT,))
                    if spec[0] == user]
            if done != sorted(done):
                failures.append(f"user {user}'s tasks finished out of "
                                "sequence order")
        log(f"scheduler stats: {json.dumps(stats)}")

        # a paragraph, segmented, through process()
        reset()
        t0 = time.perf_counter()
        audio = pipe.process(PARAGRAPH, "smoke_voice", segment_text=True)
        paragraph_ms = (time.perf_counter() - t0) * 1e3
        pieces = [(ipa_list[0], h) for ipa_list, _, h in dispatched]
        para_launches = counts(f"paragraph ({len(pieces)} pieces)",
                               len(passes))
        table_ipa = {row[1] for row in g2p_table.values()}
        if any(ipa not in table_ipa or len(ipa) > MAX_PHONEMES
               for ipa, _ in pieces):
            failures.append("a paragraph piece is not a frozen-table IPA "
                            f"within {MAX_PHONEMES} phonemes")
        check_wave("paragraph", audio,
                    sum(int(h.fitted_totals[0]) for _, h in pieces) * 600)
        log(f"paragraph ({len(PARAGRAPH)} characters, segment_text=True): "
            f"{len(pieces)} pieces, {audio.size / 24000:.2f} s of audio in "
            f"{paragraph_ms:.1f} ms")

        # one windowed stream
        reset()
        t0 = time.perf_counter()
        gen = pipe.stream_process(STREAM_TEXT, "smoke_voice",
                                  window_frames=STREAM_WINDOW,
                                  halo_frames=STREAM_HALO, exact=False)
        chunks = [next(gen)]
        first_chunk_ms = (time.perf_counter() - t0) * 1e3
        chunks += list(gen)
        stream_ms = (time.perf_counter() - t0) * 1e3
        (ipa_list, _, h), = dispatched
        total = int(h.fitted_totals[0])
        windows = -(-total // STREAM_WINDOW)
        stream_launches = counts(f"windowed stream ({windows} windows)",
                                 windows)
        if ipa_list != [expected_ipa(STREAM_TEXT)]:
            failures.append("the stream's IPA differs from the table's")
        check_wave("windowed stream", np.concatenate(chunks), total * 600)
        log(f"windowed stream_process ({STREAM_WINDOW} + {STREAM_HALO} "
            f"frames): {len(chunks)} chunks, first after "
            f"{first_chunk_ms:.1f} ms, all after {stream_ms:.1f} ms")
    finally:
        del synth._stage_b, synth.dispatch
    return {
        "card": card,
        "frontend": frontend,
        "tasks": per_task,
        "generator_passes": generator_passes,
        "launches": launches,
        "launches_cache_hit": cached,
        "scheduler_stats": stats,
        "paragraph": {"characters": len(PARAGRAPH), "pieces": len(pieces),
                      "ms": paragraph_ms, "launches": para_launches},
        "stream": {"windows": windows, "first_chunk_ms": first_chunk_ms,
                   "all_chunks_ms": stream_ms, "launches": stream_launches},
    }


def riff_data(body):
    """The payload of a RIFF/WAVE body's ``data`` chunk (chunk walk: the
    mu-law WAV carries a ``fact`` chunk before it)."""
    import struct

    pos = 12
    while pos + 8 <= len(body):
        cid = body[pos:pos + 4]
        size = struct.unpack("<I", body[pos + 4:pos + 8])[0]
        if cid == b"data":
            return body[pos + 8:pos + 8 + size]
        pos += 8 + size + (size % 2)
    raise ValueError("no data chunk")


def repair_timing(torch, synth, texts, failures):
    """The host time of ``launch_decode`` beside the CUDA-event span of the
    stage B it launches, on ``texts`` (long_8's shape), for a plain and a
    timestamped (``keep_durations``) handle. Stage A has finished before the
    call, so the span is stage B and the audio copy. A timestamped handle's
    durations were copied to the host at dispatch, so its launch must not
    wait for its own stage B."""
    voices = ["smoke_voice"] * len(texts)
    out = {}
    for keep in (False, True):
        torch.cuda.synchronize()
        h = synth.dispatch(texts, voices, keep_durations=keep)
        synth._pick_f_bucket(h)
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        t0 = time.perf_counter()
        synth.launch_decode(h)
        host_ms = (time.perf_counter() - t0) * 1e3
        end.record()
        end.synchronize()
        span_ms = start.elapsed_time(end)
        label = "timestamped" if keep else "plain"
        out[label] = {"launch_decode_host_ms": host_ms,
                      "stage_b_span_ms": span_ms,
                      "shape": [h.b_bucket, h.t_bucket, h.f_bucket]}
        log(f"launch_decode on a {label} handle at long_8's shape "
            f"(B={h.b_bucket}, T={h.t_bucket}, F={h.f_bucket}): host "
            f"{host_ms:.2f} ms, its stage B's span {span_ms:.2f} ms "
            f"({host_ms / span_ms:.3f} of it)")
        if keep:
            if host_ms > 0.5 * span_ms:
                failures.append(f"a timestamped launch_decode held the host "
                                f"{host_ms:.1f} ms of its stage B's "
                                f"{span_ms:.1f} ms")
            dur = synth.rendered_durations(h)
            if list(dur.sum(axis=1)) != list(h.fitted_totals[: h.n]):
                failures.append("rendered_durations disagree with the "
                                "fitted frame totals")
        synth.collect(h)
    return out


def http_phase(torch, np, synth, pipe, oa, asc, conv_per_generator, card,
               failures):
    """Phase 8: the port's ``create_app`` and MCP server over phase 7's
    pipeline, served on loopback and requested one at a time. -> the
    summary dict."""
    import asyncio
    import base64
    import tempfile

    import aiohttp
    from aiohttp import web

    from illufly_tts_tpu_torch.api import endpoints
    from illufly_tts_tpu_torch.api.auth import create_access_token
    from illufly_tts_tpu_torch.audio import flac as flac_mod
    from illufly_tts_tpu_torch.client.mcp_client import TTSMcpClient
    from illufly_tts_tpu_torch.mcp.server import ManagerBackend, MCPServer

    voice = "smoke_voice"
    zh, mixed, speech, streamed = (TASKS[0][2], TASKS[2][2], TASKS[3][2],
                                   TASKS[6][2])
    # (label, method, path, JSON body, Generator passes it should take):
    # the FLAC request shares the WAV request's pcm16 render, so it and the
    # repeat come from the pipeline's audio cache
    requests = (
        ("tts wav zh", "POST", "/api/tts", {"text": zh, "voice_id": voice}, 1),
        ("tts wav mixed", "POST", "/api/tts",
         {"text": mixed, "voice_id": voice}, 1),
        ("tts flac zh", "POST", "/api/tts",
         {"text": zh, "voice_id": voice, "format": "flac"}, 0),
        ("tts mulaw8k zh", "POST", "/api/tts",
         {"text": zh, "voice_id": voice, "format": "mulaw8k"}, 1),
        ("openai speech flac", "POST", "/v1/audio/speech",
         {"model": "kokoro", "input": speech, "voice": voice,
          "response_format": "flac"}, 1),
        ("tts stream", "POST", "/api/tts/stream",
         {"text": streamed, "voice_id": voice}, 1),
        ("info", "GET", "/api/tts/info", None, 0),
        ("voices", "GET", "/api/tts/voices", None, 0),
        ("metrics", "GET", "/metrics", None, 0),
        ("tts wav zh repeat", "POST", "/api/tts",
         {"text": zh, "voice_id": voice}, 0),
    )
    passes = []
    stage_b = synth._stage_b

    def counted_stage_b(*args):
        passes.append(1)
        return stage_b(*args)

    flac_ms = []
    encode_flac = flac_mod.encode_flac

    def timed_encode_flac(*args, **kwargs):
        t0 = time.perf_counter()
        try:
            return encode_flac(*args, **kwargs)
        finally:
            flac_ms.append((time.perf_counter() - t0) * 1e3)

    def reset():
        oa.launches = 0
        for name in asc.launches:
            asc.launches[name] = 0
        passes.clear()

    def check_launches(label, want_passes):
        got = {"istft_oa": oa.launches, **asc.launches}
        want = {"istft_oa": want_passes,
                **{name: conv_per_generator * want_passes
                   for name in asc.launches}}
        if len(passes) != want_passes or got != want:
            failures.append(f"{label}: {len(passes)} Generator passes, "
                            f"launches {got}, want {want}")
        return got

    async def serve(app):
        # the SSE handler of a closed session waits for the app's cleanup,
        # which comes after the shutdown wait: keep that wait short
        runner = web.AppRunner(app, shutdown_timeout=2.0)
        await runner.setup()
        site = web.TCPSite(runner, "127.0.0.1", 0)
        await site.start()
        return runner, runner.addresses[0][1]

    async def http(out_dir, token):
        app = endpoints.create_app(pipeline=pipe, max_wait_time=0.1,
                                   batch_size=4, output_dir=out_dir)
        runner, port = await serve(app)
        results = []
        try:
            manager = app["service_manager"]
            headers = {"Authorization": f"Bearer {token}"}
            async with aiohttp.ClientSession(headers=headers) as session:
                for label, method, path, body, want_passes in requests:
                    known = set(manager.tasks)
                    flac_ms.clear()
                    reset()
                    t0 = time.perf_counter()
                    async with session.request(
                            method, f"http://127.0.0.1:{port}{path}",
                            json=body) as resp:
                        payload = await resp.read()
                    wall_ms = (time.perf_counter() - t0) * 1e3
                    t_recv = time.time()
                    got = check_launches(label, want_passes)
                    done = [manager.tasks[t].completed_at
                            for t in set(manager.tasks) - known]
                    poll_ms = ((t_recv - max(done)) * 1e3
                               if done and all(done) else None)
                    results.append({
                        "label": label, "status": resp.status,
                        "body": payload, "wall_ms": wall_ms,
                        "generator_passes": len(passes), "launches": got,
                        "server_flac_ms": sum(flac_ms) if flac_ms else None,
                        "completed_to_response_ms": poll_ms,
                    })
        finally:
            await runner.cleanup()
        return results

    async def mcp(out_dir):
        backend = ManagerBackend(pipeline=pipe, batch_size=4,
                                 max_wait_time=0.1, output_dir=out_dir)
        runner, port = await serve(MCPServer(backend).create_sse_app())
        try:
            reset()
            t0 = time.perf_counter()
            async with TTSMcpClient(host="127.0.0.1", port=port,
                                    timeout=300.0) as client:
                spoken = await client.text_to_speech(zh, voice=voice)
                wall_ms = (time.perf_counter() - t0) * 1e3
                listed = await client.list_voices()
            got = check_launches("MCP text_to_speech", 1)
            return spoken, listed, wall_ms, got
        finally:
            await runner.cleanup()

    os.environ.pop("TTS_DEV_MODE", None)
    os.environ.pop("TTS_MCP_TOKEN", None)
    os.environ.pop("TTS_METRICS_PUBLIC", None)
    os.environ["FASTAPI_SECRET_KEY"] = os.urandom(16).hex()
    token = create_access_token("smoke_user")
    # run-to-run bit equality with the engine's own render below
    torch.backends.cudnn.deterministic = True
    pipe.clear_caches()
    synth._stage_b, flac_mod.encode_flac = counted_stage_b, timed_encode_flac
    try:
        with tempfile.TemporaryDirectory() as out_dir:
            results = asyncio.run(http(out_dir, token))
            spoken, listed, mcp_ms, mcp_launches = asyncio.run(mcp(out_dir))
    finally:
        del synth._stage_b
        flac_mod.encode_flac = encode_flac
    torch.backends.cudnn.deterministic = False
    native = flac_mod._get_lib() is not None

    by_label = {r["label"]: r for r in results}
    for r in results:
        if r["status"] != 200:
            failures.append(f"{r['label']}: HTTP {r['status']}: "
                            f"{r['body'][:200]!r}")
    if any(r["status"] != 200 for r in results):
        return {"requests": [{k: v for k, v in r.items() if k != "body"}
                             for r in results]}

    def envelope(label):
        return json.loads(by_label[label]["body"])

    def audio_of(label):
        return base64.b64decode(envelope(label)["audio_base64"])

    # the engine's own B=1 renders of the same texts, with the audio cache
    # cleared so each renders anew
    pipe.clear_caches()
    torch.backends.cudnn.deterministic = True
    engine = {(text, fmt): pipe.batch_process_texts(
        [text], [voice], output_format=fmt)[0]
        for text, fmt in ((zh, "pcm16"), (mixed, "pcm16"), (zh, "mulaw8k"),
                          (speech, "pcm16"), (streamed, "f32"))}
    torch.backends.cudnn.deterministic = False
    checks = {}
    for label, text in (("tts wav zh", zh), ("tts wav mixed", mixed),
                        ("tts wav zh repeat", zh)):
        pcm = np.frombuffer(riff_data(audio_of(label)), "<i2")
        checks[label] = np.array_equal(pcm, engine[(text, "pcm16")])
    wav_zh = np.frombuffer(riff_data(audio_of("tts wav zh")), "<i2")
    flac_zh, rate = flac_mod.decode_flac(audio_of("tts flac zh"))
    checks["tts flac zh"] = (rate == 24000 and np.array_equal(flac_zh, wav_zh)
                             and envelope("tts flac zh")["format"] == "flac")
    checks["tts mulaw8k zh"] = (
        riff_data(audio_of("tts mulaw8k zh"))
        == engine[(zh, "mulaw8k")].tobytes()
        and envelope("tts mulaw8k zh")["sample_rate"] == 8000)
    speech_pcm, rate = flac_mod.decode_flac(
        by_label["openai speech flac"]["body"])
    checks["openai speech flac"] = (
        rate == 24000 and np.array_equal(speech_pcm, engine[(speech, "pcm16")]))
    stream_body = by_label["tts stream"]["body"]
    stream_pcm = np.frombuffer(stream_body[44:], "<i2")
    checks["tts stream"] = (stream_body[:4] == b"RIFF"
                            and stream_pcm.size == engine[(streamed,
                                                           "f32")].size
                            and int(np.abs(stream_pcm).max()) > 0)
    info = envelope("info")
    checks["info"] = str(info.get("device", "")).startswith("cuda")
    checks["voices"] = voice in {v["id"] for v in envelope("voices")["voices"]}
    metrics = by_label["metrics"]["body"].decode()
    checks["metrics"] = "tts_tasks_completed_total" in metrics
    checks["native flac encoder"] = native
    mcp_wav = (base64.b64decode(spoken["audio_base64"])
               if isinstance(spoken, dict)
               and spoken.get("status") == "success" else b"")
    checks["mcp text_to_speech"] = (
        len(mcp_wav) == len(audio_of("tts wav zh")) and mcp_wav[:4] == b"RIFF")
    checks["mcp list_voices"] = voice in {v.get("id") for v in listed}
    for label, ok in checks.items():
        if not ok:
            failures.append(f"phase 8 check failed: {label}")
    log(f"HTTP/MCP checks (WAV bodies bitwise equal to the engine's B=1 "
        f"pcm16 render, FLAC lossless to them, mulaw8k equal to the "
        f"engine's bytes, info device {info.get('device')!r}, native FLAC "
        f"encoder {native}): {json.dumps(checks)}")

    rows = []
    for r in results:
        share = 50.0 / r["wall_ms"]
        rows.append({k: v for k, v in r.items() if k != "body"}
                    | {"poll_step_share": share})
        extra = (f", FLAC encode on the server {r['server_flac_ms']:.2f} ms"
                 if r["server_flac_ms"] is not None else "")
        poll = (f", completed -> response {r['completed_to_response_ms']:.1f}"
                f" ms" if r["completed_to_response_ms"] is not None else "")
        log(f"  {r['label']}: HTTP {r['status']}, {len(r['body'])} bytes in "
            f"{r['wall_ms']:.1f} ms (client wall; the 50 ms poll step is "
            f"{share:.2f} of it){poll}{extra}; {r['generator_passes']} "
            f"Generator passes [{card}]")
    log(f"  MCP over SSE: text_to_speech {len(mcp_wav)} bytes and "
        f"list_voices in {mcp_ms:.1f} ms (client wall, connect included) "
        f"[{card}]")
    total = {name: sum(r["launches"][name] for r in results)
             for name in results[0]["launches"]}
    return {"card": card, "requests": rows, "launches": total,
            "mcp": {"wall_ms": mcp_ms, "wav_bytes": len(mcp_wav),
                    "launches": mcp_launches},
            "checks": checks, "native_flac": native}


def weights_phase(torch, synth, cfg, card, failures, reset_counts,
                  check_counts):
    """Phase 9: the engine's weights to flax msgpack (``save_params``) and
    into a second Synthesizer on the card (``load_params``): parameters and
    a B=1 pcm16 render bitwise equal. -> the summary dict."""
    import tempfile

    from illufly_tts_tpu_torch.engine.synthesizer import Synthesizer

    torch.backends.cudnn.deterministic = True
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "weights.msgpack")
        t0 = time.perf_counter()
        synth.save_params(path)
        save_ms = (time.perf_counter() - t0) * 1e3
        size = os.path.getsize(path)
        other = Synthesizer(  # other weights until the load
            cfg, seed=1, token_buckets=synth.token_buckets,
            frame_buckets=synth.frame_buckets,
            batch_buckets=synth.batch_buckets)
        t0 = time.perf_counter()
        other.load_params(path)
        torch.cuda.synchronize()
        load_ms = (time.perf_counter() - t0) * 1e3
    ours, theirs = synth.model.state_dict(), other.model.state_dict()
    same_params = ours.keys() == theirs.keys() and all(
        torch.equal(value, theirs[name]) for name, value in ours.items())
    other.register_random_voice("smoke_voice", seed=0)
    reset_counts()
    renders = [engine.collect(engine.dispatch([ZH], ["smoke_voice"],
                                              fmt="pcm16"))[0]
               for engine in (synth, other)]
    counts = check_counts("weights: two B=1 pcm16 renders", 2)
    same_audio = renders[0].tobytes() == renders[1].tobytes()
    torch.backends.cudnn.deterministic = False
    del other, theirs
    torch.cuda.empty_cache()
    log(f"weights: save_params {save_ms:.1f} ms ({size / 2**20:.1f} MiB "
        f"flax msgpack), load_params into a second Synthesizer on the card "
        f"{load_ms:.1f} ms (host clock, placement included; {card}); "
        f"parameters bitwise equal: {same_params}; B=1 pcm16 renders "
        f"({renders[0].size} samples) bitwise equal: {same_audio}")
    if not same_params:
        failures.append("load_params(save_params) changed the parameters")
    if not same_audio:
        failures.append("the reloaded engine renders other pcm16 bytes")
    return {"save_ms": save_ms, "load_ms": load_ms, "msgpack_bytes": size,
            "params_bitwise_equal": same_params,
            "render_bitwise_equal": same_audio, "launches": counts,
            "card": card}


def training_phase(torch, np, synth, cfg, layers, vocoder, asc, oa, flush,
                   card, failures, reset_counts, check_counts):
    """Phase 10: training at the full width. -> (summary dict, conv shapes
    by kernel, head shapes) the training path gave the kernels."""
    import copy
    import re
    import shutil
    import tempfile

    from illufly_tts_tpu_torch.training import loop
    from illufly_tts_tpu_torch.training import step as tstep
    from illufly_tts_tpu_torch.training.voice_adapt import (
        adapt_voice,
        rendered_batches,
    )

    batch, tokens, frames = TRAIN["batch"], TRAIN["tokens"], TRAIN["frames"]
    init = copy.deepcopy(synth.model)  # the engine's seeded random weights
    out = {"card": card, "shape": dict(TRAIN), "launches": {}, "wall_s": {}}
    passes = {}
    clock = [time.perf_counter()]

    def lap(label):
        """Host seconds since the last lap, kept under ``label``."""
        torch.cuda.synchronize()
        now = time.perf_counter()
        out["wall_s"][label] = now - clock[0]
        clock[0] = now
    conv_shapes, head_shapes = record_shapes(layers, vocoder, asc, oa)

    def run(model, steps, batches=None, **kw):
        """``loop.train`` logging every step -> the per-step metrics."""
        seen = []
        loop.train(model, steps=steps, batch_size=batch, tokens=tokens,
                   frames=frames, log_every=1, batches=batches,
                   on_metrics=lambda step, m: seen.append(m), **kw)
        return seen

    def counted(label, generator_passes):
        passes[label] = generator_passes
        got = check_counts(f"training: {label}", generator_passes)
        for name, n in got.items():
            out["launches"][name] = out["launches"].get(name, 0) + n

    # (a) train() for 3 steps on its own synthetic-teacher batches (kept)
    drawn, synthetic = [], loop.synthetic_batches

    def keep(*args, **kw):
        for item in synthetic(*args, **kw):
            drawn.append(item)
            yield item

    model = copy.deepcopy(init)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    loop.synthetic_batches = keep
    try:
        t0 = time.perf_counter()
        metrics = run(model, 3)
        torch.cuda.synchronize()
        out["train_3_steps_s"] = time.perf_counter() - t0
    finally:
        loop.synthetic_batches = synthetic
    # each step: the teacher's render and the student's forward
    counted("train(), 3 steps", 6)
    out["peak_memory_gib"] = torch.cuda.max_memory_allocated() / 2**30
    out["losses"] = [m["loss"] for m in metrics]
    if not all(math.isfinite(v) for m in metrics for v in m.values()):
        failures.append(f"training: non-finite metrics {metrics}")
    log(f"training: train() at KokoroConfig() (B={batch}, tokens {tokens}, "
        f"frames {frames}), 3 steps in {out['train_3_steps_s']:.2f} s, "
        f"losses {out['losses']}, peak device memory "
        f"{out['peak_memory_gib']:.2f} GiB ({card})")

    lap("train(), 3 steps")

    # (b) step 0 on the card against the port on the CPU, same batch and
    # parameters
    first = drawn[0]
    cpu_model = copy.deepcopy(init).cpu()
    with torch.no_grad():
        _, cpu_m = tstep.make_loss_fn(cpu_model, frames)(first.to("cpu"))
    del cpu_model
    scale = float(first.target_audio.abs().mean())
    dur_err = abs(metrics[0]["dur_loss"] - float(cpu_m["dur_loss"])) / float(
        cpu_m["dur_loss"])
    audio_err = abs(metrics[0]["audio_loss"] - float(cpu_m["audio_loss"]))
    out["step0"] = {"card": metrics[0], "cpu": {k: float(v) for k, v in
                                                cpu_m.items()},
                    "dur_loss_rel_err": dur_err,
                    "audio_loss_err_over_mean_abs_target": audio_err / scale}
    log(f"training: step 0 card vs CPU: dur_loss {metrics[0]['dur_loss']:.6f}"
        f" vs {float(cpu_m['dur_loss']):.6f} (relative {dur_err:.2e}, limit "
        f"{STEP0_DUR_TOL}); audio_loss {metrics[0]['audio_loss']:.6f} vs "
        f"{float(cpu_m['audio_loss']):.6f} ({audio_err / scale:.2e} of "
        f"mean|target|, limit {CPU_GPU_TOL})")
    if not dur_err <= STEP0_DUR_TOL or not audio_err <= CPU_GPU_TOL * scale:
        failures.append(f"training: step 0 card vs CPU {out['step0']}")
    lap("step 0 on the CPU")

    # (c) one batch's gradients through the kernels and through the plain
    # versions, at the trained weights; the target is +-10x the audio's
    # peak, so no sample's L1 sign depends on either forward's rounding
    gen = torch.Generator(device="cuda").manual_seed(5)
    far = first._replace(target_audio=torch.where(
        torch.rand(first.target_audio.shape, device="cuda", generator=gen)
        < 0.5, -1.0, 1.0) * 10.0 * float(first.target_audio.abs().max()))
    loss_fn = tstep.make_loss_fn(model, frames)
    model.train()  # cuDNN's LSTM backward runs in training mode only

    def grads():
        model.zero_grad(set_to_none=True)
        loss, _ = loss_fn(far)
        loss.backward()
        return {name: p.grad.detach().clone()
                for name, p in model.named_parameters() if p.grad is not None}

    reset_counts()
    through = grads()
    counted("gradients through the kernels", 1)
    unrecord(layers, vocoder, asc, oa)
    for name in CONV_KERNELS:
        setattr(layers, name, asc.adain_snake_conv_plain)
    vocoder.istft_head = oa.istft_head_plain
    reset_counts()
    try:
        plain = grads()
    finally:
        unrecord(layers, vocoder, asc, oa)
    plain_counts = {"istft_oa": oa.launches, **asc.launches}
    log(f"training: gradients through the plain versions, launches "
        f"{plain_counts}")
    if any(plain_counts.values()):
        failures.append(f"training: the plain pass launched {plain_counts}")
    conv_more, head_more = record_shapes(layers, vocoder, asc, oa)
    total = math.sqrt(sum(float(g.square().sum()) for g in plain.values()))
    degenerate = re.compile(DEGENERATE)
    worst, worst_name = 0.0, None
    for name, g in plain.items():
        diff = float((through[name] - g).norm())
        if degenerate.search(name):
            if not diff <= 1e-3 * total:
                failures.append(f"training: {name} gradient differs by "
                                f"{diff} (> 1e-3 of the global norm)")
            continue
        err = diff / max(float(g.norm()), 1e-30)
        if err > worst:
            worst, worst_name = err, name
    zero = [name for name, g in through.items()
            if re.search(r"generator\.(noise_)?res_.*(conv[12]_\d\.weight|"
                         r"alpha[12]_\d|adain[12]_\d\.fc\.weight)", name)
            and not float(g.abs().max()) > 0]
    n_checked = sum(1 for name in through if re.search(
        r"generator\.(noise_)?res_.*(conv[12]_\d\.weight|alpha[12]_\d|"
        r"adain[12]_\d\.fc\.weight)", name))
    out["gradients"] = {"leaves": len(plain), "global_norm": total,
                        "worst_rel_l2": worst, "worst_leaf": worst_name,
                        "tolerance": GRAD_TOL,
                        "resblock_leaves_checked_nonzero": n_checked}
    log(f"training: gradients through the kernels vs the plain versions, "
        f"{len(plain)} leaves: worst relative L2 {worst:.3e} ({worst_name}; "
        f"limit {GRAD_TOL}); {n_checked} resblock conv/alpha/adain.fc "
        f"leaves, zero gradients: {zero}")
    if not worst <= GRAD_TOL or zero or len(through) != len(plain):
        failures.append(f"training: kernel vs plain gradients "
                        f"{out['gradients']}, zero {zero}")
    del through, plain
    lap("gradients, kernels and plain")

    # (d) forward and backward ms per step (CUDA events), then each
    # kernel's backward recompute at the largest training shape
    fwd, bwd = [], []
    reset_counts()
    for _ in range(3):
        model.zero_grad(set_to_none=True)
        marks = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        marks[0].record()
        loss, _ = loss_fn(far)
        marks[1].record()
        loss.backward()
        marks[2].record()
        marks[2].synchronize()
        fwd.append(marks[0].elapsed_time(marks[1]))
        bwd.append(marks[1].elapsed_time(marks[2]))
    counted("timed forward + backward, 3 reps", 3)
    out["forward_ms"] = statistics.median(fwd)
    out["backward_ms"] = statistics.median(bwd)
    log(f"training: one step at B={batch}, frames {frames}: forward "
        f"{out['forward_ms']:.1f} ms, backward {out['backward_ms']:.1f} ms "
        f"(CUDA events, median of 3; {card})")
    model.zero_grad(set_to_none=True)
    out["recompute"] = time_recompute(torch, asc, oa, flush, conv_shapes,
                                      head_shapes, card)
    lap("step and recompute timing")

    # (e) one adversarial step (the full HiFiGANDiscriminator)
    reset_counts()
    gan = run(model, 1, batches=iter([first]), adversarial=True)
    counted("one adversarial step", 2)  # the D step's and the G step's
    out["gan"] = gan[0]
    log(f"training: adversarial step {gan[0]}")
    if not all(math.isfinite(v) for v in gan[0].values()):
        failures.append(f"training: non-finite adversarial step {gan[0]}")
    del model, loss_fn
    torch.cuda.empty_cache()
    lap("one adversarial step")

    # (f) checkpoint and resume: 4 steps saving at step 2, then step 2's
    # checkpoint restored into a fresh model for steps 3 and 4; cuDNN's
    # deterministic algorithms make the forward run-to-run bit equal
    order = [drawn[0], drawn[1], drawn[2], drawn[0]]
    torch.backends.cudnn.deterministic = True
    tmp = tempfile.mkdtemp()
    try:
        reset_counts()
        whole = run(copy.deepcopy(init), 4, batches=iter(order),
                    checkpoint_dir=tmp, checkpoint_every=2)
        shutil.rmtree(os.path.join(tmp, "step_00000004"))
        resumed = run(copy.deepcopy(init), 2, batches=iter(order[2:]),
                      checkpoint_dir=tmp, resume=True, checkpoint_every=0)
        counted("4 steps, then 2 resumed", 6)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
        torch.backends.cudnn.deterministic = False
    torch.cuda.empty_cache()
    lap("checkpoint and resume")
    step4_err = abs(resumed[1]["loss"] - whole[3]["loss"]) / abs(
        whole[3]["loss"])
    out["resume"] = {"step3_loss": [whole[2]["loss"], resumed[0]["loss"]],
                     "step4_loss": [whole[3]["loss"], resumed[1]["loss"]],
                     "step4_rel_err": step4_err}
    log(f"training: resumed from step 2: step 3 loss {resumed[0]['loss']!r} "
        f"vs uninterrupted {whole[2]['loss']!r} (must be equal); step 4 "
        f"{resumed[1]['loss']!r} vs {whole[3]['loss']!r} (relative "
        f"{step4_err:.2e}, limit {RESUME_STEP4_TOL}: step 3's gradients sum "
        "with atomics)")
    if resumed[0]["loss"] != whole[2]["loss"] or not (
            step4_err <= RESUME_STEP4_TOL):
        failures.append(f"training: resume {out['resume']}")

    # (g) voice adaptation: 3 steps on batches the frozen engine model
    # renders under another voice, from the smoke voice
    synth.register_random_voice("train_target", seed=7)
    target = synth.load_voice("train_target")[20]
    start = synth.load_voice("smoke_voice")[20]
    renders = rendered_batches(synth.model, target, 4, tokens, frames, seed=2)
    reset_counts()
    style, adapt_m = adapt_voice(synth.model, renders, steps=3,
                                 frames=frames, init=start, log_every=0)
    s = torch.tensor(style, device="cuda", requires_grad=True)
    held = next(renders)
    synth.model.train()
    try:
        loss, _ = tstep.make_loss_fn(synth.model, frames, spectral=True)(
            held._replace(ref_s=s.expand(held.ref_s.shape)))
        loss.backward()
    finally:
        synth.model.eval()
    counted("adapt_voice 3 steps + one style gradient", 8)
    s_grad = float(s.grad.norm())
    moved = float(np.abs(style - start).max())
    out["adapt_voice"] = {"metrics": adapt_m, "style_moved": moved,
                          "style_grad_norm": s_grad}
    log(f"training: adapt_voice 3 steps: {adapt_m}; style moved by up to "
        f"{moved:.3e}; style gradient norm {s_grad:.3e}")
    if not (np.isfinite(style).all() and math.isfinite(s_grad)
            and s_grad > 0):
        failures.append(f"training: adapt_voice {out['adapt_voice']}")
    unrecord(layers, vocoder, asc, oa)
    del init
    torch.cuda.empty_cache()
    lap("adapt_voice")
    log(f"training: host seconds by part {out['wall_s']}")
    out["generator_passes"] = passes
    for name in CONV_KERNELS:
        conv_shapes[name] |= conv_more[name]
    return out, conv_shapes, head_shapes | head_more


def time_recompute(torch, asc, oa, flush, conv_shapes, head_shapes, card):
    """Each kernel's backward at its largest training shape (the plain
    version recomputed and differentiated, ``ops/kernel_grad.py``), beside
    its forward launch, CUDA-event medians. -> {kernel: row}."""
    rows = {}
    for name in CONV_KERNELS:
        b, c, length, k, d = max(conv_shapes[name], key=lambda s: (
            s[0] * s[1] * s[2] * s[3], s[4]))  # the most work, widest d
        args = [t.requires_grad_(i != 1) for i, t in enumerate(
            conv_inputs(torch, b, c, length, k, seed=7))]
        fn = getattr(asc, name)
        y = fn(*args, k, d)
        inputs = [args[i] for i in (0, 2, 3, 4, 5, 6)]
        g = torch.randn_like(y)
        rows[name] = {
            "shape": [b, c, length, k, d],
            "forward_ms": cuda_ms(lambda: fn(*args, k, d), 10, flush),
            "backward_recompute_ms": cuda_ms(
                lambda: torch.autograd.grad(y, inputs, g, retain_graph=True),
                10, flush)}
    b, length = max(head_shapes)
    x = head_inputs(torch, b, length, seed=7).requires_grad_()
    y = oa.istft_head(x)
    g = torch.randn_like(y)
    rows["istft_oa"] = {
        "shape": [b, 22, length],
        "forward_ms": cuda_ms(lambda: oa.istft_head(x), 20, flush),
        "backward_recompute_ms": cuda_ms(
            lambda: torch.autograd.grad(y, [x], g, retain_graph=True), 20,
            flush)}
    for name, row in rows.items():
        log(f"training: {name} at the training shape {row['shape']}: "
            f"forward (kernel) {row['forward_ms']:.4f} ms, backward "
            f"(plain recompute + autograd) {row['backward_recompute_ms']:.4f}"
            f" ms ({card})")
    return rows


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
    conv_shapes, head_shapes = record_shapes(layers, vocoder, asc, oa)

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
    unrecord(layers, vocoder, asc, oa)

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
    del cpu

    # ---- 7. serving path ----------------------------------------------------------
    pipe, frontend = text_pipeline(synth, failures)
    serve_conv, serve_head = record_shapes(layers, vocoder, asc, oa)
    try:
        serving = serving_phase(torch, np, synth, pipe, frontend, oa, asc,
                                conv_per_generator, card, failures,
                                check_wave)
    finally:
        unrecord(layers, vocoder, asc, oa)
    log("kernels vs plain at the shapes the serving path gave them (those "
        "not checked above):")
    for name in CONV_KERNELS:
        new = sorted(serve_conv[name] - conv_shapes[name])
        if new:
            err = check_conv(torch, asc, name,
                             [(*shape, False) for shape in new])
            conv[name]["max_abs_err"] = max(conv[name]["max_abs_err"], err)
    new = sorted(serve_head - head_shapes)
    if new:
        head_err = max(head_err, check_head(
            torch, oa, [(b, f, False) for b, f in new]))

    # ---- 8. HTTP and MCP ----------------------------------------------------------
    repair = repair_timing(torch, synth, requests["long_8"], failures)
    http_conv, http_head = record_shapes(layers, vocoder, asc, oa)
    try:
        http = http_phase(torch, np, synth, pipe, oa, asc,
                          conv_per_generator, card, failures)
    finally:
        unrecord(layers, vocoder, asc, oa)
    http["repair"] = repair
    log("kernels vs plain at the shapes the HTTP phase gave them (those not "
        "checked above):")
    for name in CONV_KERNELS:
        new = sorted(http_conv[name] - conv_shapes[name] - serve_conv[name])
        if new:
            err = check_conv(torch, asc, name,
                             [(*shape, False) for shape in new])
            conv[name]["max_abs_err"] = max(conv[name]["max_abs_err"], err)
    new = sorted(http_head - head_shapes - serve_head)
    if new:
        head_err = max(head_err, check_head(
            torch, oa, [(b, f, False) for b, f in new]))

    # ---- 9. weights ------------------------------------------------------------
    weights = weights_phase(torch, synth, cfg, card, failures, reset_counts,
                            check_counts)

    # ---- 10. training -------------------------------------------------------------
    training, train_conv, train_head = training_phase(
        torch, np, synth, cfg, layers, vocoder, asc, oa, flush, card,
        failures, reset_counts, check_counts)
    log("kernels vs plain at the shapes the training phase gave them (those "
        "not checked above):")
    for name in CONV_KERNELS:
        new = sorted(train_conv[name] - conv_shapes[name] - serve_conv[name]
                     - http_conv[name])
        if new:
            err = check_conv(torch, asc, name,
                             [(*shape, False) for shape in new])
            conv[name]["max_abs_err"] = max(conv[name]["max_abs_err"], err)
    new = sorted(train_head - head_shapes - serve_head - http_head)
    if new:
        head_err = max(head_err, check_head(
            torch, oa, [(b, f, False) for b, f in new]))

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
        "launches_serving": serving["launches"]["istft_oa"],
        "launches_per_text_request": serving["launches"]["istft_oa"]
        / len(TASKS),
        "launches_http": http["launches"]["istft_oa"],
        "launches_training": training["launches"]["istft_oa"],
        "training_generator_passes": sum(
            training["generator_passes"].values()),
        "backward_recompute": training["recompute"]["istft_oa"],
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
            "launches_serving": serving["launches"][name],
            "launches_per_text_request": serving["launches"][name]
            / len(TASKS),
            "launches_http": http["launches"][name],
            "launches_training": training["launches"][name],
            "training_generator_passes": sum(
                training["generator_passes"].values()),
            "backward_recompute": training["recompute"][name],
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
    log(json.dumps({"serving": serving}))
    log(json.dumps({"http": http}))
    log(json.dumps({"weights": weights}))
    log(json.dumps({"training": training}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)


# the frontend's output for phase 7's texts, made by frontend_table() with
# the JAX package's frontend; tests/test_torch_frontend.py holds it to it
FRONTEND_TABLE = {
    "normalized": {
        '预热一下。':
            '预热一下。',
        'Warm up once.':
            'Warm up once.',
        '今天是2024年3月5日，气温25℃。':
            '今天是二零二四年三月五日，气温二十五摄氏度。',
        'The meeting starts at 3:30 PM on June 1st and costs $42.':
            'The meeting starts at three thirty in the afternoon on J'
            'une first and costs forty two dollars.',
        '我们用Python写了一个TTS服务，效果很好。':
            '我们用 Python写了一个 TTS服务，效果很好。',
        '请在下午三点之前提交报告。':
            '请在下午三点之前提交报告。',
        'Please hold the line, your call is important to us.':
            'Please hold the line, your call is important to us.',
        '今天天气真好，我们去公园散步。':
            '今天天气真好，我们去公园散步。',
        '欢迎使用语音合成服务。':
            '欢迎使用语音合成服务。',
        'Thank you for calling, goodbye.':
            'Thank you for calling, goodbye.',
        '清晨六点，城市还没有完全醒来。街道两旁的路灯依次熄灭，早餐店的老板已经忙着蒸包子、煮豆浆。公交车载着第一批乘客驶'
        '过大桥，江面上飘着薄薄的雾。七点半以后，上班的人越来越多，地铁站里排起了长队。学校门口，家长们叮嘱孩子注意安全，'
        '老师微笑着迎接每一位学生。中午的阳光很温暖，公园里有人下棋，有人散步，还有人坐在长椅上读报纸。到了傍晚，商场的灯'
        '光亮起来，年轻人约朋友一起吃饭、看电影。据统计，这座城市去年接待游客超过3200万人次，比前年增长了12.5%。'
        '夜深了，城市慢慢安静下来，只有远处的货车还在运送明天需要的蔬菜和水果。':
            '清晨六点，城市还没有完全醒来。街道两旁的路灯依次熄灭，早餐店的老板已经忙着蒸包子、煮豆浆。公交车载着第一批乘客驶'
            '过大桥，江面上飘着薄薄的雾。七点半以后，上班的人越来越多，地铁站里排起了长队。学校门口，家长们叮嘱孩子注意安全，'
            '老师微笑着迎接每一位学生。中午的阳光很温暖，公园里有人下棋，有人散步，还有人坐在长椅上读报纸。到了傍晚，商场的灯'
            '光亮起来，年轻人约朋友一起吃饭、看电影。据统计，这座城市去年接待游客超过三千二百万人次，比前年增长了百分之十二点'
            '五。夜深了，城市慢慢安静下来，只有远处的货车还在运送明天需要的蔬菜和水果。',
        '欢迎收听今天的新闻。This is the evening report, with the weather a'
        'nd the traffic.':
            '欢迎收听今天的新闻。 This is the evening report, with the weather '
            'and the traffic.',
    },
    "g2p": {
        '预热一下。': [
            'ㄩ4ㄖㄜ4/ㄧ2ㄒㄧㄚ4.',
            'y↘ʐɤ↘ i↗ɕja↘.',
        ],
        'Warm up once.': [
            'wˈɔɹm ˌʌp wˈʌns .',
            'wˈɔɹm ˌʌp wˈʌns .',
        ],
        '今天是二零二四年三月五日，气温二十五摄氏度。': [
            'ㄐㄧㄣ1ㄊㄧㄢ1/ㄕㄭ4/ㄦ4ㄌㄧㄥ2ㄦ4/ㄙㄭ4ㄋㄧㄢ2/ㄙㄢ1ㄩㄝ4/ㄨ3ㄖㄭ4, ㄑㄧ4ㄨㄣ1/ㄦ4ㄕㄭ2'
            'ㄨ3/ㄕㄜ4ㄕㄭ4ㄉㄨ4.',
            'tɕin→tʰjɛn→ ʂɨ↘ ɚ↘liŋ↗ɚ↘ sɨ↘njɛn↗ san→ɥe↘ u↓ʐɨ↘, tɕʰi↘wə'
            'n→ ɚ↘ʂɨ↗u↓ ʂɤ↘ʂɨ↘tu↘.',
        ],
        'The meeting starts at three thirty in the afternoon on J'
        'une first and costs forty two dollars.': [
            'ðə mˈitɪŋ stˈɑɹts æt θɹˈi θˈɝti ɪn ði ˌæftɚnˈun ˌɔn dʒˈu'
            'n fˈɝst ænd kˈɔsts fˈɔɹti tˈu dˈɑlɚz .',
            'ðə mˈitɪŋ stˈɑɹts æt θɹˈi θˈɝti ɪn ði ˌæftɚnˈun ˌɔn dʒˈu'
            'n fˈɝst ænd kˈɔsts fˈɔɹti tˈu dˈɑlɚz .',
        ],
        '我们用 Python写了一个 TTS服务，效果很好。': [
            'ㄨㄛ3ㄇㄣ5/ㄩㄥ4 pˈaɪθɑn ㄒㄧㄝ3/ㄌㄜ5/ㄧ2ㄍㄜ5 tˌitˌiˈɛs ㄈㄨ2ㄨ4, ㄒㄧㄠ4ㄍ'
            'ㄨㄛ3/ㄏㄣ2ㄏㄠ3.',
            'wo↓mən jʊŋ↘ pˈaɪθɑn ɕje↓ lɤ i↗kɤ tˌitˌiˈɛs fu↗u↘, ɕjau↘k'
            'wo↓ xən↗xau↓.',
        ],
        '请在下午三点之前提交报告。': [
            'ㄑㄧㄥ3/ㄗㄞ4/ㄒㄧㄚ4ㄨ3/ㄙㄢ1ㄉㄧㄢ3/ㄓㄭ1ㄑㄧㄢ2/ㄊㄧ2ㄐㄧㄠ1/ㄅㄠ4ㄍㄠ4.',
            'tɕʰiŋ↓ tsai↘ ɕja↘u↓ san→tjɛn↓ ʈʂɨ→tɕʰjɛn↗ tʰi↗tɕjau→ pau'
            '↘kau↘.',
        ],
        'Please hold the line, your call is important to us.': [
            'plˈiz hˈoʊld ðə lˈaɪn , jʊɹ kˈɔl ɪz ɪmpˈɔɹtənt tʊ ˌʌs .',
            'plˈiz hˈoʊld ðə lˈaɪn , jʊɹ kˈɔl ɪz ɪmpˈɔɹtənt tʊ ˌʌs .',
        ],
        '今天天气真好，我们去公园散步。': [
            'ㄐㄧㄣ1ㄊㄧㄢ1ㄊㄧㄢ1ㄑㄧ4/ㄓㄣ1/ㄏㄠ3, ㄨㄛ3ㄇㄣ5/ㄑㄩ4/ㄍㄨㄥ1ㄩㄢ2/ㄙㄢ4ㄅㄨ4.',
            'tɕin→tʰjɛn→tʰjɛn→tɕʰi↘ ʈʂən→ xau↓, wo↓mən tɕʰy↘ kʊŋ→ɥɛn↗'
            ' san↘pu↘.',
        ],
        '欢迎使用语音合成服务。': [
            'ㄏㄨㄢ1ㄧㄥ2/ㄕㄭ3ㄩㄥ4/ㄩ3ㄧㄣ1/ㄏㄜ2ㄔㄥ2/ㄈㄨ2ㄨ4.',
            'xwan→iŋ↗ ʂɨ↓jʊŋ↘ y↓in→ xɤ↗ʈʂʰəŋ↗ fu↗u↘.',
        ],
        'Thank you for calling, goodbye.': [
            'θˈæŋk ju fɔɹ kˈɔlɪŋ , ɡʊdbˈaɪ .',
            'θˈæŋk ju fɔɹ kˈɔlɪŋ , ɡʊdbˈaɪ .',
        ],
        '清晨六点，城市还没有完全醒来。街道两旁的路灯依次熄灭，早餐店的老板已经忙着蒸包子、煮豆浆。公交车载着第一批乘客驶'
        '过大桥，江面上飘着薄薄的雾。七点半以后，上班的人越来越多，地铁站里排起了长队。学校门口，家长们叮嘱孩子注意安全，'
        '老师微笑着迎接每一位学生。中午的阳光很温暖，公园里有人下棋，有人散步，还有人坐在长椅上读报纸。到了傍晚，商场的灯'
        '光亮起来，年轻人约朋友一起吃饭、看电影。据统计，这座城市去年接待游客超过三千二百万人次，比前年增长了百分之十二点'
        '五。夜深了，城市慢慢安静下来，只有远处的货车还在运送明天需要的蔬菜和水果。': [
            'ㄑㄧㄥ1ㄔㄣ2/ㄌㄧㄡ4ㄉㄧㄢ3, ㄔㄥ2ㄕㄭ4/ㄏㄞ2/ㄇㄟ2ㄧㄡ3/ㄨㄢ2ㄑㄩㄢ2/ㄒㄧㄥ3ㄌㄞ2. ㄐㄧㄝ'
            '1ㄉㄠ4/ㄌㄧㄤ3ㄆㄤ2/ㄉㄜ5/ㄌㄨ4ㄉㄥ1/ㄧ1ㄘㄭ4/ㄒㄧ1ㄇㄧㄝ4, ㄗㄠ3ㄘㄢ1/ㄉㄧㄢ4/ㄉㄜ5/ㄌ'
            'ㄠ2ㄅㄢ2/ㄧ3ㄐㄧㄥ1/ㄇㄤ2/ㄓㄜ5/ㄓㄥ1/ㄅㄠ1ㄗㄭ5, ㄓㄨ3/ㄉㄡ4ㄐㄧㄤ1. ㄍㄨㄥ1ㄐㄧㄠ1ㄔㄜ'
            '1/ㄗㄞ4/ㄓㄜ5/ㄉㄧ4ㄧ1ㄆㄧ1/ㄔㄥ2ㄎㄜ4/ㄕㄭ3ㄍㄨㄛ4/ㄉㄚ4ㄑㄧㄠ2, ㄐㄧㄤ1ㄇㄧㄢ4/ㄕㄤ4/'
            'ㄆㄧㄠ1/ㄓㄜ5/ㄅㄠ2ㄅㄠ2ㄉㄜ5/ㄨ4. ㄑㄧ1ㄉㄧㄢ3/ㄅㄢ4/ㄧ3ㄏㄡ4, ㄕㄤ4ㄅㄢ1/ㄉㄜ5/ㄖㄣ2'
            '/ㄩㄝ4ㄌㄞ2ㄩㄝ4/ㄉㄨㄛ1, ㄉㄧ4ㄊㄧㄝ3ㄓㄢ4/ㄌㄧ3/ㄆㄞ2ㄑㄧ3/ㄌㄜ5/ㄔㄤ2ㄉㄨㄟ4. ㄒㄩㄝ2'
            'ㄒㄧㄠ4/ㄇㄣ2ㄎㄡ3, ㄐㄧㄚ1ㄓㄤ3/ㄇㄣ5/ㄉㄧㄥ1ㄓㄨ3/ㄏㄞ2ㄗㄭ5/ㄓㄨ4ㄧ4ㄢ1ㄑㄩㄢ2, ㄌㄠ3'
            'ㄕㄭ1/ㄨㄟ1ㄒㄧㄠ4/ㄓㄜ5/ㄧㄥ2ㄐㄧㄝ1/ㄇㄟ3/ㄧ2ㄨㄟ4/ㄒㄩㄝ2ㄕㄥ1. ㄓㄨㄥ1ㄨ3/ㄉㄜ5/ㄧㄤ'
            '2ㄍㄨㄤ1/ㄏㄣ3/ㄨㄣ1ㄋㄨㄢ3, ㄍㄨㄥ1ㄩㄢ2/ㄌㄧ2ㄧㄡ3ㄖㄣ2/ㄒㄧㄚ4ㄑㄧ2, ㄧㄡ3ㄖㄣ2/ㄙㄢ4'
            'ㄅㄨ4, ㄏㄞ2ㄧㄡ3/ㄖㄣ2/ㄗㄨㄛ4ㄗㄞ4/ㄔㄤ2ㄧ3/ㄕㄤ4ㄉㄨ2/ㄅㄠ4ㄓㄭ3. ㄉㄠ4/ㄌㄜ5/ㄅㄤ4'
            'ㄨㄢ3, ㄕㄤ1ㄔㄤ2/ㄉㄜ5/ㄉㄥ1ㄍㄨㄤ1/ㄌㄧㄤ4/ㄑㄧ3ㄌㄞ5, ㄋㄧㄢ2ㄑㄧㄥ1ㄖㄣ2/ㄩㄝ1/ㄆㄥ2'
            'ㄧㄡ5/ㄧ4ㄑㄧ3/ㄔㄭ1ㄈㄢ4, ㄎㄢ4/ㄉㄧㄢ4ㄧㄥ3. ㄐㄩ4ㄊㄨㄥ3ㄐㄧ4, ㄓㄜ4/ㄗㄨㄛ4/ㄔㄥ2ㄕ'
            'ㄭ4/ㄑㄩ4ㄋㄧㄢ2/ㄐㄧㄝ1ㄉㄞ4/ㄧㄡ2ㄎㄜ4/ㄔㄠ1ㄍㄨㄛ4/ㄙㄢ1ㄑㄧㄢ1/ㄦ4ㄅㄞ3/ㄨㄢ4ㄖㄣ2ㄘㄭ'
            '4, ㄅㄧ3/ㄑㄧㄢ2ㄋㄧㄢ2/ㄗㄥ1ㄓㄤ3/ㄌㄜ5/ㄅㄞ3ㄈㄣ1ㄓㄭ1ㄕㄭ2/ㄦ4ㄉㄧㄢ3ㄨ3. ㄧㄝ4ㄕㄣ1'
            '/ㄌㄜ5, ㄔㄥ2ㄕㄭ4/ㄇㄢ4ㄇㄢ4/ㄢ1ㄐㄧㄥ4ㄒㄧㄚ4ㄌㄞ5, ㄓㄭ2ㄧㄡ3/ㄩㄢ2ㄔㄨ3/ㄉㄜ5/ㄏㄨㄛ'
            '4ㄔㄜ1/ㄏㄞ2/ㄗㄞ4/ㄩㄣ4ㄙㄨㄥ4/ㄇㄧㄥ2ㄊㄧㄢ1/ㄒㄩ1ㄧㄠ4/ㄉㄜ5/ㄕㄨ1ㄘㄞ4/ㄏㄜ2/ㄕㄨㄟ2'
            'ㄍㄨㄛ3.',
            'tɕʰiŋ→ʈʂʰən↗ ljou↘tjɛn↓, ʈʂʰəŋ↗ʂɨ↘ xai↗ mei↗jou↓ wan↗tɕʰ'
            'ɥɛn↗ ɕiŋ↓lai↗. tɕje→tau↘ ljaŋ↓pʰaŋ↗ tɤ lu↘təŋ→ i→tsʰɨ↘ ɕ'
            'i→mje↘, tsau↓tsʰan→ tjɛn↘ tɤ lau↗pan↗ i↓tɕiŋ→ maŋ↗ ʈʂɤ ʈ'
            'ʂəŋ→ pau→tsɨ, ʈʂu↓ tou↘tɕjaŋ→. kʊŋ→tɕjau→ʈʂʰɤ→ tsai↘ ʈʂɤ'
            ' ti↘i→pʰi→ ʈʂʰəŋ↗kʰɤ↘ ʂɨ↓kwo↘ ta↘tɕʰjau↗, tɕjaŋ→mjɛn↘ ʂa'
            'ŋ↘ pʰjau→ ʈʂɤ pau↗pau↗tɤ u↘. tɕʰi→tjɛn↓ pan↘ i↓xou↘, ʂaŋ'
            '↘pan→ tɤ ʐən↗ ɥe↘lai↗ɥe↘ two→, ti↘tʰje↓ʈʂan↘ li↓ pʰai↗tɕ'
            'ʰi↓ lɤ ʈʂʰaŋ↗twei↘. ɕɥe↗ɕjau↘ mən↗kʰou↓, tɕja→ʈʂaŋ↓ mən '
            'tiŋ→ʈʂu↓ xai↗tsɨ ʈʂu↘i↘an→tɕʰɥɛn↗, lau↓ʂɨ→ wei→ɕjau↘ ʈʂɤ'
            ' iŋ↗tɕje→ mei↓ i↗wei↘ ɕɥe↗ʂəŋ→. ʈʂʊŋ→u↓ tɤ jaŋ↗kwaŋ→ xən'
            '↓ wən→nwan↓, kʊŋ→ɥɛn↗ li↗jou↓ʐən↗ ɕja↘tɕʰi↗, jou↓ʐən↗ sa'
            'n↘pu↘, xai↗jou↓ ʐən↗ tswo↘tsai↘ ʈʂʰaŋ↗i↓ ʂaŋ↘tu↗ pau↘ʈʂɨ'
            '↓. tau↘ lɤ paŋ↘wan↓, ʂaŋ→ʈʂʰaŋ↗ tɤ təŋ→kwaŋ→ ljaŋ↘ tɕʰi↓'
            'lai, njɛn↗tɕʰiŋ→ʐən↗ ɥe→ pʰəŋ↗jou i↘tɕʰi↓ ʈʂʰɨ→fan↘, kʰa'
            'n↘ tjɛn↘iŋ↓. tɕy↘tʰʊŋ↓tɕi↘, ʈʂɤ↘ tswo↘ ʈʂʰəŋ↗ʂɨ↘ tɕʰy↘nj'
            'ɛn↗ tɕje→tai↘ jou↗kʰɤ↘ ʈʂʰau→kwo↘ san→tɕʰjɛn→ ɚ↘pai↓ wan'
            '↘ʐən↗tsʰɨ↘, pi↓ tɕʰjɛn↗njɛn↗ tsəŋ→ʈʂaŋ↓ lɤ pai↓fən→ʈʂɨ→ʂ'
            'ɨ↗ ɚ↘tjɛn↓u↓. je↘ʂən→ lɤ, ʈʂʰəŋ↗ʂɨ↘ man↘man↘ an→tɕiŋ↘ɕja'
            '↘lai, ʈʂɨ↗jou↓ ɥɛn↗ʈʂʰu↓ tɤ xwo↘ʈʂʰɤ→ xai↗ tsai↘ yn↘sʊŋ↘'
            ' miŋ↗tʰjɛn→ ɕy→jau↘ tɤ ʂu→tsʰai↘ xɤ↗ ʂwei↗kwo↓.',
        ],
        '清晨六点，城市还没有完全醒来。街道两旁的路灯依次熄灭，早餐店的老板已经忙着蒸包子、煮豆浆。公交车载着第一批乘客驶'
        '过大桥，江面上飘着薄薄的雾。七点半以后，上班的人越来越多，地铁站里排起了长队。学校门口，家长们叮嘱孩子注意安全，'
        '老师微笑着迎接每一位学生。中午的阳光很温暖，': [
            'ㄑㄧㄥ1ㄔㄣ2/ㄌㄧㄡ4ㄉㄧㄢ3, ㄔㄥ2ㄕㄭ4/ㄏㄞ2/ㄇㄟ2ㄧㄡ3/ㄨㄢ2ㄑㄩㄢ2/ㄒㄧㄥ3ㄌㄞ2. ㄐㄧㄝ'
            '1ㄉㄠ4/ㄌㄧㄤ3ㄆㄤ2/ㄉㄜ5/ㄌㄨ4ㄉㄥ1/ㄧ1ㄘㄭ4/ㄒㄧ1ㄇㄧㄝ4, ㄗㄠ3ㄘㄢ1/ㄉㄧㄢ4/ㄉㄜ5/ㄌ'
            'ㄠ2ㄅㄢ2/ㄧ3ㄐㄧㄥ1/ㄇㄤ2/ㄓㄜ5/ㄓㄥ1/ㄅㄠ1ㄗㄭ5, ㄓㄨ3/ㄉㄡ4ㄐㄧㄤ1. ㄍㄨㄥ1ㄐㄧㄠ1ㄔㄜ'
            '1/ㄗㄞ4/ㄓㄜ5/ㄉㄧ4ㄧ1ㄆㄧ1/ㄔㄥ2ㄎㄜ4/ㄕㄭ3ㄍㄨㄛ4/ㄉㄚ4ㄑㄧㄠ2, ㄐㄧㄤ1ㄇㄧㄢ4/ㄕㄤ4/'
            'ㄆㄧㄠ1/ㄓㄜ5/ㄅㄠ2ㄅㄠ2ㄉㄜ5/ㄨ4. ㄑㄧ1ㄉㄧㄢ3/ㄅㄢ4/ㄧ3ㄏㄡ4, ㄕㄤ4ㄅㄢ1/ㄉㄜ5/ㄖㄣ2'
            '/ㄩㄝ4ㄌㄞ2ㄩㄝ4/ㄉㄨㄛ1, ㄉㄧ4ㄊㄧㄝ3ㄓㄢ4/ㄌㄧ3/ㄆㄞ2ㄑㄧ3/ㄌㄜ5/ㄔㄤ2ㄉㄨㄟ4. ㄒㄩㄝ2'
            'ㄒㄧㄠ4/ㄇㄣ2ㄎㄡ3, ㄐㄧㄚ1ㄓㄤ3/ㄇㄣ5/ㄉㄧㄥ1ㄓㄨ3/ㄏㄞ2ㄗㄭ5/ㄓㄨ4ㄧ4ㄢ1ㄑㄩㄢ2, ㄌㄠ3'
            'ㄕㄭ1/ㄨㄟ1ㄒㄧㄠ4/ㄓㄜ5/ㄧㄥ2ㄐㄧㄝ1/ㄇㄟ3/ㄧ2ㄨㄟ4/ㄒㄩㄝ2ㄕㄥ1. ㄓㄨㄥ1ㄨ3/ㄉㄜ5/ㄧㄤ'
            '2ㄍㄨㄤ1/ㄏㄣ3/ㄨㄣ1ㄋㄨㄢ3,',
            'tɕʰiŋ→ʈʂʰən↗ ljou↘tjɛn↓, ʈʂʰəŋ↗ʂɨ↘ xai↗ mei↗jou↓ wan↗tɕʰ'
            'ɥɛn↗ ɕiŋ↓lai↗. tɕje→tau↘ ljaŋ↓pʰaŋ↗ tɤ lu↘təŋ→ i→tsʰɨ↘ ɕ'
            'i→mje↘, tsau↓tsʰan→ tjɛn↘ tɤ lau↗pan↗ i↓tɕiŋ→ maŋ↗ ʈʂɤ ʈ'
            'ʂəŋ→ pau→tsɨ, ʈʂu↓ tou↘tɕjaŋ→. kʊŋ→tɕjau→ʈʂʰɤ→ tsai↘ ʈʂɤ'
            ' ti↘i→pʰi→ ʈʂʰəŋ↗kʰɤ↘ ʂɨ↓kwo↘ ta↘tɕʰjau↗, tɕjaŋ→mjɛn↘ ʂa'
            'ŋ↘ pʰjau→ ʈʂɤ pau↗pau↗tɤ u↘. tɕʰi→tjɛn↓ pan↘ i↓xou↘, ʂaŋ'
            '↘pan→ tɤ ʐən↗ ɥe↘lai↗ɥe↘ two→, ti↘tʰje↓ʈʂan↘ li↓ pʰai↗tɕ'
            'ʰi↓ lɤ ʈʂʰaŋ↗twei↘. ɕɥe↗ɕjau↘ mən↗kʰou↓, tɕja→ʈʂaŋ↓ mən '
            'tiŋ→ʈʂu↓ xai↗tsɨ ʈʂu↘i↘an→tɕʰɥɛn↗, lau↓ʂɨ→ wei→ɕjau↘ ʈʂɤ'
            ' iŋ↗tɕje→ mei↓ i↗wei↘ ɕɥe↗ʂəŋ→. ʈʂʊŋ→u↓ tɤ jaŋ↗kwaŋ→ xən'
            '↓ wən→nwan↓,',
        ],
        '清晨六点，城市还没有完全醒来。街道两旁的路灯依次熄灭，早餐店的老板已经忙着蒸包子、煮豆浆。公交车载着第一批乘客驶'
        '过大桥，江面上飘着薄薄的雾。': [
            'ㄑㄧㄥ1ㄔㄣ2/ㄌㄧㄡ4ㄉㄧㄢ3, ㄔㄥ2ㄕㄭ4/ㄏㄞ2/ㄇㄟ2ㄧㄡ3/ㄨㄢ2ㄑㄩㄢ2/ㄒㄧㄥ3ㄌㄞ2. ㄐㄧㄝ'
            '1ㄉㄠ4/ㄌㄧㄤ3ㄆㄤ2/ㄉㄜ5/ㄌㄨ4ㄉㄥ1/ㄧ1ㄘㄭ4/ㄒㄧ1ㄇㄧㄝ4, ㄗㄠ3ㄘㄢ1/ㄉㄧㄢ4/ㄉㄜ5/ㄌ'
            'ㄠ2ㄅㄢ2/ㄧ3ㄐㄧㄥ1/ㄇㄤ2/ㄓㄜ5/ㄓㄥ1/ㄅㄠ1ㄗㄭ5, ㄓㄨ3/ㄉㄡ4ㄐㄧㄤ1. ㄍㄨㄥ1ㄐㄧㄠ1ㄔㄜ'
            '1/ㄗㄞ4/ㄓㄜ5/ㄉㄧ4ㄧ1ㄆㄧ1/ㄔㄥ2ㄎㄜ4/ㄕㄭ3ㄍㄨㄛ4/ㄉㄚ4ㄑㄧㄠ2, ㄐㄧㄤ1ㄇㄧㄢ4/ㄕㄤ4/'
            'ㄆㄧㄠ1/ㄓㄜ5/ㄅㄠ2ㄅㄠ2ㄉㄜ5/ㄨ4.',
            'tɕʰiŋ→ʈʂʰən↗ ljou↘tjɛn↓, ʈʂʰəŋ↗ʂɨ↘ xai↗ mei↗jou↓ wan↗tɕʰ'
            'ɥɛn↗ ɕiŋ↓lai↗. tɕje→tau↘ ljaŋ↓pʰaŋ↗ tɤ lu↘təŋ→ i→tsʰɨ↘ ɕ'
            'i→mje↘, tsau↓tsʰan→ tjɛn↘ tɤ lau↗pan↗ i↓tɕiŋ→ maŋ↗ ʈʂɤ ʈ'
            'ʂəŋ→ pau→tsɨ, ʈʂu↓ tou↘tɕjaŋ→. kʊŋ→tɕjau→ʈʂʰɤ→ tsai↘ ʈʂɤ'
            ' ti↘i→pʰi→ ʈʂʰəŋ↗kʰɤ↘ ʂɨ↓kwo↘ ta↘tɕʰjau↗, tɕjaŋ→mjɛn↘ ʂa'
            'ŋ↘ pʰjau→ ʈʂɤ pau↗pau↗tɤ u↘.',
        ],
        '七点半以后，上班的人越来越多，地铁站里排起了长队。学校门口，家长们叮嘱孩子注意安全，老师微笑着迎接每一位学生。中'
        '午的阳光很温暖，': [
            'ㄑㄧ1ㄉㄧㄢ3/ㄅㄢ4/ㄧ3ㄏㄡ4, ㄕㄤ4ㄅㄢ1/ㄉㄜ5/ㄖㄣ2/ㄩㄝ4ㄌㄞ2ㄩㄝ4/ㄉㄨㄛ1, ㄉㄧ4ㄊㄧㄝ'
            '3ㄓㄢ4/ㄌㄧ3/ㄆㄞ2ㄑㄧ3/ㄌㄜ5/ㄔㄤ2ㄉㄨㄟ4. ㄒㄩㄝ2ㄒㄧㄠ4/ㄇㄣ2ㄎㄡ3, ㄐㄧㄚ1ㄓㄤ3/ㄇㄣ'
            '5/ㄉㄧㄥ1ㄓㄨ3/ㄏㄞ2ㄗㄭ5/ㄓㄨ4ㄧ4ㄢ1ㄑㄩㄢ2, ㄌㄠ3ㄕㄭ1/ㄨㄟ1ㄒㄧㄠ4/ㄓㄜ5/ㄧㄥ2ㄐㄧㄝ1'
            '/ㄇㄟ3/ㄧ2ㄨㄟ4/ㄒㄩㄝ2ㄕㄥ1. ㄓㄨㄥ1ㄨ3/ㄉㄜ5/ㄧㄤ2ㄍㄨㄤ1/ㄏㄣ3/ㄨㄣ1ㄋㄨㄢ3,',
            'tɕʰi→tjɛn↓ pan↘ i↓xou↘, ʂaŋ↘pan→ tɤ ʐən↗ ɥe↘lai↗ɥe↘ two→'
            ', ti↘tʰje↓ʈʂan↘ li↓ pʰai↗tɕʰi↓ lɤ ʈʂʰaŋ↗twei↘. ɕɥe↗ɕjau↘'
            ' mən↗kʰou↓, tɕja→ʈʂaŋ↓ mən tiŋ→ʈʂu↓ xai↗tsɨ ʈʂu↘i↘an→tɕʰ'
            'ɥɛn↗, lau↓ʂɨ→ wei→ɕjau↘ ʈʂɤ iŋ↗tɕje→ mei↓ i↗wei↘ ɕɥe↗ʂəŋ'
            '→. ʈʂʊŋ→u↓ tɤ jaŋ↗kwaŋ→ xən↓ wən→nwan↓,',
        ],
        '公园里有人下棋，有人散步，还有人坐在长椅上读报纸。到了傍晚，商场的灯光亮起来，年轻人约朋友一起吃饭、看电影。据统'
        '计，这座城市去年接待游客超过三千二百万人次，比前年增长了百分之十二点五。夜深了，城市慢慢安静下来，只有远处的货车'
        '还在运送明天需要的蔬菜和水果。': [
            'ㄍㄨㄥ1ㄩㄢ2/ㄌㄧ2ㄧㄡ3ㄖㄣ2/ㄒㄧㄚ4ㄑㄧ2, ㄧㄡ3ㄖㄣ2/ㄙㄢ4ㄅㄨ4, ㄏㄞ2ㄧㄡ3/ㄖㄣ2/ㄗㄨㄛ'
            '4ㄗㄞ4/ㄔㄤ2ㄧ3/ㄕㄤ4ㄉㄨ2/ㄅㄠ4ㄓㄭ3. ㄉㄠ4/ㄌㄜ5/ㄅㄤ4ㄨㄢ3, ㄕㄤ1ㄔㄤ2/ㄉㄜ5/ㄉㄥ1'
            'ㄍㄨㄤ1/ㄌㄧㄤ4/ㄑㄧ3ㄌㄞ5, ㄋㄧㄢ2ㄑㄧㄥ1ㄖㄣ2/ㄩㄝ1/ㄆㄥ2ㄧㄡ5/ㄧ4ㄑㄧ3/ㄔㄭ1ㄈㄢ4, ㄎ'
            'ㄢ4/ㄉㄧㄢ4ㄧㄥ3. ㄐㄩ4ㄊㄨㄥ3ㄐㄧ4, ㄓㄜ4/ㄗㄨㄛ4/ㄔㄥ2ㄕㄭ4/ㄑㄩ4ㄋㄧㄢ2/ㄐㄧㄝ1ㄉㄞ4/'
            'ㄧㄡ2ㄎㄜ4/ㄔㄠ1ㄍㄨㄛ4/ㄙㄢ1ㄑㄧㄢ1/ㄦ4ㄅㄞ3/ㄨㄢ4ㄖㄣ2ㄘㄭ4, ㄅㄧ3/ㄑㄧㄢ2ㄋㄧㄢ2/ㄗㄥ1'
            'ㄓㄤ3/ㄌㄜ5/ㄅㄞ3ㄈㄣ1ㄓㄭ1ㄕㄭ2/ㄦ4ㄉㄧㄢ3ㄨ3. ㄧㄝ4ㄕㄣ1/ㄌㄜ5, ㄔㄥ2ㄕㄭ4/ㄇㄢ4ㄇㄢ4'
            '/ㄢ1ㄐㄧㄥ4ㄒㄧㄚ4ㄌㄞ5, ㄓㄭ2ㄧㄡ3/ㄩㄢ2ㄔㄨ3/ㄉㄜ5/ㄏㄨㄛ4ㄔㄜ1/ㄏㄞ2/ㄗㄞ4/ㄩㄣ4ㄙㄨㄥ'
            '4/ㄇㄧㄥ2ㄊㄧㄢ1/ㄒㄩ1ㄧㄠ4/ㄉㄜ5/ㄕㄨ1ㄘㄞ4/ㄏㄜ2/ㄕㄨㄟ2ㄍㄨㄛ3.',
            'kʊŋ→ɥɛn↗ li↗jou↓ʐən↗ ɕja↘tɕʰi↗, jou↓ʐən↗ san↘pu↘, xai↗jo'
            'u↓ ʐən↗ tswo↘tsai↘ ʈʂʰaŋ↗i↓ ʂaŋ↘tu↗ pau↘ʈʂɨ↓. tau↘ lɤ pa'
            'ŋ↘wan↓, ʂaŋ→ʈʂʰaŋ↗ tɤ təŋ→kwaŋ→ ljaŋ↘ tɕʰi↓lai, njɛn↗tɕʰ'
            'iŋ→ʐən↗ ɥe→ pʰəŋ↗jou i↘tɕʰi↓ ʈʂʰɨ→fan↘, kʰan↘ tjɛn↘iŋ↓. '
            'tɕy↘tʰʊŋ↓tɕi↘, ʈʂɤ↘ tswo↘ ʈʂʰəŋ↗ʂɨ↘ tɕʰy↘njɛn↗ tɕje→tai↘'
            ' jou↗kʰɤ↘ ʈʂʰau→kwo↘ san→tɕʰjɛn→ ɚ↘pai↓ wan↘ʐən↗tsʰɨ↘, p'
            'i↓ tɕʰjɛn↗njɛn↗ tsəŋ→ʈʂaŋ↓ lɤ pai↓fən→ʈʂɨ→ʂɨ↗ ɚ↘tjɛn↓u↓.'
            ' je↘ʂən→ lɤ, ʈʂʰəŋ↗ʂɨ↘ man↘man↘ an→tɕiŋ↘ɕja↘lai, ʈʂɨ↗jou'
            '↓ ɥɛn↗ʈʂʰu↓ tɤ xwo↘ʈʂʰɤ→ xai↗ tsai↘ yn↘sʊŋ↘ miŋ↗tʰjɛn→ ɕ'
            'y→jau↘ tɤ ʂu→tsʰai↘ xɤ↗ ʂwei↗kwo↓.',
        ],
        '公园里有人下棋，有人散步，还有人坐在长椅上读报纸。到了傍晚，商场的灯光亮起来，年轻人约朋友一起吃饭、看电影。据统'
        '计，': [
            'ㄍㄨㄥ1ㄩㄢ2/ㄌㄧ2ㄧㄡ3ㄖㄣ2/ㄒㄧㄚ4ㄑㄧ2, ㄧㄡ3ㄖㄣ2/ㄙㄢ4ㄅㄨ4, ㄏㄞ2ㄧㄡ3/ㄖㄣ2/ㄗㄨㄛ'
            '4ㄗㄞ4/ㄔㄤ2ㄧ3/ㄕㄤ4ㄉㄨ2/ㄅㄠ4ㄓㄭ3. ㄉㄠ4/ㄌㄜ5/ㄅㄤ4ㄨㄢ3, ㄕㄤ1ㄔㄤ2/ㄉㄜ5/ㄉㄥ1'
            'ㄍㄨㄤ1/ㄌㄧㄤ4/ㄑㄧ3ㄌㄞ5, ㄋㄧㄢ2ㄑㄧㄥ1ㄖㄣ2/ㄩㄝ1/ㄆㄥ2ㄧㄡ5/ㄧ4ㄑㄧ3/ㄔㄭ1ㄈㄢ4, ㄎ'
            'ㄢ4/ㄉㄧㄢ4ㄧㄥ3. ㄐㄩ4ㄊㄨㄥ3ㄐㄧ4,',
            'kʊŋ→ɥɛn↗ li↗jou↓ʐən↗ ɕja↘tɕʰi↗, jou↓ʐən↗ san↘pu↘, xai↗jo'
            'u↓ ʐən↗ tswo↘tsai↘ ʈʂʰaŋ↗i↓ ʂaŋ↘tu↗ pau↘ʈʂɨ↓. tau↘ lɤ pa'
            'ŋ↘wan↓, ʂaŋ→ʈʂʰaŋ↗ tɤ təŋ→kwaŋ→ ljaŋ↘ tɕʰi↓lai, njɛn↗tɕʰ'
            'iŋ→ʐən↗ ɥe→ pʰəŋ↗jou i↘tɕʰi↓ ʈʂʰɨ→fan↘, kʰan↘ tjɛn↘iŋ↓. '
            'tɕy↘tʰʊŋ↓tɕi↘,',
        ],
        '这座城市去年接待游客超过三千二百万人次，比前年增长了百分之十二点五。夜深了，城市慢慢安静下来，只有远处的货车还在'
        '运送明天需要的蔬菜和水果。': [
            'ㄓㄜ4/ㄗㄨㄛ4/ㄔㄥ2ㄕㄭ4/ㄑㄩ4ㄋㄧㄢ2/ㄐㄧㄝ1ㄉㄞ4/ㄧㄡ2ㄎㄜ4/ㄔㄠ1ㄍㄨㄛ4/ㄙㄢ1ㄑㄧㄢ1/ㄦ'
            '4ㄅㄞ3/ㄨㄢ4ㄖㄣ2ㄘㄭ4, ㄅㄧ3/ㄑㄧㄢ2ㄋㄧㄢ2/ㄗㄥ1ㄓㄤ3/ㄌㄜ5/ㄅㄞ3ㄈㄣ1ㄓㄭ1ㄕㄭ2/ㄦ4ㄉ'
            'ㄧㄢ3ㄨ3. ㄧㄝ4ㄕㄣ1/ㄌㄜ5, ㄔㄥ2ㄕㄭ4/ㄇㄢ4ㄇㄢ4/ㄢ1ㄐㄧㄥ4ㄒㄧㄚ4ㄌㄞ5, ㄓㄭ2ㄧㄡ3/ㄩ'
            'ㄢ2ㄔㄨ3/ㄉㄜ5/ㄏㄨㄛ4ㄔㄜ1/ㄏㄞ2/ㄗㄞ4/ㄩㄣ4ㄙㄨㄥ4/ㄇㄧㄥ2ㄊㄧㄢ1/ㄒㄩ1ㄧㄠ4/ㄉㄜ5/ㄕㄨ'
            '1ㄘㄞ4/ㄏㄜ2/ㄕㄨㄟ2ㄍㄨㄛ3.',
            'ʈʂɤ↘ tswo↘ ʈʂʰəŋ↗ʂɨ↘ tɕʰy↘njɛn↗ tɕje→tai↘ jou↗kʰɤ↘ ʈʂʰau'
            '→kwo↘ san→tɕʰjɛn→ ɚ↘pai↓ wan↘ʐən↗tsʰɨ↘, pi↓ tɕʰjɛn↗njɛn↗'
            ' tsəŋ→ʈʂaŋ↓ lɤ pai↓fən→ʈʂɨ→ʂɨ↗ ɚ↘tjɛn↓u↓. je↘ʂən→ lɤ, ʈʂ'
            'ʰəŋ↗ʂɨ↘ man↘man↘ an→tɕiŋ↘ɕja↘lai, ʈʂɨ↗jou↓ ɥɛn↗ʈʂʰu↓ tɤ '
            'xwo↘ʈʂʰɤ→ xai↗ tsai↘ yn↘sʊŋ↘ miŋ↗tʰjɛn→ ɕy→jau↘ tɤ ʂu→ts'
            'ʰai↘ xɤ↗ ʂwei↗kwo↓.',
        ],
        '欢迎收听今天的新闻。 This is the evening report, with the weather '
        'and the traffic.': [
            'ㄏㄨㄢ1ㄧㄥ2/ㄕㄡ1ㄊㄧㄥ1/ㄐㄧㄣ1ㄊㄧㄢ1/ㄉㄜ5/ㄒㄧㄣ1ㄨㄣ2. ðɪs ɪz ði ˈivnɪŋ ɹ'
            'ɪpˈɔɹt , wɪð ðə wˈɛðɚ ænd ðə tɹˈæfɪk .',
            'xwan→iŋ↗ ʂou→tʰiŋ→ tɕin→tʰjɛn→ tɤ ɕin→wən↗. ðɪs ɪz ði ˈi'
            'vnɪŋ ɹɪpˈɔɹt , wɪð ðə wˈɛðɚ ænd ðə tɹˈæfɪk .',
        ],
    },
    "words": {
        '今天天气真好，我们去公园散步。': [
            ['今天天气', 'tɕin→tʰjɛn→tʰjɛn→tɕʰi↘'],
            ['真', 'ʈʂən→'],
            ['好', 'xau↓'],
            [',', ','],
            ['我们', 'wo↓mən'],
            ['去', 'tɕʰy↘'],
            ['公园', 'kʊŋ→ɥɛn↗'],
            ['散步', 'san↘pu↘'],
            ['.', '.'],
        ],
    },
}


if __name__ == "__main__":
    main()
