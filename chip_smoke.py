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
   the eager route the head replaced and ``torch.istft``; the AdaIN
   statistics pass, ``adain_fold`` (the masked instance moments and the
   AdaIN fold, f32 and bf16 x; its moments-only form, which ``AdaIN1d``
   takes, at the same shapes), within ``ADAIN_TOL`` of its plain version's
   peak and bitwise repeatable at ragged, unmasked and all-zero masks, timed
   at ``ADAIN_TIMED`` beside its byte bound and ``torch.var_mean``; at the
   end of the run it is held to its plain version again at every shape the
   main path gave it); then (3b) the row extents: each bf16 conv form and
   the AdaIN pass given the mask's row extents, bitwise to the same launch
   with full extents and without, at ``EXTENT_SHAPES`` and every (k, d),
   the columns tally against ``work_plan``, and each conv form timed at
   the offline cell's extents and at full extents (``check_extents``;
   ``scripts/conv_extents.py`` times a Generator pass and the full-mask
   shapes against another checkout);
4. drives the batch path — ``Synthesizer.synthesize_batch`` and
   ``dispatch -> launch_decode -> collect`` at the full ``KokoroConfig()``
   with seeded random weights and a random voice — on three requests in
   pcm16, f32, mulaw8k and mulaw24k, and checks lengths, finiteness,
   non-silence and that every kernel ran as often as each stage B runs it
   (the iSTFT kernel once per Generator pass, each fused conv form once a
   residual step, the AdaIN pass once per AdaIN: 70 a stage B, of which a
   windowed stream's prepare runs 22 and each window 48:
   ``kernel_launches``);
5. drives the streaming path: exact streams concatenate bit for bit to
   ``collect()``; a windowed stream's first use captures its prepare and
   window graphs (its time and each capture's warm pass and lock time on
   a line of their own; launches: one Generator pass per window plus the
   window's warm pass), then the timed windowed stream replays them and
   gives finite, non-silent chunks of the right count and length, with
   every kernel launched per window as per stage B; and the mulaw24k
   bytes equal ``mulaw_encode_np`` of the card's own int16 rendering; then
   holds each kernel against its plain version at the shapes both paths
   gave it;
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
   ``process(segment_text=True)`` and a windowed ``stream_process`` (its
   first use, which captures, on a line of its own, then one replayed). On
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
   alphas and AdaIN fcs non-zero; the noise blocks, whose output a silent
   harmonic source leaves to rounding, their convs and AdaIN passes plain
   in both passes: ``NOISE_BLOCK``; the F0/N towers' and the trunk's
   ``AdaIN1d`` moments plain in both passes: ``gradient_passes``; the
   Generator's other AdaIN passes through the kernel;
   ``scripts/grad_check_repeat.py`` repeats this comparison),
   forward/backward ms per step and each kernel's backward recompute at the
   training shape, one adversarial step,
   a checkpoint resumed (the next step's loss equal to an uninterrupted
   run's), and 3 ``adapt_voice`` steps on ``rendered_batches`` (a finite
   style, a non-zero style gradient). Every teacher-forced forward must
   launch each kernel as one Generator pass does; the backward launches
   none;
11. serves in bfloat16, ``KokoroConfig(dtype=torch.bfloat16)`` on the same
   weights: the bf16 forms of the three kernels against their plain bf16
   versions (``BF16_TOL`` of the output's peak, the share of bitwise-equal
   outputs printed; the bf16 head bitwise the f32 head of ``x.float()``),
   bitwise repeatable, at the main path's shapes and at edges (ragged and
   short L, C_in = 24, C = 256, k in {3, 7, 11}, d in {1, 3, 5}, all-zero
   masks), timed beside their bound, cuDNN's bf16 conv and the f32 forms,
   the halo tile at each column tile and the carry's walking chunks beside
   one-tile chunks; bench.py's serving shape (B=32, 256 tokens, frame
   bucket 512) in pcm16 and mulaw8k
   beside the f32 engine, with exact launches (each bf16 form as often as
   the Generator passes give, no f32 form; none in the f32 engine); zh_1 in
   the four formats, an exact stream bitwise equal to ``collect()`` and a
   windowed stream (its first use, then replayed: first-chunk ms); and the
   card's bf16 render of zh_1
   against the CPU's: frame totals within ``FRAME_SLACK`` and mel-L1(card
   bf16, CPU bf16) <= mel-L1(CPU bf16, CPU f32);
12. warms the engine as CUDA graphs (``Synthesizer.warmup``), under cuDNN's
   deterministic algorithms: phase 4's engine captures phase 4's three keys
   in the four formats (3 stage-A and 12 stage-B graphs; each capture's
   seconds, the allocator's growth and the graph pool's bytes printed; a
   call that brings a larger key rebuilds the pool, its keys and lock time
   printed),
   then serves the same requests again: every key replays, the audio is
   bitwise equal to the
   same engine's eager render before the warmup, the launches are exact with
   the replays counted, two batches of one key in flight at once keep their
   own outputs, exact streams of replayed handles concatenate to
   ``collect()``; wall time eager (a fresh engine on the same weights)
   against replayed, in turns, per request and format, and through the
   scheduler (phase 7's first batch); bench.py's shape in bf16 (pcm16,
   mulaw8k) replayed bitwise equal to eager, with exact bf16 launches, and
   timed; windowed streams of zh_1 and mixed_4 in float32 and of zh_1 in
   bfloat16, each on a fresh engine: its first use (the prepare and window
   graphs captured: extra seconds, lock time and the allocator's growth
   per key) and its replays bitwise equal to the eager reference loop
   (``eager_windowed_stream``: host-int starts, blocking copies), with
   exact launches, and first-chunk and whole-stream ms, eager reference
   against replayed, medians of 5 in turns; two zh_1 streams of one key
   (pitch 1 and 1.3), their windows interleaved, each bitwise equal to its
   eager reference; the first use of long_8's stream keys (B=8, F 4096),
   to its first chunk: lock time and the allocator's growth per key;
   ``create_app`` with
   ``TTS_WARMUP=1`` on a fresh engine (startup to ready, the first
   request's stages replayed, the background pass, a request of another
   warmed shape replayed); ``load_params`` on the warmed engine leaves no
   graph and renders bitwise as a fresh engine on those weights;
13. runs data parallelism (``parallel/mesh.py``) as two and three
   replicas sharing the one card, under cuDNN's deterministic algorithms,
   on phase 4's weights: ``make_mesh`` over the card (and past its count:
   the JAX assert), then zh_1, mixed_4 and a B=8 batch in pcm16 and
   mulaw8k and mixed_4 in f32 on two replicas (each replica's rows bitwise
   equal to the one-device engine's render of them at the shard's batch
   size and the batch's buckets; in pcm16 and f32 the gathered batch
   within the golden gate, rms/scale < 5e-3, of the one-device render of
   the whole batch, whose other shapes let cuDNN and cuBLAS sum in other
   orders; in mu-law that distance is printed), mixed_4 padded
   to 6 rows on three (bitwise the two replicas' render); ``warmup`` of mixed_4's key on every replica
   (replays bitwise equal to eager), an exact and a windowed stream of a
   one-request handle (first use, then replayed: bitwise equal, and equal
   to the one-device engine's); two concurrent requests through
   ``create_app`` over ``TTSPipeline(mesh=)`` with ``FrozenG2P`` (WAV bodies
   equal to the mesh engine's render of the batches the scheduler formed);
   B=8 wall time, two replicas against one device, in turns; ``train(mesh=
   <2 replicas>)`` at B=8 / 64 tokens / 128 frames, step 0 against a
   one-device step on the same batch (phase 10's loss tolerances; each
   weight's update within two steps of lr, at most 1% of entries off by
   1e-3 lr: Adam's first step is the gradient's sign), then a step after a
   resume; a bfloat16 ``train`` whose float32 master starts from the
   float32 weights (``master=``; B=2, 2 steps), step 0
   against the CPU's bf16 step; every Generator pass launching each kernel
   once per replica, and each kernel held against its plain version at the
   replicas' shapes.
14. Tensor parallelism: the 'model' axis, its shards sharing cuda:0
   (``make_mesh(1, 2, devices=[cuda:0] * 2)`` and ``make_mesh(2, 2,
   devices=[cuda:0] * 4)``), under deterministic cuDNN. Both conv kernels,
   f32 and bf16 forms, against their plain versions at a 2-way split's
   shapes (B=8, C_in 256 -> C_out 128 and 128 -> 64, every (k, d) of the
   Generator; phase 3's and phase 11's tolerances) and timed beside their
   bounds and cuDNN; zh_1 and mixed_4 in every format through the 1 x 2
   and 2 x 2 engines against the one-device engine (pcm16/f32 within the
   golden gate, mu-law's distance printed), each fused step launched once
   per shard and the head once per replica; a windowed stream (first use
   and replayed, bitwise each other, within the golden gate of the
   one-device stream); ``warmup`` of mixed_4's key on both meshes (replays
   bitwise the eager render, pool bytes printed); a bf16 request on 1 x 2;
   B=8 wall, eager and replayed, 1 x 2 against one device (for
   information); ``train(mesh=<1 x 2>)`` step 0 against one device (each
   loss within 1e-5 relative, phase 13's update check) and a bf16 step;
   then each kernel against its plain version at the shapes the shards
   gave it;
15. measures the graph pool (``pool_phase``; ``scripts/graph_pool.py``
   runs it alone), under deterministic cuDNN: a
   fresh engine's ``warmup()`` with the JAX engine's default arguments (4
   stage-A and 48 stage-B keys; each capture's growth in capture order,
   the pool's bytes, the wall time; a B=1 and a B=4 request replayed
   bitwise equal to their eager renders with exact launches), then two
   windowed streams' first use on it, at (4, 256, 4096) and (1, 32, 1024)
   (each stream key's growth); and the largest key captured alone in a
   fresh engine beside its stage run eagerly and captured by hand from an
   emptied cache (allocated peak, reserved growth, segments).

It prints a ``{"kernels": [...]}`` JSON line (one row per kernel form,
``adain_fold`` and ``adain_fold_bf16`` among them; each kernel's launches
per phase; ``launches_replayed``: those of phase 12's batch replays;
``launches_stream_replayed``: those of its replayed windowed streams;
``launches_mesh``: those of phase 13; ``launches_tp``: those of phase 14;
``launches_pool``: those of phase 15's two replays;
``split_shapes``: the convs at phase 14's split shapes), each phase's
summary as a JSON line (phase 15's ``{"pool": ...}``) and, last,
``{"ok": true, "device": {...}}``. Any failed check exits non-zero with no
result line;
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
# tensor-core) operations/s, dense TF32 and bf16 tensor-core operations/s
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
TF32_OPS_PER_S = 495e12
BF16_OPS_PER_S = 989e12

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
# The same silent source makes the Generator's noise blocks (noise_res_i,
# after noise_conv_i) a branch whose output is decided by rounding: their
# AdaINs divide a channel that is constant in time up to rounding by
# sqrt(var + 1e-5), and the branch's output is added to the main path, so
# it reaches every leaf: the comparison then measures the rounding of the
# kernels against cuDNN's in that branch, not the kernels' gradients
# (tests/test_torch_training.py::test_noise_blocks_set_the_gradient_spread;
# scripts/grad_check_repeat.py reports both comparisons on the card). So
# both gradient passes run the noise blocks' fused convs and AdaIN passes
# plain.
NOISE_BLOCK = "noise_res_"

# phase 11, bf16: each bf16 form against its plain bf16 version, max
# |kernel - plain| over max |plain| (one bfloat16 ulp at the output's peak:
# both round one float32 sum, summed in other orders); bf16 form -> its
# float32 form
BF16_TOL = 2.0 ** -7
BF16_CONV = {"adain_snake_conv_bf16": "adain_snake_conv",
             "adain_snake_conv_carry_bf16": "adain_snake_conv_carry"}
# bench.py's serving shape (B=32, 256 tokens, frame bucket 512) and text
BENCH = {"batch": 32, "tokens": 256, "frames": 512}
BENCH_TEXT = ("ni↗xau↓ma, tsʰɤ↘ʂɨ↘i↗kɤ↘tʰəst. " * 12)[:250]
FRAME_SLACK = 2  # frames per item, the card's bf16 render vs the CPU's

ZH = "ni→xau↓ma, tsʰɤ↘ʂɨ↘i↗kɤ↘tʰəst."
MIXED = "tʰjɛn→tʃʰi↘tʃən→pu↗tsʰwo↘. hello wɝld."
EN = "ðɪs ɪz ə smˈoʊk tˈɛst ʌv ðə pˈɔɹt."
FORMATS = ("pcm16", "f32", "mulaw8k", "mulaw24k")
# the three requests of phase 4 on: latency (B=1), mixed (B=4), throughput
# (B=8, T 256, F 4096)
REQUESTS = {
    "zh_1": [ZH],
    "mixed_4": [ZH, MIXED, EN, ZH + " " + EN],
    "long_8": [" ".join([ZH, MIXED, ZH, MIXED, ZH]),
               " ".join([EN, MIXED, EN, ZH])] * 4,
}
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
# the AdaIN statistics pass (ops/adain_moments.py): scale and shift, and the
# moments-only form's mean and rstd, each within 1e-5 of their largest
# magnitude of the plain version's (both sum in float32, in other orders)
ADAIN_TOL = 1e-5
# its launches per stage B besides the Generator's two a fused step: the
# AdaIN1d's of the F0/N towers (2 towers x 3 blocks x 2) and of the decoder
# trunk (5 blocks x 2), which a windowed stream runs once, in its prepare
ADAIN_FRONT = 22
# its timed shapes (B, C, L, x dtype): b8's second stage, bench.py's two
# stages (bf16), zh_1's second stage (F 1024), a B=1 stream window's first
# stage, long_8's second stage (F 4096)
ADAIN_TIMED = ((8, 128, 61440, "float32"), (32, 128, 61440, "bfloat16"),
               (32, 256, 10240, "bfloat16"), (1, 128, 122880, "float32"),
               (1, 256, 1920, "float32"), (8, 128, 491520, "float32"))
# (B, C, L, x dtype, mask kind) of each call the main path made, recorded
# by ``record_shapes`` (phases 4-5, 7, 8, 10, 11 and 13); ``main`` holds
# the pass against its plain version at each
ADAIN_SEEN = set()


def kernel_launches(name, conv_per_generator, passes, fronts=None,
                    skipped=0):
    """Launches of kernel ``name`` (either form) in ``passes`` Generator
    passes, each ``skipped`` fused steps of each form short (phase 10's
    plain noise blocks), and ``fronts`` runs of the F0/N towers and the
    decoder trunk (one a pass where None; a windowed stream runs them in
    its prepare stage): the iSTFT head once a pass, each fused conv form
    once a step, the AdaIN pass twice a step and ``ADAIN_FRONT`` times a
    front."""
    if "istft" in name:
        return passes
    steps = (conv_per_generator - skipped) * passes
    if name.startswith("adain_fold"):
        return 2 * steps + ADAIN_FRONT * (passes if fronts is None
                                          else fronts)
    return steps


def first_use_fronts(summary):
    """The fronts a windowed stream's first use ran (``first_use``'s
    summary): the prepare's replay, and its warm pass where the prepare's
    key was captured then."""
    return 1 + sum("'prep'" in key for key in summary["keys"])


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


def time_carry_walk(torch, asc, flush, shape, bf16=False):
    """The carry kernel's walking chunks (the wrapper's choice where the
    carry buffer fits: about one wave of CTAs, one per SM) against one-tile
    chunks, which carry nothing; both must give the same bits. ``bf16``:
    the bf16 form."""
    batch, channels, length, k, d = shape
    args = (bf16_inputs(torch, asc, batch, channels, length, k, seed=99)
            if bf16 else conv_inputs(torch, batch, channels, length, k,
                                     seed=99))
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    tile_len = asc.column_tile(batch, channels, length, sms, bf16)
    walk = asc.carry_tiles_per_chunk(batch, channels, channels, length, k, d,
                                     sms, tile_len, bf16)
    if walk == 1:
        fail(f"carry kernel: no walking chunks at {list(shape)}")
    fn = (asc._library().adain_snake_conv_carry_bf16 if bf16
          else asc._library().adain_snake_conv_carry_f32)

    def launch(per_chunk):
        return asc._launch(fn, *args, k, d, tile_len, per_chunk)

    if not torch.equal(launch(walk), launch(1)):
        fail(f"carry kernel: {walk}-tile chunks differ from one-tile chunks")
    out = {"shape": list(shape),
           "one_tile_chunks_ms": cuda_ms(lambda: launch(1), 20, flush),
           "walking_chunks_ms": cuda_ms(lambda: launch(walk), 20, flush),
           "walking_tiles_per_chunk": walk}
    log(f"adain_snake_conv_carry{'_bf16' if bf16 else ''} at "
        f"{list(shape)} ({tile_len}-column tiles): one-tile chunks "
        f"{out['one_tile_chunks_ms']:.4f} ms, {walk}-tile walking chunks "
        f"{out['walking_chunks_ms']:.4f} ms (bitwise equal; the wrapper "
        "walks)")
    return out


def time_tile_lens(torch, asc, flush, shape, bf16=False):
    """The halo-tile kernel at each column tile, one tile a CTA: the source
    of the wrapper's ``TILE_COST`` (``TILE_COST_BF16`` for ``bf16``)."""
    batch, channels, length, k, d = shape
    if bf16:
        args = bf16_inputs(torch, asc, batch, channels, length, k, seed=99)
        fn, lens = asc._library().adain_snake_conv_bf16, asc.TILE_LENS_BF16
    else:
        args = conv_inputs(torch, batch, channels, length, k, seed=99)
        fn, lens = asc._library().adain_snake_conv_f32, asc.TILE_LENS
    out = {}
    for tile_len in lens:
        asc._launch(fn, *args, k, d, tile_len, 1)
        out[tile_len] = cuda_ms(lambda: asc._launch(fn, *args, k, d,
                                                    tile_len, 1), 10, flush)
    tiles = {tl: -(-length // tl) for tl in out}
    top = lens[0]
    log(f"adain_snake_conv{'_bf16' if bf16 else ''} at {list(shape)} by "
        "column tile: " + ", ".join(
            f"{tl}: {ms:.4f} ms ({ms / out[top] * tiles[top] / tiles[tl]:.2f}"
            f" of a {top}-column CTA's time)" for tl, ms in out.items()))
    return {"shape": list(shape), "ms_by_tile_len": out}


def adain_inputs(torch, batch, channels, length, dtype, seed,
                 mask="ragged"):
    """x [B, C, L] in ``dtype``, the mask [B, L] (``ragged``: row i keeps
    L - i L / (B + 1) columns, the last row of a batch above 1 none;
    ``zero``: all zero; ``none``: no mask), gamma and beta [B, C] as the
    halves of one fc output [B, 2C], as the layers hand them over."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    x = (torch.randn(batch, channels, length, device="cuda", generator=gen)
         * 1.5 + 0.3).to(getattr(torch, dtype))
    m = None
    if mask != "none":
        keep = [length - i * length // (batch + 1) for i in range(batch)]
        if batch > 1:
            keep[-1] = 0
        m = (torch.arange(length, device="cuda")[None, :]
             < torch.tensor(keep, device="cuda")[:, None]).float()
        if mask == "zero":
            m.zero_()
    style = 0.3 * torch.randn(batch, 2 * channels, device="cuda",
                              generator=gen)
    return (x, m, *style.chunk(2, dim=1))


def check_adain(torch, am, cases):
    """The AdaIN pass vs its plain version at each (B, C, L, x dtype, mask
    kind), the fold and the moments-only form -> (max error over the
    output's peak, max abs error), over scale, shift, mean and rstd; two
    launches must agree bitwise, and an all-zero mask row must give shift =
    beta and mean = 0 exactly."""
    worst, worst_abs = 0.0, 0.0
    for i, (batch, channels, length, dtype, mask) in enumerate(cases):
        args = adain_inputs(torch, batch, channels, length, dtype, i, mask)
        for style, parts in ((args[2:], ("scale", "shift")),
                             ((None, None), ("mean", "rstd"))):
            got = am.adain_fold(*args[:2], *style)
            again = am.adain_fold(*args[:2], *style)
            torch.cuda.synchronize()
            ref = am.adain_fold_plain(*args[:2], *style)
            for part, g, a, r in zip(parts, got, again, ref):
                if g.shape != (batch, channels) or g.dtype != torch.float32:
                    fail(f"adain_fold {part}: {tuple(g.shape)} {g.dtype}")
                if not torch.equal(g, a):
                    fail(f"adain_fold {part}: two launches differ at "
                         f"{cases[i]}")
                err = float((g - r).abs().max())
                over = err / max(float(r.abs().max()), 1e-30)
                if not over <= ADAIN_TOL:
                    fail(f"adain_fold {part} disagrees with plain at "
                         f"{cases[i]}: {over} of its peak > {ADAIN_TOL}")
                worst, worst_abs = max(worst, over), max(worst_abs, err)
            zero_rows = ([batch - 1] if mask == "ragged" and batch > 1 else
                         range(batch) if mask == "zero" else [])
            for row in zero_rows:
                if parts[0] == "scale" and not torch.equal(got[1][row],
                                                           args[3][row]):
                    fail(f"adain_fold: an all-zero mask row's shift is not "
                         f"beta at {cases[i]}")
                if parts[0] == "mean" and got[0][row].any():
                    fail(f"adain_fold: an all-zero mask row's mean is not 0 "
                         f"at {cases[i]}")
            del got, again, ref
        del args
    log(f"  adain_fold: {len(cases)} shapes, the fold and the moments, "
        f"max|kernel - plain| / max|plain| = {worst:.3e} (limit "
        f"{ADAIN_TOL}), max abs {worst_abs:.3e}; two launches bitwise equal "
        "at each")
    return worst, worst_abs


def time_adain(torch, am, flush, shape, card, reps=20):
    """The AdaIN pass (both launches), its plain version and
    ``torch.var_mean`` (the unmasked moments alone, one call) ms at (B, C,
    L, x dtype), ragged mask, beside its bound: x, the mask, gamma and beta
    read once, scale and shift written once, over HBM; its f32 operations
    (x m, two sums, the centered square, its weight and its sum: 7 an
    element) over the f32 CUDA-core rate."""
    batch, channels, length, dtype = shape
    x, m, gamma, beta = adain_inputs(torch, batch, channels, length, dtype,
                                     seed=99)
    calls = {
        "ms": lambda: am.adain_fold(x, m, gamma, beta),
        "plain_ms": lambda: am.adain_fold_plain(x, m, gamma, beta),
        "library_ms": lambda: torch.var_mean(x, dim=-1, correction=0),
    }
    for call in calls.values():
        call()
    out = {key: cuda_ms(call, reps, flush) for key, call in calls.items()}
    n_bytes = (x.numel() * x.element_size() + m.numel() * 4
               + 4 * gamma.numel() * 4)
    out["bound_ms"], out["bound_by"] = bound(n_bytes, 7 * x.numel())
    out["bound_share"] = out["bound_ms"] / out["ms"]
    out["shape"] = [batch, channels, length, dtype]
    log(f"adain_fold at B={batch}, C={channels}, L={length}, {dtype}: "
        f"kernel {out['ms']:.4f} ms ({out['bound_share']:.2f} of its bound "
        f"{out['bound_ms']:.4f} ms, {out['bound_by']}), plain "
        f"{out['plain_ms']:.4f} ms, torch.var_mean (unmasked, no fold) "
        f"{out['library_ms']:.4f} ms ({card})")
    del x, m, gamma, beta
    return out


def adain_phase(torch, am, flush, card):
    """Phase 3, the AdaIN pass: held against its plain version at the
    timed shapes, ragged, unmasked and all-zero masks and short and ragged
    L, then timed at ``ADAIN_TIMED``. -> {form: kernels-line row}."""
    t0 = time.perf_counter()
    log("adain_fold kernel vs plain (ragged masks, the last row of each "
        "batch masked whole):")
    cases = [(*shape, "ragged") for shape in ADAIN_TIMED] + [
        (8, 128, 61440, "float32", "none"),
        (32, 128, 61440, "bfloat16", "none"),
        (3, 128, 1000, "float32", "ragged"),     # L shorter than a chunk
        (2, 64, 37, "bfloat16", "ragged"),
        (2, 256, 4097, "float32", "zero"),      # one element past a chunk
        (3, 512, 8193, "bfloat16", "ragged"),
        (1, 256, 1920, "bfloat16", "none"),
    ]
    err, err_abs = check_adain(torch, am, cases)
    rows = {}
    for name, dtype in (("adain_fold", "float32"),
                        ("adain_fold_bf16", "bfloat16")):
        timed = [time_adain(torch, am, flush, shape, card, reps=10)
                 for shape in ADAIN_TIMED if shape[3] == dtype]
        rows[name] = {"err_over_peak": err, "max_abs_err": err_abs,
                      **{key: timed[0][key] for key in (
                          "ms", "plain_ms", "library_ms", "bound_ms",
                          "bound_by", "bound_share", "shape")},
                      "more_shapes": timed[1:]}
    log(f"adain_fold checked and timed in {time.perf_counter() - t0:.1f} s "
        f"({card})")
    return rows


def recorded_fold(fn, shapes):
    """The AdaIN pass ``fn`` that also records each call's (B, C, L, x
    dtype, mask kind)."""
    def call(x, mask, gamma, beta, extent=None):
        shapes.add((*x.shape, str(x.dtype).split(".")[-1],
                    "none" if mask is None else "ragged"))
        return fn(x, mask, gamma, beta, extent=extent)
    return call


def recorded(fn, shapes):
    """``fn`` that also records each call's (B, C_in, L, k, d)."""
    def call(x, mask, scale, shift, alpha, w, b, kernel, dilation=1,
             extent=None):
        shapes.add((x.shape[0], x.shape[1], x.shape[2], kernel, dilation))
        return fn(x, mask, scale, shift, alpha, w, b, kernel, dilation,
                  extent=extent)
    return call


def recorded_head(fn, shapes):
    """The iSTFT head ``fn`` that also records each call's (B, L)."""
    def call(x, n_fft, hop):
        shapes.add((x.shape[0], x.shape[2]))
        return fn(x, n_fft, hop)
    return call


def record_shapes(layers, vocoder, asc, oa):
    """Route the Generator's kernel calls through recorders -> (conv shapes
    by kernel, head shapes), the AdaIN pass's shapes into ``ADAIN_SEEN``;
    ``unrecord`` routes them back."""
    from illufly_tts_tpu_torch.ops import adain_moments as am

    conv_shapes = {name: set() for name in CONV_KERNELS}
    for name in CONV_KERNELS:  # the blocks call through the module names
        setattr(layers, name, recorded(getattr(asc, name), conv_shapes[name]))
    layers.adain_fold = recorded_fold(am.adain_fold, ADAIN_SEEN)
    head_shapes = set()
    vocoder.istft_head = recorded_head(oa.istft_head, head_shapes)
    return conv_shapes, head_shapes


def unrecord(layers, vocoder, asc, oa):
    from illufly_tts_tpu_torch.ops import adain_moments as am

    for name in CONV_KERNELS:
        setattr(layers, name, getattr(asc, name))
    layers.adain_fold = am.adain_fold
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

    from illufly_tts_tpu_torch.ops import adain_moments as am
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
        for table in (asc.launches, am.launches):
            for name in table:
                table[name] = 0
        passes.clear()
        dispatched.clear()

    def counts(label, generator_passes, fronts=None):
        got = {"istft_oa": oa.launches, **asc.launches, **am.launches}
        want = {name: kernel_launches(name, conv_per_generator,
                                      generator_passes, fronts)
                for name in got}
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

        # one windowed stream: its first use captures the prepare and
        # window graphs of its key (the window's warm pass is one more
        # Generator pass); the timed one replays them
        def stream():
            t0 = time.perf_counter()
            gen = pipe.stream_process(STREAM_TEXT, "smoke_voice",
                                      window_frames=STREAM_WINDOW,
                                      halo_frames=STREAM_HALO, exact=False)
            chunks = [next(gen)]
            first_chunk_ms = (time.perf_counter() - t0) * 1e3
            chunks += list(gen)
            return chunks, first_chunk_ms, (time.perf_counter() - t0) * 1e3

        reset()
        (chunks, _, _), stream_first_use = first_use(
            synth, stream, "windowed stream_process", card)
        (_, _, h), = dispatched
        windows = -(-int(h.fitted_totals[0]) // STREAM_WINDOW)
        counts(f"windowed stream, first use ({windows} windows)",
               windows + 1, first_use_fronts(stream_first_use))
        reset()
        chunks, first_chunk_ms, stream_ms = stream()
        (ipa_list, _, h), = dispatched
        total = int(h.fitted_totals[0])
        windows = -(-total // STREAM_WINDOW)
        stream_launches = counts(f"windowed stream ({windows} windows)",
                                 windows, 1)
        if ipa_list != [expected_ipa(STREAM_TEXT)]:
            failures.append("the stream's IPA differs from the table's")
        check_wave("windowed stream", np.concatenate(chunks), total * 600)
        log(f"windowed stream_process ({STREAM_WINDOW} + {STREAM_HALO} "
            f"frames), replayed: {len(chunks)} chunks, first after "
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
                   "all_chunks_ms": stream_ms, "launches": stream_launches,
                   "first_use": stream_first_use},
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
    from illufly_tts_tpu_torch.ops import adain_moments as am

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
        for table in (asc.launches, am.launches):
            for name in table:
                table[name] = 0
        passes.clear()

    def check_launches(label, want_passes):
        got = {"istft_oa": oa.launches, **asc.launches, **am.launches}
        want = {name: kernel_launches(name, conv_per_generator, want_passes)
                for name in got}
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
    import shutil
    import tempfile

    from illufly_tts_tpu_torch.ops import adain_moments as am
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

    def counted(label, generator_passes, skipped=0, fronts=None):
        passes[label] = generator_passes
        got = check_counts(f"training: {label}", generator_passes, skipped,
                           fronts)
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
    # versions, at the trained weights (the noise blocks and the front's
    # AdaIN1d moments plain in both)
    skipped = noise_block_convs(model)

    def between():
        counted("gradients through the kernels", 1, skipped, fronts=0)
        reset_counts()

    reset_counts()
    through, plain = gradient_passes(torch, model, first, frames, layers,
                                     vocoder, asc, oa, between=between)
    plain_counts = {"istft_oa": oa.launches, **asc.launches, **am.launches}
    log(f"training: gradients through the plain versions, launches "
        f"{plain_counts}")
    if any(plain_counts.values()):
        failures.append(f"training: the plain pass launched {plain_counts}")
    out["gradients"], wrong = compare_gradients(through, plain)
    failures.extend(f"training: {msg}" for msg in wrong)
    g = out["gradients"]
    log(f"training: gradients through the kernels vs the plain versions "
        f"(the noise blocks' {skipped} convs of each form and their AdaIN "
        f"passes, and the F0/N towers' and the trunk's AdaIN1d moments, "
        f"plain in both), "
        f"{g['leaves']} leaves: worst relative L2 {g['worst_rel_l2']:.3e} "
        f"({g['worst_leaf']}; limit {GRAD_TOL}), median "
        f"{g['median_rel_l2']:.3e}; {g['resblock_leaves_checked_nonzero']} "
        f"resblock conv/alpha/adain.fc leaves, zero gradients: "
        f"{g['zero']}")
    del through, plain
    lap("gradients, kernels and plain")
    far = far_target(torch, first)
    loss_fn = tstep.make_loss_fn(model, frames)

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
                                      head_shapes, card, cfg)
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
    return out, conv_shapes, head_shapes


def noise_block_convs(model):
    """Fused conv launches of each form in one Generator pass's noise
    blocks (one a dilation; the AdaIN pass twice that)."""
    return sum(len(block.dilations) for name, block in
               model.decoder.generator.named_children()
               if name.startswith(NOISE_BLOCK))


def plain_noise_blocks(layers, asc, model):
    """Run the Generator's noise blocks' fused convs and AdaIN passes
    through their plain versions, whatever ``layers`` holds elsewhere:
    forward hooks that swap the module's names around each noise block. ->
    the hook handles."""
    from illufly_tts_tpu_torch.ops import adain_moments as am

    saved = {}
    plain = {**{name: asc.adain_snake_conv_plain for name in CONV_KERNELS},
             "adain_fold": am.adain_fold_plain}

    def enter(block, args):
        for name, fn in plain.items():
            saved[name] = getattr(layers, name)
            setattr(layers, name, fn)

    def leave(block, args, output):
        for name in plain:
            setattr(layers, name, saved[name])

    handles = []
    for name, block in model.decoder.generator.named_children():
        if name.startswith(NOISE_BLOCK):
            handles += [block.register_forward_pre_hook(enter),
                        block.register_forward_hook(leave)]
    return handles


def far_target(torch, batch):
    """``batch`` with a target of +-10x its audio's peak: no sample's L1
    sign depends on either forward's rounding."""
    gen = torch.Generator(device="cuda").manual_seed(5)
    return batch._replace(target_audio=torch.where(
        torch.rand(batch.target_audio.shape, device="cuda", generator=gen)
        < 0.5, -1.0, 1.0) * 10.0 * float(batch.target_audio.abs().max()))


# Phase 10's two gradient passes take the F0/N towers' and the decoder
# trunk's AdaIN1d moments plain in both (``front_plain``: the AdaIN pass's
# moments-only form), so that the front's forward is the same in both, as
# it was before the AdaIN pass had a kernel. The
# leaves just ahead of those instance norms (pool biases, the 1-channel
# f0_conv/n_conv and the projections feeding them) have gradients that the
# norms cancel to near zero; with the front's moments through the kernel
# they read the moments' rounding: 2 of 60 runs above GRAD_TOL (1.595e-2
# at predictor.n_1.pool.bias, 2.032e-2 at decoder.f0_conv.weight), 0 of 60
# on the tree before the kernel (scripts/grad_check_repeat.py's
# front_kernel comparison; PERF.md §6). The Generator's AdaIN passes go
# through the kernel in the first pass; step 0 against the CPU holds the
# front's kernel launches in training.
def gradient_passes(torch, model, batch, frames, layers, vocoder, asc, oa,
                    between=None, noise_blocks_plain=True, front_plain=True):
    """Phase 10 (c): one batch's gradients through the kernels (as
    ``layers`` and ``vocoder`` hold them), then through the plain versions,
    against ``far_target``; with ``noise_blocks_plain`` the noise
    blocks run plain in both passes (``NOISE_BLOCK``), with
    ``front_plain`` the F0/N towers' and the trunk's ``AdaIN1d`` moments
    (see above). ``between()`` runs between the passes. ->
    (through, plain): {leaf: gradient}."""
    from illufly_tts_tpu_torch.ops import adain_moments as am
    from illufly_tts_tpu_torch.training import step as tstep

    far = far_target(torch, batch)
    loss_fn = tstep.make_loss_fn(model, frames)
    model.train()  # cuDNN's LSTM backward runs in training mode only

    def grads():
        model.zero_grad(set_to_none=True)
        loss, _ = loss_fn(far)
        loss.backward()
        return {name: p.grad.detach().clone()
                for name, p in model.named_parameters() if p.grad is not None}

    hooks = plain_noise_blocks(layers, asc, model) if noise_blocks_plain else []
    held = layers.adain_fold
    if front_plain:  # AdaIN1d takes the moments-only form, gamma None
        def fold(x, mask, gamma, beta, extent=None):
            return (am.adain_fold_plain if gamma is None else held)(
                x, mask, gamma, beta, extent=extent)
        layers.adain_fold = fold
    try:
        through = grads()
        if between is not None:
            between()
        plain_fns = {**{name: asc.adain_snake_conv_plain
                        for name in CONV_KERNELS},
                     "adain_fold": am.adain_fold_plain}
        saved = ({name: getattr(layers, name) for name in plain_fns},
                 vocoder.istft_head)
        for name, fn in plain_fns.items():
            setattr(layers, name, fn)
        vocoder.istft_head = oa.istft_head_plain
        try:
            plain = grads()
        finally:
            for name, fn in saved[0].items():
                setattr(layers, name, fn)
            vocoder.istft_head = saved[1]
    finally:
        layers.adain_fold = held
        for handle in hooks:
            handle.remove()
    model.zero_grad(set_to_none=True)
    return through, plain


def compare_gradients(through, plain):
    """Each leaf through the kernels against the plain versions: relative
    L2 within ``GRAD_TOL``, ``DEGENERATE`` leaves within 1e-3 of the global
    norm, no resblock conv/alpha/adain.fc leaf with a zero gradient. ->
    (summary, [what failed])."""
    import re

    wrong = []
    total = math.sqrt(sum(float(g.square().sum()) for g in plain.values()))
    degenerate = re.compile(DEGENERATE)
    errs = {}
    for name, g in plain.items():
        diff = float((through[name] - g).norm())
        if degenerate.search(name):
            if not diff <= 1e-3 * total:
                wrong.append(f"{name} gradient differs by {diff} (> 1e-3 of "
                             "the global norm)")
            continue
        errs[name] = diff / max(float(g.norm()), 1e-30)
    worst_name = max(errs, key=errs.get)
    resblock = re.compile(r"generator\.(noise_)?res_.*(conv[12]_\d\.weight|"
                          r"alpha[12]_\d|adain[12]_\d\.fc\.weight)")
    zero = [name for name, g in through.items()
            if resblock.search(name) and not float(g.abs().max()) > 0]
    summary = {"leaves": len(plain), "global_norm": total,
               "worst_rel_l2": errs[worst_name], "worst_leaf": worst_name,
               "median_rel_l2": statistics.median(errs.values()),
               "tolerance": GRAD_TOL, "zero": zero,
               "resblock_leaves_checked_nonzero": sum(
                   1 for name in through if resblock.search(name))}
    if not errs[worst_name] <= GRAD_TOL or zero or len(through) != len(
            plain):
        wrong.append(f"kernel vs plain gradients {summary}")
    return summary, wrong


def time_recompute(torch, asc, oa, flush, conv_shapes, head_shapes, card,
                   cfg):
    """Each kernel's backward at its largest training shape (the plain
    version recomputed and differentiated, ``ops/kernel_grad.py``; the
    AdaIN pass's at the Generator's last stage), beside its forward launch,
    CUDA-event medians. -> {kernel: row}."""
    from illufly_tts_tpu_torch.ops import adain_moments as am

    rows = {}
    net = cfg.istftnet
    length = TRAIN["frames"] * 2 * math.prod(net.upsample_rates)
    channels = net.upsample_initial_channel // 2 ** len(net.upsample_rates)
    x, m, gamma, beta = adain_inputs(torch, TRAIN["batch"], channels, length,
                                     "float32", seed=7)
    inputs = [t.requires_grad_() for t in (x, gamma, beta)]
    scale, shift = am.adain_fold(x, m, gamma, beta)
    g = torch.randn_like(scale)
    rows["adain_fold"] = {
        "shape": [TRAIN["batch"], channels, length],
        "forward_ms": cuda_ms(lambda: am.adain_fold(x, m, gamma, beta), 10,
                              flush),
        "backward_recompute_ms": cuda_ms(
            lambda: torch.autograd.grad((scale, shift), inputs, (g, g),
                                        retain_graph=True), 10, flush)}
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

def bf16_inputs(torch, asc, batch, channels, length, kernel, seed,
                zero_mask=False):
    """``conv_inputs`` as the bf16 forms take them: x bfloat16, w
    stage-packed bfloat16 as the model holds it (``asc.pack_weights``)."""
    x, mask, scale, shift, alpha, w, b = conv_inputs(
        torch, batch, channels, length, kernel, seed, zero_mask)
    return x.bfloat16(), mask, scale, shift, alpha, asc.pack_weights(w), b


def check_conv_bf16(torch, asc, name, cases):
    """bf16 form ``name`` vs the plain bf16 version at each (batch, C, L, k,
    d, zero_mask) -> (worst max|kernel - plain| / max|plain|, its max
    |kernel - plain|, the least share of bitwise-equal outputs). An all-zero
    mask must give the bias rounded to bfloat16; a second launch on the
    same inputs must give the same bits."""
    fn = getattr(asc, BF16_CONV[name])
    worst, worst_err, least_equal = 0.0, 0.0, 1.0
    for i, (batch, channels, length, k, d, zero) in enumerate(cases):
        args = bf16_inputs(torch, asc, batch, channels, length, k, 50 + i,
                           zero)
        out = fn(*args, k, d)
        again = fn(*args, k, d)
        torch.cuda.synchronize()
        ref = asc.adain_snake_conv_plain(*args, k, d)
        if out.dtype != torch.bfloat16 or out.shape != ref.shape:
            fail(f"{name}: {out.dtype} {tuple(out.shape)} at {cases[i]}")
        if not torch.equal(out.view(torch.int16), again.view(torch.int16)):
            fail(f"{name}: two launches differ at {cases[i]}")
        err = float((out.float() - ref.float()).abs().max())
        peak = float(ref.float().abs().max())
        equal = float((out.view(torch.int16) == ref.view(torch.int16))
                      .float().mean())
        if zero and not torch.equal(out, args[-1].bfloat16()[
                None, :, None].expand_as(out)):
            fail(f"{name}: an all-zero mask did not give the bias")
        if not err <= BF16_TOL * peak:
            fail(f"{name} disagrees with plain at {cases[i]}: {err} > "
                 f"2^-7 * {peak}")
        if err / max(peak, 1e-30) >= worst:
            worst, worst_err = err / max(peak, 1e-30), err
        least_equal = min(least_equal, equal)
        del args, out, ref
    log(f"  {name}: {len(cases)} shapes, max|kernel - plain| <= "
        f"{worst:.3e} of max|plain| (gate 2^-7 = {BF16_TOL:.3e}), outputs "
        f"bitwise equal: >= {least_equal:.2%} (the previous bf16 design: "
        ">= 99.08%); "
        "two launches bitwise equal at each")
    return worst, worst_err, least_equal


def check_head_bf16(torch, oa, shapes):
    """The bf16 head on a bfloat16 x against the f32 head on x.float() at
    each (batch, frames, edges): bitwise equal (NaN included) -> max
    |kernel - plain| over the finite samples."""
    worst = 0.0
    for i, (batch, frames, edges) in enumerate(shapes):
        x = head_inputs(torch, batch, frames, seed=200 + i,
                        edges=edges).bfloat16()
        out = oa.istft_head(x)
        f32 = oa.istft_head(x.float())
        torch.cuda.synchronize()
        if out.dtype != torch.float32 or not torch.equal(
                out.view(torch.int32), f32.view(torch.int32)):
            fail(f"istft_head_bf16 is not bitwise the f32 head of x.float() "
                 f"at {(batch, frames)}")
        ref = oa.istft_head_plain(x)
        fin = ~torch.isnan(ref)
        worst = max(worst, float((out[fin] - ref[fin]).abs().max()))
    log(f"  istft_head_bf16: {len(shapes)} shapes bitwise equal to the f32 "
        f"head of x.float(); max|kernel - plain| = {worst:.3e}")
    return worst


def time_conv_bf16(torch, F, asc, name, flush, shape, card, reps=20):
    """bf16 form, plain bf16 version, cuDNN's bf16 conv alone on an
    activated input, and the 3xTF32 form on the same values in f32, ms,
    beside the bound: the larger of 2 B L C^2 k / 989e12 and its bytes (x
    and y bfloat16, the f32 mask, w bfloat16) over HBM."""
    batch, channels, length, k, d = shape
    args = bf16_inputs(torch, asc, batch, channels, length, k, seed=99)
    w = asc.unpack_weights(args[5], channels, channels)  # [k, C_in, C_out]
    f32_args = tuple(t.float().contiguous() for t in args[:5]) + (
        w.float().contiguous(), args[6])
    fn = getattr(asc, BF16_CONV[name])
    h = torch.randn(args[0].shape, device="cuda").bfloat16()
    w_t = w.permute(2, 1, 0).contiguous()  # [C_out, C_in, k]
    b16 = args[6].bfloat16()
    pad = (k - 1) * d // 2
    calls = {
        "ms": lambda: fn(*args, k, d),
        "plain_ms": lambda: asc.adain_snake_conv_plain(*args, k, d),
        "library_ms": lambda: F.conv1d(h, w_t, b16, padding=pad,
                                       dilation=d),
        "f32_form_ms": lambda: fn(*f32_args, k, d),
    }
    for call in calls.values():
        call()
    out = {key: cuda_ms(call, reps, flush) for key, call in calls.items()}
    n_bytes = (2 * args[0].numel() * 2 + args[1].numel() * 4
               + w.numel() * 2)
    out["bound_ms"], out["bound_by"] = bound(
        n_bytes, 2 * batch * length * channels * channels * k,
        BF16_OPS_PER_S)
    out["shape"] = list(shape)
    log(f"{name} at B={batch}, C={channels}, L={length}, k={k}, d={d}: "
        f"kernel {out['ms']:.4f} ms, plain {out['plain_ms']:.4f} ms, cuDNN "
        f"bf16 conv alone {out['library_ms']:.4f} ms, 3xTF32 form "
        f"{out['f32_form_ms']:.4f} ms, bound {out['bound_ms']:.4f} ms "
        f"({out['bound_by']}, {out['bound_ms'] / out['ms']:.0%} of it "
        f"reached; {card})")
    return out


# phase 3b, row extents (the bf16 convs and the AdaIN pass given each row's
# mask extent): the shapes of bench.py's two Generator stages (B=32, F
# 512) and B=1 at both, every (k, d) of the inventory
EXTENT_SHAPES = ((32, 256, 10240), (32, 128, 61440), (1, 256, 10240),
                 (1, 128, 61440))
# the offline cell's rows: 40-170 ids at 3 frames an id, of 512 frames
CELL_FRAMES = (120, 511)


def cell_extents(torch, batch, length, seed):
    """Extents of ``batch`` rows of the offline cell's frames, at a
    Generator stage of ``length`` columns for 512 frames."""
    gen = torch.Generator().manual_seed(seed)
    frames = torch.randint(*CELL_FRAMES, (batch,), generator=gen)
    return [int(f) * length // 512 for f in frames]


def edge_extents(length, tile_len, pad):
    """Extents at the split's edges: empty, one column, whole, and a tile
    edge and the next one +- the conv's reach, +- 1."""
    out = [0, 1, length, length - 1, length - pad]
    for edge in (tile_len, 3 * tile_len):
        for e in (edge - pad, edge + pad):
            out += [e - 1, e, e + 1]
    return sorted({min(max(e, 0), length) for e in out})


def extent_mask(torch, extents, length, holes=False):
    """Prefix masks [B, L] of the extents; with ``holes`` the second row
    also has every 7th column inside its extent zeroed."""
    cols = torch.arange(length, device="cuda")[None, :]
    m = (cols < torch.tensor(extents, device="cuda")[:, None]).float()
    if holes and len(extents) > 1:
        m[1, ::7] = 0.0
    return m.contiguous()


def check_extents(torch, asc, am, flush, card, failures):
    """Each bf16 conv form and the AdaIN pass (both x dtypes) given the
    mask's row extents against the same launch given full extents and
    without extents: the whole output bitwise equal, padded columns
    included, at ``EXTENT_SHAPES`` and every (k, d) of the inventory, for
    rows at the split's edges (``edge_extents``) and the cell's own rows;
    the columns tally against ``work_plan``; each form at k 11 (d 1 and 5)
    and the AdaIN pass timed at the cell's extents and at full extents
    (device ms, ``cuda_ms``). -> summary."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    inventory = [(k, d) for k in (3, 7, 11) for d in (1, 3, 5)]
    launches = 0
    tally_ok = True
    timed = []
    t0 = time.perf_counter()

    def tally():  # None before the process's first bf16 conv
        return asc.columns_tally() or {"computed_tiles": 0, "grid_tiles": 0}

    def same(a, b):
        return torch.equal(a.view(torch.int16 if a.dtype == torch.bfloat16
                                  else torch.int32),
                           b.view(torch.int16 if b.dtype == torch.bfloat16
                                  else torch.int32))

    for si, (batch, channels, length) in enumerate(EXTENT_SHAPES):
        tile_len = asc.column_tile(batch, channels, length, sms, True)
        for k, d in inventory:
            pad = (k - 1) * d // 2
            edges = edge_extents(length, tile_len, pad)
            cell = cell_extents(torch, 64, length, seed=si)
            # B=32: one batch of edge rows then the cell's; B=1: a launch
            # per extent
            rows = ([(edges + cell)[:batch]] if batch > 1
                    else [[e] for e in edges + cell[:2]])
            args = bf16_inputs(torch, asc, batch, channels, length, k,
                               seed=700 + si)
            for extents in rows:
                mask = extent_mask(torch, extents, length, holes=True)
                ext = asc.mask_extent(mask)
                full = torch.full_like(ext, length)
                inputs = (args[0], mask, *args[2:])
                for name, fn in (("tile", asc.adain_snake_conv),
                                 ("carry", asc.adain_snake_conv_carry)):
                    torch.cuda.synchronize()
                    before = tally()
                    got = fn(*inputs, k, d, extent=ext)
                    torch.cuda.synchronize()
                    after = tally()
                    want = fn(*inputs, k, d)
                    with_full = fn(*inputs, k, d, extent=full)
                    launches += 3
                    if not (same(got, want) and same(with_full, want)):
                        failures.append(
                            f"extents: {name} at {[batch, channels, length]}"
                            f" k={k} d={d}, extents {extents[:12]}: not "
                            "bitwise the launch without extents")
                    co = -(-channels // asc.COUT_TILE)
                    computed = sum(co * asc.work_tiles(int(e), length,
                                                       tile_len, pad)
                                   for e in ext.tolist())
                    if (after["computed_tiles"] - before["computed_tiles"]
                            != computed
                            or after["grid_tiles"] - before["grid_tiles"]
                            != batch * co * -(-length // tile_len)):
                        tally_ok = False
                        failures.append(
                            f"extents: {name}'s columns tally at "
                            f"{[batch, channels, length]} k={k} d={d} is not "
                            "work_plan's")
        # the AdaIN pass, both x dtypes, with the last shape's rows
        for dtype in (torch.bfloat16, torch.float32):
            x = args[0].to(dtype)
            gamma, beta = (0.3 * torch.randn(2, batch, channels,
                                             device="cuda")).unbind(0)
            for extents in rows:
                mask = extent_mask(torch, extents, length, holes=True)
                ext = asc.mask_extent(mask)
                got = am.adain_fold(x, mask, gamma, beta, extent=ext)
                want = am.adain_fold(x, mask, gamma, beta)
                launches += 2
                if not all(same(g, w) for g, w in zip(got, want)):
                    failures.append(
                        f"extents: adain_fold ({dtype}) at "
                        f"{[batch, channels, length]}, extents "
                        f"{extents[:12]}: not bitwise the pass without")
        # timed at the cell's rows (B=1: its first) and at full extents:
        # each form at k 11, the AdaIN pass on its bf16 x
        mask = extent_mask(torch, cell_extents(torch, batch, length, si),
                           length)
        modes = (("cell", asc.mask_extent(mask)),
                 ("full", torch.full((batch,), length, dtype=torch.int32,
                                     device="cuda")))
        args = bf16_inputs(torch, asc, batch, channels, length, 11,
                           seed=800 + si)
        inputs = (args[0], mask, *args[2:])
        for name, fn, d in (("tile", asc.adain_snake_conv, 1),
                            ("carry", asc.adain_snake_conv_carry, 5)):
            timed.append({"conv": [name, batch, channels, length, 11, d]} | {
                mode: cuda_ms(lambda: fn(*inputs, 11, d, extent=e), 10, flush)
                for mode, e in modes})
        timed.append({"adain_fold": [batch, channels, length]} | {
            mode: cuda_ms(lambda: am.adain_fold(args[0], mask, gamma, beta,
                                                extent=e), 10, flush)
            for mode, e in modes})
        del args, inputs
    summary = {"shapes": [list(s) for s in EXTENT_SHAPES],
               "kd": inventory, "launches": launches, "tally_ok": tally_ok,
               "seconds": time.perf_counter() - t0, "card": card,
               "timed_ms": timed}
    log(f"row extents: {launches} launches at {len(EXTENT_SHAPES)} shapes x "
        f"{len(inventory)} (k, d), bf16 tile and carry and adain_fold "
        "(bf16, f32) bitwise equal to full extents and to no extents "
        f"{'in every case' if not any('extents:' in f for f in failures) else 'NOT in every case'}; "
        f"tally {'matches' if tally_ok else 'DIFFERS from'} work_plan "
        f"({summary['seconds']:.1f} s); device ms at the offline cell's "
        f"extents and at full extents ({card}):")
    for row in timed:
        log("  " + json.dumps(row))
    return summary


def time_head_bf16(torch, oa, flush, card):
    """The bf16 head at [8, 22, 61440] beside its plain version, the f32
    head on the same values in f32, and its byte bound (22 bfloat16 in and
    5 f32 out a frame)."""
    batch, frames = 8, 61440
    x = head_inputs(torch, batch, frames, seed=99).bfloat16()
    x32 = x.float()
    calls = {"ms": lambda: oa.istft_head(x),
             "plain_ms": lambda: oa.istft_head_plain(x),
             "f32_form_ms": lambda: oa.istft_head(x32)}
    for call in calls.values():
        call()
    out = {key: cuda_ms(call, 50, flush) for key, call in calls.items()}
    out["bound_ms"], out["bound_by"] = bound(
        batch * frames * (22 * 2 + 5 * 4), batch * frames * ISTFT_OPS_PER_FRAME)
    out["shape"] = [batch, 22, frames]
    log(f"istft_head_bf16 at {out['shape']}: kernel {out['ms']:.4f} ms, "
        f"plain {out['plain_ms']:.4f} ms, f32 head {out['f32_form_ms']:.4f}"
        f" ms, bound {out['bound_ms']:.4f} ms ({out['bound_by']}; {card})")
    return out


def bf16_counts():
    """The bf16 forms' launch counts (the wrappers' own counters)."""
    from illufly_tts_tpu_torch.ops import adain_moments as am
    from illufly_tts_tpu_torch.ops import adain_snake_conv as asc
    from illufly_tts_tpu_torch.ops import istft_oa as oa

    return {"istft_head_bf16": oa.launches_bf16, **asc.launches_bf16,
            **am.launches_bf16}


def bf16_phase(torch, np, F, synth, layers, vocoder, asc, oa, flush, card,
               failures, conv_per_generator, reset_counts, check_wave):
    """Phase 11: ``KokoroConfig(dtype=torch.bfloat16)`` on the card, on the
    f32 engine's weights: the bf16 forms against their plain versions and
    timed; bench.py's serving shape (B=32, 256 tokens, frame bucket 512)
    in pcm16 and mulaw8k beside the f32 engine; zh_1 in the four formats,
    streamed exact and windowed; the card's bf16 against the CPU's on zh_1.
    -> (summary, kernel rows by name)."""
    import dataclasses

    from illufly_tts_tpu_torch.audio.mel import mel_l1
    from illufly_tts_tpu_torch.engine.synthesizer import Synthesizer
    from illufly_tts_tpu_torch.model.params import export_flax_params
    from illufly_tts_tpu_torch.ops import adain_moments as am

    out = {"card": card}
    # -- the forms against their plain versions, and timed
    log("phase 11: bf16 forms vs their plain bf16 versions:")
    # (B, C, L, k, d, all-zero mask): the timed shape, b8's stage 0, the
    # two B=1 stream windows; then L a multiple of no tile, L shorter than
    # one tile, C_in = 24 (not a multiple of the 16-channel stage), C = 256,
    # k in {3, 7, 11}, d in {1, 3, 5}, odd batch rows (conv_inputs masks
    # their last third) and all-zero masks, which must give the bias
    timed = [(8, 128, 61440, 11, 1, False), (8, 128, 61440, 11, 5, False),
             (8, 256, 10240, 7, 3, False), (1, 256, 1920, 7, 3, False),
             (1, 128, 11520, 11, 5, False), (3, 128, 1001, 7, 3, False),
             (2, 256, 37, 11, 5, False), (2, 256, 640, 3, 1, True),
             (3, 24, 1001, 7, 3, False), (5, 24, 300, 11, 5, False),
             (3, 256, 2049, 3, 5, False), (1, 128, 129, 7, 1, True),
             (3, 128, 257, 11, 3, False)]
    rows = {name: dict(zip(("err_over_peak", "max_abs_err",
                            "bitwise_share"),
                           check_conv_bf16(torch, asc, name, timed)))
            for name in BF16_CONV}
    head_err = check_head_bf16(torch, oa, [
        (8, 61440, False), (1, 11520, False), (3, 1001, False),
        (1, 1, False), (2, 4096, True)])
    for name, d in (("adain_snake_conv_bf16", 1),
                    ("adain_snake_conv_carry_bf16", 5)):
        rows[name].update(time_conv_bf16(torch, F, asc, name, flush,
                                         (8, 128, 61440, 11, d), card))
        rows[name]["bench_shape"] = time_conv_bf16(
            torch, F, asc, name, flush, (32, 128, 61440, 11, d), card,
            reps=10)
    rows["adain_snake_conv_bf16"]["tile_lens"] = [
        time_tile_lens(torch, asc, flush, shape, bf16=True)
        for shape in ((8, 128, 61440, 11, 1), (1, 256, 1920, 7, 3),
                      (1, 128, 11520, 11, 5))]
    rows["adain_snake_conv_carry_bf16"]["chunks"] = [
        time_carry_walk(torch, asc, flush, shape, bf16=True)
        for shape in ((8, 128, 61440, 11, 5), (8, 256, 10240, 11, 5))]
    rows["istft_head_bf16"] = {"max_abs_err": head_err,
                               **time_head_bf16(torch, oa, flush, card)}

    # -- the engines, on the f32 engine's weights
    tree = export_flax_params(synth.model)
    cfg16 = dataclasses.replace(synth.config, dtype=torch.bfloat16)
    t0 = time.perf_counter()
    s16 = Synthesizer(cfg16, params=tree)
    s16.register_random_voice("smoke_voice", seed=0)
    log(f"Synthesizer(KokoroConfig(dtype=torch.bfloat16)) on {s16.device} "
        f"in {time.perf_counter() - t0:.1f} s ({card})")
    buckets = {"token_buckets": (BENCH["tokens"],),
               "frame_buckets": (BENCH["frames"],)}
    engines = {"bf16": Synthesizer(cfg16, params=tree, **buckets),
               "f32": Synthesizer(synth.config, params=tree, **buckets)}
    texts = [BENCH_TEXT] * BENCH["batch"]
    voices = ["bench_voice"] * BENCH["batch"]
    out["bench"] = {}
    conv_shapes, head_shapes = record_shapes(layers, vocoder, asc, oa)
    try:
        for label, engine in engines.items():
            engine.register_random_voice("bench_voice", seed=7)
            for fmt in ("pcm16", "mulaw8k"):
                engine.collect(engine.dispatch(texts, voices, fmt=fmt))
                torch.cuda.synchronize()
                reset_counts()
                walls = []
                for _ in range(3):
                    t0 = time.perf_counter()
                    h = engine.dispatch(texts, voices, fmt=fmt)
                    clips = engine.collect(h)
                    walls.append((time.perf_counter() - t0) * 1e3)
                got = {"istft_oa": oa.launches, **asc.launches,
                       **am.launches, **bf16_counts()}
                per_frame = 200 if fmt == "mulaw8k" else 600
                for i, clip in enumerate(clips):
                    check_wave(f"bench {label}/{fmt}[{i}]", clip,
                               int(h.fitted_totals[i]) * per_frame)
                seconds = float(sum(h.fitted_totals[: h.n])) * 600 / 24000
                run = {"wall_ms": walls, "median_ms": statistics.median(
                    walls), "audio_s": seconds, "t_bucket": h.t_bucket,
                    "f_bucket": h.f_bucket, "launches": got}
                out["bench"][f"{label}/{fmt}"] = run
                on = (("istft_head_bf16", *BF16_CONV, "adain_fold_bf16")
                      if label == "bf16" else
                      ("istft_oa", *BF16_CONV.values(), "adain_fold"))
                want = {name: 0 for name in got}
                want.update({name: kernel_launches(name, conv_per_generator,
                                                   3) for name in on})
                if got != want:
                    failures.append(f"bench {label}/{fmt}: launches {got}, "
                                    f"want {want}")
                log(f"bench.py shape, {label} engine, {fmt}: B={h.n}, "
                    f"T_bucket={h.t_bucket}, F_bucket={h.f_bucket}, "
                    f"{seconds:.1f} s of audio, wall ms (warm, dispatch -> "
                    f"collect) {', '.join(f'{w:.1f}' for w in walls)}; "
                    f"launches over 3 renders {got} ({card})")
        del engines
        torch.cuda.empty_cache()
        for fmt in ("pcm16", "mulaw8k"):
            b, f = out["bench"][f"bf16/{fmt}"], out["bench"][f"f32/{fmt}"]
            log(f"bench.py shape {fmt}: bf16 {b['median_ms']:.1f} ms, f32 "
                f"{f['median_ms']:.1f} ms, ratio "
                f"{b['median_ms'] / f['median_ms']:.3f} ({card})")

        # -- zh_1 in the four formats, exact and windowed streams
        reset_counts()
        for fmt in FORMATS:
            h = s16.dispatch([ZH], ["smoke_voice"], fmt=fmt)
            check_wave(f"bf16 zh_1/{fmt}", s16.collect(h)[0],
                       int(h.fitted_totals[0]) * (200 if fmt == "mulaw8k"
                                                  else 600))
        got = bf16_counts()
        want = {name: kernel_launches(name, conv_per_generator, len(FORMATS))
                for name in got}
        if got != want or oa.launches or any(asc.launches.values()) or any(
                am.launches.values()):
            failures.append(f"bf16 zh_1 formats: launches {got}, want "
                            f"{want} and no f32 launch")
        torch.backends.cudnn.deterministic = True
        whole = s16.collect(s16.dispatch([ZH], ["smoke_voice"], fmt="f32"))
        stream = np.concatenate(list(s16.stream_decode(
            s16.dispatch([ZH], ["smoke_voice"], fmt="f32"),
            window_frames=STREAM_WINDOW)), axis=1)
        exact_equal = stream[0, : whole[0].size].tobytes() == whole[0].tobytes()
        torch.backends.cudnn.deterministic = False
        if not exact_equal:
            failures.append("bf16 exact stream differs from collect()")
        # the first use captures the stream's graphs (the window's warm
        # pass is one more Generator pass); the timed stream replays them
        reset_counts()
        (_, chunks, _, _), first_use16 = first_use(
            s16, lambda: timed_stream(torch, s16, [ZH]),
            "bf16 windowed stream (zh_1)", card)
        got = bf16_counts()
        want = {name: kernel_launches(name, conv_per_generator,
                                      len(chunks) + 1,
                                      first_use_fronts(first_use16))
                for name in got}
        if got != want or oa.launches or any(asc.launches.values()) or any(
                am.launches.values()):
            failures.append(f"bf16 windowed stream, first use: launches "
                            f"{got}, want {want} and no f32 launch")
        reset_counts()
        h, chunks, first_ms, stream_ms = timed_stream(torch, s16, [ZH])
        got = bf16_counts()
        want = {name: kernel_launches(name, conv_per_generator, len(chunks),
                                      fronts=1)
                for name in got}
        if got != want or oa.launches or any(asc.launches.values()) or any(
                am.launches.values()):
            failures.append(f"bf16 windowed stream: launches {got}, want "
                            f"{want} and no f32 launch")
        max_total = int(h.fitted_totals[0])
        if sum(c.shape[1] for c in chunks) != max_total * 600 or not all(
                np.isfinite(c).all() for c in chunks):
            failures.append("bf16 windowed chunks: length or finiteness")
        out["stream"] = {"first_chunk_ms": first_ms, "all_chunks_ms":
                         stream_ms, "chunks": len(chunks), "launches": got,
                         "exact_bitwise_equal_to_collect": exact_equal,
                         "first_use": first_use16}
        log(f"bf16 zh_1: four formats served; exact stream bitwise equal to "
            f"collect(): {exact_equal}; windowed stream ({STREAM_WINDOW} + "
            f"{STREAM_HALO} frames, F_bucket {h.f_bucket}), replayed: "
            f"{len(chunks)} "
            f"chunks, first after {first_ms:.1f} ms, all after "
            f"{stream_ms:.1f} ms, launches {got} ({card})")
    finally:
        unrecord(layers, vocoder, asc, oa)
    log("bf16 forms vs plain at the shapes the bf16 engine gave them:")
    for name, plain_name in BF16_CONV.items():
        new = sorted(conv_shapes[plain_name] - {c[:5] for c in timed})
        if new:
            worst, err, share = check_conv_bf16(
                torch, asc, name, [(*shape, False) for shape in new])
            rows[name]["err_over_peak"] = max(rows[name]["err_over_peak"],
                                              worst)
            rows[name]["max_abs_err"] = max(rows[name]["max_abs_err"], err)
            rows[name]["bitwise_share"] = min(rows[name]["bitwise_share"],
                                              share)
    rows["istft_head_bf16"]["max_abs_err"] = max(
        head_err, check_head_bf16(torch, oa, [(b, f, False)
                                              for b, f in sorted(head_shapes)]))
    for name, row in rows.items():
        row["launches"] = out["bench"]["bf16/pcm16"]["launches"][name]
        row["launches_stream"] = out["stream"]["launches"][name]

    # -- the card's bf16 against the CPU's, on zh_1
    t0 = time.perf_counter()
    cpu16 = Synthesizer(cfg16, params=tree, device="cpu")
    cpu32 = Synthesizer(synth.config, params=tree, device="cpu")
    renders, totals = {}, {}
    for label, engine in (("card_bf16", s16), ("cpu_bf16", cpu16),
                          ("cpu_f32", cpu32)):
        engine.register_random_voice("smoke_voice", seed=0)
        h = engine.dispatch([ZH], ["smoke_voice"], fmt="f32")
        renders[label] = engine.collect(h)[0]
        totals[label] = [int(t) for t in h.fitted_totals[: h.n]]
        shape = (h.n, h.t_bucket, h.f_bucket)
    card_cpu = mel_l1(renders["card_bf16"], renders["cpu_bf16"])
    bf16_f32 = mel_l1(renders["cpu_bf16"], renders["cpu_f32"])

    def rms_scale(a, b):
        n = min(a.size, b.size)
        return float(np.sqrt(np.mean((a[:n] - b[:n]) ** 2))
                     / (np.sqrt(np.mean(b[:n] ** 2)) + 1e-9))

    out["card_vs_cpu"] = {
        "shape": list(shape), "frame_totals": totals,
        "mel_l1_card_bf16_cpu_bf16": card_cpu,
        "mel_l1_cpu_bf16_cpu_f32": bf16_f32,
        "rms_scale_card_bf16_cpu_bf16": rms_scale(renders["card_bf16"],
                                                  renders["cpu_bf16"]),
        "rms_scale_cpu_bf16_cpu_f32": rms_scale(renders["cpu_bf16"],
                                                renders["cpu_f32"]),
        "seconds": time.perf_counter() - t0}
    log(f"bf16 card vs CPU (zh_1, B={shape[0]}, T_bucket={shape[1]}, "
        f"F_bucket={shape[2]}): frame totals {totals}; mel-L1(card bf16, "
        f"CPU bf16) {card_cpu:.4e} vs mel-L1(CPU bf16, CPU f32) "
        f"{bf16_f32:.4e}; rms/scale "
        f"{out['card_vs_cpu']['rms_scale_card_bf16_cpu_bf16']:.3e} vs "
        f"{out['card_vs_cpu']['rms_scale_cpu_bf16_cpu_f32']:.3e}; "
        f"{out['card_vs_cpu']['seconds']:.1f} s ({card})")
    if any(abs(a - b) > FRAME_SLACK for a, b in zip(totals["card_bf16"],
                                                    totals["cpu_bf16"])):
        failures.append(f"bf16 frame totals card {totals['card_bf16']} vs "
                        f"CPU {totals['cpu_bf16']}")
    if not card_cpu <= bf16_f32:
        failures.append(f"bf16 card vs CPU mel-L1 {card_cpu} > CPU bf16 vs "
                        f"f32 {bf16_f32}")
    del cpu16, cpu32, s16
    return out, rows


GRAPH_REPS = 5  # phase 12: timed renders per engine, in turns


def pool_bytes(torch, pool):
    """Bytes the caching allocator holds in the graph memory pool
    ``pool`` (``torch.cuda.graph_pool_handle()``), or None where its
    snapshot names no pools."""
    segments = torch.cuda.memory_snapshot()
    if not any("segment_pool_id" in seg for seg in segments):
        return None
    return sum(seg["total_size"] for seg in segments
               if tuple(seg.get("segment_pool_id", ())) == tuple(pool))


def timed_stream(torch, engine, texts, voice="smoke_voice"):
    """One windowed stream of ``texts`` (f32 handle, ``STREAM_WINDOW`` +
    ``STREAM_HALO``) through ``stream_decode``: -> (handle, chunks,
    first-chunk ms, all-chunks ms), host clock from ``dispatch``."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    h = engine.dispatch(texts, [voice] * len(texts), fmt="f32")
    gen = engine.stream_decode(h, STREAM_WINDOW, STREAM_HALO, exact=False)
    chunks = [next(gen)]
    first_ms = (time.perf_counter() - t0) * 1e3
    chunks += list(gen)
    return h, chunks, first_ms, (time.perf_counter() - t0) * 1e3


def eager_windowed_stream(torch, np, engine, handle, window_frames,
                          halo_frames, prepare=None, window=None):
    """The windowed stream as the engine ran it before its stages became
    graphs: ``decode_prepare`` once, then per window ``decode_window`` with
    a host-int start and a blocking copy to the host, crossfaded as
    ``stream_decode`` crossfades. Yields the chunks. ``prepare`` and
    ``window`` stand in for the two model calls (to time them). It runs on
    this tree's ``decode_window``, which makes each host-int start a
    device scalar (one small copy to the card a window) and gathers where
    the engine before sliced views: a reference for the output, not the
    older engine's timing (``scripts/profile_torch_port.py --streams-of``
    times any checkout's own ``stream_decode``)."""
    from illufly_tts_tpu_torch.model.kokoro import _fit_durations

    net = engine.net
    prepare = prepare or net.decode_prepare
    window = window or net.decode_window
    f_bucket = engine._pick_f_bucket(handle)
    with torch.inference_mode():
        prep = prepare(handle.ids, handle.mask, handle.d,
                       _fit_durations(handle.pred_dur, f_bucket),
                       handle.ref, f_bucket, pitch=handle.pitch)
    spf = engine.config.samples_per_frame
    overlap = halo_frames * spf
    ramp = np.linspace(0.0, 1.0, overlap, dtype=np.float32)[None, :]
    max_total = int(handle.fitted_totals[: handle.n].max())
    body = window_frames * spf
    prev_tail = None
    for emitted in range(0, max_total, window_frames):
        with torch.inference_mode():
            audio = window(*prep, handle.ref, 2 * emitted,
                           2 * window_frames, 2 * halo_frames)
        chunk = audio.float().cpu().numpy()
        out = chunk[:, :body].copy()
        if prev_tail is not None:
            out[:, :overlap] = (prev_tail * (1.0 - ramp)
                                + out[:, :overlap] * ramp)
        prev_tail = chunk[:, body: body + overlap]
        frames_here = min(window_frames, max_total - emitted)
        yield out[: handle.n, : frames_here * spf]


def first_use(engine, run, label, card):
    """``run()``, a windowed stream that uses its keys for the first time
    on ``engine``, and what capturing them cost: -> (its result, summary:
    seconds of the whole call, and per captured key the warm pass's
    seconds, the seconds the capture held the engine's lock, and the
    allocator's state before and after the capture)."""
    before = set(engine._graphs)
    t0 = time.perf_counter()
    result = run()
    seconds = time.perf_counter() - t0
    keys = {}
    for key, g in engine._graphs.items():
        if key not in before:
            keys[str(key)] = {"warm_pass_s": g.warm_s,
                              "capture_lock_s": g.lock_s, **g.memory}
    log(f"{label}: first use {seconds * 1e3:.1f} ms in all; captured "
        + "; ".join(f"{k} (warm pass {v['warm_pass_s'] * 1e3:.1f} ms, lock "
                    f"held {v['capture_lock_s'] * 1e3:.1f} ms)"
                    for k, v in keys.items()) + f" ({card})")
    return result, {"s": seconds, "keys": keys}


def graphs_phase(torch, np, synth, pipe, requests, oa, asc,
                 conv_per_generator, card, failures, reset_counts,
                 check_counts, check_wave):
    """Phase 12: the engine's warmup as CUDA graphs. -> (summary, launches
    the replays made by kernel, f32 and bf16)."""
    import asyncio
    import dataclasses
    import tempfile
    import threading

    import aiohttp
    from aiohttp import web

    from illufly_tts_tpu_torch.api import endpoints
    from illufly_tts_tpu_torch.api.auth import create_access_token
    from illufly_tts_tpu_torch.engine.synthesizer import (
        Synthesizer,
        stage_kind,
    )
    from illufly_tts_tpu_torch.model.params import export_flax_params
    from illufly_tts_tpu_torch.ops import adain_moments as am
    from illufly_tts_tpu_torch.runtime.scheduler import (
        TaskStatus,
        TTSServiceManager,
    )

    t_phase = time.perf_counter()
    out = {"card": card, "cudnn_deterministic": True}
    # bitwise comparisons need cuDNN's deterministic algorithms; the graphs
    # are captured under them too, so eager and replayed run the same ones
    torch.backends.cudnn.deterministic = True
    tree = export_flax_params(synth.model)

    def render(engine, texts, fmt, voice="smoke_voice", **kw):
        h = engine.dispatch(texts, [voice] * len(texts), fmt=fmt, **kw)
        return h, engine.collect(h)

    def same(a, b):
        return len(a) == len(b) and all(
            x.dtype == y.dtype and x.tobytes() == y.tobytes()
            for x, y in zip(a, b))

    def check(label, ok):
        if not ok:
            failures.append(f"phase 12: {label}")
        return ok

    # -- eager references on phase 4's engine, before any warmup
    eager, keys = {}, {}
    for name, texts in requests.items():
        for fmt in FORMATS:
            h, eager[name, fmt] = render(synth, texts, fmt)
            keys[name] = (h.b_bucket, h.t_bucket, h.f_bucket)
    texts4 = requests["mixed_4"]
    pair = None  # a second mixed_4 batch on the same key, other durations
    for speed in (1.04, 0.96, 1.1, 0.9):
        h, clips = render(synth, texts4, "f32", speeds=[speed] * 4)
        if (h.b_bucket, h.t_bucket, h.f_bucket) == keys["mixed_4"]:
            pair = (speed, clips)
            break
    check("no second mixed_4 batch on mixed_4's key", pair is not None)

    # -- warmup(narrow=False): phase 4's three keys in the four formats
    out["captures"], out["warmup_s"] = [], {}
    for name, (b, t, f) in keys.items():
        before = set(synth._graphs)
        rebuilt = synth.last_recapture
        out["warmup_s"][name] = synth.warmup(
            batch_sizes=(b,), token_sizes=(t,), frame_sizes=(f,),
            formats=FORMATS, narrow=False)
        torch.cuda.synchronize()
        pool = pool_bytes(torch, synth._graph_pool)
        for key in sorted(set(synth._graphs) - before, key=len):
            g = synth._graphs[key]
            out["captures"].append({"key": list(key), "warm_pass_s": g.warm_s,
                                    "capture_s": g.lock_s,
                                    "pool_reserved_bytes": pool,
                                    "memory": g.memory})
            log(f"  captured {key}: warm pass {g.warm_s:.3f} s, "
                f"capture {g.lock_s:.3f} s; {len(g.launches)} kernels, "
                f"{sum(g.launches.values())} launches a replay; "
                f"{memory_growth(g.memory)}")
        if synth.last_recapture is not rebuilt:
            rebuilt = synth.last_recapture
            out.setdefault("recaptures", {})[name] = {
                "keys": [list(k) for k in rebuilt["keys"]],
                "lock_s": rebuilt["lock_s"]}
            log(f"  the pool was rebuilt for {name}'s larger keys: "
                f"{len(rebuilt['keys'])} graphs captured again, largest "
                f"first ({rebuilt['keys'][:3]} ...), the lock held "
                f"{rebuilt['lock_s']:.2f} s")
        log(f"warmup {name} (B={b}, T={t}, F={f}, {len(FORMATS)} formats): "
            f"{out['warmup_s'][name]:.2f} s; graph pool reserved "
            f"{(pool or 0) / 2**30:.2f} GiB (None: {pool is None}), all "
            f"reserved "
            f"{torch.cuda.memory_reserved() / 2**30:.2f} GiB ({card})")
    # phases 5 and 7 captured their streams' keys at first use
    batch_keys = [k for k in synth._graphs if stage_kind(k) in ("a", "b")]
    check(f"{len(batch_keys)} batch graphs, want 3 stage A + 12 stage B",
          len(batch_keys) == 3 + 3 * len(FORMATS))
    out["pool_reserved_bytes"] = pool_bytes(torch, synth._graph_pool)
    # the last call rebuilt the pool largest first: the other keys fit in
    # the blocks of its largest capture
    largest = max(g.memory["after"]["reserved_bytes"]
                  - g.memory["before"]["reserved_bytes"]
                  for g in synth._graphs.values() if g.memory)
    check(f"the pool ({out['pool_reserved_bytes']} bytes) exceeds 1.05x its "
          f"largest capture's growth ({largest})",
          (out["pool_reserved_bytes"] or 0) <= 1.05 * largest)

    # -- the same requests replayed: bitwise, exact launches, replay counts
    reset_counts()
    replays0 = dict(synth.graph_replays)
    out["bitwise_equal"] = {}
    renders = 0
    for name, texts in requests.items():
        for fmt in FORMATS:
            h, clips = render(synth, texts, fmt)
            renders += 1
            per_frame = 200 if fmt == "mulaw8k" else 600
            for i, wave in enumerate(clips):
                check_wave(f"replayed {name}/{fmt}[{i}]", wave,
                           int(h.fitted_totals[i]) * per_frame)
            out["bitwise_equal"][f"{name}/{fmt}"] = check(
                f"replayed {name}/{fmt} differs from the eager render",
                same(clips, eager[name, fmt]))
    replayed = check_counts(f"replayed batch path ({renders} renders)",
                            renders)
    grown = {key: synth.graph_replays[key] - replays0.get(key, 0)
             for key in batch_keys}
    want = {key: len(FORMATS) if stage_kind(key) == "a" else 1
            for key in grown}
    check(f"replays per key {grown}, want {want}", grown == want)
    log(f"replayed: {renders} renders bitwise equal to the eager renders: "
        f"{all(out['bitwise_equal'].values())}; replays per key {grown}")
    if pair is not None:
        hx = synth.dispatch(texts4, ["smoke_voice"] * 4, fmt="f32")
        hy = synth.dispatch(texts4, ["smoke_voice"] * 4, fmt="f32",
                            speeds=[pair[0]] * 4)
        synth.launch_decode(hx)
        synth.launch_decode(hy)
        ok = same(synth.collect(hx), eager["mixed_4", "f32"]) and same(
            synth.collect(hy), pair[1])
        out["two_batches_in_flight_bitwise"] = check(
            "two batches of one key in flight: a handle lost its outputs", ok)
        log(f"two mixed_4 batches on one key dispatched before either "
            f"decodes (the scheduler's order), each bitwise its eager "
            f"render: {ok}")
    out["exact_stream_bitwise"] = {}
    for fmt in ("f32", "pcm16"):
        h = synth.dispatch(texts4, ["smoke_voice"] * 4, fmt=fmt)
        stream = np.concatenate(list(synth.stream_decode(
            h, window_frames=STREAM_WINDOW)), axis=1)
        whole = synth.collect(h)
        ok = same(whole, eager["mixed_4", fmt]) and all(
            stream[i, : c.size].tobytes() == c.tobytes()
            for i, c in enumerate(whole))
        out["exact_stream_bitwise"][fmt] = check(
            f"exact stream of a replayed handle ({fmt}) differs", ok)
    log(f"exact streams of replayed handles bitwise equal to collect(): "
        f"{out['exact_stream_bitwise']}")

    # -- launch_decode's host time at long_8's shape, replayed (phase 8
    # times it eager)
    out["launch_decode_replayed"] = repair_timing(
        torch, synth, requests["long_8"], failures)

    # -- wall: a fresh unwarmed engine on the same weights vs replayed
    inventory = {"token_buckets": synth.token_buckets,
                 "frame_buckets": synth.frame_buckets,
                 "batch_buckets": synth.batch_buckets}
    cold = Synthesizer(synth.config, params=tree, **inventory)
    cold.register_random_voice("smoke_voice", seed=0)
    cold.register_random_voice("smoke_voice_b", seed=1)
    for name, texts in requests.items():
        for fmt in FORMATS:
            render(cold, texts, fmt)  # the eager engine's first calls
    out["wall_ms"] = {}
    for name, texts in requests.items():
        for fmt in FORMATS:
            runs = {"eager": [], "replayed": []}
            for rep in range(GRAPH_REPS):
                turn = [("eager", cold), ("replayed", synth)]
                for label, engine in (turn if rep % 2 == 0 else turn[::-1]):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    render(engine, texts, fmt)
                    runs[label].append((time.perf_counter() - t0) * 1e3)
            row = {label: {"ms": ms, "median_ms": statistics.median(ms)}
                   for label, ms in runs.items()}
            out["wall_ms"][f"{name}/{fmt}"] = row
            log(f"wall ms, {name}/{fmt} (dispatch -> collect, medians of "
                f"{GRAPH_REPS}, in turns): eager "
                f"{row['eager']['median_ms']:.1f}, replayed "
                f"{row['replayed']['median_ms']:.1f} ({card})")

    # -- through the scheduler: phase 7's first batch, eager vs replayed
    first = TASKS[:4]
    decoded = []
    launch_decode = synth.launch_decode

    def recorded_launch(handle):
        done = launch_decode(handle)
        decoded.append((handle.b_bucket, handle.t_bucket, handle.f_bucket,
                        handle.fmt))
        return done

    async def first_batch(p, out_dir):
        manager = TTSServiceManager(pipeline=p, batch_size=4,
                                    output_dir=out_dir)
        await manager.start()
        try:
            with p._cache_lock:
                p._audio_cache.clear()
            sent = []
            for user, seq, text, voice, fmt, stamps in first:
                t_submit = time.time()
                tid = await manager.submit_task(
                    text, voice, user_id=user, sequence_id=seq,
                    output_format=fmt, return_timestamps=stamps)
                sent.append((manager.tasks[tid], t_submit))
            deadline = time.monotonic() + 120.0
            while any(task.status in (TaskStatus.PENDING,
                                      TaskStatus.PROCESSING)
                      for task, _ in sent):
                if time.monotonic() > deadline:
                    raise TimeoutError("phase 12 tasks did not finish")
                await asyncio.sleep(0.005)
            if any(task.status != TaskStatus.COMPLETED for task, _ in sent):
                failures.append("phase 12: a scheduler task failed")
            return [(task.completed_at - t) * 1e3 for task, t in sent]
        finally:
            await manager.shutdown()

    cold_pipe = type(pipe)(synthesizer=cold)
    with tempfile.TemporaryDirectory() as tmp:
        synth.launch_decode = recorded_launch
        try:
            asyncio.run(first_batch(pipe, tmp))
        finally:
            del synth.launch_decode
        sched_keys = sorted(set(decoded))
        for b, t, f, fmt in sched_keys:
            synth.warmup(batch_sizes=(b,), token_sizes=(t,),
                         frame_sizes=(f,), formats=(fmt,))
        asyncio.run(first_batch(cold_pipe, tmp))  # the eager pipeline's warm
        sched = {"eager": [], "replayed": []}
        for rep in range(3):
            turn = [("eager", cold_pipe), ("replayed", pipe)]
            for label, p in (turn if rep % 2 == 0 else turn[::-1]):
                before = sum(synth.graph_replays[k] for k in sched_keys)
                sched[label].append(asyncio.run(first_batch(p, tmp)))
                if label == "replayed":
                    check("the scheduler's batches did not replay",
                          sum(synth.graph_replays[k] for k in sched_keys)
                          - before == len(sched_keys))
    out["scheduler_first_batch"] = {
        "keys": [list(k) for k in sched_keys],
        **{label: {"submit_to_result_ms": runs, "median_ms":
                   statistics.median(max(r) for r in runs)}
           for label, runs in sched.items()}}
    log(f"scheduler, phase 7's first {len(first)} tasks (stage-B keys "
        f"{sched_keys}): submit -> last result, median of 3: eager "
        f"{out['scheduler_first_batch']['eager']['median_ms']:.1f} ms, "
        f"replayed "
        f"{out['scheduler_first_batch']['replayed']['median_ms']:.1f} ms "
        f"({card})")

    # -- bf16 at bench.py's shape, eager vs replayed
    cfg16 = dataclasses.replace(synth.config, dtype=torch.bfloat16)
    buckets = {"token_buckets": (BENCH["tokens"],),
               "frame_buckets": (BENCH["frames"],)}
    e16 = Synthesizer(cfg16, params=tree, **buckets)
    w16 = Synthesizer(cfg16, params=tree, **buckets)
    texts32 = [BENCH_TEXT] * BENCH["batch"]
    fmts16 = ("pcm16", "mulaw8k")
    ref16 = {}
    for engine in (e16, w16):
        engine.register_random_voice("bench_voice", seed=7)
    for fmt in fmts16:
        _, ref16[fmt] = render(e16, texts32, fmt, voice="bench_voice")
    t0 = time.perf_counter()
    w16.warmup(batch_sizes=(BENCH["batch"],), token_sizes=(BENCH["tokens"],),
               frame_sizes=(BENCH["frames"],), formats=fmts16)
    out["bf16"] = {"warmup_s": time.perf_counter() - t0, "bitwise_equal": {},
                   "wall_ms": {}}
    reset_counts()
    for fmt in fmts16:
        h, clips = render(w16, texts32, fmt, voice="bench_voice")
        out["bf16"]["bitwise_equal"][fmt] = check(
            f"bf16 replayed {fmt} differs from the eager render",
            same(clips, ref16[fmt]))
    replayed16 = bf16_counts()
    want16 = {name: kernel_launches(name, conv_per_generator, len(fmts16))
              for name in replayed16}
    check(f"bf16 replays launched {replayed16}, want {want16} and no f32 "
          "form", replayed16 == want16 and not oa.launches
          and not any(asc.launches.values())
          and not any(am.launches.values()))
    check("bf16 keys did not replay", all(
        w16.graph_replays[k] == (len(fmts16) if stage_kind(k) == "a" else 1)
        for k in w16._graphs))
    for fmt in fmts16:
        runs = {"eager": [], "replayed": []}
        for rep in range(GRAPH_REPS):
            turn = [("eager", e16), ("replayed", w16)]
            for label, engine in (turn if rep % 2 == 0 else turn[::-1]):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                render(engine, texts32, fmt, voice="bench_voice")
                runs[label].append((time.perf_counter() - t0) * 1e3)
        row = {label: {"ms": ms, "median_ms": statistics.median(ms)}
               for label, ms in runs.items()}
        out["bf16"]["wall_ms"][fmt] = row
        log(f"bf16 bench.py shape (B=32, T 256, F 512), {fmt}: replayed "
            f"bitwise equal to eager: {out['bf16']['bitwise_equal'][fmt]}; "
            f"wall ms, medians of {GRAPH_REPS} in turns: eager "
            f"{row['eager']['median_ms']:.1f}, replayed "
            f"{row['replayed']['median_ms']:.1f}; bf16 launches of the two "
            f"replays {replayed16} ({card})")
    del e16, w16
    torch.cuda.empty_cache()

    # -- the windowed stream: prepare and window graphs captured at first
    # use, replayed, against the eager reference loop
    out["windowed"], replayed_streams = stream_graphs(
        torch, np, synth, requests, tree, inventory, oa, asc,
        conv_per_generator, card, check, reset_counts)

    # -- TTS_WARMUP=1: create_app warms a fresh engine through warmup_staged
    fresh = Synthesizer(synth.config, params=tree, **inventory)
    fresh.register_random_voice("smoke_voice", seed=0)
    fresh_pipe = type(pipe)(synthesizer=fresh)

    async def post_tts(session, port, text):
        """-> (status, replays of stage A, of stage B, Generator passes)."""
        reset_counts()
        before = dict(fresh.graph_replays)
        async with session.post(f"http://127.0.0.1:{port}/api/tts",
                                json={"text": text,
                                      "voice_id": "smoke_voice"}) as resp:
            await resp.read()
        grown = {k: n - before.get(k, 0)
                 for k, n in fresh.graph_replays.items()}
        return (resp.status,
                sum(n for k, n in grown.items() if stage_kind(k) == "a"),
                sum(n for k, n in grown.items() if stage_kind(k) == "b"),
                oa.launches)

    async def serve_warm(out_dir):
        app = endpoints.create_app(pipeline=fresh_pipe, max_wait_time=0.1,
                                   batch_size=4, output_dir=out_dir)
        t0 = time.perf_counter()
        runner = web.AppRunner(app, shutdown_timeout=2.0)
        await runner.setup()  # runs the startup: warmup_staged
        site = web.TCPSite(runner, "127.0.0.1", 0)
        await site.start()
        ready_s = time.perf_counter() - t0
        port = runner.addresses[0][1]
        primary = sorted(fresh._graphs, key=len)
        background = [t for t in threading.enumerate()
                      if t.name == "warmup-background"]
        try:
            headers = {"Authorization":
                       f"Bearer {create_access_token('smoke')}"}
            async with aiohttp.ClientSession(headers=headers) as session:
                first_req = await post_tts(session, port, TASKS[0][2])
                t_bg = time.perf_counter()
                for thread in background:
                    await asyncio.to_thread(thread.join, 900.0)
                bg_s = time.perf_counter() - t_bg
                alive = any(t.is_alive() for t in background)
                other = await post_tts(session, port, WARM_TEXTS[0])
        finally:
            await runner.cleanup()
        return ready_s, primary, first_req, len(background), bg_s, alive, \
            other

    os.environ["TTS_WARMUP"] = "1"
    try:
        with tempfile.TemporaryDirectory() as tmp:
            ready_s, primary, first_req, n_bg, bg_s, alive, other = \
                asyncio.run(serve_warm(tmp))
    finally:
        os.environ.pop("TTS_WARMUP", None)
    stalls = [g.lock_s for k, g in fresh._graphs.items() if k not in primary]
    out["tts_warmup"] = {
        "startup_to_ready_s": ready_s, "primary_keys": [list(k)
                                                        for k in primary],
        "warmup_phases": fresh.last_warmup_phases,
        "drain_s": fresh.last_drain_s,
        "first_request": dict(zip(("status", "stage_a_replays",
                                   "stage_b_replays", "generator_passes"),
                                  first_req)),
        "background_s_after_first_request": bg_s,
        "background_keys": len(stalls),
        "background_capture_lock_s": {"max": max(stalls, default=0.0),
                                      "sum": sum(stalls)},
        "other_shape_request": dict(zip(("status", "stage_a_replays",
                                         "stage_b_replays",
                                         "generator_passes"), other)),
        "graphs": len(fresh._graphs), "card": card}
    for label, (status, a_n, b_n, passes) in (("first", first_req),
                                              ("other-shape", other)):
        check(f"TTS_WARMUP {label} request: status {status}, stage A "
              f"replays {a_n}, stage B replays {b_n} of {passes} passes",
              status == 200 and a_n >= 1 and b_n == passes >= 1)
    check("TTS_WARMUP: no background warmup thread, or it did not end",
          n_bg == 1 and not alive)
    log(f"TTS_WARMUP=1 create_app: startup to ready {ready_s:.2f} s "
        f"(primary keys {primary}, phases {fresh.last_warmup_phases}, "
        f"drain {fresh.last_drain_s:.3f} s); first /api/tts: stage A "
        f"replays {first_req[1]}, stage B replays {first_req[2]} of "
        f"{first_req[3]} Generator passes; background pass ended "
        f"{bg_s:.2f} s after it ({len(stalls)} keys, each capture holding "
        f"the engine lock up to {max(stalls, default=0.0) * 1e3:.1f} ms, "
        f"{sum(stalls) * 1e3:.1f} ms in all); another shape then: stage A "
        f"replays {other[1]}, stage B replays {other[2]} of {other[3]} "
        f"passes ({card})")
    del fresh, fresh_pipe
    torch.cuda.empty_cache()

    # -- load_params on a warmed engine drops every graph
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "weights.msgpack")
        synth.save_params(path)
        synth.load_params(path)
    replays = dict(synth.graph_replays)
    _, after = render(synth, [ZH], "pcm16")
    _, want_zh = render(cold, [ZH], "pcm16")
    out["load_params"] = {
        "graphs_left": len(synth._graphs),
        "nothing_replayed": dict(synth.graph_replays) == replays,
        "bitwise_equal_to_fresh_engine": same(after, want_zh)}
    check(f"after load_params: {out['load_params']}",
          out["load_params"]["graphs_left"] == 0
          and out["load_params"]["nothing_replayed"]
          and out["load_params"]["bitwise_equal_to_fresh_engine"])
    log(f"load_params on the warmed engine: {out['load_params']}")
    del cold, cold_pipe
    torch.backends.cudnn.deterministic = False
    torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t_phase
    log(f"phase 12: {out['seconds']:.1f} s ({card})")
    return out, {**replayed, **replayed16}, replayed_streams


def memory_growth(memory):
    """A capture's growth of the allocator's reserved and allocated bytes
    and segments (``StageGraph.memory``), as a log phrase."""
    if "before" not in memory:
        return "allocator state not recorded"
    before, after = memory["before"], memory["after"]
    mib = {key: (after[key] - before[key]) / 2 ** 20
           for key in ("reserved_bytes", "allocated_bytes")}
    return (f"reserved +{mib['reserved_bytes']:.1f} MiB (to "
            f"{after['reserved_bytes'] / 2 ** 30:.2f} GiB), allocated "
            f"+{mib['allocated_bytes']:.1f} MiB, segments "
            f"+{after['segments'] - before['segments']}")


def stream_graphs(torch, np, synth, requests, tree, inventory, oa, asc,
                  conv_per_generator, card, check, reset_counts):
    """Phase 12's windowed streams (zh_1 and mixed_4 in float32, zh_1 in
    bfloat16), each on a fresh engine under deterministic cuDNN: the
    eager reference loop (``eager_windowed_stream``), then the engine's
    first use (its prepare and window graphs captured), then its replays,
    bitwise equal to the reference with exact launches; then first-chunk
    and whole-stream ms, eager reference against replayed, medians of
    ``GRAPH_REPS`` in turns. -> (summary, the kernels' launches in the
    replayed streams)."""
    import dataclasses

    from illufly_tts_tpu_torch.engine.synthesizer import Synthesizer
    from illufly_tts_tpu_torch.ops import adain_moments as am

    def fresh(dtype):
        engine = Synthesizer(dataclasses.replace(synth.config, dtype=dtype),
                             params=tree, **inventory)
        engine.register_random_voice("smoke_voice", seed=0)
        return engine

    def launches():
        return {"istft_oa": oa.launches, "istft_head_bf16": oa.launches_bf16,
                **asc.launches, **asc.launches_bf16, **am.launches,
                **am.launches_bf16}

    def want_launches(passes, bf16, fronts):
        names = (("istft_head_bf16", *BF16_CONV, "adain_fold_bf16") if bf16
                 else ("istft_oa", *CONV_KERNELS, "adain_fold"))
        want = {name: 0 for name in launches()}
        want.update({name: kernel_launches(name, conv_per_generator, passes,
                                           fronts) for name in names})
        return want

    def eager_stream(engine, texts):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        h = engine.dispatch(texts, ["smoke_voice"] * len(texts), fmt="f32")
        gen = eager_windowed_stream(torch, np, engine, h, STREAM_WINDOW,
                                    STREAM_HALO)
        chunks = [next(gen)]
        first_ms = (time.perf_counter() - t0) * 1e3
        chunks += list(gen)
        return h, chunks, first_ms, (time.perf_counter() - t0) * 1e3

    def replayed_stream(engine, texts):
        return timed_stream(torch, engine, texts)

    def same(a, b):
        return len(a) == len(b) and all(
            x.shape == y.shape and x.tobytes() == y.tobytes()
            for x, y in zip(a, b))

    out, replayed = {}, {}
    engines = {torch.float32: fresh(torch.float32),
               torch.bfloat16: fresh(torch.bfloat16)}
    for label, texts, dtype in (("zh_1", requests["zh_1"], torch.float32),
                                ("mixed_4", requests["mixed_4"],
                                 torch.float32),
                                ("zh_1 bf16", requests["zh_1"],
                                 torch.bfloat16)):
        engine = engines[dtype]
        bf16 = dtype == torch.bfloat16
        _, ref, _, _ = eager_stream(engine, texts)
        reset_counts()
        (_, chunks, _, first_use_ms), use = first_use(
            engine, lambda: replayed_stream(engine, texts),
            f"phase 12 windowed {label}", card)
        windows = len(chunks)
        row = {"windows": windows, "first_use": use,
               "first_use_bitwise_equal": check(
                   f"windowed {label}: the first use differs from the eager "
                   "reference loop", same(chunks, ref))}
        check(f"windowed {label}, first use: launches {launches()}",
              launches() == want_launches(windows + 1, bf16,
                                          first_use_fronts(use)))
        reset_counts()
        replays0 = sum(engine.graph_replays.values())
        _, chunks, _, _ = timed_stream(torch, engine, texts)
        got = launches()
        for name, n in got.items():
            replayed[name] = replayed.get(name, 0) + n
        row["replayed_bitwise_equal"] = check(
            f"windowed {label}: replayed differs from the eager reference "
            "loop", same(chunks, ref))
        row["launches_replayed"] = got
        check(f"windowed {label}, replayed: launches {got}",
              got == want_launches(windows, bf16, 1))
        grown = sum(engine.graph_replays.values()) - replays0
        check(f"windowed {label}: {grown} replays, want {windows + 1}",
              grown == windows + 1)
        runs = {"eager": [], "replayed": []}
        for rep in range(GRAPH_REPS):
            turn = [("eager", eager_stream), ("replayed", replayed_stream)]
            for name, run in (turn if rep % 2 == 0 else turn[::-1]):
                _, _, first_ms, all_ms = run(engine, texts)
                runs[name].append((first_ms, all_ms))
        for name, ms in runs.items():
            row[name] = {
                "first_chunk_ms": [f for f, _ in ms],
                "all_chunks_ms": [a for _, a in ms],
                "first_chunk_median_ms": statistics.median(f for f, _ in ms),
                "all_chunks_median_ms": statistics.median(a for _, a in ms)}
        row["first_use_extra_s"] = (
            first_use_ms - row["replayed"]["all_chunks_median_ms"]) / 1e3
        out[label] = row
        log(f"windowed {label} ({windows} windows of {STREAM_WINDOW} + "
            f"{STREAM_HALO} frames): first use and replays bitwise equal to "
            f"the eager reference loop: {row['first_use_bitwise_equal']}, "
            f"{row['replayed_bitwise_equal']}; medians of {GRAPH_REPS} in "
            f"turns, first chunk / whole stream ms: eager "
            f"{row['eager']['first_chunk_median_ms']:.1f} / "
            f"{row['eager']['all_chunks_median_ms']:.1f}, replayed "
            f"{row['replayed']['first_chunk_median_ms']:.1f} / "
            f"{row['replayed']['all_chunks_median_ms']:.1f} ({card})")
        log(f"windowed {label}: the first use took "
            f"{row['first_use_extra_s']:.3f} s more than a replayed stream "
            f"(warm passes and captures); per key: " + "; ".join(
                f"{key} lock held {v['capture_lock_s'] * 1e3:.1f} ms, "
                f"{memory_growth(v)}" for key, v in use["keys"].items()))

    # two streams of one key, their windows interleaved (each replay copies
    # its own stream's inputs into the graphs' static inputs): zh_1 at
    # pitch 1 and 1.3, each against its eager reference
    engine = engines[torch.float32]
    texts = requests["zh_1"]

    def pitched(pitch):
        return engine.dispatch(texts, ["smoke_voice"] * len(texts),
                               fmt="f32", pitches=[pitch] * len(texts))

    pitches = (1.0, 1.3)
    refs = [list(eager_windowed_stream(torch, np, engine, pitched(p),
                                       STREAM_WINDOW, STREAM_HALO))
            for p in pitches]
    replays0 = dict(engine.graph_replays)
    pairs = list(zip(*(engine.stream_decode(pitched(p), STREAM_WINDOW,
                                            STREAM_HALO, exact=False)
                       for p in pitches)))
    row = {"pitches": pitches,
           "bitwise_equal": [same([pair[i] for pair in pairs], refs[i])
                             for i in range(2)],
           "streams_differ": not same(*refs),
           "replays": {str(k): n - replays0.get(k, 0)
                       for k, n in engine.graph_replays.items()
                       if n != replays0.get(k, 0)}}
    check(f"two interleaved zh_1 streams of one key: {row}",
          all(row["bitwise_equal"]) and row["streams_differ"]
          and sum(row["replays"].values()) == 2 * (len(refs[0]) + 1))
    out["interleaved_zh_1"] = row
    log(f"two zh_1 streams of one key (pitch {pitches}), windows "
        f"interleaved: each bitwise equal to its eager reference loop: "
        f"{row['bitwise_equal']}; the two differ: {row['streams_differ']}; "
        f"replays {row['replays']} ({card})")

    # the largest stream keys' first use: long_8 (B=8, F 4096), to its
    # first chunk
    texts = requests["long_8"]
    h = engine.dispatch(texts, ["smoke_voice"] * len(texts), fmt="f32")

    def first_chunk():
        gen = engine.stream_decode(h, STREAM_WINDOW, STREAM_HALO,
                                   exact=False)
        chunk = next(gen)
        gen.close()
        return chunk

    chunk, use = first_use(engine, first_chunk, "phase 12 windowed long_8",
                           card)
    check(f"windowed long_8: first chunk {chunk.shape}, finite "
          f"{np.isfinite(chunk).all()}",
          chunk.shape == (len(texts), STREAM_WINDOW
                          * engine.config.samples_per_frame)
          and bool(np.isfinite(chunk).all()))
    out["long_8_first_use"] = use
    log(f"windowed long_8 (B=8, F {h.f_bucket}), first use to the first "
        f"chunk: {use['s']:.3f} s; per key: " + "; ".join(
            f"{key} warm pass {v['warm_pass_s'] * 1e3:.1f} ms, lock held "
            f"{v['capture_lock_s'] * 1e3:.1f} ms, {memory_growth(v)}"
            for key, v in use["keys"].items()) + f" ({card})")
    del engines, engine
    torch.cuda.empty_cache()
    return out, replayed


MESH_REPS = 5  # phase 13: timed B=8 renders per engine, in turns


def mesh_phase(torch, np, synth, cfg, requests, layers, vocoder, asc, oa,
               conv_per_generator, card, failures, reset_counts,
               check_counts, check_wave, dev):
    """Phase 13: data parallelism, one replica per 'data' device, here two
    (and three) replicas sharing the one card. -> (summary dict, f32
    launches by kernel, bf16 launches by kernel, f32 conv shapes by
    kernel, head shapes, bf16 conv shapes, bf16 head shapes)."""
    import asyncio
    import base64
    import copy
    import dataclasses
    import tempfile

    import aiohttp
    from aiohttp import web

    from illufly_tts_tpu_torch.api import endpoints
    from illufly_tts_tpu_torch.api.auth import create_access_token
    from illufly_tts_tpu_torch.audio.telephony import mulaw_decode_np
    from illufly_tts_tpu_torch.engine.synthesizer import Synthesizer
    from illufly_tts_tpu_torch.model.params import export_flax_params
    from illufly_tts_tpu_torch.ops import adain_moments as am
    from illufly_tts_tpu_torch.parallel.mesh import compute_copy, make_mesh
    from illufly_tts_tpu_torch.pipeline import CachedTTSPipeline
    from illufly_tts_tpu_torch.training import loop
    from illufly_tts_tpu_torch.training import step as tstep

    t_phase = time.perf_counter()
    torch.backends.cudnn.deterministic = True  # bitwise comparisons below
    out = {"card": card, "cudnn_deterministic": True, "checks": {}}
    launches = {"istft_oa": 0, **{name: 0 for name in CONV_KERNELS},
                "adain_fold": 0}
    tree = export_flax_params(synth.model)  # phase 4's weights
    voice = "smoke_voice"

    def check(label, ok):
        out["checks"][label] = bool(ok)
        if not ok:
            failures.append(f"phase 13: {label}")
        return ok

    def counted(label, generator_runs, fronts=None):
        got = check_counts(f"phase 13: {label}", generator_runs,
                           fronts=fronts)
        for name, n in got.items():
            launches[name] += n

    def same(a, b):
        return len(a) == len(b) and all(
            x.dtype == y.dtype and x.tobytes() == y.tobytes()
            for x, y in zip(a, b))

    # -- the mesh
    one = make_mesh(n_data=1)
    check("make_mesh(n_data=1) spans cuda:0",
          one.shape == {"data": 1, "model": 1} and one.data_devices == [dev])
    refused = None
    try:
        make_mesh(n_data=torch.cuda.device_count() + 1)
    except AssertionError as exc:
        refused = str(exc)
    check("make_mesh past the card count raises AssertionError",
          refused is not None)
    mesh2 = make_mesh(n_data=2, devices=[dev] * 2)
    mesh3 = make_mesh(n_data=3, devices=[dev] * 3)
    check("meshes over a repeated cuda:0",
          mesh2.shape["data"] == 2 and mesh3.shape["data"] == 3)
    log(f"phase 13: make_mesh(n_data=1) {one}; make_mesh(n_data="
        f"{torch.cuda.device_count() + 1}) raises {refused!r}; 2 and 3 "
        f"replicas on cuda:0 built")

    single = Synthesizer(cfg, params=tree, device=dev)
    e2 = Synthesizer(cfg, params=tree, mesh=mesh2)
    e3 = Synthesizer(cfg, params=tree, mesh=mesh3)
    for engine in (single, e2, e3):
        engine.register_random_voice(voice, seed=0)
    buckets = (single.batch_buckets, single.token_buckets,
               single.frame_buckets)

    def forced(rows, t_bucket, f_bucket):
        single.batch_buckets, single.token_buckets = (rows,), (t_bucket,)
        single.frame_buckets = (f_bucket,)

    def unforced():
        (single.batch_buckets, single.token_buckets,
         single.frame_buckets) = buckets

    def shard_refs(h, texts, fmt):
        """The one-device engine's render of each replica's real rows at
        the replica's batch size and the batch's token and frame
        buckets."""
        rows = h.b_bucket // len(h.shards)
        refs = []
        forced(rows, h.t_bucket, h.f_bucket)
        try:
            for lo in range(0, len(texts), rows):
                part = texts[lo:lo + rows]
                refs += single.collect(single.dispatch(
                    part, [voice] * len(part), fmt=fmt))
        finally:
            unforced()
        return refs

    def as_float(clip):
        return mulaw_decode_np(clip) if clip.dtype == np.uint8 else clip

    def close(got, want):
        """-> (equal lengths and rms/scale below ``CPU_GPU_TOL`` for every
        item, the golden gate; the worst rms/scale; the worst max
        |difference| over max(peak, 1), ``tests/test_sharding.py``'s
        measure; for mu-law the largest code difference)."""
        worst_rms = worst_max = 0.0
        codes = None
        for a, b in zip(got, want):
            if a.size != b.size:
                return False, None, None, None
            if a.dtype == np.uint8:
                codes = max(codes or 0, int(np.abs(
                    a.astype(np.int16) - b).max()))
            a, b = as_float(a).astype(np.float64), as_float(b)
            rms = float(np.sqrt(np.mean((a - b) ** 2)))
            worst_rms = max(worst_rms, rms / (float(np.sqrt(np.mean(
                b.astype(np.float64) ** 2))) + 1e-9))
            worst_max = max(worst_max, float(np.abs(a - b).max()) / max(
                float(np.abs(b).max()), 1.0))
        return (len(got) == len(want) and worst_rms < CPU_GPU_TOL,
                worst_rms, worst_max, codes)

    # -- serving on two replicas
    conv_shapes, head_shapes = record_shapes(layers, vocoder, asc, oa)
    b8 = requests["mixed_4"] * 2
    cases = [("zh_1", requests["zh_1"], "pcm16"),
             ("zh_1", requests["zh_1"], "mulaw8k"),
             ("mixed_4", requests["mixed_4"], "pcm16"),
             ("mixed_4", requests["mixed_4"], "mulaw8k"),
             ("mixed_4", requests["mixed_4"], "f32"),
             ("b8", b8, "pcm16"), ("b8", b8, "mulaw8k")]
    served, eager = [], {}
    try:
        for name, texts, fmt in cases:
            reset_counts()
            h = e2.dispatch(texts, [voice] * len(texts), fmt=fmt)
            got = e2.collect(h)
            counted(f"{name}/{fmt} on 2 replicas", 2)
            per = 200 if fmt == "mulaw8k" else 600
            for i, clip in enumerate(got):
                check_wave(f"phase 13 {name}/{fmt}[{i}]", clip,
                           int(h.fitted_totals[i]) * per)
            bitwise = check(f"{name}/{fmt}: each replica's rows bitwise the "
                            "one-device engine's at the shard's batch",
                            same(got, shard_refs(h, texts, fmt)))
            # the one-device engine at the whole batch's size: other
            # shapes, so cuDNN and cuBLAS may sum in other orders
            whole = single.collect(single.dispatch(texts, [voice] * len(
                texts), fmt=fmt))
            ok, rms, worst, codes = close(got, whole)
            if fmt != "mulaw8k":  # a flipped code near the peak is ~1%
                check(f"{name}/{fmt}: gathered within the golden gate of "
                      "the one-device batch render", ok)
            eager[name, fmt] = got
            served.append({"request": name, "fmt": fmt, "b_bucket": h.b_bucket,
                           "shard_rows": [s.b_bucket for s in h.shards],
                           "t_bucket": h.t_bucket, "f_bucket": h.f_bucket,
                           "shards_bitwise": bitwise,
                           "rms_over_scale": rms,
                           "max_err_over_peak": worst,
                           "max_code_diff": codes})
            log(f"phase 13: {name}/{fmt} on 2 replicas: B bucket "
                f"{h.b_bucket} as {[s.b_bucket for s in h.shards]}, "
                f"T {h.t_bucket}, F {h.f_bucket}; shards bitwise the "
                f"one-device engine's: {bitwise}; gathered vs the one-device "
                f"batch render: rms/scale {rms} (limit {CPU_GPU_TOL}, "
                f"pcm16/f32), max err/max(peak, 1) {worst}"
                + (f", codes at most {codes} apart" if codes is not None
                   else ""))
        texts4 = requests["mixed_4"]
        reset_counts()
        h3 = e3.dispatch(texts4, [voice] * 4)
        got3 = e3.collect(h3)
        counted("mixed_4 on 3 replicas", 3)
        check("3 replicas pad mixed_4 to 6 rows",
              h3.b_bucket == 6 and [s.b_bucket for s in h3.shards]
              == [2, 2, 2])
        # the real rows run at two a replica on both engines
        ok3 = check("3 replicas bitwise the 2 replicas' render",
                    same(got3, eager["mixed_4", "pcm16"]))
        out["serving"] = served
        out["three_replicas"] = {"b_bucket": h3.b_bucket, "bitwise": ok3}
        log(f"phase 13: mixed_4 on 3 replicas: B bucket {h3.b_bucket} as "
            f"{[s.b_bucket for s in h3.shards]}, bitwise the 2 replicas' "
            f"render: {ok3}")

        # -- graphs and streams on two replicas
        h = e2.dispatch(texts4, [voice] * 4)
        e2.collect(h)
        key4 = (h.t_bucket, h.f_bucket)
        t0 = time.perf_counter()
        e2.warmup(batch_sizes=(4,), token_sizes=(key4[0],),
                  frame_sizes=(key4[1],), formats=("pcm16",))
        warm_s = time.perf_counter() - t0
        reset_counts()
        h = e2.dispatch(texts4, [voice] * 4, fmt="pcm16")
        replayed = e2.collect(h)
        counted("mixed_4 replayed on 2 replicas", 2)
        keys = [(2, key4[0]), (2, key4[0], key4[1], "pcm16")]
        check("each replica replays its graphs",
              all(rep.graph_replays[k] == 1 for rep in e2._replicas
                  for k in keys))
        check("replays bitwise equal to eager",
              same(replayed, eager["mixed_4", "pcm16"]))
        zh = requests["zh_1"]
        h = e2.dispatch(zh, [voice], fmt="f32")
        exact = np.concatenate(list(e2.stream_decode(
            h, window_frames=STREAM_WINDOW)), axis=1)
        check("exact stream on 2 replicas bitwise equal to collect()",
              exact[0].tobytes() == e2.collect(e2.dispatch(
                  zh, [voice], fmt="f32"))[0].tobytes())
        streams = {}
        for label in ("first use", "replayed"):
            reset_counts()
            h = e2.dispatch(zh, [voice], fmt="f32")
            t0 = time.perf_counter()
            chunks = list(e2.stream_decode(h, window_frames=STREAM_WINDOW,
                                           halo_frames=STREAM_HALO,
                                           exact=False))
            ms = (time.perf_counter() - t0) * 1e3
            # each replica prepares once and renders every window; at
            # first use each one's prepare and window captures add their
            # warm passes
            counted(f"windowed stream ({label}) on 2 replicas",
                    2 * len(chunks) + (2 if label == "first use" else 0),
                    fronts=2 * (2 if label == "first use" else 1))
            streams[label] = (chunks, ms, h.f_bucket)
        forced(1, h.t_bucket, h.f_bucket)
        try:
            hs = single.dispatch(zh, [voice], fmt="f32")
            ref = list(single.stream_decode(hs, window_frames=STREAM_WINDOW,
                                            halo_frames=STREAM_HALO,
                                            exact=False))
        finally:
            unforced()
        first, again = streams["first use"][0], streams["replayed"][0]
        check("windowed stream replayed bitwise equal to its first use",
              same(first, again))
        check("windowed stream bitwise the one-device engine's",
              same(again, ref))
        for i, c in enumerate(again):
            check(f"windowed chunk {i} finite, not silent",
                  np.isfinite(c).all() and float(np.abs(c).max()) > 1e-4)
        pools = [pool_bytes(torch, rep._graph_pool) for rep in e2._replicas]
        out["graphs"] = {"warmup_s": warm_s, "keys": [list(k) for k in keys],
                         "pool_bytes": pools, "stream_chunks": len(again),
                         "stream_first_use_ms": streams["first use"][1],
                         "stream_replayed_ms": streams["replayed"][1]}
        log(f"phase 13: warmup of mixed_4's key on 2 replicas in {warm_s:.2f}"
            f" s, replays bitwise equal to eager; windowed stream of zh_1 "
            f"(F {streams['replayed'][2]}): {len(again)} chunks, first use "
            f"{streams['first use'][1]:.1f} ms, replayed "
            f"{streams['replayed'][1]:.1f} ms, bitwise the one-device "
            f"engine's; pool bytes per replica {pools} ({card})")

        # -- text in: the scheduler and create_app over TTSPipeline(mesh=)
        pipe = frozen_frontend(CachedTTSPipeline)(mesh=mesh2)
        eng = pipe.synthesizer
        eng.register_random_voice(voice, seed=0)
        check("TTSPipeline(mesh=) serves on 2 replicas",
              len(eng._replicas) == 2 and eng.device == dev)
        batches = []
        dispatch = eng.dispatch

        def recorded_dispatch(*args, **kw):
            batches.append((args, kw))
            return dispatch(*args, **kw)

        eng.dispatch = recorded_dispatch
        texts = (TASKS[0][2], TASKS[6][2])
        os.environ.pop("TTS_DEV_MODE", None)
        os.environ["FASTAPI_SECRET_KEY"] = os.urandom(16).hex()
        token = create_access_token("mesh_user")

        async def http(out_dir):
            app = endpoints.create_app(pipeline=pipe, max_wait_time=0.2,
                                       batch_size=4, output_dir=out_dir)
            runner = web.AppRunner(app, shutdown_timeout=2.0)
            await runner.setup()
            site = web.TCPSite(runner, "127.0.0.1", 0)
            await site.start()
            port = runner.addresses[0][1]
            headers = {"Authorization": f"Bearer {token}"}
            try:
                async with aiohttp.ClientSession(headers=headers) as session:
                    async def post(text):
                        async with session.post(
                                f"http://127.0.0.1:{port}/api/tts",
                                json={"text": text, "voice_id": voice}) as r:
                            return r.status, await r.read()

                    return await asyncio.gather(*(post(t) for t in texts))
            finally:
                await runner.cleanup()

        reset_counts()
        t0 = time.perf_counter()
        with tempfile.TemporaryDirectory() as out_dir:
            answers = asyncio.run(http(out_dir))
        http_ms = (time.perf_counter() - t0) * 1e3
        counted("two HTTP requests on 2 replicas", 2 * len(batches))
        del eng.dispatch
        ok = all(status == 200 for status, _ in answers)
        check("HTTP 200 for both requests", ok)
        rows = []
        for args, kw in batches:
            rows += [r.tobytes() for r in eng.collect(
                eng.dispatch(*args, **kw), pcm16=True)]
        wavs = [np.frombuffer(riff_data(base64.b64decode(
            json.loads(body)["audio_base64"])), "<i2").tobytes()
            for status, body in answers if status == 200]
        check("WAV bodies equal the mesh engine's own render",
              ok and len(wavs) == 2 and all(w in rows for w in wavs))
        out["http"] = {"requests": len(texts), "engine_batches": [
            len(args[0]) for args, _ in batches], "wall_ms": http_ms}
        log(f"phase 13: create_app over TTSPipeline(mesh=2 replicas): two "
            f"concurrent requests in {http_ms:.1f} ms (client wall), the "
            f"scheduler's batches {out['http']['engine_batches']}, WAV "
            f"bodies equal to the engine's render ({card})")
        del pipe, eng

        # -- wall time, two replicas against one device, B=8 on one card
        walls = {"one device": [], "2 replicas": []}
        order = [("one device", single), ("2 replicas", e2)]
        for rep in range(MESH_REPS):
            for label, engine in order if rep % 2 == 0 else order[::-1]:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                engine.collect(engine.dispatch(b8, [voice] * 8))
                walls[label].append((time.perf_counter() - t0) * 1e3)
        out["b8_wall_ms"] = {k: statistics.median(v) for k, v in walls.items()}
        out["b8_wall_ms_all"] = walls
        log(f"phase 13: B=8 pcm16 (mixed_4 twice), host wall ms, median of "
            f"{MESH_REPS} in turns: one device "
            f"{out['b8_wall_ms']['one device']:.1f}, 2 replicas on the one "
            f"card {out['b8_wall_ms']['2 replicas']:.1f} (eager, "
            f"deterministic cuDNN; for information) [{card}]")
        del e3

        # -- training on two replicas
        init = copy.deepcopy(synth.model)
        teacher = copy.deepcopy(init)
        gen = loop.synthetic_batches(init, teacher, TRAIN["batch"],
                                     TRAIN["tokens"], TRAIN["frames"], seed=0)
        data = [next(gen) for _ in range(2)]
        del teacher, gen
        frames = TRAIN["frames"]

        def run(model, part, **kw):
            seen = []
            master, _, _ = loop.train(
                model, steps=len(part), batch_size=TRAIN["batch"],
                tokens=TRAIN["tokens"], frames=frames, log_every=1,
                batches=iter(part), on_metrics=lambda s, m: seen.append(m),
                **kw)
            return master, seen

        with tempfile.TemporaryDirectory() as ckpt:
            reset_counts()
            t0 = time.perf_counter()
            m_mesh, mesh_m = run(copy.deepcopy(init), data[:1], mesh=mesh2,
                                 checkpoint_dir=ckpt)
            torch.cuda.synchronize()
            mesh_step_s = time.perf_counter() - t0
            counted("train(mesh=2 replicas), step 0", 2)
            reset_counts()
            m_one, one_m = run(copy.deepcopy(init), data[:1])
            counted("train() on one device, step 0", 1)
            scale = float(data[0].target_audio.abs().mean())
            dur_err = abs(mesh_m[0]["dur_loss"] - one_m[0]["dur_loss"]) / (
                one_m[0]["dur_loss"])
            audio_err = abs(mesh_m[0]["audio_loss"] - one_m[0]["audio_loss"])
            check("step 0 loss: 2 replicas vs one device (phase 10's "
                  "tolerances)", dur_err <= STEP0_DUR_TOL
                  and audio_err <= CPU_GPU_TOL * scale)
            lr = 1e-4
            diff, n_off, n_all = 0.0, 0, 0
            for (name, p), q, p0 in zip(m_mesh.named_parameters(),
                                        m_one.parameters(),
                                        init.parameters()):
                d = ((p - p0) - (q - p0)).abs() / lr
                diff = max(diff, float(d.max()))
                n_off += int((d > 1e-3).sum())
                n_all += d.numel()
            check("step 0 weights: 2 replicas vs one device (each update "
                  "within two steps of lr, at most 1% of entries off by "
                  "1e-3 lr)", diff <= 2.002 and n_off <= 0.01 * n_all)
            reset_counts()
            m_mesh, more = run(m_mesh, data[1:], mesh=mesh2,
                               checkpoint_dir=ckpt, resume=True)
            counted("train(mesh=2 replicas), step 1 after a resume", 2)
        losses = [mesh_m[0]["loss"], more[0]["loss"]]
        check("2 mesh steps: finite losses",
              all(math.isfinite(v) for v in losses))
        out["training"] = {
            "mesh_losses": losses, "one_device_step0": one_m[0],
            "mesh_step0": mesh_m[0], "dur_loss_rel_err": dur_err,
            "audio_loss_err_over_mean_abs_target": audio_err / scale,
            "step0_update_max_diff_lr": diff,
            "step0_update_entries_off": n_off, "entries": n_all,
            "mesh_step0_s": mesh_step_s}
        log(f"phase 13: train(mesh=2 replicas) at B={TRAIN['batch']}, "
            f"tokens {TRAIN['tokens']}, frames {frames}: losses {losses}; "
            f"step 0 vs one device: dur_loss rel {dur_err:.2e} (limit "
            f"{STEP0_DUR_TOL}), audio_loss {audio_err / scale:.2e} of "
            f"mean|target| (limit {CPU_GPU_TOL}); updates differ by at most "
            f"{diff:.3f} lr, {n_off} of {n_all} entries by more than 1e-3 "
            f"lr ({card})")
        del m_mesh, m_one
    finally:
        unrecord(layers, vocoder, asc, oa)
        unforced()

    # -- bf16 training on one device, step 0 against the CPU's
    conv16, head16 = record_shapes(layers, vocoder, asc, oa)
    try:
        small = [tstep.TrainBatch(*(t[:2] for t in b)) for b in data]
        reset_counts()
        m16 = compute_copy(init, torch.bfloat16, dev)
        master16, seen16 = run(m16, small, master=init)
        got16 = bf16_counts()
        want16 = {n: kernel_launches(n, conv_per_generator, 2) for n in got16}
        f32_launched = (oa.launches + sum(asc.launches.values())
                        + sum(am.launches.values()))
        check("bf16 training launches each bf16 form per Generator pass, no "
              "f32 form", got16 == want16 and f32_launched == 0)
    finally:
        unrecord(layers, vocoder, asc, oa)
    check("bf16 train: finite losses, float32 masters",
          all(math.isfinite(m["loss"]) for m in seen16)
          and all(p.dtype == torch.float32 for p in master16.parameters()))
    cpu_batch = small[0].to("cpu")
    cpu = {}
    with torch.no_grad():
        for dtype in (torch.bfloat16, torch.float32):
            model = compute_copy(init, dtype, "cpu")
            audio, mask, dur_loss = tstep.teacher_forced_audio(
                model, frames, cpu_batch)
            audio_loss = (torch.abs(audio.float() - cpu_batch.target_audio)
                          * mask).sum() / mask.sum().clamp(min=1.0)
            cpu[dtype] = (float(dur_loss), float(audio_loss),
                          (audio.float() * mask))
            del model
    (d16, a16, w16), (d32, a32, w32) = cpu[torch.bfloat16], cpu[torch.float32]
    spread = float((w16 - w32).abs().mean())
    card16 = seen16[0]
    check("bf16 step 0, card vs CPU bf16: dur_loss within twice the CPU's "
          "bf16-vs-f32 distance, audio_loss within twice the CPU's mean "
          "|bf16 - f32 audio|",
          abs(card16["dur_loss"] - d16) <= 2 * abs(d16 - d32)
          and abs(card16["audio_loss"] - a16) <= 2 * spread)
    out["bf16_training"] = {
        "batch": 2, "losses": [m["loss"] for m in seen16],
        "card_step0": card16, "cpu_bf16": {"dur_loss": d16,
                                           "audio_loss": a16},
        "cpu_f32": {"dur_loss": d32, "audio_loss": a32},
        "cpu_mean_abs_bf16_minus_f32_audio": spread, "launches": got16}
    log(f"phase 13: bf16 train() on a float32 master from the float32 "
        f"weights, B=2, 2 steps: losses "
        f"{out['bf16_training']['losses']}; step 0 card vs CPU bf16: "
        f"dur_loss {card16['dur_loss']:.5f} vs {d16:.5f} (CPU f32 {d32:.5f}),"
        f" audio_loss {card16['audio_loss']:.5f} vs {a16:.5f} (CPU f32 "
        f"{a32:.5f}, mean |bf16 - f32 audio| {spread:.5f}); launches {got16}")
    torch.backends.cudnn.deterministic = False
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"phase 13 in {out['phase_s']:.1f} s")
    return (out, launches, got16, conv_shapes, head_shapes, conv16, head16)


# phase 14: tensor parallelism, the 'model' axis on the one card
TP_REPS = 5  # timed B=8 renders per engine and mode, in turns
# the fused convs at a 2-way split's shapes: (C_in, C_out = C_in / 2, L)
# of the Generator's two stages at B=8 and frame bucket 512
TP_CONV_SHAPES = ((256, 128, 10240), (128, 64, 61440))
# train step 0 on a 1 x 2 mesh against one device: each loss, relative
TP_STEP0_TOL = 1e-5


def split_conv_inputs(torch, batch, c_in, c_out, length, kernel, seed):
    """``conv_inputs`` at C_in, with w [k, C_in, C_out] and b [C_out]: a
    column shard's operands."""
    x, mask, scale, shift, alpha, _, _ = conv_inputs(
        torch, batch, c_in, length, kernel, seed)
    gen = torch.Generator(device="cuda").manual_seed(seed + 1000)
    w = torch.randn((kernel, c_in, c_out), device="cuda",
                    generator=gen) / math.sqrt(c_in * kernel)
    return (x, mask, scale, shift, alpha, w,
            0.1 * torch.randn(c_out, device="cuda", generator=gen))


def as_bf16(asc, args):
    x, mask, scale, shift, alpha, w, b = args
    return x.bfloat16(), mask, scale, shift, alpha, asc.pack_weights(w), b


def check_split_conv(torch, asc, name, shapes):
    """Kernel ``name`` (an f32 form or a bf16 form) against its plain
    version at each (B, C_in, C_out, L, k, d) -> max|kernel - plain|
    (bf16: over max|plain|). f32 within CONV_TOL * (1 + max|plain|), bf16
    within BF16_TOL of max|plain|, as phases 3 and 11 hold them."""
    bf16 = name in BF16_CONV
    fn = getattr(asc, BF16_CONV.get(name, name))
    worst = 0.0
    for i, (batch, c_in, c_out, length, k, d) in enumerate(shapes):
        args = split_conv_inputs(torch, batch, c_in, c_out, length, k, 70 + i)
        if bf16:
            args = as_bf16(asc, args)
        out = fn(*args, k, d)
        torch.cuda.synchronize()
        ref = asc.adain_snake_conv_plain(*args, k, d)
        if out.shape != (batch, c_out, length) or out.dtype != ref.dtype:
            fail(f"{name} at {shapes[i]}: {out.dtype} {tuple(out.shape)}")
        err = float((out.float() - ref.float()).abs().max())
        peak = float(ref.float().abs().max())
        if bf16:
            ok, err = err <= BF16_TOL * peak, err / max(peak, 1e-30)
        else:
            ok = err <= CONV_TOL * (1.0 + peak)
        if not ok:
            fail(f"{name} disagrees with plain at {shapes[i]}: {err}")
        worst = max(worst, err)
        del args, out, ref
    log(f"  {name}: {len(shapes)} split shapes, max|kernel - plain| = "
        f"{worst:.3e}" + (" of max|plain| (gate 2^-7)" if bf16 else
                          f" (each within {CONV_TOL} * (1 + max|plain|))"))
    return worst


def time_split_conv(torch, F, asc, name, flush, shape, card, reps=20):
    """Kernel ``name``, its plain version and cuDNN's conv alone (on an
    activated input, in the form's dtype) at (B, C_in, C_out, L, k, d) ms,
    beside the bound: 3 x 2 B L C_in C_out k / the TF32 peak for the f32
    form (three TF32 products a multiply-add), 2 B L C_in C_out k / the
    bf16 peak for the bf16 form, or the bytes over HBM, the larger."""
    batch, c_in, c_out, length, k, d = shape
    bf16 = name in BF16_CONV
    args = split_conv_inputs(torch, batch, c_in, c_out, length, k, seed=99)
    w_t = args[5].permute(2, 1, 0).contiguous()
    h = torch.randn_like(args[0])
    b = args[6]
    if bf16:
        args = as_bf16(asc, args)
        h, w_t, b = h.bfloat16(), w_t.bfloat16(), b.bfloat16()
    fn = getattr(asc, BF16_CONV.get(name, name))
    pad = (k - 1) * d // 2
    calls = {
        "ms": lambda: fn(*args, k, d),
        "plain_ms": lambda: asc.adain_snake_conv_plain(*args, k, d),
        "library_ms": lambda: F.conv1d(h, w_t, b, padding=pad, dilation=d),
    }
    for call in calls.values():
        call()
    out = {key: cuda_ms(call, reps, flush) for key, call in calls.items()}
    width = 2 if bf16 else 4
    n_bytes = (batch * (c_in + c_out) * length * width + batch * length * 4
               + k * c_in * c_out * width)
    n_ops = 2 * batch * length * c_in * c_out * k
    out["bound_ms"], out["bound_by"] = (
        bound(n_bytes, n_ops, BF16_OPS_PER_S) if bf16
        else bound(n_bytes, 3 * n_ops, TF32_OPS_PER_S))
    out["shape"] = list(shape)
    log(f"{name} at B={batch}, C_in={c_in} -> C_out={c_out}, L={length}, "
        f"k={k}, d={d}: kernel {out['ms']:.4f} ms, plain "
        f"{out['plain_ms']:.4f} ms, cuDNN conv alone {out['library_ms']:.4f}"
        f" ms, bound {out['bound_ms']:.4f} ms ({out['bound_by']}, "
        f"{out['bound_ms'] / out['ms']:.0%} of it reached; {card})")
    return out


def recorded_split(fn, name, seen):
    """``fn`` (the f32 form ``name``'s wrapper) that also records each
    call's (B, C_in, C_out, L, k, d) in ``seen``, under the bf16 form's
    name for a bfloat16 x."""
    import torch

    bf16 = {plain: form for form, plain in BF16_CONV.items()}[name]

    def call(x, mask, scale, shift, alpha, w, b, kernel, dilation=1,
             extent=None):
        seen[bf16 if x.dtype == torch.bfloat16 else name].add((
            x.shape[0], x.shape[1], b.shape[0], x.shape[2], kernel,
            dilation))
        return fn(x, mask, scale, shift, alpha, w, b, kernel, dilation,
                  extent=extent)
    return call


def tp_phase(torch, np, F, synth, cfg, requests, layers, vocoder, asc, oa,
             flush, conv_per_generator, card, failures, reset_counts,
             check_wave, dev):
    """Phase 14: tensor parallelism on the 'model' axis, the shards of a
    group sharing the one card: 1 x 2 and 2 x 2 meshes over cuda:0. ->
    (summary dict, f32 launches by kernel, bf16 launches by kernel, the
    split-shape rows by kernel)."""
    import copy
    import dataclasses

    from illufly_tts_tpu_torch.audio.telephony import mulaw_decode_np
    from illufly_tts_tpu_torch.engine.synthesizer import Synthesizer
    from illufly_tts_tpu_torch.model.params import export_flax_params
    from illufly_tts_tpu_torch.ops import adain_moments as am
    from illufly_tts_tpu_torch.parallel.mesh import compute_copy, make_mesh
    from illufly_tts_tpu_torch.training import loop
    from illufly_tts_tpu_torch.training import step as tstep

    t_phase = time.perf_counter()
    out = {"card": card, "checks": {}}
    launches = {"istft_oa": 0, **{name: 0 for name in CONV_KERNELS},
                "adain_fold": 0}
    launches16 = {"istft_head_bf16": 0, **{n: 0 for n in BF16_CONV},
                  "adain_fold_bf16": 0}
    voice = "smoke_voice"

    def check(label, ok):
        out["checks"][label] = bool(ok)
        if not ok:
            failures.append(f"phase 14: {label}")
        return ok

    def counted(label, replicas, passes, bf16=False, fronts=None):
        """The launches since the last reset against ``passes`` Generator
        passes and ``fronts`` F0/N and trunk runs (one a pass where None)
        on each of ``replicas`` replicas: each fused conv step once per
        shard (both meshes' 'model' axes are 2-way), the AdaIN pass once a
        step on the whole x, the head once per pass; no launch of the other
        dtype's forms."""
        f32 = {"istft_oa": oa.launches, **asc.launches, **am.launches}
        b16 = {"istft_head_bf16": oa.launches_bf16, **asc.launches_bf16,
               **am.launches_bf16}
        got, other = (b16, f32) if bf16 else (f32, b16)
        shards = {name: 1 if "istft" in name or "adain_fold" in name else 2
                  for name in got}
        want = {name: replicas * shards[name] * kernel_launches(
                    name, conv_per_generator, passes, fronts)
                for name in got}
        log(f"phase 14: {label}: {replicas} replicas x {passes} Generator "
            f"passes, launches {got}")
        if not (got == want and not any(other.values())):
            log(f"phase 14: {label}: want {want} and none of {other}")
        check(f"{label}: exact launches",
              got == want and not any(other.values()))
        for name, n in got.items():
            (launches16 if bf16 else launches)[name] += n

    def rms_over_scale(a, b):
        a, b = a.astype(np.float64), b.astype(np.float64)
        return float(np.sqrt(np.mean((a - b) ** 2))) / (
            float(np.sqrt(np.mean(b ** 2))) + 1e-9)

    # -- the kernels at the split shapes
    t0 = time.perf_counter()
    inventory = sorted({(k, d) for k in (3, 7, 11) for d in (1, 3, 5)})
    shapes = [(8, c_in, c_out, length, k, d)
              for c_in, c_out, length in TP_CONV_SHAPES
              for k, d in inventory]
    log("phase 14: fused conv kernels vs plain at C_in -> C_in / 2 (B=8, "
        "the Generator's (k, d), odd rows masked after 2/3):")
    errors = {name: check_split_conv(torch, asc, name, shapes)
              for name in (*CONV_KERNELS, *BF16_CONV)}
    rows = {}
    for name in (*CONV_KERNELS, *BF16_CONV):
        d = 5 if "carry" in name else 1
        rows[name] = {"max_abs_err" if name in CONV_KERNELS
                      else "err_over_peak": errors[name],
                      "timed": [time_split_conv(
                          torch, F, asc, name, flush,
                          (8, c_in, c_out, length, 11, d), card)
                          for c_in, c_out, length in TP_CONV_SHAPES]}
    out["kernel_s"] = time.perf_counter() - t0

    # -- serving on 1 x 2 and 2 x 2 meshes over cuda:0
    torch.backends.cudnn.deterministic = True  # bitwise replays below
    tree = export_flax_params(synth.model)  # phase 4's weights
    mesh12 = make_mesh(1, 2, devices=[dev] * 2)
    mesh22 = make_mesh(2, 2, devices=[dev] * 4)
    single = Synthesizer(cfg, params=tree, device=dev)
    e12 = Synthesizer(cfg, params=tree, mesh=mesh12)
    e22 = Synthesizer(cfg, params=tree, mesh=mesh22)
    engines = {"1x2": (e12, 1), "2x2": (e22, 2)}
    for engine in (single, e12, e22):
        engine.register_random_voice(voice, seed=0)
    check("every replica's compute model is split in two",
          all(len(leaf.shards) == 2 for e in (e12, e22)
              for rep in e._replicas
              for leaf in rep.net.split_leaves.values())
          and len(e12.net.split_leaves) > 300)
    seen = {name: set() for name in (*CONV_KERNELS, *BF16_CONV)}
    for name in CONV_KERNELS:
        setattr(layers, name, recorded_split(getattr(asc, name), name, seen))
    served, eager = [], {}
    try:
        for req in ("zh_1", "mixed_4"):
            texts = requests[req]
            for fmt in FORMATS:
                whole = single.collect(single.dispatch(
                    texts, [voice] * len(texts), fmt=fmt))
                for label, (engine, n_rep) in engines.items():
                    reset_counts()
                    h = engine.dispatch(texts, [voice] * len(texts), fmt=fmt)
                    got = engine.collect(h)
                    counted(f"{req}/{fmt} on {label}", n_rep, 1)
                    per = 200 if fmt == "mulaw8k" else 600
                    for i, clip in enumerate(got):
                        check_wave(f"phase 14 {label} {req}/{fmt}[{i}]", clip,
                                   int(h.fitted_totals[i]) * per)
                    sizes = [a.size for a in got] == [a.size for a in whole]
                    if fmt.startswith("mulaw"):
                        rms = max(rms_over_scale(mulaw_decode_np(a),
                                                 mulaw_decode_np(b))
                                  for a, b in zip(got, whole))
                        codes = max(int(np.abs(a.astype(np.int16) - b).max())
                                    for a, b in zip(got, whole))
                        check(f"{label} {req}/{fmt}: lengths of the "
                              "one-device render", sizes)
                    else:
                        rms = max(rms_over_scale(a, b)
                                  for a, b in zip(got, whole))
                        codes = None
                        check(f"{label} {req}/{fmt}: within the golden gate "
                              "of the one-device render",
                              sizes and rms < CPU_GPU_TOL)
                    eager[label, req, fmt] = got
                    served.append({"mesh": label, "request": req, "fmt": fmt,
                                   "b_bucket": h.b_bucket,
                                   "f_bucket": h.f_bucket,
                                   "rms_over_scale": rms,
                                   "max_code_diff": codes})
                    log(f"phase 14: {req}/{fmt} on {label}: B bucket "
                        f"{h.b_bucket}, F {h.f_bucket}; vs the one-device "
                        f"render: rms/scale {rms:.3e} (limit {CPU_GPU_TOL} "
                        f"for pcm16/f32)" + (
                            f", codes at most {codes} apart"
                            if codes is not None else ""))
        out["serving"] = served

        # -- a windowed stream on 1 x 2, first use and replayed
        zh = requests["zh_1"]
        streams = {}
        for label in ("first use", "replayed"):
            reset_counts()
            h = e12.dispatch(zh, [voice], fmt="f32")
            chunks = list(e12.stream_decode(h, STREAM_WINDOW, STREAM_HALO,
                                            exact=False))
            # at first use the prepare's and the window's captures add
            # their warm passes
            counted(f"windowed stream ({label}) on 1x2", 1,
                    len(chunks) + (label == "first use"),
                    fronts=1 + (label == "first use"))
            streams[label] = chunks
        hs = single.dispatch(zh, [voice], fmt="f32")
        ref = list(single.stream_decode(hs, STREAM_WINDOW, STREAM_HALO,
                                        exact=False))
        first, again = streams["first use"], streams["replayed"]
        check("1x2 windowed stream replayed bitwise its first use",
              all(a.tobytes() == b.tobytes() for a, b in zip(first, again)))
        stream_rms = max(rms_over_scale(a, b) for a, b in zip(again, ref))
        check("1x2 windowed stream within the golden gate of the one-device "
              "stream", len(again) == len(ref) and stream_rms < CPU_GPU_TOL)
        out["stream"] = {"chunks": len(again), "rms_over_scale": stream_rms}
        log(f"phase 14: windowed stream of zh_1 on 1x2: {len(again)} chunks,"
            f" replayed bitwise its first use; vs the one-device stream "
            f"rms/scale {stream_rms:.3e}")

        # -- warmup, then a replay bitwise the eager render, on both meshes
        texts4 = requests["mixed_4"]
        h = e12.dispatch(texts4, [voice] * 4)
        e12.collect(h)
        key = (h.t_bucket, h.f_bucket)
        graphs = {}
        for label, (engine, n_rep) in engines.items():
            t0 = time.perf_counter()
            engine.warmup(batch_sizes=(4,), token_sizes=(key[0],),
                          frame_sizes=(key[1],), formats=("pcm16",))
            warm_s = time.perf_counter() - t0
            reset_counts()
            got = engine.collect(engine.dispatch(texts4, [voice] * 4))
            counted(f"mixed_4 replayed on {label}", n_rep, 1)
            rows_each = 4 // n_rep
            keys = [(rows_each, key[0]), (rows_each, *key, "pcm16")]
            check(f"{label}: each replica replays its graphs",
                  all(rep.graph_replays[k] == 1 for rep in engine._replicas
                      for k in keys))
            check(f"{label}: replay bitwise the eager render", all(
                a.tobytes() == b.tobytes() for a, b in zip(
                    got, eager[label, "mixed_4", "pcm16"])))
            memory = {str(k): memory_growth(engine._replicas[0]._graphs[k]
                                            .memory) for k in keys}
            pools = [pool_bytes(torch, rep._graph_pool)
                     for rep in engine._replicas]
            graphs[label] = {"warmup_s": warm_s, "pool_bytes": pools,
                             "capture_growth": memory}
            log(f"phase 14: warmup of mixed_4's key on {label} in "
                f"{warm_s:.2f} s, replays bitwise the eager render; pool "
                f"bytes per replica {pools}; capture growth {memory}")
        out["graphs"] = graphs

        # -- one bf16 request on 1 x 2
        e16 = Synthesizer(dataclasses.replace(cfg, dtype=torch.bfloat16),
                          params=tree, mesh=mesh12)
        e16.register_random_voice(voice, seed=0)
        reset_counts()
        h = e16.dispatch(zh, [voice], fmt="pcm16")
        got16 = e16.collect(h)
        counted("bf16 zh_1 on 1x2", 1, 1, bf16=True)
        for i, clip in enumerate(got16):
            check_wave(f"phase 14 bf16 1x2 zh_1[{i}]", clip,
                       int(h.fitted_totals[i]) * 600)
        del e16

        # -- B=8 wall, eager and replayed, 1 x 2 against one device
        b8 = requests["mixed_4"] * 2
        walls = {}
        order = [("one device", single), ("1x2", e12)]

        def timed(mode):
            for rep in range(TP_REPS):
                for label, engine in order if rep % 2 == 0 else order[::-1]:
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    engine.collect(engine.dispatch(b8, [voice] * 8))
                    walls.setdefault(f"{label} {mode}", []).append(
                        (time.perf_counter() - t0) * 1e3)

        hb = single.dispatch(b8, [voice] * 8)
        single.collect(hb)
        timed("eager")
        for engine in (single, e12):
            engine.warmup(batch_sizes=(8,), token_sizes=(hb.t_bucket,),
                          frame_sizes=(hb.f_bucket,), formats=("pcm16",))
        timed("replayed")
        out["b8_wall_ms"] = {k: statistics.median(v)
                             for k, v in walls.items()}
        out["b8_wall_ms_all"] = walls
        log(f"phase 14: B=8 pcm16 (mixed_4 twice), host wall ms, median of "
            f"{TP_REPS} in turns: {out['b8_wall_ms']} (deterministic cuDNN;"
            f" for information) [{card}]")
        engines.clear()
        del e22

        # -- training on 1 x 2: step 0 against one device, then bf16
        init = copy.deepcopy(synth.model)
        teacher = copy.deepcopy(init)
        gen = loop.synthetic_batches(init, teacher, TRAIN["batch"],
                                     TRAIN["tokens"], TRAIN["frames"], seed=0)
        data = next(gen)
        del teacher, gen

        def run(model, batch, **kw):
            seen_m = []
            master, _, _ = loop.train(
                model, steps=1, batch_size=batch.input_ids.shape[0],
                tokens=TRAIN["tokens"], frames=TRAIN["frames"], log_every=1,
                batches=iter([batch]),
                on_metrics=lambda s, m: seen_m.append(m),
                **kw)
            return master, seen_m[0]

        reset_counts()
        t0 = time.perf_counter()
        m_tp, tp_m = run(copy.deepcopy(init), data, mesh=mesh12)
        torch.cuda.synchronize()
        tp_step_s = time.perf_counter() - t0
        counted("train(mesh=1x2), step 0", 1, 1)
        reset_counts()
        m_one, one_m = run(copy.deepcopy(init), data)
        # the audio loss against the frozen teacher (the initial model,
        # rendered on one device) is ~0 at step 0: it is held relative to
        # the target's mean |amplitude|, the others to their own values
        scale = float(data.target_audio.abs().mean())
        rel = {key: abs(tp_m[key] - one_m[key]) / (
            scale if key == "audio_loss" else abs(one_m[key]))
            for key in ("loss", "dur_loss", "audio_loss")}
        check(f"step 0 losses: 1x2 vs one device within {TP_STEP0_TOL} "
              "relative", all(v <= TP_STEP0_TOL for v in rel.values()))
        lr = 1e-4
        diff, n_off, n_all = 0.0, 0, 0
        with torch.no_grad():
            for p, q, p0 in zip(m_tp.parameters(), m_one.parameters(),
                                init.parameters()):
                d = ((p - p0) - (q - p0)).abs() / lr
                diff = max(diff, float(d.max()))
                n_off += int((d > 1e-3).sum())
                n_all += d.numel()
        check("step 0 weights: 1x2 vs one device (phase 13's update check)",
              diff <= 2.002 and n_off <= 0.01 * n_all)
        del m_tp, m_one
        small = tstep.TrainBatch(*(t[:2] for t in data))
        reset_counts()
        m16 = compute_copy(init, torch.bfloat16, dev)
        master16, seen16 = run(m16, small, mesh=mesh12, master=init)
        counted("bf16 train(mesh=1x2), B=2", 1, 1, bf16=True)
        check("bf16 1x2 step: finite loss, float32 master",
              math.isfinite(seen16["loss"]) and all(
                  p.dtype == torch.float32 for p in master16.parameters()))
        out["training"] = {"step0_1x2": tp_m, "step0_one_device": one_m,
                           "step0_rel": rel, "update_max_diff_lr": diff,
                           "update_entries_off": n_off, "entries": n_all,
                           "step0_1x2_s": tp_step_s, "bf16_1x2": seen16}
        log(f"phase 14: train(mesh=1x2) at B={TRAIN['batch']}, tokens "
            f"{TRAIN['tokens']}, frames {TRAIN['frames']}: step 0 vs one "
            f"device, relative {rel} (limit {TP_STEP0_TOL}); updates differ "
            f"by at most {diff:.3f} lr, {n_off} of {n_all} entries by more "
            f"than 1e-3 lr; bf16 step on 1x2 loss {seen16['loss']:.5f} "
            f"({card})")
        del init, master16, m16, single, e12, order
    finally:
        unrecord(layers, vocoder, asc, oa)
        torch.backends.cudnn.deterministic = False
    torch.cuda.empty_cache()  # the phase's engines and their graph pools

    # -- the kernels against their plain versions at the shapes the
    # tensor-parallel engines and trainer gave them
    log("phase 14: kernels vs plain at the shapes the shards gave them:")
    for name, got in seen.items():
        err = check_split_conv(torch, asc, name, sorted(got))
        key = "max_abs_err" if name in CONV_KERNELS else "err_over_peak"
        rows[name][key] = max(rows[name][key], err)
        rows[name]["shapes_seen"] = len(got)
    check("the shards ran the fused kernels at C_out = C / 2",
          all(any(c_out * 2 == c_in for _, c_in, c_out, *_ in got)
              for got in seen.values()))
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"phase 14 in {out['phase_s']:.1f} s")
    return out, launches, launches16, rows


# phase 15: the graph pool. The largest key of ``warmup()``'s defaults
# (B 1 and 4, T 64 and 256, every frame bucket, pcm16), and a smaller
# request of them (B=1, T 64) besides long_8's first four texts (B=4, T
# 256, F 4096)
POOL_LARGEST = (4, 256, 4096, "pcm16")
# the pool of that inventory against the largest key's captured alone, and
# a first-use stream key's growth of a pool warmed at or above its (B, F)
POOL_OVER_LARGEST = 1.15
STREAM_KEY_GROWTH = 64 * 2 ** 20


def pool_phase(torch, np, cfg, requests, card, failures):
    """Phase 15: the graph pool's size, under deterministic cuDNN. (a) a
    fresh engine's ``warmup()`` with the JAX engine's default arguments:
    each capture's growth in capture order, the pool's bytes, the wall
    time, and two requests of warmed keys replayed bitwise equal to their
    eager renders before the warmup, with exact launches; (c) then two
    windowed streams' first use on that engine, at (4, 256, 4096) and at
    zh_1's (1, 32, 1024) (a replayed zh_1 stream bitwise its first use),
    with each stream key's growth; (b) ``POOL_LARGEST`` captured alone in
    a fresh engine, beside the same stage run eagerly and captured by hand
    from an emptied cache: the allocated peak, the reserved growth and the
    segments of each. ``scripts/graph_pool.py`` runs it alone, on this
    checkout's engine or on another checkout with that checkout's own
    ``chip_smoke.py``. -> summary."""
    from illufly_tts_tpu_torch.engine.synthesizer import (
        Synthesizer,
        stage_kind,
    )
    from illufly_tts_tpu_torch.ops import adain_moments as am
    from illufly_tts_tpu_torch.ops import adain_snake_conv as asc
    from illufly_tts_tpu_torch.ops import istft_oa as oa

    t_phase = time.perf_counter()
    out = {"card": card, "cudnn_deterministic": True}
    torch.backends.cudnn.deterministic = True
    net = cfg.istftnet
    conv_per_generator = len(net.upsample_rates) * (
        3 + sum(len(d) for d in net.resblock_dilation_sizes))
    mib = 2 ** 20

    def check(label, ok):
        if not ok:
            failures.append(f"phase 15: {label}")
        return ok

    def launches():
        return {"istft_oa": oa.launches, "istft_head_bf16": oa.launches_bf16,
                **asc.launches, **asc.launches_bf16, **am.launches,
                **am.launches_bf16}

    def growth(memory):
        if "before" not in memory:
            return None
        return {key: memory["after"][key] - memory["before"][key]
                for key in ("reserved_bytes", "allocated_bytes", "segments")}

    def pool_segments(pool):
        return sorted((seg["total_size"] for seg in torch.cuda.memory_snapshot()
                       if tuple(seg.get("segment_pool_id", ())) == tuple(pool)),
                      reverse=True)

    # -- (a) warmup() with the JAX engine's default arguments
    torch.cuda.empty_cache()
    synth = Synthesizer(cfg, seed=0)
    synth.register_random_voice("smoke_voice", seed=0)
    probes = {"b1": [MIXED], "b4": requests["long_8"][:4]}
    eager, keys = {}, {}
    for name, texts in probes.items():
        h = synth.dispatch(texts, ["smoke_voice"] * len(texts), fmt="pcm16")
        eager[name] = synth.collect(h)
        keys[name] = (h.b_bucket, h.t_bucket, h.f_bucket, "pcm16")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    synth.warmup()
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    n_a = sum(stage_kind(k) == "a" for k in synth._graphs)
    check(f"warmup(): {n_a} stage-A and {len(synth._graphs) - n_a} stage-B "
          "graphs, want 4 and 48", (n_a, len(synth._graphs)) == (4, 52))
    captures = [{"key": list(k), "capture_s": g.lock_s, "warm_pass_s": g.warm_s,
                 "growth": growth(g.memory)} for k, g in synth._graphs.items()]
    pool = pool_bytes(torch, synth._graph_pool)
    grew = [c for c in captures
            if c["growth"] and c["growth"]["reserved_bytes"]]
    out["default_warmup"] = {
        "seconds": warm_s, "pool_bytes": pool, "captures": captures,
        "capture_order": [c["key"] for c in captures],
        "reserved_bytes": torch.cuda.memory_reserved(),
        "recapture": getattr(synth, "last_recapture", None)}
    log(f"phase 15 (a): warmup() with the JAX defaults on a fresh engine: "
        f"{len(captures)} graphs in {warm_s:.2f} s, captured in the order "
        f"{[tuple(c['key']) for c in captures[:3]]} ...; pool "
        f"{(pool or 0) / mib:.0f} MiB, {len(grew)} captures grew it: "
        + "; ".join(f"{tuple(c['key'])} +{c['growth']['reserved_bytes'] / mib:.0f}"
                    f" MiB ({c['growth']['segments']} segments)" for c in grew)
        + f"; all reserved {torch.cuda.memory_reserved() / mib:.0f} MiB "
        f"({card})")
    out["launches"] = {}  # of the two replays, by kernel
    for name, texts in probes.items():
        reset = dict(synth.graph_replays)
        for table in (asc.launches, asc.launches_bf16, am.launches,
                      am.launches_bf16):
            for kernel in table:
                table[kernel] = 0
        oa.launches = oa.launches_bf16 = 0
        got = synth.collect(synth.dispatch(texts, ["smoke_voice"] * len(texts),
                                           fmt="pcm16"))
        want = {name_: 0 for name_ in launches()}
        want.update({name_: kernel_launches(name_, conv_per_generator, 1)
                     for name_ in ("istft_oa", "adain_snake_conv",
                                   "adain_snake_conv_carry", "adain_fold")})
        grown = {k: n - reset.get(k, 0)
                 for k, n in synth.graph_replays.items() if n != reset.get(k, 0)}
        out[f"replay_{name}"] = {
            "key": list(keys[name]), "replays": {str(k): n for k, n in grown.items()},
            "bitwise_equal": check(
                f"{name} {keys[name]}: the replay differs from its eager "
                "render", len(got) == len(eager[name]) and all(
                    a.tobytes() == b.tobytes() for a, b in zip(got, eager[name]))),
            "launches": launches()}
        check(f"{name}: launches {launches()}, want {want}", launches() == want)
        for kernel, n in launches().items():
            out["launches"][kernel] = out["launches"].get(kernel, 0) + n
        check(f"{name}: replays {grown}, want stage A and {keys[name]} once",
              grown.get(keys[name]) == 1 and grown.get(keys[name][:2]) == 1)
    log(f"phase 15 (a): {', '.join(f'{n} {keys[n]}' for n in probes)} "
        f"replayed bitwise equal to their eager renders: "
        f"{[out[f'replay_{n}']['bitwise_equal'] for n in probes]}, exact "
        f"launches")

    # -- (c) first-use windowed streams on the warmed engine
    out["stream_first_use"] = {}
    for name, texts in (("b4_f4096", requests["long_8"][:4]),
                        ("zh_1", requests["zh_1"])):
        h = synth.dispatch(texts, ["smoke_voice"] * len(texts), fmt="f32")

        def run(h=h):
            gen = synth.stream_decode(h, STREAM_WINDOW, STREAM_HALO,
                                      exact=False)
            chunks = list(gen) if len(texts) == 1 else [next(gen)]
            gen.close()
            return chunks

        chunks, use = first_use(synth, run, f"phase 15 (c) windowed {name}",
                                card)
        check(f"windowed {name}: chunks finite", all(
            np.isfinite(c).all() for c in chunks))
        use["growth"] = {key: growth(v) for key, v in use["keys"].items()}
        check(f"windowed {name}: a first-use key grew the pool past "
              f"{STREAM_KEY_GROWTH // mib} MiB: {use['growth']}", all(
                  g["reserved_bytes"] <= STREAM_KEY_GROWTH
                  for g in use["growth"].values() if g))
        use["bucket"] = [h.b_bucket, h.t_bucket, h.f_bucket]
        out["stream_first_use"][name] = use
        log(f"phase 15 (c): windowed {name} {tuple(use['bucket'])} at first "
            f"use after the warmup: " + "; ".join(
                f"{key} +{g['reserved_bytes'] / mib:.0f} MiB in "
                f"{g['segments']} segments" for key, g in use["growth"].items()
                if g) + f" ({card})")
        if len(texts) == 1:
            again = list(synth.stream_decode(synth.dispatch(
                texts, ["smoke_voice"], fmt="f32"), STREAM_WINDOW,
                STREAM_HALO, exact=False))
            check("windowed zh_1: the replayed stream differs from its first "
                  "use", len(again) == len(chunks) and all(
                      a.tobytes() == b.tobytes() for a, b in zip(again, chunks)))
    out["pool_bytes_after_streams"] = pool_bytes(torch, synth._graph_pool)
    del synth
    torch.cuda.empty_cache()

    # -- (b) the largest key alone; its stage eager and captured by hand
    engine = Synthesizer(cfg, seed=0)
    b, t, f, fmt = POOL_LARGEST
    ids, mask, ref, speed = engine._zero_inputs(b, t)
    with torch.inference_mode():
        d, pred_dur, _ = engine._stage_a(ids, mask, ref, speed)
    inputs = (ids, mask, d, pred_dur, ref, torch.ones((b,), device="cuda"))
    fn = engine._stage_fn(POOL_LARGEST)

    def measured(run):
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_stats()
        result = run()
        torch.cuda.synchronize()
        after = torch.cuda.memory_stats()
        row = {key: after[f"{key}.all.current"] - before[f"{key}.all.current"]
               for key in ("reserved_bytes", "allocated_bytes", "segment")}
        row["allocated_peak"] = (after["allocated_bytes.all.peak"]
                                 - before["allocated_bytes.all.current"])
        row["requested_peak"] = (
            after.get("requested_bytes.all.peak", 0)
            - before.get("requested_bytes.all.current", 0))
        row["inactive_split_bytes"] = after["inactive_split_bytes.all.current"]
        row["alloc_retries"] = after["num_alloc_retries"]
        return result, row

    with torch.inference_mode():
        fn(*inputs)  # builds, tables
        _, eager_row = measured(lambda: fn(*inputs))
        by_hand = torch.cuda.CUDAGraph()
        hand_pool = torch.cuda.graph_pool_handle()

        def capture():
            with torch.cuda.graph(by_hand, pool=hand_pool,
                                  capture_error_mode="thread_local"):
                return fn(*inputs)

        held, hand_row = measured(capture)
        hand_row["pool_segments"] = pool_segments(hand_pool)
        del held, by_hand
    torch.cuda.empty_cache()
    engine.compile_stage_b(b, t, f, fmt)
    alone = growth(engine._graphs[POOL_LARGEST].memory)
    alone["pool_bytes"] = pool_bytes(torch, engine._graph_pool)
    alone["pool_segments"] = pool_segments(engine._graph_pool)
    out["largest_alone"] = {"key": list(POOL_LARGEST), "engine": alone,
                            "eager": eager_row, "captured_by_hand": hand_row}
    log(f"phase 15 (b): {POOL_LARGEST} captured alone: +"
        f"{alone['reserved_bytes'] / mib:.0f} MiB in {alone['segments']} "
        f"segments (pool {(alone['pool_bytes'] or 0) / mib:.0f} MiB); its "
        f"stage eager from an emptied cache: allocated peak "
        f"{eager_row['allocated_peak'] / mib:.0f} MiB, reserved +"
        f"{eager_row['reserved_bytes'] / mib:.0f} MiB in "
        f"{eager_row['segment']} segments; captured by hand: allocated peak "
        f"{hand_row['allocated_peak'] / mib:.0f} MiB, reserved +"
        f"{hand_row['reserved_bytes'] / mib:.0f} MiB in "
        f"{hand_row['segment']} segments ({card})")
    log(f"phase 15 (b): segments MiB, engine pool "
        f"{[round(x / mib) for x in alone['pool_segments']]}; by hand "
        f"{[round(x / mib) for x in hand_row['pool_segments']]}; inactive "
        f"split MiB eager {eager_row['inactive_split_bytes'] / mib:.0f}, by "
        f"hand {hand_row['inactive_split_bytes'] / mib:.0f}")
    default = out["default_warmup"]["pool_bytes"] or 0
    out["default_over_largest"] = default / max(alone["reserved_bytes"], 1)
    check(f"the default inventory's pool is {out['default_over_largest']}x "
          f"the largest key's alone, want <= {POOL_OVER_LARGEST}",
          out["default_over_largest"] <= POOL_OVER_LARGEST)
    log(f"phase 15: the default inventory's pool is "
        f"{out['default_over_largest']:.3f}x the largest key's alone")
    del engine, fn, inputs
    torch.backends.cudnn.deterministic = False
    torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t_phase
    log(f"phase 15 in {out['seconds']:.1f} s ({card})")
    return out


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
        from illufly_tts_tpu_torch.ops import adain_moments as am
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
    info = cuda_build.build(["istft_oa", "adain_snake_conv",
                             "adain_moments"])
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
    adain = adain_phase(torch, am, flush, card)
    extent_failures = []
    extents = check_extents(torch, asc, am, flush, card, extent_failures)
    if extent_failures:
        fail("; ".join(extent_failures[:5]))

    # ---- 4. batch path ---------------------------------------------------------
    t0 = time.perf_counter()
    synth = Synthesizer(cfg, seed=0)
    synth.register_random_voice("smoke_voice", seed=0)
    log(f"Synthesizer(KokoroConfig(), seed=0) on {synth.device} in "
        f"{time.perf_counter() - t0:.1f} s")
    net = cfg.istftnet
    conv_per_generator = len(net.upsample_rates) * (
        3 + sum(len(d) for d in net.resblock_dilation_sizes))  # 24
    fronts = 2 * sum(isinstance(m, layers.AdainResBlk1d)
                     for m in synth.model.modules())
    if fronts != ADAIN_FRONT:
        fail(f"the model has {fronts} AdaIN1d's outside the Generator, "
             f"ADAIN_FRONT says {ADAIN_FRONT}")
    requests = REQUESTS
    failures = []
    conv_shapes, head_shapes = record_shapes(layers, vocoder, asc, oa)

    def voices(texts):
        return ["smoke_voice"] * len(texts)

    def reset_counts():
        oa.launches = oa.launches_bf16 = 0
        for table in (asc.launches, asc.launches_bf16, am.launches,
                      am.launches_bf16):
            for name in table:
                table[name] = 0

    def check_counts(label, generator_runs, skipped=0, fronts=None):
        """The f32 kernels' launches against ``generator_runs`` Generator
        passes, each ``skipped`` fused steps of each form short (the noise
        blocks of phase 10's gradient comparison), and ``fronts`` F0/N and
        trunk runs (one a pass where None; ``kernel_launches``)."""
        counts = {"istft_oa": oa.launches, **asc.launches, **am.launches}
        want = {name: kernel_launches(name, conv_per_generator,
                                      generator_runs, fronts, skipped)
                for name in counts}
        log(f"{label}: {generator_runs} Generator runs, launches {counts}")
        for name, n in counts.items():
            if n == 0 or n != want[name]:
                failures.append(f"{label}: {name} launched {n} times, "
                                f"want {want[name]}")
        if any(bf16_counts().values()):  # the f32 path runs no bf16 form
            failures.append(f"{label}: bf16 forms launched {bf16_counts()}")
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

    # the stream's first use captures its prepare and window graphs (the
    # window's warm pass is one more Generator pass); the timed stream
    # after it replays them
    reset_counts()
    (_, chunks, _, _), stream_first_use = first_use(
        synth, lambda: timed_stream(torch, synth, texts),
        "windowed stream (mixed_4)", card)
    check_counts("windowed stream, first use (captures)", len(chunks) + 1,
                 fronts=first_use_fronts(stream_first_use))
    reset_counts()
    h, chunks, first_ms, stream_ms = timed_stream(torch, synth, texts)
    windows = h.f_bucket // STREAM_WINDOW
    max_total = int(h.fitted_totals[: h.n].max())
    want_lens = [min(STREAM_WINDOW, max_total - lo) * 600
                 for lo in range(0, max_total, STREAM_WINDOW)]
    stream_counts = check_counts("windowed stream", len(chunks), fronts=1)
    if [c.shape for c in chunks] != [(h.n, n) for n in want_lens]:
        failures.append(f"windowed chunks {[c.shape for c in chunks]}, "
                        f"want {want_lens}")
    for i, c in enumerate(chunks):
        if not np.isfinite(c).all() or float(np.abs(c).max()) <= 1e-4:
            failures.append(f"windowed chunk {i}: non-finite or silent")
    log(f"windowed stream (mixed_4, window {STREAM_WINDOW} + halo "
        f"{STREAM_HALO} frames, F_bucket {h.f_bucket} = {windows} windows), "
        f"replayed: {len(chunks)} chunks, first after {first_ms:.1f} ms, all "
        f"after {stream_ms:.1f} ms; full render (pcm16, section 4) "
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

    # ---- 11. bf16 ---------------------------------------------------------------
    bf16, bf16_rows = bf16_phase(
        torch, np, F, synth, layers, vocoder, asc, oa, flush, card, failures,
        conv_per_generator, reset_counts, check_wave)

    # ---- 12. warmup as CUDA graphs ----------------------------------------------
    graphs, replayed, replayed_streams = graphs_phase(
        torch, np, synth, pipe, requests, oa, asc, conv_per_generator, card,
        failures, reset_counts, check_counts, check_wave)

    # ---- 13. data parallelism: replicas on the 'data' axis ------------------
    (mesh, mesh_launches, mesh_bf16, mesh_conv, mesh_head, mesh_conv16,
     mesh_head16) = mesh_phase(
        torch, np, synth, cfg, requests, layers, vocoder, asc, oa,
        conv_per_generator, card, failures, reset_counts, check_counts,
        check_wave, torch.device("cuda", 0))
    log("kernels vs plain at the shapes the replicas gave them:")
    for name in CONV_KERNELS:
        err = check_conv(torch, asc, name, [
            (*shape, False) for shape in sorted(mesh_conv[name])])
        conv[name]["max_abs_err"] = max(conv[name]["max_abs_err"], err)
    head_err = max(head_err, check_head(
        torch, oa, [(b, f, False) for b, f in sorted(mesh_head)]))
    for name, plain_name in BF16_CONV.items():
        worst, err, share = check_conv_bf16(
            torch, asc, name,
            [(*shape, False) for shape in sorted(mesh_conv16[plain_name])])
        row = bf16_rows[name]
        row["err_over_peak"] = max(row["err_over_peak"], worst)
        row["max_abs_err"] = max(row["max_abs_err"], err)
        row["bitwise_share"] = min(row["bitwise_share"], share)
    bf16_rows["istft_head_bf16"]["max_abs_err"] = max(
        bf16_rows["istft_head_bf16"]["max_abs_err"], check_head_bf16(
            torch, oa, [(b, f, False) for b, f in sorted(mesh_head16)]))

    # ---- 14. tensor parallelism: shards on the 'model' axis ---------------
    tp, tp_launches, tp_bf16, tp_rows = tp_phase(
        torch, np, F, synth, cfg, requests, layers, vocoder, asc, oa, flush,
        conv_per_generator, card, failures, reset_counts, check_wave,
        torch.device("cuda", 0))

    # ---- 15. the graph pool ---------------------------------------------------
    pool = pool_phase(torch, np, cfg, requests, card, failures)

    seen = sorted(ADAIN_SEEN)
    log(f"adain_fold vs plain at the {len(seen)} shapes the main path gave "
        "it in phases 4-5, 7, 8, 10, 11 and 13:")
    t0 = time.perf_counter()
    err, err_abs = check_adain(torch, am, seen)
    log(f"  in {time.perf_counter() - t0:.1f} s ({card})")
    for row in adain.values():
        row["err_over_peak"] = max(row["err_over_peak"], err)
        row["max_abs_err"] = max(row["max_abs_err"], err_abs)
        row["main_path_shapes_checked"] = len(seen)

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
    for name, bf16_form in (("adain_fold", False), ("adain_fold_bf16", True)):
        rows.append({
            "name": name,
            "route": "cuda",
            "source": "illufly_tts_tpu_torch/csrc/adain_moments.cu",
            "replaces": "illufly_tts_tpu/ops/pallas/fused_conv.py:157",
            "replaces_note": "no Pallas kernel: the XLA reduction the JAX "
                             "package runs outside its conv kernels "
                             "(instance_moments + fold_adain, fused_conv.py"
                             ":157-179) and in AdaIN1d (model/layers.py:"
                             "99-106)",
            "role": "every AdaIN of stage B" + (", bfloat16 model"
                                                if bf16_form else "")
                    + f": two a fused Generator step, {ADAIN_FRONT} in the "
                      "F0/N towers and the decoder trunk",
            **adain[name],
            **({"launches": bf16["bench"]["bf16/pcm16"]["launches"][name],
                "launches_stream": bf16["stream"]["launches"][name]}
               if bf16_form else {
                "launches": counts[name],
                "launches_stream": stream_counts[name],
                "stage_b_runs": stage_b_runs,
                "launches_serving": serving["launches"][name],
                "launches_per_text_request": serving["launches"][name]
                / len(TASKS),
                "launches_http": http["launches"][name],
                "launches_training": training["launches"][name],
                "backward_recompute": training["recompute"][name]}),
            "library_note": "torch.var_mean(x, dim=-1, correction=0): the "
                            "unmasked moments alone in one call, no mask, "
                            "no fold",
            "bound_note": "bytes: x, the mask, gamma and beta read once, "
                          "scale and shift written once, over 3.35e12 B/s",
            "card": card,
        })
    head16 = bf16_rows["istft_head_bf16"]
    rows.append({
        "name": "istft_head_bf16",
        "route": "cuda",
        "source": "illufly_tts_tpu_torch/csrc/istft_oa.cu",
        "replaces": "illufly_tts_tpu/ops/pallas/istft_oa.py:88",
        **head16,
        "library_ms": None,
        "library_note": "no single PyTorch call computes it (as the f32 "
                        "head); f32_form_ms: the f32 head on x.float()",
        "bitwise_equal_to_f32_head": True,
        "card": card,
    })
    for name, plain_name in BF16_CONV.items():
        rows.append({
            "name": name,
            "route": "cuda",
            "source": "illufly_tts_tpu_torch/csrc/adain_snake_conv.cu",
            "replaces": CONV_KERNELS[plain_name][0],
            "role": CONV_KERNELS[plain_name][1] + ", bfloat16 model",
            **bf16_rows[name],
            "library_note": "F.conv1d in bfloat16 (cuDNN) alone on an "
                            "already activated input, with the bias",
            "bound_note": "bf16 tensor cores (2 B L C^2 k / 989e12) or "
                          "bytes over HBM, the larger",
            "card": card,
        })
    for row in rows:
        row["launches_replayed"] = replayed[row["name"]]
        row["launches_stream_replayed"] = replayed_streams[row["name"]]
        # phase 13: serving, graphs, streams, HTTP and training on the
        # replicas (f32 forms); bf16 training (bf16 forms)
        row["launches_mesh"] = {**mesh_launches, **mesh_bf16}[row["name"]]
        # phase 14: serving, streams, graphs and training on 'model'
        # shards (f32 forms), a bf16 request and step (bf16 forms); the
        # convs' times at the split shapes C_in -> C_in / 2
        row["launches_tp"] = {**tp_launches, **tp_bf16}[row["name"]]
        # phase 15: the two replays of the default inventory's keys
        row["launches_pool"] = pool["launches"][row["name"]]
        split = tp_rows.get(row["name"])
        if split:
            row["split_shapes"] = split
            key = ("max_abs_err" if row["name"] in CONV_KERNELS
                   else "err_over_peak")
            row[key] = max(row[key], split[key])
    log(json.dumps({"kernels": rows}))
    log(json.dumps({"requests_wall_ms": timings,
                    "stream_first_chunk_ms": first_ms,
                    "stream_all_chunks_ms": stream_ms,
                    "stream_first_use": stream_first_use}))
    log(json.dumps({"serving": serving}))
    log(json.dumps({"http": http}))
    log(json.dumps({"weights": weights}))
    log(json.dumps({"training": training}))
    log(json.dumps({"bf16": bf16}))
    log(json.dumps({"graphs": graphs}))
    log(json.dumps({"mesh": mesh}))
    log(json.dumps({"tensor_parallel": tp}))
    log(json.dumps({"pool": pool}))
    log(json.dumps({"extents": extents}))
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
