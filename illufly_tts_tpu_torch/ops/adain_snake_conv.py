# -*- coding: utf-8 -*-
"""Fused AdaIN affine + Snake + mask + dilated conv of the Generator's
residual blocks: CUDA kernel wrappers + plain versions.

Replaces two TPU kernels that compute one function,
``conv1d(mask * snake(x * scale + shift), w) + b`` with centered zero
padding ``(k - 1) * d / 2`` and f32 accumulation:

- ``illufly_tts_tpu/ops/pallas/fused_conv.py::adain_snake_conv`` (a halo
  tile) -> ``adain_snake_conv``;
- ``illufly_tts_tpu/ops/pallas/carry_conv.py::adain_snake_conv_carry`` (a
  carry walked across the sequence) -> ``adain_snake_conv_carry``.

Both kernels live in ``csrc/adain_snake_conv.cu`` (whose header gives the
design and the mapping to the Pallas kernels): implicit GEMMs on the tensor
cores in 3xTF32 (each operand split as ``hi = tf32(v)``, ``lo = tf32(v -
hi)``; ``lo*hi + hi*lo + hi*hi`` summed in f32), bound by operations:
``3 * 2 * B * L * C_in * C_out * k`` TF32 FLOPs against a few bytes per
output. ``adain_snake_conv_3xtf32_plain`` emulates that split on any device
(the tests hold it against the f32 version). Layouts are the Pallas
kernels' own: x ``[B, C_in, L]`` (channels-first), mask ``[B, L]``,
scale/shift ``[B, C_in]``, alpha ``[C_in]``, w ``[k, C_in, C_out]``, b
``[C_out]``. ``column_tile`` picks each launch's column tile from its
shape.

bfloat16 (the Pallas kernels' bf16 form, ``fused_conv.py:59-87``): x,
w and the output are bfloat16; mask, scale, shift, alpha and b float32.
The activation runs in float32 and is rounded to bfloat16, the products of
the bfloat16 h and w sum in float32 with the bias, and the output is
rounded to bfloat16. A bfloat16 x on CUDA launches the kernels' bf16 forms
(one bf16 ``wgmma`` per tap and 16-channel stage, with the weights as the
GEMM's A and up to 256 columns as its B; counted as
``adain_snake_conv_bf16`` and ``adain_snake_conv_carry_bf16`` in
``launches_bf16``); they take w stage-packed (``pack_weights``: each
stage's weights for one 128-channel output tile one contiguous span in the
layout the tensor cores read, which the kernels' copy engine moves in bulk),
which the model makes once per weight. ``adain_snake_conv_plain`` computes
the same arithmetic on any device, with w as it comes or packed.

Row extents (``extent``, ``mask_extent(mask)``: one past each row's last
nonzero mask column) let the bf16 forms compute only the column tiles that
start before a row's extent plus the conv's reach ``(k - 1) * d / 2``,
spread over the launch's grid (about one wave of CTAs), and store the
bias, which is what the rest computes, for the others: the output is
bitwise the launch's without extents (``work_plan`` mirrors the split; the
source's notes give why). The float32 forms and the plain version take
extents and compute every column. ``columns_tally`` reads the bf16
kernels' count of column tiles computed against their grids' tiles
(``TIMERS``' snapshot).

Each wrapper launches its kernel for CUDA tensors (or raises) and counts the
launch in ``launches``; for CPU tensors it runs ``adain_snake_conv_plain``.
On CUDA the launch goes through ``ops/kernel_grad.py::kernel_call``: where
autograd records, the gradients of x, scale, shift, alpha, w and b come
from ``adain_snake_conv_plain`` recomputed in the backward (the mask gets
none).
``instance_moments`` and ``fold_adain`` give the folded AdaIN scale/shift
in plain tensor ops: the plain version of ``ops/adain_moments.py``'s
kernel, which computes them on CUDA.
"""
from __future__ import annotations

import ctypes
import threading
from functools import lru_cache
from typing import List, Optional, Tuple

import torch
import torch.nn.functional as F

from ..utils.profiling import TIMERS
from .capture_tally import tallied
from .kernel_grad import kernel_call

# kernel geometry; must equal the source's (checked at load)
TILE_LENS = (128, 64)  # output columns per CTA the kernels take
COUT_TILE = 128        # output channels per CTA
MAX_KERNEL = 11
MAX_PAD = 32
# a CTA's time by column tile, relative to the 128-column tile, on an H100
# at B=8, C=128, L=61440, k=11 (chip_smoke.py's ``tile_lens``; PERF.md):
# every stage streams the same weights whatever the tile, so short tiles
# cost more per column. One CTA runs per SM.
TILE_COST = {128: 1.0, 64: 0.66}
MAX_SMEM = 232448      # bytes of shared memory one CTA may take
# the bf16 forms' geometry; must equal the source's (checked at load)
TILE_LENS_BF16 = (256, 128, 64)  # output columns per CTA (wgmma n256/128/64)
CIN_STAGE = 16         # input channels per stage (one k16 step)
W_TAP_BYTES = 2 * COUT_TILE * 8 * 2  # a tap of a stage's packed weights
# a bf16 CTA's time by column tile, relative to the 256-column tile, one
# tile a CTA (chip_smoke.py's ``tile_lens_bf16``; PERF.md): a stage's
# weights cost the same whatever the tile, so short tiles cost more per
# column
TILE_COST_BF16 = {256: 1.0, 128: 0.70, 64: 0.58}

# kernel launches since the last reset, by kernel (plain-version calls do
# not count), bumped under a lock: the scheduler's worker threads launch
# concurrently
launches = {"adain_snake_conv": 0, "adain_snake_conv_carry": 0}
launches_bf16 = {"adain_snake_conv_bf16": 0, "adain_snake_conv_carry_bf16": 0}
_launches_lock = threading.Lock()


def count_launch(name: str, n: int = 1) -> None:
    """Add ``n`` launches of kernel ``name`` to ``launches`` (or, for a
    bf16 form, to ``launches_bf16``); while this thread captures a CUDA
    graph, to the capture's tally instead (``ops/capture_tally.py``)."""
    if tallied(name, n):
        return
    with _launches_lock:
        table = launches_bf16 if name in launches_bf16 else launches
        table[name] += n


def instance_moments(x: torch.Tensor, mask: torch.Tensor,
                     eps: float = 1e-5) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-(batch, channel) masked mean and 1/sqrt(var + eps) over time.
    x [B, C, L] (channels-first), mask [B, L] -> two [B, C]; float32 for a
    bfloat16 x."""
    x = _wide(x)
    m = mask[:, None, :].to(x.dtype)
    count = m.sum(dim=-1).clamp(min=1.0)
    mean = (x * m).sum(dim=-1) / count
    var = ((x - mean[:, :, None]) ** 2 * m).sum(dim=-1) / count
    return mean, torch.rsqrt(var + eps)


def fold_adain(mean, rstd, gamma, beta):
    """AdaIN (instance norm + style affine) as one scale/shift:
    ``(x - mean) * rstd * (1 + gamma) + beta == x * scale + shift``."""
    scale = (1.0 + gamma) * rstd
    return scale, beta - mean * scale


def _wide(t: torch.Tensor) -> torch.Tensor:
    """f32, or f64 for f64 inputs (the gradient checks run in f64)."""
    return t if t.dtype == torch.float64 else t.float()


def _activate(x, mask, scale, shift, alpha):
    """mask * snake(x * scale + shift), f32 [B, C, L]."""
    xn = _wide(x) * scale[:, :, None] + shift[:, :, None]
    a = _wide(alpha).reshape(1, -1, 1)
    h = xn + (1.0 / a) * torch.square(torch.sin(a * xn))
    return h * mask[:, None, :].to(h.dtype)


def _conv(h, w, kernel, dilation):
    pad = ((kernel - 1) * dilation) // 2
    return F.conv1d(h, w.permute(2, 1, 0), padding=pad, dilation=dilation)


def adain_snake_conv_plain(x, mask, scale, shift, alpha, w, b, kernel,
                           dilation=1, extent=None):
    """PyTorch ops equal to the JAX ``adain_snake_conv_reference``. For a
    bfloat16 x, its bf16 arithmetic: h (float32) and w rounded to
    bfloat16, their products (exact in float32) summed in float32 with the
    float32 bias, the output rounded to bfloat16. Every column is computed
    (``extent`` is taken as the kernels take it, and changes nothing)."""
    w = _held(w, x.shape[1], b.shape[0])
    h = _activate(x, mask, scale, shift, alpha)
    if x.dtype == torch.bfloat16:
        y = _conv(h.bfloat16().float(), w.bfloat16().float(), kernel,
                  dilation)
        return (y + b.float().reshape(1, -1, 1)).bfloat16()
    return _conv(h, _wide(w), kernel, dilation) + _wide(b).reshape(1, -1, 1)


def packed_shape(kernel: int, c_in: int, c_out: int) -> Tuple[int, ...]:
    """Shape of ``pack_weights``' output for w [k, C_in, C_out]."""
    return (-(-c_out // COUT_TILE), -(-c_in // CIN_STAGE), kernel, 2,
            COUT_TILE, 8)


def pack_weights(w: torch.Tensor) -> torch.Tensor:
    """w [k, C_in, C_out] as the bf16 kernels hold it: bfloat16
    ``[C_out / 128][C_in / 16][k][2][128][8]``, zero-padded past C_in and
    C_out. Element ``[o_tile, stage, t, half, row, j]`` is ``w[t, 16 stage +
    8 half + j, 128 o_tile + row]``: one stage's weights for one output
    tile are one contiguous span of k * 4 KB, each tap ``[2 halves][128
    rows][8 channels]``, the K-major 16-byte rows the tensor cores read."""
    kernel, c_in, c_out = w.shape
    tiles, stages = packed_shape(kernel, c_in, c_out)[:2]
    padded = w.new_zeros((kernel, stages * CIN_STAGE, tiles * COUT_TILE),
                         dtype=torch.bfloat16)
    padded[:, :c_in, :c_out] = w
    return padded.reshape(kernel, stages, 2, 8, tiles, COUT_TILE).permute(
        4, 1, 0, 2, 5, 3).contiguous()


def unpack_weights(packed: torch.Tensor, c_in: int,
                   c_out: int) -> torch.Tensor:
    """``pack_weights``' inverse: w [k, C_in, C_out] bfloat16."""
    tiles, stages, kernel = packed.shape[:3]
    return packed.permute(2, 1, 3, 5, 0, 4).reshape(
        kernel, stages * CIN_STAGE, tiles * COUT_TILE)[:, :c_in, :c_out]


def _held(w: torch.Tensor, c_in: int, c_out: int) -> torch.Tensor:
    """w [k, C_in, C_out] from w as it comes or stage-packed."""
    return unpack_weights(w, c_in, c_out) if w.dim() == 6 else w


def tf32_round(t: torch.Tensor) -> torch.Tensor:
    """f32 rounded to TF32 (10 mantissa bits) as ``cvt.rna.tf32.f32`` does:
    to nearest, ties away from zero, on the bits."""
    bits = t.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def adain_snake_conv_3xtf32_plain(x, mask, scale, shift, alpha, w, b, kernel,
                                  dilation=1, passes=3):
    """The kernels' arithmetic: h and w split as ``hi = tf32(v)``, ``lo =
    tf32(v - hi)``, and ``lo*hi + hi*lo + hi*hi`` summed in f32 (products
    of TF32 values are exact in f32). ``passes=1`` is plain TF32, ``hi*hi``
    alone."""
    h = _activate(x, mask, scale, shift, alpha)
    w = w.float()
    h_hi, w_hi = tf32_round(h), tf32_round(w)
    y = _conv(h_hi, w_hi, kernel, dilation)
    if passes == 3:
        h_lo, w_lo = tf32_round(h - h_hi), tf32_round(w - w_hi)
        y = (_conv(h_lo, w_hi, kernel, dilation)
             + _conv(h_hi, w_lo, kernel, dilation)) + y
    elif passes != 1:
        raise ValueError(f"passes={passes}: 1 (TF32) or 3 (3xTF32)")
    return y + b.float().reshape(1, -1, 1)


def smem_bytes(tile_len: int, kernel: int, carry_words: int,
               bf16: bool = False) -> int:
    """Dynamic shared memory of a launch in bytes (the source's
    ``smem_bytes`` and ``smem_bytes_bf16``): stage buffers, raw-input
    buffers and the carry, counted in 4-byte words. f32: two stages of B as
    hi and lo for k taps ([k][2][128][4] words each) and A as hi and lo
    ([2][tile_len + 2 MAX_PAD][4]), two raw buffers of x [8][200], mask
    [200], 3 x 8 parameters. bf16: 32 words of mbarriers, three stages of
    the weights [k][2][128][4] words and the window [2][rows][4] (16-byte
    rows of 8 channels; rows = tile_len + 2 MAX_PAD + 4), three raw buffers
    of x [16][tile_len + 2 MAX_PAD + 24] bfloat16, mask [tile_len + 2
    MAX_PAD + 8], 3 x 16 parameters."""
    if bf16:
        rows = tile_len + 2 * MAX_PAD + 4
        stage = kernel * W_TAP_BYTES // 4 + 8 * rows
        raw = (CIN_STAGE * (tile_len + 2 * MAX_PAD + 24) // 2
               + tile_len + 2 * MAX_PAD + 8 + 3 * CIN_STAGE)
        return 4 * (32 + 3 * stage + 3 * raw + carry_words)
    a_rows = 2 * (tile_len + 2 * MAX_PAD) * 4
    stage = 2 * kernel * 8 * COUT_TILE + 2 * a_rows
    return 4 * (2 * stage + 2 * (8 * 200 + 200 + 32) + carry_words)


def tiles_per_cta(batch: int, c_out: int, length: int, sms: int,
                  tile_len: int) -> int:
    """Consecutive column tiles one CTA takes: about one wave of CTAs, one
    per SM, so each pipeline fills and drains once per run of tiles."""
    rows = batch * -(-c_out // COUT_TILE)
    n_tiles = -(-length // tile_len)
    return -(-n_tiles // max(1, sms // rows))


def carry_tiles_per_chunk(batch: int, c_in: int, c_out: int, length: int,
                          kernel: int, dilation: int, sms: int,
                          tile_len: int, bf16: bool = False) -> int:
    """Tiles each carry CTA walks: ``tiles_per_cta`` where the carry buffer
    (2 pad columns of every input channel: hi and lo words in f32, one
    bfloat16 in bf16, channels in pairs) fits beside the stage buffers; one
    tile (no carry) where it does not. On an H100 walking measured 4-7%
    faster than one-tile chunks at k <= 7 in f32 (chip_smoke.py's
    ``chunks``; PERF.md); the bf16 form's smaller stages let it walk at
    every k <= 11, d <= 5."""
    pad2 = (kernel - 1) * dilation
    carry = (c_in + 1) // 2 * pad2 if bf16 else 2 * c_in * pad2
    if smem_bytes(tile_len, kernel, carry, bf16) > MAX_SMEM:
        return 1
    return tiles_per_cta(batch, c_out, length, sms, tile_len)


def column_tile(batch: int, c_out: int, length: int, sms: int,
                bf16: bool = False) -> int:
    """Output columns per CTA: the tile whose busiest SM finishes first,
    ``ceil(CTAs / sms) * TILE_COST`` (``TILE_COST_BF16`` for the bf16
    forms); among equals the longest. f32: large shapes take 128 columns; a
    B=1 stage-0 stream window (15 tiles of 128 at C=256) takes 64, which
    spreads over twice the SMs. bf16: large shapes take 256, the B=1 stream
    windows 128 (stage 1) and 64 (stage 0)."""
    lens, cost = ((TILE_LENS_BF16, TILE_COST_BF16) if bf16
                  else (TILE_LENS, TILE_COST))
    per_column = batch * -(-c_out // COUT_TILE)
    return min(lens, key=lambda tl: (
        -(-per_column * -(-length // tl) // sms) * cost[tl], -tl))


def mask_extent(mask: torch.Tensor) -> torch.Tensor:
    """Row extents of a mask [B, L]: one past the last nonzero column of each
    row, 0 for an all-zero row, L for one whose last column is nonzero ->
    int32 [B] on the mask's device (a few ops; nothing read on the host)."""
    cols = torch.arange(1, mask.shape[1] + 1, dtype=torch.int32,
                        device=mask.device)
    return torch.where(mask != 0, cols, 0).amax(dim=1)


def work_tiles(extent: int, length: int, tile_len: int, pad: int) -> int:
    """Column tiles of a row that the bf16 kernels compute: those starting
    before ``extent + pad``, clipped to the row; none for an empty row."""
    if extent <= 0:
        return 0
    return min(-(-length // tile_len), -(-(extent + pad) // tile_len))


def work_plan(extents, c_out: int, length: int, tile_len: int, pad: int,
              tiles: int) -> List[Tuple[List[Tuple[int, int, int]],
                                        List[Tuple[int, int, int]]]]:
    """The bf16 kernels' split with row extents, as the source's
    ``share_of`` makes it, for a grid of ``tiles`` tiles a CTA
    (``tiles_per_cta`` or ``carry_tiles_per_chunk``): each (row b,
    output-channel tile co) a segment, in that order. Where every row
    computes all its tiles, each CTA its run of ``tiles`` tiles of one
    segment, as without extents; else CTA i of the G takes list indices
    [i W / G, (i + 1) W / G) of the W computed (b, co, column tile)s and
    likewise of the bias tiles (each segment's tiles past its computed
    ones). -> per CTA in grid order (x fastest, then co, then b),
    (computed, bias) lists of (b, co, tile)."""
    co_tiles = -(-c_out // COUT_TILE)
    n_tiles = -(-length // tile_len)
    runs = -(-n_tiles // tiles)
    work, bias = [], []
    for b, e in enumerate(extents):
        n = work_tiles(int(e), length, tile_len, pad)
        for co in range(co_tiles):
            work += [(b, co, t) for t in range(n)]
            bias += [(b, co, t) for t in range(n, n_tiles)]
    if not bias:
        return [([(b, co, t) for t in range(x * tiles,
                                            min(n_tiles, (x + 1) * tiles))],
                 []) for b in range(len(extents)) for co in range(co_tiles)
                for x in range(runs)]
    ctas = len(extents) * co_tiles * runs

    def share(items, i):
        return items[i * len(items) // ctas:(i + 1) * len(items) // ctas]

    return [(share(work, i), share(bias, i)) for i in range(ctas)]


@lru_cache(maxsize=None)
def _library():
    from .cuda_build import load

    lib = load("adain_snake_conv")
    # x, mask, scale, shift, alpha, w, b, y, w_split; batch, C_in, C_out,
    # L, k, d, tile_len, tiles a CTA takes; the stream
    for fn in (lib.adain_snake_conv_f32, lib.adain_snake_conv_carry_f32):
        fn.argtypes = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 8
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    # the bf16 forms: the same without the split-weight scratch, w packed;
    # then the row extents (or null)
    for fn in (lib.adain_snake_conv_bf16, lib.adain_snake_conv_carry_bf16):
        fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 8
                       + [ctypes.c_void_p, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    lib.adain_snake_conv_tally.argtypes = [
        ctypes.POINTER(ctypes.c_ulonglong), ctypes.c_void_p]
    lib.adain_snake_conv_tally.restype = ctypes.c_int
    for fn in (lib.adain_snake_conv_smem_bytes,
               lib.adain_snake_conv_smem_bytes_bf16):
        fn.argtypes = [ctypes.c_int] * 3
        fn.restype = ctypes.c_int
    lib.adain_snake_conv_split_words.argtypes = [ctypes.c_int] * 3
    lib.adain_snake_conv_split_words.restype = ctypes.c_int64
    for fn in (lib.adain_snake_conv_geometry,
               lib.adain_snake_conv_geometry_bf16):
        fn.argtypes = [ctypes.POINTER(ctypes.c_int)]
        fn.restype = None
    geometry = (ctypes.c_int * 4)()
    lib.adain_snake_conv_geometry(geometry)
    bf16 = (ctypes.c_int * 3)()
    lib.adain_snake_conv_geometry_bf16(bf16)
    if (tuple(geometry) != (TILE_LENS[0], COUT_TILE, MAX_KERNEL, MAX_PAD)
            or tuple(bf16) != (TILE_LENS_BF16[0], CIN_STAGE, W_TAP_BYTES)):
        raise RuntimeError(f"adain_snake_conv: kernel geometry "
                           f"{tuple(geometry)}, {tuple(bf16)} differs from "
                           "the wrapper's")
    for case in ((128, 11, 0), (128, 7, 4608), (64, 3, 1280)):
        if lib.adain_snake_conv_smem_bytes(*case) != smem_bytes(*case):
            raise RuntimeError("adain_snake_conv: shared-memory sizes differ "
                               "from the wrapper's")
    for case in ((256, 11, 0), (256, 11, 6400), (128, 7, 3072), (64, 3, 256)):
        if (lib.adain_snake_conv_smem_bytes_bf16(*case)
                != smem_bytes(*case, bf16=True)):
            raise RuntimeError("adain_snake_conv: bf16 shared-memory sizes "
                               "differ from the wrapper's")
    return lib


# the cards a bf16 conv has launched on in this process (their tallies)
_TALLIED: set = set()


@lru_cache(maxsize=None)
def _tally_stream(index: int) -> torch.cuda.Stream:
    return torch.cuda.Stream(device=index)


def columns_tally() -> Optional[dict]:
    """The bf16 conv kernels' column tiles since their library loaded,
    summed over the cards they launched on in this process (the replicas
    of one engine across cards included): ``computed_tiles`` (what the MMAs
    ran over), ``grid_tiles`` (every launch's B x C_out tiles x its L /
    column tile) and their ratio, ``computed_share``, the share of the
    columns computed. None before the first bf16 launch (no CUDA touched).
    Reads each card's device counter on a stream of its own, kept for the
    next read, waiting for no other work."""
    if not _TALLIED:
        return None
    computed = grid = 0
    out = (ctypes.c_ulonglong * 2)()
    for index in sorted(_TALLIED):
        with torch.cuda.device(index):
            rc = _library().adain_snake_conv_tally(
                out, _tally_stream(index).cuda_stream)
        if rc != 0:
            raise RuntimeError(f"adain_snake_conv_tally: cudaError {rc}")
        computed, grid = computed + int(out[0]), grid + int(out[1])
    return {"computed_tiles": computed, "grid_tiles": grid,
            "computed_share": computed / grid if grid else None}


TIMERS.add_reader("bf16_conv_columns", columns_tally)


@lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _check(name, x, mask, scale, shift, alpha, w, b, kernel, dilation):
    """Validate shapes; -> True for CPU tensors (plain path). Raises for
    mixed devices, and on CUDA for what the kernel does not take."""
    if x.dim() != 3:
        raise ValueError(f"{name}: x must be [B, C_in, L], got "
                         f"{tuple(x.shape)}")
    batch, c_in, length = x.shape
    c_out = _c_out(w, b)
    if w.dim() == 6:
        if tuple(w.shape) != packed_shape(kernel, c_in, c_out):
            raise ValueError(f"{name}: packed w {tuple(w.shape)} != "
                             f"{packed_shape(kernel, c_in, c_out)}")
    elif w.dim() != 3 or w.shape[:2] != (kernel, c_in):
        raise ValueError(f"{name}: w {tuple(w.shape)} must be [k={kernel}, "
                         f"C_in={c_in}, C_out], or pack_weights' output")
    want = {"mask": (batch, length), "scale": (batch, c_in),
            "shift": (batch, c_in), "alpha": (c_in,), "b": (c_out,)}
    for key, t in zip(want, (mask, scale, shift, alpha, b)):
        if tuple(t.shape) != want[key]:
            raise ValueError(f"{name}: {key} {tuple(t.shape)} != "
                             f"{want[key]}")
    if ((kernel - 1) * dilation) % 2:
        raise ValueError(f"{name}: (k - 1) * d = {(kernel - 1) * dilation} "
                         "is odd; centered padding needs it even")
    tensors = (x, mask, scale, shift, alpha, w, b)
    if all(t.device.type == "cpu" for t in tensors):
        return True
    if not (x.is_cuda and all(t.device == x.device for t in tensors)):
        raise ValueError(f"{name}: all inputs must be on one CUDA device")
    if x.dtype == torch.bfloat16:
        _check_bf16(name, tensors)
    elif w.dim() == 6 or any(t.dtype != torch.float32 for t in tensors):
        raise TypeError(f"{name} kernel takes float32, or the bf16 form's "
                        "types (x and w bfloat16)")
    elif not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{name} kernel takes contiguous inputs")
    if kernel > MAX_KERNEL or (kernel - 1) * dilation // 2 > MAX_PAD:
        raise ValueError(f"{name} kernel: k={kernel}, d={dilation}; it "
                         f"takes k <= {MAX_KERNEL} and pad <= {MAX_PAD}")
    if batch == 0 or length == 0 or batch > 65535:
        raise ValueError(f"{name} kernel: batch {batch}, length {length}")
    return False


def _c_out(w, b):
    """Output channels: w's last dimension, or b's for packed weights."""
    return b.shape[0] if w.dim() == 6 else w.shape[2]


def _check_bf16(name, tensors):
    """What the bf16 forms take: x and w bfloat16, the rest float32; w
    stage-packed (``pack_weights``); x, w and the mask 16-byte aligned (the
    kernels copy them in 16-byte chunks)."""
    x, mask, scale, shift, alpha, w, b = tensors
    if w.dtype != torch.bfloat16 or any(
            t.dtype != torch.float32 for t in (mask, scale, shift, alpha, b)):
        raise TypeError(f"{name} bf16 kernel takes x and w in bfloat16 and "
                        "mask, scale, shift, alpha and b in float32")
    if w.dim() != 6:
        raise ValueError(f"{name} bf16 kernel takes w as pack_weights(w)")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{name} bf16 kernel takes contiguous inputs")
    if x.data_ptr() % 16 or w.data_ptr() % 16 or mask.data_ptr() % 16:
        raise ValueError(f"{name} bf16 kernel takes x, w and the mask "
                         "16-byte aligned")


def _launch(fn, x, mask, scale, shift, alpha, w, b, kernel, dilation,
            *extra, extent=None):
    """``extra``: the column tile and the tiles a CTA takes; a bf16 form
    also gets ``extent`` (int32 [B] on x's device, or None)."""
    batch, c_in, length = x.shape
    c_out = _c_out(w, b)
    y = torch.empty((batch, c_out, length), dtype=x.dtype, device=x.device)
    scratch, plan = [], ()
    if x.dtype != torch.bfloat16:
        # the weights split as hi and lo, which the launch fills for its
        # kernel (the bf16 forms read w as it is held)
        scratch.append(torch.empty(
            _library().adain_snake_conv_split_words(c_in, c_out, kernel),
            dtype=torch.int32, device=x.device))
    else:
        plan = (0 if extent is None else extent.data_ptr(),)
        _TALLIED.add(x.device.index)
    # the C side launches on the runtime's current device and sets each
    # kernel's shared-memory limit there: make it x's
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = fn(x.data_ptr(), mask.data_ptr(), scale.data_ptr(),
                shift.data_ptr(), alpha.data_ptr(), w.data_ptr(),
                b.data_ptr(), y.data_ptr(),
                *(t.data_ptr() for t in scratch), batch, c_in, c_out,
                length, kernel, dilation, *extra, *plan, stream)
    if rc != 0:
        raise RuntimeError(f"{fn.__name__} launch failed: cudaError {rc}")
    return y


def _call(name, fn, x, mask, scale, shift, alpha, w, b, kernel, dilation,
          *extra, extent=None):
    """Launch ``fn`` and count it as ``name``; where autograd records, the
    backward differentiates the plain version (``kernel_call``). The mask
    and the row extents stay outside the Function's inputs: they get no
    gradient."""
    def launch(x, scale, shift, alpha, w, b):
        y = _launch(fn, x, mask, scale, shift, alpha, w, b, kernel, dilation,
                    *extra, extent=extent)
        count_launch(name)
        return y

    def plain(x, scale, shift, alpha, w, b):
        return adain_snake_conv_plain(x, mask, scale, shift, alpha, w, b,
                                      kernel, dilation)

    return kernel_call(launch, plain, x, scale, shift, alpha, w, b)


def check_extent(name, x, extent):
    """``extent`` as a kernel takes it: None, or int32 [B] on x's device;
    raises for anything else."""
    batch = x.shape[0]
    if extent is not None and (
            tuple(extent.shape) != (batch,) or extent.dtype != torch.int32
            or extent.device != x.device or not extent.is_contiguous()):
        raise ValueError(f"{name}: extent must be the mask's row extents, "
                         f"int32 [{batch}] on {x.device}; got {extent.dtype} "
                         f"{tuple(extent.shape)} on {extent.device}")
    return extent


def adain_snake_conv(x, mask, scale, shift, alpha, w, b, kernel,
                     dilation=1, extent=None):
    """Halo-tile kernel: mask(snake(x*scale+shift)) conv w + b ->
    [B, C_out, L] in x's dtype (f32, or the bf16 form for bfloat16 x).
    ``extent``: the mask's row extents (``mask_extent``), with which the
    bf16 form computes only each row's columns the mask reaches; the
    output is the same."""
    check_extent("adain_snake_conv", x, extent)
    if _check("adain_snake_conv", x, mask, scale, shift, alpha, w, b,
              kernel, dilation):
        return adain_snake_conv_plain(x, mask, scale, shift, alpha, w, b,
                                      kernel, dilation)
    batch, _, length = x.shape
    c_out = _c_out(w, b)
    sms = _sm_count(x.device.index or 0)
    bf16 = x.dtype == torch.bfloat16
    tile_len = column_tile(batch, c_out, length, sms, bf16)
    name, fn = "adain_snake_conv", _library().adain_snake_conv_f32
    if bf16:  # the float32 form computes every column
        name, fn = "adain_snake_conv_bf16", _library().adain_snake_conv_bf16
    return _call(name, fn, x, mask, scale, shift, alpha, w, b, kernel,
                 dilation, tile_len,
                 tiles_per_cta(batch, c_out, length, sms, tile_len),
                 extent=extent if bf16 else None)


def adain_snake_conv_carry(x, mask, scale, shift, alpha, w, b, kernel,
                           dilation=1, extent=None):
    """Walking-carry kernel: the same function as ``adain_snake_conv``,
    each input column loaded and activated once per chunk of
    ``carry_tiles_per_chunk`` tiles (with ``extent``, once per run of a
    row's tiles in a CTA's share, where that walks)."""
    check_extent("adain_snake_conv_carry", x, extent)
    if _check("adain_snake_conv_carry", x, mask, scale, shift, alpha, w, b,
              kernel, dilation):
        return adain_snake_conv_plain(x, mask, scale, shift, alpha, w, b,
                                      kernel, dilation)
    batch, c_in, length = x.shape
    c_out = _c_out(w, b)
    sms = _sm_count(x.device.index or 0)
    bf16 = x.dtype == torch.bfloat16
    tile_len = column_tile(batch, c_out, length, sms, bf16)
    per_chunk = carry_tiles_per_chunk(batch, c_in, c_out, length, kernel,
                                      dilation, sms, tile_len, bf16)
    name, fn = ("adain_snake_conv_carry",
                _library().adain_snake_conv_carry_f32)
    if bf16:  # the float32 form computes every column
        name, fn = ("adain_snake_conv_carry_bf16",
                    _library().adain_snake_conv_carry_bf16)
    return _call(name, fn, x, mask, scale, shift, alpha, w, b, kernel,
                 dilation, tile_len, per_chunk,
                 extent=extent if bf16 else None)
