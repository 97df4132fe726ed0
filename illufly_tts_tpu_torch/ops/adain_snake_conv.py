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
(one bf16 ``wgmma`` per tap and 16-channel stage, counted as
``adain_snake_conv_bf16`` and ``adain_snake_conv_carry_bf16`` in
``launches_bf16``); they read w as a K-major view (``kmajor``), which the
model makes once per weight. ``adain_snake_conv_plain`` computes the same
arithmetic on any device.

Each wrapper launches its kernel for CUDA tensors (or raises) and counts the
launch in ``launches``; for CPU tensors it runs ``adain_snake_conv_plain``.
On CUDA the launch goes through ``ops/kernel_grad.py::kernel_call``: where
autograd records, the gradients of x, scale, shift, alpha, w and b come
from ``adain_snake_conv_plain`` recomputed in the backward (the mask gets
none).
``instance_moments`` and ``fold_adain`` give the folded AdaIN scale/shift;
like the JAX package, they stay plain tensor ops.
"""
from __future__ import annotations

import ctypes
import threading
from functools import lru_cache
from typing import Tuple

import torch
import torch.nn.functional as F

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

# kernel launches since the last reset, by kernel (plain-version calls do
# not count), bumped under a lock: the scheduler's worker threads launch
# concurrently
launches = {"adain_snake_conv": 0, "adain_snake_conv_carry": 0}
launches_bf16 = {"adain_snake_conv_bf16": 0, "adain_snake_conv_carry_bf16": 0}
_launches_lock = threading.Lock()


def count_launch(name: str) -> None:
    """Add one launch of kernel ``name`` to ``launches`` (or, for a bf16
    form, to ``launches_bf16``)."""
    with _launches_lock:
        table = launches_bf16 if name in launches_bf16 else launches
        table[name] += 1


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
                           dilation=1):
    """PyTorch ops equal to the JAX ``adain_snake_conv_reference``. For a
    bfloat16 x, its bf16 arithmetic: h (float32) and w rounded to
    bfloat16, their products (exact in float32) summed in float32 with the
    float32 bias, the output rounded to bfloat16."""
    h = _activate(x, mask, scale, shift, alpha)
    if x.dtype == torch.bfloat16:
        y = _conv(h.bfloat16().float(), w.bfloat16().float(), kernel,
                  dilation)
        return (y + b.float().reshape(1, -1, 1)).bfloat16()
    return _conv(h, _wide(w), kernel, dilation) + _wide(b).reshape(1, -1, 1)


def kmajor(w: torch.Tensor) -> torch.Tensor:
    """w [k, C_in, C_out] in bfloat16 as a view of a contiguous
    [k, C_out, C_in] tensor: each output channel's input channels
    contiguous, the K-major rows the bf16 kernels copy to their stages."""
    return w.bfloat16().transpose(1, 2).contiguous().transpose(1, 2)


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
    [200], 3 x 8 parameters. bf16: three stages of B [k][2][128][4] words
    and A [2][tile_len + 2 MAX_PAD][4] (16-byte rows of 8 channels), four
    raw buffers of x [16][200] bfloat16, mask [200], 3 x 16 parameters."""
    a_rows = 2 * (tile_len + 2 * MAX_PAD) * 4
    if bf16:
        stage = kernel * 8 * COUT_TILE + a_rows
        return 4 * (3 * stage + 4 * (16 * 100 + 200 + 48) + carry_words)
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
    bfloat16 in bf16) fits beside the stage buffers; one tile (no carry)
    where it does not. On an H100 walking measured 4-7% faster than
    one-tile chunks at k <= 7 in f32 (chip_smoke.py's ``chunks``;
    PERF.md); the bf16 form's smaller stages let it walk at k = 11 too."""
    pad2 = (kernel - 1) * dilation
    carry = c_in * pad2 // 2 if bf16 else 2 * c_in * pad2
    if smem_bytes(tile_len, kernel, carry, bf16) > MAX_SMEM:
        return 1
    return tiles_per_cta(batch, c_out, length, sms, tile_len)


def column_tile(batch: int, c_out: int, length: int, sms: int) -> int:
    """Output columns per CTA: the tile whose busiest SM finishes first,
    ``ceil(CTAs / sms) * TILE_COST``; among equals the longest. Large
    shapes take 128 columns; a B=1 stage-0 stream window (15 tiles of 128
    at C=256) takes 64, which spreads over twice the SMs."""
    per_column = batch * -(-c_out // COUT_TILE)
    return min(TILE_LENS, key=lambda tl: (
        -(-per_column * -(-length // tl) // sms) * TILE_COST[tl], -tl))


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
    # the bf16 forms: the same without the split-weight scratch
    for fn in (lib.adain_snake_conv_bf16, lib.adain_snake_conv_carry_bf16):
        fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 8
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    for fn in (lib.adain_snake_conv_smem_bytes,
               lib.adain_snake_conv_smem_bytes_bf16):
        fn.argtypes = [ctypes.c_int] * 3
        fn.restype = ctypes.c_int
    lib.adain_snake_conv_split_words.argtypes = [ctypes.c_int] * 3
    lib.adain_snake_conv_split_words.restype = ctypes.c_int64
    lib.adain_snake_conv_geometry.argtypes = [ctypes.POINTER(ctypes.c_int)]
    lib.adain_snake_conv_geometry.restype = None
    geometry = (ctypes.c_int * 4)()
    lib.adain_snake_conv_geometry(geometry)
    if tuple(geometry) != (TILE_LENS[0], COUT_TILE, MAX_KERNEL, MAX_PAD):
        raise RuntimeError(f"adain_snake_conv: kernel geometry "
                           f"{tuple(geometry)} differs from the wrapper's")
    for case in ((128, 11, 0), (128, 7, 4608), (64, 3, 1280)):
        if (lib.adain_snake_conv_smem_bytes(*case) != smem_bytes(*case)
                or lib.adain_snake_conv_smem_bytes_bf16(*case)
                != smem_bytes(*case, bf16=True)):
            raise RuntimeError("adain_snake_conv: shared-memory sizes differ "
                               "from the wrapper's")
    return lib


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
    if w.dim() != 3 or w.shape[:2] != (kernel, c_in):
        raise ValueError(f"{name}: w {tuple(w.shape)} must be [k={kernel}, "
                         f"C_in={c_in}, C_out]")
    c_out = w.shape[2]
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
    elif any(t.dtype != torch.float32 for t in tensors):
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


def _check_bf16(name, tensors):
    """What the bf16 forms take: x and w bfloat16, the rest float32; w a
    K-major view (``kmajor``) 16-byte aligned; C_in a multiple of 8."""
    x, mask, scale, shift, alpha, w, b = tensors
    if w.dtype != torch.bfloat16 or any(
            t.dtype != torch.float32 for t in (mask, scale, shift, alpha, b)):
        raise TypeError(f"{name} bf16 kernel takes x and w in bfloat16 and "
                        "mask, scale, shift, alpha and b in float32")
    if not (all(t.is_contiguous() for t in tensors if t is not w)
            and w.transpose(1, 2).is_contiguous()):
        raise ValueError(f"{name} bf16 kernel takes contiguous inputs and w "
                         "as kmajor(w)")
    if x.shape[1] % 8 or x.data_ptr() % 4 or w.data_ptr() % 16:
        raise ValueError(f"{name} bf16 kernel takes C_in a multiple of 8 "
                         f"(got {x.shape[1]}), x 4-byte and w 16-byte "
                         "aligned")


def _launch(fn, x, mask, scale, shift, alpha, w, b, kernel, dilation,
            *extra):
    batch, c_in, length = x.shape
    c_out = w.shape[2]
    y = torch.empty((batch, c_out, length), dtype=x.dtype, device=x.device)
    scratch = []
    if x.dtype != torch.bfloat16:
        # the weights split as hi and lo, which the launch fills for its
        # kernel (the bf16 forms read w as it is held)
        scratch.append(torch.empty(
            _library().adain_snake_conv_split_words(c_in, c_out, kernel),
            dtype=torch.int32, device=x.device))
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = fn(x.data_ptr(), mask.data_ptr(), scale.data_ptr(),
            shift.data_ptr(), alpha.data_ptr(), w.data_ptr(), b.data_ptr(),
            y.data_ptr(), *(t.data_ptr() for t in scratch), batch, c_in,
            c_out, length, kernel, dilation, *extra, stream)
    if rc != 0:
        raise RuntimeError(f"{fn.__name__} launch failed: cudaError {rc}")
    return y


def _call(name, fn, x, mask, scale, shift, alpha, w, b, kernel, dilation,
          *extra):
    """Launch ``fn`` and count it as ``name``; where autograd records, the
    backward differentiates the plain version (``kernel_call``). The mask
    stays outside the Function's inputs: it gets no gradient."""
    def launch(x, scale, shift, alpha, w, b):
        y = _launch(fn, x, mask, scale, shift, alpha, w, b, kernel, dilation,
                    *extra)
        count_launch(name)
        return y

    def plain(x, scale, shift, alpha, w, b):
        return adain_snake_conv_plain(x, mask, scale, shift, alpha, w, b,
                                      kernel, dilation)

    return kernel_call(launch, plain, x, scale, shift, alpha, w, b)


def adain_snake_conv(x, mask, scale, shift, alpha, w, b, kernel,
                     dilation=1):
    """Halo-tile kernel: mask(snake(x*scale+shift)) conv w + b ->
    [B, C_out, L] in x's dtype (f32, or the bf16 form for bfloat16 x)."""
    if _check("adain_snake_conv", x, mask, scale, shift, alpha, w, b,
              kernel, dilation):
        return adain_snake_conv_plain(x, mask, scale, shift, alpha, w, b,
                                      kernel, dilation)
    batch, _, length = x.shape
    sms = _sm_count(x.device.index or 0)
    tile_len = column_tile(batch, w.shape[2], length, sms)
    name, fn = "adain_snake_conv", _library().adain_snake_conv_f32
    if x.dtype == torch.bfloat16:
        name, fn = "adain_snake_conv_bf16", _library().adain_snake_conv_bf16
    return _call(name, fn, x, mask, scale, shift, alpha, w, b, kernel,
                 dilation, tile_len,
                 tiles_per_cta(batch, w.shape[2], length, sms, tile_len))


def adain_snake_conv_carry(x, mask, scale, shift, alpha, w, b, kernel,
                           dilation=1):
    """Walking-carry kernel: the same function as ``adain_snake_conv``,
    each input column loaded and activated once per chunk of
    ``carry_tiles_per_chunk`` tiles."""
    if _check("adain_snake_conv_carry", x, mask, scale, shift, alpha, w, b,
              kernel, dilation):
        return adain_snake_conv_plain(x, mask, scale, shift, alpha, w, b,
                                      kernel, dilation)
    batch, c_in, length = x.shape
    sms = _sm_count(x.device.index or 0)
    tile_len = column_tile(batch, w.shape[2], length, sms)
    bf16 = x.dtype == torch.bfloat16
    per_chunk = carry_tiles_per_chunk(batch, c_in, w.shape[2], length,
                                      kernel, dilation, sms, tile_len, bf16)
    name, fn = ("adain_snake_conv_carry",
                _library().adain_snake_conv_carry_f32)
    if bf16:
        name, fn = ("adain_snake_conv_carry_bf16",
                    _library().adain_snake_conv_carry_bf16)
    return _call(name, fn, x, mask, scale, shift, alpha, w, b, kernel,
                 dilation, tile_len, per_chunk)
