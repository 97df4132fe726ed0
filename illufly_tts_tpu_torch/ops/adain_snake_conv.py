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
design and the mapping to the Pallas kernels). They are bound by operations:
``2 * B * L * C_in * C_out * k`` f32 FLOPs against a few bytes per output.
Layouts are the Pallas kernels' own: x ``[B, C_in, L]`` (channels-first),
mask ``[B, L]``, scale/shift ``[B, C_in]``, alpha ``[C_in]``, w ``[k, C_in,
C_out]``, b ``[C_out]``.

Each wrapper launches its kernel for CUDA tensors (or raises) and counts the
launch in ``launches``; for CPU tensors it runs ``adain_snake_conv_plain``.
``instance_moments`` and ``fold_adain`` give the folded AdaIN scale/shift;
like the JAX package, they stay plain tensor ops.
"""
from __future__ import annotations

import ctypes
from functools import lru_cache
from typing import Tuple

import torch
import torch.nn.functional as F

# kernel geometry; must equal the source's (checked at load)
TILE_LEN = 128     # output columns per tile
COUT_TILE = 64     # output channels per tile
MAX_KERNEL = 11
MAX_PAD = 32
# the carry kernel cuts each row into chunks until the grid holds this many
# CTAs per SM: many short waves, since its carry buffer leaves room for
# only 2 to 4 resident CTAs per SM and long chunks leave a long last wave
CARRY_CTAS_PER_SM = 16

# kernel launches since the last reset, by kernel (plain-version calls do
# not count)
launches = {"adain_snake_conv": 0, "adain_snake_conv_carry": 0}


def instance_moments(x: torch.Tensor, mask: torch.Tensor,
                     eps: float = 1e-5) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-(batch, channel) masked mean and 1/sqrt(var + eps) over time.
    x [B, C, L] (channels-first), mask [B, L] -> two [B, C]."""
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


def adain_snake_conv_plain(x, mask, scale, shift, alpha, w, b, kernel,
                           dilation=1):
    """PyTorch ops equal to the JAX ``adain_snake_conv_reference``."""
    xn = x.float() * scale[:, :, None] + shift[:, :, None]
    a = alpha.float().reshape(1, -1, 1)
    h = xn + (1.0 / a) * torch.square(torch.sin(a * xn))
    h = h * mask[:, None, :].float()
    pad = ((kernel - 1) * dilation) // 2
    y = F.conv1d(h, w.float().permute(2, 1, 0), padding=pad,
                 dilation=dilation)
    return y + b.float().reshape(1, -1, 1)


def carry_tiles_per_chunk(batch: int, c_out: int, length: int,
                          sms: int) -> int:
    """Tiles each carry CTA walks: rows are cut into about as few chunks
    as give ``CARRY_CTAS_PER_SM * sms`` CTAs (at least that many, where the
    rows have the tiles), and never below one tile a chunk."""
    n_tiles = -(-length // TILE_LEN)
    per_row = batch * -(-c_out // COUT_TILE)
    chunks = min(n_tiles, max(1, -(-CARRY_CTAS_PER_SM * sms // per_row)))
    return n_tiles // chunks


@lru_cache(maxsize=None)
def _library():
    from .cuda_build import load

    lib = load("adain_snake_conv")
    ptrs = [ctypes.c_void_p] * 8
    ints = [ctypes.c_int] * 6
    lib.adain_snake_conv_f32.argtypes = ptrs + ints + [ctypes.c_void_p]
    lib.adain_snake_conv_f32.restype = ctypes.c_int
    lib.adain_snake_conv_carry_f32.argtypes = (
        ptrs + ints + [ctypes.c_int, ctypes.c_void_p])
    lib.adain_snake_conv_carry_f32.restype = ctypes.c_int
    lib.adain_snake_conv_geometry.argtypes = [ctypes.POINTER(ctypes.c_int)]
    lib.adain_snake_conv_geometry.restype = None
    geometry = (ctypes.c_int * 4)()
    lib.adain_snake_conv_geometry(geometry)
    if tuple(geometry) != (TILE_LEN, COUT_TILE, MAX_KERNEL, MAX_PAD):
        raise RuntimeError(f"adain_snake_conv: kernel geometry "
                           f"{tuple(geometry)} differs from the wrapper's")
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
    if any(t.dtype != torch.float32 for t in tensors):
        raise TypeError(f"{name} kernel takes float32")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{name} kernel takes contiguous inputs")
    if kernel > MAX_KERNEL or (kernel - 1) * dilation // 2 > MAX_PAD:
        raise ValueError(f"{name} kernel: k={kernel}, d={dilation}; it "
                         f"takes k <= {MAX_KERNEL} and pad <= {MAX_PAD}")
    if batch == 0 or length == 0 or batch > 65535:
        raise ValueError(f"{name} kernel: batch {batch}, length {length}")
    return False


def _launch(fn, x, mask, scale, shift, alpha, w, b, kernel, dilation,
            *extra):
    batch, c_in, length = x.shape
    c_out = w.shape[2]
    y = torch.empty((batch, c_out, length), dtype=torch.float32,
                    device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = fn(x.data_ptr(), mask.data_ptr(), scale.data_ptr(),
            shift.data_ptr(), alpha.data_ptr(), w.data_ptr(), b.data_ptr(),
            y.data_ptr(), batch, c_in, c_out, length, kernel, dilation,
            *extra, stream)
    if rc != 0:
        raise RuntimeError(f"{fn.__name__} launch failed: cudaError {rc}")
    return y


def adain_snake_conv(x, mask, scale, shift, alpha, w, b, kernel,
                     dilation=1):
    """Halo-tile kernel: mask(snake(x*scale+shift)) conv w + b ->
    [B, C_out, L] f32."""
    if _check("adain_snake_conv", x, mask, scale, shift, alpha, w, b,
              kernel, dilation):
        return adain_snake_conv_plain(x, mask, scale, shift, alpha, w, b,
                                      kernel, dilation)
    y = _launch(_library().adain_snake_conv_f32, x, mask, scale, shift,
                alpha, w, b, kernel, dilation)
    launches["adain_snake_conv"] += 1
    return y


def adain_snake_conv_carry(x, mask, scale, shift, alpha, w, b, kernel,
                           dilation=1):
    """Walking-carry kernel: the same function as ``adain_snake_conv``,
    each input column loaded and activated once per chunk."""
    if _check("adain_snake_conv_carry", x, mask, scale, shift, alpha, w, b,
              kernel, dilation):
        return adain_snake_conv_plain(x, mask, scale, shift, alpha, w, b,
                                      kernel, dilation)
    batch, _, length = x.shape
    per_chunk = carry_tiles_per_chunk(batch, w.shape[2], length,
                                      _sm_count(x.device.index or 0))
    y = _launch(_library().adain_snake_conv_carry_f32, x, mask, scale, shift,
                alpha, w, b, kernel, dilation, per_chunk)
    launches["adain_snake_conv_carry"] += 1
    return y

