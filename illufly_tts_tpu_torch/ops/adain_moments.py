# -*- coding: utf-8 -*-
"""The AdaIN statistics pass: masked instance moments and the AdaIN fold in
one CUDA kernel, with its plain versions.

Replaces the reduction the JAX package leaves to XLA outside its Pallas
conv kernels, ``illufly_tts_tpu/ops/pallas/fused_conv.py::instance_moments``
+ ``fold_adain``, which ``illufly_tts_tpu/model/layers.py::AdaIN1d`` also
computes. For x ``[B, C, L]`` (channels-first, float32 or bfloat16), a mask
``[B, L]`` or none (all ones), and gamma, beta ``[B, C]`` float32:

    count = max(sum m, 1), mean = sum x m / count,
    var = sum (x - mean)^2 m / count,
    scale = (1 + gamma) / sqrt(var + eps), shift = beta - mean * scale,

-> (scale, shift) ``[B, C]`` float32, so that the AdaIN of x is
``x * scale + shift``. With gamma and beta None the fold is left out: ->
(mean, 1 / sqrt(var + eps)), with which ``model/layers.py::AdaIN1d``
normalizes as the JAX layer does, ``(x - mean) * rstd``. A bfloat16 x is
widened to float32; all arithmetic is float32.

``adain_fold`` launches the kernel (``csrc/adain_moments.cu``) for CUDA
tensors, or raises for what it does not take, and counts the launch in
``launches`` (a bfloat16 x in ``launches_bf16``); for CPU tensors it runs
``adain_fold_plain``. The kernel splits each row into chunks of ``CHUNK``
elements, takes each chunk's (count, mean, M2) in two passes over
registers, and combines a row's chunks left to right by Chan's formula;
``adain_fold_chunked_plain`` computes that arithmetic on any device. Given
the mask's row extents (``extent``, ``adain_snake_conv.mask_extent``), a
chunk that starts at or past its row's extent is not read: its (count,
mean, M2) is (0, 0, 0), what reading it gives (``adain_fold_chunked_plain``
takes ``skip_past`` to do the same). On
CUDA the launch goes through ``ops/kernel_grad.py::kernel_call``: where
autograd records, the gradients of x, gamma and beta come from
``adain_fold_plain`` recomputed in the backward (the mask gets none). Both
forms are one launch of the same kernel pair and count alike.
"""
from __future__ import annotations

import ctypes
import threading
from functools import lru_cache
from typing import Optional, Tuple

import torch

from .adain_snake_conv import (_wide, check_extent, fold_adain,
                               instance_moments)
from .capture_tally import tallied
from .kernel_grad import kernel_call

# the kernel's geometry; must equal the source's (checked at load)
THREADS = 256
PER_THREAD = 16
CHUNK = THREADS * PER_THREAD  # elements of a row one block takes
EPS = 1e-5

# kernel launches since the last reset (plain-version calls do not count),
# bumped under a lock: the scheduler's worker threads launch concurrently
launches = {"adain_fold": 0}
launches_bf16 = {"adain_fold_bf16": 0}
_launches_lock = threading.Lock()


def count_launch(name: str, n: int = 1) -> None:
    """Add ``n`` launches of ``name`` (``adain_fold`` or ``adain_fold_bf16``)
    to its table; while this thread captures a CUDA graph, to the capture's
    tally instead (``ops/capture_tally.py``)."""
    if tallied(name, n):
        return
    with _launches_lock:
        (launches_bf16 if name in launches_bf16 else launches)[name] += n


def _ones_mask(x: torch.Tensor) -> torch.Tensor:
    return torch.ones(x.shape[0], x.shape[2], dtype=torch.float32,
                      device=x.device)


def adain_fold_plain(x: torch.Tensor, mask: Optional[torch.Tensor],
                     gamma: Optional[torch.Tensor],
                     beta: Optional[torch.Tensor], eps: float = EPS,
                     extent: Optional[torch.Tensor] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """PyTorch ops equal to the JAX ``fold_adain(*instance_moments(...))``
    in the channels-first layout (no mask: the mean and the variance over
    time, as JAX's unmasked branch); with gamma and beta None,
    ``instance_moments(...)`` alone. ``extent`` is taken as the kernel
    takes it and changes nothing."""
    if mask is None:
        xf = _wide(x)
        moments = (xf.mean(dim=-1), torch.rsqrt(
            xf.var(dim=-1, unbiased=False) + eps))
    else:
        moments = instance_moments(x, mask, eps)
    if gamma is None:
        return moments
    return fold_adain(*moments, _wide(gamma), _wide(beta))


def adain_fold_chunked_plain(x: torch.Tensor, mask: Optional[torch.Tensor],
                             gamma: Optional[torch.Tensor],
                             beta: Optional[torch.Tensor], eps: float = EPS,
                             chunk: int = CHUNK,
                             skip_past: Optional[torch.Tensor] = None
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's arithmetic: each row cut into ``chunk``-element chunks,
    each chunk's count, mean and centered M2 (two passes), the chunks
    combined left to right by Chan's formula, then the count clamp and the
    fold (none where gamma and beta are None). ``skip_past`` (row extents
    [B]): the chunks that start at or past their row's extent get (0, 0,
    0) in place of what they compute, as the kernel does with extents."""
    x = _wide(x)
    batch, channels, length = x.shape
    m = _ones_mask(x) if mask is None else mask
    m = m.to(x.dtype)[:, None, :].expand(batch, channels, length)
    pad = -length % chunk
    xs = torch.nn.functional.pad(x, (0, pad)).reshape(batch, channels, -1,
                                                      chunk)
    ms = torch.nn.functional.pad(m, (0, pad)).reshape(batch, channels, -1,
                                                      chunk)
    cn = ms.sum(dim=-1)
    safe = torch.where(cn > 0, cn, torch.ones_like(cn))
    cm = torch.where(cn > 0, (xs * ms).sum(dim=-1) / safe,
                     torch.zeros_like(cn))
    cq = ((xs - cm[..., None]) ** 2 * ms).sum(dim=-1)
    if skip_past is not None:
        starts = torch.arange(cn.shape[-1], device=x.device) * chunk
        past = (starts[None, :] >= skip_past.to(x.device)[:, None])[:, None]
        cn, cm, cq = (torch.where(past, torch.zeros_like(t), t)
                      for t in (cn, cm, cq))
    n = mean = m2 = torch.zeros_like(cn[..., 0])
    for k in range(cn.shape[-1]):
        total = n + cn[..., k]
        share = torch.where(total > 0,
                            cn[..., k] / torch.where(total > 0, total, 1.0),
                            torch.zeros_like(total))
        delta = cm[..., k] - mean
        mean = mean + delta * share
        m2 = m2 + cq[..., k] + delta * delta * n * share
        n = total
    whole = n >= 1
    mean_out = torch.where(whole, mean, n * mean)
    var = torch.where(whole, m2 / torch.where(whole, n, 1.0),
                      m2 + n * (mean - mean_out) ** 2)
    if gamma is None:
        return mean_out, torch.rsqrt(var + eps)
    return fold_adain(mean_out, torch.rsqrt(var + eps), _wide(gamma),
                      _wide(beta))


@lru_cache(maxsize=None)
def _library():
    from .cuda_build import load

    lib = load("adain_moments")
    ptr, num, wide = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    # x, mask, row extents, gamma, its row stride, beta, its row stride,
    # out, scratch; batch, C, L; eps; the stream
    for fn in (lib.adain_fold_f32, lib.adain_fold_bf16):
        fn.argtypes = [ptr, ptr, ptr, ptr, wide, ptr, wide, ptr, ptr, num,
                       num, num, ctypes.c_float, ptr]
        fn.restype = ctypes.c_int
    lib.adain_fold_part_floats.argtypes = [num] * 3
    lib.adain_fold_part_floats.restype = wide
    lib.adain_fold_geometry.argtypes = [ctypes.POINTER(ctypes.c_int)]
    lib.adain_fold_geometry.restype = None
    geometry = (ctypes.c_int * 2)()
    lib.adain_fold_geometry(geometry)
    if tuple(geometry) != (THREADS, PER_THREAD):
        raise RuntimeError(f"adain_moments: kernel geometry "
                           f"{tuple(geometry)} differs from the wrapper's")
    return lib


def _check(x, mask, gamma, beta, extent=None) -> bool:
    """Validate shapes; -> True for CPU tensors (plain path). Raises for
    mixed devices, and on CUDA for what the kernel does not take."""
    if x.dim() != 3:
        raise ValueError(f"adain_fold: x must be [B, C, L], got "
                         f"{tuple(x.shape)}")
    batch, channels, length = x.shape
    if (gamma is None) != (beta is None):
        raise ValueError("adain_fold: gamma and beta are both given or "
                         "both None")
    for key, t in (("gamma", gamma), ("beta", beta)):
        if t is not None and tuple(t.shape) != (batch, channels):
            raise ValueError(f"adain_fold: {key} {tuple(t.shape)} != "
                             f"{(batch, channels)}")
    if mask is not None and tuple(mask.shape) != (batch, length):
        raise ValueError(f"adain_fold: mask {tuple(mask.shape)} != "
                         f"{(batch, length)}")
    if check_extent("adain_fold", x, extent) is not None and mask is None:
        raise ValueError("adain_fold: extent without a mask")
    tensors = [t for t in (x, mask, gamma, beta) if t is not None]
    if all(t.device.type == "cpu" for t in tensors):
        return True
    if not (x.is_cuda and all(t.device == x.device for t in tensors)):
        raise ValueError("adain_fold: all inputs must be on one CUDA device")
    if x.dtype not in (torch.float32, torch.bfloat16) or any(
            t.dtype != torch.float32 for t in tensors[1:]):
        raise TypeError("adain_fold kernel takes x in float32 or bfloat16 "
                        "and the mask, gamma and beta in float32")
    if not x.is_contiguous() or (mask is not None
                                 and not mask.is_contiguous()):
        raise ValueError("adain_fold kernel takes a contiguous x and mask")
    if gamma is not None and (gamma.stride(1) != 1 or beta.stride(1) != 1):
        raise ValueError("adain_fold kernel takes gamma and beta with "
                         "contiguous rows")
    if batch == 0 or channels == 0 or length == 0:
        raise ValueError(f"adain_fold kernel: x {tuple(x.shape)}")
    return False


def adain_fold(x: torch.Tensor, mask: Optional[torch.Tensor],
               gamma: Optional[torch.Tensor], beta: Optional[torch.Tensor],
               eps: float = EPS, extent: Optional[torch.Tensor] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x [B, C, L] f32 or bf16, mask [B, L] f32 or None, gamma and beta
    [B, C] f32 -> (scale, shift) [B, C] f32, or with gamma and beta None
    (mean, rstd): the kernel on CUDA tensors, ``adain_fold_plain`` on CPU
    tensors. ``extent``: the mask's row extents (int32 [B]), with which the
    kernel reads no chunk past them; the result is the same."""
    if _check(x, mask, gamma, beta, extent):
        return adain_fold_plain(x, mask, gamma, beta, eps)
    batch, channels, length = x.shape
    bf16 = x.dtype == torch.bfloat16
    name = "adain_fold_bf16" if bf16 else "adain_fold"
    lib = _library()
    fn = lib.adain_fold_bf16 if bf16 else lib.adain_fold_f32

    def launch(x, gamma=None, beta=None):
        dev = x.device
        out = torch.empty((2, batch, channels), dtype=torch.float32,
                          device=dev)
        part = torch.empty(lib.adain_fold_part_floats(batch, channels,
                                                      length),
                           dtype=torch.float32, device=dev)
        with torch.cuda.device(dev):  # the C side launches on the current one
            rc = fn(x.data_ptr(), 0 if mask is None else mask.data_ptr(),
                    0 if extent is None else extent.data_ptr(),
                    *((0, 0, 0, 0) if gamma is None else (
                        gamma.data_ptr(), gamma.stride(0), beta.data_ptr(),
                        beta.stride(0))), out.data_ptr(), part.data_ptr(),
                    batch, channels, length, eps,
                    torch.cuda.current_stream(dev).cuda_stream)
        if rc != 0:
            raise RuntimeError(f"{fn.__name__} launch failed: cudaError {rc}")
        count_launch(name)
        return out

    def plain(x, gamma=None, beta=None):
        return torch.stack(adain_fold_plain(x, mask, gamma, beta, eps))

    tensors = (x,) if gamma is None else (x, gamma, beta)
    return tuple(kernel_call(launch, plain, *tensors).unbind(0))
