"""Operations and bytes of the Kokoro stack's work, counted from the
architecture (``perfbench/reference/kokoro.py``) and the shapes, whatever
implements them; and the published peaks they are held to.

An operation is one multiply or one add of a product (a multiply-add is
two); elementwise work is not counted. Bytes count each input read once
and each output written once."""
from __future__ import annotations

import math
from typing import Iterator, Tuple

# one NVIDIA H100 SXM (NVIDIA's data sheet; dense, without sparsity)
PEAK_BF16 = 989e12     # operations/s, bf16 tensor cores
PEAK_TF32 = 495e12     # operations/s, TF32: the fastest rate for float32
                       # inputs (the float32 convs run as 3xTF32 products)
PEAK_BYTES = 3.35e12   # bytes/s, HBM3
ESIZE = {"float32": 4, "bfloat16": 2}


def peak_ops(dtype: str) -> float:
    return PEAK_BF16 if dtype == "bfloat16" else PEAK_TF32


def _lstm(steps: int, d_in: int, hidden: int) -> float:
    """A bidirectional LSTM layer over ``steps``."""
    return 2 * 2 * steps * 4 * hidden * (d_in + hidden)


def _conv(length: int, c_in: int, c_out: int, k: int) -> float:
    return 2.0 * length * c_in * c_out * k


def _res_block(length: int, d_in: int, d_out: int, upsample: bool) -> float:
    out_len = 2 * length if upsample else length
    ops = _conv(out_len, d_in, d_out, 3) + _conv(out_len, d_out, d_out, 3)
    if upsample:
        ops += _conv(out_len, d_in, 1, 3)  # depthwise: one input channel each
    if d_in != d_out:
        ops += _conv(out_len, d_in, d_out, 1)
    return ops


def stage_a(cfg: dict, tokens: int) -> float:
    a = cfg["albert"]
    t, e, h, i = tokens, a["embedding_size"], a["hidden_size"], \
        a["intermediate_size"]
    hid, s = cfg["hidden_dim"], cfg["style_dim"]
    layer = (2 * t * h * 3 * h + 2 * 2 * t * t * h + 2 * t * h * h
             + 2 * 2 * t * h * i)
    ops = 2 * t * e * h + a["num_layers"] * layer + 2 * t * h * hid
    ops += 4 * _lstm(t, hid + s, hid // 2)  # duration encoder (3) + lstm
    ops += 2 * t * hid * cfg["max_dur"]
    return ops


def generator_launches(cfg: dict, batch: int, gen_frames: int
                       ) -> Iterator[Tuple[int, int, int, int]]:
    """(batch, channels, length, kernel) of every fused AdaIN + snake +
    conv step of one Generator pass over ``gen_frames`` generator frames
    (two a model frame): conv1 and conv2 of each dilation of each residual
    block, the noise blocks' included."""
    net = cfg["istftnet"]
    length = gen_frames
    for i, u in enumerate(net["upsample_rates"]):
        length *= u
        c = net["upsample_initial_channel"] // (2 ** (i + 1))
        noise_k = 7 if i + 1 < len(net["upsample_rates"]) else 11
        blocks = [(noise_k, (1, 3, 5))] + list(zip(
            net["resblock_kernel_sizes"], net["resblock_dilation_sizes"]))
        for k, dils in blocks:
            for _ in dils:
                yield batch, c, length, k
                yield batch, c, length, k


def generator(cfg: dict, batch: int, gen_frames: int) -> float:
    net = cfg["istftnet"]
    n_fft = net["gen_istft_n_fft"]
    spec = n_fft + 2
    ops = sum(_conv(b * length, c, c, k) for b, c, length, k in
              generator_launches(cfg, batch, gen_frames))
    length, c_prev = batch * gen_frames, 512
    for i, (u, k) in enumerate(zip(net["upsample_rates"],
                                   net["upsample_kernel_sizes"])):
        c = net["upsample_initial_channel"] // (2 ** (i + 1))
        ops += _conv(length, c_prev, c, k)  # transposed: per input column
        length *= u
        stride = math.prod(net["upsample_rates"][i + 1:])
        ops += _conv(length, spec, c, 2 * stride if stride > 1 else 1)
        c_prev = c
    ops += _conv(length, c_prev, spec, 7)  # conv_post
    k = n_fft // 2 + 1
    ops += 2 * 2 * length * n_fft * k * 2   # the source's STFT, the iSTFT
    return ops


def stage_b_front(cfg: dict, tokens: int, frames: int) -> float:
    """Everything of stage B before the Generator, at ``frames`` frames."""
    hid, s = cfg["hidden_dim"], cfg["style_dim"]
    f = frames
    ops = _lstm(f, hid + s, hid // 2)                     # shared LSTM
    tower = (_res_block(f, hid, hid, False)
             + _res_block(f, hid, hid // 2, True)
             + _res_block(2 * f, hid // 2, hid // 2, False)
             + _conv(2 * f, hid // 2, 1, 1))
    ops += 2 * tower
    ops += cfg["n_layer"] * _conv(tokens, hid, hid,
                                  cfg["text_encoder_kernel_size"])
    ops += _lstm(tokens, hid, hid // 2)                   # text encoder
    ops += _res_block(f, hid + 2, 1024, False) + _conv(f, hid, 64, 1)
    ops += 3 * _res_block(f, 1090, 1024, False) + _res_block(f, 1090, 512, True)
    return ops


def utterance(cfg: dict, tokens: int, frames: int) -> float:
    """The model's operations for one utterance of ``tokens`` ids rendered
    at ``frames`` frames, with no padding."""
    return (stage_a(cfg, tokens) + stage_b_front(cfg, tokens, frames)
            + generator(cfg, 1, 2 * frames))


# ---- kernels' bounds -----------------------------------------------------------


def conv_bound(cfg: dict, batch: int, gen_frames: int, dtype: str) -> float:
    """Least seconds of one Generator pass's fused convs: per launch the
    larger of its operations over the peak and its bytes (x, the weights,
    the mask, the per-channel scale, shift, alpha and bias read once, y
    written once) over the bandwidth."""
    es = ESIZE[dtype]
    total = 0.0
    for b, c, length, k in generator_launches(cfg, batch, gen_frames):
        ops = _conv(b * length, c, c, k)
        nbytes = (2 * b * c * length * es + k * c * c * es + b * length * 4
                  + (2 * b * c + 2 * c) * 4)
        total += max(ops / peak_ops(dtype), nbytes / PEAK_BYTES)
    return total


def fold_launches(cfg: dict, batch: int, frames: int, gen_frames: int,
                  front: bool) -> Iterator[Tuple[int, int, int, bool]]:
    """(batch, channels, length, folded) of every AdaIN statistics pass of
    a stage B: the Generator's 48 (one before each fused conv, folded with
    the style) and, with ``front``, the F0/N towers' and the trunk's 22
    (moments only)."""
    for b, c, length, _ in generator_launches(cfg, batch, gen_frames):
        yield b, c, length, True
    if not front:
        return
    h, f = cfg["hidden_dim"], frames
    tower = [(h, f), (h, f), (h, f), (h // 2, 2 * f), (h // 2, 2 * f),
             (h // 2, 2 * f)]
    trunk = [(h + 2, f), (1024, f)] + [(1090, f), (1024, f)] * 3 + \
        [(1090, f), (512, 2 * f)]
    for c, length in tower * 2 + trunk:
        yield batch, c, length, False


def fold_bound(cfg: dict, batch: int, frames: int, gen_frames: int,
               dtype: str, front: bool = True) -> float:
    """Least seconds of those passes: x and the mask read once, gamma and
    beta read once where folded, two per-channel rows written."""
    es = ESIZE[dtype]
    total = 0.0
    for b, c, length, folded in fold_launches(cfg, batch, frames, gen_frames,
                                              front):
        nbytes = b * c * length * es + b * length * 4 + 2 * b * c * 4
        if folded:
            nbytes += 2 * b * c * 4
        total += nbytes / PEAK_BYTES
    return total
