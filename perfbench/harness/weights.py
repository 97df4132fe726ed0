"""Seeded weights and voices, drawn on the device in one call each.

``spec(cfg)`` lists every parameter of the Kokoro stack by name, shape and
initializer, named as the served model names them. ``make(cfg, seed,
device)`` draws them: LayerNorm scales and snake alphas 1, biases 0, every
other weight normal / sqrt(fan_in), fan_in as a flax initializer counts it
(the served model's own random init), from one ``torch.Generator`` on the
device. The duration projection's bias is the configuration's
``duration_bias``, so that a token lasts about as many frames as speech
gives it, and the Generator's log-magnitude rows of ``conv_post`` are
scaled by its ``magnitude_gain``, so that the iSTFT head's magnitudes stay
near 1 as a trained head's do, and the F0 projection by its ``f0_gain``, so
that F0 stays below the harmonic source's voiced threshold and the source
silent: on voiced frames the Generator's float32 arithmetic, the
reference's and the program's alike, lies about its own rms from float64
(``perfbench/conditioning.py``), so no waveform comparison holds there
(``PERF.md``, Cells).
"""
from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch

Spec = Tuple[str, Tuple[int, ...], str, int]  # name, shape, rule, fan_in
MAX_PHONEMES = 510  # voice pack rows: one style per utterance length


def _linear(out: List[Spec], name: str, d_in: int, d_out: int) -> None:
    out.append((f"{name}.weight", (d_out, d_in), "normal", d_in))
    out.append((f"{name}.bias", (d_out,), "zero", 0))


def _conv(out: List[Spec], name: str, c_in: int, c_out: int, k: int) -> None:
    out.append((f"{name}.weight", (c_out, c_in, k), "normal", c_in * k))
    out.append((f"{name}.bias", (c_out,), "zero", 0))


def _norm(out: List[Spec], name: str, width: int) -> None:
    out.append((f"{name}.weight", (width,), "one", 0))
    out.append((f"{name}.bias", (width,), "zero", 0))


def _lstm(out: List[Spec], name: str, d_in: int, hidden: int) -> None:
    for d in ("fwd", "bwd"):
        out.append((f"{name}.{d}.weight_ih_l0", (4 * hidden, d_in), "normal",
                    d_in))
        out.append((f"{name}.{d}.weight_hh_l0", (4 * hidden, hidden),
                    "normal", hidden))
        out.append((f"{name}.{d}.bias_ih_l0", (4 * hidden,), "zero", 0))
        out.append((f"{name}.{d}.bias_hh_l0", (4 * hidden,), "zero", 0))


def _res_block(out: List[Spec], name: str, d_in: int, d_out: int, s: int,
               upsample: bool) -> None:
    _linear(out, f"{name}.norm1.fc", s, 2 * d_in)
    if upsample:  # depthwise transposed conv, k 3: fan_in 3
        out.append((f"{name}.pool.weight", (d_in, 1, 3), "normal", 3))
        out.append((f"{name}.pool.bias", (d_in,), "zero", 0))
    _conv(out, f"{name}.conv1", d_in, d_out, 3)
    _linear(out, f"{name}.norm2.fc", s, 2 * d_out)
    _conv(out, f"{name}.conv2", d_out, d_out, 3)
    if d_in != d_out:
        _conv(out, f"{name}.conv1x1", d_in, d_out, 1)


def _snake_block(out: List[Spec], name: str, c: int, k: int, dilations,
                 s: int) -> None:
    for j, _ in enumerate(dilations):
        for n in (1, 2):
            out.append((f"{name}.alpha{n}_{j}", (1, c, 1), "one", 0))
            _linear(out, f"{name}.adain{n}_{j}.fc", s, 2 * c)
            _conv(out, f"{name}.conv{n}_{j}", c, c, k)


def spec(cfg: dict) -> List[Spec]:
    """Every parameter of the stack, in a fixed order."""
    a, net = cfg["albert"], cfg["istftnet"]
    h, s = cfg["hidden_dim"], cfg["style_dim"]
    out: List[Spec] = []
    e, hid = a["embedding_size"], a["hidden_size"]
    out.append(("bert.tok_emb.weight", (a["vocab_size"], e), "normal",
                a["vocab_size"]))
    out.append(("bert.pos_emb", (a["max_position"], e), "normal",
                a["max_position"]))
    _norm(out, "bert.ln_emb", e)
    _linear(out, "bert.emb_proj", e, hid)
    pre = "bert.shared_layer"
    _linear(out, f"{pre}.qkv", hid, 3 * hid)
    _linear(out, f"{pre}.attn_out", hid, hid)
    _norm(out, f"{pre}.ln_attn", hid)
    _linear(out, f"{pre}.ffn_in", hid, a["intermediate_size"])
    _linear(out, f"{pre}.ffn_out", a["intermediate_size"], hid)
    _norm(out, f"{pre}.ln_ffn", hid)
    _linear(out, "bert_encoder", hid, h)
    pre = "predictor"
    for i in range(3):
        _lstm(out, f"{pre}.duration_encoder.lstm_{i}", h + s, h // 2)
        _linear(out, f"{pre}.duration_encoder.adaln_{i}.fc", s, 2 * h)
    _lstm(out, f"{pre}.lstm", h + s, h // 2)
    _linear(out, f"{pre}.duration_proj", h, cfg["max_dur"])
    _lstm(out, f"{pre}.shared", h + s, h // 2)
    for tower in ("f0", "n"):
        _res_block(out, f"{pre}.{tower}_0", h, h, s, False)
        _res_block(out, f"{pre}.{tower}_1", h, h // 2, s, True)
        _res_block(out, f"{pre}.{tower}_2", h // 2, h // 2, s, False)
        _conv(out, f"{pre}.{tower}_proj", h // 2, 1, 1)
    out.append(("text_encoder.embed.weight", (cfg["n_token"], h), "normal",
                cfg["n_token"]))
    for i in range(cfg["n_layer"]):
        _conv(out, f"text_encoder.conv_{i}", h, h,
              cfg["text_encoder_kernel_size"])
        _norm(out, f"text_encoder.ln_{i}", h)
    _lstm(out, "text_encoder.lstm", h, h // 2)
    _conv(out, "decoder.f0_conv", 1, 1, 3)
    _conv(out, "decoder.n_conv", 1, 1, 3)
    _res_block(out, "decoder.encode", h + 2, 1024, s, False)
    _conv(out, "decoder.asr_res", h, 64, 1)
    for i, (d_in, d_out, up) in enumerate(((1090, 1024, False),) * 3
                                          + ((1090, 512, True),)):
        _res_block(out, f"decoder.decode_{i}", d_in, d_out, s, up)
    pre = "decoder.generator"
    _linear(out, f"{pre}.source.merge", 9, 1)
    rates, ks = net["upsample_rates"], net["upsample_kernel_sizes"]
    spec_ch = net["gen_istft_n_fft"] + 2
    c_prev = 512
    for i, (u, k) in enumerate(zip(rates, ks)):
        c = net["upsample_initial_channel"] // (2 ** (i + 1))
        # transposed conv [in, out, k]: fan_in k * in
        out.append((f"{pre}.up_{i}.weight", (c_prev, c, k), "normal",
                    c_prev * k))
        out.append((f"{pre}.up_{i}.bias", (c,), "zero", 0))
        if i + 1 < len(rates):
            stride = math.prod(rates[i + 1:])
            _conv(out, f"{pre}.noise_conv_{i}", spec_ch, c, 2 * stride)
            _snake_block(out, f"{pre}.noise_res_{i}", c, 7, (1, 3, 5), s)
        else:
            _conv(out, f"{pre}.noise_conv_{i}", spec_ch, c, 1)
            _snake_block(out, f"{pre}.noise_res_{i}", c, 11, (1, 3, 5), s)
        for j, (kr, dr) in enumerate(zip(net["resblock_kernel_sizes"],
                                         net["resblock_dilation_sizes"])):
            _snake_block(out, f"{pre}.res_{i}_{j}", c, kr, dr, s)
        c_prev = c
    _conv(out, f"{pre}.conv_post", c_prev, spec_ch, 7)
    return out


def make(cfg: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """name -> float32 tensor on ``device``, drawn from ``seed``: one normal
    draw for every weight, sliced and scaled."""
    items = spec(cfg)
    sizes = [math.prod(shape) for _, shape, rule, _ in items]
    total = sum(n for n, (_, _, rule, _) in zip(sizes, items)
                if rule == "normal")
    gen = torch.Generator(device=device).manual_seed(seed)
    draw = torch.randn(total, generator=gen, device=device)
    params, at = {}, 0
    for (name, shape, rule, fan_in), n in zip(items, sizes):
        if rule == "normal":
            params[name] = draw[at:at + n].view(shape) / math.sqrt(fan_in)
            at += n
        elif rule == "one":
            params[name] = torch.ones(shape, device=device)
        else:
            params[name] = torch.zeros(shape, device=device)
    params["predictor.duration_proj.bias"].fill_(cfg["duration_bias"])
    bins = cfg["istftnet"]["gen_istft_n_fft"] // 2 + 1
    params["decoder.generator.conv_post.weight"][:bins] *= cfg["magnitude_gain"]
    params["predictor.f0_proj.weight"] *= cfg["f0_gain"]
    return params


def voices(cfg: dict, seed: int, count: int, device) -> torch.Tensor:
    """``count`` voice packs [count, 510, 2 * style_dim], normal * 0.1 as
    the served engine's random voices, from ``seed`` (a stream of its
    own)."""
    gen = torch.Generator(device=device).manual_seed(seed ^ 0x5EED)
    return torch.randn(count, MAX_PHONEMES, 2 * cfg["style_dim"],
                       generator=gen, device=device) * 0.1
