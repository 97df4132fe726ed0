"""The Kokoro-82M family: StyleTTS2's text side (PL-BERT/ALBERT, the
style-conditioned duration predictor, the F0/energy towers, the text
encoder), the AdaIN decoder and the iSTFTNet Generator. Everything the
harness knows of the model, found by a configuration's ``"family":
"kokoro"`` (``perfbench/harness/registry.py``):

- ``sizes(raw)``: a configuration file's keys as the model's sizes (the
  ``cfg`` every other function takes); ``tiny(dtype)``: such sizes small
  enough for the CPU tests; ``kokoro_config(cfg)``: them as the served
  model's ``KokoroConfig``;
- ``spec``, ``make``, ``voices``: the seeded weights and voice packs;
- ``model``, ``engine``: the served float32 model and engine on them;
- ``row_extras(handle, i)``: what the recorder keeps of a dispatched row
  beyond its durations and frame bucket: nothing, the style is the voice
  pack's row;
- ``Reference``: the plain reference (``perfbench/reference/kokoro.py``);
  ``Judge``: it on the seed's weights and voices, as the check asks it;
- ``encode``, ``samples_per_frame``: the ids the model reads of an IPA
  text, and the audio samples of one frame;
- ``generator_passes()``, ``TRACE_CLASSES``, ``PASS_CLASS``: the program's
  count of Generator passes, the trace's classes of the program's own
  kernels, and the class of which one launch marks one Generator pass;
- ``utterance``, ``conv_bound``, ``fold_bound`` (and their parts):
  operations and bytes of the model's work, counted from the architecture
  and the shapes, whatever implements them. An operation is one multiply
  or one add of a product (a multiply-add is two); elementwise work is not
  counted. Bytes count each input read once and each output written once.
  ``perfbench/flops.py`` holds the peaks they are held to."""
from __future__ import annotations

import math
from typing import Callable, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from perfbench.flops import ESIZE, PEAK_BYTES, peak_ops
from perfbench.reference import kokoro as reference
from perfbench.reference import vocab

# ---- sizes ------------------------------------------------------------------

# The file keeps the published ``config.json``'s keys (``plbert``,
# ``istftnet`` and the top-level sizes), plus ``dtype`` (the compute type),
# and under ``assumed`` the sizes the source leaves out
# (``albert_embedding_size``, ``sample_rate``) and the constants of the
# seeded weights (``duration_bias``, ``magnitude_head_gain``,
# ``f0_head_gain``).

_DTYPES = ("float32", "bfloat16")


def sizes(raw: dict) -> dict:
    """The file's keys -> the model's sizes under the served model's field
    names (the reference's ``cfg``)."""
    bert, net, assumed = raw["plbert"], raw["istftnet"], raw["assumed"]
    if raw["dtype"] not in _DTYPES:
        raise ValueError(f"dtype {raw['dtype']!r}: one of {_DTYPES}")
    return {
        "n_token": raw["n_token"],
        "hidden_dim": raw["hidden_dim"],
        "style_dim": raw["style_dim"],
        "max_dur": raw["max_dur"],
        "n_layer": raw["n_layer"],
        "text_encoder_kernel_size": raw["text_encoder_kernel_size"],
        "sample_rate": assumed["sample_rate"],
        "albert": {
            "vocab_size": raw["n_token"],
            "embedding_size": assumed["albert_embedding_size"],
            "hidden_size": bert["hidden_size"],
            "num_heads": bert["num_attention_heads"],
            "intermediate_size": bert["intermediate_size"],
            "num_layers": bert["num_hidden_layers"],
            "max_position": bert["max_position_embeddings"],
        },
        "istftnet": {
            "upsample_rates": tuple(net["upsample_rates"]),
            "upsample_kernel_sizes": tuple(net["upsample_kernel_sizes"]),
            "upsample_initial_channel": net["upsample_initial_channel"],
            "resblock_kernel_sizes": tuple(net["resblock_kernel_sizes"]),
            "resblock_dilation_sizes": tuple(
                tuple(d) for d in net["resblock_dilation_sizes"]),
            "gen_istft_n_fft": net["gen_istft_n_fft"],
            "gen_istft_hop_size": net["gen_istft_hop_size"],
        },
        "dtype": raw["dtype"],
        "duration_bias": assumed["duration_bias"],
        "magnitude_gain": assumed["magnitude_head_gain"],
        "f0_gain": assumed["f0_head_gain"],
    }


def tiny(dtype: str = "float32") -> dict:
    """Sizes small enough for the CPU tests: the stack's shape with narrow
    layers, as ``sizes`` returns them."""
    return {
        "n_token": 256, "hidden_dim": 32, "style_dim": 16, "max_dur": 10,
        "n_layer": 2, "text_encoder_kernel_size": 5, "sample_rate": 24000,
        "albert": {"vocab_size": 256, "embedding_size": 16, "hidden_size": 32,
                   "num_heads": 4, "intermediate_size": 64, "num_layers": 2,
                   "max_position": 512},
        "istftnet": {"upsample_rates": (10, 6),
                     "upsample_kernel_sizes": (20, 12),
                     "upsample_initial_channel": 32,
                     "resblock_kernel_sizes": (3, 7),
                     "resblock_dilation_sizes": ((1, 3), (1, 3)),
                     "gen_istft_n_fft": 20, "gen_istft_hop_size": 5},
        "dtype": dtype, "duration_bias": -1.0, "magnitude_gain": 0.05,
        "f0_gain": 0.1,
    }


def kokoro_config(cfg: dict):
    """``cfg`` as the served model's ``KokoroConfig``."""
    from illufly_tts_tpu_torch.model.config import (
        AlbertConfig,
        IstftNetConfig,
        KokoroConfig,
    )

    keys = ("n_token", "hidden_dim", "style_dim", "max_dur", "n_layer",
            "text_encoder_kernel_size", "sample_rate")
    return KokoroConfig(
        **{k: cfg[k] for k in keys},
        albert=AlbertConfig(**cfg["albert"]),
        istftnet=IstftNetConfig(**cfg["istftnet"]),
        dtype=getattr(torch, cfg["dtype"]),
    )


# ---- seeded weights and voices ----------------------------------------------

# ``spec(cfg)`` lists every parameter of the Kokoro stack by name, shape and
# initializer, named as the served model names them. ``make(cfg, seed,
# device)`` draws them: LayerNorm scales and snake alphas 1, biases 0, every
# other weight normal / sqrt(fan_in), fan_in as a flax initializer counts it
# (the served model's own random init), from one ``torch.Generator`` on the
# device. The duration projection's bias is the configuration's
# ``duration_bias``, so that a token lasts about as many frames as speech
# gives it, and the Generator's log-magnitude rows of ``conv_post`` are
# scaled by its ``magnitude_gain``, so that the iSTFT head's magnitudes stay
# near 1 as a trained head's do, and the F0 projection by its ``f0_gain``, so
# that F0 stays below the harmonic source's voiced threshold and the source
# silent: on voiced frames the Generator's float32 arithmetic, the
# reference's and the program's alike, lies about its own rms from float64
# (``perfbench/conditioning.py``), so no waveform comparison holds there
# (``PERF.md``, Cells).

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


# ---- the system under test --------------------------------------------------


def model(cfg: dict, params: Dict[str, torch.Tensor], device):
    """A float32 ``KokoroModel`` on ``device`` holding ``params``."""
    from illufly_tts_tpu_torch.model.kokoro import KokoroModel

    with torch.device("meta"):
        net = KokoroModel(kokoro_config({**cfg, "dtype": "float32"}))
    net = net.to_empty(device=device)
    net.load_state_dict(params, strict=True)
    return net


def engine(cfg: dict, params: Dict[str, torch.Tensor], device, **buckets):
    """The served engine (``Synthesizer``) holding ``params``: they are put
    into a float32 model on the device and handed to the engine as its
    weight tree, as a checkpoint is."""
    from illufly_tts_tpu_torch.engine.synthesizer import Synthesizer
    from illufly_tts_tpu_torch.model.params import export_flax_params

    kcfg = kokoro_config(cfg)
    net = model(cfg, params, device)
    tree = export_flax_params(net)
    del net
    return Synthesizer(config=kcfg, params=tree, device=device, **buckets)


def row_extras(handle, i: int) -> dict:
    """Nothing beyond the durations: the style is the voice pack's row."""
    return {}


def generator_passes() -> int:
    """Generator passes so far: one iSTFT-head launch a pass."""
    from illufly_tts_tpu_torch.ops import istft_oa

    return istft_oa.launches + istft_oa.launches_bf16


# the program's own kernels, ahead of the trace's general classes
# (``perfbench/harness/trace.py``); first match wins
TRACE_CLASSES = (
    ("istft", r"istft"),
    ("fused_conv", r"adain_snake_conv"),
    ("adain_fold", r"chunk_moments|finish_rows"),
    ("conv_weight_split", r"split_weights_kernel"),
)
PASS_CLASS = "istft"

# ---- the check's reference --------------------------------------------------

MAX_IDS = 512  # ALBERT's positions: the ids the served model reads


def encode(ipa: str) -> List[int]:
    """The ids the model reads of ``ipa``."""
    return vocab.encode(ipa)[:MAX_IDS]


samples_per_frame = reference.samples_per_frame
Reference = reference.Reference


class Judge:
    """The reference on the seed's weights and voices, on their device, as
    ``perfbench/harness/check.py`` asks it: ``durations(ipa, voice,
    row=None)`` -> (float durations [1, n] of the n ids ``encode`` gives,
    the state stage B starts from); ``ref.quantize(durations, mask)``,
    rounded as the engine rounds; ``audio(...)`` of one recorded row."""

    def __init__(self, cfg: dict, params: Dict[str, torch.Tensor],
                 packs: torch.Tensor, quant: Optional[Callable] = None):
        self.cfg = cfg
        self.ref = Reference(cfg, params, quant)
        self.packs = packs
        self.device = packs.device

    def inputs(self, ipa: str, voice: int):
        ids = torch.tensor([encode(ipa)], device=self.device)
        mask = torch.ones(ids.shape, device=self.device)
        pack = self.packs[voice]
        ref_s = pack[max(min(len(ipa) - 1, pack.shape[0] - 1), 0)][None]
        return ids, mask, ref_s

    @torch.no_grad()
    def durations(self, ipa: str, voice: int, row=None):
        """``row``, the recorder's row of the answer (None for a control,
        which draws its own), adds nothing here (``row_extras``)."""
        ids, mask, ref_s = self.inputs(ipa, voice)
        dur, d = self.ref.durations(ids, mask, ref_s)
        return dur, d

    @torch.no_grad()
    def audio(self, ipa: str, voice: int, dur_int: np.ndarray, frames: int,
              form: dict, d=None, row=None) -> np.ndarray:
        """The served audio of ``ipa`` rendered with ``dur_int`` at
        ``frames`` frames, in ``form`` ({"kind": "pcm16"} or {"kind":
        "stream", "window": w, "halo": h}); None where the reference
        refuses it. ``row``, the recorder's row of the answer, adds
        nothing here (``row_extras``)."""
        ids, mask, ref_s = self.inputs(ipa, voice)
        if d is None:
            _, d = self.ref.durations(ids, mask, ref_s)
        dur = torch.as_tensor(dur_int, device=self.device)[None]
        spf = samples_per_frame(self.cfg)
        total = int(self.ref.fit(dur, frames).sum())
        if form["kind"] == "stream":
            try:
                out = self.ref.stream(ids, mask, d, dur, ref_s, frames,
                                      form["window"], form["halo"])
            except ValueError:
                return None
            return out.cpu().numpy()
        audio, _ = self.ref.render(ids, mask, d, dur, ref_s, frames)
        return reference.pcm16(audio)[0, : total * spf].cpu().numpy()


# ---- operations and bytes ---------------------------------------------------


def _lstm_ops(steps: int, d_in: int, hidden: int) -> float:
    """A bidirectional LSTM layer over ``steps``."""
    return 2 * 2 * steps * 4 * hidden * (d_in + hidden)


def _conv_ops(length: int, c_in: int, c_out: int, k: int) -> float:
    return 2.0 * length * c_in * c_out * k


def _res_block_ops(length: int, d_in: int, d_out: int,
                   upsample: bool) -> float:
    out_len = 2 * length if upsample else length
    ops = _conv_ops(out_len, d_in, d_out, 3) \
        + _conv_ops(out_len, d_out, d_out, 3)
    if upsample:
        ops += _conv_ops(out_len, d_in, 1, 3)  # depthwise: one input each
    if d_in != d_out:
        ops += _conv_ops(out_len, d_in, d_out, 1)
    return ops


def stage_a(cfg: dict, tokens: int) -> float:
    a = cfg["albert"]
    t, e, h, i = tokens, a["embedding_size"], a["hidden_size"], \
        a["intermediate_size"]
    hid, s = cfg["hidden_dim"], cfg["style_dim"]
    layer = (2 * t * h * 3 * h + 2 * 2 * t * t * h + 2 * t * h * h
             + 2 * 2 * t * h * i)
    ops = 2 * t * e * h + a["num_layers"] * layer + 2 * t * h * hid
    ops += 4 * _lstm_ops(t, hid + s, hid // 2)  # duration encoder (3) + lstm
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
    ops = sum(_conv_ops(b * length, c, c, k) for b, c, length, k in
              generator_launches(cfg, batch, gen_frames))
    length, c_prev = batch * gen_frames, 512
    for i, (u, k) in enumerate(zip(net["upsample_rates"],
                                   net["upsample_kernel_sizes"])):
        c = net["upsample_initial_channel"] // (2 ** (i + 1))
        ops += _conv_ops(length, c_prev, c, k)  # transposed: per input column
        length *= u
        stride = math.prod(net["upsample_rates"][i + 1:])
        ops += _conv_ops(length, spec, c, 2 * stride if stride > 1 else 1)
        c_prev = c
    ops += _conv_ops(length, c_prev, spec, 7)  # conv_post
    k = n_fft // 2 + 1
    ops += 2 * 2 * length * n_fft * k * 2   # the source's STFT, the iSTFT
    return ops


def stage_b_front(cfg: dict, tokens: int, frames: int) -> float:
    """Everything of stage B before the Generator, at ``frames`` frames."""
    hid, s = cfg["hidden_dim"], cfg["style_dim"]
    f = frames
    ops = _lstm_ops(f, hid + s, hid // 2)                 # shared LSTM
    tower = (_res_block_ops(f, hid, hid, False)
             + _res_block_ops(f, hid, hid // 2, True)
             + _res_block_ops(2 * f, hid // 2, hid // 2, False)
             + _conv_ops(2 * f, hid // 2, 1, 1))
    ops += 2 * tower
    ops += cfg["n_layer"] * _conv_ops(tokens, hid, hid,
                                      cfg["text_encoder_kernel_size"])
    ops += _lstm_ops(tokens, hid, hid // 2)               # text encoder
    ops += _res_block_ops(f, hid + 2, 1024, False) + _conv_ops(f, hid, 64, 1)
    ops += 3 * _res_block_ops(f, 1090, 1024, False) \
        + _res_block_ops(f, 1090, 512, True)
    return ops


def utterance(cfg: dict, tokens: int, frames: int) -> float:
    """The model's operations for one utterance of ``tokens`` ids rendered
    at ``frames`` frames, with no padding."""
    return (stage_a(cfg, tokens) + stage_b_front(cfg, tokens, frames)
            + generator(cfg, 1, 2 * frames))


def conv_bound(cfg: dict, batch: int, gen_frames: int, dtype: str) -> float:
    """Least seconds of one Generator pass's fused convs: per launch the
    larger of its operations over the peak and its bytes (x, the weights,
    the mask, the per-channel scale, shift, alpha and bias read once, y
    written once) over the bandwidth."""
    es = ESIZE[dtype]
    total = 0.0
    for b, c, length, k in generator_launches(cfg, batch, gen_frames):
        ops = _conv_ops(b * length, c, c, k)
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

