"""A configuration file (``perfbench/configs/<name>.json``) as the sizes the
reference reads and as the served model's ``KokoroConfig``.

The file keeps the published ``config.json``'s keys (``plbert``,
``istftnet`` and the top-level sizes), plus ``dtype`` (the compute type), and
under ``assumed`` the sizes the source leaves out
(``albert_embedding_size``, ``sample_rate``) and the constants of the
seeded weights (``duration_bias``, ``magnitude_head_gain``,
``f0_head_gain``, ``perfbench/harness/weights.py``)."""
from __future__ import annotations

import json

from . import registry

_DTYPES = ("float32", "bfloat16")


def load(name: str) -> dict:
    with open(registry.path("configs", name)) as f:
        raw = json.load(f)
    return from_file(raw)


def from_file(raw: dict) -> dict:
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


def kokoro_config(cfg: dict):
    """``cfg`` as the served model's ``KokoroConfig``."""
    import torch
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
