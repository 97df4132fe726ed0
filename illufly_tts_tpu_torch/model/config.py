# -*- coding: utf-8 -*-
"""Model configuration (Kokoro-82M-class StyleTTS2 stack), PyTorch port.

Counterpart of ``illufly_tts_tpu/model/config.py``: the same dimensions and
defaults, with a ``torch.dtype`` for the compute type: float32 (the default)
or bfloat16, the two the JAX package uses (``check_dtype``).

The JAX config's ``use_pallas_istft`` switch has no counterpart here: the
port's Generator always calls the iSTFT wrapper (``ops/istft_oa.py``), which
is the counterpart of ``use_pallas_istft=True``. Both JAX settings compute
the same function (the Pallas kernel is held to the jnp iSTFT at atol 1e-4
by the JAX package's own tests), so the port matches either.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import torch


# compute dtypes the port takes: those of the JAX package
DTYPES = (torch.float32, torch.bfloat16)


def check_dtype(dtype: torch.dtype) -> None:
    """Raise NotImplementedError for a compute dtype the port lacks."""
    if dtype not in DTYPES:
        raise NotImplementedError(
            f"compute dtype {dtype}: the port computes in float32 or "
            "bfloat16")


@dataclasses.dataclass(frozen=True)
class AlbertConfig:
    vocab_size: int = 256
    embedding_size: int = 128
    hidden_size: int = 768
    num_heads: int = 12
    intermediate_size: int = 2048
    num_layers: int = 12
    max_position: int = 512


@dataclasses.dataclass(frozen=True)
class IstftNetConfig:
    upsample_rates: Sequence[int] = (10, 6)
    upsample_kernel_sizes: Sequence[int] = (20, 12)
    upsample_initial_channel: int = 512
    resblock_kernel_sizes: Sequence[int] = (3, 7, 11)
    resblock_dilation_sizes: Sequence[Sequence[int]] = (
        (1, 3, 5), (1, 3, 5), (1, 3, 5)
    )
    gen_istft_n_fft: int = 20
    gen_istft_hop_size: int = 5


@dataclasses.dataclass(frozen=True)
class KokoroConfig:
    n_token: int = 256
    hidden_dim: int = 512
    style_dim: int = 128
    max_dur: int = 50
    n_layer: int = 3                 # text-encoder conv depth
    text_encoder_kernel_size: int = 5
    sample_rate: int = 24000
    albert: AlbertConfig = AlbertConfig()
    istftnet: IstftNetConfig = IstftNetConfig()
    # compute dtype (float32 or bfloat16); parameters stay float32, and a
    # bfloat16 model computes on a bfloat16 copy (``model/kokoro.py``)
    dtype: torch.dtype = torch.float32

    @property
    def samples_per_frame(self) -> int:
        # duration frames -> samples: 2x (F0 upsampling in the predictor /
        # decoder) * prod(upsample_rates) * istft hop
        r = 2 * self.istftnet.gen_istft_hop_size
        for u in self.istftnet.upsample_rates:
            r *= u
        return r  # 600 with defaults -> 40 duration-frames/sec at 24 kHz

    @property
    def style_split(self) -> int:
        return self.style_dim  # ref_s = [decoder 128 | style 128]
