# -*- coding: utf-8 -*-
"""Voice adaptation: learn a new voice pack from reference audio (PyTorch
port of ``illufly_tts_tpu/training/voice_adapt.py``).

The acoustic model is differentiable end to end, so a new voice is a
256-d style vector (ref_s: 128 decoder + 128 prosody, reference
kmodel.py:82-84) optimized by gradient descent against a few (wav,
transcript) pairs. The model weights stay frozen: the style vector is the
only tensor that requires a gradient, so on the card its gradient reaches
it through the kernels' Functions (``ops/kernel_grad.py``: AdaIN ``fc(s)``
-> scale/shift of every fused conv) and the plain layers. A bfloat16 model
computes in bfloat16 on the float32 vector, as the JAX bfloat16 model
casts it; the vector, its gradient and Adam stay float32. The result saves
as a standard length-indexed ``[510, 1, 256]`` pack any surface loads like a
shipped voice.
"""
from __future__ import annotations

import logging
from typing import Iterator, Optional, Tuple

import numpy as np
import torch

from ..model.config import check_dtype
from ..model.kokoro import KokoroModel
from .loop import model_device, random_token_batch, render
from .step import TrainBatch, clip_by_global_norm, make_loss_fn

logger = logging.getLogger(__name__)


def adapt_voice(
    model: KokoroModel,
    batches: Iterator[TrainBatch],
    steps: int = 200,
    learning_rate: float = 5e-2,
    frames: int = 128,
    init: Optional[np.ndarray] = None,
    spectral: bool = True,
    log_every: int = 20,
) -> Tuple[np.ndarray, dict]:
    """Optimize a style vector against ``batches`` -> (style [2 *
    style_dim] float32, the best step's metrics).

    ``batches`` yield TrainBatch whose ref_s is ignored: the trained vector
    replaces it. ``init`` warm-starts from an existing voice's vector.
    ``spectral=True`` is the real-recording objective (mel-L1 + multi-res
    STFT, phase-blind); ``spectral=False`` is exact waveform L1, meaningful
    only against model-rendered targets. Optimizer: the global-norm clip at
    1.0, then Adam (optax.adam's defaults). A step whose loss is not finite
    is skipped (no update of the style or Adam's moments); the style
    returned is the one with the lowest loss seen, the style that loss was
    evaluated at."""
    check_dtype(model.config.dtype)
    style_dim = 2 * model.config.style_dim
    dev = model_device(model)
    if init is not None:
        s0 = np.asarray(init, np.float32).reshape(-1)
        if s0.shape[0] != style_dim:
            raise ValueError(
                f"init style has dim {s0.shape[0]}, model wants {style_dim}")
    else:
        s0 = np.zeros((style_dim,), np.float32)
    s = torch.tensor(s0, device=dev, requires_grad=True)
    model.requires_grad_(False)
    was_training = model.training
    model.train()  # cuDNN's LSTM backward runs in training mode only
    loss_fn = make_loss_fn(model, frames, spectral=spectral)
    optimizer = torch.optim.Adam([s], lr=learning_rate, betas=(0.9, 0.999),
                                 eps=1e-8)

    best_loss = float("inf")
    best_s = s0
    best_aux: dict = {}
    for i in range(steps):
        batch = next(batches).to(dev)
        optimizer.zero_grad(set_to_none=True)
        loss, aux = loss_fn(batch._replace(
            ref_s=s.expand(batch.ref_s.shape)))
        step_loss = float(loss.detach())
        if np.isfinite(step_loss):
            if step_loss < best_loss:
                best_loss = step_loss
                best_s = s.detach().cpu().numpy().copy()  # pre-update
                best_aux = {k: float(v.detach()) for k, v in aux.items()}
            loss.backward()
            clip_by_global_norm([s], 1.0)
            optimizer.step()
        else:
            # a non-finite step (the random-init generator can overflow
            # under an aggressive style) would poison s AND the Adam
            # moments: skip the update entirely and keep stepping
            logger.warning("voice-adapt step %d: non-finite loss, update "
                           "skipped", i + 1)
        if log_every and (i + 1) % log_every == 0:
            logger.info("voice-adapt step %d: %s", i + 1, {
                "loss": step_loss, "best_loss": best_loss,
                **{k: float(v.detach()) for k, v in aux.items()}})
    model.train(was_training)
    metrics = {"loss": best_loss, "best_loss": best_loss, **best_aux}
    return np.asarray(best_s, np.float32), metrics


def style_to_pack(style: np.ndarray, max_len: int = 510) -> np.ndarray:
    """Broadcast a single style vector into the length-indexed pack layout
    every loader accepts (``pack[len(phonemes)-1]``, reference
    pipeline.py:199; shape [510, 1, 256] like HF voice packs)."""
    style = np.asarray(style, np.float32).reshape(1, 1, -1)
    return np.broadcast_to(style, (max_len,) + style.shape[1:]).copy()


def rendered_batches(model: KokoroModel, target_style, batch_size: int,
                     tokens: int, frames: int,
                     seed: int = 0) -> Iterator[TrainBatch]:
    """Self-test data: batches whose target audio the model itself renders
    under ``target_style`` ([2 * style_dim]) on its device: adaptation must
    recover a vector that reproduces it."""
    cfg = model.config
    dev = model_device(model)
    rng = np.random.RandomState(seed)
    ref = torch.as_tensor(np.asarray(target_style, np.float32),
                          device=dev).expand(batch_size, 2 * cfg.style_dim)
    while True:
        ids, mask, target_dur = random_token_batch(
            rng, batch_size, tokens, cfg.albert.vocab_size)
        ids_t, mask_t, dur_t = (torch.from_numpy(a).to(dev)
                                for a in (ids, mask, target_dur))
        audio = render(model, ids_t, mask_t, ref, dur_t, frames)
        yield TrainBatch(ids_t, mask_t, ref, dur_t, audio)
