# -*- coding: utf-8 -*-
"""Training step (teacher-forced) for the TTS stack: the PyTorch port of
``illufly_tts_tpu/training/step.py``.

Duration-prediction loss + waveform reconstruction with teacher-forced
alignments (differentiable end to end: rounding never appears in the
gradient path). The model's ``encode_durations`` and ``decode_frames`` run
directly, with no ``generator``: deterministic, as the JAX step. On the card
the Generator's kernels run forward and their plain versions give the
gradients (``ops/kernel_grad.py``).

The optimizer steps follow optax's: ``clip_by_global_norm`` scales the
gradients by ``max / ||g||`` only when ``||g|| >= max`` (not
``torch.nn.utils.clip_grad_norm_``'s ``max / (||g|| + 1e-6)``), then the
optimizer (``torch.optim.AdamW`` set as ``optax.adamw``: betas (0.9, 0.999),
eps 1e-8, weight decay 1e-4) steps.

The steps take a float32 ``KokoroModel`` or ``Replicas``
(``parallel/replicas.py``): the forward runs on each compute replica (its
rows of the batch, gathered before the loss, so that the loss is the whole
batch's), the replicas' gradients are summed into the float32 master
weights, and the replicas take the stepped weights back.
"""
from __future__ import annotations

from typing import Dict, Iterable, NamedTuple

import torch

from ..model.kokoro import KokoroModel
from ..parallel.replicas import Replicas


class TrainBatch(NamedTuple):
    input_ids: torch.Tensor     # [B, T] int
    mask: torch.Tensor          # [B, T]
    ref_s: torch.Tensor         # [B, 2 * style_dim]
    target_dur: torch.Tensor    # [B, T] float frames (teacher alignment)
    target_audio: torch.Tensor  # [B, F * samples_per_frame]

    def to(self, device) -> "TrainBatch":
        return TrainBatch(*(t.to(device) for t in self))


def adamw(params: Iterable[torch.nn.Parameter],
          learning_rate: float) -> torch.optim.Optimizer:
    """``optax.adamw(learning_rate)``'s defaults in torch."""
    return torch.optim.AdamW(params, lr=learning_rate, betas=(0.9, 0.999),
                             eps=1e-8, weight_decay=1e-4)


@torch.no_grad()
def clip_by_global_norm(params: Iterable[torch.nn.Parameter],
                        max_norm: float) -> torch.Tensor:
    """``optax.clip_by_global_norm``: every gradient becomes ``g / ||g|| *
    max_norm`` when the global norm ``||g|| >= max_norm``, else stays. A
    parameter without a gradient gets zeros, as optax sees it (so AdamW
    still decays it). -> the norm (a device tensor: no host sync)."""
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    grads = [p.grad for p in params]
    norm = torch.linalg.vector_norm(
        torch.stack([torch.linalg.vector_norm(g) for g in grads]))
    keep = norm < max_norm
    for g in grads:
        g.copy_(torch.where(keep, g, g / norm * max_norm))
    return norm


def _outputs(model: KokoroModel, num_frames: int, batch: TrainBatch):
    """One model's teacher-forced forward -> (durations [B, T], audio
    [B, F * spf], frame mask [B, F])."""
    ones = torch.ones(batch.input_ids.shape[0], device=batch.mask.device)
    duration, d = model.encode_durations(batch.input_ids, batch.mask,
                                         batch.ref_s, ones)
    teacher = torch.round(batch.target_dur * batch.mask).to(torch.int32)
    audio, fmask = model.decode_frames(batch.input_ids, batch.mask, d,
                                       teacher, batch.ref_s, num_frames)
    return duration, audio, fmask


def teacher_forced_audio(model, num_frames: int, batch: TrainBatch):
    """The shared generator forward -> (audio [B, F * spf], sample mask
    [B, F * spf], duration loss). ``model``: a ``KokoroModel``, or
    ``Replicas``, whose replicas each run their rows of ``batch`` and whose
    outputs are gathered first, so that the loss is the whole batch's."""
    if isinstance(model, Replicas):
        duration, audio, fmask = model.map(
            lambda m, b: _outputs(m, num_frames, b), batch)
    else:
        duration, audio, fmask = _outputs(model, num_frames, batch)
    denom = torch.clamp(batch.mask.sum(), min=1.0)
    dur_loss = (torch.square(duration - batch.target_dur)
                * batch.mask).sum() / denom
    sample_mask = fmask.repeat_interleave(model.config.samples_per_frame,
                                          dim=1)
    return audio, sample_mask, dur_loss


def make_loss_fn(model, num_frames: int, spectral: bool = False,
                 mel_weight: float = 1.0, stft_weight: float = 0.5):
    """Teacher-forced loss, ``loss_fn(batch) -> (loss, metrics)``.
    ``spectral=False``: duration MSE + masked waveform L1 (the synthetic
    distillation objective, whose teacher waveform is exact).
    ``spectral=True``: duration MSE + mel-L1 + multi-resolution STFT (the
    real-data objective: waveform L1 is phase-blind against recordings)."""

    def loss_fn(batch: TrainBatch):
        audio, sample_mask, dur_loss = teacher_forced_audio(
            model, num_frames, batch)
        if spectral:
            from ..audio.mel_torch import mel_l1, multi_res_stft_loss

            pred = audio * sample_mask
            tgt = batch.target_audio * sample_mask
            mel_loss = mel_l1(pred, tgt, model.config.sample_rate)
            stft_loss = multi_res_stft_loss(pred, tgt)
            loss = dur_loss + mel_weight * mel_loss + stft_weight * stft_loss
            return loss, {"dur_loss": dur_loss, "mel_l1": mel_loss,
                          "stft_loss": stft_loss, "audio_loss": mel_loss}
        a_denom = torch.clamp(sample_mask.sum(), min=1.0)
        audio_loss = (torch.abs(audio - batch.target_audio)
                      * sample_mask).sum() / a_denom
        return dur_loss + audio_loss, {"dur_loss": dur_loss,
                                       "audio_loss": audio_loss}

    return loss_fn


def _detached(metrics: Dict[str, torch.Tensor], **more) -> dict:
    return {k: v.detach() for k, v in dict(metrics, **more).items()}


def _replicas(model) -> Replicas:
    """``model`` as ``Replicas`` (a float32 ``KokoroModel`` is its own
    master and only replica)."""
    if isinstance(model, Replicas):
        return model
    if model.config.dtype != torch.float32:
        raise ValueError(
            f"a {model.config.dtype} model steps its float32 master "
            "weights: pass Replicas(model) and an optimizer over "
            "Replicas.params (train() does both)")
    return Replicas(model)


def make_train_step(model, optimizer: torch.optim.Optimizer,
                    num_frames: int, spectral: bool = False,
                    max_grad_norm: float = 1.0):
    """``train_step(batch) -> metrics`` (detached tensors): loss,
    backward, the replicas' gradients reduced into the master weights, the
    global-norm clip, the optimizer step, the replicas refreshed.
    ``model``: a float32 ``KokoroModel`` or ``Replicas``; ``optimizer``
    over the master's parameters."""
    replicas = _replicas(model)
    loss_fn = make_loss_fn(replicas, num_frames, spectral=spectral)
    params = [p for group in optimizer.param_groups for p in group["params"]]

    def train_step(batch: TrainBatch):
        optimizer.zero_grad(set_to_none=True)
        replicas.zero_grad()
        loss, metrics = loss_fn(batch)
        loss.backward()
        replicas.reduce_grads()
        clip_by_global_norm(params, max_grad_norm)
        optimizer.step()
        replicas.sync()
        return _detached(metrics, loss=loss)

    return train_step


def make_gan_train_step(
    model,
    disc,
    g_optimizer: torch.optim.Optimizer,
    d_optimizer: torch.optim.Optimizer,
    num_frames: int,
    dur_weight: float = 1.0,
    mel_weight: float = 45.0,
    stft_weight: float = 0.5,
    adv_weight: float = 1.0,
    fm_weight: float = 2.0,
    max_grad_norm: float = 1.0,
):
    """Adversarial (HiFi-GAN/StyleTTS2 recipe) step, ``gan_step(batch) ->
    metrics``: the D update on detached generator output (LSGAN), then the
    G update against the refreshed discriminator with reconstruction
    (duration MSE + mel-L1 at HiFi-GAN's lambda_mel=45 + multi-res STFT)
    + adversarial + feature-matching terms."""
    from ..audio.mel_torch import mel_l1, multi_res_stft_loss
    from .discriminator import (
        discriminator_loss,
        feature_matching_loss,
        generator_adv_loss,
    )

    model = _replicas(model)
    sr = model.config.sample_rate
    g_params = [p for g in g_optimizer.param_groups for p in g["params"]]
    d_params = [p for g in d_optimizer.param_groups for p in g["params"]]

    def gan_step(batch: TrainBatch):
        # --- D step (fake detached: only D learns here) ---
        with torch.no_grad():
            audio, sample_mask, _ = teacher_forced_audio(model, num_frames,
                                                         batch)
            fake = audio * sample_mask
        real = batch.target_audio * sample_mask
        d_optimizer.zero_grad(set_to_none=True)
        f_logits, _ = disc(fake)
        r_logits, _ = disc(real)
        d_loss = discriminator_loss(r_logits, f_logits)
        d_loss.backward()
        clip_by_global_norm(d_params, max_grad_norm)
        d_optimizer.step()
        # --- G step against the refreshed D (HiFi-GAN order) ---
        g_optimizer.zero_grad(set_to_none=True)
        model.zero_grad()
        disc.requires_grad_(False)
        try:
            audio, sample_mask, dur_loss = teacher_forced_audio(
                model, num_frames, batch)
            fake = audio * sample_mask
            mel_loss = mel_l1(fake, real, sr)
            stft_loss = multi_res_stft_loss(fake, real)
            f_logits, f_feats = disc(fake)
            _, r_feats = disc(real)
            adv = generator_adv_loss(f_logits)
            fm = feature_matching_loss(r_feats, f_feats)
            loss = (dur_weight * dur_loss + mel_weight * mel_loss
                    + stft_weight * stft_loss + adv_weight * adv
                    + fm_weight * fm)
            loss.backward()
        finally:
            disc.requires_grad_(True)
        model.reduce_grads()
        clip_by_global_norm(g_params, max_grad_norm)
        g_optimizer.step()
        model.sync()
        return _detached({"dur_loss": dur_loss, "mel_l1": mel_loss,
                          "stft_loss": stft_loss, "adv_loss": adv,
                          "fm_loss": fm, "audio_loss": mel_loss},
                         loss=loss, d_loss=d_loss)

    return gan_step
