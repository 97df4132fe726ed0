# -*- coding: utf-8 -*-
"""Training loop: synthetic-teacher data, checkpointing (PyTorch port of
``illufly_tts_tpu/training/loop.py``).

A loop that distills against a frozen teacher (a deepcopy of the initial
model, taken before any restore), so the loss is verifiably minimizable
without external data; real data plugs in by yielding ``TrainBatch`` from
any source, or through ``data_dir`` (``training/data.py``).

The optimizer steps float32 master weights (``parallel/replicas.py``): a
float32 model trains in place and is its own master; a bfloat16 model
computes the steps in bfloat16, its float32 master starts from the float32
weights given as ``master`` (else from a copy of the model's own), and the
model is refreshed from it after every step. With a ``mesh`` one replica per
'data' index runs its rows of each batch, tensor-parallel over the index's
row of devices where the 'model' axis exceeds 1; the loss is the whole
batch's, and the replicas' gradients (a split leaf's shards concatenated)
are summed into the master's.
"""
from __future__ import annotations

import copy
import logging
import time
from typing import Iterator, Optional

import numpy as np
import torch

from ..model.config import check_dtype
from ..model.kokoro import KokoroModel
from ..parallel.replicas import Replicas
from .checkpoint import latest_checkpoint, restore_train_state, save_train_state
from .step import TrainBatch, adamw, make_gan_train_step, make_train_step

logger = logging.getLogger(__name__)


def model_device(model: torch.nn.Module) -> torch.device:
    return next(model.parameters()).device


def flatten_rnns(model: torch.nn.Module) -> None:
    """Put each LSTM's weights back into one chunk (a deepcopy splits
    them, and cuDNN then compacts them at every call)."""
    for m in model.modules():
        if isinstance(m, torch.nn.RNNBase):
            m.flatten_parameters()


def random_token_batch(rng: np.random.RandomState, batch_size: int,
                       tokens: int, n_vocab: int):
    """(ids [B, T] int32, mask [B, T] f32, target_dur = 3 * mask): rows of
    ``tokens // 2 .. tokens - 2`` random ids between BOS/EOS zeros that
    stay in the mask, as the JAX loaders draw them."""
    lengths = rng.randint(tokens // 2, tokens - 1, batch_size)
    ids = np.zeros((batch_size, tokens), np.int32)
    mask = np.zeros((batch_size, tokens), np.float32)
    for i, ln in enumerate(lengths):
        ids[i, 1: ln + 1] = rng.randint(1, n_vocab, ln)
        mask[i, : ln + 2] = 1.0  # BOS/EOS zeros stay in-mask
    return ids, mask, (mask * 3.0).astype(np.float32)


@torch.no_grad()
def render(model: KokoroModel, ids, mask, ref_s, target_dur,
           frames: int) -> torch.Tensor:
    """The model's teacher-forced audio [B, frames * spf] (durations
    truncated to int, as the JAX renderers cast them)."""
    ones = torch.ones(ids.shape[0], device=ids.device)
    _, d = model.encode_durations(ids, mask, ref_s, ones)
    teacher = (target_dur * mask).to(torch.int32)
    audio, _ = model.decode_frames(ids, mask, d, teacher, ref_s, frames)
    return audio


def synthetic_batches(model: KokoroModel, teacher: KokoroModel,
                      batch_size: int, tokens: int, frames: int,
                      seed: int = 0) -> Iterator[TrainBatch]:
    """Endless batches whose audio targets come from a frozen ``teacher``
    on ``model``'s device. Teacher-forced durations are fixed (3 frames a
    token) so the duration head has a stationary target too."""
    cfg = model.config
    dev = model_device(teacher)
    rng = np.random.RandomState(seed)
    while True:
        ids, mask, target_dur = random_token_batch(
            rng, batch_size, tokens, cfg.albert.vocab_size)
        ref_s = (rng.randn(batch_size, 2 * cfg.style_dim) * 0.1).astype(
            np.float32)
        ids_t, mask_t, ref_t, dur_t = (torch.from_numpy(a).to(dev) for a in (
            ids, mask, ref_s, target_dur))
        audio = render(teacher, ids_t, mask_t, ref_t, dur_t, frames)
        assert audio.shape[1] == frames * cfg.samples_per_frame
        yield TrainBatch(ids_t, mask_t, ref_t, dur_t, audio)


def train(
    model: KokoroModel,
    steps: int,
    batch_size: int = 8,
    tokens: int = 64,
    frames: int = 128,
    learning_rate: float = 1e-4,
    max_grad_norm: float = 1.0,
    mesh=None,
    checkpoint_dir: Optional[str] = None,
    resume: bool = False,
    checkpoint_every: int = 100,
    log_every: int = 10,
    seed: int = 0,
    batches: Optional[Iterator[TrainBatch]] = None,
    data_dir: Optional[str] = None,
    spectral: Optional[bool] = None,
    on_metrics=None,
    adversarial: bool = False,
    disc_lr: float = 2e-4,
    disc_kwargs: Optional[dict] = None,
    master=None,
):
    """Run ``steps`` optimizer steps on ``model`` -> (the float32 master
    model, optimizer, metrics of the last step as floats). The master is
    ``model`` itself when it is float32; a bfloat16 ``model`` holds the
    master's weights rounded after every step. Checkpoints hold the master.

    ``master``: for a bfloat16 ``model``, the float32 weights its master
    starts from (a float32 ``KokoroModel`` or a flax-layout tree), as the
    JAX ``train`` steps its float32 ``params`` and computes in bfloat16;
    ``model`` is set to them rounded before the first step. None: the
    master starts from ``model``'s own weights, already rounded to
    bfloat16 (``Replicas``). A float32 ``model`` takes none.

    ``mesh`` (``parallel/mesh.py``): the batch size rounds up to a
    multiple of the 'data' axis, and a ``batches`` iterator whose batch
    does not divide it raises ValueError, as the JAX trainer does; a
    'model' axis above 1 splits ``param_spec``'s leaves over each row of
    the mesh (``parallel/tensor.py``), the master and the optimizer's
    state staying whole on the first device. The discriminator of
    ``adversarial=True`` runs on the first device.

    ``adversarial=True`` adds the HiFi-GAN LSGAN objective: a MultiPeriod +
    MultiResolution discriminator (``HiFiGANDiscriminator(**disc_kwargs)``,
    the port's init seeded with ``seed + 1``) trains alongside the generator (``make_gan_train_step``) and
    checkpoints under ``{checkpoint_dir}/disc``, so resume continues both
    players. The optimizers: the global-norm clip (the random-init
    generator's exp() magnitudes reach O(1e4); unclipped, the first
    waveform-gradient step NaNs the decoder), then AdamW as optax.adamw."""
    check_dtype(model.config.dtype)
    dev = model_device(model)
    replicas = Replicas(model, mesh, master=master)
    master = replicas.master
    n_data = len(replicas.models)
    if mesh is not None:
        # the batch divides the data axis (as the serving engine rounds)
        rounded = -(-batch_size // n_data) * n_data
        if rounded != batch_size:
            logger.info("batch_size %d -> %d (multiple of %d-way data axis)",
                        batch_size, rounded, n_data)
            batch_size = rounded
    # the distillation teacher is the INITIAL model, frozen: copied before
    # any checkpoint restore so resume continues the original objective
    # instead of distilling the student against itself
    teacher = (copy.deepcopy(model).requires_grad_(False)
               if batches is None and not data_dir else None)
    was_training = model.training
    replicas.train()  # cuDNN's LSTM backward runs in training mode only
    for m in (*replicas.models, teacher):
        if m is not None:
            flatten_rnns(m)
    optimizer = adamw(replicas.params, learning_rate)
    start_step = 0
    if resume and checkpoint_dir:
        path = latest_checkpoint(checkpoint_dir)
        if path:
            start_step = restore_train_state(path, master, optimizer)
            replicas.sync()
            logger.info("resumed from %s (step %d)", path, start_step)

    if batches is None:
        if data_dir:
            # real data: spectral objective by default (waveform L1 is
            # phase-blind against recordings; see training/step.py)
            from .data import SpeechDataset, dataset_batches, prefetch

            dataset = SpeechDataset(
                data_dir, sample_rate=model.config.sample_rate,
                style_dim=2 * model.config.style_dim,
                samples_per_frame=model.config.samples_per_frame,
            )
            batches = prefetch(dataset_batches(
                dataset, batch_size, tokens, frames,
                model.config.samples_per_frame, seed=seed,
                vocab_size=model.config.albert.vocab_size,
            ))
            if spectral is None:
                spectral = True
        else:
            batches = synthetic_batches(model, teacher, batch_size, tokens,
                                        frames, seed=seed)
    d_optimizer = None
    if adversarial:
        from .discriminator import HiFiGANDiscriminator, init_disc_params

        disc = HiFiGANDiscriminator(**(disc_kwargs or {}))
        init_disc_params(disc, seed + 1)
        disc.to(dev)
        d_optimizer = adamw(list(disc.parameters()), disc_lr)
        if resume and checkpoint_dir:
            d_path = latest_checkpoint(f"{checkpoint_dir}/disc")
            if d_path:
                restore_train_state(d_path, disc, d_optimizer)
                logger.info("resumed discriminator from %s", d_path)
        step_fn = make_gan_train_step(replicas, disc, optimizer, d_optimizer,
                                      num_frames=frames,
                                      max_grad_norm=max_grad_norm)
    else:
        step_fn = make_train_step(replicas, optimizer, num_frames=frames,
                                  spectral=bool(spectral),
                                  max_grad_norm=max_grad_norm)

    def save(step):
        save_train_state(checkpoint_dir, step, master, optimizer)
        if adversarial:
            save_train_state(f"{checkpoint_dir}/disc", step, disc,
                             d_optimizer)

    metrics = {}
    last_saved = -1
    t0 = time.perf_counter()
    for step in range(start_step, start_step + steps):
        batch = next(batches)
        if batch.input_ids.shape[0] % n_data:
            # caller-supplied iterators bypass the batch_size rounding
            raise ValueError(
                f"batch dim {batch.input_ids.shape[0]} does not divide the "
                f"{n_data}-way 'data' mesh axis; yield TrainBatch with a "
                f"leading dim that is a multiple of {n_data}")
        metrics = step_fn(batch.to(dev))
        if log_every and (step + 1) % log_every == 0:
            m = {k: float(v) for k, v in metrics.items()}
            logger.info(
                "step %d: loss=%.4f dur=%.4f audio=%.4f%s (%.2f s/step)",
                step + 1, m["loss"], m["dur_loss"], m["audio_loss"],
                (" d=%.4f adv=%.4f" % (m["d_loss"], m["adv_loss"])
                 if "d_loss" in m else ""),
                (time.perf_counter() - t0) / log_every,
            )
            if on_metrics is not None:
                on_metrics(step + 1, m)
            t0 = time.perf_counter()
        if checkpoint_dir and checkpoint_every \
                and (step + 1) % checkpoint_every == 0:
            save(step + 1)
            last_saved = step + 1
    if checkpoint_dir and last_saved != start_step + steps:
        save(start_step + steps)
    replicas.train(False)
    model.train(was_training)
    return master, optimizer, {k: float(v) for k, v in metrics.items()}
