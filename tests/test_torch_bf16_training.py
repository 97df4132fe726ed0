# -*- coding: utf-8 -*-
"""PyTorch port: training a bfloat16 model against the JAX package's
bfloat16 training, on the CPU.

The JAX trainer keeps float32 parameters and computes in bfloat16 (flax's
``param_dtype``/``dtype``). The port steps float32 master weights
(``parallel/replicas.py``) and computes on a bfloat16 copy. Both start from
the JAX random init of ``small_config`` on the step-0 batch of
``tests/test_torch_training.py``. Given those float32 weights
(``train(..., master=)``), the port's master starts from them, as JAX's
``params`` do; without them it starts from the bfloat16 model's own, which
holds them rounded but for its float32 islands.

Tolerances follow ``tests/test_torch_bf16.py``: the port's bfloat16
against JAX's bfloat16 within twice JAX's own bfloat16-vs-float32 distance
(``RATIO``), which holds whenever the port's bfloat16 is no farther from
float32 than JAX's (triangle inequality), for

- the step's forward: the teacher-forced audio and durations (relative L2);
- its losses, in the loss's own units: the waveform L1 moves by at most
  the mean |audio difference|, so its bound is twice JAX's mean |bf16 -
  f32 audio| (the L1 against a random target moves by ~1% under any
  bfloat16 rounding, and which of the two lands nearer float32 varies from
  batch to batch: audio loss port / JAX bf16 minus float32, +0.029 /
  -0.012 on this batch), and the duration MSE by twice JAX's own;
- the gradients over the leaves that are no stable number in neither
  precision left out (``DEGENERATE``), relative L2 over the whole tree
  (measured: 0.87 port-vs-JAX against 1.05 JAX's own);
- one clipped AdamW step: the share of entries whose update differs by
  more than 1e-3 of the learning rate (Adam's first step is g / |g|, so
  those are the entries whose gradient changed sign);
- ``adapt_voice`` (3 steps, the style vector float32 in both): the
  returned style and the best loss.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.flatten_util import ravel_pytree

from illufly_tts_tpu.training import voice_adapt as jax_va
from illufly_tts_tpu_torch.model.kokoro import KokoroModel
from illufly_tts_tpu_torch.model.params import (
    export_flax_params,
    load_flax_params,
)
from illufly_tts_tpu_torch.parallel.replicas import Replicas
from illufly_tts_tpu_torch.training import loop
from illufly_tts_tpu_torch.training import step as port_step
from illufly_tts_tpu_torch.training import voice_adapt as port_va
from illufly_tts_tpu_torch.training.checkpoint import STATE_FILE
from tests.test_parity_torch import small_config
from tests.test_torch_params import port_config
from tests.test_torch_training import (
    DEGENERATE,
    FRAMES,
    LR,
    JaxModel,
    _batch,
    init_params,
    jax_step,
    leaves,
    port_batch,
)
from tests.test_torch_voice_adapt import (
    B as VA_B,
    FRAMES as VA_FRAMES,
    LR as VA_LR,
    TOKENS as VA_TOKENS,
    _jax_batches,
    _port_batches,
)

torch.set_num_threads(2)

BF16 = torch.bfloat16
RATIO = 2.0


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _bf16_model(jcfg, params) -> KokoroModel:
    model = KokoroModel(dataclasses.replace(port_config(jcfg), dtype=BF16))
    load_flax_params(model, params)
    return model


def _flat(grads: dict) -> np.ndarray:
    """The leaves that are stable numbers, raveled in key order."""
    return np.concatenate([grads[k].ravel() for k in sorted(grads)
                           if not DEGENERATE.search(k)])


@pytest.fixture(scope="module")
def jax_side():
    """JAX's loss, metrics, gradients and teacher-forced outputs in float32
    and bfloat16 on the same parameters and batch."""
    jcfg = small_config()
    params = init_params(jcfg)
    arrays = _batch(jcfg)
    jbatch = jax_step.TrainBatch(*map(jnp.asarray, arrays))
    out = {}
    for name, dtype in (("f32", jnp.float32), ("bf16", jnp.bfloat16)):
        jmodel = JaxModel(dataclasses.replace(jcfg, dtype=dtype))

        def step0(params, batch):
            (loss, metrics), grads = jax.value_and_grad(
                jax_step.make_loss_fn(jmodel, FRAMES), has_aux=True)(
                params, batch)
            duration, _ = jmodel.apply(
                params, batch.input_ids, batch.mask, batch.ref_s,
                jnp.ones((batch.input_ids.shape[0],), jnp.float32),
                method=type(jmodel).encode_durations)
            audio, _, _ = jax_step._teacher_forced_audio(jmodel, FRAMES,
                                                         params, batch)
            return loss, metrics, grads, duration, audio

        loss, metrics, grads, duration, audio = jax.jit(step0)(params,
                                                               jbatch)
        out[name] = {"loss": float(loss),
                     "metrics": {k: float(v) for k, v in metrics.items()},
                     "grads": leaves(grads), "tree": grads,
                     "duration": np.asarray(duration, np.float32),
                     "audio": np.asarray(audio, np.float32)}
    return jcfg, params, arrays, out


@pytest.fixture(scope="module")
def port_side(jax_side):
    """The port's bfloat16 step 0: loss, metrics and the master's
    gradients (through ``Replicas``), and its teacher-forced outputs."""
    jcfg, params, arrays, _ = jax_side
    model = _bf16_model(jcfg, params)
    replicas = Replicas(model)
    replicas.train()
    loss, metrics = port_step.make_loss_fn(replicas, FRAMES)(
        port_batch(arrays))
    loss.backward()
    replicas.reduce_grads()
    grads = leaves(export_flax_params(replicas.master, grads=True))
    batch = port_batch(arrays)
    with torch.no_grad():
        audio, sample_mask, _ = port_step.teacher_forced_audio(
            model, FRAMES, batch)
        duration, _ = model.encode_durations(
            batch.input_ids, batch.mask, batch.ref_s,
            torch.ones(batch.input_ids.shape[0]))
    return {"loss": float(loss.detach()), "grads": grads,
            "replicas": replicas,
            "metrics": {k: float(v) for k, v in metrics.items()},
            "audio": (audio * sample_mask).float().numpy(),
            "duration": duration.float().numpy()}


def test_bf16_step_forward_within_jax_bf16_spread(jax_side, port_side):
    _, _, _, j = jax_side
    for key in ("audio", "duration"):
        ours = _rel(port_side[key], j["bf16"][key])
        theirs = _rel(j["bf16"][key], j["f32"][key])
        assert ours <= RATIO * theirs, (key, ours, theirs)


def test_bf16_step_losses_within_jax_bf16_spread(jax_side, port_side):
    _, _, _, j = jax_side
    ours, theirs = port_side["metrics"], j["bf16"]["metrics"]
    assert ours.keys() == theirs.keys()
    audio_l1 = float(np.mean(np.abs(j["bf16"]["audio"] - j["f32"]["audio"])))
    assert abs(ours["audio_loss"] - theirs["audio_loss"]) <= RATIO * audio_l1
    dur_spread = abs(theirs["dur_loss"] - j["f32"]["metrics"]["dur_loss"])
    assert abs(ours["dur_loss"] - theirs["dur_loss"]) <= RATIO * dur_spread
    assert port_side["loss"] == pytest.approx(
        ours["dur_loss"] + ours["audio_loss"], rel=1e-6)


def test_bf16_gradients_within_jax_bf16_spread(jax_side, port_side):
    """The master's float32 gradients, reduced from the bfloat16 replica,
    against JAX's bfloat16 gradients; the bf16 conv weights, packed for
    the kernels at every training call, get theirs."""
    _, _, _, j = jax_side
    ours = port_side["grads"]
    assert ours.keys() == j["bf16"]["grads"].keys()
    dist = _rel(_flat(ours), _flat(j["bf16"]["grads"]))
    spread = _rel(_flat(j["bf16"]["grads"]), _flat(j["f32"]["grads"]))
    assert dist <= RATIO * spread, (dist, spread)
    replicas = port_side["replicas"]
    assert all(p.grad.dtype == torch.float32 for p in replicas.params)
    conv = replicas.master.decoder.generator.res_0_0.conv1_0.weight
    assert conv.grad.abs().sum() > 0


def test_bf16_train_step_on_float32_masters(jax_side):
    """One ``train`` step: the master stays float32 and is not the bfloat16
    model, which holds the master rounded afterwards; the update's entries
    that differ from JAX's bfloat16 update are at most twice as many as
    between JAX's bfloat16 and float32 updates."""
    jcfg, params, arrays, j = jax_side
    model = _bf16_model(jcfg, params)
    before = leaves(export_flax_params(model))
    master, optimizer, metrics = loop.train(
        model, steps=1, frames=FRAMES, learning_rate=LR, log_every=0,
        batches=iter([port_batch(arrays)]))
    assert master is not model
    assert all(p.dtype == torch.float32 for p in master.parameters())
    assert {p.dtype for p in model.parameters()} == {BF16, torch.float32}
    held = {id(p) for g in optimizer.param_groups for p in g["params"]}
    assert held == {id(p) for p in master.parameters() if p.requires_grad}
    for p, m in zip(model.parameters(), master.parameters()):
        torch.testing.assert_close(p, m.to(p.dtype), rtol=0, atol=0)
    after = leaves(export_flax_params(master))
    opt = optax.chain(optax.clip_by_global_norm(1.0), optax.adamw(LR))
    flat_p = ravel_pytree(params)[0]
    updates = {}
    for name in ("f32", "bf16"):
        flat_g, unravel = ravel_pytree(j[name]["tree"])
        upd, _ = opt.update(flat_g, opt.init(flat_p), flat_p)
        updates[name] = _flat(leaves(unravel(upd))) / LR
    ours = _flat({k: after[k] - before[k] for k in after}) / LR
    n_ours = int((np.abs(ours - updates["bf16"]) > 1e-3).sum())
    n_theirs = int((np.abs(updates["bf16"] - updates["f32"]) > 1e-3).sum())
    assert n_theirs > 0 and n_ours <= RATIO * n_theirs, (n_ours, n_theirs)
    assert np.isfinite(metrics["loss"])


def _float32_source(kind, jcfg, params):
    if kind == "model":
        model = KokoroModel(port_config(jcfg))
        load_flax_params(model, params)
        return model
    return params if kind == "tree" else None


@pytest.mark.parametrize("source", [None, "tree", "model"])
def test_bf16_master_starts_from_float32_weights(jax_side, source):
    """At learning rate 0 ``train`` returns the master as it started:
    given the float32 weights (a flax tree or a float32 model), exactly
    them, and the bfloat16 model holds them rounded; without them, the
    bfloat16 model's own weights, rounded from them."""
    jcfg, params, arrays, _ = jax_side
    model = _bf16_model(jcfg, params)
    rounded = leaves(export_flax_params(model))
    master, _, metrics = loop.train(
        model, steps=1, frames=FRAMES, learning_rate=0.0, log_every=0,
        batches=iter([port_batch(arrays)]),
        master=_float32_source(source, jcfg, params))
    want = rounded if source is None else leaves(params)
    got = leaves(export_flax_params(master))
    assert got.keys() == want.keys()
    for name in want:
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)
    assert any(not np.array_equal(rounded[k], leaves(params)[k])
               for k in rounded)
    for p, m in zip(model.parameters(), master.parameters()):
        torch.testing.assert_close(p, m.to(p.dtype), rtol=0, atol=0)
    assert np.isfinite(metrics["loss"])


def test_bf16_master_source_refused_for_float32():
    model = KokoroModel(port_config())
    with pytest.raises(ValueError, match="its own master"):
        Replicas(model, master=export_flax_params(model))


def test_bf16_train_step_from_float32_weights(jax_side):
    """One ``train`` step from the float32 weights (``master=``) against
    JAX's bfloat16 step from the same ``params``: the update's entries that
    differ are at most twice as many as between JAX's bfloat16 and float32
    updates (the rule of ``test_bf16_train_step_on_float32_masters``)."""
    jcfg, params, arrays, j = jax_side
    master, _, metrics = loop.train(
        _bf16_model(jcfg, params), steps=1, frames=FRAMES, learning_rate=LR,
        log_every=0, batches=iter([port_batch(arrays)]), master=params)
    before, after = leaves(params), leaves(export_flax_params(master))
    opt = optax.chain(optax.clip_by_global_norm(1.0), optax.adamw(LR))
    flat_p = ravel_pytree(params)[0]
    updates = {}
    for name in ("f32", "bf16"):
        flat_g, unravel = ravel_pytree(j[name]["tree"])
        upd, _ = opt.update(flat_g, opt.init(flat_p), flat_p)
        updates[name] = _flat(leaves(unravel(upd))) / LR
    ours = _flat({k: after[k] - before[k] for k in after}) / LR
    n_ours = int((np.abs(ours - updates["bf16"]) > 1e-3).sum())
    n_theirs = int((np.abs(updates["bf16"] - updates["f32"]) > 1e-3).sum())
    assert n_theirs > 0 and n_ours <= RATIO * n_theirs, (n_ours, n_theirs)
    assert np.isfinite(metrics["loss"])


def test_bf16_checkpoint_resumes(jax_side, tmp_path):
    """A bfloat16 run checkpoints its float32 masters; step 2 after a
    restore from step 1's checkpoint gives the uninterrupted run's loss,
    exactly."""
    jcfg, params, _, _ = jax_side
    batches = [port_batch(_batch(jcfg, seed=20 + i)) for i in range(2)]

    def run(steps, part, **kw):
        losses = []
        master, _, _ = loop.train(
            _bf16_model(jcfg, params), steps=steps, frames=FRAMES,
            learning_rate=LR, log_every=1, batches=iter(part),
            on_metrics=lambda step, m: losses.append((step, m["loss"])),
            **kw)
        return master, losses

    whole_master, whole = run(2, batches)
    ckpt = str(tmp_path / "ckpt")
    first, _ = run(1, batches[:1], checkpoint_dir=ckpt, checkpoint_every=1)
    saved = torch.load(f"{ckpt}/step_00000001/{STATE_FILE}",
                       weights_only=True)["params"]
    for name, p in first.state_dict().items():
        assert saved[name].dtype == p.dtype == torch.float32, name
        torch.testing.assert_close(saved[name], p, rtol=0, atol=0)
    resumed_master, resumed = run(1, batches[1:], checkpoint_dir=ckpt,
                                  resume=True, checkpoint_every=0)
    assert resumed == whole[1:]
    for p, q in zip(resumed_master.parameters(), whole_master.parameters()):
        torch.testing.assert_close(p, q, rtol=0, atol=0)


def test_bf16_adapt_voice_within_jax_bf16_spread():
    """3 ``adapt_voice`` steps (the fixture of
    ``tests/test_torch_voice_adapt.py``) with a bfloat16 model in both
    packages: the style and the best loss within twice JAX's own
    bfloat16-vs-float32 distance (measured: style 4.75 lr against 5.28 lr,
    best loss 1.47 against 1.17)."""
    jcfg = small_config()
    params = init_params(jcfg)
    target = (np.random.RandomState(7).randn(2 * jcfg.style_dim) * 0.3
              ).astype(np.float32)
    gen = jax_va.rendered_batches(JaxModel(jcfg), params,
                                  jnp.asarray(target), VA_B, VA_TOKENS,
                                  VA_FRAMES, seed=1)
    batches = [tuple(np.asarray(t) for t in next(gen)) for _ in range(3)]
    init = (np.random.RandomState(9).randn(2 * jcfg.style_dim) * 0.1
            ).astype(np.float32)
    kw = dict(steps=3, learning_rate=VA_LR, frames=VA_FRAMES, init=init,
              spectral=False, log_every=0)
    jax_out = {name: jax_va.adapt_voice(
        JaxModel(dataclasses.replace(jcfg, dtype=dtype)), params,
        _jax_batches(batches), **kw)
        for name, dtype in (("f32", jnp.float32), ("bf16", jnp.bfloat16))}
    model = _bf16_model(jcfg, params)
    style, metrics = port_va.adapt_voice(model, _port_batches(batches), **kw)
    assert style.dtype == np.float32 and np.isfinite(style).all()
    assert not any(p.requires_grad for p in model.parameters())
    (s16, m16), (s32, m32) = jax_out["bf16"], jax_out["f32"]
    assert np.linalg.norm(style - s16) <= RATIO * np.linalg.norm(s16 - s32)
    assert abs(metrics["best_loss"] - m16["best_loss"]) <= RATIO * abs(
        m16["best_loss"] - m32["best_loss"])
    assert np.abs(style - init).max() > 0.5 * VA_LR  # the style moved


@pytest.mark.parametrize("entry", ["train", "adapt_voice"])
def test_float16_training_raises(entry):
    """float16 still raises (``check_dtype``), for a model whose config
    was switched after it was built."""
    model = KokoroModel(port_config())
    model.config = dataclasses.replace(model.config, dtype=torch.float16)
    with pytest.raises(NotImplementedError, match="float32 or bfloat16"):
        if entry == "train":
            loop.train(model, steps=1, batch_size=1, tokens=8, frames=8)
        else:
            port_va.adapt_voice(model, iter(()), steps=1)
