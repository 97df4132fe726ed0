# -*- coding: utf-8 -*-
"""PyTorch port: one adversarial step against the JAX package on the CPU
(``small_config``, the JAX random init, a random target waveform, as in
``tests/test_torch_training.py``).

- One GAN step (``make_gan_train_step``) with the JAX discriminator's
  initial weights carried over by the bridge: ``d_loss``, the clipped
  discriminator gradients of the D step (1e-3 relative L2 per leaf) and
  ``g_loss`` against the refreshed discriminator (1e-4 relative), each
  computed in JAX from the same parts the JAX step uses."""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.flatten_util import ravel_pytree

from illufly_tts_tpu.audio import mel_jax
from illufly_tts_tpu.training import discriminator as jax_disc
from illufly_tts_tpu.training import step as jax_step
from illufly_tts_tpu_torch.model.params import trainable_parameters
from illufly_tts_tpu_torch.training import discriminator as port_disc
from illufly_tts_tpu_torch.training import step as port_step
from tests.test_parity_torch import small_config
from tests.test_torch_training import (
    FRAMES,
    JaxModel,
    _batch,
    init_params,
    leaves,
    port_batch,
    port_model,
    rel_l2,
)

torch.set_num_threads(2)

DISC = dict(periods=(2, 3), resolutions=((128, 32), (256, 64)),
            base_channels=8, max_channels=32)
LR, DISC_LR = 1e-4, 2e-4


@pytest.fixture(scope="module")
def setup():
    jcfg = small_config()
    return jcfg, init_params(jcfg), _batch(jcfg, seed=1)


def _clip(tree):
    """``optax.clip_by_global_norm(1.0)`` of a tree."""
    flat, unravel = ravel_pytree(tree)
    clipped, _ = optax.clip_by_global_norm(1.0).update(flat, None)
    return unravel(clipped)


def test_one_gan_step_matches_jax(setup):
    jcfg, params, arrays = setup
    jmodel = JaxModel(jcfg)
    jbatch = jax_step.TrainBatch(*map(jnp.asarray, arrays))
    fake, real, dur_loss = jax.jit(
        lambda p, b: jax_step._teacher_forced_audio(jmodel, FRAMES, p, b))(
        params, jbatch)
    disc = jax_disc.HiFiGANDiscriminator(**DISC)
    d_params = disc.init(jax.random.PRNGKey(1), real)

    def d_loss_fn(d, fake, real):
        f_logits, _ = disc.apply(d, fake)
        r_logits, _ = disc.apply(d, real)
        return jax_disc.discriminator_loss(r_logits, f_logits)

    d_loss, d_grads = jax.jit(jax.value_and_grad(d_loss_fn))(
        d_params, fake, real)
    d_grads = _clip(d_grads)
    opt = optax.adamw(DISC_LR)
    flat_d, unravel = ravel_pytree(d_params)
    upd, _ = opt.update(ravel_pytree(d_grads)[0], opt.init(flat_d), flat_d)
    d_new = unravel(optax.apply_updates(flat_d, upd))

    @jax.jit
    def g_loss_fn(d, fake, real, dur_loss):
        f_logits, f_feats = disc.apply(d, fake)
        _, r_feats = disc.apply(d, real)
        return (dur_loss + 45.0 * mel_jax.mel_l1(fake, real, jcfg.sample_rate)
                + 0.5 * mel_jax.multi_res_stft_loss(fake, real)
                + jax_disc.generator_adv_loss(f_logits)
                + 2.0 * jax_disc.feature_matching_loss(r_feats, f_feats))

    g_loss = float(g_loss_fn(d_new, fake, real, dur_loss))

    model = port_model(jcfg, params)
    pdisc = port_disc.HiFiGANDiscriminator(**DISC)
    port_disc.load_flax_disc_params(pdisc, d_params)
    step = port_step.make_gan_train_step(
        model, pdisc, port_step.adamw(trainable_parameters(model), LR),
        port_step.adamw(list(pdisc.parameters()), DISC_LR), FRAMES)
    metrics = step(port_batch(arrays))
    assert abs(float(metrics["d_loss"]) - float(d_loss)) <= 1e-4 * float(
        d_loss)
    ours = leaves(port_disc.export_flax_disc_params(pdisc, grads=True))
    ref = leaves(d_grads)
    assert ours.keys() == ref.keys() and len(ref) == 2 * (2 * 6 + 2 * 5)
    for key, g in ref.items():
        assert rel_l2(ours[key], g) <= 1e-3, key
    assert abs(float(metrics["loss"]) - g_loss) <= 1e-4 * g_loss
    for key in ("dur_loss", "mel_l1", "stft_loss", "adv_loss", "fm_loss"):
        assert np.isfinite(float(metrics[key])), key


def test_disc_bridge_round_trips_and_matches_jax_logits(setup):
    """The bridge places every flax leaf; the port's discriminator scores a
    waveform as the flax one does (the ``SAME`` padding at even and odd
    sizes, the reflect pad of a period that does not divide the length)."""
    disc = jax_disc.HiFiGANDiscriminator(**DISC)
    x = np.random.RandomState(2).randn(2, 2501).astype(np.float32) * 0.1
    d_params = disc.init(jax.random.PRNGKey(3), jnp.asarray(x))
    pdisc = port_disc.HiFiGANDiscriminator(**DISC)
    port_disc.load_flax_disc_params(pdisc, d_params)
    back = leaves(port_disc.export_flax_disc_params(pdisc))
    for key, leaf in leaves(d_params).items():
        np.testing.assert_array_equal(back[key], leaf, err_msg=key)
    logits, feats = disc.apply(d_params, jnp.asarray(x))
    with torch.no_grad():
        p_logits, p_feats = pdisc(torch.from_numpy(x))
    for a, b in zip(p_logits, logits):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4,
                                   atol=1e-5)
    for fa, fb in zip(p_feats, feats):
        for a, b in zip(fa, fb):  # NCHW against NHWC
            np.testing.assert_allclose(a.permute(0, 2, 3, 1).numpy(),
                                       np.asarray(b), rtol=1e-4, atol=1e-5)
    with pytest.raises(ValueError, match="unmapped"):
        tree = {"params": dict(d_params["params"], bogus={"kernel": x})}
        port_disc.load_flax_disc_params(pdisc, tree)
