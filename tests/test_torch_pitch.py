# -*- coding: utf-8 -*-
"""PyTorch port: the pitch knob (``tests/test_pitch.py``).

Every case of that suite that goes through the engine, the pipeline, the
scheduler or the HTTP surface runs again on the port's (the engine on the
CPU, ``tiny_config`` as the port's config), its ``slow`` case among them:
a mixed-pitch batch renders row for row as its uniform batches. The two
cases that call the flax model directly get port counterparts here with
the same assertions on the port's ``KokoroModel``, and the F0 contour
``decode_prepare`` returns under pitch 2 is held to JAX's on the same
parameters. Pitch is not compared by waveform against JAX: a voiced
source makes the random Generator chaotic across frameworks."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from illufly_tts_tpu.engine.synthesizer import Synthesizer as JaxSynthesizer
from illufly_tts_tpu.model.kokoro import KokoroModel as JaxModel
from illufly_tts_tpu_torch.api import jwt_hs256 as port_jwt
from illufly_tts_tpu_torch.model.kokoro import KokoroModel
from illufly_tts_tpu_torch.model.params import load_flax_params
from tests import test_api
from tests import test_pitch as jax_cases
from tests import torch_port_cases as port_cases
from tests.test_model import tiny_config
from tests.test_torch_params import numpy_tree, port_config

torch.set_num_threads(2)

DIRECT = ("test_pitch_scales_f0_exactly",
          "test_pitch_changes_audio_and_neutral_matches_default")
CASES = port_cases.collect(jax_cases, exclude=DIRECT, include_slow=True)


def test_all_pitch_cases_collected():
    assert len(CASES) == 4, sorted(CASES)
    assert "test_engine_dispatch_pitch" in CASES


@pytest.mark.parametrize("case", sorted(CASES))
def test_pitch_case_on_the_port(case, monkeypatch):
    from illufly_tts_tpu_torch.api import auth as port_auth

    port_cases.use_port_engine(monkeypatch, jax_cases, ("tiny_config",), {
        f"illufly_tts_tpu.{name}": f"illufly_tts_tpu_torch.{name}"
        for name in ("api.auth", "api.dev_mode", "api.endpoints",
                     "api.jwt_hs256")})
    # the HTTP case signs its bearer token with tests/test_api.py's helper
    monkeypatch.setattr(test_api, "jwt", port_jwt)
    monkeypatch.setattr(test_api, "create_access_token",
                        port_auth.create_access_token)
    port_cases.run(jax_cases, CASES[case])


# ---- the flax-model cases, on the port's KokoroModel ----------------------

@pytest.fixture(scope="module")
def models():
    """The inputs of the suite's ``_tiny_model_and_inputs`` (its ids,
    mask, voices, stage-A ``d`` and unit durations at 16 frames) on the
    JAX engine's random parameters (a host-side init: the flax init the
    suite runs takes tens of seconds on the CPU), and the port's model on
    the same parameters."""
    jsynth = JaxSynthesizer(tiny_config(), seed=0)
    jmodel, params = jsynth.model, jsynth.params
    cfg, (batch, tokens, frames) = tiny_config(), (2, 12, 16)
    rng = np.random.RandomState(0)
    ids = jnp.asarray(
        rng.randint(1, cfg.albert.vocab_size, (batch, tokens)), jnp.int32)
    mask = jnp.ones((batch, tokens), jnp.float32)
    ref = jnp.asarray(
        (rng.randn(batch, 2 * cfg.style_dim) * 0.2).astype(np.float32))
    _, d = jax.jit(lambda p: jmodel.apply(
        p, ids, mask, ref, jnp.ones((batch,), jnp.float32),
        method=JaxModel.encode_durations))(params)
    pred = jnp.ones((batch, tokens), jnp.int32)
    port = KokoroModel(port_config()).eval()
    load_flax_params(port, numpy_tree(params))
    t = {k: torch.from_numpy(np.array(v)) for k, v in dict(
        ids=ids, mask=mask, d=d, pred=pred, ref=ref).items()}
    t["ids"] = t["ids"].long()
    return (jmodel, params, (ids, mask, d, pred, ref, frames)), (port, t,
                                                                 frames)


def _prepare(port, t, frames, pitch):
    batch = t["ids"].shape[0]
    with torch.no_grad():
        return port.decode_prepare(
            t["ids"], t["mask"], t["d"], t["pred"], t["ref"], frames,
            pitch=(None if pitch is None
                   else torch.full((batch,), pitch)))


def test_pitch_scales_f0_exactly(models):
    """``test_pitch.py::test_pitch_scales_f0_exactly`` on the port: the F0
    contour under pitch 2 is 2x the neutral one, and None == 1.0."""
    _, (port, t, frames) = models
    f0_neutral = _prepare(port, t, frames, 1.0)[1].numpy()
    f0_double = _prepare(port, t, frames, 2.0)[1].numpy()
    np.testing.assert_allclose(f0_double, 2.0 * f0_neutral, rtol=1e-6)
    np.testing.assert_array_equal(_prepare(port, t, frames, None)[1].numpy(),
                                  f0_neutral)


@pytest.mark.parametrize("pitch", [1.0, 2.0, 0.7])
def test_pitched_f0_contour_matches_jax(models, pitch):
    """``decode_prepare``'s masked F0 under ``pitch``, port against JAX on
    the same parameters and inputs (the tolerance of
    ``tests/test_torch_streaming.py::test_decode_prepare_matches_jax``)."""
    (jmodel, params, (ids, mask, d, pred, ref, frames)), (port, t, _) = models
    batch = ids.shape[0]
    _, f0_ref, _, _ = jax.jit(lambda p: jmodel.apply(
        p, ids, mask, d, pred, ref, frames,
        pitch=jnp.full((batch,), pitch, jnp.float32),
        method=JaxModel.decode_prepare))(params)
    f0_ref = np.asarray(f0_ref)
    f0 = _prepare(port, t, frames, pitch)[1].numpy()
    scale = np.abs(f0_ref).max()
    assert scale > 0
    np.testing.assert_allclose(f0 / scale, f0_ref / scale, atol=1e-4)


def test_pitch_changes_audio_and_neutral_matches_default(models):
    """``test_pitch.py::test_pitch_changes_audio_and_neutral_matches_default``
    on the port: pitch None and 1.0 render the same bits, 1.5 another
    waveform."""
    _, (port, t, frames) = models
    batch = t["ids"].shape[0]

    def decode(pitch):
        with torch.no_grad():
            audio, _ = port.decode_frames(
                t["ids"], t["mask"], t["d"], t["pred"], t["ref"], frames,
                pitch=(None if pitch is None
                       else torch.full((batch,), pitch)))
        return audio.numpy()

    base = decode(None)
    np.testing.assert_array_equal(base, decode(1.0))
    assert np.abs(decode(1.5) - base).max() > 0
