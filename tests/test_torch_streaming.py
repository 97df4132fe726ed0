# -*- coding: utf-8 -*-
"""PyTorch port: streaming decode and the mu-law formats against the JAX
package, on ``tiny_config`` with shared parameters (the JAX random init,
seed 123) and one shared voice, on the CPU.

- mu-law: the port's device encoder is bit-exact with ``mulaw_encode_np``
  for every int16 value, and with the JAX encoder on audio; the 24k -> 8k
  FIR agrees with JAX within 1e-6;
- windowed streaming: ``decode_prepare`` + ``decode_window`` and the
  crossfaded ``stream_decode(exact=False)`` chunks agree with JAX within
  1e-4 of the audio's peak (the stage-B tolerance of
  ``tests/test_torch_model.py``);
- exact streaming concatenates to the port's own ``collect()`` bit for bit;
- a mulaw8k batch expands to within one mu-law step of JAX's."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from illufly_tts_tpu.audio import telephony as jtel
from illufly_tts_tpu.engine.synthesizer import Synthesizer as JaxSynthesizer
from illufly_tts_tpu.model.kokoro import _fit_durations as jax_fit
from illufly_tts_tpu_torch.audio import telephony as tel
from illufly_tts_tpu_torch.engine.synthesizer import Synthesizer
from tests.test_model import tiny_config
from tests.test_torch_params import numpy_tree, port_config

torch.set_num_threads(2)

SEED = 123
FRAMES = 128
WINDOW, HALO = 32, 8          # model frames
TEXTS = ["ni→xau↓ma tsʰɤ↘ʂɨ↘" * 3, "ni→xau↓"]
VOICES = ["v", "v"]


@pytest.fixture(scope="module")
def engines():
    buckets = dict(token_buckets=(64,), frame_buckets=(FRAMES,))
    jsynth = JaxSynthesizer(tiny_config(), seed=SEED, **buckets)
    port = Synthesizer(port_config(), params=numpy_tree(jsynth.params),
                       device="cpu", **buckets)
    for s in (jsynth, port):
        s.register_random_voice("v", seed=1)
    return jsynth, port


def _scaled_close(port, ref, tol=1e-4):
    ref = np.asarray(ref)
    assert port.shape == ref.shape
    scale = np.abs(ref).max()
    assert scale > 0
    np.testing.assert_allclose(port / scale, ref / scale, atol=tol)


# ---- mu-law and the decimating FIR ----------------------------------------

def test_mulaw_encode_bit_exact_for_every_int16():
    x16 = np.arange(-32768, 32768).astype(np.int16)
    ref = tel.mulaw_encode_np(x16)
    np.testing.assert_array_equal(ref, jtel.mulaw_encode_np(x16))
    got = tel.mulaw_encode(torch.from_numpy(x16.astype(np.float32) / 32767.0))
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), ref)
    codes = np.arange(256, dtype=np.uint8)
    np.testing.assert_array_equal(tel.mulaw_decode_np(codes),
                                  jtel.mulaw_decode_np(codes))
    for dtype in (np.float32, np.int16):
        np.testing.assert_array_equal(tel.mulaw_lut(dtype),
                                      jtel.mulaw_lut(dtype))


def test_mulaw_encode_matches_jax_on_audio():
    audio = np.random.RandomState(0).randn(3, 4000).astype(np.float32) * 0.6
    got = tel.mulaw_encode(torch.from_numpy(audio)).numpy()
    np.testing.assert_array_equal(
        got, np.asarray(jtel.mulaw_encode(jnp.asarray(audio))))


def test_resample_to_8k_matches_jax():
    taps = tel.design_decimation_fir()
    np.testing.assert_array_equal(taps, jtel.design_decimation_fir())
    audio = np.random.RandomState(1).randn(2, 6000).astype(np.float32)
    got = tel.resample_to_8k(torch.from_numpy(audio), taps).numpy()
    ref = np.asarray(jtel.resample_to_8k(jnp.asarray(audio), taps))
    assert got.shape == ref.shape == (2, 2000)
    np.testing.assert_allclose(got, ref, atol=1e-6)


# ---- windowed streaming ----------------------------------------------------

@pytest.fixture(scope="module")
def prepared(engines):
    """Both models' decode_prepare on JAX's stage-A outputs."""
    jsynth, port = engines
    h = jsynth.dispatch(TEXTS, VOICES, fmt="f32")
    prep = jsynth._get_stage_prep(h.b_bucket, h.t_bucket, FRAMES)(
        jsynth.params, h.ids, h.mask, h.d, h.pred_dur, h.ref, h.pitch)
    t = {k: torch.from_numpy(np.array(v)) for k, v in dict(
        ids=h.ids, mask=h.mask, d=h.d,
        fitted=jax_fit(h.pred_dur, FRAMES), ref=h.ref, pitch=h.pitch).items()}
    with torch.no_grad():
        t_prep = port.model.decode_prepare(
            t["ids"].long(), t["mask"], t["d"], t["fitted"], t["ref"],
            FRAMES, pitch=t["pitch"])
    return h, prep, t_prep, t["ref"]


def test_decode_prepare_matches_jax(prepared):
    _, (x, f0_m, cum_rad, cur_mask), t_prep, _ = prepared
    t_x, t_f0, t_rad, t_mask = (t.numpy() for t in t_prep)
    _scaled_close(np.transpose(t_x, (0, 2, 1)), x)  # port: channels-first
    np.testing.assert_array_equal(t_mask, np.asarray(cur_mask))
    _scaled_close(t_f0, f0_m)
    _scaled_close(t_rad, cum_rad)


@pytest.mark.parametrize("window_index", [0, 2, 3])  # first, middle, last
def test_decode_window_matches_jax(engines, prepared, window_index):
    jsynth, port = engines
    h, prep, t_prep, t_ref = prepared
    start = window_index * 2 * WINDOW  # generator frames
    win_fn = jsynth._get_stage_window(h.b_bucket, 2 * WINDOW, 2 * HALO)
    ref = win_fn(jsynth.params, *prep, h.ref, jnp.int32(start))
    with torch.no_grad():
        got = port.model.decode_window(*t_prep, t_ref, start, 2 * WINDOW,
                                       2 * HALO)
    assert got.shape == (2, (WINDOW + HALO) * 600)
    _scaled_close(got.numpy(), ref)


def test_windowed_stream_matches_jax(engines):
    jsynth, port = engines
    hj = jsynth.dispatch(TEXTS, VOICES)
    hp = port.dispatch(TEXTS, VOICES)
    np.testing.assert_array_equal(hp.pred_dur.numpy(),
                                  np.asarray(hj.pred_dur))
    ref = list(jsynth.stream_decode(hj, WINDOW, HALO, exact=False))
    got = list(port.stream_decode(hp, WINDOW, HALO, exact=False))
    assert len(got) == len(ref) == FRAMES // WINDOW
    for g, r in zip(got, ref):
        assert g.dtype == np.float32
        _scaled_close(g, r)  # random weights: peaks near 1e4
    # the short row's masked tail stays silent
    stream = np.concatenate(got, axis=1)
    assert not stream[1, int(hp.fitted_totals[1]) * 600:].any()


def test_windowed_stream_checks_its_handle(engines):
    _, port = engines
    h = port.dispatch(TEXTS, VOICES)
    with pytest.raises(ValueError, match="must divide"):
        next(port.stream_decode(h, window_frames=48, exact=False))
    port.launch_decode(h)
    with pytest.raises(ValueError, match="already decoded"):
        next(port.stream_decode(h, WINDOW, HALO, exact=False))


# ---- exact streaming and the formats ---------------------------------------

@pytest.mark.parametrize("fmt", ["f32", "pcm16", "mulaw24k", "mulaw8k"])
def test_exact_stream_bitwise_equals_collect(engines, fmt):
    _, port = engines
    h = port.dispatch(TEXTS, VOICES, fmt=fmt)
    chunks = list(port.stream_decode(h, window_frames=WINDOW))
    assert len(chunks) == FRAMES // WINDOW
    stream = np.concatenate(chunks, axis=1)
    ref = port.collect(port.dispatch(TEXTS, VOICES, fmt=fmt))
    per_frame = 200 if fmt == "mulaw8k" else 600
    assert stream.dtype == (np.uint8 if fmt == "mulaw8k" else np.float32)
    for i, clip in enumerate(ref):
        assert clip.size == h.fitted_totals[i] * per_frame
        assert stream[i, : clip.size].tobytes() == clip.tobytes(), i
    # a handle streamed before is collected from the same render
    again = port.collect(h)
    for i, clip in enumerate(again):
        assert clip.tobytes() == ref[i].tobytes()


def test_mulaw8k_collect_matches_jax(engines):
    jsynth, port = engines
    ref = jsynth.collect(jsynth.dispatch(TEXTS, VOICES, fmt="mulaw8k"))
    got = port.collect(port.dispatch(TEXTS, VOICES, fmt="mulaw8k"))
    # rank of each code on the ordered 256-level grid: neighbouring ranks
    # are one mu-law step apart
    rank = np.argsort(np.argsort(tel.mulaw_lut(np.float32), kind="stable"),
                      kind="stable")
    for g, r in zip(got, ref):
        assert g.dtype == np.uint8 and g.shape == np.asarray(r).shape
        steps = np.abs(rank[g].astype(np.int64)
                       - rank[np.asarray(r)].astype(np.int64))
        assert np.mean(steps <= 1) >= 0.999, np.mean(steps <= 1)


def test_mulaw24k_collect_is_the_pcm16_render_companded(engines):
    """The device's mulaw24k bytes are mulaw_encode_np of the device's own
    int16 rendering (same peak policy, same clip, same rounding)."""
    _, port = engines
    h = port.dispatch(TEXTS, VOICES, fmt="mulaw24k")
    args = (h.ids, h.mask, h.d, h.pred_dur, h.ref, h.pitch, FRAMES)
    with torch.no_grad():
        codes, _ = port._stage_b(*args, "mulaw24k")
        pcm, _ = port._stage_b(*args, "pcm16")
    assert codes.dtype == torch.uint8 and pcm.dtype == torch.int16
    np.testing.assert_array_equal(codes.numpy(),
                                  tel.mulaw_encode_np(pcm.numpy()))
