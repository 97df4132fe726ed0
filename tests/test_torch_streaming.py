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
- at speed != 1 the windowed stream still agrees with JAX's; at pitch != 1
  (where a voiced source would make the random Generator chaotic across
  frameworks) the prepared F0 contour agrees with JAX's and the engine's
  chunks equal, bit for bit, ``parent_windowed_stream``: the loop over
  ``decode_prepare`` / ``decode_window`` with host-int starts and blocking
  copies that the engine ran before its stages became graphs;
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
from illufly_tts_tpu_torch.model.kokoro import _fit_durations
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


def parent_windowed_stream(synth, handle, window_frames, halo_frames):
    """The windowed stream as the engine ran it eagerly: ``decode_prepare``
    once, then per window ``decode_window`` with a host-int start, a
    blocking copy to the host and the linear crossfade. -> the chunks."""
    f_bucket = synth._pick_f_bucket(handle)
    net = synth.net
    with torch.inference_mode():
        prep = net.decode_prepare(
            handle.ids, handle.mask, handle.d,
            _fit_durations(handle.pred_dur, f_bucket), handle.ref, f_bucket,
            pitch=handle.pitch)
    spf = synth.config.samples_per_frame
    overlap = halo_frames * spf
    ramp = np.linspace(0.0, 1.0, overlap, dtype=np.float32)[None, :]
    max_total = int(handle.fitted_totals[: handle.n].max())
    body = window_frames * spf
    prev_tail, chunks = None, []
    for emitted in range(0, max_total, window_frames):
        with torch.inference_mode():
            audio = net.decode_window(*prep, handle.ref, 2 * emitted,
                                      2 * window_frames, 2 * halo_frames)
        chunk = audio.float().cpu().numpy()
        out = chunk[:, :body].copy()
        if prev_tail is not None:
            out[:, :overlap] = (prev_tail * (1.0 - ramp)
                                + out[:, :overlap] * ramp)
        prev_tail = chunk[:, body: body + overlap]
        frames_here = min(window_frames, max_total - emitted)
        chunks.append(out[: handle.n, : frames_here * spf])
    return chunks


@pytest.mark.parametrize("speeds", [[0.8, 1.3], [1.25, 1.25]])
def test_windowed_stream_at_speed_matches_jax(engines, speeds):
    """Speed scales stage A's durations, and so the frames every window
    renders: both engines' windowed streams on one speed-scaled batch."""
    jsynth, port = engines
    hj = jsynth.dispatch(TEXTS, VOICES, speeds=speeds)
    hp = port.dispatch(TEXTS, VOICES, speeds=speeds)
    np.testing.assert_array_equal(hp.pred_dur.numpy(),
                                  np.asarray(hj.pred_dur))
    base = port.dispatch(TEXTS, VOICES)
    assert (hp.pred_dur.numpy() != base.pred_dur.numpy()).any()
    ref = list(jsynth.stream_decode(hj, WINDOW, HALO, exact=False))
    got = list(port.stream_decode(hp, WINDOW, HALO, exact=False))
    assert [g.shape for g in got] == [np.asarray(r).shape for r in ref]
    for g, r in zip(got, ref):
        _scaled_close(g, r)


def test_windowed_stream_at_pitch(engines):
    """Pitch scales the F0 contour ``decode_prepare`` hands the windows:
    held to JAX's there; the chunks, voiced or not, to the port's eager
    loop bit for bit."""
    jsynth, port = engines
    pitches = [1.6, 0.7]
    hj = jsynth.dispatch(TEXTS, VOICES, pitches=pitches)
    hp = port.dispatch(TEXTS, VOICES, pitches=pitches)
    np.testing.assert_array_equal(hp.pred_dur.numpy(),
                                  np.asarray(hj.pred_dur))
    _, f0_ref, _, _ = jsynth._get_stage_prep(hj.b_bucket, hj.t_bucket,
                                             FRAMES)(
        jsynth.params, hj.ids, hj.mask, hj.d, hj.pred_dur, hj.ref, hj.pitch)
    with torch.inference_mode():
        _, f0, _, _ = port.net.decode_prepare(
            hp.ids, hp.mask, hp.d, _fit_durations(hp.pred_dur, FRAMES),
            hp.ref, FRAMES, pitch=hp.pitch)
    _scaled_close(f0.numpy(), f0_ref)
    neutral = port.dispatch(TEXTS, VOICES)
    with torch.inference_mode():
        f0_neutral = port.net.decode_prepare(
            neutral.ids, neutral.mask, neutral.d,
            _fit_durations(neutral.pred_dur, FRAMES), neutral.ref,
            FRAMES)[1]
    np.testing.assert_allclose(
        f0.numpy(), f0_neutral.numpy() * np.array(pitches)[:, None],
        rtol=1e-6)
    want = parent_windowed_stream(port, port.dispatch(
        TEXTS, VOICES, pitches=pitches), WINDOW, HALO)
    got = list(port.stream_decode(hp, WINDOW, HALO, exact=False))
    assert len(got) == len(want) == FRAMES // WINDOW
    for g, w in zip(got, want):
        assert g.tobytes() == w.tobytes()


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
