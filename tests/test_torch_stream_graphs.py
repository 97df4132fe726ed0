# -*- coding: utf-8 -*-
"""PyTorch port: the windowed stream as the JAX engine runs it, on the CPU.

- ``KokoroModel.decode_window`` takes ``start`` as a 0-d tensor and slices
  by gathers at offsets clamped on the device: bit for bit the host-sliced
  window it replaced (``host_sliced_window``, kept here) at every window
  start of a stream, the clamped first and last windows and starts past
  the end included, in float32 and bfloat16; within the tolerance of
  ``tests/test_torch_streaming.py::test_decode_window_matches_jax`` of
  JAX's ``decode_window`` called with ``jnp.int32(start)``; and it reads
  no value on the host (``item``, ``int``, ``bool`` raise inside it);
- the engine records the stream's ``("prep", B, T, F)`` and ``("win", B,
  F, window, halo)`` keys at their first use (on the CPU a recorded key
  computes eagerly through the graph's bookkeeping), counts the later
  streams' replays, and ``load_params`` drops the keys;
- the loop that enqueues window k + 1 before handing over chunk k yields
  the chunks of the eager loop it replaced, bit for bit, also with two
  streams of one key interleaved, and a consumer that stops after the
  first chunk leaves one window rendered for nothing."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from illufly_tts_tpu.engine.synthesizer import Synthesizer as JaxSynthesizer
from illufly_tts_tpu_torch.engine.synthesizer import Synthesizer
from illufly_tts_tpu_torch.model.kokoro import _fit_durations
from tests.test_model import tiny_config
from tests.test_torch_params import numpy_tree, port_config
from tests.test_torch_streaming import parent_windowed_stream

torch.set_num_threads(2)

SEED = 123
FRAMES = 128
WINDOW, HALO = 32, 8          # model frames
TEXTS = ["ni→xau↓ma tsʰɤ↘ʂɨ↘" * 3, "ni→xau↓"]
VOICES = ["v", "v"]
BUCKETS = dict(token_buckets=(64,), frame_buckets=(FRAMES,))
# generator-frame starts: every window of the stream, then starts whose
# emitted span or halo runs past the end (the clamped cases)
STARTS = list(range(0, 2 * FRAMES, 2 * WINDOW)) + [2 * FRAMES - 20,
                                                    2 * FRAMES,
                                                    2 * FRAMES + 50]


def host_sliced_window(net, x, f0_m, cum_rad, cur_mask, ref_s, start: int,
                       window: int, halo: int):
    """``decode_window`` as the port computed it with a host-int start:
    Python slices at starts clamped on the host."""
    cfg = net.config

    def clamp(s, size, total):
        return min(max(s, 0), total - size)

    dec_style = ref_s[:, : cfg.style_split].to(cfg.dtype)
    span = window + 2 * halo
    x_p = F.pad(x, (0, halo))
    f0_p, rad_p, mask_p = (F.pad(t, (0, halo))
                           for t in (f0_m, cum_rad, cur_mask))
    total_p = x_p.shape[-1]
    lo = clamp(start - halo, span, total_p)
    audio = net.decoder.generate(
        x_p[:, :, lo:lo + span], dec_style, f0_p[:, lo:lo + span],
        mask_p[:, lo:lo + span], rad_offset=rad_p[:, lo])
    spi = cfg.samples_per_frame // 2
    emit = window + halo
    a0 = clamp((start - lo) * spi, emit * spi, audio.shape[1])
    audio = audio[:, a0:a0 + emit * spi]
    m0 = clamp(start, emit, total_p)
    return audio * mask_p[:, m0:m0 + emit].repeat_interleave(spi, dim=1)


@pytest.fixture(scope="module")
def jax_engine():
    s = JaxSynthesizer(tiny_config(), seed=SEED, **BUCKETS)
    s.register_random_voice("v", seed=1)
    return s


def _port(jax_engine, dtype=torch.float32, **buckets):
    cfg = dataclasses.replace(port_config(), dtype=dtype)
    s = Synthesizer(cfg, params=numpy_tree(jax_engine.params), device="cpu",
                    **(buckets or BUCKETS))
    s.register_random_voice("v", seed=1)
    return s


@pytest.fixture(scope="module")
def engines(jax_engine):
    return {torch.float32: _port(jax_engine),
            torch.bfloat16: _port(jax_engine, torch.bfloat16)}


def _prepare(synth, h):
    with torch.inference_mode():
        return synth.net.decode_prepare(
            h.ids, h.mask, h.d, _fit_durations(h.pred_dur, FRAMES), h.ref,
            FRAMES, pitch=h.pitch)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_device_start_equals_host_slicing(engines, dtype):
    synth = engines[dtype]
    h = synth.dispatch(TEXTS, VOICES)
    prep = _prepare(synth, h)
    for start in STARTS:
        with torch.inference_mode():
            got = synth.net.decode_window(*prep, h.ref, torch.tensor(start),
                                          2 * WINDOW, 2 * HALO)
            from_int = synth.net.decode_window(*prep, h.ref, start,
                                               2 * WINDOW, 2 * HALO)
            want = host_sliced_window(synth.net, *prep, h.ref, start,
                                      2 * WINDOW, 2 * HALO)
        assert got.dtype == want.dtype == torch.float32
        assert got.shape == want.shape == (2, (WINDOW + HALO) * 600)
        assert got.numpy().tobytes() == want.numpy().tobytes(), start
        assert from_int.numpy().tobytes() == want.numpy().tobytes(), start
        assert float(want.abs().max()) > 0 or start >= 2 * FRAMES - 20


def test_device_start_pcm16_equals_host_slicing(engines):
    synth = engines[torch.float32]
    h = synth.dispatch(TEXTS, VOICES)
    prep = _prepare(synth, h)
    for start in STARTS[:2] + STARTS[-2:]:
        with torch.inference_mode():
            got = synth.net.decode_window(*prep, h.ref, torch.tensor(start),
                                          2 * WINDOW, 2 * HALO, pcm16=True)
            want = host_sliced_window(synth.net, *prep, h.ref, start,
                                      2 * WINDOW, 2 * HALO)
        want = torch.round(torch.clamp(want, -1.0, 1.0) * 32767.0).to(
            torch.int16)
        assert got.dtype == torch.int16
        assert got.numpy().tobytes() == want.numpy().tobytes(), start


def test_device_start_matches_jax(jax_engine, engines):
    """Every start against JAX's one window program called with
    ``jnp.int32(start)``, both on JAX's prepared state."""
    port = engines[torch.float32]
    h = jax_engine.dispatch(TEXTS, VOICES, fmt="f32")
    prep = jax_engine._get_stage_prep(h.b_bucket, h.t_bucket, FRAMES)(
        jax_engine.params, h.ids, h.mask, h.d, h.pred_dur, h.ref, h.pitch)
    t = {k: torch.from_numpy(np.array(v)) for k, v in dict(
        ids=h.ids, mask=h.mask, d=h.d, pred=h.pred_dur, ref=h.ref,
        pitch=h.pitch).items()}
    with torch.inference_mode():
        t_prep = port.net.decode_prepare(
            t["ids"].long(), t["mask"], t["d"],
            _fit_durations(t["pred"], FRAMES), t["ref"], FRAMES,
            pitch=t["pitch"])
    win_fn = jax_engine._get_stage_window(h.b_bucket, 2 * WINDOW, 2 * HALO)
    for start in STARTS:
        ref = np.asarray(win_fn(jax_engine.params, *prep, h.ref,
                                jnp.int32(start)))
        with torch.inference_mode():
            got = port.net.decode_window(
                *t_prep, t["ref"], torch.tensor(start, dtype=torch.int32),
                2 * WINDOW, 2 * HALO).numpy()
        assert got.shape == ref.shape
        scale = np.abs(ref).max()
        if scale == 0:  # past the end: both silent
            assert not got.any(), start
            continue
        np.testing.assert_allclose(got / scale, ref / scale, atol=1e-4,
                                   err_msg=str(start))


def test_decode_window_reads_nothing_on_the_host(engines, monkeypatch):
    """With a tensor start, no value is read back to the host: what a CUDA
    graph of the window (one for every position) needs."""
    synth = engines[torch.float32]
    h = synth.dispatch(TEXTS, VOICES)
    prep = _prepare(synth, h)
    start = torch.tensor(2 * WINDOW)

    def host_read(*_):
        raise AssertionError("a tensor value was read on the host")

    for name in ("item", "tolist", "__int__", "__index__", "__bool__",
                 "__float__"):
        monkeypatch.setattr(torch.Tensor, name, host_read)
    with torch.inference_mode():
        audio = synth.net.decode_window(*prep, h.ref, start, 2 * WINDOW,
                                        2 * HALO)
    monkeypatch.undo()
    assert audio.shape == (2, (WINDOW + HALO) * 600)


def _stream(synth, pitches=None):
    h = synth.dispatch(TEXTS, VOICES, pitches=pitches)
    return list(synth.stream_decode(h, WINDOW, HALO, exact=False))


def test_stream_keys_recorded_at_first_use_and_replayed(jax_engine):
    synth = _port(jax_engine)
    windows = FRAMES // WINDOW
    prep_key = ("prep", 2, 64, FRAMES)
    win_key = ("win", 2, FRAMES, 2 * WINDOW, 2 * HALO)
    assert not synth._graphs
    first = _stream(synth)
    assert set(synth._graphs) == {prep_key, win_key}
    assert synth.graph_replays == {prep_key: 1, win_key: windows}
    again = _stream(synth)
    assert synth.graph_replays == {prep_key: 2, win_key: 2 * windows}
    for a, b in zip(first, again):
        assert a.tobytes() == b.tobytes()
    # another window size is another key; the batch path records none
    list(synth.stream_decode(synth.dispatch(TEXTS, VOICES), 64, 16,
                             exact=False))
    synth.collect(synth.dispatch(TEXTS, VOICES))
    assert set(synth._graphs) == {prep_key, win_key,
                                  ("win", 2, FRAMES, 128, 32)}
    assert synth.graph_replays[prep_key] == 3


def test_load_params_drops_the_stream_keys(jax_engine, tmp_path):
    synth = _port(jax_engine)
    before = _stream(synth)
    assert len(synth._graphs) == 2
    path = str(tmp_path / "w.msgpack")
    synth.save_params(path)
    synth.load_params(path)
    assert synth._graphs == {}
    after = _stream(synth)
    assert len(synth._graphs) == 2
    for a, b in zip(before, after):
        assert a.tobytes() == b.tobytes()


@pytest.mark.parametrize("ahead", [False, True], ids=["0", "1"])
def test_windows_ahead_yield_the_eager_loops_chunks(engines, ahead):
    """The engine's loop, rendering one window ahead of the chunk it hands
    over (as on the card) or none (as on the CPU), against
    ``parent_windowed_stream``, at pitch 1 and not."""
    synth = engines[torch.float32]
    synth._render_ahead = ahead
    try:
        for pitches in (None, [1.4, 0.8]):
            want = parent_windowed_stream(
                synth, synth.dispatch(TEXTS, VOICES, pitches=pitches),
                WINDOW, HALO)
            got = _stream(synth, pitches)
            assert len(got) == len(want) == FRAMES // WINDOW
            for g, w in zip(got, want):
                assert g.dtype == np.float32 and g.tobytes() == w.tobytes()
    finally:
        synth._render_ahead = False


def test_interleaved_streams_of_one_key(engines):
    """Two streams of one window key, their windows interleaved (each
    replay copies its own stream's inputs in)."""
    synth = engines[torch.float32]
    synth._render_ahead = True
    try:
        a = synth.stream_decode(synth.dispatch(TEXTS, VOICES), WINDOW, HALO,
                                exact=False)
        b = synth.stream_decode(synth.dispatch(TEXTS[::-1], VOICES), WINDOW,
                                HALO, exact=False)
        pairs = list(zip(a, b))
    finally:
        synth._render_ahead = False
    want_a = _stream(synth)
    want_b = list(synth.stream_decode(synth.dispatch(TEXTS[::-1], VOICES),
                                      WINDOW, HALO, exact=False))
    for (ga, gb), wa, wb in zip(pairs, want_a, want_b):
        assert ga.tobytes() == wa.tobytes() and gb.tobytes() == wb.tobytes()


def test_early_stop_renders_one_window_ahead(engines, monkeypatch):
    synth = engines[torch.float32]
    rendered = []
    decode_window = synth.net.decode_window

    def counted(*args, **kwargs):
        rendered.append(args[5])
        return decode_window(*args, **kwargs)

    monkeypatch.setattr(synth.net, "decode_window", counted)
    monkeypatch.setattr(synth, "_render_ahead", True)
    gen = synth.stream_decode(synth.dispatch(TEXTS, VOICES), WINDOW, HALO,
                              exact=False)
    next(gen)
    gen.close()
    assert [int(s) for s in rendered] == [0, 2 * WINDOW]


@pytest.mark.parametrize("window, halo, fits", [(64, 16, False),
                                                 (32, 32, True)])
def test_window_and_halo_past_the_bucket_raise(jax_engine, window, halo,
                                               fits):
    """A window and halo longer than the frame bucket raise ValueError on
    the host, before any stage runs or is recorded (a gather past the
    tensor would be a device-side assert on the card); one that just fits
    streams."""
    synth = _port(jax_engine, token_buckets=(64,), frame_buckets=(64,))
    h = synth.dispatch(TEXTS[1:], VOICES[1:])
    gen = synth.stream_decode(h, window, halo, exact=False)
    if fits:
        assert len(list(gen)) >= 1
        return
    with pytest.raises(ValueError, match="exceed the frame bucket 64"):
        next(gen)
    assert synth._graphs == {}
    with torch.inference_mode():
        prep = synth.net.decode_prepare(
            h.ids, h.mask, h.d, _fit_durations(h.pred_dur, 64), h.ref, 64,
            pitch=h.pitch)
        with pytest.raises(ValueError, match="exceed"):
            synth.net.decode_window(*prep, h.ref, 0, 2 * window, 2 * halo)
