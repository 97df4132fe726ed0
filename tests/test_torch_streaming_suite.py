# -*- coding: utf-8 -*-
"""PyTorch port: intra-utterance streaming (``tests/test_streaming.py``).

Every case of that suite that goes through the engine or the pipeline runs
again on the port's, on the suite's own fixture built on the port (the
same config dimensions, seed, buckets and voice; on the CPU): exact
streams bitwise equal to ``collect()`` in f32 and pcm16, chunk geometry
and trim, seam continuity, the first chunk before the later windows, the
decoded-handle checks, sorted inventories, ``stream_process`` with and
without timestamps. The suite is ``slow`` as a whole for its JAX
compiles; on the port it is cheap, so it runs here unmarked.

The two cases that call the flax model or the JAX engine's stage programs
directly get port counterparts with the same assertions: one window over
the whole budget equals ``decode_frames``, and two neighbouring windows
agree on their overlap. Both pass ``decode_window`` its ``start`` as a 0-d
tensor, as the JAX cases pass ``jnp.int32``. The first-chunk case keeps its
id but runs ``first_chunk_early``: its assertions, with the window work
timed from the prepare's end (the JAX body's timing premise does not hold
on the port's CPU path, see there)."""
import time

import numpy as np
import pytest
import torch

from illufly_tts_tpu_torch.model.kokoro import KokoroModel, _fit_durations
from tests import test_streaming as jax_cases
from tests import torch_port_cases as port_cases
from tests.test_torch_params import port_config

torch.set_num_threads(2)

DIRECT = ("test_full_span_window_is_exact", "test_overlap_regions_allclose")
CASES = port_cases.collect(jax_cases, exclude=DIRECT)
TEXTS = jax_cases.TEXTS
FRAMES = 128


@pytest.fixture(scope="module")
def synth():
    s = port_cases.cpu_synthesizer()(
        config=port_config(), seed=0, token_buckets=(64,),
        frame_buckets=(FRAMES,))
    s.register_random_voice("v", seed=1)
    return s


def test_all_streaming_cases_collected():
    assert len(CASES) == 10, sorted(CASES)


@pytest.mark.parametrize("case", sorted(CASES))
def test_streaming_case_on_the_port(case, synth, monkeypatch):
    if case == "test_streaming_structure_first_chunk_early":
        first_chunk_early(synth, monkeypatch)  # its timing, on the port
        return
    port_cases.use_port_engine(monkeypatch, jax_cases,
                               ("Synthesizer", "tiny_config"))
    monkeypatch.setattr(jax_cases, "KokoroModel", KokoroModel)
    monkeypatch.setattr(jax_cases, "_fit_durations", _fit_durations)
    port_cases.run(jax_cases, CASES[case], synth=synth)


def first_chunk_early(synth, monkeypatch):
    """``test_streaming.py::test_streaming_structure_first_chunk_early`` on
    the port: the generator yields chunk 0 having rendered one window, not
    all four. The JAX case times it from the stream's start, ``t_first <
    0.75 * t_all``, which takes the prepare to be small beside the windows
    (``t_first = P + W``, ``t_all = P + 4W``: it holds while P < 8W). This
    config's decoder trunk is full width (1024 channels), and on the CPU
    the prepare takes ~5 windows, so that ratio reads 0.6-0.74 alone and
    crossed 0.75 under a loaded full run. Here the windows rendered by chunk
    0 are counted, and the window work is timed from the prepare's end,
    where the ratio is ~W / 4W."""
    rendered, prep_done = [], []
    run_stage = synth._run_stage

    def stamped(key, inputs):
        out = run_stage(key, inputs)
        if key[0] in ("prep", "win"):  # not stage A
            (prep_done if key[0] == "prep" else rendered).append(
                time.perf_counter())
        return out

    monkeypatch.setattr(synth, "_run_stage", stamped)
    h = synth.dispatch(TEXTS, ["v", "v"])
    gen = synth.stream_decode(h, window_frames=32, halo_frames=8,
                              exact=False)
    first = next(gen)
    t_first = time.perf_counter()
    windows_at_first = len(rendered)
    rest = list(gen)
    t_all = time.perf_counter()
    assert first.shape[1] > 0
    assert len(rest) == 3
    assert windows_at_first == 1 and len(rendered) == 4
    (t0,) = prep_done
    assert t_first - t0 < 0.75 * (t_all - t0), (t_first - t0, t_all - t0)



def _prepared(synth, h):
    with torch.inference_mode():
        return synth.net.decode_prepare(
            h.ids, h.mask, h.d, _fit_durations(h.pred_dur, FRAMES), h.ref,
            FRAMES)


def test_full_span_window_is_exact(synth):
    """``test_streaming.py::test_full_span_window_is_exact`` on the port:
    one window covering the whole budget equals ``decode_frames``."""
    h = synth.dispatch(TEXTS, ["v", "v"])
    with torch.inference_mode():
        full, _ = synth.net.decode_frames(
            h.ids, h.mask, h.d, _fit_durations(h.pred_dur, FRAMES), h.ref,
            FRAMES)
        audio = synth.net.decode_window(*_prepared(synth, h), h.ref,
                                        torch.tensor(0), 2 * FRAMES, 0)
    np.testing.assert_allclose(audio.numpy(), full.numpy(), atol=1e-4)


def test_overlap_regions_allclose(synth):
    """``test_streaming.py::test_overlap_regions_allclose`` on the port:
    window 0's right overlap and window 1's left body, rendered apart,
    agree (rel < 1, correlation > 0.5 at the random init)."""
    W, H = 32, 8
    h = synth.dispatch(TEXTS, ["v", "v"])
    prep = _prepared(synth, h)
    spf = synth.config.samples_per_frame
    overlap, body = 2 * H * 300, W * spf
    with torch.inference_mode():
        prev, nxt = (synth.net.decode_window(
            *prep, h.ref, torch.tensor(start), 2 * W, 2 * H).numpy()
            for start in (0, 2 * W))
    a = prev[0, body: body + overlap]
    b = nxt[0, :overlap]
    rel = np.sqrt(np.mean((a - b) ** 2)) / (np.sqrt(np.mean(a ** 2)) + 1e-9)
    assert rel < 1.0, rel
    assert np.corrcoef(a, b)[0, 1] > 0.5
