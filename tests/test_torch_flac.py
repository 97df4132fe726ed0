# -*- coding: utf-8 -*-
"""PyTorch port: FLAC output (``audio/flac.py`` + ``csrc/flacenc.cpp``).

Every case of ``tests/test_flac.py`` runs again with the port's ``flac``
module and ``save_audio`` in that file's globals. The port's encoder gives
streams byte-equal to the JAX package's on the same seeded input, through
the native library and through the numpy encoder alike, and either
package's decoder reads the other's output. The native library builds under
the git-ignored ``build/`` at the root of the checkout, keyed by the
source's hash, and ``TTSPipeline.process(..., output_path="x.flac")``
writes a FLAC holding the samples of the returned audio."""
import os

import numpy as np
import pytest
import torch

from illufly_tts_tpu.audio import flac as jax_flac
from illufly_tts_tpu_torch.audio import flac as port_flac
from illufly_tts_tpu_torch.audio import wav as port_wav
from tests import test_flac as jax_cases
from tests import torch_port_cases as port_cases

torch.set_num_threads(2)

CASES = port_cases.collect(jax_cases)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_all_flac_cases_collected():
    assert len(CASES) == 23, sorted(CASES)


@pytest.mark.parametrize("case", sorted(CASES))
def test_flac_case_on_the_port(case, monkeypatch, tmp_path):
    monkeypatch.setattr(jax_cases, "flac", port_flac)
    monkeypatch.setattr(jax_cases, "save_audio", port_wav.save_audio)
    port_cases.run(jax_cases, CASES[case], monkeypatch=monkeypatch,
                   tmp_path=tmp_path)


def _seeded_pcm():
    rng = np.random.default_rng(7)
    return np.concatenate([
        jax_cases._speechish(30000, seed=7),
        np.zeros(4096, np.int16),
        rng.integers(-32768, 32768, 777).astype(np.int16),
    ])


@pytest.mark.parametrize("encoder", ["native", "numpy"])
def test_port_and_jax_streams_byte_equal(encoder, monkeypatch):
    if encoder == "native":
        assert port_flac._get_lib() is not None, "g++ build failed"
        assert jax_flac._get_lib() is not None
    else:
        for mod in (port_flac, jax_flac):
            monkeypatch.setattr(mod, "_encode_frames_native",
                                lambda *a: None)
    pcm = _seeded_pcm()
    for rate in (24000, 8000):
        port_bytes = port_flac.encode_flac(pcm, rate)
        jax_bytes = jax_flac.encode_flac(pcm, rate)
        assert port_bytes == jax_bytes
        for decode in (port_flac.decode_flac, jax_flac.decode_flac):
            dec, sr = decode(port_bytes)
            assert sr == rate and np.array_equal(dec, pcm)


def test_native_library_builds_under_build_dir():
    port_flac._get_lib()
    path = port_flac.library_path()
    assert os.path.exists(path)
    rel = os.path.relpath(path, REPO)
    assert rel.startswith(os.path.join("build", "native", "flacenc-")), rel
    # the source is the port's own copy, byte for byte the JAX package's
    with open(os.path.join(REPO, "native", "flacenc.cpp"), "rb") as a, \
            open(port_flac._SRC, "rb") as b:
        assert a.read() == b.read()


def test_pipeline_process_writes_flac(tmp_path):
    """``process(..., output_path=<x>.flac)`` writes a lossless FLAC of the
    audio it returns, quantized as the WAV path quantizes it."""
    from illufly_tts_tpu_torch.engine.synthesizer import Synthesizer
    from illufly_tts_tpu_torch.pipeline import TTSPipeline
    from tests.test_torch_params import port_config

    synth = Synthesizer(port_config(), seed=3, device="cpu",
                        token_buckets=(64,), frame_buckets=(128,),
                        batch_buckets=(1,))
    synth.register_random_voice("v", seed=3)
    path = tmp_path / "out.flac"
    audio = TTSPipeline(synthesizer=synth).process(
        "你好。", "v", output_path=str(path))
    dec, rate = port_flac.decode_flac(path.read_bytes())
    wav = port_wav.encode_wav(audio, rate)
    assert rate == 24000 and dec.size == audio.size > 0
    assert np.array_equal(dec, np.frombuffer(wav[44:], "<i2"))
