# -*- coding: utf-8 -*-
"""PyTorch port: the text pipeline against the JAX one, on the CPU.

Both ``CachedTTSPipeline``s run over the same parameters (the JAX random
init of ``tiny_config``, seed 123) and the same voices, with one token and
one frame bucket. Audio agrees in length and to rms/scale < 5e-3 (the
golden-audio gate); word timestamps name the same words in the same order,
each edge within one frame (0.025 s); blended voice packs agree to 1e-7;
the offline HF-cache voice search finds the same packs and reports the same
``searched`` list. The port's own paths hold together exactly:
split-phase == one-shot, an exact stream == ``process``, a cache hit
reaches no Synthesizer."""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from illufly_tts_tpu.engine.synthesizer import Synthesizer as JaxSynthesizer
from illufly_tts_tpu.pipeline import CachedTTSPipeline as JaxCachedPipeline
from illufly_tts_tpu_torch import pipeline as pipeline_mod
from illufly_tts_tpu_torch.audio.telephony import mulaw_decode_np
from illufly_tts_tpu_torch.engine.synthesizer import Synthesizer
from illufly_tts_tpu_torch.pipeline import CachedTTSPipeline, TTSPipeline
from tests.test_model import tiny_config
from tests.test_torch_params import numpy_tree, port_config

torch.set_num_threads(2)

SEED = 123
BUCKETS = dict(token_buckets=(64,), frame_buckets=(128,),
               batch_buckets=(1, 4))
FRAME_S = 600 / 24000  # one model frame
ZH = "你好，这是一个测试。"
MIXED = "今天是May 10th，气温25°C。"
SEGMENTED = "第一句话。第二句话！第三句话？"
BATCH = ["你好。", "再见。", "hello there.", "今天天气不错。"]
BATCH_VOICES = ["v", "w", "v", "v*0.7+w*0.3"]


@pytest.fixture(scope="module")
def pipes():
    jsynth = JaxSynthesizer(tiny_config(), seed=SEED, **BUCKETS)
    synth = Synthesizer(port_config(), params=numpy_tree(jsynth.params),
                        device="cpu", **BUCKETS)
    for s in (jsynth, synth):
        s.register_random_voice("v", seed=1)
        s.register_random_voice("w", seed=2)
    return (JaxCachedPipeline(synthesizer=jsynth),
            CachedTTSPipeline(synthesizer=synth))


@pytest.fixture(scope="module")
def plain(pipes):
    """An uncached port pipeline on the same Synthesizer."""
    return TTSPipeline(synthesizer=pipes[1].synthesizer)


def _as_float(audio):
    audio = np.asarray(audio)
    if audio.dtype == np.uint8:
        return mulaw_decode_np(audio).astype(np.float64)
    if audio.dtype == np.int16:
        return audio.astype(np.float64) / 32767.0
    return audio.astype(np.float64)


def _close(port, ref):
    assert port.shape == ref.shape and port.dtype == ref.dtype
    port, ref = _as_float(port), _as_float(ref)
    rms = float(np.sqrt(np.mean((port - ref) ** 2)))
    scale = float(np.sqrt(np.mean(ref ** 2))) + 1e-9
    assert rms / scale < 5e-3, (rms, scale)


def _same_words(port, ref):
    assert [(w["text"], w["phonemes"]) for w in port] == \
        [(w["text"], w["phonemes"]) for w in ref]
    for p, r in zip(port, ref):
        assert abs(p["start_s"] - r["start_s"]) <= FRAME_S, (p, r)
        assert abs(p["end_s"] - r["end_s"]) <= FRAME_S, (p, r)


@pytest.mark.parametrize("text,segment", [(ZH, False), (MIXED, False),
                                          (SEGMENTED, True)],
                         ids=["zh", "mixed", "segmented"])
def test_process_matches_jax(pipes, text, segment):
    jax_pipe, port = pipes
    audio = port.process(text, "v", segment_text=segment)
    assert audio.size > 0 and np.isfinite(audio).all()
    _close(audio, jax_pipe.process(text, "v", segment_text=segment))


@pytest.mark.parametrize("fmt", ["f32", "pcm16", "mulaw8k"])
def test_batch_process_texts_matches_jax(pipes, fmt):
    jax_pipe, port = pipes
    got = port.batch_process_texts(BATCH, BATCH_VOICES, output_format=fmt)
    want = jax_pipe.batch_process_texts(BATCH, BATCH_VOICES,
                                        output_format=fmt)
    assert len(got) == len(BATCH)
    for g, w in zip(got, want):
        _close(g, w)


def test_process_with_timestamps_matches_jax(pipes):
    jax_pipe, port = pipes
    audio, words = port.process_with_timestamps(ZH, "v")
    ref_audio, ref_words = jax_pipe.process_with_timestamps(ZH, "v")
    _close(audio, ref_audio)
    assert words
    _same_words(words, ref_words)
    dur = audio.size / port.sample_rate
    prev_end = 0.0
    for w in words:
        assert prev_end - 1e-6 <= w["start_s"] <= w["end_s"] <= dur + 1e-6
        prev_end = w["end_s"]


def test_split_phase_matches_oneshot(plain):
    """dispatch_texts -> launch_decode -> collect_batch, with two batches
    in flight, equals the one-shot batch path."""
    assert plain.supports_split_phase
    batches = [(BATCH[:2], BATCH_VOICES[:2]), (BATCH[2:3], BATCH_VOICES[2:3])]
    handles = [plain.dispatch_texts(t, v, output_format="pcm16")
               for t, v in batches]
    for h in handles:
        plain.launch_decode(h)
    for (texts, voices), h in zip(batches, handles):
        got = plain.collect_batch(h, "pcm16")
        want = plain.batch_process_texts(texts, voices,
                                         output_format="pcm16")
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("cached", [False, True], ids=["plain", "cached"])
def test_split_phase_timestamps(pipes, plain, cached):
    """A timestamped split-phase dispatch (the scheduler's path for
    ``return_timestamps``) stores its frontend context on the engine's
    handle and gives the one-shot path's audio and stamps."""
    jax_pipe, port = pipes
    pipe = port if cached else plain
    texts, want = [ZH, "再见。"], [True, False]
    h = pipe.dispatch_texts(texts, ["v", "v"], want_timestamps=want)
    pipe.launch_decode(h)
    audios = pipe.collect_batch(h)
    stamps = pipe.collect_timestamps(h)
    ref_audios, ref_stamps = plain.batch_process_texts_with_timestamps(
        texts, ["v", "v"], want=want)
    assert stamps[1] is None and stamps[0]
    assert stamps[0] == ref_stamps[0]
    for a, r in zip(audios, ref_audios):
        np.testing.assert_array_equal(a, r)
    _, jax_stamps = jax_pipe.batch_process_texts_with_timestamps(
        texts, ["v", "v"], want=want)
    _same_words(stamps[0], jax_stamps[0])


def test_stream_process_exact_is_process(pipes):
    jax_pipe, port = pipes
    chunks = list(port.stream_process(MIXED, "v", window_frames=32))
    assert len(chunks) > 1
    stream = np.concatenate(chunks)
    whole = port.process(MIXED, "v")
    np.testing.assert_array_equal(stream, whole)
    _close(stream, np.concatenate(list(jax_pipe.stream_process(
        MIXED, "v", window_frames=32))))


def test_audio_cache_hit_reaches_no_synthesizer(pipes, monkeypatch):
    _, port = pipes
    first = port.batch_process_texts(["缓存测试。"], ["v"])
    calls = []
    synth = port.synthesizer
    monkeypatch.setattr(synth, "dispatch",
                        lambda *a, **k: calls.append(a) or None)
    again = port.batch_process_texts(["缓存测试。"], ["v"])
    h = port.dispatch_texts(["缓存测试。"], ["v"])
    assert h.inner is None
    port.launch_decode(h)
    split = port.collect_batch(h)
    assert calls == []
    np.testing.assert_array_equal(again[0], first[0])
    np.testing.assert_array_equal(split[0], first[0])
    assert port.get_cache_stats()["text_misses"] >= 1


@pytest.mark.parametrize("spec", ["v*0.7+w*0.3", "v+w", "w*2 + v*1+v*0.5"])
def test_blend_voice_matches_jax(pipes, spec):
    jax_pipe, port = pipes
    pack = port.synthesizer.blend_voices(spec)
    ref = jax_pipe.synthesizer.blend_voices(spec)
    assert pack.shape == ref.shape and pack.dtype == np.float32
    np.testing.assert_allclose(pack, ref, rtol=0, atol=1e-7)
    assert port.is_voice_loaded(spec)
    np.testing.assert_array_equal(port.load_voice(spec), pack)
    assert spec in port.list_voices()
    assert {"v", "w"} <= set(port.list_voices())


@pytest.mark.parametrize("spec", ["v*0", "v*-1", "v*abc", "+v", "v+nope"])
def test_bad_blend_specs_raise_as_jax(pipes, spec):
    jax_pipe, port = pipes
    with pytest.raises(ValueError) as ref:
        jax_pipe.synthesizer.blend_voices(spec)
    with pytest.raises(ValueError) as got:
        port.synthesizer.blend_voices(spec)
    assert str(got.value) == str(ref.value)
    assert not port.is_voice_loaded(spec)


@pytest.mark.parametrize("case", ["found", "missing", "no_snapshots"])
def test_hf_cache_voice_search_matches_jax(pipes, tmp_path, monkeypatch,
                                           case):
    """voices_dir first, then ``$HF_HOME/hub/models--org--name/snapshots/
    */voices/``, offline; the same packs and the same error as JAX."""
    hf_home = tmp_path / "hf"
    voices_dir = tmp_path / "voices"
    voices_dir.mkdir()
    pack = np.random.RandomState(5).randn(40, 32).astype(np.float32)
    if case != "no_snapshots":
        snaps = hf_home / "hub" / "models--org--name" / "snapshots"
        (snaps / "aaa").mkdir(parents=True)  # a revision without voices/
        (snaps / "bbb" / "voices").mkdir(parents=True)
        np.save(snaps / "bbb" / "voices" / "hf_voice.npy", pack[:, None, :])
    monkeypatch.setenv("HF_HOME", str(hf_home))
    jsynth = pipes[0].synthesizer
    monkeypatch.setattr(jsynth, "repo_id", "org/name")
    monkeypatch.setattr(jsynth, "voices_dir", str(voices_dir))
    monkeypatch.setattr(jsynth, "_voices", {})
    synth = Synthesizer(port_config(), seed=0, device="cpu",
                        voices_dir=str(voices_dir), repo_id="org/name")
    if case == "found":
        got = synth.load_voice("hf_voice")
        np.testing.assert_array_equal(got, pack)
        np.testing.assert_array_equal(got, jsynth.load_voice("hf_voice"))
        return
    with pytest.raises(ValueError) as ref:
        jsynth.load_voice("absent")
    with pytest.raises(ValueError) as err:
        synth.load_voice("absent")
    assert str(err.value) == str(ref.value)
    assert str(voices_dir) in str(err.value)


def test_pipeline_device(monkeypatch):
    """TTSPipeline() runs on CUDA and raises without it, before the
    frontend loads; device='cpu' reaches the Synthesizer it builds."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TTSPipeline()
    built = {}

    def tiny_synth(**kw):
        built.update(kw)
        return Synthesizer(port_config(), seed=0, **kw)

    monkeypatch.setattr(pipeline_mod, "Synthesizer", tiny_synth)
    pipe = TTSPipeline(device="cpu", repo_id="org/name")
    assert built == {"voices_dir": None, "device": "cpu",
                     "repo_id": "org/name"}
    assert pipe.device == torch.device("cpu")
    pipe.synthesizer.register_random_voice("v", seed=1)
    assert pipe.process(ZH, "v").size > 0


def test_load_params_not_ported(pipes, tmp_path):
    """Checkpoint loading is ported now: ``params_path`` reads the flax
    msgpack the JAX engine saves (the same parameters: nothing moves)."""
    jpipe, pipe = pipes
    synth = pipe.synthesizer
    path = str(tmp_path / "model.msgpack")
    jpipe.synthesizer.save_params(path)
    before = {k: v.clone() for k, v in synth.model.state_dict().items()}
    TTSPipeline(synthesizer=synth, params_path=path)
    for name, value in synth.model.state_dict().items():
        assert torch.equal(value, before[name]), name
    ckpt = tmp_path / "model.pth"
    ckpt.write_bytes(b"")  # not a torch file: the loader's own error
    with pytest.raises(Exception) as err:
        TTSPipeline(synthesizer=synth, params_path=str(ckpt))
    assert not isinstance(err.value, NotImplementedError)


_NO_JIEBA = """
import sys

class _Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] == "jieba":
            raise ImportError("BLOCKED: jieba")
        return None

sys.meta_path.insert(0, _Block())
import numpy as np
import chip_smoke
from illufly_tts_tpu_torch.engine.synthesizer import Synthesizer
from illufly_tts_tpu_torch.pipeline import CachedTTSPipeline
from illufly_tts_tpu_torch.runtime.scheduler import TTSServiceManager
from tests.test_torch_params import port_config

synth = Synthesizer(port_config(), seed=0, device="cpu",
                    token_buckets=(64,), frame_buckets=(128,))
synth.register_random_voice("smoke_voice", seed=0)
pipe = chip_smoke.frozen_frontend(CachedTTSPipeline)(synthesizer=synth)
for task in chip_smoke.TASKS[:3]:
    audio = pipe.process(task[2], "smoke_voice")
    assert audio.size > 0 and np.isfinite(audio).all()
assert "jieba" not in sys.modules
print("NO JIEBA OK")
"""


def test_serves_without_jieba():
    """Where ``jieba`` is absent the port's pipeline and scheduler still
    import, and ``chip_smoke.py``'s frozen-table frontend serves its
    texts through them."""
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run(
        [sys.executable, "-c", _NO_JIEBA], cwd=repo, capture_output=True,
        text=True, timeout=300, env={**os.environ, "JAX_PLATFORMS": "cpu"},
    )
    assert proc.returncode == 0, proc.stderr
    assert "NO JIEBA OK" in proc.stdout
