# -*- coding: utf-8 -*-
"""PyTorch port: the Synthesizer end to end on the CPU.

It must reproduce the JAX engine's frozen golden waveforms
(``tests/golden``, made by ``tests/test_golden_audio.py``) from the same
seeded parameters and voice, at the golden gate's tolerances; refuse to
start without CUDA unless asked for the CPU; and import no JAX."""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from illufly_tts_tpu.audio.mel import mel_l1
from illufly_tts_tpu_torch.engine import synthesizer as synth_mod
from illufly_tts_tpu_torch.engine.synthesizer import Synthesizer
from tests.test_client_only_imports import FASTAPI_STUB
from tests.test_golden_audio import GOLDEN_DIR, SEED, TEXTS
from tests.test_torch_params import port_config

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _synth(**kw):
    s = Synthesizer(port_config(), seed=SEED, device="cpu",
                    token_buckets=(64,), frame_buckets=(128,), **kw)
    s.register_random_voice("golden_voice", seed=SEED)
    return s


@pytest.fixture(scope="module")
def synth():
    return _synth()


def _assert_golden(out):
    for i, wave in enumerate(out):
        gold = np.load(os.path.join(GOLDEN_DIR, f"wave_{i}_f32.npy"))
        assert wave.shape == gold.shape, (wave.shape, gold.shape)
        rms = float(np.sqrt(np.mean((wave - gold) ** 2)))
        scale = float(np.sqrt(np.mean(gold ** 2))) + 1e-9
        assert rms / scale < 5e-3, (i, rms, scale)
        assert mel_l1(wave, gold) < 5e-3, i


def test_port_reproduces_golden_waveforms(synth):
    _assert_golden(synth.synthesize_batch(TEXTS, ["golden_voice"] * 2))


def test_split_batches_reproduce_golden():
    """Batches beyond the largest batch bucket are split and pipelined."""
    s = _synth(batch_buckets=(1,))
    _assert_golden(s.synthesize_batch(TEXTS, ["golden_voice"] * 2))


def test_formats_and_rendered_durations(synth):
    h32 = synth.dispatch(TEXTS, ["golden_voice"] * 2, fmt="f32",
                         keep_durations=True)
    dur = synth.rendered_durations(h32)  # before any decode
    f32 = synth.collect(h32)
    pcm = synth.collect(synth.dispatch(TEXTS, ["golden_voice"] * 2),
                        pcm16=True)
    assert dur.shape == (2, h32.t_bucket) and dur.dtype == np.int32
    for i in range(2):
        assert dur[i].sum() == h32.fitted_totals[i]
        assert f32[i].dtype == np.float32 and pcm[i].dtype == np.int16
        assert f32[i].size == pcm[i].size == h32.fitted_totals[i] * 600
        # pcm16 is the f32 render scaled to its peak (it clips), rounded
        peak = np.abs(f32[i]).max()
        assert peak > 1.0
        assert np.abs(f32[i] / peak * 32767.0 - pcm[i]).max() <= 1.0
    with pytest.raises(ValueError, match="unsupported audio format"):
        synth.dispatch(TEXTS, ["golden_voice"] * 2, fmt="opus")


def test_voice_files(tmp_path):
    pack = np.random.RandomState(0).randn(40, 32).astype(np.float32)
    np.save(tmp_path / "a.npy", pack)
    np.savez(tmp_path / "b.npz", pack=pack[:, None, :])
    torch.save(torch.from_numpy(pack), tmp_path / "c.pt")
    s = Synthesizer(port_config(), seed=0, device="cpu",
                    voices_dir=str(tmp_path))
    for name in "abc":
        np.testing.assert_array_equal(s.load_voice(name), pack)
    with pytest.raises(ValueError, match="voice not found"):
        s.load_voice("missing")


def test_timestamped_dispatch_copies_durations_beside_totals(synth,
                                                            monkeypatch):
    """``keep_durations``: ``dispatch`` starts the host copy of
    ``pred_dur[:n]`` beside the frame totals, and ``_decode`` and
    ``rendered_durations`` read it without a ``Tensor.cpu`` call (on the
    card such a copy queues behind the batch's own stage B)."""
    h = synth.dispatch(TEXTS, ["golden_voice"] * 2, keep_durations=True)
    assert h.host_pred_dur is not None
    np.testing.assert_array_equal(h.host_pred_dur.numpy(),
                                  h.pred_dur[: h.n].numpy())

    def no_cpu(self, *args, **kwargs):
        raise AssertionError("Tensor.cpu called")

    with monkeypatch.context() as m:
        m.setattr(torch.Tensor, "cpu", no_cpu)
        before = synth.rendered_durations(h)
        synth.launch_decode(h)
        after = synth.rendered_durations(h)
    np.testing.assert_array_equal(before, after)
    assert [a.size for a in synth.collect(h)] == \
        [int(t) * 600 for t in before.sum(axis=1)]
    plain = synth.dispatch(TEXTS, ["golden_voice"] * 2)
    assert plain.host_pred_dur is None
    with pytest.raises(ValueError, match="keep_durations=True"):
        synth.rendered_durations(plain)


def test_default_device_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Synthesizer(port_config())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        synth_mod.resolve_device("cuda")


_BLOCKER = """
import sys

class _Block:
    BLOCKED = ("jax", "jaxlib", "flax", "optax", "orbax", "illufly_tts_tpu")

    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in self.BLOCKED:
            raise ImportError("BLOCKED: the port must not import " + name)
        return None

sys.meta_path.insert(0, _Block())
"""


def test_port_imports_no_jax():
    pkg = os.path.join(REPO, "illufly_tts_tpu_torch")
    modules = sorted(
        ("illufly_tts_tpu_torch." + os.path.relpath(
            os.path.join(root, f), pkg)[:-3].replace(os.sep, "."))
        .removesuffix(".__init__")
        for root, _, files in os.walk(pkg) for f in files
        if f.endswith(".py")
    )
    assert len(modules) >= 15, modules
    for m in ("api.endpoints", "api.fastapi_compat", "mcp.server",
              "client.mcp_client", "audio.flac", "__main__"):
        assert f"illufly_tts_tpu_torch.{m}" in modules, m
    # the FastAPI shim imports fastapi at module top: a stub stands in
    body = FASTAPI_STUB + (
        "import importlib\n"
        f"for m in {modules!r} + ['chip_smoke']:\n"
        "    importlib.import_module(m)\n"
        "import illufly_tts_tpu_torch as p\n"
        "p.Synthesizer, p.KokoroConfig\n"
        "p.TTSPipeline, p.CachedTTSPipeline, p.TTSServiceManager\n"
        "assert not any(m.split('.')[0] in ('jax', 'flax', 'illufly_tts_tpu')"
        " for m in sys.modules)\n"
        "print('PORT OK')\n"
    )
    proc = subprocess.run(
        [sys.executable, "-c", _BLOCKER + body], cwd=REPO,
        capture_output=True, text=True, timeout=120,
        env={**os.environ, "JAX_PLATFORMS": "cpu"},
    )
    assert proc.returncode == 0, proc.stderr
    assert "PORT OK" in proc.stdout
