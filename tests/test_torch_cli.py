# -*- coding: utf-8 -*-
"""PyTorch port: the command line (``python -m illufly_tts_tpu_torch``).

The cases of ``tests/test_cli.py`` run again on the port's ``cli``, all
nine commands. ``test_convert_roundtrip`` gets a port rewrite (the JAX case
reads ``Synthesizer.params`` through ``jax.tree_util`` and runs without
``--device``, which the port reads as CUDA), and the slow-marked
``test_train_voice_end_to_end`` runs here at its tiny size, its pack
loaded by the JAX engine. The port's own rules: ``--dp N`` builds an N-way
'data' mesh (of the host's CUDA devices, here two CPU devices standing in)
and fails as JAX's ``make_mesh`` does on a host with fewer devices,
``--device`` reaches the engine, and ``main()`` defaults to ``serve``."""
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch
from click.testing import CliRunner

from illufly_tts_tpu_torch import __main__ as port_main
from tests import test_cli as jax_cases
from tests import torch_port_cases as port_cases

torch.set_num_threads(2)

REWRITTEN = ("test_convert_roundtrip",)
CASES = port_cases.collect(jax_cases, exclude=REWRITTEN)
COMMANDS = ("serve", "synth", "server", "api", "router", "client", "convert",
            "train", "train-voice")


def test_all_cli_cases_collected():
    assert len(CASES) == 6, sorted(CASES)


@pytest.mark.parametrize("case", sorted(CASES))
def test_cli_case_on_the_port(case, monkeypatch, tmp_path):
    monkeypatch.setattr(jax_cases, "cli", port_main.cli)
    port_cases.run(jax_cases, CASES[case], monkeypatch=monkeypatch,
                   tmp_path=tmp_path)


def test_commands_not_ported_are_absent():
    """None is left: the port's CLI lists the JAX CLI's nine commands."""
    out = CliRunner().invoke(port_main.cli, ["--help"]).output
    listed = {line.split()[0] for line in out.split("Commands:")[1]
              .splitlines() if line.strip()}
    assert listed == set(COMMANDS)
    from illufly_tts_tpu.__main__ import cli as jax_cli

    assert set(jax_cli.commands) == set(COMMANDS)


def _two_cpu_devices(monkeypatch):
    """A host whose 'CUDA devices' are two CPU devices, for ``--dp 2``."""
    from illufly_tts_tpu_torch.parallel import mesh

    monkeypatch.setattr(mesh, "cuda_devices",
                        lambda: [torch.device("cpu")] * 2)


@pytest.mark.parametrize("dp", ["1", "2-on-one-device", "2"])
def test_serve_dp(dp, monkeypatch):
    """``--dp 1`` serves on one device (``create_app`` builds its own
    pipeline); ``--dp 2`` on a one-device host fails with the JAX
    ``make_mesh`` assert's message; ``--dp 2`` over two devices hands
    ``create_app`` a ``CachedTTSPipeline`` on a 2-way 'data' mesh."""
    from aiohttp import web

    from illufly_tts_tpu_torch import pipeline as pipeline_mod
    from illufly_tts_tpu_torch.api import endpoints

    apps, pipes = [], []
    monkeypatch.setattr(endpoints, "create_app",
                        lambda **kw: apps.append(kw) or web.Application())
    monkeypatch.setattr(web, "run_app", lambda app, **kw: None)
    monkeypatch.setattr(pipeline_mod, "CachedTTSPipeline",
                        lambda **kw: pipes.append(kw) or "mesh pipeline")
    args = ["serve", "--dp", dp[0], "--port", "0"]
    if dp == "2":
        _two_cpu_devices(monkeypatch)
    else:
        args += ["--device", "cpu"]
    result = CliRunner().invoke(port_main.cli, args)
    if dp == "2-on-one-device":
        assert isinstance(result.exception, AssertionError), result.output
        assert str(result.exception).startswith("(2, 1, 1)")
        assert apps == [] and pipes == []
        return
    assert result.exit_code == 0, result.output
    if dp == "1":
        assert apps[0]["pipeline"] is None and apps[0]["device"] == "cpu"
        assert pipes == []
    else:
        assert apps[0]["pipeline"] == "mesh pipeline"
        mesh = pipes[0]["mesh"]
        assert mesh.shape == {"data": 2, "model": 1}
        assert mesh.data_devices == [torch.device("cpu")] * 2


@pytest.mark.parametrize("dp", ["1", "2-on-one-device", "2"])
def test_train_dp(dp, monkeypatch):
    """``train --dp 1`` trains on one device; ``--dp 2`` on a one-device
    host fails with the JAX ``make_mesh`` assert's message; over two
    devices ``--dp 2`` trains on two replicas (the batch of 1 rounds up to
    2)."""
    args = ["train", "--tiny", "--dp", dp[0], "--steps", "1",
            "--batch-size", "1", "--tokens", "16", "--frames", "8"]
    if dp == "2":
        _two_cpu_devices(monkeypatch)
    else:
        args += ["--device", "cpu"]
    result = CliRunner().invoke(port_main.cli, args)
    if dp == "2-on-one-device":
        assert isinstance(result.exception, AssertionError), result.output
        assert str(result.exception).startswith("(2, 1, 1)")
        return
    assert result.exit_code == 0, result.output
    assert "done: {" in result.output and "'loss'" in result.output


def test_convert_roundtrip_on_the_port(tmp_path):
    """``convert --device cpu``: a Kokoro-style .pt and .pt voice packs ->
    flax .msgpack + .npy voices; the .msgpack loads into the port exactly
    as the .pt does, and into the JAX engine as the JAX converter's tree."""
    from illufly_tts_tpu.engine.synthesizer import Synthesizer as JaxSynth
    from illufly_tts_tpu_torch.engine.synthesizer import Synthesizer
    from tests.torch_twin import TwinKModel

    cfg = port_main._tiny_cfg()
    torch.manual_seed(0)
    ckpt = tmp_path / "kokoro_tiny.pt"
    torch.save(TwinKModel(cfg).state_dict(), ckpt)
    vdir = tmp_path / "voices"
    vdir.mkdir()
    torch.save(torch.randn(8, 1, 2 * cfg.style_dim), vdir / "zf_test.pt")
    out = tmp_path / "weights.msgpack"
    result = CliRunner().invoke(port_main.cli, [
        "convert", str(ckpt), "-o", str(out), "--voices-dir", str(vdir),
        "--tiny", "--device", "cpu"])
    assert result.exit_code == 0, result.output
    pack = np.load(vdir / "zf_test.npy")
    assert pack.shape == (8, 1, 2 * cfg.style_dim)
    assert pack.dtype == np.float32

    s1 = Synthesizer(config=cfg, device="cpu")
    s1.load_params(str(ckpt))
    s2 = Synthesizer(config=cfg, device="cpu")
    s2.load_params(str(out))
    state2 = s2.model.state_dict()
    for name, value in s1.model.state_dict().items():
        assert torch.equal(value, state2[name]), name
    from illufly_tts_tpu.__main__ import _tiny_cfg
    from illufly_tts_tpu.model.convert import convert_checkpoint

    engine = JaxSynth(config=_tiny_cfg())
    engine.load_params(str(out))
    want = convert_checkpoint(torch.load(ckpt, weights_only=True),
                              engine.params)
    for a, b in zip(*map(jax.tree_util.tree_leaves, (engine.params, want))):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_train_voice_end_to_end_case(monkeypatch, tmp_path):
    """The JAX suite's slow-marked case, run here on the port at its tiny
    size (6 steps, batch 2, 16 tokens, 8 frames, ``--device cpu``)."""
    monkeypatch.setattr(jax_cases, "cli", port_main.cli)
    port_cases.run(jax_cases, ("test_train_voice_end_to_end", {}),
                   tmp_path=tmp_path)


def test_train_tiny_on_the_cpu(tmp_path):
    result = CliRunner().invoke(port_main.cli, [
        "train", "--tiny", "--device", "cpu", "--steps", "2",
        "--batch-size", "2", "--tokens", "16", "--frames", "8",
        "--checkpoint-dir", str(tmp_path / "ckpt")])
    assert result.exit_code == 0, result.output
    assert "done: {" in result.output and "'loss'" in result.output
    assert (tmp_path / "ckpt" / "step_00000002" / "state.pt").exists()


def test_synth_device_reaches_the_engine(monkeypatch, tmp_path):
    """``synth --device X`` builds its pipeline with ``device=X``; the
    default is None, which the engine reads as CUDA."""
    seen = []

    class Stop(Exception):
        pass

    def fake_pipeline(**kwargs):
        seen.append(kwargs["device"])
        raise Stop

    from illufly_tts_tpu_torch import pipeline as pipeline_mod

    monkeypatch.setattr(pipeline_mod, "CachedTTSPipeline", fake_pipeline)
    for args, want in ((["--device", "cpu"], "cpu"), ([], None)):
        result = CliRunner().invoke(
            port_main.cli, ["synth", "x", "-o", str(tmp_path / "a.wav"),
                            *args])
        assert isinstance(result.exception, Stop)
        assert seen[-1] == want


def test_python_dash_m_runs_the_port_cli():
    proc = subprocess.run(
        [sys.executable, "-m", "illufly_tts_tpu_torch", "--help"],
        capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert "serve" in proc.stdout and "client" in proc.stdout
