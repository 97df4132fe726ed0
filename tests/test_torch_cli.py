# -*- coding: utf-8 -*-
"""PyTorch port: the command line (``python -m illufly_tts_tpu_torch``).

The cases of ``tests/test_cli.py`` for the commands the port has (serve,
synth, server, api, client) run again on the port's ``cli``; ``convert``
and ``train-voice`` are not ported yet and their cases are left out. The
port's own rules: ``--dp`` above 1 is a usage error (data parallelism is
not ported), ``--device`` reaches the engine, and ``main()`` defaults to
``serve``."""
import subprocess
import sys

import pytest
import torch
from click.testing import CliRunner

from illufly_tts_tpu_torch import __main__ as port_main
from tests import test_cli as jax_cases
from tests import torch_port_cases as port_cases

torch.set_num_threads(2)

NOT_PORTED = ("test_convert_help", "test_convert_roundtrip",
              "test_train_voice_help", "test_train_voice_end_to_end")
CASES = port_cases.collect(jax_cases, exclude=NOT_PORTED)


def test_all_cli_cases_collected():
    assert len(CASES) == 4, sorted(CASES)


@pytest.mark.parametrize("case", sorted(CASES))
def test_cli_case_on_the_port(case, monkeypatch, tmp_path):
    monkeypatch.setattr(jax_cases, "cli", port_main.cli)
    port_cases.run(jax_cases, CASES[case], monkeypatch=monkeypatch,
                   tmp_path=tmp_path)


def test_commands_not_ported_are_absent():
    out = CliRunner().invoke(port_main.cli, ["--help"]).output
    for cmd in ("serve", "synth", "server", "api", "router", "client"):
        assert cmd in out, cmd
    for cmd in ("convert", "train"):
        assert f"  {cmd} " not in out, cmd


def test_serve_dp_above_one_is_a_usage_error():
    result = CliRunner().invoke(port_main.cli, ["serve", "--dp", "2"])
    assert result.exit_code == 2
    assert "data-parallel serving is not ported yet" in result.output


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
