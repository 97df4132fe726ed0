"""Whole runs of the harness on the CPU at the tiny configuration (all
but the look for a card): the result line's schema, ``correct`` false when
the answers are altered where the engine produces them, and the refusals
(no card, no program, a forbidden module)."""
import json
import os
import shutil
import subprocess
import sys
import types

import numpy as np
import pytest

from perfbench.harness import check, main, registry

from .helpers import tiny_run, tiny_sizes

CELLS = registry.names("workloads")
ROOT = registry.ROOT


@pytest.mark.parametrize("cell", CELLS)
def test_result_line(cell):
    out = tiny_run(cell)
    assert list(out) == ["correct", "attempted", "failed", "metrics",
                         "device", "checks"]
    assert out["correct"] is True
    assert out["attempted"] >= 1 and 0 <= out["failed"] <= out["attempted"]
    wanted = registry.metrics_of(cell, registry.benchmark())["end_to_end"]
    assert set(out["metrics"]) == {m["name"] for m in wanted}
    for m in wanted:
        value = out["metrics"][m["name"]]
        assert value["unit"] == m["unit"] and value["value"] > 0
    limits = registry.load_json("workloads", cell)["check"]["limits"]
    assert set(out["checks"]) == set(limits)
    assert out["device"]["count"] == 1


def _alter(audio):
    """An answer altered where it is produced: its samples in reverse
    order (what it says garbled; its length, level and spectrum kept)."""
    return np.ascontiguousarray(np.asarray(audio)[..., ::-1])


@pytest.mark.parametrize("cell", CELLS)
def test_altered_answers_are_not_correct(cell, monkeypatch):
    from illufly_tts_tpu_torch.engine.synthesizer import Synthesizer

    collect, stream = Synthesizer.collect, Synthesizer.stream_decode

    def bad_collect(self, handle, pcm16=False):
        return [_alter(a) for a in collect(self, handle, pcm16)]

    def bad_stream(self, handle, *args, **kwargs):
        for chunk in stream(self, handle, *args, **kwargs):
            yield _alter(chunk)

    monkeypatch.setattr(Synthesizer, "collect", bad_collect)
    monkeypatch.setattr(Synthesizer, "stream_decode", bad_stream)
    out = tiny_run(cell)
    assert out["correct"] is False


def test_numbers_that_decide(monkeypatch):
    """Each number reads its fault: a missing answer, a wrong duration,
    another text's IPA."""
    answers = [{"ipa": "a", "voice": 0, "audio": np.ones(600, np.int16)},
               {"ipa": "b", "voice": 0, "audio": None}]
    rows = {("a", "v"): {"pred_dur": np.array([3, 3, 3]), "frames": 64}}

    class Judge:
        class ref:
            @staticmethod
            def quantize(d, m):
                import torch

                return torch.full((1, 3), 3)

        def durations(self, ipa, voice, row=None):
            import torch

            return torch.full((1, 3), 3.1), None

        def audio(self, *args, **kwargs):
            return np.ones(600, np.int16)

    out = check.judge(answers, rows, Judge(), {"kind": "pcm16"}, answers[:1],
                      ["v"])
    assert out["ipa_mismatch"] == 1 and out["unanswered"] == 1
    assert out["dur_mismatch"] == 0 and out["wave_err"] == 0.0
    rows[("a", "v")]["pred_dur"] = np.array([3, 4, 3])
    assert check.judge(answers, rows, Judge(), {"kind": "pcm16"},
                       answers[:1], ["v"])["dur_mismatch"] == 1


def test_forbidden_module_refuses(monkeypatch, capsys):
    monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))
    from perfbench.harness import configs
    import time

    args = main.parse(["--workload", "f32-serve-poisson", "--seed", "5",
                       "--seconds", "1", "--trace", "0"])
    rc = main.run(args, time.perf_counter(), device="cpu",
                  overrides={"config": tiny_sizes("f32-serve-poisson"),
                             "traffic": {"rate_per_s": 2.0}})
    assert rc != 0
    assert "{" not in capsys.readouterr().out


def _cmd(cwd):
    return subprocess.run(
        [sys.executable, "perfbench/run.py", "--workload", "f32-serve-poisson",
         "--seed", "2147483700", "--seconds", "1", "--trace", "0"],
        cwd=cwd, capture_output=True, text=True, timeout=300,
        env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})


def test_no_card_no_result():
    done = _cmd(ROOT)
    assert done.returncode != 0 and done.stdout.strip() == ""


def test_no_program_no_result(tmp_path):
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(registry.BENCH_DIR, tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    done = _cmd(tmp_path)
    assert done.returncode != 0 and done.stdout.strip() == ""


def test_reference_imports_nothing_of_the_program():
    code = ("import sys; import perfbench.reference.kokoro, "
            "perfbench.reference.mel, perfbench.harness.check; "
            "print(sorted({m.split('.')[0] for m in sys.modules}))")
    done = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    loaded = set(json.loads(done.stdout.replace("'", '"')))
    assert not loaded & {"jax", "jaxlib", "flax", "illufly_tts_tpu",
                         "illufly_tts_tpu_torch"}
