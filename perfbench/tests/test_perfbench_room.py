"""Room for a second model family: a family, a configuration, a mix and a
cell that arrive as new files, with the cell appended to the lists of the
metrics it reports, pass the benchmark's own tests with no test edited.

``build`` makes such a copy of the benchmark: the toy family of
``test_perfbench_families.py`` (the Kokoro stack at half its sample rate,
with sizes of its own and a judge that reads each recorded row), a
configuration naming it, an English mix of the offline kind and a cell on
them. The suite's files then run over the copy in a process of their own.
Beside it: today's cells get the tiny sizes and overrides they were given
by name before these came from the family and the mix's kind."""
import json
import os
import shutil
import subprocess
import sys
import xml.etree.ElementTree as ET

import pytest

from perfbench.harness import registry

from .helpers import tiny_overrides, tiny_sizes
from .test_perfbench_families import TOY

FAMILY, CONFIG, MIX = "toy", "toy-room", "offline-b32-en"
CELL, OFFLINE = "toy-offline-en", "bf16-offline-b32"
# the suite's files whole, and the cases of the files whose every case
# runs a cell
FILES = ("test_perfbench_registry.py", "test_perfbench_traffic.py",
         "test_perfbench_spans.py", "test_perfbench_families.py")
CASES = ("test_perfbench_run.py::test_result_line",
         "test_perfbench_run.py::test_altered_answers_are_not_correct",
         "test_perfbench_control.py::test_control_fails_the_limits_tiny")
# the new files' own cases, each of which has to be among those that passed
MUST_PASS = (f"test_configuration_files[{CONFIG}]",
             "test_every_entry_has_its_file",
             f"test_deterministic_per_seed[{MIX}]",
             f"test_unique_texts_and_same_work_per_seed[{MIX}]",
             f"test_program_normalizes_as_composed[0-{MIX}]",
             "test_entries", f"test_a_family_imports_no_jax[{FAMILY}]",
             "test_a_family_of_new_files_runs_a_cell",
             f"test_result_line[{CELL}]",
             f"test_altered_answers_are_not_correct[{CELL}]",
             f"test_control_fails_the_limits_tiny[{CELL}]")


def build(dst, source: str = registry.BENCH_DIR) -> None:
    """``dst/BENCHMARK.json`` and ``dst/perfbench``: ``source`` (this
    ``perfbench`` directory, or another checkout's, such as its parent's,
    to see the same procedure there) copied, the toy family, its
    configuration, mix and cell added as new files, their entries added and
    the cell appended to every metric list that holds the offline cell."""
    copy = os.path.join(dst, "perfbench")
    shutil.copytree(source, copy, ignore=shutil.ignore_patterns("__pycache__"))
    kokoro = registry.family("kokoro")
    mix = {**registry.load_json("traffic", "offline-b32"),
           "languages": {"en": 0.8, "mixed": 0.15, "zh": 0.05}}
    cell = {**registry.load_json("workloads", OFFLINE), "config": CONFIG,
            "traffic": MIX}
    new = {("families", f"{FAMILY}.py"): TOY,
           ("configs", f"{CONFIG}.json"): json.dumps(
               {"family": FAMILY, "source": "https://arxiv.org/abs/2306.07691",
                "reduced": [], "sizes": kokoro.tiny("bfloat16")}),
           ("traffic", f"{MIX}.json"): json.dumps(mix),
           ("workloads", f"{CELL}.json"): json.dumps(cell)}
    for (kind, name), text in new.items():
        where = os.path.join(copy, kind, name)
        assert not os.path.exists(where), where
        with open(where, "w") as f:
            f.write(text)
    bench = registry.benchmark()
    bench["configs"].append(
        {"name": CONFIG, "source": "https://arxiv.org/abs/2306.07691",
         "file": f"perfbench/configs/{CONFIG}.json", "reduced": [],
         "why": "a second family, new files only"})
    bench["workloads"].append(
        {"name": CELL, "config": CONFIG, "traffic": MIX, "chips": 1,
         "why": "the offline deployment on a second family"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if OFFLINE in m.get("workloads", ()):
            m["workloads"].append(CELL)
    with open(os.path.join(dst, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f, indent=1)


def run_suite(dst) -> dict:
    """The selection (``FILES`` whole, ``CASES`` of the new cell) over the
    copy at ``dst``, in a process of its own with the copy first on the
    path and the program's checkout after it. -> {"rc", "passed" (test
    names), "other" (names of those that did not pass), "output"}."""
    tests = os.path.join("perfbench", "tests")
    report = os.path.join(dst, "report.xml")
    args = [os.path.join(tests, f) for f in FILES] + \
        [os.path.join(tests, f"{c}[{CELL}]") for c in CASES]
    done = subprocess.run(
        [sys.executable, "-m", "pytest", "-q", "-p", "no:cacheprovider",
         "-p", "no:randomly", "--rootdir", str(dst), f"--junitxml={report}",
         *args],
        cwd=dst, capture_output=True, text=True, timeout=1500,
        env={**os.environ, "PYTHONPATH": os.pathsep.join(
            [str(dst), registry.ROOT])})
    passed, other = [], []
    if os.path.exists(report):
        for case in ET.parse(report).getroot().iter("testcase"):
            bad = {c.tag for c in case} & {"failure", "error", "skipped"}
            (other if bad else passed).append(case.get("name"))
    return {"rc": done.returncode, "passed": passed, "other": other,
            "output": done.stdout[-6000:] + done.stderr[-2000:]}


def test_a_second_family_passes_the_suite(tmp_path):
    build(tmp_path)
    out = run_suite(tmp_path)
    assert out["rc"] == 0 and out["other"] == [], out["output"]
    assert out["passed"], out["output"]  # the selection is not empty
    missing = [name for name in MUST_PASS if name not in out["passed"]]
    assert missing == [], out["output"]


# ---- today's cells, as they were given their tiny runs by name -------------

KOKORO_TINY = {
    "n_token": 256, "hidden_dim": 32, "style_dim": 16, "max_dur": 10,
    "n_layer": 2, "text_encoder_kernel_size": 5, "sample_rate": 24000,
    "albert": {"vocab_size": 256, "embedding_size": 16, "hidden_size": 32,
               "num_heads": 4, "intermediate_size": 64, "num_layers": 2,
               "max_position": 512},
    "istftnet": {"upsample_rates": (10, 6), "upsample_kernel_sizes": (20, 12),
                 "upsample_initial_channel": 32,
                 "resblock_kernel_sizes": (3, 7),
                 "resblock_dilation_sizes": ((1, 3), (1, 3)),
                 "gen_istft_n_fft": 20, "gen_istft_hop_size": 5},
    "duration_bias": -1.0, "magnitude_gain": 0.05, "f0_gain": 0.1,
}
BY_NAME = {
    "f32-serve-poisson": ({"rate_per_s": 3.0}, {}),
    "f32-serve-repeat": ({"rate_per_s": 3.0,
                          "prompts": {"count": 4, "zipf": 1.0,
                                      "unique_share": 0.2}}, {}),
    "f32-stream-windowed": ({"streams": 40}, {}),
    OFFLINE: ({"batches": 6}, {"ahead_batches": 2}),
}


@pytest.mark.parametrize("cell", sorted(BY_NAME))
def test_todays_cells_get_the_same_tiny_run(cell):
    traffic, deployment = BY_NAME[cell]
    assert tiny_overrides(cell) == {"traffic": traffic,
                                    "deployment": deployment}
    dtype = "bfloat16" if "bf16" in cell else "float32"
    assert tiny_sizes(cell) == {**KOKORO_TINY, "dtype": dtype}
