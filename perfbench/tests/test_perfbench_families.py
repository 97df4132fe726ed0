"""The model family layer (``perfbench/families/``): a configuration names
its family, and the harness takes the model's sizes, seeded weights and
voices, engine, reference, id encoder, Generator-pass count, trace classes
and operation counts from it.

- (a), (b): the Kokoro family gives what the harness gave before it had
  families (numbers frozen from that code at the same seeds): the seeded
  weights and voices bitwise, and on a tiny run the numbers that decide
  ``correct``, the delivered rate, ``mfu``, the pass count, the trace's
  kernel classes and the kernels' bounds;
- (c): a family that exists only as new files (a toy, written here into a
  copy of ``perfbench/``) runs a cell through ``main.run``, and the metric
  readers use its samples per frame, pass class and counts;
- (d): no harness or metric module names Kokoro's modules, and no family
  imports JAX or the JAX package."""
import ast
import contextlib
import hashlib
import io
import itertools
import json
import os
import shutil
import subprocess
import sys
import time
from types import SimpleNamespace

import pytest
import torch

from perfbench import flops
from perfbench.harness import configs, drive, main, registry, trace

from .helpers import tiny_overrides, tiny_sizes

BENCH_DIR = registry.BENCH_DIR

# sha256 of every weight (by name: name, shape, float32 bytes) and then of
# two voice packs, on the CPU
DIGESTS = {
    ("kokoro82m-zh-f32", 2147483659):
        "6e4fb142882275fb4242a51a1282eb5180db34acd876e1ffaa9a6a084dbf0c9f",
    ("kokoro82m-zh-f32", 3000000019):
        "d55fb69dd2244593c5a514d44674c320dd2215c9c2e6eb911f83d42db4dd7d0e",
    ("kokoro82m-zh-bf16", 2147483659):
        "6e4fb142882275fb4242a51a1282eb5180db34acd876e1ffaa9a6a084dbf0c9f",
    ("kokoro82m-zh-bf16", 3000000019):
        "d55fb69dd2244593c5a514d44674c320dd2215c9c2e6eb911f83d42db4dd7d0e",
}


def _digest(params, packs) -> str:
    h = hashlib.sha256()
    for name in sorted(params):
        t = params[name].contiguous()
        h.update(name.encode())
        h.update(str(tuple(t.shape)).encode())
        h.update(t.numpy().tobytes())
    h.update(packs.contiguous().numpy().tobytes())
    return h.hexdigest()


@pytest.mark.parametrize("name,seed", sorted(DIGESTS))
def test_seeded_weights_and_voices_are_frozen(name, seed):
    family = configs.family(name)
    cfg = configs.load(name)
    assert _digest(family.make(cfg, seed, "cpu"),
                   family.voices(cfg, seed, 2, "cpu")) == DIGESTS[name, seed]


def _fixed_clock_run(monkeypatch, cell, overrides, seconds=0.35):
    """``main.run`` of ``cell`` on the CPU with the window's clock a
    counter (0.1 s a reading), so that the same batches are dispatched on
    every machine. -> (result line, the run the readers were handed)."""
    torch.set_num_threads(2)
    seen = []
    read = registry.reader

    def reader(name):
        fn = read(name)

        def wrapped(run):
            seen.append(run)
            return fn(run)
        return wrapped

    tick = itertools.count()
    monkeypatch.setattr(registry, "reader", reader)
    monkeypatch.setattr(drive, "time", SimpleNamespace(
        perf_counter=lambda: next(tick) * 0.1))
    args = main.parse(["--workload", cell, "--seed", "3000000123",
                       "--seconds", str(seconds), "--trace", "0"])
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = main.run(args, time.perf_counter(), device="cpu",
                      overrides=overrides)
    assert rc == 0, out.getvalue()
    return json.loads(out.getvalue().strip().splitlines()[-1]), seen[0]


KERNELS = ["void istft_head_bf16_kernel", "adain_snake_conv_tile_bf16_kernel",
           "chunk_moments<bf16>", "finish_rows", "split_weights_kernel",
           "elemWiseRNNcell", "nvjet_tst_64x8", "sm90_xmma_gemm",
           "Memcpy HtoD (Pageable -> Device)",
           "void at::native::vectorized_elementwise_kernel",
           "cudaGraphLaunch"]
# the bf16 offline cell's tiny run, seed 3000000123, two batches
FROZEN_RUN = {
    "checks": {"ipa_mismatch": 0, "unanswered": 0, "dur_off": 0,
               "mel_err": 0.042327397025827614,
               "mel_med": 0.030506311367880158},
    "audio_s_per_s": 474.28125,
    "attempted": 64,
    "mfu": 0.0966397684206269,
    "passes": 0,
    "samples_per_frame": 600,
    "classes": ["istft", "fused_conv", "adain_fold", "adain_fold",
                "conv_weight_split", "lstm", "other", "conv_gemm", "memcpy",
                "elementwise", "other"],
    "pass_class": "istft",
    "bounds": [0.0003889552047761193, 0.00031177361194029867],
}


def test_tiny_run_numbers_are_frozen(monkeypatch):
    cell = "bf16-offline-b32"
    cfg = tiny_sizes(cell)
    line, run = _fixed_clock_run(monkeypatch, cell, {
        "config": cfg, **tiny_overrides(cell)})
    want = FROZEN_RUN
    assert line["correct"] is True
    assert line["attempted"] == want["attempted"]
    got = {k: v["value"] for k, v in line["checks"].items()}
    assert set(got) == set(want["checks"])
    for k, v in want["checks"].items():
        assert got[k] == pytest.approx(v, rel=1e-6, abs=0), k
    assert line["metrics"]["audio_s_per_s"]["value"] == want["audio_s_per_s"]
    resumed = SimpleNamespace(**{**vars(run), "trace_resumed": 0.3})
    assert registry.reader("mfu.batch")(resumed) == want["mfu"]
    assert run.after["generator_passes"] - run.before["generator_passes"] \
        == want["passes"]
    assert run.samples_per_frame == want["samples_per_frame"]
    family = run.family
    classes = trace.compile_classes(family.TRACE_CLASSES)
    assert [trace.kernel_class(n, classes) for n in KERNELS] \
        == want["classes"]
    assert family.PASS_CLASS == want["pass_class"]
    assert [family.conv_bound(cfg, 32, 1024, "bfloat16"),
            family.fold_bound(cfg, 32, 512, 1024, "bfloat16")] \
        == want["bounds"]


# ---- (c) a family of new files ---------------------------------------------

TOY = '''"""A family for the tests alone: the Kokoro stack served at half its
sample rate (every second sample), with a count of Generator passes and a
pass class of its own, and a judge that reads each recorded row."""
from perfbench.harness import registry

KOKORO = registry.family("kokoro")
PASS_CLASS = "toy_pass"
TRACE_CLASSES = ((PASS_CLASS, r"istft"),) + KOKORO.TRACE_CLASSES[1:]
make, voices, encode = KOKORO.make, KOKORO.voices, KOKORO.encode
conv_bound, fold_bound = KOKORO.conv_bound, KOKORO.fold_bound
PASSES = [0]  # collects so far: one Generator pass a batch


def _tuples(x):
    if isinstance(x, dict):
        return {k: _tuples(v) for k, v in x.items()}
    return tuple(map(_tuples, x)) if isinstance(x, list) else x


def sizes(raw):
    cfg = _tuples(raw["sizes"])
    return {**cfg, "sample_rate": cfg["sample_rate"] // 2}


def tiny(dtype="float32"):
    return sizes({"sizes": KOKORO.tiny(dtype)})


def _kokoro(cfg):
    return {**cfg, "sample_rate": 2 * cfg["sample_rate"]}


def samples_per_frame(cfg):
    return KOKORO.samples_per_frame(cfg) // 2


def utterance(cfg, tokens, frames):
    return 1000.0 * tokens + frames


def generator_passes():
    return PASSES[0]


def row_extras(handle, i):
    return {"row": i}


def engine(cfg, params, device, **buckets):
    synth = KOKORO.engine(_kokoro(cfg), params, device, **buckets)
    collect = synth.collect

    def half(handle, pcm16=False):
        PASSES[0] += 1
        return [a[::2].copy() for a in collect(handle, pcm16)]

    synth.collect = half
    return synth


ROWS = [0]  # recorded rows the judge's durations were handed


def _recorded(row):
    """The extras the recorder kept of ``row``; None for no row, or for a
    control's, which records nothing."""
    if row is None or "extras" not in row:
        return None
    assert row["extras"]["row"] >= 0
    return row["extras"]


class Judge(KOKORO.Judge):
    def __init__(self, cfg, params, packs, quant=None):
        super().__init__(_kokoro(cfg), params, packs, quant)

    def durations(self, ipa, voice, row=None):
        if _recorded(row) is not None:
            ROWS[0] += 1
        return super().durations(ipa, voice, row=row)

    def audio(self, *args, row=None, **kwargs):
        _recorded(row)
        out = super().audio(*args, row=row, **kwargs)
        return None if out is None else out[::2].copy()
'''


@pytest.fixture
def toy_bench(tmp_path, monkeypatch):
    """A copy of ``perfbench/`` with the toy family, a configuration that
    names it and a cell on it, each a new file; the cell enrolled under
    the existing offline metrics."""
    copy = tmp_path / "perfbench"
    shutil.copytree(BENCH_DIR, copy,
                    ignore=shutil.ignore_patterns("__pycache__"))
    (copy / "families" / "toy.py").write_text(TOY)
    sizes = registry.family("kokoro").tiny("bfloat16")
    (copy / "configs" / "toy-tiny.json").write_text(json.dumps(
        {"family": "toy", "sizes": sizes}))
    cell = registry.load_json("workloads", "bf16-offline-b32")
    (copy / "workloads" / "toy-offline.json").write_text(json.dumps(
        {**cell, "config": "toy-tiny"}))
    bench = registry.benchmark()
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "bf16-offline-b32" in m.get("workloads", ()):
            m["workloads"] = m["workloads"] + ["toy-offline"]
    monkeypatch.setattr(registry, "BENCH_DIR", str(copy))
    monkeypatch.setattr(registry, "benchmark", lambda root=None: bench)
    return bench


def test_a_family_of_new_files_runs_a_cell(toy_bench, monkeypatch):
    kokoro = registry.family("kokoro")
    toy = configs.family("toy-tiny")
    assert toy.PASS_CLASS != kokoro.PASS_CLASS
    toy.ROWS[0] = 0
    line, run = _fixed_clock_run(monkeypatch, "toy-offline",
                                 tiny_overrides("toy-offline"))
    assert line["correct"] is True, line["checks"]
    assert run.family is toy
    cfg = run.cfg
    assert cfg["sample_rate"] == 12000
    assert run.samples_per_frame == 300 != kokoro.samples_per_frame(cfg)
    done = [r for r in run.records if r.get("audio") is not None]
    assert done and all(r["audio"].size % 300 == 0 for r in done)
    assert line["metrics"]["audio_s_per_s"]["value"] == pytest.approx(
        sum(r["audio"].size for r in done) / 12000 / run.window_s)
    # the judge's durations read the recorded row of every sampled answer
    assert toy.ROWS[0] == min(len(done), run.cell["check"]["sample"])
    batches = len(done) // 32
    assert run.after["generator_passes"] - run.before["generator_passes"] \
        == batches
    # the per-layer readers, fed what a traced run would hold
    resumed = SimpleNamespace(**{**vars(run), "trace_resumed": 0.3})
    late = [r for r in done if r["sent"] >= 0.3]
    ops = sum(1000.0 * len(toy.encode(r["ipa"])) + r["audio"].size // 300
              for r in late)
    assert registry.reader("mfu.batch")(resumed) == pytest.approx(
        100.0 * ops / ((run.t_end - 0.3) * flops.PEAK_BF16))
    traced = SimpleNamespace(**{**vars(run), "trace": {"classes": {
        "toy_pass": {"launches": 3, "seconds": 0.01},
        "fused_conv": {"launches": 144, "seconds": 0.5},
        "adain_fold": {"launches": 420, "seconds": 0.25}}}})
    assert registry.reader("fused_conv_roofline.batch")(traced) == \
        pytest.approx(100.0 * 3 * toy.conv_bound(cfg, 32, 1024, cfg["dtype"])
                      / 0.5)
    assert registry.reader("adain_fold_roofline.batch")(traced) == \
        pytest.approx(100.0 * 3 * toy.fold_bound(cfg, 32, 512, 1024,
                                                 cfg["dtype"]) / 0.25)
    kokoro_traced = SimpleNamespace(**{**vars(traced), "trace": {"classes": {
        "istft": {"launches": 3, "seconds": 0.01},
        "fused_conv": {"launches": 144, "seconds": 0.5}}}})
    assert registry.reader("fused_conv_roofline.batch")(kokoro_traced) is None


def test_a_configuration_without_a_family_is_refused(tmp_path, monkeypatch):
    copy = tmp_path / "perfbench"
    (copy / "configs").mkdir(parents=True)
    raw = registry.load_json("configs", "kokoro82m-zh-bf16")
    del raw["family"]
    (copy / "configs" / "nameless.json").write_text(json.dumps(raw))
    monkeypatch.setattr(registry, "BENCH_DIR", str(copy))
    with pytest.raises(ValueError, match="family"):
        configs.load("nameless")


# ---- (d) source guards -----------------------------------------------------

KOKORO_WORDS = ("perfbench.reference.kokoro", "reference import kokoro",
                "KokoroModel", "istft_oa", "istftnet")
FORBIDDEN = {"jax", "jaxlib", "flax", "illufly_tts_tpu"}


def _sources(kind):
    folder = os.path.join(BENCH_DIR, kind)
    return sorted(os.path.join(kind, f) for f in os.listdir(folder)
                  if f.endswith(".py"))


@pytest.mark.parametrize("path", _sources("harness") + _sources("metrics"))
def test_harness_and_metrics_name_no_kokoro_module(path):
    with open(os.path.join(BENCH_DIR, path)) as f:
        src = f.read()
    assert [w for w in KOKORO_WORDS if w in src] == []


def _imported(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


@pytest.mark.parametrize("name", registry.names("families"))
def test_a_family_imports_no_jax(name):
    with open(registry.path("families", name)) as f:
        tree = ast.parse(f.read())
    assert {m.split(".")[0] for m in _imported(tree)} & FORBIDDEN == set()
    # and loads none of them, its lazy imports of the program included
    code = ("import sys; from perfbench.harness import registry; "
            f"fam = registry.family({name!r}); fam.generator_passes(); "
            "import json; print(json.dumps(sorted("
            "{m.split('.')[0] for m in sys.modules})))")
    done = subprocess.run([sys.executable, "-c", code],
                          cwd=os.path.dirname(BENCH_DIR), capture_output=True,
                          text=True, timeout=300)
    assert done.returncode == 0, done.stderr
    assert set(json.loads(done.stdout)) & FORBIDDEN == set()
