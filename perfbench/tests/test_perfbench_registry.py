"""The harness finds every cell, configuration, traffic mix and metric by
its file name, and ``BENCHMARK.json`` keeps to the benchmark's contract."""
import json
import os
import re
import shutil

import pytest

from perfbench.harness import configs, registry

BENCH = registry.benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_every_entry_has_its_file():
    for cell in BENCH["workloads"]:
        data = registry.load_json("workloads", cell["name"])
        assert data["config"] == cell["config"]
        assert data["traffic"] == cell["traffic"]
        assert data["chips"] == cell["chips"]
        assert os.path.isfile(registry.path("traffic", cell["traffic"]))
    for cfg in BENCH["configs"]:
        assert cfg["file"] == f"perfbench/configs/{cfg['name']}.json"
        assert configs.load(cfg["name"])["dtype"] in ("float32", "bfloat16")
    for metric in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert callable(registry.reader(metric["name"]))


def test_files_and_entries_agree():
    """Every entry has its file; a cell, configuration or metric file that
    no entry names is one held back (``PERF.md``, Open questions), which a
    later change enrolls by an entry alone. Every configuration file is
    some cell's, and every configuration entry some enrolled cell's."""
    assert {w["name"] for w in BENCH["workloads"]} <= set(
        registry.names("workloads"))
    assert {c["name"] for c in BENCH["configs"]} <= set(
        registry.names("configs"))
    assert {c["name"] for c in BENCH["configs"]} == {
        w["config"] for w in BENCH["workloads"]}
    assert set(registry.names("configs")) == {
        registry.load_json("workloads", w)["config"]
        for w in registry.names("workloads")}
    assert {m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]} \
        <= set(registry.names("metrics"))
    for name in registry.names("workloads"):
        cell = registry.load_json("workloads", name)
        assert cell["config"] in registry.names("configs")
        assert cell["traffic"] in registry.names("traffic")
    for name in registry.names("metrics"):
        assert callable(registry.reader(name))


def test_contract_shape():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "perfbench/run.py"]
    assert BENCH["paths"] == ["perfbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    cells = len(BENCH["workloads"])
    assert sum(w["chips"] == 4 for w in BENCH["workloads"]) <= max(1, cells // 4)
    # a full check of 24 cells fits the driver's 43,200 seconds
    assert (2 + 14 * 24) * (BENCH["run_seconds"] + 60) + 2 * 90 * 24 \
        + 1200 <= 43200
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in BENCH[k]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    for cfg in BENCH["configs"]:
        assert set(cfg) == {"name", "source", "file", "reduced", "why"}
    for cell in BENCH["workloads"]:
        assert set(cell) == {"name", "config", "traffic", "chips", "why"}
        assert len(cell["why"]) <= 200 and "\n" not in cell["why"]
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    for m in metrics:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["moves"] in e2e
        for cell in m.get("workloads", []):
            reported = registry.metrics_of(cell, BENCH)["end_to_end"]
            assert m["moves"] in {x["name"] for x in reported}
    for cell in BENCH["workloads"]:
        mine = registry.metrics_of(cell["name"], BENCH)
        assert any(m["name"] == "setup_s" for m in mine["end_to_end"])
        assert len(mine["end_to_end"]) >= 2 and mine["per_layer"]


def test_a_new_cell_and_metric_are_files_alone(tmp_path, monkeypatch):
    """A later change adds a cell (and its mix) and a metric by adding
    files and entries; the registry finds them with no code edited."""
    copy = tmp_path / "perfbench"
    shutil.copytree(registry.BENCH_DIR, copy,
                    ignore=shutil.ignore_patterns("__pycache__"))
    cell = registry.load_json("workloads", "bf16-offline-b32")
    mix = registry.load_json("traffic", "offline-b32")
    (copy / "traffic" / "offline-b16.json").write_text(json.dumps(
        {**mix, "batch": 16}))
    (copy / "workloads" / "bf16-offline-b16.json").write_text(json.dumps(
        {**cell, "traffic": "offline-b16"}))
    (copy / "metrics" / "requests_done.batch.py").write_text(
        "def read(run):\n    return len(run.records)\n")
    bench = dict(BENCH)
    bench["workloads"] = BENCH["workloads"] + [
        {"name": "bf16-offline-b16", "config": "kokoro82m-zh-bf16",
         "traffic": "offline-b16", "chips": 1, "why": "half batches"}]
    bench["per_layer"] = BENCH["per_layer"] + [
        {"name": "requests_done.batch", "unit": "count", "better": "higher",
         "source": "host_clock", "layer": "model (model/)",
         "moves": "audio_s_per_s", "workloads": ["bf16-offline-b16"]}]
    bench["end_to_end"] = [
        {**m, "workloads": m["workloads"] + ["bf16-offline-b16"]}
        if m["name"] == "audio_s_per_s" else m for m in BENCH["end_to_end"]]
    monkeypatch.setattr(registry, "BENCH_DIR", str(copy))
    assert "bf16-offline-b16" in registry.names("workloads")
    assert registry.load_json("traffic", "offline-b16")["batch"] == 16
    mine = registry.metrics_of("bf16-offline-b16", bench)
    assert "requests_done.batch" in [m["name"] for m in mine["per_layer"]]
    assert "audio_s_per_s" in [m["name"] for m in mine["end_to_end"]]

    class Run:
        records = [1, 2, 3]

    assert registry.reader("requests_done.batch")(Run) == 3


@pytest.mark.parametrize("name", registry.names("configs"))
def test_configuration_files(name):
    """Every configuration: as its entry states it, where it has one, and
    read by the family it names into sizes with a compute type and a
    sample rate."""
    with open(registry.path("configs", name)) as f:
        raw = json.load(f)
    entry = next((c for c in BENCH["configs"] if c["name"] == name), None)
    if entry is not None:  # a configuration held back has no entry
        assert raw["source"] == entry["source"]
        assert raw["reduced"] == entry["reduced"]
    assert raw["family"] in registry.names("families")
    cfg = configs.family(name).sizes(raw)
    assert cfg["dtype"] in ("float32", "bfloat16")
    assert cfg["sample_rate"] > 0


KOKORO_CONFIGS = [n for n in registry.names("configs")
                  if configs.family_name(n) == "kokoro"]


@pytest.mark.parametrize("name", KOKORO_CONFIGS)
def test_kokoro_configuration_widths(name):
    with open(registry.path("configs", name)) as f:
        raw = json.load(f)
    assert raw["source"] == "https://huggingface.co/hexgrad/Kokoro-82M-v1.1-zh"
    assert raw["reduced"] == ["n_token"]
    # published widths, none cut
    assert raw["hidden_dim"] == 512 and raw["style_dim"] == 128
    assert raw["plbert"]["hidden_size"] == 768
    assert raw["plbert"]["num_hidden_layers"] == 12
    assert raw["istftnet"]["upsample_initial_channel"] == 512
    assert {"duration_bias", "magnitude_head_gain",
            "f0_head_gain"} <= set(raw["assumed"])
