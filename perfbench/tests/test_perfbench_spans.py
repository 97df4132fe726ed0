"""The ``program_span`` readers (``perfbench/spans.py``) against a
synthetic run and a recorder filled with stand-in event pairs: each reads
the program's device spans, and none reads anything without a trace or
without spans."""
from types import SimpleNamespace

import pytest

from perfbench.harness import registry

READERS = ("stage_a_device_ms.batch", "stage_b_device_ms.batch",
           "outside_stage_share.batch")


class _Event:
    def __init__(self, ms):
        self.ms = ms

    def query(self):
        return True

    def elapsed_time(self, other):
        return other.ms - self.ms


@pytest.fixture
def recorder(monkeypatch):
    from illufly_tts_tpu_torch.utils import profiling

    timers = profiling.StageTimers()
    monkeypatch.setattr(profiling, "TIMERS", timers)
    return timers


def _fill(timers):
    # three batches: stage A 10, 12, 30 ms; stage B 120, 130, 140 ms
    t = 0.0
    for batch, (a, b) in enumerate(((10, 120), (12, 130), (30, 140))):
        for name, ms in (("stage_a", a), ("stage_b", b)):
            timers.add_device(name, _Event(t), _Event(t + ms), batch,
                              "cuda:0")
            t += ms + 1.0


def test_readers_read_the_device_spans(recorder):
    _fill(recorder)
    run = SimpleNamespace(trace={"window_s": 1.0, "busy_s": 0.5})
    read = {name: registry.reader(name)(run) for name in READERS}
    assert read["stage_a_device_ms.batch"] == 12
    assert read["stage_b_device_ms.batch"] == 130
    assert read["outside_stage_share.batch"] == pytest.approx(
        100.0 * (1.0 - 0.442))


@pytest.mark.parametrize("name", READERS)
def test_nothing_to_read(recorder, name):
    reader = registry.reader(name)
    run = SimpleNamespace(trace={"window_s": 1.0, "busy_s": 0.5})
    assert reader(run) is None  # a trace, no spans
    _fill(recorder)
    assert reader(SimpleNamespace(trace=None)) is None  # spans, no trace


@pytest.mark.parametrize("name", READERS)
def test_a_program_without_the_recorder(monkeypatch, name):
    """The parent of the change that added the spans: ``TIMERS`` without
    ``device_spans``."""
    from illufly_tts_tpu_torch.utils import profiling

    monkeypatch.setattr(profiling, "TIMERS", SimpleNamespace(total={}))
    run = SimpleNamespace(trace={"window_s": 1.0, "busy_s": 0.5})
    assert registry.reader(name)(run) is None


def test_entries():
    """Each reader is enrolled in the offline cell; a later cell enrolls by
    an entry, and every cell listed is one that reports the rate."""
    bench = registry.benchmark()
    entries = {m["name"]: m for m in bench["per_layer"]}
    cells = {w["name"] for w in bench["workloads"]}
    for name in READERS:
        m = entries[name]
        assert m["source"] == "program_span"
        assert m["moves"] == "audio_s_per_s"
        assert "bf16-offline-b32" in m["workloads"]
        for cell in m["workloads"]:
            assert cell in cells and cell in registry.names("workloads")
            reported = registry.metrics_of(cell, bench)["end_to_end"]
            assert "audio_s_per_s" in {x["name"] for x in reported}
