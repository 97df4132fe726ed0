"""The numbers added beside the waveform's: the gain, durations off by a
frame or more, the model-operations share read after the profiler has
stopped, and the Generator's conditioning that decides which frames a
waveform comparison can hold to (``perfbench/conditioning.py``)."""
import math
from types import SimpleNamespace

import numpy as np

from perfbench import conditioning, flops, readings
from perfbench.harness import check, registry
from perfbench.reference import vocab

KOKORO = registry.family("kokoro")


class _Judge:
    """The reference's durations 3.1 frames a token; its audio a tone."""

    class ref:
        @staticmethod
        def quantize(d, m):
            import torch

            return torch.full((1, 3), 3)

    def durations(self, ipa, voice, row=None):
        import torch

        return torch.full((1, 3), 3.1), None

    def audio(self, *args, **kwargs):
        return (1000 * np.sin(np.arange(600) * 0.1)).astype(np.int16)


def _judge(audio, dur):
    answers = [{"ipa": "a", "voice": 0, "audio": audio}]
    rows = {("a", "v"): {"pred_dur": np.array(dur), "frames": 64}}
    return check.judge(answers, rows, _Judge(), {"kind": "pcm16"}, answers,
                       ["v"])


def test_gain_reads_a_scaled_answer():
    tone = _Judge().audio()
    assert _judge(tone, [3, 3, 3])["gain_err"] == 0.0
    doubled = _judge((2 * tone.astype(np.int32)).astype(np.int16), [3, 3, 3])
    assert math.isclose(doubled["gain_err"], math.log(2.0), rel_tol=1e-3)
    assert doubled["mel_err"] < 1e-6  # the gain-matched distance is blind


def test_mel_med_is_the_median_answer():
    tone = _Judge().audio()
    answers = [{"ipa": "a", "voice": 0, "audio": tone},
               {"ipa": "a", "voice": 0, "audio": tone},
               {"ipa": "a", "voice": 0, "audio": (1000 * np.sin(
                   np.arange(600) * 0.9)).astype(np.int16)}]
    rows = {("a", "v"): {"pred_dur": np.array([3, 3, 3]), "frames": 64}}
    out = check.judge(answers, rows, _Judge(), {"kind": "pcm16"}, answers,
                      ["v"])
    assert out["mel_med"] < 1e-6 < out["mel_err"]


def test_dur_off_reads_durations_moved():
    tone = _Judge().audio()
    assert _judge(tone, [3, 3, 4])["dur_off"] == 1   # 0.9 from 3.1
    assert _judge(tone, [3, 3, 4])["dur_mismatch"] == 1
    assert _judge(tone, [3, 2, 3])["dur_off"] == 1   # 1.1 from 3.1
    assert _judge(tone, [5, 5, 5])["dur_off"] == 3


def _run(resumed, t_end=50.0):
    cfg = KOKORO.tiny("bfloat16")
    recs = [{"ipa": "ni", "audio": np.zeros(600 * 9), "sent": t}
            for t in (1.0, 20.0, 30.0, 40.0)]
    return SimpleNamespace(family=KOKORO, cfg=cfg, records=recs,
                           trace_resumed=resumed,
                           t_end=t_end, samples_per_frame=600, window_s=49.0)


def test_mfu_reads_the_untraced_part_of_the_window():
    read = registry.reader("mfu.batch")
    one = KOKORO.utterance(KOKORO.tiny("bfloat16"), len(vocab.encode("ni")),
                           9)
    got = read(_run(resumed=15.0))  # three items dispatched after the stop
    assert math.isclose(got, 100.0 * 3 * one / (35.0 * flops.PEAK_BF16))
    assert read(_run(resumed=None)) is None        # no trace
    assert read(_run(resumed=55.0)) is None        # traced to the end


def test_unvoiced_frames_are_well_conditioned_tiny():
    rows = {r["f0"]: r for r in conditioning.readings(
        KOKORO.tiny(), 2147483999, 16, "cpu")}
    unvoiced = rows["unvoiced"]
    assert unvoiced["float32"] < 1e-4 and unvoiced["program"] < 1e-4
    assert unvoiced["tf32_control"] > 10 * unvoiced["float32"]


def test_readings_need_a_card(monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert readings.main(["--workload", "bf16-offline-b32", "--seeds",
                          "1,2", "--seconds", "1"]) != 0
