"""The comparison that decides ``correct``.

What the window produced is held to the plain reference (the
configuration's family's ``Judge``, ``perfbench/families/<family>.py``,
over ``perfbench/reference/``) after the window has closed, the peak
memory read and the program's state freed:

- ``ipa_mismatch``: answers whose text the pipeline did not hand to the
  engine as the IPA the frozen tables spell for it (every answer);
- ``unanswered``: answers that failed or never came where the reference
  answers (every answer; a windowed stream that the reference cannot
  window either is no such answer);
- ``dur_mismatch``: stage A. Tokens of the sampled answers whose integer
  duration (frames) differs from the reference's rounded one (an exact
  comparison: the configuration's durations lie 0.18 frames or more from a
  rounding boundary, PERF.md);
- ``wave_err``: stage B and the format. For each sampled answer, the
  reference renders the engine's durations at the engine's frame bucket
  (for a stream: windowed as the engine windows it) and the served audio
  is held to it: rms of the difference over rms of the reference; the
  worst answer;
- ``mel_err``: the same audio held to it by log-mel distance with the gain
  removed (``perfbench/reference/mel.py``); the worst answer;
- ``mel_med``: the median answer's ``mel_err``: steadier than the worst
  answer's, whose bfloat16 reading follows the few answers in which the
  rounding grows most (``PERF.md``, Limits);
- ``gain_err``: the gain that ``mel_err`` removes: |ln(rms of the served
  audio / rms of the reference's)|, the worst answer;
- ``dur_off``: stage A, for a compute type whose durations may round the
  other way near a boundary: tokens of the sampled answers whose integer
  duration lies ``DUR_OFF`` frames or more from the reference's unrounded
  one (a sound engine's lies at most half a frame and its rounding error
  from it; one moved by a frame lies 0.5 to 1.5 from it, past
  ``DUR_OFF`` for most tokens of durations 2.8-3.3 frames, and one moved
  by two frames 1.5 or more).

A cell compares the numbers its ``check.limits`` names.

The sample is drawn from the seed among the answers that came, with the
longest one in it. The reference follows the engine's durations into
stage B (it cannot align audio made with others); ``dur_mismatch`` checks
the durations themselves. An answer of the wrong length reads
``NO_MATCH``.

A control stands in for the program: the reference itself, its products'
operands rounded to a lower precision (``CONTROLS``), computes its own
durations and audio, and is judged as the program is."""
from __future__ import annotations

from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from perfbench.reference import mel

NO_MATCH = 1e9
DUR_OFF = 0.75


def round_mantissa(bits: int) -> Callable:
    """Round float32 to ``bits`` explicit mantissa bits, nearest even: 10
    is TF32's operand precision."""
    drop = 23 - bits

    def q(t: torch.Tensor) -> torch.Tensor:
        i = t.contiguous().view(torch.int32)
        half = (1 << (drop - 1)) - 1
        odd = (i >> drop) & 1
        return ((i + half + odd) & ~((1 << drop) - 1)).view(torch.float32)

    return q


def fp8_e4m3(t: torch.Tensor) -> torch.Tensor:
    """Per-tensor scaled float8 e4m3, as fp8 inference keeps its operands."""
    scale = t.abs().amax().clamp(min=1e-12) / 448.0
    return (t / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale


# the nearest precision below each configuration's: TF32 for float32 (TF32
# off), fp8 for bfloat16
CONTROLS = {"float32": round_mantissa(10), "bfloat16": fp8_e4m3}


def rel_rms(got: np.ndarray, want: np.ndarray) -> float:
    if got.shape != want.shape:
        return NO_MATCH
    g, w = got.astype(np.float64), want.astype(np.float64)
    return float(np.sqrt(np.mean((g - w) ** 2))
                 / max(np.sqrt(np.mean(w ** 2)), 1e-12))


def log_gain(got: np.ndarray, want: np.ndarray) -> float:
    if got.shape != want.shape:
        return NO_MATCH
    g = np.sqrt(np.mean(got.astype(np.float64) ** 2))
    w = np.sqrt(np.mean(want.astype(np.float64) ** 2))
    return float(abs(np.log(max(g, 1e-12) / max(w, 1e-12))))


def pick_sample(answers: List[dict], count: int, seed: int,
                size: Callable = lambda a: a["audio"].size) -> List[dict]:
    """``count`` answers that came, drawn from ``seed``, the longest by
    ``size`` among them."""
    came = [a for a in answers if a.get("audio") is not None or
            "audio" not in a]
    if not came:
        return []
    rng = np.random.default_rng(seed ^ 0xC4EC)
    longest = max(came, key=size)
    rest = [a for a in came if a is not longest]
    take = rng.choice(len(rest), min(count - 1, len(rest)), replace=False)
    return [longest] + [rest[i] for i in sorted(take)]


def judge(answers: List[dict], rows: Dict[tuple, dict], judge_,
          form: dict, sample: List[dict], voice_names: List[str],
          worst: Optional[list] = None) -> Dict[str, float]:
    """The run's numbers (those of the module's docstring).

    ``answers``: every request due in the window, {"ipa" (expected),
    "voice", "audio" (served, None where it failed)}; ``rows``: the
    recorder's (IPA, voice name) -> engine durations, frame bucket and
    the family's extras, each handed to the judge's ``durations`` and
    ``audio`` with its answer; ``judge_``: the family's ``Judge``; ``worst``
    gathers (wave_err, mel_err, index, ids) of each sampled answer."""
    out = {"ipa_mismatch": 0, "unanswered": 0, "dur_mismatch": 0,
           "dur_off": 0, "wave_err": 0.0, "mel_err": 0.0, "mel_med": 0.0,
           "gain_err": 0.0}
    mels = []
    for a in answers:
        row = rows.get((a["ipa"], voice_names[a["voice"]]))
        if row is None:
            out["ipa_mismatch"] += 1
        if a.get("audio") is None:
            refused = (row is not None and form["kind"] == "stream"
                       and 2 * (form["window"] + 2 * form["halo"])
                       > 2 * row["frames"] + 2 * form["halo"])
            if not refused:
                out["unanswered"] += 1
    for a in sample:
        row = rows.get((a["ipa"], voice_names[a["voice"]]))
        if row is None:
            continue  # counted above
        ref_float, d = judge_.durations(a["ipa"], a["voice"], row=row)
        n = ref_float.shape[-1]
        port_dur = np.asarray(row["pred_dur"][:n], np.int64)
        ref_dur = judge_.ref.quantize(ref_float, torch.ones_like(ref_float))
        out["dur_mismatch"] += int((ref_dur[0].cpu().numpy()
                                    != port_dur).sum())
        out["dur_off"] += int((np.abs(port_dur - ref_float[0].double().cpu()
                                      .numpy()) >= DUR_OFF).sum())
        want = judge_.audio(a["ipa"], a["voice"], port_dur, row["frames"],
                            form, d=d, row=row)
        got = a["audio"]
        err = NO_MATCH if want is None else rel_rms(got, want)
        out["wave_err"] = max(out["wave_err"], err)
        err_mel = NO_MATCH if want is None or got.shape != want.shape else \
            mel.gain_matched_l1(got, want)
        out["mel_err"] = max(out["mel_err"], err_mel)
        mels.append(err_mel)
        out["gain_err"] = max(out["gain_err"], NO_MATCH if want is None
                              else log_gain(got, want))
        if worst is not None:
            worst.append((err, err_mel, a.get("index"), n))
    if mels:
        out["mel_med"] = float(np.median(mels))
    return out


def control_answers(sample: List[dict], control, form: dict,
                    frame_buckets, voice_names: List[str]) -> tuple:
    """The control in the program's place for ``sample``: its own durations
    (rounded as the engine rounds), its own frame bucket and audio, from
    no recorded row (what the engine drew, the control draws itself). ->
    (answers, rows) as ``judge`` takes them."""
    answers, rows = [], {}
    for a in sample:
        dur_f, d = control.durations(a["ipa"], a["voice"], row=None)
        ids, mask, _ = control.inputs(a["ipa"], a["voice"])
        dur = control.ref.quantize(dur_f, mask)[0].cpu().numpy()
        frames = a.get("frames") or _pick(frame_buckets, int(dur.sum()))
        audio = control.audio(a["ipa"], a["voice"], dur, frames, form, d=d)
        rows[(a["ipa"], voice_names[a["voice"]])] = {"pred_dur": dur,
                                                     "frames": frames}
        answers.append({**a, "audio": audio})
    return answers, rows


def _pick(buckets, needed):
    for b in buckets:
        if needed <= b:
            return b
    return buckets[-1]


def verdict(numbers: Dict[str, float], limits: Dict[str, float]) -> bool:
    return all(numbers[k] <= limit for k, limit in limits.items())
