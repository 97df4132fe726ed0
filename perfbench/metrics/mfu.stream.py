"""The model's operations for the streams delivered (each at its own
tokens and frames, counted by the configuration's family,
``run.family.utterance``) over the seconds they took times the card's TF32
peak, the fastest rate for float32 inputs: the streams started after the
profiler stopped, over the time from its stop to the window's end
(``trace.untraced``), so that neither the profiler nor its stop is
counted."""
from perfbench import flops
from perfbench.harness import trace


def read(run):
    part = trace.untraced(run)
    if part is None:
        return None
    recs, seconds = part
    fam = run.family
    ops = sum(fam.utterance(run.cfg, len(fam.encode(r["ipa"])),
                            r["audio"].size // run.samples_per_frame)
              for r in recs if r.get("audio") is not None)
    return 100.0 * ops / (seconds * flops.PEAK_TF32)
