"""The model's operations for the audio delivered (each item at its own
tokens and fitted frames, counted by the configuration's family,
``run.family.utterance``) over the seconds it took times the card's dense
bf16 peak: the batches dispatched after the profiler stopped, over the
time from its stop to the window's end (``trace.untraced``), so that
neither the profiler nor its stop is counted."""
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
    return 100.0 * ops / (seconds * flops.PEAK_BF16)
