"""Seconds of audio delivered (each item's fitted frames, not its padded
bucket) over the window's seconds, whole batches, last one included."""


def read(run):
    audio = sum(r["audio"].size for r in run.records
                if r.get("audio") is not None) / run.sample_rate
    return audio / run.window_s
