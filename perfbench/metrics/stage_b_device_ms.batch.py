"""Device ms of stage B (the F0/N towers, the decoder trunk, the
Generator, pcm16) per batch: the median over the traced batches of the
CUDA-event pair the engine records around each replayed stage B
(``perfbench/spans.py``)."""
import statistics

from perfbench import spans


def read(run):
    ms = spans.device_ms(run)
    return statistics.median(ms["stage_b"]) if ms and ms["stage_b"] else None
