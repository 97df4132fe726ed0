"""Device ms of stage A (ALBERT, the duration LSTMs, ``duration_proj``)
per batch: the median over the traced batches of the CUDA-event pair the
engine records around each replayed stage A (``perfbench/spans.py``)."""
import statistics

from perfbench import spans


def read(run):
    ms = spans.device_ms(run)
    return statistics.median(ms["stage_a"]) if ms and ms["stage_a"] else None
