"""The program's own device spans of a ``--trace 1`` run, for the
``program_span`` metrics: the CUDA-event pairs ``illufly_tts_tpu_torch``'s
engine records around each replayed stage A and stage B while a
``torch.profiler`` runs (``utils/profiling.py::TIMERS.device_spans``), so
while the harness's ``Tracer`` ran. None where the run has no trace, the
program has no such recorder, or it recorded nothing."""


def device_ms(run, names=("stage_a", "stage_b")):
    """{span name: [ms of each span]} of ``names``, or None."""
    if not run.trace:
        return None
    try:
        from illufly_tts_tpu_torch.utils.profiling import TIMERS
    except ImportError:
        return None
    read = getattr(TIMERS, "device_spans", None)
    if read is None:
        return None
    out = {name: [] for name in names}
    for span in read():
        if span.name in out:
            out[span.name].append(span.ms)
    return out if any(out.values()) else None
