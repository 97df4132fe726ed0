"""Share of the traced window in which the engine's stream ran no stage:
one minus the sum of every traced stage A and stage B device interval
(``perfbench/spans.py``) over the window. What is left is the copies
between stages, the frame-total waits and the device's idle between
stages; read beside ``device_idle_share.batch``, it tells idle between
the stages from idle inside their graphs. The tracer synchronizes before
it stops, so every stage recorded in the window ran inside it."""
from perfbench import spans


def read(run):
    ms = spans.device_ms(run)
    if not ms:
        return None
    inside = sum(map(sum, ms.values())) / 1e3
    return 100.0 * (1.0 - inside / run.trace["window_s"])
