"""95th percentile, in ms, over every request due in the window that
completed: from the instant it was due (open loop) to its whole audio in
hand through ``stream_result``."""
import numpy as np


def read(run):
    lat = [r["latency"] for r in run.records if r.get("audio") is not None]
    return float(np.percentile(lat, 95)) * 1e3 if lat else None
