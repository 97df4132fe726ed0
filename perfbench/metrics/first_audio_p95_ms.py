"""95th percentile, in ms, over the streams of the window that delivered
audio: from the call to the first chunk in hand."""
import numpy as np


def read(run):
    first = [r["first_audio"] for r in run.records
             if r.get("first_audio") is not None]
    return float(np.percentile(first, 95)) * 1e3 if first else None
