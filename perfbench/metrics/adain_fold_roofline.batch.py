"""The AdaIN statistics pass's least time (bytes) over its time in the
trace: each stage B (one iSTFT launch) at the pinned batch and frame bucket,
its 70 passes bounded by ``perfbench/flops.py``."""
from perfbench import flops


def read(run):
    t = run.trace
    if not t or "adain_fold" not in t["classes"] or "istft" not in t["classes"]:
        return None
    b = run.deployment["buckets"]
    frames = b["frame_buckets"][0]
    bound = t["classes"]["istft"]["launches"] * flops.fold_bound(
        run.cfg, b["batch_buckets"][0], frames, 2 * frames, run.cfg["dtype"])
    return 100.0 * bound / t["classes"]["adain_fold"]["seconds"]
