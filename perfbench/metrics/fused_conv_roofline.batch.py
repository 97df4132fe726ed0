"""The fused AdaIN + snake + conv kernels' least time over their time in
the trace: each Generator pass (one iSTFT launch) at the pinned batch and
frame bucket, its 48 launches bounded by ``perfbench/flops.py``."""
from perfbench import flops


def read(run):
    t = run.trace
    if not t or "fused_conv" not in t["classes"] or "istft" not in t["classes"]:
        return None
    b = run.deployment["buckets"]
    bound = t["classes"]["istft"]["launches"] * flops.conv_bound(
        run.cfg, b["batch_buckets"][0], 2 * b["frame_buckets"][0],
        run.cfg["dtype"])
    return 100.0 * bound / t["classes"]["fused_conv"]["seconds"]
