"""The fused conv kernels' least time over their time in the trace: each
stream window (one iSTFT launch) renders window + 2 halos generator frames
at batch 1; its 48 launches bounded by ``perfbench/flops.py``."""
from perfbench import flops


def read(run):
    t = run.trace
    if not t or "fused_conv" not in t["classes"] or "istft" not in t["classes"]:
        return None
    dep = run.deployment
    gen_frames = 2 * (dep["window_frames"] + 2 * dep["halo_frames"])
    bound = t["classes"]["istft"]["launches"] * flops.conv_bound(
        run.cfg, 1, gen_frames, run.cfg["dtype"])
    return 100.0 * bound / t["classes"]["fused_conv"]["seconds"]
