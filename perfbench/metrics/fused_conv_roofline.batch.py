"""The fused AdaIN + snake + conv kernels' least time over their time in
the trace: each Generator pass (one launch of the family's ``PASS_CLASS``)
at the pinned batch and frame bucket, its launches bounded by the
family's ``conv_bound``."""


def read(run):
    t, fam = run.trace, run.family
    if not t or "fused_conv" not in t["classes"] or \
            fam.PASS_CLASS not in t["classes"]:
        return None
    b = run.deployment["buckets"]
    bound = t["classes"][fam.PASS_CLASS]["launches"] * fam.conv_bound(
        run.cfg, b["batch_buckets"][0], 2 * b["frame_buckets"][0],
        run.cfg["dtype"])
    return 100.0 * bound / t["classes"]["fused_conv"]["seconds"]
