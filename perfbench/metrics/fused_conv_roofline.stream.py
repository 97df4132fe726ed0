"""The fused conv kernels' least time over their time in the trace: each
stream window (one launch of the family's ``PASS_CLASS``) renders window +
2 halos generator frames at batch 1; its launches bounded by the family's
``conv_bound``."""


def read(run):
    t, fam = run.trace, run.family
    if not t or "fused_conv" not in t["classes"] or \
            fam.PASS_CLASS not in t["classes"]:
        return None
    dep = run.deployment
    gen_frames = 2 * (dep["window_frames"] + 2 * dep["halo_frames"])
    bound = t["classes"][fam.PASS_CLASS]["launches"] * fam.conv_bound(
        run.cfg, 1, gen_frames, run.cfg["dtype"])
    return 100.0 * bound / t["classes"]["fused_conv"]["seconds"]
