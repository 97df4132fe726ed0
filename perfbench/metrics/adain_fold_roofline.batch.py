"""The AdaIN statistics pass's least time (bytes) over its time in the
trace: each stage B (one launch of the family's ``PASS_CLASS``) at the
pinned batch and frame bucket, its passes bounded by the family's
``fold_bound``."""


def read(run):
    t, fam = run.trace, run.family
    if not t or "adain_fold" not in t["classes"] or \
            fam.PASS_CLASS not in t["classes"]:
        return None
    b = run.deployment["buckets"]
    frames = b["frame_buckets"][0]
    bound = t["classes"][fam.PASS_CLASS]["launches"] * fam.fold_bound(
        run.cfg, b["batch_buckets"][0], frames, 2 * frames, run.cfg["dtype"])
    return 100.0 * bound / t["classes"]["adain_fold"]["seconds"]
