"""Share of the window's Generator passes (the family's count,
``generator_passes``) that came from a replayed stage-B CUDA graph."""


def read(run):
    passes = run.after["generator_passes"] - run.before["generator_passes"]
    if passes <= 0:
        return None
    return 100.0 * (run.after["replays_b"] - run.before["replays_b"]) / passes
