"""Seconds from the process's start to the window's start: loading,
weights, warmup and graph captures (the first run of a checkout adds the
kernels' nvcc build)."""


def read(run):
    return run.setup_s
