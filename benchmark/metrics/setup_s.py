"""Seconds from the start of the process to the first timed call: imports,
the CUDA context, loading (the first run in a checkout: building) the
port's kernels, making the data on the card, warming every call shape."""


def read(run):
    return run.setup_s
