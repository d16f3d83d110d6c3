"""The allocator's peak of device memory over the window, resident inputs
included (`torch.cuda.max_memory_allocated`, reset at its start), in GiB."""


def read(run):
    return run.peak_bytes / 2**30 if run.peak_bytes else None
