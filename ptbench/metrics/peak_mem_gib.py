"""torch.cuda.max_memory_allocated over set-up and window, in GiB (the
fullest card's)."""


def read(run):
    return run.memory_peak_bytes / 2 ** 30 if run.memory_peak_bytes else None
