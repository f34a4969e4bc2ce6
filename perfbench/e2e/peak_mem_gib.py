"""peak_mem_gib (GiB): ``max_memory_allocated`` over the window, after
``reset_peak_memory_stats`` at its start."""


def read(run):
    return run.peak_bytes / 2 ** 30
