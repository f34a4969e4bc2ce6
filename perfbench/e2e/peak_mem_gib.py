"""peak_mem_gib (GiB): ``max_memory_allocated`` over the window on the
fullest card of the run's card set, after ``reset_peak_memory_stats`` of
each card at its start."""


def read(run):
    return run.peak_bytes / 2 ** 30
