"""launches_per_sample (launches): device kernels launched in the traced
iterations over the samples they rendered, from the profiler's trace.
It counts the host's glue (every torch op's kernel) beside the
hand-written kernels."""


def read(run):
    if run.trace is None or run.window is None or not run.work_traced:
        return None
    return len(run.trace.kernels_in(run.window)) / run.work_traced
