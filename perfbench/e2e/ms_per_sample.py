"""ms_per_sample (ms): all the window's time over all the samples of the
windows completed in it."""


def read(run):
    if run.unit != "samples" or not run.done:
        return None
    return run.measured_s * 1000.0 / run.done
