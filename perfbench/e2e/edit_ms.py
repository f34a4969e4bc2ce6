"""edit_ms (ms): all the window's time over all the edits completed in
it (move, ``synchronize``, the frame read back)."""


def read(run):
    if run.unit != "edits" or not run.done:
        return None
    return run.measured_s * 1000.0 / run.done
