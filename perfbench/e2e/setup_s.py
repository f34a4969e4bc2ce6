"""setup_s (s): from the harness's start (its first line) to the end of
the warm-up, synchronised: imports, CUDA, the scene through the API, the
warm-up."""


def read(run):
    return run.setup_s
