"""update_ms (ms): the host clock around an edit's move and
``RenderSystem.synchronize()``, ended by ``torch.cuda.synchronize()``
in the traced run, as the mean over the window's and the traced
iterations' edits."""


def read(run):
    if not run.update_s:
        return None
    return 1000.0 * sum(run.update_s) / len(run.update_s)
