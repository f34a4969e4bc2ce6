"""cards_busy_at_once (cards): the sum over the run's cards of each card's
merged busy seconds in the traced window, over the seconds in which at
least one of them is busy: 1.0 when the cards work in turn, their count
when all work at once, exactly 1.0 on one card. The cards are ``cuda:0``
to ``cuda:{n - 1}``, ``n`` the configuration's tiles
(``render.n_devices``, at least 1), which the benchmark ties to the
cell's ``chips``. Reads nothing without a trace or a busy card."""

from perfbench.lib import trace


def read(run):
    tr, window = getattr(run, "trace", None), getattr(run, "window", None)
    if tr is None or window is None:
        return None
    n = max(1, run.config["render"].get("n_devices") or 0)
    per_card = [tr.busy(window, card) for card in range(n)]
    any_busy = sum(e - s for s, e in trace._merge(
        iv for busy in per_card for iv in busy))
    if not any_busy:
        return None
    return sum(e - s for busy in per_card for s, e in busy) / any_busy
