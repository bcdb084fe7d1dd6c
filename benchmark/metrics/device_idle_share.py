"""The share of the traced window in which nothing ran on the card:
1 minus the union of device activity over the window's length."""

from benchmark.trace import busy_s


def read(run):
    t = run.trace
    if t is None or t.window_s <= 0:
        return None
    return (1 - busy_s(t) / t.window_s) * 100
