"""Device time per query of every activity on the card but K1 (kernels,
copies and fills of the operators), in the traced window."""

from benchmark.trace import device_s_by, kind_of


def read(run):
    t = run.trace
    if t is None or t.queries == 0:
        return None
    s = device_s_by(t, lambda n: kind_of(n) != "onehot_reduce")
    return s / t.queries * 1e3
