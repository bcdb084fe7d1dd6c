"""What launching the operators from the host costs the card, in ms a
query: the device-idle gaps of the traced window whose midpoint lies
inside one of the program's ``presto.dispatch`` spans."""

import bisect

from benchmark.program_spans import intervals
from benchmark.trace import idle_gaps


def read(run):
    t = run.trace
    if t is None or t.queries == 0:
        return None
    spans = intervals(t, "dispatch")
    if not spans:
        return None
    starts = [s for s, _ in spans]
    idle = 0.0
    for s, e in idle_gaps(t):
        mid = (s + e) / 2
        i = bisect.bisect_right(starts, mid) - 1
        if i >= 0 and mid <= spans[i][1]:
            idle += e - s
    return idle / 1e3 / t.queries
