"""The program's own spans in a traced window. The port names each
``presto.<span>`` on torch.profiler's clock at FUNCTION scope, so
``trace.from_profiler`` puts them among the host events; a program
without them yields no intervals, and the readers then read nothing."""

from __future__ import annotations

from typing import List, Optional, Tuple

from benchmark.trace import Trace, merged

PREFIX = "presto."


def intervals(trace: Trace, span: str) -> List[Tuple[float, float]]:
    """The union of the window's ``presto.<span>`` intervals (us), in
    order and disjoint: nested or overlapping spans count once."""
    name = PREFIX + span
    return merged([iv for iv in trace.in_window(trace.host) if iv[0] == name])


def ms_per_query(run, span: str) -> Optional[float]:
    """The union of ``presto.<span>`` over the window, in ms a query."""
    t = run.trace
    if t is None or t.queries == 0:
        return None
    ivs = intervals(t, span)
    if not ivs:
        return None
    return sum(e - s for s, e in ivs) / 1e3 / t.queries
