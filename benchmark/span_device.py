"""What one of the program's spans costs the card, in a traced window:
the device-idle gaps under the span, and the device time of the work
that the host launched while inside it.

The trace keeps no correlation ids, and the card's clock, as the
profiler maps it onto the host's, runs off the host's by up to
milliseconds and drifts within a window (as read on an H100). So
launches and device activities are paired by order alone: the port
issues its work on one stream, so the k-th launch runs as the k-th
activity. The profiler loses a few activity records when it starts (the
first launches of the window's first query), none later, so the two
sequences are paired from their ends. Each query's block of activities
is checked against the device's own clock: the harness synchronises the
card at the end of each query, so the card idles between one query's
last activity and the next one's first for at least the host's time
between that query's end and the next launch; a block that does not
start and end at a gap of at least half that is misaligned. Such queries, and the first
query where records were lost, are left out: the mean of the queries
holding the span that pair stands for every query holding it. Where
fewer than half of those pair, or the card shows more activities than
launches, the reading is nothing rather than a guess. A program
without the span reads nothing."""

from __future__ import annotations

import bisect
import itertools
from typing import List, Optional, Tuple

from benchmark.program_spans import intervals
from benchmark.trace import QUERY_SPAN, Trace, idle_gaps

#: host calls that each put one activity (a kernel, a copy or a fill) on
#: the card's stream; the ``cu*`` launches (Triton's, a library's) are
#: among the trace's host events, the ``cuda*`` calls among its runtime
LAUNCHES = frozenset((
    "cudaLaunchKernel", "cudaLaunchKernelExC", "cudaLaunchCooperativeKernel",
    "cuLaunchKernel", "cuLaunchKernelEx",
    "cudaMemcpy", "cudaMemcpyAsync", "cudaMemcpy2DAsync",
    "cudaMemset", "cudaMemsetAsync", "cudaMemset2DAsync",
))


def _within(spans: List[Tuple[float, float]]):
    """Whether a time lies inside the disjoint, ordered ``spans``."""
    starts = [s for s, _ in spans]

    def inside(t: float) -> bool:
        i = bisect.bisect_right(starts, t) - 1
        return i >= 0 and t <= spans[i][1]

    return inside


def idle_ms_in(run, span: str) -> Optional[float]:
    """Device-idle gaps whose midpoint lies inside ``presto.<span>``, in
    ms a query."""
    t = run.trace
    if t is None or t.queries == 0:
        return None
    spans = intervals(t, span)
    if not spans:
        return None
    inside = _within(spans)
    idle = sum(e - s for s, e in idle_gaps(t) if inside((s + e) / 2))
    return idle / 1e3 / t.queries


def launched_device_ms(run, span: str) -> Optional[float]:
    """Device time, in ms a query, of the activities whose launch the
    host made inside ``presto.<span>``."""
    t: Trace = run.trace
    if t is None or t.queries == 0:
        return None
    spans = intervals(t, span)
    if not spans:
        return None
    inside = _within(spans)
    launches = sorted(s for n, s, _ in t.runtime + t.host if n in LAUNCHES)
    acts = sorted((s, e) for _, s, e in t.device)
    lost = len(launches) - len(acts)
    if lost < 0:
        return None
    # the latest end on the card up to each activity
    ends = list(itertools.accumulate((e for _, e in acts), max))

    def starts_block(j: int, after: float) -> bool:
        """Whether launch ``j``, the first after a query that ended at
        ``after``, is paired with an activity that follows an idle gap of
        at least half the host's time from ``after`` to the launch."""
        if j == len(launches):
            return True
        i = j - lost
        if i <= 0:
            return j == 0 and lost == 0
        return acts[i][0] - ends[i - 1] >= (launches[j] - after) / 2

    total, paired, unpaired = 0.0, 0, 0
    prev_end = t.window[0]
    for qs, qe in sorted((s, e) for n, s, e in t.in_window(t.host)
                         if n == QUERY_SPAN):
        lo = bisect.bisect_left(launches, qs)
        hi = bisect.bisect_right(launches, qe)
        after, prev_end = prev_end, qe
        mine = [j for j in range(lo, hi) if inside(launches[j])]
        if not mine:
            continue
        if not (starts_block(lo, after) and starts_block(hi, qe)):
            unpaired += 1
            continue
        paired += 1
        total += sum(acts[j - lost][1] - acts[j - lost][0] for j in mine)
    if paired < unpaired:
        return None
    if paired == 0:  # nothing was launched inside the span
        return 0.0
    # the paired queries' mean stands for every query holding the span
    return total / paired * (paired + unpaired) / 1e3 / t.queries
