"""The traced window: torch.profiler's events reduced to plain intervals
that the per-layer readers and the breakdown work from.

A ``Trace`` holds microsecond intervals on the profiler's clock:
``device`` (kernels, copies and fills on the card), ``runtime`` (the
host's CUDA runtime calls), ``host`` (host operators and the harness's
own spans) and the window, from the harness's ``bench.window`` span.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

import numpy as np

Interval = Tuple[str, float, float]

#: kinds of device activity by name (lower case), first match wins; a
#: copy of chip_profile.py's table
KINDS = (
    ("onehot_reduce", ("onehot_reduce", "onehot_many")),
    ("searchsorted", ("searchsorted",)),
    ("sort", ("sort", "radix")),
    ("scan", ("scan",)),
    ("gather/scatter", ("index", "gather", "scatter")),
)

#: host calls that make the host wait for the device; the harness's own
#: ``torch.cuda.synchronize()`` after each query is a
#: cudaDeviceSynchronize and is left out
SYNC_CALLS = ("cudaStreamSynchronize", "cudaEventSynchronize", "cudaMemcpy")

#: the harness's own spans (torch.profiler.record_function), each also
#: mirrored on the device as an annotation, which is no device work
SPAN_PREFIX = "bench."
WINDOW_SPAN = "bench.window"
QUERY_SPAN = "bench.query"
EXECUTE_SPAN = "bench.execute"
ROWS_SPAN = "bench.rows"
SYNC_SPAN = "bench.sync"


def kind_of(name: str) -> str:
    low = name.lower()
    for kind, marks in KINDS:
        if any(m in low for m in marks):
            return kind
    return "other"


@dataclasses.dataclass
class Trace:
    device: List[Interval]
    runtime: List[Interval]
    host: List[Interval]
    window: Tuple[float, float]
    queries: int

    def in_window(self, intervals: List[Interval]) -> List[Interval]:
        lo, hi = self.window
        return [(n, max(s, lo), min(e, hi)) for n, s, e in intervals
                if e > lo and s < hi]

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) / 1e6


def from_profiler(prof, queries: int) -> Trace:
    from torch.autograd import DeviceType

    device, runtime, host = [], [], []
    window = None
    for evt in prof.events():
        tr = evt.time_range
        item = (evt.name, float(tr.start), float(tr.end))
        if evt.device_type == DeviceType.CUDA:
            if not evt.name.startswith(SPAN_PREFIX):
                device.append(item)
        elif evt.name == WINDOW_SPAN:
            window = (item[1], item[2])
        elif evt.name.startswith("cuda"):
            runtime.append(item)
        else:
            host.append(item)
    if window is None:
        raise RuntimeError("the trace holds no bench.window span")
    return Trace(device, runtime, host, window, queries)


def merged(intervals: List[Interval]) -> List[Tuple[float, float]]:
    out: List[List[float]] = []
    for _, s, e in sorted(intervals, key=lambda x: x[1]):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def busy_s(trace: Trace) -> float:
    """Seconds in the window in which some activity ran on the device."""
    return sum(e - s for s, e in merged(trace.in_window(trace.device))) / 1e6


def device_s_by(trace: Trace, pred) -> float:
    return sum(e - s for n, s, e in trace.in_window(trace.device)
               if pred(n)) / 1e6


def idle_gaps(trace: Trace) -> List[Tuple[float, float]]:
    lo, hi = trace.window
    gaps, t = [], lo
    for s, e in merged(trace.in_window(trace.device)):
        if s > t:
            gaps.append((t, s))
        t = max(t, e)
    if hi > t:
        gaps.append((t, hi))
    return gaps


def breakdown(trace: Trace, top: int = 10, gaps_read: int = 500) -> Dict:
    """The device operations that took most time, and the longest idle
    gaps by what the host was doing: the innermost host operation or
    runtime call under the gap's middle (a harness span where the host
    ran Python of the program alone)."""
    by_op: Dict[str, float] = {}
    for n, s, e in trace.in_window(trace.device):
        by_op[n[:120]] = by_op.get(n[:120], 0.0) + (e - s) / 1e6
    gaps = sorted(idle_gaps(trace), key=lambda g: g[0] - g[1])[:gaps_read]
    events = trace.host + trace.runtime
    names = [n for n, _, _ in events]
    starts = np.array([s for _, s, _ in events], dtype=np.float64)
    ends = np.array([e for _, _, e in events], dtype=np.float64)
    by_host: Dict[str, float] = {}
    for s, e in gaps:
        mid = (s + e) / 2
        inside = np.flatnonzero((starts <= mid) & (ends >= mid))
        name = ("(no host span)" if len(inside) == 0
                else names[inside[np.argmax(starts[inside])]][:120])
        by_host[name] = by_host.get(name, 0.0) + (e - s) / 1e6

    def ranked(d):
        return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:top]]

    return {"device_ops": ranked(by_op), "idle_gaps": ranked(by_host)}
