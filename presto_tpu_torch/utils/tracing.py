"""Query-lifecycle tracing: per-query span trees + traceparent headers.

Reference parity: presto attributes every query's wall time to a tree
of runtime objects (QueryStats -> StageStats -> TaskStats ->
OperatorStats) and exposes it at ``GET /v1/query/{id}`` (SURVEY.md
§5.1). Here the same attribution is a span tree: each phase of the
lifecycle (plan -> fragment -> schedule -> task -> staging/execute ->
gather) opens a :class:`Span`, and the coordinator propagates a
W3C-``traceparent``-style header on every worker call so worker-side
spans join the query's tree under one trace id — the id that appears
in both coordinator and worker logs.

The tree is servable WHILE the query runs (an open span has
``end == 0``), which is what makes "what is query q_7 doing right now"
answerable from ``/v1/query/{id}``.

While a ``torch.profiler`` records, every span of a tree is mirrored on
the profiler's clock (the clock of the device trace) as
``presto.<name>``, and :func:`profiled` puts spans too fine for the tree
there alone (one per plan node, ``presto.op.<NodeClass>``). Both record
at FUNCTION scope (``_RecordFunctionFast``), as an aten operator does,
never as a USER_SCOPE range, which the profiler would mirror on the
device as an annotation. With no profiler recording, the mirror costs
one flag check.
"""

from __future__ import annotations

import contextlib
import dataclasses
import logging
import os
import random
import threading
import time
from typing import Dict, List, Optional

import torch.autograd.profiler as _autograd_profiler
from torch._C._profiler import _RecordFunctionFast

log = logging.getLogger("presto_tpu_torch.trace")

#: the name prefix of every program span on the profiler's timeline
PROFILER_PREFIX = "presto."

#: the shared context :func:`profiled` returns while no profiler records
_NOOP = contextlib.nullcontext()


def recording() -> bool:
    """True while a ``torch.profiler`` records in this process."""
    return _autograd_profiler._is_profiler_enabled


def profiled(name: str):
    """A span on the profiler's timeline alone, named ``presto.<name>``;
    the shared no-op context (nothing allocated) while no profiler
    records."""
    if not _autograd_profiler._is_profiler_enabled:
        return _NOOP
    return _RecordFunctionFast(PROFILER_PREFIX + name)


#: traceparent version field (only 00 exists; parsed leniently)
_TP_VERSION = "00"


#: the ids' own generator, seeded from the OS once per process (and
#: again in a forked child), apart from the global ``random`` that
#: callers may seed: an ``os.urandom`` call per id took 0.15-0.3 ms
#: inside a query on an H100 machine's host, about 10 ms over the 51
#: spans of a TPC-DS Q95
_ids = random.Random()
os.register_at_fork(after_in_child=_ids.seed)


def new_trace_id() -> str:
    return f"{_ids.getrandbits(128):032x}"  # W3C width


def new_span_id() -> str:
    return f"{_ids.getrandbits(64):016x}"  # W3C width


def format_traceparent(trace_id: str, span_id: str) -> str:
    """``00-{trace}-{span}-01`` (sampled flag always on)."""
    return f"{_TP_VERSION}-{trace_id}-{span_id}-01"


def parse_traceparent(header: Optional[str]):
    """Header -> (trace_id, parent_span_id), or None when absent or
    malformed (a bad header must never fail the task carrying it)."""
    if not header:
        return None
    parts = header.strip().split("-")
    if len(parts) != 4:
        return None
    _, trace_id, span_id, _ = parts
    if len(trace_id) != 32 or len(span_id) != 16:
        return None
    return trace_id, span_id


@dataclasses.dataclass
class Span:
    """One timed phase of a query. ``end == 0`` means still open."""

    trace_id: str
    span_id: str
    parent_id: Optional[str]
    name: str
    start: float
    end: float = 0.0
    attrs: Dict[str, object] = dataclasses.field(default_factory=dict)

    @property
    def duration_ms(self) -> float:
        end = self.end or time.time()
        return (end - self.start) * 1000.0

    def to_dict(self) -> dict:
        return {
            "trace_id": self.trace_id,
            "span_id": self.span_id,
            "parent_id": self.parent_id,
            "name": self.name,
            "start": self.start,
            "end": self.end,
            "duration_ms": self.duration_ms,
            "attrs": dict(self.attrs),
        }

    @staticmethod
    def from_dict(d: dict) -> "Span":
        return Span(
            trace_id=d.get("trace_id", ""),
            span_id=d.get("span_id", ""),
            parent_id=d.get("parent_id"),
            name=d.get("name", ""),
            start=float(d.get("start", 0.0)),
            end=float(d.get("end", 0.0)),
            attrs=dict(d.get("attrs") or {}),
        )


class _SpanCtx:
    """Context manager yielded by :meth:`Trace.span`; mirrors the span on
    the profiler's timeline while a profiler records, unless opened with
    ``mirror=False``."""

    __slots__ = ("_trace", "span", "_mirror", "_record")

    def __init__(self, trace: "Trace", span: Span, mirror: bool):
        self._trace = trace
        self.span = span
        self._mirror = mirror
        self._record = None

    def __enter__(self) -> Span:
        self._trace._push(self.span)
        if self._mirror and _autograd_profiler._is_profiler_enabled:
            self._record = _RecordFunctionFast(
                PROFILER_PREFIX + self.span.name
            )
            self._record.__enter__()
        return self.span

    def __exit__(self, exc_type, exc, tb):
        if self._record is not None:
            self._record.__exit__(None, None, None)
        self._trace._pop(self.span, failed=exc is not None)
        return False


class Trace:
    """One query's span tree; thread-safe, servable mid-flight.

    Spans opened on the same thread nest implicitly (a thread-local
    stack provides the parent); spans opened on OTHER threads (stage
    runner pools, exchange pull threads) parent to the trace's root
    span unless an explicit ``parent`` is given — so a fan-out of
    concurrent stages still hangs off the one query root.
    """

    def __init__(self, trace_id: Optional[str] = None):
        self.trace_id = trace_id or new_trace_id()
        self._lock = threading.Lock()
        self._spans: List[Span] = []
        self._stack = threading.local()
        self.root: Optional[Span] = None

    # ------------------------------------------------------------ spans

    def span(
        self,
        name: str,
        parent: Optional[Span] = None,
        *,
        mirror: bool = True,
        **attrs,
    ):
        """Open a span; use as ``with trace.span("plan"):``. With
        ``mirror=False`` it stays off the profiler's timeline (a caller
        that already put the same phase there)."""
        if parent is None:
            stack = getattr(self._stack, "value", None)
            if stack:
                parent = stack[-1]
            else:
                parent = self.root
        s = Span(
            trace_id=self.trace_id,
            span_id=new_span_id(),
            parent_id=parent.span_id if parent is not None else None,
            name=name,
            start=time.time(),
            attrs=attrs,
        )
        return _SpanCtx(self, s, mirror)

    def current(self) -> Optional[Span]:
        """The innermost span open on this thread, or None."""
        stack = getattr(self._stack, "value", None)
        return stack[-1] if stack else None

    def _push(self, span: Span) -> None:
        with self._lock:
            self._spans.append(span)
            if self.root is None:
                self.root = span
        stack = getattr(self._stack, "value", None)
        if stack is None:
            stack = []
            self._stack.value = stack
        stack.append(span)
        if log.isEnabledFor(logging.DEBUG):
            log.debug(
                "trace=%s span=%s start name=%s parent=%s",
                self.trace_id, span.span_id, span.name, span.parent_id,
            )

    def _pop(self, span: Span, failed: bool = False) -> None:
        span.end = time.time()
        if failed:
            span.attrs["error"] = True
        stack = getattr(self._stack, "value", None)
        if stack and stack[-1] is span:
            stack.pop()  # the common case: spans close innermost first
        elif stack and span in stack:
            stack.remove(span)
        if log.isEnabledFor(logging.DEBUG):
            log.debug(
                "trace=%s span=%s end name=%s dur_ms=%.1f",
                self.trace_id, span.span_id, span.name, span.duration_ms,
            )

    def graft(self, span_dicts) -> None:
        """Attach foreign (worker-side) spans to this tree. Spans whose
        trace id differs are re-homed under this trace — a worker that
        ignored the traceparent still lands in the right query."""
        spans = [
            Span.from_dict(d) if isinstance(d, dict) else d
            for d in (span_dicts or ())
        ]
        with self._lock:
            for s in spans:
                s.trace_id = self.trace_id
                if s.parent_id is None and self.root is not None:
                    s.parent_id = self.root.span_id
                self._spans.append(s)

    def traceparent(self, span: Optional[Span] = None) -> str:
        """Header value carrying this trace + the given (or root) span
        as parent, for coordinator->worker propagation."""
        parent = span or self.root
        sid = parent.span_id if parent is not None else new_span_id()
        return format_traceparent(self.trace_id, sid)

    # -------------------------------------------------------- rendering

    def spans(self) -> List[Span]:
        with self._lock:
            return list(self._spans)

    def to_tree(self) -> List[dict]:
        """Nested span dicts (children under ``"children"``), roots
        first. Orphans (parent never seen, e.g. pruned worker spans)
        surface as roots rather than vanishing."""
        spans = self.spans()
        by_id = {s.span_id: s.to_dict() for s in spans}
        for d in by_id.values():
            d["children"] = []
        roots: List[dict] = []
        for s in spans:
            d = by_id[s.span_id]
            parent = by_id.get(s.parent_id) if s.parent_id else None
            if parent is not None and parent is not d:
                parent["children"].append(d)
            else:
                roots.append(d)
        return roots


def synthesize_task_spans(
    trace_id: str,
    parent_span_id: Optional[str],
    task_id: str,
    node_id: str,
    start: float,
    end: float,
    staging_ms: float,
    execute_ms: float,
    prefetch_ms: float = 0.0,
) -> List[dict]:
    """Worker-side span tree for one task, synthesized from its phase
    accumulators: a ``task`` span with ``staging`` and ``execute``
    children (plus a ``stage:prefetch`` child when pipelined prefetch
    staging overlapped host transfers with device execution — its
    duration co-anchored with ``execute`` makes the overlap visible in
    EXPLAIN ANALYZE). Batches interleave staging and execution, so the
    children carry aggregate durations anchored at the task start
    rather than one span per batch (bounded payload however many
    splits streamed).
    """
    task_span = Span(
        trace_id=trace_id,
        span_id=new_span_id(),
        parent_id=parent_span_id,
        name="task",
        start=start,
        end=end,
        attrs={"task_id": task_id, "node_id": node_id},
    )
    out = [task_span]
    for name, dur_ms in (
        ("staging", staging_ms),
        ("stage:prefetch", prefetch_ms),
        ("execute", execute_ms),
    ):
        if dur_ms <= 0:
            continue
        out.append(
            Span(
                trace_id=trace_id,
                span_id=new_span_id(),
                parent_id=task_span.span_id,
                name=name,
                start=start,
                end=start + dur_ms / 1000.0,
                attrs={"task_id": task_id},
            )
        )
    return [s.to_dict() for s in out]
