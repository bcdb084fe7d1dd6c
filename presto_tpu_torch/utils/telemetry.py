"""Device-plane telemetry: execution accounting, cluster metrics
federation, and the time-series sampler.

The PyTorch counterpart of ``presto_tpu/utils/telemetry.py`` (a copy of
its three pieces, all host-side):

- :class:`DeviceTelemetry` — process-global counters incremented at
  the execution choke points: ``exec/staging.py`` counts the bytes it
  copies to the card (``stage_page``, ``host_to_page``) and back
  (``page_to_host``) and the padding of each staged bucket; the runner
  counts one dispatch per ``_run_with_pages`` attempt, the bytes its
  control read and its result copy bring back, and the padding of
  each result page. The port runs operators eagerly and compiles no
  program per query: ``compiles`` and ``compile_ms`` count the builds
  of the hand-written CUDA kernels that ``presto_tpu_torch/kernels.py``
  ran ``nvcc`` for (a cached library's load counts nothing), which the
  runner counts where it folds them into the query whose run made
  them. ``enabled=False`` short-circuits
  every ``count_*`` method before it touches a counter, and callers
  guard their byte-size computations on ``enabled``.
- :func:`parse_prometheus` + :class:`MetricsFederation` — render many
  nodes' Prometheus expositions as one, per-node labelled and
  cluster-summed; the transport is injected (a ``fetch(uri) -> text``
  callable).
- :class:`MetricsSampler` — a bounded ring buffer of
  ``(node, ts, name, value, rate)`` samples backing
  ``system.runtime.metrics_history``, with optional JSONL persistence
  (append-only, torn-tail tolerant, rotation keeping the newest two
  segments).
"""

from __future__ import annotations

import collections
import json
import os
import threading
import time
from typing import Callable, Dict, Iterable, List, Optional, Tuple

from presto_tpu_torch.utils.metrics import REGISTRY


class DeviceTelemetry:
    """Process-global device-execution accounting.

    Per-query attribution does NOT live here: the runner folds the
    same quantities into its active stats sink (TaskStats worker-side,
    QueryStats locally) under its own locks — this class is the
    process-wide trajectory the bench and the metrics plane read."""

    def __init__(self):
        #: master gate (``telemetry.enabled``); True by default — the
        #: counters are host-side arithmetic on values the engine
        #: already holds. False restores bit-exact zero-delta.
        self.enabled = True
        self._dispatches = REGISTRY.counter("device.dispatches")
        self._compiles = REGISTRY.counter("device.compiles")
        self._compile_ms = REGISTRY.distribution("device.compile_ms")
        self._h2d = REGISTRY.counter("device.h2d_bytes")
        self._d2h = REGISTRY.counter("device.d2h_bytes")
        self._pad = REGISTRY.counter("device.pad_rows")
        self._live = REGISTRY.counter("device.live_rows")

    def set_enabled(self, flag: bool) -> None:
        self.enabled = bool(flag)

    # ---------------------------------------------- choke-point hooks

    def count_dispatch(self, n: int = 1) -> None:
        """One attempt of a plan's operators on the device (one
        ``_run_with_pages`` attempt in the port)."""
        if self.enabled:
            self._dispatches.update(n)

    def count_compile(self, ms: float) -> None:
        """One build of a hand-written kernel by ``nvcc`` that a run
        made (``kernels.take_builds``), counted by the runner where it
        folds the build into the run's query."""
        if self.enabled:
            self._compiles.update()
            self._compile_ms.add(float(ms))

    def count_h2d(self, nbytes: int) -> None:
        """Host -> device transfer (staging / restage / shard put)."""
        if self.enabled and nbytes > 0:
            self._h2d.update(int(nbytes))

    def count_d2h(self, nbytes: int) -> None:
        """Device -> host fetch (result gather, spill, ICI drain)."""
        if self.enabled and nbytes > 0:
            self._d2h.update(int(nbytes))

    def count_padding(self, live: int, capacity: int) -> None:
        """Capacity-bucket occupancy of one staged/produced page:
        ``capacity - live`` rows are padding the device computes over
        for nothing (pad-waste % = pad / (pad + live))."""
        if self.enabled and 0 <= live <= capacity:
            self._pad.update(int(capacity - live))
            self._live.update(int(live))

    # ------------------------------------------------------ snapshots

    def snapshot(self) -> Dict[str, float]:
        """Current totals (the bench diffs two of these around each
        measurement; tests assert zero delta when disabled)."""
        return {
            "dispatches": int(self._dispatches.total),
            "compiles": int(self._compiles.total),
            "compile_ms": float(self._compile_ms.values()["sum"]),
            "h2d_bytes": int(self._h2d.total),
            "d2h_bytes": int(self._d2h.total),
            "pad_rows": int(self._pad.total),
            "live_rows": int(self._live.total),
        }


#: process-wide device-plane accounting (the ONE instance; servers
#: seed ``enabled`` from tier-1 config at boot)
DEVICE = DeviceTelemetry()


def device_snapshot() -> Dict[str, float]:
    """Module-level convenience for bench/tests."""
    return DEVICE.snapshot()


def pad_waste_pct(pad_rows: float, live_rows: float) -> float:
    """Padding share of device row slots actually computed over."""
    total = pad_rows + live_rows
    return (100.0 * pad_rows / total) if total > 0 else 0.0


# ---------------------------------------------------------- federation


def parse_prometheus(text: str) -> List[Tuple[str, str, float]]:
    """Parse a Prometheus text exposition into
    ``(sample_name, label_body, value)`` tuples. Comment/HELP/TYPE
    lines and malformed samples are skipped (scrapes must never
    fail on a partial body)."""
    out: List[Tuple[str, str, float]] = []
    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        head, _, val = line.rpartition(" ")
        if not head:
            continue
        try:
            value = float(val)
        except ValueError:
            continue
        if "{" in head:
            name, _, rest = head.partition("{")
            labels = rest.rstrip("}")
        else:
            name, labels = head, ""
        out.append((name, labels, value))
    return out


def _monotone(name: str) -> bool:
    """Samples safe to sum/rate across nodes: counters and summary
    sum/count streams (quantiles are not additive)."""
    return name.endswith(("_total", "_sum", "_count"))


class MetricsFederation:
    """Coordinator-side aggregation of per-node expositions.

    ``fetch`` is injected (``fetch(uri) -> exposition text``, raising
    on failure) so the transport — rpc policy, breakers — stays the
    coordinator's concern. A node whose scrape fails is dropped from
    that round (and counted on ``telemetry.scrape_failures``) rather
    than failing the federation."""

    def __init__(self, fetch: Callable[[str], str]):
        self._fetch = fetch
        self._failures = REGISTRY.counter("telemetry.scrape_failures")

    def scrape(
        self, nodes: Iterable[Tuple[str, str]]
    ) -> Dict[str, List[Tuple[str, str, float]]]:
        """``(node_id, metrics_uri)`` -> per-node parsed samples."""
        out: Dict[str, List[Tuple[str, str, float]]] = {}
        for node_id, uri in nodes:
            try:
                out[node_id] = parse_prometheus(self._fetch(uri))
            except Exception:
                self._failures.update()
        return out

    @staticmethod
    def render(by_node: Dict[str, List[Tuple[str, str, float]]]) -> str:
        """Per-node-labeled samples plus ``node="cluster"`` sums of
        every additive family — one exposition the dashboards scrape
        instead of N."""
        lines: List[str] = []
        sums: Dict[Tuple[str, str], float] = {}
        for node_id in sorted(by_node):
            for name, labels, value in by_node[node_id]:
                tag = f'node="{node_id}"'
                body = f"{tag},{labels}" if labels else tag
                lines.append(f"{name}{{{body}}} {value}")
                if _monotone(name):
                    key = (name, labels)
                    sums[key] = sums.get(key, 0.0) + value
        for (name, labels), value in sorted(sums.items()):
            body = 'node="cluster"' + (f",{labels}" if labels else "")
            lines.append(f"{name}{{{body}}} {value}")
        return "\n".join(lines) + "\n"


# ------------------------------------------------------------- sampler

#: rows per persisted segment before rotation (journal idiom: bounded
#: segments, newest two survive)
SEGMENT_ROWS = 4096


class MetricsSampler:
    """Bounded ring buffer of cluster metric samples — the backing
    store of ``system.runtime.metrics_history``.

    ``observe(node, pairs, ts)`` appends one row per (name, value)
    pair, computing ``rate`` against the previous sample of the same
    ``(node, name)`` stream (monotone streams only: a value that went
    backwards — a restarted worker — rates as 0 rather than negative).
    ``retention`` bounds TOTAL retained rows; the deque drops the
    oldest on overflow. With ``path`` set, every row also appends to a
    JSONL segment file (torn tails tolerated on read; rotation keeps
    ``path`` + ``path.1``)."""

    def __init__(
        self, retention: int = 4096, path: Optional[str] = None
    ):
        self._lock = threading.Lock()
        self._rows: "collections.deque" = collections.deque(
            maxlen=max(1, int(retention))
        )
        #: (node, name) -> (ts, value) of the previous observation
        self._last: Dict[Tuple[str, str], Tuple[float, float]] = {}
        self.path = path
        self._seg_rows = 0
        self._samples = REGISTRY.counter("telemetry.samples")

    def observe(
        self,
        node: str,
        pairs: Iterable[Tuple[str, float]],
        ts: Optional[float] = None,
    ) -> int:
        """Fold one scrape of ``node`` into the ring; returns rows
        appended."""
        if ts is None:
            ts = time.time()
        rows = []
        with self._lock:
            for name, value in pairs:
                value = float(value)
                prev = self._last.get((node, name))
                rate = 0.0
                if prev is not None and ts > prev[0] and value >= prev[1]:
                    rate = (value - prev[1]) / (ts - prev[0])
                self._last[(node, name)] = (ts, value)
                rows.append(
                    {
                        "node": node,
                        "ts": ts,
                        "name": name,
                        "value": value,
                        "rate": rate,
                    }
                )
            self._rows.extend(rows)
        # persistence OUTSIDE the ring lock (blocking-under-lock
        # discipline): the one writer is the coordinator's sampler
        # thread, so append order still matches ring order; a second
        # concurrent observer could only interleave whole lines, which
        # the ts-stamped read path tolerates
        if self.path and rows:
            self._persist(rows)
        self._samples.update(len(rows))
        return len(rows)

    def rows(self) -> List[dict]:
        """Retained samples, oldest first (the system-table view)."""
        with self._lock:
            return list(self._rows)

    # ------------------------------------------------- JSONL segments

    def _persist(self, rows: List[dict]) -> None:
        """Append + rotate, lock-free (single-writer: the sampler
        thread); all I/O errors are swallowed — persistence must never
        fail a scrape."""
        try:
            if self._seg_rows >= SEGMENT_ROWS:
                os.replace(self.path, self.path + ".1")
                self._seg_rows = 0
            with open(self.path, "a") as f:
                for r in rows:
                    f.write(json.dumps(r) + "\n")
            self._seg_rows += len(rows)
        except OSError:
            pass

    @staticmethod
    def read_persisted(path: str) -> List[dict]:
        """Replay persisted samples, oldest segment first, skipping
        torn/corrupt lines (the history-store read discipline)."""
        out: List[dict] = []
        for p in (path + ".1", path):
            try:
                with open(p) as f:
                    for line in f:
                        try:
                            out.append(json.loads(line))
                        except ValueError:
                            continue  # torn tail / partial write
            except OSError:
                continue
        return out
