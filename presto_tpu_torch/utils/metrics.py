"""Process metrics registry.

Reference parity: airlift's ``@Managed`` JMX stats beans — CounterStat,
TimeStat, DistributionStat — exported everywhere in presto and made
SQL-able by the jmx connector (SURVEY.md §5.5). TPU equivalent: a plain
registry exported as Prometheus text and as ``system.runtime.metrics``.

Distributions keep a bounded reservoir (algorithm R) alongside the
streaming moments, so ``snapshot()`` and the Prometheus rendering carry
p50/p90/p99 estimates — the decaying-histogram quantiles of the
reference's DistributionStat, minus the decay (documented
simplification: a uniform all-time sample, not a sliding window).
"""

from __future__ import annotations

import itertools
import math
import random
import re
import threading
import time
from typing import Dict, List, Tuple

#: bounded reservoir size per distribution (uniform sample; 1024 gives
#: ~3% worst-case p99 error, a few KB per metric)
RESERVOIR_SIZE = 1024

_NAME_SANITIZE = re.compile(r"[^a-zA-Z0-9_]")

#: per-instance reservoir RNG seeds, in creation order
_RESERVOIR_SEEDS = itertools.count(1)


def _sanitize(name: str) -> str:
    """Prometheus metric name: [a-zA-Z_][a-zA-Z0-9_]*. The fixed
    prefix keeps the first character legal whatever ``name`` is."""
    return f"presto_tpu_{_NAME_SANITIZE.sub('_', name)}"


class CounterStat:
    #: Prometheus exposition type of this stat class
    PROM_TYPE = "counter"

    def __init__(self):
        self._lock = threading.Lock()
        self.total = 0

    def update(self, n: int = 1) -> None:
        with self._lock:
            self.total += n

    def values(self) -> Dict[str, float]:
        return {"total": float(self.total)}

    def prometheus_lines(self, metric: str) -> List[str]:
        return [f"{metric}_total {float(self.total)}"]


class DistributionStat:
    """Streaming count/sum/min/max/mean + a bounded reservoir for
    quantile estimates (p50/p90/p99)."""

    PROM_TYPE = "summary"

    def __init__(self):
        self._lock = threading.Lock()
        self.count = 0
        self.sum = 0.0
        self.min = math.inf
        self.max = -math.inf
        # creation-ordered seed: instances stay independent AND the
        # sampling stream reproduces across runs of the same program
        # (id(self) would differ per run)
        self._rng = random.Random(0x5EED ^ next(_RESERVOIR_SEEDS))
        self._reservoir: List[float] = []

    def add(self, v: float) -> None:
        with self._lock:
            self.count += 1
            self.sum += v
            self.min = min(self.min, v)
            self.max = max(self.max, v)
            # algorithm R: keep each of the n values with prob k/n
            if len(self._reservoir) < RESERVOIR_SIZE:
                self._reservoir.append(v)
            else:
                j = self._rng.randrange(self.count)
                if j < RESERVOIR_SIZE:
                    self._reservoir[j] = v

    def _quantiles(self) -> Dict[str, float]:
        """p50/p90/p99 from the reservoir (nearest-rank); zeros when
        empty so the field set is stable."""
        if not self._reservoir:
            return {"p50": 0.0, "p90": 0.0, "p99": 0.0}
        s = sorted(self._reservoir)
        n = len(s)
        return {
            "p50": s[min(n - 1, int(0.50 * n))],
            "p90": s[min(n - 1, int(0.90 * n))],
            "p99": s[min(n - 1, int(0.99 * n))],
        }

    def values(self) -> Dict[str, float]:
        with self._lock:
            mean = self.sum / self.count if self.count else 0.0
            out = {
                "count": float(self.count),
                "sum": self.sum,
                "min": self.min if self.count else 0.0,
                "max": self.max if self.count else 0.0,
                "mean": mean,
            }
            out.update(self._quantiles())
        return out

    def prometheus_lines(self, metric: str) -> List[str]:
        v = self.values()
        return [
            f'{metric}{{quantile="0.5"}} {v["p50"]}',
            f'{metric}{{quantile="0.9"}} {v["p90"]}',
            f'{metric}{{quantile="0.99"}} {v["p99"]}',
            f"{metric}_sum {v['sum']}",
            f"{metric}_count {v['count']}",
        ]


class TimeStat(DistributionStat):
    """Durations in seconds; ``time()`` is a context manager."""

    def time(self):
        stat = self

        class _Timer:
            def __enter__(self):
                self._t0 = time.perf_counter()
                return self

            def __exit__(self, *exc):
                stat.add(time.perf_counter() - self._t0)
                return False

        return _Timer()


class MetricsRegistry:
    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: Dict[str, object] = {}
        #: metric name -> sanitized Prometheus name, computed ONCE at
        #: registration (the render path only joins strings)
        self._prom_names: Dict[str, str] = {}

    def counter(self, name: str) -> CounterStat:
        return self._get(name, CounterStat)

    def timer(self, name: str) -> TimeStat:
        return self._get(name, TimeStat)

    def distribution(self, name: str) -> DistributionStat:
        return self._get(name, DistributionStat)

    def _get(self, name, cls):
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = cls()
                self._metrics[name] = m
                self._prom_names[name] = _sanitize(name)
            elif not isinstance(m, cls):
                raise TypeError(f"metric {name} is {type(m).__name__}")
            return m

    def snapshot(self) -> List[Tuple[str, str, float]]:
        """(name.field, kind, value) rows for system.runtime.metrics."""
        with self._lock:
            items = list(self._metrics.items())
        out = []
        for name, m in items:
            kind = type(m).__name__
            for field, v in m.values().items():
                out.append((f"{name}.{field}", kind, v))
        return sorted(out)

    def render_prometheus(self) -> str:
        """Prometheus text exposition: one ``# HELP``/``# TYPE`` header
        per metric family (counters as counters, distributions and
        timers as summaries with quantile labels)."""
        with self._lock:
            items = [
                (name, self._prom_names[name], m)
                for name, m in self._metrics.items()
            ]
        lines: List[str] = []
        for name, metric, m in sorted(items):
            # classic text format: the family in HELP/TYPE must match
            # the sample name, which for counters carries _total
            fam = (
                f"{metric}_total" if m.PROM_TYPE == "counter" else metric
            )
            lines.append(f"# HELP {fam} {name} ({type(m).__name__})")
            lines.append(f"# TYPE {fam} {m.PROM_TYPE}")
            lines.extend(m.prometheus_lines(metric))
        return "\n".join(lines) + "\n"


#: process-wide default registry (reference: the JMX MBean server)
REGISTRY = MetricsRegistry()
