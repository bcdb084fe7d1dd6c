"""The 95th percentile of the latency of every query completed in the
window (host clock, from the call to the synchronize after its rows
were read)."""

import statistics


def read(run):
    lat = [q.latency_s for q in run.queries if q.error is None]
    if len(lat) < 2:
        return None
    return statistics.quantiles(lat, n=100, method="inclusive")[94]
