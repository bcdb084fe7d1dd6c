"""Q95's 95th percentile of latency, read in the traced window: the
cell's window holds too few queries for a tail that an end-to-end
bound could hold (host clock, from the call to the synchronize after
its rows were read, under the profiler)."""

import statistics


def read(run):
    lat = [q.latency_s for q in run.queries if q.error is None]
    if len(lat) < 2:
        return None
    return statistics.quantiles(lat, n=100, method="inclusive")[94]
