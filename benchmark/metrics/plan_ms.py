"""The front end's host time per query: ``QueryStats.planning_ms`` plus
``optimization_ms`` from the runner's history, mean over the traced
window's queries."""


def read(run):
    qs = [q for q in run.queries if q.error is None and q.stats]
    if not qs:
        return None
    return sum(q.stats["planning_ms"] + q.stats["optimization_ms"]
               for q in qs) / len(qs)
