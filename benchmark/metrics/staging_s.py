"""The program's staging of the tables to the card: the sum of
``QueryStats.staging_ms`` over the warm-up's queries (the cold ones
stage; warm ones hit the split cache)."""


def read(run):
    if not run.warmup:
        return None
    return sum(q.stats.get("staging_ms", 0.0) for q in run.warmup
               if q.stats) / 1e3
