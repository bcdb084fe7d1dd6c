"""Host time issuing the sorted GROUP BY, in ms a query: the union of
the program's ``presto.sorted_agg`` spans (each call of the sorted path
of ``hash_aggregate``: its sort, group spans and aggregates issued to
the card, not run there) over the traced window. The card's time in
that work is ``sorted_agg_device_ms``. A program without the span reads
nothing."""

from benchmark.program_spans import ms_per_query


def read(run):
    return ms_per_query(run, "sorted_agg")
