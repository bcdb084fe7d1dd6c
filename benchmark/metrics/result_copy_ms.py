"""The copy of each result's live rows to the host, in ms a query: the
union of the program's ``presto.result_copy`` spans over the traced
window."""

from benchmark.program_spans import ms_per_query


def read(run):
    return ms_per_query(run, "result_copy")
