"""The host root stage (the final sort, limit and output on the host,
``exec/host_ops.py``), in ms a query: the union of the program's
``presto.host_ops`` spans over the traced window."""

from benchmark.program_spans import ms_per_query


def read(run):
    return ms_per_query(run, "host_ops")
