"""Host time issuing the plan's operators, in ms a query: the union of
the program's ``presto.dispatch`` spans (each run of the operators, from
the first plan node to the control vector built) over the traced
window."""

from benchmark.program_spans import ms_per_query


def read(run):
    return ms_per_query(run, "dispatch")
