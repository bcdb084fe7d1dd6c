"""What the sorted GROUP BY's host work costs the card, in ms a query:
the device-idle gaps of the traced window whose midpoint lies inside one
of the program's ``presto.sorted_agg`` spans. A program without the span
reads nothing."""

from benchmark.span_device import idle_ms_in


def read(run):
    return idle_ms_in(run, "sorted_agg")
