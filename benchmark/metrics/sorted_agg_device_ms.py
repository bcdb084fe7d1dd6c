"""Device time of the sorted GROUP BY, in ms a query: the kernels,
copies and fills that the host launched inside one of the program's
``presto.sorted_agg`` spans, paired with their launches by order
(``span_device.launched_device_ms``). A program without the span reads
nothing."""

from benchmark.span_device import launched_device_ms


def read(run):
    return launched_device_ms(run, "sorted_agg")
