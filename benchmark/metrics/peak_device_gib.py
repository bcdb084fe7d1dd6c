"""``torch.cuda.max_memory_allocated()`` from the program's first
staging to the window's end: the resident tables plus the working
set (the benchmark's own generation is freed, and the peak reset,
before the program starts)."""


def read(run):
    return None if run.peak_bytes is None else run.peak_bytes / 2 ** 30
