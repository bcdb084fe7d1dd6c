"""From the process's start to the window's start: imports, generation,
the copy to the host, the program's cold staging, the K1 build or load,
and the warm-up of every query shape of the cell."""


def read(run):
    return run.setup_s
