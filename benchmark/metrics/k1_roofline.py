"""K1's share of its byte bound in the traced window: the bytes its
GROUP BYs need over HBM's peak, divided by K1's device time. Bytes per
query, from the query's ``k1`` entry in ``<query>.params.json``: the
rows the reference finds reaching the GROUP BY times ``row_bytes`` (the
int32 group id plus each distinct input read once), plus ``outputs`` x
``segments`` 8-byte results. The count is the same whatever implements
the GROUP BY (chip_smoke.py's ``bound_ms``, at 3.35 TB/s)."""

from benchmark.peaks import HBM_BYTES_PER_S
from benchmark.trace import device_s_by, kind_of


def read(run):
    t = run.trace
    if t is None:
        return None
    nbytes = 0
    for q in run.queries:
        k1 = run.query_meta[q.query].get("k1")
        ans = run.answers.get((q.query, q.pool_index))
        if k1 and ans is not None and ans.groupby_rows is not None:
            nbytes += (ans.groupby_rows * k1["row_bytes"]
                       + k1["outputs"] * k1["segments"] * 8)
    secs = device_s_by(t, lambda n: kind_of(n) == "onehot_reduce")
    if nbytes == 0 or secs <= 0:
        return None
    return nbytes / HBM_BYTES_PER_S / secs * 100
