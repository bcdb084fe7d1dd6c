"""Base-table rows of every table scan in each completed query's text
(CTE references expanded), over the window's seconds."""


def read(run):
    done = [q for q in run.queries if q.error is None]
    if not done or run.window_s <= 0:
        return None
    return sum(q.scanned_rows for q in done) / run.window_s
