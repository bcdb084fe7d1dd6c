"""Host waits for the device per query: cudaStreamSynchronize,
cudaEventSynchronize and synchronous cudaMemcpy calls in the traced
window (the harness's own synchronize after each query is a
cudaDeviceSynchronize and is not counted)."""

from benchmark.trace import SYNC_CALLS


def read(run):
    t = run.trace
    if t is None or t.queries == 0:
        return None
    n = sum(1 for name, _, _ in t.in_window(t.runtime) if name in SYNC_CALLS)
    return n / t.queries
