"""The port's copy of the memory pool (``presto_tpu_torch/utils/memory.py``)
against the reference's (``presto_tpu/utils/memory.py``): every case runs
on both packages' ``MemoryPool`` (and fault plane), and the accounting
snapshots of one operation sequence must agree exactly."""

from __future__ import annotations

import threading
import time

import pytest

from presto_tpu.utils import faults as ref_faults
from presto_tpu.utils import memory as ref_memory
from presto_tpu_torch.utils import faults as port_faults
from presto_tpu_torch.utils import memory as port_memory
from torch_parity import one_torch_thread  # noqa: F401

PACKAGES = {
    "reference": (ref_memory, ref_faults),
    "port": (port_memory, port_faults),
}


@pytest.fixture(params=sorted(PACKAGES))
def pkg(request):
    return PACKAGES[request.param]


def _stable(snap: dict) -> dict:
    """A snapshot without the wall-clock ages of blocked waiters."""
    out = dict(snap)
    out["blocked"] = [
        {k: v for k, v in b.items() if k != "age_s"} for b in snap["blocked"]
    ]
    return out


def _sequence(memory) -> list:
    """One operation sequence; the snapshots it passes through."""
    p = memory.MemoryPool(1000)
    freed = []
    p.add_pressure_hook(lambda need: (freed.append(need), 0)[1])
    out = []
    p.reserve("q1", 600)
    out.append(_stable(p.snapshot()))
    p.release("q1", 200)
    out.append(_stable(p.snapshot()))
    out.append(p.try_reserve("cache", 700))  # over the limit: refused
    out.append(p.try_reserve("cache", 500))
    with pytest.raises(memory.MemoryLimitExceeded):
        p.reserve("q2", 200)
    out.append(list(freed))  # the pressure hook was asked for 100
    out.append(_stable(p.snapshot()))
    p.mark_dead("q1")
    out.append(p.try_reserve("q1", 1))
    p.release("q1")
    p.release("cache", 100)
    out.append(_stable(p.snapshot()))
    out.append((p.used_bytes(), p.used_bytes("cache"), p.peak_bytes("cache")))
    return out


def test_operation_sequence_snapshots_match_reference():
    assert _sequence(port_memory) == _sequence(ref_memory)


def test_parse_bytes_matches_reference():
    for s in ("0", "512", "1kB", "4GB", "1.5MB", "8 GB", 2048):
        assert port_memory.parse_bytes(s) == ref_memory.parse_bytes(s), s


def test_pool_tracks_peak_and_blocked(pkg):
    memory, _ = pkg
    p = memory.MemoryPool(1000)
    p.reserve("q1", 600)
    p.release("q1", 200)
    assert p.used_bytes("q1") == 400
    assert p.peak_bytes("q1") == 600
    snap = p.snapshot()
    assert snap["used"]["q1"] == 400 and snap["peak"]["q1"] == 600
    assert snap["blocked"] == []
    p.release("q1")
    assert p.peak_bytes("q1") == 0  # the peak dies with the reservation


def test_blocking_reserve_waits_for_headroom(pkg):
    memory, _ = pkg
    p = memory.MemoryPool(1000)
    p.block_timeout_s = 5.0
    p.reserve("q1", 900)
    got = []
    t = threading.Thread(
        target=lambda: (p.reserve("q2", 500), got.append("ok"))
    )
    t.start()
    time.sleep(0.15)
    blocked = p.blocked()
    assert len(blocked) == 1
    assert blocked[0]["owner"] == "q2" and blocked[0]["bytes"] == 500
    assert blocked[0]["age_s"] > 0.05
    p.release("q1")  # headroom appears: the wait resolves
    t.join(3)
    assert got == ["ok"]
    assert p.used_bytes() == 500


def test_blocking_reserve_times_out(pkg):
    memory, _ = pkg
    p = memory.MemoryPool(100)
    p.block_timeout_s = 0.2
    p.reserve("q1", 90)
    with pytest.raises(memory.MemoryLimitExceeded, match="blocked past"):
        p.reserve("q2", 50)
    assert p.blocked() == []  # the waiter unregistered


def test_cancel_blocked_fails_waiter_without_poisoning(pkg):
    memory, _ = pkg
    p = memory.MemoryPool(100)
    p.block_timeout_s = 5.0
    p.reserve("q1", 90)
    errs = []

    def waiter():
        try:
            p.reserve("q2", 50)
        except memory.MemoryLimitExceeded as e:
            errs.append(str(e))

    t = threading.Thread(target=waiter)
    t.start()
    time.sleep(0.1)
    assert p.cancel_blocked("q2") == 1
    t.join(3)
    assert errs and "cancelled" in errs[0]
    # unlike mark_dead, the owner may reserve again
    p.release("q1")
    p.reserve("q2", 50)
    assert p.used_bytes("q2") == 50


def test_kill_largest_evicts_the_largest_other_holder(pkg):
    memory, _ = pkg
    killed = []

    def kill(holders, requester):
        victim = max(
            (o for o in holders if o != requester), key=holders.get
        )
        killed.append(victim)
        return victim

    p = memory.MemoryPool(1000, kill_largest=kill)
    p.reserve("small", 100)
    p.reserve("big", 800)
    p.reserve("new", 500)
    assert killed == ["big"]
    assert p.snapshot()["used"] == {"small": 100, "new": 500}


def test_fault_reserve_fail_at_nth_reserve(pkg):
    memory, faults = pkg
    p = memory.MemoryPool(1 << 20)
    faults.configure(
        {"rules": [{"action": "reserve_fail", "owner": "qf",
                    "skip": 1, "count": 1}]}
    )
    try:
        p.reserve("qf", 10)  # skipped
        with pytest.raises(memory.MemoryLimitExceeded, match="injected"):
            p.reserve("qf", 10)  # the 2nd reserve fails
        p.reserve("qf", 10)  # count exhausted
        p.reserve("other", 10)  # owner filter
    finally:
        faults.configure(None)
    assert p.used_bytes("qf") == 20 and p.used_bytes("other") == 10


def test_fault_mem_pressure_shrinks_budget(pkg):
    memory, faults = pkg
    p = memory.MemoryPool(1 << 20)
    p.node_id = "worker-x"
    p.reserve("q1", 100)
    faults.configure(
        {"rules": [{"action": "mem_pressure", "node": "worker-x",
                    "budget": 150, "count": 1}]}
    )
    try:
        with pytest.raises(memory.MemoryLimitExceeded):
            p.reserve("q2", 100)  # shrunk to 150: 100 + 100 is over
        assert p.limit == 150
        p.reserve("q2", 40)  # still fits under the shrunken budget
    finally:
        faults.configure(None)


def test_query_memory_context_releases_everything(pkg):
    memory, _ = pkg
    p = memory.MemoryPool(1000)
    ctx = memory.QueryMemoryContext(p, "q9")
    ctx.reserve(300)
    ctx.reserve(200)
    assert p.used_bytes("q9") == 500
    ctx.release_all()
    assert p.used_bytes() == 0
