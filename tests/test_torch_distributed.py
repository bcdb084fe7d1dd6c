"""The port's ``DistributedQueryRunner``
(``presto_tpu_torch/parallel/distributed_runner.py``) on 8 CPU shards.

The reference's distributed suite (``tests/test_distributed.py``) runs
the TPC-H corpus on its 8-virtual-device mesh against the sqlite oracle;
the port's runner does the same over ``devices=["cpu"] * 8`` (one
controller, a page list per sharded table), with the reference's low
thresholds so tiny data takes the partitioned (all_to_all) paths. Q1, Q3
and Q18 also equal the reference's ``DistributedQueryRunner`` column by
column (doubles within rel 1e-9); a forced bucket overflow re-runs at a
larger balance factor with the same rows; the dryrun twin of
``__graft_entry__.dryrun_multichip`` runs Q3 on 8 shards.
"""

from __future__ import annotations

import pytest
import torch

from presto_tpu.parallel import DistributedQueryRunner as RefRunner
from presto_tpu.verifier import SqliteOracle, verify_query
from presto_tpu_torch import convert
from presto_tpu_torch.parallel import DistributedQueryRunner, dryrun_multichip
from presto_tpu_torch.parallel import distributed_runner as DR
from tpch_queries import QUERIES
from torch_parity import assert_columns_equal, jax_live_columns
from torch_parity import one_torch_thread  # noqa: F401

SHARDS = ["cpu"] * 8
THRESHOLDS = {"broadcast_threshold": 1 << 11, "repl_threshold": 1 << 10}


@pytest.fixture(scope="module")
def runner():
    return DistributedQueryRunner(devices=SHARDS, **THRESHOLDS)


@pytest.fixture(scope="module")
def oracle():
    return SqliteOracle("tiny")


@pytest.fixture(scope="module")
def reference():
    return RefRunner(**THRESHOLDS)


@pytest.mark.parametrize("qnum", sorted(QUERIES))
def test_tpch_query_distributed(qnum, runner, oracle):
    diff = verify_query(runner, oracle, QUERIES[qnum], rel_tol=1e-6)
    assert diff is None, f"Q{qnum} distributed mismatch: {diff}"


def test_partitioned_agg_path(runner, oracle):
    """A GROUP BY over 15,000 order keys routes its partial states by
    key hash (all_to_all), above the replication threshold."""
    sql = (
        "select l_orderkey, count(*) as c, sum(l_quantity) as s "
        "from tpch.tiny.lineitem group by l_orderkey"
    )
    before = runner.collective_bytes["all_to_all"]
    assert verify_query(runner, oracle, sql) is None
    assert runner.collective_bytes["all_to_all"] > before


@pytest.mark.parametrize("qnum", [1, 3, 18])
def test_matches_the_reference_distributed_runner(qnum, runner, reference):
    ref = reference.execute(QUERIES[qnum])
    got = runner.execute(QUERIES[qnum])
    assert got.columns == ref.columns
    assert_columns_equal(
        jax_live_columns(ref.page), convert.page_to_numpy(got.page)
    )


def test_forced_bucket_overflow_retries_at_a_larger_balance(
    runner, oracle, monkeypatch
):
    """Buckets of 4 rows overflow on the first attempt: the runner
    re-runs the fragment at a doubled balance factor (and 4x
    capacities), where the buckets take their planned size again, with
    the same rows."""
    sql = (
        "select l_suppkey, count(*) as c, sum(l_extendedprice) as s "
        "from tpch.tiny.lineitem group by l_suppkey order by l_suppkey"
    )
    want = runner.execute(sql).rows()
    r = DistributedQueryRunner(
        devices=SHARDS, broadcast_threshold=1 << 11, repl_threshold=16
    )
    partition = r._partition

    def small(pages, key_cols, bucket_cap, flags):
        if r.balance_retries == 0:
            bucket_cap = 4
        return partition(pages, key_cols, bucket_cap, flags)

    monkeypatch.setattr(r, "_partition", small)
    got = r.execute(sql).rows()
    assert r.balance_retries == 1
    assert got == want
    assert verify_query(r, oracle, sql) is None


def test_one_host_read_per_fragment_attempt(runner):
    """Every shard's flags, errors and counts come back in one read per
    fragment attempt."""
    runs, reads, retries = (
        runner.fragment_runs, runner.fragment_reads, runner.balance_retries
    )
    runner.execute(QUERIES[3])
    assert runner.fragment_reads - reads == (
        runner.fragment_runs - runs + runner.balance_retries - retries
    )
    assert runner.fragment_runs > runs


def test_dryrun_multichip_twin():
    r = dryrun_multichip(8, devices=SHARDS)
    assert r.n == 8 and all(d.type == "cpu" for d in r.devices)


def test_devices_default_to_cuda_and_never_repeat_silently(monkeypatch):
    """``devices=None`` means every visible CUDA device and raises
    without one; more shards than devices must be asked for explicitly."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        DistributedQueryRunner(n_devices=2)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="one card"):
        DR._shard_devices(4, None)
    assert DR._shard_devices(None, None) == [torch.device("cuda", 0)]
    with pytest.raises(ValueError):
        DistributedQueryRunner(n_devices=3, devices=SHARDS)
