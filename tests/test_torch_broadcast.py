"""One-row results that hold a broadcast column, through the port and
the JAX reference on the CPU.

A literal projection (``ops/filter_project.py``) and the single-row
cross join (``LocalQueryRunner``) make their blocks with
``torch.broadcast_to``, whose stride is 0. torch counts a one-row slice
of such a block as contiguous, so ``.contiguous()`` kept the zero
stride and ``page.to_host`` failed to view the block's bytes: the query
raised instead of answering. Each query here runs through both
packages under the default session and under streaming with
``max_device_rows`` 8,192, where the ROLLUP grand total comes back
through ``merge_spilled_buckets``."""

from __future__ import annotations

import functools

import pytest
import torch

from presto_tpu.exec.local_runner import LocalQueryRunner as RefRunner
from presto_tpu.session import Session as RefSession
from presto_tpu_torch import convert
from presto_tpu_torch.exec.local_runner import LocalQueryRunner
from presto_tpu_torch.page import to_host
from presto_tpu_torch.session import Session
from broadcast_queries import QUERIES
from torch_parity import assert_columns_equal, jax_live_columns

SESSIONS = {"default": {}, "streamed": {"max_device_rows": 8_192}}


@pytest.fixture(scope="module")
def reference():
    runners = {
        k: RefRunner(session=RefSession(properties=p))
        for k, p in SESSIONS.items()
    }

    @functools.lru_cache(maxsize=None)
    def run(name, session):
        res = runners[session].execute(QUERIES[name][0])
        return res.columns, res.rows(), jax_live_columns(res.page)

    return run


@pytest.fixture(scope="module")
def ports():
    return {
        k: LocalQueryRunner(device="cpu", session=Session(properties=p))
        for k, p in SESSIONS.items()
    }


@pytest.mark.parametrize("session", sorted(SESSIONS))
@pytest.mark.parametrize("name", sorted(QUERIES))
def test_query_matches_reference(reference, ports, name, session):
    ref_columns, ref_rows, ref_cols = reference(name, session)
    port = ports[session].execute(QUERIES[name][0])
    assert port.columns == ref_columns
    assert_columns_equal(ref_cols, convert.page_to_numpy(port.page))
    pinned = QUERIES[name][1]
    if pinned is not None:
        assert ref_rows == pinned
        assert port.rows() == pinned


def test_streamed_rollup_keeps_its_grand_total(ports):
    rows = ports["streamed"].execute(QUERIES["rollup_grand_total"][0]).rows()
    assert ports["streamed"].stream_stats.buckets > 0
    assert rows[-1][0] is None and rows[-1][3] == 1  # the grand total


@pytest.mark.parametrize(
    "make",
    [
        lambda: torch.broadcast_to(torch.tensor(7), (5,))[:1],
        lambda: torch.broadcast_to(torch.tensor([True]), (3,)),
        lambda: torch.broadcast_to(torch.tensor(2.5), (4,)),
        lambda: torch.arange(10)[::3],
        lambda: torch.zeros(0, dtype=torch.int64),
    ],
    ids=["one_row_slice", "bool", "double", "strided", "empty"],
)
def test_to_host_copies_any_strides(make):
    t = make()
    (got,) = to_host([t])
    assert got.dtype == t.dtype and got.shape == t.shape
    assert torch.equal(got, t)
