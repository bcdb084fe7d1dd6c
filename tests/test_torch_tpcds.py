"""The port's tpcds connector and TPC-DS queries on the CPU, against the
JAX reference.

The connector (``presto_tpu_torch/connectors/tpcds.py``) is a copy of
the reference's over the port's tpch generator helpers: every table at
tiny, and windows of the large tables at sf1 (long enough for the fused
C++ generator loop), must be bit-equal to the reference's. The query
texts come from the port's own copy (``presto_tpu_torch/queries_tpcds.py``),
which must equal the reference's.

The queries run through the port's CPU runner against the reference's
sqlite oracle over the same generated data, at rel 1e-6 as
tests/test_tpcds.py holds the reference: BASELINE.json's Q64 and Q95,
and the non-HEAVY breadth and official corpus, one case per query.
tests/test_tpcds.py holds the reference runner to the same oracle, so
an equal port equals the reference; Q95 also runs through both runners
directly (Q64's reference run costs over a minute of XLA compile on a
CPU, which test_tpcds.py already pays).

Streaming: at ``max_device_rows`` 7,000 the six fact and returns tables
over that size stream, as they would over the 2^26 budget at SF100.
Q95 and q94 stream and equal the oracle; Q64, which joins store_sales
to store_returns through inner joins with small dimensions, admits no
streaming cut in either package and raises ``StreamingError`` in both.
"""

from __future__ import annotations

import numpy as np
import pytest

from presto_tpu import queries_tpcds as ref_queries
from presto_tpu.connectors import tpcds as ref_tpcds
from presto_tpu.exec.local_runner import LocalQueryRunner as RefRunner
from presto_tpu.exec.streaming import StreamingError as RefStreamingError
from presto_tpu.session import Session as RefSession
from presto_tpu.sql import parse_statement
from presto_tpu.verifier import SqliteOracle, diff_results
from presto_tpu_torch import convert, queries_tpcds
from presto_tpu_torch.connectors import tpcds
from presto_tpu_torch.exec.local_runner import LocalQueryRunner
from presto_tpu_torch.exec.streaming import StreamingError
from presto_tpu_torch.session import Session
from test_tpcds import EMPTY_AT_TINY, HEAVY
from torch_parity import assert_columns_equal, jax_live_columns

REL = 1e-6
#: the six fact and returns tables that exceed this budget at tiny, as
#: they exceed the 2^26-row budget at SF100
STREAM_ROWS = 7_000

CORPUS = {
    "Q64": queries_tpcds.Q64,
    "Q95": queries_tpcds.Q95,
    **{f"breadth_{k}": v for k, v in queries_tpcds.BREADTH.items()},
    **{k: v for k, v in queries_tpcds.OFFICIAL.items() if k not in HEAVY},
}


def _columns_equal(got, want, name):
    assert sorted(got) == sorted(want), name
    for col in want:
        g, w = got[col], want[col]
        assert type(g).__name__ == type(w).__name__, (name, col)
        for field in ("ids", "data", "valid", "values"):
            if hasattr(w, field):
                gv, wv = getattr(g, field), getattr(w, field)
                if wv is None:
                    assert gv is None, (name, col, field)
                    continue
                gv, wv = np.asarray(gv), np.asarray(wv)
                assert gv.dtype == wv.dtype, (name, col, field)
                np.testing.assert_array_equal(gv, wv, err_msg=f"{name}.{col}")
        if isinstance(w, np.ndarray):
            assert g.dtype == w.dtype, (name, col)
            np.testing.assert_array_equal(g, w, err_msg=f"{name}.{col}")


def test_query_texts_are_the_reference_s():
    assert queries_tpcds.Q64 == ref_queries.Q64
    assert queries_tpcds.Q95 == ref_queries.Q95
    assert queries_tpcds.BREADTH == ref_queries.BREADTH
    assert queries_tpcds.OFFICIAL == ref_queries.OFFICIAL
    assert queries_tpcds.queries_for("sf10") == ref_queries.queries_for("sf10")
    assert queries_tpcds.official_for("sf1") == ref_queries.official_for("sf1")


def test_connector_schemas_and_counts_are_the_reference_s():
    assert tpcds.TABLE_SCHEMAS.keys() == ref_tpcds.TABLE_SCHEMAS.keys()
    for table, cols in ref_tpcds.TABLE_SCHEMAS.items():
        assert list(tpcds.TABLE_SCHEMAS[table]) == list(cols)
        assert [str(t) for t in tpcds.TABLE_SCHEMAS[table].values()] == [
            str(t) for t in cols.values()
        ]
    for sf in tpcds.SCHEMAS.values():
        assert tpcds._counts(sf) == ref_tpcds._counts(sf)


@pytest.mark.parametrize("table", sorted(ref_tpcds.TABLE_SCHEMAS))
def test_tiny_table_is_bit_equal_to_the_reference(table):
    sf = tpcds.SCHEMAS["tiny"]
    gen, ref = tpcds.TpcdsGenerator(sf), ref_tpcds.TpcdsGenerator(sf)
    cols = list(ref_tpcds.TABLE_SCHEMAS[table])
    n = ref.counts[table]
    _columns_equal(gen.generate(table, 0, n, cols),
                   ref.generate(table, 0, n, cols), table)


@pytest.mark.parametrize(
    "table", ["store_sales", "store_returns", "web_sales", "web_returns"]
)
def test_sf1_window_is_bit_equal_to_the_reference(table):
    # 2^17 rows from an unaligned start: every per-row stream of the
    # window takes the fused loop
    sf = tpcds.SCHEMAS["sf1"]
    gen, ref = tpcds.TpcdsGenerator(sf), ref_tpcds.TpcdsGenerator(sf)
    cols = list(ref_tpcds.TABLE_SCHEMAS[table])
    lo = 100_003
    _columns_equal(gen.generate(table, lo, lo + (1 << 17), cols),
                   ref.generate(table, lo, lo + (1 << 17), cols), table)


@pytest.fixture(scope="module")
def oracle():
    return SqliteOracle("tiny", catalog="tpcds")


@pytest.fixture(scope="module")
def port():
    return LocalQueryRunner(device="cpu")


def _equal_to_oracle(rows, oracle, sql):
    ordered = bool(parse_statement(sql).order_by)
    return diff_results(rows, oracle.execute(sql), ordered, REL)


@pytest.mark.parametrize("name", sorted(CORPUS))
def test_query_equals_the_oracle(name, port, oracle):
    sql = CORPUS[name]
    rows = port.execute(sql).rows()
    diff = _equal_to_oracle(rows, oracle, sql)
    assert diff is None, f"{name}: {diff}"
    if name not in EMPTY_AT_TINY:
        assert len(rows) > 0, f"{name} selected nothing"


def test_q95_equals_the_reference_runner(port):
    ref = RefRunner().execute(queries_tpcds.Q95)
    got = port.execute(queries_tpcds.Q95)
    assert got.columns == ref.columns
    assert_columns_equal(jax_live_columns(ref.page),
                         convert.page_to_numpy(got.page))
    assert got.rows()[0][0] > 0


@pytest.fixture(scope="module")
def streamed():
    return LocalQueryRunner(
        device="cpu",
        session=Session(properties={"max_device_rows": STREAM_ROWS}),
    )


@pytest.mark.parametrize("name", ["Q95", "q94"])
def test_streamed_query_equals_the_oracle(name, streamed, oracle):
    sql = CORPUS[name]
    before = streamed.stream_stats.batches
    rows = streamed.execute(sql).rows()
    assert streamed.stream_stats.batches > before  # web_sales streamed
    diff = _equal_to_oracle(rows, oracle, sql)
    assert diff is None, f"{name} streamed: {diff}"
    assert len(rows) == 1 and (name != "Q95" or rows[0][0] > 0)


def test_q64_admits_no_streaming_cut_in_either_package(streamed):
    with pytest.raises(StreamingError, match="no semantics-preserving"):
        streamed.execute(queries_tpcds.Q64)
    ref = RefRunner(
        session=RefSession(properties={"max_device_rows": STREAM_ROWS})
    )
    with pytest.raises(RefStreamingError, match="no semantics-preserving"):
        ref.execute(ref_queries.Q64)
