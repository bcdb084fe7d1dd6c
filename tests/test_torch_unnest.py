"""ARRAY[...] expressions and UNNEST through both runners on the CPU:
the SQL of the reference's ``tests/test_unnest.py`` row for row, the
``unnest``/``unnest_column`` operators on the same seeded page, and the
static UNNEST of a page that holds nested columns, which the reference
fails (ROADMAP §3)."""

from __future__ import annotations

import numpy as np
import pytest

from presto_tpu import expr as RE
from presto_tpu import ops as RO
from presto_tpu import types as RT
from presto_tpu_torch import convert
from presto_tpu_torch import expr as PE
from presto_tpu_torch import ops as PO
from presto_tpu_torch import types as PT
from test_torch_arrays import assert_parity, both_runners
from test_torch_nested import _assert_same_page, _pages
from torch_parity import assert_columns_equal, both_pages, jax_live_columns
from torch_parity import one_torch_thread  # noqa: F401


@pytest.fixture(scope="module")
def runners():
    return both_runners({
        ("default", "t"): (
            lambda T: {"id": T.INTEGER, "arr": T.array(T.BIGINT)},
            lambda: {"id": [1, 2, 3, 4], "arr": [[10, 20, 30], [5], None, []]},
        ),
    })


UNNEST_SQL = {
    "constants_standalone": (
        "select x from unnest(array[3, 1, 2]) as t(x) order by x"
    ),
    "with_ordinality": (
        "select x, n from unnest(array[30, 10, 20]) "
        "with ordinality as t(x, n) order by n"
    ),
    "lateral_columns": (
        "select r_regionkey, v from tpch.tiny.region "
        "cross join unnest(array[r_regionkey, r_regionkey * 10]) as u(v) "
        "order by r_regionkey, v"
    ),
    "aggregation_over_expanded_rows": (
        "select count(*) as n, sum(v) as s from tpch.tiny.region "
        "cross join unnest(array[1, 2, 3]) as u(v)"
    ),
    "filter_on_element": (
        "select r_name, v from tpch.tiny.region "
        "cross join unnest(array[r_regionkey, 7]) as u(v) "
        "where v > 3 order by r_name, v"
    ),
    "string_elements_mixed_dictionaries": (
        "select r_regionkey, s from tpch.tiny.region "
        "cross join unnest(array[r_name, 'zzz']) as u(s) "
        "order by r_regionkey, s"
    ),
    "nulls_pass_through": (
        "select v from unnest(array[1, null, 3]) as t(v) "
        "order by v nulls last"
    ),
    "cardinality": "select cardinality(array[1, 2, 3]) as c",
    "element_at_literal_index": (
        "select element_at(array[10, 20, 30], 2) as e"
    ),
    "element_at_out_of_range_is_null": (
        "select element_at(array[10, 20], 5) as e"
    ),
    "subscript_sugar": "select array[10, 20, 30][2] as e",
    "element_at_column_index": (
        "select r_regionkey, element_at(array[100, 200], r_regionkey) as e "
        "from tpch.tiny.region order by r_regionkey"
    ),
    "contains": (
        "select r_name from tpch.tiny.region "
        "where contains(array[0, 2], r_regionkey) order by r_name"
    ),
    "join_then_unnest": (
        "select n_name, v from tpch.tiny.nation "
        "join tpch.tiny.region on n_regionkey = r_regionkey "
        "cross join unnest(array[r_regionkey]) as u(v) "
        "where n_name = 'CANADA'"
    ),
    "onehot_group_over_expansion": (
        "select l_returnflag, l_linestatus, count(*), sum(u.v) "
        "from tpch.tiny.lineitem cross join unnest(array[l_quantity, "
        "l_discount, l_tax]) as u(v) group by l_returnflag, l_linestatus "
        "order by l_returnflag, l_linestatus"
    ),
    "column_unnest_with_ordinality": (
        "select id, e, o from mem.default.t cross join unnest(arr) "
        "with ordinality as u(e, o) order by id, o"
    ),
}


@pytest.mark.parametrize("sql", list(UNNEST_SQL.values()), ids=list(UNNEST_SQL))
def test_unnest_sql_matches_reference(runners, sql):
    assert_parity(runners, sql)


def test_onehot_group_over_expansion_takes_one_reduction(runners, monkeypatch):
    """A static UNNEST feeding a small-domain GROUP BY makes one
    onehot_reduce_many call over the expanded page (capacity * 3 rows,
    not a power of two)."""
    import presto_tpu_torch.ops.aggregation as PA

    calls = []
    real = PA.onehot_reduce_many

    def spy(gid, requests, nseg):
        calls.append(gid.shape[0])
        return real(gid, requests, nseg)

    monkeypatch.setattr(PA, "onehot_reduce_many", spy)
    runners[1].execute(UNNEST_SQL["onehot_group_over_expansion"])
    assert len(calls) == 1 and calls[0] % 3 == 0


CAP, LIVE = 40, 33


def _columns():
    rng = np.random.default_rng(9)
    return {
        "a": (rng.integers(-50, 50, CAP).astype(np.int64),
              rng.random(CAP) < 0.8, "bigint", None),
        "d": (rng.integers(-10**6, 10**6, CAP).astype(np.int64), None,
              "decimal(12,2)", None),
        "s": (rng.integers(0, 3, CAP).astype(np.int32), None, "varchar",
              np.asarray(["x", "y", "z"], object)),
        "big": (np.stack([rng.integers(-5, 5, CAP),
                          rng.integers(-(2**62), 2**62, CAP)], axis=1),
                None, "decimal(30,2)", None),
    }


@pytest.mark.parametrize("ordinality", [None, "ord"])
@pytest.mark.parametrize("kind", ["bigint", "varchar", "long_decimal"])
def test_unnest_operator_matches_reference(kind, ordinality):
    ref_page, port_page = both_pages(_columns(), LIVE)
    out = {}
    for E, O, T, page in ((RE, RO, RT, ref_page), (PE, PO, PT, port_page)):
        if kind == "bigint":
            els = (E.ColumnRef("a", T.BIGINT), E.Literal(None, T.BIGINT),
                   E.Literal(7, T.BIGINT))
            t = T.BIGINT
        elif kind == "varchar":
            els = (E.ColumnRef("s", T.VARCHAR), E.Literal("w", T.VARCHAR))
            t = T.VARCHAR
        else:
            t = T.decimal(30, 2)
            els = (E.ColumnRef("big", t), E.Literal(-(10**20), t))
        out[O] = O.unnest(page, els, "u", t, ordinality)
    assert_columns_equal(
        jax_live_columns(out[RO]), convert.page_to_numpy(out[PO])
    )


@pytest.mark.parametrize("out_capacity", [1024, 64])
def test_unnest_column_matches_reference(out_capacity):
    """The length expansion of a physical array column, and its
    overflow flag when the bucket is too small."""
    ref_page, port_page = _pages(8)
    want, ref_over = RO.unnest_column(
        ref_page, "arr", "e", RT.BIGINT, "o", out_capacity
    )
    got, port_over = PO.unnest_column(
        port_page, "arr", "e", PT.BIGINT, "o", out_capacity
    )
    assert bool(port_over) == bool(ref_over) == (out_capacity == 64)
    _assert_same_page(want, got)


def test_static_unnest_keeps_nested_columns(runners):
    """A fault of the reference (ROADMAP §3): a static UNNEST over a page
    that holds an array column repeats the flat values and drops the
    offsets, and the query fails. The port repeats the rows of the
    block (values widened k times) and returns the Python evaluation's
    rows."""
    sql = (
        "select id, arr, u.v from mem.default.t "
        "cross join unnest(array[1, 2]) as u(v) order by id, v"
    )
    arrs = {1: [10, 20, 30], 2: [5], 3: None, 4: []}
    ref, port = runners
    assert port.execute(sql).rows() == [
        (i, arrs[i], v) for i in (1, 2, 3, 4) for v in (1, 2)
    ]
    with pytest.raises(TypeError):
        ref.execute(sql).rows()


def test_aggregation_over_unnest_streams_per_batch():
    """Under a budget lineitem exceeds, an aggregation above a static
    UNNEST streams with a partial step per batch: only the partial
    groups spill. The reference gathers every scanned row first (ROADMAP
    §3); the rows are the same."""
    from presto_tpu.exec.local_runner import LocalQueryRunner as RefRunner
    from presto_tpu.session import Session as RefSession
    from presto_tpu_torch.exec.local_runner import LocalQueryRunner
    from presto_tpu_torch.exec.streaming import StreamStats
    from presto_tpu_torch.session import Session

    props = {"max_device_rows": 16_384, "page_capacity": 4_096}
    sql = UNNEST_SQL["onehot_group_over_expansion"]
    port = LocalQueryRunner(device="cpu", session=Session(properties=props))
    port.stream_stats = StreamStats()
    got = port.execute(sql).rows()
    want = RefRunner(session=RefSession(properties=props)).execute(sql).rows()
    assert got == want
    st = port.stream_stats
    assert st.batches == 15 and 0 < st.spilled_rows <= 4 * st.batches
