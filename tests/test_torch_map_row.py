"""MAP and ROW columns through both runners on the CPU: the SQL of the
reference's ``tests/test_map_row.py`` over identically loaded memory
connectors, row for row, and its gates, which raise in both. The page
round trip of the same values is in both packages too."""

from __future__ import annotations

import pytest

from presto_tpu import page as RP
from presto_tpu import types as RT
from presto_tpu_torch import page as PP
from presto_tpu_torch import types as PT
from test_torch_arrays import assert_both_raise, assert_parity, both_runners
from torch_parity import one_torch_thread  # noqa: F401

MAPS = [
    {"a": 1, "b": 2},
    {},
    None,
    {"c": 30, "a": 10},
    {"z": None, "q": 7},
]
ROWS = [
    {"x": 1.5, "y": "one"},
    {"x": -2.0, "y": "two"},
    None,
    {"x": 0.25, "y": None},
    {"x": 9.0, "y": "nine"},
]


def _types(T):
    return {
        "id": T.BIGINT,
        "m": T.map_(T.VARCHAR, T.BIGINT),
        "im": T.map_(T.INTEGER, T.DOUBLE),
        "r": T.row(("x", T.DOUBLE), ("y", T.VARCHAR)),
    }


@pytest.fixture(scope="module")
def runners():
    return both_runners({
        ("s", "t"): (
            _types,
            lambda: {
                "id": list(range(5)),
                "m": MAPS,
                "im": [{1: 0.5}, {2: 1.5, 3: -2.5}, {}, None, {1: 9.0}],
                "r": ROWS,
            },
        ),
    })


def test_page_roundtrip_map_row():
    for P, T in ((RP, RT), (PP, PT)):
        kw = {} if P is RP else {"device": "cpu"}
        p = P.Page.from_pydict(
            {"m": MAPS, "r": ROWS},
            {"m": T.map_(T.VARCHAR, T.BIGINT),
             "r": T.row(("x", T.DOUBLE), ("y", T.VARCHAR))},
            capacity=8, **kw,
        )
        out = p.to_pylist()
        assert [row["m"] for row in out] == MAPS
        assert [row["r"] for row in out] == ROWS


MAP_ROW_SQL = {
    "select_whole_map_and_row": "select id, m, r from mem.s.t",
    "map_subscript_string_key": "select id, m['a'] as v from mem.s.t",
    "map_element_at_int_key": (
        "select id, element_at(im, 1) as v from mem.s.t"
    ),
    "map_subscript_null_value": "select m['z'] as v from mem.s.t",
    "map_cardinality": "select id, cardinality(m) as n from mem.s.t",
    "row_field_access": "select id, r.x, r.y from mem.s.t",
    "filter_on_row_field": (
        "select id from mem.s.t where r.x > 0 order by id"
    ),
    "filter_on_map_subscript": (
        "select id from mem.s.t where m['a'] >= 10"
    ),
    "group_by_row_field": (
        "select r.y is null as has_null, count(*) as n from mem.s.t "
        "where id <> 2 group by r.y is null order by has_null"
    ),
    "map_subscript_key_domain": (
        "select id, element_at(im, 1.0) as v from mem.s.t order by id"
    ),
    "map_subscript_wide_key_no_wrap": (
        "select id, element_at(im, 4294967297) as v from mem.s.t "
        "order by id"
    ),
    "whole_map_through_order_by_id": (
        "select id, m, r from mem.s.t order by id desc"
    ),
    "filter_compacts_maps_and_rows": (
        "select id, m, r, im from mem.s.t where id <> 1 and id <> 3 "
        "order by id"
    ),
    "map_through_topn": (
        "select id, m from (select id, m from mem.s.t "
        "order by id desc limit 3) s order by id"
    ),
}


@pytest.mark.parametrize(
    "sql", list(MAP_ROW_SQL.values()), ids=list(MAP_ROW_SQL)
)
def test_map_row_sql_matches_reference(runners, sql):
    assert_parity(runners, sql)


@pytest.mark.parametrize(
    "sql,needle",
    [
        ("select m from mem.s.t group by m", ""),
        ("select m from mem.s.t order by m", ""),
        ("select count(*) from mem.s.t a, mem.s.t b where a.m = b.m", ""),
        ("select r.zz from mem.s.t", "no field"),
        ("select m[1] from mem.s.t", ""),
        ("select a.id, a.r from mem.s.t a, mem.s.t b where a.id = b.id",
         "nested column"),
        ("select id, r, row_number() over (order by id) as rn "
         "from mem.s.t", "nested column"),
    ],
    ids=["group_by_map", "order_by_map", "join_on_map", "row_field_missing",
         "fractional_map_key", "row_through_join", "row_through_window"],
)
def test_map_row_gates_raise_in_both(runners, sql, needle):
    assert_both_raise(runners, sql, needle)


def test_row_column_through_a_device_sort(runners):
    """A fault of the reference (ROADMAP §3): its ORDER BY inside a
    query permutes a row block's placeholder and leaves the children in
    place, so each row reads another row's fields (and a field access
    above it fails on mismatched shapes). The port gathers the children
    with their rows; the reference's rows are pinned as they are."""
    sql = (
        "select id, r from (select id, r from mem.s.t "
        "order by id desc limit 3) s order by id"
    )
    ref, port = runners
    assert port.execute(sql).rows() == [(2, None), (3, ROWS[3]), (4, ROWS[4])]
    assert ref.execute(sql).rows() == [(2, None), (3, ROWS[1]), (4, ROWS[0])]
    sql = sql.replace("select id, r from (", "select id, r.y from (")
    assert port.execute(sql).rows() == [(2, None), (3, None), (4, "nine")]
    with pytest.raises(TypeError, match="incompatible shapes"):
        ref.execute(sql).rows()
