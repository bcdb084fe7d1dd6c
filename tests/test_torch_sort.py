"""Parity of the port's sort lanes (presto_tpu_torch.ops.common) and
ordering operators (presto_tpu_torch.ops.sort) with the reference's on
the CPU: the same seeded numpy columns through both packages."""

from __future__ import annotations

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from presto_tpu import expr as RE
from presto_tpu import types as RT
from presto_tpu.ops import common as RC
from presto_tpu.ops import sort as RS
from presto_tpu_torch import convert
from presto_tpu_torch import expr as PE
from presto_tpu_torch import types as PT
from presto_tpu_torch.ops import common as PC
from presto_tpu_torch.ops import sort as PS
from torch_parity import assert_columns_equal, both_pages, jax_live_columns
from torch_parity import one_torch_thread  # noqa: F401

CAP = 300
LIVE = 270


def _columns(seed: int):
    """Few distinct values per column (so keys tie and later keys and
    stability matter), NULLs, and floats with NaN, -0.0 and +-inf."""
    rng = np.random.default_rng(seed)
    f = rng.choice(
        np.array([np.nan, -0.0, 0.0, 1.5, -2.25, np.inf, -np.inf, 3.0]), CAP
    )
    return {
        "i": (rng.integers(-3, 4, CAP).astype(np.int64),
              rng.random(CAP) < 0.85, "bigint", None),
        "n": (rng.integers(0, 5, CAP).astype(np.int32), None, "integer",
              None),
        "f": (f, rng.random(CAP) < 0.9, "double", None),
        "r": (f.astype(np.float32), None, "real", None),
        "d": (rng.integers(-300, 300, CAP).astype(np.int64) * 7,
              rng.random(CAP) < 0.9, "decimal(12,2)", None),
        "dt": (rng.integers(9000, 9010, CAP).astype(np.int32), None, "date",
               None),
        "s": (rng.integers(0, 3, CAP).astype(np.int32),
              rng.random(CAP) < 0.8, "varchar",
              np.asarray(["x", "y", "z"], object)),
    }


def _type(name):
    return _columns(0)[name][2]


KEYSETS = {
    "int": [("i", False, None)],
    "float_nan_negzero": [("f", False, None)],
    "float_desc_nulls_last": [("f", True, False)],
    "real": [("r", True, None)],
    "int_then_string_desc": [("n", False, None), ("s", True, None)],
    "decimal_date_float": [("d", False, True), ("dt", True, None),
                           ("f", False, None)],
}


@pytest.mark.parametrize("keyset", sorted(KEYSETS))
@pytest.mark.parametrize("seed", [0, 1])
def test_sort_order_and_boundaries_match_reference(keyset, seed):
    cols = _columns(seed)
    ref_page, port_page = both_pages(cols, LIVE)
    spec = KEYSETS[keyset]
    live = np.arange(CAP) < LIVE
    live[::7] = False  # a masked page: dead rows in the middle too
    ref_keys = [
        (ref_page.block(c).data, ref_page.block(c).valid, RT.parse_type(_type(c)))
        for c, _, _ in spec
    ]
    port_keys = [
        (port_page.block(c).data, port_page.block(c).valid,
         PT.parse_type(_type(c)))
        for c, _, _ in spec
    ]
    desc = [d for _, d, _ in spec]
    nf = [d if n is None else n for _, d, n in spec]
    ref_order = np.asarray(
        RC.sort_order(ref_keys, jnp.asarray(live), desc, nf)
    )
    port_order = PC.sort_order(port_keys, torch.from_numpy(live), desc, nf)
    assert port_order.dtype == torch.int64
    np.testing.assert_array_equal(port_order.numpy(), ref_order)

    ref_bnd = RC.boundaries(
        [(d[ref_order], None if v is None else v[ref_order])
         for d, v, _ in ref_keys],
        jnp.asarray(live[ref_order]),
    )
    port_bnd = PC.boundaries(
        [(d[port_order], None if v is None else v[port_order])
         for d, v, _ in port_keys],
        torch.from_numpy(live)[port_order],
    )
    np.testing.assert_array_equal(port_bnd.numpy(), np.asarray(ref_bnd))


def test_orderable_floats_nan_last_and_negative_zero_equal():
    x = torch.tensor([np.nan, 1.0, -0.0, 0.0, -np.inf, np.inf, -1.0])
    img = PC.orderable_i64(x, PT.DOUBLE)
    assert img[2] == img[3]  # -0.0 == +0.0
    order = torch.sort(img, stable=True).indices.tolist()
    assert order == [4, 6, 2, 3, 1, 5, 0]  # NaN sorts last


def test_boundaries_group_nans_and_nulls_together():
    data = torch.tensor([np.nan, np.nan, 1.0, 7.0, 9.0, 2.0])
    valid = torch.tensor([True, True, True, False, False, True])
    live = torch.tensor([True] * 5 + [False])
    bnd = PC.boundaries([(data, valid)], live)
    assert bnd.tolist() == [True, False, True, True, False, False]


def test_long_decimal_keys_raise():
    """A long decimal has no single orderable lane in either package;
    its two ``key_lanes`` equal the reference's, and they order and
    group int128 values as Python ints do."""
    vals = [0, -1, 1, 2**63, -(2**63), 2**64 + 3, -(2**64) - 3, 2**100,
            -(2**100), 5, 2**63, -1]
    limbs = RT.int128_limbs(vals)
    t_ref, t_port = RT.decimal(30, 2), PT.decimal(30, 2)
    with pytest.raises(NotImplementedError, match="long decimals"):
        RC.orderable_i64(jnp.asarray(limbs), t_ref)
    with pytest.raises(NotImplementedError, match="long decimals"):
        PC.orderable_i64(torch.from_numpy(limbs), t_port)
    want = RC.key_lanes(jnp.asarray(limbs), t_ref)
    got = PC.key_lanes(torch.from_numpy(limbs), t_port)
    for w, g in zip(want, got, strict=True):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    live = torch.ones(len(vals), dtype=torch.bool)
    order = PC.sort_order([(torch.from_numpy(limbs), None, t_port)], live)
    assert order.tolist() == sorted(range(len(vals)), key=lambda i: vals[i])
    sorted_limbs = torch.from_numpy(limbs)[order]
    bnd = PC.boundaries([(sorted_limbs, None)], live)
    svals = sorted(vals)
    assert bnd.tolist() == [
        i == 0 or svals[i] != svals[i - 1] for i in range(len(vals))
    ]


def _sort_keys(spec, E, S, T):
    return [
        S.SortKey(E.ColumnRef(c, T.parse_type(_type(c))), d, n)
        for c, d, n in spec
    ]


@pytest.mark.parametrize("keyset", sorted(KEYSETS))
@pytest.mark.parametrize("limit", [None, 17])
def test_order_by_matches_reference(keyset, limit):
    cols = _columns(3)
    ref_page, port_page = both_pages(cols, LIVE)
    spec = KEYSETS[keyset]
    ref = RS.order_by(ref_page, _sort_keys(spec, RE, RS, RT), limit)
    port = PS.order_by(port_page, _sort_keys(spec, PE, PS, PT), limit)
    assert port.capacity == ref.capacity
    assert_columns_equal(jax_live_columns(ref), convert.page_to_numpy(port))


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("n", [0, 5, 2000])
def test_limit_matches_reference(masked, n):
    cols = _columns(4)
    ref_page, port_page = both_pages(cols, LIVE)
    if masked:
        live = np.random.default_rng(4).random(CAP) < 0.5
        ref_page = dataclasses.replace(
            ref_page, live=jnp.asarray(live),
            num_valid=jnp.asarray(int(live.sum()), jnp.int32))
        port_page = dataclasses.replace(
            port_page, live=torch.from_numpy(live),
            num_valid=torch.tensor(int(live.sum()), dtype=torch.int32))
    ref = RS.limit(ref_page, n)
    port = PS.limit(port_page, n)
    assert port.capacity == ref.capacity
    assert int(port.num_valid) == int(ref.num_valid)
    assert_columns_equal(jax_live_columns(ref), convert.page_to_numpy(port))


@pytest.mark.parametrize("columns", [["n", "s"], ["i", "f"], ["dt"]])
def test_distinct_matches_reference(columns):
    cols = {c: _columns(5)[c] for c in columns}
    ref_page, port_page = both_pages(cols, LIVE)
    ref, ref_ovf = RS.distinct(ref_page, 64)
    port, port_ovf = PS.distinct(port_page, 64)
    assert bool(port_ovf) == bool(ref_ovf)
    assert_columns_equal(jax_live_columns(ref), convert.page_to_numpy(port))


# ------------------------------------------------- the root TopN on the card


def _topn_table():
    """64 seeded rows: few distinct keys (ties), NULLs in every nullable
    key, doubles with NaN, -0.0, +0.0 and +-inf, long decimals, varchars
    and an array column."""
    import decimal

    rng = np.random.default_rng(21)
    n = 64
    f = rng.choice(
        np.array([np.nan, -0.0, 0.0, 1.5, -2.25, np.inf, -np.inf]), n
    )
    amts = [decimal.Decimal(v).scaleb(-3)
            for v in (2**70 + 1, -(2**66), 5, -5, 2**63)]
    return {
        "id": list(range(n)),
        "k": [int(v) for v in rng.integers(0, 4, n)],
        "ni": [None if rng.random() < 0.25 else int(v)
               for v in rng.integers(-2, 3, n)],
        "f": [None if rng.random() < 0.1 else float(v) for v in f],
        "amt": [None if rng.random() < 0.15 else amts[int(i)]
                for i in rng.integers(0, len(amts), n)],
        "s": [None if rng.random() < 0.2 else "abc"[int(i)] * (1 + int(i))
              for i in rng.integers(0, 3, n)],
        "arr": [None if i % 9 == 0 else list(range(i % 4)) for i in range(n)],
    }


def _topn_types(T):
    return {"id": T.BIGINT, "k": T.INTEGER, "ni": T.BIGINT, "f": T.DOUBLE,
            "amt": T.decimal(30, 3), "s": T.VARCHAR, "arr": T.array(T.BIGINT)}


#: name -> (SELECT ... FROM mem.s.t ..., whether the TopN runs on the
#: device: the statement's live rows exceed its limit)
ROOT_TOPN = {
    "ties_on_first_key": ("select id, k from mem.s.t order by k limit 9",
                          True),
    "nulls_default_asc": ("select id, ni from mem.s.t order by ni limit 52",
                          True),
    "nulls_first_asc": (
        "select id, ni from mem.s.t order by ni asc nulls first limit 20",
        True),
    "nulls_default_desc": (
        "select id, ni from mem.s.t order by ni desc limit 20", True),
    "nulls_last_desc": (
        "select id, ni from mem.s.t order by ni desc nulls last, k limit 55",
        True),
    "double_nan_negative_zero": (
        "select id, f from mem.s.t order by f limit 40", True),
    "double_desc_nulls_last": (
        "select id, f from mem.s.t order by f desc nulls last, k limit 12",
        True),
    "long_decimal_key": (
        "select id, amt from mem.s.t order by amt desc, k limit 10", True),
    "varchar_key": (
        "select id, s from mem.s.t order by s desc nulls last, k limit 11",
        True),
    "array_column_in_output": (
        "select id, arr, s from mem.s.t order by k desc, ni limit 6", True),
    "masked_input": (
        "select id, f from mem.s.t where k > 0 order by f, ni limit 5",
        True),
    "limit_zero": ("select id, k from mem.s.t order by k limit 0", True),
    "limit_covers_every_row": (
        "select id, k from mem.s.t order by k desc limit 64", False),
}


@pytest.fixture(scope="module")
def topn_runners():
    from test_torch_arrays import both_runners

    return both_runners({("s", "t"): (_topn_types, _topn_table)})


@pytest.mark.parametrize("case", sorted(ROOT_TOPN))
def test_root_topn_matches_reference_row_for_row(topn_runners, case):
    # the statement's root ORDER BY ... LIMIT: over more rows than its
    # limit the port sorts on its device and copies the limit's rows;
    # the reference sorts every row on the host. Same rows, same order
    from test_torch_arrays import assert_same_rows
    from presto_tpu_torch.utils.metrics import REGISTRY

    sql, engaged = ROOT_TOPN[case]
    ref, port = topn_runners
    runs = REGISTRY.counter("root_topn.device")
    before = runs.total
    got = port.execute(sql).rows()
    assert runs.total - before == int(engaged)
    assert_same_rows(got, ref.execute(sql).rows())
