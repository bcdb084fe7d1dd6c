"""Parity of the port's joins (presto_tpu_torch.ops.join) and dynamic
filters (presto_tpu_torch.exec.dynfilter) with the reference's on the
CPU: the same seeded numpy columns through both packages."""

from __future__ import annotations

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from presto_tpu import expr as RE
from presto_tpu import types as RT
from presto_tpu.exec import dynfilter as RD
from presto_tpu.ops import join as RJ
from presto_tpu_torch import convert
from presto_tpu_torch import expr as PE
from presto_tpu_torch import types as PT
from presto_tpu_torch.exec import dynfilter as PD
from presto_tpu_torch.ops import join as PJ
from torch_parity import assert_columns_equal, both_pages, jax_live_columns

P_CAP, P_LIVE = 200, 180
B_CAP, B_LIVE = 64, 50


def _probe(seed: int):
    rng = np.random.default_rng(seed)
    return {
        "pk": (rng.integers(0, 14, P_CAP).astype(np.int32),
               rng.random(P_CAP) < 0.9, "integer", None),
        "pk2": (rng.integers(0, 3, P_CAP).astype(np.int32), None, "integer",
                None),
        "pv": (rng.integers(-10**9, 10**9, P_CAP).astype(np.int64),
               rng.random(P_CAP) < 0.8, "bigint", None),
        "ps": (rng.integers(0, 3, P_CAP).astype(np.int32), None, "varchar",
               np.asarray(["a", "b", "c"], object)),
    }


def _build(seed: int, unique: bool):
    rng = np.random.default_rng(seed + 100)
    if unique:  # keys 0..63 once each; the probe's 0..13 overlap them
        bk = rng.permutation(B_CAP).astype(np.int32)
    else:
        bk = rng.integers(0, 10, B_CAP).astype(np.int32)
    return {
        "bk": (bk, rng.random(B_CAP) < 0.9, "integer", None),
        "bk2": (rng.integers(0, 3, B_CAP).astype(np.int32), None, "integer",
                None),
        "bv": (rng.standard_normal(B_CAP), rng.random(B_CAP) < 0.8,
               "double", None),
        "bs": (rng.integers(0, 2, B_CAP).astype(np.int32), None, "varchar",
               np.asarray(["u", "v"], object)),
    }


def _masked(pages, live):
    ref, port = pages
    n = int(live.sum())
    return (
        dataclasses.replace(ref, live=jnp.asarray(live),
                            num_valid=jnp.asarray(n, jnp.int32)),
        dataclasses.replace(port, live=torch.from_numpy(live),
                            num_valid=torch.tensor(n, dtype=torch.int32)),
    )


def _join_both(join_type, unique, two_keys, masked, out_capacity=4096,
               seed=0):
    probe = both_pages(_probe(seed), P_LIVE)
    build = both_pages(_build(seed, unique), B_LIVE)
    if masked:
        rng = np.random.default_rng(seed + 7)
        probe = _masked(probe, (rng.random(P_CAP) < 0.7) & (
            np.arange(P_CAP) < P_LIVE))
        build = _masked(build, (rng.random(B_CAP) < 0.8) & (
            np.arange(B_CAP) < B_LIVE))
    pkeys = ["pk", "pk2"] if two_keys else ["pk"]
    bkeys = ["bk", "bk2"] if two_keys else ["bk"]
    kw = dict(
        join_type=join_type, build_payload=["bk", "bv", "bs"],
        build_unique=unique, out_capacity=out_capacity,
        payload_rename={"bv": "bv_out"},
    )
    ref, ref_ovf = RJ.hash_join(probe[0], build[0], pkeys, bkeys, **kw)
    port, port_ovf = PJ.hash_join(probe[1], build[1], pkeys, bkeys, **kw)
    assert port_ovf.dtype == torch.bool and port_ovf.dim() == 0
    assert bool(port_ovf) == bool(ref_ovf)
    assert port.names == ref.names
    assert port.capacity == ref.capacity
    assert int(port.num_valid) == int(ref.num_valid)
    if not bool(port_ovf):
        assert_columns_equal(jax_live_columns(ref), convert.page_to_numpy(port))
    return port, bool(port_ovf)


@pytest.mark.parametrize("join_type", ["inner", "left", "full", "semi", "anti"])
@pytest.mark.parametrize("unique", [False, True])
@pytest.mark.parametrize("two_keys", [False, True])
@pytest.mark.parametrize("masked", [False, True])
def test_hash_join_matches_reference(join_type, unique, two_keys, masked):
    out, overflow = _join_both(join_type, unique, two_keys, masked)
    assert not overflow
    if join_type in ("inner", "left", "full") and not unique:
        assert int(out.num_valid) > P_LIVE // 2  # duplicates did expand


@pytest.mark.parametrize("join_type", ["inner", "left", "full"])
def test_hash_join_reports_overflow(join_type):
    _, overflow = _join_both(join_type, False, False, False, out_capacity=64)
    assert overflow


def test_null_keys_never_match():
    probe = {"k": (np.array([1, 2, 3], np.int32), np.array([1, 0, 1], bool),
                   "integer", None)}
    build = {"b": (np.array([1, 2, 3], np.int32), np.array([1, 1, 0], bool),
                   "integer", None)}
    p, b = both_pages(probe, 3)[1], both_pages(build, 3)[1]
    out, _ = PJ.hash_join(p, b, ["k"], ["b"], "inner", ["b"],
                          out_capacity=16)
    assert convert.page_to_numpy(out)["k"][0].tolist() == [1]
    out, _ = PJ.hash_join(p, b, ["k"], ["b"], "anti")
    assert convert.page_to_numpy(out)["k"][0].tolist() == [2, 3]


def test_pack_keys_is_bijective_on_32_bit_pairs():
    a = torch.tensor([0, -1, 2 ** 31 - 1, -(2 ** 31), 5], dtype=torch.int32)
    b = torch.tensor([-1, 0, -(2 ** 31), 2 ** 31 - 1, 5], dtype=torch.int32)
    packed = PJ.pack_keys(a, b)
    assert len(set(packed.tolist())) == 5
    np.testing.assert_array_equal(
        packed.numpy(),
        np.asarray(RJ.pack_keys(jnp.asarray(a.numpy()), jnp.asarray(b.numpy()))),
    )


def test_wide_two_column_keys_raise():
    cols = {"a": (np.arange(4, dtype=np.int64), None, "bigint", None),
            "b": (np.arange(4, dtype=np.int32), None, "integer", None)}
    page = both_pages(cols, 4)[1]
    with pytest.raises(NotImplementedError, match="32-bit"):
        PJ.hash_join(page, page, ["a", "b"], ["a", "b"], "semi")


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("out_capacity", [8192, 100])
def test_cross_join_matches_reference(masked, out_capacity):
    left = both_pages(_probe(3), 40)
    right = both_pages(_build(3, False), 30)
    if masked:
        right = _masked(right, np.random.default_rng(3).random(B_CAP) < 0.4)
    ref, ref_ovf = RJ.cross_join(left[0], right[0], out_capacity)
    port, port_ovf = PJ.cross_join(left[1], right[1], out_capacity)
    assert bool(port_ovf) == bool(ref_ovf) == (out_capacity == 100)
    assert int(port.num_valid) == int(ref.num_valid)
    assert_columns_equal(jax_live_columns(ref), convert.page_to_numpy(port))


# ----------------------------------------------------- dynamic filters


def _conjunct_shape(e):
    """A package-neutral picture of one conjunct."""
    name = type(e).__name__
    if name == "Between":
        return (name, e.arg.name, e.low.value, e.high.value)
    if name == "InList":
        return (name, e.arg.name, tuple(v.value for v in e.values))
    return (name, e.value)


DYN_BUILDS = {
    "int": ("integer", lambda r: r.integers(5, 40, B_CAP).astype(np.int32)),
    "bigint": ("bigint", lambda r: r.integers(-2**40, 2**40, B_CAP)),
    "double_with_nan": ("double", lambda r: np.where(
        r.random(B_CAP) < 0.2, np.nan, r.standard_normal(B_CAP))),
    "real": ("real", lambda r: r.standard_normal(B_CAP).astype(np.float32)),
    "date": ("date", lambda r: r.integers(9000, 9500, B_CAP).astype(np.int32)),
    "decimal": ("decimal(12,2)", lambda r: r.integers(-10**6, 10**6, B_CAP)),
    "string": ("varchar", lambda r: r.integers(0, 3, B_CAP).astype(np.int32)),
}


@pytest.mark.parametrize("kind", sorted(DYN_BUILDS))
@pytest.mark.parametrize("live_rows", [B_LIVE, 0])
def test_device_conjuncts_match_reference(kind, live_rows):
    type_name, make = DYN_BUILDS[kind]
    rng = np.random.default_rng(len(kind))
    dict_values = (
        np.asarray(["ASIA", "EUROPE", "MIDDLE EAST"], object)
        if type_name == "varchar" else None
    )
    build = {
        "k": (make(rng), rng.random(B_CAP) < 0.85, type_name, dict_values),
        "other": (np.arange(B_CAP, dtype=np.int32), None, "integer", None),
    }
    ref_page, port_page = both_pages(build, live_rows)
    t = PT.parse_type(type_name)
    probe_schema_port = {"pk": t, "po": PT.BIGINT}  # "po" mismatches: skipped
    rt = RT.parse_type(type_name)
    pairs = [("pk", "k"), ("po", "other")]
    ref_c, ref_n = RD.device_conjuncts(
        ref_page, pairs, {"pk": rt, "po": RT.BIGINT}
    )
    port_c, port_n = PD.device_conjuncts(port_page, pairs, probe_schema_port)
    assert port_n == ref_n
    assert [_conjunct_shape(c) for c in port_c] == [
        _conjunct_shape(c) for c in ref_c
    ]
    if live_rows == 0:
        assert [_conjunct_shape(c) for c in port_c] == [("Literal", False)]


def test_device_conjuncts_skip_large_dictionaries():
    values = np.asarray([f"v{i:03d}" for i in range(100)], object)
    build = {"k": (np.arange(B_CAP, dtype=np.int32), None, "varchar", values)}
    page = both_pages(build, B_LIVE)[1]
    assert PD.device_conjuncts(page, [("pk", "k")], {"pk": PT.VARCHAR},
                               ndv_limit=64) == ([], 0)
    conj, n = PD.device_conjuncts(page, [("pk", "k")], {"pk": PT.VARCHAR},
                                  ndv_limit=100)
    assert n == 1 and len(conj[0].values) == B_LIVE


def test_inlist_filters_match_reference():
    probe = _probe(9)
    ref_page, port_page = both_pages(probe, P_LIVE)
    exprs = [
        ("ps", "varchar", ["a", "c", "zz", None], False),
        ("pk", "integer", [1, 5, 13], True),
        ("pv", "bigint", [0, 7], False),
    ]
    for col, tname, members, negate in exprs:
        r = RE.InList(RE.ColumnRef(col, RT.parse_type(tname)), tuple(
            RE.Literal(m, RT.parse_type(tname)) for m in members), negate)
        p = PE.InList(PE.ColumnRef(col, PT.parse_type(tname)), tuple(
            PE.Literal(m, PT.parse_type(tname)) for m in members), negate)
        np.testing.assert_array_equal(
            PE.eval_predicate(p, port_page).numpy(),
            np.asarray(RE.eval_predicate(r, ref_page)),
        )
