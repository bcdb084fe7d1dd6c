"""Parity of the port's nested blocks with the reference's, on the CPU.

Array, map and row pages are built from the same seeded Python values
in both packages (``Page.from_pydict``) and from the same numpy column
tuples (``convert``), then compacted under the same selection masks,
re-bucketed up and down and decoded: every tensor (offsets, flat values,
children, validity, padding included) must be equal, and the decoded
rows too. Also the host payload half: ``ArrayColumn`` slices, the
vectorised row take against the reference's per-row ``_slice_payload``,
the chunk merge, staging, and the split cache's spill copy."""

from __future__ import annotations

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from presto_tpu import page as RP
from presto_tpu import types as RT
from presto_tpu.exec import staging as RS
from presto_tpu.exec import streaming as RSTR
from presto_tpu.server import pages_wire as RW
from presto_tpu_torch import convert
from presto_tpu_torch import page as PP
from presto_tpu_torch import types as PT
from presto_tpu_torch.exec import staging as PS
from presto_tpu_torch.exec import streaming as PSTR
from presto_tpu_torch.server import pages_wire as PW
from torch_parity import one_torch_thread  # noqa: F401

CAP = 64
WORDS = ["alpha", "beta", "gamma", "delta", "eps", "zeta"]


def _values(seed: int, n: int = CAP):
    """Arrays (NULL and empty rows), string arrays, maps (NULL values,
    empty and NULL rows), rows (NULL rows and fields), and a long
    decimal column, from one seed."""
    rng = np.random.default_rng(seed)

    def maybe(v, p=0.15):
        return None if rng.random() < p else v

    arr = [
        maybe([int(x) for x in rng.integers(-99, 99, rng.integers(0, 5))])
        for _ in range(n)
    ]
    tags = [
        maybe([WORDS[i] for i in rng.integers(0, 6, rng.integers(0, 4))])
        for _ in range(n)
    ]
    maps = [
        maybe({
            WORDS[int(k)]: maybe(int(rng.integers(-5, 5)), 0.2)
            for k in rng.choice(6, rng.integers(0, 4), replace=False)
        })
        for _ in range(n)
    ]
    rows = [
        maybe({
            "x": maybe(int(rng.integers(-9, 9)), 0.2),
            "y": maybe(WORDS[int(rng.integers(0, 6))], 0.2),
        })
        for _ in range(n)
    ]
    dec = [
        maybe(int(rng.integers(-(2**62), 2**62)) * int(rng.integers(1, 2**40)))
        for _ in range(n)
    ]
    return {"arr": arr, "tags": tags, "m": maps, "r": rows, "dec": dec}


def _schema(T):
    return {
        "arr": T.array(T.BIGINT),
        "tags": T.array(T.VARCHAR),
        "m": T.map_(T.VARCHAR, T.BIGINT),
        "r": T.row(("x", T.BIGINT), ("y", T.VARCHAR)),
        "dec": T.decimal(38, 0),
    }


def _pages(seed: int, n: int = CAP):
    vals = _values(seed, n)
    return (
        RP.Page.from_pydict(vals, _schema(RT), capacity=CAP),
        PP.Page.from_pydict(vals, _schema(PT), capacity=CAP, device="cpu"),
    )


def _raw(blk):
    """Every array of a block (either package) as numpy, children
    included, in one fixed order."""
    out = [np.asarray(blk.data), None if blk.valid is None else np.asarray(blk.valid)]
    out.append(None if blk.offsets is None else np.asarray(blk.offsets))
    for ch in blk.children or ():
        out.extend(_raw(ch))
    return out


def _assert_same_page(ref_page, port_page):
    assert ref_page.names == port_page.names
    assert int(ref_page.num_valid) == int(port_page.num_valid)
    for name, rb, pb in zip(ref_page.names, ref_page.blocks, port_page.blocks):
        assert str(rb.dtype) == str(pb.dtype), name
        rd, pd = _raw(rb), _raw(pb)
        assert len(rd) == len(pd), name
        for r, p in zip(rd, pd):
            assert (r is None) == (p is None), name
            if r is not None:
                np.testing.assert_array_equal(p, r, err_msg=name)
    assert port_page.to_pylist() == ref_page.to_pylist()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_from_pydict_matches_reference(seed):
    ref, port = _pages(seed)
    _assert_same_page(ref, port)


@pytest.mark.parametrize("seed", [0, 3])
@pytest.mark.parametrize("out_cap", [None, 16, 128])
def test_compact_page_gathers_nested_blocks(seed, out_cap):
    """A masked page compacts to the front: array and map values are
    laid out again for the selected rows, row children follow, and the
    rows past the live count read as empty."""
    ref, port = _pages(seed)
    live = np.random.default_rng(seed + 7).random(CAP) < 0.4
    live[50:] = False  # past the 50 built rows
    if out_cap == 16:
        live[np.flatnonzero(live)[16:]] = False
    n = int(live.sum())
    ref = dataclasses.replace(
        ref, live=jnp.asarray(live), num_valid=jnp.asarray(n, jnp.int32)
    )
    port = dataclasses.replace(
        port, live=torch.from_numpy(live),
        num_valid=torch.tensor(n, dtype=torch.int32),
    )
    _assert_same_page(
        RP.compact_page(ref, out_cap), PP.compact_page(port, out_cap)
    )


@pytest.mark.parametrize("capacity", [8, 40, 64, 256])
def test_pad_capacity_rebuckets_nested_blocks(capacity):
    """Offsets edge-pad when growing (padding rows are empty) and slice
    when shrinking; row children pad and slice with their parent."""
    ref, port = _pages(4, n=8)
    _assert_same_page(
        RP.pad_capacity(ref, capacity), PP.pad_capacity(port, capacity)
    )


@pytest.mark.parametrize("repeats", [None, 16])
@pytest.mark.parametrize("col", ["arr", "tags", "m"])
def test_gather_block_makes_room_for_repeated_values(col, repeats):
    """Every row selected 16 times needs more value slots than the
    source's 1,024 bucket: the gather widens the value axis (by the
    static bound, or to the bucket of the gathered total) and every copy
    decodes whole."""
    k = 16
    vals = _values(5)[col]
    page = PP.Page.from_pydict(
        {col: vals}, {col: _schema(PT)[col]}, capacity=CAP, device="cpu"
    )
    blk = page.block(col)
    vcap = (blk.children[0] if blk.dtype.is_map else blk).data.shape[0]
    assert sum(len(v) for v in vals if v is not None) * k > vcap
    out = PP.gather_block(
        blk, torch.arange(CAP * k) // k, CAP * k, repeats=repeats
    )
    got = PP.Page(
        blocks=(out,),
        num_valid=torch.tensor(CAP * k, dtype=torch.int32),
        names=(col,),
    ).to_pylist()
    assert [r[col] for r in got] == [v for v in vals for _ in range(k)]


def test_nested_in_nested_raises_in_both():
    """One nesting level (the reference's documented deviation)."""
    for P, T in ((RP, RT), (PP, PT)):
        kw = {} if P is RP else {"device": "cpu"}
        rt = T.row(("a", T.array(T.BIGINT)), ("b", T.BIGINT))
        with pytest.raises(NotImplementedError):
            P.Page.from_pydict({"r": [{"a": [1, 2], "b": 3}]}, {"r": rt}, **kw)
        mt = T.map_(T.VARCHAR, T.row(("x", T.BIGINT)))
        with pytest.raises(NotImplementedError):
            P.Page.from_pydict({"m": [{"k": {"x": 1}}]}, {"m": mt}, **kw)
        with pytest.raises(NotImplementedError, match="NULL array elements"):
            P.Page.from_pydict(
                {"a": [[1, None]]}, {"a": T.array(T.BIGINT)}, **kw
            )


def test_convert_round_trips_nested_and_long_decimal_columns():
    """One numpy description -> the same page in both packages: arrays
    as (offsets, values), maps as (offsets, keys, values), rows as their
    children's tuples, long decimals as (n, 2) limb pairs."""
    _, port = _pages(5)
    cols = convert.page_to_numpy(port)
    again = convert.page_from_numpy(cols, CAP, device="cpu")
    assert again.to_pylist() == port.to_pylist()
    off, vals = cols["arr"][0]
    assert off.dtype == np.int32 and len(off) == CAP + 1
    assert len(vals) == off[-1]
    assert cols["dec"][0].shape == (CAP, 2)
    keys, values = cols["m"][0][1:]
    assert keys[2] == "varchar" and values[2] == "bigint"
    assert [c[2] for c in cols["r"][0]] == ["bigint", "varchar"]


def _array_column(C, seed: int, n: int = 500):
    rng = np.random.default_rng(seed)
    lens = rng.integers(0, 6, n)
    off = np.zeros(n + 1, np.int32)
    np.cumsum(lens, out=off[1:])
    return C(
        offsets=off,
        values=rng.integers(-(10**6), 10**6, int(off[-1])).astype(np.int64),
        valid=rng.random(n) < 0.9,
    )


def _same_array_column(got, want):
    np.testing.assert_array_equal(got.offsets, want.offsets)
    np.testing.assert_array_equal(got.values, want.values)
    np.testing.assert_array_equal(got.valid, want.valid)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_slice_payload_take_equals_reference(seed):
    """The port's vectorised take (lengths, cumsum, one np.repeat-built
    gather index) gives the reference's per-row concatenation."""
    rng = np.random.default_rng(seed + 11)
    mask = rng.random(500) < 0.3
    if seed == 2:
        mask[:] = False
    schema = {"a": PT.array(PT.BIGINT)}
    got = PSTR._slice_payload({"a": _array_column(PS.ArrayColumn, seed)},
                              schema, mask)["a"]
    want = RSTR._slice_payload(
        {"a": _array_column(RS.ArrayColumn, seed)},
        {"a": RT.array(RT.BIGINT)}, mask,
    )["a"]
    _same_array_column(got, want)
    sl = _array_column(PS.ArrayColumn, seed)[37:300]
    _same_array_column(sl, _array_column(RS.ArrayColumn, seed)[37:300])


def test_merge_array_parts_equals_reference():
    parts = [_array_column(PS.ArrayColumn, s, n) for s, n in ((0, 10), (1, 0), (2, 7))]
    rparts = [_array_column(RS.ArrayColumn, s, n) for s, n in ((0, 10), (1, 0), (2, 7))]
    schema_p, schema_r = {"a": PT.array(PT.BIGINT)}, {"a": RT.array(RT.BIGINT)}
    got = PW.merge_payloads([({"a": p}, schema_p, 0) for p in parts], schema_p)
    want = RW.merge_payloads([({"a": p}, schema_r, 0) for p in rparts], schema_r)
    _same_array_column(got["a"], want["a"])


def test_stage_array_column_matches_reference():
    col_p, col_r = _array_column(PS.ArrayColumn, 3, 100), _array_column(RS.ArrayColumn, 3, 100)
    ids = np.arange(100, dtype=np.int64)
    port = PS.stage_page({"id": ids, "a": col_p},
                         {"id": PT.BIGINT, "a": PT.array(PT.BIGINT)}, device="cpu")
    ref = RS.stage_page({"id": ids, "a": col_r},
                        {"id": RT.BIGINT, "a": RT.array(RT.BIGINT)})
    _assert_same_page(ref, port)


def test_split_cache_spill_copy_keeps_nested_blocks():
    """A nested page's host copy (the split cache's spill lane) and its
    restage hold the same tensors, children included."""
    _, port = _pages(6)
    back = PS.host_to_page(PS.page_to_host(port))
    for a, b in zip(port.blocks, back.blocks):
        for x, y in zip(_raw(a), _raw(b)):
            assert (x is None) == (y is None)
            if x is not None:
                np.testing.assert_array_equal(x, y)
    assert PS.page_nbytes(back) == PS.page_nbytes(port)
