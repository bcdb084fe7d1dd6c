"""Parity of the port's page model and staging (presto_tpu_torch.page,
presto_tpu_torch.exec.staging) with the JAX reference on the CPU."""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from presto_tpu import page as ref_page
from presto_tpu import types as RT
from presto_tpu.connectors.tpch import DictColumn as RefDictColumn
from presto_tpu.exec import staging as ref_staging
from presto_tpu_torch import convert
from presto_tpu_torch import page as port_page
from presto_tpu_torch import types as PT
from presto_tpu_torch.connectors.tpch import DictColumn
from presto_tpu_torch.exec import staging as port_staging
from torch_parity import assert_columns_equal, both_pages, jax_live_columns


def _payloads(seed: int, n: int):
    """The same SPI payloads for both packages: native numeric arrays,
    a pre-encoded dictionary column, a masked column with nulls and an
    object column of Python values."""
    rng = np.random.default_rng(seed)
    words = np.asarray(sorted(["AIR", "MAIL", "RAIL", "SHIP", "TRUCK"]), object)
    ids = rng.integers(0, len(words), n).astype(np.int32)
    masked_data = rng.integers(-500, 500, n).astype(np.int64)
    masked_valid = rng.random(n) < 0.8
    pyvals = np.empty(n, dtype=object)
    for i, v in enumerate(rng.integers(0, 3, n)):
        pyvals[i] = None if v == 0 else ["x", "y"][v - 1]
    common = {
        "k": rng.integers(-10**12, 10**12, n).astype(np.int64),
        "price": rng.integers(0, 10**8, n).astype(np.int64),
        "ship": rng.integers(8000, 10500, n).astype(np.int32),
        "ratio": rng.standard_normal(n),
        "obj": pyvals,
    }
    schema = {
        "k": "bigint",
        "price": "decimal(12,2)",
        "ship": "date",
        "ratio": "double",
        "obj": "varchar",
        "mode": "varchar",
        "m": "bigint",
    }
    ref = dict(common)
    ref["mode"] = RefDictColumn(ids=ids, values=words)
    ref["m"] = ref_staging.MaskedColumn(masked_data, masked_valid)
    port = dict(common)
    port["mode"] = DictColumn(ids=ids, values=words)
    port["m"] = port_staging.MaskedColumn(masked_data, masked_valid)
    return ref, port, schema


def _port_columns(page):
    return {
        name: (
            blk.data.numpy(),
            None if blk.valid is None else blk.valid.numpy(),
            str(blk.dtype),
            None if blk.dictionary is None else blk.dictionary.values,
        )
        for name, blk in zip(page.names, page.blocks)
    }


def _ref_columns(page):
    return {
        name: (
            np.asarray(blk.data),
            None if blk.valid is None else np.asarray(blk.valid),
            str(blk.dtype),
            None if blk.dictionary is None else blk.dictionary.values,
        )
        for name, blk in zip(page.names, page.blocks)
    }


@pytest.mark.parametrize("n,capacity", [(37, None), (1500, None), (300, 4096)])
def test_stage_page_matches_reference(n, capacity):
    ref_data, port_data, schema = _payloads(n, n)
    rs = {k: RT.parse_type(v) for k, v in schema.items()}
    ps = {k: PT.parse_type(v) for k, v in schema.items()}
    ref = ref_staging.stage_page(ref_data, rs, capacity=capacity)
    port = port_staging.stage_page(port_data, ps, capacity=capacity,
                                   device="cpu")
    assert port.capacity == ref.capacity
    assert int(port.num_valid) == int(ref.num_valid) == n
    assert port.num_valid.dtype == torch.int32
    # whole capacity, padding included: staging pads identically
    assert_columns_equal(_ref_columns(ref), _port_columns(port), rtol=0)
    for blk in port.blocks:
        assert blk.data.device.type == "cpu"
        assert blk.data.dtype == blk.dtype.torch_dtype


def test_stage_page_round_trips_through_convert():
    _, port_data, schema = _payloads(3, 200)
    page = port_staging.stage_page(
        port_data, {k: PT.parse_type(v) for k, v in schema.items()},
        device="cpu",
    )
    cols = convert.page_to_numpy(page)
    again = convert.page_to_numpy(
        convert.page_from_numpy(cols, 200, device="cpu")
    )
    assert_columns_equal(cols, again, rtol=0)
    assert len(cols["k"][0]) == 200


@pytest.mark.parametrize("n", [0, 1, 1023, 1024, 1025, 5000])
def test_bucket_capacity_matches_reference(n):
    assert port_staging.bucket_capacity(n) == ref_staging.bucket_capacity(n)


def _masked_columns(seed: int, cap: int):
    rng = np.random.default_rng(seed)
    return {
        "a": (rng.integers(-99, 99, cap).astype(np.int64), None, "bigint", None),
        "d": (
            rng.integers(0, 10**6, cap).astype(np.int64),
            rng.random(cap) < 0.7,
            "decimal(12,2)",
            None,
        ),
        "s": (
            rng.integers(0, 3, cap).astype(np.int32),
            None,
            "varchar",
            np.asarray(["A", "N", "R"], object),
        ),
        "f": (rng.standard_normal(cap), None, "double", None),
    }


@pytest.mark.parametrize(
    "seed,cap,keep,out_capacity",
    [(0, 64, 0.5, None), (1, 64, 0.0, None), (2, 64, 1.0, 32), (3, 128, 0.3, 256)],
)
def test_compact_page_matches_reference(seed, cap, keep, out_capacity):
    cols = _masked_columns(seed, cap)
    live = np.random.default_rng(seed + 100).random(cap) < keep
    ref, port = both_pages(cols, cap)
    ref = ref_page.Page(
        blocks=ref.blocks,
        num_valid=jnp.asarray(int(live.sum()), jnp.int32),
        names=ref.names,
        live=jnp.asarray(live),
    )
    port = port_page.Page(
        blocks=port.blocks,
        num_valid=torch.tensor(int(live.sum()), dtype=torch.int32),
        names=port.names,
        live=torch.from_numpy(live),
    )
    ref_c = ref_page.compact_page(ref, out_capacity)
    port_c = port_page.compact_page(port, out_capacity)
    assert port_c.live is None and port_c.capacity == ref_c.capacity
    assert int(port_c.num_valid) == int(ref_c.num_valid)
    # the fill rows past the live count copy row 0 in both
    assert_columns_equal(_ref_columns(ref_c), _port_columns(port_c), rtol=0)
    assert_columns_equal(
        jax_live_columns(ref_c), convert.page_to_numpy(port_c), rtol=0
    )


@pytest.mark.parametrize("capacity", [16, 100, 40])
def test_pad_capacity_matches_reference(capacity):
    cols = _masked_columns(7, 40)
    ref, port = both_pages(cols, 30)
    ref_p = ref_page.pad_capacity(ref, capacity)
    port_p = port_page.pad_capacity(port, capacity)
    assert port_p.capacity == ref_p.capacity == capacity
    assert int(port_p.num_valid) == int(ref_p.num_valid)
    assert_columns_equal(_ref_columns(ref_p), _port_columns(port_p), rtol=0)


@pytest.mark.parametrize(
    "seed,n,size,fill", [(0, 50, 50, 0), (1, 50, 10, 7), (2, 50, 80, -1), (3, 1, 4, 0)]
)
def test_nonzero_static_matches_jnp(seed, n, size, fill):
    mask = np.random.default_rng(seed).random(n) < 0.4
    (want,) = jnp.nonzero(jnp.asarray(mask), size=size, fill_value=fill)
    got = port_page.nonzero_static(torch.from_numpy(mask), size, fill)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_from_pydict_to_pylist_matches_reference():
    data = {
        "i": [1, None, -3, 4],
        "s": ["b", "a", None, "b"],
        "d": [1.25, None, -0.5, 3.0],
        "dt": [9131, None, -1, 11016],  # epoch days
        "f": [0.5, 1.5, None, -2.0],
        "b": [True, False, None, True],
    }
    rs = {"i": RT.BIGINT, "s": RT.VARCHAR, "d": RT.decimal(10, 2),
          "dt": RT.DATE, "f": RT.DOUBLE, "b": RT.BOOLEAN}
    ps = {"i": PT.BIGINT, "s": PT.VARCHAR, "d": PT.decimal(10, 2),
          "dt": PT.DATE, "f": PT.DOUBLE, "b": PT.BOOLEAN}
    ref = ref_page.Page.from_pydict(data, rs, capacity=8)
    port = port_page.Page.from_pydict(data, ps, capacity=8, device="cpu")
    assert port.to_pylist() == ref.to_pylist()
    assert_columns_equal(_ref_columns(ref), _port_columns(port), rtol=0)


def test_type_map():
    assert PT.BIGINT.torch_dtype == torch.int64
    assert PT.INTEGER.torch_dtype == torch.int32
    assert PT.DATE.torch_dtype == torch.int32
    assert PT.VARCHAR.torch_dtype == torch.int32
    assert PT.DOUBLE.torch_dtype == torch.float64
    assert PT.REAL.torch_dtype == torch.float32
    assert PT.BOOLEAN.torch_dtype == torch.bool
    assert PT.decimal(12, 2).torch_dtype == torch.int64
    for name in ("bigint", "integer", "date", "varchar", "double", "real",
                 "boolean", "decimal(18,4)", "timestamp"):
        assert PT.parse_type(name).np_dtype == RT.parse_type(name).np_dtype


@pytest.mark.parametrize("seed", [0, 1])
def test_to_host_matches_device_get(seed):
    # one packed copy must give back every tensor as jax.device_get does,
    # whatever the mix of element sizes, shapes and empties
    import jax

    rng = np.random.default_rng(seed)
    arrays = [
        rng.random(5) < 0.5,
        rng.integers(-9, 9, 7).astype(np.int32),
        rng.integers(-2**40, 2**40, (3, 2)).astype(np.int64),
        np.asarray(rng.standard_normal(), np.float64),
        np.zeros(0, np.int64),
        rng.standard_normal(6).astype(np.float32),
        rng.random(3) < 0.5,
    ]
    if seed:
        arrays.reverse()
    want = jax.device_get([jnp.asarray(a) for a in arrays])
    got = port_page.to_host([torch.from_numpy(np.asarray(a)) for a in arrays])
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == torch.from_numpy(np.asarray(w)).dtype
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert port_page.to_host([]) == []
