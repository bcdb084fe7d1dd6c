"""The port's multi-device exchange (``presto_tpu_torch/parallel/exchange.py``)
and the device half of its in-slice lane, on the CPU, against the JAX
reference.

The same seeded pages go through the reference's collectives inside a
``shard_map`` over the 8 virtual CPU devices that ``tests/conftest.py``
forces and through the port's collectives over per-shard page lists on
``["cpu"] * 8``: every destination's rows equal, in order, the overflow
flags included (cf. ``tests/test_distributed.py``). ``bucket_dest``
equals the host wire's ``_bucket_of`` (the port's and the reference's)
and the reference's ``bucket_dest`` bit for bit over every key kind (cf.
``tests/test_ici_exchange.py``), and the single-program collective merge
gives pages bit-equal to the per-source ``device_merge`` and to the HTTP
wire's payload merge.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import shard_map
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from presto_tpu import types as RT
from presto_tpu.connectors.tpch import DictColumn as RefDictColumn
from presto_tpu.exec import streaming as RS
from presto_tpu.exec.staging import MaskedColumn as RefMasked
from presto_tpu.page import Block as RefBlock
from presto_tpu.page import Dictionary as RefDictionary
from presto_tpu.page import Page as RefPage
from presto_tpu.parallel import exchange as RX
from presto_tpu_torch import types as T
from presto_tpu_torch.connectors.tpch import DictColumn
from presto_tpu_torch.exec import streaming as S
from presto_tpu_torch.exec.staging import MaskedColumn, stage_page
from presto_tpu_torch.page import Block, Dictionary, Page
from presto_tpu_torch.parallel import exchange as X
from presto_tpu_torch.server import exchange_spi, pages_wire
from torch_parity import one_torch_thread  # noqa: F401

N = 8
CPU = torch.device("cpu")


def _mesh():
    assert len(jax.devices()) == N, "conftest must force 8 virtual devices"
    return Mesh(np.array(jax.devices()[:N]), ("workers",))


def _shards(seed: int, cap: int, with_nulls: bool):
    """Per-shard (keys, values, validity, live count) from a seed."""
    rng = np.random.default_rng(seed)
    keys = rng.integers(-1000, 1000, size=(N, cap)).astype(np.int64)
    vals = rng.normal(size=(N, cap))
    valid = rng.random((N, cap)) > 0.2 if with_nulls else None
    counts = rng.integers(0, cap + 1, size=N).astype(np.int32)
    return keys, vals, valid, counts


def _ref_stacked(keys, vals, valid, counts):
    return RefPage(
        blocks=(
            RefBlock(
                data=jnp.asarray(keys.reshape(-1)),
                valid=None if valid is None else jnp.asarray(valid.reshape(-1)),
                dtype=RT.BIGINT,
            ),
            RefBlock(data=jnp.asarray(vals.reshape(-1)), valid=None,
                     dtype=RT.DOUBLE),
        ),
        num_valid=jnp.asarray(counts),
        names=("k", "v"),
    )


def _port_shards(keys, vals, valid, counts):
    return [
        Page(
            blocks=(
                Block(
                    data=torch.from_numpy(keys[i].copy()),
                    valid=None if valid is None
                    else torch.from_numpy(valid[i].copy()),
                    dtype=T.BIGINT,
                ),
                Block(data=torch.from_numpy(vals[i].copy()), valid=None,
                      dtype=T.DOUBLE),
            ),
            num_valid=torch.tensor(int(counts[i]), dtype=torch.int32),
            names=("k", "v"),
        )
        for i in range(N)
    ]


def _ref_run(prog, page):
    fn = jax.jit(
        shard_map(prog, mesh=_mesh(), in_specs=(P("workers"),),
                  out_specs=P("workers"))
    )
    return fn(jax.device_put(page, NamedSharding(_mesh(), P("workers"))))


def _ref_rows(page, shard: int, cap: int):
    """Shard ``shard``'s live rows of a stacked reference output as
    (key, key valid, value) lists."""
    n = int(np.asarray(page.num_valid)[shard])
    k = np.asarray(page.blocks[0].data).reshape(N, cap)[shard][:n]
    kv = page.blocks[0].valid
    kv = (np.ones(n, bool) if kv is None
          else np.asarray(kv).reshape(N, cap)[shard][:n])
    v = np.asarray(page.blocks[1].data).reshape(N, cap)[shard][:n]
    return k[kv].tolist(), kv.tolist(), v.tolist()


def _port_rows(page: Page):
    n = int(page.num_valid)
    k = page.blocks[0].data[:n].numpy()
    kv = page.blocks[0].valid
    kv = np.ones(n, bool) if kv is None else kv[:n].numpy()
    return k[kv].tolist(), kv.tolist(), page.blocks[1].data[:n].numpy().tolist()


@pytest.mark.parametrize(
    "cap,bucket_cap,with_nulls",
    [(64, 64, False), (64, 64, True), (64, 8, False), (256, 16, True)],
    ids=["fits", "fits-nulls", "overflow", "overflow-nulls"],
)
def test_partition_exchange_matches_the_reference(cap, bucket_cap, with_nulls):
    """Every destination receives the reference's rows in the
    reference's order (source order, row order within a source), the
    surplus of an overflowed bucket dropped alike, and the same
    overflow flags."""
    keys, vals, valid, counts = _shards(7 + cap + bucket_cap, cap, with_nulls)

    def prog(page):
        local = dataclasses.replace(page, num_valid=page.num_valid[0])
        h = RX.partition_hash(local, ["k"])
        dest = (h % jnp.uint64(N)).astype(jnp.int32)
        out, ovf = RX.partition_exchange(local, dest, N, "workers", bucket_cap)
        return (
            dataclasses.replace(out, num_valid=out.num_valid.reshape(1)),
            ovf.reshape(1),
        )

    ref_out, ref_ovf = _ref_run(prog, _ref_stacked(keys, vals, valid, counts))
    pages = _port_shards(keys, vals, valid, counts)
    dests = [X.umod(X.partition_hash(p, ["k"]), N) for p in pages]
    out, ovf = X.partition_exchange(pages, dests, bucket_cap)
    assert [bool(o) for o in ovf] == np.asarray(ref_ovf).tolist()
    assert any(bool(o) for o in ovf) == (bucket_cap < cap // 4)
    for d in range(N):
        assert out[d].capacity == N * bucket_cap
        assert _port_rows(out[d]) == _ref_rows(ref_out, d, N * bucket_cap)


def test_partition_hash_and_umod_match_the_reference():
    """The int64 hash bits are the reference's uint64 bits, and the
    unsigned modulus over them is numpy's uint64 modulus."""
    keys, vals, valid, counts = _shards(3, 128, True)
    ref = _ref_stacked(keys, vals, valid, counts)
    ref_local = dataclasses.replace(ref, num_valid=ref.num_valid[0])
    ref_h = np.asarray(RX.partition_hash(ref_local, ["k", "v"]))
    port = Page(
        blocks=(
            Block(data=torch.from_numpy(keys.reshape(-1).copy()),
                  valid=torch.from_numpy(valid.reshape(-1).copy()),
                  dtype=T.BIGINT),
            Block(data=torch.from_numpy(vals.reshape(-1).copy()), valid=None,
                  dtype=T.DOUBLE),
        ),
        num_valid=torch.tensor(int(counts[0]), dtype=torch.int32),
        names=("k", "v"),
    )
    h = X.partition_hash(port, ["k", "v"])
    assert np.array_equal(h.numpy().view(np.uint64), ref_h)
    for n in (1, 3, 7, 8, 64, 1000003):
        assert np.array_equal(
            X.umod(h, n).numpy(), (ref_h % np.uint64(n)).astype(np.int64)
        ), n


@pytest.mark.parametrize("with_nulls", [False, True])
def test_replicate_and_gather_match_the_reference(with_nulls):
    """REPLICATE: every shard holds the reference's concatenation in
    shard order; GATHER: the shards' live prefixes concatenated, as the
    reference's ``gather_stacked`` gives them."""
    cap = 16
    keys, vals, valid, counts = _shards(11, cap, with_nulls)

    def prog(page):
        local = dataclasses.replace(page, num_valid=page.num_valid[0])
        out = RX.replicate(local, N, "workers")
        return dataclasses.replace(out, num_valid=out.num_valid.reshape(1))

    ref = _ref_run(prog, _ref_stacked(keys, vals, valid, counts))
    pages = _port_shards(keys, vals, valid, counts)
    out = X.replicate(pages)
    for d in range(N):
        assert out[d].capacity == N * cap
        assert _port_rows(out[d]) == _ref_rows(ref, d, N * cap)
    ref_g = RX.gather_stacked(
        _ref_stacked(keys, vals, valid, counts), jnp.asarray(counts), cap,
        False,
    )
    got = X.gather_stacked(pages, counts.tolist(), False, CPU)
    assert got.capacity == ref_g.capacity == N * cap
    n = int(ref_g.num_valid)
    assert int(got.num_valid) == n
    for rb, pb in zip(ref_g.blocks, got.blocks):
        np.testing.assert_array_equal(pb.data[:n].numpy(),
                                      np.asarray(rb.data)[:n])
    one = X.gather_stacked(pages, counts.tolist(), True, CPU)
    assert int(one.num_valid) == counts[0]


# ------------------------------------------------ device == host hash


def _hash_inputs(seed: int = 7, n: int = 900, cap: int = 1024):
    rng = np.random.default_rng(seed)
    ints = rng.integers(-5000, 5000, n).astype(np.int64)
    flts = rng.normal(size=n)
    flts[::7] = 0.0
    flts[::11] = -0.0  # -0.0 must hash like +0.0
    vals = np.array(sorted({"a", "bb", "ccc", "dddd", "e"}), object)
    ids = rng.integers(0, len(vals), n).astype(np.int32)
    valid = rng.random(n) > 0.15  # NULLs hash to one bucket
    limbs = rng.integers(-2 ** 40, 2 ** 40, size=(n, 2)).astype(np.int64)

    def pad(a, tail=()):
        out = np.zeros((cap,) + tail, a.dtype)
        out[:n] = a
        return out

    return n, cap, ints, flts, vals, ids, valid, limbs, pad


#: key kind -> (column names in the pages below)
KEY_KINDS = {
    "int": ("k",),
    "double": ("f",),
    "dictionary": ("s",),
    "null": ("m",),
    "long_decimal": ("d",),
    "all": ("k", "f", "s", "m", "d"),
}


@pytest.mark.parametrize("kind", sorted(KEY_KINDS))
def test_bucket_dest_equals_the_host_wire_hash(kind):
    """THE correctness contract of the in-slice lane: the port's device
    ``bucket_dest`` places every row where the port's host
    ``_bucket_of``, the reference's ``_bucket_of`` and the reference's
    ``bucket_dest`` place it, for every key kind."""
    n, cap, ints, flts, vals, ids, valid, limbs, pad = _hash_inputs()
    keys = list(KEY_KINDS[kind])
    payload = {
        "k": ints,
        "f": flts,
        "s": DictColumn(ids=ids, values=vals),
        "m": MaskedColumn(data=ints.copy(), valid=valid),
        "d": limbs,
    }
    ref_payload = {
        "k": ints,
        "f": flts,
        "s": RefDictColumn(ids=ids, values=vals),
        "m": RefMasked(data=ints.copy(), valid=valid),
        "d": limbs,
    }
    for nb in (2, 7, 64):
        host = S._bucket_of(payload, keys, n, nb)
        ref_host = RS._bucket_of(ref_payload, keys, n, nb)
        np.testing.assert_array_equal(host, ref_host)

        dic = Dictionary(vals)
        page = Page(
            blocks=(
                Block(data=torch.from_numpy(pad(ints)), valid=None,
                      dtype=T.BIGINT),
                Block(data=torch.from_numpy(pad(flts)), valid=None,
                      dtype=T.DOUBLE),
                Block(data=torch.from_numpy(pad(ids)), valid=None,
                      dtype=T.VARCHAR, dictionary=dic),
                Block(data=torch.from_numpy(pad(ints)),
                      valid=torch.from_numpy(pad(valid)), dtype=T.BIGINT),
                Block(data=torch.from_numpy(pad(limbs, (2,))), valid=None,
                      dtype=T.decimal(30, 2)),
            ),
            num_valid=torch.tensor(n, dtype=torch.int32),
            names=("k", "f", "s", "m", "d"),
        )
        crc = {"s": X.wire_crc_table(dic, CPU)}
        dest_t = X.bucket_dest(page, crc, nb, keys)
        dest = dest_t.numpy()[:n]
        np.testing.assert_array_equal(dest, host)

        rdic = RefDictionary(vals)
        rpage = RefPage(
            blocks=(
                RefBlock(data=jnp.asarray(pad(ints)), valid=None,
                         dtype=RT.BIGINT),
                RefBlock(data=jnp.asarray(pad(flts)), valid=None,
                         dtype=RT.DOUBLE),
                RefBlock(data=jnp.asarray(pad(ids)), valid=None,
                         dtype=RT.VARCHAR, dictionary=rdic),
                RefBlock(data=jnp.asarray(pad(ints)),
                         valid=jnp.asarray(pad(valid)), dtype=RT.BIGINT),
                RefBlock(data=jnp.asarray(pad(limbs, (2,))), valid=None,
                         dtype=RT.decimal(30, 2)),
            ),
            num_valid=jnp.asarray(n, jnp.int32),
            names=("k", "f", "s", "m", "d"),
        )
        rdest = RX.bucket_dest(
            RX.strip_dictionaries(rpage), {"s": RX.wire_crc_table(rdic)},
            jnp.asarray(nb), tuple(keys),
        )
        np.testing.assert_array_equal(dest, np.asarray(rdest)[:n])
        counts = X.ici_partition_counts(page, dest_t)
        assert int(counts[:nb].sum()) == n and int(counts[nb:].sum()) == 0


# ------------------------------------------------ collective == per source


def _producer_batches(seed: int, nparts: int):
    """Three producer batches over a (string, nullable bigint, double)
    schema; each batch has its own string dictionary (so the merge
    takes the union with remaps), two share one."""
    rng = np.random.default_rng(seed)
    words = ["ant", "bee", "cat", "dog", "eel", "fox", "gnu"]
    schema = {"s": T.VARCHAR, "k": T.BIGINT, "x": T.DOUBLE}
    shared = np.array(sorted(words[:4]), object)
    batches = []
    for b, n in enumerate((700, 0, 1500)):
        vals = shared if b < 2 else np.array(sorted(words[2:]), object)
        payload = {
            "s": DictColumn(
                ids=rng.integers(0, len(vals), n).astype(np.int32),
                values=vals,
            ),
            "k": MaskedColumn(
                data=rng.integers(0, 50, n).astype(np.int64),
                valid=rng.random(n) > 0.1,
            ),
            "x": rng.normal(size=n),
        }
        page = stage_page(payload, schema, device=CPU)
        dest = X.bucket_dest(
            page, exchange_spi._crc_tables(page, ("k", "s")), nparts,
            ("k", "s"),
        )
        batches.append((page, dest, payload, n))
    return schema, batches


def _page_eq(a: Page, b: Page) -> None:
    assert a.names == b.names and a.capacity == b.capacity
    assert int(a.num_valid) == int(b.num_valid)
    for x, y in zip(a.blocks, b.blocks):
        assert torch.equal(x.data, y.data)
        assert (x.valid is None) == (y.valid is None)
        if x.valid is not None:
            assert torch.equal(x.valid, y.valid)
        assert (x.dictionary is None) == (y.dictionary is None)
        if x.dictionary is not None:
            assert list(x.dictionary.values) == list(y.dictionary.values)


@pytest.mark.parametrize("nparts", [2, 5])
def test_collective_merge_pages_equal_device_merge_and_the_wire(nparts):
    """The single-program collective merge gives, per partition, the
    page ``device_merge`` gives (data, validity, union dictionary,
    capacity and count bit for bit), and both equal the HTTP wire's
    ``merge_payloads`` + ``stage_page`` over the same rows."""
    schema, batches = _producer_batches(5 + nparts, nparts)
    by_source = [[(p, d)] for p, d, _, _ in batches[:2]] + [
        [(batches[2][0], batches[2][1])]
    ]
    srcs = ("t.0", "t.1", "t.2")
    stages0 = exchange_spi.REGISTRY.counter("exchange.collective_stages").total
    for part in range(nparts):
        got = exchange_spi.collective_merge(
            "cpu-test", srcs, by_source, part, schema, nparts, CPU
        )
        want = exchange_spi.device_merge(by_source, part, schema, CPU)
        assert got is not None and want is not None
        _page_eq(got[0], want[0])
        assert got[1] == want[1]
        payloads = []
        for page, dest, payload, n in batches:
            mask = dest.numpy()[:n] == part
            if mask.any():
                payloads.append(
                    (S._slice_payload(payload, schema, mask), schema,
                     int(mask.sum()))
                )
        wire = stage_page(pages_wire.merge_payloads(payloads, schema), schema,
                          device=CPU)
        _page_eq(got[0], wire)
    # one routing pass served every partition of the stage
    assert (
        exchange_spi.REGISTRY.counter("exchange.collective_stages").total
        == stages0 + 1
    )
    assert exchange_spi.COLLECTIVE.stats()["entries"] == 0
