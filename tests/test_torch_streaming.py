"""The port's streamed execution (``presto_tpu_torch/exec/streaming.py``)
against the JAX reference's, at tpch.tiny on the CPU.

Both packages run the same SQL under the reference's own streaming
budgets (tests/test_streaming.py): ``max_device_rows`` 16,384 with
``page_capacity`` 4,096, so lineitem (~60k rows) streams in batches with
spill buckets, and the "tight" 8,192 budget, under which orders (15,000
rows) is oversized too and joins that build on it take the partitioned
build-side spill. The module parts are held one by one: the bucket hash
bit for bit, the stage cut, the payload merge and the prefetch iterator.
Each reference query runs once per module."""

from __future__ import annotations

import functools

import numpy as np
import pytest

from presto_tpu.connectors.tpch import DictColumn as RefDictColumn
from presto_tpu.exec import local_runner as ref_local_runner
from presto_tpu.exec import staging as ref_staging
from presto_tpu.exec import streaming as ref_streaming
from presto_tpu.exec.host_ops import peel_host_ops as ref_peel
from presto_tpu.exec.local_runner import LocalQueryRunner as RefRunner
from presto_tpu.parallel.fragmenter import insert_gathers as ref_gathers
from presto_tpu.plan import nodes as RN
from presto_tpu.plan.optimizer import prune_columns as ref_prune
from presto_tpu.plan.optimizer import push_scan_constraints as ref_push
from presto_tpu.plan.planner import plan_statement as ref_plan
from presto_tpu.server import pages_wire as ref_wire
from presto_tpu.server.scheduler import plan_stage as ref_plan_stage
from presto_tpu.session import Session as RefSession
from presto_tpu.sql import parse_statement as ref_parse
from presto_tpu_torch import convert
from presto_tpu_torch.connectors.tpch import DictColumn
from presto_tpu_torch.exec import local_runner, staging, streaming
from presto_tpu_torch.exec.host_ops import peel_host_ops
from presto_tpu_torch.exec.local_runner import LocalQueryRunner
from presto_tpu_torch.parallel.fragmenter import insert_gathers
from presto_tpu_torch.plan import nodes as N
from presto_tpu_torch.plan.optimizer import prune_columns, push_scan_constraints
from presto_tpu_torch.plan.planner import plan_statement
from presto_tpu_torch.server import pages_wire
from presto_tpu_torch.server.scheduler import plan_stage
from presto_tpu_torch.session import Session
from presto_tpu_torch.sql import parse_statement
from test_streaming import NON_AGG_STREAMED
from tpch_queries import QUERIES
from torch_parity import assert_columns_equal, jax_live_columns

MAX_DEVICE_ROWS = 16_384
BATCH_ROWS = 4_096
TIGHT_ROWS = 8_192

#: Q18's HAVING keeps no order at tiny (the largest per-order sum is
#: 293.00), so it also runs at 250
Q18_250 = QUERIES[18].replace("> 300", "> 250")
assert Q18_250 != QUERIES[18]

#: the join build-side spills of tests/test_streaming.py (tight budget)
SPILLS = {
    "spill_semi": (
        "select count(*) as c from tpch.tiny.customer "
        "where c_custkey in (select o_custkey from tpch.tiny.orders "
        "where o_totalprice > 100000)"
    ),
    "spill_anti": (
        "select count(*) as c from tpch.tiny.customer "
        "where c_custkey not in (select o_custkey from tpch.tiny.orders "
        "where o_totalprice > 150000)"
    ),
    "spill_left_payload": (
        "select count(*) as c, sum(o_totalprice) as s "
        "from tpch.tiny.customer left join tpch.tiny.orders "
        "on c_custkey = o_custkey"
    ),
}

#: name -> (sql, budget)
CASES = {
    **{f"q{q}": (QUERIES[q], MAX_DEVICE_ROWS) for q in (1, 3, 5, 9, 18)},
    "q18_250": (Q18_250, MAX_DEVICE_ROWS),
    "q18_250_tight": (Q18_250, TIGHT_ROWS),
    **{k: (v, MAX_DEVICE_ROWS) for k, v in NON_AGG_STREAMED.items()},
    **{k: (v, TIGHT_ROWS) for k, v in SPILLS.items()},
}


def _props(budget):
    return {
        "max_device_rows": budget,
        "page_capacity": BATCH_ROWS,
        "spill_enabled": True,
    }


@pytest.fixture(scope="module")
def reference():
    runners = {
        b: RefRunner(session=RefSession(properties=_props(b)))
        for b in (MAX_DEVICE_ROWS, TIGHT_ROWS)
    }

    @functools.lru_cache(maxsize=None)
    def run(name):
        sql, budget = CASES[name]
        res = runners[budget].execute(sql)
        return res.columns, jax_live_columns(res.page)

    return run


@pytest.fixture(scope="module")
def ports():
    out = {
        b: LocalQueryRunner(device="cpu", session=Session(properties=_props(b)))
        for b in (MAX_DEVICE_ROWS, TIGHT_ROWS)
    }
    out["whole"] = LocalQueryRunner(device="cpu")
    return out


@pytest.fixture(scope="module")
def port_results(ports):
    @functools.lru_cache(maxsize=None)
    def run(name, whole=False):
        sql, budget = CASES[name]
        runner = ports["whole" if whole else budget]
        before = runner.stream_stats.batches
        res = runner.execute(sql)
        return res, runner.stream_stats.batches - before

    return run


@pytest.mark.parametrize("name", sorted(CASES))
def test_streamed_matches_reference(reference, port_results, name):
    ref_columns, ref_cols = reference(name)
    port, batches = port_results(name)
    assert batches > 0, f"{name} did not stream"
    assert port.columns == ref_columns
    assert_columns_equal(ref_cols, convert.page_to_numpy(port.page))


@pytest.mark.parametrize("name", sorted(CASES))
def test_streamed_matches_unstreamed(port_results, name):
    # integers, decimals, dates and strings exactly; doubles within rel
    # 1e-9 (a streamed DOUBLE sum adds in another order). An empty
    # streamed result carries no dictionary, as the reference's does
    streamed, _ = port_results(name)
    whole, batches = port_results(name, whole=True)
    assert batches == 0
    assert streamed.columns == whole.columns
    want = convert.page_to_numpy(whole.page)
    got = convert.page_to_numpy(streamed.page)
    if int(whole.page.num_valid) == 0:
        want = {k: c[:3] + (None,) for k, c in want.items()}
        got = {k: c[:3] + (None,) for k, c in got.items()}
    assert_columns_equal(want, got, rtol=1e-9)


def test_q18_250_keeps_orders_and_partitioned_join_runs(port_results):
    res, _ = port_results("q18_250")
    assert int(res.page.num_valid) > 0
    # under the tight budget orders is oversized too: both sides of the
    # lineitem-orders join stream into buckets (batches of both tables)
    _, batches = port_results("q18_250_tight")
    assert batches > -(-60_000 // BATCH_ROWS) + -(-15_000 // BATCH_ROWS)


def test_prefetch_depth_does_not_change_results():
    results = []
    for depth in (0, 2):
        props = {**_props(MAX_DEVICE_ROWS), "staging_prefetch_depth": depth}
        r = LocalQueryRunner(device="cpu", session=Session(properties=props))
        results.append(convert.page_to_numpy(r.execute(QUERIES[1]).page))
        assert r.stream_stats.batches > 0
    a, b = results
    assert list(a) == list(b)
    for name in a:
        assert a[name][0].tobytes() == b[name][0].tobytes(), name


def test_streaming_actually_engaged(monkeypatch):
    calls = []
    orig = streaming._spill_partial

    def spy(*a, **k):
        calls.append(1)
        return orig(*a, **k)

    monkeypatch.setattr(streaming, "_spill_partial", spy)
    r = LocalQueryRunner(
        device="cpu", session=Session(properties=_props(MAX_DEVICE_ROWS))
    )
    r.execute(
        "select l_returnflag, sum(l_quantity) as s "
        "from tpch.tiny.lineitem group by l_returnflag"
    )
    assert len(calls) >= 10, f"expected >= 10 streamed batches, {len(calls)}"
    assert r.stream_stats.batches == len(calls)
    assert r.stream_stats.buckets > 0 and r.stream_stats.spilled_rows > 0


def test_spill_disabled_raises_streaming_error():
    r = LocalQueryRunner(
        device="cpu",
        session=Session(
            properties={"max_device_rows": MAX_DEVICE_ROWS, "spill_enabled": False}
        ),
    )
    with pytest.raises(streaming.StreamingError):
        r.execute("select count(*) as c from tpch.tiny.lineitem")


def test_split_cache_raises_not_implemented():
    r = LocalQueryRunner(
        device="cpu",
        session=Session(
            properties={**_props(MAX_DEVICE_ROWS), "stream_split_cache": True}
        ),
    )
    with pytest.raises(NotImplementedError, match="SplitCache"):
        r.execute("select count(*) as c from tpch.tiny.lineitem")


def test_whole_tables_still_stage_whole():
    r = LocalQueryRunner(device="cpu")
    r.execute(QUERIES[1])
    assert r.stream_stats == streaming.StreamStats()


# ------------------------------------------------------- bucket hashing


def _payloads(seed, n=5_000):
    """The same seeded columns in both packages' payload classes: int32
    and int64 keys, doubles with -0.0/+0.0/NaN, a masked (NULL) column,
    and a string column."""
    rng = np.random.default_rng(seed)
    i32 = rng.integers(-(2**31), 2**31 - 1, n).astype(np.int32)
    i64 = rng.integers(-(2**62), 2**62, n, dtype=np.int64)
    f = rng.standard_normal(n) * 1e6
    f[::7] = -0.0
    f[1::7] = 0.0
    f[2::11] = np.nan
    valid = rng.random(n) < 0.7
    words = np.asarray(sorted({f"w{i:05d}" for i in rng.integers(0, 900, 300)}),
                       dtype=object)
    ids = rng.integers(0, len(words), n).astype(np.int32)
    out = []
    for Dict_, Masked in ((RefDictColumn, ref_staging.MaskedColumn),
                          (DictColumn, staging.MaskedColumn)):
        out.append({
            "i32": i32.copy(), "i64": i64.copy(), "f": f.copy(),
            "m": Masked(data=i64.copy(), valid=valid.copy()),
            "s": Dict_(ids=ids.copy(), values=words.copy()),
            "ms": Masked(data=ids.astype(np.int64), valid=valid.copy(),
                         values=tuple(words)),
        })
    return out


@pytest.mark.parametrize("keys", [["i32"], ["i64"], ["f"], ["m"], ["s"],
                                  ["ms"], ["s", "i32", "f"], ["m", "ms"]])
@pytest.mark.parametrize("n_buckets", [1, 7, 64])
def test_bucket_of_is_bit_equal_to_the_reference(keys, n_buckets):
    ref, port = _payloads(len(keys) * 100 + n_buckets)
    want = ref_streaming._bucket_of(ref, keys, 4_999, n_buckets)
    got = streaming._bucket_of(port, keys, 4_999, n_buckets)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    # a second call takes the cached crc image: same buckets
    np.testing.assert_array_equal(
        streaming._bucket_of(port, keys, 4_999, n_buckets), want
    )


def test_bucket_hash_stable_across_dictionaries():
    # the same value under two dictionaries (ids in another order)
    vals = [["apple", "banana"], ["aardvark", "apple"]]
    ids = [[0, 1], [1, 0]]
    got = [
        streaming._bucket_of(
            {"k": DictColumn(ids=np.array(i, np.int32),
                             values=np.array(v, object))},
            ["k"], 2, 64,
        )
        for v, i in zip(vals, ids)
    ]
    want = [
        ref_streaming._bucket_of(
            {"k": RefDictColumn(ids=np.array(i, np.int32),
                                values=np.array(v, object))},
            ["k"], 2, 64,
        )
        for v, i in zip(vals, ids)
    ]
    assert got[0][0] == got[1][0]  # "apple" agrees across id spaces
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_spill_buckets_equal_the_references():
    ref, port = _payloads(5)
    schema = {k: None for k in ref}
    want = [[] for _ in range(16)]
    ref_streaming._spill_partial(want, ref, schema, ["s", "i64"], 4_000, 16)
    got = [[] for _ in range(16)]
    streaming._spill_partial(
        got, port, schema, ["s", "i64"], 4_000, 16, streaming.StreamStats()
    )
    for gb, wb in zip(got, want):
        assert len(gb) == len(wb)
        for (gp, _, gn), (wp, _, wn) in zip(gb, wb):
            assert gn == wn
            for k in schema:
                g, w = gp[k], wp[k]
                for attr in ("ids", "data", "valid"):
                    if hasattr(w, attr):
                        np.testing.assert_array_equal(
                            getattr(g, attr), getattr(w, attr)
                        )
                if isinstance(w, np.ndarray):
                    assert g.tobytes() == w.tobytes()


# ----------------------------------------------------------- stage cut


def _fragments(sql, ref: bool):
    """The distributable fragments of a query's device plan."""
    if ref:
        runner = RefRunner()
        plan = ref_plan(ref_parse(sql), runner.catalogs, runner.session)
        root, _ = ref_peel(ref_push(ref_prune(plan.root)))
        froot, nodes = ref_gathers(root), RN
    else:
        runner = LocalQueryRunner(device="cpu")
        plan = plan_statement(parse_statement(sql), runner.catalogs,
                              runner.session)
        root, _ = peel_host_ops(push_scan_constraints(prune_columns(plan.root)))
        froot, nodes = insert_gathers(root), N
    frags = [n.fragment_root for n in nodes.walk(froot)
             if isinstance(n, nodes.RemoteSourceNode)]
    return runner.catalogs, frags


#: name -> (sql, replicated_limit)
STAGE_CASES = {
    "q1": (QUERIES[1], MAX_DEVICE_ROWS),
    "q18": (QUERIES[18], MAX_DEVICE_ROWS),
    "q18_unlimited": (QUERIES[18], None),
    # orders sits on the build side of a LEFT join, and replicating it
    # for a cut on customer is over the limit: no cut
    "non_distributive": (SPILLS["spill_left_payload"], TIGHT_ROWS),
}


@pytest.mark.parametrize("name", sorted(STAGE_CASES))
def test_plan_stage_cuts_like_the_reference(name):
    sql, limit = STAGE_CASES[name]
    ref_cats, ref_frags = _fragments(sql, ref=True)
    cats, frags = _fragments(sql, ref=False)
    assert len(frags) == len(ref_frags) > 0
    for f, rf in zip(frags, ref_frags):
        got = plan_stage(f, cats, replicated_limit=limit)
        want = ref_plan_stage(rf, ref_cats, replicated_limit=limit)
        assert repr(got) == repr(want)
        if name == "non_distributive":
            assert got is None
        else:
            assert got is not None


# -------------------------------------------------------- payload merge


def _merge_parts(same_dictionary: bool):
    """Three parts of a string column (one masked) and an int column,
    in both packages' payload classes."""
    rng = np.random.default_rng(3)
    dicts = [np.asarray(v, object) for v in
             (["b", "d", "f"], ["a", "d", "z"], ["c", "d"])]
    if same_dictionary:
        dicts = [dicts[0]] * 3
    ref, port = [], []
    for i, d in enumerate(dicts):
        n = 5 + i
        ids = rng.integers(0, len(d), n).astype(np.int32)
        ints = rng.integers(-100, 100, n)
        valid = rng.random(n) < 0.6
        if i == 1:
            ref.append(({"s": ref_staging.MaskedColumn(ids, valid, tuple(d)),
                         "x": ints}, None, n))
            port.append(({"s": staging.MaskedColumn(ids, valid, d),
                          "x": ints}, None, n))
        else:
            ref.append(({"s": RefDictColumn(ids, d), "x": ints}, None, n))
            port.append(({"s": DictColumn(ids, d), "x": ints}, None, n))
    return ref, port


def _assert_payload_columns_equal(got, want):
    assert set(got) == set(want)
    for k in want:
        g, w = got[k], want[k]
        assert type(g).__name__ == type(w).__name__, k
        if isinstance(w, np.ndarray):
            np.testing.assert_array_equal(g, w)
            continue
        np.testing.assert_array_equal(getattr(g, "ids", getattr(g, "data", None)),
                                      getattr(w, "ids", getattr(w, "data", None)))
        if hasattr(w, "valid"):
            np.testing.assert_array_equal(g.valid, w.valid)
        assert [str(v) for v in g.values] == [str(v) for v in w.values]


@pytest.mark.parametrize("same_dictionary", [False, True])
def test_merge_payloads_equals_the_references(same_dictionary):
    from presto_tpu import types as RT
    from presto_tpu_torch import types as PT

    ref, port = _merge_parts(same_dictionary)
    want = ref_wire.merge_payloads(ref, {"s": RT.VARCHAR, "x": RT.BIGINT})
    got = pages_wire.merge_payloads(port, {"s": PT.VARCHAR, "x": PT.BIGINT})
    _assert_payload_columns_equal(got, want)


@pytest.mark.parametrize("same_dictionary", [False, True])
def test_merge_split_payloads_equals_the_references(same_dictionary):
    # the repair: split payloads whose dictionaries differ used to raise
    ref, port = _merge_parts(same_dictionary)
    ref = [p for p, _, _ in ref if isinstance(p["s"], RefDictColumn)]
    port = [p for p, _, _ in port if isinstance(p["s"], DictColumn)]
    want = ref_local_runner._merge_split_payloads(ref, ["s", "x"])
    got = local_runner._merge_split_payloads(port, ["s", "x"])
    _assert_payload_columns_equal(got, want)
    if same_dictionary:
        assert got["s"].values is port[0]["s"].values


# ------------------------------------------------------------ prefetch


@pytest.mark.parametrize("depth", [0, 1, 2, 5])
def test_prefetch_iter_keeps_order(depth):
    got = list(staging.prefetch_iter(range(20), lambda i: i * i, depth))
    assert got == [i * i for i in range(20)]


@pytest.mark.parametrize("depth", [0, 2])
def test_prefetch_iter_raises_at_the_failing_iteration(depth):
    def load(i):
        if i == 3:
            raise ValueError("split 3")
        return i

    seen = []
    with pytest.raises(ValueError, match="split 3"):
        for item in staging.prefetch_iter(range(10), load, depth):
            seen.append(item)
    assert seen == [0, 1, 2]


def test_prefetch_iter_drops_unconsumed_items_on_close():
    dropped = []
    it = staging.prefetch_iter(range(10), lambda i: i, 2, on_drop=dropped.append)
    assert next(it) == 0
    it.close()
    assert all(d > 0 for d in dropped)


# ------------------------------------------------- grouped final merge


def _partial_payloads(sql, ref: bool, rows_per_split: int):
    """A query's stage cut, and its split step run over each split of
    the split scan, as (payload, schema, nrows) parts."""
    cats, frags = _fragments(sql, ref)
    stage = (ref_plan_stage if ref else plan_stage)(frags[0], cats)
    worker = stage.worker_fragment
    nodes = RN if ref else N
    scan = list(nodes.walk(worker))[stage.partition_scan]
    runner = RefRunner() if ref else LocalQueryRunner(device="cpu")
    mod = ref_streaming if ref else streaming
    payloads = []
    for lo in range(0, stage.partition_rows, rows_per_split):
        hi = min(lo + rows_per_split, stage.partition_rows)
        page = runner._load_split(scan, lo, hi, rows_per_split)
        out = runner._run_with_pages(worker, [scan], [page])
        payloads.append(mod._page_to_payload(out))
    return runner, stage, payloads


def test_grouped_final_merge_equals_the_references():
    # lineitem's per-split partial states over a budget they exceed:
    # merged one group-key bucket at a time
    sql = ("select l_orderkey, sum(l_quantity) as q, count(*) as c, "
           "max(l_extendedprice) as m from tpch.tiny.lineitem "
           "group by l_orderkey")
    out = []
    for ref in (True, False):
        runner, stage, payloads = _partial_payloads(sql, ref, BATCH_ROWS)
        schema = dict(stage.worker_fragment.output_schema())
        mod = ref_streaming if ref else streaming
        page = mod.grouped_final_merge(
            runner, payloads, schema, stage.final_root,
            stage.worker_fragment, TIGHT_ROWS,
        )
        if ref:
            out.append(jax_live_columns(page))
        else:
            assert runner.stream_stats.buckets > 1
            out.append(convert.page_to_numpy(page))
    assert_columns_equal(*out)
    assert len(out[1]["l_orderkey"][0]) == 15_000
