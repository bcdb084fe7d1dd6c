"""EXPLAIN and EXPLAIN ANALYZE through the port's ``LocalQueryRunner``
(``presto_tpu_torch/exec/explain.py``), against the JAX reference on the
CPU.

EXPLAIN's text must equal the reference's string for string for the 22
TPC-H queries and TPC-DS Q64/Q95 at tiny; EXPLAIN ANALYZE's per-node
lines (rows, estimate, provenance, error factor and capacity) too, all
but the closing wall-time line. The documented deviations are named
where they apply:

- a ``DictTransform`` predicate prints its function object in the
  reference, whose address differs from process to process (Q22), and
  its ``fn_key`` only in the port: the port's text must equal the
  reference's with that object taken out, and hold no address;
- the port prunes columns under a cross join and the reference does not
  (ROADMAP §3; Q95): each line's node kind and its annotation must
  agree, not the scan and projection column lists;
- the port cuts a planned join fan-out over 2^20 rows to the bucket of
  the exact output count (``ops/join.py::_expand``, ROADMAP §3; Q64's
  (item, ticket) join): the capacity of that join and of the nodes
  above it in the same run may be smaller; their rows must agree.
"""

from __future__ import annotations

import functools
import re

import pytest

from presto_tpu.exec.local_runner import LocalQueryRunner as RefRunner
from presto_tpu_torch import queries_tpcds
from presto_tpu_torch.exec.local_runner import LocalQueryRunner
from tpch_queries import QUERIES
from torch_parity import one_torch_thread  # noqa: F401

CASES = {f"q{k}": v for k, v in QUERIES.items()}
CASES["tpcds_q64"] = queries_tpcds.Q64
CASES["tpcds_q95"] = queries_tpcds.Q95

_ADDR = re.compile(r" at 0x[0-9a-f]+")
#: the closure a reference ``DictTransform`` prints beside its fn_key
_FN = re.compile(r", fn=<function \S+ at 0x[0-9a-f]+>")
_ANNOT = re.compile(r"^(?P<indent> *)- (?P<label>.*?)(?:  \[(?P<annot>[^\]]*)\])?$")
_CAP = re.compile(r", capacity: (\d+)\]?$")


@pytest.fixture(scope="module")
def texts():
    ref, port = RefRunner(), LocalQueryRunner(device="cpu")

    @functools.lru_cache(maxsize=None)
    def run(which: str, sql: str):
        if which == "ref":
            return tuple(_FN.sub("", row[0]) for row in ref.execute(sql).rows())
        out = tuple(row[0] for row in port.execute(sql).rows())
        assert not any(_ADDR.search(x) for x in out)
        return out

    return run


def _parse(line: str):
    m = _ANNOT.match(line)
    assert m, line
    return len(m.group("indent")), m.group("label"), m.group("annot") or ""


def _kind(label: str) -> str:
    return label.split("[", 1)[0]


def _fanout_cut_lines(lines) -> set:
    """Indices of each join planned over 2^20 rows (``cap=N`` in its
    label) and of its ancestors: the lines whose capacity the port's
    fan-out cut may shrink."""
    parsed = [_parse(x) for x in lines]
    out = set()
    for j, (ind, label, _) in enumerate(parsed):
        m = re.search(r"Join\[.* cap=(\d+)\]", label)
        if not m or int(m.group(1)) <= 1 << 20:
            continue
        out.add(j)
        need = ind
        for i in range(j - 1, -1, -1):
            if parsed[i][0] < need:
                out.add(i)
                need = parsed[i][0]
    return out


def _assert_lines_equal(name, ref_lines, port_lines):
    assert len(ref_lines) == len(port_lines), name
    cut = (
        _fanout_cut_lines(ref_lines) if name == "tpcds_q64" else set()
    )
    for i, (a, b) in enumerate(zip(ref_lines, port_lines)):
        if name == "tpcds_q95":
            # cross-join pruning: column lists differ, nothing else
            (ia, la, xa), (ib, lb, xb) = _parse(a), _parse(b)
            assert (ia, _kind(la), xa) == (ib, _kind(lb), xb), (a, b)
        elif i in cut and _CAP.search(a):
            (ia, la, xa), (ib, lb, xb) = _parse(a), _parse(b)
            assert (ia, la) == (ib, lb), (a, b)
            assert _CAP.sub("", xa) == _CAP.sub("", xb), (a, b)
            ca, cb = int(_CAP.search(xa).group(1)), int(_CAP.search(xb).group(1))
            assert cb <= ca, (a, b)
        else:
            assert a == b, (a, b)


@pytest.mark.parametrize("name", sorted(CASES))
def test_explain_text_equals_the_reference(texts, name):
    sql = "explain " + CASES[name]
    ref_lines, port_lines = texts("ref", sql), texts("port", sql)
    assert any("est rows:" in x for x in port_lines)
    _assert_lines_equal(name, ref_lines, port_lines)


@pytest.mark.parametrize("name", sorted(CASES))
def test_explain_analyze_rows_and_capacities_equal_the_reference(texts, name):
    sql = "explain analyze " + CASES[name]
    ref_lines, port_lines = texts("ref", sql), texts("port", sql)
    # the last line is the run's wall time; the blank line before it
    assert port_lines[-1].startswith("EXPLAIN ANALYZE: ")
    assert port_lines[-1].split(" rows in ")[0] == ref_lines[-1].split(" rows in ")[0]
    plan_ref, plan_port = ref_lines[:-2], port_lines[:-2]
    assert all("[rows: " in x for x in plan_port), plan_port
    _assert_lines_equal(name, plan_ref, plan_port)


def test_explain_analyze_annotates_the_host_root_stage(texts):
    """Q1's ORDER BY and Output run on the host (``host_root_stage``):
    they carry their row counts and no capacity."""
    lines = texts("port", "explain analyze " + QUERIES[1])
    host = [x for x in lines if "host root stage" in x]
    assert [_kind(_parse(x)[1]) for x in host] == ["Output", "Sort"]
    assert all("[rows: 4, host root stage]" in x for x in host)


def test_a_repeated_explain_analyze_keeps_its_annotations():
    """A second EXPLAIN ANALYZE of the same SQL reads its tables from the
    split cache and annotates the same nodes with the same counts."""
    r = LocalQueryRunner(device="cpu")
    sql = "explain analyze " + QUERIES[3]
    first = [row[0] for row in r.execute(sql).rows()]
    hits = r.split_cache.stats()["hits"]
    second = [row[0] for row in r.execute(sql).rows()]
    assert r.split_cache.stats()["hits"] > hits
    assert first[:-1] == second[:-1]
    assert sum("[rows: " in x for x in second) == len(second) - 2


@pytest.mark.parametrize(
    "sql, budget",
    [
        # the system tables are never cached
        ("select * from system.runtime.queries", None),
        # lineitem's page is larger than the cache budget
        ("select count(*) from tpch.tiny.lineitem", 100_000),
    ],
    ids=["system_table", "over_budget"],
)
def test_explain_analyze_releases_what_it_reserved(sql, budget):
    """EXPLAIN ANALYZE's run reserves the pages the split cache does not
    keep under a query of its own and releases them after, so a pooled
    runner's reservations come back to where they were. The reference
    runs it with no query, so each run leaves those bytes reserved under
    "adhoc" (ROADMAP §3)."""
    from presto_tpu.utils import memory as ref_memory
    from presto_tpu_torch.utils import memory as port_memory

    port_pool = port_memory.MemoryPool(1 << 30)
    ref_pool = ref_memory.MemoryPool(1 << 30)
    r = LocalQueryRunner(device="cpu", memory_pool=port_pool,
                         staging_cache_bytes=budget)
    ref = RefRunner(memory_pool=ref_pool, staging_cache_bytes=budget)
    base = port_pool.snapshot()["reserved"]
    leaked = []
    for _ in range(2):
        lines = [row[0] for row in r.execute("explain analyze " + sql).rows()]
        ref.execute("explain analyze " + sql)
        assert lines[-1].startswith("EXPLAIN ANALYZE: ")
        assert port_pool.snapshot()["reserved"] == base
        assert not [o for o in port_pool.snapshot()["used"]
                    if o != "table-cache"]
        leaked.append(ref_pool.used_bytes("adhoc"))
    assert leaked[0] > 0 and leaked[1] == 2 * leaked[0]
    assert r.history.snapshot() == []
