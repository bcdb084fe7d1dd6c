"""The port's query fuzzer and SQLite verifier (``presto_tpu_torch/fuzz.py``
and ``verifier.py``) against the reference's on the CPU.

- The generator is pure Python: both packages' ``generate_query`` and
  ``session_draw`` give the same text for seeds 0-1,999.
- The oracle: both ``render_sqlite`` give the same sqlite text, and both
  ``SqliteOracle("tiny")`` the same rows, on 40 seeds (their tpch
  loaders are separate copies: ``DictColumn`` ids and dates must decode
  to the same strings).
- ``diff_results`` gives the same verdict, and the same report, on
  equal, reordered and perturbed row sets.
- The port's ``run_fuzz`` and ``run_fuzz_distributed`` on the CPU report
  no failure, and ``verify_offload`` finds a CPU runner equal to itself.
"""

from __future__ import annotations

import datetime

import pytest

from presto_tpu import fuzz as ref_fuzz
from presto_tpu import verifier as ref_verifier
from presto_tpu.sql import parse_statement as ref_parse
from presto_tpu.sql.grouping_sets import desugar_tree as ref_desugar
from presto_tpu_torch import fuzz, verifier
from presto_tpu_torch.exec.local_runner import LocalQueryRunner
from presto_tpu_torch.session import Session
from presto_tpu_torch.sql import parse_statement
from presto_tpu_torch.sql.grouping_sets import desugar_tree
from torch_parity import one_torch_thread  # noqa: F401

#: seeds whose SQL both oracles run (array seeds have no sqlite dialect)
ORACLE_SEEDS = [s for s in range(48) if "array[" not in ref_fuzz.generate_query(s)][:40]
FUZZ_SEEDS = list(range(30))
STREAM_ROWS = 8_192
#: seeds that raise ``StreamingError`` under STREAM_ROWS in both
#: packages (lineitem joined to orders joined to customer)
NO_CUT_SEEDS = [738, 1335, 1961]


@pytest.mark.parametrize("block", range(20))
def test_generator_text_equals_the_reference(block):
    for seed in range(block * 100, block * 100 + 100):
        assert fuzz.generate_query(seed) == ref_fuzz.generate_query(seed), seed
        assert fuzz.session_draw(seed) == ref_fuzz.session_draw(seed), seed


def test_generator_registries_equal_the_reference():
    assert fuzz._AGGS == ref_fuzz._AGGS
    assert fuzz._registry_funcs() == ref_fuzz._registry_funcs()


@pytest.fixture(scope="module")
def oracles():
    return ref_verifier.SqliteOracle("tiny"), verifier.SqliteOracle("tiny")


@pytest.mark.parametrize("seed", ORACLE_SEEDS)
def test_oracle_rows_and_rendering_equal_the_reference(oracles, seed):
    sql = fuzz.generate_query(seed)
    want_text = ref_verifier.render_sqlite(ref_desugar(ref_parse(sql)))
    assert verifier.render_sqlite(desugar_tree(parse_statement(sql))) == want_text
    ref, port = oracles
    assert port.execute(sql) == ref.execute(sql)


def test_oracle_tables_equal_the_reference(oracles):
    """Every loaded table, row for row: strings of dictionary columns,
    ISO dates and REAL decimals."""
    ref, port = oracles
    for table in ("lineitem", "orders", "customer", "nation"):
        sql = f"select * from {table} order by 1, 2, 3"
        assert port.execute(sql) == ref.execute(sql), table


def test_oracle_tpcds_catalog_equals_the_reference():
    ref = ref_verifier.SqliteOracle("tiny", catalog="tpcds")
    port = verifier.SqliteOracle("tiny", catalog="tpcds")
    sql = (
        "select d_year, count(*) as n, min(d_date) as lo from date_dim "
        "group by d_year order by d_year"
    )
    assert port.execute(sql) == ref.execute(sql)
    with pytest.raises(KeyError):
        verifier.SqliteOracle("tiny", catalog="nope")


ROWS = [(1, "a", 1.5, None), (2, "b", 2.25, datetime.date(2020, 1, 2)),
        (3, None, -0.5, datetime.date(1992, 1, 1))]
DIFF_CASES = {
    "equal": (ROWS, ROWS, True),
    "reordered_unordered": (ROWS[::-1], ROWS, False),
    "reordered_ordered": (ROWS[::-1], ROWS, True),
    "double_within_tol": ([(1, "a", 1.5 * (1 + 1e-8), None)] + ROWS[1:], ROWS, True),
    "double_off": ([(1, "a", 1.6, None)] + ROWS[1:], ROWS, True),
    "string_off": ([(1, "z", 1.5, None)] + ROWS[1:], ROWS, True),
    "null_vs_value": ([(1, "a", 1.5, 0)] + ROWS[1:], ROWS, True),
    "row_missing": (ROWS[:2], ROWS, False),
    "bool_as_int": ([(True,)], [(1,)], True),
}


@pytest.mark.parametrize("case", sorted(DIFF_CASES))
def test_diff_results_verdict_equals_the_reference(case):
    ours, oracle, ordered = DIFF_CASES[case]
    want = ref_verifier.diff_results(ours, oracle, ordered)
    assert verifier.diff_results(ours, oracle, ordered) == want
    agree = ("equal", "reordered_unordered", "double_within_tol", "bool_as_int")
    assert (want is None) == (case in agree)


@pytest.fixture(scope="module")
def port_runner():
    return LocalQueryRunner(device="cpu")


@pytest.mark.parametrize("seed", FUZZ_SEEDS)
def test_run_fuzz_on_the_cpu_reports_no_failure(port_runner, oracles, seed):
    assert fuzz.run_fuzz([seed], runner=port_runner, oracle=oracles[1]) == []


def test_run_fuzz_streamed_reports_only_the_known_no_cut_seeds(oracles):
    runner = LocalQueryRunner(
        device="cpu", session=Session(properties={"max_device_rows": STREAM_ROWS})
    )
    fails = fuzz.run_fuzz(
        NO_CUT_SEEDS + list(range(450, 456)), runner=runner, oracle=oracles[1]
    )
    assert [s for s, _, _ in fails] == NO_CUT_SEEDS
    assert all(
        d.startswith("StreamingError: fragment exceeds max_device_rows")
        for _, _, d in fails
    )


def test_run_fuzz_distributed_on_cpu_shards(oracles):
    assert fuzz.run_fuzz_distributed(
        range(8), oracle=oracles[1], devices=["cpu"] * 4
    ) == []


def test_verify_query_and_offload_on_the_cpu(port_runner, oracles):
    sql = (
        "select l_returnflag, sum(l_quantity) as q, avg(l_discount) as d "
        "from tpch.tiny.lineitem group by l_returnflag order by l_returnflag"
    )
    assert verifier.verify_query(port_runner, oracles[1], sql) is None
    assert verifier.verify_offload(sql, device="cpu") is None


def test_fuzz_cli_on_the_cpu(capsys, monkeypatch):
    monkeypatch.setattr(
        "sys.argv", ["fuzz", "--start", "3", "--count", "2", "--device", "cpu"]
    )
    fuzz.main()
    assert capsys.readouterr().out.strip().endswith("0 failures / 2 queries")
