"""The benchmark's TPC-H Q18 configuration (``tpch_sf10_q18``) on the CPU
at a tiny cut: its generator (``benchmark/gen/tpch_q18.py``) against a
direct computation, the port's runner against the plain reference
(``benchmark/reference/q18.py``), and the comparison that decides
``correct`` against planted faults."""

from __future__ import annotations

import copy
import datetime
import decimal
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmark import compare, harness, layout, params  # noqa: E402
from benchmark.gen import tpch, tpch_q18  # noqa: E402
from torch_parity import one_torch_thread  # noqa: E402,F401

#: the tiny cut: 15,000 orders, 60,000 lines, 1,500 customers
SF = 0.01
SEED = 2**31 + 1822
CPU = torch.device("cpu")
#: QUANTITY values the tiny cut answers (the benchmark's 312..315 leave
#: no order below SF 1): 200 leaves about 600 orders, more than the
#: LIMIT; 250 about 60; 280 a handful
QUANTITIES = ("200", "250", "280")


def tiny_config(name: str, sf: float = SF) -> dict:
    cfg = copy.deepcopy(layout.config(name))
    cfg["scale_factor"] = sf
    for t, n in tpch.row_counts(sf).items():
        if t in cfg["tables"]:
            cfg["tables"][t]["rows"] = n
    return cfg


@pytest.fixture(scope="module")
def cut():
    """(configuration, generated tables, the port's runner over them)."""
    cfg = tiny_config("tpch_sf10_q18")
    tables = layout.generator(cfg).generate(cfg, SEED, CPU)
    runner = harness.build_runner(cfg, SEED, CPU, lambda msg: None)
    return cfg, tables, runner


def _q18(runner, quantity: str):
    sql = params.render(layout.query_sql("q18"), {"QUANTITY": quantity})
    return runner.execute(sql).exact_rows()


# ------------------------------------------------------------ generator


def test_names_and_total_prices_match_a_direct_computation(cut):
    cfg, tables, _ = cut
    c, o = tables["customer"], tables["orders"]
    keys = c["c_custkey"].tolist()
    assert list(c["c_name"].values) == sorted(c["c_name"].values)
    for row in range(0, len(keys), 7):
        assert c["c_name"].values[int(c["c_name"].ids[row])] == (
            f"Customer#{keys[row]:09d}")
    # every order's lines, as tpch_sf10 draws them for the same seed
    li = tpch._lineitem(SEED, tpch.row_counts(SF), {}, [
        "l_orderkey", "l_extendedprice", "l_discount", "l_tax"], CPU)
    lines = {}
    for ok, ext, disc, tax in zip(*(li[k].tolist() for k in (
            "l_orderkey", "l_extendedprice", "l_discount", "l_tax"))):
        lines.setdefault(ok, []).append((ext, disc, tax))
    checked = 0
    for row in range(0, len(o["o_orderkey"]), 50):
        want = sum(ext * (100 - disc) // 100 * (100 + tax) // 100
                   for ext, disc, tax in lines[int(o["o_orderkey"][row])])
        assert int(o["o_totalprice"][row]) == want
        checked += 1
    assert checked >= 300


def test_shared_columns_are_those_of_tpch_sf10_for_the_same_seed(cut):
    cfg, tables, _ = cut
    base_cfg = tiny_config("tpch_sf10")
    base = layout.generator(base_cfg).generate(base_cfg, SEED, CPU)
    for t, spec in cfg["tables"].items():
        for col in spec["columns"]:
            if col in base_cfg["tables"][t]["columns"]:
                assert torch.equal(tables[t][col], base[t][col]), (t, col)


def test_rows_of_the_full_size_configuration():
    cfg = layout.config("tpch_sf10_q18")
    counts = tpch.row_counts(cfg["scale_factor"])
    assert {t: s["rows"] for t, s in cfg["tables"].items()} == {
        t: counts[t] for t in ("customer", "orders", "lineitem")}
    assert cfg["reduced"] == ["scale_factor"]
    assert cfg["reduced_from"] == {"scale_factor": 100}
    assert cfg["session"]["max_device_rows"] == 2 ** 26
    assert tpch_q18.order_index(
        tpch.orderkey(torch.arange(100_000))).tolist() == list(range(100_000))


# ---------------------------------------------------- port vs reference


@pytest.mark.parametrize("quantity", QUANTITIES)
def test_port_matches_the_reference(cut, quantity):
    _, tables, runner = cut
    want = layout.reference("q18").answer(tables, {"QUANTITY": quantity})
    got = _q18(runner, quantity)
    assert want.rows, quantity
    one = compare.compare_one(want, got)
    assert one == {"wrong": 0, "exact_gap": 0.0, "float_rel_gap": 0.0}, (
        quantity, got[:3], want.rows[:3])
    assert runner.overflow_retries == 0


def test_the_limit_cuts_and_the_sums_pass_the_having(cut):
    _, tables, runner = cut
    want = layout.reference("q18").answer(tables, {"QUANTITY": "200"})
    assert len(want.rows) == 100
    assert all(r[5] > 200 for r in want.rows)
    totals = [(-r[4], r[3]) for r in want.rows]
    assert totals == sorted(totals)


@pytest.mark.parametrize("quantity", ("312", "315"))
def test_the_benchmark_pool_runs_empty_at_the_tiny_cut(cut, quantity):
    _, tables, runner = cut
    want = layout.reference("q18").answer(tables, {"QUANTITY": quantity})
    assert want.rows == [] and _q18(runner, quantity) == []


def test_the_pool_takes_each_quantity_once():
    cfg = layout.config("tpch_sf10_q18")
    mix = layout.mix("q18")
    pool = params.draw_pool(SEED, "q18", layout.query_meta("q18"), cfg,
                            mix["pool"])
    assert sorted(p["QUANTITY"] for p in pool) == ["312", "313", "314", "315"]
    assert layout.query_meta("q18")["scans"] == {
        "lineitem": 2, "orders": 1, "customer": 1}


# ---------------------------------------------------- planted faults


@pytest.fixture(scope="module")
def answer(cut):
    _, tables, runner = cut
    want = layout.reference("q18").answer(tables, {"QUANTITY": "250"})
    return want, _q18(runner, "250")


def _replace(rows, i, col, value):
    rows = list(rows)
    row = list(rows[i])
    row[col] = value
    rows[i] = tuple(row)
    return rows


def test_a_cent_off_one_total_price_fails(answer):
    want, got = answer
    cent = decimal.Decimal("0.01")
    one = compare.compare_one(want, _replace(got, 3, 4, got[3][4] + cent))
    assert one["exact_gap"] == 1.0
    assert not compare.passed({**_clean(), "exact_gap": one["exact_gap"]})


def test_a_wrong_name_fails(answer):
    want, got = answer
    assert compare.compare_one(
        want, _replace(got, 0, 0, "Customer#999999999"))["wrong"] == 1


def test_a_row_dropped_before_the_limit_fails(answer, cut, monkeypatch):
    from benchmark.reference import q18

    want, got = answer
    assert compare.compare_one(want, got[:5] + got[6:])["wrong"] == 1
    # at QUANTITY 200 the limit cuts: the 101st row in place of a
    # dropped one is wrong unless it ties with the 100th
    _, tables, runner = cut
    full = layout.reference("q18").answer(tables, {"QUANTITY": "200"})
    top = _q18(runner, "200")
    assert compare.compare_one(full, top)["wrong"] == 0
    monkeypatch.setattr(q18, "LIMIT", 10 ** 9)  # every qualifying order
    every = q18.answer(tables, {"QUANTITY": "200"}).rows
    extra = [r for r in every if r not in full.rows and r not in full.ties][0]
    as_got = (extra[0], extra[1], extra[2],
              datetime.date(1970, 1, 1) + datetime.timedelta(extra[3]),
              extra[4], extra[5])
    assert compare.compare_one(full, top[:40] + top[41:] + [as_got])[
        "wrong"] == 1


@pytest.mark.parametrize("quantity", ("200", "250"))
def test_the_reference_in_float32_is_not_correct(cut, quantity):
    # the control: o_totalprice above 2^24 cents rounds in float32
    _, tables, _ = cut
    ref = layout.reference("q18")
    exact = ref.answer(tables, {"QUANTITY": quantity})
    low = ref.answer(tables, {"QUANTITY": quantity}, "float32")
    r = compare.readings([(exact, low.rows)], attempted=1, failed=0)
    assert r["exact_gap"] > 0 and not compare.passed(r), r


def test_a_tied_row_may_stand_in_for_the_last():
    from benchmark.reference.common import Answer

    rows = [("Customer#%09d" % k, k, k, 9000, decimal.Decimal(1000 - k), 1)
            for k in range(1, 101)]
    tie = ("Customer#000000999", 999, 999, 9000, rows[-1][4], 1)
    want = Answer(rows=rows, key_cols=(2,), sort_cols=(4, 3), ties=[tie])
    assert compare.compare_one(want, rows[:99] + [tie])["wrong"] == 0
    assert compare.compare_one(want, rows[1:] + [tie])["wrong"] == 1


def _clean():
    return {"wrong_answers": 0, "exact_gap": 0.0, "float_rel_gap": 0.0,
            "failed": 0, "unchecked": 0}

