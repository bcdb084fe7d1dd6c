"""Each plain reference agrees with the port's CPU runner on the same
generated columns, for every parameter set of a pool."""

import pytest
import torch

from bench_tiny import TINY, tiny_config
from benchmark import compare, harness, layout, params


def _cases():
    bench = layout.benchmark()
    for cell in TINY:
        w = layout.workload(bench, cell)
        for q in layout.mix(w["traffic"])["queries"]:
            yield cell, q


@pytest.mark.parametrize("cell,query", list(_cases()))
def test_reference_matches_cpu_runner(cell, query):
    w = layout.workload(layout.benchmark(), cell)
    cfg = tiny_config(w["config"], TINY[cell])
    dev = torch.device("cpu")
    seed = 2**31 + 99
    runner = harness.build_runner(cfg, seed, dev, lambda msg: None)
    tables = layout.generator(cfg).generate(cfg, seed, dev)
    ref = layout.reference(query)
    sql = layout.query_sql(query)
    nonempty = 0
    for p in params.draw_pool(seed, query, layout.query_meta(query), cfg, 4):
        want = ref.answer(tables, p)
        got = runner.execute(params.render(sql, p)).exact_rows()
        one = compare.compare_one(want, got)
        assert one["wrong"] == 0 and one["exact_gap"] == 0, (p, got, want.rows)
        assert one["float_rel_gap"] <= compare.LIMITS["float_rel_gap"]
        nonempty += any(v not in (None, 0) for v in want.rows[0]) if want.rows else 0
    assert nonempty > 0, "every answer of the pool is empty"


def test_q3_tie_at_the_limit():
    from benchmark.reference.common import Answer

    want = Answer(rows=[(k, 10 - k, 1, 0) for k in range(10)], key_cols=(0,),
                  sort_cols=(1, 2), ties=[(99, 1, 1, 0)])
    swapped = want.rows[:9] + [(99, 1, 1, 0)]
    assert compare.compare_one(want, swapped)["wrong"] == 0
    assert compare.compare_one(want, want.rows[::-1])["wrong"] == 1
    assert compare.compare_one(want, want.rows[:9])["wrong"] == 1


def test_gaps_in_units_of_the_last_digit():
    from decimal import Decimal

    from benchmark.reference.common import Answer

    want = Answer(rows=[("A", Decimal("10.0000"), 0.5, 3)], key_cols=(0,))
    got = [("A", Decimal("10.0003"), 0.5 * (1 + 1e-9), 3)]
    one = compare.compare_one(want, got)
    assert one["exact_gap"] == 3.0
    assert one["float_rel_gap"] == pytest.approx(1e-9, rel=1e-6)
    assert compare.compare_one(want, [("A", None, 0.5, 3)])["wrong"] == 1
