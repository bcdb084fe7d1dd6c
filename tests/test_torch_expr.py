"""Parity of the port's expression lowering (presto_tpu_torch.expr) with
the reference's ``ExprLowerer`` over the same seeded page."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from presto_tpu import expr as RE
from presto_tpu import types as RT
from presto_tpu_torch import expr as PE
from presto_tpu_torch import types as PT
from torch_parity import both_pages
from torch_parity import one_torch_thread  # noqa: F401

CAP = 96
LIVE = 90


def _columns(seed: int = 0):
    rng = np.random.default_rng(seed)
    flags = np.asarray(["A", "N", "R"], object)
    modes = np.asarray(["AIR", "MAIL", "SHIP"], object)
    return {
        "l_quantity": (rng.integers(100, 5001, CAP).astype(np.int64), None,
                       "decimal(12,2)", None),
        "l_extendedprice": (rng.integers(90000, 10**7, CAP).astype(np.int64),
                            None, "decimal(12,2)", None),
        "l_discount": (rng.integers(0, 11, CAP).astype(np.int64), None,
                       "decimal(12,2)", None),
        "l_tax": (rng.integers(0, 9, CAP).astype(np.int64), None,
                  "decimal(12,2)", None),
        "l_shipdate": (rng.integers(-800, 10600, CAP).astype(np.int32), None,
                       "date", None),
        "l_returnflag": (rng.integers(0, 3, CAP).astype(np.int32), None,
                         "varchar", flags),
        "mode": (rng.integers(0, 3, CAP).astype(np.int32),
                 rng.random(CAP) < 0.8, "varchar", modes),
        "i": (rng.integers(-50, 50, CAP).astype(np.int64),
              rng.random(CAP) < 0.75, "bigint", None),
        "j": (rng.integers(-7, 8, CAP).astype(np.int64), None, "bigint", None),
        "k": (rng.integers(-1000, 1000, CAP).astype(np.int32), None,
              "integer", None),
        "d": (rng.integers(-10**6, 10**6, CAP).astype(np.int64),
              rng.random(CAP) < 0.8, "decimal(12,2)", None),
        "f": (rng.standard_normal(CAP) * 100, rng.random(CAP) < 0.9,
              "double", None),
        "p": (rng.random(CAP) < 0.5, rng.random(CAP) < 0.7, "boolean", None),
        "q": (rng.random(CAP) < 0.5, rng.random(CAP) < 0.7, "boolean", None),
        **_more_columns(seed),
    }


NAMES = np.asarray(
    ["PROMO BRASS", "almond green", "forest green", "forest", "ivory",
     "medium polished tin", "special requests", "", "Customer Complaints"],
    object,
)


def _more_columns(seed: int):
    """The columns of the dictionary, date, math and hash cases (their
    own generator, so the columns above keep their values)."""
    rng = np.random.default_rng(seed + 1)
    # month ends on both sides of the epoch (leap Februaries included)
    ends = np.asarray([
        np.datetime64(f"{y}-{m:02d}", "M") + 1 for y in (1900, 1960, 1969,
                                                          2000, 2023, 2024)
        for m in range(1, 13)
    ]).astype("datetime64[D]").astype(np.int64) - 1
    g = rng.standard_normal(CAP) * 3
    g[:6] = [0.0, -0.0, np.nan, -1.5, 2.5, np.inf]
    return {
        "name": (rng.integers(0, len(NAMES), CAP).astype(np.int32),
                 rng.random(CAP) < 0.85, "varchar", NAMES),
        "me": (rng.choice(ends, CAP).astype(np.int32), rng.random(CAP) < 0.9,
               "date", None),
        "ts": (rng.integers(-(10**15), 2 * 10**15, CAP).astype(np.int64),
               rng.random(CAP) < 0.9, "timestamp", None),
        "g": (g, rng.random(CAP) < 0.9, "double", None),
    }


def _col(E, T, name):
    return E.ColumnRef(name, T.parse_type(_columns()[name][2]))


def _dict_cases(E, T):
    """LIKE and the dictionary functions: host LUTs gathered on the
    device, over columns with NULLs and dead rows."""
    c = lambda n: _col(E, T, n)  # noqa: E731
    fn = E.dict_transform_fn
    sub2 = E.DictTransform(c("name"), "substring:1:2", fn("substring:1:2"))
    ym = 'date_format:["%Y-%m"]'
    cat = 'concat2:["<", "|", ">"]'
    return {
        "like_prefix": E.Like(c("mode"), "A%"),
        "like_infix": E.Like(c("name"), "%green%"),
        "like_two_parts": E.Like(c("name"), "%special%requests%"),
        "like_underscore_negate": E.Like(c("name"), "_o%", negate=True),
        "like_empty_string": E.Like(c("name"), ""),
        "dictpredicate": E.DictPredicate(
            c("name"), 'starts_with:["f"]', fn('starts_with:["f"]')
        ),
        "dicttransform_substring": sub2,
        "dicttransform_upper": E.DictTransform(c("mode"), "lower",
                                               fn("lower")),
        "dicttransform_eq": E.Compare("=", sub2, E.Literal("fo", T.VARCHAR)),
        "dicttransform_in": E.InList(
            sub2, (E.Literal("fo", T.VARCHAR), E.Literal("iv", T.VARCHAR),
                   E.Literal("zz", T.VARCHAR)),
        ),
        "dicttransform_of_transform": E.DictTransform(
            sub2, "upper", fn("upper")
        ),
        "dictcombine": E.DictCombine(c("mode"), c("l_returnflag"), cat,
                                     fn(cat)),
        "inttodict": E.IntToDict(c("l_shipdate"), ym, -800, 10600, fn(ym)),
        "inttodict_like": E.Like(
            E.IntToDict(c("me"), ym, -30000, 20000, fn(ym)), "19%"
        ),
        "dictintfunc_length": E.DictIntFunc(c("name"), "length",
                                            fn("length")),
        "dictintfunc_strpos": E.DictIntFunc(
            c("name"), 'strpos:["e"]', fn('strpos:["e"]')
        ),
    }


EXTRACT_FIELDS = ("year", "month", "day", "quarter", "dow", "doy", "week")


def _date_cases(E, T):
    """EXTRACT of every field, date_trunc of every unit and date_add over
    month ends, negative epoch days and timestamps."""
    c = lambda n: _col(E, T, n)  # noqa: E731
    out = {}
    for f in EXTRACT_FIELDS:
        out[f"extract_{f}"] = E.Extract(f, c("l_shipdate"))
        out[f"extract_{f}_ts"] = E.Extract(f, c("ts"))
    out["extract_literal"] = E.Extract("year", E.Literal(-1, T.DATE))
    for unit in ("day", "week", "month", "quarter", "year"):
        out[f"trunc_{unit}"] = E.DateTrunc(unit, c("me"))
        out[f"trunc_{unit}_ts"] = E.DateTrunc(unit, c("ts"))
    for unit in ("hour", "minute", "second"):
        out[f"trunc_{unit}_ts"] = E.DateTrunc(unit, c("ts"))
    for unit in ("day", "week", "month", "year"):
        out[f"add_{unit}"] = E.DateAdd(unit, c("j"), c("me"))
        out[f"add_{unit}_ts"] = E.DateAdd(unit, c("j"), c("ts"))
    out["add_month_nullable_n"] = E.DateAdd("month", c("i"), c("l_shipdate"))
    out["add_literal_year"] = E.DateAdd(
        "year", E.Literal(-3, T.BIGINT), c("me")
    )
    return out


MATH1 = ("sqrt", "ln", "log2", "log10", "exp", "floor", "ceil", "round",
         "truncate", "cbrt", "sin", "cos", "tan", "asin", "acos", "atan",
         "degrees", "radians", "sinh", "cosh", "tanh", "abs", "sign")


def _math_cases(E, T):
    """Scalar math over doubles (with -0.0, NaN and inf), decimals and
    integers, the two-argument functions, and ValueHash."""
    c = lambda n: _col(E, T, n)  # noqa: E731
    out = {f"math_{f}": E.MathFunc(f, c("g")) for f in MATH1}
    for f in ("abs", "sign", "round", "truncate", "floor", "ceil", "sqrt"):
        out[f"math_{f}_dec"] = E.MathFunc(f, c("d"))
        out[f"math_{f}_int"] = E.MathFunc(f, c("i"))
    out["math_exp_dec"] = E.MathFunc("exp", c("l_discount"))
    out["math2_power"] = E.MathFunc2("power", c("g"), c("j"))
    out["math2_atan2"] = E.MathFunc2("atan2", c("g"), c("d"))
    out["math2_log"] = E.MathFunc2("log", c("k"), c("f"))
    out["math2_round_double"] = E.MathFunc2("round", c("f"), c("j"))
    out["math2_round_dec"] = E.MathFunc2(
        "round", c("d"), E.Literal(1, T.BIGINT)
    )
    out["math2_truncate_dec"] = E.MathFunc2(
        "truncate", c("d"), E.Literal(1, T.BIGINT)
    )
    out["math2_round_int"] = E.MathFunc2(
        "round", c("k"), E.Literal(-2, T.BIGINT)
    )
    for n in ("i", "g", "f", "d", "mode", "p", "l_shipdate", "ts", "k"):
        out[f"valuehash_{n}"] = E.ValueHash(c(n))
    return out


def _cases(E, T):
    """The same expression trees, built from either package's IR."""
    c = lambda n: _col(E, T, n)  # noqa: E731
    lit = E.Literal
    dec2 = T.decimal(3, 2)
    one = lit(1, T.BIGINT)
    disc_price = E.arith("*", c("l_extendedprice"),
                         E.arith("-", one, c("l_discount")))
    return {
        # TPC-H Q1 / Q6
        "q1_filter": E.Compare("<=", c("l_shipdate"), lit(10471, T.DATE)),
        "q1_disc_price": disc_price,
        "q1_charge": E.arith("*", disc_price,
                             E.arith("+", one, c("l_tax"))),
        "q6_filter": E.And((
            E.Compare(">=", c("l_shipdate"), lit(8766, T.DATE)),
            E.Compare("<", c("l_shipdate"), lit(9131, T.DATE)),
            E.Between(c("l_discount"), lit(5, dec2), lit(7, dec2)),
            E.Compare("<", c("l_quantity"), lit(24, T.BIGINT)),
        )),
        "q6_revenue": E.arith("*", c("l_extendedprice"), c("l_discount")),
        "avg_finisher": E.Arithmetic(
            "/", E.Cast(c("d"), T.DOUBLE), E.Cast(c("j"), T.DOUBLE), T.DOUBLE
        ),
        # decimals: rescale half-up away from zero, casts, mixed types
        "rescale_down": E.Cast(c("d"), T.decimal(12, 0)),
        "rescale_down_1": E.Cast(c("d"), T.decimal(12, 1)),
        "rescale_up": E.Cast(c("d"), T.decimal(15, 4)),
        "dec_to_bigint": E.Cast(c("d"), T.BIGINT),
        "dec_to_double": E.Cast(c("d"), T.DOUBLE),
        "double_to_dec": E.Cast(c("f"), T.decimal(12, 2)),
        "int_to_dec": E.Cast(c("k"), T.decimal(12, 3)),
        "dec_plus_dec": E.arith("+", c("d"), c("l_tax")),
        "dec_minus_int": E.arith("-", c("d"), c("j")),
        "dec_times_int": E.arith("*", c("d"), c("j")),
        "dec_div": E.arith("/", c("d"), c("l_discount")),
        "dec_lt_double": E.Compare("<", c("d"), c("f")),
        "dec_eq_lit": E.Compare("=", c("l_discount"), lit(6, dec2)),
        # integer arithmetic on negatives and zero divisors
        "int_div": E.arith("/", c("i"), c("j")),
        "int_mod": E.arith("%", c("i"), c("j")),
        "int_mixed": E.arith("+", c("k"), c("i")),
        "negate": E.Negate(c("i")),
        "double_div": E.arith("/", c("f"), E.Cast(c("j"), T.DOUBLE)),
        # dates
        "date_between": E.Between(c("l_shipdate"), lit(0, T.DATE),
                                  lit(9000, T.DATE)),
        "date_not_between": E.Between(c("l_shipdate"), lit(-100, T.DATE),
                                      lit(100, T.DATE), negate=True),
        # strings against literals (present and absent)
        "str_eq": E.Compare("=", c("l_returnflag"), lit("R", T.VARCHAR)),
        "str_ne_absent": E.Compare("<>", c("l_returnflag"), lit("B", T.VARCHAR)),
        "str_lt": E.Compare("<", c("l_returnflag"), lit("N", T.VARCHAR)),
        "str_ge_absent": E.Compare(">=", c("l_returnflag"), lit("M", T.VARCHAR)),
        "str_flip": E.Compare(">", lit("N", T.VARCHAR), c("mode")),
        "str_cross_dict": E.Compare("<", c("l_returnflag"), c("mode")),
        # three-valued logic and nulls
        "and3": E.And((c("p"), c("q"))),
        "or3": E.Or((c("p"), c("q"), E.Compare(">", c("i"), lit(0, T.BIGINT)))),
        "not3": E.Not(c("p")),
        "is_null": E.IsNull(c("i")),
        "is_not_null": E.IsNull(c("d"), negate=True),
        "is_null_free": E.IsNull(c("j")),
        "null_lit": lit(None, T.BIGINT),
        "null_cmp": E.Compare("=", c("i"), lit(None, T.BIGINT)),
        "coalesce": E.Coalesce((c("i"), c("j")), T.BIGINT),
        "coalesce_lit": E.Coalesce((c("d"), lit(0, T.BIGINT)), T.decimal(12, 2)),
        "coalesce_str": E.Coalesce((c("mode"), c("l_returnflag")), T.VARCHAR),
        "case": E.Case(
            ((E.Compare(">", c("i"), lit(10, T.BIGINT)), c("j")),
             (c("p"), lit(-1, T.BIGINT))),
            None, T.BIGINT,
        ),
        "case_default": E.Case(
            ((E.Compare("<", c("f"), lit(0.0, T.DOUBLE)), c("d")),),
            c("l_tax"), T.decimal(12, 2),
        ),
        "case_str": E.Case(
            ((c("q"), c("mode")),), c("l_returnflag"), T.VARCHAR,
        ),
        "literal_bool": lit(True, T.BOOLEAN),
        **_dict_cases(E, T),
        **_date_cases(E, T),
        **_math_cases(E, T),
    }


CASES = sorted(_cases(PE, PT))


def _as_numpy(data, valid, cap, to_np):
    data = np.broadcast_to(to_np(data), (cap,))
    valid = (
        np.ones(cap, bool)
        if valid is None
        else np.broadcast_to(to_np(valid), (cap,))
    )
    return data, valid


@pytest.mark.parametrize("name", CASES)
def test_lowering_matches_reference(name):
    ref_page, port_page = both_pages(_columns(), LIVE)
    ref_e = _cases(RE, RT)[name]
    port_e = _cases(PE, PT)[name]
    ref_low = RE.ExprLowerer(ref_page)
    port_low = PE.ExprLowerer(port_page)
    rd, rv = ref_low.eval(ref_e)
    pd, pv = port_low.eval(port_e)
    assert (rv is None) == (pv is None), name
    rd, rv = _as_numpy(rd, rv, CAP, np.asarray)
    pd, pv = _as_numpy(pd, pv, CAP, lambda t: t.numpy())
    assert pd.dtype == rd.dtype, (name, pd.dtype, rd.dtype)
    np.testing.assert_array_equal(pv, rv, err_msg=name)
    if np.issubdtype(rd.dtype, np.floating):
        np.testing.assert_allclose(pd[rv], rd[rv], rtol=1e-12, atol=0)
    else:
        np.testing.assert_array_equal(pd[rv], rd[rv], err_msg=name)
    if port_e.dtype.is_string:
        assert list(port_low.dictionary_of(port_e).values) == list(
            ref_low.dictionary_of(ref_e).values
        )


@pytest.mark.parametrize("name", ["q1_filter", "q6_filter", "or3", "str_eq"])
def test_eval_predicate_matches_reference(name):
    ref_page, port_page = both_pages(_columns(), LIVE)
    want = np.asarray(RE.eval_predicate(_cases(RE, RT)[name], ref_page))
    got = PE.eval_predicate(_cases(PE, PT)[name], port_page)
    assert got.dtype == torch.bool
    np.testing.assert_array_equal(got.numpy(), want)
    assert not got.numpy()[LIVE:].any()  # padding rows never pass


def test_civil_date_math_matches_reference():
    days = np.arange(-200_000, 200_000, 37, dtype=np.int64)
    import jax.numpy as jnp

    want = RE._civil_from_days(jnp.asarray(days))
    got = PE._civil_from_days(torch.from_numpy(days))
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    back = PE._days_from_civil(*got)
    np.testing.assert_array_equal(back.numpy(), days)


def test_unported_node_raises_with_its_name():
    """The nested lowerings and long decimals are ported: an array
    operation over a flat column raises in both packages, with the
    column's name, and a long-decimal literal lowers to the reference's
    limb pair."""
    ref_page, port_page = both_pages(_columns(), LIVE)
    for E, T, page in ((RE, RT, ref_page), (PE, PT, port_page)):
        e = E.ArrayLength(_col(E, T, "i"))
        with pytest.raises(
            NotImplementedError, match="i is not a physical array column"
        ):
            E.ExprLowerer(page).eval(e)
    want, _ = RE.ExprLowerer(ref_page).eval(
        RE.Literal(-(10**20) - 7, RT.decimal(38, 2))
    )
    got, valid = PE.ExprLowerer(port_page).eval(
        PE.Literal(-(10**20) - 7, PT.decimal(38, 2))
    )
    assert valid is None
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
