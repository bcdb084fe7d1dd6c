"""Scalar function registry.

Reference parity: ``FunctionAndTypeManager`` and the annotation-driven
builtin registry (``@ScalarFunction`` over hundreds of builtins —
SURVEY.md §2.1 "Function registry"). The reference registers a function
once and every layer (analyzer, planner, interpreter, codegen) resolves
it through the manager; here the analogous seam is a declarative table
``name -> ScalarFunction`` whose ``build`` lowers a call directly to the
engine's Expr IR (XLA is the codegen, so "registering" a function means
providing its typed Expr construction — no interpreter entry needed).

Adding a builtin touches ONLY this module: the planner resolves every
non-aggregate, non-window FuncCall here (plan/planner.py FuncCall
branch), and the fuzzer draws generatable functions from the same table
(``fuzz`` argument classes).

String functions follow the dictionary-LUT design (SURVEY.md §7
"Strings on TPU"): host-side evaluation over the (small) dictionary,
device-side int32/int64/bool LUT gathers — so string builtins require a
dictionary-backed argument and literal parameters, enforced here at
plan time.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Callable, Dict, List, Optional, Tuple

from presto_tpu_torch import expr as E
from presto_tpu_torch import types as T


class FunctionError(ValueError):
    """Raised for bad calls; the planner re-raises as PlanningError."""


@dataclasses.dataclass(frozen=True)
class ScalarFunction:
    """One registered scalar builtin."""

    name: str
    min_args: int
    max_args: int  # -1 = variadic
    build: Callable[[List[E.Expr]], E.Expr]
    description: str = ""
    #: fuzzer argument classes, each in {"num", "str", "date", "any",
    #: "bool"}; None = not fuzz-generatable (needs literal params etc.)
    fuzz: Optional[Tuple[str, ...]] = None


SCALAR: Dict[str, ScalarFunction] = {}


def _register(
    name: str,
    min_args: int,
    max_args: Optional[int] = None,
    description: str = "",
    fuzz: Optional[Tuple[str, ...]] = None,
):
    def deco(fn):
        SCALAR[name] = ScalarFunction(
            name=name,
            min_args=min_args,
            max_args=min_args if max_args is None else max_args,
            build=fn,
            description=description,
            fuzz=fuzz,
        )
        return fn

    return deco


def lower_scalar(name: str, args: List[E.Expr]) -> E.Expr:
    """Resolve + build a scalar call; FunctionError on unknown name or
    arity/type mismatch. The planner's single entry point."""
    fn = SCALAR.get(name)
    if fn is None:
        raise FunctionError(f"unknown function: {name}")
    n = len(args)
    if n < fn.min_args or (fn.max_args >= 0 and n > fn.max_args):
        want = (
            str(fn.min_args)
            if fn.min_args == fn.max_args
            else f"{fn.min_args}..{'*' if fn.max_args < 0 else fn.max_args}"
        )
        raise FunctionError(f"{name}() takes {want} arguments, got {n}")
    return fn.build(args)


# ------------------------------------------------------------- helpers


def _lit_str(e: E.Expr, what: str) -> str:
    if not isinstance(e, E.Literal) or not isinstance(e.value, str):
        raise FunctionError(f"{what} must be a string literal")
    return e.value


def _lit_int(e: E.Expr, what: str) -> int:
    if not isinstance(e, E.Literal) or e.value is None:
        raise FunctionError(f"{what} must be an integer literal")
    try:
        return int(e.value)
    except (TypeError, ValueError):
        raise FunctionError(
            f"{what} must be an integer literal, got {e.value!r}"
        ) from None


def _string_arg(e: E.Expr, fname: str) -> E.Expr:
    if not e.dtype.is_string:
        raise FunctionError(
            f"{fname}() requires a varchar argument, got {e.dtype}"
        )
    return e


def _numeric_arg(e: E.Expr, fname: str) -> E.Expr:
    t = e.dtype
    if not (t.is_integer or t.is_decimal or t.name in ("double", "real")):
        raise FunctionError(
            f"{fname}() requires a numeric argument, got {t}"
        )
    return e


def _date_arg(e: E.Expr, fname: str) -> E.Expr:
    if e.dtype.name not in ("date", "timestamp"):
        raise FunctionError(
            f"{fname}() requires a date/timestamp argument, got {e.dtype}"
        )
    return e


def _common_type(args: List[E.Expr]) -> T.DataType:
    ct = args[0].dtype
    for a in args[1:]:
        ct = T.common_super_type(ct, a.dtype)
    return ct


def _transform(arg: E.Expr, key: str) -> E.Expr:
    fn = E.dict_transform_fn(key)
    if isinstance(arg, E.Literal):  # constant fold
        v = None if arg.value is None else str(fn(str(arg.value)))
        return E.Literal(v, T.VARCHAR)
    return E.DictTransform(arg, key, fn)


def _int_func(arg: E.Expr, key: str) -> E.Expr:
    fn = E.dict_transform_fn(key)
    if isinstance(arg, E.Literal):
        v = None if arg.value is None else int(fn(str(arg.value)))
        return E.Literal(v, T.BIGINT)
    return E.DictIntFunc(arg, key, fn)


def _predicate(arg: E.Expr, key: str) -> E.Expr:
    fn = E.dict_transform_fn(key)
    if isinstance(arg, E.Literal):
        v = None if arg.value is None else bool(fn(str(arg.value)))
        return E.Literal(v, T.BOOLEAN)
    return E.DictPredicate(arg, key, fn)


def _math1(func: str):
    def build(args, _f=func):
        return E.MathFunc(_f, _numeric_arg(args[0], _f))

    return build


# ---------------------------------------------------------------- math

for _f in (
    "sqrt", "ln", "exp", "abs", "sign", "cbrt",
    "log2", "log10", "sin", "cos", "tan", "asin", "acos", "atan",
    "degrees", "radians", "sinh", "cosh", "tanh",
):
    _register(_f, 1, description=f"{_f}(x)", fuzz=("num",))(_math1(_f))


@_register(
    "width_bucket", 4,
    description="width_bucket(x, lo, hi, n) -> bucket in [0, n+1]; "
    "descending bounds (lo > hi) reverse the buckets like the "
    "reference; equal bounds -> NULL (deviation: the reference raises)",
)
def _width_bucket(args):
    x = _numeric_arg(args[0], "width_bucket")
    lo = _numeric_arg(args[1], "width_bucket")
    hi = _numeric_arg(args[2], "width_bucket")
    n_count = _lit_int(args[3], "width_bucket bucket count")
    if n_count < 1:
        raise FunctionError(
            f"width_bucket bucket count must be >= 1, got {n_count}"
        )
    xf = E.Cast(x, T.DOUBLE) if x.dtype != T.DOUBLE else x
    lof = E.Cast(lo, T.DOUBLE) if lo.dtype != T.DOUBLE else lo
    hif = E.Cast(hi, T.DOUBLE) if hi.dtype != T.DOUBLE else hi
    nf = _flit(n_count)
    over = E.Literal(n_count + 1, T.BIGINT)

    def bucket(span_from, span_to):
        # floor((x - from) / (to - from) * n) + 1
        span = _fsub(span_to, span_from)
        frac = _fdiv(_fsub(xf, span_from), span)
        return E.Arithmetic(
            "+",
            E.MathFunc("floor", _fmul(frac, nf)),
            E.Literal(1, T.BIGINT),
            T.BIGINT,
        )

    asc = E.Case(
        whens=(
            (E.Compare("<", xf, lof), E.Literal(0, T.BIGINT)),
            (E.Compare(">=", xf, hif), over),
        ),
        default=bucket(lof, hif),
        _dtype=T.BIGINT,
    )
    # descending bounds: buckets decrease from lo to hi, (hi, lo]-open
    desc = E.Case(
        whens=(
            (E.Compare(">", xf, lof), E.Literal(0, T.BIGINT)),
            (E.Compare("<=", xf, hif), over),
        ),
        default=bucket(lof, hif),
        _dtype=T.BIGINT,
    )
    return E.Case(
        whens=(
            (E.Compare("<", lof, hif), asc),
            (E.Compare(">", lof, hif), desc),
        ),
        default=E.Literal(None, T.BIGINT),
        _dtype=T.BIGINT,
    )


@_register("floor", 1, description="floor(x) -> bigint", fuzz=("num",))
def _floor(args):
    return E.MathFunc("floor", _numeric_arg(args[0], "floor"))


@_register("ceil", 1, description="ceil(x) -> bigint", fuzz=("num",))
@_register("ceiling", 1, description="alias of ceil")
def _ceil(args):
    return E.MathFunc("ceil", _numeric_arg(args[0], "ceil"))


@_register("round", 1, 2, description="round(x[, digits])", fuzz=("num",))
def _round(args):
    x = _numeric_arg(args[0], "round")
    if len(args) == 1:
        return E.MathFunc("round", x)
    return E.MathFunc2("round", x, _numeric_arg(args[1], "round"))


@_register("truncate", 1, 2, description="truncate(x[, digits])",
           fuzz=("num",))
def _truncate(args):
    x = _numeric_arg(args[0], "truncate")
    if len(args) == 1:
        return E.MathFunc("truncate", x)
    return E.MathFunc2("truncate", x, _numeric_arg(args[1], "truncate"))


@_register("power", 2, description="power(x, y)", fuzz=("num", "num"))
@_register("pow", 2, description="alias of power")
def _power(args):
    return E.MathFunc2(
        "power",
        _numeric_arg(args[0], "power"),
        _numeric_arg(args[1], "power"),
    )


@_register("atan2", 2, description="atan2(y, x)", fuzz=("num", "num"))
def _atan2(args):
    return E.MathFunc2(
        "atan2",
        _numeric_arg(args[0], "atan2"),
        _numeric_arg(args[1], "atan2"),
    )


@_register("log", 2, description="log(base, x)")
def _log(args):
    return E.MathFunc2(
        "log", _numeric_arg(args[0], "log"), _numeric_arg(args[1], "log")
    )


@_register("mod", 2, description="mod(x, y)", fuzz=("num", "num"))
def _mod(args):
    return E.arith(
        "%", _numeric_arg(args[0], "mod"), _numeric_arg(args[1], "mod")
    )


@_register("pi", 0, description="pi()")
def _pi(args):
    import math

    return E.Literal(math.pi, T.DOUBLE)


@_register("e", 0, description="e()")
def _e(args):
    import math

    return E.Literal(math.e, T.DOUBLE)


def _bound(op: str, args: List[E.Expr], fname: str) -> E.Expr:
    """greatest/least as a CASE fold; NULL if any argument is NULL
    (Presto semantics)."""
    ct = _common_type(args)
    args = [a if a.dtype == ct else E.Cast(a, ct) for a in args]
    out = args[0]
    for a in args[1:]:
        out = E.Case(
            whens=(
                (E.IsNull(out), E.Literal(None, ct)),
                (E.IsNull(a), E.Literal(None, ct)),
                (E.Compare(op, out, a), out),
            ),
            default=a,
            _dtype=ct,
        )
    return out


@_register("greatest", 1, -1, description="greatest(x, ...)",
           fuzz=("num", "num"))
def _greatest(args):
    return _bound(">=", list(args), "greatest")


@_register("least", 1, -1, description="least(x, ...)",
           fuzz=("num", "num"))
def _least(args):
    return _bound("<=", list(args), "least")


# --------------------------------------------------------- conditional


@_register("coalesce", 1, -1, description="coalesce(x, ...)")
def _coalesce(args):
    ct = _common_type(list(args))
    return E.Coalesce(tuple(args), ct)


@_register("if", 2, 3, description="if(cond, then[, else])")
def _if(args):
    cond = args[0]
    if cond.dtype.name != "boolean":
        raise FunctionError("if() condition must be boolean")
    then = args[1]
    default = args[2] if len(args) > 2 else E.Literal(None, then.dtype)
    ct = T.common_super_type(then.dtype, default.dtype)
    return E.Case(whens=((cond, then),), default=default, _dtype=ct)


@_register("nullif", 2, description="nullif(a, b)")
def _nullif(args):
    a, b = args
    return E.Case(
        whens=((E.Compare("=", a, b), E.Literal(None, a.dtype)),),
        default=a,
        _dtype=a.dtype,
    )


# -------------------------------------------------------------- string


@_register("lower", 1, description="lower(s)", fuzz=("str",))
def _lower_fn(args):
    return _transform(_string_arg(args[0], "lower"), "lower")


@_register("upper", 1, description="upper(s)", fuzz=("str",))
def _upper_fn(args):
    return _transform(_string_arg(args[0], "upper"), "upper")


@_register("trim", 1, description="trim(s)", fuzz=("str",))
def _trim(args):
    return _transform(_string_arg(args[0], "trim"), "trim")


@_register("ltrim", 1, description="ltrim(s)", fuzz=("str",))
def _ltrim(args):
    return _transform(_string_arg(args[0], "ltrim"), "ltrim")


@_register("rtrim", 1, description="rtrim(s)", fuzz=("str",))
def _rtrim(args):
    return _transform(_string_arg(args[0], "rtrim"), "rtrim")


@_register("reverse", 1, description="reverse(s)", fuzz=("str",))
def _reverse(args):
    return _transform(_string_arg(args[0], "reverse"), "reverse")


@_register("length", 1, description="length(s) -> bigint", fuzz=("str",))
def _length(args):
    return _int_func(_string_arg(args[0], "length"), "length")


@_register("substring", 2, 3, description="substring(s, start[, len])")
@_register("substr", 2, 3, description="alias of substring")
def _substring(args):
    s = _string_arg(args[0], "substring")
    start = _lit_int(args[1], "substring start")
    length = _lit_int(args[2], "substring length") if len(args) > 2 else None
    return _transform(s, f"substring:{start}:{length}")


@_register("replace", 3, description="replace(s, search, repl)")
def _replace(args):
    s = _string_arg(args[0], "replace")
    old = _lit_str(args[1], "replace search")
    new = _lit_str(args[2], "replace replacement")
    return _transform(s, f"replace:{json.dumps([old, new])}")


@_register(
    "concat", 1, -1,
    description="concat(s, ...): at most one dictionary column, any "
    "number of string literals (host-LUT design)",
)
def _concat(args):
    cols = [a for a in args if not isinstance(a, E.Literal)]
    if len(cols) == 2:
        # two dictionary columns: cross-product combined dictionary
        # (E.DictCombine). Literals between/around the columns fold
        # into the combine function; deeper chains nest (|| is
        # left-associative, so a || b || c combines pairwise)
        for col in cols:
            _string_arg(col, "concat")
        i0 = next(i for i, a in enumerate(args) if a is cols[0])
        i1 = next(
            i
            for i, a in enumerate(args)
            if a is cols[1] and i > i0
        )
        pre = "".join(
            _lit_str(a, "concat argument") for a in args[:i0]
        )
        mid = "".join(
            _lit_str(a, "concat argument")
            for a in args[i0 + 1: i1]
        )
        suf = "".join(
            _lit_str(a, "concat argument") for a in args[i1 + 1:]
        )
        key = f"concat2:{json.dumps([pre, mid, suf])}"
        return E.DictCombine(
            cols[0], cols[1], key, E.dict_transform_fn(key)
        )
    if len(cols) > 2:
        raise FunctionError(
            "concat() supports at most two non-literal arguments "
            "(chain || pairwise for more)"
        )
    if not cols:
        return E.Literal(
            "".join(_lit_str(a, "concat argument") for a in args),
            T.VARCHAR,
        )
    col = cols[0]
    _string_arg(col, "concat")
    idx = next(i for i, a in enumerate(args) if a is col)
    prefix = "".join(
        _lit_str(a, "concat argument") for a in args[:idx]
    )
    suffix = "".join(
        _lit_str(a, "concat argument") for a in args[idx + 1:]
    )
    return _transform(col, f"concat:{json.dumps([prefix, suffix])}")


#: MySQL date_format directives -> strftime (the supported subset;
#: unknown directives fail at plan time, not silently)
_MYSQL_FMT = {
    "%Y": "%Y", "%y": "%y", "%m": "%m", "%c": "%-m", "%d": "%d",
    "%e": "%-d", "%j": "%j", "%W": "%A", "%a": "%a", "%M": "%B",
    "%b": "%b", "%u": "%W", "%%": "%%",
}

#: JodaTime format_datetime tokens -> strftime (longest-match subset)
_JODA_FMT = [
    ("yyyy", "%Y"), ("yy", "%y"), ("MMMM", "%B"), ("MMM", "%b"),
    ("MM", "%m"), ("M", "%-m"), ("dd", "%d"), ("d", "%-d"),
    ("EEEE", "%A"), ("EEE", "%a"), ("DDD", "%j"),
]

#: date-domain LUT bounds: 1900-01-01 .. 2071-06-06 (epoch days)
_DATE_LO, _DATE_HI = -25567, 37040


def _date_arg(e: E.Expr, fname: str) -> E.Expr:
    if e.dtype.name != "date":
        raise FunctionError(f"{fname}() requires a DATE argument")
    return e


@_register(
    "date_format", 2, description="date_format(d, '%Y-%m-%d') (MySQL "
    "directives, date args)",
)
def _date_format(args):
    arg = _date_arg(args[0], "date_format")
    fmt = _lit_str(args[1], "date_format pattern")
    out = []
    i = 0
    while i < len(fmt):
        if fmt[i] == "%":
            tok = fmt[i:i + 2]
            if tok not in _MYSQL_FMT:
                raise FunctionError(
                    f"date_format directive {tok!r} is not supported"
                )
            out.append(_MYSQL_FMT[tok])
            i += 2
        else:
            ch = fmt[i]
            out.append("%%" if ch == "%" else ch)
            i += 1
    key = f"date_format:{json.dumps([''.join(out)])}"
    return E.IntToDict(
        arg, key, _DATE_LO, _DATE_HI, E.dict_transform_fn(key)
    )


@_register(
    "format_datetime", 2,
    description="format_datetime(d, 'yyyy-MM-dd') (Joda tokens, "
    "date args)",
)
def _format_datetime(args):
    arg = _date_arg(args[0], "format_datetime")
    fmt = _lit_str(args[1], "format_datetime pattern")
    out = []
    i = 0
    while i < len(fmt):
        for tok, st in _JODA_FMT:
            if fmt.startswith(tok, i):
                out.append(st)
                i += len(tok)
                break
        else:
            ch = fmt[i]
            if ch.isalpha():
                raise FunctionError(
                    f"format_datetime token {ch!r} at {i} is not "
                    "supported"
                )
            out.append("%%" if ch == "%" else ch)
            i += 1
    key = f"date_format:{json.dumps([''.join(out)])}"
    return E.IntToDict(
        arg, key, _DATE_LO, _DATE_HI, E.dict_transform_fn(key)
    )


@_register("initcap", 1, description="initcap(s)")
def _initcap(args):
    return _transform(_string_arg(args[0], "initcap"), "initcap")


@_register("md5", 1, description="md5(s) -> hex digest")
def _md5(args):
    return _transform(_string_arg(args[0], "md5"), "md5")


@_register("sha256", 1, description="sha256(s) -> hex digest")
def _sha256(args):
    return _transform(_string_arg(args[0], "sha256"), "sha256")


@_register("crc32", 1, description="crc32(s) -> bigint")
def _crc32(args):
    return _int_func(_string_arg(args[0], "crc32"), "crc32")


@_register("codepoint", 1, description="codepoint(s) -> first char")
def _codepoint(args):
    return _int_func(_string_arg(args[0], "codepoint"), "codepoint")


@_register("repeat", 2, description="repeat(s, n)")
def _repeat(args):
    if not isinstance(args[1], E.Literal) or args[1].value is None:
        raise FunctionError("repeat count must be a constant")
    n = int(args[1].value)
    if n < 0 or n > 100:
        raise FunctionError("repeat count out of range [0, 100]")
    return _transform(
        _string_arg(args[0], "repeat"), f"repeat:{json.dumps([n])}"
    )


@_register("translate", 3, description="translate(s, from, to)")
def _translate(args):
    src = _lit_str(args[1], "translate from")
    dst = _lit_str(args[2], "translate to")
    if len(src) != len(dst):
        raise FunctionError(
            "translate from/to must have equal length"
        )
    return _transform(
        _string_arg(args[0], "translate"),
        f"translate:{json.dumps([src, dst])}",
    )


@_register(
    "levenshtein_distance", 2,
    description="levenshtein_distance(s, literal)",
)
def _levenshtein(args):
    other = _lit_str(args[1], "levenshtein_distance reference")
    return _int_func(
        _string_arg(args[0], "levenshtein_distance"),
        f"levenshtein:{json.dumps([other])}",
    )


@_register("char_length", 1, description="char_length(s)")
def _char_length(args):
    return _int_func(_string_arg(args[0], "char_length"), "length")


@_register("strpos", 2, description="strpos(s, sub) -> 1-based, 0=absent")
def _strpos(args):
    s = _string_arg(args[0], "strpos")
    sub = _lit_str(args[1], "strpos substring")
    return _int_func(s, f"strpos:{json.dumps([sub])}")


@_register("position", 2, description="position(sub IN s)")
def _position(args):
    # the parser's position(x IN y) special form produces
    # position(x, y): arg order is (substring, string) — flipped vs
    # strpos
    sub = _lit_str(args[0], "position substring")
    s = _string_arg(args[1], "position")
    return _int_func(s, f"strpos:{json.dumps([sub])}")


@_register("lpad", 3, description="lpad(s, size, pad)")
def _lpad(args):
    s = _string_arg(args[0], "lpad")
    size = _lit_int(args[1], "lpad size")
    pad = _lit_str(args[2], "lpad padstring")
    return _transform(s, f"lpad:{json.dumps([size, pad])}")


@_register("rpad", 3, description="rpad(s, size, pad)")
def _rpad(args):
    s = _string_arg(args[0], "rpad")
    size = _lit_int(args[1], "rpad size")
    pad = _lit_str(args[2], "rpad padstring")
    return _transform(s, f"rpad:{json.dumps([size, pad])}")


@_register(
    "split_part", 3,
    description="split_part(s, delim, index); out-of-range -> '' "
    "(deviation: the reference returns NULL)",
)
def _split_part(args):
    s = _string_arg(args[0], "split_part")
    delim = _lit_str(args[1], "split_part delimiter")
    index = _lit_int(args[2], "split_part index")
    if index < 1:
        raise FunctionError("split_part index must be >= 1")
    return _transform(s, f"split_part:{json.dumps([delim, index])}")


@_register("regexp_like", 2, description="regexp_like(s, pattern)")
def _regexp_like(args):
    s = _string_arg(args[0], "regexp_like")
    pat = _lit_str(args[1], "regexp_like pattern")
    return _predicate(s, f"regexp_like:{json.dumps([pat])}")


@_register("starts_with", 2, description="starts_with(s, prefix)")
def _starts_with(args):
    s = _string_arg(args[0], "starts_with")
    prefix = _lit_str(args[1], "starts_with prefix")
    return _predicate(s, f"starts_with:{json.dumps([prefix])}")


@_register("ends_with", 2, description="ends_with(s, suffix)")
def _ends_with(args):
    s = _string_arg(args[0], "ends_with")
    suffix = _lit_str(args[1], "ends_with suffix")
    return _predicate(s, f"ends_with:{json.dumps([suffix])}")


# ---------------------------------------------------------------- date

_DATE_UNITS = ("year", "quarter", "month", "week", "day")
_TIME_UNITS = ("hour", "minute", "second")


@_register("date_trunc", 2, description="date_trunc(unit, x)",
           fuzz=None)
def _date_trunc(args):
    unit = _lit_str(args[0], "date_trunc unit").lower()
    x = _date_arg(args[1], "date_trunc")
    if unit not in _DATE_UNITS + _TIME_UNITS:
        raise FunctionError(f"date_trunc: unknown unit {unit!r}")
    if unit in _TIME_UNITS and x.dtype.name != "timestamp":
        raise FunctionError(
            f"date_trunc({unit!r}) requires a timestamp argument"
        )
    return E.DateTrunc(unit, x)


@_register("date_add", 3, description="date_add(unit, n, x)")
def _date_add(args):
    unit = _lit_str(args[0], "date_add unit").lower()
    if unit not in _DATE_UNITS or unit == "quarter":
        raise FunctionError(f"date_add: unsupported unit {unit!r}")
    n = _numeric_arg(args[1], "date_add")
    if not n.dtype.is_integer:
        raise FunctionError("date_add count must be an integer")
    x = _date_arg(args[2], "date_add")
    return E.DateAdd(unit, n, x)


@_register(
    "date_diff", 3,
    description="date_diff('day'|'week', a, b) -> b - a in units",
)
def _date_diff(args):
    unit = _lit_str(args[0], "date_diff unit").lower()
    a = _date_arg(args[1], "date_diff")
    b = _date_arg(args[2], "date_diff")
    if unit not in ("day", "week"):
        raise FunctionError(
            f"date_diff: unsupported unit {unit!r} (day/week only; "
            "month/year boundaries need per-row civil division)"
        )
    if a.dtype.name == "timestamp" or b.dtype.name == "timestamp":
        raise FunctionError("date_diff over timestamps: cast to date")
    diff = E.Arithmetic("-", b, a, T.BIGINT)
    if unit == "week":
        return E.arith("/", diff, E.Literal(7, T.BIGINT))
    return diff


def _extract_fn(field: str):
    def build(args, _f=field):
        return E.Extract(_f, _date_arg(args[0], _f))

    return build


for _f in (
    "year", "month", "day", "quarter", "week",
    "day_of_week", "day_of_year",
):
    _register(_f, 1, description=f"{_f}(x)", fuzz=("date",))(
        _extract_fn(_f)
    )


# --------------------------------------------------- aggregate registry

@dataclasses.dataclass(frozen=True)
class KernelAgg:
    """Aggregate lowering onto a native kernel accumulator: ``func`` is
    an ops/aggregation.py kernel name (count/count_star/sum/min/max/
    array_agg/approx_percentile/min_by/max_by), ``arg2`` the ordering
    argument of min_by/max_by, ``param`` approx_percentile's quantile."""

    func: str
    arg: Optional[E.Expr]
    arg2: Optional[E.Expr] = None
    param: Optional[float] = None


@dataclasses.dataclass(frozen=True)
class ComposedAgg:
    """Aggregate lowering as primitive mergeable states + an Expr
    finisher — the engine's form of the reference's accumulator quartet
    (@InputFunction/@CombineFunction/@OutputFunction — SURVEY.md §2.1
    "Function registry"): each state is a (suffix, primitive, expr)
    where primitive ∈ {sum, count, min, max} merges with itself (sum/
    count by summing, min/max by re-reducing), and ``finish`` maps
    ColumnRefs of the state columns to the output expression. Because
    states are self-mergeable primitives, the partial/final distributed
    split (parallel/agg_split.py) handles every composed aggregate with
    NO per-function code."""

    states: Tuple[Tuple[str, str, E.Expr], ...]
    finish: Callable[[Dict[str, E.Expr]], E.Expr]
    dtype: T.DataType


@dataclasses.dataclass(frozen=True)
class AggregateFunction:
    """One registered aggregate builtin. ``build`` validates the
    lowered argument exprs and returns a KernelAgg or ComposedAgg;
    ``distinct_rewrite`` marks approx_distinct-style functions the
    planner rewrites into the two-level count(DISTINCT) tree before
    lowering ever happens."""

    name: str
    min_args: int
    max_args: int  # -1 = variadic
    build: Optional[Callable[[List[E.Expr]], object]]
    description: str = ""
    #: fuzzer argument classes (see ScalarFunction.fuzz); aggregates
    #: with no sqlite oracle equivalent set None
    fuzz: Optional[Tuple[str, ...]] = None
    distinct_rewrite: bool = False


AGGREGATE: Dict[str, AggregateFunction] = {}


def _register_agg(
    name: str,
    min_args: int,
    max_args: Optional[int] = None,
    description: str = "",
    fuzz: Optional[Tuple[str, ...]] = None,
    distinct_rewrite: bool = False,
):
    def deco(fn):
        AGGREGATE[name] = AggregateFunction(
            name=name,
            min_args=min_args,
            max_args=min_args if max_args is None else max_args,
            build=fn,
            description=description,
            fuzz=fuzz,
            distinct_rewrite=distinct_rewrite,
        )
        return fn

    return deco


def is_aggregate(name: str) -> bool:
    return name in AGGREGATE


def lower_aggregate(name: str, args: List[E.Expr]):
    """Resolve + build an aggregate call -> KernelAgg | ComposedAgg;
    FunctionError on unknown name or arity/type mismatch. The planner's
    single entry point (plan/planner.py::_plain_agg_node)."""
    fn = AGGREGATE.get(name)
    if fn is None:
        raise FunctionError(f"unknown aggregate function: {name}")
    n = len(args)
    if n < fn.min_args or (fn.max_args >= 0 and n > fn.max_args):
        want = (
            str(fn.min_args)
            if fn.min_args == fn.max_args
            else f"{fn.min_args}..{'*' if fn.max_args < 0 else fn.max_args}"
        )
        raise FunctionError(f"{name}() takes {want} arguments, got {n}")
    return fn.build(args)


def agg_state_type(prim: str, expr: Optional[E.Expr]) -> T.DataType:
    """Result type of one primitive state column (mirrors the kernel's
    AggCall.result_type for the primitive subset)."""
    if prim in ("count", "count_star"):
        return T.BIGINT
    t = expr.dtype
    if prim == "sum":
        if t.is_decimal:
            return T.decimal(18, t.scale)
        if t.is_integer:
            return T.BIGINT
        return T.DOUBLE
    if prim in ("min", "max"):
        return t
    raise FunctionError(f"unknown aggregate state primitive {prim}")


# --- Expr algebra helpers for finishers (all in DOUBLE) ---------------


def _f64(e: E.Expr) -> E.Expr:
    return e if e.dtype == T.DOUBLE else E.Cast(e, T.DOUBLE)


def _flit(v: float) -> E.Expr:
    return E.Literal(float(v), T.DOUBLE)


def _fmul(a: E.Expr, b: E.Expr) -> E.Expr:
    return E.Arithmetic("*", a, b, T.DOUBLE)


def _fdiv(a: E.Expr, b: E.Expr) -> E.Expr:
    return E.Arithmetic("/", a, b, T.DOUBLE)


def _fadd(a: E.Expr, b: E.Expr) -> E.Expr:
    return E.Arithmetic("+", a, b, T.DOUBLE)


def _fsub(a: E.Expr, b: E.Expr) -> E.Expr:
    return E.Arithmetic("-", a, b, T.DOUBLE)


def _null_unless(cond: E.Expr, body: E.Expr, dtype: T.DataType) -> E.Expr:
    """body where cond, SQL NULL otherwise."""
    return E.Case(
        whens=((E.Not(cond), E.Literal(None, dtype)),),
        default=body,
        _dtype=dtype,
    )


def _cnt_ge(cnt: E.Expr, n: int) -> E.Expr:
    return E.Compare(">=", cnt, E.Literal(n, T.BIGINT))


def _pair_masked(x: E.Expr, y: E.Expr, e: E.Expr) -> E.Expr:
    """e where BOTH x and y are non-null, else NULL — two-argument
    aggregates (corr/covar/regr) skip a row when either input is NULL."""
    both = E.And((E.Not(E.IsNull(x)), E.Not(E.IsNull(y))))
    return E.Case(
        whens=((both, e),),
        default=E.Literal(None, e.dtype),
        _dtype=e.dtype,
    )


def _orderable_arg(e: E.Expr, fname: str) -> E.Expr:
    t = e.dtype
    ok = (
        t.is_integer or t.is_decimal or t.is_string
        or t.name in ("double", "real", "date", "timestamp", "boolean")
    )
    if not ok:
        raise FunctionError(f"{fname}() cannot order type {t}")
    return e


# --- entries ----------------------------------------------------------


@_register_agg("count", 0, 1, description="count(*) | count(x)",
               fuzz=("any",))
def _agg_count(args):
    if not args:
        return KernelAgg("count_star", None)
    return KernelAgg("count", args[0])


@_register_agg("sum", 1, description="sum(x)", fuzz=("num",))
def _agg_sum(args):
    return KernelAgg("sum", _numeric_arg(args[0], "sum"))


@_register_agg("min", 1, description="min(x)", fuzz=("any",))
def _agg_min(args):
    return KernelAgg("min", _orderable_arg(args[0], "min"))


@_register_agg("max", 1, description="max(x)", fuzz=("any",))
def _agg_max(args):
    return KernelAgg("max", _orderable_arg(args[0], "max"))


@_register_agg("arbitrary", 1, description="any value of the group")
@_register_agg("any_value", 1, description="alias of arbitrary")
def _agg_arbitrary(args):
    return KernelAgg("min", _orderable_arg(args[0], "arbitrary"))


def _bool_arg(e: E.Expr, fname: str) -> E.Expr:
    if e.dtype.name != "boolean":
        raise FunctionError(f"{fname}() requires a boolean argument")
    return e


@_register_agg("bool_and", 1, description="true iff every value true")
@_register_agg("every", 1, description="alias of bool_and")
def _agg_bool_and(args):
    return KernelAgg("min", _bool_arg(args[0], "bool_and"))


@_register_agg("bool_or", 1, description="true iff any value true")
def _agg_bool_or(args):
    return KernelAgg("max", _bool_arg(args[0], "bool_or"))


@_register_agg("array_agg", 1, description="array_agg(x)")
def _agg_array_agg(args):
    return KernelAgg("array_agg", args[0])


@_register_agg(
    "approx_distinct", 1,
    description="plans as exact count(DISTINCT x) — error 0 <= any "
    "HLL standard error",
    distinct_rewrite=True,
)
def _agg_approx_distinct(args):
    raise FunctionError(
        "approx_distinct is rewritten by the planner before lowering"
    )


@_register_agg("avg", 1, description="avg(x) = sum/count", fuzz=("num",))
def _agg_avg(args):
    x = _numeric_arg(args[0], "avg")

    def finish(s):
        return _null_unless(
            _cnt_ge(s["cnt"], 1),
            _fdiv(_f64(s["sum"]), _f64(s["cnt"])),
            T.DOUBLE,
        )

    return ComposedAgg(
        states=(("sum", "sum", x), ("cnt", "count", x)),
        finish=finish,
        dtype=T.DOUBLE,
    )


def _variance_entry(func: str):
    """stddev/variance family from (Σx, Σx², n) — the same mergeable
    decomposition the single-node kernel used to hardcode."""

    def build(args, _func=func):
        x = _f64(_numeric_arg(args[0], _func))
        sq = _fmul(x, x)
        samp = _func.endswith("_samp")

        def finish(s, _samp=samp, _f=_func):
            nf = _f64(s["cnt"])
            mean = _fdiv(s["s1"], nf)
            var = _fsub(_fdiv(s["s2"], nf), _fmul(mean, mean))
            if _samp:
                var = _fdiv(
                    _fmul(var, nf), _fsub(nf, _flit(1.0))
                )
            # clamp fp cancellation residue: tiny negative -> 0
            var = E.Case(
                whens=(
                    (E.Compare("<", var, _flit(0.0)), _flit(0.0)),
                ),
                default=var,
                _dtype=T.DOUBLE,
            )
            if _f.startswith("stddev"):
                var = E.MathFunc("sqrt", var)
            return _null_unless(
                _cnt_ge(s["cnt"], 2 if _samp else 1), var, T.DOUBLE
            )

        return ComposedAgg(
            states=(
                ("s1", "sum", x),
                ("s2", "sum", sq),
                ("cnt", "count", x),
            ),
            finish=finish,
            dtype=T.DOUBLE,
        )

    return build


for _f, _target in (
    ("stddev", "stddev_samp"), ("stddev_samp", "stddev_samp"),
    ("stddev_pop", "stddev_pop"), ("variance", "var_samp"),
    ("var_samp", "var_samp"), ("var_pop", "var_pop"),
):
    _register_agg(_f, 1, description=f"{_f}(x)", fuzz=None)(
        _variance_entry(_target)
    )


@_register_agg("geometric_mean", 1,
               description="exp(avg(ln(x))); non-positive values are "
               "skipped as NULL ln (deviation: the reference raises)")
def _agg_geometric_mean(args):
    x = _f64(_numeric_arg(args[0], "geometric_mean"))
    lx = E.MathFunc("ln", x)

    def finish(s):
        return _null_unless(
            _cnt_ge(s["cnt"], 1),
            E.MathFunc("exp", _fdiv(s["s"], _f64(s["cnt"]))),
            T.DOUBLE,
        )

    return ComposedAgg(
        states=(("s", "sum", lx), ("cnt", "count", lx)),
        finish=finish,
        dtype=T.DOUBLE,
    )


@_register_agg("count_if", 1, description="count_if(b) = rows where true")
def _agg_count_if(args):
    b = _bool_arg(args[0], "count_if")
    one_if = E.Case(
        whens=((b, E.Literal(1, T.BIGINT)),),
        default=E.Literal(None, T.BIGINT),
        _dtype=T.BIGINT,
    )

    def finish(s):
        return s["c"]

    return ComposedAgg(
        states=(("c", "count", one_if),), finish=finish, dtype=T.BIGINT
    )


@_register_agg(
    "checksum", 1,
    description="order/partitioning-insensitive BIGINT digest: sum of "
    "per-value 32-bit hashes (deviation: the reference emits varbinary)",
)
def _agg_checksum(args):
    h = E.ValueHash(args[0])

    def finish(s):
        return s["s"]

    return ComposedAgg(
        states=(("s", "sum", h),), finish=finish, dtype=T.BIGINT
    )


def _covar_states(y: E.Expr, x: E.Expr):
    """Pairwise-masked (Σx, Σy, Σxy, n) over rows where BOTH non-null."""
    xf, yf = _f64(x), _f64(y)
    return (
        ("sx", "sum", _pair_masked(x, y, xf)),
        ("sy", "sum", _pair_masked(x, y, yf)),
        ("sxy", "sum", _pair_masked(x, y, _fmul(xf, yf))),
        ("cnt", "count", _pair_masked(x, y, xf)),
    )


def _covar_entry(pop: bool):
    def build(args, _pop=pop):
        y = _numeric_arg(args[0], "covar")
        x = _numeric_arg(args[1], "covar")

        def finish(s, _p=_pop):
            nf = _f64(s["cnt"])
            num = _fsub(
                s["sxy"], _fdiv(_fmul(s["sx"], s["sy"]), nf)
            )
            if _p:
                out = _fdiv(num, nf)
                min_n = 1
            else:
                out = _fdiv(num, _fsub(nf, _flit(1.0)))
                min_n = 2
            return _null_unless(
                _cnt_ge(s["cnt"], min_n), out, T.DOUBLE
            )

        return ComposedAgg(
            states=_covar_states(y, x), finish=finish, dtype=T.DOUBLE
        )

    return build


_register_agg("covar_samp", 2, description="sample covariance(y, x)")(
    _covar_entry(False)
)
_register_agg("covar_pop", 2, description="population covariance(y, x)")(
    _covar_entry(True)
)


@_register_agg("corr", 2, description="Pearson correlation of (y, x)")
def _agg_corr(args):
    y = _numeric_arg(args[0], "corr")
    x = _numeric_arg(args[1], "corr")
    xf, yf = _f64(x), _f64(y)
    states = _covar_states(y, x) + (
        ("sx2", "sum", _pair_masked(x, y, _fmul(xf, xf))),
        ("sy2", "sum", _pair_masked(x, y, _fmul(yf, yf))),
    )

    def finish(s):
        nf = _f64(s["cnt"])
        num = _fsub(_fmul(nf, s["sxy"]), _fmul(s["sx"], s["sy"]))
        dx = _fsub(_fmul(nf, s["sx2"]), _fmul(s["sx"], s["sx"]))
        dy = _fsub(_fmul(nf, s["sy2"]), _fmul(s["sy"], s["sy"]))
        den = E.MathFunc("sqrt", _fmul(dx, dy))
        # sqrt() NULLs on negative domain; also NULL a zero denominator
        out = _null_unless(
            E.Compare(">", den, _flit(0.0)), _fdiv(num, den), T.DOUBLE
        )
        return _null_unless(_cnt_ge(s["cnt"], 2), out, T.DOUBLE)

    return ComposedAgg(states=states, finish=finish, dtype=T.DOUBLE)


@_register_agg("regr_slope", 2,
               description="regr_slope(y, x) = covar_pop(y,x)/var_pop(x)")
def _agg_regr_slope(args):
    y = _numeric_arg(args[0], "regr_slope")
    x = _numeric_arg(args[1], "regr_slope")
    xf = _f64(x)
    states = _covar_states(y, x) + (
        ("sx2", "sum", _pair_masked(x, y, _fmul(xf, xf))),
    )

    def finish(s):
        nf = _f64(s["cnt"])
        num = _fsub(_fmul(nf, s["sxy"]), _fmul(s["sx"], s["sy"]))
        den = _fsub(_fmul(nf, s["sx2"]), _fmul(s["sx"], s["sx"]))
        out = _null_unless(
            E.Compare("!=", den, _flit(0.0)), _fdiv(num, den), T.DOUBLE
        )
        return _null_unless(_cnt_ge(s["cnt"], 1), out, T.DOUBLE)

    return ComposedAgg(states=states, finish=finish, dtype=T.DOUBLE)


@_register_agg("regr_intercept", 2,
               description="regr_intercept(y, x) = avg(y) - slope*avg(x)")
def _agg_regr_intercept(args):
    y = _numeric_arg(args[0], "regr_intercept")
    x = _numeric_arg(args[1], "regr_intercept")
    xf = _f64(x)
    states = _covar_states(y, x) + (
        ("sx2", "sum", _pair_masked(x, y, _fmul(xf, xf))),
    )

    def finish(s):
        nf = _f64(s["cnt"])
        num = _fsub(_fmul(nf, s["sxy"]), _fmul(s["sx"], s["sy"]))
        den = _fsub(_fmul(nf, s["sx2"]), _fmul(s["sx"], s["sx"]))
        slope = _fdiv(num, den)
        icept = _fdiv(
            _fsub(s["sy"], _fmul(slope, s["sx"])), nf
        )
        out = _null_unless(
            E.Compare("!=", den, _flit(0.0)), icept, T.DOUBLE
        )
        return _null_unless(_cnt_ge(s["cnt"], 1), out, T.DOUBLE)

    return ComposedAgg(states=states, finish=finish, dtype=T.DOUBLE)


def _moment_states(x: E.Expr, upto: int):
    xf = _f64(x)
    states = [("s1", "sum", xf), ("cnt", "count", xf)]
    p = xf
    for k in range(2, upto + 1):
        p = _fmul(p, xf)
        states.append((f"s{k}", "sum", p))
    return tuple(states)


@_register_agg("skewness", 1,
               description="sqrt(n) * m3 / m2^1.5 over central moment "
               "sums (the reference's AggregationUtils formula)")
def _agg_skewness(args):
    x = _numeric_arg(args[0], "skewness")

    def finish(s):
        nf = _f64(s["cnt"])
        mean = _fdiv(s["s1"], nf)
        # central moment SUMS from raw moment sums
        m2 = _fsub(s["s2"], _fdiv(_fmul(s["s1"], s["s1"]), nf))
        m3 = _fadd(
            _fsub(
                s["s3"],
                _fmul(_flit(3.0), _fmul(mean, s["s2"])),
            ),
            _fmul(_flit(2.0), _fmul(_fmul(mean, mean), s["s1"])),
        )
        den = E.MathFunc2("power", m2, _flit(1.5))
        out = _fdiv(_fmul(E.MathFunc("sqrt", nf), m3), den)
        out = _null_unless(E.Compare(">", m2, _flit(0.0)), out, T.DOUBLE)
        return _null_unless(_cnt_ge(s["cnt"], 3), out, T.DOUBLE)

    return ComposedAgg(
        states=_moment_states(x, 3), finish=finish, dtype=T.DOUBLE
    )


@_register_agg("kurtosis", 1,
               description="sample excess kurtosis (the reference's "
               "AggregationUtils formula)")
def _agg_kurtosis(args):
    x = _numeric_arg(args[0], "kurtosis")

    def finish(s):
        nf = _f64(s["cnt"])
        mean = _fdiv(s["s1"], nf)
        m2 = _fsub(s["s2"], _fdiv(_fmul(s["s1"], s["s1"]), nf))
        m3 = _fadd(
            _fsub(
                s["s3"], _fmul(_flit(3.0), _fmul(mean, s["s2"]))
            ),
            _fmul(_flit(2.0), _fmul(_fmul(mean, mean), s["s1"])),
        )
        mean2 = _fmul(mean, mean)
        m4 = _fadd(
            _fsub(
                _fadd(
                    s["s4"],
                    _fmul(
                        _flit(6.0), _fmul(mean2, s["s2"])
                    ),
                ),
                _fmul(_flit(4.0), _fmul(mean, s["s3"])),
            ),
            _fmul(_flit(-3.0), _fmul(mean2, _fmul(mean2, nf))),
        )
        _ = m3  # m3 not used by kurtosis; kept for clarity of family
        n1 = _fsub(nf, _flit(1.0))
        n2 = _fsub(nf, _flit(2.0))
        n3 = _fsub(nf, _flit(3.0))
        term = _fdiv(_fmul(nf, _fadd(nf, _flit(1.0))), _fmul(n1, _fmul(n2, n3)))
        # Σd⁴ / s⁴ with s² = m2/(n-1):  m4 · (n-1)² / m2²
        core = _fdiv(_fmul(_fmul(n1, n1), m4), _fmul(m2, m2))
        adj = _fdiv(
            _fmul(_flit(3.0), _fmul(n1, n1)), _fmul(n2, n3)
        )
        out = _fsub(_fmul(term, core), adj)
        out = _null_unless(E.Compare(">", m2, _flit(0.0)), out, T.DOUBLE)
        return _null_unless(_cnt_ge(s["cnt"], 4), out, T.DOUBLE)

    return ComposedAgg(
        states=_moment_states(x, 4), finish=finish, dtype=T.DOUBLE
    )


@_register_agg(
    "approx_percentile", 2,
    description="approx_percentile(x, p): exact nearest-rank percentile "
    "(error 0 <= any qdigest bound); p must be a literal in [0, 1]",
)
def _agg_approx_percentile(args):
    x = _numeric_arg(args[0], "approx_percentile")
    p = args[1]
    if not isinstance(p, E.Literal) or p.value is None:
        raise FunctionError(
            "approx_percentile percentile must be a numeric literal"
        )
    pv = float(p.value)
    if isinstance(p.value, int) and p.dtype.is_decimal:
        pv = pv / (10 ** p.dtype.scale)
    if not (0.0 <= pv <= 1.0):
        raise FunctionError(
            f"approx_percentile percentile must be in [0, 1], got {pv}"
        )
    return KernelAgg("approx_percentile", x, param=pv)


@_register_agg("min_by", 2, description="min_by(x, y): x at minimal y")
def _agg_min_by(args):
    return KernelAgg(
        "min_by", args[0], arg2=_orderable_arg(args[1], "min_by")
    )


@_register_agg("max_by", 2, description="max_by(x, y): x at maximal y")
def _agg_max_by(args):
    return KernelAgg(
        "max_by", args[0], arg2=_orderable_arg(args[1], "max_by")
    )


# ------------------------------------------------------ window registry


@dataclasses.dataclass(frozen=True)
class WindowFunction:
    """One registered window builtin. ``kind`` selects the planner's
    argument protocol (plan/planner.py::_plan_windows):

    - "rank":  no arguments (row_number/rank/dense_rank/percent_rank/
               cume_dist) — pure position arithmetic in the kernel
    - "ntile": one constant bucket-count argument
    - "nav":   lag/lead — value, optional constant offset + default
    - "value": first_value/last_value (one value argument) and
               nth_value (value + constant n)
    - "agg":   aggregate-over-frame (sum/count/avg/min/max)
    """

    name: str
    kind: str
    description: str = ""


WINDOW: Dict[str, WindowFunction] = {}

for _n, _k, _d in (
    ("row_number", "rank", "1-based row position in partition"),
    ("rank", "rank", "rank with gaps over the peer groups"),
    ("dense_rank", "rank", "rank without gaps"),
    ("percent_rank", "rank", "(rank-1)/(rows-1); 0 for 1-row partitions"),
    ("cume_dist", "rank", "peers-through-current / partition rows"),
    ("ntile", "ntile", "ntile(n): n near-equal buckets"),
    ("lag", "nav", "lag(x[, offset[, default]])"),
    ("lead", "nav", "lead(x[, offset[, default]])"),
    ("first_value", "value", "first frame value"),
    ("last_value", "value", "last frame value"),
    ("nth_value", "value", "nth_value(x, n): n-th frame row's value"),
    ("sum", "agg", "running/frame sum"),
    ("count", "agg", "running/frame count"),
    ("avg", "agg", "running/frame average"),
    ("min", "agg", "running/frame minimum"),
    ("max", "agg", "running/frame maximum"),
):
    WINDOW[_n] = WindowFunction(name=_n, kind=_k, description=_d)


def is_window(name: str) -> bool:
    return name in WINDOW
