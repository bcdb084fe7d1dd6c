"""Typed expression IR + PyTorch lowering.

The IR node classes are a verbatim copy of ``presto_tpu/expr.py``'s (the
planner builds them). ``ExprLowerer`` lowers a tree over one Page into
torch tensors, eagerly, with the reference's semantics:

- Null semantics are SQL three-valued logic, carried as (data, valid)
  pairs where ``valid=None`` means "statically no nulls".
- Strings never reach the device: dictionary columns are int32 ids with
  an order-preserving host dictionary, so =/< compare ids against
  host-resolved literal ids.
- Decimals are exact scaled int64 (a ± b rescales to max(scale),
  a * b adds scales, a / b is DOUBLE). Integer floor division and
  remainder use ``rounding_mode="floor"`` / ``torch.remainder``, which
  match ``jnp`` ``//`` and ``%`` on negative operands.

Every node the reference lowers over flat columns is lowered here:
column refs, literals, arithmetic, comparisons, three-valued logic,
BETWEEN, IS NULL, CAST, CASE, COALESCE, IN lists of literals, the
dictionary functions (LIKE, DictPredicate/Transform/Combine/IntFunc,
IntToDict: a host LUT over the dictionary, gathered on the device), the
civil-calendar date functions (EXTRACT, date_trunc, date_add), scalar
math and ValueHash. Nodes over array/map/row columns, RuntimeParam (the
plan cache) and long decimals (int128 limb pairs) are not ported yet:
they raise ``NotImplementedError`` with their names; none is evaluated
approximately.
"""

from __future__ import annotations

import dataclasses
import datetime
import math
import re
from typing import Any, List, Optional, Sequence, Tuple

import numpy as np
import torch

from presto_tpu_torch import types as T
from presto_tpu_torch.page import Page

# --------------------------------------------------------------------------
# IR nodes (analyzer output; see SURVEY.md §2.1 "Analyzer")
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Expr:
    """Base expression; ``dtype`` is resolved at analysis time."""

    def children(self) -> Sequence["Expr"]:
        return ()

    @property
    def dtype(self) -> T.DataType:
        raise NotImplementedError


@dataclasses.dataclass(frozen=True)
class ColumnRef(Expr):
    name: str
    _dtype: T.DataType

    @property
    def dtype(self):
        return self._dtype

    def __str__(self):
        return self.name


@dataclasses.dataclass(frozen=True)
class Literal(Expr):
    """A constant. Decimal literals carry their *unscaled* int value;
    date literals carry epoch days; string literals carry the python str
    (resolved against the column dictionary at lowering time)."""

    value: Any
    _dtype: T.DataType

    @property
    def dtype(self):
        return self._dtype

    def __str__(self):
        return repr(self.value)

    @classmethod
    def of(cls, value: Any) -> "Literal":
        """Infer a literal from a python value (analyzer convenience)."""
        if value is None:
            return cls(None, T.BIGINT)
        if isinstance(value, bool):
            return cls(value, T.BOOLEAN)
        if isinstance(value, int):
            return cls(value, T.BIGINT)
        if isinstance(value, float):
            return cls(value, T.DOUBLE)
        if isinstance(value, str):
            return cls(value, T.VARCHAR)
        if isinstance(value, datetime.date):
            days = (value - datetime.date(1970, 1, 1)).days
            return cls(days, T.DATE)
        raise TypeError(f"cannot infer literal type for {value!r}")


@dataclasses.dataclass(frozen=True)
class Arithmetic(Expr):
    op: str  # + - * / %
    left: Expr
    right: Expr
    _dtype: T.DataType

    def children(self):
        return (self.left, self.right)

    @property
    def dtype(self):
        return self._dtype


@dataclasses.dataclass(frozen=True)
class Negate(Expr):
    arg: Expr

    def children(self):
        return (self.arg,)

    @property
    def dtype(self):
        return self.arg.dtype


@dataclasses.dataclass(frozen=True)
class Compare(Expr):
    op: str  # = <> < <= > >=
    left: Expr
    right: Expr

    def children(self):
        return (self.left, self.right)

    @property
    def dtype(self):
        return T.BOOLEAN


@dataclasses.dataclass(frozen=True)
class And(Expr):
    terms: Tuple[Expr, ...]

    def children(self):
        return self.terms

    @property
    def dtype(self):
        return T.BOOLEAN


@dataclasses.dataclass(frozen=True)
class Or(Expr):
    terms: Tuple[Expr, ...]

    def children(self):
        return self.terms

    @property
    def dtype(self):
        return T.BOOLEAN


@dataclasses.dataclass(frozen=True)
class Not(Expr):
    arg: Expr

    def children(self):
        return (self.arg,)

    @property
    def dtype(self):
        return T.BOOLEAN


@dataclasses.dataclass(frozen=True)
class IsNull(Expr):
    arg: Expr
    negate: bool = False

    def children(self):
        return (self.arg,)

    @property
    def dtype(self):
        return T.BOOLEAN


@dataclasses.dataclass(frozen=True)
class Case(Expr):
    """Searched CASE: WHEN cond THEN value ... ELSE default."""

    whens: Tuple[Tuple[Expr, Expr], ...]
    default: Optional[Expr]
    _dtype: T.DataType

    def children(self):
        out: List[Expr] = []
        for c, v in self.whens:
            out += [c, v]
        if self.default is not None:
            out.append(self.default)
        return tuple(out)

    @property
    def dtype(self):
        return self._dtype


@dataclasses.dataclass(frozen=True)
class Cast(Expr):
    arg: Expr
    to: T.DataType

    def children(self):
        return (self.arg,)

    @property
    def dtype(self):
        return self.to


@dataclasses.dataclass(frozen=True)
class MathFunc(Expr):
    """Scalar math over one numeric argument (reference: the scalar
    function registry's math builtins — SURVEY.md §2.1 "Function
    registry"). abs/sign/round/truncate preserve the argument type,
    floor/ceil return BIGINT, the rest return DOUBLE; sqrt/ln of
    out-of-domain values return NULL (SQL-adjacent; the reference
    raises — documented deviation, keeps the kernel branch-free)."""

    func: str
    arg: Expr

    def children(self):
        return (self.arg,)

    @property
    def dtype(self):
        if self.func == "sign" and self.arg.dtype.is_decimal:
            # ±1/0 is an integer; keeping the decimal type would read
            # the bare sign as an unscaled value (off by 10^-scale)
            return T.BIGINT
        if self.func in ("abs", "sign", "round", "truncate"):
            return self.arg.dtype
        if self.func in ("floor", "ceil"):
            return T.BIGINT
        return T.DOUBLE


@dataclasses.dataclass(frozen=True)
class MathFunc2(Expr):
    """Two-argument scalar math: power | atan2 | log(base, x) |
    round(x, digits) | truncate(x, digits). round/truncate preserve the
    first argument's type; the rest return DOUBLE."""

    func: str
    left: Expr
    right: Expr

    def children(self):
        return (self.left, self.right)

    @property
    def dtype(self):
        if self.func in ("round", "truncate"):
            return self.left.dtype
        return T.DOUBLE


@dataclasses.dataclass(frozen=True)
class DateTrunc(Expr):
    """date_trunc(unit, x) over date (epoch days) or timestamp (epoch
    microseconds): unit in year|quarter|month|week|day (+ hour|minute|
    second for timestamps). Branch-free civil-calendar integer math on
    device (see _civil_from_days / _days_from_civil)."""

    unit: str
    arg: Expr

    def children(self):
        return (self.arg,)

    @property
    def dtype(self):
        return self.arg.dtype


@dataclasses.dataclass(frozen=True)
class Between(Expr):
    arg: Expr
    low: Expr
    high: Expr
    negate: bool = False

    def children(self):
        return (self.arg, self.low, self.high)

    @property
    def dtype(self):
        return T.BOOLEAN


@dataclasses.dataclass(frozen=True)
class InList(Expr):
    arg: Expr
    values: Tuple[Expr, ...]  # literals
    negate: bool = False

    def children(self):
        return (self.arg,) + self.values

    @property
    def dtype(self):
        return T.BOOLEAN


@dataclasses.dataclass(frozen=True)
class Like(Expr):
    """LIKE with a literal pattern — evaluated host-side over the
    dictionary into a boolean LUT, gathered on device."""

    arg: Expr
    pattern: str
    negate: bool = False

    def children(self):
        return (self.arg,)

    @property
    def dtype(self):
        return T.BOOLEAN


@dataclasses.dataclass(frozen=True)
class Extract(Expr):
    """EXTRACT(field FROM date) — field in year/month/day/quarter."""

    field: str
    arg: Expr

    def children(self):
        return (self.arg,)

    @property
    def dtype(self):
        return T.BIGINT


@dataclasses.dataclass(frozen=True)
class Coalesce(Expr):
    args: Tuple[Expr, ...]
    _dtype: T.DataType

    def children(self):
        return self.args

    @property
    def dtype(self):
        return self._dtype


@dataclasses.dataclass(frozen=True)
class Param(Expr):
    """A scalar placeholder bound before fragment compilation (used for
    uncorrelated scalar subqueries: the executor runs the subplan, then
    substitutes the resulting Literal — reference analogue: the planner's
    ApplyNode for scalar subqueries, resolved at runtime)."""

    param_id: int
    _dtype: T.DataType

    @property
    def dtype(self):
        return self._dtype


@dataclasses.dataclass(frozen=True)
class RuntimeParam(Expr):
    """A hoisted literal that enters the compiled program as a RUNTIME
    argument (device input) instead of a trace-time constant — the
    parameterized-plan-cache leaf (plan/canonical.py). Two structurally
    identical plans whose literals differ only in value normalize to
    one canonical form over RuntimeParams, so they share ONE jitted
    program; the values ride in as a parameter vector per execution.

    ``index`` is the slot in that vector. Construction is owned by
    plan/canonical.py (and the planner's one BoundParam lowering site)
    — enforced by tools/check_plan_params.py: an ad-hoc RuntimeParam
    bypasses the dtype/structure eligibility rules (strings resolve
    against trace-time dictionaries, long decimals take the
    literal-introspection fast path) and silently miscompiles."""

    index: int
    _dtype: T.DataType

    @property
    def dtype(self):
        return self._dtype

    def __str__(self):
        return f"?p{self.index}"


@dataclasses.dataclass(frozen=True)
class DictTransform(Expr):
    """String-valued function of a dictionary column, evaluated host-side
    over the dictionary entries (substring, lower, ...). On device it is
    an int32 LUT gather old-id -> new-id; the result column carries the
    transformed (re-sorted) dictionary. ``fn`` maps str -> str."""

    arg: Expr  # string-typed
    fn_key: str
    fn: object = dataclasses.field(hash=False, compare=False)

    def children(self):
        return (self.arg,)

    @property
    def dtype(self):
        return T.VARCHAR


@dataclasses.dataclass(frozen=True)
class DictCombine(Expr):
    """String-valued function of TWO dictionary columns (a || b): the
    combined dictionary is the host-side cross product of both inputs'
    values (bounded — names/labels, not free text), and the device id
    is id_left * |right| + id_right gathered through one int32 LUT.
    ``fn`` maps (str, str) -> str, rebuilt from ``fn_key``."""

    left: Expr  # string-typed
    right: Expr  # string-typed
    fn_key: str
    fn: object = dataclasses.field(hash=False, compare=False)

    def children(self):
        return (self.left, self.right)

    @property
    def dtype(self):
        return T.VARCHAR


@dataclasses.dataclass(frozen=True)
class IntToDict(Expr):
    """String-valued function of a BOUNDED integer column (dates as
    epoch days -> formatted strings): the dictionary is a host-side
    LUT over [lo, hi] (the date domain is a few tens of thousands of
    values), the device gathers ``lut[clip(x - lo)]``. ``fn`` maps
    int -> str, rebuilt from ``fn_key``."""

    arg: Expr  # integer/date-typed
    fn_key: str
    lo: int
    hi: int
    fn: object = dataclasses.field(hash=False, compare=False)

    def children(self):
        return (self.arg,)

    @property
    def dtype(self):
        return T.VARCHAR


def dict_transform_fn(fn_key: str):
    """Rebuild a dictionary-function host callable from its key.

    The key is the canonical (wire-safe) identity of the function —
    the coordinator->worker protocol ships only ``fn_key`` and rebuilds
    the callable here, so every producer of DictTransform /
    DictPredicate / DictIntFunc nodes must construct ``fn`` through
    this factory. Parameterized keys carry their arguments
    JSON-encoded after the first colon (colon-safe)."""
    import json

    if fn_key.startswith("date_format:"):
        import datetime

        (fmt,) = json.loads(fn_key.partition(":")[2])

        def _df(days, _f=fmt):
            d = datetime.date(1970, 1, 1) + datetime.timedelta(
                days=int(days)
            )
            return d.strftime(_f)

        return _df
    if fn_key.startswith("concat2:"):
        import json as _json

        pre, mid, suf = _json.loads(fn_key.partition(":")[2])
        return lambda a, b: pre + a + mid + b + suf
    if fn_key == "initcap":
        return lambda s: " ".join(
            w[:1].upper() + w[1:].lower() for w in s.split(" ")
        )
    if fn_key == "md5":
        import hashlib

        return lambda s: hashlib.md5(s.encode()).hexdigest()
    if fn_key == "sha256":
        import hashlib

        return lambda s: hashlib.sha256(s.encode()).hexdigest()
    if fn_key == "crc32":
        import zlib

        return lambda s: zlib.crc32(s.encode())
    if fn_key == "codepoint":
        return lambda s: ord(s[0]) if s else 0
    if fn_key.startswith("repeat:"):
        (n_,) = json.loads(fn_key.partition(":")[2])
        return lambda s: s * n_
    if fn_key.startswith("translate:"):
        src, dst = json.loads(fn_key.partition(":")[2])
        table = str.maketrans(src, dst)
        return lambda s: s.translate(table)
    if fn_key.startswith("levenshtein:"):
        (other,) = json.loads(fn_key.partition(":")[2])

        def _lev(s, _o=other):
            prev = list(range(len(_o) + 1))
            for i, ca in enumerate(s, 1):
                cur = [i]
                for j, cb in enumerate(_o, 1):
                    cur.append(min(
                        prev[j] + 1, cur[-1] + 1,
                        prev[j - 1] + (ca != cb),
                    ))
                prev = cur
            return prev[-1]

        return _lev
    if fn_key == "lower":
        return str.lower
    if fn_key == "upper":
        return str.upper
    if fn_key == "trim":
        return str.strip
    if fn_key == "ltrim":
        return lambda s: s.lstrip()
    if fn_key == "rtrim":
        return lambda s: s.rstrip()
    if fn_key == "reverse":
        return lambda s: s[::-1]
    if fn_key == "length":
        return len
    if fn_key.startswith("substring:"):
        _, st, ln = fn_key.split(":")
        start = int(st)
        length = None if ln == "None" else int(ln)
        if length is None:
            return lambda s: s[start - 1:]
        return lambda s: s[start - 1: start - 1 + length]
    kind, _, payload = fn_key.partition(":")
    if kind == "replace":
        old, new = json.loads(payload)
        return lambda s: s.replace(old, new)
    if kind == "concat":
        prefix, suffix = json.loads(payload)
        return lambda s: prefix + s + suffix
    if kind == "lpad":
        size, pad = json.loads(payload)
        return lambda s: (
            s[:size]
            if len(s) >= size
            else ((pad * size)[: size - len(s)] + s if pad else s)
        )
    if kind == "rpad":
        size, pad = json.loads(payload)
        return lambda s: (
            s[:size]
            if len(s) >= size
            else (s + (pad * size)[: size - len(s)] if pad else s)
        )
    if kind == "split_part":
        delim, index = json.loads(payload)
        def _split_part(s, _d=delim, _i=index):
            parts = s.split(_d) if _d else [s]
            return parts[_i - 1] if 1 <= _i <= len(parts) else ""
        return _split_part
    if kind == "strpos":
        (sub,) = json.loads(payload)
        return lambda s: s.find(sub) + 1
    if kind == "regexp_like":
        (pat,) = json.loads(payload)
        rx = re.compile(pat)
        return lambda s: rx.search(s) is not None
    if kind == "starts_with":
        (prefix,) = json.loads(payload)
        return lambda s: s.startswith(prefix)
    if kind == "ends_with":
        (suffix,) = json.loads(payload)
        return lambda s: s.endswith(suffix)
    raise TypeError(f"unknown dictionary-function key {fn_key!r}")


@dataclasses.dataclass(frozen=True)
class ArrayLength(Expr):
    """cardinality(arr) over a physical array column -> BIGINT
    (offsets difference; NULL rows stay NULL)."""

    arg: Expr  # ColumnRef to an array column

    def children(self):
        return (self.arg,)

    @property
    def dtype(self):
        return T.BIGINT


@dataclasses.dataclass(frozen=True)
class ArraySubscript(Expr):
    """arr[i] / element_at(arr, i) over a physical array column: a
    bounds-checked gather ``values[offsets[row] + i - 1]``;
    out-of-range (or negative-from-the-end out-of-range) -> NULL
    (Presto element_at semantics; the reference's subscript raises —
    documented deviation keeps the kernel branch-free)."""

    arg: Expr  # ColumnRef to an array column
    index: Expr  # 1-based; negative = from the end

    def children(self):
        return (self.arg, self.index)

    @property
    def dtype(self):
        return self.arg.dtype.element


@dataclasses.dataclass(frozen=True)
class MapSubscript(Expr):
    """m[k] / element_at(m, k) over a physical map column: a flat
    segment scan — the matching entry's flat position per row is a
    segmented running max over ``match ? j : -1`` read at each row's
    segment end (branch-free, one pass over the values axis, no
    scatter). Missing key -> NULL (Presto element_at; the reference's
    subscript raises — same documented deviation as ArraySubscript)."""

    arg: Expr  # ColumnRef to a map column
    key: Expr

    def children(self):
        return (self.arg, self.key)

    @property
    def dtype(self):
        return self.arg.dtype.value


@dataclasses.dataclass(frozen=True)
class RowFieldAccess(Expr):
    """r.f over a physical row (struct) column: zero-copy select of the
    field's child block; row-NULL propagates into the field."""

    arg: Expr  # ColumnRef to a row column
    field: str
    field_type: T.DataType

    def children(self):
        return (self.arg,)

    @property
    def dtype(self):
        return self.field_type


@dataclasses.dataclass(frozen=True)
class DateAdd(Expr):
    """date_add(unit, n, x): shift a date/timestamp by n units (unit in
    day|week|month|year). Month/year shifts clamp the day-of-month to
    the target month's length (SQL semantics), computed branch-free via
    civil-calendar math on device."""

    unit: str
    n: Expr  # integer count (may be a column)
    arg: Expr

    def children(self):
        return (self.n, self.arg)

    @property
    def dtype(self):
        return self.arg.dtype


@dataclasses.dataclass(frozen=True)
class ValueHash(Expr):
    """checksum() support: an order-insensitive per-value hash.

    Maps any column to a 32-bit avalanche hash zero-extended into
    BIGINT, with NULL contributing a fixed non-zero constant — so a
    wrapping-free int64 SUM over the hashes (exact below 2^31 rows) is
    an order- and partitioning-insensitive set digest. Reference parity:
    the ``checksum()`` aggregate's per-value XXHash64 step (SURVEY.md
    §2.1 "Function registry"); deviation: 32-bit mix + BIGINT result
    (the reference emits varbinary), values hash their physical device
    image (dictionary ids for strings), so checksums compare equal only
    within one engine — the reference makes the same single-engine
    assumption for its own hash seed.

    The output has no validity lane (NULLs are folded INTO the hash),
    which is what lets the SUM state see every live row."""

    arg: Expr

    def children(self):
        return (self.arg,)

    @property
    def dtype(self):
        return T.BIGINT


@dataclasses.dataclass(frozen=True)
class DictIntFunc(Expr):
    """Integer-valued function of a dictionary column (length, strpos),
    evaluated host-side per dictionary entry into an int64 LUT that the
    device gathers (SURVEY.md §7 "Strings on TPU"). ``fn`` maps
    str -> int and is rebuilt from ``fn_key`` via dict_transform_fn."""

    arg: Expr  # string-typed
    fn_key: str
    fn: object = dataclasses.field(hash=False, compare=False)

    def children(self):
        return (self.arg,)

    @property
    def dtype(self):
        return T.BIGINT


@dataclasses.dataclass(frozen=True)
class DictPredicate(Expr):
    """Boolean predicate over a dictionary column evaluated *host-side*
    per dictionary entry (e.g. predicates over substring()/lower()): the
    device just gathers the LUT (SURVEY.md §7 "Strings on TPU").
    ``fn_key`` keeps the node hashable; ``fn`` maps str -> bool."""

    arg: Expr  # ColumnRef to a varchar column
    fn_key: str
    fn: object = dataclasses.field(hash=False, compare=False)

    def children(self):
        return (self.arg,)

    @property
    def dtype(self):
        return T.BOOLEAN


# --- analyzer-facing constructors (type inference for binary ops) ---------


def arith(op: str, left: Expr, right: Expr) -> Arithmetic:
    lt, rt = left.dtype, right.dtype
    if (lt.is_decimal or rt.is_decimal) and (
        lt.name in ("double", "real") or rt.name in ("double", "real")
    ):
        out = T.DOUBLE  # decimal op double -> double (reference semantics)
    elif op == "/" and (lt.is_decimal or rt.is_decimal):
        out = T.DOUBLE  # documented deviation: int128 division later
    elif lt.is_decimal or rt.is_decimal:
        a = lt if lt.is_decimal else T.decimal(18, 0)
        b = rt if rt.is_decimal else T.decimal(18, 0)
        long = a.is_long_decimal or b.is_long_decimal
        if op == "*":
            scale = a.scale + b.scale
            if scale > 18:
                raise NotImplementedError(
                    f"decimal multiply scale {scale} > 18"
                )
            out = T.decimal(38 if long else 18, scale)
        else:
            out = T.decimal(38 if long else 18, max(a.scale, b.scale))
    else:
        out = T.common_super_type(lt, rt)
    return Arithmetic(op, left, right, out)



# --------------------------------------------------------------------------
# Lowering: eval_expr(expr, page) -> (data, valid|None) as torch tensors
# --------------------------------------------------------------------------

def like_to_regex(pattern: str, escape: Optional[str] = None) -> re.Pattern:
    out, i = [], 0
    while i < len(pattern):
        c = pattern[i]
        if escape and c == escape and i + 1 < len(pattern):
            out.append(re.escape(pattern[i + 1]))
            i += 2
            continue
        if c == "%":
            out.append(".*")
        elif c == "_":
            out.append(".")
        else:
            out.append(re.escape(c))
        i += 1
    return re.compile("^" + "".join(out) + "$", re.DOTALL)


def _floordiv(a, b):
    """Integer floor division (``jnp`` ``//``): rounds toward -inf."""
    return torch.div(a, b, rounding_mode="floor")


_US_PER_DAY = 86_400_000_000


def _i64(c: int) -> int:
    """A uint64 constant as the int64 with the same bits."""
    return c - (1 << 64) if c >= (1 << 63) else c


def _lsr(z: torch.Tensor, k: int) -> torch.Tensor:
    """Logical right shift of int64 bits (``>>`` on int64 is arithmetic:
    mask off the copies of the sign bit)."""
    return (z >> k) & ((1 << (64 - k)) - 1)


def _sign(x: torch.Tensor) -> torch.Tensor:
    """``jnp.sign``: NaN and -0.0 map to themselves (``torch.sign`` gives
    0 for both)."""
    if not x.is_floating_point():
        return torch.sign(x)
    return torch.where(x > 0, 1.0, torch.where(x < 0, -1.0, x))


def _to_i64(x: torch.Tensor) -> torch.Tensor:
    """float64 -> int64 as XLA converts: NaN to 0, out-of-range values
    saturate (torch's own conversion leaves them undefined)."""
    big = x >= 2.0 ** 63
    small = x < -(2.0 ** 63)
    ok = ~(big | small | torch.isnan(x))
    out = torch.where(ok, x, 0.0).to(torch.int64)
    out = torch.where(big, torch.iinfo(torch.int64).max, out)
    return torch.where(small, torch.iinfo(torch.int64).min, out)


def _cbrt(x: torch.Tensor) -> torch.Tensor:
    """Real cube root (torch has none): |x|^(1/3) with x's sign, then one
    Newton step written as y + (x/y^2 - y)/3, which cannot overflow."""
    y = _sign(x) * torch.pow(torch.abs(x), 1.0 / 3.0)
    ok = torch.isfinite(y) & (y != 0)
    safe = torch.where(ok, y, 1.0)
    return torch.where(ok, safe + (x / (safe * safe) - safe) / 3.0, y)


def _rescale(data, from_scale: int, to_scale: int):
    if to_scale > from_scale:
        return data * (10 ** (to_scale - from_scale))
    if to_scale < from_scale:
        # SQL half-up rounding away from zero (matches ingest in page.py)
        factor = 10 ** (from_scale - to_scale)
        half = factor // 2
        q = _floordiv(torch.abs(data) + half, factor)
        return torch.sign(data) * q
    return data


def _and_valid(a, b):
    if a is None:
        return b
    if b is None:
        return a
    return a & b


def _numeric_pair(left: Expr, right: Expr, ld, rd):
    """Align two numeric operands to a common device representation.
    Returns (l, r, kind) where kind is 'decimal:<scale>' | 'float' | 'int'."""
    lt, rt = left.dtype, right.dtype
    if lt.is_decimal or rt.is_decimal:
        if lt.name == "double" or rt.name == "double" or lt.name == "real" or rt.name == "real":
            ls = 10.0 ** -(lt.scale if lt.is_decimal else 0)
            rs = 10.0 ** -(rt.scale if rt.is_decimal else 0)
            return (
                ld.to(torch.float64) * (ls if lt.is_decimal else 1.0),
                rd.to(torch.float64) * (rs if rt.is_decimal else 1.0),
                "float",
            )
        scale = max(
            lt.scale if lt.is_decimal else 0,
            rt.scale if rt.is_decimal else 0,
        )
        l = _rescale(ld.to(torch.int64), lt.scale if lt.is_decimal else 0, scale)
        r = _rescale(rd.to(torch.int64), rt.scale if rt.is_decimal else 0, scale)
        return l, r, f"decimal:{scale}"
    if lt.name in ("double", "real") or rt.name in ("double", "real"):
        return ld.to(torch.float64), rd.to(torch.float64), "float"
    return ld.to(torch.int64), rd.to(torch.int64), "int"


def _civil_from_days(z):
    """Epoch days -> (year, month, day), branch-free integer math
    (Howard Hinnant's civil_from_days; operands kept non-negative)."""
    z = z.to(torch.int64) + 719468
    era = _floordiv(torch.where(z >= 0, z, z - 146096), 146097)
    doe = z - era * 146097
    yoe = _floordiv(
        doe - _floordiv(doe, 1460) + _floordiv(doe, 36524)
        - _floordiv(doe, 146096),
        365,
    )
    y = yoe + era * 400
    doy = doe - (365 * yoe + _floordiv(yoe, 4) - _floordiv(yoe, 100))
    mp = _floordiv(5 * doy + 2, 153)
    d = doy - _floordiv(153 * mp + 2, 5) + 1
    m = mp + torch.where(mp < 10, 3, -9)
    y = y + (m <= 2).to(torch.int64)
    return y, m, d


def _days_from_civil(y, m, d):
    """(year, month, day) -> epoch days; inverse of _civil_from_days
    (Howard Hinnant's days_from_civil), branch-free."""
    y = y - (m <= 2).to(torch.int64)
    era = _floordiv(torch.where(y >= 0, y, y - 399), 400)
    yoe = y - era * 400
    doy = _floordiv(153 * (m + torch.where(m > 2, -3, 9)) + 2, 5) + d - 1
    doe = yoe * 365 + _floordiv(yoe, 4) - _floordiv(yoe, 100) + doy
    return era * 146097 + doe - 719468


def lut_to_device(lut: np.ndarray, device: torch.device) -> torch.Tensor:
    """A host lookup table on ``device``. To a card it goes from pinned
    memory, so the copy is queued on the stream and the host does not
    wait for the card's queued work (a pageable copy would)."""
    t = torch.from_numpy(np.ascontiguousarray(lut))
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


def _long_unsupported():
    return NotImplementedError(
        "long decimals (int128 limb pairs): later slice of the port"
    )


class ExprLowerer:
    """Lowers an Expr tree over one Page into torch tensors.

    Results are (data, valid) with valid=None meaning statically
    null-free. Literals lower to 0-d tensors that broadcast against
    (capacity,) columns, as the reference's 0-d arrays do."""

    def __init__(self, page: Page):
        self.page = page
        self.device = page.device
        self._transform_cache = {}

    def _lut(self, lut: np.ndarray) -> torch.Tensor:
        return lut_to_device(lut, self.device)

    def _remap(self, ids: torch.Tensor, lut: np.ndarray) -> torch.Tensor:
        if not len(lut):
            return ids
        idx = torch.clamp(ids, 0, len(lut) - 1).to(torch.int64)
        return self._lut(lut)[idx]

    def _zeros(self, dtype) -> torch.Tensor:
        return torch.zeros(
            (self.page.capacity,), dtype=dtype, device=self.device
        )

    def _ones_bool(self) -> torch.Tensor:
        return torch.ones(
            (self.page.capacity,), dtype=torch.bool, device=self.device
        )

    def dictionary_of(self, expr: Expr):
        """Host dictionary of a string-typed expression's result."""
        from presto_tpu_torch.page import Dictionary

        if isinstance(expr, ColumnRef):
            return self.page.block(expr.name).dictionary
        if isinstance(expr, DictTransform):
            return self._transform(expr)[0]
        if isinstance(expr, DictCombine):
            return self._combine(expr)[0]
        if isinstance(expr, Coalesce) and expr.dtype.is_string:
            return self._coalesce_dict(expr)[0]
        if isinstance(expr, Case) and expr.dtype.is_string:
            return self._case_dicts(expr)[0][0]
        if isinstance(expr, IntToDict):
            return self._int_to_dict(expr)[0]
        if isinstance(expr, Literal):
            vals = [] if expr.value is None else [str(expr.value)]
            return Dictionary(np.asarray(vals, object))
        raise NotImplementedError(
            f"no dictionary for string expression {type(expr).__name__}"
        )

    def _sorted_lut(self, key, values):
        """(sorted Dictionary of the distinct strings of ``values()``, an
        int32 LUT from each value's position to its id), made once per
        ``key``: the shared host step of every dictionary-valued
        function."""
        if key not in self._transform_cache:
            from presto_tpu_torch.page import Dictionary

            strings = np.asarray([str(v) for v in values()], dtype=str)
            uniq = np.unique(strings)
            self._transform_cache[key] = (
                Dictionary(uniq.astype(object)),
                np.searchsorted(uniq, strings).astype(np.int32),
            )
        return self._transform_cache[key]

    def _combine(self, e: DictCombine):
        """(new dictionary, pair-id -> new-id LUT) for a two-dictionary
        combine. pair id = id_left * |right| + id_right."""
        ld = self.dictionary_of(e.left)
        rd = self.dictionary_of(e.right)
        nl, nr = len(ld.values), len(rd.values)
        if nl * nr > (1 << 20):
            raise NotImplementedError(
                f"combined dictionary too large ({nl}x{nr}); "
                "two-column string functions are bounded to 2^20 "
                "combinations (names/labels, not free text)"
            )
        return self._sorted_lut(
            (e.fn_key, ld, rd),
            lambda: (e.fn(a, b) for a in ld.values for b in rd.values),
        )

    def _transform(self, e: DictTransform):
        """(new dictionary, old-id -> new-id LUT)."""
        src = self.dictionary_of(e.arg)
        return self._sorted_lut(
            (e.fn_key, src), lambda: map(e.fn, src.values)
        )

    def _int_to_dict(self, e: IntToDict):
        """(Dictionary, value LUT over [lo, hi])."""
        return self._sorted_lut(
            (e.fn_key, e.lo, e.hi), lambda: map(e.fn, range(e.lo, e.hi + 1))
        )

    def _gather_lut(self, lut: np.ndarray, idx: torch.Tensor, empty):
        """``lut[clamp(idx)]`` on the device; an empty LUT (an empty or
        all-NULL dictionary) gives ``empty``'s zeros."""
        if len(lut) == 0:
            return self._zeros(empty)
        return self._lut(lut)[torch.clamp(idx, 0, len(lut) - 1).long()]

    def eval(self, expr: Expr):
        method = getattr(self, "_eval_" + type(expr).__name__.lower(), None)
        if method is None:
            raise NotImplementedError(
                f"no lowering for {type(expr).__name__}"
            )
        return method(expr)

    # -- leaves ------------------------------------------------------------

    def _eval_columnref(self, e: ColumnRef):
        blk = self.page.block(e.name)
        return blk.data, blk.valid

    def _eval_literal(self, e: Literal):
        if e.dtype.is_long_decimal:
            raise _long_unsupported()
        if e.value is None:
            return (
                self._zeros(e.dtype.torch_dtype),
                self._zeros(torch.bool),
            )
        if e.dtype.is_string:
            # one-entry dictionary, all ids 0 (dictionary_of pairs it)
            return self._zeros(torch.int32), None
        # a fill on the device: torch.tensor() would copy from the host
        # and make the host wait for the queued device work
        return (
            torch.full(
                (), e.value, dtype=e.dtype.torch_dtype, device=self.device
            ),
            None,
        )

    # -- arithmetic --------------------------------------------------------

    def _eval_arithmetic(self, e: Arithmetic):
        ld, lv = self.eval(e.left)
        rd, rv = self.eval(e.right)
        valid = _and_valid(lv, rv)
        lt, rt = e.left.dtype, e.right.dtype
        if lt.is_long_decimal or rt.is_long_decimal:
            raise _long_unsupported()
        if e.op == "/" and (lt.is_decimal or rt.is_decimal):
            ls = 10.0 ** -(lt.scale if lt.is_decimal else 0)
            rs = 10.0 ** -(rt.scale if rt.is_decimal else 0)
            lf = ld.to(torch.float64) * ls
            rf = rd.to(torch.float64) * rs
            return lf / torch.where(rf == 0, 1.0, rf), (
                valid
                if not _maybe_zero(e.right)
                else _and_valid(valid, rf != 0)
            )
        if e.op == "*" and lt.is_decimal and rt.is_decimal:
            # exact: unscaled product, scale adds
            return ld.to(torch.int64) * rd.to(torch.int64), valid
        if e.op == "*" and (lt.is_decimal or rt.is_decimal):
            dec, other = (ld, rd) if lt.is_decimal else (rd, ld)
            ot = rt if lt.is_decimal else lt
            if ot.is_integer:
                # exact: unscaled decimal * integer keeps the scale
                return dec.to(torch.int64) * other.to(torch.int64), valid
            # decimal * double falls through: _numeric_pair descales
        l, r, kind = _numeric_pair(e.left, e.right, ld, rd)
        if e.op == "+":
            return l + r, valid
        if e.op == "-":
            return l - r, valid
        if e.op == "*":
            return l * r, valid
        if e.op == "/":
            if kind == "float":
                return l / torch.where(r == 0, 1.0, r), _and_valid(valid, r != 0)
            # SQL integer division truncates toward zero
            q = torch.sign(l) * torch.sign(r) * _floordiv(
                torch.abs(l), torch.clamp(torch.abs(r), min=1)
            )
            return q.to(torch.int64), _and_valid(valid, r != 0)
        if e.op == "%":
            r_safe = torch.where(r == 0, 1, r)
            m = l - (
                torch.sign(l) * torch.sign(r)
                * _floordiv(torch.abs(l), torch.abs(r_safe))
            ) * r
            return m, _and_valid(valid, r != 0)
        raise ValueError(f"unknown arithmetic op {e.op}")

    def _eval_negate(self, e: Negate):
        if e.arg.dtype.is_long_decimal:
            raise _long_unsupported()
        d, v = self.eval(e.arg)
        return -d, v

    # -- comparisons -------------------------------------------------------

    def _cmp(self, op: str, l, r):
        if op == "=":
            return l == r
        if op in ("<>", "!="):
            return l != r
        if op == "<":
            return l < r
        if op == "<=":
            return l <= r
        if op == ">":
            return l > r
        if op == ">=":
            return l >= r
        raise ValueError(f"unknown comparison {op}")

    def _string_literal_compare(self, op: str, col: Expr, lit):
        """Compare a dictionary-typed expression against a string literal
        by id — an int32 compare (order-preserving dictionary)."""
        ids, valid = self.eval(col)
        if lit is None:  # NULL literal (e.g. empty scalar subquery)
            zeros = torch.zeros(ids.shape, dtype=torch.bool, device=self.device)
            return zeros, zeros
        d = self.dictionary_of(col)
        if op == "=":
            i = d.id_of(lit)
            res = (ids == i) if i >= 0 else torch.zeros(
                ids.shape, dtype=torch.bool, device=self.device
            )
        elif op in ("<>", "!="):
            i = d.id_of(lit)
            res = (ids != i) if i >= 0 else torch.ones(
                ids.shape, dtype=torch.bool, device=self.device
            )
        elif op == "<":
            res = ids < d.searchsorted(lit, "left")
        elif op == "<=":
            res = ids < d.searchsorted(lit, "right")
        elif op == ">":
            res = ids >= d.searchsorted(lit, "right")
        elif op == ">=":
            res = ids >= d.searchsorted(lit, "left")
        else:
            raise ValueError(op)
        return res, valid

    def _eval_compare(self, e: Compare):
        lt, rt = e.left.dtype, e.right.dtype
        if lt.is_string and isinstance(e.right, Literal):
            return self._string_literal_compare(e.op, e.left, e.right.value)
        if rt.is_string and isinstance(e.left, Literal):
            flip = {
                "<": ">", "<=": ">=", ">": "<", ">=": "<=",
                "=": "=", "<>": "<>", "!=": "!=",
            }
            return self._string_literal_compare(
                flip[e.op], e.right, e.left.value
            )
        if lt.is_long_decimal or rt.is_long_decimal:
            raise _long_unsupported()
        ld, lv = self.eval(e.left)
        rd, rv = self.eval(e.right)
        if lt.is_string and rt.is_string:
            # ids compare only within ONE dictionary: re-encode both
            # sides into the sorted union when they differ
            ldict = self.dictionary_of(e.left)
            rdict = self.dictionary_of(e.right)
            if ldict != rdict:
                _, (llut, rlut) = self._union_dicts((ldict, rdict))
                ld = self._remap(ld, llut)
                rd = self._remap(rd, rlut)
            return self._cmp(e.op, ld, rd), _and_valid(lv, rv)
        l, r, _ = _numeric_pair(e.left, e.right, ld, rd)
        return self._cmp(e.op, l, r), _and_valid(lv, rv)

    # -- boolean (Kleene three-valued) -------------------------------------

    def _eval_and(self, e: And):
        data, valid = None, None
        for t in e.terms:
            d, v = self.eval(t)
            if data is None:
                data, valid = d, v
                continue
            # three-valued AND: false dominates null
            new_valid = (
                None
                if valid is None and v is None
                else _tv_and_valid(data, valid, d, v)
            )
            data = data & d
            valid = new_valid
        return data, valid

    def _eval_or(self, e: Or):
        data, valid = None, None
        for t in e.terms:
            d, v = self.eval(t)
            if data is None:
                data, valid = d, v
                continue
            new_valid = (
                None
                if valid is None and v is None
                else _tv_or_valid(data, valid, d, v)
            )
            data = data | d
            valid = new_valid
        return data, valid

    def _eval_not(self, e: Not):
        d, v = self.eval(e.arg)
        return ~d, v

    def _eval_isnull(self, e: IsNull):
        _, v = self.eval(e.arg)
        res = self._zeros(torch.bool) if v is None else ~v
        if e.negate:
            res = ~res
        return res, None

    # -- conditional -------------------------------------------------------

    def _case_dicts(self, e: Case):
        """((union dictionary, per-branch LUTs), branch exprs) for a
        string-valued CASE: branches and the default re-encode into one
        sorted union."""
        args = [v for _, v in e.whens]
        if e.default is not None:
            args.append(e.default)
        return (
            self._union_dicts(
                tuple(self.dictionary_of(a) for a in args)
            ),
            args,
        )

    def _eval_case_string(self, e: Case):
        (_, luts), _args = self._case_dicts(e)
        conds = []
        vals = []
        for (c, v), lut in zip(e.whens, luts):
            cd, cv = self.eval(c)
            cd = cd & cv if cv is not None else cd
            vd, vv = self.eval(v)
            conds.append(cd)
            vals.append((self._remap(vd, lut), vv))
        if e.default is not None:
            dd, dv = self.eval(e.default)
            dd = self._remap(dd, luts[-1])
        else:
            dd = self._zeros(torch.int32)
            dv = self._zeros(torch.bool)
        out_d, out_v = dd, dv
        if out_v is None:
            out_v = self._ones_bool()
        for cd, (vd, vv) in zip(reversed(conds), reversed(vals)):
            out_d = torch.where(cd, vd, out_d)
            bv = vv if vv is not None else self._ones_bool()
            out_v = torch.where(cd, bv, out_v)
        return out_d, out_v

    def _eval_case(self, e: Case):
        if e.dtype.is_string:
            return self._eval_case_string(e)
        if e.dtype.is_long_decimal:
            raise _long_unsupported()
        # evaluate all branches, select first matching WHEN (SQL order)
        conds = []
        vals = []
        for c, v in e.whens:
            cd, cv = self.eval(c)
            cd = cd & cv if cv is not None else cd  # null cond = no match
            vd, vv = self.eval(v)
            conds.append(cd)
            vals.append((vd, vv))
        if e.default is not None:
            dd, dv = self.eval(e.default)
            dd = _coerce_to(dd, e.default.dtype, e.dtype)
        else:
            dd = self._zeros(e.dtype.torch_dtype)
            dv = self._zeros(torch.bool)
        out_d, out_v = dd, dv
        needs_valid = dv is not None or any(vv is not None for _, vv in vals)
        if needs_valid and out_v is None:
            out_v = self._ones_bool()
        branch_types = [v.dtype for _, v in e.whens]
        for cd, (vd, vv), bt in zip(
            reversed(conds), reversed(vals), reversed(branch_types)
        ):
            vd = _coerce_to(vd, bt, e.dtype)
            out_d = torch.where(cd, vd, out_d)
            if needs_valid:
                branch_v = vv if vv is not None else torch.ones(
                    cd.shape, dtype=torch.bool, device=self.device
                )
                out_v = torch.where(cd, branch_v, out_v)
        return out_d, (out_v if needs_valid else None)

    def _union_dicts(self, dicts):
        """(sorted union Dictionary, per-input id LUTs): the shared
        re-encode for string coalesce/CASE and cross-dictionary compares
        — sorted union ids preserve value order, so </> stay valid."""
        key = ("union",) + tuple(dicts)
        if key not in self._transform_cache:
            from presto_tpu_torch.page import Dictionary

            parts = [
                np.asarray(d.values, dtype=object) for d in dicts
            ]
            allv = (
                np.concatenate([p for p in parts if len(p)])
                if any(len(p) for p in parts)
                else np.array([], dtype=object)
            )
            uniq = (
                np.unique(allv.astype(str))
                if len(allv)
                else np.array([], dtype=str)
            )
            luts = [
                np.searchsorted(uniq, p.astype(str)).astype(np.int32)
                if len(p)
                else np.zeros(0, np.int32)
                for p in parts
            ]
            self._transform_cache[key] = (
                Dictionary(np.asarray(uniq, dtype=object)),
                luts,
            )
        return self._transform_cache[key]

    def _coalesce_dict(self, e: Coalesce):
        """(union dictionary, per-arg id LUTs) for string coalesce."""
        return self._union_dicts(
            tuple(self.dictionary_of(a) for a in e.args)
        )

    def _eval_coalesce(self, e: Coalesce):
        if e.dtype.is_string:
            _, luts = self._coalesce_dict(e)
            out_d = None
            out_v = None
            for a, lut in zip(e.args, luts):
                d, v = self.eval(a)
                d = self._remap(d, lut)
                if out_d is None:
                    out_d, out_v = d, v
                    continue
                if out_v is None:
                    break
                out_d = torch.where(out_v, out_d, d)
                out_v = out_v | (v if v is not None else True)
            return out_d, out_v
        if e.dtype.is_long_decimal:
            raise _long_unsupported()
        out_d, out_v = self.eval(e.args[0])
        out_d = _coerce_to(out_d, e.args[0].dtype, e.dtype)
        for a in e.args[1:]:
            if out_v is None:
                return out_d, None
            d, v = self.eval(a)
            d = _coerce_to(d, a.dtype, e.dtype)
            out_d = torch.where(out_v, out_d, d)
            out_v = out_v | (v if v is not None else True)
        return out_d, out_v

    def _eval_cast(self, e: Cast):
        d, v = self.eval(e.arg)
        src, dst = e.arg.dtype, e.to
        if src == dst:
            return d, v
        if src.is_long_decimal or dst.is_long_decimal:
            raise _long_unsupported()
        if dst.is_decimal:
            if src.is_decimal:
                return _rescale(d, src.scale, dst.scale), v
            if src.is_integer:
                return d.to(torch.int64) * (10 ** dst.scale), v
            if src.name in ("double", "real"):
                scaled = d.to(torch.float64) * (10 ** dst.scale)
                # half-up away from zero (torch.round is half-to-even)
                return (
                    torch.sign(scaled) * torch.floor(torch.abs(scaled) + 0.5)
                ).to(torch.int64), v
        if src.is_decimal:
            if dst.name in ("double", "real"):
                return (
                    d.to(torch.float64) / (10 ** src.scale)
                ).to(dst.torch_dtype), v
            if dst.is_integer:
                return _rescale(d, src.scale, 0).to(dst.torch_dtype), v
        return d.to(dst.torch_dtype), v

    # -- predicates --------------------------------------------------------

    def _eval_between(self, e: Between):
        lo = Compare(">=", e.arg, e.low)
        hi = Compare("<=", e.arg, e.high)
        d, v = self._eval_and(And((lo, hi)))
        return (~d if e.negate else d), v

    def _eval_inlist(self, e: InList):
        """Literal members only (a RuntimeParam member needs the plan
        cache, a later slice). A string argument gathers a membership LUT
        over its dictionary; a numeric one ORs one compare per member,
        each member cast to the argument's type as the reference does."""
        if not all(isinstance(lit, Literal) for lit in e.values):
            raise NotImplementedError(
                "IN list with non-literal members: later slice of the port"
            )
        data, valid = self.eval(e.arg)
        if e.arg.dtype.is_string:
            members = {lit.value for lit in e.values}
            lut = self.dictionary_of(e.arg).predicate_lut(
                lambda s: s in members
            )
            if not lut.any():
                res = self._zeros(torch.bool)
            else:
                res = self._lut(lut)[torch.clamp(data, 0, len(lut) - 1).long()]
        else:
            vals = np.asarray(
                [lit.value for lit in e.values], dtype=e.arg.dtype.np_dtype
            )
            res = self._zeros(torch.bool)
            for x in vals.tolist():
                res = res | (data == x)
        return (~res if e.negate else res), valid

    def _eval_param(self, e: Param):
        raise NotImplementedError(
            f"unbound scalar-subquery parameter ${e.param_id}: the executor "
            "must substitute Params before execution"
        )

    # -- dictionary functions (host LUT over the dictionary, device gather)

    def _dict_lut_eval(self, arg: Expr, fn):
        data, valid = self.eval(arg)
        lut = self.dictionary_of(arg).predicate_lut(fn)
        return self._gather_lut(lut, data, torch.bool), valid

    def _eval_like(self, e: Like):
        rx = like_to_regex(e.pattern)
        res, valid = self._dict_lut_eval(
            e.arg, lambda s: rx.match(s) is not None
        )
        return (~res if e.negate else res), valid

    def _eval_dictpredicate(self, e: DictPredicate):
        return self._dict_lut_eval(e.arg, e.fn)

    def _eval_dicttransform(self, e: DictTransform):
        data, valid = self.eval(e.arg)
        _, lut = self._transform(e)
        return self._gather_lut(lut, data, torch.int32), valid

    def _eval_dictcombine(self, e: DictCombine):
        dl, vl = self.eval(e.left)
        dr, vr = self.eval(e.right)
        nr = max(len(self.dictionary_of(e.right).values), 1)
        _, lut = self._combine(e)
        valid = _and_valid(vl, vr)
        if len(lut) == 0:
            return self._zeros(torch.int32), valid
        pair = (
            torch.clamp(dl.to(torch.int64), 0, len(lut) // nr - 1) * nr
            + torch.clamp(dr.to(torch.int64), 0, nr - 1)
        )
        return self._lut(lut)[pair], valid

    def _eval_inttodict(self, e: IntToDict):
        d, v = self.eval(e.arg)
        _, lut = self._int_to_dict(e)
        return self._gather_lut(lut, d.to(torch.int64) - e.lo, torch.int32), v

    def _eval_dictintfunc(self, e: DictIntFunc):
        data, valid = self.eval(e.arg)
        lut = np.asarray(
            [int(e.fn(v)) for v in self.dictionary_of(e.arg).values],
            dtype=np.int64,
        )
        return self._gather_lut(lut, data, torch.int64), valid

    # -- numeric functions --------------------------------------------------

    def _eval_mathfunc(self, e: MathFunc):
        d, v = self.eval(e.arg)
        at = e.arg.dtype
        if at.is_long_decimal:
            raise _long_unsupported()
        if e.func == "abs":
            return torch.abs(d), v
        if e.func == "sign":
            return _sign(d).to(e.dtype.torch_dtype), v
        if e.func in ("round", "truncate") and (
            at.is_integer or at.is_decimal
        ):
            if at.is_integer:
                return d, v  # already integral
            # decimal: round/truncate the unscaled value to 0 digits; the
            # result keeps the decimal type
            factor = 10 ** at.scale
            half = factor // 2 if e.func == "round" else 0
            q = _floordiv(torch.abs(d.to(torch.int64)) + half, factor)
            return torch.sign(d) * q * factor, v
        x = d.to(torch.float64)
        if at.is_decimal:
            x = x / (10 ** at.scale)
        tiny = float(np.finfo(np.float64).tiny)
        if e.func == "sqrt":
            return torch.sqrt(torch.clamp(x, min=0.0)), _and_valid(v, x >= 0)
        if e.func in ("ln", "log2", "log10"):
            out = torch.log(torch.clamp(x, min=tiny))
            if e.func != "ln":
                out = out / math.log(2.0 if e.func == "log2" else 10.0)
            return out, _and_valid(v, x > 0)
        if e.func == "exp":
            return torch.exp(x), v
        if e.func == "floor":
            return _to_i64(torch.floor(x)), v
        if e.func == "ceil":
            return _to_i64(torch.ceil(x)), v
        if e.func in ("round", "truncate"):
            # SQL half away from zero (torch.round is half to even)
            half = 0.5 if e.func == "round" else 0.0
            return _sign(x) * torch.floor(torch.abs(x) + half), v
        if e.func == "cbrt":
            return _cbrt(x), v
        if e.func in ("asin", "acos"):
            fn = torch.asin if e.func == "asin" else torch.acos
            return (
                fn(torch.clamp(x, -1.0, 1.0)),
                _and_valid(v, torch.abs(x) <= 1.0),
            )
        fn = {
            "sin": torch.sin, "cos": torch.cos, "tan": torch.tan,
            "atan": torch.atan, "sinh": torch.sinh, "cosh": torch.cosh,
            "tanh": torch.tanh,
        }.get(e.func)
        if fn is not None:
            return fn(x), v
        if e.func == "degrees":
            return x * (180.0 / math.pi), v
        if e.func == "radians":
            return x * (math.pi / 180.0), v
        raise NotImplementedError(f"math function {e.func}")

    def _eval_mathfunc2(self, e: MathFunc2):
        lt, rt = e.left.dtype, e.right.dtype
        if lt.is_long_decimal or rt.is_long_decimal:
            raise _long_unsupported()
        ld, lv = self.eval(e.left)
        rd, rv = self.eval(e.right)
        valid = _and_valid(lv, rv)
        x = ld.to(torch.float64)
        if lt.is_decimal:
            x = x / (10 ** lt.scale)
        y = rd.to(torch.float64)
        if rt.is_decimal:
            y = y / (10 ** rt.scale)
        if e.func == "power":
            return torch.pow(x, y), valid
        if e.func == "atan2":
            return torch.atan2(x, y), valid
        if e.func == "log":  # log(base, x)
            tiny = float(np.finfo(np.float64).tiny)
            out = torch.log(torch.clamp(y, min=tiny)) / torch.log(
                torch.clamp(x, min=tiny)
            )
            return out, _and_valid(valid, (x > 0) & (y > 0))
        if e.func in ("round", "truncate"):
            factor = torch.pow(10.0, y)
            scaled = x * factor
            half = 0.5 if e.func == "round" else 0.0
            out = _sign(scaled) * torch.floor(
                torch.abs(scaled) + half
            ) / factor
            if lt.is_integer:
                return _to_i64(out), valid
            if lt.is_decimal:
                return _to_i64(
                    _sign(out)
                    * torch.floor(torch.abs(out) * (10 ** lt.scale) + 0.5)
                ), valid
            return out, valid
        raise NotImplementedError(f"math function {e.func}")

    def _eval_valuehash(self, e: ValueHash):
        """splitmix64's finalizer folded to 32 bits, bit-equal to the
        reference's uint64 arithmetic: torch has no uint64 multiply or
        shift, so it runs in int64 (two's-complement products wrap the
        same way, constants >= 2^63 are written as their negative int64
        values, and a logical right shift masks off the sign fill)."""
        d, v = self.eval(e.arg)
        at = e.arg.dtype
        if at.is_long_decimal:
            raise _long_unsupported()
        if at.name in ("double", "real"):
            f = d.to(torch.float64)
            f = torch.where(f == 0, 0.0, f)  # +0.0 and -0.0 are SQL-equal
            x = f.view(torch.int64)
        else:
            x = d.to(torch.int64)
        z = x + _i64(0x9E3779B97F4A7C15)
        z = (z ^ _lsr(z, 30)) * _i64(0xBF58476D1CE4E5B9)
        z = (z ^ _lsr(z, 27)) * _i64(0x94D049BB133111EB)
        z = z ^ _lsr(z, 31)
        h = z & 0xFFFFFFFF
        if v is not None:
            h = torch.where(v, h, 0x9E3779B9)
        return h, None

    # -- dates ---------------------------------------------------------------

    def _eval_extract(self, e: Extract):
        d, v = self.eval(e.arg)
        if e.arg.dtype.name == "timestamp":
            d = _floordiv(d, _US_PER_DAY)
        y, m, day = _civil_from_days(d)
        f = e.field.lower()
        if f == "year":
            return y, v
        if f == "month":
            return m, v
        if f == "day":
            return day, v
        if f == "quarter":
            return _floordiv(m + 2, 3), v
        if f in ("day_of_week", "dow"):
            # ISO: 1 = Monday .. 7 = Sunday; epoch day 0 was a Thursday
            return torch.remainder(d + 3, 7) + 1, v
        if f in ("day_of_year", "doy"):
            one = torch.ones_like(y)
            return d - _days_from_civil(y, one, one) + 1, v
        if f == "week":
            # ISO week number of the ISO year holding the date
            thursday = d - torch.remainder(d + 3, 7) + 3
            ty, _, _ = _civil_from_days(thursday)
            one = torch.ones_like(ty)
            jan1 = _days_from_civil(ty, one, one)
            return _floordiv(thursday - jan1, 7) + 1, v
        raise NotImplementedError(f"extract({e.field})")

    def _eval_datetrunc(self, e: DateTrunc):
        d, v = self.eval(e.arg)
        unit = e.unit
        is_ts = e.arg.dtype.name == "timestamp"
        days = d
        if is_ts:
            sub_day = {"hour": 3_600_000_000, "minute": 60_000_000,
                       "second": 1_000_000}
            if unit in sub_day:
                q = sub_day[unit]
                return _floordiv(d, q) * q, v
            days = _floordiv(d, _US_PER_DAY)
        if unit == "day":
            out_days = days
        elif unit == "week":
            # epoch day 0 = Thursday; Monday-start ISO weeks
            out_days = days - torch.remainder(days + 3, 7)
        else:
            y, m, _ = _civil_from_days(days)
            one = torch.ones_like(y)
            if unit == "month":
                out_days = _days_from_civil(y, m, one)
            elif unit == "quarter":
                out_days = _days_from_civil(
                    y, _floordiv(m - 1, 3) * 3 + 1, one
                )
            elif unit == "year":
                out_days = _days_from_civil(y, one, one)
            else:
                raise NotImplementedError(f"date_trunc({unit})")
        if is_ts:
            return out_days * _US_PER_DAY, v
        return out_days.to(e.arg.dtype.torch_dtype), v

    def _eval_dateadd(self, e: DateAdd):
        nd, nv = self.eval(e.n)
        d, v = self.eval(e.arg)
        valid = _and_valid(nv, v)
        n = nd.to(torch.int64)
        is_ts = e.arg.dtype.name == "timestamp"
        days = _floordiv(d, _US_PER_DAY) if is_ts else d
        if e.unit in ("day", "week"):
            out_days = days + n * (7 if e.unit == "week" else 1)
        else:
            months = n * (12 if e.unit == "year" else 1)
            y, m, day = _civil_from_days(days)
            total = y * 12 + (m - 1) + months
            y2 = _floordiv(total, 12)
            m2 = total - y2 * 12 + 1
            one = torch.ones_like(y2)
            first = _days_from_civil(y2, m2, one)
            dec = m2 == 12
            nxt = _days_from_civil(
                y2 + dec.to(torch.int64), torch.where(dec, 1, m2 + 1), one
            )
            # the day of month clamps to the target month's length
            out_days = first + torch.minimum(day, nxt - first) - 1
        if is_ts:
            return out_days * _US_PER_DAY + (d - days * _US_PER_DAY), valid
        return out_days.to(e.arg.dtype.torch_dtype), valid


def _maybe_zero(e: Expr) -> bool:
    return not (isinstance(e, Literal) and e.value not in (0, None))


def _tv_and_valid(ld, lv, rd, rv):
    """Validity of (l AND r): known iff both known, or either is known-false."""
    lk = lv if lv is not None else True
    rk = rv if rv is not None else True
    known_false = ((ld == False) & lk) | ((rd == False) & rk)  # noqa: E712
    return (lk & rk) | known_false


def _tv_or_valid(ld, lv, rd, rv):
    lk = lv if lv is not None else True
    rk = rv if rv is not None else True
    known_true = (ld & lk) | (rd & rk)
    return (lk & rk) | known_true


def _coerce_to(data, from_t: T.DataType, to_t: T.DataType):
    if from_t == to_t:
        return data
    if to_t.is_long_decimal or from_t.is_long_decimal:
        raise _long_unsupported()
    if to_t.is_decimal and from_t.is_decimal:
        return _rescale(data, from_t.scale, to_t.scale)
    if to_t.is_decimal and from_t.is_integer:
        return data.to(torch.int64) * (10 ** to_t.scale)
    return data.to(to_t.torch_dtype)


def eval_expr(expr: Expr, page: Page):
    """Lower ``expr`` over ``page`` -> (data, valid|None)."""
    return ExprLowerer(page).eval(expr)


def eval_predicate(expr: Expr, page: Page) -> torch.Tensor:
    """Predicate as a keep-mask over live rows: NULL -> False (SQL WHERE),
    padding rows -> False."""
    d, v = eval_expr(expr, page)
    mask = d if v is None else (d & v)
    return mask & page.row_mask()
