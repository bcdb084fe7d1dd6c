"""SQL type system.

Reference parity: ``presto-common`` ``Type`` / ``TypeSignature`` hierarchy
(BigintType ... DecimalType, VarcharType, ArrayType/MapType/RowType) —
SURVEY.md §2.1 "Type system".

TPU-first design decisions (SURVEY.md §7 step 1):

- Every SQL type maps to a fixed-width device representation so that all
  pages are static-shape JAX arrays:

    BIGINT            -> int64
    INTEGER           -> int32
    SMALLINT/TINYINT  -> int32 (widened on device; narrowing on output)
    DOUBLE / REAL     -> float64 / float32
    BOOLEAN           -> bool
    DATE              -> int32  (days since 1970-01-01, like the reference)
    TIMESTAMP         -> int64  (microseconds since epoch)
    DECIMAL(p<=18, s) -> int64  (unscaled value; exact arithmetic)
    DECIMAL(p>18, s)  -> int64 pair (hi, lo) — emulated int128 (future);
                         round 1 gates p<=18 which covers all of TPC-H
    VARCHAR / CHAR    -> int32 dictionary ids + host-side order-preserving
                         dictionary (see presto_tpu.page.Dictionary)

- Types are immutable, interned value objects; they are *static* metadata
  (never traced), safe to hash into jit cache keys.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import numpy as np

#: the numpy twin of each device dtype (host staging and materialization)
_NP_OF_TORCH = {
    torch.int64: np.int64,
    torch.int32: np.int32,
    torch.float64: np.float64,
    torch.float32: np.float32,
    torch.bool: np.bool_,
}


@dataclasses.dataclass(frozen=True)
class DataType:
    """Base SQL type. Frozen/hashable: types are static jit-cache metadata."""

    name: str

    @property
    def torch_dtype(self):
        raise NotImplementedError

    @property
    def np_dtype(self):
        return np.dtype(_NP_OF_TORCH[self.torch_dtype])

    @property
    def is_numeric(self) -> bool:
        return False

    @property
    def is_integer(self) -> bool:
        return False

    @property
    def is_string(self) -> bool:
        return False

    @property
    def is_decimal(self) -> bool:
        return False

    @property
    def is_long_decimal(self) -> bool:
        return False

    @property
    def is_array(self) -> bool:
        return False

    @property
    def is_map(self) -> bool:
        return False

    @property
    def is_row(self) -> bool:
        return False

    @property
    def is_nested(self) -> bool:
        """array/map/row — types whose blocks carry offsets/children."""
        return self.is_array or self.is_map or self.is_row

    def __str__(self) -> str:
        return self.name


@dataclasses.dataclass(frozen=True)
class BigintType(DataType):
    name: str = "bigint"

    @property
    def torch_dtype(self):
        return torch.int64

    @property
    def is_numeric(self):
        return True

    @property
    def is_integer(self):
        return True


@dataclasses.dataclass(frozen=True)
class IntegerType(DataType):
    name: str = "integer"

    @property
    def torch_dtype(self):
        return torch.int32

    @property
    def is_numeric(self):
        return True

    @property
    def is_integer(self):
        return True


@dataclasses.dataclass(frozen=True)
class DoubleType(DataType):
    name: str = "double"

    @property
    def torch_dtype(self):
        return torch.float64

    @property
    def is_numeric(self):
        return True


@dataclasses.dataclass(frozen=True)
class RealType(DataType):
    name: str = "real"

    @property
    def torch_dtype(self):
        return torch.float32

    @property
    def is_numeric(self):
        return True


@dataclasses.dataclass(frozen=True)
class BooleanType(DataType):
    name: str = "boolean"

    @property
    def torch_dtype(self):
        return torch.bool


@dataclasses.dataclass(frozen=True)
class DateType(DataType):
    """Days since 1970-01-01 (matches the reference's DateType encoding)."""

    name: str = "date"

    @property
    def torch_dtype(self):
        return torch.int32

    @property
    def is_numeric(self):
        return False


@dataclasses.dataclass(frozen=True)
class TimestampType(DataType):
    """Microseconds since epoch."""

    name: str = "timestamp"

    @property
    def torch_dtype(self):
        return torch.int64


@dataclasses.dataclass(frozen=True)
class DecimalType(DataType):
    """Exact decimal as an unscaled int64 (short decimal path).

    Reference parity: presto-common DecimalType; short decimals (p<=18) are
    long-backed there too, long decimals (p<=38) are int128-backed (future
    round: int64-pair emulation; TPC-H needs only p<=15).
    """

    precision: int = 38
    scale: int = 0
    name: str = "decimal"

    def __post_init__(self):
        object.__setattr__(
            self, "name", f"decimal({self.precision},{self.scale})"
        )
        if self.precision > 18:
            raise ValueError(
                "DecimalType is the short-decimal (p<=18) path; use "
                "T.decimal(), which routes p>18 to LongDecimalType"
            )

    @property
    def torch_dtype(self):
        return torch.int64

    @property
    def is_numeric(self):
        return True

    @property
    def is_decimal(self):
        return True


@dataclasses.dataclass(frozen=True)
class LongDecimalType(DataType):
    """decimal(19..38, s): emulated int128 (reference parity:
    presto-common long DecimalType, Int128-backed).

    Physical layout: the block's data array has shape ``(capacity, 2)``
    int64 — column 0 the signed high limb, column 1 the low 64 bits
    (unsigned, stored in an int64 bit pattern); value = hi*2^64 + lo.
    All limb arithmetic lives in ``presto_tpu.int128`` and runs inside
    jit (static shapes, pure int64/uint64 ops — nothing the MXU/VPU
    can't chew).

    Supported surface this round: scans (parquet/ORC/memory/pylist),
    comparisons, +/-/negate, casts (short<->long incl. half-up
    downscale via int128 division, ->double, ->bigint), projection and
    exact host materialization (``decimal.Decimal``).
    Documented deviation: long decimals as GROUP BY / join / sort keys
    and as aggregate inputs raise PlanningError — cast to
    decimal(18,s) or double to aggregate (no benchmark config needs a
    >18-digit key; see COMPONENTS.md type-system row).
    """

    precision: int = 38
    scale: int = 0
    name: str = "decimal"

    def __post_init__(self):
        object.__setattr__(
            self, "name", f"decimal({self.precision},{self.scale})"
        )
        if not (18 < self.precision <= 38):
            raise ValueError(
                f"LongDecimalType precision must be in 19..38, got "
                f"{self.precision}"
            )

    @property
    def torch_dtype(self):
        return torch.int64

    @property
    def is_numeric(self):
        return True

    @property
    def is_decimal(self):
        return True

    @property
    def is_long_decimal(self):
        return True


@dataclasses.dataclass(frozen=True)
class VarcharType(DataType):
    """Dictionary-encoded string: device arrays hold int32 dictionary ids.

    The dictionary itself (presto_tpu.page.Dictionary) lives host-side and
    is order-preserving (ids sorted by string value), so <, <=, =, >=, >
    on ids agree with string comparison within one dictionary.
    """

    length: Optional[int] = None  # None = unbounded
    name: str = "varchar"

    def __post_init__(self):
        if self.length is not None:
            object.__setattr__(self, "name", f"varchar({self.length})")

    @property
    def torch_dtype(self):
        return torch.int32

    @property
    def is_string(self):
        return True


# Interned singletons — reference parity with presto-common's static
# instances (BigintType.BIGINT etc.).
BIGINT = BigintType()
INTEGER = IntegerType()
DOUBLE = DoubleType()
REAL = RealType()
BOOLEAN = BooleanType()
DATE = DateType()
TIMESTAMP = TimestampType()
VARCHAR = VarcharType()


def decimal(precision: int, scale: int) -> DataType:
    """decimal(p,s) — int64-backed for p<=18, int128 limb pair beyond."""
    if precision > 18:
        return LongDecimalType(precision=precision, scale=scale)
    return DecimalType(precision=precision, scale=scale)


def long_decimal(precision: int, scale: int) -> LongDecimalType:
    return LongDecimalType(precision=precision, scale=scale)


def int128_limbs(unscaled) -> np.ndarray:
    """Python ints -> (n, 2) int64 limb array [hi, lo] (lo = low 64
    bits as an int64 bit pattern)."""
    vals = [int(v) for v in unscaled]
    lo = np.asarray(
        [(v & 0xFFFFFFFFFFFFFFFF) - (1 << 64) if (v & (1 << 63)) else
         (v & 0xFFFFFFFFFFFFFFFF) for v in vals],
        dtype=np.int64,
    )
    hi = np.asarray([v >> 64 for v in vals], dtype=np.int64)
    return np.stack([hi, lo], axis=1)


def int128_value(hi: int, lo: int) -> int:
    """Limb pair -> python int (lo re-read as unsigned)."""
    return (int(hi) << 64) + (int(lo) & 0xFFFFFFFFFFFFFFFF)


def varchar(length: Optional[int] = None) -> VarcharType:
    return VarcharType(length=length)


_BY_NAME = {
    "bigint": BIGINT,
    "integer": INTEGER,
    "int": INTEGER,
    "double": DOUBLE,
    "real": REAL,
    "boolean": BOOLEAN,
    "date": DATE,
    "timestamp": TIMESTAMP,
    "varchar": VARCHAR,
}


@dataclasses.dataclass(frozen=True)
class ArrayType(DataType):
    """array(T) — physical array columns (reference: ArrayType).

    Device representation (SURVEY.md §2.1 "Block/Page data model"): an
    offsets int32 array (capacity+1) over a flat child values array
    (``Block.offsets``/``Block.data``); per-row validity as usual.
    """

    element: DataType = None  # type: ignore[assignment]
    name: str = "array"

    @property
    def torch_dtype(self):
        # the VALUES child array's dtype (offsets are always int32)
        return self.element.torch_dtype

    @property
    def is_array(self) -> bool:
        return True

    def __str__(self) -> str:
        return f"array({self.element})"


def array(element: DataType) -> ArrayType:
    return ArrayType(element=element)


@dataclasses.dataclass(frozen=True)
class MapType(DataType):
    """map(K, V) — physical map columns (reference: MapType /
    MapBlock, SURVEY.md §2.1 "Type system").

    Device representation: an int32 offsets array (capacity+1) shared
    by TWO flat child blocks — keys and values (``Block.children``);
    row i's entries are ``keys[offsets[i]:offsets[i+1]]`` zipped with
    the same span of values. Per-row validity as usual. Key lookup is
    a flat segment-max scan (expr.MapSubscript) — branch-free, one
    pass over the values axis."""

    key: DataType = None  # type: ignore[assignment]
    value: DataType = None  # type: ignore[assignment]
    name: str = "map"

    @property
    def torch_dtype(self):
        raise TypeError("map columns have no single dtype (children)")

    @property
    def is_map(self) -> bool:
        return True

    def __str__(self) -> str:
        return f"map({self.key},{self.value})"


@dataclasses.dataclass(frozen=True)
class RowType(DataType):
    """row(f1 T1, ..., fk Tk) — physical struct columns (reference:
    RowType / RowBlock, SURVEY.md §2.1 "Type system").

    Device representation: one child block per field, all at the row
    capacity (``Block.children``, shredded layout — the columnar form
    parquet/ORC use for structs); per-row validity on the parent.
    Field access (expr.RowFieldAccess) is a zero-copy child select."""

    fields: tuple = ()  # ((name, DataType), ...)
    name: str = "row"

    @property
    def torch_dtype(self):
        raise TypeError("row columns have no single dtype (children)")

    @property
    def is_row(self) -> bool:
        return True

    def field_index(self, name: str) -> int:
        for i, (n, _) in enumerate(self.fields):
            if n.lower() == name.lower():
                return i
        raise KeyError(name)

    def __str__(self) -> str:
        inner = ", ".join(f"{n} {t}" for n, t in self.fields)
        return f"row({inner})"


def map_(key: DataType, value: DataType) -> MapType:
    return MapType(key=key, value=value)


def row(*fields) -> RowType:
    """row(("a", BIGINT), ("b", VARCHAR)) or row(a=BIGINT, ...) via
    tuple pairs."""
    return RowType(fields=tuple((n, t) for n, t in fields))


def parse_type(text: str) -> DataType:
    """Parse a SQL type string, e.g. ``decimal(12,2)`` or ``varchar(25)``."""
    t = text.strip().lower()
    if t in _BY_NAME:
        return _BY_NAME[t]
    if t in ("decimal", "char"):  # bare forms: SQL defaults
        return decimal(18, 0) if t == "decimal" else varchar(1)
    if t.startswith("decimal(") and t.endswith(")"):
        inner = t[len("decimal(") : -1]
        p, s = (int(x) for x in inner.split(","))
        return decimal(p, s)
    if (t.startswith("varchar(") or t.startswith("char(")) and t.endswith(")"):
        inner = t[t.index("(") + 1 : -1]
        return varchar(int(inner))
    if t.startswith("array(") and t.endswith(")"):
        return array(parse_type(t[len("array(") : -1]))
    if t.startswith("map(") and t.endswith(")"):
        parts = _split_top(t[len("map(") : -1])
        if len(parts) != 2:
            raise ValueError(f"map type needs key,value: {text}")
        return map_(parse_type(parts[0]), parse_type(parts[1]))
    if t.startswith("row(") and t.endswith(")"):
        fields = []
        for p in _split_top(t[len("row(") : -1]):
            p = p.strip()
            sp = p.find(" ")
            if sp < 0:
                raise ValueError(f"row field needs 'name type': {p}")
            fields.append((p[:sp], parse_type(p[sp + 1 :])))
        return RowType(fields=tuple(fields))
    raise ValueError(f"unknown type: {text}")


def _split_top(s: str) -> list:
    """Split on commas at paren depth 0."""
    parts, depth, cur = [], 0, []
    for ch in s:
        if ch == "(":
            depth += 1
        elif ch == ")":
            depth -= 1
        if ch == "," and depth == 0:
            parts.append("".join(cur).strip())
            cur = []
        else:
            cur.append(ch)
    if cur or parts:
        parts.append("".join(cur).strip())
    return parts


# --- coercion lattice (reference: presto-common TypeCoercion) -------------

_NUMERIC_ORDER = ["integer", "bigint", "real", "double"]


def common_super_type(a: DataType, b: DataType) -> DataType:
    """Least common type two operands coerce to (simplified lattice)."""
    if a == b:
        return a
    if a.is_decimal and b.is_decimal:
        scale = max(a.scale, b.scale)
        intd = max(a.precision - a.scale, b.precision - b.scale)
        # p>18 routes to LongDecimalType via decimal(); cap at the
        # int128 ceiling like the reference caps at 38
        return decimal(min(intd + scale, 38), scale)
    if a.is_decimal and b.is_integer:
        # widen integer digits to the representation ceiling; precision
        # is capacity-advisory (arithmetic runs on int64 / int128 limbs)
        return decimal(38 if a.is_long_decimal else 18, a.scale)
    if b.is_decimal and a.is_integer:
        return decimal(38 if b.is_long_decimal else 18, b.scale)
    if a.is_decimal and b.name == "double":
        return DOUBLE
    if b.is_decimal and a.name == "double":
        return DOUBLE
    if a.is_numeric and b.is_numeric:
        ia = _NUMERIC_ORDER.index(a.name)
        ib = _NUMERIC_ORDER.index(b.name)
        return _BY_NAME[_NUMERIC_ORDER[max(ia, ib)]]
    if a.is_string and b.is_string:
        return VARCHAR
    if {a.name, b.name} == {"date", "timestamp"}:
        return TIMESTAMP
    raise TypeError(f"no common type for {a} and {b}")
