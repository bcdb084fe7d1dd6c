"""TPC-H connector: deterministic data generated on the fly.

Reference parity: ``presto-tpch`` — data derived from the scale factor at
scan time, zero stored bytes, so every correctness suite can assert exact
results (SURVEY.md §2.2, §4.4). Schemas ``tiny`` (SF0.01), ``sf1``,
``sf10``, ``sf100`` like the reference.

TPU-first redesign of dbgen: every column is a *closed-form function of
the row index* — splitmix64 streams for values, arithmetic bijections for
key relationships (lineitem row -> (order, linenumber) in O(1) via the
7-line cycle closed form). This makes any split [row_start, row_end)
generatable independently, vectorized in numpy, with no sequential RNG
state (the property the reference gets from per-split dbgen seeds).
Varchar columns emit dictionary ids + the (sorted) dictionary directly —
strings never materialise per row, which makes scan staging pure numeric
work (SURVEY.md §7 "Strings on TPU").

Distributions are TPC-H-shaped (official ranges, FK validity, the
partsupp supplier formula, Q-relevant patterns like 'special requests'
comments and BRASS part types) but not bit-identical to dbgen: the
verifier (presto_tpu.verifier) asserts correctness against a CPU oracle
over the SAME generated data, per BASELINE.md's measurement protocol.
"""

from __future__ import annotations

import dataclasses
import datetime
import functools
from typing import Dict, List, Optional, Sequence

import numpy as np

from presto_tpu_torch import native
from presto_tpu_torch import types as T
from presto_tpu_torch.connectors.spi import (
    ColumnStats,
    Connector,
    ConnectorMetadata,
    ConnectorSplit,
    SplitSource,
    TableHandle,
    TableStats,
)


@dataclasses.dataclass
class DictColumn:
    """Pre-encoded varchar column: int32 ids into a sorted dictionary."""

    ids: np.ndarray  # int32
    values: np.ndarray  # sorted unique strings


SCHEMAS = {"tiny": 0.01, "sf1": 1.0, "sf10": 10.0, "sf100": 100.0}

_EPOCH = datetime.date(1970, 1, 1)


def _day(y, m, d):
    return (datetime.date(y, m, d) - _EPOCH).days


STARTDATE = _day(1992, 1, 1)
ENDDATE = _day(1998, 8, 2)
CURRENTDATE = _day(1995, 6, 17)

# ---------------------------------------------------------- random streams

_M1 = np.uint64(0xBF58476D1CE4E5B9)
_M2 = np.uint64(0x94D049BB133111EB)


def _mix(x: np.ndarray) -> np.ndarray:
    x = (x ^ (x >> np.uint64(30))) * _M1
    x = (x ^ (x >> np.uint64(27))) * _M2
    return x ^ (x >> np.uint64(31))


def _stream(tag: int, idx: np.ndarray) -> np.ndarray:
    """Deterministic uint64 stream keyed by (column tag, row index)."""
    tag_key = (tag * 0xD1B54A32D192ED03 + 0x632BE59BD9B4E019) % (1 << 64)
    return _mix(
        idx.astype(np.uint64) * np.uint64(0x9E3779B97F4A7C15)
        ^ np.uint64(tag_key)
    )


def _uniform(tag: int, idx: np.ndarray, lo: int, hi: int) -> np.ndarray:
    """Uniform integers in [lo, hi] (inclusive). Affine index runs of
    ``native.GEN_MIN_ROWS`` rows or more go through the fused C++ loop
    (bit-equal); everything else, and a host without a compiler, takes
    the vectorized numpy path."""
    out = native.gen_uniform(tag, idx, lo, hi)
    if out is not None:
        return out
    span = (_stream(tag, idx) % np.uint64(hi - lo + 1)).astype(np.int64)
    return lo + span


# ---------------------------------------------------------- word material

REGIONS = ["AFRICA", "AMERICA", "ASIA", "EUROPE", "MIDDLE EAST"]
NATIONS = [
    ("ALGERIA", 0), ("ARGENTINA", 1), ("BRAZIL", 1), ("CANADA", 1),
    ("EGYPT", 4), ("ETHIOPIA", 0), ("FRANCE", 3), ("GERMANY", 3),
    ("INDIA", 2), ("INDONESIA", 2), ("IRAN", 4), ("IRAQ", 4),
    ("JAPAN", 2), ("JORDAN", 4), ("KENYA", 0), ("MOROCCO", 0),
    ("MOZAMBIQUE", 0), ("PERU", 1), ("CHINA", 2), ("ROMANIA", 3),
    ("SAUDI ARABIA", 4), ("VIETNAM", 2), ("RUSSIA", 3),
    ("UNITED KINGDOM", 3), ("UNITED STATES", 1),
]
SEGMENTS = ["AUTOMOBILE", "BUILDING", "FURNITURE", "HOUSEHOLD", "MACHINERY"]
PRIORITIES = ["1-URGENT", "2-HIGH", "3-MEDIUM", "4-NOT SPECIFIED", "5-LOW"]
SHIPMODES = ["AIR", "FOB", "MAIL", "RAIL", "REG AIR", "SHIP", "TRUCK"]
INSTRUCTIONS = [
    "COLLECT COD", "DELIVER IN PERSON", "NONE", "TAKE BACK RETURN",
]
TYPE_S1 = ["STANDARD", "SMALL", "MEDIUM", "LARGE", "ECONOMY", "PROMO"]
TYPE_S2 = ["ANODIZED", "BURNISHED", "PLATED", "POLISHED", "BRUSHED"]
TYPE_S3 = ["TIN", "NICKEL", "BRASS", "STEEL", "COPPER"]
CONTAINER_S1 = ["SM", "LG", "MED", "JUMBO", "WRAP"]
CONTAINER_S2 = ["CASE", "BOX", "BAG", "JAR", "PKG", "PACK", "CAN", "DRUM"]
COLORS = [
    "almond", "antique", "aquamarine", "azure", "beige", "bisque", "black",
    "blanched", "blue", "blush", "brown", "burlywood", "burnished",
    "chartreuse", "chiffon", "chocolate", "coral", "cornflower",
    "cornsilk", "cream", "cyan", "dark", "deep", "dim", "dodger", "drab",
    "firebrick", "floral", "forest", "frosted", "gainsboro", "ghost",
    "goldenrod", "green", "grey", "honeydew", "hot", "indian", "ivory",
    "khaki", "lace", "lavender", "lawn", "lemon", "light", "lime",
    "linen", "magenta", "maroon", "medium", "metallic", "midnight",
    "mint", "misty", "moccasin", "navajo", "navy", "olive", "orange",
    "orchid", "pale", "papaya", "peach", "peru", "pink", "plum", "powder",
    "puff", "purple", "red", "rose", "rosy", "royal", "saddle", "salmon",
    "sandy", "seashell", "sienna", "sky", "slate", "smoke", "snow",
    "spring", "steel", "tan", "thistle", "tomato", "turquoise", "violet",
    "wheat", "white", "yellow",
]
# comment vocabulary: Q13 greps '%special%requests%', Q16 greps
# '%Customer%Complaints%' — both reachable by construction
COMMENT_W1 = [
    "carefully", "quickly", "furiously", "slyly", "blithely", "special",
    "express", "regular", "final", "pending", "ironic", "bold", "even",
    "silent", "unusual", "Customer",
]
COMMENT_W2 = [
    "packages", "deposits", "requests", "accounts", "instructions",
    "foxes", "pinto beans", "theodolites", "dependencies", "excuses",
    "platelets", "ideas", "Complaints", "asymptotes", "dugouts",
    "sheaves",
]
COMMENT_W3 = [
    "sleep", "haggle", "nag", "wake", "cajole", "detect", "integrate",
    "use", "boost", "doze", "engage", "affix", "dazzle", "snooze",
    "breach", "unwind",
]


def _combo_dictionary(*lists: Sequence[str]):
    """All cross-product phrases, sorted; plus the rank lookup table
    mapping raw combo index -> sorted dictionary id."""
    phrases = []
    for a in lists[0]:
        if len(lists) == 1:
            phrases.append(a)
            continue
        for b in lists[1]:
            if len(lists) == 2:
                phrases.append(f"{a} {b}")
            else:
                for c in lists[2]:
                    phrases.append(f"{a} {b} {c}")
    arr = np.asarray(phrases, dtype=object)
    order = np.argsort(arr.astype(str), kind="stable")
    rank = np.empty(len(arr), dtype=np.int32)
    rank[order] = np.arange(len(arr), dtype=np.int32)
    return arr[order], rank


class _LazyCombo:
    """Combo dictionary built once on first use (hundreds of kB)."""

    def __init__(self, *lists):
        self.lists = lists
        self._built = None

    def get(self):
        if self._built is None:
            self._built = _combo_dictionary(*self.lists)
        return self._built

    def column(self, tag: int, idx: np.ndarray) -> DictColumn:
        values, rank = self.get()
        sizes = [len(l) for l in self.lists]
        total = int(np.prod(sizes))
        raw = (_stream(tag, idx) % np.uint64(total)).astype(np.int64)
        return DictColumn(ids=rank[raw], values=values)


_COMMENTS = _LazyCombo(COMMENT_W1, COMMENT_W2, COMMENT_W3)
_P_NAME = _LazyCombo(COLORS, COLORS)
_P_TYPE = _LazyCombo(TYPE_S1, TYPE_S2, TYPE_S3)
_CONTAINERS = _LazyCombo(CONTAINER_S1, CONTAINER_S2)


def _numbered(prefix: str, count: int, keys: np.ndarray) -> DictColumn:
    """'Customer#000000001'-style names: zero-padded => sorted order is
    numeric order, so ids are just key-1 (no string materialisation for
    the ids). Every split of a table shares one dictionary object."""
    return DictColumn(
        ids=(keys - 1).astype(np.int32), values=_numbered_values(prefix, count)
    )


@functools.lru_cache(maxsize=4)
def _numbered_values(prefix: str, count: int) -> np.ndarray:
    """The dictionary of ``_numbered``, built once per (prefix, count):
    at SF100 the customer names are 15,000,000 strings, which every
    split would otherwise format again."""
    return np.asarray(
        [f"{prefix}#{i + 1:09d}" for i in range(count)], dtype=object
    )


def _fixed(values: Sequence[str], picks: np.ndarray) -> DictColumn:
    arr = np.asarray(values, dtype=object)
    order = np.argsort(arr.astype(str), kind="stable")
    rank = np.empty(len(arr), dtype=np.int32)
    rank[order] = np.arange(len(arr), dtype=np.int32)
    return DictColumn(ids=rank[picks.astype(np.int64)], values=arr[order])


# ------------------------------------------------------------- row counts


def _counts(sf: float) -> Dict[str, int]:
    orders = int(1_500_000 * sf)
    return {
        "region": 5,
        "nation": 25,
        "supplier": max(int(10_000 * sf), 1),
        "customer": max(int(150_000 * sf), 1),
        "part": max(int(200_000 * sf), 1),
        "partsupp": max(int(200_000 * sf), 1) * 4,
        "orders": max(orders, 1),
        "lineitem": _lineitem_count(max(orders, 1)),
    }


def _lineitem_count(n_orders: int) -> int:
    """Lines per order cycle 1..7 => closed form."""
    full, rem = divmod(n_orders, 7)
    return full * 28 + rem * (rem + 1) // 2


_CYCLE_BOUNDS = np.array([0, 1, 3, 6, 10, 15, 21, 28], dtype=np.int64)


def _lineitem_order(rows: np.ndarray):
    """Global lineitem row -> (order index 0-based, linenumber 1-based)."""
    cyc, rr = np.divmod(rows, 28)
    j = np.searchsorted(_CYCLE_BOUNDS, rr, side="right") - 1
    order_idx = cyc * 7 + j
    linenumber = rr - _CYCLE_BOUNDS[j] + 1
    return order_idx, linenumber


# --------------------------------------------------------------- schemas

D12_2 = T.decimal(12, 2)

TABLE_SCHEMAS: Dict[str, Dict[str, T.DataType]] = {
    "region": {
        "r_regionkey": T.INTEGER,
        "r_name": T.VARCHAR,
        "r_comment": T.VARCHAR,
    },
    "nation": {
        "n_nationkey": T.INTEGER,
        "n_name": T.VARCHAR,
        "n_regionkey": T.INTEGER,
        "n_comment": T.VARCHAR,
    },
    "supplier": {
        "s_suppkey": T.INTEGER,
        "s_name": T.VARCHAR,
        "s_address": T.VARCHAR,
        "s_nationkey": T.INTEGER,
        "s_phone": T.VARCHAR,
        "s_acctbal": D12_2,
        "s_comment": T.VARCHAR,
    },
    "customer": {
        "c_custkey": T.INTEGER,
        "c_name": T.VARCHAR,
        "c_address": T.VARCHAR,
        "c_nationkey": T.INTEGER,
        "c_phone": T.VARCHAR,
        "c_acctbal": D12_2,
        "c_mktsegment": T.VARCHAR,
        "c_comment": T.VARCHAR,
    },
    "part": {
        "p_partkey": T.INTEGER,
        "p_name": T.VARCHAR,
        "p_mfgr": T.VARCHAR,
        "p_brand": T.VARCHAR,
        "p_type": T.VARCHAR,
        "p_size": T.INTEGER,
        "p_container": T.VARCHAR,
        "p_retailprice": D12_2,
        "p_comment": T.VARCHAR,
    },
    "partsupp": {
        "ps_partkey": T.INTEGER,
        "ps_suppkey": T.INTEGER,
        "ps_availqty": T.INTEGER,
        "ps_supplycost": D12_2,
        "ps_comment": T.VARCHAR,
    },
    "orders": {
        "o_orderkey": T.INTEGER,
        "o_custkey": T.INTEGER,
        "o_orderstatus": T.VARCHAR,
        "o_totalprice": D12_2,
        "o_orderdate": T.DATE,
        "o_orderpriority": T.VARCHAR,
        "o_clerk": T.VARCHAR,
        "o_shippriority": T.INTEGER,
        "o_comment": T.VARCHAR,
    },
    "lineitem": {
        "l_orderkey": T.INTEGER,
        "l_partkey": T.INTEGER,
        "l_suppkey": T.INTEGER,
        "l_linenumber": T.INTEGER,
        "l_quantity": D12_2,
        "l_extendedprice": D12_2,
        "l_discount": D12_2,
        "l_tax": D12_2,
        "l_returnflag": T.VARCHAR,
        "l_linestatus": T.VARCHAR,
        "l_shipdate": T.DATE,
        "l_commitdate": T.DATE,
        "l_receiptdate": T.DATE,
        "l_shipinstruct": T.VARCHAR,
        "l_shipmode": T.VARCHAR,
        "l_comment": T.VARCHAR,
    },
}

# NOTE: keys are INTEGER (32-bit) rather than the reference's BIGINT — a
# deliberate narrowing (max orderkey at SF100 ≈ 6e8 < 2^31) that keeps
# two-column join keys bijectively packable into int64 (ops.join).


# ------------------------------------------------------------ generators


def _retailprice(partkey: np.ndarray) -> np.ndarray:
    return 90000 + (partkey % 20001) + 100 * (partkey % 1000)  # unscaled c


def _ps_suppkey(partkey: np.ndarray, i: np.ndarray, S: int) -> np.ndarray:
    """The official partsupp supplier spread: 4 distinct suppliers/part."""
    return ((partkey - 1 + i * (S // 4) + (partkey - 1) // S) % S) + 1


class TpchGenerator:
    def __init__(self, sf: float):
        self.sf = sf
        self.counts = _counts(sf)

    def generate(
        self, table: str, lo: int, hi: int, columns: Sequence[str]
    ) -> Dict[str, object]:
        rows = np.arange(lo, hi, dtype=np.int64)
        fn = getattr(self, f"_gen_{table}")
        return fn(rows, list(columns))

    # each generator returns {col: numpy array | DictColumn}

    def _gen_region(self, rows, columns):
        out = {}
        for c in columns:
            if c == "r_regionkey":
                out[c] = rows
            elif c == "r_name":
                out[c] = _fixed(REGIONS, rows % 5)
            elif c == "r_comment":
                out[c] = _COMMENTS.column(101, rows)
        return out

    def _gen_nation(self, rows, columns):
        regionkeys = np.asarray([r for _, r in NATIONS], dtype=np.int64)
        out = {}
        for c in columns:
            if c == "n_nationkey":
                out[c] = rows
            elif c == "n_name":
                out[c] = _fixed([n for n, _ in NATIONS], rows)
            elif c == "n_regionkey":
                out[c] = regionkeys[rows]
            elif c == "n_comment":
                out[c] = _COMMENTS.column(102, rows)
        return out

    def _gen_supplier(self, rows, columns):
        keys = rows + 1
        out = {}
        for c in columns:
            if c == "s_suppkey":
                out[c] = keys
            elif c == "s_name":
                out[c] = _numbered("Supplier", self.counts["supplier"], keys)
            elif c == "s_address":
                out[c] = _COMMENTS.column(201, rows)
            elif c == "s_nationkey":
                out[c] = _uniform(202, rows, 0, 24)
            elif c == "s_phone":
                out[c] = _phone(203, rows, _uniform(202, rows, 0, 24))
            elif c == "s_acctbal":
                out[c] = _uniform(204, rows, -99999, 999999)
            elif c == "s_comment":
                out[c] = _COMMENTS.column(205, rows)
        return out

    def _gen_customer(self, rows, columns):
        keys = rows + 1
        out = {}
        for c in columns:
            if c == "c_custkey":
                out[c] = keys
            elif c == "c_name":
                out[c] = _numbered("Customer", self.counts["customer"], keys)
            elif c == "c_address":
                out[c] = _COMMENTS.column(301, rows)
            elif c == "c_nationkey":
                out[c] = _uniform(302, rows, 0, 24)
            elif c == "c_phone":
                out[c] = _phone(303, rows, _uniform(302, rows, 0, 24))
            elif c == "c_acctbal":
                out[c] = _uniform(304, rows, -99999, 999999)
            elif c == "c_mktsegment":
                out[c] = _fixed(SEGMENTS, _uniform(305, rows, 0, 4))
            elif c == "c_comment":
                out[c] = _COMMENTS.column(306, rows)
        return out

    def _gen_part(self, rows, columns):
        keys = rows + 1
        out = {}
        for c in columns:
            if c == "p_partkey":
                out[c] = keys
            elif c == "p_name":
                out[c] = _P_NAME.column(401, rows)
            elif c == "p_mfgr":
                out[c] = _fixed(
                    [f"Manufacturer#{i}" for i in range(1, 6)],
                    _uniform(402, rows, 0, 4),
                )
            elif c == "p_brand":
                m = _uniform(402, rows, 0, 4) + 1
                n = _uniform(403, rows, 1, 5)
                out[c] = _fixed(
                    [f"Brand#{a}{b}" for a in range(1, 6) for b in range(1, 6)],
                    (m - 1) * 5 + (n - 1),
                )
            elif c == "p_type":
                out[c] = _P_TYPE.column(404, rows)
            elif c == "p_size":
                out[c] = _uniform(405, rows, 1, 50)
            elif c == "p_container":
                out[c] = _CONTAINERS.column(406, rows)
            elif c == "p_retailprice":
                out[c] = _retailprice(keys)
            elif c == "p_comment":
                out[c] = _COMMENTS.column(407, rows)
        return out

    def _gen_partsupp(self, rows, columns):
        partkey = rows // 4 + 1
        i = rows % 4
        S = self.counts["supplier"]
        out = {}
        for c in columns:
            if c == "ps_partkey":
                out[c] = partkey
            elif c == "ps_suppkey":
                out[c] = _ps_suppkey(partkey, i, S)
            elif c == "ps_availqty":
                out[c] = _uniform(501, rows, 1, 9999)
            elif c == "ps_supplycost":
                out[c] = _uniform(502, rows, 100, 100000)
            elif c == "ps_comment":
                out[c] = _COMMENTS.column(503, rows)
        return out

    def _gen_orders(self, rows, columns):
        keys = _orderkey(rows)
        odate = STARTDATE + (
            _stream(601, rows) % np.uint64(ENDDATE - 151 - STARTDATE + 1)
        ).astype(np.int64)
        out = {}
        for c in columns:
            if c == "o_orderkey":
                out[c] = keys
            elif c == "o_custkey":
                out[c] = _uniform(602, rows, 1, self.counts["customer"])
            elif c == "o_orderstatus":
                # derived from line statuses; approximated deterministically
                r = _uniform(603, rows, 0, 9)
                out[c] = _fixed(
                    ["F", "O", "P"], np.where(r < 5, 1, np.where(r < 9, 0, 2))
                )
            elif c == "o_totalprice":
                out[c] = _uniform(604, rows, 90000, 55000000)
            elif c == "o_orderdate":
                out[c] = odate
            elif c == "o_orderpriority":
                out[c] = _fixed(PRIORITIES, _uniform(605, rows, 0, 4))
            elif c == "o_clerk":
                nclerk = max(int(1000 * self.sf), 1)
                out[c] = _numbered(
                    "Clerk", nclerk, _uniform(606, rows, 1, nclerk)
                )
            elif c == "o_shippriority":
                out[c] = np.zeros(len(rows), dtype=np.int64)
            elif c == "o_comment":
                out[c] = _COMMENTS.column(607, rows)
        return out

    def _gen_lineitem(self, rows, columns):
        order_idx, linenumber = _lineitem_order(rows)
        # the shared streams are made on first use only: a scan of
        # (l_orderkey, l_quantity) skips the dates and the part keys
        memo = {}

        def shared(name):
            if name not in memo:
                if name == "odate":
                    memo[name] = STARTDATE + (
                        _stream(601, order_idx)
                        % np.uint64(ENDDATE - 151 - STARTDATE + 1)
                    ).astype(np.int64)
                elif name == "shipdate":
                    memo[name] = shared("odate") + _uniform(701, rows, 1, 121)
                elif name == "partkey":
                    memo[name] = _uniform(702, rows, 1, self.counts["part"])
                else:  # qty
                    memo[name] = _uniform(703, rows, 1, 50)
            return memo[name]

        out = {}
        for c in columns:
            if c == "l_orderkey":
                out[c] = _orderkey(order_idx)
            elif c == "l_partkey":
                out[c] = shared("partkey")
            elif c == "l_suppkey":
                out[c] = _ps_suppkey(
                    shared("partkey"),
                    _uniform(704, rows, 0, 3),
                    self.counts["supplier"],
                )
            elif c == "l_linenumber":
                out[c] = linenumber
            elif c == "l_quantity":
                out[c] = shared("qty") * 100  # unscaled decimal(12,2)
            elif c == "l_extendedprice":
                out[c] = shared("qty") * _retailprice(shared("partkey"))
            elif c == "l_discount":
                out[c] = _uniform(705, rows, 0, 10)  # 0.00..0.10
            elif c == "l_tax":
                out[c] = _uniform(706, rows, 0, 8)
            elif c == "l_returnflag":
                receipt = shared("shipdate") + _uniform(708, rows, 1, 30)
                ra = _uniform(709, rows, 0, 1)
                out[c] = _fixed(
                    ["A", "N", "R"],
                    np.where(receipt > CURRENTDATE, 1, np.where(ra == 0, 0, 2)),
                )
            elif c == "l_linestatus":
                out[c] = _fixed(
                    ["F", "O"],
                    (shared("shipdate") > CURRENTDATE).astype(np.int64),
                )
            elif c == "l_shipdate":
                out[c] = shared("shipdate")
            elif c == "l_commitdate":
                out[c] = shared("odate") + _uniform(707, rows, 30, 90)
            elif c == "l_receiptdate":
                out[c] = shared("shipdate") + _uniform(708, rows, 1, 30)
            elif c == "l_shipinstruct":
                out[c] = _fixed(INSTRUCTIONS, _uniform(710, rows, 0, 3))
            elif c == "l_shipmode":
                out[c] = _fixed(SHIPMODES, _uniform(711, rows, 0, 6))
            elif c == "l_comment":
                out[c] = _COMMENTS.column(712, rows)
        return out


def _orderkey(order_idx: np.ndarray) -> np.ndarray:
    """Sparse order keys (official: 8 used out of every 32)."""
    blk, off = np.divmod(order_idx, 8)
    return blk * 32 + off + 1


_PHONE_LOCALS = list(range(0, 10000, 101))  # 100 bucketed local parts
_PHONE_VALUES = np.asarray(
    [
        f"{c}-{l // 100:03d}-{l % 100:03d}-{l:04d}"
        for c in range(10, 35)
        for l in _PHONE_LOCALS
    ],
    dtype=object,
)  # already sorted: fixed-width country code, then local ascending


def _phone(tag: int, rows: np.ndarray, nationkey: np.ndarray) -> DictColumn:
    """'NN-NNN-NNN-NNNN' with country code nationkey+10 (Q22 substr
    relies on the leading country code). Dictionary ids computed
    arithmetically — the dictionary layout is (country, local-bucket)
    row-major, which matches lexicographic order by construction."""
    bucket = _uniform(tag, rows, 0, len(_PHONE_LOCALS) - 1)
    ids = (nationkey * len(_PHONE_LOCALS) + bucket).astype(np.int32)
    return DictColumn(ids=ids, values=_PHONE_VALUES)


# -------------------------------------------------------------- connector


class _TpchMetadata(ConnectorMetadata):
    def list_schemas(self):
        return list(SCHEMAS)

    def list_tables(self, schema):
        return list(TABLE_SCHEMAS)

    def get_table_schema(self, handle: TableHandle):
        if handle.schema not in SCHEMAS:
            raise KeyError(f"unknown tpch schema: {handle.schema}")
        if handle.table not in TABLE_SCHEMAS:
            raise KeyError(f"unknown tpch table: {handle.table}")
        return dict(TABLE_SCHEMAS[handle.table])

    PRIMARY_KEYS = {
        "region": ("r_regionkey",),
        "nation": ("n_nationkey",),
        "supplier": ("s_suppkey",),
        "customer": ("c_custkey",),
        "part": ("p_partkey",),
        "partsupp": ("ps_partkey", "ps_suppkey"),
        "orders": ("o_orderkey",),
        "lineitem": ("l_orderkey", "l_linenumber"),
    }

    # foreign keys: column -> referenced table (distinct count source)
    FOREIGN_KEYS = {
        "n_regionkey": "region",
        "s_nationkey": "nation",
        "c_nationkey": "nation",
        "ps_partkey": "part",
        "ps_suppkey": "supplier",
        "o_custkey": "customer",
        "l_orderkey": "orders",
        "l_partkey": "part",
        "l_suppkey": "supplier",
    }

    def get_table_stats(self, handle: TableHandle):
        sf = SCHEMAS[handle.schema]
        counts = _counts(sf)
        n = counts[handle.table]
        pk = self.PRIMARY_KEYS[handle.table]

        def key_max(table: str) -> int:
            # orderkeys are sparse (8 of every 32): domain max != rowcount
            if table == "orders":
                return int(_orderkey(np.asarray([counts["orders"] - 1]))[0])
            return counts[table]

        cols: Dict[str, ColumnStats] = {}
        for name in TABLE_SCHEMAS[handle.table]:
            if len(pk) == 1 and name == pk[0]:
                cols[name] = ColumnStats(
                    distinct_count=n, min_value=1, max_value=key_max(handle.table)
                )
            elif name in self.FOREIGN_KEYS:
                ref_table = self.FOREIGN_KEYS[name]
                ref = counts[ref_table]
                cols[name] = ColumnStats(
                    distinct_count=min(ref, n),
                    min_value=1,
                    max_value=key_max(ref_table),
                )
            elif name == "l_linenumber":
                # closed form: 1..7 lines per order
                cols[name] = ColumnStats(
                    distinct_count=7, min_value=1, max_value=7
                )
        return TableStats(row_count=float(n), columns=cols, primary_key=pk)


class TpchConnector(Connector):
    """Catalog 'tpch': schemas tiny/sf1/sf10/sf100, zero stored bytes."""

    def __init__(self, **config):
        self._metadata = _TpchMetadata()
        self._gens: Dict[str, TpchGenerator] = {}

    def metadata(self):
        return self._metadata

    def _gen(self, schema: str) -> TpchGenerator:
        if schema not in self._gens:
            self._gens[schema] = TpchGenerator(SCHEMAS[schema])
        return self._gens[schema]

    def get_splits(self, handle: TableHandle, target_split_rows: int = 1 << 20, constraint=()):
        n = self._gen(handle.schema).counts[handle.table]
        splits = [
            ConnectorSplit(handle, lo, min(lo + target_split_rows, n))
            for lo in range(0, n, target_split_rows)
        ] or [ConnectorSplit(handle, 0, 0)]
        return SplitSource(splits)

    def create_page_source(self, split: ConnectorSplit, columns):
        return self._gen(split.table.schema).generate(
            split.table.table, split.row_start, split.row_end, columns
        )
