"""TPC-H tables on the device from a seed (TPC-H Standard Specification,
clause 4.2). Not dbgen: the same row counts, key relations and value
ranges (clause 4.2.3), drawn with torch's generator on the device.

Only the columns that a configuration lists are made; the others are
never read by its queries, as a column store never reads them.
Departures from dbgen, listed under ``assumed`` in the configuration:
lines per order are a fixed multiset of 1..7 (each count equally often)
in an order drawn from the seed, so every seed has the same number of
lineitem rows; comments, names and addresses are not made.
"""

from __future__ import annotations

from typing import Dict

import torch

from benchmark.gen.common import (
    Table,
    check_rows,
    shuffled,
    sorted_values,
    uniform,
    varchar,
)

STARTDATE = 8035  # 1992-01-01, epoch days
ENDDATE = 10440  # 1998-08-02
CURRENTDATE = 9298  # 1995-06-17


def row_counts(sf: float) -> Dict[str, int]:
    orders = int(1_500_000 * sf)
    return {
        "region": 5,
        "nation": 25,
        "supplier": int(10_000 * sf),
        "customer": int(150_000 * sf),
        "part": int(200_000 * sf),
        "orders": orders,
        # (orders // 7) orders of each of 1..7 lines, the rest of 4
        "lineitem": orders // 7 * 28 + orders % 7 * 4,
    }


def lines_per_order(orders: int, device) -> torch.Tensor:
    full = torch.arange(1, 8, device=device).repeat(orders // 7)
    rest = torch.full((orders % 7,), 4, device=device)
    return torch.cat([full, rest])


def orderkey(order_idx: torch.Tensor) -> torch.Tensor:
    """Sparse order keys: the first 8 of every 32 (clause 4.2.3)."""
    return order_idx // 8 * 32 + order_idx % 8 + 1


def retailprice(partkey: torch.Tensor) -> torch.Tensor:
    """P_RETAILPRICE in cents (clause 4.2.3)."""
    return 90000 + (partkey // 10) % 20001 + 100 * (partkey % 1000)


def suppkey(partkey: torch.Tensor, i: torch.Tensor, s: int) -> torch.Tensor:
    """The i-th (0..3) supplier of a part (clause 4.2.3)."""
    return (partkey + i * (s // 4 + (partkey - 1) // s)) % s + 1


def generate(config: dict, seed: int, device) -> Dict[str, Table]:
    sf = float(config["scale_factor"])
    counts = row_counts(sf)
    dicts = config["dictionaries"]
    out: Dict[str, Table] = {}
    for table, spec in config["tables"].items():
        cols = list(spec["columns"])
        made = _TABLES[table](seed, counts, dicts, cols, device)
        missing = set(cols) - set(made)
        if missing:
            raise ValueError(f"tpch.{table}: no generator for {sorted(missing)}")
        check_rows(config, table, counts[table])
        out[table] = {c: made[c] for c in cols}
    return out


def _region(seed, counts, dicts, cols, dev):
    names = sorted_values(dicts["r_name"], "r_name")
    keys = torch.arange(5, device=dev)
    return {"r_regionkey": keys.to(torch.int32), "r_name": varchar(keys, names)}


def _nation(seed, counts, dicts, cols, dev):
    nations = dicts["nations"]  # [name, regionkey] in nationkey order
    names = sorted_values(sorted(n for n, _ in nations), "n_name")
    rank = {n: i for i, n in enumerate(names)}
    return {
        "n_nationkey": torch.arange(25, device=dev, dtype=torch.int32),
        "n_name": varchar(
            torch.tensor([rank[n] for n, _ in nations], device=dev), names
        ),
        "n_regionkey": torch.tensor(
            [r for _, r in nations], device=dev, dtype=torch.int32
        ),
    }


def _supplier(seed, counts, dicts, cols, dev):
    n = counts["supplier"]
    return {
        "s_suppkey": torch.arange(1, n + 1, device=dev, dtype=torch.int32),
        "s_nationkey": uniform(seed, "s_nationkey", 0, 24, n, dev).to(
            torch.int32
        ),
    }


def _customer(seed, counts, dicts, cols, dev):
    n = counts["customer"]
    segments = sorted_values(dicts["c_mktsegment"], "c_mktsegment")
    return {
        "c_custkey": torch.arange(1, n + 1, device=dev, dtype=torch.int32),
        "c_nationkey": uniform(seed, "c_nationkey", 0, 24, n, dev).to(
            torch.int32
        ),
        "c_mktsegment": varchar(
            uniform(seed, "c_mktsegment", 0, len(segments) - 1, n, dev),
            segments,
        ),
    }


def _orderdate(seed, n, dev):
    return uniform(seed, "o_orderdate", STARTDATE, ENDDATE - 151, n, dev)


def _orders(seed, counts, dicts, cols, dev):
    n = counts["orders"]
    # a third of the customers place no order: O_CUSTKEY is never a
    # multiple of 3 (clause 4.2.3)
    k = uniform(seed, "o_custkey", 0, counts["customer"] * 2 // 3 - 1, n, dev)
    return {
        "o_orderkey": orderkey(torch.arange(n, device=dev)).to(torch.int32),
        "o_custkey": (k // 2 * 3 + k % 2 + 1).to(torch.int32),
        "o_orderdate": _orderdate(seed, n, dev).to(torch.int32),
        "o_shippriority": torch.zeros(n, device=dev, dtype=torch.int32),
    }


def _lineitem(seed, counts, dicts, cols, dev):
    n_orders = counts["orders"]
    per_order = shuffled(seed, "lines_per_order",
                         lines_per_order(n_orders, dev))
    order_idx = torch.repeat_interleave(
        torch.arange(n_orders, device=dev), per_order
    )
    del per_order
    n = len(order_idx)
    memo = {}

    def shared(name):
        if name not in memo:
            if name == "partkey":
                memo[name] = uniform(seed, "l_partkey", 1, counts["part"], n, dev)
            elif name == "quantity":
                memo[name] = uniform(seed, "l_quantity", 1, 50, n, dev)
            elif name == "shipdate":
                odate = _orderdate(seed, n_orders, dev)
                memo[name] = odate[order_idx] + uniform(
                    seed, "l_shipdate", 1, 121, n, dev)
            elif name == "receiptdate":
                memo[name] = shared("shipdate") + uniform(
                    seed, "l_receiptdate", 1, 30, n, dev)
        return memo[name]

    makers = {
        "l_orderkey": lambda: orderkey(order_idx).to(torch.int32),
        "l_suppkey": lambda: suppkey(
            shared("partkey"), uniform(seed, "l_suppkey", 0, 3, n, dev),
            counts["supplier"]).to(torch.int32),
        "l_quantity": lambda: shared("quantity") * 100,
        "l_extendedprice": lambda: shared("quantity") * retailprice(
            shared("partkey")),
        "l_discount": lambda: uniform(seed, "l_discount", 0, 10, n, dev),
        "l_tax": lambda: uniform(seed, "l_tax", 0, 8, n, dev),
        # 'R' or 'A' once received by CURRENTDATE, else 'N'
        "l_returnflag": lambda: varchar(torch.where(
            shared("receiptdate") <= CURRENTDATE,
            uniform(seed, "l_returnflag", 0, 1, n, dev) * 2, 1), ("A", "N", "R")),
        "l_linestatus": lambda: varchar(
            (shared("shipdate") > CURRENTDATE).to(torch.int64), ("F", "O")),
        "l_shipdate": lambda: shared("shipdate").to(torch.int32),
    }
    return {c: makers[c]() for c in cols if c in makers}


_TABLES = {
    "region": _region,
    "nation": _nation,
    "supplier": _supplier,
    "customer": _customer,
    "orders": _orders,
    "lineitem": _lineitem,
}
