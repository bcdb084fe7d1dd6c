"""TPC-H Q18's tables on the device from a seed (TPC-H Standard
Specification, clauses 4.2 and 2.4.18): the columns that
``gen/tpch.py`` makes, drawn by its own functions, so that keys,
quantities, prices, taxes and discounts are those of ``tpch_sf10`` for
the same seed, and the two that it lacks:

- ``c_name``: 'Customer#' and the key in 9 digits (clause 4.2.3), a
  dictionary sorted by construction, one name per key;
- ``o_totalprice``: the sum over the order's own lines of
  ``ext * (100 - disc) // 100 * (100 + tax) // 100`` in cents, dbgen's
  integer arithmetic (clause 4.2.3's formula, truncated to the cent).
"""

from __future__ import annotations

from typing import Dict

import torch

from benchmark.gen import tpch
from benchmark.gen.common import Table, check_rows, varchar


def order_index(l_orderkey: torch.Tensor) -> torch.Tensor:
    """The inverse of ``tpch.orderkey``: the order's index, int64."""
    k = l_orderkey.to(torch.int64) - 1
    return k // 32 * 8 + k % 32


def customer_names(n: int):
    """'Customer#000000001' .. for keys 1..n: zero-padded, so sorted."""
    return tuple(f"Customer#{k:09d}" for k in range(1, n + 1))


def totalprice(seed: int, counts: Dict[str, int], dev) -> torch.Tensor:
    """O_TOTALPRICE in cents, int64, in order-index order."""
    li = tpch._lineitem(seed, counts, {}, ["l_orderkey", "l_extendedprice",
                                          "l_discount", "l_tax"], dev)
    term = (li["l_extendedprice"] * (100 - li["l_discount"]) // 100
            * (100 + li["l_tax"]) // 100)
    out = torch.zeros(counts["orders"], dtype=torch.int64, device=dev)
    return out.index_add_(0, order_index(li["l_orderkey"]), term)


def generate(config: dict, seed: int, device) -> Dict[str, Table]:
    counts = tpch.row_counts(float(config["scale_factor"]))
    out: Dict[str, Table] = {}
    for table, spec in config["tables"].items():
        cols = list(spec["columns"])
        made = _TABLES[table](seed, counts, cols, device)
        missing = set(cols) - set(made)
        if missing:
            raise ValueError(
                f"tpch_q18.{table}: no generator for {sorted(missing)}")
        check_rows(config, table, counts[table])
        out[table] = {c: made[c] for c in cols}
    return out


def _customer(seed, counts, cols, dev):
    n = counts["customer"]
    keys = torch.arange(n, device=dev)
    out = {"c_custkey": (keys + 1).to(torch.int32)}
    if "c_name" in cols:
        out["c_name"] = varchar(keys, customer_names(n))
    return out


def _orders(seed, counts, cols, dev):
    out = tpch._orders(seed, counts, {}, cols, dev)
    if "o_totalprice" in cols:
        out["o_totalprice"] = totalprice(seed, counts, dev)
    return out


def _lineitem(seed, counts, cols, dev):
    return tpch._lineitem(seed, counts, {}, cols, dev)


_TABLES = {
    "customer": _customer,
    "orders": _orders,
    "lineitem": _lineitem,
}
