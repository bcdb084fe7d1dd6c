"""TPC-DS web-channel tables on the device from a seed (TPC-DS
specification: table scaling, and the column domains Q95 reads). Not
dsdgen: the row counts are the configuration's, and each column is
drawn from the domain dsdgen gives it.

Departures from dsdgen, listed under ``assumed`` in the configuration:
lines per web order are a fixed multiset of 8..16 (dsdgen: uniform
8..16) in an order drawn from the seed; company names, states, the
ship lag, the warehouse and the prices are uniform over their domains;
a return is a web_sales line drawn without replacement.
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

JULIAN_OF_EPOCH = 2440588  # d_date_sk of 1970-01-01
FIRST_DATE = -25566  # 1900-01-02, the first d_date
SOLD_FIRST, SOLD_LAST = 10228, 12052  # 1998-01-02 .. 2002-12-31


def lines_per_order(rows: int, device) -> torch.Tensor:
    """Counts of 8..16 lines, each equally often, that add up to
    ``rows``: (rows // 108) of each, then orders of 12, then one of
    what is left."""
    k, rest = divmod(rows, 108)
    counts = [torch.arange(8, 17, device=device).repeat(k)]
    tail = []
    while rest > 16:
        tail.append(12)
        rest -= 12
    if rest:
        if rest < 8:
            raise ValueError(f"web_sales: {rows} rows leave an order of {rest}")
        tail.append(rest)
    counts.append(torch.tensor(tail, device=device, dtype=torch.int64))
    return torch.cat(counts)


def generate(config: dict, seed: int, device) -> Dict[str, Table]:
    rows = {t: spec["rows"] for t, spec in config["tables"].items()}
    dicts = config["dictionaries"]
    out: Dict[str, Table] = {}
    for table, spec in config["tables"].items():
        cols = list(spec["columns"])
        made = _TABLES[table](seed, rows, config, dicts, device)
        missing = set(cols) - set(made)
        if missing:
            raise ValueError(f"tpcds.{table}: no generator for {sorted(missing)}")
        out[table] = {c: made[c] for c in cols}
        n = made[cols[0]]
        check_rows(config, table, len(getattr(n, "ids", n)))
    return out


def _date_dim(seed, rows, config, dicts, dev):
    day = torch.arange(rows["date_dim"], device=dev, dtype=torch.int32)
    return {
        "d_date_sk": day + (FIRST_DATE + JULIAN_OF_EPOCH),
        "d_date": day + FIRST_DATE,
    }


def _web_site(seed, rows, config, dicts, dev):
    n = rows["web_site"]
    names = sorted_values(dicts["web_company_name"], "web_company_name")
    picks = shuffled(seed, "web_company_name",
                     torch.arange(n, device=dev) % len(names))
    return {
        "web_site_sk": torch.arange(1, n + 1, device=dev, dtype=torch.int32),
        "web_company_name": varchar(picks, names),
    }


def _customer_address(seed, rows, config, dicts, dev):
    n = rows["customer_address"]
    states = sorted_values(dicts["ca_state"], "ca_state")
    picks = shuffled(seed, "ca_state", torch.arange(n, device=dev) % len(states))
    return {
        "ca_address_sk": torch.arange(1, n + 1, device=dev, dtype=torch.int32),
        "ca_state": varchar(picks, states),
    }


def _web_orders(seed, rows, dev):
    """Order index of every web_sales line."""
    per_order = shuffled(seed, "ws_lines_per_order",
                         lines_per_order(rows["web_sales"], dev))
    return len(per_order), torch.repeat_interleave(
        torch.arange(len(per_order), device=dev), per_order)


def _web_sales(seed, rows, config, dicts, dev):
    n_orders, order = _web_orders(seed, rows, dev)
    n = len(order)

    def per_order(name, lo, hi):
        return uniform(seed, name, lo, hi, n_orders, dev)[order]

    def per_line(name, lo, hi):
        return uniform(seed, name, lo, hi, n, dev)

    qty = per_line("ws_quantity", 1, 100)
    wholesale = per_line("ws_wholesale_cost", 100, 10000)  # cents
    listp = wholesale * (100 + per_line("ws_markup", 0, 200)) // 100
    sales = listp * (100 - per_line("ws_discount", 0, 100)) // 100
    sold = per_order("ws_sold_date", SOLD_FIRST, SOLD_LAST) + JULIAN_OF_EPOCH
    return {
        "ws_order_number": (order + 1).to(torch.int32),
        "ws_warehouse_sk": per_line(
            "ws_warehouse_sk", 1, int(config["warehouses"])).to(torch.int32),
        "ws_ship_date_sk": (sold + per_line("ws_ship_lag", 1, 120)).to(
            torch.int32),
        "ws_ship_addr_sk": per_order(
            "ws_ship_addr_sk", 1, rows["customer_address"]).to(torch.int32),
        "ws_web_site_sk": per_order(
            "ws_web_site_sk", 1, rows["web_site"]).to(torch.int32),
        "ws_ext_ship_cost": qty * listp * per_line("ws_ship_factor", 0, 50)
        // 100,
        "ws_net_profit": qty * (sales - wholesale),
    }


def _web_returns(seed, rows, config, dicts, dev):
    _, order = _web_orders(seed, rows, dev)
    g_rows = shuffled(seed, "wr_line", torch.arange(len(order), device=dev))
    return {
        "wr_order_number": (order[g_rows[: rows["web_returns"]]] + 1).to(
            torch.int32)
    }


_TABLES = {
    "date_dim": _date_dim,
    "web_site": _web_site,
    "customer_address": _customer_address,
    "web_sales": _web_sales,
    "web_returns": _web_returns,
}
