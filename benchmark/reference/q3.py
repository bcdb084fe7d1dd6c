"""TPC-H Q3: the ten unshipped orders of one segment with the highest
revenue, as of one day."""

import torch

from benchmark.reference.common import (
    Answer, days, dec, lookup, num, sums_by, value_id)

LIMIT = 10


def answer(t, p, precision="exact") -> Answer:
    c, o, li = t["customer"], t["orders"], t["lineitem"]
    day = days(p["DATE"])
    seg = value_id(c["c_mktsegment"], p["SEGMENT"])
    cust_ok = lookup(c["c_custkey"], c["c_mktsegment"].ids == seg, False)
    n_orders = len(o["o_orderkey"])
    order_ok = (o["o_orderdate"] < day) & cust_ok[o["o_custkey"].long()]
    order_row = lookup(o["o_orderkey"],
                       torch.arange(n_orders, device=o["o_orderkey"].device), -1)
    orow = order_row[li["l_orderkey"].long()]
    m = order_ok[orow] & (li["l_shipdate"] > day)
    rows_m = orow[m]
    revenue = sums_by(rows_m, num(li["l_extendedprice"][m], precision)
                      * (100 - num(li["l_discount"][m], precision)), n_orders)
    grouped = torch.zeros(n_orders, dtype=torch.bool, device=m.device)
    grouped[rows_m] = True
    n_groups = int(grouped.sum())
    if n_groups == 0:
        return Answer(rows=[], key_cols=(0,), sort_cols=(1, 2))
    ranked = torch.where(grouped, revenue, torch.full_like(revenue, -1))
    kth = torch.topk(ranked, min(LIMIT, n_groups)).values[-1]
    cand = torch.nonzero(grouped & (ranked >= kth)).flatten()
    rows = sorted(
        (
            (int(k), dec(round(float(r)) if r.is_floating_point() else int(r), 4),
             int(d), int(s))
            for k, r, d, s in zip(
                o["o_orderkey"][cand].cpu(), revenue[cand].cpu(),
                o["o_orderdate"][cand].cpu(), o["o_shippriority"][cand].cpu())
        ),
        key=lambda row: (-row[1], row[2], row[0]),
    )
    top = rows[:LIMIT]
    last = (top[-1][1], top[-1][2])
    ties = [r for r in rows[LIMIT:] if (r[1], r[2]) == last]
    return Answer(rows=top, key_cols=(0,), sort_cols=(1, 2), ties=ties)
