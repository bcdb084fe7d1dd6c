"""TPC-H Q18: the orders of more than QUANTITY units, with their
customer, date, total price and quantity, the 100 largest by total
price, then earliest date."""

import torch

from benchmark.reference.common import Answer, dec, lookup, num, sums_by

LIMIT = 100


def _units(x: torch.Tensor) -> int:
    return round(float(x)) if x.is_floating_point() else int(x)


def answer(t, p, precision="exact") -> Answer:
    c, o, li = t["customer"], t["orders"], t["lineitem"]
    keys = o["o_orderkey"]
    n_orders = len(keys)
    order_row = lookup(keys, torch.arange(n_orders, device=keys.device), -1)
    orow = order_row[li["l_orderkey"].long()]
    # the IN subquery: sum(l_quantity) by order, over QUANTITY (scale 2)
    qty = sums_by(orow, num(li["l_quantity"], precision), n_orders)
    big = torch.nonzero(qty > int(p["QUANTITY"]) * 100).flatten()
    cust_row = lookup(c["c_custkey"],
                      torch.arange(len(c["c_custkey"]), device=keys.device), -1)
    name_id = c["c_name"].ids[cust_row[o["o_custkey"][big].long()]]
    price = num(o["o_totalprice"][big], precision)
    rows = sorted(
        (
            (c["c_name"].values[int(n)], int(ck), int(ok), int(d),
             dec(_units(tp), 2), dec(_units(q), 2))
            for n, ck, ok, d, tp, q in zip(
                name_id.cpu(), o["o_custkey"][big].cpu(), keys[big].cpu(),
                o["o_orderdate"][big].cpu(), price.cpu(), qty[big].cpu())
        ),
        key=lambda row: (-row[4], row[3], row[2]),
    )
    top = rows[:LIMIT]
    if not top:
        return Answer(rows=[], key_cols=(2,), sort_cols=(4, 3))
    last = (top[-1][4], top[-1][3])
    ties = [r for r in rows[LIMIT:] if (r[4], r[3]) == last]
    return Answer(rows=top, key_cols=(2,), sort_cols=(4, 3), ties=ties)
