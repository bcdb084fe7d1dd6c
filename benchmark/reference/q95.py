"""TPC-DS Q95: web orders shipped from more than one warehouse and
returned, shipped in a 61-day window to one state from the company's
sites: their count, shipping cost and net profit."""

import torch

from benchmark.reference.common import Answer, days, dec, lookup, num, total, value_id


def answer(t, p, precision="exact") -> Answer:
    ws, wr = t["web_sales"], t["web_returns"]
    d, ca, site = t["date_dim"], t["customer_address"], t["web_site"]
    order = ws["ws_order_number"].long()
    n_orders = int(order.max()) + 1
    wh = ws["ws_warehouse_sk"].long()
    lo = torch.full((n_orders,), 1 << 40, device=order.device).scatter_reduce(
        0, order, wh, "amin")
    hi = torch.full((n_orders,), -1, device=order.device).scatter_reduce(
        0, order, wh, "amax")
    returned = torch.zeros(n_orders, dtype=torch.bool, device=order.device)
    returned[wr["wr_order_number"].long()] = True
    # ws_wh: an order with two lines from different warehouses; the
    # second IN keeps those of them with a return
    order_ok = (lo != hi) & (hi >= 0) & returned
    first = days(f"{p['YEAR']}-{p['MONTH']}-01")
    date_ok = lookup(d["d_date_sk"], (d["d_date"] >= first)
                     & (d["d_date"] <= first + 60), False)
    state_ok = lookup(ca["ca_address_sk"], ca["ca_state"].ids
                      == value_id(ca["ca_state"], p["STATE"]), False)
    site_ok = lookup(site["web_site_sk"], site["web_company_name"].ids
                     == value_id(site["web_company_name"], "pri"), False)
    ship = ws["ws_ship_date_sk"].long()
    in_dates = (ship < len(date_ok)) & date_ok[ship.clamp(max=len(date_ok) - 1)]
    m = (in_dates & state_ok[ws["ws_ship_addr_sk"].long()]
         & site_ok[ws["ws_web_site_sk"].long()] & order_ok[order])
    if not bool(m.any()):
        return Answer(rows=[(0, None, None)])
    return Answer(rows=[(
        int(torch.unique(order[m]).numel()),
        dec(total(num(ws["ws_ext_ship_cost"][m], precision)), 2),
        dec(total(num(ws["ws_net_profit"][m], precision)), 2),
    )])
