"""TPC-H Q5: revenue per nation of one region from orders of one year
whose customer and supplier share the nation."""

import torch

from benchmark.reference.common import (
    Answer, days, dec, lookup, num, plus_years, total, value_id)


def answer(t, p, precision="exact") -> Answer:
    c, o, li = t["customer"], t["orders"], t["lineitem"]
    s, n, r = t["supplier"], t["nation"], t["region"]
    regionkeys = r["r_regionkey"][r["r_name"].ids == value_id(r["r_name"],
                                                              p["REGION"])]
    in_region = lookup(n["n_nationkey"],
                       (n["n_regionkey"][:, None] == regionkeys[None, :]).any(1),
                       False)
    cust_nation = lookup(c["c_custkey"], c["c_nationkey"], -1)
    supp_nation = lookup(s["s_suppkey"], s["s_nationkey"], -1)
    keys = o["o_orderkey"]
    order_row = lookup(keys, torch.arange(len(keys), device=keys.device), -1)
    orow = order_row[li["l_orderkey"].long()]
    od = o["o_orderdate"][orow]
    sn = supp_nation[li["l_suppkey"].long()]
    m = ((od >= days(p["DATE"])) & (od < plus_years(p["DATE"], 1))
         & (cust_nation[o["o_custkey"][orow].long()] == sn)
         & in_region[sn.long()])
    revenue = num(li["l_extendedprice"], precision) * (
        100 - num(li["l_discount"], precision))
    rows = []
    for key, name_id in zip(n["n_nationkey"].tolist(), n["n_name"].ids.tolist()):
        mk = m & (sn == key)
        if bool(mk.any()):
            rows.append((n["n_name"].values[name_id], dec(total(revenue[mk]), 4)))
    rows.sort(key=lambda row: -row[1])
    return Answer(rows=rows, key_cols=(0,), sort_cols=(1,),
                  groupby_rows=int(m.sum()))
