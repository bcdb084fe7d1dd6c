"""TPC-H Q1: per (l_returnflag, l_linestatus) over the lines shipped by
1998-12-01 minus DELTA days."""

from benchmark.reference.common import Answer, days, dec, mean, num, total


def answer(t, p, precision="exact") -> Answer:
    li = t["lineitem"]
    live = li["l_shipdate"] <= days("1998-12-01") - int(p["DELTA"])
    flag, status = li["l_returnflag"], li["l_linestatus"]
    ns = len(status.values)
    gid = flag.ids.long() * ns + status.ids.long()
    qty = num(li["l_quantity"], precision)
    price = num(li["l_extendedprice"], precision)
    disc = num(li["l_discount"], precision)
    tax = num(li["l_tax"], precision)
    rows = []
    for f, fv in enumerate(flag.values):
        for s, sv in enumerate(status.values):
            m = live & (gid == f * ns + s)
            n = int(m.sum())
            if n == 0:
                continue
            q, pr, d = qty[m], price[m], disc[m]
            disc_price = pr * (100 - d)
            rows.append((
                fv, sv, dec(total(q), 2), dec(total(pr), 2),
                dec(total(disc_price), 4),
                dec(total(disc_price * (100 + tax[m])), 6),
                mean(q, n, 2), mean(pr, n, 2), mean(d, n, 2), n,
            ))
    return Answer(rows=rows, key_cols=(0, 1), sort_cols=(0, 1),
                  groupby_rows=int(live.sum()))
