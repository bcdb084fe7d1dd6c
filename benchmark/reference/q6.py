"""TPC-H Q6: revenue of the lines of one year at one discount band under
one quantity."""

from benchmark.reference.common import Answer, days, dec, num, plus_years, total
from benchmark.params import decimal_units


def answer(t, p, precision="exact") -> Answer:
    li = t["lineitem"]
    disc = decimal_units(p["DISCOUNT"], 2)
    ship = li["l_shipdate"]
    m = ((ship >= days(p["DATE"])) & (ship < plus_years(p["DATE"], 1))
         & (li["l_discount"] >= disc - 1) & (li["l_discount"] <= disc + 1)
         & (li["l_quantity"] < int(p["QUANTITY"]) * 100))
    if not bool(m.any()):
        return Answer(rows=[(None,)])
    revenue = num(li["l_extendedprice"][m], precision) * num(
        li["l_discount"][m], precision)
    return Answer(rows=[(dec(total(revenue), 4),)])
