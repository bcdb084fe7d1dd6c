"""Queries whose one-row results hold a broadcast (stride-0) column:
shared by tests/test_torch_broadcast.py (the port against the JAX
reference on the CPU) and tests/test_torch_cuda.py (the card against
the CPU), so this module imports neither JAX nor the JAX package."""

#: name -> (sql, the reference's rows where the query pins them)
QUERIES = {
    "literal_beside_count": (
        "select 7 as c, count(*) as n from tpch.tiny.nation",
        [(7, 25)],
    ),
    "two_count_distinct": (
        "select count(distinct l_suppkey) as s, "
        "count(distinct l_shipmode) as m from tpch.tiny.lineitem",
        [(100, 7)],
    ),
    "count_distinct_beside_sum": (
        "select count(distinct o_custkey) as d, sum(o_totalprice) as s "
        "from tpch.tiny.orders",
        None,
    ),
    "rollup_grand_total": (
        "select l_suppkey, count(l_partkey * 5) as a0, "
        "min(l_extendedprice) as a1, grouping(l_suppkey) as g0 "
        "from tpch.tiny.lineitem group by rollup (l_suppkey) "
        "order by l_suppkey",
        None,
    ),
    "cube_one_row": (
        "select l_returnflag, l_linestatus, avg(l_quantity) as a0, "
        "grouping(l_returnflag) as g0 from tpch.tiny.lineitem "
        "where l_quantity >= 43110 and l_partkey = 48761 "
        "group by cube (l_returnflag, l_linestatus)",
        None,
    ),
}
