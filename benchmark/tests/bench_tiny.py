"""The cells' configurations cut to a size that the CPU runs in
seconds."""

import copy
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmark import layout  # noqa: E402
from benchmark.gen import tpch  # noqa: E402


def tiny_config(name: str, factor: float) -> dict:
    """A configuration at ``factor`` of its scale: TPC-H by its scale
    factor, TPC-DS by the rows of its large tables."""
    cfg = copy.deepcopy(layout.config(name))
    if cfg["generator"] == "tpch":
        cfg["scale_factor"] = cfg["scale_factor"] * factor
        for t, n in tpch.row_counts(cfg["scale_factor"]).items():
            if t in cfg["tables"]:
                cfg["tables"][t]["rows"] = n
    else:
        for t in ("web_sales", "web_returns", "customer_address"):
            cfg["tables"][t]["rows"] = int(cfg["tables"][t]["rows"] * factor)
    return cfg


#: each cell at a size the CPU runs in seconds
TINY = {
    "tpch_sf10.scan_agg": 0.001,
    "tpch_sf10.join": 0.001,
    "tpcds_sf10.q95": 0.01,
}
