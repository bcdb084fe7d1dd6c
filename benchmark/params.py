"""Parameter pools: each query of a mix takes ``pool`` parameter sets in
its parameter space (``<query>.params.json``), paired and ordered by
the seed, and the window cycles through them. A value is the text that
the query takes in place of ``{NAME}``; the references parse the same
text."""

from __future__ import annotations

import datetime
import random
from typing import Dict, List

def stratum_value(spec: dict, cfg: dict, k: int, size: int) -> str:
    """The ``k``-th of ``size`` values spread evenly over a parameter's
    range: the midpoint of the k-th of ``size`` equal strata."""
    def pick(n: int) -> int:  # the k-th stratum's middle in [0, n)
        return (n * (2 * k + 1)) // (2 * size)

    kind = spec["kind"]
    if kind == "int":
        v = spec["lo"] + pick(spec["hi"] - spec["lo"] + 1)
        return format(v, spec.get("format", "d"))
    if kind == "choice":
        values = list(spec.get("values") or cfg["dictionaries"][spec["from"]])
        return values[pick(len(values))]
    if kind == "year_start":
        return f"{spec['lo'] + pick(spec['hi'] - spec['lo'] + 1)}-01-01"
    if kind == "day":
        first = datetime.date.fromisoformat(spec["first"])
        return (first + datetime.timedelta(pick(spec["days"]))).isoformat()
    if kind == "decimal":
        units = spec["lo"] + pick(spec["hi"] - spec["lo"] + 1)
        scale = spec["scale"]
        return f"{units // 10 ** scale}.{units % 10 ** scale:0{scale}d}"
    raise ValueError(f"unknown parameter kind {kind!r}")


def draw_pool(seed: int, query: str, meta: dict, cfg: dict, size: int
              ) -> List[Dict[str, str]]:
    """``size`` parameter sets of ``query``. Every seed gets the same
    values of each parameter, spread evenly over its range; the seed
    draws how they pair up and their order, so the work of a pool is
    the same whatever the seed."""
    rng = random.Random(f"{int(seed)}:{query}")
    columns = {}
    for name, spec in meta["params"].items():
        values = [stratum_value(spec, cfg, k, size) for k in range(size)]
        rng.shuffle(values)
        columns[name] = values
    return [{n: columns[n][k] for n in columns} for k in range(size)]


def render(sql: str, params: Dict[str, str]) -> str:
    for k, v in params.items():
        sql = sql.replace("{" + k + "}", v)
    if "{" in sql:
        raise ValueError(f"a parameter is left unbound in:\n{sql}")
    return sql


def decimal_units(text: str, scale: int) -> int:
    whole, _, frac = text.partition(".")
    frac = (frac + "0" * scale)[:scale]
    sign = -1 if whole.startswith("-") else 1
    return sign * (abs(int(whole or "0")) * 10 ** scale + int(frac or "0"))
