"""The control of a cell's comparison: the plain reference put in the
program's place, worked out in float32 (decimals and averages), and
held to the exact reference by the comparison that decides
``correct``. It has to come out as not correct on every seed.

    python3 benchmark/control.py --workload tpch_sf10.scan_agg \
        --seeds 11,12,13

For each seed, the cell's tables at its own size and every parameter
set of its pools (as many distinct answers as a run compares). Prints
one JSON line per seed with the numbers compared, and whether the
control passed. Not run by the benchmark's own runs.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path
from typing import Optional

ROOT = Path(__file__).resolve().parent.parent


def control_readings(workload: str, seed: int, device,
                     cfg: Optional[dict] = None) -> dict:
    from benchmark import compare, layout, params

    cell = layout.workload(layout.benchmark(), workload)
    cfg = cfg or layout.config(cell["config"])
    mix = layout.mix(cell["traffic"])
    tables = layout.generator(cfg).generate(cfg, seed, device)
    pairs = []
    for q in mix["queries"]:
        ref = layout.reference(q)
        for p in params.draw_pool(seed, q, layout.query_meta(q), cfg,
                                  mix["pool"]):
            exact = ref.answer(tables, p, "exact")
            low = ref.answer(tables, p, "float32")
            pairs.append((exact, low.rows))
    r = compare.readings(pairs, attempted=len(pairs), failed=0)
    return {"seed": seed, "answers": len(pairs), "passed": compare.passed(r),
            "readings": r}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch

    if not torch.cuda.is_available():
        print("control.py: no CUDA device", file=sys.stderr)
        return 2
    for s in args.seeds.split(","):
        t0 = time.perf_counter()
        out = control_readings(args.workload, int(s), torch.device("cuda:0"))
        out["seconds"] = time.perf_counter() - t0
        out["device"] = torch.cuda.get_device_name(0)
        print(json.dumps(out), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
