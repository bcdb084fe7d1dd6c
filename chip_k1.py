#!/usr/bin/env python3
"""K1 (``presto_tpu_torch/csrc/onehot_reduce.cu``) alone, at the shapes
the main path gives it, on one GPU.

    python3 chip_k1.py [--port DIR] [--out FILE]

Builds the kernel, then runs each case below through chip_smoke.py's
own kernel-phase checks (``fused_case`` for a single call,
``lanes_case`` for a lane call): the kernel held against its plain
PyTorch version, two launches bit-identical, the launches of one call
counted, and the kernel, plain and library times beside the bound:

- ``q1 fused``: Q1's aggregation at SF1, K = 8 over the 2^23-row bucket
  (chip_smoke.py's headline);
- ``q1 shard 2^24`` and ``q1 2^26``: the same columns repeated to a
  distributed shard's and the parquet Q1's bucket sizes;
- ``q1 8 lanes``: the serve phase's V3 batch, 8 lanes of that bucket,
  lane l keeping the rows shipped by its cutoff
  (chip_smoke.Q1_CUTOFFS), every column repeated per lane as
  ``page.tile_lanes`` lays it out, through ``onehot_reduce_lanes``,
  beside the 8 lanes' scalar calls one at a time;
- ``merge k19 n100`` and ``small k40 n1000``: small calls (an ICI merge
  task's final and its like) of every op and value type;
- an empty launch (``chip_smoke.empty_launch_ms``: the floor any launch
  pays).

Every case prints one line and one JSON record (``--out`` gets them all
as a JSON list). ``--port DIR`` times the ``presto_tpu_torch`` of
another checkout (built into its own ``build/``) with this script's
cases and ``chip_smoke.py`` helpers: compare two versions in one call on
one card, in turns. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent


def q1_lane_inputs(dev, lanes: int):
    """The V3 batch's lane call: gid per lane (Q1's key where the row
    shipped by the lane's cutoff, else the dead segment 6) and Q1's 8
    requests with each column repeated once per lane."""
    import numpy as np
    import torch

    import chip_smoke as S

    d = S.sf1_lineitem()
    n = S.SF1_LINEITEM_ROWS
    _, reqs, nseg = S.q1_inputs(dev)
    ship = np.full(S.CAPACITY, np.iinfo(np.int64).max, np.int64)
    ship[:n] = d["l_shipdate"].astype(np.int64)
    ship = torch.from_numpy(ship).to(dev)
    cuts = [S.epoch_days(c) for c in S.Q1_CUTOFFS[:lanes]]
    # Q1's key of every row (its own cutoff left aside), dead padding
    rf, ls = d["l_returnflag"], d["l_linestatus"]
    full = np.full(S.CAPACITY, nseg, np.int32)
    full[:n] = rf.ids.astype(np.int32) * len(ls.values) + ls.ids
    full = torch.from_numpy(full).to(dev)
    gid = torch.cat([
        torch.where(ship <= c, full, nseg).to(torch.int32) for c in cuts
    ])
    tiled = [(op, None if x is None else x.repeat(lanes), None)
             for op, x, _ in reqs]
    return gid, tiled, nseg


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--port", default=str(ROOT),
                    help="the checkout whose presto_tpu_torch is timed")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("chip_k1.py: CUDA is not available", file=sys.stderr)
        return 2
    port = Path(args.port).resolve()
    if not (port / "presto_tpu_torch").is_dir():
        print(f"chip_k1.py: no presto_tpu_torch/ in {port}", file=sys.stderr)
        return 2
    sys.path.insert(0, str(port))
    # this script's chip_smoke.py, whichever port is timed
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", ROOT / "chip_smoke.py")
    S = importlib.util.module_from_spec(spec)
    sys.modules["chip_smoke"] = S
    spec.loader.exec_module(S)
    import numpy as np

    from presto_tpu_torch import kernels

    card = S.card_line()
    print(f"{port}: {card}", flush=True)
    kernels.load("onehot_reduce")
    dev = torch.device("cuda")
    records = []
    g, reqs, nseg = S.q1_inputs(dev)
    records.append(S.fused_case("q1 fused", g, reqs, nseg, card))
    single_ms = records[-1]["ms"]
    for reps, label in ((2, "q1 shard 2^24"), (8, "q1 2^26")):
        big = [(op, None if x is None else x.repeat(reps), None)
               for op, x, _ in reqs]
        records.append(S.fused_case(label, g.repeat(reps), big, nseg, card))
        del big
    del g, reqs
    lanes = 8
    g, reqs, nseg = q1_lane_inputs(dev, lanes)
    records.append(S.lanes_case("q1 8 lanes", g, reqs, nseg, lanes, card,
                                single_ms=single_ms))
    del g, reqs
    torch.cuda.empty_cache()

    rng = np.random.default_rng(17)
    for label, k, n in (("merge k19 n100", 19, 100),
                        ("small k40 n1000", 40, 1000)):
        g, reqs = S.small_inputs(rng, n, k, 6, dev)
        records.append(S.fused_case(label, g, reqs, 6, card))
    floor = S.empty_launch_ms()
    records.append({"label": "empty launch", "ms": floor})
    print(f"empty launch: {floor:.4f} ms [{card}]", flush=True)
    for rec in records:
        rec["card"] = card
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(records, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
