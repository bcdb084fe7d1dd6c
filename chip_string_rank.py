#!/usr/bin/env python3
"""Host time of turning a parquet string column into dictionary ids, two ways.

    python3 chip_string_rank.py [--scale sf10] [--runs 2] [--out FILE]

Writes the string columns that chip_smoke.py's F1 reads (lineitem's
``l_returnflag`` and ``l_linestatus`` at ``--scale``) to one parquet file
in a temporary directory, in row groups of 2^20 rows as F1 writes them.
Then it takes the splits that the port's parquet connector gives a
scan of that file (2^22 rows each, as ``LocalQueryRunner`` asks for
them when it stages a scan whole) and ranks each split's columns both
ways:

- ``arrow``: the port's ``connectors/_arrow.py::_encode_arrow_strings``
  (arrow's ``dictionary_encode`` finds the distinct values, then only
  those are sorted and the codes remapped to their ranks);
- ``numpy``: ``numpy_unique_rank`` below, the JAX package's ranking
  (``np.unique`` and ``np.searchsorted`` over one Python string per
  row).

Both must give the same ids, valid mask and dictionary. It prints, per
column, the best of ``--runs`` passes over all splits for each way, the
card's name and power limit where ``nvidia-smi`` answers, and one JSON
line last (also written to ``--out``). The work runs on the host; the
file is read from the page cache (warm).
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

COLUMNS = ["l_returnflag", "l_linestatus"]


def numpy_unique_rank(combined):
    """The JAX package's ranking: arrow string column -> (int32 ids,
    valid, sorted dictionary), one Python string per row."""
    valid = np.asarray(combined.is_valid(), dtype=bool)
    values = combined.fill_null("").to_numpy(zero_copy_only=False)
    values = values.astype(object)
    present = values[valid].astype(str)
    uniq = np.unique(present) if len(present) else np.empty(0, object)
    ids = np.zeros(len(values), dtype=np.int32)
    if len(present):
        ids[valid] = np.searchsorted(
            uniq.astype(str), present
        ).astype(np.int32)
    return ids, valid, uniq.astype(object)


def card() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            check=True, capture_output=True, text=True, timeout=60,
        )
    except (OSError, subprocess.SubprocessError):
        return "no nvidia-smi"
    return out.stdout.strip().splitlines()[0]


def write_file(path: str, scale: str) -> int:
    import pyarrow as pa
    import pyarrow.parquet as pq

    from presto_tpu_torch.connectors.tpch import SCHEMAS, TpchGenerator

    gen = TpchGenerator(SCHEMAS[scale])
    n = gen.counts["lineitem"]

    def part(lo, hi):
        d = gen.generate("lineitem", lo, hi, COLUMNS)
        return pa.table([
            pa.DictionaryArray.from_arrays(
                pa.array(np.asarray(d[c].ids, dtype=np.int32)),
                pa.array([str(x) for x in d[c].values]),
            ).cast(pa.string())
            for c in COLUMNS
        ], names=COLUMNS)

    ranges = [(lo, min(lo + (1 << 22), n)) for lo in range(0, n, 1 << 22)]
    with ThreadPoolExecutor(max_workers=8) as pool:
        tables = list(pool.map(lambda r: part(*r), ranges))
    with pq.ParquetWriter(path, tables[0].schema) as w:
        for t in tables:
            w.write_table(t, row_group_size=1 << 20)
    return n


def split_columns(root: str):
    """Each split's string columns as the parquet connector reads them
    (the arrow arrays it hands ``arrow_column_to_payload``)."""
    from presto_tpu_torch.connectors import parquet as parquet_mod
    from presto_tpu_torch.connectors.spi import TableHandle

    conn = parquet_mod.ParquetConnector(root=root)
    handle = TableHandle("lake", "tpch", "lineitem")
    src = conn.get_splits(handle, target_split_rows=1 << 22)
    convert = parquet_mod._arrow_column_to_payload
    captured = []

    def capture(arr, t):
        captured.append(arr.combine_chunks())
        return convert(arr, t)

    parquet_mod._arrow_column_to_payload = capture
    try:
        while not src.exhausted:
            for split in src.next_batch(64):
                conn.create_page_source(split, COLUMNS)
    finally:
        parquet_mod._arrow_column_to_payload = convert
    # the connector converts a split's columns in the order asked
    return {c: captured[i::len(COLUMNS)] for i, c in enumerate(COLUMNS)}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scale", default="sf10")
    ap.add_argument("--runs", type=int, default=2)
    ap.add_argument("--out", default="")
    args = ap.parse_args()

    from presto_tpu_torch.connectors._arrow import _encode_arrow_strings

    where = card()
    root = tempfile.mkdtemp(prefix="string-rank-")
    try:
        os.makedirs(os.path.join(root, "tpch"))
        t0 = time.perf_counter()
        rows = write_file(os.path.join(root, "tpch", "lineitem.parquet"),
                          args.scale)
        print(f"wrote {rows} rows of {args.scale} lineitem's "
              f"{', '.join(COLUMNS)} in {time.perf_counter() - t0:.2f} s",
              flush=True)
        seen = split_columns(root)
        result = {"scale": args.scale, "rows": rows, "card": where,
                  "columns": {}}
        for col in COLUMNS:
            arrays = seen[col]
            for a in arrays:
                got, want = _encode_arrow_strings(a), numpy_unique_rank(a)
                assert np.array_equal(got[0], want[0]), col
                assert np.array_equal(got[1], want[1]), col
                assert list(got[2]) == list(want[2]), col
            best = {}
            for name, fn in (("arrow", _encode_arrow_strings),
                             ("numpy", numpy_unique_rank)):
                times = []
                for _ in range(args.runs):
                    t0 = time.perf_counter()
                    for a in arrays:
                        fn(a)
                    times.append(time.perf_counter() - t0)
                best[name] = min(times)
            result["columns"][col] = {
                "splits": len(arrays), "arrow_s": best["arrow"],
                "numpy_s": best["numpy"],
            }
            print(f"{col}: {len(arrays)} splits, arrow {best['arrow']:.4f} s,"
                  f" numpy {best['numpy']:.4f} s (best of {args.runs}) "
                  f"[{where}]", flush=True)
        result["arrow_s"] = sum(
            v["arrow_s"] for v in result["columns"].values())
        result["numpy_s"] = sum(
            v["numpy_s"] for v in result["columns"].values())
    finally:
        shutil.rmtree(root, ignore_errors=True)
    line = json.dumps(result)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            f.write(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
