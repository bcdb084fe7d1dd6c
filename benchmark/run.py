"""Run one cell of the port's benchmark on the card.

    python3 benchmark/run.py --workload tpch_sf10.scan_agg --seed 7 \
        --seconds 30 --trace 0

Prints, as the last line of standard output, one JSON object: whether
every answer of the window was correct, the queries attempted and
failed, the cell's end-to-end metrics (``--trace 0``) or its per-layer
metrics and a breakdown of the traced window (``--trace 1``), the
device, and last the numbers compared with their limits, which also
end standard error. Exits with 2 without a CUDA device, and with 3 if a
JAX module or the JAX package was loaded.
"""

import time

_T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent

# every cache of the program at a fixed place inside the checkout
os.environ["TRITON_CACHE_DIR"] = str(ROOT / ".bench_cache" / "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / ".bench_cache" / "torch_extensions")
os.environ["USE_FLAX"] = "0"
# one host thread for the program's CPU tensor and numpy work: on a
# shared host, runs with a pool of threads spread more
for _var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ[_var] = "1"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    sys.path.insert(0, str(ROOT))
    import torch

    torch.set_num_threads(1)

    from benchmark import harness, layout

    bench = layout.benchmark()
    cell = layout.workload(bench, args.workload)
    if not torch.cuda.is_available():
        print("run.py: no CUDA device", file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell["chips"]:
        print(f"run.py: {cell['chips']} CUDA devices wanted, "
              f"{torch.cuda.device_count()} present", file=sys.stderr)
        return 2
    try:
        result = harness.run_cell(args.workload, args.seed, args.seconds,
                                  bool(args.trace), "cuda:0", _T0, bench=bench)
    except harness.ForbiddenModules as e:
        print(f"run.py: {e}", file=sys.stderr)
        return 3
    print(f"correct: {result['correct']}", file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
