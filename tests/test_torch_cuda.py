"""The port's CUDA kernels on the card, against their plain versions.

Every test here needs an NVIDIA GPU and skips without one: a CUDA kernel
has no CPU mode, and on the CPU the wrappers take the plain versions,
which the parity tests (tests/test_torch_aggregation.py) cover. On a
machine with a card, without JAX, run

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -q

This file imports neither JAX nor the JAX package.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from presto_tpu_torch.ops.aggregation import (
    onehot_reduce,
    onehot_reduce_plain,
)

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


def _inputs(rows, nseg, dtype, with_valid, seed, dev):
    """Segment ids with dead (== nseg) and out-of-range rows, one empty
    segment, values with a NaN for floats, and an optional null mask."""
    rng = np.random.default_rng(seed)
    g = rng.integers(-1, nseg + 2, rows).astype(np.int32)
    if nseg > 1:
        g[g == nseg - 1] = nseg  # the last segment stays empty
    valid = rng.random(rows) < 0.8 if with_valid else None
    if dtype == torch.int64:
        x = rng.integers(-(2**40), 2**40, rows, dtype=np.int64)
    else:
        x = rng.standard_normal(rows) * 1e3
        if rows:
            x[rows // 2] = np.nan
    tx = torch.from_numpy(x).to(dtype=dtype, device=dev)
    tv = None if valid is None else torch.from_numpy(valid).to(dev)
    return torch.from_numpy(g).to(dev), tx, tv


def _assert_agrees(got, want, op, abs_sum):
    """Integer results and float min/max exactly; float sums within a
    relative ``tol`` of each segment's sum of |x|, because the kernel
    adds in another order than the plain version (1e-12 for float64;
    1e-5 for float32, the bound tools/pallas_groupby.py holds the TPU
    kernel to)."""
    assert got.dtype == want.dtype and got.shape == want.shape
    if not got.is_floating_point():
        assert torch.equal(got, want), (got, want)
        return
    nan = torch.isnan(want)
    assert torch.equal(torch.isnan(got), nan)
    if op in ("min", "max"):
        assert torch.equal(got[~nan], want[~nan]), (got, want)
        return
    tol = 1e-12 if got.dtype == torch.float64 else 1e-5
    err = (got[~nan].double() - want[~nan].double()).abs()
    assert bool((err <= tol * abs_sum[~nan].double()).all()), (got, want)


#: (op, value dtype); count takes no values, so one dtype covers it
OPS = [("count", torch.int64)] + [
    (op, dtype)
    for op in ("sum", "min", "max")
    for dtype in (torch.int64, torch.float64, torch.float32)
]


@pytest.mark.parametrize("op,dtype", OPS)
@pytest.mark.parametrize(
    "rows,nseg", [(0, 6), (1, 1), (1000, 6), (70_001, 256), (1_000_003, 12)]
)
@pytest.mark.parametrize("with_valid", [False, True])
def test_onehot_reduce_matches_plain(cuda, op, dtype, rows, nseg, with_valid):
    g, x, v = _inputs(rows, nseg, dtype, with_valid, rows + nseg, cuda)
    if op == "count":
        x = None
    before = onehot_reduce.launches
    got = onehot_reduce(g, x, v, nseg, op)
    want = onehot_reduce_plain(g, x, v, nseg, op)
    torch.cuda.synchronize()
    assert onehot_reduce.launches == before + 1
    abs_sum = None
    if op == "sum" and x.is_floating_point():
        abs_sum = onehot_reduce_plain(g, x.abs(), v, nseg, "sum")
    _assert_agrees(got, want, op, abs_sum)


def test_onehot_reduce_takes_strided_inputs(cuda):
    g, x, v = _inputs(20_000, 6, torch.int64, True, 3, cuda)
    got = onehot_reduce(g[::2], x[::2], v[::2], 6, "sum")
    want = onehot_reduce_plain(g[::2], x[::2], v[::2], 6, "sum")
    assert torch.equal(got, want)


def test_onehot_reduce_int64_sum_wraps_like_the_plain_version(cuda):
    g = torch.zeros(4, dtype=torch.int32, device=cuda)
    x = torch.full((4,), 2**62, dtype=torch.int64, device=cuda)
    got = onehot_reduce(g, x, None, 1, "sum")
    assert torch.equal(got, onehot_reduce_plain(g, x, None, 1, "sum"))


def test_onehot_reduce_refuses_mixed_devices(cuda):
    g = torch.zeros(8, dtype=torch.int32, device=cuda)
    x = torch.zeros(8, dtype=torch.int64)
    with pytest.raises(ValueError, match="device"):
        onehot_reduce(g, x, None, 4, "sum")
