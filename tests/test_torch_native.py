"""The port's host C++ loops (``presto_tpu_torch/native.py``) against
the JAX reference's on the CPU.

``connectors.tpch._uniform`` and ``page.encode_strings`` must give the
reference's output bit for bit on both of the port's paths: the C++
loop built with g++ at first use, and the numpy path a host without a
compiler keeps. Index runs that are long and affine take the fused
loop; short runs and runs that are not affine stay in numpy on either
path."""

from __future__ import annotations

import numpy as np
import pytest

from presto_tpu import page as ref_page
from presto_tpu.connectors import tpch as ref_tpch
from presto_tpu_torch import native, page
from presto_tpu_torch.connectors import tpch

PATHS = ["native", "numpy"]

#: name -> (row indices, whether the fused loop takes them)
INDEX_RUNS = {
    "arange": (np.arange(0, 1 << 17, dtype=np.int64), True),
    "arange_offset": (np.arange(123_457, 123_457 + 70_001, dtype=np.int64), True),
    "returns_map": (np.arange(0, 80_000, dtype=np.int64) * 3, True),
    "large_rows": (np.arange(2**40, 2**40 + 65_536, dtype=np.int64), True),
    "short_affine": (np.arange(10, 1010, dtype=np.int64), False),
    "one_row": (np.array([42], dtype=np.int64), False),
    "empty": (np.zeros(0, dtype=np.int64), False),
    "permuted": (
        np.random.default_rng(0).permutation(100_000).astype(np.int64), False
    ),
    "repeated": (np.repeat(np.arange(40_000, dtype=np.int64), 2), False),
    "affine_but_one": (
        np.concatenate([np.arange(70_000), [5], np.arange(70_001, 80_000)])
        .astype(np.int64),
        False,
    ),
}

RANGES = [(1, 3), (-5000, 20000), (0, 2**31), (100, 100)]


@pytest.fixture(params=PATHS)
def path(request, monkeypatch):
    """Runs the test on the native path (which must build here) or with
    the libraries taken away."""
    if request.param == "native":
        assert native.status() == "native"
    else:
        monkeypatch.setattr(native, "gen_uniform", lambda *a: None)
        monkeypatch.setattr(native, "encode_strings", lambda v: None)
    return request.param


@pytest.mark.parametrize("lo,hi", RANGES, ids=str)
@pytest.mark.parametrize("run", sorted(INDEX_RUNS))
def test_uniform_is_bit_equal_to_the_reference(path, run, lo, hi):
    idx, fused = INDEX_RUNS[run]
    tag = 702
    calls = native.gen_uniform.calls if path == "native" else 0
    got = tpch._uniform(tag, idx, lo, hi)
    want = ref_tpch._uniform(tag, idx, lo, hi)
    assert got.dtype == np.int64 and want.dtype == np.int64
    np.testing.assert_array_equal(got, want)
    if path == "native":
        assert native.gen_uniform.calls - calls == int(fused)


def _strings(n, seed):
    rng = np.random.default_rng(seed)
    words = np.array(
        ["", "a", "b", "ab", "Ab", "zz", "é", "naïve", "日本", "a b", "a\tb",
         "Customer#000000001", "Customer#000000010"],
        dtype=object,
    )
    out = words[rng.integers(0, len(words), n)].copy()
    out[rng.random(n) < 0.1] = None
    extra = rng.integers(0, 5000, n)
    wide = rng.random(n) < 0.5
    out[wide] = [f"w{k}" for k in extra[wide]]
    return list(out)


@pytest.mark.parametrize(
    "values",
    [
        _strings(10, 0),
        _strings(page.NATIVE_ENCODE_MIN_ROWS - 1, 1),
        _strings(page.NATIVE_ENCODE_MIN_ROWS, 2),
        _strings(50_000, 3),
        [None] * 5000,
        ["same"] * 5000,
    ],
    ids=["short", "below_threshold", "at_threshold", "wide", "all_null",
         "one_value"],
)
def test_encode_strings_is_bit_equal_to_the_reference(path, values):
    routed = len(values) >= page.NATIVE_ENCODE_MIN_ROWS
    calls = native.encode_strings.calls if path == "native" else 0
    ids, valid, dictionary = page.encode_strings(values)
    for force_numpy in (False, True):
        r_ids, r_valid, r_dict = ref_page.encode_strings(
            values, force_numpy=force_numpy
        )
        assert ids.dtype == r_ids.dtype == np.int32
        np.testing.assert_array_equal(ids, r_ids)
        np.testing.assert_array_equal(valid, r_valid)
        assert list(dictionary.values) == list(r_dict.values)
    if path == "native":
        assert native.encode_strings.calls - calls == int(routed)


def test_a_host_that_cannot_build_says_so_and_keeps_numpy(
    monkeypatch, tmp_path
):
    monkeypatch.setattr(native, "_libs", {})
    monkeypatch.setattr(native, "_why", {})
    monkeypatch.setattr(native, "GXX", ["no-such-compiler-for-this-test"])
    monkeypatch.setattr(native.kernels, "BUILD", tmp_path)
    status = native.status()
    assert status.startswith("numpy: ")
    assert "genstream" in status and "dict_codec" in status
    idx, _ = INDEX_RUNS["arange"]
    assert native.gen_uniform(7, idx, 1, 9) is None
    np.testing.assert_array_equal(
        tpch._uniform(7, idx, 1, 9), ref_tpch._uniform(7, idx, 1, 9)
    )
    values = _strings(5000, 4)
    assert native.encode_strings(np.asarray(values, dtype=object)) is None
    r_ids, _, _ = ref_page.encode_strings(values, force_numpy=True)
    np.testing.assert_array_equal(page.encode_strings(values)[0], r_ids)
