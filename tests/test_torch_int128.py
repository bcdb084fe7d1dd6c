"""Parity of the port's int128 limb arithmetic (presto_tpu_torch.int128)
with Python's integers and with the reference's ``presto_tpu.int128``.

The reference runs its unsigned steps on ``jnp.uint64``; the port runs
them on wrapping int64 (torch has no uint64 add). The values straddle
every carry and sign boundary: 0, +-1, +-2^63 and their neighbours,
2^64 - 1, +-2^64, the int128 extremes and seeded values spread over the
whole range. Integers are compared exactly, floats bit for bit."""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from presto_tpu import int128 as RI
from presto_tpu_torch import int128 as PI
from presto_tpu_torch import types as PT
from torch_parity import one_torch_thread  # noqa: F401

M = 1 << 127
EDGES = [
    0, 1, -1, (1 << 63) - 1, -(1 << 63), 1 << 63, -(1 << 63) - 1,
    (1 << 64) - 1, 1 << 64, -(1 << 64), (1 << 64) + 1, -(1 << 64) + 1,
    (1 << 100) + 5, -(1 << 100) - 7, M - 1, -M, 10 ** 30 + 5 * 10 ** 11,
    -(10 ** 30) - 5 * 10 ** 11, 15, 25, -15, -25, 449, 450, -450,
]


def _values(seed: int, n: int = 200):
    rng = np.random.default_rng(seed)
    wide = [
        int.from_bytes(rng.bytes(16), "little", signed=True)
        for _ in range(n)
    ]
    # around the limb boundary, where carries and borrows happen
    near = [
        int(x) + (int(s) << 64)
        for x, s in zip(
            rng.integers(-(2**62), 2**62, n), rng.integers(-3, 4, n)
        )
    ]
    return EDGES + wide + near


def _wrap(x: int) -> int:
    """x reduced to a signed 128-bit value (two's-complement wrap)."""
    x %= 1 << 128
    return x - (1 << 128) if x >= M else x


def _port(vals):
    limbs = torch.from_numpy(PT.int128_limbs(vals))
    return limbs[:, 0], limbs[:, 1]


def _ref(vals):
    limbs = PT.int128_limbs(vals)
    return jnp.asarray(limbs[:, 0]), jnp.asarray(limbs[:, 1])


def _back(h, l):
    return [PT.int128_value(int(a), int(b)) for a, b in zip(h, l)]


def _same(port_pair, ref_pair):
    for p, r in zip(port_pair, ref_pair, strict=True):
        np.testing.assert_array_equal(p.numpy(), np.asarray(r))


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("op", ["add", "sub", "eq", "lt"])
def test_binary_ops_match_python_and_reference(op, seed):
    a = _values(seed)
    b = list(reversed(a))
    got = getattr(PI, op)(*_port(a), *_port(b))
    want = getattr(RI, op)(*_ref(a), *_ref(b))
    if op in ("eq", "lt"):
        py = [x == y if op == "eq" else x < y for x, y in zip(a, b)]
        assert got.tolist() == py
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        return
    py = [_wrap(x + y if op == "add" else x - y) for x, y in zip(a, b)]
    assert _back(*got) == py
    _same(got, want)


@pytest.mark.parametrize("seed", [0, 1])
def test_neg_and_from_i64(seed):
    a = _values(seed)
    got = PI.neg(*_port(a))
    assert _back(*got) == [_wrap(-x) for x in a]
    _same(got, RI.neg(*_ref(a)))
    small = np.asarray(
        [x for x in a if -(1 << 63) <= x < (1 << 63)], np.int64
    )
    got = PI.from_i64(torch.from_numpy(small))
    assert _back(*got) == small.tolist()
    _same(got, RI.from_i64(jnp.asarray(small)))


@pytest.mark.parametrize("c", [0, 1, 7, 10, 10 ** 9, (1 << 31) - 1])
def test_mul_u32(c):
    a = _values(2)
    got = PI.mul_u32(*_port(a), c)
    assert _back(*got) == [_wrap(x * c) for x in a]
    _same(got, RI.mul_u32(*_ref(a), c))


def test_mul_u32_refuses_a_wide_factor():
    with pytest.raises(ValueError, match="out of range"):
        PI.mul_u32(*_port([1]), 1 << 31)


@pytest.mark.parametrize("k", [0, 1, 4, 9, 10, 18])
def test_mul_pow10(k):
    a = [x for x in _values(3) if abs(x) < (1 << 60)]
    got = PI.mul_pow10(*_port(a), k)
    assert _back(*got) == [_wrap(x * 10 ** k) for x in a]
    _same(got, RI.mul_pow10(*_ref(a), k))


@pytest.mark.parametrize("k", [1, 2, 9, 12, 18])
def test_div_pow10_half_up(k):
    a = [x for x in _values(4) if x != -M]
    f = 10 ** k
    got = PI.div_pow10_half_up(*_port(a), k)
    assert _back(*got) == [
        (abs(v) + f // 2) // f * (1 if v >= 0 else -1) for v in a
    ]
    _same(got, RI.div_pow10_half_up(*_ref(a), k))


def test_div_pow10_refuses_more_than_18_digits():
    with pytest.raises(NotImplementedError, match="10\\^19"):
        PI.div_pow10_half_up(*_port([1]), 19)


@pytest.mark.parametrize("seed", [0, 5])
def test_to_f64_is_bit_equal_to_the_reference(seed):
    """Bit-equal to the reference: hi * 2^64 plus the low limb rounded
    as a uint64 -> float64 conversion rounds it, so off the Python int
    by at most the low limb's rounding (2^11) and the sum's."""
    a = _values(seed)
    got = PI.to_f64(*_port(a))
    np.testing.assert_array_equal(got.numpy(), np.asarray(RI.to_f64(*_ref(a))))
    for x, f in zip(a, got.tolist()):
        assert abs(f - x) <= abs(x) * 2.0 ** -52 + 2.0 ** 11
