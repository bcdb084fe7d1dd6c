"""int128 limb arithmetic for long decimals, as elementwise torch ops.

The PyTorch counterpart of ``presto_tpu/int128.py``, with its layout: a
value is an (..., 2) int64 tensor, [..., 0] the signed high limb and
[..., 1] the low 64 bits (an unsigned quantity stored as its int64 bit
pattern). Everything is elementwise int64 work with static shapes.

Torch has no unsigned 64-bit arithmetic (``uint64`` has no add, and less
still on the card), so every unsigned step of the reference runs on
int64, whose add, subtract and multiply wrap in two's complement exactly
as uint64 would:

- an unsigned compare ``a <u b`` is the signed ``(a ^ MIN) < (b ^ MIN)``;
- a logical right shift is the arithmetic shift with the sign fill
  masked off: ``(x >> k) & (2^(64-k) - 1)``;
- the carry out of the low limb is the unsigned compare of the wrapped
  sum against an addend.
"""

from __future__ import annotations

from typing import Tuple

import torch

_I64_MIN = -(1 << 63)
_MASK32 = 0xFFFFFFFF


def _ult(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Unsigned 64-bit ``a < b`` over int64 bit patterns."""
    return (a ^ _I64_MIN) < (b ^ _I64_MIN)


def _lsr(x: torch.Tensor, k: int) -> torch.Tensor:
    """Logical right shift of an int64 bit pattern by 0 < k < 64
    (``>>`` on int64 is arithmetic: mask off the copies of the sign
    bit)."""
    return (x >> k) & ((1 << (64 - k)) - 1)


def from_i64(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sign-extend int64 -> (hi, lo) limbs."""
    x = x.to(torch.int64)
    return x >> 63, x


def add(ah, al, bh, bl):
    """(ah, al) + (bh, bl) with the carry out of the low limb."""
    lo = al + bl  # wraps (two's complement)
    carry = _ult(lo, al).to(torch.int64)
    return ah + bh + carry, lo


def neg(h, l):
    """Two's-complement negate: ~x + 1 across limbs."""
    borrow = (l != 0).to(torch.int64)
    return -h - borrow, -l


def sub(ah, al, bh, bl):
    nh, nl = neg(bh, bl)
    return add(ah, al, nh, nl)


def eq(ah, al, bh, bl):
    return (ah == bh) & (al == bl)


def lt(ah, al, bh, bl):
    """Signed 128-bit less-than: high limb signed, low limb unsigned."""
    return (ah < bh) | ((ah == bh) & _ult(al, bl))


def mul_u32(h, l, c: int):
    """Multiply by a non-negative Python int < 2**31: schoolbook on the
    32-bit halves of the low limb; the high limb wraps like the
    reference's overflow-unchecked fast path."""
    if not 0 <= c < (1 << 31):
        raise ValueError(f"mul_u32 factor out of range: {c}")
    lo32 = l & _MASK32
    hi32 = _lsr(l, 32)
    p_lo = lo32 * c  # < 2^63
    p_hi = hi32 * c  # < 2^63
    low = p_lo + ((p_hi & _MASK32) << 32)  # may wrap once
    carry = _ult(low, p_lo).to(torch.int64)
    return h * c + _lsr(p_hi, 32) + carry, low


def mul_pow10(h, l, k: int):
    """Multiply by 10**k (k >= 0) in steps below 2^31: the decimal
    rescale primitive."""
    while k > 0:
        step = min(k, 9)  # 10^9 < 2^31
        h, l = mul_u32(h, l, 10 ** step)
        k -= step
    return h, l


def _u64_to_f64(x: torch.Tensor) -> torch.Tensor:
    """The unsigned value of an int64 bit pattern as float64, rounded
    once as a uint64 conversion rounds: both 32-bit halves are exact in
    float64, so only their sum rounds."""
    return _lsr(x, 32).to(torch.float64) * (2.0 ** 32) + (
        x & _MASK32
    ).to(torch.float64)


def to_f64(h, l):
    """Approximate float64 value (for casts to DOUBLE)."""
    return h.to(torch.float64) * (2.0 ** 64) + _u64_to_f64(l)


def _divmod_u128_small(uh, ul, d: int):
    """Unsigned (uh, ul) // d for a Python 0 < d < 2**31: schoolbook
    long division in 32-bit chunks. Every partial dividend (rem << 32 |
    chunk) is below 2^63, so the signed int64 division is exact."""
    q3 = _lsr(uh, 32)
    r = q3 % d
    q3 = q3 // d
    t = (r << 32) | (uh & _MASK32)
    q2 = t // d
    r = t % d
    t = (r << 32) | _lsr(ul, 32)
    q1 = t // d
    r = t % d
    t = (r << 32) | (ul & _MASK32)
    q0 = t // d
    r = t % d
    return (q3 << 32) | q2, (q1 << 32) | q0, r


def div_pow10_half_up(h, l, k: int):
    """(h, l) / 10**k with SQL half-up rounding away from zero: the
    long-decimal downscale primitive. k <= 18 (two 10^9 chunks)."""
    if k == 0:
        return h, l
    if k > 18:
        raise NotImplementedError(
            f"long-decimal downscale by 10^{k} (>18 digits)"
        )
    is_neg = h < 0
    nh, nl = neg(h, l)
    uh = torch.where(is_neg, nh, h)
    ul = torch.where(is_neg, nl, l)
    d1 = 10 ** min(k, 9)
    qh, ql, rem = _divmod_u128_small(uh, ul, d1)
    dd = d1
    if k > 9:
        d2 = 10 ** (k - 9)
        qh, ql, r2 = _divmod_u128_small(qh, ql, d2)
        # total remainder r2 * d1 + r1 < 10^18 fits int64
        rem = r2 * d1 + rem
        dd = d1 * d2
    half = dd // 2 + dd % 2  # ceil(d/2): half-up
    carry = (rem >= half).to(torch.int64)
    qh, ql = add(qh, ql, torch.zeros_like(qh), carry)
    back_h, back_l = neg(qh, ql)
    return torch.where(is_neg, back_h, qh), torch.where(is_neg, back_l, ql)


def split(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """An (..., 2) limb tensor -> (hi, lo)."""
    return x[..., 0], x[..., 1]


def join(h: torch.Tensor, l: torch.Tensor) -> torch.Tensor:
    """(hi, lo) -> an (..., 2) limb tensor."""
    h, l = torch.broadcast_tensors(h, l)
    return torch.stack([h, l], dim=-1)
