"""Double-float (df32) arithmetic in PyTorch: the subset of
``fractalshark_tpu/ops/dblflt.py`` that the RC tail's orbit
reconstruction runs (``dblflt.py:35-120``).

value = hi + lo.  The error-free transforms (Knuth two-sum, Dekker
two-prod by splitting) are exact only when every ``*`` and ``+`` rounds
on its own: a fused multiply-add changes ``split`` and ``two_prod``.
The plain ops here are separate tensor operations, and the device twin
``csrc/df32.cuh`` is built with ``-fmad=false`` for the same reason.
Results are flushed like every other plain op (see ``hdrfloat.ftz``).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from fractalshark_tpu_torch.ops.hdrfloat import ftz


class DF(NamedTuple):
    hi: torch.Tensor
    lo: torch.Tensor


def _split_const(dtype) -> float:
    # Dekker splitter 2^ceil(p/2) + 1
    return 4097.0 if dtype == torch.float32 else 134217729.0


def two_sum(a, b):
    s = ftz(a + b)
    bb = ftz(s - a)
    err = ftz(ftz(a - ftz(s - bb)) + ftz(b - bb))
    return s, err


def quick_two_sum(a, b):
    """Requires |a| >= |b| (or a == 0)."""
    s = ftz(a + b)
    return s, ftz(b - ftz(s - a))


def split(a):
    c = ftz(_split_const(a.dtype) * a)
    hi = ftz(c - ftz(c - a))
    return hi, ftz(a - hi)


def two_prod(a, b):
    p = ftz(a * b)
    ahi, alo = split(a)
    bhi, blo = split(b)
    err = ftz(ftz(ftz(ftz(ftz(ahi * bhi) - p) + ftz(ahi * blo))
                  + ftz(alo * bhi)) + ftz(alo * blo))
    return p, err


def df_neg(a: DF) -> DF:
    return DF(-a.hi, -a.lo)


def df_add(a: DF, b: DF) -> DF:
    s1, s2 = two_sum(a.hi, b.hi)
    t1, t2 = two_sum(a.lo, b.lo)
    s1, s2 = quick_two_sum(s1, ftz(s2 + t1))
    s1, s2 = quick_two_sum(s1, ftz(s2 + t2))
    return DF(s1, s2)


def df_sub(a: DF, b: DF) -> DF:
    return df_add(a, df_neg(b))


def df_mul(a: DF, b: DF) -> DF:
    p1, p2 = two_prod(a.hi, b.hi)
    p2 = ftz(ftz(p2 + ftz(a.hi * b.lo)) + ftz(a.lo * b.hi))
    return DF(*quick_two_sum(p1, p2))


def df_sqr(a: DF) -> DF:
    p1, p2 = two_prod(a.hi, a.hi)
    p2 = ftz(p2 + ftz(ftz(2.0 * a.hi) * a.lo))
    return DF(*quick_two_sum(p1, p2))


def df_mul_pow2(a: DF, s: float) -> DF:
    """Multiply by an exact power of two."""
    return DF(ftz(a.hi * s), ftz(a.lo * s))
