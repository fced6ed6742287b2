"""HDRFloat in PyTorch: (mantissa, int32 exponent), the port of
``fractalshark_tpu/ops/hdrfloat.py``.

value = mantissa * 2**exp; the mantissa stays unreduced between
operations and is renormalised to ±[1, 2) only at explicit ``reduce``
points.  Every function here is elementwise over tensors of any shape
and follows the JAX reference operation for operation, so the float
rounding sequence is the same.  ``csrc/hdr.cuh`` is the device twin the
CUDA kernels share; the two are held bit-identical on the card.

Floating-point mode.  The reference's CPU backend (XLA:CPU) runs with
subnormals flushed to zero on input and output, and the CUDA kernels
are built with ``-ftz=true`` to match.  The plain ops reproduce that
here by flushing every arithmetic result (``ftz``), and the host tables
are flushed once when they are uploaded (``ops/tables.py``), so no
subnormal ever reaches an operation.  No operation is contracted into a
fused multiply-add: each ``*`` and ``+`` is a separate rounding, as the
kernels are built with ``-fmad=false``.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

# INT32_MIN >> 3: the zero sentinel exponent (HDRFloat.h:50-58)
MIN_BIG_EXPONENT = int(-(2 ** 31) // 8)
EXPONENT_DIFF_IGNORED = 120

_F32_BIAS = 127
_F64_BIAS = 1023
_SIGN_FRAC_MASK = int(np.uint32(0x807FFFFF).view(np.int32))
# the smallest normal number of each type, as a 0-dim tensor (an op with a
# tensor operand is cheaper than with a Python float on small tensors)
_TINY = {torch.float32: torch.tensor(float(np.finfo(np.float32).tiny),
                                     dtype=torch.float32),
         torch.float64: torch.tensor(float(np.finfo(np.float64).tiny),
                                     dtype=torch.float64)}


class HDR(NamedTuple):
    m: torch.Tensor  # mantissa (f32 or f64)
    e: torch.Tensor  # int32 exponent


class HDRComplex(NamedTuple):
    re: torch.Tensor
    im: torch.Tensor
    e: torch.Tensor


# ---------------------------------------------------------------- helpers


def ftz(x: torch.Tensor) -> torch.Tensor:
    """Flush subnormals to a zero of the same sign (FTZ).  A subnormal
    (and a zero) is multiplied by 0.0, which keeps its sign; every other
    value, inf and NaN included, by 1.0 (a NaN's |x| >= tiny is false, and
    NaN * 0.0 is NaN): the bits of ``where(|x| < tiny, x * 0.0, x)``."""
    return x * (x.abs() >= _TINY[x.dtype])


def flush_np(a: np.ndarray) -> np.ndarray:
    """Host-side flush of a float table before upload (DAZ for inputs)."""
    a = np.asarray(a)
    if a.dtype.kind != "f":
        return a
    tiny = np.finfo(a.dtype).tiny
    return np.where(np.abs(a) < tiny, a * 0, a).astype(a.dtype)


def _frexp2(m: torch.Tensor):
    """(mantissa', exp) with m == mantissa' * 2**exp, |mantissa'| in
    [1, 2); zeros pass through with exponent 0."""
    zero = m == 0
    if m.dtype == torch.float32:
        bits = m.view(torch.int32)
        f_exp = ((bits >> 23) & 0xFF) - _F32_BIAS
        norm = ((bits & _SIGN_FRAC_MASK) | 0x3F800000).view(torch.float32)
        return torch.where(zero, m, norm), torch.where(zero, 0, f_exp)
    mm, ee = torch.frexp(m)
    return (torch.where(zero, m, mm * 2.0),
            torch.where(zero, 0, (ee - 1).to(torch.int32)))


def pow2i(shift: torch.Tensor, dtype) -> torch.Tensor:
    """2.0**shift as dtype, exact; the shift is clamped to the normal
    exponent range."""
    if dtype == torch.float32:
        s = shift.clamp(-126, 127).to(torch.int32)
        return ((s + _F32_BIAS) << 23).view(torch.float32)
    s = shift.clamp(-1022, 1023).to(torch.int64)
    return ((s + _F64_BIAS) << 52).view(torch.float64)


# ------------------------------------------------------------- reduction


def reduce(x: HDR) -> HDR:
    mm, fe = _frexp2(x.m)
    return HDR(mm, torch.where(x.m == 0, MIN_BIG_EXPONENT, x.e + fe))


def reduce_complex(z: HDRComplex) -> HDRComplex:
    """Normalise a shared-exponent complex by its Chebyshev-largest
    component."""
    big = torch.maximum(z.re.abs(), z.im.abs())
    _, fe = _frexp2(big)
    zero = big == 0
    fe = torch.where(zero, 0, fe)
    scale = pow2i(-fe, z.re.dtype)
    return HDRComplex(ftz(z.re * scale), ftz(z.im * scale),
                      torch.where(zero, MIN_BIG_EXPONENT, z.e + fe))


# ------------------------------------------------------------ arithmetic


def add(a: HDR, b: HDR) -> HDR:
    """Unreduced add; gaps past EXPONENT_DIFF_IGNORED underflow the
    smaller operand to zero (HDRFloat.h:122)."""
    a_big = a.e >= b.e
    eb = torch.where(a_big, a.e, b.e)
    mb = torch.where(a_big, a.m, b.m)
    ms = torch.where(a_big, b.m, a.m)
    diff = eb - torch.where(a_big, b.e, a.e)
    scale = pow2i(-diff.clamp(max=EXPONENT_DIFF_IGNORED + 6), mb.dtype)
    return HDR(ftz(mb + ftz(ms * scale)), eb)


def negate(x: HDR) -> HDR:
    return HDR(-x.m, x.e)


def sub(a: HDR, b: HDR) -> HDR:
    return add(a, negate(b))


def mul(a: HDR, b: HDR) -> HDR:
    return HDR(ftz(a.m * b.m), a.e + b.e)


def square(a: HDR) -> HDR:
    return HDR(ftz(a.m * a.m), a.e + a.e)


def mul_pow2(a: HDR, k: int) -> HDR:
    return HDR(a.m, a.e + k)


# ----------------------------------------------------------- comparisons


def gt_reduced(a: HDR, b: HDR):
    return (a.e > b.e) | ((a.e == b.e) & (a.m > b.m))


def lt_reduced(a: HDR, b: HDR):
    return (a.e < b.e) | ((a.e == b.e) & (a.m < b.m))


def lte_reduced(a: HDR, b: HDR):
    return ~gt_reduced(a, b)


def lt_unreduced(a: HDR, b: HDR):
    """a < b for unreduced non-negative operands (proof in the
    reference's hdrfloat.py block comment)."""
    return a.m < ftz(b.m * pow2i(b.e - a.e, a.m.dtype))


def gt_pow2_unreduced(a: HDR, k: int):
    return a.m > pow2i(k - a.e, a.m.dtype)


# ---------------------------------------------------------------- complex


def complex_from_hdr(re: HDR, im: HDR) -> HDRComplex:
    e = torch.maximum(re.e, im.e)
    dre = (e - re.e).clamp(max=EXPONENT_DIFF_IGNORED + 6)
    dim = (e - im.e).clamp(max=EXPONENT_DIFF_IGNORED + 6)
    return HDRComplex(ftz(re.m * pow2i(-dre, re.m.dtype)),
                      ftz(im.m * pow2i(-dim, im.m.dtype)), e)


def complex_zero(shape, dtype=torch.float32, device=None) -> HDRComplex:
    return HDRComplex(torch.zeros(shape, dtype=dtype, device=device),
                      torch.zeros(shape, dtype=dtype, device=device),
                      torch.full(shape, MIN_BIG_EXPONENT, dtype=torch.int32,
                                 device=device))


def complex_add(a: HDRComplex, b: HDRComplex) -> HDRComplex:
    a_big = a.e >= b.e
    e = torch.where(a_big, a.e, b.e)
    diff = (e - torch.where(a_big, b.e, a.e)).clamp(
        max=EXPONENT_DIFF_IGNORED + 6)
    s = pow2i(-diff, a.re.dtype)
    re = torch.where(a_big, ftz(a.re + ftz(b.re * s)),
                     ftz(b.re + ftz(a.re * s)))
    im = torch.where(a_big, ftz(a.im + ftz(b.im * s)),
                     ftz(b.im + ftz(a.im * s)))
    return HDRComplex(re, im, e)


def complex_mul(a: HDRComplex, b: HDRComplex) -> HDRComplex:
    return HDRComplex(ftz(ftz(a.re * b.re) - ftz(a.im * b.im)),
                      ftz(ftz(a.re * b.im) + ftz(a.im * b.re)),
                      a.e + b.e)


def complex_sqr(a: HDRComplex) -> HDRComplex:
    return HDRComplex(ftz(ftz(a.re * a.re) - ftz(a.im * a.im)),
                      ftz(ftz(2.0 * a.re) * a.im),
                      a.e + a.e)


def complex_mul_pow2(a: HDRComplex, k: int) -> HDRComplex:
    return HDRComplex(a.re, a.im, a.e + k)


def norm_squared(a: HDRComplex) -> HDR:
    return HDR(ftz(ftz(a.re * a.re) + ftz(a.im * a.im)), a.e + a.e)


def chebychev_norm(a: HDRComplex) -> HDR:
    return HDR(torch.maximum(a.re.abs(), a.im.abs()), a.e)
