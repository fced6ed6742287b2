"""Minimal host-side HDR scalar: (float mantissa, int exp2) with
unbounded exponent. Used where host code needs magnitudes far outside
f64 range (periodicity radii, dzdc derivatives at deep zoom) without
paying HighPrecision cost. Mirrors the semantics of ops/hdrfloat.py at
scalar granularity."""

from __future__ import annotations

import math
from dataclasses import dataclass

from fractalshark_tpu_torch.core.highprecision import HighPrecision


@dataclass(frozen=True, slots=True)
class HD:
    m: float  # mantissa; canonical |m| in [1,2) (or 0.0)
    e: int    # exponent: value = m * 2**e

    @staticmethod
    def zero() -> "HD":
        return HD(0.0, 0)

    @staticmethod
    def from_float(x: float) -> "HD":
        if x == 0.0:
            return HD(0.0, 0)
        m, e = math.frexp(x)  # m in [0.5,1)
        return HD(m * 2.0, e - 1)

    @staticmethod
    def from_hp(x: HighPrecision) -> "HD":
        m, e = x.mantissa_exp2()
        if m == 0.0:
            return HD(0.0, 0)
        return HD(m * 2.0, e - 1)

    def reduce(self) -> "HD":
        if self.m == 0.0:
            return HD(0.0, 0)
        m, e = math.frexp(self.m)
        return HD(m * 2.0, self.e + e - 1)

    def __mul__(self, o: "HD") -> "HD":
        return HD(self.m * o.m, self.e + o.e).reduce()

    def __add__(self, o: "HD") -> "HD":
        if self.m == 0.0:
            return o
        if o.m == 0.0:
            return self
        big, small = (self, o) if self.e >= o.e else (o, self)
        d = big.e - small.e
        if d > 128:
            return big
        return HD(big.m + math.ldexp(small.m, -d), big.e).reduce()

    def __sub__(self, o: "HD") -> "HD":
        return self + HD(-o.m, o.e)

    def mul_pow2(self, k: int) -> "HD":
        if self.m == 0.0:
            return self
        return HD(self.m, self.e + k)

    def mul_float(self, s: float) -> "HD":
        return HD(self.m * s, self.e).reduce()

    def abs(self) -> "HD":
        return HD(abs(self.m), self.e)

    def lt(self, o: "HD") -> bool:
        """|self| < |o| for non-negative reduced values."""
        a, b = self.reduce(), o.reduce()
        if a.m == 0.0:
            return b.m != 0.0
        if b.m == 0.0:
            return False
        if a.e != b.e:
            return a.e < b.e
        return a.m < b.m

    def to_float(self) -> float:
        if self.m == 0.0:
            return 0.0
        if self.e > 1023:
            return math.inf if self.m > 0 else -math.inf
        if self.e < -1073:
            return 0.0
        return math.ldexp(self.m, self.e)

    def __repr__(self):
        return f"HD({self.m}*2^{self.e})"


@dataclass(frozen=True, slots=True)
class HDC:
    """Host complex HDR: value = m * 2**e with m a python complex whose
    Chebyshev norm is kept in [1,2) by reduce() (or 0).  Mirrors
    HDRFloatComplex's shared-exponent layout for the LA table builder."""
    m: complex
    e: int

    @staticmethod
    def zero() -> "HDC":
        return HDC(0j, 0)

    @staticmethod
    def from_complex(z: complex) -> "HDC":
        return HDC(complex(z), 0).reduce()

    def reduce(self) -> "HDC":
        big = max(abs(self.m.real), abs(self.m.imag))
        if big == 0.0:
            return HDC(0j, 0)
        _, e2 = math.frexp(big)
        k = e2 - 1  # cheb(m) in [1,2) after scaling by 2^-k
        return HDC(complex(math.ldexp(self.m.real, -k),
                           math.ldexp(self.m.imag, -k)), self.e + k)

    def __mul__(self, o: "HDC") -> "HDC":
        return HDC(self.m * o.m, self.e + o.e).reduce()

    def mul_hd(self, s: HD) -> "HDC":
        return HDC(self.m * s.m, self.e + s.e).reduce()

    def mul_float(self, s: float) -> "HDC":
        return HDC(self.m * s, self.e).reduce()

    def __add__(self, o: "HDC") -> "HDC":
        if self.m == 0:
            return o
        if o.m == 0:
            return self
        big, small = (self, o) if self.e >= o.e else (o, self)
        d = big.e - small.e
        if d > 128:
            return big
        return HDC(big.m + complex(math.ldexp(small.m.real, -d),
                                   math.ldexp(small.m.imag, -d)),
                   big.e).reduce()

    def __sub__(self, o: "HDC") -> "HDC":
        return self + HDC(-o.m, o.e)

    def cheb(self) -> HD:
        return HD(max(abs(self.m.real), abs(self.m.imag)), self.e).reduce()

    def norm_sqr(self) -> HD:
        return HD(abs(self.m) ** 2, 2 * self.e).reduce()

    def reciprocal(self) -> "HDC":
        return HDC(1.0 / self.m, -self.e).reduce()

    def to_complex(self) -> complex:
        if self.m == 0:
            return 0j
        if self.e > 1000:
            return complex(math.inf, math.inf)
        if self.e < -1000:
            return 0j
        return complex(math.ldexp(self.m.real, self.e),
                       math.ldexp(self.m.imag, self.e))

    def __repr__(self):
        return f"HDC({self.m}*2^{self.e})"
