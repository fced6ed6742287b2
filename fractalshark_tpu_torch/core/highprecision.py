"""Arbitrary-precision binary floating point on Python integers.

Host-side replacement for the reference's MPIR-backed ``HighPrecision``
(reference: ``HpSharkFloatLib/HighPrecision.h:33``).  The reference wraps
``mpf_t``; we instead represent a value exactly as

    value = mantissa * 2**exponent      (mantissa: int, exponent: int)

with per-instance precision (in bits) controlling rounding after every
operation.  Python's big integers give us exact decimal-string round trips
(the reference guarantees hex-exact round trips, ``HighPrecision.h:25-31``)
and unbounded exponents (zoom factors like 10**244240 are routine).

This module is deliberately free of jax/numpy: it is the *host* numeric
foundation used by view math (PointZoomBBConverter), reference-orbit
computation, and file formats.  The hot reference-orbit loop has a
dedicated fixed-point path (see engine/reforbit.py) and a native module.
"""

from __future__ import annotations

import math
import re
import sys

# Deep-zoom coordinates run to hundreds of thousands of decimal digits
# (view #32 is ~244k digits); lift CPython's int↔str conversion guard.
sys.set_int_max_str_digits(0)

_LOG10_2 = math.log10(2.0)

# Guard bits carried through divisions/parses before rounding.
_GUARD = 32

_DEC_RE = re.compile(
    r"^\s*([+-]?)(\d*)(?:\.(\d*))?(?:[eE]([+-]?\d+))?\s*$"
)


def _round_to_bits(mant: int, exp: int, prec: int) -> tuple[int, int]:
    """Round mant*2^exp to `prec` significant bits, round-half-to-even."""
    if mant == 0:
        return 0, 0
    neg = mant < 0
    m = -mant if neg else mant
    nbits = m.bit_length()
    drop = nbits - prec
    if drop <= 0:
        return mant, exp
    half = 1 << (drop - 1)
    rem = m & ((1 << drop) - 1)
    m >>= drop
    if rem > half or (rem == half and (m & 1)):
        m += 1
        if m.bit_length() > prec:  # carry rippled: 0b111.. + 1
            m >>= 1
            exp += 1
    exp += drop
    return (-m if neg else m), exp


class HighPrecision:
    """Immutable arbitrary-precision binary float.

    API parity targets (reference ``HighPrecision.h``): construction from
    decimal strings / ints / floats, arithmetic operators, comparisons,
    ``precision_in_bits``, exact string round-trip, ``mantissa_exp2``
    (the HDRFloat conversion hook).
    """

    __slots__ = ("mant", "exp", "prec")

    DEFAULT_PREC = 256
    MAX_PREC = 1 << 26  # 64M bits, matching reference HighPrecision.h:48

    def __init__(self, value=0, prec: int | None = None):
        if prec is None:
            prec = HighPrecision.DEFAULT_PREC
        prec = min(int(prec), HighPrecision.MAX_PREC)
        self.prec = prec
        if isinstance(value, HighPrecision):
            self.mant, self.exp = _round_to_bits(value.mant, value.exp, prec)
        elif isinstance(value, int):
            self.mant, self.exp = _round_to_bits(value, 0, prec)
        elif isinstance(value, float):
            if value == 0.0:
                self.mant, self.exp = 0, 0
            else:
                if math.isinf(value) or math.isnan(value):
                    raise ValueError(f"non-finite float: {value}")
                m, e = math.frexp(value)  # m in [0.5,1)
                mi = int(m * (1 << 53))
                self.mant, self.exp = _round_to_bits(mi, e - 53, prec)
        elif isinstance(value, str):
            self.mant, self.exp = HighPrecision._parse(value, prec)
        elif isinstance(value, tuple) and len(value) == 2:
            self.mant, self.exp = _round_to_bits(value[0], value[1], prec)
        else:
            raise TypeError(f"cannot construct HighPrecision from {type(value)}")

    # ---------------------------------------------------------------- parse

    @staticmethod
    def _parse(s: str, prec: int) -> tuple[int, int]:
        m = _DEC_RE.match(s)
        if not m or (not m.group(2) and not m.group(3)):
            raise ValueError(f"bad decimal literal: {s!r}")
        sign = -1 if m.group(1) == "-" else 1
        ipart = m.group(2) or "0"
        fpart = m.group(3) or ""
        e10 = int(m.group(4) or 0) - len(fpart)
        digits = int(ipart + fpart) if (ipart + fpart) else 0
        if digits == 0:
            return 0, 0
        digits *= sign
        # value = digits * 10^e10 = digits * 5^e10 * 2^e10
        if e10 >= 0:
            mant = digits * (5 ** e10)
            return _round_to_bits(mant, e10, prec)
        d = 5 ** (-e10)
        shift = max(0, prec + _GUARD + d.bit_length() - digits.bit_length())
        mant = (digits << shift) // d
        return _round_to_bits(mant, e10 - shift, prec)

    # ------------------------------------------------------------ factories

    @classmethod
    def from_mant_exp(cls, mant: int, exp: int, prec: int | None = None):
        return cls((mant, exp), prec=prec)

    @classmethod
    def zero(cls, prec: int | None = None):
        return cls(0, prec=prec)

    # ------------------------------------------------------------ accessors

    def precision_in_bits(self) -> int:
        return self.prec

    def with_precision(self, prec: int) -> "HighPrecision":
        return HighPrecision(self, prec=prec)

    def is_zero(self) -> bool:
        return self.mant == 0

    def sign(self) -> int:
        return 0 if self.mant == 0 else (1 if self.mant > 0 else -1)

    def mantissa_exp2(self) -> tuple[float, int]:
        """Return (m, e) with value == m * 2**e and m in [0.5, 1).

        This is the HDRFloat conversion hook (reference converts mpf →
        HDRFloat via mantissa/exponent split, ``HpSharkFloat.h:297-307``).
        """
        if self.mant == 0:
            return 0.0, 0
        nbits = abs(self.mant).bit_length()
        top = 64
        if nbits > top:
            m_red = self.mant >> (nbits - top)
        else:
            m_red = self.mant << (top - nbits)
        return m_red / (1 << top), self.exp + nbits

    def exponent2(self) -> int:
        """Base-2 exponent: value magnitude is in [2^(e-1), 2^e)."""
        if self.mant == 0:
            return 0
        return self.exp + abs(self.mant).bit_length()

    def __float__(self) -> float:
        m, e = self.mantissa_exp2()
        if e > 1024:
            return math.inf if m > 0 else -math.inf
        if e < -1074:
            return 0.0
        return math.ldexp(m, e)

    def __int__(self) -> int:
        if self.exp >= 0:
            return self.mant << self.exp
        return self.mant >> (-self.exp) if self.mant >= 0 else -((-self.mant) >> (-self.exp))

    # ----------------------------------------------------------- arithmetic

    @staticmethod
    def _res_prec(a: "HighPrecision", b: "HighPrecision") -> int:
        return max(a.prec, b.prec)

    def _coerce(self, other):
        if isinstance(other, HighPrecision):
            return other
        if isinstance(other, (int, float, str)):
            return HighPrecision(other, prec=self.prec)
        return NotImplemented

    def __add__(self, other):
        o = self._coerce(other)
        if o is NotImplemented:
            return o
        prec = HighPrecision._res_prec(self, o)
        if self.mant == 0:
            return HighPrecision(o, prec=prec)
        if o.mant == 0:
            return HighPrecision(self, prec=prec)
        a, b = self, o
        if a.exponent2() < b.exponent2():
            a, b = b, a
        # If the smaller operand's magnitude is entirely below the rounding
        # boundary of the larger, it cannot affect the result (cf. the
        # EXPONENT_DIFF_IGNORED fast path, reference HDRFloat.h:122) — but
        # exact: only skip when provably beyond prec+guard bits.
        if a.exponent2() - b.exponent2() > prec + _GUARD + 2:
            return HighPrecision(a, prec=prec)
        if a.exp >= b.exp:
            mant = (a.mant << (a.exp - b.exp)) + b.mant
            return HighPrecision.from_mant_exp(mant, b.exp, prec)
        mant = a.mant + (b.mant << (b.exp - a.exp))
        return HighPrecision.from_mant_exp(mant, a.exp, prec)

    def __radd__(self, other):
        return self.__add__(other)

    def __sub__(self, other):
        o = self._coerce(other)
        if o is NotImplemented:
            return o
        return self.__add__(HighPrecision.from_mant_exp(-o.mant, o.exp, o.prec))

    def __rsub__(self, other):
        o = self._coerce(other)
        return o.__sub__(self)

    def __neg__(self):
        return HighPrecision.from_mant_exp(-self.mant, self.exp, self.prec)

    def __abs__(self):
        return HighPrecision.from_mant_exp(abs(self.mant), self.exp, self.prec)

    def __mul__(self, other):
        o = self._coerce(other)
        if o is NotImplemented:
            return o
        prec = HighPrecision._res_prec(self, o)
        return HighPrecision.from_mant_exp(
            self.mant * o.mant, self.exp + o.exp, prec
        )

    def __rmul__(self, other):
        return self.__mul__(other)

    def __truediv__(self, other):
        o = self._coerce(other)
        if o is NotImplemented:
            return o
        if o.mant == 0:
            raise ZeroDivisionError("HighPrecision division by zero")
        prec = HighPrecision._res_prec(self, o)
        if self.mant == 0:
            return HighPrecision.zero(prec)
        shift = max(
            0,
            prec + _GUARD + abs(o.mant).bit_length() - abs(self.mant).bit_length(),
        )
        num = self.mant << shift
        q, r = divmod(num, o.mant)
        # round-to-nearest on the true quotient
        if o.mant > 0:
            if 2 * r >= o.mant:
                q += 1
        else:
            if 2 * r <= o.mant:
                q += 1
        return HighPrecision.from_mant_exp(q, self.exp - o.exp - shift, prec)

    def __rtruediv__(self, other):
        o = self._coerce(other)
        return o.__truediv__(self)

    def __pow__(self, n: int):
        if not isinstance(n, int):
            return NotImplemented
        if n < 0:
            return HighPrecision(1, prec=self.prec) / (self ** (-n))
        result = HighPrecision(1, prec=self.prec)
        base = self
        while n:
            if n & 1:
                result = result * base
            base = base * base
            n >>= 1
        return result

    def sqrt(self) -> "HighPrecision":
        if self.mant < 0:
            raise ValueError("sqrt of negative HighPrecision")
        if self.mant == 0:
            return HighPrecision.zero(self.prec)
        target = 2 * (self.prec + _GUARD)
        nbits = self.mant.bit_length()
        shift = max(0, target - nbits)
        if (self.exp - shift) & 1:
            shift += 1
        m = self.mant << shift
        r = math.isqrt(m)
        return HighPrecision.from_mant_exp(r, (self.exp - shift) // 2, self.prec)

    def mul_pow2(self, k: int) -> "HighPrecision":
        return HighPrecision.from_mant_exp(self.mant, self.exp + k, self.prec)

    # ---------------------------------------------------------- comparisons

    def _cmp(self, other) -> int:
        o = self._coerce(other)
        sa, sb = self.sign(), o.sign()
        if sa != sb:
            return -1 if sa < sb else 1
        if sa == 0:
            return 0
        # same nonzero sign: compare magnitudes via exponent2 then subtract
        ea, eb = self.exponent2(), o.exponent2()
        if ea != eb:
            mag = -1 if ea < eb else 1
            return mag * sa
        d = self - o
        return d.sign()

    def __eq__(self, other):
        try:
            return self._cmp(other) == 0
        except TypeError:
            return NotImplemented

    def __lt__(self, other):
        return self._cmp(other) < 0

    def __le__(self, other):
        return self._cmp(other) <= 0

    def __gt__(self, other):
        return self._cmp(other) > 0

    def __ge__(self, other):
        return self._cmp(other) >= 0

    def __hash__(self):
        # normalize trailing zero bits for a canonical form
        m, e = self.mant, self.exp
        if m:
            tz = (m & -m).bit_length() - 1
            m >>= tz
            e += tz
        return hash((m, e))

    # -------------------------------------------------------------- strings

    def digits10(self) -> int:
        return max(8, int(self.prec * _LOG10_2) + 2)

    def to_string(self, digits: int | None = None) -> str:
        """Scientific-notation decimal string, exact to `digits` digits."""
        if digits is None:
            digits = self.digits10()
        if self.mant == 0:
            return "0"
        neg = self.mant < 0
        m = -self.mant if neg else self.mant
        e = self.exp
        # estimate decimal exponent d10: |v| in [10^d10, 10^(d10+1))
        bl = m.bit_length()
        d10 = math.floor((bl + e - 1) * _LOG10_2)
        for _ in range(4):
            # scaled = m * 2^e * 10^(digits-1-d10), want it to have
            # exactly `digits` decimal digits
            j = digits - 1 - d10
            e2 = e + j
            if j >= 0:
                num = m * (5 ** j)
                scaled = num << e2 if e2 >= 0 else _div_round(num, 1 << (-e2))
            else:
                d = 5 ** (-j)
                if e2 >= 0:
                    scaled = _div_round(m << e2, d)
                else:
                    scaled = _div_round(m, d << (-e2))
            s = str(scaled)
            if len(s) == digits:
                break
            d10 += len(s) - digits
        sign = "-" if neg else ""
        if len(s) > 1:
            body = f"{s[0]}.{s[1:]}"
        else:
            body = s
        body = body.rstrip("0").rstrip(".") if "." in body else body
        return f"{sign}{body}e{'+' if d10 >= 0 else '-'}{abs(d10):02d}"

    def __str__(self):
        return self.to_string()

    def __repr__(self):
        return f"HighPrecision({self.to_string(24)!r}, prec={self.prec})"


def _div_round(a: int, b: int) -> int:
    q, r = divmod(a, b)
    if 2 * r >= b:
        q += 1
    return q


def set_default_precision(bits: int) -> None:
    """Set the default construction precision (mirrors
    ``HighPrecision::defaultPrecisionInBits``)."""
    HighPrecision.DEFAULT_PREC = min(int(bits), HighPrecision.MAX_PREC)
