"""Fixed-point big numbers on 16-bit digits and one orbit step on them:
the port of ``fractalshark_tpu/ops/bignum/fixedpoint.py`` that the
device reference orbit and the feature finder's device Newton-Raphson
evaluator need, through kernels K4 (``csrc/ntt_orbit.cu``, the step's
products) and K5 (``csrc/orbit_tail.cu``, products to the next z), and
their NR instances K4-NR and K5-NR (``iterate_z_nr``: z and dz/dc), one
step at a time (a chunk of steps is K12, ``orbit.py``); and
the reference's generic multiplies (``multiply_3way``, ``multiply_iter``,
``multiply_nr``, ``multiply_nr_iter``) through the generic transforms of
``ntt.py`` (kernel K8), at the end of this module.  The reference's
flag-off routes of the step and of ``multiply_iter``/``multiply_nr_iter``
(``PALLAS_NTT``, ``PALLAS_NTT_SPLIT`` here, ``ntt_pallas.WHOLE_ALIGNED``,
``ntt_pallas.BATCHED_TAIL``, ``ntt_mxu.MXU_ITER_FULL``) go to kernels K9,
K10 and K11 (``ntt_pallas.py``, ``ntt_mxu.py``).

A value is sign-magnitude fixed point, as in the JAX package:

    value = sign · Σ d_i·2^(16·i) / 2^(16·F),   F = D − INT_DIGITS,

with ``D`` digits below 2^16 (int32 tensors here, read as uint32 by the
kernels; numpy uint32 at the host converters) and an int32 sign of ±1.

One step z ← z² + c (``iterate_z``) is exactly, with h = 2^(16F − 1),

    x' = rhu(x² − y² + cx·2^(16F)),   y' = rhu(2xy + cy·2^(16F)),
    rhu(v) = sign(v + h) · (|v + h| >> 16F),

the sign of a zero result being +1 unless v + h < 0.  K4 computes the
exact coefficient sequences of x² − y² and x·y (two-prime NTT
convolution, CRT); K5 adds ±c and the round bit, propagates the carries
over all 2D digits and finishes in sign-magnitude form, emitting the
next step's shadow row.  The plain twins below compute the same two
functions with torch int64 tensors (exact modular arithmetic, then a
carry scan); a wrapper takes its twin only for CPU tensors and launches
its kernel, or raises, for CUDA tensors.

One NR step (``iterate_z_nr``, ``fractalshark_tpu/ops/bignum/fixedpoint.py:743-827``)
updates z and dz/dc together, dz/dc from the pre-update z:

    x'  = rhu(x² − y² + cx·2^(16F)),   y'  = rhu(2·xy + cy·2^(16F)),
    dx' = rhu(2u + 2^(32F)),           dy' = rhu(2v),
    u = x·dx − y·dy,   v = x·dy + y·dx   (signed values),

the +1 of dz/dc sitting at digit 2F of the product stream.  K4-NR
computes the exact signed coefficients of x² − y², xy, u and v (the
signs folded in the frequency domain); K5-NR adds ±c, the +1 and the
round bit, resolves the carries and keeps digits F..F+D−1 of each
magnitude.  dz/dc lives in the orbit's format, with 2 integer digits,
so its magnitude wraps modulo 2^32 once |dz/dc| ≥ 2^32, exactly as in
the reference; the host evaluator (``engine/feature_finder.py``) does
not wrap.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from fractalshark_tpu_torch import kernels
from fractalshark_tpu_torch.core.highprecision import HighPrecision
from fractalshark_tpu_torch.ops.bignum import ntt as N

INT_DIGITS = 2          # 32 integer bits: |z²+c| < 256 plus headroom
DIGIT_BITS = 16
DIGIT_MASK = 0xFFFF

WINDOW = 4              # top digits in a shadow row (64 bits ≥ f64)
# shadow row: win_x[4], base_x, win_y[4], base_y, sx, sy
ROW = 12
# the NR state's sign row: sx, sy, sdx, sdy
NR_ROW = 4
# K5-NR's digit sums: |2u|, |2v| ≤ 4D·(2^16 − 1)^2 < 2^50 − 2^34 up to
# D = 2^16 (32,768 limbs, nfft 2^17, K4-NR's cap), and the carries are
# exact for any |acc| < 2^51 (``csrc/orbit_tail.cu``)
NR_MAX_DIGITS = 1 << 16


@dataclass(frozen=True)
class FixedSpec:
    """Shape/precision of one fixed-point format."""
    digits: int              # D: total 16-bit digits
    nfft: int                # transform size ≥ 2D

    @property
    def frac_digits(self) -> int:
        return self.digits - INT_DIGITS

    @property
    def frac_bits(self) -> int:
        return DIGIT_BITS * self.frac_digits

    @staticmethod
    def for_limbs(limbs32: int) -> "FixedSpec":
        d = 2 * limbs32
        nfft = 1 << (2 * d - 1).bit_length()
        return FixedSpec(digits=d, nfft=nfft)


# ----------------------------------------------------------- host converts


def hp_to_digits(x: HighPrecision, spec: FixedSpec) -> tuple[int, np.ndarray]:
    """(sign, digit array) of round(x · 2^frac_bits)."""
    sh = x.exp + spec.frac_bits
    mant = x.mant << sh if sh >= 0 else _round_shift(x.mant, -sh)
    sign = -1 if mant < 0 else 1
    mant = abs(mant)
    out = np.zeros(spec.digits, np.uint32)
    i = 0
    while mant and i < spec.digits:
        out[i] = mant & 0xFFFF
        mant >>= 16
        i += 1
    if mant:
        raise OverflowError("value exceeds fixed-point range")
    return sign, out


def _round_shift(m: int, s: int) -> int:
    if s == 0:
        return m
    half = 1 << (s - 1)
    return (m + half) >> s if m >= 0 else -((-m + half) >> s)


def digits_to_int(digits) -> int:
    v = 0
    for i, d in enumerate(np.asarray(digits).tolist()):
        v += int(d) << (16 * i)
    return v


def digits_to_float(sign: int, digits, spec: FixedSpec) -> float:
    v = digits_to_int(digits)
    if v == 0:
        return 0.0
    nb = v.bit_length()
    top = v >> max(0, nb - 56)
    return sign * math.ldexp(top, max(0, nb - 56) - spec.frac_bits)


def shadow_row_np(sx: int, x: np.ndarray, sy: int,
                  y: np.ndarray) -> np.ndarray:
    """The [12] int32 shadow row of a state (``orbit.py:72-80,145-148``):
    per component the WINDOW digits ending at the top nonzero digit and
    the window's base index (zero value: base 0), then the two signs."""
    row = np.zeros(ROW, np.int32)
    for c, d in enumerate((np.asarray(x), np.asarray(y))):
        nz = np.nonzero(d)[0]
        idx = int(nz[-1]) if nz.size else -1
        base = min(max(idx - (WINDOW - 1), 0), d.shape[0] - WINDOW)
        row[5 * c:5 * c + WINDOW] = d[base:base + WINDOW]
        row[5 * c + WINDOW] = base
    row[10], row[11] = sx, sy
    return row


# ------------------------------------------------------------ plain twins


_plans: dict = {}


def _plan(n: int, device) -> dict:
    """The twin's per-size constants on ``device``, cached: the primes,
    each stage's twiddles (DIF forward, DIT inverse, ``ntt.py:145-192``)
    and n^-1 per prime."""
    key = (n, str(device))
    if key not in _plans:
        fwd, inv = (torch.from_numpy(t).to(device)
                    for t in N.root_tables(n))
        stages = n.bit_length() - 1
        idx = torch.arange(n // 2, device=device)
        _plans[key] = {
            "p": torch.tensor([N.P1, N.P2], dtype=torch.int64,
                              device=device).view(2, 1, 1, 1),
            "dif": [fwd[:, idx[:n >> (s + 1)] << s].view(2, 1, 1, -1)
                    for s in range(stages)],
            "dit": [inv[:, idx[:1 << s] << (stages - 1 - s)]
                    .view(2, 1, 1, -1) for s in range(stages)],
            "ninv": torch.tensor([pow(n, -1, N.P1), pow(n, -1, N.P2)],
                                 dtype=torch.int64,
                                 device=device).view(2, 1, 1),
        }
    return _plans[key]


def _dif(a: torch.Tensor, plan: dict) -> torch.Tensor:
    """Radix-2 decimation-in-frequency NTT of [2 primes, B, n] int64:
    natural order in, bit-reversed order out (``ntt.py:145-169``)."""
    _, b, n = a.shape
    p = plan["p"]
    for s, tw in enumerate(plan["dif"]):
        y = a.view(2, b, 1 << s, 2, n >> (s + 1))
        u, v = y[..., 0, :], y[..., 1, :]
        a = torch.stack([(u + v) % p, (u - v) * tw % p], dim=-2)
        a = a.view(2, b, n)
    return a


def _dit(a: torch.Tensor, plan: dict) -> torch.Tensor:
    """Radix-2 decimation-in-time inverse NTT: bit-reversed order in,
    natural order out, unscaled (``ntt.py:172-192``)."""
    _, b, n = a.shape
    p = plan["p"]
    for s, tw in enumerate(plan["dit"]):
        y = a.view(2, b, n >> (s + 1), 2, 1 << s)
        u, v = y[..., 0, :], y[..., 1, :] * tw % p
        a = torch.stack([(u + v) % p, (u - v) % p], dim=-2)
        a = a.view(2, b, n)
    return a


def _crt_signed(r: torch.Tensor) -> torch.Tensor:
    """Residues [2 primes, K, n] → the signed int64 integers [K, n] they
    represent, read as negative above p1·p2/2."""
    r1, r2 = r[0], r[1]
    t = (r2 - r1) % N.P2 * pow(N.P1, -1, N.P2) % N.P2
    rec = r1 + N.P1 * t                                   # [0, p1·p2)
    return torch.where(rec > N.P1 * N.P2 // 2, rec - N.P1 * N.P2, rec)


def _forward(values, n: int) -> tuple[torch.Tensor, dict]:
    """Spectra [2 primes, len(values), n] of digit vectors and the plan."""
    plan = _plan(n, values[0].device)
    a = torch.zeros(2, len(values), n, dtype=torch.int64,
                    device=values[0].device)
    for k, v in enumerate(values):
        a[:, k, :v.shape[0]] = v
    return _dif(a, plan), plan


def _inverse(prod: torch.Tensor, plan: dict) -> torch.Tensor:
    """Signed integer coefficients [K, n] of spectra [2 primes, K, n]."""
    return _crt_signed(_dit(prod, plan) * plan["ninv"] %
                       plan["p"].view(2, 1, 1))


def orbit_products_plain(x: torch.Tensor, y: torch.Tensor,
                         n: int) -> torch.Tensor:
    """K4's function: int64 [2, n] = (coefficients of x² − y², of x·y)
    for digit vectors x, y, by an NTT modulo each prime and CRT."""
    f, plan = _forward((x, y), n)
    fx, fy = f[:, 0], f[:, 1]
    pp = plan["p"].view(2, 1)
    return _inverse(torch.stack([(fx * fx - fy * fy) % pp, fx * fy % pp],
                                dim=1), plan)


def nr_products_plain(x: torch.Tensor, y: torch.Tensor, dx: torch.Tensor,
                      dy: torch.Tensor, signs: torch.Tensor,
                      n: int) -> torch.Tensor:
    """K4-NR's function: int64 [4, n] = coefficients of x² − y², sx·sy·xy,
    u = sx·sdx·x·dx − sy·sdy·y·dy and v = sx·sdy·x·dy + sy·sdx·y·dx for
    magnitudes x, y, dx, dy and ``signs`` = int32 [4] (sx, sy, sdx, sdy)
    on their device.  A sign multiplies its product's spectrum by ±1 mod
    p, as the reference negates spectra (``fixedpoint.py:777-780``)."""
    f, plan = _forward((x, y, dx, dy), n)
    fx, fy, fdx, fdy = f[:, 0], f[:, 1], f[:, 2], f[:, 3]
    pp = plan["p"].view(2, 1)
    s = signs.to(torch.int64)

    def signed(sgn, a, b):
        prod = a * b % pp
        return torch.where(sgn > 0, prod, (pp - prod) % pp)

    u = signed(s[0] * s[2], fx, fdx) - signed(s[1] * s[3], fy, fdy)
    v = signed(s[0] * s[3], fx, fdy) + signed(s[1] * s[2], fy, fdx)
    return _inverse(torch.stack([(fx * fx - fy * fy) % pp,
                                 signed(s[0] * s[1], fx, fy),
                                 u % pp, v % pp], dim=1), plan)


def _carry_resolve(acc: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact base-2^16 normalization of signed digit sums [K, L] (each
    |sum| < 2^50): (digits in [0, 2^16), top) with
    Σ sum_j 2^(16j) = Σ digit_j 2^(16j) + top · 2^(16L).

    Four split-and-shift rounds leave every position in [−1, 2^16]; the
    remaining carries are each in {−1, 0, 1}, so position j maps its
    carry-in c to its carry-out f_j(c) = ⌊(acc_j + c) / 2^16⌋ within
    {−1, 0, 1}.  A Hillis-Steele scan composes those maps, giving every
    carry-in at once (no ripple along runs of 0xFFFF or 0 digits)."""
    top = torch.zeros(acc.shape[0], dtype=torch.int64, device=acc.device)
    for _ in range(4):
        hi = acc >> DIGIT_BITS
        top = top + hi[:, -1]
        acc = acc & DIGIT_MASK
        acc[:, 1:] += hi[:, :-1]
    cs = torch.tensor([-1, 0, 1], dtype=torch.int64, device=acc.device)
    g = ((acc.unsqueeze(-1) + cs) >> DIGIT_BITS) + 1   # maps as indices
    length = acc.shape[1]
    k = 1
    while k < length:
        g = torch.cat([g[:, :k], torch.gather(g[:, k:], 2, g[:, :-k])], 1)
        k <<= 1
    cin = torch.cat([torch.zeros_like(acc[:, :1]), g[:, :-1, 1] - 1], 1)
    return (acc + cin) & DIGIT_MASK, top + g[:, -1, 1] - 1


def _negate(d: torch.Tensor) -> torch.Tensor:
    """Two's complement of [K, L] digit rows modulo 2^(16L)."""
    L = d.shape[1]
    pos = torch.arange(L, device=d.device)
    j0 = torch.where(d != 0, pos, L).min(dim=1, keepdim=True).values
    return torch.where(pos < j0, 0,
                       torch.where(pos == j0, (1 << 16) - d, DIGIT_MASK - d))


def shadow_rows(mags: torch.Tensor, signs: torch.Tensor) -> torch.Tensor:
    """shadow_row_np for [2, D] digit rows and [2] signs, on their device."""
    D = mags.shape[1]
    pos = torch.arange(D, device=mags.device)
    idx = torch.where(mags != 0, pos, -1).max(dim=1).values
    base = (idx - (WINDOW - 1)).clamp(0, D - WINDOW)
    win = torch.gather(mags, 1, base.unsqueeze(1)
                       + torch.arange(WINDOW, device=mags.device))
    rows = torch.cat([win, base.unsqueeze(1)], 1).to(torch.int32)
    return torch.cat([rows.reshape(-1), signs.to(torch.int32)])


def _sign_magnitude(acc: torch.Tensor, spec: FixedSpec):
    """Digit sums [K, L] (round bit included) → (magnitudes int32 [K, D]
    = digits F..F+D−1 of |Σ acc_j 2^(16j)|, signs int32 [K], −1 iff the
    sum is negative)."""
    F, D = spec.frac_digits, spec.digits
    dig, top = _carry_resolve(acc)
    neg = top < 0
    mag = torch.where(neg.unsqueeze(1), _negate(dig), dig)[:, F:F + D]
    return mag.to(torch.int32), torch.where(neg, -1, 1).to(torch.int32)


def orbit_tail_plain(coef: torch.Tensor, row_in: torch.Tensor, scx: int,
                     cx: torch.Tensor, scy: int, cy: torch.Tensor,
                     spec: FixedSpec):
    """K5's function: (x' digits, y' digits, row of z') from K4's
    coefficients, the pre-update signs in ``row_in[10:12]`` and c."""
    D, F = spec.digits, spec.frac_digits
    sxy = (row_in[10] * row_in[11]).to(torch.int64)
    acc = torch.stack([coef[0], 2 * sxy * coef[1]])
    acc[0, F:F + D] += scx * cx.to(torch.int64)
    acc[1, F:F + D] += scy * cy.to(torch.int64)
    acc[:, F - 1] += 1 << (DIGIT_BITS - 1)
    mag, signs = _sign_magnitude(acc, spec)
    return mag[0], mag[1], shadow_rows(mag, signs)


def nr_tail_plain(coef: torch.Tensor, scx: int, cx: torch.Tensor, scy: int,
                  cy: torch.Tensor, spec: FixedSpec):
    """K5-NR's function: (x', y', dx', dy' digits, signs int32 [4]) from
    K4-NR's coefficients and c: x² − y² + cx, 2·xy + cy, 2u + 1 (at digit
    2F) and 2v, each with the round bit at digit F − 1
    (``fixedpoint.py:812-827``)."""
    D, F = spec.digits, spec.frac_digits
    acc = coef * torch.tensor([1, 2, 2, 2], dtype=torch.int64,
                              device=coef.device).view(4, 1)
    acc[0, F:F + D] += scx * cx.to(torch.int64)
    acc[1, F:F + D] += scy * cy.to(torch.int64)
    acc[2, 2 * F] += 1
    acc[:, F - 1] += 1 << (DIGIT_BITS - 1)
    mag, signs = _sign_magnitude(acc, spec)
    return mag[0], mag[1], mag[2], mag[3], signs


# --------------------------------------------------------------- wrappers


_tables: dict = {}


def device_tables(n: int, device) -> torch.Tensor:
    """K4's root tables (``ntt.kernel_tables``) on ``device``, cached."""
    key = (n, str(device))
    if key not in _tables:
        _tables[key] = torch.from_numpy(
            N.kernel_tables(n).view(np.int32)).to(device)
    return _tables[key]


_k9: dict = {}


def k9_tables(n: int, device) -> torch.Tensor:
    """K9's and K11's tables (``ntt.k9_tables``) on ``device``, cached:
    made once per (n, device), not on every call."""
    key = (n, str(device))
    if key not in _k9:
        _k9[key] = torch.from_numpy(N.k9_tables(n)).to(device)
    return _k9[key]


def _check_state(spec: FixedSpec, *digits: torch.Tensor) -> None:
    if spec.nfft < 2 * spec.digits or spec.nfft & (spec.nfft - 1):
        raise ValueError(f"{spec}: nfft must be a power of two ≥ 2D")
    for t in digits:
        if t.shape != (spec.digits,) or t.dtype != torch.int32 or \
                not t.is_contiguous():
            raise ValueError(f"digit vectors must be contiguous int32 "
                             f"[{spec.digits}], got {t.dtype}"
                             f"{tuple(t.shape)}")
        if t.device != digits[0].device:
            raise ValueError("digit vectors on different devices")
    if digits[0].device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {digits[0].device}")


def orbit_products(x: torch.Tensor, y: torch.Tensor,
                   spec: FixedSpec) -> torch.Tensor:
    """int64 [2, nfft]: coefficients of x² − y² and x·y (K4 on CUDA)."""
    _check_state(spec, x, y)
    if x.device.type == "cpu":
        return orbit_products_plain(x, y, spec.nfft)
    n = spec.nfft
    coef = torch.empty(2, n, dtype=torch.int64, device=x.device)
    work = torch.empty(4 * n, dtype=torch.int32, device=x.device)
    rc = kernels.lib().fs_ntt_orbit(
        x.data_ptr(), y.data_ptr(), coef.data_ptr(), work.data_ptr(),
        device_tables(n, x.device).data_ptr(), spec.digits,
        n.bit_length() - 1, kernels.stream(x.device))
    kernels.check(rc, "ntt_orbit")
    kernels.launches["ntt_orbit"] += 1
    return coef


def orbit_tail(coef: torch.Tensor, row_in: torch.Tensor, scx: int,
               cx: torch.Tensor, scy: int, cy: torch.Tensor,
               spec: FixedSpec):
    """(x', y', row of z') from K4's coefficients (K5 on CUDA)."""
    _check_state(spec, cx, cy)
    if coef.shape != (2, spec.nfft) or coef.dtype != torch.int64 or \
            row_in.shape != (ROW,) or row_in.dtype != torch.int32:
        raise ValueError("orbit_tail: coef must be int64 [2, nfft] and "
                         "row_in int32 [12]")
    if coef.device.type == "cpu":
        return orbit_tail_plain(coef, row_in, scx, cx, scy, cy, spec)
    D = spec.digits
    nx = torch.empty(D, dtype=torch.int32, device=coef.device)
    ny = torch.empty_like(nx)
    row = torch.empty(ROW, dtype=torch.int32, device=coef.device)
    scratch = torch.empty(4 * spec.nfft, dtype=torch.int32,
                          device=coef.device)
    rc = kernels.lib().fs_orbit_tail(
        coef.contiguous().data_ptr(), row_in.contiguous().data_ptr(),
        row.data_ptr(), cx.data_ptr(), cy.data_ptr(), int(scx), int(scy),
        nx.data_ptr(), ny.data_ptr(), scratch.data_ptr(), D,
        spec.nfft.bit_length() - 1, kernels.stream(coef.device))
    kernels.check(rc, "orbit_tail")
    kernels.launches["orbit_tail"] += 1
    return nx, ny, row


# ------------------------------------------------------------- the routes
# The reference's flag-off product routes (``fixedpoint.py:339-379``):
# ``PALLAS_NTT`` sends the step's products to K9 (B-f1's function) for
# ntt_pallas.supported sizes, ``PALLAS_NTT_SPLIT`` for supported_split
# sizes (B-f2, or B-f3 under ``ntt_pallas.WHOLE_ALIGNED``), each followed
# by K10's tail; ``ntt_mxu.MXU_ITER_FULL`` runs the whole step as K11.
# The precedence is the reference's (``:668-690``, ``:757-770``):
# ``ntt_mxu.MXU_ITER`` takes the step first at its sizes (K4 in the port),
# so K9 is reached there only with it off.  With every flag at its
# default the step is K4 then K5 at every size, which a chunk of steps
# runs as K12 (``orbit.orbit_chunk``).  (The reference's
# ``PALLAS_FUSED_TAIL`` has no counterpart: on the card the tail is
# always fused, by K5 or K10.)
PALLAS_NTT: bool = False
PALLAS_NTT_SPLIT: bool = False


def _use_pallas(nf: int) -> bool:
    from fractalshark_tpu_torch.ops.bignum import ntt_pallas as NP
    return PALLAS_NTT and NP.supported(nf)


def _use_pallas_split(nf: int) -> bool:
    from fractalshark_tpu_torch.ops.bignum import ntt_pallas as NP
    return PALLAS_NTT_SPLIT and NP.supported_split(nf)


def _any_pallas(nf: int) -> bool:
    return _use_pallas(nf) or _use_pallas_split(nf)


def _use_mxu_iter(nf: int) -> bool:
    from fractalshark_tpu_torch.ops.bignum import ntt_mxu as NM
    return NM.use_iter_kernel(nf)


def _use_fused_tail(nf: int, D: int) -> bool:
    """The layout B-f5's tail needs (``fixedpoint.py:391-397``)."""
    return 2 * D == nf and nf % 128 == 0 and nf >= 2048


def step_route(spec: FixedSpec) -> str:
    """The orbit step's route: "k4" (K4 then K5), "products" (K9 then
    K10) or "full" (K11)."""
    from fractalshark_tpu_torch.ops.bignum import ntt_mxu as NM
    nf = spec.nfft
    if NM.MXU_ITER_FULL and _use_mxu_iter(nf) and \
            _use_fused_tail(nf, spec.digits):
        return "full"
    if _use_mxu_iter(nf) or not _any_pallas(nf):
        return "k4"
    return "products"


def nr_route(spec: FixedSpec) -> str:
    """The NR step's route: "k4" (K4-NR then K5-NR) or "products" (K9
    then K10)."""
    nf = spec.nfft
    return "k4" if _use_mxu_iter(nf) or not _any_pallas(nf) else "products"


def addend_planes(cx: torch.Tensor, cy: torch.Tensor, spec: FixedSpec,
                  nr: bool = False):
    """The tail's addend planes over L = 2D digits (``fixedpoint.py:
    700-706, 800-806``): int32 [K, L] (c at digit F; for NR also the +1
    of dz/dc at digit 2F) and the round plane int32 [L] (2^15 at F − 1)."""
    D, F = spec.digits, spec.frac_digits
    cadd = torch.zeros(4 if nr else 2, 2 * D, dtype=torch.int32,
                       device=cx.device)
    cadd[0, F:F + D] = cx
    cadd[1, F:F + D] = cy
    if nr:
        cadd[2, 2 * F] = 1
    rnd = torch.zeros(2 * D, dtype=torch.int32, device=cx.device)
    rnd[F - 1] = 1 << (DIGIT_BITS - 1)
    return cadd, rnd


def iterate_z_row(x: torch.Tensor, y: torch.Tensor, row_in: torch.Tensor,
                  scx: int, cx: torch.Tensor, scy: int, cy: torch.Tensor,
                  spec: FixedSpec, planes=None):
    """(x', y', row of z') of one step from the digits and the [12] row
    of z (its signs at 10 and 11), on the step's route."""
    route = step_route(spec)
    if route == "k4":
        return orbit_tail(orbit_products(x, y, spec), row_in, scx, cx, scy,
                          cy, spec)
    from fractalshark_tpu_torch.ops.bignum import ntt_mxu as NM
    from fractalshark_tpu_torch.ops.bignum import ntt_pallas as NP
    _check_state(spec, x, y, cx, cy)
    F, D, nf = spec.frac_digits, spec.digits, spec.nfft
    cadd, rnd = planes if planes is not None else addend_planes(cx, cy, spec)
    cfg = NP.tail_cfg((scx, scy, 1, 0), nr=False)
    zsign = row_in[10:12]
    if route == "full":
        dig, sgn, shw = NM.mxu_iterate_full(x, y, cadd, rnd, cfg, nf,
                                            (F, D), zsign=zsign)
    else:
        inv = NP.products(torch.stack([x, y]), None, nf, NP.PLAN_ITER)
        dig, sgn, shw = NP.tail(inv, cadd, rnd, cfg, (F, D), zsign=zsign)
    row = torch.cat([shw.reshape(-1), sgn])
    return (dig[0, F:F + D].contiguous(), dig[1, F:F + D].contiguous(),
            row)


def iterate_z(sx, x: torch.Tensor, sy, y: torch.Tensor, scx: int,
              cx: torch.Tensor, scy: int, cy: torch.Tensor,
              spec: FixedSpec):
    """ONE z ← z² + c update on sign-magnitude digits: K4 then K5 on CUDA
    tensors (or K9 then K10, or K11, under the flags above), their plain
    twins on CPU tensors.  Signs are ints or int32 0-d tensors; returns
    (nsx, nx, nsy, ny) with 0-d int32 signs."""
    row_in = torch.zeros(ROW, dtype=torch.int32, device=x.device)
    row_in[10] = torch.as_tensor(sx)
    row_in[11] = torch.as_tensor(sy)
    nx, ny, row = iterate_z_row(x, y, row_in, scx, cx, scy, cy, spec)
    return row[10], nx, row[11], ny


def check_nr(spec: FixedSpec) -> None:
    if not 16 <= spec.digits <= NR_MAX_DIGITS:
        raise ValueError(f"{spec}: the NR step needs 16 ≤ D ≤ 2^16 digits "
                         f"(8 to 32,768 limbs; past them nfft > 2^17, "
                         f"K4-NR's cap)")


def _check_signs(signs: torch.Tensor, like: torch.Tensor) -> None:
    if signs.shape != (NR_ROW,) or signs.dtype != torch.int32 or \
            signs.device != like.device or not signs.is_contiguous():
        raise ValueError("signs must be a contiguous int32 [4] on the "
                         "digits' device")


def nr_products(x: torch.Tensor, y: torch.Tensor, dx: torch.Tensor,
                dy: torch.Tensor, signs: torch.Tensor,
                spec: FixedSpec) -> torch.Tensor:
    """int64 [4, nfft]: coefficients of x² − y², sx·sy·xy, u and v
    (K4-NR on CUDA)."""
    _check_state(spec, x, y, dx, dy)
    check_nr(spec)
    _check_signs(signs, x)
    if x.device.type == "cpu":
        return nr_products_plain(x, y, dx, dy, signs, spec.nfft)
    n = spec.nfft
    coef = torch.empty(4, n, dtype=torch.int64, device=x.device)
    work = torch.empty(8 * n, dtype=torch.int32, device=x.device)
    rc = kernels.lib().fs_ntt_nr(
        x.data_ptr(), y.data_ptr(), dx.data_ptr(), dy.data_ptr(),
        signs.data_ptr(), coef.data_ptr(), work.data_ptr(),
        device_tables(n, x.device).data_ptr(), spec.digits,
        n.bit_length() - 1, kernels.stream(x.device))
    kernels.check(rc, "ntt_nr")
    kernels.launches["ntt_nr"] += 1
    return coef


def nr_tail(coef: torch.Tensor, scx: int, cx: torch.Tensor, scy: int,
            cy: torch.Tensor, spec: FixedSpec):
    """(x', y', dx', dy', signs int32 [4]) from K4-NR's coefficients
    (K5-NR on CUDA)."""
    _check_state(spec, cx, cy)
    check_nr(spec)
    if coef.shape != (4, spec.nfft) or coef.dtype != torch.int64 or \
            coef.device != cx.device:
        raise ValueError("nr_tail: coef must be int64 [4, nfft] on c's "
                         "device")
    if coef.device.type == "cpu":
        return nr_tail_plain(coef, scx, cx, scy, cy, spec)
    D, n = spec.digits, spec.nfft
    out = torch.empty(4, D, dtype=torch.int32, device=coef.device)
    signs = torch.empty(NR_ROW, dtype=torch.int32, device=coef.device)
    scratch = torch.empty(8 * n, dtype=torch.int32, device=coef.device)
    rc = kernels.lib().fs_nr_tail(
        coef.contiguous().data_ptr(), signs.data_ptr(), cx.data_ptr(),
        cy.data_ptr(), int(scx), int(scy), out[0].data_ptr(),
        out[1].data_ptr(), out[2].data_ptr(), out[3].data_ptr(),
        scratch.data_ptr(), D, n.bit_length() - 1,
        kernels.stream(coef.device))
    kernels.check(rc, "nr_tail")
    kernels.launches["nr_tail"] += 1
    return out[0], out[1], out[2], out[3], signs


def sign_row(sx, sy, sdx, sdy, device) -> torch.Tensor:
    """The int32 [4] sign row of an NR state; each sign an int or an
    int32 0-d tensor."""
    return torch.stack([torch.as_tensor(s, dtype=torch.int32, device=device)
                        for s in (sx, sy, sdx, sdy)])


def iterate_z_nr(sx, x, sy, y, sdx, dx, sdy, dy, scx: int, cx, scy: int,
                 cy, spec: FixedSpec):
    """ONE fused NR update, z ← z² + c and dz/dc ← 2·z·dz/dc + 1 with
    dz/dc from the PRE-update z (MpirOrbitEval order): K4-NR then K5-NR
    on CUDA tensors, their plain twins on CPU tensors.  Returns (nsx,
    nx, nsy, ny, nsdx, ndx, nsdy, ndy) with 0-d int32 signs."""
    signs = sign_row(sx, sy, sdx, sdy, x.device)
    if nr_route(spec) == "k4":
        coef = nr_products(x, y, dx, dy, signs, spec)
        nx, ny, ndx, ndy, ns = nr_tail(coef, scx, cx, scy, cy, spec)
        return ns[0], nx, ns[1], ny, ns[2], ndx, ns[3], ndy
    from fractalshark_tpu_torch.ops.bignum import ntt_pallas as NP
    _check_state(spec, x, y, dx, dy, cx, cy)
    F, D = spec.frac_digits, spec.digits
    inv = NP.products(torch.stack([x, y, dx, dy]), signs, spec.nfft,
                      NP.PLAN_NR_ITER)
    cadd, rnd = addend_planes(cx, cy, spec, nr=True)
    dig, ns = NP.tail(inv, cadd, rnd, NP.tail_cfg((scx, scy, 0, 0), nr=True))
    m = dig[:, F:F + D]
    return ns[0], m[0], ns[1], m[1], ns[2], m[2], ns[3], m[3]


# ------------------------------------------------------ generic multiplies
# The reference's generic routes (``fixedpoint.py:299,510,830,896``; for
# multiply_iter its XLA branch ``:538-552``, whose outputs its TPU routes
# B8a and B-f1 equal): NTTs of the padded digit vectors modulo both primes
# (the four-step with K8 phases from nfft 8,192, the flat transform
# below), Montgomery pointwise products, the inverse scaled by n^-1·R, and
# the digit-domain tails (CRT, digit sums, carries, signed finish) in plain
# torch on the digits' device, as XLA runs them in the reference.
#
# Exactness, the reference's limits: nfft is a power of two >= 2D, so no
# coefficient wraps (FixedSpec.for_limbs), and at most 2^24 (K8's phases,
# m <= 4,096; the flat route below 8,192); every coefficient is below
# p1·p2/2 ~ 2^60.7 in magnitude (D·2^32 for a product, 2D·2^32 for u and
# v), so the CRT is exact.  A product of 2D digits keeps digits
# F..F+D−1 after the round bit at F − 1 (round half up), i.e. it is
# ((v + 2^(16F−1)) >> 16F) mod 2^(16D); a signed result splits its
# coefficients into a positive and a negative digit stream, each held
# modulo 2^(32D) before the signed subtract, and its sign is −1 iff the
# positive stream is below the negative one, +1 for a zero magnitude.
# In-range operands (|value| < 4) never wrap a stream; full-width random
# digits can, and then the port wraps as the reference does.


def digit_rows(values, device) -> torch.Tensor:
    """int32 [K, D] digit rows from numpy arrays or tensors."""
    return torch.stack([torch.as_tensor(np.asarray(v, np.int64)
                                        if isinstance(v, np.ndarray) else v)
                        .to(device=device, dtype=torch.int32)
                        for v in values])


def _forward_rows(rows: torch.Tensor, nf: int) -> torch.Tensor:
    """Spectra of digit rows [K, D], zero-padded to nf."""
    x = torch.zeros(rows.shape[0], nf, dtype=torch.int32, device=rows.device)
    x[:, :rows.shape[1]] = rows
    return (N.fourstep_forward(x, nf) if nf >= N.FOURSTEP_MIN
            else N.shoup_forward(x, nf))


def _inverse_rows(prod: torch.Tensor, nf: int) -> torch.Tensor:
    return (N.fourstep_inverse_scaled(prod, nf, extra_scale_r=True)
            if nf >= N.FOURSTEP_MIN
            else N.shoup_inverse_scaled(prod, nf, extra_scale_r=True))


def _crt_rec(r1: torch.Tensor, r2: torch.Tensor) -> torch.Tensor:
    """int64 rec = CRT(r1 mod p1, r2 mod p2) in [0, p1·p2)."""
    t = (r2.to(torch.int64) - r1) % N.P2 * pow(N.P1, -1, N.P2) % N.P2
    return r1.to(torch.int64) + N.P1 * t


def _parts_acc(rec: torch.Tensor, out_digits: int) -> torch.Tensor:
    """Each coefficient's four 16-bit parts added at digit positions
    k..k+3, cut to ``out_digits`` positions (int64 [..., L])."""
    L = out_digits
    acc = torch.zeros(rec.shape[:-1] + (L,), dtype=torch.int64,
                      device=rec.device)
    for k in range(4):
        acc[..., k:] += ((rec >> (16 * k)) & DIGIT_MASK)[..., :L - k]
    return acc


def carry_propagate(acc: torch.Tensor) -> torch.Tensor:
    """Canonical 16-bit digits of non-negative digit sums along the last
    axis, modulo 2^(16L) (int64)."""
    dig, _ = _carry_resolve(acc.reshape(-1, acc.shape[-1]))
    return dig.reshape(acc.shape)


def signed_add(sa, a: torch.Tensor, sb, b: torch.Tensor):
    """(sign, magnitude) of sa·A + sb·B for canonical digit rows
    [..., L] and signs ±1 (ints or tensors of the rows' leading shape);
    the sign of a zero magnitude is +1 (``fixedpoint.py:195-205``)."""
    L = a.shape[-1]
    lead = a.shape[:-1]
    a2, b2 = a.reshape(-1, L), b.reshape(-1, L)
    sa = torch.as_tensor(sa, device=a.device).expand(lead).reshape(-1)
    sb = torch.as_tensor(sb, device=a.device).expand(lead).reshape(-1)
    total, _ = _carry_resolve(a2 + b2)
    diff, top = _carry_resolve(a2 - b2)
    b_big = top < 0                     # A < B
    mag = torch.where((sa == sb)[:, None], total,
                      torch.where(b_big[:, None], _negate(diff), diff))
    sign = torch.where(sa == sb, sa, torch.where(b_big, sb, sa))
    sign = torch.where((mag == 0).all(dim=1), 1, sign)
    return sign.to(torch.int32).reshape(lead), mag.reshape(a.shape)


def _crt_to_digit_sums(r1, r2, out_digits: int, round_digit: int):
    """Canonical digits [..., out_digits] of non-negative convolution
    coefficients given mod p1 and p2, the half-ulp added at
    ``round_digit``."""
    acc = _parts_acc(_crt_rec(r1, r2), out_digits)
    if round_digit >= 0:
        acc[..., round_digit] += 1 << (DIGIT_BITS - 1)
    return carry_propagate(acc)


def _crt_to_digit_sums_signed(r1, r2, out_digits: int, round_digit: int):
    """(sign, digits) of signed coefficients (read as negative above
    p1·p2/2), the half-ulp added to the positive stream."""
    rec = _crt_rec(r1, r2)
    neg = rec > (N.P1 * N.P2) // 2
    acc_p = _parts_acc(torch.where(neg, 0, rec), out_digits)
    acc_n = _parts_acc(torch.where(neg, N.P1 * N.P2 - rec, 0), out_digits)
    if round_digit >= 0:
        acc_p[..., round_digit] += 1 << (DIGIT_BITS - 1)
    return signed_add(1, carry_propagate(acc_p), -1, carry_propagate(acc_n))


def _keep(digits: torch.Tensor, spec: FixedSpec) -> torch.Tensor:
    F = spec.frac_digits
    return digits[..., F:F + spec.digits].to(torch.int32)


def multiply_3way(ax, ay, spec: FixedSpec, device="cuda"):
    """(x², y², x·y) of magnitudes x, y, fixed-point scaled: int32 [D]
    each (``fixedpoint.py:896-941``)."""
    x, y = digit_rows((ax, ay), kernels.resolve_device(device))
    f = _forward_rows(torch.stack([x, x, y, y]), spec.nfft)
    prod = N.mont_mul_rows(f[[0, 1, 2, 3, 0, 1]], f[[0, 1, 2, 3, 2, 3]])
    inv = _inverse_rows(prod, spec.nfft)
    out = _keep(_crt_to_digit_sums(inv[0::2], inv[1::2], 2 * spec.digits,
                                   spec.frac_digits - 1), spec)
    return out[0], out[1], out[2]


def multiply_iter(ax, ay, spec: FixedSpec, device="cuda"):
    """((sign, x² − y²), x·y), the difference taken in the frequency
    domain (``fixedpoint.py:510-559``)."""
    x, y = digit_rows((ax, ay), kernels.resolve_device(device))
    if not _use_mxu_iter(spec.nfft) and _any_pallas(spec.nfft):
        from fractalshark_tpu_torch.ops.bignum import ntt_pallas as NP
        inv = NP.ntt_iter_products(x, y, spec.nfft)
    else:
        f = _forward_rows(torch.stack([x, x, y, y]), spec.nfft)
        sq = N.mont_mul_rows(f, f)
        prod = torch.cat([N.mod_sub_rows(sq[0:2], sq[2:4]),
                          N.mont_mul_rows(f[0:2], f[2:4])])
        inv = _inverse_rows(prod, spec.nfft)
    L, rd = 2 * spec.digits, spec.frac_digits - 1
    sd, dd = _crt_to_digit_sums_signed(inv[0], inv[1], L, rd)
    xy = _crt_to_digit_sums(inv[2], inv[3], L, rd)
    return (sd, _keep(dd, spec)), _keep(xy, spec)


def multiply_nr(ax, ay, adx, ady, spec: FixedSpec, device="cuda"):
    """x², y², x·y and the four cross products x·dx, x·dy, y·dx, y·dy,
    fixed-point scaled: seven int32 [D] (``fixedpoint.py:299-336``)."""
    x, y, dx, dy = digit_rows((ax, ay, adx, ady),
                               kernels.resolve_device(device))
    f = _forward_rows(torch.stack([x, x, y, y, dx, dx, dy, dy]), spec.nfft)
    pairs = ((0, 0), (1, 1), (0, 1), (0, 2), (0, 3), (1, 2), (1, 3))
    a = [2 * i + pr for i, _ in pairs for pr in range(2)]
    b = [2 * j + pr for _, j in pairs for pr in range(2)]
    inv = _inverse_rows(N.mont_mul_rows(f[a], f[b]), spec.nfft)
    out = _keep(_crt_to_digit_sums(inv[0::2], inv[1::2], 2 * spec.digits,
                                   spec.frac_digits - 1), spec)
    return tuple(out)


def multiply_nr_iter(sx, ax, sy, ay, sdx, adx, sdy, ady, spec: FixedSpec,
                     device="cuda"):
    """((s, x² − y²), (s, x·y), (s, x·dx − y·dy), (s, x·dy + y·dx)) of
    signed values, the signs folded into the spectra
    (``fixedpoint.py:830-893``)."""
    dev = kernels.resolve_device(device)
    x, y, dx, dy = digit_rows((ax, ay, adx, ady), dev)
    if _any_pallas(spec.nfft):
        from fractalshark_tpu_torch.ops.bignum import ntt_pallas as NP
        inv = NP.ntt_nr_iter_products(x, y, dx, dy, sign_row(
            sx, sy, sdx, sdy, dev), spec.nfft)
    else:
        f = _forward_rows(torch.stack([x, x, y, y, dx, dx, dy, dy]),
                          spec.nfft)
        signs = torch.tensor([int(s) for s in (sx, sx, sy, sy, sdx, sdx,
                                               sdy, sdy)], device=dev)
        f = torch.where((signs < 0)[:, None],
                        N.mod_sub_rows(torch.zeros_like(f), f), f)
        fx, fy, fdx, fdy = f[0:2], f[2:4], f[4:6], f[6:8]
        mul = N.mont_mul_rows
        prod = torch.cat([N.mod_sub_rows(mul(fx, fx), mul(fy, fy)),
                          mul(fx, fy),
                          N.mod_sub_rows(mul(fx, fdx), mul(fy, fdy)),
                          N.mod_add_rows(mul(fx, fdy), mul(fy, fdx))])
        inv = _inverse_rows(prod, spec.nfft)
    sg, mag = _crt_to_digit_sums_signed(inv[0::2], inv[1::2],
                                        2 * spec.digits, spec.frac_digits - 1)
    mag = _keep(mag, spec)
    return tuple((sg[k], mag[k]) for k in range(4))
