"""Perturbed perturbation: reference-orbit REUSE across zooms.

Rebuild of the reference's ReuseModes 1–4
(``RefOrbitCalc.h:131-137``, reuse arrays
``PerturbationResults.h:358-361``, intermediate compressors
``PerturbationResults.h:397-493``): alongside a reference orbit, keep an
*intermediate-precision* copy of the high-precision z values
(AuthoritativeReuseExtraPrecisionInBits = 800 extra bits,
``HighPrecision.h:563``). A later orbit at a nearby center c' = c + dc
is then computed as a *delta orbit at intermediate precision*

    δ_{n+1} = 2·Z_n·δ_n + δ_n² + dc ;   z'_n = Z_n + δ_n

— thousands of bits instead of the full zoom precision, which is the
whole point at 10^100k-class zooms (SURVEY.md §5 long-context analogue
mechanism (3)).

Intermediate storage here: fixed-point Python ints at reuse precision,
optionally compressed with the same anchor+recompute scheme as the
low-precision orbit (SimpleIntermediateOrbitCompressor analogue).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from fractalshark_tpu_torch.core.highprecision import HighPrecision
from fractalshark_tpu_torch.core.precision import (
    AUTHORITATIVE_REUSE_EXTRA_PRECISION_BITS)
from fractalshark_tpu_torch.engine.perturbation_results import (
    PerturbationResults)
from fractalshark_tpu_torch.engine.reforbit import _fx_to_float


@dataclass
class ReuseOrbit:
    """Intermediate-precision orbit: fixed-point ints (frac_bits) of the
    z values, aligned with the low-precision orbit entries (index 0 is
    the zero seed)."""
    zx: list            # list[int], fixed point
    zy: list
    frac_bits: int
    center_x: HighPrecision
    center_y: HighPrecision

    def count(self) -> int:
        return len(self.zx)


def reuse_precision(radius: HighPrecision) -> int:
    """Intermediate precision: |exp2(radius)| + 800
    (PrecisionCalculator with RequiresReuse)."""
    e = abs(radius.exponent2()) if not radius.is_zero() else 0
    return e + AUTHORITATIVE_REUSE_EXTRA_PRECISION_BITS


def compute_reference_orbit_with_reuse(center_x: HighPrecision,
                                       center_y: HighPrecision,
                                       max_iterations: int,
                                       max_radius: HighPrecision,
                                       periodicity: bool = True,
                                       precision_bits: int | None = None
                                       ):
    """Full-precision orbit + intermediate-precision reuse copy,
    recorded DURING the single main run (the reference's SaveForReuse
    paths append each intermediate z inline, RefOrbitCalc.cpp:543-548 —
    no second pass): each reuse entry is the running fixed-point value
    truncated to reuse precision, a cheap shift."""
    from fractalshark_tpu_torch.engine.reforbit import compute_reference_orbit
    prec = precision_bits or max(center_x.prec, center_y.prec)
    rprec = min(reuse_precision(max_radius), prec)
    return compute_reference_orbit(
        center_x, center_y, max_iterations, max_radius,
        periodicity=periodicity, precision_bits=prec,
        reuse_frac_bits=rprec + 16)


def compute_reference_orbit_reused(reuse: ReuseOrbit,
                                   new_center_x: HighPrecision,
                                   new_center_y: HighPrecision,
                                   max_iterations: int,
                                   max_radius: HighPrecision,
                                   periodicity: bool = True
                                   ) -> PerturbationResults:
    """New orbit at c' = c + dc as a delta orbit at intermediate
    precision (the MT3 reuse paths, RefOrbitCalc.cpp:1540+)."""
    from fractalshark_tpu_torch.core.hdr_host import HD

    F = reuse.frac_bits
    half = 1 << (F - 1)

    def to_fx(hp):
        sh = hp.exp + F
        if sh >= 0:
            return hp.mant << sh
        h2 = 1 << (-sh - 1)
        return (hp.mant + h2) >> (-sh) if hp.mant >= 0 else \
            -((-hp.mant + h2) >> (-sh))

    def m(a, b):
        return (a * b + half) >> F

    dcx = to_fx(new_center_x - reuse.center_x)
    dcy = to_fx(new_center_y - reuse.center_y)
    # δ_1 = z'_1 − Z_1 = c' − c = dc  (orbit entry 1 is z_1 = c)
    dx_, dy_ = dcx, dcy

    radius = HD.from_hp(max_radius)
    dzdc_x = HD.from_float(1.0)
    dzdc_y = HD.zero()
    cxf = float(new_center_x)
    cyf = float(new_center_y)

    xs = [0.0]
    ys = [0.0]
    period = 0
    escaped_at = 0
    n_cached = reuse.count()
    budget = min(max_iterations, n_cached - 1)
    for i in range(1, budget + 1):
        zxi = reuse.zx[i] + dx_
        zyi = reuse.zy[i] + dy_
        lzx = _fx_to_float(zxi, F)
        lzy = _fx_to_float(zyi, F)
        xs.append(lzx)
        ys.append(lzy)
        if periodicity:
            azx = HD.from_float(abs(lzx))
            azy = HD.from_float(abs(lzy))
            n2 = azy if azx.lt(azy) else azx
            r0 = (dzdc_y.abs() if dzdc_x.abs().lt(dzdc_y.abs())
                  else dzdc_x.abs())
            n3 = (radius * r0).mul_pow2(1)
            if n2.lt(n3):
                period = len(xs)
                break
            ndx = (dzdc_x.mul_float(lzx) -
                   dzdc_y.mul_float(lzy)).mul_pow2(1) + HD.from_float(1.0)
            ndy = (dzdc_y.mul_float(lzx) +
                   dzdc_x.mul_float(lzy)).mul_pow2(1)
            dzdc_x, dzdc_y = ndx, ndy
        # δ' = 2 Z δ + δ² + dc (complex)
        zx_c = reuse.zx[i]
        zy_c = reuse.zy[i]
        tx = (m(zx_c, dx_) - m(zy_c, dy_)) * 2
        ty = (m(zx_c, dy_) + m(zy_c, dx_)) * 2
        d2x = m(dx_, dx_) - m(dy_, dy_)
        d2y = 2 * m(dx_, dy_)
        dx_, dy_ = tx + d2x + dcx, ty + d2y + dcy
        tx2 = lzx + cxf
        ty2 = lzy + cyf
        if tx2 * tx2 + ty2 * ty2 > 256.0:
            escaped_at = len(xs)
            break

    return PerturbationResults(
        center_x=new_center_x, center_y=new_center_y,
        orbit_x=np.asarray(xs, np.float64),
        orbit_y=np.asarray(ys, np.float64),
        max_radius=max_radius, period=period, escaped_at=escaped_at,
        max_iterations=max_iterations, precision_bits=F - 16,
        extra={"reused_from": (reuse.center_x, reuse.center_y)})


@dataclass
class CompressedReuseOrbit:
    """Anchor + recompute compression of the intermediate orbit
    (SimpleIntermediateOrbitCompressor, PerturbationResults.h:397-428):
    store z_i only when the intermediate-precision shadow recurrence
    drifts by more than 2^-error_exp relative."""
    anchors_zx: list
    anchors_zy: list
    anchor_index: np.ndarray
    total_count: int
    frac_bits: int
    center_x: HighPrecision
    center_y: HighPrecision
    error_exp: int

    @staticmethod
    def from_reuse(reuse: ReuseOrbit,
                   error_exp: int = 450) -> "CompressedReuseOrbit":
        F = reuse.frac_bits
        half = 1 << (F - 1)

        def to_fx(hp):
            sh = hp.exp + F
            return hp.mant << sh if sh >= 0 else hp.mant >> (-sh)

        cxi = to_fx(reuse.center_x)
        cyi = to_fx(reuse.center_y)
        ax, ay, ai = [], [], []
        zx = zy = 0
        have = False
        thr_shift = error_exp
        for i in range(reuse.count()):
            tx, ty = reuse.zx[i], reuse.zy[i]
            if have:
                ex = abs(zx - tx)
                ey = abs(zy - ty)
                mag = max(abs(tx), abs(ty), 1)
                store = max(ex, ey) << thr_shift >= mag
            else:
                store = True
            if store:
                ax.append(tx)
                ay.append(ty)
                ai.append(i)
                zx, zy = tx, ty
                have = True
            nx = ((zx * zx + half) >> F) - ((zy * zy + half) >> F) + cxi
            zy = (((zx * zy + half) >> F) << 1) + cyi
            zx = nx
        return CompressedReuseOrbit(
            anchors_zx=ax, anchors_zy=ay,
            anchor_index=np.asarray(ai, np.int64),
            total_count=reuse.count(), frac_bits=F,
            center_x=reuse.center_x, center_y=reuse.center_y,
            error_exp=error_exp)

    def compression_ratio(self) -> float:
        return self.total_count / max(1, len(self.anchors_zx))

    def decompress(self) -> ReuseOrbit:
        F = self.frac_bits
        half = 1 << (F - 1)

        def to_fx(hp):
            sh = hp.exp + F
            return hp.mant << sh if sh >= 0 else hp.mant >> (-sh)

        cxi = to_fx(self.center_x)
        cyi = to_fx(self.center_y)
        zxs = [0] * self.total_count
        zys = [0] * self.total_count
        m = len(self.anchors_zx)
        for k in range(m):
            start = int(self.anchor_index[k])
            end = int(self.anchor_index[k + 1]) if k + 1 < m \
                else self.total_count
            zx, zy = self.anchors_zx[k], self.anchors_zy[k]
            for i in range(start, end):
                zxs[i] = zx
                zys[i] = zy
                nx = ((zx * zx + half) >> F) - ((zy * zy + half) >> F) + cxi
                zy = (((zx * zy + half) >> F) << 1) + cyi
                zx = nx
        return ReuseOrbit(zx=zxs, zy=zys, frac_bits=F,
                          center_x=self.center_x, center_y=self.center_y)
