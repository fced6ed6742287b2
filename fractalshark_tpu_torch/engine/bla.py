"""BLA (bilinear approximation) tables — the legacy iteration-skipping
scheme kept for parity (``FractalSharkLib/BLAS.{h,cpp}``, ``BLA.h``;
the reference itself calls it legacy next to LAv2).

A BLA entry linearizes l orbit steps: dz_{m+l} ≈ A·dz_m + B·dc, valid
while |dz_m|² < r².  Construction (BLAS.cpp:27-92, vectorized here in
numpy with explicit (mantissa, exponent) arrays since |A| grows like
∏|2z| and overflows f64 at modest levels):

* single step at orbit index m: A = 2·Z_m, B = 1, r = |A|·2^-23
  (BLA_BITS = 23, BLAS.h:14)
* merge(x, y): A = yA·xA, B = yA·xB + yB,
  r = min(rx, max(0, (ry − |xB|·blaSize)/|xA|)), l = lx + ly,
  blaSize = view max radius (Fractal.cpp:2228)
* levels halve: level k entry i covers orbit indices starting at
  i·2^k + 1; levels below BLA_STARTING_LEVEL−1 = 2 are built but not
  stored (BLAS.h:15-21).

Lookup (BLAS.cpp:258-308): for reference index m with k = m−1 even,
the deepest stored level ≤ trailing_zeros(k) whose r² exceeds |dz|²
wins; each miss halves the level (ix <<= 1).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

BLA_BITS = 23
FIRST_LEVEL = 2  # BLA_STARTING_LEVEL - 1


def _renorm(m: np.ndarray, e: np.ndarray):
    """Normalize complex mantissa arrays so |m| ∈ [1,2) (or 0)."""
    mag = np.maximum(np.abs(m.real), np.abs(m.imag))
    nz = mag > 0
    ex = np.zeros_like(e)
    ex[nz] = np.frexp(mag[nz])[1] - 1
    m = np.where(nz, m * np.exp2(-ex.astype(np.float64)), 0.0)
    return m, e + ex


def _renorm_r(m: np.ndarray, e: np.ndarray):
    nz = m > 0
    ex = np.zeros_like(e)
    ex[nz] = np.frexp(m[nz])[1] - 1
    m = np.where(nz, m * np.exp2(-ex.astype(np.float64)), 0.0)
    return m, e + ex


@dataclass
class BLATable:
    """Flattened per-level arrays (levels ≥ FIRST_LEVEL).

    Per entry: A (complex m/e), B (complex m/e), r2 (m/e), l (int32).
    level_offset[k] = index of level (FIRST_LEVEL + k)'s first entry.
    """
    a_m: np.ndarray
    a_e: np.ndarray
    b_m: np.ndarray
    b_e: np.ndarray
    r2_m: np.ndarray
    r2_e: np.ndarray
    l: np.ndarray
    level_offset: np.ndarray     # int32 [num_levels]
    level_count: np.ndarray      # int32 [num_levels]
    num_levels: int              # stored levels (from FIRST_LEVEL up)
    m_total: int                 # orbit entry count the table was built for

    @staticmethod
    def build(orbit_x: np.ndarray, orbit_y: np.ndarray,
              max_radius_mant: float, max_radius_exp: int) -> "BLATable":
        m_total = len(orbit_x)
        n0 = m_total - 1
        if n0 < 1:
            raise ValueError("orbit too short for BLA")
        eps_e = -BLA_BITS
        # level 0: single steps at orbit indices 1..m_total-1
        z = orbit_x[1:] + 1j * orbit_y[1:]  # Z_m for m = 1..M-1
        a_m = 2.0 * z
        a_e = np.zeros(n0, np.int32)
        a_m, a_e = _renorm(a_m, a_e)
        b_m = np.ones(n0, np.complex128)
        b_e = np.zeros(n0, np.int32)
        # r = |A| * eps
        r_m = np.hypot(a_m.real, a_m.imag)
        r_e = a_e + eps_e
        r_m, r_e = _renorm_r(r_m, r_e)
        l = np.ones(n0, np.int32)

        levels = []

        def merge(x, y):
            """x, y: dict level arrays; returns merged (pairs of x,y)."""
            (xa_m, xa_e, xb_m, xb_e, xr_m, xr_e, xl) = x
            (ya_m, ya_e, yb_m, yb_e, yr_m, yr_e, yl) = y
            na_m, na_e = _renorm(ya_m * xa_m, ya_e + xa_e)
            # B = yA·xB + yB with exponent alignment
            p_m = ya_m * xb_m
            p_e = ya_e + xb_e
            # align p and yB to common exponent
            ce = np.maximum(p_e, yb_e)
            d1 = np.clip(ce - p_e, 0, 80).astype(np.float64)
            d2 = np.clip(ce - yb_e, 0, 80).astype(np.float64)
            nb_m = p_m * np.exp2(-d1) + yb_m * np.exp2(-d2)
            nb_e = ce
            nb_m, nb_e = _renorm(nb_m, nb_e)
            # r = min(rx, max(0, (ry - |xB|*blaSize) / |xA|))
            xa_abs = np.hypot(xa_m.real, xa_m.imag)
            xb_abs = np.hypot(xb_m.real, xb_m.imag)
            # t = ry - |xB|*blaSize  (align exponents)
            t_e = xb_e + max_radius_exp
            ce2 = np.maximum(yr_e, t_e)
            tm = (yr_m * np.exp2(np.clip(yr_e - ce2, -80, 0).astype(
                np.float64)) -
                xb_abs * max_radius_mant * np.exp2(
                    np.clip(t_e - ce2, -80, 0).astype(np.float64)))
            tm = np.maximum(tm, 0.0)
            # divide by |xA|
            q_m = np.where(xa_abs > 0, tm / xa_abs, 0.0)
            q_e = ce2 - xa_e
            q_m, q_e = _renorm_r(q_m, q_e)
            # r = min(rx, q): compare (m,e)
            rx_bigger = (xr_e > q_e) | ((xr_e == q_e) & (xr_m > q_m))
            nr_m = np.where(rx_bigger, q_m, xr_m)
            nr_e = np.where(rx_bigger, q_e, xr_e)
            return (na_m, na_e, nb_m, nb_e, nr_m, nr_e, xl + yl)

        cur = (a_m, a_e, b_m, b_e, r_m, r_e, l)
        level = 0
        while True:
            n = cur[0].shape[0]
            if level >= FIRST_LEVEL:
                levels.append(cur)
            if n <= 1:
                break
            half = n // 2
            x = tuple(v[0:2 * half:2] for v in cur)
            y = tuple(v[1:2 * half:2] for v in cur)
            merged = merge(x, y)
            if n % 2:
                merged = tuple(np.concatenate([mv, cv[-1:]])
                               for mv, cv in zip(merged, cur))
            cur = merged
            level += 1

        if not levels:
            levels = [cur]
        # store r2 = r^2
        offs = np.zeros(len(levels), np.int32)
        cnts = np.zeros(len(levels), np.int32)
        acc = 0
        packed = {k: [] for k in
                  ("a_m", "a_e", "b_m", "b_e", "r2_m", "r2_e", "l")}
        for i, lvl in enumerate(levels):
            (am, ae, bm, be, rm, re, ll) = lvl
            offs[i] = acc
            cnts[i] = am.shape[0]
            acc += am.shape[0]
            r2m, r2e = _renorm_r(rm * rm, 2 * re)
            packed["a_m"].append(am)
            packed["a_e"].append(ae)
            packed["b_m"].append(bm)
            packed["b_e"].append(be)
            packed["r2_m"].append(r2m)
            packed["r2_e"].append(r2e)
            packed["l"].append(ll)
        return BLATable(
            a_m=np.concatenate(packed["a_m"]),
            a_e=np.concatenate(packed["a_e"]).astype(np.int32),
            b_m=np.concatenate(packed["b_m"]),
            b_e=np.concatenate(packed["b_e"]).astype(np.int32),
            r2_m=np.concatenate(packed["r2_m"]),
            r2_e=np.concatenate(packed["r2_e"]).astype(np.int32),
            l=np.concatenate(packed["l"]).astype(np.int32),
            level_offset=offs, level_count=cnts,
            num_levels=len(levels), m_total=m_total)

    # host-side lookup (oracle for the device kernel; BLAS.cpp:258-308)
    def lookup_backwards(self, m: int, dz2_m: float, dz2_e: int):
        if m == 0:
            return None
        k = m - 1
        if k & 1:
            return None
        if k == 0:
            zeros = 32
            ix = 0
        else:
            zeros = (k & -k).bit_length() - 1
            ix = k >> zeros
        lm2 = max(self.num_levels + FIRST_LEVEL - 2, FIRST_LEVEL)
        start = min(zeros, lm2)
        for level in range(start, FIRST_LEVEL - 1, -1):
            li = level - FIRST_LEVEL
            if li >= self.num_levels or ix >= self.level_count[li]:
                ix <<= 1
                continue
            g = self.level_offset[li] + ix
            r2m, r2e = self.r2_m[g], self.r2_e[g]
            less = (dz2_e < r2e) or (dz2_e == r2e and dz2_m < r2m)
            if less:
                return g
            ix <<= 1
        return None


def get_or_build_bla(results) -> BLATable:
    bla = results.extra.get("bla_table")
    if bla is None:
        from fractalshark_tpu_torch.core.hdr_host import HD
        rad = HD.from_hp(results.max_radius)
        bx, by = results.orbit_plain()
        bla = BLATable.build(bx, by,
                             rad.m, rad.e)
        results.extra["bla_table"] = bla
    return bla
