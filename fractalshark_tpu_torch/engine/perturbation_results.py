"""Reference-orbit storage + compression.

Re-design of the reference ``PerturbationResults``
(``FractalSharkLib/PerturbationResults.h:59-367``): one reference orbit =
the low-precision shadow (x_n, y_n) of the high-precision iteration
z←z²+c at the orbit center, plus metadata {hi-precision center, period,
max radius, iteration budget}.

Orbit values are O(1) in magnitude, so they are stored as float64 numpy
arrays and cast to the render dtype at device-upload time (the
reference's type-erased variant zoo over {f32,f64,2x32,HDR×3} collapses
to one canonical representation + casts).

Compression (``PerturbationResults.h:370-394``, algorithm due to
Zhuoran / fractalforums — SURVEY.md A.4): a compressor shadows the
low-precision recurrence from the last stored anchor and stores an orbit
point only when the relative reconstruction error exceeds
2^-CompressionErrorExp. Decompression *recomputes* spans from anchors.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass, field

import numpy as np

from fractalshark_tpu_torch.core.highprecision import HighPrecision

ESCAPE_RADIUS_SQ = 256.0  # reference orbit escape (PeriodicityChecker.h:95)

ORBIT_FORMAT_VERSION = "1.0"


@dataclass
class PerturbationResults:
    # high-precision orbit center
    center_x: HighPrecision
    center_y: HighPrecision
    # low-precision orbit shadow, uncompressed: z_0 .. z_{n-1}
    orbit_x: np.ndarray
    orbit_y: np.ndarray
    max_radius: HighPrecision          # view half-height at creation
    period: int = 0                    # 0 = no period detected
    escaped_at: int = 0                # 0 = did not escape
    max_iterations: int = 0            # budget the orbit was computed for
    precision_bits: int = 0
    compression_error_exp: int | None = None
    # optional per-entry power-of-two exponents: at extreme depth the
    # orbit's near-period dips underflow f64 (|Z| ~ the minibrot
    # scale); entries with orbit_e[i] != 0 hold (mantissa, exp) —
    # the reference stores HDRFloat orbits for the same reason
    orbit_e: np.ndarray | None = None
    # intermediate-precision reuse orbit (perturbed perturbation) — later
    extra: dict = field(default_factory=dict)

    # ------------------------------------------------------------- queries

    def count_orbit_entries(self) -> int:
        return len(self.orbit_x)

    def orbit_plain(self) -> tuple[np.ndarray, np.ndarray]:
        """f64 orbit values with sub-f64 dips flushed to 0 (plain-float
        consumers: compressors, BLA build, f64 evaluators)."""
        if self.orbit_e is None:
            return self.orbit_x, self.orbit_y
        return (np.ldexp(self.orbit_x, self.orbit_e),
                np.ldexp(self.orbit_y, self.orbit_e))

    def get_complex(self, j: int) -> complex:
        x, y = (self.orbit_x, self.orbit_y) if self.orbit_e is None \
            else self.orbit_plain()
        return complex(x[j], y[j])

    def period_maybe_zero(self) -> int:
        return self.period

    def is_useful_for(self, ptz, num_iterations: int) -> bool:
        """Usefulness test (RefOrbitCalc.cpp:2264-2288): the orbit center
        must lie inside the view, the orbit must have been computed at
        (at least) the precision the view demands — zooming deeper than
        the stored precision would silently feed an under-precise center
        into the dc grid (``ops/perturb.delta_params`` subtracts at
        stored precision) — and the orbit must cover the budget (or have
        ended naturally by period/escape)."""
        inside = (ptz.min_x <= self.center_x <= ptz.max_x and
                  ptz.min_y <= self.center_y <= ptz.max_y)
        if not inside:
            return False
        if self.precision_bits:
            from fractalshark_tpu_torch.core.precision import (
                precision_from_view)
            if self.precision_bits < precision_from_view(ptz):
                return False
        if self.period > 0 or self.escaped_at > 0:
            return True
        return self.max_iterations >= num_iterations

    # -------------------------------------------------------- device views

    def max_ref_iteration(self) -> int:
        return self.count_orbit_entries() - 1

    def device_orbit(self, dtype=np.float64):
        """Orbit arrays for device upload, with ONE extra wraparound
        entry so kernels may read Z[j+1] at j == maxRefIteration before
        the rebase test fires: Z[count] = Z[0] for periodic orbits
        (z_{n+p} = z_n), else the last value repeated.  Sub-f64 dips
        (orbit_e != 0) flush to 0 — correct for the delta kernels,
        whose rebasing covers the near-period window."""
        if self.orbit_e is not None:
            x = np.ldexp(self.orbit_x, self.orbit_e).astype(dtype)
            y = np.ldexp(self.orbit_y, self.orbit_e).astype(dtype)
        else:
            x = self.orbit_x.astype(dtype, copy=False)
            y = self.orbit_y.astype(dtype, copy=False)
        if self.period > 0:
            wx, wy = x[:1], y[:1]
        else:
            wx, wy = x[-1:], y[-1:]
        return (np.concatenate([x, wx]), np.concatenate([y, wy]))

    def device_orbit_df(self):
        """Orbit as double-float (hi, lo) f32 pairs — the 2x32 upload
        the reference's HDRx2x32 kernels take (CudaDblflt orbit arrays,
        GPU_Render.cu InitializePerturb): hi = f32(z), lo = f32(z − hi)
        captures ~48 of the f64 orbit's 53 mantissa bits."""
        ox, oy = self.device_orbit(np.float64)

        def split(v):
            hi = v.astype(np.float32)
            lo = (v - hi.astype(np.float64)).astype(np.float32)
            return hi, lo

        return split(ox) + split(oy)

    # ---------------------------------------------------------- compression

    def compress(self, error_exp: int = 20) -> "CompressedOrbit":
        return CompressedOrbit.from_uncompressed(self, error_exp)

    def compress_max(self, error_exp: int = 20) -> "MaxCompressedOrbit":
        return MaxCompressedOrbit.from_uncompressed(self, error_exp)

    # --------------------------------------------------------------- disk IO

    def save(self, path: str, compression: str = "none",
             error_exp: int | None = None) -> None:
        """Own format: metadata JSON + orbit payload. The reference
        persists orbits as mmap-backed files with a text metadata
        header (PerturbationResults.h:84,142-156).

        compression: "none" → raw mmap-able .npy arrays;
        "simple" → anchors npz (Zhuoran SimpleCompression);
        "max" → waypoint+rebase npz (CompressMax)."""
        if error_exp is None:
            error_exp = self.compression_error_exp or 20
        meta = {
            "version": ORBIT_FORMAT_VERSION,
            "center_x": self.center_x.to_string(),
            "center_y": self.center_y.to_string(),
            "max_radius": self.max_radius.to_string(),
            "period": self.period,
            "escaped_at": self.escaped_at,
            "max_iterations": self.max_iterations,
            "precision_bits": self.precision_bits,
            "count": int(self.count_orbit_entries()),
            "compression": compression,
            "compression_error_exp": (error_exp if compression != "none"
                                      else self.compression_error_exp),
        }
        with open(path + ".meta.json", "w") as f:
            json.dump(meta, f)
        if compression == "simple":
            self.compress(error_exp).save(path + ".orbit.simple.npz")
        elif compression == "max":
            self.compress_max(error_exp).save(path + ".orbit.max.npz")
        elif compression == "none":
            # .npy (not npz) so orbits can be memory-mapped on load —
            # the GrowableVector file-backing analogue (Vectors.h:38-177):
            # the file IS the orbit store
            np.save(path + ".orbit.x.npy", self.orbit_x)
            np.save(path + ".orbit.y.npy", self.orbit_y)
            if self.orbit_e is not None:
                np.save(path + ".orbit.e.npy", self.orbit_e)
        else:
            raise ValueError(f"unknown compression {compression!r}")

    @staticmethod
    def load(path: str, mmap: bool = False) -> "PerturbationResults":
        with open(path + ".meta.json") as f:
            meta = json.load(f)
        if meta["version"] != ORBIT_FORMAT_VERSION:
            raise ValueError(f"orbit format version {meta['version']}")
        prec = meta["precision_bits"] or 256
        compression = meta.get("compression", "none")
        if compression == "simple":
            comp = CompressedOrbit.load(path + ".orbit.simple.npz")
            ox, oy = comp.decompress()
            arrs = {"x": ox, "y": oy}
        elif compression == "max":
            mcomp = MaxCompressedOrbit.load(path + ".orbit.max.npz")
            ox, oy = mcomp.decompress()
            arrs = {"x": ox, "y": oy}
        else:
            mode = "r" if mmap else None
            arrs = {"x": np.load(path + ".orbit.x.npy", mmap_mode=mode),
                    "y": np.load(path + ".orbit.y.npy", mmap_mode=mode)}
            import os as _os
            if _os.path.exists(path + ".orbit.e.npy"):
                arrs["e"] = np.load(path + ".orbit.e.npy",
                                    mmap_mode=mode)
        return PerturbationResults(
            center_x=HighPrecision(meta["center_x"], prec=prec),
            center_y=HighPrecision(meta["center_y"], prec=prec),
            orbit_x=arrs["x"], orbit_y=arrs["y"],
            orbit_e=arrs.get("e"),
            max_radius=HighPrecision(meta["max_radius"], prec=64),
            period=meta["period"], escaped_at=meta["escaped_at"],
            max_iterations=meta["max_iterations"],
            precision_bits=meta["precision_bits"],
            compression_error_exp=meta.get("compression_error_exp"),
        )


@dataclass
class CompressedOrbit:
    """SimpleCompression: stored anchors + their uncompressed indices.

    Reconstruction re-iterates z←z²+c_low forward from the nearest
    anchor (PerturbationResultsHelpers.h:51-161) — decompression is
    recomputation, not decoding.
    """
    anchors_x: np.ndarray        # float64 [M]
    anchors_y: np.ndarray
    anchor_index: np.ndarray     # int64 [M] — uncompressed index of anchor
    total_count: int             # uncompressed orbit length
    cx_low: float                # low-precision center (recurrence constant)
    cy_low: float
    error_exp: int

    @staticmethod
    def from_uncompressed(res: PerturbationResults,
                          error_exp: int = 20) -> "CompressedOrbit":
        """Store z_i iff |shadow_i - z_i|² * 10^errorExp >= |z_i|²
        — the reference's exact test (PerturbationResults.cpp:2347-2381:
        ``CompressionError = pow(10, CompressionErrorExp)`` applied ONCE
        to the squared error), so the interop defaults 20/450 mean the
        same thing here."""
        x, y = res.orbit_plain()
        n = len(x)
        cx = float(res.center_x)
        cy = float(res.center_y)
        threshold_scale = float(10.0 ** error_exp)
        ax, ay, ai = [], [], []
        # shadow recurrence state
        zx, zy = 0.0, 0.0
        have_anchor = False
        for i in range(n):
            tx, ty = x[i], y[i]
            if have_anchor:
                err = (zx - tx) ** 2 + (zy - ty) ** 2
                mag = tx * tx + ty * ty
                store = err * threshold_scale >= mag
            else:
                store = True
            if store:
                ax.append(tx)
                ay.append(ty)
                ai.append(i)
                zx, zy = tx, ty
                have_anchor = True
            # advance shadow: z ← z² + c
            zx, zy = zx * zx - zy * zy + cx, 2.0 * zx * zy + cy
        return CompressedOrbit(
            anchors_x=np.asarray(ax), anchors_y=np.asarray(ay),
            anchor_index=np.asarray(ai, np.int64), total_count=n,
            cx_low=cx, cy_low=cy, error_exp=error_exp)

    @staticmethod
    def identity(res: "PerturbationResults") -> "CompressedOrbit":
        """Every entry an anchor (ratio 1): turns the RC streaming
        kernel into an EXACT streaming evaluator of an uncompressed
        orbit (used for the two-phase LAv2 tail)."""
        x, y = res.orbit_plain()
        return CompressedOrbit(
            anchors_x=np.asarray(x, np.float64),
            anchors_y=np.asarray(y, np.float64),
            anchor_index=np.arange(len(x), dtype=np.int64),
            total_count=len(x), cx_low=float(res.center_x),
            cy_low=float(res.center_y), error_exp=0)

    def compression_ratio(self) -> float:
        return self.total_count / max(1, len(self.anchors_x))

    def decompress(self) -> tuple[np.ndarray, np.ndarray]:
        """Reconstruct the full orbit by recomputation from anchors."""
        n = self.total_count
        x = np.empty(n, np.float64)
        y = np.empty(n, np.float64)
        m = len(self.anchors_x)
        for k in range(m):
            start = int(self.anchor_index[k])
            end = int(self.anchor_index[k + 1]) if k + 1 < m else n
            zx = float(self.anchors_x[k])
            zy = float(self.anchors_y[k])
            for i in range(start, end):
                x[i] = zx
                y[i] = zy
                zx, zy = (zx * zx - zy * zy + self.cx_low,
                          2.0 * zx * zy + self.cy_low)
        return x, y

    def save(self, path: str) -> None:
        np.savez(path,
                 ax=self.anchors_x, ay=self.anchors_y,
                 ai=self.anchor_index,
                 meta=np.asarray([self.total_count, self.error_exp],
                                 np.int64),
                 c=np.asarray([self.cx_low, self.cy_low]))

    @staticmethod
    def load(path: str) -> "CompressedOrbit":
        z = np.load(path)
        return CompressedOrbit(
            anchors_x=z["ax"], anchors_y=z["ay"], anchor_index=z["ai"],
            total_count=int(z["meta"][0]), error_exp=int(z["meta"][1]),
            cx_low=float(z["c"][0]), cy_low=float(z["c"][1]))


class VirtualResults:
    """LA-phase stand-in for :class:`PerturbationResults` when only a
    :class:`CompressedOrbit` exists (the View #27 class — period ~28e9,
    Notes/FractalShark-06-RefOrbit.tex:740-747 — where the ~453 GB
    uncompressed orbit never exists anywhere).

    ``device_orbit`` returns a 1-row dummy: valid ONLY for
    ``la_only=True`` LA machines, whose perturbation-tail branch is
    provably dead (a pixel dropping below stage 0 is marked done in the
    same body step, so ``in_tail`` live pixels never exist) — the real
    tail runs in the RC streaming kernel via the jwait handoff
    (engine/renderers.py two_phase_render)."""

    def __init__(self, center_x, center_y, total_count: int):
        self.center_x = center_x
        self.center_y = center_y
        self._total = int(total_count)
        self.extra: dict = {}

    @staticmethod
    def from_compressed(comp: "CompressedOrbit", center_x,
                        center_y) -> "VirtualResults":
        """``center_x/center_y`` are the HIGH-PRECISION center (the
        compressed orbit stores only the f64 shadow center)."""
        return VirtualResults(center_x, center_y, comp.total_count)

    def max_ref_iteration(self) -> int:
        return self._total - 1

    def device_orbit(self, dtype=np.float64):
        z = np.zeros(1, dtype)
        return z, z


@dataclass
class MaxCompressedOrbit:
    """MaxCompression: waypoints + Zhuoran rebases.

    Faithful re-expression of ``PerturbationResults::CompressMax`` /
    ``DecompressMax`` (PerturbationResults.cpp:1346-1906; algorithm due
    to Zhuoran & mathr's reference-compression writeup). The orbit tail
    is encoded as a *delta orbit against the orbit's own earlier
    entries* — exploiting near-periodicity after the orbit first passes
    close to the origin — so the stored waypoint density collapses on
    period-heavy deep views where SimpleCompression saturates.

    * phase-1 waypoints store z values (plain shadow recurrence);
    * the phase transition fires when cheb(Z_i) < 2⁻⁴ (constant1) and
      stores a rebase-flagged z waypoint;
    * phase-2 waypoints store dz values, rebase flag = "dz reset to z,
      j back to 0"; standalone Zhuoran rebases (cheb(z) < cheb(dz)) are
      kept in a separate index list;
    * decompression replays the dz recurrence against the already-
      reconstructed prefix and back-corrects each span via the dzdc
      Newton step (``CorrectOrbit``).

    Norms are Chebyshev; threshold2 = sqrt(10^errorExp), matching the
    reference exactly.
    """
    wx: np.ndarray            # float64 [M] — waypoint values (z or dz)
    wy: np.ndarray
    windex: np.ndarray        # int64 [M] — uncompressed index
    wrebase: np.ndarray       # bool [M]
    rebases: np.ndarray       # int64 [R] — standalone rebase indices
    total_count: int
    cx_low: float
    cy_low: float
    error_exp: int

    @staticmethod
    def from_uncompressed(res: PerturbationResults,
                          error_exp: int = 20) -> "MaxCompressedOrbit":
        X, Y = res.orbit_plain()
        n = len(X)
        cx = float(res.center_x)
        cy = float(res.center_y)
        threshold2 = float(np.sqrt(10.0 ** error_exp))
        constant1 = 2.0 ** -4
        constant2 = float.fromhex("0x1.000001p0")

        def cheb(x, y):
            return max(abs(x), abs(y))

        wx, wy, wi, wr = [], [], [], []
        rebases: list[int] = []

        # ---- phase 1: plain shadow recurrence (CompressMax:1420-1468)
        zx, zy = cx, cy
        i = 1
        while i < n:
            ox, oy = X[i], Y[i]
            norm_z = cheb(ox, oy)
            if norm_z < constant1:
                zx, zy = ox, oy
                wx.append(ox); wy.append(oy); wi.append(i); wr.append(True)
                break
            if cheb(zx - ox, zy - oy) * threshold2 >= norm_z:
                zx, zy = ox, oy
                wx.append(ox); wy.append(oy); wi.append(i); wr.append(False)
            zx, zy = zx * zx - zy * zy + cx, 2.0 * zx * zy + cy
            i += 1
        else:
            # never came near the origin: pure phase-1 encoding
            return MaxCompressedOrbit(
                wx=np.asarray(wx), wy=np.asarray(wy),
                windex=np.asarray(wi, np.int64),
                wrebase=np.asarray(wr, bool),
                rebases=np.asarray(rebases, np.int64), total_count=n,
                cx_low=cx, cy_low=cy, error_exp=error_exp)

        # ---- phase 2: delta orbit against the orbit itself
        dzx, dzy = zx, zy
        prev_waypoint_iteration = i
        # dz ← 2·Z₀·dz + dz² with Z₀ = 0 (the zero seed entry)
        z0x, z0y = X[0], Y[0]
        t = dzx
        dzx = 2.0 * z0x * dzx - 2.0 * z0y * dzy + dzx * dzx - dzy * dzy
        dzy = 2.0 * z0x * dzy + 2.0 * z0y * t + 2.0 * t * dzy
        i += 1
        j = 1
        while i < n:
            oxi, oyi = X[i], Y[i]
            oxj, oyj = X[j], Y[j]
            zx = dzx + oxj
            zy = dzy + oyj
            norm_z_orig = cheb(zx, zy)
            norm_dz_orig = cheb(dzx, dzy) * constant2
            err = cheb(zx - oxi, zy - oyi) * threshold2
            if j >= prev_waypoint_iteration or err >= norm_z_orig:
                prev_waypoint_iteration = i
                zx, zy = oxi, oyi
                dzx = zx - oxj
                dzy = zy - oyj
                if (cheb(zx, zy) < cheb(dzx, dzy)) or (i - j) * 4 < i:
                    dzx, dzy = zx, zy
                    j = 0
                    wx.append(dzx); wy.append(dzy); wi.append(i)
                    wr.append(True)
                else:
                    wx.append(dzx); wy.append(dzy); wi.append(i)
                    wr.append(False)
            elif norm_z_orig < norm_dz_orig:
                dzx, dzy = zx, zy
                j = 0
                # successive rebases with no intervening waypoint
                # collapse onto the latest one (CompressMax:1566-1578)
                if rebases and rebases[-1] > wi[-1]:
                    rebases[-1] = i
                else:
                    rebases.append(i)
            oxj, oyj = X[j], Y[j]
            t = dzx
            dzx = (2.0 * oxj * dzx - 2.0 * oyj * dzy +
                   dzx * dzx - dzy * dzy)
            dzy = 2.0 * oxj * dzy + 2.0 * oyj * t + 2.0 * t * dzy
            i += 1
            j += 1

        return MaxCompressedOrbit(
            wx=np.asarray(wx), wy=np.asarray(wy),
            windex=np.asarray(wi, np.int64), wrebase=np.asarray(wr, bool),
            rebases=np.asarray(rebases, np.int64), total_count=n,
            cx_low=cx, cy_low=cy, error_exp=error_exp)

    def compression_ratio(self) -> float:
        return self.total_count / max(1, len(self.wx) + len(self.rebases))

    def decompress(self) -> tuple[np.ndarray, np.ndarray]:
        """DecompressMax (PerturbationResults.cpp:1660-1906) with the
        CorrectOrbit backward dzdc-Newton span correction."""
        n = self.total_count
        ox = np.zeros(n, np.float64)
        oy = np.zeros(n, np.float64)
        cx, cy = self.cx_low, self.cy_low
        M = len(self.wx)
        R = len(self.rebases)

        def cheb(x, y):
            return max(abs(x), abs(y))

        def correct_orbit(begin, end, diff_x, diff_y):
            dzdc_x, dzdc_y = 1.0, 0.0
            i = end
            while i > begin:
                i -= 1
                old = dzdc_x
                dzdc_x = dzdc_x * ox[i] * 2 - dzdc_y * oy[i] * 2
                dzdc_y = old * oy[i] * 2 + dzdc_y * ox[i] * 2
                den = dzdc_x * dzdc_x + dzdc_y * dzdc_y
                if den == 0.0 or not np.isfinite(den):
                    continue
                ox[i] += (diff_x * dzdc_x + diff_y * dzdc_y) / den
                oy[i] += (diff_y * dzdc_x - diff_x * dzdc_y) / den

        wp = 0
        rb = 0
        next_wp = int(self.windex[0]) if M else -1
        next_rebase = int(self.rebases[0]) if R else -1
        uncorrected_begin = 1

        # ---- phase 1
        zx, zy = 0.0, 0.0
        i = 0
        entered_phase2 = False
        while i < n:
            if i == next_wp:
                correct_orbit(uncorrected_begin, i,
                              self.wx[wp] - zx, self.wy[wp] - zy)
                uncorrected_begin = i + 1
                zx, zy = self.wx[wp], self.wy[wp]
                rebase = bool(self.wrebase[wp])
                wp += 1
                next_wp = int(self.windex[wp]) if wp < M else -1
                if rebase:
                    entered_phase2 = True
                    break
            ox[i] = zx
            oy[i] = zy
            zx, zy = zx * zx - zy * zy + cx, 2.0 * zx * zy + cy
            i += 1
        if not entered_phase2:
            return ox, oy

        # ---- phase 2
        j = 0
        dzx, dzy = zx, zy
        while i < n:
            zx = dzx + ox[j]
            zy = dzy + oy[j]
            if i == next_wp:
                if bool(self.wrebase[wp]):
                    dzx, dzy = zx, zy
                    j = 0
                correct_orbit(uncorrected_begin, i,
                              self.wx[wp] - dzx, self.wy[wp] - dzy)
                uncorrected_begin = i + 1
                dzx, dzy = self.wx[wp], self.wy[wp]
                zx = dzx + ox[j]
                zy = dzy + oy[j]
                wp += 1
                next_wp = int(self.windex[wp]) if wp < M else -1
            elif i == next_rebase:
                rb += 1
                next_rebase = int(self.rebases[rb]) if rb < R else -1
                dzx, dzy = zx, zy
                j = 0
            elif cheb(zx, zy) < cheb(dzx, dzy):
                dzx, dzy = zx, zy
                j = 0
            ox[i] = zx
            oy[i] = zy
            t = dzx
            dzx = (2.0 * ox[j] * dzx - 2.0 * oy[j] * dzy +
                   dzx * dzx - dzy * dzy)
            dzy = 2.0 * ox[j] * dzy + 2.0 * oy[j] * t + 2.0 * t * dzy
            i += 1
            j += 1
        return ox, oy

    def save(self, path: str) -> None:
        np.savez(path, wx=self.wx, wy=self.wy, wi=self.windex,
                 wr=self.wrebase, rebases=self.rebases,
                 meta=np.asarray([self.total_count, self.error_exp],
                                 np.int64),
                 c=np.asarray([self.cx_low, self.cy_low]))

    @staticmethod
    def load(path: str) -> "MaxCompressedOrbit":
        z = np.load(path)
        return MaxCompressedOrbit(
            wx=z["wx"], wy=z["wy"], windex=z["wi"], wrebase=z["wr"],
            rebases=z["rebases"],
            total_count=int(z["meta"][0]), error_exp=int(z["meta"][1]),
            cx_low=float(z["c"][0]), cy_low=float(z["c"][1]))
