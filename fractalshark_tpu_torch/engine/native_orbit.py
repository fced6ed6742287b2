"""ctypes bridge to the native reference-orbit evaluator
(``native/fs_orbit.cpp``), the MT3-CPU-path analogue.

The shared library is built on demand with g++ against the system
libgmp (mpn layer, stable ABI) and cached under
``fractalshark_tpu_torch/build/`` (the JAX package builds the same
source into ``native/build/``; neither build touches the other's).
Falls back gracefully: callers use ``available()`` and keep the pure
Python fixed-point path when the toolchain or libgmp is missing.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading

import numpy as np

from fractalshark_tpu_torch.core.hdr_host import HD
from fractalshark_tpu_torch.core.highprecision import HighPrecision
from fractalshark_tpu_torch.engine.perturbation_results import (
    PerturbationResults)

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SRC = os.path.join(os.path.dirname(_PKG), "native", "fs_orbit.cpp")
_SO = os.path.join(_PKG, "build", "libfs_orbit.so")

_lib = None
_lib_lock = threading.Lock()
_build_failed = False


def _build() -> bool:
    os.makedirs(os.path.dirname(_SO), exist_ok=True)
    # built under a private name and renamed into place, so that a
    # concurrent process never loads a half-written library
    tmp = f"{_SO}.{os.getpid()}.tmp"
    # -ffp-contract=off: the compressor shadow recurrence must round
    # exactly like the strict-IEEE host/device decompressors — FMA
    # contraction shifts the store/skip decision on borderline entries
    cmd = ["g++", "-O3", "-shared", "-fPIC", "-march=native",
           "-ffp-contract=off", "-pthread",
           "-o", tmp, _SRC, "-l:libgmp.so.10"]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
        os.replace(tmp, _SO)
        return True
    except Exception:
        return False


def _load():
    global _lib, _build_failed
    with _lib_lock:
        if _lib is not None or _build_failed:
            return _lib
        if not os.path.exists(_SO) or \
                os.path.getmtime(_SO) < os.path.getmtime(_SRC):
            if not _build():
                _build_failed = True
                return None
        try:
            lib = ctypes.CDLL(_SO)
        except OSError:
            _build_failed = True
            return None
        lib.fs_orbit_create.restype = ctypes.c_void_p
        lib.fs_orbit_create.argtypes = [
            ctypes.POINTER(ctypes.c_uint64), ctypes.c_int,
            ctypes.POINTER(ctypes.c_uint64), ctypes.c_int,
            ctypes.c_int64, ctypes.c_double, ctypes.c_int64,
            ctypes.c_int, ctypes.c_int,
            ctypes.c_double, ctypes.c_double]
        lib.fs_orbit_destroy.argtypes = [ctypes.c_void_p]
        lib.fs_orbit_run.restype = ctypes.c_int64
        lib.fs_orbit_run.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
            ctypes.POINTER(ctypes.c_double),
            ctypes.POINTER(ctypes.c_double),
            ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_int32)]
        for fn in ("fs_orbit_iters", "fs_orbit_total_count",
                   "fs_orbit_had_dip", "fs_orbit_state_size"):
            getattr(lib, fn).restype = ctypes.c_int64
            getattr(lib, fn).argtypes = [ctypes.c_void_p]
        lib.fs_orbit_status.restype = ctypes.c_int32
        lib.fs_orbit_status.argtypes = [ctypes.c_void_p]
        lib.fs_orbit_serialize.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_uint8)]
        lib.fs_orbit_deserialize.restype = ctypes.c_void_p
        lib.fs_orbit_deserialize.argtypes = [
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64]
        lib.fs_reference_orbit.restype = ctypes.c_int64
        lib.fs_reference_orbit.argtypes = [
            ctypes.POINTER(ctypes.c_uint64), ctypes.c_int,
            ctypes.POINTER(ctypes.c_uint64), ctypes.c_int,
            ctypes.c_int64, ctypes.c_int64,
            ctypes.c_double, ctypes.c_int64, ctypes.c_int,
            ctypes.POINTER(ctypes.c_double),
            ctypes.POINTER(ctypes.c_double),
            ctypes.POINTER(ctypes.c_int32),   # out_e (HDR exponents)
            ctypes.POINTER(ctypes.c_int32),   # status
            ctypes.c_int64,                   # reuse_limbs (0 = off)
            ctypes.POINTER(ctypes.c_uint64),  # out_reuse
            ctypes.POINTER(ctypes.c_int8),    # out_reuse_sign
        ]
        _lib = lib
        return _lib


def available() -> bool:
    return _load() is not None


def _hp_to_limbs(x: HighPrecision, nlimbs: int) -> tuple[np.ndarray, int]:
    """Sign-magnitude little-endian 64-bit limbs, one integer limb
    (value = mag / 2^(64*(nlimbs-1)))."""
    frac_bits = 64 * (nlimbs - 1)
    sh = x.exp + frac_bits
    mant = x.mant << sh if sh >= 0 else _round_shift(x.mant, -sh)
    sign = -1 if mant < 0 else 1
    mant = abs(mant)
    out = np.zeros(nlimbs, np.uint64)
    i = 0
    while mant and i < nlimbs:
        out[i] = mant & 0xFFFFFFFFFFFFFFFF
        mant >>= 64
        i += 1
    if mant:
        raise OverflowError("value exceeds native fixed-point range")
    return out, sign


def _round_shift(m: int, s: int) -> int:
    half = 1 << (s - 1)
    return (m + half) >> s if m >= 0 else -((-m + half) >> s)


class NativeOrbitSession:
    """Chunked, checkpointable native orbit — the endurance path.

    The View #27 class (period ~28e9, 10^15-iteration budgets,
    reference Notes/FractalShark-06-RefOrbit.tex:740-747) cannot hold
    an uncompressed orbit (28e9 entries = 450 GB), so the native loop
    emits SimpleCompression anchors on the fly
    (PerturbationResults.cpp:2347-2381) and serializes its complete
    state so a multi-hour run survives interruption exactly
    (GpuOrbitSession checkpoint/resume, KernelInvoke.h:148-169).

    checkpoint_path: base path; ``<base>.state`` holds
    ``n_emitted:int64 || native state bytes`` (written atomically),
    ``<base>.ax/.ay/.ae/.ai`` are file-backed GrowableArrays of the
    emitted entries.  If the state file exists the session RESUMES
    from it (the constructor's center/radius arguments are then only
    used for result metadata).
    """

    def __init__(self, center_x: HighPrecision, center_y: HighPrecision,
                 max_radius: HighPrecision,
                 precision_bits: int | None = None,
                 periodicity: bool = True,
                 compression_error_exp: int | None = None,
                 checkpoint_path: str | None = None):
        lib = _load()
        if lib is None:
            raise RuntimeError("native orbit library unavailable")
        self._lib = lib
        self.center_x = center_x
        self.center_y = center_y
        self.max_radius = max_radius
        self.compression_error_exp = compression_error_exp
        self.checkpoint_path = checkpoint_path
        self.prec = precision_bits or max(center_x.prec, center_y.prec)
        self.nlimbs = max(2, (self.prec + 80 + 63) // 64 + 1)
        self._h = None
        self._resumed = False

        from fractalshark_tpu_torch.utils.growable import (
            AddPointOptions, GrowableArray)
        comp = compression_error_exp is not None
        state_file = (checkpoint_path + ".state"
                      if checkpoint_path else None)
        if state_file and os.path.exists(state_file):
            blob = open(state_file, "rb").read()
            n_emitted = int.from_bytes(blob[:8], "little")
            st = np.frombuffer(blob[8:], np.uint8).copy()
            h = lib.fs_orbit_deserialize(
                st.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                len(st))
            if not h:
                raise ValueError(f"corrupt orbit checkpoint {state_file}")
            self._h = h
            self._resumed = True
            self._gx = GrowableArray.open_existing(checkpoint_path + ".ax")
            self._gy = GrowableArray.open_existing(checkpoint_path + ".ay")
            self._ge = GrowableArray.open_existing(checkpoint_path + ".ae")
            self._gi = GrowableArray.open_existing(checkpoint_path + ".ai")
            # arrays may be AHEAD of the state snapshot (crash between
            # array flush and state write): truncate to the state's view
            for g in (self._gx, self._gy, self._ge, self._gi):
                g._n = min(g._n, n_emitted)
        else:
            cxl, sx = _hp_to_limbs(center_x.with_precision(self.prec),
                                   self.nlimbs)
            cyl, sy = _hp_to_limbs(center_y.with_precision(self.prec),
                                   self.nlimbs)
            rad = HD.from_hp(max_radius)
            self._h = lib.fs_orbit_create(
                cxl.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)), sx,
                cyl.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)), sy,
                self.nlimbs, rad.m, rad.e, int(periodicity),
                int(compression_error_exp) if comp else 0,
                float(center_x), float(center_y))
            if checkpoint_path:
                opt = AddPointOptions.ENABLE_WITH_SAVE
                self._gx = GrowableArray(np.float64,
                                         checkpoint_path + ".ax", opt)
                self._gy = GrowableArray(np.float64,
                                         checkpoint_path + ".ay", opt)
                self._ge = GrowableArray(np.int32,
                                         checkpoint_path + ".ae", opt)
                self._gi = GrowableArray(np.int64,
                                         checkpoint_path + ".ai", opt)
            else:
                self._gx = GrowableArray(np.float64)
                self._gy = GrowableArray(np.float64)
                self._ge = GrowableArray(np.int32)
                self._gi = GrowableArray(np.int64)

    # ------------------------------------------------------------- state

    @property
    def iters(self) -> int:
        return int(self._lib.fs_orbit_iters(self._h))

    @property
    def total_count(self) -> int:
        return int(self._lib.fs_orbit_total_count(self._h))

    @property
    def status(self) -> int:
        """0 running, 1 period found, 2 escaped."""
        return int(self._lib.fs_orbit_status(self._h))

    @property
    def n_emitted(self) -> int:
        return len(self._gx)

    @property
    def had_dip(self) -> int:
        return int(self._lib.fs_orbit_had_dip(self._h))

    def checkpoint(self) -> None:
        if not self.checkpoint_path:
            return
        for g in (self._gx, self._gy, self._ge, self._gi):
            g.finalize()
        n = self._lib.fs_orbit_state_size(self._h)
        buf = np.zeros(n, np.uint8)
        self._lib.fs_orbit_serialize(
            self._h, buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
        tmp = self.checkpoint_path + ".state.tmp"
        with open(tmp, "wb") as f:
            f.write(len(self._gx).to_bytes(8, "little"))
            f.write(buf.tobytes())
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, self.checkpoint_path + ".state")

    # --------------------------------------------------------------- run

    def run(self, max_iterations: int, chunk: int = 1 << 20,
            checkpoint_every_s: float = 300.0,
            abort_flag: threading.Event | None = None,
            progress_cb=None) -> int:
        """Advance until done or max_iterations; returns status."""
        import time
        lib = self._lib
        ox = np.empty(chunk + 2, np.float64)
        oy = np.empty(chunk + 2, np.float64)
        oe = np.empty(chunk + 2, np.int32)
        oi = np.empty(chunk + 2, np.int64)
        status = ctypes.c_int32(self.status)
        last_ck = time.perf_counter()
        t0 = last_ck
        while self.status == 0 and self.iters < max_iterations:
            if abort_flag is not None and abort_flag.is_set():
                break
            steps = min(chunk, max_iterations - self.iters)
            wrote = lib.fs_orbit_run(
                self._h, steps, steps + 2,
                ox.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
                oy.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
                oe.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
                oi.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
                ctypes.byref(status))
            if wrote > 0:
                self._gx.extend(ox[:wrote])
                self._gy.extend(oy[:wrote])
                self._ge.extend(oe[:wrote])
                self._gi.extend(oi[:wrote])
            now = time.perf_counter()
            if self.checkpoint_path and \
                    now - last_ck >= checkpoint_every_s:
                self.checkpoint()
                last_ck = now
            if progress_cb is not None:
                progress_cb(self.iters, max_iterations, now - t0)
        if self.checkpoint_path:
            self.checkpoint()
        return self.status

    # ----------------------------------------------------------- results

    def results(self) -> PerturbationResults:
        """Uncompressed-mode results (every entry emitted)."""
        if self.compression_error_exp is not None:
            raise ValueError("compressed session: use compressed()")
        x = np.asarray(self._gx.view(), np.float64).copy()
        y = np.asarray(self._gy.view(), np.float64).copy()
        e = np.asarray(self._ge.view(), np.int32)
        st = self.status
        return PerturbationResults(
            center_x=self.center_x, center_y=self.center_y,
            orbit_x=x, orbit_y=y, max_radius=self.max_radius,
            period=self.total_count if st == 1 else 0,
            escaped_at=self.total_count if st == 2 else 0,
            max_iterations=self.iters,
            precision_bits=self.prec,
            orbit_e=e.copy() if (e != 0).any() else None)

    def compressed(self):
        """Compressed-mode results: the anchors as a CompressedOrbit."""
        from fractalshark_tpu_torch.engine.perturbation_results import \
            CompressedOrbit
        if self.compression_error_exp is None:
            raise ValueError("uncompressed session: use results()")
        return CompressedOrbit(
            anchors_x=np.asarray(self._gx.view(), np.float64).copy(),
            anchors_y=np.asarray(self._gy.view(), np.float64).copy(),
            anchor_index=np.asarray(self._gi.view(), np.int64).copy(),
            total_count=self.total_count,
            cx_low=float(self.center_x), cy_low=float(self.center_y),
            error_exp=int(self.compression_error_exp))

    def close(self) -> None:
        if self._h:
            self._lib.fs_orbit_destroy(self._h)
            self._h = None
        for g in (self._gx, self._gy, self._ge, self._gi):
            g.close()

    def __del__(self):  # noqa: D105
        try:
            if self._h:
                self._lib.fs_orbit_destroy(self._h)
        except Exception:  # noqa: BLE001
            pass


def compute_reference_orbit_native(center_x: HighPrecision,
                                   center_y: HighPrecision,
                                   max_iterations: int,
                                   max_radius: HighPrecision,
                                   periodicity: bool = True,
                                   precision_bits: int | None = None,
                                   reuse_frac_bits: int | None = None
                                   ) -> PerturbationResults:
    """reuse_frac_bits: when set, the native loop also records the
    intermediate-precision reuse copy of every z during the run (a
    limb-truncating memcpy per iteration — RefOrbitCalc.cpp:543-548),
    attached as ``extra["reuse_orbit"]``.  The effective reuse
    precision rounds up to a limb multiple ≥ the request."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native orbit library unavailable")
    prec = precision_bits or max(center_x.prec, center_y.prec)
    nlimbs = max(2, (prec + 80 + 63) // 64 + 1)
    cx, sx = _hp_to_limbs(center_x, nlimbs)
    cy, sy = _hp_to_limbs(center_y, nlimbs)
    rad = HD.from_hp(max_radius)
    out_x = np.zeros(max_iterations + 2, np.float64)
    out_y = np.zeros(max_iterations + 2, np.float64)
    out_e = np.zeros(max_iterations + 2, np.int32)
    status = ctypes.c_int32(0)
    rl = 0
    out_reuse = np.zeros(1, np.uint64)
    out_rsign = np.zeros(2, np.int8)
    if reuse_frac_bits is not None:
        rl = min(-(-int(reuse_frac_bits) // 64) + 1, nlimbs)
        out_reuse = np.zeros((max_iterations + 2) * 2 * rl, np.uint64)
        out_rsign = np.zeros((max_iterations + 2) * 2, np.int8)
    count = lib.fs_reference_orbit(
        cx.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)), sx,
        cy.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)), sy,
        nlimbs, max_iterations, rad.m, rad.e, int(periodicity),
        out_x.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        out_y.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        out_e.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        ctypes.byref(status), rl,
        out_reuse.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
        out_rsign.ctypes.data_as(ctypes.POINTER(ctypes.c_int8)))
    period = count if status.value == 1 else 0
    escaped = count if status.value == 2 else 0
    oe = out_e[:count]
    res = PerturbationResults(
        center_x=center_x, center_y=center_y,
        orbit_x=out_x[:count].copy(), orbit_y=out_y[:count].copy(),
        max_radius=max_radius, period=period, escaped_at=escaped,
        max_iterations=max_iterations, precision_bits=prec,
        orbit_e=oe.copy() if (oe != 0).any() else None)
    if reuse_frac_bits is not None and rl > 0:
        from fractalshark_tpu_torch.engine.reuse import ReuseOrbit
        limbs = out_reuse[:count * 2 * rl].reshape(count, 2, rl)
        sgn = out_rsign[:count * 2].reshape(count, 2)
        raw = limbs.tobytes()
        stride = 2 * rl * 8
        half = rl * 8
        rzx, rzy = [], []
        for i in range(count):
            o = i * stride
            rzx.append(int(sgn[i, 0]) * int.from_bytes(
                raw[o:o + half], "little"))
            rzy.append(int(sgn[i, 1]) * int.from_bytes(
                raw[o + half:o + stride], "little"))
        res.extra["reuse_orbit"] = ReuseOrbit(
            zx=rzx, zy=rzy, frac_bits=64 * (rl - 1),
            center_x=center_x, center_y=center_y)
    return res
