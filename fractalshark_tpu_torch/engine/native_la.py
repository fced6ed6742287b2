"""ctypes bridge to the native LA-table builder (``native/la_build.cpp``).

Built, like ``native_orbit``, into ``fractalshark_tpu_torch/build/``.

The reference builds its LA tables in C++ on the CPU
(``FractalSharkLib/LAReference.cpp:218+`` CreateLAFromOrbit/MT); the
Python builder in ``la_reference.py`` costs ~60 µs per orbit entry
(HD/HDC object arithmetic), which dominates deep-view render setup.
This bridge runs the identical algorithm natively (~3 orders of
magnitude faster) and returns an ``LAReferenceHost``-compatible object
holding the flattened arrays directly.

Falls back gracefully: callers use ``available()`` and keep the Python
builder when the toolchain is missing. The Python builder remains the
differential-test oracle (tests/test_la.py compares the two).
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading

import numpy as np

from fractalshark_tpu_torch.core.hdr_host import HD, HDC
from fractalshark_tpu_torch.engine.la_reference import (
    ATInfo, LAParameters, LAReferenceHost)

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SRC = os.path.join(os.path.dirname(_PKG), "native", "la_build.cpp")
_SO = os.path.join(_PKG, "build", "libfs_la.so")

_lib = None
_lib_lock = threading.Lock()
_build_failed = False

_D = ctypes.POINTER(ctypes.c_double)
_I = ctypes.POINTER(ctypes.c_int64)


def _build() -> bool:
    os.makedirs(os.path.dirname(_SO), exist_ok=True)
    # private name, then an atomic rename (see native_orbit._build)
    tmp = f"{_SO}.{os.getpid()}.tmp"
    # -ffp-contract=off: no FMA contraction — outputs stay bit-exact vs
    # the Python oracle (the baseline -O2 build relied on x86-64 having
    # no FMA instruction; make it explicit); C++20 for std::bit_cast
    cmd = ["g++", "-O3", "-std=c++20", "-ffp-contract=off",
           "-shared", "-fPIC", "-o", tmp, _SRC]
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
        lib.fs_la_generate.restype = ctypes.c_int64
        lib.fs_la_generate.argtypes = [
            _D, _D, ctypes.c_int64,                      # orbit
            ctypes.c_void_p,                             # orbit exps (opt)
            ctypes.c_double, ctypes.c_int64,             # radius
            ctypes.c_int, ctypes.c_double, ctypes.c_double,
            ctypes.c_double, ctypes.c_double, ctypes.c_double,
            ctypes.c_double, ctypes.c_int,
            ctypes.c_int64,                              # low_bound
            ctypes.c_int,                                # sub_is_f32
            ctypes.c_int64,                              # cap
            _D, _I, _D, _I, _D, _I, _D, _I, _D, _I,      # node arrays
            _I, _I,                                      # step/next
            _I, _I,                                      # stage arrays
            _D, _I, _I,                                  # AT + flags
        ]
        lib.fs_la_generate_rc.restype = ctypes.c_int64
        lib.fs_la_generate_rc.argtypes = [
            _D, _D, _I, ctypes.c_int64, ctypes.c_int64,  # anchors, n_orbit
            ctypes.c_double, ctypes.c_double,            # cx/cy low
            ctypes.c_double, ctypes.c_int64,             # radius
            ctypes.c_int, ctypes.c_double, ctypes.c_double,
            ctypes.c_double, ctypes.c_double, ctypes.c_double,
            ctypes.c_double, ctypes.c_int,
            ctypes.c_int64,                              # low_bound
            ctypes.c_int,                                # sub_is_f32
            ctypes.c_int64,                              # cap
            _D, _I, _D, _I, _D, _I, _D, _I, _D, _I,
            _I, _I,
            _I, _I,
            _D, _I, _I,
        ]
        lib.fs_la_begin_rc.restype = ctypes.c_void_p
        lib.fs_la_begin_rc.argtypes = [
            _D, _D, _I, ctypes.c_int64, ctypes.c_int64,  # anchors, n_orbit
            ctypes.c_double, ctypes.c_double,            # cx/cy low
            ctypes.c_int, ctypes.c_double, ctypes.c_double,
            ctypes.c_double, ctypes.c_double, ctypes.c_double,
            ctypes.c_double, ctypes.c_int,
            ctypes.c_int64,                              # low_bound
        ]
        lib.fs_la_result_n.restype = ctypes.c_int64
        lib.fs_la_result_n.argtypes = [ctypes.c_void_p]
        lib.fs_la_result_stages.restype = ctypes.c_int64
        lib.fs_la_result_stages.argtypes = [ctypes.c_void_p]
        lib.fs_la_collect.restype = ctypes.c_int64
        lib.fs_la_collect.argtypes = [
            ctypes.c_void_p,
            ctypes.c_double, ctypes.c_int64,             # radius
            ctypes.c_int,                                # sub_is_f32
            _D, _I, _D, _I, _D, _I, _D, _I, _D, _I,
            _I, _I,
            _I, _I,
            _D, _I, _I,
        ]
        lib.fs_la_free.restype = None
        lib.fs_la_free.argtypes = [ctypes.c_void_p]
        _lib = lib
        return _lib


def available() -> bool:
    return _load() is not None


class LAReferenceArrays(LAReferenceHost):
    """LA table built natively — array-backed; same consumer interface
    as the Python-built table (device_arrays / use_at / at / stages)."""

    def __init__(self, arrays: dict, stage_la_index, stage_macro,
                 stage_count: int, at: ATInfo | None,
                 params: LAParameters):
        super().__init__(params=params)
        self._arrays = arrays
        self.stage_la_index = list(stage_la_index)
        self.stage_macro_it_count = list(stage_macro)
        self.stage_count = stage_count
        self.at = at
        self.use_at = at is not None
        self.is_valid = True
        self.las = _NodeView(arrays)

    def device_arrays(self, dtype=np.float32) -> dict:
        # exponents normalized to i32 at the upload boundary: the
        # in-place/memmap collect path stores them i64 (the native ABI
        # width); copy=False keeps already-i32 tables alias-free
        a = self._arrays

        def e32(k):
            return a[k].astype(np.int32, copy=False)

        return {
            "ref_m": a["ref_m"].astype(dtype), "ref_e": e32("ref_e"),
            "zc_m": a["zc_m"].astype(dtype), "zc_e": e32("zc_e"),
            "cc_m": a["cc_m"].astype(dtype), "cc_e": e32("cc_e"),
            "thr_m": a["thr_m"].astype(dtype), "thr_e": e32("thr_e"),
            "thrc_m": a["thrc_m"].astype(dtype), "thrc_e": e32("thrc_e"),
            "step_length": a["step_length"],
            # int64: stage-0 next indices are orbit positions (up to
            # the period — beyond int32 at View #27 class)
            "next_stage_la_index": a["next_stage_la_index"],
            "stage_la_index": np.asarray(self.stage_la_index, np.int32),
            "stage_macro_it_count": np.asarray(
                self.stage_macro_it_count, np.int32),
            "stage_count": self.stage_count,
        }

    def stage_window(self, min_stage: int) -> "LAReferenceArrays":
        """A table holding only stages ``>= min_stage`` — the
        HBM-fitting device table for period-billions views.  View #27's
        full table is 426.6M nodes (~37 GB as device arrays, vs 16 GB
        HBM); its stage 0 is ~85% of the nodes, and dropping it only
        moves each pixel's one-time tail handoff earlier by at most one
        stage-1 macro step (~stage-1 step_length extra streamed tail
        iterations per pixel — noise against a 5e13 budget).

        The dropped stage's role in the handoff is preserved exactly:
        the machine hands ``NextStageLAIndex`` of the last unusable
        lowest-stage node to the tail as an ORBIT POSITION, so the new
        lowest stage's next-indices (offsets into the dropped stage,
        ``native/la_build.cpp`` create_new_la_stage) are remapped
        through the dropped stage's step-length prefix sum to the orbit
        positions those offsets denote."""
        if not 0 < min_stage < self.stage_count:
            if min_stage == 0:
                return self
            raise ValueError(f"min_stage {min_stage} out of range "
                             f"(stage_count {self.stage_count})")
        a = self._arrays
        idx = list(self.stage_la_index) + [len(self.las)]
        base = int(idx[min_stage])
        new = {k: np.asarray(a[k][base:]) for k in a}
        # orbit position of stage (min_stage-1) offset j = exclusive
        # prefix sum of that stage's step lengths
        lo, hi = int(idx[min_stage - 1]), base
        steps = np.asarray(a["step_length"][lo:hi], np.int64)
        pos = np.concatenate([np.zeros(1, np.int64), np.cumsum(steps)])
        end0 = int(idx[min_stage + 1]) - base
        nsi = new["next_stage_la_index"].astype(np.int64, copy=True)
        low = np.clip(nsi[:end0], 0, len(steps))
        nsi[:end0] = pos[low]
        new["next_stage_la_index"] = nsi
        return LAReferenceArrays(
            new, [int(x) - base for x in self.stage_la_index[min_stage:]],
            self.stage_macro_it_count[min_stage:],
            self.stage_count - min_stage, self.at, self.params)


    # ------------------------------------------------------ persistence

    def _meta_kwargs(self) -> dict:
        """The non-node-array savez payload (stages, params, AT) shared
        by the single-npz and directory persistence formats."""
        at = self.at
        at_m = np.zeros(10, np.float64)
        at_e = np.zeros(6, np.int64)
        at_step = 0
        if at is not None:
            at_step = int(at.step_length)
            at_m[:] = [at.threshold_c.m, at.sqr_escape_radius.m,
                       at.ref_c.m.real, at.ref_c.m.imag,
                       at.zcoeff.m.real, at.zcoeff.m.imag,
                       at.ccoeff.m.real, at.ccoeff.m.imag,
                       at.inv_zcoeff.m.real, at.inv_zcoeff.m.imag]
            at_e[:] = [at.threshold_c.e, at.sqr_escape_radius.e,
                       at.ref_c.e, at.zcoeff.e, at.ccoeff.e,
                       at.inv_zcoeff.e]
        return dict(
            stage_la_index=np.asarray(self.stage_la_index, np.int64),
            stage_macro=np.asarray(self.stage_macro_it_count, np.int64),
            meta=np.asarray([self.stage_count,
                             1 if at is not None else 0, at_step,
                             self.params.period_divisor,
                             self.params.low_bound], np.int64),
            at_m=at_m, at_e=at_e)

    def save_npz(self, path: str) -> None:
        """Persist the full node table + stages + AT (the View #27
        class builds take ~20 min over 28e9 reconstructed orbit points
        — the render driver must not pay that twice)."""
        np.savez(path, **self._arrays, **self._meta_kwargs())

    @staticmethod
    def load_npz(path: str) -> "LAReferenceArrays":
        z = np.load(path)
        meta = z["meta"]
        at = _at_from(int(meta[1]), int(meta[2]), z["at_m"], z["at_e"])
        arrays = {k: z[k] for k in (
            "ref_m", "ref_e", "zc_m", "zc_e", "cc_m", "cc_e",
            "thr_m", "thr_e", "thrc_m", "thrc_e",
            "step_length", "next_stage_la_index")}
        p = LAParameters(period_divisor=int(meta[3]),
                         low_bound=int(meta[4]))
        return LAReferenceArrays(arrays, z["stage_la_index"],
                                 z["stage_macro"], int(meta[0]), at, p)

    def save_meta_npz(self, dir_path: str) -> None:
        """Directory-format persistence, part 2: the node arrays are
        already on disk as ``la_<key>.npy`` memmaps (written by
        ``generate_native_rc_streamed(memmap_dir=...)``); this stores
        the small remainder (stages, params, AT) as ``la_meta.npz``.
        ``save_npz`` at View #27 scale would write a second 51 GB copy
        of data that is already persistent."""
        np.savez(os.path.join(dir_path, "la_meta.npz"),
                 **self._meta_kwargs())

    @staticmethod
    def load_dir(dir_path: str) -> "LAReferenceArrays":
        """Open a directory-format table (``la_<key>.npy`` node arrays
        + ``la_meta.npz``) with the node arrays READ-ONLY MEMMAPPED —
        a 51 GB View #27 table opens in milliseconds and only the
        pages a consumer touches (e.g. ``stage_window`` slices) are
        ever read."""
        z = np.load(os.path.join(dir_path, "la_meta.npz"))
        meta = z["meta"]
        at = _at_from(int(meta[1]), int(meta[2]), z["at_m"], z["at_e"])
        arrays = {stem: np.load(os.path.join(dir_path, f"la_{stem}.npy"),
                                mmap_mode="r")
                  for stem, _, _ in _NODE_BUFS.values()}
        p = LAParameters(period_divisor=int(meta[3]),
                         low_bound=int(meta[4]))
        return LAReferenceArrays(arrays, z["stage_la_index"],
                                 z["stage_macro"], int(meta[0]), at, p)


class _NodeView:
    """len()/indexing facade over the flattened node arrays (a few
    callers ask for len(la.las) or individual node fields)."""

    def __init__(self, a: dict):
        self._a = a

    def __len__(self):
        return len(self._a["thr_m"])

    def __getitem__(self, k):
        a = self._a
        from fractalshark_tpu_torch.engine.la_reference import LANode
        return LANode(
            ref=HDC(complex(a["ref_m"][k, 0], a["ref_m"][k, 1]),
                    int(a["ref_e"][k])),
            zcoeff=HDC(complex(a["zc_m"][k, 0], a["zc_m"][k, 1]),
                       int(a["zc_e"][k])),
            ccoeff=HDC(complex(a["cc_m"][k, 0], a["cc_m"][k, 1]),
                       int(a["cc_e"][k])),
            la_threshold=HD(float(a["thr_m"][k]), int(a["thr_e"][k])),
            la_threshold_c=HD(float(a["thrc_m"][k]), int(a["thrc_e"][k])),
            min_mag=HD.zero(),
            step_length=int(a["step_length"][k]),
            next_stage_la_index=int(a["next_stage_la_index"][k]))


def _at_from(present: int, step_length: int, at_m, at_e):
    """Rebuild the ATInfo from its flat (mantissa, exponent) payload —
    the persistence formats and the native collect all share it."""
    if not present:
        return None
    return ATInfo(
        step_length=step_length,
        threshold_c=HD(float(at_m[0]), int(at_e[0])),
        sqr_escape_radius=HD(float(at_m[1]), int(at_e[1])),
        ref_c=HDC(complex(at_m[2], at_m[3]), int(at_e[2])),
        zcoeff=HDC(complex(at_m[4], at_m[5]), int(at_e[3])),
        ccoeff=HDC(complex(at_m[6], at_m[7]), int(at_e[4])),
        inv_zcoeff=HDC(complex(at_m[8], at_m[9]), int(at_e[5])))


def _dp(a):
    return a.ctypes.data_as(_D)


def _ip(a):
    return a.ctypes.data_as(_I)


# per-node output arrays: buffer key -> (LAReferenceArrays key, dtype,
# is 2-wide).  The buffer keys match la_marshal's pointer order; the
# arrays key names the persisted .npy file stem.
_NODE_BUFS = {
    "ref_m": ("ref_m", np.float64, True),
    "ref_e": ("ref_e", np.int64, False),
    "zc_m": ("zc_m", np.float64, True),
    "zc_e": ("zc_e", np.int64, False),
    "cc_m": ("cc_m", np.float64, True),
    "cc_e": ("cc_e", np.int64, False),
    "thr_m": ("thr_m", np.float64, False),
    "thr_e": ("thr_e", np.int64, False),
    "thrc_m": ("thrc_m", np.float64, False),
    "thrc_e": ("thrc_e", np.int64, False),
    "step_length": ("step_length", np.int64, False),
    "next_idx": ("next_stage_la_index", np.int64, False),
}


def _out_bufs(cap: int, memmap_dir: str | None = None) -> dict:
    """Marshalling buffers for the native collect call.  With
    ``memmap_dir`` the twelve per-node arrays are disk-backed
    ``.npy`` memmaps (named after their LAReferenceArrays keys) —
    at View #27 scale they total ~51 GB, which alongside the native
    builder's own ~58 GB table OOM-killed the in-RAM variant."""
    def alloc(stem, dtype, wide):
        shape = (cap, 2) if wide else (cap,)
        if memmap_dir is None:
            return np.empty(shape, dtype)
        return np.lib.format.open_memmap(
            os.path.join(memmap_dir, f"la_{stem}.npy"),
            mode="w+", dtype=dtype, shape=shape)

    b = {key: alloc(stem, dtype, wide)
         for key, (stem, dtype, wide) in _NODE_BUFS.items()}
    b.update(
        stage_idx=np.zeros(1025, np.int64),
        stage_macro=np.zeros(1025, np.int64),
        at_m=np.zeros(10, np.float64), at_e=np.zeros(6, np.int64),
        flags=np.zeros(4, np.int64))
    return b


def _out_ptrs(b: dict) -> tuple:
    return (_dp(b["ref_m"]), _ip(b["ref_e"]), _dp(b["zc_m"]),
            _ip(b["zc_e"]), _dp(b["cc_m"]), _ip(b["cc_e"]),
            _dp(b["thr_m"]), _ip(b["thr_e"]), _dp(b["thrc_m"]),
            _ip(b["thrc_e"]), _ip(b["step_length"]), _ip(b["next_idx"]),
            _ip(b["stage_idx"]), _ip(b["stage_macro"]),
            _dp(b["at_m"]), _ip(b["at_e"]), _ip(b["flags"]))


def _collect(cnt: int, b: dict, p: LAParameters, in_place: bool = False):
    """``in_place`` keeps the marshalling buffers as the table's arrays
    (sliced views, i64 exponents) instead of compacting copies — the
    memmap path at View #27 scale cannot afford a second 51 GB set.
    Every consumer (``_pack_nodes``, ``_NodeView``, ``device_arrays``)
    converts exponents with ``astype(int32)`` at use, so the wider
    dtype is interface-neutral."""
    flags = b["flags"]
    if cnt <= 0 or flags[0] == 0:
        return None
    at_m, at_e = b["at_m"], b["at_e"]
    stage_count = int(flags[3])
    at = _at_from(int(flags[1]), int(flags[2]), at_m, at_e)
    if in_place:
        arrays = {stem: b[key][:cnt]
                  for key, (stem, _, _) in _NODE_BUFS.items()}
    else:
        arrays = {
            "ref_m": b["ref_m"][:cnt].copy(),
            "ref_e": b["ref_e"][:cnt].astype(np.int32),
            "zc_m": b["zc_m"][:cnt].copy(),
            "zc_e": b["zc_e"][:cnt].astype(np.int32),
            "cc_m": b["cc_m"][:cnt].copy(),
            "cc_e": b["cc_e"][:cnt].astype(np.int32),
            "thr_m": b["thr_m"][:cnt].copy(),
            "thr_e": b["thr_e"][:cnt].astype(np.int32),
            "thrc_m": b["thrc_m"][:cnt].copy(),
            "thrc_e": b["thrc_e"][:cnt].astype(np.int32),
            "step_length": b["step_length"][:cnt].copy(),
            "next_stage_la_index": b["next_idx"][:cnt].copy(),
        }
    return LAReferenceArrays(arrays, b["stage_idx"][:stage_count],
                             b["stage_macro"][:stage_count], stage_count,
                             at, p)


def generate_native(orbit_x: np.ndarray, orbit_y: np.ndarray,
                    radius_hd: HD, params: LAParameters | None = None,
                    sub_is_f32: bool = True,
                    orbit_e: np.ndarray | None = None):
    """Native LAReferenceHost.generate. Returns None when the library
    is unavailable or the orbit yields no valid table (callers fall
    back to the Python builder / direct render)."""
    lib = _load()
    if lib is None:
        return None
    p = params or LAParameters()
    ox = np.ascontiguousarray(orbit_x, np.float64)
    oy = np.ascontiguousarray(orbit_y, np.float64)
    n = len(ox)
    cap = 2 * n + 64
    b = _out_bufs(cap)
    rad = radius_hd.reduce()
    if orbit_e is not None:
        oe = np.ascontiguousarray(orbit_e, np.int32)
        oe_ptr = oe.ctypes.data_as(ctypes.c_void_p)
    else:
        oe_ptr = None
    cnt = lib.fs_la_generate(
        _dp(ox), _dp(oy), n, oe_ptr, float(rad.m), int(rad.e),
        p.detection_method, p.la_threshold_scale, p.la_threshold_c_scale,
        p.stage0_period_detection_threshold2,
        p.period_detection_threshold2,
        p.stage0_period_detection_threshold, p.period_detection_threshold,
        p.period_divisor, p.low_bound, 1 if sub_is_f32 else 0,
        cap, *_out_ptrs(b))
    return _collect(cnt, b, p)


def generate_native_rc(compressed, radius_hd: HD,
                       params: LAParameters | None = None,
                       sub_is_f32: bool = True,
                       cap: int | None = None):
    """LA table straight from a ``CompressedOrbit``: the native builder
    reads the orbit through a streaming reconstructing accessor
    (anchors + the f64 recurrence, resetting at every anchor), so the
    uncompressed orbit never materializes anywhere — the LA-build path
    for orbits that only exist compressed (period-billions View #27
    class, ``Notes/FractalShark-06-RefOrbit.tex:740-747``).  Values
    reconstruct exactly as ``CompressedOrbit.decompress``; reference
    analogue: LA building through the decompressing orbit helpers
    (``PerturbationResultsHelpers.h:51-161``).

    ``cap`` bounds the node-table allocation (default: orbit length
    + 64, the empirical ceiling for period-driven stage-0 tables);
    returns None when the library is unavailable, the orbit yields no
    valid table, or the cap is exceeded.

    Default params use period_divisor=8: the reference widens stage-0
    node spacing for compressed orbits to bound table memory
    (LAReference.cpp:12-19, periodDivisor = SimpleCompression ? 8 : 2)
    — at View #27 scale the divisor-2 table would be ~9e9 nodes."""
    lib = _load()
    if lib is None:
        return None
    p = params or LAParameters(period_divisor=8)
    ax = np.ascontiguousarray(compressed.anchors_x, np.float64)
    ay = np.ascontiguousarray(compressed.anchors_y, np.float64)
    ai = np.ascontiguousarray(compressed.anchor_index, np.int64)
    n = int(compressed.total_count)
    if cap is None:
        cap = n + 64
    b = _out_bufs(cap)
    rad = radius_hd.reduce()
    cnt = lib.fs_la_generate_rc(
        _dp(ax), _dp(ay), _ip(ai), len(ax), n,
        float(compressed.cx_low), float(compressed.cy_low),
        float(rad.m), int(rad.e),
        p.detection_method, p.la_threshold_scale, p.la_threshold_c_scale,
        p.stage0_period_detection_threshold2,
        p.period_detection_threshold2,
        p.stage0_period_detection_threshold, p.period_detection_threshold,
        p.period_divisor, p.low_bound, 1 if sub_is_f32 else 0,
        cap, *_out_ptrs(b))
    return _collect(cnt, b, p)


def generate_native_rc_streamed(compressed, radius_hd: HD,
                                params: LAParameters | None = None,
                                sub_is_f32: bool = True,
                                memmap_dir: str | None = None):
    """Two-call-protocol variant of :func:`generate_native_rc`: the
    native builder runs to completion first, reports the EXACT node
    count, and only then are output buffers allocated (sized to fit by
    construction) and marshalled into.  This removes the cap-guessing
    failure mode of the one-call API, which cost two wasted hour-long
    full-orbit passes at View #27 scale (period 28.3e9) when the real
    table outgrew the guessed preallocation.

    Set ``FS_LA_PROGRESS=<path>`` to stream one JSON line per ~2^28
    consumed orbit entries (live node-density monitoring for
    hour-scale builds).  Set ``FS_LA_RESERVE=<count>`` (node count,
    known from a prior counting run) to pre-size the native vector.

    With ``memmap_dir`` the node arrays are marshalled straight into
    disk-backed ``la_<key>.npy`` memmaps in that directory (and the
    returned table's arrays ARE those memmaps): persistence happens as
    a side effect of collection, with no second in-RAM copy — pair
    with :meth:`LAReferenceArrays.save_meta_npz` +
    :meth:`LAReferenceArrays.load_dir`.

    Returns ``(la, info)``: ``la`` is the :class:`LAReferenceArrays`
    (or None on failure) and ``info`` always carries the diagnostic
    facts (``n_nodes`` is -2 when stage-0 detection found no valid
    table — growing memory cannot help; ``error`` names the failure).
    """
    lib = _load()
    if lib is None:
        return None, {"error": "native library unavailable"}
    p = params or LAParameters(period_divisor=8)
    ax = np.ascontiguousarray(compressed.anchors_x, np.float64)
    ay = np.ascontiguousarray(compressed.anchors_y, np.float64)
    ai = np.ascontiguousarray(compressed.anchor_index, np.int64)
    n_orbit = int(compressed.total_count)
    h = lib.fs_la_begin_rc(
        _dp(ax), _dp(ay), _ip(ai), len(ax), n_orbit,
        float(compressed.cx_low), float(compressed.cy_low),
        p.detection_method, p.la_threshold_scale, p.la_threshold_c_scale,
        p.stage0_period_detection_threshold2,
        p.period_detection_threshold2,
        p.stage0_period_detection_threshold, p.period_detection_threshold,
        p.period_divisor, p.low_bound)
    try:
        n = int(lib.fs_la_result_n(h))
        stages = int(lib.fs_la_result_stages(h))
        info = {"n_nodes": n, "n_stage_entries": stages}
        if n < 0:
            info["error"] = "no valid LA table (stage-0 detection failed)"
            return None, info
        if stages > 1025:
            info["error"] = "stage table overflow (>1025 entries)"
            return None, info
        b = _out_bufs(max(n, 1), memmap_dir)
        rad = radius_hd.reduce()
        cnt = lib.fs_la_collect(h, float(rad.m), int(rad.e),
                                1 if sub_is_f32 else 0, *_out_ptrs(b))
        info["cnt"] = int(cnt)
        la = _collect(cnt, b, p, in_place=memmap_dir is not None)
        if memmap_dir is not None:
            for key in _NODE_BUFS:
                b[key].flush()
        return la, info
    finally:
        lib.fs_la_free(h)
