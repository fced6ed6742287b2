"""LA (linear approximation) table construction — the LAv2 deep-zoom
accelerator.

Host-side rebuild of ``LAReference``
(``FractalSharkLib/LAReference.cpp``; node algebra
``HpSharkFloatLib/LAInfoDeep.h``; per SURVEY.md A.2):

* stage 0: walk the reference orbit, starting a new LA node whenever
  period detection fires (default detection method 1: the running
  MinMag = min cheb|z| dropping below MinMag·2^-6) or the period window
  ends (``LAReference.cpp:31-208``);
* stage k+1: pairwise Composite of stage-k nodes until a stage has
  < lowBound = 64 nodes (``LAReference.h:56``); max 1024 stages;
* AT (series-approximation head skip): built from the top stage's first
  node (``LAInfoDeep.h CreateAT``, ``LAReference.cpp CreateATFromLA``).

Node fields {Ref, ZCoeff, CCoeff, LAThreshold, LAThresholdC, MinMag}
carry unbounded exponents → host HD/HDC scalars; the finished table is
flattened to (mantissa, exp) numpy arrays for device upload
(the analogue of GPU_LAReference's device copy).
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass, field

import numpy as np

from fractalshark_tpu_torch.core.hdr_host import HD, HDC

LOW_BOUND = 64           # LAReference.h:56
MAX_LA_STAGES = 1024     # LAReference.h:272
DEFAULT_PERIOD_DIVISOR = 2   # LAReference.cpp:17-19 (8 when compressed)


@dataclass
class LAParameters:
    """Tuning parameters, powers of two (LAParameters.h:66-73)."""
    detection_method: int = 1
    la_threshold_scale: float = 2.0 ** -24
    la_threshold_c_scale: float = 2.0 ** -24
    stage0_period_detection_threshold2: float = 2.0 ** -6
    period_detection_threshold2: float = 2.0 ** -3
    stage0_period_detection_threshold: float = 2.0 ** -10
    period_detection_threshold: float = 2.0 ** -10
    period_divisor: int = DEFAULT_PERIOD_DIVISOR
    # How small a stage may get before composition stops (the
    # reference's fixed lowBound = 64, LAReference.h:56).  Deep renders
    # wrap the whole orbit inside the LA machine — one wrap costs one
    # pass over the TOP stage's nodes — so composing further (down to a
    # single whole-orbit node via the period==0 terminal branch) divides
    # per-wrap macro-step counts by up to 64.  The View #27 class
    # (10^15-iteration budgets = tens of thousands of wraps/pixel) needs
    # low_bound=1; see tools/view27_la.py and docs/DESIGN.md.
    low_bound: int = LOW_BOUND
    # TPU-native perf lever with no reference analogue: drop the k
    # finest LA stages from the DEVICE table (LAReferenceHost
    # .stage_window — the same mechanism that caps the View #27 table
    # to HBM).  Pixels that would have descended into the dropped
    # stages take their micro-iterations in the streaming RC tail,
    # which amortizes lockstep steps across all pixels instead of
    # paying one packed HBM gather per pixel per step.  Measured on the
    # View #6 512² deep render (tools/ab_la_depth.py, warm,
    # alternating reps): phase-1 3.61 s → 2.39 s at k=2 with the tail
    # flat; iteration counts shift by ~1.6e-7 relative (same class of
    # change as the reference's MaxPerf threshold rescale,
    # LAParameters.cpp:266-272).  0 = off.
    device_stage_window: int = 0

    @staticmethod
    def max_accuracy() -> "LAParameters":
        return LAParameters()

    @staticmethod
    def max_perf() -> "LAParameters":
        # LAParameters.cpp:266-272: threshold scales +12 exponents
        return LAParameters(la_threshold_scale=2.0 ** -12,
                            la_threshold_c_scale=2.0 ** -12)

    @staticmethod
    def min_memory() -> "LAParameters":
        return LAParameters(period_divisor=8)


@dataclass
class LANode:
    ref: HDC
    zcoeff: HDC
    ccoeff: HDC
    la_threshold: HD
    la_threshold_c: HD
    min_mag: HD
    step_length: int = 0
    next_stage_la_index: int = 0


def _new_node(p: LAParameters, z: HDC) -> LANode:
    return LANode(
        ref=z,
        zcoeff=HDC.from_complex(1.0),
        ccoeff=HDC.from_complex(1.0),
        la_threshold=HD.from_float(1.0),
        la_threshold_c=HD.from_float(1.0),
        min_mag=HD.from_float(4.0) if p.detection_method == 1 else HD.zero())


def _hd_min(a: HD, b: HD) -> HD:
    return a if a.lt(b) else b


def _detect_period(p: LAParameters, node: LANode, z: HDC) -> bool:
    if p.detection_method == 1:
        return z.cheb().lt(node.min_mag.mul_float(
            p.period_detection_threshold2))
    t = node.ref  # unused in this branch shape; keep reference formula
    lhs = _hd_div(z.cheb(), node.zcoeff.cheb()).mul_float(
        p.la_threshold_scale)
    return lhs.lt(node.la_threshold.mul_float(p.period_detection_threshold))


def _hd_div(a: HD, b: HD) -> HD:
    if b.m == 0.0:
        # divisor underflowed (orbit dip below the mantissa range):
        # treat the quotient as zero-threshold (conservative)
        return HD(0.0, 0)
    return HD(a.m / b.m, a.e - b.e).reduce()


def _step(p: LAParameters, node: LANode, z: HDC) -> tuple[LANode, bool]:
    """LAInfoDeep::Step (LAInfoDeep.h:187-259): extend node by one orbit
    point z; returns (new_node, period_detected)."""
    cheb_z = z.cheb()
    out_min = _hd_min(cheb_z, node.min_mag) if p.detection_method == 1 \
        else node.min_mag
    t1 = _hd_div(cheb_z, node.zcoeff.cheb()).mul_float(p.la_threshold_scale)
    t2 = _hd_div(cheb_z, node.ccoeff.cheb()).mul_float(p.la_threshold_c_scale)
    out_thr = _hd_min(node.la_threshold, t1)
    out_thr_c = _hd_min(node.la_threshold_c, t2)
    z2 = z.mul_float(2.0)
    out_zc = z2 * node.zcoeff
    out_cc = z2 * node.ccoeff + HDC.from_complex(1.0)
    out = LANode(ref=node.ref, zcoeff=out_zc, ccoeff=out_cc,
                 la_threshold=out_thr, la_threshold_c=out_thr_c,
                 min_mag=out_min)
    if p.detection_method == 1:
        detected = out.min_mag.lt(node.min_mag.mul_float(
            p.stage0_period_detection_threshold2))
    else:
        detected = out.la_threshold.lt(node.la_threshold.mul_float(
            p.stage0_period_detection_threshold))
    return out, detected


def _composite(p: LAParameters, node: LANode,
               la: LANode) -> tuple[LANode, bool]:
    """LAInfoDeep::Composite (LAInfoDeep.h:296-381): merge `node` with
    the following node `la`."""
    z = la.ref
    cheb_z = z.cheb()
    t1 = _hd_div(cheb_z, node.zcoeff.cheb()).mul_float(p.la_threshold_scale)
    t2 = _hd_div(cheb_z, node.ccoeff.cheb()).mul_float(p.la_threshold_c_scale)
    out_thr = _hd_min(node.la_threshold, t1)
    out_thr_c = _hd_min(node.la_threshold_c, t2)
    z2 = z.mul_float(2.0)
    zc = z2 * node.zcoeff
    cc = z2 * node.ccoeff
    t1 = _hd_div(la.la_threshold, zc.cheb())
    t2 = _hd_div(la.la_threshold, cc.cheb())
    temp = out_thr
    out_thr = _hd_min(out_thr, t1)
    out_thr_c = _hd_min(out_thr_c, t2)
    out_zc = zc * la.zcoeff
    out_cc = cc * la.zcoeff + la.ccoeff
    if p.detection_method == 1:
        t = _hd_min(cheb_z, node.min_mag)
        out_min = _hd_min(t, la.min_mag)
        detected = t.lt(node.min_mag.mul_float(p.period_detection_threshold2))
    else:
        out_min = node.min_mag
        detected = temp.lt(node.la_threshold.mul_float(
            p.period_detection_threshold))
    out = LANode(ref=node.ref, zcoeff=out_zc, ccoeff=out_cc,
                 la_threshold=out_thr, la_threshold_c=out_thr_c,
                 min_mag=out_min)
    return out, detected


@dataclass
class ATInfo:
    """Series-approximation head skip (HpSharkFloatLib/ATInfo.h:80-115)."""
    step_length: int
    threshold_c: HD
    sqr_escape_radius: HD
    ref_c: HDC
    zcoeff: HDC
    ccoeff: HDC
    inv_zcoeff: HDC


def _create_at(node: LANode, next_node: LANode,
               sub_is_f32: bool) -> ATInfo:
    """LAInfoDeep::CreateAT (LAInfoDeep.h:458-503)."""
    zc = node.zcoeff
    cc = zc * node.ccoeff
    inv_zc = zc.reciprocal()
    ref_c = next_node.ref * zc
    lim = HD(1.0, 32 if sub_is_f32 else 256)
    sqr_esc = _hd_min(zc.norm_sqr() * node.la_threshold, lim)
    thr_c = _hd_min(node.la_threshold_c, _hd_div(lim, cc.cheb()))
    return ATInfo(step_length=node.step_length, threshold_c=thr_c,
                  sqr_escape_radius=sqr_esc, ref_c=ref_c,
                  zcoeff=zc, ccoeff=cc, inv_zcoeff=inv_zc)


def _at_usable(at: ATInfo, sqr_radius: HD) -> bool:
    """ATInfo::Usable (ATInfo.h:93-106), factor = 2^32."""
    result = at.ccoeff.norm_sqr() * sqr_radius * HD(1.0, 32)
    four = HD.from_float(4.0)
    return (at.ref_c.norm_sqr().lt(result) and
            four.lt(at.sqr_escape_radius))


def _orbit_accessor(orbit):
    if isinstance(orbit, tuple):
        vals, exps = orbit

        def gc(i):
            c = HDC.from_complex(vals[i])
            if c.m == 0:
                return c
            return HDC(c.m, c.e + int(exps[i]))

        return gc
    return lambda i: HDC.from_complex(orbit[i])


@dataclass
class LAReferenceHost:
    """Built LA table (host form)."""
    las: list = field(default_factory=list)          # list[LANode]
    stage_la_index: list = field(default_factory=list)
    stage_macro_it_count: list = field(default_factory=list)
    stage_count: int = 0
    is_valid: bool = False
    use_at: bool = False
    at: ATInfo | None = None
    params: LAParameters = field(default_factory=LAParameters)

    # ------------------------------------------------------------ build

    @staticmethod
    def generate(orbit_x: np.ndarray, orbit_y: np.ndarray,
                 radius_hd: HD, params: LAParameters | None = None,
                 sub_is_f32: bool = True,
                 orbit_e: np.ndarray | None = None) -> "LAReferenceHost":
        """GenerateApproximationData (LAReference.cpp:974-1017).

        orbit_e: optional per-entry power-of-two exponents — at extreme
        depth the orbit's near-period dips (|Z| ~ the minibrot scale)
        underflow plain f64, and a zero Ref poisons node coefficients;
        the reference stores HDRFloat orbits for the same reason."""
        self = LAReferenceHost(params=params or LAParameters())
        max_ref = len(orbit_x) - 1
        if max_ref == 0:
            return self
        orbit = orbit_x.astype(np.float64) + 1j * orbit_y.astype(np.float64)
        if orbit_e is not None:
            orbit = (orbit, np.asarray(orbit_e, np.int64))
        detected = self._create_la_from_orbit(orbit, max_ref)
        if not detected:
            return self
        while True:
            detected = self._create_new_la_stage(orbit, max_ref)
            if not detected:
                break
        self._create_at_from_la(radius_hd, sub_is_f32, max_ref)
        self.is_valid = True
        return self

    @staticmethod
    def generate_auto(orbit_x: np.ndarray, orbit_y: np.ndarray,
                      radius_hd: HD, params: LAParameters | None = None,
                      sub_is_f32: bool = True,
                      orbit_e: np.ndarray | None = None
                      ) -> "LAReferenceHost":
        """Native C++ builder when available (LAReference.cpp's CPU
        build path — ~1000× the Python walk), else the Python oracle."""
        from fractalshark_tpu_torch.engine import native_la
        la = native_la.generate_native(orbit_x, orbit_y, radius_hd,
                                       params=params,
                                       sub_is_f32=sub_is_f32,
                                       orbit_e=orbit_e)
        if la is not None:
            return la
        return LAReferenceHost.generate(orbit_x, orbit_y, radius_hd,
                                        params=params,
                                        sub_is_f32=sub_is_f32,
                                        orbit_e=orbit_e)

    def _create_la_from_orbit(self, orbit: np.ndarray,
                              max_ref: int) -> bool:
        """Stage-0 build (LAReference.cpp:31-208, single-threaded)."""
        p = self.params
        gc = _orbit_accessor(orbit)
        self.stage_la_index = [0]
        self.stage_macro_it_count = [0]
        self.use_at = False
        self.stage_count = 0

        period = 0
        la = _new_node(p, HDC.zero())
        la, _ = _step(p, la, gc(1))
        next_stage_la_index = 0
        if la.zcoeff.m == 0:
            return False

        i = 2
        while i < max_ref:
            new_la, period_detected = _step(p, la, gc(i))
            if not period_detected:
                la = new_la
                i += 1
                continue
            period = i
            la.step_length = period
            la.next_stage_la_index = next_stage_la_index
            self.las.append(la)
            next_stage_la_index = i
            if i + 1 < max_ref:
                la, _ = _step(p, _new_node(p, gc(i)), gc(i + 1))
                i += 2
            else:
                la = _new_node(p, gc(i))
                i += 1
            break
        else:
            i = max_ref  # loop exhausted without detection

        self.stage_count = 1
        period_begin = period
        period_end = period_begin + period

        if period == 0:
            if max_ref > LOW_BOUND:
                la, _ = _step(p, _new_node(p, gc(0)), gc(1))
                next_stage_la_index = 0
                i = 2
                nth_root = round(math.log2(max_ref) / p.period_divisor)
                period = round(max_ref ** (1.0 / max(1, nth_root)))
                period_begin = 0
                period_end = period
            else:
                la.step_length = max_ref
                la.next_stage_la_index = next_stage_la_index
                self.las.append(la)
                self.las.append(_new_node(p, gc(max_ref)))
                self.stage_macro_it_count[0] = 1
                return False
        elif period > LOW_BOUND:
            self.las.pop()
            la, _ = _step(p, _new_node(p, gc(0)), gc(1))
            next_stage_la_index = 0
            i = 2
            nth_root = round(math.log2(max_ref) / p.period_divisor)
            period = round(max_ref ** (1.0 / max(1, nth_root)))
            period_begin = 0
            period_end = period

        while i < max_ref:
            new_la, period_detected = _step(p, la, gc(i))
            if not period_detected and i < period_end:
                la = new_la
                i += 1
                continue
            la.step_length = i - period_begin
            la.next_stage_la_index = next_stage_la_index
            self.las.append(la)
            next_stage_la_index = i
            period_begin = i
            period_end = period_begin + period
            ip1 = i + 1
            detected = _detect_period(p, new_la, gc(min(ip1, max_ref)))
            if detected or ip1 >= max_ref:
                la = _new_node(p, gc(i))
                i += 1
            else:
                la, _ = _step(p, _new_node(p, gc(i)), gc(ip1))
                i += 2

        la.step_length = i - period_begin
        la.next_stage_la_index = next_stage_la_index
        self.las.append(la)
        self.stage_macro_it_count[0] = len(self.las)
        tail = _new_node(p, gc(max_ref))
        self.las.append(tail)
        return True

    def _create_new_la_stage(self, orbit: np.ndarray, max_ref: int) -> bool:
        """Higher-stage build (LAReference.cpp:777-972)."""
        p = self.params
        gc = _orbit_accessor(orbit)
        prev_stage = self.stage_count - 1
        cur_stage = self.stage_count
        prev_idx = self.stage_la_index[prev_stage]
        prev_count = self.stage_macro_it_count[prev_stage]
        if cur_stage >= MAX_LA_STAGES:
            return False

        self.stage_la_index.append(len(self.las))
        self.stage_macro_it_count.append(0)

        prev_la = self.las[prev_idx]
        prev_lap1 = self.las[prev_idx + 1]

        period = 0
        la, _ = _composite(p, prev_la, prev_lap1)
        next_stage_la_index = 0
        i = prev_la.step_length + prev_lap1.step_length

        j = 2
        while j < prev_count:
            pj = self.las[prev_idx + j]
            new_la, period_detected = _composite(p, la, pj)
            if period_detected:
                if pj.la_threshold.m == 0:
                    break
                period = i
                la.step_length = period
                la.next_stage_la_index = next_stage_la_index
                self.las.append(la)
                next_stage_la_index = j
                pjp1 = self.las[prev_idx + j + 1]
                if (_detect_period(p, new_la, pjp1.ref) or
                        j + 1 >= prev_count):
                    la = LANode(**vars(pj))
                    i += pj.step_length
                    j += 1
                else:
                    la, _ = _composite(p, pj, pjp1)
                    i += pj.step_length + pjp1.step_length
                    j += 2
                break
            la = new_la
            i += pj.step_length
            j += 1

        self.stage_count += 1
        period_begin = period
        period_end = period_begin + period

        if period == 0:
            if max_ref > prev_la.step_length * LOW_BOUND:
                la, _ = _composite(p, prev_la, prev_lap1)
                i = prev_la.step_length + prev_lap1.step_length
                next_stage_la_index = 0
                j = 2
                ratio = max_ref / prev_la.step_length
                nth_root = round(math.log2(max_ref) / p.period_divisor)
                period = prev_la.step_length * round(
                    ratio ** (1.0 / max(1, nth_root)))
                period_begin = 0
                period_end = period
            else:
                la.step_length = max_ref
                la.next_stage_la_index = next_stage_la_index
                self.las.append(la)
                self.las.append(_new_node(p, gc(max_ref)))
                self.stage_macro_it_count[cur_stage] = 1
                return False
        elif period > prev_la.step_length * LOW_BOUND:
            self.las.pop()
            la, _ = _composite(p, prev_la, prev_lap1)
            i = prev_la.step_length + prev_lap1.step_length
            next_stage_la_index = 0
            j = 2
            ratio = period / prev_la.step_length
            nth_root = round(math.log2(max_ref) / p.period_divisor)
            period = prev_la.step_length * round(
                ratio ** (1.0 / max(1, nth_root)))
            period_begin = 0
            period_end = period

        while j < prev_count:
            pj = self.las[prev_idx + j]
            new_la, period_detected = _composite(p, la, pj)
            if period_detected or i >= period_end:
                la.step_length = i - period_begin
                la.next_stage_la_index = next_stage_la_index
                self.las.append(la)
                next_stage_la_index = j
                period_begin = i
                period_end = period_begin + period
                pjp1 = self.las[prev_idx + j + 1]
                if (_detect_period(p, new_la, pjp1.ref) or
                        j + 1 >= prev_count):
                    la = LANode(**vars(pj))
                else:
                    la, _ = _composite(p, pj, pjp1)
                    i += pj.step_length
                    j += 1
            else:
                la = new_la
            i += self.las[prev_idx + j].step_length
            j += 1

        la.step_length = i - period_begin
        la.next_stage_la_index = next_stage_la_index
        self.las.append(la)
        self.stage_macro_it_count[cur_stage] = (
            len(self.las) - self.stage_la_index[cur_stage])
        self.las.append(_new_node(p, gc(max_ref)))
        # another stage is worthwhile while this one is still big;
        # p.low_bound < 64 composes deeper (>= 2: composition needs a
        # real node pair, and the period==0 terminal branch emits the
        # final 1-node whole-orbit stage itself)
        return self.stage_macro_it_count[cur_stage] > max(p.low_bound, 1)

    def _create_at_from_la(self, radius_hd: HD, sub_is_f32: bool,
                           max_ref: int = 0) -> None:
        """CreateATFromLA (LAReference.cpp:1052-1074) — with one extra
        guard the reference's Usable test lacks: the AT node's window
        must cover (essentially) the WHOLE orbit.  The AT model
        iterates z' <- z'^2 + c', which is the renormalized dynamics
        only when the window is a full period; a sub-period window
        passes Usable at extreme depth (RefC at a dip is tiny) yet
        cannot model the per-window amplification of dc — measured on
        View #30: AT-on consumed the entire 200M budget on every pixel
        while the true first escapes are at ~0.46 x period."""
        sqr_radius = (radius_hd * radius_hd).reduce()
        for stage in range(self.stage_count - 1, -1, -1):
            idx = self.stage_la_index[stage]
            node = self.las[idx]
            if max_ref > 0 and node.step_length * 2 <= max_ref:
                continue       # sub-period window: model invalid
            at = _create_at(node, self.las[idx + 1], sub_is_f32)
            if at.step_length > 0 and _at_usable(at, sqr_radius):
                self.at = at
                self.use_at = True
                return
        self.use_at = False

    # ------------------------------------------------------- device form

    def device_arrays(self, dtype=np.float32) -> dict:
        """Flatten to (mantissa, exp) numpy arrays for device upload
        (the analogue of GPU_LAReference)."""
        n = len(self.las)

        def pack_c(get):
            m = np.zeros((n, 2), dtype)
            e = np.zeros(n, np.int32)
            for k, node in enumerate(self.las):
                z = get(node)
                m[k, 0] = z.m.real
                m[k, 1] = z.m.imag
                e[k] = z.e
            return m, e

        def pack_s(get):
            m = np.zeros(n, dtype)
            e = np.zeros(n, np.int32)
            for k, node in enumerate(self.las):
                v = get(node)
                m[k] = v.m
                e[k] = v.e
            return m, e

        ref_m, ref_e = pack_c(lambda x: x.ref)
        zc_m, zc_e = pack_c(lambda x: x.zcoeff)
        cc_m, cc_e = pack_c(lambda x: x.ccoeff)
        thr_m, thr_e = pack_s(lambda x: x.la_threshold)
        thrc_m, thrc_e = pack_s(lambda x: x.la_threshold_c)
        return {
            "ref_m": ref_m, "ref_e": ref_e,
            "zc_m": zc_m, "zc_e": zc_e,
            "cc_m": cc_m, "cc_e": cc_e,
            "thr_m": thr_m, "thr_e": thr_e,
            "thrc_m": thrc_m, "thrc_e": thrc_e,
            "step_length": np.asarray(
                [x.step_length for x in self.las], np.int64),
            # int64: stage-0 next indices are ORBIT POSITIONS — up to
            # the period (~28e9 at View #27 class, beyond int32)
            "next_stage_la_index": np.asarray(
                [x.next_stage_la_index for x in self.las], np.int64),
            "stage_la_index": np.asarray(self.stage_la_index, np.int32),
            "stage_macro_it_count": np.asarray(
                self.stage_macro_it_count, np.int32),
            "stage_count": self.stage_count,
        }


def get_or_build_la(fractal, results) -> LAReferenceHost | None:
    """Cache the LA table on the PerturbationResults it belongs to
    (the reference stores m_LaReference inside PerturbationResults).

    ``fractal.la_parameters`` (None = defaults) selects the build
    params; ``device_stage_window`` additionally windows the cached
    full table for the device (windowed table cached separately so
    repeated frames don't re-remap).  Each table is cached under the
    parameters that built it (all but the window, which applies after
    the build), so a render with other parameters builds its own; the
    reference keys its cache on nothing (``la_reference.py:601-603``)."""
    params = getattr(fractal, "la_parameters", None) or LAParameters()
    build = dataclasses.astuple(
        dataclasses.replace(params, device_stage_window=0))
    key = ("la_reference", build)
    la = results.extra.get(key)
    if la is None:
        la = LAReferenceHost.generate_auto(
            results.orbit_x, results.orbit_y,
            HD.from_hp(results.max_radius), params=params,
            orbit_e=results.orbit_e)
        results.extra[key] = la
    if not la.is_valid:
        return None
    k = int(params.device_stage_window or 0)
    if k > 0 and la.stage_count > k and hasattr(la, "stage_window"):
        key = ("la_reference_win", build, k)
        win = results.extra.get(key)
        if win is None:
            win = la.stage_window(k)
            results.extra[key] = win
        return win
    return la
