"""Imagina ``.im`` orbit file format (Sharks variant).

Byte-compatible rebuild of the reference's Imagina-derived format
(``FractalSharkLib/ImaginaOrbit.h``, writer
``PerturbationResults.cpp:2013-2090 SaveOrbitBin``, reader
``RefOrbitCalc.cpp:3440-3520`` + ``LoadOrbitBin``):

    IMFileHeader { u64 Magic; u64 Reserved; u64 LocationOffset;
                   u64 ReferenceOffset; }
    @LocationOffset:
        HRReal halfH            (f64 mantissa, i64 exp2 — view half-height)
        u64 iterationLimit
        mpf orbitX, orbitY      (GMP raw stream: i64 limb-exponent,
                                 i32 big-endian byte count (sign carries
                                 the value's sign), big-endian magnitude
                                 bytes; value = Z·(2^64)^(exp−limbs))
    @ReferenceOffset:
        ReferenceHeader { bool ExtendedRange }  (1 byte)
        ReferenceTrivialContent { HRReal AbsolutePrecision,
                                  RelativePrecision, ValidRadius }
        LAReferenceTrivialContent (trivially-copied struct; see below)
        u64 compressedSize
        entries ×compressedSize: {f64 x, f64 y} (ExtendedRange=0) or
            {f64 xm, i64 xe, f64 ym, i64 ye} HRReal pairs
            (ExtendedRange=1 — deep orbits with sub-f64 dips)
                                 or {HRReal x, HRReal y} (=1),
                                 each followed by u64 compression-index
                                 field (low 63 bits index, high bit rebase)
        u64 rebaseCount; u64 rebases[]

Magic numbers: IMMagicNumber 0x000A0D56504D49FF (plain Imagina),
SharksMagicNumber 0x536861726b733a29 ("Sharks:)").
"""

from __future__ import annotations

import struct
from dataclasses import dataclass

import numpy as np

from fractalshark_tpu_torch.core.highprecision import HighPrecision
from fractalshark_tpu_torch.core.hdr_host import HD
from fractalshark_tpu_torch.engine.perturbation_results import (
    CompressedOrbit, PerturbationResults)

IM_MAGIC = 0x000A0D56504D49FF
SHARKS_MAGIC = 0x536861726B733A29

# LAReferenceTrivialContent layout (ImaginaOrbit.h:44-57):
#   complex<double> Refc (16) | u64 RefIt | u64 MaxIt |
#   4 bools + 4 pad (8) | ImaginaATInfo (u64 StepLength, HRReal
#   ThresholdC, f64 SqrEscapeRadius, complex<f64> RefC, 3×complex<HRReal>)
#   | u64 LAStageCount
_AT_FMT = "<Q d q d d d 6d 6q"  # not used directly; see _la_content_size


def _write_hrreal(buf: bytearray, hd: HD) -> None:
    buf += struct.pack("<dq", hd.m, hd.e)


def _read_hrreal(b: bytes, off: int) -> tuple[HD, int]:
    m, e = struct.unpack_from("<dq", b, off)
    return HD(m, int(e)), off + 16


def _write_mpf(buf: bytearray, x: HighPrecision) -> None:
    """GMP raw-stream serialization (MpirSerialization.cpp:157-170)."""
    if x.is_zero():
        buf += struct.pack("<q", 0)
        buf += struct.pack(">i", 0)
        return
    mant, e2 = x.mant, x.exp
    r = e2 % 64
    z = abs(mant) << r
    e_base = e2 - r                     # divisible by 64
    nbytes = (z.bit_length() + 7) // 8
    nlimbs = (nbytes + 7) // 8
    expt = e_base // 64 + nlimbs
    buf += struct.pack("<q", expt)
    raw = z.to_bytes(nbytes, "big")
    count = nbytes if mant > 0 else -nbytes
    buf += struct.pack(">i", count)
    buf += raw


def _read_mpf(b: bytes, off: int, prec: int) -> tuple[HighPrecision, int]:
    (expt,) = struct.unpack_from("<q", b, off)
    off += 8
    (count,) = struct.unpack_from(">i", b, off)
    off += 4
    if count == 0:
        return HighPrecision(0, prec=prec), off
    nbytes = abs(count)
    z = int.from_bytes(b[off:off + nbytes], "big")
    off += nbytes
    nlimbs = (nbytes + 7) // 8
    val_exp = 64 * (expt - nlimbs)
    if count < 0:
        z = -z
    # never lose serialized bits to the caller's precision estimate
    prec = max(prec, z.bit_length() + 16)
    return HighPrecision.from_mant_exp(z, val_exp, prec=prec), off


def _la_trivial_content(refc: complex, ref_it: int, max_it: int,
                        is_periodic: bool) -> bytes:
    """LAReferenceTrivialContent with zeroed AT (the reference also
    leaves AT/LAStageCount zero on save, PerturbationResults.cpp:2030)."""
    out = bytearray()
    out += struct.pack("<dd", refc.real, refc.imag)
    out += struct.pack("<QQ", ref_it, max_it)
    out += struct.pack("<????4x", False, False, bool(is_periodic), False)
    # ImaginaATInfo: u64 StepLength, HRReal ThresholdC, f64 SqrEscape,
    # complex<f64> RefC, complex<HRReal> ZCoeff, CCoeff, InvZCoeff
    out += struct.pack("<Q", 0)
    out += struct.pack("<dq", 0.0, 0)
    out += struct.pack("<d", 0.0)
    out += struct.pack("<dd", 0.0, 0.0)
    for _ in range(3):
        out += struct.pack("<dqdq", 0.0, 0, 0.0, 0)
    out += struct.pack("<Q", 0)
    return bytes(out)


_LA_CONTENT_SIZE = len(_la_trivial_content(0j, 0, 0, False))


def save_orbit_im(path: str, results: PerturbationResults,
                  comp: CompressedOrbit | None = None,
                  magic: int = SHARKS_MAGIC,
                  extended: bool | None = None) -> None:
    """Write a .im orbit file (SimpleCompression payload).

    extended=None (auto): the ExtendedRange payload (HRReal (m, e)
    entry pairs, Imagina's deep-orbit format) is chosen whenever the
    orbit carries HDR exponents — sub-f64 near-period dips
    (|Z| ~ minibrot scale, e.g. 2^-380k on View #30) are UNREPRESENTABLE
    as plain f64 anchors and would export as 0.0
    (``PeriodicityChecker.h:32-33`` stores HDRFloat per entry)."""
    if comp is None:
        comp = results.compress(results.compression_error_exp or 20)
    half_h = HD.from_hp(results.max_radius)
    if extended is None:
        extended = bool(results.orbit_e is not None and
                        np.any(results.orbit_e != 0))

    buf = bytearray(32)  # header placeholder
    loc_off = len(buf)
    _write_hrreal(buf, half_h)
    # iterationLimit = budget - 1: the reference writes
    # GetMaxIterations() - 1 (RefOrbitCalc.cpp:3083); load_orbit_im
    # adds the 1 back so a round trip is lossless.
    buf += struct.pack("<Q", max(0, results.max_iterations - 1))
    _write_mpf(buf, results.center_x)
    _write_mpf(buf, results.center_y)

    ref_off = len(buf)
    buf += struct.pack("<?", bool(extended))
    # AbsolutePrecision = 2·2^-precBits — the reference writes
    # HRReal{-precBits, 2} (PerturbationResults.cpp SaveOrbitBin)
    prec = HD(2.0, -int(results.precision_bits))
    _write_hrreal(buf, prec)    # AbsolutePrecision
    _write_hrreal(buf, HD.zero())  # RelativePrecision (unused)
    _write_hrreal(buf, half_h)  # ValidRadius
    refc = complex(float(results.center_x), float(results.center_y))
    buf += _la_trivial_content(
        refc, results.count_orbit_entries() - 1,
        max(0, results.max_iterations - 2), results.period != 0)
    m = len(comp.anchors_x)
    buf += struct.pack("<Q", m)
    oe = results.orbit_e
    for i in range(m):
        idx = int(comp.anchor_index[i]) & ((1 << 63) - 1)
        if extended:
            # the (mantissa, shared-exp) forms live on the results
            # orbit arrays; anchors_x/y are their (possibly
            # underflowed) f64 collapse
            if oe is not None and idx < len(results.orbit_x):
                xm = float(results.orbit_x[idx])
                ym = float(results.orbit_y[idx])
                e = int(oe[idx])
            else:
                xm = float(comp.anchors_x[i])
                ym = float(comp.anchors_y[i])
                e = 0
            buf += struct.pack("<dqdq", xm, e, ym, e)
        else:
            buf += struct.pack("<dd", float(comp.anchors_x[i]),
                               float(comp.anchors_y[i]))
        buf += struct.pack("<Q", idx)
    buf += struct.pack("<Q", 0)  # no rebases (SimpleCompression)

    struct.pack_into("<QQQQ", buf, 0, magic, 0, loc_off, ref_off)
    with open(path, "wb") as f:
        f.write(bytes(buf))


@dataclass
class ImOrbitFile:
    center_x: HighPrecision
    center_y: HighPrecision
    half_h: HD
    iteration_limit: int
    results: PerturbationResults | None   # None if location-only
    magic: int


@dataclass
class OrbitParameterPack:
    """Everything a loaded orbit implies about how to render it — the
    reference's OrbitParameterPack + RecommendedSettings bundle
    (RefOrbitCalc.cpp:3483): the adopted view, iteration budget/type,
    and the re-derived render algorithm for the orbit's depth."""
    file: ImOrbitFile

    @property
    def zoom_exp2(self) -> int:
        return max(0, -int(self.file.half_h.e))

    @property
    def iter_type_bits(self) -> int:
        """IterTypeEnum analogue: 64 when the budget needs it."""
        return 64 if self.file.iteration_limit >= (1 << 31) else 32

    def recommended_algorithm(self, has_accelerator: bool = True):
        """Algorithm for the loaded orbit's depth (RecommendedSettings
        re-derivation)."""
        from fractalshark_tpu_torch.core.algorithms import auto_select
        return auto_select(self.zoom_exp2,
                           has_accelerator=has_accelerator)

    def view(self):
        from fractalshark_tpu_torch.core.pointzoom import PointZoomBBConverter
        half = self.file.half_h
        zoom = (HighPrecision(2) /
                HighPrecision.from_mant_exp(
                    int(half.m * (1 << 52)), half.e - 52,
                    prec=max(64, -half.e + 128)))
        return PointZoomBBConverter(pt_x=self.file.center_x,
                                    pt_y=self.file.center_y,
                                    zoom_factor=zoom)


def load_orbit_im(path: str) -> ImOrbitFile:
    with open(path, "rb") as f:
        b = f.read()
    magic, _, loc_off, ref_off = struct.unpack_from("<QQQQ", b, 0)
    if magic not in (IM_MAGIC, SHARKS_MAGIC):
        raise ValueError(f"not an Imagina orbit file: magic {magic:#x}")
    off = loc_off
    half_h, off = _read_hrreal(b, off)
    (iter_limit,) = struct.unpack_from("<Q", b, off)
    off += 8
    prec = max(64, -min(0, half_h.e) + 120)
    cx, off = _read_mpf(b, off, prec)
    cy, off = _read_mpf(b, off, prec)

    results = None
    if ref_off:
        off = ref_off
        (extended,) = struct.unpack_from("<?", b, off)
        off += 1
        _, off = _read_hrreal(b, off)  # AbsolutePrecision
        _, off = _read_hrreal(b, off)  # RelativePrecision
        _, off = _read_hrreal(b, off)  # ValidRadius
        la = b[off:off + _LA_CONTENT_SIZE]
        off += _LA_CONTENT_SIZE
        ref_it, max_it = struct.unpack_from("<QQ", la, 16)
        is_periodic = struct.unpack_from("<?", la, 34)[0]
        (count,) = struct.unpack_from("<Q", b, off)
        off += 8
        ax = np.zeros(count, np.float64)
        ay = np.zeros(count, np.float64)
        ai = np.zeros(count, np.int64)
        hdr_anchors = []  # (index, m_x, m_y, shared_e) sub-f64 dips
        for i in range(count):
            if extended:
                xm, xe = struct.unpack_from("<dq", b, off)
                off += 16
                ym, ye = struct.unpack_from("<dq", b, off)
                off += 16
                ax[i] = np.ldexp(xm, int(np.clip(xe, -2000, 2000)))
                ay[i] = np.ldexp(ym, int(np.clip(ye, -2000, 2000)))
                # value representable only as (m, e): keep the
                # shared-exponent HDR form (same policy as
                # ops/bignum/orbit.py's dip emission)
                dip = (xm != 0.0 and ax[i] == 0.0) or \
                    (ym != 0.0 and ay[i] == 0.0)
                if dip:
                    e_sh = max(xe if xm != 0.0 else ye,
                               ye if ym != 0.0 else xe)
                    hdr_anchors.append(
                        (i, np.ldexp(xm, int(max(xe - e_sh, -2000))),
                         np.ldexp(ym, int(max(ye - e_sh, -2000))),
                         int(e_sh)))
            else:
                ax[i], ay[i] = struct.unpack_from("<dd", b, off)
                off += 16
            (cidx,) = struct.unpack_from("<Q", b, off)
            off += 8
            ai[i] = cidx & ((1 << 63) - 1)
        (n_rebases,) = struct.unpack_from("<Q", b, off)
        off += 8 + 8 * n_rebases

        total = int(ref_it) + 1
        comp = CompressedOrbit(
            anchors_x=ax, anchors_y=ay, anchor_index=ai,
            total_count=total, cx_low=float(cx), cy_low=float(cy),
            error_exp=20)
        ox, oy = comp.decompress()
        oe = None
        if hdr_anchors:
            # re-inject the HDR dip entries into the decompressed
            # orbit: (mantissa, exp) at their uncompressed indices
            oe = np.zeros(len(ox), np.int32)
            for (i, mx, my, e_sh) in hdr_anchors:
                idx = int(ai[i])
                if 0 <= idx < len(ox):
                    ox[idx] = mx
                    oy[idx] = my
                    oe[idx] = e_sh
        radius = HighPrecision.from_mant_exp(
            int(half_h.m * (1 << 52)), half_h.e - 52, prec=64)
        results = PerturbationResults(
            center_x=cx, center_y=cy, orbit_x=ox, orbit_y=oy,
            max_radius=radius,
            period=(int(ref_it) + 1) if is_periodic else 0,
            escaped_at=0, max_iterations=int(iter_limit) + 1,
            precision_bits=prec, orbit_e=oe)
    # stored iterationLimit = budget - 1 (RefOrbitCalc.cpp:3083); both
    # consumers below want the reconstructed budget
    return ImOrbitFile(center_x=cx, center_y=cy, half_h=half_h,
                       iteration_limit=int(iter_limit) + 1,
                       results=results, magic=magic)
