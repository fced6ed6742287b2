"""Renormalizing quad-double / quad-float arithmetic (QD4) in PyTorch:
the port of ``fractalshark_tpu/ops/quadd.py`` (``QD``, ``renorm``,
``qd_add``/``qd_sub``/``qd_mul``/``qd_sqr``/``qd_mul_pow2``,
``qd_from_hp``, ``qd_to_f64``) and its escape render ``escape_qd``
through kernel K17 (``csrc/escape_quad.cu``).

A value is a four-term expansion q0 + q1 + q2 + q3 of f32 (4x32, ~92+
mantissa bits) or f64 (4x64, ~200+) components, kept canonical by two
branch-free quick-two-sum sweeps (Hida-Li-Bailey's "sloppy" add and
multiply).  The error-free transforms come from ``ops/dblflt.py``, so
every ``*`` and ``+`` rounds and flushes on its own, as the device twin
``csrc/quad.cuh`` does under ``-fmad=false``.

``escape_qd`` is the route of the ``Gpu4x32`` and ``Gpu4x64`` names
(JAX ``engine/fractal.py:189-195``): counts and budget int32 as in the
reference (a budget of 2^31 raises OverflowError), the grid int64 inside
the port and uint32 at the public boundary.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from fractalshark_tpu_torch import kernels
from fractalshark_tpu_torch.core.highprecision import HighPrecision
from fractalshark_tpu_torch.core.pointzoom import PointZoomBBConverter
from fractalshark_tpu_torch.ops import escape
from fractalshark_tpu_torch.ops.dblflt import quick_two_sum, two_prod, two_sum
from fractalshark_tpu_torch.ops.hdrfloat import flush_np, ftz
from fractalshark_tpu_torch.ops.tables import int32_budget

# variant: (torch type, numpy type) of the components
VARIANTS = {"4x32": (torch.float32, np.float32),
            "4x64": (torch.float64, np.float64)}


class QD(NamedTuple):
    q0: torch.Tensor
    q1: torch.Tensor
    q2: torch.Tensor
    q3: torch.Tensor


def _three_sum(a, b, c):
    """(s, e1, e2) with a+b+c = s+e1+e2."""
    t1, t2 = two_sum(a, b)
    s, t3 = two_sum(c, t1)
    e1, e2 = two_sum(t2, t3)
    return s, e1, e2


def _three_sum2(a, b, c):
    """(s, e) with a+b+c ≈ s+e."""
    t1, t2 = two_sum(a, b)
    s, t3 = two_sum(c, t1)
    return s, ftz(t2 + t3)


def renorm(c0, c1, c2, c3, c4=None) -> QD:
    """Two downward quick-two-sum sweeps: a canonical non-overlapping
    four-term expansion of the (possibly overlapping) terms."""
    if c4 is not None:
        c3, c4 = quick_two_sum(c3, c4)
        c2, c3 = quick_two_sum(c2, c3)
        c1, c2 = quick_two_sum(c1, c2)
        c0, c1 = quick_two_sum(c0, c1)
        c3 = ftz(c3 + c4)
    for _ in range(2):
        c2, c3 = quick_two_sum(c2, c3)
        c1, c2 = quick_two_sum(c1, c2)
        c0, c1 = quick_two_sum(c0, c1)
    return QD(c0, c1, c2, c3)


def qd_neg(x: QD) -> QD:
    return QD(-x.q0, -x.q1, -x.q2, -x.q3)


def qd_add(x: QD, y: QD) -> QD:
    """Hida-Li-Bailey 'sloppy' addition, then renorm."""
    s0, t0 = two_sum(x.q0, y.q0)
    s1, t1 = two_sum(x.q1, y.q1)
    s2, t2 = two_sum(x.q2, y.q2)
    s3, t3 = two_sum(x.q3, y.q3)
    s1, t0 = two_sum(s1, t0)
    s2, t0, t1 = _three_sum(s2, t0, t1)
    s3, t0 = _three_sum2(s3, t0, t2)
    t0 = ftz(ftz(t0 + t1) + t3)
    return renorm(s0, s1, s2, s3, t0)


def qd_sub(x: QD, y: QD) -> QD:
    return qd_add(x, qd_neg(y))


def qd_mul(x: QD, y: QD) -> QD:
    """'Sloppy' multiplication, exact through the O(ulp^3) terms."""
    p0, q0 = two_prod(x.q0, y.q0)
    p1, q1 = two_prod(x.q0, y.q1)
    p2, q2 = two_prod(x.q1, y.q0)
    p3, q3 = two_prod(x.q0, y.q2)
    p4, q4 = two_prod(x.q1, y.q1)
    p5, q5 = two_prod(x.q2, y.q0)
    p1, p2, q0 = _three_sum(p1, p2, q0)
    p2, q1, q2 = _three_sum(p2, q1, q2)
    p3, p4, p5 = _three_sum(p3, p4, p5)
    s0, t0 = two_sum(p2, p3)
    s1, t1 = two_sum(q1, p4)
    s2 = ftz(q2 + p5)
    s1, t0 = two_sum(s1, t0)
    s2 = ftz(s2 + ftz(t0 + t1))
    # the order-3 terms as plain products, summed left to right
    s1b = ftz(x.q0 * y.q3)
    for a, b in ((x.q1, y.q2), (x.q2, y.q1), (x.q3, y.q0)):
        s1b = ftz(s1b + ftz(a * b))
    for q in (q3, q4, q5):
        s1b = ftz(s1b + q)
    return renorm(p0, p1, s0, ftz(s1 + s1b), s2)


def qd_sqr(x: QD) -> QD:
    return qd_mul(x, x)


def qd_mul_pow2(x: QD, s) -> QD:
    return QD(*(ftz(q * s) for q in x))


def qd_to_f64(x: QD) -> torch.Tensor:
    out = ftz(x.q0.double() + x.q1.double())
    for q in (x.q2, x.q3):
        out = ftz(out + q.double())
    return out


def qd_from_hp(v: HighPrecision, dtype=np.float32) -> tuple:
    """Four non-overlapping numpy components of a high-precision value
    (host), as the reference splits it: each the nearest f64 of the
    remainder, rounded again to `dtype`, the remainder taken at
    max(256, v.prec) bits."""
    comps = []
    rem = v
    for _ in range(4):
        c = dtype(float(rem))
        comps.append(c)
        rem = rem - HighPrecision(float(c), prec=max(256, v.prec))
    return tuple(comps)


# --------------------------------------------------------- escape render


def qd_params(ptz: PointZoomBBConverter, width: int, height: int,
              variant: str = "4x32") -> list[float]:
    """The escape's 16 scalars (min_x, max_y, dx, dy, four components
    each: ``_escape_qd_impl``'s ``scal``) in the variant's type, flushed
    of subnormals as the reference reads them."""
    npdt = VARIANTS[variant][1]
    vals = [c for hp in (ptz.min_x, ptz.max_y, ptz.delta_x(width),
                         ptz.delta_y(height)) for c in qd_from_hp(hp, npdt)]
    return [float(v) for v in flush_np(np.asarray(vals, npdt))]


def escape_quad_plain(scal: list[float], width: int, height: int,
                      max_iter: int, dtype, device, arith) -> torch.Tensor:
    """The lockstep loop of ``_escape_qd_impl`` / ``_escape_qf_impl`` in
    the arithmetic `arith` (``(cls, add, sub, mul, sqr, mul_pow2,
    lead)``: a module's four-component type and ops, ``lead`` the
    magnitude's leading component): the int64 grid [height, width]."""
    max_iter = int32_budget(max_iter)
    cls, add, sub, mul, sqr, mul_pow2, lead = arith
    shape = (height, width)

    def full(v):
        return torch.full(shape, v, dtype=dtype, device=device)

    min_x, max_y, dx, dy = (cls(*(full(scal[4 * i + k]) for k in range(4)))
                            for i in range(4))
    zero = full(0.0)
    xs = torch.arange(width, dtype=dtype, device=device)[None, :]
    ys = torch.arange(height, dtype=dtype, device=device)[:, None]
    cx = add(min_x, mul(dx, cls(xs.expand(shape), zero, zero, zero)))
    cy = sub(max_y, mul(dy, cls(ys.expand(shape), zero, zero, zero)))
    zx, zy = cx, cy
    it = torch.zeros(shape, dtype=torch.int64, device=device)
    active = torch.ones(shape, dtype=torch.bool, device=device)
    k = 0
    while k < max_iter:
        zx2, zy2 = sqr(zx), sqr(zy)
        cont = active & ~(lead(add(zx2, zy2)) > 4.0)
        if k % 64 == 0 and not bool(cont.any()):
            break
        nzy = add(mul_pow2(mul(zx, zy), 2.0), cy)
        nzx = add(sub(zx2, zy2), cx)
        zx = cls(*(torch.where(cont, n, o) for n, o in zip(nzx, zx)))
        zy = cls(*(torch.where(cont, n, o) for n, o in zip(nzy, zy)))
        it += cont.to(torch.int64)
        active = cont
        k += 1
    return it


QD_ARITH = (QD, qd_add, qd_sub, qd_mul, qd_sqr, qd_mul_pow2,
            lambda q: q.q0)


def escape_qd_plain(scal: list[float], width: int, height: int,
                    max_iter: int, dtype=torch.float32,
                    device="cpu") -> torch.Tensor:
    """Plain PyTorch twin of K17: the int64 grid [height, width], every
    pixel in lockstep (``_escape_qd_impl``)."""
    return escape_quad_plain(scal, width, height, max_iter, dtype, device,
                             QD_ARITH)


def launch_quad(name: str, key: str, scal: list[float], width: int,
                height: int, max_iter: int, device) -> torch.Tensor:
    """One C call of K17 or K18 (both passes), counted under `key`."""
    return escape.launch_two_pass(
        name, key, width, height, device,
        list(scal) + [int32_budget(max_iter)], escape.LOOP_PASS1_CAP)


def escape_qd_kernel(scal: list[float], width: int, height: int,
                     max_iter: int, dtype, device) -> torch.Tensor:
    """Launch K17 on a CUDA device (one C call, both passes)."""
    f64 = dtype == torch.float64
    return launch_quad("fs_escape_qd_f64" if f64 else "fs_escape_qd_f32",
                       "escape_4x64" if f64 else "escape_4x32", scal,
                       width, height, max_iter, device)


def escape_qd(ptz: PointZoomBBConverter, width: int, height: int,
              max_iter: int, variant: str = "4x32",
              device="cuda") -> torch.Tensor:
    """Escape-time render on QD coordinates (the reference's GQF/GQD
    direct kernels), the int64 grid [height, width] on `device`: K17 on
    a CUDA device, the plain twin on the CPU."""
    dtype = VARIANTS[variant][0]
    device = kernels.resolve_device(device)
    scal = qd_params(ptz, width, height, variant)
    run = escape_qd_kernel if device.type == "cuda" else escape_qd_plain
    return run(scal, width, height, max_iter, dtype, device)
