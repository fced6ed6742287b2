"""Compensated quad-float arithmetic (a pair of double-floats) in
PyTorch: the port of ``fractalshark_tpu/ops/quadflt.py`` (``QF``,
``_df_two_sum``, ``_renorm``, ``qf_add``/``qf_sub``/``qf_mul``/
``qf_sqr``/``qf_mul_pow2``, ``_df_two_prod``, ``qf_from_hp``,
``qf_to_f64``) and its escape render ``escape_qf`` through kernel K18
(``csrc/escape_quad.cu``).

value = A + B, each an unevaluated double-float sum (``ops/dblflt.py``)
of f32 (4x32) or f64 (4x64) components, |B| within about an ulp of A;
Knuth-style error recovery at the DF level gives ~76-100 effective
mantissa bits for 4x32.  Every ``*`` and ``+`` rounds and flushes on its
own, as the device twin ``csrc/quad.cuh`` does under ``-fmad=false``.

No algorithm name of the reference routes here (``Gpu4x32``/``Gpu4x64``
take ``ops/quadd.py``); ``escape_qf`` is a public function of the
reference all the same, and runs on the card like the others: counts
and budget int32, the grid int64 inside the port.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from fractalshark_tpu_torch import kernels
from fractalshark_tpu_torch.core.highprecision import HighPrecision
from fractalshark_tpu_torch.core.pointzoom import PointZoomBBConverter
from fractalshark_tpu_torch.ops.dblflt import (DF, df_add, df_mul,
                                               df_mul_pow2, df_sub, two_prod)
from fractalshark_tpu_torch.ops.hdrfloat import flush_np, ftz
from fractalshark_tpu_torch.ops.quadd import (VARIANTS, escape_quad_plain,
                                              launch_quad)


class QF(NamedTuple):
    """value = A + B, each an unevaluated DF sum."""
    a_hi: torch.Tensor
    a_lo: torch.Tensor
    b_hi: torch.Tensor
    b_lo: torch.Tensor

    @property
    def A(self) -> DF:
        return DF(self.a_hi, self.a_lo)

    @property
    def B(self) -> DF:
        return DF(self.b_hi, self.b_lo)


def _mk(A: DF, B: DF) -> QF:
    return QF(A.hi, A.lo, B.hi, B.lo)


def _df_two_sum(x: DF, y: DF) -> tuple[DF, DF]:
    """DF-level Knuth two-sum: s ≈ x + y, e the residual (exact up to the
    partials' DF rounding)."""
    s = df_add(x, y)
    bb = df_sub(s, x)
    e = df_add(df_sub(x, df_sub(s, bb)), df_sub(y, bb))
    return s, e


def _renorm(A: DF, B: DF) -> QF:
    s = df_add(A, B)
    e = df_add(df_sub(A, s), B)
    return _mk(s, e)


def qf_neg(x: QF) -> QF:
    return QF(-x.a_hi, -x.a_lo, -x.b_hi, -x.b_lo)


def qf_add(x: QF, y: QF) -> QF:
    s, e = _df_two_sum(x.A, y.A)
    e = df_add(e, df_add(x.B, y.B))
    return _renorm(s, e)


def qf_sub(x: QF, y: QF) -> QF:
    return qf_add(x, qf_neg(y))


def _df_two_prod(x: DF, y: DF) -> tuple[DF, DF]:
    """(p, e) with p + e ≈ x·y to about quad accuracy: the exact sum of
    the component products, accumulated with DF-level two-sums."""
    hh = DF(*two_prod(x.hi, y.hi))
    hl = DF(*two_prod(x.hi, y.lo))
    lh = DF(*two_prod(x.lo, y.hi))
    ll = DF(ftz(x.lo * y.lo), torch.zeros_like(x.lo))
    s, e = _df_two_sum(hh, df_add(hl, lh))
    s2, e2 = _df_two_sum(s, ll)
    return s2, df_add(e, e2)


def qf_mul(x: QF, y: QF) -> QF:
    p, e = _df_two_prod(x.A, y.A)
    e = df_add(e, df_add(df_mul(x.A, y.B), df_mul(x.B, y.A)))
    return _renorm(p, e)


def qf_sqr(x: QF) -> QF:
    p, e = _df_two_prod(x.A, x.A)
    e = df_add(e, df_mul_pow2(df_mul(x.A, x.B), 2.0))
    return _renorm(p, e)


def qf_mul_pow2(x: QF, s) -> QF:
    return QF(*(ftz(q * s) for q in x))


def qf_to_f64(x: QF) -> torch.Tensor:
    out = ftz(x.a_hi.double() + x.a_lo.double())
    for q in (x.b_hi, x.b_lo):
        out = ftz(out + q.double())
    return out


def qf_from_hp(v: HighPrecision, dtype=np.float32) -> tuple:
    """The reference's 4-way split of a high-precision value (host): each
    part the nearest f64 of the remainder rounded again to `dtype`, the
    remainder taken at v.prec bits."""
    f = np.dtype(dtype).type
    parts = []
    rem = v
    for _ in range(4):
        c = float(f(float(rem)))
        parts.append(c)
        rem = rem - HighPrecision(c, prec=v.prec)
    return tuple(parts)


# --------------------------------------------------------- escape render


def qf_params(ptz: PointZoomBBConverter, width: int, height: int,
              variant: str = "4x32") -> list[float]:
    """The escape's 16 scalars (``_escape_qf_impl``'s ``scal``) in the
    variant's type, flushed of subnormals as the reference reads them."""
    npdt = VARIANTS[variant][1]
    vals = [c for hp in (ptz.min_x, ptz.max_y, ptz.delta_x(width),
                         ptz.delta_y(height)) for c in qf_from_hp(hp, npdt)]
    return [float(v) for v in flush_np(np.asarray(vals, npdt))]


QF_ARITH = (QF, qf_add, qf_sub, qf_mul, qf_sqr, qf_mul_pow2,
            lambda q: q.a_hi)


def escape_qf_plain(scal: list[float], width: int, height: int,
                    max_iter: int, dtype=torch.float32,
                    device="cpu") -> torch.Tensor:
    """Plain PyTorch twin of K18: the int64 grid [height, width], every
    pixel in lockstep (``_escape_qf_impl``)."""
    return escape_quad_plain(scal, width, height, max_iter, dtype, device,
                             QF_ARITH)


def escape_qf_kernel(scal: list[float], width: int, height: int,
                     max_iter: int, dtype, device) -> torch.Tensor:
    """Launch K18 on a CUDA device (one C call, both passes)."""
    f64 = dtype == torch.float64
    return launch_quad("fs_escape_qf_f64" if f64 else "fs_escape_qf_f32",
                       "escape_qf64" if f64 else "escape_qf32", scal,
                       width, height, max_iter, device)


def escape_qf(ptz: PointZoomBBConverter, width: int, height: int,
              max_iter: int, variant: str = "4x32",
              device="cuda") -> torch.Tensor:
    """Escape-time render on compensated quad-float coordinates, the int64
    grid [height, width] on `device`: K18 on a CUDA device, the plain twin
    on the CPU."""
    dtype = VARIANTS[variant][0]
    device = kernels.resolve_device(device)
    scal = qf_params(ptz, width, height, variant)
    run = escape_qf_kernel if device.type == "cuda" else escape_qf_plain
    return run(scal, width, height, max_iter, dtype, device)
