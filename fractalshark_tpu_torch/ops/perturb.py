"""Pixel-delta (dc) grids for the perturbation kernels: the port of
``delta_params`` and ``_dc_grids_hdr`` (``fractalshark_tpu/ops/perturb.py:43-110``).

Pixel deltas: dc = (dx·x - centerX, -dy·y - centerY) with
centerX = refX - minX, centerY = refY - maxY (``Fractal.cpp:2235-2237``).
"""

from __future__ import annotations

import numpy as np
import torch

from fractalshark_tpu_torch.core.highprecision import HighPrecision
from fractalshark_tpu_torch.core.pointzoom import PointZoomBBConverter
from fractalshark_tpu_torch.ops import hdrfloat as hdr
from fractalshark_tpu_torch.ops.hdrfloat import HDR, HDRComplex


def delta_params(ptz: PointZoomBBConverter, ref_x: HighPrecision,
                 ref_y: HighPrecision, width: int, height: int):
    """High-precision dx, dy, centerX, centerY for the delta grid."""
    dx = (ptz.max_x - ptz.min_x) / HighPrecision(width)
    dy = (ptz.max_y - ptz.min_y) / HighPrecision(height)
    return dx, dy, ref_x - ptz.min_x, ref_y - ptz.max_y


def _dc_grids_hdr(dx, dy, cx_off, cy_off, width: int, height: int,
                  device) -> HDRComplex:
    """dc grids as an HDRComplex with f32 mantissas (shared exponent),
    exact at any zoom.  Built on `device` with the plain HDR ops: this
    is a one-off elementwise pass per frame."""
    def hp(v):
        m, e = v.mantissa_exp2()
        return float(np.float32(m)), int(np.int32(e))

    (dxm, dxe), (dym, dye) = hp(dx), hp(dy)
    (cxm, cxe), (cym, cye) = hp(cx_off), hp(cy_off)
    shape = (height, width)
    f32 = dict(dtype=torch.float32, device=device)
    i32 = dict(dtype=torch.int32, device=device)
    xs = torch.arange(width, **f32)
    ys = torch.arange(height, **f32)
    x_dx = HDR(hdr.ftz(xs[None, :] * dxm).expand(shape),
               torch.full(shape, dxe, **i32))
    y_dy = HDR(hdr.ftz(ys[:, None] * dym).expand(shape),
               torch.full(shape, dye, **i32))
    cx_h = HDR(torch.full(shape, cxm, **f32), torch.full(shape, cxe, **i32))
    cy_h = HDR(torch.full(shape, cym, **f32), torch.full(shape, cye, **i32))
    dcx = hdr.reduce(hdr.sub(hdr.reduce(x_dx), cx_h))
    dcy = hdr.reduce(hdr.sub(hdr.negate(hdr.reduce(y_dy)), cy_h))
    dc = hdr.complex_from_hdr(dcx, dcy)
    return HDRComplex(*(t.contiguous() for t in dc))
