"""Plain escape time in HDR arithmetic (the CpuHDR32, CpuHDR64 and
GpuHDRx32 names): the port of ``fractalshark_tpu/ops/hdr_escape.py``
(``view_to_hdr_params``, ``hdr_escape_tile``, ``_escape_hdr_impl``,
``escape_hdr``) through kernel K13 (``csrc/escape_hdr.cu``).

The iteration of the f64 escape in HDRFloat operands, with the
reference's reduce points: the magnitude sum is reduced before the
escape compare (``|z|² > HDR(1, 2)``), each update after it.  Pixel
coordinates come exactly from the high-precision view through per-axis
(mantissa, exp2) splits, so a frame far past f64's range renders:
cx = reduce(min_x + reduce(x·dx_m, dx_e)), cy = reduce(max_y −
reduce(y·dy_m, dy_e)), the products in the mantissa type.

Counts and budget are int32 as in the reference (a budget of 2^31 raises
OverflowError there and here); the grid is int64 inside the port, uint32
at the public boundary (``engine/fractal.py`` ``public_dtype``).
"""

from __future__ import annotations

import numpy as np
import torch

from fractalshark_tpu_torch import kernels
from fractalshark_tpu_torch.core.pointzoom import PointZoomBBConverter
from fractalshark_tpu_torch.ops import escape
from fractalshark_tpu_torch.ops import hdrfloat as hdr
from fractalshark_tpu_torch.ops.hdrfloat import HDR
from fractalshark_tpu_torch.ops.tables import int32_budget, torch_dtype

_KEYS = ("min_x", "max_y", "dx", "dy")


def _hdr_scalar(hp_value, dtype):
    m, e = hp_value.mantissa_exp2()
    return np.asarray(m, dtype), np.int32(e)


def view_to_hdr_params(ptz: PointZoomBBConverter, width: int, height: int,
                       antialiasing: int = 1, dtype=np.float32) -> dict:
    """Exact HDR (mantissa, exp) splits of min_x, max_y, dx, dy."""
    return {
        "min_x": _hdr_scalar(ptz.min_x, dtype),
        "max_y": _hdr_scalar(ptz.max_y, dtype),
        "dx": _hdr_scalar(ptz.delta_x(width, antialiasing), dtype),
        "dy": _hdr_scalar(ptz.delta_y(height, antialiasing), dtype),
    }


def _coords(p: dict, width: int, height: int, dtype, device):
    """The pixels' c as HDR grids [height, width], op for op as the
    kernel computes each in its lane."""
    def full(key):
        m, e = p[key]
        return HDR(torch.full((height, width), float(m), dtype=dtype,
                              device=device),
                   torch.full((height, width), int(e), dtype=torch.int32,
                              device=device))

    def axis(n, key, shape):
        m, e = p[key]
        v = hdr.ftz(torch.arange(n, dtype=dtype, device=device) * float(m))
        return hdr.reduce(HDR(v.reshape(shape).expand(height, width),
                              torch.full((height, width), int(e),
                                         dtype=torch.int32, device=device)))

    cx = hdr.reduce(hdr.add(full("min_x"), axis(width, "dx", (1, width))))
    cy = hdr.reduce(hdr.sub(full("max_y"), axis(height, "dy", (height, 1))))
    return cx, cy


def escape_hdr_plain(p: dict, width: int, height: int, max_iter: int,
                     dtype=torch.float32, device="cpu") -> torch.Tensor:
    """Plain PyTorch twin of K13: the int64 grid [height, width], every
    pixel in lockstep (``hdr_escape_tile``)."""
    max_iter = int32_budget(max_iter)
    cx, cy = _coords(p, width, height, dtype, device)
    four = HDR(torch.ones_like(cx.m), torch.full_like(cx.e, 2))
    zx, zy = cx, cy
    it = torch.zeros(cx.m.shape, dtype=torch.int64, device=device)
    active = torch.ones(cx.m.shape, dtype=torch.bool, device=device)
    k = 0
    while k < max_iter:
        zx2, zy2 = hdr.square(zx), hdr.square(zy)
        mag = hdr.reduce(hdr.add(zx2, zy2))
        cont = active & ~hdr.gt_reduced(mag, four)
        if k % 64 == 0 and not bool(cont.any()):
            break
        nzy = hdr.reduce(hdr.add(hdr.mul_pow2(hdr.mul(zx, zy), 1), cy))
        nzx = hdr.reduce(hdr.add(hdr.sub(zx2, zy2), cx))
        zx = HDR(*(torch.where(cont, n, o) for n, o in zip(nzx, zx)))
        zy = HDR(*(torch.where(cont, n, o) for n, o in zip(nzy, zy)))
        it += cont.to(torch.int64)
        active = cont
        k += 1
    return it


def escape_hdr_kernel(p: dict, width: int, height: int, max_iter: int,
                      dtype, device) -> torch.Tensor:
    """Launch K13 on a CUDA device (one C call, both passes)."""
    f64 = dtype == torch.float64
    split = [v for key in _KEYS for v in (float(p[key][0]), int(p[key][1]))]
    return escape.launch_two_pass(
        "fs_escape_hdr_f64" if f64 else "fs_escape_hdr_f32",
        "escape_hdr64" if f64 else "escape_hdr32", width, height, device,
        split + [int32_budget(max_iter)], escape.LOOP_PASS1_CAP)


def escape_hdr(ptz: PointZoomBBConverter, width: int, height: int,
               max_iter: int, sub_dtype=np.float32,
               device="cuda") -> torch.Tensor:
    """The HDR escape grid [height, width] (int64) on `device`: K13 on a
    CUDA device, the plain twin on the CPU.  `width` and `height` are the
    render's (antialiased) dimensions; the view is split at antialiasing
    1, as the reference's entry point calls it."""
    dtype = torch_dtype(sub_dtype)
    device = kernels.resolve_device(device)
    p = view_to_hdr_params(ptz, width, height,
                           dtype=np.float32 if dtype == torch.float32
                           else np.float64)
    run = escape_hdr_kernel if device.type == "cuda" else escape_hdr_plain
    return run(p, width, height, max_iter, dtype, device)
