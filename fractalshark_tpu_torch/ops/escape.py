"""Plain (non-perturbed) escape time: the port of
``fractalshark_tpu/ops/escape.py`` (``escape_jax`` and the Pallas
``_escape_kernel``), through kernel K1 (``csrc/escape.cu``).

Two semantics, one per precision, each matching the reference route
that renders it:

* f32 (``Gpu1x32``, the reference's Pallas ``_escape_kernel``): pixels
  inside the main cardioid or the period-2 bulb are set to the budget
  up front; every other pixel counts steps while ``|z|² <= 4`` and the
  count is clamped to the budget.
* f64 (``Gpu1x64`` and ``Cpu64``, the reference's ``escape_jax``): the
  plain loop ``while i < N: if |z|² > 4: break; z = z² + c; i += 1``,
  with no interior shortcut.

Pixel coordinates: cx = min_x + x*dx, cy = max_y - y*dy in the working
type.  Grids are int64 tensors inside the port.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from fractalshark_tpu_torch.core.pointzoom import PointZoomBBConverter
from fractalshark_tpu_torch import kernels
from fractalshark_tpu_torch.ops.hdrfloat import ftz

_DTYPES = {"f32": torch.float32, "f64": torch.float64}


@dataclass(frozen=True)
class PlainParams:
    """Plain-render coordinates, derived once per render from the
    high-precision view."""
    min_x: float
    max_y: float
    dx: float
    dy: float

    @staticmethod
    def from_view(ptz: PointZoomBBConverter, width: int, height: int,
                  antialiasing: int = 1) -> "PlainParams":
        return PlainParams(
            min_x=float(ptz.min_x),
            max_y=float(ptz.max_y),
            dx=float(ptz.delta_x(width, antialiasing)),
            dy=float(ptz.delta_y(height, antialiasing)),
        )


def _coords(params: PlainParams, width: int, height: int, dtype, device):
    def s(v):
        return torch.tensor(v, dtype=dtype, device=device)

    xs = torch.arange(width, dtype=dtype, device=device)
    ys = torch.arange(height, dtype=dtype, device=device)
    cx = (s(params.min_x) + xs * s(params.dx))[None, :].expand(height, width)
    cy = (s(params.max_y) - ys * s(params.dy))[:, None].expand(height, width)
    return cx.contiguous(), cy.contiguous()


def escape_plain(params: PlainParams, width: int, height: int,
                 max_iter: int, dtype=torch.float64,
                 device="cpu") -> torch.Tensor:
    """Plain PyTorch twin of K1 (lockstep over the whole grid)."""
    f32 = dtype == torch.float32
    fl = ftz if f32 else (lambda t: t)
    cx, cy = _coords(params, width, height, dtype, device)
    if f32:
        cx, cy = fl(cx), fl(cy)
    it = torch.zeros((height, width), dtype=torch.int64, device=device)
    active = torch.ones((height, width), dtype=torch.bool, device=device)
    if f32:
        xq = fl(cx - 0.25)
        cy2 = fl(cy * cy)
        q = fl(fl(xq * xq) + cy2)
        cx1 = fl(cx + 1.0)
        interior = (fl(q * fl(q + xq)) <= fl(0.25 * cy2)) | \
            (fl(fl(cx1 * cx1) + cy2) <= 0.0625)
        it = torch.where(interior, max_iter, it)
        active &= ~interior
    zx, zy = cx.clone(), cy.clone()
    k = 0
    while k < max_iter:
        zx2 = fl(zx * zx)
        zy2 = fl(zy * zy)
        mag = fl(zx2 + zy2)
        cont = active & ((mag <= 4.0) if f32 else ~(mag > 4.0))
        if k % 64 == 0 and not bool(cont.any()):
            break
        nzy = fl(fl(fl(2.0 * zx) * zy) + cy)
        nzx = fl(fl(zx2 - zy2) + cx)
        zx = torch.where(cont, nzx, zx)
        zy = torch.where(cont, nzy, zy)
        it += cont.to(torch.int64)
        active = cont
        k += 1
    return it


def escape_kernel(params: PlainParams, width: int, height: int,
                  max_iter: int, dtype, device) -> torch.Tensor:
    """Launch K1 on a CUDA device."""
    out = torch.empty((height, width), dtype=torch.int64, device=device)
    name = "fs_escape_f32" if dtype == torch.float32 else "fs_escape_f64"
    lib = kernels.lib()
    kernels.launches["escape"] += 1
    kernels.check(getattr(lib, name)(
        out.data_ptr(), width, height, params.min_x, params.max_y,
        params.dx, params.dy, int(max_iter), kernels.stream(out.device)),
        name)
    return out


def escape(params: PlainParams, width: int, height: int, max_iter: int,
           dtype: str | torch.dtype = "f64", device="cuda") -> torch.Tensor:
    """Escape-time grid [height, width] (int64) on `device`: K1 on a
    CUDA device, the plain twin on the CPU."""
    dtype = _DTYPES.get(dtype, dtype)
    if dtype not in (torch.float32, torch.float64):
        raise ValueError(f"escape supports f32/f64, not {dtype}")
    device = torch.device(device)
    if device.type == "cuda":
        return escape_kernel(params, width, height, max_iter, dtype, device)
    if device.type != "cpu":
        raise ValueError(f"unsupported device {device}")
    return escape_plain(params, width, height, max_iter, dtype, device)
