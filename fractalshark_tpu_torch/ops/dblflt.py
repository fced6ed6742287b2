"""Double-float arithmetic in PyTorch: the port of
``fractalshark_tpu/ops/dblflt.py``, as (hi, lo) pairs of f32 (df32: the
RC tail's orbit reconstruction, and the ``Gpu2x32`` escape) or f64 (the
``Gpu2x64`` escape), and the double-float escape render ``escape_df``
through kernel K14 (``csrc/escape_df.cu``).

value = hi + lo.  The error-free transforms (Knuth two-sum, Dekker
two-prod by splitting) are exact only when every ``*`` and ``+`` rounds
on its own: a fused multiply-add changes ``split`` and ``two_prod``.
The plain ops here are separate tensor operations, and the device twin
``csrc/df32.cuh`` is built with ``-fmad=false`` for the same reason.
Results are flushed like every other plain op (see ``hdrfloat.ftz``).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from fractalshark_tpu_torch import kernels
from fractalshark_tpu_torch.core.highprecision import HighPrecision
from fractalshark_tpu_torch.core.pointzoom import PointZoomBBConverter
from fractalshark_tpu_torch.ops import escape
from fractalshark_tpu_torch.ops.hdrfloat import flush_np, ftz
from fractalshark_tpu_torch.ops.tables import int32_budget


class DF(NamedTuple):
    hi: torch.Tensor
    lo: torch.Tensor


def _split_const(dtype) -> float:
    # Dekker splitter 2^ceil(p/2) + 1
    return 4097.0 if dtype == torch.float32 else 134217729.0


def two_sum(a, b):
    s = ftz(a + b)
    bb = ftz(s - a)
    err = ftz(ftz(a - ftz(s - bb)) + ftz(b - bb))
    return s, err


def quick_two_sum(a, b):
    """Requires |a| >= |b| (or a == 0)."""
    s = ftz(a + b)
    return s, ftz(b - ftz(s - a))


def split(a):
    c = ftz(_split_const(a.dtype) * a)
    hi = ftz(c - ftz(c - a))
    return hi, ftz(a - hi)


def two_prod(a, b):
    p = ftz(a * b)
    ahi, alo = split(a)
    bhi, blo = split(b)
    err = ftz(ftz(ftz(ftz(ftz(ahi * bhi) - p) + ftz(ahi * blo))
                  + ftz(alo * bhi)) + ftz(alo * blo))
    return p, err


def df_zero(shape, dtype=torch.float32, device="cpu") -> DF:
    z = torch.zeros(shape, dtype=dtype, device=device)
    return DF(z, z.clone())


def df_from_float(x: torch.Tensor) -> DF:
    return DF(x, torch.zeros_like(x))


def df_neg(a: DF) -> DF:
    return DF(-a.hi, -a.lo)


def df_add(a: DF, b: DF) -> DF:
    s1, s2 = two_sum(a.hi, b.hi)
    t1, t2 = two_sum(a.lo, b.lo)
    s1, s2 = quick_two_sum(s1, ftz(s2 + t1))
    s1, s2 = quick_two_sum(s1, ftz(s2 + t2))
    return DF(s1, s2)


def df_sub(a: DF, b: DF) -> DF:
    return df_add(a, df_neg(b))


def df_mul(a: DF, b: DF) -> DF:
    p1, p2 = two_prod(a.hi, b.hi)
    p2 = ftz(ftz(p2 + ftz(a.hi * b.lo)) + ftz(a.lo * b.hi))
    return DF(*quick_two_sum(p1, p2))


def df_sqr(a: DF) -> DF:
    p1, p2 = two_prod(a.hi, a.hi)
    p2 = ftz(p2 + ftz(ftz(2.0 * a.hi) * a.lo))
    return DF(*quick_two_sum(p1, p2))


def df_mul_float(a: DF, s) -> DF:
    """a times a plain float (a tensor of a's type, or a scalar)."""
    p1, p2 = two_prod(a.hi, s)
    p2 = ftz(p2 + ftz(a.lo * s))
    return DF(*quick_two_sum(p1, p2))


def df_mul_pow2(a: DF, s: float) -> DF:
    """Multiply by an exact power of two."""
    return DF(ftz(a.hi * s), ftz(a.lo * s))


def df_gt_float(a: DF, thresh: float) -> torch.Tensor:
    return (a.hi > thresh) | ((a.hi == thresh) & (a.lo > 0))


def df_to_float(a: DF) -> torch.Tensor:
    return ftz(a.hi + a.lo)


def df_from_hp(x: HighPrecision, dtype=np.float32) -> tuple[float, float]:
    """Exact (hi, lo) split of a HighPrecision value on host."""
    f = np.dtype(dtype).type
    hi = f(float(x))
    lo = f(float(x - HighPrecision(float(hi), prec=x.prec)))
    return float(hi), float(lo)


# --------------------------------------------------------- escape render

_VARIANTS = {"2x32": (torch.float32, np.float32),
             "2x64": (torch.float64, np.float64)}


def df_params(params_or_ptz, width: int, height: int,
              variant: str = "2x32") -> list[float]:
    """The escape's eight scalars (min_x, max_y, dx, dy as (hi, lo)
    pairs, ``_escape_df_impl``'s ``scal``) in the variant's type, flushed:
    exact splits of the high-precision view, or the splits of a
    ``PlainParams``' floats."""
    npdt = _VARIANTS[variant][1]
    if isinstance(params_or_ptz, PointZoomBBConverter):
        ptz = params_or_ptz
        vals = [v for hp in (ptz.min_x, ptz.max_y, ptz.delta_x(width),
                             ptz.delta_y(height))
                for v in df_from_hp(hp, npdt)]
    else:
        p = params_or_ptz
        vals = []
        for v in (p.min_x, p.max_y, p.dx, p.dy):
            hi = npdt(v)
            vals += [float(hi), float(npdt(v - float(hi)))]
    return [float(v) for v in flush_np(np.asarray(vals, npdt))]


def escape_df_plain(scal: list[float], width: int, height: int,
                    max_iter: int, dtype=torch.float32,
                    device="cpu") -> torch.Tensor:
    """Plain PyTorch twin of K14: the int64 grid [height, width], every
    pixel in lockstep (``_escape_df_impl``)."""
    max_iter = int32_budget(max_iter)
    shape = (height, width)

    def full(v):
        return torch.full(shape, v, dtype=dtype, device=device)

    min_x, max_y, dx, dy = (DF(full(scal[2 * i]), full(scal[2 * i + 1]))
                            for i in range(4))
    xs = torch.arange(width, dtype=dtype, device=device)[None, :]
    ys = torch.arange(height, dtype=dtype, device=device)[:, None]
    cx = df_add(min_x, df_mul_float(dx, xs.expand(shape)))
    cy = df_sub(max_y, df_mul_float(dy, ys.expand(shape)))
    zx, zy = cx, cy
    it = torch.zeros(shape, dtype=torch.int64, device=device)
    active = torch.ones(shape, dtype=torch.bool, device=device)
    k = 0
    while k < max_iter:
        zx2, zy2 = df_sqr(zx), df_sqr(zy)
        cont = active & ~(df_add(zx2, zy2).hi > 4.0)
        if k % 64 == 0 and not bool(cont.any()):
            break
        nzy = df_add(df_mul_pow2(df_mul(zx, zy), 2.0), cy)
        nzx = df_add(df_sub(zx2, zy2), cx)
        zx = DF(*(torch.where(cont, n, o) for n, o in zip(nzx, zx)))
        zy = DF(*(torch.where(cont, n, o) for n, o in zip(nzy, zy)))
        it += cont.to(torch.int64)
        active = cont
        k += 1
    return it


def escape_df_kernel(scal: list[float], width: int, height: int,
                     max_iter: int, dtype, device) -> torch.Tensor:
    """Launch K14 on a CUDA device (one C call, both passes)."""
    f64 = dtype == torch.float64
    return escape.launch_two_pass(
        "fs_escape_df_f64" if f64 else "fs_escape_df_f32",
        "escape_2x64" if f64 else "escape_2x32", width, height, device,
        list(scal) + [int32_budget(max_iter)], escape.LOOP_PASS1_CAP)


def escape_df(params_or_ptz, width: int, height: int, max_iter: int,
              variant: str = "2x32", device="cuda") -> torch.Tensor:
    """Plain escape render in double-float arithmetic, the int64 grid
    [height, width] on `device`: K14 on a CUDA device, the plain twin on
    the CPU.  `variant` "2x32" (f32 pairs, ~48-bit) or "2x64" (f64
    pairs, ~106-bit); `params_or_ptz` the high-precision view (exact
    splits) or an ``escape.PlainParams``."""
    if variant in ("4x32", "4x64"):
        raise NotImplementedError(
            f"quad-float variant {variant}: ROADMAP A1 (ops/quadd.py "
            f"escape_qd), not ported yet")
    dtype = _VARIANTS[variant][0]
    device = kernels.resolve_device(device)
    scal = df_params(params_or_ptz, width, height, variant)
    run = escape_df_kernel if device.type == "cuda" else escape_df_plain
    return run(scal, width, height, max_iter, dtype, device)
