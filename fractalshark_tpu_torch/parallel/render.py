"""Multi-device rendering with the pixel rows sharded over a mesh: the
port of ``fractalshark_tpu/parallel/render.py``.

The reference's pixel-grid parallelism (its CUDA grid,
``GPU_Render.h:116-120``) lifted to a ``torch.distributed`` mesh: rank r
of M renders rows [r·H/M, (r+1)·H/M) of the frame through the
single-device launch loops of the port, K1 (``ops/escape.py`` with the
row offset ``y0``) and K6 HDR (``ops/perturb.py`` ``perturb_run`` over
the slab's rows of the dc grids).  The per-pixel kernels need no tile
padding and no communication in their loops; the reference orbit is
replicated on every rank (each rank holds the results), and the
statistics reduce with ``all_reduce`` (``ReductionKernels.cuh``).  Each
function returns the rank's slab, the counterpart of the JAX package's
row-sharded array; ``gather_rows`` assembles the frame on every rank.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from fractalshark_tpu_torch.core.pointzoom import PointZoomBBConverter
from fractalshark_tpu_torch.ops import escape
from fractalshark_tpu_torch.ops import perturb
from fractalshark_tpu_torch.ops.hdrfloat import HDRComplex
from fractalshark_tpu_torch.ops.tables import orbit_on, torch_dtype
from fractalshark_tpu_torch.parallel import mesh as PM
from fractalshark_tpu_torch.parallel.mesh import Mesh

__all__ = ["make_mesh", "sharded_escape_render",
           "sharded_perturb_render_hdr", "sharded_stats", "gather_rows"]


def make_mesh(device, group=None) -> Mesh:
    """The calling rank's pixel mesh (``mesh.make_mesh``): one rank per
    device over ``group``, the default group when None."""
    return PM.make_mesh(device, group)


def slab(height: int, mesh: Mesh, even: bool = True) -> tuple[int, int]:
    """(first row, rows) of the rank's slab: H/M rows each, which needs M
    to divide H (``render.py:56-57``, ``:78-79``), or with ``even`` False
    ceil(H/M) rows each, the last slabs shorter or empty."""
    if even:
        if height % mesh.size:
            raise ValueError(f"height {height} not divisible by mesh size "
                             f"{mesh.size}")
        h = height // mesh.size
        return mesh.rank * h, h
    h = -(-height // mesh.size)
    y0 = min(mesh.rank * h, height)
    return y0, min(h, height - y0)


def gather_rows(part: torch.Tensor, height: int, mesh: Mesh) -> torch.Tensor:
    """The frame [height, W] on every rank from each rank's slab (``slab``
    with ``even`` False, or equal slabs): one ``all_gather`` of the slabs
    padded to ceil(H/M) rows."""
    h = -(-height // mesh.size)
    pad = torch.zeros((h,) + tuple(part.shape[1:]), dtype=part.dtype,
                      device=part.device)
    pad[:part.shape[0]] = part
    return PM.all_gather(mesh, pad).reshape((-1,) + tuple(
        part.shape[1:]))[:height]


def sharded_escape_render(params: escape.PlainParams, width: int,
                          height: int, max_iter: int, mesh: Mesh,
                          dtype=np.float64) -> torch.Tensor:
    """The plain escape render (``escape_jax``'s loop, f64 or f32) of the
    rank's rows: K1 with ``y0`` on the card, bit for bit the whole
    frame's rows.  Returns the rank's int64 slab [H/M, W]."""
    y0, h = slab(height, mesh)
    dt = "f32" if np.dtype(dtype) == np.float32 else "f64"
    return escape.escape(params, width, h, max_iter, dtype=dt,
                         device=mesh.device, y0=y0, tile=False)


def dc_slab(ref_x, ref_y, ptz: PointZoomBBConverter, width: int,
            height: int, y0: int, h: int, device,
            dtype=torch.float32) -> HDRComplex:
    """Rows [y0, y0 + h) of the frame's HDR dc grids about the reference
    point (ref_x, ref_y): the whole grid is made on the device (one
    elementwise pass) and cut, so a slab is those rows bit for bit."""
    dx, dy, cxo, cyo = perturb.delta_params(ptz, ref_x, ref_y, width,
                                            height)
    dc = perturb._dc_grids_hdr(dx, dy, cxo, cyo, width, height, device,
                               dtype)
    return HDRComplex(*(t[y0:y0 + h].contiguous() for t in dc))


def sharded_perturb_render_hdr(results, ptz: PointZoomBBConverter,
                               width: int, height: int, max_iter: int,
                               mesh: Mesh, sub_dtype=np.float32,
                               chunk_steps: int | None = None
                               ) -> torch.Tensor:
    """``perturb.perturb_render_hdr`` of the rank's rows (K6 HDR in
    launches over the slab's live pixels); height a multiple of M.
    Returns the rank's int64 slab [H/M, W]."""
    y0, h = slab(height, mesh)
    fdt = torch_dtype(sub_dtype)
    key = "perturb_hdr64" if fdt == torch.float64 else "perturb_hdr32"
    dc = dc_slab(results.center_x, results.center_y, ptz, width, height,
                 y0, h, mesh.device, fdt)
    return perturb.perturb_run(orbit_on(results, mesh.device, fdt), dc,
                               max_iter, results.max_ref_iteration(), True,
                               key, chunk_steps)


def sharded_stats(iters: torch.Tensor, mesh: Mesh) -> dict:
    """Min, max and the 64-bit sum of a row-sharded iteration buffer (each
    rank's slab) over the mesh, by ``all_reduce``, without gathering the
    frame.  The sum is the total mod 2^64, in [0, 2^64), as the JAX
    package's ``uint64`` sum gives it (``render.py:130``): int64 addition
    wraps, which is the same sum mod 2^64, read unsigned on the host."""
    t = iters.to(torch.int64)
    out = {}
    for name, v, op in (("min", t.min(), dist.ReduceOp.MIN),
                        ("max", t.max(), dist.ReduceOp.MAX),
                        ("sum", t.sum(), dist.ReduceOp.SUM)):
        out[name] = int(PM.all_reduce(mesh, v.reshape(1), op)[0])
    out["sum"] %= 1 << 64
    return out
