"""Plain (non-perturbed) escape time: the port of
``fractalshark_tpu/ops/escape.py`` (``escape_jax``, the Pallas
``_escape_kernel`` and ``_escape_seq_kernel``), through kernels K1 and
K1-seq (``csrc/escape.cu``).

Two semantics, each matching the reference route that renders it:

* the tile (f32 ``Gpu1x32``, the reference's Pallas ``_escape_tile``;
  and every frame of a sequence, f32 or f64): pixels inside the main
  cardioid or the period-2 bulb are set to the budget up front; every
  other pixel counts steps while ``|z|² <= 4`` and the count is clamped
  to the budget; every result is flushed of subnormals, as XLA:CPU
  flushes the reference's f32 and f64 alike.
* f64 single frames (``Gpu1x64`` and ``Cpu64``, the reference's
  ``escape_jax``), and f32 single frames at budgets of 2^31 or more,
  which the reference also sends to ``escape_jax``
  (``engine/fractal.py:182-184``): the plain loop ``while i < N: if
  |z|² > 4: break; z = z² + c; i += 1``, with no interior shortcut (f32
  results flushed, as XLA:CPU flushes them).

A tile reads its budget from a table in the frame type, as the
reference's ``scalar_ref[4].astype(int32)`` does (``escape.py:216``):
an f32 budget of 2^24 + 1 runs as 2^24 (``seq_budget``).

Pixel coordinates: cx = min_x + x*dx, cy = max_y - (y0 + y)*dy in the
working type; y0 (default 0) is a band's first row in a taller image,
``escape_jax``'s row offset (``escape.py:120-128``), so that a band equals
those rows of the whole frame bit for bit (the tile farm's bands).
Single-frame grids are int64 tensors inside the port; a sequence is
int32 on the device and numpy uint32 [K, H, W] at its public entry
point, as the reference's.

Both kernels run a frame in two passes from one C call: pass 1 runs every
pixel for at most a cap of iterations and lists those still running,
pass 2 runs each listed pixel from its coordinate to the end
(``escape_two_pass_plain`` is that schedule in torch).  The list and its
counters are cached device scratch (``kernels.pass_list``).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
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


def _coords(params: PlainParams, width: int, height: int, dtype, device,
            fl=lambda t: t, y0: int = 0):
    def s(v):
        return torch.tensor(v, dtype=dtype, device=device)

    xs = torch.arange(width, dtype=dtype, device=device)
    ys = torch.arange(height, dtype=dtype, device=device) + y0
    cx = fl(s(params.min_x) + fl(xs * s(params.dx)))
    cy = fl(s(params.max_y) - fl(ys * s(params.dy)))
    return (cx[None, :].expand(height, width).contiguous(),
            cy[:, None].expand(height, width).contiguous())


def _pixel_coords(params: PlainParams, at: torch.Tensor, width: int, dtype,
                  fl, y0: int = 0):
    """The coordinates of the pixels at flat indices `at` (row-major over
    a frame `width` wide, its first row y0), from the frame's numbers
    alone."""
    def s(v):
        return torch.tensor(v, dtype=dtype, device=at.device)

    xs, ys = (at % width).to(dtype), (at // width + y0).to(dtype)
    return (fl(s(params.min_x) + fl(xs * s(params.dx))),
            fl(s(params.max_y) - fl(ys * s(params.dy))))


def _interior(cx: torch.Tensor, cy: torch.Tensor) -> torch.Tensor:
    """The tile's shortcut (``escape.py:166-178``): c in the main
    cardioid or the period-2 bulb, every result flushed."""
    xq = ftz(cx - 0.25)
    cy2 = ftz(cy * cy)
    q = ftz(ftz(xq * xq) + cy2)
    cx1 = ftz(cx + 1.0)
    return (ftz(q * ftz(q + xq)) <= ftz(0.25 * cy2)) | \
        (ftz(ftz(cx1 * cx1) + cy2) <= 0.0625)


def interior_mask(params: PlainParams, width: int, height: int, dtype,
                  device="cpu") -> torch.Tensor:
    """The pixels of a tile frame that the shortcut resolves without
    iterating, as the kernels test them (bool [height, width])."""
    return _interior(*_coords(params, width, height, dtype, device, ftz))


def tile_semantics(max_iter: int, dtype) -> bool:
    """Whether a single frame runs the reference's Pallas tile: f32 below
    a budget of 2^31 (``engine/fractal.py:182-184``)."""
    return dtype == torch.float32 and max_iter < (1 << 31)


def _flush(tile: bool, dtype):
    """The flush a frame's results pass through: the tile flushes, and
    f32 always (XLA:CPU); escape_jax's f64 loop does not."""
    return ftz if tile or dtype == torch.float32 else (lambda t: t)


def _lockstep(cx: torch.Tensor, cy: torch.Tensor, limit: int, tile: bool,
              fl) -> torch.Tensor:
    """The counts (int64) of the loop from z = c for at most `limit`
    iterations, every pixel of cx, cy in lockstep: the tile counts while
    |z|² <= 4, escape_jax's loop breaks once |z|² > 4."""
    it = torch.zeros(cx.shape, dtype=torch.int64, device=cx.device)
    active = torch.ones(cx.shape, dtype=torch.bool, device=cx.device)
    zx, zy = cx.clone(), cy.clone()
    k = 0
    while k < limit:
        zx2 = fl(zx * zx)
        zy2 = fl(zy * zy)
        mag = fl(zx2 + zy2)
        cont = active & ((mag <= 4.0) if tile else ~(mag > 4.0))
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


def escape_plain(params: PlainParams, width: int, height: int,
                 max_iter: int, dtype=torch.float64, device="cpu",
                 tile: bool | None = None, y0: int = 0) -> torch.Tensor:
    """Plain PyTorch twin of K1 (lockstep over the whole grid, its first
    row y0).  `tile` picks the reference's tile semantics (default:
    ``tile_semantics``), which run the budget in the frame type."""
    if tile is None:
        tile = tile_semantics(max_iter, dtype)
    if tile:
        max_iter = seq_budget(max_iter, dtype)
    fl = _flush(tile, dtype)
    cx, cy = _coords(params, width, height, dtype, device, fl, y0)
    if not tile:
        return _lockstep(cx, cy, max_iter, False, fl)
    interior = _interior(cx, cy)
    it = torch.full((height, width), max_iter, dtype=torch.int64,
                    device=device)
    it[~interior] = _lockstep(cx[~interior], cy[~interior], max_iter, True,
                              fl)
    return it


def escape_two_pass_plain(params: PlainParams, width: int, height: int,
                          max_iter: int, dtype=torch.float64, device="cpu",
                          cap: int | None = None,
                          shuffle: np.random.Generator | None = None,
                          y0: int = 0) -> torch.Tensor:
    """Plain twin of K1's schedule: pass 1 runs every pixel the shortcut
    leaves for at most `cap` iterations (default: the kernel's,
    ``pass1_cap``) and keeps each that ends there; the others form a list
    (in pass 1's order, or shuffled by `shuffle`) and pass 2 runs each
    listed pixel from its own coordinate to the budget.  Equals
    ``escape_plain`` for every cap and every order of the list."""
    tile = tile_semantics(max_iter, dtype)
    if tile:
        max_iter = seq_budget(max_iter, dtype)
    if cap is None:
        cap = pass1_cap(tile)
    fl = _flush(tile, dtype)
    cx, cy = (t.reshape(-1) for t in
              _coords(params, width, height, dtype, device, fl, y0))
    out = torch.full((width * height,), -1, dtype=torch.int64, device=device)
    rest = torch.arange(width * height, device=device)
    if tile:
        inside = _interior(cx, cy)
        out[inside] = max_iter
        rest = rest[~inside]
    limit = min(cap, max_iter)
    it = _lockstep(cx[rest], cy[rest], limit, tile, fl)
    done = (it < limit) | (it == max_iter)
    out[rest[done]] = it[done]
    later = rest[~done]
    if shuffle is not None:
        later = later[torch.from_numpy(shuffle.permutation(later.numel()))
                      .to(device)]
    lx, ly = _pixel_coords(params, later, width, dtype, fl, y0)
    out[later] = _lockstep(lx, ly, max_iter, tile, fl)
    return out.reshape(height, width)


# the iterations K1's pass 1 runs in the tile and in escape_jax's loop,
# each the fastest of those measured on View 0 1024² x 256 (H100, PERF.md
# §6: f32 16-96, f64 8-32; one pass of the f64 loop was slower); K1-seq's
# is the C side's kSeqCap
PASS1_CAP = 32
LOOP_PASS1_CAP = 16


def pass1_cap(tile: bool) -> int:
    """The iterations K1's pass 1 runs for a frame (from the budget up,
    one pass)."""
    return PASS1_CAP if tile else LOOP_PASS1_CAP


def launch_two_pass(name: str, key: str, width: int, height: int, device,
                    args, cap: int) -> torch.Tensor:
    """One C call of a two-pass escape kernel (K1, K13, K14, K17, K18),
    counted under `key`: ``name(out, width, height, *args, cap, list,
    counters, parity, stream)`` into a new int64 grid [height, width] on
    `device`, with the device's pass-2 list (``kernels.pass_list``)."""
    out = torch.empty((height, width), dtype=torch.int64, device=device)
    lst = kernels.pass_list(out.device)
    items, counters, parity = lst.take(out.numel())
    lib = kernels.lib()
    kernels.launches[key] += 1
    rc = getattr(lib, name)(
        out.data_ptr(), width, height, *args, cap, items.data_ptr(),
        counters.data_ptr(), parity, kernels.stream(out.device))
    if rc:
        lst.reset()
    kernels.check(rc, name)
    return out


def escape_kernel(params: PlainParams, width: int, height: int,
                  max_iter: int, dtype, device, y0: int = 0,
                  tile: bool | None = None) -> torch.Tensor:
    """Launch K1 on a CUDA device (one C call, both passes): the f32 tile
    below a budget of 2^31 (or as `tile` says), else ``escape_jax``'s loop
    in the frame type; the frame's first row is y0."""
    if tile is None:
        tile = tile_semantics(max_iter, dtype)
    if dtype == torch.float64:
        name = "fs_escape_f64"
    elif tile:
        name, max_iter = "fs_escape_f32", seq_budget(max_iter, dtype)
    else:
        name = "fs_escape_f32_loop"
    return launch_two_pass(
        name, "escape", width, height, device,
        (params.min_x, params.max_y, params.dx, params.dy, int(y0),
         int(max_iter)), pass1_cap(tile))


def escape(params: PlainParams, width: int, height: int, max_iter: int,
           dtype: str | torch.dtype = "f64", device="cuda", y0: int = 0,
           tile: bool | None = None) -> torch.Tensor:
    """Escape-time grid [height, width] (int64) on `device`, its first row
    y0 of a taller image: K1 on a CUDA device, the plain twin on the CPU.
    `tile`: the f32 tile's semantics (default: ``tile_semantics``) or, with
    False, ``escape_jax``'s loop, as the tile farm's f32 bands run."""
    dtype = _DTYPES.get(dtype, dtype)
    if dtype not in (torch.float32, torch.float64):
        raise ValueError(f"escape supports f32/f64, not {dtype}")
    if y0 < 0:
        raise ValueError(f"escape: y0 = {y0} < 0")
    if tile and dtype == torch.float64:
        raise ValueError("escape: a single f64 frame has no tile semantics")
    device = torch.device(device)
    if device.type == "cuda":
        return escape_kernel(params, width, height, max_iter, dtype, device,
                             y0, tile)
    if device.type != "cpu":
        raise ValueError(f"unsupported device {device}")
    return escape_plain(params, width, height, max_iter, dtype, device, tile,
                        y0)


# ------------------------------------------------------------- sequences


def _np_dtype(dtype):
    return np.float32 if dtype == torch.float32 else np.float64


def _seq_table(params_seq, max_iter: int, dtype, width: int = 1,
               height: int = 1) -> np.ndarray:
    """The reference's [K, 5] table (min_x, max_y, dx, dy, budget) in the
    frame type (``escape.py:322-327``, which refuses budgets of 2^31);
    1 to 65,535 frames (the kernel's grid z) of fewer than 2^32 pixels in
    all (its pass-2 list's indices)."""
    if max_iter >= (1 << 31):
        raise ValueError("escape_sequence supports max_iter < 2^31")
    if not 0 < len(params_seq) < (1 << 16):
        raise ValueError(f"escape_sequence renders 1 to 65,535 frames, not "
                         f"{len(params_seq)}")
    if len(params_seq) * width * height >= (1 << 32):
        raise ValueError("escape_sequence renders fewer than 2^32 pixels")
    return np.array([[p.min_x, p.max_y, p.dx, p.dy, float(max_iter)]
                     for p in params_seq], _np_dtype(dtype))


def seq_budget(max_iter: int, dtype) -> int:
    """The budget a frame of the sequence runs: the budget in the frame
    type, converted back to int32 as the reference's ``.astype(int32)``
    (f32: 2^24 + 1 reads as 2^24), saturating as the card's conversion."""
    return min(int(_np_dtype(dtype)(max_iter)), (1 << 31) - 1)


def escape_sequence_plain(params_seq, width: int, height: int,
                          max_iter: int, dtype=torch.float32,
                          device="cpu") -> torch.Tensor:
    """Plain twin of K1-seq: int32 [K, height, width], each frame
    ``_escape_tile``'s grid at the frame type's budget."""
    tab = _seq_table(params_seq, max_iter, dtype, width, height)
    n = seq_budget(max_iter, dtype)
    return torch.stack([
        escape_plain(PlainParams(*(float(v) for v in row[:4])), width,
                     height, n, dtype, device, tile=True)
        for row in tab]).to(torch.int32)


def escape_sequence_kernel(params_seq, width: int, height: int,
                           max_iter: int, dtype, device) -> torch.Tensor:
    """Launch K1-seq on a CUDA device: int32 [K, height, width]."""
    tab = torch.from_numpy(_seq_table(params_seq, max_iter, dtype, width,
                                      height)).to(device)
    frames = tab.shape[0]
    out = torch.empty((frames, height, width), dtype=torch.int32,
                      device=device)
    name = "fs_escape_seq_f32" if dtype == torch.float32 \
        else "fs_escape_seq_f64"
    lst = kernels.pass_list(out.device)
    items, counters, parity = lst.take(out.numel())
    lib = kernels.lib()
    kernels.launches["escape_seq"] += 1
    rc = getattr(lib, name)(
        out.data_ptr(), tab.data_ptr(), frames, width, height,
        items.data_ptr(), counters.data_ptr(), parity,
        kernels.stream(out.device))
    if rc:
        lst.reset()
    kernels.check(rc, name)
    return out


def escape_sequence(params_seq, width: int, height: int, max_iter: int,
                    dtype: str | torch.dtype = "f32",
                    device="cuda") -> np.ndarray:
    """A whole frame sequence (zoom animation, AA passes) in one launch,
    ``escape_pallas_sequence``'s counterpart: numpy uint32 [K, height,
    width].  K1-seq on a CUDA device, the plain twin on the CPU."""
    dtype = _DTYPES.get(dtype, dtype)
    if dtype not in (torch.float32, torch.float64):
        raise ValueError(f"escape_sequence supports f32/f64, not {dtype}")
    device = kernels.resolve_device(device)
    run = escape_sequence_kernel if device.type == "cuda" \
        else escape_sequence_plain
    out = run(list(params_seq), width, height, max_iter, dtype, device)
    return out.cpu().numpy().astype(np.uint32)


def zoom_sequence(p0: PlainParams, width: int, height: int, frames: int,
                  factor: float = 1.3) -> list[PlainParams]:
    """The frames of a zoom animation about the view centre, each
    `factor` times deeper than the last (the JAX bench's headline
    sequence, ``bench.py`` ``_headline``)."""
    cx = p0.min_x + p0.dx * width / 2
    cy = p0.max_y - p0.dy * height / 2
    out = []
    for k in range(frames):
        s = factor ** k
        out.append(PlainParams(min_x=cx - (cx - p0.min_x) / s,
                               max_y=cy + (p0.max_y - cy) / s,
                               dx=p0.dx / s, dy=p0.dy / s))
    return out
