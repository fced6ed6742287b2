"""The streaming perturbation renders: the port of
``fractalshark_tpu/ops/perturb_stream.py``.

``perturb_render_stream`` (B11, ``_kernel``) is the HDR-f32
perturbation render for orbits of any length and 64-bit budgets; on the
card it is kernel K6 (``ops/perturb.py``, ``csrc/perturb.cu``), which
gathers each pixel's orbit row itself where the reference sweeps the
orbit in lockstep windows.  Its contract stays: no orbit-length cap,
64-bit budgets (int64 counters here; ``Fractal.iters_numpy`` gives
uint64 from a budget of 2^31 up, ``perturb_stream.py:100-109``), bounded
relaunches (``launch_windows`` windows of 1,024 steps per pixel per
launch) and an abort check between launches.

The rest is the RC part (``_rc_kernel``, B3) through kernel K3
(``csrc/rc_tail.cu``), over a real compressed orbit.  (The reference
also runs B3 over identity anchors as the two-phase tail of an
uncompressed orbit; there the port runs K6 resumed from the handoff,
``engine/renderers.py``.)

The reference sweeps one serial reconstruction cursor over the orbit
in lockstep for a whole pixel tile (the TPU has no vector gather).  On
a GPU each pixel carries its own cursor instead, in the design of the
reference's gather tail ``ops/rc_tail.py`` (df32 mode), which its tests
pin bit-identical to the sweep:

1. the handoff (``_rc_init_from_handoff``, ``perturb_stream.py:671-716``):
   a pixel handed over at ``jwait == max_ref`` rebases there
   (dz ← Z[max_ref] + dz, position 0) without spending an iteration;
   other positions are clipped to [0, max_ref - 1];
2. each pixel finds the last anchor ≤ its position and catches up to it
   with the df32 recurrence z ← z² + c_low (``perturb_stream.py:480-489``);
3. the HDR-f32 tail (``:492-520``): unreduced compares, escape at
   |z|² > 2^8, rebase on |z|² < |dz|² or at the orbit's end, which
   restarts the pixel at position 0 and anchor 0.

Positions and anchor pointers take the anchor table's index type
(int32 where max_ref < 2^31 - 1, else int64); the remaining budget is
int64.  Launches are bounded (``chunk_steps`` tail steps per pixel) and
resumable, each after the first over the pixels the last one left live
(``perturb.live_pixels``; the plain twin runs the same subsets); the
state is updated in place.  The same loop with an f64 cursor is K19, the
gather tail's exact mode (``ops/rc_tail.py``; a kernel of its own, the
recurrence unflushed where an exponent guard admits it): its anchor table is
``tables.Anchors64``, and every function below takes either table.
"""

from __future__ import annotations

import numpy as np
import torch

from fractalshark_tpu_torch.core.pointzoom import PointZoomBBConverter
from fractalshark_tpu_torch import kernels
from fractalshark_tpu_torch.ops import dblflt as dfm
from fractalshark_tpu_torch.ops import hdrfloat as hdr
from fractalshark_tpu_torch.ops.hdrfloat import HDRComplex
from fractalshark_tpu_torch.ops.perturb import (_dc_grids_hdr, delta_params,
                                               live_pixels, on_subset,
                                               perturb_render_hdr)
from fractalshark_tpu_torch.ops.tables import anchor_table, anchor_table_f64

DEFAULT_CHUNK_STEPS = 1 << 16
# orbit entries per streamed window in the reference; here the unit of
# `launch_windows`
WIN = 1024

_STATE = ("dzr", "dzi", "dze", "rem", "pos", "aptr", "z", "done")

# written by rc_tail_run after every render: launches ("dispatches") and
# the pixels each launch ran ("work")
last_run_stats: dict = {}


def _orbit_value_at(compressed, idx: int) -> tuple[float, float]:
    """Z[idx] from the anchor set: the last anchor ≤ idx, then the f64
    low-precision recurrence forward (``perturb_stream.py:719-744``)."""
    ai = compressed.anchor_index
    k = int(np.searchsorted(ai, idx, side="right")) - 1
    zx = float(compressed.anchors_x[k])
    zy = float(compressed.anchors_y[k])
    for _ in range(idx - int(ai[k])):
        zx, zy = (zx * zx - zy * zy + compressed.cx_low,
                  2.0 * zx * zy + compressed.cy_low)
    return zx, zy


def _df_step(z: torch.Tensor, c: tuple) -> torch.Tensor:
    """One df32 recurrence step z ← z² + c on [P, 4] (xh, xl, yh, yl)."""
    ccx = dfm.DF(*(torch.full_like(z[:, 0], v) for v in c[0:2]))
    ccy = dfm.DF(*(torch.full_like(z[:, 0], v) for v in c[2:4]))
    zx = dfm.DF(z[:, 0], z[:, 1])
    zy = dfm.DF(z[:, 2], z[:, 3])
    rx = dfm.df_add(dfm.df_sub(dfm.df_sqr(zx), dfm.df_sqr(zy)), ccx)
    ry = dfm.df_add(dfm.df_mul_pow2(dfm.df_mul(zx, zy), 2.0), ccy)
    return torch.stack([rx.hi, rx.lo, ry.hi, ry.lo], dim=1)


def _f64_step(z: torch.Tensor, c: tuple) -> torch.Tensor:
    """One f64 recurrence step z ← z² + c on [P, 2] (x, y), every result
    flushed (``rc_tail.py:136-137``: zx*zx - zy*zy + cx, 2*zx*zy + cy)."""
    ftz = hdr.ftz
    zx, zy = z[:, 0], z[:, 1]
    rx = ftz(ftz(ftz(zx * zx) - ftz(zy * zy)) + c[0])
    ry = ftz(ftz(ftz(2.0 * zx) * zy) + c[1])
    return torch.stack([rx, ry], dim=1)


def _recur(A, z: torch.Tensor) -> torch.Tensor:
    """The table's reconstruction step: f64 (K19) or df32 (K3)."""
    return _f64_step(z, A.c) if A.f64 else _df_step(z, A.c)


def _parts(A, z: torch.Tensor) -> tuple:
    """The f32 (x, y) of cursor values that the HDR step reads: the f64
    values rounded and flushed (K19), or the df32 hi parts (K3)."""
    if A.f64:
        return hdr.ftz(z[:, 0].float()), hdr.ftz(z[:, 1].float())
    return z[:, 0], z[:, 2]


def rc_init_plain(A, state: tuple, max_iter: int, z_mr: tuple) -> tuple:
    """Plain twin of K3's (or, with an ``Anchors64`` table, K19's) init
    launch.  On entry `rem` holds the completed iterations and `pos` the
    handoff position jwait."""
    dzr, dzi, dze, it, jw, _, _, done = state
    max_ref = A.max_ref
    wrap = (jw >= max_ref) & ~done
    zero_e = torch.zeros_like(dze)
    zmr = HDRComplex(torch.full_like(dzr, z_mr[0]),
                     torch.full_like(dzr, z_mr[1]), zero_e)
    zf = hdr.reduce_complex(hdr.complex_add(zmr, HDRComplex(dzr, dzi, dze)))
    dzr = torch.where(wrap, zf.re, dzr)
    dzi = torch.where(wrap, zf.im, dzi)
    dze = torch.where(wrap, zf.e, dze)
    pos = torch.where(wrap, 0, jw.clamp(0, max(max_ref - 1, 0)))
    rem = (max_iter - it).clamp(min=0)
    done = done | (rem == 0)
    aptr = torch.searchsorted(A.index, pos, right=True,
                              out_int32=A.index.dtype == torch.int32) - 1
    z = A.val[aptr].clone()
    catch = pos - A.index[aptr]
    while bool((catch > 0).any()):
        step = catch > 0
        z = torch.where(step[:, None], _recur(A, z), z)
        catch = catch - step.to(torch.int64)
    return (dzr, dzi, dze, rem, pos, aptr, z, done)


def rc_tail_plain(A, dc: HDRComplex, state: tuple,
                  chunk_steps: int = 0) -> tuple:
    """Plain PyTorch twin of K3's (or K19's) tail launch over flat pixel
    tensors: at most `chunk_steps` lockstep steps (0 = until every pixel
    is done).  Returns the state."""
    dzr, dzi, dze, rem, pos, aptr, z, done = state
    M = A.index.shape[0]
    max_ref = A.max_ref
    zero_e = torch.zeros_like(dze)
    steps = 0
    while not bool(done.all()) and (chunk_steps == 0 or steps < chunk_steps):
        steps += 1
        live = ~done
        nxt = (aptr + 1).clamp(max=M - 1)
        hit = ((aptr + 1) < M) & (A.index[nxt] == pos + 1)
        zn = A.val[nxt]
        if not bool((hit | done).all()):
            zn = torch.where(hit[:, None], zn, _recur(A, z))
        dz = HDRComplex(dzr, dzi, dze)
        zj = HDRComplex(*_parts(A, z), zero_e)
        t = hdr.complex_add(hdr.complex_mul_pow2(zj, 1), dz)
        ndz = hdr.reduce_complex(hdr.complex_add(hdr.complex_mul(t, dz), dc))
        zf = hdr.reduce_complex(hdr.complex_add(
            HDRComplex(*_parts(A, zn), zero_e), ndz))
        nsq = hdr.norm_squared(zf)
        dsq = hdr.norm_squared(ndz)
        esc = hdr.gt_pow2_unreduced(nsq, 8)
        reb = hdr.lt_unreduced(nsq, dsq) | (pos + 1 >= max_ref)
        upd = live & ~esc
        rb = upd & reb
        adv = upd & ~reb
        dzr = torch.where(upd, torch.where(reb, zf.re, ndz.re), dzr)
        dzi = torch.where(upd, torch.where(reb, zf.im, ndz.im), dzi)
        dze = torch.where(upd, torch.where(reb, zf.e, ndz.e), dze)
        rem = rem - upd.to(torch.int64)
        pos = torch.where(adv, pos + 1, torch.where(rb, 0, pos))
        aptr = torch.where(adv & hit, aptr + 1, torch.where(rb, 0, aptr))
        z = torch.where(adv[:, None], zn,
                        torch.where(rb[:, None], A.val[0].expand_as(z), z))
        done = done | (live & esc) | (rem == 0)
    return (dzr, dzi, dze, rem, pos, aptr, z, done)


def rc_tail_kernel(A, dc: HDRComplex, state: tuple, max_iter: int,
                   z_mr: tuple, chunk_steps: int, init: bool,
                   work=None) -> tuple:
    """Launch K3 (or, with an ``Anchors64`` table, K19) once on a CUDA
    device over the pixels `work` (int32 indices; None: every pixel); the
    state is updated in place."""
    dev = dc.re.device
    P = dc.re.numel()
    _check_state(state, P, dev, A)
    tables = (A.rows,) if A.f64 else (A.index, A.val)
    for t in (*dc, *tables):
        if t.device != dev or not t.is_contiguous():
            raise ValueError("K3 inputs must be contiguous on one device")
    n_work = P
    if work is not None:
        if work.dtype != torch.int32 or work.device != dev \
                or not work.is_contiguous():
            raise ValueError("K3 work must be contiguous int32 on the device")
        n_work = work.numel()
    lib = kernels.lib()
    counter = kernels.queue_counter(dev).data_ptr()
    if A.f64:
        kernels.launches["rc_tail_f64"] += 1
        kernels.check(lib.fs_rc_tail_f64(
            *(t.data_ptr() for t in dc), A.rows.data_ptr(),
            *(t.data_ptr() for t in state),
            None if work is None else work.data_ptr(), counter, n_work,
            A.rows.shape[0], A.max_ref, *A.c, float(z_mr[0]),
            float(z_mr[1]), int(max_iter), int(chunk_steps), int(init),
            kernels.stream(dev)), "fs_rc_tail_f64")
        return state
    wide = A.index.dtype == torch.int64
    kernels.launches["rc_tail"] += 1
    kernels.check(lib.fs_rc_tail(
        *(t.data_ptr() for t in dc), A.index.data_ptr(),
        A.val.data_ptr(), *(t.data_ptr() for t in state),
        None if work is None else work.data_ptr(), counter, n_work,
        A.index.shape[0],
        A.max_ref, *A.c, float(z_mr[0]), float(z_mr[1]), int(max_iter),
        int(chunk_steps), int(init) | (int(wide) << 1),
        kernels.stream(dev)), "fs_rc_tail")
    return state


def _state_dtypes(A):
    itype = A.index.dtype
    return (torch.float32, torch.float32, torch.int32, torch.int64, itype,
            itype, A.val.dtype, torch.bool)


def _check_state(state, P, dev, A):
    for t, dt, name in zip(state, _state_dtypes(A), _STATE):
        n = A.val.shape[1] * P if name == "z" else P
        if t.dtype != dt or t.numel() != n or t.device != dev \
                or not t.is_contiguous():
            raise ValueError(f"rc tail state {name}: {t.dtype} "
                             f"{tuple(t.shape)}")


def wrap_value(compressed, max_ref: int) -> tuple[float, float]:
    """Z[max_ref] as the f32 pair the handoff's wrap rebase adds."""
    return tuple(float(hdr.flush_np(np.float32(v)))
                 for v in _orbit_value_at(compressed, max_ref))


def handoff_state(A, init_state: dict, device) -> tuple:
    """Flat K3 (or K19) state from a handoff dict: `rem` holds the completed
    iterations and `pos` the position jwait (in [0, max_ref], which
    changes no handoff) until the init launch."""
    P = init_state["dzr"].numel()
    itype = A.index.dtype

    def f(k, dt):
        return init_state[k].reshape(-1).to(device=device, dtype=dt).clone()

    jw = init_state["jwait"].reshape(-1).to(device=device, dtype=torch.int64)
    return (f("dzr", torch.float32), f("dzi", torch.float32),
            f("dze", torch.int32), f("it", torch.int64),
            jw.clamp(0, A.max_ref).to(itype).contiguous(),
            torch.zeros(P, dtype=itype, device=device),
            torch.zeros((P, A.val.shape[1]), dtype=A.val.dtype,
                        device=device),
            f("done", torch.bool))


def rc_tail_run(A, dc: HDRComplex, init_state: dict, max_iter: int,
                z_mr: tuple, chunk_steps: int | None = None,
                abort_monitor=None) -> torch.Tensor:
    """Handoff init plus the tail to the end (or an abort) in bounded
    launches, each after the first over the pixels the last one left
    live: K3 (K19 for an ``Anchors64`` table) for CUDA tensors, the plain
    twin for CPU tensors.  Returns
    the remaining budget per pixel (flat int64)."""
    dev = dc.re.device
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    cuda = dev.type == "cuda"
    flat = HDRComplex(*(t.reshape(-1).contiguous() for t in dc))
    state = handoff_state(A, init_state, dev)
    if chunk_steps is None:
        chunk_steps = DEFAULT_CHUNK_STEPS if cuda else 0
    if not cuda:
        state = rc_init_plain(A, state, max_iter, z_mr)
    work, sizes = None, []
    while True:  # the first launch also runs the handoff init
        sizes.append(flat.re.numel() if work is None else work.numel())
        if cuda:
            state = rc_tail_kernel(A, flat, state, max_iter, z_mr,
                                   chunk_steps, init=work is None, work=work)
        else:
            state = on_subset(
                lambda st, d: rc_tail_plain(A, d, st, chunk_steps), state,
                flat, work)
        if bool(state[-1].all()) or (abort_monitor is not None
                                     and abort_monitor.aborted()):
            break
        work = live_pixels(state[-1])
    last_run_stats["dispatches"] = len(sizes)
    last_run_stats["work"] = sizes
    return state[3]


def anchors_on(compressed, device, f64: bool = False):
    """Anchor tables on `device`, cached on the CompressedOrbit: K3's
    (``Anchors``), or with `f64` K19's (``Anchors64``)."""
    cache = getattr(compressed, "_torch_anchors", None)
    if cache is None:
        cache = {}
        compressed._torch_anchors = cache
    key = (str(device), f64)
    if key not in cache:
        cache[key] = (anchor_table_f64 if f64 else anchor_table)(compressed,
                                                                 device)
    return cache[key]


def perturb_render_stream_rc(compressed, center_x, center_y,
                             ptz: PointZoomBBConverter, width: int,
                             height: int, max_iter: int, init_state=None,
                             chunk_steps: int | None = None,
                             abort_monitor=None, device="cuda",
                             f64: bool = False):
    """Perturbation render from a CompressedOrbit; the orbit is rebuilt
    on the device from its anchors, in df32 (K3) or, with `f64`, in f64
    (K19, the gather tail's exact mode, ``ops/rc_tail.py``).
    ``init_state``: optional handoff from the LA phase, a dict of
    [height, width] tensors 'dzr', 'dzi', 'dze', 'it' (completed
    iterations), 'jwait' (orbit position) and 'done'.  Returns the int64
    iteration grid [height, width]."""
    device = torch.device(device)
    A = anchors_on(compressed, device, f64)
    dx, dy, cxo, cyo = delta_params(ptz, center_x, center_y, width, height)
    dc = _dc_grids_hdr(dx, dy, cxo, cyo, width, height, device)
    if init_state is None:
        z = hdr.complex_zero((height, width), device=device)
        zeros = torch.zeros((height, width), dtype=torch.int64, device=device)
        init_state = {"dzr": z.re, "dzi": z.im, "dze": z.e, "it": zeros,
                      "jwait": zeros, "done": zeros.bool()}
    rem = rc_tail_run(A, dc, init_state, max_iter,
                      wrap_value(compressed, A.max_ref), chunk_steps,
                      abort_monitor)
    return (max_iter - rem).reshape(height, width)


def perturb_render_stream(results, ptz: PointZoomBBConverter, width: int,
                          height: int, max_iter: int, tile_h: int = 64,
                          launch_windows: int | None = None,
                          abort_monitor=None, device="cuda") -> torch.Tensor:
    """HDR-f32 perturbation render with no orbit-length cap (B11's
    route).  Each launch runs at most `launch_windows` × 1,024 steps per
    pixel (default ``DEFAULT_CHUNK_STEPS``), and the abort monitor is
    polled between launches.  `tile_h` is the reference's pixel-tile
    height and has no role on the card.  Returns the int64 iteration
    grid."""
    chunk = None if launch_windows is None else int(launch_windows) * WIN
    return perturb_render_hdr(results, ptz, width, height, max_iter,
                              np.float32, chunk, abort_monitor, device,
                              key="perturb_stream")
