"""BLA perturbation rendering (the PerturbedBLA names): the port of
``fractalshark_tpu/ops/bla_kernel.py`` (``_bla_impl``,
``bla_perturb_render``) through kernel K15 (``csrc/bla.cu``).

Per pixel, from dz = 0 at orbit position j = 0: try the deepest valid
BLA entry for (j, |dz|²) (dz ← A·dz + B·dc, skipping l iterations), else
one perturbation step, with the usual escape (|z|² > 256) and Zhuoran
rebase (``_bla_impl``, whose vectorised level walk this module's twin
runs; the host's ``BLATable.lookup_backwards`` walks another way and is
not the reference here).

The table (``engine/bla.py``) goes to the device as row tables in the
mantissa type, one a walk reads and one a step reads: ``probe`` [R, 2]
(r² mantissa, exponent) and ``steps`` [R, 8] (A re, A im, A exponent, B
re, B im, B exponent, l, 0), integer fields bit-cast (f32) or exactly
converted (f64) as ``tables.ibits_np``, floats flushed as every uploaded
table; ``levels`` int32 [L, 2] holds each stored level's first entry
and its count; ``bound`` [n_bound, 2] (``bound_rows_np``), in probe's
layout, the largest r² the walk can visit at each position k = 4r, so
K15 decides a lookup with one load.

The reference steps every pixel in lockstep and counts in int32; K15
gives each lane its own pixel (int32 counts, so a budget of 2^31 raises
OverflowError, as the reference's ``jnp.int32`` does), and past the
card's lanes a lane takes further pixels from a work queue; a launch
runs at most ``chunk_steps`` steps a pixel, and the run loop hands the
next launch only the pixels still live, as K6's
(``perturb.perturb_run``).  The first launch runs every pixel from the
zero state; like the reference's first body, it steps every pixel once
even at a budget of 0.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from fractalshark_tpu_torch import kernels
from fractalshark_tpu_torch.core.pointzoom import PointZoomBBConverter
from fractalshark_tpu_torch.engine.bla import FIRST_LEVEL, BLATable
from fractalshark_tpu_torch.ops import hdrfloat as hdr
from fractalshark_tpu_torch.ops import perturb
from fractalshark_tpu_torch.ops.hdrfloat import HDR, HDRComplex, flush_np
from fractalshark_tpu_torch.ops.tables import (
    ibits, ibits_np, int32_budget, orbit_on, torch_dtype)

# steps per pixel per launch on the card
DEFAULT_CHUNK_STEPS = 1 << 16

# written by the run loop after every render: launches ("dispatches")
# and the pixels each launch ran ("work")
last_run_stats: dict = {}


@dataclass
class BLATables:
    probe: torch.Tensor    # T [R, 2]
    steps: torch.Tensor    # T [R, 8]
    levels: torch.Tensor   # int32 [L, 2]
    num_levels: int
    lm2: int               # the deepest level a lookup starts at
    bound: torch.Tensor    # T [n_bound, 2]


def bound_rows_np(probe: np.ndarray, levels: np.ndarray,
                  lm2: int) -> np.ndarray:
    """K15's lookup bound from the uploaded `probe` [R, 2] and `levels`
    [L, 2]: row r holds, in probe's layout, the largest r² (exponent
    first, then mantissa: ``lt_reduced``'s order) of the entries the
    level walk can visit at the position k = 4r, the levels FIRST_LEVEL
    to min(trailing_zeros(k), lm2) whose index k >> level is below their
    count (at k = 0 each such level's entry 0).  So dz² is below some
    such entry exactly when it is below row r.  A row with no such entry
    holds (-inf, INT32_MIN), below which nothing lies.  A position k = 2
    (mod 4) has no level from FIRST_LEVEL on, and positions at or past 4
    × the rows have none either: they have no row.  A mantissa that is
    NaN never compares below, so it counts as -inf."""
    npdt = probe.dtype
    m = probe[:, 0]
    e = (probe[:, 1].view(np.int32) if npdt == np.float32
         else probe[:, 1].astype(np.int32)).astype(np.int64)
    offs = levels[:, 0].astype(np.int64)
    cnts = levels[:, 1].astype(np.int64)
    walked = min(len(cnts), lm2 - FIRST_LEVEL + 1)
    # level li is visited at r < cnts[li] << li, r a multiple of 2^li
    n = max([1] + [int(cnts[li]) << li for li in range(walked)])
    best_e = np.full(n, np.iinfo(np.int32).min, np.int64)
    best_m = np.full(n, -np.inf, npdt)
    r = np.arange(n, dtype=np.int64)
    for li in range(walked):
        ix = r >> li
        ok = ((r & ((1 << li) - 1)) == 0) & (ix < cnts[li])
        q = offs[li] + ix[ok]
        ee, mm = e[q], np.where(np.isnan(m[q]), -np.inf, m[q])
        ce, cm = best_e[ok], best_m[ok]
        best_m[ok] = np.where(ee > ce, mm,
                              np.where(ee == ce, np.maximum(cm, mm), cm))
        best_e[ok] = np.maximum(ce, ee)
    out = np.empty((n, 2), npdt)
    out[:, 0] = best_m
    out[:, 1] = ibits_np(best_e, npdt)
    return out


def bla_tables(bla: BLATable, device, dtype=torch.float32) -> BLATables:
    """The BLA table as K15's row tables on `device`, `dtype` mantissas."""
    npdt = np.float32 if dtype == torch.float32 else np.float64
    R = len(bla.l)
    probe = np.zeros((R, 2), npdt)
    probe[:, 0] = flush_np(bla.r2_m.astype(npdt))
    probe[:, 1] = ibits_np(bla.r2_e, npdt)
    steps = np.zeros((R, 8), npdt)
    for c, v in enumerate((bla.a_m.real, bla.a_m.imag)):
        steps[:, c] = flush_np(v.astype(npdt))
    steps[:, 2] = ibits_np(bla.a_e, npdt)
    for c, v in enumerate((bla.b_m.real, bla.b_m.imag)):
        steps[:, 3 + c] = flush_np(v.astype(npdt))
    steps[:, 5] = ibits_np(bla.b_e, npdt)
    steps[:, 6] = ibits_np(bla.l, npdt)
    levels = np.stack([bla.level_offset, bla.level_count], axis=1)

    lm2 = max(bla.num_levels + FIRST_LEVEL - 2, FIRST_LEVEL)

    def up(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    return BLATables(probe=up(probe), steps=up(steps),
                     levels=up(levels.astype(np.int32)),
                     num_levels=int(bla.num_levels), lm2=lm2,
                     bound=up(bound_rows_np(probe, levels, lm2)))


def bla_on(results, bla: BLATable, device, dtype) -> BLATables:
    """``bla_tables`` cached on the results, for the lifetime of that
    orbit (and so of its table)."""
    key = ("torch_bla", str(device), dtype)
    T = results.extra.get(key)
    if T is None:
        T = results.extra[key] = bla_tables(bla, device, dtype)
    return T


_STATE = ("dzr", "dzi", "dze", "j", "it", "done")


def _state_dtypes(fdt):
    return (fdt, fdt, torch.int32, torch.int32, torch.int32, torch.bool)


def init_state_plain(dc: HDRComplex) -> tuple:
    """The zero state: dz = HDR zero, at orbit position 0, no iteration
    done, no pixel done (the reference's first body runs every pixel)."""
    shape, dev = dc.re.shape, dc.re.device
    zero = hdr.complex_zero(shape, dc.re.dtype, dev)
    i32 = torch.zeros(shape, dtype=torch.int32, device=dev)
    return (zero.re, zero.im, zero.e, i32, i32.clone(),
            torch.zeros(shape, dtype=torch.bool, device=dev))


def _trailing_zeros(k: torch.Tensor) -> torch.Tensor:
    """trailing_zeros(k) for k > 0, 32 at k = 0 (``_bla_impl``'s
    popcount(lowbit(k) - 1))."""
    low = (k & -k).to(torch.float64)
    tz = torch.log2(low.clamp(min=1)).round().to(torch.int32)
    return torch.where(k == 0, 32, tz)


def level_search(T: BLATables, j: torch.Tensor, dz2: HDR) -> tuple:
    """``_bla_impl``'s LookupBackwards for flat pixels at orbit positions
    `j` with reduced |dz|² `dz2`: (found, g), g the entry of the deepest
    level whose r² exceeds dz² at k = j - 1 (k even, levels FIRST_LEVEL
    to min(trailing_zeros(k), lm2) with k >> level below their count)."""
    R = T.probe.shape[0]
    li = torch.arange(T.num_levels, dtype=torch.int32, device=j.device)
    level = li + FIRST_LEVEL
    offs, cnts = T.levels[:, 0], T.levels[:, 1]
    k = j - 1
    k_ok = (j > 0) & ((k & 1) == 0)
    ksafe = k.clamp(min=0)
    start = _trailing_zeros(ksafe).clamp(max=T.lm2)
    # every level at once [pixels, levels]; the deepest hit wins, as the
    # reference's walk from the deepest level with `found`
    ix = torch.where(level >= 32, 0, ksafe[:, None] >> level.clamp(max=31))
    in_range = (level <= start[:, None]) & (ix < cnts)
    gi = (offs + ix).clamp(0, R - 1)
    pr = T.probe[gi.long()]
    hit = k_ok[:, None] & in_range & hdr.lt_reduced(
        HDR(dz2.m[:, None], dz2.e[:, None]),
        HDR(pr[..., 0], ibits(pr[..., 1])))
    best = torch.where(hit, li, -1).amax(dim=1)
    found = best >= 0
    pick = best.clamp(min=0).long()[:, None]
    return found, torch.where(found, gi.gather(1, pick)[:, 0], 0)


def bla_plain(orbit: torch.Tensor, dc: HDRComplex, T: BLATables,
              state: tuple, max_iter: int, max_ref: int,
              chunk_steps: int = 0, tally=None) -> tuple:
    """Plain PyTorch twin of K15 over flat pixel tensors: at most
    `chunk_steps` lockstep bodies (0 = until every pixel is done), each
    ``_bla_impl``'s body.  `orbit` is the packed [max_ref + 1, 4] table
    (Z[q] in row q's first half).  Returns the state.  `tally` (int64
    [pixels, 2], or None) gains each pixel's BLA steps and single steps,
    K15's tally."""
    dzr, dzi, dze, j, it, done = state
    n = int32_budget(max_iter)
    zero_e = torch.zeros_like(dze)
    two56 = HDR(torch.ones_like(dzr), torch.full_like(dze, 8))

    def z_at(q):
        row = orbit[q.clamp(0, max_ref).long()]
        return HDRComplex(row[:, 0], row[:, 1], zero_e)

    steps = 0
    while not bool(done.all()) and (chunk_steps == 0 or steps < chunk_steps):
        steps += 1
        live = ~done
        dz = HDRComplex(dzr, dzi, dze)
        found, g = level_search(T, j, hdr.reduce(hdr.norm_squared(dz)))
        row = T.steps[g.long()]
        l = ibits(row[:, 6])
        do_bla = live & found & ((j + l) < (max_ref + 1)) & ((it + l) < n)
        if tally is not None:
            tally[:, 0] += do_bla
            tally[:, 1] += live & ~do_bla
        A = HDRComplex(row[:, 0], row[:, 1], ibits(row[:, 2]))
        B = HDRComplex(row[:, 3], row[:, 4], ibits(row[:, 5]))
        dz_bla = hdr.reduce_complex(hdr.complex_add(
            hdr.complex_mul(A, dz), hdr.complex_mul(B, dc)))
        t2 = hdr.complex_add(hdr.complex_mul_pow2(z_at(j), 1), dz)
        dz_one = hdr.reduce_complex(
            hdr.complex_add(hdr.complex_mul(t2, dz), dc))
        ndz = HDRComplex(*(torch.where(do_bla, b, o)
                           for b, o in zip(dz_bla, dz_one)))
        nj = torch.where(do_bla, j + l, j + 1)
        nit = torch.where(do_bla, it + l, it + 1)
        zf = hdr.reduce_complex(hdr.complex_add(z_at(nj), ndz))
        nsq = hdr.reduce(hdr.norm_squared(zf))
        dsq = hdr.reduce(hdr.norm_squared(ndz))
        esc = hdr.gt_reduced(nsq, two56)
        reb = hdr.lt_reduced(nsq, dsq) | (nj >= max_ref)
        upd = live & ~esc
        dzr = torch.where(upd, torch.where(reb, zf.re, ndz.re), dzr)
        dzi = torch.where(upd, torch.where(reb, zf.im, ndz.im), dzi)
        dze = torch.where(upd, torch.where(reb, zf.e, ndz.e), dze)
        j = torch.where(upd, torch.where(reb, 0, nj), j)
        it = torch.where(upd, nit, it)
        done = done | (live & esc) | (it >= n)
    return (dzr, dzi, dze, j, it, done)


def bla_kernel(orbit: torch.Tensor, dc: HDRComplex, T: BLATables,
               state: tuple | None, max_iter: int, max_ref: int,
               chunk_steps: int, work=None, tally=None) -> tuple:
    """Launch K15 once on a CUDA device over the pixels `work` (int32
    indices; None: every pixel).  With `state` None the launch starts
    every pixel from the zero state (and `work` must be None).  The state
    tensors are updated in place and returned.  `tally` (int64 [pixels,
    2], or None) gains each pixel's BLA steps and single steps: a
    measurement's count of the work, which no render takes."""
    dev = dc.re.device
    fdt = dc.re.dtype
    P = dc.re.numel()
    max_iter = int32_budget(max_iter)
    init = state is None
    if init:
        if work is not None:
            raise ValueError("K15's first launch runs every pixel")
        state = tuple(torch.empty(P, dtype=dt, device=dev)
                      for dt in _state_dtypes(fdt))
    for t, dt, name in zip(state, _state_dtypes(fdt), _STATE):
        if t.dtype != dt or t.numel() != P or t.device != dev \
                or not t.is_contiguous():
            raise ValueError(f"K15 state {name}: {t.dtype} {tuple(t.shape)}")
    for t in (*dc, orbit, T.probe, T.steps, T.levels, T.bound):
        if t.device != dev or not t.is_contiguous():
            raise ValueError("K15 inputs must be contiguous on one device")
    if tally is not None and (tally.dtype != torch.int64 or tally.device != dev
                              or tuple(tally.shape) != (P, 2)
                              or not tally.is_contiguous()):
        raise ValueError("K15 tally must be contiguous int64 [pixels, 2]")
    if orbit.dtype != fdt or T.probe.dtype != fdt or T.steps.dtype != fdt \
            or T.bound.dtype != fdt or T.bound.shape[-1] != 2 \
            or orbit.shape[-1] != 4 or orbit.shape[0] < max_ref + 1:
        raise ValueError(f"K15 tables must be {fdt}, the orbit [max_ref + "
                         f"1, 4], not {tuple(orbit.shape)}")
    n_work = P
    if work is not None:
        if work.dtype != torch.int32 or work.device != dev \
                or not work.is_contiguous():
            raise ValueError("K15 work must be contiguous int32 on the "
                             "device")
        n_work = work.numel()
    lib = kernels.lib()
    f64 = fdt == torch.float64
    name = "fs_bla_f64" if f64 else "fs_bla_f32"
    kernels.launches["bla_f64" if f64 else "bla_f32"] += 1
    kernels.check(getattr(lib, name)(
        *(t.data_ptr() for t in dc), orbit.data_ptr(), T.probe.data_ptr(),
        T.bound.data_ptr(), T.steps.data_ptr(), T.levels.data_ptr(),
        *(t.data_ptr() for t in state),
        None if work is None else work.data_ptr(),
        kernels.queue_counter(dev).data_ptr(),
        None if tally is None else tally.data_ptr(), n_work, int(max_ref),
        max_iter, int(chunk_steps), T.num_levels, T.lm2, T.bound.shape[0],
        int(init), kernels.stream(dev)), name)
    return state


def bla_run(orbit: torch.Tensor, dc: HDRComplex, T: BLATables,
            max_iter: int, max_ref: int, chunk_steps: int | None = None,
            abort_monitor=None, tally=None) -> torch.Tensor:
    """Run every pixel to its escape or the budget (or to an abort) in
    bounded launches, each over the pixels the last one left live: K15
    for CUDA tensors, the plain twin for CPU tensors.  Returns the int64
    iteration grid in dc's shape.  `tally`: K15's count of each pixel's
    BLA and single steps (``bla_kernel``; on the card only)."""
    state = bla_run_state(orbit, dc, T, max_iter, max_ref, chunk_steps,
                          abort_monitor, tally)
    return state[4].reshape(dc.re.shape).to(torch.int64)


def bla_run_state(orbit: torch.Tensor, dc: HDRComplex, T: BLATables,
                  max_iter: int, max_ref: int,
                  chunk_steps: int | None = None, abort_monitor=None,
                  tally=None) -> tuple:
    """``bla_run``'s loop, returning the final flat state."""
    dev = dc.re.device
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    cuda = dev.type == "cuda"
    flat = HDRComplex(*(t.reshape(-1).contiguous() for t in dc))
    if chunk_steps is None:
        chunk_steps = DEFAULT_CHUNK_STEPS if cuda else 0
    if tally is not None and not cuda:
        raise ValueError("the step tally is K15's (a CUDA device)")
    state = None if cuda else init_state_plain(flat)
    work, sizes = None, []
    while True:
        sizes.append(flat.re.numel() if work is None else work.numel())
        if cuda:
            state = bla_kernel(orbit, flat, T, state, max_iter, max_ref,
                               chunk_steps, work, tally)
        else:
            state = perturb.on_subset(
                lambda st, d: bla_plain(orbit, d, T, st, max_iter, max_ref,
                                        chunk_steps), state, flat, work)
        if bool(state[-1].all()) or (abort_monitor is not None
                                     and abort_monitor.aborted()):
            break
        work = perturb.live_pixels(state[-1])
    last_run_stats["dispatches"] = len(sizes)
    last_run_stats["work"] = sizes
    return state


def bla_perturb_render(results, bla: BLATable, ptz: PointZoomBBConverter,
                       width: int, height: int, max_iter: int,
                       sub_dtype=np.float64, chunk_steps: int | None = None,
                       abort_monitor=None, device="cuda") -> torch.Tensor:
    """The BLA render's int64 iteration grid [height, width] on `device`
    (HDR with `sub_dtype` mantissas)."""
    device = torch.device(device)
    fdt = torch_dtype(sub_dtype)
    max_iter = int32_budget(max_iter)
    orbit = orbit_on(results, device, fdt)
    dc = perturb._dc_grids_hdr(*perturb.delta_params(
        ptz, results.center_x, results.center_y, width, height),
        width, height, device, fdt)
    return bla_run(orbit, dc, bla_on(results, bla, device, fdt), max_iter,
                   results.max_ref_iteration(), chunk_steps, abort_monitor)
