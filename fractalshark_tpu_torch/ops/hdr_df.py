"""HDR double-float ("HDRx2x32") perturbation rendering: the port of
``fractalshark_tpu/ops/hdr_df.py`` (``HDC2`` and its ops, the dc grids
``_dc_grids_hdrdf``, ``_perturb_hdrdf_impl`` and
``perturb_render_hdr_df``) through kernel K16
(``csrc/perturb_hdr_df.cu``).

Each complex value carries double-float (hi, lo) f32 mantissas (~48
bits, ``ops/dblflt.py``) and one shared int32 exponent: the depth band
where f32 glitches but f64 throughput is poor.  Exponent handling is
``ops/hdrfloat.py``'s (the ignore threshold, the zero sentinel); every
mantissa scaling is by an exact power of two, applied to both halves.

Per pixel (``_perturb_hdrdf_impl``), from dz = 0 at orbit position 0:

    dz ← reduce((2·Z[j] + dz)·dz + dc) ;  z = reduce(Z[j+1] + dz)
    escaped  when |z|²hi > 256 (the reduced HDR compare of the hi parts)
    rebase   when |z|²hi < |dz|²hi or j+1 ≥ max_ref: dz ← z, j ← 0;
             count += 1

The route of the 2x32 and hdr2x32 LAv2 names in PO mode or without a
valid LA table (JAX ``engine/renderers.py:121-129``).  As K6 does, the
kernel gives each live pixel a lane and int64 counters, and the run loop
hands each launch after the first only the pixels still live; the budget
is int32 as the reference's (2^31 raises OverflowError), the grid int64
inside the port and uint32 at the public boundary.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from fractalshark_tpu_torch import kernels
from fractalshark_tpu_torch.core.highprecision import HighPrecision
from fractalshark_tpu_torch.core.pointzoom import PointZoomBBConverter
from fractalshark_tpu_torch.ops import hdrfloat as hdr
from fractalshark_tpu_torch.ops import perturb
from fractalshark_tpu_torch.ops.dblflt import (DF, df_add, df_mul, df_sub,
                                               two_prod)
from fractalshark_tpu_torch.ops.hdrfloat import (EXPONENT_DIFF_IGNORED,
                                                 HDR, MIN_BIG_EXPONENT,
                                                 flush_np, ftz, pow2i)
from fractalshark_tpu_torch.ops.tables import int32_budget

KEY = "perturb_hdr_df"


class HDC2(NamedTuple):
    """Complex HDR with double-float mantissas and a shared exponent."""
    re: DF
    im: DF
    e: torch.Tensor


def zero(shape, device="cpu") -> HDC2:
    def z():
        return torch.zeros(shape, dtype=torch.float32, device=device)
    return HDC2(DF(z(), z()), DF(z(), z()),
                torch.full(shape, MIN_BIG_EXPONENT, dtype=torch.int32,
                           device=device))


def _scale(v: DF, s) -> DF:
    """A DF times an exact power of two."""
    return DF(ftz(v.hi * s), ftz(v.lo * s))


def add(a: HDC2, b: HDC2) -> HDC2:
    """Shared-exponent complex add: the smaller operand scaled down, gaps
    past the ignore threshold vanish (HDRFloatComplex::plus)."""
    a_big = a.e >= b.e
    e = torch.where(a_big, a.e, b.e)
    diff = (e - torch.where(a_big, b.e, a.e)).clamp(
        max=EXPONENT_DIFF_IGNORED + 6)
    s = pow2i(-diff, torch.float32)

    def pick(big, small):
        return DF(torch.where(a_big, big.hi, small.hi),
                  torch.where(a_big, big.lo, small.lo))

    return HDC2(df_add(pick(a.re, b.re), _scale(pick(b.re, a.re), s)),
                df_add(pick(a.im, b.im), _scale(pick(b.im, a.im), s)), e)


def mul(a: HDC2, b: HDC2) -> HDC2:
    return HDC2(df_sub(df_mul(a.re, b.re), df_mul(a.im, b.im)),
                df_add(df_mul(a.re, b.im), df_mul(a.im, b.re)),
                a.e + b.e)


def mul_pow2(a: HDC2, k: int) -> HDC2:
    return HDC2(a.re, a.im, a.e + k)


def reduce(a: HDC2) -> HDC2:
    """HdrReduce by the Chebyshev-largest hi component; the power-of-two
    scale is exact on both DF halves."""
    big = torch.maximum(a.re.hi.abs(), a.im.hi.abs())
    _, fe = hdr._frexp2(big)
    is_zero = big == 0
    fe = torch.where(is_zero, 0, fe)
    s = pow2i(-fe, torch.float32)
    return HDC2(_scale(a.re, s), _scale(a.im, s),
                torch.where(is_zero, MIN_BIG_EXPONENT, a.e + fe))


def norm_squared_hi(a: HDC2) -> HDR:
    """|z|² of the hi parts as a plain-f32 HDR (the escape and rebase
    compares need no low halves)."""
    return HDR(ftz(ftz(a.re.hi * a.re.hi) + ftz(a.im.hi * a.im.hi)),
               a.e + a.e)


# ------------------------------------------------------------ dc grids


def _hp_to_df_exp(v: HighPrecision):
    """(hi, lo, exp2) with v == (hi + lo)·2^exp2, hi and lo f32: the
    mantissa is split, not the value."""
    m, e = v.mantissa_exp2()
    hi = np.float32(m)
    lo = np.float32(m - float(hi))
    return float(hi), float(lo), int(e)


def _dc_grids_hdrdf(dx, dy, cx_off, cy_off, width: int, height: int,
                    device="cpu") -> HDC2:
    """dc = (x·dx − centerX, −y·dy − centerY) as an HDC2 grid [height,
    width], ~48-bit mantissas at any depth, op for op as the reference
    builds it: idx·hi by ``two_prod`` (idx < 2^24 is exact in f32),
    idx·lo plainly into the low word.  A one-off elementwise pass per
    frame, on `device`."""
    shape = (height, width)
    fl = dict(dtype=torch.float32, device=device)

    def zeros():
        return torch.zeros(shape, **fl)

    def term(step_hp, count, axis):
        hi, lo, e = _hp_to_df_exp(step_hp)
        idx = torch.arange(count, **fl)
        idx = (idx[None, :] if axis else idx[:, None]).expand(shape)
        p_hi, p_err = two_prod(idx, torch.full(shape, hi, **fl))
        p_lo = ftz(p_err + ftz(idx * lo))
        return HDC2(DF(p_hi, p_lo), DF(zeros(), zeros()),
                    torch.full(shape, e, dtype=torch.int32, device=device))

    def const(c_hp):
        hi, lo, e = _hp_to_df_exp(c_hp)
        return HDC2(DF(torch.full(shape, hi, **fl),
                       torch.full(shape, lo, **fl)), DF(zeros(), zeros()),
                    torch.full(shape, e, dtype=torch.int32, device=device))

    def neg(z: HDC2) -> HDC2:
        return HDC2(DF(-z.re.hi, -z.re.lo), z.im, z.e)

    dcx = reduce(add(reduce(term(dx, width, True)), neg(const(cx_off))))
    dcy = reduce(add(neg(reduce(term(dy, height, False))),
                     neg(const(cy_off))))
    # one complex: re from dcx, im from dcy, at the larger exponent
    e = torch.maximum(dcx.e, dcy.e)
    sx = pow2i(-(e - dcx.e).clamp(max=EXPONENT_DIFF_IGNORED + 6),
               torch.float32)
    sy = pow2i(-(e - dcy.e).clamp(max=EXPONENT_DIFF_IGNORED + 6),
               torch.float32)
    return HDC2(_scale(dcx.re, sx), _scale(dcy.re, sy), e)


def dc_tensors(dc: HDC2) -> tuple:
    """The dc grid as K16 takes it: (re hi, re lo, im hi, im lo, e), flat
    and contiguous."""
    return tuple(t.reshape(-1).contiguous()
                 for t in (*dc.re, *dc.im, dc.e))


def pack_orbit_df(results, device) -> torch.Tensor:
    """``results.device_orbit_df()`` as K16's orbit table: f32 [M, 8] rows
    (Z[r].re hi, lo, Z[r].im hi, lo, then Z[r+1] likewise) for r <
    max(max_ref, 1) (the orbit has one entry past max_ref), flushed of
    subnormals as the reference reads them; cached on the results.  A
    step at position j < max_ref reads row j."""
    key = ("torch_orbit_df", str(device))
    table = results.extra.get(key)
    if table is None:
        cols = np.stack(results.device_orbit_df(), axis=1)
        m = max(results.max_ref_iteration(), 1)
        rows = np.concatenate([cols[:m], cols[1:m + 1]], axis=1)
        table = results.extra[key] = torch.from_numpy(
            np.ascontiguousarray(flush_np(rows))).to(device)
    return table


# --------------------------------------------------------- K16 and twin

_STATE = ("rh", "rl", "ih", "il", "e", "j", "it", "done")


def init_state_plain(n_pixels: int, max_iter: int, device) -> tuple:
    """The zero state: dz = 0 (exponent MIN_BIG_EXPONENT) at orbit
    position 0, no iteration done."""
    z = zero((n_pixels,), device)
    i64 = torch.zeros(n_pixels, dtype=torch.int64, device=device)
    return (*z.re, *z.im, z.e, i64, i64.clone(),
            torch.full((n_pixels,), int(max_iter) <= 0, device=device))


def step_plain(rows: torch.Tensor, dz: HDC2, dc: HDC2):
    """One step of every pixel from its orbit row (Z[j], Z[j+1]):
    (ndz, zf, escaped, |z|² < |dz|²)."""
    zero_e = torch.zeros_like(dz.e)
    zj = HDC2(DF(rows[:, 0], rows[:, 1]), DF(rows[:, 2], rows[:, 3]), zero_e)
    t = add(mul_pow2(zj, 1), dz)
    ndz = reduce(add(mul(t, dz), dc))
    zf = reduce(add(HDC2(DF(rows[:, 4], rows[:, 5]),
                         DF(rows[:, 6], rows[:, 7]), zero_e), ndz))
    nsq = hdr.reduce(norm_squared_hi(zf))
    dsq = hdr.reduce(norm_squared_hi(ndz))
    two56 = HDR(torch.ones_like(nsq.m), torch.full_like(nsq.e, 8))
    return ndz, zf, hdr.gt_reduced(nsq, two56), hdr.lt_reduced(nsq, dsq)


def perturb_hdr_df_plain(orbit: torch.Tensor, dc: tuple, state: tuple,
                         max_iter: int, max_ref: int,
                         chunk_steps: int = 0) -> tuple:
    """Plain PyTorch twin of K16 over flat pixel tensors: at most
    `chunk_steps` lockstep steps (0 = until every pixel is done); returns
    the state.  `dc` as ``dc_tensors``."""
    rh, rl, ih, il, e, j, it, done = state
    dcv = HDC2(DF(dc[0], dc[1]), DF(dc[2], dc[3]), dc[4])
    steps = 0
    while not bool(done.all()) and (chunk_steps == 0 or steps < chunk_steps):
        steps += 1
        live = ~done
        rows = orbit[j.clamp(0, max(max_ref - 1, 0))]
        ndz, zf, esc, lower = step_plain(
            rows, HDC2(DF(rh, rl), DF(ih, il), e), dcv)
        reb = lower | ((j + 1) >= max_ref)
        upd = live & ~esc

        def sel(new_reb, new_nrm, old):
            return torch.where(upd, torch.where(reb, new_reb, new_nrm), old)

        rh = sel(zf.re.hi, ndz.re.hi, rh)
        rl = sel(zf.re.lo, ndz.re.lo, rl)
        ih = sel(zf.im.hi, ndz.im.hi, ih)
        il = sel(zf.im.lo, ndz.im.lo, il)
        e = sel(zf.e, ndz.e, e)
        j = torch.where(upd, torch.where(reb, 0, j + 1), j)
        it = it + upd.to(torch.int64)
        done = done | (live & esc) | (it >= max_iter)
    return rh, rl, ih, il, e, j, it, done


def perturb_hdr_df_kernel(orbit: torch.Tensor, dc: tuple, state,
                          max_iter: int, max_ref: int, chunk_steps: int,
                          work=None) -> tuple:
    """Launch K16 once on a CUDA device over the pixels `work` (int32
    indices; None: every pixel).  With `state` None the launch starts
    every pixel from the zero state (and `work` must be None).  The state
    tensors are updated in place and returned."""
    dev = orbit.device
    P = dc[0].numel()
    dtypes = (torch.float32,) * 4 + (torch.int32, torch.int64, torch.int64,
                                     torch.bool)
    init = state is None
    if init:
        if work is not None:
            raise ValueError("K16's first launch runs every pixel")
        state = tuple(torch.empty(P, dtype=dt, device=dev) for dt in dtypes)
    if len(state) != len(dtypes):
        raise ValueError(f"K16 state: {len(state)} tensors, not "
                         f"{len(dtypes)}")
    for t, dt, name in zip(state, dtypes, _STATE):
        if t.dtype != dt or t.numel() != P or t.device != dev \
                or not t.is_contiguous():
            raise ValueError(f"K16 state {name}: {t.dtype} "
                             f"{tuple(t.shape)}")
    for t, dt in zip(dc, (torch.float32,) * 4 + (torch.int32,)):
        if t.dtype != dt or t.numel() != P or t.device != dev \
                or not t.is_contiguous():
            raise ValueError("K16 dc: four f32 and one int32 tensor, "
                             "contiguous, on the orbit's device")
    if orbit.dtype != torch.float32 or orbit.dim() != 2 \
            or orbit.shape[1] != 8 or not orbit.is_contiguous():
        raise ValueError(f"K16 orbit must be f32 [M, 8], not "
                         f"{orbit.dtype} {tuple(orbit.shape)}")
    n_work = P
    if work is not None:
        if work.dtype != torch.int32 or work.device != dev \
                or not work.is_contiguous():
            raise ValueError("K16 work must be contiguous int32 on the "
                             "device")
        n_work = work.numel()
    lib = kernels.lib()
    kernels.launches[KEY] += 1
    kernels.check(lib.fs_perturb_hdr_df(
        *(t.data_ptr() for t in dc), orbit.data_ptr(),
        *(t.data_ptr() for t in state),
        None if work is None else work.data_ptr(), n_work, int(max_ref),
        int(max_iter), int(chunk_steps), int(init), kernels.stream(dev)),
        "fs_perturb_hdr_df")
    return state


def run_state(orbit: torch.Tensor, dc: tuple, max_iter: int, max_ref: int,
              chunk_steps: int | None = None, abort_monitor=None) -> tuple:
    """Every pixel to its escape or the budget (or to an abort) in bounded
    launches, each after the first over the pixels the last one left live
    (``perturb.live_pixels``): K16 for CUDA tensors, the plain twin for
    CPU tensors.  Returns the final flat state."""
    dev = orbit.device
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    max_iter = int32_budget(max_iter)
    cuda = dev.type == "cuda"
    if chunk_steps is None:
        chunk_steps = perturb.DEFAULT_CHUNK_STEPS if cuda else 0
    state = None if cuda else init_state_plain(dc[0].numel(), max_iter, dev)
    work, sizes = None, []
    while True:
        sizes.append(dc[0].numel() if work is None else work.numel())
        if cuda:
            state = perturb_hdr_df_kernel(orbit, dc, state, max_iter,
                                          max_ref, chunk_steps, work)
        else:
            state = perturb.on_subset(
                lambda st, d: perturb_hdr_df_plain(
                    orbit, d, st, max_iter, max_ref, chunk_steps),
                state, dc, work)
        if bool(state[7].all()) or (abort_monitor is not None
                                    and abort_monitor.aborted()):
            break
        work = perturb.live_pixels(state[7])
    perturb.last_run_stats["dispatches"] = len(sizes)
    perturb.last_run_stats["work"] = sizes
    return state


def perturb_render_hdr_df(results, ptz: PointZoomBBConverter, width: int,
                          height: int, max_iter: int,
                          chunk_steps: int | None = None,
                          abort_monitor=None,
                          device="cuda") -> torch.Tensor:
    """The full 2x32 / HDRx2x32 perturbation render: the int64 iteration
    grid [height, width] on `device`."""
    device = kernels.resolve_device(device)
    max_iter = int32_budget(max_iter)
    orbit = pack_orbit_df(results, device)
    dx, dy, cxo, cyo = perturb.delta_params(ptz, results.center_x,
                                            results.center_y, width, height)
    dc = dc_tensors(_dc_grids_hdrdf(dx, dy, cxo, cyo, width, height, device))
    state = run_state(orbit, dc, max_iter, results.max_ref_iteration(),
                      chunk_steps, abort_monitor)
    return state[6].reshape(height, width)
