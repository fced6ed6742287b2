"""Perturbation-only rendering: the port of
``fractalshark_tpu/ops/perturb.py`` (``delta_params``, the dc grids,
``_perturb_float_impl``, ``perturb_render_float``, ``_perturb_hdr_impl``
and ``perturb_render_hdr``) through kernel K6 (``csrc/perturb.cu``).

Per-pixel semantics (``perturb.py:6-11``), from dz = 0 at orbit
position j = 0:

    dz ← dz·(2·Z[j] + dz) + dc ;  z = Z[j+1] + dz
    escaped  when |z|² > 256          (the count stays where it is)
    rebase   when |z|² < |dz|² or j+1 == maxRefIteration:
             dz ← z ; j ← 0           (else j ← j+1); count += 1

Pixel deltas: dc = (dx·x - centerX, -dy·y - centerY) with
centerX = refX - minX, centerY = refY - maxY (``Fractal.cpp:2235-2237``).

Numeric forms, each a K6 instance with its plain twin here:

* HDR, f32 or f64 mantissas (``_perturb_hdr_impl``): the HDRx32 and
  HDRx64 perturbation-only renders, and the no-LA fallback of their LAv2
  names.  The f32 instance is also what the reference's Pallas kernels
  B10 (``perturb_pallas.py``) and B11 (``perturb_stream.py``) compute;
  their entry points are in the modules of those names.
* plain float, f32 or f64 (``_perturb_float_impl``): the ``Gpu1x32`` and
  ``Gpu1x64`` LAv2 names without a valid LA table.
* plain f32 with a glitch flag a pixel, the OR of ``bad[j]`` over the
  orbit positions it stepped from (``scaled.py``'s
  ``_perturb_f32_glitch_impl``): the Scaled family's f32 pass
  (``run_state`` with ``bad``; ``ops/scaled.py``).

The reference steps every pixel in lockstep and counts the iterations
in int32; K6 gives each lane its own pixel and int64 counters, so
budgets of 2^31 and more work, and a launch runs at most
``chunk_steps`` steps per pixel and resumes from the state.  Between
launches the run loop hands the next launch only the pixels still live
(``live_pixels``), in index order, on the card and on the CPU alike:
K6 gives each of them a lane, the plain twin steps that subset in
lockstep.  Each pixel's steps depend on its own state alone,
so the subsets change no result.
"""

from __future__ import annotations

import numpy as np
import torch

from fractalshark_tpu_torch import kernels
from fractalshark_tpu_torch.core.highprecision import HighPrecision
from fractalshark_tpu_torch.core.pointzoom import PointZoomBBConverter
from fractalshark_tpu_torch.ops import hdrfloat as hdr
from fractalshark_tpu_torch.ops.hdrfloat import HDR, HDRComplex, flush_np, ftz
from fractalshark_tpu_torch.ops.tables import orbit_on, torch_dtype

# steps per pixel per launch: bounds one launch and sets the abort-poll
# granularity
DEFAULT_CHUNK_STEPS = 1 << 16

# written by the run loop after every render: launches ("dispatches")
# and the pixels each launch ran ("work")
last_run_stats: dict = {}

_STATE = ("dzr", "dzi", "dze", "j", "it", "done")


def delta_params(ptz: PointZoomBBConverter, ref_x: HighPrecision,
                 ref_y: HighPrecision, width: int, height: int):
    """High-precision dx, dy, centerX, centerY for the delta grid."""
    dx = (ptz.max_x - ptz.min_x) / HighPrecision(width)
    dy = (ptz.max_y - ptz.min_y) / HighPrecision(height)
    return dx, dy, ref_x - ptz.min_x, ref_y - ptz.max_y


def _dc_grids_hdr(dx, dy, cx_off, cy_off, width: int, height: int,
                  device, dtype=torch.float32) -> HDRComplex:
    """dc grids as an HDRComplex with `dtype` mantissas (shared
    exponent), exact at any zoom.  Built on `device` with the plain HDR
    ops: this is a one-off elementwise pass per frame."""
    npdt = np.float32 if dtype == torch.float32 else np.float64

    def hp(v):
        m, e = v.mantissa_exp2()
        return float(npdt(m)), int(np.int32(e))

    (dxm, dxe), (dym, dye) = hp(dx), hp(dy)
    (cxm, cxe), (cym, cye) = hp(cx_off), hp(cy_off)
    shape = (height, width)
    fl = dict(dtype=dtype, device=device)
    i32 = dict(dtype=torch.int32, device=device)
    xs = torch.arange(width, **fl)
    ys = torch.arange(height, **fl)
    x_dx = HDR(hdr.ftz(xs[None, :] * dxm).expand(shape),
               torch.full(shape, dxe, **i32))
    y_dy = HDR(hdr.ftz(ys[:, None] * dym).expand(shape),
               torch.full(shape, dye, **i32))
    cx_h = HDR(torch.full(shape, cxm, **fl), torch.full(shape, cxe, **i32))
    cy_h = HDR(torch.full(shape, cym, **fl), torch.full(shape, cye, **i32))
    dcx = hdr.reduce(hdr.sub(hdr.reduce(x_dx), cx_h))
    dcy = hdr.reduce(hdr.sub(hdr.negate(hdr.reduce(y_dy)), cy_h))
    dc = hdr.complex_from_hdr(dcx, dcy)
    return HDRComplex(*(t.contiguous() for t in dc))


def _dc_grids_float(dx, dy, cx_off, cy_off, width: int, height: int,
                    device, dtype=torch.float64) -> HDRComplex:
    """dc grids in native float: dcx = x·dx - centerX, dcy = -y·dy -
    centerY, computed in numpy as the reference does, then flushed of
    subnormals (the reference's kernels read them with DAZ).  Returned
    as an HDRComplex with a zero exponent, the form K6 takes."""
    npdt = np.float32 if dtype == torch.float32 else np.float64
    fdx, fdy = npdt(float(dx)), npdt(float(dy))
    fcx, fcy = npdt(float(cx_off)), npdt(float(cy_off))
    xs = np.arange(width, dtype=npdt)
    ys = np.arange(height, dtype=npdt)
    dcx = np.broadcast_to(xs[None, :] * fdx - fcx, (height, width))
    dcy = np.broadcast_to(-ys[:, None] * fdy - fcy, (height, width))

    def up(a):
        return torch.from_numpy(np.ascontiguousarray(flush_np(a))).to(device)

    return HDRComplex(up(dcx), up(dcy),
                      torch.zeros((height, width), dtype=torch.int32,
                                  device=device))


# --------------------------------------------------------------------------
# K6 and its plain twin
# --------------------------------------------------------------------------


def init_state_plain(dc: HDRComplex, max_iter: int, hdr_mode: bool) -> tuple:
    """The zero state: dz = 0 (HDR zero: exponent MIN_BIG_EXPONENT), at
    orbit position 0, no iteration done."""
    shape, dev = dc.re.shape, dc.re.device
    zero = torch.zeros(shape, dtype=dc.re.dtype, device=dev)
    dze = torch.full(shape, hdr.MIN_BIG_EXPONENT if hdr_mode else 0,
                     dtype=torch.int32, device=dev)
    i64 = torch.zeros(shape, dtype=torch.int64, device=dev)
    return (zero, zero.clone(), dze, i64, i64.clone(),
            torch.full(shape, int(max_iter) <= 0, device=dev))


def _step_hdr(og, dz: HDRComplex, dc: HDRComplex):
    """One HDR step (``_perturb_hdr_impl``): (ndz, zf, escaped, z < dz)."""
    zero_e = torch.zeros_like(dz.e)
    zj = HDRComplex(og[:, 0], og[:, 1], zero_e)
    t = hdr.complex_add(hdr.complex_mul_pow2(zj, 1), dz)
    ndz = hdr.reduce_complex(hdr.complex_add(hdr.complex_mul(t, dz), dc))
    zf = hdr.reduce_complex(hdr.complex_add(
        HDRComplex(og[:, 2], og[:, 3], zero_e), ndz))
    nsq = hdr.reduce(hdr.norm_squared(zf))
    dsq = hdr.reduce(hdr.norm_squared(ndz))
    two56 = HDR(torch.ones_like(nsq.m), torch.full_like(nsq.e, 8))
    return ndz, zf, hdr.gt_reduced(nsq, two56), hdr.lt_reduced(nsq, dsq)


def _step_float(og, dz: HDRComplex, dc: HDRComplex):
    """One native-float step (``_perturb_float_impl``), every * and +
    rounded and flushed on its own."""
    tx = ftz(ftz(2.0 * og[:, 0]) + dz.re)
    ty = ftz(ftz(2.0 * og[:, 1]) + dz.im)
    ndzx = ftz(ftz(ftz(tx * dz.re) - ftz(ty * dz.im)) + dc.re)
    ndzy = ftz(ftz(ftz(tx * dz.im) + ftz(ty * dz.re)) + dc.im)
    zfx = ftz(og[:, 2] + ndzx)
    zfy = ftz(og[:, 3] + ndzy)
    nsq = ftz(ftz(zfx * zfx) + ftz(zfy * zfy))
    dsq = ftz(ftz(ndzx * ndzx) + ftz(ndzy * ndzy))
    return (HDRComplex(ndzx, ndzy, dz.e), HDRComplex(zfx, zfy, dz.e),
            nsq > 256.0, nsq < dsq)


def perturb_plain(orbit: torch.Tensor, dc: HDRComplex, state: tuple,
                  max_iter: int, max_ref: int, hdr_mode: bool,
                  chunk_steps: int = 0, bad: torch.Tensor | None = None
                  ) -> tuple:
    """Plain PyTorch twin of K6 over flat pixel tensors: at most
    `chunk_steps` lockstep steps (0 = until every pixel is done).
    Returns the state.  With `bad` (bool, one an orbit position: the
    glitch instance) the state has a seventh tensor, the glitch flags,
    each ORed with bad[j] on every step its pixel runs."""
    dzr, dzi, dze, j, it, done = state[:6]
    glitch = state[6] if bad is not None else None
    step = _step_hdr if hdr_mode else _step_float
    steps = 0
    while not bool(done.all()) and (chunk_steps == 0 or steps < chunk_steps):
        steps += 1
        live = ~done
        jc = j.clamp(0, max(max_ref - 1, 0))
        og = orbit[jc]
        if bad is not None:
            glitch = glitch | (live & bad[jc])
        ndz, zf, esc, lower = step(og, HDRComplex(dzr, dzi, dze), dc)
        reb = lower | ((j + 1) >= max_ref)
        upd = live & ~esc
        dzr = torch.where(upd, torch.where(reb, zf.re, ndz.re), dzr)
        dzi = torch.where(upd, torch.where(reb, zf.im, ndz.im), dzi)
        dze = torch.where(upd, torch.where(reb, zf.e, ndz.e), dze)
        j = torch.where(upd, torch.where(reb, 0, j + 1), j)
        it = it + upd.to(torch.int64)
        done = done | (live & esc) | (it >= max_iter)
    out = (dzr, dzi, dze, j, it, done)
    return out if bad is None else out + (glitch,)


def live_pixels(done: torch.Tensor) -> torch.Tensor:
    """The pixels of a flat state that are not done, as int32 indices in
    ascending order: the next launch's work."""
    return torch.nonzero(~done).flatten().to(torch.int32)


def on_subset(step, state: tuple, dc: tuple, work) -> tuple:
    """`step(state, dc)` over the pixels `work` (None: all of them), the
    others left as they are: how the plain twins run a launch's work.
    `dc` is a tuple of flat tensors (an ``HDRComplex`` stays one)."""
    if work is None:
        return step(state, dc)
    w = work.long()
    sub_dc = tuple(t[w] for t in dc)
    if isinstance(dc, HDRComplex):
        sub_dc = HDRComplex(*sub_dc)
    sub = step(tuple(t[w] for t in state), sub_dc)
    out = tuple(t.clone() for t in state)
    for o, v in zip(out, sub):
        o[w] = v
    return out


def perturb_kernel(orbit: torch.Tensor, dc: HDRComplex, state: tuple | None,
                   max_iter: int, max_ref: int, hdr_mode: bool,
                   chunk_steps: int, key: str, work=None,
                   handoff: bool = False,
                   bad: torch.Tensor | None = None) -> tuple:
    """Launch K6 once on a CUDA device, counted under `key` (the entry
    point's instance name), over the pixels `work` (int32 indices; None:
    every pixel).  With `state` None the launch starts every pixel from
    the zero state itself (and `work` must be None); with `handoff` it
    first applies an LA phase's handoff to `state` (``handoff_plain``).
    With `bad` (bool, one an orbit position) it is the glitch instance
    (native f32 only): the state's seventh tensor holds the glitch flags.
    The state tensors are updated in place and returned."""
    dev = dc.re.device
    fdt = dc.re.dtype
    P = dc.re.numel()
    glitch = bad is not None
    if glitch and (hdr_mode or handoff or fdt != torch.float32
                   or bad.dtype != torch.bool or bad.device != dev
                   or bad.numel() < max_ref or not bad.is_contiguous()):
        raise ValueError("K6's glitch instance takes native f32 from the "
                         "zero state and a bool flag an orbit position")
    dtypes = _state_dtypes(fdt) + ((torch.bool,) if glitch else ())
    init = state is None
    if init:
        if work is not None:
            raise ValueError("K6's first launch runs every pixel")
        state = tuple(torch.empty(P, dtype=dt, device=dev) for dt in dtypes)
    if len(state) != len(dtypes):
        raise ValueError(f"K6 state: {len(state)} tensors, not "
                         f"{len(dtypes)}")
    for t, dt, name in zip(state, dtypes, _STATE + ("glitch",)):
        if t.dtype != dt or t.numel() != P or t.device != dev \
                or not t.is_contiguous():
            raise ValueError(f"K6 state {name}: {t.dtype} {tuple(t.shape)}")
    for t in (*dc, orbit):
        if t.device != dev or not t.is_contiguous():
            raise ValueError("K6 inputs must be contiguous on one device")
    if orbit.dtype != fdt or orbit.shape[-1] != 4:
        raise ValueError(f"K6 orbit must be {fdt} [M, 4], not "
                         f"{orbit.dtype} {tuple(orbit.shape)}")
    n_work = P
    if work is not None:
        if work.dtype != torch.int32 or work.device != dev \
                or not work.is_contiguous():
            raise ValueError("K6 work must be contiguous int32 on the device")
        n_work = work.numel()
    lib = kernels.lib()
    kernels.launches[key] += 1
    ptr_work = None if work is None else work.data_ptr()
    if glitch:
        kernels.check(lib.fs_perturb_scaled(
            dc.re.data_ptr(), dc.im.data_ptr(), orbit.data_ptr(),
            *(t.data_ptr() for t in state[:6]), ptr_work, bad.data_ptr(),
            state[6].data_ptr(), n_work, int(max_ref), int(max_iter),
            int(chunk_steps), int(init), kernels.stream(dev)),
            "fs_perturb_scaled")
        return state
    fn = lib.fs_perturb_f64 if fdt == torch.float64 else lib.fs_perturb_f32
    kernels.check(fn(
        *(t.data_ptr() for t in dc), orbit.data_ptr(),
        *(t.data_ptr() for t in state), ptr_work, n_work, int(max_ref),
        int(max_iter), int(chunk_steps),
        int(init) | (int(hdr_mode) << 1) | (int(handoff) << 2),
        kernels.stream(dev)), "fs_perturb")
    return state


def _state_dtypes(fdt):
    return (fdt, fdt, torch.int32, torch.int64, torch.int64, torch.bool)


def handoff_state(init: dict, device) -> tuple:
    """K6's HDR-f32 state from an LA phase's handoff (``init``: 'dzr',
    'dzi', 'dze', 'it' (completed iterations), 'jwait' (orbit position)
    and 'done'), flat and as handed over (a copy: K6 updates its state
    in place): `j` holds jwait until the handoff is applied
    (``handoff_plain``, or K6's first launch)."""
    def f(k, dt):
        return init[k].reshape(-1).to(device=device, dtype=dt).clone()

    return (f("dzr", torch.float32), f("dzi", torch.float32),
            f("dze", torch.int32), f("jwait", torch.int64),
            f("it", torch.int64), f("done", torch.bool))


def handoff_plain(orbit: torch.Tensor, state: tuple, max_iter: int,
                  max_ref: int) -> tuple:
    """Plain twin of K6's handoff, as the reference's
    ``_rc_init_from_handoff`` (``perturb_stream.py:671-716``) prepares
    its tail: a pixel at the budget is done; a live pixel handed over at
    ``jwait >= max_ref`` rebases there (dz ← Z[max_ref] + dz, position
    0) without spending an iteration, the other live positions are
    clamped to [0, max_ref - 1].  Z[max_ref] is the second half of the
    packed orbit's row max_ref - 1."""
    dzr, dzi, dze, jw, it, done = state
    done = done | (it >= max_iter)
    wrap = (jw >= max_ref) & ~done
    zmr = orbit[max(max_ref - 1, 0), 2:4]
    zf = hdr.reduce_complex(hdr.complex_add(
        HDRComplex(zmr[0].expand_as(dzr), zmr[1].expand_as(dzr),
                   torch.zeros_like(dze)), HDRComplex(dzr, dzi, dze)))
    j = torch.where(done, jw, jw.clamp(0, max(max_ref - 1, 0)))
    return (torch.where(wrap, zf.re, dzr), torch.where(wrap, zf.im, dzi),
            torch.where(wrap, zf.e, dze), torch.where(wrap, 0, j), it, done)


def perturb_run(orbit: torch.Tensor, dc: HDRComplex, max_iter: int,
                max_ref: int, hdr_mode: bool, key: str,
                chunk_steps: int | None = None, abort_monitor=None,
                state: tuple | None = None,
                handoff: bool = False) -> torch.Tensor:
    """Run every pixel to its escape or the budget (or to an abort) in
    bounded launches, each over the pixels the last one left live: K6 for
    CUDA tensors, the plain twin for CPU tensors.  From the zero state,
    or resumed from `state` (flat; updated in place on the card); with
    `handoff`, `state` is an LA phase's (``handoff_state``), which K6's
    first launch applies (``handoff_plain`` on the CPU).  The first
    launch runs every pixel (one that is done is stored as it is), so a
    run that ends in one launch never builds a work list.  Returns the
    int64 iteration grid in dc's shape."""
    state = run_state(orbit, dc, max_iter, max_ref, hdr_mode, key,
                      chunk_steps, abort_monitor, state, handoff)
    return state[4].reshape(dc.re.shape)


def run_state(orbit: torch.Tensor, dc: HDRComplex, max_iter: int,
              max_ref: int, hdr_mode: bool, key: str,
              chunk_steps: int | None = None, abort_monitor=None,
              state: tuple | None = None, handoff: bool = False,
              bad: torch.Tensor | None = None) -> tuple:
    """``perturb_run``'s loop, returning the final flat state; with `bad`
    the glitch instance's (its seventh tensor the glitch flags)."""
    dev = dc.re.device
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    cuda = dev.type == "cuda"
    flat = HDRComplex(*(t.reshape(-1).contiguous() for t in dc))
    if chunk_steps is None:
        chunk_steps = DEFAULT_CHUNK_STEPS if cuda else 0
    work, sizes = None, []
    if state is not None and handoff and not cuda:
        state = handoff_plain(orbit, state, max_iter, max_ref)
    elif state is None and not cuda:
        state = init_state_plain(flat, max_iter, hdr_mode)
        if bad is not None:
            state += (torch.zeros_like(state[5]),)
    while True:
        sizes.append(flat.re.numel() if work is None else work.numel())
        if cuda:
            state = perturb_kernel(orbit, flat, state, max_iter, max_ref,
                                   hdr_mode, chunk_steps, key, work,
                                   handoff=handoff and len(sizes) == 1,
                                   bad=bad)
        else:
            state = on_subset(
                lambda st, d: perturb_plain(orbit, d, st, max_iter, max_ref,
                                            hdr_mode, chunk_steps, bad),
                state, flat, work)
        if bool(state[5].all()) or (abort_monitor is not None
                                    and abort_monitor.aborted()):
            break
        work = live_pixels(state[5])
    last_run_stats["dispatches"] = len(sizes)
    last_run_stats["work"] = sizes
    return state


def _render(results, ptz, width, height, max_iter, dtype, hdr_mode, key,
            chunk_steps, abort_monitor, device):
    device = torch.device(device)
    orbit = orbit_on(results, device, dtype)
    dx, dy, cxo, cyo = delta_params(ptz, results.center_x, results.center_y,
                                    width, height)
    grids = _dc_grids_hdr if hdr_mode else _dc_grids_float
    dc = grids(dx, dy, cxo, cyo, width, height, device, dtype)
    return perturb_run(orbit, dc, max_iter, results.max_ref_iteration(),
                       hdr_mode, key, chunk_steps, abort_monitor)


def perturb_render_float(results, ptz: PointZoomBBConverter, width: int,
                         height: int, max_iter: int, dtype=np.float64,
                         chunk_steps: int | None = None, abort_monitor=None,
                         device="cuda") -> torch.Tensor:
    """Full perturbation render with native-float deltas (f32 or f64,
    numpy or torch dtype).  Returns the int64 iteration grid."""
    fdt = torch_dtype(dtype)
    key = "perturb_f64" if fdt == torch.float64 else "perturb_f32"
    return _render(results, ptz, width, height, max_iter, fdt, False, key,
                   chunk_steps, abort_monitor, device)


def perturb_render_hdr(results, ptz: PointZoomBBConverter, width: int,
                       height: int, max_iter: int, sub_dtype=np.float32,
                       chunk_steps: int | None = None, abort_monitor=None,
                       device="cuda", key: str | None = None) -> torch.Tensor:
    """Full perturbation render with HDR deltas of f32 or f64 mantissas.
    Returns the int64 iteration grid.  `key` names the launch counter
    (the B10/B11 entry points pass theirs)."""
    fdt = torch_dtype(sub_dtype)
    if key is None:
        key = "perturb_hdr64" if fdt == torch.float64 else "perturb_hdr32"
    return _render(results, ptz, width, height, max_iter, fdt, True, key,
                   chunk_steps, abort_monitor, device)
