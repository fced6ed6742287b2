"""LAv2 per-pixel machine: AT head skip → LA stage stepping →
perturbation tail with rebasing.  The port of
``fractalshark_tpu/ops/la_kernel.py`` (``_lav2_impl``, B2) through
kernel K2 (``csrc/lav2.cu``), which also covers the reference's
one-kernel Pallas render ``ops/la_pallas.py::_kernel`` (B4) in its
full mode.

Per-pixel state: stage ``s`` (s >= 0: LA stepping in stage s; s = -1:
perturbation tail), node offset ``j`` within the stage (-1 = "just
entered, take it from ref_iter"), ``ref_iter`` (node index handed to the
next stage, then the orbit position in the tail), dz (HDR complex), the
iteration count ``it`` and ``done``.  Counters and positions are int64.

Mantissas are f32 (the HDRx32 family and the LAv2 f32, 2x32 and
hdr2x32 names) or f64 (``sub_dtype=float64``: the ``Gpu1x64PerturbedLAv2``
band of 2^46-2^200 zoom and the hdr64 names), as in the reference's
``la_perturb_render(sub_dtype=...)``; K2 is one CUDA template over the
two.

Modes: full (returns the iteration grid) and ``la_only`` (a pixel is
done when it leaves stage 0; with ``return_state`` the state is
exported for the perturbation tail).  Both run in bounded chunks of
body steps with relaunches between them, polling an abort monitor, as
the reference does (``la_kernel.py:484-506``).

The plain version below runs every pixel in lockstep over flat tensors;
K2 runs one lane per pixel through the same body, its lanes taking
pixels from a work queue.  Between launches the run loop hands the next
launch only the pixels still live, on the card and on the CPU alike
(``perturb.live_pixels``).  Each pixel's trajectory depends only on its
own state, so both give the same grid.
"""

from __future__ import annotations

import torch

from fractalshark_tpu_torch.core.pointzoom import PointZoomBBConverter
from fractalshark_tpu_torch import kernels
from fractalshark_tpu_torch.ops import hdrfloat as hdr
from fractalshark_tpu_torch.ops.hdrfloat import HDR, HDRComplex
from fractalshark_tpu_torch.ops.perturb import (_dc_grids_hdr, delta_params,
                                               live_pixels, on_subset)
from fractalshark_tpu_torch.ops.tables import (ibits, la_tables, orbit_on,
                                               torch_dtype)

# body steps per pixel per launch: bounds one launch and sets the
# abort-poll granularity
DEFAULT_CHUNK_STEPS = 1 << 14

# written by the run loop after every render: launches ("dispatches"),
# the pixels each launch ran ("work") and its body steps a pixel a launch
# ("chunk_steps"; 0: unbounded)
last_run_stats: dict = {}

_STATE = ("s", "j", "ref_iter", "dzr", "dzi", "dze", "it", "done")

# K2's phases, by their code in csrc/lav2.cu (kPhaseBoth, kPhaseLa,
# kPhaseTail): which steps a launch runs
PHASES = ("both", "la", "tail")


def _select(c, a: HDRComplex, b: HDRComplex) -> HDRComplex:
    return HDRComplex(torch.where(c, a.re, b.re), torch.where(c, a.im, b.im),
                      torch.where(c, a.e, b.e))


def _cheb_r(z: HDRComplex) -> HDR:
    return hdr.reduce(hdr.chebychev_norm(z))


def _at_vals(at: torch.Tensor):
    """Unpack the [13] AT row: thrc, sqr_esc (HDR); refc, cc, invzc."""
    a = at.cpu()
    f = [float(v) for v in a]
    i = [int(v) for v in ibits(a)]
    return ((f[0], i[1]), (f[2], i[3]), (f[4], f[5], i[6]),
            (f[7], f[8], i[9]), (f[10], f[11], i[12]))


def init_state_plain(T, dc: HDRComplex, max_iter: int) -> tuple:
    """AT head skip and the initial machine state (plain twin of K2's
    init launch)."""
    shape = dc.re.shape
    dev = dc.re.device
    fdt = dict(dtype=dc.re.dtype, device=dev)
    i64 = dict(dtype=torch.int64, device=dev)
    it0 = torch.zeros(shape, **i64)
    dz0 = hdr.complex_zero(shape, dc.re.dtype, device=dev)
    if T.at_step > 0:
        thrc, sqr, refc, cc, invzc = _at_vals(T.at)

        def bc_c(v):
            return HDRComplex(torch.full(shape, v[0], **fdt),
                              torch.full(shape, v[1], **fdt),
                              torch.full(shape, v[2], dtype=torch.int32,
                                         device=dev))

        def bc_s(v):
            return HDR(torch.full(shape, v[0], **fdt),
                       torch.full(shape, v[1], dtype=torch.int32, device=dev))

        dc_cheb = _cheb_r(dc)
        at_ok = hdr.lte_reduced(dc_cheb, bc_s(thrc))
        c_at = hdr.reduce_complex(hdr.complex_add(
            hdr.complex_mul(dc, bc_c(cc)), bc_c(refc)))
        at_max = max_iter // T.at_step
        sqr_esc = bc_s(sqr)
        z = hdr.complex_zero(shape, dc.re.dtype, device=dev)
        cnt = torch.zeros(shape, **i64)
        active = at_ok.clone()
        i = 0
        while i < at_max and bool(active.any()):
            esc = hdr.gt_reduced(hdr.reduce(hdr.norm_squared(z)), sqr_esc)
            cont = active & ~esc
            nz = hdr.reduce_complex(hdr.complex_add(hdr.complex_sqr(z), c_at))
            z = _select(cont, nz, z)
            cnt += cont.to(torch.int64)
            active = cont
            i += 1
        dz_at = hdr.reduce_complex(hdr.complex_mul(z, bc_c(invzc)))
        it0 = torch.where(at_ok, cnt * T.at_step, it0)
        dz0 = _select(at_ok, dz_at, dz0)
    s0 = torch.full(shape, T.stage_count - 1, dtype=torch.int32, device=dev)
    j0 = torch.zeros(shape, dtype=torch.int32, device=dev)
    ref0 = torch.zeros(shape, **i64)
    return (s0, j0, ref0, dz0.re, dz0.im, dz0.e, it0, it0 >= max_iter)


def lav2_plain(T, orbit: torch.Tensor, dc: HDRComplex, state: tuple,
               max_iter: int, max_ref: int, la_only: bool,
               chunk_steps: int = 0, phase: str = "both") -> tuple:
    """Plain PyTorch twin of K2: run the machine over flat pixel
    tensors for at most `chunk_steps` lockstep body steps (0 = until
    every pixel is done).  With `phase` "la" only the pixels in the LA
    stages step (a pixel stops when it leaves them), with "tail" only
    those in the perturbation tail, as K2's launches of those `PHASES`.
    Returns the state."""
    if phase not in PHASES:
        raise ValueError(f"K2 phase {phase!r}")
    n = int(max_iter)
    S = T.stage_count
    N = T.nodes.shape[0]
    nodes_i = ibits(T.nodes)
    shape = dc.re.shape
    dev = dc.re.device
    dc_cheb = _cheb_r(dc)
    two56 = HDR(torch.ones(shape, dtype=dc.re.dtype, device=dev),
                torch.full(shape, 8, dtype=torch.int32, device=dev))
    zero_e = torch.zeros(shape, dtype=torch.int32, device=dev)
    if S > 0:
        st_i = ibits(T.stages)
        st_rows = st_i.long()
        thrc_m = T.stages[:, 2]
        stage_valid = torch.stack([
            hdr.lt_reduced(dc_cheb, HDR(thrc_m[k].expand(shape),
                                        st_i[k, 3].expand(shape)))
            for k in range(S)])
    s, j, ref_iter, dzr, dzi, dze, it, done = state
    steps = 0
    while chunk_steps == 0 or steps < chunk_steps:
        live = ~done
        if phase != "both":
            live = live & ((s >= 0) if phase == "la" else (s < 0))
        if not bool(live.any()):
            break
        steps += 1
        dz = HDRComplex(dzr, dzi, dze)
        in_la = live & (s >= 0)
        in_tail = live & (s < 0)

        # ---------------- LA branch -----------------------------------
        if S > 0:
            s_idx = s.clamp(0, S - 1).long()
            la_index = st_rows[s_idx, 0]
            macro = st_rows[s_idx, 1]
            valid = stage_valid.gather(0, s_idx[None])[0]
        else:
            la_index = torch.zeros_like(ref_iter)
            macro = torch.zeros_like(ref_iter)
            valid = torch.zeros_like(done)
        j_eff = torch.where(j < 0, ref_iter.to(torch.int32), j)
        node = (la_index + j_eff).clamp(0, N - 1)
        g = T.nodes[node]
        gi = nodes_i[node]
        sg = T.side[node]
        ref = HDRComplex(g[:, 0], g[:, 1], gi[:, 2])
        thr = HDR(g[:, 9], gi[:, 10])
        l_step = sg[:, 0]
        nsi = sg[:, 1]
        t = hdr.complex_add(hdr.complex_mul_pow2(ref, 1), dz)
        newdz = hdr.reduce_complex(hdr.complex_mul(t, dz))
        usable = ((it + l_step) <= n) & hdr.lt_reduced(_cheb_r(newdz), thr)
        drop_invalid = in_la & ~valid
        drop_unusable = in_la & valid & ~usable
        do_step = in_la & valid & usable
        ref_iter = torch.where(drop_unusable, nsi, ref_iter)
        drop = drop_invalid | drop_unusable
        s = torch.where(drop, s - 1, s)
        j = torch.where(drop, -1, j)
        zc = HDRComplex(g[:, 3], g[:, 4], gi[:, 5])
        cc = HDRComplex(g[:, 6], g[:, 7], gi[:, 8])
        dz_ev = hdr.reduce_complex(hdr.complex_add(
            hdr.complex_mul(newdz, zc), hdr.complex_mul(dc, cc)))
        refp1 = HDRComplex(g[:, 13], g[:, 14], gi[:, 15])
        z_full = hdr.reduce_complex(hdr.complex_add(refp1, dz_ev))
        j_next = j_eff + 1
        reb = hdr.lt_reduced(_cheb_r(z_full), _cheb_r(dz_ev)) | \
            (j_next >= macro)
        dz_la = _select(reb, z_full, dz_ev)
        j_la = torch.where(reb, 0, j_next)

        # ---------------- tail branch ----------------------------------
        # clamped to the table too: a VirtualResults orbit is one row,
        # which la_only never reads (its pixels stop on leaving the LA
        # stages), and the reference's gather clamps likewise
        og = orbit[ref_iter.clamp(0, min(max_ref, orbit.shape[0] - 1))]
        zj = HDRComplex(og[:, 0], og[:, 1], zero_e)
        t2 = hdr.complex_add(hdr.complex_mul_pow2(zj, 1), dz)
        ndz = hdr.reduce_complex(
            hdr.complex_add(hdr.complex_mul(t2, dz), dc))
        zf = hdr.reduce_complex(hdr.complex_add(
            HDRComplex(og[:, 2], og[:, 3], zero_e), ndz))
        nsq = hdr.reduce(hdr.norm_squared(zf))
        dsq = hdr.reduce(hdr.norm_squared(ndz))
        esc = hdr.gt_reduced(nsq, two56)
        treb = hdr.lt_reduced(nsq, dsq) | ((ref_iter + 1) >= max_ref)
        tail_upd = in_tail & ~esc
        dz_tail = _select(treb, zf, ndz)
        ref_tail = torch.where(treb, 0, ref_iter + 1)

        # ---------------- merge ----------------------------------------
        dz_new = _select(do_step, dz_la, _select(tail_upd, dz_tail, dz))
        dzr, dzi, dze = dz_new.re, dz_new.im, dz_new.e
        j = torch.where(do_step, j_la, j)
        ref_iter = torch.where(tail_upd, ref_tail, ref_iter)
        it = torch.where(do_step, it + l_step,
                         torch.where(tail_upd, it + 1, it))
        done = done | (in_tail & esc) | (it >= n)
        if la_only:
            done = done | (live & (s < 0))
    return (s, j, ref_iter, dzr, dzi, dze, it, done)


_LANES: dict = {}


def lanes_on(T, dev, dtype) -> int:
    """Lanes of K2 the card holds at once for the table `T` (the C side's
    resident blocks times its block size); raises on a CUDA error."""
    key = (T.stage_count, dtype == torch.float64, str(dev))
    if key not in _LANES:
        n = kernels.lib().fs_lav2_lanes(T.stage_count, int(key[1]))
        if n < 0:
            kernels.check(-n, "fs_lav2_lanes")
        _LANES[key] = n
    return _LANES[key]


def lav2_kernel(T, orbit: torch.Tensor, dc: HDRComplex, state: tuple | None,
                max_iter: int, max_ref: int, la_only: bool,
                chunk_steps: int, work=None, phase: str = "both") -> tuple:
    """Launch K2 once on a CUDA device over the pixels `work` (int32
    indices; None: every pixel), in one of the `PHASES`: "la" steps a
    pixel while it is in the LA stages, "tail" while it is in the
    perturbation tail, "both" either.  With `state` None the launch runs
    the AT head skip and initialises the state itself (and `work` must
    be None, the phase not "tail").  The state tensors are updated in
    place and returned."""
    dev = dc.re.device
    fdt = dc.re.dtype
    P = dc.re.numel()
    init = state is None
    if init:
        if work is not None or phase == "tail":
            raise ValueError("K2's first launch runs every pixel from its "
                             "LA stages")
        state = tuple(torch.empty(P, dtype=dt, device=dev)
                      for dt in _state_dtypes(fdt))
    _check_state(state, P, dev, fdt)
    tabs = (T.nodes, T.side, orbit, T.stages, T.at)
    for t in (*dc, *tabs):
        if t.device != dev or not t.is_contiguous():
            raise ValueError("K2 inputs must be contiguous on one device")
    for t in (*dc[:2], T.nodes, orbit, T.stages, T.at):
        if t.dtype != fdt:
            raise ValueError(f"K2 tables must all be {fdt}, not {t.dtype}")
    n_work = P
    if work is not None:
        if work.dtype != torch.int32 or work.device != dev \
                or not work.is_contiguous():
            raise ValueError("K2 work must be contiguous int32 on the device")
        n_work = work.numel()
    at = T.at if T.at.numel() else T.nodes  # never read when at_step == 0
    f64 = fdt == torch.float64
    lib = kernels.lib()
    kernels.launches[_COUNTER[f64, bool(la_only)]] += 1
    fn = lib.fs_lav2_f64 if f64 else lib.fs_lav2
    kernels.check(fn(
        *(t.data_ptr() for t in dc), T.nodes.data_ptr(),
        T.side.data_ptr(), orbit.data_ptr(), T.stages.data_ptr(),
        at.data_ptr(), *(t.data_ptr() for t in state),
        None if work is None else work.data_ptr(),
        kernels.queue_counter(dev).data_ptr(), n_work, T.nodes.shape[0],
        T.stage_count, int(max_ref), int(max_iter), int(chunk_steps),
        int(T.at_step),
        int(la_only) | (int(init) << 1) | (PHASES.index(phase) << 2),
        kernels.stream(dev)), "fs_lav2")
    return state


# launch counter per (f64 mantissas, la_only): K2 full mode is the
# reference's one-kernel render, la_only its phase 1 (f32) or the LAO
# algorithms' machine (f64)
_COUNTER = {(False, False): "lav2_full", (False, True): "lav2_phase1",
            (True, False): "lav2_full_f64", (True, True): "lav2_lao_f64"}


def _state_dtypes(fdt):
    return (torch.int32, torch.int32, torch.int64, fdt, fdt, torch.int32,
            torch.int64, torch.bool)


def _check_state(state, P, dev, fdt):
    for t, dt, name in zip(state, _state_dtypes(fdt), _STATE):
        if t.dtype != dt or t.numel() != P or t.device != dev \
                or not t.is_contiguous():
            raise ValueError(f"K2 state {name}: {t.dtype} {tuple(t.shape)}")


def split_phases(n_pixels: int, lanes: int) -> bool:
    """Whether a run launches the LA and tail phases apart: when its
    pixels outnumber the lanes the card holds at once, lanes take new
    pixels while their warps are in the tail, and a newcomer's LA steps
    would make the whole warp run the LA branch again; when every pixel
    has a lane, both phases run in one launch, and no pixel's tail waits
    for the others' LA steps.  (A la_only pixel is done when it leaves
    the LA stages, so its launches run its LA steps alone either way.)"""
    return n_pixels > lanes


def next_work(state: tuple, split: bool):
    """The next launch's pixels and phase: every live pixel in "both"; or,
    when the run splits its phases, those still in the LA stages while
    there are any (every pixel runs its LA steps before its tail), then
    those in the tail.  (None, _) when every pixel is done."""
    s, done = state[0], state[-1]
    if not split:
        if bool(done.all()):
            return None, "both"
        return live_pixels(done), "both"
    la = ~done & (s >= 0)
    n_la, n_live = torch.stack([la.sum(), (~done).sum()]).tolist()
    if n_live == 0:
        return None, "tail"
    if n_la:
        return live_pixels(~la), "la"
    return live_pixels(done), "tail"


def lav2_run(T, orbit, dc: HDRComplex, max_iter: int, max_ref: int,
             la_only: bool, chunk_steps: int | None = None,
             abort_monitor=None) -> tuple:
    """Run the machine to the end (or to an abort) in bounded launches,
    each over the pixels the last one left live: K2 for CUDA tensors, the
    plain twin for CPU tensors.  On the card, a run with more pixels than
    the card has lanes launches its phases apart (`split_phases`): first
    the LA steps of every live pixel in the LA stages, then the tail
    steps of those in the tail."""
    dev = dc.re.device
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    cuda = dev.type == "cuda"
    flat = HDRComplex(*(t.reshape(-1) for t in dc))
    if chunk_steps is None:
        chunk_steps = DEFAULT_CHUNK_STEPS if cuda else 0
    state = None if cuda else init_state_plain(T, flat, max_iter)
    split = cuda and split_phases(flat.re.numel(),
                                  lanes_on(T, dev, flat.re.dtype))
    work, phase, sizes = None, "la" if split else "both", []
    while True:
        sizes.append(flat.re.numel() if work is None else work.numel())
        if cuda:
            state = lav2_kernel(T, orbit, flat, state, max_iter, max_ref,
                                la_only, chunk_steps, work, phase)
        else:
            state = on_subset(
                lambda st, d: lav2_plain(T, orbit, d, st, max_iter, max_ref,
                                         la_only, chunk_steps, phase),
                state, flat, work)
        work, phase = next_work(state, split)
        if work is None or (abort_monitor is not None
                            and abort_monitor.aborted()):
            break
    last_run_stats["dispatches"] = len(sizes)
    last_run_stats["work"] = sizes
    last_run_stats["chunk_steps"] = chunk_steps
    return tuple(t.reshape(dc.re.shape) for t in state)


def la_perturb_render(results, la, ptz: PointZoomBBConverter, width: int,
                      height: int, max_iter: int, sub_dtype=torch.float32,
                      la_only: bool = False, chunk_steps: int | None = None,
                      abort_monitor=None, return_state: bool = False,
                      device="cuda"):
    """Full LAv2 render: AT skip → LA stages → perturbation tail, with
    f32 or f64 mantissas (`sub_dtype`, numpy or torch).  Returns the
    int64 iteration grid [height, width], or with `return_state` the
    machine state (s, j, ref_iter, dzr, dzi, dze, it, done)."""
    device = torch.device(device)
    fdt = torch_dtype(sub_dtype)
    T, orbit = device_tables(results, la, device, fdt)
    dx, dy, cxo, cyo = delta_params(ptz, results.center_x,
                                    results.center_y, width, height)
    dc = _dc_grids_hdr(dx, dy, cxo, cyo, width, height, device, fdt)
    state = lav2_run(T, orbit, dc, max_iter, results.max_ref_iteration(),
                     la_only, chunk_steps, abort_monitor)
    return state if return_state else state[6]


def la_tables_on(la, device, dtype=torch.float32):
    """The LA table on `device` with `dtype` mantissas, cached on the host
    object for the lifetime of that LA table."""
    key = ("torch_tables", str(device), dtype)
    cache = getattr(la, "_torch_cache", None)
    if cache is None:
        cache = la._torch_cache = {}
    if key not in cache:
        cache[key] = la_tables(la, device, dtype)
    return cache[key]


def device_tables(results, la, device, dtype=torch.float32):
    """LA and orbit tables on `device` with `dtype` mantissas, cached on
    the host objects for the lifetime of that LA table / orbit."""
    return la_tables_on(la, device, dtype), orbit_on(results, device, dtype)


def fits_full_mode(results, T, max_iter: int) -> bool:
    """The reference's one-kernel Pallas caps (``la_pallas.py:250-262``):
    orbit ≤ 8,192 entries, ≤ 2,048 nodes, 32-bit budgets and step
    lengths, at least one stage.  Frames within them render in K2's
    full mode; the others go two-phase, as on the reference."""
    count = results.count_orbit_entries() + 1
    return (count <= 64 * 128 and T.nodes.shape[0] <= 16 * 128
            and max_iter < (1 << 31) and T.stage_count > 0
            and T.max_step < (1 << 31))

