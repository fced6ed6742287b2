"""The streaming LA phase: the port of ``fractalshark_tpu/ops/la_stream.py``
(``la_phase_stream``, B12) through kernel K7 (``csrc/la_stream.cu``).

Phase 1 of the two-phase LAv2 render, stage by stage from coarse to
fine, as the pixel-identical alternative to K2's one-machine phase 1
(``FRACTALSHARK_LA_PHASE=stream``, ``engine/renderers.py``).  The
reference (``la_stream.py:386-499``) runs the AT head skip, then every
stage from coarse to fine: a pixel takes part in stage s iff it is not
done and |dc| is below the stage's first LAThresholdC, its entry offset
is the ``ref_iter`` handed down (clipped to [0, macro − 1]), the stage
is relaunched until no pixel still steps in it, and the abort monitor is
polled between launches.  The result is the tail handoff
``{dzr, dzi, dze, it, jwait, done}`` that
``perturb_stream.perturb_render_stream_rc(init_state=...)`` takes.

Whether a pixel enters a stage, where, and how it steps depend only on
its own state, so K7 carries each pixel through the AT skip and every
stage in one lane (see ``csrc/la_stream.cu``), and ``run_stages``
launches it once over every pixel, then, while some pixel reached the
launch's bound of steps, over the pixels still in a stage
(``perturb.live_pixels``).  ``stream_plain`` is the plain twin of one
such launch; ``lockstep_plain`` is the reference's schedule, stage after
stage in lockstep, kept as the yardstick of the new one.  All give the
reference's handoff bit for bit.  The state per pixel: dz (HDR-f32), the
remaining budget and ``ref_iter`` (int64), the node offset ``j``, the
stage ``s`` it steps in (−1: it has left the stages, or is done) and
``done``.
"""

from __future__ import annotations

import numpy as np
import torch

from fractalshark_tpu_torch import kernels
from fractalshark_tpu_torch.core.pointzoom import PointZoomBBConverter
from fractalshark_tpu_torch.ops import hdrfloat as hdr
from fractalshark_tpu_torch.ops import la_kernel
from fractalshark_tpu_torch.ops.hdrfloat import HDR, HDRComplex
from fractalshark_tpu_torch.ops.perturb import (_dc_grids_hdr, delta_params,
                                               live_pixels, on_subset)
from fractalshark_tpu_torch.ops.tables import ibits

# nodes per streamed window in the reference; here the unit of
# `launch_windows` (steps per pixel per launch = launch_windows · win)
WIN = 512
# steps a pixel per launch, counted across stages
DEFAULT_CHUNK_STEPS = 1 << 16

STATE = ("dzr", "dzi", "dze", "rem", "ref_iter", "j", "s", "done")
_DTYPES = (torch.float32, torch.float32, torch.int32, torch.int64,
           torch.int64, torch.int32, torch.int32, torch.bool)
# the handoff's arrays in a state (and in lockstep_plain's)
HANDOFF = ("dzr", "dzi", "dze", "rem", "ref_iter", "done")

# written by run_stages: launches ("dispatches"), the pixels each launch
# ran ("work") and, for the twin, the LA steps of all pixels ("steps")
last_run_stats: dict = {}


def _cheb_r(z: HDRComplex) -> HDR:
    return hdr.reduce(hdr.chebychev_norm(z))


def _step(T, dc: HDRComplex, dz: HDRComplex, node: torch.Tensor,
          rem: torch.Tensor, j: torch.Tensor, macro) -> tuple:
    """One LA step of every pixel at its node (la_stream.py:99-181):
    (usable, the node's NextStageLAIndex, its step length, the rebase
    flag, dz after the step)."""
    nodes_i = ibits(T.nodes)
    g, gi, sg = T.nodes[node], nodes_i[node], T.side[node]
    ref_n = HDRComplex(g[:, 0], g[:, 1], gi[:, 2])
    t = hdr.complex_add(hdr.complex_mul_pow2(ref_n, 1), dz)
    newdz = hdr.reduce_complex(hdr.complex_mul(t, dz))
    usable = (sg[:, 0] <= rem) & hdr.lt_unreduced(
        hdr.chebychev_norm(newdz), HDR(g[:, 9], gi[:, 10]))
    dz_ev = hdr.reduce_complex(hdr.complex_add(
        hdr.complex_mul(newdz, HDRComplex(g[:, 3], g[:, 4], gi[:, 5])),
        hdr.complex_mul(dc, HDRComplex(g[:, 6], g[:, 7], gi[:, 8]))))
    z_full = hdr.reduce_complex(hdr.complex_add(
        HDRComplex(g[:, 13], g[:, 14], gi[:, 15]), dz_ev))
    reb = hdr.lt_unreduced(hdr.chebychev_norm(z_full),
                           hdr.chebychev_norm(dz_ev)) | (j + 1 >= macro)
    return usable, sg[:, 1], sg[:, 0], reb, la_kernel._select(reb, z_full,
                                                              dz_ev)


def init_plain(T, dc: HDRComplex, max_iter: int) -> tuple:
    """The state before any LA step: the AT head skip (K2's,
    ``la_kernel.init_state_plain``), the remaining budget, stage S − 1
    (−1 where the skip used the budget) and done."""
    _, _, ref, dzr, dzi, dze, it, done = la_kernel.init_state_plain(
        T, dc, max_iter)
    s = torch.where(done, -1, T.stage_count - 1).to(torch.int32)
    return (dzr, dzi, dze, (max_iter - it).clamp(min=0), ref,
            torch.zeros_like(dze), s, done)


def stream_plain(T, dc: HDRComplex, state: tuple | None, max_iter: int,
                 chunk_steps: int = 0, steps_taken: list | None = None
                 ) -> tuple:
    """Plain twin of one K7 launch over the pixels of `dc` (state None:
    the first launch, from the AT skip): each pixel enters stage after
    stage and steps, at most `chunk_steps` steps (0 = no bound) counted
    across stages; a pixel stopped by the bound is left with its next
    stage entered.  Every pixel still in a stage takes one step per pass
    of the loop, so the passes count every pixel's steps; each pass's
    count of stepping pixels is appended to `steps_taken` if given."""
    first = state is None
    if first:
        state = init_plain(T, dc, max_iter)
    dzr, dzi, dze, rem, ref, j, s, done = state
    st_i = ibits(T.stages).to(torch.int64)
    heads, macros = st_i[:, 0], st_i[:, 1]
    thrc0 = HDR(T.stages[:, 2], st_i[:, 3].to(torch.int32))
    dc_cheb = _cheb_r(dc)
    act = torch.zeros_like(done) if first else s >= 0
    N = T.nodes.shape[0]
    steps = 0
    while True:
        while True:     # the pixels between stages enter their next one
            pend = (s >= 0) & ~act
            if not bool(pend.any()):
                break
            si = s.clamp(min=0).long()
            macro = macros[si]
            ok = pend & (macro > 0) & hdr.lt_reduced(
                dc_cheb, HDR(thrc0.m[si], thrc0.e[si]))
            act = act | ok
            j = torch.where(ok, torch.minimum(ref.clamp(min=0), macro - 1),
                            j).to(torch.int32)
            s = torch.where(pend & ~ok, s - 1, s)
        live = s >= 0
        if not bool(live.any()) or (chunk_steps and steps == chunk_steps):
            break
        steps += 1
        if steps_taken is not None:
            steps_taken.append(live.sum())
        si = s.clamp(min=0).long()
        node = (heads[si] + j.to(torch.int64)).clamp(max=N - 1)
        usable, nxt, length, reb, new = _step(
            T, dc, HDRComplex(dzr, dzi, dze), node, rem, j, macros[si])
        drop = live & ~usable
        stepx = live & usable
        ref = torch.where(drop, nxt, ref)
        dzr = torch.where(stepx, new.re, dzr)
        dzi = torch.where(stepx, new.im, dzi)
        dze = torch.where(stepx, new.e, dze)
        rem = torch.where(stepx, rem - length, rem)
        exhausted = stepx & (rem == 0)
        done = done | exhausted
        j = torch.where(stepx & ~exhausted, torch.where(reb, 0, j + 1), j)
        act = stepx & ~exhausted
        s = torch.where(drop, s - 1, torch.where(exhausted, -1, s))
    return (dzr, dzi, dze, rem, ref, j, s, done)


def lockstep_plain(T, dc: HDRComplex, max_iter: int,
                   chunk_steps: int = 0) -> tuple:
    """The reference's schedule: after the AT skip, stage after stage
    from coarse to fine, every pixel of the stage in lockstep, relaunched
    (in chunks of `chunk_steps` steps, 0 = none) until none steps in it.
    Returns (dzr, dzi, dze, rem, ref_iter, done)."""
    dzr, dzi, dze, rem, ref, j, _, done = init_plain(T, dc, max_iter)
    st_i = ibits(T.stages)
    dc_cheb = _cheb_r(dc)
    N = T.nodes.shape[0]
    for stage in reversed(range(T.stage_count)):
        head, macro = int(st_i[stage, 0]), int(st_i[stage, 1])
        thrc0 = HDR(T.stages[stage, 2].expand_as(dzr),
                    st_i[stage, 3].expand_as(dze))
        act = ~done & (macro > 0) & hdr.lt_reduced(dc_cheb, thrc0)
        j = ref.clamp(0, max(macro - 1, 0)).to(torch.int32)
        while bool(act.any()):
            steps = 0
            while bool(act.any()) and (chunk_steps == 0
                                       or steps < chunk_steps):
                steps += 1
                node = (head + j.to(torch.int64)).clamp(max=N - 1)
                usable, nxt, length, reb, new = _step(
                    T, dc, HDRComplex(dzr, dzi, dze), node, rem, j, macro)
                drop = act & ~usable
                stepx = act & usable
                ref = torch.where(drop, nxt, ref)
                dzr = torch.where(stepx, new.re, dzr)
                dzi = torch.where(stepx, new.im, dzi)
                dze = torch.where(stepx, new.e, dze)
                rem = torch.where(stepx, rem - length, rem)
                exhausted = stepx & (rem == 0)
                done = done | exhausted
                j = torch.where(stepx & ~exhausted,
                                torch.where(reb, 0, j + 1), j)
                act = stepx & ~exhausted
    return (dzr, dzi, dze, rem, ref, done)


def stream_kernel(T, dc: HDRComplex, state: tuple | None, max_iter: int,
                  chunk_steps: int, work=None) -> tuple:
    """Launch K7 once on a CUDA device over the pixels `work` (int32
    indices, ascending; None: every pixel).  With `state` None the launch
    is the first (the AT skip; `work` must be None) and allocates the
    state; the state is updated in place and returned."""
    dev = dc.re.device
    P = dc.re.numel()
    first = state is None
    if first:
        if work is not None:
            raise ValueError("K7's first launch runs every pixel")
        state = tuple(torch.empty(P, dtype=dt, device=dev) for dt in _DTYPES)
    for t, dt, name in zip(state, _DTYPES, STATE):
        if t.dtype != dt or t.numel() != P or t.device != dev \
                or not t.is_contiguous():
            raise ValueError(f"K7 state {name}: {t.dtype} {tuple(t.shape)}")
    tabs = (T.nodes, T.side, T.stages, T.at)
    for t in (*dc, *tabs):
        if t.device != dev or not t.is_contiguous():
            raise ValueError("K7 inputs must be contiguous on one device")
    if T.nodes.dtype != torch.float32 or dc.re.dtype != torch.float32:
        raise ValueError("K7 takes f32 mantissas")
    n_work = P
    if work is not None:
        if work.dtype != torch.int32 or work.device != dev \
                or not work.is_contiguous():
            raise ValueError("K7 work must be contiguous int32 on the device")
        n_work = work.numel()
    at = T.at if T.at.numel() else T.nodes  # never read when at_step == 0
    lib = kernels.lib()
    kernels.launches["la_stream"] += 1
    kernels.check(lib.fs_la_stream(
        *(t.data_ptr() for t in dc), T.nodes.data_ptr(), T.side.data_ptr(),
        T.stages.data_ptr(), at.data_ptr(), *(t.data_ptr() for t in state),
        None if work is None else work.data_ptr(), n_work, T.nodes.shape[0],
        T.stage_count, int(max_iter), int(chunk_steps), int(T.at_step),
        int(first), kernels.stream(dev)), "fs_la_stream")
    return state


def run_stages(T, dc: HDRComplex, max_iter: int, chunk_steps: int,
               abort_monitor=None, plain: bool | None = None) -> tuple:
    """The AT skip and every stage over flat pixel tensors: one launch
    over every pixel, then, while some pixel is still in a stage (it
    reached the launch's bound of `chunk_steps` steps), one over those
    pixels, the abort monitor polled between launches.  K7, or the plain
    twin where `plain` (default: for CPU tensors).  Returns the state."""
    if plain is None:
        plain = dc.re.device.type == "cpu"
    state, work, sizes, taken = None, None, [], []
    while True:
        sizes.append(dc.re.numel() if work is None else work.numel())
        if not plain:
            state = stream_kernel(T, dc, state, max_iter, chunk_steps, work)
        elif state is None:
            state = stream_plain(T, dc, None, max_iter, chunk_steps, taken)
        else:
            state = on_subset(
                lambda st, d: stream_plain(T, d, st, max_iter, chunk_steps,
                                           taken), state, dc, work)
        live = state[6] >= 0
        if not bool(live.any()) or (abort_monitor is not None
                                    and abort_monitor.aborted()):
            break
        work = live_pixels(~live)
    last_run_stats["dispatches"] = len(sizes)
    last_run_stats["work"] = sizes
    # the LA steps of every pixel (counted by the twin only)
    last_run_stats["steps"] = int(sum(taken)) if plain else None
    return state


def la_phase_stream(results, la, ptz: PointZoomBBConverter, width: int,
                    height: int, max_iter: int,
                    launch_windows: int | None = None, abort_monitor=None,
                    win: int | None = None, device="cuda"):
    """The AT skip and every LA stage, each pixel carried through all of
    them by one lane: K7 on a CUDA device, the plain twin on the CPU
    (``run_stages``).  Returns the tail handoff {dzr, dzi, dze,
    it, jwait, done} ([height, width] tensors on `device`), or None when
    the table has no stages or a node offset reaches 2^31 − 1, as the
    reference (``la_stream.py:397-405``).  Each launch runs at most
    `launch_windows` · `win` steps a pixel (default 65,536)."""
    device = kernels.resolve_device(device)
    arrs = la.device_arrays(np.float32)
    if int(arrs["stage_count"]) == 0:
        return None
    nsi = arrs["next_stage_la_index"]
    if len(nsi) and int(nsi.max()) >= (1 << 31) - 1:
        return None
    chunk = DEFAULT_CHUNK_STEPS if launch_windows is None \
        else int(launch_windows) * (WIN if win is None else int(win))
    T = la_kernel.la_tables_on(la, device)
    dx, dy, cxo, cyo = delta_params(ptz, results.center_x, results.center_y,
                                    width, height)
    dc = _dc_grids_hdr(dx, dy, cxo, cyo, width, height, device)
    flat = HDRComplex(*(t.reshape(-1).contiguous() for t in dc))
    state = run_stages(T, flat, max_iter, chunk, abort_monitor)
    dzr, dzi, dze, rem, ref, _, _, done = (
        t.reshape(height, width) for t in state)
    return {"dzr": dzr, "dzi": dzi, "dze": dze, "it": max_iter - rem,
            "jwait": ref, "done": done}
