"""The streaming LA phase: the port of ``fractalshark_tpu/ops/la_stream.py``
(``la_phase_stream``, B12) through kernel K7 (``csrc/la_stream.cu``).

Phase 1 of the two-phase LAv2 render, stage by stage from coarse to
fine, as the pixel-identical alternative to K2's one-machine phase 1
(``FRACTALSHARK_LA_PHASE=stream``, ``engine/renderers.py``).  The host
side is the reference's (``la_stream.py:386-499``): the AT head skip,
stages from coarse to fine, a pixel taking part in stage s iff it is not
done and |dc| is below the stage's first LAThresholdC, its entry offset
the ``ref_iter`` handed down (clipped to [0, macro − 1]), relaunches
until no pixel still steps in the stage, and the abort monitor polled
between launches.  The result is the tail handoff
``{dzr, dzi, dze, it, jwait, done}`` that
``perturb_stream.perturb_render_stream_rc(init_state=...)`` takes.

The reference sweeps each stage's nodes in lockstep and lets pixels
stall until the sweep reaches their offset; K7 steps each pixel's own
offset (see ``csrc/la_stream.cu``), and the plain twin steps every pixel
in lockstep over flat tensors.  Both give the reference's state bit for
bit.  The machine state per pixel: dz (HDR-f32), the remaining budget
and ``ref_iter`` (int64), the node offset ``j``, ``act`` (still stepping
in this stage) and ``done``.
"""

from __future__ import annotations

import numpy as np
import torch

from fractalshark_tpu_torch import kernels
from fractalshark_tpu_torch.core.pointzoom import PointZoomBBConverter
from fractalshark_tpu_torch.ops import hdrfloat as hdr
from fractalshark_tpu_torch.ops import la_kernel
from fractalshark_tpu_torch.ops.hdrfloat import HDR, HDRComplex
from fractalshark_tpu_torch.ops.perturb import _dc_grids_hdr, delta_params
from fractalshark_tpu_torch.ops.tables import ibits

# nodes per streamed window in the reference; here the unit of
# `launch_windows` (steps per pixel per launch = launch_windows · win)
WIN = 512
DEFAULT_CHUNK_STEPS = 1 << 16

_STATE = ("dzr", "dzi", "dze", "rem", "ref_iter", "j", "act", "done")
_DTYPES = (torch.float32, torch.float32, torch.int32, torch.int64,
           torch.int64, torch.int32, torch.bool, torch.bool)
_MODES = {"init": 0, "enter": 1, "step": 2}


def init_plain(T, dc: HDRComplex, max_iter: int) -> tuple:
    """Plain twin of K7's init launch: the AT head skip (K2's,
    ``la_kernel.init_state_plain``), the remaining budget and done."""
    _, _, ref, dzr, dzi, dze, it, done = la_kernel.init_state_plain(
        T, dc, max_iter)
    j = torch.zeros_like(dze)
    return (dzr, dzi, dze, (max_iter - it).clamp(min=0), ref, j,
            torch.zeros_like(done), done)


def stage_plain(T, dc: HDRComplex, state: tuple, stage: int, enter: bool,
                chunk_steps: int = 0) -> tuple:
    """Plain twin of K7's stage launch: every pixel of the stage in
    lockstep for at most `chunk_steps` steps (0 = until none steps)."""
    dzr, dzi, dze, rem, ref, j, act, done = state
    st_i = ibits(T.stages[stage])
    head, macro = int(st_i[0]), int(st_i[1])
    if enter:
        thrc0 = HDR(T.stages[stage, 2].expand_as(dzr),
                    st_i[3].expand_as(dze))
        act = ~done & (macro > 0) & hdr.lt_reduced(la_kernel._cheb_r(dc),
                                                   thrc0)
        j = ref.clamp(0, max(macro - 1, 0)).to(torch.int32)
    nodes_i = ibits(T.nodes)
    N = T.nodes.shape[0]
    steps = 0
    while bool(act.any()) and (chunk_steps == 0 or steps < chunk_steps):
        steps += 1
        node = (head + j.to(torch.int64)).clamp(max=N - 1)
        g, gi, sg = T.nodes[node], nodes_i[node], T.side[node]
        dz = HDRComplex(dzr, dzi, dze)
        ref_n = HDRComplex(g[:, 0], g[:, 1], gi[:, 2])
        t = hdr.complex_add(hdr.complex_mul_pow2(ref_n, 1), dz)
        newdz = hdr.reduce_complex(hdr.complex_mul(t, dz))
        usable = (sg[:, 0] <= rem) & hdr.lt_unreduced(
            hdr.chebychev_norm(newdz), HDR(g[:, 9], gi[:, 10]))
        drop = act & ~usable
        stepx = act & usable
        ref = torch.where(drop, sg[:, 1], ref)
        dz_ev = hdr.reduce_complex(hdr.complex_add(
            hdr.complex_mul(newdz, HDRComplex(g[:, 3], g[:, 4], gi[:, 5])),
            hdr.complex_mul(dc, HDRComplex(g[:, 6], g[:, 7], gi[:, 8]))))
        z_full = hdr.reduce_complex(hdr.complex_add(
            HDRComplex(g[:, 13], g[:, 14], gi[:, 15]), dz_ev))
        reb = hdr.lt_unreduced(hdr.chebychev_norm(z_full),
                               hdr.chebychev_norm(dz_ev)) | (j + 1 >= macro)
        new = la_kernel._select(reb, z_full, dz_ev)
        dzr = torch.where(stepx, new.re, dzr)
        dzi = torch.where(stepx, new.im, dzi)
        dze = torch.where(stepx, new.e, dze)
        rem = torch.where(stepx, rem - sg[:, 0], rem)
        exhausted = stepx & (rem == 0)
        done = done | exhausted
        j = torch.where(stepx & ~exhausted, torch.where(reb, 0, j + 1), j)
        act = stepx & ~exhausted
    return (dzr, dzi, dze, rem, ref, j, act, done)


def stage_kernel(T, dc: HDRComplex, state: tuple | None, stage: int,
                 mode: str, max_iter: int, chunk_steps: int) -> tuple:
    """Launch K7 once on a CUDA device (mode init, enter or step); with
    `state` None the state is allocated (init).  The state is updated in
    place and returned."""
    dev = dc.re.device
    P = dc.re.numel()
    if state is None:
        state = tuple(torch.empty(P, dtype=dt, device=dev) for dt in _DTYPES)
    for t, dt, name in zip(state, _DTYPES, _STATE):
        if t.dtype != dt or t.numel() != P or t.device != dev \
                or not t.is_contiguous():
            raise ValueError(f"K7 state {name}: {t.dtype} {tuple(t.shape)}")
    tabs = (T.nodes, T.side, T.stages, T.at)
    for t in (*dc, *tabs):
        if t.device != dev or not t.is_contiguous():
            raise ValueError("K7 inputs must be contiguous on one device")
    if T.nodes.dtype != torch.float32 or dc.re.dtype != torch.float32:
        raise ValueError("K7 takes f32 mantissas")
    at = T.at if T.at.numel() else T.nodes  # never read when at_step == 0
    lib = kernels.lib()
    kernels.launches["la_stream"] += 1
    kernels.check(lib.fs_la_stream(
        *(t.data_ptr() for t in dc), T.nodes.data_ptr(), T.side.data_ptr(),
        T.stages.data_ptr(), at.data_ptr(), *(t.data_ptr() for t in state),
        P, T.nodes.shape[0], stage, int(max_iter), int(chunk_steps),
        int(T.at_step), _MODES[mode], kernels.stream(dev)), "fs_la_stream")
    return state


def run_stages(T, dc: HDRComplex, max_iter: int, chunk_steps: int,
               abort_monitor=None, plain: bool | None = None) -> tuple:
    """The init launch, then every stage from coarse to fine, relaunched
    until no pixel steps in it (or an abort), over flat pixel tensors:
    K7, or the plain twin where `plain` (default: for CPU tensors).
    Returns the state."""
    if plain is None:
        plain = dc.re.device.type == "cpu"

    def run(state, stage, mode):
        if not plain:
            return stage_kernel(T, dc, state, stage, mode, max_iter,
                                chunk_steps)
        if mode == "init":
            return init_plain(T, dc, max_iter)
        return stage_plain(T, dc, state, stage, mode == "enter", chunk_steps)

    state = run(None, 0, "init")
    for s in reversed(range(T.stage_count)):
        mode = "enter"
        while True:
            state = run(state, s, mode)
            mode = "step"
            if not bool(state[6].any()) or (abort_monitor is not None
                                            and abort_monitor.aborted()):
                break
    return state


def la_phase_stream(results, la, ptz: PointZoomBBConverter, width: int,
                    height: int, max_iter: int,
                    launch_windows: int | None = None, abort_monitor=None,
                    win: int | None = None, device="cuda"):
    """AT skip and every LA stage, stage by stage: K7 on a CUDA device,
    the plain twin on the CPU.  Returns the tail handoff {dzr, dzi, dze,
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
