"""The streaming perturbation renders with the pixel rows sharded over a
mesh: the port of ``fractalshark_tpu/parallel/stream_render.py``.

The JAX package wraps one bounded launch of its Pallas kernels (B11, B3)
in ``shard_map`` per device (``:37-58``, ``:152-173``).  Here each rank
runs its rows' slab through the single-device kernels' launches: K6
(``csrc/perturb.cu``, B11's route ``perturb_stream``) over the slab of
the dc grids, and for the RC form K3 (``csrc/rc_tail.cu``) over the
compressed anchors, which every rank holds (``perturb_stream.anchors_on``).
The orbit, the anchors and the scalars are replicated.

The launch loop stays on the host, as in the single-device wrappers, each
launch after the first over the slab's live pixels; after every launch
the ranks agree in one ``all_reduce`` whether every slab is done and
whether any rank's ``abort_monitor`` fired, and all stop together (a rank
that stopped alone would leave the others waiting at the gather).  A rank
whose slab is done, or empty, launches nothing and keeps voting.  Any
height and width: the slabs are ceil(H/M) rows, the last ones shorter or
empty.  Each returns the whole int64 frame on every rank.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from fractalshark_tpu_torch.core.pointzoom import PointZoomBBConverter
from fractalshark_tpu_torch.ops import hdrfloat as hdr
from fractalshark_tpu_torch.ops import perturb
from fractalshark_tpu_torch.ops import perturb_stream as PS
from fractalshark_tpu_torch.ops.hdrfloat import HDRComplex
from fractalshark_tpu_torch.ops.tables import orbit_on
from fractalshark_tpu_torch.parallel import mesh as PM
from fractalshark_tpu_torch.parallel.mesh import Mesh
from fractalshark_tpu_torch.parallel.render import (dc_slab, gather_rows,
                                                    slab)

__all__ = ["sharded_perturb_render_stream",
           "sharded_perturb_render_stream_rc"]

# written after every render: this rank's launches ("dispatches") and the
# rounds of the agreement ("rounds")
last_run_stats: dict = {}


def _agree(mesh: Mesh, done: bool, abort_monitor) -> bool:
    """Whether every rank is done or any rank aborted (one all_reduce)."""
    aborted = abort_monitor is not None and abort_monitor.aborted()
    v = torch.tensor([0 if done else 1, int(aborted)], dtype=torch.int32,
                     device=mesh.device)
    v = PM.all_reduce(mesh, v, dist.ReduceOp.MAX)
    return int(v[0]) == 0 or int(v[1]) == 1


def _run(mesh: Mesh, pixels: int, launch, abort_monitor) -> tuple:
    """The launch loop: ``launch(state, work)`` (state None and work None
    the first time) until the ranks agree; returns the final state."""
    state, work, launches, rounds = None, None, 0, 0
    while True:
        if pixels and (work is None or work.numel()):
            state = launch(state, work)
            launches += 1
        rounds += 1
        done = not pixels or bool(state[-1].all())
        if _agree(mesh, done, abort_monitor):
            break
        if not done:
            work = perturb.live_pixels(state[-1])
    last_run_stats.update(dispatches=launches, rounds=rounds)
    return state


def _chunk(launch_windows, device) -> int:
    if launch_windows is not None:
        return int(launch_windows) * PS.WIN
    return PS.DEFAULT_CHUNK_STEPS if device.type == "cuda" else 0


def sharded_perturb_render_stream(results, ptz: PointZoomBBConverter,
                                  width: int, height: int, max_iter: int,
                                  mesh: Mesh,
                                  launch_windows: int | None = None,
                                  abort_monitor=None) -> torch.Tensor:
    """``perturb_stream.perturb_render_stream`` with the rows sharded over
    the mesh (bit-identical frame on every rank)."""
    dev = mesh.device
    y0, h = slab(height, mesh, even=False)
    dc = dc_slab(results.center_x, results.center_y, ptz, width, height, y0,
                 h, dev)
    flat = HDRComplex(*(t.reshape(-1).contiguous() for t in dc))
    orbit = orbit_on(results, dev, torch.float32)
    max_ref = results.max_ref_iteration()
    chunk = _chunk(launch_windows, dev)

    def launch(state, work):
        if dev.type == "cuda":
            return perturb.perturb_kernel(orbit, flat, state, max_iter,
                                          max_ref, True, chunk,
                                          "perturb_stream", work)
        if state is None:
            state = perturb.init_state_plain(flat, max_iter, True)
        return perturb.on_subset(
            lambda st, d: perturb.perturb_plain(orbit, d, st, max_iter,
                                                max_ref, True, chunk),
            state, flat, work)

    state = _run(mesh, h * width, launch, abort_monitor)
    part = state[4].reshape(h, width) if h else torch.zeros(
        0, width, dtype=torch.int64, device=dev)
    return gather_rows(part, height, mesh)


def sharded_perturb_render_stream_rc(compressed, center_x, center_y,
                                     ptz: PointZoomBBConverter, width: int,
                                     height: int, max_iter: int, mesh: Mesh,
                                     launch_windows: int | None = None,
                                     abort_monitor=None):
    """``perturb_stream.perturb_render_stream_rc`` (K3 over the compressed
    anchors, from the zero state: fresh renders only) with the rows
    sharded over the mesh; None for an orbit without anchors, as the JAX
    package returns."""
    if len(compressed.anchors_x) == 0:
        return None
    dev = mesh.device
    y0, h = slab(height, mesh, even=False)
    A = PS.anchors_on(compressed, dev)
    z_mr = PS.wrap_value(compressed, A.max_ref)
    dc = dc_slab(center_x, center_y, ptz, width, height, y0, h, dev)
    flat = HDRComplex(*(t.reshape(-1).contiguous() for t in dc))
    chunk = _chunk(launch_windows, dev)
    z = hdr.complex_zero((h * width,), device=dev)
    zeros = torch.zeros(h * width, dtype=torch.int64, device=dev)
    init = {"dzr": z.re, "dzi": z.im, "dze": z.e, "it": zeros,
            "jwait": zeros, "done": zeros.bool()}

    def launch(state, work):
        if state is None:
            state = PS.handoff_state(A, init, dev)
            if dev.type == "cpu":
                state = PS.rc_init_plain(A, state, max_iter, z_mr)
        if dev.type == "cuda":
            return PS.rc_tail_kernel(A, flat, state, max_iter, z_mr, chunk,
                                     init=work is None, work=work)
        return perturb.on_subset(
            lambda st, d: PS.rc_tail_plain(A, d, st, chunk), state, flat,
            work)

    state = _run(mesh, h * width, launch, abort_monitor)
    part = (max_iter - state[3]).reshape(h, width) if h else torch.zeros(
        0, width, dtype=torch.int64, device=dev)
    return gather_rows(part, height, mesh)
