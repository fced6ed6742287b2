#!/usr/bin/env python3
"""Time the port's per-pixel loops, K6 (``csrc/perturb.cu``), K2
(``csrc/lav2.cu``), the two-phase tail (K6 resumed from K2's handoff),
K3 (``csrc/rc_tail.cu``), K1 and K1-seq (``csrc/escape.cu``), the
streaming LA phase K7 (``csrc/la_stream.cu``), the HDR and double-float
escapes K13 and K14 (``csrc/escape_hdr.cu``, ``csrc/escape_df.cu``), the
BLA render K15 (``csrc/bla.cu``), K6's glitch instance (the Scaled
family's f32 pass), the HDR double-float perturbation render K16
(``csrc/perturb_hdr_df.cu``) and the quad-float escapes K17 and K18
(``csrc/escape_quad.cu``), at the main path's full budgets on one NVIDIA
card.

    python3 tools/time_pixel_loops.py [--tree DIR] [--reps N] [--cli]
                                      [--profile] [--trace] [--no-floor]
                                      [--only NAME ...]

For each frame it builds the orbit, the LA table and the dc grid through
the port's engine (a tail frame also runs K2's la_only phase 1, untimed),
then runs the frame's kernel to the end (every chunked launch,
``perturb.perturb_run`` / ``la_kernel.lav2_run`` /
``perturb_stream.rc_tail_run``, the sequence's one launch, or K1's
frame through ``escape.escape``) under CUDA
events, ``--reps`` times after one warm-up run, and prints one JSON line
per frame: the times (ms), the launches of one run, the pixels each
launch ran, the iter_sum and the CRC-32 of the grid as ``<u4``.  The
2048² tail's iter_sum is pinned (``PINS``).  It also prints the
registers and spills ``ptxas -v`` reports for K6, K2, K16, K17 and K18,
and the
serial floor: the per-step time of K6 on one pixel with a one-row orbit
(``max_ref`` = 1, every step rebases onto row 0) that never escapes
(c = -0.5), in each of K6's four forms, and the same pixel walking an
orbit of 2^20 zero rows (a new row every step, no rebase).
K3's serial floor is its time per step on one such pixel over a zero
orbit of 2^20 positions, with an anchor at every position and with
anchor 0 alone (every step reconstructs).  ``--profile`` adds the pixels
still live after each launch and the deepest pixel's body steps (K2,
from launches of 64 steps) or tail steps with its serial floor (the
tail at K6's HDR-f32 floor, K3 at its floor with an anchor every step),
or K7's LA steps and its bound (``stream_profile``);
``--no-floor`` skips the serial floors.  ``--trace`` adds, for each
frame, a run under ``torch.profiler`` (``trace_call``: the fullest of
three traces): the sum of its CUDA kernels' intervals, their count, and
the host syncs of the run (``torch.cuda.set_sync_debug_mode``'s
warnings).  ``--cli`` renders the
frames the smoke pins (View #6 PO 256², View #5 1024², View #6 256² with
``FRACTALSHARK_LA_PHASE=stream``) through the CLI, twice each in this
process, and prints their iter_sum, crc32 and timings.

``--tree DIR`` imports ``fractalshark_tpu_torch`` from DIR (another
checkout, e.g. a ``git archive`` of the parent commit), so two versions
can be timed in turns in one run on one card.  Needs a CUDA device.

``chip_smoke.py`` times the same frames through ``setup``,
``time_frame``, ``serial_floor`` and ``rc_floor`` below, so the two
report one measurement.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import itertools
import json
import os
import statistics
import subprocess
import sys
import types
import zlib

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# the small-table deep frame of chip_smoke.py (its budget)
SMALL_DEEP = ("-0.743643887037158704752191506114774",
              "0.131825904205311970493132056385139", "1e8", 2000)

# the render families' frames: the integration sweep's shallow frame at
# its budget, and the 1e8 frame at the sweep's (tests/test_integration.py)
SHALLOW = ("-0.6", "0.45", "64", 256)
DEEP_1500 = SMALL_DEEP[:3] + (1500,)

# the quad-float escapes' frame: the 1e17 frame of tests/test_quadflt.py
# (every pixel runs the budget)
QUAD_1E17 = ("-0.743643887037151", "0.131825904205330", "1e17", 600)

# name: (frame, size, kernel, launch-counter key, mantissa, hdr_mode /
# la_only / budget)
FRAMES = {
    "view6_po_16": (6, 16, "k6", "perturb_stream", "f32", True),
    "view6_po_256": (6, 256, "k6", "perturb_stream", "f32", True),
    "view2_f64_64": (2, 64, "k6", "perturb_f64", "f64", False),
    "view2_f64_256": (2, 256, "k6", "perturb_f64", "f64", False),
    "view2_hdr64_64": (2, 64, "k6", "perturb_hdr64", "f64", True),
    "1e8_pallas_64": (SMALL_DEEP, 64, "k6", "perturb_pallas", "f32", True),
    "1e8_f32_64": (SMALL_DEEP, 64, "k6", "perturb_f32", "f32", False),
    "1e8_full_64": (SMALL_DEEP, 64, "k2", "lav2_full", "f32", False),
    # more pixels than the card has lanes: K2 runs its phases apart
    "1e8_full_1024": (SMALL_DEEP, 1024, "k2", "lav2_full", "f32", False),
    "view6_phase1_256": (6, 256, "k2", "lav2_phase1", "f32", True),
    "view6_phase1_1024": (6, 1024, "k2", "lav2_phase1", "f32", True),
    "view5_f64_64": (5, 64, "k2", "lav2_full_f64", "f64", False),
    "view5_f64_256": (5, 256, "k2", "lav2_full_f64", "f64", False),
    "view5_f64_1024": (5, 1024, "k2", "lav2_full_f64", "f64", False),
    # its LA phase alone (la_only: each pixel is done when it leaves the
    # LA stages)
    "view5_f64_1024_la": (5, 1024, "k2", "lav2_lao_f64", "f64", True),
    "view3_lao_64": (3, 64, "k2", "lav2_lao_f64", "f64", True),
    # the two-phase tail over the uncompressed orbit (K6 resumed; in a
    # tree from before it, K3 over identity anchors) from K2's la_only
    # handoff, phase 1 untimed
    "view6_tail_256": (6, 256, "tail", "two_phase_tail", "f32", True),
    "view6_tail_2048": (6, 2048, "tail", "two_phase_tail", "f32", True),
    # K3 over a compressed orbit (error_exp, from K2's handoff or from the
    # zero state): the RC LAv2 tail and the RC PO render
    "view6_rc_64": (6, 64, "k3", "rc_tail", "f32", (8, True)),
    "view6_rc_256": (6, 256, "k3", "rc_tail", "f32", (20, True)),
    # more pixels than the card has lanes: K3's work-queue form
    "view6_rc_1024": (6, 1024, "k3", "rc_tail", "f32", (20, True)),
    "view6_rc_po_16": (6, 16, "k3", "rc_tail", "f32", (20, False)),
    "view6_rc_po_256": (6, 256, "k3", "rc_tail", "f32", (20, False)),
    # K1-seq: the View 0 zoom sequence (8 frames, 1.3x each, 512
    # iterations, f32)
    "seq_4096": (0, 4096, "seq", "escape_seq", "f32", (8, 1.3, 512)),
    # K1, one frame through escape.escape as the CLI renders View 0: the
    # f32 tile (Gpu1x32), escape_jax's f64 loop (Gpu1x64), and the tile
    # at 4096² x 512, where the device time outweighs the call (budget)
    "view0_1024_f32": (0, 1024, "k1", "escape", "f32", 256),
    "view0_1024_f64": (0, 1024, "k1", "escape", "f64", 256),
    "view0_4096_f32": (0, 4096, "k1", "escape", "f32", 512),
    # K7: the streaming LA phase (AT skip and every stage, la_stream.
    # run_stages); 1024² has more pixels than the card has lanes
    "1e8_stream_64": (SMALL_DEEP, 64, "k7", "la_stream", "f32", None),
    "view6_stream_256": (6, 256, "k7", "la_stream", "f32", None),
    "view6_stream_1024": (6, 1024, "k7", "la_stream", "f32", None),
    # K13 and K14 (escape.escape's neighbours: the HDR and double-float
    # direct escapes), K15 (the BLA render, at the sweep's budget and at
    # View #6's preset budget) and K6's glitch instance (the Scaled
    # family's f32 pass)
    "shallow_hdr32_1024": (SHALLOW, 1024, "k13", "escape_hdr32", "f32", None),
    "shallow_hdr64_1024": (SHALLOW, 1024, "k13", "escape_hdr64", "f64", None),
    "shallow_2x32_1024": (SHALLOW, 1024, "k14", "escape_2x32", "f32", None),
    "shallow_2x64_1024": (SHALLOW, 1024, "k14", "escape_2x64", "f64", None),
    "1e8_bla_f32_1024": (DEEP_1500, 1024, "k15", "bla_f32", "f32", None),
    "1e8_bla_f64_1024": (DEEP_1500, 1024, "k15", "bla_f64", "f64", None),
    "view6_bla_256": (6, 256, "k15", "bla_f32", "f32", None),
    "1e8_scaled_1024": (DEEP_1500, 1024, "glitch", "perturb_scaled", "f32",
                        None),
    # K16 (the 2x32 / hdr2x32 names without an LA table): the 1e8 frame,
    # and View #9 at the budget of the depth band HDRx2x32 exists for
    # (tests/test_hdr_df.py:79-101)
    "1e8_hdr_df_64": (DEEP_1500, 64, "k16", "perturb_hdr_df", "f32", None),
    "view9_hdr_df_1024": (9, 1024, "k16", "perturb_hdr_df", "f32", 40000),
    # K17 (QD, Gpu4x32/Gpu4x64) and K18 (QF, escape_qf) on the 1e17 frame
    "1e17_qd32_1024": (QUAD_1E17, 1024, "k17", "escape_4x32", "f32", None),
    "1e17_qd64_1024": (QUAD_1E17, 1024, "k17", "escape_4x64", "f64", None),
    "1e17_qf32_1024": (QUAD_1E17, 1024, "k18", "escape_qf32", "f32", None),
    "1e17_qf64_1024": (QUAD_1E17, 1024, "k18", "escape_qf64", "f64", None),
}

# iter_sum of frames pinned to a reference: the 2048² poster's two-phase
# grid (the JAX package's TPU run, BENCH_r05.json deep_poster_iter_sum)
PINS = {"view6_tail_2048": 3_347_387_150_394}

# label: (argv, environment variables set around the render)
CLI_FRAMES = {
    "View #6 GpuHDRx32PerturbedLAv2PO 256²": ([
        "--view", "6", "--render-algorithm", "GpuHDRx32PerturbedLAv2PO",
        "--width", "256", "--height", "256"], {}),
    "View #5 AUTO 1024²": (["--view", "5", "--width", "1024", "--height",
                            "1024"], {}),
    # phase 1 as K7 (the smoke pins its frame to the two-phase one)
    "View #6 256² FRACTALSHARK_LA_PHASE=stream": ([
        "--view", "6", "--width", "256", "--height", "256"],
        {"FRACTALSHARK_LA_PHASE": "stream"}),
}

FLOOR_STEPS = 1 << 20
# the streaming floor: the same pixel over this many rows of a zero orbit
# (dz <- dz^2 + dc stays small, |z| = |dz|: no rebase), which it walks one
# row a step until max_ref: the per-step time with a new row every step
STREAM_ROWS = 1 << 20


def log(msg: str) -> None:
    print(msg, flush=True)


def crc(grid) -> int:
    return zlib.crc32(grid.cpu().numpy().astype("<u4").tobytes())


def ptxas_lines(text: str) -> list[str]:
    """The ptxas -v lines of the K6, K2, K16, K17 and K18 entry
    functions."""
    out, keep = [], 0
    for line in text.splitlines():
        if "Compiling entry function" in line:
            keep = 4 if ("perturb" in line or "lav2" in line
                         or "QuadRule" in line) else 0
        if keep:
            out.append(line.strip())
            keep -= 1
    return out


def frame_inputs(frame, size, device, budget=None):
    """The Fractal and the reference orbit of a frame (a preset index or
    a (x, y, zoom, budget) tuple) at size², via the engine; `budget`
    replaces a preset's."""
    from fractalshark_tpu_torch.core.pointzoom import PointZoomBBConverter
    from fractalshark_tpu_torch.engine.fractal import Fractal
    from fractalshark_tpu_torch.engine.renderers import get_orbit_calc

    if isinstance(frame, int):
        f = Fractal(width=size, height=size, view=frame, device=device)
    else:
        x, y, zoom, n = frame
        f = Fractal(width=size, height=size, num_iterations=n,
                    view=PointZoomBBConverter(pt_x=x, pt_y=y,
                                              zoom_factor=zoom, prec=512),
                    device=device)
    if budget is not None:
        f.num_iterations = budget
    res = get_orbit_calc(f).get_and_create_useful_results(f.ptz,
                                                          f.num_iterations)
    return f, res


def setup(name, device):
    """A frame of FRAMES on `device`: its inputs (orbit, dc grid, for K2
    the LA tables T), its budget n and max_ref mr, and ``run(budget=None,
    chunk_steps=None)``, which runs its kernel through its run loop (on
    the card: the kernel; on the CPU: the plain twin) and returns the
    int64 grid (K6, the tail, K3), the state (K2) or the int32 frames
    (K1-seq).  The tail and K3 frames also have ``plain(budget)``, their
    twin in one lockstep run (the grid, flat)."""
    import torch

    from fractalshark_tpu_torch.engine.la_reference import get_or_build_la
    from fractalshark_tpu_torch.ops import la_kernel, perturb
    from fractalshark_tpu_torch.ops.tables import orbit_on

    frame, size, kern, key, mant, mode = FRAMES[name]
    if kern == "seq":
        return _setup_seq(name, device)
    if kern == "k1":
        return _setup_k1(name, device)
    if kern in ("k13", "k14", "k17", "k18"):
        return _setup_direct(name, device)
    fdt = torch.float32 if mant == "f32" else torch.float64
    f, res = frame_inputs(frame, size, device,
                          mode if kern == "k16" else None)
    n, mr = f.num_iterations, res.max_ref_iteration()
    dpar = perturb.delta_params(f.ptz, res.center_x, res.center_y, size,
                                size)
    fr = types.SimpleNamespace(name=name, kern=kern, key=key, size=size,
                               dtype=fdt, mode=mode, n=n, mr=mr, T=None)
    if kern in ("tail", "k3"):
        return _setup_tail(fr, f, res, dpar, device)
    if kern == "k7":
        return _setup_stream(fr, f, res, dpar, device)
    if kern in ("k15", "glitch"):
        return _setup_family(fr, res, dpar, device)
    if kern == "k16":
        return _setup_hdr_df(fr, res, dpar, device)
    if kern == "k6":
        fr.orbit = orbit_on(res, device, fdt)
        grids = perturb._dc_grids_hdr if mode else perturb._dc_grids_float
        fr.dc = grids(*dpar, size, size, device, fdt)

        def run(budget=None, chunk_steps=None):
            return perturb.perturb_run(fr.orbit, fr.dc, budget or n, mr,
                                       mode, key, chunk_steps)
    else:
        fr.T, fr.orbit = la_kernel.device_tables(
            res, get_or_build_la(f, res), device, fdt)
        fr.dc = perturb._dc_grids_hdr(*dpar, size, size, device, fdt)

        def run(budget=None, chunk_steps=None):
            return la_kernel.lav2_run(fr.T, fr.orbit, fr.dc, budget or n, mr,
                                      mode, chunk_steps)
    fr.run = run
    return fr


def _setup_tail(fr, f, res, dpar, device):
    """The two-phase tail (K6 resumed from K2's handoff) or K3 (over a
    compressed orbit, from K2's handoff or the zero state)."""
    import torch

    from fractalshark_tpu_torch.engine.la_reference import get_or_build_la
    from fractalshark_tpu_torch.engine.perturbation_results import (
        CompressedOrbit)
    from fractalshark_tpu_torch.ops import hdrfloat as hdr
    from fractalshark_tpu_torch.ops import la_kernel, perturb
    from fractalshark_tpu_torch.ops import perturb_stream as ps
    from fractalshark_tpu_torch.ops.hdrfloat import HDRComplex
    from fractalshark_tpu_torch.ops.tables import orbit_on

    size, n, mr = fr.size, fr.n, fr.mr
    la = get_or_build_la(f, res)
    fr.dc = perturb._dc_grids_hdr(*dpar, size, size, device)
    flat = HDRComplex(*(t.reshape(-1) for t in fr.dc))
    handoffs = {}

    def handoff(budget):
        """K2's la_only handoff at `budget` (phase 1, run once a budget)."""
        if budget not in handoffs:
            s = la_kernel.la_perturb_render(res, la, f.ptz, size, size,
                                            budget, la_only=True,
                                            return_state=True, device=device)
            handoffs[budget] = {"dzr": s[3], "dzi": s[4], "dze": s[5],
                                "it": s[6], "jwait": s[2],
                                "done": s[6] >= budget}
        return handoffs[budget]

    def zero(_budget):
        """The zero state (perturb_render_stream_rc without a handoff)."""
        dz = hdr.complex_zero((size, size), device=device)
        z = torch.zeros((size, size), dtype=torch.int64, device=device)
        return {"dzr": dz.re, "dzi": dz.im, "dze": dz.e, "it": z,
                "jwait": z, "done": z.bool()}

    if fr.kern == "tail" and hasattr(perturb, "handoff_plain"):
        fr.orbit = orbit_on(res, device)

        def run(budget=None, chunk_steps=None):
            b = budget or n
            return perturb.perturb_run(
                fr.orbit, fr.dc, b, mr, True, fr.key, chunk_steps,
                state=perturb.handoff_state(handoff(b), device),
                handoff=True)

        def plain(budget):
            st = perturb.handoff_plain(fr.orbit, perturb.handoff_state(
                handoff(budget), device), budget, mr)
            return perturb.perturb_plain(fr.orbit, flat, st, budget, mr,
                                         True)[4]
    else:
        # K3: a compressed orbit, or identity anchors for the tail in a
        # tree from before K6 took it
        err, from_handoff = fr.mode if fr.kern == "k3" else (None, True)
        if err is None:
            comp, fr.key = CompressedOrbit.identity(res), "rc_tail"
        else:
            comp = CompressedOrbit.from_uncompressed(res, error_exp=err)
        fr.comp = comp
        fr.A = ps.anchors_on(comp, device)
        z_mr = ps.wrap_value(comp, fr.A.max_ref)
        init = handoff if from_handoff else zero

        def run(budget=None, chunk_steps=None):
            b = budget or n
            return b - ps.rc_tail_run(fr.A, fr.dc, init(b), b, z_mr,
                                      chunk_steps).reshape(size, size)

        def plain(budget):
            st = ps.rc_init_plain(fr.A, ps.handoff_state(
                fr.A, init(budget), device), budget, z_mr)
            return budget - ps.rc_tail_plain(fr.A, flat, st)[3]
    fr.run, fr.plain = run, plain
    # the completed iterations on entry to the tail, at the full budget
    fr.start = handoff(n)["it"] if fr.kern == "tail" or fr.mode[1] else \
        torch.zeros((size, size), dtype=torch.int64, device=device)
    return fr


def _setup_stream(fr, f, res, dpar, device):
    """K7: the AT skip and every LA stage over the frame's pixels
    (``la_stream.run_stages``, the chunk the main path uses); its result
    is the state, whose fourth array is the remaining budget."""
    from fractalshark_tpu_torch.engine.la_reference import get_or_build_la
    from fractalshark_tpu_torch.ops import la_kernel, perturb
    from fractalshark_tpu_torch.ops import la_stream as LS
    from fractalshark_tpu_torch.ops.hdrfloat import HDRComplex

    fr.T = la_kernel.la_tables_on(get_or_build_la(f, res), device)
    fr.dc = perturb._dc_grids_hdr(*dpar, fr.size, fr.size, device)
    flat = HDRComplex(*(t.reshape(-1).contiguous() for t in fr.dc))

    def run(budget=None, chunk_steps=None):
        return LS.run_stages(fr.T, flat, budget or fr.n,
                             chunk_steps or LS.DEFAULT_CHUNK_STEPS)
    fr.run = run
    return fr


def _setup_seq(name, device):
    """K1-seq on the zoom sequence of FRAMES[name]."""
    import torch

    from fractalshark_tpu_torch.core.views import get_view_preset
    from fractalshark_tpu_torch.ops import escape

    view, size, kern, key, _, (count, factor, n) = FRAMES[name]
    ptz = get_view_preset(view).ptz.square_aspect_ratio(size, size)
    frames = escape.zoom_sequence(escape.PlainParams.from_view(
        ptz, size, size), size, size, count, factor)
    fr = types.SimpleNamespace(name=name, kern=kern, key=key, size=size,
                               n=n, frames=frames)

    def run(budget=None, chunk_steps=None):
        return escape.escape_sequence_kernel(frames, size, size, budget or n,
                                             torch.float32, device)
    fr.run = run
    return fr


def _setup_k1(name, device):
    """K1 on one View 0 frame of FRAMES[name], through ``escape.escape``
    (the int64 grid)."""
    from fractalshark_tpu_torch.core.views import get_view_preset
    from fractalshark_tpu_torch.ops import escape

    view, size, kern, key, mant, n = FRAMES[name]
    ptz = get_view_preset(view).ptz.square_aspect_ratio(size, size)
    p = escape.PlainParams.from_view(ptz, size, size)
    fr = types.SimpleNamespace(name=name, kern=kern, key=key, size=size,
                               n=n, params=p)

    def run(budget=None, chunk_steps=None):
        return escape.escape(p, size, size, budget or n, mant, device)
    fr.run = run
    return fr


def _setup_direct(name, device):
    """K13, K14, K17 or K18 on a frame of FRAMES[name], from its view's
    splits: ``run`` launches the kernel (the int64 grid), ``plain(budget)``
    runs its twin (on the same device)."""
    import numpy as np
    import torch

    from fractalshark_tpu_torch.core.pointzoom import PointZoomBBConverter
    from fractalshark_tpu_torch.ops import dblflt, hdr_escape

    (x, y, zoom, n), size, kern, key, mant, _ = FRAMES[name]
    ptz = PointZoomBBConverter(pt_x=x, pt_y=y, zoom_factor=zoom,
                               prec=512).square_aspect_ratio(size, size)
    fdt = torch.float32 if mant == "f32" else torch.float64
    fr = types.SimpleNamespace(name=name, kern=kern, key=key, size=size,
                               n=n, dtype=fdt, ptz=ptz)
    if kern == "k13":
        p = hdr_escape.view_to_hdr_params(
            ptz, size, size, dtype=np.float32 if mant == "f32"
            else np.float64)
        kernel, fr.plain_fn, arg = (hdr_escape.escape_hdr_kernel,
                                    hdr_escape.escape_hdr_plain, p)
    elif kern == "k14":
        arg = dblflt.df_params(ptz, size, size, key[-4:])
        kernel, fr.plain_fn = dblflt.escape_df_kernel, dblflt.escape_df_plain
    else:
        # (a tree from before K17/K18 has no quadd/quadflt)
        from fractalshark_tpu_torch.ops import quadd, quadflt
        mod, kind = (quadd, "qd") if kern == "k17" else (quadflt, "qf")
        arg = getattr(mod, kind + "_params")(ptz, size, size,
                                            "4x" + mant[1:])
        kernel = getattr(mod, f"escape_{kind}_kernel")
        fr.plain_fn = getattr(mod, f"escape_{kind}_plain")

    def run(budget=None, chunk_steps=None):
        return kernel(arg, size, size, budget or n, fdt, device)

    def plain(budget=None):
        return fr.plain_fn(arg, size, size, budget or n, fdt, device)
    fr.run, fr.plain = run, plain
    return fr


def _setup_family(fr, res, dpar, device):
    """K15 (the BLA table's rows, the HDR dc grid) or K6's glitch instance
    (the f32 dc grid, the bad flags): ``run(budget, chunk_steps)`` through
    the run loop (K15: the int64 grid; the glitch instance: the flat
    state, counts in [4] and flags in [6]), ``plain(budget)`` the twin in
    one lockstep run (the same)."""
    import numpy as np
    import torch

    from fractalshark_tpu_torch.engine.bla import get_or_build_bla
    from fractalshark_tpu_torch.ops import bla_kernel, perturb, scaled
    from fractalshark_tpu_torch.ops.hdrfloat import HDRComplex
    from fractalshark_tpu_torch.ops.tables import orbit_on

    size, n, mr = fr.size, fr.n, fr.mr
    fr.orbit = orbit_on(res, device, fr.dtype)
    if fr.kern == "k15":
        fr.dc = perturb._dc_grids_hdr(*dpar, size, size, device, fr.dtype)
        fr.T = bla_kernel.bla_tables(get_or_build_bla(res), device, fr.dtype)
    else:
        fr.dc = perturb._dc_grids_float(*dpar, size, size, device,
                                        torch.float32)
        fr.bad = torch.from_numpy(scaled.bad_flags(
            *res.device_orbit(np.float64))).to(device)
    flat = HDRComplex(*(t.reshape(-1) for t in fr.dc))

    def run(budget=None, chunk_steps=None, tally=None):
        if fr.kern == "k15":
            return bla_kernel.bla_run(fr.orbit, fr.dc, fr.T, budget or n, mr,
                                      chunk_steps, tally=tally)
        return perturb.run_state(fr.orbit, fr.dc, budget or n, mr, False,
                                 fr.key, chunk_steps, bad=fr.bad)

    def plain(budget=None):
        if fr.kern == "k15":
            st = bla_kernel.bla_plain(fr.orbit, flat, fr.T,
                                      bla_kernel.init_state_plain(flat),
                                      budget or n, mr)
            return st[4].to(torch.int64).reshape(size, size)
        zero = perturb.init_state_plain(flat, budget or n, False)
        return perturb.perturb_plain(fr.orbit, flat,
                                     zero + (torch.zeros_like(zero[5]),),
                                     budget or n, mr, False, bad=fr.bad)
    fr.run, fr.plain = run, plain
    return fr


def _setup_hdr_df(fr, res, dpar, device):
    """K16 on its orbit table and HDC2 dc grid: ``run(budget,
    chunk_steps)`` through its run loop over the live pixels, ``plain
    (budget)`` the twin in one lockstep run; both the int64 grid."""
    from fractalshark_tpu_torch.ops import hdr_df

    size, n, mr = fr.size, fr.n, fr.mr
    fr.orbit = hdr_df.pack_orbit_df(res, device)
    fr.dc = hdr_df.dc_tensors(hdr_df._dc_grids_hdrdf(*dpar, size, size,
                                                     device))

    def run(budget=None, chunk_steps=None):
        return hdr_df.run_state(fr.orbit, fr.dc, budget or n, mr,
                                chunk_steps)[6].reshape(size, size)

    def plain(budget=None):
        st = hdr_df.perturb_hdr_df_plain(
            fr.orbit, fr.dc, hdr_df.init_state_plain(size * size, budget or n,
                                                     device),
            budget or n, mr)
        return st[6].reshape(size, size)
    fr.run, fr.plain = run, plain
    return fr


def grid_of(fr, out):
    """The iteration grid of a run's result (K7: the iterations done when
    the pixel leaves the LA stages; K6's glitch instance: its state's
    counts)."""
    if fr.kern == "k7":
        return fr.n - out[3]
    if fr.kern == "glitch":
        return out[4].reshape(fr.size, fr.size)
    return out[6] if fr.kern == "k2" else out


def trace_call(fn, margin: float = 0.002, tries: int = 3):
    """One call of `fn` (warm) under torch.profiler and under the sync
    debug mode: {"device_ms": the sum of its CUDA kernels' intervals,
    "kernels": their count, "kernel_names": the count by name,
    "kernel_ms": the intervals' sum by name, "syncs": the host syncs
    torch reports, "order": the kernels' names in launch order}.  Kernels
    launched through ctypes are traced as well (CUPTI sees every launch of
    the process).  The call sits `margin` seconds inside each end of the
    profiler's window: with none, a trace on an H100 now and then lost a
    launch of a two-launch call (``tools/time_ntt.py --trace-reps``).  A
    trace with the margin lost one too (a four-step transform's K8
    launch, H100, once in a smoke run), so the call is traced `tries`
    times and the trace that holds the most kernels is kept: a trace can
    lose a launch's record but not invent one, so a call that runs an
    extra kernel still shows it."""
    import collections
    import tempfile
    import time
    import warnings

    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            fn()
            torch.cuda.synchronize()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    syncs = sum("synchroniz" in str(w.message) for w in caught)
    # the run's own synchronize() above is not torch's: it is not counted
    kern = []
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            time.sleep(margin)
            fn()
            torch.cuda.synchronize()
            time.sleep(margin)
        with tempfile.TemporaryDirectory() as d:
            path = os.path.join(d, "trace.json")
            prof.export_chrome_trace(path)
            with open(path) as fh:
                events = json.load(fh)["traceEvents"]
        got = sorted((e for e in events if e.get("cat") == "kernel"),
                     key=lambda e: e["ts"])
        if len(got) > len(kern):
            kern = got

    def short(name):
        """A kernel's name without its namespace and arguments."""
        name = name.replace("(anonymous namespace)::", "")
        return name.split("(")[0].split("<")[0].replace("void ", "")[-40:]

    names = collections.Counter(short(e["name"]) for e in kern)
    per_name = collections.Counter()
    for e in kern:
        per_name[short(e["name"])] += e["dur"] / 1e3
    return {"device_ms": sum(e["dur"] for e in kern) / 1e3,
            "kernels": len(kern), "syncs": syncs,
            "kernel_names": dict(names), "kernel_ms": dict(per_name),
            "order": [short(e["name"]) for e in kern]}


def time_frame(fr, reps):
    """Run the frame to the end `reps` times under CUDA events after one
    warm-up run: (the last run's result, a record of the times, the
    launches of one run, the grid's iter_sum and CRC-32)."""
    import torch

    from fractalshark_tpu_torch import kernels
    from fractalshark_tpu_torch.ops import la_kernel, perturb
    from fractalshark_tpu_torch.ops import perturb_stream as ps
    # (a tree from before K15 has no bla_kernel)
    try:
        from fractalshark_tpu_torch.ops import bla_kernel
        bla_stats = bla_kernel.last_run_stats
    except ImportError:
        bla_stats = {}

    kernels.reset_counts()
    out = fr.run()
    torch.cuda.synchronize()
    launches = {k: v for k, v in kernels.launches.items() if v}
    # (a tree from before K3's live-pixel launches records none)
    from fractalshark_tpu_torch.ops import la_stream as LS
    stats = {"k6": perturb.last_run_stats, "k2": la_kernel.last_run_stats,
             "k15": bla_stats, "glitch": perturb.last_run_stats,
             "k16": perturb.last_run_stats,
             "k7": getattr(LS, "last_run_stats", {}),
             "k3": getattr(ps, "last_run_stats", {}),
             "tail": getattr(ps, "last_run_stats", {})
             if getattr(fr, "key", None) == "rc_tail"
             else perturb.last_run_stats}.get(fr.kern, {})
    # the pixels each launch ran (a tree from before the live-pixel
    # launches records none)
    work = list(stats.get("work", []))
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        a.record()
        out = fr.run()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    grid = grid_of(fr, out)
    if fr.name in PINS and int(grid.sum()) != PINS[fr.name]:
        raise AssertionError(f"{fr.name}: iter_sum {int(grid.sum())} != "
                             f"{PINS[fr.name]}")
    return out, {"frame": fr.name, "budget": fr.n, "ms": times,
                 "ms_median": statistics.median(times),
                 "launches": launches, "work": work,
                 "iter_sum": int(grid.sum()), "crc32": crc(grid),
                 "max_iter": int(grid.max())}


def deepest_body_steps(fr, chunk=16) -> int:
    """An upper bound, within `chunk`, of the body steps of a K2 frame's
    deepest pixel: `chunk` times the launches of the run in chunks of
    `chunk`."""
    from fractalshark_tpu_torch.ops import la_kernel
    fr.run(chunk_steps=chunk)
    return chunk * la_kernel.last_run_stats["dispatches"]


def perturb_profile(fr, chunk):
    """Live pixels after each launch of `chunk` steps."""
    from fractalshark_tpu_torch.ops import perturb
    from fractalshark_tpu_torch.ops.hdrfloat import HDRComplex
    flat = HDRComplex(*(t.reshape(-1).contiguous() for t in fr.dc))
    state, live, work = None, [], None
    while True:
        state = perturb.perturb_kernel(fr.orbit, flat, state, fr.n, fr.mr,
                                       fr.mode, chunk, fr.key, work)
        work = perturb.live_pixels(state[-1])
        live.append(int(work.numel()))
        if live[-1] == 0:
            return live


def lav2_profile(fr, chunk):
    """Live pixels and pixels in the LA stages after each launch of
    `chunk` body steps (every launch over all pixels in both phases)."""
    from fractalshark_tpu_torch.ops import la_kernel
    from fractalshark_tpu_torch.ops.hdrfloat import HDRComplex
    flat = HDRComplex(*(t.reshape(-1) for t in fr.dc))
    state, live = None, []
    while True:
        state = la_kernel.lav2_kernel(fr.T, fr.orbit, flat, state, fr.n,
                                      fr.mr, fr.mode, chunk)
        done = state[-1]
        live.append((int((~done).sum()), int((~done & (state[0] >= 0)).sum())))
        if live[-1][0] == 0:
            return live


def stream_profile(fr, state) -> dict:
    """K7's work on a frame: the LA steps of all its pixels (the twin's
    count, from one run of the twin) and the bound they and the bytes K7
    must move (the tables, dc, the state written) give, by
    ``chip_smoke.py``'s rates."""
    import importlib.util

    from fractalshark_tpu_torch.ops import la_stream as LS
    from fractalshark_tpu_torch.ops.hdrfloat import HDRComplex

    flat = HDRComplex(*(t.reshape(-1).contiguous() for t in fr.dc))
    LS.run_stages(fr.T, flat, fr.n, 0, plain=True)
    steps = LS.last_run_stats["steps"]
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    tabs = (fr.T.nodes, fr.T.side, fr.T.stages, fr.T.at)
    return {"la_steps": steps, **smoke.bound(
        smoke.nbytes(*tabs, *flat, *state), smoke.stream_ops(steps),
        smoke.F32_OPS_PER_S)}


def serial_floor(device, reps):
    """K6's time per step (ns) on one never-escaping pixel with a one-row
    orbit (max_ref = 1), each of its four forms (hdr_f32, hdr_f64,
    float_f32, float_f64), and over a streamed zero orbit (the same names
    with _stream)."""
    import torch

    from fractalshark_tpu_torch.ops import perturb
    from fractalshark_tpu_torch.ops.hdrfloat import HDRComplex

    out = {}
    for (mant, hdr_mode), rows in itertools.product(
            (("f32", True), ("f64", True), ("f32", False), ("f64", False)),
            (1, STREAM_ROWS)):
        fdt = torch.float32 if mant == "f32" else torch.float64
        # one row (0, -0.5), or rows of a zero orbit: each row's second
        # half is the next row's first, as pack_orbit_np packs them
        orbit = (torch.tensor([[0.0, 0.0, -0.5, 0.0]], dtype=fdt,
                              device=device) if rows == 1 else
                 torch.zeros((rows, 4), dtype=fdt, device=device))
        dc = HDRComplex(torch.tensor([1e-3], dtype=fdt, device=device),
                        torch.zeros(1, dtype=fdt, device=device),
                        torch.zeros(1, dtype=torch.int32, device=device))
        fr = types.SimpleNamespace(
            name=f"floor {mant} {rows}", kern="k6", n=FLOOR_STEPS,
            run=lambda: perturb.perturb_run(orbit, dc, FLOOR_STEPS, rows,
                                            hdr_mode, "perturb_hdr32"))
        _, rec = time_frame(fr, reps)
        if rec["max_iter"] != FLOOR_STEPS:
            raise AssertionError(f"floor pixel escaped at {rec['max_iter']}")
        ns = rec["ms_median"] * 1e6 / FLOOR_STEPS
        name = f"{'hdr' if hdr_mode else 'float'}_{mant}"
        out[name if rows == 1 else name + "_stream"] = ns
        log(f"  serial floor {'HDR' if hdr_mode else 'float'}-{mant}, "
            f"{rows} rows: {ns:.3f} ns a step (median of {reps}: "
            f"{[round(t, 3) for t in rec['ms']]} ms for {FLOOR_STEPS} "
            f"steps)")
    return out


def rc_floor(device, reps):
    """K3's time per step (ns) on one never-escaping pixel over a zero
    orbit of STREAM_ROWS positions from the zero state: with an anchor at
    every position ("hit": every step reads the next anchor) and with
    anchor 0 alone ("df32": every step reconstructs Z[pos+1])."""
    import numpy as np
    import torch

    from fractalshark_tpu_torch.engine.perturbation_results import (
        CompressedOrbit)
    from fractalshark_tpu_torch.ops import hdrfloat as hdr
    from fractalshark_tpu_torch.ops import perturb_stream as ps
    from fractalshark_tpu_torch.ops.hdrfloat import HDRComplex
    from fractalshark_tpu_torch.ops.tables import anchor_table

    total = STREAM_ROWS + 1
    dc = HDRComplex(torch.tensor([1e-3], device=device),
                    torch.zeros(1, device=device),
                    torch.zeros(1, dtype=torch.int32, device=device))
    out = {}
    for name, m in (("hit", total), ("df32", 1)):
        comp = CompressedOrbit(
            anchors_x=np.zeros(m), anchors_y=np.zeros(m),
            anchor_index=np.arange(m, dtype=np.int64), total_count=total,
            cx_low=0.0, cy_low=0.0, error_exp=0)
        A = anchor_table(comp, device)

        def init():
            dz = hdr.complex_zero((1,), device=device)
            z = torch.zeros(1, dtype=torch.int64, device=device)
            return {"dzr": dz.re, "dzi": dz.im, "dze": dz.e, "it": z,
                    "jwait": z, "done": z.bool()}

        fr = types.SimpleNamespace(
            name=f"K3 floor {name}", kern="k3", n=FLOOR_STEPS,
            run=lambda: FLOOR_STEPS - ps.rc_tail_run(
                A, dc, init(), FLOOR_STEPS, (0.0, 0.0)))
        _, rec = time_frame(fr, reps)
        if rec["max_iter"] != FLOOR_STEPS:
            raise AssertionError(f"K3 floor pixel escaped at "
                                 f"{rec['max_iter']}")
        out[name] = rec["ms_median"] * 1e6 / FLOOR_STEPS
        log(f"  K3 serial floor ({name}): {out[name]:.3f} ns a step "
            f"(median of {reps}: {[round(t, 3) for t in rec['ms']]} ms "
            f"for {FLOOR_STEPS} steps)")
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", default=ROOT)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--cli", action="store_true")
    ap.add_argument("--profile", action="store_true")
    ap.add_argument("--trace", action="store_true",
                    help="each frame's device time, kernels and syncs")
    ap.add_argument("--only", nargs="*")
    ap.add_argument("--no-floor", action="store_true",
                    help="skip the serial floors")
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.tree))
    import torch
    if not torch.cuda.is_available():
        print("FAIL: no CUDA device", file=sys.stderr)
        return 1
    from fractalshark_tpu_torch import kernels
    device = torch.device("cuda", 0)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    log(f"tree {os.path.abspath(args.tree)}; card {card}")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        kernels.build(verbose=True)
    kernels.lib()
    for line in ptxas_lines(buf.getvalue()):
        log(f"  ptxas {line}")
    floor = {}
    if not args.no_floor:
        floor = serial_floor(device, args.reps)
        floor.update({f"k3_{k}": v for k, v in rc_floor(device,
                                                         args.reps).items()})
    for name in args.only or FRAMES:
        fr = setup(name, device)
        out, rec = time_frame(fr, args.reps)
        if args.trace:
            tr = trace_call(fr.run)
            tr.pop("order")
            rec["trace"] = tr
        if args.profile and fr.kern in ("tail", "k3"):
            # the live pixels of each launch (default chunks) and the
            # deepest pixel's tail steps (its count, and the escaping
            # step), at K3's or K6's one-pixel step
            steps = int((grid_of(fr, out) - fr.start).max()) + 1
            ns = floor.get("hdr_f32" if fr.key == "two_phase_tail"
                           else "k3_hit", float("nan"))
            rec.update(live=rec["work"], deepest_steps=steps,
                       serial_floor_ms=steps * ns / 1e6)
        elif args.profile and fr.kern == "k7":
            rec.update(stream_profile(fr, out))
        elif args.profile and fr.kern in ("k2", "k6"):
            chunk = 64 if fr.kern == "k2" else 65536
            live = (lav2_profile if fr.kern == "k2" else perturb_profile)(
                fr, chunk)
            rec["deepest_steps_le"] = len(live) * chunk
            rec["live"] = live if fr.kern == "k6" else live[::16] + [live[-1]]
        log(json.dumps(rec))
    if args.cli:
        from fractalshark_tpu_torch import cli
        for label, (argv, env) in CLI_FRAMES.items():
            # twice in this process: the second render has every kernel
            # and table loaded
            for run in range(2):
                os.environ.update(env)
                out = io.StringIO()
                try:
                    with contextlib.redirect_stdout(out):
                        rc = cli.main(argv + ["--stats", "--device", "cuda"])
                finally:
                    for k in env:
                        del os.environ[k]
                s = json.loads(out.getvalue().strip().splitlines()[-1])
                log(json.dumps({"cli": label, "run": run, "rc": rc,
                                "iter_sum": s["iter_sum"],
                                "crc32": s["crc32"],
                                "timings": s.get("timings")}))
    log(json.dumps({"card": card, "serial_floor_ns": floor}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
