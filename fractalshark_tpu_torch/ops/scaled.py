"""Scaled (f32) perturbation with glitch detection and selective repair
(the PerturbedScaled names): the port of ``fractalshark_tpu/ops/scaled.py``
(``bad_flags``, ``_perturb_f32_glitch_impl``, ``perturb_render_scaled``).

One f32 pass over every pixel tracks a per-pixel glitch flag, the OR of
``bad[j]`` over the orbit positions it stepped from (K6's glitch
instance, ``csrc/perturb.cu``); where any pixel glitched, a repair pass
renders the frame in HDR with f64 mantissas (K6 HDR-f64,
``perturb.perturb_render_hdr``) and the glitched pixels take its counts.
An orbit entry is bad where f32 would underflow it: |x|, |y| or
|z|²·1e-7 at or below f32's smallest normal (``RefOrbitCalc.cpp:553-560``).

The f32 orbit is the f64 orbit (with its wrap entry) cast to f32 and
flushed, as every uploaded table; counts and budget are int32 as in the
reference (a budget of 2^31 raises OverflowError there and here).
"""

from __future__ import annotations

import numpy as np
import torch

from fractalshark_tpu_torch.core.pointzoom import PointZoomBBConverter
from fractalshark_tpu_torch.ops import perturb
from fractalshark_tpu_torch.ops.tables import int32_budget, orbit_on

FLOAT_MIN_NORMAL = 1.1754944e-38  # RefOrbitCalc.cpp:472
GLITCH_EPS = 1e-7                  # RefOrbitCalc.cpp:474


def bad_flags(orbit_x: np.ndarray, orbit_y: np.ndarray) -> np.ndarray:
    """PerturbExtras::Bad flags per orbit entry: set when |zx|, |zy| or
    |z|²·1e-7 underflows the f32 minimum normal; never at the seed entry
    0, the rebase target."""
    norm = (orbit_x * orbit_x + orbit_y * orbit_y) * GLITCH_EPS
    bad = (np.abs(orbit_x) <= FLOAT_MIN_NORMAL) | \
        (np.abs(orbit_y) <= FLOAT_MIN_NORMAL) | (norm <= FLOAT_MIN_NORMAL)
    bad[0] = False
    return bad


def scaled_pass(results, ptz: PointZoomBBConverter, width: int,
                height: int, max_iter: int, chunk_steps: int | None = None,
                abort_monitor=None, device="cuda"):
    """The f32 pass: (int64 iterations, bool glitch flags) [height,
    width] on `device`, and the number of bad orbit entries."""
    device = torch.device(device)
    max_iter = int32_budget(max_iter)
    ox, oy = results.device_orbit(np.float64)
    bad = bad_flags(ox, oy)
    dc = perturb._dc_grids_float(*perturb.delta_params(
        ptz, results.center_x, results.center_y, width, height),
        width, height, device, torch.float32)
    state = perturb.run_state(
        orbit_on(results, device, torch.float32), dc, max_iter,
        results.max_ref_iteration(), False, "perturb_scaled", chunk_steps,
        abort_monitor, bad=torch.from_numpy(bad))
    shape = (height, width)
    return state[4].reshape(shape), state[6].reshape(shape), int(bad.sum())


def perturb_render_scaled(results, ptz: PointZoomBBConverter, width: int,
                          height: int, max_iter: int,
                          chunk_steps: int | None = None, abort_monitor=None,
                          device="cuda") -> tuple[torch.Tensor, dict]:
    """Two-pass scaled render: (the int64 iteration grid, {"glitched_pixels",
    "bad_entries"})."""
    iters, glitch, n_bad = scaled_pass(results, ptz, width, height, max_iter,
                                       chunk_steps, abort_monitor, device)
    n_glitched = int(glitch.sum())
    if n_glitched:
        repair = perturb.perturb_render_hdr(
            results, ptz, width, height, max_iter, sub_dtype=np.float64,
            chunk_steps=chunk_steps, abort_monitor=abort_monitor,
            device=device)
        iters = torch.where(glitch, repair, iters)
    return iters, {"glitched_pixels": n_glitched, "bad_entries": n_bad}
