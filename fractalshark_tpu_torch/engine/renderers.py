"""Perturbed-render orchestration: the port of
``fractalshark_tpu/engine/renderers.py`` (``calc_perturbed``,
``la_rc_render``, ``two_phase_render``, ``_handoff_init``).

The Scaled names (every dtype) take ``ops/scaled.py`` (K6's glitch
instance, then K6 HDR-f64 where a pixel glitched), the BLA names
``engine/bla.py``'s table and ``ops/bla_kernel.py`` (K15; f32 mantissas
for the hdr32 names, f64 for the others), as the reference routes them
(``renderers.py:98-115``).  The rest is the LAv2 families'.

Routing follows the reference's accelerator route
(``renderers.py:30-179``).  With a valid LA table (FULL and LAO modes):

* f32 mantissas (dtypes f32, hdr32, 2x32, hdr2x32): RC in FULL mode →
  two-phase with K3 over the real compressed anchors; LAO → K2
  ``la_only``; FULL within the reference's one-kernel Pallas caps (orbit
  ≤ 8,192 entries, table ≤ 2,048 nodes) → K2 in full mode; otherwise →
  two-phase: K2 ``la_only``, the handoff, then the tail over the
  uncompressed orbit.  The reference runs that tail as its RC kernel
  over identity anchors (every orbit position an anchor, so the
  reconstruction never runs); its step is K6's HDR-f32 step, so here it
  is K6 resumed from the handoff state (``perturb.handoff_state``,
  ``perturb.perturb_run``; K6's first launch applies the handoff) on the
  packed orbit phase 1 already put on the device: no anchor table is
  built or uploaded;
* f64 mantissas (f64, hdr64: the ``Gpu1x64PerturbedLAv2`` band AUTO
  picks from 2^46 to 2^200) → K2-f64 in full or ``la_only`` mode, the
  reference's one route for them (its RC, Pallas and two-phase routes
  take f32 only).

PO mode, or no valid LA table: the perturbation-only renders of
``ops/perturb.py`` (K6): f32/f64 → native float; 2x32 and hdr2x32 (RC
names too) → ``ops/hdr_df.py`` (K16, HDR double-float); hdr32 with RC →
K3 from the zero state; hdr32 → B10's route within its caps, else B11's;
hdr64 → HDR with f64 mantissas.

``FRACTALSHARK_LA_PHASE=stream`` makes phase 1 of the two-phase routes
the streaming LA phase (K7, ``ops/la_stream.py``) on a CUDA device, as
the reference does on its TPU (``renderers.py:215-240``); on the CPU the
variable is ignored.  Unlike the reference, a K7 failure raises (no
catch-all fallback) and any value other than unset or ``stream`` raises
``ValueError``.

On the CPU the same routes run the kernels' plain twins.
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch

from fractalshark_tpu_torch.core.algorithms import (
    Family, LAMode, RenderAlgorithm)
from fractalshark_tpu_torch.engine.bla import get_or_build_bla
from fractalshark_tpu_torch.engine.la_reference import get_or_build_la
from fractalshark_tpu_torch.engine.perturbation_results import CompressedOrbit
from fractalshark_tpu_torch.engine.reforbit import RefOrbitCalc
from fractalshark_tpu_torch.ops import la_kernel, perturb
from fractalshark_tpu_torch.ops.bla_kernel import bla_perturb_render
from fractalshark_tpu_torch.ops.hdr_df import perturb_render_hdr_df
from fractalshark_tpu_torch.ops.la_stream import la_phase_stream
from fractalshark_tpu_torch.ops.perturb_pallas import perturb_render_pallas
from fractalshark_tpu_torch.ops.perturb_stream import (
    anchors_on, perturb_render_stream, perturb_render_stream_rc)
from fractalshark_tpu_torch.ops.scaled import perturb_render_scaled
from fractalshark_tpu_torch.ops.tables import orbit_on

# dtypes whose LA machine runs with f32 mantissas (renderers.py:61-62)
_SUB_F32 = ("f32", "hdr32", "2x32", "hdr2x32")


def get_orbit_calc(fractal) -> RefOrbitCalc:
    """The fractal's orbit cache; its device orbit runs on the fractal's
    device."""
    if fractal._orbit_cache is None:
        fractal._orbit_cache = RefOrbitCalc()
    fractal._orbit_cache.device = str(fractal.device)
    return fractal._orbit_cache


def calc_perturbed(fractal, alg: RenderAlgorithm) -> torch.Tensor:
    """Iteration grid (int64, on the fractal's device) of a perturbed
    algorithm."""
    if alg.family not in (Family.PERTURB_LAV2, Family.PERTURB_BLA,
                          Family.PERTURB_SCALED):
        raise NotImplementedError(f"{alg.name}: family {alg.family}")
    calc = get_orbit_calc(fractal)
    w, h = fractal._render_dims()
    bm = fractal.benchmark

    t0 = time.perf_counter()
    results = calc.get_and_create_useful_results(fractal.ptz,
                                                 fractal.num_iterations)
    bm.ref_orbit_s = time.perf_counter() - t0
    bm.extra.update(calc.last_details)
    if alg.family is Family.PERTURB_SCALED:
        return _scaled(fractal, results, w, h)
    if alg.family is Family.PERTURB_BLA:
        return _bla(fractal, alg, results, w, h)

    la = None
    if alg.la_mode in (LAMode.FULL, LAMode.LAO):
        t0 = time.perf_counter()
        la = get_or_build_la(fractal, results)
        bm.la_generation_s = time.perf_counter() - t0
    if la is None:
        return _perturb_only(fractal, alg, results, w, h)
    if alg.dtype not in _SUB_F32:
        return _timed(fractal, "lav2-lao-f64" if alg.la_mode is LAMode.LAO
                      else "lav2-f64", "phase1_s",
                      lambda: la_kernel.la_perturb_render(
                          results, la, fractal.ptz, w, h,
                          fractal.num_iterations, sub_dtype=torch.float64,
                          la_only=alg.la_mode is LAMode.LAO,
                          abort_monitor=fractal.abort_monitor,
                          device=fractal.device))

    dev = fractal.device
    n = fractal.num_iterations
    if alg.runtime_decompression and alg.la_mode is LAMode.FULL:
        bm.extra["kernel"] = "lav2-rc"
        return la_rc_render(fractal, results, la, w, h)
    if alg.la_mode is LAMode.LAO:
        return _timed(fractal, "lav2-lao", "phase1_s",
                      lambda: la_kernel.la_perturb_render(
                          results, la, fractal.ptz, w, h, n, la_only=True,
                          abort_monitor=fractal.abort_monitor, device=dev))
    t0 = time.perf_counter()
    T, _ = la_kernel.device_tables(results, la, dev)
    _sync(dev)
    bm.extra["tables_s"] = time.perf_counter() - t0
    if la_kernel.fits_full_mode(results, T, n):
        return _timed(fractal, "lav2-full", "phase1_s",
                      lambda: la_kernel.la_perturb_render(
                          results, la, fractal.ptz, w, h, n,
                          abort_monitor=fractal.abort_monitor, device=dev))
    bm.extra["kernel"] = "lav2-two-phase"
    return la_rc_render(fractal, results, la, w, h, identity=True)


def _perturb_only(fractal, alg: RenderAlgorithm, results, w: int,
                  h: int) -> torch.Tensor:
    """PO mode, or no valid LA table (``renderers.py:117-178``)."""
    n = fractal.num_iterations
    kw = dict(abort_monitor=fractal.abort_monitor, device=fractal.device)
    if alg.dtype in ("f32", "f64"):
        dt = np.float32 if alg.dtype == "f32" else np.float64
        return _timed(fractal, f"perturb-{alg.dtype}", "perturb_s",
                      lambda: perturb.perturb_render_float(
                          results, fractal.ptz, w, h, n, dtype=dt, **kw))
    if alg.dtype in ("2x32", "hdr2x32"):
        # double-float mantissas with an HDR exponent (K16), RC names too
        return _timed(fractal, "hdr-df", "perturb_s",
                      lambda: perturb_render_hdr_df(
                          results, fractal.ptz, w, h, n, **kw))
    if alg.dtype == "hdr64":
        return _timed(fractal, "perturb-hdr64", "perturb_s",
                      lambda: perturb.perturb_render_hdr(
                          results, fractal.ptz, w, h, n,
                          sub_dtype=np.float64, **kw))
    if alg.runtime_decompression:
        # render straight from the compressed orbit: K3 from the zero
        # state rebuilds the reference values on the card
        comp = _compressed(fractal, results)
        return _timed(fractal, "perturb-rc-stream", "perturb_s",
                      lambda: perturb_render_stream_rc(
                          comp, results.center_x, results.center_y,
                          fractal.ptz, w, h, n, **kw))
    out = _timed(fractal, "perturb-pallas", "perturb_s",
                 lambda: perturb_render_pallas(results, fractal.ptz, w, h,
                                               n, **kw))
    if out is not None:
        return out
    # past B10's caps: the streaming route, no length cap
    return _timed(fractal, "perturb-stream", "perturb_s",
                  lambda: perturb_render_stream(results, fractal.ptz, w, h,
                                                n, **kw))


def _scaled(fractal, results, w: int, h: int) -> torch.Tensor:
    """The Scaled names, whatever their dtype (``renderers.py:98-104``):
    the glitch counts go into the benchmark's extra."""
    out, stats = _timed(fractal, "scaled", "perturb_s",
                        lambda: perturb_render_scaled(
                            results, fractal.ptz, w, h,
                            fractal.num_iterations,
                            abort_monitor=fractal.abort_monitor,
                            device=fractal.device))
    fractal.benchmark.extra.update(stats)
    return out


def _bla(fractal, alg: RenderAlgorithm, results, w: int,
         h: int) -> torch.Tensor:
    """The BLA names (``renderers.py:106-115``): the table built (once
    an orbit) and timed, then K15 with f32 mantissas for f32/hdr32, f64
    for the others."""
    t0 = time.perf_counter()
    bla = get_or_build_bla(results)
    fractal.benchmark.extra["bla_build_s"] = time.perf_counter() - t0
    sub = np.float32 if alg.dtype in ("f32", "hdr32") else np.float64
    return _timed(fractal, "bla-f32" if sub == np.float32 else "bla-f64",
                  "perturb_s", lambda: bla_perturb_render(
                      results, bla, fractal.ptz, w, h,
                      fractal.num_iterations, sub_dtype=sub,
                      abort_monitor=fractal.abort_monitor,
                      device=fractal.device))


def _timed(fractal, kernel: str, timer: str, render):
    """Run `render`, synchronised, under the route name `kernel` and the
    timing `timer`."""
    t0 = time.perf_counter()
    out = render()
    _sync(fractal.device)
    if out is not None:
        fractal.benchmark.extra["kernel"] = kernel
        fractal.benchmark.extra[timer] = time.perf_counter() - t0
    return out


def _compressed(fractal, results) -> CompressedOrbit:
    """The results' compressed orbit (built once), its ratio noted."""
    comp = results.extra.get("compressed_orbit")
    if comp is None:
        comp = results.extra["compressed_orbit"] = \
            CompressedOrbit.from_uncompressed(
                results, error_exp=fractal.compression_error_exp)
    fractal.benchmark.extra["compression_ratio"] = round(
        comp.compression_ratio(), 2)
    return comp


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


LA_PHASE_ENV = "FRACTALSHARK_LA_PHASE"


def use_stream_phase(device) -> bool:
    """Phase 1 is K7 where ``FRACTALSHARK_LA_PHASE=stream`` and the device
    is CUDA (the reference: on its TPU).  The variable is unset or
    ``stream``; anything else raises, on every device (the reference
    silently ignores a typo)."""
    v = os.environ.get(LA_PHASE_ENV)
    if v not in (None, "stream"):
        raise ValueError(f"{LA_PHASE_ENV}={v!r}: the only value is "
                         f"'stream' (or leave it unset)")
    return v == "stream" and torch.device(device).type == "cuda"


def la_rc_render(fractal, results, la, w: int, h: int,
                 identity: bool = False) -> torch.Tensor:
    """Two-phase LAv2 over the uncompressed orbit (`identity`: K6's tail)
    or the real compressed orbit (RC: K3's tail over its anchors); phase 1
    is the streaming LA phase where ``FRACTALSHARK_LA_PHASE=stream``
    selects it on a CUDA device."""
    stream = use_stream_phase(fractal.device)
    comp = None
    if not identity:
        t0 = time.perf_counter()
        comp = _compressed(fractal, results)
        anchors_on(comp, fractal.device)
        _sync(fractal.device)
        fractal.benchmark.extra["anchors_s"] = time.perf_counter() - t0
    return two_phase_render(results, la, fractal.ptz, w, h,
                            fractal.num_iterations, comp=comp,
                            abort_monitor=fractal.abort_monitor,
                            device=fractal.device,
                            timings=fractal.benchmark.extra, stream=stream)


def _handoff_init(ref_iter, it, n: int) -> tuple:
    """Phase-1 state → tail init: (it, jwait, done)."""
    return it, ref_iter, it >= n


def two_phase_render(results, la, ptz, w: int, h: int, n: int, *, comp=None,
                     abort_monitor=None, device="cuda",
                     timings: dict | None = None, stream: bool = False,
                     chunk_steps: int | None = None) -> torch.Tensor:
    """Phase 1: the LA machine to each pixel's tail entry (K2,
    ``la_only``; with `stream` the streaming LA phase, K7, unless it
    returns None); phase 2: the tail from each pixel's orbit position,
    over the uncompressed orbit (`comp` None: K6 resumed) or the
    compressed orbit `comp` (K3).  Returns the int64 iteration grid
    [h, w].  `chunk_steps` bounds the tail's launches (default: its
    kernel's)."""
    t0 = time.perf_counter()
    init = la_phase_stream(results, la, ptz, w, h, n,
                           abort_monitor=abort_monitor,
                           device=device) if stream else None
    if init is None:
        state = la_kernel.la_perturb_render(
            results, la, ptz, w, h, n, la_only=True, return_state=True,
            abort_monitor=abort_monitor, device=device)
        _, _, ref_iter, dzr, dzi, dze, it, _ = state
        it, jwait, done = _handoff_init(ref_iter, it, n)
        init = {"dzr": dzr, "dzi": dzi, "dze": dze, "it": it,
                "jwait": jwait, "done": done}
    elif timings is not None:
        timings["la_phase"] = "stream"
    _sync(device)
    t1 = time.perf_counter()
    if comp is None:
        out = _identity_tail(results, ptz, w, h, n, init, chunk_steps,
                             abort_monitor, device)
    else:
        out = perturb_render_stream_rc(
            comp, results.center_x, results.center_y, ptz, w, h, n,
            init_state=init, chunk_steps=chunk_steps,
            abort_monitor=abort_monitor, device=device)
    _sync(device)
    if timings is not None:
        timings["phase1_s"] = t1 - t0
        timings["phase2_s"] = time.perf_counter() - t1
    return out


def _identity_tail(results, ptz, w: int, h: int, n: int, init: dict,
                   chunk_steps, abort_monitor, device) -> torch.Tensor:
    """The two-phase tail over the uncompressed orbit: the handoff, then
    K6 (HDR-f32) over the live pixels, counted as ``two_phase_tail``."""
    device = torch.device(device)
    orbit = orbit_on(results, device)
    max_ref = results.max_ref_iteration()
    dc = perturb._dc_grids_hdr(*perturb.delta_params(
        ptz, results.center_x, results.center_y, w, h), w, h, device)
    return perturb.perturb_run(orbit, dc, n, max_ref, True,
                               "two_phase_tail", chunk_steps, abort_monitor,
                               perturb.handoff_state(init, device),
                               handoff=True)
