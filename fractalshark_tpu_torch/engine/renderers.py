"""Perturbed-render orchestration for the LAv2 HDRx32 family: the port
of ``fractalshark_tpu/engine/renderers.py`` (``calc_perturbed``,
``la_rc_render``, ``two_phase_render``, ``_handoff_init``).

Routing follows the reference's accelerator route
(``renderers.py:59-96``):

* FULL mode, orbit ≤ 8,192 entries and table ≤ 2,048 nodes (the
  reference's one-kernel Pallas caps) → K2 in full mode;
* otherwise → two-phase: K2 in phase-1 (``la_only``) mode, the handoff,
  then K3 over identity anchors (every orbit position stored);
* the RC variants → two-phase with K3 over the real compressed anchors;
* LAO → K2 with ``la_only``.

On the CPU the same routes run the kernels' plain twins.
"""

from __future__ import annotations

import time

import torch

from fractalshark_tpu_torch.core.algorithms import (
    Family, LAMode, RenderAlgorithm)
from fractalshark_tpu_torch.engine.la_reference import get_or_build_la
from fractalshark_tpu_torch.engine.perturbation_results import CompressedOrbit
from fractalshark_tpu_torch.engine.reforbit import RefOrbitCalc
from fractalshark_tpu_torch.ops import la_kernel
from fractalshark_tpu_torch.ops.perturb_stream import (
    anchors_on, perturb_render_stream_rc)

# ROADMAP items that own the algorithms this slice does not port yet
_NOT_PORTED = {
    "f64": "ROADMAP A11/B-queue 1: the f64-mantissa K2 "
           "(Gpu1x64PerturbedLAv2 band, 2^46-2^200)",
    "po": "ROADMAP A11: PO mode (B10/B11 perturbation-only kernels)",
    "bla": "ROADMAP A11: BLA and Scaled perturbation families",
}


def get_orbit_calc(fractal) -> RefOrbitCalc:
    """The fractal's orbit cache; its device orbit runs on the fractal's
    device."""
    if fractal._orbit_cache is None:
        fractal._orbit_cache = RefOrbitCalc()
    fractal._orbit_cache.device = str(fractal.device)
    return fractal._orbit_cache


def calc_perturbed(fractal, alg: RenderAlgorithm) -> torch.Tensor:
    """Iteration grid (int64, on the fractal's device) of a perturbed
    algorithm of the LAv2 HDRx32 family."""
    if alg.family is not Family.PERTURB_LAV2:
        raise NotImplementedError(f"{alg.name}: {_NOT_PORTED['bla']}")
    if alg.dtype != "hdr32":
        raise NotImplementedError(f"{alg.name}: {_NOT_PORTED['f64']}")
    if alg.la_mode is LAMode.PO:
        raise NotImplementedError(f"{alg.name}: {_NOT_PORTED['po']}")
    calc = get_orbit_calc(fractal)
    w, h = fractal._render_dims()
    bm = fractal.benchmark

    t0 = time.perf_counter()
    results = calc.get_and_create_useful_results(fractal.ptz,
                                                 fractal.num_iterations)
    bm.ref_orbit_s = time.perf_counter() - t0
    bm.extra.update(calc.last_details)

    t0 = time.perf_counter()
    la = get_or_build_la(fractal, results)
    bm.la_generation_s = time.perf_counter() - t0
    if la is None:
        raise NotImplementedError(
            f"{alg.name}: no valid LA table for this view; the "
            f"perturbation-only fallback is {_NOT_PORTED['po']}")

    dev = fractal.device
    n = fractal.num_iterations
    if alg.runtime_decompression and alg.la_mode is LAMode.FULL:
        bm.extra["kernel"] = "lav2-rc"
        return la_rc_render(fractal, results, la, w, h)
    if alg.la_mode is LAMode.LAO:
        bm.extra["kernel"] = "lav2-lao"
        t0 = time.perf_counter()
        out = la_kernel.la_perturb_render(
            results, la, fractal.ptz, w, h, n, la_only=True,
            abort_monitor=fractal.abort_monitor, device=dev)
        _sync(dev)
        bm.extra["phase1_s"] = time.perf_counter() - t0
        return out
    t0 = time.perf_counter()
    T, _ = la_kernel.device_tables(results, la, dev)
    _sync(dev)
    bm.extra["tables_s"] = time.perf_counter() - t0
    if la_kernel.fits_full_mode(results, T, n):
        bm.extra["kernel"] = "lav2-full"
        t0 = time.perf_counter()
        out = la_kernel.la_perturb_render(
            results, la, fractal.ptz, w, h, n,
            abort_monitor=fractal.abort_monitor, device=dev)
        _sync(dev)
        bm.extra["phase1_s"] = time.perf_counter() - t0
        return out
    bm.extra["kernel"] = "lav2-two-phase"
    return la_rc_render(fractal, results, la, w, h, identity=True)


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def la_rc_render(fractal, results, la, w: int, h: int,
                 identity: bool = False) -> torch.Tensor:
    """Two-phase LAv2 over identity anchors (exact streaming of the
    uncompressed orbit) or the real compressed orbit (RC)."""
    t0 = time.perf_counter()
    if identity:
        comp = results.extra.get("identity_compressed")
        if comp is None:
            comp = results.extra["identity_compressed"] = \
                CompressedOrbit.identity(results)
    else:
        comp = results.extra.get("compressed_orbit")
        if comp is None:
            comp = results.extra["compressed_orbit"] = \
                CompressedOrbit.from_uncompressed(
                    results, error_exp=fractal.compression_error_exp)
        fractal.benchmark.extra["compression_ratio"] = round(
            comp.compression_ratio(), 2)
    anchors_on(comp, fractal.device)
    _sync(fractal.device)
    fractal.benchmark.extra["anchors_s"] = time.perf_counter() - t0
    return two_phase_render(results, la, fractal.ptz, w, h,
                            fractal.num_iterations, comp=comp,
                            abort_monitor=fractal.abort_monitor,
                            device=fractal.device,
                            timings=fractal.benchmark.extra)


def _handoff_init(ref_iter, it, n: int) -> tuple:
    """Phase-1 state → tail init: (it, jwait, done)."""
    return it, ref_iter, it >= n


def two_phase_render(results, la, ptz, w: int, h: int, n: int, *, comp=None,
                     abort_monitor=None, device="cuda",
                     timings: dict | None = None) -> torch.Tensor:
    """Phase 1: the LA machine to each pixel's tail entry (K2,
    ``la_only``); phase 2: the RC tail from each pixel's orbit position
    (K3).  Returns the int64 iteration grid [h, w]."""
    if comp is None:
        comp = CompressedOrbit.identity(results)
    t0 = time.perf_counter()
    state = la_kernel.la_perturb_render(
        results, la, ptz, w, h, n, la_only=True, return_state=True,
        abort_monitor=abort_monitor, device=device)
    _sync(device)
    t1 = time.perf_counter()
    _, _, ref_iter, dzr, dzi, dze, it, _ = state
    it, jwait, done = _handoff_init(ref_iter, it, n)
    init = {"dzr": dzr, "dzi": dzi, "dze": dze, "it": it, "jwait": jwait,
            "done": done}
    out = perturb_render_stream_rc(
        comp, results.center_x, results.center_y, ptz, w, h, n,
        init_state=init, abort_monitor=abort_monitor, device=device)
    _sync(device)
    if timings is not None:
        timings["phase1_s"] = t1 - t0
        timings["phase2_s"] = time.perf_counter() - t1
    return out
