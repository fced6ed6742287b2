#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (fractalshark_tpu_torch) on one
NVIDIA card: builds the CUDA kernels from the checkout, holds each one
against its plain PyTorch version on the card, then renders through the
port's CLI entry point and checks the frames against values of the JAX
reference.

    python3 chip_smoke.py

Phases: (1) card, (2) build, (3) kernel vs plain on the card at the
main path's shapes, bit-identical, (4) the slice through
``fractalshark_tpu_torch.cli.main``: View 0 AUTO at 1024² (K1), a
small-table deep frame (K2 full mode), View #6 AUTO at 64² and 256²
(K2 phase 1 + K3).  Exits non-zero if any phase fails, and at once when
no CUDA device is present.  The next-to-last lines are the card's
``nvidia-smi`` name and power limit and a JSON object of the kernels;
the last line is ``{"ok": true, "device": {...}}``.

Expected View #6 values are those of the JAX package on the CPU with
FMA contraction off (``XLA_FLAGS=--xla_cpu_max_isa=AVX``): the port's
kernels round every * and + on their own (``nvcc -fmad=false``), while
XLA:CPU's default contracts a*b+c.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import subprocess
import sys
import tempfile
import time
import zlib

# View #6 (zoom 2^452, 4,718,592-iteration budget): iter_sum and CRC-32
# of the grid as <u4, JAX package on the CPU with FMA off
VIEW6_64 = (3_268_937_305, 2_518_423_760)
VIEW6_256 = (52_302_966_139, 1_647_051_423)
# the same frames with XLA:CPU's default FMA contraction, and the TPU
# v5e's bench record (BENCH_r05.json deep_iter_sum): printed, not targets
VIEW6_256_JAX_CPU_FMA = 52_302_949_912
VIEW6_256_TPU = 52_302_966_139
# a deep view whose orbit and LA table fit the one-kernel caps
SMALL_DEEP = ("-0.743643887037158704752191506114774",
              "0.131825904205311970493132056385139", "1e8", 2000)

KERNEL_META = {
    "escape": ("fractalshark_tpu_torch/csrc/escape.cu",
               "fractalshark_tpu/ops/escape.py:211"),
    "lav2_full": ("fractalshark_tpu_torch/csrc/lav2.cu",
                  "fractalshark_tpu/ops/la_pallas.py:45"),
    "lav2_phase1": ("fractalshark_tpu_torch/csrc/lav2.cu",
                    "fractalshark_tpu/ops/la_kernel.py:99"),
    "rc_tail": ("fractalshark_tpu_torch/csrc/rc_tail.cu",
                "fractalshark_tpu/ops/perturb_stream.py:395"),
}


def log(msg: str) -> None:
    print(msg, flush=True)


def crc(iters) -> int:
    return zlib.crc32(iters.cpu().numpy().astype("<u4").tobytes())


def timed(fn, device, reps: int = 1):
    """(result, ms per call) with CUDA events after one warm-up call."""
    import torch
    out = fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize(device)
    start.record()
    for _ in range(reps):
        out = fn()
    end.record()
    torch.cuda.synchronize(device)
    return out, start.elapsed_time(end) / reps


def compare(name, kern, plain, results):
    import torch
    a, b = kern.cpu(), plain.cpu()
    if a.shape != b.shape or a.dtype != b.dtype:
        raise AssertionError(f"{name}: {a.dtype}{tuple(a.shape)} vs "
                             f"{b.dtype}{tuple(b.shape)}")
    diff = (a.to(torch.float64) - b.to(torch.float64)).abs()
    err = float(diff.max()) if diff.numel() else 0.0
    bad = int((a != b).sum())
    log(f"  {name}: {bad} of {a.numel()} differ, max_abs_err {err}")
    if bad:
        raise AssertionError(f"{name}: kernel disagrees with its plain "
                             f"version at {bad} elements")
    results["max_abs_err"] = max(results.get("max_abs_err", 0.0), err)


# ---------------------------------------------------------------- phases


def phase_card(torch):
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()
    card = smi[0] if smi else "nvidia-smi: no output"
    log(f"[1] card: {card}; {torch.cuda.get_device_name(0)}; torch "
        f"{torch.__version__}, CUDA {torch.version.cuda}, python "
        f"{sys.version.split()[0]}")
    return card


def phase_build():
    from fractalshark_tpu_torch import kernels
    t0 = time.perf_counter()
    so = kernels.build(verbose=True)
    kernels.lib()
    log(f"[2] build: {so.name} in {time.perf_counter() - t0:.2f} s")


def deep_inputs(view_or_center, size, device):
    """Host tables and dc grid of a deep frame, via the engine."""
    from fractalshark_tpu.core.pointzoom import PointZoomBBConverter
    from fractalshark_tpu.engine.la_reference import get_or_build_la
    from fractalshark_tpu_torch.engine.fractal import Fractal
    from fractalshark_tpu_torch.engine.renderers import get_orbit_calc
    from fractalshark_tpu_torch.ops import la_kernel
    from fractalshark_tpu_torch.ops.perturb import _dc_grids_hdr, delta_params

    if isinstance(view_or_center, int):
        f = Fractal(width=size, height=size, view=view_or_center,
                    device=device)
    else:
        x, y, zoom, n = view_or_center
        ptz = PointZoomBBConverter(pt_x=x, pt_y=y, zoom_factor=zoom,
                                   prec=512)
        f = Fractal(width=size, height=size, view=ptz, num_iterations=n,
                    device=device)
    calc = get_orbit_calc(f)
    res = calc.get_and_create_useful_results(f.ptz, f.num_iterations)
    la = get_or_build_la(f, res)
    T, orbit = la_kernel.device_tables(res, la, f.device)
    dx, dy, cxo, cyo = delta_params(f.ptz, res.center_x, res.center_y,
                                    size, size)
    dc = _dc_grids_hdr(dx, dy, cxo, cyo, size, size, f.device)
    return f, res, la, T, orbit, dc, calc.last_details.get("backend")


def phase_kernels(device, size_escape=1024, size_deep=256,
                  size_small=64):
    """Each kernel against its plain version on the card."""
    import torch

    from fractalshark_tpu.core.views import get_view_preset
    from fractalshark_tpu.engine.perturbation_results import CompressedOrbit
    from fractalshark_tpu_torch.ops import escape, la_kernel
    from fractalshark_tpu_torch.ops import perturb_stream as ps
    from fractalshark_tpu_torch.ops.hdrfloat import HDRComplex

    stats = {k: {} for k in KERNEL_META}
    log("[3] kernels vs plain versions on the card")

    # K1 at View 0, the main path's 1024² (f32 = Gpu1x32, f64 = Gpu1x64)
    ptz = get_view_preset(0).ptz.square_aspect_ratio(size_escape, size_escape)
    p = escape.PlainParams.from_view(ptz, size_escape, size_escape)
    for dt in ("f32", "f64"):
        tdt = torch.float32 if dt == "f32" else torch.float64
        k, ms = timed(lambda: escape.escape_kernel(
            p, size_escape, size_escape, 256, tdt, device), device, reps=5)
        pl, pms = timed(lambda: escape.escape_plain(
            p, size_escape, size_escape, 256, tdt, device), device)
        compare(f"K1 escape {dt} View 0 {size_escape}² x256", k, pl,
                stats["escape"])
        log(f"    kernel {ms:.3f} ms, plain {pms:.3f} ms")
        if dt == "f32":
            stats["escape"].update(ms=ms, plain_ms=pms)

    def k2(T, orbit, dc, n, max_ref, la_only):
        flat = HDRComplex(*(t.reshape(-1) for t in dc))
        kern = lambda: la_kernel.lav2_run(  # noqa: E731
            T, orbit, dc, n, max_ref, la_only)
        plain = lambda: la_kernel.lav2_plain(  # noqa: E731
            T, orbit, flat, la_kernel.init_state_plain(T, flat, n), n,
            max_ref, la_only)
        ks, ms = timed(kern, device, reps=3)
        ps_, pms = timed(plain, device)
        return ks, [t.reshape(dc.re.shape) for t in ps_], ms, pms

    def k2_both(label, T, orbit, dc, n, max_ref, modes):
        """K2 against its plain twin, every state array; (ms, plain ms)
        of the last mode."""
        for la_only in modes:
            key = "lav2_phase1" if la_only else "lav2_full"
            ks, pls, ms, pms = k2(T, orbit, dc, n, max_ref, la_only)
            for i, name in enumerate(la_kernel._STATE):
                compare(f"K2 {key} {label} {name}", ks[i], pls[i], stats[key])
            log(f"    kernel {ms:.3f} ms, plain {pms:.3f} ms")
        return ks, ms, pms

    # K2 in both modes on the small-table deep frame (full mode is its
    # main-path route) and on View #6, at the small size
    f, res, la, T, orbit, dc, backend = deep_inputs(SMALL_DEEP, size_small,
                                                    device)
    _, ms, pms = k2_both(f"1e8 {size_small}²", T, orbit, dc, SMALL_DEEP[3],
                         res.max_ref_iteration(), (True, False))
    stats["lav2_full"].update(ms=ms, plain_ms=pms)
    f, res_s, la, T, orbit, dc_s, backend = deep_inputs(6, size_small, device)
    st_s, _, _ = k2_both(f"View #6 {size_small}²", T, orbit, dc_s,
                         f.num_iterations, res_s.max_ref_iteration(),
                         (False, True))

    # K2 phase-1 and K3 (identity anchors) on View #6 at the main path's
    # size; K3 over real compressed anchors at the small size
    f, res, la, T, orbit, dc, backend = deep_inputs(6, size_deep, device)
    n = f.num_iterations
    ks, ms, pms = k2_both(f"View #6 {size_deep}²", T, orbit, dc, n,
                          res.max_ref_iteration(), (True,))
    stats["lav2_phase1"].update(ms=ms, plain_ms=pms)

    def k3(comp, state, dc, label):
        A = ps.anchors_on(comp, device)
        init = {"dzr": state[3], "dzi": state[4], "dze": state[5],
                "it": state[6], "jwait": state[2], "done": state[6] >= n}
        z_mr = ps.wrap_value(comp, A.max_ref)
        flat = HDRComplex(*(t.reshape(-1) for t in dc))
        kern = lambda: ps.rc_tail_run(A, dc, init, n, z_mr)  # noqa: E731

        def plain():
            st = ps.rc_init_plain(A, ps.handoff_state(init, device), n,
                                  z_mr)
            return ps.rc_tail_plain(A, flat, st)[3]

        rk, ms = timed(kern, device, reps=3)
        rp, pms = timed(plain, device)
        compare(f"K3 {label} remaining budget", rk, rp, stats["rc_tail"])
        log(f"    kernel {ms:.3f} ms, plain {pms:.3f} ms")
        return ms, pms

    ms, pms = k3(CompressedOrbit.identity(res), ks, dc,
                 f"identity anchors View #6 {size_deep}²")
    stats["rc_tail"].update(ms=ms, plain_ms=pms)
    comp = CompressedOrbit.from_uncompressed(res_s, error_exp=8)
    log(f"    compressed orbit: {len(comp.anchors_x)} anchors of "
        f"{comp.total_count} (ratio {comp.compression_ratio():.2f})")
    k3(comp, st_s, dc_s, f"compressed anchors (error_exp 8) View #6 "
       f"{size_small}²")
    return stats, backend


def cli_run(argv):
    from fractalshark_tpu_torch import cli
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(argv)
    wall = time.perf_counter() - t0
    if rc != 0:
        raise AssertionError(f"cli {' '.join(argv)} exited {rc}")
    stats = json.loads(buf.getvalue().strip().splitlines()[-1])
    return stats, wall


def phase_slice(outdir, device="cuda"):
    """The main path through the CLI, with the kernels' counters."""
    from fractalshark_tpu_torch import kernels
    log("[4] the slice through fractalshark_tpu_torch.cli.main")
    kernels.reset_counts()
    runs = {}

    def run(label, argv, want_alg, want_kernels):
        before = dict(kernels.launches)
        s, wall = cli_run(argv + ["--stats", "--device", device])
        grew = {k: kernels.launches[k] - before[k] for k in kernels.launches}
        log(f"  {label}: {s['algorithm']} via {s['kernel']}, iter_sum "
            f"{s['iter_sum']}, crc32 {s['crc32']}, wall {wall:.3f} s, "
            f"launches {grew}")
        log(f"    timings {json.dumps(s['timings'])}")
        if s["algorithm"] != want_alg:
            raise AssertionError(f"{label}: algorithm {s['algorithm']}")
        for k in want_kernels:
            if grew[k] <= 0:
                raise AssertionError(f"{label}: kernel {k} never launched")
        runs[label] = s
        return s

    png = os.path.join(outdir, "view0_1024.png")
    s = run("View 0 AUTO 1024²", ["--view", "0", "--width", "1024",
                                  "--height", "1024", "--output-png", png],
            "Gpu1x32", ["escape"])
    if not (s["iter_min"] >= 0 and s["iter_max"] <= 256 and s["iter_sum"] > 0
            and os.path.getsize(png) > 1000):
        raise AssertionError("View 0 frame is not plausible")
    x, y, zoom, budget = SMALL_DEEP
    run("small-table deep frame 64²",
        ["--center-x", x, "--center-y", y, "--zoom", zoom, "--iterations",
         str(budget), "--render-algorithm", "GpuHDRx32PerturbedLAv2",
         "--width", "64", "--height", "64"],
        "GpuHDRx32PerturbedLAv2", ["lav2_full"])
    for size, want in ((64, VIEW6_64), (256, VIEW6_256)):
        png = os.path.join(outdir, f"view6_{size}.png")
        s = run(f"View #6 AUTO {size}²",
                ["--view", "6", "--width", str(size), "--height", str(size),
                 "--output-png", png],
                "GpuHDRx32PerturbedLAv2", ["lav2_phase1", "rc_tail"])
        got = (s["iter_sum"], s["crc32"])
        log(f"    expected (JAX CPU, FMA off) {want}, got {got}")
        if got != want:
            raise AssertionError(f"View #6 {size}²: {got} != {want}")
    log(f"  View #6 256² iter_sum {runs['View #6 AUTO 256²']['iter_sum']}; "
        f"known other values: TPU v5e {VIEW6_256_TPU} (BENCH_r05), JAX CPU "
        f"with FMA contraction {VIEW6_256_JAX_CPU_FMA}")
    return dict(kernels.launches), runs


def main() -> int:
    try:
        import torch
    except ImportError:
        print("FAIL: torch is not installed", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("FAIL: no CUDA device", file=sys.stderr)
        return 1
    try:
        import fractalshark_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"FAIL: the port is not importable here: {e}", file=sys.stderr)
        return 1
    device = torch.device("cuda", 0)
    t0 = time.perf_counter()
    card = phase_card(torch)
    phase_build()
    stats, backend = phase_kernels(device)
    log(f"    orbit backend: {backend}")
    with tempfile.TemporaryDirectory() as outdir:  # the frames' PNGs
        launches, runs = phase_slice(outdir)
    if "jax" in sys.modules:
        raise AssertionError("jax was imported")
    kernels_out = []
    for name, (src, replaces) in KERNEL_META.items():
        st = stats[name]
        kernels_out.append({
            "name": name, "route": "cuda", "source": src,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": st["max_abs_err"], "ms": st["ms"],
            "plain_ms": st["plain_ms"]})
    log(f"total {time.perf_counter() - t0:.1f} s")
    print(card)
    print(json.dumps({"kernels": kernels_out}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
