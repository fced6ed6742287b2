"""Headless command-line renderer of the PyTorch/CUDA port: the slice
of ``fractalshark_tpu/cli.py`` that the deep-zoom render path needs,
with the same flag names, plus ``--device`` (default ``cuda``; ``cpu``
runs the kernels' plain PyTorch twins).

    python -m fractalshark_tpu_torch.cli --view 6 --width 256 \\
        --height 256 --output-png out.png --stats
    # the reference orbit on the card (K12) instead of native GMP
    python -m fractalshark_tpu_torch.cli --view 6 --width 256 \\
        --height 256 --perturbation-alg GPU --stats
    # find and refine the minibrot at the view centre (host evaluator)
    python -m fractalshark_tpu_torch.cli --view 6 --feature-find
"""

from __future__ import annotations

import argparse
import json
import sys
import time
import zlib


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="fractalshark-tpu-torch",
        description="deep-zoom Mandelbrot renderer (PyTorch + CUDA port)")
    p.add_argument("--render-algorithm", default="AUTO",
                   help="algorithm name (e.g. Gpu1x32, Cpu64, "
                        "GpuHDRx32PerturbedLAv2, AUTO)")
    p.add_argument("--view", type=int, default=None,
                   help="builtin view preset index (0..32)")
    p.add_argument("--center-x", default=None, help="center real coordinate")
    p.add_argument("--center-y", default=None, help="center imag coordinate")
    p.add_argument("--zoom", default=None, help="zoom factor (decimal string)")
    p.add_argument("--iterations", type=int, default=None)
    p.add_argument("--width", type=int, default=1024)
    p.add_argument("--height", type=int, default=1024)
    p.add_argument("--output-png", default=None)
    p.add_argument("--png-bit-depth", type=int, default=8, choices=[8, 16])
    p.add_argument("--perturbation-alg", default="Auto",
                   choices=["Auto", "ST", "MT", "Native", "GPU", "TPU"],
                   help="reference-orbit backend: Auto picks native C++ "
                        "when available; GPU/TPU = the on-device NTT orbit "
                        "(kernel K12 on --device); ST/MT = Python host")
    p.add_argument("--stats", action="store_true",
                   help="print iteration min/max/sum, the grid's CRC-32 "
                        "and phase timings as JSON")
    p.add_argument("--feature-find", action="store_true",
                   help="find+refine a periodic point (minibrot) at the "
                        "view center; prints a JSON summary")
    p.add_argument("--feature-scan", default=None, metavar="NXxNY",
                   help="grid-scan the view for periodic points "
                        "(e.g. 12x12); prints JSON summaries")
    p.add_argument("--feature-mode", default="direct",
                   choices=["direct", "pt", "la"],
                   help="Phase-A evaluator policy for --feature-scan "
                        "(FeatureFinderMode Direct/PT/LA)")
    p.add_argument("--feature-max-period", type=int, default=None)
    p.add_argument("--device", default="cuda",
                   help="torch device: cuda (kernels) or cpu (plain "
                        "PyTorch versions)")
    return p


def feature_summary(fs) -> dict:
    """The JSON record of one found feature (``fractalshark_tpu/cli.py``
    ``_summary``)."""
    return {"center_x": fs.center_x.to_string(40),
            "center_y": fs.center_y.to_string(40),
            "period": fs.period,
            "size_exp2": int(fs.size_estimate.e),
            "residual_exp2": fs.residual_exp2,
            "nr_iterations": fs.nr_iterations}


def feature_main(f, args) -> int:
    """--feature-find / --feature-scan: one JSON line, exit code 2 on a
    malformed grid (``fractalshark_tpu/cli.py:274-305``)."""
    max_period = (args.feature_max_period or
                  min(f.num_iterations, 1_000_000))
    if args.feature_scan:
        from fractalshark_tpu_torch.engine.feature_finder import \
            find_periodic_points_scan
        try:
            nx, ny = (int(v) for v in args.feature_scan.lower().split("x"))
        except ValueError:
            print(f"error: --feature-scan expects NXxNY, got "
                  f"{args.feature_scan!r}", file=sys.stderr)
            return 2
        feats = find_periodic_points_scan(f.ptz, max_period, grid=(nx, ny),
                                          mode=args.feature_mode)
        print(json.dumps({"found": len(feats),
                          "features": [feature_summary(x) for x in feats]}))
    else:
        fs = f.try_find_periodic_point(max_period=max_period)
        print(json.dumps(feature_summary(fs) if fs else None))
    return 0


def grid_crc32(iters) -> int:
    """CRC-32 of the grid's little-endian bytes (u32 below a 2^31
    budget), the repo's golden-CRC convention."""
    return zlib.crc32(iters.astype(iters.dtype.newbyteorder("<")).tobytes())


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    from fractalshark_tpu_torch.core.algorithms import get_algorithm
    from fractalshark_tpu_torch.core.highprecision import HighPrecision
    from fractalshark_tpu_torch.core.pointzoom import PointZoomBBConverter
    from fractalshark_tpu_torch.engine.fractal import Fractal

    try:
        get_algorithm(args.render_algorithm)
    except KeyError as e:
        print(f"error: {e.args[0]}", file=sys.stderr)
        return 2

    try:
        f = Fractal(width=args.width, height=args.height,
                    algorithm=args.render_algorithm, device=args.device)
    except (RuntimeError, ValueError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    if args.center_x is not None:
        if args.center_y is None or args.zoom is None:
            print("error: --center-x requires --center-y and --zoom",
                  file=sys.stderr)
            return 2
        zoom = HighPrecision(args.zoom, prec=64)
        prec = max(64, abs(zoom.exponent2()) + 192)
        f.set_view(PointZoomBBConverter(
            pt_x=HighPrecision(args.center_x, prec=prec),
            pt_y=HighPrecision(args.center_y, prec=prec),
            zoom_factor=HighPrecision(args.zoom, prec=prec)))
    else:
        try:
            f.set_view_preset(args.view if args.view is not None else 0)
        except KeyError:
            from fractalshark_tpu_torch.core.views import num_views
            print(f"error: no such view preset {args.view} "
                  f"(valid: 0..{num_views() - 1})", file=sys.stderr)
            return 2
    if args.iterations is not None:
        f.num_iterations = args.iterations
    if args.perturbation_alg != "Auto":
        from fractalshark_tpu_torch.engine.renderers import get_orbit_calc
        get_orbit_calc(f).orbit_backend = {
            "ST": "host", "MT": "host", "Native": "native",
            "GPU": "device", "TPU": "device"}[args.perturbation_alg]
    if args.feature_find or args.feature_scan:
        return feature_main(f, args)

    t0 = time.perf_counter()
    if args.output_png:
        f.save_png(args.output_png, bit_depth=args.png_bit_depth)
        print(f"wrote {args.output_png}")
    else:
        f.calc_fractal()
    elapsed = time.perf_counter() - t0

    if args.stats:
        stats = f.stats()
        bm = f.benchmark
        timings = {"ref_orbit_s": bm.ref_orbit_s,
                   "la_generation_s": bm.la_generation_s,
                   "per_pixel_s": bm.per_pixel_s}
        timings.update({k: v for k, v in bm.extra.items()
                        if k.endswith("_s")})
        print(json.dumps({
            "algorithm": f.resolve_algorithm().name,
            "width": f.width, "height": f.height,
            "iterations_budget": f.num_iterations,
            "iter_min": stats["min"], "iter_max": stats["max"],
            "iter_sum": stats["sum"],
            "crc32": grid_crc32(f.iters_numpy()),
            "wall_s": round(elapsed, 4),
            "per_pixel_s": round(bm.per_pixel_s, 4),
            "backend": f.backend,
            "kernel": bm.extra.get("kernel"),
            "orbit_backend": bm.extra.get("backend"),
            "orbit_len": bm.extra.get("orbit_len"),
            "orbit_period": bm.extra.get("period"),
            "la_phase": bm.extra.get("la_phase"),
            "timings": timings,
        }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
