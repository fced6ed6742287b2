"""Queued hi-res renderer — the FractalTray analogue; the port of
``fractalshark_tpu/tray.py``.

The reference's tray app queues saved locations for unattended hi-res
rendering; this module consumes a saved-locations file and renders each
entry to a PNG, with per-item progress, abort support, and parallel PNG
encoding.  Poster mode (``--tile-rows``) renders a direct-escape location
in checkpointed row bands (``parallel/tile_farm.py``, K1 f64 with the
band's first row as ``y0``), resumable across runs.

    python -m fractalshark_tpu_torch.tray locations.txt --out-dir renders/
    python -m fractalshark_tpu_torch.tray locations.txt --tile-rows 128 \\
        --device cpu
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="fractalshark-tray")
    p.add_argument("locations", help="saved-locations text file")
    p.add_argument("--out-dir", default=".")
    p.add_argument("--render-algorithm", default="AUTO")
    p.add_argument("--width", type=int, default=None,
                   help="override the per-location width")
    p.add_argument("--height", type=int, default=None)
    p.add_argument("--abort-file", default=None,
                   help="touch this file to stop the queue")
    p.add_argument("--tile-rows", type=int, default=None,
                   help="poster mode: render in checkpointed row bands "
                        "of this height (resumable across runs)")
    p.add_argument("--ckpt-dir", default=None,
                   help="tile checkpoint directory (default: out-dir)")
    p.add_argument("--device", default="cuda",
                   help="torch device: cuda (kernels) or cpu (plain "
                        "PyTorch versions)")
    args = p.parse_args(argv)

    import torch

    from fractalshark_tpu_torch.engine.fractal import Fractal
    from fractalshark_tpu_torch.io.png_parallel import write_png_parallel
    from fractalshark_tpu_torch.io.saved_location import load_locations
    from fractalshark_tpu_torch.ops.coloring import rgba16_to_rgba8
    from fractalshark_tpu_torch.utils.aux import AbortMonitor

    locs = load_locations(args.locations)
    if not locs:
        print("no locations found", file=sys.stderr)
        return 2
    os.makedirs(args.out_dir, exist_ok=True)
    monitor = AbortMonitor(sentinel_file=args.abort_file) \
        if args.abort_file else None

    for i, loc in enumerate(locs):
        if monitor is not None and monitor.aborted():
            print("aborted by sentinel")
            break
        w = args.width or loc.width or 1024
        h = args.height or loc.height or 1024
        t0 = time.perf_counter()
        f = Fractal(width=w, height=h, view=loc.to_view(),
                    algorithm=args.render_algorithm,
                    num_iterations=loc.num_iterations,
                    antialiasing=max(1, loc.antialiasing),
                    device=args.device)
        # poster mode's band renderer is the plain f64 escape kernel —
        # only valid for direct (non-reference) algorithms.  A deep
        # perturbation-class location silently got a garbage image here
        # (ADVICE r2 #4); route those through the full renderer dispatch.
        tile_ok = args.tile_rows and \
            not f.resolve_algorithm().requires_reference
        if args.tile_rows and not tile_ok:
            print(f"[{i + 1}/{len(locs)}] {loc.description!r}: algorithm "
                  f"{f.resolve_algorithm().name} needs a reference orbit "
                  "— rendering whole-frame instead of tiled",
                  file=sys.stderr)
        if tile_ok:
            # poster mode: checkpointed resumable tile farm — a killed
            # queue resumes from the finished bands (direct escape
            # algorithms; y0-offset bands are bit-identical to the
            # whole image)
            from fractalshark_tpu_torch.parallel.tile_farm import (
                TileFarm, render_tile_escape)

            ck = os.path.join(args.ckpt_dir or args.out_dir,
                              f"tiles_{i:03d}")
            farm = TileFarm(f.ptz, w, h, args.tile_rows, ck)
            farm.run(render_tile_escape(np.float64, f.num_iterations,
                                        f.device))
            iters = farm.gather_local()
            rgba = f.color(torch.from_numpy(iters.astype(np.int64))
                           .to(f.device))
        else:
            rgba = f.render()
        name = (loc.description.replace(" ", "_")[:40] or f"location{i}")
        out = os.path.join(args.out_dir, f"{i:03d}_{name}.png")
        write_png_parallel(out, rgba16_to_rgba8(rgba))
        print(f"[{i + 1}/{len(locs)}] {out} "
              f"({time.perf_counter() - t0:.1f}s, "
              f"alg {f.resolve_algorithm().name})")
    if monitor is not None:
        monitor.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
