#!/usr/bin/env python3
"""The feature-zoom animation clip through the PyTorch/CUDA port
(``fractalshark_tpu_torch``): the counterpart of
``tools/autozoom_clip.py``, the acceptance artifact of the feature-zoom
pipeline (the reference's AutoZoomer animation,
``FractalSharkLib/AutoZoomer.h:7-31``).

From View 0 toward View #5's centre: ``AutoZoomer.setup_feature_zoom``
precomputes ×1.1 steps (the budget interpolated from 2,048 to 4,096), and
``run_feature_zoom_pipeline`` presents them at a fixed cadence through
``RenderThreadPool`` (two workers, one device lock) and ``PacedPresenter``.
Each presented frame is written as ``<outdir>/frame_NNN.png`` and the
manifest as ``<outdir>/clip.json``: the JAX tool's keys, the clip's
kernel launches, and for each frame the route and kernel of its step.
These come from a direct ``Fractal`` render of the step after the clip
(launches counted from 0), which must give the presented frame's pixels
(``equals_direct``).

    python3 tools/autozoom_clip_torch.py [n_frames] [size] [fps] [outdir]
        [--device cuda]

Defaults: 24 frames, 256 px, 10 fps, ``.clips/autozoom_torch``.  With
``max_steps`` at n_frames the clip stops n_frames steps into the path
(24: a zoom of 1.1^24 = 9.85, K1 in f32 on the card); the whole path to
View #5 is 1,090 steps.  The last line of standard output is the manifest
without its frames, as one JSON object.  The device is CUDA unless
``--device cpu`` is asked for; CUDA without a card raises.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

TOOLS = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(TOOLS)
for _p in (ROOT, TOOLS):
    if _p not in sys.path:
        sys.path.insert(0, _p)

START_ITERS, TARGET_ITERS = 2048, 4096
TARGET_VIEW = 5


def run(n_frames: int = 24, size: int = 256, fps: float = 10.0,
        outdir: str = os.path.join(".clips", "autozoom_torch"),
        device="cuda") -> dict:
    """Render and present the clip; return its manifest (also written to
    ``<outdir>/clip.json``) and print it, without its frames, as one JSON
    line."""
    import torch

    from fractalshark_tpu_torch import kernels
    from fractalshark_tpu_torch.core.views import get_view_preset
    from fractalshark_tpu_torch.engine.autozoom import AutoZoomer
    from fractalshark_tpu_torch.engine.fractal import Fractal
    from fractalshark_tpu_torch.engine.render_pool import RenderThreadPool
    from fractalshark_tpu_torch.io.png import write_png
    from fractalshark_tpu_torch.ops.coloring import rgba16_to_numpy

    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device 'cuda' requested but CUDA is not "
                           "available")
    os.makedirs(outdir, exist_ok=True)
    f = Fractal(width=size, height=size, view=0,
                num_iterations=START_ITERS, device=dev)
    pool = RenderThreadPool(f, num_workers=2)
    az = AutoZoomer(f)
    steps = az.setup_feature_zoom(
        target_ptz=get_view_preset(TARGET_VIEW).ptz,
        target_iters=TARGET_ITERS, max_steps=n_frames)

    t_start = time.perf_counter()
    frames_meta, rgbas = [], []

    def on_frame(frame):
        i = len(frames_meta)
        write_png(os.path.join(outdir, f"frame_{i:03d}.png"), frame.rgba)
        rgbas.append(frame.rgba)
        frames_meta.append({
            "i": i, "generation": frame.generation,
            "present_t": round(time.perf_counter() - t_start, 4),
            "render_wall_s": round(frame.wall_s, 4)})

    kernels.reset_counts()
    try:
        res = az.run_feature_zoom_pipeline(pool, steps, interval_s=1.0 / fps,
                                           on_frame=on_frame,
                                           timeout_s=1800.0)
        wall = time.perf_counter() - t_start
    finally:
        pool.shutdown()
    launches = {k: v for k, v in kernels.launches.items() if v}

    # each presented frame against a direct render of its step, built as
    # the pool's workers build theirs
    for meta, step, rgba in zip(frames_meta, steps, rgbas):
        g = Fractal(width=size, height=size, view=step.ptz,
                    num_iterations=step.num_iterations, device=dev)
        kernels.reset_counts()
        direct = rgba16_to_numpy(g.render())
        meta.update(zoom=step.ptz.zoom_factor.to_string(12),
                    num_iterations=step.num_iterations,
                    route=g.resolve_algorithm().name,
                    kernel=g.benchmark.extra.get("kernel"),
                    launches={k: v for k, v in kernels.launches.items()
                              if v},
                    equals_direct=bool(np.array_equal(direct, rgba)))

    gaps = [b["present_t"] - a["present_t"]
            for a, b in zip(frames_meta, frames_meta[1:])]
    span = frames_meta[-1]["present_t"] - frames_meta[0]["present_t"] \
        if len(frames_meta) > 1 else 0.0
    gens = [m["generation"] for m in frames_meta]
    manifest = {
        "n_steps": len(steps),
        "presented": res["presented"],
        "aborted": res["aborted"],
        "size": size, "cadence_fps": fps,
        "wall_s": round(wall, 2),
        "achieved_fps": round((res["presented"] - 1) / max(1e-9, span), 2)
        if res["presented"] > 1 else 0.0,
        "min_gap_s": round(min(gaps), 4) if gaps else None,
        "max_gap_s": round(max(gaps), 4) if gaps else None,
        "zoom_start": str(steps[0].ptz.zoom_factor)[:20],
        "zoom_end": str(steps[-1].ptz.zoom_factor)[:20],
        "device": str(dev),
        "in_generation_order": gens == sorted(gens),
        "all_equal_direct": all(m["equals_direct"] for m in frames_meta),
        "routes": sorted({m["route"] for m in frames_meta}),
        "launches": launches,
        "frames": frames_meta,
    }
    if dev.type == "cuda":
        import run_view32_torch as rv32
        manifest.update(card=rv32.card_line(),
                        kind=torch.cuda.get_device_name(dev))
    with open(os.path.join(outdir, "clip.json"), "w") as fp:
        json.dump(manifest, fp, indent=1)
    print(json.dumps({k: v for k, v in manifest.items() if k != "frames"}),
          flush=True)
    return manifest


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("n_frames", type=int, nargs="?", default=24)
    ap.add_argument("size", type=int, nargs="?", default=256)
    ap.add_argument("fps", type=float, nargs="?", default=10.0)
    ap.add_argument("outdir", nargs="?",
                    default=os.path.join(".clips", "autozoom_torch"))
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args(argv)
    run(a.n_frames, a.size, a.fps, a.outdir, a.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
