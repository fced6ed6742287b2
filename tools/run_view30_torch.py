#!/usr/bin/env python3
"""View #30 on one NVIDIA card through the PyTorch/CUDA port
(``fractalshark_tpu_torch``): the counterpart of ``tools/run_view30.py``
(the record run) and ``tools/zoomseq_view30.py`` (the zoom sequence) in
one file.

View #30 is zoom 1.4e114514 at the preset's budget of 200,000,000; its
reference orbit has period 669,773 at 16,384 limbs.  The orbit, its store,
the LA table and the single frame are ``tools/run_view32_torch.py``'s
``run`` (the device orbit on K12's grid form, the native LA build, K2
``la_only`` then K6 resumed); its record goes to
``<out_dir>/view30_progress.json``.  Then:

* ``equals_record``: at 512² and the preset's budget the frame's period
  and iter_sum are held to ``data/records.json:view30_e2e``;
* the frame's PNG (``<out_dir>/view30_<size>.png``, the default palette,
  ``io/png.py``), its time kept apart from the render's: ``--size 2048``
  is the README's poster;
* with ``--sequence N``: N frames zooming in toward the view, frame k at
  ``zoomed_at_center(1 / step^(N-1-k))`` (``zoomseq_view30.py:89-93``),
  all against the one orbit and the one LA table built at the final
  radius, each through ``two_phase_render(..., release_la_tables=False)``
  so the device tables stay cached between frames (the orbit table on
  ``results.extra``, the LA table in ``la._torch_cache``).  Each frame
  keeps its wall time, phases, iter_sum, CRC-32 and K2/K6 launches; the
  first frame's wall stands apart from the median of the others.  On
  the card two warm frames are then traced (``torch.profiler``) and
  checked: no host-to-device copy, and K2's and K6's kernels each as
  often as their counted launches, at least once a frame.  The last
  frame has the single frame's box and must equal it pixel for pixel.  The record is
  ``<out_dir>/view30_sequence.json``, the grids
  ``<out_dir>/view30_sequence_<size>.npy`` ([N, size, size] int64).

A rerun with the same ``out_dir`` reads the finished orbit back from the
store (a square view keeps its box at every square size, so one orbit
serves 512² and 2048²).

    python3 tools/run_view30_torch.py [--size 512] [--sequence N]
        [--step 1.5] [--budget N] [--max-it 4000000]
        [--dir .v30cache_torch] [--device cuda]

The last line of standard output is the record as one JSON object (the
single frame's record, run_view32_torch's, comes on the line before).
The device is CUDA unless ``--device cpu`` is asked for (the plain twins;
only small locations finish there); the PNG is coloured on the same
device.  CUDA without a card raises.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time

import numpy as np

TOOLS = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(TOOLS)
for _p in (ROOT, TOOLS):
    if _p not in sys.path:
        sys.path.insert(0, _p)

import iters_to_png_torch as i2p  # noqa: E402
import run_view32_torch as rv32  # noqa: E402
from run_view27_torch import grid_pin  # noqa: E402

VIEW = 30
RECORD = os.path.join(ROOT, "data", "records.json")
RECORD_SIZE = 512        # data/records.json view30_e2e is a 512² frame


def _cached_tables(results, la) -> list:
    """The device tables the frames read: the orbit table on
    ``results.extra`` and the LA table in ``la._torch_cache``."""
    return [v for k, v in results.extra.items()
            if isinstance(k, tuple) and k[:1] == ("torch_orbit",)] + \
        list(getattr(la, "_torch_cache", {}).values())


# the kernels a sequence frame launches: their counters in ``kernels``
# and their names in a profiler trace
FRAME_KERNELS = {"lav2_phase1": "lav2_kernel",
                 "two_phase_tail": "perturb_kernel"}


def _trace(render) -> dict:
    """Kernels and host-to-device copies of `render` (two warm frames)
    from a ``torch.profiler`` trace of the card: count and device µs by
    name."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        render()
    kernels, copies = {}, {"count": 0, "device_us": 0.0}
    for ev in prof.key_averages():
        if ev.device_type != DeviceType.CUDA:
            continue
        us = float(ev.device_time_total)
        if ev.key.startswith("Memcpy HtoD"):
            copies["count"] += ev.count
            copies["device_us"] = round(copies["device_us"] + us, 1)
        elif not ev.key.startswith(("Memcpy", "Memset")):
            kernels[ev.key] = {"count": ev.count, "device_us": round(us, 1)}
    return {"kernels": kernels, "htod_copies": copies}


def check_trace(trace: dict, launches: dict, frames: int) -> None:
    """Raise unless the traced frames made no host-to-device copy and each
    kernel of FRAME_KERNELS ran as often as its counter says (`launches`,
    counted over the same frames), at least once a frame."""
    if trace["htod_copies"]["count"]:
        raise AssertionError(f"warm frames copied to the card: "
                             f"{trace['htod_copies']}")
    for counter, name in FRAME_KERNELS.items():
        traced = sum(v["count"] for k, v in trace["kernels"].items()
                     if name in k)
        if traced != launches[counter] or traced < frames:
            raise AssertionError(
                f"{frames} warm frames: {name} traced {traced} times, "
                f"{counter} counted {launches[counter]}")


def sequence(results, la, base, size: int, budget: int, frames: int,
             step: float, dev, trace: bool = False
             ) -> tuple[dict, np.ndarray]:
    """The zoom sequence: `frames` frames toward `base` against one orbit
    and one LA table; (its record, the grids [frames, size, size]).  With
    `trace` (the card only), the last two frames are rendered again under
    ``torch.profiler`` and held by ``check_trace``."""
    import torch

    from fractalshark_tpu_torch import kernels
    from fractalshark_tpu_torch.engine.renderers import two_phase_render

    dev = torch.device(dev)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    boxes = [base.zoomed_at_center(1.0 / step ** (frames - 1 - k))
             for k in range(frames)]
    recs, grids, tables = [], [], None
    for k, ptz in enumerate(boxes):
        kernels.reset_counts()
        timings: dict = {}
        sync()
        t0 = time.perf_counter()
        out = two_phase_render(results, la, ptz, size, size, budget,
                               device=dev, timings=timings,
                               release_la_tables=False)
        sync()
        wall = time.perf_counter() - t0
        g = out.cpu().numpy().astype(np.int64)
        grids.append(g)
        iter_sum, crc = grid_pin(g)
        recs.append({"k": k, "scale": 1.0 / step ** (frames - 1 - k),
                     "zoom": ptz.zoom_factor.to_string(12),
                     "wall_s": round(wall, 6),
                     "phase1_s": round(timings["phase1_s"], 6),
                     "phase2_s": round(timings["phase2_s"], 6),
                     "tail": timings["tail"], "iter_sum": iter_sum,
                     "crc32": crc,
                     "launches": {n: kernels.launches[n]
                                  for n in FRAME_KERNELS}})
        ids = [id(t) for t in _cached_tables(results, la)]
        if tables is None:
            tables = ids
        elif ids != tables:
            raise AssertionError(f"frame {k} put the device tables on the "
                                 "card again")
    warm = [r["wall_s"] for r in recs[1:]]
    med = statistics.median(warm) if warm else None
    rec = {"frames": frames, "step": step, "size": size, "budget": budget,
           "device": str(dev), "first_wall_s": recs[0]["wall_s"],
           "warm_median_s": med,
           "warm_min_s": min(warm) if warm else None,
           "warm_max_s": max(warm) if warm else None,
           "mpix_per_s": size * size / med / 1e6 if med else None,
           "tables_cached": len(tables), "per_frame": recs}
    if trace and dev.type == "cuda" and frames >= 2:
        def two():
            for ptz in boxes[-2:]:
                two_phase_render(results, la, ptz, size, size, budget,
                                 device=dev, release_la_tables=False)
            sync()
        kernels.reset_counts()
        rec["trace_two_warm_frames"] = _trace(two)
        check_trace(rec["trace_two_warm_frames"],
                    {n: kernels.launches[n] for n in FRAME_KERNELS}, 2)
    return rec, np.stack(grids)


def run(size: int = 512, budget: int | None = None,
        max_it: int = 4_000_000, chunk: int = 256,
        out_dir: str = ".v30cache_torch", device="cuda",
        limbs: int | None = 16384, ptz=None, frames: int = 0,
        step: float = 1.5) -> dict:
    """The single frame (``run_view32_torch.run`` for View #30, or `ptz`),
    its PNG and, with `frames`, the zoom sequence; return the record,
    written to ``<out_dir>/view30_progress.json`` (the sequence's to
    ``view30_sequence.json``), and print it as one JSON line."""
    import torch

    from fractalshark_tpu_torch.core.views import get_view_preset
    from fractalshark_tpu_torch.io.png import write_png

    tables: dict = {}
    st = rv32.run(view=VIEW, size=size, budget=budget, max_it=max_it,
                  chunk=chunk, out_dir=out_dir, device=device, limbs=limbs,
                  ptz=ptz, tables=tables)
    if st["phase"] != "done":
        return st
    dev = torch.device(device)
    grid = np.load(os.path.join(out_dir, f"view{VIEW}_iters_{size}.npy"))
    st["crc32"] = grid_pin(grid)[1]
    if ptz is None and size == RECORD_SIZE and \
            st["budget"] == get_view_preset(VIEW).num_iterations:
        with open(RECORD) as f:
            want = json.load(f)["view30_e2e"]
        st["equals_record"] = (st["period"], st["iter_sum"]) == \
            (want["period"], want["iter_sum"])
    # the PNG from the grid where it was rendered, timed apart
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    write_png(os.path.join(out_dir, f"view{VIEW}_{size}.png"),
              i2p.colour(tables["grid"], budget=st["budget"], device=dev))
    st["png_s"] = round(time.perf_counter() - t0, 3)
    if frames:
        seq, grids = sequence(tables["results"], tables["la"],
                              tables["ptz"], size, st["budget"], frames,
                              step, dev, trace=True)
        seq["last_equals_single"] = bool(np.array_equal(grids[-1], grid))
        seq["last_differing_px"] = int((grids[-1] != grid).sum())
        seq.update(card=st.get("card"), kind=st.get("kind"))
        np.save(os.path.join(out_dir, f"view{VIEW}_sequence_{size}.npy"),
                grids)
        with open(os.path.join(out_dir, f"view{VIEW}_sequence.json"),
                  "w") as f:
            json.dump(seq, f)
        st["sequence"] = {k: v for k, v in seq.items()
                          if k not in ("per_frame", "trace_two_warm_frames")}
    st["total_s"] = round(time.time() - st["t0"], 1)
    with open(os.path.join(out_dir, f"view{VIEW}_progress.json"), "w") as f:
        json.dump(st, f)
    print(json.dumps(st), flush=True)
    return st


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--size", type=int, default=512,
                    help="frame side in pixels (2048: the poster)")
    ap.add_argument("--sequence", type=int, nargs="?", const=8, default=0,
                    metavar="N", help="render N frames (8 if N is not "
                    "given) zooming in toward the view")
    ap.add_argument("--step", type=float, default=1.5,
                    help="the zoom ratio of two frames of the sequence")
    ap.add_argument("--budget", type=int, default=None,
                    help="per-pixel budget, the preset's by default")
    ap.add_argument("--max-it", type=int, default=4_000_000,
                    help="orbit cap in iterations (run_view30.py MAX_IT)")
    ap.add_argument("--dir", default=".v30cache_torch",
                    help="orbit store and record directory")
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args(argv)
    run(size=a.size, budget=a.budget, max_it=a.max_it, out_dir=a.dir,
        device=a.device, frames=a.sequence, step=a.step)
    return 0


if __name__ == "__main__":
    sys.exit(main())
