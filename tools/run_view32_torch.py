#!/usr/bin/env python3
"""View #32 end to end on one NVIDIA card through the PyTorch/CUDA port
(``fractalshark_tpu_torch``): the counterpart of ``tools/run_view32.py``.

View #32 is the reference's deepest demonstrated render: zoom 1.6e244240,
an 811,541-bit centre, the 32,768-limb class of the device orbit.  The
script runs its phases in order and writes its record to
``<out_dir>/view32_progress.json`` after each one:

* ``orbit``: the reference orbit on the device
  (``compute_reference_orbit_device``: K12's grid form at 32,768 limbs,
  periodicity on, checkpointed under ``<out_dir>/view32_orbit``);
* ``cap_hit``: the cap came before the period or an escape; the record
  gives this run's rate and the projection (seconds a million
  iterations), and no frame;
* ``la_build``: the LA table on the host (``generate_auto``, the native
  build, with the orbit's exponents);
* ``render``: the two-phase frame (K2 ``la_only``, then K6 resumed over
  the orbit); at 256² and the preset's budget, ``equals_artifact`` holds
  the int64 grid to the JAX package's ``artifacts/view32_iters.npy``.

A rerun with the same ``out_dir`` resumes the orbit bit for bit from its
checkpoint (``max_it`` is the total cap), or, once the orbit has found its
period or escaped, reads it back from the store instead of computing it
(``view32_orbit.done.json``): a square view keeps its box at every square
size, so a 512² frame reuses the 256² frame's orbit.

    python3 tools/run_view32_torch.py [--size 256] [--budget N]
        [--max-it 48000000] [--dir .v32cache_torch] [--ck-every 600]
        [--device cuda]

The last line of standard output is the record as one JSON object.  The
device is CUDA unless ``--device cpu`` is asked for (the plain twins; only
small locations finish there); CUDA without a card raises.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

ARTIFACT = os.path.join(ROOT, "artifacts", "view32_iters.npy")
# the JAX package's record of the same frame (data/records.json
# view32_e2e): the artifact's pixels are compared only at this size and
# the preset's budget
ARTIFACT_VIEW, ARTIFACT_SIZE = 32, 256


def card_line() -> str | None:
    """The card's name and power limit as ``nvidia-smi`` gives them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip().splitlines()
    except (OSError, subprocess.SubprocessError):
        return None
    return out[0] if out else None


def _orbit_key(ptz, limbs) -> str:
    """What a stored orbit was computed for: the centre, the radius and
    the limbs."""
    h = hashlib.sha256()
    for v in (ptz.pt_x, ptz.pt_y, ptz.radius):
        h.update(f"{v.mant:x}p{v.exp}/".encode())
    h.update(str(limbs).encode())
    return h.hexdigest()[:16]


def stored_orbit(ck: str, done: dict, ptz, max_it: int):
    """The finished orbit of an earlier run, from its store."""
    from fractalshark_tpu_torch.engine.perturbation_results import \
        PerturbationResults
    from fractalshark_tpu_torch.utils.growable import GrowableArray

    n = int(done["count"])
    if n - 1 > max_it:
        raise ValueError(f"the stored orbit has {n - 1} iterations, past "
                         f"max_it {max_it}")
    arrs = []
    for ext in ("x", "y", "e"):
        g = GrowableArray.open_existing(f"{ck}.{ext}")
        if len(g) != n:
            raise ValueError(f"{ck}.{ext} holds {len(g)} entries, the "
                             f"record {n}")
        arrs.append(g.view())
    xs, ys, es = arrs
    return PerturbationResults(
        center_x=ptz.pt_x, center_y=ptz.pt_y,
        orbit_x=np.asarray(xs, np.float64),
        orbit_y=np.asarray(ys, np.float64), max_radius=ptz.radius,
        period=int(done["period"]), escaped_at=int(done["escaped_at"]),
        max_iterations=max_it, precision_bits=int(done["precision_bits"]),
        orbit_e=np.asarray(es, np.int32) if (es != 0).any() else None)


def run(view: int = 32, size: int = 256, budget: int | None = None,
        max_it: int = 48_000_000, chunk: int = 256,
        out_dir: str = ".v32cache_torch", ck_every_s: float = 600,
        device="cuda", limbs: int | None = 32768, ptz=None,
        tables: dict | None = None) -> dict:
    """Run the phases (orbit, then la_build and render, or cap_hit) for
    `view` (its preset's box, or `ptz`) at `size`² and `budget` (the
    preset's when None); return the record, also written to
    ``<out_dir>/view<view>_progress.json``, and print it as one JSON
    line.  `tables`: a dict that receives the orbit's results, the LA
    table and the frame's box ('results', 'la', 'ptz') once the table is
    built, for a caller that renders more frames from them, and the
    frame's grid on the device ('grid') once it is rendered."""
    import torch

    from fractalshark_tpu_torch import kernels
    from fractalshark_tpu_torch.core.hdr_host import HD
    from fractalshark_tpu_torch.core.views import get_view_preset
    from fractalshark_tpu_torch.engine.la_reference import LAReferenceHost
    from fractalshark_tpu_torch.engine.renderers import two_phase_render
    from fractalshark_tpu_torch.ops.bignum.orbit import \
        compute_reference_orbit_device

    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device 'cuda' requested but CUDA is not "
                           "available")
    preset = get_view_preset(view)
    from_preset = ptz is None
    ptz = (preset.ptz if from_preset else ptz).square_aspect_ratio(size,
                                                                   size)
    budget = int(preset.num_iterations if budget is None else budget)
    os.makedirs(out_dir, exist_ok=True)
    out = os.path.join(out_dir, f"view{view}_progress.json")
    ck = os.path.join(out_dir, f"view{view}_orbit")
    done_file = ck + ".done.json"
    key = _orbit_key(ptz, limbs)
    state = {"phase": "init", "t0": time.time(), "view": view,
             "max_it": max_it, "chunk": chunk, "device": str(dev),
             "limbs": limbs, "zoom": str(ptz.zoom_factor)[:24],
             "prec_bits": max(ptz.pt_x.prec, ptz.pt_y.prec), "size": size,
             "budget": budget, "torch": torch.__version__}
    if dev.type == "cuda":
        state.update(card=card_line(),
                     kind=torch.cuda.get_device_name(dev))

    def save():
        state["elapsed_s"] = round(time.time() - state["t0"], 1)
        tmp = out + ".tmp"
        with open(tmp, "w") as f:
            json.dump(state, f)
        os.replace(tmp, out)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    # ------------------------------------------------------------ orbit
    done = None
    if os.path.exists(done_file):
        with open(done_file) as f:
            done = json.load(f)
        if done["key"] != key:
            raise ValueError(f"{done_file} holds another location's orbit")
    state["phase"] = "orbit"
    save()
    if done is not None:
        res = stored_orbit(ck, done, ptz, max_it)
        state.update(orbit_cached=True, resumed_from=done["count"],
                     **done["record"])
    else:
        start = 1
        if os.path.exists(ck + ".state.npz"):
            with np.load(ck + ".state.npz") as z:
                start = int(z["count"])
        last = [0.0]

        def progress(done_it, total, elapsed):
            now = time.perf_counter()
            if now - last[0] >= 10.0:
                last[0] = now
                new = done_it - (start - 1)
                state.update(orbit_done_it=done_it,
                             orbit_it_per_s=round(new / max(elapsed, 1e-9),
                                                  1))
                save()

        state.update(orbit_cached=False, resumed_from=start)
        save()
        kernels.reset_counts()
        t0 = time.perf_counter()
        res = compute_reference_orbit_device(
            ptz.pt_x, ptz.pt_y, max_it, ptz.radius, limbs32=limbs,
            periodicity=True, chunk_steps=chunk, progress_cb=progress,
            checkpoint_path=ck, checkpoint_every_s=ck_every_s,
            device=dev)
        orbit_s = time.perf_counter() - t0
        n = res.count_orbit_entries()
        new = n - start
        record = {
            "orbit_s": round(orbit_s, 3), "orbit_len": n,
            "orbit_new_it": new, "period": res.period,
            "escaped_at": res.escaped_at,
            "it_per_s": round(new / orbit_s, 1) if new else None,
            "us_per_iter": round(orbit_s / new * 1e6, 3) if new else None,
            "session_timers": res.extra.get("session_timers"),
            "orbit_launches": {k: v for k, v in kernels.launches.items()
                               if v},
            "use_hdr_orbit": res.orbit_e is not None}
        state.update(record)
        if res.period or res.escaped_at:
            tmp = done_file + ".tmp"
            with open(tmp, "w") as f:
                json.dump({"key": key, "count": n, "period": res.period,
                           "escaped_at": res.escaped_at,
                           "precision_bits": res.precision_bits,
                           "record": record}, f)
            os.replace(tmp, done_file)
    state["phase"] = "orbit_done"
    save()

    if res.period == 0 and res.escaped_at == 0:
        # the cap came first: this run's rate and the projection, no frame
        new = state["orbit_new_it"]
        state.update(phase="cap_hit", projected_s_per_Mit=round(
            1e6 * state["orbit_s"] / new, 3) if new else None)
        save()
        print(json.dumps(state), flush=True)
        return state

    # --------------------------------------------------------- la_build
    state["phase"] = "la_build"
    save()
    t0 = time.perf_counter()
    la = LAReferenceHost.generate_auto(res.orbit_x, res.orbit_y,
                                       HD.from_hp(res.max_radius),
                                       orbit_e=res.orbit_e)
    state.update(la_build_s=round(time.perf_counter() - t0, 3),
                 la_valid=bool(la.is_valid), la_stages=int(la.stage_count))
    save()
    if tables is not None:
        tables.update(results=res, la=la, ptz=ptz)
    if not la.is_valid:
        state["phase"] = "done_no_la"
        save()
        print(json.dumps(state), flush=True)
        return state

    # ----------------------------------------------------------- render
    state["phase"] = "render"
    save()
    kernels.reset_counts()
    timings: dict = {}
    sync()
    t0 = time.perf_counter()
    grid = two_phase_render(res, la, ptz, size, size, budget, device=dev,
                            timings=timings)
    sync()
    render_s = time.perf_counter() - t0
    if tables is not None:
        tables["grid"] = grid
    o = grid.cpu().numpy().astype(np.int64)
    state.update(phase="done", render_s=round(render_s, 3),
                 render_timings={k: (round(v, 3) if isinstance(v, float)
                                     else v) for k, v in timings.items()},
                 launches={k: v for k, v in kernels.launches.items() if v},
                 iter_min=int(o.min()), iter_max=int(o.max()),
                 iter_sum=int(o.sum()), capped_px=int((o >= budget).sum()))
    np.save(os.path.join(out_dir, f"view{view}_iters_{size}.npy"), o)
    if (from_preset and view == ARTIFACT_VIEW and size == ARTIFACT_SIZE
            and budget == preset.num_iterations):
        art = np.load(ARTIFACT).astype(np.int64)
        state.update(equals_artifact=bool(np.array_equal(o, art)),
                     differing_px=int((o != art).sum()))
    state["total_s"] = round(time.time() - state["t0"], 1)
    save()
    print(json.dumps(state), flush=True)
    return state


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--size", type=int, default=256,
                    help="frame side in pixels (V32_SIZE)")
    ap.add_argument("--budget", type=int, default=None,
                    help="per-pixel budget, the preset's by default "
                         "(V32_BUDGET)")
    ap.add_argument("--max-it", type=int, default=48_000_000,
                    help="total orbit cap in iterations (V32_MAX_IT)")
    ap.add_argument("--dir", default=".v32cache_torch",
                    help="checkpoint and record directory (V32_DIR)")
    ap.add_argument("--ck-every", type=float, default=600,
                    help="checkpoint cadence in seconds (V32_CK_EVERY)")
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args(argv)
    run(size=a.size, budget=a.budget, max_it=a.max_it, out_dir=a.dir,
        ck_every_s=a.ck_every, device=a.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
