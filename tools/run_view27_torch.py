#!/usr/bin/env python3
"""The endurance pipeline on one NVIDIA card through the PyTorch/CUDA port
(``fractalshark_tpu_torch``): the counterpart of the JAX package's three
View #27 tools (``tools/run_view27.py``, ``view27_la.py`` and
``view27_render.py``) in one script.

View #27 is the reference's hardest known render class: period
28,311,731,137, a 5e13 budget, an orbit that exists only compressed
(Notes/FractalShark-06-RefOrbit.tex:740-747).  The script runs its phases
in order and writes its record to ``<dir>/view<view>_progress.json``
after each one:

* ``orbit``: the native orbit session (``NativeOrbitSession``), compressed
  on the fly at the preset's ``compression_error_exp_low`` (else 20) and
  checkpointed under ``<dir>/view<view>_orbit``; a rerun resumes it bit
  for bit, or, once it has found its period or escaped, takes it as it
  stands (the store is keyed on its centre, radius, precision and
  ``error_exp``: another location's raises).  ``cap_hit``: ``--max-it``
  came first; the record gives this run's rate, and no frame;
* ``la_build``: the LA table built through the anchor store into a
  directory of memmaps (``generate_native_rc_streamed(memmap_dir=)``,
  ``LAParameters(period_divisor=8, low_bound=1)``), then
  ``save_meta_npz``; a finished directory is read back (``load_dir``) and
  not rebuilt (keyed on the orbit's anchors);
* ``render``: the table windowed to ``--node-cap`` nodes
  (``stage_window``), ``VirtualResults.from_compressed`` (the uncompressed
  orbit never exists), then phase 1 (K2 ``la_only``) and the tail with the
  LA tables dropped from the device between them: ``--mode f64`` is
  ``two_phase_render`` (route ``auto``: the gather tail, K19, from 64M
  orbit positions on), ``--mode df32`` the same phase 1, then the gather
  tail's df32 mode (K3) on that handoff.  The int64 grid is saved as
  ``<dir>/view<view>_iters_<size>[_df32].npy``.  At View #23, 32² and the
  preset's budget the grid is held to the JAX package's
  (``artifacts/view23_rc_iters.npy``, ``..._df32.npy``;
  ``tools/view23_rc_pins.py``) and the orbit and table to its counts
  (``artifacts/view23_rc_pins.json``).

It also reads the stores of the JAX tools (the formats are the same):
``--orbit-store`` (``V27_CK``: the ``.state``/``.ax``/``.ay``/``.ai``
files of ``run_view27.py``) and ``--la-dir`` (``V27_LA_DIR``:
``la_meta.npz`` and ``la_<key>.npy`` of ``view27_la.py``), so that a
``.v27cache/`` renders on the card without its hours of host work.  The
two variables are read only for View #27's own box (no ``ptz``
override).

    python3 tools/run_view27_torch.py [--view 27] [--size 64] [--budget N]
        [--mode f64|df32] [--node-cap 70e6] [--dir .v27cache_torch]
        [--orbit-store PREFIX] [--la-dir DIR] [--max-it 40000000000]
        [--device cuda]

The last line of standard output is the record as one JSON object.  The
device is CUDA unless ``--device cpu`` is asked for (the plain twins; only
small frames finish there); CUDA without a card raises.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
import zlib

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
for _p in (ROOT, os.path.join(ROOT, "tools")):
    if _p not in sys.path:
        sys.path.insert(0, _p)

ART = os.path.join(ROOT, "artifacts")
# the JAX package's View #23 frame (tools/view23_rc_pins.py): the grids
# are compared only at this view and size and the preset's budget
PIN_VIEW, PIN_SIZE = 23, 32
PIN_GRIDS = {"f64": "view23_rc_iters.npy", "df32": "view23_rc_iters_df32.npy"}
PIN_RECORD = "view23_rc_pins.json"
# view27_la.py's reservation: View #27's node count (426,635,659) and
# slack; at another view it would reserve that many nodes for nothing
V27_LA_RESERVE = "440000000"
# K19's time a tail step with the f64 recurrence every step (the serial
# floor of chip_smoke.py's phase 3 on View #6 RC 256²; PERF.md's K19 row)
K19_STEP_NS = 235.1
MODES = ("f64", "df32")
# the orbit session's iterations a call and seconds between checkpoints
# (tools/run_view27.py's)
ORBIT_CHUNK, CHECKPOINT_EVERY_S = 1 << 22, 300


def anchors_crc(comp) -> int:
    """CRC-32 of the three anchor arrays (x, y as <f8, index as <i8)."""
    c = zlib.crc32(np.asarray(comp.anchors_x, "<f8").tobytes())
    c = zlib.crc32(np.asarray(comp.anchors_y, "<f8").tobytes(), c)
    return zlib.crc32(np.asarray(comp.anchor_index, "<i8").tobytes(), c)


def grid_pin(grid) -> tuple:
    """A frame's pin: (iter_sum, CRC-32 of the int64 grid as <u8)."""
    g = np.asarray(grid, np.int64)
    return int(g.sum()), zlib.crc32(g.astype("<u8").tobytes())


def tail_steps(grid, start, budget: int) -> dict:
    """The tail's work: the iterations each pixel did after the handoff
    (`start`, its count there; 0 for a pixel that phase 1 took to the
    budget), summed and at the deepest pixel, and the pixels that escaped
    in the tail."""
    grid, start = np.asarray(grid, np.int64), np.asarray(start, np.int64)
    live = start < budget
    steps = np.where(live, grid - start, 0)
    return {"tail_steps_sum": int(steps.sum()),
            "tail_steps_max": int(steps.max()),
            "tail_escaped": int((live & (grid < budget)).sum())}


def phase1_steps(run_stats: dict, pixels: int, stages: int) -> dict:
    """Phase 1's work from its run loop's record (``la_kernel``'s
    ``last_run_stats``): each launch after the first ran only pixels that
    were live after the one before, which therefore ran all its
    ``chunk_steps`` body steps there.  So the steps summed over pixels
    are at least that count, and at least one a stage a pixel; the
    deepest pixel's chain is at least (launches - 1) x ``chunk_steps``."""
    sizes, chunk = run_stats["work"], run_stats["chunk_steps"]
    return {"phase1_steps": max(chunk * sum(sizes[1:]), pixels * stages),
            "phase1_chain_steps": chunk * (len(sizes) - 1)}


def _write_json(path: str, obj) -> None:
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(obj, f)
    os.replace(tmp, path)


def window_stage(la, node_cap: int) -> int:
    """The lowest stage to keep so that the table holds at most
    `node_cap` nodes (``view27_render.py``; the top stage always stays)."""
    n = len(la.las)
    idx = list(la.stage_la_index) + [n]
    s = 0
    while n - idx[s] > node_cap and s < la.stage_count - 1:
        s += 1
    return s


def bounds(work: dict, mode: str, anchors: int, nodes: int, pixels: int,
           ratio: float) -> dict:
    """The least time each phase could take on the card for this run's
    work, by ``chip_smoke.py``'s rates and counts: the larger of the bytes
    it must move over the memory rate and its operations over the f32
    rate.  Phase 1 (K2 ``la_only``): the node tables (80 bytes a node),
    dc and the state written (49 bytes a pixel); its counted body steps
    (``phase1_steps``), each a complex HDR product and add (40, as
    ``lav2_ops``).  The tail: the anchor table, dc, the
    handoff count read and the grid written; K6's HDR step (60) a tail
    iteration and an escape, and in f64 mode (K19) the f64 recurrence on
    the steps that land on no anchor, 1 - 1/ratio of them
    (``k19_ops``; a lower bound for K3's df32 reconstruction)."""
    import chip_smoke as smoke

    def bound(n_bytes, ops):
        t_bytes = n_bytes / smoke.HBM_BYTES_PER_S * 1e3
        t_ops = ops / smoke.F32_OPS_PER_S * 1e3
        return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops \
            else "operations"

    steps = work["tail_steps_sum"]
    ops = 60.0 * (steps + work["tail_escaped"])
    if mode == "f64":
        ops += smoke.K19_RECUR_F32_OPS * steps * (1.0 - 1.0 / ratio)
    row = 32 if mode == "f64" else 24
    out = {}
    out["phase1_bound_ms"], out["phase1_bound_by"] = bound(
        80 * nodes + 49 * pixels, 40.0 * work["phase1_steps"])
    out["tail_bound_ms"], out["tail_bound_by"] = bound(
        row * anchors + 28 * pixels, ops)
    return out


def run(view: int = 27, size: int = 64, budget: int | None = None,
        mode: str = "f64", node_cap: int = 70_000_000,
        out_dir: str = ".v27cache_torch", orbit_store: str | None = None,
        la_dir: str | None = None, max_it: int = 40_000_000_000,
        device="cuda", ptz=None) -> dict:
    """Run the phases (orbit, then la_build and render, or cap_hit) for
    `view` (its preset's box, or `ptz`) at `size`² and `budget` (the
    preset's when None) in `mode`; return the record, also written to
    ``<out_dir>/view<view>_progress.json``, and print it as one JSON line.
    The f64 mode's route is ``two_phase_render``'s ``auto``
    (``FRACTALSHARK_RC_TAIL`` overrides it)."""
    import torch

    from fractalshark_tpu_torch import kernels
    from fractalshark_tpu_torch.core.hdr_host import HD
    from fractalshark_tpu_torch.core.precision import precision_from_view
    from fractalshark_tpu_torch.core.views import get_view_preset
    from fractalshark_tpu_torch.engine import native_la as NL
    from fractalshark_tpu_torch.engine import renderers as R
    from fractalshark_tpu_torch.engine.la_reference import LAParameters
    from fractalshark_tpu_torch.engine.native_orbit import NativeOrbitSession
    from fractalshark_tpu_torch.engine.perturbation_results import (
        VirtualResults)
    from fractalshark_tpu_torch.ops import la_kernel
    from fractalshark_tpu_torch.ops.rc_tail import rc_tail_gather
    from run_view32_torch import _orbit_key, card_line

    if mode not in MODES:
        raise ValueError(f"mode {mode!r}: one of {MODES}")
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device 'cuda' requested but CUDA is not "
                           "available")
    preset = get_view_preset(view)
    from_preset = ptz is None
    ptz = (preset.ptz if from_preset else ptz).square_aspect_ratio(size,
                                                                   size)
    budget = int(preset.num_iterations if budget is None else budget)
    prec = precision_from_view(ptz) + 32
    cx, cy = ptz.pt_x.with_precision(prec), ptz.pt_y.with_precision(prec)
    error_exp = int(preset.compression_error_exp_low or 20)
    os.makedirs(out_dir, exist_ok=True)
    if from_preset and view == 27:
        orbit_store = orbit_store or os.environ.get("V27_CK")
        la_dir = la_dir or os.environ.get("V27_LA_DIR")
    ck = orbit_store or os.path.join(out_dir, f"view{view}_orbit")
    la_dir = la_dir or os.path.join(out_dir, f"view{view}_la")
    out = os.path.join(out_dir, f"view{view}_progress.json")
    state = {"phase": "init", "t0": time.time(), "view": view, "size": size,
             "budget": budget, "mode": mode, "device": str(dev),
             "zoom": str(ptz.zoom_factor)[:24], "prec_bits": prec,
             "error_exp": error_exp, "orbit_store": ck, "la_dir": la_dir,
             "torch": torch.__version__}
    if dev.type == "cuda":
        state.update(card=card_line(), kind=torch.cuda.get_device_name(dev))

    def save():
        state["elapsed_s"] = round(time.time() - state["t0"], 1)
        _write_json(out, state)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    # ------------------------------------------------------------ orbit
    state["phase"] = "orbit"
    save()
    # what the store was computed for; a store the JAX tools wrote has no
    # key, and is taken as the caller names it
    orbit_key = _orbit_key(ptz, f"{prec}/{error_exp}")
    key_file = ck + ".key.json"
    if os.path.exists(key_file):
        with open(key_file) as f:
            if json.load(f) != orbit_key:
                raise ValueError(f"{ck} holds another location's orbit")
    sess = NativeOrbitSession(cx, cy, ptz.radius, precision_bits=prec,
                              compression_error_exp=error_exp,
                              checkpoint_path=ck)
    if not sess._resumed:
        _write_json(key_file, orbit_key)
    state["orbit_key_checked"] = os.path.exists(key_file)
    start = sess.iters
    last = [0.0]

    def progress(it, _max_it, elapsed):
        now = time.perf_counter()
        if now - last[0] >= 10.0:
            last[0] = now
            state.update(orbit_iters=it, n_anchors=sess.n_emitted,
                         orbit_it_per_s=round((it - start)
                                              / max(elapsed, 1e-9), 1))
            save()

    t0 = time.perf_counter()
    status = sess.run(max_it, chunk=ORBIT_CHUNK,
                      checkpoint_every_s=CHECKPOINT_EVERY_S,
                      progress_cb=progress)
    orbit_s = time.perf_counter() - t0
    comp = sess.compressed()
    new = sess.iters - start
    state.update(
        orbit_resumed=sess._resumed, orbit_start_iters=start,
        orbit_iters=sess.iters, orbit_new_it=new,
        orbit_s=round(orbit_s, 3),
        orbit_it_per_s=round(new / orbit_s, 1) if new else None,
        orbit_status=status,
        period=comp.total_count if status == 1 else 0,
        escaped_at=comp.total_count if status == 2 else 0,
        total_count=int(comp.total_count), n_anchors=len(comp.anchors_x),
        anchors_crc32=anchors_crc(comp),
        ratio=round(comp.compression_ratio(), 1), had_dip=sess.had_dip)
    sess.close()
    if status == 0:
        state["phase"] = "cap_hit"
        save()
        print(json.dumps(state), flush=True)
        return state

    # --------------------------------------------------------- la_build
    state["phase"] = "la_build"
    save()
    key = {"total_count": int(comp.total_count),
           "n_anchors": len(comp.anchors_x),
           "anchors_crc32": state["anchors_crc32"]}
    key_file = os.path.join(la_dir, "la_key.json")
    meta = os.path.join(la_dir, "la_meta.npz")
    if os.path.exists(meta):
        if os.path.exists(key_file):
            with open(key_file) as f:
                if json.load(f) != key:
                    raise ValueError(f"{la_dir} holds another orbit's "
                                     "table")
        state.update(la_cached=True, la_key_checked=os.path.exists(key_file))
    else:
        os.makedirs(la_dir, exist_ok=True)
        if from_preset and view == 27:
            os.environ.setdefault("FS_LA_RESERVE", V27_LA_RESERVE)
        t0 = time.perf_counter()
        built, info = NL.generate_native_rc_streamed(
            comp, HD.from_hp(ptz.radius),
            params=LAParameters(period_divisor=8, low_bound=1),
            memmap_dir=la_dir)
        state.update(la_cached=False,
                     la_build_s=round(time.perf_counter() - t0, 3),
                     la_info=info)
        if built is None:
            state["phase"] = "la_failed"
            save()
            print(json.dumps(state), flush=True)
            return state
        built.save_meta_npz(la_dir)
        _write_json(key_file, key)
        del built
    la = NL.LAReferenceArrays.load_dir(la_dir)
    state.update(la_valid=bool(la.is_valid), la_nodes=len(la.las),
                 la_stages=int(la.stage_count),
                 stage_la_index=[int(x) for x in la.stage_la_index],
                 stage_macro_it_count=[int(x)
                                       for x in la.stage_macro_it_count],
                 use_at=bool(la.use_at),
                 at_step=int(la.at.step_length) if la.use_at else 0)
    save()

    # ----------------------------------------------------------- render
    min_stage = window_stage(la, node_cap)
    la_dev = la.stage_window(min_stage)
    state.update(phase="render", node_cap=node_cap, min_stage=min_stage,
                 la_nodes_windowed=len(la_dev.las))
    save()
    virt = VirtualResults.from_compressed(comp, cx, cy)
    kernels.reset_counts()
    timings: dict = {}
    sync()
    t0 = time.perf_counter()
    if mode == "f64":
        init: dict = {}
        grid = R.two_phase_render(
            virt, la_dev, ptz, size, size, budget, comp=comp, device=dev,
            timings=timings, release_la_tables=True, handoff=init)
    else:
        init = R.la_handoff(virt, la_dev, ptz, size, size, budget,
                            device=dev)
        R.drop_la_tables(virt, la_dev, dev)
        t1 = time.perf_counter()
        grid = rc_tail_gather(comp, cx, cy, ptz, size, size, budget, init,
                              mode="df32", device=dev)
        sync()
        timings.update(phase1_s=t1 - t0, phase2_s=time.perf_counter() - t1,
                       tail="gather")
    sync()
    render_s = time.perf_counter() - t0
    o = grid.cpu().numpy().astype(np.int64)
    timings.update(tail_steps(o, init["it"].cpu().numpy(), budget),
                   **phase1_steps(la_kernel.last_run_stats, size * size,
                                  int(la_dev.stage_count)))
    iter_sum, crc = grid_pin(o)
    state.update(
        phase="done", render_s=round(render_s, 3),
        tail=timings["tail"], tail_mode=mode,
        phase1_s=round(timings["phase1_s"], 3),
        phase2_s=round(timings["phase2_s"], 3),
        launches={k: v for k, v in kernels.launches.items() if v},
        iter_min=int(o.min()), iter_max=int(o.max()), iter_sum=iter_sum,
        capped_px=int((o >= budget).sum()), crc32=crc,
        phase1_steps=timings["phase1_steps"],
        phase1_chain_steps=timings["phase1_chain_steps"],
        tail_steps_sum=timings["tail_steps_sum"],
        tail_steps_max=timings["tail_steps_max"],
        tail_escaped=timings["tail_escaped"],
        k19_serial_floor_ms=round(
            timings["tail_steps_max"] * K19_STEP_NS * 1e-6, 3),
        **bounds(timings, mode, len(comp.anchors_x), len(la_dev.las),
                 size * size, comp.compression_ratio()))
    suffix = "" if mode == "f64" else "_df32"
    np.save(os.path.join(out_dir, f"view{view}_iters_{size}{suffix}.npy"), o)
    if (from_preset and view == PIN_VIEW and size == PIN_SIZE
            and budget == preset.num_iterations):
        art = np.load(os.path.join(ART, PIN_GRIDS[mode])).astype(np.int64)
        with open(os.path.join(ART, PIN_RECORD)) as f:
            pins = json.load(f)
        state.update(
            equals_artifact=bool(np.array_equal(o, art)),
            differing_pixels=int((o != art).sum()),
            equals_pins={k: state[k] == pins[p] for k, p in (
                ("period", "period"), ("n_anchors", "n_anchors"),
                ("anchors_crc32", "anchors_crc32"), ("la_nodes", "la_nodes"),
                ("la_stages", "la_stages"),
                ("stage_macro_it_count", "stage_macro_it_count"))})
    state["total_s"] = round(time.time() - state["t0"], 1)
    save()
    print(json.dumps(state), flush=True)
    return state


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--view", type=int, default=27)
    ap.add_argument("--size", type=int, default=64,
                    help="frame side in pixels (V27_SIZE)")
    ap.add_argument("--budget", type=int, default=None,
                    help="per-pixel budget, the preset's by default "
                         "(V27_BUDGET)")
    ap.add_argument("--mode", choices=MODES, default="f64",
                    help="the gather tail's mode: f64 (K19) or df32 (K3)")
    ap.add_argument("--node-cap", type=float, default=70e6,
                    help="the device table's most nodes (V27_NODE_CAP)")
    ap.add_argument("--dir", default=".v27cache_torch",
                    help="checkpoint, table and record directory")
    ap.add_argument("--orbit-store", default=None,
                    help="the orbit store's prefix (V27_CK; default "
                         "<dir>/view<view>_orbit)")
    ap.add_argument("--la-dir", default=None,
                    help="the LA table's directory (V27_LA_DIR; default "
                         "<dir>/view<view>_la)")
    ap.add_argument("--max-it", type=int, default=40_000_000_000,
                    help="total orbit cap in iterations")
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args(argv)
    run(view=a.view, size=a.size, budget=a.budget, mode=a.mode,
        node_cap=int(a.node_cap), out_dir=a.dir, orbit_store=a.orbit_store,
        la_dir=a.la_dir, max_it=a.max_it, device=a.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
