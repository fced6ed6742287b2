#!/usr/bin/env python3
"""Time the port's device reference orbit at the 32,768-limb class (View
#32's operand, D = 2^16 digits, nfft 2^17) on one NVIDIA card.

    python3 tools/time_orbit32.py chunk [--limbs N ...] [--reps N]
                                  [--tree DIR ...]
                                  [--set NAME=VALUE[,NAME=VALUE] ...]
    python3 tools/time_orbit32.py session [--steps N] [--limbs N]
    (both: [--out FILE])

``chunk``: from View #32's centre (``data/views.json`` key "32"), after one
warm chunk, a chunk of 256 steps by K12 (``orbit.chunk_form``'s form,
the grid form at these sizes) and by the per-step loop of K4 then K5
(``orbit.launch_orbit_chunk(..., "steps")``) on the same state, in turns
(loop, K12, K12, loop), each ``--reps`` times under CUDA events; prints
the median ms of a chunk and µs a step of each, and whether the two
chunks' digits, shadow rows and signs are equal bit for bit.  Each
configuration runs in a child process: this checkout's package, each
``--tree DIR`` (another checkout, e.g. a ``git archive`` of the parent)
and each ``--set`` (a copy of this checkout's package with the named
``constexpr`` constants of ``csrc/orbit_chunk.cu`` set, e.g.
``--set kGridLogCols=2``), in the order A, B, ..., B, A.

``session``: a periodicity-detecting ``CudaOrbitSession`` of ``--steps``
iterations (default 100,000) at ``--limbs`` from View #32's centre, as
``compute_reference_orbit_device`` runs it: its wall time, µs an
iteration, the session's timers, the device's busy share (the union of
the CUDA kernel intervals ``torch.profiler`` records, over the wall
time; "not measured" if it records none), the launches by kernel, and
View #32's projected orbit time (its period, 22,680,805 iterations,
``data/records.json`` ``view32_e2e``, times the µs an iteration).

Each result is one JSON line on stdout, also appended to ``--out FILE``
when given.  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VIEW32_PERIOD = 22_680_805
CHUNK_STEPS = 256


def emit(rec: dict, out: str | None) -> None:
    line = json.dumps(rec)
    print(line, flush=True)
    if out:
        os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
        with open(out, "a") as fh:
            fh.write(line + "\n")


def card() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    return out.splitlines()[0] if out else "nvidia-smi: no output"


def view32(limbs: int):
    """(spec, scx, cx digits, scy, cy digits, centre, radius) at
    ``limbs``."""
    from fractalshark_tpu_torch.core.views import get_view_preset
    from fractalshark_tpu_torch.ops.bignum import fixedpoint as FP
    ptz = get_view_preset(32).ptz
    spec = FP.FixedSpec.for_limbs(limbs)
    scx, cxd = FP.hp_to_digits(ptz.pt_x, spec)
    scy, cyd = FP.hp_to_digits(ptz.pt_y, spec)
    return spec, scx, cxd, scy, cyd, (ptz.pt_x, ptz.pt_y), ptz.radius


def time_chunk(limbs: int, reps: int) -> dict:
    """K12 and the per-step loop on the same state, in turns."""
    import torch

    from fractalshark_tpu_torch import kernels
    from fractalshark_tpu_torch.ops.bignum import fixedpoint as FP
    from fractalshark_tpu_torch.ops.bignum import orbit as O

    dev = torch.device("cuda", 0)
    kernels.build()
    spec, scx, cxd, scy, cyd, _, _ = view32(limbs)
    cx = torch.from_numpy(cxd.astype("int32")).to(dev)
    cy = torch.from_numpy(cyd.astype("int32")).to(dev)
    scratch = O._Scratch(spec, dev)
    form = O.chunk_form(spec)

    def run(state, f):
        rows = torch.empty(CHUNK_STEPS + 1, FP.ROW, dtype=torch.int32,
                           device=dev)
        rows[0] = state.row
        O.launch_orbit_chunk(state, rows, scx, cx, scy, cy, spec,
                             CHUNK_STEPS, scratch, f)
        state.row = rows[CHUNK_STEPS]
        return rows

    warm = O.OrbitState(scx, cxd, scy, cyd, dev)
    run(warm, form)
    outs = {}
    for f in ("steps", form):
        st = O.OrbitState(1, cxd, 1, cyd, dev)
        st.x, st.y, st.row = warm.x.clone(), warm.y.clone(), warm.row.clone()
        rows = run(st, f)
        outs[f] = (st.x.cpu(), st.y.cpu(), rows.cpu())
    equal = all(torch.equal(a, b) for a, b in zip(outs["steps"],
                                                   outs[form]))
    ms = {"steps": [], form: []}
    for f in ("steps", form, form, "steps"):
        st = O.OrbitState(1, cxd, 1, cyd, dev)
        st.x, st.y, st.row = warm.x.clone(), warm.y.clone(), warm.row.clone()
        for _ in range(reps):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize(dev)
            a.record()
            run(st, f)
            b.record()
            torch.cuda.synchronize(dev)
            ms[f].append(a.elapsed_time(b))
    rec = {"limbs": limbs, "digits": spec.digits, "nfft": spec.nfft,
           "form": form, "equal_to_loop": equal}
    for f, key in ((form, "k12"), ("steps", "loop")):
        med = statistics.median(ms[f])
        rec[f"{key}_chunk_ms"] = med
        rec[f"{key}_chunk_ms_min_max"] = [min(ms[f]), max(ms[f])]
        rec[f"{key}_us_per_step"] = med / CHUNK_STEPS * 1e3
    return rec


def session(limbs: int, steps: int) -> dict:
    """A periodicity-detecting session of ``steps`` iterations."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from fractalshark_tpu_torch import kernels
    from fractalshark_tpu_torch.ops.bignum import orbit as O

    dev = torch.device("cuda", 0)
    kernels.build()
    spec, _, _, _, _, (x0, y0), rad = view32(limbs)
    # a short session first: the library, tables and scratch are made
    O.compute_reference_orbit_device(x0, y0, 512, rad, limbs32=limbs,
                                     device=dev)
    kernels.reset_counts()
    torch.cuda.synchronize(dev)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        res = O.compute_reference_orbit_device(x0, y0, steps, rad,
                                               limbs32=limbs, device=dev)
        torch.cuda.synchronize(dev)
        wall = time.perf_counter() - t0
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    busy, end = 0.0, -1.0
    for a, b in spans:
        if b > end:
            busy += b - max(a, end)
            end = b
    n_it = res.count_orbit_entries() - 1
    us = wall / n_it * 1e6
    return {"limbs": limbs, "steps": steps, "iterations": n_it,
            "period": res.period, "escaped_at": res.escaped_at,
            "form": O.chunk_form(spec), "wall_s": wall, "us_per_iter": us,
            "timers": res.extra["session_timers"],
            "device_busy_ms": busy / 1e3 if spans else None,
            "busy_share": busy / 1e6 / wall if spans else "not measured",
            "device_events": len(spans),
            "launches": {k: v for k, v in kernels.launches.items() if v},
            "view32_projected_s": VIEW32_PERIOD * us / 1e6}


def patched_tree(sets: str) -> str:
    """A temporary copy of this checkout's package with constants of
    csrc/orbit_chunk.cu set (``NAME=VALUE,...``); returns its root."""
    root = tempfile.mkdtemp(prefix="orbit32_")
    shutil.copytree(os.path.join(ROOT, "fractalshark_tpu_torch"),
                    os.path.join(root, "fractalshark_tpu_torch"),
                    ignore=shutil.ignore_patterns("build", "__pycache__"))
    src = os.path.join(root, "fractalshark_tpu_torch", "csrc",
                       "orbit_chunk.cu")
    text = open(src).read()
    for item in sets.split(","):
        name, value = item.split("=")
        text, n = re.subn(rf"(constexpr int {name} = )[^;]+;",
                          rf"\g<1>{value};", text)
        if n != 1:
            raise SystemExit(f"no constexpr int {name} in orbit_chunk.cu")
    with open(src, "w") as fh:
        fh.write(text)
    return root


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("mode", choices=("chunk", "session"))
    ap.add_argument("--limbs", type=int, nargs="+", default=[32768])
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--steps", type=int, default=100_000)
    ap.add_argument("--tree", action="append", default=[])
    ap.add_argument("--set", action="append", default=[])
    ap.add_argument("--out", default=None)
    ap.add_argument("--child", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--label", default="this tree", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child is not None:
        sys.path.insert(0, os.path.abspath(args.child))
        for limbs in args.limbs:
            rec = time_chunk(limbs, args.reps)
            emit(dict(rec, tree=args.label), args.out)
        return 0
    c = card()
    if args.mode == "session":
        sys.path.insert(0, ROOT)
        for limbs in args.limbs:
            emit(dict(session(limbs, args.steps), card=c), args.out)
        return 0
    configs = [(ROOT, "this tree")]
    configs += [(os.path.abspath(t), t) for t in args.tree]
    patched = [(patched_tree(s), s) for s in args.set]
    configs += patched
    failed = 0
    try:
        for tree, label in configs + configs[::-1]:
            cmd = [sys.executable, os.path.abspath(__file__), "chunk",
                   "--child", tree, "--label", label, "--reps",
                   str(args.reps), "--limbs", *map(str, args.limbs)]
            if args.out:
                cmd += ["--out", os.path.abspath(args.out)]
            proc = subprocess.run(cmd, cwd=tree, text=True,
                                  capture_output=True)
            sys.stdout.write(proc.stdout)
            if proc.returncode:
                failed += 1
                sys.stderr.write(f"{label}: rc {proc.returncode}\n"
                                 f"{proc.stderr[-3000:]}\n")
    finally:
        for tree, _ in patched:
            shutil.rmtree(tree, ignore_errors=True)
    print(c)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
