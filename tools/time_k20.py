#!/usr/bin/env python3
"""Time K20 (``csrc/sharded_tail.cu``, the sharded orbit step's CRT/carry
tail) and the sharded step around it on NVIDIA cards, for this checkout
and for other checkouts of the port in one run.

    python3 tools/time_k20.py pair  [--tree DIR ...] [--set NAME=VALUE ...]
                                    [--reps N] [--out FILE]
    python3 tools/time_k20.py steps [--tree DIR ...] [--backend gloo|nccl]
                                    [--out FILE]

``pair``: View #30's first step at 16,384 limbs (the one-device residue
rows, K8), rank 0's block of M = 2 ranks (32,768 digits), the words of
both ranks fixed: K20's call pair, launch A then launch B, through the
public ``tail_a``/``tail_b`` and, where the tree has one, through a
``Workspace`` (the step's own calls), ms a pair by CUDA events over
``--reps`` pairs after a warm one (median of 5 such runs); and each
launch's device time, from a CUDA graph of 256 back-to-back launches
replayed between two CUDA events.  A tree before the workspace (K20's
first form: residue rows after the plain reshard, per-tile words) runs
its own form of the same pair.

``steps``: the sharded session's step at 16,384 limbs from View #30's
centre, as ``chip_smoke.py`` phase 17 runs it: 4 ranks as processes, on
card 0 under gloo (M = 4, and M = 2 on a subgroup) or one a card under
NCCL (M = the cards, at most 4, and M = 2 on a subgroup when there are
more than 2); per rank a 64-step chunk's µs a step, the same with the
card synchronised around each collective and the collectives' share of
that, and the host's waits on the card outside the collectives
(``torch.cuda.set_sync_debug_mode``, off inside each collective) in the
reshard and the tail of 4 steps, and in a whole 4-step chunk.

Each configuration runs in a child process, this checkout first, then
each ``--tree`` and each ``--set`` (a copy of this checkout's package
with the named ``constexpr int`` constants of ``csrc/sharded_tail.cu``
set, e.g. ``--set kShardThreads=256``), then again in reverse order (A,
B, ..., B, A).  One JSON
line a result on stdout, also appended to ``--out FILE``; the card's
``nvidia-smi`` name and power limit last.  Needs a CUDA device.
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
import warnings

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LIMBS = 16384
GRAPH_LAUNCHES = 256
TIMED_STEPS = 64
WAIT_STEPS = 4


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


def centre(spec):
    """(scx, cx digits, scy, cy digits) of View #30's centre."""
    from fractalshark_tpu_torch.core.views import get_view_preset
    from fractalshark_tpu_torch.ops.bignum import fixedpoint as FP
    ptz = get_view_preset(30).ptz
    return FP.hp_to_digits(ptz.pt_x, spec) + FP.hp_to_digits(ptz.pt_y, spec)


def events_ms(fn, reps: int) -> float:
    import torch
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def graph_us(fn) -> float:
    """Device µs a launch: GRAPH_LAUNCHES launches of ``fn`` in a CUDA
    graph, replayed between two CUDA events."""
    import torch
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(GRAPH_LAUNCHES):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / GRAPH_LAUNCHES * 1e3


def pair(reps: int) -> dict:
    import torch

    from fractalshark_tpu_torch.ops.bignum import fixedpoint as FP
    from fractalshark_tpu_torch.ops.bignum import ntt as N
    from fractalshark_tpu_torch.ops.bignum import ntt_pallas as NP
    from fractalshark_tpu_torch.parallel import orbit_sharded as OS
    from fractalshark_tpu_torch.parallel.mesh import Mesh

    dev = torch.device("cuda", 0)
    spec = FP.FixedSpec.for_limbs(LIMBS)
    nf, D = spec.nfft, spec.digits
    scx, cxd, scy, cyd = centre(spec)
    v = torch.zeros(4, nf, dtype=torch.int32, device=dev)
    v[0:2, :D] = torch.from_numpy(cxd.astype("int32")).to(dev)
    v[2:4, :D] = torch.from_numpy(cyd.astype("int32")).to(dev)
    f = N.fourstep_forward(v, nf)
    fx, fy = f[0:2], f[2:4]
    e = torch.cat([N.mod_sub_rows(N.mont_mul_rows(fx, fx),
                                  N.mont_mul_rows(fy, fy)),
                   N.mont_mul_rows(fx, fy)])
    inv = N.fourstep_inverse_scaled(e, nf, True).view(2, 2, nf)
    cadd, rnd = FP.addend_planes(v[0, :D], v[2, :D], spec)
    cfg = NP.tail_cfg((scx, scy, 1, 0), nr=False)
    zsign = torch.tensor([scx, scy], dtype=torch.int32, device=dev)
    H, lloc = OS.HALO, nf // 2
    pad = torch.nn.functional.pad
    ip, cp, rp = pad(inv, (H, 0)), pad(cadd, (H, 0)), pad(rnd, (H, 0))
    planes = [(cp[:, r * lloc:r * lloc + H + lloc].contiguous(),
               rp[r * lloc:r * lloc + H + lloc].contiguous())
              for r in range(2)]
    rec = {"mode": "pair", "limbs": LIMBS, "M": 2, "lloc": lloc}
    if hasattr(OS, "Workspace"):
        lays, recvs = OS.receive_buffers(inv, 2)
        words = torch.stack([OS.tail_a(recvs[r], *planes[r], cfg, lays[r],
                                       zsign)[2] for r in range(2)])

        def public():
            a = OS.tail_a(recvs[0], *planes[0], cfg, lays[0], zsign)
            return OS.tail_b(a[0], a[1], words, lays[0])

        ws = OS.Workspace(spec, Mesh(None, 2, 0, dev))
        ws.bind(planes[0], cfg)
        ws.recv.copy_(recvs[0])
        ws.gathered.copy_(words)

        def path():
            ws.launch_a(zsign)
            ws.launch_b()

        rec["workspace_ms"] = [events_ms(path, reps) for _ in range(5)]
        rec["device_us_a"] = graph_us(lambda: ws.launch_a(zsign))
        rec["device_us_b"] = graph_us(ws.launch_b)
    else:
        rows = [ip[..., r * lloc:r * lloc + H + lloc].contiguous()
                for r in range(2)]
        words = torch.stack([OS.tail_a(rows[r], *planes[r], cfg, zsign)[2]
                             for r in range(2)])
        a0 = OS.tail_a(rows[0], *planes[0], cfg, zsign)

        def public():
            a = OS.tail_a(rows[0], *planes[0], cfg, zsign)
            return OS.tail_b(a[0], a[1], words, 0)

        rec["device_us_a"] = graph_us(
            lambda: OS.tail_a(rows[0], *planes[0], cfg, zsign))
        rec["device_us_b"] = graph_us(
            lambda: OS.tail_b(a0[0], a0[1], words, 0))
    rec["public_ms"] = [events_ms(public, reps) for _ in range(5)]
    for k in ("public_ms", "workspace_ms"):
        if k in rec:
            rec[k + "_median"] = statistics.median(rec[k])
    return rec


def quiet_collectives(PM):
    """Turn the sync debug mode off inside each of the mesh's
    collectives; returns a function that puts them back."""
    import torch
    names = ("all_gather", "all_to_all", "all_reduce")
    saved = {n: getattr(PM, n) for n in names}

    def wrap(coll):
        def call(*a, **k):
            prev = torch.cuda.get_sync_debug_mode()
            torch.cuda.set_sync_debug_mode(0)
            try:
                return coll(*a, **k)
            finally:
                torch.cuda.set_sync_debug_mode(prev)
        return call

    for n in names:
        setattr(PM, n, wrap(saved[n]))
    return lambda: [setattr(PM, n, saved[n]) for n in names]


def counted(fn):
    """``fn`` with the sync debug mode on while it runs."""
    import torch

    def call(*a, **k):
        prev = torch.cuda.get_sync_debug_mode()
        torch.cuda.set_sync_debug_mode(1)
        try:
            return fn(*a, **k)
        finally:
            torch.cuda.set_sync_debug_mode(prev)
    return call


def waits(run, OS, whole: bool) -> list:
    """The sync debug mode's warnings while ``run`` runs: in the reshard
    and the tail only (``whole`` False: OS.Workspace.step, or a tree's
    OS.reshard and OS.sharded_tail before it), or in all of it."""
    import torch

    from fractalshark_tpu_torch.parallel import mesh as PM
    put_back = quiet_collectives(PM)
    saved = []
    if not whole:
        if hasattr(OS, "Workspace"):
            saved.append((OS.Workspace, "step", OS.Workspace.step))
        else:
            saved += [(OS, n, getattr(OS, n)) for n in ("reshard",
                                                        "sharded_tail")]
        for obj, name, fn in saved:
            setattr(obj, name, counted(fn))
    try:
        with warnings.catch_warnings(record=True) as seen:
            warnings.simplefilter("always")
            if whole:
                torch.cuda.set_sync_debug_mode(1)
            try:
                run()
            finally:
                torch.cuda.set_sync_debug_mode(0)
    finally:
        for obj, name, fn in saved:
            setattr(obj, name, fn)
        put_back()
    return [str(w.message).splitlines()[0] for w in seen
            if "called a synchronizing" in str(w.message)]


def rank_main(rank: int, world: int, backend: str, workdir: str) -> int:
    import torch
    import torch.distributed as dist
    dev = torch.device("cuda", 0 if backend == "gloo" else rank)
    torch.cuda.set_device(dev)
    dist.init_process_group(backend, init_method="file://" + os.path.join(
        workdir, "store"), world_size=world, rank=rank)
    try:
        from fractalshark_tpu_torch.ops.bignum import fixedpoint as FP
        from fractalshark_tpu_torch.ops.bignum import orbit as O
        from fractalshark_tpu_torch.parallel import mesh as PM
        from fractalshark_tpu_torch.parallel import ntt_sharded as NS
        from fractalshark_tpu_torch.parallel import orbit_sharded as OS
        sub = dist.new_group([0, 1]) if world > 2 else None
        out = {}
        spec = FP.FixedSpec.for_limbs(LIMBS)
        scx, cxd, scy, cyd = centre(spec)
        for M, group in [(world, None)] + ([(2, sub)] if world > 2 else []):
            if rank >= M:
                continue
            mesh = NS.make_limb_mesh(dev, group)
            state = O.OrbitState(scx, cxd, scy, cyd, dev)
            cx, cy = state.x.clone(), state.y.clone()

            def chunk(steps):
                torch.cuda.synchronize(dev)
                t0 = time.perf_counter()
                O.orbit_chunk(state, scx, cx, scy, cy, spec, steps,
                              mesh=mesh)
                torch.cuda.synchronize(dev)
                return (time.perf_counter() - t0) / steps * 1e6

            chunk(4)
            out[f"{M}_step_us"] = [chunk(TIMED_STEPS) for _ in range(2)]
            clock = {"s": 0.0}
            names = ("all_gather", "all_to_all", "all_reduce")
            saved = {n: getattr(PM, n) for n in names}

            def synced(coll):
                def call(*a, **k):
                    torch.cuda.synchronize(dev)
                    t0 = time.perf_counter()
                    res = coll(*a, **k)
                    torch.cuda.synchronize(dev)
                    clock["s"] += time.perf_counter() - t0
                    return res
                return call

            for n in names:
                setattr(PM, n, synced(saved[n]))
            try:
                out[f"{M}_step_synced_us"] = chunk(TIMED_STEPS)
            finally:
                for n in names:
                    setattr(PM, n, saved[n])
            out[f"{M}_coll_us"] = clock["s"] / TIMED_STEPS * 1e6
            out[f"{M}_waits_tail"] = waits(
                lambda: O.orbit_chunk(state, scx, cx, scy, cy, spec,
                                      WAIT_STEPS, mesh=mesh), OS, False)
            out[f"{M}_waits_chunk"] = waits(
                lambda: O.orbit_chunk(state, scx, cx, scy, cy, spec,
                                      WAIT_STEPS, mesh=mesh), OS, True)
        with open(os.path.join(workdir, f"out_{rank}.json"), "w") as fh:
            json.dump(out, fh)
    finally:
        dist.destroy_process_group()
    return 0


def steps(backend: str) -> dict:
    import torch
    world = 4 if backend == "gloo" else min(4, torch.cuda.device_count())
    with tempfile.TemporaryDirectory() as workdir:
        procs = [subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "steps", "--rank",
             str(r), str(world), backend, workdir],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for r in range(world)]
        logs = [p.communicate(timeout=600)[0] for p in procs]
        for r, p in enumerate(procs):
            if p.returncode:
                raise SystemExit(f"rank {r}: rc {p.returncode}\n"
                                 f"{logs[r][-3000:]}")
        ranks = []
        for r in range(world):
            with open(os.path.join(workdir, f"out_{r}.json")) as fh:
                ranks.append(json.load(fh))
    rec = {"mode": "steps", "backend": backend, "world": world,
           "limbs": LIMBS}
    for k in ranks[0]:
        rec[k] = ranks[0][k]
    rec["waits_tail_by_rank"] = [
        {k: len(v) for k, v in o.items() if "waits" in k} for o in ranks]
    return rec


def patched_tree(sets: str) -> str:
    """A temporary copy of this checkout's package with constants of
    csrc/sharded_tail.cu set (``NAME=VALUE,...``); returns its root."""
    root = tempfile.mkdtemp(prefix="k20_")
    shutil.copytree(os.path.join(ROOT, "fractalshark_tpu_torch"),
                    os.path.join(root, "fractalshark_tpu_torch"),
                    ignore=shutil.ignore_patterns("build", "__pycache__"))
    src = os.path.join(root, "fractalshark_tpu_torch", "csrc",
                       "sharded_tail.cu")
    text = open(src).read()
    for item in sets.split(","):
        name, value = item.split("=")
        text, n = re.subn(rf"(constexpr int {name} = )[^;]+;",
                          rf"\g<1>{value};", text)
        if n != 1:
            raise SystemExit(f"no constexpr int {name} in sharded_tail.cu")
    with open(src, "w") as fh:
        fh.write(text)
    return root


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("mode", choices=("pair", "steps"))
    ap.add_argument("--tree", action="append", default=[])
    ap.add_argument("--set", action="append", default=[])
    ap.add_argument("--reps", type=int, default=200)
    ap.add_argument("--backend", default="gloo", choices=("gloo", "nccl"))
    ap.add_argument("--out", default=None)
    ap.add_argument("--child", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--label", default="this tree", help=argparse.SUPPRESS)
    ap.add_argument("--rank", nargs=4, default=None, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.rank is not None:
        sys.path.insert(0, os.getcwd())
        r, w, backend, workdir = args.rank
        return rank_main(int(r), int(w), backend, workdir)
    if args.child is not None:
        sys.path.insert(0, os.path.abspath(args.child))
        rec = pair(args.reps) if args.mode == "pair" else steps(args.backend)
        emit(dict(rec, tree=args.label), args.out)
        return 0
    c = card()
    configs = [(ROOT, "this tree")]
    configs += [(os.path.abspath(t), t) for t in args.tree]
    patched = [(patched_tree(s), s) for s in args.set]
    configs += patched
    failed = 0
    for tree, label in configs + configs[::-1]:
        cmd = [sys.executable, os.path.abspath(__file__), args.mode,
               "--child", tree, "--label", label, "--reps", str(args.reps),
               "--backend", args.backend]
        if args.out:
            cmd += ["--out", os.path.abspath(args.out)]
        proc = subprocess.run(cmd, cwd=tree, text=True, capture_output=True)
        sys.stdout.write(proc.stdout)
        if proc.returncode:
            failed += 1
            sys.stderr.write(f"{label}: rc {proc.returncode}\n"
                             f"{proc.stderr[-3000:]}\n")
    for tree, _ in patched:
        shutil.rmtree(tree, ignore_errors=True)
    print(c)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
