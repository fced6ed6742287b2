"""The port's graft entry points: the counterpart of ``__graft_entry__.py``.

* ``entry(device)`` — the single-card forward step: View 0 at 256² with
  512 iterations in f32, ``escape_jax``'s loop (K1 on the card, its plain
  twin on the CPU).  Returns ``(forward, (scalars,))`` as ``entry()`` does
  (``__graft_entry__.py:14-53``).
* ``dryrun_multichip(n, device)`` — the flagship render step and the
  limb-sharded bignum step over an n-rank mesh
  (``__graft_entry__.py:56-180``): ``n`` processes in one gloo group, each
  checking its results against one device's and failing on any
  difference.  On ``"cuda"`` every rank uses card 0 (gloo stages each
  collective through host memory); on ``"cpu"`` the ranks run the plain
  twins.

    python -m fractalshark_tpu_torch.graft_entry [--device cpu]
    python -m fractalshark_tpu_torch.graft_entry --dryrun 8 [--device cpu]
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from fractalshark_tpu_torch import kernels

# the dry run's frame (__graft_entry__.py:94-101): 8 rows a rank, 64 wide,
# the 1e8 frame at budget 500; the sharded product at nfft 4,096; three
# sharded orbit steps at 256 limbs
CX = "-0.743643887037158704752191506114774"
CY = "0.131825904205311970493132056385139"
ROWS_PER_RANK, WIDTH, BUDGET = 8, 64, 500
NFFT = 4096
ORBIT_LIMBS, ORBIT_STEPS = 256, 3
ORBIT_CX, ORBIT_CY = "-0.7436438870371587", "0.1318259042053119"


def entry(device="cuda"):
    """(forward, (scalars,)): ``forward(scalars)`` renders View 0 at 256²
    with scalars f32[5] = [min_x, max_y, dx, dy, max_iter]; the int32 grid
    on ``device``."""
    from fractalshark_tpu_torch.core.views import get_view_preset
    from fractalshark_tpu_torch.ops import escape

    dev = kernels.resolve_device(device)
    size, max_iter = 256, 512
    ptz = get_view_preset(0).ptz.square_aspect_ratio(size, size)
    p = escape.PlainParams.from_view(ptz, size, size)

    def forward(scalars: torch.Tensor) -> torch.Tensor:
        min_x, max_y, dx, dy, mi = scalars.cpu().tolist()
        return escape.escape(escape.PlainParams(min_x, max_y, dx, dy), size,
                             size, int(mi), "f32", dev,
                             tile=False).to(torch.int32)

    scalars = torch.tensor([p.min_x, p.max_y, p.dx, p.dy, float(max_iter)],
                           dtype=torch.float32, device=dev)
    return forward, (scalars,)


def _frame(n: int):
    """The dry run's view, square-adjusted to its 64 x 8n frame."""
    from fractalshark_tpu_torch.core.pointzoom import PointZoomBBConverter
    return PointZoomBBConverter(
        pt_x=CX, pt_y=CY, zoom_factor="1e8",
        prec=512).square_aspect_ratio(WIDTH, ROWS_PER_RANK * n)


def _rank(rank: int, n: int, device: str, workdir: str) -> dict:
    """One rank's cases; raises on the first difference."""
    import pickle

    import torch.distributed as dist

    from fractalshark_tpu_torch.core.highprecision import HighPrecision
    from fractalshark_tpu_torch.ops.bignum import fixedpoint as FP
    from fractalshark_tpu_torch.ops.bignum import ntt as N
    from fractalshark_tpu_torch.ops.bignum import orbit as O
    from fractalshark_tpu_torch.parallel import ntt_sharded as NS
    from fractalshark_tpu_torch.parallel import render as sharded
    from fractalshark_tpu_torch.parallel import stream_render as SR

    dev = torch.device("cuda", 0) if device == "cuda" else torch.device("cpu")
    with open(os.path.join(workdir, "orbit.pkl"), "rb") as fh:
        res = pickle.load(fh)
    kernels.reset_counts()
    mesh = sharded.make_mesh(dev)
    h, w = ROWS_PER_RANK * n, WIDTH
    ptz = _frame(n)

    # the row-sharded HDR render (K6 on the rank's slab) and its stats
    part = sharded.sharded_perturb_render_hdr(res, ptz, w, h, BUDGET, mesh,
                                              sub_dtype=np.float32)
    stats = sharded.sharded_stats(part, mesh)
    frame = sharded.gather_rows(part, h, mesh)
    total = stats["sum"]
    if tuple(frame.shape) != (h, w) or total <= 0:
        raise AssertionError(f"sharded render: shape {tuple(frame.shape)}, "
                             f"sum {total}")
    if total != int(frame.sum()):
        raise AssertionError("sharded_stats sum != the gathered frame's")

    # the stream form of the same frame
    stream = SR.sharded_perturb_render_stream(res, ptz, w, h, BUDGET, mesh)
    if not torch.equal(stream, frame):
        raise AssertionError("sharded stream render != sharded HDR render")

    # the limb-sharded 3-way product = the one-device four-step chain
    lmesh = NS.make_limb_mesh(dev)
    rng = np.random.default_rng(0)
    digits = rng.integers(0, 1 << 16, NFFT).astype(np.uint32)
    digits[NFFT // 2:] = 0
    rows = NS.multiply_3way_sharded(digits, digits, lmesh)
    x = torch.from_numpy(np.tile(digits.astype(np.int32), (4, 1))).to(dev)
    f = N.fourstep_forward(x, NFFT)
    xx = N.mont_mul_rows(f[:2], f[:2])
    want = N.fourstep_inverse_scaled(torch.cat([xx, xx, xx]), NFFT, True)
    if not torch.equal(rows, want):
        raise AssertionError("sharded NTT product != one device's")

    # three sharded orbit steps = the one-device chunk, digit for digit
    spec = FP.FixedSpec.for_limbs(ORBIT_LIMBS)
    prec = spec.frac_bits - 20
    scx, cxd = FP.hp_to_digits(HighPrecision(ORBIT_CX, prec=prec), spec)
    scy, cyd = FP.hp_to_digits(HighPrecision(ORBIT_CY, prec=prec), spec)
    cxt, cyt = (torch.from_numpy(d.astype(np.int32)).to(dev)
                for d in (cxd, cyd))
    states = []
    for m in (lmesh, None):
        st = O.OrbitState(scx, cxd, scy, cyd, dev)
        O.orbit_chunk(st, scx, cxt, scy, cyt, spec, ORBIT_STEPS, mesh=m)
        states.append(st)
    for name in ("x", "y", "row"):
        if not torch.equal(getattr(states[0], name),
                           getattr(states[1], name)):
            raise AssertionError(f"sharded orbit step != one device's "
                                 f"({name})")
    dist.barrier()
    return {"devices": n, "device": str(dev), "shape": [h, w],
            "iter_sum": total, "iter_min": stats["min"],
            "iter_max": stats["max"], "nfft": NFFT, "digits": spec.digits,
            "checks": {"stream": True, "ntt": True, "orbit": True},
            "launches": {k: v for k, v in kernels.launches.items() if v}}


def _rank_main(argv) -> int:
    """``--rank RANK N DEVICE DIR``: one rank of the dry run, its result
    in ``DIR/rank<RANK>.json``."""
    import torch.distributed as dist

    rank, n, device, workdir = int(argv[0]), int(argv[1]), argv[2], argv[3]
    torch.set_num_threads(1)
    if device == "cuda":
        torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method="file://" + os.path.join(
        workdir, "store"), world_size=n, rank=rank)
    try:
        out = _rank(rank, n, device, workdir)
    finally:
        dist.destroy_process_group()
    tmp = os.path.join(workdir, f"rank{rank}.json.tmp")
    with open(tmp, "w") as fh:
        json.dump(out, fh)
    os.replace(tmp, os.path.join(workdir, f"rank{rank}.json"))
    return 0


def dryrun_multichip(n: int, device="cuda", timeout: float = 600) -> dict:
    """Run the dry run on ``n`` ranks; print rank 0's line and return its
    record.  The kernels are built and the replicated reference orbit is
    computed here, once, before the ranks start.  A rank that fails ends
    the others at once and raises here."""
    import pickle

    from fractalshark_tpu_torch.engine.reforbit import RefOrbitCalc

    dev = kernels.resolve_device(device)
    if n < 1:
        raise ValueError(f"dryrun_multichip needs n >= 1, not {n}")
    if dev.type == "cuda":
        kernels.build()
    res = RefOrbitCalc().get_and_create_useful_results(_frame(n), BUDGET)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (root, os.environ.get("PYTHONPATH")) if p))
    with tempfile.TemporaryDirectory() as workdir:
        with open(os.path.join(workdir, "orbit.pkl"), "wb") as fh:
            pickle.dump(res, fh)
        procs = []
        for r in range(n):
            with open(os.path.join(workdir, f"rank{r}.log"), "w") as log:
                procs.append(subprocess.Popen(
                    [sys.executable, "-m", "fractalshark_tpu_torch.graft_entry",
                     "--rank", str(r), str(n), dev.type, workdir],
                    env=env, cwd=root, stdout=log, stderr=subprocess.STDOUT))
        deadline = time.monotonic() + timeout
        try:
            while any(p.poll() is None for p in procs):
                if any(p.poll() not in (None, 0) for p in procs) or \
                        time.monotonic() > deadline:
                    break
                time.sleep(0.05)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                p.wait()
        for r, p in enumerate(procs):
            if p.returncode != 0:
                with open(os.path.join(workdir, f"rank{r}.log")) as fh:
                    text = fh.read()[-4000:]
                raise RuntimeError(f"dryrun_multichip rank {r} (exit "
                                   f"{p.returncode}):\n{text}")
        outs = []
        for r in range(n):
            with open(os.path.join(workdir, f"rank{r}.json")) as fh:
                outs.append(json.load(fh))
    rec = outs[0]
    for r, o in enumerate(outs[1:], 1):
        if {k: o[k] for k in ("shape", "iter_sum")} != \
                {k: rec[k] for k in ("shape", "iter_sum")}:
            raise RuntimeError(f"dryrun_multichip: rank {r} disagrees")
    print(f"dryrun_multichip OK: {n} devices ({rec['device']}), "
          f"perturbation render {tuple(rec['shape'])} sharded over mesh, "
          f"iter_sum={rec['iter_sum']}; streaming render row-slab-sharded, "
          f"bit-identical; limb-sharded NTT bit-identical at "
          f"nfft={rec['nfft']}; mesh-wired orbit_chunk (sharded multiply + "
          f"CRT/carry tail) bit-identical at {rec['digits']} digits",
          flush=True)
    return rec


def main(argv=None) -> int:
    import argparse

    argv = sys.argv[1:] if argv is None else argv
    if argv[:1] == ["--rank"]:
        return _rank_main(argv[1:])
    ap = argparse.ArgumentParser(description="The port's graft entry "
                                 "points: the forward step, or the dry run "
                                 "over N ranks.")
    ap.add_argument("--dryrun", type=int, metavar="N", default=None)
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args(argv)
    if a.dryrun is not None:
        dryrun_multichip(a.dryrun, a.device)
        return 0
    fn, args = entry(a.device)
    out = fn(*args)
    print("entry OK:", tuple(out.shape), out.dtype, int(out.sum()))
    return 0


if __name__ == "__main__":
    sys.exit(main())
