#!/usr/bin/env python3
"""Time the port's generic NTT (kernel K8, ``csrc/ntt_phase.cu``) on one
NVIDIA card: the four-step transforms as the generic multiplies call
them, one phase alone, and the multiplies.

    python3 tools/time_ntt.py [--tree DIR] [--reps N] [--only TEXT ...]

For each call it prints one JSON line: the median, min and max of
``--reps`` single calls under CUDA events (``ms``, after a warm-up call
that builds the tables), and one traced call (``tools/
time_pixel_loops.py`` ``trace_call``): the sum of its CUDA kernels'
intervals (``device_ms``), their count, their names, and the host syncs
torch reports.  Calls: ``fourstep_forward`` and
``fourstep_inverse_scaled`` at n = 65,536 and 131,072 with 4 and 6 rows;
``phase_kernel`` (one phase, no epilogue) at [4,256,256] and
[14,256,512]; ``multiply_3way`` and ``multiply_nr`` at 2,048, 16,384
and 32,768 limbs (digits on the card, as the smoke passes them);
``--only`` keeps the calls whose label contains one of the texts.  The
inputs are random residues and digits from a fixed seed.

``--tree DIR`` imports ``fractalshark_tpu_torch`` from DIR (another
checkout, e.g. a ``git archive`` of the parent commit), so two versions
can be timed in turns in one run on one card.  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import statistics
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TRANSFORMS = [(65536, 4), (65536, 6), (131072, 4), (131072, 6)]
PHASES = [(4, 256, 256), (14, 256, 512)]
MUL_LIMBS = (2048, 16384, 32768)


def log(msg: str) -> None:
    print(msg, flush=True)


def _trace_call():
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "time_pixel_loops.py")
    spec = importlib.util.spec_from_file_location("time_pixel_loops", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.trace_call


def time_call(fn, reps: int) -> dict:
    """Median, min and max ms of `reps` single calls under CUDA events,
    after one warm-up call."""
    import torch
    fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return {"ms": statistics.median(times), "ms_min": min(times),
            "ms_max": max(times)}


def calls(device):
    """(label, function) of every call timed."""
    import numpy as np
    import torch

    from fractalshark_tpu_torch.ops.bignum import fixedpoint as FP
    from fractalshark_tpu_torch.ops.bignum import ntt as N

    rng = np.random.default_rng(10)

    def residues(shape):
        a = np.stack([rng.integers(0, (N.P1, N.P2)[r % 2], shape[1:])
                      for r in range(shape[0])])
        return torch.from_numpy(a.astype(np.int32)).to(device)

    out = []
    for n, rows in TRANSFORMS:
        x = residues((rows, n))
        out.append((f"fourstep_forward n={n} rows={rows}",
                    lambda x=x, n=n: N.fourstep_forward(x, n)))
        out.append((f"fourstep_inverse_scaled n={n} rows={rows}",
                    lambda x=x, n=n: N.fourstep_inverse_scaled(x, n)))
    for rows, m, lanes in PHASES:
        y = residues((rows, m, lanes))
        out.append((f"phase_kernel [{rows},{m},{lanes}]",
                     lambda y=y, m=m: N.phase_kernel(y, m, False)))
    for limbs in MUL_LIMBS:
        spec = FP.FixedSpec.for_limbs(limbs)
        d = []
        for _ in range(4):
            v = rng.integers(0, 1 << 16, spec.digits, dtype=np.uint32)
            v[-1], v[-2] = 0, v[-2] & 3
            d.append(torch.from_numpy(v.astype(np.int32)).to(device))
        out.append((f"multiply_3way {limbs} limbs",
                    lambda d=d, spec=spec: FP.multiply_3way(
                        d[0], d[1], spec, device=device)))
        out.append((f"multiply_nr {limbs} limbs",
                    lambda d=d, spec=spec: FP.multiply_nr(
                        *d, spec, device=device)))
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", default=ROOT)
    ap.add_argument("--reps", type=int, default=7)
    ap.add_argument("--only", nargs="*")
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.tree))
    import torch
    if not torch.cuda.is_available():
        print("FAIL: no CUDA device", file=sys.stderr)
        return 1
    from fractalshark_tpu_torch import kernels
    device = torch.device("cuda", 0)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    log(f"tree {os.path.abspath(args.tree)}; card {card}")
    kernels.lib()
    trace_call = _trace_call()
    for label, fn in calls(device):
        if args.only and not any(t in label for t in args.only):
            continue
        kernels.reset_counts()
        fn()
        torch.cuda.synchronize()
        k8 = kernels.launches["ntt_phase"]
        rec = {"call": label, "k8_launches": k8, **time_call(fn, args.reps)}
        tr = trace_call(fn)
        order = tr.pop("order")
        # CUDA kernels between a transform's first and last K8 launch
        k8_at = [i for i, name in enumerate(order) if "phase" in name]
        if k8_at:
            tr["kernels_between_k8"] = k8_at[-1] - k8_at[0] + 1 - len(k8_at)
        rec.update(tr)
        log(json.dumps(rec))
    log(json.dumps({"card": card}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
