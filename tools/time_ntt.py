#!/usr/bin/env python3
"""Time the port's generic NTT (kernel K8, ``csrc/ntt_phase.cu``) on one
NVIDIA card: the four-step transforms as the generic multiplies call
them, one phase alone, and the multiplies; and the flag-off bignum
kernels: K9 (``ntt_pallas.launch_products``), K10 (``ntt_pallas.
launch_tail``) and K11 (``ntt_mxu.mxu_iterate_full``).

    python3 tools/time_ntt.py [--tree DIR] [--reps N] [--only TEXT ...]
                              [--trace-reps N] [--margin-ms MS]

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
``products`` (K9, whole and split) at nfft 2,048, 16,384, 32,768 and
131,072 with the iteration plan and the signed NR-iteration plan, on the
values ``chip_smoke.py`` phase 12 makes (16-bit digits in the low half,
from seed 12); ``tail`` (K10, gridded and batched) at nfft 2,048,
16,384 and 65,536 with K = 2 and the shadow rows and with K = 4 (the NR
configuration), random residue rows and addend planes as
``tests/test_torch_tail_fused.py`` makes them; ``iterate_full`` (K11)
at 2,048 and 16,384 limbs from random values in (-2, 2), and the same
step as K9's whole form then K10 (``k9 whole + k10``), the two launches
K11 replaces.  Each record also has the launches of one call by counter
(``launches``).  ``--only`` keeps the calls whose label contains one of
the texts.  The inputs are random residues and digits
from a fixed seed.  ``--trace-reps N`` traces each call N times more and
adds how many traces held each number of CUDA kernels
(``traces_by_kernels``, each a single trace, where the record above keeps
the fullest of three), to show how often a trace loses a launch;
``--margin-ms`` is the time the traced call sits inside each end of the
profiler's window (default 2).

``--tree DIR`` imports ``fractalshark_tpu_torch`` from DIR (another
checkout, e.g. a ``git archive`` of the parent commit), so two versions
can be timed in turns in one run on one card.  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import collections
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
TAIL_NFFT = (2048, 16384, 65536)
FULL_LIMBS = (2048, 16384)
PRODUCT_NFFT = (2048, 16384, 32768, 131072)


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
    out += product_calls(device)
    out += tail_calls(device, rng)
    return out


def product_calls(device):
    """(label, function) of K9 in both forms: the iteration plan and the
    signed NR-iteration plan, on chip_smoke.py phase 12's values."""
    import numpy as np
    import torch

    from fractalshark_tpu_torch.ops.bignum import ntt_pallas as NP

    rng = np.random.default_rng(12)
    signs = torch.tensor([1, -1, -1, 1], dtype=torch.int32, device=device)
    plans = {"iter": (2, NP.PLAN_ITER, None),
             "nriter": (4, NP.PLAN_NR_ITER, signs)}
    out = []
    for n in PRODUCT_NFFT:
        x = torch.zeros(4, n, dtype=torch.int32, device=device)
        x[:, :n // 2] = torch.from_numpy(rng.integers(
            0, 1 << 16, (4, n // 2)).astype(np.int32)).to(device)
        for name, (V, plan, sg) in plans.items():
            for form in ("whole", "split"):
                out.append((f"products {form} n={n} {name}",
                            lambda a=(list(x[:V]), n, sg, n, plan, form):
                            NP.launch_products(*a)))
    return out


def tail_calls(device, rng):
    """(label, function) of K10 under both flags and of K11."""
    import numpy as np
    import torch

    from fractalshark_tpu_torch.core.highprecision import HighPrecision
    from fractalshark_tpu_torch.ops.bignum import fixedpoint as FP
    from fractalshark_tpu_torch.ops.bignum import ntt as N
    from fractalshark_tpu_torch.ops.bignum import ntt_mxu as NM
    from fractalshark_tpu_torch.ops.bignum import ntt_pallas as NP

    def t(a):
        return torch.from_numpy(np.asarray(a).astype(np.int32)).to(device)

    out = []
    for n in TAIL_NFFT:
        D = n // 2
        rnd = np.zeros(n, np.uint32)
        rnd[D - 3] = 1 << 15
        for K in (2, 4):
            inv = t(np.stack([np.stack([
                rng.integers(0, p, n, dtype=np.uint64) for p in
                (N.P1, N.P2)]) for _ in range(K)]))
            cadd = t(rng.integers(0, 1 << 16, (K, n), dtype=np.uint32))
            cfg = NP.tail_cfg((1, -1, -1, 0), K == 4)
            fd = (D - 2, D) if K == 2 else None
            for batched in (False, True):
                form = "batched" if batched else "grid"
                out.append((
                    f"tail {form} n={n} K={K}" + (" shadows" if fd else ""),
                    lambda a=(inv, cadd, t(rnd), cfg, fd, batched):
                    NP.launch_tail(*a)))
    for limbs in FULL_LIMBS:
        spec = FP.FixedSpec.for_limbs(limbs)
        F, D = spec.frac_digits, spec.digits
        st = [FP.hp_to_digits(HighPrecision(rng.uniform(-2, 2),
                                            prec=spec.frac_bits + 30), spec)
              for _ in range(4)]
        x, y, cx, cy = (t(d) for _, d in st)
        cadd, rnd = FP.addend_planes(cx, cy, spec)
        cfg = NP.tail_cfg((st[2][0], st[3][0], st[0][0] * st[1][0], 0),
                          False)
        out.append((f"iterate_full {limbs} limbs",
                    lambda a=(x, y, cadd, rnd, cfg, spec.nfft, (F, D)):
                    NM.mxu_iterate_full(*a)))

        def k9_k10(x=x, y=y, cadd=cadd, rnd=rnd, cfg=cfg, n=spec.nfft,
                   fd=(F, D)):
            inv = NP.launch_products([x, y], fd[1], None, n, NP.PLAN_ITER,
                                     "whole")
            return NP.launch_tail(inv, cadd, rnd, cfg, fd, False)
        out.append((f"k9 whole + k10 {limbs} limbs", k9_k10))
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", default=ROOT)
    ap.add_argument("--reps", type=int, default=7)
    ap.add_argument("--only", nargs="*")
    ap.add_argument("--trace-reps", type=int, default=0)
    ap.add_argument("--margin-ms", type=float, default=2.0)
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
        launches = {k: v for k, v in kernels.launches.items() if v}
        rec = {"call": label, "k8_launches": k8, "launches": launches,
               **time_call(fn, args.reps)}
        margin = args.margin_ms / 1e3
        tr = trace_call(fn, margin)
        order = tr.pop("order")
        # CUDA kernels between a transform's first and last K8 launch
        k8_at = [i for i, name in enumerate(order) if "phase" in name]
        if k8_at:
            tr["kernels_between_k8"] = k8_at[-1] - k8_at[0] + 1 - len(k8_at)
        rec.update(tr)
        if args.trace_reps:
            rec["traces_by_kernels"] = dict(collections.Counter(
                trace_call(fn, margin, tries=1)["kernels"]
                for _ in range(args.trace_reps)))
        log(json.dumps(rec))
    log(json.dumps({"card": card}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
