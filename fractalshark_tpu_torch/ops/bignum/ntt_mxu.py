"""The one-launch orbit step: the port of ``mxu_iterate_full``
(``fractalshark_tpu/ops/bignum/ntt_mxu.py:965-1038``, the Pallas
``_iterfull_kernel`` :920, B-f5) through kernel K11
(``csrc/iterate_full.cu`` ``fs_iterate_full``), and the reference's
routing flags of this module.

On the TPU ``MXU_ITER`` sends the orbit and NR steps from nfft 8,192 to
the MXU product kernels (B5/B8a, B7/B8b); in the port that route is K4
(``csrc/ntt_orbit.cu``), which computes those kernels' function at every
size, so ``MXU_ITER`` keeps the step on K4 wherever the reference's
``_use_mxu_iter`` holds, and the flag-off kernels of ``ntt_pallas`` are
reached at those sizes only with it off, as in the reference.

``MXU_ITER_FULL`` (off, as in the reference) runs the whole step
z ← z² + c in one launch: K11 is K9's three phases for the plan
(x² − y², x·y) followed, after a grid-wide barrier, by K10's tail bodies
over tiles of both components with their shadow rows, then the
finishing body after another.  Its plain twin is K9's and K10's twins in
turn; ``iterate_full_tiled_plain`` is its schedule (K9's rounds, then
K10's tiles).
"""

from __future__ import annotations

import numpy as np
import torch

from fractalshark_tpu_torch import kernels
from fractalshark_tpu_torch.ops.bignum import fixedpoint as FP
from fractalshark_tpu_torch.ops.bignum import ntt as N
from fractalshark_tpu_torch.ops.bignum import ntt_pallas as NP

MXU_ITER: bool = True
MXU_ITER_FULL: bool = False


def iter_kernel_supported(n: int) -> bool:
    """The sizes of the reference's MXU step kernels (``:626-631``)."""
    if n & (n - 1) or n < 8192:
        return False
    n1, n2 = N.split_n(n)
    return n1 % 8 == 0 and n2 % 128 == 0 and 8 <= n1 <= 4096 \
        and n2 <= 4096


def use_iter_kernel(n: int) -> bool:
    return MXU_ITER and iter_kernel_supported(n)


def mxu_iterate_full_plain(x, y, cadd, rnd, cfg, n: int, shadow_fd=None):
    """K11's function: K9's and K10's twins in turn."""
    xp = torch.zeros(2, n, dtype=torch.int32, device=x.device)
    xp[0, :x.shape[0]] = x
    xp[1, :y.shape[0]] = y
    inv = NP.products_plain(xp, None, n, NP.PLAN_ITER)
    return NP.fused_tail_plain(inv, cadd, rnd, cfg, shadow_fd)


def iterate_full_tiled_plain(x, y, cadd, rnd, cfg, n: int, shadow_fd=None,
                             zsign=None, rng: np.random.Generator | None
                             = None):
    """K11's schedule in torch: K9's rounds twin
    (``ntt_pallas.products_rounds_plain``), then K10's tiled tail twin at
    K10's tiles (K11's blocks have K10's 256 threads), the look-back's
    view of earlier tiles chosen by `rng` as in ``tail_tiled_plain``."""
    xp = torch.zeros(2, n, dtype=torch.int32, device=x.device)
    xp[0, :x.shape[0]] = x
    xp[1, :y.shape[0]] = y
    inv = NP.products_rounds_plain(xp, None, n, NP.PLAN_ITER)
    return NP.tail_tiled_plain(inv, cadd, rnd, cfg, shadow_fd, zsign,
                               rng=rng)


def launch_iterate_full(x, y, din: int, cadd, rnd, cfg, shadow_fd,
                        zsign=None):
    """Launch K11 once on CUDA tensors; ``x``/``y`` point at ``din``
    digits (zero beyond), ``zsign`` as in ``ntt_pallas.launch_tail``.  Its
    12n words of work are the device's cached scratch
    (``kernels.scratch``), its tail state K10's (``kernels.tail_state``):
    a call allocates only its outputs."""
    dev = x.device
    n = rnd.shape[0]
    dig = torch.empty(2, n, dtype=torch.int32, device=dev)
    sgn = torch.empty(2, dtype=torch.int32, device=dev)
    shw = None if shadow_fd is None else torch.empty(2, 5, dtype=torch.int32,
                                                     device=dev)
    scratch = kernels.scratch(dev, 12 * n)
    F, D = shadow_fd if shadow_fd is not None else (0, 0)
    words = np.asarray(cfg, np.int32)
    rc = kernels.lib().fs_iterate_full(
        x.data_ptr(), y.data_ptr(), din, cadd.data_ptr(), rnd.data_ptr(),
        words.ctypes.data, 0 if zsign is None else zsign.data_ptr(),
        dig.data_ptr(), sgn.data_ptr(), 0 if shw is None else shw.data_ptr(),
        scratch.data_ptr(), FP.k9_tables(n, dev).data_ptr(),
        kernels.tail_state(dev).data_ptr(), n.bit_length() - 1, F, D,
        kernels.stream(dev))
    kernels.check(rc, "iterate_full")
    kernels.launches["iterate_full"] += 1
    return (dig, sgn) if shw is None else (dig, sgn, shw)


def mxu_iterate_full(x, y, cadd, rnd, cfg, n: int, shadow_fd=None,
                     in_digits: int | None = None, zsign=None):
    """One whole z ← z² + c digit update (``ntt_mxu.py:965``): x, y int32
    digit magnitudes ([in_digits], zero-padded to n); cadd int32 [2, n]
    addend planes; rnd int32 [n]; cfg = per component (double, gswap,
    csign, 0).  Returns (digits int32 [2, n], signs int32 [2][, shadows
    int32 [2, 5]]): K11 on CUDA tensors, its twin on CPU tensors.
    ``zsign`` (int32 [2], optional): component 1's gswap is
    zsign[0]·zsign[1], the pre-update signs, read on the device."""
    if not iter_kernel_supported(n):
        raise ValueError(f"mxu_iterate_full: unsupported size {n}")
    din = x.shape[0] if in_digits is None else in_digits
    if x.shape != (din,) or y.shape != (din,) or din > n:
        raise ValueError("mxu_iterate_full: x, y must be [in_digits]")
    NP._check_tail(torch.empty(2, 2, n, dtype=torch.int32, device=x.device),
                   cadd, rnd, cfg, shadow_fd)
    if cadd.shape != (2, n):
        raise ValueError("mxu_iterate_full: cadd must be [2, n]")
    if x.device.type == "cpu":
        if zsign is not None:
            cfg = list(cfg)
            cfg[5] = int(zsign[0]) * int(zsign[1])
        return mxu_iterate_full_plain(x, y, cadd, rnd, cfg, n, shadow_fd)
    return launch_iterate_full(x.contiguous(), y.contiguous(), din,
                               cadd.contiguous(), rnd.contiguous(), cfg,
                               shadow_fd, zsign)
