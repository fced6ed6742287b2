"""The number-theoretic transform: the two 31-bit primes of
``fractalshark_tpu/ops/bignum/ntt.py:35-38`` and their root-of-unity
tables, shared by the CUDA product kernels K4 (``csrc/ntt_orbit.cu``),
K9 and K11 (``csrc/ntt_products.cu``, ``csrc/iterate_full.cu``: the same
``kernel_tables`` operand) and their plain twins (``fixedpoint.py``,
``ntt_pallas.py``); and the generic transforms of the
reference (``ntt.py:195-735``) that its generic multiplies and the debug
checksum tool run, through the phase kernel K8 (``csrc/ntt_phase.cu``).

Why two 31-bit primes and not one 64-bit prime: the plain twin runs in
torch int64, where a product of two residues below 2^31 is exact; a
64-bit prime would need 128-bit products.  Their CRT capacity
p1·p2 ≈ 2^61.7 holds every coefficient of the orbit step's products
(|c| ≤ 2·D·(2^16 − 1)² < 2^49 at D = 2^16 digits) with room for the
sign.

Tables are numpy, built once per transform size and cached; the kernel
gets them in Montgomery form (R = 2^32), the twin in plain form.

The generic transforms work on int32 tensors [R, ...] of canonical
residues, row r modulo p1 if r is even and p2 if r is odd; the plain
code runs in exact int64 on the tensors' device.  Every reference
operation (Montgomery, Shoup or plain modular product, add, subtract)
yields the canonical residue, so exact arithmetic mod p gives its
outputs bit for bit, scrambled orders included.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np
import torch

from fractalshark_tpu_torch import kernels

P1 = 2013265921  # 15 * 2^27 + 1
P2 = 1811939329  # 27 * 2^26 + 1
G1 = 31          # primitive root mod P1
G2 = 13          # primitive root mod P2
PRIMES = ((P1, G1), (P2, G2))

# K4 keeps each four-step row or column (≤ 1024 points) in shared memory
MAX_LOG2N = 20

_R = 1 << 32


def mont_const(p: int) -> tuple[int, int, int]:
    """(p' = -p^-1 mod 2^32, R mod p, R^2 mod p)."""
    pinv = pow(p, -1, _R)
    return (_R - pinv) % _R, _R % p, (_R * _R) % p


def _powers(w: int, n: int, p: int) -> np.ndarray:
    """[w^0, w^1, ..., w^(n-1)] mod p, by doubling (products < 2^62)."""
    out = np.ones(n, np.uint64)
    m = 1
    while m < n:
        step = np.uint64(pow(w, m, p))
        out[m:2 * m] = out[:min(m, n - m)] * step % np.uint64(p)
        m *= 2
    return out


@functools.lru_cache(maxsize=8)
def root_tables(n: int) -> tuple[np.ndarray, np.ndarray]:
    """Forward and inverse root powers, int64 [2 primes, n] each:
    ``fwd[i, k] = w_i^k`` and ``inv[i, k] = w_i^-k`` with w_i a primitive
    n-th root of unity mod the i-th prime."""
    if n & (n - 1) or not 2 <= n <= 1 << MAX_LOG2N:
        raise ValueError(f"transform size {n} is not a power of two in "
                         f"[2, 2^{MAX_LOG2N}]")
    fwd, inv = [], []
    for p, g in PRIMES:
        w = pow(g, (p - 1) // n, p)
        fwd.append(_powers(w, n, p))
        inv.append(_powers(pow(w, p - 2, p), n, p))
    return (np.stack(fwd).astype(np.int64), np.stack(inv).astype(np.int64))


@functools.lru_cache(maxsize=8)
def kernel_tables(n: int) -> np.ndarray:
    """K4's table operand, uint32 [4n + 4]: forward roots mod p1, mod p2,
    inverse roots mod p1, mod p2 (each n entries, Montgomery form), then
    ``n^-1·R² mod p1``, ``n^-1·R² mod p2`` (the inverse transform's scale,
    which also cancels the R^-1 of the pointwise Montgomery products)
    and ``p1^-1·R mod p2`` (the CRT step), and one pad word."""
    fwd, inv = root_tables(n)
    rows = []
    for tab in (fwd, inv):
        for i, (p, _) in enumerate(PRIMES):
            rows.append((tab[i].astype(object) * _R % p).astype(np.uint32))
    consts = [pow(n, -1, p) * _R * _R % p for p, _ in PRIMES]
    consts += [pow(P1, -1, P2) * _R % P2, 0]
    return np.concatenate(rows + [np.asarray(consts, np.uint32)])


# ------------------------------------------------------ generic transforms

# K8 holds one phase column per lane in shared memory: m <= 4,096, so the
# four-step covers n = n1·n2 <= 2^24
MAX_PHASE = 4096
# the generic multiplies take the four-step from this size, the flat
# transform below it (``fixedpoint.py:313,542,919``)
FOURSTEP_MIN = 8192


def _check_pow2(n: int, lo: int, hi: int, what: str) -> None:
    if n & (n - 1) or not lo <= n <= hi:
        raise ValueError(f"{what} {n} is not a power of two in [{lo}, {hi}]")


def _row_idx(rows: int, device) -> torch.Tensor:
    """Each row's prime index (r % 2)."""
    return torch.arange(rows, device=device) % 2


_rows_cache: dict = {}


def _per_row(values, a: torch.Tensor) -> torch.Tensor:
    """int64 per-prime values, one per row of a (row r takes values[r %
    2]), shaped to broadcast over a.  Made on a's device once per
    (values, rows, device) and cached: a host-to-device copy on every call
    would stall the stream."""
    key = (tuple(int(v) for v in values), a.shape[0], str(a.device))
    t = _rows_cache.get(key)
    if t is None:
        t = torch.tensor(key[0], dtype=torch.int64, device=a.device)
        t = _rows_cache[key] = t[_row_idx(a.shape[0], a.device)]
    return t.view((-1,) + (1,) * (a.dim() - 1))


_PS = [p for p, _ in PRIMES]


def mul_rows(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a·b mod p per row, exactly (int32 residues, b broadcast)."""
    return (a.to(torch.int64) * b.to(torch.int64)
            % _per_row(_PS, a)).to(torch.int32)


def mont_mul_rows(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a·b·R^-1 mod p per row: the reference's ``_mont_mul_rows``."""
    return mul_rows(mul_rows(a, b),
                    _per_row([pow(_R, -1, p) for p in _PS], a))


def mod_add_rows(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return ((a.to(torch.int64) + b) % _per_row(_PS, a)).to(torch.int32)


def mod_sub_rows(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return ((a.to(torch.int64) - b) % _per_row(_PS, a)).to(torch.int32)


def split_n(n: int) -> tuple[int, int]:
    """The four-step split n = n1·n2, n1 = 2^floor(log2(n)/2)
    (``ntt.py:434-437``)."""
    s = n.bit_length() - 1
    n1 = 1 << (s // 2)
    return n1, n // n1


@functools.lru_cache(maxsize=32)
def phase_twiddles(m: int, inverse: bool) -> np.ndarray:
    """int64 [2 primes, m/2]: w_m^k (forward) or w_m^-k (inverse), the
    roots every stage of a length-m phase indexes
    (``_fourstep_consts.stage_tws``)."""
    fwd, inv = root_tables(m)
    return (inv if inverse else fwd)[:, :m // 2].copy()


@functools.lru_cache(maxsize=64)
def stage_twiddles(m: int, rows: int, inverse: bool) -> tuple:
    """Per stage, the twiddles int64 [rows, h] of a length-m phase
    (forward DIF stage s: h = m >> (s+1), w_m^(j << s); inverse DIT stage
    s: h = 2^s, w_m^-(j << (lg-1-s))): the values of ``_stage_tw_shoup``
    and of ``_fourstep_consts``' ``tw*`` pairs."""
    tw = phase_twiddles(m, inverse)
    lg = m.bit_length() - 1
    out = []
    for s in range(lg):
        idx = np.arange(1 << s) << (lg - 1 - s) if inverse \
            else np.arange(m >> (s + 1)) << s
        out.append(np.stack([tw[r % 2, idx] for r in range(rows)]))
    return tuple(out)


@functools.lru_cache(maxsize=16)
def fourstep_twiddles(n: int) -> tuple[np.ndarray, np.ndarray]:
    """(t1, t1i), int64 [2 primes, n1, n2]: t1[i, row, c] =
    w_n^(bitrev(row)·c) and t1i its inverse, the twiddle matrices between
    the phases (``_fourstep_consts`` ``t1``/``t1i``)."""
    n1, n2 = split_n(n)
    bits1 = n1.bit_length() - 1
    rev1 = np.array([int(format(k, f"0{bits1}b")[::-1], 2) if bits1 else 0
                     for k in range(n1)], np.int64)
    expo = (rev1[:, None] * np.arange(n2)[None, :]) % n
    t1, t1i = [], []
    for p, g in PRIMES:
        w = pow(g, (p - 1) // n, p)
        t1.append(_powers(w, n, p).astype(np.int64)[expo])
        t1i.append(_powers(pow(w, p - 2, p), n, p).astype(np.int64)[expo])
    return np.stack(t1), np.stack(t1i)


def scale_consts(n: int, extra_scale_r: bool) -> np.ndarray:
    """int64 [2 primes]: n^-1 mod p, times R when it also cancels a
    Montgomery pointwise product's R^-1."""
    return np.array([pow(n, -1, p) * (_R if extra_scale_r else 1) % p
                     for p, _ in PRIMES], np.int64)


_dev_cache: dict = {}


def _on(key, device, make) -> torch.Tensor:
    """A host table moved to ``device`` once (cached by key and device)."""
    k = key + (str(device),)
    if k not in _dev_cache:
        _dev_cache[k] = torch.from_numpy(make()).to(device)
    return _dev_cache[k]


def phase_transform_plain(y: torch.Tensor, m: int,
                          inverse: bool) -> torch.Tensor:
    """Plain twin of K8 on [R, m, L]: the reference's ``_axis0_dif``
    (forward) or ``_axis0_dit`` (inverse), ``ntt.py:598-632``."""
    rows, _, lanes = y.shape
    p = _per_row(_PS, y).view(rows, 1, 1, 1)
    a = y.to(torch.int64)
    for s, w_np in enumerate(stage_twiddles(m, rows, inverse)):
        h = w_np.shape[1]
        w = torch.from_numpy(w_np).to(y.device).view(rows, 1, h, 1)
        if inverse:
            y4 = a.view(rows, m >> (s + 1), 2, h, lanes)
            u = y4[:, :, 1] * w % p
            a = torch.stack([(y4[:, :, 0] + u) % p, (y4[:, :, 0] - u) % p],
                            dim=2)
        else:
            y4 = a.view(rows, 1 << s, 2, h, lanes)
            a0, a1 = y4[:, :, 0], y4[:, :, 1]
            a = torch.stack([(a0 + a1) % p, (a0 - a1) % p * w % p], dim=2)
        a = a.view(rows, m, lanes)
    return a.to(torch.int32)


def _k8_table(m: int, inverse: bool) -> np.ndarray:
    """K8's twiddles, uint32 [2 primes, m, 2] read as int32: the stage of
    half-span h = 2^b at [h − 1, 2h − 1), entry h − 1 + j =
    phase_twiddles[j << (log2(m) − 1 − b)] (the stage's twiddle of pair
    j) as (w, floor(w·2^32 / p)), the pair of a Shoup product; the last
    entry is unused."""
    tw = phase_twiddles(m, inverse)
    lg = m.bit_length() - 1
    w = np.zeros((2, m), np.int64)
    for b in range(lg):
        h = 1 << b
        w[:, h - 1:2 * h - 1] = tw[:, np.arange(h) << (lg - 1 - b)]
    wp = (w << 32) // np.array([[p] for p in _PS])
    return np.stack([w, wp], axis=-1).astype(np.uint32).view(np.int32)


def _k8_matrix(n: int, inverse: bool) -> np.ndarray:
    """The four-step's twiddle matrix in the order K8's epilogue reads it,
    [2 primes, L, m] of its first launch's phase (forward: t1
    transposed, [n2, n1]; inverse: t1i, [n1, n2]), Montgomery form,
    uint32 read as int32."""
    t1, t1i = fourstep_twiddles(n)
    mat = t1i if inverse else t1.transpose(0, 2, 1)
    mat = mat * _R % np.array([[[p]] for p in _PS])
    return np.ascontiguousarray(mat.astype(np.uint32).view(np.int32))


@functools.lru_cache(maxsize=8)
def k9_tables(n: int) -> np.ndarray:
    """K9's and K11's table operand, uint32 read as int32 [4 + 8·(n1 + n2)
    + 4n] (n = n1·n2, ``split_n``): ``n^-1·R² mod p1``, ``mod p2`` (the
    inverse's scale, which also cancels the R^-1 of the pointwise
    Montgomery products) and two pad words; K8's Shoup tables
    (``_k8_table``) of the column transforms (length n1), forward then
    inverse, and of the row transforms (length n2); then the four-step
    twiddle matrices ``fourstep_twiddles`` t1 and t1i, [2 primes, n1,
    n2] each in the order the row phase reads them, Montgomery form."""
    n1, n2 = split_n(n)
    scale = [pow(n, -1, p) * _R * _R % p for p in _PS] + [0, 0]
    parts = [np.asarray(scale, np.uint32)]
    for m in (n1, n2):
        for inverse in (False, True):
            parts.append(_k8_table(m, inverse).view(np.uint32).ravel())
    ps = np.array([[[p]] for p in _PS], np.int64)
    for t in fourstep_twiddles(n):
        parts.append((t * _R % ps).astype(np.uint32).ravel())
    return np.concatenate(parts).view(np.int32)


def _mont_words(values) -> tuple[int, int]:
    """Per-prime values in Montgomery form (v·R mod p)."""
    return tuple(int(v) * _R % p for v, p in zip(values, _PS))


def phase_kernel(y: torch.Tensor, m: int, inverse: bool,
                 mat: torch.Tensor | None = None,
                 scale: tuple[int, int] | None = None) -> torch.Tensor:
    """Launch K8 once on a CUDA device over int32 [R, m, L]: the phase
    alone ([R, m, L]); with `mat` (int32 [2, L, m], ``_k8_matrix``) the
    phase transposed to [R, L, m] and times the matrix; with `scale` (a
    Montgomery word per prime) the phase times the scale ([R, m, L])."""
    rows, _, lanes = y.shape
    if not 0 < rows < (1 << 16):
        raise ValueError(f"K8 takes 1 to 65,535 rows, not {rows}")
    if mat is not None and (scale is not None or mat.dtype != torch.int32
                            or tuple(mat.shape) != (2, lanes, m)
                            or mat.device != y.device
                            or not mat.is_contiguous()):
        raise ValueError(f"K8's matrix must be int32 [2, {lanes}, {m}] on "
                         f"{y.device}, without a scale")
    y = y.contiguous()
    out = torch.empty((rows, lanes, m) if mat is not None else y.shape,
                      dtype=y.dtype, device=y.device)
    tw = _on(("k8", m, inverse), y.device, lambda: _k8_table(m, inverse))
    epi = 1 if mat is not None else (2 if scale is not None else 0)
    sc = scale if scale is not None else (0, 0)
    rc = kernels.lib().fs_ntt_phase(
        y.data_ptr(), out.data_ptr(), tw.data_ptr(),
        None if mat is None else mat.data_ptr(), rows, m, lanes,
        int(inverse), epi, sc[0], sc[1], kernels.stream(y.device))
    kernels.check(rc, "ntt_phase")
    kernels.launches["ntt_phase"] += 1
    return out


def _check_phase(y: torch.Tensor, m: int) -> None:
    _check_pow2(m, 2, MAX_PHASE, "phase length")
    if y.dim() != 3 or y.shape[1] != m or y.dtype != torch.int32:
        raise ValueError(f"K8 takes int32 [R, {m}, L], not "
                         f"{y.dtype}{tuple(y.shape)}")
    if y.device.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {y.device}")


def phase_transform(y: torch.Tensor, m: int, inverse: bool) -> torch.Tensor:
    """All radix-2 stages along axis 1 of int32 [R, m, L] (row r mod
    p1/p2 by r % 2): forward DIF, natural → bit-reversed; inverse DIT,
    bit-reversed → natural, unscaled.  K8 for CUDA tensors, the plain twin
    for CPU tensors; equal to B9a and B9b bit for bit."""
    _check_phase(y, m)
    if y.device.type == "cuda":
        return phase_kernel(y, m, inverse)
    return phase_transform_plain(y, m, inverse)


def _scale(y: torch.Tensor, n: int, extra_scale_r: bool) -> torch.Tensor:
    return mul_rows(y, _per_row(scale_consts(n, extra_scale_r).tolist(), y))


def _fourstep_shape(x: torch.Tensor, n: int, m: int) -> torch.Tensor:
    """x as [R, m, n / m] (n a four-step size, x int32 [R, n] or a view)."""
    _check_pow2(n, 4, MAX_PHASE * MAX_PHASE, "transform size")
    if x.dtype != torch.int32 or x.numel() != x.shape[0] * n:
        raise ValueError(f"the four-step takes int32 [R, {n}], not "
                         f"{x.dtype}{tuple(x.shape)}")
    y = x.reshape(x.shape[0], m, n // m)
    _check_phase(y, m)
    return y


def fourstep_head_plain(x: torch.Tensor, n: int,
                        inverse: bool) -> torch.Tensor:
    """Plain twin of a four-step's first K8 launch.  Forward: the phase
    of n1 over [R, n1, n2], times the twiddle matrix t1, transposed to
    [R, n2, n1]; inverse: the phase of n2 over [R, n2, n1], transposed to
    [R, n1, n2], times t1i (``ntt.py:678-718``)."""
    rows = x.shape[0]
    n1, n2 = split_n(n)
    m = n2 if inverse else n1
    b = phase_transform_plain(_fourstep_shape(x, n, m), m, inverse)
    t = _on(("t1i" if inverse else "t1", n), x.device,
            lambda: fourstep_twiddles(n)[int(inverse)])
    t = t[_row_idx(rows, x.device)]
    if inverse:
        return mul_rows(b.transpose(1, 2).contiguous(), t)
    return mul_rows(b, t).transpose(1, 2).contiguous()


def fourstep_tail_plain(b: torch.Tensor, n: int, inverse: bool,
                        extra_scale_r: bool = True) -> torch.Tensor:
    """Plain twin of a four-step's second K8 launch over the first's
    output: forward, the phase of n2 over [R, n2, n1]; inverse, the phase
    of n1 over [R, n1, n2], scaled by n^-1 (·R with `extra_scale_r`)."""
    n1, n2 = split_n(n)
    m = n1 if inverse else n2
    a = phase_transform_plain(_fourstep_shape(b, n, m), m, inverse)
    return _scale(a, n, extra_scale_r) if inverse else a


def fourstep_head(x: torch.Tensor, n: int, inverse: bool) -> torch.Tensor:
    """A four-step's first launch (``fourstep_head_plain``): K8 with the
    twiddle-matrix epilogue for CUDA tensors, the plain twin for CPU
    tensors."""
    n1, n2 = split_n(n)
    m = n2 if inverse else n1
    y = _fourstep_shape(x, n, m)
    if y.device.type == "cpu":
        return fourstep_head_plain(x, n, inverse)
    mat = _on(("k8_mat", n, inverse), y.device,
              lambda: _k8_matrix(n, inverse))
    return phase_kernel(y, m, inverse, mat=mat)


def fourstep_tail(b: torch.Tensor, n: int, inverse: bool,
                  extra_scale_r: bool = True) -> torch.Tensor:
    """A four-step's second launch (``fourstep_tail_plain``): K8 (with the
    scale epilogue for the inverse) for CUDA tensors, the plain twin for
    CPU tensors."""
    n1, n2 = split_n(n)
    m = n1 if inverse else n2
    y = _fourstep_shape(b, n, m)
    if y.device.type == "cpu":
        return fourstep_tail_plain(b, n, inverse, extra_scale_r)
    scale = _mont_words(scale_consts(n, extra_scale_r)) if inverse else None
    return phase_kernel(y, m, inverse, scale=scale)


def fourstep_forward(x: torch.Tensor, n: int) -> torch.Tensor:
    """Four-step forward of int32 [R, n]: phase of n1 over [R, n1, n2],
    the twiddle matrix, transpose, phase of n2 over [R, n2, n1]; the
    reference's scrambled spectra (``ntt.py:678-692``).  Two launches on
    the card (``fourstep_head``, ``fourstep_tail``)."""
    e = fourstep_tail(fourstep_head(x, n, False), n, False)
    return e.reshape(x.shape[0], n)


def fourstep_inverse_scaled(x: torch.Tensor, n: int,
                            extra_scale_r: bool = True) -> torch.Tensor:
    """Inverse of fourstep_forward, scaled by n^-1 (·R optionally)
    (``ntt.py:695-718``).  Two launches on the card."""
    a = fourstep_tail(fourstep_head(x, n, True), n, True, extra_scale_r)
    return a.reshape(x.shape[0], n)


def shoup_forward(x: torch.Tensor, n: int) -> torch.Tensor:
    """The flat forward DIF of int32 [R, n] (``ntt.py:368-386``): one
    phase of length n over one lane."""
    return phase_transform(x.reshape(x.shape[0], n, 1), n,
                           False).reshape(x.shape[0], n)


def shoup_inverse_scaled(x: torch.Tensor, n: int,
                         extra_scale_r: bool = True) -> torch.Tensor:
    """The flat inverse DIT, scaled by n^-1 (·R optionally)
    (``ntt.py:389-419``): K8 with the scale epilogue on the card."""
    y = x.reshape(x.shape[0], n, 1)
    _check_phase(y, n)
    if y.device.type == "cuda":
        return phase_kernel(y, n, True, scale=_mont_words(
            scale_consts(n, extra_scale_r))).reshape(x.shape[0], n)
    y = phase_transform_plain(y, n, True)
    return _scale(y.reshape(x.shape[0], n), n, extra_scale_r)


# -------------------------------------- Montgomery-domain batched transforms
# The reference's plan-based transforms (``ntt.py:53-314``, XLA there),
# which the debug checksum tool runs: plain torch on the tensors' device.
# A butterfly's Montgomery product with a twiddle in Montgomery form is
# the exact product with the plain twiddle, so the plain phase code
# computes them.


@dataclass(frozen=True)
class NTTPlan:
    n: int
    stages: int


def make_plan(n: int) -> NTTPlan:
    _check_pow2(n, 2, 1 << MAX_LOG2N, "transform size")
    return NTTPlan(n=n, stages=n.bit_length() - 1)


def batched_forward(x: torch.Tensor, plan: NTTPlan) -> torch.Tensor:
    """DIF over int32 [R, n] (Montgomery domain), bit-reversed out."""
    return phase_transform_plain(x.reshape(x.shape[0], plan.n, 1), plan.n,
                                 False).reshape(x.shape)


def batched_inverse(x: torch.Tensor, plan: NTTPlan) -> torch.Tensor:
    """DIT over int32 [R, n], natural out, scaled by n^-1."""
    y = phase_transform_plain(x.reshape(x.shape[0], plan.n, 1), plan.n,
                              True).reshape(x.shape)
    return _scale(y, plan.n, False)


def batched_to_mont(x: torch.Tensor, rows: int) -> torch.Tensor:
    """x·R mod p per row (canonical inputs)."""
    return mul_rows(x, _per_row([_R % p for p in _PS], x))


def batched_from_mont(x: torch.Tensor, rows: int) -> torch.Tensor:
    """x·R^-1 mod p per row."""
    return mont_mul_rows(x, torch.ones_like(x))
