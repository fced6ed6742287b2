"""The number-theoretic transform's constants and tables: the two 31-bit
primes of ``fractalshark_tpu/ops/bignum/ntt.py:35-38`` and their
root-of-unity tables, shared by the CUDA product kernel K4
(``csrc/ntt_orbit.cu``) and its plain twin (``fixedpoint.py``).

Why two 31-bit primes and not one 64-bit prime: the plain twin runs in
torch int64, where a product of two residues below 2^31 is exact; a
64-bit prime would need 128-bit products.  Their CRT capacity
p1·p2 ≈ 2^61.7 holds every coefficient of the orbit step's products
(|c| ≤ 2·D·(2^16 − 1)² < 2^49 at D = 2^16 digits) with room for the
sign.

Tables are numpy, built once per transform size and cached; the kernel
gets them in Montgomery form (R = 2^32), the twin in plain form.
"""

from __future__ import annotations

import functools

import numpy as np

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
