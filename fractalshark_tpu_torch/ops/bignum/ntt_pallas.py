"""The whole bignum multiply and its CRT + carry tail as kernels: the port
of ``fractalshark_tpu/ops/bignum/ntt_pallas.py``'s flag-off routes,
through kernels K9 (``csrc/ntt_products.cu``) and K10
(``csrc/fused_tail.cu``).

* ``products`` (K9) computes ``_ntt_products``' function: from V values
  (int32 [V, n], each below both primes) the inverse transforms of K
  frequency-domain combinations of pointwise products, int32 [K, 2, n],
  row (k, i) the k-th combination modulo the i-th prime.  A combination
  is a tuple of (±1, ia, ib) terms summed mod p; with ``signs`` each
  value's spectrum is negated where its sign is negative,
  NTT(−a) = p − NTT(a), 0 staying 0 (``ntt_pallas.py:336-339``).  The
  reference's rows are the transforms "·R" of Montgomery pointwise
  products, an inverse scaled by n^-1·R: the R's cancel, so every row is
  the canonical residue of the exact cyclic convolution, which any exact
  mod-p order gives bit for bit.  K9 has two launch forms of the same
  device functions: ``whole``, one cooperative launch with grid-wide
  barriers between the forward, pointwise and inverse phases (B-f1
  ``_make_kernel`` up to MAX_NFFT and B-f3 ``_whole_aligned_kernel``
  beyond), and ``split``, three launches (B-f2, the split trio).
* ``fused_tail`` (K10) computes the reference's ``fused_tail``: per
  component the CRT of its residue rows read as signed above p1·p2/2,
  doubled and/or negated by its config, its 16-bit parts summed at digit
  positions k..k+3 (those at L or beyond dropped), ±c and the round
  plane added, the carries resolved exactly, then sign-magnitude:
  magnitude (P − N) mod 2^(16L), sign −1 iff P < N and the magnitude is
  non-zero; with ``shadow_fd`` = (F, D) also the top-digit window of the
  value slice [F, F+D) (``ntt_pallas.py:1178-1222``).  The reference has
  two forms, gridded (B8c's on residue rows, the route when
  ``BATCHED_TAIL`` is off) and batched (B-f4 ``_tail_batched_kernel``);
  the port runs both flags through one kernel pair over the whole card
  (tiles of 1,024 digits, every component in one launch, the carries
  across tiles by decoupled look-back, then a finishing launch), whose
  launches are counted under the flag's route.  ``tail_tiled_plain`` is
  its schedule in torch.

The plain twins compute both functions in torch int64 on the tensors'
device; a wrapper takes its twin only for CPU tensors and launches its
kernel, or raises, for CUDA tensors.  Residues and digits are int32
tensors here (read as uint32 by the kernels), as in ``fixedpoint``.

Routing follows the reference: ``products`` takes the whole form when
``WHOLE_ALIGNED`` is on and ``supported_whole``, the split form when
``supported_split``, else the whole form (``_products``, :401-413).
"""

from __future__ import annotations

import numpy as np
import torch

from fractalshark_tpu_torch import kernels
from fractalshark_tpu_torch.ops.bignum import fixedpoint as FP
from fractalshark_tpu_torch.ops.bignum import ntt as N

LANES = 128
MIN_NFFT = 2048
MAX_NFFT = 16384
SPLIT_MAX_NFFT = 131072

# the reference's flag-off routes (``ntt_pallas.py:757,1299``)
WHOLE_ALIGNED: bool = False
BATCHED_TAIL: bool = False

# K9's limits: at most 4 values, 8 combinations of at most 2 terms
MAX_VALUES, MAX_COMBOS, MAX_TERMS = 4, 8, 2

_P1P2 = N.P1 * N.P2


def supported(nfft: int) -> bool:
    return MIN_NFFT <= nfft <= MAX_NFFT


def supported_split(nfft: int) -> bool:
    return MAX_NFFT < nfft <= SPLIT_MAX_NFFT and nfft % LANES == 0


def supported_whole(nfft: int) -> bool:
    return MAX_NFFT < nfft <= SPLIT_MAX_NFFT and nfft % LANES == 0


def _pairs(*idx):
    return tuple(((1, i, j),) for (i, j) in idx)


PLAN_3WAY = _pairs((0, 0), (1, 1), (0, 1))
PLAN_NR = _pairs((0, 0), (1, 1), (0, 1), (0, 2), (0, 3), (1, 2), (1, 3))
PLAN_ITER = (((1, 0, 0), (-1, 1, 1)),        # x² − y²
             ((1, 0, 1),))                   # x·y
PLAN_NR_ITER = (((1, 0, 0), (-1, 1, 1)),     # x² − y²
                ((1, 0, 1),),                # x·y
                ((1, 0, 2), (-1, 1, 3)),     # x·dx − y·dy
                ((1, 0, 3), (1, 1, 2)))      # x·dy + y·dx


def product_form(n: int) -> str:
    """K9's launch form for size n, by the reference's routing."""
    if WHOLE_ALIGNED and supported_whole(n):
        return "whole"
    if supported_split(n):
        return "split"
    return "whole"


def _check_plan(pair_plan, n_values: int) -> None:
    if not 0 < len(pair_plan) <= MAX_COMBOS:
        raise ValueError(f"K9 takes 1 to {MAX_COMBOS} combinations")
    for terms in pair_plan:
        if not 0 < len(terms) <= MAX_TERMS or terms[0][0] <= 0:
            raise ValueError(f"a combination is 1 to {MAX_TERMS} terms, "
                             f"the first one +: {terms}")
        for sgn, ia, ib in terms:
            if sgn not in (1, -1) or not (0 <= ia < n_values and
                                          0 <= ib < n_values):
                raise ValueError(f"bad term {(sgn, ia, ib)}")


def plan_words(pair_plan) -> np.ndarray:
    """K9's plan operand, int32 [1 + 7·MAX_COMBOS]: K, then per
    combination its term count and (sign, ia, ib) per term."""
    w = np.zeros(1 + MAX_COMBOS * (1 + 3 * MAX_TERMS), np.int32)
    w[0] = len(pair_plan)
    for k, terms in enumerate(pair_plan):
        base = 1 + k * (1 + 3 * MAX_TERMS)
        w[base] = len(terms)
        for t, term in enumerate(terms):
            w[base + 1 + 3 * t:base + 4 + 3 * t] = term
    return w


# ------------------------------------------------------------ plain twins


def products_plain(x: torch.Tensor, signs, n: int,
                   pair_plan) -> torch.Tensor:
    """K9's function on x's device: int32 [K, 2, n]."""
    plan = FP._plan(n, x.device)
    p = plan["p"].view(2, 1, 1)
    a = x.to(torch.int64).unsqueeze(0) % p                     # [2, V, n]
    f = FP._dif(a, plan)
    if signs is not None:
        neg = (torch.as_tensor(signs, device=x.device) < 0).view(1, -1, 1)
        f = torch.where(neg, (p - f) % p, f)
    pp = p.view(2, 1)
    rows = []
    for terms in pair_plan:
        acc = torch.zeros_like(f[:, 0])
        for sgn, ia, ib in terms:
            acc = (acc + sgn * (f[:, ia] * f[:, ib] % pp)) % pp
        rows.append(acc)
    inv = FP._dit(torch.stack(rows, dim=1), plan) * plan["ninv"] % p
    return inv.transpose(0, 1).to(torch.int32).contiguous()


_MASK32 = (1 << 32) - 1


def _shoup(x: torch.Tensor, w: torch.Tensor, wp: torch.Tensor,
           p: int) -> torch.Tensor:
    """x·w mod p as the kernels' Shoup product (int64, x < 2^32, w < p):
    r = x·w − ⌊x·wp / 2^32⌋·p, which lies in [0, 2p), then r − p where
    r ≥ p; the quotient from wp's 16-bit halves, as ``__umulhi`` gives
    it, without an int64 overflow."""
    q = (x * (wp >> 16) + ((x * (wp & 0xFFFF)) >> 16)) >> 16
    r = (x * w - q * p) & _MASK32
    return torch.where(r >= p, r - p, r)


def _mont(a: torch.Tensor, b: torch.Tensor, p: int) -> torch.Tensor:
    """a·b·R^-1 mod p (a Montgomery product's canonical value)."""
    return a * b % p * pow(1 << 32, -1, p) % p


def _rounds(a: torch.Tensor, table: torch.Tensor, p: int,
            inverse: bool) -> torch.Tensor:
    """A length-m transform along a's last axis (int64, canonical) with
    K8's per-stage Shoup table (int64 [m, 2]: the stage of half-span h at
    [h − 1, 2h − 1)): forward DIF, the top bit's stage first; inverse DIT,
    the bottom bit's first.  A radix-8 register round is three of these
    stages in the same order, so the words are the kernels'."""
    m = a.shape[-1]
    lg = m.bit_length() - 1
    lead = a.shape[:-1]
    for b in (range(lg) if inverse else reversed(range(lg))):
        h = 1 << b
        y = a.reshape(*lead, m // (2 * h), 2, h)
        x0, x1 = y[..., 0, :], y[..., 1, :]
        w, wp = table[h - 1:2 * h - 1, 0], table[h - 1:2 * h - 1, 1]
        if inverse:
            u = _shoup(x1, w, wp, p)
            s, d = (x0 + u) % p, (x0 - u) % p
        else:
            s, d = (x0 + x1) % p, _shoup(x0 + p - x1, w, wp, p)
        a = torch.stack([s, d], dim=-2).reshape(*lead, m)
    return a


def k9_parts(n: int, device) -> dict:
    """``ntt.k9_tables(n)`` cut into its parts, int64 on ``device``."""
    n1, n2 = N.split_n(n)
    t = torch.from_numpy(N.k9_tables(n).view(np.uint32).astype(np.int64))
    out, off = {"scale": t[:2]}, 4
    for name, m in (("col_f", n1), ("col_i", n1), ("row_f", n2),
                    ("row_i", n2)):
        out[name] = t[off:off + 4 * m].view(2, m, 2)
        off += 4 * m
    for name in ("mat_f", "mat_i"):
        out[name] = t[off:off + 2 * n].view(2, n1, n2)
        off += 2 * n
    return {k: v.to(device) for k, v in out.items()}


def products_rounds_plain(x: torch.Tensor, signs, n: int,
                          pair_plan) -> torch.Tensor:
    """K9's schedule in torch: ``products_plain``'s function through the
    kernel's steps and tables (``ntt.k9_tables``).  Per prime: each
    value's columns (length n1) by forward Shoup rounds; each row times
    the forward twiddle matrix (Montgomery), its forward rounds (length
    n2), the sign fold, the Montgomery combinations, its inverse rounds,
    times the inverse matrix; the columns' inverse rounds; the scale
    n^-1·R² (Montgomery).  int32 [K, 2, n] from x int32 [V, n]."""
    n1, n2 = N.split_n(n)
    T = k9_parts(n, x.device)
    V = x.shape[0]
    rows = []
    for pr, p in enumerate((N.P1, N.P2)):
        a = x.to(torch.int64) % p
        a = _rounds(a.view(V, n1, n2).transpose(1, 2), T["col_f"][pr], p,
                    False).transpose(1, 2)
        f = _rounds(_mont(a, T["mat_f"][pr], p), T["row_f"][pr], p, False)
        if signs is not None:
            neg = (torch.as_tensor(signs, device=x.device) < 0).view(V, 1, 1)
            f = torch.where(neg & (f != 0), p - f, f)
        combos = []
        for terms in pair_plan:
            acc = torch.zeros_like(f[0])
            for sgn, ia, ib in terms:
                acc = (acc + sgn * _mont(f[ia], f[ib], p)) % p
            combos.append(acc)
        g = _rounds(torch.stack(combos), T["row_i"][pr], p, True)
        g = _mont(g, T["mat_i"][pr], p)
        g = _rounds(g.transpose(1, 2), T["col_i"][pr], p, True)
        rows.append(_mont(g.transpose(1, 2), T["scale"][pr], p)
                    .reshape(len(pair_plan), n))
    return torch.stack(rows, dim=1).to(torch.int32)


def block_threads(n: int, n_values: int) -> int:
    """K9's block size T at size n for ``n_values`` values: halved from
    512 (not below 32) until the forward phase has two blocks an SM of the
    H100, then raised (to 256 at most) until a row block loads its rows
    and the inverse matrix's row in one batch of 8 words a thread, at
    most n/8
    (``csrc/ntt_products.cuh`` ``products_threads``; the ``cuda`` tests
    hold the two equal).  K11 takes 256, K10's block."""
    m1 = (n.bit_length() - 1) // 2
    e1 = 8 if m1 >= 3 else 1 << m1
    t = 512
    while t > 32 and (2 * n_values * n) // (t * e1) < 264:
        t //= 2
    while t < 256 and 8 * t < (n_values + 1) * (n >> m1):
        t *= 2
    return min(t, n // e1)


def tail_cfg(sgs, nr: bool) -> list:
    """The per-component config (double, gswap, csign, 0) of
    ``fused_tail`` (``ntt_pallas.py:1338-1349``) from sgs = (scx, scy,
    sx·sy, 0)."""
    s = [int(v) for v in sgs]
    if nr:
        # rows (d, xy, u, v): all spectrum-signed; xy/u/v doubled;
        # addends cx (sign scx), cy (scy), +1, none
        return [0, 1, s[0], 0, 1, 1, s[1], 0, 1, 1, 1, 0, 1, 1, 1, 0]
    # rows (d, xy): d signed, +cx; xy with global sign sx·sy, doubled, +cy
    return [0, 1, s[0], 0, 1, s[2], s[1], 0]


def signed_coefs(inv: torch.Tensor, cfg) -> torch.Tensor:
    """int64 [K, n]: each component's CRT'd coefficients, negative above
    p1·p2/2, doubled where its config says so and negated where its
    gswap is negative (the stream swap)."""
    K = inv.shape[0]
    c = torch.as_tensor(cfg, dtype=torch.int64, device=inv.device).view(K, 4)
    rec = FP._crt_rec(inv[:, 0], inv[:, 1])
    s = torch.where(rec > _P1P2 // 2, rec - _P1P2, rec)
    s = s * torch.where(c[:, 0] > 0, 2, 1).view(K, 1)
    return torch.where(c[:, 1:2] < 0, -s, s)


def part_sums(s: torch.Tensor, L: int) -> torch.Tensor:
    """int64 [K, L]: each coefficient's four 16-bit parts, signed, added
    at digit positions k..k+3 below L."""
    mag, neg = s.abs(), s < 0
    acc = torch.zeros(s.shape[0], L, dtype=torch.int64, device=s.device)
    for q in range(4):
        part = (mag >> (16 * q)) & FP.DIGIT_MASK
        acc[:, q:] += torch.where(neg, -part, part)[:, :L - q]
    return acc


def shadow5(mag: torch.Tensor, F: int, D: int) -> torch.Tensor:
    """int32 [K, 5]: the 4 digits ending at the top non-zero digit of the
    value slice [F, F+D) and their base index (0 for a zero slice)."""
    sl = mag[:, F:F + D]
    pos = torch.arange(D, device=mag.device)
    idx = torch.where(sl != 0, pos, -1).max(dim=1).values
    base = (idx - 3).clamp(0, D - 4)
    win = torch.gather(sl, 1, base.unsqueeze(1)
                       + torch.arange(4, device=mag.device))
    return torch.cat([win, base.unsqueeze(1)], 1).to(torch.int32)


def fused_tail_plain(inv: torch.Tensor, cadd: torch.Tensor, rnd: torch.Tensor,
                     cfg, shadow_fd=None):
    """K10's function: (digits int32 [K, L], signs int32 [K][, shadows
    int32 [K, 5]]) with L = cadd.shape[1] <= n."""
    K, L = cadd.shape
    c = torch.as_tensor(cfg, dtype=torch.int64, device=inv.device).view(K, 4)
    acc = part_sums(signed_coefs(inv, cfg), L)
    ca = cadd.to(torch.int64)
    acc += torch.where(c[:, 2:3] > 0, ca, -ca) + rnd.to(torch.int64)
    dig, top = FP._carry_resolve(acc)
    neg = top < 0
    mag = torch.where(neg.unsqueeze(1), FP._negate(dig), dig)
    sign = torch.where(neg & (mag != 0).any(dim=1), -1, 1).to(torch.int32)
    out = (mag.to(torch.int32), sign)
    if shadow_fd is not None:
        out += (shadow5(mag, *shadow_fd),)
    return out


_IDENTITY = (-1, 0, 1)


def _compose(g: torch.Tensor, f: torch.Tensor) -> torch.Tensor:
    """Carry maps [..., 3] (the value out for a carry of −1, 0, 1 in):
    g after f."""
    return torch.gather(g, -1, f + 1)


def _apply(f: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    return torch.gather(f, -1, (c + 1).unsqueeze(-1)).squeeze(-1)


def tail_tiled_plain(inv: torch.Tensor, cadd: torch.Tensor, rnd: torch.Tensor,
                     cfg, shadow_fd=None, zsign=None, threads: int = 256,
                     rng: np.random.Generator | None = None):
    """K10's schedule in torch: ``fused_tail_plain``'s function through the
    kernel's steps, with tiles of `threads` segments of 4 digits (the
    kernel's: 256).  Per segment the local ripple of its sums, the carry
    of the segment below absorbed (across a tile's edge too, as the
    kernel recomputes it) and its carry map; per tile the scan of its
    maps and its aggregate; the carry into each tile by decoupled
    look-back, where each earlier tile is seen with its carry-out
    published or, chosen by `rng`, only its aggregate; each segment's
    carry-in applied; the sign from the top carry; the negation from the
    lowest nonzero digit; the shadow row from the highest of the slice.
    ``zsign`` (two ints) replaces component 1's gswap, as on the card."""
    K, L = cadd.shape
    if L % 4:
        raise ValueError("the tiled tail takes L a multiple of 4")
    cfg = list(cfg)
    if zsign is not None:
        cfg[5] = int(zsign[0]) * int(zsign[1])
    c = torch.as_tensor(cfg, dtype=torch.int64, device=inv.device).view(K, 4)
    acc = part_sums(signed_coefs(inv, cfg), L)
    ca = cadd.to(torch.int64)
    acc += torch.where(c[:, 2:3] > 0, ca, -ca) + rnd.to(torch.int64)
    G = L // 4
    a = acc.view(K, G, 4)
    dig = torch.empty_like(a)
    cr = torch.zeros(K, G, dtype=torch.int64, device=a.device)
    for q in range(4):                       # each segment's own ripple
        v = a[:, :, q] + cr
        dig[:, :, q], cr = v & FP.DIGIT_MASK, v >> 16
    ci = torch.cat([torch.zeros_like(cr[:, :1]), cr[:, :-1]], 1)
    for q in range(4):                       # the carry of the one below
        v = dig[:, :, q] + ci
        dig[:, :, q], ci = v & FP.DIGIT_MASK, v >> 16
    ffff = (dig == FP.DIGIT_MASK).all(-1)
    zero = (dig == 0).all(-1)
    maps = torch.stack([ci - zero.long(), ci, ci + ffff.long()], -1)
    # the tiles' inclusive scans (identity maps past the number)
    tiles = -(-G // threads)
    ident = torch.tensor(_IDENTITY, device=a.device)
    pad = ident.expand(K, tiles * threads - G, 3)
    m = torch.cat([maps, pad], 1).view(K, tiles, threads, 3)
    incl = m.clone()
    for t in range(1, threads):
        incl[:, :, t] = _compose(m[:, :, t], incl[:, :, t - 1])
    agg = incl[:, :, -1]
    # decoupled look-back, tile by tile in ticket order
    rin = torch.zeros(K, tiles, dtype=torch.int64, device=a.device)
    out = torch.zeros(K, tiles, dtype=torch.int64, device=a.device)
    for b in range(tiles):
        for k in range(K):
            acc_map = ident
            p = b - 1
            while p >= 0:
                seen = p == 0 or rng is None or rng.random() < 0.5
                if seen:                      # p's carry-out is published
                    rin[k, b] = _apply(acc_map, out[k, p])
                    break
                acc_map = _compose(acc_map, agg[k, p])
                p -= 1
        out[:, b] = _apply(agg[:, b], rin[:, b])
    excl = torch.cat([ident.expand(K, tiles, 1, 3), incl[:, :, :-1]], 2)
    cin = _apply(excl, rin.unsqueeze(2).expand(K, tiles, threads))
    cin = cin.reshape(K, -1)[:, :G]
    top = cr[:, -1] + _apply(incl.reshape(K, -1, 3)[:, G - 1],
                             rin[:, (G - 1) // threads])
    for q in range(4):                        # the carry-ins, applied
        v = dig[:, :, q] + cin
        dig[:, :, q], cin = v & FP.DIGIT_MASK, v >> 16
    dig = dig.reshape(K, L)
    pos = torch.arange(L, device=a.device)
    lo = torch.where(dig != 0, pos, L).min(dim=1).values
    neg = top < 0
    negated = torch.where(pos < lo.unsqueeze(1), 0,
                          torch.where(pos == lo.unsqueeze(1), 0x10000 - dig,
                                      FP.DIGIT_MASK - dig))
    mag = torch.where(neg.unsqueeze(1), negated, dig)
    sign = torch.where(neg & (lo < L), -1, 1).to(torch.int32)
    res = (mag.to(torch.int32), sign)
    if shadow_fd is not None:
        res += (shadow5(mag, *shadow_fd),)
    return res


# --------------------------------------------------------------- wrappers


def _values(x: torch.Tensor, n: int, n_values: int) -> None:
    if x.dim() != 2 or x.shape[0] != n_values or x.shape[1] > n or \
            x.dtype != torch.int32:
        raise ValueError(f"K9 takes int32 [{n_values}, <= {n}] values, not "
                         f"{x.dtype}{tuple(x.shape)}")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {x.device}")


def _check_n(n: int) -> None:
    if n & (n - 1) or not 4 <= n <= SPLIT_MAX_NFFT:
        raise ValueError(f"K9 takes a power-of-two size up to "
                         f"{SPLIT_MAX_NFFT}, not {n}")


_PLAN_WORDS: dict = {}


def _plan_words_cached(pair_plan) -> np.ndarray:
    """``plan_words`` made once per plan: the C entry reads them on the
    host at every call."""
    if pair_plan not in _PLAN_WORDS:
        _PLAN_WORDS[pair_plan] = plan_words(pair_plan)
    return _PLAN_WORDS[pair_plan]


def launch_products(vals, din: int, signs, n: int, pair_plan,
                    form: str) -> torch.Tensor:
    """Launch K9 once on CUDA tensors: ``vals`` up to 4 int32 vectors
    whose first ``din`` entries are the values (zero beyond);
    returns int32 [K, 2, n].  The work (2(V + K)·n words) is the device's
    cached scratch (``kernels.scratch``), the tables are made once per
    size (``fixedpoint.k9_tables``): a call allocates only its output."""
    dev = vals[0].device
    K, V = len(pair_plan), len(vals)
    out = torch.empty(K, 2, n, dtype=torch.int32, device=dev)
    work = kernels.scratch(dev, 2 * (V + K) * n)
    ptrs = [v.data_ptr() for v in vals] + [0] * (MAX_VALUES - V)
    words = _plan_words_cached(pair_plan)
    rc = kernels.lib().fs_ntt_products(
        *ptrs, V, din, 0 if signs is None else signs.data_ptr(),
        words.ctypes.data, out.data_ptr(), work.data_ptr(),
        FP.k9_tables(n, dev).data_ptr(), n.bit_length() - 1,
        int(form == "whole"), kernels.stream(dev))
    kernels.check(rc, f"ntt_products_{form}")
    kernels.launches[f"ntt_products_{form}"] += 1
    return out


def products(x: torch.Tensor, signs, n: int, pair_plan) -> torch.Tensor:
    """int32 [K, 2, n]: the combinations of ``pair_plan`` of the values x
    (int32 [V, <= n], zero-padded to n), K9 on CUDA in the form the
    reference routes n to, the plain twin on the CPU.  ``signs``: None or
    int32 [V] on x's device."""
    _check_n(n)
    _values(x, n, x.shape[0])
    _check_plan(pair_plan, x.shape[0])
    if signs is not None and (signs.shape != (x.shape[0],) or
                              signs.dtype != torch.int32 or
                              signs.device != x.device):
        raise ValueError("signs must be int32 [V] on the values' device")
    if x.device.type == "cpu":
        xp = torch.zeros(x.shape[0], n, dtype=torch.int32)
        xp[:, :x.shape[1]] = x
        return products_plain(xp, signs, n, pair_plan)
    x = x.contiguous()
    return launch_products(list(x), x.shape[1],
                           None if signs is None else signs.contiguous(), n,
                           pair_plan, product_form(n))


def ntt3way_products(vx, vy, nfft: int) -> torch.Tensor:
    """(xx, yy, xy) rows [6, nfft], rows 2k, 2k+1 = product k mod p1, p2."""
    return products(torch.stack([vx, vy]), None, nfft,
                    PLAN_3WAY).reshape(6, nfft)


def nttnr_products(vx, vy, vdx, vdy, nfft: int) -> torch.Tensor:
    """(xx, yy, xy, xdx, xdy, ydx, ydy) rows [14, nfft]."""
    return products(torch.stack([vx, vy, vdx, vdy]), None, nfft,
                    PLAN_NR).reshape(14, nfft)


def ntt_iter_products(vx, vy, nfft: int) -> torch.Tensor:
    """[4, nfft]: rows (x² − y²) mod p1, p2 (signed residues), x·y."""
    return products(torch.stack([vx, vy]), None, nfft,
                    PLAN_ITER).reshape(4, nfft)


def ntt_nr_iter_products(vx, vy, vdx, vdy, signs, nfft: int) -> torch.Tensor:
    """[8, nfft]: signed-residue rows of d = x² − y², xy, u = x·dx − y·dy,
    v = x·dy + y·dx; signs = int32 [4] (sx, sy, sdx, sdy)."""
    return products(torch.stack([vx, vy, vdx, vdy]), signs, nfft,
                    PLAN_NR_ITER).reshape(8, nfft)


def _check_tail(inv, cadd, rnd, cfg, shadow_fd) -> None:
    K, L = cadd.shape
    n = inv.shape[-1]
    if inv.shape != (K, 2, n) or rnd.shape != (L,) or len(cfg) != 4 * K:
        raise ValueError("fused_tail: inv [K, 2, n], cadd [K, L], rnd [L] "
                         "and cfg [4K]")
    if not 1 <= K <= 4 or L > n or L % 4 or n & (n - 1):
        raise ValueError(f"fused_tail takes 1 to 4 components and L <= n "
                         f"digits, L a multiple of 4, not K={K}, L={L}, "
                         f"n={n}")
    for t in (inv, cadd, rnd):
        if t.dtype != torch.int32 or t.device != inv.device:
            raise ValueError("fused_tail's planes are int32 on one device")
    if shadow_fd is not None:
        F, D = shadow_fd
        if not (D >= 4 and 0 <= F and F + D <= L):
            raise ValueError(f"shadow slice {shadow_fd} outside {L} digits")


def launch_tail(inv, cadd, rnd, cfg, shadow_fd, batched: bool, zsign=None):
    """Launch K10 once on CUDA tensors (one C call, its two launches over
    the whole card), counted under the flag's route (``batched``: B-f4's,
    else B8c's on residue rows; both run the same kernels); ``zsign``
    (int32 [2] on the card, optional) replaces component 1's gswap by
    zsign[0]·zsign[1]."""
    dev = inv.device
    K, L = cadd.shape
    dig = torch.empty(K, L, dtype=torch.int32, device=dev)
    sgn = torch.empty(K, dtype=torch.int32, device=dev)
    shw = None if shadow_fd is None else torch.empty(K, 5, dtype=torch.int32,
                                                     device=dev)
    F, D = shadow_fd if shadow_fd is not None else (0, 0)
    words = np.asarray(cfg, np.int32)
    form = "batched" if batched else "grid"
    rc = kernels.lib().fs_fused_tail(
        inv.data_ptr(), cadd.data_ptr(), rnd.data_ptr(), words.ctypes.data,
        0 if zsign is None else zsign.data_ptr(), dig.data_ptr(),
        sgn.data_ptr(), 0 if shw is None else shw.data_ptr(),
        kernels.tail_state(dev).data_ptr(), K,
        inv.shape[-1].bit_length() - 1, L, F, D, kernels.stream(dev))
    kernels.check(rc, f"fused_tail_{form}")
    kernels.launches[f"fused_tail_{form}"] += 1
    return (dig, sgn) if shw is None else (dig, sgn, shw)


def tail(inv, cadd, rnd, cfg, shadow_fd=None, zsign=None):
    """K10 on CUDA tensors (counted as batched under ``BATCHED_TAIL``,
    else as gridded), its plain twin on CPU tensors."""
    _check_tail(inv, cadd, rnd, cfg, shadow_fd)
    if inv.device.type == "cpu":
        if zsign is not None:
            cfg = list(cfg)
            cfg[5] = int(zsign[0]) * int(zsign[1])
        return fused_tail_plain(inv, cadd, rnd, cfg, shadow_fd)
    return launch_tail(inv.contiguous(), cadd.contiguous(), rnd.contiguous(),
                       cfg, shadow_fd, BATCHED_TAIL, zsign)


def fused_tail(inv, cadd, rnd, sgs, n: int, nr: bool = False,
               shadow_fd=None):
    """The reference's ``fused_tail`` (``ntt_pallas.py:1326-1393``): inv
    int32 [K, 2, n] (K = 2, or 4 with ``nr``), cadd int32 [K, n], rnd
    int32 [n], sgs = (scx, scy, sx·sy, 0).  Returns (digits int32 [K, n],
    signs int32 [K]) and, with shadow_fd = (F, D), the shadows int32
    [K, 5]."""
    K = 4 if nr else 2
    if inv.shape != (K, 2, n):
        raise ValueError(f"fused_tail: inv must be [{K}, 2, {n}]")
    return tail(inv, cadd, rnd, tail_cfg(sgs, nr), shadow_fd)
