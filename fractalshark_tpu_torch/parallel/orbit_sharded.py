"""One z ← z² + c update with the digits of one bignum sharded over a
mesh: the port of ``fractalshark_tpu/parallel/orbit_sharded.py``.

``iterate_z_sharded`` is ``fixedpoint.iterate_z``'s function, bit for
bit, on every rank:

* transforms: the limb-sharded four-step of ``ntt_sharded`` (K8 on each
  rank, one ``all_to_all`` a direction); the frequency combines x² − y²
  and x·y (``:227-235``) are elementwise on each rank;
* reshard: one more ``all_to_all`` gives rank r the residue rows of its
  contiguous digit block [r·L/M, (r+1)·L/M) (L = nfft = 2D, the flat
  layout, ``:182``) and the 8 coefficients below it, from the ranks
  whose columns hold them (rank M − 1 alone while a rank has 8 columns
  or more, else the last ⌈8/(n2/M)⌉; a digit's sum takes parts of the 3
  coefficients below, and the segment below the block is rippled from
  7: the JAX package's ``_from_prev`` halo, ``:62-68``);
* the tail: kernel K20 (``csrc/sharded_tail.cu``) in two launches with
  one ``all_gather`` of a few words a rank between them (``tail_a``,
  ``tail_b``; their plain twins on CPU tensors);
* one ``all_gather`` of the digit blocks: the next step's columns span
  every block, and the state is replicated as the one-device session's
  is, so its shadow rows (``fixedpoint.shadow_rows``) are read on each
  rank with no further collective.

``orbit_chunk_sharded`` is ``orbit.orbit_chunk`` over a mesh (the
sharded session's chunk).
"""

from __future__ import annotations

import numpy as np
import torch

from fractalshark_tpu_torch import kernels
from fractalshark_tpu_torch.ops.bignum import fixedpoint as FP
from fractalshark_tpu_torch.ops.bignum import ntt as N
from fractalshark_tpu_torch.ops.bignum import ntt_pallas as NP
from fractalshark_tpu_torch.parallel import mesh as PM
from fractalshark_tpu_torch.parallel import ntt_sharded as NS
from fractalshark_tpu_torch.parallel.mesh import Mesh
from fractalshark_tpu_torch.parallel.ntt_sharded import make_limb_mesh

__all__ = ["iterate_z_sharded", "make_limb_mesh", "orbit_chunk_sharded"]

HALO = 8          # coefficients and plane words below a rank's block
SEG = 4           # digits a K20 thread
TILE_SEGS = 256   # segments a K20 block (1,024 digits)
MASK = FP.DIGIT_MASK


# --------------------------------------------------- K20's (f, z) words
# A segment's word: its carry map f (2 bits a carry-in −1, 0, 1: the
# carry-out + 1) in bits 0-5 and, in bits 6-8, for each carry-in whether
# its final digits are all zero (csrc/sharded_tail.cu).


def _decode(w: torch.Tensor):
    """(f int64 [..., 3] in {-1, 0, 1}, z bool [..., 3]) of words."""
    w = w.to(torch.int64)
    sh = torch.arange(3, device=w.device)
    f = ((w.unsqueeze(-1) >> (2 * sh)) & 3) - 1
    z = ((w.unsqueeze(-1) >> (6 + sh)) & 1).bool()
    return f, z


def _encode(f: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    sh = torch.arange(3, device=f.device)
    return (((f + 1) << (2 * sh)).sum(-1) + (z.long() << (6 + sh)).sum(-1)
            ).to(torch.int32)


def _compose(fu, zu, fl, zl):
    """(f, z) of u after l."""
    return torch.gather(fu, -1, fl + 1), zl & torch.gather(zu, -1, fl + 1)


def _identity(shape, device):
    f = torch.tensor([-1, 0, 1], device=device).expand(*shape, 3)
    return f.clone(), torch.ones(*shape, 3, dtype=torch.bool, device=device)


def _fold(f, z):
    """The composition along dim -2 (lower first) of a power-of-two count
    of pairs, in a tree."""
    while f.shape[-2] > 1:
        f, z = _compose(f[..., 1::2, :], z[..., 1::2, :],
                        f[..., 0::2, :], z[..., 0::2, :])
    return f[..., 0, :], z[..., 0, :]


def _scan(f, z):
    """Inclusive scan along dim -2 (Hillis-Steele), lower first."""
    k, S = 1, f.shape[-2]
    while k < S:
        nf, nz = _compose(f[..., k:, :], z[..., k:, :], f[..., :-k, :],
                          z[..., :-k, :])
        f = torch.cat([f[..., :k, :], nf], -2)
        z = torch.cat([z[..., :k, :], nz], -2)
        k <<= 1
    return f, z


def tiles_of(lloc: int) -> int:
    return -(-lloc // (SEG * TILE_SEGS))


# --------------------------------------------------------- K20's twins


def _cfg(cfg, zsign) -> list:
    cfg = [int(v) for v in cfg]
    if zsign is not None:
        cfg[5] = int(zsign[0]) * int(zsign[1])
    return cfg


def tail_a_plain(inv: torch.Tensor, cadd: torch.Tensor, rnd: torch.Tensor,
                 cfg, zsign=None):
    """Launch A's function on one rank's block: inv int32 [K, 2, 8 + Lloc]
    (residue rows, the halo of 8 coefficients first), cadd int32 [K, 8 +
    Lloc], rnd int32 [8 + Lloc].  Returns (digits int32 [K, Lloc], each
    segment's carry absorbed from the one below; segment words int32 [K,
    Lloc/4]; words int32 [K, T + 1]: each 1,024-digit tile's composed
    word, then the raw carry-out of the block's top segment)."""
    K, _, W = inv.shape
    lloc = W - HALO
    cfg = _cfg(cfg, zsign)
    c = torch.as_tensor(cfg, dtype=torch.int64, device=inv.device).view(K, 4)
    acc = NP.part_sums(NP.signed_coefs(inv, cfg), W)
    ca = cadd.to(torch.int64)
    acc += torch.where(c[:, 2:3] > 0, ca, -ca) + rnd.to(torch.int64)
    G = lloc // SEG
    a = acc[:, HALO - SEG:].reshape(K, G + 1, SEG)   # the segment below first
    dig = torch.empty_like(a)
    cr = torch.zeros(K, G + 1, dtype=torch.int64, device=a.device)
    for q in range(SEG):                       # each segment's own ripple
        v = a[:, :, q] + cr
        dig[:, :, q], cr = v & MASK, v >> 16
    dig, ci = dig[:, 1:].clone(), cr[:, :-1].clone()
    for q in range(SEG):                       # the carry of the one below
        v = dig[:, :, q] + ci
        dig[:, :, q], ci = v & MASK, v >> 16
    ffff = (dig == MASK).all(-1)
    hi0 = (dig[:, :, 1:] == 0).all(-1)
    zero = hi0 & (dig[:, :, 0] == 0)
    f = torch.stack([ci - zero.long(), ci, ci + ffff.long()], -1)
    z = torch.stack([hi0 & (dig[:, :, 0] == 1), zero, ffff], -1)
    T = tiles_of(lloc)
    fi, zi = _identity((K, T * TILE_SEGS - G), a.device)
    tf, tz = _fold(torch.cat([f, fi], 1).view(K, T, TILE_SEGS, 3),
                   torch.cat([z, zi], 1).view(K, T, TILE_SEGS, 3))
    words = torch.cat([_encode(tf, tz), cr[:, -1:].to(torch.int32)], 1)
    return dig.reshape(K, lloc).to(torch.int32), _encode(f, z), words


def tail_b_plain(dig: torch.Tensor, fz: torch.Tensor, words: torch.Tensor,
                 rank: int):
    """Launch B's function: launch A's digits and segment words of rank
    ``rank``'s block, every rank's launch-A words int32 [M, K, T + 1] in
    rank order.  Returns (final digits int32 [K, Lloc], signs int32 [K])."""
    K, lloc = dig.shape
    M, _, T1 = words.shape
    T, G = T1 - 1, lloc // SEG
    dev = dig.device
    tf, tz = _decode(words[:, :, :T].permute(1, 0, 2).reshape(K, M * T))
    ef, ez = _identity((K,), dev)              # below tile g
    pre_f, pre_z = [], []
    for g in range(M * T):
        pre_f.append(ef)
        pre_z.append(ez)
        ef, ez = _compose(tf[:, g], tz[:, g], ef, ez)
    top = words[M - 1, :, T].to(torch.int64)
    neg = top + ef[:, 1] < 0
    sign = torch.where(neg & ~ez[:, 1], -1, 1).to(torch.int32)
    bf = torch.stack(pre_f[rank * T:(rank + 1) * T], 1)       # [K, T, 3]
    bz = torch.stack(pre_z[rank * T:(rank + 1) * T], 1)
    sf, sz = _decode(fz)
    fi, zi = _identity((K, T * TILE_SEGS - G), dev)
    sf = torch.cat([sf, fi], 1).view(K, T, TILE_SEGS, 3)
    sz = torch.cat([sz, zi], 1).view(K, T, TILE_SEGS, 3)
    inf, inz = _scan(sf, sz)
    xf, xz = _identity((K, T, 1), dev)
    xf = torch.cat([xf, inf[:, :, :-1]], 2)   # exclusive within the tile
    xz = torch.cat([xz, inz[:, :, :-1]], 2)
    pf, pz = _compose(xf, xz, bf.unsqueeze(2).expand_as(xf),
                      bz.unsqueeze(2).expand_as(xz))
    cin = pf[..., 1].reshape(K, -1)[:, :G]
    zb = pz[..., 1].reshape(K, -1)[:, :G]
    d = dig.to(torch.int64).view(K, G, SEG).clone()
    for q in range(SEG):
        v = d[:, :, q] + cin
        d[:, :, q], cin = v & MASK, v >> 16
        nd = torch.where(zb, torch.where(d[:, :, q] == 0, 0,
                                         0x10000 - d[:, :, q]),
                         MASK - d[:, :, q])
        zb = zb & (d[:, :, q] == 0)
        d[:, :, q] = torch.where(neg.view(K, 1), nd, d[:, :, q])
    return d.reshape(K, lloc).to(torch.int32), sign


# ----------------------------------------------------------- K20 wrappers


def _check_a(inv, cadd, rnd, cfg, zsign):
    K, _, W = inv.shape
    lloc = W - HALO
    if inv.shape != (K, 2, W) or cadd.shape != (K, W) or rnd.shape != (W,) \
            or len(cfg) != 4 * K:
        raise ValueError("K20: inv [K, 2, 8 + Lloc], cadd [K, 8 + Lloc], "
                         "rnd [8 + Lloc] and cfg [4K]")
    if not 1 <= K <= 4 or lloc < SEG or lloc % SEG or lloc > 1 << 17:
        raise ValueError(f"K20 takes 1 to 4 components and a block of a "
                         f"multiple of 4 digits up to 2^17, not K={K}, "
                         f"Lloc={lloc}")
    for t in (inv, cadd, rnd):
        if t.dtype != torch.int32 or t.device != inv.device:
            raise ValueError("K20's planes are int32 on one device")
    if inv.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {inv.device}")
    if zsign is not None and (zsign.shape != (2,) or
                              zsign.dtype != torch.int32 or
                              zsign.device != inv.device):
        raise ValueError("zsign must be int32 [2] on the planes' device")


def tail_a(inv, cadd, rnd, cfg, zsign=None):
    """Launch A (``tail_a_plain``): K20 on CUDA tensors, the twin on CPU
    tensors.  ``zsign`` (int32 [2], optional) replaces component 1's
    gswap by zsign[0]·zsign[1], read on the card."""
    _check_a(inv, cadd, rnd, cfg, zsign)
    if inv.device.type == "cpu":
        return tail_a_plain(inv, cadd, rnd, cfg, zsign)
    K, _, W = inv.shape
    lloc = W - HALO
    dev = inv.device
    inv, cadd, rnd = inv.contiguous(), cadd.contiguous(), rnd.contiguous()
    dig = torch.empty(K, lloc, dtype=torch.int32, device=dev)
    fz = torch.empty(K, lloc // SEG, dtype=torch.int32, device=dev)
    words = torch.empty(K, tiles_of(lloc) + 1, dtype=torch.int32, device=dev)
    cw = np.asarray(cfg, np.int32)
    rc = kernels.lib().fs_sharded_tail_a(
        inv.data_ptr(), cadd.data_ptr(), rnd.data_ptr(), cw.ctypes.data,
        None if zsign is None else zsign.data_ptr(), dig.data_ptr(),
        fz.data_ptr(), words.data_ptr(), K, lloc, kernels.stream(dev))
    kernels.check(rc, "sharded_tail")
    kernels.launches["sharded_tail"] += 1
    return dig, fz, words


def tail_b(dig, fz, words, rank: int):
    """Launch B (``tail_b_plain``): K20 on CUDA tensors, the twin on CPU
    tensors."""
    K, lloc = dig.shape
    M = words.shape[0]
    if fz.shape != (K, lloc // SEG) or \
            words.shape != (M, K, tiles_of(lloc) + 1) or \
            not 0 <= rank < M:
        raise ValueError("K20 launch B: digits [K, Lloc], segment words "
                         "[K, Lloc/4], words [M, K, T + 1], rank in [0, M)")
    for t in (dig, fz, words):
        if t.dtype != torch.int32 or t.device != dig.device:
            raise ValueError("K20's words are int32 on one device")
    if dig.device.type == "cpu":
        return tail_b_plain(dig, fz, words, rank)
    dig = dig.contiguous().clone()
    sgn = torch.empty(K, dtype=torch.int32, device=dig.device)
    rc = kernels.lib().fs_sharded_tail_b(
        dig.data_ptr(), fz.contiguous().data_ptr(),
        words.contiguous().data_ptr(), sgn.data_ptr(), K, lloc, M, rank,
        kernels.stream(dig.device))
    kernels.check(rc, "sharded_tail")
    kernels.launches["sharded_tail"] += 1
    return dig, sgn


def sharded_tail(inv, cadd, rnd, cfg, mesh: Mesh, zsign=None):
    """The rank's block of the tail: (digits int32 [K, Lloc], signs int32
    [K], the same on every rank): launch A, one all_gather of the words,
    launch B."""
    dig, fz, words = tail_a(inv, cadd, rnd, cfg, zsign)
    return tail_b(dig, fz, PM.all_gather(mesh, words), mesh.rank)


# ------------------------------------------------------------ the step


def check_spec(spec: FP.FixedSpec, mesh: Mesh) -> tuple[int, int]:
    """(n1, n2) of the step's transforms; ValueError, before any launch,
    for a spec or mesh the sharded step does not take: every mesh that
    ``ntt_sharded.split`` takes, with the flat digit layout."""
    nf = spec.nfft
    if 2 * spec.digits != nf:
        raise ValueError(f"{spec}: the sharded tail needs the flat digit "
                         f"layout 2·D == nfft (FixedSpec.for_limbs of a "
                         f"power of two)")
    return NS.split(nf, mesh)


def local_planes(cx: torch.Tensor, cy: torch.Tensor, spec: FP.FixedSpec,
                 mesh: Mesh):
    """The rank's addend planes with their halo: (cadd int32 [2, 8 +
    Lloc], rnd int32 [8 + Lloc]), global digits [B − 8, B + Lloc)."""
    cadd, rnd = FP.addend_planes(cx, cy, spec)
    lloc = spec.nfft // mesh.size
    lo = mesh.rank * lloc
    pad = torch.nn.functional.pad
    return (pad(cadd, (HALO, 0))[:, lo:lo + HALO + lloc].contiguous(),
            pad(rnd, (HALO, 0))[lo:lo + HALO + lloc].contiguous())


def halo_owners(n1: int, n2: int, M: int) -> np.ndarray:
    """int64 [M, 3, HALO]: for each rank s's halo, the coefficients at
    flat digits s·Lloc − 8 .. s·Lloc − 1 (Lloc = n1·n2/M): the rank whose
    columns hold each and its (row, local column) there.  Rank 0's halo
    (below digit 0) is all zero; its owner is marked −1.  Column c is on
    rank c // (n2/M), so with fewer than 8 columns a rank the halo spans
    the last ⌈8/(n2/M)⌉ ranks."""
    w, lloc = n2 // M, n1 * n2 // M
    out = np.full((M, 3, HALO), -1, np.int64)
    for s in range(1, M):
        idx = s * lloc - HALO + np.arange(HALO)
        row, col = idx // n2, idx % n2
        out[s] = col // w, row, col % w
    return out


def reshard(inv: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The inverse's rank block [4, n1, n2/M] → the residue rows of the
    rank's contiguous digit block with its halo, [2, 2, 8 + Lloc]: one
    ``all_to_all`` (the JAX package's ``:246-249``) whose blocks also
    carry the 8 coefficients below each rank's block, each from the rank
    whose columns hold it (``halo_owners``)."""
    R, n1, w = inv.shape
    M, h = mesh.size, n1 // mesh.size
    own = halo_owners(n1, w * M, M)
    body = inv.view(R, M, h, w).permute(1, 0, 2, 3).reshape(M, R * h * w)
    halo = torch.zeros(M, R, HALO, dtype=inv.dtype, device=inv.device)
    s, j = np.nonzero(own[:, 0] == mesh.rank)
    if len(s):
        idx = torch.from_numpy(own[s, 1:, j]).to(inv.device)
        halo[torch.from_numpy(s).to(inv.device), :,
             torch.from_numpy(j).to(inv.device)] = \
            inv[:, idx[:, 0], idx[:, 1]].T
    recv = PM.all_to_all(mesh, torch.cat([body, halo.reshape(M, -1)], 1))
    blk = recv[:, :R * h * w].view(M, R, h, w).permute(1, 2, 0, 3)
    below = torch.zeros(R, HALO, dtype=inv.dtype, device=inv.device)
    if mesh.rank:
        src = torch.from_numpy(own[mesh.rank, 0]).to(inv.device)
        below = recv[:, R * h * w:].view(M, R, HALO)[
            src, :, torch.arange(HALO, device=inv.device)].T
    return torch.cat([below, blk.reshape(R, -1)], 1).view(2, 2, -1)


def products(x, y, spec, mesh: Mesh) -> torch.Tensor:
    """The residue rows of x² − y² and x·y over the rank's digit block
    with its halo, int32 [2, 2, 8 + Lloc], from replicated digits x, y:
    the sharded transforms, the frequency combines and the reshard."""
    nf, D = spec.nfft, spec.digits
    n1, n2 = N.split_n(nf)
    w = n2 // mesh.size
    v = torch.zeros(4, nf, dtype=torch.int32, device=x.device)
    v[0:2, :D] = x
    v[2:4, :D] = y
    a = v.view(4, n1, n2)[:, :, mesh.rank * w:(mesh.rank + 1) * w]
    f = NS.forward_local(a.contiguous(), nf, mesh)
    fx, fy = f[0:2], f[2:4]
    e = torch.cat([N.mod_sub_rows(N.mont_mul_rows(fx, fx),
                                  N.mont_mul_rows(fy, fy)),
                   N.mont_mul_rows(fx, fy)])
    return reshard(NS.fourstep_inverse_sharded(e, nf, mesh, True), mesh)


def _step(x, y, zsign, scx: int, scy: int, planes, spec, mesh: Mesh):
    """(digits int32 [2, L] on every rank, signs int32 [2]) of one step
    from replicated digits x, y and their signs zsign int32 [2]."""
    inv = products(x, y, spec, mesh)
    cfg = NP.tail_cfg((scx, scy, 1, 0), nr=False)
    if x.device.type == "cpu":
        cfg = _cfg(cfg, zsign)
        zsign = None
    dig, sgn = sharded_tail(inv, *planes, cfg, mesh, zsign)
    full = PM.all_gather(mesh, dig).permute(1, 0, 2).reshape(2, spec.nfft)
    return full, sgn


def _check_state(spec, mesh, *digits):
    FP._check_state(spec, *digits)
    if digits[0].device != mesh.device:
        raise ValueError(f"digits on {digits[0].device}, the mesh is on "
                         f"{mesh.device}")


def iterate_z_sharded(sx, x, sy, y, scx, cx, scy, cy, *,
                      spec: FP.FixedSpec, mesh: Mesh):
    """ONE z ← z² + c update with every heavy axis sharded over the mesh:
    ``fixedpoint.iterate_z``'s signature semantics and its results bit
    for bit, on every rank (digits int32 [D] replicated on the mesh's
    device; signs ints or 0-d tensors).  Returns (nsx, nx, nsy, ny) with
    0-d int32 signs."""
    check_spec(spec, mesh)
    _check_state(spec, mesh, x, y, cx, cy)
    zsign = torch.stack([torch.as_tensor(s, dtype=torch.int32,
                                         device=x.device) for s in (sx, sy)])
    full, sgn = _step(x, y, zsign, int(scx), int(scy),
                      local_planes(cx, cy, spec, mesh), spec, mesh)
    F, D = spec.frac_digits, spec.digits
    return (sgn[0], full[0, F:F + D].contiguous(), sgn[1],
            full[1, F:F + D].contiguous())


def orbit_chunk_sharded(state, scx: int, cx: torch.Tensor, scy: int,
                        cy: torch.Tensor, spec: FP.FixedSpec, steps: int,
                        mesh: Mesh, reuse_digits: int = 0):
    """``orbit.orbit_chunk`` over a mesh: advance ``state``
    (``orbit.OrbitState``, replicated on every rank) by ``steps`` sharded
    steps in place; return the rows [steps, 12] of the pre-update z of
    each step and, with ``reuse_digits`` R > 0, their reuse rows: the
    one-device chunk's outputs exactly."""
    from fractalshark_tpu_torch.ops.bignum.orbit import reuse_row
    check_spec(spec, mesh)
    _check_state(spec, mesh, state.x, state.y, cx, cy)
    R = int(reuse_digits)
    if not 0 <= R <= spec.digits:
        raise ValueError(f"reuse_digits {R} not in [0, {spec.digits}]")
    dev = state.x.device
    F, D = spec.frac_digits, spec.digits
    rows = torch.empty(steps + 1, FP.ROW, dtype=torch.int32, device=dev)
    rows[0] = state.row
    reuse = None
    if R:
        reuse = torch.empty(steps + 1, 2 * R + 2, dtype=torch.int32,
                            device=dev)
        reuse[0] = reuse_row(state.x, state.y, state.row, R)
    planes = local_planes(cx, cy, spec, mesh)
    x, y, zsign = state.x, state.y, state.row[10:12].contiguous()
    for k in range(steps):
        full, zsign = _step(x, y, zsign, int(scx), int(scy), planes, spec,
                            mesh)
        mags = full[:, F:F + D]
        rows[k + 1] = FP.shadow_rows(mags, zsign)
        x, y = mags[0].contiguous(), mags[1].contiguous()
        if R:
            reuse[k + 1] = reuse_row(x, y, rows[k + 1], R)
    state.x.copy_(x)
    state.y.copy_(y)
    state.row = rows[steps]
    return (rows[:steps], reuse[:steps]) if R else rows[:steps]
