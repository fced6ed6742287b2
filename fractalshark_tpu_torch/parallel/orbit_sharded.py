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
  7: the JAX package's ``_from_prev`` halo, ``:62-68``).  The send
  buffer is one gather from a resident index (``pack``); the receive
  buffer goes to the tail as it is, which finds each residue by its
  (slot, row, column) address (``unpack`` is the same reading in torch);
* the tail: kernel K20 (``csrc/sharded_tail.cu``) in two launches with
  one ``all_gather`` of 2K words a rank between them (``tail_a``,
  ``tail_b``; their plain twins on CPU tensors);
* one ``all_gather`` of the digit blocks: the next step's columns span
  every block, and the state is replicated as the one-device session's
  is, so its shadow rows (``fixedpoint.shadow_rows``) are read on each
  rank with no further collective.

On the card a step runs on a resident ``Workspace`` (the send and
receive buffers, K20's outputs, the gathered words, the halo's slots and
the look-back state, made and checked once per spec and mesh), so it
copies nothing from host memory and waits for the card only inside the
collectives.  ``orbit_chunk_sharded`` is ``orbit.orbit_chunk`` over a mesh
(the sharded session's chunk).
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass

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
MAX_LLOC = 1 << 17
MASK = FP.DIGIT_MASK


# --------------------------------------------------------- the layout


@dataclass(frozen=True)
class Layout:
    """Rank ``rank``'s block of the step's L = n1·n2 digits over M ranks
    with K components: Lloc = L/M digits, h = n1/M rows of the
    four-step's n1 × n2 matrix, its w = n2/M columns a rank; the
    all_to_all's slot from each rank holds the R = 2K residue rows [R, h,
    w], then R × 8 halo words."""
    n1: int
    n2: int
    M: int
    rank: int
    K: int = 2

    @property
    def h(self) -> int:
        return self.n1 // self.M

    @property
    def w(self) -> int:
        return self.n2 // self.M

    @property
    def lloc(self) -> int:
        return self.h * self.n2

    @property
    def body(self) -> int:
        return 2 * self.K * self.h * self.w

    @property
    def slot(self) -> int:
        return self.body + 2 * self.K * HALO


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


@functools.lru_cache(maxsize=None)
def _send_index(lay: Layout) -> np.ndarray:
    """int64 [M, slot]: for each word of the send buffer, its index in
    the rank's inverse block [R, n1, w] (``torch.take``): to rank t, the
    rows [t·h, (t+1)·h) of every residue row, then the halo coefficients
    t's block reads from this rank; a halo word that t reads from
    another rank takes word 0, which t never reads."""
    R, h, w = 2 * lay.K, lay.h, lay.w
    q, r, c = np.meshgrid(np.arange(R), np.arange(h), np.arange(w),
                          indexing="ij")
    out = np.zeros((lay.M, lay.slot), np.int64)
    own = halo_owners(lay.n1, lay.n2, lay.M)
    for t in range(lay.M):
        out[t, :lay.body] = (q * lay.n1 * w + (t * h + r) * w + c).ravel()
        mine = own[t, 0] == lay.rank
        for k in range(R):
            out[t, lay.body + k * HALO:lay.body + (k + 1) * HALO][mine] = \
                k * lay.n1 * w + own[t, 1, mine] * w + own[t, 2, mine]
    return out


def pack(inv: torch.Tensor, lay: Layout) -> torch.Tensor:
    """The reshard's send buffer int32 [M, slot] from the rank's inverse
    block [R, n1, w]: one gather (``_send_index``; a ``Workspace`` keeps
    the index on the card)."""
    return torch.take(inv, torch.from_numpy(_send_index(lay)).to(inv.device))


def unpack(recv: torch.Tensor, lay: Layout) -> torch.Tensor:
    """The reshard's receive buffer [M, slot] → the residue rows of the
    rank's digit block with its halo, int32 [K, 2, 8 + Lloc]: each
    slot's [R, h, w] body in column order, and the 8 coefficients below
    the block from the ranks that hold them (``halo_owners``).  K20's
    launch A reads the receive buffer at these addresses itself."""
    M, R, h, w = lay.M, 2 * lay.K, lay.h, lay.w
    blk = recv[:, :lay.body].reshape(M, R, h, w).permute(1, 2, 0, 3)
    below = torch.zeros(R, HALO, dtype=recv.dtype, device=recv.device)
    if lay.rank:
        src = torch.from_numpy(
            halo_owners(lay.n1, lay.n2, M)[lay.rank, 0]).to(recv.device)
        below = recv[:, lay.body:].reshape(M, R, HALO)[
            src, :, torch.arange(HALO, device=recv.device)].T
    return torch.cat([below, blk.reshape(R, -1)], 1).view(lay.K, 2, -1)


def receive_buffers(inv: torch.Tensor, M: int):
    """(layouts, receive buffers int32 [M, slot]) of the M ranks of a
    mesh, as the reshard's all_to_all gives them, from the whole residue
    rows inv [K, 2, L] of one device (L = n1·n2 in the flat order of the
    four-step's n1 × n2 matrix): rank s's inverse block is the matrix's
    columns [s·n2/M, (s+1)·n2/M), packed by ``pack``, and rank r receives
    block r of every rank's send buffer.  For holding K20's blocks to
    their twins on one card, with no collective."""
    K, _, L = inv.shape
    n1, n2 = N.split_n(L)
    w = n2 // M
    mat = inv.reshape(2 * K, n1, n2)
    lays = [Layout(n1, n2, M, r, K) for r in range(M)]
    sends = [pack(mat[:, :, s * w:(s + 1) * w].contiguous(), lays[s])
             for s in range(M)]
    return lays, [torch.stack([sends[s][r] for s in range(M)])
                  for r in range(M)]


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


# --------------------------------------------------------- K20's twins


def _cfg(cfg, zsign) -> list:
    cfg = [int(v) for v in cfg]
    if zsign is not None:
        cfg[5] = int(zsign[0]) * int(zsign[1])
    return cfg


def _segments(rows: torch.Tensor, cadd: torch.Tensor, rnd: torch.Tensor,
              cfg):
    """The segments of a block from its residue rows int32 [K, 2, 8 +
    Lloc] (the halo first): (digits int32 [K, Lloc], each segment's own
    ripple with the carry of the one below absorbed; f, z [K, Lloc/4, 3]
    its (f, z) word; the raw carry-out int64 [K] of the top segment's
    ripple)."""
    K, _, W = rows.shape
    lloc = W - HALO
    c = torch.as_tensor(cfg, dtype=torch.int64, device=rows.device).view(K, 4)
    acc = NP.part_sums(NP.signed_coefs(rows, cfg), W)
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
    return dig.reshape(K, lloc).to(torch.int32), f, z, cr[:, -1]


def tail_a_plain(recv: torch.Tensor, cadd: torch.Tensor, rnd: torch.Tensor,
                 cfg, lay: Layout, zsign=None):
    """Launch A's function on rank ``lay.rank``'s block: recv int32 [M,
    slot] (the reshard's receive buffer), cadd int32 [K, 8 + Lloc], rnd
    int32 [8 + Lloc] (their 8 halo words first).  Returns (digits int32
    [K, Lloc], each segment's carry absorbed from the one below; pre
    int32 [K, Lloc/4], each segment's exclusive prefix word within the
    block; words int32 [K, 2]: the block's composed word and the raw
    carry-out of its top segment)."""
    dig, f, z, top = _segments(unpack(recv, lay), cadd, rnd,
                               _cfg(cfg, zsign))
    inf, inz = _scan(f, z)
    fi, zi = _identity((lay.K, 1), recv.device)
    pre = _encode(torch.cat([fi, inf[:, :-1]], 1),
                  torch.cat([zi, inz[:, :-1]], 1))
    words = torch.stack([_encode(inf[:, -1], inz[:, -1]),
                         top.to(torch.int32)], 1)
    return dig, pre, words


def tail_b_plain(dig: torch.Tensor, pre: torch.Tensor, words: torch.Tensor,
                 rank: int):
    """Launch B's function: launch A's digits and prefix words of rank
    ``rank``'s block and every rank's launch-A words int32 [M, K, 2] in
    rank order.  Returns (final digits int32 [K, Lloc], signs int32
    [K])."""
    K, lloc = dig.shape
    M = words.shape[0]
    G = lloc // SEG
    dev = dig.device
    wf, wz = _decode(words[:, :, 0])           # [M, K, 3]
    bf, bz = _identity((K,), dev)              # the ranks below
    tf, tz = _identity((K,), dev)              # every rank
    for r in range(M):
        if r < rank:
            bf, bz = _compose(wf[r], wz[r], bf, bz)
        tf, tz = _compose(wf[r], wz[r], tf, tz)
    neg = words[M - 1, :, 1].to(torch.int64) + tf[:, 1] < 0
    sign = torch.where(neg & ~tz[:, 1], -1, 1).to(torch.int32)
    sf, sz = _decode(pre)
    pf, pz = _compose(sf, sz, bf.unsqueeze(1).expand_as(sf),
                      bz.unsqueeze(1).expand_as(sz))
    cin, zb = pf[..., 1], pz[..., 1]
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


class _Args(ctypes.Structure):
    """``ShardArgs`` of csrc/sharded_tail.cu: both launches' arguments."""
    _fields_ = [(name, ctypes.c_void_p) for name in (
        "recv", "cadd", "rnd", "zsign", "halo", "dig", "pre", "words",
        "state", "gathered", "sgn")] + [
        ("cfg", ctypes.c_int32 * 16)] + [
        (name, ctypes.c_int32) for name in (
            "K", "lloc", "log2_n2", "log2_w", "ranks", "rank")]


def _args(lay: Layout, cfg) -> _Args:
    a = _Args()
    a.cfg[:len(cfg)] = [int(v) for v in cfg]
    a.K, a.lloc, a.ranks, a.rank = lay.K, lay.lloc, lay.M, lay.rank
    a.log2_n2 = lay.n2.bit_length() - 1
    a.log2_w = lay.w.bit_length() - 1
    return a


def _check_layout(lay: Layout) -> None:
    if not 1 <= lay.K <= 4 or lay.lloc < SEG or lay.lloc % SEG or \
            lay.lloc > MAX_LLOC:
        raise ValueError(f"K20 takes 1 to 4 components and a block of a "
                         f"multiple of 4 digits up to 2^17, not K={lay.K}, "
                         f"Lloc={lay.lloc}")
    if not 0 <= lay.rank < lay.M or lay.n1 % lay.M or lay.n2 % lay.M:
        raise ValueError(f"K20: {lay} is not a rank's block")


def _check_a(recv, cadd, rnd, cfg, lay, zsign):
    _check_layout(lay)
    W = HALO + lay.lloc
    if recv.shape != (lay.M, lay.slot) or cadd.shape != (lay.K, W) or \
            rnd.shape != (W,) or len(cfg) != 4 * lay.K:
        raise ValueError(f"K20: recv [{lay.M}, {lay.slot}], cadd "
                         f"[{lay.K}, {W}], rnd [{W}] and cfg "
                         f"[{4 * lay.K}]")
    for t in (recv, cadd, rnd):
        if t.dtype != torch.int32 or t.device != recv.device or \
                not t.is_contiguous():
            raise ValueError("K20's planes are contiguous int32 on one "
                             "device")
    if recv.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {recv.device}")
    if zsign is not None and (zsign.shape != (2,) or
                              zsign.dtype != torch.int32 or
                              zsign.device != recv.device):
        raise ValueError("zsign must be int32 [2] on the planes' device")


def _halo_slots(lay: Layout, device) -> torch.Tensor | None:
    """The halo's slots, int32 [8] on ``device`` (None on rank 0)."""
    if not lay.rank:
        return None
    own = halo_owners(lay.n1, lay.n2, lay.M)[lay.rank, 0]
    return torch.from_numpy(own.astype(np.int32)).to(device)


def _launch(fn, args, device) -> None:
    """One K20 launch: ``fn`` a C entry, ``args`` a reference to its
    ``_Args``."""
    kernels.check(fn(args, kernels.stream(device)), "sharded_tail")
    kernels.launches["sharded_tail"] += 1


def _state(device) -> torch.Tensor:
    """A zeroed look-back state (``LookBack`` of csrc/sharded_tail.cu).
    It serves one block size; the launches that share it run one after
    another, on one stream."""
    return torch.zeros(kernels.lib().fs_sharded_tail_state_words(),
                       dtype=torch.int32, device=device)


_STATES: dict = {}


def _public_state(device, lloc: int) -> torch.Tensor:
    """The public ``tail_a``'s look-back state for ``lloc``-digit blocks
    on ``device``, made once (as K10's ``kernels.tail_state``)."""
    key = (str(device), lloc)
    if key not in _STATES:
        _STATES[key] = _state(device)
    return _STATES[key]


def tail_a(recv, cadd, rnd, cfg, lay: Layout, zsign=None):
    """Launch A (``tail_a_plain``): K20 on CUDA tensors, the twin on CPU
    tensors.  ``zsign`` (int32 [2], optional) replaces component 1's
    gswap by zsign[0]·zsign[1], read on the card."""
    _check_a(recv, cadd, rnd, cfg, lay, zsign)
    if recv.device.type == "cpu":
        return tail_a_plain(recv, cadd, rnd, cfg, lay, zsign)
    dev = recv.device
    dig = torch.empty(lay.K, lay.lloc, dtype=torch.int32, device=dev)
    pre = torch.empty(lay.K, lay.lloc // SEG, dtype=torch.int32, device=dev)
    words = torch.empty(lay.K, 2, dtype=torch.int32, device=dev)
    state, halo = _public_state(dev, lay.lloc), _halo_slots(lay, dev)
    a = _args(lay, cfg)
    a.recv, a.cadd, a.rnd = recv.data_ptr(), cadd.data_ptr(), rnd.data_ptr()
    a.zsign = None if zsign is None else zsign.data_ptr()
    a.halo = None if halo is None else halo.data_ptr()
    a.dig, a.pre, a.words = dig.data_ptr(), pre.data_ptr(), words.data_ptr()
    a.state = state.data_ptr()
    _launch(kernels.lib().fs_sharded_tail_a, ctypes.byref(a), dev)
    return dig, pre, words


def tail_b(dig, pre, words, lay: Layout):
    """Launch B (``tail_b_plain``): K20 on CUDA tensors, finishing
    ``dig`` in place; the twin on CPU tensors."""
    _check_layout(lay)
    if dig.shape != (lay.K, lay.lloc) or \
            pre.shape != (lay.K, lay.lloc // SEG) or \
            words.shape != (lay.M, lay.K, 2):
        raise ValueError("K20 launch B: digits [K, Lloc], prefix words "
                         "[K, Lloc/4], words [M, K, 2]")
    for t in (dig, pre, words):
        if t.dtype != torch.int32 or t.device != dig.device or \
                not t.is_contiguous():
            raise ValueError("K20's words are contiguous int32 on one "
                             "device")
    if dig.device.type == "cpu":
        return tail_b_plain(dig, pre, words, lay.rank)
    sgn = torch.empty(lay.K, dtype=torch.int32, device=dig.device)
    a = _args(lay, [])
    a.dig, a.pre, a.gathered, a.sgn = (dig.data_ptr(), pre.data_ptr(),
                                       words.data_ptr(), sgn.data_ptr())
    _launch(kernels.lib().fs_sharded_tail_b, ctypes.byref(a), dig.device)
    return dig, sgn


def sharded_tail(recv, cadd, rnd, cfg, lay: Layout, mesh: Mesh,
                 zsign=None):
    """The rank's block of the tail from the reshard's receive buffer:
    (digits int32 [K, Lloc], signs int32 [K], the same on every rank):
    launch A, one all_gather of the words, launch B."""
    dig, pre, words = tail_a(recv, cadd, rnd, cfg, lay, zsign)
    return tail_b(dig, pre, PM.all_gather(mesh, words), lay)


class Workspace:
    """A step's resident buffers on one rank, made and checked once per
    (spec, mesh): the send and receive buffers of the reshard and the
    send index, K20's digits, prefix words, words, gathered words and
    signs, and on the card the halo's slots, the look-back state and the
    launches' argument struct.  ``bind`` sets the chunk's planes and
    config; a step then runs ``exchange``, ``launch_a``, the words'
    all_gather into ``gathered``, ``launch_b``: on the card with no
    allocation, no host-to-device copy and no check; on the CPU the same
    through the twins.

    Aliasing: ``dig`` is finished in place by launch B and overwritten
    by the next step's launch A, so the digits' all_gather must have
    read it by then.  It has: under NCCL the collective runs on its own
    stream after the current stream's work and the current stream waits
    for it before the next launch; under gloo ``mesh.all_gather`` copies
    ``dig`` to the host, which waits for that copy, before it returns.
    The same holds for ``words`` and ``send``, and ``gathered`` and
    ``recv`` are written only by their collectives."""

    def __init__(self, spec: FP.FixedSpec, mesh: Mesh, K: int = 2):
        n1, n2 = check_spec(spec, mesh)
        self.lay = lay = Layout(n1, n2, mesh.size, mesh.rank, K)
        _check_layout(lay)
        dev = self.device = mesh.device

        def buf(*shape):
            return torch.zeros(*shape, dtype=torch.int32, device=dev)

        self.index = torch.from_numpy(_send_index(lay)).to(dev)
        self.send, self.recv = buf(lay.M, lay.slot), buf(lay.M, lay.slot)
        self.dig, self.pre = buf(K, lay.lloc), buf(K, lay.lloc // SEG)
        self.words, self.gathered = buf(K, 2), buf(lay.M, K, 2)
        self.sgn = buf(K)
        self.planes = self.cfg = None
        if dev.type != "cuda":
            return
        self.halo = _halo_slots(lay, dev)
        self.state = _state(dev)
        self.args = a = _args(lay, [0] * 4 * K)
        a.recv, a.dig, a.pre = (self.recv.data_ptr(), self.dig.data_ptr(),
                                self.pre.data_ptr())
        a.words, a.gathered = self.words.data_ptr(), self.gathered.data_ptr()
        a.sgn, a.state = self.sgn.data_ptr(), self.state.data_ptr()
        a.halo = None if self.halo is None else self.halo.data_ptr()
        self._ref = ctypes.byref(a)
        lib = kernels.lib()
        self._fa, self._fb = lib.fs_sharded_tail_a, lib.fs_sharded_tail_b

    def bind(self, planes, cfg) -> None:
        """The chunk's addend planes (``local_planes``) and config."""
        cadd, rnd = planes
        _check_a(self.recv, cadd, rnd, cfg, self.lay, None)
        self.planes, self.cfg = planes, cfg
        if self.device.type == "cuda":
            self.args.cadd, self.args.rnd = cadd.data_ptr(), rnd.data_ptr()
            self.args.cfg[:len(cfg)] = [int(v) for v in cfg]

    def exchange(self, inv: torch.Tensor, mesh: Mesh) -> None:
        """The reshard: the send buffer gathered from the inverse block
        [R, n1, w], one all_to_all into ``recv``."""
        torch.take(inv, self.index, out=self.send)
        PM.all_to_all(mesh, self.send, out=self.recv)

    def launch_a(self, zsign: torch.Tensor) -> None:
        """Launch A into ``dig``, ``pre`` and ``words``; ``zsign``: the
        signs of the step's z, int32 [2]."""
        if self.device.type == "cuda":
            self.args.zsign = zsign.data_ptr()
            _launch(self._fa, self._ref, self.device)
            return
        for t, v in zip((self.dig, self.pre, self.words), tail_a_plain(
                self.recv, *self.planes, self.cfg, self.lay, zsign)):
            t.copy_(v)

    def launch_b(self) -> None:
        """Launch B: ``dig`` finished in place, the signs into ``sgn``."""
        if self.device.type == "cuda":
            _launch(self._fb, self._ref, self.device)
            return
        dig, sgn = tail_b_plain(self.dig, self.pre, self.gathered,
                                self.lay.rank)
        self.dig.copy_(dig)
        self.sgn.copy_(sgn)

    def step(self, inv: torch.Tensor, zsign: torch.Tensor,
             mesh: Mesh) -> tuple[torch.Tensor, torch.Tensor]:
        """The reshard and the tail of one step from the inverse block:
        (``dig``, ``sgn``), the workspace's own buffers."""
        self.exchange(inv, mesh)
        self.launch_a(zsign)
        PM.all_gather(mesh, self.words, out=self.gathered)
        self.launch_b()
        return self.dig, self.sgn


_WORKSPACES: dict = {}


def workspace(spec: FP.FixedSpec, mesh: Mesh) -> Workspace:
    """The cached ``Workspace`` of (spec, mesh)."""
    key = (spec, mesh)
    if key not in _WORKSPACES:
        _WORKSPACES[key] = Workspace(spec, mesh)
    return _WORKSPACES[key]


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


def reshard(inv: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The inverse's rank block [4, n1, n2/M] → the residue rows of the
    rank's contiguous digit block with its halo, [2, 2, 8 + Lloc]: the
    send buffer (``pack``), one ``all_to_all`` (the JAX package's
    ``:246-249``) and the receive buffer read in torch (``unpack``), the
    plain path of what K20's launch A reads in place."""
    R, n1, w = inv.shape
    lay = Layout(n1, w * mesh.size, mesh.size, mesh.rank, R // 2)
    return unpack(PM.all_to_all(mesh, pack(inv, lay)), lay)


def inverse_block(x, y, spec, mesh: Mesh) -> torch.Tensor:
    """The rank's block [4, n1, n2/M] of the residue rows of x² − y² and
    x·y, from replicated digits x, y: the sharded transforms and the
    frequency combines."""
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
    return NS.fourstep_inverse_sharded(e, nf, mesh, True)


def _step(x, y, zsign, spec, mesh: Mesh, ws: Workspace):
    """(digits int32 [2, L] on every rank, signs int32 [2]: ``ws.sgn``)
    of one step from replicated digits x, y and their signs zsign int32
    [2], through the workspace ``ws`` (bound to the chunk's planes)."""
    dig, sgn = ws.step(inverse_block(x, y, spec, mesh), zsign, mesh)
    full = PM.all_gather(mesh, dig).permute(1, 0, 2).reshape(2, spec.nfft)
    return full, sgn


def _session(spec, mesh: Mesh, scx: int, scy: int, cx, cy) -> Workspace:
    """The (spec, mesh) workspace bound to c's planes and config; its
    component 1's gswap is each step's zsign."""
    ws = workspace(spec, mesh)
    ws.bind(local_planes(cx, cy, spec, mesh),
            NP.tail_cfg((scx, scy, 1, 0), nr=False))
    return ws


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
    ws = _session(spec, mesh, int(scx), int(scy), cx, cy)
    full, sgn = _step(x, y, zsign, spec, mesh, ws)
    sgn = sgn.clone()     # the workspace's signs change at its next step
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
    ws = _session(spec, mesh, int(scx), int(scy), cx, cy)
    x, y, zsign = state.x, state.y, state.row[10:12].contiguous()
    for k in range(steps):
        full, zsign = _step(x, y, zsign, spec, mesh, ws)
        mags = full[:, F:F + D]
        rows[k + 1] = FP.shadow_rows(mags, zsign)
        x, y = mags[0].contiguous(), mags[1].contiguous()
        if R:
            reuse[k + 1] = reuse_row(x, y, rows[k + 1], R)
    state.x.copy_(x)
    state.y.copy_(y)
    state.row = rows[steps]
    return (rows[:steps], reuse[:steps]) if R else rows[:steps]
