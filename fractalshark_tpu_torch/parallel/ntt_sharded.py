"""The limb-sharded four-step NTT: one bignum transform spread over a
mesh of ranks, the port of ``fractalshark_tpu/parallel/ntt_sharded.py``.

The coefficient tensor [R, n1, n2] of the four-step (``ntt.split_n``,
n1 <= n2) is sharded over n2: rank r holds the columns [r·n2/M, (r+1)·n2/M)
of every row.  A forward transform is

* the head launch: K8 (``csrc/ntt_phase.cu``, unchanged) runs the phase
  of n1 over the rank's [R, n1, n2/M] and, in its epilogue, multiplies by
  the rank's rows of the twiddle matrix (``ntt._k8_matrix``, which is
  [2, n2, n1]: the rank's n2/M lanes are contiguous) and stores
  transposed, [R, n2/M, n1];
* the exchange: one ``all_to_all`` of that block, split along n1 (the
  JAX package's ``all_to_all(split_axis=1, concat_axis=2)``, ``:73-74``),
  which gives the rank [R, n2, n1/M];
* the tail launch: K8's phase of n2 over lanes n1/M.

The spectra are the reference's [R, n2, n1] sharded over the last axis.
The inverse is the mirror image: the head launch runs the phase of n2
and applies the rank's rows of t1i before the exchange (t1i is
elementwise in the global (i1, i2), so it commutes with the exchange;
the JAX package applies it after, ``:104-106``), the exchange gives
[R, n1, n2/M], and the tail launch runs the phase of n1 with the scale
epilogue.  Both are the single-device ``ntt.fourstep_forward`` /
``fourstep_inverse_scaled`` bit for bit: every phase is exact arithmetic
on its own columns.

On CPU tensors each launch is its plain twin (``ntt.phase_transform_plain``
and the twiddle products in exact int64), over the same collectives.
Inputs are replicated on every rank; outputs are the rank's blocks.
"""

from __future__ import annotations

import numpy as np
import torch

from fractalshark_tpu_torch.ops.bignum import ntt as N
from fractalshark_tpu_torch.parallel import mesh as PM
from fractalshark_tpu_torch.parallel.mesh import Mesh

__all__ = ["make_limb_mesh", "fourstep_forward_sharded",
           "fourstep_inverse_sharded", "multiply_3way_sharded"]


def make_limb_mesh(device, group=None) -> Mesh:
    """The calling rank's limb mesh (``mesh.make_mesh``): one rank per
    device over ``group``, the default group when None."""
    return PM.make_mesh(device, group)


def split(n: int, mesh: Mesh) -> tuple[int, int]:
    """(n1, n2) of an n-point transform over ``mesh``; ValueError, before
    any launch, unless M divides both."""
    N._check_pow2(n, 4, N.MAX_PHASE * N.MAX_PHASE, "transform size")
    n1, n2 = N.split_n(n)
    if n1 % mesh.size or n2 % mesh.size:
        raise ValueError(f"a mesh of {mesh.size} ranks must divide both "
                         f"four-step factors {n1} and {n2} of n = {n}")
    return n1, n2


def _matrix(n: int, inverse: bool, mesh: Mesh) -> torch.Tensor:
    """K8's twiddle-matrix operand for the rank's head launch: its lanes'
    rows of ``ntt._k8_matrix`` (forward: columns n2; inverse: rows n1)."""
    def make():
        mat = N._k8_matrix(n, inverse)
        w = mat.shape[1] // mesh.size
        return np.ascontiguousarray(mat[:, mesh.rank * w:(mesh.rank + 1) * w])
    return N._on(("k8_mat_shard", n, inverse, mesh.rank, mesh.size),
                 mesh.device, make)


def _twiddle_plain(n: int, inverse: bool, mesh: Mesh, rows: int):
    """The plain head's twiddles, int64 [R, L, m] in the order of its
    transposed output: the rank's slice of t1 (transposed) or t1i."""
    def make():
        t1, t1i = N.fourstep_twiddles(n)
        mat = t1i if inverse else t1.transpose(0, 2, 1)
        w = mat.shape[1] // mesh.size
        return np.ascontiguousarray(mat[:, mesh.rank * w:(mesh.rank + 1) * w])
    t = N._on(("t1_shard", n, inverse, mesh.rank, mesh.size), mesh.device,
              make)
    return t[N._row_idx(rows, mesh.device)]


def _head(a: torch.Tensor, n: int, m: int, inverse: bool,
          mesh: Mesh) -> torch.Tensor:
    """The phase of m over [R, m, L], transposed to [R, L, m], times the
    rank's twiddle rows: K8 with its matrix epilogue on the card."""
    if a.device.type == "cuda":
        return N.phase_kernel(a, m, inverse, mat=_matrix(n, inverse, mesh))
    b = N.phase_transform_plain(a, m, inverse).transpose(1, 2).contiguous()
    return N.mul_rows(b, _twiddle_plain(n, inverse, mesh, a.shape[0]))


def _tail(b: torch.Tensor, n: int, m: int, inverse: bool,
          extra_scale_r: bool) -> torch.Tensor:
    """The phase of m over [R, m, L]; the inverse scaled by n^-1 (·R with
    ``extra_scale_r``): K8 (with its scale epilogue) on the card."""
    if b.device.type == "cuda":
        scale = N._mont_words(N.scale_consts(n, extra_scale_r)) \
            if inverse else None
        return N.phase_kernel(b, m, inverse, scale=scale)
    out = N.phase_transform_plain(b, m, inverse)
    return N._scale(out, n, extra_scale_r) if inverse else out


def exchange(block: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """[R, A/M, B] → [R, A, B/M]: the four-step transpose's exchange.
    Rank s gets columns [s·B/M, (s+1)·B/M) of every rank's rows, stacked
    in rank order."""
    R, a, b = block.shape
    M = mesh.size
    send = block.view(R, a, M, b // M).permute(2, 0, 1, 3).contiguous()
    recv = PM.all_to_all(mesh, send)           # [M, R, a, b/M]
    return recv.permute(1, 0, 2, 3).reshape(R, M * a, b // M)


def _check_rows(x: torch.Tensor, tail: tuple, mesh: Mesh) -> None:
    if x.dim() != 1 + len(tail) or tuple(x.shape[1:]) != tail or \
            x.dtype != torch.int32 or x.device != mesh.device:
        raise ValueError(f"expected int32 [R, {', '.join(map(str, tail))}] "
                         f"on {mesh.device}, not {x.dtype}"
                         f"{tuple(x.shape)} on {x.device}")
    if not 0 < x.shape[0] < (1 << 16):
        raise ValueError(f"1 to 65,535 rows, not {x.shape[0]}")


def forward_local(a: torch.Tensor, n: int, mesh: Mesh) -> torch.Tensor:
    """The sharded forward from the rank's columns a int32 [R, n1, n2/M]:
    the rank's spectra [R, n2, n1/M]."""
    n1, n2 = split(n, mesh)
    _check_rows(a, (n1, n2 // mesh.size), mesh)
    return _tail(exchange(_head(a.contiguous(), n, n1, False, mesh), mesh),
                 n, n2, False, False)


def fourstep_forward_sharded(x: torch.Tensor, n: int,
                             mesh: Mesh) -> torch.Tensor:
    """Plain-domain rows x int32 [R, n] (replicated) → the rank's block
    [R, n2, n1/M] of the scrambled spectra [R, n2, n1], sharded over the
    last axis; bit-identical to ``ntt.fourstep_forward``."""
    n1, n2 = split(n, mesh)
    _check_rows(x, (n,), mesh)
    w = n2 // mesh.size
    a = x.reshape(x.shape[0], n1, n2)[:, :, mesh.rank * w:(mesh.rank + 1) * w]
    return forward_local(a.contiguous(), n, mesh)


def fourstep_inverse_sharded(e: torch.Tensor, n: int, mesh: Mesh,
                             extra_scale_r: bool = True) -> torch.Tensor:
    """Inverse of ``fourstep_forward_sharded`` from the rank's spectra
    [R, n2, n1/M]: the rank's block [R, n1, n2/M] of [R, n1, n2] sharded
    over the last axis (flattened, the digits), scaled by n^-1 (·R with
    ``extra_scale_r``); bit-identical to ``ntt.fourstep_inverse_scaled``."""
    n1, n2 = split(n, mesh)
    _check_rows(e, (n2, n1 // mesh.size), mesh)
    b = exchange(_head(e.contiguous(), n, n2, True, mesh), mesh)
    return _tail(b, n, n1, True, extra_scale_r)


def pointwise_sq3(f: torch.Tensor) -> torch.Tensor:
    """x², y², x·y in the frequency domain from stacked spectra f = [4,
    ...] (x mod p1, p2, y mod p1, p2): Montgomery products, elementwise on
    each rank (``:139-159``); [6, ...]."""
    fx, fy = f[:2], f[2:]
    return torch.cat([N.mont_mul_rows(fx, fx), N.mont_mul_rows(fy, fy),
                      N.mont_mul_rows(fx, fy)])


def gather_columns(block: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """[R, A, B/M] blocks sharded over the last axis → [R, A·B] on every
    rank."""
    R, a, w = block.shape
    parts = PM.all_gather(mesh, block)          # [M, R, a, w]
    return parts.permute(1, 2, 0, 3).reshape(R, a * w * mesh.size)


def multiply_3way_sharded(ax_digits, ay_digits, mesh: Mesh) -> torch.Tensor:
    """x², y², x·y exact convolutions of two digit vectors of length n (a
    four-step size; the upper half zero for an unwrapped product), every
    transform limb-sharded over the mesh: the residue rows int32 [6, n]
    (rows 2k, 2k + 1: product k mod p1, p2) gathered on every rank, as
    the single-device chain (``fourstep_forward``, Montgomery products,
    ``fourstep_inverse_scaled`` with ``extra_scale_r``) gives them."""
    ax = torch.as_tensor(np.asarray(ax_digits, np.int64)
                         if isinstance(ax_digits, np.ndarray) else ax_digits)
    ay = torch.as_tensor(np.asarray(ay_digits, np.int64)
                         if isinstance(ay_digits, np.ndarray) else ay_digits)
    n = int(ax.shape[0])
    x = torch.stack([ax, ax, ay, ay]).to(device=mesh.device,
                                         dtype=torch.int32)
    f = fourstep_forward_sharded(x, n, mesh)
    inv = fourstep_inverse_sharded(pointwise_sq3(f), n, mesh)
    return gather_columns(inv, mesh)
