"""A device mesh on ``torch.distributed``: the port's counterpart of the
one-axis ``jax.sharding.Mesh`` that ``fractalshark_tpu/parallel/`` shards
over (``ntt_sharded.py:43-44``, ``render.py:31-33``).

A mesh is a process group with one rank per device: rank r of M works on
its own device and holds the r-th block of every sharded axis.  The
caller creates the group (``torch.distributed.init_process_group``:
``nccl`` when each rank has a card of its own, ``gloo`` on the CPU or for
several ranks on one card) and names the rank's device; nothing here
picks a backend or a device, and nothing falls back to one rank or to the
CPU when a collective fails.

The collectives take and return tensors on the mesh's device.  Under
gloo a CUDA tensor is staged through host memory explicitly (gloo's own
CUDA collectives stage the same way), so every collective the sharded
paths use is one gloo supports on CPU tensors: ``all_gather`` (list
form), ``all_to_all_single`` with equal splits and ``all_reduce``.  torch
has no uint32 collectives: the bignum paths exchange int32 bit patterns.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.distributed as dist


@dataclass(frozen=True)
class Mesh:
    """One rank's view of a mesh: its group, the number of ranks M, its
    rank in the group and its device."""
    group: object
    size: int
    rank: int
    device: torch.device

    @property
    def staged(self) -> bool:
        """Whether collectives go through host memory (gloo and a CUDA
        device)."""
        return self.device.type == "cuda" and \
            dist.get_backend(self.group) == "gloo"


def make_mesh(device, group=None) -> Mesh:
    """The calling rank's mesh over ``group`` (the default group when
    None, which the caller has initialised) on ``device``: one rank per
    device.  A CUDA device becomes the current device, so that the
    kernels launch on it."""
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError("make_mesh needs an initialised torch.distributed "
                           "process group")
    group = dist.group.WORLD if group is None else group
    rank = dist.get_rank(group)
    if rank < 0:
        raise ValueError("this process is not a member of the group")
    device = torch.device(device)
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {device}")
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("device 'cuda' requested but CUDA is not "
                               "available")
        if device.index is None:
            raise ValueError("a CUDA mesh device needs its index")
        torch.cuda.set_device(device)
    return Mesh(group, dist.get_world_size(group), rank, device)


def _host(mesh: Mesh, t: torch.Tensor) -> torch.Tensor:
    if t.device != mesh.device:
        raise ValueError(f"a tensor on {t.device}, the mesh is on "
                         f"{mesh.device}")
    t = t.contiguous()
    return t.cpu() if mesh.staged else t


def _into(res: torch.Tensor, out: torch.Tensor | None) -> torch.Tensor:
    if out is None:
        return res
    return out.copy_(res)


def all_gather(mesh: Mesh, t: torch.Tensor,
               out: torch.Tensor | None = None) -> torch.Tensor:
    """[M, *t.shape]: every rank's ``t``, in rank order, on every rank;
    into ``out`` (contiguous, on the mesh's device) when given, which
    NCCL writes in place."""
    src = _host(mesh, t)
    if out is not None and not mesh.staged and \
            dist.get_backend(mesh.group) == "nccl":
        dist.all_gather_into_tensor(out, src, group=mesh.group)
        return out
    parts = [torch.empty_like(src) for _ in range(mesh.size)]
    dist.all_gather(parts, src, group=mesh.group)
    return _into(torch.stack(parts).to(mesh.device), out)


def all_to_all(mesh: Mesh, t: torch.Tensor,
               out: torch.Tensor | None = None) -> torch.Tensor:
    """t [M, ...]: block s goes to rank s; returns [M, ...] with block k
    from rank k, into ``out`` (contiguous, t's shape) when given."""
    if t.shape[0] != mesh.size:
        raise ValueError(f"all_to_all takes [{mesh.size}, ...] blocks, not "
                         f"{tuple(t.shape)}")
    src = _host(mesh, t)
    if out is not None and not mesh.staged:
        dist.all_to_all_single(out, src, group=mesh.group)
        return out
    res = torch.empty_like(src)
    dist.all_to_all_single(res, src, group=mesh.group)
    return _into(res.to(mesh.device), out)


def all_reduce(mesh: Mesh, t: torch.Tensor, op) -> torch.Tensor:
    """``t`` reduced over the ranks with ``op`` (a ``dist.ReduceOp``)."""
    buf = _host(mesh, t).clone()
    dist.all_reduce(buf, op=op, group=mesh.group)
    return buf.to(mesh.device)
