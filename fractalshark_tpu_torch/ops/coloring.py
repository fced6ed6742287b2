"""Iteration → colour mapping, box antialiasing and iteration
statistics: the port of ``fractalshark_tpu/ops/coloring.py``.

The reference computes these in XLA (not Pallas), so here they are
plain PyTorch on whatever device the iteration grid lives on.
"""

from __future__ import annotations

import numpy as np
import torch


def color_from_iters(iters: torch.Tensor, palette: np.ndarray,
                     n_iterations: int, aux_depth: int,
                     antialiasing: int = 1) -> torch.Tensor:
    """iters [H*aa, W*aa] int64 → RGBA16 [H, W, 4] (int32 holding
    uint16 values): palette[(iters >> aux_depth) % C], interior pixels
    (iters >= budget) black, alpha 65535."""
    pal = torch.as_tensor(np.asarray(palette).astype(np.int32),
                          device=iters.device)
    idx = (iters >> int(aux_depth)) % pal.shape[0]
    rgb = pal[idx]
    rgb = torch.where((iters >= int(n_iterations))[..., None],
                      torch.zeros_like(rgb), rgb)
    if antialiasing > 1:
        h, w, _ = rgb.shape
        a = antialiasing
        rgb = rgb.reshape(h // a, a, w // a, a, 3).sum(dim=(1, 3)) // (a * a)
    alpha = torch.full(rgb.shape[:2] + (1,), 65535, dtype=rgb.dtype,
                       device=rgb.device)
    return torch.cat([rgb, alpha], dim=-1)


def iteration_stats(iters: torch.Tensor) -> dict:
    """{min, max, sum} of the iteration counts (one host readback).  The
    sum is the reference's uint64 sum (``jnp.sum`` of uint64): int64 row
    sums cannot overflow (a row of 2^16 pixels stays below 2^63 at any
    budget under 2^47), and their exact total is taken modulo 2^64 on the
    host."""
    flat = iters.reshape(iters.shape[0], -1) if iters.dim() > 1 \
        else iters.reshape(1, -1)
    rows = flat.sum(dim=1).cpu().tolist()
    mm = torch.stack([iters.min(), iters.max()]).cpu()
    return {"min": int(mm[0]), "max": int(mm[1]),
            "sum": sum(rows) % (1 << 64)}


def rgba16_to_rgba8(rgba16) -> np.ndarray:
    arr = np.asarray(rgba16.cpu() if isinstance(rgba16, torch.Tensor)
                     else rgba16)
    return (arr >> 8).astype(np.uint8)


def rgba16_to_numpy(rgba16: torch.Tensor) -> np.ndarray:
    return rgba16.cpu().numpy().astype(np.uint16)
