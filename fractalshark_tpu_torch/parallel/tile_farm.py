"""Multi-host tile farming with checkpointed tile queues: the port of
``fractalshark_tpu/parallel/tile_farm.py``.

The reference is single-node; its scale-out analogue in SURVEY.md §2.5
is farming pixel TILES of one huge render across hosts: the devices of a
host render inside it, while hosts coordinate over the network.  Design:

* a render is cut into fixed tiles (row bands by default);
* each process claims the tiles with ``index % num_processes ==
  process_index`` (static partition — no cross-host scheduler chatter;
  DCN is for bulk results, not fine-grained work stealing);
* finished tiles land in a *checkpoint directory* (one ``.npy`` per
  tile + a done-marker) so a preempted host resumes without recompute —
  the reference's save-as-you-go orbit files (``Vectors.h``
  AddPointOptions) applied to tiles;
* ``gather_dcn()`` assembles the full image in a ``torch.distributed``
  process group: each process's tiles (zeros elsewhere) summed by one
  ``all_reduce`` (the JAX package's ``process_allgather`` then a sum);
  ``gather_local()`` reads the checkpoint directory.

Single-process use degenerates to a resumable tiled renderer (used by
the tray queue for poster-size renders).
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass

import numpy as np


@dataclass(frozen=True)
class Tile:
    index: int
    y0: int
    h: int


def make_tiles(height: int, tile_h: int) -> list[Tile]:
    tiles = []
    y = 0
    i = 0
    while y < height:
        h = min(tile_h, height - y)
        tiles.append(Tile(i, y, h))
        y += h
        i += 1
    return tiles


class TileFarm:
    """Checkpointed tile queue for one render.

    ``render_tile(ptz, width, height, y0, h) -> np.ndarray[h, width]``
    is supplied by the caller (typically a closure over
    Fractal/renderers so any registered algorithm can be farmed)."""

    def __init__(self, ptz, width: int, height: int, tile_h: int,
                 ckpt_dir: str, process_index: int = 0,
                 process_count: int = 1):
        self.ptz = ptz
        self.width = width
        self.height = height
        self.tiles = make_tiles(height, tile_h)
        self.ckpt_dir = ckpt_dir
        self.process_index = process_index
        self.process_count = process_count
        os.makedirs(ckpt_dir, exist_ok=True)
        meta = os.path.join(ckpt_dir, "farm.json")
        if not os.path.exists(meta):
            with open(meta, "w") as f:
                json.dump({"width": width, "height": height,
                           "tile_h": tile_h,
                           "tiles": len(self.tiles)}, f)

    # ------------------------------------------------------------ queue

    def my_tiles(self) -> list[Tile]:
        return [t for t in self.tiles
                if t.index % self.process_count == self.process_index]

    def _tile_path(self, t: Tile) -> str:
        return os.path.join(self.ckpt_dir, f"tile_{t.index:05d}.npy")

    def is_done(self, t: Tile) -> bool:
        return os.path.exists(self._tile_path(t))

    def pending(self) -> list[Tile]:
        return [t for t in self.my_tiles() if not self.is_done(t)]

    def run(self, render_tile, progress=None, abort_monitor=None) -> int:
        """Render this process's pending tiles; returns tiles rendered.
        Already-checkpointed tiles are skipped (resume)."""
        n = 0
        for t in self.pending():
            if abort_monitor is not None and abort_monitor.aborted():
                break
            out = np.asarray(render_tile(self.ptz, self.width,
                                         self.height, t.y0, t.h))
            assert out.shape == (t.h, self.width), out.shape
            tmp = self._tile_path(t) + ".tmp.npy"
            np.save(tmp, out)
            os.replace(tmp, self._tile_path(t))
            n += 1
            if progress is not None:
                progress(t, out)
        return n

    # ----------------------------------------------------------- gather

    def gather_local(self, dtype=np.uint32) -> np.ndarray:
        """Assemble from the checkpoint directory (all tiles must be
        done — by this or other processes sharing the directory)."""
        img = np.zeros((self.height, self.width), dtype)
        for t in self.tiles:
            p = self._tile_path(t)
            if not os.path.exists(p):
                raise FileNotFoundError(f"tile {t.index} missing: {p}")
            img[t.y0:t.y0 + t.h] = np.load(p)
        return img

    def gather_dcn(self, dtype=np.uint32) -> np.ndarray:
        """Assemble across the processes of the ``torch.distributed``
        process group: each contributes its own tiles (zeros elsewhere)
        and one ``all_reduce`` (SUM) of the int64 image gives the whole
        one on every process, no shared filesystem needed.  With no
        process group, or a world of one, this process's part."""
        import torch
        import torch.distributed as dist

        part = np.zeros((self.height, self.width), np.int64)
        for t in self.my_tiles():
            part[t.y0:t.y0 + t.h] = np.load(self._tile_path(t))
        if not (dist.is_available() and dist.is_initialized()) or \
                dist.get_world_size() == 1:
            return part.astype(dtype)
        img = torch.from_numpy(part)
        if dist.get_backend() == "nccl":
            img = img.cuda()
        dist.all_reduce(img, op=dist.ReduceOp.SUM)
        return img.cpu().numpy().astype(dtype)


def render_tile_escape(alg_dtype=np.float32, max_iter: int = 512,
                       device="cuda"):
    """A render_tile closure over the plain escape (K1 on a CUDA device,
    its twin on the CPU) in ``escape_jax``'s loop semantics, as the
    reference's closure; row-band crops share the full view's pixel grid
    exactly (``escape(..., y0=...)``).  The grid as numpy, uint32 below a
    budget of 2^32, as ``escape_jax`` returns it."""
    from fractalshark_tpu_torch.ops import escape

    def fn(ptz, width, height, y0, h):
        p = escape.PlainParams.from_view(ptz, width, height)
        dt = "f32" if alg_dtype == np.float32 else "f64"
        out = escape.escape(p, width, h, max_iter, dtype=dt, device=device,
                            y0=y0, tile=False)
        return out.cpu().numpy().astype(
            np.uint64 if max_iter >= (1 << 32) else np.uint32)

    return fn
