#!/usr/bin/env python3
"""Colour a saved iteration grid (``*.npy``) into a PNG through the
PyTorch/CUDA port (``fractalshark_tpu_torch``): the counterpart of
``tools/iters_to_png.py``.

The port's drivers (``tools/run_view32_torch.py``,
``run_view27_torch.py``, ``run_view30_torch.py``) save raw per-pixel
iteration counts.  This applies the palette pipeline the CLI uses
(``core/palette.FractalPalette`` → ``ops/coloring.color_from_iters`` →
``rgba16_to_rgba8``) with the counts rebased to the grid's own minimum,
so that deep-budget frames (iter_min ~ 49e9 on View #27) land in palette
range, with the span + 1 as the budget (no pixel is drawn as interior).
The JAX tool hands the rebased counts over as uint32 below a span of 2^31
and as uint64 above it; here they stay int64, whose ``%`` and ``>=`` give
the same for every count below 2^63.  The colouring runs on the card
unless ``--device cpu`` is asked for; CUDA without a card raises.

    python3 tools/iters_to_png_torch.py in.npy [out.png] [--device cuda]

Environment: ``I2P_IN`` and ``I2P_OUT`` stand in for the arguments,
``I2P_PALETTE`` names the palette (Default).  Without either output the
PNG goes beside the input (``in.png``; the JAX tool writes a fixed path
in the temporary directory).  ``I2P_DEPTH``, which the JAX tool reads but
never applies, is not read.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def colour(it, budget: int | None = None, palette: str = "Default",
           device="cuda") -> np.ndarray:
    """The grid's RGBA8 image [H, W, 4], coloured on `device`.  `it` is a
    numpy array or a tensor (one on `device` is not copied).  With
    `budget` None the counts are rebased to the grid's minimum and the
    span + 1 is the budget (this tool's colouring); else the raw counts
    are coloured against `budget` (the CLI's)."""
    import torch

    from fractalshark_tpu_torch.core.palette import FractalPalette
    from fractalshark_tpu_torch.ops.coloring import (color_from_iters,
                                                     rgba16_to_rgba8)

    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device 'cuda' requested but CUDA is not "
                           "available")
    if not isinstance(it, torch.Tensor):
        it = torch.from_numpy(np.asarray(it).astype(np.int64))
    it = it.to(device=dev, dtype=torch.int64)
    if budget is None:
        lo, hi = (int(v) for v in torch.stack([it.min(), it.max()]).cpu())
        it, budget = it - lo, max(hi - lo, 1) + 1
    pal = FractalPalette()
    pal.use_palette_type(palette)
    return rgba16_to_rgba8(color_from_iters(it, pal.current(), budget,
                                            pal.aux_depth))


def main(argv=None) -> int:
    from fractalshark_tpu_torch.io.png import write_png

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("src", nargs="?", default=os.environ.get("I2P_IN"),
                    help="the grid (.npy); I2P_IN without it")
    ap.add_argument("out", nargs="?", default=os.environ.get("I2P_OUT"),
                    help="the PNG; I2P_OUT, else beside the grid")
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args(sys.argv[1:] if argv is None else argv)
    if not a.src:
        print("usage: iters_to_png_torch.py in.npy [out.png] "
              "[--device cuda] (or I2P_IN)", file=sys.stderr)
        return 2
    out = a.out or os.path.splitext(a.src)[0] + ".png"
    it = np.load(a.src)
    write_png(out, colour(it, palette=os.environ.get("I2P_PALETTE",
                                                     "Default"),
                          device=a.device))
    print(f"wrote {out} ({it.shape[1]}x{it.shape[0]}, iters "
          f"{int(it.min())}..{int(it.max())})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
