"""Palette generation + iteration→color mapping.

Mirrors the reference ``FractalSharkLib/FractalPalette.{h,cpp}``:

* 4 palette families {Basic, Default, Patriotic, Summer} + Random
  (``PngParallelSave.h:12-19``), each built from smooth ``PalTransition``
  ramps between anchor colors in RGB16 (FractalPalette.cpp:28-95).
* 6 bit depths (2^5..2^20 colors per ramp segment,
  FractalPalette.cpp:173-186).
* aux-depth shifting and palette rotation.
* mapping (AntialiasingKernel.cuh:55-58):
  ``palIndex = (iters >> aux_depth) % num_colors``; interior pixels
  (iters == max) are black; colors averaged over the AA box.

Palettes are small host-side numpy arrays uploaded to device once per
generation; the mapping itself runs on device (ops/coloring.py).
"""

from __future__ import annotations

import numpy as np

MAX_VAL = 65535

PALETTE_TYPES = ("Basic", "Default", "Patriotic", "Summer", "Random")
BIT_DEPTHS = (5, 6, 8, 12, 16, 20)
DEFAULT_DEPTH_INDEX = 2  # depth 8 (reference FractalPalette.cpp:20)


def _pal_transition(segments: list[np.ndarray], length: int,
                    r: int, g: int, b: int) -> None:
    """Append a smooth ramp from the current last color to (r,g,b).
    Reference FractalPalette.cpp:139-166 (endpoint-inclusive steps)."""
    if segments:
        cur = segments[-1][-1].astype(np.float64)
    else:
        cur = np.zeros(3, dtype=np.float64)
    target = np.array([r, g, b], dtype=np.float64)
    i = np.arange(1, length + 1, dtype=np.float64)[:, None]
    ramp = cur[None, :] + (target - cur)[None, :] / length * i
    segments.append(ramp.astype(np.uint16))


def _build_default(depth: int) -> np.ndarray:
    n = 1 << depth
    segs: list[np.ndarray] = []
    m = MAX_VAL
    for anchor in [(m, 0, 0), (m, m, 0), (0, m, 0), (0, m, m),
                   (0, 0, m), (m, 0, m), (0, 0, 0)]:
        _pal_transition(segs, n, *anchor)
    return np.concatenate(segs, axis=0)


def _build_basic(depth: int) -> np.ndarray:
    # The reference's "Basic" palette is a plain RGB cycle at lower
    # saturation; we reuse the default ramp shape with half values.
    return (_build_default(depth) // 2).astype(np.uint16)


def _build_patriotic(depth: int) -> np.ndarray:
    n = 1 << depth
    m = MAX_VAL
    rr = int(0xB3 / 0xFF * m)
    rg = int(0x19 / 0xFF * m)
    rb = int(0x42 / 0xFF * m)
    br = int(0x0A / 0xFF * m)
    bg = int(0x31 / 0xFF * m)
    bb = int(0x61 / 0xFF * m)
    segs: list[np.ndarray] = [np.array([[m, m, m]], dtype=np.uint16)]
    _pal_transition(segs, n, rr, rg, rb)
    _pal_transition(segs, n, br, bg, bb)
    _pal_transition(segs, n, m, m, m)
    return np.concatenate(segs, axis=0)


def _build_summer(depth: int) -> np.ndarray:
    n = 1 << depth
    m = MAX_VAL
    segs: list[np.ndarray] = []
    for anchor in [(m, 0, 0), (0, m // 2, 0), (m, m, 0), (m, m, m),
                   (m // 2, m // 2, m), (m, m * 2 // 3, 0), (0, 0, 0)]:
        _pal_transition(segs, n, *anchor)
    return np.concatenate(segs, axis=0)


def _build_random(depth: int, rng: np.random.Generator) -> np.ndarray:
    n = 1 << depth
    num_anchors = 8
    segs: list[np.ndarray] = []
    for _ in range(num_anchors - 1):
        r, g, b = rng.integers(0, MAX_VAL + 1, size=3)
        _pal_transition(segs, n, int(r), int(g), int(b))
    _pal_transition(segs, n, 0, 0, 0)
    return np.concatenate(segs, axis=0)


class FractalPalette:
    """Host-side palette store with device-upload caching hooks."""

    def __init__(self, seed: int = 0):
        self._rng = np.random.default_rng(seed)
        self._cache: dict[tuple[str, int], np.ndarray] = {}
        self.palette_type = "Default"
        self.depth_index = DEFAULT_DEPTH_INDEX
        self.aux_depth = 0
        self.rotation = 0
        self.generation = 0

    # ------------------------------------------------------------- builders

    def _build(self, ptype: str, depth: int) -> np.ndarray:
        key = (ptype, depth)
        if key not in self._cache:
            builder = {
                "Basic": _build_basic,
                "Default": _build_default,
                "Patriotic": _build_patriotic,
                "Summer": _build_summer,
            }.get(ptype)
            if builder is not None:
                self._cache[key] = builder(depth)
            else:
                self._cache[key] = _build_random(depth, self._rng)
        return self._cache[key]

    def create_new_random_palette(self) -> None:
        for d in BIT_DEPTHS:
            self._cache.pop(("Random", d), None)
        self.generation += 1

    # ------------------------------------------------------------- controls

    def use_palette_type(self, ptype: str) -> None:
        if ptype not in PALETTE_TYPES:
            raise ValueError(f"unknown palette type {ptype}")
        self.palette_type = ptype
        self.generation += 1

    def use_depth(self, depth: int) -> None:
        if depth in BIT_DEPTHS:
            self.depth_index = BIT_DEPTHS.index(depth)
        else:
            self.depth_index = 0
        self.generation += 1

    def next_depth(self) -> None:
        self.depth_index = (self.depth_index + 1) % len(BIT_DEPTHS)
        self.generation += 1

    def set_aux_depth(self, depth: int) -> None:
        self.aux_depth = max(0, min(31, depth))
        self.generation += 1

    def next_aux_depth(self, inc: int) -> None:
        self.set_aux_depth((self.aux_depth + inc) % 17)

    def rotate(self, delta: int, max_iters: int) -> None:
        self.rotation = (self.rotation + delta) % max(1, max_iters)
        self.generation += 1

    def reset_rotation(self) -> None:
        self.rotation = 0
        self.generation += 1

    # -------------------------------------------------------------- queries

    @property
    def depth(self) -> int:
        return BIT_DEPTHS[self.depth_index]

    def current(self) -> np.ndarray:
        """Current palette as a uint16 array of shape [num_colors, 3]."""
        return self._build(self.palette_type, self.depth)

    def num_colors(self) -> int:
        return int(self.current().shape[0])
