"""Saved-location text format (compatible with the reference's
``FractalSharkLib/SavedLocation.cpp``):

    width height minX minY maxX maxY num_iterations antialiasing <description>

one record per line(s); coordinates are decimal scientific strings.
"""

from __future__ import annotations

from dataclasses import dataclass

from fractalshark_tpu_torch.core.highprecision import HighPrecision
from fractalshark_tpu_torch.core.pointzoom import PointZoomBBConverter


@dataclass
class SavedLocation:
    width: int
    height: int
    min_x: HighPrecision
    min_y: HighPrecision
    max_x: HighPrecision
    max_y: HighPrecision
    num_iterations: int
    antialiasing: int
    description: str = ""

    def to_view(self) -> PointZoomBBConverter:
        return PointZoomBBConverter(
            min_x=self.min_x, min_y=self.min_y,
            max_x=self.max_x, max_y=self.max_y)


def serialize(loc: SavedLocation) -> str:
    digits = max(loc.min_x.digits10(), 25)
    return (f"{loc.width} {loc.height} "
            f"{loc.min_x.to_string(digits)} {loc.min_y.to_string(digits)} "
            f"{loc.max_x.to_string(digits)} {loc.max_y.to_string(digits)} "
            f"{loc.num_iterations} {loc.antialiasing} {loc.description}")


def parse_stream(text: str, prec: int = 2048) -> list[SavedLocation]:
    """Whitespace-token parse mirroring the C++ stream extraction: 8
    fields then the rest of the line is the description."""
    out: list[SavedLocation] = []
    toks: list[str] = []
    for rawline in text.splitlines():
        line = rawline.strip()
        if not line:
            continue
        parts = line.split()
        toks.extend(parts)
        if len(toks) >= 8:
            w, h = int(toks[0]), int(toks[1])
            mnx, mny, mxx, mxy = (HighPrecision(t, prec=prec)
                                  for t in toks[2:6])
            iters, aa = int(toks[6]), int(toks[7])
            desc = " ".join(toks[8:])
            out.append(SavedLocation(w, h, mnx, mny, mxx, mxy, iters, aa, desc))
            toks = []
    return out


def load_locations(path: str, prec: int = 2048) -> list[SavedLocation]:
    with open(path) as f:
        return parse_stream(f.read(), prec=prec)


def save_locations(path: str, locs: list[SavedLocation]) -> None:
    with open(path, "w") as f:
        for loc in locs:
            f.write(serialize(loc) + "\n")
