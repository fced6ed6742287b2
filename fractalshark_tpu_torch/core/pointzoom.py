"""Canonical view state: (center point, zoom factor) ↔ bounding box.

Semantics mirror the reference ``PointZoomBBConverter``
(``FractalSharkLib/PointZoomBBConverter.{h,cpp}``):

* ``Factor = 2``: a view constructed from (pt, zoomFactor) has half-extent
  ``Factor / zoomFactor`` on both axes (PointZoomBBConverter.cpp:16-19).
* ``radius`` = (maxY - minY) / 2 (the view half-height; used as the
  periodicity radius for reference orbits).
* zoomFactor recovered from a bounding box as ``2 * Factor / deltaY``
  (PointZoomBBConverter.cpp:329-332).
* screen↔calc mapping (PointZoomBBConverter.cpp:339-368), y inverted.
"""

from __future__ import annotations

from fractalshark_tpu_torch.core.highprecision import HighPrecision

FACTOR = 2


class PointZoomBBConverter:
    __slots__ = ("min_x", "min_y", "max_x", "max_y", "pt_x", "pt_y",
                 "zoom_factor", "radius")

    def __init__(self, *, pt_x=None, pt_y=None, zoom_factor=None,
                 min_x=None, min_y=None, max_x=None, max_y=None,
                 prec: int | None = None):
        def hp(v):
            if prec is None and isinstance(v, HighPrecision):
                return v  # preserve caller precision
            return HighPrecision(v, prec=prec)
        if pt_x is not None:
            self.pt_x = hp(pt_x)
            self.pt_y = hp(pt_y)
            self.zoom_factor = hp(zoom_factor)
            half = hp(FACTOR) / self.zoom_factor
            self.min_x = self.pt_x - half
            self.min_y = self.pt_y - half
            self.max_x = self.pt_x + half
            self.max_y = self.pt_y + half
            self.radius = half
        else:
            self.min_x = hp(min_x)
            self.min_y = hp(min_y)
            self.max_x = hp(max_x)
            self.max_y = hp(max_y)
            two = hp(2)
            self.pt_x = (self.min_x + self.max_x) / two
            self.pt_y = (self.min_y + self.max_y) / two
            delta_y = self.max_y - self.min_y
            self.radius = delta_y / two
            if delta_y.is_zero():
                self.zoom_factor = hp(1)
            else:
                self.zoom_factor = hp(2 * FACTOR) / delta_y

    # ------------------------------------------------------------ queries

    def degenerate(self) -> bool:
        return (self.max_x - self.min_x).is_zero() or \
               (self.max_y - self.min_y).is_zero()

    def delta_x(self, scrn_width: int, antialiasing: int = 1) -> HighPrecision:
        return (self.max_x - self.min_x) / HighPrecision(
            scrn_width * antialiasing, prec=self.min_x.prec)

    def delta_y(self, scrn_height: int, antialiasing: int = 1) -> HighPrecision:
        return (self.max_y - self.min_y) / HighPrecision(
            scrn_height * antialiasing, prec=self.min_y.prec)

    def x_screen_to_calc(self, x, scrn_width: int, antialiasing: int = 1):
        """minX + x * (maxX-minX)/(W*aa)  — reference cpp:339-345."""
        w = HighPrecision(scrn_width * antialiasing)
        return self.min_x + HighPrecision(x) * (self.max_x - self.min_x) / w

    def y_screen_to_calc(self, y, scrn_height: int, antialiasing: int = 1):
        """maxY - y * (maxY-minY)/(H*aa)  — y axis inverted (cpp:348-354)."""
        h = HighPrecision(scrn_height * antialiasing)
        return self.max_y - HighPrecision(y) * (self.max_y - self.min_y) / h

    def x_calc_to_screen(self, x, scrn_width: int) -> float:
        w = HighPrecision(scrn_width)
        return float((HighPrecision(x) - self.min_x) * w / (self.max_x - self.min_x))

    def y_calc_to_screen(self, y, scrn_height: int) -> float:
        h = HighPrecision(scrn_height)
        return float(h - (HighPrecision(y) - self.min_y) * h / (self.max_y - self.min_y))

    # --------------------------------------------------------- navigation

    def zoomed_at_center(self, scale: float) -> "PointZoomBBConverter":
        """scale > 1 zooms in (extent shrinks by `scale`)."""
        new_zoom = self.zoom_factor * HighPrecision(scale)
        return PointZoomBBConverter(
            pt_x=self.pt_x, pt_y=self.pt_y, zoom_factor=new_zoom)

    def recentered(self, calc_x, calc_y) -> "PointZoomBBConverter":
        return PointZoomBBConverter(
            pt_x=calc_x, pt_y=calc_y, zoom_factor=self.zoom_factor)

    def zoomed_recentered(self, calc_x, calc_y, scale: float):
        return PointZoomBBConverter(
            pt_x=calc_x, pt_y=calc_y,
            zoom_factor=self.zoom_factor * HighPrecision(scale))

    def zoomed_toward_point(self, calc_x, calc_y, scale: float):
        """Zoom keeping (calc_x, calc_y) at the same screen position."""
        cx, cy = HighPrecision(calc_x), HighPrecision(calc_y)
        inv = HighPrecision(1) / HighPrecision(scale)
        npx = cx + (self.pt_x - cx) * inv
        npy = cy + (self.pt_y - cy) * inv
        return PointZoomBBConverter(
            pt_x=npx, pt_y=npy,
            zoom_factor=self.zoom_factor * HighPrecision(scale))

    def panned(self, dx, dy) -> "PointZoomBBConverter":
        return PointZoomBBConverter(
            pt_x=self.pt_x + HighPrecision(dx),
            pt_y=self.pt_y + HighPrecision(dy),
            zoom_factor=self.zoom_factor)

    def square_aspect_ratio(self, scrn_width: int, scrn_height: int):
        """Expand the narrower axis so pixel aspect is square
        (reference cpp:271-330: grows the box, never shrinks)."""
        if scrn_width == 0 or scrn_height == 0:
            return self
        ratio = HighPrecision(scrn_width) / HighPrecision(scrn_height)
        width = self.max_x - self.min_x
        height = self.max_y - self.min_y
        mwidth = width / ratio
        two = HighPrecision(2)
        if height > mwidth:
            adjust = ratio * (height - mwidth) / two
            return PointZoomBBConverter(
                min_x=self.min_x - adjust, max_x=self.max_x + adjust,
                min_y=self.min_y, max_y=self.max_y)
        elif mwidth > height:
            adjust = (mwidth - height) / two
            return PointZoomBBConverter(
                min_x=self.min_x, max_x=self.max_x,
                min_y=self.min_y - adjust, max_y=self.max_y + adjust)
        return self

    def with_precision(self, prec: int) -> "PointZoomBBConverter":
        return PointZoomBBConverter(
            min_x=self.min_x.with_precision(prec),
            min_y=self.min_y.with_precision(prec),
            max_x=self.max_x.with_precision(prec),
            max_y=self.max_y.with_precision(prec))

    def __repr__(self):
        return (f"PointZoomBBConverter(pt=({self.pt_x.to_string(20)}, "
                f"{self.pt_y.to_string(20)}), zoom={self.zoom_factor.to_string(8)})")
