"""Required-precision derivation from view extent.

Mirrors reference ``PrecisionCalculator::GetPrecision``
(``FractalSharkLib/PrecisionCalculator.cpp:57-109``): precision (bits) =
max(|exp2(radiusX)|, |exp2(radiusY)|) + extra, where extra is 120 bits
normally and 800 bits when the orbit must support perturbed-perturbation
reuse (``HpSharkFloatLib/HighPrecision.h:559-563``).
"""

from __future__ import annotations

from fractalshark_tpu_torch.core.highprecision import HighPrecision
from fractalshark_tpu_torch.core.pointzoom import PointZoomBBConverter

AUTHORITATIVE_MIN_EXTRA_PRECISION_BITS = 120
AUTHORITATIVE_REUSE_EXTRA_PRECISION_BITS = 800


def precision_from_radii(radius_x: HighPrecision, radius_y: HighPrecision,
                         requires_reuse: bool = False) -> int:
    ex = abs(radius_x.exponent2()) if not radius_x.is_zero() else 0
    ey = abs(radius_y.exponent2()) if not radius_y.is_zero() else 0
    larger = max(ex, ey)
    if requires_reuse:
        return larger + AUTHORITATIVE_REUSE_EXTRA_PRECISION_BITS
    return larger + AUTHORITATIVE_MIN_EXTRA_PRECISION_BITS


def precision_from_view(ptz: PointZoomBBConverter,
                        requires_reuse: bool = False) -> int:
    delta_x = abs(ptz.max_x - ptz.min_x)
    delta_y = abs(ptz.max_y - ptz.min_y)
    return precision_from_radii(delta_x, delta_y, requires_reuse)
