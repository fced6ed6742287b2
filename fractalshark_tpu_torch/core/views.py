"""Built-in view presets (33 views mirroring the reference's
``FractalSharkLib/FractalViewPresets.cpp``; coordinate data extracted to
``fractalshark_tpu_torch/data/views.json``, a copy of the JAX package's
``fractalshark_tpu/data/views.json`` written by ``tools/extract_views.py``).

View #0 = home view (center 0,0, zoom 1).  View #5 = the standard
perturbation benchmark.  View #30 = zoom 1.367e114514 / 200M iterations
(the GPU-reference-orbit north-star benchmark).  View #32 = 10^244240.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from functools import lru_cache
from importlib import resources

from fractalshark_tpu_torch.core.highprecision import HighPrecision
from fractalshark_tpu_torch.core.pointzoom import PointZoomBBConverter
from fractalshark_tpu_torch.core.precision import precision_from_view

DEFAULT_ITERATIONS = 256


@dataclass
class ViewPreset:
    index: int
    ptz: PointZoomBBConverter
    num_iterations: int = DEFAULT_ITERATIONS
    antialiasing: int = 1
    iter_type_bits: int = 32
    la_defaults_max_perf: bool = False
    compression_error_exp_low: int | None = None
    extra: dict = field(default_factory=dict)


@lru_cache(maxsize=1)
def _raw_views() -> dict:
    data = resources.files("fractalshark_tpu_torch.data")
    with data.joinpath("views.json").open() as f:
        return json.load(f)["views"]


def num_views() -> int:
    return len(_raw_views())


@lru_cache(maxsize=None)
def get_view_preset(index: int,
                    default_iterations: int = DEFAULT_ITERATIONS) -> ViewPreset:
    raw = _raw_views().get(str(index))
    if raw is None:
        raise KeyError(f"no such view preset: {index}")
    # Precision: parse at generous precision, then round to what the zoom
    # actually needs (the reference parses at 1M bits then SetPrecision).
    if raw["kind"] == "ptz":
        zoom = HighPrecision(raw["zoom"], prec=64)
        # bits needed ≈ |exp2(1/zoom)| + margin
        prec = max(64, abs(zoom.exponent2()) + 192)
        ptz = PointZoomBBConverter(
            pt_x=HighPrecision(raw["pt_x"], prec=prec),
            pt_y=HighPrecision(raw["pt_y"], prec=prec),
            zoom_factor=HighPrecision(raw["zoom"], prec=prec))
    else:
        # bounding box: first parse at a precision generous enough for the
        # longest coordinate string (≈3.33 bits/digit), then derive the
        # actual requirement from the extent.
        prec0 = max(2048, 4 * max(len(raw[k]) for k in
                                  ("min_x", "min_y", "max_x", "max_y")))
        lo = PointZoomBBConverter(
            min_x=HighPrecision(raw["min_x"], prec=prec0),
            min_y=HighPrecision(raw["min_y"], prec=prec0),
            max_x=HighPrecision(raw["max_x"], prec=prec0),
            max_y=HighPrecision(raw["max_y"], prec=prec0))
        prec = precision_from_view(lo) + 64
        ptz = PointZoomBBConverter(
            min_x=HighPrecision(raw["min_x"], prec=prec),
            min_y=HighPrecision(raw["min_y"], prec=prec),
            max_x=HighPrecision(raw["max_x"], prec=prec),
            max_y=HighPrecision(raw["max_y"], prec=prec))
    return ViewPreset(
        index=index,
        ptz=ptz,
        num_iterations=raw.get("num_iterations", default_iterations),
        antialiasing=raw.get("antialiasing", 1),
        iter_type_bits=raw.get("iter_type", 32),
        la_defaults_max_perf=raw.get("la_defaults_max_perf", False),
        compression_error_exp_low=raw.get("compression_error_exp_low"),
    )
