"""fractalshark_tpu_torch — the PyTorch + CUDA port of fractalshark_tpu.

The deep-zoom render path (reference orbit → LA table → LAv2 phase 1 →
perturbation tail → colour) runs here on an NVIDIA H100 through
hand-written CUDA kernels (``csrc/``), with a plain PyTorch twin of
every kernel for CPU tensors.  The JAX package stays the reference.

The host layer (high-precision view maths, the native GMP reference
orbit, the LA table builder, presets, palette, PNG writer) is imported
from ``fractalshark_tpu`` unchanged.  That package imports jax at import
time unless both switches below are set, so they are set (as defaults,
never overriding a caller's choice) before the first
``fractalshark_tpu`` import.  The port itself never imports jax.
"""

import os

os.environ.setdefault("FRACTALSHARK_NO_X64", "1")
os.environ.setdefault("FRACTALSHARK_NO_COMPILE_CACHE", "1")

from fractalshark_tpu.core.highprecision import HighPrecision  # noqa: E402
from fractalshark_tpu.core.pointzoom import PointZoomBBConverter  # noqa: E402

__version__ = "0.1.0"

__all__ = ["HighPrecision", "PointZoomBBConverter", "__version__"]
