"""fractalshark_tpu_torch — the PyTorch + CUDA port of fractalshark_tpu.

The deep-zoom render path (reference orbit → LA table → LAv2 phase 1 →
perturbation tail → colour) runs here on an NVIDIA H100 through
hand-written CUDA kernels (``csrc/``), with a plain PyTorch twin of
every kernel for CPU tensors.  The JAX package stays the reference.

The host layer (high-precision view maths, the native GMP reference
orbit, the LA table builder, presets, palette, PNG writer) is the
port's own copy of the JAX package's jax-free modules, under the same
sub-package names (``core/``, ``io/``, ``utils/``, ``engine/``).  The
port imports neither jax nor ``fractalshark_tpu``.
"""

from fractalshark_tpu_torch.core.highprecision import HighPrecision
from fractalshark_tpu_torch.core.pointzoom import PointZoomBBConverter

__version__ = "0.1.0"

__all__ = ["HighPrecision", "PointZoomBBConverter", "__version__"]
