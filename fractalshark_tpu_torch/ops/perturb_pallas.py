"""The HDR-f32 perturbation render for short orbits and small budgets:
the port of ``fractalshark_tpu/ops/perturb_pallas.py``
(``perturb_render_pallas``, B10) through kernel K6 (``csrc/perturb.cu``,
``ops/perturb.py``).

The reference keeps the whole orbit in VMEM as [R, 128] rows and
gathers Z[j] by masked row selects, so it takes orbits of at most
64 × 128 = 8,192 entries, and it runs one unbounded dispatch, so it
takes budgets of at most 200,000 (``perturb_pallas.py:144-154``).  K6
gathers from device memory and relaunches in bounded chunks, so it has
neither limit; the caps stay here so that the routing reads as in the
reference (``engine/renderers.py``): past them this returns None and the
caller takes the streaming route (``perturb_stream.perturb_render_stream``,
B11), which is the same K6 instance.
"""

from __future__ import annotations

import numpy as np

from fractalshark_tpu_torch.core.pointzoom import PointZoomBBConverter
from fractalshark_tpu_torch.ops.perturb import perturb_render_hdr

LANE = 128
MAX_ORBIT_ROWS = 64  # the reference's VMEM orbit cap: 64×128 = 8192 entries
MAX_BUDGET = 200_000


def perturb_render_pallas(results, ptz: PointZoomBBConverter, width: int,
                          height: int, max_iter: int, tile_h: int = 64,
                          chunk_steps: int | None = None, abort_monitor=None,
                          device="cuda"):
    """HDR-f32 perturbation render (B10's route); None past the
    reference's caps.  `tile_h` is the reference's pixel-tile height and
    has no role on the card (K6 runs one thread per pixel).  Returns the
    int64 iteration grid."""
    count = results.count_orbit_entries() + 1  # + wraparound entry
    if -(-count // LANE) > MAX_ORBIT_ROWS or max_iter > MAX_BUDGET:
        return None
    return perturb_render_hdr(results, ptz, width, height, max_iter,
                              np.float32, chunk_steps, abort_monitor, device,
                              key="perturb_pallas")
