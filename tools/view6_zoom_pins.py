#!/usr/bin/env python3
"""The JAX package's frames of ``chip_smoke.py`` phase 20's zoom sequence:
View #6 at ``ZOOM_SIZE``² and the preset's budget, ``ZOOM_FRAMES`` frames
at ``zoomed_at_center(1 / ZOOM_STEP^(N-1-k))`` against one orbit and the
one LA table of the final radius (``tools/zoomseq_view30.py``'s
composition: ``la_perturb_render(la_only, return_state)``, then
``perturb_render_stream_rc`` over identity anchors, in interpret mode).

    python3 tools/view6_zoom_pins.py

The JAX package runs on the CPU with FMA contraction off, in a
subprocess (``tests/test_torch_jaxref.run_jax_reference``), through
``tests/test_torch_view30_sequence.py`` ``_view6_zoom_pins``.  It writes
``artifacts/view6_zoom_pins.json``: each frame's (iter_sum, CRC-32 of the
grid as <u4), the pins ``chip_smoke.py`` keeps as ``ZOOM_PINS`` (the last
frame's is ``VIEW6_64``), and the seconds it took; it prints the JSON.
"""

import json
import os
import sys
import tempfile
import time
import zlib

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ART = os.path.join(ROOT, "artifacts")


def main() -> int:
    sys.path[:0] = [ROOT, os.path.join(ROOT, "tests")]
    import chip_smoke as cs
    import test_torch_jaxref as ref
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        out = ref.run_jax_reference("test_torch_view30_sequence",
                                    "_view6_zoom_pins", tmp, timeout=3600)
    grids = out["grids"].astype(np.int64)
    rec = {"view": cs.ZOOM_VIEW, "size": cs.ZOOM_SIZE,
           "frames": cs.ZOOM_FRAMES, "step": cs.ZOOM_STEP,
           "budget": int(out["budget"]), "period": int(out["period"]),
           "pins": [[int(g.sum()), zlib.crc32(g.astype("<u4").tobytes())]
                    for g in grids],
           "wall_s": round(time.perf_counter() - t0, 1),
           "jax": "CPU, FMA contraction off (--xla_cpu_max_isa=AVX)"}
    rec["last_equals_view6_64"] = tuple(rec["pins"][-1]) == cs.VIEW6_64
    with open(os.path.join(ART, "view6_zoom_pins.json"), "w") as f:
        json.dump(rec, f, indent=1)
        f.write("\n")
    print(json.dumps(rec))
    return 0


if __name__ == "__main__":
    sys.exit(main())
