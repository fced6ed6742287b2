#!/usr/bin/env python3
"""The JAX package's View #23 frame at 32² and the preset's budget
(51,539,607,504) through the endurance composition, the pins of
``tools/run_view27_torch.py --view 23 --size 32``: the native session
(compressed, ``error_exp`` 20) → ``generate_native_rc_streamed`` into
memmaps → ``load_dir`` → ``VirtualResults`` → ``two_phase_render``
through the gather tail in its f64 mode, and its ``rc_tail_gather`` with
``mode="df32"`` on the same handoff (one phase 1 for both).

    python3 tools/view23_rc_pins.py

The JAX package runs on the CPU with FMA contraction off, in a
subprocess (``tests/test_torch_jaxref.run_jax_reference``), through
``tests/test_torch_view27_pipeline.py`` ``_view23_rc_pins``.  It writes
``artifacts/view23_rc_iters.npy`` (f64) and ``view23_rc_iters_df32.npy``
(int64 [32, 32] each) and ``artifacts/view23_rc_pins.json``: the period,
the anchor count and the CRC-32 of the three anchor arrays, the LA
node count, stages and ``stage_macro_it_count``, each grid's (iter_sum,
CRC-32 as <u8), the f64/df32 flip count, the seconds of each step; and
the mini location's (iter_sum, CRC-32) in both modes, which
``chip_smoke.py`` keeps as ``MINI_RC_PINS``.  It prints the JSON.  About
10 minutes on an 8-core CPU.
"""

import json
import os
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ART = os.path.join(ROOT, "artifacts")


def main() -> int:
    sys.path[:0] = [ROOT, os.path.join(ROOT, "tests")]
    import test_torch_jaxref as ref
    import test_torch_view27_pipeline as vp
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        out = ref.run_jax_reference("test_torch_view27_pipeline",
                                    "_view23_rc_pins", tmp, timeout=3600)
    wall = time.perf_counter() - t0
    status, total, n_anchors, crc, prec, budget = (
        int(x) for x in out["orbit"])
    grids = {m: out[f"iters_{m}"].astype(np.int64) for m in vp.MODES}
    np.save(os.path.join(ART, "view23_rc_iters.npy"), grids["f64"])
    np.save(os.path.join(ART, "view23_rc_iters_df32.npy"), grids["df32"])
    stage_count, use_at, at_step, n_nodes = (int(x) for x in out["la_meta"])
    rec = {
        "view": vp.VIEW23, "size": vp.SIZE23, "budget": budget,
        "prec_bits": prec, "orbit_status": status, "period": total,
        "n_anchors": n_anchors, "anchors_crc32": crc,
        "la_nodes": n_nodes, "la_stages": stage_count,
        "stage_la_index": [int(x) for x in out["la_stage_index"]],
        "stage_macro_it_count": [int(x) for x in out["la_stage_macro"]],
        "use_at": bool(use_at), "at_step": at_step,
        "grids": {m: dict(zip(("iter_sum", "crc32"), vp.rv.grid_pin(g)),
                          iter_min=int(g.min()), iter_max=int(g.max()),
                          capped_px=int((g >= budget).sum()))
                  for m, g in grids.items()},
        "flips_f64_df32": int((grids["f64"] != grids["df32"]).sum()),
        "mini": {m: [int(x) for x in out[f"mini_{m}"]] for m in vp.MODES},
        "seconds": dict(zip(("orbit", "la_build", "render",
                             "tail_f64", "tail_df32"),
                            (round(float(x), 1) for x in out["seconds"]))),
        "wall_s": round(wall, 1),
        "jax": "CPU, FMA contraction off (--xla_cpu_max_isa=AVX)"}
    with open(os.path.join(ART, "view23_rc_pins.json"), "w") as f:
        json.dump(rec, f, indent=1)
        f.write("\n")
    print(json.dumps(rec))
    return 0


if __name__ == "__main__":
    sys.exit(main())
