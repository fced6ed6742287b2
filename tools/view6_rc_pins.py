#!/usr/bin/env python3
"""Print the JAX package's (iter_sum, CRC-32 of the grid as <u4) of
View #6 through ``GpuHDRx32PerturbedRCLAv2`` at 256², its gather tail in
both modes: "f64" (the gather tail of K19) and "df32" (which the JAX
package's own tests pin bit for bit to the sweep, the tail of K3).

    python3 tools/view6_rc_pins.py

The JAX package runs on the CPU with FMA contraction off, in a
subprocess (``tests/test_torch_jaxref.run_jax_reference``), through
``tests/test_torch_rc_fast.py`` ``_view6_rc_pins``: the LA phase of its
two-phase render, then ``rc_tail_gather`` over the orbit compressed as
the CLI compresses it (``error_exp`` 20).  ``chip_smoke.py`` keeps the
values beside its pins (``VIEW6_RC_256_GATHER``).  Several minutes on
the CPU.
"""

import json
import os
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    import test_torch_jaxref as ref
    with tempfile.TemporaryDirectory() as tmp:
        out = ref.run_jax_reference("test_torch_rc_fast", "_view6_rc_pins",
                                    tmp, timeout=3600)
    print(json.dumps({k: [int(x) for x in v] for k, v in out.items()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
