"""The BLA names end to end on the CPU (``device="cpu"``, K15's plain
twin): each of the six through ``Fractal`` against the JAX package's
``Fractal`` at 8² on the 1e8 frame, grid and public dtype, and one
through the CLI (its route and the table's build time in the stats).
The smoke's 256² BLA pins are held to the JAX CLI in
``test_torch_family_pins.py``.
"""

import zlib

import pytest

import test_torch_jaxref as ref
from test_torch_families import (DEEP, DEEP_BUDGET, SIZE, _cli, check_grid,
                                 jax_grids, render)

NAMES = {name: (DEEP, DEEP_BUDGET, route) for name, route in (
    ("Cpu64PerturbedBLA", "bla-f64"), ("Cpu32PerturbedBLAHDR", "bla-f32"),
    ("Cpu64PerturbedBLAHDR", "bla-f64"), ("Gpu1x64PerturbedBLA", "bla-f64"),
    ("GpuHDRx32PerturbedBLA", "bla-f32"),
    ("GpuHDRx64PerturbedBLA", "bla-f64"))}


def _jax_reference(_inputs):
    return jax_grids(NAMES)


@pytest.fixture(scope="module")
def jax_ref(tmp_path_factory):
    return ref.run_jax_reference("test_torch_families_bla", "_jax_reference",
                                 tmp_path_factory.mktemp("families_bla"))


@pytest.mark.parametrize("name", list(NAMES))
def test_bla_name_renders_as_jax(jax_ref, name):
    frame, n, route = NAMES[name]
    f = render(name, frame, n)
    check_grid(f, jax_ref[name], route)
    assert f.benchmark.extra["bla_build_s"] >= 0


def test_bla_cli_frame_equals_jax(jax_ref):
    name = "GpuHDRx32PerturbedBLA"
    x, y, zoom = DEEP
    s = _cli(["--center-x", x, "--center-y", y, "--zoom", zoom,
              "--iterations", str(DEEP_BUDGET), "--render-algorithm", name,
              "--width", str(SIZE), "--height", str(SIZE)])
    want = jax_ref[name]
    assert s["iter_sum"] == int(want.sum())
    assert s["crc32"] == zlib.crc32(want.astype("<u4").tobytes())
    assert s["kernel"] == "bla-f32"
    assert "bla_build_s" in s["timings"] and "perturb_s" in s["timings"]

