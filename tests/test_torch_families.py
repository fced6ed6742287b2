"""The direct escapes (HDR, double-float, CpuHigh) and the Scaled names
end to end on the CPU (``device="cpu"``, the kernels' plain twins):
``Fractal`` and the CLI against the JAX package's ``Fractal`` at 8², grid
and public dtype, on the integration sweep's frames, and the smoke's 256²
pins of these families against the JAX CLI.  The BLA names are in
``test_torch_families_bla.py``, the quad-float names in
``test_torch_quad.py``.
"""

import contextlib
import io
import json

import numpy as np
import pytest

import test_torch_jaxref as ref
from fractalshark_tpu_torch import cli
from fractalshark_tpu_torch.engine.fractal import Fractal

SIZE = 8
SHALLOW, SHALLOW_BUDGET = ("-0.6", "0.45", "64"), 256
DEEP, DEEP_BUDGET = ("-0.743643887037158704752191506114774",
                     "0.131825904205311970493132056385139", "1e8"), 1500
# name: (frame, budget, the route's kernel name)
NAMES = {
    "CpuHDR32": (SHALLOW, SHALLOW_BUDGET, "escape-hdr32"),
    "CpuHDR64": (SHALLOW, SHALLOW_BUDGET, "escape-hdr64"),
    "GpuHDRx32": (SHALLOW, SHALLOW_BUDGET, "escape-hdr32"),
    "Gpu2x32": (SHALLOW, SHALLOW_BUDGET, "escape-2x32"),
    "Gpu2x64": (SHALLOW, SHALLOW_BUDGET, "escape-2x64"),
    "CpuHigh": (SHALLOW, SHALLOW_BUDGET, "cpu-high"),
    "Gpu1x32PerturbedScaled": (DEEP, DEEP_BUDGET, "scaled"),
    "Gpu2x32PerturbedScaled": (DEEP, DEEP_BUDGET, "scaled"),
    "GpuHDRx32PerturbedScaled": (DEEP, DEEP_BUDGET, "scaled"),
}
# the smoke's 256² pins this file holds to the JAX CLI (the BLA ones:
# test_torch_families_bla.py)
PINNED = ("CpuHDR32", "CpuHDR64", "GpuHDRx32", "Gpu2x32", "Gpu2x64",
          "Gpu1x32PerturbedScaled")


def _ptz(frame, pkg="fractalshark_tpu_torch"):
    x, y, zoom = frame
    return ref.host_layer(pkg).PointZoomBBConverter(
        pt_x=x, pt_y=y, zoom_factor=zoom, prec=512)


def jax_pins(names) -> dict:
    """The JAX CLI's (iter_sum, CRC-32) of the smoke's 256² frames."""
    import chip_smoke as cs
    from test_torch_slice import _jax_cli_with_crc

    out = {}
    for name in names:
        argv, _, _ = cs.FAMILY_PINS[name]
        s = _jax_cli_with_crc(argv + ["--render-algorithm", name, "--width",
                                      "256", "--height", "256"])
        out["pin_" + name] = np.asarray([s["iter_sum"], s["crc32"]])
    return out


def jax_grids(names: dict) -> dict:
    """The JAX package's 8² grid of each name of `names` (name: (frame,
    budget, route)), and the Scaled names' glitch stats."""
    from fractalshark_tpu.engine.fractal import Fractal as JFractal

    out = {}
    for name, (frame, n, _) in names.items():
        f = JFractal(width=SIZE, height=SIZE, view=_ptz(frame,
                                                        "fractalshark_tpu"),
                     algorithm=name, num_iterations=n, backend="cpu")
        out[name] = np.asarray(f.calc_fractal())
        for k in ("glitched_pixels", "bad_entries"):
            if k in f.benchmark.extra:
                out[f"{name}_{k}"] = np.asarray(f.benchmark.extra[k])
    return out


def _jax_reference(_inputs):
    out = jax_grids(NAMES)
    out.update(jax_pins(PINNED))
    return out


@pytest.fixture(scope="module")
def jax_ref(tmp_path_factory):
    return ref.run_jax_reference("test_torch_families", "_jax_reference",
                                 tmp_path_factory.mktemp("families"))


def render(name, frame, n):
    f = Fractal(width=SIZE, height=SIZE, view=_ptz(frame), algorithm=name,
                num_iterations=n, device="cpu")
    f.calc_fractal()
    return f


def check_grid(f, want, route):
    got = f.iters_numpy()
    assert got.dtype == want.dtype, (got.dtype, want.dtype)
    np.testing.assert_array_equal(got, want)
    assert f.benchmark.extra["kernel"] == route
    assert 0 < int(got.max())


@pytest.mark.parametrize("name", list(NAMES))
def test_family_name_renders_as_jax(jax_ref, name):
    frame, n, route = NAMES[name]
    f = render(name, frame, n)
    check_grid(f, jax_ref[name], route)
    for k in ("glitched_pixels", "bad_entries"):
        if route == "scaled":
            assert f.benchmark.extra[k] == int(jax_ref[f"{name}_{k}"])


def _cli(argv) -> dict:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert cli.main(argv + ["--stats", "--device", "cpu"]) == 0
    return json.loads(buf.getvalue().strip().splitlines()[-1])


@pytest.mark.parametrize("name", ["CpuHDR64", "Gpu2x32",
                                  "GpuHDRx32PerturbedScaled"])
def test_cli_frame_equals_jax(jax_ref, name):
    """Through the CLI: the stats of the JAX grid, the route's kernel."""
    import zlib

    frame, n, route = NAMES[name]
    x, y, zoom = frame
    s = _cli(["--center-x", x, "--center-y", y, "--zoom", zoom,
              "--iterations", str(n), "--render-algorithm", name,
              "--width", str(SIZE), "--height", str(SIZE)])
    want = jax_ref[name]
    assert (s["iter_sum"], s["iter_min"], s["iter_max"]) == (
        int(want.sum()), int(want.min()), int(want.max()))
    assert s["crc32"] == zlib.crc32(want.astype("<u4").tobytes())
    assert s["kernel"] == route and s["algorithm"] == name
    assert "perturb_s" in s["timings"] or route != "scaled"


def test_smoke_pins_equal_jax(jax_ref):
    """The values chip_smoke.py phase 14 holds these frames to on the
    card are the JAX package's."""
    import chip_smoke as cs
    for name in PINNED:
        assert tuple(jax_ref["pin_" + name]) == cs.FAMILY_PINS[name][2], name
