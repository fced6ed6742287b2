"""The port's counterpart of ``tests/test_integration.py::
test_golden_crc_view5_class_render``: ``GpuHDRx64PerturbedLAv2`` on the
integration sweep's 1e8 frame at 32² × 1,500.  Its golden,
``GOLDEN_LAV2_DEEP``, was taken on a CPU build that contracts FMAs; the
port is held to the JAX package with FMA off (``run_jax_reference``),
whose CRC-32 of the grid (as ``<u4``) is ``GOLDEN_LAV2_DEEP_NOFMA``.
The port's ``Fractal`` and its CLI, on the CPU (the kernels' plain
twins), give that CRC.
"""

import contextlib
import io
import json
import zlib

import numpy as np
import pytest

import test_torch_jaxref as ref
from fractalshark_tpu_torch import cli
from fractalshark_tpu_torch.engine.fractal import Fractal

NAME, SIZE, BUDGET = "GpuHDRx64PerturbedLAv2", 32, 1500
DEEP = ("-0.743643887037158704752191506114774",
        "0.131825904205311970493132056385139", "1e8")
# the JAX package's CRC of this frame with FMA contraction off
GOLDEN_LAV2_DEEP_NOFMA = 3_725_720_663


def _ptz(pkg):
    x, y, zoom = DEEP
    return ref.host_layer(pkg).PointZoomBBConverter(
        pt_x=x, pt_y=y, zoom_factor=zoom, prec=512)


def crc(grid) -> int:
    return zlib.crc32(np.asarray(grid).astype("<u4").tobytes())


def _jax_reference(_inputs):
    """The integration test's render, as it makes it."""
    from fractalshark_tpu.engine.fractal import Fractal as JFractal

    f = JFractal(width=SIZE, height=SIZE, view=_ptz("fractalshark_tpu"),
                 algorithm=NAME, num_iterations=BUDGET, backend="cpu")
    return {"grid": np.asarray(f.calc_fractal())}


@pytest.fixture(scope="module")
def jax_ref(tmp_path_factory):
    return ref.run_jax_reference("test_torch_golden_lav2", "_jax_reference",
                                 tmp_path_factory.mktemp("golden_lav2"))


def test_jax_crc_with_fma_off_is_the_recorded_one(jax_ref):
    grid = jax_ref["grid"]
    assert grid.shape == (SIZE, SIZE) and grid.dtype == np.uint32
    assert crc(grid) == GOLDEN_LAV2_DEEP_NOFMA


def test_fractal_gives_the_jax_crc(jax_ref):
    f = Fractal(width=SIZE, height=SIZE, view=_ptz("fractalshark_tpu_torch"),
                algorithm=NAME, num_iterations=BUDGET, device="cpu")
    f.calc_fractal()
    got = f.iters_numpy()
    np.testing.assert_array_equal(got, jax_ref["grid"])
    assert crc(got) == GOLDEN_LAV2_DEEP_NOFMA


def test_cli_gives_the_jax_crc(jax_ref):
    x, y, zoom = DEEP
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert cli.main(["--center-x", x, "--center-y", y, "--zoom", zoom,
                         "--iterations", str(BUDGET), "--render-algorithm",
                         NAME, "--width", str(SIZE), "--height", str(SIZE),
                         "--stats", "--device", "cpu"]) == 0
    s = json.loads(buf.getvalue().strip().splitlines()[-1])
    want = jax_ref["grid"]
    assert s["algorithm"] == NAME
    assert (s["iter_sum"], s["crc32"]) == (int(want.sum()),
                                           GOLDEN_LAV2_DEEP_NOFMA)
