"""K1's plain twin (``fractalshark_tpu_torch/ops/escape.py``) against the
JAX package: f32 against the Pallas ``escape_pallas`` (interpret mode),
f64 against ``escape_jax``, bit for bit; and the f64 golden CRC of
``tests/test_escape.py``.
"""

import zlib

import numpy as np
import pytest
import torch

import test_torch_jaxref as ref
from fractalshark_tpu_torch.core.views import get_view_preset
from fractalshark_tpu_torch.ops import escape

GOLDEN_ESCAPE_VIEW0_256 = 3586676062  # tests/test_escape.py:111

CASES = {  # name: (width, height, budget, dtype)
    "f32_64x48": (64, 48, 200, "f32"),
    "f32_57x43": (57, 43, 64, "f32"),
    "f64_64x48": (64, 48, 200, "f64"),
}


def _params(width, height):
    ptz = get_view_preset(0).ptz.square_aspect_ratio(width, height)
    return escape.PlainParams.from_view(ptz, width, height)


def _jax_reference(_inputs):
    import jax.numpy as jnp

    from fractalshark_tpu.ops import escape as jesc

    out = {}
    for name, (w, h, n, dt) in CASES.items():
        p = _params(w, h)
        jp = jesc.PlainParams(p.min_x, p.max_y, p.dx, p.dy)
        if dt == "f32":
            g = jesc.escape_pallas(jp, w, h, n, dtype=jnp.float32,
                                   tile_h=16, tile_w=128, interpret=True)
        else:
            g = jesc.escape_jax(jp, w, h, n, dtype=jnp.float64)
        out[name] = np.asarray(g)
    p = _params(256, 256)
    out["golden"] = np.asarray(jesc.escape_jax(
        jesc.PlainParams(p.min_x, p.max_y, p.dx, p.dy), 256, 256, 256,
        dtype=jnp.float64))
    return out


@pytest.fixture(scope="module")
def jax_ref(tmp_path_factory):
    return ref.run_jax_reference("test_torch_escape", "_jax_reference",
                                 tmp_path_factory.mktemp("escape"))


@pytest.mark.parametrize("case", list(CASES))
def test_plain_escape_matches_jax(jax_ref, case):
    w, h, n, dt = CASES[case]
    got = escape.escape(_params(w, h), w, h, n, dtype=dt, device="cpu")
    assert got.dtype == torch.int64 and got.shape == (h, w)
    np.testing.assert_array_equal(got.numpy(), jax_ref[case].astype(np.int64))


def test_f64_golden_crc(jax_ref):
    got = escape.escape(_params(256, 256), 256, 256, 256, dtype="f64",
                        device="cpu").numpy()
    np.testing.assert_array_equal(got, jax_ref["golden"].astype(np.int64))
    assert zlib.crc32(got.astype("<u4").tobytes()) == GOLDEN_ESCAPE_VIEW0_256


def test_interior_shortcut_and_budget_cap():
    """f32: cardioid/bulb pixels take the budget without iterating; no
    count exceeds the budget; points outside radius 2 count 0."""
    p = escape.PlainParams(min_x=-2.5, max_y=1.5, dx=0.25, dy=0.25)
    got = escape.escape(p, 16, 12, 37, dtype="f32", device="cpu")
    assert int(got.max()) == 37 and int(got.min()) == 0
    # c = -0.5 + 0i (row 6, col 8) is inside the main cardioid
    assert int(got[6, 8]) == 37


def test_rejects_unported_precision():
    with pytest.raises(ValueError):
        escape.escape(_params(8, 8), 8, 8, 10, dtype=torch.float16,
                      device="cpu")


@pytest.mark.cuda
def test_kernel_matches_plain_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    p = _params(512, 512)
    for dt in (torch.float32, torch.float64):
        k = escape.escape(p, 512, 512, 256, dtype=dt, device="cuda")
        pl = escape.escape_plain(p, 512, 512, 256, dtype=dt, device="cuda")
        assert torch.equal(k, pl)
