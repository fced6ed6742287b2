"""K1's plain twin (``fractalshark_tpu_torch/ops/escape.py``) against the
JAX package: f32 against the Pallas ``escape_pallas`` (interpret mode),
f64 against ``escape_jax``, bit for bit; and the f64 golden CRC of
``tests/test_escape.py``.  The f32 budget is the f32 value of the budget
below 2^31 (ROADMAP C1: 2^24 + 1 runs as 2^24, as ``escape_pallas``
reads it), and ``escape_jax``'s loop from 2^31; the grid's public dtype
follows each route of the reference (ROADMAP C2).
"""

import zlib

import numpy as np
import pytest
import torch

import test_torch_jaxref as ref
from fractalshark_tpu_torch.core.views import get_view_preset
from fractalshark_tpu_torch.engine.fractal import Fractal, public_dtype
from fractalshark_tpu_torch.ops import escape

GOLDEN_ESCAPE_VIEW0_256 = 3586676062  # tests/test_escape.py:111

CASES = {  # name: (width, height, budget, dtype)
    "f32_64x48": (64, 48, 200, "f32"),
    "f32_57x43": (57, 43, 64, "f32"),
    "f64_64x48": (64, 48, 200, "f64"),
}


# ROADMAP C1: an 8x8 frame inside the main cardioid at a budget f32 cannot
# hold (2^24 + 1), and an all-escaping f32 frame past 2^31
C1_FRAME = escape.PlainParams(min_x=-0.11, max_y=0.01, dx=0.0025, dy=0.0025)
C1_BUDGET = (1 << 24) + 1
FAR_FRAME = escape.PlainParams(min_x=2.0, max_y=2.5, dx=0.125, dy=0.125)
FAR_BUDGET = (1 << 31) + 5


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
    c1 = jesc.PlainParams(C1_FRAME.min_x, C1_FRAME.max_y, C1_FRAME.dx,
                          C1_FRAME.dy)
    out["c1"] = np.asarray(jesc.escape_pallas(
        c1, 8, 8, C1_BUDGET, dtype=jnp.float32, tile_h=8, tile_w=128,
        interpret=True))
    far = jesc.PlainParams(FAR_FRAME.min_x, FAR_FRAME.max_y, FAR_FRAME.dx,
                           FAR_FRAME.dy)
    out["far"] = np.asarray(jesc.escape_jax(far, 8, 8, FAR_BUDGET,
                                            dtype=jnp.float32))
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


def test_c1_f32_budget_is_the_f32_value(jax_ref):
    """ROADMAP C1: every capped pixel gives 2^24, as escape_pallas (its
    f32 table) and the sequence give."""
    got = escape.escape(C1_FRAME, 8, 8, C1_BUDGET, dtype="f32",
                        device="cpu").numpy()
    assert (got == 1 << 24).all()
    np.testing.assert_array_equal(got, jax_ref["c1"].astype(np.int64))
    seq = escape.escape_sequence([C1_FRAME], 8, 8, C1_BUDGET, device="cpu")
    np.testing.assert_array_equal(got, seq[0].astype(np.int64))


def test_f32_past_2_31_runs_escape_jax(jax_ref):
    """From a budget of 2^31 the reference sends f32 to escape_jax."""
    assert not escape.tile_semantics(FAR_BUDGET, torch.float32)
    got = escape.escape(FAR_FRAME, 8, 8, FAR_BUDGET, dtype="f32",
                        device="cpu").numpy()
    np.testing.assert_array_equal(got, jax_ref["far"].astype(np.int64))


C2_CASES = [  # (route, budget, dtype of the reference's grid)
    ("escape", (1 << 31) - 1, np.uint32), ("escape", 1 << 31, np.uint32),
    ("escape", (1 << 32) - 1, np.uint32), ("escape", 1 << 32, np.uint64),
    ("lav2-two-phase", (1 << 31) - 1, np.uint32),
    ("lav2-two-phase", 1 << 31, np.uint64), ("lav2-f64", 1 << 31, np.uint64),
    ("perturb-stream", 1 << 31, np.uint64),
    ("perturb-hdr64", 1 << 32, np.uint32), ("perturb-pallas", 1 << 31,
                                            np.uint32),
]


@pytest.mark.parametrize("route,budget,want", C2_CASES,
                         ids=[f"{r}-{b}" for r, b, _ in C2_CASES])
def test_c2_public_dtype_follows_the_route(route, budget, want):
    assert public_dtype(route, budget) is want


def test_c2_iters_numpy_of_a_direct_frame():
    """A direct frame at a budget in [2^31, 2^32) is uint32 at the public
    boundary (the reference's escape_jax), values unchanged."""
    f = Fractal(width=4, height=2, num_iterations=1 << 31, device="cpu")
    f.benchmark.extra["kernel"] = "escape"
    iters = torch.tensor([[0, 1, 5, (1 << 31) - 1]] * 2, dtype=torch.int64)
    got = f.iters_numpy(iters)
    assert got.dtype == np.uint32
    np.testing.assert_array_equal(got, iters.numpy())
    f.benchmark.extra["kernel"] = "lav2-two-phase"
    assert f.iters_numpy(iters).dtype == np.uint64


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


@pytest.mark.cuda
def test_c1_kernel_runs_the_f32_budget_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    got = escape.escape(C1_FRAME, 8, 8, C1_BUDGET, dtype="f32",
                        device="cuda")
    assert (got.cpu() == 1 << 24).all()
    far = escape.escape(FAR_FRAME, 8, 8, FAR_BUDGET, dtype="f32",
                        device="cuda")
    assert torch.equal(far.cpu(), escape.escape_plain(
        FAR_FRAME, 8, 8, FAR_BUDGET, torch.float32, "cpu"))
