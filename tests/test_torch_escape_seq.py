"""K1-seq's plain twin (``fractalshark_tpu_torch/ops/escape.py``
``escape_sequence``) against the JAX package's Pallas
``escape_pallas_sequence`` (interpret mode), bit for bit, in f32 and
f64; each frame against the port's single-frame f32 escape; the f32
budget's rounding (2^24 + 1 runs as 2^24, as the reference's
``.astype(int32)`` of its f32 table gives).
"""

import numpy as np
import pytest
import torch

import test_torch_jaxref as ref
from fractalshark_tpu_torch.core.views import get_view_preset
from fractalshark_tpu_torch.ops import escape

W, H = 64, 48
CASES = {  # name: (frames, budget, dtype)
    "f32_b100": (3, 100, "f32"),
    "f32_b256": (2, 256, "f32"),
    "f64_b100": (2, 100, "f64"),
    "f64_b256": (3, 256, "f64"),
}
BIG = (1 << 24) + 1
# a frame inside the main cardioid and one far outside |c| = 2
ROUNDING = [escape.PlainParams(-0.5, 0.1, 0.01, 0.01),
            escape.PlainParams(10.0, 10.0, 0.1, 0.1)]


def _frames(k):
    ptz = get_view_preset(0).ptz.square_aspect_ratio(W, H)
    return escape.zoom_sequence(escape.PlainParams.from_view(ptz, W, H),
                                W, H, k)


def _jax_reference(_inputs):
    import jax.numpy as jnp

    from fractalshark_tpu.ops import escape as jesc

    def jp(ps):
        return [jesc.PlainParams(p.min_x, p.max_y, p.dx, p.dy) for p in ps]

    out = {}
    for name, (k, n, dt) in CASES.items():
        out[name] = np.asarray(jesc.escape_pallas_sequence(
            jp(_frames(k)), W, H, n,
            dtype=jnp.float32 if dt == "f32" else jnp.float64,
            tile_h=16, tile_w=128, interpret=True))
    out["rounding"] = np.asarray(jesc.escape_pallas_sequence(
        jp(ROUNDING), 8, 8, BIG, dtype=jnp.float32, tile_h=8, tile_w=128,
        interpret=True))
    return out


@pytest.fixture(scope="module")
def jax_ref(tmp_path_factory):
    return ref.run_jax_reference("test_torch_escape_seq", "_jax_reference",
                                 tmp_path_factory.mktemp("escape_seq"))


@pytest.mark.parametrize("case", list(CASES))
def test_sequence_matches_jax(jax_ref, case):
    k, n, dt = CASES[case]
    got = escape.escape_sequence(_frames(k), W, H, n, dtype=dt, device="cpu")
    assert got.dtype == np.uint32 and got.shape == (k, H, W)
    np.testing.assert_array_equal(got, jax_ref[case])


@pytest.mark.parametrize("n", [100, 256])
def test_each_frame_equals_single_frame_f32(n):
    frames = _frames(3)
    seq = escape.escape_sequence(frames, W, H, n, device="cpu")
    for k, p in enumerate(frames):
        one = escape.escape(p, W, H, n, dtype="f32", device="cpu")
        np.testing.assert_array_equal(seq[k], one.numpy().astype(np.uint32))


def test_f32_budget_rounds_as_the_reference(jax_ref):
    got = escape.escape_sequence(ROUNDING, 8, 8, BIG, dtype="f32",
                                 device="cpu")
    np.testing.assert_array_equal(got, jax_ref["rounding"])
    assert escape.seq_budget(BIG, torch.float32) == 1 << 24
    assert escape.seq_budget(BIG, torch.float64) == BIG
    assert (got[0] == 1 << 24).all() and (got[1] == 0).all()


def test_refuses_budgets_of_2_31():
    with pytest.raises(ValueError, match="2\\^31"):
        escape.escape_sequence(ROUNDING, 8, 8, 1 << 31, device="cpu")


def test_needs_the_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        escape.escape_sequence(ROUNDING, 8, 8, 10)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [40, 300])
def test_kernel_matches_plain_on_card(n):
    """Both passes of K1-seq (a budget past the first pass's 64
    iterations) and the first alone (40), f32 and f64."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    frames = _frames(4)
    for dt in (torch.float32, torch.float64):
        k = escape.escape_sequence_kernel(frames, 256, 192, n, dt, "cuda")
        pl = escape.escape_sequence_plain(frames, 256, 192, n, dt, "cuda")
        assert torch.equal(k, pl)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [BIG, (1 << 31) - 1])
def test_kernel_budget_edges_on_card(n):
    """Budgets of 2^24 + 1 (f32: 2^24) and 2^31 - 1 on the rounding
    frames (a frame in the main cardioid, one far outside)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    for dt in (torch.float32, torch.float64):
        k = escape.escape_sequence_kernel(ROUNDING, 8, 8, n, dt, "cuda")
        pl = escape.escape_sequence_plain(ROUNDING, 8, 8, n, dt, "cuda")
        assert torch.equal(k, pl)
        assert (k[0] == escape.seq_budget(n, dt)).all()
