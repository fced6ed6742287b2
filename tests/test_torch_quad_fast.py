"""K17 4x64's exact fast path (``csrc/escape_quad.cu``): the facts it
rests on, on the CPU, and the kernel on frames that trip its guard, on
the card.

The fast path forms each two-product as one product and one FMA, which
gives exactly a·b − fl(a·b), and skips every flush; the guard admits an
iteration when every nonzero component of zx, zy, cx and cy has an
exponent in [-450, 500].  Above 2^-459 the twin's Dekker two-product in
its flushed f64 arithmetic (``ops/dblflt.py``) is that exact error, so
both give one value; below the range the flushed Dekker product is not
always exact, so the guard is needed.  The guard scalars
(``chip_smoke.QUAD_GUARD_SCALARS``) make a frame whose pixels' components
fall below the range on some iterations and not on others; the twin
on that frame equals the JAX package's ``_escape_qd_impl`` (FMA off),
and the ``cuda`` test holds K17 to the twin there.
"""

from fractions import Fraction

import numpy as np
import pytest
import torch

import chip_smoke as cs
import test_torch_jaxref as ref
from fractalshark_tpu_torch import kernels
from fractalshark_tpu_torch.ops import quadd
from fractalshark_tpu_torch.ops.dblflt import two_prod

GUARD_LO, GUARD_HI = -450, 500   # escape_quad.cu kGuardLo, kGuardHi
LATTICE_E = -459                 # the argument's bound: 2E - 104 = -1022
N_PAIRS = 4096
SIZE, BUDGET = cs.QUAD_GUARD_SIZE, cs.QUAD_GUARD_BUDGET


def _operands(seed, lo, hi):
    """N_PAIRS f64 pairs of random sign and 53-bit mantissa with
    exponents drawn from [lo, hi] (a sixteenth at each end), and a few
    signed zeros."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(2):
        e = rng.integers(lo, hi + 1, N_PAIRS)
        e[: N_PAIRS // 16] = lo
        e[N_PAIRS // 16: N_PAIRS // 8] = hi
        v = rng.uniform(1, 2, N_PAIRS) * np.exp2(e.astype(np.float64))
        v *= rng.choice([-1.0, 1.0], N_PAIRS)
        v[-4:] = [0.0, -0.0, 0.0, -0.0]
        out.append(v)
    return out


def _exact_errors(a, b):
    """The twin's Dekker two-product, and whether each error is exactly
    a·b − p (``fractions.Fraction``)."""
    p, e = two_prod(torch.from_numpy(a), torch.from_numpy(b))
    exact = [Fraction(float(x)) * Fraction(float(y)) - Fraction(float(q))
             == Fraction(float(r))
             for x, y, q, r in zip(a, b, p.tolist(), e.tolist())]
    return np.asarray(exact)


@pytest.mark.parametrize("lo,hi", [(LATTICE_E, GUARD_HI), (GUARD_LO,
                                                            GUARD_HI)])
def test_flushed_dekker_is_exact_across_the_guard_range(lo, hi):
    a, b = _operands(lo & 0xFFFF, lo, hi)
    assert _exact_errors(a, b).all()


def test_flushed_dekker_is_not_exact_below_the_range():
    """Pairs whose exponents sum to about -1,000 and below: the flushed
    partial products and errors are not the exact error (the FMA's)."""
    a, b = _operands(7, -560, LATTICE_E - 1)
    exact = _exact_errors(a, b)
    assert 0 < int((~exact).sum()) < N_PAIRS


def _admits(q: quadd.QD) -> torch.Tensor:
    """escape_quad.cu's guard on one four-component value."""
    ok = torch.ones_like(q.q0, dtype=torch.bool)
    for c in q:
        e = torch.frexp(c).exponent - 1
        ok &= (c == 0) | ((e >= GUARD_LO) & (e <= GUARD_HI))
    return ok


def _guard_counts(scal, size, n):
    """escape_qd_plain's loop on `scal` with the guard mirrored: each
    pixel's count, and the iterations the guard admits and refuses."""
    Q = quadd.QD
    shape = (size, size)

    def full(v):
        return torch.full(shape, v, dtype=torch.float64)

    min_x, max_y, dx, dy = (Q(*(full(scal[4 * i + k]) for k in range(4)))
                            for i in range(4))
    zero = full(0.0)
    xs = torch.arange(size, dtype=torch.float64)[None, :].expand(shape)
    ys = torch.arange(size, dtype=torch.float64)[:, None].expand(shape)
    cx = quadd.qd_add(min_x, quadd.qd_mul(dx, Q(xs, zero, zero, zero)))
    cy = quadd.qd_sub(max_y, quadd.qd_mul(dy, Q(ys, zero, zero, zero)))
    c_ok = _admits(cx) & _admits(cy)
    zx, zy = cx, cy
    it = torch.zeros(shape, dtype=torch.int64)
    admitted = torch.zeros(shape, dtype=torch.int64)
    refused = torch.zeros(shape, dtype=torch.int64)
    active = torch.ones(shape, dtype=torch.bool)
    for _ in range(n):
        ok = c_ok & _admits(zx) & _admits(zy)
        admitted += active & ok
        refused += active & ~ok
        zx2, zy2 = quadd.qd_sqr(zx), quadd.qd_sqr(zy)
        cont = active & ~(quadd.qd_add(zx2, zy2).q0 > 4.0)
        nzy = quadd.qd_add(quadd.qd_mul_pow2(quadd.qd_mul(zx, zy), 2.0), cy)
        nzx = quadd.qd_add(quadd.qd_sub(zx2, zy2), cx)
        zx = Q(*(torch.where(cont, a, o) for a, o in zip(nzx, zx)))
        zy = Q(*(torch.where(cont, a, o) for a, o in zip(nzy, zy)))
        it += cont
        active = cont
    return it, admitted, refused


def _jax_reference(_inputs):
    import jax.numpy as jnp

    from fractalshark_tpu.ops.quadd import _escape_qd_impl

    return {"guard": np.asarray(_escape_qd_impl(
        jnp.asarray(cs.QUAD_GUARD_SCALARS, jnp.float64),
        jnp.asarray(BUDGET, jnp.int32), SIZE, SIZE, jnp.float64))}


@pytest.fixture(scope="module")
def jax_ref(tmp_path_factory):
    return ref.run_jax_reference("test_torch_quad_fast", "_jax_reference",
                                 tmp_path_factory.mktemp("quad_fast"))


@pytest.fixture(scope="module")
def guard_twin():
    return quadd.escape_qd_plain(cs.QUAD_GUARD_SCALARS, SIZE, SIZE, BUDGET,
                                 torch.float64)


def test_guard_frame_twin_equals_jax(jax_ref, guard_twin):
    want = jax_ref["guard"]
    np.testing.assert_array_equal(guard_twin.numpy(), want.astype(np.int64))
    # some pixels escape, some run the budget
    assert int(want.min()) < BUDGET == int(want.max())


def test_guard_frame_trips_the_guard(guard_twin):
    """On the guard scalars the mirrored guard refuses every iteration of
    some pixels, admits every iteration of others, and refuses some
    iterations and admits others of a third kind."""
    it, admitted, refused = _guard_counts(cs.QUAD_GUARD_SCALARS, SIZE,
                                          BUDGET)
    assert torch.equal(it, guard_twin)
    # each iteration of a pixel, its escaping one too, is admitted or not
    assert torch.equal(admitted + refused,
                       it + (it < BUDGET).to(torch.int64))
    assert bool(((admitted == 0) & (refused > 0)).any())
    assert bool(((refused == 0) & (admitted > 0)).any())
    assert bool(((admitted > 0) & (refused > 0)).any())


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (K17 has no CPU form)")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_k17_fast_path_matches_twin_on_guard_scalars(card):
    kernels.reset_counts()
    got = quadd.escape_qd_kernel(cs.QUAD_GUARD_SCALARS, SIZE, SIZE, BUDGET,
                                 torch.float64, card)
    assert kernels.launches["escape_4x64"] == 1
    want = quadd.escape_qd_plain(cs.QUAD_GUARD_SCALARS, SIZE, SIZE, BUDGET,
                                 torch.float64, card)
    assert torch.equal(got, want)
