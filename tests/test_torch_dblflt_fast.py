"""K14 2x64's exact fast path (``csrc/escape_df.cu``): the facts it rests
on, on the CPU, and the kernel on frames that trip its guard, on the
card.

The fast path runs the double-float operations of an iteration with no
flushes and each two-product as one product and one FMA, which gives
exactly a·b − fl(a·b); the guard admits an iteration when every nonzero
component of zx, zy, cx and cy has an exponent in [-450, 500].  There the
twin's flushed operations (``ops/dblflt.py``: Dekker's two-product, the
squares, products, sums and differences) give the bits of that exact
arithmetic, which this file emulates in numpy (unflushed f64, the FMA's
error from ``fractions.Fraction``); below the range the products do not
always.  The guard scalars (``chip_smoke.DF_GUARD_SCALARS``) make a frame
with pixels whose components stay in the range, pixels whose coordinate
does not, and pixels whose components fall below it on some iterations
and not on others; the twin on that frame equals the JAX package's
``_escape_df_impl`` (FMA off), and the ``cuda`` tests hold K14 2x64 to
the twin there and on the shallow frame.
"""

from fractions import Fraction

import numpy as np
import pytest
import torch

import chip_smoke as cs
import test_torch_jaxref as ref
from fractalshark_tpu_torch import kernels
from fractalshark_tpu_torch.core.pointzoom import PointZoomBBConverter
from fractalshark_tpu_torch.ops import dblflt
from fractalshark_tpu_torch.ops.dblflt import DF

GUARD_LO, GUARD_HI = -450, 500   # df32.cuh kGuardLo, kGuardHi
LATTICE_E = -459                 # the argument's bound: 2E - 104 = -1022
N = 2048
SIZE, BUDGET = cs.DF_GUARD_SIZE, cs.DF_GUARD_BUDGET


def _components(rng, lo, hi):
    """N f64 values of random sign and 53-bit mantissa, exponents from
    [lo, hi] (a sixteenth at each end), and a few signed zeros."""
    e = rng.integers(lo, hi + 1, N)
    e[: N // 16] = lo
    e[N // 16: N // 8] = hi
    v = rng.uniform(1, 2, N) * np.exp2(e.astype(np.float64))
    v *= rng.choice([-1.0, 1.0], N)
    v[-4:] = [0.0, -0.0, 0.0, -0.0]
    return v


def _operands(seed, lo, hi):
    """Two double-floats a, b (numpy (hi, lo) pairs) whose every
    component is zero or has an exponent in [lo, hi]: each low part
    2^-53 to 2^-60 of its high part, and +0 or -0 in a sixteenth each."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(2):
        h = _components(rng, lo + 60, hi)
        low = h * np.exp2(-rng.integers(53, 61, N).astype(np.float64)) \
            * rng.uniform(-1, 1, N)
        low = np.where(np.abs(low) < 2.0 ** lo, 0.0, low)
        pick = rng.random(N)
        low[pick < 1 / 16] = 0.0
        low[pick > 15 / 16] = -0.0
        out.append((h, low))
    return out


# the Exact arithmetic (csrc/df32.cuh Exact): numpy f64, nothing flushed,
# the two-product's error exact (an FMA: a*b - p rounded once)

def _prod(a, b):
    p = a * b
    e = np.array([float(Fraction(float(x)) * Fraction(float(y))
                        - Fraction(float(q))) for x, y, q in zip(a, b, p)])
    return p, e


def _two_sum(a, b):
    s = a + b
    bb = s - a
    return s, (a - (s - bb)) + (b - bb)


def _quick_two_sum(a, b):
    s = a + b
    return s, b - (s - a)


def _add(a, b):
    s1, s2 = _two_sum(a[0], b[0])
    t1, t2 = _two_sum(a[1], b[1])
    s1, s2 = _quick_two_sum(s1, s2 + t1)
    return _quick_two_sum(s1, s2 + t2)


def _mul(a, b):
    p1, p2 = _prod(a[0], b[0])
    return _quick_two_sum(p1, (p2 + a[0] * b[1]) + a[1] * b[0])


def _sqr(a):
    p1, p2 = _prod(a[0], a[0])
    return _quick_two_sum(p1, p2 + (2.0 * a[0]) * a[1])


EXACT = {
    "two_prod": lambda a, b: _prod(a[0], b[0]),
    "df_add": _add,
    "df_sub": lambda a, b: _add(a, (-b[0], -b[1])),
    "df_mul": _mul,
    "df_sqr": lambda a, b: _sqr(a),
    "df_mul_pow2": lambda a, b: (a[0] * 2.0, a[1] * 2.0),
}


def _twin(name, a, b):
    """The twin's flushed operation on the same operands."""
    ta, tb = (DF(*(torch.from_numpy(c) for c in x)) for x in (a, b))
    if name == "two_prod":
        out = dblflt.two_prod(ta.hi, tb.hi)
    elif name == "df_sqr":
        out = dblflt.df_sqr(ta)
    elif name == "df_mul_pow2":
        out = dblflt.df_mul_pow2(ta, 2.0)
    else:
        out = getattr(dblflt, name)(ta, tb)
    return [c.numpy() for c in out]


def _same_bits(name, a, b):
    """Per operand pair: the twin's result has the Exact arithmetic's
    bits (signed zeros included)."""
    got, want = _twin(name, a, b), EXACT[name](a, b)
    return np.logical_and.reduce([
        g.view(np.int64) == np.asarray(w, np.float64).view(np.int64)
        for g, w in zip(got, want)])


@pytest.mark.parametrize("name", list(EXACT))
def test_flushed_df_ops_equal_exact_across_the_guard_range(name):
    a, b = _operands(sum(map(ord, name)), LATTICE_E, GUARD_HI)
    assert _same_bits(name, a, b).all()


@pytest.mark.parametrize("name", ["two_prod", "df_mul", "df_sqr"])
def test_flushed_products_are_not_exact_below_the_range(name):
    """Operands whose products reach about 2^-1,000 and below: the
    flushed partials and errors are not always the Exact ones."""
    a, b = _operands(11, -580, LATTICE_E - 1)
    same = _same_bits(name, a, b)
    assert 0 < int((~same).sum()) < N


def _admits(v: DF) -> torch.Tensor:
    """df32.cuh's guard (admits) on one double-float value."""
    ok = torch.ones_like(v.hi, dtype=torch.bool)
    for c in v:
        e = torch.frexp(c).exponent - 1
        ok &= (c == 0) | ((e >= GUARD_LO) & (e <= GUARD_HI))
    return ok


def _guard_counts(scal, size, n):
    """escape_df_plain's loop on `scal` with the guard mirrored: each
    pixel's count, and the iterations the guard admits and refuses."""
    shape = (size, size)

    def full(v):
        return torch.full(shape, v, dtype=torch.float64)

    min_x, max_y, dx, dy = (DF(full(scal[2 * i]), full(scal[2 * i + 1]))
                            for i in range(4))
    xs = torch.arange(size, dtype=torch.float64)[None, :].expand(shape)
    ys = torch.arange(size, dtype=torch.float64)[:, None].expand(shape)
    cx = dblflt.df_add(min_x, dblflt.df_mul_float(dx, xs))
    cy = dblflt.df_sub(max_y, dblflt.df_mul_float(dy, ys))
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
        zx2, zy2 = dblflt.df_sqr(zx), dblflt.df_sqr(zy)
        cont = active & ~(dblflt.df_add(zx2, zy2).hi > 4.0)
        nzy = dblflt.df_add(dblflt.df_mul_pow2(dblflt.df_mul(zx, zy), 2.0),
                            cy)
        nzx = dblflt.df_add(dblflt.df_sub(zx2, zy2), cx)
        zx = DF(*(torch.where(cont, a, o) for a, o in zip(nzx, zx)))
        zy = DF(*(torch.where(cont, a, o) for a, o in zip(nzy, zy)))
        it += cont
        active = cont
    return it, admitted, refused


def _jax_reference(_inputs):
    import jax.numpy as jnp

    from fractalshark_tpu.ops.dblflt import _escape_df_impl

    return {"guard": np.asarray(_escape_df_impl(
        jnp.asarray(cs.DF_GUARD_SCALARS, jnp.float64),
        jnp.asarray(BUDGET, jnp.int32), SIZE, SIZE, jnp.float64))}


@pytest.fixture(scope="module")
def jax_ref(tmp_path_factory):
    return ref.run_jax_reference("test_torch_dblflt_fast", "_jax_reference",
                                 tmp_path_factory.mktemp("dblflt_fast"))


@pytest.fixture(scope="module")
def guard_twin():
    return dblflt.escape_df_plain(cs.DF_GUARD_SCALARS, SIZE, SIZE, BUDGET,
                                  torch.float64)


def test_guard_frame_twin_equals_jax(jax_ref, guard_twin):
    want = jax_ref["guard"]
    np.testing.assert_array_equal(guard_twin.numpy(), want.astype(np.int64))
    # some pixels escape, some run the budget
    assert int(want.min()) < BUDGET == int(want.max())


def test_guard_frame_trips_the_guard(guard_twin):
    """On the guard scalars the mirrored guard refuses every iteration of
    some pixels (column 8: cx's low part 2^-457), admits every iteration
    of others (row 0: cy = 0), and refuses some iterations and admits
    others of the rest (zy's low parts start below 2^-450)."""
    it, admitted, refused = _guard_counts(cs.DF_GUARD_SCALARS, SIZE, BUDGET)
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
        pytest.skip("needs a CUDA device (K14 has no CPU form)")
    return torch.device("cuda", 0)


def _shallow_scalars(size):
    argv = cs.FAMILY_SHALLOW
    ptz = PointZoomBBConverter(pt_x=argv[1], pt_y=argv[3],
                               zoom_factor=argv[5], prec=512)
    return dblflt.df_params(ptz.square_aspect_ratio(size, size), size, size,
                            "2x64"), int(argv[7])


@pytest.mark.cuda
@pytest.mark.parametrize("frame", ["guard", "shallow"])
def test_k14_2x64_matches_twin_on_card(card, frame):
    if frame == "guard":
        scal, size, n = cs.DF_GUARD_SCALARS, SIZE, BUDGET
    else:
        size = 256
        scal, n = _shallow_scalars(size)
    kernels.reset_counts()
    got = dblflt.escape_df_kernel(scal, size, size, n, torch.float64, card)
    assert kernels.launches["escape_2x64"] == 1
    want = dblflt.escape_df_plain(scal, size, size, n, torch.float64, card)
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [0, 1, 16, 17])
def test_k14_2x64_budgets_around_pass1_cap(card, n):
    """Budgets of 0, 1, pass 1's cap (escape.LOOP_PASS1_CAP: one pass) and
    one past it (two passes) on the guard frame."""
    scal = cs.DF_GUARD_SCALARS
    got = dblflt.escape_df_kernel(scal, SIZE, SIZE, n, torch.float64, card)
    want = dblflt.escape_df_plain(scal, SIZE, SIZE, n, torch.float64, card)
    assert torch.equal(got, want)
    assert int(want.max()) == n
