"""K18 4x64's exact fast path (``csrc/escape_quad.cu``): the facts it
rests on, on the CPU, and the kernel on frames that trip its guard, on
the card.

The fast path runs the compensated quad-float iteration (``ops/
quadflt.py``: a pair of double-floats A + B) with no flushes, each
two-product as one product and one FMA, which gives exactly
a·b − fl(a·b), and a square's product x.hi·x.lo formed once; the guard
admits an iteration when every nonzero component of zx, zy, cx and cy has
an exponent in [-450, 500].  There the twin's flushed operations give the
bits of that exact arithmetic, which this file emulates in numpy
(unflushed f64, each two-product's error from ``fractions.Fraction``),
operation by operation and iteration by iteration on three frames; below
the range the products do not always.  The guard scalars
(``chip_smoke.QF_GUARD_SCALARS``) make a frame with rows whose coordinate
has a component below the range, rows whose iterations start below it and
rise into it, and a row that stays in it; the twin on that frame equals
the JAX package's ``_escape_qf_impl`` (FMA off), and the ``cuda`` tests
hold K18 4x64 to the twin there, on the shallow, antenna and 1e17 frames
and at budgets around pass 1's cap.
"""

import numpy as np
import pytest
import torch

import chip_smoke as cs
import test_torch_jaxref as ref
from fractalshark_tpu_torch import kernels
from fractalshark_tpu_torch.core.pointzoom import PointZoomBBConverter
from fractalshark_tpu_torch.ops import quadflt
from fractalshark_tpu_torch.ops.quadflt import QF
from test_torch_dblflt_fast import _add, _mul, _prod

GUARD_LO, GUARD_HI = -450, 500   # df32.cuh kGuardLo, kGuardHi
LATTICE_E = -459                 # the argument's bound: 2E - 104 = -1022
N = 512
SIZE, BUDGET = cs.QF_GUARD_SIZE, cs.QF_GUARD_BUDGET

# ------------------------------------------- the Exact arithmetic in numpy
# (csrc/quad.cuh under fs::Exact): a double-float is a (hi, lo) pair of
# f64 arrays, a QF value a pair (A, B) of them; nothing flushed, each
# two-product's error exact (an FMA: a*b - p rounded once)


def _sub(a, b):
    return _add(a, (-b[0], -b[1]))


def _mul_pow2(a, s):
    return a[0] * s, a[1] * s


def _df_two_sum(x, y):
    s = _add(x, y)
    bb = _sub(s, x)
    return s, _add(_sub(x, _sub(s, bb)), _sub(y, bb))


def _renorm(a, b):
    s = _add(a, b)
    return s, _add(_sub(a, s), b)


def _qf_add(x, y):
    s, e = _df_two_sum(x[0], y[0])
    return _renorm(s, _add(e, _add(x[1], y[1])))


def _qf_neg(x):
    return tuple((-c[0], -c[1]) for c in x)


def _prod_sum(hh, hl, lh, ll):
    s, e1 = _df_two_sum(hh, _add(hl, lh))
    p, e2 = _df_two_sum(s, (ll, np.zeros_like(ll)))
    return p, _add(e1, e2)


def _df_two_prod(x, y):
    return _prod_sum(_prod(x[0], y[0]), _prod(x[0], y[1]),
                     _prod(x[1], y[0]), x[1] * y[1])


def _df_two_sqr(x):
    """df_two_prod(x, x) with x.hi*x.lo's two-product formed once."""
    hl = _prod(x[0], x[1])
    return _prod_sum(_prod(x[0], x[0]), hl, hl, x[1] * x[1])


def _qf_mul(x, y):
    p, e = _df_two_prod(x[0], y[0])
    return _renorm(p, _add(e, _add(_mul(x[0], y[1]), _mul(x[1], y[0]))))


def _qf_sqr(x):
    p, e = _df_two_sqr(x[0])
    return _renorm(p, _add(e, _mul_pow2(_mul(x[0], x[1]), 2.0)))


def _qf_mul_pow2(x, s):
    return _mul_pow2(x[0], s), _mul_pow2(x[1], s)


EXACT = {
    "df_two_sum": lambda x, y: _df_two_sum(x[0], y[0]),
    "renorm": lambda x, y: _renorm(x[0], y[0]),
    "df_two_prod": lambda x, y: _df_two_prod(x[0], y[0]),
    "df_two_sqr": lambda x, y: _df_two_sqr(x[0]),
    "qf_add": _qf_add,
    "qf_sub": lambda x, y: _qf_add(x, _qf_neg(y)),
    "qf_mul": _qf_mul,
    "qf_sqr": lambda x, y: _qf_sqr(x),
    "qf_mul_pow2": lambda x, y: _qf_mul_pow2(x, 2.0),
}


def _tq(x) -> QF:
    """A numpy QF value as the twin's."""
    return QF(*(torch.from_numpy(np.ascontiguousarray(c))
                for d in x for c in d))


def _nq(q: QF):
    """The twin's QF value as numpy ((a.hi, a.lo), (b.hi, b.lo))."""
    return (q.a_hi.numpy(), q.a_lo.numpy()), (q.b_hi.numpy(), q.b_lo.numpy())


def _twin(name, x, y):
    """The twin's flushed operation on the same operands, as numpy."""
    tx, ty = _tq(x), _tq(y)
    if name in ("df_two_sum", "renorm", "df_two_prod", "df_two_sqr"):
        fn = {"df_two_sum": quadflt._df_two_sum, "renorm": None,
              "df_two_prod": quadflt._df_two_prod,
              "df_two_sqr": lambda a, b: quadflt._df_two_prod(a, a)}[name]
        if fn is None:
            return _nq(quadflt._renorm(tx.A, ty.A))
        p, e = fn(tx.A, ty.A)
        return (p.hi.numpy(), p.lo.numpy()), (e.hi.numpy(), e.lo.numpy())
    if name == "qf_sqr":
        return _nq(quadflt.qf_sqr(tx))
    if name == "qf_mul_pow2":
        return _nq(quadflt.qf_mul_pow2(tx, 2.0))
    return _nq(getattr(quadflt, name)(tx, ty))


def _bits_equal(got, want):
    """Per element: the four components' bits equal (signed zeros
    included)."""
    g = [c for d in got for c in d]
    w = [np.asarray(c, np.float64) for d in want for c in d]
    return np.logical_and.reduce([a.view(np.int64) == b.view(np.int64)
                                  for a, b in zip(g, w)])


def _operands(seed, lo, hi):
    """Two QF values (numpy) whose every component is zero or has an
    exponent in [lo, hi]: A.hi of random sign and 53-bit mantissa (its
    exponent at least lo + 180, or within 20 of hi), each
    lower component 2^-53 to 2^-60 of the one above it (B.hi of A.lo) at
    random sign, a component below 2^lo made zero, and +0 or -0 in a
    sixteenth of each lower component."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(2):
        e = rng.integers(min(lo + 180, hi - 20), hi + 1, N)
        e[: N // 16] = hi
        comps = [rng.uniform(1, 2, N) * np.exp2(e.astype(np.float64))
                 * rng.choice([-1.0, 1.0], N)]
        for _ in range(3):
            c = comps[-1] * np.exp2(-rng.integers(53, 61, N).astype(
                np.float64)) * rng.uniform(-1, 1, N)
            c = np.where(np.abs(c) < 2.0 ** lo, 0.0, c)
            pick = rng.random(N)
            c[pick < 1 / 16] = 0.0
            c[pick > 15 / 16] = -0.0
            comps.append(c)
        # the lowest components reach the bottom of the range
        comps[3][-N // 16:] = np.exp2(float(lo)) * rng.choice([-1.0, 1.0],
                                                              N // 16)
        comps[0][-4:] = [0.0, -0.0, 0.0, -0.0]
        out.append(((comps[0], comps[1]), (comps[2], comps[3])))
    return out


def _same_bits(name, x, y):
    with np.errstate(under="ignore"):
        want = EXACT[name](x, y)
    return _bits_equal(_twin(name, x, y), want)


@pytest.mark.parametrize("name", list(EXACT))
def test_flushed_qf_ops_equal_exact_across_the_guard_range(name):
    x, y = _operands(sum(map(ord, name)), LATTICE_E, GUARD_HI)
    assert _same_bits(name, x, y).all()


@pytest.mark.parametrize("name", ["df_two_prod", "qf_mul", "qf_sqr"])
def test_flushed_products_are_not_exact_below_the_range(name):
    """Operands whose products reach about 2^-1,000 and below: the
    flushed partials and errors are not always the Exact ones, so the
    guard is needed."""
    x, y = _operands(13, -620, LATTICE_E - 1)
    same = _same_bits(name, x, y)
    assert 0 < int((~same).sum()) < N


# --------------------------------------------------------- the escape


def _admits(q: QF) -> torch.Tensor:
    """escape_quad.cu's guard (quad.cuh admits) on one QF value."""
    ok = torch.ones_like(q.a_hi, dtype=torch.bool)
    for c in q:
        e = torch.frexp(c).exponent - 1
        ok &= (c == 0) | ((e >= GUARD_LO) & (e <= GUARD_HI))
    return ok


def _mirror(scal, size, n):
    """escape_qf_plain's loop on `scal` (4x64) with the guard mirrored:
    on every iteration it admits, the Exact iteration in numpy on the
    same state, held to the twin's squares, magnitude, escape test and
    next state component by component.  Returns each pixel's count, the
    iterations admitted and refused, and the iterations compared."""
    shape = (size, size)

    def full(v):
        return torch.full(shape, v, dtype=torch.float64)

    min_x, max_y, dx, dy = (QF(*(full(scal[4 * i + k]) for k in range(4)))
                            for i in range(4))
    zero = full(0.0)
    xs = torch.arange(size, dtype=torch.float64)[None, :].expand(shape)
    ys = torch.arange(size, dtype=torch.float64)[:, None].expand(shape)
    cx = quadflt.qf_add(min_x, quadflt.qf_mul(dx, QF(xs, zero, zero, zero)))
    cy = quadflt.qf_sub(max_y, quadflt.qf_mul(dy, QF(ys, zero, zero, zero)))
    c_ok = _admits(cx) & _admits(cy)
    zx, zy = cx, cy
    it = torch.zeros(shape, dtype=torch.int64)
    admitted = torch.zeros(shape, dtype=torch.int64)
    refused = torch.zeros(shape, dtype=torch.int64)
    active = torch.ones(shape, dtype=torch.bool)
    compared = 0
    for _ in range(n):
        if not bool(active.any()):
            break
        ok = c_ok & _admits(zx) & _admits(zy)
        admitted += active & ok
        refused += active & ~ok
        zx2, zy2 = quadflt.qf_sqr(zx), quadflt.qf_sqr(zy)
        mag = quadflt.qf_add(zx2, zy2)
        cont = active & ~(mag.a_hi > 4.0)
        nzy = quadflt.qf_add(quadflt.qf_mul_pow2(quadflt.qf_mul(zx, zy),
                                                 2.0), cy)
        nzx = quadflt.qf_add(quadflt.qf_sub(zx2, zy2), cx)
        sel = (active & ok).numpy()
        if sel.any():
            def pick(q):
                return tuple((c[0][sel], c[1][sel]) for c in _nq(q))
            ex, ey, ecx, ecy = pick(zx), pick(zy), pick(cx), pick(cy)
            ex2, ey2 = _qf_sqr(ex), _qf_sqr(ey)
            emag = _qf_add(ex2, ey2)
            enzy = _qf_add(_qf_mul_pow2(_qf_mul(ex, ey), 2.0), ecy)
            enzx = _qf_add(_qf_add(ex2, _qf_neg(ey2)), ecx)
            for got, want in ((zx2, ex2), (zy2, ey2), (mag, emag),
                              (nzx, enzx), (nzy, enzy)):
                assert _bits_equal(pick(got), want).all()
            assert np.array_equal((mag.a_hi > 4.0).numpy()[sel],
                                  emag[0][0] > 4.0)
            compared += int(sel.sum())
        zx = QF(*(torch.where(cont, a, o) for a, o in zip(nzx, zx)))
        zy = QF(*(torch.where(cont, a, o) for a, o in zip(nzy, zy)))
        it += cont
        active = cont
    return it, admitted, refused, compared


def _frame(argv, size):
    """A CLI frame's 16 scalars (4x64) at size² and its budget."""
    ptz = PointZoomBBConverter(pt_x=argv[1], pt_y=argv[3],
                               zoom_factor=argv[5], prec=256)
    return quadflt.qf_params(ptz.square_aspect_ratio(size, size), size,
                             size, "4x64"), int(argv[-1])


def _jax_reference(_inputs):
    import jax.numpy as jnp

    from fractalshark_tpu.ops.quadflt import _escape_qf_impl

    return {"guard": np.asarray(_escape_qf_impl(
        jnp.asarray(cs.QF_GUARD_SCALARS, jnp.float64),
        jnp.asarray(BUDGET, jnp.int32), SIZE, SIZE, jnp.float64))}


@pytest.fixture(scope="module")
def jax_ref(tmp_path_factory):
    return ref.run_jax_reference("test_torch_qf_fast", "_jax_reference",
                                 tmp_path_factory.mktemp("qf_fast"))


@pytest.fixture(scope="module")
def guard_twin():
    return quadflt.escape_qf_plain(cs.QF_GUARD_SCALARS, SIZE, SIZE, BUDGET,
                                   torch.float64)


def test_guard_frame_twin_equals_jax(jax_ref, guard_twin):
    want = jax_ref["guard"]
    np.testing.assert_array_equal(guard_twin.numpy(), want.astype(np.int64))
    # some pixels escape, some run the budget
    assert int(want.min()) < BUDGET == int(want.max())


@pytest.fixture(scope="module")
def guard_mirror():
    return _mirror(cs.QF_GUARD_SCALARS, SIZE, BUDGET)


def test_guard_frame_trips_the_guard(guard_twin, guard_mirror):
    """On the guard scalars the mirrored guard refuses every iteration of
    rows 3, 5-7 and 9-15 (cy's component near 2^-492), admits every
    iteration of row 0 (cy = 0), and refuses some iterations and admits
    others of rows 1, 2, 4 and 8; every admitted iteration's Exact form
    equals the twin's (``_mirror``)."""
    it, admitted, refused, compared = guard_mirror
    assert torch.equal(it, guard_twin)
    # each iteration of a pixel, its escaping one too, is admitted or not
    assert torch.equal(admitted + refused,
                       it + (it < BUDGET).to(torch.int64))
    kind = {"refused": (admitted == 0) & (refused > 0),
            "admitted": (refused == 0) & (admitted > 0),
            "mixed": (admitted > 0) & (refused > 0)}
    rows = {k: sorted({int(r) for r in torch.nonzero(v)[:, 0]})
            for k, v in kind.items()}
    assert rows == {"refused": [3, 5, 6, 7, 9, 10, 11, 12, 13, 14, 15],
                    "admitted": [0], "mixed": [1, 2, 4, 8]}
    assert [int(v.sum()) for v in kind.values()] == [176, 16, 64]
    assert compared == int(admitted.sum()) > 0
    assert 0 < int(refused.sum())


@pytest.mark.parametrize("frame", ["shallow", "antenna"])
def test_exact_iteration_equals_twin_on_frames(frame):
    """The sweep's shallow frame and the 1e18 antenna frame at 16²: every
    iteration is admitted, and the Exact form equals the twin's state at
    each."""
    argv = cs.FAMILY_SHALLOW if frame == "shallow" else cs.QUAD_ANTENNA
    scal, n = _frame(argv, 16)
    it, admitted, refused, compared = _mirror(scal, 16, n)
    assert torch.equal(it, quadflt.escape_qf_plain(scal, 16, 16, n,
                                                   torch.float64))
    assert int(refused.sum()) == 0
    assert compared == int(admitted.sum()) > 0
    assert int(it.min()) < int(it.max())


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (K18 has no CPU form)")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("frame", ["guard", "shallow", "antenna", "1e17"])
def test_k18_4x64_matches_twin_on_card(card, frame):
    """K18 4x64 = its twin on the guard frame and at 256² on the shallow
    frame, the antenna frame and the 1e17 frame (budget cut to 40)."""
    if frame == "guard":
        scal, size, n = cs.QF_GUARD_SCALARS, SIZE, BUDGET
    else:
        argv = {"shallow": cs.FAMILY_SHALLOW, "antenna": cs.QUAD_ANTENNA,
                "1e17": cs.QUAD_1E17}[frame]
        size = cs.QUAD_TWIN_SIZE
        scal, n = _frame(argv, size)
        if frame == "1e17":
            n = cs.QUAD_TWIN_BUDGET
    kernels.reset_counts()
    got = quadflt.escape_qf_kernel(scal, size, size, n, torch.float64, card)
    assert kernels.launches["escape_qf64"] == 1
    want = quadflt.escape_qf_plain(scal, size, size, n, torch.float64, card)
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [0, 1, 16, 17])
def test_k18_4x64_budgets_around_pass1_cap(card, n):
    """Budgets of 0, 1, pass 1's cap (escape.LOOP_PASS1_CAP: one pass) and
    one past it (two passes) on the guard frame."""
    scal = cs.QF_GUARD_SCALARS
    got = quadflt.escape_qf_kernel(scal, SIZE, SIZE, n, torch.float64, card)
    want = quadflt.escape_qf_plain(scal, SIZE, SIZE, n, torch.float64, card)
    assert torch.equal(got, want)
    assert int(want.max()) == n
