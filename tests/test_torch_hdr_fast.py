"""K13's value form (``csrc/escape_hdr.cu``): the facts it rests on, on
the CPU, and the kernel on frames that trip its window, on the card.

An iteration of K13 whose zx and zy (and the pixel's cx and cy) are each
zero or of a reduced exponent in the window W = [-30, 30] runs on the
values v = m 2^e in the mantissa type; the others run the HDR step of
the twin (``ops/hdr_escape.py``).  The header of the kernel proves that
in W each HDR operation's mantissa is the value operation's result times
a power of two; here a torch mirror of both forms and the window checks
it one iteration at a time on operands spread over W (and finds
iterations that differ outside it), then runs the kernel's loop on the
guard frames (``chip_smoke.HDR_GUARD_SCALARS``), where it equals the twin
and the JAX package's ``_escape_hdr_impl`` (FMA off) and the window
refuses, admits and mixes iterations.  The ``cuda`` tests hold K13 to
the twin there, on the shallow frame and at budgets around pass 1's cap.
"""

import numpy as np
import pytest
import torch

import chip_smoke as cs
import test_torch_jaxref as ref
from fractalshark_tpu_torch import kernels
from fractalshark_tpu_torch.core.pointzoom import PointZoomBBConverter
from fractalshark_tpu_torch.ops import escape, hdr_escape
from fractalshark_tpu_torch.ops import hdrfloat as hdr
from fractalshark_tpu_torch.ops.hdrfloat import HDR

WIN_LO, WIN_HI, C_HI = -30, 30, 28  # escape_hdr.cu kWinLo, kWinHi, kCHi
BUDGET = cs.HDR_GUARD_BUDGET
DTYPES = {"f32": torch.float32, "f64": torch.float64}
N = 4096


def _in_window(h: HDR, hi: int = WIN_HI) -> torch.Tensor:
    """escape_hdr.cu in_window on a reduced HDR value."""
    return (h.m == 0) | ((h.e >= WIN_LO) & (h.e <= hi))


def _value(h: HDR) -> torch.Tensor:
    return h.m * hdr.pow2i(h.e, h.m.dtype)


def _to_hdr(v: torch.Tensor) -> HDR:
    return hdr.reduce(HDR(v, torch.zeros(v.shape, dtype=torch.int32)))


def _hdr_iteration(zx, zy, cx, cy):
    """HdrRule::step (the twin's hdr_escape_tile step): (escaped, zx, zy)."""
    zx2, zy2 = hdr.square(zx), hdr.square(zy)
    mag = hdr.reduce(hdr.add(zx2, zy2))
    four = HDR(torch.ones_like(zx.m), torch.full_like(zx.e, 2))
    nzy = hdr.reduce(hdr.add(hdr.mul_pow2(hdr.mul(zx, zy), 1), cy))
    nzx = hdr.reduce(hdr.add(hdr.sub(zx2, zy2), cx))
    return hdr.gt_reduced(mag, four), nzx, nzy


def _value_iteration(zx, zy, cx, cy):
    """The value form, each result flushed as the card flushes f32 (-ftz;
    f64 results are not flushed there: none is subnormal in W)."""
    f = hdr.ftz if zx.m.dtype == torch.float32 else (lambda t: t)
    vx, vy, vcx, vcy = (_value(h) for h in (zx, zy, cx, cy))
    x2, y2 = f(vx * vx), f(vy * vy)
    esc = f(x2 + y2) > 4.0
    ny = f(f(f(2.0 * vx) * vy) + vcy)
    nx = f(f(x2 - y2) + vcx)
    return esc, _to_hdr(nx), _to_hdr(ny)


def _same(a: HDR, b: HDR) -> torch.Tensor:
    """Bit equality of two HDR values (signed zeros apart)."""
    ib = torch.int32 if a.m.dtype == torch.float32 else torch.int64
    return (a.m.view(ib) == b.m.view(ib)) & (a.e == b.e)


def _operands(seed, dtype, lo, hi):
    """N reduced HDR values of random sign and mantissa, exponents from
    [lo, hi] (a sixteenth at each end), a sixteenth +-0, and in the last
    sixteenth the magnitude of the next operand's (|zx| = |zy|: an exact
    cancellation of zx^2 - zy^2)."""
    rng = np.random.default_rng(seed)
    e = rng.integers(lo, hi + 1, N)
    e[: N // 16] = lo
    e[N // 16: N // 8] = hi
    m = rng.uniform(1, 2, N) * rng.choice([-1.0, 1.0], N)
    m[N // 8: 3 * N // 16] = np.where(rng.random(N // 16) < 0.5, 0.0, -0.0)
    mt = torch.from_numpy(m).to(dtype)
    h = hdr.reduce(HDR(mt, torch.from_numpy(e.astype(np.int32))))
    return h


def _iteration_pairs(seed, dtype, lo, hi):
    zx, zy, cx, cy = (_operands(seed + k, dtype, lo, hi) for k in range(4))
    tail = slice(-N // 16, None)
    zy.m[tail] = zx.m[tail].abs() * zy.m[tail].sign()
    zy.e[tail] = zx.e[tail]
    return zx, zy, cx, cy


@pytest.mark.parametrize("mant", ["f32", "f64"])
def test_value_iteration_equals_hdr_step_in_the_window(mant):
    """Every operand in W (the window's ends, zeros of both signs, and
    |zx| = |zy|): the value form's escape decision and reduced results
    are the HDR step's, bit for bit."""
    zx, zy, cx, cy = _iteration_pairs(1, DTYPES[mant], WIN_LO, WIN_HI)
    esc_h, nzx_h, nzy_h = _hdr_iteration(zx, zy, cx, cy)
    esc_v, nzx_v, nzy_v = _value_iteration(zx, zy, cx, cy)
    assert torch.equal(esc_h, esc_v)
    live = ~esc_h
    assert bool(live.sum() > N // 4)
    assert bool((_same(nzx_h, nzx_v) & _same(nzy_h, nzy_v))[live].all())


@pytest.mark.parametrize("mant", ["f32", "f64"])
def test_value_iteration_is_not_the_hdr_step_past_the_window(mant):
    """Operands with exponents out to +-70 (gaps past 126 between the
    squares, exact zeros far above cx): some iterations differ, and not
    all."""
    zx, zy, cx, cy = _iteration_pairs(7, DTYPES[mant], -70, 70)
    cx = _operands(99, DTYPES[mant], -140, -100)
    esc_h, nzx_h, nzy_h = _hdr_iteration(zx, zy, cx, cy)
    esc_v, nzx_v, nzy_v = _value_iteration(zx, zy, cx, cy)
    same = (esc_h == esc_v) & (esc_h | (_same(nzx_h, nzx_v)
                                         & _same(nzy_h, nzy_v)))
    assert 0 < int((~same).sum()) < N


def _guard_p(frame, np_dtype):
    p, w, h = frame
    return {k: (np.asarray(m, np_dtype), np.int32(e))
            for k, (m, e) in p.items()}, w, h


def mirror(p, width, height, n, dtype):
    """The kernel's loop on the twin's arithmetic: each pixel's count, the
    iterations the window admits (run in the value form) and refuses (the
    HDR step), and the iterations whose zx^2 - zy^2 cancels to an exact
    zero more than 126 binades above cx."""
    cx, cy = hdr_escape._coords(p, width, height, dtype, "cpu")
    c_in = _in_window(cx, C_HI) & _in_window(cy, C_HI)
    zx, zy = cx, cy
    shape = cx.m.shape
    it = torch.zeros(shape, dtype=torch.int64)
    admitted = torch.zeros(shape, dtype=torch.int64)
    refused = torch.zeros(shape, dtype=torch.int64)
    cancels = 0
    active = torch.ones(shape, dtype=torch.bool)
    for _ in range(n):
        ok = c_in & _in_window(zx) & _in_window(zy)
        admitted += active & ok
        refused += active & ~ok
        d = hdr.sub(hdr.square(zx), hdr.square(zy))
        cancels += int((active & (d.m == 0) & (d.e - cx.e > 126)
                        & (d.e > hdr.MIN_BIG_EXPONENT // 2)).sum())
        esc_h, nzx_h, nzy_h = _hdr_iteration(zx, zy, cx, cy)
        esc_v, nzx_v, nzy_v = _value_iteration(zx, zy, cx, cy)
        esc = torch.where(ok, esc_v, esc_h)
        cont = active & ~esc
        nzx = HDR(*(torch.where(ok, v, h) for v, h in zip(nzx_v, nzx_h)))
        nzy = HDR(*(torch.where(ok, v, h) for v, h in zip(nzy_v, nzy_h)))
        zx = HDR(*(torch.where(cont, a, o) for a, o in zip(nzx, zx)))
        zy = HDR(*(torch.where(cont, a, o) for a, o in zip(nzy, zy)))
        it += cont
        active = cont
        if not bool(active.any()):
            break
    return it, admitted, refused, cancels


def _jax_reference(_inputs):
    import jax.numpy as jnp

    from fractalshark_tpu.ops.hdr_escape import _escape_hdr_impl

    out = {}
    for i, frame in enumerate(cs.HDR_GUARD_SCALARS):
        for mant, npdt in (("f32", np.float32), ("f64", np.float64)):
            p, w, h = _guard_p(frame, npdt)
            args = []
            for key in ("min_x", "max_y", "dx", "dy"):
                args += [jnp.asarray(p[key][0]), jnp.asarray(p[key][1])]
            out[f"{i}_{mant}"] = np.asarray(_escape_hdr_impl(
                *args, jnp.asarray(BUDGET, jnp.int32), w, h,
                jnp.dtype(npdt)))
    return out


@pytest.fixture(scope="module")
def jax_ref(tmp_path_factory):
    return ref.run_jax_reference("test_torch_hdr_fast", "_jax_reference",
                                 tmp_path_factory.mktemp("hdr_fast"))


@pytest.fixture(scope="module")
def guard_runs():
    """Per frame and mantissa type: the twin's grid and the mirror's."""
    out = {}
    for i, frame in enumerate(cs.HDR_GUARD_SCALARS):
        for mant, npdt in (("f32", np.float32), ("f64", np.float64)):
            p, w, h = _guard_p(frame, npdt)
            out[i, mant] = (hdr_escape.escape_hdr_plain(p, w, h, BUDGET,
                                                        DTYPES[mant]),
                            mirror(p, w, h, BUDGET, DTYPES[mant]))
    return out


@pytest.mark.parametrize("frame", range(len(cs.HDR_GUARD_SCALARS)))
@pytest.mark.parametrize("mant", ["f32", "f64"])
def test_guard_frame_twin_equals_jax_and_mirror(jax_ref, guard_runs, frame,
                                                mant):
    twin, (it, admitted, refused, _) = guard_runs[frame, mant]
    np.testing.assert_array_equal(twin.numpy(),
                                  jax_ref[f"{frame}_{mant}"].astype(np.int64))
    assert torch.equal(it, twin)
    # each iteration of a pixel, its escaping one too, is admitted or not
    assert torch.equal(admitted + refused,
                       it + (it < BUDGET).to(torch.int64))


@pytest.mark.parametrize("mant", ["f32", "f64"])
def test_guard_frames_trip_the_window(guard_runs, mant):
    """Over the guard frames the window refuses every iteration of some
    pixels (a coordinate below it), admits every iteration of others and
    mixes the two in others (z falls below it); frame 1 has the exact
    cancellation far above cx; some pixels escape, some run the budget."""
    runs = [guard_runs[i, mant] for i in range(len(cs.HDR_GUARD_SCALARS))]
    adm = torch.cat([r[1][1].reshape(-1) for r in runs])
    ref_ = torch.cat([r[1][2].reshape(-1) for r in runs])
    grid = torch.cat([r[0].reshape(-1) for r in runs])
    assert bool(((adm == 0) & (ref_ > 0)).any())
    assert bool(((ref_ == 0) & (adm > 0)).any())
    assert bool(((adm > 0) & (ref_ > 0)).any())
    assert runs[1][1][3] > 0
    assert int(grid.min()) < BUDGET == int(grid.max())


def test_guard_frame_f64_falls_below_every_other_iteration(guard_runs):
    """Frame 0, column 0 (c = -1 + i cy), row 15 (cy = 2^-16): in f64 the
    window refuses about every other iteration (zx = -cy^2 = -2^-32)."""
    _, (it, admitted, refused, _) = guard_runs[0, "f64"]
    assert int(it[15, 0]) == BUDGET
    assert abs(int(admitted[15, 0]) - int(refused[15, 0])) <= 2


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (K13 has no CPU form)")
    return torch.device("cuda", 0)


def _shallow(size, npdt):
    argv = cs.FAMILY_SHALLOW
    ptz = PointZoomBBConverter(pt_x=argv[1], pt_y=argv[3],
                               zoom_factor=argv[5], prec=512)
    return hdr_escape.view_to_hdr_params(
        ptz.square_aspect_ratio(size, size), size, size, dtype=npdt), \
        int(argv[7])


@pytest.mark.cuda
@pytest.mark.parametrize("mant", ["f32", "f64"])
@pytest.mark.parametrize("frame", ["guard0", "guard1", "shallow"])
def test_k13_matches_twin_on_card(card, mant, frame):
    npdt = np.float32 if mant == "f32" else np.float64
    if frame == "shallow":
        (p, n), w = _shallow(256, npdt), 256
        h = w
    else:
        p, w, h = _guard_p(cs.HDR_GUARD_SCALARS[int(frame[-1])], npdt)
        n = BUDGET
    kernels.reset_counts()
    got = hdr_escape.escape_hdr_kernel(p, w, h, n, DTYPES[mant], card)
    assert kernels.launches["escape_hdr" + mant[1:]] == 1
    want = hdr_escape.escape_hdr_plain(p, w, h, n, DTYPES[mant], card)
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("mant", ["f32", "f64"])
@pytest.mark.parametrize("n", [0, 1, escape.LOOP_PASS1_CAP,
                               escape.LOOP_PASS1_CAP + 1])
def test_k13_budgets_around_pass1_cap(card, mant, n):
    """Budgets of 0, 1, pass 1's cap (one pass) and one past it (two
    passes) on guard frame 0."""
    p, w, h = _guard_p(cs.HDR_GUARD_SCALARS[0], np.float32 if mant == "f32"
                       else np.float64)
    got = hdr_escape.escape_hdr_kernel(p, w, h, n, DTYPES[mant], card)
    want = hdr_escape.escape_hdr_plain(p, w, h, n, DTYPES[mant], card)
    assert torch.equal(got, want)
    assert int(want.max()) == n
