"""K19's redesign (``csrc/rc_tail.cu`` ``rc_gather_kernel``): the facts
it rests on, on the CPU, and the kernel on orbits that trip its guard,
on the card.

K19 forms Z[pos+1] with the f64 recurrence z <- z^2 + c
(``rc_tail.py:136-137``) unflushed where every component of z and c is
zero or of an exponent in [-450, 500]; there the twin's flushed
operations (``perturb_stream._f64_step``) give the same bits, which this
file checks operation by operation (each rounded product a multiple of
2^-952, from ``fractions.Fraction``), and below the range they do not
always.  Synthetic compressed orbits (``GUARD_ORBITS``: c low below the
range from z = 0, and anchors with components below it under an
admitted c) reach refused steps; over them the twin equals the JAX
package's f64 gather.  The ``cuda`` tests hold K19 to its twin, every
state array of the pixels live after the handoff, on those orbits and on
an orbit with an anchor at every position, one with anchor 0 alone and
one that rebases every step, in one launch, in 7-step launches and in
the queue form.  ``_view6_rc_pins`` is the JAX package's View #6 RC 256²
through its gather tail (``tools/view6_rc_pins.py``, outside the gate).
"""

from fractions import Fraction

import numpy as np
import pytest
import torch

import chip_smoke as cs
import test_torch_jaxref as ref
from fractalshark_tpu_torch.engine.perturbation_results import (
    CompressedOrbit)
from fractalshark_tpu_torch.ops import hdrfloat as hdr
from fractalshark_tpu_torch.ops import perturb, rc_tail
from fractalshark_tpu_torch.ops import perturb_stream as ps
from fractalshark_tpu_torch.ops.hdrfloat import HDRComplex
from fractalshark_tpu_torch.ops.tables import anchor_table_f64

SIZE6 = 256
GUARD_LO, GUARD_HI = -450, 500   # df32.cuh kGuardLo, kGuardHi
LATTICE = Fraction(1, 2 ** 952)  # the argument's grid: 2^(2 GUARD_LO - 52)
N = 2048
SIZE, BUDGET, TOTAL = cs.RC_GUARD_SIZE, cs.RC_GUARD_BUDGET, cs.RC_GUARD_TOTAL
GUARD_ORBITS = cs.RC_GUARD_ORBITS
# besides the guard orbits: "every", an anchor at every position (a real
# orbit's values; no recurrence after the handoff), "alone", anchor 0
# alone (every step reconstructs), "rebase", max_ref 1 (every step
# rebases)
ORBITS = tuple(GUARD_ORBITS) + ("every", "alone", "rebase")


def _orbit(kind, C=CompressedOrbit):
    if kind in GUARD_ORBITS:
        return cs.rc_guard_orbit(kind, C)
    c = (-0.5, 0.1)     # inside the main cardioid: the orbit stays bounded
    if kind == "every":
        z = [(0.0, 0.0)]
        for _ in range(TOTAL - 1):
            x, y = z[-1]
            z.append((x * x - y * y + c[0], 2.0 * x * y + c[1]))
        z = np.asarray(z)
        return C(z[:, 0], z[:, 1], np.arange(TOTAL), TOTAL, *c, 0)
    if kind == "alone":
        return C(np.zeros(1), np.zeros(1), np.zeros(1, np.int64), TOTAL, *c,
                 0)
    return C(np.zeros(2), np.asarray([0.0, 0.1]), np.arange(2), 2, *c, 0)


def _view(pkg="fractalshark_tpu_torch"):
    """The guard orbits' 16² view: (ptz, centre x, centre y)."""
    import importlib
    HP = importlib.import_module(f"{pkg}.core.highprecision").HighPrecision
    return cs.rc_guard_view(HP, ref.host_layer(pkg).PointZoomBBConverter)


def _zero_init():
    z = np.zeros((SIZE, SIZE), np.int64)
    return {"dzr": np.zeros((SIZE, SIZE), np.float32),
            "dzi": np.zeros((SIZE, SIZE), np.float32),
            "dze": np.full((SIZE, SIZE), hdr.MIN_BIG_EXPONENT, np.int32),
            "it": z, "jwait": z, "done": z.astype(np.int32)}


# a budget past 2^31, handed over BIG_LEFT iterations before it: the
# counts are int64 (the reference's grid is uint64 from 2^31 on,
# rc_tail.py:441-443)
BIG, BIG_LEFT = (1 << 31) + 40, 40


def _big_init():
    init = _zero_init()
    init["it"] = np.full((SIZE, SIZE), BIG - BIG_LEFT, np.int64)
    init["jwait"] = (np.arange(SIZE * SIZE) % 150).reshape(SIZE, SIZE)
    return init


def _view6_rc_pins(_inputs):
    """The JAX package's View #6 ``GpuHDRx32PerturbedRCLAv2`` 256² through
    its gather tail in both modes: (iter_sum, CRC-32 of the grid as <u4)
    each (``tools/view6_rc_pins.py``; minutes on the CPU)."""
    import functools
    import zlib

    from fractalshark_tpu.engine import renderers as R
    from fractalshark_tpu.engine.fractal import Fractal
    from fractalshark_tpu.engine.la_reference import get_or_build_la
    from fractalshark_tpu.engine.perturbation_results import CompressedOrbit
    from fractalshark_tpu.ops import rc_tail as RT

    f = Fractal(width=SIZE6, height=SIZE6, view=6,
                algorithm="GpuHDRx32PerturbedRCLAv2", backend="cpu")
    res = R.get_orbit_calc(f).get_and_create_useful_results(
        f.ptz, f.num_iterations)
    la = get_or_build_la(f, res)
    comp = CompressedOrbit.from_uncompressed(
        res, error_exp=f.compression_error_exp)
    gather = RT.rc_tail_gather
    out = {}
    try:
        for mode in ("f64", "df32"):
            RT.rc_tail_gather = functools.partial(gather, mode=mode)
            g = np.asarray(R.two_phase_render(
                res, la, f.ptz, SIZE6, SIZE6, f.num_iterations, comp=comp,
                tail="gather")).astype("<u4")
            out[mode] = np.asarray([int(g.sum(dtype=np.uint64)),
                                    zlib.crc32(g.tobytes())])
    finally:
        RT.rc_tail_gather = gather
    return out


def _guard_reference(_inputs):
    from fractalshark_tpu.engine.perturbation_results import (
        CompressedOrbit as JC)
    from fractalshark_tpu.ops.rc_tail import rc_tail_gather

    ptz, cx, cy = _view("fractalshark_tpu")
    out = {kind: np.asarray(rc_tail_gather(
        _orbit(kind, JC), cx, cy, ptz, SIZE, SIZE, BUDGET,
        init_state=_zero_init(), mode="f64")) for kind in GUARD_ORBITS}
    out["big"] = np.asarray(rc_tail_gather(
        _orbit("guard_mix", JC), cx, cy, ptz, SIZE, SIZE, BIG,
        init_state=_big_init(), mode="f64"))
    return out


@pytest.fixture(scope="module")
def jax_ref(tmp_path_factory):
    return ref.run_jax_reference("test_torch_rc_fast", "_guard_reference",
                                 tmp_path_factory.mktemp("rc_fast"))


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


def _recur_unflushed(zx, zy, cx, cy):
    """rc_tail.cu recur_exact: the operations with nothing flushed."""
    with np.errstate(all="ignore"):
        return (zx * zx - zy * zy) + cx, ((2.0 * zx) * zy) + cy


def _recur_twin(zx, zy, cx, cy):
    """The twin's flushed step (perturb_stream._f64_step), per sample c."""
    z = torch.from_numpy(np.stack([zx, zy], axis=1))
    ftz = hdr.ftz
    x, y = z[:, 0], z[:, 1]
    rx = ftz(ftz(ftz(x * x) - ftz(y * y)) + torch.from_numpy(cx))
    ry = ftz(ftz(ftz(2.0 * x) * y) + torch.from_numpy(cy))
    assert torch.equal(ps._f64_step(z[:1], (float(cx[0]), float(cy[0]))),
                       torch.stack([rx[:1], ry[:1]], dim=1))
    return rx.numpy(), ry.numpy()


def _samples(seed, lo, hi):
    rng = np.random.default_rng(seed)
    return [_components(rng, lo, hi) for _ in range(4)]


def _bits_equal(a, b):
    return np.asarray(a, np.float64).view(np.int64) == \
        np.asarray(b, np.float64).view(np.int64)


def test_unflushed_recurrence_equals_flushed_in_the_range():
    """Components in [-450, 500] and zeros: the unflushed recurrence has
    the twin's bits, signed zeros too, and every rounded product is a
    multiple of 2^-952 and every nonzero result at least 2^-952."""
    zx, zy, cx, cy = _samples(3, GUARD_LO, GUARD_HI)
    ux, uy = _recur_unflushed(zx, zy, cx, cy)
    tx, ty = _recur_twin(zx, zy, cx, cy)
    assert (_bits_equal(ux, tx) & _bits_equal(uy, ty)).all()
    for p in (zx * zx, zy * zy, (2.0 * zx) * zy):
        assert all((Fraction(float(v)) / LATTICE).denominator == 1
                   for v in p)
    for r in (zx * zx - zy * zy, ux, uy):
        r = np.abs(r)
        assert ((r == 0) | (r >= 2.0 ** -952)).all()


def test_unflushed_recurrence_is_not_flushed_below_the_range():
    """Components below 2^-450 (products near the subnormal range, a c
    low as small, or zero in half the samples): some results differ from
    the twin's, and not all."""
    zx, zy, cx, cy = _samples(5, -560, GUARD_LO - 1)
    cx[N // 2:] = 0.0
    cy[N // 2:] = 0.0
    ux, uy = _recur_unflushed(zx, zy, cx, cy)
    tx, ty = _recur_twin(zx, zy, cx, cy)
    same = _bits_equal(ux, tx) & _bits_equal(uy, ty)
    assert 0 < int((~same).sum()) < N


def test_anchor_rows_hold_values_and_position_bits():
    """tables.Anchors64: 32-byte rows (x, y, the position's int64 bits, a
    zero pad)."""
    comp = _orbit("guard_c")
    A = anchor_table_f64(comp, "cpu")
    assert A.rows.shape == (4, 4) and A.rows.dtype == torch.float64
    assert torch.equal(A.rows[:, 2].contiguous().view(torch.int64), A.index)
    assert torch.equal(A.index, torch.tensor([0, 40, 41, 90]))
    assert not bool(A.rows[:, 3].any())
    assert torch.equal(A.val, torch.from_numpy(np.stack(
        [comp.anchors_x, comp.anchors_y], axis=1)))


def _dc(device="cpu"):
    ptz, cx, cy = _view()
    return perturb._dc_grids_hdr(*perturb.delta_params(ptz, cx, cy, SIZE,
                                                       SIZE), SIZE, SIZE,
                                 device)


def _guard_mirror(kind):
    """The twin's run over a synthetic orbit with the kernel's guard
    mirrored on every recurrence it evaluates: (the grid, admitted,
    refused)."""
    counts = [0, 0]
    step = ps._f64_step

    def ok(v):
        e = torch.frexp(v).exponent - 1
        return (v == 0) | ((e >= GUARD_LO) & (e <= GUARD_HI))

    def guarded(z, c):
        c_in = bool(ok(torch.tensor(c, dtype=torch.float64)).all())
        adm = ok(z[:, 0]) & ok(z[:, 1]) & c_in
        counts[0] += int(adm.sum())
        counts[1] += int((~adm).sum())
        return step(z, c)

    ps._f64_step = guarded
    try:
        comp = _orbit(kind)
        A = anchor_table_f64(comp, "cpu")
        init = {k: torch.as_tensor(v) for k, v in _zero_init().items()}
        rem = rc_tail.rc_tail_gather_plain(A, _dc(), init, BUDGET,
                                           ps.wrap_value(comp, A.max_ref))
    finally:
        ps._f64_step = step
    return (BUDGET - rem).reshape(SIZE, SIZE), counts


@pytest.mark.parametrize("kind", list(GUARD_ORBITS))
def test_guard_orbits_twin_equals_jax_and_reaches_refused_steps(jax_ref,
                                                                kind):
    grid, (admitted, refused) = _guard_mirror(kind)
    np.testing.assert_array_equal(grid.numpy(),
                                  jax_ref[kind].astype(np.int64))
    assert refused > 0
    assert (admitted > 0) == (kind == "guard_mix")
    # the same through the public entry on the CPU
    ptz, cx, cy = _view()
    got = rc_tail.rc_tail_gather(_orbit(kind), cx, cy, ptz, SIZE, SIZE,
                                 BUDGET, {k: torch.as_tensor(v) for k, v in
                                          _zero_init().items()},
                                 device="cpu")
    assert torch.equal(got, grid)


def test_budget_past_2_31_equals_jax(jax_ref):
    """A budget of 2^31 + 40 handed over 40 iterations before its end, at
    positions 0-149 of the guard_mix orbit (each pixel catches up from
    its last anchor): the int64 grid equals the JAX gather's uint64 one,
    and some pixels run to the budget."""
    ptz, cx, cy = _view()
    got = rc_tail.rc_tail_gather(
        _orbit("guard_mix"), cx, cy, ptz, SIZE, SIZE, BIG,
        {k: torch.as_tensor(v) for k, v in _big_init().items()},
        device="cpu")
    want = jax_ref["big"]
    assert want.dtype == np.uint64
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))
    assert int(got.max()) == BIG and int(got.min()) >= BIG - BIG_LEFT


def test_k3_pin_is_the_jax_df32_gather():
    """The JAX package's View #6 RC 256² through its df32 gather (= its
    sweep) is the value the smoke pins K3's frame to; its f64 gather is
    the one-kernel frame."""
    assert cs.VIEW6_RC_256_GATHER["df32"] == cs.VIEW6_RC_256
    assert cs.VIEW6_RC_256_GATHER["f64"] == cs.VIEW6_256


def _run_state(A, dc, init, n, z_mr, chunk):
    """ps.rc_tail_run's loop, returning the whole state."""
    flat = HDRComplex(*(t.reshape(-1).contiguous() for t in dc))
    state = ps.handoff_state(A, init, dc.re.device)
    work = None
    while True:
        state = ps.rc_tail_kernel(A, flat, state, n, z_mr, chunk or 0,
                                  init=work is None, work=work)
        if bool(state[-1].all()):
            return state
        work = perturb.live_pixels(state[-1])


def _twin_state(A, dc, init, n, z_mr):
    flat = HDRComplex(*(t.reshape(-1).contiguous() for t in dc))
    st = ps.rc_init_plain(A, ps.handoff_state(A, init, dc.re.device), n,
                          z_mr)
    return ~st[-1], ps.rc_tail_plain(A, flat, st)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ORBITS)
@pytest.mark.parametrize("chunk", [None, 7])
def test_k19_matches_twin_on_synthetic_orbits_on_card(kind, chunk):
    """Every state array of the pixels live after the handoff (the others
    keep their handed-over z and anchor pointer), in one launch or in
    live-pixel launches of 7 steps; K19 alone."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from fractalshark_tpu_torch import kernels
    comp = _orbit(kind)
    got, want = {}, {}
    for dev in ("cuda", "cpu"):
        A = anchor_table_f64(comp, torch.device(dev))
        z_mr = ps.wrap_value(comp, A.max_ref)
        init = {k: torch.as_tensor(v).to(dev) for k, v in
                _zero_init().items()}
        kernels.reset_counts()
        if dev == "cuda":
            got = [t.cpu() for t in _run_state(A, _dc(dev), init, BUDGET,
                                               z_mr, chunk)]
            assert kernels.launches["rc_tail_f64"] >= 1
            assert kernels.launches["rc_tail"] == 0
        else:
            live, want = _twin_state(A, _dc(dev), init, BUDGET, z_mr)
    assert torch.equal(got[3], want[3])
    for a, b in zip(got, want):
        assert torch.equal(a[live], b[live])


@pytest.mark.cuda
@pytest.mark.parametrize("chunk", [None, 7])
def test_k19_budget_past_2_31_on_card(chunk):
    """The handoff of test_budget_past_2_31_equals_jax on the card: every
    state array of the live pixels equals the twin's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    comp = _orbit("guard_mix")
    got, want = {}, {}
    for dev in ("cuda", "cpu"):
        A = anchor_table_f64(comp, torch.device(dev))
        z_mr = ps.wrap_value(comp, A.max_ref)
        init = {k: torch.as_tensor(v).to(dev) for k, v in
                _big_init().items()}
        if dev == "cuda":
            got = [t.cpu() for t in _run_state(A, _dc(dev), init, BIG, z_mr,
                                               chunk)]
        else:
            live, want = _twin_state(A, _dc(dev), init, BIG, z_mr)
    for a, b in zip(got, want):
        assert torch.equal(a[live], b[live])
    assert torch.equal(got[3], want[3])


@pytest.mark.cuda
def test_k19_queue_form_matches_twin_on_card():
    """More pixels than the card holds lanes (1024² over the "alone"
    orbit, every step reconstructs): the queue form against the twin on
    the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda")
    size, n = 1024, 64
    comp = _orbit("alone")
    A = anchor_table_f64(comp, dev)
    z_mr = ps.wrap_value(comp, A.max_ref)
    ptz, cx, cy = _view()
    ptz = ptz.square_aspect_ratio(size, size)
    dc = perturb._dc_grids_hdr(*perturb.delta_params(ptz, cx, cy, size,
                                                     size), size, size, dev)
    z = torch.zeros((size, size), dtype=torch.int64, device=dev)
    dz = hdr.complex_zero((size, size), device=dev)
    init = {"dzr": dz.re, "dzi": dz.im, "dze": dz.e, "it": z, "jwait": z,
            "done": z.bool()}
    got = ps.rc_tail_run(A, dc, init, n, z_mr)
    want = rc_tail.rc_tail_gather_plain(A, dc, init, n, z_mr)
    assert torch.equal(got, want)
