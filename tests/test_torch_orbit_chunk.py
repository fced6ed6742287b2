"""K12, the chunk of device-orbit and NR steps in one launch
(``csrc/orbit_chunk.cu``), on the CPU: its plain twins
``orbit.orbit_chunk_plain`` and ``orbit.nr_chunk_plain`` against the JAX
package's orbit chunk and the exact Python-int recurrences, the choice of
its form by size, the block form's shared memory at its cap, and the
refusals of its wrappers.  A ``cuda``-marked test holds the kernel, both
forms and both instances, to the twins and the per-step loop on the card.
"""

import numpy as np
import pytest
import torch

import test_torch_jaxref as ref
from fractalshark_tpu_torch.core.highprecision import HighPrecision
from fractalshark_tpu_torch.ops.bignum import fixedpoint as FP
from fractalshark_tpu_torch.ops.bignum import orbit as O

# c of the 1e8 frame (tests/test_la_pallas.py); the orbit chunk starts
# from the first state past step 4 of c's orbit with both signs negative
# and runs CHUNK steps, not a power of two
CX = "-0.743643887037158704752191506114774"
CY = "0.131825904205311970493132056385139"
CHUNK = 37
CHUNK_LIMBS = (32, 2048)
NR_LIMBS = (16, 2048)
NR_STEPS = 5


def _digits(v: int, D: int) -> np.ndarray:
    return np.asarray([(v >> (16 * i)) & 0xFFFF for i in range(D)],
                      np.uint32)


def _rhu(v: int, spec):
    """(sign, magnitude) of round-half-up(v / 2^16F) mod 2^16D, the sign
    that of v + h, as the tails give it (a zero may be negative)."""
    shift = 16 * spec.frac_digits
    t = v + (1 << (shift - 1))
    return (-1 if t < 0 else 1), (abs(t) >> shift) % (1 << (16 * spec.digits))


def _orbit_steps(spec, z, c, steps):
    """The exact orbit recurrence from z = ((sx, x), (sy, y)) with signed
    c = (cx, cy) ints: the states after each step."""
    shift = 16 * spec.frac_digits
    out = []
    for _ in range(steps):
        (sx, x), (sy, y) = z
        X, Y = sx * x, sy * y
        z = (_rhu(X * X - Y * Y + (c[0] << shift), spec),
             _rhu(2 * X * Y + (c[1] << shift), spec))
        out.append(z)
    return out


def _mid_state(limbs: int):
    """(spec, c ints, c digits (scx, cx, scy, cy), z) with z the first
    state past step 4 of c's orbit whose signs are both negative."""
    spec = FP.FixedSpec.for_limbs(limbs)
    scx, cxd = FP.hp_to_digits(HighPrecision(CX, prec=200), spec)
    scy, cyd = FP.hp_to_digits(HighPrecision(CY, prec=200), spec)
    c = (scx * FP.digits_to_int(cxd), scy * FP.digits_to_int(cyd))
    z = ((scx, FP.digits_to_int(cxd)), (scy, FP.digits_to_int(cyd)))
    for k, z in enumerate(_orbit_steps(spec, z, c, 64)):
        if k >= 4 and z[0][0] < 0 and z[1][0] < 0:
            return spec, c, (scx, cxd, scy, cyd), z
    raise AssertionError("no state with two negative signs")


def _row(spec, z) -> np.ndarray:
    (sx, x), (sy, y) = z
    return FP.shadow_row_np(sx, _digits(x, spec.digits), sy,
                            _digits(y, spec.digits))


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a).astype(np.int32))


def _plain_chunk(limbs: int):
    spec, c, (scx, cxd, scy, cyd), z = _mid_state(limbs)
    (sx, x), (sy, y) = z
    out = O.orbit_chunk_plain(
        _t(_digits(x, spec.digits)), _t(_digits(y, spec.digits)),
        torch.from_numpy(_row(spec, z)), scx, _t(cxd), scy, _t(cyd), spec,
        CHUNK)
    return spec, c, z, out


# ----------------------------------------------------------- JAX side


def _jax_reference(inputs):
    import jax.numpy as jnp

    from fractalshark_tpu.ops.bignum import fixedpoint as JFP
    from fractalshark_tpu.ops.bignum import orbit as JO

    class _SplitRoute:
        """fixedpoint as orbit.py sees it on the TPU: the fused-tail gate
        open, so the chunk is the digit scan of the split bookkeeping."""
        def __getattr__(self, name):
            return getattr(JFP, name)

        @staticmethod
        def _use_fused_tail(nf, D):
            return True

    JO.FP = _SplitRoute()
    JO.orbit_chunk.clear_cache()
    out = {}
    for limbs in CHUNK_LIMBS:
        spec, _, (scx, cxd, scy, cyd), z = _mid_state(limbs)
        (sx, x), (sy, y) = z
        D = spec.digits
        zero = jnp.float64(0)
        (nsx, nx, nsy, ny), rows = JO.orbit_chunk(
            jnp.int32(sx), jnp.asarray(_digits(x, D)), jnp.int32(sy),
            jnp.asarray(_digits(y, D)), zero, zero, jnp.int32(0),
            jnp.int32(scx), jnp.asarray(cxd), jnp.int32(scy),
            jnp.asarray(cyd), zero, jnp.int32(0), zero, zero,
            spec=JFP.FixedSpec.for_limbs(limbs), steps=CHUNK)
        for k, v in (("sx", nsx), ("x", nx), ("sy", nsy), ("y", ny),
                     ("rows", rows)):
            out[f"{limbs}_{k}"] = np.asarray(v)
    return out


def _jax_wide(_inputs):
    """The JAX package's chunk (split-bookkeeping route) at WIDE_LIMBS,
    WIDE_STEPS steps from View #30's centre."""
    import jax.numpy as jnp

    from fractalshark_tpu.ops.bignum import fixedpoint as JFP
    from fractalshark_tpu.ops.bignum import orbit as JO

    class _SplitRoute:
        def __getattr__(self, name):
            return getattr(JFP, name)

        @staticmethod
        def _use_fused_tail(nf, D):
            return True

    JO.FP = _SplitRoute()
    JO.orbit_chunk.clear_cache()
    spec, _, scx, cxd, scy, cyd = _wide_centre()
    zero = jnp.float64(0)
    args = (jnp.int32(scx), jnp.asarray(cxd), jnp.int32(scy),
            jnp.asarray(cyd))
    (nsx, nx, nsy, ny), rows = JO.orbit_chunk(
        *args, zero, zero, jnp.int32(0), *args, zero, jnp.int32(0), zero,
        zero, spec=JFP.FixedSpec.for_limbs(WIDE_LIMBS), steps=WIDE_STEPS)
    return {"sx": np.asarray(nsx), "x": np.asarray(nx),
            "sy": np.asarray(nsy), "y": np.asarray(ny),
            "rows": np.asarray(rows)}


@pytest.fixture(scope="module", autouse=True)
def jax_refs(tmp_path_factory):
    """The module's three JAX references (``_jax_reference``,
    ``_jax_wide``, ``_jax_nr_wide``), started together in the background
    when the module starts; each is read, and waited for, at first use."""
    nr_inputs = {}
    for case in NR_WIDE_CASES:
        _, st = _nr_wide_state(case)
        nr_inputs[f"{case}_signs"] = np.asarray(st[0::2], np.int32)
        nr_inputs[f"{case}_digits"] = np.stack(st[1::2]).astype(np.uint32)
    return {func: ref.Background(ref.run_jax_reference,
                                 "test_torch_orbit_chunk", func,
                                 tmp_path_factory.mktemp(func.strip("_")),
                                 inputs)
            for func, inputs in (("_jax_reference", None),
                                 ("_jax_wide", None),
                                 ("_jax_nr_wide", nr_inputs))}


@pytest.fixture(scope="module")
def jax_ref(jax_refs):
    return jax_refs["_jax_reference"]


# ----------------------------------------------------------- the twins


@pytest.mark.parametrize("limbs", CHUNK_LIMBS)
def test_orbit_chunk_plain_equals_jax(jax_ref, limbs):
    """Rows of the pre-update z and the final state equal the JAX
    package's chunk (its split-bookkeeping scan) from a mid-orbit state
    whose signs are both negative."""
    _, _, z, (x, y, rows) = _plain_chunk(limbs)
    assert z[0][0] == z[1][0] == -1
    np.testing.assert_array_equal(rows[:CHUNK].numpy(),
                                  jax_ref[f"{limbs}_rows"].T)
    assert int(rows[CHUNK, 10]) == int(jax_ref[f"{limbs}_sx"])
    assert int(rows[CHUNK, 11]) == int(jax_ref[f"{limbs}_sy"])
    np.testing.assert_array_equal(x.numpy().astype(np.uint32),
                                  jax_ref[f"{limbs}_x"])
    np.testing.assert_array_equal(y.numpy().astype(np.uint32),
                                  jax_ref[f"{limbs}_y"])


@pytest.mark.parametrize("limbs", CHUNK_LIMBS)
def test_orbit_chunk_plain_equals_int_recurrence(limbs):
    spec, c, z, (x, y, rows) = _plain_chunk(limbs)
    want = _orbit_steps(spec, z, c, CHUNK)
    np.testing.assert_array_equal(rows[0].numpy(), _row(spec, z))
    for k, w in enumerate(want):
        np.testing.assert_array_equal(rows[k + 1].numpy(), _row(spec, w))
    (sx, wx), (sy, wy) = want[-1]
    assert FP.digits_to_int(x.numpy()) == wx
    assert FP.digits_to_int(y.numpy()) == wy
    assert (int(rows[CHUNK, 10]), int(rows[CHUNK, 11])) == (sx, sy)


def _nr_oracle_steps(spec, st, steps):
    """The exact wrapped NR recurrence (z ← z² + c, dz/dc ← 2·z·dz/dc +
    1 from the pre-update z) on (sign, magnitude) pairs."""
    shift = 16 * spec.frac_digits
    z = [(st[2 * k], FP.digits_to_int(st[2 * k + 1])) for k in range(4)]
    cx, cy = (st[8] * FP.digits_to_int(st[9]),
              st[10] * FP.digits_to_int(st[11]))
    for _ in range(steps):
        x, y, dx, dy = (s * m for s, m in z)
        z = [_rhu(x * x - y * y + (cx << shift), spec),
             _rhu(2 * x * y + (cy << shift), spec),
             _rhu(2 * (x * dx - y * dy) + (1 << (2 * shift)), spec),
             _rhu(2 * (x * dy + y * dx), spec)]
    return z


def _nr_state(limbs: int, seed: int):
    """A random NR state: z and c below 4, every digit of dz/dc random (so
    |dz/dc| wraps), signs mixed."""
    spec = FP.FixedSpec.for_limbs(limbs)
    rng = np.random.default_rng(7000 + limbs + seed)
    st = []
    for k, sign in enumerate((-1, 1, -1, -1, 1, -1)):
        d = rng.integers(0, 1 << 16, size=spec.digits, dtype=np.uint32)
        if k not in (2, 3):
            d[-1] = 0
            d[-2] &= 3
        st += [sign, d]
    return spec, st


@pytest.mark.parametrize("limbs", NR_LIMBS)
def test_nr_chunk_plain_equals_wrapped_recurrence(limbs):
    spec, st = _nr_state(limbs, 0)
    signs, *mags = O.nr_chunk_plain(
        FP.sign_row(*st[0:8:2], "cpu"), *[_t(d) for d in st[1:8:2]],
        st[8], _t(st[9]), st[10], _t(st[11]), spec, NR_STEPS)
    want = _nr_oracle_steps(spec, st, NR_STEPS)
    got = [(int(s), FP.digits_to_int(m.numpy())) for s, m in
           zip(signs, mags)]
    assert got == [tuple(w) for w in want]


# ----------------------------------------------------------- the forms


# the smoke's size classes and the form the route gives the orbit and NR
# (at 32,768 limbs, D = 2^16, K12's grid form takes both)
FORMS = [(8, "block"), (16, "block"), (32, "block"), (128, "block"),
         (256, "grid"), (512, "grid"), (1024, "grid"), (2048, "grid"),
         (16384, "grid"), (32768, "grid")]


@pytest.mark.parametrize("limbs,form", FORMS)
def test_chunk_form_by_size(limbs, form):
    """The form by transform size, the same for the orbit (2 values) and
    NR (4 values), and one that takes the size for both, up to D = 2^16
    (32,768 limbs: the grid form for both, and the NR step takes it,
    its digit sums below 2^50)."""
    spec = FP.FixedSpec.for_limbs(limbs)
    assert O.chunk_form(spec) == form
    assert O.chunk_form(spec, 4) == form
    O.check_chunk(spec, form, 2)
    O.check_chunk(spec, form, 4)
    FP.check_nr(spec)


@pytest.mark.parametrize("values,largest", [(2, 4096), (4, 2048)])
def test_block_form_shared_memory_at_its_cap(values, largest):
    """The block form's shared memory at the largest transform the route
    gives it, and the largest transform that fits a block at all (nfft
    4,096 for the orbit, 2,048 for NR): check_chunk takes the one and
    refuses the next."""
    n = O.BLOCK_MAX_NFFT
    assert O.block_smem_bytes(n, n // 2, values) <= O.SMEM_PER_BLOCK
    assert O.block_smem_bytes(largest, largest // 2,
                              values) <= O.SMEM_PER_BLOCK
    assert O.block_smem_bytes(2 * largest, largest,
                              values) > O.SMEM_PER_BLOCK
    O.check_chunk(FP.FixedSpec(digits=largest // 2, nfft=largest), "block",
                  values)
    with pytest.raises(ValueError, match="shared memory"):
        O.check_chunk(FP.FixedSpec(digits=largest, nfft=2 * largest),
                      "block", values)
    for limbs in (8, 32, 128):
        assert O.chunk_form(FP.FixedSpec.for_limbs(limbs)) == "block"


def test_chunk_wrappers_refuse_sizes_past_the_bounds():
    """D <= 2^16 for the orbit and NR (their digit sums below 2^50),
    nfft <= 2^17 (K4-NR's cap); the refusal comes before any launch, so
    it shows on CPU tensors.  The default route leaves K12 only past D =
    2^16 or nfft = 2^17 (65,536 limbs and up): the orbit to the per-step
    loop, while the NR step refuses it."""
    wide = FP.FixedSpec(digits=1 << 16, nfft=1 << 17)
    past = FP.FixedSpec(digits=(1 << 16) + 1, nfft=1 << 18)
    long = FP.FixedSpec(digits=1 << 10, nfft=1 << 18)
    for values in (2, 4):
        assert O.chunk_form(wide, values) == "grid"
        O.check_chunk(wide, "grid", values)
    FP.check_nr(wide)
    for spec in (past, FP.FixedSpec.for_limbs(65536)):
        assert O.chunk_form(spec) == O.chunk_form(spec, 4) == "steps"
        with pytest.raises(ValueError, match="NR step needs"):
            FP.check_nr(spec)
    assert O.chunk_form(long) == O.chunk_form(long, 4) == "steps"
    for form in ("block", "grid"):
        for values in (2, 4):
            for spec in (long, past):
                with pytest.raises(ValueError, match="K12 takes"):
                    O.check_chunk(spec, form, values)
    with pytest.raises(ValueError, match="shared memory"):
        O.check_chunk(wide, "block", 2)
    with pytest.raises(ValueError, match="shared memory"):
        O.check_chunk(FP.FixedSpec.for_limbs(2048), "block", 2)
    with pytest.raises(ValueError, match="nfft ≥ 1,024"):
        O.check_chunk(FP.FixedSpec.for_limbs(128), "grid", 2)
    v = torch.zeros(long.digits, dtype=torch.int32)
    state = O.OrbitState(1, v.numpy(), 1, v.numpy(), "cpu")
    rows = torch.zeros(2, FP.ROW, dtype=torch.int32)
    with pytest.raises(ValueError, match="K12 takes"):
        O.launch_orbit_chunk(state, rows, 1, v, 1, v, long, 1, None, "grid")
    v = torch.zeros(past.digits, dtype=torch.int32)
    nr = O.NRState((1, 1, 1, 1), v, v, v, v, "cpu")
    with pytest.raises(ValueError, match="K12 takes"):
        O.launch_nr_chunk(nr, 1, v, 1, v, past, 1, None, "grid")
    with pytest.raises(ValueError, match="NR step needs"):
        O.orbit_nr_chunk(nr, 1, v, 1, v, past, 1)


# ------------------------------------------- 32,768 limbs (D = 2^16)
# View #30's centre at 32,768 limbs: its imaginary part carries 1,661
# fractional digits of 0xFFFF, so the carries cross the whole width
WIDE_LIMBS = 32768
WIDE_STEPS = 3


def _wide_centre():
    """(spec, c ints, scx, cx digits, scy, cy digits) of View #30's
    centre at WIDE_LIMBS."""
    from fractalshark_tpu_torch.core.views import get_view_preset
    spec = FP.FixedSpec.for_limbs(WIDE_LIMBS)
    ptz = get_view_preset(30).ptz
    prec = spec.frac_bits - 20
    scx, cxd = FP.hp_to_digits(ptz.pt_x.with_precision(prec), spec)
    scy, cyd = FP.hp_to_digits(ptz.pt_y.with_precision(prec), spec)
    c = (scx * FP.digits_to_int(cxd), scy * FP.digits_to_int(cyd))
    return spec, c, scx, cxd, scy, cyd


@pytest.fixture(scope="module")
def wide_plain():
    """(spec, c, z, (x, y, rows)): the plain chunk at D = 2^16,
    WIDE_STEPS steps from z = c (View #30's centre)."""
    spec, c, scx, cxd, scy, cyd = _wide_centre()
    z = ((scx, FP.digits_to_int(cxd)), (scy, FP.digits_to_int(cyd)))
    out = O.orbit_chunk_plain(
        _t(cxd), _t(cyd), torch.from_numpy(_row(spec, z)), scx, _t(cxd),
        scy, _t(cyd), spec, WIDE_STEPS)
    return spec, c, z, out


@pytest.fixture(scope="module")
def jax_wide(jax_refs):
    return jax_refs["_jax_wide"]


def test_orbit_chunk_plain_at_32768_limbs_equals_int_recurrence(wide_plain):
    """The plain chunk at D = 2^16, WIDE_STEPS steps from z = c (View
    #30's centre, a 0xFFFF run of 1,661 digits): rows and state = the
    Python-int recurrence, exactly."""
    spec, c, z, (x, y, rows) = wide_plain
    assert spec.digits == 1 << 16 and O.chunk_form(spec) == "grid"
    assert (_digits(z[1][1], spec.digits)[-2 - 1661:-2] == 0xFFFF).all()
    want = _orbit_steps(spec, z, c, WIDE_STEPS)
    np.testing.assert_array_equal(rows[0].numpy(), _row(spec, z))
    for k, w in enumerate(want):
        np.testing.assert_array_equal(rows[k + 1].numpy(), _row(spec, w))
    (_, wx), (_, wy) = want[-1]
    assert FP.digits_to_int(x.numpy()) == wx
    assert FP.digits_to_int(y.numpy()) == wy


def test_orbit_chunk_plain_at_32768_limbs_equals_jax(wide_plain, jax_wide):
    """The same chunk = the JAX package's (its split-bookkeeping scan at
    32,768 limbs): rows, signs and digits, exactly."""
    _, _, _, (x, y, rows) = wide_plain
    np.testing.assert_array_equal(rows[:WIDE_STEPS].numpy(),
                                  jax_wide["rows"].T)
    assert int(rows[WIDE_STEPS, 10]) == int(jax_wide["sx"])
    assert int(rows[WIDE_STEPS, 11]) == int(jax_wide["sy"])
    np.testing.assert_array_equal(x.numpy().astype(np.uint32), jax_wide["x"])
    np.testing.assert_array_equal(y.numpy().astype(np.uint32), jax_wide["y"])


# ------------------------------------- NR at 32,768 limbs (D = 2^16)
# One NR step at D = 2^16 (nfft 2^17): from View #32's centre at its
# precision (811,541 bits, orbit.nr_limbs: 32,768 limbs) with z = c and
# dz/dc = 1, the feature finder's start; and from every digit of x, y,
# dx, dy and c at 0xFFFF with the signs that make u = x·dx + y·dy, which
# drives |2u| to 4D·(2^16 − 1)^2 = 2^50 − 2^35 + 2^18, the digit sums'
# bound.
NR_WIDE_CASES = ("view32", "ffff")


def _nr_wide_state(case: str):
    """(spec, state list [sx, x, sy, y, sdx, dx, sdy, dy, scx, cx, scy,
    cy] of numpy uint32 digits) of an NR_WIDE_CASES case."""
    spec = FP.FixedSpec.for_limbs(WIDE_LIMBS)
    D = spec.digits
    if case == "ffff":
        f = np.full(D, 0xFFFF, np.uint32)
        return spec, [1, f, 1, f, 1, f, -1, f, 1, f, 1, f]
    from fractalshark_tpu_torch.core.views import get_view_preset
    ptz = get_view_preset(32).ptz
    assert O.nr_limbs(ptz.pt_x.prec) == WIDE_LIMBS
    scx, cxd = FP.hp_to_digits(ptz.pt_x, spec)
    scy, cyd = FP.hp_to_digits(ptz.pt_y, spec)
    one_s, one_d = FP.hp_to_digits(HighPrecision(1, prec=64), spec)
    return spec, [scx, cxd, scy, cyd, one_s, one_d, 1,
                  np.zeros(D, np.uint32), scx, cxd, scy, cyd]


def _jax_nr_wide(inputs):
    """The JAX package's iterate_z_nr, one step of each NR_WIDE_CASES
    state (its digits and signs in ``inputs``), jitted: integer
    arithmetic throughout, so the jit changes no bit, and it compiles in
    a few seconds where the op-by-op first call takes most of a minute."""
    import jax
    import jax.numpy as jnp

    from fractalshark_tpu.ops.bignum import fixedpoint as JFP
    spec = JFP.FixedSpec.for_limbs(WIDE_LIMBS)
    step = jax.jit(JFP.iterate_z_nr, static_argnames=("spec",))
    out = {}
    for case in NR_WIDE_CASES:
        signs = inputs[f"{case}_signs"]
        digits = inputs[f"{case}_digits"]
        args = []
        for k in range(6):
            args += [jnp.int32(int(signs[k])), jnp.asarray(digits[k])]
        st = step(*args, spec=spec)
        for k in range(4):
            out[f"{case}_s{k}"] = np.asarray(st[2 * k])
            out[f"{case}_d{k}"] = np.asarray(st[2 * k + 1])
    return out


@pytest.fixture(scope="module")
def jax_nr_wide(jax_refs):
    return jax_refs["_jax_nr_wide"]


@pytest.fixture(scope="module")
def nr_wide_plain():
    """{case: (spec, state, (signs, x, y, dx, dy))}: one plain NR step of
    each NR_WIDE_CASES state; View #32's through the feature finder's
    device evaluator on the CPU (critical_orbit_state_device, period 2)."""
    out = {}
    for case in NR_WIDE_CASES:
        spec, st = _nr_wide_state(case)
        if case == "view32":
            from fractalshark_tpu_torch.core.views import get_view_preset
            ptz = get_view_preset(32).ptz
            got_spec, state = O.critical_orbit_state_device(
                ptz.pt_x, ptz.pt_y, 2, ptz.pt_x.prec, device="cpu")
            assert got_spec == spec
            res = (state.signs, state.x, state.y, state.dx, state.dy)
        else:
            res = O.nr_chunk_plain(FP.sign_row(*st[0:8:2], "cpu"),
                                   *[_t(d) for d in st[1:8:2]], st[8],
                                   _t(st[9]), st[10], _t(st[11]), spec, 1)
        out[case] = (spec, st, res)
    return out


@pytest.mark.parametrize("case", NR_WIDE_CASES)
def test_nr_step_at_32768_limbs_equals_int_recurrence(nr_wide_plain, case):
    """C12: the NR step at D = 2^16 is taken (K12's grid form on the
    card) and its plain chunk = the exact wrapped Python-int recurrence,
    signs and digits, from View #32's centre and from the all-0xFFFF
    state at the digit sums' bound."""
    spec, st, (signs, *mags) = nr_wide_plain[case]
    assert spec.digits == 1 << 16 and O.chunk_form(spec, 4) == "grid"
    O.check_chunk(spec, "grid", 4)
    want = _nr_oracle_steps(spec, st, 1)
    got = [(int(s), FP.digits_to_int(m.numpy())) for s, m in
           zip(signs, mags)]
    assert got == [tuple(w) for w in want]


@pytest.mark.parametrize("case", NR_WIDE_CASES)
def test_nr_step_at_32768_limbs_equals_jax(nr_wide_plain, jax_nr_wide, case):
    """The same step = the JAX package's iterate_z_nr (FMA off), signs
    and digits, exactly."""
    _, _, (signs, *mags) = nr_wide_plain[case]
    for k in range(4):
        assert int(signs[k]) == int(jax_nr_wide[f"{case}_s{k}"])
        np.testing.assert_array_equal(mags[k].numpy().astype(np.uint32),
                                      jax_nr_wide[f"{case}_d{k}"])


# ----------------------------------------------------------- on the card


@pytest.mark.cuda
def test_k12_matches_twins_and_the_loop_on_card():
    """K12 in every form that takes the size, both instances: equal to
    the plain chunk and to the per-step loop of K4 then K5 (K4-NR then
    K5-NR)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda")
    for limbs in (32, 256, 2048):
        spec, _, (scx, cxd, scy, cyd), z = _mid_state(limbs)
        (sx, x), (sy, y) = z
        xd, yd = _digits(x, spec.digits), _digits(y, spec.digits)
        cx, cy = _t(cxd).to(dev), _t(cyd).to(dev)
        want = O.orbit_chunk_plain(_t(xd), _t(yd),
                                   torch.from_numpy(_row(spec, z)), scx,
                                   _t(cxd), scy, _t(cyd), spec, CHUNK)
        scratch = O._Scratch(spec, dev)
        for form in ("steps", "block", "grid"):
            try:
                O.check_chunk(spec, form, 2)
            except ValueError:
                continue
            state = O.OrbitState(sx, xd, sy, yd, dev)
            rows = torch.empty(CHUNK + 1, FP.ROW, dtype=torch.int32,
                               device=dev)
            rows[0] = state.row
            O.launch_orbit_chunk(state, rows, scx, cx, scy, cy, spec, CHUNK,
                                 scratch, form)
            for a, b in zip((state.x, state.y, rows), want):
                assert torch.equal(a.cpu(), b), (limbs, form)
        nspec, st = _nr_state(limbs, 1)
        want = O.nr_chunk_plain(FP.sign_row(*st[0:8:2], "cpu"),
                                *[_t(d) for d in st[1:8:2]], st[8],
                                _t(st[9]), st[10], _t(st[11]), nspec,
                                NR_STEPS)
        scratch = O._Scratch(nspec, dev, values=4)
        for form in ("steps", "block", "grid"):
            try:
                O.check_chunk(nspec, form, 4)
            except ValueError:
                continue
            nr = O.NRState(st[0:8:2], *st[1:8:2], dev)
            O.launch_nr_chunk(nr, st[8], _t(st[9]).to(dev), st[10],
                              _t(st[11]).to(dev), nspec, NR_STEPS, scratch,
                              form)
            for a, b in zip((nr.signs, nr.x, nr.y, nr.dx, nr.dy), want):
                assert torch.equal(a.cpu(), b), (limbs, form)


def _k12_refuses(spec, values, grid, dev) -> bool:
    """Whether K12's C entry itself (no wrapper check) refuses one step
    at ``spec``'s size from a zero state."""
    from fractalshark_tpu_torch import kernels
    z = torch.zeros(spec.digits, dtype=torch.int32, device=dev)
    st = [z.clone() for _ in range(values)]
    lg = spec.nfft.bit_length() - 1
    scratch = O._Scratch(spec, dev, values=values)
    bufs = [t.data_ptr() for t in scratch.grid()] if grid else [None] * 3
    tables = scratch.tables.data_ptr()
    stream = kernels.stream(dev)
    if values == 2:
        rows = torch.zeros(2, FP.ROW, dtype=torch.int32, device=dev)
        rc = kernels.lib().fs_orbit_chunk_k12(
            st[0].data_ptr(), st[1].data_ptr(), rows.data_ptr(),
            z.data_ptr(), z.data_ptr(), 1, 1, *bufs, tables, spec.digits,
            lg, 1, int(grid), None, 0, stream)
    else:
        signs = torch.ones(4, dtype=torch.int32, device=dev)
        rc = kernels.lib().fs_nr_chunk_k12(
            *[t.data_ptr() for t in st], signs.data_ptr(), z.data_ptr(),
            z.data_ptr(), 1, 1, *bufs, tables, spec.digits, lg, 1,
            int(grid), stream)
    torch.cuda.synchronize(dev)
    return rc != 0


@pytest.mark.cuda
def test_k12_c_limits_match_the_wrapper_on_card():
    """The wrapper's mirror of K12's limits is the C's: the block form's
    shared memory (fs_k12_block_bytes) at every transform size, and the C
    entry refuses exactly where check_chunk does, at the block form's
    shared-memory cap, the grid form's smallest transform and each
    instance's most digits."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from fractalshark_tpu_torch import kernels
    dev = torch.device("cuda")
    for values in (2, 4):
        for lg in range(5, 18):
            n = 1 << lg
            assert kernels.lib().fs_k12_block_bytes(lg, n // 2, values) == \
                O.block_smem_bytes(n, n // 2, values), (values, n)
    for values, largest in ((2, 4096), (4, 2048)):
        for n in (largest, 2 * largest):
            spec = FP.FixedSpec(digits=n // 2, nfft=n)
            try:
                O.check_chunk(spec, "block", values)
                refused = False
            except ValueError:
                refused = True
            assert _k12_refuses(spec, values, False, dev) == refused
        for n in (512, 1024):
            spec = FP.FixedSpec(digits=n // 2, nfft=n)
            refused = n < O.K12_GRID_MIN_NFFT
            assert _k12_refuses(spec, values, True, dev) == refused
    # D = 2^16: both instances' grid form takes it, as check_chunk does;
    # D = 2^16 + 1 is refused (at nfft 2^17 it wraps, at 2^18 it is past
    # the cap)
    wide = FP.FixedSpec(digits=1 << 16, nfft=1 << 17)
    for values in (2, 4):
        assert not _k12_refuses(wide, values, True, dev)
        assert wide.digits == O.K12_MAX_DIGITS[values]
        for nfft in (1 << 17, 1 << 18):
            past = FP.FixedSpec(digits=(1 << 16) + 1, nfft=nfft)
            assert _k12_refuses(past, values, True, dev)


@pytest.mark.cuda
def test_k12_at_32768_limbs_equals_the_loop_on_card(wide_plain):
    """K12's grid form at D = 2^16 (32,768 limbs, nfft 2^17): = the plain
    chunk over WIDE_STEPS steps from View #30's centre, and = the
    per-step loop of K4 then K5 over a 256-step chunk from there, rows
    and state bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda")
    spec, _, z, want = wide_plain
    _, _, scx, cxd, scy, cyd = _wide_centre()
    cx, cy = _t(cxd).to(dev), _t(cyd).to(dev)
    scratch = O._Scratch(spec, dev)
    outs = {}
    for form, steps in (("grid", WIDE_STEPS), ("grid", 256),
                        ("steps", 256)):
        state = O.OrbitState(scx, cxd, scy, cyd, dev)
        rows = torch.empty(steps + 1, FP.ROW, dtype=torch.int32, device=dev)
        rows[0] = state.row
        O.launch_orbit_chunk(state, rows, scx, cx, scy, cy, spec, steps,
                             scratch, form)
        outs[form, steps] = (state.x.cpu(), state.y.cpu(), rows.cpu())
    for a, b in zip(outs["grid", WIDE_STEPS], want):
        assert torch.equal(a, b)
    for a, b in zip(outs["grid", 256], outs["steps", 256]):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_k12_nr_at_32768_limbs_equals_the_plain_chunk_on_card(nr_wide_plain):
    """C12 on the card: K12-NR's grid form at D = 2^16 = the plain chunk
    from both NR_WIDE_CASES states (one step), and = the per-step loop of
    K4-NR then K5-NR over 3 steps from View #32's centre."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda")
    for case in NR_WIDE_CASES:
        spec, st, want = nr_wide_plain[case]
        scratch = O._Scratch(spec, dev, values=4)
        cx, cy = _t(st[9]).to(dev), _t(st[11]).to(dev)
        outs = {}
        for form, steps in (("grid", 1), ("grid", 3), ("steps", 3)):
            nr = O.NRState(st[0:8:2], *st[1:8:2], dev)
            O.launch_nr_chunk(nr, st[8], cx, st[10], cy, spec, steps,
                              scratch, form)
            outs[form, steps] = [t.cpu() for t in
                                 (nr.signs, nr.x, nr.y, nr.dx, nr.dy)]
        for a, b in zip(outs["grid", 1], want):
            assert torch.equal(a, b), case
        for a, b in zip(outs["grid", 3], outs["steps", 3]):
            assert torch.equal(a, b), case
