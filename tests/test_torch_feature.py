"""The feature finder of the PyTorch/CUDA port on the CPU: the NR step's
plain twins (K4-NR, K5-NR) against the JAX package's ``iterate_z_nr``,
its Pallas NR-products kernel (B8b, in interpret mode) and the exact
Python-int oracle of ``tests/test_paired.py:135-160``; the device
evaluator and device refinement against the JAX package's; the copied
host paths and the CLI's feature commands against the JAX package's.

Tolerance: equal digits and signs everywhere, except the comparisons of
the device evaluator with the host evaluator, which use the reference
test's own bound (within 2^-150 relative, ``tests/test_nr_device.py``).

dz/dc lives in the orbit's fixed point (2 integer digits), so its
magnitude wraps modulo 2^32 once |dz/dc| ≥ 2^32, in the reference and
in the port alike; the oracle below wraps the same way, and the random
states here put |2·z·dz/dc| past 2^32.
"""

import contextlib
import io
import json

import numpy as np
import pytest
import torch

import test_torch_jaxref as ref
from fractalshark_tpu_torch import cli
from fractalshark_tpu_torch.core.highprecision import HighPrecision
from fractalshark_tpu_torch.core.pointzoom import PointZoomBBConverter
from fractalshark_tpu_torch.engine import feature_finder as FF
from fractalshark_tpu_torch.ops.bignum import fixedpoint as FP
from fractalshark_tpu_torch.ops.bignum import ntt as N
from fractalshark_tpu_torch.ops.bignum import orbit as O

NR_LIMBS = (8, 8192)
B8B_LIMBS = 2048           # nfft 8,192, B8b's smallest size
STATES = 3                 # random states per size
PERIOD3_RE = "-1.754877666246692760049520"
# the period-858 nucleus near the zoom-1e8 view's centre, as the JAX
# package's feature finder gives it (40 digits, 208 bits)
NUCLEUS_858 = ("-7.436439788719175333769749883804773785841e-01",
               "1.318259410297359947061587497198248392972e-01")
ZOOM_1E8 = ("-0.743643887037158704752191506114774",
            "0.131825904205311970493132056385139", "1e8")
# tests/test_cli.py:80-90
SCAN_ARGS = ["--center-x", "-1.75487766624669276", "--center-y", "0",
             "--zoom", "100000", "--feature-scan", "3x3",
             "--feature-max-period", "64", "--width", "32", "--height", "32"]
FIND_ARGS = ["--center-x", ZOOM_1E8[0], "--center-y", ZOOM_1E8[1],
             "--zoom", ZOOM_1E8[2], "--feature-find",
             "--feature-max-period", "3000", "--width", "32",
             "--height", "32"]
SCAN_MODES = ("direct", "pt", "la")


def nr_state(limbs: int, seed: int):
    """(spec, [sx, x, sy, y, sdx, dx, sdy, dy, scx, cx, scy, cy]): z and c
    random below 4 with mixed signs, dz/dc with every digit random (so
    |dz/dc| is near 2^32 and |2·z·dz/dc| wraps).  Seed 0 is the zero
    state: z = 0, dz/dc = 0, c = (−1 ulp, 0), whose x' is a zero of sign
    −1 and whose y' and dy' are zeros of sign +1."""
    spec = FP.FixedSpec.for_limbs(limbs)
    D = spec.digits
    rng = np.random.default_rng(1000 * limbs + seed)
    out = []
    for k in range(6):
        d = rng.integers(0, 1 << 16, size=D, dtype=np.uint32)
        if k not in (2, 3):
            d[-1] = 0
            d[-2] &= 3
        out += [int(rng.choice([-1, 1])), d]
    if seed == 0:
        for k in (1, 3, 5, 7, 11):
            out[k] = np.zeros(D, np.uint32)
        out[9] = np.zeros(D, np.uint32)
        out[9][0] = 1
        out[8] = -1
    return spec, out


def nr_oracle(spec, sx, x, sy, y, sdx, dx, sdy, dy, scx, cx, scy, cy):
    """The exact wrapped NR step: ((sign, magnitude) of x', y', dx', dy')
    with rhu(v) = (sign(v + h), (|v + h| >> 16F) mod 2^(16D)), and
    whether a magnitude of dz/dc' wrapped."""
    ints = [s * FP.digits_to_int(d) for s, d in
            ((sx, x), (sy, y), (sdx, dx), (sdy, dy), (scx, cx), (scy, cy))]
    xi, yi, dxi, dyi, cxi, cyi = ints
    shift = 16 * spec.frac_digits
    half = 1 << (shift - 1)

    def rhu(v):
        t = v + half
        return (1 if t >= 0 else -1), abs(t) >> shift

    out = (rhu(xi * xi - yi * yi + (cxi << shift)),
           rhu(2 * xi * yi + (cyi << shift)),
           rhu(2 * (xi * dxi - yi * dyi) + (1 << (2 * shift))),
           rhu(2 * (xi * dyi + yi * dxi)))
    mod = 1 << (16 * spec.digits)
    wrapped = out[2][1] >= mod or out[3][1] >= mod
    return tuple((s, m % mod) for s, m in out), wrapped


def hp_key(v) -> str:
    """An exact text form of a HighPrecision (mantissa, exponent)."""
    return f"{v.mant}p{v.exp}"


def cli_json(main, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(argv)
    return rc, buf.getvalue().strip().splitlines()[-1]


def feature_key(fs) -> str:
    return json.dumps({"cx": hp_key(fs.center_x), "cy": hp_key(fs.center_y),
                       "period": fs.period, "steps": fs.nr_iterations,
                       "residual": fs.residual_exp2,
                       "size": [float(fs.size_estimate.m),
                                int(fs.size_estimate.e)]})


# ----------------------------------------------------------- JAX side


def _jax_reference(inputs):
    import jax
    import jax.numpy as jnp

    from fractalshark_tpu.cli import main
    from fractalshark_tpu.core.highprecision import HighPrecision as JHP
    from fractalshark_tpu.core.pointzoom import PointZoomBBConverter as JPZ
    from fractalshark_tpu.engine import feature_finder as JFF
    from fractalshark_tpu.ops.bignum import fixedpoint as JFP
    from fractalshark_tpu.ops.bignum import ntt_mxu as NM
    from fractalshark_tpu.ops.bignum import orbit as JO

    out = {}
    spec, st = nr_state(B8B_LIMBS, 1)
    signs = np.asarray([st[0], st[2], st[4], st[6]], np.int32)
    out["b8b"] = np.asarray(NM.mxu_nr_products(
        *(jnp.asarray(st[k]) for k in (1, 3, 5, 7)), jnp.asarray(signs),
        n=spec.nfft, interpret=True, in_digits=spec.digits))

    step = jax.jit(JFP.iterate_z_nr, static_argnames=("spec",))
    for limbs in NR_LIMBS:
        for seed in range(STATES):
            _, st = nr_state(limbs, seed)
            r = step(*(jnp.int32(v) if k % 2 == 0 else jnp.asarray(v)
                       for k, v in enumerate(st)),
                     spec=JFP.FixedSpec.for_limbs(limbs))
            for k, v in enumerate(r):
                out[f"nr{limbs}_{seed}_{k}"] = np.asarray(v)

    def keep(name, values):
        out[name] = np.asarray([hp_key(v) for v in values])

    keep("eval_a", JO.evaluate_critical_orbit_and_derivs_device(
        JHP("-0.15", prec=200), JHP("0.4", prec=200), 12, 200))
    nx, ny = (JHP(v, prec=208) for v in NUCLEUS_858)
    keep("eval_858", JO.evaluate_critical_orbit_and_derivs_device(
        nx, ny, 858, 208))
    fs = JFF.refine_periodic_point(JHP("-1.754", prec=256),
                                   JHP("0.0004", prec=256), 3, 256,
                                   backend="device")
    out["refine3_device"] = np.asarray(feature_key(fs))
    ptz = JPZ(pt_x=ZOOM_1E8[0], pt_y=ZOOM_1E8[1], zoom_factor=ZOOM_1E8[2],
              prec=512)
    prec = 208
    fs = JFF.refine_periodic_point(ptz.pt_x.with_precision(prec),
                                   ptz.pt_y.with_precision(prec), 858, prec,
                                   backend="device")
    out["refine858_device"] = np.asarray(feature_key(fs))

    fs = JFF.find_periodic_point(JPZ(pt_x="-1.7549", pt_y="1e-6",
                                     zoom_factor="1e4", prec=256), 50)
    out["find3"] = np.asarray(feature_key(fs))
    ck = str(inputs["ckpt"])
    part = JFF.refine_periodic_point(JHP("-1.754", prec=256),
                                     JHP("0.0004", prec=256), 3, 256,
                                     max_steps=2, checkpoint_path=ck)
    out["ckpt_part"] = np.asarray(feature_key(part))
    out["ckpt_resumed"] = np.asarray(feature_key(JFF.resume_refinement(ck)))

    for mode in SCAN_MODES:
        rc, line = cli_json(main, SCAN_ARGS + ["--feature-mode", mode])
        out[f"scan_{mode}"] = np.asarray([str(rc), line])
    rc, line = cli_json(main, FIND_ARGS)
    out["find858"] = np.asarray([str(rc), line])
    return out


@pytest.fixture(scope="module")
def jax_ref(tmp_path_factory):
    d = tmp_path_factory.mktemp("feature")
    return ref.run_jax_reference("test_torch_feature", "_jax_reference", d,
                                 {"ckpt": str(d / "jax_nr.json")})


# ----------------------------------------------------------- the NR step


def _t(a):
    return torch.from_numpy(np.asarray(a).astype(np.int32))


def _step(st, spec):
    return FP.iterate_z_nr(*(v if k % 2 == 0 else _t(v)
                             for k, v in enumerate(st)), spec)


def test_nr_products_equal_b8b(jax_ref):
    """The twin's signed rows, CRT'd from B8b's residue rows [8, nfft]
    (d, xy, u, v per prime), are equal at nfft 8,192 with mixed signs."""
    spec, st = nr_state(B8B_LIMBS, 1)
    signs = torch.tensor([st[0], st[2], st[4], st[6]], dtype=torch.int32)
    got = FP.nr_products(*(_t(st[k]) for k in (1, 3, 5, 7)), signs, spec)
    rows = jax_ref["b8b"].astype(np.int64)
    r1, r2 = rows[0::2], rows[1::2]
    t = (r2 - r1) % N.P2 * pow(N.P1, -1, N.P2) % N.P2
    rec = r1 + N.P1 * t
    want = np.where(rec > N.P1 * N.P2 // 2, rec - N.P1 * N.P2, rec)
    assert sorted(set(signs.tolist())) == [-1, 1]
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("limbs", NR_LIMBS)
def test_iterate_z_nr_equals_jax_and_oracle(jax_ref, limbs):
    wrapped = 0
    for seed in range(STATES):
        spec, st = nr_state(limbs, seed)
        got = _step(st, spec)
        want, wrap = nr_oracle(spec, *st)
        wrapped += wrap
        for k in range(4):
            sign, mag = int(got[2 * k]), got[2 * k + 1].numpy()
            assert sign == int(jax_ref[f"nr{limbs}_{seed}_{2 * k}"])
            np.testing.assert_array_equal(
                mag.astype(np.uint32), jax_ref[f"nr{limbs}_{seed}_{2 * k + 1}"])
            assert (sign, FP.digits_to_int(mag)) == want[k]
    assert wrapped >= 1
    # the zero state: x' = −0, y' = +0, dx' = 1.0, dy' = +0
    spec, st = nr_state(limbs, 0)
    got = _step(st, spec)
    mags = [FP.digits_to_int(got[2 * k + 1].numpy()) for k in range(4)]
    assert [int(got[2 * k]) for k in range(4)] == [-1, 1, 1, 1]
    assert mags == [0, 0, 1 << (16 * spec.frac_digits), 0]


def test_nr_chunk_wraps_like_the_oracle():
    """64 NR steps from c = i + 2^-40 at 8 limbs: z stays by the cycle of
    i while |dz/dc| grows by 2^1.25 a step and wraps about every 26
    steps; the chunk equals the wrapped recurrence step for step."""
    spec = FP.FixedSpec.for_limbs(8)
    cx = HighPrecision.from_mant_exp(1, -40, prec=64)
    cy = HighPrecision(1, prec=64)
    scx, cxd = FP.hp_to_digits(cx, spec)
    scy, cyd = FP.hp_to_digits(cy, spec)
    one = FP.hp_to_digits(HighPrecision(1, prec=64), spec)[1]
    zero = np.zeros(spec.digits, np.uint32)
    st = [scx, cxd, scy, cyd, 1, one, 1, zero]
    state = O.NRState(st[0::2], *st[1::2], "cpu")
    O.orbit_nr_chunk(state, scx, _t(cxd), scy, _t(cyd), spec, 64)
    wraps = 0
    for _ in range(64):
        res, wrapped = nr_oracle(spec, *st, scx, cxd, scy, cyd)
        wraps += wrapped
        st = []
        for s, m in res:
            st += [s, np.asarray([(m >> (16 * i)) & 0xFFFF
                                  for i in range(spec.digits)], np.uint32)]
    assert wraps >= 2
    got = state.numpy()
    for k in range(4):
        assert int(got[2 * k]) == st[2 * k]
        np.testing.assert_array_equal(got[2 * k + 1], st[2 * k + 1])


def test_nr_wrappers_reject_sizes_past_the_bound():
    """The NR step takes D = 2^16 (32,768 limbs, View #32's evaluator
    size) and refuses D = 2^16 + 1, past K4-NR's nfft 2^17."""
    FP.check_nr(FP.FixedSpec(digits=1 << 16, nfft=1 << 17))
    spec = FP.FixedSpec(digits=(1 << 16) + 1, nfft=1 << 18)
    v = torch.zeros(spec.digits, dtype=torch.int32)
    with pytest.raises(ValueError, match="NR step needs"):
        FP.nr_products(v, v, v, v, torch.ones(4, dtype=torch.int32), spec)
    with pytest.raises(ValueError, match="NR step needs"):
        FP.nr_tail(torch.zeros(4, spec.nfft, dtype=torch.int64), 1, v, 1, v,
                   spec)
    assert O.nr_limbs(2 ** 19 - 80) == 16384
    assert O.nr_limbs(811_541) == 32768


# ----------------------------------------------------------- evaluator


def test_device_evaluator_equals_jax_and_host(jax_ref):
    cx, cy = HighPrecision("-0.15", prec=200), HighPrecision("0.4", prec=200)
    got = O.evaluate_critical_orbit_and_derivs_device(cx, cy, 12, 200,
                                                      device="cpu")
    assert [hp_key(v) for v in got] == jax_ref["eval_a"].tolist()
    host = FF.evaluate_critical_orbit_and_derivs(cx, cy, 12, 200)
    for h, d in zip(host[:4], got):
        err = h - d
        assert err.is_zero() or err.exponent2() < h.exponent2() - 150


def test_device_evaluator_period858_equals_jax(jax_ref):
    """At the period-858 nucleus (208 bits: 16 limbs) |dz/dc| is about
    2^19, below the wrap: the device and host evaluators agree, within
    2^-150 relative to max(|host value|, 1) (z itself is about 2^-116
    there, so its bound is absolute)."""
    nx, ny = (HighPrecision(v, prec=208) for v in NUCLEUS_858)
    got = O.evaluate_critical_orbit_and_derivs_device(nx, ny, 858, 208,
                                                      device="cpu")
    assert [hp_key(v) for v in got] == jax_ref["eval_858"].tolist()
    assert 2 ** 18 < abs(float(got[2])) < 2 ** 20
    host = FF.evaluate_critical_orbit_and_derivs(nx, ny, 858, 208)
    for h, d in zip(host[:4], got):
        assert (h - d).exponent2() < max(h.exponent2(), 0) - 150


def test_device_refine_period3_equals_jax(jax_ref):
    fs = FF.refine_periodic_point(HighPrecision("-1.754", prec=256),
                                  HighPrecision("0.0004", prec=256), 3, 256,
                                  backend="device", device="cpu")
    assert feature_key(fs) == str(jax_ref["refine3_device"])
    assert abs(float(fs.center_x) - float(HighPrecision(PERIOD3_RE))) < 1e-18
    assert abs(float(fs.center_y)) < 1e-18


def test_device_refine_period858_equals_jax(jax_ref):
    """From the zoom-1e8 view's centre to the period-858 nucleus: the
    JAX package's device refinement's centre and step count."""
    ptz = PointZoomBBConverter(pt_x=ZOOM_1E8[0], pt_y=ZOOM_1E8[1],
                               zoom_factor=ZOOM_1E8[2], prec=512)
    fs = FF.refine_periodic_point(ptz.pt_x.with_precision(208),
                                  ptz.pt_y.with_precision(208), 858, 208,
                                  backend="device", device="cpu")
    assert feature_key(fs) == str(jax_ref["refine858_device"])
    assert fs.center_x.to_string(40) == NUCLEUS_858[0]
    assert fs.center_y.to_string(40) == NUCLEUS_858[1]


def test_device_backend_needs_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        FF.refine_periodic_point(HighPrecision("-1.754", prec=256),
                                 HighPrecision("0.0004", prec=256), 3, 256,
                                 backend="device")


# ----------------------------------------------------------- host paths


def test_find_periodic_point_equals_jax(jax_ref):
    fs = FF.find_periodic_point(PointZoomBBConverter(
        pt_x="-1.7549", pt_y="1e-6", zoom_factor="1e4", prec=256), 50)
    assert fs.period == 3
    assert feature_key(fs) == str(jax_ref["find3"])


def test_checkpoint_resume_equals_jax(jax_ref, tmp_path):
    ck = str(tmp_path / "nr.json")
    part = FF.refine_periodic_point(HighPrecision("-1.754", prec=256),
                                    HighPrecision("0.0004", prec=256), 3,
                                    256, max_steps=2, checkpoint_path=ck)
    assert part.nr_iterations == 2
    assert feature_key(part) == str(jax_ref["ckpt_part"])
    assert feature_key(FF.resume_refinement(ck)) == \
        str(jax_ref["ckpt_resumed"])


@pytest.mark.parametrize("mode", SCAN_MODES)
def test_cli_feature_scan_equals_jax(jax_ref, mode):
    rc, line = cli_json(cli.main, SCAN_ARGS + ["--feature-mode", mode,
                                               "--device", "cpu"])
    assert [str(rc), line] == jax_ref[f"scan_{mode}"].tolist()
    assert json.loads(line)["features"][0]["period"] == 3


def test_cli_feature_find_equals_jax(jax_ref):
    rc, line = cli_json(cli.main, FIND_ARGS + ["--device", "cpu"])
    assert [str(rc), line] == jax_ref["find858"].tolist()
    out = json.loads(line)
    assert (out["center_x"], out["center_y"]) == NUCLEUS_858
    assert (out["period"], out["nr_iterations"]) == (858, 22)


def test_cli_feature_scan_bad_grid(capsys):
    assert cli.main(["--view", "0", "--feature-scan", "oops", "--width",
                     "32", "--height", "32", "--device", "cpu"]) == 2
    assert "NXxNY" in capsys.readouterr().err


def test_smoke_pins_equal_jax(jax_ref):
    """The JAX values chip_smoke.py holds the card to are these."""
    import chip_smoke as cs
    assert cs.SCAN_ARGS == SCAN_ARGS
    for mode in SCAN_MODES:
        assert cs.FEATURE_SCAN[mode] == jax_ref[f"scan_{mode}"][1]
    assert cs.FEATURE_FIND_1E8 == jax_ref["find858"][1]
    key = json.loads(str(jax_ref["refine858_device"]))
    assert cs.REFINE_858 == (NUCLEUS_858, key["steps"])


# ----------------------------------------------------------- on the card


@pytest.mark.cuda
def test_nr_kernels_match_twins_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    for limbs in (8, 2048):
        for seed in range(STATES):
            spec, st = nr_state(limbs, seed)
            signs = FP.sign_row(*st[0:8:2], "cpu")
            mags = [_t(st[k]) for k in (1, 3, 5, 7)]
            coef = FP.nr_products(*(m.cuda() for m in mags), signs.cuda(),
                                  spec)
            want = FP.nr_products_plain(*mags, signs, spec.nfft)
            assert torch.equal(coef.cpu(), want)
            got = FP.nr_tail(coef, st[8], _t(st[9]).cuda(), st[10],
                             _t(st[11]).cuda(), spec)
            plain = FP.nr_tail_plain(want, st[8], _t(st[9]), st[10],
                                     _t(st[11]), spec)
            for a, b in zip(got, plain):
                assert torch.equal(a.cpu(), b)
