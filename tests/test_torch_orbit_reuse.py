"""The device orbit's reuse digits on the CPU: K12's plain twin
(``orbit.orbit_chunk_plain``) and ``orbit.orbit_chunk`` with
``reuse_digits`` against the JAX package's orbit chunk (its
split-bookkeeping scan, ``orbit.py:220-222``) and the exact Python-int
truncation, and the port's ``RefOrbitCalc(orbit_backend="device",
reuse_mode="on")`` against the JAX package's (``tests/test_reuse.py:195``:
a 1e60 authority serving a nearby 1e62 zoom).  A ``cuda``-marked test holds
K12's block and grid forms and the per-step loop to the twin on the card.
"""

import numpy as np
import pytest
import torch

import test_torch_jaxref as ref
from fractalshark_tpu_torch.core.highprecision import HighPrecision
from fractalshark_tpu_torch.ops.bignum import fixedpoint as FP
from fractalshark_tpu_torch.ops.bignum import orbit as O
from test_torch_orbit_chunk import (CHUNK, CHUNK_LIMBS, _digits, _mid_state,
                                    _orbit_steps, _row, _t)

CX = "-0.743643887037158704752191506114774"
CY = "0.131825904205311970493132056385139"
# the reuse digits of a chunk: as the session takes them for 1,000 bits
REUSE_FRAC_BITS = 1000
AUTH_PREC = 768
AUTH_BUDGET = 600


def _reuse_digits(spec) -> int:
    return min(-(-REUSE_FRAC_BITS // 16) + FP.INT_DIGITS, spec.digits)


def _views(pkg="fractalshark_tpu_torch"):
    """The authority at 1e60 and the nearby 1e62 view of
    ``tests/test_reuse.py:195``."""
    import importlib
    PZ = importlib.import_module(f"{pkg}.core.pointzoom").PointZoomBBConverter
    HP = importlib.import_module(f"{pkg}.core.highprecision").HighPrecision
    v1 = PZ(pt_x=CX, pt_y=CY, zoom_factor="1e60", prec=AUTH_PREC)
    cx2 = HP(CX, prec=AUTH_PREC) + HP("1e-55", prec=AUTH_PREC)
    v2 = PZ(pt_x=cx2, pt_y=CY, zoom_factor="1e62", prec=AUTH_PREC)
    return v1, v2


def _reuse_strings(ro) -> dict:
    return {"zx": np.asarray([str(v) for v in ro.zx]),
            "zy": np.asarray([str(v) for v in ro.zy]),
            "frac_bits": np.asarray(ro.frac_bits)}


def _jax_reference(_inputs):
    import jax.numpy as jnp

    from fractalshark_tpu.engine.reforbit import RefOrbitCalc
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
        _, (rows, xr, yr, rsx, rsy) = JO.orbit_chunk(
            jnp.int32(sx), jnp.asarray(_digits(x, D)), jnp.int32(sy),
            jnp.asarray(_digits(y, D)), zero, zero, jnp.int32(0),
            jnp.int32(scx), jnp.asarray(cxd), jnp.int32(scy),
            jnp.asarray(cyd), zero, jnp.int32(0), zero, zero,
            spec=JFP.FixedSpec.for_limbs(limbs), steps=CHUNK,
            reuse_digits=_reuse_digits(spec))
        out[f"{limbs}_reuse"] = np.concatenate(
            [np.asarray(xr), np.asarray(yr), np.asarray(rsx)[:, None],
             np.asarray(rsy)[:, None]], axis=1).astype(np.int64)

    v1, v2 = _views("fractalshark_tpu")
    calc = RefOrbitCalc(orbit_backend="device", reuse_mode="on")
    r1 = calc.get_and_create_useful_results(v1, AUTH_BUDGET)
    out["r1_x"], out["r1_y"] = r1.orbit_x, r1.orbit_y
    for k, v in _reuse_strings(r1.extra["reuse_orbit"]).items():
        out["r1_reuse_" + k] = v
    r2 = calc.get_and_create_useful_results(v2, AUTH_BUDGET)
    out["r2_reused"] = np.asarray(bool(calc.last_details.get("reused")))
    out["r2_x"], out["r2_y"] = r2.orbit_x, r2.orbit_y
    return out


@pytest.fixture(scope="module")
def jax_ref(tmp_path_factory):
    return ref.run_jax_reference("test_torch_orbit_reuse", "_jax_reference",
                                 tmp_path_factory.mktemp("orbit_reuse"))


def _plain(limbs):
    spec, c, (scx, cxd, scy, cyd), z = _mid_state(limbs)
    (sx, x), (sy, y) = z
    R = _reuse_digits(spec)
    out = O.orbit_chunk_plain(
        _t(_digits(x, spec.digits)), _t(_digits(y, spec.digits)),
        torch.from_numpy(_row(spec, z)), scx, _t(cxd), scy, _t(cyd), spec,
        CHUNK, R)
    return spec, c, z, R, out


@pytest.mark.parametrize("limbs", CHUNK_LIMBS)
def test_reuse_rows_equal_jax(jax_ref, limbs):
    """K12's twin with reuse rows: the pre-update states' top digits and
    signs, as the JAX chunk emits them (from a state whose signs are both
    negative)."""
    _, _, _, R, (_, _, _, reuse) = _plain(limbs)
    assert reuse.shape == (CHUNK + 1, 2 * R + 2)
    np.testing.assert_array_equal(reuse[:CHUNK].numpy(),
                                  jax_ref[f"{limbs}_reuse"])


@pytest.mark.parametrize("limbs", CHUNK_LIMBS)
def test_reuse_rows_are_the_exact_truncation(limbs):
    """Each reuse row is the exact state's top R digits (the value
    truncated to 16(R - INT_DIGITS) fraction bits) and its signs."""
    spec, c, z, R, (_, _, rows, reuse) = _plain(limbs)
    shift = 16 * (spec.digits - R)
    states = [z] + _orbit_steps(spec, z, c, CHUNK)
    for k, ((sx, x), (sy, y)) in enumerate(states):
        got = reuse[k].numpy()
        assert FP.digits_to_int(got[:R].astype(np.uint32)) == x >> shift
        assert FP.digits_to_int(got[R:2 * R].astype(np.uint32)) == y >> shift
        assert (got[2 * R], got[2 * R + 1]) == (sx, sy)
        assert (got[2 * R], got[2 * R + 1]) == tuple(rows[k, 10:12].tolist())


def test_orbit_chunk_reuse_on_both_cpu_routes(monkeypatch):
    """``orbit_chunk`` gives (rows, reuse) equal to the twin's, on the
    default route and on the flagged routes' CPU loop."""
    spec, _, (scx, cxd, scy, cyd), z = _mid_state(32)
    (sx, x), (sy, y) = z
    R = _reuse_digits(spec)
    want = O.orbit_chunk_plain(
        _t(_digits(x, spec.digits)), _t(_digits(y, spec.digits)),
        torch.from_numpy(_row(spec, z)), scx, _t(cxd), scy, _t(cyd), spec,
        CHUNK, R)
    for route in ("k4", "whole"):
        monkeypatch.setattr(FP, "step_route", lambda _spec: route)
        st = O.OrbitState(sx, _digits(x, spec.digits), sy,
                          _digits(y, spec.digits), "cpu")
        rows, reuse = O.orbit_chunk(st, scx, _t(cxd), scy, _t(cyd), spec,
                                    CHUNK, reuse_digits=R)
        assert torch.equal(rows, want[2][:CHUNK]), route
        assert torch.equal(reuse, want[3][:CHUNK]), route
        assert torch.equal(st.x, want[0]) and torch.equal(st.y, want[1])
    with pytest.raises(ValueError, match="reuse_digits"):
        O.orbit_chunk(st, scx, _t(cxd), scy, _t(cyd), spec, 1,
                      reuse_digits=spec.digits + 1)


@pytest.fixture(scope="module")
def served():
    from fractalshark_tpu_torch.engine.reforbit import RefOrbitCalc
    v1, v2 = _views()
    calc = RefOrbitCalc(orbit_backend="device", reuse_mode="on")
    calc.device = "cpu"
    r1 = calc.get_and_create_useful_results(v1, AUTH_BUDGET)
    d1 = dict(calc.last_details)
    r2 = calc.get_and_create_useful_results(v2, AUTH_BUDGET)
    return v1, r1, d1, r2, dict(calc.last_details)


def test_device_backend_records_reuse_and_serves_deep_zoom(jax_ref, served):
    """``tests/test_reuse.py:195`` on the port, with the twins on the CPU:
    the device-backend authority records the reuse copy (equal to the JAX
    session's, every int) and serves the nearby deeper view by perturbed
    perturbation, giving the JAX package's served orbit bit for bit and a
    from-scratch device orbit within the reference's tolerance."""
    from fractalshark_tpu_torch.engine.reforbit import RefOrbitCalc
    from fractalshark_tpu_torch.engine.reuse import reuse_precision
    v1, r1, d1, r2, d2 = served
    assert d1["backend"] == "device"
    ro = r1.extra["reuse_orbit"]
    assert ro.frac_bits >= reuse_precision(v1.radius) + 16
    assert ro.count() == r1.count_orbit_entries()
    for k, v in _reuse_strings(ro).items():
        np.testing.assert_array_equal(v, jax_ref["r1_reuse_" + k])
    np.testing.assert_array_equal(r1.orbit_x, jax_ref["r1_x"])
    np.testing.assert_array_equal(r1.orbit_y, jax_ref["r1_y"])
    assert d2.get("reused") is True and bool(jax_ref["r2_reused"])
    np.testing.assert_array_equal(r2.orbit_x, jax_ref["r2_x"])
    np.testing.assert_array_equal(r2.orbit_y, jax_ref["r2_y"])
    _, v2 = _views()
    calc2 = RefOrbitCalc(orbit_backend="device", reuse_mode="off")
    calc2.device = "cpu"
    r3 = calc2.get_and_create_useful_results(v2, AUTH_BUDGET)
    n = min(r2.count_orbit_entries(), r3.count_orbit_entries())
    assert n > 100
    np.testing.assert_allclose(r2.orbit_x[:n], r3.orbit_x[:n], rtol=0,
                               atol=1e-13)
    np.testing.assert_allclose(r2.orbit_y[:n], r3.orbit_y[:n], rtol=0,
                               atol=1e-13)


@pytest.mark.cuda
def test_reuse_rows_on_card_in_every_form():
    """K12's block and grid forms and the per-step loop write the twin's
    reuse rows (and rows and state) on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda")
    for limbs in (32, 2048):
        spec, _, (scx, cxd, scy, cyd), z = _mid_state(limbs)
        (sx, x), (sy, y) = z
        xd, yd = _digits(x, spec.digits), _digits(y, spec.digits)
        R = _reuse_digits(spec)
        want = O.orbit_chunk_plain(_t(xd), _t(yd),
                                   torch.from_numpy(_row(spec, z)), scx,
                                   _t(cxd), scy, _t(cyd), spec, CHUNK, R)
        scratch = O._Scratch(spec, dev)
        cx, cy = _t(cxd).to(dev), _t(cyd).to(dev)
        for form in ("steps", "block", "grid"):
            try:
                O.check_chunk(spec, form, 2)
            except ValueError:
                continue
            state = O.OrbitState(sx, xd, sy, yd, dev)
            rows = torch.empty(CHUNK + 1, FP.ROW, dtype=torch.int32,
                               device=dev)
            rows[0] = state.row
            reuse = torch.empty(CHUNK + 1, 2 * R + 2, dtype=torch.int32,
                                device=dev)
            reuse[0] = O.reuse_row(state.x, state.y, state.row, R)
            O.launch_orbit_chunk(state, rows, scx, cx, scy, cy, spec, CHUNK,
                                 scratch, form, reuse)
            for a, b in zip((state.x, state.y, rows, reuse), want):
                assert torch.equal(a.cpu(), b), (limbs, form)


def test_session_reuse_bits_round_up_to_digits():
    """The session's reuse copy has ceil(bits / 16) fraction digits
    (``orbit.py:652-654``), capped at the state's."""
    cx, cy = HighPrecision("0.3", prec=200), HighPrecision(CY, prec=200)
    res = O.compute_reference_orbit_device(
        cx, cy, 10, HighPrecision("1e-9", prec=64), device="cpu",
        reuse_frac_bits=65)
    ro = res.extra["reuse_orbit"]
    assert ro.frac_bits == 80
    assert ro.count() == res.count_orbit_entries()
