"""The device reference orbit of the PyTorch/CUDA port on the CPU (the
plain twins of K4 and K5): ``fixedpoint.iterate_z`` against the JAX
package's ``iterate_z`` and the exact Python-int oracle of
``tests/test_paired.py:114-132``, and the orbit session against JAX
``compute_reference_orbit_device``.

The JAX package runs two forms of the session's f64 bookkeeping: on the
TPU the digit scan emits shadow rows and ``host_bookkeeping`` converts
them with exact ``ldexp``/``frexp`` (``SPLIT_BOOKKEEPING``, gated on the
fused tail, ``orbit.py:123-124,590-591``); on the CPU the scan converts
in-graph with ``jnp.exp2``, which XLA:CPU computes inexactly even for
integer arguments (a few ulp, relative 1.5e-15).  The port runs the
first form, so its orbits are held bit for bit to the JAX session taken
through that form (the reference subprocess selects it by handing
``orbit`` a view of ``fixedpoint`` whose fused-tail gate is open; no
JAX file changes), and to the default CPU form within the JAX package's
own cross-form tolerance (``tests/test_orbit_shadow.py:104-106``).
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
from fractalshark_tpu_torch.core.precision import precision_from_view
from fractalshark_tpu_torch.core.views import get_view_preset
from fractalshark_tpu_torch.ops.bignum import fixedpoint as FP
from fractalshark_tpu_torch.ops.bignum import ntt as N
from fractalshark_tpu_torch.ops.bignum import orbit as O

CX = "-0.743643887037158704752191506114774"
CY = "0.131825904205311970493132056385139"
# tests/test_device_orbit_session.py:15-56: (cx, cy, radius, budget,
# periodicity, chunk_steps)
SESSIONS = {
    "period": (CX, CY, "1e-9", 1200, True, 100),
    "escape": ("0.5", "0.5", "0.01", 200, False, 16),
    "budget": ("0.3", CY, "1e-9", 300, False, 64),
}
ITER_LIMBS = (8, 32, 1024)
VIEW6_PREFIX = 8192
# the 1e8 frame of tests/test_la_pallas.py (budget cut to 1,200, 8²)
SMALL_DEEP = ["--center-x", CX, "--center-y", CY, "--zoom", "1e8",
              "--iterations", "1200", "--width", "8", "--height", "8",
              "--render-algorithm", "GpuHDRx32PerturbedLAv2",
              "--perturbation-alg", "GPU"]
STAT_KEYS = ("algorithm", "iterations_budget", "iter_min", "iter_max",
             "iter_sum")


def _rand_state(seed: int, limbs: int):
    """Four random signed values below 1 (sx, x, sy, y, scx, cx, scy, cy)."""
    spec = FP.FixedSpec.for_limbs(limbs)
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(4):
        d = rng.integers(0, 1 << 16, size=spec.digits, dtype=np.uint32)
        d[-2:] = 0
        out += [int(rng.choice([-1, 1])), d]
    return spec, out


def _view6_center():
    ptz = get_view_preset(6).ptz
    prec = precision_from_view(ptz) + 32
    return ptz, prec


def _hp(cx, cy, rad):
    return (HighPrecision(cx, prec=200), HighPrecision(cy, prec=200),
            HighPrecision(rad, prec=64))


# ----------------------------------------------------------- JAX side


def _jax_reference(inputs):
    import jax
    import jax.numpy as jnp

    from fractalshark_tpu.core.highprecision import HighPrecision as JHP
    from fractalshark_tpu.core.precision import precision_from_view as jpfv
    from fractalshark_tpu.core.views import get_view_preset as jview
    from fractalshark_tpu.ops.bignum import fixedpoint as JFP
    from fractalshark_tpu.ops.bignum import orbit as JO

    out = {}
    iterate_z = jax.jit(JFP.iterate_z, static_argnames=("spec",))
    for limbs in ITER_LIMBS:
        spec, (sx, x, sy, y, scx, cx, scy, cy) = _rand_state(limbs, limbs)
        r = iterate_z(jnp.int32(sx), jnp.asarray(x), jnp.int32(sy),
                      jnp.asarray(y), jnp.int32(scx), jnp.asarray(cx),
                      jnp.int32(scy), jnp.asarray(cy),
                      spec=JFP.FixedSpec.for_limbs(limbs))
        for k, v in zip(("sx", "x", "sy", "y"), r):
            out[f"iter{limbs}_{k}"] = np.asarray(v)

    class _SplitRoute:
        """fixedpoint as orbit.py sees it on the TPU: the fused-tail gate
        open, so the session takes the split (host) bookkeeping."""
        def __getattr__(self, name):
            return getattr(JFP, name)

        @staticmethod
        def _use_fused_tail(nf, D):
            return True

    def use(route):
        JO.FP = _SplitRoute() if route == "split" else JFP
        JO.orbit_chunk.clear_cache()    # traced under the other route

    def session(name, route, **kw):
        cx, cy, rad, n, per, chunk = SESSIONS[name]
        res = JO.compute_reference_orbit_device(
            JHP(cx, prec=200), JHP(cy, prec=200), kw.pop("n", n),
            JHP(rad, prec=64), periodicity=per, chunk_steps=chunk, **kw)
        return res

    def keep(prefix, res):
        out[prefix + "x"] = res.orbit_x
        out[prefix + "y"] = res.orbit_y
        out[prefix + "e"] = (res.orbit_e if res.orbit_e is not None
                             else np.zeros(0, np.int32))
        out[prefix + "meta"] = np.asarray(
            [res.period, res.escaped_at, res.count_orbit_entries()])

    for route in ("cpu", "split"):
        use(route)
        for name in SESSIONS:
            keep(f"{route}_{name}_", session(name, route))
    ck = str(inputs["ckpt"])
    session("period", "split", n=400, checkpoint_path=ck,
            checkpoint_every_s=0.0)
    keep("split_resumed_", session("period", "split", checkpoint_path=ck,
                                   checkpoint_every_s=0.0))

    ptz = jview(6).ptz
    prec = jpfv(ptz) + 32
    res = JO.compute_reference_orbit_device(
        ptz.pt_x.with_precision(prec), ptz.pt_y.with_precision(prec),
        VIEW6_PREFIX, ptz.radius)
    keep("view6_", res)

    from fractalshark_tpu.cli import main
    use("cpu")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert main(SMALL_DEEP + ["--stats"]) == 0
    for k, v in json.loads(buf.getvalue().strip().splitlines()[-1]).items():
        if k in STAT_KEYS:
            out["cli_" + k] = np.asarray(v)
    return out


@pytest.fixture(scope="module")
def jax_ref(tmp_path_factory):
    d = tmp_path_factory.mktemp("orbit")
    return ref.run_jax_reference("test_torch_orbit", "_jax_reference", d,
                                 {"ckpt": str(d / "jax_ckpt")})


# ----------------------------------------------------------- iterate_z


def _iterate(limbs: int, seed: int):
    spec, (sx, x, sy, y, scx, cx, scy, cy) = _rand_state(seed, limbs)
    t = lambda a: torch.from_numpy(a.astype(np.int32))  # noqa: E731
    r = FP.iterate_z(sx, t(x), sy, t(y), scx, t(cx), scy, t(cy), spec)
    return spec, (sx, x, sy, y, scx, cx, scy, cy), r


@pytest.mark.parametrize("limbs", ITER_LIMBS)
def test_iterate_z_equals_jax(jax_ref, limbs):
    _, _, (nsx, nx, nsy, ny) = _iterate(limbs, limbs)
    assert int(nsx) == int(jax_ref[f"iter{limbs}_sx"])
    assert int(nsy) == int(jax_ref[f"iter{limbs}_sy"])
    np.testing.assert_array_equal(nx.numpy().astype(np.uint32),
                                  jax_ref[f"iter{limbs}_x"])
    np.testing.assert_array_equal(ny.numpy().astype(np.uint32),
                                  jax_ref[f"iter{limbs}_y"])


def _oracle(spec, sx, x, sy, y, scx, cx, scy, cy):
    """tests/test_paired.py:114-132."""
    x_i = sx * FP.digits_to_int(x)
    y_i = sy * FP.digits_to_int(y)
    cx_i = scx * FP.digits_to_int(cx)
    cy_i = scy * FP.digits_to_int(cy)
    shift = 16 * spec.frac_digits
    half = 1 << (shift - 1)

    def rhu(v):
        t = v + half
        return (1 if t >= 0 else -1) * (abs(t) >> shift)

    return (rhu(x_i * x_i - y_i * y_i + (cx_i << shift)),
            rhu(2 * x_i * y_i + (cy_i << shift)))


@pytest.mark.parametrize("limbs", [8, 8192])
def test_iterate_z_equals_int_oracle(limbs):
    for seed in range(3):
        spec, st, (nsx, nx, nsy, ny) = _iterate(limbs, 100 + seed)
        want_x, want_y = _oracle(spec, *st)
        assert int(nsx) * FP.digits_to_int(nx.numpy()) == want_x
        assert int(nsy) * FP.digits_to_int(ny.numpy()) == want_y


@pytest.mark.parametrize("sign", [1, -1])
def test_iterate_z_carry_runs(sign):
    """-2 + eps, View #30's kind of centre: a run of 0xFFFF digits as
    long as the number, through both a long carry and a long borrow."""
    spec = FP.FixedSpec.for_limbs(256)
    D = spec.digits
    c = np.full(D, 0xFFFF, np.uint32)
    c[-2:] = 0
    c[-3] = 0x7FFF
    zero = np.zeros(D, np.uint32)
    t = lambda a: torch.from_numpy(a.astype(np.int32))  # noqa: E731
    st = (sign, c, 1, zero, -sign, c, 1, c)
    nsx, nx, nsy, ny = FP.iterate_z(st[0], t(st[1]), st[2], t(st[3]),
                                    st[4], t(st[5]), st[6], t(st[7]), spec)
    want_x, want_y = _oracle(spec, *st)
    assert int(nsx) * FP.digits_to_int(nx.numpy()) == want_x
    assert int(nsy) * FP.digits_to_int(ny.numpy()) == want_y


def test_iterate_z_shadow_row():
    """K5's row of the new z equals the host shadow row of it."""
    spec, st, _ = _iterate(32, 5)
    sx, x, sy, y, scx, cx, scy, cy = st
    t = lambda a: torch.from_numpy(a.astype(np.int32))  # noqa: E731
    row_in = torch.from_numpy(FP.shadow_row_np(sx, x, sy, y))
    coef = FP.orbit_products(t(x), t(y), spec)
    nx, ny, row = FP.orbit_tail(coef, row_in, scx, t(cx), scy, t(cy), spec)
    np.testing.assert_array_equal(
        row.numpy(), FP.shadow_row_np(int(row[10]), nx.numpy(),
                                      int(row[11]), ny.numpy()))


def test_kernel_constants_match_ntt():
    """The primes and Montgomery constants compiled into K4 (and K9-K11,
    from the header K4 includes) are ntt.py's, and K10's CRT constant is
    p1^-1·R mod p2."""
    src = open(FP.kernels.SRC_DIR / "ntt_common.cuh").read()
    assert '#include "ntt_common.cuh"' in open(
        FP.kernels.SRC_DIR / "ntt_orbit.cu").read()
    for name, want in (("kP1", N.P1), ("kP2", N.P2),
                       ("kPp1", N.mont_const(N.P1)[0]),
                       ("kPp2", N.mont_const(N.P2)[0]),
                       ("kP1P2", N.P1 * N.P2)):
        assert f" {name} = {want}u" in src, name
    tail = open(FP.kernels.SRC_DIR / "fused_tail.cuh").read()
    assert f" kCrtConst = {pow(N.P1, -1, N.P2) * 2 ** 32 % N.P2}u" in tail


# ----------------------------------------------------------- session


def _port_session(name, **kw):
    cx, cy, rad, n, per, chunk = SESSIONS[name]
    hx, hy, hr = _hp(cx, cy, rad)
    return O.compute_reference_orbit_device(
        hx, hy, kw.pop("n", n), hr, periodicity=per, chunk_steps=chunk,
        device="cpu", **kw)


def _assert_same_orbit(res, jax_ref, prefix):
    period, escaped, count = jax_ref[prefix + "meta"].tolist()
    assert (res.period, res.escaped_at, res.count_orbit_entries()) == \
        (period, escaped, count)
    assert ref.bits_equal(res.orbit_x, jax_ref[prefix + "x"])
    assert ref.bits_equal(res.orbit_y, jax_ref[prefix + "y"])
    e = res.orbit_e if res.orbit_e is not None else np.zeros(0, np.int32)
    np.testing.assert_array_equal(e, jax_ref[prefix + "e"])


@pytest.mark.parametrize("name", list(SESSIONS))
def test_session_equals_jax(jax_ref, name):
    res = _port_session(name)
    _assert_same_orbit(res, jax_ref, f"split_{name}_")
    # the JAX package's default CPU form: same decisions, f64 shadows
    # within its own cross-form tolerance
    cpu = f"cpu_{name}_"
    assert (res.period, res.escaped_at, res.count_orbit_entries()) == \
        tuple(jax_ref[cpu + "meta"].tolist())
    np.testing.assert_allclose(res.orbit_x, jax_ref[cpu + "x"], rtol=1e-14)
    np.testing.assert_allclose(res.orbit_y, jax_ref[cpu + "y"], rtol=1e-14)
    assert res.extra["session_timers"]["wall_s"] >= 0


def test_session_checkpoint_resume_bit_identical(jax_ref, tmp_path):
    """A run capped mid-orbit and a resumed run reproduce the
    straight-through orbit and period bit for bit (the dzdc state
    crosses the boundary), as JAX's resume does
    (tests/test_device_orbit_session.py:104-136)."""
    ck = str(tmp_path / "v")
    part = _port_session("period", n=400, checkpoint_path=ck,
                         checkpoint_every_s=0.0)
    assert part.period == 0 and part.count_orbit_entries() == 401
    full = _port_session("period", checkpoint_path=ck,
                         checkpoint_every_s=0.0)
    _assert_same_orbit(full, jax_ref, "split_period_")
    _assert_same_orbit(full, jax_ref, "split_resumed_")


def test_session_abort_and_progress():
    """An abort flag set from the progress callback stops the session
    after the chunks already dispatched, with a consistent orbit."""
    import threading
    stop = threading.Event()
    seen = []

    def cb(done, total, elapsed):
        seen.append(done)
        stop.set()

    cx, cy, rad = _hp("0.3", CY, "1e-9")
    res = O.compute_reference_orbit_device(
        cx, cy, 10_000, rad, periodicity=False, chunk_steps=32,
        abort_flag=stop, progress_cb=cb, device="cpu")
    assert seen[0] == 32
    assert res.count_orbit_entries() == 1 + 32 * O.PIPELINE_DEPTH
    assert res.period == 0 and res.escaped_at == 0


def test_view6_prefix_equals_jax(jax_ref):
    ptz, prec = _view6_center()
    res = O.compute_reference_orbit_device(
        ptz.pt_x.with_precision(prec), ptz.pt_y.with_precision(prec),
        VIEW6_PREFIX, ptz.radius, device="cpu")
    # 636 bits of precision: 32 limbs, 64 digits, nfft 128
    assert res.precision_bits == FP.FixedSpec.for_limbs(32).frac_bits
    _assert_same_orbit(res, jax_ref, "view6_")


def _one_rank_session(rank: int, world: int) -> dict:
    """The mesh session on a one-rank gloo group (``run_ranks``)."""
    from fractalshark_tpu_torch.parallel.mesh import make_mesh
    cx, cy, rad = _hp("0.3", CY, "1e-9")
    res = O.compute_reference_orbit_device(cx, cy, 10, rad, device="cpu",
                                           mesh=make_mesh("cpu"))
    return {"x": res.orbit_x, "y": res.orbit_y}


def test_unported_options_raise(tmp_path):
    """The reuse digits (A4's first item) are ported: the session records
    the reuse copy.  The mesh-sharded orbit (A6) is ported too: a session
    over a one-rank mesh, in a subprocess with its own process group,
    returns the one-device session's orbit bit for bit."""
    cx, cy, rad = _hp("0.3", CY, "1e-9")
    res = O.compute_reference_orbit_device(cx, cy, 10, rad, device="cpu",
                                           reuse_frac_bits=64)
    ro = res.extra["reuse_orbit"]
    assert ro.frac_bits == 64 and ro.count() == res.count_orbit_entries()
    got, = ref.run_ranks("test_torch_orbit", "_one_rank_session", 1,
                         tmp_path)
    assert ref.bits_equal(got["x"], res.orbit_x)
    assert ref.bits_equal(got["y"], res.orbit_y)


def test_cli_device_orbit_frame_equals_jax(jax_ref):
    """``--perturbation-alg GPU`` through the port's CLI (twins on the
    CPU) renders the frame the JAX CLI renders with its device orbit."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert cli.main(SMALL_DEEP + ["--stats", "--device", "cpu"]) == 0
    s = json.loads(buf.getvalue().strip().splitlines()[-1])
    assert s["orbit_backend"] == "device"
    for k in STAT_KEYS:
        assert s[k] == jax_ref["cli_" + k].item(), k


# ----------------------------------------------------------- on the card


@pytest.mark.cuda
def test_kernels_match_twins_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    for limbs in (8, 2048):
        spec, st, _ = _iterate(limbs, 7)
        sx, x, sy, y, scx, cx, scy, cy = st
        t = lambda a: torch.from_numpy(a.astype(np.int32))  # noqa: E731
        row_in = torch.from_numpy(FP.shadow_row_np(sx, x, sy, y))
        coef = FP.orbit_products(t(x).cuda(), t(y).cuda(), spec)
        want = FP.orbit_products_plain(t(x), t(y), spec.nfft)
        assert torch.equal(coef.cpu(), want)
        got = FP.orbit_tail(coef, row_in.cuda(), scx, t(cx).cuda(), scy,
                            t(cy).cuda(), spec)
        plain = FP.orbit_tail_plain(want, row_in, scx, t(cx), scy, t(cy),
                                    spec)
        for a, b in zip(got, plain):
            assert torch.equal(a.cpu(), b)


# View #6 with the device orbit at 64²: iter_sum and CRC-32 of the grid
# as <u4 that the JAX package gives for the same command on the CPU with
# FMA contraction off (and with its native orbit); period 457,977
VIEW6_GPU_ORBIT_64 = (3_268_937_305, 2_518_423_760)


@pytest.mark.cuda
def test_view6_device_orbit_frame_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert cli.main(["--view", "6", "--width", "64", "--height", "64",
                         "--perturbation-alg", "GPU", "--stats"]) == 0
    s = json.loads(buf.getvalue().strip().splitlines()[-1])
    assert (s["orbit_backend"], s["orbit_period"]) == ("device", 457_977)
    assert (s["iter_sum"], s["crc32"]) == VIEW6_GPU_ORBIT_64
