"""K17's and K18's plain twins (``fractalshark_tpu_torch/ops/quadd.py``,
``ops/quadflt.py``) against the JAX package, bit for bit: the QD and QF
operations on random operands of both component types (a quarter of
them so small that their low components are subnormal, which the
reference reads as zero and the port flushes on upload), the view
splits, ``escape_qd`` and ``escape_qf`` in both variants on the
integration sweep's shallow frame, the 1e17 frame of
``tests/test_quadflt.py`` and a 1e18 frame on the antenna by -2 (whose
counts vary), ``Gpu4x32``/``Gpu4x64`` through ``Fractal`` and the CLI,
the int32 budget, and the smoke's phase-15 QD pins.  The ``cuda`` tests
hold K17 and K18 to their twins on the card.
"""

import zlib

import numpy as np
import pytest
import torch

import test_torch_jaxref as ref
from fractalshark_tpu_torch import kernels
from fractalshark_tpu_torch.ops import quadd, quadflt
from fractalshark_tpu_torch.ops.hdrfloat import flush_np

SIZE = 16
# name: (x, y, zoom, budget)
FRAMES = {
    "shallow": ("-0.6", "0.45", "64", 256),
    "1e17": ("-0.743643887037151", "0.131825904205330", "1e17", 600),
    "antenna": ("-1.9999999999999999995", "0.0000000000000000003", "1e18",
                200),
}
VARIANTS = ("4x32", "4x64")
N_OPS = 256
OPS = ("add", "sub", "mul", "sqr", "mul_pow2", "to_f64")
# the smoke's phase-15 pins of the QD names (chip_smoke.py LATE_PINS)
QUAD_PINS = ("Gpu4x32 shallow", "Gpu4x64 shallow", "Gpu4x32 1e17",
             "Gpu4x64 1e17", "Gpu4x32 antenna")


def _ptz(frame, pkg="fractalshark_tpu_torch", size=SIZE):
    x, y, zoom, _ = FRAMES[frame]
    return ref.host_layer(pkg).PointZoomBBConverter(
        pt_x=x, pt_y=y, zoom_factor=zoom, prec=256).square_aspect_ratio(
            size, size)


def _operands(npdt, seed):
    """Two operands of N_OPS four-component values: a leading component
    of random sign and magnitude, each next one about an ulp of the last
    below it; a quarter of them tiny enough that the lowest component is
    subnormal (and their products underflow)."""
    rng = np.random.default_rng(seed)
    eps = np.finfo(npdt).eps
    tiny_exp = -70 if npdt == np.float32 else -900
    out = []
    for _ in range(2):
        e = rng.integers(-4, 5, N_OPS).astype(np.float64)
        e[: N_OPS // 4] = tiny_exp + rng.integers(0, 12, N_OPS // 4)
        c = [rng.uniform(1, 2, N_OPS) * np.exp2(e)
             * rng.choice([-1.0, 1.0], N_OPS)]
        for _ in range(3):
            c.append(c[-1] * eps * rng.uniform(-0.5, 0.5, N_OPS))
        out.append(np.stack(c).astype(npdt))
    return out


def _inputs():
    cases = [(kind, dt, npdt) for kind in ("qd", "qf")
             for dt, npdt in (("f32", np.float32), ("f64", np.float64))]
    return {f"{kind}_{dt}_{k}": v
            for seed, (kind, dt, npdt) in enumerate(cases)
            for k, v in zip("xy", _operands(npdt, seed))}


def _apply(mod, kind, op, x, y):
    """One op of module `mod`'s QD (kind "qd") or QF arithmetic: its four
    result components (to_f64: one)."""
    if kind == "qd":
        cls, pre = mod.QD, "qd_"
    else:
        cls, pre = mod.QF, "qf_"
    a, b = cls(*x), cls(*y)
    fn = getattr(mod, pre + op)
    if op == "sqr":
        r = fn(a)
    elif op == "mul_pow2":
        r = fn(a, 2.0)
    elif op == "to_f64":
        return [fn(a)]
    else:
        r = fn(a, b)
    return list(r)


def _jax_reference(inputs):
    import jax
    import jax.numpy as jnp

    from fractalshark_tpu.ops import quadd as jqd
    from fractalshark_tpu.ops import quadflt as jqf
    from test_torch_slice import _jax_cli_with_crc

    import chip_smoke as cs

    out = {}
    for kind, mod in (("qd", jqd), ("qf", jqf)):
        for dt in ("f32", "f64"):
            x = [jnp.asarray(c) for c in inputs[f"{kind}_{dt}_x"]]
            y = [jnp.asarray(c) for c in inputs[f"{kind}_{dt}_y"]]
            for op in OPS:
                r = jax.jit(lambda x, y, op=op, kind=kind, mod=mod:
                            _apply(mod, kind, op, x, y))(x, y)
                out[f"{kind}_{dt}_{op}"] = np.stack([np.asarray(c)
                                                     for c in r])
    for frame, (_, _, _, n) in FRAMES.items():
        ptz = _ptz(frame, "fractalshark_tpu")
        for v in VARIANTS:
            npdt = np.float32 if v == "4x32" else np.float64
            out[f"qd_{frame}_{v}"] = np.asarray(jqd.escape_qd(
                ptz, SIZE, SIZE, n, variant=v))
            out[f"qf_{frame}_{v}"] = np.asarray(jqf.escape_qf(
                ptz, SIZE, SIZE, n, variant=v))
            for kind, split in (("qd", jqd.qd_from_hp),
                                ("qf", jqf.qf_from_hp)):
                hps = (ptz.min_x, ptz.max_y, ptz.delta_x(SIZE),
                       ptz.delta_y(SIZE))
                out[f"split_{kind}_{frame}_{v}"] = np.asarray(
                    [c for hp in hps for c in split(hp, npdt)], npdt)
    for name, fn in (("qd", jqd.escape_qd), ("qf", jqf.escape_qf)):
        try:
            fn(_ptz("shallow", "fractalshark_tpu", 4), 4, 4, 1 << 31)
            out["overflow_" + name] = np.asarray(False)
        except OverflowError:
            out["overflow_" + name] = np.asarray(True)
    for label in QUAD_PINS:
        argv, alg, _, _ = cs.LATE_PINS[label]
        s = _jax_cli_with_crc(argv + ["--render-algorithm", alg, "--width",
                                      "256", "--height", "256"])
        out["pin_" + label] = np.asarray([s["iter_sum"], s["crc32"]])
    return out


@pytest.fixture(scope="module")
def jax_ref(tmp_path_factory):
    return ref.run_jax_reference("test_torch_quad", "_jax_reference",
                                 tmp_path_factory.mktemp("quad"), _inputs())


@pytest.mark.parametrize("kind", ["qd", "qf"])
@pytest.mark.parametrize("dt", ["f32", "f64"])
def test_ops_match_jax_bit_for_bit(jax_ref, kind, dt):
    """Every op on the same operands, the port's inputs flushed as the
    port uploads them (the reference reads subnormals as zero)."""
    inputs = _inputs()
    mod = quadd if kind == "qd" else quadflt
    x = [torch.from_numpy(flush_np(c)) for c in inputs[f"{kind}_{dt}_x"]]
    y = [torch.from_numpy(flush_np(c)) for c in inputs[f"{kind}_{dt}_y"]]
    tiny = np.finfo(np.float32 if dt == "f32" else np.float64).tiny
    low = np.abs(inputs[f"{kind}_{dt}_x"][3])
    assert ((low > 0) & (low < tiny)).any()   # subnormal inputs occur
    for op in OPS:
        got = np.stack([c.numpy() for c in _apply(mod, kind, op, x, y)])
        assert ref.bits_equal(got, jax_ref[f"{kind}_{dt}_{op}"]), op


@pytest.mark.parametrize("frame", list(FRAMES))
@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("kind", ["qd", "qf"])
def test_escape_matches_jax(jax_ref, kind, variant, frame):
    fn = quadd.escape_qd if kind == "qd" else quadflt.escape_qf
    got = fn(_ptz(frame), SIZE, SIZE, FRAMES[frame][3], variant=variant,
             device="cpu")
    want = jax_ref[f"{kind}_{frame}_{variant}"]
    assert want.dtype == np.uint32 and got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))


@pytest.mark.parametrize("frame", ["shallow", "1e17", "antenna"])
@pytest.mark.parametrize("variant", VARIANTS)
def test_view_splits_match_jax(jax_ref, variant, frame):
    """The 16 scalars each escape uploads: the reference's splits (QD at
    max(256, prec) bits, QF at prec bits), flushed."""
    npdt = np.float32 if variant == "4x32" else np.float64
    ptz = _ptz(frame)
    for kind, params in (("qd", quadd.qd_params), ("qf", quadflt.qf_params)):
        want = jax_ref[f"split_{kind}_{frame}_{variant}"]
        got = params(ptz, SIZE, SIZE, variant)
        assert ref.bits_equal(np.asarray(got, npdt), flush_np(want))


def test_antenna_frame_flushes_subnormal_components(jax_ref):
    """On the 1e18 antenna frame the 4x32 splits of dx and dy have
    subnormal low components, which decide counts: 4x32 differs from
    4x64 there, and the port equals the reference in both."""
    raw = jax_ref["split_qd_antenna_4x32"]
    assert ((raw != 0) & (np.abs(raw) < np.finfo(np.float32).tiny)).any()
    assert (jax_ref["qd_antenna_4x32"] != jax_ref["qd_antenna_4x64"]).any()


@pytest.mark.parametrize("variant", VARIANTS)
def test_quad_names_through_fractal_and_cli(jax_ref, variant):
    """Gpu4x32 / Gpu4x64: the QD route, uint32 at the public boundary,
    the grid through Fractal and the stats and CRC through the CLI."""
    from fractalshark_tpu_torch.engine.fractal import Fractal
    from test_torch_families import _cli

    name = "Gpu" + variant
    want = jax_ref[f"qd_antenna_{variant}"]
    x, y, zoom, n = FRAMES["antenna"]
    f = Fractal(width=SIZE, height=SIZE, view=_ptz("antenna"),
                algorithm=name, num_iterations=n, device="cpu")
    f.calc_fractal()
    got = f.iters_numpy()
    assert got.dtype == np.uint32 and f.benchmark.extra["kernel"] == \
        "escape-" + variant
    np.testing.assert_array_equal(got, want)
    s = _cli(["--center-x", x, "--center-y", y, "--zoom", zoom,
              "--iterations", str(n), "--render-algorithm", name,
              "--width", str(SIZE), "--height", str(SIZE)])
    assert s["kernel"] == "escape-" + variant
    assert (s["iter_sum"], s["crc32"]) == (
        int(want.sum()), zlib.crc32(want.astype("<u4").tobytes()))


def test_budgets_of_2_31_raise_as_the_reference(jax_ref):
    assert jax_ref["overflow_qd"] and jax_ref["overflow_qf"]
    ptz = _ptz("shallow", size=4)
    for fn in (quadd.escape_qd, quadflt.escape_qf):
        for n in (1 << 31, (1 << 32) + 5):
            with pytest.raises(OverflowError):
                fn(ptz, 4, 4, n, device="cpu")


@pytest.mark.parametrize("label", QUAD_PINS)
def test_smoke_pins_equal_jax(jax_ref, label):
    import chip_smoke as cs
    assert tuple(int(v) for v in jax_ref["pin_" + label]) == \
        cs.LATE_PINS[label][3]


# ---------------------------------------------------------------- the card


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (K17/K18 have no CPU form)")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("frame", ["shallow", "antenna"])
@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("kind", ["qd", "qf"])
def test_k17_k18_match_twin_on_card(card, kind, variant, frame):
    mod = quadd if kind == "qd" else quadflt
    size, n = 64, FRAMES[frame][3]
    ptz = _ptz(frame, size=size)
    scal = (quadd.qd_params if kind == "qd" else quadflt.qf_params)(
        ptz, size, size, variant)
    dt = torch.float32 if variant == "4x32" else torch.float64
    kernels.reset_counts()
    got = getattr(mod, f"escape_{kind}_kernel")(scal, size, size, n, dt,
                                                card)
    key = {"qd": "escape_" + variant,
           "qf": "escape_qf" + variant[2:]}[kind]
    assert kernels.launches[key] == 1
    want = getattr(mod, f"escape_{kind}_plain")(scal, size, size, n, dt,
                                                card)
    assert torch.equal(got, want)
