"""K16's plain twin (``fractalshark_tpu_torch/ops/hdr_df.py``) against
the JAX package, bit for bit: the HDC2 operations on random operands and
on the cases of ``tests/test_hdr_df.py`` (exponent alignment, the ignore
threshold, the zero sentinel), the dc grids, the orbit table, the render
on the 1e8 frame (one lockstep run and launches over the live pixels),
the 2x32 and hdr2x32 names through the CLI (PO mode, and an LAv2 name on
View #2, whose LA table is invalid), the int32 budget, and the smoke's
phase-15 K16 pins.  The ``cuda`` test holds K16 to its twin on the card.
"""

import zlib

import numpy as np
import pytest
import torch

import test_torch_jaxref as ref
from fractalshark_tpu_torch import kernels
from fractalshark_tpu_torch.ops import hdr_df
from fractalshark_tpu_torch.ops.dblflt import DF
from fractalshark_tpu_torch.ops.hdrfloat import MIN_BIG_EXPONENT, flush_np

SIZE = 16
DEEP = ("-0.743643887037158704752191506114774",
        "0.131825904205311970493132056385139", "1e8", 1500)
OPS = ("add", "mul", "mul_pow2", "reduce", "norm_squared_hi")
N_RANDOM = 240
# the 2x32 / hdr2x32 names the CLI renders through K16 here: (argv,
# route's frame); View #2 has no valid LA table
CLI_NAMES = {
    "Gpu2x32PerturbedLAv2PO": "deep", "GpuHDRx2x32PerturbedLAv2PO": "deep",
    "Gpu2x32PerturbedLAv2": "view2",
}
HDR_DF_PINS = ("Gpu2x32PerturbedLAv2PO 1e8",
               "GpuHDRx2x32PerturbedLAv2PO 1e8",
               "Gpu2x32PerturbedLAv2 View #2")


def _cli_argv(frame):
    if frame == "view2":
        return ["--view", "2"]
    x, y, zoom, n = DEEP
    return ["--center-x", x, "--center-y", y, "--zoom", zoom,
            "--iterations", str(n)]


def _operands():
    """Two HDC2 operands as (re hi, re lo, im hi, im lo, e) arrays: the
    cases of tests/test_hdr_df.py:15-75 first (1.5·2^100 + 1.0·2^70, 1.0
    + 1.9·2^-400, zero sentinels on either side), then random values
    with exponents within and past the ignore threshold and low halves
    about an ulp of the high ones."""
    rng = np.random.default_rng(11)
    z = MIN_BIG_EXPONENT
    special = [  # (a re hi, a e, b re hi, b e)
        (1.5, 100, 1.0, 70), (1.0, 0, 1.9, -400), (1.0, 0, 0.0, z),
        (0.0, z, -1.25, 3), (0.0, z, 0.0, z), (1.75, -5, -1.75, -5)]
    out = []
    for side in range(2):
        n = N_RANDOM
        hi = rng.uniform(1, 2, (2, n)) * np.exp2(rng.integers(-3, 4, (2, n)))
        hi *= rng.choice([-1.0, 1.0], (2, n))
        lo = hi * 2.0 ** -24 * rng.uniform(-0.5, 0.5, (2, n))
        e = rng.integers(-140, 141, n)
        re_hi = np.concatenate([[c[2 * side] for c in special], hi[0]])
        im_hi = np.concatenate([np.zeros(len(special)), hi[1]])
        re_lo = np.concatenate([np.zeros(len(special)), lo[0]])
        im_lo = np.concatenate([np.zeros(len(special)), lo[1]])
        ex = np.concatenate([[c[2 * side + 1] for c in special], e])
        out.append(tuple(a.astype(np.float32) for a in (re_hi, re_lo, im_hi,
                                                        im_lo))
                   + (ex.astype(np.int32),))
    return out


def _inputs():
    a, b = _operands()
    return {f"{k}_{i}": v for k, op in (("a", a), ("b", b))
            for i, v in enumerate(op)}


def _apply(mod, hdr, ops_in, op):
    """`op` of module `mod` (an hdr_df) on the operands: the result's
    (re hi, re lo, im hi, im lo, e), or norm_squared_hi's reduced (m,
    e)."""
    def mk(t):
        return mod.HDC2(DF(t[0], t[1]), DF(t[2], t[3]), t[4])
    a, b = mk(ops_in[0]), mk(ops_in[1])
    if op == "add":
        r = mod.add(a, b)
    elif op == "mul":
        r = mod.mul(a, b)
    elif op == "mul_pow2":
        r = mod.mul_pow2(a, 1)
    elif op == "reduce":
        r = mod.reduce(mod.add(a, b))
    else:
        h = hdr.reduce(mod.norm_squared_hi(a))
        return [h.m, h.e]
    return [r.re.hi, r.re.lo, r.im.hi, r.im.lo, r.e]


def _frame(pkg, which, size=SIZE):
    h = ref.host_layer(pkg)
    if which == "view9":
        ptz = h.get_view_preset(9).ptz.square_aspect_ratio(size, size)
        n = 40000
    else:
        x, y, zoom, n = DEEP
        ptz = h.PointZoomBBConverter(
            pt_x=x, pt_y=y, zoom_factor=zoom,
            prec=512).square_aspect_ratio(size, size)
    res = h.RefOrbitCalc().get_and_create_useful_results(ptz, n)
    return ptz, res, n


def _jax_reference(inputs):
    import jax
    import jax.numpy as jnp

    from fractalshark_tpu.ops import hdr_df as jhd
    from fractalshark_tpu.ops import hdrfloat as jhdr
    from fractalshark_tpu.ops.perturb import delta_params
    from test_torch_slice import _jax_cli_with_crc

    import chip_smoke as cs

    ops_in = [[jnp.asarray(inputs[f"{k}_{i}"]) for i in range(5)]
              for k in "ab"]
    out = {}
    for op in OPS:
        r = jax.jit(lambda a, b, op=op: _apply(jhd, jhdr, (a, b), op))(
            *ops_in)
        for i, c in enumerate(r):
            out[f"{op}_{i}"] = np.asarray(c)
    for which in ("deep", "view9"):
        ptz, res, _ = _frame("fractalshark_tpu", which)
        dc = jhd._dc_grids_hdrdf(*delta_params(
            ptz, res.center_x, res.center_y, SIZE, SIZE), SIZE, SIZE)
        for i, c in enumerate((*dc.re, *dc.im, dc.e)):
            out[f"dc_{which}_{i}"] = np.asarray(c)
    ptz, res, n = _frame("fractalshark_tpu", "deep")
    out["render"] = np.asarray(jhd.perturb_render_hdr_df(res, ptz, SIZE,
                                                         SIZE, n))
    out["orbit_df"] = np.stack(res.device_orbit_df())
    out["max_ref"] = np.asarray(res.max_ref_iteration())
    try:
        jhd.perturb_render_hdr_df(res, ptz, 2, 2, 1 << 31)
        out["overflow"] = np.asarray(False)
    except OverflowError:
        out["overflow"] = np.asarray(True)
    for name, frame in CLI_NAMES.items():
        s = _jax_cli_with_crc(_cli_argv(frame) + [
            "--render-algorithm", name, "--width", str(SIZE), "--height",
            str(SIZE)])
        out["cli_" + name] = np.asarray([s["iter_sum"], s["crc32"],
                                         s["iter_min"], s["iter_max"]])
    for label in HDR_DF_PINS:
        argv, alg, _, _ = cs.LATE_PINS[label]
        s = _jax_cli_with_crc(argv + ["--render-algorithm", alg, "--width",
                                      "256", "--height", "256"])
        out["pin_" + label] = np.asarray([s["iter_sum"], s["crc32"]])
    return out


@pytest.fixture(scope="module")
def jax_ref(tmp_path_factory):
    return ref.run_jax_reference("test_torch_hdr_df", "_jax_reference",
                                 tmp_path_factory.mktemp("hdr_df"),
                                 _inputs())


@pytest.mark.parametrize("op", OPS)
def test_hdc2_ops_match_jax(jax_ref, op):
    from fractalshark_tpu_torch.ops import hdrfloat
    inputs = _inputs()
    ops_in = [[torch.from_numpy(flush_np(inputs[f"{k}_{i}"]))
               for i in range(5)] for k in "ab"]
    got = _apply(hdr_df, hdrfloat, ops_in, op)
    for i, c in enumerate(got):
        assert ref.bits_equal(c.numpy(), jax_ref[f"{op}_{i}"]), (op, i)


def test_reference_cases_of_the_hdr_df_tests(jax_ref):
    """tests/test_hdr_df.py's cases, now in the port: 1.5·2^100 +
    1.0·2^70 aligns to 1.5 + 2^-30 at exponent 100; 1.9·2^-400 vanishes
    beside 1.0 (its residue below 2^-120); a zero-sentinel operand leaves
    the other as it is."""
    re_hi, re_lo, e = (jax_ref[f"add_{i}"] for i in (0, 1, 4))
    assert (float(re_hi[0]) + float(re_lo[0]), int(e[0])) == (
        1.5 + 2.0 ** -30, 100)
    assert re_hi[1] == 1.0 and abs(float(re_lo[1])) < 2.0 ** -120
    assert (re_hi[2], e[2]) == (1.0, 0) and (re_hi[3], e[3]) == (-1.25, 3)
    assert e[4] == MIN_BIG_EXPONENT
    assert jax_ref["reduce_4"][4] == MIN_BIG_EXPONENT


@pytest.mark.parametrize("which", ["deep", "view9"])
def test_dc_grids_match_jax(jax_ref, which):
    from fractalshark_tpu_torch.ops.perturb import delta_params
    ptz, res, _ = _frame("fractalshark_tpu_torch", which)
    dc = hdr_df._dc_grids_hdrdf(*delta_params(
        ptz, res.center_x, res.center_y, SIZE, SIZE), SIZE, SIZE)
    for i, c in enumerate((*dc.re, *dc.im, dc.e)):
        assert ref.bits_equal(c.numpy(), jax_ref[f"dc_{which}_{i}"]), i


def test_orbit_table_holds_the_reference_orbit(jax_ref):
    """Row r of K16's table is (Z[r], Z[r+1]) of the reference's
    double-float orbit, flushed, for every position a step reads."""
    _, res, _ = _frame("fractalshark_tpu_torch", "deep")
    t = hdr_df.pack_orbit_df(res, "cpu").numpy()
    cols = flush_np(jax_ref["orbit_df"].T)
    mr = int(jax_ref["max_ref"])
    assert t.shape == (mr, 8)
    assert ref.bits_equal(t[:, :4], cols[:mr])
    assert ref.bits_equal(t[:, 4:], cols[1:mr + 1])


@pytest.mark.parametrize("chunk", [None, 7])
def test_render_matches_jax(jax_ref, chunk):
    """One lockstep run, and launches of 7 steps each over the pixels the
    last one left live."""
    ptz, res, n = _frame("fractalshark_tpu_torch", "deep")
    got = hdr_df.perturb_render_hdr_df(res, ptz, SIZE, SIZE, n,
                                       chunk_steps=chunk, device="cpu")
    want = jax_ref["render"]
    assert want.dtype == np.uint32 and got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))
    assert 0 < int(got.min()) < n == int(got.max())


@pytest.mark.parametrize("name", list(CLI_NAMES))
def test_names_render_through_k16_as_jax(jax_ref, name):
    from test_torch_families import _cli
    s = _cli(_cli_argv(CLI_NAMES[name]) + [
        "--render-algorithm", name, "--width", str(SIZE), "--height",
        str(SIZE)])
    assert s["kernel"] == "hdr-df" and "perturb_s" in s["timings"]
    assert (s["iter_sum"], s["crc32"], s["iter_min"], s["iter_max"]) == \
        tuple(int(v) for v in jax_ref["cli_" + name])


def test_public_grid_is_uint32(jax_ref):
    from fractalshark_tpu_torch.engine.fractal import Fractal
    ptz, _, n = _frame("fractalshark_tpu_torch", "deep")
    f = Fractal(width=SIZE, height=SIZE, view=ptz,
                algorithm="GpuHDRx2x32PerturbedLAv2PO", num_iterations=n,
                device="cpu")
    f.calc_fractal()
    got = f.iters_numpy()
    assert got.dtype == np.uint32 and f.benchmark.extra["kernel"] == "hdr-df"
    assert zlib.crc32(got.astype("<u4").tobytes()) == \
        int(jax_ref["cli_GpuHDRx2x32PerturbedLAv2PO"][1])


def test_budgets_of_2_31_raise_as_the_reference(jax_ref):
    assert jax_ref["overflow"]
    ptz, res, _ = _frame("fractalshark_tpu_torch", "deep", 2)
    for n in (1 << 31, (1 << 32) + 5):
        with pytest.raises(OverflowError):
            hdr_df.perturb_render_hdr_df(res, ptz, 2, 2, n, device="cpu")


@pytest.mark.parametrize("label", HDR_DF_PINS)
def test_smoke_pins_equal_jax(jax_ref, label):
    import chip_smoke as cs
    assert tuple(int(v) for v in jax_ref["pin_" + label]) == \
        cs.LATE_PINS[label][3]


# ---------------------------------------------------------------- the card


@pytest.mark.cuda
def test_k16_matches_twin_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (K16 has no CPU form)")
    card = torch.device("cuda", 0)
    ptz, res, n = _frame("fractalshark_tpu_torch", "deep", 64)
    from fractalshark_tpu_torch.ops.perturb import delta_params
    orbit = hdr_df.pack_orbit_df(res, card)
    dc = hdr_df.dc_tensors(hdr_df._dc_grids_hdrdf(*delta_params(
        ptz, res.center_x, res.center_y, 64, 64), 64, 64, card))
    mr = res.max_ref_iteration()
    kernels.reset_counts()
    got = hdr_df.run_state(orbit, dc, n, mr, chunk_steps=257)
    assert kernels.launches["perturb_hdr_df"] >= 2
    want = hdr_df.perturb_hdr_df_plain(
        orbit, dc, hdr_df.init_state_plain(64 * 64, n, card), n, mr)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
