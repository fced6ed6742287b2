"""K6's plain twin (``fractalshark_tpu_torch/ops/perturb.py``) and the B10
and B11 entry points (``ops/perturb_pallas.py``,
``ops/perturb_stream.py::perturb_render_stream``) against the JAX
package, bit for bit: ``perturb_render_hdr`` (f32, f64),
``perturb_render_float`` (f32, f64), and the Pallas kernels of B10 and
B11 in interpret mode, on the 1e8 frame of ``tests/test_perturb_stream.py``
(an orbit of several 1,024-entry windows), on View #6 with its budget cut
(an orbit past B10's cap), on View #2 (58 entries, no valid LA table)
and on View #3 with its budget cut; then chunked relaunch and abort.
"""

import types

import numpy as np
import pytest
import torch

import test_torch_jaxref as ref
from fractalshark_tpu_torch.ops import perturb
from fractalshark_tpu_torch.ops.perturb_pallas import perturb_render_pallas
from fractalshark_tpu_torch.ops.perturb_stream import perturb_render_stream

SIZE, BUDGET = 32, 2000
V6_SIZE, V6_BUDGET = 16, 2000
V3_BUDGET = 3000
# a 64-bit budget: every View #2 pixel escapes long before it
BIG_BUDGET = (1 << 32) + 7


def _deep(pkg="fractalshark_tpu_torch", size=SIZE):
    h = ref.host_layer(pkg)
    ptz = h.PointZoomBBConverter(
        pt_x="-0.743643887037158704752191506114774",
        pt_y="0.131825904205311970493132056385139",
        zoom_factor="1e8", prec=512).square_aspect_ratio(size, size)
    return ptz, h.RefOrbitCalc().get_and_create_useful_results(ptz, BUDGET)


def _view(v, size, pkg="fractalshark_tpu_torch"):
    h = ref.host_layer(pkg)
    p = h.get_view_preset(v)
    ptz = p.ptz.square_aspect_ratio(size, size)
    return ptz, h.RefOrbitCalc().get_and_create_useful_results(
        ptz, p.num_iterations), p.num_iterations


def _jax_reference(_inputs):
    from fractalshark_tpu.ops import perturb as jp
    from fractalshark_tpu.ops.perturb_pallas import \
        perturb_render_pallas as jpallas
    from fractalshark_tpu.ops.perturb_stream import \
        perturb_render_stream as jstream

    out = {}
    ptz, res = _deep("fractalshark_tpu")
    for name, dt in (("f32", np.float32), ("f64", np.float64)):
        out["hdr_" + name] = np.asarray(jp.perturb_render_hdr(
            res, ptz, SIZE, SIZE, BUDGET, sub_dtype=dt))
        out["float_" + name] = np.asarray(jp.perturb_render_float(
            res, ptz, SIZE, SIZE, BUDGET, dtype=dt))
    out["pallas"] = np.asarray(jpallas(res, ptz, SIZE, SIZE, BUDGET,
                                       tile_h=16, interpret=True))
    out["stream"] = np.asarray(jstream(res, ptz, SIZE, SIZE, BUDGET,
                                       tile_h=16, interpret=True))
    ptz, res, _ = _view(6, V6_SIZE, "fractalshark_tpu")
    out["v6_stream"] = np.asarray(jstream(res, ptz, V6_SIZE, V6_SIZE,
                                          V6_BUDGET, tile_h=16,
                                          interpret=True))
    out["v6_hdr"] = np.asarray(jp.perturb_render_hdr(
        res, ptz, V6_SIZE, V6_SIZE, V6_BUDGET, sub_dtype=np.float32))
    ptz, res, n = _view(2, SIZE, "fractalshark_tpu")
    out["v2_float_f64"] = np.asarray(jp.perturb_render_float(
        res, ptz, SIZE, SIZE, n, dtype=np.float64))
    out["v2_stream_big"] = np.asarray(jstream(res, ptz, 16, 16, BIG_BUDGET,
                                              tile_h=16, interpret=True))
    ptz, res, _ = _view(3, SIZE, "fractalshark_tpu")
    out["v3_hdr_f64"] = np.asarray(jp.perturb_render_hdr(
        res, ptz, SIZE, SIZE, V3_BUDGET, sub_dtype=np.float64))
    return out


@pytest.fixture(scope="module")
def jax_ref(tmp_path_factory):
    return ref.run_jax_reference("test_torch_perturb", "_jax_reference",
                                 tmp_path_factory.mktemp("perturb"))


@pytest.fixture(scope="module")
def deep():
    return _deep()


def _eq(got: torch.Tensor, want: np.ndarray):
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))


@pytest.mark.parametrize("dtype", ["f32", "f64"])
def test_hdr_matches_jax(jax_ref, deep, dtype):
    ptz, res = deep
    got = perturb.perturb_render_hdr(res, ptz, SIZE, SIZE, BUDGET,
                                     sub_dtype=getattr(np, "float" + dtype[1:]),
                                     device="cpu")
    _eq(got, jax_ref["hdr_" + dtype])


@pytest.mark.parametrize("dtype", ["f32", "f64"])
def test_float_matches_jax(jax_ref, deep, dtype):
    ptz, res = deep
    got = perturb.perturb_render_float(res, ptz, SIZE, SIZE, BUDGET,
                                       dtype=getattr(np, "float" + dtype[1:]),
                                       device="cpu")
    _eq(got, jax_ref["float_" + dtype])


def test_pallas_route_matches_jax_pallas(jax_ref, deep):
    """B10's route: the orbit (several windows long) is within its cap,
    as is the budget; bit-identical to the Pallas kernel."""
    ptz, res = deep
    got = perturb_render_pallas(res, ptz, SIZE, SIZE, BUDGET, device="cpu")
    assert got is not None
    _eq(got, jax_ref["pallas"])


def test_pallas_route_caps(deep):
    """Past the reference's caps (orbit > 8,192 entries, budget >
    200,000) B10's entry point declines, as the reference's does."""
    ptz, res = deep
    assert perturb_render_pallas(res, ptz, 4, 4, 200_001,
                                 device="cpu") is None
    ptz6, res6, _ = _view(6, 4)
    assert res6.count_orbit_entries() > 8192
    assert perturb_render_pallas(res6, ptz6, 4, 4, 100, device="cpu") is None


def test_stream_route_matches_jax_stream(jax_ref, deep):
    """B11's route on the 1e8 frame: the lockstep sweep's unreduced
    compares and the port's reduced ones give the same grid."""
    ptz, res = deep
    got = perturb_render_stream(res, ptz, SIZE, SIZE, BUDGET, device="cpu")
    _eq(got, jax_ref["stream"])
    _eq(got, jax_ref["hdr_f32"])


def test_stream_route_view6_cut_budget(jax_ref):
    """B11's route where B10 cannot go: View #6's 457,977-entry orbit."""
    ptz, res, _ = _view(6, V6_SIZE)
    got = perturb_render_stream(res, ptz, V6_SIZE, V6_SIZE, V6_BUDGET,
                                device="cpu")
    _eq(got, jax_ref["v6_stream"])
    _eq(got, jax_ref["v6_hdr"])


def test_stream_64bit_budget(jax_ref):
    """A budget past 2^32: int64 counters, no wrap; the reference
    returns uint64 there, the port's public grid too."""
    ptz, res, _ = _view(2, 16)
    got = perturb_render_stream(res, ptz, 16, 16, BIG_BUDGET, device="cpu")
    want = jax_ref["v2_stream_big"]
    assert want.dtype == np.uint64
    _eq(got, want)
    assert int(got.max()) < 1000


def test_view2_float_f64_full_budget(jax_ref):
    """View #2 (no valid LA table): the f64 float render AUTO falls back
    to on the card."""
    ptz, res, n = _view(2, SIZE)
    got = perturb.perturb_render_float(res, ptz, SIZE, SIZE, n,
                                       dtype=np.float64, device="cpu")
    _eq(got, jax_ref["v2_float_f64"])


def test_view3_hdr_f64_cut_budget(jax_ref):
    ptz, res, _ = _view(3, SIZE)
    got = perturb.perturb_render_hdr(res, ptz, SIZE, SIZE, V3_BUDGET,
                                     sub_dtype=np.float64, device="cpu")
    _eq(got, jax_ref["v3_hdr_f64"])


@pytest.mark.parametrize("hdr_mode", [True, False])
def test_chunked_relaunch_and_abort(deep, hdr_mode):
    ptz, res = deep
    render = (perturb.perturb_render_hdr if hdr_mode
              else perturb.perturb_render_float)
    whole = render(res, ptz, 16, 16, BUDGET, device="cpu")
    chunked = render(res, ptz, 16, 16, BUDGET, chunk_steps=300, device="cpu")
    assert perturb.last_run_stats["dispatches"] > 1
    assert torch.equal(whole, chunked)
    aborted = types.SimpleNamespace(aborted=lambda: True)
    part = render(res, ptz, 16, 16, BUDGET, chunk_steps=300,
                  abort_monitor=aborted, device="cpu")
    assert perturb.last_run_stats["dispatches"] == 1
    assert int(part.sum()) < int(whole.sum())
    assert int(part.max()) <= 300


def test_stream_launch_windows_bound_each_launch(deep):
    ptz, res = deep
    whole = perturb_render_stream(res, ptz, 16, 16, BUDGET, device="cpu")
    windows = perturb_render_stream(res, ptz, 16, 16, BUDGET,
                                    launch_windows=1, device="cpu")
    assert int(whole.max()) == BUDGET
    assert perturb.last_run_stats["dispatches"] == -(-BUDGET // 1024)
    assert torch.equal(whole, windows)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("hdr_mode", [True, False])
def test_kernel_matches_plain_on_card(deep, dtype, hdr_mode):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from fractalshark_tpu_torch.ops.hdrfloat import HDRComplex
    from fractalshark_tpu_torch.ops.tables import orbit_on
    ptz, res = deep
    dev = torch.device("cuda")
    orbit = orbit_on(res, dev, dtype)
    grids = perturb._dc_grids_hdr if hdr_mode else perturb._dc_grids_float
    dc = grids(*perturb.delta_params(ptz, res.center_x, res.center_y, SIZE,
                                     SIZE), SIZE, SIZE, dev, dtype)
    mr = res.max_ref_iteration()
    k = perturb.perturb_run(orbit, dc, BUDGET, mr, hdr_mode, "perturb_hdr32",
                            chunk_steps=333)
    flat = HDRComplex(*(t.reshape(-1) for t in dc))
    p = perturb.perturb_plain(orbit, flat, perturb.init_state_plain(
        flat, BUDGET, hdr_mode), BUDGET, mr, hdr_mode)
    assert torch.equal(k.reshape(-1), p[4])
