"""The streaming LA phase of the port (``fractalshark_tpu_torch/ops/
la_stream.py``, K7's plain twin) against the JAX package's
``la_phase_stream`` (Pallas, interpret mode) on the fixture of
``tests/test_la_stream.py``, bit for bit: the handoff at 32², across
many windows (``win=8``), suspended after every window
(``launch_windows=1``) and at 50×37; against the port's own K2
``la_only`` state; the stream phase plus the RC tail against the full
one-kernel grid; the ``FRACTALSHARK_LA_PHASE`` gate of the renderer.
"""

import numpy as np
import pytest
import torch

import test_torch_jaxref as ref
from fractalshark_tpu_torch.engine import renderers
from fractalshark_tpu_torch.engine.fractal import Fractal
from fractalshark_tpu_torch.engine.perturbation_results import (
    CompressedOrbit)
from fractalshark_tpu_torch.ops import la_kernel
from fractalshark_tpu_torch.ops.la_stream import la_phase_stream
from fractalshark_tpu_torch.ops.perturb_stream import perturb_render_stream_rc

CENTER = ("-0.743643887037158704752191506114774",
          "0.131825904205311970493132056385139")
KEYS = ("it", "jwait", "done", "dzr", "dzi", "dze")
# name: (width, height, budget, keyword arguments of la_phase_stream)
CASES = {
    "base": (32, 32, 1800, {}),
    "win8": (32, 32, 1500, {"win": 8}),
    "relaunch": (32, 32, 1200, {"win": 8, "launch_windows": 1}),
    "nondiv": (50, 37, 1200, {}),
}
RC_ALG = "GpuHDRx32PerturbedRCLAv2"


def _frame(w, h, pkg="fractalshark_tpu_torch"):
    """The 1e8 frame's view at w×h; orbit and LA table built at 32² by
    the host layer of ``pkg``, as tests/test_la_stream.py builds them."""
    hl = ref.host_layer(pkg)

    def ptz(w, h):
        return hl.PointZoomBBConverter(
            pt_x=CENTER[0], pt_y=CENTER[1], zoom_factor="1e8",
            prec=512).square_aspect_ratio(w, h)

    res = hl.RefOrbitCalc().get_and_create_useful_results(ptz(32, 32), 2000)
    la = hl.LAReferenceHost.generate(res.orbit_x, res.orbit_y,
                                     hl.HD.from_hp(res.max_radius))
    return ptz(w, h), res, la


def _jax_reference(_inputs):
    from fractalshark_tpu.engine.perturbation_results import \
        CompressedOrbit as JCO
    from fractalshark_tpu.ops import la_kernel as jla
    from fractalshark_tpu.ops.la_stream import la_phase_stream as jstream
    from fractalshark_tpu.ops.perturb_stream import \
        perturb_render_stream_rc as jrc

    out = {}
    for name, (w, h, n, kw) in CASES.items():
        ptz, res, la = _frame(w, h, "fractalshark_tpu")
        got = jstream(res, la, ptz, w, h, n, tile_h=16, interpret=True, **kw)
        for k in KEYS:
            out[f"{name}_{k}"] = np.asarray(got[k])
    ptz, res, la = _frame(32, 32, "fractalshark_tpu")
    out["full"] = np.asarray(jla.la_perturb_render(
        res, la, ptz, 32, 32, 1800, sub_dtype=np.float32))
    init = jstream(res, la, ptz, 32, 32, 1800, tile_h=16, interpret=True)
    out["two"] = np.asarray(jrc(
        JCO.identity(res), res.center_x, res.center_y, ptz, 32, 32, 1800,
        tile_h=16, interpret=True, init_state=init))
    return out


@pytest.fixture(scope="module")
def jax_ref(tmp_path_factory):
    return ref.run_jax_reference("test_torch_la_stream", "_jax_reference",
                                 tmp_path_factory.mktemp("la_stream"))


@pytest.mark.parametrize("name", list(CASES))
def test_handoff_matches_jax(jax_ref, name):
    w, h, n, kw = CASES[name]
    ptz, res, la = _frame(w, h)
    got = la_phase_stream(res, la, ptz, w, h, n, device="cpu", **kw)
    for k in KEYS:
        want = jax_ref[f"{name}_{k}"]
        np.testing.assert_array_equal(got[k].numpy().astype(want.dtype),
                                      want, err_msg=k)


@pytest.mark.parametrize("name", list(CASES))
def test_handoff_equals_one_machine_state(name):
    """The stream phase hands off what K2's la_only machine does."""
    w, h, n, kw = CASES[name]
    ptz, res, la = _frame(w, h)
    got = la_phase_stream(res, la, ptz, w, h, n, device="cpu", **kw)
    _, _, ref_iter, dzr, dzi, dze, it, _ = la_kernel.la_perturb_render(
        res, la, ptz, w, h, n, la_only=True, return_state=True, device="cpu")
    want = {"it": it, "jwait": ref_iter, "done": it >= n, "dzr": dzr,
            "dzi": dzi, "dze": dze}
    for k in KEYS:
        assert torch.equal(got[k], want[k]), k


def test_stream_then_rc_tail_equals_full_grid(jax_ref):
    ptz, res, la = _frame(32, 32)
    init = la_phase_stream(res, la, ptz, 32, 32, 1800, device="cpu")
    two = perturb_render_stream_rc(
        CompressedOrbit.identity(res), res.center_x, res.center_y, ptz, 32,
        32, 1800, init_state=init, device="cpu")
    full = la_kernel.la_perturb_render(res, la, ptz, 32, 32, 1800,
                                       device="cpu")
    np.testing.assert_array_equal(two.numpy(), jax_ref["two"])
    np.testing.assert_array_equal(two.numpy(), jax_ref["full"])
    assert torch.equal(two, full)


def _rc_fractal():
    from fractalshark_tpu_torch.core.pointzoom import PointZoomBBConverter
    ptz = PointZoomBBConverter(pt_x=CENTER[0], pt_y=CENTER[1],
                               zoom_factor="1e8", prec=512)
    return Fractal(width=16, height=16, view=ptz, algorithm=RC_ALG,
                   num_iterations=600, device="cpu")


def test_env_gate_is_ignored_on_the_cpu(monkeypatch):
    monkeypatch.delenv(renderers.LA_PHASE_ENV, raising=False)
    f = _rc_fractal()
    want = f.calc_fractal()
    monkeypatch.setenv(renderers.LA_PHASE_ENV, "stream")
    f = _rc_fractal()
    got = f.calc_fractal()
    assert f.benchmark.extra["kernel"] == "lav2-rc"
    assert "la_phase" not in f.benchmark.extra
    assert torch.equal(got, want)


@pytest.mark.parametrize("value", ["Stream", "xla", "1", ""])
def test_env_gate_rejects_other_values(monkeypatch, value):
    monkeypatch.setenv(renderers.LA_PHASE_ENV, value)
    with pytest.raises(ValueError, match="FRACTALSHARK_LA_PHASE"):
        _rc_fractal().calc_fractal()


def test_la_phase_stream_needs_the_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    ptz, res, la = _frame(8, 8)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        la_phase_stream(res, la, ptz, 8, 8, 100)


@pytest.mark.cuda
def test_kernel_matches_plain_on_card(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    for name, (w, h, n, kw) in CASES.items():
        ptz, res, la = _frame(w, h)
        k = la_phase_stream(res, la, ptz, w, h, n, device="cuda", **kw)
        p = la_phase_stream(res, la, ptz, w, h, n, device="cpu", **kw)
        for key in KEYS:
            assert torch.equal(k[key].cpu(), p[key]), (name, key)
    monkeypatch.setenv(renderers.LA_PHASE_ENV, "stream")
    f = _rc_fractal()
    f.device = torch.device("cuda")
    got = f.calc_fractal()
    assert f.benchmark.extra["la_phase"] == "stream"
    monkeypatch.delenv(renderers.LA_PHASE_ENV)
    assert torch.equal(got.cpu(), _rc_fractal().calc_fractal())
