"""K3's plain twin (``fractalshark_tpu_torch/ops/perturb_stream.py``)
against the JAX package's RC streaming tail
``perturb_render_stream_rc`` (Pallas, interpret mode), bit for bit:
the two-phase handoff over identity anchors and over compressed anchors
(``error_exp=8``), and handoffs at ``jwait == max_ref`` (the wrap
rebase).
"""

import numpy as np
import pytest
import torch

import test_torch_jaxref as ref
from fractalshark_tpu_torch.engine.perturbation_results import (
    CompressedOrbit)
from fractalshark_tpu_torch.engine.renderers import two_phase_render
from fractalshark_tpu_torch.ops import la_kernel
from fractalshark_tpu_torch.ops import perturb_stream as ps

SIZE, N = 32, 1800
STATE = ("s", "j", "ref_iter", "dzr", "dzi", "dze", "it", "done")


def _fixture(pkg="fractalshark_tpu_torch"):
    """View, orbit and LA table from the host layer of ``pkg``."""
    h = ref.host_layer(pkg)
    ptz = h.PointZoomBBConverter(
        pt_x="-0.743643887037158704752191506114774",
        pt_y="0.131825904205311970493132056385139",
        zoom_factor="1e8", prec=512).square_aspect_ratio(64, 64)
    res = h.RefOrbitCalc().get_and_create_useful_results(ptz, 2000)
    la = h.LAReferenceHost.generate(res.orbit_x, res.orbit_y,
                                    h.HD.from_hp(res.max_radius))
    return ptz, res, la


def _inits(state, max_ref):
    """Handoff dicts (numpy) from a phase-1 state: as handed over, and
    with every 5th live pixel moved to jwait == max_ref."""
    st = dict(zip(STATE, (np.asarray(a) for a in state)))
    it = st["it"].astype(np.int64)
    base = {"dzr": st["dzr"], "dzi": st["dzi"], "dze": st["dze"],
            "it": it, "jwait": st["ref_iter"].astype(np.int64),
            "done": (it >= N).astype(np.int32)}
    wrap = dict(base)
    pick = (np.arange(it.size).reshape(it.shape) % 5 == 0) & (it < N)
    wrap["jwait"] = np.where(pick, max_ref, base["jwait"]).astype(np.int64)
    return base, wrap


def _jax_reference(_inputs):
    from fractalshark_tpu.engine.perturbation_results import CompressedOrbit
    from fractalshark_tpu.ops import la_kernel as jla
    from fractalshark_tpu.ops.perturb_stream import perturb_render_stream_rc

    ptz, res, la = _fixture("fractalshark_tpu")
    out = {"full": np.asarray(jla.la_perturb_render(
        res, la, ptz, SIZE, SIZE, N, sub_dtype=np.float32))}
    state = jla.la_perturb_render(res, la, ptz, SIZE, SIZE, N,
                                  sub_dtype=np.float32, la_only=True,
                                  return_state=True)
    base, wrap = _inits(state, res.max_ref_iteration())
    ident = CompressedOrbit.identity(res)
    comp = CompressedOrbit.from_uncompressed(res, error_exp=8)

    def rc(c, init):
        return np.asarray(perturb_render_stream_rc(
            c, res.center_x, res.center_y, ptz, SIZE, SIZE, N, tile_h=16,
            interpret=True, init_state=dict(init)))

    out["identity"] = rc(ident, base)
    out["compressed"] = rc(comp, base)
    out["wrap"] = rc(ident, wrap)
    return out


@pytest.fixture(scope="module")
def jax_ref(tmp_path_factory):
    return ref.run_jax_reference("test_torch_rc_tail", "_jax_reference",
                                 tmp_path_factory.mktemp("rc_tail"))


@pytest.fixture(scope="module")
def deep():
    ptz, res, la = _fixture()
    state = la_kernel.la_perturb_render(res, la, ptz, SIZE, SIZE, N,
                                        la_only=True, return_state=True,
                                        device="cpu")
    base, wrap = _inits(state, res.max_ref_iteration())
    return ptz, res, la, base, wrap


def _rc(deep, comp, init, **kw):
    ptz, res = deep[0], deep[1]
    init = {k: torch.as_tensor(v) for k, v in init.items()}
    return ps.perturb_render_stream_rc(
        comp, res.center_x, res.center_y, ptz, SIZE, SIZE, N,
        init_state=init, device="cpu", **kw).numpy()


def test_identity_two_phase_matches_sweep_and_full(jax_ref, deep):
    got = _rc(deep, CompressedOrbit.identity(deep[1]), deep[3])
    np.testing.assert_array_equal(got, jax_ref["identity"].astype(np.int64))
    np.testing.assert_array_equal(got, jax_ref["full"].astype(np.int64))


def test_compressed_anchors_match_sweep(jax_ref, deep):
    comp = CompressedOrbit.from_uncompressed(deep[1], error_exp=8)
    assert comp.compression_ratio() > 2  # real catch-up work
    got = _rc(deep, comp, deep[3])
    np.testing.assert_array_equal(got, jax_ref["compressed"].astype(np.int64))


def test_wrap_handoff_matches_sweep(jax_ref, deep):
    got = _rc(deep, CompressedOrbit.identity(deep[1]), deep[4])
    np.testing.assert_array_equal(got, jax_ref["wrap"].astype(np.int64))
    # the wrap really changed those pixels' start
    assert (deep[4]["jwait"] != deep[3]["jwait"]).any()


def test_chunked_tail_equals_whole(jax_ref, deep):
    got = _rc(deep, CompressedOrbit.identity(deep[1]), deep[3],
              chunk_steps=97)
    np.testing.assert_array_equal(got, jax_ref["identity"].astype(np.int64))


def test_two_phase_render_composition(jax_ref, deep):
    ptz, res, la = deep[:3]
    timings = {}
    got = two_phase_render(res, la, ptz, SIZE, SIZE, N, device="cpu",
                           timings=timings)
    np.testing.assert_array_equal(got.numpy(), jax_ref["full"].astype(np.int64))
    assert {"phase1_s", "phase2_s"} <= set(timings)


def test_anchor_table_needs_position_zero(deep):
    comp = CompressedOrbit.identity(deep[1])
    bad = CompressedOrbit(comp.anchors_x[1:], comp.anchors_y[1:],
                          comp.anchor_index[1:], comp.total_count,
                          comp.cx_low, comp.cy_low, 0)
    with pytest.raises(ValueError):
        ps.anchors_on(bad, torch.device("cpu"))


@pytest.mark.cuda
def test_kernel_matches_plain_on_card(deep):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    ptz, res, la, base, wrap = deep
    comp = CompressedOrbit.from_uncompressed(res, error_exp=8)
    for init in (base, wrap):
        k = ps.perturb_render_stream_rc(
            comp, res.center_x, res.center_y, ptz, SIZE, SIZE, N,
            init_state={k: torch.as_tensor(v) for k, v in init.items()},
            device="cuda").cpu().numpy()
        np.testing.assert_array_equal(k, _rc(deep, comp, init))
