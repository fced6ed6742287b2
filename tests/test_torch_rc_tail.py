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
from fractalshark_tpu_torch.ops import la_kernel, perturb
from fractalshark_tpu_torch.ops import perturb_stream as ps
from fractalshark_tpu_torch.ops.hdrfloat import HDRComplex
from fractalshark_tpu_torch.ops.tables import anchor_table, orbit_on

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


def _last_anchor_at_max_ref(C, comp, res):
    """`comp` with an anchor at max_ref (the exact orbit's value there),
    a boundary of the anchor cursor: the step into the orbit's last
    position reads an anchor and rebases."""
    x, y = res.orbit_plain()
    m = comp.total_count - 1
    assert comp.anchor_index[-1] < m
    return C(np.append(comp.anchors_x, x[m]), np.append(comp.anchors_y, y[m]),
             np.append(comp.anchor_index, m), comp.total_count, comp.cx_low,
             comp.cy_low, comp.error_exp)


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
    out["compressed_last_wrap"] = rc(
        _last_anchor_at_max_ref(CompressedOrbit, comp, res), wrap)
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


@pytest.mark.parametrize("wide,chunk_steps",
                         [(False, 0), (False, 1), (False, 7), (True, 7)])
def test_compressed_tail_in_live_pixel_launches(jax_ref, deep, wide,
                                                chunk_steps):
    """K3's twin over compressed anchors with int32 (or, `wide`, int64)
    positions and anchor pointers, in launches of `chunk_steps` steps
    (0: one launch), each after the first over the pixels the last one
    left live: the JAX sweep's grid."""
    ptz, res = deep[:2]
    comp = CompressedOrbit.from_uncompressed(res, error_exp=8)
    A = anchor_table(comp, torch.device("cpu"), wide=wide)
    assert A.index.dtype == (torch.int64 if wide else torch.int32)
    dc = perturb._dc_grids_hdr(*perturb.delta_params(
        ptz, res.center_x, res.center_y, SIZE, SIZE), SIZE, SIZE, "cpu")
    init = {k: torch.as_tensor(v) for k, v in deep[3].items()}
    rem = ps.rc_tail_run(A, dc, init, N, ps.wrap_value(comp, A.max_ref),
                         chunk_steps)
    np.testing.assert_array_equal((N - rem).reshape(SIZE, SIZE).numpy(),
                                  jax_ref["compressed"].astype(np.int64))
    work = ps.last_run_stats["work"]
    assert work[0] == SIZE * SIZE
    assert all(b <= a for a, b in zip(work, work[1:]))
    assert (len(work) > 2) == bool(chunk_steps)


def test_compressed_last_anchor_at_max_ref(jax_ref, deep):
    """An anchor at max_ref, with handoffs at jwait == max_ref: the JAX
    sweep's grid."""
    comp = _last_anchor_at_max_ref(
        CompressedOrbit, CompressedOrbit.from_uncompressed(deep[1],
                                                           error_exp=8),
        deep[1])
    got = _rc(deep, comp, deep[4])
    np.testing.assert_array_equal(
        got, jax_ref["compressed_last_wrap"].astype(np.int64))


def test_wrap_handoff_matches_sweep(jax_ref, deep):
    got = _rc(deep, CompressedOrbit.identity(deep[1]), deep[4])
    np.testing.assert_array_equal(got, jax_ref["wrap"].astype(np.int64))
    # the wrap really changed those pixels' start
    assert (deep[4]["jwait"] != deep[3]["jwait"]).any()


def test_chunked_tail_equals_whole(jax_ref, deep):
    got = _rc(deep, CompressedOrbit.identity(deep[1]), deep[3],
              chunk_steps=97)
    np.testing.assert_array_equal(got, jax_ref["identity"].astype(np.int64))


def _identity_twins(deep, init, chunk_steps):
    """The tail over identity anchors two ways from one handoff: K3's
    twin (``rc_init_plain`` then ``rc_tail_plain``), and K6's twin
    resumed from the handoff (``perturb.handoff_plain``) in one lockstep
    run and through
    ``perturb_run``'s live-pixel launches of `chunk_steps`.  Returns the
    two states in K6's order (dzr, dzi, dze, j, it, done) and the run's
    grid."""
    ptz, res = deep[0], deep[1]
    init = {k: torch.as_tensor(v) for k, v in init.items()}
    comp = CompressedOrbit.identity(res)
    A = ps.anchors_on(comp, torch.device("cpu"))
    dc = perturb._dc_grids_hdr(*perturb.delta_params(
        ptz, res.center_x, res.center_y, SIZE, SIZE), SIZE, SIZE, "cpu")
    flat = HDRComplex(*(t.reshape(-1) for t in dc))
    k3 = ps.rc_tail_plain(A, flat, ps.rc_init_plain(
        A, ps.handoff_state(A, init, "cpu"), N,
        ps.wrap_value(comp, A.max_ref)))
    dzr, dzi, dze, rem, pos, _, _, done = k3
    orbit = orbit_on(res, torch.device("cpu"))
    mr = res.max_ref_iteration()
    k6 = perturb.perturb_plain(orbit, flat, perturb.handoff_plain(
        orbit, perturb.handoff_state(init, "cpu"), N, mr), N, mr, True)
    grid = perturb.perturb_run(orbit, dc, N, mr, True, "two_phase_tail",
                               chunk_steps,
                               state=perturb.handoff_state(init, "cpu"),
                               handoff=True)
    return (dzr, dzi, dze, pos, N - rem, done), k6, grid


@pytest.mark.parametrize("chunk_steps", [0, 7])
@pytest.mark.parametrize("handoff", ["base", "wrap"])
def test_identity_tail_is_k6_resumed(jax_ref, deep, handoff, chunk_steps):
    """The two-phase tail over identity anchors is K6's HDR-f32 step
    resumed from the handoff: every state array of K3's twin equals K6's
    twin's, bit for bit, and both equal the JAX RC kernel's grid."""
    init = deep[3] if handoff == "base" else deep[4]
    k3, k6, grid = _identity_twins(deep, init, chunk_steps)
    for a, b, name in zip(k3, k6, perturb._STATE):
        assert torch.equal(a, b), name
    want = jax_ref["identity" if handoff == "base" else "wrap"]
    np.testing.assert_array_equal(k6[4].reshape(SIZE, SIZE).numpy(),
                                  want.astype(np.int64))
    np.testing.assert_array_equal(grid.numpy(), want.astype(np.int64))
    if chunk_steps:
        assert perturb.last_run_stats["dispatches"] > 1


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
@pytest.mark.parametrize("wide,chunk_steps", [(False, None), (False, 7),
                                              (True, 7)])
def test_kernel_matches_plain_on_card(deep, wide, chunk_steps):
    """K3 against its twin over compressed anchors, every state array:
    from the handoff and the wrap handoff, int32 or int64 positions, in
    one launch or in live-pixel launches of 7 steps."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    ptz, res, la, base, wrap = deep
    comp = CompressedOrbit.from_uncompressed(res, error_exp=8)
    z_mr = ps.wrap_value(comp, res.max_ref_iteration())
    got = {}
    for dev in ("cuda", "cpu"):
        A = anchor_table(comp, torch.device(dev), wide=wide)
        dc = perturb._dc_grids_hdr(*perturb.delta_params(
            ptz, res.center_x, res.center_y, SIZE, SIZE), SIZE, SIZE, dev)
        for name, init in (("base", base), ("wrap", wrap)):
            init = {k: torch.as_tensor(v) for k, v in init.items()}
            got[dev, name] = ps.rc_tail_run(A, dc, init, N, z_mr,
                                            chunk_steps).cpu()
    for name in ("base", "wrap"):
        assert torch.equal(got["cuda", name], got["cpu", name]), name


@pytest.mark.cuda
def test_queue_form_matches_plain_on_card():
    """More pixels than the card holds lanes: K3's work-queue form
    against its twin, from K2's la_only handoff on the 1e8 frame at
    1024²."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    h = ref.host_layer("fractalshark_tpu_torch")
    size = 1024
    ptz = h.PointZoomBBConverter(
        pt_x="-0.743643887037158704752191506114774",
        pt_y="0.131825904205311970493132056385139",
        zoom_factor="1e8", prec=512).square_aspect_ratio(size, size)
    res = h.RefOrbitCalc().get_and_create_useful_results(ptz, 2000)
    la = h.LAReferenceHost.generate(res.orbit_x, res.orbit_y,
                                    h.HD.from_hp(res.max_radius))
    dev = torch.device("cuda")
    st = la_kernel.la_perturb_render(res, la, ptz, size, size, N,
                                     la_only=True, return_state=True,
                                     device=dev)
    init = {"dzr": st[3], "dzi": st[4], "dze": st[5], "it": st[6],
            "jwait": st[2], "done": st[6] >= N}
    comp = CompressedOrbit.from_uncompressed(res, error_exp=8)
    A = anchor_table(comp, dev)
    z_mr = ps.wrap_value(comp, A.max_ref)
    dc = perturb._dc_grids_hdr(*perturb.delta_params(
        ptz, res.center_x, res.center_y, size, size), size, size, dev)
    got = ps.rc_tail_run(A, dc, init, N, z_mr)
    flat = HDRComplex(*(t.reshape(-1) for t in dc))
    want = ps.rc_tail_plain(A, flat, ps.rc_init_plain(
        A, ps.handoff_state(A, init, dev), N, z_mr))
    assert torch.equal(got, want[3])
