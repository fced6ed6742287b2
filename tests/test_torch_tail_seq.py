"""The two-phase tail over an uncompressed orbit, on View #6: the
reference runs it as its RC kernel over identity anchors (B3,
``_rc_kernel``); the port runs K6's HDR-f32 step resumed from the
handoff (``perturb.handoff_state``, ``perturb.perturb_run``).  From K2's
``la_only`` handoff at 32² and 64², K3's plain twin over identity
anchors, K6's plain twin resumed (in one lockstep run and in live-pixel
launches) and the JAX package's sweep (interpret mode, FMA off) give
the same state bit for bit and the same grid, and the route
(``two_phase_render``) gives it too.  The ``cuda`` test holds K6 on the
route to its twin.
"""

import types

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
from fractalshark_tpu_torch.ops.tables import orbit_on

SIZES = (32, 64)
# View #6, JAX package on the CPU with FMA contraction off (the full
# LAv2 render's iter_sum at these sizes, tests/test_torch_lav2.py and
# chip_smoke.py)
VIEW6_SUM = {32: 817_235_786, 64: 3_268_937_305}


def _view6(size, pkg="fractalshark_tpu_torch"):
    h = ref.host_layer(pkg)
    v = h.get_view_preset(6)
    ptz = v.ptz.square_aspect_ratio(size, size)
    res = h.RefOrbitCalc().get_and_create_useful_results(ptz,
                                                         v.num_iterations)
    la = h.get_or_build_la(types.SimpleNamespace(la_parameters=None), res)
    return ptz, res, la, v.num_iterations


def _handoff(state, n) -> dict:
    """The phase-1 state as the tail's handoff dict (numpy)."""
    _, _, ref_iter, dzr, dzi, dze, it, _ = (np.asarray(a) for a in state)
    it = it.astype(np.int64)
    return {"dzr": dzr, "dzi": dzi, "dze": dze, "it": it,
            "jwait": ref_iter.astype(np.int64),
            "done": (it >= n).astype(np.int32)}


def _jax_reference(_inputs):
    from fractalshark_tpu.engine.perturbation_results import CompressedOrbit
    from fractalshark_tpu.ops import la_kernel as jla
    from fractalshark_tpu.ops.perturb_stream import perturb_render_stream_rc

    out = {}
    for size in SIZES:
        ptz, res, la, n = _view6(size, "fractalshark_tpu")
        state = jla.la_perturb_render(res, la, ptz, size, size, n,
                                      sub_dtype=np.float32, la_only=True,
                                      return_state=True)
        out[f"rc{size}"] = np.asarray(perturb_render_stream_rc(
            CompressedOrbit.identity(res), res.center_x, res.center_y, ptz,
            size, size, n, tile_h=size, interpret=True,
            init_state=_handoff(state, n)))
    return out


@pytest.fixture(scope="module")
def jax_ref(tmp_path_factory):
    return ref.run_jax_reference("test_torch_tail_seq", "_jax_reference",
                                 tmp_path_factory.mktemp("tail_seq"))


@pytest.fixture(scope="module", params=SIZES, ids=lambda s: f"{s}px")
def view6(request):
    size = request.param
    ptz, res, la, n = _view6(size)
    state = la_kernel.la_perturb_render(res, la, ptz, size, size, n,
                                        la_only=True, return_state=True,
                                        device="cpu")
    init = {k: torch.as_tensor(v) for k, v in _handoff(state, n).items()}
    return types.SimpleNamespace(size=size, ptz=ptz, res=res, la=la, n=n,
                                 init=init)


def _dc(v, device="cpu"):
    return perturb._dc_grids_hdr(*perturb.delta_params(
        v.ptz, v.res.center_x, v.res.center_y, v.size, v.size), v.size,
        v.size, device)


def test_identity_tail_is_k6_resumed(jax_ref, view6):
    """K3's twin over identity anchors and K6's twin resumed from the
    handoff: every state array equal, bit for bit; the grid equals the
    JAX RC kernel's and the full LAv2 render's iter_sum."""
    v = view6
    comp = CompressedOrbit.identity(v.res)
    A = ps.anchors_on(comp, torch.device("cpu"))
    flat = HDRComplex(*(t.reshape(-1) for t in _dc(v)))
    dzr, dzi, dze, rem, pos, _, _, done = ps.rc_tail_plain(
        A, flat, ps.rc_init_plain(A, ps.handoff_state(A, v.init, "cpu"),
                                  v.n, ps.wrap_value(comp, A.max_ref)))
    orbit = orbit_on(v.res, torch.device("cpu"))
    mr = v.res.max_ref_iteration()
    k6 = perturb.perturb_plain(orbit, flat, perturb.handoff_plain(
        orbit, perturb.handoff_state(v.init, "cpu"), v.n, mr), v.n, mr,
        True)
    for a, b, name in zip((dzr, dzi, dze, pos, v.n - rem, done), k6,
                          perturb._STATE):
        assert torch.equal(a.to(b.dtype), b), name
    want = jax_ref[f"rc{v.size}"].astype(np.int64)
    np.testing.assert_array_equal(k6[4].reshape(v.size, v.size).numpy(),
                                  want)
    assert int(want.sum()) == VIEW6_SUM[v.size]


@pytest.mark.parametrize("chunk_steps", [None, 7])
def test_route_runs_k6_in_live_pixel_launches(jax_ref, view6, monkeypatch,
                                              chunk_steps):
    """``two_phase_render`` over the uncompressed orbit: the handoff,
    then K6's twin over the pixels still live (in launches of 7 steps,
    or one), and no identity anchors or anchor table built; the JAX
    grid."""
    v = view6

    def refuse(*_a, **_k):
        raise AssertionError("an anchor table on the identity route")

    monkeypatch.setattr(CompressedOrbit, "identity", refuse)
    monkeypatch.setattr(ps, "anchor_table", refuse)
    got = two_phase_render(v.res, v.la, v.ptz, v.size, v.size, v.n,
                           device="cpu", chunk_steps=chunk_steps)
    np.testing.assert_array_equal(got.numpy(),
                                  jax_ref[f"rc{v.size}"].astype(np.int64))
    # the first launch runs every pixel, the others the live ones
    work = perturb.last_run_stats["work"]
    assert work[0] == v.size ** 2
    assert all(b <= a for a, b in zip(work, work[1:]))
    if chunk_steps:
        assert len(work) > 2 and work[-1] < work[0]


@pytest.mark.cuda
def test_identity_tail_kernel_matches_plain_on_card(view6):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    v = view6
    dev = torch.device("cuda")
    orbit = orbit_on(v.res, dev)
    mr = v.res.max_ref_iteration()
    flat = HDRComplex(*(t.reshape(-1) for t in _dc(v, dev)))
    pl = perturb.perturb_plain(orbit, flat, perturb.handoff_plain(
        orbit, perturb.handoff_state(v.init, dev), v.n, mr), v.n, mr, True)
    for chunk in (None, 7):
        st = perturb.handoff_state(v.init, dev)
        k = perturb.perturb_run(orbit, _dc(v, dev), v.n, mr, True,
                                "two_phase_tail", chunk, state=st,
                                handoff=True)
        for a, b, name in zip(st, pl, perturb._STATE):
            assert torch.equal(a, b), name
        assert torch.equal(k.reshape(-1), pl[4])
