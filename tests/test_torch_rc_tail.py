"""K3's plain twin (``fractalshark_tpu_torch/ops/perturb_stream.py``)
against the JAX package's RC streaming tail
``perturb_render_stream_rc`` (Pallas, interpret mode), bit for bit:
the two-phase handoff over identity anchors and over compressed anchors
(``error_exp=8``), and handoffs at ``jwait == max_ref`` (the wrap
rebase).  Then the gather tail (``ops/rc_tail.py``): K19's twin (f64)
and its df32 mode (K3) against the JAX package's ``rc_tail_gather`` and
``two_phase_render(tail=...)``, the cases of ``tests/test_rc_tail.py``.
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
from fractalshark_tpu_torch.ops import rc_tail
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


# ---------------------------------------------------------------------------
# The gather tail (ops/rc_tail.py): K19's twin (f64) and K3 as its df32
# mode, on the reference's own fixture (tests/test_rc_tail.py: a 1e13
# orbit cut to 2,048 positions, a budget that wraps it, the native RC LA
# table), against the JAX package's rc_tail_gather and two_phase_render.

# (the orbit escapes at 999 entries: the budget wraps it three times, the
# small budget just past once)
G_SIZE, G_BUDGET, G_LEN, G_SMALL = 16, 3000, 2048, 1100
# the orbit with a last gap past 2^31 (the ADVICE fault of the df32
# mode's i32 gapW): positions 0..G_LEN-1 and G_FAR..G_FAR+G_TOP-1
G_FAR, G_TOP, G_FAR_BUDGET = (1 << 31) + 7, 64, 100


def _mini(pkg="fractalshark_tpu_torch"):
    """(ptz, truncated results, decompressed results, comp, la, the
    package's CompressedOrbit) of ``tests/test_rc_tail.py``'s fixture."""
    import importlib
    h = ref.host_layer(pkg)
    PR = importlib.import_module(f"{pkg}.engine.perturbation_results")
    NL = importlib.import_module(f"{pkg}.engine.native_la")
    LP = importlib.import_module(f"{pkg}.engine.la_reference").LAParameters
    ptz = h.PointZoomBBConverter(
        pt_x="-0.743643887037158704752191506114774",
        pt_y="0.131825904205311970493132056385139",
        zoom_factor="1e13", prec=512).square_aspect_ratio(G_SIZE, G_SIZE)
    res = h.RefOrbitCalc().get_and_create_useful_results(ptz, 50_000)

    def results(x, y):
        return PR.PerturbationResults(
            center_x=res.center_x, center_y=res.center_y, orbit_x=x,
            orbit_y=y, max_radius=res.max_radius, period=0, escaped_at=0,
            max_iterations=G_LEN, precision_bits=res.precision_bits)

    res_t = results(res.orbit_x[:G_LEN], res.orbit_y[:G_LEN])
    comp = PR.CompressedOrbit.from_uncompressed(res_t, error_exp=20)
    la = NL.generate_native_rc(comp, h.HD.from_hp(res_t.max_radius),
                               params=LP(period_divisor=8, low_bound=1))
    assert la is not None and la.is_valid
    return ptz, res_t, results(*comp.decompress()), comp, la, \
        PR.CompressedOrbit


def _far_orbit(C, res_t):
    """Every entry of the truncated orbit an anchor, then G_TOP
    anchors (its first values again) from G_FAR: the last gap is past
    2^31, and no pixel of the far handoff below reconstructs a value."""
    x, y = res_t.orbit_plain()
    return C(np.concatenate([x, x[:G_TOP]]), np.concatenate([y, y[:G_TOP]]),
             np.concatenate([np.arange(len(x)), G_FAR + np.arange(G_TOP)]),
             G_FAR + G_TOP, float(res_t.center_x), float(res_t.center_y), 0)


def _far_handoff(init):
    """A handoff in the far block: jwait G_FAR + (pixel mod 10), nothing
    done yet, the handed-over dz kept."""
    k = np.arange(G_SIZE * G_SIZE).reshape(G_SIZE, G_SIZE)
    return {"dzr": np.asarray(init["dzr"]), "dzi": np.asarray(init["dzi"]),
            "dze": np.asarray(init["dze"]),
            "it": np.zeros(k.shape, np.int64),
            "jwait": (G_FAR + k % 10).astype(np.int64),
            "done": np.zeros(k.shape, np.int32)}


def _gather_reference(_inputs):
    from fractalshark_tpu.engine import renderers as R
    from fractalshark_tpu.ops import la_kernel as jla
    from fractalshark_tpu.ops.rc_tail import rc_tail_gather

    ptz, res_t, res_rc, comp, la, C = _mini("fractalshark_tpu")

    def handoff(budget):
        s = jla.la_perturb_render(res_rc, la, ptz, G_SIZE, G_SIZE, budget,
                                  sub_dtype=np.float32, la_only=True,
                                  return_state=True)
        it = np.asarray(s[6]).astype(np.int64)
        return {"dzr": np.asarray(s[3]), "dzi": np.asarray(s[4]),
                "dze": np.asarray(s[5]), "it": it,
                "jwait": np.asarray(s[2]).astype(np.int64),
                "done": (it >= budget).astype(np.int32)}

    def gather(c, init, budget=G_BUDGET, mode=None):
        return np.asarray(rc_tail_gather(
            c, res_t.center_x, res_t.center_y, ptz, G_SIZE, G_SIZE, budget,
            init_state=dict(init), mode=mode))

    def two_phase(**kw):
        return np.asarray(R.two_phase_render(res_rc, la, ptz, G_SIZE, G_SIZE,
                                             G_BUDGET, **kw))

    init = handoff(G_BUDGET)
    ident = C.identity(res_t)
    out = {"full": np.asarray(jla.la_perturb_render(
        res_rc, la, ptz, G_SIZE, G_SIZE, G_BUDGET, sub_dtype=np.float32)),
        "f64": gather(comp, init), "df32": gather(comp, init, mode="df32"),
        "ident_f64": gather(ident, init),
        "ident_df32": gather(ident, init, mode="df32"),
        "small": gather(comp, handoff(G_SMALL), G_SMALL),
        "far": gather(_far_orbit(C, res_t), _far_handoff(init),
                      G_FAR_BUDGET),
        "two_phase_gather": two_phase(comp=comp, tail="gather"),
        "two_phase_identity": two_phase(tail="gather")}
    R._GATHER_TAIL_MIN_ORBIT = int(comp.total_count)
    out["two_phase_auto"] = two_phase(comp=comp)
    return out


@pytest.fixture(scope="module")
def gather_ref(tmp_path_factory):
    return ref.run_jax_reference("test_torch_rc_tail", "_gather_reference",
                                 tmp_path_factory.mktemp("rc_gather"))


@pytest.fixture(scope="module")
def mini():
    ptz, res_t, res_rc, comp, la, _ = _mini()

    def handoff(budget):
        s = la_kernel.la_perturb_render(res_rc, la, ptz, G_SIZE, G_SIZE,
                                        budget, la_only=True,
                                        return_state=True, device="cpu")
        return {"dzr": s[3], "dzi": s[4], "dze": s[5], "it": s[6],
                "jwait": s[2], "done": s[6] >= budget}

    return types.SimpleNamespace(ptz=ptz, res_t=res_t, res_rc=res_rc,
                                 comp=comp, la=la, handoff=handoff,
                                 init=handoff(G_BUDGET))


def _gather(mini, comp, init=None, budget=G_BUDGET, **kw):
    return rc_tail.rc_tail_gather(
        comp, mini.res_t.center_x, mini.res_t.center_y, mini.ptz, G_SIZE,
        G_SIZE, budget, dict(mini.init if init is None else init),
        device="cpu", **kw).numpy()


@pytest.fixture(scope="module")
def gather_f64(mini):
    return _gather(mini, mini.comp)


def test_gather_tail_matches_one_kernel_machine(mini, gather_ref,
                                                gather_f64):
    """``tests/test_rc_tail.py:74``: the f64 gather tail (K19's twin)
    after the LA phase equals the one-kernel LAv2 machine on the
    decompressed orbit, and the JAX gather, bit for bit; the tail wraps
    the orbit."""
    np.testing.assert_array_equal(gather_f64,
                                  gather_ref["full"].astype(np.int64))
    np.testing.assert_array_equal(gather_f64,
                                  gather_ref["f64"].astype(np.int64))
    assert gather_f64.max() >= 2 * mini.comp.total_count


def test_gather_tail_matches_sweep_on_identity_anchors(mini, gather_ref):
    """``:92``: over identity anchors the f64 gather equals the sweep
    (K3's twin) and the JAX gather."""
    ident = CompressedOrbit.identity(mini.res_t)
    f64 = _gather(mini, ident)
    sweep = _rc_mini(mini, ident)
    np.testing.assert_array_equal(f64, sweep)
    np.testing.assert_array_equal(f64,
                                  gather_ref["ident_f64"].astype(np.int64))


def _rc_mini(mini, comp):
    return ps.perturb_render_stream_rc(
        comp, mini.res_t.center_x, mini.res_t.center_y, mini.ptz, G_SIZE,
        G_SIZE, G_BUDGET, init_state=dict(mini.init), device="cpu").numpy()


def test_two_phase_render_gather_tail_plumbing(mini, gather_ref):
    """``:111``: two_phase_render(tail="gather") takes the gather tail and
    equals the one-kernel machine and the JAX render."""
    timings = {}
    got = two_phase_render(mini.res_rc, mini.la, mini.ptz, G_SIZE, G_SIZE,
                           G_BUDGET, comp=mini.comp, device="cpu",
                           timings=timings, tail="gather").numpy()
    assert timings["tail"] == "gather"
    np.testing.assert_array_equal(got, gather_ref["full"].astype(np.int64))
    np.testing.assert_array_equal(
        got, gather_ref["two_phase_gather"].astype(np.int64))


def test_df32_tail_matches_sweep_on_real_compression(mini, gather_ref,
                                                     gather_f64):
    """``:126``: the df32 mode is K3, the sweep's reconstruction; it
    equals the JAX df32 gather.  Against the f64 mode it may flip last-ulp
    counts (``rc_tail.py:41-44``): the flips are counted, and there are
    few."""
    df32 = _gather(mini, mini.comp, mode="df32")
    np.testing.assert_array_equal(df32, gather_ref["df32"].astype(np.int64))
    assert int((df32 != gather_f64).sum()) <= G_SIZE * G_SIZE // 8


def test_df32_tail_matches_f64_on_identity_anchors(mini, gather_ref):
    """``:146``: over identity anchors both modes read exact values."""
    ident = CompressedOrbit.identity(mini.res_t)
    df32 = _gather(mini, ident, mode="df32")
    np.testing.assert_array_equal(df32,
                                  gather_ref["ident_df32"].astype(np.int64))
    np.testing.assert_array_equal(df32,
                                  gather_ref["ident_f64"].astype(np.int64))


def test_gather_tail_budget_exhaustion(mini, gather_ref):
    """``:162``: pixels that exhaust the budget report exactly max_iter."""
    out = _gather(mini, mini.comp, mini.handoff(G_SMALL), G_SMALL)
    np.testing.assert_array_equal(out, gather_ref["small"].astype(np.int64))
    assert out.max() == G_SMALL and out.min() > 0


def test_auto_tail_takes_the_gather_from_its_length(mini, gather_ref,
                                                    monkeypatch):
    """C6: with the length threshold below the orbit's, tail="auto" takes
    the gather (K19's twin), as the JAX render does with the same patch;
    the threshold is the reference's."""
    from fractalshark_tpu_torch.engine import renderers as R
    assert R._GATHER_TAIL_MIN_ORBIT == 64_000_000
    assert R.tail_route("auto", 63_999_999, True) == "sweep"
    assert R.tail_route("auto", 64_000_000, True) == "gather"
    monkeypatch.setattr(R, "_GATHER_TAIL_MIN_ORBIT",
                        int(mini.comp.total_count))
    timings = {}
    got = R.two_phase_render(mini.res_rc, mini.la, mini.ptz, G_SIZE, G_SIZE,
                             G_BUDGET, comp=mini.comp, device="cpu",
                             timings=timings).numpy()
    assert timings["tail"] == "gather"
    np.testing.assert_array_equal(
        got, gather_ref["two_phase_auto"].astype(np.int64))


def test_identity_gather_is_k6_resumed(mini, gather_ref):
    """Over an uncompressed orbit the reference gathers over identity
    anchors; the port's tail there is K6 resumed, which gives the JAX
    gather's grid."""
    timings = {}
    got = two_phase_render(mini.res_rc, mini.la, mini.ptz, G_SIZE, G_SIZE,
                           G_BUDGET, device="cpu", timings=timings,
                           tail="gather").numpy()
    assert timings["tail"] == "identity"
    np.testing.assert_array_equal(
        got, gather_ref["two_phase_identity"].astype(np.int64))


def test_far_last_gap_takes_int64_positions(mini, gather_ref):
    """ADVICE (the df32 mode's unasserted i32 gap, ``rc_tail.py:413``):
    over an orbit whose last gap is past 2^31, both modes run with int64
    positions and give the JAX f64 gather's grid, the wrap at max_ref
    included; the JAX package's df32 mode refuses this orbit."""
    far = _far_orbit(CompressedOrbit, mini.res_t)
    assert anchor_table(far, torch.device("cpu")).index.dtype == torch.int64
    init = {k: torch.as_tensor(v) for k, v in _far_handoff(mini.init).items()}
    want = gather_ref["far"].astype(np.int64)
    for mode in ("f64", "df32"):
        got = _gather(mini, far, init, G_FAR_BUDGET, mode=mode)
        np.testing.assert_array_equal(got, want)
    assert want.max() == G_FAR_BUDGET   # some pixels wrapped and went on


def test_gather_refusals(mini, monkeypatch):
    """ADVICE: zero anchors raise (the reference returned None), an
    unknown mode raises, and FRACTALSHARK_RC_TAIL takes auto, sweep or
    gather only (the reference took a typo as the sweep)."""
    from fractalshark_tpu_torch.engine import renderers as R
    empty = CompressedOrbit(np.zeros(0), np.zeros(0), np.zeros(0, np.int64),
                            10, 0.0, 0.0, 0)
    with pytest.raises(ValueError, match="no anchors"):
        _gather(mini, empty)
    with pytest.raises(ValueError, match="mode"):
        _gather(mini, mini.comp, mode="f32")
    monkeypatch.setenv(R.RC_TAIL_ENV, "gathr")
    with pytest.raises(ValueError, match="FRACTALSHARK_RC_TAIL"):
        two_phase_render(mini.res_rc, mini.la, mini.ptz, G_SIZE, G_SIZE,
                         G_BUDGET, comp=mini.comp, device="cpu")
    with pytest.raises(ValueError, match="FRACTALSHARK_RC_TAIL"):
        R.tail_route("sweep", G_LEN, False)


@pytest.mark.cuda
@pytest.mark.parametrize("chunk_steps", [None, 7])
def test_k19_matches_plain_on_card(mini, chunk_steps):
    """K19 against its twin in one lockstep run (``rc_tail_gather_plain``),
    over the real compressed orbit from the LA handoff and over the far
    orbit from the far handoff, in one launch or in live-pixel launches
    of 7 steps; no K3 launch."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from fractalshark_tpu_torch import kernels
    far = _far_orbit(CompressedOrbit, mini.res_t)
    for comp, init, budget in (
            (mini.comp, mini.init, G_BUDGET),
            (far, {k: torch.as_tensor(v) for k, v in
                   _far_handoff(mini.init).items()}, G_FAR_BUDGET)):
        z_mr = ps.wrap_value(comp, int(comp.total_count) - 1)
        got = {}
        for dev in ("cuda", "cpu"):
            A = ps.anchors_on(comp, torch.device(dev), f64=True)
            dc = perturb._dc_grids_hdr(*perturb.delta_params(
                mini.ptz, mini.res_t.center_x, mini.res_t.center_y, G_SIZE,
                G_SIZE), G_SIZE, G_SIZE, dev)
            kernels.reset_counts()
            if dev == "cuda":
                got[dev] = ps.rc_tail_run(A, dc, dict(init), budget, z_mr,
                                          chunk_steps).cpu()
                assert kernels.launches["rc_tail_f64"] >= 1
                assert kernels.launches["rc_tail"] == 0
            else:
                got[dev] = rc_tail.rc_tail_gather_plain(A, dc, dict(init),
                                                        budget, z_mr)
        assert torch.equal(got["cuda"], got["cpu"])
