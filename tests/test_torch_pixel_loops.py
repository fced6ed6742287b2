"""The per-pixel loops K6 (``ops/perturb.py``, ``csrc/perturb.cu``) and K2
(``ops/la_kernel.py``, ``csrc/lav2.cu``) as their run loops drive them:
each launch over the pixels the last one left live (``live_pixels``),
chunked and resumed.  On the CPU the plain twins run those subsets:
chunked, compacted and reordered runs give the state and grid of one
lockstep run, and equal the JAX package (FMA off) for each of K6's four
forms and K2's four modes, on the 1e8 frame and on View #6 at a cut
budget; K2's two phases, as its run loop splits them past the card's
lanes.  The wrappers refuse work lists the kernels cannot take.  The
``cuda`` tests hold each kernel to its twin, from edge states too, and
K2's lane count and its refusal of a stage table past its shared memory.
"""

import numpy as np
import pytest
import torch

import test_torch_jaxref as ref
from fractalshark_tpu_torch.ops import la_kernel, perturb
from fractalshark_tpu_torch.ops.hdrfloat import HDRComplex

SIZE, BUDGET = 16, 2000
LA_SIZE = 32
V6_SIZE, V6_BUDGET = 16, 3000
# a chunk that ends launches mid-flight, pixels escaping inside them
CHUNK = 97
K6_FORMS = [("hdr", torch.float32), ("hdr", torch.float64),
            ("float", torch.float32), ("float", torch.float64)]
K2_MODES = [(torch.float32, False), (torch.float32, True),
            (torch.float64, False), (torch.float64, True)]


def _ids(forms):
    return [f"{a}-{str(b).split('.')[-1]}" for a, b in forms]


def _deep(pkg="fractalshark_tpu_torch", size=SIZE):
    h = ref.host_layer(pkg)
    ptz = h.PointZoomBBConverter(
        pt_x="-0.743643887037158704752191506114774",
        pt_y="0.131825904205311970493132056385139",
        zoom_factor="1e8", prec=512).square_aspect_ratio(size, size)
    res = h.RefOrbitCalc().get_and_create_useful_results(ptz, BUDGET)
    la = h.LAReferenceHost.generate(res.orbit_x, res.orbit_y,
                                    h.HD.from_hp(res.max_radius))
    return ptz, res, la


def _view6(pkg="fractalshark_tpu_torch"):
    h = ref.host_layer(pkg)
    p = h.get_view_preset(6)
    ptz = p.ptz.square_aspect_ratio(V6_SIZE, V6_SIZE)
    return ptz, h.RefOrbitCalc().get_and_create_useful_results(
        ptz, p.num_iterations)


def _jax_reference(_inputs):
    from fractalshark_tpu.ops import la_kernel as jla
    from fractalshark_tpu.ops import perturb as jp

    out = {}
    ptz, res, _ = _deep("fractalshark_tpu")
    for dt in (np.float32, np.float64):
        name = np.dtype(dt).name
        out["hdr-" + name] = np.asarray(jp.perturb_render_hdr(
            res, ptz, SIZE, SIZE, BUDGET, sub_dtype=dt))
        out["float-" + name] = np.asarray(jp.perturb_render_float(
            res, ptz, SIZE, SIZE, BUDGET, dtype=dt))
    ptz, res, la = _deep("fractalshark_tpu", LA_SIZE)
    for dt in (np.float32, np.float64):
        name = np.dtype(dt).name
        out["full-" + name] = np.asarray(jla.la_perturb_render(
            res, la, ptz, LA_SIZE, LA_SIZE, BUDGET, sub_dtype=dt))
        st = jla.la_perturb_render(res, la, ptz, LA_SIZE, LA_SIZE, BUDGET,
                                   sub_dtype=dt, la_only=True,
                                   return_state=True)
        for k, a in zip(la_kernel._STATE, st):
            out[f"lao-{name}-{k}"] = np.asarray(a)
    ptz, res = _view6("fractalshark_tpu")
    out["v6"] = np.asarray(jp.perturb_render_hdr(
        res, ptz, V6_SIZE, V6_SIZE, V6_BUDGET, sub_dtype=np.float32))
    return out


@pytest.fixture(scope="module")
def jax_ref(tmp_path_factory):
    return ref.run_jax_reference("test_torch_pixel_loops", "_jax_reference",
                                 tmp_path_factory.mktemp("pixel_loops"))


@pytest.fixture(scope="module")
def deep():
    return _deep()


@pytest.fixture(scope="module")
def deep_la():
    return _deep(size=LA_SIZE)


def _k6_inputs(ptz, res, size, form, dtype, device="cpu"):
    from fractalshark_tpu_torch.ops.tables import orbit_on
    orbit = orbit_on(res, torch.device(device), dtype)
    grids = perturb._dc_grids_hdr if form == "hdr" else \
        perturb._dc_grids_float
    dc = grids(*perturb.delta_params(ptz, res.center_x, res.center_y, size,
                                     size), size, size, device, dtype)
    return orbit, HDRComplex(*(t.reshape(-1) for t in dc))


def _k2_inputs(ptz, res, la, dtype, device="cpu"):
    T, orbit = la_kernel.device_tables(res, la, torch.device(device), dtype)
    dc = perturb._dc_grids_hdr(*perturb.delta_params(
        ptz, res.center_x, res.center_y, LA_SIZE, LA_SIZE), LA_SIZE, LA_SIZE,
        device, dtype)
    return T, orbit, HDRComplex(*(t.reshape(-1) for t in dc))


def _k6_lockstep(orbit, flat, res, n, form):
    hdr_mode = form == "hdr"
    return perturb.perturb_plain(orbit, flat, perturb.init_state_plain(
        flat, n, hdr_mode), n, res.max_ref_iteration(), hdr_mode)


def _k2_lockstep(T, orbit, flat, res, la_only):
    return la_kernel.lav2_plain(T, orbit, flat, la_kernel.init_state_plain(
        T, flat, BUDGET), BUDGET, res.max_ref_iteration(), la_only)


def _same(a: tuple, b: tuple):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert torch.equal(x.reshape(-1), y.reshape(-1))


# ------------------------------------------------------------ CPU: subsets


@pytest.mark.parametrize("form,dtype", K6_FORMS, ids=_ids(K6_FORMS))
def test_k6_compacted_chunks_equal_lockstep(deep, form, dtype):
    """The run loop's launches over the live pixels, CHUNK steps each,
    give the grid of one lockstep run, and every launch after the first
    ran fewer pixels than the one before it or as many."""
    ptz, res, _ = deep
    orbit, flat = _k6_inputs(ptz, res, SIZE, form, dtype)
    want = _k6_lockstep(orbit, flat, res, BUDGET, form)
    got = perturb.perturb_run(orbit, flat, BUDGET, res.max_ref_iteration(),
                              form == "hdr", "perturb_hdr32",
                              chunk_steps=CHUNK)
    assert torch.equal(got, want[4])
    work = perturb.last_run_stats["work"]
    assert work[0] == SIZE * SIZE and len(work) > 2
    assert all(b <= a for a, b in zip(work, work[1:])) and work[-1] < work[0]


@pytest.mark.parametrize("form,dtype", K6_FORMS, ids=_ids(K6_FORMS))
def test_k6_reordered_subsets_equal_lockstep(deep, form, dtype):
    """Launches over the live pixels in a shuffled order, resumed from
    each other's state, give the lockstep run's state, every array."""
    ptz, res, _ = deep
    orbit, flat = _k6_inputs(ptz, res, SIZE, form, dtype)
    hdr_mode = form == "hdr"
    mr = res.max_ref_iteration()
    want = _k6_lockstep(orbit, flat, res, BUDGET, form)
    rng = np.random.default_rng(8)
    state = perturb.init_state_plain(flat, BUDGET, hdr_mode)
    while True:
        live = perturb.live_pixels(state[-1])
        if live.numel() == 0:
            break
        work = live[torch.from_numpy(rng.permutation(live.numel()))]
        state = perturb.on_subset(
            lambda st, d: perturb.perturb_plain(orbit, d, st, BUDGET, mr,
                                                hdr_mode, CHUNK),
            state, flat, work)
    _same(state, want)


def test_k6_one_step_launches_equal_lockstep(deep):
    """Every launch one step long: each resumes mid-orbit, after rebases
    and at the pixels' last steps."""
    ptz, res, _ = deep
    orbit, flat = _k6_inputs(ptz, res, SIZE, "hdr", torch.float32)
    n = 300
    want = _k6_lockstep(orbit, flat, res, n, "hdr")
    got = perturb.perturb_run(orbit, flat, n, res.max_ref_iteration(), True,
                              "perturb_hdr32", chunk_steps=1)
    assert perturb.last_run_stats["dispatches"] == n
    assert torch.equal(got, want[4])


@pytest.mark.parametrize("dtype,la_only", K2_MODES, ids=[
    f"{str(d).split('.')[-1]}-{'la_only' if o else 'full'}"
    for d, o in K2_MODES])
def test_k2_compacted_chunks_equal_lockstep(deep_la, dtype, la_only):
    """K2's run loop, chunked and compacted, gives the lockstep run's
    state, every array."""
    ptz, res, la = deep_la
    T, orbit, flat = _k2_inputs(ptz, res, la, dtype)
    want = _k2_lockstep(T, orbit, flat, res, la_only)
    got = la_kernel.lav2_run(T, orbit, flat, BUDGET, res.max_ref_iteration(),
                             la_only, chunk_steps=1 if la_only else CHUNK)
    _same(got, want)
    work = la_kernel.last_run_stats["work"]
    assert len(work) > 1 and work[-1] < work[0]


@pytest.mark.parametrize("dtype,la_only", K2_MODES, ids=[
    f"{str(d).split('.')[-1]}-{'la_only' if o else 'full'}"
    for d, o in K2_MODES])
def test_k2_reordered_subsets_equal_lockstep(deep_la, dtype, la_only):
    """Launches over K2's live pixels in a shuffled order, resumed from
    each other's state, give the lockstep run's state, every array."""
    ptz, res, la = deep_la
    T, orbit, flat = _k2_inputs(ptz, res, la, dtype)
    mr = res.max_ref_iteration()
    want = _k2_lockstep(T, orbit, flat, res, la_only)
    rng = np.random.default_rng(2)
    state = la_kernel.init_state_plain(T, flat, BUDGET)
    while True:
        live = perturb.live_pixels(state[-1])
        if live.numel() == 0:
            break
        work = live[torch.from_numpy(rng.permutation(live.numel()))]
        state = perturb.on_subset(
            lambda st, d: la_kernel.lav2_plain(T, orbit, d, st, BUDGET, mr,
                                               la_only, 11),
            state, flat, work)
    _same(state, want)


@pytest.mark.parametrize("kernel", ["k6", "k2"])
def test_subset_leaves_the_other_pixels(deep_la, kernel):
    """A launch over some of the pixels leaves the others as they are and
    steps its own as a run over them alone does."""
    ptz, res, la = deep_la
    mr = res.max_ref_iteration()
    if kernel == "k6":
        orbit, flat = _k6_inputs(ptz, res, LA_SIZE, "hdr", torch.float32)
        state = perturb.init_state_plain(flat, BUDGET, True)

        def step(st, d):
            return perturb.perturb_plain(orbit, d, st, BUDGET, mr, True, 50)
    else:
        T, orbit, flat = _k2_inputs(ptz, res, la, torch.float32)
        state = la_kernel.init_state_plain(T, flat, BUDGET)

        def step(st, d):
            return la_kernel.lav2_plain(T, orbit, d, st, BUDGET, mr, False,
                                        50)
    work = torch.arange(0, flat.re.numel(), 3, dtype=torch.int32)
    got = perturb.on_subset(step, state, flat, work)
    alone = step(tuple(t[work.long()] for t in state),
                 HDRComplex(*(t[work.long()] for t in flat)))
    rest = torch.ones(flat.re.numel(), dtype=torch.bool)
    rest[work.long()] = False
    for a, b, c in zip(got, state, alone):
        assert torch.equal(a[rest], b[rest])
        assert torch.equal(a[work.long()], c)
    assert not torch.equal(got[-2], state[-2])


def test_k2_reordered_phases_equal_lockstep(deep_la):
    """K2's launches as the run loop plans them (the LA phase of every
    pixel in the LA stages, then the tail phase), each over its pixels in
    a shuffled order, give the lockstep run's state; every LA launch
    precedes every tail launch."""
    ptz, res, la = deep_la
    T, orbit, flat = _k2_inputs(ptz, res, la, torch.float32)
    mr = res.max_ref_iteration()
    want = _k2_lockstep(T, orbit, flat, res, False)
    rng = np.random.default_rng(2)
    state = la_kernel.init_state_plain(T, flat, BUDGET)
    work, phase, phases = None, "la", []
    while work is not None or not phases:
        phases.append(phase)
        if work is not None:
            work = work[torch.from_numpy(rng.permutation(work.numel()))]
        state = perturb.on_subset(
            lambda st, d: la_kernel.lav2_plain(T, orbit, d, st, BUDGET, mr,
                                               False, 11, phase),
            state, flat, work)
        work, phase = la_kernel.next_work(state, True)
    _same(state, want)
    n_la = phases.count("la")
    assert n_la and phases[:n_la] == ["la"] * n_la and \
        phases[n_la:] == ["tail"] * (len(phases) - n_la)


@pytest.mark.parametrize("n_pixels,lanes,split", [
    (65536, 118272, False), (118272, 118272, False), (1 << 20, 118272, True)])
def test_k2_splits_phases_past_the_lanes(n_pixels, lanes, split):
    """K2's phases run apart only when the pixels outnumber the lanes."""
    assert la_kernel.split_phases(n_pixels, lanes) == split


@pytest.mark.parametrize("phase", ["la", "tail"])
def test_k2_phase_steps_only_its_pixels(deep_la, phase):
    """A launch of one phase leaves the pixels of the other as they
    are."""
    ptz, res, la = deep_la
    T, orbit, flat = _k2_inputs(ptz, res, la, torch.float32)
    mr = res.max_ref_iteration()
    start = la_kernel.lav2_plain(T, orbit, flat, la_kernel.init_state_plain(
        T, flat, BUDGET), BUDGET, mr, False, 1)
    # half the pixels one step further: some in the LA stages, some in
    # the tail
    half = torch.arange(flat.re.numel()) % 2 == 0
    later = la_kernel.lav2_plain(T, orbit, flat, start, BUDGET, mr, False, 2)
    start = tuple(torch.where(half, b, a) for a, b in zip(start, later))
    other = (start[0] < 0) if phase == "la" else (start[0] >= 0)
    assert bool(other.any()) and bool((~other & ~start[-1]).any())
    got = la_kernel.lav2_plain(T, orbit, flat, start, BUDGET, mr, False, 50,
                               phase)
    for a, b in zip(got, start):
        assert torch.equal(a[other], b[other])
    assert any(not torch.equal(a[~other], b[~other])
               for a, b in zip(got, start))


# ------------------------------------------------------------ CPU: JAX


@pytest.mark.parametrize("form,dtype", K6_FORMS, ids=_ids(K6_FORMS))
def test_k6_chunked_matches_jax(jax_ref, deep, form, dtype):
    ptz, res, _ = deep
    render = (perturb.perturb_render_hdr if form == "hdr"
              else perturb.perturb_render_float)
    got = render(res, ptz, SIZE, SIZE, BUDGET, dtype, chunk_steps=CHUNK,
                 device="cpu")
    want = jax_ref[f"{form}-{str(dtype).split('.')[-1]}"]
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))


def test_k6_view6_chunked_matches_jax(jax_ref):
    """View #6's 457,977-entry orbit at a cut budget (B11's route)."""
    ptz, res = _view6()
    got = perturb.perturb_render_hdr(res, ptz, V6_SIZE, V6_SIZE, V6_BUDGET,
                                     chunk_steps=CHUNK * 10, device="cpu")
    np.testing.assert_array_equal(got.numpy(),
                                  jax_ref["v6"].astype(np.int64))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["float32", "float64"])
def test_k2_full_chunked_matches_jax(jax_ref, deep_la, dtype):
    ptz, res, la = deep_la
    got = la_kernel.la_perturb_render(res, la, ptz, LA_SIZE, LA_SIZE, BUDGET,
                                      sub_dtype=dtype, chunk_steps=CHUNK,
                                      device="cpu")
    want = jax_ref[f"full-{str(dtype).split('.')[-1]}"]
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["float32", "float64"])
def test_k2_la_only_chunked_matches_jax(jax_ref, deep_la, dtype):
    ptz, res, la = deep_la
    got = la_kernel.la_perturb_render(res, la, ptz, LA_SIZE, LA_SIZE, BUDGET,
                                      sub_dtype=dtype, la_only=True,
                                      chunk_steps=1, return_state=True,
                                      device="cpu")
    name = str(dtype).split(".")[-1]
    for k, a in zip(la_kernel._STATE, got):
        np.testing.assert_array_equal(a.numpy(), jax_ref[f"lao-{name}-{k}"])


# ------------------------------------------------------------ CPU: plans


def _k6_launch(deep, state, work):
    ptz, res, _ = deep
    orbit, flat = _k6_inputs(ptz, res, SIZE, "hdr", torch.float32)
    if state == "zero":
        state = perturb.init_state_plain(flat, BUDGET, True)
    return lambda: perturb.perturb_kernel(orbit, flat, state, BUDGET,
                                          res.max_ref_iteration(), True,
                                          CHUNK, "perturb_hdr32", work)


def _k2_launch(deep_la, state, work):
    ptz, res, la = deep_la
    T, orbit, flat = _k2_inputs(ptz, res, la, torch.float32)
    if state == "zero":
        state = la_kernel.init_state_plain(T, flat, BUDGET)
    return lambda: la_kernel.lav2_kernel(T, orbit, flat, state, BUDGET,
                                         res.max_ref_iteration(), False,
                                         CHUNK, work)


WORK_FAULTS = {
    # the first launch starts every pixel from the zero state
    "first_launch_with_work": (None, torch.arange(4, dtype=torch.int32)),
    "int64_work": ("zero", torch.arange(4, dtype=torch.int64)),
    "strided_work": ("zero", torch.arange(8, dtype=torch.int32)[::2]),
}


@pytest.mark.parametrize("fault", list(WORK_FAULTS))
@pytest.mark.parametrize("kernel", ["k6", "k2"])
def test_wrappers_refuse_bad_work(deep, deep_la, kernel, fault):
    """A work list the kernels cannot take is refused before any launch
    (these tensors lie on the CPU, where nothing is built)."""
    state, work = WORK_FAULTS[fault]
    launch = (_k6_launch(deep, state, work) if kernel == "k6"
              else _k2_launch(deep_la, state, work))
    with pytest.raises(ValueError):
        launch()


def test_live_pixels_are_ascending_int32():
    done = torch.tensor([True, False, False, True, False])
    w = perturb.live_pixels(done)
    assert w.dtype == torch.int32 and w.tolist() == [1, 2, 4]


# ------------------------------------------------------------ the card


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("form,dtype", K6_FORMS, ids=_ids(K6_FORMS))
def test_k6_kernel_equals_twin_on_card(deep, form, dtype):
    """K6's run on the card, compacted and chunked, equals the twin's
    lockstep run, every state array."""
    dev = _card()
    ptz, res, _ = deep
    orbit, flat = _k6_inputs(ptz, res, SIZE, form, dtype, dev)
    hdr_mode = form == "hdr"
    mr = res.max_ref_iteration()
    want = _k6_lockstep(orbit, flat, res, BUDGET, form)
    state, work = None, None
    while True:
        state = perturb.perturb_kernel(orbit, flat, state, BUDGET, mr,
                                       hdr_mode, CHUNK, "perturb_hdr32", work)
        work = perturb.live_pixels(state[-1])
        if work.numel() == 0:
            break
    _same(state, want)


def _edge_k6(state, edge, mr):
    """A K6 state moved to an edge: every live pixel at j = max_ref - 1
    (its next step rebases on the orbit's end), or at j = 0 with its dz
    the orbit value it would rebase to (a rebase-prone first step)."""
    dzr, dzi, dze, j, it, done = (t.clone() for t in state)
    if edge == "last_row":
        j[:] = mr - 1
    else:
        j[:] = 0
    return dzr, dzi, dze, j, it, done


@pytest.mark.cuda
@pytest.mark.parametrize("edge", ["last_row", "row0"])
@pytest.mark.parametrize("form,dtype", K6_FORMS, ids=_ids(K6_FORMS))
def test_k6_resumes_from_edge_states_on_card(deep, form, dtype, edge):
    """K6 resumed from a state at an edge (a launch's first step at
    j = max_ref - 1, or at row 0 after 40 steps) equals the twin."""
    dev = _card()
    ptz, res, _ = deep
    orbit, flat = _k6_inputs(ptz, res, SIZE, form, dtype, dev)
    hdr_mode = form == "hdr"
    mr = res.max_ref_iteration()
    start = perturb.perturb_plain(orbit, flat, perturb.init_state_plain(
        flat, BUDGET, hdr_mode), BUDGET, mr, hdr_mode, 40)
    start = _edge_k6(start, edge, mr)
    want = perturb.perturb_plain(orbit, flat, start, BUDGET, mr, hdr_mode,
                                 CHUNK)
    work = perturb.live_pixels(start[-1])
    got = perturb.perturb_kernel(orbit, flat, tuple(t.clone() for t in start),
                                 BUDGET, mr, hdr_mode, CHUNK, "perturb_hdr32",
                                 work)
    _same(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,la_only", K2_MODES, ids=[
    f"{str(d).split('.')[-1]}-{'la_only' if o else 'full'}"
    for d, o in K2_MODES])
def test_k2_kernel_equals_twin_on_card(deep_la, dtype, la_only):
    dev = _card()
    ptz, res, la = deep_la
    T, orbit, flat = _k2_inputs(ptz, res, la, dtype, dev)
    mr = res.max_ref_iteration()
    want = _k2_lockstep(T, orbit, flat, res, la_only)
    for split in (False, True):
        state, work, phase = None, None, "la" if split else "both"
        while True:
            state = la_kernel.lav2_kernel(T, orbit, flat, state, BUDGET, mr,
                                          la_only, 1 if la_only else CHUNK,
                                          work, phase)
            work, phase = la_kernel.next_work(state, split)
            if work is None:
                break
        _same(state, want)


@pytest.mark.cuda
@pytest.mark.parametrize("edge", ["tail_at_max_ref", "stage_drop",
                                  "stage_rebase"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["float32", "float64"])
def test_k2_resumes_from_edge_states_on_card(deep_la, dtype, edge):
    """K2 resumed from a state at an edge equals the twin, in "both" and
    in the edge's own phase: the tail entered at ref_iter = max_ref (the
    clamp's end), a stage just dropped (j = -1: the node comes from
    ref_iter), or j = 0 (the stage's first node, as after a rebase)."""
    dev = _card()
    ptz, res, la = deep_la
    T, orbit, flat = _k2_inputs(ptz, res, la, dtype, dev)
    mr = res.max_ref_iteration()
    start = la_kernel.lav2_plain(T, orbit, flat, la_kernel.init_state_plain(
        T, flat, BUDGET), BUDGET, mr, False, 2)
    s, j, ref_iter, dzr, dzi, dze, it, done = (t.clone() for t in start)
    if edge == "tail_at_max_ref":
        s[:] = -1
        ref_iter[:] = mr
    elif edge == "stage_drop":
        live = s >= 0
        j[live] = -1
        ref_iter[live] = 1
    else:
        j[s >= 0] = 0
    start = (s, j, ref_iter, dzr, dzi, dze, it, done)
    for phase in ("both", "tail" if edge == "tail_at_max_ref" else "la"):
        want = la_kernel.lav2_plain(T, orbit, flat, start, BUDGET, mr, False,
                                    CHUNK, phase)
        runs = ~done & {"both": True, "la": s >= 0, "tail": s < 0}[phase]
        got = la_kernel.lav2_kernel(T, orbit, flat,
                                    tuple(t.clone() for t in start), BUDGET,
                                    mr, False, CHUNK,
                                    perturb.live_pixels(~runs), phase)
        _same(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("f64", [0, 1], ids=["float32", "float64"])
def test_k2_lanes_and_shared_memory_on_card(f64):
    """The C side's lane count (which decides K2's phase split) holds a
    block of the builder's 1,024 stages, and the C entry refuses a stage
    table past the 48 KB of shared memory a block takes, before it
    launches (cudaErrorInvalidValue), so no pixel is touched."""
    _card()
    from fractalshark_tpu_torch import kernels
    lib = kernels.lib()
    assert lib.fs_lav2_lanes(1024, f64) >= 128
    fn = lib.fs_lav2_f64 if f64 else lib.fs_lav2
    stages = 48 * 1024 // (32 if f64 else 16) + 1
    assert fn(*([None] * 18), 1, 1, stages, 1, 1, 1, 0, 0, None) == 1
