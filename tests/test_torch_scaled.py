"""The Scaled family in the port (``fractalshark_tpu_torch/ops/scaled.py``)
against the JAX package, bit for bit: ``bad_flags``; K6's glitch instance
(its plain twin, ``perturb.perturb_plain`` with ``bad``) against
``_perturb_f32_glitch_impl``, counts and flags, on the 1e8 frame (clean:
its one bad entry is the wrap entry no pixel reads) and on the poisoned
orbit of ``tests/test_scaled.py`` (glitched pixels, so the HDR-f64 repair
pass runs); ``perturb_render_scaled`` and its stats on both; the twin in
chunks over the live pixels against one run.  The ``cuda`` test holds
the glitch instance to its twin on the card.
"""

import numpy as np
import pytest
import torch

import test_torch_jaxref as ref
from fractalshark_tpu_torch import kernels
from fractalshark_tpu_torch.ops import perturb, scaled
from fractalshark_tpu_torch.ops.hdrfloat import HDRComplex
from fractalshark_tpu_torch.ops.tables import orbit_on

DEEP_SIZE, DEEP_BUDGET = 32, 1500
POISON_SIZE, POISON_BUDGET = 32, 200


def _deep(pkg="fractalshark_tpu_torch"):
    h = ref.host_layer(pkg)
    ptz = h.PointZoomBBConverter(
        pt_x="-0.743643887037158704752191506114774",
        pt_y="0.131825904205311970493132056385139",
        zoom_factor="1e8", prec=512).square_aspect_ratio(DEEP_SIZE,
                                                         DEEP_SIZE)
    res = h.RefOrbitCalc().get_and_create_useful_results(ptz, DEEP_BUDGET)
    return ptz, res


def _poisoned(pkg="fractalshark_tpu_torch"):
    """``tests/test_scaled.py:52-73``: a clean shallow orbit with entry 5
    made f32-subnormal."""
    h = ref.host_layer(pkg)
    ptz = h.PointZoomBBConverter(
        pt_x="-0.6", pt_y="0.4",
        zoom_factor="4").square_aspect_ratio(POISON_SIZE, POISON_SIZE)
    res = h.RefOrbitCalc().get_and_create_useful_results(ptz, POISON_BUDGET)
    res2 = type(res)(
        center_x=res.center_x, center_y=res.center_y,
        orbit_x=res.orbit_x.copy(), orbit_y=res.orbit_y.copy(),
        max_radius=res.max_radius, period=res.period,
        escaped_at=res.escaped_at, max_iterations=res.max_iterations,
        precision_bits=res.precision_bits)
    res2.orbit_x[5] = 1e-40
    res2.orbit_y[5] = 1e-40
    return ptz, res2


FRAMES = {"deep": (_deep, DEEP_SIZE, DEEP_BUDGET),
          "poisoned": (_poisoned, POISON_SIZE, POISON_BUDGET)}


def _jax_reference(_inputs):
    import jax.numpy as jnp

    from fractalshark_tpu.ops import perturb as jp
    from fractalshark_tpu.ops import scaled as js

    out = {}
    for name, (make, size, n) in FRAMES.items():
        ptz, res = make("fractalshark_tpu")
        ox, oy = res.device_orbit(np.float64)
        bad = js.bad_flags(ox, oy)
        out[name + "_bad"] = bad
        dx, dy, cxo, cyo = jp.delta_params(ptz, res.center_x, res.center_y,
                                           size, size)
        dcx, dcy = jp._dc_grids_float(dx, dy, cxo, cyo, size, size,
                                      np.float32)
        it, glitch = js._perturb_f32_glitch_impl(
            jnp.asarray(ox.astype(np.float32)),
            jnp.asarray(oy.astype(np.float32)), jnp.asarray(bad), dcx, dcy,
            n, jnp.int32(res.max_ref_iteration()))
        out[name + "_f32"] = np.asarray(it)
        out[name + "_glitch"] = np.asarray(glitch)
        grid, stats = js.perturb_render_scaled(res, ptz, size, size, n,
                                               return_stats=True)
        out[name + "_render"] = np.asarray(grid)
        for k, v in stats.items():
            out[f"{name}_{k}"] = np.asarray(v)
    return out


@pytest.fixture(scope="module")
def jax_ref(tmp_path_factory):
    return ref.run_jax_reference("test_torch_scaled", "_jax_reference",
                                 tmp_path_factory.mktemp("scaled"))


@pytest.fixture(scope="module")
def frames():
    return {name: make() for name, (make, _, _) in FRAMES.items()}


@pytest.mark.parametrize("name", list(FRAMES))
def test_bad_flags_match_jax(jax_ref, frames, name):
    _, res = frames[name]
    bad = scaled.bad_flags(*res.device_orbit(np.float64))
    np.testing.assert_array_equal(bad, jax_ref[name + "_bad"])
    assert not bad[0]
    # the 1e8 frame's only bad entry is the wrap entry past max_ref
    want = [res.max_ref_iteration() + 1] if name == "deep" else [5]
    assert np.flatnonzero(bad).tolist() == want


@pytest.mark.parametrize("name", list(FRAMES))
def test_glitch_pass_matches_jax(jax_ref, frames, name):
    """K6's glitch instance's twin (the f32 pass through the run loop):
    counts and flags."""
    ptz, res = frames[name]
    _, size, n = FRAMES[name]
    iters, glitch, n_bad = scaled.scaled_pass(res, ptz, size, size, n,
                                              device="cpu")
    want = jax_ref[name + "_f32"]
    assert want.dtype == np.uint32
    np.testing.assert_array_equal(iters.numpy(), want.astype(np.int64))
    np.testing.assert_array_equal(glitch.numpy(), jax_ref[name + "_glitch"])
    assert n_bad == int(jax_ref[f"{name}_bad_entries"])
    assert bool(glitch.any()) == (name == "poisoned")


@pytest.mark.parametrize("name", list(FRAMES))
def test_render_and_stats_match_jax(jax_ref, frames, name):
    ptz, res = frames[name]
    _, size, n = FRAMES[name]
    kernels.reset_counts()
    got, stats = scaled.perturb_render_scaled(res, ptz, size, size, n,
                                              device="cpu")
    np.testing.assert_array_equal(
        got.numpy(), jax_ref[name + "_render"].astype(np.int64))
    for k in ("glitched_pixels", "bad_entries"):
        assert stats[k] == int(jax_ref[f"{name}_{k}"]), k
    assert (stats["glitched_pixels"] > 0) == (name == "poisoned")


def _inputs(frames, name, device):
    ptz, res = frames[name]
    _, size, _ = FRAMES[name]
    dc = perturb._dc_grids_float(*perturb.delta_params(
        ptz, res.center_x, res.center_y, size, size), size, size, device,
        torch.float32)
    bad = torch.from_numpy(scaled.bad_flags(
        *res.device_orbit(np.float64))).to(device)
    return orbit_on(res, device, torch.float32), dc, bad, \
        res.max_ref_iteration()


@pytest.mark.parametrize("chunk", [0, 1, 7])
def test_glitch_twin_in_chunks_over_the_live_pixels(frames, chunk):
    """Launches of `chunk` steps over the live pixels carry the glitch
    flags with the state: the same counts and flags as one run."""
    orbit, dc, bad, mr = _inputs(frames, "poisoned", torch.device("cpu"))
    flat = HDRComplex(*(t.reshape(-1) for t in dc))
    zero = perturb.init_state_plain(flat, POISON_BUDGET, False)
    one = perturb.perturb_plain(orbit, flat,
                                zero + (torch.zeros_like(zero[5]),),
                                POISON_BUDGET, mr, False, bad=bad)
    st = perturb.run_state(orbit, dc, POISON_BUDGET, mr, False,
                           "perturb_scaled", chunk, bad=bad)
    assert torch.equal(st[4], one[4]) and torch.equal(st[6], one[6])
    assert bool(one[6].any()) and not bool(one[6].all())


def test_budget_of_2_31_raises(frames):
    ptz, res = frames["poisoned"]
    with pytest.raises(OverflowError):
        scaled.perturb_render_scaled(res, ptz, 4, 4, 1 << 31, device="cpu")


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(FRAMES))
def test_glitch_instance_matches_twin_on_card(frames, name):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (K6 has no CPU form)")
    card = torch.device("cuda", 0)
    orbit, dc, bad, mr = _inputs(frames, name, card)
    n = FRAMES[name][2]
    kernels.reset_counts()
    st = perturb.run_state(orbit, dc, n, mr, False, "perturb_scaled", 97,
                           bad=bad)
    assert kernels.launches["perturb_scaled"] == \
        perturb.last_run_stats["dispatches"]
    flat = HDRComplex(*(t.reshape(-1) for t in dc))
    zero = perturb.init_state_plain(flat, n, False)
    one = perturb.perturb_plain(orbit, flat,
                                zero + (torch.zeros_like(zero[5]),), n, mr,
                                False, bad=bad)
    assert torch.equal(st[4], one[4]) and torch.equal(st[6], one[6])


def _bad_variants(bad: torch.Tensor, mr: int) -> dict:
    """The poisoned orbit's flags (entry 5), and flags set at position 1
    alone, in the middle alone, at the last position a pixel steps from
    (max_ref - 1, where it rebases) alone, past it (max_ref) alone, and at
    random (seeded, 2 % of the entries)."""
    out = {"poisoned": bad}
    for name, pos in (("first", 1), ("middle", mr // 2), ("last", mr - 1),
                      ("past", mr)):
        b = torch.zeros_like(bad)
        b[pos] = True
        out[name] = b
    rng = np.random.default_rng(17)
    for s in range(2):
        out[f"random{s}"] = torch.from_numpy(rng.random(bad.numel()) < 0.02)
    return out


BAD_VARIANTS = ["poisoned", "first", "middle", "last", "past", "random0",
                "random1"]


def test_first_bad_index(frames):
    orbit, _, bad, mr = _inputs(frames, "poisoned", torch.device("cpu"))
    v = _bad_variants(bad, mr)
    assert [perturb.first_bad(v[k], mr) for k in ("poisoned", "first",
                                                  "middle", "last",
                                                  "past")] == \
        [5, 1, mr // 2, mr - 1, mr]
    assert perturb.first_bad(torch.zeros_like(bad), mr) == mr
    assert perturb.first_bad(torch.ones_like(bad), 0) == 0
    assert perturb.first_bad(torch.zeros_like(bad), 0) == 1
    # the 1e8 frame's only bad entry, the wrap entry, is past max_ref
    _, _, deep_bad, deep_mr = _inputs(frames, "deep", torch.device("cpu"))
    assert perturb.first_bad(deep_bad, deep_mr) == deep_mr


@pytest.mark.parametrize("chunk", [0, 7])
@pytest.mark.parametrize("variant", BAD_VARIANTS)
def test_twin_with_the_prefix_mask_equals_twin_with_bad(frames, variant,
                                                        chunk):
    """K6-glitch's first-bad identity: the twin with `bad` replaced by its
    prefix mask (positions at or past first_bad) gives the counts and
    flags it gives with `bad`, from the zero state in one run and in
    launches of `chunk` steps over the live pixels."""
    orbit, dc, bad, mr = _inputs(frames, "poisoned", torch.device("cpu"))
    bad = _bad_variants(bad, mr)[variant]
    prefix = torch.arange(bad.numel()) >= perturb.first_bad(bad, mr)
    want = perturb.run_state(orbit, dc, POISON_BUDGET, mr, False,
                             "perturb_scaled", chunk, bad=bad)
    got = perturb.run_state(orbit, dc, POISON_BUDGET, mr, False,
                            "perturb_scaled", chunk, bad=prefix)
    assert torch.equal(got[4], want[4]) and torch.equal(got[6], want[6])
    if variant != "past":
        assert bool(want[6].any())
    else:
        assert not bool(want[6].any())


@pytest.mark.cuda
@pytest.mark.parametrize("chunk", [0, 257])
@pytest.mark.parametrize("variant", BAD_VARIANTS)
def test_glitch_kernel_matches_twin_on_bad_variants(frames, variant, chunk):
    """The glitch kernel (its first-bad index) against the twin (its bad
    flags) on the poisoned orbit's flag variants, in one launch and in
    launches of 257 steps over the live pixels: counts, flags, j and the
    state's dz and done."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (K6 has no CPU form)")
    card = torch.device("cuda", 0)
    orbit, dc, bad, mr = _inputs(frames, "poisoned", card)
    bad = _bad_variants(bad.cpu(), mr)[variant]
    st = perturb.run_state(orbit, dc, POISON_BUDGET, mr, False,
                           "perturb_scaled", chunk, bad=bad)
    flat = HDRComplex(*(t.reshape(-1) for t in dc))
    zero = perturb.init_state_plain(flat, POISON_BUDGET, False)
    one = perturb.perturb_plain(orbit, flat,
                                zero + (torch.zeros_like(zero[5]),),
                                POISON_BUDGET, mr, False, bad=bad.to(card))
    for i in (0, 1, 3, 4, 5, 6):
        assert torch.equal(st[i], one[i]), i


def test_budget_zero_runs_no_step_and_sets_no_flag(frames):
    """At a budget of 0 the glitch pass runs no step: counts 0, no flag,
    even with every entry bad."""
    orbit, dc, bad, mr = _inputs(frames, "poisoned", torch.device("cpu"))
    st = perturb.run_state(orbit, dc, 0, mr, False, "perturb_scaled",
                           bad=torch.ones_like(bad))
    assert not bool(st[4].any()) and not bool(st[6].any())
    assert bool(st[5].all())


@pytest.mark.cuda
def test_glitch_kernel_budget_zero(frames):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (K6 has no CPU form)")
    card = torch.device("cuda", 0)
    orbit, dc, bad, mr = _inputs(frames, "poisoned", card)
    st = perturb.run_state(orbit, dc, 0, mr, False, "perturb_scaled",
                           bad=torch.ones_like(bad))
    assert not bool(st[4].any()) and not bool(st[6].any())
    assert bool(st[5].all())
