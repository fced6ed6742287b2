"""The BLA family in the port: ``engine/bla.py``'s table against the JAX
package's, field for field (the 1e8 frame's orbit and View #6's), and
K15's plain twin (``fractalshark_tpu_torch/ops/bla_kernel.py``) against
``bla_perturb_render`` with f32 and f64 mantissas, bit for bit; the twin
in chunks over the live pixels against one run; the int32 budget the
reference refuses at 2^31; K15's lookup bound (``bound_rows_np``), which
decides a lookup exactly as the twin's level walk does; the twin's step
tally.  The ``cuda`` tests hold K15 (its state, grid and tally) to its
twin on the card at the full budget.
"""

import numpy as np
import pytest
import torch

import test_torch_jaxref as ref
from fractalshark_tpu_torch import kernels
from fractalshark_tpu_torch.engine.bla import BLATable, get_or_build_bla
from fractalshark_tpu_torch.ops import bla_kernel, perturb
from fractalshark_tpu_torch.ops.hdrfloat import HDR, HDRComplex
from fractalshark_tpu_torch.ops.tables import ibits, orbit_on

SIZE, BUDGET = 32, 1500
# the chunked runs: a 16² frame at a cut budget (its first pixels escape
# from 900 on)
CHUNK_SIZE, CHUNK_BUDGET = 16, 1000
FIELDS = ("a_m", "a_e", "b_m", "b_e", "r2_m", "r2_e", "l", "level_offset",
          "level_count")


def _deep(pkg="fractalshark_tpu_torch", size=SIZE):
    h = ref.host_layer(pkg)
    ptz = h.PointZoomBBConverter(
        pt_x="-0.743643887037158704752191506114774",
        pt_y="0.131825904205311970493132056385139",
        zoom_factor="1e8", prec=512).square_aspect_ratio(size, size)
    return ptz, h.RefOrbitCalc().get_and_create_useful_results(ptz, BUDGET)


def _view6(pkg="fractalshark_tpu_torch"):
    h = ref.host_layer(pkg)
    p = h.get_view_preset(6)
    ptz = p.ptz.square_aspect_ratio(4, 4)
    return h.RefOrbitCalc().get_and_create_useful_results(
        ptz, p.num_iterations)


def _table_arrays(bla, prefix) -> dict:
    out = {f"{prefix}_{k}": np.asarray(getattr(bla, k)) for k in FIELDS}
    out[f"{prefix}_num_levels"] = np.asarray(bla.num_levels)
    out[f"{prefix}_m_total"] = np.asarray(bla.m_total)
    return out


def _jax_reference(_inputs):
    from fractalshark_tpu.engine.bla import get_or_build_bla as jbuild
    from fractalshark_tpu.ops import bla_kernel as jb

    out = {}
    ptz, res = _deep("fractalshark_tpu")
    bla = jbuild(res)
    out.update(_table_arrays(bla, "deep"))
    for name, dt in (("f32", np.float32), ("f64", np.float64)):
        out["render_" + name] = np.asarray(jb.bla_perturb_render(
            res, bla, ptz, SIZE, SIZE, BUDGET, sub_dtype=dt))
    try:
        jb.bla_perturb_render(res, bla, ptz, 4, 4, 1 << 31)
        out["overflow"] = np.asarray(False)
    except OverflowError:
        out["overflow"] = np.asarray(True)
    out.update(_table_arrays(jbuild(_view6("fractalshark_tpu")), "v6"))
    return out


@pytest.fixture(scope="module")
def jax_ref(tmp_path_factory):
    return ref.run_jax_reference("test_torch_bla", "_jax_reference",
                                 tmp_path_factory.mktemp("bla"))


@pytest.fixture(scope="module")
def deep():
    ptz, res = _deep()
    return ptz, res, get_or_build_bla(res)


def _table_equal(bla: BLATable, jax_ref, prefix):
    for k, v in _table_arrays(bla, prefix).items():
        want = jax_ref[k]
        assert v.dtype == want.dtype, k
        assert ref.bits_equal(v, want), k


def test_table_matches_jax_on_the_1e8_frame(jax_ref, deep):
    _, res, bla = deep
    assert bla.num_levels > 1 and len(bla.l) > 100
    _table_equal(bla, jax_ref, "deep")
    assert res.extra["bla_table"] is bla   # built once per orbit


def test_table_matches_jax_on_view6(jax_ref):
    bla = get_or_build_bla(_view6())
    assert bla.m_total > 400_000
    _table_equal(bla, jax_ref, "v6")


@pytest.mark.parametrize("dtype", ["f32", "f64"])
def test_render_matches_jax(jax_ref, deep, dtype):
    ptz, res, bla = deep
    got = bla_kernel.bla_perturb_render(
        res, bla, ptz, SIZE, SIZE, BUDGET,
        sub_dtype=getattr(np, "float" + dtype[1:]), device="cpu")
    want = jax_ref["render_" + dtype]
    assert want.dtype == np.uint32
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))
    assert int(got.max()) == BUDGET > int(got.min())


def _inputs(deep, size, dtype):
    ptz, res, bla = deep
    dev = torch.device("cpu")
    dc = perturb._dc_grids_hdr(*perturb.delta_params(
        ptz, res.center_x, res.center_y, size, size), size, size, dev, dtype)
    return (orbit_on(res, dev, dtype), dc,
            bla_kernel.bla_tables(bla, dev, dtype), res.max_ref_iteration())


@pytest.fixture(scope="module")
def one_run(deep):
    """The chunk frame's inputs and its grid from one lockstep run."""
    orbit, dc, T, mr = _inputs(deep, CHUNK_SIZE, torch.float32)
    flat = HDRComplex(*(t.reshape(-1) for t in dc))
    one = bla_kernel.bla_plain(orbit, flat, T,
                               bla_kernel.init_state_plain(flat),
                               CHUNK_BUDGET, mr)
    return orbit, dc, T, mr, one[4].to(torch.int64)


@pytest.mark.parametrize("chunk", [0, 1, 7])
def test_twin_in_chunks_over_the_live_pixels(one_run, chunk):
    """The run loop's launches of `chunk` bodies, each over the pixels the
    last left live, give one lockstep run's grid."""
    orbit, dc, T, mr, want = one_run
    got = bla_kernel.bla_run(orbit, dc, T, CHUNK_BUDGET, mr,
                             chunk_steps=chunk)
    assert torch.equal(got.reshape(-1), want)
    assert int(want.max()) == CHUNK_BUDGET > int(want.min())
    if chunk:
        assert bla_kernel.last_run_stats["dispatches"] > 1
        work = bla_kernel.last_run_stats["work"]
        assert work[0] == CHUNK_SIZE ** 2
        assert all(a >= b for a, b in zip(work, work[1:]))


def test_budget_of_2_31_raises_as_the_reference(jax_ref, deep):
    assert jax_ref["overflow"]
    ptz, res, bla = deep
    with pytest.raises(OverflowError):
        bla_kernel.bla_perturb_render(res, bla, ptz, 4, 4, 1 << 31,
                                      device="cpu")


def test_first_body_runs_at_budget_zero(deep):
    """As the reference's first body: every pixel steps once (or
    escapes) even at a budget of 0."""
    orbit, dc, T, mr = _inputs(deep, 4, torch.float64)
    got = bla_kernel.bla_run(orbit, dc, T, 0, mr)
    assert set(got.reshape(-1).tolist()) <= {0, 1}


@pytest.fixture(scope="module")
def view6_bla():
    return get_or_build_bla(_view6())


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("frame", ["1e8", "view6"])
def test_bound_rows_decide_the_walk(deep, view6_bla, frame, dtype):
    """At every even k below max_ref, for seeded |dz|² (random near the
    row's bound, the bound itself and the next value below it), the
    twin's level walk finds an entry exactly when dz² is below
    bound[k/4]; k = 2 (mod 4) and k past the rows find none."""
    bla = deep[2] if frame == "1e8" else view6_bla
    T = bla_kernel.bla_tables(bla, "cpu", dtype)
    rows = T.bound.shape[0]
    bm, be = T.bound[:, 0], ibits(T.bound[:, 1])
    k = torch.arange(0, int(bla.m_total), 2, dtype=torch.int32)
    r = (k >> 2).clamp(max=rows - 1).long()
    has_row = ((k & 3) == 0) & ((k >> 2) < rows)
    real = has_row & torch.isfinite(bm[r])
    assert bool(real.any()) and bool((~has_row).any())
    rng = np.random.default_rng(16)
    m_at, e_at = torch.where(real, bm[r], 1.0), torch.where(real, be[r], 0)
    # the reduced value just below each bound: the next mantissa down, or
    # the largest one of the exponent below
    m_dn = torch.nextafter(m_at, torch.zeros_like(m_at))
    wrap = m_dn < 1
    cases = [(m_at, e_at),
             (torch.where(wrap, torch.nextafter(torch.full_like(m_at, 2.0),
                                                torch.zeros_like(m_at)),
                          m_dn), e_at - wrap.to(torch.int32))]
    for _ in range(3):
        cases.append((torch.from_numpy(rng.uniform(1, 2, len(k))).to(dtype),
                      e_at + torch.from_numpy(
                          rng.integers(-2, 3, len(k))).to(torch.int32)))
    for i, (m, e) in enumerate(cases):
        dz2 = HDR(m, e)
        found, _ = bla_kernel.level_search(T, k + 1, dz2)
        want = has_row & bla_kernel.hdr.lt_reduced(dz2, HDR(bm[r], be[r]))
        assert torch.equal(found, want)
        # at the bound nothing hits; just below it, every real row does
        if i < 2:
            assert torch.equal(found, real if i else torch.zeros_like(real))


def test_twin_tally_counts_every_live_body(one_run):
    """The twin's tally: a BLA or a single step for each pixel in each
    body it is live, the same over chunks of bodies as in one run."""
    orbit, dc, T, mr, want = one_run
    flat = HDRComplex(*(t.reshape(-1) for t in dc))
    tally = torch.zeros((flat.re.numel(), 2), dtype=torch.int64)
    st = bla_kernel.bla_plain(orbit, flat, T,
                              bla_kernel.init_state_plain(flat),
                              CHUNK_BUDGET, mr, tally=tally)
    assert torch.equal(st[4].to(torch.int64), want)
    live = torch.zeros(flat.re.numel(), dtype=torch.int64)
    chunked = torch.zeros_like(tally)
    st = bla_kernel.init_state_plain(flat)
    while not bool(st[-1].all()):
        live += ~st[-1]
        st = bla_kernel.bla_plain(orbit, flat, T, st, CHUNK_BUDGET, mr,
                                  chunk_steps=1, tally=chunked)
    assert torch.equal(tally, chunked)
    assert torch.equal(tally.sum(dim=1), live)
    assert int(tally[:, 0].sum()) > 0 and int(tally[:, 1].sum()) > 0


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (K15 has no CPU form)")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("chunk", [None, 97])
@pytest.mark.parametrize("size", [64, 1024])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_k15_matches_twin_on_card(card, deep, dtype, size, chunk):
    """K15 at the full budget through its run loop (the default launches,
    or launches of 97 steps over the live pixels; 1024² has more pixels
    than the card's lanes: the work queue) equals the twin's state, grid
    and per-pixel tally of BLA and single steps."""
    ptz, res, bla = deep
    orbit = orbit_on(res, card, dtype)
    dc = perturb._dc_grids_hdr(*perturb.delta_params(
        ptz, res.center_x, res.center_y, size, size), size, size, card,
        dtype)
    T = bla_kernel.bla_tables(bla, card, dtype)
    mr = res.max_ref_iteration()
    P = size * size
    kernels.reset_counts()
    tally = torch.zeros((P, 2), dtype=torch.int64, device=card)
    got = bla_kernel.bla_run_state(orbit, dc, T, BUDGET, mr,
                                   chunk_steps=chunk, tally=tally)
    key = "bla_f32" if dtype == torch.float32 else "bla_f64"
    assert kernels.launches[key] == bla_kernel.last_run_stats["dispatches"]
    flat = HDRComplex(*(t.reshape(-1) for t in dc))
    want_tally = torch.zeros_like(tally)
    want = bla_kernel.bla_plain(orbit, flat, T,
                                bla_kernel.init_state_plain(flat), BUDGET,
                                mr, tally=want_tally)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert torch.equal(tally, want_tally)
    assert int(want[4].max()) == BUDGET
