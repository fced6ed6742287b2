"""The endurance pipeline of the PyTorch/CUDA port (the View #27 class:
a compressed, checkpointed native orbit, an LA table built through the
anchor store into memmaps, a ``VirtualResults`` two-phase render through
the gather tail), on the CPU (the plain twins), against the JAX
package's same composition with FMA contraction off.

The mini location is ``tests/test_view27_pipeline.py``'s: the 1e13
frame at 16², budget 12,000.  Its orbit has period 999, so the JAX
test's truncation to 2,048 entries leaves it whole, and a native session
from its centre ends at the same 999 positions (7 anchors at
``error_exp`` 20): each pixel wraps the orbit several times.  The JAX
references run the gather tail (XLA, in both modes), not the sweep.

``_view23_rc_pins`` is the JAX package's View #23 frame at 32² through
the same composition, the pins of ``tools/run_view27_torch.py``
(``tools/view23_rc_pins.py``, outside the gate: ~10 minutes on the CPU).
"""

import importlib
import json
import os
import types

import numpy as np
import pytest
import torch

import chip_smoke as cs
import test_torch_jaxref as ref
from fractalshark_tpu_torch.engine import native_la as NL

pytestmark = pytest.mark.skipif(not NL.available(),
                                reason="native toolchain missing")

# the driver: its pins (grid_pin, anchors_crc) are the ones checked here
rv = cs.load_tool("run_view27_torch")

MINI_CX, MINI_CY, MINI_ZOOM = cs.MINI_RC_VIEW
ORBIT_LEN, BUDGET, SIZE = 2048, cs.MINI_RC_BUDGET, cs.MINI_RC_SIZE
MODES = ("f64", "df32")
# tests/test_native_orbit.py's session: View #5 at 64², period 16,046,
# interrupted at 9,000
SESSION_VIEW, SESSION_STOP, SESSION_CAP = 5, 9000, 200_000
# View #23's pinned frame (tools/view23_rc_pins.py)
VIEW23, SIZE23 = 23, 32


def _mods(pkg):
    """The host-layer names of the pipeline from `pkg`: the port or,
    inside a JAX reference, ``fractalshark_tpu``."""
    def m(name):
        return importlib.import_module(f"{pkg}.{name}")

    pr = m("engine.perturbation_results")
    return types.SimpleNamespace(
        HD=m("core.hdr_host").HD,
        PTZ=m("core.pointzoom").PointZoomBBConverter,
        precision_from_view=m("core.precision").precision_from_view,
        get_view_preset=m("core.views").get_view_preset,
        NL=m("engine.native_la"), NO=m("engine.native_orbit"),
        LAParameters=m("engine.la_reference").LAParameters,
        PerturbationResults=pr.PerturbationResults,
        CompressedOrbit=pr.CompressedOrbit,
        VirtualResults=pr.VirtualResults,
        RefOrbitCalc=m("engine.reforbit").RefOrbitCalc)


def deep_params(pkg):
    """The endurance class's LA parameters (``tools/view27_la.py``)."""
    return _mods(pkg).LAParameters(period_divisor=8, low_bound=1)


def mini_ptz(pkg):
    return _mods(pkg).PTZ(pt_x=MINI_CX, pt_y=MINI_CY, zoom_factor=MINI_ZOOM,
                          prec=512).square_aspect_ratio(SIZE, SIZE)


def mini_case(pkg):
    """(ptz, the orbit cut at ORBIT_LEN, its CompressedOrbit) at the mini
    location through `pkg`, as tests/test_view27_pipeline.py builds them."""
    h = _mods(pkg)
    ptz = mini_ptz(pkg)
    res = h.RefOrbitCalc().get_and_create_useful_results(ptz, 50_000)
    res_t = h.PerturbationResults(
        center_x=res.center_x, center_y=res.center_y,
        orbit_x=res.orbit_x[:ORBIT_LEN], orbit_y=res.orbit_y[:ORBIT_LEN],
        max_radius=res.max_radius, period=0, escaped_at=0,
        max_iterations=ORBIT_LEN, precision_bits=res.precision_bits)
    comp = h.CompressedOrbit.from_uncompressed(res_t, error_exp=20)
    return ptz, res_t, comp


def session_view(pkg):
    """(cx, cy, radius, precision) of the session test's view."""
    h = _mods(pkg)
    ptz = h.get_view_preset(SESSION_VIEW).ptz.square_aspect_ratio(64, 64)
    prec = h.precision_from_view(ptz) + 32
    return (ptz.pt_x.with_precision(prec), ptz.pt_y.with_precision(prec),
            ptz.radius, prec)


def la_arrays(la) -> dict:
    """An LA table's node arrays and stage bookkeeping as arrays."""
    out = {f"la_{k}": np.asarray(v) for k, v in la._arrays.items()}
    out.update(la_stage_index=np.asarray(la.stage_la_index, np.int64),
               la_stage_macro=np.asarray(la.stage_macro_it_count, np.int64),
               la_meta=np.asarray([la.stage_count, int(la.use_at),
                                   la.at.step_length if la.use_at else 0,
                                   len(la.las)], np.int64))
    return out


# ---------------------------------------------------------------------------
# The JAX package's side (run in a subprocess, FMA off)


def _jax_gather(res, la, ptz, w, h, n, comp, mode, **kw):
    """The JAX package's two_phase_render through its gather tail in
    `mode` (its rc_tail_gather taken with that mode, as
    tests/test_torch_rc_fast.py _view6_rc_pins does)."""
    import functools

    from fractalshark_tpu.engine import renderers as R
    from fractalshark_tpu.ops import rc_tail as RT

    gather = RT.rc_tail_gather
    RT.rc_tail_gather = functools.partial(gather, mode=mode)
    try:
        return np.asarray(R.two_phase_render(
            res, la, ptz, w, h, n, comp=comp, tail="gather",
            **kw)).astype(np.int64)
    finally:
        RT.rc_tail_gather = gather


def _jax_both_modes(res, la, ptz, w, h, n, comp, **kw):
    """The JAX package's two_phase_render through its gather tail in f64,
    and its df32 tail on the same handoff (one phase 1 for both): (f64
    grid, df32 grid, {"f64_s", "df32_s", "render_s"})."""
    import time

    import jax

    from fractalshark_tpu.engine import renderers as R
    from fractalshark_tpu.ops import rc_tail as RT

    gather = RT.rc_tail_gather
    got, secs = {}, {}

    def both(*a, **k):
        for mode in ("df32", "f64"):
            t = time.perf_counter()
            got[mode] = jax.block_until_ready(gather(*a, mode=mode, **k))
            secs[f"{mode}_s"] = time.perf_counter() - t
        return got["f64"]

    RT.rc_tail_gather = both
    t = time.perf_counter()
    try:
        R.two_phase_render(res, la, ptz, w, h, n, comp=comp, tail="gather",
                           **kw)
    finally:
        RT.rc_tail_gather = gather
    secs["render_s"] = time.perf_counter() - t
    return (*(np.asarray(got[m]).astype(np.int64) for m in MODES), secs)


def _jax_build(comp, radius, la_dir):
    """The JAX package's LA build through the anchor store into `la_dir`,
    read back: (in-RAM table, directory table)."""
    h = _mods("fractalshark_tpu")
    ram = h.NL.generate_native_rc(comp, h.HD.from_hp(radius),
                                  params=deep_params("fractalshark_tpu"))
    os.makedirs(la_dir, exist_ok=True)
    mm, _ = h.NL.generate_native_rc_streamed(
        comp, h.HD.from_hp(radius), params=deep_params("fractalshark_tpu"),
        memmap_dir=la_dir)
    mm.save_meta_npz(la_dir)
    return ram, h.NL.LAReferenceArrays.load_dir(la_dir)


def _jax_pipeline(_inputs):
    """The JAX package at the mini location: its anchors, its LA table
    (the in-RAM build) and the two-phase grids in both gather modes."""
    import tempfile

    h = _mods("fractalshark_tpu")
    ptz, res_t, comp = mini_case("fractalshark_tpu")
    out = {"anchors_x": comp.anchors_x, "anchors_y": comp.anchors_y,
           "anchor_index": comp.anchor_index,
           "total_count": np.asarray(comp.total_count)}
    with tempfile.TemporaryDirectory() as d:
        ram, ld = _jax_build(comp, res_t.max_radius, d)
        out.update(la_arrays(ram))
        virt = h.VirtualResults.from_compressed(comp, res_t.center_x,
                                                res_t.center_y)
        for mode in MODES:
            out[f"grid_{mode}"] = _jax_gather(virt, ld, ptz, SIZE, SIZE,
                                              BUDGET, comp, mode)
    return out


def _view23_rc_pins(_inputs):
    """The JAX package's View #23 at 32² and the preset's budget through
    the driver's composition: the native session (compressed, error_exp
    20) → the LA build through the anchor store into memmaps → load_dir →
    VirtualResults → two_phase_render through the gather tail in f64, and
    the df32 tail on the same handoff; its counts and CRC-32s; and the
    mini location's (iter_sum, CRC-32) in both modes (chip_smoke.py's
    phase 19 pins)."""
    import tempfile
    import time

    h = _mods("fractalshark_tpu")
    v = h.get_view_preset(VIEW23)
    ptz = v.ptz.square_aspect_ratio(SIZE23, SIZE23)
    prec = h.precision_from_view(ptz) + 32
    cx, cy = ptz.pt_x.with_precision(prec), ptz.pt_y.with_precision(prec)
    budget = int(v.num_iterations)
    out = {}
    with tempfile.TemporaryDirectory() as d:
        t0 = time.perf_counter()
        s = h.NO.NativeOrbitSession(
            cx, cy, ptz.radius, precision_bits=prec,
            compression_error_exp=int(v.compression_error_exp_low or 20),
            checkpoint_path=os.path.join(d, "orbit"))
        status = s.run(40_000_000_000, chunk=1 << 22)
        comp = s.compressed()
        t1 = time.perf_counter()
        la_dir = os.path.join(d, "la")
        os.makedirs(la_dir)
        la, _ = h.NL.generate_native_rc_streamed(
            comp, h.HD.from_hp(ptz.radius),
            params=deep_params("fractalshark_tpu"), memmap_dir=la_dir)
        la.save_meta_npz(la_dir)
        la = h.NL.LAReferenceArrays.load_dir(la_dir)
        t2 = time.perf_counter()
        virt = h.VirtualResults.from_compressed(comp, cx, cy)
        f64, df32, secs = _jax_both_modes(virt, la, ptz, SIZE23, SIZE23,
                                          budget, comp,
                                          release_la_tables=True)
        out.update(
            iters_f64=f64, iters_df32=df32,
            orbit=np.asarray([status, comp.total_count, len(comp.anchors_x),
                              rv.anchors_crc(comp), prec, budget], np.int64),
            seconds=np.asarray([t1 - t0, t2 - t1, secs["render_s"],
                                secs["f64_s"], secs["df32_s"]]),
            **la_arrays_meta(la))
    mini_ptz_, res_t, mcomp = mini_case("fractalshark_tpu")
    with tempfile.TemporaryDirectory() as d:
        _, ld = _jax_build(mcomp, res_t.max_radius, d)
        virt = h.VirtualResults.from_compressed(mcomp, res_t.center_x,
                                                res_t.center_y)
        grids = _jax_both_modes(virt, ld, mini_ptz_, SIZE, SIZE, BUDGET,
                                mcomp, release_la_tables=True)
        for mode, grid in zip(MODES, grids):
            out[f"mini_{mode}"] = np.asarray(rv.grid_pin(grid), np.int64)
    return out


def la_arrays_meta(la) -> dict:
    """la_arrays without the node arrays (the View #23 table's 194,628
    nodes stay out of the pins)."""
    return {k: v for k, v in la_arrays(la).items()
            if k in ("la_stage_index", "la_stage_macro", "la_meta")}


# ---------------------------------------------------------------------------
# The port's side (the plain twins)


@pytest.fixture(scope="module")
def pipe(tmp_path_factory):
    """The port's mini pipeline beside the JAX package's (a subprocess):
    the LA table in RAM and through memmaps, read back from its
    directory, and the two-phase grids of each gather mode and of the
    full LAv2 machine over the decompressed orbit."""
    from fractalshark_tpu_torch.engine import renderers as R
    from fractalshark_tpu_torch.ops import la_kernel
    from fractalshark_tpu_torch.ops.rc_tail import rc_tail_gather

    base = tmp_path_factory.mktemp("view27_pipeline")
    jax = ref.Background(ref.run_jax_reference, "test_torch_view27_pipeline",
                         "_jax_pipeline", base)
    h = _mods("fractalshark_tpu_torch")
    ptz, res_t, comp = mini_case("fractalshark_tpu_torch")
    rad = h.HD.from_hp(res_t.max_radius)
    params = deep_params("fractalshark_tpu_torch")
    out = {"comp": comp, "ram": NL.generate_native_rc(comp, rad,
                                                      params=params)}
    d = base / "la_dir"
    d.mkdir()
    out["mm"], out["info"] = NL.generate_native_rc_streamed(
        comp, rad, params=params, memmap_dir=str(d))
    out["mm"].save_meta_npz(str(d))
    ld = out["ld"] = NL.LAReferenceArrays.load_dir(str(d))
    virt = h.VirtualResults.from_compressed(comp, res_t.center_x,
                                            res_t.center_y)
    out["timings"] = {}
    out["f64"] = R.two_phase_render(
        virt, ld, ptz, SIZE, SIZE, BUDGET, comp=comp, device="cpu",
        tail="gather", timings=out["timings"]).numpy()
    init = R.la_handoff(virt, ld, ptz, SIZE, SIZE, BUDGET, device="cpu")
    out["df32"] = rc_tail_gather(comp, res_t.center_x, res_t.center_y, ptz,
                                 SIZE, SIZE, BUDGET, init, mode="df32",
                                 device="cpu").numpy()
    dx, dy = comp.decompress()
    res_rc = h.PerturbationResults(
        center_x=res_t.center_x, center_y=res_t.center_y, orbit_x=dx,
        orbit_y=dy, max_radius=res_t.max_radius, period=0, escaped_at=0,
        max_iterations=ORBIT_LEN, precision_bits=res_t.precision_bits)
    out["full"] = la_kernel.la_perturb_render(
        res_rc, ld, ptz, SIZE, SIZE, BUDGET, sub_dtype=torch.float32,
        device="cpu").numpy()
    out["jax"] = jax.result()
    return out


def test_mini_pipeline_equals_jax_in_each_gather_mode(pipe):
    """The compressed orbit, then the two-phase VirtualResults render
    (phase 1 over a one-row stand-in orbit, the gather tail from the
    anchors) = the JAX package's, bit for bit, in the f64 mode (K19's
    twin) and in df32 (K3's); the budget wraps the orbit several times."""
    jax, comp = pipe["jax"], pipe["comp"]
    for k in ("anchors_x", "anchors_y", "anchor_index"):
        assert ref.bits_equal(getattr(comp, k), jax[k]), k
    assert comp.total_count == int(jax["total_count"]) == 999
    assert comp.compression_ratio() > 1.5
    for mode in MODES:
        np.testing.assert_array_equal(pipe[mode], jax[f"grid_{mode}"],
                                      err_msg=mode)
        assert rv.grid_pin(jax[f"grid_{mode}"]) == cs.MINI_RC_PINS[mode]
    assert pipe["timings"]["tail"] == "gather"
    assert pipe["f64"].max() >= 2 * ORBIT_LEN


def test_two_phase_f64_equals_full_lav2_on_the_decompressed_orbit(pipe):
    """The f64 gather reconstructs exactly ``decompress()``'s values, so
    the two-phase grid = the one-machine LAv2 render over the
    decompressed orbit with the same table (tests/test_view27_pipeline.py
    asserts it for the JAX package's sweep, with FMA on)."""
    np.testing.assert_array_equal(pipe["f64"], pipe["full"])


def test_memmap_build_equals_ram_build_and_jax(pipe):
    """The build through memmaps = the in-RAM build = the JAX package's
    node arrays and stages; low_bound=1 composes down to a terminal
    whole-orbit stage of at most two nodes."""
    ram, mm, jax = pipe["ram"], pipe["mm"], pipe["jax"]
    assert ram is not None and ram.is_valid
    assert pipe["info"]["cnt"] == len(ram.las)
    for k, v in ram._arrays.items():
        np.testing.assert_array_equal(v, mm._arrays[k], err_msg=k)
        assert ref.bits_equal(v, jax[f"la_{k}"]), k
    assert isinstance(mm._arrays["ref_m"].base, np.memmap)
    got = la_arrays(ram)
    for k in ("la_stage_index", "la_stage_macro", "la_meta"):
        np.testing.assert_array_equal(got[k], jax[k], err_msg=k)
    top = ram.stage_count - 1
    assert len(ram.las) - ram.stage_la_index[top] <= 2


def test_directory_round_trip(pipe):
    """save_meta_npz → load_dir gives the table back: node arrays, stage
    indices and macro counts, stage count, AT."""
    ram, ld = pipe["ram"], pipe["ld"]
    for k, v in ram._arrays.items():
        np.testing.assert_array_equal(v, ld._arrays[k], err_msg=k)
    assert ld.stage_la_index == ram.stage_la_index
    assert ld.stage_macro_it_count == ram.stage_macro_it_count
    assert ld.stage_count == ram.stage_count and ld.use_at == ram.use_at
    if ram.use_at:
        assert ld.at.step_length == ram.at.step_length


def test_stage_window_remaps_to_orbit_positions(pipe):
    """stage_window(1) drops stage 0 and remaps the new lowest stage's
    next-indices to the orbit positions they denote: a stage-0 node's
    recorded next index is its orbit start, the prefix sum of the step
    lengths (tests/test_view27_pipeline.py's exact remap property)."""
    ram = pipe["ram"]
    assert ram.stage_count >= 2
    win = pipe["ld"].stage_window(1)
    assert win.stage_count == ram.stage_count - 1
    assert len(win.las) == len(ram.las) - ram.stage_la_index[1]
    a = ram._arrays
    s0 = np.asarray(a["step_length"][:ram.stage_la_index[1]], np.int64)
    pos = np.concatenate([np.zeros(1, np.int64), np.cumsum(s0)])
    live0 = ram.stage_macro_it_count[0]
    np.testing.assert_array_equal(
        pos[:live0],
        np.asarray(a["next_stage_la_index"][:ram.stage_la_index[1]])[:live0])
    end0 = win.stage_la_index[1] if win.stage_count > 1 else len(win.las)
    old = np.asarray(a["next_stage_la_index"][ram.stage_la_index[1]:
                                               ram.stage_la_index[1] + end0],
                     np.int64)
    np.testing.assert_array_equal(
        np.asarray(win._arrays["next_stage_la_index"][:end0]), pos[old])


def test_view23_pins_are_their_grids():
    """artifacts/view23_rc_pins.json (tools/view23_rc_pins.py) describes
    the grids saved beside it, and its mini pins are chip_smoke.py's."""
    art = os.path.join(ref.ROOT, "artifacts")
    with open(os.path.join(art, "view23_rc_pins.json")) as f:
        pins = json.load(f)
    assert (pins["view"], pins["size"]) == (VIEW23, SIZE23)
    grids = {m: np.load(os.path.join(art, name)) for m, name in (
        ("f64", "view23_rc_iters.npy"), ("df32", "view23_rc_iters_df32.npy"))}
    for mode, g in grids.items():
        assert g.dtype == np.int64 and g.shape == (SIZE23, SIZE23)
        rec = pins["grids"][mode]
        assert (rec["iter_sum"], rec["crc32"]) == rv.grid_pin(g)
        assert (rec["iter_min"], rec["iter_max"], rec["capped_px"]) == (
            int(g.min()), int(g.max()), int((g >= pins["budget"]).sum()))
    assert pins["flips_f64_df32"] == int((grids["f64"] != grids["df32"]).sum())
    assert {m: tuple(v) for m, v in pins["mini"].items()} == cs.MINI_RC_PINS
