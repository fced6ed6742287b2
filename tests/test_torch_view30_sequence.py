"""``tools/run_view30_torch.py``, the port's View #30 tool (the record run
and the zoom sequence), on the CPU (the plain twins) at a small location,
against the JAX package with FMA contraction off.

The location is ``tests/test_torch_orbit.py``'s ``"period"`` session: the
1e8 frame's centre, radius 1e-9 (zoom 2e9), 16 limbs, a cap of 1,200
iterations in 100-step chunks; its period, 999, comes inside the cap.
Frames are 16² at a budget of 1,200; the sequence has 3 frames at a zoom
step of 1.5.  The port computes the orbit once, and its store hands it to
the JAX reference as numpy arrays (``tests/test_torch_view32_driver.py``
holds that orbit to the JAX device orbit bit for bit).  On the JAX side
every frame is rendered twice: by ``tools/zoomseq_view30.py``'s own
composition (``la_perturb_render(la_only, return_state)``, then
``perturb_render_stream_rc`` over identity anchors,
``zoomseq_view30.py:71-86``) and by ``two_phase_render``, the Pallas
tail in interpret mode.
"""

import contextlib
import io
import json
import os
import time

import numpy as np
import pytest
import torch

import test_torch_jaxref as ref

CX = "-0.743643887037158704752191506114774"
CY = "0.131825904205311970493132056385139"
ZOOM = "2e9"            # radius 2 / zoom = 1e-9
CAP, CHUNK, LIMBS = 1200, 100, 16
SIZE, BUDGET = 16, 1200
FRAMES, STEP = 3, 1.5


def _ptz(pkg):
    return ref.host_layer(pkg).PointZoomBBConverter(
        pt_x=CX, pt_y=CY, zoom_factor=ZOOM, prec=200)


def _boxes(pkg):
    """The sequence's boxes, frame k at zoomed_at_center(1 / STEP^(N-1-k))
    (``zoomseq_view30.py:89-93``)."""
    base = _ptz(pkg).square_aspect_ratio(SIZE, SIZE)
    return [base.zoomed_at_center(1.0 / STEP ** (FRAMES - 1 - k))
            for k in range(FRAMES)]


def _jax_setup(inputs):
    """The JAX package's results on the port's orbit, and its LA table."""
    from fractalshark_tpu.core.hdr_host import HD
    from fractalshark_tpu.engine.la_reference import LAReferenceHost
    from fractalshark_tpu.engine.perturbation_results import \
        PerturbationResults

    base = _ptz("fractalshark_tpu").square_aspect_ratio(SIZE, SIZE)
    res = PerturbationResults(
        center_x=base.pt_x, center_y=base.pt_y, orbit_x=inputs["x"],
        orbit_y=inputs["y"], max_radius=base.radius,
        period=int(inputs["period"]), escaped_at=0, max_iterations=BUDGET,
        precision_bits=base.pt_x.prec, orbit_e=None)
    la = LAReferenceHost.generate_auto(res.orbit_x, res.orbit_y,
                                       HD.from_hp(res.max_radius),
                                       orbit_e=res.orbit_e)
    return res, la


def _jax_tool(inputs):
    """The frames by the JAX tool's composition (zoomseq_view30.py:71-86,
    the tail in interpret mode)."""
    from fractalshark_tpu.engine.perturbation_results import CompressedOrbit
    from fractalshark_tpu.ops import la_kernel
    from fractalshark_tpu.ops.perturb_stream import perturb_render_stream_rc

    res, la = _jax_setup(inputs)
    ident = CompressedOrbit.identity(res)

    def render_frame(ptz):
        st = la_kernel.la_perturb_render(
            res, la, ptz, SIZE, SIZE, BUDGET, sub_dtype=np.float32,
            la_only=True, return_state=True)
        _, _, ref_iter, dzr, dzi, dze, it, _ = st
        it64 = np.asarray(it).astype(np.int64)
        init = {"dzr": np.asarray(dzr), "dzi": np.asarray(dzi),
                "dze": np.asarray(dze), "it": it64,
                "jwait": np.asarray(ref_iter).astype(np.int64),
                "done": (it64 >= BUDGET).astype(np.int32)}
        return np.asarray(perturb_render_stream_rc(
            ident, res.center_x, res.center_y, ptz, SIZE, SIZE, BUDGET,
            init_state=init, interpret=True))

    return {"grids": np.stack([render_frame(p) for p in
                               _boxes("fractalshark_tpu")]).astype(np.int64),
            "la": np.asarray([la.stage_count, la.is_valid])}


def _jax_two_phase(inputs):
    """The frames by JAX ``two_phase_render`` (interpret mode)."""
    from fractalshark_tpu.engine.renderers import two_phase_render

    res, la = _jax_setup(inputs)
    return {"grids": np.stack([np.asarray(two_phase_render(
        res, la, p, SIZE, SIZE, BUDGET, interpret=True))
        for p in _boxes("fractalshark_tpu")]).astype(np.int64)}


def _view6_zoom_pins(_inputs):
    """The JAX package's frames of ``chip_smoke.py`` phase 20's zoom
    sequence (View #6, ``ZOOM_SIZE``², ``ZOOM_FRAMES`` frames at
    ``ZOOM_STEP``, the preset's budget) against one orbit and the one LA
    table of the final radius, by the JAX tool's composition (the tail in
    interpret mode); ``tools/view6_zoom_pins.py`` records them."""
    import types

    import chip_smoke as cs
    from fractalshark_tpu.engine.perturbation_results import CompressedOrbit
    from fractalshark_tpu.ops import la_kernel as jla
    from fractalshark_tpu.ops.perturb_stream import perturb_render_stream_rc

    h = ref.host_layer("fractalshark_tpu")
    g, frames, step = cs.ZOOM_SIZE, cs.ZOOM_FRAMES, cs.ZOOM_STEP
    v = h.get_view_preset(cs.ZOOM_VIEW)
    n = v.num_iterations
    base = v.ptz.square_aspect_ratio(g, g)
    res = h.RefOrbitCalc().get_and_create_useful_results(base, n)
    la = h.get_or_build_la(types.SimpleNamespace(la_parameters=None), res)
    ident = CompressedOrbit.identity(res)
    grids = []
    for k in range(frames):
        ptz = base.zoomed_at_center(1.0 / step ** (frames - 1 - k))
        st = jla.la_perturb_render(res, la, ptz, g, g, n,
                                   sub_dtype=np.float32, la_only=True,
                                   return_state=True)
        _, _, ref_iter, dzr, dzi, dze, it, _ = (np.asarray(a) for a in st)
        it = it.astype(np.int64)
        grids.append(np.asarray(perturb_render_stream_rc(
            ident, res.center_x, res.center_y, ptz, g, g, n, tile_h=g,
            interpret=True, init_state={
                "dzr": dzr, "dzi": dzi, "dze": dze, "it": it,
                "jwait": ref_iter.astype(np.int64),
                "done": (it >= n).astype(np.int32)})))
    return {"grids": np.stack(grids).astype(np.int64),
            "budget": np.asarray(n), "period": np.asarray(res.period)}


def _load_tool():
    import importlib.util
    path = os.path.join(ref.ROOT, "tools", "run_view30_torch.py")
    spec = importlib.util.spec_from_file_location("run_view30_torch", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


rv = _load_tool()


def _run(out_dir, **kw):
    """The tool on the CPU at the test's location; (record, its printed
    JSON line, the sequence's record, its grids)."""
    args = dict(size=SIZE, budget=BUDGET, max_it=CAP, chunk=CHUNK,
                out_dir=str(out_dir), device="cpu", limbs=LIMBS,
                ptz=_ptz("fractalshark_tpu_torch"), frames=FRAMES,
                step=STEP)
    args.update(kw)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        st = rv.run(**args)
    line = json.loads(buf.getvalue().strip().splitlines()[-1])
    with open(os.path.join(str(out_dir), "view30_sequence.json")) as f:
        seq = json.load(f)
    grids = np.load(os.path.join(str(out_dir),
                                 f"view30_sequence_{SIZE}.npy"))
    return st, line, seq, grids


def _stored_orbit(out_dir) -> dict:
    """The port's orbit, read from the store as soon as the port's first
    run has finished it (the frames' render goes on meanwhile), as the
    JAX references' inputs."""
    done_file = os.path.join(str(out_dir), "view30_orbit.done.json")
    deadline = time.monotonic() + 600
    while not os.path.exists(done_file):
        assert time.monotonic() < deadline, "the port's orbit never came"
        time.sleep(0.05)
    with open(done_file) as f:
        done = json.load(f)
    ptz = _ptz("fractalshark_tpu_torch").square_aspect_ratio(SIZE, SIZE)
    res = rv.rv32.stored_orbit(os.path.join(str(out_dir), "view30_orbit"),
                               done, ptz, CAP)
    return {"x": res.orbit_x, "y": res.orbit_y,
            "period": np.asarray(res.period)}


def _jax_on_the_stored_orbit(out_dir, workdir, func):
    return ref.run_jax_reference("test_torch_view30_sequence", func,
                                 workdir, _stored_orbit(out_dir))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The port's run (the orbit computed), its rerun from the store, and
    the two JAX references (side by side) on the first run's orbit."""
    base = tmp_path_factory.mktemp("view30_tool")
    out = {"dir": base / "run"}
    jax = {f: ref.Background(_jax_on_the_stored_orbit, out["dir"], base, f)
           for f in ("_jax_tool", "_jax_two_phase")}
    out["first"] = _run(out["dir"])
    out["rerun"] = _run(out["dir"])
    out["single"] = np.load(os.path.join(str(out["dir"]),
                                         f"view30_iters_{SIZE}.npy"))
    out["jax"] = {f: j.result() for f, j in jax.items()}
    return out


@pytest.mark.parametrize("k", range(FRAMES))
def test_frame_equals_the_jax_tool_and_two_phase_render(runs, k):
    """Frame k of the port's sequence (one orbit, one LA table built at the
    final radius, K2's twin then K6's resumed) = the JAX tool's
    composition = JAX ``two_phase_render``, bit for bit."""
    _, _, seq, grids = runs["first"]
    for composition in ("_jax_tool", "_jax_two_phase"):
        np.testing.assert_array_equal(
            grids[k], runs["jax"][composition]["grids"][k])
    frame = seq["per_frame"][k]
    assert (frame["iter_sum"], frame["crc32"]) == rv.grid_pin(grids[k])
    assert frame["tail"] == "identity"
    assert frame["scale"] == 1.0 / STEP ** (FRAMES - 1 - k)


def test_frames_differ_and_the_table_is_the_final_radius_one(runs):
    """The frames are three views (no two grids alike), against the LA
    table of the final radius: the single frame's stage count = the JAX
    table's."""
    st, _, _, grids = runs["first"]
    assert len({g.tobytes() for g in grids}) == FRAMES
    stages, valid = runs["jax"]["_jax_tool"]["la"].tolist()
    assert (st["la_stages"], st["la_valid"]) == (stages, bool(valid))


def test_last_frame_equals_the_single_frame(runs):
    """The last frame has the single frame's box: 0 differing pixels."""
    st, line, seq, grids = runs["first"]
    np.testing.assert_array_equal(grids[-1], runs["single"])
    assert seq["last_equals_single"] and seq["last_differing_px"] == 0
    assert (st["iter_sum"], st["crc32"]) == rv.grid_pin(runs["single"])
    assert line == st and st["sequence"]["last_equals_single"]


def test_rerun_from_the_store_equals_the_first_run(runs):
    """A second run in the same directory reads the orbit back and gives
    the same single frame and sequence."""
    first, rerun = runs["first"], runs["rerun"]
    assert not first[0]["orbit_cached"] and rerun[0]["orbit_cached"]
    assert rerun[0]["period"] == first[0]["period"] == 999
    np.testing.assert_array_equal(rerun[3], first[3])
    assert [(f["iter_sum"], f["crc32"]) for f in rerun[2]["per_frame"]] == \
        [(f["iter_sum"], f["crc32"]) for f in first[2]["per_frame"]]


def test_record_keeps_the_walls_and_the_tables(runs):
    """The record: each frame's wall and phases, the first frame apart
    from the warm median, Mpix/s, both device tables cached once for every
    frame, no trace on the CPU."""
    _, _, seq, _ = runs["first"]
    walls = [f["wall_s"] for f in seq["per_frame"]]
    assert seq["first_wall_s"] == walls[0]
    assert seq["warm_median_s"] == float(np.median(walls[1:]))
    assert seq["mpix_per_s"] == SIZE * SIZE / seq["warm_median_s"] / 1e6
    assert seq["tables_cached"] == 2
    assert "trace_two_warm_frames" not in seq
    for f in seq["per_frame"]:
        assert f["phase1_s"] + f["phase2_s"] <= f["wall_s"]
        assert f["launches"] == {"lav2_phase1": 0, "two_phase_tail": 0}


def test_png_is_the_grid_coloured(runs):
    """The frame's PNG = the CLI colouring of the saved grid."""
    from fractalshark_tpu_torch.core.palette import FractalPalette
    from fractalshark_tpu_torch.io.png import read_png
    from fractalshark_tpu_torch.ops.coloring import (color_from_iters,
                                                     rgba16_to_rgba8)
    pal = FractalPalette()
    want = rgba16_to_rgba8(color_from_iters(
        torch.from_numpy(runs["single"]), pal.current(), BUDGET,
        pal.aux_depth))
    got = read_png(os.path.join(str(runs["dir"]), f"view30_{SIZE}.png"))
    np.testing.assert_array_equal(got, want)
    assert runs["first"][0]["png_s"] >= 0


def test_trace_check_holds_copies_and_kernel_counts():
    """``check_trace`` passes two warm frames that copied nothing to the
    card and ran K2's and K6's kernels as often as they were counted, and
    raises on a copy, on a traced count that differs from the counter and
    on fewer launches than frames."""
    def trace(k2, k6, copies=0):
        return {"kernels": {"void lav2_kernel<float, false>(...)":
                            {"count": k2, "device_us": 1.0},
                            "void perturb_kernel<float, true>(...)":
                            {"count": k6, "device_us": 1.0},
                            "elementwise_kernel": {"count": 9,
                                                   "device_us": 1.0}},
                "htod_copies": {"count": copies, "device_us": 0.0}}

    counted = {"lav2_phase1": 2, "two_phase_tail": 3}
    rv.check_trace(trace(2, 3), counted, 2)
    for bad in (trace(2, 3, copies=1), trace(1, 3), trace(2, 4)):
        with pytest.raises(AssertionError):
            rv.check_trace(bad, counted, 2)
    with pytest.raises(AssertionError, match="traced 1 times"):
        rv.check_trace(trace(1, 1), {"lav2_phase1": 1,
                                     "two_phase_tail": 1}, 2)


def test_cuda_without_cuda_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        _run(tmp_path, device="cuda")
    assert not os.listdir(tmp_path)
