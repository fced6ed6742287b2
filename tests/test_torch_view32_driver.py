"""``tools/run_view32_torch.py``, the port's View #32 script, on the CPU
(the plain twins) at a small location, against the JAX package's flow
through the same phases: ``compute_reference_orbit_device`` (its split
bookkeeping, the TPU's route, as ``tests/test_torch_orbit.py`` takes it)
→ ``LAReferenceHost.generate_auto`` → ``two_phase_render`` (interpret
mode), with FMA contraction off.

The location is ``tests/test_torch_orbit.py``'s ``"period"`` session: the
1e8 frame's centre, radius 1e-9 (zoom 2e9), a cap of 1,200 iterations in
100-step chunks at that case's 16 limbs; its period, 999, comes inside
the cap.  The frame is 16² at a budget of 1,200.
"""

import contextlib
import importlib.util
import io
import json
import os

import numpy as np
import pytest
import torch

import test_torch_jaxref as ref

CX = "-0.743643887037158704752191506114774"
CY = "0.131825904205311970493132056385139"
ZOOM = "2e9"            # radius 2 / zoom = 1e-9
CAP, CHUNK, LIMBS = 1200, 100, 16
SIZE, BUDGET = 16, 1200
RESUME_AT = 400


def _ptz(pkg):
    return ref.host_layer(pkg).PointZoomBBConverter(
        pt_x=CX, pt_y=CY, zoom_factor=ZOOM, prec=200)


def _jax_reference(inputs):
    from fractalshark_tpu.core.hdr_host import HD
    from fractalshark_tpu.engine.la_reference import LAReferenceHost
    from fractalshark_tpu.engine.renderers import two_phase_render
    from fractalshark_tpu.ops.bignum import fixedpoint as JFP
    from fractalshark_tpu.ops.bignum import orbit as JO

    class _SplitRoute:
        """fixedpoint as orbit.py sees it on the TPU (the fused-tail gate
        open): the session's split host bookkeeping."""
        def __getattr__(self, name):
            return getattr(JFP, name)

        @staticmethod
        def _use_fused_tail(nf, D):
            return True

    JO.FP = _SplitRoute()
    JO.orbit_chunk.clear_cache()
    ptz = _ptz("fractalshark_tpu").square_aspect_ratio(SIZE, SIZE)
    res = JO.compute_reference_orbit_device(
        ptz.pt_x, ptz.pt_y, CAP, ptz.radius, limbs32=LIMBS,
        periodicity=True, chunk_steps=CHUNK)
    la = LAReferenceHost.generate_auto(res.orbit_x, res.orbit_y,
                                       HD.from_hp(res.max_radius),
                                       orbit_e=res.orbit_e)
    grid = two_phase_render(res, la, ptz, SIZE, SIZE, BUDGET,
                            interpret=True)
    return {"meta": np.asarray([res.period, res.escaped_at,
                                res.count_orbit_entries()]),
            "x": res.orbit_x, "y": res.orbit_y,
            "e": (res.orbit_e if res.orbit_e is not None
                  else np.zeros(0, np.int32)),
            "la": np.asarray([la.stage_count, la.is_valid]),
            "grid": np.asarray(grid).astype(np.int64)}


def _load_script():
    path = os.path.join(ref.ROOT, "tools", "run_view32_torch.py")
    spec = importlib.util.spec_from_file_location("run_view32_torch", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


rv = _load_script()


def _run(out_dir, **kw):
    """The script on the CPU at the test's location; (record, its
    printed JSON line)."""
    args = dict(size=SIZE, budget=BUDGET, max_it=CAP, chunk=CHUNK,
                out_dir=str(out_dir), device="cpu", limbs=LIMBS,
                ptz=_ptz("fractalshark_tpu_torch"))
    args.update(kw)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        st = rv.run(**args)
    return st, json.loads(buf.getvalue().strip().splitlines()[-1])


def _orbit(out_dir, st):
    """The orbit a run left in its store."""
    with open(os.path.join(str(out_dir), "view32_orbit.done.json")) as f:
        done = json.load(f)
    ptz = _ptz("fractalshark_tpu_torch").square_aspect_ratio(SIZE, SIZE)
    return rv.stored_orbit(os.path.join(str(out_dir), "view32_orbit"),
                           done, ptz, st["max_it"])


def _grid(out_dir, size=SIZE):
    return np.load(os.path.join(str(out_dir), f"view32_iters_{size}.npy"))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The JAX flow (a subprocess) beside the port's runs: uninterrupted,
    capped at RESUME_AT then resumed, and each's directory."""
    base = tmp_path_factory.mktemp("view32_script")
    jax = ref.Background(ref.run_jax_reference, "test_torch_view32_driver",
                         "_jax_reference", base)
    out = {"straight_dir": base / "straight", "resumed_dir": base / "resumed"}
    out["straight"] = _run(out["straight_dir"])
    with open(os.path.join(str(out["straight_dir"]),
                           "view32_progress.json")) as f:
        out["straight_progress"] = json.load(f)
    out["capped"] = _run(out["resumed_dir"], max_it=RESUME_AT)
    out["resumed"] = _run(out["resumed_dir"])
    out["jax"] = jax.result()
    return out


def _assert_orbit_equals_jax(res, jax):
    period, escaped, count = jax["meta"].tolist()
    assert (res.period, res.escaped_at, res.count_orbit_entries()) == \
        (period, escaped, count)
    assert ref.bits_equal(res.orbit_x, jax["x"])
    assert ref.bits_equal(res.orbit_y, jax["y"])
    e = res.orbit_e if res.orbit_e is not None else np.zeros(0, np.int32)
    np.testing.assert_array_equal(e, jax["e"])


def test_orbit_equals_jax(runs):
    """The script's orbit phase = the JAX device orbit: period, escape,
    length and x/y/e bit for bit; the record names the period."""
    st, line = runs["straight"]
    _assert_orbit_equals_jax(_orbit(runs["straight_dir"], st), runs["jax"])
    assert st["period"] == runs["jax"]["meta"][0] == 999
    assert (st["orbit_len"], st["orbit_new_it"], st["resumed_from"]) == \
        (999, 998, 1)
    assert st["use_hdr_orbit"] is False and st["orbit_cached"] is False
    assert line == st


def test_la_table_and_grid_equal_jax(runs):
    """The LA stage count and the 16² grid = the JAX flow's, and the
    record's statistics are the grid's."""
    st, _ = runs["straight"]
    stages, valid = runs["jax"]["la"].tolist()
    assert (st["la_stages"], st["la_valid"]) == (stages, bool(valid))
    grid = _grid(runs["straight_dir"])
    np.testing.assert_array_equal(grid, runs["jax"]["grid"])
    assert (st["iter_sum"], st["iter_min"], st["iter_max"],
            st["capped_px"]) == (int(grid.sum()), int(grid.min()),
                                 int(grid.max()),
                                 int((grid >= BUDGET).sum()))
    assert st["phase"] == "done" and st["render_timings"]["tail"] == \
        "identity"
    assert runs["straight_progress"] == st


def test_cap_hit_reports_the_projection(runs):
    """A run capped before the period stops at cap_hit with this run's
    rate and the projection, and renders nothing."""
    st, _ = runs["capped"]
    assert st["phase"] == "cap_hit"
    assert (st["period"], st["escaped_at"]) == (0, 0)
    assert (st["orbit_len"], st["orbit_new_it"]) == (RESUME_AT + 1,
                                                     RESUME_AT)
    assert st["projected_s_per_Mit"] == round(
        1e6 * st["orbit_s"] / RESUME_AT, 3)
    assert "la_stages" not in st and "iter_sum" not in st


def test_resumed_run_equals_uninterrupted(runs):
    """The capped run resumed in the same directory (max_it the total
    cap) = the uninterrupted run and the JAX flow: orbit bit for bit, LA
    table and grid."""
    st, _ = runs["resumed"]
    assert st["resumed_from"] == RESUME_AT + 1
    assert st["orbit_new_it"] == 999 - (RESUME_AT + 1)
    _assert_orbit_equals_jax(_orbit(runs["resumed_dir"], st), runs["jax"])
    np.testing.assert_array_equal(_grid(runs["resumed_dir"]),
                                  runs["jax"]["grid"])
    assert st["la_stages"] == runs["straight"][0]["la_stages"]


def test_finished_orbit_is_reused_at_another_size(runs, tmp_path):
    """A rerun in a directory whose orbit has found its period reads the
    orbit back instead of computing it; at 8² its frame = a fresh 8²
    run's, whose orbit is the 16² run's (a square view's box does not
    depend on its size)."""
    cached, _ = _run(runs["straight_dir"], size=8)
    fresh, _ = _run(tmp_path, size=8)
    assert cached["orbit_cached"] and not fresh["orbit_cached"]
    assert cached["period"] == fresh["period"] == 999
    res = _orbit(tmp_path, fresh)
    _assert_orbit_equals_jax(res, runs["jax"])
    np.testing.assert_array_equal(_grid(runs["straight_dir"], 8),
                                  _grid(tmp_path, 8))
    assert _grid(tmp_path, 8).shape == (8, 8)


def test_store_of_another_location_is_refused(runs):
    ptz = ref.host_layer("fractalshark_tpu_torch").PointZoomBBConverter(
        pt_x=CX, pt_y="0.13", zoom_factor=ZOOM, prec=200)
    progress = os.path.join(str(runs["straight_dir"]), "view32_progress.json")
    before = os.stat(progress).st_mtime_ns
    with pytest.raises(ValueError, match="another location"):
        _run(runs["straight_dir"], ptz=ptz)
    assert os.stat(progress).st_mtime_ns == before


def test_cuda_without_cuda_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        _run(tmp_path, device="cuda")
    assert not os.listdir(tmp_path)
