"""``tools/run_view27_torch.py``, the port's endurance driver, and the
pieces it adds to the pipeline (``two_phase_render``'s
``release_la_tables``, ``stage_window`` on the render path, the native
orbit session's checkpoint), on the CPU (the plain twins) at
``tests/test_torch_view27_pipeline.py``'s mini location, against the JAX
package with FMA contraction off.

The driver's frames run at the mini location's budget (12,000) and, for
its reruns, at 3,000: every pixel escapes past 2,000 iterations there,
so the lower budget still wraps the 999-position orbit.
"""

import contextlib
import io
import json
import os

import numpy as np
import pytest
import torch

import test_torch_jaxref as ref
import test_torch_view27_pipeline as vp

pytestmark = vp.pytestmark

LOW_BUDGET = 3000
CAP_AT = 500            # the driver's orbit, interrupted, then resumed


def _jax_driver(inputs):
    """The JAX package at the mini location: the f64 grid at the budget,
    the stage_window(1) grid with its tables released, the df32 grid at
    LOW_BUDGET; the View #5 session uninterrupted; and, into
    inputs["store"], the store of its tools (run_view27.py's checkpointed
    session, view27_la.py's directory) with the f64 grid rendered from it
    at LOW_BUDGET."""
    import tempfile

    h = vp._mods("fractalshark_tpu")
    ptz, res_t, comp = vp.mini_case("fractalshark_tpu")
    out = {"anchors_crc": np.asarray(rv.anchors_crc(comp))}
    with tempfile.TemporaryDirectory() as d:
        _, ld = vp._jax_build(comp, res_t.max_radius, d)
        virt = h.VirtualResults.from_compressed(comp, res_t.center_x,
                                                res_t.center_y)
        out["grid_f64"] = vp._jax_gather(virt, ld, ptz, vp.SIZE, vp.SIZE,
                                         vp.BUDGET, comp, "f64")
        out["grid_window"] = vp._jax_gather(
            virt, ld.stage_window(1), ptz, vp.SIZE, vp.SIZE, vp.BUDGET, comp,
            "f64", release_la_tables=True)
        out["grid_df32_low"] = vp._jax_gather(
            virt, ld, ptz, vp.SIZE, vp.SIZE, LOW_BUDGET, comp, "df32")

    cx, cy, rad, prec = vp.session_view("fractalshark_tpu")
    s = h.NO.NativeOrbitSession(cx, cy, rad, precision_bits=prec,
                                compression_error_exp=20)
    out["session_status"] = np.asarray(s.run(vp.SESSION_CAP, chunk=7777))
    co = s.compressed()
    out.update(session_x=co.anchors_x, session_y=co.anchors_y,
               session_index=co.anchor_index,
               session_total=np.asarray(co.total_count))

    store = str(inputs["store"])
    os.makedirs(store, exist_ok=True)
    prec = h.precision_from_view(ptz) + 32
    mcx, mcy = ptz.pt_x.with_precision(prec), ptz.pt_y.with_precision(prec)
    s = h.NO.NativeOrbitSession(mcx, mcy, ptz.radius, precision_bits=prec,
                                compression_error_exp=20,
                                checkpoint_path=os.path.join(store, "orbit"))
    s.run(vp.ORBIT_LEN, chunk=1 << 22)
    sc = s.compressed()
    s.close()
    _, sld = vp._jax_build(sc, ptz.radius, os.path.join(store, "la"))
    out["store_grid"] = vp._jax_gather(
        h.VirtualResults.from_compressed(sc, mcx, mcy), sld, ptz, vp.SIZE,
        vp.SIZE, LOW_BUDGET, sc, "f64")
    return out


rv = vp.rv


def _run(out_dir, **kw):
    """The driver on the CPU at the mini location; (record, its printed
    JSON line)."""
    args = dict(size=vp.SIZE, budget=vp.BUDGET, out_dir=str(out_dir),
                device="cpu", ptz=vp.mini_ptz("fractalshark_tpu_torch"))
    args.update(kw)
    buf = io.StringIO()
    # the mini orbit's 999 positions are below auto's gather threshold
    with contextlib.redirect_stdout(buf), pytest.MonkeyPatch.context() as mp:
        mp.setenv("FRACTALSHARK_RC_TAIL", "gather")
        st = rv.run(**args)
    return st, json.loads(buf.getvalue().strip().splitlines()[-1])


def _grid(out_dir, suffix=""):
    return np.load(os.path.join(str(out_dir),
                                f"view27_iters_{vp.SIZE}{suffix}.npy"))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The JAX package (a subprocess) beside the driver's runs: capped at
    CAP_AT, resumed to the period and rendered (f64 at the budget), rerun
    in the same directory (df32 at LOW_BUDGET), and run on the JAX
    package's store (f64 at LOW_BUDGET)."""
    base = tmp_path_factory.mktemp("view27_driver")
    store = base / "jax_store"
    jax = ref.Background(ref.run_jax_reference, "test_torch_view27_driver",
                         "_jax_driver", base, {"store": np.asarray(str(store))})
    d = base / "run"
    out = {"dir": d, "capped": _run(d, max_it=CAP_AT)}
    out["first"] = _run(d)
    with open(os.path.join(str(d), "view27_progress.json")) as f:
        out["progress"] = json.load(f)
    out["rerun"] = _run(d, mode="df32", budget=LOW_BUDGET)
    out["jax"] = jax.result()
    out["store_dir"] = base / "from_jax_store"
    out["store"] = _run(out["store_dir"], budget=LOW_BUDGET,
                        orbit_store=str(store / "orbit"),
                        la_dir=str(store / "la"))
    return out


def test_capped_run_stops_without_a_frame(runs):
    """--max-it before the period: cap_hit, this run's rate, no table
    and no frame."""
    st, line = runs["capped"]
    assert st["phase"] == "cap_hit" and line == st
    assert (st["orbit_iters"], st["orbit_status"], st["period"]) == \
        (CAP_AT, 0, 0)
    assert "la_nodes" not in st and "iter_sum" not in st


def test_resumed_run_equals_jax(runs):
    """Resumed from the capped run's checkpoint: the orbit of the mini
    case (period 999, the JAX package's anchors), then the table and the
    16² frame through the gather tail = the JAX package's f64 grid, with
    the tables released between the phases (so the flag leaves the grid
    as it is: tests/test_torch_view27_pipeline.py renders without it)."""
    st, line = runs["first"]
    jax = runs["jax"]
    assert line == st == runs["progress"]
    assert st["orbit_resumed"] and st["orbit_start_iters"] == CAP_AT
    assert (st["period"], st["total_count"], st["n_anchors"]) == (999, 999, 7)
    assert st["anchors_crc32"] == int(jax["anchors_crc"])
    assert (st["la_cached"], st["la_valid"], st["min_stage"]) == \
        (False, True, 0)
    grid = _grid(runs["dir"])
    np.testing.assert_array_equal(grid, jax["grid_f64"])
    assert st["phase"] == "done" and st["tail"] == "gather"
    assert (st["iter_sum"], st["crc32"]) == rv.grid_pin(grid)
    assert (st["iter_min"], st["iter_max"], st["capped_px"]) == (
        int(grid.min()), int(grid.max()), int((grid >= vp.BUDGET).sum()))
    assert 0 < st["tail_steps_max"] <= st["iter_max"]
    assert st["tail_steps_max"] <= st["tail_steps_sum"] <= st["iter_sum"]
    # the twins run phase 1 in one launch: one step a stage a pixel
    assert (st["phase1_steps"], st["phase1_chain_steps"]) == (
        vp.SIZE * vp.SIZE * st["la_stages"], 0)
    assert st["launches"] == {}     # the plain twins on the CPU


def test_rerun_reuses_the_orbit_and_the_table(runs):
    """A rerun in the same directory computes no orbit step and builds
    no table (its own key checked); its df32 frame = the JAX package's
    df32 gather."""
    st, _ = runs["rerun"]
    assert st["orbit_resumed"] and st["orbit_new_it"] == 0
    assert st["orbit_key_checked"]
    assert st["la_cached"] and st["la_key_checked"]
    assert "la_build_s" not in st
    assert (st["tail"], st["tail_mode"]) == ("gather", "df32")
    np.testing.assert_array_equal(_grid(runs["dir"], "_df32"),
                                  runs["jax"]["grid_df32_low"])


def test_reads_the_jax_store(runs):
    """The JAX tools' store (the checkpointed session's .state/.ax/.ay/
    .ai and the LA directory's la_meta.npz + la_<key>.npy) renders
    through the port to the JAX package's grid, with no orbit step and no
    build."""
    st, _ = runs["store"]
    assert st["orbit_resumed"] and st["orbit_new_it"] == 0
    assert not st["orbit_key_checked"]
    assert st["la_cached"] and not st["la_key_checked"]
    assert (st["period"], st["n_anchors"]) == (999, 7)
    np.testing.assert_array_equal(_grid(runs["store_dir"]),
                                  runs["jax"]["store_grid"])


def test_refuses_another_locations_store(runs):
    """The driver's own store names its location: another view's run in
    the same directory and store raises before any work."""
    with pytest.raises(ValueError, match="another location's orbit"):
        _run(runs["dir"], view=5, ptz=None, budget=100,
             orbit_store=str(runs["dir"] / "view27_orbit"))


def test_v27_store_variables_ignored_at_another_box(tmp_path, monkeypatch):
    """V27_CK and V27_LA_DIR name View #27's own stores: a run with a
    ``ptz`` of its own keeps its store in its directory, and neither
    variable's path is read or made."""
    ck, la = tmp_path / "v27" / "orbit", tmp_path / "v27" / "la"
    monkeypatch.setenv("V27_CK", str(ck))
    monkeypatch.setenv("V27_LA_DIR", str(la))
    d = tmp_path / "run"
    st, _ = _run(d, max_it=CAP_AT)
    assert st["phase"] == "cap_hit"
    assert st["orbit_store"] == os.path.join(str(d), "view27_orbit")
    assert st["la_dir"] == os.path.join(str(d), "view27_la")
    assert not (tmp_path / "v27").exists()


def test_refuses_cuda_without_a_card(tmp_path, monkeypatch):
    """--device cuda where no card is: RuntimeError before any work."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        rv.main(["--view", "23", "--dir", str(tmp_path)])
    assert not os.listdir(str(tmp_path))


def test_release_la_tables_drops_the_tables_and_keeps_the_grid(runs):
    """two_phase_render(release_la_tables=True): the LA table's device
    cache and phase 1's orbit table are gone after the render, and the
    grid is the one without the flag, bit for bit."""
    from fractalshark_tpu_torch.engine import renderers as R

    h = vp._mods("fractalshark_tpu_torch")
    ptz, res_t, comp = vp.mini_case("fractalshark_tpu_torch")
    la = h.NL.generate_native_rc(comp, h.HD.from_hp(res_t.max_radius),
                                 params=vp.deep_params(
                                     "fractalshark_tpu_torch"))
    grids = {}
    for release in (False, True):
        virt = h.VirtualResults.from_compressed(comp, res_t.center_x,
                                                res_t.center_y)
        grids[release] = R.two_phase_render(
            virt, la, ptz, vp.SIZE, vp.SIZE, LOW_BUDGET, comp=comp,
            device="cpu", tail="gather",
            release_la_tables=release).numpy()
        kept = [k for k in virt.extra if k[:1] == ("torch_orbit",)]
        assert bool(la._torch_cache) == (not release)
        assert bool(kept) == (not release)
    np.testing.assert_array_equal(grids[True], grids[False])


def test_stage_window_render_equals_jax(runs):
    """The stage_window(1) table (stage 0 dropped, its role kept through
    the remapped next-indices) with the tables released: the grid = the
    JAX package's, bit for bit, and the cache is empty afterwards."""
    from fractalshark_tpu_torch.engine import renderers as R

    h = vp._mods("fractalshark_tpu_torch")
    ptz, res_t, comp = vp.mini_case("fractalshark_tpu_torch")
    la = h.NL.generate_native_rc(comp, h.HD.from_hp(res_t.max_radius),
                                 params=vp.deep_params(
                                     "fractalshark_tpu_torch"))
    win = la.stage_window(1)
    virt = h.VirtualResults.from_compressed(comp, res_t.center_x,
                                            res_t.center_y)
    grid = R.two_phase_render(virt, win, ptz, vp.SIZE, vp.SIZE, vp.BUDGET,
                              comp=comp, device="cpu", tail="gather",
                              release_la_tables=True).numpy()
    assert not win._torch_cache
    np.testing.assert_array_equal(grid, runs["jax"]["grid_window"])


def test_session_resumed_equals_uninterrupted_and_jax(runs, tmp_path):
    """The native session at View #5, compressed and checkpointed,
    interrupted at 9,000 iterations and resumed from its files = the same
    session uninterrupted = the JAX package's session: anchors, indices,
    total_count and status."""
    h = vp._mods("fractalshark_tpu_torch")
    cx, cy, rad, prec = vp.session_view("fractalshark_tpu_torch")

    def session(**kw):
        return h.NO.NativeOrbitSession(cx, cy, rad, precision_bits=prec,
                                       compression_error_exp=20, **kw)

    whole = session()
    assert whole.run(vp.SESSION_CAP, chunk=7777) == 1
    base = str(tmp_path / "ck")
    s1 = session(checkpoint_path=base)
    assert s1.run(vp.SESSION_STOP, chunk=2000) == 0
    s1.close()
    s2 = session(checkpoint_path=base)
    assert s2._resumed and s2.iters == vp.SESSION_STOP
    assert s2.run(vp.SESSION_CAP, chunk=7777) == 1
    jax = runs["jax"]
    assert int(jax["session_status"]) == 1
    for co in (whole.compressed(), s2.compressed()):
        assert ref.bits_equal(co.anchors_x, jax["session_x"])
        assert ref.bits_equal(co.anchors_y, jax["session_y"])
        np.testing.assert_array_equal(co.anchor_index, jax["session_index"])
        assert co.total_count == int(jax["session_total"]) == 16046
