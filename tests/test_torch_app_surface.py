"""The app surface of the PyTorch/CUDA port on the CPU: the render pool
(``engine/render_pool.py``), autozoom (``engine/autozoom.py`` and the
autozoom commands), the render server (``server.py`` and the CLI's
``--serve``/``--client``/``--socket``/``--warm``/``--shutdown-server``)
and the tray (``tray.py``), with the cases of the JAX package's
``tests/test_render_pool.py``, ``test_autozoom.py``, ``test_server.py``
and ``test_io_tools.py``'s tray cases, their zoom paths, frames and PNG
bytes held to the JAX package's (``run_jax_reference``).  Every render
here takes ``device="cpu"`` (the plain twins); the server in a thread,
every socket wait with its own time limit.
"""

import contextlib
import io
import json
import os
import threading
import time

import numpy as np
import pytest
import torch

import test_torch_jaxref as ref
from fractalshark_tpu_torch import server as srv
from fractalshark_tpu_torch.cli import _strip_transport_flags, main
from fractalshark_tpu_torch.core.pointzoom import PointZoomBBConverter
from fractalshark_tpu_torch.engine.autozoom import (AutoZoomer,
                                                    AutoZoomHeuristic)
from fractalshark_tpu_torch.engine.fractal import Fractal
from fractalshark_tpu_torch.engine.render_pool import RenderThreadPool
from fractalshark_tpu_torch.ops.coloring import rgba16_to_numpy

CPU = ["--device", "cpu"]
SERVER_V0 = ["--view", "0", "--render-algorithm", "Cpu64", "--width", "32",
             "--height", "32", "--iterations", "64", "--stats"]
SERVER_DEEP = ["--center-x", "-0.743643887037158704752191506114774",
               "--center-y", "0.131825904205311970493132056385139",
               "--zoom", "1e8", "--width", "16", "--height", "16",
               "--iterations", "600", "--stats",
               "--render-algorithm", "Cpu64PerturbedBLA"]
TRAY_LOCS = ("24 24 -2 -2 2 2 64 1 home\n"
             "24 24 -1 -1 0 0 32 1 quadrant\n")
POSTER_LOC = "96 96 -2.5 -1.5 1.5 1.5 64 1 poster\n"
FEATURE_TARGET = dict(pt_x="-0.743643887", pt_y="0.131825904",
                      zoom_factor="8", prec=64)


def _view_key(ptz) -> str:
    """A view, exactly: its centre's digits and its zoom's exponent."""
    return (f"{ptz.pt_x.to_string(40)} {ptz.pt_y.to_string(40)} "
            f"{ptz.zoom_factor.to_string(20)}")


def _zoom_path(pkg, heuristic: str, size: int, iters: int, steps: int,
               scale: float, **kw) -> list:
    """The views after each of `steps` autozoom steps from View 0 (Cpu64)."""
    import importlib
    F = importlib.import_module(f"{pkg}.engine.fractal").Fractal
    az = importlib.import_module(f"{pkg}.engine.autozoom")
    f = F(width=size, height=size, view=0, algorithm="Cpu64",
          num_iterations=iters, **kw)
    z = az.AutoZoomer(f, az.AutoZoomHeuristic[heuristic],
                      scale_per_step=scale)
    out = []
    for _ in range(steps):
        z.step()
        out.append(_view_key(f.ptz))
    return out


def _feature_steps(pkg, **kw) -> list:
    import importlib
    F = importlib.import_module(f"{pkg}.engine.fractal").Fractal
    az = importlib.import_module(f"{pkg}.engine.autozoom")
    PZ = importlib.import_module(f"{pkg}.core.pointzoom").PointZoomBBConverter
    f = F(width=16, height=16, view=0, algorithm="Cpu64", num_iterations=64,
          **kw)
    steps = az.AutoZoomer(f).setup_feature_zoom(
        target_ptz=PZ(**FEATURE_TARGET), target_iters=256, max_steps=12)
    return [f"{_view_key(s.ptz)} {s.num_iterations}" for s in steps]


def _tray_pngs(tray_main, workdir: str, extra: list) -> dict:
    """PNG bytes of the tray's renders: the two-location queue (Cpu64)
    and the 96² poster in 32-row bands."""
    out = {}
    loc = os.path.join(workdir, "locs.txt")
    with open(loc, "w") as fh:
        fh.write(TRAY_LOCS)
    d = os.path.join(workdir, "queue")
    assert tray_main([loc, "--out-dir", d, "--render-algorithm", "Cpu64"]
                     + extra) == 0
    for name in sorted(os.listdir(d)):
        with open(os.path.join(d, name), "rb") as fh:
            out["queue_" + name] = np.frombuffer(fh.read(), np.uint8)
    loc = os.path.join(workdir, "poster.txt")
    with open(loc, "w") as fh:
        fh.write(POSTER_LOC)
    d = os.path.join(workdir, "poster")
    assert tray_main([loc, "--out-dir", d, "--tile-rows", "32"] + extra) == 0
    for name in sorted(n for n in os.listdir(d) if n.endswith(".png")):
        with open(os.path.join(d, name), "rb") as fh:
            out["poster_" + name] = np.frombuffer(fh.read(), np.uint8)
    return out


def _jax_reference(inputs):
    from fractalshark_tpu import cli as jcli
    from fractalshark_tpu.tray import main as jtray

    work = str(inputs["workdir"])
    out = {}
    for h, (size, iters, steps, scale) in (("MAX", (48, 128, 3, 2.0)),
                                           ("FILAMENT_TIP", (32, 64, 2, 4.0))):
        out["zoom_" + h] = np.asarray(_zoom_path(
            "fractalshark_tpu", h, size, iters, steps, scale,
            backend="cpu"))
    out["feature_steps"] = np.asarray(_feature_steps("fractalshark_tpu",
                                                     backend="cpu"))
    png = os.path.join(work, "v0.png")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert jcli.main(SERVER_V0 + ["--output-png", png]) == 0
        assert jcli.main(SERVER_DEEP) == 0
    lines = [ln for ln in buf.getvalue().splitlines() if ln.startswith("{")]
    out["v0_iter_sum"] = np.asarray(json.loads(lines[0])["iter_sum"])
    out["deep_iter_sum"] = np.asarray(json.loads(lines[1])["iter_sum"])
    with open(png, "rb") as fh:
        out["v0_png"] = np.frombuffer(fh.read(), np.uint8)
    for k, v in _tray_pngs(jtray, work, []).items():
        out["tray_" + k] = v
    return out


@pytest.fixture(scope="module")
def jax_ref(tmp_path_factory):
    d = tmp_path_factory.mktemp("app_jax")
    return ref.run_jax_reference("test_torch_app_surface", "_jax_reference",
                                 d, {"workdir": str(d)})


# ----------------------------------------------------------- render pool
# (tests/test_render_pool.py)


def make_pool(**kw):
    f = Fractal(width=32, height=32, view=0, algorithm="Cpu64",
                num_iterations=64, device="cpu")
    return f, RenderThreadPool(f, **kw)


def test_progressive_frames_arrive_in_order():
    f, pool = make_pool(num_workers=1, progressive_scales=(4, 1))
    try:
        gen = pool.enqueue_render()
        first = pool.next_frame(timeout=60)
        assert first is not None and first.generation == gen
        assert not first.final
        assert first.rgba.shape == (8, 8, 4)
        final = pool.next_frame(timeout=60)
        assert final is not None and final.final
        assert final.rgba.shape == (32, 32, 4)
    finally:
        pool.shutdown()


def test_supersede_drops_stale():
    f, pool = make_pool(num_workers=1, progressive_scales=(1,))
    try:
        pool.enqueue_render()
        pool.enqueue_render()
        g3 = pool.enqueue_render()
        pool.wait_idle(timeout=60)
        finals = []
        while True:
            fr = pool.next_frame(timeout=2)
            if fr is None:
                break
            if fr.final:
                finals.append(fr.generation)
        assert g3 in finals
        assert all(g <= g3 for g in finals)
    finally:
        pool.shutdown()


def test_mutation_runs_on_pool():
    f, pool = make_pool(num_workers=1, progressive_scales=(1,))
    try:
        def mutate(fr):
            fr.num_iterations = 99

        pool.enqueue_mutation(mutate)
        frame = pool.next_frame(timeout=60)
        assert frame is not None
        assert f.num_iterations == 99
    finally:
        pool.shutdown()


def test_abort_flag_stops_work():
    f, pool = make_pool(num_workers=1, progressive_scales=(4, 1))
    try:
        pool.abort_flag.set()
        pool.enqueue_render()
        frame = pool.next_frame(timeout=3)
        assert frame is None
    finally:
        pool.shutdown()


def test_two_workers_over_one_fractal_equal_one_shot_renders():
    """C9: two workers render jobs of one Fractal (a deep perturbed frame,
    whose orbit cache and the orbit's device table both share) under the
    pool's device lock; every final frame equals a one-shot render of its
    view, and no two renders ran at once."""
    ptz = PointZoomBBConverter(
        pt_x="-0.743643887037158704752191506114774",
        pt_y="0.131825904205311970493132056385139", zoom_factor="1e8",
        prec=512)
    f = Fractal(width=16, height=16, view=ptz,
                algorithm="GpuHDRx32PerturbedLAv2PO", num_iterations=1000,
                device="cpu")
    pool = RenderThreadPool(f, num_workers=2, progressive_scales=(1,))
    inside, most = [0], [0]
    lock = pool.device_lock

    class _Watched:
        """The device lock, counting the renders inside it."""
        def __enter__(self):
            lock.acquire()
            inside[0] += 1
            most[0] = max(most[0], inside[0])

        def __exit__(self, *exc):
            inside[0] -= 1
            lock.release()

    pool.device_lock = _Watched()
    try:
        budgets = (1000, 1200, 900)
        gens = []
        for n in budgets:
            gens.append(pool.enqueue_mutation(
                lambda fr, n=n: setattr(fr, "num_iterations", n),
                supersedable=False))
        for g in gens:
            assert pool.wait(g, timeout=120)
        frames = {}
        while True:
            fr = pool.next_frame(timeout=2)
            if fr is None:
                break
            frames[fr.view["num_iterations"]] = fr.rgba
        assert set(frames) == set(budgets)
        for n in budgets:
            one = Fractal(width=16, height=16, view=ptz,
                          algorithm="GpuHDRx32PerturbedLAv2PO",
                          num_iterations=n, device="cpu")
            np.testing.assert_array_equal(frames[n],
                                          rgba16_to_numpy(one.render()))
        assert most[0] == 1
    finally:
        pool.shutdown()


# ----------------------------------------------------------- autozoom
# (tests/test_autozoom.py)


def test_autozoom_max_descends(jax_ref):
    f = Fractal(width=48, height=48, view=0, algorithm="Cpu64",
                num_iterations=128, device="cpu")
    z0 = f.ptz.zoom_factor.exponent2()
    az = AutoZoomer(f, AutoZoomHeuristic.MAX, scale_per_step=2.0)
    log = az.run(3)
    assert len(log) == 3
    assert f.ptz.zoom_factor.exponent2() == z0 + 3
    iters = f.iters_numpy(f.calc_fractal())
    assert iters.min() < iters.max()
    # the zoom path, step by step, is the JAX package's
    np.testing.assert_array_equal(
        _zoom_path("fractalshark_tpu_torch", "MAX", 48, 128, 3, 2.0,
                   device="cpu"), jax_ref["zoom_MAX"])


def test_autozoom_filament(jax_ref):
    f = Fractal(width=32, height=32, view=0, algorithm="Cpu64",
                num_iterations=64, device="cpu")
    az = AutoZoomer(f, AutoZoomHeuristic.FILAMENT_TIP, scale_per_step=4.0)
    az.run(2)
    assert f.ptz.zoom_factor.exponent2() >= 4
    np.testing.assert_array_equal(
        _zoom_path("fractalshark_tpu_torch", "FILAMENT_TIP", 32, 64, 2, 4.0,
                   device="cpu"), jax_ref["zoom_FILAMENT_TIP"])


def test_feature_zoom_pipeline_presents_every_frame(jax_ref):
    f = Fractal(width=16, height=16, view=0, algorithm="Cpu64",
                num_iterations=64, device="cpu")
    pool = RenderThreadPool(f, num_workers=2)
    try:
        az = AutoZoomer(f)
        steps = az.setup_feature_zoom(
            target_ptz=PointZoomBBConverter(**FEATURE_TARGET),
            target_iters=256, max_steps=12)
        assert len(steps) == 12
        its = [s.num_iterations for s in steps]
        assert its == sorted(its) and its[-1] == 256
        np.testing.assert_array_equal(
            [f"{_view_key(s.ptz)} {s.num_iterations}" for s in steps],
            jax_ref["feature_steps"])
        res = az.run_feature_zoom_pipeline(pool, steps, interval_s=0.01)
        assert not res["aborted"]
        assert res["presented"] == len(steps)
        gens = [g for g, _ in res["frames"]]
        assert gens == sorted(gens)
        times = [t for _, t in res["frames"]]
        assert all(b - a >= 0.009 for a, b in zip(times, times[1:]))
        assert f.num_iterations == 256
        assert f.ptz.zoom_factor.exponent2() == \
            steps[-1].ptz.zoom_factor.exponent2()
    finally:
        pool.shutdown()


def test_feature_zoom_pipeline_abort_restores_view():
    f = Fractal(width=16, height=16, view=0, algorithm="Cpu64",
                num_iterations=64, device="cpu")
    pool = RenderThreadPool(f, num_workers=1)
    try:
        az = AutoZoomer(f)
        target = PointZoomBBConverter(pt_x="-0.75", pt_y="0.1",
                                      zoom_factor="64", prec=64)
        steps = az.setup_feature_zoom(target_ptz=target, max_steps=30)
        abort = threading.Event()
        presented = []

        def on_frame(frame):
            presented.append(frame.generation)
            if len(presented) == 4:
                abort.set()

        res = az.run_feature_zoom_pipeline(pool, steps, on_frame=on_frame,
                                           abort_flag=abort, timeout_s=120)
        assert res["aborted"]
        assert res["presented"] < len(steps)
        assert pool.last_presented_view is not None
        assert f.ptz.zoom_factor.exponent2() == \
            pool.last_presented_view["ptz"].zoom_factor.exponent2()
    finally:
        pool.shutdown()


def test_pool_wait_and_groups():
    f = Fractal(width=16, height=16, view=0, algorithm="Cpu64",
                num_iterations=32, device="cpu")
    pool = RenderThreadPool(f, num_workers=1)
    try:
        g1 = pool.begin_paced_animation()
        g2 = pool.begin_paced_animation()
        assert g1 != g2
        gen = pool.enqueue_mutation(lambda fr: None, supersedable=False,
                                    group=g1, final_only=True)
        assert pool.wait(gen, timeout=30.0)
        pool.cancel_paced_animation(g1)
        frame = pool.next_frame(timeout=1.0)
        assert frame is None or frame.group != g1
    finally:
        pool.shutdown()


def test_zoom_to_feature():
    f = Fractal(width=24, height=24,
                view=PointZoomBBConverter(pt_x="-1.7549", pt_y="1e-6",
                                          zoom_factor="1e4", prec=256),
                algorithm="Cpu64", num_iterations=2000, device="cpu")
    feat = f.try_find_periodic_point(max_period=50)
    assert feat is not None and feat.period == 3
    f.zoom_to_feature(feat)
    assert abs(float(f.ptz.pt_x - feat.center_x)) < 1e-12
    iters = f.iters_numpy(f.calc_fractal())
    assert iters[12, 12] == f.num_iterations


def test_autozoom_command_runs_the_zoomer(jax_ref):
    """The autozoom commands of ``core/commands.py`` run the zoomer (no
    "ROADMAP A5" raise): AUTOZOOM_MAX's path is the zoomer's, and BACK
    returns to the view before it."""
    from fractalshark_tpu_torch.core.commands import (FractalCommand as FC,
                                                      PortableCommandHandlers)
    f = Fractal(width=48, height=48, view=0, algorithm="Cpu64",
                num_iterations=128, device="cpu")
    before = _view_key(f.ptz)
    h = PortableCommandHandlers(f)
    for k in range(3):
        h.dispatch(FC.AUTOZOOM_MAX, steps=1)
        assert _view_key(f.ptz) == jax_ref["zoom_MAX"][k]
    h.dispatch(FC.BACK)
    assert _view_key(f.ptz) == jax_ref["zoom_MAX"][1]
    h.dispatch(FC.AUTOZOOM_FILAMENT, steps=1)
    assert _view_key(f.ptz) != before


# ----------------------------------------------------------- server
# (tests/test_server.py)


@pytest.fixture
def live_server(tmp_path):
    sock = str(tmp_path / "fsk.sock")
    s = srv.RenderServer(sock)
    ready = threading.Event()
    t = threading.Thread(
        target=s.serve_forever,
        kwargs={"ready_cb": lambda _s: ready.set()}, daemon=True)
    t.start()
    assert ready.wait(10.0)
    yield s, sock
    try:
        srv.request({"op": "shutdown"}, sock, timeout=10.0)
    except OSError:
        pass
    t.join(timeout=10.0)


def test_ping_stats_and_shutdown(tmp_path):
    sock = str(tmp_path / "fsk.sock")
    s = srv.RenderServer(sock)
    ready = threading.Event()
    t = threading.Thread(
        target=s.serve_forever,
        kwargs={"ready_cb": lambda _s: ready.set()}, daemon=True)
    t.start()
    assert ready.wait(10.0)
    assert srv.server_alive(sock)
    st = srv.request({"op": "stats"}, sock, timeout=10.0)
    assert st["ok"] and st["requests"] == 0
    resp = srv.request({"op": "shutdown"}, sock, timeout=10.0)
    assert resp.get("shutdown")
    t.join(timeout=10.0)
    assert not t.is_alive()
    assert not srv.server_alive(sock)


def test_render_through_server(live_server, tmp_path, capsys, jax_ref):
    """A render through the server: rc 0, the stats of an in-process
    render, and PNG bytes equal to the JAX package's direct render."""
    s, sock = live_server
    png = tmp_path / "v0.png"
    rc = srv.run_client(SERVER_V0 + CPU + ["--output-png", str(png)], sock)
    assert rc == 0
    out = capsys.readouterr().out
    assert '"iter_sum"' in out and png.exists()
    main(SERVER_V0 + CPU)
    direct = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    via = json.loads([ln for ln in out.splitlines()
                      if ln.startswith("{")][-1])
    assert via["iter_sum"] == direct["iter_sum"] == int(jax_ref["v0_iter_sum"])
    np.testing.assert_array_equal(np.frombuffer(png.read_bytes(), np.uint8),
                                  jax_ref["v0_png"])


def test_orbit_cache_shared_across_requests(live_server, jax_ref):
    s, sock = live_server
    req = SERVER_DEEP + CPU
    r1 = srv.request({"argv": req}, sock, timeout=300.0)
    assert r1["rc"] == 0, r1["stderr"]
    st = srv.request({"op": "stats"}, sock, timeout=10.0)
    n_orbits = st["orbit_cache_len"]
    assert n_orbits >= 1
    r2 = srv.request({"argv": req}, sock, timeout=300.0)
    assert r2["rc"] == 0, r2["stderr"]
    st2 = srv.request({"op": "stats"}, sock, timeout=10.0)
    assert st2["orbit_cache_len"] == n_orbits
    assert st2["requests"] == 2
    s1 = json.loads(r1["stdout"].strip().splitlines()[-1])
    s2 = json.loads(r2["stdout"].strip().splitlines()[-1])
    assert s1["iter_sum"] == s2["iter_sum"] == int(jax_ref["deep_iter_sum"])


def test_server_survives_bad_requests(live_server):
    """Bad requests answer rc 2; a render that raises answers rc 1 with
    the error in stderr (the reference's report, not a fallback), and the
    server goes on."""
    s, sock = live_server
    r = srv.request({"argv": "not-a-list"}, sock, timeout=10.0)
    assert r["rc"] == 2
    r = srv.request({"argv": ["--view", "99999"] + CPU}, sock, timeout=30.0)
    assert r["rc"] == 2
    r = srv.request({"argv": SERVER_V0 + ["--device", "cuda:99"]}, sock,
                    timeout=30.0)
    assert r["rc"] != 0
    assert srv.server_alive(sock)


def test_strip_transport_flags():
    argv = ["--client", "--socket", "/x/y.sock", "--view", "3",
            "--socket=/z.sock", "--serve", "--width", "8"]
    assert _strip_transport_flags(argv) == ["--view", "3", "--width", "8"]


def test_cli_client_and_shutdown_flags(live_server, capsys):
    _, sock = live_server
    rc = main(["--client", "--socket", sock, "--view", "0",
               "--render-algorithm", "Cpu64", "--width", "16",
               "--height", "16", "--iterations", "32", "--stats"] + CPU)
    assert rc == 0
    assert '"iter_sum"' in capsys.readouterr().out
    rc = main(["--shutdown-server", "--socket", sock])
    assert rc == 0
    time.sleep(0.1)
    assert not srv.server_alive(sock)


def test_serve_flag_warms_and_serves(tmp_path):
    """``--serve --warm 0`` in a thread: it renders the preset once at
    start-up, serves a client, and exits on --shutdown-server."""
    sock = str(tmp_path / "warm.sock")
    out = io.StringIO()
    rcs = []

    def serve():
        with contextlib.redirect_stdout(out):
            rcs.append(main(["--serve", "--socket", sock, "--warm", "0"]
                            + CPU))

    t = threading.Thread(target=serve, daemon=True)
    t.start()
    deadline = time.monotonic() + 120
    while not srv.server_alive(sock):
        assert time.monotonic() < deadline and t.is_alive()
        time.sleep(0.05)
    st = srv.request({"op": "stats"}, sock, timeout=10.0)
    assert st["requests"] == 1
    r = srv.request({"argv": SERVER_V0 + CPU}, sock, timeout=60.0)
    assert r["rc"] == 0, r["stderr"]
    assert srv.request({"op": "shutdown"}, sock, timeout=10.0)["shutdown"]
    t.join(timeout=10.0)
    assert rcs == [0]
    assert '"warmed": "0"' in out.getvalue()


# ----------------------------------------------------------- tray
# (tests/test_io_tools.py:36, :86)


def test_tray_queue_and_poster_equal_jax(tmp_path, jax_ref):
    """The tray's two-location queue and its poster mode write the PNGs
    the JAX tray writes, byte for byte; a second poster run resumes from
    its checkpointed bands (nothing rendered again) and writes the same
    file."""
    from fractalshark_tpu_torch.parallel import tile_farm
    from fractalshark_tpu_torch.tray import main as tray_main
    got = _tray_pngs(tray_main, str(tmp_path), CPU)
    want = {k[len("tray_"):]: v for k, v in jax_ref.items()
            if k.startswith("tray_")}
    assert sorted(got) == sorted(want) and len(got) == 3
    for k in got:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    from fractalshark_tpu_torch.io.png import read_png
    q = sorted(n for n in os.listdir(tmp_path / "queue"))
    assert read_png(str(tmp_path / "queue" / q[0])).shape == (24, 24, 4)
    d = tmp_path / "poster"
    png = next(n for n in os.listdir(d) if n.endswith(".png"))
    first = (d / png).read_bytes()
    calls = []
    run = tile_farm.TileFarm.run

    def counted(self, render_tile, *a, **kw):
        calls.append(len(self.pending()))
        return run(self, render_tile, *a, **kw)

    tile_farm.TileFarm.run = counted
    try:
        assert tray_main([str(tmp_path / "poster.txt"), "--out-dir", str(d),
                          "--tile-rows", "32"] + CPU) == 0
    finally:
        tile_farm.TileFarm.run = run
    assert calls == [0]
    assert (d / png).read_bytes() == first
    assert any(n.endswith(".npy") for n in os.listdir(d / "tiles_000"))


def test_tray_without_locations_is_rc_2(tmp_path):
    from fractalshark_tpu_torch.tray import main as tray_main
    loc = tmp_path / "empty.txt"
    loc.write_text("")
    assert tray_main([str(loc), "--out-dir", str(tmp_path)] + CPU) == 2


def test_iters_of_pool_frames_are_numpy_uint16():
    """A pool frame is the RGBA16 of the render as numpy uint16."""
    f, pool = make_pool(num_workers=1, progressive_scales=(1,))
    try:
        pool.enqueue_render()
        fr = pool.next_frame(timeout=60)
        assert fr.rgba.dtype == np.uint16
        one = Fractal(width=32, height=32, view=0, algorithm="Cpu64",
                      num_iterations=64, device="cpu")
        np.testing.assert_array_equal(fr.rgba, rgba16_to_numpy(one.render()))
        assert torch.is_tensor(one.render())
    finally:
        pool.shutdown()


def test_import_walk_reaches_the_app_surface():
    """The port's AST import walk (``tests/test_torch_slice.py``) reaches
    this slice's modules, and none imports jax or the JAX package."""
    import test_torch_slice as sl
    srcs = {os.path.relpath(p, ref.ROOT) for p in sl._port_sources()}
    pkg = "fractalshark_tpu_torch/"
    assert {pkg + m for m in (
        "server.py", "tray.py", "parallel/__init__.py",
        "parallel/tile_farm.py", "engine/render_pool.py",
        "engine/autozoom.py", "ops/rc_tail.py")} <= srcs
    sl.test_port_imports_neither_jax_nor_the_jax_package()
