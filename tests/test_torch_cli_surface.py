"""The port's CLI, engine and io surface against the JAX package: the
cases of ``tests/test_cli.py``, ``tests/test_imagina.py``,
``tests/test_commands.py``, ``tests/test_menu.py`` and
``tests/test_io_tools.py`` (the tray's wait for its port) on the port's
own modules, and, through ``test_torch_jaxref.run_jax_reference``, the
outputs that must equal the JAX package's: the console renders, a
locations-file frame, antialiasing, palette PNG bytes, the saved
location, the interactive console's transcript, the ``.im`` writer's
bytes, and the LA presets and stage window (the LA cache keyed on the
parameters that built it)."""

import builtins
import contextlib
import io
import json
import struct
import zlib

import numpy as np
import pytest

import test_torch_jaxref as ref
from fractalshark_tpu_torch import cli
from fractalshark_tpu_torch.core.highprecision import HighPrecision
from fractalshark_tpu_torch.core.pointzoom import PointZoomBBConverter
from fractalshark_tpu_torch.engine.fractal import Fractal

LOCATION = "32 32 -2 -2 2 2 64 1 home view smoke\n"
ASCII = ["--center-x", "-0.75", "--center-y", "0", "--zoom", "1",
         "--width", "32", "--height", "32", "--iterations", "64",
         "--render-algorithm", "Cpu64"]
SMALL = ["--view", "0", "--render-algorithm", "Cpu64", "--width", "16",
         "--height", "16", "--iterations", "96"]
# the 1e8 frame with a valid LA table, its budget cut (K2's full mode)
LA_FRAME = ["--center-x", "-0.743643887037158704752191506114774",
            "--center-y", "0.131825904205311970493132056385139",
            "--zoom", "1e8", "--iterations", "1000", "--width", "8",
            "--height", "8", "--render-algorithm", "GpuHDRx32PerturbedLAv2"]
LA_FLAGS = {"max_perf": ["--la-preset", "max-perf"],
            "min_memory": ["--la-preset", "min-memory"],
            "window2": ["--la-stage-window", "2"],
            "default": []}
KEYS = ["z", "Z", "b", "i", "x"]   # the interactive transcript's input
DEEP = ("-0.743643887037158704752191506114774",
        "0.131825904205311970493132056385139")


def _stdout(main, argv, keys=None) -> str:
    buf = io.StringIO()
    feed = iter(keys or [])

    def fake_input(_prompt=""):
        try:
            return next(feed)
        except StopIteration:
            raise EOFError from None

    saved = builtins.input
    builtins.input = fake_input
    try:
        with contextlib.redirect_stdout(buf):
            assert main(argv) in (0, None)
    finally:
        builtins.input = saved
    return buf.getvalue()


def _stats(main, argv) -> dict:
    return json.loads(_stdout(main, argv + ["--stats"]).strip()
                      .splitlines()[-1])


def _port(argv):
    return argv + ["--device", "cpu"]


def _synthetic_results(pkg):
    """tests/test_imagina.py:156's synthetic orbit: exact-IEEE f64
    z <- z^2 + c at an interior point."""
    import importlib
    PR = importlib.import_module(
        f"{pkg}.engine.perturbation_results").PerturbationResults
    HP = importlib.import_module(f"{pkg}.core.highprecision").HighPrecision
    n = 64
    cx, cy = -0.12, 0.74
    ox, oy = np.zeros(n), np.zeros(n)
    zx = zy = 0.0
    for k in range(n):
        ox[k], oy[k] = zx, zy
        zx, zy = zx * zx - zy * zy + cx, 2.0 * zx * zy + cy
    return PR(center_x=HP("-0.12", prec=256), center_y=HP("0.74", prec=256),
              orbit_x=ox, orbit_y=oy, max_radius=HP("1e-6", prec=64),
              period=0, escaped_at=0, max_iterations=1000,
              precision_bits=256, compression_error_exp=20)


def _seahorse_orbit(pkg):
    import importlib
    rf = importlib.import_module(f"{pkg}.engine.reforbit")
    HP = importlib.import_module(f"{pkg}.core.highprecision").HighPrecision
    return rf.compute_reference_orbit(
        HP(DEEP[0], prec=256), HP(DEEP[1], prec=256), 2000,
        HP("1e-9", prec=64), periodicity=True, precision_bits=256)


def _im_bytes(pkg, results, path) -> np.ndarray:
    import importlib
    importlib.import_module(f"{pkg}.io.imagina").save_orbit_im(path, results)
    with open(path, "rb") as fh:
        return np.frombuffer(fh.read(), np.uint8)


def _jax_reference(inputs):
    from fractalshark_tpu.cli import main
    from fractalshark_tpu.engine.fractal import Fractal as JFractal
    from test_torch_slice import _jax_cli_with_crc

    tmp = str(inputs["tmp"])
    out = {"ascii": np.asarray(_stdout(main, ASCII + ["--console-output",
                                                      "ascii"]))}
    out["ansi"] = np.asarray(_stdout(main, SMALL + ["--console-output",
                                                    "ansi"]))
    loc = f"{tmp}/locs.txt"
    with open(loc, "w") as fh:
        fh.write(LOCATION)
    s = _jax_cli_with_crc(["--locations-file", loc, "--location-index", "0",
                           "--render-algorithm", "Cpu64"])
    out["locations"] = np.asarray([s["iter_sum"], s["crc32"], s["width"]])
    s = _jax_cli_with_crc(SMALL + ["--antialiasing", "2"])
    out["aa2"] = np.asarray([s["iter_sum"], s["crc32"]])
    png = f"{tmp}/palette.png"
    _stdout(main, SMALL + ["--palette", "Summer", "--palette-depth", "12",
                           "--output-png", png])
    out["palette_png"] = np.frombuffer(open(png, "rb").read(), np.uint8)
    saved = f"{tmp}/saved.txt"
    _stdout(main, SMALL + ["--save-location", saved])
    out["saved"] = np.asarray(open(saved).read())
    out["interactive"] = np.asarray(_stdout(
        main, ASCII + ["--interactive"], KEYS))
    f = JFractal(width=24, height=24, view=0, algorithm="Cpu64",
                 num_iterations=80, backend="cpu")
    out["console_ascii"] = np.asarray(f.render_to_console(max_width=12,
                                                          ansi=False))
    for name, flags in LA_FLAGS.items():
        s = _jax_cli_with_crc(LA_FRAME + flags)
        out["la_" + name] = np.asarray([s["iter_sum"], s["crc32"]])
    out["im_synthetic"] = _im_bytes("fractalshark_tpu",
                                    _synthetic_results("fractalshark_tpu"),
                                    f"{tmp}/syn.im")
    out["im_seahorse"] = _im_bytes("fractalshark_tpu",
                                   _seahorse_orbit("fractalshark_tpu"),
                                   f"{tmp}/sea.im")
    return out


@pytest.fixture(scope="module")
def jax_ref(tmp_path_factory):
    d = tmp_path_factory.mktemp("cli_surface")
    return ref.run_jax_reference("test_torch_cli_surface", "_jax_reference",
                                 d, {"tmp": str(d)})


# --------------------------------------------- the outputs equal the JAX's


def test_console_ascii_equals_jax(jax_ref):
    """tests/test_cli.py:38's frame: --console-output ascii, the same
    text."""
    got = _stdout(cli.main, _port(ASCII + ["--console-output", "ascii"]))
    assert got.strip() and got == str(jax_ref["ascii"])


def test_console_ansi_equals_jax(jax_ref):
    got = _stdout(cli.main, _port(SMALL + ["--console-output", "ansi"]))
    assert "\x1b[4" in got and got == str(jax_ref["ansi"])


def test_render_to_console_equals_jax(jax_ref):
    f = Fractal(width=24, height=24, view=0, algorithm="Cpu64",
                num_iterations=80, device="cpu")
    assert f.render_to_console(max_width=12, ansi=False) == \
        str(jax_ref["console_ascii"])


def test_locations_file_frame_equals_jax(jax_ref, tmp_path):
    loc = tmp_path / "locs.txt"
    loc.write_text(LOCATION)
    s = _stats(cli.main, _port(["--locations-file", str(loc),
                                "--location-index", "0",
                                "--render-algorithm", "Cpu64"]))
    assert (s["iter_sum"], s["crc32"], s["width"]) == tuple(
        int(v) for v in jax_ref["locations"])
    assert s["iterations_budget"] == 64


def test_location_index_out_of_range(tmp_path, capsys):
    loc = tmp_path / "locs.txt"
    loc.write_text(LOCATION)
    assert cli.main(_port(["--locations-file", str(loc),
                           "--location-index", "3"])) == 2
    assert "out of range" in capsys.readouterr().err


def test_antialiasing_equals_jax(jax_ref):
    s = _stats(cli.main, _port(SMALL + ["--antialiasing", "2"]))
    assert (s["iter_sum"], s["crc32"]) == tuple(
        int(v) for v in jax_ref["aa2"])


def test_palette_flags_png_equals_jax(jax_ref, tmp_path):
    png = tmp_path / "palette.png"
    _stdout(cli.main, _port(SMALL + ["--palette", "Summer",
                                     "--palette-depth", "12",
                                     "--output-png", str(png)]))
    assert np.array_equal(np.frombuffer(png.read_bytes(), np.uint8),
                          jax_ref["palette_png"])


def test_save_location_equals_jax(jax_ref, tmp_path):
    saved = tmp_path / "saved.txt"
    _stdout(cli.main, _port(SMALL + ["--save-location", str(saved)]))
    assert saved.read_text() == str(jax_ref["saved"])
    from fractalshark_tpu_torch.io.saved_location import load_locations
    (loc,) = load_locations(str(saved))
    assert (loc.width, loc.num_iterations) == (16, 96)


def test_interactive_transcript_equals_jax(jax_ref):
    """--interactive: zoom in, out, back, more iterations, exit; the
    same console frames and status lines."""
    got = _stdout(cli.main, _port(ASCII + ["--interactive"]), KEYS)
    assert "zoom 2^" in got and got == str(jax_ref["interactive"])


@pytest.mark.parametrize("name", list(LA_FLAGS))
def test_la_flags_equal_jax(jax_ref, name):
    """--la-preset and --la-stage-window on the 1e8 frame: the JAX CLI's
    grid."""
    s = _stats(cli.main, _port(LA_FRAME + LA_FLAGS[name]))
    assert s["kernel"] == "lav2-full"
    assert (s["iter_sum"], s["crc32"]) == tuple(
        int(v) for v in jax_ref["la_" + name])


def test_la_cache_is_keyed_on_its_parameters(jax_ref):
    """One orbit rendered under max-accuracy, then max-perf: the second
    render builds its own table (the cache keyed on the parameters) and
    equals a fresh max-perf render of the JAX CLI, not the first table's
    frame."""
    from fractalshark_tpu_torch.engine.la_reference import LAParameters
    from fractalshark_tpu_torch.engine.renderers import get_orbit_calc
    assert tuple(jax_ref["la_max_perf"]) != tuple(jax_ref["la_default"])
    ptz = PointZoomBBConverter(pt_x=DEEP[0], pt_y=DEEP[1], zoom_factor="1e8",
                               prec=512)
    f = Fractal(width=8, height=8, view=ptz,
                algorithm="GpuHDRx32PerturbedLAv2", num_iterations=1000,
                device="cpu")
    grids = []
    for params in (None, LAParameters.max_perf()):
        f.la_parameters = params
        g = f.iters_numpy(f.calc_fractal())
        grids.append((int(g.sum()), cli.grid_crc32(g)))
    assert grids == [tuple(int(v) for v in jax_ref["la_default"]),
                     tuple(int(v) for v in jax_ref["la_max_perf"])]
    (res,) = get_orbit_calc(f).cache
    tables = [k for k in res.extra if isinstance(k, tuple)
              and k[0] == "la_reference"]
    assert len(tables) == 2


def test_im_writer_bytes_equal_jax(jax_ref, tmp_path):
    """The .im writer on the synthetic orbit of tests/test_imagina.py:156
    (its golden length and CRC) and on a computed orbit: the JAX
    writer's bytes."""
    from fractalshark_tpu_torch.io.imagina import save_orbit_im
    p = str(tmp_path / "syn.im")
    save_orbit_im(p, _synthetic_results("fractalshark_tpu_torch"))
    b = open(p, "rb").read()
    assert (len(b), zlib.crc32(b)) == (433, 0x13C5742E)
    assert np.array_equal(np.frombuffer(b, np.uint8), jax_ref["im_synthetic"])
    got = _im_bytes("fractalshark_tpu_torch",
                    _seahorse_orbit("fractalshark_tpu_torch"),
                    str(tmp_path / "sea.im"))
    assert np.array_equal(got, jax_ref["im_seahorse"])


# ------------------------------------- tests/test_cli.py on the port


def test_cli_smoke_view0_png(tmp_path):
    from fractalshark_tpu_torch.io.png import read_png
    out = tmp_path / "view0.png"
    _stdout(cli.main, _port(["--view", "0", "--render-algorithm", "Cpu64",
                             "--width", "64", "--height", "64",
                             "--iterations", "128", "--output-png",
                             str(out), "--stats"]))
    img = read_png(str(out))
    assert img.shape == (64, 64, 4)
    rgb = img[..., :3].astype(np.int64).sum(axis=-1)
    assert (rgb == 0).any() and (rgb > 0).any()


@pytest.mark.parametrize("dtype", [np.uint16, np.uint8])
def test_png_round_trip(tmp_path, dtype):
    from fractalshark_tpu_torch.io.png import read_png, write_png
    if dtype == np.uint16:
        img = np.arange(4 * 5 * 4, dtype=np.uint16).reshape(4, 5, 4) * 977
    else:
        img = np.random.default_rng(0).integers(0, 256, (7, 3, 3),
                                                dtype=np.uint8)
    p = str(tmp_path / "t.png")
    write_png(p, img)
    np.testing.assert_array_equal(read_png(p), img)


def test_save_location_round_trip(tmp_path):
    from fractalshark_tpu_torch.io.saved_location import (
        SavedLocation, load_locations, save_locations)
    loc = SavedLocation(
        width=800, height=600,
        min_x=HighPrecision("-2"), min_y=HighPrecision("-1.5"),
        max_x=HighPrecision("1"), max_y=HighPrecision("1.5"),
        num_iterations=1000, antialiasing=2, description="round trip")
    p = str(tmp_path / "locs.txt")
    save_locations(p, [loc])
    (back,) = load_locations(p)
    assert (back.width, back.num_iterations, back.description) == (
        800, 1000, "round trip")
    assert abs(float(back.min_x) - (-2.0)) < 1e-15


def test_commit_cap_bytes(monkeypatch):
    """--commit-cap-bytes: the frame's buffer is reserved against the
    cap (MemoryError past it, as the reference's CLI), and the orbit
    cache gets the same budget."""
    with pytest.raises(MemoryError):
        cli.main(_port(SMALL + ["--commit-cap-bytes", "64"]))
    from fractalshark_tpu_torch.engine import renderers
    seen = []
    real = renderers.get_orbit_calc

    def spy(f):
        calc = real(f)
        seen.append(calc)
        return calc
    monkeypatch.setattr(renderers, "get_orbit_calc", spy)
    s = _stats(cli.main, _port(SMALL + ["--commit-cap-bytes", "1000000"]))
    assert s["iter_max"] == 96
    assert seen and seen[-1].memory_budget.committed == 16 * 16 * 4


def test_compression_error_exp_flag(monkeypatch):
    """--compression-error-exp-low reaches the fractal (20 without it)."""
    from fractalshark_tpu_torch.engine import fractal as F
    seen = []
    init = F.Fractal.__init__

    def spy(self, *a, **k):
        init(self, *a, **k)
        seen.append(self.compression_error_exp)
    monkeypatch.setattr(F.Fractal, "__init__", spy)
    _stdout(cli.main, _port(SMALL))
    _stdout(cli.main, _port(SMALL + ["--compression-error-exp-low", "12"]))
    assert seen == [20, 12]


# ----------------------------------------- tests/test_imagina.py on the port


def test_mpf_stream_round_trip():
    from fractalshark_tpu_torch.io.imagina import _read_mpf, _write_mpf
    for v in ["0", "1", "-2.5", "0.1",
              "-1.76339917706675269585422012081849339487476471507552e-01",
              "1e-300", "123456789.987654321"]:
        x = HighPrecision(v, prec=512)
        buf = bytearray()
        _write_mpf(buf, x)
        back, off = _read_mpf(bytes(buf), 0, 512)
        assert off == len(buf)
        assert (back - x).is_zero() or \
            abs((back - x).exponent2() - x.exponent2()) > 400, v


@pytest.fixture(scope="module")
def orbit():
    return _seahorse_orbit("fractalshark_tpu_torch")


def test_im_round_trip(tmp_path, orbit):
    from fractalshark_tpu_torch.io.imagina import (SHARKS_MAGIC,
                                                   load_orbit_im,
                                                   save_orbit_im)
    p = str(tmp_path / "orbit.im")
    save_orbit_im(p, orbit)
    with open(p, "rb") as fh:
        assert struct.unpack("<Q", fh.read(8))[0] == SHARKS_MAGIC
    back = load_orbit_im(p)
    assert (back.center_x - orbit.center_x).is_zero()
    assert (back.center_y - orbit.center_y).is_zero()
    res = back.results
    assert res.count_orbit_entries() == orbit.count_orbit_entries()
    assert res.period == orbit.period
    n = res.count_orbit_entries()
    mag = np.hypot(orbit.orbit_x[:n], orbit.orbit_y[:n]) + 1e-30
    err = np.hypot(res.orbit_x[:n] - orbit.orbit_x[:n],
                   res.orbit_y[:n] - orbit.orbit_y[:n]) / mag
    assert err.max() < 2.0 ** -18


def test_engine_save_load_render(tmp_path):
    """Save the orbit of one engine as .im, load it into another, render:
    the frames agree but for boundary pixels the compression flips, and
    the two orbits compare as equal up to it."""
    ptz = PointZoomBBConverter(pt_x=DEEP[0], pt_y=DEEP[1],
                               zoom_factor="1e8", prec=512)
    kw = dict(width=16, height=16, view=ptz,
              algorithm="GpuHDRx32PerturbedLAv2PO", num_iterations=1500,
              device="cpu")
    f1 = Fractal(**kw)
    it1 = f1.iters_numpy(f1.calc_fractal())
    p = str(tmp_path / "o.im")
    f1.save_ref_orbit(p, compression="imagina")
    from fractalshark_tpu_torch.engine.renderers import get_orbit_calc
    saved = get_orbit_calc(f1).cache[-1]
    f2 = Fractal(**kw)
    loaded = f2.load_ref_orbit(p)
    it2 = f2.iters_numpy(f2.calc_fractal())
    assert (it1 == it2).mean() > 0.97
    d = Fractal.diff_ref_orbits(saved, loaded)
    assert d["period_match"] and d["max_abs_dx"] < 1e-5
    assert d["compared"] == min(saved.count_orbit_entries(),
                                loaded.count_orbit_entries())


def test_own_format_save_load(tmp_path):
    ptz = PointZoomBBConverter(pt_x="-0.6", pt_y="0.45", zoom_factor="1e3")
    f = Fractal(width=16, height=16, view=ptz, algorithm="Cpu64PerturbedBLA",
                num_iterations=300, device="cpu")
    f.calc_fractal()
    p = str(tmp_path / "own")
    f.save_ref_orbit(p, compression="none")
    assert f.load_ref_orbit(p, imagina=False).count_orbit_entries() > 0


def test_save_iters_as_text(tmp_path):
    f = Fractal(width=8, height=8, view=0, algorithm="Cpu64",
                num_iterations=32, device="cpu")
    f.calc_fractal()
    p = str(tmp_path / "iters.txt")
    f.save_iters_as_text(p)
    arr = np.loadtxt(p)
    assert arr.shape == (8, 8) and arr.max() <= 32
    np.testing.assert_array_equal(arr, f.iters_numpy())


def test_orbit_parameter_pack_recommendation(tmp_path):
    from fractalshark_tpu_torch.io.imagina import (OrbitParameterPack,
                                                   load_orbit_im)
    ptz = PointZoomBBConverter(pt_x=DEEP[0], pt_y=DEEP[1],
                               zoom_factor="1e8", prec=512)
    kw = dict(width=8, height=8, view=ptz, num_iterations=800, device="cpu")
    f1 = Fractal(algorithm="GpuHDRx32PerturbedLAv2PO", **kw)
    f1.calc_fractal()
    p = str(tmp_path / "o.im")
    f1.save_ref_orbit(p, compression="imagina")
    pack = OrbitParameterPack(load_orbit_im(p))
    assert pack.iter_type_bits == 32 and pack.zoom_exp2 > 20
    alg = pack.recommended_algorithm(has_accelerator=False)
    assert alg.name == "Cpu64"
    f2 = Fractal(algorithm="AUTO", **kw)
    f2.load_ref_orbit(p)
    assert f2.algorithm_name == alg.name
    f3 = Fractal(algorithm="GpuHDRx32PerturbedLAv2PO", **kw)
    f3.load_ref_orbit(p)
    assert f3.algorithm_name == "GpuHDRx32PerturbedLAv2PO"


def test_extended_range_round_trip(tmp_path, orbit):
    from dataclasses import replace

    from fractalshark_tpu_torch.io.imagina import load_orbit_im, save_orbit_im
    dip = 900
    ox, oy = orbit.orbit_x.copy(), orbit.orbit_y.copy()
    oe = np.zeros(len(ox), np.int32)
    ox[dip], oy[dip], oe[dip] = 0.71875, -0.40625, -5000
    deep = replace(orbit, orbit_x=ox, orbit_y=oy, orbit_e=oe)
    p = str(tmp_path / "deep.im")
    save_orbit_im(p, deep)
    res = load_orbit_im(p).results
    assert res.orbit_e is not None and res.orbit_e[dip] == -5000
    assert (res.orbit_x[dip], res.orbit_y[dip]) == (0.71875, -0.40625)
    assert (res.orbit_e[:res.count_orbit_entries()] != 0).sum() == 1
    p2 = str(tmp_path / "deep_f64.im")
    save_orbit_im(p2, deep, extended=False)
    flat = load_orbit_im(p2).results
    assert flat.orbit_e is None
    assert flat.orbit_x[dip] == 0.0 and flat.orbit_y[dip] == 0.0


# --------------------------- tests/test_commands.py and test_menu.py


def _handlers():
    from fractalshark_tpu_torch.core.commands import PortableCommandHandlers
    f = Fractal(width=16, height=16, view=0, algorithm="Cpu64",
                num_iterations=64, device="cpu")
    return f, PortableCommandHandlers(f)


def test_idm_numeric_compatibility():
    from fractalshark_tpu_torch.core.commands import FractalCommand as FC
    assert (FC.ZOOM_IN, FC.STANDARD_VIEW, FC.view(5),
            FC.RESET_ITERATIONS) == (40102, 40200, 40205, 40400)


def test_hotkey_lookup():
    from fractalshark_tpu_torch.core.commands import (
        K_COMMANDS, FractalCommand, find_command_for_key)
    assert find_command_for_key("z") == FractalCommand.ZOOM_IN
    assert find_command_for_key("z", shift=True) == FractalCommand.ZOOM_OUT
    assert find_command_for_key("?") == FractalCommand.NONE
    keys = [(e.hotkey.key, e.hotkey.shift, e.hotkey.ctrl, e.hotkey.alt)
            for e in K_COMMANDS if e.hotkey]
    assert len(keys) == len(set(keys))


def test_zoom_back_and_iteration_commands():
    from fractalshark_tpu_torch.core.commands import FractalCommand as FC
    f, h = _handlers()
    z0 = f.ptz.zoom_factor.exponent2()
    h.dispatch(FC.ZOOM_IN)
    assert f.ptz.zoom_factor.exponent2() == z0 + 1
    h.dispatch(FC.BACK)
    assert f.ptz.zoom_factor.exponent2() == z0
    h.dispatch(FC.INCREASE_ITERATIONS_1P5X)
    assert f.num_iterations == 96
    h.dispatch(FC.RESET_ITERATIONS)
    assert f.num_iterations == 256
    h.dispatch(FC.DECREASE_ITERATIONS)
    assert f.num_iterations == 170
    h.dispatch(FC.view(5))
    assert f.num_iterations == 4718592


def test_palette_aa_save_and_messages(tmp_path):
    from fractalshark_tpu_torch.core.commands import FractalCommand as FC
    from fractalshark_tpu_torch.io.png import read_png
    from fractalshark_tpu_torch.io.saved_location import load_locations
    f, h = _handlers()
    h.dispatch(FC.AA_4X)
    assert f.antialiasing == 2
    h.dispatch(FC.PALETTE_TYPE_3)
    assert f.palette.palette_type == "Summer"
    d0 = f.palette.depth_index
    h.dispatch(FC.PALETTE_DEPTH_NEXT)
    assert f.palette.depth_index == (d0 + 1) % 6
    h.dispatch(FC.AA_1X)
    png = str(tmp_path / "out.png")
    h.dispatch(FC.SAVE_PNG, path=png)
    assert read_png(png).shape == (16, 16, 4)
    loc = str(tmp_path / "loc.txt")
    h.dispatch(FC.SAVE_LOCATION, path=loc, description="cmd test")
    assert load_locations(loc)[0].description == "cmd test"
    h.dispatch(FC.SHOW_HOTKEYS)
    h.dispatch(FC.CUR_POS)
    assert any("Zoom in here" in m for m in h.messages)
    assert any("center=" in m for m in h.messages)
    called = []
    h.on_exit = lambda: called.append(1)
    assert h.dispatch(FC.EXIT) is False and called


def test_autozoom_command_waits_for_its_port():
    from fractalshark_tpu_torch.core.commands import FractalCommand as FC
    _, h = _handlers()
    with pytest.raises(NotImplementedError, match="ROADMAP A5"):
        h.dispatch(FC.AUTOZOOM_DEFAULT)


def test_menu_tree():
    from fractalshark_tpu_torch.core import menu
    from fractalshark_tpu_torch.core.commands import FractalCommand as FC
    assert menu.validate() == []
    labels = [n.label for n, _ in menu.walk()]
    for want in ("Navigate", "Feature Finder", "Direct Scan", "Views",
                 "File", "Save Image (PNG)", "Exit"):
        assert want in labels, want

    class H:
        last_feature = None
        history = ()
        nr_checkpoint_path = None

    def line(txt, label):
        return [ln for ln in txt.splitlines() if label in ln][0]
    txt = menu.render_text(H())
    assert "(disabled)" in line(txt, "Zoom to Found Feature")
    assert "(disabled)" in line(txt, "Back")
    H.last_feature, H.history = object(), (1,)
    assert "(disabled)" not in line(menu.render_text(H()),
                                    "Zoom to Found Feature")
    txt = menu.render_text(checked={menu.RadioGroup.ANTIALIASING: FC.AA_4X})
    assert "(*) 4x" in txt and "( ) 1x" in txt


# ---------------------------- tests/test_io_tools.py:10-60 on the port


def test_parallel_png_round_trip(tmp_path):
    from fractalshark_tpu_torch.io.png import read_png
    from fractalshark_tpu_torch.io.png_parallel import write_png_parallel
    rng = np.random.default_rng(0)
    for shape, dtype in [((50, 33, 4), np.uint16), ((20, 41, 3), np.uint8)]:
        hi = 65536 if dtype == np.uint16 else 256
        img = rng.integers(0, hi, size=shape).astype(dtype)
        p = str(tmp_path / "p.png")
        write_png_parallel(p, img, num_threads=3)
        np.testing.assert_array_equal(read_png(p), img)


def test_orbit_mmap_load(tmp_path):
    from fractalshark_tpu_torch.engine.perturbation_results import \
        PerturbationResults
    from fractalshark_tpu_torch.engine.reforbit import \
        compute_reference_orbit
    res = compute_reference_orbit(
        HighPrecision("-0.6", prec=128), HighPrecision("0.4", prec=128),
        300, HighPrecision("0.5"), periodicity=True, precision_bits=128)
    p = str(tmp_path / "orbit")
    res.save(p)
    back = PerturbationResults.load(p, mmap=True)
    assert isinstance(back.orbit_x, np.memmap)
    np.testing.assert_array_equal(np.asarray(back.orbit_x), res.orbit_x)


def test_cli_perturbation_alg_flag():
    s = _stats(cli.main, _port([
        "--center-x", "-0.6", "--center-y", "0.4", "--zoom", "1e6",
        "--width", "16", "--height", "16", "--iterations", "200",
        "--render-algorithm", "GpuHDRx32PerturbedLAv2PO",
        "--perturbation-alg", "ST"]))
    assert s["orbit_backend"] == "host" and s["iter_max"] > 0


# ------------------------------------------------ utils/profiling.py


def test_device_time_without_a_device_lane():
    """On the CPU the trace has no device lane: total 0.0 with an error,
    as the reference's helper reports it."""
    import torch

    from fractalshark_tpu_torch.utils.profiling import (device_time_ms,
                                                        top_kernels)
    prof = device_time_ms(lambda: torch.ones(8) + 1)
    assert prof["total_ms"] == 0.0 and prof["events"] == 0
    assert "error" in prof
    assert top_kernels({"by_kernel": {"a": 1.0, "b": 3.0, "c": 2.0}},
                       2) == [("b", 3.0), ("c", 2.0)]
