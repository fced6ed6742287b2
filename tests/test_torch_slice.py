"""The port's slice end to end on the CPU (``--device cpu``, the kernels'
plain twins): ``Fractal`` and the CLI against ``fractalshark_tpu``'s
CLI (View 0, View #6, and the ``Gpu1x64PerturbedLAv2`` band on Views
#2, #3 and #5), every LAv2 algorithm's route, and the proof that a
render never imports jax.
"""

import contextlib
import io
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import test_torch_jaxref as ref
from fractalshark_tpu_torch import cli
from fractalshark_tpu_torch.engine.fractal import Fractal

VIEW0 = ["--view", "0", "--width", "128", "--height", "128"]
DEEP = ["--view", "6", "--width", "32", "--height", "32",
        "--render-algorithm", "GpuHDRx32PerturbedLAv2"]
VIEW6_32 = (817_235_786, 2_300_363_464)  # JAX CPU, FMA contraction off
STAT_KEYS = ("algorithm", "width", "height", "iterations_budget",
             "iter_min", "iter_max", "iter_sum")
# 32² frames of the f64 band (2^46-2^200 zoom), (iter_sum, CRC-32 of the
# grid as <u4), JAX CPU with FMA contraction off: View #2 has no valid LA
# table, so Gpu1x64PerturbedLAv2 falls back to the f64 float render and
# the PO name renders HDR-f32; Views #3 and #5 run the f64 LA machine
BAND = {
    "v2": (["--view", "2", "--render-algorithm", "Gpu1x64PerturbedLAv2"],
           (59_958, 538_599_484), "perturb-f64"),
    "v2_po": (["--view", "2", "--render-algorithm",
               "GpuHDRx32PerturbedLAv2PO"], (59_958, 538_599_484),
              "perturb-pallas"),
    "v3": (["--view", "3", "--render-algorithm", "Gpu1x64PerturbedLAv2"],
           (15_395_230, 724_198_528), "lav2-f64"),
    "v5": (["--view", "5", "--render-algorithm", "Gpu1x64PerturbedLAv2"],
           (89_887_493, 1_005_684_374), "lav2-f64"),
    # AUTO on the CPU: Cpu64PerturbedBLAV2HDR, hdr64 without an LA table
    "v2_auto": (["--view", "2"], (59_958, 538_599_484), "perturb-hdr64"),
}
SMALL_DEEP = ["--center-x", "-0.743643887037158704752191506114774",
              "--center-y", "0.131825904205311970493132056385139",
              "--zoom", "1e8", "--iterations", "2000"]


def _run(main, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(argv)
    assert rc in (0, None)
    return json.loads(buf.getvalue().strip().splitlines()[-1])


def _jax_cli_with_crc(argv) -> dict:
    """The JAX CLI's --stats, plus the CRC-32 of its grid as <u4."""
    import zlib

    from fractalshark_tpu.cli import main
    from fractalshark_tpu.engine import fractal as F

    grids = []
    stats = F.Fractal.stats

    def keep(self, iters=None):
        grids.append(np.asarray(self._iters_cache))
        return stats(self, iters)

    F.Fractal.stats = keep
    try:
        s = _run(main, argv + ["--stats"])
    finally:
        F.Fractal.stats = stats
    s["crc32"] = zlib.crc32(grids[-1].astype("<u4").tobytes())
    return s


def _jax_reference(inputs):
    from fractalshark_tpu.cli import main

    png = str(inputs["png"])
    out = {k: np.asarray(v) for k, v in _run(
        main, VIEW0 + ["--output-png", png, "--stats"]).items()
        if k in STAT_KEYS}
    out["png_bytes"] = np.frombuffer(open(png, "rb").read(), np.uint8)
    for k, v in _run(main, DEEP + ["--stats"]).items():
        if k in STAT_KEYS:
            out["deep_" + k] = np.asarray(v)
    for name, (argv, _, _) in BAND.items():
        s = _jax_cli_with_crc(argv + ["--width", "32", "--height", "32"])
        for k in STAT_KEYS + ("crc32",):
            out[f"{name}_{k}"] = np.asarray(s[k])
    return out


@pytest.fixture(scope="module")
def jax_ref(tmp_path_factory):
    d = tmp_path_factory.mktemp("slice")
    return ref.run_jax_reference("test_torch_slice", "_jax_reference", d,
                                 {"png": str(d / "jax_view0.png")})


def test_view0_png_and_stats_equal_jax(jax_ref, tmp_path):
    png = tmp_path / "port_view0.png"
    s = _run(cli.main, VIEW0 + ["--output-png", str(png), "--stats",
                                "--device", "cpu"])
    for k in STAT_KEYS:
        assert s[k] == jax_ref[k].item(), k
    assert s["algorithm"] == "Cpu64" and s["kernel"] == "escape"
    assert png.read_bytes() == jax_ref["png_bytes"].tobytes()


def test_deep_frame_equals_jax(jax_ref):
    s = _run(cli.main, DEEP + ["--stats", "--device", "cpu"])
    for k in STAT_KEYS:
        assert s[k] == jax_ref["deep_" + k].item(), k
    assert (s["iter_sum"], s["crc32"]) == VIEW6_32
    assert s["kernel"] == "lav2-two-phase"
    assert {"phase1_s", "phase2_s"} <= set(s["timings"])


def test_render_never_imports_jax(tmp_path):
    """A shallow render, a perturbation-only one (View #2, no valid LA
    table) and a deep LA one through the port, in a fresh interpreter
    whose environment sets none of the JAX package's switches: neither
    jax nor the JAX package gets imported."""
    code = (
        "import sys\n"
        "from fractalshark_tpu_torch.cli import main\n"
        "for v in ('0', '2', '6'):\n"
        "    assert main(['--view', v, '--width', '16', '--height', '16',\n"
        "                 '--device', 'cpu', '--stats']) == 0\n"
        "assert 'jax' not in sys.modules, 'jax was imported'\n"
        "assert 'fractalshark_tpu' not in sys.modules, 'JAX package'\n"
        "print('NO_JAX_OK')\n")
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("FRACTALSHARK_")}
    env["PYTHONPATH"] = ref.ROOT
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          cwd=str(tmp_path), capture_output=True, text=True,
                          timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "NO_JAX_OK" in proc.stdout


# the port's scripts under tools/ (the others there drive the JAX package)
PORT_TOOLS = ("autozoom_clip_torch.py", "iters_to_png_torch.py",
              "run_view27_torch.py", "run_view30_torch.py",
              "run_view32_torch.py", "time_k20.py", "time_ntt.py",
              "time_orbit32.py", "time_pixel_loops.py")


def _port_sources():
    root = os.path.join(ref.ROOT, "fractalshark_tpu_torch")
    for dirpath, dirnames, files in os.walk(root):
        if dirpath == root and "build" in dirnames:
            dirnames.remove("build")  # kernel build output, not sources
        for fn in files:
            if fn.endswith(".py"):
                yield os.path.join(dirpath, fn)
    yield os.path.join(ref.ROOT, "chip_smoke.py")
    for name in PORT_TOOLS:
        yield os.path.join(ref.ROOT, "tools", name)


def test_package_sources_do_not_import_jax():
    for path in _port_sources():
        text = open(path).read()
        assert "import jax" not in text and "from jax" not in text, path


def test_port_imports_neither_jax_nor_the_jax_package():
    """No module of the port, not chip_smoke.py and not the port's tools
    (``PORT_TOOLS``, View #32's script among them) imports jax or
    fractalshark_tpu, at any level of any function (AST walk)."""
    import ast
    banned = ("jax", "fractalshark_tpu")
    names = {os.path.basename(p) for p in _port_sources()}
    assert {"graft_entry.py", "run_view27_torch.py", "run_view30_torch.py",
            "run_view32_torch.py", "autozoom_clip_torch.py",
            "iters_to_png_torch.py"} <= names
    for path in _port_sources():
        tree = ast.parse(open(path).read(), filename=path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""] if node.level == 0 else []
            else:
                continue
            for name in names:
                assert name.split(".")[0] not in banned, (path, node.lineno,
                                                          name)


def test_cuda_device_without_cuda_is_an_error(capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    assert cli.main(VIEW0 + ["--device", "cuda"]) == 2
    assert "CUDA is not available" in capsys.readouterr().err


@pytest.mark.parametrize("name", list(BAND))
def test_f64_band_frame_equals_jax(jax_ref, name):
    """The zoom band AUTO resolves to Gpu1x64PerturbedLAv2 on the card
    (Cpu64PerturbedBLAV2HDR on the CPU), through the CLI at 32²."""
    argv, pinned, kernel = BAND[name]
    s = _run(cli.main, argv + ["--width", "32", "--height", "32", "--stats",
                               "--device", "cpu"])
    for k in STAT_KEYS + ("crc32",):
        assert s[k] == jax_ref[f"{name}_{k}"].item(), k
    assert (s["iter_sum"], s["crc32"]) == pinned
    assert s["kernel"] == kernel
    if name == "v2_auto":
        assert s["algorithm"] == "Cpu64PerturbedBLAV2HDR"


def _lav2_names():
    from fractalshark_tpu_torch.core.algorithms import Family, all_algorithms
    return sorted(a.name for a in all_algorithms()
                  if a.family is Family.PERTURB_LAV2)


# each LA mode's route on a frame with a valid LA table (the 1e8 frame,
# its budget cut)
ROUTE_BUDGET = 400
_ROUTES = {
    ("f32", "full"): "lav2-full", ("f32", "lao"): "lav2-lao",
    ("f64", "full"): "lav2-f64", ("f64", "lao"): "lav2-lao-f64",
    ("f32", "po"): "perturb-f32", ("f64", "po"): "perturb-f64",
    ("hdr32", "po"): "perturb-pallas", ("hdr64", "po"): "perturb-hdr64",
    ("2x32", "po"): "hdr-df", ("hdr2x32", "po"): "hdr-df",
}


@pytest.mark.parametrize("name", _lav2_names())
def test_every_lav2_algorithm_renders(name):
    """Every LAv2 name renders in each LA mode (RC too); the PO names of
    2x32 and hdr2x32 mantissas take the HDR double-float render (K16),
    their other modes the f32 LA machine."""
    from fractalshark_tpu_torch.core.algorithms import get_algorithm
    from fractalshark_tpu_torch.core.pointzoom import PointZoomBBConverter
    alg = get_algorithm(name)
    ptz = PointZoomBBConverter(pt_x=SMALL_DEEP[1], pt_y=SMALL_DEEP[3],
                               zoom_factor=SMALL_DEEP[5], prec=512)
    f = Fractal(width=8, height=8, view=ptz, algorithm=name,
                num_iterations=ROUTE_BUDGET, device="cpu")
    iters = f.calc_fractal()
    assert iters.shape == (8, 8) and iters.dtype == torch.int64
    assert 0 <= int(iters.min()) and int(iters.max()) <= ROUTE_BUDGET
    assert int(iters.sum()) > 0
    sub = {"2x32": "f32", "hdr2x32": "f32", "hdr32": "f32",
           "hdr64": "f64"}.get(alg.dtype, alg.dtype)
    mode = alg.la_mode.value
    kernel = f.benchmark.extra["kernel"]
    if mode == "po" and alg.dtype in ("2x32", "hdr2x32"):
        assert kernel == "hdr-df"
    elif alg.runtime_decompression and mode != "lao" and sub == "f32":
        want = "perturb-rc-stream" if mode == "po" else "lav2-rc"
        if alg.dtype == "f32" and mode == "po":
            want = "perturb-f32"
        assert kernel == want
    elif mode == "po":
        assert kernel == _ROUTES[alg.dtype, mode]
    else:
        assert kernel == _ROUTES[sub, mode]


def test_auto_ladder_on_cuda_names():
    """With a CUDA device the AUTO ladder picks the accelerator names,
    as the reference does on a TPU (core/algorithms.py:162-179)."""
    f = Fractal(width=8, height=8, view=0, device="cpu")
    f.device = torch.device("cuda")
    assert f.resolve_algorithm().name == "Gpu1x32"
    f.set_view_preset(6)
    assert f.resolve_algorithm().name == "GpuHDRx32PerturbedLAv2"
    f.set_view_preset(5)
    assert f.resolve_algorithm().name == "Gpu1x64PerturbedLAv2"
