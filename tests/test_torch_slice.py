"""The port's slice end to end on the CPU (``--device cpu``, the kernels'
plain twins): ``Fractal`` and the CLI against ``fractalshark_tpu``'s
CLI, and the proof that a render never imports jax.
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


def _run(main, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(argv)
    assert rc in (0, None)
    return json.loads(buf.getvalue().strip().splitlines()[-1])


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
    """A deep render and a shallow one through the port, in a fresh
    interpreter whose environment sets none of the JAX package's
    switches: neither jax nor the JAX package gets imported."""
    code = (
        "import sys\n"
        "from fractalshark_tpu_torch.cli import main\n"
        "for v in ('0', '6'):\n"
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


def _port_sources():
    root = os.path.join(ref.ROOT, "fractalshark_tpu_torch")
    for dirpath, dirnames, files in os.walk(root):
        if dirpath == root and "build" in dirnames:
            dirnames.remove("build")  # kernel build output, not sources
        for fn in files:
            if fn.endswith(".py"):
                yield os.path.join(dirpath, fn)
    yield os.path.join(ref.ROOT, "chip_smoke.py")


def test_package_sources_do_not_import_jax():
    for path in _port_sources():
        text = open(path).read()
        assert "import jax" not in text and "from jax" not in text, path


def test_port_imports_neither_jax_nor_the_jax_package():
    """No module of the port, and not chip_smoke.py, imports jax or
    fractalshark_tpu, at any level of any function (AST walk)."""
    import ast
    banned = ("jax", "fractalshark_tpu")
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


@pytest.mark.parametrize("alg", ["Gpu1x64PerturbedLAv2",
                                 "GpuHDRx32PerturbedLAv2PO",
                                 "GpuHDRx32PerturbedBLA",
                                 "GpuHDRx32PerturbedScaled",
                                 "Gpu2x32", "GpuHDRx32"])
def test_unported_algorithms_raise(alg):
    f = Fractal(width=8, height=8, view=6, algorithm=alg, device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        f.calc_fractal()


def test_auto_ladder_on_cuda_names():
    """With a CUDA device the AUTO ladder picks the accelerator names,
    as the reference does on a TPU (core/algorithms.py:162-179)."""
    f = Fractal(width=8, height=8, view=0, device="cpu")
    f.device = torch.device("cuda")
    assert f.resolve_algorithm().name == "Gpu1x32"
    f.set_view_preset(6)
    assert f.resolve_algorithm().name == "GpuHDRx32PerturbedLAv2"
