"""``tools/autozoom_clip_torch.py``, the port's feature-zoom clip, on the
CPU against the JAX package's ``tools/autozoom_clip.py``: 4 frames at
32², paced at 0.01 s (100 fps).  The steps (zoom and budget), each
presented frame's pixels and PNG, and the manifest's keys equal the JAX
clip's; every step is presented, none aborted, in generation order, each
frame equal to a direct ``Fractal`` render of its step.  The frames are
shallow (View 0 zoomed 1.1^4 toward View #5's centre): no reference orbit
is computed, so the native toolchain is not needed.
"""

import json
import os
import runpy
import sys

import numpy as np
import pytest
import torch

import test_torch_jaxref as ref
from fractalshark_tpu_torch.io.png import read_png

N_FRAMES, SIZE, FPS = 4, 32, 100.0


def _steps(pkg, **kw) -> list:
    """The clip's steps as the tool sets them up: each step's zoom and
    budget."""
    import importlib
    F = importlib.import_module(f"{pkg}.engine.fractal").Fractal
    az = importlib.import_module(f"{pkg}.engine.autozoom")
    views = importlib.import_module(f"{pkg}.core.views")
    f = F(width=SIZE, height=SIZE, view=0, num_iterations=2048, **kw)
    steps = az.AutoZoomer(f).setup_feature_zoom(
        target_ptz=views.get_view_preset(5).ptz, target_iters=4096,
        max_steps=N_FRAMES)
    return [f"{s.ptz.pt_x.to_string(40)} {s.ptz.pt_y.to_string(40)} "
            f"{s.ptz.zoom_factor.to_string(20)} {s.num_iterations}"
            for s in steps]


def _jax_reference(inputs):
    out_dir = str(inputs["outdir"])
    tool = os.path.join(ref.ROOT, "tools", "autozoom_clip.py")
    saved = sys.argv
    sys.argv = [tool, str(N_FRAMES), str(SIZE), str(FPS), out_dir]
    try:
        runpy.run_path(tool, run_name="__main__")
    finally:
        sys.argv = saved
    with open(os.path.join(out_dir, "clip.json")) as f:
        manifest = json.load(f)
    out = {"keys": np.asarray(sorted(manifest)),
           "steps": np.asarray(_steps("fractalshark_tpu", backend="cpu")),
           "zooms": np.asarray([manifest["zoom_start"],
                                manifest["zoom_end"]]),
           "counts": np.asarray([manifest["n_steps"],
                                 manifest["presented"]])}
    for i in range(manifest["presented"]):
        with open(os.path.join(out_dir, f"frame_{i:03d}.png"), "rb") as f:
            out[f"png{i}"] = np.frombuffer(f.read(), np.uint8)
    return out


def _load_tool():
    import importlib.util
    path = os.path.join(ref.ROOT, "tools", "autozoom_clip_torch.py")
    spec = importlib.util.spec_from_file_location("autozoom_clip_torch",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


clip_tool = _load_tool()


@pytest.fixture(scope="module")
def clips(tmp_path_factory):
    d = tmp_path_factory.mktemp("autozoom_clip")
    jax = ref.Background(ref.run_jax_reference, "test_torch_autozoom_clip",
                         "_jax_reference", d, {"outdir": str(d / "jax")})
    port = clip_tool.run(N_FRAMES, SIZE, FPS, str(d / "port"), "cpu")
    return d, port, jax.result()


def test_steps_equal_the_jax_clip(clips):
    _, port, jax = clips
    np.testing.assert_array_equal(_steps("fractalshark_tpu_torch",
                                         device="cpu"), jax["steps"])
    assert [port["zoom_start"], port["zoom_end"]] == jax["zooms"].tolist()
    assert [f["num_iterations"] for f in port["frames"]] == \
        [int(s.split()[-1]) for s in jax["steps"]]


def test_every_step_presented_in_order(clips):
    _, port, jax = clips
    assert [port["n_steps"], port["presented"]] == jax["counts"].tolist() \
        == [N_FRAMES, N_FRAMES]
    assert port["aborted"] == 0 and port["in_generation_order"]
    gens = [f["generation"] for f in port["frames"]]
    assert gens == sorted(gens) and len(set(gens)) == N_FRAMES
    times = [f["present_t"] for f in port["frames"]]
    assert all(b - a >= 1 / FPS - 1e-3 for a, b in zip(times, times[1:]))
    assert port["achieved_fps"] > 0


@pytest.mark.parametrize("i", range(N_FRAMES))
def test_frame_equals_the_jax_clip_and_a_direct_render(clips, i, tmp_path):
    """Presented frame i: its PNG's pixels and bytes = the JAX clip's
    frame; its pixels = a direct render of its step (the manifest's
    equals_direct), on the route the CPU takes (Cpu64, K1's f64 twin)."""
    d, port, jax = clips
    path = os.path.join(str(d / "port"), f"frame_{i:03d}.png")
    jax_png = tmp_path / "jax.png"
    jax_png.write_bytes(jax[f"png{i}"].tobytes())
    np.testing.assert_array_equal(read_png(path), read_png(str(jax_png)))
    with open(path, "rb") as f:
        assert f.read() == jax[f"png{i}"].tobytes()
    frame = port["frames"][i]
    assert frame["equals_direct"]
    assert (frame["route"], frame["kernel"]) == ("Cpu64", "escape")


def test_manifest_has_the_jax_keys(clips):
    d, port, jax = clips
    with open(os.path.join(str(d / "port"), "clip.json")) as f:
        written = json.load(f)
    assert set(jax["keys"].tolist()) <= set(written)
    assert written["all_equal_direct"] and written["routes"] == ["Cpu64"]
    assert written["device"] == "cpu" and "card" not in written


def test_cuda_without_cuda_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        clip_tool.run(N_FRAMES, SIZE, FPS, str(tmp_path / "clip"), "cuda")
    assert not os.listdir(tmp_path)
