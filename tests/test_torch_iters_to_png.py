"""``tools/iters_to_png_torch.py``, the port's grid-to-PNG tool, against
the JAX package's ``tools/iters_to_png.py`` on the same saved grids: the
PNG pixels (and bytes) equal, for a grid whose span is below 2^31 (the
JAX tool colours it as uint32) and one whose span is past it (uint64),
and with the palette named in ``I2P_PALETTE``.  The grids are made from a
seed with numpy.
"""

import os
import runpy
import sys

import numpy as np
import pytest

import test_torch_jaxref as ref
from fractalshark_tpu_torch.io.png import read_png

# name: (rows, columns, the grid's minimum, its span)
GRIDS = {"below_2_31": (20, 24, 49_000_000_000, 3_000_000),
         "past_2_31": (18, 26, 50_000_000_000_000, 5_000_000_000)}
ENV_GRID, ENV_PALETTE = "below_2_31", "Patriotic"


def _grid(name) -> np.ndarray:
    h, w, lo, span = GRIDS[name]
    rng = np.random.default_rng(25)
    g = lo + rng.integers(0, span + 1, size=(h, w), dtype=np.int64)
    g.flat[:2] = (lo, lo + span)        # the span is the grid's own
    return g


def _run_tool(path, argv, env=None):
    """A tool script as its ``__main__``, with `argv` and `env` set."""
    saved_argv, saved_env = sys.argv, dict(os.environ)
    sys.argv = [path] + argv
    os.environ.update(env or {})
    try:
        runpy.run_path(path, run_name="__main__")
    except SystemExit as e:
        assert not e.code, e.code
    finally:
        sys.argv = saved_argv
        os.environ.clear()
        os.environ.update(saved_env)


def _jax_reference(inputs):
    work = str(inputs["workdir"])
    tool = os.path.join(ref.ROOT, "tools", "iters_to_png.py")
    out = {}
    for name in GRIDS:
        png = os.path.join(work, f"jax_{name}.png")
        _run_tool(tool, [os.path.join(work, f"{name}.npy"), png])
        with open(png, "rb") as f:
            out[name] = np.frombuffer(f.read(), np.uint8)
    png = os.path.join(work, "jax_env.png")
    _run_tool(tool, [], {"I2P_IN": os.path.join(work, f"{ENV_GRID}.npy"),
                         "I2P_OUT": png, "I2P_PALETTE": ENV_PALETTE})
    with open(png, "rb") as f:
        out["env"] = np.frombuffer(f.read(), np.uint8)
    return out


TOOL = os.path.join(ref.ROOT, "tools", "iters_to_png_torch.py")


@pytest.fixture(scope="module")
def grids(tmp_path_factory):
    d = tmp_path_factory.mktemp("iters_to_png")
    for name in GRIDS:
        np.save(d / f"{name}.npy", _grid(name))
    return d, ref.Background(ref.run_jax_reference, "test_torch_iters_to_png",
                             "_jax_reference", d, {"workdir": str(d)})


def _png_pixels(data: np.ndarray, path) -> np.ndarray:
    with open(path, "wb") as f:
        f.write(data.tobytes())
    return read_png(str(path))


@pytest.mark.parametrize("name", sorted(GRIDS))
def test_png_equals_the_jax_tool(grids, name, tmp_path):
    d, jax = grids
    png = tmp_path / "port.png"
    _run_tool(TOOL, [str(d / f"{name}.npy"), str(png), "--device", "cpu"])
    got = read_png(str(png))
    want = _png_pixels(jax[name], tmp_path / "jax.png")
    h, w = GRIDS[name][:2]
    assert got.shape == (h, w, 4) and got.dtype == np.uint8
    np.testing.assert_array_equal(got, want)
    assert png.read_bytes() == jax[name].tobytes()
    assert len({tuple(p) for p in got.reshape(-1, 4)}) > 1


def test_environment_names_input_output_and_palette(grids, tmp_path):
    d, jax = grids
    png = tmp_path / "env.png"
    _run_tool(TOOL, ["--device", "cpu"],
              {"I2P_IN": str(d / f"{ENV_GRID}.npy"), "I2P_OUT": str(png),
               "I2P_PALETTE": ENV_PALETTE})
    np.testing.assert_array_equal(
        read_png(str(png)), _png_pixels(jax["env"], tmp_path / "jax.png"))
    default = tmp_path / "default.png"
    _run_tool(TOOL, [str(d / f"{ENV_GRID}.npy"), str(default),
                     "--device", "cpu"])
    assert not np.array_equal(read_png(str(png)), read_png(str(default)))


def test_output_defaults_to_beside_the_input(tmp_path):
    np.save(tmp_path / "grid.npy", _grid("below_2_31"))
    _run_tool(TOOL, [str(tmp_path / "grid.npy"), "--device", "cpu"])
    assert read_png(str(tmp_path / "grid.png")).shape == (20, 24, 4)


def test_no_input_is_rc_2(monkeypatch, capsys):
    monkeypatch.delenv("I2P_IN", raising=False)
    spec_globals = runpy.run_path(TOOL)
    assert spec_globals["main"]([]) == 2
    assert "usage" in capsys.readouterr().err


def test_cuda_without_cuda_raises(monkeypatch, tmp_path):
    """The colouring runs on the card by default: without one it raises
    and writes nothing."""
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    np.save(tmp_path / "grid.npy", _grid("below_2_31"))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        runpy.run_path(TOOL)["main"]([str(tmp_path / "grid.npy")])
    assert not (tmp_path / "grid.png").exists()
