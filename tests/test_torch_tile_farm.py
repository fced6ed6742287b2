"""The tile farm of the PyTorch/CUDA port (``parallel/tile_farm.py``) and
K1's row offset ``y0`` on the CPU: the cases of the JAX package's
``tests/test_tile_farm.py`` (tiles, the whole frame from bands, resume,
two processes gathering over ``torch.distributed`` with gloo where the
reference has ``jax.distributed``), and ``escape(..., y0=...)`` bands
equal to the whole frame and to the JAX package's ``escape_jax(y0=...)``
in f32 and f64 (C7).  A ``cuda``-marked test holds K1's bands to its
twin on the card.
"""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

import test_torch_jaxref as ref
from fractalshark_tpu_torch.core.views import get_view_preset
from fractalshark_tpu_torch.ops import escape
from fractalshark_tpu_torch.parallel.tile_farm import (TileFarm, make_tiles,
                                                       render_tile_escape)

# (size, budget, band rows, first rows) of the y0 bands
BAND_SIZE, BAND_BUDGET, BAND_ROWS = 64, 128, 24
BAND_Y0 = (0, 24, 48)


def _view(size):
    return get_view_preset(0).ptz.square_aspect_ratio(size, size)


def _jax_reference(_inputs):
    import jax.numpy as jnp

    from fractalshark_tpu.core.views import get_view_preset as jview
    from fractalshark_tpu.ops import escape as jesc

    out = {}
    ptz = jview(0).ptz.square_aspect_ratio(BAND_SIZE, BAND_SIZE)
    p = jesc.PlainParams.from_view(ptz, BAND_SIZE, BAND_SIZE)
    for name, dt in (("f32", jnp.float32), ("f64", jnp.float64)):
        out[f"whole_{name}"] = np.asarray(jesc.escape_jax(
            p, BAND_SIZE, BAND_SIZE, BAND_BUDGET, dtype=dt))
        for y0 in BAND_Y0:
            h = min(BAND_ROWS, BAND_SIZE - y0)
            out[f"band_{name}_{y0}"] = np.asarray(jesc.escape_jax(
                p, BAND_SIZE, h, BAND_BUDGET, dtype=dt, y0=y0))
    return out


@pytest.fixture(scope="module")
def jax_ref(tmp_path_factory):
    return ref.run_jax_reference("test_torch_tile_farm", "_jax_reference",
                                 tmp_path_factory.mktemp("tile_farm"))


def test_tiles_cover_exactly():
    ts = make_tiles(100, 32)
    assert [t.y0 for t in ts] == [0, 32, 64, 96]
    assert [t.h for t in ts] == [32, 32, 32, 4]
    assert sum(t.h for t in ts) == 100


@pytest.mark.parametrize("dtype", ["f32", "f64"])
def test_y0_bands_equal_the_whole_frame_and_jax(jax_ref, dtype):
    """C7: cy = max_y - (y0 + y)·dy, so a band is those rows of the whole
    frame bit for bit, in ``escape_jax``'s loop semantics (the reference's
    band renderer) and in the f32 tile's; each band equals the JAX
    package's ``escape_jax(y0=...)``, and K1's two-pass twin takes y0
    too.  y0 = 0 is the frame as before."""
    p = escape.PlainParams.from_view(_view(BAND_SIZE), BAND_SIZE, BAND_SIZE)
    whole = escape.escape(p, BAND_SIZE, BAND_SIZE, BAND_BUDGET, dtype,
                          "cpu", tile=False)
    np.testing.assert_array_equal(whole.numpy(),
                                  jax_ref[f"whole_{dtype}"].astype(np.int64))
    default = escape.escape(p, BAND_SIZE, BAND_SIZE, BAND_BUDGET, dtype,
                            "cpu")
    assert torch.equal(default, escape.escape(
        p, BAND_SIZE, BAND_SIZE, BAND_BUDGET, dtype, "cpu", y0=0))
    for y0 in BAND_Y0:
        h = min(BAND_ROWS, BAND_SIZE - y0)
        band = escape.escape(p, BAND_SIZE, h, BAND_BUDGET, dtype, "cpu",
                             y0=y0, tile=False)
        assert torch.equal(band, whole[y0:y0 + h])
        np.testing.assert_array_equal(
            band.numpy(), jax_ref[f"band_{dtype}_{y0}"].astype(np.int64))
        tile = escape.escape(p, BAND_SIZE, h, BAND_BUDGET, dtype, "cpu",
                             y0=y0)
        assert torch.equal(tile, default[y0:y0 + h])
        two = escape.escape_two_pass_plain(
            p, BAND_SIZE, h, BAND_BUDGET, escape._DTYPES[dtype], y0=y0,
            shuffle=np.random.default_rng(y0))
        assert torch.equal(two, tile)


def test_y0_refusals():
    p = escape.PlainParams.from_view(_view(8), 8, 8)
    with pytest.raises(ValueError, match="y0"):
        escape.escape(p, 8, 8, 16, "f64", "cpu", y0=-1)
    with pytest.raises(ValueError, match="tile"):
        escape.escape(p, 8, 8, 16, "f64", "cpu", tile=True)


def test_single_process_matches_whole_render(tmp_path, jax_ref):
    size = BAND_SIZE
    ptz = _view(size)
    farm = TileFarm(ptz, size, size, 24, str(tmp_path / "ck"))
    n = farm.run(render_tile_escape(max_iter=BAND_BUDGET, device="cpu"))
    assert n == len(farm.tiles)
    img = farm.gather_local()
    assert img.dtype == np.uint32
    np.testing.assert_array_equal(img, jax_ref["whole_f32"])
    # no process group: the gather is this process's part, the whole image
    np.testing.assert_array_equal(farm.gather_dcn(), img)


def test_resume_skips_done_tiles(tmp_path):
    size = 48
    ptz = _view(size)
    ck = str(tmp_path / "ck")
    farm = TileFarm(ptz, size, size, 16, ck)
    calls = []

    def counting(ptz_, w, h, y0, th):
        calls.append(y0)
        return render_tile_escape(max_iter=64, device="cpu")(ptz_, w, h, y0,
                                                            th)

    assert farm.run(counting) == 3
    farm2 = TileFarm(ptz, size, size, 16, ck)
    assert farm2.pending() == []
    assert farm2.run(counting) == 0
    assert len(calls) == 3


_WORKER = r"""
import os, sys
import numpy as np
import torch
import torch.distributed as dist
pid, np_, port, ck = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                        world_size=np_, rank=pid)
from fractalshark_tpu_torch.core.views import get_view_preset
from fractalshark_tpu_torch.ops import escape
from fractalshark_tpu_torch.parallel.tile_farm import (TileFarm,
                                                       render_tile_escape)
size = 48
ptz = get_view_preset(0).ptz.square_aspect_ratio(size, size)
farm = TileFarm(ptz, size, size, 16, ck, process_index=pid,
                process_count=np_)
farm.run(render_tile_escape(max_iter=64, device="cpu"))
p0 = escape.PlainParams.from_view(ptz, size, size)
whole = escape.escape(p0, size, size, 64, "f32", "cpu",
                      tile=False).numpy().astype(np.uint32)
for t in farm.my_tiles():
    assert (np.load(farm._tile_path(t)) == whole[t.y0:t.y0 + t.h]).all(), t
img = farm.gather_dcn()
assert (img == whole).all()
if pid == 0:
    np.save(os.path.join(ck, "assembled.npy"), img)
dist.destroy_process_group()
"""


def test_two_process_gather(tmp_path):
    """Two processes in a gloo process group over 127.0.0.1 render
    disjoint tile sets (tile index mod 2) into one checkpoint directory
    and assemble the image with one all_reduce: every process gets the
    whole frame (the reference: two jax.distributed processes and
    process_allgather)."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    ck = str(tmp_path / "ck")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (ref.ROOT, os.environ.get("PYTHONPATH")) if p))
    procs = [subprocess.Popen(
        [sys.executable, "-c", _WORKER, str(pid), "2", str(port), ck],
        env=env, cwd=ref.ROOT, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE) for pid in range(2)]
    try:
        outs = [p.communicate(timeout=120) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for p, (_, se) in zip(procs, outs):
        assert p.returncode == 0, se.decode()[-2000:]
    img = np.load(os.path.join(ck, "assembled.npy"))
    assert img.shape == (48, 48)
    assert img.max() == 64 and img.min() >= 0
    assert len(os.listdir(ck)) == 3 + 2   # tiles, farm.json, assembled


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tile", [("f32", None), ("f32", False),
                                        ("f64", None)])
def test_k1_bands_on_card(dtype, tile):
    """K1 with y0: bands on the card equal the whole frame's rows and the
    twin's bands, bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    size = 512
    p = escape.PlainParams.from_view(_view(size), size, size)
    whole = escape.escape(p, size, size, 256, dtype, "cuda", tile=tile)
    bands = torch.cat([escape.escape(p, size, 128, 256, dtype, "cuda", y0=y,
                                     tile=tile) for y in range(0, size, 128)])
    assert torch.equal(whole, bands)
    k = escape.escape(p, 64, 40, 256, dtype, "cuda", y0=300, tile=tile)
    pl = escape.escape(p, 64, 40, 256, dtype, "cpu", y0=300, tile=tile)
    assert torch.equal(k.cpu(), pl)
