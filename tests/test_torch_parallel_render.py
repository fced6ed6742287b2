"""Row-sharded renders of the PyTorch/CUDA port (``parallel/render.py``)
on the CPU: the cases of the JAX package's ``tests/test_parallel.py``
with M = 2 and 4 ranks in one gloo process group (subprocesses; M = 2 on
a subgroup of ranks 0 and 1): the escape render (K1's twin with ``y0``)
and the HDR perturbation render (K6's twin over a slab of the dc grids),
each rank's slab the whole frame's rows, the frame equal to the port's
one-device render and to the JAX package's sharded render (4 virtual
devices); the slabs and the all_reduce statistics, also of slabs whose
sum passes 2^63 and 2^64 (the JAX package's ``uint64`` total mod 2^64);
the height refusal.
"""

import numpy as np
import pytest
import torch

import test_torch_jaxref as ref
from fractalshark_tpu_torch.ops import escape, perturb
from fractalshark_tpu_torch.parallel import render as PR
from fractalshark_tpu_torch.parallel.mesh import Mesh

MESHES = (2, 4)
H = 32                       # rows: a multiple of both mesh sizes
ESC_W, ESC_BUDGET = 64, 100
DEEP_W, DEEP_BUDGET = 48, 2000
STATS_W, STATS_BUDGET = 32, 50
# slabs of counts near 2^51 and 2^52 (made from a seed): the frame sums to
# a total in [2^63, 2^64) and to one past 2^64, which the JAX package's
# uint64 sum gives mod 2^64
BIG_W = 128
BIG_BASES = (1 << 51, 1 << 52)
DEEP = ("-0.743643887037158704752191506114774",
        "0.131825904205311970493132056385139", "1e8")


def _views(h):
    return h.get_view_preset(0).ptz.square_aspect_ratio


def _deep(h):
    ptz = h.PointZoomBBConverter(pt_x=DEEP[0], pt_y=DEEP[1],
                                 zoom_factor=DEEP[2], prec=512)
    ptz = ptz.square_aspect_ratio(DEEP_W, H)
    return ptz, h.RefOrbitCalc().get_and_create_useful_results(
        ptz, DEEP_BUDGET)


def _big_frame(k: int) -> np.ndarray:
    """The int64 frame [H, BIG_W] of counts BIG_BASES[k] + [0, 2^16)."""
    rng = np.random.default_rng(2100 + k)
    return BIG_BASES[k] + rng.integers(0, 1 << 16, size=(H, BIG_W),
                                       dtype=np.int64)


def _jax_reference(_inputs):
    import jax

    from fractalshark_tpu.ops import escape as jesc
    from fractalshark_tpu.parallel import render as jpr

    h = ref.host_layer("fractalshark_tpu")
    mesh = jpr.make_mesh(jax.devices()[:4])
    out = {}
    ptz = _views(h)(ESC_W, H)
    p = jesc.PlainParams.from_view(ptz, ESC_W, H)
    out["escape"] = np.asarray(jpr.sharded_escape_render(
        p, ESC_W, H, ESC_BUDGET, mesh))
    ptz, res = _deep(h)
    out["hdr"] = np.asarray(jpr.sharded_perturb_render_hdr(
        res, ptz, DEEP_W, H, DEEP_BUDGET, mesh, sub_dtype=np.float32))
    ptz = _views(h)(STATS_W, H)
    p = jesc.PlainParams.from_view(ptz, STATS_W, H)
    it = jpr.sharded_escape_render(p, STATS_W, H, STATS_BUDGET, mesh)
    stats = jpr.sharded_stats(it, mesh)
    out["stats"] = np.asarray([int(stats[k]) for k in ("min", "max", "sum")])
    for k in range(len(BIG_BASES)):
        it = jpr._shard_rows(mesh, jax.numpy.asarray(_big_frame(k)))
        stats = jpr.sharded_stats(it, mesh)
        out[f"big{k}"] = np.asarray([int(stats[n]) for n in
                                     ("min", "max", "sum")], np.uint64)
    return out


def _rank_cases(rank: int, world: int) -> dict:
    import torch.distributed as dist
    sub = dist.new_group([0, 1])
    h = ref.host_layer("fractalshark_tpu_torch")
    ptz_deep, res = _deep(h)
    out = {}
    for M in MESHES:
        if rank >= M:
            continue
        mesh = PR.make_mesh("cpu", None if M == world else sub)
        p = escape.PlainParams.from_view(_views(h)(ESC_W, H), ESC_W, H)
        part = PR.sharded_escape_render(p, ESC_W, H, ESC_BUDGET, mesh)
        out[f"{M}_escape_slab"] = part.numpy()
        out[f"{M}_escape"] = PR.gather_rows(part, H, mesh).numpy()
        part = PR.sharded_perturb_render_hdr(res, ptz_deep, DEEP_W, H,
                                             DEEP_BUDGET, mesh)
        out[f"{M}_hdr_slab"] = part.numpy()
        out[f"{M}_hdr"] = PR.gather_rows(part, H, mesh).numpy()
        p = escape.PlainParams.from_view(_views(h)(STATS_W, H), STATS_W, H)
        part = PR.sharded_escape_render(p, STATS_W, H, STATS_BUDGET, mesh)
        out[f"{M}_stats_slab"] = part.numpy()
        st = PR.sharded_stats(part, mesh)
        out[f"{M}_stats"] = np.asarray([st[k] for k in ("min", "max",
                                                        "sum")])
        rows = H // M
        for k in range(len(BIG_BASES)):
            part = torch.from_numpy(
                _big_frame(k)[rank * rows:(rank + 1) * rows])
            st = PR.sharded_stats(part, mesh)
            out[f"{M}_big{k}"] = np.asarray([st[n] for n in
                                             ("min", "max", "sum")],
                                            np.uint64)
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return ref.run_ranks_and_jax("test_torch_parallel_render", 4,
                                 tmp_path_factory.mktemp("parallel_render"),
                                 4)


@pytest.fixture(scope="module")
def host():
    return ref.host_layer("fractalshark_tpu_torch")


@pytest.mark.parametrize("M", MESHES)
def test_sharded_escape_matches_single(runs, host, M):
    """Every rank's slab is the one-device frame's rows (K1's twin with
    y0, ``escape_jax``'s loop in f64); the gathered frame = the JAX
    package's sharded render."""
    ranks, jref = runs
    p = escape.PlainParams.from_view(_views(host)(ESC_W, H), ESC_W, H)
    single = escape.escape(p, ESC_W, H, ESC_BUDGET, "f64", "cpu",
                           tile=False).numpy()
    h = H // M
    for r in range(M):
        np.testing.assert_array_equal(ranks[r][f"{M}_escape_slab"],
                                      single[r * h:(r + 1) * h])
        np.testing.assert_array_equal(ranks[r][f"{M}_escape"], single)
    np.testing.assert_array_equal(single, jref["escape"].astype(np.int64))


@pytest.mark.parametrize("M", MESHES)
def test_sharded_perturb_matches_single(runs, host, M):
    """The HDR-f32 perturbation render of the 1e8 frame (budget 2,000):
    slabs = the one-device frame's rows = the JAX package's sharded
    render."""
    ranks, jref = runs
    ptz, res = _deep(host)
    single = perturb.perturb_render_hdr(res, ptz, DEEP_W, H, DEEP_BUDGET,
                                        np.float32, device="cpu").numpy()
    h = H // M
    for r in range(M):
        np.testing.assert_array_equal(ranks[r][f"{M}_hdr_slab"],
                                      single[r * h:(r + 1) * h])
        np.testing.assert_array_equal(ranks[r][f"{M}_hdr"], single)
    np.testing.assert_array_equal(single, jref["hdr"].astype(np.int64))


@pytest.mark.parametrize("M", MESHES)
def test_sharded_output_actually_sharded(runs, M):
    """Each rank holds H/M rows; the statistics reduce over the mesh
    without a gather: min, max (= the budget) and the 64-bit sum of the
    whole frame, on every rank, = the JAX package's."""
    ranks, jref = runs
    frame = np.concatenate([ranks[r][f"{M}_stats_slab"] for r in range(M)])
    want = [frame.min(), frame.max(), frame.sum()]
    for r in range(M):
        assert ranks[r][f"{M}_stats_slab"].shape == (H // M, STATS_W)
        assert list(ranks[r][f"{M}_stats"]) == want
    assert want[1] == STATS_BUDGET
    assert list(jref["stats"]) == want


@pytest.mark.parametrize("M", MESHES)
@pytest.mark.parametrize("k", range(len(BIG_BASES)))
def test_sharded_sum_past_2_63_is_the_uint64_total(runs, M, k):
    """Slabs whose sum passes 2^63 (k = 0) and 2^64 (k = 1): every rank's
    sum is the frame's total mod 2^64, in [0, 2^64), = the JAX package's
    ``uint64`` sum, exactly; min and max as they were."""
    ranks, jref = runs
    frame = _big_frame(k)
    total = sum(int(v) for v in frame.ravel())
    assert total >= 1 << (63 + k)
    want = [int(frame.min()), int(frame.max()), total % (1 << 64)]
    assert [int(v) for v in jref[f"big{k}"]] == want
    for r in range(M):
        assert [int(v) for v in ranks[r][f"{M}_big{k}"]] == want


def test_height_divisibility_error(host):
    """A height the mesh does not divide is refused before any launch
    or collective (``render.py:56-57``, ``:78-79``)."""
    p = escape.PlainParams.from_view(_views(host)(32, 30), 32, 30)
    mesh = Mesh(None, 4, 0, torch.device("cpu"))
    with pytest.raises(ValueError, match="not divisible"):
        PR.sharded_escape_render(p, 32, 30, 10, mesh)
    ptz, res = _deep(host)
    with pytest.raises(ValueError, match="not divisible"):
        PR.sharded_perturb_render_hdr(res, ptz, DEEP_W, 30, 10, mesh)
