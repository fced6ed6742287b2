"""The row-sharded streaming renders of the PyTorch/CUDA port
(``parallel/stream_render.py``) on the CPU: the cases of the JAX
package's ``tests/test_parallel_stream.py`` with M = 2 and 4 ranks in one
gloo process group (subprocesses; M = 2 on a subgroup of ranks 0 and 1):
the stream render (K6's twin on B11's route) and the RC render (K3's twin
over the compressed anchors) on the 1e8 frame, and the stream render at
50 × 37 (slabs of ceil(37/M) rows, the last shorter), each frame on every
rank equal to the port's one-device render and to the JAX package's
sharded render (4 virtual devices, Pallas in interpret mode); launches
bounded to 1,024 steps; an abort on one rank stops every rank.
"""

import numpy as np
import pytest

import test_torch_jaxref as ref
from fractalshark_tpu_torch.ops import perturb_stream as PS
from fractalshark_tpu_torch.parallel import stream_render as SR
from fractalshark_tpu_torch.parallel.mesh import make_mesh

MESHES = (2, 4)
DEEP = ("-0.743643887037158704752191506114774",
        "0.131825904205311970493132056385139", "1e8")
SIZE, BUDGET, RC_BUDGET = 64, 2000, 1500
ODD_W, ODD_H, ODD_BUDGET = 50, 37, 1200


def _deep(h):
    ptz = h.PointZoomBBConverter(pt_x=DEEP[0], pt_y=DEEP[1],
                                 zoom_factor=DEEP[2], prec=512)
    ptz = ptz.square_aspect_ratio(SIZE, SIZE)
    return ptz, h.RefOrbitCalc().get_and_create_useful_results(ptz, BUDGET)


def _jax_reference(_inputs):
    import jax
    from jax.sharding import Mesh

    from fractalshark_tpu.engine.perturbation_results import \
        CompressedOrbit
    from fractalshark_tpu.parallel.stream_render import (
        sharded_perturb_render_stream, sharded_perturb_render_stream_rc)

    mesh = Mesh(np.array(jax.devices()[:4]), ("rows",))
    ptz, res = _deep(ref.host_layer("fractalshark_tpu"))
    co = CompressedOrbit.from_uncompressed(res)
    return {
        "stream": np.asarray(sharded_perturb_render_stream(
            res, ptz, SIZE, SIZE, BUDGET, mesh=mesh, tile_h=8,
            interpret=True)),
        "rc": np.asarray(sharded_perturb_render_stream_rc(
            co, res.center_x, res.center_y, ptz, SIZE, SIZE, RC_BUDGET,
            mesh=mesh, tile_h=8, interpret=True)),
        "odd": np.asarray(sharded_perturb_render_stream(
            res, ptz, ODD_W, ODD_H, ODD_BUDGET, mesh=mesh, tile_h=8,
            interpret=True)),
    }


class _AbortAt:
    """Fires on one rank once it has been asked ``n`` times."""

    def __init__(self, n: int):
        self.n = n

    def aborted(self) -> bool:
        self.n -= 1
        return self.n < 0


def _rank_cases(rank: int, world: int) -> dict:
    import torch.distributed as dist

    from fractalshark_tpu_torch.engine.perturbation_results import \
        CompressedOrbit
    sub = dist.new_group([0, 1])
    ptz, res = _deep(ref.host_layer("fractalshark_tpu_torch"))
    co = CompressedOrbit.from_uncompressed(res)
    out = {}
    for M in MESHES:
        if rank >= M:
            # ranks 2 and 3 make the one-device frames meanwhile
            out.update(_single(rank, ptz, res, co))
            continue
        mesh = make_mesh("cpu", None if M == world else sub)
        out[f"{M}_stream"] = SR.sharded_perturb_render_stream(
            res, ptz, SIZE, SIZE, BUDGET, mesh, launch_windows=1).numpy()
        out[f"{M}_stream_launches"] = np.asarray(
            SR.last_run_stats["dispatches"])
        out[f"{M}_rc"] = SR.sharded_perturb_render_stream_rc(
            co, res.center_x, res.center_y, ptz, SIZE, SIZE, RC_BUDGET,
            mesh).numpy()
        out[f"{M}_odd"] = SR.sharded_perturb_render_stream(
            res, ptz, ODD_W, ODD_H, ODD_BUDGET, mesh).numpy()
    # one rank aborts after its first launch: every rank stops there
    mesh = make_mesh("cpu")
    SR.sharded_perturb_render_stream(
        res, ptz, SIZE, SIZE, BUDGET, mesh, launch_windows=1,
        abort_monitor=_AbortAt(0) if rank == world - 1 else None)
    out["abort_rounds"] = np.asarray(SR.last_run_stats["rounds"])
    return out


def _single(rank: int, ptz, res, co) -> dict:
    """The one-device frames (rank 2: the stream renders; rank 3: RC)."""
    if rank == 2:
        return {"single_stream": PS.perturb_render_stream(
                    res, ptz, SIZE, SIZE, BUDGET, launch_windows=1,
                    device="cpu").numpy(),
                "single_odd": PS.perturb_render_stream(
                    res, ptz, ODD_W, ODD_H, ODD_BUDGET,
                    device="cpu").numpy()}
    return {"single_rc": PS.perturb_render_stream_rc(
        co, res.center_x, res.center_y, ptz, SIZE, SIZE, RC_BUDGET,
        device="cpu").numpy()}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return ref.run_ranks_and_jax("test_torch_parallel_stream", 4,
                                 tmp_path_factory.mktemp("parallel_stream"),
                                 4)


@pytest.mark.parametrize("M", MESHES)
def test_sharded_stream_matches_single_device(runs, M):
    """Every rank's frame = the one-device stream render = the JAX
    package's sharded stream render; launches of 1,024 steps a pixel."""
    ranks, jref = runs
    single = ranks[2]["single_stream"]
    for r in range(M):
        np.testing.assert_array_equal(ranks[r][f"{M}_stream"], single)
        assert int(ranks[r][f"{M}_stream_launches"]) >= 2
    np.testing.assert_array_equal(single, jref["stream"].astype(np.int64))


@pytest.mark.parametrize("M", MESHES)
def test_sharded_stream_rc_matches_single_device(runs, M):
    """The RC render (K3's twin over the compressed anchors, from the
    zero state) row-sharded = the one-device RC render = JAX's."""
    ranks, jref = runs
    single = ranks[3]["single_rc"]
    for r in range(M):
        np.testing.assert_array_equal(ranks[r][f"{M}_rc"], single)
    np.testing.assert_array_equal(single, jref["rc"].astype(np.int64))


@pytest.mark.parametrize("M", MESHES)
def test_sharded_stream_nondivisible_rows(runs, M):
    """50 × 37: slabs of ceil(37/M) rows, the last shorter; the frame =
    the one-device render = JAX's."""
    ranks, jref = runs
    single = ranks[2]["single_odd"]
    for r in range(M):
        assert ranks[r][f"{M}_odd"].shape == (ODD_H, ODD_W)
        np.testing.assert_array_equal(ranks[r][f"{M}_odd"], single)
    np.testing.assert_array_equal(single, jref["odd"].astype(np.int64))


def test_abort_on_one_rank_stops_every_rank(runs):
    """One rank's abort monitor fires after the first launch: the ranks
    agree in that round's all_reduce and all stop after one round."""
    ranks, _ = runs
    assert [int(r["abort_rounds"]) for r in ranks] == [1] * len(ranks)
