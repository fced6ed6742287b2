"""The limb-sharded four-step NTT of the PyTorch/CUDA port
(``parallel/ntt_sharded.py``) on the CPU: the cases of the JAX package's
``tests/test_parallel_ntt.py`` with M = 2 and 4 ranks in one gloo process
group (subprocesses, the M = 2 cases on a subgroup of ranks 0 and 1), each
result equal to the JAX package's sharded function (on as many virtual
devices) and to the port's one-device transforms, bit for bit; a 2-rank
case at nfft 2,048; the refusals before any collective.
"""

import numpy as np
import pytest
import torch

import test_torch_jaxref as ref
from fractalshark_tpu_torch.ops.bignum import ntt as N
from fractalshark_tpu_torch.parallel import ntt_sharded as NS
from fractalshark_tpu_torch.parallel.mesh import Mesh

N_BIG, N_SMALL = 65536, 2048
MESHES = (2, 4)


def _inputs(n: int):
    """(x [4, n], y [2, n], a, b) from seeds 0, 1, 2 as the JAX tests."""
    rng = np.random.default_rng(0)
    x = rng.integers(0, 1 << 16, (4, n)).astype(np.uint32)
    y = np.random.default_rng(1).integers(0, 1 << 16, (2, n)) \
        .astype(np.uint32)
    rng = np.random.default_rng(2)
    a = rng.integers(0, 1 << 16, n).astype(np.uint32)
    b = rng.integers(0, 1 << 16, n).astype(np.uint32)
    a[n // 2:] = 0
    b[n // 2:] = 0
    return x, y, a, b


def _jax_reference(_inputs_unused):
    import jax
    import jax.numpy as jnp

    from fractalshark_tpu.parallel import ntt_sharded as JNS

    out = {}
    # the JAX package's sharded results do not depend on M (its own tests
    # hold them to the one-device chain): one mesh a size
    for M, n in ((4, N_BIG), (2, N_SMALL)):
        mesh = JNS.make_limb_mesh(jax.devices()[:M])
        x, y, a, b = _inputs(n)
        out[f"fwd_{n}"] = np.asarray(JNS.fourstep_forward_sharded(
            jnp.asarray(x), n, mesh)).reshape(4, n)
        f = JNS.fourstep_forward_sharded(jnp.asarray(y), n, mesh)
        out[f"rt_{n}"] = np.asarray(JNS.fourstep_inverse_sharded(
            f, n, mesh, extra_scale_r=False)).reshape(2, n)
        out[f"m3_{n}"] = np.asarray(JNS.multiply_3way_sharded(a, b, mesh))
    return out


def _rank_cases(rank: int, world: int) -> dict:
    """Every rank's part of every case, M = 4 on the world and M = 2 on a
    subgroup of ranks 0 and 1."""
    import torch.distributed as dist
    sub = dist.new_group([0, 1])
    out = {}
    for M in MESHES:
        if rank >= M:
            continue
        mesh = NS.make_limb_mesh("cpu", None if M == world else sub)
        for n in (N_BIG, N_SMALL):
            if M == 4 and n == N_SMALL:
                continue
            x, y, a, b = _inputs(n)
            f = NS.fourstep_forward_sharded(torch.from_numpy(
                x.astype(np.int32)), n, mesh)
            out[f"fwd_{M}_{n}"] = f.numpy()
            fy = NS.fourstep_forward_sharded(torch.from_numpy(
                y.astype(np.int32)), n, mesh)
            inv = NS.fourstep_inverse_sharded(fy, n, mesh,
                                              extra_scale_r=False)
            out[f"rt_{M}_{n}"] = NS.gather_columns(inv, mesh).numpy()
            out[f"m3_{M}_{n}"] = NS.multiply_3way_sharded(a, b, mesh).numpy()
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("parallel_ntt")
    return ref.run_ranks_and_jax("test_torch_parallel_ntt", 4, d, 4)


def _single(n: int) -> dict:
    x, y, a, b = _inputs(n)
    xx = torch.from_numpy(np.stack([a, a, b, b]).astype(np.int32))
    f = N.fourstep_forward(xx, n)
    prod = N.mont_mul_rows(f[[0, 1, 2, 3, 0, 1]], f[[0, 1, 2, 3, 2, 3]])
    return {"fwd": N.fourstep_forward(torch.from_numpy(x.astype(np.int32)),
                                      n).numpy(),
            "m3": N.fourstep_inverse_scaled(prod, n, True).numpy()}


def _blocks(parts, n: int) -> np.ndarray:
    """The ranks' spectra blocks [R, n2, n1/M] as the [R, n] spectra."""
    return np.concatenate(parts, axis=2).reshape(parts[0].shape[0], n)


@pytest.mark.parametrize("M", MESHES)
def test_forward_bit_identical_65536(runs, M):
    ranks, jref = runs
    got = _blocks([ranks[r][f"fwd_{M}_{N_BIG}"] for r in range(M)], N_BIG)
    np.testing.assert_array_equal(got, _single(N_BIG)["fwd"])
    np.testing.assert_array_equal(got.astype(np.uint32),
                                  jref[f"fwd_{N_BIG}"])


@pytest.mark.parametrize("M", MESHES)
def test_round_trip_bit_identical(runs, M):
    ranks, jref = runs
    _, y, _, _ = _inputs(N_BIG)
    for r in range(M):
        got = ranks[r][f"rt_{M}_{N_BIG}"]
        np.testing.assert_array_equal(got, y.astype(np.int32))
        np.testing.assert_array_equal(got.astype(np.uint32),
                                      jref[f"rt_{N_BIG}"])


@pytest.mark.parametrize("M", MESHES)
def test_sharded_3way_products_match_exact_convolution(runs, M):
    """The sharded multiply on every rank = the one-device chain = the
    JAX package's sharded multiply, and its x·y rows CRT to A·B."""
    ranks, jref = runs
    n = N_BIG
    want = _single(n)["m3"]
    for r in range(M):
        got = ranks[r][f"m3_{M}_{n}"]
        assert got.shape == (6, n)
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got.astype(np.uint32),
                                      jref[f"m3_{n}"])
    _, _, a, b = _inputs(n)
    A = int.from_bytes(a[:n // 2].astype("<u2").tobytes(), "little")
    B = int.from_bytes(b[:n // 2].astype("<u2").tobytes(), "little")
    r1 = want[4].astype(np.int64)
    r2 = want[5].astype(np.int64)
    t = ((r1 - r2) % N.P1) * pow(N.P2, -1, N.P1) % N.P1
    v = r2 + N.P2 * t
    assert sum(int(c) << (16 * i) for i, c in enumerate(v)) == A * B


def test_two_ranks_at_2048(runs):
    """nfft 2,048 (n1 = 32, n2 = 64) on two ranks: forward, round trip
    and multiply = the one-device transforms = JAX."""
    ranks, jref = runs
    n = N_SMALL
    single = _single(n)
    got = _blocks([ranks[r][f"fwd_2_{n}"] for r in range(2)], n)
    np.testing.assert_array_equal(got, single["fwd"])
    np.testing.assert_array_equal(got.astype(np.uint32), jref[f"fwd_{n}"])
    _, y, _, _ = _inputs(n)
    for r in range(2):
        np.testing.assert_array_equal(ranks[r][f"rt_2_{n}"],
                                      y.astype(np.int32))
        np.testing.assert_array_equal(ranks[r][f"m3_2_{n}"], single["m3"])
        np.testing.assert_array_equal(
            ranks[r][f"m3_2_{n}"].astype(np.uint32), jref[f"m3_{n}"])


def test_refusals():
    """M must divide both four-step factors, refused before any
    collective (a mesh object with no group suffices)."""
    x = torch.zeros(4, 8, dtype=torch.int32)
    cpu = torch.device("cpu")
    with pytest.raises(ValueError, match="divide both"):
        NS.fourstep_forward_sharded(x, 8, Mesh(None, 4, 0, cpu))   # n1 = 2
    with pytest.raises(ValueError, match="divide both"):
        NS.fourstep_forward_sharded(torch.zeros(4, 2048, dtype=torch.int32),
                                    2048, Mesh(None, 3, 0, cpu))
    with pytest.raises(ValueError, match="divide both"):
        NS.fourstep_inverse_sharded(torch.zeros(4, 64, 16, dtype=torch.int32),
                                    2048, Mesh(None, 64, 0, cpu))
