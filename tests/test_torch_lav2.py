"""K2's plain twin (``fractalshark_tpu_torch/ops/la_kernel.py``) against
the JAX package's LAv2 machine, bit for bit: full mode against
``la_kernel.la_perturb_render`` and the Pallas ``la_render_pallas``
(interpret mode) on the 1e8 fixture of ``tests/test_la_pallas.py``, the
``la_only`` phase-1 state, and View #6 at 32²; then K2 with f64
mantissas (``sub_dtype=np.float64``): the packed f64 tables, full mode
and the ``la_only`` state on the same fixture.
"""

import hashlib
import types
import zlib

import numpy as np
import pytest
import torch

import test_torch_jaxref as ref
from fractalshark_tpu_torch.ops import la_kernel

SIZE, BUDGET = 64, 2000
V6 = 32
# View #6 at 32², JAX package on the CPU with FMA contraction off
VIEW6_32 = (817_235_786, 2_300_363_464)
STATE = ("s", "j", "ref_iter", "dzr", "dzi", "dze", "it", "done")


def _fixture(pkg="fractalshark_tpu_torch"):
    """The 1e8 frame's view, orbit and LA table, built by the host layer
    of ``pkg``: the port's own, or the JAX package's in its reference."""
    h = ref.host_layer(pkg)
    ptz = h.PointZoomBBConverter(
        pt_x="-0.743643887037158704752191506114774",
        pt_y="0.131825904205311970493132056385139",
        zoom_factor="1e8", prec=512).square_aspect_ratio(SIZE, SIZE)
    res = h.RefOrbitCalc().get_and_create_useful_results(ptz, BUDGET)
    la = h.LAReferenceHost.generate(res.orbit_x, res.orbit_y,
                                    h.HD.from_hp(res.max_radius))
    return ptz, res, la


def _view6(pkg="fractalshark_tpu_torch"):
    h = ref.host_layer(pkg)
    v = h.get_view_preset(6)
    ptz = v.ptz.square_aspect_ratio(V6, V6)
    res = h.RefOrbitCalc().get_and_create_useful_results(ptz,
                                                         v.num_iterations)
    la = h.get_or_build_la(types.SimpleNamespace(la_parameters=None), res)
    return ptz, res, la, v.num_iterations


def _tables_sha(res, la) -> np.ndarray:
    h = hashlib.sha256()
    for a in (res.orbit_x, res.orbit_y):
        h.update(np.ascontiguousarray(a).tobytes())
    for k, v in sorted(la.device_arrays(np.float32).items()):
        h.update(k.encode() + np.ascontiguousarray(v).tobytes())
    return np.frombuffer(h.digest(), np.uint8)


def _packed_sha(pack_nodes, pack_orbit, res, la, dtype) -> np.ndarray:
    """sha256 of the packed node and orbit tables of `dtype`, from the
    given packers (the reference's ``_pack_nodes``/``_pack_orbit`` or
    the port's)."""
    ox, oy = res.device_orbit(dtype)
    h = hashlib.sha256()
    for a in (pack_nodes(la.device_arrays(dtype), dtype),
              pack_orbit(np.asarray(ox), np.asarray(oy),
                         int(res.max_ref_iteration()))):
        h.update(np.ascontiguousarray(a).tobytes())
    return np.frombuffer(h.digest(), np.uint8)


def _jax_reference(_inputs):
    from fractalshark_tpu.ops import la_kernel as jla
    from fractalshark_tpu.ops.la_pallas import la_render_pallas

    ptz, res, la = _fixture("fractalshark_tpu")
    out = {"sha": _tables_sha(res, la),
           "sha64": _packed_sha(jla._pack_nodes, jla._pack_orbit, res, la,
                                np.float64)}
    out["full64"] = np.asarray(jla.la_perturb_render(
        res, la, ptz, SIZE, SIZE, BUDGET, sub_dtype=np.float64))
    st = jla.la_perturb_render(res, la, ptz, SIZE, SIZE, BUDGET,
                               sub_dtype=np.float64, la_only=True,
                               return_state=True)
    for name, a in zip(STATE, st):
        out["state64_" + name] = np.asarray(a)
    out["full"] = np.asarray(jla.la_perturb_render(
        res, la, ptz, SIZE, SIZE, BUDGET, sub_dtype=np.float32))
    out["pallas"] = np.asarray(la_render_pallas(
        res, la, ptz, SIZE, SIZE, BUDGET, tile_h=32, interpret=True))
    st = jla.la_perturb_render(res, la, ptz, SIZE, SIZE, BUDGET,
                               sub_dtype=np.float32, la_only=True,
                               return_state=True)
    for name, a in zip(STATE, st):
        out["state_" + name] = np.asarray(a)
    ptz, res, la, n = _view6("fractalshark_tpu")
    out["v6_sha"] = _tables_sha(res, la)
    out["v6"] = np.asarray(jla.la_perturb_render(
        res, la, ptz, V6, V6, n, sub_dtype=np.float32))
    return out


@pytest.fixture(scope="module")
def jax_ref(tmp_path_factory):
    return ref.run_jax_reference("test_torch_lav2", "_jax_reference",
                                 tmp_path_factory.mktemp("lav2"))


@pytest.fixture(scope="module")
def deep():
    return _fixture()


@pytest.fixture(scope="module")
def full(deep):
    ptz, res, la = deep
    return la_kernel.la_perturb_render(res, la, ptz, SIZE, SIZE, BUDGET,
                                       device="cpu")


@pytest.fixture(scope="module")
def la_only_state64(deep):
    ptz, res, la = deep
    return la_kernel.la_perturb_render(res, la, ptz, SIZE, SIZE, BUDGET,
                                       sub_dtype=np.float64, la_only=True,
                                       return_state=True, device="cpu")


@pytest.fixture(scope="module")
def la_only_state(deep):
    ptz, res, la = deep
    return la_kernel.la_perturb_render(res, la, ptz, SIZE, SIZE, BUDGET,
                                       la_only=True, return_state=True,
                                       device="cpu")


def test_same_host_tables(jax_ref, deep):
    _, res, la = deep
    np.testing.assert_array_equal(_tables_sha(res, la), jax_ref["sha"])


@pytest.mark.parametrize("which", ["full", "pallas"])
def test_full_mode_matches_jax(jax_ref, full, which):
    """`full`: the XLA machine; `pallas`: the one-kernel Pallas render."""
    np.testing.assert_array_equal(full.numpy(),
                                  jax_ref[which].astype(np.int64))


@pytest.mark.parametrize("name", STATE)
def test_la_only_state_matches(jax_ref, la_only_state, name):
    got = la_only_state[STATE.index(name)].numpy()
    want = jax_ref["state_" + name]
    if name in ("dzr", "dzi"):
        assert ref.bits_equal(got, want)
    else:
        np.testing.assert_array_equal(got.astype(np.int64),
                                      want.astype(np.int64))


def test_f64_packed_tables_equal_jax(jax_ref, deep):
    """The port's f64 node and orbit tables are the reference's
    ``_pack_nodes``/``_pack_orbit`` at f64, byte for byte (no f64
    mantissa of a node is subnormal, so the upload flush changes
    nothing)."""
    from fractalshark_tpu_torch.ops.tables import pack_nodes_np, pack_orbit_np
    _, res, la = deep
    np.testing.assert_array_equal(
        _packed_sha(pack_nodes_np, pack_orbit_np, res, la, np.float64),
        jax_ref["sha64"])
    T, orbit = la_kernel.device_tables(res, la, torch.device("cpu"),
                                       torch.float64)
    assert T.nodes.dtype == orbit.dtype == T.stages.dtype == torch.float64


def test_full_mode_f64_matches_jax(jax_ref, deep):
    ptz, res, la = deep
    got = la_kernel.la_perturb_render(res, la, ptz, SIZE, SIZE, BUDGET,
                                      sub_dtype=np.float64, device="cpu")
    np.testing.assert_array_equal(got.numpy(),
                                  jax_ref["full64"].astype(np.int64))


@pytest.mark.parametrize("name", STATE)
def test_la_only_f64_state_matches(jax_ref, la_only_state64, name):
    got = la_only_state64[STATE.index(name)].numpy()
    want = jax_ref["state64_" + name]
    if name in ("dzr", "dzi"):
        assert got.dtype == np.float64
        assert ref.bits_equal(got, want)
    else:
        np.testing.assert_array_equal(got.astype(np.int64),
                                      want.astype(np.int64))


def test_chunked_relaunch_and_abort(deep):
    ptz, res, la = deep
    whole = la_kernel.la_perturb_render(res, la, ptz, 16, 16, BUDGET,
                                        device="cpu")
    chunked = la_kernel.la_perturb_render(res, la, ptz, 16, 16, BUDGET,
                                          chunk_steps=300, device="cpu")
    assert la_kernel.last_run_stats["dispatches"] > 1
    assert torch.equal(whole, chunked)
    aborted = types.SimpleNamespace(aborted=lambda: True)
    part = la_kernel.la_perturb_render(res, la, ptz, 16, 16, BUDGET,
                                       chunk_steps=300, abort_monitor=aborted,
                                       device="cpu")
    assert la_kernel.last_run_stats["dispatches"] == 1
    assert int(part.sum()) < int(whole.sum())


def test_view6_32_matches_jax(jax_ref):
    ptz, res, la, n = _view6()
    np.testing.assert_array_equal(_tables_sha(res, la), jax_ref["v6_sha"])
    T, _ = la_kernel.device_tables(res, la, torch.device("cpu"))
    assert not la_kernel.fits_full_mode(res, T, n)
    got = la_kernel.la_perturb_render(res, la, ptz, V6, V6, n, device="cpu")
    g = got.numpy()
    np.testing.assert_array_equal(g, jax_ref["v6"].astype(np.int64))
    assert (int(g.sum()), zlib.crc32(g.astype("<u4").tobytes())) == VIEW6_32


def test_small_table_fits_full_mode(deep):
    _, res, la = deep
    T, _ = la_kernel.device_tables(res, la, torch.device("cpu"))
    assert la_kernel.fits_full_mode(res, T, BUDGET)
    assert not la_kernel.fits_full_mode(res, T, 1 << 31)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_kernel_matches_plain_on_card(deep, dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    ptz, res, la = deep
    for la_only in (False, True):
        k = la_kernel.la_perturb_render(res, la, ptz, SIZE, SIZE, BUDGET,
                                        sub_dtype=dtype, la_only=la_only,
                                        return_state=True, device="cuda")
        T, orbit = la_kernel.device_tables(res, la, torch.device("cuda"),
                                           dtype)
        from fractalshark_tpu_torch.ops.perturb import (_dc_grids_hdr,
                                                        delta_params)
        dc = _dc_grids_hdr(*delta_params(ptz, res.center_x, res.center_y,
                                         SIZE, SIZE), SIZE, SIZE, "cuda",
                           dtype)
        flat = type(dc)(*(t.reshape(-1) for t in dc))
        p = la_kernel.lav2_plain(
            T, orbit, flat, la_kernel.init_state_plain(T, flat, BUDGET),
            BUDGET, res.max_ref_iteration(), la_only)
        for a, b in zip(k, p):
            assert torch.equal(a.reshape(-1), b)
