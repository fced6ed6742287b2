"""K10's tiled schedule (``ntt_pallas.tail_tiled_plain``: segments of 4
digits, tiles of a few segments, the carries across tiles by decoupled
look-back with earlier tiles seen published or not) against
``fused_tail_plain`` and the JAX package's ``_fused_tail_batched`` and
``fused_tail`` in interpret mode, bit for bit, for 1 to 4 components
with and without ``zsign`` and the shadow rows; on values made to carry
and borrow across tile edges (runs of 0xFFFF as View #30's imaginary
part has 1,661 of them, runs of 0), a negative total, zero magnitudes
(sign +1) and a carry out of the top; then against Python ints
(Hypothesis).  The tiles run from 1 segment to K10's and K11's 256,
one and two warps' among them.  On the card, K10 against the tiled
twin."""

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import test_torch_jaxref as ref
from fractalshark_tpu_torch.ops.bignum import ntt as N
from fractalshark_tpu_torch.ops.bignum import ntt_pallas as NP

P1P2 = N.P1 * N.P2
N_RANDOM = 1024
N_EDGE = 2048
# segments a tile: K10's and K11's 256, and smaller (one and two warps)
THREADS = (1, 2, 4, 32, 64, 256)


def _rows(values) -> np.ndarray:
    """The residue rows [2, n] of signed coefficient values."""
    v = [(int(x) + P1P2) % P1P2 for x in values]
    return np.array([[x % N.P1 for x in v], [x % N.P2 for x in v]],
                    np.uint32)


def _edge_values():
    """name: (coefficients, cadd, cfg) of one component at N_EDGE."""
    n = N_EDGE
    zero = np.zeros(n, np.int64)
    out = {}
    v = zero.copy()
    v[0] = 0x10000                   # a carry into 1,661 digits of 0xFFFF
    v[1:1662] = 0xFFFF
    v[1700] = 3
    out["ffff_run_across_tiles"] = (v, np.zeros(n), [0, 1, 1, 0])
    v = zero.copy()
    v[0], v[1:] = 0x10000, 0xFFFF    # every digit carries: out of the top
    out["carry_out_of_the_top"] = (v, np.zeros(n), [0, 1, 1, 0])
    v = zero.copy()
    v[3], v[1500] = -1, 5            # a borrow through a run of 0
    out["zero_run_borrow"] = (v, np.zeros(n), [0, 1, 1, 0])
    v = zero.copy()
    v[100], v[1500] = 7, 1 << 40     # swapped: a negative total
    out["negative_total"] = (v, np.zeros(n), [0, -1, 1, 0])
    out["zero"] = (zero.copy(), np.zeros(n), [1, 1, -1, 0])
    v = zero.copy()
    v[n - 1] = -0xFFFF               # -2^(16L): zero magnitude, negative
    c = np.zeros(n)
    c[n - 1] = 1
    out["negative_zero_magnitude"] = (v, c, [0, 1, -1, 0])
    return out


EDGE = _edge_values()


def _inputs():
    rng = np.random.default_rng(1111)
    n = N_RANDOM
    out = {}
    for K in (1, 2, 3, 4):
        out[f"inv{K}"] = np.stack([np.stack([
            rng.integers(0, p, n, dtype=np.uint64) for p in (N.P1, N.P2)])
            for _ in range(K)]).astype(np.uint32)
        out[f"cadd{K}"] = rng.integers(0, 1 << 16, (K, n), dtype=np.uint32)
        out[f"cfg{K}"] = rng.choice([-1, 0, 1], 4 * K).astype(np.int32)
    rnd = np.zeros(n, np.uint32)
    rnd[n // 2 - 3] = 1 << 15
    out["rnd"] = rnd
    for name, (v, c, cfg) in EDGE.items():
        out[f"e_{name}_inv"] = _rows(v)[None]
        out[f"e_{name}_cadd"] = np.asarray(c, np.uint32)[None]
        out[f"e_{name}_cfg"] = np.asarray(cfg, np.int32)
    return out


INPUTS = _inputs()
ZSIGN = (1, -1)
# (K, shadows, zsign) of the random cases
RANDOM_CASES = [(K, shadow, zs) for K in (1, 2, 3, 4)
                for shadow in (False, True) for zs in (False, True)
                if not (zs and K < 2)]
FD_RANDOM = (N_RANDOM // 2 - 2, N_RANDOM // 2)
FD_EDGE = (100, N_EDGE - 100)


def _rid(case):
    K, shadow, zs = case
    return f"K{K}{'-shadow' if shadow else ''}{'-zsign' if zs else ''}"


def _cfg(K, zs):
    cfg = [int(v) for v in INPUTS[f"cfg{K}"]]
    if zs:
        cfg[5] = ZSIGN[0] * ZSIGN[1]
    return cfg


def _jax_reference(inputs):
    import jax.numpy as jnp

    from fractalshark_tpu.ops.bignum import ntt_pallas as jpal

    def batched(inv, cadd, rnd, cfg, n, fd):
        K = inv.shape[0]
        r = jpal._fused_tail_batched(
            jnp.asarray(inv), jnp.asarray(cadd), jnp.asarray(rnd),
            jnp.asarray(cfg, jnp.int32), n=n, nr=False, shadow_fd=fd,
            interpret=True)
        return (r[0].reshape(K, n), r[1][:, 0, 0]) + \
            ((r[2][:, 0:5, 0],) if fd else ())

    out = {}
    for case in RANDOM_CASES:
        K, shadow, zs = case
        r = batched(inputs[f"inv{K}"], inputs[f"cadd{K}"], inputs["rnd"],
                    _cfg(K, zs), N_RANDOM, FD_RANDOM if shadow else None)
        for i, a in enumerate(r):
            out[f"{_rid(case)}_{i}"] = np.asarray(a)
    # the gridded form, the route with BATCHED_TAIL off (orbit and NR)
    for K, nr in ((2, False), (4, True)):
        sgs = jnp.asarray([1, -1, -1, 0], jnp.int32)
        r = jpal.fused_tail(jnp.asarray(inputs[f"inv{K}"]),
                            jnp.asarray(inputs[f"cadd{K}"]),
                            jnp.asarray(inputs["rnd"]), sgs, n=N_RANDOM,
                            nr=nr, interpret=True)
        for i, a in enumerate(r):
            out[f"grid{K}_{i}"] = np.asarray(a)
    rnd = np.zeros(N_EDGE, np.uint32)
    for name in EDGE:
        r = batched(inputs[f"e_{name}_inv"], inputs[f"e_{name}_cadd"], rnd,
                    [int(v) for v in inputs[f"e_{name}_cfg"]], N_EDGE,
                    FD_EDGE)
        for i, a in enumerate(r):
            out[f"e_{name}_{i}"] = np.asarray(a)
    return out


@pytest.fixture(scope="module")
def jax_ref(tmp_path_factory):
    return ref.run_jax_reference("test_torch_tail_tiled", "_jax_reference",
                                 tmp_path_factory.mktemp("tail_tiled"),
                                 INPUTS)


def _t(a):
    return torch.from_numpy(np.asarray(a).astype(np.int32))


def _same(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(np.asarray(a).astype(np.int64),
                                      np.asarray(b).astype(np.int64))


@pytest.mark.parametrize("threads", THREADS)
@pytest.mark.parametrize("case", RANDOM_CASES, ids=_rid)
def test_tiled_twin_equals_plain_and_jax(jax_ref, case, threads):
    K, shadow, zs = case
    inv, cadd, rnd = (_t(INPUTS[k]) for k in (f"inv{K}", f"cadd{K}",
                                              "rnd"))
    cfg = [int(v) for v in INPUTS[f"cfg{K}"]]
    fd = FD_RANDOM if shadow else None
    got = NP.tail_tiled_plain(inv, cadd, rnd, cfg, fd,
                              zsign=ZSIGN if zs else None, threads=threads,
                              rng=np.random.default_rng(threads))
    _same(got, NP.fused_tail_plain(inv, cadd, rnd, _cfg(K, zs), fd))
    _same(got, [jax_ref[f"{_rid(case)}_{i}"] for i in range(len(got))])


@pytest.mark.parametrize("K", (2, 4))
def test_tiled_twin_equals_the_gridded_jax_tail(jax_ref, K):
    inv, cadd, rnd = (_t(INPUTS[k]) for k in (f"inv{K}", f"cadd{K}",
                                              "rnd"))
    got = NP.tail_tiled_plain(inv, cadd, rnd,
                              NP.tail_cfg((1, -1, -1, 0), K == 4),
                              threads=4, rng=np.random.default_rng(K))
    _same(got, [jax_ref[f"grid{K}_{i}"] for i in range(2)])


@pytest.mark.parametrize("threads", THREADS)
@pytest.mark.parametrize("name", list(EDGE))
def test_tiled_twin_on_carries_across_tiles(jax_ref, name, threads):
    inv, cadd = _t(INPUTS[f"e_{name}_inv"]), _t(INPUTS[f"e_{name}_cadd"])
    rnd = torch.zeros(N_EDGE, dtype=torch.int32)
    cfg = [int(v) for v in INPUTS[f"e_{name}_cfg"]]
    got = NP.tail_tiled_plain(inv, cadd, rnd, cfg, FD_EDGE, threads=threads,
                              rng=np.random.default_rng(threads + 1))
    _same(got, NP.fused_tail_plain(inv, cadd, rnd, cfg, FD_EDGE))
    _same(got, [jax_ref[f"e_{name}_{i}"] for i in range(3)])
    sign = int(got[1][0])
    if name in ("zero", "negative_zero_magnitude", "carry_out_of_the_top"):
        assert sign == 1 and int(got[0].abs().sum()) == 0
    if name == "negative_total":
        assert sign == -1


def _oracle(values, cadd, rnd, cfg, L):
    """(digits, sign) of the tail's function with Python ints."""
    V = 0
    for k, s in enumerate(values):
        s = 2 * s if cfg[0] > 0 else s
        s = -s if cfg[1] < 0 else s
        for q in range(4):
            if k + q < L:
                part = (abs(s) >> (16 * q)) & 0xFFFF
                V += (-part if s < 0 else part) << (16 * (k + q))
    for j in range(L):
        V += ((cadd[j] if cfg[2] > 0 else -cadd[j]) + rnd[j]) << (16 * j)
    mag = abs(V) % (1 << (16 * L))
    return [(mag >> (16 * j)) & 0xFFFF for j in range(L)], \
        -1 if V < 0 and mag else 1


_COEF = st.one_of(st.sampled_from([0, 1, -1, 0xFFFF, -0xFFFF, 0x10000,
                                   -0x10000, (1 << 48) - 1]),
                  st.integers(-(P1P2 // 2 - 1), P1P2 // 2 - 1))


@settings(max_examples=60, deadline=None)
@given(data=st.data(), quarter_n=st.sampled_from([4, 16, 64]),
       threads=st.sampled_from([1, 2, 4]),
       cfg=st.tuples(st.sampled_from([0, 1]), st.sampled_from([-1, 1]),
                     st.sampled_from([-1, 1])))
def test_tiled_twin_against_python_ints(data, quarter_n, threads, cfg):
    n = 4 * quarter_n
    L = 4 * data.draw(st.integers(1, quarter_n))
    values = data.draw(st.lists(_COEF, min_size=n, max_size=n))
    cadd = data.draw(st.lists(st.sampled_from([0, 0, 0xFFFF, 1, 0x8000]),
                              min_size=L, max_size=L))
    rnd = [0] * L
    rnd[L // 2] = 1 << 15
    cfg = [cfg[0], cfg[1], cfg[2], 0]
    got = NP.tail_tiled_plain(_t(_rows(values)[None]), _t([cadd]), _t(rnd),
                              cfg, threads=threads,
                              rng=np.random.default_rng(L))
    digits, sign = _oracle(values, cadd, rnd, cfg, L)
    assert got[0][0].tolist() == digits and int(got[1][0]) == sign


@pytest.mark.cuda
def test_k10_matches_the_tiled_twin_on_card(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    for case in RANDOM_CASES:
        K, shadow, zs = case
        inv, cadd, rnd = (_t(INPUTS[k]) for k in (f"inv{K}", f"cadd{K}",
                                                  "rnd"))
        cfg = [int(v) for v in INPUTS[f"cfg{K}"]]
        fd = FD_RANDOM if shadow else None
        want = NP.tail_tiled_plain(inv, cadd, rnd, cfg, fd,
                                   zsign=ZSIGN if zs else None)
        zsign = torch.tensor(ZSIGN, dtype=torch.int32,
                             device="cuda") if zs else None
        for batched in (False, True):
            monkeypatch.setattr(NP, "BATCHED_TAIL", batched)
            got = NP.tail(inv.cuda(), cadd.cuda(), rnd.cuda(), cfg, fd,
                          zsign)
            _same([a.cpu() for a in got], want)
    rnd = torch.zeros(N_EDGE, dtype=torch.int32)
    for name in EDGE:
        inv, cadd = _t(INPUTS[f"e_{name}_inv"]), _t(INPUTS[f"e_{name}_cadd"])
        cfg = [int(v) for v in INPUTS[f"e_{name}_cfg"]]
        want = NP.tail_tiled_plain(inv, cadd, rnd, cfg, FD_EDGE)
        got = NP.tail(inv.cuda(), cadd.cuda(), rnd.cuda(), cfg, FD_EDGE)
        _same([a.cpu() for a in got], want)
