"""K10, the CRT + carry tail from residue rows (``ntt_pallas.tail`` /
``fused_tail``), and K11, the one-launch orbit step (``ntt_mxu.
mxu_iterate_full``), against the JAX package's Pallas kernels in
interpret mode, bit for bit: ``fused_tail`` (the gridded B8c form) and
``_fused_tail_batched`` (B-f4), orbit and NR configurations, with and
without shadow rows; ``mxu_iterate_full`` (B-f5) at nfft 8,192 with
shadows, and against the port's default ``iterate_z`` (K4 then K5) and
the exact Python-int step; K11's schedule (``iterate_full_tiled_plain``:
K9's rounds, K10's tiles of 4T digits at K11's block size) against
B-f5 and the plain twin, also on steps made to carry across every tile,
to go negative, to vanish and to put the shadow's top digit at the
slice's edges (those also against B-f5).  Then the routes: each flag sends
``iterate_z`` and ``iterate_z_nr`` to its kernels' twins with the
default route's results, and a flagged device-orbit session and NR chunk
equal the default ones.  Flags are set with ``monkeypatch``.
"""

import numpy as np
import pytest
import torch

import test_torch_jaxref as ref
from fractalshark_tpu_torch.core.highprecision import HighPrecision
from fractalshark_tpu_torch.ops.bignum import fixedpoint as FP
from fractalshark_tpu_torch.ops.bignum import ntt_mxu as NM
from fractalshark_tpu_torch.ops.bignum import ntt_pallas as NP
from fractalshark_tpu_torch.ops.bignum import orbit as O

P = (2013265921, 1811939329)
TAIL_N = 2048
TAIL_D = TAIL_N // 2
TAIL_FD = (TAIL_D - 2, TAIL_D)
SGS = np.array([1, -1, -1, 0], np.int32)
TAIL_CASES = [(form, nr, shadow) for form in ("grid", "batched")
              for nr in (False, True) for shadow in (False, True)
              if not (nr and shadow)]
FULL_N = 8192
FULL_D = FULL_N // 2


def _tid(case):
    form, nr, shadow = case
    return f"{form}-{'nr' if nr else 'orbit'}{'-shadow' if shadow else ''}"


def _in_range(spec, rng):
    """Digits of a value in (-2, 2) and its sign."""
    v = HighPrecision(rng.uniform(-2, 2), prec=spec.frac_bits + 30)
    return FP.hp_to_digits(v, spec)


def _inputs():
    rng = np.random.default_rng(4242)
    out = {}
    for K in (2, 4):
        inv = np.stack([np.stack([rng.integers(0, p, TAIL_N, dtype=np.uint64)
                                  for p in P]) for _ in range(K)])
        out[f"inv{K}"] = inv.astype(np.uint32)
        out[f"cadd{K}"] = rng.integers(0, 1 << 16, (K, TAIL_N),
                                       dtype=np.uint32)
    rnd = np.zeros(TAIL_N, np.uint32)
    rnd[TAIL_D - 3] = 1 << 15
    out["rnd"] = rnd
    spec = FP.FixedSpec(digits=FULL_D, nfft=FULL_N)
    st = [_in_range(spec, rng) for _ in range(4)]
    out["z"] = np.stack([d for _, d in st])
    out["zs"] = np.array([s for s, _ in st], np.int32)
    return out


INPUTS = _inputs()


def _full_args(inputs):
    """x, y, c and the planes, cfg of mxu_iterate_full (numpy)."""
    spec = FP.FixedSpec(digits=FULL_D, nfft=FULL_N)
    F, D = spec.frac_digits, spec.digits
    z, zs = inputs["z"], inputs["zs"]
    cadd = np.zeros((2, FULL_N), np.uint32)
    cadd[0, F:F + D], cadd[1, F:F + D] = z[2], z[3]
    rnd = np.zeros(FULL_N, np.uint32)
    rnd[F - 1] = 1 << 15
    cfg = np.array(NP.tail_cfg((zs[2], zs[3], zs[0] * zs[1], 0), False),
                   np.int32)
    return z[0], z[1], cadd, rnd, cfg, (F, D)


def _jax_reference(inputs):
    import jax.numpy as jnp

    from fractalshark_tpu.ops.bignum import ntt_mxu as jmxu
    from fractalshark_tpu.ops.bignum import ntt_pallas as jpal

    out = {}
    for case in TAIL_CASES:
        form, nr, shadow = case
        K = 4 if nr else 2
        inv, cadd, rnd = (jnp.asarray(inputs[k]) for k in
                          (f"inv{K}", f"cadd{K}", "rnd"))
        fd = TAIL_FD if shadow else None
        if form == "grid":
            r = jpal.fused_tail(inv, cadd, rnd, jnp.asarray(SGS), n=TAIL_N,
                                nr=nr, shadow_fd=fd, interpret=True)
        else:
            cfg = jnp.asarray(NP.tail_cfg(SGS, nr), jnp.int32)
            r = jpal._fused_tail_batched(inv, cadd, rnd, cfg, n=TAIL_N,
                                         nr=nr, shadow_fd=fd, interpret=True)
            r = (r[0].reshape(K, TAIL_N), r[1][:, 0, 0]) + \
                ((r[2][:, 0:5, 0],) if shadow else ())
        for i, a in enumerate(r):
            out[f"{_tid(case)}_{i}"] = np.asarray(a)
    x, y, cadd, rnd, cfg, fd = _full_args(inputs)
    r = jmxu.mxu_iterate_full(jnp.asarray(x), jnp.asarray(y),
                              jnp.asarray(cadd), jnp.asarray(rnd),
                              jnp.asarray(cfg), n=FULL_N, shadow_fd=fd,
                              interpret=True, in_digits=FULL_D)
    for i, a in enumerate(r):
        out[f"full_{i}"] = np.asarray(a)
    zero = jnp.zeros(FULL_D, jnp.uint32)
    for name, (cadd, rnd, cfg) in K11_EDGES.items():
        r = jmxu.mxu_iterate_full(zero, zero, jnp.asarray(cadd),
                                  jnp.asarray(rnd),
                                  jnp.asarray(cfg, jnp.int32), n=FULL_N,
                                  shadow_fd=(FULL_D - 2, FULL_D),
                                  interpret=True, in_digits=FULL_D)
        for i, a in enumerate(r):
            out[f"edge_{name}_{i}"] = np.asarray(a)
    return out


@pytest.fixture(scope="module")
def jax_ref(tmp_path_factory):
    return ref.run_jax_reference("test_torch_tail_fused", "_jax_reference",
                                 tmp_path_factory.mktemp("tail_fused"),
                                 INPUTS)


def _t(a):
    return torch.from_numpy(np.asarray(a).astype(np.int32))


def _tail_inputs(nr):
    K = 4 if nr else 2
    return (_t(INPUTS[f"inv{K}"]), _t(INPUTS[f"cadd{K}"]), _t(INPUTS["rnd"]),
            NP.tail_cfg(SGS, nr))


@pytest.mark.parametrize("case", TAIL_CASES, ids=_tid)
def test_tail_twin_equals_fused_tail(jax_ref, monkeypatch, case):
    form, nr, shadow = case
    monkeypatch.setattr(NP, "BATCHED_TAIL", form == "batched")
    inv, cadd, rnd, _ = _tail_inputs(nr)
    got = NP.fused_tail(inv, cadd, rnd, SGS, TAIL_N, nr=nr,
                        shadow_fd=TAIL_FD if shadow else None)
    assert len(got) == (3 if shadow else 2)
    for i, a in enumerate(got):
        np.testing.assert_array_equal(
            a.numpy().astype(np.int64),
            jax_ref[f"{_tid(case)}_{i}"].astype(np.int64))


def test_tail_signs_and_wraps():
    """Both signs occur in the random rows; the magnitudes are canonical
    16-bit digits; a zero sum has sign +1."""
    inv, cadd, rnd, cfg = _tail_inputs(True)
    dig, sgn = NP.fused_tail_plain(inv, cadd, rnd, cfg)
    assert int(dig.max()) <= 0xFFFF and int(dig.min()) >= 0
    z = torch.zeros(2, 2, 64, dtype=torch.int32)
    dig, sgn = NP.fused_tail_plain(z, torch.zeros(2, 64, dtype=torch.int32),
                                   torch.zeros(64, dtype=torch.int32),
                                   [0, -1, -1, 0, 1, -1, -1, 0])
    assert sgn.tolist() == [1, 1] and int(dig.abs().sum()) == 0


def _oracle(spec, sx, x, sy, y, scx, cx, scy, cy):
    """The exact step with Python ints: rhu(x² − y² + cx·2^16F),
    rhu(2xy + cy·2^16F)."""
    shift = FP.DIGIT_BITS * spec.frac_digits

    def val(s, d):
        return int(s) * FP.digits_to_int(d)

    def rhu(v):
        t = v + (1 << (shift - 1))
        return (1 if t >= 0 else -1), abs(t) >> shift

    xi, yi = val(sx, x), val(sy, y)
    return (rhu(xi * xi - yi * yi + (val(scx, cx) << shift)),
            rhu(2 * xi * yi + (val(scy, cy) << shift)))


def test_k11_twin_equals_b_f5_k4_k5_and_the_oracle(jax_ref):
    x, y, cadd, rnd, cfg, fd = _full_args(INPUTS)
    got = NM.mxu_iterate_full(_t(x), _t(y), _t(cadd), _t(rnd), cfg, FULL_N,
                              shadow_fd=fd)
    for i, a in enumerate(got):
        np.testing.assert_array_equal(a.numpy().astype(np.int64),
                                      jax_ref[f"full_{i}"].astype(np.int64))
    spec = FP.FixedSpec(digits=FULL_D, nfft=FULL_N)
    F, D = spec.frac_digits, spec.digits
    zs = INPUTS["zs"]
    row_in = torch.zeros(FP.ROW, dtype=torch.int32)
    row_in[10], row_in[11] = int(zs[0]), int(zs[1])
    nx, ny, row = FP.orbit_tail(FP.orbit_products(_t(x), _t(y), spec),
                                row_in, int(zs[2]), _t(INPUTS["z"][2]),
                                int(zs[3]), _t(INPUTS["z"][3]), spec)
    dig, sgn, shw = got
    assert torch.equal(dig[0, F:F + D], nx) and torch.equal(dig[1, F:F + D],
                                                           ny)
    assert torch.equal(torch.cat([shw.reshape(-1), sgn]), row)
    want = _oracle(spec, zs[0], x, zs[1], y, zs[2], INPUTS["z"][2], zs[3],
                   INPUTS["z"][3])
    for c in range(2):
        assert (int(sgn[c]), FP.digits_to_int(dig[c, F:F + D].numpy())) == \
            want[c]


@pytest.mark.parametrize("seed", (0, 1, 2))
def test_k11_tiled_twin_equals_b_f5(jax_ref, seed):
    x, y, cadd, rnd, cfg, fd = _full_args(INPUTS)
    got = NM.iterate_full_tiled_plain(_t(x), _t(y), _t(cadd), _t(rnd), cfg,
                                      FULL_N, fd,
                                      rng=np.random.default_rng(seed))
    for i, a in enumerate(got):
        np.testing.assert_array_equal(a.numpy().astype(np.int64),
                                      jax_ref[f"full_{i}"].astype(np.int64))


def _k11_edges():
    """name: (cadd [2, n], rnd [n], cfg) of a K11 step from x = y = 0 at
    FULL_N, whose digits are then the addend and round planes' sums."""
    n, D = FULL_N, FULL_D
    F = D - 2
    out = {}
    cadd = np.zeros((2, n), np.uint32)
    rnd = np.zeros(n, np.uint32)
    cadd[0] = 0xFFFF                      # + 1: a carry through every tile
    rnd[0] = 1
    out["carry_across_every_tile"] = (cadd, rnd, [0, 1, 1, 0, 1, 1, 1, 0])
    cadd = np.zeros((2, n), np.uint32)
    cadd[0, 3 * n // 4] = 1               # - that: a negative total
    cadd[1, 5] = 1
    out["negative_total"] = (cadd, np.zeros(n, np.uint32),
                             [0, 1, -1, 0, 1, 1, -1, 0])
    out["zero"] = (np.zeros((2, n), np.uint32), np.zeros(n, np.uint32),
                   [0, 1, 1, 0, 1, -1, -1, 0])
    cadd = np.zeros((2, n), np.uint32)
    cadd[0, F] = 7                        # the slice's lowest digit
    cadd[1, F + D - 1] = 9                # and its highest
    cadd[1, F - 1] = 0xFFFF               # below the slice: not in it
    out["shadow_at_the_slice_edges"] = (cadd, np.zeros(n, np.uint32),
                                        [0, 1, 1, 0, 1, 1, 1, 0])
    return out


K11_EDGES = _k11_edges()


@pytest.mark.parametrize("name", list(K11_EDGES))
def test_k11_tiled_twin_on_edge_steps(jax_ref, name):
    cadd, rnd, cfg = K11_EDGES[name]
    zero = torch.zeros(FULL_D, dtype=torch.int32)
    fd = (FULL_D - 2, FULL_D)
    want = NM.mxu_iterate_full_plain(zero, zero, _t(cadd), _t(rnd), cfg,
                                     FULL_N, fd)
    for i, a in enumerate(want):
        np.testing.assert_array_equal(
            a.numpy().astype(np.int64),
            jax_ref[f"edge_{name}_{i}"].astype(np.int64))
    for seed in range(3):
        got = NM.iterate_full_tiled_plain(zero, zero, _t(cadd), _t(rnd), cfg,
                                          FULL_N, fd,
                                          rng=np.random.default_rng(seed))
        for a, b in zip(got, want):
            assert torch.equal(a, b)
    dig, sgn, shw = want
    if name in ("carry_across_every_tile", "zero"):
        assert int(sgn[0]) == 1 and int(dig[0].abs().sum()) == 0
    if name == "negative_total":
        assert sgn.tolist() == [-1, -1]
    if name == "shadow_at_the_slice_edges":
        assert shw[0].tolist() == [7, 0, 0, 0, 0]
        assert shw[1].tolist() == [0, 0, 0, 9, FULL_D - 4]


# (flags, limbs) of the orbit step's routes: K9 + K10 at nfft 2,048
# (PALLAS_NTT), at 32,768 (PALLAS_NTT_SPLIT with MXU_ITER off, also with
# WHOLE_ALIGNED), each also with BATCHED_TAIL; K11 at 8,192 (MXU_ITER_FULL)
STEP_ROUTES = [
    ({"PALLAS_NTT": True}, 512, "products"),
    ({"PALLAS_NTT": True, "BATCHED_TAIL": True}, 512, "products"),
    ({"PALLAS_NTT_SPLIT": True, "MXU_ITER": False}, 8192, "products"),
    ({"PALLAS_NTT_SPLIT": True, "MXU_ITER": False, "WHOLE_ALIGNED": True,
      "BATCHED_TAIL": True}, 8192, "products"),
    ({"MXU_ITER_FULL": True}, 2048, "full"),
]
STEP_IDS = ["pallas_ntt", "pallas_ntt-batched", "split",
            "whole_aligned-batched", "mxu_iter_full"]


def _set_flags(monkeypatch, flags):
    for name, v in flags.items():
        mod = {"MXU_ITER": NM, "MXU_ITER_FULL": NM, "WHOLE_ALIGNED": NP,
               "BATCHED_TAIL": NP}.get(name, FP)
        monkeypatch.setattr(mod, name, v)


def _state(spec, seed):
    rng = np.random.default_rng(seed)
    st = [_in_range(spec, rng) for _ in range(4)]
    return [v for s, d in st for v in (s, _t(d))]


@pytest.mark.parametrize("flags,limbs,route", STEP_ROUTES, ids=STEP_IDS)
def test_flagged_iterate_z_equals_the_default(monkeypatch, flags, limbs,
                                              route):
    spec = FP.FixedSpec.for_limbs(limbs)
    sx, x, sy, y, scx, cx, scy, cy = _state(spec, limbs)
    assert FP.step_route(spec) == "k4"
    want = FP.iterate_z(sx, x, sy, y, scx, cx, scy, cy, spec)
    _set_flags(monkeypatch, flags)
    assert FP.step_route(spec) == route
    got = FP.iterate_z(sx, x, sy, y, scx, cx, scy, cy, spec)
    for a, b in zip(got, want):
        assert torch.equal(torch.as_tensor(a), torch.as_tensor(b))


def test_mxu_iter_takes_the_step_first(monkeypatch):
    """At nfft >= 8,192 MXU_ITER keeps the step on K4 under PALLAS_NTT_SPLIT,
    as the reference's precedence has it; below 8,192 MXU_ITER_FULL has no
    route."""
    monkeypatch.setattr(FP, "PALLAS_NTT_SPLIT", True)
    assert FP.step_route(FP.FixedSpec.for_limbs(8192)) == "k4"
    assert FP.nr_route(FP.FixedSpec.for_limbs(8192)) == "k4"
    monkeypatch.setattr(NM, "MXU_ITER_FULL", True)
    assert FP.step_route(FP.FixedSpec.for_limbs(512)) == "k4"


def _nr_state(spec, seed):
    """z, c in range; every digit of dz/dc random, so |2z·dz/dc| wraps."""
    rng = np.random.default_rng(seed)
    st = []
    for k, sign in enumerate((1, -1, -1, 1, -1, 1)):
        d = rng.integers(0, 1 << 16, spec.digits, dtype=np.uint32)
        if k not in (2, 3):
            d[-1], d[-2] = 0, d[-2] & 3
        st += [sign, _t(d)]
    return st


@pytest.mark.parametrize("batched", (False, True), ids=("grid", "batched"))
def test_flagged_iterate_z_nr_equals_the_default(monkeypatch, batched):
    spec = FP.FixedSpec.for_limbs(512)
    st = _nr_state(spec, 7)
    want = FP.iterate_z_nr(*st, spec)
    _set_flags(monkeypatch, {"PALLAS_NTT": True, "BATCHED_TAIL": batched})
    assert FP.nr_route(spec) == "products"
    spy = []
    real = NP.tail
    monkeypatch.setattr(NP, "tail", lambda *a, **k: spy.append(1) or
                        real(*a, **k))
    got = FP.iterate_z_nr(*st, spec)
    assert spy
    for a, b in zip(got, want):
        assert torch.equal(torch.as_tensor(a), torch.as_tensor(b))


def _session(limbs, budget):
    from fractalshark_tpu_torch.core.views import get_view_preset
    ptz = get_view_preset(30).ptz
    res = O.compute_reference_orbit_device(
        ptz.pt_x, ptz.pt_y, budget, ptz.radius, limbs32=limbs,
        periodicity=False, chunk_steps=48, device="cpu")
    return res


@pytest.mark.parametrize("flags,limbs,budget", [
    ({"PALLAS_NTT": True, "BATCHED_TAIL": True}, 512, 120),
    ({"MXU_ITER_FULL": True}, 2048, 40)], ids=("pallas_ntt", "full"))
def test_flagged_session_equals_the_default(monkeypatch, flags, limbs,
                                            budget):
    want = _session(limbs, budget)
    _set_flags(monkeypatch, flags)
    got = _session(limbs, budget)
    assert got.count_orbit_entries() == want.count_orbit_entries() == \
        budget + 1
    np.testing.assert_array_equal(got.orbit_x, want.orbit_x)
    np.testing.assert_array_equal(got.orbit_y, want.orbit_y)


def test_flagged_nr_chunk_equals_the_default(monkeypatch):
    spec = FP.FixedSpec.for_limbs(512)
    st = _nr_state(spec, 11)
    signs = [int(s) for s in st[0:8:2]]
    mags = [t.numpy() for t in st[1:8:2]]

    def run():
        s = O.NRState(signs, *mags, "cpu")
        O.orbit_nr_chunk(s, st[8], st[9], st[10], st[11], spec, 6)
        return s.numpy()

    want = run()
    _set_flags(monkeypatch, {"PALLAS_NTT": True})
    got = run()
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


@pytest.mark.cuda
def test_k10_and_k11_match_their_twins_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    for nr in (False, True):
        inv, cadd, rnd, cfg = _tail_inputs(nr)
        fd = None if nr else TAIL_FD
        want = NP.fused_tail_plain(inv, cadd, rnd, cfg, fd)
        for batched in (False, True):
            got = NP.launch_tail(inv.cuda(), cadd.cuda(), rnd.cuda(), cfg, fd,
                                 batched)
            for a, b in zip(got, want):
                assert torch.equal(a.cpu(), b), (nr, batched)
    x, y, cadd, rnd, cfg, fd = _full_args(INPUTS)
    want = NM.mxu_iterate_full(_t(x), _t(y), _t(cadd), _t(rnd), cfg, FULL_N,
                               shadow_fd=fd)
    got = NM.mxu_iterate_full(_t(x).cuda(), _t(y).cuda(), _t(cadd).cuda(),
                              _t(rnd).cuda(), cfg, FULL_N, shadow_fd=fd)
    for a, b in zip(got, want):
        assert torch.equal(a.cpu(), b)
    # the smoke's limb counts from random values in (-2, 2), zsign read on
    # the card; the edge steps
    rng = np.random.default_rng(11)
    for limbs in (2048, 16384):
        spec = FP.FixedSpec.for_limbs(limbs)
        n, F, D = spec.nfft, spec.frac_digits, spec.digits
        st = [_in_range(spec, rng) for _ in range(4)]
        x, y, cx, cy = (_t(d) for _, d in st)
        cadd, rnd = FP.addend_planes(cx, cy, spec)
        cfg = NP.tail_cfg((st[2][0], st[3][0], 1, 0), False)
        zs = (int(st[0][0]), int(st[1][0]))
        want = NM.mxu_iterate_full(x, y, cadd, rnd, cfg, n, (F, D),
                                   zsign=zs)
        assert all(torch.equal(a, b) for a, b in zip(
            NM.iterate_full_tiled_plain(x, y, cadd, rnd, cfg, n, (F, D),
                                        zs), want))
        got = NM.mxu_iterate_full(
            x.cuda(), y.cuda(), cadd.cuda(), rnd.cuda(), cfg, n, (F, D),
            zsign=torch.tensor(zs, dtype=torch.int32, device="cuda"))
        for a, b in zip(got, want):
            assert torch.equal(a.cpu(), b), limbs
    zero = torch.zeros(FULL_D, dtype=torch.int32)
    for name, (cadd, rnd, cfg) in K11_EDGES.items():
        fd = (FULL_D - 2, FULL_D)
        want = NM.mxu_iterate_full_plain(zero, zero, _t(cadd), _t(rnd), cfg,
                                         FULL_N, fd)
        got = NM.mxu_iterate_full(zero.cuda(), zero.cuda(), _t(cadd).cuda(),
                                  _t(rnd).cuda(), cfg, FULL_N, fd)
        for a, b in zip(got, want):
            assert torch.equal(a.cpu(), b), name


@pytest.mark.cuda
def test_k11_second_call_takes_no_new_scratch_on_card():
    """A second K11 call allocates only its outputs: its work is the
    cached scratch, its tail state K10's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    x, y, cadd, rnd, cfg, fd = _full_args(INPUTS)
    x, y, cadd, rnd = (_t(a).cuda() for a in (x, y, cadd, rnd))
    NM.mxu_iterate_full(x, y, cadd, rnd, cfg, FULL_N, shadow_fd=fd)
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    got = NM.mxu_iterate_full(x, y, cadd, rnd, cfg, FULL_N, shadow_fd=fd)
    torch.cuda.synchronize()
    grown = torch.cuda.memory_allocated() - before
    # the outputs' blocks (the caching allocator rounds each to 512 bytes)
    assert grown == sum(-(-a.numel() * a.element_size() // 512) * 512
                        for a in got)
