"""K9, the whole bignum multiply (``fractalshark_tpu_torch/ops/bignum/
ntt_pallas.py`` ``products``), against the JAX package's flag-off Pallas
kernels in interpret mode, bit for bit: ``_ntt_products`` (B-f1) at nfft
2,048 and 8,192 for the 3-way, NR, iteration and signed NR-iteration
plans, ``_ntt_products_split`` (B-f2) and ``_ntt_products_whole`` (B-f3)
at 32,768; K9's schedule (``products_rounds_plain``: K8's Shoup rounds,
the four-step matrices of ``ntt.k9_tables``) against the same JAX rows
and against ``products_plain`` at every size from 4; then the reference's
routing of the generic multiplies ``multiply_iter`` and
``multiply_nr_iter`` under ``PALLAS_NTT`` and ``PALLAS_NTT_SPLIT`` (flags
off by default; a flag on sends the products to K9's twin, with the
default route's results).  The JAX side runs once per module in a
subprocess (``test_torch_jaxref.run_jax_reference``).  On the card: both
forms against both twins at the smoke's sizes, the C entry's block size
against ``block_threads``, and a second call in the cached scratch.
"""

import numpy as np
import pytest
import torch

import test_torch_jaxref as ref
from fractalshark_tpu_torch import kernels
from fractalshark_tpu_torch.core.highprecision import HighPrecision
from fractalshark_tpu_torch.ops.bignum import fixedpoint as FP
from fractalshark_tpu_torch.ops.bignum import ntt as N
from fractalshark_tpu_torch.ops.bignum import ntt_mxu as NM
from fractalshark_tpu_torch.ops.bignum import ntt_pallas as NP

P = (2013265921, 1811939329)
PLANS = {"3way": (2, NP.PLAN_3WAY, False), "nr": (4, NP.PLAN_NR, False),
         "iter": (2, NP.PLAN_ITER, False),
         "nriter": (4, NP.PLAN_NR_ITER, True)}
SIGNS = np.array([1, -1, -1, 1], np.int32)
B_F1 = [(n, plan) for n in (2048, 8192) for plan in PLANS]
SPLIT_N = 32768
B_F23 = [(form, plan) for form in ("split", "whole")
         for plan in ("iter", "nriter")]


def _values(rng, n):
    """Four value vectors: full-width digits in the low half (the padded
    operands of a product), zeros above, and one row of residues below
    p2 over the whole length."""
    x = np.zeros((4, n), np.uint32)
    x[:3, :n // 2] = rng.integers(0, 1 << 16, (3, n // 2), dtype=np.uint32)
    x[3] = rng.integers(0, P[1], n, dtype=np.uint64).astype(np.uint32)
    return x


def _inputs():
    rng = np.random.default_rng(909)
    return {f"x{n}": _values(rng, n) for n in (2048, 8192, SPLIT_N)}


INPUTS = _inputs()


def _jax_reference(inputs):
    import jax.numpy as jnp

    from fractalshark_tpu.ops.bignum import ntt_pallas as jnp_

    out = {}
    sg = jnp.asarray(SIGNS)
    for n, name in B_F1:
        V, plan, signed = PLANS[name]
        out[f"bf1_{n}_{name}"] = np.asarray(jnp_._ntt_products(
            jnp.asarray(inputs[f"x{n}"][:V]), sg if signed else None, n=n,
            n_values=V, pair_plan=plan, interpret=True))
    for form, name in B_F23:
        V, plan, signed = PLANS[name]
        fn = (jnp_._ntt_products_split if form == "split"
              else jnp_._ntt_products_whole)
        out[f"{form}_{name}"] = np.asarray(fn(
            jnp.asarray(inputs[f"x{SPLIT_N}"][:V]), sg if signed else None,
            n=SPLIT_N, n_values=V, pair_plan=plan, interpret=True))
    return out


@pytest.fixture(scope="module")
def jax_ref(tmp_path_factory):
    return ref.run_jax_reference("test_torch_ntt_fused", "_jax_reference",
                                 tmp_path_factory.mktemp("ntt_fused"), INPUTS)


def _twin(n, name):
    """The plan's reference entry point (rows [2K, n]) as [K, 2, n]."""
    V, plan, signed = PLANS[name]
    x = list(torch.from_numpy(INPUTS[f"x{n}"][:V].astype(np.int32)))
    rows = {"3way": lambda: NP.ntt3way_products(*x, n),
            "nr": lambda: NP.nttnr_products(*x, n),
            "iter": lambda: NP.ntt_iter_products(*x, n),
            "nriter": lambda: NP.ntt_nr_iter_products(
                *x, torch.from_numpy(SIGNS), n)}[name]()
    return rows.reshape(len(plan), 2, n).numpy()


@pytest.mark.parametrize("n,name", B_F1, ids=[f"{n}-{p}" for n, p in B_F1])
def test_products_equal_b_f1(jax_ref, n, name):
    want = jax_ref[f"bf1_{n}_{name}"]
    got = _twin(n, name)
    assert got.shape == want.shape
    np.testing.assert_array_equal(got.astype(np.int64), want.astype(np.int64))


@pytest.mark.parametrize("form,name", B_F23,
                         ids=[f"{f}-{p}" for f, p in B_F23])
def test_products_equal_b_f2_and_b_f3(jax_ref, form, name):
    np.testing.assert_array_equal(_twin(SPLIT_N, name).astype(np.int64),
                                  jax_ref[f"{form}_{name}"].astype(np.int64))


def _rounds(n, name):
    """The plan's rows through K9's schedule twin, [K, 2, n]."""
    V, plan, signed = PLANS[name]
    x = torch.from_numpy(INPUTS[f"x{n}"][:V].astype(np.int32))
    sg = torch.from_numpy(SIGNS[:V]) if signed else None
    return NP.products_rounds_plain(x, sg, n, plan).numpy()


@pytest.mark.parametrize("n,name", B_F1, ids=[f"{n}-{p}" for n, p in B_F1])
def test_rounds_twin_equals_b_f1(jax_ref, n, name):
    np.testing.assert_array_equal(_rounds(n, name).astype(np.int64),
                                  jax_ref[f"bf1_{n}_{name}"].astype(np.int64))


@pytest.mark.parametrize("form,name", B_F23,
                         ids=[f"{f}-{p}" for f, p in B_F23])
def test_rounds_twin_equals_b_f2_and_b_f3(jax_ref, form, name):
    np.testing.assert_array_equal(_rounds(SPLIT_N, name).astype(np.int64),
                                  jax_ref[f"{form}_{name}"].astype(np.int64))


SMALL_N = [1 << k for k in range(2, 11)]


@pytest.mark.parametrize("n", SMALL_N)
def test_rounds_twin_equals_the_plain_twin(n):
    """Every size K9 takes below the reference's, down to n = 4 (the
    kernel's 2- and 4-point rounds), every plan, values up to p1."""
    rng = np.random.default_rng(n)
    for name, (V, plan, signed) in PLANS.items():
        x = np.zeros((V, n), np.int64)
        x[:, :n // 2] = rng.integers(0, 1 << 16, (V, n // 2))
        x[-1] = rng.integers(0, P[0], n)
        x = torch.from_numpy(x.astype(np.int32))
        sg = torch.from_numpy(SIGNS[:V]) if signed else None
        assert torch.equal(NP.products_rounds_plain(x, sg, n, plan),
                           NP.products_plain(x, sg, n, plan)), name


def test_k9_tables_hold_the_scale_stage_tables_and_matrices():
    n = 2048
    n1, n2 = N.split_n(n)
    parts = NP.k9_parts(n, "cpu")
    assert [int(v) for v in parts["scale"]] == \
        [int(v) for v in N.kernel_tables(n)[4 * n:4 * n + 2]]
    for name, m, inverse in (("col_f", n1, False), ("col_i", n1, True),
                             ("row_f", n2, False), ("row_i", n2, True)):
        want = N._k8_table(m, inverse).view(np.uint32).astype(np.int64)
        np.testing.assert_array_equal(parts[name].numpy(), want)
    t1, t1i = N.fourstep_twiddles(n)
    for name, t in (("mat_f", t1), ("mat_i", t1i)):
        for i, p in enumerate(P):
            np.testing.assert_array_equal(parts[name][i].numpy(),
                                          t[i] * (1 << 32) % p)
    assert N.k9_tables(n).size == 4 + 8 * (n1 + n2) + 4 * n


def test_block_threads_fill_the_card():
    """K9's block size: two blocks an SM in the forward phase where the
    work allows, a warp at least; a row block's rows and inverse matrix
    row at 8 words a thread where 256 threads allow; n/8 at most."""
    assert NP.block_threads(2048, 2) == 32
    assert NP.block_threads(16384, 2) == 64      # rows: 3 x 128 words
    assert NP.block_threads(65536, 2) == 128
    assert NP.block_threads(131072, 4) == 256
    assert NP.block_threads(64, 2) == 8
    for k in range(2, 18):
        n = 1 << k
        n2 = n >> (k // 2)
        e1 = min(8, 1 << (k // 2))
        for V in (1, 2, 4):
            t = NP.block_threads(n, V)
            assert t & (t - 1) == 0 and t <= min(512, n // e1)
            assert t >= min(32, n // e1)
            assert 8 * t >= (V + 1) * n2 or t in (256, n // e1)


def test_scratch_is_cached_and_grown():
    """The per-device scratch K9's and K11's wrappers take: a second call
    of the same size or smaller reuses the words, a larger one grows
    them."""
    dev = torch.device("cpu")
    a = kernels.scratch(dev, 1000)
    assert kernels.scratch(dev, 1000).data_ptr() == a.data_ptr()
    assert kernels.scratch(dev, 10).data_ptr() == a.data_ptr()
    b = kernels.scratch(dev, 5000)
    assert b.numel() == 5000
    assert kernels.scratch(dev, 4000).data_ptr() == b.data_ptr()


def test_rows_are_the_exact_convolutions():
    """Every row is the canonical residue of the exact cyclic
    convolution (the reference's "·R" cancels)."""
    rng = np.random.default_rng(3)
    n = 64
    a = rng.integers(0, 1 << 16, n // 2, dtype=np.int64)
    b = rng.integers(0, 1 << 16, n // 2, dtype=np.int64)
    x = np.zeros((2, n), np.int32)
    x[0, :n // 2], x[1, :n // 2] = a, b
    rows = NP.products(torch.from_numpy(x), None, n, NP.PLAN_3WAY).numpy()
    conv = [np.convolve(u, v) for u, v in ((a, a), (b, b), (a, b))]
    for k, c in enumerate(conv):
        full = np.zeros(n, object)
        full[:c.size] = c
        for i, p in enumerate(P):
            np.testing.assert_array_equal(rows[k, i], (full % p).astype(
                np.int64))


def test_forms_and_flags():
    assert NP.product_form(2048) == "whole"
    assert NP.product_form(16384) == "whole"
    assert NP.product_form(32768) == "split"
    assert not (FP.PALLAS_NTT or FP.PALLAS_NTT_SPLIT or NP.WHOLE_ALIGNED or
                NP.BATCHED_TAIL or NM.MXU_ITER_FULL)
    assert NM.MXU_ITER
    assert NP.supported(2048) and not NP.supported(1024)
    assert NP.supported_split(131072) and not NP.supported_split(16384)
    with pytest.raises(ValueError):
        NP.products(torch.zeros(2, 8, dtype=torch.int32), None, 8,
                    (((-1, 0, 0),),))


def test_new_modules_are_walked_for_imports():
    import test_torch_slice
    names = {p.replace("\\", "/").rsplit("/", 1)[-1]
             for p in map(str, test_torch_slice._port_sources())}
    assert {"ntt_pallas.py", "ntt_mxu.py", "fixedpoint.py"} <= names


def _digits(spec, rng, k):
    prec = spec.frac_bits + 30
    return [FP.hp_to_digits(HighPrecision(rng.uniform(-2, 2), prec=prec),
                            spec)[1] for _ in range(k)]


class _Spy:
    """Counts the calls of ntt_pallas.products while passing them on."""

    def __init__(self, monkeypatch):
        self.calls = 0
        real = NP.products

        def spy(*a, **kw):
            self.calls += 1
            return real(*a, **kw)
        monkeypatch.setattr(NP, "products", spy)


# (flags to set, limbs): PALLAS_NTT at nfft 2,048; PALLAS_NTT_SPLIT at
# 32,768 with MXU_ITER off (the reference's precedence at nfft >= 8,192),
# and with WHOLE_ALIGNED
MUL_ROUTES = [({"PALLAS_NTT": True}, 512),
              ({"PALLAS_NTT_SPLIT": True, "MXU_ITER": False}, 8192),
              ({"PALLAS_NTT_SPLIT": True, "MXU_ITER": False,
                "WHOLE_ALIGNED": True}, 8192)]


def _set_flags(monkeypatch, flags):
    for name, v in flags.items():
        mod = {"MXU_ITER": NM, "WHOLE_ALIGNED": NP}.get(name, FP)
        monkeypatch.setattr(mod, name, v)


@pytest.mark.parametrize("flags,limbs", MUL_ROUTES,
                         ids=["pallas_ntt", "split", "whole_aligned"])
def test_flagged_multiplies_equal_the_default_route(monkeypatch, flags,
                                                    limbs):
    spec = FP.FixedSpec.for_limbs(limbs)
    rng = np.random.default_rng(limbs)
    d = _digits(spec, rng, 4)
    signs = (1, -1, -1, 1)
    want_it = FP.multiply_iter(d[0], d[1], spec, device="cpu")
    want_nr = FP.multiply_nr_iter(signs[0], d[0], signs[1], d[1], signs[2],
                                  d[2], signs[3], d[3], spec, device="cpu")
    _set_flags(monkeypatch, flags)
    spy = _Spy(monkeypatch)
    got_it = FP.multiply_iter(d[0], d[1], spec, device="cpu")
    got_nr = FP.multiply_nr_iter(signs[0], d[0], signs[1], d[1], signs[2],
                                 d[2], signs[3], d[3], spec, device="cpu")
    assert spy.calls == 2
    assert int(got_it[0][0]) == int(want_it[0][0])
    assert torch.equal(got_it[0][1], want_it[0][1])
    assert torch.equal(got_it[1], want_it[1])
    for (sa, ma), (sb, mb) in zip(got_nr, want_nr):
        assert int(sa) == int(sb) and torch.equal(ma, mb)


def test_mxu_iter_takes_multiply_iter_first(monkeypatch):
    """The reference's precedence: at nfft >= 8,192 MXU_ITER takes
    multiply_iter before PALLAS_NTT_SPLIT, and multiply_nr_iter has no
    MXU route."""
    spec = FP.FixedSpec.for_limbs(8192)
    monkeypatch.setattr(FP, "PALLAS_NTT_SPLIT", True)
    spy = _Spy(monkeypatch)
    d = _digits(spec, np.random.default_rng(5), 2)
    FP.multiply_iter(d[0], d[1], spec, device="cpu")
    assert spy.calls == 0
    FP.multiply_nr_iter(1, d[0], 1, d[1], 1, d[0], 1, d[1], spec,
                        device="cpu")
    assert spy.calls == 1


# the smoke's sizes and values (chip_smoke.py phase 12)
CARD_N = (2048, 16384, 32768, 131072)


@pytest.mark.cuda
def test_k9_forms_match_the_twin_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    rng = np.random.default_rng(12)
    for n in CARD_N:
        x = torch.zeros(4, n, dtype=torch.int32)
        x[:, :n // 2] = torch.from_numpy(rng.integers(
            0, 1 << 16, (4, n // 2)).astype(np.int32))
        for name, (V, plan, signed) in PLANS.items():
            sg = torch.from_numpy(SIGNS[:V]) if signed else None
            want = NP.products_plain(x[:V], sg, n, plan)
            assert torch.equal(NP.products_rounds_plain(x[:V], sg, n, plan),
                               want), (n, name)
            for form in ("whole", "split"):
                got = NP.launch_products(
                    list(x[:V].cuda()), n,
                    None if sg is None else sg.cuda(), n, plan, form)
                assert torch.equal(got.cpu(), want), (n, name, form)
    for n in (2048, SPLIT_N):
        for name, (V, plan, signed) in PLANS.items():
            x = torch.from_numpy(INPUTS[f"x{n}"][:V].astype(np.int32))
            sg = torch.from_numpy(SIGNS[:V]) if signed else None
            want = NP.products_plain(x, sg, n, plan)
            for form in ("whole", "split"):
                got = NP.launch_products(
                    list(x.cuda()), n, None if sg is None else sg.cuda(), n,
                    plan, form)
                assert torch.equal(got.cpu(), want), (n, name, form)


@pytest.mark.cuda
def test_k9_small_sizes_and_block_size_on_card():
    """K9's 2- and 4-point rounds (n = 4-32) and its block size: the C
    entry's equals the twins' (block_threads) at every size it takes."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    lib = kernels.lib()
    for k in range(2, 18):
        for V in (1, 2, 4):
            assert lib.fs_ntt_products_threads(V, k) == \
                NP.block_threads(1 << k, V), (k, V)
    rng = np.random.default_rng(7)
    for n in SMALL_N:
        V, plan, _ = PLANS["nr"]
        x = torch.from_numpy(rng.integers(0, P[1], (V, n)).astype(np.int32))
        want = NP.products_plain(x, None, n, plan)
        for form in ("whole", "split"):
            got = NP.launch_products(list(x.cuda()), n, None, n, plan, form)
            assert torch.equal(got.cpu(), want), (n, form)


@pytest.mark.cuda
def test_second_call_takes_no_new_scratch_on_card():
    """A second call of launch_products allocates only its output: its
    work is the cached scratch, its tables and plan words made once."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    n = 16384
    V, plan, _ = PLANS["nr"]
    x = torch.from_numpy(INPUTS["x8192"][:V].astype(np.int32)).cuda()
    NP.launch_products(list(x), 8192, None, n, plan, "whole")
    torch.cuda.synchronize()
    work = kernels.scratch(x.device, 2 * (V + len(plan)) * n).data_ptr()
    before = torch.cuda.memory_allocated()
    out = NP.launch_products(list(x), 8192, None, n, plan, "split")
    torch.cuda.synchronize()
    # the output's block (the caching allocator rounds it to 512 bytes)
    assert torch.cuda.memory_allocated() - before == \
        -(-out.numel() * out.element_size() // 512) * 512
    assert kernels.scratch(x.device, 2 * (V + len(plan)) * n).data_ptr() == \
        work
