"""The generic NTT of the port (``fractalshark_tpu_torch/ops/bignum/ntt.py``,
K8's plain twin) and the generic multiplies and debug checksums built on
it, against the JAX package, bit for bit: the phase transform against
``_axis0_dif``/``_axis0_dit``, the MXU form ``mxu_transform_pallas`` and
the sublane form ``sublane_transform`` (both Pallas, interpret mode);
the four-step and flat transforms, and the twins of the four-step's two
K8 launches (the twiddle matrix, transpose and scale in their
epilogues) against the four-step with that glue between its phases and
against JAX at every row count of the multiplies; ``multiply_3way``, ``multiply_iter``,
``multiply_nr`` and ``multiply_nr_iter`` against JAX and against Python
ints; the ``checksum_multiply_3way`` record key for key.

A phase transforms every (row, lane) column on its own, so the JAX side
transforms one [14, m, 128] input per (m, direction) and each of the
port's cases, R rows by L lanes, is held to those rows and lanes of it.
The JAX multiplies run under ``jax.jit`` (exact integer programs: the
same outputs as eager, in a fraction of the time).
"""

import functools
import itertools

import numpy as np
import pytest
import torch

import test_torch_jaxref as ref
from fractalshark_tpu_torch.core.highprecision import HighPrecision
from fractalshark_tpu_torch.ops.bignum import debug as DBG
from fractalshark_tpu_torch.ops.bignum import fixedpoint as FP
from fractalshark_tpu_torch.ops.bignum import ntt as N

PHASE_M, PHASE_R, PHASE_L = (8, 64, 256), (2, 4, 6, 14), (1, 128)
PHASES = list(itertools.product(PHASE_M, PHASE_R, PHASE_L, (False, True)))
FOURSTEP = [(8192, 4), (65536, 6)]
# the four-step as K8's two launches a transform: every row count the
# generic multiplies use (4/6: multiply_3way's forward/inverse, 8/14:
# multiply_nr's)
FUSED = [(n, r) for n in (8192, 65536) for r in (4, 6, 8, 14)]
FLAT_N = 4096
LIMBS = (256, 2048, 4096)
WIDE_LIMBS = 256         # full-width random digits: pins the stream wraps
CHECKSUM_LIMBS = (8, 256)


def _pid(case):
    m, r, l, inv = case
    return f"m{m}_r{r}_l{l}_{'inv' if inv else 'fwd'}"


def _residues(rng, shape):
    out = np.empty(shape, np.uint32)
    for r in range(shape[0]):
        out[r] = rng.integers(0, (N.P1, N.P2)[r % 2], shape[1:],
                              dtype=np.uint64)
    return out


def _in_range_digits(spec, rng, k):
    """k digit vectors of |values| < 2 (the fixed-point range)."""
    prec = spec.frac_bits + 30
    return [FP.hp_to_digits(HighPrecision(rng.uniform(-2, 2), prec=prec),
                            spec)[1] for _ in range(k)]


def _inputs():
    rng = np.random.default_rng(2024)
    out = {}
    for m in PHASE_M:
        out[f"phase_{m}"] = _residues(rng, (max(PHASE_R), m, max(PHASE_L)))
    for n, r in FOURSTEP:
        out[f"fs_{n}"] = _residues(rng, (r, n))
    out["flat"] = _residues(rng, (4, FLAT_N))
    for limbs in LIMBS:
        spec = FP.FixedSpec.for_limbs(limbs)
        out[f"mul_{limbs}"] = np.stack(_in_range_digits(spec, rng, 4))
    spec = FP.FixedSpec.for_limbs(WIDE_LIMBS)
    out["wide"] = rng.integers(0, 1 << 16, (4, spec.digits), dtype=np.uint32)
    for limbs in CHECKSUM_LIMBS:
        out[f"ck_{limbs}"] = np.stack(
            _in_range_digits(FP.FixedSpec.for_limbs(limbs), rng, 2))
    for n, r in FUSED:
        out[f"fused_{n}_{r}"] = _residues(rng, (r, n))
    return out


INPUTS = _inputs()
NR_SIGNS = (1, -1, -1, 1)


def _jax_reference(inputs):
    import jax
    import jax.numpy as jnp

    from fractalshark_tpu.ops.bignum import debug as jdbg
    from fractalshark_tpu.ops.bignum import fixedpoint as jfp
    from fractalshark_tpu.ops.bignum import ntt as jn
    from fractalshark_tpu.ops.bignum import ntt_mxu as jmxu
    from fractalshark_tpu.ops.bignum import ntt_pallas as jpal

    out = {}
    rows = max(PHASE_R)
    p_col, _ = jn._row_consts(rows)
    for m, inv in itertools.product(PHASE_M, (False, True)):
        y = jnp.asarray(inputs[f"phase_{m}"])
        key = f"{m}_{inv}"
        tws = jn._stage_tw_shoup(m, rows, inv)
        out["axis0_" + key] = np.asarray(
            (jn._axis0_dit if inv else jn._axis0_dif)(y, tws, p_col))
        out["mxu_" + key] = np.asarray(jmxu.mxu_transform_pallas(
            y, m=m, inverse=inv, interpret=True))
        out["sub_" + key] = np.asarray(jpal.sublane_transform(
            y, m=m, inverse=inv, interpret=True))
    for n, _ in FOURSTEP:
        x = jnp.asarray(inputs[f"fs_{n}"])
        out[f"fs_fwd_{n}"] = np.asarray(jax.jit(
            functools.partial(jn.fourstep_forward, n=n))(x))
        for r in (False, True):
            out[f"fs_inv_{n}_{r}"] = np.asarray(jax.jit(functools.partial(
                jn.fourstep_inverse_scaled, n=n, extra_scale_r=r))(x))
    for n, r in FUSED:
        x = jnp.asarray(inputs[f"fused_{n}_{r}"])
        out[f"fused_fwd_{n}_{r}"] = np.asarray(jax.jit(
            functools.partial(jn.fourstep_forward, n=n))(x))
        out[f"fused_inv_{n}_{r}"] = np.asarray(jax.jit(functools.partial(
            jn.fourstep_inverse_scaled, n=n, extra_scale_r=True))(x))
    x = jnp.asarray(inputs["flat"])
    out["flat_fwd"] = np.asarray(jax.jit(
        functools.partial(jn.shoup_forward, n=FLAT_N))(x))
    out["flat_inv"] = np.asarray(jax.jit(
        functools.partial(jn.shoup_inverse_scaled, n=FLAT_N))(x))

    def muls(tag, limbs, d, signed_only=False):
        spec = jfp.FixedSpec.for_limbs(limbs)
        x, y, dx, dy = (jnp.asarray(v) for v in d)

        def run(f, *args):
            return jax.jit(functools.partial(f, spec=spec))(*args)

        if not signed_only:
            for i, v in enumerate(run(jfp.multiply_3way, x, y)):
                out[f"{tag}_3way_{i}"] = np.asarray(v)
            for i, v in enumerate(run(jfp.multiply_nr, x, y, dx, dy)):
                out[f"{tag}_nr_{i}"] = np.asarray(v)
        (s, dd), xy = run(jfp.multiply_iter, x, y)
        out[f"{tag}_iter_s"] = np.asarray(s)
        out[f"{tag}_iter_d"] = np.asarray(dd)
        out[f"{tag}_iter_xy"] = np.asarray(xy)
        sg = [jnp.int32(s) for s in NR_SIGNS]
        res = run(lambda x, y, dx, dy, spec: jfp.multiply_nr_iter(
            sg[0], x, sg[1], y, sg[2], dx, sg[3], dy, spec), x, y, dx, dy)
        for i, (s, v) in enumerate(res):
            out[f"{tag}_nri_s{i}"] = np.asarray(s)
            out[f"{tag}_nri_{i}"] = np.asarray(v)

    for limbs in LIMBS:
        muls(f"m{limbs}", limbs, inputs[f"mul_{limbs}"])
    muls("wide", WIDE_LIMBS, inputs["wide"], signed_only=True)
    for limbs in CHECKSUM_LIMBS:
        dx, dy = inputs[f"ck_{limbs}"]
        rec = jdbg.checksum_multiply_3way(
            dx, dy, jfp.FixedSpec.for_limbs(limbs))
        out[f"ck_{limbs}_keys"] = np.array(list(rec))
        out[f"ck_{limbs}_vals"] = np.array(list(rec.values()), np.uint64)
    return out


@pytest.fixture(scope="module")
def jax_ref(tmp_path_factory):
    return ref.run_jax_reference("test_torch_ntt_phase", "_jax_reference",
                                 tmp_path_factory.mktemp("ntt_phase"),
                                 INPUTS)


def _t(a):
    return torch.from_numpy(np.asarray(a).astype(np.int32))


@pytest.mark.parametrize("case", PHASES, ids=_pid)
def test_phase_matches_all_three_reference_forms(jax_ref, case):
    m, r, l, inv = case
    y = _t(INPUTS[f"phase_{m}"][:r, :, :l])
    got = N.phase_transform(y, m, inv).numpy().astype(np.uint32)
    for form in ("axis0", "mxu", "sub"):
        np.testing.assert_array_equal(
            got, jax_ref[f"{form}_{m}_{inv}"][:r, :, :l], err_msg=form)


@pytest.mark.parametrize("n", [n for n, _ in FOURSTEP])
def test_fourstep_matches_jax(jax_ref, n):
    x = _t(INPUTS[f"fs_{n}"])
    fwd = N.fourstep_forward(x, n)
    np.testing.assert_array_equal(fwd.numpy().astype(np.uint32),
                                  jax_ref[f"fs_fwd_{n}"])
    for r in (False, True):
        np.testing.assert_array_equal(
            N.fourstep_inverse_scaled(x, n, extra_scale_r=r).numpy()
            .astype(np.uint32), jax_ref[f"fs_inv_{n}_{r}"])
    assert torch.equal(N.fourstep_inverse_scaled(fwd, n, False), x)


def _fourstep_reference(x, n, inverse):
    """The four-step as the port ran it before K8 took its glue: the
    phases' twin with the twiddle matrix, the transpose and the scale as
    tensor operations between them (``ntt.py:678-718``)."""
    rows = x.shape[0]
    n1, n2 = N.split_n(n)
    t1, t1i = (torch.from_numpy(t)[N._row_idx(rows, "cpu")]
               for t in N.fourstep_twiddles(n))
    if not inverse:
        b = N.phase_transform_plain(x.reshape(rows, n1, n2), n1, False)
        b = N.mul_rows(b, t1)
        e = N.phase_transform_plain(b.transpose(1, 2).contiguous(), n2,
                                    False)
        return e.reshape(rows, n)
    bt = N.phase_transform_plain(x.reshape(rows, n2, n1), n2, True)
    b = N.mul_rows(bt.transpose(1, 2).contiguous(), t1i)
    a = N.phase_transform_plain(b, n1, True)
    return N._scale(a.reshape(rows, n), n, True)


@pytest.mark.parametrize("case", FUSED, ids=lambda c: f"n{c[0]}_r{c[1]}")
def test_fused_launches_match_fourstep_and_jax(jax_ref, case):
    """The twins of K8's two launches a transform (the twiddle matrix and
    transpose in the first's epilogue, the scale in the inverse's second)
    equal the four-step with its glue between the phases and the JAX
    package's transforms, bit for bit; the first launch's output is the
    second's input, with no operation between them."""
    n, r = case
    x = _t(INPUTS[f"fused_{n}_{r}"])
    n1, n2 = N.split_n(n)
    for inverse, key in ((False, "fwd"), (True, "inv")):
        head = N.fourstep_head_plain(x, n, inverse)
        assert head.shape == ((r, n1, n2) if inverse else (r, n2, n1))
        got = N.fourstep_tail_plain(head, n, inverse).reshape(r, n)
        assert torch.equal(got, _fourstep_reference(x, n, inverse))
        np.testing.assert_array_equal(got.numpy().astype(np.uint32),
                                      jax_ref[f"fused_{key}_{n}_{r}"])
        public = (N.fourstep_inverse_scaled(x, n) if inverse
                  else N.fourstep_forward(x, n))
        assert torch.equal(public, got)


def test_fused_entries_refuse_bad_inputs():
    """The fused launches' wrappers check their operands before any
    launch: the matrix's shape and type, a matrix with a scale, the
    transform's type and size, the row count."""
    y = torch.zeros(4, 64, 128, dtype=torch.int32)
    for mat in (torch.zeros(2, 64, 128, dtype=torch.int32),
                torch.zeros(2, 128, 64, dtype=torch.int64)):
        with pytest.raises(ValueError, match="matrix"):
            N.phase_kernel(y, 64, False, mat=mat)
    with pytest.raises(ValueError, match="matrix"):
        N.phase_kernel(y, 64, False, scale=(1, 1),
                       mat=torch.zeros(2, 128, 64, dtype=torch.int32))
    with pytest.raises(ValueError, match="rows"):
        N.phase_kernel(torch.zeros(0, 64, 128, dtype=torch.int32), 64,
                       False)
    for bad in (torch.zeros(4, 8192, dtype=torch.int64),
                torch.zeros(4, 4096, dtype=torch.int32)):
        for call in (N.fourstep_head, N.fourstep_tail):
            with pytest.raises(ValueError):
                call(bad, 8192, False)
    with pytest.raises(ValueError):
        N.fourstep_forward(torch.zeros(4, 8191, dtype=torch.int32), 8191)


def test_per_row_constants_made_once():
    """A per-row constant is made on the device once per (values, rows,
    device) and reused: no host-to-device copy per call; the products
    stay exact."""
    rng = np.random.default_rng(8)
    a = _t(_residues(rng, (6, 64)))
    b = _t(_residues(rng, (6, 64)))
    first = N._per_row(N._PS, a)
    assert N._per_row(N._PS, a).data_ptr() == first.data_ptr()
    assert N._per_row(N._PS, a[:4]).data_ptr() != first.data_ptr()
    assert first.flatten().tolist() == [N._PS[r % 2] for r in range(6)]
    p = torch.tensor([N._PS[r % 2] for r in range(6)])[:, None]
    ai, bi = a.to(torch.int64), b.to(torch.int64)
    rinv = torch.tensor([pow(1 << 32, -1, N._PS[r % 2]) for r in range(6)])
    for _ in range(2):
        assert torch.equal(N.mul_rows(a, b), (ai * bi % p).to(torch.int32))
        assert torch.equal(N.mont_mul_rows(a, b), (ai * bi % p * rinv[:, None]
                                                   % p).to(torch.int32))
        assert torch.equal(N.mod_add_rows(a, b), ((ai + bi) % p).to(
            torch.int32))
        assert torch.equal(N.mod_sub_rows(a, b), ((ai - bi) % p).to(
            torch.int32))


def test_flat_transform_matches_jax(jax_ref):
    x = _t(INPUTS["flat"])
    np.testing.assert_array_equal(
        N.shoup_forward(x, FLAT_N).numpy().astype(np.uint32),
        jax_ref["flat_fwd"])
    np.testing.assert_array_equal(
        N.shoup_inverse_scaled(x, FLAT_N).numpy().astype(np.uint32),
        jax_ref["flat_inv"])


def test_fourstep_tables_equal_jax_constants():
    from fractalshark_tpu.ops.bignum import ntt as jn
    c = jn._fourstep_consts(8192, 2)
    t1, t1i = N.fourstep_twiddles(8192)
    np.testing.assert_array_equal(t1, c["t1"][0])
    np.testing.assert_array_equal(t1i, c["t1i"][0])
    for key, m, inv in (("tw1_f", c["n1"], False), ("tw2_i", c["n2"], True)):
        for mine, theirs in zip(N.stage_twiddles(m, 2, inv), c[key]):
            np.testing.assert_array_equal(mine, theirs[0])


def _signed(s, v, spec):
    """The reference's rounding of a signed product: sign −1 iff
    v + half < 0, magnitude (|v + half| >> 16F) mod 2^16D."""
    t = v + (1 << (spec.frac_bits - 1))
    return (-1 if t < 0 else 1), (abs(t) >> spec.frac_bits) % (
        1 << (16 * spec.digits))


def _oracle(limbs, d):
    spec = FP.FixedSpec.for_limbs(limbs)
    x, y, dx, dy = (FP.digits_to_int(v) for v in d)
    us = [_signed(1, a * b, spec)[1] for a, b in
          ((x, x), (y, y), (x, y), (x, dx), (x, dy), (y, dx), (y, dy))]
    X, Y, DX, DY = (s * v for s, v in zip(NR_SIGNS, (x, y, dx, dy)))
    nri = [_signed(1, v, spec) for v in
           (X * X - Y * Y, X * Y, X * DX - Y * DY, X * DY + Y * DX)]
    return us, _signed(1, x * x - y * y, spec), nri


def _muls(limbs, d, signed_only=False):
    spec = FP.FixedSpec.for_limbs(limbs)
    x, y, dx, dy = d
    out = {}
    if not signed_only:
        for i, v in enumerate(FP.multiply_3way(x, y, spec, device="cpu")):
            out[f"3way_{i}"] = v
        for i, v in enumerate(FP.multiply_nr(x, y, dx, dy, spec,
                                             device="cpu")):
            out[f"nr_{i}"] = v
    (s, dd), xy = FP.multiply_iter(x, y, spec, device="cpu")
    out.update(iter_s=s, iter_d=dd, iter_xy=xy)
    sg = NR_SIGNS
    res = FP.multiply_nr_iter(sg[0], x, sg[1], y, sg[2], dx, sg[3], dy, spec,
                              device="cpu")
    for i, (s, v) in enumerate(res):
        out[f"nri_s{i}"] = s
        out[f"nri_{i}"] = v
    return out


def _assert_muls_equal_jax(got, jax_ref, tag):
    for k, v in got.items():
        want = jax_ref[f"{tag}_{k}"]
        np.testing.assert_array_equal(v.numpy().astype(want.dtype), want,
                                      err_msg=k)


@pytest.mark.parametrize("limbs", LIMBS)
def test_multiplies_match_jax_and_python_ints(jax_ref, limbs):
    d = INPUTS[f"mul_{limbs}"]
    got = _muls(limbs, d)
    _assert_muls_equal_jax(got, jax_ref, f"m{limbs}")
    us, (sd, md), nri = _oracle(limbs, d)
    val = FP.digits_to_int
    assert [val(got[f"3way_{i}"].numpy()) for i in range(3)] == us[:3]
    assert [val(got[f"nr_{i}"].numpy()) for i in range(7)] == us
    assert (int(got["iter_s"]), val(got["iter_d"].numpy())) == (sd, md)
    assert val(got["iter_xy"].numpy()) == us[2]
    assert [(int(got[f"nri_s{i}"]), val(got[f"nri_{i}"].numpy()))
            for i in range(4)] == nri


def test_full_width_digits_wrap_as_jax(jax_ref):
    """Random digits over the whole width overflow the fixed-point
    range; the signed streams then wrap modulo 2^32D as in the
    reference."""
    _assert_muls_equal_jax(_muls(WIDE_LIMBS, INPUTS["wide"], True), jax_ref,
                           "wide")


@pytest.mark.parametrize("limbs", CHECKSUM_LIMBS)
def test_checksum_record_matches_jax(jax_ref, limbs):
    spec = FP.FixedSpec.for_limbs(limbs)
    dx, dy = INPUTS[f"ck_{limbs}"]
    rec = DBG.checksum_multiply_3way(dx, dy, spec, device="cpu")
    assert list(rec) == list(jax_ref[f"ck_{limbs}_keys"]) == \
        list(DBG.PURPOSES)
    assert list(rec.values()) == [int(v) for v in jax_ref[f"ck_{limbs}_vals"]]
    host = DBG.host_multiply_3way_checksums(dx, dy, spec)
    assert DBG.diff_checksums(rec, host) == []
    bad = dx.copy()
    bad[0] ^= 1
    assert "input_x_digits" in DBG.diff_checksums(
        DBG.checksum_multiply_3way(bad, dy, spec, device="cpu"), host)


def test_entry_points_need_the_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    spec = FP.FixedSpec.for_limbs(8)
    d = np.zeros(spec.digits, np.uint32)
    for call in (lambda: FP.multiply_3way(d, d, spec),
                 lambda: FP.multiply_iter(d, d, spec),
                 lambda: FP.multiply_nr(d, d, d, d, spec),
                 lambda: FP.multiply_nr_iter(1, d, 1, d, 1, d, 1, d, spec),
                 lambda: DBG.checksum_multiply_3way(d, d, spec)):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()


def test_phase_rejects_unsupported_shapes():
    with pytest.raises(ValueError):
        N.phase_transform(torch.zeros(2, 8192, 1, dtype=torch.int32), 8192,
                          False)
    with pytest.raises(ValueError):
        N.phase_transform(torch.zeros(2, 8, 4, dtype=torch.int64), 8, False)


@pytest.mark.cuda
def test_kernel_matches_plain_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    rng = np.random.default_rng(5)
    for m, r, l in ((8, 2, 1), (256, 4, 512), (512, 14, 256), (4096, 2, 3)):
        y = _t(_residues(rng, (r, m, l))).cuda()
        for inv in (False, True):
            assert torch.equal(N.phase_transform(y, m, inv),
                               N.phase_transform_plain(y, m, inv))
    limbs = 2048
    d = INPUTS[f"mul_{limbs}"]
    spec = FP.FixedSpec.for_limbs(limbs)
    us, _, _ = _oracle(limbs, d)
    got = FP.multiply_nr(*d, spec, device="cuda")
    assert [FP.digits_to_int(v.cpu().numpy()) for v in got] == us


@pytest.mark.cuda
def test_fused_launches_match_twins_on_card():
    """K8's two launches a four-step transform, each against its twin at
    every size and row count the generic multiplies use, and the flat
    inverse with its scale epilogue."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from fractalshark_tpu_torch import kernels
    rng = np.random.default_rng(6)
    for n in (8192, 65536, 131072):
        for r in (4, 6, 8, 14):
            x = _t(_residues(rng, (r, n))).cuda()
            for inverse in (False, True):
                kernels.reset_counts()
                head = N.fourstep_head(x, n, inverse)
                want = N.fourstep_head_plain(x, n, inverse)
                assert torch.equal(head, want), (n, r, inverse)
                assert torch.equal(N.fourstep_tail(want, n, inverse),
                                   N.fourstep_tail_plain(want, n, inverse))
                assert kernels.launches["ntt_phase"] == 2
    for n in (64, 4096):
        x = _t(_residues(rng, (4, n)))
        assert torch.equal(N.shoup_inverse_scaled(x.cuda(), n).cpu(),
                           N.shoup_inverse_scaled(x, n))
