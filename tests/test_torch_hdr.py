"""HDR and df32 primitives of the port (``ops/hdrfloat.py``,
``ops/dblflt.py``) against the JAX package's, bit for bit, on seeded
random inputs plus edges: zero sentinels, exponent gaps of 120, 126 and
127, negative values, products that underflow (flushed on both sides).
The HDR ops run with f32 and with f64 mantissas (the ``_f64`` cases:
the same exponents, mantissas from 1e-160 to 1e150, so f64 products
underflow too).
"""

import numpy as np
import pytest
import torch

import test_torch_jaxref as ref
from fractalshark_tpu_torch.ops import dblflt as tdf
from fractalshark_tpu_torch.ops import hdrfloat as th

N = 2048
MIN_E = th.MIN_BIG_EXPONENT


def _inputs():
    rng = np.random.default_rng(20261016)

    def mant(scale_mix=True):
        m = rng.standard_normal(N).astype(np.float32)
        if scale_mix:
            k = rng.integers(0, 6, N)
            m = np.where(k == 0, np.float32(0), m)
            m = np.where(k == 1, m * np.float32(1e-20), m)
            m = np.where(k == 2, m * np.float32(1e18), m)
            m = np.where(k == 3, np.sign(m) * (1 + np.abs(m) % 1), m)
        return m.astype(np.float32)

    def mant64():
        m = rng.standard_normal(N)
        k = rng.integers(0, 6, N)
        m = np.where(k == 0, 0.0, m)
        m = np.where(k == 1, m * 1e-160, m)
        m = np.where(k == 2, m * 1e150, m)
        return np.where(k == 3, np.sign(m) * (1 + np.abs(m) % 1), m)

    e1 = rng.integers(-200, 200, N).astype(np.int32)
    gap = rng.choice(np.array([0, 1, 119, 120, 121, 125, 126, 127, 128, 300],
                              np.int32), N)
    sign = rng.choice(np.array([-1, 1], np.int32), N)
    e2 = (e1 + sign * gap).astype(np.int32)
    out = {"re1": mant(), "im1": mant(), "e1": e1,
           "re2": mant(), "im2": mant(), "e2": e2,
           "shift": rng.integers(-300, 300, N).astype(np.int32),
           "f64": rng.standard_normal(N) * 10.0 ** rng.integers(-300, 300, N)}
    for name in ("re1", "im1", "re2", "im2"):
        out[name + "_64"] = mant64()
    for a, e in (("re1", "e1"), ("re2", "e2")):
        zero = (out[a] == 0) | (out[a + "_64"] == 0)
        out[e] = np.where(zero & (rng.random(N) < 0.5), MIN_E,
                          out[e]).astype(np.int32)
    x = rng.standard_normal(N) * 10.0 ** rng.integers(-8, 8, N)
    y = rng.standard_normal(N) * 10.0 ** rng.integers(-8, 8, N)
    for name, v in (("x", x), ("y", y)):
        hi = v.astype(np.float32)
        out[name + "h"] = hi
        out[name + "l"] = (v - hi.astype(np.float64)).astype(np.float32)
    return out


def _hdr_ops(H, T, inp, key="", name="", k=5):
    """The HDR ops on the mantissas `re1{key}`... (f32: key "", f64:
    key "_64"), named with the suffix `name`."""
    a = H.HDR(T(inp["re1" + key]), T(inp["e1"]))
    b = H.HDR(T(inp["re2" + key]), T(inp["e2"]))
    ca = H.HDRComplex(T(inp["re1" + key]), T(inp["im1" + key]),
                      T(inp["e1"]))
    cb = H.HDRComplex(T(inp["re2" + key]), T(inp["im2" + key]),
                      T(inp["e2"]))
    ra, rb = H.reduce(a), H.reduce(b)
    pa = H.HDR(abs(ra.m), ra.e)
    pb = H.HDR(abs(rb.m), rb.e)
    ops = {
        "reduce": lambda: ra,
        "reduce_complex": lambda: H.reduce_complex(ca),
        "add": lambda: H.add(a, b),
        "sub": lambda: H.sub(a, b),
        "mul": lambda: H.mul(a, b),
        "complex_from_hdr": lambda: H.complex_from_hdr(ra, rb),
        "complex_add": lambda: H.complex_add(ca, cb),
        "complex_mul": lambda: H.complex_mul(ca, cb),
        "complex_sqr": lambda: H.complex_sqr(ca),
        "complex_mul_pow2": lambda: H.complex_mul_pow2(ca, k),
        "norm_squared": lambda: H.norm_squared(ca),
        "chebychev_norm": lambda: H.chebychev_norm(ca),
        "gt_reduced": lambda: H.gt_reduced(ra, rb),
        "lt_reduced": lambda: H.lt_reduced(ra, rb),
        "lte_reduced": lambda: H.lte_reduced(ra, rb),
        "lt_unreduced": lambda: H.lt_unreduced(pa, pb),
        "gt_pow2_unreduced": lambda: H.gt_pow2_unreduced(pa, 8),
    }
    return {op + name: fn for op, fn in ops.items()}


def _ops(H, D, T, inp):
    """The op table, written once for both packages: H/D are the
    hdrfloat/dblflt modules, T turns an input into that side's array
    type."""
    xa = D.DF(T(inp["xh"]), T(inp["xl"]))
    xb = D.DF(T(inp["yh"]), T(inp["yl"]))
    return {
        "frexp2_f32": lambda: H._frexp2(T(inp["re1"])),
        "frexp2_f64": lambda: H._frexp2(T(inp["f64"])),
        "pow2i_f32": lambda: H.pow2i(T(inp["shift"]), T(inp["re1"]).dtype),
        "pow2i_f64": lambda: H.pow2i(T(inp["shift"]),
                                     T(inp["re1_64"]).dtype),
        **_hdr_ops(H, T, inp),
        **_hdr_ops(H, T, inp, "_64", "_f64"),
        "two_sum": lambda: D.two_sum(xa.hi, xb.hi),
        "quick_two_sum": lambda: D.quick_two_sum(xa.hi, xa.lo),
        "split": lambda: D.split(xa.hi),
        "two_prod": lambda: D.two_prod(xa.hi, xb.hi),
        "df_add": lambda: D.df_add(xa, xb),
        "df_sub": lambda: D.df_sub(xa, xb),
        "df_mul": lambda: D.df_mul(xa, xb),
        "df_sqr": lambda: D.df_sqr(xa),
        "df_mul_pow2": lambda: D.df_mul_pow2(xa, 2.0),
    }


OPS = list(_ops(th, tdf, torch.as_tensor,
                {k: np.asarray(v) for k, v in _inputs().items()}))


def _flatten(name, out):
    parts = out if isinstance(out, tuple) else (out,)
    return {f"{name}:{i}": np.asarray(p) for i, p in enumerate(parts)}


def _jax_reference(inputs):
    import jax
    import jax.numpy as jnp

    from fractalshark_tpu.ops import dblflt as D
    from fractalshark_tpu.ops import hdrfloat as H

    # inputs go in as jit ARGUMENTS: arrays closed over would become
    # constants, which XLA folds at compile time without the runtime's
    # subnormal flush
    args = {k: jnp.asarray(v) for k, v in inputs.items()}
    res = {}
    for name in _ops(H, D, jnp.asarray, inputs):
        fn = jax.jit(lambda a, name=name: _ops(H, D, jnp.asarray, a)[name]())
        res.update(_flatten(name, fn(args)))
    return res


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    inputs = _inputs()
    jx = ref.run_jax_reference("test_torch_hdr", "_jax_reference",
                               tmp_path_factory.mktemp("hdr"), inputs)
    port = {}
    for name, fn in _ops(th, tdf, torch.as_tensor, inputs).items():
        port.update(_flatten(name, fn()))
    return jx, port


@pytest.mark.parametrize("name", OPS)
def test_op_matches_jax_bitwise(both, name):
    jx, port = both
    keys = [k for k in jx if k.split(":")[0] == name]
    assert keys
    for k in keys:
        assert ref.bits_equal(port[k], jx[k]), k


def test_edges_are_exercised():
    """The input set really holds the edges the ops special-case."""
    inp = _inputs()
    gap = np.abs(inp["e1"].astype(np.int64) - inp["e2"])
    for g in (120, 126, 127):
        assert (gap == g).any()
    assert (inp["e1"] == MIN_E).any() and (inp["re1"] == 0).any()
    assert (inp["re1"] < 0).any()
    prod = inp["re1"].astype(np.float64) * inp["re2"]
    assert ((np.abs(prod) < np.finfo(np.float32).tiny) & (prod != 0)).any()
    prod64 = inp["re1_64"] * inp["re2_64"]
    assert ((np.abs(prod64) < np.finfo(np.float64).tiny) &
            (inp["re1_64"] != 0) & (inp["re2_64"] != 0)).any()


def test_frexp2_zero_and_pow2i_clamp():
    m, e = th._frexp2(torch.tensor([0.0, -0.0, 3.0, -0.75]))
    assert m.tolist() == [0.0, -0.0, 1.5, -1.5]
    assert e.tolist() == [0, 0, 1, -1]
    p = th.pow2i(torch.tensor([-500, -126, 0, 127, 500], dtype=torch.int32),
                 torch.float32)
    assert p.tolist() == [2.0 ** -126, 2.0 ** -126, 1.0, 2.0 ** 127,
                          2.0 ** 127]
