"""K13's and K14's plain twins (``fractalshark_tpu_torch/ops/hdr_escape.py``,
``ops/dblflt.py``) against the JAX package, bit for bit: ``escape_hdr``
with f32 and f64 mantissas and ``escape_df`` in its 2x32 and 2x64
variants on the integration sweep's shallow frame, the HDR escape past
f32's exponent range (View #6's centre, 2^453) and past f64's (View #8's,
2^2220) with their budgets cut, the view splits both take, and the int32
budget both refuse at 2^31.  The ``cuda`` tests hold the kernels to the
twins on the card.
"""

import numpy as np
import pytest
import torch

import test_torch_jaxref as ref
from fractalshark_tpu_torch import kernels
from fractalshark_tpu_torch.ops import dblflt, escape, hdr_escape

SIZE, BUDGET = 48, 256
DEEP_SIZE = 16
V6_BUDGET, V8_BUDGET = 600, 300
# View #6's and View #8's centres at 16², budgets cut, each with the
# mantissa type it is past the exponent range of
DEEP_VIEWS = {"v6": (6, V6_BUDGET, np.float32), "v8": (8, V8_BUDGET,
                                                       np.float64)}


def _shallow(pkg="fractalshark_tpu_torch", size=SIZE):
    h = ref.host_layer(pkg)
    return h.PointZoomBBConverter(
        pt_x="-0.6", pt_y="0.45",
        zoom_factor="64").square_aspect_ratio(size, size)


def _deep_view(v, pkg="fractalshark_tpu_torch"):
    h = ref.host_layer(pkg)
    return h.get_view_preset(v).ptz.square_aspect_ratio(DEEP_SIZE,
                                                        DEEP_SIZE)


def _jax_reference(_inputs):
    import jax.numpy as jnp

    from fractalshark_tpu.ops import dblflt as jdf
    from fractalshark_tpu.ops import escape as jesc
    from fractalshark_tpu.ops import hdr_escape as jh

    out = {}
    ptz = _shallow("fractalshark_tpu")
    for name, dt in (("f32", jnp.float32), ("f64", jnp.float64)):
        out["hdr_" + name] = np.asarray(jh.escape_hdr(ptz, SIZE, SIZE, BUDGET,
                                                      sub_dtype=dt))
        p = jh.view_to_hdr_params(ptz, SIZE, SIZE,
                                  dtype=np.float32 if name == "f32"
                                  else np.float64)
        for key, (m, e) in p.items():
            out[f"split_{name}_{key}"] = np.asarray([m], m.dtype)
            out[f"split_{name}_{key}_e"] = np.asarray([e], np.int32)
    for variant in ("2x32", "2x64"):
        out["df_" + variant] = np.asarray(jdf.escape_df(
            ptz, SIZE, SIZE, BUDGET, variant=variant))
        npdt = np.float32 if variant == "2x32" else np.float64
        out["hp_" + variant] = np.asarray(
            [v for hp in (ptz.min_x, ptz.max_y, ptz.delta_x(SIZE),
                          ptz.delta_y(SIZE))
             for v in jdf.df_from_hp(hp, npdt)])
        params = jesc.PlainParams.from_view(ptz, SIZE, SIZE)
        out["df_plain_" + variant] = np.asarray(jdf.escape_df(
            params, SIZE, SIZE, BUDGET, variant=variant))
    for name, (v, n, dt) in DEEP_VIEWS.items():
        out["deep_" + name] = np.asarray(jh.escape_hdr(
            _deep_view(v, "fractalshark_tpu"), DEEP_SIZE, DEEP_SIZE, n,
            sub_dtype=dt))
    for name, fn in (("hdr", lambda n: jh.escape_hdr(ptz, 4, 4, n)),
                     ("df", lambda n: jdf.escape_df(ptz, 4, 4, n))):
        try:
            fn(1 << 31)
            out["overflow_" + name] = np.asarray(False)
        except OverflowError:
            out["overflow_" + name] = np.asarray(True)
    return out


@pytest.fixture(scope="module")
def jax_ref(tmp_path_factory):
    return ref.run_jax_reference("test_torch_escape_hdr_df",
                                 "_jax_reference",
                                 tmp_path_factory.mktemp("hdr_df"))


def _eq(got: torch.Tensor, want: np.ndarray):
    assert want.dtype == np.uint32
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))


@pytest.mark.parametrize("dtype", ["f32", "f64"])
def test_hdr_escape_matches_jax(jax_ref, dtype):
    got = hdr_escape.escape_hdr(_shallow(), SIZE, SIZE, BUDGET,
                                sub_dtype=getattr(np, "float" + dtype[1:]),
                                device="cpu")
    _eq(got, jax_ref["hdr_" + dtype])
    assert 0 < int(got.min()) < BUDGET == int(got.max())


@pytest.mark.parametrize("variant", ["2x32", "2x64"])
def test_df_escape_matches_jax(jax_ref, variant):
    got = dblflt.escape_df(_shallow(), SIZE, SIZE, BUDGET, variant=variant,
                           device="cpu")
    _eq(got, jax_ref["df_" + variant])
    assert 0 < int(got.min()) < BUDGET == int(got.max())


@pytest.mark.parametrize("variant", ["2x32", "2x64"])
def test_df_escape_from_plain_params_matches_jax(jax_ref, variant):
    """``escape_df``'s other input: a PlainParams' floats, split."""
    params = escape.PlainParams.from_view(_shallow(), SIZE, SIZE)
    got = dblflt.escape_df(params, SIZE, SIZE, BUDGET, variant=variant,
                           device="cpu")
    _eq(got, jax_ref["df_plain_" + variant])


@pytest.mark.parametrize("name", list(DEEP_VIEWS))
def test_hdr_escape_past_the_mantissa_range(jax_ref, name):
    """View #6's centre (2^453, past f32's exponent) with f32 mantissas,
    View #8's (2^2220, past f64's) with f64: the coordinates exist only as
    HDR splits."""
    v, n, dt = DEEP_VIEWS[name]
    ptz = _deep_view(v)
    p = hdr_escape.view_to_hdr_params(ptz, DEEP_SIZE, DEEP_SIZE, dtype=dt)
    assert p["dx"][1] < (-200 if v == 6 else -2100)
    got = hdr_escape.escape_hdr(ptz, DEEP_SIZE, DEEP_SIZE, n, sub_dtype=dt,
                                device="cpu")
    _eq(got, jax_ref["deep_" + name])


@pytest.mark.parametrize("dtype", ["f32", "f64"])
def test_view_splits_match_jax(jax_ref, dtype):
    npdt = getattr(np, "float" + dtype[1:])
    p = hdr_escape.view_to_hdr_params(_shallow(), SIZE, SIZE, dtype=npdt)
    for key, (m, e) in p.items():
        assert m.dtype == npdt
        assert ref.bits_equal([m], jax_ref[f"split_{dtype}_{key}"])
        assert e == jax_ref[f"split_{dtype}_{key}_e"][0]


@pytest.mark.parametrize("variant", ["2x32", "2x64"])
def test_df_from_hp_matches_jax(jax_ref, variant):
    ptz = _shallow()
    npdt = np.float32 if variant == "2x32" else np.float64
    got = [v for hp in (ptz.min_x, ptz.max_y, ptz.delta_x(SIZE),
                        ptz.delta_y(SIZE)) for v in dblflt.df_from_hp(hp, npdt)]
    assert ref.bits_equal(np.asarray(got), jax_ref["hp_" + variant])
    assert dblflt.df_params(ptz, SIZE, SIZE, variant) == got


def test_budgets_of_2_31_raise_as_the_reference(jax_ref):
    """Both references hold the budget in int32 and refuse 2^31 with
    OverflowError; so does the port, on every device and in the twin."""
    assert jax_ref["overflow_hdr"] and jax_ref["overflow_df"]
    ptz = _shallow(size=4)
    for n in (1 << 31, (1 << 32) + 5):
        with pytest.raises(OverflowError):
            hdr_escape.escape_hdr(ptz, 4, 4, n, device="cpu")
        with pytest.raises(OverflowError):
            dblflt.escape_df(ptz, 4, 4, n, device="cpu")


@pytest.mark.parametrize("variant", ["4x32", "4x64"])
def test_quad_variants_raise(variant):
    with pytest.raises(NotImplementedError, match="ROADMAP A1"):
        dblflt.escape_df(_shallow(size=4), 4, 4, 8, variant=variant,
                         device="cpu")


# ---------------------------------------------------------------- the card


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (K13/K14 have no CPU form)")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["f32", "f64"])
def test_k13_matches_twin_on_card(card, dtype):
    npdt = getattr(np, "float" + dtype[1:])
    ptz = _shallow(size=256)
    kernels.reset_counts()
    got = hdr_escape.escape_hdr(ptz, 256, 256, BUDGET, sub_dtype=npdt,
                                device=card)
    assert kernels.launches["escape_hdr" + dtype[1:]] == 1
    p = hdr_escape.view_to_hdr_params(ptz, 256, 256, dtype=npdt)
    want = hdr_escape.escape_hdr_plain(p, 256, 256, BUDGET,
                                       getattr(torch, npdt.__name__), card)
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("variant", ["2x32", "2x64"])
def test_k14_matches_twin_on_card(card, variant):
    ptz = _shallow(size=256)
    kernels.reset_counts()
    got = dblflt.escape_df(ptz, 256, 256, BUDGET, variant=variant,
                           device=card)
    assert kernels.launches["escape_" + variant] == 1
    scal = dblflt.df_params(ptz, 256, 256, variant)
    want = dblflt.escape_df_plain(
        scal, 256, 256, BUDGET,
        torch.float32 if variant == "2x32" else torch.float64, card)
    assert torch.equal(got, want)
