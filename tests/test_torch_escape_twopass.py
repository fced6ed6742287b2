"""K1's two-pass schedule (``ops/escape.py`` ``escape_two_pass_plain``:
pass 1 capped, the list of unfinished pixels in any order, pass 2 from
each listed pixel's coordinate) against ``escape_plain`` and the JAX
package, bit for bit: the f32 tile against ``escape_pallas`` (interpret
mode), escape_jax's f64 loop, the f32 budget 2^24 + 1 (run as 2^24, C1)
and an f32 frame at 2^31 (escape_jax's loop), at caps 0, 1, 64 and the
budget, with the list in pass 1's order and shuffled.  Then the pass-2
list's scratch and, on the card, K1 at every cap against the twin."""

import numpy as np
import pytest
import torch

import test_torch_jaxref as ref
from fractalshark_tpu_torch import kernels
from fractalshark_tpu_torch.core.views import get_view_preset
from fractalshark_tpu_torch.ops import escape

C1_FRAME = escape.PlainParams(min_x=-0.11, max_y=0.01, dx=0.0025, dy=0.0025)
FAR_FRAME = escape.PlainParams(min_x=2.0, max_y=2.5, dx=0.125, dy=0.125)


def _view0(width, height):
    ptz = get_view_preset(0).ptz.square_aspect_ratio(width, height)
    return escape.PlainParams.from_view(ptz, width, height)


# name: (frame, width, height, budget, dtype)
CASES = {
    "tile_f32": (_view0(64, 48), 64, 48, 200, "f32"),
    "loop_f64": (_view0(64, 48), 64, 48, 200, "f64"),
    "c1_f32_2_24_plus_1": (C1_FRAME, 8, 8, (1 << 24) + 1, "f32"),
    "loop_f32_2_31": (FAR_FRAME, 8, 8, 1 << 31, "f32"),
}
CAPS = ("0", "1", "64", "budget")


def _jax_reference(_inputs):
    import jax.numpy as jnp

    from fractalshark_tpu.ops import escape as jesc

    out = {}
    for name, (p, w, h, n, dt) in CASES.items():
        jp = jesc.PlainParams(p.min_x, p.max_y, p.dx, p.dy)
        if escape.tile_semantics(n, torch.float32 if dt == "f32"
                                 else torch.float64):
            g = jesc.escape_pallas(jp, w, h, n, dtype=jnp.float32,
                                   tile_h=8, tile_w=128, interpret=True)
        else:
            g = jesc.escape_jax(jp, w, h, n, dtype=jnp.float32
                                if dt == "f32" else jnp.float64)
        out[name] = np.asarray(g)
    return out


@pytest.fixture(scope="module")
def jax_ref(tmp_path_factory):
    return ref.run_jax_reference("test_torch_escape_twopass",
                                 "_jax_reference",
                                 tmp_path_factory.mktemp("twopass"))


def _cap(cap, n):
    return n if cap == "budget" else int(cap)


@pytest.mark.parametrize("shuffle", (False, True), ids=("ordered",
                                                        "shuffled"))
@pytest.mark.parametrize("cap", CAPS)
@pytest.mark.parametrize("case", list(CASES))
def test_two_pass_twin_equals_plain_and_jax(jax_ref, case, cap, shuffle):
    p, w, h, n, dt = CASES[case]
    tdt = torch.float32 if dt == "f32" else torch.float64
    got = escape.escape_two_pass_plain(
        p, w, h, n, tdt, cap=_cap(cap, n),
        shuffle=np.random.default_rng(11) if shuffle else None)
    assert got.dtype == torch.int64 and got.shape == (h, w)
    assert torch.equal(got, escape.escape_plain(p, w, h, n, tdt))
    np.testing.assert_array_equal(got.numpy(),
                                  jax_ref[case].astype(np.int64))


def test_two_pass_lists_the_long_pixels():
    """At cap 64 the View 0 tile frame leaves pixels for pass 2 (those
    past 64 iterations) and resolves the rest in pass 1; the default cap
    is the kernel's."""
    p, w, h, n, _ = CASES["tile_f32"]
    want = escape.escape_plain(p, w, h, n, torch.float32)
    inside = escape.interior_mask(p, w, h, torch.float32)
    assert int(((want > 64) & ~inside).sum()) > 0
    assert int(((want <= 64) & ~inside).sum()) > 0
    assert escape.pass1_cap(True) == escape.PASS1_CAP
    assert torch.equal(escape.escape_two_pass_plain(p, w, h, n,
                                                    torch.float32), want)


def test_pass1_caps_fit_the_c_entry():
    """The caps go to the C entry as int32; the loop's applies to f64 and
    to f32 from a budget of 2^31."""
    for tile in (True, False):
        assert 0 < escape.pass1_cap(tile) < (1 << 31)
    assert escape.pass1_cap(False) == escape.LOOP_PASS1_CAP
    assert not escape.tile_semantics(1 << 31, torch.float32)


def test_pass_list_grows_and_alternates_its_counters():
    lst = kernels.PassList("cpu")
    items, counters, parity = lst.take(100)
    assert items.numel() >= 100 and counters.tolist() == [0, 0]
    items2, _, parity2 = lst.take(50)
    assert parity2 != parity and items2.data_ptr() == items.data_ptr()
    items3, _, parity3 = lst.take(1000)
    assert items3.numel() >= 1000 and parity3 == parity
    counters[0] = 7
    lst.reset()
    assert counters.tolist() == [0, 0]


@pytest.mark.cuda
def test_k1_two_passes_match_the_twin_on_card(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    p = _view0(512, 512)
    for cap in (0, 1, 64, 256, 1000):
        monkeypatch.setattr(escape, "PASS1_CAP", cap)
        monkeypatch.setattr(escape, "LOOP_PASS1_CAP", cap)
        for dt in (torch.float32, torch.float64):
            want = escape.escape_two_pass_plain(p, 512, 512, 256, dt,
                                                device="cuda", cap=cap)
            for _ in range(2):   # the list's counters alternate
                got = escape.escape(p, 512, 512, 256, dtype=dt,
                                    device="cuda")
                assert torch.equal(got, want), (cap, dt)
    for name in ("c1_f32_2_24_plus_1", "loop_f32_2_31"):
        q, w, h, n, dt = CASES[name]
        assert torch.equal(escape.escape(q, w, h, n, dt, "cuda").cpu(),
                           escape.escape_plain(q, w, h, n, torch.float32))
