"""K7's launch form (``fractalshark_tpu_torch/ops/la_stream.py``): one
launch carries each pixel through the AT skip and every LA stage, and
launches after the first run the pixels still in a stage.  Its plain twin
(``stream_plain``), run in chunks of 0 (no bound), 1, 7 and 1,000 steps
a pixel with live-pixel launches between them (``run_stages``), hands off
bit for bit what the reference's schedule does: the stage-lockstep twin
(``lockstep_plain``) and the JAX package's ``la_phase_stream`` (Pallas,
interpret mode, FMA contraction off), on the 1e8 frame and View #6 at
32² and 64².  Then the wrapper's refusals, and the ``cuda`` test that
holds K7 to its twin in every state array.
"""

import functools
import types

import numpy as np
import pytest
import torch

import test_torch_jaxref as ref
from fractalshark_tpu_torch.ops import la_kernel, perturb
from fractalshark_tpu_torch.ops import la_stream as LS
from fractalshark_tpu_torch.ops.hdrfloat import HDRComplex

# the 1e8 frame of chip_smoke.py (its budget) and View #6 (its own)
CENTER_1E8 = ("-0.743643887037158704752191506114774",
              "0.131825904205311970493132056385139", "1e8", 2000)
FRAMES = {"1e8_32": ("1e8", 32), "1e8_64": ("1e8", 64),
          "view6_32": (6, 32), "view6_64": (6, 64)}
CHUNKS = (0, 1, 7, 1000)
# the handoff's arrays and the JAX dict's keys for them
KEYS = {"dzr": "dzr", "dzi": "dzi", "dze": "dze", "ref_iter": "jwait",
        "done": "done"}


def _frame(name, pkg="fractalshark_tpu_torch"):
    """(ptz, orbit results, LA table, budget) of a frame, built by the
    host layer of ``pkg``."""
    view, size = FRAMES[name]
    h = ref.host_layer(pkg)
    if view == "1e8":
        x, y, zoom, n = CENTER_1E8
        ptz = h.PointZoomBBConverter(pt_x=x, pt_y=y, zoom_factor=zoom,
                                     prec=512).square_aspect_ratio(size, size)
    else:
        v = h.get_view_preset(view)
        ptz, n = v.ptz.square_aspect_ratio(size, size), v.num_iterations
    res = h.RefOrbitCalc().get_and_create_useful_results(ptz, n)
    la = h.get_or_build_la(types.SimpleNamespace(la_parameters=None), res)
    return ptz, res, la, n


def _jax_reference(_inputs):
    from fractalshark_tpu.ops.la_stream import la_phase_stream

    out = {}
    for name, (_, size) in FRAMES.items():
        ptz, res, la, n = _frame(name, "fractalshark_tpu")
        got = la_phase_stream(res, la, ptz, size, size, n, tile_h=size,
                              interpret=True)
        for k in ("it", *KEYS.values()):
            out[f"{name}_{k}"] = np.asarray(got[k])
    return out


@pytest.fixture(scope="module")
def jax_ref(tmp_path_factory):
    return ref.run_jax_reference("test_torch_la_stream_launch",
                                 "_jax_reference",
                                 tmp_path_factory.mktemp("la_stream_launch"))


@functools.lru_cache(maxsize=None)
def _cpu_frame(name):
    """A frame's LA tables and flat dc on the CPU, and its lockstep
    handoff."""
    ptz, res, la, n = _frame(name)
    size = FRAMES[name][1]
    T = la_kernel.la_tables_on(la, torch.device("cpu"))
    dc = perturb._dc_grids_hdr(*perturb.delta_params(
        ptz, res.center_x, res.center_y, size, size), size, size, "cpu")
    flat = HDRComplex(*(t.reshape(-1).contiguous() for t in dc))
    return types.SimpleNamespace(name=name, ptz=ptz, res=res, la=la, T=T,
                                 dc=flat, n=n,
                                 lockstep=LS.lockstep_plain(T, flat, n))


@pytest.fixture(scope="module", params=list(FRAMES))
def frame(request):
    return _cpu_frame(request.param)


@pytest.mark.parametrize("chunk", CHUNKS)
def test_launches_equal_lockstep_and_jax(jax_ref, frame, chunk):
    """The one-launch twin in chunks over the live pixels: the handoff
    equals the stage-lockstep twin's and the JAX package's bit for bit;
    every pixel ends out of the stages; a run whose pixels finish within
    the bound is one launch, and one of a step takes more, the later ones
    over fewer pixels."""
    state = LS.run_stages(frame.T, frame.dc, frame.n, chunk, plain=True)
    launches = LS.last_run_stats["dispatches"]
    got = dict(zip(LS.STATE, state))
    assert bool((got["s"] < 0).all())
    for name, want in zip(LS.HANDOFF, frame.lockstep):
        assert torch.equal(got[name], want), name
    for name, key in KEYS.items():
        want = jax_ref[f"{frame.name}_{key}"].reshape(-1)
        np.testing.assert_array_equal(
            got[name].numpy().astype(want.dtype), want, err_msg=name)
    it = jax_ref[f"{frame.name}_it"].reshape(-1)
    np.testing.assert_array_equal((frame.n - got["rem"]).numpy(), it)
    if chunk == 1:
        assert launches > 1
        assert min(LS.last_run_stats["work"]) < frame.dc.re.numel()
    if chunk == 0:
        assert launches == 1


def test_kernel_wrapper_refuses_bad_inputs():
    """K7's wrapper checks its operands before any launch: a work list on
    the first launch, a state array of the wrong type or size, a work
    list that is not int32, f64 mantissas."""
    f = _cpu_frame("1e8_32")
    T, dc, n = f.T, f.dc, f.n
    P = dc.re.numel()
    with pytest.raises(ValueError, match="first launch"):
        LS.stream_kernel(T, dc, None, n, 0,
                         work=torch.zeros(1, dtype=torch.int32))
    state = LS.init_plain(T, dc, n)
    bad = list(state)
    bad[6] = bad[6].to(torch.int64)
    with pytest.raises(ValueError, match="K7 state s"):
        LS.stream_kernel(T, dc, tuple(bad), n, 0)
    bad = list(state)
    bad[3] = bad[3][:P - 1]
    with pytest.raises(ValueError, match="K7 state rem"):
        LS.stream_kernel(T, dc, tuple(bad), n, 0)
    with pytest.raises(ValueError, match="K7 work"):
        LS.stream_kernel(T, dc, state, n, 0,
                         work=torch.zeros(1, dtype=torch.int64))
    d64 = HDRComplex(dc.re.double(), dc.im.double(), dc.e)
    with pytest.raises(ValueError, match="f32"):
        LS.stream_kernel(T, d64, None, n, 0)


@pytest.mark.cuda
def test_kernel_matches_twin_on_card(frame):
    """K7 in chunks over the live pixels against its twin on the same
    subsets: every state array equal, bit for bit, and the same
    launches."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda")
    T = la_kernel.la_tables_on(frame.la, dev)
    dc = HDRComplex(*(t.to(dev) for t in frame.dc))
    for chunk in CHUNKS:
        plain = LS.run_stages(frame.T, frame.dc, frame.n, chunk, plain=True)
        runs = LS.last_run_stats["dispatches"]
        got = LS.run_stages(T, dc, frame.n, chunk)
        assert LS.last_run_stats["dispatches"] == runs
        for name, a, b in zip(LS.STATE, got, plain):
            assert torch.equal(a.cpu(), b), (chunk, name)
