"""``fractalshark_tpu_torch.graft_entry``, the port's graft entry points, on
the CPU (the plain twins) against ``__graft_entry__.py``, the JAX package's,
run in a subprocess with FMA contraction off: ``dryrun_multichip`` on 2
ranks (gloo processes) against the JAX dry run on 2 virtual devices, the
same frame shape and iter_sum with every check passing; 4 ranks on the
port alone, against the one-process frame; ``entry()``'s grid against the
JAX ``entry()``'s.
"""

import contextlib
import io
import re

import numpy as np
import pytest
import torch

import test_torch_jaxref as ref
from fractalshark_tpu_torch import graft_entry as G


def _jax_reference(inputs):
    import __graft_entry__ as g

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        g.dryrun_multichip(2)
    line = buf.getvalue().strip().splitlines()[-1]
    m = re.search(r"perturbation render \((\d+), (\d+)\) .*iter_sum=(\d+)",
                  line)
    fn, args = g.entry()
    return {"shape": np.asarray([int(m.group(1)), int(m.group(2))]),
            "iter_sum": np.asarray(int(m.group(3))),
            "ok": np.asarray(line.startswith("dryrun_multichip OK") and
                             line.count("bit-identical") == 3),
            "entry": np.asarray(fn(*args))}


def _dryrun(n):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rec = G.dryrun_multichip(n, "cpu")
    return rec, buf.getvalue()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The JAX dry run and entry (a subprocess on 2 virtual devices)
    beside the port's dry runs on 2 and 4 ranks."""
    jax = ref.Background(ref.run_jax_reference, "test_torch_graft_entry",
                         "_jax_reference", tmp_path_factory.mktemp(
                             "graft_entry"), None, 900, 2)
    out = {n: _dryrun(n) for n in (2, 4)}
    out["jax"] = jax.result()
    return out


def _assert_passed(rec, line, n):
    assert rec["devices"] == n and rec["device"] == "cpu"
    assert rec["checks"] == {"stream": True, "ntt": True, "orbit": True}
    assert (rec["nfft"], rec["digits"]) == (4096, 512)
    assert line.startswith(f"dryrun_multichip OK: {n} devices")
    assert f"iter_sum={rec['iter_sum']}" in line


def test_dryrun_two_ranks_equals_jax(runs):
    """Two ranks: the JAX dry run's frame shape and iter_sum, and every
    check (stream = render, sharded product and orbit steps = one
    device's) passing on both sides."""
    rec, line = runs[2]
    _assert_passed(rec, line, 2)
    jax = runs["jax"]
    assert bool(jax["ok"])
    assert rec["shape"] == jax["shape"].tolist() == [16, 64]
    assert rec["iter_sum"] == int(jax["iter_sum"])


def test_dryrun_four_ranks(runs):
    """Four ranks: every check passes, and the sharded frame's statistics
    are the one-process frame's."""
    from fractalshark_tpu_torch.engine.reforbit import RefOrbitCalc
    from fractalshark_tpu_torch.ops import perturb

    rec, line = runs[4]
    _assert_passed(rec, line, 4)
    h, w = rec["shape"]
    assert (h, w) == (32, 64)
    ptz = G._frame(4)
    res = RefOrbitCalc().get_and_create_useful_results(ptz, G.BUDGET)
    single = perturb.perturb_render_hdr(res, ptz, w, h, G.BUDGET,
                                        device="cpu")
    assert (rec["iter_sum"], rec["iter_min"], rec["iter_max"]) == (
        int(single.sum()), int(single.min()), int(single.max()))


def test_entry_equals_jax(runs):
    """entry(): View 0 256² x 512 in f32 = the JAX entry()'s grid."""
    fn, (scalars,) = G.entry("cpu")
    assert scalars.dtype == torch.float32 and scalars.shape == (5,)
    got = fn(scalars)
    assert got.dtype == torch.int32 and got.shape == (256, 256)
    np.testing.assert_array_equal(got.numpy(), runs["jax"]["entry"])


def test_cuda_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        G.entry("cuda")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        G.dryrun_multichip(2, "cuda")


def test_failed_rank_fails_the_dry_run():
    """Three ranks cannot split the 4,096-point transform: the ranks fail
    and the dry run raises with a rank's log."""
    with pytest.raises(RuntimeError, match=r"(?s)rank \d .*must divide"):
        _dryrun(3)
