"""Differential-test harness of the PyTorch/CUDA port, and the facts
about the JAX reference's floating point that it rests on.

XLA:CPU, which runs the JAX package in these tests, contracts
``a*b + c`` into fused multiply-adds wherever its backend finds the
pattern, and runs with subnormals flushed to zero, f32 and f64 alike.
The port's kernels do no contraction (``nvcc -fmad=false``) and flush
subnormals (``-ftz=true`` for f32, in code for f64), and so do their
plain PyTorch twins.  The reference the
port is held to bit for bit is therefore the JAX package with FMA
instructions disabled (``--xla_cpu_max_isa=AVX``): the same program,
each ``*`` and ``+`` rounded on its own.  That flag has to be set
before XLA starts, so the reference runs in a subprocess; each test
module computes all of its JAX references in one such call.
"""

from __future__ import annotations

import os
import subprocess
import sys

import numpy as np
import torch

# the plain twins run thousands of small tensor steps: one intra-op
# thread is faster than many and leaves the other test workers alone
torch.set_num_threads(1)

TESTS_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(TESTS_DIR)
NOFMA_XLA_FLAGS = "--xla_cpu_max_isa=AVX"

_BOOT = """
import os, sys
os.environ["JAX_PLATFORMS"] = "cpu"
import jax
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)
sys.path.insert(0, {tests!r})
import numpy as np
import {module} as m
inputs = dict(np.load({inp!r}, allow_pickle=False))
np.savez({out!r}, **m.{func}(inputs))
"""


def run_jax_reference(module: str, func: str, workdir, inputs=None,
                      timeout: int = 900, devices: int | None = None) -> dict:
    """Run ``module.func(inputs) -> dict of arrays`` in a subprocess
    with JAX on the CPU, x64 on and FMA contraction off; return its
    result as numpy arrays.  ``devices``: that many virtual CPU devices
    (for the JAX package's mesh-sharded functions), else one."""
    inp = os.path.join(str(workdir), f"{module}.{func}.in.npz")
    out = os.path.join(str(workdir), f"{module}.{func}.out.npz")
    np.savez(inp, **(inputs or {}))
    env = dict(os.environ)
    env.pop("FRACTALSHARK_NO_X64", None)
    # x64 on, as the JAX package's own tests run it; no compile cache
    # written under the home directory
    flags = NOFMA_XLA_FLAGS
    if devices:
        flags += f" --xla_force_host_platform_device_count={devices}"
    env.update(JAX_PLATFORMS="cpu", XLA_FLAGS=flags,
               FRACTALSHARK_NO_COMPILE_CACHE="1",
               PYTHONPATH=os.pathsep.join(
                   p for p in (ROOT, env.get("PYTHONPATH")) if p))
    proc = subprocess.run(
        [sys.executable, "-c", _BOOT.format(tests=TESTS_DIR, module=module,
                                            func=func, inp=inp, out=out)],
        env=env, cwd=ROOT, capture_output=True, text=True, timeout=timeout)
    assert proc.returncode == 0, proc.stderr[-4000:]
    with np.load(out) as z:
        return {k: z[k] for k in z.files}


class Background:
    """``fn(*args)`` (a JAX reference) run in a background thread from
    now on; its result is waited for at the first item access, so the
    port's side of a test module computes while the reference runs."""

    def __init__(self, fn, *args):
        from concurrent.futures import ThreadPoolExecutor
        pool = ThreadPoolExecutor(1)
        self._future = pool.submit(fn, *args)
        pool.shutdown(wait=False)

    def result(self) -> dict:
        return self._future.result()

    def __getitem__(self, key):
        return self.result()[key]


_RANK_BOOT = """
import os, sys
sys.path.insert(0, {tests!r})
import numpy as np
import torch
import torch.distributed as dist
torch.set_num_threads(1)
rank = int(sys.argv[1])
dist.init_process_group("gloo", init_method="file://" + {store!r},
                        world_size={world}, rank=rank)
import {module} as m
out = m.{func}(rank, {world})
np.savez(os.path.join({outdir!r}, "rank%d.npz" % rank), **out)
dist.destroy_process_group()
"""


def run_ranks(module: str, func: str, world: int, workdir,
              timeout: int = 600) -> list[dict]:
    """Run ``module.func(rank, world) -> dict of arrays`` in ``world``
    subprocesses joined in one gloo process group (a ``file://`` store in
    ``workdir``, so that no port is raced for); return each rank's result,
    in rank order.  The test process itself starts no process group.  A
    rank that fails ends the others at once (they would wait in a
    collective)."""
    import time
    workdir = str(workdir)
    store = os.path.join(workdir, f"{module}.{func}.store")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (ROOT, os.environ.get("PYTHONPATH")) if p))
    code = _RANK_BOOT.format(tests=TESTS_DIR, store=store, world=world,
                             module=module, func=func, outdir=workdir)
    logs = [os.path.join(workdir, f"rank{r}.log") for r in range(world)]
    procs = []
    for r in range(world):
        with open(logs[r], "w") as log_file:
            procs.append(subprocess.Popen(
                [sys.executable, "-c", code, str(r)], env=env, cwd=ROOT,
                stdout=log_file, stderr=subprocess.STDOUT))
    deadline = time.monotonic() + timeout
    try:
        while any(p.poll() is None for p in procs):
            if any(p.poll() not in (None, 0) for p in procs) or \
                    time.monotonic() > deadline:
                break
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    for r, (p, log) in enumerate(zip(procs, logs)):
        if p.returncode != 0:
            with open(log) as fh:
                text = fh.read()
            raise AssertionError(f"rank {r} (rc {p.returncode}): "
                                 f"{text[-4000:]}")
    res = []
    for r in range(world):
        with np.load(os.path.join(workdir, f"rank{r}.npz")) as z:
            res.append({k: z[k] for k in z.files})
    return res


def run_ranks_and_jax(module: str, world: int, workdir, devices: int,
                      rank_func: str = "_rank_cases",
                      jax_func: str = "_jax_reference"):
    """(``run_ranks`` of ``rank_func``, ``run_jax_reference`` of
    ``jax_func`` on ``devices`` virtual devices), the two run side by
    side."""
    from concurrent.futures import ThreadPoolExecutor
    with ThreadPoolExecutor(1) as ex:
        jax_out = ex.submit(run_jax_reference, module, jax_func, workdir,
                            None, 900, devices)
        ranks = run_ranks(module, rank_func, world, workdir)
        return ranks, jax_out.result()


def host_layer(pkg: str):
    """The host-layer names the port's tests build views, orbits and LA
    tables with, from ``pkg``: the port (``fractalshark_tpu_torch``, its
    own copies) or, inside a JAX reference, ``fractalshark_tpu``."""
    import importlib
    import types

    def mod(name):
        return importlib.import_module(f"{pkg}.{name}")

    la = mod("engine.la_reference")
    return types.SimpleNamespace(
        HD=mod("core.hdr_host").HD,
        PointZoomBBConverter=mod("core.pointzoom").PointZoomBBConverter,
        get_view_preset=mod("core.views").get_view_preset,
        LAReferenceHost=la.LAReferenceHost,
        get_or_build_la=la.get_or_build_la,
        RefOrbitCalc=mod("engine.reforbit").RefOrbitCalc)


def bits_equal(a, b) -> bool:
    """Bitwise equality (NaNs and signed zeros included)."""
    a = np.ascontiguousarray(np.asarray(a))
    b = np.ascontiguousarray(np.asarray(b))
    if a.shape != b.shape or a.dtype.itemsize != b.dtype.itemsize:
        return False
    if a.dtype.kind == "f":
        a = a.view(f"u{a.dtype.itemsize}")
        b = b.view(f"u{b.dtype.itemsize}")
    return bool((a == b).all())


# ----------------------------------------------------------------------------
# The reference's floating-point mode


def _fp_mode(inputs):
    import jax
    import jax.numpy as jnp

    a, b, c, d = (jnp.asarray(inputs[k]) for k in "abcd")
    tiny = jnp.asarray(inputs["tiny"])
    tiny64 = jnp.asarray(inputs["tiny64"])
    return {
        "fma_pattern": np.asarray(jax.jit(lambda a, b, c: a * b + c)(a, b, c)),
        "cmul_pattern": np.asarray(
            jax.jit(lambda a, b, c, d: a * b - c * d)(a, b, c, d)),
        "underflow": np.asarray(jax.jit(lambda t: t * t)(tiny)),
        "underflow64": np.asarray(jax.jit(lambda t: t * t)(tiny64)),
    }


def test_reference_has_ieee_products_and_flushes_subnormals(tmp_path):
    """The no-FMA reference rounds every * and + on its own (equal to
    numpy), and flushes subnormal results exactly as the port's ftz."""
    from fractalshark_tpu_torch.ops.hdrfloat import ftz

    rng = np.random.default_rng(7)
    inputs = {k: rng.standard_normal(4096).astype(np.float32)
              for k in "abcd"}
    inputs["tiny"] = np.float32(1e-20) * rng.standard_normal(64).astype(
        np.float32)
    # f64 products below 2^-1022 flush too: the f64 kernels flush in code
    inputs["tiny64"] = 1e-160 * rng.standard_normal(64)
    ref = run_jax_reference("test_torch_jaxref", "_fp_mode", tmp_path, inputs)
    a, b, c, d = (inputs[k] for k in "abcd")
    assert bits_equal(ref["fma_pattern"], a * b + c)
    assert bits_equal(ref["cmul_pattern"], a * b - c * d)
    for key in ("tiny", "tiny64"):
        t = torch.from_numpy(inputs[key])
        under = ref[key.replace("tiny", "underflow")]
        assert (under == 0).all()
        assert bits_equal(under, ftz(t * t).numpy())
        assert not (inputs[key] * inputs[key] == 0).all()
