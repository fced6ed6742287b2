"""The high-precision reference orbit computed on the device: the port of
``fractalshark_tpu/ops/bignum/orbit.py`` in its split-bookkeeping form
(``orbit.py:150-246``, the route the JAX package takes on the TPU).

* device: ``orbit_chunk`` runs ``steps`` iterations of z ← z² + c on
  the digit state in one launch of K12 (``csrc/orbit_chunk.cu``: K4's
  and K5's function for every step of the chunk) and emits, per step,
  the [12] int32 shadow row of the PRE-update z
  (``fixedpoint.shadow_row_np``) and, with ``reuse_digits`` R > 0, its
  reuse row: the top R digits of x and of y and both signs, [2R + 2]
  int32 (``orbit.py:220-222``), from which the session builds the
  intermediate-precision reuse copy (``engine/reuse.py``);
* host: ``host_bookkeeping`` turns a chunk's rows into f64 shadows, runs
  the periodicity (dzdc) and escape checks with exact IEEE f64
  (``PeriodicityChecker.h:46-95``), and ``CudaOrbitSession`` stops the
  session at period, escape or budget.

The device and the host meet once per chunk.  On CPU tensors the same
session runs the kernels' plain twins (``orbit_chunk_plain``).  Under
the reference's flag-off routes (``fixedpoint.step_route``) a chunk's
steps are K9 then K10, or K11, in one C call per chunk; the rows, and
so the period, escape and checkpoint behaviour, are the same.

The feature finder's device evaluator (``evaluate_critical_orbit_and_derivs_device``,
``orbit.py:480-535``) runs z and dz/dc together in the NR chunk
(``orbit_nr_chunk``: K12's NR instance, the signs kept on the device;
``nr_chunk_plain`` on the CPU), and reads the state back once at the
end.

K12 has two forms, chosen by the transform size (``chunk_form``):
the block form, one CTA with the state in shared memory, up to
``BLOCK_MAX_NFFT``; the grid form, one cooperative launch with K4's
passes and K5's wide tail spread over the card between grid-wide
barriers, above it, up to 32,768 limbs (D = 2^16 digits, nfft = 2^17),
the orbit and NR alike.  Sizes K12 does not take (the orbit past D = 2^16
or nfft = 2^17, 65,536 limbs and up) keep the per-step loop
of K4 then K5 (``fs_orbit_chunk``, one C call per chunk), which is also
the yardstick of ``chip_smoke.py`` and ``tools/time_orbit32.py``.
"""

from __future__ import annotations

import math
import os
import threading
import time
from collections import deque
from dataclasses import dataclass

import numpy as np
import torch

from fractalshark_tpu_torch import kernels
from fractalshark_tpu_torch.core.hdr_host import HD
from fractalshark_tpu_torch.core.highprecision import HighPrecision
from fractalshark_tpu_torch.engine.perturbation_results import (
    PerturbationResults)
from fractalshark_tpu_torch.ops.bignum import fixedpoint as FP

# chunks dispatched ahead of the one being read back (orbit.py:742)
PIPELINE_DEPTH = 3


class OrbitState:
    """The device digit state of a session: x and y digits (int32 [D])
    and the shadow row of z (int32 [12], signs at 10 and 11)."""

    def __init__(self, sx: int, x: np.ndarray, sy: int, y: np.ndarray,
                 device):
        self.x = torch.from_numpy(np.asarray(x).astype(np.int32)).to(device)
        self.y = torch.from_numpy(np.asarray(y).astype(np.int32)).to(device)
        self.row = torch.from_numpy(FP.shadow_row_np(sx, x, sy, y)).to(device)

    def numpy(self) -> tuple:
        """(sx, x, sy, y) on the host, the JAX session's state tuple."""
        row = self.row.cpu().numpy()
        return (np.int32(row[10]), self.x.cpu().numpy().astype(np.uint32),
                np.int32(row[11]), self.y.cpu().numpy().astype(np.uint32))


class _Scratch:
    """Per-session device buffers of a chunk: the per-step loop's (K4's
    coefficients and work, which K5's scratch reuses) and K12's grid
    form's (work, coefficients and the wide tail's scratch, the same
    sizes plus 4n or 7n words), made at first use; for the flagged
    routes (``fixedpoint.step_route``) the addend planes and
    K9/K10/K11's digits, residue rows and work (``values`` values, K
    components)."""

    def __init__(self, spec: FP.FixedSpec, device, values: int = 2):
        self.spec, self.values, self.device = spec, values, device
        self.tables = FP.device_tables(spec.nfft, device)
        self._loop = None
        self._tail = None
        self.fused = None

    def loop(self):
        """(coef int64 [V, n], work int32 [2Vn]): K4's outputs and work,
        K5's scratch inside it."""
        if self._loop is None:
            n, v = self.spec.nfft, self.values
            self._loop = (
                torch.empty(v, n, dtype=torch.int64, device=self.device),
                torch.empty(2 * v * n, dtype=torch.int32,
                            device=self.device))
        return self._loop

    def grid(self):
        """(work, coef, scratch) of K12's grid form: the loop's buffers
        and the wide tail's own scratch, uint32 [4n] (orbit) or [7n]
        (NR), which it reads while the next step's first pass writes
        work."""
        coef, work = self.loop()
        if self._tail is None:
            words = (7 if self.values == 4 else 4) * self.spec.nfft
            self._tail = torch.empty(words, dtype=torch.int32,
                                     device=self.device)
        return work, coef, self._tail

    def fused_buffers(self, spec: FP.FixedSpec, cx, cy, nr: bool = False):
        """(cadd, rnd, dig, inv, work) of the flagged routes, made once."""
        if self.fused is None:
            n, K = spec.nfft, 4 if nr else 2
            dev = cx.device
            cadd, rnd = FP.addend_planes(cx, cy, spec, nr)
            self.fused = (cadd, rnd,
                          torch.empty(K, 2 * spec.digits, dtype=torch.int32,
                                      device=dev),
                          torch.empty(K, 2, n, dtype=torch.int32,
                                      device=dev),
                          torch.empty(4 * K * n, dtype=torch.int32,
                                      device=dev))
        return self.fused


# the C chunk loops' routes of the flagged steps
_ROUTES = {"whole": 1, "split": 2, "full": 3}


def _fused_route(spec: FP.FixedSpec, route: str) -> tuple[int, list]:
    """(route code, counters) of a flagged chunk: K9 in the form the
    reference routes nfft to, then K10 (batched under BATCHED_TAIL); or
    K11."""
    from fractalshark_tpu_torch.ops.bignum import ntt_pallas as NP
    if route == "full":
        return _ROUTES["full"], ["iterate_full"]
    form = NP.product_form(spec.nfft)
    tail = "fused_tail_batched" if NP.BATCHED_TAIL else "fused_tail_grid"
    return _ROUTES[form], [f"ntt_products_{form}", tail]


# ------------------------------------------------------------------ K12
# The block form takes a chunk up to this transform size, the grid form
# above it (both instances).  Fixed by the crossover measured on the H100
# (PERF.md §6): at 256 limbs (nfft 1,024) the grid form is the faster for
# the orbit and for NR, at 128 limbs (512) the block form.
BLOCK_MAX_NFFT = 512
# The C entry point's limits, mirrored so that a size is refused before
# any launch (csrc/orbit_chunk.cu: max_digits, kMaxSmem, kChunkMaxLog2,
# kGridMinLog2 and the checks of chunk()): the carries are exact for any
# |acc| < 2^51, and the digit sums stay below 2^50 up to D = 2^16 digits
# (32,768 limbs), for the orbit and NR alike; nfft <= 2^17 is K4-NR's cap
# and the grid form's one-block scan of the tail's block aggregates; a
# block may opt in to SMEM_PER_BLOCK bytes of shared memory.  The cuda-marked test in
# tests/test_torch_orbit_chunk.py holds these and block_smem_bytes to the
# C's own reckoning (fs_k12_block_bytes) and refusals.
K12_MAX_DIGITS = {2: 1 << 16, 4: 1 << 16}
K12_MAX_NFFT = 1 << 17
K12_GRID_MIN_NFFT = 1 << 10
SMEM_PER_BLOCK = 232_448


def block_smem_bytes(nfft: int, digits: int, values: int) -> int:
    """The block form's shared memory, ``block_bytes`` of
    ``csrc/orbit_chunk.cu``: digit sums int64 [V][n], residues [2V][n],
    the state [V][D], c [2][D], twiddles [2][n] and 16 ints."""
    return 4 * (4 * values * nfft + values * digits + 2 * digits
                + 2 * nfft + 16)


def chunk_form(spec: FP.FixedSpec, values: int = 2) -> str:
    """The default route's form of a chunk at ``spec``'s size (``values``:
    2 for the orbit, 4 for NR): K12's "block" or "grid", or "steps" (K4
    then K5 per step, one C call) for a size K12 does not take: past D =
    2^16 digits or nfft = 2^17, i.e. 65,536 limbs and up, which no view
    needs.  NR there is refused whatever the form
    (``fixedpoint.check_nr``)."""
    if spec.digits > K12_MAX_DIGITS[values] or spec.nfft > K12_MAX_NFFT:
        return "steps"
    return "block" if spec.nfft <= BLOCK_MAX_NFFT else "grid"


def check_chunk(spec: FP.FixedSpec, form: str, values: int) -> None:
    """Refuse, before any launch, what K12's C entry points refuse
    (``values``: 2 for the orbit, 4 for NR)."""
    if form == "steps":
        return
    top = K12_MAX_DIGITS[values]
    if not 16 <= spec.digits <= top or \
            spec.nfft > K12_MAX_NFFT or spec.nfft < 2 * spec.digits:
        what = "the orbit" if values == 2 else "NR"
        raise ValueError(f"{spec}: K12 takes 16 ≤ D ≤ {top} digits and "
                         f"2D ≤ nfft ≤ 2^17 for {what}")
    if form == "block" and block_smem_bytes(
            spec.nfft, spec.digits, values) > SMEM_PER_BLOCK:
        raise ValueError(f"{spec}: the block form needs more than "
                         f"{SMEM_PER_BLOCK} bytes of shared memory")
    if form == "grid" and spec.nfft < K12_GRID_MIN_NFFT:
        raise ValueError(f"{spec}: the grid form needs nfft ≥ 1,024")
    if form not in ("block", "grid"):
        raise ValueError(f"unknown chunk form {form!r}")


def _grid_ptrs(scratch: _Scratch, form: str) -> list:
    """K12's work, coefficient and tail-scratch pointers: the grid form's
    buffers, or null for the block form, which keeps all in shared
    memory."""
    if form == "grid":
        return [t.data_ptr() for t in scratch.grid()]
    return [None] * 3


def reuse_row(x: torch.Tensor, y: torch.Tensor, row: torch.Tensor,
              R: int) -> torch.Tensor:
    """A state's reuse row, int32 [2R + 2]: the top R digits of x, of y,
    then the signs sx, sy (row[10], row[11] of its shadow row)."""
    D = x.shape[0]
    return torch.cat([x[D - R:], y[D - R:], row[10:12]]).to(torch.int32)


def orbit_chunk_plain(x: torch.Tensor, y: torch.Tensor, row: torch.Tensor,
                      scx: int, cx: torch.Tensor, scy: int,
                      cy: torch.Tensor, spec: FP.FixedSpec, steps: int,
                      reuse_digits: int = 0):
    """K12's function for the orbit on the tensors' device: ``steps``
    times K4's twin then K5's twin from digits x, y (int32 [D]) and the
    state's row (int32 [12]).  Returns (x', y', rows int32 [steps + 1,
    12]) with rows[0] = ``row`` and rows[k + 1] the row after step k, and
    with ``reuse_digits`` R > 0 the reuse rows int32 [steps + 1, 2R + 2]
    of the same states (``reuse_row``) as a fourth."""
    rows = [row]
    reuse = [reuse_row(x, y, row, reuse_digits)] if reuse_digits else []
    for _ in range(steps):
        x, y, r = FP.orbit_tail_plain(FP.orbit_products_plain(
            x, y, spec.nfft), rows[-1], scx, cx, scy, cy, spec)
        rows.append(r)
        if reuse_digits:
            reuse.append(reuse_row(x, y, r, reuse_digits))
    if reuse_digits:
        return x, y, torch.stack(rows), torch.stack(reuse)
    return x, y, torch.stack(rows)


def nr_chunk_plain(signs: torch.Tensor, x, y, dx, dy, scx: int,
                   cx: torch.Tensor, scy: int, cy: torch.Tensor,
                   spec: FP.FixedSpec, steps: int):
    """K12's function for NR on the tensors' device: ``steps`` times
    K4-NR's twin then K5-NR's twin.  Returns (signs int32 [4], x, y, dx,
    dy)."""
    for _ in range(steps):
        coef = FP.nr_products_plain(x, y, dx, dy, signs, spec.nfft)
        x, y, dx, dy, signs = FP.nr_tail_plain(coef, scx, cx, scy, cy,
                                               spec)
    return signs, x, y, dx, dy


def _reuse_args(reuse: torch.Tensor | None) -> tuple:
    """(pointer, R) of a [steps + 1, 2R + 2] reuse buffer, or (null, 0)."""
    if reuse is None:
        return None, 0
    return reuse.data_ptr(), (reuse.shape[1] - 2) // 2


def launch_orbit_chunk(state: "OrbitState", rows: torch.Tensor, scx: int,
                       cx: torch.Tensor, scy: int, cy: torch.Tensor,
                       spec: FP.FixedSpec, steps: int, scratch: _Scratch,
                       form: str, reuse: torch.Tensor | None = None) -> None:
    """One C call for a chunk on CUDA tensors, in ``form``: "block" or
    "grid" (K12, one launch) or "steps" (K4 then K5 per step, each step's
    reuse row after K5).  ``reuse``: None, or int32 [steps + 1, 2R + 2]
    with row 0 the state's; the call writes rows 1..steps.
    ``orbit_chunk`` passes ``chunk_form``'s form; ``chip_smoke.py`` times
    the others at the same sizes."""
    check_chunk(spec, form, 2)
    lg = spec.nfft.bit_length() - 1
    if form == "steps":
        coef, work = scratch.loop()
        rc = kernels.lib().fs_orbit_chunk(
            state.x.data_ptr(), state.y.data_ptr(), rows.data_ptr(),
            cx.data_ptr(), cy.data_ptr(), int(scx), int(scy),
            coef.data_ptr(), work.data_ptr(), scratch.tables.data_ptr(),
            spec.digits, lg, steps, *_reuse_args(reuse),
            kernels.stream(state.x.device))
        kernels.check(rc, "orbit_chunk")
        kernels.launches["ntt_orbit"] += steps
        kernels.launches["orbit_tail"] += steps
        return
    rc = kernels.lib().fs_orbit_chunk_k12(
        state.x.data_ptr(), state.y.data_ptr(), rows.data_ptr(),
        cx.data_ptr(), cy.data_ptr(), int(scx), int(scy),
        *_grid_ptrs(scratch, form), scratch.tables.data_ptr(), spec.digits,
        lg, steps, int(form == "grid"), *_reuse_args(reuse),
        kernels.stream(state.x.device))
    kernels.check(rc, f"orbit_chunk_{form}")
    kernels.launches[f"orbit_chunk_{form}"] += 1


def orbit_chunk(state: OrbitState, scx: int, cx: torch.Tensor, scy: int,
                cy: torch.Tensor, spec: FP.FixedSpec, steps: int,
                scratch: _Scratch | None = None, reuse_digits: int = 0,
                mesh=None):
    """Advance ``state`` by ``steps`` iterations in place; return the
    rows [steps, 12] int32 of the pre-update z of each step (on the
    state's device; on CUDA the call returns before the work is done),
    and with ``reuse_digits`` R > 0 also their reuse rows [steps, 2R + 2]
    (``reuse_row``): (rows, reuse).  By default a chunk is one launch of
    K12 in ``chunk_form``'s form; under the flagged routes
    (``fixedpoint.step_route``) K9 then K10, or K11, per step.  With a
    ``mesh`` (``parallel.mesh.Mesh``) every step is the limb-sharded step
    over it (``parallel.orbit_sharded``, K8 and K20 on each rank), the
    flags aside, as the JAX package's ``orbit_chunk(mesh=)`` does."""
    if mesh is not None:
        from fractalshark_tpu_torch.parallel.orbit_sharded import \
            orbit_chunk_sharded
        return orbit_chunk_sharded(state, scx, cx, scy, cy, spec, steps,
                                   mesh, reuse_digits)
    dev = state.x.device
    R = int(reuse_digits)
    if not 0 <= R <= spec.digits:
        raise ValueError(f"reuse_digits {R} not in [0, {spec.digits}]")
    rows = torch.empty(steps + 1, FP.ROW, dtype=torch.int32, device=dev)
    rows[0] = state.row
    reuse = None
    if R:
        reuse = torch.empty(steps + 1, 2 * R + 2, dtype=torch.int32,
                            device=dev)
        reuse[0] = reuse_row(state.x, state.y, state.row, R)
    route = FP.step_route(spec)
    if dev.type == "cpu":
        if route == "k4":
            out = orbit_chunk_plain(state.x, state.y, state.row, scx, cx,
                                    scy, cy, spec, steps, R)
            rows = out[2]
            if R:
                reuse = out[3]
            state.x.copy_(out[0])
            state.y.copy_(out[1])
        else:
            planes = FP.addend_planes(cx, cy, spec)
            for k in range(steps):
                nx, ny, rows[k + 1] = FP.iterate_z_row(
                    state.x, state.y, rows[k], scx, cx, scy, cy, spec,
                    planes)
                state.x.copy_(nx)
                state.y.copy_(ny)
                if R:
                    reuse[k + 1] = reuse_row(nx, ny, rows[k + 1], R)
        state.row = rows[steps]
        return (rows[:steps], reuse[:steps]) if R else rows[:steps]
    if scratch is None:
        scratch = _Scratch(spec, dev)
    if route == "k4":
        launch_orbit_chunk(state, rows, scx, cx, scy, cy, spec, steps,
                           scratch, chunk_form(spec), reuse)
    else:
        code, counters = _fused_route(spec, route)
        cadd, rnd, dig, inv, work = scratch.fused_buffers(spec, cx, cy)
        rc = kernels.lib().fs_orbit_chunk_fused(
            state.x.data_ptr(), state.y.data_ptr(), rows.data_ptr(),
            cadd.data_ptr(), rnd.data_ptr(), int(scx), int(scy),
            dig.data_ptr(), inv.data_ptr(), work.data_ptr(),
            FP.k9_tables(spec.nfft, dev).data_ptr(), spec.digits,
            spec.nfft.bit_length() - 1, steps, code,
            kernels.tail_state(dev).data_ptr(), *_reuse_args(reuse),
            kernels.stream(dev))
        kernels.check(rc, "orbit_chunk_fused")
        for name in counters:
            kernels.launches[name] += steps
    state.row = rows[steps]
    return (rows[:steps], reuse[:steps]) if R else rows[:steps]


class NRState:
    """The device state of an NR evaluation: z and dz/dc digits (int32
    [D] each) and their signs (int32 [4]: sx, sy, sdx, sdy)."""

    def __init__(self, signs, x, y, dx, dy, device):
        def dev(a):
            return torch.from_numpy(np.asarray(a).astype(np.int32)).to(device)
        self.x, self.y, self.dx, self.dy = dev(x), dev(y), dev(dx), dev(dy)
        self.signs = dev(np.asarray(signs))

    def numpy(self) -> tuple:
        """(sx, x, sy, y, sdx, dx, sdy, dy) on the host, the JAX state
        tuple's order."""
        s = self.signs.cpu().numpy()
        out = ()
        for k, d in enumerate((self.x, self.y, self.dx, self.dy)):
            out += (np.int32(s[k]), d.cpu().numpy().astype(np.uint32))
        return out


def launch_nr_chunk(state: "NRState", scx: int, cx: torch.Tensor, scy: int,
                    cy: torch.Tensor, spec: FP.FixedSpec, steps: int,
                    scratch: _Scratch, form: str) -> None:
    """One C call for an NR chunk on CUDA tensors, in ``form``: "block" or
    "grid" (K12's NR instance, one launch) or "steps" (K4-NR then K5-NR
    per step)."""
    check_chunk(spec, form, 4)
    lg = spec.nfft.bit_length() - 1
    ptrs = (state.x.data_ptr(), state.y.data_ptr(), state.dx.data_ptr(),
            state.dy.data_ptr(), state.signs.data_ptr(), cx.data_ptr(),
            cy.data_ptr(), int(scx), int(scy))
    if form == "steps":
        coef, work = scratch.loop()
        rc = kernels.lib().fs_nr_chunk(
            *ptrs, coef.data_ptr(), work.data_ptr(),
            scratch.tables.data_ptr(), spec.digits, lg, steps,
            kernels.stream(state.x.device))
        kernels.check(rc, "nr_chunk")
        kernels.launches["ntt_nr"] += steps
        kernels.launches["nr_tail"] += steps
        return
    rc = kernels.lib().fs_nr_chunk_k12(
        *ptrs, *_grid_ptrs(scratch, form), scratch.tables.data_ptr(),
        spec.digits, lg, steps, int(form == "grid"),
        kernels.stream(state.x.device))
    kernels.check(rc, f"nr_chunk_{form}")
    kernels.launches[f"nr_chunk_{form}"] += 1


def orbit_nr_chunk(state: NRState, scx: int, cx: torch.Tensor, scy: int,
                   cy: torch.Tensor, spec: FP.FixedSpec, steps: int,
                   scratch: _Scratch | None = None) -> None:
    """Advance ``state`` by ``steps`` NR updates in place (z ← z² + c and
    dz/dc ← 2·z·dz/dc + 1, ``orbit.py:480-498``) on
    ``fixedpoint.nr_route``: by default one launch of K12's NR instance
    in ``chunk_form``'s form (the call returns before the work is done);
    under the flagged routes K9 then K10 per step, in one C call."""
    dev = state.x.device
    route = FP.nr_route(spec)
    if route == "k4":
        FP.check_nr(spec)
    if dev.type == "cpu":
        if route == "k4":
            out = nr_chunk_plain(state.signs, state.x, state.y, state.dx,
                                 state.dy, scx, cx, scy, cy, spec, steps)
            state.signs = out[0]
            for t, m in zip((state.x, state.y, state.dx, state.dy), out[1:]):
                t.copy_(m)
            return
        for _ in range(steps):
            st = FP.iterate_z_nr(state.signs[0], state.x, state.signs[1],
                                 state.y, state.signs[2], state.dx,
                                 state.signs[3], state.dy, scx, cx, scy, cy,
                                 spec)
            state.signs = torch.stack(st[0::2]).to(torch.int32)
            for t, m in zip((state.x, state.y, state.dx, state.dy), st[1::2]):
                t.copy_(m)
        return
    if scratch is None:
        scratch = _Scratch(spec, dev, values=4)
    if route == "k4":
        launch_nr_chunk(state, scx, cx, scy, cy, spec, steps, scratch,
                        chunk_form(spec, 4))
        return
    code, counters = _fused_route(spec, route)
    cadd, rnd, dig, inv, work = scratch.fused_buffers(spec, cx, cy, nr=True)
    rc = kernels.lib().fs_nr_chunk_fused(
        state.x.data_ptr(), state.y.data_ptr(), state.dx.data_ptr(),
        state.dy.data_ptr(), state.signs.data_ptr(), cadd.data_ptr(),
        rnd.data_ptr(), int(scx), int(scy), dig.data_ptr(), inv.data_ptr(),
        work.data_ptr(), FP.k9_tables(spec.nfft, dev).data_ptr(),
        spec.digits, spec.nfft.bit_length() - 1, steps, code,
        kernels.tail_state(dev).data_ptr(), kernels.stream(dev))
    kernels.check(rc, "nr_chunk_fused")
    for name in counters:
        kernels.launches[name] += steps


def nr_limbs(precision_bits: int) -> int:
    """The evaluator's limb count (``orbit.py:510-512``): a power of two
    of at least 8 covering ``precision_bits`` + 80 bits."""
    return 1 << max(3, (-(-(precision_bits + 80) // 32) - 1).bit_length())


def critical_orbit_state_device(cx: HighPrecision, cy: HighPrecision,
                                period: int, precision_bits: int,
                                chunk_steps: int = 256, device="cuda"):
    """(spec, NRState) after period−1 NR updates from z = c, dz/dc = 1 on
    ``device``, at the evaluator's limb count (``orbit.py:510-527``)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device 'cuda' requested but CUDA is not "
                           "available")
    spec = FP.FixedSpec.for_limbs(nr_limbs(precision_bits))
    scx, cxd = FP.hp_to_digits(cx, spec)
    scy, cyd = FP.hp_to_digits(cy, spec)
    one_s, one_d = FP.hp_to_digits(HighPrecision(1, prec=64), spec)
    state = NRState((scx, scy, one_s, 1), cxd, cyd, one_d,
                    np.zeros(spec.digits, np.uint32), dev)
    cxt, cyt = state.x.clone(), state.y.clone()
    scratch = _Scratch(spec, dev, values=4) if dev.type == "cuda" else None
    remaining = period - 1
    while remaining > 0:
        steps = min(chunk_steps, remaining)
        orbit_nr_chunk(state, scx, cxt, scy, cyt, spec, steps, scratch)
        remaining -= steps
    return spec, state


def evaluate_critical_orbit_and_derivs_device(cx: HighPrecision,
                                              cy: HighPrecision,
                                              period: int,
                                              precision_bits: int,
                                              chunk_steps: int = 256,
                                              device="cuda"):
    """Device counterpart of feature_finder's host evaluator: returns
    (z_x, z_y, dzdc_x, dzdc_y) as HighPrecision after period−1 updates
    from z = c, dzdc = 1 (EvaluateCriticalOrbitAndDerivs_GPU analogue,
    KernelInvoke.h:148-169).  dz/dc is held in the orbit's fixed point,
    so its magnitude wraps modulo 2^32, as in the reference."""
    spec, state = critical_orbit_state_device(cx, cy, period, precision_bits,
                                              chunk_steps, device)
    st = state.numpy()
    return tuple(HighPrecision.from_mant_exp(
        int(st[2 * k]) * FP.digits_to_int(st[2 * k + 1]), -spec.frac_bits,
        prec=precision_bits) for k in range(4))


def host_bookkeeping(rows: np.ndarray, dz, rad_m: float, rad_e: int,
                     cxf: float, cyf: float, frac_bits: int,
                     periodicity: bool = True):
    """Exact host bookkeeping of one chunk (``orbit.py:366-467``): rows
    [12, steps] i32 = (win_x[4], base_x, win_y[4], base_y, sx, sy) per
    step; dz = (dx_m, dy_m, d_e) host floats.  Returns (packed [7, steps]
    f64 = (lzx, lzy, period, escape, sh_mx, sh_my, e_sh), the advanced
    dz).  Every operation is exact-rounded IEEE f64 (ldexp/frexp), so
    results are machine-independent.

    The sequential dzdc/periodicity loop runs in plain Python floats and
    stops once a terminating flag fires: flags past the first stop are
    never consumed by the session."""
    steps = rows.shape[1]
    F = frac_bits
    sgx = rows[10].astype(np.float64)
    sgy = rows[11].astype(np.float64)
    wx = rows[0:4].astype(np.float64)
    wy = rows[5:9].astype(np.float64)
    # explicit sum order == the device scan's _row_shadow/_shadow_hdr
    mzx = (wx[0] + wx[1] * 65536.0 + wx[2] * 65536.0 ** 2
           + wx[3] * 65536.0 ** 3) * sgx
    mzy = (wy[0] + wy[1] * 65536.0 + wy[2] * 65536.0 ** 2
           + wy[3] * 65536.0 ** 3) * sgy
    ezx = 16 * rows[4].astype(np.int64) - F
    ezy = 16 * rows[9].astype(np.int64) - F
    lzx = np.ldexp(mzx, ezx)
    lzy = np.ldexp(mzy, ezy)
    e_sh = np.maximum(ezx, ezy)
    sh_mx = np.ldexp(mzx, ezx - e_sh)
    sh_my = np.ldexp(mzy, ezy - e_sh)
    tx = lzx + cxf
    ty = lzy + cyf
    escape = tx * tx + ty * ty > 256.0

    def vnorm1(m, e):
        _, fe = np.frexp(m)
        s = np.where(m > 0.0, fe.astype(np.int64) - 1, 0)
        return np.ldexp(m, -s), e + s

    axm, axe = vnorm1(np.abs(mzx), ezx)
    aym, aye = vnorm1(np.abs(mzy), ezy)
    ge = (axe > aye) | ((axe == aye) & (axm >= aym))
    n2m = np.where(ge, axm, aym)
    n2e = np.where(ge, axe, aye)
    n2z = np.maximum(np.abs(mzx), np.abs(mzy)) == 0.0

    def pnorm1(m: float, e: int):
        if m > 0.0:
            s = math.frexp(m)[1] - 1
            return math.ldexp(m, -s), e + s
        return m, e

    eidx = int(np.argmax(escape)) if escape.any() else steps
    limit = min(steps, eidx + 1)
    period = np.zeros(steps, np.float64)
    dx_m, dy_m, d_e = float(dz[0]), float(dz[1]), int(dz[2])
    rad_m = float(rad_m)
    rad_e = int(rad_e)
    for k in range(limit):
        dxm, dxe = pnorm1(abs(dx_m), d_e)
        dym, dye = pnorm1(abs(dy_m), d_e)
        if (dxe > dye) or (dxe == dye and dxm >= dym):
            dmm, dme = dxm, dxe
        else:
            dmm, dme = dym, dye
        n3m, n3e = pnorm1(rad_m * dmm, rad_e + dme + 1)
        if n2z[k]:
            pk = True
        else:
            pk = (n2e[k] < n3e) or (n2e[k] == n3e and n2m[k] < n3m)
        if pk:
            period[k] = 1.0
            if periodicity:
                break
        mzxk, mzyk = float(mzx[k]), float(mzy[k])
        exk, eyk = int(ezx[k]), int(ezy[k])
        ezz = max(exk, eyk)
        azx = math.ldexp(mzxk, exk - ezz)
        azy = math.ldexp(mzyk, eyk - ezz)
        px = azx * dx_m - azy * dy_m
        py = azx * dy_m + azy * dx_m
        pe = ezz + d_e + 1
        res_e = max(pe, 0)
        ndx = math.ldexp(px, pe - res_e) + math.ldexp(1.0, -res_e)
        ndy = math.ldexp(py, pe - res_e)
        amax = max(abs(ndx), abs(ndy))
        if amax > 0.0:
            s = math.frexp(amax)[1] - 1
            ndx = math.ldexp(ndx, -s)
            ndy = math.ldexp(ndy, -s)
        else:
            s = 0
        dx_m, dy_m, d_e = ndx, ndy, res_e + s
    packed = np.stack([
        lzx, lzy, period, escape.astype(np.float64),
        sh_mx, sh_my, e_sh.astype(np.float64)])
    return packed, (dx_m, dy_m, d_e)


@dataclass
class CudaOrbitSession:
    """The counterpart of ``TpuOrbitSession`` (``orbit.py:538-827``), the
    reference's GpuOrbitSession (``KernelInvoke.h:63``): one orbit on
    one device, chunk by chunk.  With a ``mesh`` (``parallel.mesh.Mesh``)
    every step's digits are sharded over its ranks: each rank runs the
    session on its own device (the mesh's, of ``device``'s type) and every
    rank returns the same orbit, the one-device session's exactly."""
    spec: FP.FixedSpec
    center_x: HighPrecision
    center_y: HighPrecision
    max_radius: HighPrecision
    chunk_steps: int = 256
    device: str | torch.device = "cuda"
    mesh: object | None = None

    def run(self, max_iterations: int, periodicity: bool = True,
            abort_flag: threading.Event | None = None,
            progress_cb=None,
            store_path: str | None = None,
            reuse_frac_bits: int | None = None,
            checkpoint_path: str | None = None,
            checkpoint_every_s: float = 300.0) -> PerturbationResults:
        """store_path: the orbit accumulates in memory-mapped file-backed
        GrowableArrays (<path>.x / <path>.y).

        checkpoint_path: atomic resume-exactly checkpoints: the orbit
        accumulates at ``<path>.x/.y/.e`` and the exact digit state, the
        host dzdc and the count land in ``<path>.state.npz`` every
        ``checkpoint_every_s`` seconds (pipeline drained first).  A later
        run() with the same path resumes bit-exactly; ``max_iterations``
        is the TOTAL cap across all runs.  Exclusive with store_path.

        reuse_frac_bits: also record the intermediate-precision reuse copy
        of every z (``engine/reuse.py`` ``ReuseOrbit``, attached as
        ``extra["reuse_orbit"]``): each chunk emits the top
        ceil(bits / 16) + INT_DIGITS digits of x and y and both signs
        (``orbit.py:652-654``, ``:710-717``, ``:821-826``)."""
        spec = self.spec
        dev = torch.device(self.device)
        if dev.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("device 'cuda' requested but CUDA is not "
                               "available")
        if self.mesh is not None:
            if self.mesh.device.type != dev.type:
                raise ValueError(f"the mesh is on {self.mesh.device}, the "
                                 f"session asks for {dev}")
            dev = self.mesh.device
        scx, cx_d = FP.hp_to_digits(self.center_x, spec)
        scy, cy_d = FP.hp_to_digits(self.center_y, spec)
        cxt = torch.from_numpy(cx_d.astype(np.int32)).to(dev)
        cyt = torch.from_numpy(cy_d.astype(np.int32)).to(dev)
        # z starts at c (RefOrbitCalc.cpp:509-511); dzdc = 1 + 0i
        state = OrbitState(scx, cx_d, scy, cy_d, dev)
        dz = (1.0, 0.0, 0)
        radius = HD.from_hp(self.max_radius)
        cxf = float(self.center_x)
        cyf = float(self.center_y)
        scratch = _Scratch(spec, dev) if dev.type == "cuda" and \
            self.mesh is None else None

        from fractalshark_tpu_torch.utils.growable import (AddPointOptions,
                                                           GrowableArray)
        ck_file = None
        count = 1
        if checkpoint_path is not None:
            if store_path is not None:
                raise ValueError("checkpoint_path is mutually exclusive "
                                 "with store_path")
            store_path = checkpoint_path
            ck_file = checkpoint_path + ".state.npz"
        if store_path is not None:
            opt = AddPointOptions.ENABLE_WITH_SAVE
            if ck_file is not None and os.path.exists(ck_file) and \
                    os.path.exists(store_path + ".x.meta"):
                # resume: the npz is the authoritative count (meta may be
                # one checkpoint ahead if the writer died between the
                # growable flush and the npz rename)
                with np.load(ck_file) as ck:
                    count = int(ck["count"])
                    state = OrbitState(int(ck["st0"]), ck["st1"],
                                       int(ck["st2"]), ck["st3"], dev)
                    dzv = ck["dz"]
                    dz = (float(dzv[0]), float(dzv[1]), int(dzv[2]))
                gx = GrowableArray.open_existing(store_path + ".x")
                gy = GrowableArray.open_existing(store_path + ".y")
                ge = GrowableArray.open_existing(store_path + ".e")
                gx._n = gy._n = ge._n = count
            else:
                gx = GrowableArray(np.float64, store_path + ".x", opt)
                gy = GrowableArray(np.float64, store_path + ".y", opt)
                ge = GrowableArray(np.int32, store_path + ".e", opt) \
                    if ck_file is not None else GrowableArray(np.int32)
        else:
            gx = GrowableArray(np.float64)
            gy = GrowableArray(np.float64)
            ge = GrowableArray(np.int32)
        if count == 1:
            gx.append(0.0)  # zero seed entry (PerturbationResults.cpp:866)
            gy.append(0.0)
            ge.append(0)
        reuse_digits = 0
        rzx: list = []
        rzy: list = []
        if reuse_frac_bits is not None:
            fr16 = -(-int(reuse_frac_bits) // 16)
            reuse_digits = min(fr16 + FP.INT_DIGITS, spec.digits)
            rzx.append(0)     # zero seed
            rzy.append(0)
        period = 0
        escaped_at = 0
        t0 = time.perf_counter()
        done = False
        timers = {"dispatch_s": 0.0, "readback_s": 0.0, "bookkeep_s": 0.0}

        def _process(out, steps):
            """Read one chunk's rows back and run the host bookkeeping;
            sets period/escape/done."""
            nonlocal count, period, escaped_at, done, dz
            tr = time.perf_counter()
            if reuse_digits:
                out, reuse = out
                reuse = reuse.cpu().numpy()
            rows = out.cpu().numpy().T
            timers["readback_s"] += time.perf_counter() - tr
            tr = time.perf_counter()
            arr, dz = host_bookkeeping(
                rows, dz, float(radius.m), int(radius.e), cxf, cyf,
                spec.frac_bits, periodicity=periodicity)
            lzx, lzy, sh_mx, sh_my = arr[0], arr[1], arr[4], arr[5]
            pflag = arr[2] != 0.0
            eflag = arr[3] != 0.0
            e_sh = arr[6].astype(np.int32)
            pidx = int(np.argmax(pflag)) if (periodicity and
                                             pflag.any()) else steps
            eidx = int(np.argmax(eflag)) if eflag.any() else steps
            take = min(steps, pidx + 1, eidx + 1)
            # HDR form (mantissa, exponent) where either component's
            # plain f64 shadow underflowed (PeriodicityChecker.h:32-33)
            dip = (((lzx[:take] == 0.0) & (sh_mx[:take] != 0.0)) |
                   ((lzy[:take] == 0.0) & (sh_my[:take] != 0.0)))
            gx.extend(np.where(dip, sh_mx[:take], lzx[:take]))
            gy.extend(np.where(dip, sh_my[:take], lzy[:take]))
            ge.extend(np.where(dip, e_sh[:take], 0).astype(np.int32))
            if reuse_digits:
                R = reuse_digits
                digs = reuse[:take, :2 * R].astype(np.uint16)
                for k in range(take):
                    rzx.append(int(reuse[k, 2 * R]) * int.from_bytes(
                        digs[k, :R].tobytes(), "little"))
                    rzy.append(int(reuse[k, 2 * R + 1]) * int.from_bytes(
                        digs[k, R:].tobytes(), "little"))
            count += take
            if periodicity and pidx < steps and pidx <= eidx:
                period = count
                done = True
            elif eidx < steps:
                escaped_at = count
                done = True
            timers["bookkeep_s"] += time.perf_counter() - tr

        def _checkpoint():
            """Atomic resume point: growables flushed first, then the
            exact digit state + host dzdc + count in one npz renamed into
            place (a crash between the two leaves the npz authoritative)."""
            for g in (gx, gy, ge):
                g.finalize()
            sx, x, sy, y = state.numpy()
            payload = {"st0": sx, "st1": x, "st2": sy, "st3": y,
                       "n_state": np.int64(4),
                       "dz": np.asarray([dz[0], dz[1], float(dz[2])],
                                        np.float64),
                       "count": np.int64(count)}
            tmp = ck_file + ".tmp"
            with open(tmp, "wb") as f:
                np.savez(f, **payload)
            os.replace(tmp, ck_file)

        # Pipelined chunk loop: up to PIPELINE_DEPTH chunks are queued on
        # the device before chunk k's rows are read back, so the device
        # computes while the host runs the bookkeeping
        # (RefOrbitCalc.cpp:2205-2233).  Chunks past a period or escape
        # are discarded: z iterating on past it is harmless.
        it = count - 1          # iterations dispatched (resume-aware)
        processed = count - 1   # iterations processed on host
        last_ck = time.perf_counter()
        ck_mark = processed     # never two checkpoints without work between
        pending = deque()       # (rows, steps) chunks in flight
        while True:
            if abort_flag is not None and abort_flag.is_set():
                while pending:
                    out, steps = pending.popleft()
                    _process(out, steps)
                    processed += steps
                break
            ck_due = (ck_file is not None and processed > ck_mark and
                      time.perf_counter() - last_ck >= checkpoint_every_s)
            while (not done and it < max_iterations
                   and len(pending) < PIPELINE_DEPTH and not ck_due):
                steps = min(self.chunk_steps, max_iterations - it)
                td = time.perf_counter()
                out = orbit_chunk(state, scx, cxt, scy, cyt, spec, steps,
                                  scratch, reuse_digits, self.mesh)
                timers["dispatch_s"] += time.perf_counter() - td
                it += steps
                pending.append((out, steps))
            if pending:
                out, steps = pending.popleft()
                _process(out, steps)
                processed += steps
                if progress_cb is not None:
                    progress_cb(processed, max_iterations,
                                time.perf_counter() - t0)
            if done:
                pending.clear()
            elif ck_due and not pending:
                # pipeline drained: the device state matches the
                # processed count exactly, safe to snapshot
                _checkpoint()
                last_ck = time.perf_counter()
                ck_mark = processed
            if not pending and (done or it >= max_iterations):
                break
        if ck_file is not None and not done:
            _checkpoint()   # budget-capped/aborted runs resume exactly

        xs = gx.finalize()
        ys = gy.finalize()
        es = ge.finalize()
        orbit_e = np.asarray(es, np.int32) if (np.asarray(es) != 0).any() \
            else None
        res = PerturbationResults(
            center_x=self.center_x, center_y=self.center_y,
            orbit_x=np.asarray(xs, np.float64),
            orbit_y=np.asarray(ys, np.float64),
            max_radius=self.max_radius,
            period=period, escaped_at=escaped_at,
            max_iterations=max_iterations,
            precision_bits=spec.frac_bits,
            orbit_e=orbit_e)
        timers["wall_s"] = round(time.perf_counter() - t0, 3)
        res.extra["session_timers"] = {
            k: round(v, 3) for k, v in timers.items()}
        if reuse_digits:
            from fractalshark_tpu_torch.engine.reuse import ReuseOrbit
            res.extra["reuse_orbit"] = ReuseOrbit(
                zx=rzx, zy=rzy,
                frac_bits=16 * (reuse_digits - FP.INT_DIGITS),
                center_x=self.center_x, center_y=self.center_y)
        return res


def compute_reference_orbit_device(center_x: HighPrecision,
                                   center_y: HighPrecision,
                                   max_iterations: int,
                                   max_radius: HighPrecision,
                                   limbs32: int | None = None,
                                   periodicity: bool = True,
                                   chunk_steps: int = 256,
                                   abort_flag=None,
                                   mesh=None,
                                   reuse_frac_bits: int | None = None,
                                   progress_cb=None,
                                   checkpoint_path: str | None = None,
                                   checkpoint_every_s: float = 300.0,
                                   device="cuda") -> PerturbationResults:
    """Device-orbit entry point (the analogue of
    RefOrbitCalc::AddPerturbationReferencePointGPU,
    RefOrbitCalc.cpp:2167-2260).  ``mesh`` (``parallel.mesh.Mesh``): the
    limb-sharded orbit, every step over the mesh's ranks (each rank calls
    this and gets the same orbit, the one-device session's exactly)."""
    if limbs32 is None:
        prec = max(center_x.prec, center_y.prec)
        limbs32 = max(8, -(-(prec + 64) // 32))
        limbs32 = 1 << (limbs32 - 1).bit_length()  # round up to pow2
    spec = FP.FixedSpec.for_limbs(limbs32)
    session = CudaOrbitSession(spec=spec, center_x=center_x,
                               center_y=center_y, max_radius=max_radius,
                               chunk_steps=chunk_steps, device=device,
                               mesh=mesh)
    return session.run(max_iterations, periodicity=periodicity,
                       abort_flag=abort_flag,
                       reuse_frac_bits=reuse_frac_bits,
                       progress_cb=progress_cb,
                       checkpoint_path=checkpoint_path,
                       checkpoint_every_s=checkpoint_every_s)
