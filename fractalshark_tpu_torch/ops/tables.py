"""The render state carried across from the host: the reference orbit,
the LA table and the orbit anchors, as the port's device tensors.

This system has no weights; its state is these three tables, built on
the host by the port's host layer (native GMP or device orbit, LA
builder, ``CompressedOrbit``: copies of the JAX package's modules).
Each function turns those numpy arrays into tensors on an explicit
``device``, so the JAX package and the port compute from the same host
tables.  Float tables are flushed
of subnormals on the way (see ``hdrfloat.ftz``).

Layouts:

The float tables come in the mantissa type of the render (f32 or f64),
and their integer fields follow the reference's ``_pack_nodes``
convention (``ibits``): bit-cast for f32, exactly converted for f64.

* LA nodes: ``[N, 16]`` rows in the layout of the reference's
  ``la_kernel._pack_nodes`` (``fractalshark_tpu/ops/la_kernel.py:43-81``),
  plus an int64 ``[N, 2]`` side table (step_length,
  next_stage_la_index).  The kernels read both integer fields from the
  side table, so no column wraps at 2^31.
* Stages: ``[S, 4]`` (first node index, macro iteration count, and the
  LAThresholdC mantissa and exponent of the stage's first node).
* AT: ``[13]`` (threshold_c, sqr_escape_radius, ref_c, ccoeff,
  inv_zcoeff), or empty without an AT head skip.
* Orbit: ``[M, 4]`` rows (Z[j], Z[j+1]) from ``_pack_orbit``
  (``:84-94``).
* Anchors: positions (int32 where the orbit allows, else int64) plus
  (hi, lo) f32 pairs of x and y, from ``perturb_stream._prep_anchors``
  (``ops/perturb_stream.py:747-770``) with plain positions in place of
  (window, local) pairs; for K19 (the gather tail's f64 mode) ``[M, 3]``
  f64 rows (x, y, position), ``rc_tail._pack_anchors``
  (``ops/rc_tail.py:63-71``).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from fractalshark_tpu_torch.ops.hdrfloat import flush_np

PACK_COLS = 16


def torch_dtype(sub_dtype) -> torch.dtype:
    """The mantissa type from a numpy or torch dtype (f32 or f64)."""
    if sub_dtype in (torch.float32, torch.float64):
        return sub_dtype
    name = np.dtype(sub_dtype).name
    if name not in ("float32", "float64"):
        raise ValueError(f"unsupported mantissa type {sub_dtype}")
    return getattr(torch, name)


def int32_budget(max_iter: int) -> int:
    """The budget of a route the reference counts in int32 (the HDR and
    double-float escapes, BLA, Scaled): its ``jnp.int32(max_iter)``
    refuses 2^31 and more with OverflowError, and so does the port."""
    max_iter = int(max_iter)
    if not -(1 << 31) <= max_iter < (1 << 31):
        raise OverflowError(f"Python integer {max_iter} out of bounds for "
                            f"int32: this route counts in int32")
    return max_iter


def ibits_np(a, dtype) -> np.ndarray:
    """Integers stored in a float table: bit-cast into f32, exactly
    converted into f64 (``la_kernel._pack_nodes``' ``ibits``)."""
    a = np.ascontiguousarray(np.asarray(a).astype(np.int32))
    return a.view(np.float32) if np.dtype(dtype) == np.float32 \
        else a.astype(np.float64)


def ibits(t: torch.Tensor) -> torch.Tensor:
    """The int32 values of a float table's integer field (inverse of
    ``ibits_np``)."""
    return t.view(torch.int32) if t.dtype == torch.float32 \
        else t.to(torch.int32)


def pack_nodes_np(arrs: dict, dtype=np.float32) -> np.ndarray:
    """[N, 16] node rows (``la_kernel._pack_nodes`` layout)."""
    n = arrs["ref_e"].shape[0]
    P = np.empty((n, PACK_COLS), dtype)
    P[:, 0] = arrs["ref_m"][:, 0]
    P[:, 1] = arrs["ref_m"][:, 1]
    P[:, 2] = ibits_np(arrs["ref_e"], dtype)
    P[:, 3] = arrs["zc_m"][:, 0]
    P[:, 4] = arrs["zc_m"][:, 1]
    P[:, 5] = ibits_np(arrs["zc_e"], dtype)
    P[:, 6] = arrs["cc_m"][:, 0]
    P[:, 7] = arrs["cc_m"][:, 1]
    P[:, 8] = ibits_np(arrs["cc_e"], dtype)
    P[:, 9] = arrs["thr_m"]
    P[:, 10] = ibits_np(arrs["thr_e"], dtype)
    P[:, 11] = ibits_np(arrs["step_length"].astype(np.int64), dtype)
    P[:, 12] = ibits_np(arrs["next_stage_la_index"], dtype)
    P[:-1, 13:16] = P[1:, 0:3]
    P[-1, 13:16] = P[-1, 0:3]
    for c in (0, 1, 3, 4, 6, 7, 9, 13, 14):
        P[:, c] = flush_np(P[:, c])
    return P


@dataclass
class LATables:
    nodes: torch.Tensor      # T [N, 16]
    side: torch.Tensor       # int64 [N, 2]
    stages: torch.Tensor     # T [S, 4]
    at: torch.Tensor         # T [13]; empty if no AT
    at_step: int             # 0 = no AT head skip
    stage_count: int
    max_step: int            # longest step_length in the table


def la_tables(la, device, dtype=torch.float32) -> LATables:
    """LA table → device tensors with `dtype` mantissas
    (``la.device_arrays``)."""
    npdt = np.float32 if dtype == torch.float32 else np.float64
    arrs = la.device_arrays(npdt)
    nodes = pack_nodes_np(arrs, npdt)
    side = np.stack([arrs["step_length"].astype(np.int64),
                     arrs["next_stage_la_index"].astype(np.int64)], axis=1)
    heads = np.asarray(arrs["stage_la_index"], np.int64)
    stages = np.zeros((len(heads), 4), npdt)
    stages[:, 0] = ibits_np(heads, npdt)
    stages[:, 1] = ibits_np(arrs["stage_macro_it_count"], npdt)
    stages[:, 2] = flush_np(arrs["thrc_m"][heads].astype(npdt))
    stages[:, 3] = ibits_np(arrs["thrc_e"][heads], npdt)
    at_vals = np.zeros(0, npdt)
    at_step = 0
    if la.use_at and la.at is not None:
        at = la.at

        def s2(v):
            return [npdt(v.m), np.int32(v.e)]

        def c3(z):
            return [npdt(z.m.real), npdt(z.m.imag), np.int32(z.e)]

        vals = (s2(at.threshold_c) + s2(at.sqr_escape_radius) +
                c3(at.ref_c) + c3(at.ccoeff) + c3(at.inv_zcoeff))
        at_vals = np.array(
            [flush_np(v) if isinstance(v, npdt) else ibits_np([v], npdt)[0]
             for v in vals], npdt)
        at_step = int(at.step_length)

    def up(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    return LATables(nodes=up(nodes), side=up(side), stages=up(stages),
                    at=up(at_vals), at_step=at_step,
                    stage_count=int(arrs["stage_count"]),
                    max_step=int(side[:, 0].max()) if len(side) else 0)


def pack_orbit_np(ox: np.ndarray, oy: np.ndarray, max_ref: int) -> np.ndarray:
    """[M, 4] rows (Z[j].re, Z[j].im, Z[j+1].re, Z[j+1].im)."""
    n = len(ox)
    m = min(n, max_ref + 1)
    OP = np.empty((m, 4), ox.dtype)
    OP[:, 0] = ox[:m]
    OP[:, 1] = oy[:m]
    OP[:m - 1, 2] = ox[1:m]
    OP[:m - 1, 3] = oy[1:m]
    OP[m - 1, 2] = ox[m - 1]
    OP[m - 1, 3] = oy[m - 1]
    return OP


def orbit_table(results, device, dtype=torch.float32) -> torch.Tensor:
    """Reference orbit → [M, 4] of `dtype` on `device`."""
    ox, oy = results.device_orbit(
        np.float32 if dtype == torch.float32 else np.float64)
    packed = flush_np(pack_orbit_np(np.asarray(ox), np.asarray(oy),
                                    int(results.max_ref_iteration())))
    return torch.from_numpy(np.ascontiguousarray(packed)).to(device)


def orbit_on(results, device, dtype=torch.float32) -> torch.Tensor:
    """``orbit_table`` cached on the results, for the lifetime of that
    orbit."""
    key = ("torch_orbit", str(device), dtype)
    orbit = results.extra.get(key)
    if orbit is None:
        orbit = results.extra[key] = orbit_table(results, device, dtype)
    return orbit


@dataclass
class Anchors:
    index: torch.Tensor      # [M] orbit positions, ascending: int32 where
    #                          max_ref < 2^31 - 1, else int64
    val: torch.Tensor        # f32 [M, 4] (x_hi, x_lo, y_hi, y_lo)
    max_ref: int
    c: tuple                 # (cx_hi, cx_lo, cy_hi, cy_lo) as floats
    f64 = False              # K3's df32 table (K19's: Anchors64)


@dataclass
class Anchors64:
    """K19's anchor table: the reference's gather-tail table in f64
    (``rc_tail.py:63-71``), its rows laid out for two vector loads."""
    rows: torch.Tensor       # f64 [M, 4] (x, y, the position's int64 bits,
    #                          a zero pad): 32 bytes a row
    index: torch.Tensor      # int64 [M] the same positions
    max_ref: int
    c: tuple                 # (cx, cy) as f64
    f64 = True

    @property
    def val(self) -> torch.Tensor:
        """The anchors' values, f64 [M, 2] (x, y): a view of `rows`."""
        return self.rows[:, :2]


def _hi_lo(v: np.ndarray):
    hi = v.astype(np.float32)
    return hi, (v - hi.astype(np.float64)).astype(np.float32)


def anchor_table(compressed, device, wide: bool | None = None) -> Anchors:
    """CompressedOrbit → anchor tensors on `device`.  Position 0 must be
    an anchor: a rebase restarts reconstruction there.  The positions are
    int32 unless `wide` (default: where max_ref < 2^31 - 1 does not
    hold), and K3's positions and anchor pointers take their type."""
    M = len(compressed.anchors_x)
    if M == 0 or int(compressed.anchor_index[0]) != 0:
        raise ValueError("anchor table must start at orbit position 0")
    xh, xl = _hi_lo(np.asarray(compressed.anchors_x, np.float64))
    yh, yl = _hi_lo(np.asarray(compressed.anchors_y, np.float64))
    val = flush_np(np.stack([xh, xl, yh, yl], axis=1))
    cxh, cxl = _hi_lo(np.asarray([compressed.cx_low], np.float64))
    cyh, cyl = _hi_lo(np.asarray([compressed.cy_low], np.float64))
    c = tuple(float(flush_np(v)[0]) for v in (cxh, cxl, cyh, cyl))
    max_ref = int(compressed.total_count) - 1
    if wide is None:
        wide = max_ref >= np.iinfo(np.int32).max
    itype = np.int64 if wide else np.int32
    return Anchors(
        index=torch.from_numpy(np.asarray(compressed.anchor_index,
                                          itype).copy()).to(device),
        val=torch.from_numpy(np.ascontiguousarray(val)).to(device),
        max_ref=max_ref, c=c)


def anchor_table_f64(compressed, device) -> Anchors64:
    """CompressedOrbit → K19's f64 anchor rows on `device` (values and c
    flushed of subnormals, as the reference's f64 runs with DAZ; the
    positions' int64 bits in column 2).  Position 0 must be an anchor."""
    M = len(compressed.anchors_x)
    if M == 0 or int(compressed.anchor_index[0]) != 0:
        raise ValueError("anchor table must start at orbit position 0")
    index = np.asarray(compressed.anchor_index, np.int64)
    rows = np.zeros((M, 4), np.float64)
    rows[:, 0] = flush_np(np.asarray(compressed.anchors_x, np.float64))
    rows[:, 1] = flush_np(np.asarray(compressed.anchors_y, np.float64))
    rows[:, 2] = index.view(np.float64)
    c = tuple(float(flush_np(np.asarray([v], np.float64))[0])
              for v in (compressed.cx_low, compressed.cy_low))
    return Anchors64(
        rows=torch.from_numpy(rows).to(device),
        index=torch.from_numpy(index.copy()).to(device),
        max_ref=int(compressed.total_count) - 1, c=c)
