"""The gather RC tail: the port of ``fractalshark_tpu/ops/rc_tail.py``.

After the LA handoff each pixel jumps to its own orbit position: the
last anchor at or before it (a binary search), a catch-up across the
anchor gap with the low-precision recurrence z ← z² + c_low, then the
HDR-f32 perturbation tail with one anchor probe a step.  The cost is
each pixel's own work, not the orbit length, which is why the reference
takes this tail for orbits of 64M positions and more
(``engine/renderers.py:261-267``; View #27's period is 28.3e9).

Two modes, as the reference's:

* ``mode="f64"`` (the default on every device: the reference's CPU
  default, and the card has native f64): the reconstruction in true f64,
  the values of ``CompressedOrbit.decompress()``, so a two-phase render
  through it equals the one-kernel LA machine on the decompressed orbit.
  On the card this is kernel K19 (``csrc/rc_tail.cu``
  ``rc_gather_kernel``, ``fs_rc_tail_f64``: one lane a pixel with K3's
  anchor cursor in f64, the recurrence unflushed where an exponent guard
  admits it, int64 positions and anchor pointers, anchors as 32-byte f64
  rows, ``tables.Anchors64``); its plain twin is
  ``rc_tail_gather_plain`` (the reference's ``_init_state`` and
  ``_tail_impl`` on CPU f64 tensors).
* ``mode="df32"``: the double-float reconstruction of the sweep kernel,
  which is K3 as it stands (it already keeps one cursor per pixel, the
  gather design); the reference pins df32 gather = sweep
  (``tests/test_rc_tail.py:126``).  Against the f64 mode, last-ulp
  iteration flips are possible on compressed orbits (``rc_tail.py:41-44``).

Both run through ``perturb_stream.rc_tail_run``: the init launch (the
wrap rebase at jwait ≥ max_ref, the search and the catch-up), then
launches of ``chunk_steps`` steps over the pixels still live.  The grid
is int64; ``Fractal.iters_numpy`` gives uint32 below a budget of 2^31 and
uint64 from it, as ``rc_tail.py:441-443`` does.

Unlike the reference: zero anchors raise ``ValueError`` (it returned
None), and positions are never narrowed to int32 where the orbit's last
gap needs more (its df32 mode's ``gapW``, ``rc_tail.py:413``): K3
takes int64 positions from max_ref 2^31 - 1 on, K19 always.
"""

from __future__ import annotations

import torch

from fractalshark_tpu_torch.core.pointzoom import PointZoomBBConverter
from fractalshark_tpu_torch.ops import perturb_stream as ps
from fractalshark_tpu_torch.ops.hdrfloat import HDRComplex

MODES = ("f64", "df32")


def rc_tail_gather(compressed, center_x, center_y,
                   ptz: PointZoomBBConverter, width: int, height: int,
                   max_iter: int, init_state: dict,
                   chunk_steps: int | None = None, abort_monitor=None,
                   mode: str | None = None, device="cuda") -> torch.Tensor:
    """The LA-handoff tail over the compressed orbit's anchors.
    ``init_state``: a dict of [height, width] tensors 'dzr', 'dzi', 'dze',
    'it' (completed iterations), 'jwait' (orbit position) and 'done'.
    ``mode``: "f64" (None) or "df32".  Returns the int64 iteration grid
    [height, width]: K19 (f64) or K3 (df32) on a CUDA device, their twins
    on the CPU."""
    if len(compressed.anchors_x) == 0:
        raise ValueError("rc_tail_gather: the compressed orbit has no "
                         "anchors")
    mode = "f64" if mode is None else mode
    if mode not in MODES:
        raise ValueError(f"rc_tail_gather: mode {mode!r} is not one of "
                         f"{MODES}")
    return ps.perturb_render_stream_rc(
        compressed, center_x, center_y, ptz, width, height, max_iter,
        init_state, chunk_steps, abort_monitor, device, f64=mode == "f64")


def rc_tail_gather_plain(A, dc: HDRComplex, init_state: dict, max_iter: int,
                         z_mr: tuple) -> torch.Tensor:
    """K19's plain twin in one lockstep run on the tensors' device (the
    reference's ``_init_state`` then ``_tail_impl`` with no chunk bound),
    from an ``Anchors64`` table and a handoff dict: the remaining budget
    per pixel (flat int64).  With an ``Anchors`` table it is K3's."""
    flat = HDRComplex(*(t.reshape(-1).contiguous() for t in dc))
    st = ps.rc_init_plain(A, ps.handoff_state(A, init_state, dc.re.device),
                          max_iter, z_mr)
    return ps.rc_tail_plain(A, flat, st)[3]
