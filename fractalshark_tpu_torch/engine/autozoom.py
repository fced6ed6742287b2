"""Automated zoom animation (reference ``AutoZoomer.h:7-31``,
heuristics {Default, Max, Feature, FilamentTip}, ``Fractal.h:101``).
The port of ``fractalshark_tpu/engine/autozoom.py``; the target is picked
on the host from the render's grid (``Fractal.iters_numpy``).

Each step picks a target in the current view and zooms toward it:

* Max / Default — the unescaped-or-slowest region: centroid of the
  highest-iteration pixels (keeps descending into the boundary),
* FilamentTip — the escaped pixel with the highest count (follows a
  filament outward),
* Feature — run the Feature Finder and zoom onto the found nucleus.

Two drive modes, matching the reference:

* ``step()``/``run()`` — synchronous step loop (the reference's
  Default/Max/FilamentTip ``Run()`` is likewise sequential: each
  recenter is an ``EnqueueCommand(...).Wait()``, AutoZoomer.cpp:415-421);
* ``setup_feature_zoom()`` + ``run_feature_zoom_pipeline()`` — the
  feature-zoom ANIMATION (AutoZoomer.cpp:543-688): all zoom steps are
  precomputed (×1.1 zoom per step, iterations linearly interpolated),
  then enqueued through the render pool as NON-supersedable
  paced-animation jobs with a bounded pipeline (depth 4×workers,
  wait-on-oldest), presented at a fixed cadence; on abort the paced
  group is cancelled and the last presented view restored.
"""

from __future__ import annotations

import math
import threading
from dataclasses import dataclass
from enum import Enum

import numpy as np


class AutoZoomHeuristic(Enum):
    DEFAULT = "default"
    MAX = "max"
    FEATURE = "feature"
    FILAMENT_TIP = "filament_tip"


@dataclass
class AutoZoomer:
    fractal: object
    heuristic: AutoZoomHeuristic = AutoZoomHeuristic.DEFAULT
    scale_per_step: float = 2.0

    def pick_target(self, iters: np.ndarray) -> tuple[float, float]:
        """Screen-space target (x, y) for the next zoom."""
        h, w = iters.shape
        n = self.fractal.num_iterations
        escaped = iters < n
        if not escaped.any():
            return w / 2, h / 2
        if self.heuristic is AutoZoomHeuristic.FILAMENT_TIP:
            vals = np.where(escaped, iters, 0)
            flat = int(vals.argmax())
            return flat % w, flat // w
        # Default/Max: centroid of the slowest-escaping band — tracks
        # the set boundary (interior pixels are excluded so the target
        # never drifts into the cardioid)
        esc_vals = iters[escaped]
        thresh = np.quantile(esc_vals, 0.98)
        mask = escaped & (iters >= thresh)
        ys, xs = np.nonzero(mask)
        return float(xs.mean()), float(ys.mean())

    def step(self) -> dict:
        f = self.fractal
        if self.heuristic is AutoZoomHeuristic.FEATURE:
            feat = f.try_find_periodic_point()
            if feat is not None:
                f.zoom_to_feature(feat, frame_scale=self.scale_per_step)
                return {"target": "feature", "period": feat.period,
                        "zoom": float(f.ptz.zoom_factor.mantissa_exp2()[1])}
            # fall through to max heuristic when no feature found
        f.calc_fractal()
        tx, ty = self.pick_target(f.iters_numpy())
        # scale from AA render grid to screen coordinates
        aa = f.antialiasing
        f.zoom_at(tx / aa, ty / aa, self.scale_per_step)
        return {"target": (tx, ty),
                "zoom_exp2": f.ptz.zoom_factor.exponent2()}

    def run(self, n_steps: int, on_frame=None) -> list:
        log = []
        for _ in range(n_steps):
            info = self.step()
            log.append(info)
            if on_frame is not None:
                on_frame(self.fractal)
        return log

    # ------------------------------------------- feature-zoom animation

    def setup_feature_zoom(self, feature=None, target_ptz=None,
                           target_iters: int | None = None,
                           max_steps: int | None = None
                           ) -> list["FeatureZoomStep"]:
        """Precompute the animation's zoom steps
        (AutoZoomer::SetupFeatureZoom, AutoZoomer.cpp:543-611): recenter
        at the target at the CURRENT zoom, then zoom ×1.1 per step
        (ZoomInPlace(-1/22), PointZoomBBConverter.cpp:400-406) until the
        target zoom, interpolating the iteration budget linearly when it
        rises."""
        f = self.fractal
        from fractalshark_tpu_torch.core.pointzoom import PointZoomBBConverter
        if feature is not None:
            from fractalshark_tpu_torch.core.highprecision import HighPrecision
            size = feature.size_estimate
            zoom = HighPrecision.from_mant_exp(128, -size.e - 4, prec=64)
            target_ptz = PointZoomBBConverter(
                pt_x=feature.center_x, pt_y=feature.center_y,
                zoom_factor=zoom)
            if target_iters is None:
                # reference uses the finder's NumIterationsAtFind; our
                # FeatureSummary records the NR iteration count instead —
                # scale the budget with the period as the finder does
                target_iters = max(f.num_iterations, 100 * feature.period)
        if target_ptz is None:
            raise ValueError("need feature or target_ptz")
        start_iters = f.num_iterations
        tgt_iters = int(target_iters or 0)
        interpolate = tgt_iters > start_iters
        # start position: target center at the original zoom
        orig_zoom = f.ptz.zoom_factor
        start = PointZoomBBConverter(
            pt_x=target_ptz.pt_x, pt_y=target_ptz.pt_y,
            zoom_factor=orig_zoom).square_aspect_ratio(f.width, f.height)
        m, e2 = (target_ptz.zoom_factor / orig_zoom).mantissa_exp2()
        log_ratio = math.log(abs(m)) + e2 * math.log(2.0)
        total = max(1, math.ceil(log_ratio / math.log(1.1)))
        if max_steps is not None:
            total = min(total, max_steps)
        steps = []
        ptz = start
        for i in range(total):
            ptz = ptz.zoomed_at_center(1.1)
            iters = (start_iters + (tgt_iters - start_iters) * (i + 1)
                     // total) if interpolate else start_iters
            steps.append(FeatureZoomStep(ptz=ptz, num_iterations=iters))
        return steps

    def run_feature_zoom_pipeline(self, pool, steps,
                                  interval_s: float = 0.0,
                                  on_frame=None,
                                  abort_flag: threading.Event | None = None,
                                  timeout_s: float = 600.0) -> dict:
        """Drive the precomputed steps through the render pool as
        NON-supersedable paced-animation jobs
        (AutoZoomer::RunFeatureZoomPipeline, AutoZoomer.cpp:623-688):
        bounded pipeline depth 4×workers with wait-on-oldest
        backpressure; a paced presenter consumes the frames at the
        requested cadence; on abort the group is cancelled and the last
        presented view restored; on success the final step is applied to
        live state so the view doesn't snap back."""
        from fractalshark_tpu_torch.engine.render_pool import PacedPresenter
        if not steps:
            return {"presented": 0, "aborted": False, "frames": []}
        group = pool.begin_paced_animation()
        presenter = PacedPresenter(pool, group, interval_s=interval_s,
                                   on_frame=on_frame)
        consumer = threading.Thread(
            target=presenter.present,
            args=(len(steps),), kwargs={"timeout": timeout_s}, daemon=True)
        consumer.start()
        depth = 4 * len(pool._workers)
        handles: list[int | None] = [None] * depth
        aborted = False
        for i, step in enumerate(steps):
            if abort_flag is not None and abort_flag.is_set():
                aborted = True
                break
            # wait for the oldest in-flight item before enqueueing
            h = handles[i % depth]
            if h is not None and not pool.wait(h, timeout=timeout_s):
                aborted = True
                break
            handles[i % depth] = pool.enqueue_mutation(
                _apply_step(step), supersedable=False, group=group,
                final_only=True)
        for h in handles:
            if h is not None:
                pool.wait(h, timeout=timeout_s)
        if aborted:
            pool.cancel_paced_animation(group)
            self._restore_last_presented(pool)
        else:
            pool.wait(pool.enqueue_mutation(_apply_step(steps[-1]),
                                            supersedable=False),
                      timeout=timeout_s)
        consumer.join(timeout=timeout_s)
        return {"presented": len(presenter.presented),
                "aborted": aborted,
                "frames": presenter.presented}

    def _restore_last_presented(self, pool) -> None:
        """RestoreLastPresentedView (AutoZoomer.cpp:690-708)."""
        view = pool.last_presented_view
        if not view:
            return
        step = FeatureZoomStep(ptz=view["ptz"],
                               num_iterations=view["num_iterations"])
        pool.wait(pool.enqueue_mutation(_apply_step(step)))


@dataclass
class FeatureZoomStep:
    """One animation frame's view + budget (AutoZoomer.h:15-18)."""
    ptz: object
    num_iterations: int


def _apply_step(step: FeatureZoomStep):
    """ApplyFeatureZoomStep as a pool mutation (AutoZoomer.cpp:513-520)."""
    def apply(f):
        f.set_view(step.ptz, square_aspect=False)
        if step.num_iterations:
            f.num_iterations = int(step.num_iterations)
    return apply
