"""Async render pipeline: worker pool, supersedable jobs, ordered frame
queue, progressive frames, abort.  The port of
``fractalshark_tpu/engine/render_pool.py``.

Rebuild of ``FractalSharkLib/RenderThreadPool.{h,cpp}``:

* ``RenderWorkItem`` snapshots the view/algorithm state with a
  monotonically increasing generation; newer supersedable jobs cancel
  older ones still in the queue (RenderThreadPool.h:32-95);
* N workers take jobs concurrently (the reference acquires one of 4
  GPURenderer slots per worker, RenderThreadPool.h:144-165); each worker
  renders on a ``Fractal`` of its own on the pool's device, and every
  render holds one pool-wide device lock.  The JAX package leaves that
  to XLA, which serializes device use; the port keeps device tables and
  scratch in caches beside the data (the orbit cache the workers share,
  the anchor and LA tables on its results, the kernels' scratch), which
  two renders at once could fill and read together;
* progressive frames: low-resolution passes stream out before the final
  full-resolution frame (the reference reads back partial GPU buffers);
* a completion queue delivers frames in generation order
  (FrameCompletionQueue, RenderThreadPool.h:184-260), dropping frames
  whose generation was superseded;
* EnqueueCommand/EnqueueMutation run state mutations on the pool
  (Fractal.h:185-196);
* abort: a shared event checked between progressive passes (the
  reference's AbortMonitor polls every 16384 iterations).
"""

from __future__ import annotations

import queue
import threading
import time
from dataclasses import dataclass, field
from typing import Callable

import numpy as np


@dataclass(order=True)
class RenderFrame:
    generation: int
    pass_index: int
    final: bool = field(compare=False)
    rgba: np.ndarray = field(compare=False, repr=False)
    wall_s: float = field(compare=False, default=0.0)
    # presentation group (BeginPacedAnimation, RenderThreadPool.h:184):
    # 0 = immediate; >0 = frames of one paced animation
    group: int = field(compare=False, default=0)
    # view snapshot of the rendered frame, for GetLastPresentedView
    view: dict = field(compare=False, default=None, repr=False)


@dataclass
class RenderWorkItem:
    generation: int
    supersedable: bool
    snapshot: dict              # view + params captured at enqueue time
    mutation: Callable | None = None
    group: int = 0
    # paced-animation frames skip the progressive low-res passes: each
    # enqueued step is exactly one presented frame
    final_only: bool = False


class RenderThreadPool:
    def __init__(self, fractal, num_workers: int = 2,
                 progressive_scales: tuple = (4, 1)):
        self.fractal = fractal
        self.progressive_scales = progressive_scales
        self._queue: "queue.Queue[RenderWorkItem|None]" = queue.Queue()
        self._frames: "queue.PriorityQueue[RenderFrame]" = \
            queue.PriorityQueue()
        self._gen = 0
        self._latest_supersedable = 0
        self._delivered_final = -1
        self._lock = threading.Lock()
        self._done_cv = threading.Condition(self._lock)
        self._completed: set[int] = set()
        self._next_group = 1
        self._cancelled_groups: set[int] = set()
        self._group_gens: dict[int, list[int]] = {}
        self.last_presented_view: dict | None = None
        self.abort_flag = threading.Event()
        # held by every render on the device (the module's docstring)
        self.device_lock = threading.Lock()
        self._shutdown = False
        self._workers = [
            threading.Thread(target=self._worker_loop, daemon=True,
                             name=f"render-worker-{i}")
            for i in range(num_workers)]
        for w in self._workers:
            w.start()

    # ------------------------------------------------------------- enqueue

    def enqueue_render(self, supersedable: bool = True) -> int:
        with self._lock:
            self._gen += 1
            gen = self._gen
            if supersedable:
                self._latest_supersedable = gen
            snap = {
                "ptz": self.fractal.ptz,
                "algorithm": self.fractal.algorithm_name,
                "num_iterations": self.fractal.num_iterations,
                "antialiasing": self.fractal.antialiasing,
                "width": self.fractal.width,
                "height": self.fractal.height,
            }
        self._queue.put(RenderWorkItem(gen, supersedable, snap))
        return gen

    def enqueue_mutation(self, fn: Callable, supersedable: bool = True,
                         group: int = 0, final_only: bool = False) -> int:
        """Run a state mutation on the pool (EnqueueMutation,
        Fractal.h:185-196), then trigger a render.  With
        ``supersedable=False`` the job can't be cancelled by newer work
        — the paced-animation mode (AutoZoomer.cpp:623-688 enqueues
        every zoom step this way)."""
        with self._lock:
            self._gen += 1
            gen = self._gen
            if supersedable:
                self._latest_supersedable = gen
            if group:
                self._group_gens.setdefault(group, []).append(gen)
        self._queue.put(RenderWorkItem(gen, supersedable, {}, mutation=fn,
                                       group=group, final_only=final_only))
        return gen

    # ------------------------------------------------- paced animation
    def begin_paced_animation(self) -> int:
        """Open a presentation group (Fractal::BeginPacedAnimation):
        frames tagged with it belong to one animation and can be
        cancelled as a unit."""
        with self._lock:
            g = self._next_group
            self._next_group += 1
            self._group_gens[g] = []
        return g

    def group_generation(self, group: int, index: int) -> int | None:
        """Generation of the ``index``-th job enqueued in ``group``, or
        None if not yet enqueued.  Lets a paced consumer present the
        group's frames in enqueue order even when two workers finish
        adjacent steps out of order."""
        with self._lock:
            gens = self._group_gens.get(group, ())
            return gens[index] if index < len(gens) else None

    def cancel_paced_animation(self, group: int) -> None:
        """Drop the group's not-yet-presented frames
        (RenderPool::CancelPacedAnimation)."""
        with self._lock:
            self._cancelled_groups.add(group)

    def wait(self, generation: int, timeout: float = 120.0) -> bool:
        """Block until the job's render work finished (or was skipped
        as stale) — RenderJobHandle::Wait."""
        deadline = time.monotonic() + timeout
        with self._done_cv:
            while generation not in self._completed:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return False
                self._done_cv.wait(remaining)
        return True

    def _mark_done(self, generation: int) -> None:
        with self._done_cv:
            self._completed.add(generation)
            self._done_cv.notify_all()

    # -------------------------------------------------------------- worker

    def _stale(self, item: RenderWorkItem) -> bool:
        return (item.supersedable and
                item.generation < self._latest_supersedable)

    def _worker_loop(self) -> None:
        from fractalshark_tpu_torch.engine.fractal import Fractal
        from fractalshark_tpu_torch.ops.coloring import rgba16_to_numpy

        while True:
            item = self._queue.get()
            if item is None:
                return
            if self._stale(item):
                self._mark_done(item.generation)
                continue
            if item.mutation is not None:
                item.mutation(self.fractal)
                snap = {
                    "ptz": self.fractal.ptz,
                    "algorithm": self.fractal.algorithm_name,
                    "num_iterations": self.fractal.num_iterations,
                    "antialiasing": self.fractal.antialiasing,
                    "width": self.fractal.width,
                    "height": self.fractal.height,
                }
                item = RenderWorkItem(item.generation, item.supersedable,
                                      snap, group=item.group,
                                      final_only=item.final_only)
            snap = item.snapshot
            t0 = time.perf_counter()
            scales = (self.progressive_scales[-1:] if item.final_only
                      else self.progressive_scales)
            for pi, scale in enumerate(scales):
                if self.abort_flag.is_set() or self._stale(item):
                    break
                w = max(8, snap["width"] // scale)
                h = max(8, snap["height"] // scale)
                frac = Fractal(width=w, height=h, view=snap["ptz"],
                               algorithm=snap["algorithm"],
                               num_iterations=snap["num_iterations"],
                               antialiasing=1, device=self.fractal.device)
                frac._orbit_cache = self.fractal._orbit_cache
                with self.device_lock:
                    rgba = rgba16_to_numpy(frac.render())
                final = pi == len(scales) - 1
                self._frames.put(RenderFrame(
                    generation=item.generation, pass_index=pi,
                    final=final, rgba=rgba,
                    wall_s=time.perf_counter() - t0,
                    group=item.group,
                    view={"ptz": snap["ptz"],
                          "num_iterations": snap["num_iterations"]}))
            self._mark_done(item.generation)

    # ------------------------------------------------------------ consumer

    def next_frame(self, timeout: float | None = 5.0) -> RenderFrame | None:
        """Pop the next frame in generation order, skipping superseded
        generations' non-final frames."""
        deadline = time.monotonic() + (timeout or 0)
        while True:
            remaining = None if timeout is None else \
                max(0.0, deadline - time.monotonic())
            try:
                frame = self._frames.get(timeout=remaining)
            except queue.Empty:
                return None
            if frame.group and frame.group in self._cancelled_groups:
                continue  # cancelled paced animation: drop its frames
            if (frame.generation < self._latest_supersedable and
                    not frame.final):
                continue  # superseded progressive frame: drop
            if (frame.final and not frame.group
                    and frame.generation <= self._delivered_final):
                continue  # stale duplicate (latest-wins interactive path)
            if frame.final:
                # grouped finals are exempt from latest-wins dropping:
                # a paced animation presents EVERY step, and two workers
                # can finish adjacent steps out of enqueue order
                self._delivered_final = max(self._delivered_final,
                                            frame.generation)
                if frame.view is not None:
                    self.last_presented_view = frame.view
            return frame

    def wait_idle(self, timeout: float = 60.0) -> bool:
        t0 = time.monotonic()
        while time.monotonic() - t0 < timeout:
            if self._queue.empty():
                return True
            time.sleep(0.01)
        return False

    def shutdown(self) -> None:
        self._shutdown = True
        for _ in self._workers:
            self._queue.put(None)
        for w in self._workers:
            w.join(timeout=10)


class PacedPresenter:
    """Fixed-cadence consumer for one paced-animation group
    (RenderPresentationMode::PacedAnimation): final frames of the group
    are presented no faster than ``interval_s`` apart, in generation
    order, none dropped — the animation analogue of the GL consumer
    thread the reference's frame queue feeds."""

    def __init__(self, pool: RenderThreadPool, group: int,
                 interval_s: float = 0.0, on_frame: Callable | None = None):
        self.pool = pool
        self.group = group
        self.interval_s = interval_s
        self.on_frame = on_frame
        self.presented: list[tuple[int, float]] = []  # (gen, present_t)

    def present(self, n_frames: int, timeout: float = 300.0) -> int:
        """Consume up to ``n_frames`` final frames of the group; returns
        how many were presented (fewer if cancelled/timeout).  Frames
        are presented in ENQUEUE order: two pool workers can finish
        adjacent animation steps out of order, so arrivals are buffered
        until the next expected generation lands."""
        deadline = time.monotonic() + timeout
        next_present = time.monotonic()
        pending: dict[int, object] = {}  # generation -> out-of-order frame
        n = 0
        while n < n_frames and time.monotonic() < deadline:
            expected = self.pool.group_generation(self.group, n)
            frame = pending.pop(expected, None) if expected is not None \
                else None
            if frame is None:
                # short poll, NOT the full deadline: after a
                # cancel_paced_animation no more group frames arrive, and
                # the cancellation check below is the only exit — a
                # deadline-length get() would strand the consumer thread
                # for the caller's whole timeout
                frame = self.pool.next_frame(
                    timeout=min(0.25, max(0.05,
                                          deadline - time.monotonic())))
                if frame is None:
                    with self.pool._lock:
                        if self.group in self.pool._cancelled_groups:
                            break
                    continue
                if frame.group != self.group or not frame.final:
                    continue
                # re-fetch: enqueue registers the generation under the
                # pool lock BEFORE the worker can produce the frame, so
                # once any frame of index >= n exists, gens[n] is
                # defined — a pre-pop None must not present blindly (an
                # out-of-order arrival would strand the true n-th frame
                # in `pending` forever)
                expected = self.pool.group_generation(self.group, n)
                if frame.generation != expected:
                    pending[frame.generation] = frame
                    continue
            now = time.monotonic()
            if now < next_present:
                time.sleep(next_present - now)
            next_present = time.monotonic() + self.interval_s
            self.presented.append((frame.generation, time.monotonic()))
            if self.on_frame is not None:
                self.on_frame(frame)
            n += 1
        return n
