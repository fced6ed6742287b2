"""Auxiliary runtime subsystems (SURVEY.md §5).

* AbortMonitor — a background watcher that trips a shared abort event
  (the reference polls a Ctrl+Alt chord every 16384 iterations,
  ``AbortMonitor.h:7-35``; headless here: a callback/file/SIGUSR1 can
  trip it). Long-running loops (orbit chunks, render pool passes)
  consult the same ``threading.Event``.
* BenchmarkTimer / BenchmarkDataCollection — phase timers
  (``BenchmarkData.h:28-46``: overall / per-pixel / ref-orbit / LA).
* VerboseMode — global verbosity switch (``TestVerbose.h:1-7``).
* MemoryBudget — a soft commit cap: device-buffer allocations are
  tracked and renders refuse to start past the budget (the reference
  enforces ``m_CommitLimitInBytes`` through its custom heap,
  ``Fractal.h:520``; here it caps planned device buffers: the CLI's
  ``--commit-cap-bytes``).
"""

from __future__ import annotations

import os
import signal
import threading
import time
from contextlib import contextmanager
from dataclasses import dataclass, field
from enum import Enum


class VerboseMode(Enum):
    NONE = 0
    BASIC = 1
    DETAILED = 2


_verbose = VerboseMode.NONE


def set_verbose(mode: VerboseMode) -> None:
    global _verbose
    _verbose = mode


def verbose() -> VerboseMode:
    return _verbose


def vlog(msg: str, level: VerboseMode = VerboseMode.BASIC) -> None:
    if _verbose.value >= level.value:
        print(f"[fractalshark] {msg}", flush=True)


class AbortMonitor:
    """Shared abort signal with optional SIGUSR1 / sentinel-file
    triggers. Check interval semantics live at the *poll sites* (the
    compute loops), as in the reference (16384-iteration granularity)."""

    CHECK_INTERVAL = 16384  # AbortMonitor.h:22

    _global = None

    def __init__(self, sentinel_file: str | None = None,
                 install_signal: bool = False, poll_s: float = 0.25):
        self.flag = threading.Event()
        self._sentinel = sentinel_file
        self._stop = threading.Event()
        self._thread = None
        if install_signal:
            try:
                signal.signal(signal.SIGUSR1, lambda *_: self.flag.set())
            except ValueError:
                pass  # not the main thread
        if sentinel_file:
            self._thread = threading.Thread(target=self._watch,
                                            args=(poll_s,), daemon=True)
            self._thread.start()

    def _watch(self, poll_s: float) -> None:
        while not self._stop.is_set():
            if self._sentinel and os.path.exists(self._sentinel):
                self.flag.set()
            time.sleep(poll_s)

    def abort(self) -> None:
        self.flag.set()

    def reset(self) -> None:
        self.flag.clear()

    def aborted(self) -> bool:
        return self.flag.is_set()

    def close(self) -> None:
        self._stop.set()

    @classmethod
    def get_global(cls) -> "AbortMonitor":
        if cls._global is None:
            cls._global = AbortMonitor()
        return cls._global


@dataclass
class BenchmarkTimer:
    """High-resolution scoped timer (BenchmarkTimer.h:45)."""
    total_s: float = 0.0
    count: int = 0
    _t0: float | None = None

    def start(self) -> None:
        self._t0 = time.perf_counter()

    def stop(self) -> float:
        dt = time.perf_counter() - (self._t0 or time.perf_counter())
        self.total_s += dt
        self.count += 1
        self._t0 = None
        return dt

    @contextmanager
    def scope(self):
        self.start()
        try:
            yield self
        finally:
            self.stop()

    def delta_ms(self) -> float:
        return self.total_s * 1e3


@dataclass
class BenchmarkDataCollection:
    """{overall, per-pixel, ref-orbit, LA-generation} phase timers
    (BenchmarkData.h:28-46)."""
    overall: BenchmarkTimer = field(default_factory=BenchmarkTimer)
    per_pixel: BenchmarkTimer = field(default_factory=BenchmarkTimer)
    ref_orbit: BenchmarkTimer = field(default_factory=BenchmarkTimer)
    la_generation: BenchmarkTimer = field(default_factory=BenchmarkTimer)

    def report(self) -> dict:
        return {k: round(getattr(self, k).total_s, 4)
                for k in ("overall", "per_pixel", "ref_orbit",
                          "la_generation")}


class MemoryBudget:
    """Soft commit cap for planned device buffers
    (m_CommitLimitInBytes analogue)."""

    def __init__(self, limit_bytes: int | None = None):
        self.limit = limit_bytes
        self.committed = 0
        self._lock = threading.Lock()

    def reserve(self, nbytes: int) -> None:
        with self._lock:
            if self.limit is not None and \
                    self.committed + nbytes > self.limit:
                raise MemoryError(
                    f"commit cap exceeded: {self.committed + nbytes} > "
                    f"{self.limit} bytes")
            self.committed += nbytes

    def release(self, nbytes: int) -> None:
        with self._lock:
            self.committed = max(0, self.committed - nbytes)

    @contextmanager
    def reserved(self, nbytes: int):
        self.reserve(nbytes)
        try:
            yield
        finally:
            self.release(nbytes)
