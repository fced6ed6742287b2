"""Device-time measurement from ``torch.profiler`` traces: the port of
``fractalshark_tpu/utils/profiling.py`` with the same interface.

A host clock around a launch measures the enqueue, and CUDA events around
it include launch gaps; the profiler's kernel records are the device's
own intervals (the reference's GPU-side ``BenchmarkTimer``,
``BenchmarkTimer.h:45``).  ``device_time_ms`` runs a callable under a
trace and sums the CUDA kernel events of the exported Chrome trace: only
kernels, since the trace's ranges nest kernels and would count them twice.
"""

from __future__ import annotations

import json
import os
import shutil
import tempfile
from collections import defaultdict


def device_time_ms(fn, *, trace_dir: str | None = None,
                   keep: bool = False) -> dict:
    """Run ``fn()`` once under a profiler trace, synchronised; returns
    ``{"total_ms": float, "by_kernel": {name: ms}, "events": int}``, the
    sum of the trace's CUDA kernel events.  Returns total_ms = 0.0 with
    ``error`` when the trace holds no device lane (no CUDA activity is
    supported, or no kernel ran): callers fall back to wall time.  The
    trace is written to `trace_dir` (default a temporary directory,
    removed unless `keep`)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    cuda = ProfilerActivity.CUDA in torch.profiler.supported_activities() \
        and torch.cuda.is_available()
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                           if cuda else [])
    tdir = trace_dir or tempfile.mkdtemp(prefix="fs_trace_")
    try:
        with profile(activities=activities) as prof:
            fn()
            if cuda:
                torch.cuda.synchronize()
        path = os.path.join(tdir, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as fh:
            events = json.load(fh).get("traceEvents", [])
        kern = [e for e in events
                if e.get("ph") == "X" and e.get("cat") == "kernel"]
        if not kern:
            return {"total_ms": 0.0, "by_kernel": {}, "events": 0,
                    "error": "no CUDA kernel in the trace" if cuda
                    else "no device lane (CUDA profiling unavailable)"}
        agg: dict = defaultdict(float)
        for e in kern:
            agg[e["name"]] += e.get("dur", 0) / 1e3
        return {"total_ms": sum(agg.values()), "by_kernel": dict(agg),
                "events": len(kern)}
    finally:
        if not keep and trace_dir is None:
            shutil.rmtree(tdir, ignore_errors=True)


def top_kernels(prof: dict, k: int = 10) -> list[tuple[str, float]]:
    """The k most expensive kernels of a device_time_ms result."""
    return sorted(prof.get("by_kernel", {}).items(),
                  key=lambda kv: -kv[1])[:k]
