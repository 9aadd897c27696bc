"""Per-stage wall-clock timing (port of ``mast3r_slam_tpu/utils/timing.py``).

``StageTimer`` reads the host clock only: CUDA work is asynchronous, so a
stage's time covers its device work only where the stage itself waits for
the device (a tracked frame ends in its stats read).  The engine's frontend
and its backend thread time their stages into one timer, so it takes a lock
around its buffers.  ``device_ms`` reads the card's own kernel durations
and raises where the profiler lost them.
"""

from __future__ import annotations

import threading
import time
from collections import defaultdict
from contextlib import contextmanager
from typing import Dict

import numpy as np


class StageTimer:
    """Accumulates wall time per named stage in bounded windows."""

    def __init__(self, window: int = 120):
        self.window = window
        self.samples: Dict[str, list] = defaultdict(list)
        self._lock = threading.Lock()

    @contextmanager
    def time(self, name: str):
        t0 = time.perf_counter()
        yield
        dt = time.perf_counter() - t0
        with self._lock:
            buf = self.samples[name]
            buf.append(dt)
            if len(buf) > self.window:
                del buf[: len(buf) - self.window]

    def stats(self) -> Dict[str, Dict[str, float]]:
        with self._lock:
            bufs = {name: list(buf) for name, buf in self.samples.items()}
        out = {}
        for name, buf in bufs.items():
            if not buf:
                continue
            arr = np.asarray(buf)
            p50 = float(np.percentile(arr, 50) * 1e3)
            p95 = float(np.percentile(arr, 95) * 1e3)
            out[name] = {
                "mean_ms": float(arr.mean() * 1e3),
                "p50_ms": p50,
                "p95_ms": p95,
                "jitter_ms": p95 - p50,
                "count": int(len(arr)),
            }
        return out


def device_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Device milliseconds per call of ``fn`` on the CUDA card: the summed
    durations of every kernel its ``iters`` calls launched, from
    torch.profiler (CUPTI), so that a kernel shorter than its launch is not
    timed at the rate the host can launch it.

    Every call launches at least one kernel, so a trace with fewer kernel
    records than calls has lost some (seen on an H100: now and then a
    trace holds no record of a kernel launched from a ctypes library); it
    is taken again, and after ten such traces this raises rather than read
    low."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    seen = []
    for _ in range(10):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
        if len(kernels) >= iters:
            return sum(e.time_range.elapsed_us() for e in kernels) / 1e3 / iters
        seen.append(len(kernels))
    raise RuntimeError(f"device_ms: the profiler recorded {seen} kernels over {iters} "
                       f"calls in ten traces; the device time cannot be read")
