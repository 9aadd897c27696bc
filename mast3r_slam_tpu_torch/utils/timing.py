"""Per-stage wall-clock timing (port of ``mast3r_slam_tpu/utils/timing.py``).

Host clock only: CUDA work is asynchronous, so a stage's time covers its
device work only where the stage itself waits for the device (a tracked
frame ends in its stats read).
"""

from __future__ import annotations

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

    @contextmanager
    def time(self, name: str):
        t0 = time.perf_counter()
        yield
        dt = time.perf_counter() - t0
        buf = self.samples[name]
        buf.append(dt)
        if len(buf) > self.window:
            del buf[: len(buf) - self.window]

    def stats(self) -> Dict[str, Dict[str, float]]:
        out = {}
        for name, buf in self.samples.items():
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
