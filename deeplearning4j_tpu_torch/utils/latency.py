"""Latency bookkeeping for serving paths: a bounded, thread-safe window
of recent request latencies with percentile readout (p50/p99 for the
inference server's /metrics). The port of the JAX package's
utils/latency.py. Window semantics — percentiles describe the last
`window` requests, not all time — which is what an operator watching a
live endpoint wants."""

from __future__ import annotations

import threading
from collections import deque


def percentile(sorted_values, q: float) -> float:
    """Nearest-rank percentile (q in [0, 100]) over an ascending list."""
    if not sorted_values:
        return float("nan")
    rank = max(0, min(len(sorted_values) - 1,
                      int(round(q / 100.0 * (len(sorted_values) - 1)))))
    return float(sorted_values[rank])


class LatencyTracker:
    def __init__(self, window: int = 2048):
        self._lock = threading.Lock()
        self._window = deque(maxlen=int(window))
        self._count = 0
        self._total = 0.0

    def record(self, seconds: float):
        with self._lock:
            self._window.append(float(seconds))
            self._count += 1
            self._total += float(seconds)

    @property
    def count(self) -> int:
        with self._lock:
            return self._count

    def percentile_seconds(self, q: float):
        """Nearest-rank percentile over the window, in seconds (None
        until something was recorded). The admission-control estimate in
        parallel/inference reads rolling batch latency through this."""
        with self._lock:
            vals = sorted(self._window)
        return percentile(vals, q) if vals else None

    def snapshot(self) -> dict:
        """{"count", "mean_ms", "p50_ms", "p99_ms"} over the window
        (count/mean are all-time)."""
        with self._lock:
            vals = sorted(self._window)
            count, total = self._count, self._total
        ms = 1e3
        return {
            "count": count,
            "mean_ms": round(total / count * ms, 3) if count else None,
            "p50_ms": round(percentile(vals, 50) * ms, 3) if vals else None,
            "p99_ms": round(percentile(vals, 99) * ms, 3) if vals else None,
        }
