"""The device trace of a short steady window, and what the per-layer
metrics read from it.

`profile(torch, fn, device)` runs `fn` under torch.profiler with CPU and CUDA
activity and keeps each device event (kernels, copies, memsets, each an
interval on the card) and each host event. From them:

- `busy_s`: the union of the device intervals, so two streams that
  overlap count once; `window_s`: the host clock around `fn`, which ends
  in a synchronize. The idle share is 1 - busy_s / window_s.
- `family_seconds(patterns)`: the summed device time of the kernels
  whose name holds one of `patterns` (the kernel families of families/).
- `top_ops(n)`: the device operations that took most time, by name.
- `idle_gaps(n)`: the longest gaps between busy intervals, each labelled
  with the innermost host event that spans its middle: what the host was
  doing while the card waited.

The CUPTI lazy re-initialisation is off in the run's environment
(run.py): a second profile after CUDA graph replays can otherwise lose
kernels, and the benchmark profiles once a process.
"""

from __future__ import annotations

import re
import time
from typing import List, Sequence, Tuple


def clean_name(name: str) -> str:
    """A kernel's name with its return type, namespaces, template
    arguments and parameters cut (`void ns::k<float>(int)` -> `k`), and a
    library kernel's tile shape (`..._tilesize128x64x64_...`,
    `nvjet_tst_256x128_...`), so that one routine's tile variants add
    up under one name."""
    s = name.replace("void ", "").replace("(anonymous namespace)::", "")
    s = s.split("<")[0].split("(")[0].strip()
    s = s.rsplit("::", 1)[-1] if "::" in s else s
    return re.sub(r"_(tilesize)?\d+x\d+.*$", "", s)


def _merge(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[Tuple[float, float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1] = (out[-1][0], e)
        else:
            out.append((s, e))
    return out


class Trace:
    """Device and host events of one profiled window, times in seconds."""

    def __init__(self, device_events, host_events, window_s: float):
        # [(name, start_s, end_s)]
        self.device_events = device_events
        self.host_events = host_events
        self.window_s = float(window_s)
        self.busy = _merge([(s, e) for _, s, e in device_events])
        self.busy_s = sum(e - s for s, e in self.busy)

    def family_seconds(self, patterns: Sequence[str]) -> float:
        pats = [p.lower() for p in patterns]
        return sum(e - s for n, s, e in self.device_events
                   if any(p in n.lower() for p in pats))

    def top_ops(self, n: int = 10) -> List[list]:
        by: dict = {}
        for name, s, e in self.device_events:
            k = clean_name(name)[:120]
            by[k] = by.get(k, 0.0) + (e - s)
        return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:n]]

    def idle_gaps(self, n: int = 10) -> List[list]:
        gaps = [(self.busy[i][1], self.busy[i + 1][0])
                for i in range(len(self.busy) - 1)]
        gaps.sort(key=lambda g: g[0] - g[1])
        out = []
        for s, e in gaps[:n]:
            mid = 0.5 * (s + e)
            inner = None
            for name, hs, he in self.host_events:
                if hs <= mid <= he and (inner is None or he - hs < inner[2] - inner[1]):
                    inner = (name, hs, he)
            out.append([(inner[0] if inner else "no host event")[:120], e - s])
        return out


def profile(torch, fn, device) -> Trace:
    """Run `fn()` under the profiler and return its Trace. `fn` must leave
    the card idle (synchronize) before it returns."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as _profile

    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
        torch.cuda.synchronize(device)
    with _profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn()
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        window = time.perf_counter() - t0
    dev, host = [], []
    try:
        # the raw events: building the profiler's FunctionEvent tree for a
        # window of graph replays takes tens of seconds
        res = prof.profiler.kineto_results
        for ev in res.events():
            rec = (ev.name(), ev.start_ns() * 1e-9, ev.end_ns() * 1e-9)
            (dev if ev.device_type() == DeviceType.CUDA else host).append(rec)
    except AttributeError:
        for ev in prof.events():
            tr = ev.time_range
            rec = (ev.name, tr.start * 1e-6, tr.end * 1e-6)
            (dev if ev.device_type == DeviceType.CUDA else host).append(rec)
    return Trace(dev, host, window)
