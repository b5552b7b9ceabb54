"""Kernel launch counts, shared by the kernel wrappers' modules.

Each module keeps one `LaunchCounter` over the names of its wrappers and
exports its methods as `launch_counts`, `reset_launch_counts`,
`recording_launches`, `add_launches` and `_bump`. A launch adds one to
its wrapper's count; while a CUDA graph captures, launches go into the
capture's tally instead, which the graph's owner adds back on every
replay, so the counts stay counts of launches.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Dict, Iterable

import torch


class LaunchCounter:
    def __init__(self, names: Iterable[str]):
        self._lock = threading.Lock()
        self._counts: Dict[str, int] = {n: 0 for n in names}
        # a thread's tally while a CUDA graph captures, and the tallies of
        # the streams being captured (see `recording_launches`)
        self._recording = threading.local()
        self._stream_tallies: Dict[int, Dict[str, int]] = {}

    def launch_counts(self) -> Dict[str, int]:
        """Kernel launches per wrapper since the last reset."""
        with self._lock:
            return dict(self._counts)

    def reset_launch_counts(self) -> None:
        with self._lock:
            for k in self._counts:
                self._counts[k] = 0

    def bump(self, name: str) -> None:
        tally = getattr(self._recording, "tally", None)
        if tally is None and self._stream_tallies:
            tally = self._stream_tallies.get(torch.cuda.current_stream().cuda_stream)
        if tally is not None:
            tally[name] = tally.get(name, 0) + 1
            return
        with self._lock:
            self._counts[name] += 1

    @contextlib.contextmanager
    def recording_launches(self, stream=None):
        """While a CUDA graph captures on this thread, the wrappers' launches
        go into the yielded dict (name -> launches) instead of the counts: a
        capture records its kernels and launches none. With the capture's
        `stream`, launches any thread makes on that stream are recorded too:
        a captured backward runs on the autograd engine's thread. The graph's
        owner adds the tally with `add_launches` on every replay, so
        `launch_counts()` stays a count of launches."""
        prev = getattr(self._recording, "tally", None)
        self._recording.tally = tally = {}
        if stream is not None:
            self._stream_tallies[stream.cuda_stream] = tally
        try:
            yield tally
        finally:
            self._recording.tally = prev
            if stream is not None:
                self._stream_tallies.pop(stream.cuda_stream, None)

    def add_launches(self, tally: Dict[str, int]) -> None:
        """Add a recorded tally to the counts: one replay of a captured graph."""
        with self._lock:
            for name, n in tally.items():
                self._counts[name] += n
