"""Pieces the drivers share at run time: the card's name and power limit,
the program's registry read around a window, and freeing the program's
memory before the reference runs."""

from __future__ import annotations

import gc
import subprocess
from typing import Dict, Iterable


def card_line(torch, device) -> str:
    """The card's name and power limit, as nvidia-smi reads them."""
    if device.type != "cuda":
        return "cpu"
    try:
        out = subprocess.run(
            ["nvidia-smi", f"--id={device.index or 0}",
             "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30, check=True)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return torch.cuda.get_device_name(device) + ", power limit not read"


def histograms(names: Iterable[str]) -> Dict[str, tuple]:
    """{name: (count, sum)} of the program's registry histograms now."""
    from deeplearning4j_tpu_torch.utils.metrics import get_registry

    reg = get_registry()
    out = {}
    for n in names:
        fam = reg.get(n)
        if fam is not None:
            ch = fam.labels()
            out[n] = (ch.count, ch.sum)
        else:
            out[n] = (0, 0.0)
    return out


def delta(before: Dict[str, tuple], after: Dict[str, tuple]) -> Dict[str, tuple]:
    return {n: (after[n][0] - before[n][0], after[n][1] - before[n][1]) for n in after}


def sync(torch, device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def memory_peak(torch, device) -> int:
    """The process's peak of allocated device memory so far (host runs: 0)."""
    return int(torch.cuda.max_memory_allocated(device)) if device.type == "cuda" else 0


def release(torch, device) -> None:
    gc.collect()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()
