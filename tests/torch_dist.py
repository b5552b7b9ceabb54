"""Run a function on R gloo processes on the CPU, for the port's
multi-process tests.

`run_ranks(fn, world, *args)` spawns `world` processes (the `spawn`
start method), each joining one gloo process group through a file store
with `init_process_group(timeout=...)`, runs `fn(rank, world, *args)`
there and returns every rank's result (a picklable value) in rank order.
Every join is bounded: a rank that fails makes the call raise with its
traceback, and ranks still running at the deadline are killed and the
call raises, so a hung rank fails its test instead of stalling the run.
`once(tmp_path_factory, key, compute)` runs `compute()` once a test
session, whatever the pytest-xdist workers: the first worker to ask
computes under a file lock in the session's shared temp root and pickles
the result; the others wait and load it. A module fixture that spawns
ranks goes through it, so tests of one module spread over several
workers spawn them once.

`fn` must be importable by name from a module that does not import JAX
(tests/torch_parallel_workers.py). With `init=False` the ranks start with
no process group (`fn` joins one itself, as the multi-host entry point
does).
"""

from __future__ import annotations

import datetime
import fcntl
import multiprocessing
import os
import pickle
import shutil
import tempfile
import time
import traceback

GROUP_TIMEOUT = 60.0   # every collective of the group
JOIN_TIMEOUT = 180.0   # the whole run


def _entry(fn, rank, world, tmp, args, threads, init):
    import torch
    import torch.distributed as dist

    torch.set_num_threads(threads)
    out = os.path.join(tmp, f"rank{rank}")
    try:
        if init:
            dist.init_process_group(
                "gloo", init_method="file://" + os.path.join(tmp, "store"),
                rank=rank, world_size=world,
                timeout=datetime.timedelta(seconds=GROUP_TIMEOUT))
        try:
            result = fn(rank, world, *args)
        finally:
            if init:
                dist.destroy_process_group()
        with open(out + ".tmp", "wb") as f:
            pickle.dump(result, f)
        os.replace(out + ".tmp", out + ".pkl")
    except BaseException:
        with open(out + ".err", "w") as f:
            f.write(traceback.format_exc())
        raise SystemExit(1)


def run_ranks(fn, world: int, *args, timeout: float = JOIN_TIMEOUT, threads: int = 1,
              init: bool = True):
    ctx = multiprocessing.get_context("spawn")
    tmp = tempfile.mkdtemp(prefix="dl4j-ranks-")
    procs = [ctx.Process(target=_entry, args=(fn, r, world, tmp, args, threads, init),
                         name=f"rank{r}") for r in range(world)]
    try:
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout
        for p in procs:
            p.join(max(0.0, deadline - time.monotonic()))
        errs = []
        for r, p in enumerate(procs):
            err = os.path.join(tmp, f"rank{r}.err")
            if os.path.exists(err):
                with open(err) as f:
                    errs.append(f"rank {r}:\n{f.read()}")
        hung = [p.name for p in procs if p.is_alive()]
        if errs or hung:
            raise RuntimeError("\n".join(errs + ([f"ranks still running after "
                                                  f"{timeout} s: {hung}"] if hung else [])))
        for r, p in enumerate(procs):
            if p.exitcode != 0:
                raise RuntimeError(f"rank {r} exited with {p.exitcode}")
        results = []
        for r in range(world):
            with open(os.path.join(tmp, f"rank{r}.pkl"), "rb") as f:
                results.append(pickle.load(f))
        return results
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(10)
        shutil.rmtree(tmp, ignore_errors=True)


def once(tmp_path_factory, key: str, compute):
    base = tmp_path_factory.getbasetemp()
    root = base.parent if base.name.startswith("popen-gw") else base
    path = os.path.join(str(root), f"once-{key}.pkl")
    with open(path + ".lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            if os.path.exists(path):
                with open(path, "rb") as f:
                    return pickle.load(f)
            result = compute()
            with open(path + ".tmp", "wb") as f:
                pickle.dump(result, f)
            os.replace(path + ".tmp", path)
            return result
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)
