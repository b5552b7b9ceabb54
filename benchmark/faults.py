"""Faults planted in the program underneath a run, for the tests and the
readings that set the limits (calibrate.py); a benchmark run never plants
one.

- `unchanged`: every optimizer step returns the parameters and the
  updater state as they were (the updater applies nothing).
- `half_batch`: the loss is the mean over the first half of the batch's
  rows only, the rest left out.
- `frozen_capture`: every replay of a fused program's CUDA graph reads
  the batches its capture read: the static input buffers are written
  back to the capture's before each replay (a buffer frozen at capture).
  On the card only: the CPU runs no graph.

`plant(name)` is a context manager that patches the port's modules and
restores them on exit.
"""

from __future__ import annotations

import contextlib

FAULTS = ("unchanged", "half_batch", "frozen_capture")


@contextlib.contextmanager
def plant(name: str):
    if name not in FAULTS:
        raise ValueError(f"unknown fault {name!r}; known: {FAULTS}")
    undo = []

    def patch(obj, attr, value):
        undo.append((obj, attr, getattr(obj, attr)))
        setattr(obj, attr, value)

    if name == "unchanged":
        from deeplearning4j_tpu_torch.train import updaters

        patch(updaters.UpdaterDef, "step_",
              lambda self, params, grads, state, lr_tree, t: [])
    elif name == "half_batch":
        from deeplearning4j_tpu_torch.nn import compgraph, multilayer

        def half_mean(per_ex, mask=None):
            return per_ex[: max(1, per_ex.shape[0] // 2)].mean()

        patch(compgraph, "masked_example_mean", half_mean)
        patch(multilayer, "masked_example_mean", half_mean)
    else:
        from deeplearning4j_tpu_torch.nn import netbase

        orig = netbase.NetworkBase._graph_dispatch
        frozen = {}

        def frozen_dispatch(self, prog, run):
            data = list(netbase._tensor_leaves(prog.io["data"]))
            if prog.graph is None and prog.warm:  # this call captures
                frozen[id(prog)] = [t.clone() for t in data]
            elif prog.graph is not None and id(prog) in frozen:
                for dst, src in zip(data, frozen[id(prog)]):
                    dst.copy_(src)
            return orig(self, prog, run)

        patch(netbase.NetworkBase, "_graph_dispatch", frozen_dispatch)
    try:
        yield
    finally:
        for obj, attr, value in reversed(undo):
            setattr(obj, attr, value)
