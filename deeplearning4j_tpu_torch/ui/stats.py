"""StatsListener: per-iteration training telemetry -> storage router.

Reference: BaseStatsListener.java:51,103-124 — collects score,
param/gradient/update mean magnitudes, learning rate, memory and
throughput counters each iteration and routes them through a
StatsStorageRouter; cadence controlled by StatsUpdateConfiguration.

The mean-magnitude reductions ride inside the train step
(net.set_collect_stats(True) — nn/netbase exposes them via
info["stats"]) so collection adds small device reductions instead of
host-side parameter sweeps; the host reads them back only every
``frequency`` iterations. The port of the JAX package's ui/stats.py, with
the same records; each report reads its mean magnitudes back in one copy
(the 0-d tensors stacked) and its histograms in one more (the leaves
concatenated), where a read per leaf would sync the device once for each
of ResNet-50's 161 parameter leaves and each group.
"""

from __future__ import annotations

import time
import uuid
from typing import Optional

import numpy as np
import torch

from deeplearning4j_tpu_torch.train.listeners import IterationListener
from deeplearning4j_tpu_torch.ui.storage import StatsStorageRouter

_MM_GROUPS = ("grad_mm", "update_mm", "param_mm")


def _device_memory_stats() -> dict:
    """Per-device memory counters of the CUDA caching allocator, under the
    JAX package's keys (`device{i}` -> bytes_in_use / bytes_limit); the CPU
    reports nothing, as in the JAX package. Reference reports JVM/off-heap
    memory per device (BaseStatsListener memory section)."""
    out = {}
    if not torch.cuda.is_available() or not torch.cuda.is_initialized():
        return out
    try:
        for i in range(torch.cuda.device_count()):
            ms = torch.cuda.memory_stats(i)
            out[f"device{i}"] = {
                "bytes_in_use": int(ms.get("allocated_bytes.all.current", 0)),
                "bytes_limit": int(torch.cuda.get_device_properties(i).total_memory),
            }
    except Exception:
        pass
    return out


def split_stat_key(key: str):
    """Decode the '{layer_index}_{param_name}' keys StatsListener emits in
    grad_mm/update_mm/param_mm/hists records — the ONE place the format is
    known (consumers: ui/server.py, ui/report.py)."""
    li, _, pname = key.partition("_")
    return li, pname


def model_graph(model) -> dict:
    """Topology for the flow view (reference: FlowListenerModule's
    layer-graph payload): {nodes: [{id, label, layer_index?}], edges:
    [[src, dst], ...]}. ComputationGraphs expose their DAG; a
    MultiLayerNetwork is the input->layer0->...->layerN chain."""
    conf = getattr(model, "conf", None)
    confs = model._ordered_layer_confs()
    if hasattr(conf, "vertex_inputs"):  # ComputationGraph
        pidx = getattr(model, "_pidx", {})
        nodes = [{"id": n, "label": n} for n in conf.inputs]
        for name, v in conf.vertices.items():
            layer = getattr(v, "layer", None)
            nodes.append({
                "id": name,
                "label": f"{name}\n{type(layer or v).__name__}",
                **({"layer_index": pidx[name]} if name in pidx else {}),
            })
        edges = [[src, name]
                 for name, ins in conf.vertex_inputs.items()
                 for src in ins]
        return {"nodes": nodes, "edges": edges,
                "outputs": list(conf.outputs)}
    nodes = [{"id": "input", "label": "input"}]
    edges = []
    prev = "input"
    for i, c in enumerate(confs):
        nid = f"layer{i}"
        nodes.append({"id": nid, "label": f"{i}: {type(c).__name__}",
                      "layer_index": i})
        edges.append([prev, nid])
        prev = nid
    return {"nodes": nodes, "edges": edges, "outputs": [prev]}


def _device_name(device: torch.device) -> str:
    if device.type == "cuda":
        return torch.cuda.get_device_name(device)
    return device.type


def _host_leaves(tensors) -> list:
    """Every tensor of `tensors` on the host, through one device-to-host
    copy of their flattened concatenation (in f32)."""
    if not tensors:
        return []
    flat = torch.cat([t.detach().reshape(-1).to(torch.float32) for t in tensors]).cpu().numpy()
    out, off = [], 0
    for t in tensors:
        n = t.numel()
        out.append(flat[off:off + n])
        off += n
    return out


class StatsListener(IterationListener):
    """Routes per-iteration stats to a StatsStorageRouter.

    Usage::

        storage = InMemoryStatsStorage()
        net.set_collect_stats(True)
        net.set_listeners(StatsListener(storage))
        net.fit(...)
        UIServer(storage).start()
    """

    def __init__(self, router: StatsStorageRouter,
                 session_id: Optional[str] = None,
                 worker_id: str = "worker0",
                 frequency: int = 1,
                 report_memory: bool = True,
                 histogram_bins: int = 0,
                 histogram_frequency: int = 10):
        self.router = router
        self.session_id = session_id or f"session-{uuid.uuid4().hex[:8]}"
        self.worker_id = worker_id
        self.frequency = max(1, int(frequency))
        self.report_memory = report_memory
        # >0 turns on per-layer parameter histograms (reference:
        # HistogramModule / weights histogram tab). Histograms force a
        # full-parameter device readback, so they ride every
        # `histogram_frequency`-th REPORT (i.e. every
        # frequency * histogram_frequency iterations).
        self.histogram_bins = int(histogram_bins)
        self.histogram_frequency = max(1, int(histogram_frequency))
        self._reports = 0
        self._sent_static = False
        self._last_time: Optional[float] = None
        self._samples_since = 0
        # watchdog transition cursor (utils/health): degradation history
        # rides the session's main record stream, so the dashboard can
        # show WHEN a component stalled, not just its current gauge
        from deeplearning4j_tpu_torch.utils.health import get_health

        self._health = get_health()
        self._health_seq = self._health.last_seq()

    # -- static info (once per session) --------------------------------------

    def _send_static(self, model):
        confs = model._ordered_layer_confs()
        layers = [
            {"index": i, "type": type(c).__name__,
             "n_params": int(sum(v.numel() for v in p.values()))}
            for i, (c, p) in enumerate(zip(confs, model.params_list))
        ]
        dev = torch.device(model.device)
        self.router.put_static_info(self.session_id, {
            "model_class": type(model).__name__,
            "backend": dev.type,
            "device": _device_name(dev),
            "n_devices": torch.cuda.device_count() if dev.type == "cuda" else 1,
            "start_time": time.time(),
            "layers": layers,
            "total_params": int(sum(l["n_params"] for l in layers)),
            "graph": model_graph(model),
        })
        self._sent_static = True

    # -- per iteration --------------------------------------------------------

    def iteration_done(self, model, iteration, info):
        if not self._sent_static:
            self._send_static(model)
        now = time.perf_counter()
        self._samples_since += info.get("batch_size", 0)
        if iteration % self.frequency != 0:
            return
        sps = 0.0
        if self._last_time is not None and now > self._last_time:
            sps = self._samples_since / (now - self._last_time)
        self._last_time = now
        self._samples_since = 0

        rec = {
            "iteration": int(iteration),
            "ts": time.time(),
            "epoch": int(model.epoch),
            "score": float(info["score"]()),
            "etl_ms": float(info.get("etl_ms", 0.0)),
            "samples_per_sec": float(sps),
            "worker": 0,
        }
        stats = info.get("stats", lambda: None)()
        if stats is not None:
            keys, vals = [], []
            for group in _MM_GROUPS:
                for li, layer in enumerate(stats[group]):
                    for pname, v in layer.items():
                        keys.append((group, f"{li}_{pname}"))
                        vals.append(v.reshape(()).to(torch.float32))
            host = torch.stack(vals).cpu().tolist() if vals else []
            for group in _MM_GROUPS:
                rec[group] = {}
            for (group, key), v in zip(keys, host):
                rec[group][key] = v
        if self.report_memory:
            mem = _device_memory_stats()
            if mem:
                rec["memory"] = mem
        new_tr = self._health.transitions_since(self._health_seq)
        if new_tr:
            from deeplearning4j_tpu_torch.utils.health import LEVELS

            self._health_seq = max(t["seq"] for t in new_tr)
            rec["health_transitions"] = new_tr
            rec["health_level"] = {t["component"]: LEVELS[t["to"]]
                                   for t in new_tr}
        self._reports += 1
        if (self.histogram_bins > 0
                and (self._reports - 1) % self.histogram_frequency == 0):
            names = [f"{li}_{pname}" for li, p in enumerate(model.params_list)
                     for pname in p]
            leaves = _host_leaves([v for p in model.params_list for v in p.values()])
            hists = {}
            for name, flat in zip(names, leaves):
                counts, edges = np.histogram(flat, bins=self.histogram_bins)
                hists[name] = {
                    "edges": [float(e) for e in edges],
                    "counts": [int(c) for c in counts],
                }
            rec["hists"] = hists
        self.router.put_update(self.session_id, rec)


class ConvolutionalIterationListener(IterationListener):
    """Streams a grid of first-conv-layer activation maps for the first
    example of the current batch (reference: ConvolutionalIterationListener
    + ConvolutionalListenerModule's /activations page). Stored as plain
    nested lists in the stats stream (record key "activations"); the UI
    renders them as canvas heatmaps — no image encoding dependency. The
    port's activations are NHWC, as the JAX package's are: the grid is
    [H, W, C] as it comes."""

    def __init__(self, router: StatsStorageRouter, session_id: str,
                 frequency: int = 10, max_channels: int = 12,
                 max_hw: int = 24):
        self.router = router
        self.session_id = session_id
        self.frequency = max(1, int(frequency))
        self.max_channels = int(max_channels)
        self.max_hw = int(max_hw)

    def iteration_done(self, model, iteration, info):
        if iteration % self.frequency != 0:
            return
        ds = info.get("batch", lambda: None)()
        confs = getattr(model, "layer_confs", None)
        if ds is None or confs is None:  # ComputationGraph: not wired yet
            return
        from deeplearning4j_tpu_torch.nn.conf.layers import ConvolutionLayer

        ci = next((i for i, c in enumerate(confs)
                   if isinstance(c, ConvolutionLayer)), None)
        if ci is None:
            return
        x = model.policy.cast_input(model._as_data(ds.features[:1]))
        with torch.no_grad():
            acts, _ = model._forward(model.params_list, model.state_list,
                                     x, training=False, rng=None,
                                     to_layer=ci + 1)
        a = acts.to(torch.float32).cpu().numpy()[0]  # [H, W, C]
        if a.ndim != 3:
            return
        # ceil division: the stride must actually cap output at max_hw
        sh = -(-a.shape[0] // self.max_hw)
        sw = -(-a.shape[1] // self.max_hw)
        a = a[::sh, ::sw, : self.max_channels]
        lo, hi = float(a.min()), float(a.max())
        a = (a - lo) / max(hi - lo, 1e-9)
        self.router.put_update(self.session_id, {
            "iteration": int(iteration),
            "ts": time.time(),
            "activations": {
                "layer": int(ci),
                "channels": [a[:, :, c].round(3).tolist()
                             for c in range(a.shape[-1])],
            },
        })
