"""Model serialization — save/restore networks with updater state.

The port of the JAX package's utils/model_serializer.py (reference:
util/ModelSerializer.java :40,79-118). A zip of

  configuration.json  — the full config DSL JSON (the compat surface)
  meta.json           — network type tag, format version, iteration/epoch
  coefficients.bin    — the flattened parameter vector, little-endian, in
                        the nn/params.py order
  layerState.npz      — non-trainable layer state (BN running stats)
  updaterState.npz    — the updater state
  trainState.json     — mid-epoch resume coordinates (checkpoints only)
  manifest.json       — per-entry SHA-256 digests, written last

with the same entries, bytes and leaf order as the JAX writer, so a zip
written by either package loads in the other. The `.npz` members are one
array per leaf, named `leaf00000`, ... in `jax.tree_util`'s leaf order:
dict keys sorted at every level, `None` an empty subtree, lists in order
(`tree_leaves` below). Version-1 zips (flat f32 `layerState.bin` /
`updaterState.bin`) still load.

The port's optimizer step updates parameters and updater state IN PLACE
(train/updaters.py `UpdaterDef.step_`). The JAX package's snapshot holds
references, which is a consistent snapshot there only because jax arrays
are immutable. Here `ModelSnapshot.capture` therefore COPIES every leaf
(a device-side clone ordered on the current stream after the step, plus
a CUDA event), and `write` waits on that event before any host read: a
checkpoint serialised while later steps run holds the state of the step
it was captured at. Any updater that mutates parameters must keep this
rule.
"""

from __future__ import annotations

import hashlib
import io
import json
import os
import zipfile
from typing import List, Optional, Union

import numpy as np
import torch

from deeplearning4j_tpu_torch.common.devices import resolve_device

FORMAT_VERSION = 2

_CONFIG_JSON = "configuration.json"
_COEFFICIENTS = "coefficients.bin"
_UPDATER_STATE = "updaterState.bin"
_LAYER_STATE = "layerState.bin"
_UPDATER_STATE_NPZ = "updaterState.npz"
_LAYER_STATE_NPZ = "layerState.npz"
_META = "meta.json"
_TRAIN_STATE = "trainState.json"
# per-entry SHA-256 digests, written LAST so it covers every other entry
# — the integrity manifest restore paths verify before trusting a
# checkpoint
_MANIFEST = "manifest.json"

_NUMPY_DTYPES = {
    torch.float16: np.float16, torch.float32: np.float32,
    torch.float64: np.float64, torch.int32: np.int32, torch.int64: np.int64,
    torch.uint8: np.uint8, torch.bool: np.bool_,
}


# -- pytree leaf order (jax.tree_util's, without jax) -------------------------

def tree_leaves(tree) -> List:
    """The leaves of a nested list/tuple/dict structure in
    `jax.tree_util.tree_leaves` order: dict keys sorted at every level,
    `None` contributes no leaf, lists and tuples in order."""
    out: List = []

    def walk(node):
        if node is None:
            return
        if isinstance(node, dict):
            for k in sorted(node):
                walk(node[k])
        elif isinstance(node, (list, tuple)):
            for v in node:
                walk(v)
        else:
            out.append(node)

    walk(tree)
    return out


def tree_map(fn, tree):
    """`tree` with every leaf replaced by `fn(leaf)`; the structure (and
    each dict's own key order) is kept."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return fn(tree)


def _tree_unflatten(template, leaves: List):
    """Rebuild `template`'s structure from `leaves` in tree_leaves order."""
    it = iter(leaves)

    def rebuild(node):
        if node is None:
            return None
        if isinstance(node, dict):
            vals = {k: rebuild(node[k]) for k in sorted(node)}
            return {k: vals[k] for k in node}
        if isinstance(node, (list, tuple)):
            return type(node)(rebuild(v) for v in node)
        return next(it)

    return rebuild(template)


def _numpy_dtype(t: torch.Tensor):
    dt = _NUMPY_DTYPES.get(t.dtype)
    if dt is None:
        raise TypeError(f"no npz dtype for a {t.dtype} leaf")
    return np.dtype(dt)


def _tree_to_npz_bytes(tree) -> bytes:
    """Serialize a tree's leaves at their NATIVE dtype/shape (the npz is
    the per-leaf manifest: a shape/dtype mismatch on load is an error, not
    a silent cast)."""
    arrays = {f"leaf{i:05d}": l.detach().cpu().numpy()
              for i, l in enumerate(tree_leaves(tree))}
    buf = io.BytesIO()
    np.savez(buf, **arrays)
    return buf.getvalue()


def _tree_from_npz_bytes(template, data: bytes):
    leaves = tree_leaves(template)
    with np.load(io.BytesIO(data)) as npz:
        keys = sorted(npz.files)
        if len(keys) != len(leaves):
            raise ValueError(
                f"saved state has {len(keys)} leaves, this "
                f"configuration/updater expects {len(leaves)} — file does "
                "not match")
        out = []
        for key, tmpl in zip(keys, leaves):
            arr = npz[key]
            if tuple(arr.shape) != tuple(tmpl.shape):
                raise ValueError(
                    f"saved leaf {key} shape {arr.shape} != expected "
                    f"{tuple(tmpl.shape)} — leaf-order drift or wrong file")
            if arr.dtype != _numpy_dtype(tmpl):
                raise ValueError(
                    f"saved leaf {key} dtype {arr.dtype} != expected "
                    f"{_numpy_dtype(tmpl)} — leaf-order drift or wrong file")
            out.append(torch.from_numpy(arr).to(tmpl.device))
    return _tree_unflatten(template, out)


def _unflatten_tree(template, vec: np.ndarray):
    """v1 compat: scatter a flat f32 vector into template's structure."""
    out = []
    off = 0
    for l in tree_leaves(template):
        n = l.numel()
        out.append(torch.from_numpy(
            vec[off: off + n].reshape(tuple(l.shape)).astype(_numpy_dtype(l)))
            .to(l.device))
        off += n
    if off != vec.size:
        raise ValueError(
            f"state vector length {vec.size} != expected {off} — saved file "
            "does not match this configuration/updater")
    return _tree_unflatten(template, out)


class ConfigMismatchError(ValueError):
    """A checkpoint was written from a DIFFERENT configuration than the
    net it is being restored into. Its own type: the corruption-fallback
    restore loop re-raises it (a changed architecture is a user error
    every candidate repeats), while bit-rot and load failures fall
    through to the previous candidate."""


class ModelSnapshot:
    """Point-in-time capture of everything a model zip holds, split so
    async checkpointing can separate the two costs. `capture()` runs on
    the fit thread: it clones every parameter, layer-state and updater
    leaf on its device (asynchronous launches on the current stream, so
    they read the state the step just left) and records a CUDA event
    after them; it reads nothing back to the host. `write()` runs on the
    checkpoint writer: it waits on that event, then does the
    device-to-host copies, flattening, compression and zip IO. The clone
    is what makes the capture a snapshot: the next optimizer step
    updates the live tensors in place. The synchronous save path runs
    both back to back — same bytes either way."""

    __slots__ = ("conf_json", "network_type", "iteration", "epoch",
                 "save_updater", "layer_confs", "params_list",
                 "state_list", "upd_state", "train_state", "ready")

    @classmethod
    def capture(cls, net, save_updater: bool = True,
                train_state: Optional[dict] = None) -> "ModelSnapshot":
        net._require_init()
        snap = cls()
        snap.conf_json = net.conf.to_json()
        snap.network_type = type(net).__name__
        snap.iteration = int(net.iteration)
        snap.epoch = int(net.epoch)
        snap.save_updater = bool(save_updater)
        snap.layer_confs = list(net._ordered_layer_confs())
        with torch.no_grad():
            clone = lambda t: t.detach().clone()  # noqa: E731
            # a tensor-parallel net's global values (gathered slices)
            params_list, upd_state = net._global_params()
            snap.params_list = tree_map(clone, list(params_list))
            snap.state_list = tree_map(clone, list(net.state_list))
            snap.upd_state = (tree_map(clone, upd_state)
                              if save_updater else None)
        snap.ready = None
        if getattr(net, "device", None) is not None and net.device.type == "cuda":
            snap.ready = torch.cuda.Event()
            snap.ready.record(torch.cuda.current_stream(net.device))
        snap.train_state = train_state
        return snap

    def write(self, path: Union[str, os.PathLike]) -> None:
        from deeplearning4j_tpu_torch.nn.params import params_to_flat

        if self.ready is not None:
            self.ready.synchronize()
        coeffs = params_to_flat(self.layer_confs,
                                self.params_list).detach().cpu().numpy()
        meta = {
            "format_version": FORMAT_VERSION,
            "network_type": self.network_type,
            "iteration": self.iteration,
            "epoch": self.epoch,
            "save_updater": self.save_updater,
            "coefficients_dtype": coeffs.dtype.str,  # e.g. "<f4", "<f8"
        }
        with zipfile.ZipFile(path, "w", zipfile.ZIP_DEFLATED) as zf:
            digests = {}

            def put(name: str, data):
                # digest the exact bytes the entry stores — the integrity
                # manifest verify_checkpoint() checks on load
                if isinstance(data, str):
                    data = data.encode("utf-8")
                digests[name] = hashlib.sha256(data).hexdigest()
                zf.writestr(name, data)

            put(_CONFIG_JSON, self.conf_json)
            put(_META, json.dumps(meta, indent=2))
            put(_COEFFICIENTS,
                coeffs.astype(coeffs.dtype.newbyteorder("<")).tobytes())
            put(_LAYER_STATE_NPZ, _tree_to_npz_bytes(self.state_list))
            if self.save_updater:
                put(_UPDATER_STATE_NPZ, _tree_to_npz_bytes(self.upd_state))
            if self.train_state is not None:
                put(_TRAIN_STATE, json.dumps(self.train_state))
            zf.writestr(_MANIFEST, json.dumps(
                {"algorithm": "sha256", "entries": digests}, indent=1))


def save_model(net, path: Union[str, os.PathLike], save_updater: bool = True,
               train_state: Optional[dict] = None) -> None:
    """Write a model zip (reference: ModelSerializer.writeModel :79-118).
    `train_state` (a JSON-safe dict, see NetworkBase.train_state()) rides
    along for mid-epoch resume."""
    ModelSnapshot.capture(net, save_updater, train_state).write(path)


def _read_vec(zf: zipfile.ZipFile, name: str, dtype: str = "<f4") -> Optional[np.ndarray]:
    try:
        data = zf.read(name)
    except KeyError:
        return None
    return np.frombuffer(data, dtype=dtype).copy()


def _read_state(zf: zipfile.ZipFile, npz_name: str, bin_name: str):
    """("npz", bytes) for v2 files, ("vec", ndarray) for v1, or None when
    absent."""
    try:
        return ("npz", zf.read(npz_name))
    except KeyError:
        pass
    vec = _read_vec(zf, bin_name)
    return None if vec is None else ("vec", vec)


def _restore_into(net, meta, coeffs, layer_state, upd) -> None:
    """Put a zip's parameters, layer state, updater state and counters
    into an initialised net, on the net's device."""
    def restore(template, entry):
        kind, payload = entry
        if kind == "npz":
            return _tree_from_npz_bytes(template, payload)
        return _unflatten_tree(template, payload)

    if coeffs is not None:
        net.set_params(coeffs)
    if layer_state is not None and not (
            layer_state[0] == "vec" and layer_state[1].size == 0):
        net.state_list = restore(net.state_list, layer_state)
    if upd is not None and meta.get("save_updater", True):
        net.upd_state = restore(net.upd_state, upd)
    net.iteration = int(meta.get("iteration", 0))
    net.epoch = int(meta.get("epoch", 0))
    # the fused programs' graphs read the tensors just replaced
    net._reset_step_programs()


def load_model(path: Union[str, os.PathLike], load_updater: bool = True, *,
               device="cuda"):
    """Restore a network from a model zip onto `device` ("cuda" by
    default; raises without a GPU unless the caller passes
    device="cpu"); dispatches on the saved config type (reference:
    restoreMultiLayerNetwork/restoreComputationGraph + ModelGuesser)."""
    from deeplearning4j_tpu_torch.nn.compgraph import ComputationGraph
    from deeplearning4j_tpu_torch.nn.conf.graph import ComputationGraphConfiguration
    from deeplearning4j_tpu_torch.nn.conf.network import MultiLayerConfiguration
    from deeplearning4j_tpu_torch.nn.conf.serde import config_from_json
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork

    dev = resolve_device(device)
    with zipfile.ZipFile(path, "r") as zf:
        conf = config_from_json(zf.read(_CONFIG_JSON).decode("utf-8"))
        meta = json.loads(zf.read(_META).decode("utf-8"))
        coeffs = _read_vec(
            zf, _COEFFICIENTS, meta.get("coefficients_dtype", "<f4"))
        layer_state = _read_state(zf, _LAYER_STATE_NPZ, _LAYER_STATE)
        upd = (_read_state(zf, _UPDATER_STATE_NPZ, _UPDATER_STATE)
               if load_updater else None)

    if isinstance(conf, MultiLayerConfiguration):
        net = MultiLayerNetwork(conf, device=dev)
    elif isinstance(conf, ComputationGraphConfiguration):
        net = ComputationGraph(conf, device=dev)
    else:
        raise ValueError(f"unsupported configuration type {type(conf).__name__}")
    net.init()
    _restore_into(net, meta, coeffs, layer_state, upd)
    return net


def guess_and_load_model(path: str, device="cuda"):
    """Load a model file onto `device` ("cuda" by default; raises without
    a GPU unless the caller passes device="cpu"), dispatching on its
    container format (reference: core util/ModelGuesser.java): a Keras
    .h5/.hdf5 archive, a reference-format DL4J zip, or this framework's
    model zip (which alone carries meta.json). The CLI and the inference
    server both load through it (the JAX package keeps it in its cli.py;
    here the server, a lower layer, need not import the CLI)."""
    if path.endswith((".h5", ".hdf5")):
        from deeplearning4j_tpu_torch.modelimport.keras import (
            import_keras_model_and_weights,
        )

        return import_keras_model_and_weights(path, device=device)
    with zipfile.ZipFile(path) as zf:
        names = set(zf.namelist())
        conf = (json.loads(zf.read("configuration.json"))
                if "configuration.json" in names else None)
    # both formats carry configuration.json + coefficients.bin; only this
    # framework's zips have meta.json (utils/model_serializer)
    if "coefficients.bin" in names and "meta.json" not in names:
        from deeplearning4j_tpu_torch.modelimport.dl4j import (
            import_dl4j_computation_graph,
            import_dl4j_multilayer,
        )

        if conf is not None and "networkInputs" in conf:
            return import_dl4j_computation_graph(path, device=device)
        return import_dl4j_multilayer(path, device=device)
    return load_model(path, device=device)


def verify_checkpoint(path: Union[str, os.PathLike]) -> dict:
    """Integrity check of a model/checkpoint zip against its per-entry
    SHA-256 manifest. Returns

        {"ok": bool, "legacy": bool, "algorithm": "sha256"|None,
         "entries": {name: {"status": ..., ...}}}

    Per-entry status: `ok`, `mismatch` (digest differs — a bit flip),
    `unreadable` (the zip layer rejects the entry — torn or CRC-failing
    bytes), `missing` (listed in the manifest, absent from the zip),
    `unlisted` (present but never digested). Zips without a manifest
    report `legacy=True` with `ok=True`. A zip that cannot be opened at
    all reports ok=False with `error`."""
    out = {"ok": True, "legacy": False, "algorithm": None, "entries": {}}
    try:
        with zipfile.ZipFile(path, "r") as zf:
            names = set(zf.namelist())
            if _MANIFEST not in names:
                out["legacy"] = True
                return out
            try:
                man = json.loads(zf.read(_MANIFEST).decode("utf-8"))
            except Exception as e:
                out["ok"] = False
                out["error"] = (f"manifest unreadable: "
                                f"{type(e).__name__}: {e}")
                return out
            out["algorithm"] = man.get("algorithm", "sha256")
            digests = man.get("entries", {})
            for name, want in digests.items():
                if name not in names:
                    out["entries"][name] = {"status": "missing"}
                    out["ok"] = False
                    continue
                try:
                    got = hashlib.sha256(zf.read(name)).hexdigest()
                except Exception as e:
                    out["entries"][name] = {
                        "status": "unreadable",
                        "error": f"{type(e).__name__}: {e}"}
                    out["ok"] = False
                    continue
                if got != want:
                    out["entries"][name] = {
                        "status": "mismatch",
                        "expected": want[:16], "got": got[:16]}
                    out["ok"] = False
                else:
                    out["entries"][name] = {"status": "ok"}
            for name in sorted(names - set(digests) - {_MANIFEST}):
                out["entries"][name] = {"status": "unlisted"}
                out["ok"] = False
    except Exception as e:
        out["ok"] = False
        out["error"] = f"{type(e).__name__}: {e}"
    return out


def read_train_state(path: Union[str, os.PathLike]) -> Optional[dict]:
    """The TrainState dict a checkpoint carries (None for zips written
    without one)."""
    with zipfile.ZipFile(path, "r") as zf:
        try:
            return json.loads(zf.read(_TRAIN_STATE).decode("utf-8"))
        except KeyError:
            return None


def restore_fit_state(net, path: Union[str, os.PathLike],
                      load_updater: bool = True,
                      ignore_lr: bool = False) -> dict:
    """Load a checkpoint zip INTO an existing, configured net, on the
    net's device: params, layer state, updater state, iteration/epoch
    counters. Returns the zip's meta dict with the saved TrainState (or
    None) under "train_state" — the `fit(resume_from=...)` restore path.

    The checkpoint's configuration must match the net's (compared as
    parsed JSON), else ConfigMismatchError. `ignore_lr` exempts
    `net_conf.learning_rate` from the comparison."""
    net._require_init()
    with zipfile.ZipFile(path, "r") as zf:
        meta = json.loads(zf.read(_META).decode("utf-8"))
        saved_conf = json.loads(zf.read(_CONFIG_JSON).decode("utf-8"))
        live_conf = json.loads(net.conf.to_json())
        if ignore_lr:
            for doc in (saved_conf, live_conf):
                nc = doc.get("net_conf")
                if isinstance(nc, dict):
                    nc.pop("learning_rate", None)
        if saved_conf != live_conf:
            raise ConfigMismatchError(
                f"checkpoint {path} was written from a different "
                f"configuration than this {type(net).__name__} — resume "
                "into the matching model, or use load_model() to "
                "reconstruct the saved one")
        coeffs = _read_vec(
            zf, _COEFFICIENTS, meta.get("coefficients_dtype", "<f4"))
        layer_state = _read_state(zf, _LAYER_STATE_NPZ, _LAYER_STATE)
        upd = (_read_state(zf, _UPDATER_STATE_NPZ, _UPDATER_STATE)
               if load_updater else None)
        try:
            train_state = json.loads(zf.read(_TRAIN_STATE).decode("utf-8"))
        except KeyError:
            train_state = None
    _restore_into(net, meta, coeffs, layer_state, upd)
    meta["train_state"] = train_state
    return meta


def restore_multi_layer_network(path, load_updater: bool = True, *,
                                device="cuda"):
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork

    net = load_model(path, load_updater, device=device)
    if not isinstance(net, MultiLayerNetwork):
        raise ValueError(f"{path} holds a {type(net).__name__}, not a MultiLayerNetwork")
    return net


def restore_computation_graph(path, load_updater: bool = True, *,
                              device="cuda"):
    from deeplearning4j_tpu_torch.nn.compgraph import ComputationGraph

    net = load_model(path, load_updater, device=device)
    if not isinstance(net, ComputationGraph):
        raise ValueError(f"{path} holds a {type(net).__name__}, not a ComputationGraph")
    return net
