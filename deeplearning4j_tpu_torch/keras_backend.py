"""Keras-backend entry point (reference: deeplearning4j-keras, 452 LoC —
a py4j GatewayServer exposing DeepLearning4jEntryPoint.fit(), with batch
data handed over as HDF5 files; DeepLearning4jEntryPoint.java:22-41).

Shape: the frontend language IS Python here, so the gateway degenerates
to (a) a direct function — fit_from_keras_config — and (b) an HTTP entry
point for out-of-process frontends, accepting the same payload the
reference took over py4j: a Keras 1.x model-config JSON plus feature/
label arrays (npy paths or HDF5 datasets). The port of the JAX package's
keras_backend.py: the network trains on `device` ("cuda" when None).
h5py is imported only for an .h5/.hdf5 path."""

from __future__ import annotations

import json
import threading
from typing import Optional

import numpy as np

from deeplearning4j_tpu_torch.common.devices import resolve_device
from deeplearning4j_tpu_torch.utils.jsonhttp import JsonHttpServer, json_response

from deeplearning4j_tpu_torch.modelimport.keras import (
    import_keras_sequential_config,
)
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork


def _load_array(path: str, dataset: Optional[str] = None) -> np.ndarray:
    if path.endswith((".h5", ".hdf5")):
        try:
            import h5py
        except ImportError as e:
            raise ImportError(
                f"reading {path} needs h5py, which is not installed; pass the "
                "arrays as .npy files instead") from e

        with h5py.File(path, "r") as f:
            return np.asarray(f[dataset or "data"])
    return np.load(path)


def fit_from_keras_config(model_config_json: str,
                          features: np.ndarray, labels: np.ndarray,
                          *, training_config_json: Optional[str] = None,
                          batch_size: int = 32, nb_epoch: int = 1,
                          precision: str = "f32", device=None):
    """The EntryPoint.fit analog: build the network from a Keras 1.x
    Sequential config, train, return (net, final_score). Without a
    training_config the loss defaults to categorical crossentropy (the
    reference's entry point always receives a compiled model; a bare
    architecture still has to train here)."""
    if training_config_json is None:
        training_config_json = json.dumps(
            {"loss": "categorical_crossentropy"})
    conf, _ = import_keras_sequential_config(
        model_config_json, training_config_json, precision=precision)
    net = MultiLayerNetwork(conf, device=device).init()
    net.fit(np.asarray(features), np.asarray(labels),
            batch_size=batch_size, epochs=nb_epoch)
    return net, float(net._score)


class KerasBackendServer:
    """POST /fit
    {"model_config": "<keras json>", "features_path": ..., "labels_path":
     ..., "batch_size": 32, "nb_epoch": 1} -> {"score": float}
    The model is retained; POST /evaluate {"features_path", "labels_path"}
    scores it. The networks train on `device` ("cuda" when None)."""

    def __init__(self, port: int = 0, device=None):
        self.device = resolve_device(device)
        self._server = JsonHttpServer(post=self._post, port=port)
        self._net: Optional[MultiLayerNetwork] = None
        self._lock = threading.Lock()

    @property
    def port(self) -> int:
        return self._server.port

    def _post(self, path, body, headers):
        req = json.loads(body)
        if path == "/fit":
            return json_response(self._fit(req))
        if path == "/evaluate":
            return json_response(self._evaluate(req))
        return None

    def _fit(self, body: dict) -> dict:
        x = _load_array(body["features_path"], body.get("features_dataset"))
        y = _load_array(body["labels_path"], body.get("labels_dataset"))
        with self._lock:
            net, score = fit_from_keras_config(
                body["model_config"], x, y,
                training_config_json=body.get("training_config"),
                batch_size=int(body.get("batch_size", 32)),
                nb_epoch=int(body.get("nb_epoch", 1)),
                device=self.device)
            self._net = net
        return {"score": score}

    def _evaluate(self, body: dict) -> dict:
        if self._net is None:
            raise ValueError("no model fitted yet")
        x = _load_array(body["features_path"], body.get("features_dataset"))
        y = _load_array(body["labels_path"], body.get("labels_dataset"))
        with self._lock:
            ev = self._net.evaluate(
                self._make_iter(x, y, int(body.get("batch_size", 128))))
        return {"accuracy": ev.accuracy(), "f1": ev.f1()}

    @staticmethod
    def _make_iter(x, y, batch):
        from deeplearning4j_tpu_torch.data.dataset import DataSet
        from deeplearning4j_tpu_torch.data.iterators import ListDataSetIterator

        return ListDataSetIterator(DataSet(x, y), batch)

    def start(self) -> int:
        return self._server.start()

    def stop(self):
        self._server.stop()
