"""REST k-NN server over a VPTree (reference:
nearestneighbor/server/NearestNeighborsServer.java:29,70 — loads a stored
points NDArray, builds a VPTree with --similarityFunction/--invert, and
serves POST /knn with {"k": int, "inputIndex": int} ->
{"results": [{"index": i}, ...]}; DTOs in nearestneighbor/model/).

Extensions beyond the reference API (same shape, additive):
- POST /knnvector {"k": int, "vector": [floats]} — query by raw vector
  instead of stored-point index.
- GET /health — liveness.
Distances are included in each result row (the reference computes them
but only returns indices). The port of the JAX package's
serving/knnserver.py: the same routes, JSON and flags; the flat search
path runs on `device` ("cuda" when None; `--device cpu` on the CLI).
"""

from __future__ import annotations

import argparse
import json
import logging

import numpy as np

from deeplearning4j_tpu_torch.clustering.vptree import VPTree
from deeplearning4j_tpu_torch.utils.jsonhttp import JsonHttpServer, json_response

logger = logging.getLogger("deeplearning4j_tpu_torch")


class NearestNeighborsServer:
    def __init__(self, points: np.ndarray,
                 similarity_function: str = "euclidean",
                 invert: bool = False, port: int = 9000, device=None):
        self.points = np.asarray(points, np.float32)
        self.tree = VPTree(self.points, similarity_function, invert,
                           device=device)
        self._server = JsonHttpServer(get=self._get, post=self._post,
                                      port=port)

    @property
    def port(self) -> int:
        return self._server.port

    # -- request handling ---------------------------------------------------

    def _get(self, path, body, headers):
        if path == "/health":
            return json_response({"status": "ok",
                                  "points": self.points.shape[0]})
        return None

    def _post(self, path, body, headers):
        req = json.loads(body or b"{}")
        if path == "/knn":
            k = int(req["k"])
            idx = int(req["inputIndex"])
            if not (0 <= idx < self.points.shape[0]):
                return json_response(
                    {"error": f"inputIndex {idx} out of range"}, 400)
            target = self.points[idx]
        elif path == "/knnvector":
            k = int(req["k"])
            target = np.asarray(req["vector"], np.float32)
            if target.shape != (self.points.shape[1],):
                return json_response(
                    {"error":
                     f"vector must have dim {self.points.shape[1]}"}, 400)
        else:
            return None
        indices, distances = self.tree.search(target, k)
        return json_response({
            "results": [
                {"index": int(i), "distance": float(d)}
                for i, d in zip(indices, distances)
            ]
        })

    # -- lifecycle ----------------------------------------------------------

    def start(self) -> int:
        return self._server.start()

    def stop(self):
        self._server.stop()

    def join(self):
        self._server.join()


def main(argv=None):
    """CLI matching the reference's flags (NearestNeighborsServer.java):
    --ndarrayPath (a .npy file), --nearestNeighborsPort,
    --similarityFunction, --invert; and --device (the flat path's device,
    "cuda" when not given)."""
    ap = argparse.ArgumentParser(description="k-NN REST server")
    ap.add_argument("--ndarrayPath", required=True)
    ap.add_argument("--nearestNeighborsPort", type=int, default=9000)
    ap.add_argument("--similarityFunction", default="euclidean")
    ap.add_argument("--invert", action="store_true")
    ap.add_argument("--device", default=None)
    args = ap.parse_args(argv)
    points = np.load(args.ndarrayPath)
    server = NearestNeighborsServer(points, args.similarityFunction,
                                    args.invert, args.nearestNeighborsPort,
                                    device=args.device)
    # operator surface: opt in to real log output, then announce through
    # the package logger (library code never prints)
    if not logging.getLogger().handlers:
        logging.basicConfig(level=logging.INFO)
    port = server.start()
    logger.info("nearest-neighbors server listening on :%d", port)
    try:
        server.join()
    except KeyboardInterrupt:
        server.stop()


if __name__ == "__main__":
    main()
