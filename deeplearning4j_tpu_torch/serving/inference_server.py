"""REST model-inference server — the serving front end the reference left
to users (ParallelInference.java was always embedded behind someone's
HTTP layer; here the layer ships with the framework, on the
utils/jsonhttp scaffold). The port of the JAX package's
serving/inference_server.py.

Wraps a MultiLayerNetwork or ComputationGraph in a bucketed, pipelined
ParallelInference (parallel/inference.py — BATCHED mode fuses concurrent
requests, pads each fused group to a fixed bucket so the model's forward
cache holds ~log2(B) entries, and overlaps host batch assembly with
device execution). Routes:

    POST /predict  {"features": [[...], ...], "deadline_ms": 250}
                                                -> {"predictions": [...]}
                   (a single flat example is also accepted and returns a
                    single prediction row; a multi-output graph returns
                    one predictions entry per output head; `deadline_ms`
                    — or an X-Deadline-Ms header — is the request's
                    latency budget: work that cannot make it is SHED
                    with 429 + Retry-After, never served late. 503 is
                    reserved for /health degradation.)
    POST /generate {"prompt": [ids], "max_tokens": n, "stream": false}
                   -> {"tokens": [...], "version": v}, or with
                      "stream": true an NDJSON token stream (the
                      continuous-batching DecodeEngine; 404 unless the
                      server runs with decode slots)
    GET  /health   -> {"status": "ok", "model": ..., "feature_shape": ...}
    GET  /metrics  -> {"requests", "examples", "batches", "queue_depth",
                       "buckets", "bucket_hits", "oversized",
                       "forward_compiles", "latency_ms":
                       {"count", "mean_ms", "p50_ms", "p99_ms",
                        "exemplars": [{"le_ms", "value_ms",
                                       "trace_id"}, ...]},
                       ...}
                   (exemplars link latency-bucket maxima to trace ids
                    when tracing is on)
    GET  /metrics?format=prometheus
                   -> text exposition of the process-global registry
                      (utils/metrics.py): serving series plus the
                      compile_total / helper_* counters living in the
                      same process
    GET  /trace    -> recent host spans as JSONL (utils/tracing.py);
                      ?format=chrome returns a chrome://tracing document
    GET  /alerts   -> live SLO rule verdicts from the attached run ledger
                      (utils/runledger + analysis/slo): per-rule state,
                      recent lifecycle transitions, the firing list
                      (start with --ledger or run_ledger=)
    GET  /tenants  -> per-tenant spend (utils/resourcemeter: device-
                      seconds by tier, tokens, device memory), merged
                      admission books and conservation verdicts.
                      Requests name their tenant via a JSON "tenant"
                      field or the X-Tenant header (field wins,
                      case-insensitive — the deadline contract's shape);
                      spend metering arms with --meter.

Knobs (constructor and CLI flags): `max_batch_size`, `batch_timeout_ms`,
`buckets`, `warmup_shape` (runs every bucket before the port opens, so
first requests never pay a kernel build or a forward-cache insertion).
With decode slots on, the decode engine is warmed (its CUDA graphs
captured) before the port opens too: no capture ever runs beside a
served forward.
"""

from __future__ import annotations

import argparse
import json
import logging
import math
import queue as _queue
import time
import urllib.parse
from typing import Optional, Sequence

import numpy as np

from deeplearning4j_tpu_torch.parallel.inference import (
    _WAIT_SHED_GRACE,
    DeadlineExceeded,
    InferenceMode,
    ParallelInference,
    ReplicaPool,
    RequestRejected,
    RequestValidationError,
)
from deeplearning4j_tpu_torch.analysis.slo import default_rule_pack
from deeplearning4j_tpu_torch.serving.decode import DecodeEngine
from deeplearning4j_tpu_torch.utils import health as _health
from deeplearning4j_tpu_torch.utils import metrics as _metrics
from deeplearning4j_tpu_torch.utils import resourcemeter as _resourcemeter
from deeplearning4j_tpu_torch.utils import runledger as _runledger
from deeplearning4j_tpu_torch.utils import tenancy as _tenancy
from deeplearning4j_tpu_torch.utils import tracing as _tracing
from deeplearning4j_tpu_torch.utils.jsonhttp import JsonHttpServer, json_response
from deeplearning4j_tpu_torch.utils.latency import LatencyTracker
from deeplearning4j_tpu_torch.utils.model_serializer import guess_and_load_model

logger = logging.getLogger("deeplearning4j_tpu_torch")


class InferenceServer:
    def __init__(
        self,
        model,
        port: int = 0,
        mesh=None,
        inference_mode: str = InferenceMode.BATCHED,
        max_batch_size: int = 64,
        batch_timeout_ms: float = 2.0,
        buckets: Optional[Sequence[int]] = None,
        warmup_shape: Optional[Sequence[int]] = None,
        health_stall_after: float = 30.0,
        n_replicas: int = 1,
        queue_capacity: int = 1024,
        default_deadline_ms: Optional[float] = None,
        request_timeout: float = 30.0,
        run_ledger=None,
        decode_slots: int = 0,
        decode_eos_token: Optional[int] = None,
        decode_max_tokens: int = 64,
        decode_tenant_weights: Optional[dict] = None,
        decode_queue_capacity: int = 256,
        devices: Optional[Sequence] = None,
    ):
        # n_replicas >= 2 turns on the self-healing pool: each replica's
        # collector/dispatcher heartbeats are watched separately, an
        # unhealthy replica is evicted (only its in-flight requests fail;
        # queued work re-routes to a sibling with no user-visible error)
        # and respawned — the eviction/respawn cycle shows up in
        # component_health transitions and serving_replica_* counters on
        # the same /metrics scrape as the traffic series
        if int(n_replicas) > 1:
            self.inference = ReplicaPool(
                model, n_replicas=int(n_replicas), mesh=mesh,
                devices=devices, inference_mode=inference_mode,
                max_batch_size=max_batch_size,
                batch_timeout_ms=batch_timeout_ms, buckets=buckets,
                health_stall_after=health_stall_after,
                queue_capacity=queue_capacity,
                default_deadline_ms=default_deadline_ms,
            )
        else:
            self.inference = ParallelInference(
                model, mesh, inference_mode, max_batch_size,
                batch_timeout_ms, buckets,
                health_stall_after=health_stall_after,
                queue_capacity=queue_capacity,
                default_deadline_ms=default_deadline_ms,
                devices=devices,
            )
        if warmup_shape is not None:
            self.inference.warmup(warmup_shape)
        # the autoregressive tier: decode_slots > 0 mounts a continuous-
        # batching DecodeEngine (serving/decode.py) over the SAME model
        # and exposes POST /generate behind the same deadline/429
        # contract as /predict (streaming via chunked ndjson). Its step
        # programs are built (on a CUDA device: captured as graphs) here,
        # before the port opens — a capture never runs beside a /predict
        # forward on another thread
        self.decode = None
        if int(decode_slots) > 0:
            self.decode = DecodeEngine(
                model, n_slots=int(decode_slots),
                eos_token=decode_eos_token,
                default_max_tokens=int(decode_max_tokens),
                default_deadline_ms=default_deadline_ms,
                tenant_weights=decode_tenant_weights,
                queue_capacity=int(decode_queue_capacity),
                health_stall_after=health_stall_after,
            ).warmup()
        # run-ledger opt-in at the server level (works for both the
        # single-PI and ReplicaPool modes): a path builds a RunLedger
        # with the default rule pack derived from THIS server's config
        # (the p99 deadline burn objective, queue boundedness) and
        # closes it on stop(); an instance is attached as given.
        rules = None
        if isinstance(run_ledger, str):
            rules = default_rule_pack(serving={
                "default_deadline_ms": default_deadline_ms,
                "queue_capacity": queue_capacity})
        self._ledgers = _runledger.attach_scoped(run_ledger, rules=rules)
        self.latency = LatencyTracker()
        # request latency also lands in the shared registry so one
        # Prometheus scrape carries serving AND training series
        self._m_latency = _metrics.get_registry().histogram(
            "serving_request_seconds",
            "end-to-end /predict latency (admission to result)").labels()
        self._server = JsonHttpServer(get=self._get, post=self._post,
                                      port=port,
                                      request_timeout=request_timeout)

    @property
    def port(self) -> int:
        return self._server.port

    def metrics(self) -> dict:
        m = self.inference.metrics()
        # JSON object keys must be strings; bucket sizes are ints
        m["bucket_hits"] = {str(k): v for k, v in m["bucket_hits"].items()}
        m["latency_ms"] = self.latency.snapshot()
        # per-bucket latency exemplars (value + trace_id) from the cached
        # serving_request_seconds child: the scrape-to-trace link.
        # Converted to ms-suffixed keys: everything else in this
        # latency_ms object is milliseconds, and a seconds-valued field
        # next to p99_ms is a silent 1000x misread
        m["latency_ms"]["exemplars"] = [
            {"le_ms": (e["le"] if isinstance(e["le"], str)
                       else round(e["le"] * 1e3, 6)),
             "value_ms": round(e["value"] * 1e3, 6),
             "trace_id": e["trace_id"], "ts": e["ts"],
             **({"tenant": e["tenant"]} if "tenant" in e else {})}
            for e in self._m_latency.exemplars()]
        if self.decode is not None:
            # the autoregressive tier's books on the same scrape: slot
            # occupancy, per-tenant conservation, token counts, version
            m["decode"] = self.decode.metrics()
        return m

    # -- request handling ----------------------------------------------------

    def _get(self, path, body, headers):
        parsed = urllib.parse.urlparse(path)
        route = parsed.path
        query = urllib.parse.parse_qs(parsed.query)
        fmt = (query.get("format") or [""])[0]
        if route == "/health":
            # the aggregated health model (utils/health): worst component
            # status, with per-component stall detail. 503 when UNHEALTHY
            # so load balancers stop routing here (the replica-eviction
            # hook); degraded stays 200 — shedding, not eviction.
            shape = self.inference._expected_shape
            h = _health.get_health().status()
            code = 503 if h["status"] == _health.UNHEALTHY else 200
            return json_response({
                "status": h["status"],
                "components": h["components"],
                "model": type(self.inference.model).__name__,
                "feature_shape": None if shape is None else list(shape),
            }, code)
        if route == "/metrics":
            if fmt == "prometheus":
                text = _metrics.get_registry().to_prometheus()
                return 200, "text/plain; version=0.0.4", text.encode()
            if fmt == "registry":
                # the registry's JSON snapshot (same series as the
                # prometheus exposition, machine-readable)
                return json_response(_metrics.get_registry().snapshot())
            return json_response(self.metrics())
        if route == "/alerts":
            # the live SLO verdicts (analysis/slo evaluated on the run
            # ledger's recorder thread): per-rule pending/firing state,
            # recent lifecycle transitions, and which rules fire right
            # now. THIS server's ledger first: another component
            # attaching/detaching the process-global slot (a fit's scoped
            # ledger ending mid-serve) must not hijack or blank this
            led = self._ledgers[1] or _runledger.current()
            if led is None:
                return json_response({
                    "ledger": None, "rules": [], "firing": [],
                    "transitions": [],
                    "note": "no run ledger attached (start the server "
                            "with run_ledger=, or attach one via "
                            "utils.runledger)"})
            return json_response(led.alert_status())
        if route == "/trace":
            # recent host spans — JSONL by default (tail-able), or the
            # chrome://tracing document with ?format=chrome
            tracer = _tracing.get_tracer()
            if fmt == "chrome":
                return json_response(tracer.to_chrome_trace())
            n_raw = (query.get("n") or [None])[0]
            try:
                n = None if n_raw is None else max(0, int(n_raw))
            except ValueError:
                n = None
            return 200, "application/x-ndjson", tracer.to_jsonl(n).encode()
        if route == "/tenants":
            # the budget view: per-tenant spend (device-seconds by tier,
            # wire bytes, tokens/examples, device memory) + merged outcome
            # books + the conservation verdicts, plus which per-tenant
            # SLO rules fire right now (from this server's ledger)
            doc = _resourcemeter.snapshot()
            led = self._ledgers[1] or _runledger.current()
            if led is not None:
                doc["slo_firing"] = [r for r in led.alert_status()["firing"]
                                     if "tenant" in str(r)]
            return json_response(doc)
        return None

    @staticmethod
    def _parse_deadline(req: dict, headers: dict):
        """The ONE deadline contract for every POST route: the JSON
        field wins over the X-Deadline-Ms header (case-insensitive —
        HTTP/2 proxies lowercase it); both are a RELATIVE ms budget.
        Returns (deadline_ms or None, error_response or None)."""
        deadline_ms = req.get("deadline_ms")
        if deadline_ms is None:
            deadline_ms = next(
                (v for k, v in headers.items()
                 if k.lower() == "x-deadline-ms"), None)
        if deadline_ms is None:
            return None, None
        try:
            deadline_ms = float(deadline_ms)
        except (TypeError, ValueError):
            return None, json_response(
                {"error": f"bad deadline_ms: {deadline_ms!r}"}, 400)
        if not math.isfinite(deadline_ms):
            # json.loads parses bare NaN/Infinity; a NaN budget makes
            # every deadline comparison False — admitted, then shed
            # with a misleading 429. Malformed input is a 400.
            return None, json_response(
                {"error": f"deadline_ms must be finite, "
                          f"got {deadline_ms!r}"}, 400)
        return deadline_ms, None

    @staticmethod
    def _extract_tenant(req: dict, headers: dict):
        """The ONE tenant contract, mirroring _parse_deadline: the JSON
        `tenant` field wins over the X-Tenant header (case-insensitive),
        falling back to the ambient tenant jsonhttp attached from the
        same header — so the result is always a concrete interned name
        (DEFAULT_TENANT when nobody said anything)."""
        tenant = req.get("tenant")
        if tenant is None:
            tenant = _tenancy.from_headers(headers)
        return _tenancy.intern(tenant)

    @staticmethod
    def _shed_response(e):
        """Shed, not failed: 429 + Retry-After (integer delta-seconds
        per RFC 9110; the body keeps ms precision)."""
        retry_after = max(0.05, getattr(e, "retry_after", 0.0) or 0.05)
        return json_response(
            {"error": str(e), "shed": True,
             "stage": getattr(e, "stage", "admission"),
             "retry_after_ms": round(retry_after * 1e3, 1)},
            429,
            headers={"Retry-After": str(max(1, math.ceil(retry_after)))})

    def _post(self, path, body, headers):
        if path == "/generate":
            return self._post_generate(body, headers)
        if path != "/predict":
            return None
        req = json.loads(body or b"{}")
        if "features" not in req:
            return json_response({"error": "missing 'features'"}, 400)
        try:
            feats = np.asarray(req["features"], np.float32)
        except (ValueError, TypeError) as e:  # ragged / non-numeric
            return json_response({"error": f"bad features: {e}"}, 400)
        if feats.ndim == 0 or feats.size == 0:
            return json_response(
                {"error": "features must be a non-empty example array"}, 400)
        single = feats.ndim == 1
        if single:
            feats = feats[None]
        deadline_ms, err = self._parse_deadline(req, headers)
        if err is not None:
            return err
        t0 = time.perf_counter()
        try:
            # the request's serving span: nests under jsonhttp's
            # http/server span (which joined the caller's traceparent,
            # or rooted a fresh trace) on this handler thread
            tenant = self._extract_tenant(req, headers)
            sp = _tracing.span("serve/predict",
                               examples=int(feats.shape[0]),
                               tenant=tenant)
            with sp:
                out = self.inference.output(feats, deadline_ms=deadline_ms,
                                            tenant=tenant)
        except RequestValidationError as e:  # the client's fault
            return json_response({"error": str(e)}, 400)
        except (RequestRejected, DeadlineExceeded) as e:
            # shed, not failed: 429 tells clients/load-balancers to back
            # off and retry later; 503 stays reserved for GET /health
            return self._shed_response(e)
        except Exception as e:
            # anything else (shutdown race, model/CUDA failure — including
            # server-side ValueErrors) is a server fault: 500, so
            # clients/load-balancers retry or fail over (JsonHttpServer's
            # catch-all would mislabel it a 400)
            return json_response({"error": f"{type(e).__name__}: {e}"}, 500)
        dt = time.perf_counter() - t0
        self.latency.record(dt)
        # exemplar link: the histogram keeps (value, trace_id) on new
        # bucket maxima, so a p99 outlier in the scrape resolves (GET
        # /trace) to the exact trace that produced it. sp.context is
        # None when tracing is off (NULL_SPAN) — a plain observation.
        ctx = sp.context
        self._m_latency.observe(
            dt, trace_id=ctx.trace_id if ctx is not None else None)
        with _tracing.span("serve/respond"):
            if isinstance(out, list):  # multi-output graph: one entry
                # per head
                preds = [np.asarray(o)[0].tolist() if single
                         else np.asarray(o).tolist() for o in out]
            else:
                out = np.asarray(out)
                preds = (out[0] if single else out).tolist()
            return json_response({"predictions": preds})

    def _post_generate(self, body, headers):
        """POST /generate — the autoregressive decode route.

            {"prompt": [token ids...], "max_tokens": 32,
             "tenant": "...", "deadline_ms": 500, "stream": false}

        Non-streaming: one JSON body {"tokens": [...], "version": v}.
        `"stream": true`: a chunked application/x-ndjson response — one
        {"token": id} line per emitted token as it is produced, closed
        by a {"done": true, "tokens": [...]} line (or an {"error": ...}
        line if the request was shed mid-decode). Same deadline/429
        contract as /predict."""
        if self.decode is None:
            return json_response(
                {"error": "decode engine not enabled (start the server "
                          "with decode_slots > 0 / --decodeSlots)"}, 404)
        req = json.loads(body or b"{}")
        if "prompt" not in req:
            return json_response({"error": "missing 'prompt'"}, 400)
        deadline_ms, err = self._parse_deadline(req, headers)
        if err is not None:
            return err
        tenant = self._extract_tenant(req, headers)
        max_tokens = req.get("max_tokens")
        if max_tokens is not None:
            try:
                max_tokens = int(max_tokens)
            except (TypeError, ValueError):
                return json_response(
                    {"error": f"bad max_tokens: {max_tokens!r}"}, 400)
        kw = dict(max_new_tokens=max_tokens, tenant=tenant,
                  deadline_ms=deadline_ms)
        stream = bool(req.get("stream", False))
        t0 = time.perf_counter()
        try:
            with _tracing.span("serve/generate", tenant=tenant,
                               stream=stream):
                if not stream:
                    toks = self.decode.generate_sync(req["prompt"], **kw)
                    self.latency.record(time.perf_counter() - t0)
                    return json_response(
                        {"tokens": toks,
                         "version": self.decode.version})
                emitted: "_queue.Queue" = _queue.Queue()
                fut = self.decode.generate(
                    req["prompt"], on_token=emitted.put_nowait, **kw)
        except RequestValidationError as e:
            return json_response({"error": str(e)}, 400)
        except (RequestRejected, DeadlineExceeded) as e:
            return self._shed_response(e)
        except Exception as e:
            return json_response({"error": f"{type(e).__name__}: {e}"},
                                 500)

        # the wedged-engine backstop the non-streaming route gets from
        # generate_sync: a deadline-carrying stream gives up (and sheds,
        # race-safely — the engine's own shed may win) a grace past its
        # deadline instead of pinning the handler thread forever
        give_up = (None if deadline_ms is None
                   else t0 + float(deadline_ms) / 1e3 + _WAIT_SHED_GRACE)

        def lines():
            # drain tokens as the engine emits them; the final line
            # carries the whole-request verdict (mid-stream sheds can
            # no longer change the status code — it is on the wire)
            while True:
                try:
                    t = emitted.get(timeout=0.05)
                except _queue.Empty:
                    if fut.done() and emitted.empty():
                        break
                    if give_up is not None \
                            and time.perf_counter() >= give_up:
                        self.decode._fail(
                            fut,
                            DeadlineExceeded(
                                "deadline expired waiting on a stalled "
                                "decode engine", stage="wait"),
                            tenant, outcome="shed", stage="wait",
                            reason="expired")
                        break
                    continue
                yield (json.dumps({"token": int(t)}) + "\n").encode()
            try:
                toks = fut.result(timeout=0)
                yield (json.dumps(
                    {"done": True, "tokens": toks,
                     "version": self.decode.version}) + "\n").encode()
            except Exception as e:
                yield (json.dumps(
                    {"error": f"{type(e).__name__}: {e}",
                     "shed": isinstance(
                         e, (RequestRejected, DeadlineExceeded))})
                    + "\n").encode()

        return 200, "application/x-ndjson", lines()

    # -- lifecycle -----------------------------------------------------------

    def start(self) -> int:
        return self._server.start()

    def stop(self):
        self._server.stop()
        if self.decode is not None:
            self.decode.shutdown()
        self.inference.shutdown()
        _runledger.end_scope(*self._ledgers)

    def join(self):
        self._server.join()


def main(argv=None):
    """CLI: serve a saved model zip / Keras h5 over REST.

        python -m deeplearning4j_tpu_torch.serving.inference_server \
            --modelPath model.zip --port 9100 --maxBatchSize 64 \
            --batchTimeoutMs 2 --warmupShape 784 --decodeSlots 8 --meter
    """
    ap = argparse.ArgumentParser(description="model inference REST server")
    ap.add_argument("--modelPath", required=True)
    ap.add_argument("--port", type=int, default=9100)
    ap.add_argument("--maxBatchSize", type=int, default=64)
    ap.add_argument("--batchTimeoutMs", type=float, default=2.0)
    ap.add_argument("--buckets", default=None,
                    help="comma-separated bucket sizes (default: powers of "
                         "two up to maxBatchSize)")
    ap.add_argument("--warmupShape", default=None,
                    help="comma-separated feature shape to precompile all "
                         "buckets before the port opens, e.g. 784 or 28,28,1")
    ap.add_argument("--replicas", type=int, default=1,
                    help=">=2 serves through a self-healing ReplicaPool: "
                         "unhealthy replicas are evicted and respawned")
    ap.add_argument("--queueCapacity", type=int, default=1024,
                    help="bounded request queue: admission returns 429 "
                         "instead of queueing past this depth (0 = "
                         "unbounded)")
    ap.add_argument("--defaultDeadlineMs", type=float, default=None,
                    help="latency budget applied to requests that carry "
                         "no deadline_ms of their own")
    ap.add_argument("--requestTimeout", type=float, default=30.0,
                    help="per-connection socket read timeout (slowloris "
                         "protection); 0 disables")
    ap.add_argument("--ledger", default=None, metavar="PATH",
                    help="record a persistent run ledger (metrics "
                         "samples + SLO rule verdicts) to this path; "
                         "GET /alerts serves the live rule states")
    ap.add_argument("--decodeSlots", type=int, default=0,
                    help=">0 mounts the continuous-batching decode "
                         "engine (POST /generate) with this many slots "
                         "(recurrent models only)")
    ap.add_argument("--decodeEos", type=int, default=None,
                    help="EOS token id ending a generated sequence early")
    ap.add_argument("--decodeMaxTokens", type=int, default=64,
                    help="default max_tokens for /generate requests")
    ap.add_argument("--meter", action="store_true",
                    help="arm per-tenant resource metering "
                         "(utils/resourcemeter): GET /tenants then "
                         "reports device-seconds/wire/HBM spend, not "
                         "just admission books")
    ap.add_argument("--device", default="cuda",
                    help="torch device to serve on (default cuda; the "
                         "server refuses to start without a GPU unless "
                         "given cpu)")
    ap.add_argument("--devices", default=None,
                    help="comma-separated torch devices each request group "
                         "is split over, e.g. cuda:0,cuda:1 (default: the "
                         "model's device alone)")
    args = ap.parse_args(argv)
    if args.meter:
        _resourcemeter.enable()
    model = guess_and_load_model(args.modelPath, device=args.device)
    buckets = (None if args.buckets is None
               else [int(b) for b in args.buckets.split(",")])
    warmup = (None if args.warmupShape is None
              else tuple(int(d) for d in args.warmupShape.split(",")))
    server = InferenceServer(
        model, port=args.port, max_batch_size=args.maxBatchSize,
        batch_timeout_ms=args.batchTimeoutMs, buckets=buckets,
        warmup_shape=warmup, n_replicas=args.replicas,
        queue_capacity=args.queueCapacity,
        default_deadline_ms=args.defaultDeadlineMs,
        request_timeout=args.requestTimeout,
        run_ledger=args.ledger,
        decode_slots=args.decodeSlots,
        decode_eos_token=args.decodeEos,
        decode_max_tokens=args.decodeMaxTokens,
        devices=None if args.devices is None else args.devices.split(","),
    )
    # operator surface: opt in to real log output, then announce through
    # the package logger (library code never prints)
    if not logging.getLogger().handlers:
        logging.basicConfig(level=logging.INFO)
    port = server.start()
    logger.info("inference server listening on :%d (buckets %s)",
                port, server.inference.buckets)
    try:
        server.join()
    except KeyboardInterrupt:
        server.stop()


if __name__ == "__main__":
    main()
