"""Tenant identity and cross-tier metering in the port
(deeplearning4j_tpu_torch/utils/tenancy.py, utils/resourcemeter.py) on
the CPU: the identity, off-path and serving cases of
tests/test_tenancy_metering.py, each held to the JAX package's answer
for the same inputs where it has one.

- BOUNDED CARDINALITY: past the registry cap new tenant names collapse
  into `__other__`.
- OFF-PATH COST: an unmetered process pays one module-global read per
  hook, under 10 µs a call (the median of many timed batches, so one
  descheduled batch on a loaded machine does not decide it).
- END-TO-END IDENTITY: a `/generate` with an X-Tenant header books the
  request under that tenant in the decode engine, tags the span and the
  token-latency exemplar with it, and charges it decode device-seconds.
"""

import json
import statistics
import time
import urllib.request

import jax
import numpy as np
import pytest
from torch_serving import TIMEOUT, mlp_pair

from deeplearning4j_tpu import parallel as jpar
from deeplearning4j_tpu.utils import tenancy as jtenancy
from deeplearning4j_tpu_torch.parallel.inference import ParallelInference
from deeplearning4j_tpu_torch.utils import metrics as metrics_mod
from deeplearning4j_tpu_torch.utils import resourcemeter, tenancy, tracing

N_IN = 12


@pytest.fixture(autouse=True)
def _meter_off_after():
    """The meter and the ambient tenant are process-global: never leak an
    armed meter (or an attached tenant) into other tests."""
    yield
    resourcemeter.disable()
    tenancy.detach(None)


# -- identity -----------------------------------------------------------------

@pytest.mark.parametrize("raw", [None, "   ", 'ac me"x', "x" * 200, "acme",
                                 "Ünïcode-name", "a.b-c_d"])
def test_intern_canonicalizes_and_defaults(raw):
    got = tenancy.intern(raw)
    assert got == jtenancy.intern(raw)
    assert '"' not in got and " " not in got and len(got) <= 64
    assert tenancy.intern(got) == got  # idempotent
    if raw is None or not raw.strip():
        assert got == tenancy.DEFAULT_TENANT


def test_tenant_cardinality_bounded():
    reg = tenancy.get_tenant_registry()
    try:
        reg.reset(max_tenants=4)
        names = {tenancy.intern(f"cust-{i}") for i in range(20)}
        assert tenancy.OVERFLOW_TENANT in names
        assert len(reg.tenants()) <= 4
        assert reg.overflowed > 0
        survivor = next(n for n in names if n != tenancy.OVERFLOW_TENANT)
        assert tenancy.intern(survivor) == survivor
    finally:
        reg.reset(max_tenants=tenancy.DEFAULT_MAX_TENANTS)


def test_header_extraction_case_insensitive():
    for headers in ({"X-Tenant": "acme"}, {"x-tenant": "acme"},
                    {"Content-Type": "a"}, None):
        assert tenancy.from_headers(headers) == jtenancy.from_headers(headers)
    assert tenancy.from_headers({"x-tenant": "acme"}) == "acme"
    base = {"Content-Type": "application/json"}
    with tenancy.tenant_scope("ambient"):
        out = tenancy.tenant_headers(base, tenant="explicit")
        assert out["X-Tenant"] == "explicit"
        assert tenancy.tenant_headers(base)["X-Tenant"] == "ambient"
    assert "X-Tenant" not in base


# -- off-path cost ------------------------------------------------------------

@pytest.mark.parametrize("hook", ["current_tenant", "note_serving_forward",
                                  "note_decode_step", "note_tokens",
                                  "note_device_window", "note_hbm", "note_wire"])
def test_unmetered_hooks_under_10us_per_call(hook):
    resourcemeter.disable()
    fn = {
        "current_tenant": tenancy.current_tenant,
        "note_serving_forward": lambda: resourcemeter.note_serving_forward(0.0, {}),
        "note_decode_step": lambda: resourcemeter.note_decode_step(0.0, {}),
        "note_tokens": lambda: resourcemeter.note_tokens("a", 1),
        "note_device_window": lambda: resourcemeter.note_device_window(None, 0.01),
        "note_hbm": lambda: resourcemeter.note_hbm("a", "s", 1.0),
        "note_wire": lambda: resourcemeter.note_wire("a", "training", 1),
    }[hook]
    per_call = []
    for _ in range(50):
        t0 = time.perf_counter()
        for _ in range(400):
            fn()
        per_call.append((time.perf_counter() - t0) / 400)
    median = statistics.median(per_call)
    assert median < 10e-6, f"{hook}: {median * 1e6:.2f} us/call"


def test_unmetered_snapshot_is_books_only():
    resourcemeter.disable()
    doc = resourcemeter.snapshot()
    assert "note" in doc  # says why spend is empty
    assert doc["conservation"]["ok"] is not None
    assert sorted(doc) == sorted(["tenants", "books_by_tier", "conservation",
                                  "registry_tenants", "note"])


# -- serving ------------------------------------------------------------------

def test_parallel_inference_books_per_tenant(tmp_path):
    jnet, tnet = mlp_pair(tmp_path)
    books = []
    for pi in (ParallelInference(tnet, max_batch_size=4, batch_timeout_ms=1.0,
                                 component_prefix="tenancy_pi"),
               jpar.ParallelInference(jnet, jpar.data_parallel_mesh(jax.devices()[:1]),
                                      max_batch_size=4, batch_timeout_ms=1.0,
                                      component_prefix="tenancy_pi_jax")):
        try:
            pi.warmup((N_IN,))
            x = np.zeros((2, N_IN), np.float32)
            for _ in range(3):
                pi.output(x, tenant="acme")
            pi.output(x, tenant="beta")
            amb = tenancy if isinstance(pi, ParallelInference) else jtenancy
            with amb.tenant_scope("ambient"):
                pi.output(x)  # no explicit tenant: the thread's ambient one
            m = pi.metrics()
            assert m["tenants"]["acme"]["completed"] == 3
            assert m["tenants"]["beta"]["completed"] == 1
            assert m["tenants"]["ambient"]["completed"] == 1
            assert m["conservation_ok"]
            books.append(m["tenants"])
        finally:
            pi.shutdown()
    assert books[0] == books[1]


def test_parallel_inference_meters_forward_seconds_per_tenant(tmp_path):
    """Metered, each fused forward's wall time splits over its live rows
    by tenant, and the per-tenant sums equal the process total."""
    _, tnet = mlp_pair(tmp_path)
    resourcemeter.enable()
    pi = ParallelInference(tnet, max_batch_size=4, batch_timeout_ms=1.0,
                           component_prefix="tenancy_meter")
    try:
        pi.warmup((N_IN,))
        for t in ("m-acme", "m-beta", "m-acme"):
            pi.output(np.zeros((2, N_IN), np.float32), tenant=t)
        snap = resourcemeter.snapshot()
        spent = snap["tenants"]["m-acme"]["device_seconds"]
        assert spent.get(resourcemeter.TIER_SERVING, 0.0) > 0.0
        assert snap["conservation"]["ok"], snap["conservation"]
    finally:
        pi.shutdown()


def test_generate_with_header_tags_books_spans_and_exemplars():
    """One `/generate` carrying X-Tenant: the request books under that
    tenant in the engine, the serve/generate span carries it, and the
    token-latency exemplar links it to the trace."""
    from deeplearning4j_tpu_torch.models.charlstm import char_lstm_network
    from deeplearning4j_tpu_torch.serving.inference_server import InferenceServer

    net = char_lstm_network(vocab_size=13, hidden=16, layers=1, tbptt_length=8,
                            seed=12345, device="cpu")
    srv = InferenceServer(net, decode_slots=2, decode_max_tokens=8)
    srv.start()
    tracing.get_tracer().clear()
    tracing.enable(True)
    resourcemeter.enable()
    tok_lat = metrics_mod.get_registry().get("decode_token_seconds").labels()
    with tok_lat._lock:  # an earlier test's exemplar must not mask ours
        tok_lat._exemplars.clear()
    try:
        req = urllib.request.Request(
            f"http://127.0.0.1:{srv.port}/generate",
            data=json.dumps({"prompt": [1, 2, 3], "max_tokens": 4}).encode(),
            headers={"Content-Type": "application/json", "X-Tenant": "acme"})
        with urllib.request.urlopen(req, timeout=TIMEOUT) as resp:
            out = json.loads(resp.read())
        assert len(out["tokens"]) == 4
        eng = srv.decode.metrics()
        assert eng["tenants"]["acme"]["completed"] >= 1
        spans = [e for e in tracing.get_tracer().recent()
                 if (e.get("args") or {}).get("tenant") == "acme"]
        names = {e["name"] for e in spans}
        assert {"serve/generate", "decode/admit", "decode/emit"} <= names, names
        exs = tok_lat.exemplars()
        assert any(ex.get("tenant") == "acme" for ex in exs), exs
        snap = resourcemeter.snapshot()
        dev = snap["tenants"]["acme"]["device_seconds"]
        assert dev.get(resourcemeter.TIER_DECODE, 0.0) > 0.0
        assert snap["tenants"]["acme"]["tokens"] == 4
    finally:
        tracing.enable(False)
        tracing.get_tracer().clear()
        srv.stop()
