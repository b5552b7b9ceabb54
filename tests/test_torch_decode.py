"""The port's continuous-batching decode engine
(deeplearning4j_tpu_torch/serving/decode.py) on the CPU.

- its greedy tokens equal the JAX package's DecodeEngine on shared
  weights, and the port's own sequential `rnn_time_step` loop at batch 1;
- a request admitted mid-flight decodes identically;
- a weight swap between waves serves the new weights, with no step
  function rebuilt;
- `set_fused_steps(4)` emits the tokens K=1 emits;
- per-tenant books conserve, including shed work.
"""

import threading

import numpy as np
import pytest

from deeplearning4j_tpu.models.charlstm import char_lstm_network as jax_network
from deeplearning4j_tpu.serving.decode import DecodeEngine as JaxDecodeEngine
from deeplearning4j_tpu_torch.models.charlstm import char_lstm_network
from deeplearning4j_tpu_torch.nn.params import params_from_numpy
from deeplearning4j_tpu_torch.parallel.inference import (
    DeadlineExceeded,
    RequestValidationError,
)
from deeplearning4j_tpu_torch.serving.decode import DecodeEngine

VOCAB = 13


def _nets(layers=2, hidden=16, seed=5):
    jnet = jax_network(vocab_size=VOCAB, hidden=hidden, layers=layers,
                       tbptt_length=8, seed=seed)
    tnet = char_lstm_network(vocab_size=VOCAB, hidden=hidden, layers=layers,
                             tbptt_length=8, seed=seed, device="cpu")
    tnet.params_list = params_from_numpy(
        tnet.conf, [{k: np.asarray(v) for k, v in p.items()}
                    for p in jnet.params_list], device="cpu")
    return jnet, tnet


def reference_decode(net, prompt, max_new):
    """The sequential loop: one request at a time, one token per
    rnn_time_step call at batch 1."""
    net.clear_rnn_state()
    eye = np.eye(VOCAB, dtype=np.float32)
    out = None
    for t in prompt:
        out = net.rnn_time_step(eye[[t]])
    toks = []
    while len(toks) < max_new:
        g = int(np.argmax(np.asarray(out)[0]))
        toks.append(g)
        out = net.rnn_time_step(eye[[g]])
    net.clear_rnn_state()
    return toks


def _requests(seed, n):
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, VOCAB, size=1 + i % 5).tolist(), 3 + i % 4)
            for i in range(n)]


def _run(eng, reqs, tenants=None):
    try:
        futs = [eng.generate(p, max_new_tokens=m,
                             tenant=(tenants[i % len(tenants)] if tenants
                                     else "default"))
                for i, (p, m) in enumerate(reqs)]
        return [f.result(timeout=120) for f in futs], eng.metrics()
    finally:
        eng.shutdown()


def test_tokens_equal_jax_engine_and_sequential_loop():
    jnet, tnet = _nets()
    reqs = _requests(0, 8)
    port, m = _run(DecodeEngine(tnet, n_slots=3, component_prefix="t_port"), reqs)
    jax_out, _ = _run(JaxDecodeEngine(jnet, n_slots=3, component_prefix="t_jax"), reqs)
    assert port == jax_out
    assert port == [reference_decode(tnet, p, mx) for p, mx in reqs]
    assert m["completed"] == len(reqs) and m["conservation_ok"]
    assert m["program_cache_size"] == 2


def test_mid_flight_admission_decodes_identically():
    _, net = _nets(layers=1)
    reqs = [([1, 2, 3], 8), ([5, 4], 8)]
    late = ([7, 1], 6)
    refs = [reference_decode(net, p, m) for p, m in reqs]
    ref_late = reference_decode(net, *late)
    eng = DecodeEngine(net, n_slots=3, component_prefix="t_mid")
    late_fut = []
    fired = threading.Event()

    def on_token(_tok):
        # runs on the engine thread after request 0's first emitted token:
        # both initial requests are mid-decode right now
        if not fired.is_set():
            fired.set()
            late_fut.append(eng.generate(late[0], max_new_tokens=late[1]))

    try:
        f0 = eng.generate(reqs[0][0], max_new_tokens=reqs[0][1], on_token=on_token)
        f1 = eng.generate(reqs[1][0], max_new_tokens=reqs[1][1])
        outs = [f0.result(timeout=120), f1.result(timeout=120)]
        assert fired.wait(10)
        out_late = late_fut[0].result(timeout=120)
    finally:
        eng.shutdown()
    assert outs == refs
    assert out_late == ref_late


def test_weight_swap_serves_new_weights_without_rebuilds():
    _, net = _nets(layers=1)
    wave1, wave2 = _requests(1, 4), _requests(2, 4)
    v1 = net.params_list
    v2 = [{k: t * 1.5 for k, t in p.items()} for p in v1]
    eng = DecodeEngine(net, n_slots=2, component_prefix="t_swap")
    try:
        out1 = [eng.generate(p, max_new_tokens=m).result(120) for p, m in wave1]
        warm = eng.program_cache_size()
        v = eng.load_version(v2)
        out2 = [eng.generate(p, max_new_tokens=m).result(120) for p, m in wave2]
        m = eng.metrics()
    finally:
        eng.shutdown()
    assert v == 1 and m["version"] == 1 and m["swaps"] == 1
    assert warm == 2 and m["program_cache_size"] == 2
    assert out1 == [reference_decode(net, p, mx) for p, mx in wave1]
    net.params_list = v2
    assert out2 == [reference_decode(net, p, mx) for p, mx in wave2]
    with pytest.raises(ValueError):
        DecodeEngine.load_version(eng, [{k: t[:1] for k, t in p.items()}
                                        for p in v1])


def test_fused_steps_k4_equals_k1_and_books_conserve_per_tenant():
    _, net = _nets()
    reqs = _requests(3, 10)
    out1, m1 = _run(DecodeEngine(net, n_slots=4, component_prefix="t_k1",
                                 tenant_weights={"a": 3.0, "b": 1.0}),
                    reqs, tenants=["a", "b"])
    eng = DecodeEngine(net, n_slots=4, component_prefix="t_k4",
                       tenant_weights={"a": 3.0, "b": 1.0}).set_fused_steps(4)
    out4, m4 = _run(eng, reqs, tenants=["a", "b"])
    assert out4 == out1
    assert m4["steps"] < m1["steps"]  # one engine iteration per 4 tokens
    for m in (m1, m4):
        assert m["conservation_ok"]
        assert {t: b["completed"] for t, b in m["tenants"].items()} == \
            {"a": 5, "b": 5}
        assert m["tokens"] == sum(mx for _, mx in reqs)


def test_expired_and_invalid_requests_are_shed_or_refused():
    _, net = _nets(layers=1)
    eng = DecodeEngine(net, n_slots=2, component_prefix="t_shed")
    try:
        with pytest.raises(DeadlineExceeded):
            eng.generate([1, 2], max_new_tokens=3, deadline_ms=0, tenant="x")
        with pytest.raises(RequestValidationError):
            eng.generate([VOCAB], max_new_tokens=3)
        with pytest.raises(RequestValidationError):
            eng.generate([], max_new_tokens=3)
        assert eng.generate([3], max_new_tokens=2, tenant="x").result(60) == \
            reference_decode(net, [3], 2)
        m = eng.metrics()
    finally:
        eng.shutdown()
    x = m["tenants"]["x"]
    assert x["rejected"] == 1 and x["completed"] == 1 and x["admitted"] == 1
    assert m["conservation_ok"]
