"""The port's serving front end on a Hopper GPU (`cuda` marker; each test
skips itself without one): K1 on /predict and K2 on /generate in one
process, with /generate traffic interleaved with /predict adding no
decode graph capture and no forward-cache entry after warm-up. The CPU
parity with the JAX package is in tests/test_torch_inference_serving.py.

This file imports nothing of JAX, so it runs where JAX is not installed:
`python -m pytest --noconftest tests/test_torch_serving_cuda.py`.
"""

import json
import threading
import urllib.request

import numpy as np
import pytest
import torch

from deeplearning4j_tpu_torch.models.charlstm import char_lstm_network
from deeplearning4j_tpu_torch.ops import fused_lstm
from deeplearning4j_tpu_torch.serving import InferenceServer

VOCAB, HIDDEN, LAYERS, T = 77, 200, 2, 50
# a served row against the same request's own output(): K1 sums in an order
# that does not depend on the row, the input projection is a cuBLAS product
# whose kernel may change with the batch; f32 softmax outputs
ROW_ATOL = 1e-5


@pytest.fixture(autouse=True)
def _require_hopper():
    if not (torch.cuda.is_available()
            and torch.cuda.get_device_capability() >= (9, 0)):
        pytest.skip("needs an NVIDIA GPU of compute capability >= 9.0")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _post(url, payload, timeout=120):
    req = urllib.request.Request(url, data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        return json.loads(resp.read())


def _greedy(net, prompt, n):
    net.clear_rnn_state()
    eye = np.eye(VOCAB, dtype=np.float32)
    out = None
    for t in prompt:
        out = net.rnn_time_step(eye[[t]])
    toks = []
    while len(toks) < n:
        toks.append(int(torch.argmax(out[0]).item()))
        out = net.rnn_time_step(eye[[toks[-1]]])
    net.clear_rnn_state()
    return toks


@pytest.mark.cuda
def test_predict_launches_k1_generate_launches_k2_no_capture_after_warmup():
    net = char_lstm_network(vocab_size=VOCAB, hidden=HIDDEN, layers=LAYERS, seed=3)
    server = InferenceServer(net, max_batch_size=8, warmup_shape=(T, VOCAB),
                             decode_slots=4)
    port = server.start()
    base = f"http://127.0.0.1:{port}"
    rng = np.random.default_rng(0)
    sizes = [1, 3, 8, 2, 5, 7]
    feats = [np.eye(VOCAB, dtype=np.float32)[rng.integers(0, VOCAB, (n, T))] for n in sizes]
    prompts = [rng.integers(0, VOCAB, 1 + i % 5).tolist() for i in range(6)]
    try:
        compiles = net.output_compile_count
        captures = dict(server.decode.metrics()["captures"])
        assert captures == {1: 2}
        fused_lstm.reset_launch_counts()
        preds, gens = {}, {}

        def predict(i):
            preds[i] = np.asarray(_post(f"{base}/predict",
                                        {"features": feats[i].tolist()})["predictions"],
                                  np.float32)

        def generate(i):
            gens[i] = _post(f"{base}/generate", {"prompt": prompts[i], "max_tokens": 6})["tokens"]

        threads = [threading.Thread(target=predict, args=(i,)) for i in range(len(sizes))]
        threads += [threading.Thread(target=generate, args=(i,)) for i in range(len(prompts))]
        order = rng.permutation(len(threads))
        for k in order:
            threads[k].start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
        torch.cuda.synchronize()
        launches = fused_lstm.launch_counts()
        pm = server.inference.metrics()
        em = server.decode.metrics()
    finally:
        server.stop()
    assert len(preds) == len(sizes) and len(gens) == len(prompts)
    assert net.output_compile_count == compiles
    assert em["captures"] == captures
    assert launches["lstm_sequence"] == LAYERS * pm["batches"] > 0
    assert launches["lstm_step"] == LAYERS * em["steps"] > 0
    for i, x in enumerate(feats):
        ref = net.output(x).cpu().numpy()
        np.testing.assert_allclose(preds[i], ref, rtol=0, atol=ROW_ATOL)
    for i, p in enumerate(prompts):
        assert gens[i] == _greedy(net, p, 6)


@pytest.mark.cuda
def test_bf16_outputs_reach_json_as_f32():
    """A bf16 policy casts the output; the readback widens it, so the
    handler serializes f32 numbers."""
    from deeplearning4j_tpu_torch.parallel import ParallelInference

    net = char_lstm_network(vocab_size=VOCAB, hidden=HIDDEN, layers=1, seed=4,
                            precision="bf16")
    pi = ParallelInference(net, max_batch_size=4)
    try:
        x = np.eye(VOCAB, dtype=np.float32)[np.arange(2 * T).reshape(2, T) % VOCAB]
        out = pi.output(x)
    finally:
        pi.shutdown()
    assert out.dtype == np.float32 and out.shape == (2, T, VOCAB)
    assert np.isfinite(out).all()
    json.dumps(out.tolist())
