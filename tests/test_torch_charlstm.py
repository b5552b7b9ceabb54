"""The port's char-LSTM (deeplearning4j_tpu_torch) against the JAX package
on shared weights: the conf JSON bridge, the weight carry-across, and the
three inference paths of the serving slice — `output()`, a multi-token
`rnn_time_step` stream, and `rnn_decode_step_fn`. vocab 13, hidden 16,
2 GravesLSTM layers, f32, rtol 1e-5 (the JAX side on the CPU at
"highest" matmul precision, per tests/conftest.py)."""

import numpy as np
import pytest
import torch

from deeplearning4j_tpu.models.charlstm import char_lstm_conf as jax_conf
from deeplearning4j_tpu.models.charlstm import char_lstm_network as jax_network
from deeplearning4j_tpu.ops import pallas_lstm
from deeplearning4j_tpu_torch.models.charlstm import char_lstm_network
from deeplearning4j_tpu_torch.nn.conf import MultiLayerConfiguration
from deeplearning4j_tpu_torch.nn.params import params_from_numpy

VOCAB, HIDDEN, LAYERS = 13, 16, 2
RTOL, ATOL = 1e-5, 1e-6


def _shared_pair(seed=7):
    jnet = jax_network(vocab_size=VOCAB, hidden=HIDDEN, layers=LAYERS, seed=seed)
    tnet = char_lstm_network(vocab_size=VOCAB, hidden=HIDDEN, layers=LAYERS,
                             seed=seed, device="cpu")
    tnet.params_list = params_from_numpy(
        tnet.conf, [{k: np.asarray(v) for k, v in p.items()}
                    for p in jnet.params_list], device="cpu")
    return jnet, tnet


def _one_hot(rng, b, t):
    return np.eye(VOCAB, dtype=np.float32)[rng.integers(0, VOCAB, (b, t))]


@pytest.mark.parametrize("precision", ["f32", "bf16"])
def test_jax_conf_json_parses_and_reserializes_identically(precision):
    js = jax_conf(vocab_size=VOCAB, hidden=HIDDEN, layers=LAYERS,
                  precision=precision).to_json()
    conf = MultiLayerConfiguration.from_json(js)
    assert conf.to_json() == js
    assert [type(lc).__name__ for lc in conf.layers] == \
        ["GravesLSTM", "GravesLSTM", "RnnOutputLayer"]


def test_params_from_numpy_gives_the_same_flat_vector():
    jnet, tnet = _shared_pair()
    flat = tnet.params()
    assert flat.shape == (jnet.num_params(),)
    np.testing.assert_array_equal(flat.numpy(), np.asarray(jnet.params()))
    assert tnet.param_table() == jnet.param_table()
    # and set_params round-trips the flat view
    tnet.set_params(flat * 2)
    np.testing.assert_array_equal(tnet.params().numpy(), flat.numpy() * 2)


def test_params_from_numpy_rejects_a_mismatched_layer():
    jnet, tnet = _shared_pair()
    bad = [{k: np.asarray(v) for k, v in p.items()} for p in jnet.params_list]
    del bad[0]["pO"]
    with pytest.raises(ValueError):
        params_from_numpy(tnet.conf, bad, device="cpu")


def test_params_from_numpy_defaults_to_the_gpu(monkeypatch):
    """Like every entry point, the carry-across puts the weights on the
    card unless the caller asks for the CPU."""
    jnet, tnet = _shared_pair()
    arrays = [{k: np.asarray(v) for k, v in p.items()} for p in jnet.params_list]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        params_from_numpy(tnet.conf, arrays)
    out = params_from_numpy(tnet.conf, arrays, device=tnet.device)
    assert all(t.device.type == "cpu" for p in out for t in p.values())


def test_init_is_seeded_and_matches_reference_statistics():
    a = char_lstm_network(vocab_size=VOCAB, hidden=64, layers=1, device="cpu")
    b = char_lstm_network(vocab_size=VOCAB, hidden=64, layers=1, device="cpu")
    assert torch.equal(a.params(), b.params())
    W = a.params_list[0]["RW"]  # xavier: std sqrt(2 / (fan_in + fan_out))
    assert abs(W.std().item() - np.sqrt(2.0 / 128)) < 0.1 * np.sqrt(2.0 / 128)
    bias = a.params_list[0]["b"]
    assert torch.equal(bias[64:128], torch.ones(64))  # forget-gate bias 1.0


@pytest.mark.parametrize("interpret", [False, True])
def test_output_matches_jax(interpret):
    """`output()` on one batch; the JAX side through its scan path and
    through the Pallas sequence kernel in interpret mode."""
    jnet, tnet = _shared_pair()
    x = _one_hot(np.random.default_rng(0), 3, 9)
    old = pallas_lstm._INTERPRET
    pallas_lstm._INTERPRET = interpret
    try:
        ref = np.asarray(jnet.output(x))
    finally:
        pallas_lstm._INTERPRET = old
    out = tnet.output(x)
    assert out.shape == (3, 9, VOCAB) and out.device.type == "cpu"
    np.testing.assert_allclose(out.numpy(), ref, rtol=RTOL, atol=ATOL)
    assert tnet.output_compile_count == 1
    tnet.output(x)
    assert tnet.output_compile_count == 1  # shape-keyed cache hit


def test_rnn_time_step_stream_matches_jax():
    """A stream of multi-token and single-token calls carries h/c across
    calls exactly as the reference does."""
    jnet, tnet = _shared_pair()
    x = _one_hot(np.random.default_rng(1), 2, 10)
    for sl in (slice(0, 4), slice(4, 5), slice(5, 10)):
        ref = np.asarray(jnet.rnn_time_step(x[:, sl]))
        out = tnet.rnn_time_step(x[:, sl]).numpy()
        np.testing.assert_allclose(out, ref, rtol=RTOL, atol=ATOL)
    ref = np.asarray(jnet.rnn_time_step(x[:, 3]))   # 2-D: one step
    out = tnet.rnn_time_step(x[:, 3]).numpy()
    assert out.shape == (2, VOCAB)
    np.testing.assert_allclose(out, ref, rtol=RTOL, atol=ATOL)
    tnet.clear_rnn_state()
    jnet.clear_rnn_state()
    np.testing.assert_allclose(tnet.rnn_time_step(x[:, :2]).numpy(),
                               np.asarray(jnet.rnn_time_step(x[:, :2])),
                               rtol=RTOL, atol=ATOL)


def test_rnn_decode_step_fn_matches_jax():
    jnet, tnet = _shared_pair()
    rng = np.random.default_rng(2)
    jstep, tstep = jnet.rnn_decode_step_fn(), tnet.rnn_decode_step_fn()
    jcarry, tcarry = jnet.rnn_zero_carry(4), tnet.rnn_zero_carry(4)
    for _ in range(3):
        x = _one_hot(rng, 4, 1)[:, 0]
        jcarry, jout = jstep(jnet.params_list, jnet.state_list, jcarry, x)
        with torch.no_grad():
            tcarry, tout = tstep(tnet.params_list, tnet.state_list, tcarry,
                                 torch.from_numpy(x))
        np.testing.assert_allclose(tout.numpy(), np.asarray(jout),
                                   rtol=RTOL, atol=ATOL)
        for i in jcarry:
            for k in ("h", "c"):
                np.testing.assert_allclose(tcarry[i][k].numpy(),
                                           np.asarray(jcarry[i][k]),
                                           rtol=RTOL, atol=ATOL)


def test_layers_fall_back_to_the_builtin_loop_on_cpu():
    """On CPU tensors the probes decline, so no helper hit is counted and
    no kernel launches."""
    from deeplearning4j_tpu_torch.ops import fused_lstm as fl
    from deeplearning4j_tpu_torch.utils.metrics import get_registry

    _, tnet = _shared_pair()
    before = fl.launch_counts()
    fam = get_registry().counter(
        "helper_fallback_total", "Helper SPI events",
        ("op", "helper", "family", "reason"))
    seq = fam.labels("lstm_sequence", "cuda_fused_lstm", "lstm_seq", "unsupported")
    n0 = seq.value
    tnet.output(_one_hot(np.random.default_rng(3), 2, 4))
    assert seq.value == n0 + LAYERS
    assert fl.launch_counts() == before
