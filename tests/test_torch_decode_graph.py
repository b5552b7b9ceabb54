"""The decode engine's static-buffer step program
(deeplearning4j_tpu_torch/serving/decode.py) on the CPU.

On a CUDA device each (K, parameter set) program is captured once as a
CUDA graph and every step replays it; on the CPU the same program runs
eagerly on the same static buffers, so these tests exercise the buffer,
reset and weight-swap logic that the card runs:

- the static-buffer engine gives the JAX engine's tokens and the port's
  sequential `rnn_time_step` loop's, at K = 1 and K = 4;
- the static program's carry after N steps is bit-equal to N calls of
  the model's decode step function, at K = 1 and K = 4;
- three `load_version` calls, one superseded before it served, serve the
  right weights from two parameter sets that never move;
- a slot admitted mid-flight, or into a slot another request used,
  decodes identically with its rows reset in the static carry;
- the capture tallies: launches and SPI events recorded while a graph
  captures are counted on every replay, and nowhere else.
The graph capture and replay themselves run on the card
(tests/test_torch_cuda_kernels.py, chip_smoke.py phase 4).
"""

import threading

import numpy as np
import pytest
import torch

from deeplearning4j_tpu.models.charlstm import char_lstm_network as jax_network
from deeplearning4j_tpu.serving.decode import DecodeEngine as JaxDecodeEngine
from deeplearning4j_tpu_torch.models.charlstm import char_lstm_network
from deeplearning4j_tpu_torch.nn.params import params_from_numpy
from deeplearning4j_tpu_torch.ops import fused_lstm as fl
from deeplearning4j_tpu_torch.ops import helpers
from deeplearning4j_tpu_torch.serving.decode import DecodeEngine
from deeplearning4j_tpu_torch.utils import metrics

VOCAB = 13


def _nets(layers=2, hidden=16, seed=7):
    jnet = jax_network(vocab_size=VOCAB, hidden=hidden, layers=layers,
                       tbptt_length=8, seed=seed)
    tnet = char_lstm_network(vocab_size=VOCAB, hidden=hidden, layers=layers,
                             tbptt_length=8, seed=seed, device="cpu")
    tnet.params_list = params_from_numpy(
        tnet.conf, [{k: np.asarray(v) for k, v in p.items()}
                    for p in jnet.params_list], device="cpu")
    return jnet, tnet


def _scaled(params, f):
    return [{k: t * f for k, t in p.items()} for p in params]


def reference_decode(net, prompt, max_new, switch=None):
    """The sequential loop at batch 1: one request, one token per
    rnn_time_step call. `switch` = (step, params): from that step (0 is
    the first prompt token) on, the loop runs on `params`."""
    net.clear_rnn_state()
    eye = np.eye(VOCAB, dtype=np.float32)
    params0 = net.params_list
    step = 0

    def feed(tok):
        nonlocal step
        if switch is not None and step == switch[0]:
            net.params_list = switch[1]
        step += 1
        return net.rnn_time_step(eye[[tok]])

    try:
        out = None
        for t in prompt:
            out = feed(t)
        toks = []
        while len(toks) < max_new:
            g = int(np.argmax(np.asarray(out)[0]))
            toks.append(g)
            out = feed(g)
    finally:
        net.params_list = params0
        net.clear_rnn_state()
    return toks


def _requests(seed, n):
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, VOCAB, size=1 + i % 5).tolist(), 3 + i % 4)
            for i in range(n)]


def _addresses(eng):
    """data_ptr of every static buffer the program reads or writes."""
    carry = [a.data_ptr() for st in eng._carry.values() for a in st.values()]
    sets = [a.data_ptr() for p in eng._sets for layer in p for a in layer.values()]
    return carry, sets


@pytest.mark.parametrize("K", [1, 4])
def test_static_engine_gives_jax_engine_and_sequential_tokens(K):
    jnet, tnet = _nets()
    reqs = _requests(11, 7)
    eng = DecodeEngine(tnet, n_slots=3, component_prefix=f"g_port{K}").set_fused_steps(K)
    before = _addresses(eng)
    jeng = JaxDecodeEngine(jnet, n_slots=3, component_prefix=f"g_jax{K}").set_fused_steps(K)
    try:
        port = [f.result(120) for f in [eng.generate(p, max_new_tokens=m) for p, m in reqs]]
        jax_out = [f.result(120) for f in [jeng.generate(p, max_new_tokens=m)
                                            for p, m in reqs]]
        m = eng.metrics()
    finally:
        eng.shutdown()
        jeng.shutdown()
    assert port == jax_out
    assert port == [reference_decode(tnet, p, mx) for p, mx in reqs]
    assert m["program_cache_size"] == 2 and m["captures"] == {}
    assert _addresses(eng) == before  # the program ran on the static buffers


@pytest.mark.parametrize("K", [1, 4])
def test_static_program_carry_equals_the_models_step_function(K):
    _, net = _nets()
    n, steps = 4, 3
    rng = np.random.default_rng(3)
    feeds = rng.integers(0, VOCAB, size=(steps, K, n)).astype(np.int32)
    force = rng.random((steps, K, n)) < 0.5
    force[:, 0] = True
    eng = DecodeEngine(net, n_slots=n, component_prefix=f"g_carry{K}").set_fused_steps(K)
    try:
        eng.warmup()
        got = []
        for s in range(steps):
            if K == 1:
                eng._io[1]["feed"].copy_(torch.from_numpy(feeds[s, 0]))
            else:
                eng._io[K]["toks"].copy_(torch.from_numpy(feeds[s]))
                eng._io[K]["force"].copy_(torch.from_numpy(force[s]))
            got.append(eng._run_program())
        carry = {i: {k: a.clone() for k, a in st.items()} for i, st in eng._carry.items()}
    finally:
        eng.shutdown()
    step = net.rnn_decode_step_fn()
    ref = net.rnn_zero_carry(n)
    with torch.no_grad():
        for s in range(steps):
            prev = torch.from_numpy(feeds[s, 0])
            toks = []
            for t in range(K):
                tok = torch.where(torch.from_numpy(force[s, t]), torch.from_numpy(feeds[s, t]),
                                  prev)
                x = torch.nn.functional.one_hot(tok.long(), VOCAB).to(torch.float32)
                ref, out = step(net.params_list, net.state_list, ref, x)
                prev = torch.argmax(out, dim=-1).to(torch.int32)
                toks.append(prev.numpy())
            np.testing.assert_array_equal(got[s].reshape(-1, n), np.stack(toks))
    for i in ref:
        for k in ref[i]:
            assert torch.equal(carry[i][k], ref[i][k])


def test_three_loads_one_superseded_serve_the_right_weights_from_two_sets():
    _, net = _nets(layers=1)
    v0 = net.params_list
    v1, v2, v3 = _scaled(v0, 1.3), _scaled(v0, 0.7), _scaled(v0, 1.6)
    eng = DecodeEngine(net, n_slots=2, component_prefix="g_loads")
    before = _addresses(eng)
    loaded = []

    def on_token(_tok):
        # on the engine thread, after the first emitted token: both loads
        # land before the engine's next step, so v1 is superseded unserved
        if not loaded:
            loaded.append(eng.load_version(v1))
            loaded.append(eng.load_version(v2))

    prompt, mx = [4, 2, 9], 6
    try:
        out_a = eng.generate(prompt, max_new_tokens=mx, on_token=on_token).result(120)
        m_a = eng.metrics()
        out_b = eng.generate([5, 1], max_new_tokens=5).result(120)
        v = eng.load_version(v3)
        out_c = eng.generate([5, 1], max_new_tokens=5).result(120)
        m_c = eng.metrics()
    finally:
        eng.shutdown()
    assert loaded == [1, 2] and v == 3
    assert m_a["version"] == 2 and m_a["swaps"] == 1  # v1 never served
    assert m_c["version"] == 3 and m_c["swaps"] == 2
    # request a ran its prompt and first token on v0, the rest on v2
    assert out_a == reference_decode(net, prompt, mx, switch=(len(prompt), v2))
    assert out_b == reference_decode(net, [5, 1], 5, switch=(0, v2))
    assert out_c == reference_decode(net, [5, 1], 5, switch=(0, v3))
    # the data tells the versions apart: v1 served would have shown
    assert out_a != reference_decode(net, prompt, mx, switch=(len(prompt), v1))
    assert len(eng._sets) == 2 and _addresses(eng) == before
    # the model's own tensors are never written
    assert all(torch.equal(a, b) for p, q in zip(net.params_list, v0)
               for a, b in zip(p.values(), q.values()))
    assert m_c["program_cache_size"] == 2


def test_a_load_that_does_not_fit_raises_and_touches_no_set():
    _, net = _nets(layers=1)
    eng = DecodeEngine(net, n_slots=1, component_prefix="g_badload")
    try:
        sets = [[{k: a.clone() for k, a in layer.items()} for layer in p] for p in eng._sets]
        with pytest.raises(ValueError, match="shape mismatch"):
            eng.load_version([{k: t[:1] for k, t in p.items()} for p in net.params_list])
        with pytest.raises(ValueError, match="parameters"):
            eng.load_version([{"W": p["W"]} for p in net.params_list])
        with pytest.raises(ValueError, match="layers"):
            eng.load_version(net.params_list[:1])
        m = eng.metrics()
    finally:
        eng.shutdown()
    assert m["version"] == 0 and m["swaps"] == 0 and eng._pending_swap is None
    assert all(torch.equal(a, b) for p, q in zip(sets, eng._sets)
               for la, lb in zip(p, q) for a, b in zip(la.values(), lb.values()))


def test_mid_flight_admission_resets_rows_of_the_static_carry():
    _, net = _nets(layers=2)
    first = [([1, 2, 3], 7), ([5, 4], 3)]
    late = [([7, 1], 6), ([2], 4)]
    refs = [reference_decode(net, p, m) for p, m in first + late]
    eng = DecodeEngine(net, n_slots=2, component_prefix="g_mid")
    before = _addresses(eng)
    late_futs = []
    fired = threading.Event()

    def on_token(_tok):
        # request 1 finishes after 3 tokens; request 0 is mid-decode: the
        # late requests take request 1's slot, whose carry rows are dirty
        if not fired.is_set():
            fired.set()
            late_futs.extend(eng.generate(p, max_new_tokens=m) for p, m in late)

    try:
        futs = [eng.generate(first[0][0], max_new_tokens=first[0][1], on_token=on_token),
                eng.generate(first[1][0], max_new_tokens=first[1][1])]
        outs = [f.result(120) for f in futs]
        assert fired.wait(10)
        outs += [f.result(120) for f in late_futs]
        carry = {i: {k: a.clone() for k, a in st.items()} for i, st in eng._carry.items()}
    finally:
        eng.shutdown()
    assert outs == refs
    assert _addresses(eng) == before
    assert all(bool(torch.isfinite(a).all()) for st in carry.values() for a in st.values())


def test_capture_tallies_are_counted_on_replay_only():
    fl.reset_launch_counts()
    reg = metrics.get_registry()

    def hits():
        fam = reg.get("helper_hit_total")
        if fam is None:
            return 0.0
        return sum(c.value for labels, c in fam.children()
                   if labels[0] == "lstm_decode_step" and labels[1] == "tally_test")

    h0 = hits()
    with fl.recording_launches() as launches, helpers.recording_events() as events:
        fl._bump("lstm_step")
        fl._bump("lstm_step")
        helpers._count("helper_hit_total", "lstm_decode_step", "tally_test", "lstm_step")
    assert launches == {"lstm_step": 2}
    assert events == [("helper_hit_total", "lstm_decode_step", "tally_test", "lstm_step", None)]
    assert fl.launch_counts()["lstm_step"] == 0 and hits() == h0  # the capture counts nothing
    for _ in range(3):  # three replays
        fl.add_launches(launches)
        helpers.replay_events(events)
    assert fl.launch_counts()["lstm_step"] == 6
    assert hits() == h0 + 3
    fl._bump("lstm_step")  # outside a capture: counted at once
    assert fl.launch_counts()["lstm_step"] == 7
    fl.reset_launch_counts()


def test_recording_is_per_thread():
    fl.reset_launch_counts()
    seen = []
    with fl.recording_launches() as launches:
        t = threading.Thread(target=lambda: (fl._bump("lstm_step"),
                                             seen.append(fl.launch_counts()["lstm_step"])))
        t.start()
        t.join()
        fl._bump("lstm_step")
    assert seen == [1] and launches == {"lstm_step": 1}
    fl.reset_launch_counts()


def test_decode_step_helper_hits_count_each_step_on_the_plain_kernel(monkeypatch):
    """With the step kernel's probe taking CPU tensors, every step of the
    static program consults it once per LSTM layer: helper_hit_total
    counts 2 a step at K = 1 and 8 a window at K = 4."""
    from deeplearning4j_tpu_torch.ops import cuda_build

    monkeypatch.setattr(cuda_build, "on_hopper", lambda device=None: True)
    _, net = _nets(layers=2)
    reg = metrics.get_registry()

    def hits():
        fam = reg.get("helper_hit_total")
        return 0.0 if fam is None else sum(
            c.value for labels, c in fam.children() if labels[0] == "lstm_decode_step")

    for K in (1, 4):
        eng = DecodeEngine(net, n_slots=2, component_prefix=f"g_hits{K}").set_fused_steps(K)
        try:
            eng.warmup()
            h = hits()
            for _ in range(3):
                eng._run_program()
            assert hits() - h == 3 * 2 * K
        finally:
            eng.shutdown()
