"""The recsys preset and FLOP accounting in the port
(deeplearning4j_tpu_torch/data/recsys.py, models/recsys.py,
utils/flops.py, PerformanceListener's MFU column) against the JAX
package: zipf traffic bit-equal, the analytic step FLOPs equal for the
lenet, charlstm, resnet50, vgg16 and recsys presets, no MFU on the CPU,
and `recsys_network(host_resident=False)` trained 3 steps from carried
weights equal to the JAX net's to rtol 1e-5 (the f32_step tolerance of
tests/torch_parity.py; JAX runs its matmuls at "highest")."""

import importlib

import numpy as np
import pytest
import torch

from deeplearning4j_tpu.data import recsys as jrec
from deeplearning4j_tpu.utils import flops as jflops
from deeplearning4j_tpu_torch.data import recsys as trec
from deeplearning4j_tpu_torch.utils import flops as tflops
from tests.torch_parity import assert_params_close, port_twin


def test_zipf_stream_is_bit_equal_to_the_jax_module():
    for vocab, alpha in ((1, 1.2), (97, 1.1), (800_000, 1.1), (5000, 2.5)):
        assert trec.zipf_cdf(vocab, alpha).tobytes() == jrec.zipf_cdf(vocab, alpha).tobytes()
    cdf = trec.zipf_cdf(10_000, 1.3)
    for seed in (0, 7, 123456):
        a = trec.zipf_ids(4096, 10_000, 1.3, seed=seed, cdf=cdf)
        b = jrec.zipf_ids(4096, 10_000, 1.3, seed=seed)
        assert a.dtype == b.dtype == np.int64 and a.tobytes() == b.tobytes()
    tb, jb = trec.zipf_batches(256, 3000, 1.2, seed=5), jrec.zipf_batches(256, 3000, 1.2, seed=5)
    for _ in range(4):
        (ti, tl), (ji, jl) = next(tb), next(jb)
        assert ti.tobytes() == ji.tobytes() and tl.tobytes() == jl.tobytes()
        assert tl.dtype == jl.dtype == np.int32
    words = np.random.default_rng(3).integers(-2 ** 63, 2 ** 63 - 1, 10_000, dtype=np.int64)
    words[:4] = (0, -1, 2 ** 63 - 1, -2 ** 63)
    assert trec._popcount64(words).tobytes() == jrec._popcount64(words).tobytes()
    with pytest.raises(ValueError):
        trec.zipf_cdf(0)


PRESETS = {"lenet": ("lenet", "lenet_conf"), "charlstm": ("charlstm", "char_lstm_conf"),
           "resnet50": ("resnet", "resnet50_conf"), "vgg16": ("vgg16", "vgg16_conf"),
           "recsys": ("recsys", "recsys_conf")}


def _preset_conf(package, preset):
    module, fn = PRESETS[preset]
    return getattr(importlib.import_module(f"{package}.models.{module}"), fn)()


@pytest.mark.parametrize("preset", sorted(PRESETS))
def test_analytic_step_flops_equal_the_jax_count(preset):
    tconf = _preset_conf("deeplearning4j_tpu_torch", preset)
    jconf = _preset_conf("deeplearning4j_tpu", preset)
    got = tflops.analytic_step_flops_per_example(tconf)
    assert got == jflops.analytic_step_flops_per_example(jconf)
    assert tflops.forward_flops(tconf) == jflops.forward_flops(jconf)
    expect = {"resnet50": 24_535_105_536.0, "recsys": 148_992.0}
    if preset in expect:
        assert got == (expect[preset], "analytic")
    if preset == "charlstm":  # no fixed timestep count: no per-example number
        assert got == (None, "analytic")


def test_train_step_flops_for_prices_the_timesteps_as_the_jax_fallback():
    from deeplearning4j_tpu.models.charlstm import char_lstm_conf as jchar_lstm_conf
    from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JMLN
    from deeplearning4j_tpu_torch.models.charlstm import char_lstm_conf
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork

    tnet = MultiLayerNetwork(char_lstm_conf(vocab_size=11, hidden=8), device="cpu").init()
    jnet = JMLN(jchar_lstm_conf(vocab_size=11, hidden=8)).init()
    got = tflops.train_step_flops_for(tnet, 4, timesteps=50)
    assert got == jflops.train_step_flops_for(jnet, 4, timesteps=50,
                                              prefer_cost_model=False)
    # two GravesLSTM layers (11 -> 8, 8 -> 8) and the 8 -> 11 head, a step
    assert got[0] == 3 * 4 * 50 * (2 * 4 * 8 * (11 + 8) + 2 * 4 * 8 * (8 + 8) + 2 * 8 * 11)


def test_device_figures_are_none_on_the_cpu_unless_overridden(monkeypatch):
    for var in ("BENCH_PEAK_FLOPS", "BENCH_HBM_BYTES", "BENCH_HBM_BANDWIDTH",
                "BENCH_LINK_BANDWIDTH"):
        monkeypatch.delenv(var, raising=False)
    cpu = torch.device("cpu")
    assert tflops.peak_flops_per_chip(cpu) is None
    assert tflops.peak_hbm_bytes_per_chip(cpu) is None
    assert tflops.hbm_bandwidth_per_chip(cpu) is None
    assert tflops.link_bandwidth_per_chip(cpu) is None
    monkeypatch.setenv("BENCH_PEAK_FLOPS", "1e15")
    assert tflops.peak_flops_per_chip(cpu) == 1e15
    # one home for the H100 figures chip_smoke.py bounds its kernels with
    assert dict(tflops.PEAK_BF16_FLOP_PER_S)["H100"] == 989e12
    assert dict(tflops.HBM_BYTES_PER_S)["H100"] == 3.35e12


def test_performance_listener_mfu_is_none_on_the_cpu():
    from deeplearning4j_tpu_torch.models.recsys import recsys_network
    from deeplearning4j_tpu_torch.train.listeners import PerformanceListener

    net = recsys_network(vocab=100, dim=4, hidden=8, device="cpu")
    lines = []
    lst = PerformanceListener(frequency=2, print_fn=lines.append)
    net.set_listeners(lst)
    rng = np.random.default_rng(0)
    x = rng.integers(0, 100, (32, 1)).astype(np.float32)
    y = np.eye(2, dtype=np.float32)[(x[:, 0].astype(np.int64) & 1)]
    net.fit(x, y, batch_size=4, async_prefetch=False)
    assert lines and not any("mfu" in s for s in lines)
    assert net.model_flops_per_example() == (3 * 2.0 * (4 * 8 + 8 * 8 + 8 * 2), "analytic")
    assert lst._window_mfu(net, 1.0) is None


def test_recsys_network_trains_like_the_jax_net(tmp_path):
    from deeplearning4j_tpu.data.dataset import DataSet as JDataSet
    from deeplearning4j_tpu.models.recsys import recsys_network as jrecsys_network
    from deeplearning4j_tpu_torch.data import DataSet

    jnet = jrecsys_network(host_resident=False, vocab=1000)
    tnet = port_twin(jnet, tmp_path)
    assert tnet.layer_confs[0].host_resident is False
    ids, labels = next(trec.zipf_batches(96, 1000, 1.1, seed=2))
    x = ids.reshape(-1, 1).astype(np.float32)
    y = np.eye(2, dtype=np.float32)[labels]
    jnet.fit(JDataSet(x, y), epochs=1, batch_size=32, async_prefetch=False)
    tnet.fit(DataSet(x, y), epochs=1, batch_size=32, async_prefetch=False)
    assert tnet.iteration == jnet.iteration == 3
    assert_params_close(jnet, tnet, "f32_step")
    np.testing.assert_allclose(float(tnet.score(DataSet(x, y))),
                               float(jnet.score(JDataSet(x, y))), rtol=1e-5)
