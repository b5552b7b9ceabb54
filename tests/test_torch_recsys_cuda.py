"""The parameter-server path and the run ledger on a Hopper GPU (`cuda`
marker; each test skips itself without one): the recsys tower over two
in-process parameter servers, pipelined and synchronous, byte-equal on
the card and within rtol 1e-4 / atol 1e-6 of the CPU (f32, TF32 off);
the recsys preset's fit on the card with run_ledger= and a
PerformanceListener. chip_smoke.py phase 14 runs the same at full size.

This file imports nothing of JAX, so it runs where JAX is not installed:
`python -m pytest --noconftest tests/test_torch_recsys_cuda.py`.
"""

import numpy as np
import pytest
import torch

from deeplearning4j_tpu_torch.data.recsys import zipf_batches, zipf_cdf, zipf_ids
from deeplearning4j_tpu_torch.models.recsys import (
    TOWER_KEYS,
    recsys_conf,
    recsys_network,
    tower_init,
    train_over_paramserver,
)

RTOL, ATOL = 1e-4, 1e-6
VOCAB, DIM, HIDDEN, BATCH, STEPS = 50_000, 64, 192, 512, 8


@pytest.fixture(autouse=True)
def _require_hopper():
    if not (torch.cuda.is_available()
            and torch.cuda.get_device_capability() >= (9, 0)):
        pytest.skip("needs an NVIDIA GPU of compute capability >= 9.0")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _stream():
    cdf = zipf_cdf(VOCAB, 1.1)
    batches = [zipf_ids(BATCH, VOCAB, 1.1, seed=k, cdf=cdf) for k in range(STEPS + 1)]
    return batches, [(b & 1).astype(np.int64) for b in batches]


@pytest.mark.cuda
def test_tower_over_the_paramserver_card_against_cpu_and_arms_byte_equal():
    batches, labels = _stream()
    p0 = tower_init(DIM, HIDDEN, generator=torch.Generator().manual_seed(0), device="cpu")
    runs = {}
    for name, dev, kw in (("cpu", "cpu", {}), ("sync", "cuda", {}),
                          ("piped", "cuda", dict(prefetch=True, cache_rows=4096))):
        runs[name] = train_over_paramserver(
            np.zeros((VOCAB, DIM), np.float32), batches, labels,
            {k: v.to(dev) for k, v in p0.items()}, lr=0.05, **kw)
    for k in TOWER_KEYS:
        assert torch.equal(runs["sync"]["params"][k], runs["piped"]["params"][k]), k
        torch.testing.assert_close(runs["sync"]["params"][k].cpu(), runs["cpu"]["params"][k],
                                   rtol=RTOL, atol=ATOL)
    for a, b, c in zip(runs["sync"]["tables"], runs["piped"]["tables"], runs["cpu"]["tables"]):
        assert np.array_equal(a.view(np.uint32), b.view(np.uint32))
        np.testing.assert_allclose(a, c, rtol=RTOL, atol=ATOL)
    st = runs["piped"]["stats"]
    assert st["pull_rows"] == st["cache_hit"] + st["cache_miss"] and st["cache_hit"] > 0


@pytest.mark.cuda
def test_recsys_fit_on_the_card_records_a_ledger(tmp_path):
    from deeplearning4j_tpu_torch.data import DataSet, ExistingDataSetIterator
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    from deeplearning4j_tpu_torch.train.listeners import PerformanceListener
    from deeplearning4j_tpu_torch.utils import runledger

    net = recsys_network(host_resident=False, vocab=VOCAB, device="cuda")
    stream = zipf_batches(BATCH, VOCAB, 1.2, seed=1)
    data = []
    for _ in range(10):
        ids, lab = next(stream)
        data.append(DataSet(ids.reshape(-1, 1).astype(np.float32),
                            np.eye(2, dtype=np.float32)[lab]))
    cpu = MultiLayerNetwork(recsys_conf(host_resident=False, vocab=VOCAB), device="cpu").init()
    cpu.params_list = [{k: v.cpu().clone() for k, v in p.items()} for p in net.params_list]
    cpu.fit(ExistingDataSetIterator(data[:3]), async_prefetch=False)

    lines = []
    path = str(tmp_path / "fit.jsonl")
    net.set_listeners(PerformanceListener(frequency=3, print_fn=lines.append))
    card = MultiLayerNetwork(recsys_conf(host_resident=False, vocab=VOCAB), device="cuda").init()
    card.params_list = [{k: v.clone() for k, v in p.items()} for p in net.params_list]
    card.fit(ExistingDataSetIterator(data[:3]), async_prefetch=False)
    for pc, pg in zip(cpu.params_list, card.params_list):
        for k in pc:
            torch.testing.assert_close(pg[k].cpu(), pc[k], rtol=RTOL, atol=ATOL)

    net.fit(ExistingDataSetIterator(data), run_ledger=path)
    assert runledger.current() is None
    doc = runledger.read_ledger(path)
    man = doc["manifest"]
    assert man["devices"]["platform"] == "gpu"
    assert man["devices"]["device_kind"] == torch.cuda.get_device_name(0)
    assert man["flops_source"] == "analytic"
    samples = list(runledger.iter_samples(doc))
    assert samples[-1][1]["fit_step_total"] - samples[0][1].get("fit_step_total", 0) == 10
    mfus = [float(ln.rsplit("mfu ", 1)[1]) for ln in lines if "mfu " in ln]
    assert mfus and all(0 < m <= 1 for m in mfus), lines
