"""The port's record readers (data/records.py), streaming iterator
(data/streaming.py), the CIFAR, Iris and LFW fetchers with their
synthetic fallbacks (data/fetchers.py) and the MultipleEpochsIterator and
StackedDataSetIterator (data/iterators.py) against the JAX package's on
the same seeds and sources: the same batches, bit for bit (both are host
numpy). Every fetcher runs with allow_download=False and an empty cache
directory.
"""

import io

import numpy as np
import pytest

from deeplearning4j_tpu.data import fetchers as jfetchers
from deeplearning4j_tpu.data import iterators as jiterators
from deeplearning4j_tpu.data import records as jrecords
from deeplearning4j_tpu.data.dataset import DataSet as JDataSet
from deeplearning4j_tpu_torch.data import (
    DataSet,
    ListDataSetIterator,
    MultipleEpochsIterator,
    StackedDataSetIterator,
)
from deeplearning4j_tpu_torch.data import fetchers, records
from deeplearning4j_tpu_torch.data.streaming import StreamingDataSetIterator


@pytest.fixture(autouse=True)
def _no_cache(tmp_path, monkeypatch):
    monkeypatch.setenv("DL4J_TPU_DATA", str(tmp_path / "empty"))


def _same_batches(a, b):
    a, b = list(a), list(b)
    assert len(a) == len(b)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x.features, y.features)
        np.testing.assert_array_equal(x.labels, y.labels)


def test_cifar_synthetic_fallback_matches_the_jax_package():
    it = fetchers.CifarDataSetIterator(
        32, train=True, fetcher=fetchers.CifarDataFetcher(
            allow_download=False, synthetic_n=128))
    jit = jfetchers.CifarDataSetIterator(
        32, train=True, fetcher=jfetchers.CifarDataFetcher(
            allow_download=False, synthetic_n=128))
    assert it.source == jit.source == "synthetic"
    batches = list(it)
    assert len(batches) == 4
    assert batches[0].features.shape == (32, 32, 32, 3)
    assert batches[0].labels.shape == (32, 10)
    _same_batches(batches, jit)
    x, y = fetchers.CifarDataFetcher(allow_download=False,
                                     synthetic_n=64).load(train=False)
    jx, jy = jfetchers.synthetic_cifar(64, seed=2)
    np.testing.assert_array_equal(x, jx)
    np.testing.assert_array_equal(y, jy)


def test_iris_matches_the_jax_package():
    _same_batches(fetchers.IrisDataSetIterator(50),
                  jfetchers.IrisDataSetIterator(50))
    x, y = fetchers.iris_data(seed=3)
    jx, jy = jfetchers.iris_data(seed=3)
    np.testing.assert_array_equal(x, jx)
    assert y.sum(axis=0).tolist() == [50.0, 50.0, 50.0]


def test_lfw_synthetic_fallback_matches_the_jax_package():
    kw = dict(allow_download=False, synthetic_n=64, num_labels=5, image_size=32)
    it = fetchers.LFWDataSetIterator(16, train=True,
                                     fetcher=fetchers.LFWDataFetcher(**kw))
    jit = jfetchers.LFWDataSetIterator(16, train=True,
                                       fetcher=jfetchers.LFWDataFetcher(**kw))
    assert it.source == "synthetic"
    ds = next(iter(it))
    assert ds.features.shape == (16, 32, 32, 3) and ds.labels.shape == (16, 5)
    _same_batches(it, jit)
    with pytest.raises(RuntimeError, match="fallback disabled"):
        fetchers.LFWDataFetcher(allow_download=False,
                                synthetic_fallback=False).load(True)


_CSV = "sepal_l,sepal_w,label\n" + "\n".join(
    f"{i / 10:.1f},{(i * 3 % 7) / 10:.1f},{i % 3}" for i in range(10))


def test_csv_record_reader_classification_matches_the_jax_package():
    it = records.RecordReaderDataSetIterator(
        records.CSVRecordReader(io.StringIO(_CSV), skip_lines=1),
        batch_size=4, label_index=2, num_classes=3)
    jit = jrecords.RecordReaderDataSetIterator(
        jrecords.CSVRecordReader(io.StringIO(_CSV), skip_lines=1),
        batch_size=4, label_index=2, num_classes=3)
    batches = list(it)
    assert [b.features.shape[0] for b in batches] == [4, 4, 2]
    np.testing.assert_allclose(batches[0].features[1], [0.1, 0.3])
    assert batches[0].labels[1].argmax() == 1
    _same_batches(batches, jit)
    assert len(list(it)) == 3  # iterating again re-reads the source


def test_csv_record_reader_from_a_path(tmp_path):
    p = tmp_path / "d.csv"
    p.write_text(_CSV)
    it = records.RecordReaderDataSetIterator(
        records.CSVRecordReader(str(p), skip_lines=1), 3, label_index=2,
        num_classes=3)
    jit = jrecords.RecordReaderDataSetIterator(
        jrecords.CSVRecordReader(str(p), skip_lines=1), 3, label_index=2,
        num_classes=3)
    _same_batches(it, jit)


def test_record_reader_regression_and_validation():
    recs = [[1.0, 2.0, 3.0, 4.0], [5.0, 6.0, 7.0, 8.0]]
    it = records.RecordReaderDataSetIterator(
        records.CollectionRecordReader(recs), 2,
        label_index_from=2, label_index_to=3)
    b = next(iter(it))
    np.testing.assert_allclose(b.features, [[1, 2], [5, 6]])
    np.testing.assert_allclose(b.labels, [[3, 4], [7, 8]])
    _same_batches(it, jrecords.RecordReaderDataSetIterator(
        jrecords.CollectionRecordReader(recs), 2,
        label_index_from=2, label_index_to=3))
    with pytest.raises(ValueError):
        records.RecordReaderDataSetIterator(
            records.CollectionRecordReader(recs), 2)


def _stream(produced=None):
    rng = np.random.default_rng(0)
    for _ in range(6):
        x = rng.standard_normal((8, 4)).astype(np.float32)
        y = np.zeros((8, 2), np.float32)
        y[np.arange(8), rng.integers(0, 2, 8)] = 1.0
        if produced is not None:
            produced.append(x)
        yield x, y


def test_streaming_iterator_trains_and_cannot_rewind():
    from deeplearning4j_tpu_torch.nn.conf import (
        DenseLayer, InputType, NeuralNetConfiguration, OutputLayer)
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork

    produced = []
    it = StreamingDataSetIterator(_stream(produced), buffer_size=2)
    conf = (NeuralNetConfiguration.builder().seed(0).list()
            .layer(DenseLayer(n_out=8, activation="tanh"))
            .layer(OutputLayer(n_out=2, activation="softmax", loss="mcxent"))
            .set_input_type(InputType.feed_forward(4)).build())
    net = MultiLayerNetwork(conf, device="cpu").init()
    net.fit(it, epochs=1, async_prefetch=False)
    assert net.iteration == 6 and len(produced) == 6
    with pytest.raises(RuntimeError, match="already consumed"):
        list(it)


def test_streaming_iterator_yields_the_sources_batches_and_errors():
    from deeplearning4j_tpu.data.streaming import (
        StreamingDataSetIterator as JStream)

    _same_batches(StreamingDataSetIterator(_stream()), JStream(_stream()))
    payloads = iter([(np.ones((2, 3), np.float32), np.ones((2, 1), np.float32)),
                     None])
    got = list(StreamingDataSetIterator(lambda: next(payloads)))
    assert len(got) == 1 and got[0].features.shape == (2, 3)

    def bad():
        yield (np.zeros((2, 4), np.float32), np.zeros((2, 2), np.float32))
        raise OSError("kafka broke")

    with pytest.raises(OSError, match="kafka broke"):
        list(StreamingDataSetIterator(bad()))


def _data(n=20, seed=4):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n, 3)).astype(np.float32),
            rng.standard_normal((n, 2)).astype(np.float32))


def test_multiple_epochs_iterator_matches_the_jax_package():
    x, y = _data()
    it = MultipleEpochsIterator(3, ListDataSetIterator(DataSet(x, y), 8,
                                                       shuffle=True, seed=1))
    jit = jiterators.MultipleEpochsIterator(
        3, jiterators.ListDataSetIterator(JDataSet(x, y), 8, shuffle=True, seed=1))
    batches = list(it)
    assert len(batches) == 9 and it.batch_size() == 8
    _same_batches(batches, jit)
    assert it.state() == jit.state()


def test_stacked_iterator_matches_the_jax_package():
    x, y = _data()
    it = StackedDataSetIterator(ListDataSetIterator(DataSet(x, y), 4), 2)
    jit = jiterators.StackedDataSetIterator(
        jiterators.ListDataSetIterator(JDataSet(x, y), 4), 2)
    batches = list(it)
    assert [b.num_examples() for b in batches] == [8, 8, 4]
    assert it.batch_size() == 8 and it.total_examples() == 20
    _same_batches(batches, jit)
    it.reset()
    _same_batches(it, batches)
