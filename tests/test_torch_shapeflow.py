"""The port's shapeflow (deeplearning4j_tpu_torch/analysis/shapeflow.py)
against the JAX package's: the same configurations — the model presets
and every broken configuration of the JAX package's tests/test_analysis.py
— go through both packages' `check_configuration` and `propagate_types`,
and the findings (code, severity, location, message) and the propagated
InputTypes must be equal. Then the doctor surface built on it: doctor
errors, the import preflight report and `net.doctor()`'s no-raise
contract. Pure configuration walking: no params, no device.
"""

from __future__ import annotations

import dataclasses
import logging

import pytest

import deeplearning4j_tpu.nn.conf as JC
import deeplearning4j_tpu_torch.nn.conf as TC
from deeplearning4j_tpu.analysis import shapeflow as jsf
from deeplearning4j_tpu.nn.conf.graph import ComputationGraphConfiguration as JCG
from deeplearning4j_tpu.nn.conf.network import MultiLayerConfiguration as JML
from deeplearning4j_tpu_torch.analysis import (
    ERROR,
    doctor_errors,
    preflight_report,
)
from deeplearning4j_tpu_torch.analysis import shapeflow as tsf
from deeplearning4j_tpu_torch.nn.conf.graph import ComputationGraphConfiguration as TCG
from deeplearning4j_tpu_torch.nn.conf.network import MultiLayerConfiguration as TML

PKG = {"jax": (JC, JML, JCG), "torch": (TC, TML, TCG)}


# -- the broken configurations of the JAX package's tests/test_analysis.py -------
# each builder takes (conf module, MultiLayerConfiguration,
# ComputationGraphConfiguration) and builds the same conf in that package


def _gb(C, *input_types, names=("in",)):
    gb = C.NeuralNetConfiguration.builder().graph_builder().add_inputs(*names)
    if input_types:
        gb.set_input_types(*input_types)
    return gb


def nin_mismatch(C, ML, CG):
    return ML(layers=[C.DenseLayer(n_in=10, n_out=5), C.OutputLayer(n_in=7, n_out=3)],
              input_type=C.InputType.feed_forward(10))


def unset_nout(C, ML, CG):
    return ML(layers=[C.DenseLayer(n_in=4, n_out=0), C.OutputLayer(n_in=0, n_out=3)],
              input_type=C.InputType.feed_forward(4))


def no_inputtype_conv_producer(C, ML, CG):
    return ML(layers=[C.ConvolutionLayer(n_in=3, n_out=8),
                      C.DenseLayer(n_in=288, n_out=10), C.OutputLayer(n_in=10, n_out=3)])


def no_inputtype_dense_miswired(C, ML, CG):
    return ML(layers=[C.DenseLayer(n_in=4, n_out=8), C.OutputLayer(n_in=9, n_out=3)])


def family_mismatch(C, ML, CG):
    return ML(layers=[C.ConvolutionLayer(n_in=3, n_out=4), C.OutputLayer(n_in=4, n_out=3)],
              input_type=C.InputType.feed_forward(12))


def missing_loss_head(C, ML, CG):
    return ML(layers=[C.DenseLayer(n_in=4, n_out=2)], input_type=C.InputType.feed_forward(4))


def merge_fanin(C, ML, CG):
    gb = _gb(C, C.InputType.convolutional(8, 8, 3), C.InputType.convolutional(4, 4, 3),
             names=("a", "b"))
    gb.add_vertex("m", C.MergeVertex(), "a", "b")
    gb.add_layer("out", C.OutputLayer(n_out=2), "m")
    gb.set_outputs("out")
    return gb.build()


def dead_vertex(C, ML, CG):
    gb = _gb(C, C.InputType.feed_forward(6))
    gb.add_layer("h", C.DenseLayer(n_out=4), "in")
    gb.add_layer("side", C.DenseLayer(n_out=3), "in")
    gb.add_layer("out", C.OutputLayer(n_out=2), "h")
    gb.set_outputs("out")
    return gb.build()


def cyclic(C, ML, CG):
    return CG(inputs=["in"], outputs=["out"],
              vertices={"a": C.LayerVertex(layer=C.DenseLayer(n_in=4, n_out=4)),
                        "out": C.LayerVertex(layer=C.OutputLayer(n_in=4, n_out=2))},
              vertex_inputs={"a": ["a"], "out": ["a"]})


def subset_out_of_range(C, ML, CG):
    gb = _gb(C, C.InputType.convolutional(8, 8, 4))
    gb.add_vertex("sub", C.SubsetVertex(from_=0, to=10), "in")
    gb.add_layer("out", C.OutputLayer(n_out=2), "sub")
    gb.set_outputs("out")
    return gb.build()


def elementwise_conflict(C, ML, CG):
    gb = _gb(C, C.InputType.feed_forward(6))
    gb.add_layer("a", C.DenseLayer(n_out=4), "in")
    gb.add_layer("b", C.DenseLayer(n_out=5), "in")
    gb.add_vertex("add", C.ElementWiseVertex(op="add"), "a", "b")
    gb.add_layer("out", C.OutputLayer(n_out=2), "add")
    gb.set_outputs("out")
    return gb.build()


BROKEN = {f.__name__: f for f in (
    nin_mismatch, unset_nout, no_inputtype_conv_producer, no_inputtype_dense_miswired,
    family_mismatch, missing_loss_head, merge_fanin, dead_vertex, cyclic,
    subset_out_of_range, elementwise_conflict)}

# the code each must raise at ERROR (JAX tests/test_analysis.py), or the
# warning-grade code
EXPECT = {"nin_mismatch": ("SF001", ERROR), "unset_nout": ("SF001", ERROR),
          "no_inputtype_dense_miswired": ("SF001", ERROR),
          "family_mismatch": ("SF002", ERROR), "missing_loss_head": ("SF007", "warning"),
          "merge_fanin": ("SF003", ERROR), "dead_vertex": ("SF004", "warning"),
          "cyclic": ("SF004", ERROR), "subset_out_of_range": ("SF005", ERROR),
          "elementwise_conflict": ("SF005", ERROR)}


def _presets(pkg):
    if pkg == "jax":
        from deeplearning4j_tpu.models import charlstm, lenet, recsys, resnet, vgg16
    else:
        from deeplearning4j_tpu_torch.models import charlstm, lenet, recsys, resnet, vgg16
    return {
        "resnet50": resnet.resnet50_conf(),
        "resnet50_bf16": resnet.resnet50_conf(precision="bf16"),
        "tiny_resnet": resnet.tiny_resnet_conf(),
        "charlstm": charlstm.char_lstm_conf(),
        "charlstm_bf16": charlstm.char_lstm_conf(precision="bf16"),
        "lenet": lenet.lenet_conf(),
        "vgg16": vgg16.vgg16_conf(),
        "recsys": recsys.recsys_conf(),
    }


def _findings(fs):
    return [(f.code, f.severity, f.location, f.message, f.fix_hint, f.name) for f in fs]


def _type(it):
    if it is None:
        return None
    return (type(it).__name__, dataclasses.asdict(it))


def _types(out):
    if isinstance(out, dict):
        return {k: _type(v) for k, v in out.items()}
    return [_type(v) for v in out]


@pytest.mark.parametrize("name", sorted(BROKEN))
def test_broken_confs_find_what_the_jax_package_finds(name):
    j = jsf.check_configuration(BROKEN[name](*PKG["jax"]))
    t = tsf.check_configuration(BROKEN[name](*PKG["torch"]))
    assert _findings(t) == _findings(j)
    if name in EXPECT:
        code, sev = EXPECT[name]
        assert (code, sev) in [(f.code, f.severity) for f in t]
    else:  # the conv producer without an InputType: not a false SF001
        assert "SF001" not in [f.code for f in t if f.severity == ERROR]


@pytest.mark.parametrize("name", sorted(BROKEN))
def test_broken_confs_propagate_like_the_jax_package(name):
    j = jsf.propagate_types(BROKEN[name](*PKG["jax"]))
    t = tsf.propagate_types(BROKEN[name](*PKG["torch"]))
    assert _types(t) == _types(j)


@pytest.mark.parametrize("preset", sorted(_presets("torch")))
def test_presets_are_clean_alike(preset):
    jconf, tconf = _presets("jax")[preset], _presets("torch")[preset]
    j, t = jsf.check_configuration(jconf), tsf.check_configuration(tconf)
    assert _findings(t) == _findings(j)
    assert not [f for f in t if f.severity == ERROR]
    # clean means no finding but the bf16 loss-head promotion point, which
    # is informational (vgg16 computes in bf16 by default)
    assert all(f.code == "SF006" and f.severity == "info" for f in t)
    if preset.endswith("bf16"):
        assert [f.code for f in t] == ["SF006"]
    assert _types(tsf.propagate_types(tconf)) == _types(jsf.propagate_types(jconf))


def test_check_configuration_refuses_other_types():
    with pytest.raises(TypeError, match="MultiLayerConfiguration"):
        tsf.check_configuration(object())


def test_doctor_errors_and_preflight_report(caplog):
    broken = nin_mismatch(*PKG["torch"])
    assert [f.code for f in doctor_errors(broken)] == ["SF001"]
    with caplog.at_level(logging.WARNING, logger="deeplearning4j_tpu_torch"):
        fs = preflight_report(broken, origin="test.zip")
    assert fs and "import preflight [test.zip]" in caplog.text
    # never raises, even on garbage
    assert preflight_report(object(), origin="junk") == []


def test_import_preflight_rides_the_dl4j_import_path(tmp_path):
    """Both DL4J importers attach the free preflight report."""
    from deeplearning4j_tpu_torch.modelimport.dl4j import (
        export_dl4j_zip,
        import_dl4j_multilayer,
    )
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork

    conf = (TC.NeuralNetConfiguration.builder().seed(7).list()
            .layer(TC.DenseLayer(n_out=5, activation="tanh"))
            .layer(TC.OutputLayer(n_out=3, activation="softmax"))
            .set_input_type(TC.InputType.feed_forward(4)).build())
    path = str(tmp_path / "m.zip")
    export_dl4j_zip(MultiLayerNetwork(conf, device="cpu").init(), path)
    imported = import_dl4j_multilayer(path, device="cpu")
    assert imported.import_preflight == []


def test_import_preflight_rides_the_dl4j_graph_import_path():
    """The graph importer attaches it too, equal to the JAX importer's on
    the same zip (tests/fixtures/cg_adam_v1.zip)."""
    import os

    from deeplearning4j_tpu.modelimport.dl4j import (
        import_dl4j_computation_graph as jimport,
    )
    from deeplearning4j_tpu_torch.modelimport.dl4j import import_dl4j_computation_graph

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures",
                        "cg_adam_v1.zip")
    got = import_dl4j_computation_graph(path, device="cpu").import_preflight
    assert _findings(got) == _findings(jimport(path).import_preflight)
    assert not [f for f in got if f.severity == ERROR]


def test_import_preflight_of_the_keras_config_path_matches_the_jax_package():
    from deeplearning4j_tpu.modelimport import keras as jkeras
    from deeplearning4j_tpu_torch.modelimport import keras as tkeras
    from deeplearning4j_tpu_torch.models.vgg16 import vgg16_keras_config

    cfg = vgg16_keras_config(num_classes=10, image_size=32)
    tconf, _ = tkeras.import_keras_sequential_config(cfg)
    jconf, _ = jkeras.import_keras_sequential_config(cfg)
    got = preflight_report(tconf, origin="vgg16.json")
    assert _findings(got) == _findings(jsf.check_configuration(jconf))
    # an inference-only archive: no loss head, nothing worse
    assert [f.code for f in got] == ["SF007"]


def test_doctor_never_raises_on_warning_grade_configs():
    """A config whose only defect is warning-grade (no loss head) makes the
    step trace fail: the doctor reports that as a finding (JX000), never
    crashes."""
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork

    conf = (TC.NeuralNetConfiguration.builder().list()
            .layer(TC.DenseLayer(n_out=4))
            .set_input_type(TC.InputType.feed_forward(3)).build())
    fs = MultiLayerNetwork(conf, device="cpu").init().doctor()
    codes = [f.code for f in fs]
    assert "SF007" in codes and "JX000" in codes
    assert not [f for f in fs if f.severity == ERROR]


def test_doctor_stops_at_config_errors():
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork

    conf = (TC.NeuralNetConfiguration.builder().list()
            .layer(TC.DenseLayer(n_in=3, n_out=4))
            .layer(TC.OutputLayer(n_in=5, n_out=2))
            .set_input_type(TC.InputType.feed_forward(3)).build())
    fs = MultiLayerNetwork(conf, device="cpu").init().doctor()
    assert [f.code for f in fs] == ["SF001"]
