"""Keras 1.x HDF5 importer.

The port of the JAX package's modelimport/keras.py (reference:
deeplearning4j-modelimport — KerasModelImport.java:39 (static entry
points), KerasModel.java:73-75,550-556 (HDF5 attrs ``model_config`` /
``training_config`` / ``model_weights`` root), KerasLayer.java (the layer
dispatcher and field vocabulary), the per-layer translators under
``layers/``, and the dim-ordering transposes in
KerasConvolution.setWeights (KerasConvolution.java:108-138) and
KerasLstm.setWeights (KerasLstm.java:138-178)). The same configurations,
layer names and parameters as the JAX importer.

- The port's conv layout is NHWC with HWIO kernels, the TensorFlow-backend
  Keras layout, so ``dim_ordering: "tf"`` weights copy with NO transpose.
  Theano ordering stores OIHW *and* applies true convolution, so those
  kernels are rotated 180 degrees spatially, then transposed to HWIO.
- Keras ``Flatten`` on NHWC activations is row-major over (H, W, C), as
  the port's CnnToFeedForwardPreProcessor reshape.
- Keras LSTM stores 12 arrays (W/U/b x i,f,c,o); they are packed into the
  fused [nIn, 4H] / [H, 4H] / [4H] blocks in the port's [i|f|g|o] gate
  order (nn/layers/recurrent.py).
- The configuration-only entry points need nothing beyond the standard
  library and numpy; only the HDF5 archive reader imports h5py, when it
  is called. Each archive import attaches the free shape-flow preflight
  report (analysis.preflight_report: logged, and kept on
  `net.import_preflight`), as the JAX importer does.
"""

from __future__ import annotations

import json
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from deeplearning4j_tpu_torch.nn.conf import layers as L
from deeplearning4j_tpu_torch.nn.conf.graph import (
    ElementWiseVertex,
    MergeVertex,
    PreprocessorVertex,
)
from deeplearning4j_tpu_torch.nn.conf.inputs import (
    ConvolutionalInput,
    FeedForwardInput,
    RecurrentInput,
)
from deeplearning4j_tpu_torch.nn.conf.network import Builder
from deeplearning4j_tpu_torch.nn.conf.preprocessors import CnnToFeedForwardPreProcessor


class KerasImportError(Exception):
    """Invalid/unsupported Keras configuration
    (reference: InvalidKerasConfigurationException /
    UnsupportedKerasConfigurationException)."""


# --- field vocabulary (KerasLayer.java:46-120) ---

_ACTIVATIONS = {
    "softmax": "softmax",
    "softplus": "softplus",
    "softsign": "softsign",
    "relu": "relu",
    "tanh": "tanh",
    "sigmoid": "sigmoid",
    "hard_sigmoid": "hardsigmoid",
    "linear": "identity",
    "elu": "elu",
}

_LOSSES = {
    "mean_squared_error": "mse",
    "mse": "mse",
    "mean_absolute_error": "mean_absolute_error",
    "mae": "mean_absolute_error",
    "mean_absolute_percentage_error": "mean_absolute_percentage_error",
    "mape": "mean_absolute_percentage_error",
    "mean_squared_logarithmic_error": "mean_squared_logarithmic_error",
    "msle": "mean_squared_logarithmic_error",
    "squared_hinge": "squared_hinge",
    "hinge": "hinge",
    "binary_crossentropy": "xent",
    "categorical_crossentropy": "mcxent",
    "sparse_categorical_crossentropy": "mcxent",
    "kullback_leibler_divergence": "kl_divergence",
    "kld": "kl_divergence",
    "poisson": "poisson",
    "cosine_proximity": "cosine_proximity",
}

_INITS = {
    "uniform": "uniform",
    "zero": "zero",
    "glorot_normal": "xavier",
    "glorot_uniform": "xavier_uniform",
    "he_normal": "relu",
    "he_uniform": "relu_uniform",
    "lecun_uniform": "lecun_uniform",
    "normal": "normal",
    "identity": "identity",
}


def map_activation(name: Optional[str]) -> str:
    if name is None:
        return "identity"
    try:
        return _ACTIVATIONS[name]
    except KeyError:
        raise KerasImportError(f"Unsupported Keras activation: {name!r}")


def map_loss(name: str) -> str:
    try:
        return _LOSSES[name]
    except KeyError:
        raise KerasImportError(f"Unsupported Keras loss: {name!r}")


def map_init(name: Optional[str]) -> Optional[str]:
    if name is None:
        return None
    mapped = _INITS.get(name)
    if mapped is None:
        raise KerasImportError(f"Unsupported Keras weight init: {name!r}")
    return mapped


def _dl4j_dropout(cfg: dict) -> Optional[float]:
    """Keras dropout fraction -> retain probability
    (KerasLayer.getDropoutFromConfig: dropout = 1 - p)."""
    p = cfg.get("dropout", cfg.get("dropout_W", cfg.get("p", 0.0))) or 0.0
    return (1.0 - float(p)) if p else None


def _border(cfg: dict):
    mode = cfg.get("border_mode", "valid")
    if mode == "same":
        return L.ConvolutionMode.SAME
    if mode == "valid":
        return L.ConvolutionMode.TRUNCATE
    raise KerasImportError(f"Unsupported border_mode: {mode!r}")


def _input_type_from_shape(shape: Sequence[Optional[int]], dim_ordering: str):
    """batch_input_shape (without batch dim) -> InputType."""
    dims = [d for d in shape]
    if len(dims) == 1:
        return FeedForwardInput(int(dims[0]))
    if len(dims) == 2:
        ts = None if dims[0] is None else int(dims[0])
        return RecurrentInput(int(dims[1]), ts)
    if len(dims) == 3:
        if dim_ordering == "th":  # (C, H, W)
            c, h, w = dims
        else:  # tf: (H, W, C)
            h, w, c = dims
        return ConvolutionalInput(int(h), int(w), int(c))
    raise KerasImportError(f"Unsupported input shape: {shape}")


# --- per-layer config translators (reference: layers/Keras*.java) ---


def _translate_layer(class_name: str, cfg: dict, dim_ordering: str):
    """Return (layer_conf | None, extras) where extras may carry
    'flatten': True (insert CnnToFF preprocessor before the next layer)."""
    name = cfg.get("name")
    act = cfg.get("activation")
    dropout = _dl4j_dropout(cfg)
    init = map_init(cfg.get("init"))

    if class_name in ("Dense", "TimeDistributedDense"):
        return (
            L.DenseLayer(
                name=name,
                n_out=int(cfg["output_dim"]),
                activation=map_activation(act),
                weight_init=init,
                dropout=dropout,
            ),
            {},
        )
    if class_name == "Activation":
        return L.ActivationLayer(name=name, activation=map_activation(act)), {}
    if class_name == "Dropout":
        return L.DropoutLayer(name=name, dropout=dropout), {}
    if class_name in ("Convolution2D", "Conv2D"):
        subsample = cfg.get("subsample", (1, 1))
        return (
            L.ConvolutionLayer(
                name=name,
                n_out=int(cfg["nb_filter"]),
                kernel_size=(int(cfg["nb_row"]), int(cfg["nb_col"])),
                stride=(int(subsample[0]), int(subsample[1])),
                convolution_mode=_border(cfg),
                activation=map_activation(act),
                weight_init=init,
                dropout=dropout,
            ),
            {},
        )
    if class_name == "Convolution1D":
        return (
            L.Convolution1DLayer(
                name=name,
                n_out=int(cfg["nb_filter"]),
                kernel_size=int(cfg["filter_length"]),
                stride=int(cfg.get("subsample_length", 1)),
                convolution_mode=_border(cfg),
                activation=map_activation(act),
                weight_init=init,
                dropout=dropout,
            ),
            {},
        )
    if class_name in ("MaxPooling2D", "AveragePooling2D"):
        pool = cfg.get("pool_size", (2, 2))
        strides = cfg.get("strides") or pool
        return (
            L.SubsamplingLayer(
                name=name,
                pooling_type=(
                    L.PoolingType.MAX
                    if class_name.startswith("Max")
                    else L.PoolingType.AVG
                ),
                kernel_size=(int(pool[0]), int(pool[1])),
                stride=(int(strides[0]), int(strides[1])),
                convolution_mode=_border(cfg),
            ),
            {},
        )
    if class_name in ("MaxPooling1D", "AveragePooling1D"):
        pool = int(cfg.get("pool_length", 2))
        stride = cfg.get("stride")
        return (
            L.Subsampling1DLayer(
                name=name,
                pooling_type=(
                    L.PoolingType.MAX
                    if class_name.startswith("Max")
                    else L.PoolingType.AVG
                ),
                kernel_size=pool,
                stride=int(stride) if stride else pool,
                convolution_mode=_border(cfg),
            ),
            {},
        )
    if class_name in (
        "GlobalMaxPooling1D",
        "GlobalMaxPooling2D",
        "GlobalAveragePooling1D",
        "GlobalAveragePooling2D",
    ):
        return (
            L.GlobalPoolingLayer(
                name=name,
                pooling_type=(
                    L.PoolingType.MAX if "Max" in class_name else L.PoolingType.AVG
                ),
            ),
            {},
        )
    if class_name == "ZeroPadding2D":
        pad = cfg.get("padding", (1, 1))
        return (
            L.ZeroPaddingLayer(
                name=name,
                padding=(int(pad[0]), int(pad[0]), int(pad[1]), int(pad[1])),
            ),
            {},
        )
    if class_name == "BatchNormalization":
        if int(cfg.get("mode", 0)) != 0:
            raise KerasImportError(
                "Only BatchNormalization mode=0 is supported "
                "(KerasBatchNormalization.java enforces the same)"
            )
        return (
            L.BatchNormalization(
                name=name,
                decay=float(cfg.get("momentum", 0.99)),
                eps=float(cfg.get("epsilon", 1e-3)),
            ),
            {},
        )
    if class_name == "Embedding":
        return (
            L.EmbeddingLayer(
                name=name,
                n_in=int(cfg["input_dim"]),
                n_out=int(cfg["output_dim"]),
                has_bias=False,
                activation="identity",
                weight_init=init,
            ),
            {},
        )
    if class_name == "LSTM":
        return (
            L.LSTM(
                name=name,
                n_out=int(cfg["output_dim"]),
                activation=map_activation(act),
                gate_activation=map_activation(cfg.get("inner_activation")),
                forget_gate_bias_init=(
                    1.0 if cfg.get("forget_bias_init", "one") == "one" else 0.0
                ),
                weight_init=init,
                dropout=dropout,
            ),
            {"return_sequences": bool(cfg.get("return_sequences", False))},
        )
    if class_name == "Flatten":
        return None, {"flatten": True}
    if class_name == "InputLayer":
        return None, {"input": True}
    raise KerasImportError(f"Unsupported Keras layer: {class_name!r}")


# --- weight readers ---


def _strip_param_name(layer_name: str, weight_name: str) -> str:
    """'dense_1_W:0' or 'dense_1_W' -> 'W' (KerasModel.java:326 comment)."""
    base = weight_name.rsplit("/", 1)[-1]
    if base.endswith(":0"):
        base = base[:-2]
    prefix = layer_name + "_"
    if base.startswith(prefix):
        base = base[len(prefix):]
    return base


def load_keras_weights(h5group) -> Dict[str, Dict[str, np.ndarray]]:
    """Read {layer_name: {short_param_name: array}} from a Keras weights
    group (the ``model_weights`` root or a weights-only file root), using
    the ``layer_names``/``weight_names`` attributes the Keras 1.x writer
    emits (KerasModel.helperImportWeights, KerasModel.java:299-360)."""
    out: Dict[str, Dict[str, np.ndarray]] = {}
    layer_names = [
        n.decode() if isinstance(n, bytes) else str(n)
        for n in h5group.attrs.get("layer_names", list(h5group.keys()))
    ]
    for lname in layer_names:
        grp = h5group[lname]
        wnames = [
            n.decode() if isinstance(n, bytes) else str(n)
            for n in grp.attrs.get("weight_names", list(grp.keys()))
        ]
        if not wnames:
            continue
        params = {}
        for wn in wnames:
            params[_strip_param_name(lname, wn)] = np.asarray(grp[wn])
        out[lname] = params
    return out


def _conv_kernel_to_hwio(W: np.ndarray, dim_ordering: str) -> np.ndarray:
    """Keras conv kernel -> HWIO.

    tf ordering already IS (kh, kw, in, out). Theano stores (out, in, kh,
    kw) and applies true convolution (filters flipped), so rotate 180° then
    transpose (KerasConvolution.java:119-138)."""
    if dim_ordering == "th":
        return np.ascontiguousarray(W[:, :, ::-1, ::-1].transpose(2, 3, 1, 0))
    return W


def _pack_lstm(params: Dict[str, np.ndarray]):
    """Keras 1.x LSTM arrays -> fused {W:[nIn,4H], RW:[H,4H], b:[4H]} in
    this framework's [i|f|g|o] gate order (KerasLstm.java:138-178 does the
    analogous packing into DL4J's [c|f|o|i] order)."""
    try:
        Ws = [params["W_i"], params["W_f"], params["W_c"], params["W_o"]]
        Us = [params["U_i"], params["U_f"], params["U_c"], params["U_o"]]
        bs = [params["b_i"], params["b_f"], params["b_c"], params["b_o"]]
    except KeyError as e:
        raise KerasImportError(f"Keras LSTM layer missing parameter {e}")
    return {
        "W": np.concatenate(Ws, axis=1),
        "RW": np.concatenate(Us, axis=1),
        "b": np.concatenate(bs, axis=0),
    }


def _layer_params_to_native(conf, kparams: Dict[str, np.ndarray], dim_ordering: str):
    """Map one Keras layer's weight dict onto this framework's param dict
    (and BN running state). Returns (params, state_or_None)."""
    if isinstance(conf, (L.LSTM, L.GravesLSTM)):
        return _pack_lstm(kparams), None
    if isinstance(conf, L.BatchNormalization):
        # Keras 1.x names: gamma, beta, running_mean, running_std (the
        # latter holds the VARIANCE — KerasBatchNormalization.java:129-133
        # maps it to GLOBAL_VAR)
        params = {"gamma": kparams["gamma"], "beta": kparams["beta"]}
        state = {
            "mean": kparams["running_mean"],
            "var": kparams.get("running_std", kparams.get("running_var")),
        }
        if state["var"] is None:
            raise KerasImportError("BatchNormalization missing running_std")
        return params, state
    if isinstance(conf, L.ConvolutionLayer):
        out = {"W": _conv_kernel_to_hwio(kparams["W"], dim_ordering)}
        if "b" in kparams:
            out["b"] = kparams["b"]
        return out, None
    if isinstance(conf, L.Convolution1DLayer):
        W = kparams["W"]
        if W.ndim == 4:  # Keras 1 stores (filter_length, 1, nIn, nOut)
            W = W.reshape(W.shape[0], W.shape[2], W.shape[3])
        out = {"W": W}
        if "b" in kparams:
            out["b"] = kparams["b"]
        return out, None
    if isinstance(conf, L.EmbeddingLayer):
        return {"W": kparams["W"]}, None
    if isinstance(conf, (L.DenseLayer, L.OutputLayer)):
        return {"W": kparams["W"], "b": kparams["b"]}, None
    raise KerasImportError(f"No weight mapping for layer {type(conf).__name__}")


# --- model config parsing ---


def _parse_model_config(model_config_json: str):
    cfg = json.loads(model_config_json)
    class_name = cfg.get("class_name")
    if class_name not in ("Sequential", "Model"):
        raise KerasImportError(f"Unsupported Keras model class: {class_name!r}")
    return class_name, cfg["config"]


def _training_loss(training_config_json: Optional[str]) -> Optional[str]:
    if not training_config_json:
        return None
    tc = json.loads(training_config_json)
    loss = tc.get("loss")
    if isinstance(loss, dict):  # per-output dict: take the single entry
        loss = next(iter(loss.values()))
    return map_loss(loss) if isinstance(loss, str) else None


def import_keras_sequential_config(
    model_config_json: str,
    training_config_json: Optional[str] = None,
    *,
    precision: str = "f32",
):
    """Keras Sequential JSON -> MultiLayerConfiguration
    (reference: KerasModelImport.importKerasSequentialConfiguration).

    Returns (conf, layer_names) where layer_names[i] is the Keras layer
    name supplying weights for network layer i (None for plain reshapes)."""
    class_name, layer_list = _parse_model_config(model_config_json)
    if class_name != "Sequential":
        raise KerasImportError("Not a Sequential model; use import_keras_model_config")
    loss = _training_loss(training_config_json)

    builder = Builder().weight_init("xavier").precision(precision).list()
    input_type = None
    dim_ordering = "tf"
    pending_flatten = False
    layer_names: List[Optional[str]] = []
    n_layers = len(layer_list)
    for i, entry in enumerate(layer_list):
        cname = entry["class_name"]
        cfg = dict(entry.get("config", {}))
        if "dim_ordering" in cfg:
            dim_ordering = cfg["dim_ordering"]
        if input_type is None and "batch_input_shape" in cfg:
            input_type = _input_type_from_shape(
                cfg["batch_input_shape"][1:], dim_ordering
            )
        conf, extras = _translate_layer(cname, cfg, dim_ordering)
        if extras.get("input"):
            continue
        if extras.get("flatten"):
            pending_flatten = True
            continue
        if conf is None:
            continue
        is_last = i == n_layers - 1 or all(
            e["class_name"] in ("Activation", "Dropout") for e in layer_list[i + 1:]
        )
        if loss is not None and is_last and isinstance(conf, L.DenseLayer):
            # final Dense under a training config becomes the loss head
            # (reference: KerasLoss appends a LossLayer; an OutputLayer is
            # this framework's fused dense+loss equivalent)
            act = conf.activation
            for e in layer_list[i + 1:]:
                if e["class_name"] == "Activation":
                    act = map_activation(e["config"].get("activation"))
            conf = L.OutputLayer(
                name=conf.name,
                n_out=conf.n_out,
                activation=act,
                weight_init=conf.weight_init,
                dropout=conf.dropout,
                loss=loss,
            )
            loss = None
        idx = len(layer_names)
        if pending_flatten:
            builder.input_pre_processor(idx, CnnToFeedForwardPreProcessor())
            pending_flatten = False
        builder.layer(conf)
        layer_names.append(cfg.get("name"))
        if isinstance(conf, L.OutputLayer) and loss is None:
            break
    if input_type is not None:
        builder.set_input_type(input_type)
    return builder.build(), layer_names


def import_keras_model_config(
    model_config_json: str,
    training_config_json: Optional[str] = None,
    *,
    precision: str = "f32",
):
    """Keras functional ``Model`` JSON -> ComputationGraphConfiguration
    (reference: KerasModel.getComputationGraphConfiguration,
    KerasModel.java:377). Returns (conf, layer_names)."""
    class_name, cfg = _parse_model_config(model_config_json)
    if class_name != "Model":
        raise KerasImportError("Not a functional Model; use the Sequential path")
    loss = _training_loss(training_config_json)

    layers = cfg["layers"]
    output_names = [o[0] for o in cfg["output_layers"]]
    gb = Builder().weight_init("xavier").precision(precision).graph_builder()
    input_types = []
    dim_ordering = "tf"
    layer_names: List[Optional[str]] = []
    name_alias: Dict[str, str] = {}  # keras name -> graph vertex feeding it

    for entry in layers:
        cname = entry["class_name"]
        lcfg = dict(entry.get("config", {}))
        kname = lcfg.get("name") or entry.get("name")
        if "dim_ordering" in lcfg:
            dim_ordering = lcfg["dim_ordering"]
        inbound = entry.get("inbound_nodes") or []
        inputs = [name_alias.get(n[0], n[0]) for n in (inbound[0] if inbound else [])]

        if cname == "InputLayer":
            gb.add_inputs(kname)
            input_types.append(
                _input_type_from_shape(lcfg["batch_input_shape"][1:], dim_ordering)
            )
            continue
        if cname == "Merge":
            mode = lcfg.get("mode", "concat")
            if mode == "concat":
                gb.add_vertex(kname, MergeVertex(), *inputs)
            elif mode in ("sum", "ave", "mul", "max"):
                op = {"sum": "add", "ave": "avg", "mul": "product", "max": "max"}[mode]
                gb.add_vertex(kname, ElementWiseVertex(op=op), *inputs)
            else:
                raise KerasImportError(f"Unsupported Merge mode: {mode!r}")
            continue
        if cname == "Flatten":
            gb.add_vertex(
                kname,
                PreprocessorVertex(preprocessor=CnnToFeedForwardPreProcessor()),
                *inputs,
            )
            continue
        conf, extras = _translate_layer(cname, lcfg, dim_ordering)
        if conf is None:
            # passthrough (e.g. unhandled no-op): alias this name
            if inputs:
                name_alias[kname] = inputs[0]
            continue
        if loss is not None and kname in output_names and isinstance(conf, L.DenseLayer):
            conf = L.OutputLayer(
                name=conf.name,
                n_out=conf.n_out,
                activation=conf.activation,
                weight_init=conf.weight_init,
                dropout=conf.dropout,
                loss=loss,
            )
        gb.add_layer(kname, conf, *inputs)
        layer_names.append(kname)

    gb.set_outputs(*[name_alias.get(n, n) for n in output_names])
    if input_types:
        gb.set_input_types(*input_types)
    return gb.build(), layer_names


# --- full import (config + weights) ---


def _read_archive(path: str):
    import h5py

    f = h5py.File(path, "r")
    attrs = f.attrs
    mc = attrs.get("model_config")
    if mc is None:
        f.close()
        raise KerasImportError(
            f"{path} has no model_config attribute — not a Keras "
            "save_model() archive (KerasModelImport expects the same)"
        )
    if isinstance(mc, bytes):
        mc = mc.decode()
    tc = attrs.get("training_config")
    if isinstance(tc, bytes):
        tc = tc.decode()
    weights_root = f["model_weights"] if "model_weights" in f else f
    return f, str(mc), (str(tc) if tc is not None else None), weights_root


def _dim_ordering_of(model_config_json: str) -> str:
    cfg = json.loads(model_config_json)
    stack = [cfg]
    while stack:
        node = stack.pop()
        if isinstance(node, dict):
            if "dim_ordering" in node:
                return node["dim_ordering"]
            stack.extend(node.values())
        elif isinstance(node, list):
            stack.extend(node)
    return "tf"


def _as_like(v, tmpl: dict, k: str, device):
    """A Keras array as a tensor on `device`, in the dtype of the
    network's tensor `k` (float32 when the network has none)."""
    dtype = tmpl[k].dtype if k in tmpl else torch.float32
    return torch.tensor(np.asarray(v), dtype=dtype, device=device)


def _copy_layer(net, i, conf, kparams, dim_ordering, kname):
    params, state = _layer_params_to_native(conf, kparams, dim_ordering)
    tmpl = net.params_list[i]
    net.params_list[i] = {k: _as_like(v, tmpl, k, net.device)
                          for k, v in params.items()}
    for k in tmpl:
        if k not in net.params_list[i]:
            raise KerasImportError(f"layer {kname}: imported params missing {k!r}")
    if state is not None:
        stmpl = net.state_list[i] or {}
        net.state_list[i] = {k: _as_like(v, stmpl, k, net.device)
                             for k, v in state.items()}


def _apply_weights(net, layer_names, weights, dim_ordering):
    """Copy imported weights into an initialized network, cast to the
    network's parameter dtype, on its device (KerasModel.copyWeightsToLayer)."""
    confs = list(net.layer_confs)
    for i, kname in enumerate(layer_names):
        if kname is None or kname not in weights:
            continue
        _copy_layer(net, i, confs[i], weights[kname], dim_ordering, kname)
    net.upd_state = net.updater_def.init_tree(net.params_list)
    return net


def import_keras_sequential_model_and_weights(
    path: str, *, enforce_training_config: bool = False, precision: str = "f32",
    device=None,
):
    """Import a Keras 1.x Sequential ``save_model()`` HDF5 archive ->
    initialized MultiLayerNetwork with copied weights on `device` ("cuda"
    when None; device="cpu" for the CPU) (reference:
    KerasModelImport.importKerasSequentialModelAndWeights)."""
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork

    f, mc, tc, wroot = _read_archive(path)
    try:
        if enforce_training_config and tc is None:
            raise KerasImportError("Archive has no training_config")
        conf, layer_names = import_keras_sequential_config(mc, tc, precision=precision)
        weights = load_keras_weights(wroot)
    finally:
        f.close()
    net = MultiLayerNetwork(conf, device=device).init()
    net = _apply_weights(net, layer_names, weights, _dim_ordering_of(mc))
    # free pre-flight: shapeflow over the translated configuration — a
    # mistranslated archive is diagnosed at import (logged findings, also
    # on net.import_preflight), not at the first step
    from deeplearning4j_tpu_torch.analysis import preflight_report

    net.import_preflight = preflight_report(net.conf, origin=path)
    return net


def import_keras_model_and_weights(
    path: str, *, enforce_training_config: bool = False, precision: str = "f32",
    device=None,
):
    """Import a Keras 1.x functional ``Model`` archive -> initialized
    ComputationGraph on `device` ("cuda" when None; device="cpu" for the
    CPU); a Sequential archive gives a MultiLayerNetwork (reference:
    KerasModelImport.importKerasModelAndWeights, KerasModelImport.java:39)."""
    from deeplearning4j_tpu_torch.nn.compgraph import ComputationGraph

    f, mc, tc, wroot = _read_archive(path)
    try:
        if enforce_training_config and tc is None:
            raise KerasImportError("Archive has no training_config")
        model_class, _ = _parse_model_config(mc)
        if model_class == "Sequential":
            f.close()
            return import_keras_sequential_model_and_weights(
                path,
                enforce_training_config=enforce_training_config,
                precision=precision,
                device=device,
            )
        conf, layer_names = import_keras_model_config(mc, tc, precision=precision)
        weights = load_keras_weights(wroot)
    finally:
        if f.id.valid:
            f.close()
    net = ComputationGraph(conf, device=device).init()
    from deeplearning4j_tpu_torch.analysis import preflight_report

    net.import_preflight = preflight_report(net.conf, origin=path)
    dim_ordering = _dim_ordering_of(mc)
    # graph params are in topological order: map vertex name -> index
    for kname in layer_names:
        if kname not in weights or kname not in net._pidx:
            continue
        i = net._pidx[kname]
        _copy_layer(net, i, net._layer_confs[i], weights[kname], dim_ordering, kname)
    net.upd_state = net.updater_def.init_tree(net.params_list)
    return net
