"""DL4J model-zip importer — the migration path from the reference. The
port of the JAX package's modelimport/dl4j.py: the same flat walk in
numpy, with the parameters, layer state and updater state put into the
network's tensors on the caller's device (`device`, "cuda" by default as
every port entry point; pass "cpu" for the CPU). The JAX importer's
shapeflow preflight report is not ported (analysis/shapeflow.py is not).

Reference format (util/ModelSerializer.java:40,79-118): a zip holding
  configuration.json  — MultiLayerConfiguration Jackson JSON (layer confs
                        wrapped by type name, Layer.java:47-48 WRAPPER_OBJECT)
  coefficients.bin    — Nd4j.write of the single flattened f32/f64 params
                        row vector (MultiLayerNetwork.java:102 flattenedParams)
  updaterState.bin    — optional flattened updater state
                        (ModelSerializer.java:107-119 write, :148 restore
                        via restoreMultiLayerNetwork(file, loadUpdater)).
                        Layout: the BaseMultiLayerUpdater state view —
                        per contiguous UpdaterBlock (params sharing one
                        updater configuration, BaseMultiLayerUpdater.java:
                        63-104), the updater's state components over the
                        block's params in flat order; two-component
                        updaters split the block view in halves (nd4j
                        AdamUpdater: m = first half, v = second; AdaDelta
                        msg/msdx), single-component (Nesterovs v, AdaGrad
                        historicalGradient, RMSProp lastGradient) use the
                        whole view. BN running mean/var are params with
                        updater NONE in DL4J (stateSize 0) and therefore
                        break block contiguity; differing effective
                        learning rates (bias_learning_rate overrides)
                        break blocks too (UpdaterUtils
                        updaterConfigurationsEqual).

Flat layouts mirrored from nn/params/* (the load-bearing part):
  Dense/Output/RnnOutput/Embedding (DefaultParamInitializer): W [nIn,nOut]
    f-order, then b [nOut].
  Convolution (ConvolutionParamInitializer:140): W [nOut,nIn,kh,kw]
    f-order, then b [nOut] -> transposed to this framework's HWIO.
  BatchNormalization (BatchNormalizationParamInitializer:56-70): gamma,
    beta, then the running mean/var — params in DL4J, STATE here.
  LSTM (LSTMParamInitializer:init): W [nIn,4H], RW [H,4H], b [4H], gate
    blocks ordered [I,F,O,G] where I is the tanh candidate and G the
    sigmoid input gate (LSTMHelpers.java:64,213-215); this framework
    orders blocks [input gate, forget, candidate, output], so columns
    permute [G,F,I,O] -> [i,f,g,o] on import.
  GravesLSTM (GravesLSTMParamInitializer): RW [H,4H+3] with peephole
    columns [wFF,wOO,wGG] appended (LSTMHelpers.java:104-115); wGG feeds
    the sigmoid input gate -> pI, wFF -> pF, wOO -> pO.

Binary array format: the era's Nd4j.write(arr, DataOutputStream) —
big-endian: shape-info buffer (int count, then rank/shape/stride/offset/
elementWiseStride/order ints) followed by a UTF-8 dtype tag and the raw
elements. write_nd4j_array produces the same layout (fixture generation +
export interop).
"""

from __future__ import annotations

import io
import json
import struct
import zipfile
from typing import List, Tuple

import numpy as np

import torch

from deeplearning4j_tpu_torch.common.devices import resolve_device
from deeplearning4j_tpu_torch.nn.conf import layers as L
from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
from deeplearning4j_tpu_torch.nn.conf.network import NeuralNetConfiguration


# -- Nd4j legacy binary array format ----------------------------------------

_DTYPES = {"FLOAT": ("f", 4), "DOUBLE": ("d", 8)}


def write_nd4j_array(arr: np.ndarray, stream) -> None:
    """Serialize in the legacy Nd4j.write layout (big-endian, Java
    DataOutputStream conventions). Arrays are written as 2-d row vectors
    in 'c' order with contiguous strides, matching flattened params."""
    arr = np.asarray(arr)
    if arr.ndim == 1:
        arr = arr[None, :]
    rank = arr.ndim
    shape = list(arr.shape)
    # c-order strides in elements
    strides = []
    acc = 1
    for d in reversed(shape):
        strides.insert(0, acc)
        acc *= d
    info = [rank] + shape + strides + [0, 1, ord("c")]
    stream.write(struct.pack(">i", len(info)))
    stream.write(struct.pack(f">{len(info)}i", *info))
    if arr.dtype == np.float64:
        tag, be = "DOUBLE", ">f8"
    else:
        arr = arr.astype(np.float32)
        tag, be = "FLOAT", ">f4"
    tag_b = tag.encode()
    stream.write(struct.pack(">H", len(tag_b)) + tag_b)  # writeUTF
    stream.write(np.ascontiguousarray(arr.reshape(-1)).astype(be).tobytes())


def read_nd4j_array(stream) -> np.ndarray:
    """Parse the legacy Nd4j.write layout back into numpy (row vector)."""
    (n_info,) = struct.unpack(">i", stream.read(4))
    info = struct.unpack(f">{n_info}i", stream.read(4 * n_info))
    rank = info[0]
    shape = list(info[1 : 1 + rank])
    order = chr(info[-1])
    (tag_len,) = struct.unpack(">H", stream.read(2))
    tag = stream.read(tag_len).decode()
    if tag not in _DTYPES:
        raise ValueError(f"unsupported nd4j dtype tag {tag!r}")
    _, width = _DTYPES[tag]
    count = int(np.prod(shape)) if shape else 0
    be = ">f4" if tag == "FLOAT" else ">f8"
    a = np.frombuffer(stream.read(width * count), dtype=be).astype(
        np.float32 if tag == "FLOAT" else np.float64)
    return a.reshape(shape, order="f" if order == "f" else "c")


# -- configuration.json -> config DSL ----------------------------------------

def _act(name):
    return (name or "identity").lower()


def _loss_name(layer_json):
    ln = layer_json.get("lossFn") or layer_json.get("lossFunction")
    if isinstance(ln, dict):  # ILossFunction object form {"@class": ...}
        cls = ln.get("@class", "")
        mapping = {
            "LossMCXENT": "mcxent", "LossMSE": "mse",
            "LossBinaryXENT": "xent", "LossNegativeLogLikelihood":
            "negativeloglikelihood", "LossL2": "l2", "LossL1": "l1",
            "LossKLD": "kl_divergence", "LossCosineProximity":
            "cosine_proximity", "LossHinge": "hinge",
            "LossSquaredHinge": "squared_hinge", "LossPoisson": "poisson",
            "LossMAE": "mean_absolute_error",
        }
        for key, val in mapping.items():
            if key in cls:
                return val
        raise ValueError(f"unmapped DL4J loss class {cls!r}")
    return (ln or "mcxent").lower()


def _map_layer(name: str, lj: dict):
    """One DL4J layer-conf JSON object -> (this framework's config, DL4J
    type tag). Covers the importable parameterized layer set."""
    act = _act(lj.get("activationFn") or lj.get("activation"))
    n_in = int(lj.get("nin") or lj.get("nIn") or 0)
    n_out = int(lj.get("nout") or lj.get("nOut") or 0)
    common = dict(n_in=n_in or None, n_out=n_out or None, activation=act)
    if name == "dense":
        return L.DenseLayer(**common)
    if name == "output":
        return L.OutputLayer(loss=_loss_name(lj), **common)
    if name == "rnnoutput":
        return L.RnnOutputLayer(loss=_loss_name(lj), **common)
    if name == "convolution":
        return L.ConvolutionLayer(
            kernel_size=tuple(lj.get("kernelSize", (3, 3))),
            stride=tuple(lj.get("stride", (1, 1))),
            padding=tuple(lj.get("padding", (0, 0))),
            convolution_mode="same"
            if lj.get("convolutionMode") == "Same" else "truncate",
            **common,
        )
    if name == "subsampling":
        pt = (lj.get("poolingType") or "MAX").lower()
        return L.SubsamplingLayer(
            pooling_type=pt,
            kernel_size=tuple(lj.get("kernelSize", (2, 2))),
            stride=tuple(lj.get("stride", (2, 2))),
            padding=tuple(lj.get("padding", (0, 0))),
            convolution_mode="same"
            if lj.get("convolutionMode") == "Same" else "truncate",
        )
    if name == "batchNormalization":
        return L.BatchNormalization(
            n_in=n_in or None, eps=lj.get("eps", 1e-5),
            decay=lj.get("decay", 0.9),
            lock_gamma_beta=bool(lj.get("lockGammaBeta", False)),
            gamma=lj.get("gamma", 1.0), beta=lj.get("beta", 0.0),
        )
    if name in ("LSTM", "gravesLSTM"):
        cls = L.LSTM if name == "LSTM" else L.GravesLSTM
        return cls(
            forget_gate_bias_init=lj.get("forgetGateBiasInit", 1.0),
            gate_activation=_act(lj.get("gateActivationFn", "sigmoid")),
            **common,
        )
    if name == "embedding":
        return L.EmbeddingLayer(**common)
    if name == "activation":
        return L.ActivationLayer(activation=act)
    if name == "dropout":
        return L.DropoutLayer(dropout=lj.get("dropOut", 0.5))
    if name == "globalPooling":
        return L.GlobalPoolingLayer(
            pooling_type=(lj.get("poolingType") or "MAX").lower())
    raise ValueError(f"unsupported DL4J layer type {name!r} for import")


def _perm_ifog(cols: np.ndarray, H: int) -> np.ndarray:
    """Columns [I,F,O,G] (DL4J: I=candidate, G=input gate,
    LSTMHelpers.java:64) -> this framework's [i(gate), f, g(candidate),
    o]: take DL4J blocks [G, F, I, O]."""
    I, F, O, G = (cols[..., i * H:(i + 1) * H] for i in range(4))
    return np.concatenate([G, F, I, O], axis=-1)


# -- shared flat-buffer walk -------------------------------------------------

def _put(tree: dict, name: str, value) -> None:
    """tree[name] <- `value` (numpy), in the current tensor's shape,
    dtype and device."""
    ref = tree[name]
    tree[name] = torch.as_tensor(np.ascontiguousarray(value)).reshape(
        ref.shape).to(device=ref.device, dtype=ref.dtype)


def _host(t) -> np.ndarray:
    return t.detach().cpu().numpy() if torch.is_tensor(t) else np.asarray(t)


def _consume_layer_params(take, tag: str, lc, p: dict, lj: dict, state):
    """Consume one layer's slice of the DL4J flat buffer into this
    framework's param dict `p` (and BN running stats into `state`).
    Layouts per nn/params/* (module docstring). Returns the state dict
    (possibly replaced) for the caller to store back."""
    if tag in ("dense", "output", "rnnoutput", "embedding"):
        n_in, n_out = int(lc.n_in), int(lc.n_out)
        W = take(n_in * n_out).reshape((n_in, n_out), order="F")
        b = take(n_out)
        _put(p, "W", W)
        _put(p, "b", b)
    elif tag == "convolution":
        kh, kw = (int(k) for k in lc.kernel_size)
        n_in, n_out = int(lc.n_in), int(lc.n_out)
        W = take(n_out * n_in * kh * kw).reshape(
            (n_out, n_in, kh, kw), order="F")
        _put(p, "W", W.transpose(2, 3, 1, 0))  # -> HWIO
        _put(p, "b", take(n_out))
    elif tag == "batchNormalization":
        n = int(lc.n_in)
        if lj.get("lockGammaBeta", False):
            # BatchNormalizationParamInitializer stores only mean/var when
            # gamma/beta are locked; the fixed values come from the conf
            _put(p, "gamma", 
                np.full(n, lj.get("gamma", 1.0), np.float32))
            _put(p, "beta", 
                np.full(n, lj.get("beta", 0.0), np.float32))
        else:
            _put(p, "gamma", take(n))
            _put(p, "beta", take(n))
        mean, var = take(n), take(n)
        st = dict(state or {})
        _put(st, "mean", mean)
        _put(st, "var", var)
        return st
    elif tag in ("LSTM", "gravesLSTM"):
        n_in, H = int(lc.n_in), int(lc.n_out)
        W = take(n_in * 4 * H).reshape((n_in, 4 * H), order="F")
        rw_cols = 4 * H + (3 if tag == "gravesLSTM" else 0)
        RW_full = take(H * rw_cols).reshape((H, rw_cols), order="F")
        b = take(4 * H)
        _put(p, "W", _perm_ifog(W, H))
        _put(p, "RW", _perm_ifog(RW_full[:, :4 * H], H))
        _put(p, "b", _perm_ifog(b[None, :], H)[0])
        if tag == "gravesLSTM":
            # peephole columns [wFF, wOO, wGG] (LSTMHelpers.java:104)
            _put(p, "pF", RW_full[:, 4 * H])
            _put(p, "pO", RW_full[:, 4 * H + 1])
            _put(p, "pI", RW_full[:, 4 * H + 2])
    elif tag in ("activation", "dropout", "subsampling", "globalPooling"):
        pass  # no params
    else:
        raise ValueError(f"no flat layout for layer tag {tag!r}")
    return state


# -- updater-state flat layout (updaterState.bin) -----------------------------

# nd4j GradientUpdater state components, in view order: two-component
# updaters split their block view in halves (AdamUpdater m|v), single use
# the whole view. sgd/none have stateSize 0 (no updaterState.bin written).
_UPDATER_COMPONENTS = {
    "adam": ("m", "v"), "adamax": ("m", "u"), "adadelta": ("msg", "msdx"),
    "nesterovs": ("v",), "adagrad": ("h",), "rmsprop": ("r",),
    "sgd": (), "none": (),
}


def _state_entries(lc):
    """DL4J flat-order updater-state entries for one layer conf: a list of
    dicts {size, to(comp_arrays)->flat, frm(flat)->{fw_name: array}, cfg}
    where cfg is "param"/"bias" (updater-carrying, effective-lr keyed) or
    "none" (DL4J params with updater NONE — BN running mean/var — that
    carry no state but break block contiguity). The to/frm transforms are
    the SAME layout maps the coefficients walk uses (f-order reshapes,
    HWIO<->OIHW transpose, [I,F,O,G]<->[i,f,g,o] gate permutation):
    moment arrays live in their param's layout."""
    inner = lc.inner if isinstance(lc, L.FrozenLayer) else lc
    entries = []
    if isinstance(inner, (L.DenseLayer, L.OutputLayer, L.RnnOutputLayer,
                          L.EmbeddingLayer)):
        n_in, n_out = int(inner.n_in), int(inner.n_out)
        entries.append(dict(
            size=n_in * n_out,
            to=lambda c: c["W"].reshape(-1, order="F"),
            frm=lambda v: {"W": v.reshape((n_in, n_out), order="F")},
            cfg="param"))
        entries.append(dict(
            size=n_out,
            to=lambda c: c["b"].reshape(-1),
            frm=lambda v: {"b": v},
            cfg="bias"))
    elif isinstance(inner, L.ConvolutionLayer):
        kh, kw = (int(k) for k in inner.kernel_size)
        n_in, n_out = int(inner.n_in), int(inner.n_out)
        entries.append(dict(
            size=n_out * n_in * kh * kw,
            to=lambda c: c["W"].transpose(3, 2, 0, 1).reshape(-1, order="F"),
            frm=lambda v: {"W": v.reshape((n_out, n_in, kh, kw),
                                          order="F").transpose(2, 3, 1, 0)},
            cfg="param"))
        entries.append(dict(
            size=n_out, to=lambda c: c["b"].reshape(-1),
            frm=lambda v: {"b": v}, cfg="bias"))
    elif isinstance(inner, L.BatchNormalization):
        n = int(inner.n_in)
        if not inner.lock_gamma_beta:
            entries.append(dict(size=n, to=lambda c: c["gamma"].reshape(-1),
                                frm=lambda v: {"gamma": v}, cfg="param"))
            entries.append(dict(size=n, to=lambda c: c["beta"].reshape(-1),
                                frm=lambda v: {"beta": v}, cfg="param"))
        # running mean/var: DL4J params with updater NONE (stateSize 0)
        entries.append(dict(size=n, to=None, frm=None, cfg="none"))
        entries.append(dict(size=n, to=None, frm=None, cfg="none"))
    elif isinstance(inner, (L.LSTM, L.GravesLSTM)):
        graves = isinstance(inner, L.GravesLSTM)
        n_in, H = int(inner.n_in), int(inner.n_out)

        def inv(cols):
            return np.concatenate(
                [cols[..., 2 * H:3 * H], cols[..., H:2 * H],
                 cols[..., 3 * H:], cols[..., :H]], axis=-1)

        entries.append(dict(
            size=n_in * 4 * H,
            to=lambda c: inv(c["W"]).reshape(-1, order="F"),
            frm=lambda v: {"W": _perm_ifog(
                v.reshape((n_in, 4 * H), order="F"), H)},
            cfg="param"))
        rw_cols = 4 * H + (3 if graves else 0)

        def rw_to(c):
            RW = inv(c["RW"])
            if graves:
                RW = np.concatenate(
                    [RW, c["pF"][:, None], c["pO"][:, None],
                     c["pI"][:, None]], axis=1)
            return RW.reshape(-1, order="F")

        def rw_frm(v):
            RW_full = v.reshape((H, rw_cols), order="F")
            out = {"RW": _perm_ifog(RW_full[:, :4 * H], H)}
            if graves:
                out["pF"] = RW_full[:, 4 * H]
                out["pO"] = RW_full[:, 4 * H + 1]
                out["pI"] = RW_full[:, 4 * H + 2]
            return out

        entries.append(dict(size=H * rw_cols, to=rw_to, frm=rw_frm,
                            cfg="param"))
        entries.append(dict(
            size=4 * H,
            to=lambda c: inv(c["b"][None, :])[0],
            frm=lambda v: {"b": _perm_ifog(v[None, :], H)[0]},
            cfg="bias"))
    elif isinstance(inner, (L.ActivationLayer, L.DropoutLayer,
                            L.SubsamplingLayer, L.GlobalPoolingLayer)):
        pass  # no params, no state
    else:
        raise ValueError(
            f"no updater-state layout for layer {type(inner).__name__}")
    return entries


def _effective_lr(net_conf, lc, kind):
    """Mirrors NetworkBase._lr_mult_tree: per-layer learning_rate and
    bias_learning_rate overrides decide UpdaterBlock splits (UpdaterUtils
    updaterConfigurationsEqual compares lr)."""
    inner = lc.inner if isinstance(lc, L.FrozenLayer) else lc
    if kind == "bias" and getattr(inner, "bias_learning_rate", None) is not None:
        return inner.bias_learning_rate
    if getattr(inner, "learning_rate", None) is not None:
        return inner.learning_rate
    return net_conf.learning_rate


def _updater_blocks(net_conf, indexed_layer_confs):
    """Group (state_idx, entry) pairs into contiguous UpdaterBlocks the
    way BaseMultiLayerUpdater does (:63-104): a new block starts whenever
    the effective updater configuration changes (including the NONE
    pseudo-config of BN mean/var). Input: [(state_idx, layer_conf)] in
    the flat-walk order."""
    upd = net_conf.updater.lower()
    blocks, cur_key, cur = [], None, []
    for i, lc in indexed_layer_confs:
        for e in _state_entries(lc):
            key = (("none",) if e["cfg"] == "none"
                   else (upd, _effective_lr(net_conf, lc, e["cfg"])))
            if key != cur_key:
                if cur:
                    blocks.append((cur_key, cur))
                cur_key, cur = key, []
            cur.append((i, e))
    if cur:
        blocks.append((cur_key, cur))
    return blocks


def updater_state_to_flat(net, indexed_layer_confs=None) -> np.ndarray:
    """The network's updater state in the reference's state-view layout
    (what Nd4j.write(updaterState, ...) serializes)."""
    comps = _UPDATER_COMPONENTS.get(net.updater_def.name, ())
    pairs = (indexed_layer_confs if indexed_layer_confs is not None
             else list(enumerate(net.layer_confs)))
    parts = []
    for key, entries in _updater_blocks(net.net_conf, pairs):
        if key[0] == "none" or not comps:
            continue
        for comp in comps:
            for i, e in entries:
                st = net.upd_state[i]
                c = {name: _host(leaf[comp])
                     for name, leaf in st.items()
                     if isinstance(leaf, dict) and comp in leaf}
                parts.append(np.asarray(e["to"](c), np.float32).reshape(-1))
    return (np.concatenate(parts) if parts
            else np.zeros(0, np.float32))


def restore_updater_state(net, flat: np.ndarray,
                          indexed_layer_confs=None) -> None:
    """Inverse of updater_state_to_flat: load a reference state view into
    the network's per-leaf updater state (resume-training parity),
    copied into the state tensors in place."""
    comps = _UPDATER_COMPONENTS.get(net.updater_def.name, ())
    flat = np.asarray(flat).reshape(-1)
    if not comps:
        if flat.size:
            raise ValueError(
                f"updater {net.updater_def.name!r} is stateless but "
                f"updaterState.bin holds {flat.size} values")
        return
    pairs = (indexed_layer_confs if indexed_layer_confs is not None
             else list(enumerate(net.layer_confs)))
    blocks = _updater_blocks(net.net_conf, pairs)
    # validate BEFORE mutating: a wrong-sized view must not leave a
    # half-restored (corrupted old/new mix) updater state behind
    expected = sum(
        len(comps) * sum(e["size"] for _, e in entries)
        for key, entries in blocks if key[0] != "none")
    if expected != flat.size:
        raise ValueError(
            f"updaterState.bin length mismatch: layout expects {expected} "
            f"values, file holds {flat.size}")
    off = 0
    for key, entries in blocks:
        if key[0] == "none":
            continue
        for comp in comps:
            for i, e in entries:
                vec = flat[off:off + e["size"]]
                off += e["size"]
                for name, arr in e["frm"](vec).items():
                    cur = net.upd_state[i][name][comp]
                    with torch.no_grad():
                        cur.copy_(torch.as_tensor(
                            np.ascontiguousarray(arr)).reshape(cur.shape))


def _training_builder(confs: List[dict], bodies: List[dict],
                      precision: str):
    """Network builder with the training hyperparameters a DL4J zip
    carries restored (0.8.x serializes updater/learningRate and the
    updater's own hyperparameters per LAYER body; iterationCount sits on
    the per-layer NeuralNetConfiguration wrapper). Without these, a
    migrated model would resume with default sgd and the imported
    optimizer moments would be meaningless."""
    nc0 = confs[0] if confs else {}
    b0 = bodies[0] if bodies else {}
    get = lambda key, default=None: b0.get(key, nc0.get(key, default))
    builder = NeuralNetConfiguration.builder().precision(precision)
    updater = get("updater")
    if updater:
        builder = builder.updater(str(updater).lower())
    lr = get("learningRate")
    if lr is not None:
        builder = builder.learning_rate(float(lr))
    for json_key, method in (
        ("momentum", "momentum"), ("rho", "rho"),
        ("rmsDecay", "rms_decay"), ("adamMeanDecay", "adam_mean_decay"),
        ("adamVarDecay", "adam_var_decay"), ("epsilon", "epsilon"),
    ):
        v = get(json_key)
        if v is not None:
            builder = getattr(builder, method)(float(v))
    return builder


# -- the importer ------------------------------------------------------------

def import_dl4j_multilayer(path: str, precision: str = "f32",
                           load_updater: bool = True, *, device=None):
    """Load a reference-format model zip into a MultiLayerNetwork.

    Returns the network with parameters, BN running stats, the updater
    state (optimizer moments from updaterState.bin, when present and
    load_updater — mirroring restoreMultiLayerNetwork(file, loadUpdater),
    ModelSerializer.java:148) and the iteration counter restored, so a
    migrated model RESUMES training rather than restarting its
    moments. The network lives on `device`."""
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork

    with zipfile.ZipFile(path) as zf:
        conf_json = json.loads(zf.read("configuration.json"))
        flat = read_nd4j_array(io.BytesIO(zf.read("coefficients.bin")))
        upd_flat = None
        if load_updater and "updaterState.bin" in zf.namelist():
            upd_flat = read_nd4j_array(io.BytesIO(zf.read("updaterState.bin")))
    flat = np.asarray(flat).reshape(-1)

    confs = conf_json.get("confs", [])
    layers: List = []
    tags: List[str] = []
    bodies: List[dict] = []
    for c in confs:
        lj = c.get("layer", {})
        if not lj:
            raise ValueError("conf without layer entry")
        (tag, body), = lj.items()
        layers.append(_map_layer(tag, body))
        tags.append(tag)
        bodies.append(body)

    builder = _training_builder(confs, bodies, precision).list()
    iteration = int((confs[0] if confs else {}).get("iterationCount", 0))
    for l in layers:
        builder = builder.layer(l)
    # input type from the first layer's nIn (feed-forward/recurrent import;
    # CNN zips additionally carry inputPreProcessors, mapped coarsely here)
    first = layers[0]
    if isinstance(first, (L.LSTM, L.GravesLSTM)):
        builder = builder.set_input_type(InputType.recurrent(first.n_in))
    else:
        builder = builder.set_input_type(InputType.feed_forward(first.n_in))
    net = MultiLayerNetwork(builder.build(), device=resolve_device(device)).init()

    # walk the flat buffer in layer order, mirroring nn/params layouts
    off = 0

    def take(n):
        nonlocal off
        out = flat[off:off + n]
        if out.size != n:
            raise ValueError(
                f"coefficients.bin too short: wanted {n} at offset {off}, "
                f"have {flat.size}")
        off += n
        return out

    for i, (tag, lc, lj) in enumerate(zip(tags, layers, bodies)):
        net.state_list[i] = _consume_layer_params(
            take, tag, lc, net.params_list[i], lj, net.state_list[i])
    if off != flat.size:
        raise ValueError(
            f"coefficients.bin length mismatch: consumed {off} of {flat.size}")
    net.iteration = iteration
    if upd_flat is not None:
        restore_updater_state(net, np.asarray(upd_flat).reshape(-1))
    return net


# -- fixture/export writer ---------------------------------------------------

def _export_layer(lc, p: dict, st) -> Tuple[str, dict, List[np.ndarray]]:
    """One layer conf + params (+ BN state) -> (DL4J tag, layer-conf JSON
    body, flat parts in the reference layouts)."""
    flat_parts: List[np.ndarray] = []
    if isinstance(lc, L.ConvolutionLayer):
        tag = "convolution"
        body = {
            "nin": int(lc.n_in), "nout": int(lc.n_out),
            "activationFn": lc.activation,
            "kernelSize": list(lc.kernel_size),
            "stride": list(lc.stride), "padding": list(lc.padding),
            "convolutionMode":
                "Same" if str(lc.convolution_mode).endswith("same")
                else "Truncate",
        }
        W = p["W"].transpose(3, 2, 0, 1)  # HWIO -> [nOut,nIn,kh,kw]
        flat_parts += [W.reshape(-1, order="F"), p["b"].reshape(-1)]
    elif isinstance(lc, L.BatchNormalization):
        tag = "batchNormalization"
        body = {"nin": int(lc.n_in), "nout": int(lc.n_in),
                "eps": lc.eps, "decay": lc.decay}
        st = st or {}
        if lc.lock_gamma_beta:
            body["lockGammaBeta"] = True
            body["gamma"], body["beta"] = lc.gamma, lc.beta
        else:
            flat_parts += [p["gamma"], p["beta"]]
        flat_parts += [_host(st.get("mean")), _host(st.get("var"))]
    elif isinstance(lc, (L.LSTM, L.GravesLSTM)):
        graves = isinstance(lc, L.GravesLSTM)
        tag = "gravesLSTM" if graves else "LSTM"
        H = int(lc.n_out)
        body = {"nin": int(lc.n_in), "nout": H,
                "activationFn": lc.activation,
                "gateActivationFn": lc.gate_activation,
                "forgetGateBiasInit": lc.forget_gate_bias_init}
        inv = lambda cols: np.concatenate(
            [cols[..., 2 * H:3 * H],           # I <- my g (candidate)
             cols[..., H:2 * H],               # F <- my f
             cols[..., 3 * H:],                # O <- my o
             cols[..., :H]], axis=-1)          # G <- my i (input gate)
        RW = inv(p["RW"])
        if graves:
            RW = np.concatenate(
                [RW, p["pF"][:, None], p["pO"][:, None],
                 p["pI"][:, None]], axis=1)
        flat_parts += [inv(p["W"]).reshape(-1, order="F"),
                       RW.reshape(-1, order="F"),
                       inv(p["b"][None, :])[0]]
    elif isinstance(lc, L.OutputLayer):
        tag = "output"
        body = {"nin": int(lc.n_in), "nout": int(lc.n_out),
                "activationFn": lc.activation, "lossFn": lc.loss}
        flat_parts += [p["W"].reshape(-1, order="F"), p["b"].reshape(-1)]
    elif isinstance(lc, L.RnnOutputLayer):
        tag = "rnnoutput"
        body = {"nin": int(lc.n_in), "nout": int(lc.n_out),
                "activationFn": lc.activation, "lossFn": lc.loss}
        flat_parts += [p["W"].reshape(-1, order="F"), p["b"].reshape(-1)]
    elif isinstance(lc, L.DenseLayer):
        tag = "dense"
        body = {"nin": int(lc.n_in), "nout": int(lc.n_out),
                "activationFn": lc.activation}
        flat_parts += [p["W"].reshape(-1, order="F"), p["b"].reshape(-1)]
    elif isinstance(lc, L.EmbeddingLayer):
        tag = "embedding"
        body = {"nin": int(lc.n_in), "nout": int(lc.n_out),
                "activationFn": lc.activation}
        flat_parts += [p["W"].reshape(-1, order="F"), p["b"].reshape(-1)]
    elif isinstance(lc, L.ActivationLayer):
        tag, body = "activation", {"activationFn": lc.activation}
    elif isinstance(lc, L.SubsamplingLayer):
        tag = "subsampling"
        body = {"poolingType": str(lc.pooling_type).upper(),
                "kernelSize": list(lc.kernel_size),
                "stride": list(lc.stride), "padding": list(lc.padding),
                "convolutionMode":
                    "Same" if str(lc.convolution_mode).endswith("same")
                    else "Truncate"}
    elif isinstance(lc, L.GlobalPoolingLayer):
        tag = "globalPooling"
        body = {"poolingType": str(lc.pooling_type).upper()}
    elif isinstance(lc, L.DropoutLayer):
        tag, body = "dropout", {"dropOut": lc.dropout}
    else:
        raise ValueError(f"cannot export layer {type(lc).__name__}")
    return tag, body, flat_parts


def _conf_training_json(net) -> dict:
    """Per-layer-body training hyperparameters, reference style."""
    nc = net.net_conf
    out = {"updater": nc.updater.upper(), "learningRate": nc.learning_rate}
    per_updater = {
        "nesterovs": {"momentum": nc.momentum},
        "adam": {"adamMeanDecay": nc.adam_mean_decay,
                 "adamVarDecay": nc.adam_var_decay, "epsilon": nc.epsilon},
        "adamax": {"adamMeanDecay": nc.adam_mean_decay,
                   "adamVarDecay": nc.adam_var_decay, "epsilon": nc.epsilon},
        "adadelta": {"rho": nc.rho, "epsilon": nc.epsilon},
        "rmsprop": {"rmsDecay": nc.rms_decay, "epsilon": nc.epsilon},
        "adagrad": {"epsilon": nc.epsilon},
    }
    out.update(per_updater.get(nc.updater.lower(), {}))
    return out


def export_dl4j_zip(net, path: str, save_updater: bool = True) -> None:
    """Write a network in the reference zip format (the inverse mapping of
    import_dl4j_multilayer — used for fixtures and for handing models back
    to reference-era tooling). Only layer types listed above. With
    save_updater (the reference's writeModel saveUpdater flag), the
    optimizer state view goes to updaterState.bin and the per-conf
    iterationCount is emitted, so import->resume matches uninterrupted
    training."""
    train_json = _conf_training_json(net)
    conf_out = {"confs": []}
    flat_parts: List[np.ndarray] = []
    for i, lc in enumerate(net.layer_confs):
        p = {k: _host(v) for k, v in net.params_list[i].items()}
        tag, body, parts = _export_layer(lc, p, net.state_list[i])
        body = {**body, **train_json}
        conf_out["confs"].append({"layer": {tag: body},
                                  "iterationCount": int(net.iteration)})
        flat_parts += parts

    flat = (np.concatenate([f.astype(np.float32).reshape(-1)
                            for f in flat_parts])
            if flat_parts else np.zeros(0, np.float32))
    buf = io.BytesIO()
    write_nd4j_array(flat, buf)
    with zipfile.ZipFile(path, "w") as zf:
        zf.writestr("configuration.json", json.dumps(conf_out))
        zf.writestr("coefficients.bin", buf.getvalue())
        if save_updater:
            upd = updater_state_to_flat(net)
            if upd.size:
                ubuf = io.BytesIO()
                write_nd4j_array(upd, ubuf)
                zf.writestr("updaterState.bin", ubuf.getvalue())


# -- ComputationGraph zips ----------------------------------------------------
# Reference format (ModelSerializer.java:228 restoreComputationGraph): the
# same zip layout, but configuration.json is a ComputationGraphConfiguration
# — networkInputs / networkOutputs / vertices (LinkedHashMap, JSON order =
# builder order) / vertexInputs — and coefficients.bin concatenates each
# parameterized vertex's flat view in TOPOLOGICAL order
# (ComputationGraph.java:365-402: vertex numbers are inputs-then-JSON-order;
# the flat walk follows topologicalSortOrder(), Kahn's algorithm with a FIFO
# queue whose ties resolve in ascending vertex number — Java HashMap/HashSet
# over small int keys iterate ascending).

def _dl4j_topo_names(inputs: List[str], vertex_names: List[str],
                     vertex_inputs: dict) -> List[str]:
    """The reference's exact topological ordering over vertex NAMES."""
    names = list(inputs) + list(vertex_names)
    idx = {n: i for i, n in enumerate(names)}
    indeg = {i: 0 for i in range(len(names))}
    outs = {i: set() for i in range(len(names))}
    for name, ins in vertex_inputs.items():
        j = idx[name]
        for src in ins:
            outs[idx[src]].add(j)
            indeg[j] += 1
    queue = [i for i in sorted(indeg) if indeg[i] == 0]
    order: List[int] = []
    while queue:
        nxt = queue.pop(0)
        order.append(nxt)
        for j in sorted(outs[nxt]):  # ascending, like HashSet<int> iteration
            indeg[j] -= 1
            if indeg[j] == 0:
                queue.append(j)
    if len(order) != len(names):
        raise ValueError("cycle in imported graph configuration")
    return [names[i] for i in order]


def _map_vertex(tag: str, body: dict):
    """DL4J graph-vertex JSON -> this framework's vertex conf (non-layer
    types; LayerVertex is handled by the importer)."""
    from deeplearning4j_tpu_torch.nn.conf import graph as G

    if tag == "MergeVertex":
        return G.MergeVertex()
    if tag == "ElementWiseVertex":
        return G.ElementWiseVertex(op=str(body.get("op", "Add")).lower())
    if tag == "SubsetVertex":
        return G.SubsetVertex(from_=int(body["from"]), to=int(body["to"]))
    if tag == "StackVertex":
        return G.StackVertex()
    if tag == "UnstackVertex":
        return G.UnstackVertex(from_=int(body["from"]),
                               stack_size=int(body["stackSize"]))
    if tag == "ScaleVertex":
        return G.ScaleVertex(scale=float(body["scaleFactor"]))
    if tag == "ShiftVertex":
        return G.ShiftVertex(shift=float(body.get("shiftFactor", 0.0)))
    if tag == "L2Vertex":
        return G.L2Vertex()
    if tag == "L2NormalizeVertex":
        return G.L2NormalizeVertex()
    if tag == "LastTimeStepVertex":
        return G.LastTimeStepVertex(mask_input=body.get("maskArrayInputName"))
    if tag == "DuplicateToTimeSeriesVertex":
        return G.DuplicateToTimeSeriesVertex(ref_input=body.get("inputName"))
    raise ValueError(f"unsupported DL4J graph vertex type {tag!r} for import")


def import_dl4j_computation_graph(path: str, precision: str = "f32",
                                  load_updater: bool = True, *, device=None):
    """Load a reference-format ComputationGraph zip
    (ModelSerializer.java:228 restoreComputationGraph) into a
    ComputationGraph on `device` with parameters, BN stats and
    (load_updater) the optimizer moments + iteration counter restored."""
    from deeplearning4j_tpu_torch.nn.compgraph import ComputationGraph
    from deeplearning4j_tpu_torch.nn.conf import graph as G

    with zipfile.ZipFile(path) as zf:
        cj = json.loads(zf.read("configuration.json"))
        flat = read_nd4j_array(io.BytesIO(zf.read("coefficients.bin")))
        upd_flat = None
        if load_updater and "updaterState.bin" in zf.namelist():
            upd_flat = read_nd4j_array(io.BytesIO(zf.read("updaterState.bin")))
    flat = np.asarray(flat).reshape(-1)

    inputs = list(cj["networkInputs"])
    outputs = list(cj["networkOutputs"])
    vertices_json = cj.get("vertices", {})  # JSON order == builder order
    vertex_inputs = {k: list(v) for k, v in cj.get("vertexInputs", {}).items()}

    layer_confs = {}   # name -> (tag, our layer conf, raw body)
    vertex_confs = {}  # name -> our vertex conf
    for name, vj in vertices_json.items():
        (vtag, vbody), = vj.items()
        if vtag == "LayerVertex":
            lj = vbody.get("layerConf", {}).get("layer", {})
            if not lj:
                raise ValueError(f"LayerVertex {name!r} without layer conf")
            (ltag, lbody), = lj.items()
            layer_confs[name] = (ltag, _map_layer(ltag, lbody), lbody)
        else:
            vertex_confs[name] = _map_vertex(vtag, vbody)

    topo = _dl4j_topo_names(inputs, list(vertices_json), vertex_inputs)

    lbodies = [layer_confs[n][2] for n in topo if n in layer_confs]
    builder = (_training_builder(
        [cj.get("defaultConfiguration", cj)], lbodies, precision)
        .graph_builder().add_inputs(*inputs))
    iteration = int(cj.get("iterationCount",
                           cj.get("defaultConfiguration", {})
                           .get("iterationCount", 0)))
    for name in topo:  # topo order satisfies inputs-before-use
        if name in inputs:
            continue
        ins = vertex_inputs[name]
        if name in layer_confs:
            builder.add_layer(name, layer_confs[name][1], *ins)
        else:
            builder.add_vertex(name, vertex_confs[name], *ins)
    builder.set_outputs(*outputs)
    net = ComputationGraph(builder.build(), device=resolve_device(device)).init()

    off = 0

    def take(n):
        nonlocal off
        out = flat[off:off + n]
        if out.size != n:
            raise ValueError(
                f"coefficients.bin too short: wanted {n} at offset {off}, "
                f"have {flat.size}")
        off += n
        return out

    # flat walk in the REFERENCE topo order, but params land by name in
    # this framework's own ordering (net._pidx maps names to param slots)
    for name in topo:
        if name not in layer_confs:
            continue
        tag, lc, lbody = layer_confs[name]
        i = net._pidx[name]
        net.state_list[i] = _consume_layer_params(
            take, tag, lc, net.params_list[i], lbody, net.state_list[i])
    if off != flat.size:
        raise ValueError(
            f"coefficients.bin length mismatch: consumed {off} of {flat.size}")
    net.iteration = iteration
    if upd_flat is not None:
        pairs = [(net._pidx[n], layer_confs[n][1])
                 for n in topo if n in layer_confs]
        restore_updater_state(net, np.asarray(upd_flat).reshape(-1),
                              indexed_layer_confs=pairs)
    return net


def export_dl4j_graph(net, path: str, save_updater: bool = True) -> None:
    """Write a ComputationGraph in the reference zip format (the inverse of
    import_dl4j_computation_graph — fixtures + hand-back interop), with
    updaterState.bin + iterationCount when save_updater."""
    from deeplearning4j_tpu_torch.nn.conf import graph as G

    conf = net.conf
    train_json = _conf_training_json(net)
    vertices_json = {}
    vertex_inputs = {}
    for name, v in conf.vertices.items():
        vertex_inputs[name] = list(conf.vertex_inputs[name])
        if isinstance(v, G.LayerVertex):
            # params are exported in the flat walk below; here only the conf
            ltag, lbody, _ = _export_layer_conf_only(v.layer)
            vertices_json[name] = {
                "LayerVertex": {"layerConf": {
                    "layer": {ltag: {**lbody, **train_json}}}}}
        else:
            vertices_json[name] = _vertex_to_json(v)

    topo = _dl4j_topo_names(conf.inputs, list(conf.vertices),
                            vertex_inputs)
    flat_parts: List[np.ndarray] = []
    for name in topo:
        v = conf.vertices.get(name)
        if not isinstance(v, G.LayerVertex):
            continue
        i = net._pidx[name]
        p = {k: _host(val) for k, val in net.params_list[i].items()}
        _, _, parts = _export_layer(v.layer, p, net.state_list[i])
        flat_parts += parts

    conf_out = {
        "networkInputs": list(conf.inputs),
        "networkOutputs": list(conf.outputs),
        "vertices": vertices_json,
        "vertexInputs": vertex_inputs,
        "iterationCount": int(net.iteration),
    }
    flat = (np.concatenate([f.astype(np.float32).reshape(-1)
                            for f in flat_parts])
            if flat_parts else np.zeros(0, np.float32))
    buf = io.BytesIO()
    write_nd4j_array(flat, buf)
    with zipfile.ZipFile(path, "w") as zf:
        zf.writestr("configuration.json", json.dumps(conf_out))
        zf.writestr("coefficients.bin", buf.getvalue())
        if save_updater:
            pairs = [(net._pidx[n], conf.vertices[n].layer)
                     for n in topo
                     if isinstance(conf.vertices.get(n), G.LayerVertex)]
            upd = updater_state_to_flat(net, indexed_layer_confs=pairs)
            if upd.size:
                ubuf = io.BytesIO()
                write_nd4j_array(upd, ubuf)
                zf.writestr("updaterState.bin", ubuf.getvalue())


def _export_layer_conf_only(lc) -> Tuple[str, dict, list]:
    """Layer conf -> (tag, JSON body): run _export_layer over throwaway
    correctly-shaped params so the body logic stays in one place."""
    from deeplearning4j_tpu_torch.nn.layers.registry import (
        init_layer_params,
        init_layer_state,
    )

    p = {k: _host(v) for k, v in init_layer_params(
        torch.Generator().manual_seed(0), lc, torch.float32).items()}
    st = init_layer_state(lc, torch.float32)
    tag, body, _ = _export_layer(lc, p, st)
    return tag, body, []


def _vertex_to_json(v) -> dict:
    from deeplearning4j_tpu_torch.nn.conf import graph as G

    if isinstance(v, G.MergeVertex):
        return {"MergeVertex": {}}
    if isinstance(v, G.ElementWiseVertex):
        return {"ElementWiseVertex": {"op": v.op.capitalize()}}
    if isinstance(v, G.SubsetVertex):
        return {"SubsetVertex": {"from": v.from_, "to": v.to}}
    if isinstance(v, G.StackVertex):
        return {"StackVertex": {}}
    if isinstance(v, G.UnstackVertex):
        return {"UnstackVertex": {"from": v.from_, "stackSize": v.stack_size}}
    if isinstance(v, G.ScaleVertex):
        return {"ScaleVertex": {"scaleFactor": v.scale}}
    if isinstance(v, G.ShiftVertex):
        return {"ShiftVertex": {"shiftFactor": v.shift}}
    if isinstance(v, G.L2Vertex):
        return {"L2Vertex": {}}
    if isinstance(v, G.L2NormalizeVertex):
        return {"L2NormalizeVertex": {}}
    if isinstance(v, G.LastTimeStepVertex):
        return {"LastTimeStepVertex": {"maskArrayInputName": v.mask_input}}
    if isinstance(v, G.DuplicateToTimeSeriesVertex):
        return {"DuplicateToTimeSeriesVertex": {"inputName": v.ref_input}}
    raise ValueError(f"cannot export vertex {type(v).__name__}")
