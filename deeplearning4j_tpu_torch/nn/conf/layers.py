"""Layer configuration dataclasses.

One config class per layer type, mirroring the reference's nn/conf/layers/
catalog (28 classes — SURVEY.md §2.1 "Layer configs"). Configs are pure
data: JSON-serializable dataclasses with two responsibilities the reference
splits between InputTypeUtil and each Layer conf:

- output_type(input_type): shape inference through the network
- infer_n_in(input_type): fill in n_in/channels when the user set an
  InputType instead of wiring sizes by hand (reference: setNIn overrides)

Fields defaulting to None inherit the network-level default from
NeuralNetConfiguration (reference: Builder.layer(...) cloning global
hyperparameters into each layer's conf).

Convolutional layers use NHWC and "same"/"truncate" border modes
(reference ConvolutionMode.Same/Truncate, nn/conf/ConvolutionMode.java).
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Sequence, Tuple

from deeplearning4j_tpu_torch.nn.conf.inputs import (
    ConvolutionalFlatInput,
    ConvolutionalInput,
    FeedForwardInput,
    RecurrentInput,
)
from deeplearning4j_tpu_torch.nn.conf.serde import register_config


class PoolingType:
    MAX = "max"
    AVG = "avg"
    SUM = "sum"
    PNORM = "pnorm"


class ConvolutionMode:
    SAME = "same"
    TRUNCATE = "truncate"


def _conv_out(size: int, k: int, s: int, p: int, mode: str) -> int:
    if mode == ConvolutionMode.SAME:
        return int(math.ceil(size / s))
    return (size + 2 * p - k) // s + 1


@dataclasses.dataclass(kw_only=True)
class LayerConf:
    """Base fields shared by every layer (reference: nn/conf/layers/Layer.java
    + BaseLayer hyperparameters)."""

    name: Optional[str] = None
    dropout: Optional[float] = None  # keep DL4J semantics: retain probability

    def output_type(self, it):
        return it

    def infer_n_in(self, it) -> None:
        pass

    def has_params(self) -> bool:
        return True


@dataclasses.dataclass(kw_only=True)
class BaseLayerConf(LayerConf):
    activation: Optional[str] = None
    weight_init: Optional[str] = None
    dist: Optional[dict] = None
    bias_init: Optional[float] = None
    l1: Optional[float] = None
    l2: Optional[float] = None
    learning_rate: Optional[float] = None
    bias_learning_rate: Optional[float] = None


@dataclasses.dataclass(kw_only=True)
class FeedForwardLayerConf(BaseLayerConf):
    n_in: Optional[int] = None
    n_out: int = 0

    def output_type(self, it):
        return FeedForwardInput(self.n_out)

    def infer_n_in(self, it) -> None:
        if self.n_in is None:
            self.n_in = it.arity()


@register_config("layer.dense")
@dataclasses.dataclass(kw_only=True)
class DenseLayer(FeedForwardLayerConf):
    """Fully connected layer (reference: nn/conf/layers/DenseLayer.java)."""


@register_config("layer.output")
@dataclasses.dataclass(kw_only=True)
class OutputLayer(FeedForwardLayerConf):
    """Dense + loss head (reference: nn/conf/layers/OutputLayer.java)."""

    loss: str = "mcxent"


@register_config("layer.rnn_output")
@dataclasses.dataclass(kw_only=True)
class RnnOutputLayer(FeedForwardLayerConf):
    """Time-distributed output layer (reference: RnnOutputLayer.java).
    Input [batch, time, nIn] -> [batch, time, nOut], loss summed over time."""

    loss: str = "mcxent"

    def output_type(self, it):
        ts = it.timesteps if isinstance(it, RecurrentInput) else None
        return RecurrentInput(self.n_out, ts)


@register_config("layer.center_loss_output")
@dataclasses.dataclass(kw_only=True)
class CenterLossOutputLayer(FeedForwardLayerConf):
    """Output layer with center-loss auxiliary term
    (reference: CenterLossOutputLayer.java: intra-class center pull)."""

    loss: str = "mcxent"
    alpha: float = 0.05
    lambda_: float = 2e-4

    def output_type(self, it):
        return FeedForwardInput(self.n_out)


@register_config("layer.loss")
@dataclasses.dataclass(kw_only=True)
class LossLayer(BaseLayerConf):
    """Parameterless loss head (reference: LossLayer.java)."""

    loss: str = "mcxent"

    def has_params(self):
        return False


@register_config("layer.activation")
@dataclasses.dataclass(kw_only=True)
class ActivationLayer(BaseLayerConf):
    """Standalone activation (reference: ActivationLayer.java)."""

    def has_params(self):
        return False


@register_config("layer.dropout")
@dataclasses.dataclass(kw_only=True)
class DropoutLayer(BaseLayerConf):
    """Standalone dropout (reference: DropoutLayer.java)."""

    def has_params(self):
        return False


@register_config("layer.embedding")
@dataclasses.dataclass(kw_only=True)
class EmbeddingLayer(FeedForwardLayerConf):
    """Index lookup layer (reference: EmbeddingLayer.java). Input: integer
    indices [batch] or [batch, 1]; the lookup is a row gather.

    `host_resident=True` declares the table lives on the HOST (sharded
    across paramserver endpoints, rows pulled/pushed through
    parallel/sparse.SparseEmbeddingPipeline) rather than in device HBM —
    the residency audit (JX008) and dead-weight liveness (JX005) then
    exempt its weights from the per-chip memory picture."""

    has_bias: bool = True
    host_resident: bool = False


@register_config("layer.convolution")
@dataclasses.dataclass(kw_only=True)
class ConvolutionLayer(FeedForwardLayerConf):
    """2D convolution, NHWC (reference: nn/conf/layers/ConvolutionLayer.java;
    runtime im2col+gemm at nn/layers/convolution/ConvolutionLayer.java:177-201
    — no explicit im2col here)."""

    kernel_size: Sequence[int] = (5, 5)
    stride: Sequence[int] = (1, 1)
    padding: Sequence[int] = (0, 0)
    convolution_mode: str = ConvolutionMode.TRUNCATE
    dilation: Sequence[int] = (1, 1)
    has_bias: bool = True

    def output_type(self, it):
        if not isinstance(it, ConvolutionalInput):
            raise ValueError(f"ConvolutionLayer needs convolutional input, got {it}")
        h = _conv_out(it.height, self.kernel_size[0], self.stride[0], self.padding[0], self.convolution_mode)
        w = _conv_out(it.width, self.kernel_size[1], self.stride[1], self.padding[1], self.convolution_mode)
        return ConvolutionalInput(h, w, self.n_out)

    def infer_n_in(self, it) -> None:
        if self.n_in is None and isinstance(it, ConvolutionalInput):
            self.n_in = it.channels


@register_config("layer.convolution1d")
@dataclasses.dataclass(kw_only=True)
class Convolution1DLayer(FeedForwardLayerConf):
    """1D convolution over time (reference: Convolution1DLayer.java).
    Input [batch, time, nIn] -> [batch, time', nOut]."""

    kernel_size: int = 5
    stride: int = 1
    padding: int = 0
    convolution_mode: str = ConvolutionMode.TRUNCATE
    has_bias: bool = True

    def output_type(self, it):
        if not isinstance(it, RecurrentInput):
            raise ValueError(f"Convolution1DLayer needs recurrent input, got {it}")
        ts = it.timesteps
        if ts is not None:
            ts = _conv_out(ts, self.kernel_size, self.stride, self.padding, self.convolution_mode)
        return RecurrentInput(self.n_out, ts)

    def infer_n_in(self, it) -> None:
        if self.n_in is None:
            self.n_in = it.size


@register_config("layer.subsampling")
@dataclasses.dataclass(kw_only=True)
class SubsamplingLayer(LayerConf):
    """2D pooling (reference: SubsamplingLayer.java)."""

    pooling_type: str = PoolingType.MAX
    kernel_size: Sequence[int] = (2, 2)
    stride: Sequence[int] = (2, 2)
    padding: Sequence[int] = (0, 0)
    convolution_mode: str = ConvolutionMode.TRUNCATE
    pnorm: int = 2

    def has_params(self):
        return False

    def output_type(self, it):
        if not isinstance(it, ConvolutionalInput):
            raise ValueError(f"SubsamplingLayer needs convolutional input, got {it}")
        h = _conv_out(it.height, self.kernel_size[0], self.stride[0], self.padding[0], self.convolution_mode)
        w = _conv_out(it.width, self.kernel_size[1], self.stride[1], self.padding[1], self.convolution_mode)
        return ConvolutionalInput(h, w, it.channels)


@register_config("layer.subsampling1d")
@dataclasses.dataclass(kw_only=True)
class Subsampling1DLayer(LayerConf):
    """1D pooling over time (reference: Subsampling1DLayer.java)."""

    pooling_type: str = PoolingType.MAX
    kernel_size: int = 2
    stride: int = 2
    padding: int = 0
    convolution_mode: str = ConvolutionMode.TRUNCATE
    pnorm: int = 2

    def has_params(self):
        return False

    def output_type(self, it):
        ts = it.timesteps
        if ts is not None:
            ts = _conv_out(ts, self.kernel_size, self.stride, self.padding, self.convolution_mode)
        return RecurrentInput(it.size, ts)


@register_config("layer.batch_norm")
@dataclasses.dataclass(kw_only=True)
class BatchNormalization(BaseLayerConf):
    """Batch normalization (reference: nn/conf/layers/BatchNormalization.java;
    cuDNN helper in deeplearning4j-cuda).
    Normalizes over all axes except the last (channels/features)."""

    decay: float = 0.9
    eps: float = 1e-5
    gamma: float = 1.0  # init value
    beta: float = 0.0
    lock_gamma_beta: bool = False
    n_in: Optional[int] = None

    def infer_n_in(self, it) -> None:
        if self.n_in is None:
            self.n_in = it.channels if isinstance(it, ConvolutionalInput) else it.arity()


@register_config("layer.lrn")
@dataclasses.dataclass(kw_only=True)
class LocalResponseNormalization(LayerConf):
    """Cross-channel LRN (reference: LocalResponseNormalization.java,
    CudnnLocalResponseNormalizationHelper — here jnp window sum over the
    channel axis)."""

    k: float = 2.0
    n: float = 5.0
    alpha: float = 1e-4
    beta: float = 0.75

    def has_params(self):
        return False


@register_config("layer.zero_padding")
@dataclasses.dataclass(kw_only=True)
class ZeroPaddingLayer(LayerConf):
    """Spatial zero padding (reference: ZeroPaddingLayer.java).
    padding = (top, bottom, left, right)."""

    padding: Sequence[int] = (1, 1, 1, 1)

    def has_params(self):
        return False

    def output_type(self, it):
        pt, pb, pl, pr = self.padding
        return ConvolutionalInput(it.height + pt + pb, it.width + pl + pr, it.channels)


@register_config("layer.global_pooling")
@dataclasses.dataclass(kw_only=True)
class GlobalPoolingLayer(LayerConf):
    """Global pooling over spatial or time dims
    (reference: GlobalPoolingLayer.java). CNN input -> pool H,W;
    RNN input -> pool time (mask-aware)."""

    pooling_type: str = PoolingType.MAX
    pnorm: int = 2
    collapse_dimensions: bool = True

    def has_params(self):
        return False

    def output_type(self, it):
        if isinstance(it, ConvolutionalInput):
            return FeedForwardInput(it.channels)
        if isinstance(it, RecurrentInput):
            return FeedForwardInput(it.size)
        return it


@dataclasses.dataclass(kw_only=True)
class BaseRecurrentLayerConf(FeedForwardLayerConf):
    def output_type(self, it):
        ts = it.timesteps if isinstance(it, RecurrentInput) else None
        return RecurrentInput(self.n_out, ts)

    def infer_n_in(self, it) -> None:
        if self.n_in is None:
            self.n_in = it.size if isinstance(it, RecurrentInput) else it.arity()


@register_config("layer.lstm")
@dataclasses.dataclass(kw_only=True)
class LSTM(BaseRecurrentLayerConf):
    """LSTM without peepholes (reference: nn/conf/layers/LSTM.java;
    runtime LSTMHelpers.java — here a time loop over a fused gate matmul,
    with hand-written CUDA kernels behind the helper SPI)."""

    forget_gate_bias_init: float = 1.0
    gate_activation: str = "sigmoid"


@register_config("layer.self_attention")
@dataclasses.dataclass(kw_only=True)
class SelfAttentionLayer(BaseRecurrentLayerConf):
    """Multi-head self-attention over the time axis — capability BEYOND
    the reference (DL4J 0.8 predates attention; SURVEY §5 lists
    long-context as greenfield). [b, t, nIn] -> [b, t, nOut]; nOut must
    be divisible by n_heads. ``causal`` masks future positions. The
    sequence-parallel execution of the same math is
    parallel/sequence.ring_self_attention."""

    n_heads: int = 4
    causal: bool = False
    projection_bias: bool = True

    def output_type(self, it):
        ts = it.timesteps if isinstance(it, RecurrentInput) else None
        return RecurrentInput(self.n_out, ts)


@register_config("layer.graves_lstm")
@dataclasses.dataclass(kw_only=True)
class GravesLSTM(BaseRecurrentLayerConf):
    """LSTM with peephole connections, Graves (2013) formulation
    (reference: GravesLSTM.java + LSTMHelpers.java:62,291)."""

    forget_gate_bias_init: float = 1.0
    gate_activation: str = "sigmoid"


@register_config("layer.graves_bidirectional_lstm")
@dataclasses.dataclass(kw_only=True)
class GravesBidirectionalLSTM(BaseRecurrentLayerConf):
    """Bidirectional peephole LSTM. Separate forward/backward parameter sets;
    the two directions' outputs are element-wise ADDED, so n_out stays n_out
    (reference: nn/layers/recurrent/GravesBidirectionalLSTM.java:205
    `fwdOutput.addi(backOutput)`)."""

    forget_gate_bias_init: float = 1.0
    gate_activation: str = "sigmoid"


@register_config("layer.autoencoder")
@dataclasses.dataclass(kw_only=True)
class AutoEncoder(FeedForwardLayerConf):
    """Denoising autoencoder (reference: nn/conf/layers/AutoEncoder.java,
    runtime nn/layers/feedforward/autoencoder/AutoEncoder.java). Supervised
    path behaves like a dense layer; unsupervised pretraining reconstructs
    corrupted input."""

    corruption_level: float = 0.3
    sparsity: float = 0.0
    loss: str = "mse"


@register_config("layer.rbm")
@dataclasses.dataclass(kw_only=True)
class RBM(FeedForwardLayerConf):
    """Restricted Boltzmann machine (reference: nn/conf/layers/RBM.java +
    nn/layers/feedforward/rbm/RBM.java — CD-k contrastive divergence with
    HiddenUnit/VisibleUnit types, :102,223-279). Supervised path behaves
    like a dense layer (propUp); unsupervised pretraining runs CD-k."""

    hidden_unit: str = "binary"  # binary | gaussian | rectified
    visible_unit: str = "binary"  # binary | gaussian
    k: int = 1  # CD-k Gibbs steps
    sparsity: float = 0.0


@register_config("layer.vae")
@dataclasses.dataclass(kw_only=True)
class VariationalAutoencoder(FeedForwardLayerConf):
    """VAE as a layer (reference: nn/conf/layers/variational/
    VariationalAutoencoder.java:40-54 — encoder/decoder MLP sizes, pluggable
    reconstruction distribution, ELBO objective; runtime impl 1,120 LoC)."""

    encoder_layer_sizes: List[int] = dataclasses.field(default_factory=lambda: [100])
    decoder_layer_sizes: List[int] = dataclasses.field(default_factory=lambda: [100])
    pzx_activation: str = "identity"
    reconstruction_distribution: Optional[dict] = None  # {"type": "gaussian"|"bernoulli", "activation": ...}
    num_samples: int = 1


@register_config("layer.frozen")
@dataclasses.dataclass(kw_only=True)
class FrozenLayer(LayerConf):
    """Wrapper marking an inner layer's params as non-trainable
    (reference: nn/layers/FrozenLayer.java, used by TransferLearning)."""

    inner: Optional[LayerConf] = None

    def output_type(self, it):
        return self.inner.output_type(it)

    def infer_n_in(self, it) -> None:
        self.inner.infer_n_in(it)

    def has_params(self):
        return self.inner.has_params()


# -- decoder language-model layers (Granite-4.0-H hybrid: models/granite_hybrid.py)
# Capability beyond the reference, as SelfAttentionLayer is. Each maps
# [b, t, n] to [b, t, n'] over the time axis and holds no recurrent carry.


def _seq_size(it) -> int:
    return it.size if isinstance(it, RecurrentInput) else it.arity()


def _seq_out(it, n: int):
    return RecurrentInput(n, it.timesteps if isinstance(it, RecurrentInput) else None)


@dataclasses.dataclass(kw_only=True)
class SequenceLayerConf(BaseLayerConf):
    """A [b, t, n_in] -> [b, t, n_out] layer; n_out None keeps the width."""

    n_in: Optional[int] = None
    n_out: Optional[int] = None

    def output_type(self, it):
        return _seq_out(it, self.n_out if self.n_out is not None else self.n_in)

    def infer_n_in(self, it) -> None:
        if self.n_in is None:
            self.n_in = _seq_size(it)


@register_config("layer.sequence_embedding")
@dataclasses.dataclass(kw_only=True)
class SequenceEmbeddingLayer(SequenceLayerConf):
    """Token-id lookup over a sequence: integer ids [b, t] -> [b, t, n_out]
    rows of W [n_in (vocabulary), n_out], no bias. The recurrent input
    type's size is the vocabulary."""


@register_config("layer.rms_norm")
@dataclasses.dataclass(kw_only=True)
class RMSNormLayer(SequenceLayerConf):
    """RMSNorm over the last axis (Zhang & Sennrich, arXiv:1910.07467):
    x / sqrt(mean(x^2) + eps) * gamma, the statistic in f32."""

    eps: float = 1e-5


@register_config("layer.gated_mlp")
@dataclasses.dataclass(kw_only=True)
class GatedMLPLayer(SequenceLayerConf):
    """Gated MLP (SwiGLU with activation silu; Shazeer, arXiv:2002.05202):
    W_out^T (act(x W_in[:, :k]) * x W_in[:, k:]) with k = hidden_size, no
    bias; the output keeps the input width."""

    hidden_size: int = 0


@register_config("layer.gqa_attention")
@dataclasses.dataclass(kw_only=True)
class GroupedQueryAttentionLayer(SequenceLayerConf):
    """Grouped-query self-attention (Ainslie et al., arXiv:2305.13245):
    n_heads query heads of head_dim share n_kv_heads key/value heads,
    causal scores q k^T * score_scale (None: 1/sqrt(head_dim)), no
    position encoding and no bias, then the output projection back to the
    input width. Never builds a [t, t] score tensor: fused attention on
    the card, query blocks on the CPU."""

    n_heads: int = 32
    n_kv_heads: int = 8
    head_dim: int = 64
    score_scale: Optional[float] = None


@register_config("layer.mamba2")
@dataclasses.dataclass(kw_only=True)
class Mamba2Layer(SequenceLayerConf):
    """Mamba-2 mixer (Dao & Gu, arXiv:2405.21060): in_proj to
    [z | x B C | dt] (no bias), a causal depthwise conv of width d_conv
    with bias on x B C then SiLU, dt = softplus(dt + dt_bias),
    A = -exp(A_log), the SSD chunked scan over chunk_size steps with the
    D x skip, the gated RMSNorm norm(y * SiLU(z)) and out_proj back to the
    input width. The inner width is n_heads * head_dim."""

    n_heads: int = 64
    head_dim: int = 64
    d_state: int = 128
    n_groups: int = 1
    d_conv: int = 4
    chunk_size: int = 256
    norm_eps: float = 1e-5


@register_config("layer.tied_output")
@dataclasses.dataclass(kw_only=True)
class TiedOutputLayer(SequenceLayerConf):
    """Decoder head that reads the embedding table of the vertex `tied_to`
    (a SequenceEmbeddingLayer, W [n_out, n_in]) as its own weight, one
    leaf for both uses: logits = x W^T / logits_scaling over [b, t, n_in],
    trained by `loss` (sparse_mcxent: integer labels [b, t]). Holds no
    parameters of its own."""

    tied_to: str = ""
    logits_scaling: float = 1.0
    loss: str = "sparse_mcxent"

    def has_params(self) -> bool:
        return False
