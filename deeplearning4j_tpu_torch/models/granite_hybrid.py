"""IBM Granite-4.0-H (model_type `granitemoehybrid`): a decoder language
model whose layers are Mamba-2 mixers and grouped-query attention, each
followed by a gated MLP, as a ComputationGraph.

From the published config's keys (Hugging Face's
GraniteMoeHybridForCausalLM):

    h = embed(ids) * embedding_multiplier
    per layer i:  h += residual_multiplier * mixer_i(RMSNorm(h))
                  h += residual_multiplier * SwiGLU(RMSNorm(h))
    logits = RMSNorm(h) W_embed^T / logits_scaling

mixer_i is Mamba-2 (nn/layers/ssm.py, the SSD on ops/fused_ssd.py's
kernels) or causal grouped-query attention with score scale
`attention_multiplier` and no position encoding
(`position_embedding_type` "nope"), by `layer_types[i]`. The output head
reads the embedding's table (`tie_word_embeddings`), one leaf for both
uses, and the loss is the mean sparse cross-entropy over the tokens
(labels are the next token's id, [b, t] integers). The config's SiLU is
the port's "swish" activation, x sigmoid(x).

`GRANITE_4_0_H_MICRO` is ibm-granite/granite-4.0-h-micro's config.json
(its shape keys). `granite4h_conf(config, num_hidden_layers=...)` builds
the first layers of any such config; every width is the config's.
"""

from __future__ import annotations

from typing import Optional

from deeplearning4j_tpu_torch.nn.conf import (
    ElementWiseVertex,
    InputType,
    NeuralNetConfiguration,
    ScaleVertex,
)
from deeplearning4j_tpu_torch.nn.conf.layers import (
    GatedMLPLayer,
    GroupedQueryAttentionLayer,
    Mamba2Layer,
    RMSNormLayer,
    SequenceEmbeddingLayer,
    TiedOutputLayer,
)
from deeplearning4j_tpu_torch.nn.compgraph import ComputationGraph

# https://huggingface.co/ibm-granite/granite-4.0-h-micro/blob/main/config.json
GRANITE_4_0_H_MICRO = {
    "attention_bias": False, "attention_multiplier": 0.015625, "embedding_multiplier": 12,
    "hidden_act": "silu", "hidden_size": 2048, "intermediate_size": 8192,
    "layer_types": ["attention" if i % 10 == 5 else "mamba" for i in range(40)],
    "logits_scaling": 8, "mamba_chunk_size": 256, "mamba_conv_bias": True,
    "mamba_d_conv": 4, "mamba_d_head": 64, "mamba_d_state": 128, "mamba_expand": 2,
    "mamba_n_groups": 1, "mamba_n_heads": 64, "mamba_proj_bias": False,
    "max_position_embeddings": 131072, "model_type": "granitemoehybrid",
    "normalization_function": "rmsnorm", "num_attention_heads": 32,
    "num_experts_per_tok": 0, "num_hidden_layers": 40, "num_key_value_heads": 8,
    "num_local_experts": 0, "position_embedding_type": "nope", "residual_multiplier": 0.22,
    "rms_norm_eps": 1e-05, "rope_scaling": None, "rope_theta": 10000,
    "shared_intermediate_size": 8192, "tie_word_embeddings": True, "vocab_size": 100352,
}


def _check(cfg) -> None:
    """The keys this builder reads hold what it implements."""
    want = {"model_type": "granitemoehybrid", "normalization_function": "rmsnorm",
            "position_embedding_type": "nope", "tie_word_embeddings": True,
            "num_local_experts": 0, "attention_bias": False, "mamba_proj_bias": False,
            "mamba_conv_bias": True, "hidden_act": "silu"}
    bad = {k: cfg.get(k) for k, v in want.items() if cfg.get(k) != v}
    if bad:
        raise ValueError(f"granite4h_conf builds {want}; the config has {bad}")
    if cfg["mamba_n_heads"] * cfg["mamba_d_head"] != cfg["mamba_expand"] * cfg["hidden_size"]:
        raise ValueError("mamba_n_heads * mamba_d_head must be mamba_expand * hidden_size")


def granite4h_conf(config: Optional[dict] = None, *, num_hidden_layers: Optional[int] = None,
                   seq_len: Optional[int] = None, seed: int = 123,
                   learning_rate: float = 3e-4, beta1: float = 0.9, beta2: float = 0.999,
                   epsilon: float = 1e-8, precision: str = "bf16"):
    """The ComputationGraphConfiguration of `config` (a Granite-4.0-H
    config.json as a dict; GRANITE_4_0_H_MICRO by default) with its first
    `num_hidden_layers` layers (all by default), trained by Adam. Input
    "ids" (token ids [b, t], the recurrent input type's size is the
    vocabulary), output "lm_head" (logits [b, t, vocab] over integer
    labels [b, t]). Linear layers and the embedding draw N(0, 0.02^2),
    Granite's initializer_range."""
    cfg = dict(GRANITE_4_0_H_MICRO if config is None else config)
    _check(cfg)
    n_layers = int(num_hidden_layers or cfg["num_hidden_layers"])
    types = list(cfg["layer_types"])[:n_layers]
    if len(types) < n_layers:
        raise ValueError(f"layer_types has {len(types)} entries for {n_layers} layers")
    hidden, vocab = int(cfg["hidden_size"]), int(cfg["vocab_size"])
    eps, res = float(cfg["rms_norm_eps"]), float(cfg["residual_multiplier"])
    gb = (
        NeuralNetConfiguration.builder()
        .seed(seed)
        .updater("adam")
        .learning_rate(learning_rate)
        .adam_mean_decay(beta1)
        .adam_var_decay(beta2)
        .epsilon(epsilon)
        .weight_init("distribution")
        .dist({"mean": 0.0, "std": 0.02})  # a normal law (no "type": a JSON tag)
        .activation("identity")
        .precision(precision)
        .graph_builder()
        .add_inputs("ids")
        .set_input_types(InputType.recurrent(vocab, seq_len))
    )
    gb.add_layer("embed", SequenceEmbeddingLayer(n_out=hidden), "ids")
    gb.add_vertex("embed_scale", ScaleVertex(scale=float(cfg["embedding_multiplier"])), "embed")
    h = "embed_scale"

    def residual(name, body, h):
        gb.add_layer(f"{name}_norm", RMSNormLayer(eps=eps), h)
        gb.add_layer(name, body, f"{name}_norm")
        gb.add_vertex(f"{name}_scale", ScaleVertex(scale=res), name)
        gb.add_vertex(f"{name}_add", ElementWiseVertex(op="add"), h, f"{name}_scale")
        return f"{name}_add"

    for i, kind in enumerate(types):
        if kind == "mamba":
            mixer = Mamba2Layer(
                n_heads=int(cfg["mamba_n_heads"]), head_dim=int(cfg["mamba_d_head"]),
                d_state=int(cfg["mamba_d_state"]), n_groups=int(cfg["mamba_n_groups"]),
                d_conv=int(cfg["mamba_d_conv"]), chunk_size=int(cfg["mamba_chunk_size"]),
                norm_eps=eps)
        elif kind == "attention":
            mixer = GroupedQueryAttentionLayer(
                n_heads=int(cfg["num_attention_heads"]),
                n_kv_heads=int(cfg["num_key_value_heads"]),
                head_dim=hidden // int(cfg["num_attention_heads"]),
                score_scale=float(cfg["attention_multiplier"]))
        else:
            raise ValueError(f"layer {i}: unknown layer type {kind!r}")
        h = residual(f"l{i}_mixer", mixer, h)
        h = residual(f"l{i}_mlp", GatedMLPLayer(
            hidden_size=int(cfg["shared_intermediate_size"]), activation="swish"), h)
    gb.add_layer("final_norm", RMSNormLayer(eps=eps), h)
    gb.add_layer("lm_head", TiedOutputLayer(
        tied_to="embed", n_out=vocab, logits_scaling=float(cfg["logits_scaling"]),
        activation="softmax", loss="sparse_mcxent"), "final_norm")
    gb.set_outputs("lm_head")
    return gb.build()


def granite4h_network(config: Optional[dict] = None, *, device=None, **kw) -> ComputationGraph:
    """granite4h_conf(config, **kw) built and initialised on `device`."""
    return ComputationGraph(granite4h_conf(config, **kw), device=device).init()
