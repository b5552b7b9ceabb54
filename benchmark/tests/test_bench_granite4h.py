"""The Granite-4.0-H cell's files on the CPU: the configuration against the
catalog's published keys, the reference and the counts importing nothing
of the port or JAX, the yardstick's arithmetic by hand, and the cell's own
code (adapter, reference, driver, readers) run end to end at a tiny size
with `--rehearse-cpu`."""

import json
import os
import subprocess
import sys

import pytest
import tiny

from benchmark import harness

ROOT = tiny.ROOT
SPEC = harness.Spec(ROOT)
CFG = SPEC.config("granite4h-micro")
REF = SPEC.module("reference", "granite4h")
SSD = SPEC.module("counts", "ssd_scan")

# the catalog's config of ibm-granite/granite-4.0-h-micro (the model-configs
# guide's architectures.jsonl), the keys the file must hold unchanged
PUBLISHED = {
    "attention_bias": False, "attention_multiplier": 0.015625, "embedding_multiplier": 12,
    "hidden_act": "silu", "hidden_size": 2048, "intermediate_size": 8192,
    "logits_scaling": 8, "mamba_chunk_size": 256, "mamba_conv_bias": True,
    "mamba_d_conv": 4, "mamba_d_head": 64, "mamba_d_state": 128, "mamba_expand": 2,
    "mamba_n_groups": 1, "mamba_n_heads": 64, "mamba_proj_bias": False,
    "max_position_embeddings": 131072, "model_type": "granitemoehybrid",
    "normalization_function": "rmsnorm", "num_attention_heads": 32,
    "num_experts_per_tok": 0, "num_key_value_heads": 8, "num_local_experts": 0,
    "position_embedding_type": "nope", "residual_multiplier": 0.22, "rms_norm_eps": 1e-05,
    "rope_scaling": None, "rope_theta": 10000, "shared_intermediate_size": 8192,
    "tie_word_embeddings": True, "vocab_size": 100352}

TINY = dict(CFG, name="tiny_granite", hidden_size=64, intermediate_size=128,
            shared_intermediate_size=128, mamba_n_heads=4, mamba_d_head=16, mamba_expand=1,
            mamba_d_state=16, mamba_chunk_size=16, num_attention_heads=4,
            num_key_value_heads=2, vocab_size=97, seq_len=40,
            precision="f32", reduced=["num_hidden_layers"], assumed={})
TINY_TRAFFIC = {"driver": "train_fit", "batch": 2, "length": 40, "fused_steps": 2, "pool": 4,
                "rate_metric": "train_tokens_per_s", "trace_seconds": 0.3,
                "start_from": "program"}


def test_the_configuration_keeps_every_published_key():
    for k, v in PUBLISHED.items():
        assert CFG[k] == v, k
    assert CFG["layer_types"] == ["attention" if i % 10 == 5 else "mamba" for i in range(40)]
    assert CFG["num_hidden_layers"] == 10 and CFG["reduced"] == ["num_hidden_layers"]
    assert CFG["published"]["num_hidden_layers"] == 40
    # one whole period of the pattern at its 9:1 ratio
    assert REF.layer_types(CFG).count("mamba") == 9 and REF.layer_types(CFG)[5] == "attention"


def test_parameters_and_flops_by_hand():
    """Per Mamba-2 layer: in_proj 2048 x 8512, conv 4352 x (4 + 1), dt_bias,
    A_log and D 3 x 64, the gated norm 4096, out_proj 4096 x 2048; the
    attention layer's q, k, v, o 2048 x (2048 + 512 + 512) + 2048 x 2048;
    each layer's gated MLP 2048 x 16384 + 8192 x 2048 and two norms; the
    embedding 100352 x 2048 and the final norm."""
    mlp = 2048 * 16384 + 8192 * 2048 + 2 * 2048
    mamba = 2048 * 8512 + 4352 * 5 + 3 * 64 + 4096 + 4096 * 2048 + mlp
    attn = 2048 * 3072 + 2048 * 2048 + mlp
    assert mamba == 76_182_976 and attn == 60_821_504
    assert REF.num_params(CFG) == 9 * mamba + attn + 100352 * 2048 + 2048 == 951_991_232
    # 1.999 GFLOP a token at 16,384: 9 x 155.5 M + 188.7 M + 411.0 M; the
    # SSD's causal halves of the [256, 256] squares, C B^T once for the
    # group of 64 heads
    f = REF.forward_flops_per_sample(CFG)
    ssd = 64 * (257 * (128 // 64 + 64) + 4 * 128 * 64)
    assert ssd == 3_182_720
    m = 2 * 2048 * 8512 + 2 * 4096 * 2048 + ssd + 2 * 2048 * 16384 + 2 * 8192 * 2048
    a = (2 * 2048 * 3072 + 2 * 2048 * 2048 + 2 * 2048 * 16384 + 2 * 8192 * 2048
         + 4 * 2048 * 16385 / 2)
    assert f == 9 * m + a + 2 * 2048 * 100352
    assert 1.999e9 < f < 2.0e9


def test_ssd_counts_by_hand():
    """Per Mamba-2 layer and 16,384 tokens: forward 3.18 MFLOP a token,
    bytes x and y bf16 [T, 64, 64], dt f32 [T, 64], B and C bf16 [T, 128],
    A and D; backward twice the FLOPs."""
    unit = {"phase": "train", "batch": 1, "length": 16384}
    work = SSD.work(CFG, REF, unit, 2)
    assert len(work) == 18
    (f, b), (g, c) = work[:2]
    T = 16384
    assert f == T * 3_182_720 and g == 2 * f
    x, bc, dt = T * 4096 * 2, 2 * T * 128 * 2, 4 * T * 64
    assert b == 2 * x + bc + dt + 8 * 64
    assert c == 3 * x + 2 * bc + 2 * dt + 16 * 64
    assert SSD.work(CFG, REF, dict(unit, phase="infer"), 2)[1:] != work[1:]


def test_reference_and_counts_import_nothing_of_the_port_or_jax():
    code = ("import sys; sys.path.insert(0, %r)\n"
            "import benchmark.reference.granite4h, benchmark.counts.ssd_scan\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'flax', 'deeplearning4j_tpu', 'deeplearning4j_tpu_torch')]\n"
            "print(bad)\n") % ROOT
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120, check=True)
    assert out.stdout.strip() == "[]"


def test_the_readers_find_nothing_without_a_trace():
    from benchmark import readers

    r = readers.Reading(spec=SPEC, cfg=CFG, traffic=TINY_TRAFFIC, ref=REF, device_name="cpu")
    for name in ("mfu.train_granite", "ssd_roofline.train", "ssd_share.granite"):
        assert SPEC.reader(name).read(r) is None


@pytest.fixture(scope="module")
def granite_checkout(tmp_path_factory):
    """A tiny checkout with a tiny Granite configuration and cell added
    from files alone."""
    dest = str(tmp_path_factory.mktemp("granite"))
    tiny.make_checkout(dest)
    b = os.path.join(dest, "benchmark")
    json.dump(TINY, open(os.path.join(b, "configs", "tiny_granite.json"), "w"))
    json.dump(TINY_TRAFFIC, open(os.path.join(b, "traffic", "tiny-train-lm.json"), "w"))
    json.dump({"first_loss_gap": 1e-5, "loss_gap": 1e-5, "state_gap_med": 1e-4},
              open(os.path.join(b, "limits", "tiny-granite-train.json"), "w"))
    spec = json.load(open(os.path.join(dest, "BENCHMARK.json")))
    spec["configs"].append({"name": "tiny_granite", "source": TINY["source"],
                            "file": "benchmark/configs/tiny_granite.json",
                            "reduced": TINY["reduced"], "why": "test"})
    spec["workloads"].append({"name": "tiny-granite-train", "config": "tiny_granite",
                              "traffic": "tiny-train-lm", "chips": 1, "why": "test"})
    for m in spec["end_to_end"] + spec["per_layer"]:
        if m["name"] == "train_tokens_per_s" or m["name"] in (
                "mfu.train_granite", "ssd_roofline.train", "ssd_share.granite"):
            m["workloads"].append("tiny-granite-train")
    json.dump(spec, open(os.path.join(dest, "BENCHMARK.json"), "w"), indent=1)
    return dest


@pytest.mark.parametrize("trace", [0, 1])
def test_the_tiny_cell_runs_its_code_on_the_cpu(granite_checkout, trace):
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "tiny-granite-train",
                          "--seed", str(2147483647 + 99), "--seconds", "0.5", "--trace",
                          str(trace), "--rehearse-cpu"], cwd=granite_checkout, env=env,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"] is True, res["checks"]
    assert res["attempted"] > 0
    assert {"first_loss_gap", "loss_gap", "state_gap_med"} <= set(res["checks"])
    if trace:
        # a CPU run has no device metric: the three readers stay silent
        assert not set(res["metrics"]) & {"mfu.train_granite", "ssd_roofline.train",
                                          "ssd_share.granite"}
    else:
        assert set(res["metrics"]) == {"train_tokens_per_s", "setup_s"}
