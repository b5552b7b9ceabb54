"""Subprocess half of tests/test_torch_checkpoint.py — the port's mirror of
tests/fault_tolerance_child.py.

Runs a small deterministic fit of the port (on the CPU) with checkpointing
armed and prints one flushed "STEP <iteration> <score>" line per training
step, so the parent test can kill the process (SIGKILL, or SIGTERM for the
preemption save) at a step of its choosing. The network and data builders
live here and the parent imports them, so the killed run, the resumed run
and the uninterrupted reference run are the same model on the same
batches by construction. Imports nothing of JAX.
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402

from deeplearning4j_tpu_torch.data import DataSet, ListDataSetIterator  # noqa: E402
from deeplearning4j_tpu_torch.train.checkpoint import CheckpointListener  # noqa: E402
from deeplearning4j_tpu_torch.train.listeners import IterationListener  # noqa: E402

N_EXAMPLES = 48
BATCH = 8
N_FEATURES = 5
N_CLASSES = 3
SHUFFLE_SEED = 11


def build_conf(seed: int = 7):
    from deeplearning4j_tpu_torch.nn.conf import (
        DenseLayer,
        InputType,
        NeuralNetConfiguration,
        OutputLayer,
    )

    return (NeuralNetConfiguration.builder().seed(seed).updater("adam")
            .learning_rate(0.02).list()
            .layer(DenseLayer(n_out=12, activation="tanh"))
            .layer(OutputLayer(n_out=N_CLASSES, activation="softmax",
                               loss="mcxent"))
            .set_input_type(InputType.feed_forward(N_FEATURES)).build())


def build_net(seed: int = 7):
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork

    return MultiLayerNetwork(build_conf(seed), device="cpu").init()


def build_data(seed: int = 7):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((N_EXAMPLES, N_FEATURES)).astype(np.float32)
    y = np.zeros((N_EXAMPLES, N_CLASSES), np.float32)
    y[np.arange(N_EXAMPLES), rng.integers(0, N_CLASSES, N_EXAMPLES)] = 1.0
    return x, y


def build_iterator(seed: int = 7):
    """Shuffling iterator: each epoch deals a different (epoch-seeded)
    permutation, so mid-epoch resume reproduces the reference run only if
    the iterator's epoch state is restored."""
    return ListDataSetIterator(DataSet(*build_data(seed)), BATCH,
                               shuffle=True, seed=SHUFFLE_SEED)


class StepPrinter(IterationListener):
    """One flushed line per step — the parent's kill trigger. The sleep
    widens the window between steps so the signal lands at about the step
    the parent chose."""

    def __init__(self, sleep: float = 0.05):
        self.sleep = sleep

    def iteration_done(self, model, iteration, info):
        # .17g round-trips a float64 exactly: the parent compares with ==
        print(f"STEP {iteration} {float(info['score']()):.17g}", flush=True)
        if self.sleep:
            time.sleep(self.sleep)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--mode", choices=["fit", "sigterm"], default="fit")
    ap.add_argument("--ckpt-dir", required=True)
    ap.add_argument("--epochs", type=int, default=3)
    ap.add_argument("--async-save", action="store_true")
    ap.add_argument("--sleep", type=float, default=0.05)
    ap.add_argument("--dump", default=None,
                    help="sigterm mode: flight-recorder crash-dump path")
    args = ap.parse_args()

    sig = args.mode == "sigterm"
    # sigterm mode: no periodic schedule — the only checkpoint that can
    # exist is the one the preemption hook saved
    listener = CheckpointListener(
        args.ckpt_dir, every_n_iterations=(None if sig else 1),
        every_n_epochs=(None if sig else 1), keep_last=3,
        save_on_preemption=sig, async_save=args.async_save)
    if sig and args.dump:
        from deeplearning4j_tpu_torch.utils.blackbox import install_crash_hooks

        install_crash_hooks(args.dump)
    net = build_net()
    net.set_listeners(listener, StepPrinter(args.sleep))
    net.fit(build_iterator(), epochs=args.epochs)
    print("FIT DONE", flush=True)


if __name__ == "__main__":
    main()
