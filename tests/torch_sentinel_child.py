"""Subprocess half of tests/test_torch_sentinel.py, the port's counterpart
of tests/sentinel_child.py.

Runs a small deterministic fit on the CPU with checkpointing and the
divergence sentinel armed, under a seeded NaN-at-step-k fault plan,
printing one flushed line per training step ("STEP <iteration> <score>")
and per sentinel event ("EVENT <kind>"), so that the parent can SIGKILL
the process at a moment of its choosing: the mid-rollback kill holds
fire until "EVENT train_rollback", and the child's own sleep inside the
event hook keeps the rollback restore in flight when the signal lands.
The builders live here and the parent imports them, so the killed run
and the resumed run are the same model on the same batches. Imports no
JAX.
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402

N_EXAMPLES = 128
BATCH = 8
N_FEATURES = 8
N_CLASSES = 3
NAN_STEP = 8  # 1-based train_step invocation the plan taints


def build_net(seed: int = 7):
    from deeplearning4j_tpu_torch.nn.conf import (
        DenseLayer,
        NeuralNetConfiguration,
        OutputLayer,
        Updater,
    )
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork

    conf = (NeuralNetConfiguration.builder().seed(seed).updater(Updater.SGD)
            .learning_rate(0.05).weight_init("xavier").list()
            .layer(DenseLayer(n_in=N_FEATURES, n_out=8, activation="tanh"))
            .layer(OutputLayer(n_in=8, n_out=N_CLASSES,
                               activation="softmax", loss="mcxent"))
            .build())
    return MultiLayerNetwork(conf, device="cpu").init()


def build_iterator(seed: int = 0):
    from deeplearning4j_tpu_torch.data import DataSet, ListDataSetIterator

    rng = np.random.default_rng(seed)
    full = DataSet(
        rng.standard_normal((N_EXAMPLES, N_FEATURES)).astype(np.float32),
        np.eye(N_CLASSES, dtype=np.float32)[
            rng.integers(0, N_CLASSES, N_EXAMPLES)])
    return ListDataSetIterator(full, BATCH)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--ckpt-dir", required=True)
    ap.add_argument("--rollback-hold", type=float, default=0.0,
                    help="seconds the train_rollback event hook sleeps "
                         "(widens the parent's mid-rollback kill window)")
    args = ap.parse_args(argv)

    from deeplearning4j_tpu_torch.train.checkpoint import CheckpointListener
    from deeplearning4j_tpu_torch.train.sentinel import DivergenceSentinel
    from deeplearning4j_tpu_torch.utils import faultpoints as fp

    net = build_net()
    listener = CheckpointListener(
        args.ckpt_dir, every_n_iterations=3, every_n_epochs=None,
        keep_last=5, async_save=False)

    def on_event(kind, payload):
        print(f"EVENT {kind}", flush=True)
        if kind == "train_rollback" and args.rollback_hold > 0:
            time.sleep(args.rollback_hold)

    sentinel = DivergenceSentinel(rollback_after=1, max_rollbacks=2,
                                  on_event=on_event)

    class StepPrinter:
        def iteration_done(self, model, iteration, info):
            print(f"STEP {iteration} {float(info['score']())}", flush=True)

        def on_epoch_start(self, model, epoch):
            pass

        def on_epoch_end(self, model, epoch):
            pass

    net.set_listeners(listener, StepPrinter())
    net.set_sentinel(sentinel)
    plan = fp.FaultPlan(seed=1).add("train_step", "nan",
                                    between=(NAN_STEP, NAN_STEP))
    with fp.active(plan):
        net.fit(build_iterator(), epochs=1, async_prefetch=False)
    print(f"FIT DONE {float(net._score)}", flush=True)


if __name__ == "__main__":
    main()
