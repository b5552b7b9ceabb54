"""train_fit: a training cell. The port's `fit` on the fused, graphed path,
fed from a pool of host batches through the port's own input pipeline.

Traffic parameters: `batch` rows a batch (and `length` time steps for a
sequence model), `fused_steps` batches a dispatch (`set_fused_steps`; 1
is the default dispatch, where a TBPTT batch is already one program),
`pool` distinct host batches drawn from the seed and cycled, `rate_metric`
the end-to-end metric the window's samples a second report under,
`trace_seconds` the length of the profiled window of a traced run, and
`start_from` where the compared replay starts ("program" or "weights",
below).

Set-up builds one network, writes the benchmark's weights into it and
drives it through three dispatches by `fit` with the window's feed: the
first runs eagerly (the fused program's warm-up), the second captures its
CUDA graph and replays it, the third replays it, as every dispatch of the
window does. So nothing builds or captures inside the window. The window
is one `fit` over the cycled pool that stops pulling batches at
`--seconds` (whole dispatches only); its rate is every sample trained
over the time from its start to the synchronize after the fit returned.

Correctness (after the window, the network freed) holds the third
dispatch, a replay of the captured graph as the window runs it, to the
plain reference, which runs the same steps on the same batches in
float32 from where the program's started. With `start_from` "program"
that is the parameters and updater state the program held after its
capture (copied to the host), and the first dispatch, from the
benchmark's weights, is compared too, as the start that the reference
skips; with "weights" the benchmark's weights are written back into the
network and its updater state zeroed, in place, before the third, so the
reference takes nothing from the program (for dynamics that no
reference can follow from a state many steps on). The run compares the
numbers its cell's limits file names (`compare`; the first dispatch's
carry the prefix `first_`): the steps' losses (largest relative gap),
and, leaf by leaf, the norm of each parameter's change and of its
updater state's change over the dispatch (the gap between the program's
norm and the reference's, over the larger of the reference's norm of the
leaf and of the median leaf, at the worst or the median leaf; leaves
whose reference gradient is under a thousandth of the median leaf's are
left out). On the card the third dispatch has to be a replay, or the run
records a fault.
"""

from __future__ import annotations

import time

from benchmark import readers, runtime, trace


def make_feed(cfg, traffic):
    """The Feed class over the port's DataSetIterator protocol."""
    from deeplearning4j_tpu_torch.data.dataset import DataSet
    from deeplearning4j_tpu_torch.data.iterators import DataSetIterator

    group = max(1, int(traffic["fused_steps"]))

    class Feed(DataSetIterator):
        """The pool's host batches in turn from `start`: `count` of them,
        or whole dispatches of them until the host clock passes
        `deadline`."""

        def __init__(self, pool, start=0, count=None, deadline=None):
            self.pool, self.start, self.count, self.deadline = pool, start, count, deadline
            self.served = 0
            self.pulls = []  # the host clock at each batch's pull

        def __iter__(self):
            i = self.start
            while True:
                if self.count is not None and self.served >= self.count:
                    return
                if (self.deadline is not None and self.served % group == 0
                        and time.perf_counter() >= self.deadline):
                    return
                x, y = self.pool[i % len(self.pool)]
                i += 1
                self.served += 1
                self.pulls.append(time.perf_counter())
                yield DataSet(x, y)

        def reset(self):
            pass

        def batch_size(self):
            return int(traffic["batch"])

    return Feed, group


def make_pool(ctx, seed):
    """`pool` host batches from the seed: drawn on the device in a few
    calls, then copied to pageable host memory, so each step pays its
    host-to-device copy as a user's loader would."""
    torch, dev, tr = ctx.torch, ctx.device, ctx.traffic
    g = torch.Generator(device=dev).manual_seed(int(seed) ^ 0x5EED5)
    pool = []
    for _ in range(int(tr["pool"])):
        x, y = ctx.ref.make_batch(ctx.cfg, tr, g, dev)
        pool.append((x.cpu(), y.cpu()))
    return pool


def _graph_counts(net):
    """(captures, replays) of the network's fused programs so far."""
    graphs = net.fit_graphs()
    return len(graphs), sum(g["replays"] for g in graphs)


# updaters whose step reads no step count, so that a dispatch from the
# weights with a zero state is the first dispatch's arithmetic
COUNT_FREE_UPDATERS = ("sgd", "nesterovs", "rmsprop")


def program_steps(ctx, weights, pool, Feed, group):
    """Build the network, load the weights and run its first three
    dispatches through `fit` on the pool's batches in turn: the eager
    warm-up, the capture and its replay, and a replay. Where the traffic's
    `start_from` is "weights", the weights are written back and the
    updater state zeroed, in place, before the third. Returns (net,
    readings of the first and of the third dispatch, the parameters and
    updater state the third started from (on the host; a state None is
    zero), whether the third was a replay of a captured graph)."""
    torch, model = ctx.torch, ctx.model
    net = model.build(ctx.cfg, ctx.device)
    if group > 1:
        net.set_fused_steps(group)
    model.load(net, weights)
    net.fit(Feed(pool, start=0, count=group))
    with torch.no_grad():
        first = _readings(model.step_losses(net), model.params(net), weights,
                          model.updater_state(net), None)
    net.fit(Feed(pool, start=group, count=group))
    if start_from(ctx) == "weights":
        model.load(net, weights)
        p0, s0 = weights, None
    else:
        with torch.no_grad():
            p0 = {k: v.detach().float().to("cpu", copy=True)
                  for k, v in model.params(net).items()}
            s0 = {k: v.detach().float().to("cpu", copy=True)
                  for k, v in model.updater_state(net).items()}
    graphs = _graph_counts(net)
    net.fit(Feed(pool, start=2 * group, count=group))
    captures, replays = _graph_counts(net)
    replayed = ctx.device.type != "cuda" or (captures == graphs[0] >= 1
                                             and replays == graphs[1] + 1)
    with torch.no_grad():
        third = _readings(model.step_losses(net), model.params(net), p0,
                          model.updater_state(net), s0)
    return net, {"first": first, "replay": third}, (p0, s0), replayed


def start_from(ctx) -> str:
    """Where the compared replay starts: "program", the parameters and
    updater state the program holds after its capture (the reference
    follows from them), or "weights", the benchmark's weights written back
    with a zero updater state (for dynamics that the reference cannot
    follow from a state many steps on)."""
    mode = ctx.traffic.get("start_from", "program")
    if mode not in ("program", "weights"):
        raise ValueError(f"start_from {mode!r}: 'program' or 'weights'")
    if mode == "weights" and ctx.cfg["updater"] not in COUNT_FREE_UPDATERS:
        raise ValueError(f"start_from 'weights' needs an updater that reads no step "
                         f"count ({COUNT_FREE_UPDATERS}), not {ctx.cfg['updater']!r}")
    return mode


def _readings(losses, params, before, state, state_before, g1=None):
    """A side's losses, and the norms of its parameters' changes and of
    its updater state's changes over the dispatch, leaf by leaf (a state
    `state_before` None started at zero)."""
    def norm(v, b):
        v = v.float()
        return float(v.norm() if b is None else (v - b.to(v.device)).norm())

    return {"losses": losses,
            "dp": {k: norm(v, before[k]) for k, v in params.items()},
            "state": {k: norm(v, None if state_before is None else state_before[k])
                      for k, v in state.items()},
            "g1": g1}


def reference_steps(ctx, start, pool, group, control=""):
    """The reference (or a control: "tf32", "fp8"; or a witness: "bf16",
    "f64", the reference in float64) over the dispatches the program's
    readings cover: the first from the weights, the third from where the
    program's started (`start`: (weights, (parameters, state)))."""
    torch, dev, prec = ctx.torch, ctx.device, ctx.precision
    weights, (p0, s0) = start
    dt = torch.float64 if control == "f64" else torch.float32
    q = prec.quantizer("" if control == "f64" else control)
    out = {}
    for kind, w, st, first_batch in (("first", weights, None, 0),
                                     ("replay", p0, s0, 2 * group)):
        w = {k: v.to(dev, dt) for k, v in w.items()}
        st = None if st is None else {k: v.to(dev, dt) for k, v in st.items()}
        batches = [tuple(t.to(dev, dt) for t in pool[(first_batch + j) % len(pool)])
                   for j in range(group)]
        with prec.exact_f32():
            losses, p, s, g1 = ctx.ref.train_steps(ctx.cfg, w, batches, q, st)
        with torch.no_grad():
            out[kind] = _readings(losses, p, w, s, st, g1)
        del w, st, batches, p, s
    return out


NUMBERS = ("loss_gap", "loss_gap3", "param_gap", "param_gap_med", "state_gap",
           "state_gap_med")


def compare_all(h, prog, ref):
    """`compare` of both dispatches: {name: value} with the first
    dispatch's names prefixed `first_`, and the leaves behind the worst."""
    nums, worst = {}, {}
    for kind, prefix in (("first", "first_"), ("replay", "")):
        n, w = compare(h, prog[kind], ref[kind])
        nums.update({prefix + k: v for k, v in n.items()})
        worst.update({prefix + k: v for k, v in w.items()})
    return nums, worst


def compare(h, prog, ref):
    """The numbers a training cell can compare for one dispatch, {name:
    value}, and the leaves behind the worst ones: the largest relative
    gap of a step's loss over the dispatch (`loss_gap`) and over its
    first three steps (`loss_gap3`); of the parameters' change and of
    the updater state's change over the dispatch, the worst leaf's gap
    between the program's norm and the reference's (`param_gap`,
    `state_gap`) and the median leaf's (`param_gap_med`,
    `state_gap_med`). The cell's limits file names the ones compared."""
    if len(prog["losses"]) != len(ref["losses"]):
        return {k: float("inf") for k in NUMBERS}, {}
    gaps = [h.rel_gap(a, b) for a, b in zip(prog["losses"], ref["losses"])]
    leaves = h.counted_leaves(ref["g1"])
    dp = h.leaf_gaps(prog["dp"], ref["dp"], leaves)
    st = h.leaf_gaps(prog["state"], ref["state"], leaves)
    wp, ws = max(dp, key=dp.get), max(st, key=st.get)
    return ({"loss_gap": max(gaps), "loss_gap3": max(gaps[:3]),
             "param_gap": dp[wp], "param_gap_med": h.median(dp.values()),
             "state_gap": st[ws], "state_gap_med": h.median(st.values())},
            {"param_gap": wp, "state_gap": ws, "leaves": len(leaves),
             "step_gaps": gaps})


def run(ctx):
    torch, dev, cfg, tr, ref, h = ctx.torch, ctx.device, ctx.cfg, ctx.traffic, ctx.ref, ctx.harness
    Feed, group = make_feed(cfg, tr)
    weights = ref.make_weights(cfg, ctx.seed, dev)
    pool = make_pool(ctx, ctx.seed)
    ctx.log(f"weights and {len(pool)} host batches made")
    net, prog, start, replayed = program_steps(ctx, weights, pool, Feed, group)
    ctx.log(f"first dispatch: losses {prog['first']['losses'][:4]}; "
            f"third: {prog['replay']['losses'][:4]}")
    runtime.sync(torch, dev)
    hist = ("fit_dispatch_seconds", "fit_data_wait_seconds")
    before = runtime.histograms(hist)
    t0 = time.perf_counter()
    setup_s = t0 - ctx.t_start
    feed = Feed(pool, start=3 * group, deadline=t0 + ctx.seconds)
    net.fit(feed)
    runtime.sync(torch, dev)
    window = time.perf_counter() - t0
    after = runtime.histograms(hist)
    samples = ref.samples_per_batch(cfg, tr)
    rate = feed.served * samples / window
    half = feed.served // 2
    if half:  # a diagnostic: the rate of each half of the window, by the pulls
        t_mid = feed.pulls[half]
        ctx.log(f"halves {half * samples / (t_mid - t0):.1f}, "
                f"{(feed.served - half) * samples / (t0 + window - t_mid):.1f} samples/s")
    ctx.log(f"window {window:.3f} s, {feed.served} batches, {rate:.1f} samples/s")
    out = {"attempted": feed.served, "failed": 0, "card": runtime.card_line(torch, dev)}
    if ctx.trace:
        reading = readers.Reading(spec=ctx.spec, cfg=cfg, traffic=tr, ref=ref,
                                  device_name=(torch.cuda.get_device_name(dev)
                                               if dev.type == "cuda" else "cpu"))
        reading.rate = rate
        reading.flops_per_sample = 3.0 * ref.forward_flops_per_sample(cfg)
        reading.registry = runtime.delta(before, after)
        tfeed = Feed(pool, start=0)

        def traced():
            tfeed.deadline = time.perf_counter() + float(tr["trace_seconds"])
            net.fit(tfeed)

        tr_obj = trace.profile(torch, traced, dev)
        reading.trace = tr_obj
        reading.units = ref.units_per_batch(cfg, tr) * tfeed.served
        out["metrics"] = readers.evaluate(ctx.spec, ctx.cell["name"], reading)
        out["trace"] = tr_obj
        out["breakdown"] = {"device_ops": tr_obj.top_ops(10), "idle_gaps": tr_obj.idle_gaps(10)}
    else:
        out["metrics"] = {tr["rate_metric"]: rate, "setup_s": setup_s}
    out["memory_peak_bytes"] = runtime.memory_peak(torch, dev)
    del net, feed
    runtime.release(torch, dev)
    refr = reference_steps(ctx, (weights, start), pool, group)
    nums, worst = compare_all(h, prog, refr)
    ctx.log(f"compared: {nums}, worst leaves {worst}")
    checks = h.Checks(ctx.limits)
    for k, v in nums.items():
        if k in ctx.limits:  # the limits file names the numbers compared
            checks.add(k, v)
    if not replayed:
        checks.fault("the third dispatch was not a replay of a captured graph")
    out["checks"] = checks
    return out


def calibrate(ctx, seeds, n_control, fault_names, emit):
    """The readings the limits are set from, at the cell's own size: for
    each seed the program's numbers; for the first `n_control` seeds also
    the control's (the reference one precision below the
    configuration's, in the program's place, from the same starts) and
    each planted fault's. `emit(row)` receives a row a seed."""
    from benchmark import faults

    torch, dev, cfg, h = ctx.torch, ctx.device, ctx.cfg, ctx.harness
    Feed, group = make_feed(cfg, ctx.traffic)
    control = ctx.precision.CONTROL_OF[cfg["precision"]]
    for i, seed in enumerate(seeds):
        t = time.perf_counter()
        weights = ctx.ref.make_weights(cfg, seed, dev)
        pool = make_pool(ctx, seed)[:3 * group]
        net, prog, start, replayed = program_steps(ctx, weights, pool, Feed, group)
        del net
        runtime.release(torch, dev)
        refr = reference_steps(ctx, (weights, start), pool, group)
        nums, worst = compare_all(h, prog, refr)
        row = {"seed": seed, "program": nums, "replayed": replayed,
               "losses": prog["replay"]["losses"][:3],
               "ref_losses": refr["replay"]["losses"][:3],
               "program_steps": worst.get("step_gaps")}
        if i < n_control:
            for c in (control, "bf16" if cfg["precision"] == "bf16" else "f64"):
                ctl = reference_steps(ctx, (weights, start), pool, group, control=c)
                kind = "control" if c == control else "witness"
                row[f"{kind}_{c}"], extra = compare_all(h, ctl, refr)
                row[f"{kind}_{c}_steps"] = extra.get("step_gaps")
            for f in fault_names:
                with faults.plant(f):
                    net, fp, fstart, _ = program_steps(ctx, weights, pool, Feed, group)
                del net
                runtime.release(torch, dev)
                # the reference follows the faulted program's own start
                row[f"fault_{f}"] = compare_all(
                    h, fp, reference_steps(ctx, (weights, fstart), pool, group))[0]
        row["seconds"] = time.perf_counter() - t
        emit(row)
