"""Operator CLI (reference: ParallelWrapperMain.java:28-54 — train a
serialized model from flags; NearestNeighborsServer; PlayUIServer runnable).
The port of the JAX package's cli.py: the same 19 subcommands, flags and
exit codes, on the GPU unless the caller passes ``--device cpu``.

    python -m deeplearning4j_tpu_torch.cli train --model-path m.zip \
        --data iris --epochs 3 --batch-size 32 --output trained.zip
    python -m deeplearning4j_tpu_torch.cli evaluate --model-path m.zip --data iris
    python -m deeplearning4j_tpu_torch.cli knn-server --ndarray-path pts.npy
    python -m deeplearning4j_tpu_torch.cli inference-server --model-path m.zip
    python -m deeplearning4j_tpu_torch.cli ui-server --stats-file stats.bin
    python -m deeplearning4j_tpu_torch.cli --device cpu doctor --preset charlstm

``--device`` (before the subcommand; default cuda) is where models load
and run. Without a GPU the CLI raises unless it is given cpu: nothing
drops to the CPU silently. DL4J_LOCKCHECK=1 arms the lock-order sanitizer
for the whole process (utils/locktrace); `locks` reads what it saw.

Data sources: mnist | cifar10 | iris | lfw | csv:<path>:<labelIndex>:<numClasses>
Model zips: this framework's format (utils/model_serializer), a DL4J
reference zip (modelimport/dl4j), or a Keras 1.x .h5 — sniffed by
ModelGuesser the way util/ModelGuesser.java does."""

from __future__ import annotations

import argparse
import sys

# the model sniffer lives beside the serializer it falls back to, so the
# server (a lower layer) imports it without importing the CLI
from deeplearning4j_tpu_torch.utils.model_serializer import (  # noqa: F401
    guess_and_load_model,
)



def _data_iterator(spec: str, batch_size: int, train: bool = True,
                   num_examples: int = None):
    if spec == "mnist":
        from deeplearning4j_tpu_torch.data.mnist import (
            MnistDataFetcher,
            MnistDataSetIterator,
        )

        return MnistDataSetIterator(
            batch_size, train=train, num_examples=num_examples,
            fetcher=MnistDataFetcher(allow_download=True))
    if spec == "cifar10":
        from deeplearning4j_tpu_torch.data.fetchers import CifarDataSetIterator

        return CifarDataSetIterator(batch_size, train=train,
                                    num_examples=num_examples)
    if spec == "iris":
        from deeplearning4j_tpu_torch.data.fetchers import IrisDataSetIterator

        return IrisDataSetIterator(batch_size)
    if spec == "lfw":
        from deeplearning4j_tpu_torch.data.fetchers import LFWDataSetIterator

        return LFWDataSetIterator(batch_size, train=train,
                                  num_examples=num_examples)
    if spec.startswith("csv:"):
        _, path, label_idx, n_classes = spec.split(":")
        from deeplearning4j_tpu_torch.data.records import (
            CSVRecordReader,
            RecordReaderDataSetIterator,
        )

        return RecordReaderDataSetIterator(
            CSVRecordReader(path), batch_size,
            label_index=int(label_idx), num_classes=int(n_classes))
    raise SystemExit(f"unknown --data {spec!r} "
                     "(mnist|cifar10|iris|csv:<path>:<label>:<classes>)")


def cmd_train(args) -> int:
    net = guess_and_load_model(args.model_path, device=args.device)
    it = _data_iterator(args.data, args.batch_size,
                        num_examples=args.num_examples)

    listeners = []
    from deeplearning4j_tpu_torch.train.listeners import ScoreIterationListener

    listeners.append(ScoreIterationListener(args.print_every,
                                            print_fn=print))
    ui_server = None
    if args.ui_port is not None:
        from deeplearning4j_tpu_torch.ui import (
            InMemoryStatsStorage,
            StatsListener,
            UIServer,
        )

        from deeplearning4j_tpu_torch.ui import ConvolutionalIterationListener

        storage = InMemoryStatsStorage()
        net.set_collect_stats(True)
        sl = StatsListener(storage, histogram_bins=20)
        listeners.append(sl)
        listeners.append(ConvolutionalIterationListener(
            storage, sl.session_id, frequency=10))
        ui_server = UIServer(storage, port=args.ui_port)
        print(f"training UI on http://127.0.0.1:{ui_server.start()}/train")
    net.set_listeners(*listeners)

    if args.workers > 1:
        # workers>1 keeps the facade for its minibatch-stacking semantics
        from deeplearning4j_tpu_torch.parallel import (
            ParallelWrapper,
            data_parallel_mesh,
        )

        ParallelWrapper(net, data_parallel_mesh(),
                        workers=args.workers).fit(it, epochs=args.epochs)
    else:
        if args.data_parallel:
            net.set_mesh()  # multi-device fit() would attach one anyway
        net.fit(it, epochs=args.epochs)

    if args.output:
        from deeplearning4j_tpu_torch.utils.model_serializer import save_model

        save_model(net, args.output)
        print(f"saved trained model to {args.output}")
    if ui_server is not None and args.ui_hold:
        print("training done; UI still serving (ctrl-C to exit)")
        try:
            import time

            while True:
                time.sleep(3600)
        except KeyboardInterrupt:
            pass
    return 0


def cmd_evaluate(args) -> int:
    net = guess_and_load_model(args.model_path, device=args.device)
    it = _data_iterator(args.data, args.batch_size, train=False)
    ev = net.evaluate(it)
    print(ev.stats())
    return 0


def cmd_knn_server(args) -> int:
    from deeplearning4j_tpu_torch.serving.knnserver import main as knn_main

    knn_main([
        "--ndarrayPath", args.ndarray_path,
        "--nearestNeighborsPort", str(args.port),
        "--similarityFunction", args.similarity_function,
        "--device", args.device,
    ] + (["--invert"] if args.invert else []))
    return 0


def cmd_inference_server(args) -> int:
    from deeplearning4j_tpu_torch.serving.inference_server import main as inf_main

    argv = [
        "--modelPath", args.model_path,
        "--port", str(args.port),
        "--maxBatchSize", str(args.max_batch_size),
        "--batchTimeoutMs", str(args.batch_timeout_ms),
    ]
    if args.buckets:
        argv += ["--buckets", args.buckets]
    if args.warmup_shape:
        argv += ["--warmupShape", args.warmup_shape]
    if args.replicas != 1:
        argv += ["--replicas", str(args.replicas)]
    if args.devices:
        argv += ["--devices", args.devices]
    if args.decode_slots:
        argv += ["--decodeSlots", str(args.decode_slots)]
        if args.decode_eos is not None:
            argv += ["--decodeEos", str(args.decode_eos)]
        argv += ["--decodeMaxTokens", str(args.decode_max_tokens)]
    argv += ["--device", args.device]
    inf_main(argv)
    return 0


def cmd_ui_server(args) -> int:
    from deeplearning4j_tpu_torch.ui import FileStatsStorage, UIServer

    storage = FileStatsStorage(args.stats_file)
    server = UIServer(storage, port=args.port)
    port = server.start()
    print(f"ui server on http://127.0.0.1:{port}/train "
          f"({len(storage.list_session_ids())} sessions)")
    try:
        import time

        while True:
            time.sleep(3600)
    except KeyboardInterrupt:
        server.stop()
    return 0


def cmd_report(args) -> int:
    """Standalone HTML training report from a stats file — the
    ui-components path: no server, one self-contained artifact
    (ui/report.py)."""
    import os

    from deeplearning4j_tpu_torch.ui import FileStatsStorage
    from deeplearning4j_tpu_torch.ui.report import write_training_report

    if not os.path.exists(args.stats_file):
        # FileStatsStorage creates missing files — a typo'd path would
        # silently produce an empty report instead of an error
        print(f"stats file not found: {args.stats_file}", file=sys.stderr)
        return 2
    storage = FileStatsStorage(args.stats_file)
    out = write_training_report(storage, args.output,
                                session_id=args.session,
                                title=args.title)
    print(f"wrote {out} ({len(storage.list_session_ids())} sessions "
          f"in {args.stats_file})")
    return 0


def cmd_profile(args) -> int:
    """Aggregate a captured profile directory into the op-family
    device-time breakdown used by the PROFILE_*.md tables; --json exports
    it as a machine-readable artifact so bench runs attach breakdowns
    mechanically instead of by hand (utils/profiler.py). The directory
    is one that `utils.profiler.trace(log_dir)` or a `ProfilerListener`
    wrote: a torch.profiler capture summarised by kernel (the JAX
    package reads an xplane directory here). With --preset the static
    cost model (analysis/costmodel) rides along: flops/bytes columns and
    a bound for --steps steps next to the measured times. K4-K8 are each
    held to the work of the conv/BN instances routed to them
    (analysis/kernelcoverage.kernel_costs), every other family to its
    cost-model group; each row says which (`bound_of`)."""
    from deeplearning4j_tpu_torch.utils.profiler import (
        _read_summary,
        family_summary,
        format_summary,
        roofline_columns,
        write_profile_json,
    )

    cost_model = kernel_costs = None
    if args.preset:
        from deeplearning4j_tpu_torch.analysis.costmodel import (
            _helpers_disabled,
            train_step_cost,
        )
        from deeplearning4j_tpu_torch.analysis.kernelcoverage import (
            kernel_costs as _kernel_costs,
        )

        net = _preset_network(args)
        with _helpers_disabled():
            cost_model = train_step_cost(
                net, batch_size=args.batch,
                timesteps=args.timesteps).to_dict()
        # the conv/BN kernels (K4-K8) each against their own instances'
        # work; every other family against its cost-model group
        itemsize = 2 if (args.precision or "f32") == "bf16" else 4
        kernel_costs = _kernel_costs(net.conf, batch=args.batch,
                                     itemsize=itemsize)
        # the static columns are only comparable to the measured trace
        # when the dims match what the trace ran — say what was modeled
        print(f"static cost model: {args.preset} train step at batch "
              f"{args.batch}, x{args.steps} step(s) (set --batch and "
              f"--steps to what the capture actually ran, or the "
              f"flops/bytes columns will not match the measured ms)")
    if args.json:
        payload = write_profile_json(args.log_dir, args.json,
                                     top_ops=args.top,
                                     cost_model=cost_model,
                                     steps=args.steps,
                                     kernel_costs=kernel_costs)
        if not payload["families_ms"]:
            print(f"no device ops found in {args.log_dir} (no "
                  f"utils.profiler capture there)", file=sys.stderr)
        print(f"wrote {args.json} ({len(payload['families_ms'])} op "
              f"families, {payload['total_device_sec'] * 1e3:.3f} ms device)")
        return 0
    rows, device = _read_summary(args.log_dir)
    if not rows:
        print(f"no device ops found in {args.log_dir} (no "
              f"utils.profiler capture there)", file=sys.stderr)
    elif not device:
        print("capture has no device activity (a CPU run): the times "
              "are the aten ops' own CPU time")
    fams = dict(family_summary(rows))
    annotated = roofline_columns(
        {k: round(v * 1e3, 3) for k, v in fams.items()}, cost_model,
        steps=args.steps, kernel_costs=kernel_costs)
    print("device time by op family:")
    for fam, sec in sorted(fams.items(), key=lambda kv: -kv[1])[:args.top]:
        row = annotated.get(fam) or {}
        extra = ""
        if row.get("flops") is not None:
            extra = (f"  [{row['flops'] / 1e9:8.3f} GFLOP "
                     f"{row['bytes'] / 2**20:8.1f} MiB moved, bound "
                     f"{row['bound_ms']:.3f} ms of the {row['bound_of']}]")
        print(f"  {sec * 1e3:9.3f} ms  {fam}{extra}")
    print(format_summary(rows[:args.top]))
    if cost_model:
        print(f"\nstatic cost model (per step at batch "
              f"{cost_model.get('batch')}, cost-model families):")
        for name, fc in sorted(cost_model["families"].items(),
                               key=lambda kv: -kv[1]["flops"])[:args.top]:
            print(f"  {fc['flops'] / 1e9:10.4f} GFLOP "
                  f"{fc['bytes'] / 2**20:9.1f} MiB  {name}")
    return 0


def cmd_perf(args) -> int:
    """Static device cost model of a preset's train step
    (analysis/costmodel): per-primitive-family FLOPs, bytes moved and
    compute- vs memory-bound roofline verdicts on the H100 figures, the
    liveness-based activation-peak and residency estimates, an optional
    cross-check of the model's FLOPs against torch's FlopCounterMode over
    the same trace (--xla, the flag's JAX name: there it compiles for
    XLA's cost_analysis; findings JX007 on divergence, JX008 on memory
    overflow), and a FLOP-drift check against the newest committed
    BENCH_r*.json so accounting changes surface as accounting. Exit 1 on
    ERROR-severity findings."""
    import json as _json

    from deeplearning4j_tpu_torch.analysis import costmodel
    from deeplearning4j_tpu_torch.analysis.findings import (
        format_findings,
        has_errors,
    )

    net = _preset_network(args)
    with costmodel._helpers_disabled():
        cm, counter_flops, findings = costmodel.check_network(
            net, batch_size=args.batch, timesteps=args.timesteps,
            tolerance=args.tolerance, count_flops=args.xla)
    xla_stats = (None if counter_flops is None
                 else {"flops": counter_flops, "source": "FlopCounterMode"})
    roof = cm.roofline()
    rows = cm.table()
    vs_prior = (None if args.no_vs_prior
                else _perf_vs_prior(args.preset, device=args.device))
    # per-conv-instance kernel routing (covered / declined-by-roofline /
    # unsupported) — config-graph walking only, so it rides along free
    # for any conv-bearing preset
    coverage = None
    try:
        from deeplearning4j_tpu_torch.analysis import kernelcoverage

        cov_rows = kernelcoverage.coverage_table(net.conf,
                                                 batch=args.batch)
        if cov_rows:
            coverage = {"rows": cov_rows,
                        "summary": kernelcoverage.coverage_summary(
                            cov_rows)}
    except Exception as e:  # a coverage bug must not kill the cost model
        coverage = {"error": f"{type(e).__name__}: {e}"}
    if args.json:
        payload = {
            "preset": args.preset,
            "batch": args.batch,
            "cost_model": cm.to_dict(),
            "roofline": roof,
            "families": rows,
            "kernel_coverage": coverage,
            "xla": xla_stats,
            "vs_prior": vs_prior,
            "findings": [f.to_dict() for f in findings],
        }
        if args.json == "-":
            print(_json.dumps(payload, indent=2, default=str))
        else:
            with open(args.json, "w") as f:
                _json.dump(payload, f, indent=2, default=str)
            print(f"wrote {args.json}")
        return 1 if has_errors(findings) else 0

    print(f"cost model — {args.preset} train step (batch {args.batch})")
    print(f"  model FLOPs (matmul/conv): {cm.model_flops:.4g}   "
          f"total FLOPs: {cm.flops_total:.4g}   "
          f"bytes moved: {cm.bytes_total:.4g}")
    print(f"  activation peak (liveness est): "
          f"{cm.activation_peak_bytes / 2**20:.2f} MiB   "
          f"resident: {cm.resident_bytes / 2**20:.2f} MiB "
          f"(params {cm.param_bytes / 2**20:.2f} + updater "
          f"{cm.updater_bytes / 2**20:.2f} + data "
          f"{cm.data_bytes / 2**20:.2f} + activations)")
    print(f"  roofline @ {roof['peak_flops'] / 1e12:.0f} TFLOP/s, "
          f"{roof['hbm_bandwidth'] / 1e9:.0f} GB/s "
          f"(ridge {roof['ridge_intensity']:.0f} FLOP/B): "
          f"step >= {roof['step_time_lower_bound_seconds'] * 1e3:.3f} ms "
          f"({roof['bound']}-bound), MFU ceiling "
          f"{roof['mfu_ceiling']:.3f}")
    print(f"  {'family':<28} {'calls':>6} {'GFLOPs':>10} {'MiB':>9} "
          f"{'FLOP/B':>8}  verdict")
    for row in rows[:args.top]:
        print(f"  {row['family']:<28} {row['count']:>6} "
              f"{row['flops'] / 1e9:>10.4f} {row['bytes'] / 2**20:>9.1f} "
              f"{row['intensity']:>8.2f}  {row['verdict']}"
              + ("  (matmul/conv)" if row["mxu"] else ""))
    if args.xla:
        if xla_stats and xla_stats["flops"]:
            rel = (cm.counter_comparable_flops - xla_stats["flops"]) \
                / xla_stats["flops"]
            print(f"  FLOP cross-check: model "
                  f"{cm.counter_comparable_flops:.4g} vs FlopCounterMode "
                  f"{xla_stats['flops']:.4g} ({rel:+.1%}, tolerance "
                  f"{args.tolerance:.0%})")
        else:
            print("  FLOP cross-check: the counter saw no FLOPs (skipped)")
    if coverage and coverage.get("rows"):
        from deeplearning4j_tpu_torch.analysis import kernelcoverage

        print()
        print(kernelcoverage.format_table(coverage["rows"]))
    elif coverage and coverage.get("error"):
        print(f"  kernel coverage: unavailable ({coverage['error']})")
    if vs_prior:
        note = vs_prior.get("note")
        if note:
            print(f"  vs prior ({vs_prior['source']}): {note}")
        else:
            print(f"  vs {vs_prior['source']} {vs_prior['workload']} "
                  f"({vs_prior['prior_is']}): prior "
                  f"{vs_prior['prior_model_flops_per_step']:.4g} FLOPs "
                  f"({vs_prior['prior_flops_source']}) at batch "
                  f"{vs_prior['prior_batch']} vs this cost model at those "
                  f"dims {vs_prior['costmodel_flops_per_step']:.4g} -> "
                  f"ratio {vs_prior['ratio']}"
                  + ("  ** FLOP accounting drifted **"
                     if vs_prior["drifted"] else ""))
    if findings:
        print(format_findings(findings))
    return 1 if has_errors(findings) else 0


def _newest_bench(bench_dir: str = None):
    """Newest committed BENCH_r*.json — same contract as
    bench._prior_bench, reimplemented here so the CLI works without the
    repo-root bench.py on sys.path. Returns (basename, result-with-
    workloads) or (None, None)."""
    import glob
    import json as _json
    import os
    import re

    if bench_dir is None:
        bench_dir = os.path.dirname(os.path.dirname(os.path.abspath(
            __file__)))

    def round_no(p):
        m = re.search(r"BENCH_r(\d+)\.json$", p)
        return int(m.group(1)) if m else -1

    for path in sorted(glob.glob(os.path.join(bench_dir, "BENCH_r*.json")),
                       key=round_no, reverse=True):
        try:
            with open(path) as f:
                doc = _json.load(f)
        except (OSError, _json.JSONDecodeError):
            continue
        if not isinstance(doc, dict):
            continue
        if "workloads" in doc:
            return os.path.basename(path), doc
        for line in reversed(str(doc.get("tail", "")).strip().splitlines()):
            line = line.strip()
            if line.startswith("{"):
                try:
                    result = _json.loads(line)
                except _json.JSONDecodeError:
                    continue
                if "workloads" in result:
                    return os.path.basename(path), result
    return None, None


def _perf_vs_prior(preset: str, device="cuda") -> dict:
    """FLOP-drift check vs the newest committed bench round: recompute
    the static model at the PRIOR round's workload dims (not the dims
    of the current invocation) and compare with the
    model_flops_per_step it recorded — a reported (never fatal)
    verdict, so a FLOP-accounting change shows up as accounting. The
    BENCH_r*.json rounds are the JAX package's records (TPU-era bench
    runs): only their FLOP count is compared, and no time of theirs is
    reported as the port's."""
    wl_name = {"resnet50": "resnet50", "charlstm": "char_lstm"}.get(preset)
    if wl_name is None:
        return None
    prior_name, prior = _newest_bench()
    if not prior:
        return None
    prior_is = (f"the JAX package's bench record (backend "
                f"{prior.get('backend') or '?'}): FLOP count only, no time")
    wl = (prior.get("workloads") or {}).get(wl_name) or {}
    pf, batch = wl.get("model_flops_per_step"), wl.get("batch")
    if not pf or not batch:
        return {"source": prior_name, "prior_is": prior_is,
                "note": f"prior {wl_name} has no model_flops_per_step"}
    from deeplearning4j_tpu_torch.analysis.costmodel import (
        _helpers_disabled,
        train_step_cost,
    )

    try:
        with _helpers_disabled():
            if preset == "resnet50":
                from deeplearning4j_tpu_torch.models.resnet import resnet50_network

                img = int(wl.get("image_size") or 224)
                # `classes` is recorded by the later BENCH rounds; older committed
                # rounds fall back to the config convention (10 classes
                # at small images, the 1000-way head at 224)
                classes = int(wl.get("classes")
                              or (1000 if img >= 224 else 10))
                net = resnet50_network(num_classes=classes,
                                       image_size=img, device=device)
                prior_cm = train_step_cost(net, batch_size=int(batch))
            else:
                from deeplearning4j_tpu_torch.models.charlstm import (
                    char_lstm_network,
                )

                # `vocab` is recorded by the later rounds; older rounds ran
                # the default 77-symbol charset
                net = char_lstm_network(
                    vocab_size=int(wl.get("vocab") or 77),
                    hidden=int(wl.get("hidden") or 200),
                    tbptt_length=int(wl.get("tbptt") or 50),
                    device=device)
                prior_cm = train_step_cost(
                    net, batch_size=int(batch),
                    timesteps=int(wl.get("seq_len") or 200))
    except Exception as e:
        return {"source": prior_name, "prior_is": prior_is,
                "note": f"recompute at prior dims failed: "
                        f"{type(e).__name__}: {e}"}
    cur = prior_cm.model_flops
    ratio = cur / pf
    return {
        "source": prior_name,
        "prior_is": prior_is,
        "workload": wl_name,
        "prior_batch": int(batch),
        "prior_model_flops_per_step": pf,
        "prior_flops_source": wl.get("flops_source", "analytic"),
        "costmodel_flops_per_step": cur,
        "ratio": round(ratio, 4),
        "drifted": abs(ratio - 1.0) > 0.01,
    }


def cmd_metrics(args) -> int:
    """Metrics snapshot -> stdout or a JSON file. With --url, scrape a
    running server (inference-server /metrics; any endpoint speaking the
    same routes); without it, dump THIS process's registry — useful from
    scripts that embed training/serving in-process (bench.py does the
    same thing per workload). --watch <secs> re-scrapes on that period
    and prints counter/histogram DELTAS plus gauge values, so health and
    stall series are observable live without a Prometheus stack."""
    import json as _json
    import urllib.request

    if getattr(args, "ledger", None):
        return _metrics_replay(args)
    if args.watch is not None:
        return _metrics_watch(args)
    if args.url:
        url = args.url.rstrip("/") + "/metrics"
        if args.format == "prometheus":
            url += "?format=prometheus"
        with urllib.request.urlopen(url, timeout=args.timeout) as r:
            text = r.read().decode()
    else:
        from deeplearning4j_tpu_torch.utils.metrics import get_registry

        reg = get_registry()
        text = (reg.to_prometheus() if args.format == "prometheus"
                else _json.dumps(reg.snapshot(), indent=2))
    if args.output:
        with open(args.output, "w") as f:
            f.write(text if text.endswith("\n") else text + "\n")
        print(f"wrote {args.output}")
    else:
        print(text)
    return 0


def _scrape_scalars(url, timeout: float) -> dict:
    """One flat {series: value} sample — from a server's JSON /metrics
    snapshot, or the local process registry when url is None."""
    from deeplearning4j_tpu_torch.utils.metrics import get_registry

    if url is None:
        return get_registry().scalar_values()
    import json as _json
    import urllib.request

    with urllib.request.urlopen(url.rstrip("/") + "/metrics?format=registry",
                                timeout=timeout) as r:
        snap = _json.loads(r.read().decode())
    out = {}
    for name, fam in snap.items():
        for v in fam.get("values", []):
            labels = v.get("labels") or {}
            lab = ("{" + ",".join(f'{k}="{labels[k]}"'
                                  for k in sorted(labels)) + "}"
                   if labels else "")
            if fam.get("type") == "histogram":
                out[f"{name}{lab}:count"] = float(v.get("count", 0))
                out[f"{name}{lab}:sum"] = float(v.get("sum", 0.0))
            elif v.get("value") is not None:
                out[f"{name}{lab}"] = float(v["value"])
    return out


def _print_metrics_tick(prev: dict, now: dict, header: str):
    """One watch/replay tick: counters and histogram counts as deltas,
    gauges as changed current values — the ONE delta rendering shared by
    the live watch loop and the ledger replay."""
    print(header)
    for key in sorted(now):
        if ":bucket:" in key:  # ledger samples carry buckets; the
            continue           # tick view stays the scalar one
        v = now[key]
        is_rate = key.endswith((":count", ":sum")) \
            or key.split("{")[0].endswith("_total")
        if is_rate:
            dv = v - prev.get(key, 0.0)
            if dv:
                print(f"  {key}  +{dv:g}  (total {v:g})")
        elif v != prev.get(key):
            print(f"  {key}  {v:g}")


def _metrics_watch(args) -> int:
    """Periodic re-scrape: counters and histogram counts print as deltas
    per tick, gauges as current values. Ctrl-C (or --watch-count) ends."""
    import time as _time

    period = max(0.05, float(args.watch))
    prev = _scrape_scalars(args.url, args.timeout)
    ticks = 0
    try:
        while args.watch_count <= 0 or ticks < args.watch_count:
            _time.sleep(period)
            now = _scrape_scalars(args.url, args.timeout)
            ticks += 1
            stamp = _time.strftime("%H:%M:%S")
            _print_metrics_tick(
                prev, now, f"-- {stamp} (every {period:g}s, tick {ticks}) --")
            prev = now
    except KeyboardInterrupt:
        pass
    return 0


def _metrics_replay(args) -> int:
    """`cli metrics --ledger <path>`: replay a recorded run ledger
    tick-by-tick with the live watch's delta rendering — post-mortems
    read the same view the operator would have watched, without the
    process being alive. `--watch-count` caps the ticks printed."""
    import os
    import time as _time

    from deeplearning4j_tpu_torch.utils import runledger

    if not os.path.exists(args.ledger):
        print(f"ledger not found: {args.ledger}", file=sys.stderr)
        return 2
    doc = runledger.read_ledger(args.ledger)
    man = doc["manifest"]
    print(f"replaying {args.ledger} — run {man.get('run_id')} "
          f"(sampled every {man.get('sample_every')}s)")
    alert_rows = list(runledger.iter_alerts(doc))
    prev: dict = {}
    ticks = 0
    t_prev = None
    for ts, now in runledger.iter_samples(doc):
        ticks += 1
        if args.watch_count > 0 and ticks > args.watch_count:
            print(f"... ({args.watch_count} of the recorded ticks shown; "
                  "raise --watch-count for more)")
            break
        stamp = _time.strftime("%H:%M:%S", _time.localtime(ts))
        dt = f" (+{ts - t_prev:.1f}s)" if t_prev is not None else ""
        _print_metrics_tick(prev, now, f"-- {stamp}{dt} tick {ticks} --")
        for a in alert_rows:
            if (t_prev or 0) < a["ts"] <= ts:
                print(f"  !! SLO {a['rule']} -> {a['to']} "
                      f"(value {a.get('value')})")
        prev, t_prev = now, ts
    return 0


def cmd_tenants(args) -> int:
    """Per-tenant chip-budget readout (utils/resourcemeter). Three
    sources, one rendering: no flags shows THIS process's spend+books,
    --url asks a running server's GET /tenants, --ledger rebuilds the
    spend table offline from a recorded run's final sample — all three
    parse the same flat scalar-values vocabulary through
    resourcemeter.spend_table(), so live and replay agree by
    construction."""
    import json as _json

    from deeplearning4j_tpu_torch.utils import resourcemeter

    if getattr(args, "ledger", None):
        import os

        from deeplearning4j_tpu_torch.utils import runledger

        if not os.path.exists(args.ledger):
            print(f"ledger not found: {args.ledger}", file=sys.stderr)
            return 2
        led = runledger.read_ledger(args.ledger)
        values: dict = {}
        for _ts, sample in runledger.iter_samples(led):
            values = sample  # the run's final recorded sample wins
        doc = {
            "tenants": resourcemeter.spend_table(values),
            # offline there are no live book-keepers: spend conservation
            # is judged for real, books vacuously
            "conservation": resourcemeter.conservation(values, books={}),
            "source": (f"ledger {args.ledger} "
                       f"(run {led['manifest'].get('run_id')})"),
        }
    elif args.url:
        import urllib.request

        with urllib.request.urlopen(args.url.rstrip("/") + "/tenants",
                                    timeout=args.timeout) as r:
            doc = _json.loads(r.read().decode())
        doc["source"] = args.url
    else:
        doc = resourcemeter.snapshot()
        doc["source"] = "in-process"
    if args.json:
        print(_json.dumps(doc, indent=2, default=str))
        return 0
    print(f"tenants — {doc.get('source', '')}")
    tenants = doc.get("tenants") or {}
    if not tenants:
        print("  (no tenant has been admitted or metered yet)")
    for t in sorted(tenants):
        rec = tenants[t] or {}
        parts = []
        dev = rec.get("device_seconds") or {}
        if dev:
            parts.append("dev[s] " + " ".join(
                f"{tier}={s:.4g}" for tier, s in sorted(dev.items())))
        wire = rec.get("wire_bytes") or {}
        if wire:
            parts.append("wire[B] " + " ".join(
                f"{tier}={int(b)}" for tier, b in sorted(wire.items())))
        if rec.get("tokens"):
            parts.append(f"tokens {int(rec['tokens'])}")
        if rec.get("examples"):
            parts.append(f"examples {int(rec['examples'])}")
        if rec.get("hbm_bytes"):
            parts.append(f"hbm[B] {int(rec['hbm_bytes'])}")
        books = rec.get("books")
        if books:
            ok = "" if books.get("conservation_ok", True) else " !LEAK"
            parts.append(
                f"books adm={books.get('admitted', 0)} "
                f"done={books.get('completed', 0)} "
                f"shed={books.get('shed', 0)} "
                f"fail={books.get('failed', 0)} "
                f"rej={books.get('rejected', 0)}{ok}")
        print(f"  {t:<16} " + ("  ".join(parts) if parts else "(idle)"))
    cons = doc.get("conservation") or {}
    if cons:
        print(f"  conservation: books_ok={cons.get('books_ok')} "
              f"spend_ok={cons.get('spend_ok')} ok={cons.get('ok')}")
    firing = doc.get("slo_firing")
    if firing:
        print(f"  !! per-tenant SLO firing: "
              f"{', '.join(str(r) for r in firing)}")
    if doc.get("note"):
        print(f"  note: {doc['note']}")
    return 0


def cmd_slo(args) -> int:
    """Offline SLO re-evaluation of a recorded run ledger
    (utils/runledger + analysis/slo): replay the sample stream through
    the rule-set — the one embedded in the ledger's manifest by
    default, or `--rules <json>` to re-judge the same run under
    different objectives — and report each rule's lifecycle. With
    `--check`, exit 1 when any ERROR-severity rule fired at any point:
    the CI/soak gate (`bench.py parallel_inference --overload` records
    exactly such a ledger)."""
    import json as _json
    import os

    from deeplearning4j_tpu_torch.analysis import slo
    from deeplearning4j_tpu_torch.utils import runledger

    if not os.path.exists(args.ledger):
        print(f"ledger not found: {args.ledger}", file=sys.stderr)
        return 2
    doc = runledger.read_ledger(args.ledger)
    if args.rules:
        with open(args.rules) as f:
            ruleset = slo.SLORuleSet.from_json(f.read())
    else:
        rule_dicts = doc["manifest"].get("rules") or []
        if not rule_dicts:
            print("ledger carries no rules (recorded without a rule "
                  "pack) — pass --rules <json>", file=sys.stderr)
            return 2
        ruleset = slo.SLORuleSet.from_dicts(rule_dicts)
    report = slo.evaluate_ledger(runledger.iter_samples(doc),
                                 ruleset.rules)
    report["ledger"] = args.ledger
    report["run_id"] = doc["manifest"].get("run_id")
    # recorded live transitions ride along so an offline/live divergence
    # (rules changed since the run) is visible, not silent
    report["recorded_alerts"] = list(runledger.iter_alerts(doc))
    if args.json == "-":
        print(_json.dumps(report, indent=2, default=str))
    elif args.json:
        with open(args.json, "w") as f:
            _json.dump(report, f, indent=2, default=str)
        print(f"wrote {args.json}")
    else:
        print(f"slo — run {report['run_id']} "
              f"({report['samples']} samples, "
              f"{len(ruleset.rules)} rules)")
        for r in report["rules"]:
            mark = {"firing": "!!", "pending": " ~"}.get(r["state"], "  ")
            fired = (f"  fired x{r['fired_total']}"
                     if r["fired_total"] else "")
            print(f"  {mark} {r['rule']:<28} {r['state']:<8} "
                  f"[{r['severity']}]{fired}  {r['detail']}")
        for t in report["transitions"]:
            print(f"    {t['ts']:.3f}  {t['rule']} -> {t['to']} "
                  f"(value {t['value']})")
        verdict = "ok" if report["ok"] else (
            f"ERROR rules fired: {', '.join(report['ever_fired_errors'])}")
        print(f"  verdict: {verdict}")
    if args.check:
        return 0 if report["ok"] else 1
    return 0


def cmd_runs(args) -> int:
    """Run-ledger operations: list the recorded runs in a directory, or
    `runs compare <reference> <candidate>` for per-metric regression
    deltas between two ledgers — the bench `vs_baseline` idea
    generalized from one-shot workloads to whole runs (counters compare
    by rate, gauges/latency means by mean; series moving more than
    --threshold are flagged with their metric family)."""
    import json as _json

    from deeplearning4j_tpu_torch.utils import runledger

    if args.paths and args.paths[0] == "compare":
        if len(args.paths) != 3:
            print("usage: runs compare <reference.jsonl> "
                  "<candidate.jsonl>", file=sys.stderr)
            return 2
        import os

        for p in args.paths[1:]:
            if not os.path.exists(p):
                print(f"ledger not found: {p}", file=sys.stderr)
                return 2
        ref = runledger.summarize_run(
            runledger.read_ledger(args.paths[1]))
        cand = runledger.summarize_run(
            runledger.read_ledger(args.paths[2]))
        report = runledger.compare_runs(ref, cand,
                                        threshold=args.threshold)
        if args.json == "-":
            print(_json.dumps(report, indent=2, default=str))
        elif args.json:
            with open(args.json, "w") as f:
                _json.dump(report, f, indent=2, default=str)
            print(f"wrote {args.json}")
        else:
            print(f"compare — reference {report['reference']['run_id']} "
                  f"vs candidate {report['candidate']['run_id']} "
                  f"(threshold {report['threshold']:.0%})")
            if not report["regressions"]:
                print("  no series moved past the threshold")
            for row in report["regressions"][:args.top]:
                r = row["ratio"]
                print(f"  {row['series']:<52} {row['basis']:>5} "
                      f"{row['reference']:>12.6g} -> "
                      f"{row['candidate']:>12.6g}  "
                      f"x{r if r is not None else float('nan'):.3f}")
            if report["regression_families"]:
                print("  families moved: "
                      + ", ".join(report["regression_families"]))
        return 0
    directory = args.dir or (args.paths[0] if args.paths else ".")
    entries = runledger.list_ledgers(directory)
    if args.json == "-":
        print(_json.dumps(entries, indent=2, default=str))
        return 0
    if not entries:
        print(f"no run ledgers in {directory!r}")
        return 0
    print(f"{len(entries)} run(s) in {directory}:")
    for e in entries:
        print(f"  {e['run_id']}  rules={e['rules']}  {e['path']}")
    return 0


def cmd_trace(args) -> int:
    """Distributed-trace readout (analysis/tracecrit): reconstruct span
    trees from a JSONL export — a file written by TracingListener /
    `cli chaos --trace-out`, or a live server's GET /trace — and report
    the top-k slowest traces with critical path and per-stage self-time
    breakdown. `--trace-id` resolves one specific trace (paste a
    histogram exemplar's trace_id from GET /metrics); exit 1 when it
    (or any trace at all) is missing from the export."""
    import json as _json
    import os

    from deeplearning4j_tpu_torch.analysis import tracecrit

    src = args.source
    if src.startswith(("http://", "https://")):
        import urllib.request

        url = src if "/trace" in src.split("://", 1)[1] \
            else src.rstrip("/") + "/trace"
        with urllib.request.urlopen(url, timeout=args.timeout) as r:
            text = r.read().decode()
    else:
        if not os.path.exists(src):
            print(f"trace export not found: {src}", file=sys.stderr)
            return 2
        with open(src) as f:
            text = f.read()
    events = tracecrit.parse_jsonl(text)
    report = tracecrit.analyze(events, top=args.top,
                               trace_id=args.trace_id)
    if args.json == "-":
        print(_json.dumps(report, indent=2))
    elif args.json:
        with open(args.json, "w") as f:
            _json.dump(report, f, indent=2)
        print(f"wrote {args.json}")
    else:
        print(tracecrit.format_report(report))
    if not report["traces"]:
        print("no matching trace in the export "
              "(tracing off, ring aged out, or wrong --trace-id?)",
              file=sys.stderr)
        return 1
    return 0


def cmd_blackbox(args) -> int:
    """Render a flight-recorder crash dump (utils/blackbox — written by
    install_crash_hooks on SIGTERM/fatal error, by the watchdog on a
    hang, or on demand): the final-steps timeline, events, component
    health, and every thread's stack at dump time."""
    import json as _json
    import os

    from deeplearning4j_tpu_torch.utils.blackbox import render_dump

    if not os.path.exists(args.dump):
        print(f"dump not found: {args.dump}", file=sys.stderr)
        return 2
    with open(args.dump) as f:
        doc = _json.load(f)
    if args.json:
        print(_json.dumps(doc, indent=2, default=str))
    else:
        print(render_dump(doc, max_steps=args.steps))
    return 0


def cmd_resume(args) -> int:
    """Operator half of the resume contract (train/checkpoint): describe
    the newest checkpoint in a directory — iteration/epoch/reason/age and
    the mid-epoch TrainState it carries — verify its per-entry SHA-256
    digest manifest, and prove the zip actually loads. Exit 0 when a
    loadable, integrity-clean checkpoint exists; 1 when the directory is
    empty, every checkpoint is torn/unreadable, or the newest one fails
    digest verification (the per-entry status is printed so the operator
    sees WHICH entry rotted): scriptable as a pre-flight gate before
    `fit(resume_from=...)` (or as the init container of a preemptible
    training pod). Pre-digest legacy checkpoints carry no manifest and
    pass with a note — nothing to verify against; `--no-validate` stays
    metadata-only (digest verification reads the payload, so it is
    skipped there too)."""
    import json as _json

    from deeplearning4j_tpu_torch.train.checkpoint import describe_latest
    from deeplearning4j_tpu_torch.utils.model_serializer import verify_checkpoint

    info = describe_latest(args.directory)
    if info is None:
        print(f"resume: no checkpoint in {args.directory!r} "
              "(empty directory = fresh start)", file=sys.stderr)
        return 1
    rc = 0
    integrity = None
    if not args.no_validate:
        # digest verification reads the payload, so it respects the
        # --no-validate "metadata only" contract
        integrity = verify_checkpoint(info["path"])
        info["integrity"] = integrity
        if not integrity["ok"]:
            rc = 1
    if not args.no_validate and integrity["ok"]:
        # the describe is metadata-level; this proves the full payload
        # (config, params, layer/updater state) deserializes
        from deeplearning4j_tpu_torch.utils.model_serializer import load_model

        try:
            model = load_model(info["path"], device=args.device)
        except Exception as e:
            print(f"resume: newest checkpoint {info['path']} does not "
                  f"load: {type(e).__name__}: {e}", file=sys.stderr)
            return 1
        info["network_type"] = type(model).__name__
        info["num_params"] = int(model.num_params())
    if args.json:
        print(_json.dumps(info, indent=2, default=str))
        return rc
    age = info.get("age_seconds")
    print(f"checkpoint: {info['path']}")
    print(f"  iteration: {info.get('iteration')}  "
          f"epoch: {info.get('epoch')}  reason: {info.get('reason')}")
    if age is not None:
        print(f"  age: {age:.1f}s")
    if integrity is None:
        pass  # --no-validate: metadata only, payload never opened
    elif integrity.get("legacy"):
        print("  integrity: no digest manifest (pre-digest checkpoint) "
              "— nothing to verify against")
    elif integrity.get("error"):
        print(f"  integrity: FAILED — {integrity['error']}")
    else:
        n_ok = sum(1 for e in integrity["entries"].values()
                   if e["status"] == "ok")
        verdict = ("ok" if integrity["ok"]
                   else "FAILED — restore would fall back to the "
                        "previous good checkpoint")
        print(f"  integrity: {verdict} ({n_ok}/"
              f"{len(integrity['entries'])} entries, sha256)")
        for name, e in sorted(integrity["entries"].items()):
            status = e["status"]
            extra = ""
            if status == "mismatch":
                extra = (f"  (expected {e.get('expected')}…, got "
                         f"{e.get('got')}…)")
            elif status == "unreadable":
                extra = f"  ({e.get('error')})"
            print(f"    {status:<10} {name}{extra}")
    if info.get("network_type"):
        print(f"  model: {info['network_type']} "
              f"({info.get('num_params')} params)  validated: loads OK")
    ts = info.get("train_state")
    if ts:
        print(f"  mid-epoch state: epoch {ts.get('epoch')}, "
              f"{ts.get('batch_in_epoch')} batch(es) into it"
              + (" (+ iterator state)" if ts.get("iterator_state")
                 else ""))
    else:
        print("  mid-epoch state: none (resume restarts its epoch)")
    return rc


def cmd_doctor(args) -> int:
    """Model doctor: static shape/dtype-flow check of a model's
    configuration plus an audit of its optimizer step traced once on
    fake tensors (analysis/shapeflow + analysis/graph_audit, the port of
    the JAX package's jaxpr audit, via net.doctor()). Exit 0 when no
    ERROR-severity finding; 1 otherwise — scriptable as a
    pre-training/pre-serving gate."""
    import json as _json

    from deeplearning4j_tpu_torch.analysis import (
        format_findings,
        has_errors,
        summarize,
    )

    if bool(args.model_path) == bool(args.preset):
        print("doctor: pass exactly one of --model-path or --preset",
              file=sys.stderr)
        return 2
    if args.model_path:
        net = guess_and_load_model(args.model_path, device=args.device)
    else:
        net = _preset_network(args)
    devices = getattr(args, "devices", None)
    if devices and devices > 1:
        # audit the SHARDED step signature: attach a data mesh over N
        # ranks (clamped to the process group: the port's mesh spans
        # torch.distributed ranks, one device a process) so the step
        # audit sees exactly what a multi-rank fit builds
        from deeplearning4j_tpu_torch.parallel.mesh import (
            data_parallel_mesh,
            n_devices,
        )

        world = n_devices()
        if world < devices:
            print(f"doctor: --devices {devices} clamped to the {world} "
                  f"rank(s) of this process's group (launch one process "
                  f"a device under torch.distributed for more)",
                  file=sys.stderr)
            devices = world
    if devices and devices > 1:
        net._require_init()
        net.set_mesh(data_parallel_mesh(list(range(devices))))
        print(f"doctor: auditing the sharded train step over "
              f"{net._mesh_plan.describe()}")
        # surface the chosen gradient-collective schedule next to the
        # donation audit: bucket count/sizes, wire dtype and bytes per
        # step, ring-time estimate — the knobs set_mesh(bucket_bytes=,
        # grad_dtype=) control
        try:
            coll = net._mesh_plan.collective_describe(net)
        except Exception as e:
            print(f"doctor: collective schedule unavailable "
                  f"({type(e).__name__}: {e})")
        else:
            sizes = coll.get("bucket_sizes_bytes")
            sched = ("monolithic (single tail-end all-reduce)"
                     if coll["mode"] == "monolithic" else
                     f"{coll['n_buckets']} bucket(s) "
                     f"{[f'{b / 2**20:.2f}MiB' for b in sizes]} "
                     f"(bucket_bytes={coll['bucket_bytes']}, "
                     f"{coll['bucketed_leaves']} leaves bucketed, "
                     f"{coll['unbucketed_leaves']} unbucketed)")
            print(f"doctor: gradient collective: {sched}; wire dtype "
                  f"{coll['grad_dtype']}, "
                  f"{coll['wire_bytes_per_step']} bytes/step, ring "
                  f"estimate {coll['ring_estimate_seconds']:.2e}s")
    findings = net.doctor(batch_size=args.batch, timesteps=args.timesteps,
                          audit=not args.no_jaxpr)
    if args.json == "-":
        print(_json.dumps(summarize(findings), indent=2))
    elif args.json:
        with open(args.json, "w") as f:
            _json.dump(summarize(findings), f, indent=2)
        print(f"wrote {args.json}")
    else:
        print(format_findings(findings))
        # concurrency section: the repo-wide lock-discipline audit —
        # lexical always, plus witnessed runtime edges when the
        # DL4J_LOCKCHECK sanitizer is armed in this process. Display
        # only: the gated form is `cli locks --smoke --baseline
        # deeplearning4j_tpu_torch/analysis/lock_baseline.txt`
        try:
            from deeplearning4j_tpu_torch.analysis import (
                concurrency_audit as _ca,
            )

            cdoc = _ca.report(runtime=True)
            mode = ("static+runtime" if cdoc["runtime"]
                    else "static only — arm with DL4J_LOCKCHECK=1")
            print(f"concurrency: {len(cdoc['edges'])} lock-order "
                  f"edge(s), {cdoc['summary']['errors']} error(s) / "
                  f"{cdoc['summary']['warnings']} warning(s) [{mode}]")
            if cdoc["findings"]:
                print(format_findings(cdoc["findings"]))
        except Exception as e:
            print(f"concurrency: audit unavailable "
                  f"({type(e).__name__}: {e})")
    return 1 if has_errors(findings) else 0


def _preset_network(args):
    """Built-in model configs for doctor runs without a serialized model,
    on the CLI's --device."""
    preset = args.preset
    precision = getattr(args, "precision", None) or "f32"
    if preset == "resnet50":
        from deeplearning4j_tpu_torch.models.resnet import resnet50_network

        return resnet50_network(num_classes=args.classes or 1000,
                                image_size=args.image_size or 224,
                                precision=precision, device=args.device)
    if preset == "tiny_resnet":
        from deeplearning4j_tpu_torch.models.resnet import tiny_resnet_conf
        from deeplearning4j_tpu_torch.nn.compgraph import ComputationGraph

        return ComputationGraph(tiny_resnet_conf(precision=precision),
                                device=args.device).init()
    if preset == "charlstm":
        from deeplearning4j_tpu_torch.models.charlstm import char_lstm_network

        return char_lstm_network(precision=precision, device=args.device)
    if preset == "recsys":
        from deeplearning4j_tpu_torch.models.recsys import recsys_network

        return recsys_network(host_resident=True, device=args.device)
    raise SystemExit(f"unknown --preset {preset!r} "
                     "(resnet50|tiny_resnet|charlstm|recsys)")


def _chaos_net(n_in: int = 8, device="cuda"):
    """Small dense net shared by the chaos presets: big enough to have a
    real forward/backward, small enough that a replay run is seconds."""
    from deeplearning4j_tpu_torch.nn.conf import (
        DenseLayer,
        NeuralNetConfiguration,
        OutputLayer,
        Updater,
    )
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork

    conf = (NeuralNetConfiguration.builder().seed(7).updater(Updater.SGD)
            .learning_rate(0.05).weight_init("xavier").list()
            .layer(DenseLayer(n_in=n_in, n_out=8, activation="tanh"))
            .layer(OutputLayer(n_in=8, n_out=3, activation="softmax",
                               loss="mcxent"))
            .build())
    return MultiLayerNetwork(conf, device=device).init()


def _chaos_budget(plan) -> float:
    """Join budget for a chaos run: generous base plus the longest hang
    the plan can inject — a run past this is WEDGED, the one verdict a
    chaos replay must never produce."""
    hangs = [r.hang_seconds for r in plan.rules if r.kind == "hang"]
    return 60.0 + (max(hangs) if hangs else 0.0)


def _chaos_unhealthy(wait: float = 10.0) -> list:
    """Components still not `ok` after the run — a hang release recovers
    them asynchronously, so give the watchdog a scan or two to flip them
    back before judging. The chaos process is fresh, so every registered
    component belongs to the run under test."""
    import time as _time

    from deeplearning4j_tpu_torch.utils import health as _health

    def _bad():
        comps = _health.get_health().status()["components"]
        return sorted(k for k, v in comps.items()
                      if v.get("status") != "ok")

    healthy_by = _time.monotonic() + wait
    unhealthy = _bad()
    while unhealthy and _time.monotonic() < healthy_by:
        _time.sleep(0.1)
        unhealthy = _bad()
    return unhealthy


def _chaos_serving(plan, requests: int, clients: int,
                   deadline_ms, device="cuda") -> dict:
    """Serving preset: concurrent closed-loop clients (two tenants)
    against one ParallelInference under the plan. Invariants checked:
    every client terminates inside the budget, the books balance
    (admitted == completed + shed + failed) PER TENANT as well as in
    aggregate, metered device-seconds sum to the process total, and the
    serving components end healthy."""
    import threading

    import numpy as np

    from deeplearning4j_tpu_torch.parallel.inference import (
        DeadlineExceeded,
        ParallelInference,
        RequestRejected,
    )
    from deeplearning4j_tpu_torch.utils import faultpoints as fp
    from deeplearning4j_tpu_torch.utils import resourcemeter

    resourcemeter.enable()  # spend conservation judged non-vacuously
    n_in = 8
    net = _chaos_net(n_in, device)
    pi = ParallelInference(net, max_batch_size=4, batch_timeout_ms=2.0,
                           queue_capacity=64, health_stall_after=20.0,
                           component_prefix="chaos_cli")
    counts = {"ok": 0, "fault": 0, "shed": 0, "error": 0}
    lock = threading.Lock()
    rng = np.random.default_rng(0)
    reqs = [rng.standard_normal((1 + i % 4, n_in)).astype(np.float32)
            for i in range(16)]
    per = max(1, requests // clients)

    def client(ci):
        for j in range(per):
            try:
                pi.output(reqs[(ci * 7 + j) % len(reqs)],
                          deadline_ms=deadline_ms,
                          tenant="a" if ci % 2 else "b")
                k = "ok"
            except fp.FaultInjected:
                k = "fault"
            except (DeadlineExceeded, RequestRejected):
                k = "shed"
            except Exception:
                k = "error"
            with lock:
                counts[k] += 1

    wedged = []
    try:
        pi.warmup((n_in,))
        # under --trace-out, tracing was enabled before warmup: drop the
        # per-bucket compile forwards from the ring, or they dominate the
        # export's slowest-traces report as standalone warmup noise
        from deeplearning4j_tpu_torch.utils import tracing as _tracing

        if _tracing.is_enabled():
            _tracing.get_tracer().clear()
        with fp.active(plan):
            threads = [threading.Thread(target=client, args=(i,),
                                        daemon=True,
                                        name=f"dl4j-chaos-cli-{i}")
                       for i in range(clients)]
            for t in threads:
                t.start()
            budget = _chaos_budget(plan)
            for t in threads:
                t.join(timeout=budget)
                if t.is_alive():
                    wedged.append(t.name)
        m = pi.metrics()
        unhealthy = _chaos_unhealthy()
        from deeplearning4j_tpu_torch.utils.metrics import get_registry

        spend_cons = resourcemeter.conservation(
            get_registry().scalar_values())
    finally:
        pi.shutdown()
    # the per-tenant law, non-vacuously: every tenant the workload
    # assigned must actually appear in the books ("a" and "b" alternate
    # by client index — a single-client run only ever offers one)
    offered = {"a" if ci % 2 else "b" for ci in range(clients)}
    tenant_books_ok = (
        offered <= set(m["tenants"])
        and all(b["conservation_ok"] for b in m["tenants"].values()))
    return {
        "workload": {"requests": per * clients, "clients": clients,
                     "deadline_ms": deadline_ms, "outcomes": counts},
        "metrics": {k: m[k] for k in ("admitted", "completed", "shed",
                                      "failed", "rejected")},
        "shed_by": m["shed_by"],
        "tenants": m["tenants"],
        "tenant_conservation": spend_cons,
        "conservation_ok":
            m["admitted"] == m["completed"] + m["shed"] + m["failed"]
            and tenant_books_ok and spend_cons["ok"],
        "wedged_threads": wedged,
        "unhealthy_components": unhealthy,
        "outcome": "wedged" if wedged else "recovered",
    }


def _chaos_training(plan, steps: int, device="cuda") -> dict:
    """Training preset: one epoch over a multi-worker ETL iterator with
    async checkpointing, under the plan — `etl_worker`, `device_put`,
    `ckpt_write` (and `helper_fn` where helpers are registered) all sit
    on this path. A fit that raises is a CLEAN failure; only a fit that
    outlives the budget is a wedge."""
    import tempfile
    import threading

    import numpy as np

    from deeplearning4j_tpu_torch.data.dataset import DataSet
    from deeplearning4j_tpu_torch.data.prefetch import ParallelDataSetIterator
    from deeplearning4j_tpu_torch.train.checkpoint import CheckpointListener
    from deeplearning4j_tpu_torch.utils import faultpoints as fp

    n_in = 8
    net = _chaos_net(n_in, device)
    rng = np.random.default_rng(0)
    base = [DataSet(rng.standard_normal((8, n_in)).astype(np.float32),
                    np.eye(3, dtype=np.float32)[rng.integers(0, 3, 8)])
            for _ in range(steps)]
    ckdir = tempfile.mkdtemp(prefix="dl4j-chaos-ckpt-")
    listener = CheckpointListener(
        ckdir, every_n_iterations=max(2, steps // 4),
        every_n_epochs=None, keep_last=2, async_save=True)
    net.set_listeners(listener)
    result = {}

    def run():
        try:
            net.fit(ParallelDataSetIterator(base, workers=2,
                                            stage="chaos_cli_etl"),
                    epochs=1, async_prefetch=True)
            result["outcome"] = "recovered"
        except fp.FaultInjected as e:
            result["outcome"] = "cleanly_failed"
            result["failure"] = f"FaultInjected: {e}"
        except Exception as e:
            result["outcome"] = "cleanly_failed"
            result["failure"] = f"{type(e).__name__}: {e}"

    with fp.active(plan):
        t = threading.Thread(target=run, daemon=True,
                             name="dl4j-chaos-cli-fit")
        t.start()
        t.join(timeout=_chaos_budget(plan))
        wedged = t.is_alive()
    listener.close()
    if wedged:
        result["outcome"] = "wedged"
    from deeplearning4j_tpu_torch.utils.metrics import get_registry

    scalars = get_registry().scalar_values()
    return {
        "workload": {"steps": steps, "checkpoint_dir": ckdir},
        "checkpoint_write_failures": scalars.get(
            "checkpoint_save_failures_total", 0.0),
        "conservation_ok": True,  # no serving books in this preset
        "wedged_threads": (["dl4j-chaos-cli-fit"] if wedged else []),
        "unhealthy_components": _chaos_unhealthy(),
        **result,
    }


def _chaos_decode(plan, requests: int, clients: int,
                  deadline_ms, device="cuda") -> dict:
    """Decode preset: closed-loop generate() clients against one
    continuous-batching DecodeEngine under the plan (latency + a hang on
    the `decode_step` point). Invariants checked: every client
    terminates inside the budget, the per-tenant books conserve, the
    watchdog actually TRIPPED on the injected hang (a vacuously-green
    run fails), the engine ends healthy again, and carried deadlines
    were shed — not served late — while the step was wedged."""
    import threading

    import numpy as np

    from deeplearning4j_tpu_torch.models.charlstm import char_lstm_network
    from deeplearning4j_tpu_torch.parallel.inference import (
        DeadlineExceeded,
        RequestRejected,
    )
    from deeplearning4j_tpu_torch.serving.decode import DecodeEngine
    from deeplearning4j_tpu_torch.utils import faultpoints as fp
    from deeplearning4j_tpu_torch.utils import health as _health
    from deeplearning4j_tpu_torch.utils import resourcemeter

    resourcemeter.enable()  # spend conservation judged non-vacuously
    vocab = 11
    net = char_lstm_network(vocab_size=vocab, hidden=16, layers=1,
                            tbptt_length=8, device=device)
    eng = DecodeEngine(net, n_slots=4,
                       tenant_weights={"a": 2.0, "b": 1.0},
                       default_max_tokens=6, queue_capacity=64,
                       health_stall_after=0.6,
                       component_prefix="chaos_decode")
    counts = {"ok": 0, "shed": 0, "error": 0}
    lock = threading.Lock()
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, vocab, size=1 + i % 4).tolist()
               for i in range(16)]
    per = max(1, requests // clients)
    health_seq0 = _health.get_health().last_seq()

    def client(ci):
        for j in range(per):
            try:
                eng.generate_sync(prompts[(ci * 7 + j) % len(prompts)],
                                  max_new_tokens=3 + j % 4,
                                  tenant="a" if ci % 2 else "b",
                                  deadline_ms=deadline_ms)
                k = "ok"
            except (DeadlineExceeded, RequestRejected):
                k = "shed"
            except Exception:
                k = "error"
            with lock:
                counts[k] += 1

    wedged = []
    try:
        # warmup outside the plan: the compile must not eat a hang
        eng.generate([1, 2], max_new_tokens=2, tenant="a").result(60)
        with fp.active(plan):
            threads = [threading.Thread(target=client, args=(i,),
                                        daemon=True,
                                        name=f"dl4j-chaos-dec-{i}")
                       for i in range(clients)]
            for t in threads:
                t.start()
            budget = _chaos_budget(plan)
            for t in threads:
                t.join(timeout=budget)
                if t.is_alive():
                    wedged.append(t.name)
        m = eng.metrics()
        unhealthy = _chaos_unhealthy()
        from deeplearning4j_tpu_torch.utils.metrics import get_registry

        spend_cons = resourcemeter.conservation(
            get_registry().scalar_values())
        tripped = [
            tr for tr in _health.get_health().transitions_since(health_seq0)
            if str(tr.get("component", "")).startswith("chaos_decode")
            and tr.get("to") != "ok"]
    finally:
        eng.shutdown()
    return {
        "workload": {"requests": per * clients, "clients": clients,
                     "deadline_ms": deadline_ms, "outcomes": counts},
        "metrics": {k: m[k] for k in ("admitted", "completed", "shed",
                                      "failed", "rejected")},
        "shed_by": m["shed_by"],
        "tenants": m["tenants"],
        "tenant_conservation": spend_cons,
        "conservation_ok": (m["conservation_ok"]
                            and {"a", "b"} <= set(m["tenants"])
                            and spend_cons["ok"]),
        "watchdog_tripped": bool(tripped),
        "sheds_during_wedge": m["shed"],
        # the gate must not be vacuous: the injected hang must have
        # degraded the engine AND expired carries must have shed
        "loop_exercised": bool(tripped) and m["shed"] >= 1,
        "wedged_threads": wedged,
        "unhealthy_components": unhealthy,
        "outcome": "wedged" if wedged else "recovered",
    }


def _chaos_default_plan(preset: str, seed: int, steps: int = 24):
    from deeplearning4j_tpu_torch.utils import faultpoints as fp

    if preset == "decode":
        # steady latency jitter plus ONE hang long enough to trip the
        # engine's watchdog (stall 0.6s) and outlive every carried
        # deadline — proving degrade -> shed -> recover end to end
        return (fp.FaultPlan(seed=seed)
                .add("decode_step", "latency", p=0.1, latency_ms=15.0)
                .add("decode_step", "hang", every_nth=25, max_fires=1,
                     hang_seconds=2.5))
    if preset == "serving":
        # replica_forward only: the preset drives ParallelInference
        # in-process, so an http_handler rule would never fire — exactly
        # the vacuously-green rule faultpoints.py warns about
        return (fp.FaultPlan(seed=seed)
                .add("replica_forward", "error", p=0.08)
                .add("replica_forward", "latency", p=0.2,
                     latency_ms=10.0))
    if preset == "divergence":
        # seeded NaN at step k (mid-run, past the first checkpoint) —
        # the deterministic rehearsal of detect -> quarantine ->
        # rollback -> recover; the sentinel must bring the fit home
        # with a finite final loss or the run exits 1
        k = max(2, steps // 2)
        return (fp.FaultPlan(seed=seed)
                .add("train_step", "nan", between=(k, k)))
    return (fp.FaultPlan(seed=seed)
            .add("etl_worker", "latency", p=0.2, latency_ms=10.0)
            .add("ckpt_write", "error", every_nth=2, max_fires=1)
            .add("device_put", "latency", p=0.1, latency_ms=5.0))


def _chaos_divergence(plan, steps: int, device="cuda") -> dict:
    """Divergence preset: a deterministic fit with checkpointing and
    the divergence sentinel armed, under a seeded NaN-at-step-k plan
    (the `nan` fault kind taints the batch through the REAL dispatch).
    The resilience loop under test: the sentinel must catch the
    non-finite loss, quarantine the batch, roll back to the last-good
    checkpoint, replay past it, and finish with a FINITE final loss —
    anything else (a raise, a wedge, a NaN final score) is a violated
    verdict."""
    import tempfile
    import threading

    import numpy as np

    from deeplearning4j_tpu_torch.data.dataset import DataSet
    from deeplearning4j_tpu_torch.data.iterators import ListDataSetIterator
    from deeplearning4j_tpu_torch.train.checkpoint import CheckpointListener
    from deeplearning4j_tpu_torch.train.sentinel import (
        DivergenceSentinel,
        TrainingDivergedError,
    )
    from deeplearning4j_tpu_torch.utils import faultpoints as fp

    n_in = 8
    net = _chaos_net(n_in, device)
    rng = np.random.default_rng(0)
    full = DataSet(
        rng.standard_normal((8 * steps, n_in)).astype(np.float32),
        np.eye(3, dtype=np.float32)[rng.integers(0, 3, 8 * steps)])
    ckdir = tempfile.mkdtemp(prefix="dl4j-chaos-ckpt-")
    listener = CheckpointListener(
        ckdir, every_n_iterations=max(2, steps // 6),
        every_n_epochs=None, keep_last=4, async_save=False)
    sentinel = DivergenceSentinel(rollback_after=1, max_rollbacks=2)
    net.set_listeners(listener)
    net.set_sentinel(sentinel)
    result = {}

    def run():
        try:
            net.fit(ListDataSetIterator(full, 8), epochs=1,
                    async_prefetch=False)
            final = float(net._score)
            result["final_score"] = final
            result["final_score_finite"] = bool(np.isfinite(final))
            result["outcome"] = ("recovered" if result["final_score_finite"]
                                 else "diverged")
        except TrainingDivergedError as e:
            result["outcome"] = "diverged"
            result["failure"] = f"TrainingDivergedError: {e}"
            result["dump_path"] = e.dump_path
        except Exception as e:
            result["outcome"] = "diverged"
            result["failure"] = f"{type(e).__name__}: {e}"

    with fp.active(plan):
        t = threading.Thread(target=run, daemon=True,
                             name="dl4j-chaos-cli-fit")
        t.start()
        t.join(timeout=_chaos_budget(plan))
        wedged = t.is_alive()
    if wedged:
        result["outcome"] = "wedged"
    return {
        "workload": {"steps": steps, "checkpoint_dir": ckdir},
        "sentinel": {
            "anomalies": sentinel.anomalies,
            "quarantined": sentinel.quarantined,
            "rollbacks": sentinel.rollbacks,
            "quarantine_records": list(sentinel.records),
            "findings": [f.to_dict() for f in sentinel.findings],
        },
        "conservation_ok": True,  # no serving books in this preset
        "final_score_finite": result.get("final_score_finite", False),
        # the gate must not be vacuous: a finite final loss only counts
        # when the injected divergence actually reached the sentinel —
        # a broken injection chain must fail the rehearsal, not pass it
        "loop_exercised": (sentinel.anomalies >= 1
                           and sentinel.quarantined >= 1),
        "wedged_threads": (["dl4j-chaos-cli-fit"] if wedged else []),
        "unhealthy_components": _chaos_unhealthy(),
        **result,
    }


def _chaos_trace_report(preset: str, path: str) -> dict:
    """Write the run's span export and — for the serving preset — check
    the fault-to-trace linkage: every injected fault's marker must sit
    in a trace that also carries serve/* lifecycle spans, i.e. a chaos
    fault is attributable to the concrete request it hit."""
    from deeplearning4j_tpu_torch.analysis import tracecrit
    from deeplearning4j_tpu_torch.utils import tracing as _tracing

    tracer = _tracing.get_tracer()
    events = tracer.recent()
    tracer.write_jsonl(path)
    traces = tracecrit.group_traces(events)
    faults = [e for e in events if e.get("name") == "fault/injected"]
    linked = sum(
        1 for ev in faults
        if any(e.get("name", "").startswith("serve/")
               for e in traces.get(ev.get("trace"), [])))
    out = {"path": path, "fault_spans": len(faults)}
    if preset == "serving":
        out["fault_spans_linked"] = linked
        out["fault_trace_ok"] = linked == len(faults)
    return out


def cmd_chaos(args) -> int:
    """Replay a seeded FaultPlan outside pytest (utils/faultpoints): run
    the serving or training preset workload under the plan and report
    the canonical event log plus the invariant verdict. Exit 0 when the
    run ends recovered or cleanly failed with the serving books
    balanced; 1 when an invariant broke (a wedge, a conservation
    violation, a component left unhealthy, or — with --trace-out on the
    serving preset — an injected fault whose trace lacks the request's
    lifecycle spans). Two runs of the same plan + preset produce the
    same event log — diff the --json artifacts to prove a replay."""
    import json as _json

    from deeplearning4j_tpu_torch.utils import faultpoints as fp
    from deeplearning4j_tpu_torch.utils import tracing as _tracing

    if args.plan:
        with open(args.plan) as f:
            plan = fp.FaultPlan.from_json(f.read())
        if args.seed is not None:
            plan.seed = int(args.seed)
    else:
        plan = _chaos_default_plan(args.preset, args.seed or 0,
                                   steps=args.steps)
    # the serving/decode rehearsals double as lock-sanitizer coverage:
    # arm DL4J_LOCKCHECK for the run so the fault-riddled schedules
    # (hangs, sheds, swap races) also witness lock-acquisition orders.
    # Disarmed again afterwards — chaos runs in-process under pytest
    # too, and the patches must not outlive the rehearsal there
    lock_audit = None
    lock_armed_here = False
    if args.preset in ("serving", "decode"):
        from deeplearning4j_tpu_torch.utils import locktrace as _locktrace

        if not _locktrace.enabled():
            _locktrace.install()
            lock_armed_here = True
    trace_out = args.trace_out
    if trace_out:
        prev_tracing = _tracing.is_enabled()
        _tracing.get_tracer().clear()
        _tracing.enable(True)
    try:
        if args.preset == "serving":
            report = _chaos_serving(plan, args.requests, args.clients,
                                    args.deadline_ms, device=args.device)
        elif args.preset == "decode":
            report = _chaos_decode(plan, args.requests, args.clients,
                                   args.deadline_ms, device=args.device)
        elif args.preset == "divergence":
            report = _chaos_divergence(plan, args.steps, device=args.device)
        else:
            report = _chaos_training(plan, args.steps, device=args.device)
    finally:
        if trace_out:
            _tracing.enable(prev_tracing)
        if args.preset in ("serving", "decode"):
            # harvest the witnessed graph BEFORE disarming (and disarm
            # even when the preset raised)
            from deeplearning4j_tpu_torch.analysis import (
                concurrency_audit as _ca,
            )

            try:
                cdoc = _ca.report(runtime=True)
                lock_audit = {
                    "edges": len(cdoc["edges"]),
                    "errors": cdoc["summary"]["errors"],
                    "warnings": cdoc["summary"]["warnings"],
                    "findings": [f.name for f in cdoc["findings"]],
                }
            finally:
                if lock_armed_here:
                    _locktrace.uninstall()
    report = {
        "preset": args.preset,
        "plan": _json.loads(plan.to_json()),
        "events": plan.event_log(),
        "invocations": plan.invocations(),
        **report,
    }
    if trace_out:
        report["trace"] = _chaos_trace_report(args.preset, trace_out)
    if lock_audit is not None:
        report["lock_audit"] = lock_audit
    ok = (report["outcome"] in ("recovered", "cleanly_failed")
          and report["conservation_ok"]
          and not report["unhealthy_components"]
          and report.get("loop_exercised", True)
          and report.get("trace", {}).get("fault_trace_ok", True)
          and (lock_audit is None or lock_audit["errors"] == 0))
    report["verdict"] = "ok" if ok else "violated"
    if args.json == "-":
        print(_json.dumps(report, indent=2, default=str))
    elif args.json:
        with open(args.json, "w") as f:
            _json.dump(report, f, indent=2, default=str)
        print(f"wrote {args.json}")
    else:
        print(f"chaos[{args.preset}] seed={plan.seed} "
              f"rules={len(plan.rules)}")
        print(f"  injected: {len(report['events'])} fault(s) over "
              f"{sum(report['invocations'].values())} point "
              f"invocation(s)")
        for e in report["events"][:20]:
            print(f"    {e['point']}#{e['invocation']} {e['kind']} "
                  f"(rule {e['rule']})")
        if len(report["events"]) > 20:
            print(f"    ... {len(report['events']) - 20} more")
        if "metrics" in report:
            print(f"  books: {report['metrics']} "
                  f"(conserved: {report['conservation_ok']})")
        if "sentinel" in report:
            s = report["sentinel"]
            print(f"  sentinel: {s['anomalies']} anomaly(ies), "
                  f"{s['quarantined']} quarantined, "
                  f"{s['rollbacks']} rollback(s)"
                  + (f", final loss {report.get('final_score'):.6g} "
                     f"(finite: {report['final_score_finite']})"
                     if report.get("final_score") is not None else ""))
        if report.get("failure"):
            print(f"  failure: {report['failure']}")
        if lock_audit is not None:
            print(f"  lock audit: {lock_audit['edges']} order edge(s), "
                  f"{lock_audit['errors']} error(s) / "
                  f"{lock_audit['warnings']} warning(s) (sanitizer "
                  f"armed for the rehearsal)")
        if report.get("trace"):
            tr = report["trace"]
            print(f"  trace export: {tr['path']} "
                  f"({tr['fault_spans']} fault span(s)"
                  + (f", {tr.get('fault_spans_linked')} linked to request "
                     f"traces" if "fault_trace_ok" in tr else "")
                  + ")")
        print(f"  outcome: {report['outcome']}  "
              f"verdict: {report['verdict']}")
    return 0 if ok else 1


def cmd_lint(args) -> int:
    """Concurrency/robustness lint over source paths (analysis/lint.py,
    CC001-CC007). The tier-1 gate runs it over the port's package with
    the committed baseline
    (deeplearning4j_tpu_torch/analysis/lint_baseline.txt); here it is
    exposed directly for ad-hoc runs."""
    from deeplearning4j_tpu_torch.analysis.lint import main as lint_main

    argv = list(args.paths)
    if args.json:
        argv += ["--json", args.json]
    if args.baseline:
        argv += ["--baseline", args.baseline]
    return lint_main(argv)


def cmd_locks(args) -> int:
    """Merged lock-discipline audit (analysis/concurrency_audit,
    CN001-CN003): the lexical lock-order graph always; the runtime
    sanitizer's witnessed edges too when it is armed (DL4J_LOCKCHECK=1)
    or when --smoke runs the serving+decode+sparse exercise in-process
    (on --device). Tier-1 and chip_smoke.py run the --smoke --baseline
    form as the lock-audit gate."""
    from deeplearning4j_tpu_torch.analysis.concurrency_audit import main as ca_main

    argv = []
    if args.smoke:
        argv += ["--smoke", "--device", args.device]
    if args.json:
        argv += ["--json", args.json]
    if args.baseline:
        argv += ["--baseline", args.baseline]
    return ca_main(argv)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="deeplearning4j_tpu_torch")
    ap.add_argument("--device", default="cuda",
                    help="torch device the subcommand's models load and "
                         "run on (default cuda; without a GPU the CLI "
                         "raises unless given cpu)")
    sub = ap.add_subparsers(dest="cmd", required=True)

    t = sub.add_parser("train", help="train a serialized model from flags")
    t.add_argument("--model-path", required=True)
    t.add_argument("--data", required=True)
    t.add_argument("--epochs", type=int, default=1)
    t.add_argument("--batch-size", type=int, default=32)
    t.add_argument("--workers", type=int, default=1)
    t.add_argument("--data-parallel", action="store_true",
                   help="shard batches over all visible devices")
    t.add_argument("--output", default=None)
    t.add_argument("--print-every", type=int, default=10)
    t.add_argument("--num-examples", type=int, default=None,
                   help="cap the training set size (mnist/cifar10/lfw)")
    t.add_argument("--ui-port", type=int, default=None)
    t.add_argument("--ui-hold", action="store_true")
    t.set_defaults(fn=cmd_train)

    e = sub.add_parser("evaluate", help="evaluate a serialized model")
    e.add_argument("--model-path", required=True)
    e.add_argument("--data", required=True)
    e.add_argument("--batch-size", type=int, default=128)
    e.set_defaults(fn=cmd_evaluate)

    k = sub.add_parser("knn-server", help="REST k-NN server over a VPTree")
    k.add_argument("--ndarray-path", required=True)
    k.add_argument("--port", type=int, default=9000)
    k.add_argument("--similarity-function", default="euclidean")
    k.add_argument("--invert", action="store_true")
    k.set_defaults(fn=cmd_knn_server)

    i = sub.add_parser(
        "inference-server",
        help="REST model serving (bucketed+pipelined ParallelInference)")
    i.add_argument("--model-path", required=True)
    i.add_argument("--port", type=int, default=9100)
    i.add_argument("--max-batch-size", type=int, default=64)
    i.add_argument("--batch-timeout-ms", type=float, default=2.0)
    i.add_argument("--buckets", default=None,
                   help="comma-separated batch-size buckets")
    i.add_argument("--warmup-shape", default=None,
                   help="feature shape to precompile, e.g. 784 or 28,28,1")
    i.add_argument("--replicas", type=int, default=1,
                   help=">=2 serves through a self-healing ReplicaPool")
    i.add_argument("--devices", default=None,
                   help="comma-separated torch devices each request group "
                        "is split over (default: the model's device alone)")
    i.add_argument("--decode-slots", type=int, default=0,
                   help=">0 mounts the continuous-batching decode "
                        "engine (POST /generate) with this many slots")
    i.add_argument("--decode-eos", type=int, default=None,
                   help="EOS token id ending a generated sequence early")
    i.add_argument("--decode-max-tokens", type=int, default=64,
                   help="default max_tokens for /generate requests")
    i.set_defaults(fn=cmd_inference_server)

    u = sub.add_parser("ui-server", help="dashboard over a stats file")
    u.add_argument("--stats-file", required=True)
    u.add_argument("--port", type=int, default=9090)
    u.set_defaults(fn=cmd_ui_server)

    r = sub.add_parser(
        "report", help="standalone self-contained HTML training report")
    r.add_argument("--stats-file", required=True)
    r.add_argument("--output", required=True)
    r.add_argument("--session", default=None,
                   help="session id (default: newest)")
    r.add_argument("--title", default="training report")
    r.set_defaults(fn=cmd_report)

    p = sub.add_parser(
        "profile",
        help="op-family device-time breakdown from a utils.profiler "
             "capture (torch.profiler, summarised by kernel)")
    p.add_argument("--log-dir", required=True,
                   help="directory utils.profiler.trace (or a "
                        "ProfilerListener) captured into")
    p.add_argument("--json", default=None,
                   help="write the aggregation to this path as JSON")
    p.add_argument("--top", type=int, default=40)
    p.add_argument("--preset", default=None,
                   help="attach the static cost model of this preset's "
                        "train step (resnet50|tiny_resnet|charlstm): "
                        "per-family flops/bytes columns + roofline "
                        "context next to the measured times")
    p.add_argument("--batch", type=int, default=8,
                   help="cost-model batch size (--preset)")
    p.add_argument("--steps", type=int, default=1,
                   help="train steps the capture holds: the cost-model "
                        "columns and bounds are for this many (--preset)")
    p.add_argument("--timesteps", type=int, default=16,
                   help="cost-model sequence length for recurrent "
                        "presets (--preset)")
    p.add_argument("--image-size", type=int, default=None)
    p.add_argument("--classes", type=int, default=None)
    p.add_argument("--precision", default="f32", choices=("f32", "bf16"),
                   help="the preset's precision: model the step the "
                        "capture ran (--preset)")
    p.set_defaults(fn=cmd_profile)

    pf = sub.add_parser(
        "perf",
        help="static device cost model of a preset train step: "
             "per-family FLOPs/bytes, roofline verdicts, activation-peak "
             "estimate, FlopCounterMode cross-check (analysis/costmodel; "
             "exit 1 on JX007/JX008)")
    pf.add_argument("--preset", required=True,
                    choices=("resnet50", "tiny_resnet", "charlstm"))
    pf.add_argument("--batch", type=int, default=8,
                    help="abstract batch size to model the step at")
    pf.add_argument("--timesteps", type=int, default=16,
                    help="abstract sequence length for recurrent presets")
    pf.add_argument("--image-size", type=int, default=None,
                    help="override preset image size (resnet50)")
    pf.add_argument("--classes", type=int, default=None,
                    help="override preset class count (resnet50)")
    pf.add_argument("--precision", default="f32", choices=("f32", "bf16"),
                    help="the preset's precision (the bytes and bounds "
                         "follow it; the FLOPs do not)")
    pf.add_argument("--tolerance", type=float, default=0.10,
                    help="JX007 cross-check tolerance vs FlopCounterMode")
    pf.add_argument("--xla", action="store_true",
                    help="cross-check the model's FLOPs against torch's "
                         "FlopCounterMode over the same trace (the JAX "
                         "package's flag name: there, XLA cost_analysis)")
    pf.add_argument("--no-vs-prior", action="store_true",
                    help="skip the FLOP-drift check against the newest "
                         "committed BENCH_r*.json")
    pf.add_argument("--top", type=int, default=20,
                    help="family-table rows to print")
    pf.add_argument("--json", default=None, metavar="PATH",
                    help="machine-readable report ('-' = stdout)")
    pf.set_defaults(fn=cmd_perf)

    m = sub.add_parser(
        "metrics",
        help="metrics snapshot: scrape a server's /metrics or dump this "
             "process's registry (utils/metrics.py)")
    m.add_argument("--url", default=None,
                   help="base URL of a running server, e.g. "
                        "http://127.0.0.1:9100 (omit to dump the local "
                        "process registry)")
    m.add_argument("--format", choices=("json", "prometheus"),
                   default="json")
    m.add_argument("--output", default=None,
                   help="write to this file instead of stdout")
    m.add_argument("--timeout", type=float, default=10.0)
    m.add_argument("--watch", type=float, default=None, metavar="SECS",
                   help="re-scrape every SECS seconds, printing counter "
                        "deltas and gauge values (ctrl-C to stop)")
    m.add_argument("--watch-count", type=int, default=0,
                   help="stop after N watch ticks (0 = until ctrl-C)")
    m.add_argument("--ledger", default=None, metavar="PATH",
                   help="replay a recorded run ledger tick-by-tick with "
                        "the --watch delta rendering (post-mortems "
                        "without the process alive); --watch-count caps "
                        "the ticks")
    m.set_defaults(fn=cmd_metrics)

    tn = sub.add_parser(
        "tenants",
        help="per-tenant chip-budget readout: device-seconds by tier, "
             "wire/HBM bytes, tokens, admission books, conservation "
             "(utils/resourcemeter) — in-process, from a server's "
             "GET /tenants, or replayed from a run ledger")
    tn.add_argument("--url", default=None,
                    help="base URL of a running inference server (its "
                         "GET /tenants is appended; omit for the local "
                         "process view)")
    tn.add_argument("--ledger", default=None, metavar="PATH",
                    help="rebuild the spend table from a recorded run "
                         "ledger's final sample instead of a live "
                         "process (same parse as the live view)")
    tn.add_argument("--timeout", type=float, default=10.0)
    tn.add_argument("--json", action="store_true",
                    help="print the raw document instead of rendering")
    tn.set_defaults(fn=cmd_tenants)

    sl = sub.add_parser(
        "slo",
        help="offline SLO re-evaluation of a recorded run ledger "
             "(analysis/slo); --check exits 1 when ERROR rules fired — "
             "the CI/soak gate")
    sl.add_argument("--ledger", required=True, metavar="PATH",
                    help="run-ledger JSONL artifact (utils/runledger)")
    sl.add_argument("--rules", default=None, metavar="JSON",
                    help="rule-set JSON (list of SLORule dicts, or "
                         "{'rules': [...]}); default: the pack embedded "
                         "in the ledger's manifest")
    sl.add_argument("--check", action="store_true",
                    help="exit 1 when any ERROR-severity rule fired at "
                         "any point during the run")
    sl.add_argument("--json", default=None, metavar="PATH",
                    help="machine-readable report ('-' = stdout)")
    sl.set_defaults(fn=cmd_slo)

    rn = sub.add_parser(
        "runs",
        help="list recorded run ledgers, or `runs compare A B` for "
             "per-metric regression deltas between two runs")
    rn.add_argument("paths", nargs="*",
                    help="a directory to list, or: compare "
                         "<reference.jsonl> <candidate.jsonl>")
    rn.add_argument("--dir", default=None,
                    help="directory to list ledgers from (default: .)")
    rn.add_argument("--threshold", type=float, default=0.25,
                    help="flag series whose rate/mean ratio moves more "
                         "than this fraction (compare)")
    rn.add_argument("--top", type=int, default=20,
                    help="flagged rows to print (compare)")
    rn.add_argument("--json", default=None, metavar="PATH",
                    help="machine-readable report ('-' = stdout)")
    rn.set_defaults(fn=cmd_runs)

    tr = sub.add_parser(
        "trace",
        help="distributed-trace readout: span trees, critical path and "
             "per-stage breakdown from a JSONL export or a live server's "
             "GET /trace (analysis/tracecrit)")
    tr.add_argument("source",
                    help="JSONL span export file, or a server base URL "
                         "(e.g. http://127.0.0.1:9100 — /trace is "
                         "appended)")
    tr.add_argument("--top", type=int, default=5,
                    help="how many of the slowest traces to report")
    tr.add_argument("--trace-id", default=None,
                    help="resolve one specific trace (accepts a unique "
                         "prefix) — paste a histogram exemplar's "
                         "trace_id from GET /metrics")
    tr.add_argument("--timeout", type=float, default=10.0)
    tr.add_argument("--json", default=None, metavar="PATH",
                    help="machine-readable report ('-' = stdout)")
    tr.set_defaults(fn=cmd_trace)

    bb = sub.add_parser(
        "blackbox",
        help="render a flight-recorder crash dump (final-steps timeline, "
             "events, component health, thread stacks)")
    bb.add_argument("dump", help="path to a blackbox JSON dump "
                                 "(utils/blackbox.install_crash_hooks)")
    bb.add_argument("--steps", type=int, default=32,
                    help="how many of the final steps to render")
    bb.add_argument("--json", action="store_true",
                    help="pretty-print the raw dump instead of rendering")
    bb.set_defaults(fn=cmd_blackbox)

    rs = sub.add_parser(
        "resume",
        help="describe + validate the newest checkpoint in a directory "
             "(exit 1 when empty/torn) — pre-flight for "
             "fit(resume_from=...)")
    rs.add_argument("directory", help="checkpoint directory "
                                      "(train.checkpoint.CheckpointListener)")
    rs.add_argument("--json", action="store_true",
                    help="machine-readable output")
    rs.add_argument("--no-validate", action="store_true",
                    help="skip the digest verification and full model "
                         "load (metadata only)")
    rs.set_defaults(fn=cmd_resume)

    d = sub.add_parser(
        "doctor",
        help="static model analysis: config shape/dtype flow + step "
             "train-step audit (exit 1 on ERROR findings)")
    d.add_argument("--model-path", default=None,
                   help="serialized model (this framework's zip, DL4J zip, "
                        "or Keras .h5)")
    d.add_argument("--preset", default=None,
                   help="built-in config instead of a file: "
                        "resnet50|tiny_resnet|charlstm")
    d.add_argument("--image-size", type=int, default=None,
                   help="override preset image size (resnet50)")
    d.add_argument("--classes", type=int, default=None,
                   help="override preset class count (resnet50)")
    d.add_argument("--batch", type=int, default=2,
                   help="abstract batch size for the step audit")
    d.add_argument("--timesteps", type=int, default=8,
                   help="abstract sequence length for recurrent models")
    d.add_argument("--devices", type=int, default=None, metavar="N",
                   help="audit the sharded multi-chip step: attach a "
                        "data mesh over N devices (clamped to the "
                        "process group) before the step audit")
    d.add_argument("--no-jaxpr", action="store_true",  # the JAX flag name
                   help="config shapeflow only (skip the abstract trace)")
    d.add_argument("--json", default=None, metavar="PATH",
                   help="machine-readable findings ('-' = stdout)")
    d.set_defaults(fn=cmd_doctor)

    ch = sub.add_parser(
        "chaos",
        help="replay a seeded FaultPlan over a preset workload "
             "(utils/faultpoints; exit 1 on wedge/conservation "
             "violation)")
    ch.add_argument("--preset", required=True,
                    choices=("serving", "training", "divergence",
                             "decode"),
                    help="workload to run under the plan (divergence: "
                         "seeded NaN-at-step-k fit with the sentinel "
                         "armed — exit 1 unless quarantine/rollback "
                         "recover a finite final loss; decode: a "
                         "continuous-batching engine under decode_step "
                         "latency + hang — exit 1 unless the watchdog "
                         "degraded/recovered it with carried deadlines "
                         "shed and books conserved)")
    ch.add_argument("--plan", default=None, metavar="JSON",
                    help="FaultPlan JSON file (default: a built-in plan "
                         "for the preset)")
    ch.add_argument("--seed", type=int, default=None,
                    help="override the plan's seed (default plan: 0)")
    ch.add_argument("--requests", type=int, default=60,
                    help="serving preset: total requests")
    ch.add_argument("--clients", type=int, default=6,
                    help="serving preset: concurrent client threads")
    ch.add_argument("--deadline-ms", type=float, default=2000.0,
                    help="serving preset: per-request deadline budget")
    ch.add_argument("--steps", type=int, default=24,
                    help="training preset: batches in the epoch")
    ch.add_argument("--json", default=None, metavar="PATH",
                    help="machine-readable report ('-' = stdout) — diff "
                         "two runs' `events` to prove a replay")
    ch.add_argument("--trace-out", default=None, metavar="PATH",
                    help="run with tracing on and write the span export "
                         "(JSONL) here; the serving preset additionally "
                         "gates on every injected fault being linked to "
                         "a request trace (render with `cli trace`)")
    ch.set_defaults(fn=cmd_chaos)

    ln = sub.add_parser(
        "lint",
        help="concurrency/robustness lint over source paths "
             "(analysis/lint.py; --baseline "
             "deeplearning4j_tpu_torch/analysis/lint_baseline.txt is the "
             "gated form)")
    ln.add_argument("paths", nargs="*",
                    help="files/dirs (default: deeplearning4j_tpu_torch)")
    ln.add_argument("--json", default=None, metavar="PATH",
                    help="machine-readable findings ('-' = stdout)")
    ln.add_argument("--baseline", default=None, metavar="FILE",
                    help="suppress baselined ERROR names; exit 1 only on "
                         "new ones")
    ln.set_defaults(fn=cmd_lint)

    lk = sub.add_parser(
        "locks",
        help="merged static+runtime lock-discipline audit "
             "(analysis/concurrency_audit, CN001-CN003; "
             "DL4J_LOCKCHECK=1 arms the runtime half)")
    lk.add_argument("--smoke", action="store_true",
                    help="arm the sanitizer and run the serving + decode "
                         "+ sparse exercise before reporting")
    lk.add_argument("--json", default=None, metavar="PATH",
                    help="machine-readable report ('-' = stdout)")
    lk.add_argument("--baseline", default=None, metavar="FILE",
                    help="suppress baselined CN names "
                         "(deeplearning4j_tpu_torch/analysis/"
                         "lock_baseline.txt); exit 1 only on "
                         "new ones")
    lk.set_defaults(fn=cmd_locks)

    args = ap.parse_args(argv)
    from deeplearning4j_tpu_torch.common.devices import resolve_device

    # the JAX package's JAX_PLATFORMS handling: here the device is named,
    # and a missing GPU is an error, never a silent CPU run
    args.device = str(resolve_device(args.device))
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
