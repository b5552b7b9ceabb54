#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA GPU and check it end to end.

    python3 chip_smoke.py [--seed N] [--out chiprun_out/chip_smoke.json]
    python3 chip_smoke.py --only 18     # phase 1's build, then phase 18 alone
    python3 chip_smoke.py --only 18a    # phase 1's build, then 18a over every visible card

Phases; any failure raises and the script exits non-zero without its
result lines:

1. Device: the card's name and power limit (nvidia-smi), the build of
   every kernel from `deeplearning4j_tpu_torch/csrc/` (one nvcc per source,
   in parallel, with the swept variants of the BN streaming passes, see
   BN_SWEEP) with each kernel's registers, shared memory and spills
   (ptxas -v), and the HGMMA (wgmma) instructions in the SASS of every
   bf16 conv kernel (cuobjdump).
2. Kernels: each hand-written kernel against its plain PyTorch version on
   the card, at the shapes the main path gives it, in f32 and bf16. K2,
   the decode step, with and without peepholes at every STEP_B x STEP_H
   shape (up to its largest H), its rows bit-equal across B = 1, 8, 64
   and slot index, its device time at 1, 8 and 64 slots, and the sweep
   of its compile-time knobs (STEP_SWEEP: units a block, k chunks,
   programmatic dependent launch), each variant held against the plain
   version and timed alone, and as (input projection, K2) pairs eager
   and replayed from a CUDA graph. The
   sequence kernels K1 and
   K3 (K3 on the forward kernel's stashes) on both variants, cluster and
   grid (see FWD_SHAPES, BWD_SHAPES), with two launches bit-equal, and
   their launch geometry; the conv/BN kernels K4-K8 at the largest
   ResNet-50 instance of every conv family at batch 128 and of the BN
   passes, plus small
   shapes that reach each producer and tile edge of the conv kernels (see
   CONV_CASES) and a ragged BN shape; the conv and BN-backward statistics
   against the exact sums of the values the kernel stored (in bf16 that
   tells the stored y from the unrounded one); K7 and K8 with their
   prologue (the ReLU gate and the centring on their loads) bit-equal to
   the same kernels fed the materialised tensors, at every BN shape.
   Device time per call by torch.profiler (CUPTI) for the kernel, its
   plain version and one
   library call that computes the same function (cuDNN's LSTM without
   peepholes, F.conv2d without the statistics, F.batch_norm,
   torch.batch_norm_backward_reduce and torch.batch_norm_backward_elemt),
   beside the roofline bound, for the conv kernels at three ResNet-50
   shapes each (TIMED_CONVS); K7 and K8 with the prologue and K6 with
   ReLU at the stem's [1605632, 64] beside their bounds; K6 and K8 at
   [401408, 256] and at the stem for every swept variant of their
   streaming layout (BN_SWEEP), each bit-equal to the shipped build; for
   the LSTM kernels the wall time per back-to-back call by CUDA events
   beside them, and for K1 and K3 both
   variants' times and the microseconds per step.
3. Slice: full-width char-LSTM (vocab 77, hidden 200, 2 GravesLSTM
   layers, f32, weights from --seed): `output()` on a [32, 100, 77]
   one-hot batch equals the same net with the helpers switched off, and
   went through the sequence kernel.
4. Serve: `DecodeEngine(n_slots=8)`, two tenants weighted 3:1, 24
   requests (prompts of 1-32 tokens, 32-64 new tokens) with one weight
   swap halfway, once with one step per iteration and once with
   `set_fused_steps(4)`: each engine captures one CUDA graph per
   parameter set (two, at its warm-up) and replays one a step or a
   window. Every request's tokens equal the port's own sequential greedy
   `rnn_time_step` loop, and K=4's equal K=1's; the books conserve; the
   K2 launches and `helper_hit_total{op="lstm_decode_step"}` count every
   replay and warm-up. The graphed carry after 6 replays, on both
   parameter sets, is bit-equal to as many eager steps. One more pass at
   each K under torch.profiler gives the device's busy share and the K2
   nodes' device time inside the graph.
5. Train: the same full-width char-LSTM (TBPTT 50, RMSProp; lr 0.01, see
   TRAIN_LR) fits 3 batches of [32, 1000, 77] windows of SURVEY.md (60
   optimizer steps): tokens/s, first and last score (the last must be
   lower), two launches of the forward and of the backward kernel per
   step; then step p50/p99 over the same batches with the device synced
   at each step, and the device-busy share of one fit batch under
   torch.profiler, whose K1 and K3 must be the cluster kernels. Over the
   20 segments of one fit batch, in lockstep, the
   helpers-on step holds to the helpers-off step (the builtin loop plus
   autograd) in gradients, score, and the parameters and RMSProp state
   it leaves; left to run free, their score drift stays within a factor
   of the drift between the builtin loop on the card and on the CPU. One
   bf16 fit batch gives finite scores.
6. Train ResNet-50: `resnet50_network(precision="bf16")` at full width
   (weights from --seed) fits 2 synthetic batches of [128, 224, 224, 3]
   (from --seed, one-hot labels over 1000 classes) for 5 epochs, 10
   Nesterovs steps at lr 0.01 (see RESNET_LR): images/s, finite scores, batch 0's score
   lower on its last visit than on its first, and per step the launches
   of K4, K5 and K6 the conv routing's coverage table gives for this batch
   (resnet_per_step: 36, 17 and 53, every conv covered) and 53 each of K7
   and K8; then step p50/p99 with the
   device synced at each step, and one profiled step's busy share and
   device time by kernel (K4 and K5 summed by name, and K6-K8); one step's
   aten ops on BN-sized tensors, and one BN's backward at the stem's
   shape by kernel: neither runs a centring or ReLU-gate pass of its own
   (FOLDED_OPS). In f32 at batch 32,
   a few builtin steps in, one step with the helpers on holds to one with
   them off (the builtin torch layers) in gradients, score and the BN
   running statistics it leaves;
   at init, where the f32 gradient is ill-conditioned, the kernels'
   gradients stand no further from the builtin step in f64 than the
   builtin f32 gradients do (within a factor: see LOCKSTEP_BATCH).
7. Checkpoint, resume, evaluate, serve from a zip (in `_ckpt_smoke/`,
   removed at the end). 7a: the full-width char-LSTM of phase 5 fits 3
   batches of SURVEY.md windows through a shuffling ListDataSetIterator
   for 2 epochs (120 steps); the same fit runs in a child process (this
   script with --child) under an async CheckpointListener that saves at
   each epoch's end and on SIGTERM; the child is SIGKILLed once
   latest.json names the epoch-0 checkpoint and epoch 1 runs, and a fresh
   net's fit(resume_from=...) gives scores, parameters and RMSProp state
   bit-equal to the uninterrupted run's, with 2 launches each of K1 and
   K3 a resumed step. Then SIGTERM mid-batch: the fit holds it until
   the running segment's step is whole, and the preemption save counts
   the batch consumed (the reference's TBPTT rule) and the resume is
   held bit-equal to a run that skips the same segments. 7b: ResNet-50
   (bf16, batch 128, Nesterovs lr 0.01) on 4 batches a epoch for 2
   epochs: whether two uninterrupted runs are bit-equal with cuDNN's
   default algorithms; then, with cudnn.deterministic on for this part
   only, an async listener saving every 3 iterations (one save at
   batch_in_epoch 3 of 4), a crash after that save is flushed, and a
   fresh net resumed bit-equal in scores, parameters, Nesterovs state and
   BN running statistics, with phase 6's launches a step; and step
   p50/p99 with the async listener beside without it, with the
   checkpoint_save_seconds snapshot and write phases. 7c: save_model of
   both trained nets, verify_checkpoint, load_model on the card with
   output() bit-equal to the writer's (K1), evaluate() of the loaded
   ResNet-50 equal to an Evaluation of output() in numpy, a
   DecodeEngine(n_slots=8) on the loaded char-LSTM equal to the
   sequential loop (K2), and restore_latest skipping a corrupted newest
   checkpoint (checkpoint_integrity_failures_total rises).
8. The fused dispatch as CUDA graphs (nn/netbase.py `_run_fused`), each
   against the eager loop from the same start (a no-op listener, the JAX
   package's switch to the loop). 8a: the full-width char-LSTM fits
   SURVEY.md batches with no listener: each batch's 20 TBPTT steps are one
   graph (the first batch warms up eagerly, the second is captured), then
   set_fused_steps(4): 80 steps a graph; scores, parameters and RMSProp r
   bit-equal, 40 (160) launches each of K1 and K3 recorded per replay and
   the same counts as the loop's, the replay's profile showing the
   cluster kernels; synced dispatch p50/p99 and tokens/s of both, each
   one's device time and busy share under the profiler, the capture's
   seconds and graph pool. 8b: ResNet-50 (bf16, batch 128, Nesterovs lr
   0.01) with set_fused_steps(2), cudnn.deterministic: 10 steps bit-equal
   in scores, parameters, Nesterovs v and BN statistics, phase 6's K4-K8
   launches a step per replay; then 3 repeats of 20 steps each way
   for step p50/p99 (synced at each dispatch) and images/s, one profiled
   dispatch each (device ms a step, busy share), the capture's seconds,
   the graph pool and the peak memory. 8c: the graphed char-LSTM fit of 6
   host batches with the device prefetch pipeline on and off, bit-equal,
   with tokens/s.
9. LeNet, the second layer slice, VGG16 through the Keras importer and
   transfer learning. 9a: LeNet (the dl4j-examples LenetMnistExample, full
   width, f32, batch 64, Nesterovs lr 0.01 momentum 0.9) on synthetic MNIST
   read with allow_download=False: the first 5 scores on the card held to
   the port on the CPU from the same parameters (LENET_RTOL, TF32 off);
   then 100 steps: step p50/p99 (synced each step), images/s, the busy
   share of 10 profiled steps; no conv/BN kernel launches (the convs carry
   a bias: conv_declined_total{reason="bias"} counts 2 a step). 9b: each
   of the ten new layer confs at small widths, forward and input and
   parameter gradients on the card against the CPU (LAYER_RTOL), and 5
   pretraining steps each of an AutoEncoder, a VAE and an RBM fed the same
   noise on both devices, their scores held (LAYER_RTOL). 9c: VGG16 built
   by `vgg16_conf` through the port's Keras importer, full width: output()
   at batch 2 in an f32 build, card vs CPU (VGG_OUT_RTOL); 10 bf16 SGD
   steps at batch 32 on 2 batches (finite, batch 0's score falls; step
   p50/p99, images/s; no conv/BN kernel launches, 13 "bias" declines a
   step); then dl4j-examples' EditLastLayerOthersFrozen: freeze through
   dense_2 (fc2), a new 5-class head, 10 Nesterovs steps at batch 15,
   eager and under set_fused_steps(2) (each frozen leaf, its updater state
   and layer state bit-equal to before; the two runs' scores agree), and
   TransferLearningHelper.featurize + fit_featurized giving the full
   fine-tune's scores (HELPER_RTOL). 9d: ResNet-50 (bf16, batch 32) under
   GraphTransferLearning, frozen through s2b5_relu (stem and stages 1-3)
   with a new 5-class head: K4-K8 launch per step exactly for stage 4's
   convs and BNs and the frozen convs are declined for "inference"; the
   fused-ReLU marks are stage 4's BNs only; frozen leaves bit-equal eager
   and fused; in f32, one step with the kernels on holds to one with them
   off from the same start in score (RESNET_SCORE_RTOL) and in the
   unfrozen BNs' running statistics (RESNET_STATE_RTOL), as in phase 6,
   and the drift of two more free-running steps is printed.
10. The divergence sentinel, the line-search solvers and the DL4J-format
   importer. 10a: phase 5's full-width char-LSTM, 8 batches, each TBPTT
   batch one CUDA graph (no listener), a sentinel with checkpoint_dir and
   rollback_after=2, a checkpoint saved after batch 2 and the `nan` fault
   at batches 5 and 6: two nonfinite_loss verdicts, two quarantines (each
   undo bit-equal to a clone taken before the step, fit_graph_captures_total and the
   graph's tensor addresses unchanged), one rollback to the checkpoint,
   a replay that skips batches 5 and 6, K1/K3 launched, and final
   parameters, updater state and layer state bit-equal to a clean fit
   over batches 1-4, 7 and 8 from the same start; then the same with a
   CheckpointListener saving at every batch's end (the per-segment loop):
   the save taken during the anomalous step is rejected as "captured from
   a quarantined step", and the result is bit-equal again. 10b: phase 6's
   ResNet-50 (bf16, batch 128, cudnn.deterministic) 10 steps without and
   with a sentinel: parameters bit-equal, K4-K8 launched per step as in
   phase 6; step p50/p99 (synced), the busy share of one profiled step,
   the pre-step copy's bytes, device and host time, the judgment's host time,
   the graphed set_fused_steps(4) step the sentinel gives up, and phase
   9d's transfer net's step without and with a sentinel (the frozen
   gradients taken for the norm). 10c: phase 9's LeNet under each
   line-search solver, 5 batches on synthetic MNIST (allow_download=False):
   the score over them falls and stays finite, the first step holds to the
   same step on the CPU (SOLVER_RTOL), no kernel launches. 10d: the two
   fixture zips (`tests/fixtures/mln_adam_v1.zip`, the model zip, and
   `cg_adam_v1.zip` through the DL4J-format importer) loaded onto the card:
   outputs within the JAX tests' tolerance of `*_expected.npz`, then one
   Adam step from the imported updater state held to the same on the CPU
   (IMPORT_STEP_RTOL).
11. The embeddings stack (nlp/, graph/, native/), on corpus A (bench.py's
   Zipf generator, 20,000 sentences of 40 over 10,000 words) and corpus
   B (the two-topic corpus of tests/test_word2vec.py); no kernel of K1-K8
   lies on this path, and none launches. 11a: Word2Vec at
   VectorsConfiguration's defaults, skip-gram then CBOW (the batched
   path): words/s of train_indexed, synced; a profiled window of
   W2V_PROFILE_GROUPS groups (host and device ms a group, the busy
   share, the top device ops); card vs CPU from the same tables through
   W2V_HOLD_GROUPS groups (NLP_FIT_RTOL / NLP_FIT_ATOL, the loss
   NLP_LOSS_RTOL). 11b: the corpus-resident skip-gram path at
   bench_word2vec's configuration: words/s over 3 epochs after a
   warm-up, a profiled epoch's busy share, the dense trust-region clip's
   share of the device time (its device ms at a live chunk's indices,
   times the live chunks), and one epoch over the first CORPUS_HOLD_SENTS
   sentences on the card against the CPU with the same injected draws.
   11c: ParagraphVectors DM and DBOW (layer 100, HS): doc vectors nearer
   within a topic than across, infer_vector card vs CPU. 11d:
   GloVe.fit_file through the port's native corpus build on corpus A
   (the loss falls) and B (cat's nearest are the animals), DeepWalk on
   two joined cliques (the cliques separate). 11e: a full-model zip
   written on the card equals its tables read on the CPU. Scratch files
   go to `_nlp_smoke/` in the checkout, removed at the phase's end.
12. Scale-out (parallel/): the data-parallel step on SCALE_RANKS
   processes on the one card, spawned with torch.multiprocessing and
   joined by gloo with CUDA tensors (every collective and every join
   bounded; a rank that raises fails the script). 12c first: two NCCL
   ranks on the card, recorded (NCCL takes one rank a GPU). The one-process
   references run in this process. 12a: VGG16 through the Keras importer
   (224x224x3, 1000 classes, bf16, global batch 32: 16 rows a rank, 2 SGD
   steps) with bucket_bytes=0, the default 4 MiB and grad_dtype="bf16":
   the ranks bit-equal, bucketed bit-equal to monolithic in scores and
   parameters, allreduce_bytes_total the f32 parameter bytes a step
   (138,357,544 parameters) and half under the bf16 wire, 2 ranks within
   VGG_SCALE_* of one process; step p50 and
   train_step_collective_seconds (estimate and measured). 12b: ResNet-50
   (bf16, 2 ranks x 64 against one process at 128, 2 Nesterovs steps):
   K4-K8 launched per step a rank as the coverage table routes 64 rows,
   two BN all-reduces a step for a BN after a covered conv (K4/K5 -> K6
   and K7 -> K8) and three for one after a declined conv (the builtin
   forward's mean and centred sums, K7 -> K8), a profiled step's all-reduces by site
   (host and device ms), and score, BN running statistics and parameters
   within SCALE_WITNESS of the one-process run's distance from itself with
   the batches' rows reversed; the full-width char-LSTM on 2 ranks (two
   TBPTT segments): K1/K3 launched a segment, the first score as one
   process's. 12d on the same ranks: the TP Dense stack against the
   unsharded net, pipeline_apply against sequential_apply (values and
   gradients), ring attention against full attention (causal and not,
   f32 and bf16; values and gradients), the point-to-point staged through
   pinned host memory. 12c: a world-1 NCCL group in this process:
   MeshPlan.reduce_grads on ResNet-50's bucketed gradients, eager and
   captured in a CUDA graph, returns its input bit-equal; a world-1 meshed
   fit books 0 bytes and issues no collective. Scratch files go to
   `_scale_smoke/` in the checkout, removed at the phase's end; phase 12's
   numbers are a JSON line before the last three.
13. The serving front end (parallel/inference.py, serving/
   inference_server.py, utils/resourcemeter.py), weights from --seed at
   full width; servers bind 127.0.0.1 on port 0. 13a: the char-LSTM of
   phase 3 behind InferenceServer (max_batch_size 32, buckets 1-32 in
   powers of two warmed at (100, 77) before the port opens, 8 decode
   slots whose graphs are captured before it opens, metering on): 16
   client threads send 128 /predict requests of one-hot [n, 100, 77], n in
   1-32 drawn with weight 1/n, while 8 more send phase 4's 24 /generate
   requests (tenants a:b 3:1 by X-Tenant, one streamed as NDJSON). Each
   /predict row is held to output() of that request alone (SLICE_ATOL;
   bit-equal rows counted), each /generate to the sequential greedy loop;
   no forward-cache entry and no decode capture after warm-up; bucket hits
   sum to the batches; the /tenants books conserve per tenant and tier;
   K1 launches 2 a bucket forward and K2 2 a decode step; the Prometheus
   text parses. 13b: ResNet-50 (bf16, 224x224x3, 1000 classes) through a
   ReplicaPool of 2 replicas sharing the weights, every bucket warmed, 16
   clients and 192 requests sized as in 13a, evict(0) once in mid-run:
   rows within BF16_ULP*max(1, |v|) of each request's own output(), no
   error but the in-flight group's, the books conserve, one respawn, no
   K4-K8 launch (inference declines the conv kernels and BN uses its
   running statistics). 13c: the char-LSTM pipeline in-process, after a
   closed-loop capacity probe, for OVERLOAD_SECONDS with twice what it
   can finish within the 100 ms deadline kept in flight (queue capacity
   64): shed rate, admitted p99 against the deadline, the largest queue
   depth against its capacity, the books. For 13a and 13b the busy share
   is estimated from each hit bucket's device ms (torch.profiler) times
   its hits over the traffic's wall. Phase 13's numbers are a JSON line
   before the last three.
14. The parameter-server path and the run ledger (parallel/paramserver.py,
   parallel/sparse.py, models/recsys.py, utils/runledger.py,
   analysis/slo.py, utils/flops.py). 14a: bench.py's bench_recsys
   configuration, not cut: the tower (64 -> 192 -> 192 -> 2, He init
   from --seed) on the card over a zero 800,000 x 64 f32 table on 2
   in-process endpoints, batch 1024 of zipf(1.1) ids labelled ids & 1, 6
   + 40 steps at lr 0.05, a pull latency of clamp(the tower's step ms, 10,
   60) injected at the paramserver_rpc fault point, a run ledger with the
   default rule pack, a tenant budget and two rules of bench_recsys's own;
   the pipelined arm (65,536 cached rows, prefetch) under torch.profiler
   (its busy share), then the synchronous arm (neither). Gates: the tower
   and both endpoints' tables byte-equal between the arms, the books
   (pull_rows == cache_hit + cache_miss), no dl4j-sparse/-ps thread left,
   tenant spend conserves, no error-severity rule fired, and the
   synchronous arm's first 8 steps on the card within RECSYS_RTOL /
   RECSYS_ATOL of the CPU (tower and touched rows). 14b: the recsys preset
   at its defaults with the table on the card, fit 20 batches of 1024 with
   run_ledger= and a PerformanceListener: the ledger's fit_step_total +20,
   its manifest naming the card, flops_source "analytic", the listener's
   mfu in (0, 1], the first 3 steps within the same bound of the CPU.
   14c: the char-LSTM through ParallelInference, DecodeEngine and
   InferenceServer, each with run_ledger=<path>: each ledger's request
   series grown by the requests sent, no error-severity rule fired on
   replay through the serving rule pack, /alerts' keys and rules. 14d: MFU
   of phase 8's graphed ResNet-50 and phase 5's char-LSTM from the
   analytic FLOP count over the card's dense bf16 peak (above 1 fails).
   14a and 14b launch none of K1-K8, 14c launches K1 and K2. Ledgers go
   to `_recsys_smoke/` in the checkout, removed at the phase's end;
   phase 14's numbers are a JSON line before the last three.
15. Device observability and static analysis (analysis/kernelcoverage.py,
   analysis/costmodel.py, utils/devprof.py, utils/profiler.py). 15a':
   ResNet-50 bf16 b128 graphed, the shipped structural routing against
   the planning table's (compute-bound convs declined to cuDNN), in
   rounds: launches a replay from each table, synced step p50 and device
   ms a step. 15a: the coverage table of ResNet-50 at b128 bf16, planned
   (34 covered / 19 declined on the H100 SXM figures) and routed (53 / 0),
   none unsupported, beside phase 8's graphed step. 15b: the step cost
   model of ResNet-50 b128 bf16 and the full-width char-LSTM: model FLOPs
   beside the analytic count, JX007 against FlopCounterMode within 10%,
   no JX008 at the card's memory, the roofline, the static memory beside
   one eager step's max_memory_allocated. 15c: a 12-step ResNet-50 fit
   sampled every 4th step with the cost model attached: step_device_seconds
   within OBS_STEP_RTOL of CUDA events on the same steps, step_mfu, every
   device_memory_bytes kind > 0; an injected oom in fit and in a
   ParallelInference forward, each dumping forensics that name live CUDA
   tensors and counting oom_total{where}. 15d: ProfilerListener over 3
   ResNet-50 steps and 2 char-LSTM batches, write_profile_json: K1, K3 and
   K4-K8 named by family, each with its cost-model bound. Phase 15's
   numbers are a JSON line before the last three.
16. The training UI and the clustering stack (ui/, clustering/,
   serving/knnserver.py, keras_backend.py; in `_ui_smoke/`, removed at
   the end). 16a: phase 6's ResNet-50 (bf16, b128) for 8 steps with
   collect_stats and StatsListener(frequency=1, 20-bin histograms every
   4th report) through RemoteUIStatsStorageRouter into a UIServer over a
   FileStatsStorage: each record's score is the fit's own, the mean
   magnitudes cover every parameter leaf, histogram counts sum to each
   leaf's size, device0's memory and the card's name are there, K4-K8
   launch in every step, every data route answers 200, the file read
   cold equals the server's records; step p50 with the listener and
   without it, and the device-to-host copies of one report step (at most
   UI_D2H_MAX). 16b: VGG16 bf16 b32, 3 steps with
   ConvolutionalIterationListener: the dashboard's activation grid
   within CONV_UI_ATOL of the CPU's f32 grid from the same parameters and
   batch. 16c: KerasBackendServer /fit with the published VGG16 widths
   (32 examples as .npy, batch 16, one epoch) and /evaluate. 16d: 100,000
   x 300 f32 "word vectors" (100 Gaussian clusters) on the card: k-means
   (k=100, euclidean and cosine) whose first Lloyd step matches the CPU's
   from the same centres and whose two runs are bit-equal; t-SNE's P
   against the CPU's, card and CPU kl_ from the same y0 at n=2,000, and
   the wall at n=10,000 (1000 iterations); the k-NN server's cosine (flat
   device) and euclidean (host tree) arms under 16 clients, every answer
   equal to the CPU's brute force bar ties; the dashboard's /tsne/compute
   on 2,000 vectors. Phase 16's numbers are a JSON line before the last
   three.
17. The operator CLI and the lock audit (cli.py, utils/locktrace.py,
   analysis/lint.py, analysis/concurrency_audit.py, analysis/tracecrit.py;
   in `_cli_smoke/`, removed at the end). 17a: the CLI's
   inference-server (`cli.main(["inference-server", ...])` in a child,
   this script with --child server) on phase 3's char-LSTM zip, phase
   13a's traffic over HTTP: every /predict row within SLICE_ATOL of this
   process's output() of the same zip, every /generate equal to the
   greedy rnn_time_step loop; the child counts K1's and K2's launches
   from its readiness (after its warm-ups) to SIGTERM, and `cli metrics
   --url` reads the server's helper_hit_total for K1 and K2, a check
   that both were reached; requests/s beside phase 13a's. 17b: a child started with
   DL4J_LOCKCHECK=1 runs phase 8's graphed ResNet-50 (bf16, b128,
   set_fused_steps(4)), phase 4's decode engine (8 slots, 24 requests,
   one weight swap) and the lock audit's smoke (concurrency_audit.smoke)
   with the sanitizer armed: the merged audit's CN names equal
   deeplearning4j_tpu_torch/analysis/lock_baseline.txt, K2 and K4-K8
   launch while armed, and the graphed step's and the decode step's p50
   are taken armed and then unarmed in the same process. 17c: `cli
   train` on LeNet over a CSV of synthetic digits, `cli evaluate` (equal
   to the saved zip's own evaluation), and `cli resume` on a checkpoint
   of two graphed ResNet-50 steps. 17d: `cli profile --preset resnet50`
   over a utils.profiler.trace of two graphed steps names K4-K8 by family,
   each with the bound of its own instances' work (the launches it prices
   equal the capture's, and the kernel's time lies between the bound and
   PROFILE_BOUND_RATIO times it); `cli perf --json` counts phase 15's
   FLOPs. 17e: in a fresh child, `cli chaos` decode and divergence, twice
   each with one seed: verdict ok, equal events, and `cli trace` renders
   each export. Phase 17's numbers are a JSON line before the last
   three.
18. ParallelInference over several devices of one process and the scan
   over identical blocks (parallel/inference.py `devices=`, nn/
   compgraph.py `set_block_scan`). 18a: phase 3's char-LSTM behind
   ParallelInference(max_batch_size=16), SHARD_REQUESTS requests of 1-16
   rows (weighted 1/n) from SERVE_CLIENTS threads, with the default
   devices (one shard on the card), split over SHARD_DEVICES (two shards
   on the one card, each on its own stream) and, where the process sees
   several cards, over every card; the arms alternate SHARD_ROUNDS times.
   Every row within SHARD_RTOL/SHARD_ATOL of that request's own output(),
   K1 launching layers x shards x groups times, `output_compile_count`
   equal to the JAX package's `_expected_traces(buckets, shards)`, and
   after a set_params a request served with the new parameters;
   requests/s, p50, p99 of each arm and round. 18b: ResNet-50 bf16 b128
   unrolled against scanned runs: output() and SCAN_FUSED_K eager steps
   bit-equal (params, Nesterovs v, BN statistics; cudnn.deterministic),
   K4-K8 launches equal and as the coverage table says,
   `compile_total{kind="graph_block"}` 12 against 4; then set_fused_steps(4)
   over SCAN_GROUPS groups (warm-up, capture, replay) bit-equal with equal
   launches; each arm's eager and graphed step p50/p99 over SCAN_ROUNDS
   alternating rounds (24 steps and 24 replays an arm).
   Phase 18's numbers are a JSON line before the last three.
The last three lines of standard output are the kernels JSON line, the
card line, and {"ok": true, "device": {...}}. Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import collections
import json
import math
import os
import statistics
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))

# The script profiles CUDA graph replays (phases 2 and 4) and profiles
# again after them. CUPTI's teardown between profiles does not work well
# with CUDA graphs (torch.profiler's own note where it sets this for
# compiled graphs): a later profile can miss a kernel. Keep CUPTI set up
# for the process instead; set before the port's import below loads torch.
os.environ.setdefault("DISABLE_CUPTI_LAZY_REINIT", "1")
sys.path.insert(0, HERE)

# H100 SXM published peaks (NVIDIA data sheet), from their one home in the
# port (utils/flops.py): HBM bandwidth and the dense bf16 tensor-core rate
from deeplearning4j_tpu_torch.utils.flops import (  # noqa: E402
    H100_BF16_DENSE_FLOP_PER_S as BF16_FLOP_PER_S,
    H100_HBM_BYTES_PER_S as HBM_BYTES_PER_S,
)

# and the f32 rate outside the tensor cores, which is what the LSTM
# kernels' FMAs use
F32_FLOP_PER_S = 67e12

VOCAB, HIDDEN, LAYERS = 77, 200, 2
F32_ATOL = 1e-5          # kernel vs plain, both f32 math: summation order only
# dRW and the peephole grads are sums of T*B products: the rounding of a
# sum taken in another order grows like sqrt(T*B), so their f32 tolerance
# is F32_ATOL * sqrt(T*B)
BF16_ULP = 2.0 ** -7     # bf16 rounding step at |v| in [1, 2)
SLICE_ATOL = 1e-4        # softmax outputs after 100 steps x 2 layers, f32
TRAIN_BATCHES, TRAIN_B, TRAIN_T, TBPTT = 3, 32, 1000, 50
# At the published lr 0.1 RMSProp's first step moves every weight by
# ~4.5 lr = 0.45, ten times the xavier scale, and the score rises more than
# threefold at the second step, in the JAX package and in the port alike
# (tests/test_torch_charlstm_fit.py::
# test_published_lr_rises_alike_in_both_packages_at_full_width). Phase 5
# trains at 0.01, where the score falls. The work per step does not depend
# on lr.
TRAIN_LR = 0.01
# helpers on vs off, in lockstep over the 20 segments of one fit batch
# (both paths take each step from the same parameters and updater state),
# f32: the gradients agree to 1e-4 of each tensor's largest entry (sums
# over up to T*B = 1600 terms in another order), the score to 1e-5
# relative; after the step, the parameters to 1e-4 of the step's own size
# (|p_on - p_off| over |p_off - p_before|, L2 over all leaves: RMSProp
# moves an entry by ~4.5 lr whatever its gradient, so a rounding-level
# gradient near zero may move its entry by a visible fraction of that) and
# RMSProp's r to 1e-4 of each tensor's largest entry.
TRAIN_GRAD_RTOL = 1e-4
TRAIN_SCORE_RTOL = 1e-5
TRAIN_PARAM_RTOL = 1e-4
TRAIN_STATE_RTOL = 1e-4
# Left to run free over the 20 steps of one fit batch, the two paths part
# further each step: RMSProp amplifies any rounding difference. The
# witness is the builtin loop on the card against the builtin loop on the
# CPU from the same parameters, which differ in nothing but the order of
# their f32 sums. The largest relative score drift of helpers on vs off
# must stay within DRIFT_FACTOR times the witness's. The peak of a chaotic
# drift varies several-fold between rounding-only pairs, so the factor is
# wide: it guards against a gross departure, and a fault beyond rounding
# shows in the lockstep check.
DRIFT_FACTOR = 30


class SmokeFailure(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(torch, fn, reps=20, rounds=5) -> float:
    """Median over `rounds` of the mean time of `reps` back-to-back calls,
    by CUDA events, after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    vals = []
    for _ in range(rounds):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        for _ in range(reps):
            fn()
        e.record()
        e.synchronize()
        vals.append(s.elapsed_time(e) / reps)
    return statistics.median(vals)


PROFILE_TRIES = 3


def device_ms(torch, fn, reps=20):
    """Device time per call: the CUDA kernels, copies and memsets that
    `reps` calls put on the card, summed by torch.profiler (CUPTI), over
    `reps`. Host overhead between launches is not in it. None when the
    profiler sees no device activity. Device activity only: with CPU
    activity on, key_averages() also gives each aten op (F.conv2d, the
    plain versions' ops) its kernels' time as its own, and the sum counts
    those kernels twice; a kernel launched through ctypes has no op."""
    total = sum(device_by_kernel(torch, fn, reps).values())
    return total if total > 0 else None


def device_by_kernel(torch, fn, reps=20):
    """device_ms() by kernel name, with the template arguments and
    parameters cut."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    out = {}
    for _ in range(PROFILE_TRIES):  # a profile that saw nothing is taken again
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        for e in prof.key_averages():
            t = getattr(e, "self_device_time_total", 0.0)
            if t > 0:
                name = e.key.replace("void ", "").replace("(anonymous namespace)::", "")
                name = name.split("<")[0].split("(")[0]
                out[name] = out.get(name, 0.0) + t / 1e3 / reps
        if out:
            break
    return out


def opt(ms, spec=".4f") -> str:
    """A time that may be missing (None: the profiler saw no device time
    for a yardstick), formatted."""
    return "not measured" if ms is None else format(ms, spec)


def bound(nbytes: float, flops: float, peak: float = F32_FLOP_PER_S) -> tuple:
    """The least time (ms) the card could take: bytes over the HBM rate or
    operations over `peak`, whichever is larger, and which it was."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def kernel_name(ptxas_line: str) -> str:
    """The kernel's name in a ptxas "Compiling entry function '_ZN...'"
    line: the last identifier of the mangled nested name, with its
    template arguments where they are f32, bf16, ints or bools."""
    s = ptxas_line.split("'")[1] if "'" in ptxas_line else ptxas_line
    if not s.startswith("_ZN"):
        return s[:60]
    s, name = s[3:], ""
    while s[:1].isdigit():
        digits = len(s) - len(s.lstrip("0123456789"))
        n = int(s[:digits])
        name, s = s[digits:digits + n], s[digits + n:]
    args = []
    if s.startswith("I"):
        s = s[1:]
        while s and s[0] != "E":
            if s.startswith("f"):
                args.append("f32")
                s = s[1:]
            elif s.startswith("13__nv_bfloat16"):
                args.append("bf16")
                s = s[15:]
            elif s.startswith("L") and "E" in s:  # a literal: Li4E, Lb0E
                lit, s = s[1:s.index("E")], s[s.index("E") + 1:]
                args.append({"b0": "false", "b1": "true"}.get(lit, lit[1:]))
            else:
                break
    return name + (f"<{', '.join(args)}>" if args else "")


def tensor_core_check(cuda_build) -> dict:
    """HGMMA (wgmma) instructions per kernel in the SASS of the built conv
    libraries (cuobjdump -sass): every bf16 conv kernel must have them, so
    its products run on the tensor cores."""
    tool = os.path.join(os.path.dirname(cuda_build._nvcc()), "cuobjdump")  # beside nvcc
    counts = {}
    for lib in ("conv1x1_stats", "conv_kxk_stats"):
        sass = subprocess.run([tool, "-sass", cuda_build._lib_path(lib)], capture_output=True,
                              text=True, timeout=120, check=True).stdout
        fn = None
        for line in sass.splitlines():
            if "Function :" in line:
                fn = line.split("Function :", 1)[1].strip()
                counts[fn] = 0
            elif fn is not None and "HGMMA" in line:
                counts[fn] += 1
    bf16 = {f: c for f, c in counts.items() if "bf16_kernel" in f}
    print(f"  HGMMA instructions in the SASS (cuobjdump): "
          + ", ".join(f"{f[:60]} {c}" for f, c in counts.items()))
    check(len(bf16) == 8 and all(bf16.values()),
          f"a bf16 conv kernel has no wgmma in its SASS: {counts}")
    return counts


# -- phase 2: kernels ---------------------------------------------------------


def kernel_inputs(torch, gen, dtype, T, B, H, peephole):
    def mk(*shape, scale=1.0):
        return (torch.randn(*shape, generator=gen) * scale).to(dtype).cuda()

    xg = mk(B, 4 * H) if T is None else mk(T, B, 4 * H)
    rw = mk(H, 4 * H, scale=0.1)
    if peephole:
        p = [mk(H, scale=0.3) for _ in range(3)]
    else:
        p = [torch.zeros(H, dtype=dtype, device="cuda") for _ in range(3)]
    return [xg, rw, *p, mk(B, H, scale=0.5), mk(B, H, scale=0.5)]


def compare(torch, outs, refs, dtype, atol=F32_ATOL):
    """(max abs err, max rel err, within tolerance) over paired outputs:
    f32 to `atol`, bf16 to one rounding step."""
    err = rel = 0.0
    ok = True
    for o, r in zip(outs, refs):
        o, r = o.float(), r.float()
        check(bool(torch.isfinite(o).all()), "kernel output is not finite")
        d = (o - r).abs()
        err = max(err, d.max().item())
        rel = max(rel, (d.max() / r.abs().max().clamp_min(1e-30)).item())
        if dtype == torch.float32:
            ok &= bool((d <= atol).all())
        else:
            ok &= bool((d <= BF16_ULP * r.abs().clamp_min(1.0)).all())
    return err, rel, ok


# K2 (csrc/lstm_step.cu) is held at every (B, H) here, f32 and bf16,
# peepholes on and off: 1, 8 and 64 slots and a ragged 70 (its last block
# of 8 rows part full); char-LSTM's H = 200, a small and a larger H, and
# its largest (where fused_lstm.step_smem reaches the H100's 227 KB: f32
# 2398, not a multiple of K2's 4 units a block, so RW is staged by plain
# loads; bf16 3596, by cp.async). f32 to F32_ATOL * sqrt(H): a sum of H
# products in another order.
STEP_B = (1, 8, 64, 70)
STEP_H = (24, 200, 300, "limit")
STEP_TIMED_B = (1, 8, 64)
# K2's compile-time knobs (csrc/lstm_step.cu): units a block STEP_U, k
# chunks STEP_S, programmatic dependent launch STEP_PDL; the shipped build
# is U = 4, S = 4, PDL on. Each variant is built by
# cuda_build.variant_library and called through the same C entry.
STEP_SWEEP = ([(("STEP_U", u), ("STEP_S", sp)) for u in (2, 4, 8) for sp in (1, 2, 4)
               if (u, sp) != (4, 4)] + [(("STEP_S", 8),), (("STEP_PDL", 0),)])
# launches of (input projection, K2) pairs in one captured graph, for the
# chain timing of the sweep
CHAIN_REPS = 20


def step_limit(torch, fl, dtype) -> int:
    H = 1
    while fl.step_smem(H + 1, dtype) <= fl.SMEM_LIMIT:
        H += 1
    return H


def step_rows_hold(torch, fl, gen, dtype):
    """Each row of a B = 8 call has the bits of the same row alone at B =
    1, of the same row at another slot index within B = 8, and in the last
    row block of a B = 64 call. Returns the number of rows compared."""
    a = kernel_inputs(torch, gen, dtype, None, 8, HIDDEN, True)
    h8, c8 = fl.lstm_step(*a)
    n = 0
    for b in range(8):
        idx = [b]
        h1, c1 = fl.lstm_step(a[0][idx].contiguous(), *a[1:5], a[5][idx].contiguous(),
                              a[6][idx].contiguous())
        check(torch.equal(h1[0], h8[b]) and torch.equal(c1[0], c8[b]),
              f"lstm_step row {b} at B=1 differs from B=8 ({dtype})")
        n += 1
    perm = torch.roll(torch.arange(8), 3)
    hp, cp = fl.lstm_step(a[0][perm].contiguous(), *a[1:5], a[5][perm].contiguous(),
                          a[6][perm].contiguous())
    check(torch.equal(hp, h8[perm]) and torch.equal(cp, c8[perm]),
          f"lstm_step rows change bits with their slot index ({dtype})")
    big = kernel_inputs(torch, gen, dtype, None, 64, HIDDEN, True)
    for t, src in ((big[0], a[0]), (big[5], a[5]), (big[6], a[6])):
        t[56:] = src
    h64, c64 = fl.lstm_step(big[0], *a[1:5], big[5], big[6])
    torch.cuda.synchronize()
    check(torch.equal(h64[56:], h8) and torch.equal(c64[56:], c8),
          f"lstm_step rows at slots 56-63 of B=64 differ from B=8 ({dtype})")
    return n + 16


def step_sweep(torch, fl, seed):
    """K2 for each variant of STEP_SWEEP and the shipped build, at B = 8,
    H = 200, f32, through the same C entry: held against the plain
    version; device time alone (torch.profiler); and the wall time per
    (input projection, K2) pair by CUDA events, eager back-to-back and
    replayed from one captured graph of CHAIN_REPS pairs, where K2's
    predecessor is the projection (addmm) that writes its xg."""
    from deeplearning4j_tpu_torch.ops import cuda_build

    gen = torch.Generator().manual_seed(seed + 7)
    B, H = 8, HIDDEN
    a = kernel_inputs(torch, gen, torch.float32, None, B, H, True)
    x = torch.randn(B, VOCAB, generator=gen).cuda()
    W = (torch.randn(VOCAB, 4 * H, generator=gen) * 0.1).cuda()
    bias = torch.randn(4 * H, generator=gen).cuda()
    xg, h1, c1 = a[0], torch.empty_like(a[5]), torch.empty_like(a[6])
    p = lambda t: t.data_ptr()  # noqa: E731
    res = {}
    for defines in [()] + STEP_SWEEP:
        tag = (", ".join(f"{k}={d}" for k, d in defines)
               or f"shipped (STEP_U={fl.STEP_UNITS}, STEP_S={fl.STEP_SPLIT}, STEP_PDL=1)")
        lib = (cuda_build.variant_library("lstm_step", defines) if defines
               else cuda_build.library("lstm_step"))
        fn = cuda_build.entry_of(lib, "lstm_step", 9, 2)

        def k2():
            return fn(0, *(p(t) for t in (xg, *a[1:7], h1, c1)), B, H,
                      torch.cuda.current_stream().cuda_stream)

        def pair():
            torch.addmm(bias, x, W, out=xg)
            check(k2() == 0, f"lstm_step ({tag}) did not launch")

        torch.addmm(bias, x, W, out=xg)
        refp = fl.lstm_step_reference(*a)
        check(k2() == 0, f"lstm_step ({tag}) did not launch")
        torch.cuda.synchronize()
        err, _, ok = compare(torch, (h1, c1), refp, torch.float32, F32_ATOL * H ** 0.5)
        check(ok, f"lstm_step ({tag}) disagrees with its plain version: {err:.3e}")
        alone = device_ms(torch, k2)
        check(alone is not None, f"the profiler saw no device time for lstm_step ({tag})")
        eager = cuda_ms(torch, pair)
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            pair()
        torch.cuda.current_stream().wait_stream(side)
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            for _ in range(CHAIN_REPS):
                pair()
        graphed = cuda_ms(torch, g.replay, reps=5) / CHAIN_REPS
        nodes = device_by_kernel(torch, g.replay, reps=5)
        k2_node = sum(v for k, v in nodes.items() if "lstm_step_kernel" in k) / CHAIN_REPS
        res[tag] = {"max_abs_err": err, "ms": alone, "pair_eager_ms": eager,
                    "pair_graph_ms": graphed, "k2_node_ms": k2_node}
        print(f"    {tag}: max abs {err:.2e}; K2 alone {alone * 1e3:.3f} us (profiler); "
              f"(addmm, K2) pair {eager * 1e3:.3f} us eager, {graphed * 1e3:.3f} us from a "
              f"graph (events), K2 node {k2_node * 1e3:.3f} us (profiler)")
    return res


def kernel_phase(torch, fl, seed):
    """K2, the decode step: held at every STEP_B x STEP_H shape, rows
    bit-equal across B and slot index, device time at 1, 8 and 64 slots,
    and the sweep of its compile-time knobs."""
    gen = torch.Generator().manual_seed(seed)
    errs = {torch.float32: 0.0, torch.bfloat16: 0.0}
    for dtype in (torch.float32, torch.bfloat16):
        limit = step_limit(torch, fl, dtype)
        for H in STEP_H:
            H = limit if H == "limit" else H
            worst = 0.0
            for B in STEP_B:
                for peep in (True, False):
                    a = kernel_inputs(torch, gen, dtype, None, B, H, peep)
                    outs = fl.lstm_step(*a)
                    torch.cuda.synchronize()
                    refs = fl.lstm_step_reference(*a)
                    err, rel, ok = compare(torch, outs, refs, dtype, F32_ATOL * H ** 0.5)
                    check(ok, f"lstm_step disagrees with its plain version "
                              f"({dtype}, B={B}, H={H}, peepholes={peep}): {err:.3e}")
                    worst = max(worst, err)
                    if H == HIDDEN:
                        errs[dtype] = max(errs[dtype], err)
            print(f"  lstm_step {str(dtype)[6:]} H={H} B={STEP_B} peepholes on/off: max abs "
                  f"{worst:.3e} (tolerance {F32_ATOL * H ** 0.5:.2e} f32, one step bf16)"
                  + (" [the largest H]" if H == limit else ""))
        n = step_rows_hold(torch, fl, gen, dtype)
        print(f"  lstm_step {str(dtype)[6:]}: {n} rows bit-equal across B = 1, 8, 64 and "
              f"slot index")
    H = HIDDEN
    by_b = {}
    for B in STEP_TIMED_B:
        a = kernel_inputs(torch, gen, torch.float32, None, B, H, True)
        nin = sum(t.numel() for t in a)
        b_ms, b_by = bound(4 * (nin + 2 * B * H), 2.0 * B * H * 4 * H)
        by_b[B] = {"ms": device_ms(torch, lambda: fl.lstm_step(*a)), "bound_ms": b_ms,
                   "bound_by": b_by, "blocks": -(-H // fl.STEP_UNITS) * -(-B // fl.STEP_ROWS)}
        check(by_b[B]["ms"] is not None, f"the profiler saw no device time for lstm_step "
                                         f"at B={B}")
        print(f"  lstm_step B={B} f32: device time per call {by_b[B]['ms'] * 1e3:.3f} us "
              f"(profiler), bound {b_ms * 1e3:.4f} us by {b_by}, {by_b[B]['blocks']} blocks")
    B = 8
    a = kernel_inputs(torch, gen, torch.float32, None, B, H, True)
    call = {"kernel": cuda_ms(torch, lambda: fl.lstm_step(*a)),
            "plain": cuda_ms(torch, lambda: fl.lstm_step_reference(*a), reps=3)}
    dev = {"kernel": device_ms(torch, lambda: fl.lstm_step(*a)),
           "plain": device_ms(torch, lambda: fl.lstm_step_reference(*a), reps=3)}
    b_ms, b_by = by_b[B]["bound_ms"], by_b[B]["bound_by"]
    # the library yardstick computes the same function without
    # peepholes: input weights = identity on the 4H projections
    z = [torch.zeros(H, device="cuda") for _ in range(3)]
    eye = torch.eye(4 * H, device="cuda")
    rwT = a[1].t().contiguous()
    zb = torch.zeros(4 * H, device="cuda")

    def lib():
        return torch.lstm_cell(a[0], (a[5], a[6]), eye, rwT, zb, zb)[0]

    ker_out = fl.lstm_step(a[0], a[1], *z, a[5], a[6])[0]
    call["library"] = cuda_ms(torch, lib)
    dev["library"] = device_ms(torch, lib)
    lib_diff = (lib() - ker_out).abs().max().item()
    ms = {k: dev[k] if dev[k] is not None else call[k] for k in call}
    source = "profiler" if dev["kernel"] is not None else "events"
    print(f"  lstm_step B={B} f32: device time per call ({source}) kernel "
          f"{ms['kernel']:.5f} ms, plain {ms['plain']:.5f} ms, library "
          f"{ms['library']:.5f} ms; bound {b_ms:.5f} ms by {b_by}; wall time per "
          f"back-to-back call (events) kernel {call['kernel']:.5f} ms, plain "
          f"{call['plain']:.5f} ms, library {call['library']:.5f} ms; library vs "
          f"kernel without peepholes: max abs {lib_diff:.2e}")
    print("  lstm_step sweep (STEP_SWEEP), B=8 H=200 f32:")
    sweep = step_sweep(torch, fl, seed)
    return {"lstm_step": dict(
        err_f32=errs[torch.float32], err_bf16=errs[torch.bfloat16], ms=ms["kernel"],
        plain_ms=ms["plain"], library_ms=ms["library"], ms_source=source,
        call_ms=call, bound_ms=b_ms, bound_by=b_by, shape={"B": B, "H": H},
        by_batch=by_b, sweep=sweep,
        limits={str(d)[6:]: step_limit(torch, fl, d) for d in (torch.float32, torch.bfloat16)})}


# K1 and K3 are held at these (T, B, H), on every variant that takes the
# shape (fused_lstm.lstm_variant): char-LSTM's widths at output()'s T=100
# and training's T=50, batches 1, 8 and 32 (clusters of 4 rows); a ragged
# shape (B not a multiple of the cluster's rows, H not a multiple of its 8
# CTAs); a short B=1 sequence; B=70, clusters of 8 rows, the last one
# ragged; and H=300, past the cluster variant's H <= 256, which only the
# grid variant takes.
FWD_SHAPES = ((100, 1, 200), (100, 8, 200), (100, 32, 200), (50, 32, 200),
              (7, 5, 20), (3, 1, 200), (10, 70, 200), (20, 32, 300))
BWD_SHAPES = ((50, 32, 200), (100, 32, 200), (7, 5, 20), (3, 1, 200), (10, 70, 200),
              (20, 32, 300))


def lstm_variants(torch, fl, B, H, backward):
    """The sequence-kernel variants that take (B, H): both where the
    cluster variant does, the grid variant alone past it."""
    out = []
    for v in fl.VARIANTS:
        try:
            fl.lstm_variant(B, H, torch.float32, backward=backward, variant=v)
            out.append(v)
        except ValueError:
            pass
    return out


def geometry(torch, fl, B, H, backward):
    """Each variant's launch at (B, H), for the log and the record."""
    geo = {}
    for v in lstm_variants(torch, fl, B, H, backward):
        g = fl.lstm_variant(B, H, torch.float32, backward=backward, variant=v)
        if v == "cluster":
            g["max_active_clusters"] = fl.cluster_occupancy(H, g["R"], backward=backward)
            desc = (f"{g['ctas'] // g['C']} clusters x {g['C']} CTAs = {g['ctas']} CTAs "
                    f"(at most {g['ctas']} SMs), {g['max_active_clusters']} clusters "
                    f"fit at once (cudaOccupancyMaxActiveClusters)")
        else:
            desc = f"one cooperative grid of {g['ctas']} blocks"
        print(f"    {v}: {desc}; R={g['R']} rows, U={g['U']} units a CTA, "
              f"{g['smem_bytes']} bytes of shared memory a CTA")
        geo[v] = g
    return geo


def sequence_phase(torch, fl, seed):
    """K1 at FWD_SHAPES on each variant, f32 and bf16, with and without
    peepholes: against its plain version, and two launches bit-equal;
    then both variants' times at T=100, B=32 beside cuDNN's nn.LSTM."""
    gen = torch.Generator().manual_seed(seed)
    errs = {(v, d): 0.0 for v in fl.VARIANTS for d in (torch.float32, torch.bfloat16)}
    for dtype in (torch.float32, torch.bfloat16):
        for T, B, H in FWD_SHAPES:
            for v in lstm_variants(torch, fl, B, H, False):
                for peep in (True, False):
                    a = kernel_inputs(torch, gen, dtype, T, B, H, peep)
                    outs = fl.lstm_sequence_forward(*a, variant=v)
                    again = fl.lstm_sequence_forward(*a, variant=v)
                    torch.cuda.synchronize()
                    refs = fl.lstm_sequence_forward_reference(*a)
                    err, rel, ok = compare(torch, outs, refs, dtype)
                    same = all(torch.equal(x, y) for x, y in zip(outs, again))
                    print(f"  lstm_sequence {v} {str(dtype)[6:]} T={T} B={B} H={H} "
                          f"peepholes={peep}: max abs {err:.3e} rel {rel:.3e} "
                          f"{'ok' if ok else 'OUT OF TOLERANCE'}; two launches "
                          f"{'bit-equal' if same else 'DIFFER'}")
                    check(ok, f"lstm_sequence ({v}) disagrees with its plain version "
                              f"({dtype}, T={T}, B={B}, H={H}, peepholes={peep})")
                    check(same, f"lstm_sequence ({v}): two launches differ "
                                f"({dtype}, T={T}, B={B}, H={H})")
                    errs[v, dtype] = max(errs[v, dtype], err)
    T, B, H = 100, 32, HIDDEN
    print(f"  lstm_sequence launch at T={T} B={B} H={H}:")
    geo = geometry(torch, fl, B, H, False)
    a = kernel_inputs(torch, gen, torch.float32, T, B, H, True)
    times = {}
    for v in fl.VARIANTS:
        times[v] = {"call": cuda_ms(torch, lambda: fl.lstm_sequence_forward(*a, variant=v)),
                    "device": device_by_kernel(torch, lambda: fl.lstm_sequence_forward(
                        *a, variant=v))}
    call = {"kernel": times["cluster"]["call"], "grid": times["grid"]["call"],
            "plain": cuda_ms(torch, lambda: fl.lstm_sequence_forward_reference(*a), reps=3)}
    dev = {"kernel": sum(times["cluster"]["device"].values()) or None,
           "grid": sum(times["grid"]["device"].values()) or None,
           "plain": device_ms(torch, lambda: fl.lstm_sequence_forward_reference(*a), reps=3)}
    nin = sum(t.numel() for t in a)
    nout = 3 * T * B * H + T * B * 4 * H + B * H
    b_ms, b_by = bound(4 * (nin + nout), 2.0 * T * B * H * 4 * H)
    # the library yardstick computes the same function without peepholes
    # (input weights = identity on the 4H projections: cuDNN also runs that
    # [T*B, 4H] x [4H, 4H] product, ~4.1 GFLOP at T=100, which the kernel
    # leaves to the layer outside)
    z = [torch.zeros(H, device="cuda") for _ in range(3)]
    lstm = torch.nn.LSTM(4 * H, H).cuda()
    with torch.no_grad():
        lstm.weight_ih_l0.copy_(torch.eye(4 * H, device="cuda"))
        lstm.weight_hh_l0.copy_(a[1].t())
        lstm.bias_ih_l0.zero_()
        lstm.bias_hh_l0.zero_()
    hc = (a[5][None], a[6][None])

    def lib():
        with torch.no_grad():
            return lstm(a[0], hc)[0]

    ker_out = fl.lstm_sequence_forward(a[0], a[1], *z, a[5], a[6])[0]
    call["library"] = cuda_ms(torch, lib)
    dev["library"] = device_ms(torch, lib)
    lib_diff = (lib() - ker_out).abs().max().item()
    ms = {k: dev[k] if dev[k] is not None else call[k] for k in call}
    source = "profiler" if dev["kernel"] is not None else "events"
    print(f"  lstm_sequence T={T} B={B} f32: device time per call ({source}) cluster "
          f"{ms['kernel']:.5f} ms = {1e3 * ms['kernel'] / T:.3f} us/step, grid "
          f"{ms['grid']:.5f} ms = {1e3 * ms['grid'] / T:.3f} us/step, plain "
          f"{ms['plain']:.5f} ms, library (cuDNN nn.LSTM) {ms['library']:.5f} ms = "
          f"{1e3 * ms['library'] / T:.3f} us/step; bound {b_ms:.5f} ms by {b_by}; "
          f"wall time per back-to-back call (events) cluster {call['kernel']:.5f} ms, "
          f"grid {call['grid']:.5f} ms, plain {call['plain']:.5f} ms, library "
          f"{call['library']:.5f} ms; library vs kernel without peepholes: max abs "
          f"{lib_diff:.2e}")
    return dict(err_f32=errs["cluster", torch.float32], err_bf16=errs["cluster", torch.bfloat16],
                err_by_variant={f"{v} {str(d)[6:]}": e for (v, d), e in errs.items()},
                ms=ms["kernel"], grid_ms=ms["grid"], us_per_step=1e3 * ms["kernel"] / T,
                plain_ms=ms["plain"], library_ms=ms["library"], ms_source=source,
                call_ms=call, bound_ms=b_ms, bound_by=b_by, variant="cluster",
                geometry=geo, device_by_kernel={v: t["device"] for v, t in times.items()},
                shape={"T": T, "B": B, "H": H})


def backward_inputs(torch, fl, gen, dtype, T, B, H, peephole):
    """(forward inputs, backward inputs): the forward kernel's stashes of
    random inputs plus random cotangents dy, dcF."""
    a = kernel_inputs(torch, gen, dtype, T, B, H, peephole)
    _, acts, hprev, cprev, _ = fl.lstm_sequence_forward(*a)
    dy = torch.randn(T, B, H, generator=gen).to(dtype).cuda()
    dcF = torch.randn(B, H, generator=gen).to(dtype).cuda()
    return a, [acts, hprev, cprev, *a[1:5], dy, dcF]


def compare_backward(torch, outs, refs, dtype, T, B):
    """compare() for the seven backward outputs: (dxg, drw, dpi, dpf, dpo,
    dh0, dc0); the four sums get the sqrt(T*B) f32 tolerance."""
    err, ok = 0.0, True
    for i, (o, r) in enumerate(zip(outs, refs)):
        o, r = o.float(), r.float()
        check(bool(torch.isfinite(o).all()), "kernel output is not finite")
        d = (o - r).abs()
        err = max(err, d.max().item())
        if dtype == torch.float32:
            tol = F32_ATOL * (math.sqrt(T * B) if 1 <= i <= 4 else 1.0)
            ok &= bool((d <= tol).all())
        else:
            ok &= bool((d <= BF16_ULP * r.abs().clamp_min(1.0)).all())
    return err, ok


def backward_phase(torch, fl, seed):
    """K3 against its plain version at BWD_SHAPES on each variant, f32 and
    bf16, with and without peepholes, on the forward kernel's stashes; two
    launches bit-equal; then both variants' times at the training segment
    (T=50, B=32, H=200), the cluster variant's by kernel (the chain, the
    dRW partials, their sums)."""
    gen = torch.Generator().manual_seed(seed + 7)
    errs = {(v, d): 0.0 for v in fl.VARIANTS for d in (torch.float32, torch.bfloat16)}
    for dtype in (torch.float32, torch.bfloat16):
        for T, B, H in BWD_SHAPES:
            for v in lstm_variants(torch, fl, B, H, True):
                for peep in (True, False):
                    _, b = backward_inputs(torch, fl, gen, dtype, T, B, H, peep)
                    outs = fl.lstm_sequence_backward(*b, variant=v)
                    again = fl.lstm_sequence_backward(*b, variant=v)
                    torch.cuda.synchronize()
                    refs = fl.lstm_sequence_backward_reference(*b)
                    err, ok = compare_backward(torch, outs, refs, dtype, T, B)
                    same = all(torch.equal(x, y) for x, y in zip(outs, again))
                    print(f"  lstm_sequence_backward {v} {str(dtype)[6:]} T={T} B={B} "
                          f"H={H} peepholes={peep}: max abs {err:.3e} "
                          f"{'ok' if ok else 'OUT OF TOLERANCE'}; two launches "
                          f"{'bit-equal' if same else 'DIFFER'}")
                    check(ok, f"lstm_sequence_backward ({v}) disagrees with its plain "
                              f"version ({dtype}, T={T}, B={B}, H={H}, peepholes={peep})")
                    check(same, f"lstm_sequence_backward ({v}): two launches differ "
                                f"({dtype}, T={T}, B={B}, H={H})")
                    errs[v, dtype] = max(errs[v, dtype], err)
    T, B, H = TBPTT, 32, HIDDEN
    print(f"  lstm_sequence_backward launch at T={T} B={B} H={H}:")
    geo = geometry(torch, fl, B, H, True)
    a, b = backward_inputs(torch, fl, gen, torch.float32, T, B, H, True)
    times = {}
    for v in fl.VARIANTS:
        times[v] = {"call": cuda_ms(torch, lambda: fl.lstm_sequence_backward(*b, variant=v)),
                    "device": device_by_kernel(torch, lambda: fl.lstm_sequence_backward(
                        *b, variant=v))}
    call = {"kernel": times["cluster"]["call"], "grid": times["grid"]["call"],
            "plain": cuda_ms(torch, lambda: fl.lstm_sequence_backward_reference(*b),
                             reps=3)}
    dev = {"kernel": sum(times["cluster"]["device"].values()) or None,
           "grid": sum(times["grid"]["device"].values()) or None,
           "plain": device_ms(torch, lambda: fl.lstm_sequence_backward_reference(*b),
                              reps=3)}
    nin = sum(t.numel() for t in b)
    nout = T * B * 4 * H + H * 4 * H + 3 * H + 2 * B * H
    # dRW += hprev^T . dpre and dh = dpre . RW^T: 2 FLOP per term each
    b_ms, b_by = bound(4 * (nin + nout), 4.0 * T * B * H * 4 * H)
    # library yardstick, an approximation: cuDNN's LSTM backward at the
    # same shape without peepholes (input weights = identity on the 4H
    # projections, so it also runs the dx and input-weight gradient
    # products, ~4.1 GFLOP at T=50, which the kernel leaves to autograd
    # outside), timed as (forward + backward) - forward, with TF32 off
    lstm = torch.nn.LSTM(4 * H, H).cuda()
    with torch.no_grad():
        lstm.weight_ih_l0.copy_(torch.eye(4 * H, device="cuda"))
        lstm.weight_hh_l0.copy_(a[1].t())
        lstm.bias_ih_l0.zero_()
        lstm.bias_hh_l0.zero_()
    x = a[0].clone().requires_grad_()
    hc = (a[5][None], a[6][None])
    dy = b[7]

    def lib_fwd():
        return lstm(x, hc)[0]

    def lib_fwd_bwd():
        lstm(x, hc)[0].backward(dy)

    fb, f = device_ms(torch, lib_fwd_bwd), device_ms(torch, lib_fwd)
    dev["library"] = None if fb is None or f is None else fb - f
    call["library"] = cuda_ms(torch, lib_fwd_bwd) - cuda_ms(torch, lib_fwd)
    ms = {k: dev[k] if dev[k] is not None else call[k] for k in call}
    source = "profiler" if dev["kernel"] is not None else "events"
    parts = ", ".join(f"{n} {t:.5f}" for n, t in times["cluster"]["device"].items())
    print(f"  lstm_sequence_backward T={T} B={B} f32: device time per call ({source}) "
          f"cluster {ms['kernel']:.5f} ms ({parts}), chain "
          f"{1e3 * times['cluster']['device'].get('lstm_sequence_bwd_cluster_kernel', 0.0) / T:.3f}"
          f" us/step; grid {ms['grid']:.5f} ms = {1e3 * ms['grid'] / T:.3f} us/step; plain "
          f"{ms['plain']:.5f} ms, library (cuDNN fwd+bwd - fwd, approximate) "
          f"{ms['library']:.5f} ms = {1e3 * ms['library'] / T:.3f} us/step; bound "
          f"{b_ms:.5f} ms by {b_by}; wall time per back-to-back call (events) cluster "
          f"{call['kernel']:.5f} ms, grid {call['grid']:.5f} ms, plain {call['plain']:.5f} "
          f"ms, library {call['library']:.5f} ms")
    return dict(err_f32=errs["cluster", torch.float32], err_bf16=errs["cluster", torch.bfloat16],
                err_by_variant={f"{v} {str(d)[6:]}": e for (v, d), e in errs.items()},
                ms=ms["kernel"], grid_ms=ms["grid"], us_per_step=1e3 * ms["kernel"] / T,
                plain_ms=ms["plain"], library_ms=ms["library"], ms_source=source,
                call_ms=call, bound_ms=b_ms, bound_by=b_by, variant="cluster",
                geometry=geo, device_by_kernel={v: t["device"] for v, t in times.items()},
                shape={"T": T, "B": B, "H": H})


# -- phase 2, conv/BN: K4-K8 at ResNet-50's widths ------------------------------

RESNET_BATCH = 128
# Conv cases as (name, x shape, (kh, kw, Cin, Cout), stride): ResNet-50's
# largest instance of every conv family at batch 128, and its deepest 1x1
# (small M, deep K); then small shapes that reach each producer of the
# tensor-core engine (conv_bn.cuh) and each edge of its tiles.
CONV_CASES = [
    ("1x1/s1 64->256 at 56", (RESNET_BATCH, 56, 56, 64), (1, 1, 64, 256), 1),
    ("1x1/s2 256->512 at 56", (RESNET_BATCH, 56, 56, 256), (1, 1, 256, 512), 2),
    ("1x1 512->2048 at 7", (RESNET_BATCH, 7, 7, 512), (1, 1, 512, 2048), 1),
    ("3x3/s1 64->64 at 56", (RESNET_BATCH, 56, 56, 64), (3, 3, 64, 64), 1),
    ("3x3/s2 128->128 at 56", (RESNET_BATCH, 56, 56, 128), (3, 3, 128, 128), 2),
    ("7x7/s2 3->64 at 224", (RESNET_BATCH, 224, 224, 3), (7, 7, 3, 64), 2),
    # gather producer (Cin 37), ragged N (70)
    ("1x1 ragged", (3, 7, 11, 37), (1, 1, 37, 70), 1),
    # vector, BN 64, M = 221 (not a multiple of 128)
    ("1x1 64->64 ragged M", (1, 13, 17, 64), (1, 1, 64, 64), 1),
    # vector, BN 128, the second column tile 72 wide
    ("1x1 64->200 ragged tile", (2, 9, 11, 64), (1, 1, 64, 200), 1),
    # vector, Cin 24: a 64-deep slice straddles taps
    ("3x3 24->40 straddle", (3, 13, 10, 24), (3, 3, 24, 40), 1),
    # gather (Cin 19), ragged N (33), odd H and W: the high-side pad
    ("3x3/s2 ragged", (3, 11, 13, 19), (3, 3, 19, 33), 2),
    # vector at stride 2 on odd H and W, BN 128
    ("3x3/s2 64->128 odd", (2, 15, 17, 64), (3, 3, 64, 128), 2),
    # the stem's gather on odd H and W
    ("7x7/s2 3->64 odd", (2, 33, 29, 3), (7, 7, 3, 64), 2),
]
# Cases timed in bf16; the first of each kernel is its row in the kernels line.
TIMED_CONVS = ("3x3/s1 64->64 at 56", "7x7/s2 3->64 at 224", "3x3/s2 128->128 at 56",
               "1x1/s1 64->256 at 56", "1x1/s2 256->512 at 56", "1x1 512->2048 at 7")
# BN passes: [M, C] of the stem BN (the largest with ReLU), of the
# 1x1 64->256 BN at 56x56, and a ragged shape
BN_CASES = [("stem 112x112x64", RESNET_BATCH * 112 * 112, 64),
            ("56x56x256", RESNET_BATCH * 56 * 56, 256), ("ragged", 1003, 37)]


def valid_taps(n: int, k: int, s: int, pad_lo: int) -> int:
    """Sum over output positions of the kernel taps that land inside an
    input of size n: the multiply-adds a SAME conv really needs per
    (row or column) dimension."""
    out = -(-n // s)
    return sum(sum(1 for a in range(k) if 0 <= o * s + a - pad_lo < n)
               for o in range(out))


# Per-channel sums held to their exact (f64) value at SUMS_RTOL*sqrt(M) of
# the largest |sum|: an f32 sum of M values in any order, its rounding
# errors (unit roundoff 6e-8) growing like sqrt(M).
SUMS_RTOL = 1e-7


def sums_rel_err(torch, sums, rows):
    """Largest |sum - exact| over the largest |exact|, for each (kernel
    sum [C], f64 rows [M, C]) pair whose exact column sum is taken."""
    out = []
    for s_, r_ in zip(sums, rows):
        e = r_.sum(0)
        out.append(((s_.double() - e).abs().max() / e.abs().max().clamp_min(1e-300)).item())
    return max(out)


def conv_close(torch, outs, refs, unrounded, dtype, K, M):
    """y against the plain version: f32 F32_ATOL*sqrt(K) (a sum of K
    products in another order), bf16 one rounding step. s1, s2 against the
    exact sums of the kernel's own stored y, at SUMS_RTOL*sqrt(M). In bf16
    the sums of the unrounded f32 y (`unrounded` [M, C], the plain
    version's product before it rounds) must stand further from those
    exact sums than the tolerance, so that the check tells a kernel that
    sums the stored y from one that sums before rounding. Returns (max abs
    error of y, relative error of s1/s2, the unrounded sums' distance in
    units of the tolerance or None in f32, within tolerance)."""
    y, s1, s2 = outs
    ry = refs[0]
    check(bool(torch.isfinite(y.float()).all()), "conv kernel output is not finite")
    d = (y.float() - ry.float()).abs()
    if dtype == torch.float32:
        ok = bool((d <= F32_ATOL * math.sqrt(K)).all())
    else:
        ok = bool((d <= BF16_ULP * ry.float().abs().clamp_min(1.0)).all())
    tol = SUMS_RTOL * math.sqrt(M)
    yd = y.double().reshape(-1, y.shape[-1])
    rel = sums_rel_err(torch, (s1, s2), (yd, yd * yd))
    ok &= rel <= tol
    gap = None
    if unrounded is not None:
        ud = unrounded.double()
        e1, e2 = yd.sum(0), (yd * yd).sum(0)
        gap = max(((ud.sum(0) - e1).abs().max() / e1.abs().max()).item(),
                  ((ud * ud).sum(0) - e2).abs().max().item() / e2.abs().max().item()) / tol
        ok &= gap > 1.0
    return d.max().item(), rel, gap, ok


def conv_bn_kernel_phase(torch, F, fcb, seed):
    """K4-K8 against their plain versions on the card at ResNet-50's
    shapes, f32 and bf16, then their device times in bf16 (the training
    dtype) beside the plain version, one library call and the bound."""
    gen = torch.Generator(device="cuda").manual_seed(seed + 30)

    def rnd(shape, dtype, scale=1.0, shift=0.0):
        return (torch.randn(shape, generator=gen, device="cuda") * scale + shift).to(dtype)

    rows = {k: dict(err_f32=0.0, err_bf16=0.0) for k in
            ("conv1x1_stats", "conv_kxk_stats", "bn_apply", "bn_backward_reduce",
             "bn_backward_apply")}
    timed = {}
    for dtype in (torch.float32, torch.bfloat16):
        dn = str(dtype)[6:]
        key = "err_f32" if dtype == torch.float32 else "err_bf16"
        for name, xs, ws, st in CONV_CASES:
            kh, kw, cin, cout = ws
            x = rnd(xs, dtype)
            w = rnd(ws, dtype, scale=(kh * kw * cin) ** -0.5)
            if kh == 1:
                x2 = x[:, ::st, ::st, :].contiguous().reshape(-1, cin)
                args, fn, ref, kname = (x2, w.reshape(cin, cout)), fcb.conv1x1_stats, \
                    fcb.conv1x1_stats_reference, "conv1x1_stats"
                M = x2.shape[0]
            else:
                args, fn, ref, kname = (x, w, (st, st)), fcb.conv_kxk_stats, \
                    fcb.conv_kxk_stats_reference, "conv_kxk_stats"
                M = xs[0] * (-(-xs[1] // st)) * (-(-xs[2] // st))
            outs = fn(*args)
            torch.cuda.synchronize()
            refs = ref(*args)
            unrounded = None
            if dtype == torch.bfloat16:
                if kh == 1:
                    unrounded = args[0].float() @ args[1].float()
                else:
                    pads = (fcb.same_pads(xs[1], kh, st)[1:], fcb.same_pads(xs[2], kw, st)[1:])
                    unrounded = fcb.conv2d_nhwc(x.float(), w.float(), (st, st), pads)
                unrounded = unrounded.reshape(-1, cout)
            err, rel, gap, ok = conv_close(torch, outs, refs, unrounded, dtype,
                                           kh * kw * cin, M)
            print(f"  {kname} {dn} {name}: max |y - plain| {err:.3e}, s1/s2 vs the "
                  f"exact sums of the stored y: relative {rel:.3e} (tolerance "
                  f"{SUMS_RTOL * math.sqrt(M):.2e})"
                  + ("" if gap is None else f"; sums of the unrounded y stand "
                     f"{gap:.1f}x the tolerance off")
                  + f" {'ok' if ok else 'OUT OF TOLERANCE'}")
            check(ok, f"{kname} disagrees with its plain version ({dn}, {name})")
            rows[kname][key] = max(rows[kname][key], err)
            rows[kname]["stats_rel_err"] = max(rows[kname].get("stats_rel_err", 0.0), rel)
            if gap is not None:
                rows[kname]["unrounded_gap_min"] = min(
                    rows[kname].get("unrounded_gap_min", math.inf), gap)
            if dtype == torch.bfloat16 and name in TIMED_CONVS:
                timed[name] = (kname, args, x, w, st)
            del x, w, outs, refs, unrounded
        for name, M, C in BN_CASES:
            x2 = rnd((M, C), dtype, shift=0.3)
            g2 = rnd((M, C), dtype)
            v = [rnd((C,), torch.float32, scale=0.5, shift=1.0) for _ in range(3)]
            step = F32_ATOL if dtype == torch.float32 else None

            def close1(o, r):
                d = (o.float() - r.float()).abs()
                tol = step if step is not None else BF16_ULP * r.float().abs().clamp_min(1.0)
                return d.max().item(), bool((d <= tol).all())

            checks = []
            for relu in (False, True):
                checks.append(("bn_apply", *close1(fcb.bn_normalize(x2, *v, relu),
                                                   fcb.bn_normalize_reference(x2, *v, relu))))
            sums = fcb.bn_backward_reduce(g2, x2)
            rsum = fcb.bn_backward_reduce_reference(g2, x2)
            gd = g2.double()
            rel = sums_rel_err(torch, sums, (gd, gd * x2.double()))
            del gd
            rows["bn_backward_reduce"]["stats_rel_err"] = max(
                rows["bn_backward_reduce"].get("stats_rel_err", 0.0), rel)
            checks.append(("bn_backward_reduce",
                           max((a - b).abs().max().item() for a, b in zip(sums, rsum)),
                           rel <= SUMS_RTOL * math.sqrt(M)))
            checks.append(("bn_backward_apply", *close1(fcb.bn_backward_apply(g2, x2, *v),
                                                        fcb.bn_backward_apply_reference(g2, x2, *v))))
            # the pullback's prologue (the ReLU gate from the saved output
            # y and the centring x - mean_b on K7's and K8's loads): the
            # same bits as K7 and K8 fed the materialised tensors, K7's
            # sums at SUMS_RTOL*sqrt(M) of the exact sums of those
            # tensors, K8 against its plain version as above
            y2 = rnd((M, C), dtype)
            mb = rnd((C,), dtype, scale=0.2, shift=0.3).float()
            pro = {"gate_y2": y2, "mean_b": mb}
            g_m = torch.where(y2 > 0, g2, torch.zeros_like(g2))
            x_m = x2 - mb.to(dtype)
            s_pro, s_mat = fcb.bn_backward_reduce(g2, x2, **pro), fcb.bn_backward_reduce(g_m, x_m)
            d_pro = fcb.bn_backward_apply(g2, x2, *v, **pro)
            d_mat = fcb.bn_backward_apply(g_m, x_m, *v)
            same = (all(torch.equal(a, b) for a, b in zip(s_pro, s_mat))
                    and torch.equal(d_pro, d_mat))
            gd = g_m.double()
            rel = sums_rel_err(torch, s_pro, (gd, gd * x_m.double()))
            del gd, g_m, x_m, s_mat, d_mat
            rows["bn_backward_reduce"]["stats_rel_err"] = max(
                rows["bn_backward_reduce"]["stats_rel_err"], rel)
            rsum = fcb.bn_backward_reduce_reference(g2, x2, **pro)
            checks.append(("bn_backward_reduce with gate and centring (bit-equal to the "
                           "materialised inputs)",
                           max((a - b).abs().max().item() for a, b in zip(s_pro, rsum)),
                           same and rel <= SUMS_RTOL * math.sqrt(M)))
            err, ok = close1(d_pro, fcb.bn_backward_apply_reference(g2, x2, *v, **pro))
            checks.append(("bn_backward_apply with gate and centring (bit-equal to the "
                           "materialised inputs)", err, ok and same))
            del d_pro
            torch.cuda.synchronize()
            for kname, err, ok in checks:
                print(f"  {kname} {dn} [{M}, {C}] ({name}): max err {err:.3e} "
                      f"{'ok' if ok else 'OUT OF TOLERANCE'}")
                check(ok, f"{kname} disagrees with its plain version ({dn}, {name})")
                kname = kname.split(" ")[0]
                rows[kname][key] = max(rows[kname][key], err)
            if dtype == torch.bfloat16 and name == "56x56x256":
                timed["bn"] = (name, x2, g2, v, mb)
            elif dtype == torch.bfloat16 and name.startswith("stem"):
                timed["stem"] = (x2, g2, y2, mb, v)
            else:
                del x2, g2, y2

    # device times, bf16, at the timed shapes
    bf = torch.bfloat16
    for name in TIMED_CONVS:
        kname, args, x, w, st = timed.pop(name)
        kh, kw, cin, cout = w.shape
        fn = fcb.conv1x1_stats if kname == "conv1x1_stats" else fcb.conv_kxk_stats
        ref = (fcb.conv1x1_stats_reference if kname == "conv1x1_stats"
               else fcb.conv_kxk_stats_reference)
        n, h, wd, _ = x.shape
        ho, ph, _ = fcb.same_pads(h, kh, st)
        wo, pw, _ = fcb.same_pads(wd, kw, st)
        if kh == 1:
            # K4 takes the subsampled rows; the library gets the same input
            xin = args[0].reshape(n, ho, wo, cin)
            lib_x, lib_s, lib_p = xin.permute(0, 3, 1, 2), 1, 0
            taps = ho * wo
        else:
            # cuDNN pads symmetrically: with SAME's low pad, a stride-2 conv
            # whose odd pixel SAME puts on the high side loses its last
            # output row and column there (111x111 of 112x112 at the stem)
            xin = x
            lib_x, lib_s, lib_p = x.permute(0, 3, 1, 2), st, (ph, pw)
            taps = valid_taps(h, kh, st, ph) * valid_taps(wd, kw, st, pw)
        wn = w.permute(3, 2, 0, 1)
        ms = {"kernel": device_ms(torch, lambda: fn(*args)),
              "plain": device_ms(torch, lambda: ref(*args), reps=3),
              "library": device_ms(torch, lambda: F.conv2d(lib_x, wn, stride=lib_s,
                                                           padding=lib_p))}
        flops = 2.0 * n * taps * cin * cout
        nbytes = 2 * (xin.numel() + w.numel() + n * ho * wo * cout) + 8 * cout
        row = bound_and_times(ms, nbytes, flops, name)
        row["variant"] = fcb.conv_variant((kh, kw), cin, cout, bf, *args[:2])
        rows[kname].setdefault("shapes", []).append(row)
        if len(rows[kname]["shapes"]) == 1:
            rows[kname].update({k: v for k, v in row.items() if k != "variant"})
        print(f"  {kname} bf16 {name} ({row['variant']['producer']}, BN "
              f"{row['variant']['bn']}, {row['variant']['stages']} stages): device ms kernel "
              f"{ms['kernel']:.4f}, plain {opt(ms['plain'])}, library F.conv2d (cuDNN, the "
              f"conv alone, no statistics) {opt(ms['library'])}; bound {row['bound_ms']:.4f} ms "
              f"by {row['bound_by']}; kernel / library "
              f"{opt(ms['library'] and ms['kernel'] / ms['library'], '.2f')}")
        del args, x, w, xin, lib_x, wn
    name, x2, g2, v, mb = timed["bn"]
    M, C = x2.shape
    wb = [t.to(bf) for t in v]
    _, smean, sinv = torch.ops.aten.native_batch_norm(x2, wb[0], wb[1], None, None,
                                                      True, 0.1, 1e-5)
    # the library's own two BN-backward passes (SyncBatchNorm's): the
    # reduce gives per-channel sum g and sum g*(x - mean), K7's function;
    # the elementwise pass gives dx from those sums, K8's
    sum_dy, sum_dy_xmu, _, _ = torch.batch_norm_backward_reduce(
        g2, x2, smean, sinv, None, True, False, False)
    count = torch.tensor([M], dtype=torch.int32, device="cuda")

    per = {
        "bn_apply": (lambda: fcb.bn_normalize(x2, *v, False),
                     lambda: fcb.bn_normalize_reference(x2, *v, False),
                     lambda: F.batch_norm(x2, wb[0], wb[1].abs(), wb[2], wb[0],
                                          training=False, eps=1e-5),
                     2 * 2 * M * C + 12 * C, 3.0 * M * C),
        "bn_backward_reduce": (lambda: fcb.bn_backward_reduce(g2, x2),
                               lambda: fcb.bn_backward_reduce_reference(g2, x2),
                               lambda: torch.batch_norm_backward_reduce(
                                   g2, x2, smean, sinv, None, True, False, False),
                               2 * 2 * M * C + 8 * C, 3.0 * M * C),
        "bn_backward_apply": (lambda: fcb.bn_backward_apply(g2, x2, *v),
                              lambda: fcb.bn_backward_apply_reference(g2, x2, *v),
                              lambda: torch.batch_norm_backward_elemt(
                                  g2, x2, smean, sinv, v[0], sum_dy, sum_dy_xmu, count),
                              3 * 2 * M * C + 12 * C, 4.0 * M * C),
    }
    for kname, (kern, plain, lib, nbytes, flops) in per.items():
        ms = {"kernel": device_ms(torch, kern), "plain": device_ms(torch, plain, reps=3),
              "library": device_ms(torch, lib)}
        rows[kname].update(bound_and_times(ms, nbytes, flops, f"[{M}, {C}]"))
        print(f"  {kname} bf16 [{M}, {C}]: device ms kernel {ms['kernel']:.4f}, plain "
              f"{opt(ms['plain'])}, library {LIBRARY_NOTE[kname]} {opt(ms['library'])}; "
              f"bound {rows[kname]['bound_ms']:.4f} ms by {rows[kname]['bound_by']}")
    # beside them, the library's whole BN backward in one call (both passes)
    both = device_ms(torch, lambda: torch.ops.aten.native_batch_norm_backward(
        g2, x2, wb[0], None, None, smean, sinv, True, 1e-5, [True, True, True]))
    rows["bn_backward_apply"]["library_both_passes_ms"] = both
    print(f"  K7 + K8 {rows['bn_backward_reduce']['ms'] + rows['bn_backward_apply']['ms']:.4f} "
          f"ms beside aten.native_batch_norm_backward (both passes in one call) {opt(both)} ms")
    # the prologue at the main path's calls: every bf16 BN pullback centres
    # on its loads (a layer without ReLU: K8 centred at [401408, 256], the
    # function batch_norm_backward_elemt computes), and the 33 with ReLU
    # also gate, timed at the largest of them, the stem's [1605632, 64]
    xs, gs, ys, mbs, vs = timed.pop("stem")
    Ms, Cs = xs.shape
    prologue = [
        ("bn_backward_apply", f"centred [{M}, {C}]",
         lambda: fcb.bn_backward_apply(g2, x2, *v, mean_b=mb), 3 * 2 * M * C + 16 * C,
         4.0 * M * C),
        ("bn_backward_reduce", f"gated and centred [{Ms}, {Cs}]",
         lambda: fcb.bn_backward_reduce(gs, xs, gate_y2=ys, mean_b=mbs),
         3 * 2 * Ms * Cs + 12 * Cs, 5.0 * Ms * Cs),
        ("bn_backward_apply", f"gated and centred [{Ms}, {Cs}]",
         lambda: fcb.bn_backward_apply(gs, xs, *vs, gate_y2=ys, mean_b=mbs),
         4 * 2 * Ms * Cs + 16 * Cs, 6.0 * Ms * Cs),
        ("bn_apply", f"relu [{Ms}, {Cs}]", lambda: fcb.bn_normalize(xs, *vs, True),
         2 * 2 * Ms * Cs + 12 * Cs, 4.0 * Ms * Cs)]
    for kname, what, fn, nbytes, flops in prologue:
        ms = device_ms(torch, fn)
        check(ms is not None, f"the profiler saw no device time for {kname} {what}")
        b_ms, b_by = bound(nbytes, flops, BF16_FLOP_PER_S)
        rows[kname].setdefault("prologue", {})[what] = {
            "ms": ms, "bound_ms": b_ms, "bound_by": b_by, "of_bound": b_ms / ms}
        print(f"  {kname} bf16 {what}: device ms {ms:.4f}; bound {b_ms:.4f} ms by "
              f"{b_by} ({100 * b_ms / ms:.1f}% of it)")
    sweep = stream_sweep(torch, fcb, [
        (f"[{M}, {C}]", x2, v, False, g2, None, None),
        (f"[{Ms}, {Cs}], K6 with ReLU, K8 gated and centred", xs, vs, True, gs, mbs, ys)])
    del xs, gs, ys
    for kname, by_variant in sweep.items():
        rows[kname]["sweep"] = by_variant
    return rows


# The streaming layout's compile-time knobs (csrc/bn_stream.cuh), each
# built into a library of its own: row-passes per unrolled group
# (BN_UNROLL, 4 shipped) and the grid (BN_GRID: 1 = one block per row
# group, shipped; 0 = a persistent grid of the blocks resident at once).
BN_SWEEP = [(("BN_GRID", 0),), (("BN_GRID", 0), ("BN_UNROLL", 8)), (("BN_UNROLL", 1),),
            (("BN_UNROLL", 2),), (("BN_UNROLL", 8),)]


def stream_sweep(torch, fcb, cases):
    """K6 and K8 in bf16 for each variant of BN_SWEEP and the shipped
    build, called through their C entries on the same inputs: device ms
    each (torch.profiler), and every variant's output bit-equal to the
    shipped kernel's (the knobs change the schedule, not the arithmetic).
    A case is (label, x, [scale-like vectors], relu, g, mean_b or None,
    gate y or None): K6 on x with ReLU as given, K8 with the prologue
    given."""
    from deeplearning4j_tpu_torch.ops import cuda_build

    stream = torch.cuda.current_stream().cuda_stream
    p = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    res = {"bn_apply": {}, "bn_backward_apply": {}}
    for label, x, v, relu, g, mb, gy in cases:
        M, C = x.shape
        ref = {"bn_apply": fcb.bn_normalize(x, *v, relu),
               "bn_backward_apply": fcb.bn_backward_apply(g, x, *v, mean_b=mb, gate_y2=gy)}
        out = {k: torch.empty_like(t) for k, t in ref.items()}
        for defines in [()] + BN_SWEEP:
            tag = (", ".join(f"{k}={d}" for k, d in defines)
                   or "shipped (BN_UNROLL=4, BN_GRID=1)")
            libs = {n: (cuda_build.variant_library(n, defines) if defines
                        else cuda_build.library(n)) for n in ("bn_apply", "bn_backward")}
            k6 = cuda_build.entry_of(libs["bn_apply"], "bn_apply", 5, 4)
            k8 = cuda_build.entry_of(libs["bn_backward"], "bn_backward_apply", 8, 3)
            calls = {
                "bn_apply": lambda: k6(1, p(x), *(p(t) for t in v), p(out["bn_apply"]), M, C,
                                       int(relu), 1, stream),
                "bn_backward_apply": lambda: k8(1, p(g), p(x), p(mb), p(gy), *(p(t) for t in v),
                                                p(out["bn_backward_apply"]), M, C, 1, stream)}
            for kname, call in calls.items():
                check(call() == 0, f"{kname} ({tag}) did not launch")
                torch.cuda.synchronize()
                check(torch.equal(out[kname], ref[kname]),
                      f"{kname} ({tag}) differs from the shipped kernel at {label}")
                res[kname].setdefault(label, {})[tag] = device_ms(torch, call)
        for kname, by in res.items():
            print(f"  {kname} bf16 {label} sweep, device ms: "
                  + "; ".join(f"{t} {opt(ms)}" for t, ms in by[label].items()))
    return res


LIBRARY_NOTE = {
    "bn_apply": "F.batch_norm(training=False), bf16 params",
    "bn_backward_reduce": "torch.batch_norm_backward_reduce (sum g, sum g*(x - mean))",
    "bn_backward_apply": "torch.batch_norm_backward_elemt (dx from the sums)",
}


def bound_and_times(ms, nbytes, flops, shape):
    """A bf16 kernel's row: its times and its bound at the bf16 peak."""
    check(ms["kernel"] is not None, "the profiler saw no device time for a kernel")
    b_ms, b_by = bound(nbytes, flops, BF16_FLOP_PER_S)
    return dict(ms=ms["kernel"], plain_ms=ms["plain"], library_ms=ms["library"],
                ms_source="profiler", bound_ms=b_ms, bound_by=b_by,
                shape={"at": shape, "dtype": "bf16"})


# -- phase 3: slice -----------------------------------------------------------


def slice_phase(torch, fl, helpers, net, seed):
    rng = np.random.default_rng(seed)
    x = np.eye(VOCAB, dtype=np.float32)[rng.integers(0, VOCAB, (32, 100))]
    fl.reset_launch_counts()
    out = net.output(x)
    torch.cuda.synchronize()
    launches = fl.launch_counts()
    check(tuple(out.shape) == (32, 100, VOCAB), f"output shape {tuple(out.shape)}")
    check(bool(torch.isfinite(out).all()), "output() is not finite")
    check(bool(((out.sum(-1) - 1).abs() < 1e-4).all()), "softmax rows do not sum to 1")
    check(launches["lstm_sequence"] >= 1,
          f"output() did not launch the sequence kernel: {launches}")
    for op in ("lstm_sequence", "lstm_decode_step"):
        helpers.set_helper_enabled(op, False)
    try:
        plain = net.output(x)
        torch.cuda.synchronize()
    finally:
        for op in ("lstm_sequence", "lstm_decode_step"):
            helpers.set_helper_enabled(op, True)
    err = (out - plain).abs().max().item()
    print(f"  output() [32, 100, {VOCAB}] vs helpers off: max abs {err:.3e} "
          f"(tolerance {SLICE_ATOL}); launches {launches}")
    check(err <= SLICE_ATOL, f"output() differs from the plain path by {err}")
    return {"max_abs_err": err, "launches": launches}


# -- phase 4: serve -----------------------------------------------------------


def greedy_reference(torch, net, prompt, max_new):
    """The sequential loop: one request at a time, one token per
    rnn_time_step call at batch 1."""
    net.clear_rnn_state()
    eye = np.eye(VOCAB, dtype=np.float32)
    out = None
    for t in prompt:
        out = net.rnn_time_step(eye[[t]])
    toks = []
    while len(toks) < max_new:
        g = int(torch.argmax(out[0]).item())
        toks.append(g)
        out = net.rnn_time_step(eye[[g]])
    net.clear_rnn_state()
    return toks


def decode_hits(metrics) -> float:
    """helper_hit_total{op="lstm_decode_step"}, all labels summed."""
    fam = metrics.get_registry().get("helper_hit_total")
    return 0.0 if fam is None else sum(c.value for labels, c in fam.children()
                                       if labels[0] == "lstm_decode_step")


def serve(torch, DecodeEngine, metrics, net, waves, v2, fused, prof=None):
    """Both waves through one engine, the weight swap between them, after
    the engine's warm-up (its graph captures, timed apart). Returns
    (tokens per request, stats). With `prof`, a torch.profiler over the
    serving part."""
    metrics.get_registry().unregister("decode_step_seconds")
    eng = DecodeEngine(net, n_slots=8, tenant_weights={"a": 3.0, "b": 1.0},
                       component_prefix=f"smoke_k{fused}")
    eng.set_fused_steps(fused)
    try:
        outs = []
        t0 = time.perf_counter()
        eng.warmup()  # the two captures, each after one eager run
        t_capture = time.perf_counter() - t0
        if prof is not None:
            prof.start()
        t0 = time.perf_counter()
        for w, wave in enumerate(waves):
            if w == 1:
                v = eng.load_version(v2)
            futs = [eng.generate(p, max_new_tokens=m, tenant=t)
                    for p, m, t in wave]
            outs += [f.result(timeout=300) for f in futs]
        wall = time.perf_counter() - t0
        if prof is not None:
            torch.cuda.synchronize()
            prof.stop()
        m = eng.metrics()
    finally:
        eng.shutdown()
    n = sum(len(w) for w in waves)
    check(m["conservation_ok"] and m["completed"] == n and m["shed"] == 0
          and m["failed"] == 0, f"books do not conserve: {m['tenants']}")
    check(m["swaps"] == 1 and m["version"] == v, f"weight swap not served: {m}")
    check(m["program_cache_size"] == 2, f"step functions rebuilt: {m}")
    check(m["captures"] == {fused: 2},
          f"the engine captured {m['captures']} graphs, not one per parameter set")
    hist = metrics.get_registry().get("decode_step_seconds").labels()
    stats = {"fused_steps": fused, "tokens": m["tokens"], "seconds": wall,
             "tokens_per_s": m["tokens"] / wall, "steps": m["steps"],
             "captures": m["captures"], "capture_s": t_capture,
             "step_p50_s": hist.percentile(50), "step_p99_s": hist.percentile(99),
             "tenants": {t: b["completed"] for t, b in m["tenants"].items()}}
    return outs, stats


def graph_carry_hold(torch, fl, DecodeEngine, net, K, seed, steps=6):
    """The engine's captured program replayed `steps` times, from a random
    carry, on both parameter sets in turn, against as many eager calls of
    the model's decode step on the same tokens: the carry and the tokens
    must be bit-equal. Returns the replays' launches of K2."""
    rng = np.random.default_rng(seed + 3 + K)
    n = 8
    feeds = rng.integers(0, VOCAB, size=(steps, K, n)).astype(np.int32)
    force = rng.random((steps, K, n)) < 0.5
    force[:, 0] = True
    eng = DecodeEngine(net, n_slots=n, component_prefix=f"smoke_hold_k{K}").set_fused_steps(K)
    try:
        eng.warmup()
        for st in eng._carry.values():
            for a in st.values():
                a.copy_(torch.from_numpy(rng.standard_normal(tuple(a.shape))
                                         .astype(np.float32) * 0.3))
        start = {i: {k: a.clone() for k, a in st.items()} for i, st in eng._carry.items()}
        fl.reset_launch_counts()
        got = []
        for s in range(steps):
            eng._live = s % 2  # both sets hold the model's weights
            io = eng._io[K]
            if K == 1:
                io["feed"].copy_(torch.from_numpy(feeds[s, 0]))
            else:
                io["toks"].copy_(torch.from_numpy(feeds[s]))
                io["force"].copy_(torch.from_numpy(force[s]))
            got.append(eng._run_program())
        torch.cuda.synchronize()
        launches = fl.launch_counts()["lstm_step"]
        graphed = {i: {k: a.clone() for k, a in st.items()} for i, st in eng._carry.items()}
    finally:
        eng.shutdown()
    step = net.rnn_decode_step_fn()
    ref = start
    with torch.no_grad():
        for s in range(steps):
            prev = torch.from_numpy(feeds[s, 0]).cuda()
            toks = []
            for t in range(K):
                tok = torch.where(torch.from_numpy(force[s, t]).cuda(),
                                  torch.from_numpy(feeds[s, t]).cuda(), prev)
                x = torch.nn.functional.one_hot(tok.long(), VOCAB).to(torch.float32)
                ref, out = step(net.params_list, net.state_list, ref, x)
                prev = torch.argmax(out, dim=-1).to(torch.int32)
                toks.append(prev.cpu().numpy())
            check(np.array_equal(got[s].reshape(-1, n), np.stack(toks)),
                  f"K={K}: replay {s} emitted other tokens than the eager step")
    for i in ref:
        for k in ref[i]:
            check(torch.equal(graphed[i][k], ref[i][k]),
                  f"K={K}: the graphed carry {i}/{k} differs from the eager step's bits")
    check(launches == LAYERS * K * steps,
          f"K={K}: {launches} K2 launches counted for {steps} replays")
    return launches


def serve_phase(torch, fl, DecodeEngine, metrics, net, seed, card):
    rng = np.random.default_rng(seed + 1)
    reqs = [(rng.integers(0, VOCAB, size=int(rng.integers(1, 33))).tolist(),
             int(rng.integers(32, 65)), "a" if i % 4 else "b")
            for i in range(24)]
    waves = [reqs[:12], reqs[12:]]
    v1 = net.params_list
    v2 = [{k: t * 1.01 for k, t in p.items()} for p in v1]
    fl.reset_launch_counts()
    hits0 = decode_hits(metrics)
    out1, st1 = serve(torch, DecodeEngine, metrics, net, waves, v2, 1)
    out4, st4 = serve(torch, DecodeEngine, metrics, net, waves, v2, 4)
    torch.cuda.synchronize()
    launches = fl.launch_counts()
    hits = decode_hits(metrics) - hits0
    # every step is one replay of K steps; each capture follows one eager
    # warm-up run of its program
    want = sum(LAYERS * st["fused_steps"] * (st["steps"] + sum(st["captures"].values()))
               for st in (st1, st4))
    check(launches["lstm_step"] == want and hits == want,
          f"K2 launches {launches['lstm_step']} and lstm_decode_step hits {hits} are not "
          f"the {want} that the replays and warm-ups ran")
    check(out4 == out1, "set_fused_steps(4) changed the emitted tokens")
    refs = [greedy_reference(torch, net, p, m) for p, m, _ in waves[0]]
    net.params_list = v2
    try:
        refs += [greedy_reference(torch, net, p, m) for p, m, _ in waves[1]]
    finally:
        net.params_list = v1
    bad = [i for i, (o, r) in enumerate(zip(out1, refs)) if o != r]
    check(not bad, f"engine tokens differ from the sequential loop for "
                   f"requests {bad}")
    for st in (st1, st4):
        print(f"  K={st['fused_steps']} ({st['captures'][st['fused_steps']]} graphs captured in "
              f"{st['capture_s']:.3f} s): {st['tokens']} tokens in "
              f"{st['seconds']:.3f} s = {st['tokens_per_s']:.1f} tokens/s, "
              f"{st['steps']} steps, decode_step_seconds p50 "
              f"{st['step_p50_s']:.6f} p99 {st['step_p99_s']:.6f} on {card}")
    print(f"  24 requests equal the sequential rnn_time_step loop; K2 launches {want} = "
          f"replays + warm-ups, as many lstm_decode_step hits; launches {launches}")
    hold = {f"k{K}": graph_carry_hold(torch, fl, DecodeEngine, net, K, seed) for K in (1, 4)}
    print(f"  graphed carry bit-equal to the eager step after 6 replays at K=1 and K=4, "
          f"both parameter sets; replay launches {hold}")
    # one more pass each under the profiler: the device's busy share while
    # serving (device time of everything it ran over the pass's wall time),
    # and the K2 nodes' device time inside the graph
    from torch.profiler import ProfilerActivity, profile

    prof_stats = {}
    for K, want_out in ((1, out1), (4, out4)):
        prof = profile(activities=[ProfilerActivity.CUDA])
        outp, stp = serve(torch, DecodeEngine, metrics, net, waves, v2, K, prof=prof)
        check(outp == want_out, f"the profiled K={K} pass emitted other tokens")
        busy_s = k2_s = 0.0
        k2_n = 0
        for e in prof.key_averages():
            t = getattr(e, "self_device_time_total", 0.0) / 1e6
            busy_s += t
            if "lstm_step_kernel" in e.key:
                k2_s += t
                k2_n += e.count
        busy = busy_s / stp["seconds"]
        # the profiler slows the host: the same device work over the wall
        # of the unprofiled pass at this K
        busy_free = busy_s / (st1 if K == 1 else st4)["seconds"]
        node_us = k2_s / max(k2_n, 1) * 1e6
        print(f"  K={K} under the profiler: device busy {busy_s:.4f} s of "
              f"{stp['seconds']:.3f} s wall = busy share {busy:.4f} "
              f"({busy_free:.4f} of the unprofiled pass's wall); {k2_n} K2 graph nodes, "
              f"{node_us:.3f} us each on average; {stp['tokens_per_s']:.1f} tokens/s, "
              f"step p50 {stp['step_p50_s']:.6f} p99 {stp['step_p99_s']:.6f}")
        prof_stats[f"profiled_k{K}"] = {**stp, "device_busy_s": busy_s, "busy_share": busy,
                                       "busy_share_of_unprofiled_wall": busy_free,
                                       "k2_launches": k2_n, "k2_node_us": node_us}
    return {"launches": launches, "k1": st1, "k4": st4, "carry_hold": hold, **prof_stats}


# -- phase 5: train -----------------------------------------------------------


def corpus_batches(DataSet, seed, n):
    """`n` batches of [TRAIN_B, TRAIN_T, VOCAB] one-hot windows of SURVEY.md
    and, as labels, the same windows one character on. The 76 most
    frequent characters get a symbol each and the rest share the 77th;
    the window starts come from --seed."""
    with open(os.path.join(HERE, "SURVEY.md"), encoding="utf-8") as f:
        text = f.read()
    vocab = {ch: i for i, (ch, _) in
             enumerate(collections.Counter(text).most_common(VOCAB - 1))}
    ids = np.array([vocab.get(ch, VOCAB - 1) for ch in text])
    rng = np.random.default_rng(seed + 2)
    eye = np.eye(VOCAB, dtype=np.float32)
    out = []
    for _ in range(n):
        starts = rng.integers(0, len(ids) - TRAIN_T - 1, TRAIN_B)
        w = ids[starts[:, None] + np.arange(TRAIN_T + 1)]
        out.append(DataSet(eye[w[:, :-1]], eye[w[:, 1:]]))
    return out


def segment_grads(torch, net, ds):
    """Gradients of the loss of a one-segment DataSet at the net's current
    parameters, from zero h/c: what one optimizer step of fit uses."""
    x, y = net._as_data(ds.features), net._as_data(ds.labels)
    leaves = [v for p in net.params_list for v in p.values()]
    for v in leaves:
        v.requires_grad_(True)
    try:
        states = [{} for _ in range(LAYERS)] + [None]
        score, _ = net._loss(net.params_list, states, x, y, None, None, rng=None)
        return torch.autograd.grad(score, leaves)
    finally:
        for v in leaves:
            v.requires_grad_(False)


def train_phase(torch, fl, helpers, char_lstm_network, DataSet,
                ExistingDataSetIterator, IterationListener, seed, card):
    class Scores(IterationListener):
        """Each optimizer step's score, kept as a device tensor and read
        after the fit, so the listener adds no sync."""

        def __init__(self):
            self.scores = []

        def iteration_done(self, model, iteration, info):
            self.scores.append(info["score"]())

        def values(self):
            return [float(s) for s in self.scores]

    class StepClock(Scores):
        """Scores, plus the host clock after a device sync at each step."""

        def __init__(self):
            super().__init__()
            self.times = [time.perf_counter()]

        def iteration_done(self, model, iteration, info):
            torch.cuda.synchronize()
            self.times.append(time.perf_counter())
            super().iteration_done(model, iteration, info)

    def network(**kw):
        return char_lstm_network(vocab_size=VOCAB, hidden=HIDDEN, layers=LAYERS,
                                 tbptt_length=TBPTT, seed=seed,
                                 learning_rate=TRAIN_LR, **kw)

    def fit_scores(net, ds):
        """The scores of fitting `ds`, and the kernel launches it made."""
        log, before = Scores(), fl.launch_counts()
        net.set_listeners(log).fit(ExistingDataSetIterator([ds]))
        torch.cuda.synchronize()
        return log.values(), {k: v - before[k] for k, v in fl.launch_counts().items()}

    def helpers_off(fn):
        helpers.set_helper_enabled("lstm_sequence", False)
        try:
            return fn()
        finally:
            helpers.set_helper_enabled("lstm_sequence", True)

    # the main path: fit with a listener that only keeps the scores
    batches = corpus_batches(DataSet, seed, TRAIN_BATCHES)
    steps = TRAIN_BATCHES * (TRAIN_T // TBPTT)
    net = network()
    log = Scores()
    net.set_listeners(log)
    fl.reset_launch_counts()
    t0 = time.perf_counter()
    net.fit(ExistingDataSetIterator(batches))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = fl.launch_counts()
    scores = log.values()
    check(net.iteration == steps and len(scores) == steps,
          f"fit ran {net.iteration} optimizer steps, expected {steps}")
    check(all(math.isfinite(s) for s in scores), f"non-finite score: {scores}")
    check(scores[-1] < scores[0],
          f"the score did not fall: first {scores[0]}, last {scores[-1]}")
    for k in ("lstm_sequence", "lstm_sequence_backward"):
        check(launches[k] == LAYERS * steps,
              f"{k} launched {launches[k]} times in {steps} optimizer steps, "
              f"expected {LAYERS} per step")
    tokens = TRAIN_BATCHES * TRAIN_B * TRAIN_T
    # the same batches again, timed per step: the device synced at each
    clock = StepClock()
    net.set_listeners(clock).fit(ExistingDataSetIterator(batches))
    step_s = np.diff(clock.times)
    st = {"steps": steps, "tokens": tokens, "seconds": wall,
          "tokens_per_s": tokens / wall,
          "step_p50_s": float(np.percentile(step_s, 50)),
          "step_p99_s": float(np.percentile(step_s, 99)),
          "first_score": scores[0], "last_score": scores[-1], "scores": scores}
    print(f"  fit {TRAIN_BATCHES} x [{TRAIN_B}, {TRAIN_T}, {VOCAB}], TBPTT "
          f"{TBPTT}: {steps} optimizer steps, {tokens} tokens in {wall:.3f} s "
          f"= {st['tokens_per_s']:.1f} tokens/s (no per-step sync); a second "
          f"pass, device synced each step: step p50 {st['step_p50_s']:.6f} s "
          f"p99 {st['step_p99_s']:.6f} s (host clock) on {card}")
    print(f"  score first {scores[0]:.4f} last {scores[-1]:.4f}; launches {launches}")

    # one more fit batch under the profiler: the device's busy share and
    # the device time by kernel
    from torch.profiler import ProfilerActivity, profile

    net.set_listeners()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t1 = time.perf_counter()
        net.fit(ExistingDataSetIterator(batches[:1]))
        torch.cuda.synchronize()
        wall1 = time.perf_counter() - t1
    rows = sorted(((e.key, getattr(e, "self_device_time_total", 0.0) / 1e3, e.count)
                   for e in prof.key_averages()), key=lambda r: -r[1])
    busy_ms = sum(r[1] for r in rows)
    check(busy_ms > 0, "the profiler saw no device time in the fit batch")
    st["profiled_batch"] = {
        "seconds": wall1, "device_busy_s": busy_ms / 1e3,
        "busy_share": busy_ms / 1e3 / wall1,
        "top_device_ms": [{"name": n[:80], "ms": ms, "calls": c}
                          for n, ms, c in rows[:10]]}
    print(f"  one fit batch under the profiler: device busy {busy_ms / 1e3:.4f} s "
          f"of {wall1:.3f} s wall = busy share {busy_ms / 1e3 / wall1:.4f}; "
          f"device time by kernel:")
    for n, ms, c in rows[:10]:
        print(f"    {ms:9.3f} ms {100 * ms / busy_ms:5.1f}%  x{c:<5d} {n[:70]}")
    # the main path ran the cluster variants of K1 and K3, never the grid's
    lstm_ms = {k: sum(ms for n, ms, _ in rows if f"::{k}<" in n or n.startswith(f"{k}<")
                      or f"::{k}(" in n)
               for k in ("lstm_sequence_cluster_kernel", "lstm_sequence_bwd_cluster_kernel",
                         "drw_partial_kernel", "drw_reduce_kernel", "lstm_sequence_kernel",
                         "lstm_sequence_bwd_kernel")}
    check(lstm_ms["lstm_sequence_cluster_kernel"] > 0
          and lstm_ms["lstm_sequence_bwd_cluster_kernel"] > 0,
          f"the fit did not run the cluster kernels: {lstm_ms}")
    check(lstm_ms["lstm_sequence_kernel"] == 0 and lstm_ms["lstm_sequence_bwd_kernel"] == 0,
          f"the fit ran the grid kernels: {lstm_ms}")
    k1 = lstm_ms["lstm_sequence_cluster_kernel"]
    k3 = sum(lstm_ms[k] for k in ("lstm_sequence_bwd_cluster_kernel", "drw_partial_kernel",
                                  "drw_reduce_kernel"))
    st["profiled_batch"]["k1_ms"], st["profiled_batch"]["k3_ms"] = k1, k3
    print(f"  K1 (cluster) {k1:.3f} ms = {100 * k1 / busy_ms:.1f}% and K3 (cluster chain + "
          f"dRW pass) {k3:.3f} ms = {100 * k3 / busy_ms:.1f}% of the device time")

    # helpers on vs off over the 20 segments of one fit batch, in lockstep:
    # each step from the same parameters and updater state, compared in
    # gradients, score, and the parameters and RMSProp state it leaves
    on = network()
    off, start = on.clone(), on.clone()
    grad_err = score_err = param_err = state_err = 0.0
    for k in range(TRAIN_T // TBPTT):
        sl = slice(k * TBPTT, (k + 1) * TBPTT)
        seg = DataSet(batches[0].features[:, sl], batches[0].labels[:, sl])
        before = [{n: v.clone() for n, v in p.items()} for p in on.params_list]
        off.params_list = [{n: v.clone() for n, v in p.items()} for p in before]
        off.upd_state = [{n: {s: v.clone() for s, v in u_n.items()} for n, u_n in u.items()}
                         for u in on.upd_state]
        g_on = segment_grads(torch, on, seg)
        g_off = helpers_off(lambda: segment_grads(torch, off, seg))
        s_off, n_off = helpers_off(lambda: fit_scores(off, seg))
        s_on, n_on = fit_scores(on, seg)
        for name in ("lstm_sequence", "lstm_sequence_backward"):
            check(n_off[name] == 0 and n_on[name] == LAYERS,
                  f"launches with the helpers off {n_off}, on {n_on}")
        grad_err = max(grad_err, *(((a - b).abs().max() / b.abs().max()).item()
                                   for a, b in zip(g_on, g_off)))
        score_err = max(score_err, abs(s_on[0] - s_off[0]) / abs(s_off[0]))
        diff_sq = step_sq = 0.0
        for p0, p_on, p_off in zip(before, on.params_list, off.params_list):
            for n in p0:
                diff_sq += (p_on[n] - p_off[n]).double().square().sum().item()
                step_sq += (p_off[n] - p0[n]).double().square().sum().item()
        param_err = max(param_err, math.sqrt(diff_sq / step_sq))
        state_err = max(state_err, *(
            ((u_on[n][s] - u_off[n][s]).abs().max() / u_off[n][s].abs().max()).item()
            for u_on, u_off in zip(on.upd_state, off.upd_state)
            for n in u_off for s in u_off[n]))
    print(f"  helpers on vs off, lockstep over the {TRAIN_T // TBPTT} segments of "
          f"one fit batch: gradients max |diff|/max|g| {grad_err:.3e} "
          f"(tolerance {TRAIN_GRAD_RTOL}), scores max relative diff "
          f"{score_err:.3e} (tolerance {TRAIN_SCORE_RTOL}); after each step, "
          f"params |diff|/|step| {param_err:.3e} (tolerance {TRAIN_PARAM_RTOL}), "
          f"RMSProp r max |diff|/max|r| {state_err:.3e} "
          f"(tolerance {TRAIN_STATE_RTOL})")
    check(grad_err <= TRAIN_GRAD_RTOL, f"gradients differ with the helpers off: {grad_err}")
    check(score_err <= TRAIN_SCORE_RTOL, f"scores differ with the helpers off: {score_err}")
    check(param_err <= TRAIN_PARAM_RTOL, f"steps differ with the helpers off: {param_err}")
    check(state_err <= TRAIN_STATE_RTOL,
          f"RMSProp state differs with the helpers off: {state_err}")

    # left to run free from the same parameters: the drift of helpers on
    # vs off beside its witness, the builtin loop on the card vs on the CPU
    free_on, _ = fit_scores(start.clone(), batches[0])
    free_off, _ = helpers_off(lambda: fit_scores(start.clone(), batches[0]))
    cpu = network(device="cpu")
    cpu.params_list = [{n: v.cpu() for n, v in p.items()} for p in start.params_list]
    free_cpu, _ = fit_scores(cpu, batches[0])
    drift = [abs(a - b) / abs(b) for a, b in zip(free_on, free_off)]
    witness = [abs(a - b) / abs(b) for a, b in zip(free_off, free_cpu)]
    print(f"  free-running fit batch, relative score drift by step: helpers on "
          f"vs off {' '.join(f'{d:.1e}' for d in drift)}; witness, builtin loop "
          f"on the card vs on the CPU {' '.join(f'{d:.1e}' for d in witness)}; "
          f"peaks {max(drift):.3e} vs {max(witness):.3e} (allowed "
          f"{DRIFT_FACTOR}x)")
    check(max(drift) <= DRIFT_FACTOR * max(witness),
          f"helpers on vs off drift {max(drift)} beyond {DRIFT_FACTOR}x the "
          f"rounding-only witness {max(witness)}")
    st["helpers_on_vs_off"] = {
        "grad_rel_err": grad_err, "score_rel_err": score_err,
        "param_rel_err": param_err, "state_rel_err": state_err,
        "free_running_drift": drift, "witness_drift_card_vs_cpu": witness}

    # one bf16 fit batch: the kernels in bf16, finite scores
    bscores, b_launches = fit_scores(network(precision="bf16"), batches[0])
    check(all(math.isfinite(s) for s in bscores), f"bf16 scores not finite: {bscores}")
    check(b_launches["lstm_sequence_backward"] == LAYERS * len(bscores),
          f"the bf16 fit did not run the backward kernel: {b_launches}")
    print(f"  bf16 fit batch: scores {bscores[0]:.4f} .. {bscores[-1]:.4f}, "
          f"all finite; launches {b_launches}")
    st["bf16"] = {"scores": bscores, "launches": b_launches}
    return {"launches": launches, "lr": TRAIN_LR, **st}


# -- phase 6: train ResNet-50 ----------------------------------------------------

RESNET_BATCHES, RESNET_EPOCHS = 2, 5  # 10 optimizer steps, each batch seen 5 times
# At the configuration's lr 0.1 the repeated batch's score rises (7.7 ->
# 13.5 over 10 steps on an H100 80GB HBM3 at 700 W), and it rises alike
# in the JAX package and the port (tests/test_torch_resnet.py::
# test_published_lr_rises_alike_in_both_packages_at_full_width). Phase 6
# trains at 0.01, where it falls. The work per step does not depend on lr.
RESNET_LR = 0.01
def resnet_per_step(batch: int, dtype: str = "bf16", image: int = 224, convs=None) -> dict:
    """K4-K8 launches of one ResNet-50 training step at this batch (a
    rank's rows), dtype and image side, from the conv routing itself: the
    coverage table of what this process routes by (analysis/kernelcoverage,
    planning=False: conv_decision on every conv instance) gives K4 for each
    covered 1x1 conv, K5 for each covered k x k one and K6 for the BN after
    each covered conv; a declined conv would run cuDNN and its BN the
    builtin forward. K7 + K8 run for every BN. `convs` restricts the step
    to those conv vertices (a transfer net's unfrozen ones)."""
    import torch

    from deeplearning4j_tpu_torch.analysis import kernelcoverage as kc
    from deeplearning4j_tpu_torch.models.resnet import resnet50_conf

    rows = kc.coverage_table(resnet50_conf(image_size=image), batch,
                             {"bf16": torch.bfloat16, "f32": torch.float32}[dtype],
                             planning=False)
    if convs is not None:
        rows = [r for r in rows if r["layer"] in convs]
    per = kc.launches_per_step(rows)
    per.update(bn_backward_reduce=len(rows), bn_backward_apply=len(rows))
    return per
LOCKSTEP_BATCH = 32
# Helpers on vs off in f32 at batch 32, from the same parameters at init.
#
# ResNet-50's f32 gradient here is ill-conditioned, and the cause is the
# forward's ReLU gates: the f32 forward sets a few ReLU inputs within
# rounding of zero to the other sign than f64 (or than f32 summing the
# batch in another order) does, and the gradient jumps at each. So two
# f32 paths that differ only in rounding part by ~1% of the median tensor
# and ~10% of the worst, while the backward from one forward is well
# conditioned: taking the BN pullback on centered x (x - mean) instead of
# the raw x both packages keep moves it by ~1e-6 (CPU test
# tests/test_torch_resnet.py::test_resnet50_f32_gradient_at_init_is_ill_conditioned).
# The script shows the same on the card's inputs: the ReLU gates where the
# f32 and f64 forwards disagree, the builtin's distance from f64 with the
# batch reordered and with the centered pullback.
#
# Held at fixed bounds: the score of one step to 1e-5 relative and the BN
# running mean and var after it to 1e-4 of each tensor's largest entry
# (the fused path's variance comes from raw moments, the builtin's from
# centered ones); and, from one forward through K4-K6 (so the same gates),
# the gradients with the K7 + K8 pullback against those with the builtin
# pullback to 1e-4 of each tensor's largest entry. The kernels' whole f32
# gradient is held to the f64 witness: it must stand no further from the
# builtin step in f64 than GRAD_WITNESS_FACTOR times the builtin f32
# gradient does, by the median and by the worst tensor.
RESNET_GRAD_RTOL = 1e-4
RESNET_SCORE_RTOL = 1e-5
RESNET_STATE_RTOL = 1e-4
GRAD_WITNESS_FACTOR = 1.5
CONV_BN_OPS = ("conv2d", "batch_norm", "bn_backward")


# Passes the BN pullback once ran on full-size tensors of its own, which
# K7 and K8 now form on their loads: the centring x - bf16(mean) (aten::sub)
# and the ReLU gate torch.where(y > 0, g, 0) (aten::where).
FOLDED_OPS = ("aten::sub", "aten::where")


def big_ops(prof, numel):
    """{aten op: calls} of the ops a CPU-activity profile with input
    shapes saw take a tensor of at least `numel` elements."""
    out = collections.Counter()
    for e in prof.key_averages(group_by_input_shape=True):
        if e.key.startswith("aten::") and any(
                len(sh) > 0 and math.prod(sh) >= numel for sh in (e.input_shapes or [])
                if isinstance(sh, (list, tuple))):
            out[e.key] += e.count
    return dict(out)


def step_ops(torch, net, data, ExistingDataSetIterator):
    """One more training step with the profiler's CPU activity and input
    shapes on (not timed): the aten ops that took a tensor of a BN
    layer's size or more (the smallest, [128, 7, 7, 512]); none may be a
    folded pass."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU], record_shapes=True) as prof:
        net.fit(ExistingDataSetIterator(data))
        torch.cuda.synchronize()
    ops = big_ops(prof, RESNET_BATCH * 7 * 7 * 512)
    folded = {k: ops[k] for k in FOLDED_OPS if k in ops}
    print(f"  one step's aten ops on BN-sized tensors (calls): "
          + ", ".join(f"{k[6:]} {c}" for k, c in sorted(ops.items(), key=lambda kv: -kv[1])))
    check(not folded, f"the step still runs the folded passes: {folded}")
    return ops


def bn_backward_region(torch, fcb, seed):
    """The backward of one BN with ReLU at the stem's [128, 112, 112, 64]
    bf16 through `bn_apply` (K6 forward): device ms by kernel (CUDA
    activity only), one launch each of K7 and K8, and no centring or gate
    op (FOLDED_OPS) on a tensor of the BN's size (CPU activity with input
    shapes)."""
    from torch.profiler import ProfilerActivity, profile

    gen = torch.Generator(device="cuda").manual_seed(seed + 62)
    C = 64
    x = torch.randn((RESNET_BATCH, 112, 112, C), generator=gen, device="cuda").to(torch.bfloat16)
    n = x.numel() // C
    xf = x.reshape(n, C).float()
    s1, s2 = xf.sum(0), (xf * xf).sum(0)
    del xf
    x.requires_grad_()
    gamma = torch.ones(C, device="cuda", requires_grad=True)
    beta = torch.zeros(C, device="cuda", requires_grad=True)
    y, _, _ = fcb.bn_apply(x, s1, s2, gamma, beta, 1e-5, n, True)
    dy = torch.randn(y.shape, generator=gen, device="cuda").to(y.dtype)

    def pullback():
        return torch.autograd.grad(y, (x, gamma, beta), dy, retain_graph=True)

    by_kernel = device_by_kernel(torch, pullback, reps=5)
    before = fcb.launch_counts()
    with profile(activities=[ProfilerActivity.CPU], record_shapes=True) as prof:
        pullback()
        torch.cuda.synchronize()
    after = fcb.launch_counts()
    runs = {k: after[k] - before[k] for k in ("bn_apply", "bn_backward_reduce",
                                              "bn_backward_apply")}
    ops = big_ops(prof, n * C)
    total = sum(by_kernel.values())
    print(f"  one BN's backward with ReLU at [{n}, {C}] bf16: device {total:.4f} ms; launches "
          f"{runs}; by kernel: " + ", ".join(
              f"{k[:40]} {m:.4f}" for k, m in sorted(by_kernel.items(), key=lambda kv: -kv[1])))
    print(f"    aten ops on [{n}, {C}]-sized tensors (calls): {ops}")
    check(runs == {"bn_apply": 0, "bn_backward_reduce": 1, "bn_backward_apply": 1},
          f"the BN backward did not run K7 and K8 once each: {runs}")
    check(not any(k in ops for k in FOLDED_OPS),
          f"the BN backward still runs a centring or gate pass: {ops}")
    return {"shape": [n, C], "device_ms": total, "by_kernel_ms": by_kernel,
            "launches": runs, "big_ops": ops}


def resnet_phase(torch, F, fcb, helpers, resnet50_network, DataSet,
                 ExistingDataSetIterator, IterationListener, seed, card):
    class Scores(IterationListener):
        def __init__(self, clock=False):
            self.scores, self.clock = [], clock
            self.times = [time.perf_counter()]

        def iteration_done(self, model, iteration, info):
            if self.clock:
                torch.cuda.synchronize()
                self.times.append(time.perf_counter())
            self.scores.append(info["score"]())

        def values(self):
            return [float(s) for s in self.scores]

    def batches(n, b, dtype):
        g = torch.Generator(device="cuda").manual_seed(seed + 60)
        out = []
        for _ in range(n):
            x = torch.randn((b, 224, 224, 3), generator=g, device="cuda").to(dtype)
            lab = torch.randint(0, 1000, (b,), generator=g, device="cuda")
            out.append(DataSet(x, F.one_hot(lab, 1000).float()))
        return out

    net = resnet50_network(precision="bf16", seed=seed, learning_rate=RESNET_LR)
    data = batches(RESNET_BATCHES, RESNET_BATCH, torch.float32)
    steps = RESNET_BATCHES * RESNET_EPOCHS
    log = Scores()
    net.set_listeners(log)
    fcb.reset_launch_counts()
    t0 = time.perf_counter()
    net.fit(ExistingDataSetIterator(data), epochs=RESNET_EPOCHS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = fcb.launch_counts()
    scores = log.values()
    check(net.iteration == steps and len(scores) == steps,
          f"fit ran {net.iteration} steps, expected {steps}")
    check(all(math.isfinite(v) for v in scores), f"non-finite score: {scores}")
    for k, per in resnet_per_step(RESNET_BATCH).items():
        check(launches[k] == per * steps,
              f"{k} launched {launches[k]} times in {steps} steps, expected {per} per step")
    first, last = scores[0], scores[-RESNET_BATCHES]
    print(f"  fit {steps} steps ({RESNET_BATCHES} batches x {RESNET_EPOCHS} epochs) of "
          f"[{RESNET_BATCH}, 224, 224, 3] bf16: {steps * RESNET_BATCH / wall:.1f} images/s "
          f"({wall:.3f} s, no per-step sync, the first step's warm-up included) on {card}")
    print(f"  scores {' '.join(f'{v:.4f}' for v in scores)}; launches {launches} "
          f"({len(net.relu_fused_bn)} BNs apply the ReLU themselves)")
    check(last < first, f"batch 0's score did not fall: {first} -> {last}")

    clock = Scores(clock=True)
    net.set_listeners(clock).fit(ExistingDataSetIterator(data), epochs=1)
    step_s = np.diff(clock.times)
    st = {"steps": steps, "images_per_s": steps * RESNET_BATCH / wall, "seconds": wall,
          "step_p50_s": float(np.percentile(step_s, 50)),
          "step_p99_s": float(np.percentile(step_s, 99)),
          "scores": scores, "relu_fused_bn": len(net.relu_fused_bn)}
    print(f"  a pass synced per step: step p50 {st['step_p50_s']:.4f} s, p99 "
          f"{st['step_p99_s']:.4f} s (host clock) = "
          f"{RESNET_BATCH / st['step_p50_s']:.1f} images/s at p50")

    from torch.profiler import ProfilerActivity, profile

    net.set_listeners()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t1 = time.perf_counter()
        net.fit(ExistingDataSetIterator(data[:1]))
        torch.cuda.synchronize()
        wall1 = time.perf_counter() - t1
    rows = sorted(((e.key, getattr(e, "self_device_time_total", 0.0) / 1e3, e.count)
                   for e in prof.key_averages()), key=lambda r: -r[1])
    busy_ms = sum(r[1] for r in rows)
    check(busy_ms > 0, "the profiler saw no device time in the ResNet step")
    # K4 and K5 by their kernels' names (the shared column_sums second stage
    # is not in them)
    conv_ms = {k: sum(m for n, m, _ in rows if k in n) for k in ("conv1x1_stats",
                                                                  "conv_kxk_stats")}
    st["profiled_step"] = {"seconds": wall1, "device_busy_s": busy_ms / 1e3,
                           "busy_share": busy_ms / 1e3 / wall1,
                           "conv_kernels_ms": conv_ms,
                           "conv_kernels_share": sum(conv_ms.values()) / busy_ms,
                           "top_device_ms": [{"name": n[:80], "ms": m, "calls": c}
                                             for n, m, c in rows[:15]]}
    print(f"  one step under the profiler: device busy {busy_ms:.2f} ms of "
          f"{wall1 * 1e3:.2f} ms wall = busy share {busy_ms / 1e3 / wall1:.4f}; K4 "
          f"{conv_ms['conv1x1_stats']:.2f} ms + K5 {conv_ms['conv_kxk_stats']:.2f} ms = "
          f"{100 * sum(conv_ms.values()) / busy_ms:.1f}% of it; device time by kernel:")
    for n, m, c in rows[:15]:
        print(f"    {m:9.3f} ms {100 * m / busy_ms:5.1f}%  x{c:<5d} {n[:70]}")
    bn_ms = {k: sum(m for n, m, _ in rows if k in n)
             for k in ("bn_apply_kernel", "bn_reduce_kernel", "bn_dx_kernel")}
    st["profiled_step"]["bn_kernels_ms"] = bn_ms
    print(f"  the BN kernels in that step: K6 {bn_ms['bn_apply_kernel']:.3f} ms, K7 (first "
          f"pass) {bn_ms['bn_reduce_kernel']:.3f} ms, K8 {bn_ms['bn_dx_kernel']:.3f} ms")
    st["step_ops"] = step_ops(torch, net, data[:1], ExistingDataSetIterator)
    del net, data
    st["bn_backward_region"] = bn_backward_region(torch, fcb, seed)

    # helpers on vs off in f32 at batch 32 (see LOCKSTEP_BATCH)
    from deeplearning4j_tpu_torch.common.dtypes import PrecisionPolicy
    from deeplearning4j_tpu_torch.nn.layers import norm as norm_layer

    on = resnet50_network(precision="f32", seed=seed, learning_rate=RESNET_LR)
    off = on.clone()
    ds = batches(1, LOCKSTEP_BATCH, torch.float32)[0]
    perm = torch.randperm(LOCKSTEP_BATCH, generator=torch.Generator().manual_seed(seed + 61))
    perm = perm.to(ds.features.device)

    def loss(net, batch):
        leaves = [v.requires_grad_() for p in net.params_list for v in p.values()]
        s_, _ = net._loss(net.params_list, net.state_list, [batch.features],
                          [batch.labels], None, None, None)
        return s_, leaves

    def grads(net, batch):
        s_, leaves = loss(net, batch)
        try:
            return torch.autograd.grad(s_, leaves)
        finally:
            for v in leaves:
                v.requires_grad_(False)

    def helpers_off(fn, ops=CONV_BN_OPS):
        for op in ops:
            helpers.set_helper_enabled(op, False)
        try:
            return fn()
        finally:
            for op in ops:
                helpers.set_helper_enabled(op, True)

    f64 = torch.float64
    w64 = off.clone()
    w64.policy = PrecisionPolicy(param_dtype=f64, compute_dtype=f64, output_dtype=f64)
    w64.params_list = [{k: v.double() for k, v in p.items()} for p in w64.params_list]
    w64.state_list = [None if s_ is None else {k: v.double() for k, v in s_.items()}
                      for s_ in w64.state_list]
    ds64 = DataSet(ds.features.double(), ds.labels.double())

    def centered_pullback(fn):
        """fn() with the f32 BN pullback taken on x - mean (the same math)."""
        plain = norm_layer.bn_backward_pieces

        def centered(g, x, mean, inv, gamma, n, *, gate_y=None):
            if x.dtype != torch.float32:
                return plain(g, x, mean, inv, gamma, n, gate_y=gate_y)
            return plain(g, x - mean, torch.zeros_like(mean), inv, gamma, n, gate_y=gate_y)

        norm_layer.bn_backward_pieces = centered
        try:
            return fn()
        finally:
            norm_layer.bn_backward_pieces = plain

    names = [f"{n}.{k}" for n, p in zip(on.layer_vertex_names, on.params_list) for k in p]

    def dist(ga, gb):
        """Per tensor max |a - b| over max |b|: (median, worst, the three
        worst tensors)."""
        d = [((a.double() - b.double()).abs().max()
              / b.double().abs().max().clamp_min(1e-300)).item() for a, b in zip(ga, gb)]
        top = sorted(zip(d, names), reverse=True)[:3]
        return float(np.median(d)), max(d), [f"{n} {v:.1e}" for v, n in top]

    before = fcb.launch_counts()
    # one forward through K4-K6, two pullbacks from it: K7 + K8, then the
    # builtin BN pullback (the same gates, the same cuDNN conv gradients)
    s_, leaves = loss(on, ds)
    g_on = torch.autograd.grad(s_, leaves, retain_graph=True)
    g_on_builtin_bn = helpers_off(lambda: torch.autograd.grad(s_, leaves), ("bn_backward",))
    for v in leaves:
        v.requires_grad_(False)
    del s_, leaves
    g_off = helpers_off(lambda: grads(off, ds))
    g64 = helpers_off(lambda: grads(w64, ds64))
    study = {
        "kernels_vs_f64": dist(g_on, g64), "builtin_vs_f64": dist(g_off, g64),
        "kernels_vs_builtin": dist(g_on, g_off),
        "k7_k8_vs_builtin_pullback_same_forward": dist(g_on, g_on_builtin_bn),
        "builtin_batch_reordered_vs_builtin": dist(helpers_off(lambda: grads(
            off, DataSet(ds.features[perm].contiguous(), ds.labels[perm].contiguous()))), g_off),
    }
    g_c = helpers_off(lambda: centered_pullback(lambda: grads(off, ds)))
    study["builtin_centered_pullback_vs_builtin"] = dist(g_c, g_off)
    study["builtin_centered_pullback_vs_f64"] = dist(g_c, g64)
    del g_on, g_on_builtin_bn, g_off, g64, g_c

    # the ReLU gates the f32 and f64 builtin forwards disagree on
    def acts(net, batch):
        with torch.no_grad():
            a, _ = net._forward(net.params_list, net.state_list, [batch.features],
                                training=True, rng=None)
        return a

    a32, a64 = helpers_off(lambda: (acts(off, ds), acts(w64, ds64)))
    gated = [n for n in off.topo if n in off.relu_fused_bn or n.endswith("_relu")]
    flips = {n: int(((a32[n] > 0) != (a64[n] > 0)).sum()) for n in gated}
    flips = {n: f for n, f in flips.items() if f}
    n_gates = sum(a32[n].numel() for n in gated)
    del a32, a64, w64
    print(f"  gradients at init, f32, batch {LOCKSTEP_BATCH}, per tensor max |diff|/max "
          f"(median, worst, worst tensors):")
    for k, r in study.items():
        print(f"    {k.replace('_', ' ')}: {r[0]:.3e}, {r[1]:.3e} ({', '.join(r[2])})")
    print(f"  ReLU gates where the f32 and f64 builtin forwards disagree: "
          f"{sum(flips.values())} of {n_gates} ({flips})")

    l_on, l_off = Scores(), Scores()
    on.set_listeners(l_on).fit(ExistingDataSetIterator([ds]))
    helpers_off(lambda: off.set_listeners(l_off).fit(ExistingDataSetIterator([ds])))
    torch.cuda.synchronize()
    after = fcb.launch_counts()
    want32 = resnet_per_step(LOCKSTEP_BATCH, "f32")
    check(all(after[k] - before[k] == 2 * want32[k] for k in want32),
          f"the helpers-on f32 passes did not run the kernels: {before} -> {after}, "
          f"expected twice {want32}")
    s_on, s_off = l_on.values()[0], l_off.values()[0]
    score_err = abs(s_on - s_off) / abs(s_off)
    state_err = max(((a[k] - b[k]).abs().max() / b[k].abs().max().clamp_min(1e-30)).item()
                    for a, b in zip(on.state_list, off.state_list) if b is not None
                    for k in b)
    grad_err = study["k7_k8_vs_builtin_pullback_same_forward"][1]
    wit = [study["kernels_vs_f64"][i] / study["builtin_vs_f64"][i] for i in (0, 1)]
    print(f"  helpers on vs off, one f32 step at batch {LOCKSTEP_BATCH}: score "
          f"{s_on:.6f} vs {s_off:.6f}, relative {score_err:.3e} (tolerance "
          f"{RESNET_SCORE_RTOL}), BN running stats after the step max |diff|/max "
          f"{state_err:.3e} (tolerance {RESNET_STATE_RTOL}); gradients, K7 + K8 vs "
          f"the builtin pullback from one forward, worst {grad_err:.3e} (tolerance "
          f"{RESNET_GRAD_RTOL}); the kernels' distance from f64 {wit[0]:.2f}x (median) "
          f"and {wit[1]:.2f}x (worst) the builtin's (allowed {GRAD_WITNESS_FACTOR}x)")
    check(grad_err <= RESNET_GRAD_RTOL,
          f"K7 + K8 gradients differ from the builtin pullback's: {grad_err}")
    check(max(wit) <= GRAD_WITNESS_FACTOR,
          f"the kernels' gradients stand further from f64 than {GRAD_WITNESS_FACTOR}x "
          f"the builtin's: {study}")
    check(score_err <= RESNET_SCORE_RTOL, f"scores differ with the helpers off: {score_err}")
    check(state_err <= RESNET_STATE_RTOL, f"BN running stats differ: {state_err}")
    st["helpers_on_vs_off"] = {
        "grad_rel_err_same_forward": grad_err, "score_rel_err": score_err,
        "state_rel_err": state_err, "witness_ratio": {"median": wit[0], "worst": wit[1]},
        "grads": {k: {"median": r[0], "worst": r[1], "worst_tensors": r[2]}
                  for k, r in study.items()},
        "relu_gates_f32_vs_f64": {"disagree": flips, "gates": n_gates}}
    return {"launches": launches, "lr": RESNET_LR, **st}


# -- phase 7: checkpoint, resume, evaluate, serve from a zip -------------------

# scratch for phase 7's checkpoint directories and zips, inside the
# checkout (gitignored), removed when the phase ends
CKPT_DIR = os.path.join(HERE, "_ckpt_smoke")
CKPT_EPOCHS = 2
SEGMENTS = TRAIN_T // TBPTT          # TBPTT segments per char-LSTM batch
EPOCH_STEPS = TRAIN_BATCHES * SEGMENTS  # 60 optimizer steps per epoch
# the child's pause after printing a step: widens the window in which the
# parent's signal lands inside epoch 1 (the work does not change)
CHILD_STEP_SLEEP = 0.02
# 7a's SIGTERM goes out after this step: three quarters into epoch 1's
# first batch
SIGTERM_STEP = EPOCH_STEPS + (3 * SEGMENTS) // 4
RESUME_BATCHES = 4   # ResNet-50 batches per epoch in 7b
RESUME_EVERY = 3     # 7b saves after iterations 4 and 7 (batch 3 of 4 in epoch 1)
RESUME_CRASH = 6     # ... and crashes after that second save is flushed
DECODE_PROMPTS = 4   # 7c's requests to the decode engine on the loaded zip


def resume_windows(DataSet, seed):
    """7a's data: TRAIN_BATCHES batches' worth of SURVEY.md windows as one
    DataSet, dealt by a shuffling iterator."""
    bs = corpus_batches(DataSet, seed + 70, TRAIN_BATCHES)
    return DataSet(np.concatenate([b.features for b in bs]),
                   np.concatenate([b.labels for b in bs]))


def resume_charlstm(char_lstm_network, seed):
    return char_lstm_network(vocab_size=VOCAB, hidden=HIDDEN, layers=LAYERS,
                             tbptt_length=TBPTT, seed=seed, learning_rate=TRAIN_LR)


def charlstm_child(ckpt_dir: str, seed: int) -> int:
    """The killed run of 7a, in a process of its own: the full-width
    char-LSTM fits 2 epochs with an async checkpoint listener that saves
    at each epoch's end and on SIGTERM, and prints one flushed
    "STEP <iteration> <score>" line a step."""
    import torch

    if not torch.cuda.is_available():
        return 2
    sys.path.insert(0, HERE)
    from deeplearning4j_tpu_torch.common.dtypes import default_policy
    from deeplearning4j_tpu_torch.data import DataSet, ListDataSetIterator
    from deeplearning4j_tpu_torch.models.charlstm import char_lstm_network
    from deeplearning4j_tpu_torch.train.checkpoint import CheckpointListener
    from deeplearning4j_tpu_torch.train.listeners import IterationListener

    class Printer(IterationListener):
        def iteration_done(self, model, iteration, info):
            print(f"STEP {iteration} {float(info['score']()):.17g}", flush=True)
            time.sleep(CHILD_STEP_SLEEP)

    default_policy().apply()
    net = resume_charlstm(char_lstm_network, seed)
    lst = CheckpointListener(ckpt_dir, every_n_epochs=1, every_n_iterations=None,
                             async_save=True, save_on_preemption=True)
    net.set_listeners(lst, Printer())
    net.fit(ListDataSetIterator(resume_windows(DataSet, seed), TRAIN_B, shuffle=True,
                                seed=seed), epochs=CKPT_EPOCHS)
    print("FIT DONE", flush=True)
    return 0


def run_child(ckpt_dir, seed, sig, fire):
    """Start the 7a child and read its steps; send `sig` at the first step
    where `fire(iteration, latest.json or None)` holds. Returns (exit code,
    {iteration: score}, the iteration after which the signal went out)."""
    import signal

    err = open(os.path.join(CKPT_DIR, f"child_{sig}.err"), "w")
    proc = subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--child", "charlstm",
         "--ckpt-dir", ckpt_dir, "--seed", str(seed)],
        cwd=HERE, stdout=subprocess.PIPE, stderr=err, text=True)
    steps, sent = {}, None
    try:
        for line in proc.stdout:
            if line.startswith("STEP "):
                _, it, score = line.split()
                steps[int(it)] = float(score)
                latest = None
                try:
                    with open(os.path.join(ckpt_dir, "latest.json")) as f:
                        latest = json.load(f)
                except (OSError, ValueError):
                    pass
                if fire(int(it), latest):
                    proc.send_signal(sig)
                    sent = int(it)
                    break
            elif line.startswith("FIT DONE"):
                break
        rc = proc.wait(timeout=300)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        proc.stdout.close()
        err.close()
    if sent is None or rc != -sig:
        with open(err.name) as f:
            tail = f.read()[-3000:]
        raise SmokeFailure(f"child (signal {sig}) ended with {rc} after step "
                           f"{max(steps, default=None)}, signal sent after {sent}: {tail}")
    return rc, steps, sent


def leaves_of(tree):
    from deeplearning4j_tpu_torch.utils.model_serializer import tree_leaves

    return [t.detach().clone() for t in tree_leaves(tree)]


def same_leaves(a, b) -> bool:
    return len(a) == len(b) and all(torch_equal(x, y) for x, y in zip(a, b))


def torch_equal(x, y) -> bool:
    return x.shape == y.shape and x.dtype == y.dtype and bool((x == y).all())


class StepScores:
    """Each step's score kept as a device tensor, read after the fit (no
    per-step sync); with `clock`, the host clock after a device sync at
    each step."""

    def __init__(self, torch, clock=False):
        self.torch, self.clock = torch, clock
        self.scores, self.times = {}, [time.perf_counter()]

    def iteration_done(self, model, iteration, info):
        if self.clock:
            self.torch.cuda.synchronize()
            self.times.append(time.perf_counter())
        self.scores[iteration] = info["score"]()

    def on_epoch_start(self, model, epoch):
        pass

    def on_epoch_end(self, model, epoch):
        pass

    def values(self):
        return {i: float(s) for i, s in self.scores.items()}


class Crash(RuntimeError):
    """7b's simulated crash."""


def truncating_iterator(DataSetIterator, base, epoch, batch, segments):
    """The reference of a SIGTERM resume: `base`, with batch `batch` of
    epoch `epoch` cut to its first `segments` TBPTT segments — the
    segments the preempted run trained before its save counted the batch
    as consumed."""

    class Truncate(DataSetIterator):
        def __init__(self):
            self.epoch = 0

        def __iter__(self):
            for i, ds in enumerate(base):
                if self.epoch == epoch and i == batch:
                    cut = slice(0, segments * TBPTT)
                    ds = type(ds)(ds.features[:, cut], ds.labels[:, cut])
                yield ds
            self.epoch += 1

        def reset(self):
            base.reset()

    return Truncate()


def charlstm_resume_phase(torch, fl, char_lstm_network, DataSet, DataSetIterator,
                          ListDataSetIterator, ckpt, ms, seed):
    """7a: SIGKILL and SIGTERM a full-width char-LSTM fit in a child
    process, resume it here, and hold the resumed run bit-equal to an
    uninterrupted one."""
    import signal

    data = resume_windows(DataSet, seed)

    def iterator():
        return ListDataSetIterator(data, TRAIN_B, shuffle=True, seed=seed)

    def fit(it, resume_from=None):
        net = resume_charlstm(char_lstm_network, seed)
        log = StepScores(torch)
        net.set_listeners(log)
        before = fl.launch_counts()
        net.fit(it, epochs=CKPT_EPOCHS, resume_from=resume_from)
        torch.cuda.synchronize()
        launches = {k: v - before[k] for k, v in fl.launch_counts().items()}
        return net, log.values(), launches

    t0 = time.perf_counter()
    ref_net, ref, _ = fit(iterator())
    ref_wall = time.perf_counter() - t0
    steps = CKPT_EPOCHS * EPOCH_STEPS
    check(sorted(ref) == list(range(steps)), f"the reference ran {len(ref)} steps")
    ref_p, ref_r = leaves_of(ref_net.params_list), leaves_of(ref_net.upd_state)
    del ref_net
    out = {"reference_seconds": ref_wall}

    # SIGKILL once the epoch-0 checkpoint is published and epoch 1 runs
    kdir = os.path.join(CKPT_DIR, "charlstm_kill")
    rc, seen, sent = run_child(
        kdir, seed, signal.SIGKILL,
        lambda it, latest: it >= EPOCH_STEPS and latest is not None
        and latest.get("iteration") == EPOCH_STEPS)
    for f in os.listdir(kdir):
        if ".tmp" in f:
            os.remove(os.path.join(kdir, f))
    bad = [i for i, sc in seen.items() if sc != ref[i]]
    check(not bad, f"the child's steps differ from the reference at {bad[:5]}")
    path, meta = ckpt.latest_checkpoint(kdir)
    check(meta["iteration"] == EPOCH_STEPS,
          f"the newest checkpoint after the kill is {meta}")
    net, res, launches = fit(iterator(), resume_from=kdir)
    bad = [i for i, sc in res.items() if sc != ref[i]]
    p_eq = same_leaves(leaves_of(net.params_list), ref_p)
    r_eq = same_leaves(leaves_of(net.upd_state), ref_r)
    n = len(res)
    print(f"  SIGKILL after step {sent} (latest.json: iteration {meta['iteration']}, "
          f"epoch {meta['epoch']}); resumed {n} steps from iteration {min(res)}: scores "
          f"bit-equal {not bad}, parameters bit-equal {p_eq}, RMSProp r bit-equal {r_eq}; "
          f"launches {launches}")
    check(min(res) == EPOCH_STEPS and n == steps - EPOCH_STEPS,
          f"resumed at {min(res)} for {n} steps")
    check(not bad, f"resumed scores differ from the uninterrupted run at {bad[:5]}")
    check(p_eq and r_eq, "resumed parameters or RMSProp state differ")
    for k in ("lstm_sequence", "lstm_sequence_backward"):
        check(launches[k] == LAYERS * n,
              f"{k} launched {launches[k]} times in {n} resumed steps")
    out["sigkill"] = {"signal_after_step": sent, "checkpoint_iteration": meta["iteration"],
                      "resumed_steps": n, "scores_equal": not bad, "params_equal": p_eq,
                      "rmsprop_equal": r_eq, "launches": launches}
    del net

    # SIGTERM mid-batch: the preemption save lands between segments
    tdir = os.path.join(CKPT_DIR, "charlstm_term")
    rc, seen, sent = run_child(tdir, seed, signal.SIGTERM,
                               lambda it, latest: it >= SIGTERM_STEP)
    path, meta = ckpt.latest_checkpoint(tdir)
    ts = ms.read_train_state(path)
    check(meta.get("reason") == "preemption", f"no preemption save: {meta}")
    it_saved, ep, b = meta["iteration"], ts["epoch"], ts["batch_in_epoch"]
    done = it_saved - (ep * TRAIN_BATCHES + b - 1) * SEGMENTS
    check(0 < done <= SEGMENTS, f"inconsistent preemption save: {meta} {ts}")
    net, res, launches = fit(iterator(), resume_from=tdir)
    tref_net, tref, _ = fit(
        truncating_iterator(DataSetIterator, iterator(), ep, b - 1, done))
    bad = [i for i, sc in res.items() if sc != tref[i]]
    p_eq = same_leaves(leaves_of(net.params_list), leaves_of(tref_net.params_list))
    r_eq = same_leaves(leaves_of(net.upd_state), leaves_of(tref_net.upd_state))
    del tref_net
    print(f"  SIGTERM after step {sent}: the preemption save holds iteration {it_saved} "
          f"(epoch {ep}, batch_in_epoch {b}: batch {b - 1} counted consumed after "
          f"{done} of its {SEGMENTS} segments); the resume skips its other "
          f"{SEGMENTS - done} segments and runs {len(res)} steps from iteration "
          f"{min(res)}; against a reference that skips the same segments: scores "
          f"bit-equal {not bad}, parameters {p_eq}, RMSProp r {r_eq}")
    check(min(res) == it_saved, f"resumed at {min(res)}, saved at {it_saved}")
    check(not bad and p_eq and r_eq,
          f"SIGTERM resume differs from its reference (scores at {bad[:5]})")
    out["sigterm"] = {"signal_after_step": sent, "checkpoint_iteration": it_saved,
                      "epoch": ep, "batch_in_epoch": b, "segments_done": done,
                      "resumed_steps": len(res), "scores_equal": not bad,
                      "params_equal": p_eq, "rmsprop_equal": r_eq}
    return net, data, out


def resnet_resume_phase(torch, F, fcb, resnet50_network, DataSet, ListDataSetIterator,
                        ckpt, metrics, seed, card):
    """7b: ResNet-50 saves asynchronously mid-epoch, crashes, and a fresh
    net resumes bit-equal (with cuDNN's deterministic algorithms); then
    the step time with the async listener beside one without it."""
    g = torch.Generator(device="cuda").manual_seed(seed + 70)
    n = RESUME_BATCHES * RESNET_BATCH
    x = torch.randn((n, 224, 224, 3), generator=g, device="cuda")
    lab = torch.randint(0, 1000, (n,), generator=g, device="cuda")
    data = DataSet(x, F.one_hot(lab, 1000).float())
    steps = CKPT_EPOCHS * RESUME_BATCHES

    class CrashAfterFlush:
        def __init__(self, lst):
            self.lst = lst

        def iteration_done(self, model, iteration, info):
            if iteration == RESUME_CRASH:
                self.lst.flush()
                raise Crash(f"simulated crash after iteration {iteration}")

        def on_epoch_start(self, model, epoch):
            pass

        def on_epoch_end(self, model, epoch):
            pass

    def run(listeners=(), resume_from=None, clock=False):
        net = resnet50_network(precision="bf16", seed=seed, learning_rate=RESNET_LR)
        log = StepScores(torch, clock=clock)
        net.set_listeners(*listeners[:1], log, *listeners[1:])
        before = fcb.launch_counts()
        try:
            net.fit(ListDataSetIterator(data, RESNET_BATCH, shuffle=True, seed=seed),
                    epochs=CKPT_EPOCHS, resume_from=resume_from)
        except Crash:
            pass
        torch.cuda.synchronize()
        launches = {k: v - before[k] for k, v in fcb.launch_counts().items()}
        return net, log, launches

    def state(net):
        return (leaves_of(net.params_list), leaves_of(net.upd_state),
                leaves_of(net.state_list))

    old = (torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark)
    out = {"cudnn_default": {"deterministic": old[0], "benchmark": old[1]}}
    # two uninterrupted runs with the setting every other phase uses
    a_net, a, _ = run()
    sa = state(a_net)
    del a_net
    b_net, b, _ = run()
    sb = state(b_net)
    del b_net
    av, bv = a.values(), b.values()
    repro = (av == bv, all(same_leaves(p, q) for p, q in zip(sa, sb)))
    print(f"  two uninterrupted runs ({steps} steps, cudnn.deterministic={old[0]}, "
          f"benchmark={old[1]}): scores bit-equal {repro[0]}, parameters, Nesterovs v "
          f"and BN running stats bit-equal {repro[1]}")
    out["reproducible_without_deterministic"] = {"scores": repro[0], "state": repro[1]}
    del sa, sb
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    try:
        ref_net, ref, _ = run()
        sr = state(ref_net)
        del ref_net
        rdir = os.path.join(CKPT_DIR, "resnet")
        lst = ckpt.CheckpointListener(rdir, every_n_iterations=RESUME_EVERY,
                                      every_n_epochs=None, async_save=True)
        crashed, _, _ = run(listeners=(lst, CrashAfterFlush(lst)))
        check(crashed.iteration == RESUME_CRASH + 1, f"crash at {crashed.iteration}")
        lst.close()
        del crashed
        path, meta = ckpt.latest_checkpoint(rdir)
        ts = ckpt_train_state(path)
        net, res, launches = run(resume_from=rdir)
        rv, refv = res.values(), ref.values()
        bad = [i for i in rv if rv[i] != refv[i]]
        eq = [same_leaves(p, q) for p, q in zip(state(net), sr)]
        print(f"  cudnn.deterministic=True: crash after iteration {RESUME_CRASH}; the "
              f"newest checkpoint holds iteration {meta['iteration']} (epoch "
              f"{ts['epoch']}, batch_in_epoch {ts['batch_in_epoch']} of "
              f"{RESUME_BATCHES}); resumed {len(rv)} step(s) from iteration "
              f"{min(rv)}: scores bit-equal {not bad}, parameters {eq[0]}, Nesterovs "
              f"v {eq[1]}, BN running stats {eq[2]}; launches {launches}")
        check(ts["batch_in_epoch"] == 3 and ts["epoch"] == 1,
              f"the mid-epoch save records {ts}")
        check(min(rv) == meta["iteration"] and len(rv) == steps - meta["iteration"],
              f"resumed {sorted(rv)}")
        check(not bad and all(eq), "the resumed ResNet-50 differs from the "
              "uninterrupted run")
        for k, per in resnet_per_step(RESNET_BATCH).items():
            check(launches[k] == per * len(rv),
                  f"{k} launched {launches[k]} times in {len(rv)} resumed steps")
        out["resume"] = {"checkpoint_iteration": meta["iteration"], "train_state": ts,
                         "resumed_steps": len(rv), "scores_equal": not bad,
                         "params_equal": eq[0], "nesterovs_equal": eq[1],
                         "bn_stats_equal": eq[2], "launches": launches}
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = old
    del sr

    # step time: the async listener saving every 3 steps, beside none
    hist = metrics.get_registry().histogram(
        "checkpoint_save_seconds", "", ("phase",))
    times = {}
    for name in ("without", "with"):
        sdir = os.path.join(CKPT_DIR, "resnet_timed")
        lst = (ckpt.CheckpointListener(sdir, every_n_iterations=RESUME_EVERY,
                                       every_n_epochs=None, async_save=True, keep_last=1)
               if name == "with" else None)
        t_net, log, _ = run(listeners=(lst,) if lst else (), clock=True)
        if lst is not None:
            lst.close()
        del t_net
        dt = np.diff(log.times)[1:]  # the first step's warm-up left out
        times[name] = {"step_p50_s": float(np.percentile(dt, 50)),
                       "step_p99_s": float(np.percentile(dt, 99)), "steps": len(dt)}
    snap, write = hist.labels("snapshot"), hist.labels("write")
    saves = {"snapshot_p50_s": snap.percentile(50), "snapshot_max_s": snap.percentile(100),
             "write_p50_s": write.percentile(50), "write_max_s": write.percentile(100),
             "snapshots": snap.count, "writes": write.count}
    print(f"  ResNet-50 step, synced per step, steps 2-{steps} of {steps}: without a "
          f"listener p50 {times['without']['step_p50_s']:.4f} s p99 "
          f"{times['without']['step_p99_s']:.4f} s; with the async listener saving every "
          f"{RESUME_EVERY} steps p50 {times['with']['step_p50_s']:.4f} s p99 "
          f"{times['with']['step_p99_s']:.4f} s (host clock) on {card}")
    print(f"  checkpoint_save_seconds over {saves['writes']} ResNet-50 saves: snapshot "
          f"p50 {saves['snapshot_p50_s']:.4f} s max {saves['snapshot_max_s']:.4f} s; write "
          f"p50 {saves['write_p50_s']:.3f} s max {saves['write_max_s']:.3f} s on {card}")
    out["step_time"] = times
    out["checkpoint_save_seconds"] = saves
    return net, data, out


def ckpt_train_state(path):
    from deeplearning4j_tpu_torch.utils.model_serializer import read_train_state

    return read_train_state(path)


def zip_phase(torch, fl, DecodeEngine, metrics, ckpt, ms, Evaluation,
              ListDataSetIterator, lstm_net, windows, resnet_net, images, seed, card):
    """7c: save both trained nets, verify, load on the card, compare
    outputs, evaluate, serve the loaded char-LSTM, and fall back past a
    corrupted newest checkpoint."""
    out = {}
    loaded = {}
    for name, net in (("charlstm", lstm_net), ("resnet50", resnet_net)):
        path = os.path.join(CKPT_DIR, f"{name}.zip")
        t0 = time.perf_counter()
        ms.save_model(net, path)
        save_s = time.perf_counter() - t0
        v = ms.verify_checkpoint(path)
        check(v["ok"] and not v["legacy"], f"{name}.zip does not verify: {v}")
        t0 = time.perf_counter()
        back = ms.load_model(path)
        load_s = time.perf_counter() - t0
        check(back.device.type == "cuda", f"{name} loaded on {back.device}")
        mb = os.path.getsize(path) / 1e6
        out[name] = {"zip_mb": mb, "save_s": save_s, "load_s": load_s,
                     "entries": sorted(v["entries"])}
        loaded[name] = back
        print(f"  {name}: zip {mb:.2f} MB, save_model {save_s:.3f} s, verify ok, "
              f"load_model {load_s:.3f} s on {card}")

    # outputs of the loaded nets, bit-equal to the writers'
    x = windows.features[:TRAIN_B, :100]
    k1 = fl.launch_counts()["lstm_sequence"]
    want = lstm_net.output(x)
    got = loaded["charlstm"].output(x)
    torch.cuda.synchronize()
    k1 = fl.launch_counts()["lstm_sequence"] - k1
    check(torch.equal(got, want), "the loaded char-LSTM's output differs from the writer's")
    check(k1 >= 2 * LAYERS, f"output() launched K1 {k1} times for two nets")
    xi = images.features[:RESNET_BATCH]
    check(torch.equal(loaded["resnet50"].output(xi), resnet_net.output(xi)),
          "the loaded ResNet-50's output differs from the writer's")
    print(f"  output() of each loaded zip bit-equal to the writer's ([{TRAIN_B}, 100, "
          f"{VOCAB}] windows, K1 launched; [{RESNET_BATCH}, 224, 224, 3] images)")

    # evaluate() against an Evaluation built in numpy from output()
    it = ListDataSetIterator(images, RESNET_BATCH)
    ev = loaded["resnet50"].evaluate(it)
    ref = Evaluation()
    counts = np.zeros((1000, 1000), np.int64)
    for ds in ListDataSetIterator(images, RESNET_BATCH):
        o = loaded["resnet50"].output(ds.features).cpu().numpy()
        y = ds.labels.cpu().numpy()
        ref.eval_batch(y, o)
        np.add.at(counts, (y.argmax(-1), o.argmax(-1)), 1)
    check(np.array_equal(ev.confusion, ref.confusion) and np.array_equal(ev.confusion, counts)
          and ev.stats() == ref.stats(), "evaluate() differs from the numpy Evaluation")
    print(f"  evaluate() of the loaded ResNet-50 on its {RESUME_BATCHES} batches equals "
          f"the numpy Evaluation of output(): accuracy {ev.accuracy():.4f}, "
          f"{int(ev.confusion.sum())} examples")
    out["evaluate"] = {"accuracy": ev.accuracy(), "examples": int(ev.confusion.sum())}

    # serve the loaded char-LSTM
    rng = np.random.default_rng(seed + 71)
    reqs = [([int(t) for t in rng.integers(0, VOCAB, int(rng.integers(1, 17)))],
             int(rng.integers(8, 25))) for _ in range(DECODE_PROMPTS)]
    want = [greedy_reference(torch, loaded["charlstm"], p, m) for p, m in reqs]
    k2 = fl.launch_counts()["lstm_step"]
    eng = DecodeEngine(loaded["charlstm"], n_slots=8, component_prefix="smoke_zip")
    try:
        got = [f.result(timeout=300) for f in
               [eng.generate(p, max_new_tokens=m) for p, m in reqs]]
    finally:
        eng.shutdown()
    torch.cuda.synchronize()
    k2 = fl.launch_counts()["lstm_step"] - k2
    check(got == want, "the decode engine on the loaded zip differs from the sequential loop")
    check(k2 > 0, "the decode engine on the loaded zip launched no K2")
    print(f"  DecodeEngine(n_slots=8) on the loaded char-LSTM: {DECODE_PROMPTS} requests, "
          f"{sum(len(t) for t in got)} tokens equal to the sequential rnn_time_step "
          f"loop's; K2 launched {k2} times")
    out["decode"] = {"requests": DECODE_PROMPTS, "tokens": sum(len(t) for t in got),
                     "k2_launches": k2}

    # a corrupted newest checkpoint is skipped, counted, and the previous loads
    rdir = os.path.join(CKPT_DIR, "resnet")
    cks = ckpt.scan_checkpoints(rdir)
    check(len(cks) >= 2, f"7b left {cks}")
    newest = os.path.join(rdir, cks[-1][1])
    damaged = ckpt.corrupt_zip_entry(newest)
    fam = metrics.get_registry().counter("checkpoint_integrity_failures_total", "")
    before = fam.labels().value
    net2, meta = ckpt.CheckpointListener.restore_latest(rdir)
    after = fam.labels().value
    load_h = metrics.get_registry().histogram("checkpoint_load_seconds", "").labels()
    check(meta["file"] == cks[-2][1] and net2.iteration == cks[-2][0],
          f"restore_latest took {meta} after {newest} was corrupted")
    check(after == before + 1, f"checkpoint_integrity_failures_total {before} -> {after}")
    print(f"  corrupted {damaged} of {cks[-1][1]}: restore_latest skipped it and loaded "
          f"{meta['file']} (iteration {net2.iteration}); "
          f"checkpoint_integrity_failures_total {before:.0f} -> {after:.0f}; "
          f"checkpoint_load_seconds {load_h.percentile(100):.3f} s on {card}")
    out["corrupt_fallback"] = {"damaged_entry": damaged, "loaded": meta["file"],
                               "integrity_failures": after - before,
                               "checkpoint_load_seconds": load_h.percentile(100)}
    return out


def checkpoint_phase(torch, F, fl, fcb, char_lstm_network, resnet50_network,
                     DecodeEngine, metrics, seed, card):
    """Phase 7: 7a, 7b and 7c in turn, in a scratch directory of the
    checkout that the phase removes at its end."""
    import shutil

    from deeplearning4j_tpu_torch.data import DataSet, DataSetIterator, ListDataSetIterator
    from deeplearning4j_tpu_torch.train import checkpoint as ckpt
    from deeplearning4j_tpu_torch.train.evaluation import Evaluation
    from deeplearning4j_tpu_torch.utils import model_serializer as ms

    shutil.rmtree(CKPT_DIR, ignore_errors=True)
    os.makedirs(CKPT_DIR)
    try:
        fl.reset_launch_counts()
        fcb.reset_launch_counts()
        print("  7a: char-LSTM, kill and resume")
        lstm_net, windows, a = charlstm_resume_phase(
            torch, fl, char_lstm_network, DataSet, DataSetIterator,
            ListDataSetIterator, ckpt, ms, seed)
        print("  7b: ResNet-50, crash and resume")
        resnet_net, images, b = resnet_resume_phase(
            torch, F, fcb, resnet50_network, DataSet, ListDataSetIterator, ckpt,
            metrics, seed, card)
        print("  7c: zip round trip on the card")
        c = zip_phase(torch, fl, DecodeEngine, metrics, ckpt, ms, Evaluation,
                      ListDataSetIterator, lstm_net, windows, resnet_net, images,
                      seed, card)
        torch.cuda.synchronize()
        launches = {**fl.launch_counts(), **fcb.launch_counts()}
    finally:
        shutil.rmtree(CKPT_DIR, ignore_errors=True)
    return {"launches": launches, "charlstm": a, "resnet50": b, "zip": c}


# -- phase 8: the fused dispatch as CUDA graphs ------------------------------------

# 8a: one fused TBPTT program a batch (20 segment steps): the first batch
# warms up eagerly, the second is captured and replayed, the rest replay
FUSED_LSTM_BATCHES = 6
# then set_fused_steps(4): 4 batches (80 steps) a graph, 5 groups (warm-up,
# capture + replay, 3 replays)
FUSED_LSTM_K, FUSED_LSTM_GROUPS = 4, 5
# 8b: ResNet-50 set_fused_steps(2); the hold runs 5 groups (10 steps) on
# 4 batches, the timing 3 repeats of 20 steps each
FUSED_RESNET_K, FUSED_RESNET_BATCHES = 2, 4
FUSED_HOLD_STEPS, FUSED_REPEATS, FUSED_REPEAT_STEPS = 10, 3, 20


class SyncClock:
    """Iterates `batches` `epochs` times and, before handing out each
    batch, synchronises the device and reads the host clock: with prefetch
    off the fit pulls a batch only after dispatching the previous one (or
    the previous fused group of `per`), so the gaps are synced dispatch
    times. With `net`, each fused group's step scores are kept as it
    ends."""

    def __init__(self, torch, DataSetIterator, batches, epochs=1, net=None, per=1):
        self.torch, self.batches, self.epochs = torch, batches, epochs
        self.net, self.per = net, per
        self.times, self.scores = [], []
        self.it = type("Clocked", (DataSetIterator,), {"__iter__": lambda _: self._gen()})()

    def _tick(self):
        self.torch.cuda.synchronize()
        self.times.append(time.perf_counter())
        n = len(self.times) - 1
        if self.net is not None and n and n % self.per == 0:
            self.scores += self.net._fused_scores.tolist()

    def _gen(self):
        for _ in range(self.epochs):
            for b in self.batches:
                self._tick()
                yield b
        self._tick()


def dispatch_times(clock, per):
    """Synced seconds of each dispatch of `per` batches."""
    t = clock.times
    return [t[i + per] - t[i] for i in range(0, len(t) - 1, per)]


def profiled(torch, fn):
    """(device busy seconds, wall seconds, device ms by kernel) of one call
    under torch.profiler, device activity only."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows = {}
    for e in prof.key_averages():
        ms = getattr(e, "self_device_time_total", 0.0) / 1e3
        if ms > 0:
            rows[e.key[:80]] = rows.get(e.key[:80], 0.0) + ms
    return sum(rows.values()) / 1e3, wall, rows


def tensors_equal(torch, a, b) -> bool:
    from deeplearning4j_tpu_torch.utils.model_serializer import tree_leaves

    la, lb = tree_leaves(a), tree_leaves(b)
    return len(la) == len(lb) and all(torch.equal(x, y) for x, y in zip(la, lb))


def nets_equal(torch, a, b) -> bool:
    """Parameters, updater state and layer state, bit for bit."""
    return all(tensors_equal(torch, getattr(a, n), getattr(b, n))
               for n in ("params_list", "upd_state", "state_list"))


def quantiles(xs) -> dict:
    return {"p50": float(np.percentile(xs, 50)), "p99": float(np.percentile(xs, 99)),
            "n": len(xs)}


def fused_lstm_phase(torch, fl, char_lstm_network, DataSet, ExistingDataSetIterator,
                     DataSetIterator, IterationListener, seed, card):
    """8a: graphed char-LSTM fits against the eager loop."""
    class Scores(IterationListener):
        def __init__(self):
            self.scores = []

        def iteration_done(self, model, iteration, info):
            self.scores.append(info["score"]())

    def network():
        return char_lstm_network(vocab_size=VOCAB, hidden=HIDDEN, layers=LAYERS,
                                 tbptt_length=TBPTT, seed=seed, learning_rate=TRAIN_LR)

    n_seg = TRAIN_T // TBPTT
    out = {}
    for label, k, n_batches in (("tbptt", 1, FUSED_LSTM_BATCHES),
                                ("fused4", FUSED_LSTM_K, FUSED_LSTM_K * FUSED_LSTM_GROUPS)):
        data = corpus_batches(DataSet, seed + 80 + k, n_batches)
        eager, graphed = network(), network().set_fused_steps(k)
        log = Scores()
        eager.set_listeners(log)
        eager.set_fused_steps(k)  # a listener keeps the loop: the switch under test
        walls, per_group = {}, []
        for name, net in (("eager", eager), ("graphed", graphed)):
            clock = SyncClock(torch, DataSetIterator, data,
                              net=net if name == "graphed" else None, per=k)
            before = fl.launch_counts()
            net.fit(clock.it, async_prefetch=False)
            per_group.append({n: v - before[n] for n, v in fl.launch_counts().items()})
            walls[name] = dispatch_times(clock, k)
        eager_scores = [float(s) for s in log.scores]
        steps = n_batches * n_seg
        check(eager.iteration == graphed.iteration == steps,
              f"8a {label}: iterations {eager.iteration} / {graphed.iteration}, "
              f"expected {steps}")
        same = (nets_equal(torch, eager, graphed) and eager_scores == clock.scores
                and torch.equal(eager._score, graphed._score))
        [prog] = [p for p in graphed._programs.values()]
        tally = prog.lstm_launches
        want = {"lstm_sequence": LAYERS * n_seg * k,
                "lstm_sequence_backward": LAYERS * n_seg * k}
        check(same, f"8a {label}: graphed fit differs from the eager loop")
        check(tally == want, f"8a {label}: launches per replay {tally}, expected {want}")
        check(per_group[0] == per_group[1],
              f"8a {label}: launches eager {per_group[0]} vs graphed {per_group[1]}")
        info = graphed.fit_graphs()[0]
        # dispatches from the third on are replays (1 warm-up, 1 capture)
        e_t, g_t = walls["eager"][2:], walls["graphed"][2:]
        tokens = k * TRAIN_B * TRAIN_T
        rec = {"k": k, "steps_per_dispatch": k * n_seg, "bit_equal": same,
               "launches_per_replay": tally, "eager_dispatch_s": quantiles(e_t),
               "graphed_dispatch_s": quantiles(g_t),
               "eager_tokens_per_s": tokens / statistics.median(e_t),
               "graphed_tokens_per_s": tokens / statistics.median(g_t),
               "warmup_s": walls["graphed"][0], "capture_and_replay_s": walls["graphed"][1],
               "capture_s": info["capture_seconds"], "pool_bytes": info["pool_bytes"],
               "replays": info["replays"]}
        print(f"  8a {label}: {k * n_seg} steps a dispatch ({k} x [{TRAIN_B}, {TRAIN_T}, "
              f"{VOCAB}]); graphed vs eager bit-equal {same} (scores, params, RMSProp r); "
              f"launches per replay {tally}")
        print(f"    synced dispatch p50/p99: eager {rec['eager_dispatch_s']['p50']:.4f} / "
              f"{rec['eager_dispatch_s']['p99']:.4f} s, graphed "
              f"{rec['graphed_dispatch_s']['p50']:.4f} / {rec['graphed_dispatch_s']['p99']:.4f}"
              f" s over {len(g_t)} dispatches of {k * n_seg} steps; tokens/s eager "
              f"{rec['eager_tokens_per_s']:.0f}, graphed {rec['graphed_tokens_per_s']:.0f}; "
              f"capture {info['capture_seconds']:.3f} s, graph pool "
              f"{info['pool_bytes'] / 2 ** 20:.1f} MiB, on {card}")
        # the busy share: one more dispatch each, under the profiler
        nxt = corpus_batches(DataSet, seed + 90 + k, k)
        for name, net in (("eager", eager), ("graphed", graphed)):
            busy, wall, rows = profiled(torch, lambda: net.fit(
                ExistingDataSetIterator(nxt), async_prefetch=False))
            rec[f"{name}_profiled"] = {"device_s": busy, "wall_s": wall,
                                       "busy_share": busy / wall,
                                       "device_ms_per_step": busy * 1e3 / (k * n_seg)}
            print(f"    {name} dispatch under the profiler: device {busy * 1e3:.2f} ms of "
                  f"{wall * 1e3:.2f} ms wall, busy {busy / wall:.3f}, "
                  f"{busy * 1e3 / (k * n_seg):.3f} ms of device a step")
            if name == "graphed":
                kernels = [n for n in rows if "cluster_kernel" in n]
                check(len(kernels) >= 2, f"8a {label}: no cluster kernels in the "
                                         f"replay's profile: {sorted(rows)[:20]}")
        out[label] = rec
        del eager, graphed
    return out


def fused_resnet_phase(torch, F, fcb, resnet50_network, DataSet, ExistingDataSetIterator,
                       DataSetIterator, IterationListener, seed, card):
    """8b: ResNet-50 set_fused_steps(2), graphed against eager."""
    class Scores(IterationListener):
        def __init__(self):
            self.scores = []

        def iteration_done(self, model, iteration, info):
            self.scores.append(info["score"]())

    g = torch.Generator(device="cuda").manual_seed(seed + 85)
    data = []
    for _ in range(FUSED_RESNET_BATCHES):
        x = torch.randn((RESNET_BATCH, 224, 224, 3), generator=g, device="cuda")
        lab = torch.randint(0, 1000, (RESNET_BATCH,), generator=g, device="cuda")
        data.append(DataSet(x, F.one_hot(lab, 1000).float()))
    k = FUSED_RESNET_K
    det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        def network():
            return resnet50_network(precision="bf16", seed=seed, learning_rate=RESNET_LR)

        eager, graphed = network(), network().set_fused_steps(k)
        log = Scores()
        eager.set_listeners(log)
        epochs = FUSED_HOLD_STEPS // FUSED_RESNET_BATCHES + 1
        hold = (data * epochs)[:FUSED_HOLD_STEPS]
        launches = []
        for net in (eager, graphed):
            clock = SyncClock(torch, DataSetIterator, hold,
                              net=net if net is graphed else None, per=k)
            before = fcb.launch_counts()
            net.fit(clock.it, async_prefetch=False)
            launches.append({n: v - before[n] for n, v in fcb.launch_counts().items()})
        same = (nets_equal(torch, eager, graphed)
                and [float(s) for s in log.scores] == clock.scores)
        [prog] = list(graphed._programs.values())
        want = {n: per * k for n, per in resnet_per_step(RESNET_BATCH).items()}
        check(same, "8b: graphed ResNet-50 differs from the eager loop (scores, params, "
                    "Nesterovs v or BN statistics)")
        check(prog.conv_launches == want,
              f"8b: launches per replay {prog.conv_launches}, expected {want}")
        check(launches[0] == launches[1], f"8b: launches eager {launches[0]} vs graphed "
                                          f"{launches[1]}")
        info = graphed.fit_graphs()[0]
        print(f"  8b: ResNet-50 bf16 batch {RESNET_BATCH}, set_fused_steps({k}), "
              f"{FUSED_HOLD_STEPS} steps: graphed vs eager bit-equal {same} (scores, params, "
              f"Nesterovs v, BN statistics; cudnn.deterministic); launches per replay "
              f"{prog.conv_launches}")
        rec = {"k": k, "bit_equal": same, "launches_per_replay": prog.conv_launches,
               "capture_s": info["capture_seconds"], "pool_bytes": info["pool_bytes"]}
        for name, net, per in (("eager", eager, 1), ("graphed", graphed, k)):
            step_s = []
            walls = []
            for _ in range(FUSED_REPEATS):
                clock = SyncClock(torch, DataSetIterator, data,
                                  FUSED_REPEAT_STEPS // FUSED_RESNET_BATCHES)
                net.fit(clock.it, async_prefetch=False)
                step_s += [t / per for t in dispatch_times(clock, per)]
                walls.append(clock.times[-1] - clock.times[0])
            rec[f"{name}_step_s"] = quantiles(step_s)
            rec[f"{name}_images_per_s"] = [FUSED_REPEAT_STEPS * RESNET_BATCH / w for w in walls]
            busy, wall, _ = profiled(torch, lambda: net.fit(
                ExistingDataSetIterator(data[:k]), async_prefetch=False))
            rec[f"{name}_profiled"] = {"device_s": busy, "wall_s": wall,
                                       "busy_share": busy / wall,
                                       "device_ms_per_step": busy * 1e3 / k}
            print(f"    {name}: step p50 {rec[f'{name}_step_s']['p50']:.4f} s p99 "
                  f"{rec[f'{name}_step_s']['p99']:.4f} s (host clock, synced at each "
                  f"dispatch, {FUSED_REPEATS} repeats of {FUSED_REPEAT_STEPS} steps); images/s "
                  f"{' '.join(f'{v:.0f}' for v in rec[f'{name}_images_per_s'])}; under the "
                  f"profiler {busy * 1e3 / k:.2f} ms of device a step, busy {busy / wall:.3f}")
        print(f"    capture {info['capture_seconds']:.3f} s, graph pool "
              f"{info['pool_bytes'] / 2 ** 30:.2f} GiB, peak allocated "
              f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB, on {card}")
        rec["max_memory_allocated"] = torch.cuda.max_memory_allocated()
        del eager, graphed
    finally:
        torch.backends.cudnn.deterministic = det
    return rec


def fused_prefetch_phase(torch, char_lstm_network, DataSet, ListDataSetIterator, seed, card):
    """8c: the graphed char-LSTM fit with the device prefetch pipeline on
    and off, from the same start: bit-equal, and each one's tokens/s."""
    data = corpus_batches(DataSet, seed + 95, FUSED_LSTM_BATCHES)
    merged = DataSet(np.concatenate([d.features for d in data]),
                     np.concatenate([d.labels for d in data]))
    nets, rates = {}, {}
    for prefetch in (False, True, False, True):
        net = char_lstm_network(vocab_size=VOCAB, hidden=HIDDEN, layers=LAYERS,
                                tbptt_length=TBPTT, seed=seed, learning_rate=TRAIN_LR)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        net.fit(ListDataSetIterator(merged, TRAIN_B), async_prefetch=prefetch)
        torch.cuda.synchronize()
        rates.setdefault(prefetch, []).append(
            FUSED_LSTM_BATCHES * TRAIN_B * TRAIN_T / (time.perf_counter() - t0))
        nets.setdefault(prefetch, net)
    same = nets_equal(torch, nets[False], nets[True]) and torch.equal(
        nets[False]._score, nets[True]._score)
    check(same, "8c: the fit with prefetch on differs from prefetch off")
    print(f"  8c: graphed char-LSTM, {FUSED_LSTM_BATCHES} host batches, prefetch on vs off "
          f"bit-equal {same}; tokens/s (whole fit, warm-up and capture included; off, on, "
          f"off, on) {rates[False][0]:.0f} {rates[True][0]:.0f} {rates[False][1]:.0f} "
          f"{rates[True][1]:.0f} on {card}")
    return {"bit_equal": same, "tokens_per_s": {"off": rates[False], "on": rates[True]}}


# -- phase 9: LeNet, the second layer slice, VGG16 via Keras, transfer ------

LENET_BATCH, LENET_CHECK_STEPS, LENET_STEPS = 64, 5, 100
# card vs CPU from the same parameters, f32 with TF32 off: the same
# expressions summed in another order, over 5 Nesterovs steps
LENET_RTOL = 1e-4
# the new layers at small widths, card vs CPU, f32 (TF32 off): forwards and
# parameter gradients to LAYER_RTOL of each tensor's largest entry;
# pretraining scores over 5 steps to LAYER_RTOL relative
LAYER_RTOL = 1e-4
PRETRAIN_STEPS = 5
VGG_OUT_BATCH, VGG_BATCH, VGG_BATCHES, VGG_EPOCHS = 2, 32, 2, 5
# VGG16 output() in f32, card vs CPU port: 13 convs and 3 dense layers
# summed in another order, softmax outputs over 1000 classes
VGG_OUT_RTOL, VGG_OUT_ATOL = 1e-4, 1e-7
# EditLastLayerOthersFrozen (dl4j-examples): freeze through fc2 (Keras
# dense_2), a new 5-class head, Nesterovs lr 5e-5, batch 15
TRANSFER_CLASSES, TRANSFER_BATCH, TRANSFER_BATCHES, TRANSFER_EPOCHS = 5, 15, 2, 5
TRANSFER_LR = 5e-5
# featurize + fit_featurized against the full fine-tune: the same ops on
# the same features; room for a cuDNN algorithm that differs between calls
HELPER_RTOL = 1e-4
# ResNet-50 under GraphTransferLearning: freeze through stage 3's last
# block, a new 5-class head, batch 32, the fine-tune of the VGG16 flow
# (Nesterovs lr 5e-5; at the source's lr 0.01 the new head's score rose
# from 2.6 to 26 in 4 steps on an H100, with the kernels on and off alike)
RESNET_TRANSFER_FREEZE = "s2b5_relu"
RESNET_TRANSFER_STEPS, RESNET_TRANSFER_BATCH = 4, 32
PHASE9_IMAGE = 224  # VGG16's and ResNet-50's image side in phase 9


class LaunchCounts:
    """Every kernel wrapper's launch count (LSTM and conv/BN), reset and
    read together."""

    def __init__(self, fl, fcb):
        self.fl, self.fcb = fl, fcb

    def reset(self):
        self.fl.reset_launch_counts()
        self.fcb.reset_launch_counts()

    def read(self) -> dict:
        return {**self.fl.launch_counts(), **self.fcb.launch_counts()}


def frozen_snapshot(net):
    """Clones of every frozen layer's parameters, updater state and layer
    state."""
    idx = [i for i, ks in enumerate(net._trainable_keys()) if not ks and net.params_list[i]]
    return idx, [({k: v.clone() for k, v in net.params_list[i].items()},
                  {k: {n: t.clone() for n, t in s.items()} for k, s in net.upd_state[i].items()},
                  None if net.state_list[i] is None
                  else {k: v.clone() for k, v in net.state_list[i].items()}) for i in idx]


def frozen_unchanged(torch, net, snap) -> bool:
    idx, saved = snap
    for i, (p, u, s) in zip(idx, saved):
        if not all(torch.equal(net.params_list[i][k], v) for k, v in p.items()):
            return False
        if not all(torch.equal(net.upd_state[i][k][n], t)
                   for k, st in u.items() for n, t in st.items()):
            return False
        if s is not None and not all(torch.equal(net.state_list[i][k], v)
                                     for k, v in s.items()):
            return False
    return True


def score_log(IterationListener, torch, clock=False):
    class Scores(IterationListener):
        def __init__(self):
            self.scores, self.times = [], [time.perf_counter()]

        def iteration_done(self, model, iteration, info):
            if clock:
                torch.cuda.synchronize()
                self.times.append(time.perf_counter())
            self.scores.append(info["score"]())

        def values(self):
            return [float(s) for s in self.scores]

    return Scores()


def decline_count(metrics, reason) -> float:
    """conv_declined_total{reason=...} summed over the conv families: the
    conv/BN kernel's structural declines (ops/fused_conv_bn.conv_decision)."""
    return sum(v for k, v in metrics.get_registry().scalar_values().items()
               if k.startswith("conv_declined_total{") and f'reason="{reason}"' in k)


def lenet_phase(torch, counts, metrics, IterationListener, SyncClockIt, seed, card):
    """9a: LeNet (dl4j-examples LenetMnistExample) at full width on
    synthetic MNIST: 5 scores held to the CPU port, then 100 steps timed."""
    from deeplearning4j_tpu_torch.data import ExistingDataSetIterator
    from deeplearning4j_tpu_torch.data.mnist import MnistDataFetcher, MnistDataSetIterator
    from deeplearning4j_tpu_torch.models.lenet import lenet_network

    # no cache is read: the synthetic digits, whatever the host holds
    os.environ["DL4J_TPU_DATA"] = os.path.join(HERE, "_no_mnist_cache")
    it = MnistDataSetIterator(LENET_BATCH, train=True, seed=seed,
                              num_examples=LENET_BATCH * LENET_STEPS,
                              fetcher=MnistDataFetcher(allow_download=False))
    check(it.source == "synthetic", f"9a: MNIST source {it.source}, expected synthetic")
    batches = list(it)
    card_net = lenet_network(seed=seed)
    cpu_net = lenet_network(seed=seed, device="cpu")
    check(all(torch.equal(a[k].cpu(), b[k]) for a, b in zip(card_net.params_list,
                                                             cpu_net.params_list) for k in a),
          "9a: the card and CPU nets start from different parameters")
    logs = []
    for net in (card_net, cpu_net):
        log = score_log(IterationListener, torch)
        net.set_listeners(log)
        net.fit(ExistingDataSetIterator(batches[:LENET_CHECK_STEPS]), async_prefetch=False)
        net.set_listeners()
        logs.append(log.values())
    rel = max(abs(a - b) / abs(b) for a, b in zip(*logs))
    check(rel <= LENET_RTOL, f"9a: card vs CPU scores part by {rel:.2e} > {LENET_RTOL}")
    print(f"  9a LeNet: first {LENET_CHECK_STEPS} scores card {' '.join(f'{s:.5f}' for s in logs[0])}"
          f"; vs the CPU port max rel {rel:.2e} (tolerance {LENET_RTOL})")
    # 100 steps on the card, synced at each step
    net = lenet_network(seed=seed)
    counts.reset()
    bias0 = decline_count(metrics, "bias")
    clock = SyncClockIt(batches)
    log = score_log(IterationListener, torch)
    net.set_listeners(log)
    net.fit(clock.it, async_prefetch=False)
    steps = dispatch_times(clock, 1)
    scores = log.values()
    check(len(scores) == LENET_STEPS and all(math.isfinite(s) for s in scores),
          "9a: LeNet scores are not all finite")
    check(statistics.mean(scores[-10:]) < statistics.mean(scores[:10]),
          f"9a: LeNet's score did not fall ({scores[0]:.4f} -> {scores[-1]:.4f})")
    launched = counts.read()
    bias = decline_count(metrics, "bias") - bias0
    check(sum(launched.values()) == 0, f"9a: conv/BN kernels launched {launched}")
    check(bias == 2 * LENET_STEPS, f"9a: {bias} bias declines, expected {2 * LENET_STEPS}")
    net.set_listeners()
    wall = clock.times[-1] - clock.times[0]
    busy, pwall, _ = profiled(torch, lambda: net.fit(
        ExistingDataSetIterator(batches[:10]), async_prefetch=False))
    rec = {"source": it.source, "card_vs_cpu_rel": rel, "scores_card": logs[0],
           "scores_cpu": logs[1], "first_score": scores[0], "last_score": scores[-1],
           "step_s": quantiles(steps), "images_per_s": LENET_STEPS * LENET_BATCH / wall,
           "busy_share": busy / pwall, "device_ms_per_step": busy * 1e3 / 10,
           "launches": launched, "bias_declines": bias}
    print(f"  9a LeNet fit {LENET_STEPS} steps of batch {LENET_BATCH}: score {scores[0]:.4f} -> "
          f"{scores[-1]:.4f}; step p50 {rec['step_s']['p50'] * 1e3:.3f} ms p99 "
          f"{rec['step_s']['p99'] * 1e3:.3f} ms (synced each step); images/s "
          f"{rec['images_per_s']:.0f}; 10 steps under the profiler: busy {busy / pwall:.3f}, "
          f"{busy * 1e3 / 10:.3f} ms of device a step; conv/BN kernels 0 (conv_decision "
          f"'bias': {bias:.0f} declines), on {card}")
    return rec


def _close_rel(torch, a, b) -> float:
    """max |a - b| over max |b| (1 when b is all zero)."""
    a, b = a.detach().double().cpu(), b.detach().double().cpu()
    scale = max(float(b.abs().max()), 1e-30) if b.numel() else 1.0
    return float((a - b).abs().max()) / scale if b.numel() else 0.0


def layers_phase(torch, seed, card):
    """9b: the ten new layer confs at small widths and AE / VAE / RBM
    pretraining, card against CPU."""
    from deeplearning4j_tpu_torch.nn.conf import layers as L
    from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
    from deeplearning4j_tpu_torch.nn.conf.network import NeuralNetConfiguration
    from deeplearning4j_tpu_torch.nn.layers.registry import (
        LayerContext, forward_layer, init_layer_params, init_layer_state)
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork, pretrain_noise

    g = torch.Generator().manual_seed(seed + 900)
    mask = torch.ones(4, 9)
    mask[1, 5:] = 0.0
    cases = {
        "Convolution1DLayer": (L.Convolution1DLayer(n_in=6, n_out=8, kernel_size=3, stride=2,
                                                    convolution_mode="same",
                                                    activation="relu"), (4, 9, 6), None),
        "Subsampling1DLayer": (L.Subsampling1DLayer(pooling_type="max", kernel_size=2,
                                                    stride=2), (4, 9, 6), None),
        "ZeroPaddingLayer": (L.ZeroPaddingLayer(padding=(1, 2, 0, 3)), (4, 7, 7, 5), None),
        "GlobalPoolingLayer (masked)": (L.GlobalPoolingLayer(pooling_type="avg"),
                                        (4, 9, 6), mask),
        "LocalResponseNormalization": (L.LocalResponseNormalization(n=4.0, alpha=1e-2),
                                       (4, 7, 7, 16), None),
        "AutoEncoder": (L.AutoEncoder(n_in=12, n_out=8, activation="sigmoid"), (4, 12), None),
        "CenterLossOutputLayer": (L.CenterLossOutputLayer(n_in=12, n_out=5,
                                                          activation="softmax"), (4, 12), None),
        "FrozenLayer": (L.FrozenLayer(inner=L.BatchNormalization(n_in=12)), (4, 12), None),
        "VariationalAutoencoder": (L.VariationalAutoencoder(
            n_in=12, n_out=4, encoder_layer_sizes=[10], decoder_layer_sizes=[10],
            activation="tanh"), (4, 12), None),
        "SelfAttentionLayer": (L.SelfAttentionLayer(n_in=6, n_out=8, n_heads=2, causal=True,
                                                    activation="identity"), (4, 9, 6), mask),
        "RBM": (L.RBM(n_in=12, n_out=8, activation="sigmoid"), (4, 12), None),
    }
    out = {}
    for name, (conf, shape, m) in cases.items():
        if getattr(conf, "weight_init", None) is None and hasattr(conf, "weight_init"):
            conf.weight_init = "xavier"
        params = init_layer_params(torch.Generator().manual_seed(seed), conf, torch.float32)
        state = init_layer_state(conf, torch.float32)
        if state is not None and "var" in state:
            state = {"mean": torch.randn(state["mean"].shape, generator=g) * 0.1,
                     "var": torch.rand(state["var"].shape, generator=g) + 0.5}
        x = torch.randn(shape, generator=g)
        res = {}
        for dev in ("cpu", "cuda"):
            p = {k: v.to(dev).requires_grad_() for k, v in params.items()}
            xx = x.to(dev).requires_grad_()
            ctx = LayerContext(training=True, mask=None if m is None else m.to(dev),
                               state=None if state is None
                               else {k: v.to(dev) for k, v in state.items()})
            y, _ = forward_layer(conf, p, xx, ctx)
            cot = torch.randn(y.shape, generator=torch.Generator().manual_seed(seed + 1))
            names = list(p)
            gr = torch.autograd.grad((y * cot.to(dev)).sum(), [xx] + [p[k] for k in names],
                                     allow_unused=True)
            res[dev] = [y] + [torch.zeros_like(t) if d is None else d
                              for t, d in zip([xx] + [p[k] for k in names], gr)]
        err = max(_close_rel(torch, a, b) for a, b in zip(res["cuda"], res["cpu"]))
        check(err <= LAYER_RTOL, f"9b {name}: card vs CPU {err:.2e} > {LAYER_RTOL}")
        out[name] = err
    print(f"  9b layers card vs CPU (forward, input and parameter gradients, f32; tolerance "
          f"{LAYER_RTOL} of each tensor's largest entry): "
          + ", ".join(f"{k} {v:.1e}" for k, v in out.items()))

    pre = {}
    x = torch.rand((32, 12), generator=g)
    for kind, layer in (("AutoEncoder", L.AutoEncoder(n_out=8, activation="sigmoid")),
                        ("VariationalAutoencoder", L.VariationalAutoencoder(
                            n_out=4, encoder_layer_sizes=[10], decoder_layer_sizes=[10],
                            activation="tanh", num_samples=2)),
                        ("RBM", L.RBM(n_out=8, activation="sigmoid", k=2))):
        data = (x > 0.5).float() if kind == "RBM" else x
        conf = (NeuralNetConfiguration.builder().seed(seed).updater("adam")
                .learning_rate(0.01).weight_init("xavier").list().layer(layer)
                .layer(L.OutputLayer(n_out=3, activation="softmax"))
                .set_input_type(InputType.feed_forward(12)).build())
        noise = {}

        def hook(idx, it, x_in, conf=conf):
            key = (idx, it)
            if key not in noise:  # drawn once on the CPU, fed to both devices
                noise[key] = pretrain_noise(conf.layers[idx], x_in.cpu(),
                                            torch.Generator().manual_seed(seed * 31 + it))
            return noise[key].to(x_in.device)

        scores = {}
        for dev in ("cpu", "cuda"):
            net = MultiLayerNetwork(conf, device=dev).init()
            got, step = [], net._pretrain_step

            def recorded(*a, step=step, got=got):
                s = step(*a)
                got.append(float(s))
                return s

            net._pretrain_step = recorded
            net.pretrain_layer(0, data.numpy(), epochs=PRETRAIN_STEPS, batch_size=32,
                               noise=hook)
            scores[dev] = got
        rel = max(abs(a - b) / abs(b) for a, b in zip(scores["cuda"], scores["cpu"]))
        check(len(scores["cuda"]) == PRETRAIN_STEPS and rel <= LAYER_RTOL,
              f"9b pretrain {kind}: card vs CPU scores {rel:.2e} > {LAYER_RTOL}")
        pre[kind] = {"scores_card": scores["cuda"], "rel": rel}
    print(f"  9b pretraining, {PRETRAIN_STEPS} steps each with the same noise, card vs CPU "
          f"scores: " + ", ".join(f"{k} {v['scores_card'][0]:.4f}->{v['scores_card'][-1]:.4f} "
                                   f"(rel {v['rel']:.1e})" for k, v in pre.items()))
    return {"layers": out, "pretrain": pre}


def vgg_batches(torch, F, DataSet, seed, n, b, classes):
    g = torch.Generator(device="cuda").manual_seed(seed)
    out = []
    for _ in range(n):
        x = torch.randn((b, PHASE9_IMAGE, PHASE9_IMAGE, 3), generator=g, device="cuda")
        lab = torch.randint(0, classes, (b,), generator=g, device="cuda")
        out.append(DataSet(x, F.one_hot(lab, classes).float()))
    return out


def vgg_phase(torch, F, counts, metrics, DataSet, IterationListener, SyncClockIt, seed,
              card):
    """9c: VGG16 through the port's Keras importer at full width: output()
    card vs CPU in f32, 10 bf16 steps, then the EditLastLayerOthersFrozen
    transfer flow, eager, fused and featurized."""
    from deeplearning4j_tpu_torch.data import ExistingDataSetIterator
    from deeplearning4j_tpu_torch.models.vgg16 import vgg16_network
    from deeplearning4j_tpu_torch.nn.transferlearning import (
        TransferLearning, TransferLearningHelper)

    rec = {}
    # output() at batch 2, an f32 build on the card against the CPU port
    card32 = vgg16_network(image_size=PHASE9_IMAGE, precision="f32", seed=seed)
    cpu32 = vgg16_network(image_size=PHASE9_IMAGE, precision="f32", seed=seed, device="cpu")
    x = torch.rand((VGG_OUT_BATCH, PHASE9_IMAGE, PHASE9_IMAGE, 3),
                   generator=torch.Generator().manual_seed(seed))
    ya, yb = card32.output(x).cpu(), cpu32.output(x)
    ok = bool(torch.allclose(ya, yb, rtol=VGG_OUT_RTOL, atol=VGG_OUT_ATOL))
    err = float((ya - yb).abs().max())
    check(ok and ya.shape == (VGG_OUT_BATCH, 1000) and bool(torch.isfinite(ya).all()),
          f"9c: VGG16 output() card vs CPU max |diff| {err:.2e} (rtol {VGG_OUT_RTOL}, "
          f"atol {VGG_OUT_ATOL})")
    rec["output_card_vs_cpu_max_abs"] = err
    print(f"  9c VGG16 (Keras import) output() f32 batch {VGG_OUT_BATCH}: card vs CPU port max "
          f"|diff| {err:.2e} (rtol {VGG_OUT_RTOL}, atol {VGG_OUT_ATOL}); "
          f"{sum(v.numel() for p in card32.params_list for v in p.values()) / 1e6:.1f}M params")
    del card32, cpu32
    torch.cuda.empty_cache()

    # 10 steps at batch 32, bf16, on 2 batches
    net = vgg16_network(image_size=PHASE9_IMAGE, seed=seed)
    data = vgg_batches(torch, F, DataSet, seed + 91, VGG_BATCHES, VGG_BATCH, 1000)
    counts.reset()
    bias0 = decline_count(metrics, "bias")
    clock = SyncClockIt(data, VGG_EPOCHS)
    log = score_log(IterationListener, torch)
    net.set_listeners(log)
    net.fit(clock.it, async_prefetch=False)
    net.set_listeners()
    scores = log.values()
    steps = VGG_BATCHES * VGG_EPOCHS
    check(len(scores) == steps and all(math.isfinite(s) for s in scores),
          f"9c: VGG16 scores {scores}")
    check(scores[-VGG_BATCHES] < scores[0],
          f"9c: batch 0's score did not fall ({scores[0]:.5f} -> {scores[-VGG_BATCHES]:.5f})")
    launched = counts.read()
    bias = decline_count(metrics, "bias") - bias0
    check(sum(launched.values()) == 0, f"9c: conv/BN kernels launched {launched}")
    check(bias == 13 * steps, f"9c: {bias} bias declines, expected {13 * steps}")
    st = dispatch_times(clock, 1)
    rec["train"] = {"scores": scores, "step_s": quantiles(st[1:]), "first_step_s": st[0],
                    "images_per_s": VGG_BATCH * (steps - 1) / sum(st[1:]),
                    "launches": launched, "bias_declines": bias}
    print(f"  9c VGG16 bf16 batch {VGG_BATCH}, {steps} SGD steps (lr "
          f"{net.net_conf.learning_rate}): batch 0 score {scores[0]:.5f} -> "
          f"{scores[-VGG_BATCHES]:.5f}; step p50 {rec['train']['step_s']['p50'] * 1e3:.2f} ms "
          f"p99 {rec['train']['step_s']['p99'] * 1e3:.2f} ms after the first "
          f"({st[0]:.2f} s); images/s {rec['train']['images_per_s']:.0f}; conv/BN kernels 0 "
          f"(conv_decision 'bias': {bias:.0f} declines), on {card}")

    # EditLastLayerOthersFrozen: freeze through fc2, a new 5-class head
    names = [c.name for c in net.layer_confs]
    fc2, head = names.index("dense_2"), len(names) - 1

    def transfer():
        return (TransferLearning.Builder(net)
                .fine_tune_configuration(updater="nesterovs", learning_rate=TRANSFER_LR,
                                         momentum=0.9)
                .set_feature_extractor(fc2)
                .n_out_replace(head, TRANSFER_CLASSES, weight_init="xavier").build())

    tdata = vgg_batches(torch, F, DataSet, seed + 92, TRANSFER_BATCHES, TRANSFER_BATCH,
                        TRANSFER_CLASSES)
    tsteps = TRANSFER_BATCHES * TRANSFER_EPOCHS
    out = {}
    for mode in ("eager", "fused"):
        tnet = transfer()
        check(tnet._trainable_keys()[:head] == [[]] * head,
              "9c: the transfer net's layers through fc2 are not all frozen")
        if mode == "fused":
            tnet.set_fused_steps(2)
        snap = frozen_snapshot(tnet)
        log = score_log(IterationListener, torch) if mode == "eager" else None
        if log is not None:
            tnet.set_listeners(log)
        clock = SyncClockIt(tdata, TRANSFER_EPOCHS, net=tnet if mode == "fused" else None,
                            per=2 if mode == "fused" else 1)
        tnet.fit(clock.it, async_prefetch=False)
        same = frozen_unchanged(torch, tnet, snap)
        check(same, f"9c: a frozen leaf of the transfer net moved ({mode})")
        sc = log.values() if log is not None else clock.scores
        check(len(sc) == tsteps and all(math.isfinite(s) for s in sc),
              f"9c transfer {mode}: scores {sc}")
        per = 2 if mode == "fused" else 1
        # step seconds: each dispatch over its steps; the fused run's first
        # two dispatches are the eager warm-up and the capture
        st = [t / per for t in dispatch_times(clock, per)][per:]
        out[mode] = {"scores": sc, "frozen_bit_equal": same, "step_s": quantiles(st),
                     "images_per_s": TRANSFER_BATCH * len(st) / sum(st)}
        if mode == "fused":
            out[mode]["graphs"] = tnet.fit_graphs()
    check(max(abs(a - b) / abs(b) for a, b in zip(out["eager"]["scores"],
                                                   out["fused"]["scores"])) <= HELPER_RTOL,
          "9c: the fused transfer's scores part from the eager one's")
    # TransferLearningHelper: featurize once, fit the head on the features
    tnet = transfer()
    helper = TransferLearningHelper(tnet)
    feats = [helper.featurize(d) for d in tdata]
    log = score_log(IterationListener, torch)
    helper.unfrozen_network().set_listeners(log)
    helper.fit_featurized(ExistingDataSetIterator(feats * TRANSFER_EPOCHS))
    hs = log.values()
    rel = max(abs(a - b) / abs(b) for a, b in zip(hs, out["eager"]["scores"]))
    check(len(hs) == tsteps and rel <= HELPER_RTOL,
          f"9c: featurize + fit_featurized scores part from the full fine-tune's by {rel:.2e}")
    out["helper"] = {"scores": hs, "rel_vs_full": rel,
                     "feature_shape": list(feats[0].features.shape)}
    rec["transfer"] = out
    print(f"  9c EditLastLayerOthersFrozen (freeze through dense_2 = fc2, {TRANSFER_CLASSES}-class "
          f"head, Nesterovs lr {TRANSFER_LR}, batch {TRANSFER_BATCH}, {tsteps} steps): frozen "
          f"leaves bit-equal eager {out['eager']['frozen_bit_equal']}, set_fused_steps(2) "
          f"{out['fused']['frozen_bit_equal']}; score {out['eager']['scores'][0]:.5f} -> "
          f"{out['eager']['scores'][-1]:.5f}; step p50 eager "
          f"{out['eager']['step_s']['p50'] * 1e3:.2f} ms, graphed "
          f"{out['fused']['step_s']['p50'] * 1e3:.2f} ms; featurize + fit_featurized vs the "
          f"full fine-tune scores rel {rel:.1e}, on {card}")
    del net, tnet, helper
    torch.cuda.empty_cache()
    return rec


def resnet_transfer_phase(torch, F, counts, helpers, metrics, DataSet, IterationListener,
                          SyncClockIt, seed, card):
    """9d: ResNet-50 under GraphTransferLearning: the stem and stages 1-3
    frozen, a new 5-class head; K4-K8 launch for stage 4 only."""
    from deeplearning4j_tpu_torch.models.resnet import resnet50_network
    from deeplearning4j_tpu_torch.nn.conf import layers as L
    from deeplearning4j_tpu_torch.nn.transferlearning import GraphTransferLearning

    def build(precision):
        src = resnet50_network(image_size=PHASE9_IMAGE, precision=precision, seed=seed,
                               learning_rate=RESNET_LR)
        return (GraphTransferLearning(src)
                .fine_tune_configuration(updater="nesterovs", learning_rate=TRANSFER_LR,
                                         momentum=0.9)
                .set_feature_extractor(RESNET_TRANSFER_FREEZE)
                .n_out_replace("out", TRANSFER_CLASSES, weight_init="xavier").build())

    net = build("bf16")
    convs = {n for n in net.layer_vertex_names
             if isinstance(net.conf.vertices[n].layer, L.ConvolutionLayer)}
    bns = [c for c in net._layer_confs if isinstance(c, L.BatchNormalization)]
    # the unfrozen convs' routing at this batch (the coverage table); each
    # feeds its own unfrozen BN
    want = resnet_per_step(RESNET_TRANSFER_BATCH, "bf16", PHASE9_IMAGE, convs)
    check(want["bn_backward_apply"] == len(bns) == len(convs),
          f"9d: {len(convs)} unfrozen convs, {len(bns)} unfrozen BNs: {want}")
    n_frozen_convs = sum(1 for c in net._layer_confs if isinstance(c, L.FrozenLayer)
                         and isinstance(c.inner, L.ConvolutionLayer))
    marked = sorted(net.relu_fused_bn)
    check(len(marked) == 2 * 3 and all(
        not isinstance(net.conf.vertices[n].layer, L.FrozenLayer) for n in marked),
          f"9d: the fused-ReLU marks are not stage 4's six unfrozen BNs: {marked}")
    data = vgg_batches(torch, F, DataSet, seed + 93, 2, RESNET_TRANSFER_BATCH, TRANSFER_CLASSES)
    snap = frozen_snapshot(net)
    counts.reset()
    inf0 = decline_count(metrics, "inference")
    clock = SyncClockIt(data, RESNET_TRANSFER_STEPS // 2)
    log = score_log(IterationListener, torch)
    net.set_listeners(log)
    net.fit(clock.it, async_prefetch=False)
    net.set_listeners()
    launched = counts.read()
    per_step = {k: want[k] * RESNET_TRANSFER_STEPS for k in want}
    check({k: launched.get(k, 0) for k in want} == per_step,
          f"9d: launches {launched}, expected {per_step} (stage 4 only)")
    inference = decline_count(metrics, "inference") - inf0
    check(inference == n_frozen_convs * RESNET_TRANSFER_STEPS,
          f"9d: {inference} 'inference' declines, expected "
          f"{n_frozen_convs * RESNET_TRANSFER_STEPS} (the frozen convs)")
    same = frozen_unchanged(torch, net, snap)
    check(same, "9d: a frozen leaf of the ResNet-50 transfer net moved")
    scores = log.values()
    check(all(math.isfinite(s) for s in scores), f"9d: scores {scores}")
    st = dispatch_times(clock, 1)
    rec = {"launches": launched, "launches_per_step": want,
           "frozen_convs": n_frozen_convs, "inference_declines": inference,
           "frozen_bit_equal": same, "scores": scores, "step_s": quantiles(st[1:]),
           "images_per_s": RESNET_TRANSFER_BATCH * (len(st) - 1) / sum(st[1:])}
    # fused: frozen leaves bit-equal under set_fused_steps(2) too
    fused = build("bf16").set_fused_steps(2)
    snap = frozen_snapshot(fused)
    fused.fit(SyncClockIt(data, 2).it, async_prefetch=False)
    rec["fused_frozen_bit_equal"] = frozen_unchanged(torch, fused, snap)
    check(rec["fused_frozen_bit_equal"], "9d: a frozen leaf moved under set_fused_steps(2)")
    del fused
    # kernels on vs off, f32 (TF32 off), from the same start: phase 6's
    # holds of one step (the score to RESNET_SCORE_RTOL, the unfrozen BNs'
    # running statistics to RESNET_STATE_RTOL of each tensor's largest
    # entry); two more steps each way show the drift of the ill-conditioned
    # f32 gradient (see LOCKSTEP_BATCH), printed, not held
    on = build("f32")
    off = on.clone()
    d32 = vgg_batches(torch, F, DataSet, seed + 94, 1, RESNET_TRANSFER_BATCH, TRANSFER_CLASSES)
    got, stats = {}, {}
    for name, n in (("on", on), ("off", off)):
        lg = score_log(IterationListener, torch)
        n.set_listeners(lg)
        if name == "off":
            for op in CONV_BN_OPS:
                helpers.set_helper_enabled(op, False)
        try:
            n.fit(SyncClockIt(d32).it, async_prefetch=False)
            stats[name] = [{k: v.clone() for k, v in n.state_list[i].items()}
                           for i, c in enumerate(n._layer_confs)
                           if isinstance(c, L.BatchNormalization)]
            n.fit(SyncClockIt(d32, 2).it, async_prefetch=False)
        finally:
            for op in CONV_BN_OPS:
                helpers.set_helper_enabled(op, True)
        got[name] = lg.values()
    rels = [abs(a - b) / abs(b) for a, b in zip(got["on"], got["off"])]
    state_err = max(_close_rel(torch, a[k], b[k])
                    for a, b in zip(stats["on"], stats["off"]) for k in a)
    check(rels[0] <= RESNET_SCORE_RTOL,
          f"9d: f32 step-1 score kernels on vs off part by {rels[0]:.2e} > {RESNET_SCORE_RTOL}")
    check(state_err <= RESNET_STATE_RTOL,
          f"9d: BN running statistics kernels on vs off part by {state_err:.2e} > "
          f"{RESNET_STATE_RTOL}")
    rec["on_off_f32"] = {"on": got["on"], "off": got["off"], "rel": rels,
                         "bn_state_rel": state_err}
    print(f"  9d ResNet-50 GraphTransferLearning (frozen through {RESNET_TRANSFER_FREEZE}: "
          f"stem and stages 1-3, {n_frozen_convs} frozen convs; {TRANSFER_CLASSES}-class head, "
          f"Nesterovs lr {TRANSFER_LR}), scores {' '.join(f'{v:.4f}' for v in scores)}; "
          f"bf16 batch {RESNET_TRANSFER_BATCH}: launches per step {want} (stage 4 only; the frozen "
          f"convs declined for 'inference' {inference:.0f} times in "
          f"{RESNET_TRANSFER_STEPS} steps); frozen leaves bit-equal eager {same}, fused "
          f"{rec['fused_frozen_bit_equal']}; step p50 {rec['step_s']['p50'] * 1e3:.2f} ms, "
          f"images/s {rec['images_per_s']:.0f}; f32 kernels on vs off from one start: step 1 "
          f"score rel {rels[0]:.1e} (tolerance {RESNET_SCORE_RTOL}), unfrozen BN statistics "
          f"{state_err:.1e} (tolerance {RESNET_STATE_RTOL}); free-running steps 2-3 rel "
          f"{rels[1]:.1e} {rels[2]:.1e} (not held), on {card}")
    del net, on, off
    torch.cuda.empty_cache()
    return rec


# -- phase 10: the divergence sentinel, the line-search solvers, the DL4J
# importer ---------------------------------------------------------------------

SENTINEL_DIR = os.path.join(HERE, "_sentinel_smoke")
SENTINEL_BATCHES = 8
SENTINEL_NAN = (5, 6)     # 1-based dispatches the `nan` fault taints
SENTINEL_SAVE_AFTER = 2   # batches trained when 10a's checkpoint is saved
SENTINEL_RESNET_STEPS = 10
SENTINEL_FUSED_K = 4
SENTINEL_TRANSFER_STEPS = 4
SOLVERS = ("line_gradient_descent", "conjugate_gradient", "lbfgs")
SOLVER_STEPS = 5
SOLVER_RTOL = 1e-4        # card vs CPU, first step, of each tensor's largest entry
# the JAX package's fixture tolerance (tests/test_dl4j_import.py)
IMPORT_RTOL, IMPORT_ATOL = 1e-5, 1e-6
# one Adam step, card vs CPU in f32 (TF32 off): of each tensor's largest entry
IMPORT_STEP_RTOL = 1e-5


def feed(DataSetIterator, DataSet, batches, on_pull=None):
    """An iterator over fresh DataSets of `batches` (the `nan` fault
    re-points a yielded batch's features: a replay must not meet the
    tainted object); `on_pull(i)` runs before batch i is handed out, when
    the previous batch has been dispatched (prefetch off)."""
    def gen(_):
        for i, b in enumerate(batches):
            if on_pull is not None:
                on_pull(i)
            yield DataSet(b.features, b.labels)

    return type("Feed", (DataSetIterator,), {"__iter__": gen})()


def events_of(blackbox, kind, since=0.0):
    """The flight recorder's `kind` events from `since` (time.time(); the
    recorder stamps events to the millisecond)."""
    return [e for e in blackbox.get_recorder().snapshot()["events"]
            if e["kind"] == kind and e["ts"] >= since - 1e-3]


def clone_net_state(torch, net):
    from deeplearning4j_tpu_torch.utils.model_serializer import tree_map

    return [tree_map(lambda t: t.clone(), getattr(net, n))
            for n in ("params_list", "state_list", "upd_state")]


def same_net_state(torch, net, saved) -> bool:
    return all(tensors_equal(torch, getattr(net, n), s)
               for n, s in zip(("params_list", "state_list", "upd_state"), saved))


def sentinel_rollback_phase(torch, fl, char_lstm_network, DataSet, DataSetIterator,
                            metrics, seed, card, device="cuda"):
    """10a: quarantine and rollback on the full-width char-LSTM, its TBPTT
    batches one CUDA graph each."""
    import shutil

    from deeplearning4j_tpu_torch.train.checkpoint import CheckpointListener
    from deeplearning4j_tpu_torch.train.sentinel import DivergenceSentinel
    from deeplearning4j_tpu_torch.utils import blackbox
    from deeplearning4j_tpu_torch.utils import faultpoints as fp

    cuda = device == "cuda"
    data = corpus_batches(DataSet, seed + 100, SENTINEL_BATCHES)
    n_seg = TRAIN_T // TBPTT
    bad = [b - 1 for b in SENTINEL_NAN]
    kept = [i for i in range(SENTINEL_BATCHES) if i not in bad]
    reg = metrics.get_registry()

    def captures():
        return reg.scalar_values().get("fit_graph_captures_total", 0.0)

    def build():
        return char_lstm_network(vocab_size=VOCAB, hidden=HIDDEN, layers=LAYERS,
                                 tbptt_length=TBPTT, seed=seed, learning_rate=TRAIN_LR,
                                 device=device)

    def sync():
        if cuda:
            torch.cuda.synchronize()

    shutil.rmtree(SENTINEL_DIR, ignore_errors=True)
    # the rollback run: no listener, so each batch is one fused program
    net = build()
    saver = CheckpointListener(os.path.join(SENTINEL_DIR, "a"), every_n_epochs=None,
                               keep_last=5)
    st = {"saved": False, "snap": None, "undo": []}

    def on_pull(i):
        if i == SENTINEL_SAVE_AFTER and not st["saved"]:
            saver.save(net, "manual")
            st["saved"] = True
        if i == bad[0] and st["snap"] is None:
            sync()
            st["snap"] = clone_net_state(torch, net)
            st["captures0"] = captures()

    def on_event(kind, payload):
        if kind == "batch_quarantined":
            sync()
            prog = next(iter(net._programs.values()), None)
            st["undo"].append({
                "bit_equal": same_net_state(torch, net, st["snap"]),
                "captures": captures(),
                "addresses_kept": prog is None or prog.graph is None
                or prog.addresses == net._state_addresses()})

    sent = DivergenceSentinel(rollback_after=2, checkpoint_dir=saver.dir, on_event=on_event)
    net.set_sentinel(sent)
    t_ev = time.time()
    fl.reset_launch_counts()
    plan = fp.FaultPlan(seed=1).add("train_step", "nan", between=SENTINEL_NAN)
    sync()
    t0 = time.perf_counter()
    with fp.active(plan):
        net.fit(feed(DataSetIterator, DataSet, data, on_pull), async_prefetch=False)
    sync()
    wall = time.perf_counter() - t0
    launches = fl.launch_counts()
    kinds = collections.Counter(e["kind"] for e in events_of(blackbox, "train_anomaly", t_ev)
                                if e.get("anomaly") == "nonfinite_loss")
    skipped = [e["batch_in_epoch"] for e in events_of(blackbox, "quarantined_batch_skipped", t_ev)]
    resumed = [e["iteration"] for e in events_of(blackbox, "resume", t_ev)]
    check(kinds["train_anomaly"] == 2, f"10a: {kinds['train_anomaly']} nonfinite_loss verdicts, "
          f"expected 2")
    check(sent.quarantined == 2 and sent.rollbacks == 1,
          f"10a: {sent.quarantined} quarantines and {sent.rollbacks} rollbacks, expected 2 and 1")
    check(sorted(skipped) == bad, f"10a: the replay skipped batches {skipped}, expected {bad}")
    check(resumed == [SENTINEL_SAVE_AFTER * n_seg],
          f"10a: the rollback restored iteration {resumed}, expected {SENTINEL_SAVE_AFTER * n_seg}")
    check(len(st["undo"]) == 2 and all(u["bit_equal"] for u in st["undo"]),
          f"10a: an undone step is not bit-equal to the clone taken before it: {st['undo']}")
    check(all(u["captures"] == st["captures0"] and u["addresses_kept"] for u in st["undo"]),
          f"10a: the undo re-captured or moved the graph's tensors: {st['undo']} "
          f"(captures before {st['captures0']})")
    check(net.iteration == len(kept) * n_seg, f"10a: iteration {net.iteration}, expected "
          f"{len(kept) * n_seg}")
    if cuda:
        check(launches.get("lstm_sequence", 0) > 0 and launches.get("lstm_sequence_backward", 0) > 0,
              f"10a: K1/K3 did not launch: {launches}")
    # the clean fit over the kept batches from the same start
    clean = build()
    clean.fit(feed(DataSetIterator, DataSet, [data[i] for i in kept]), async_prefetch=False)
    same = nets_equal(torch, net, clean)
    check(same, "10a: the rollback run is not bit-equal to the clean fit without batches "
          f"{[b + 1 for b in bad]}")
    rec = {"verdicts": kinds["train_anomaly"], "quarantined": sent.quarantined,
           "rollbacks": sent.rollbacks, "skipped": skipped, "restored_iteration": resumed[0],
           "undo": st["undo"], "captures_before_undo": st["captures0"],
           "bit_equal_clean": same, "seconds": wall, "launches": launches,
           "graphs": net.fit_graphs()}
    del net, clean
    # again with a CheckpointListener saving at the end of every batch (each
    # TBPTT batch then takes the per-segment loop): the saves taken during
    # the anomalous steps are rejected
    class BatchEnds(CheckpointListener):
        def iteration_done(self, model, iteration, info):
            if (iteration + 1) % n_seg == 0:
                self.save(model, reason="schedule")

    net = build()
    ck = BatchEnds(os.path.join(SENTINEL_DIR, "b"), every_n_epochs=None,
                   keep_last=SENTINEL_BATCHES)
    net.set_listeners(ck)
    sent = DivergenceSentinel(rollback_after=2)
    net.set_sentinel(sent)
    t_ev = time.time()
    with fp.active(fp.FaultPlan(seed=1).add("train_step", "nan", between=SENTINEL_NAN)):
        net.fit(feed(DataSetIterator, DataSet, data), async_prefetch=False)
    rejected = [e for e in events_of(blackbox, "checkpoint_corrupt", t_ev)
                if e.get("why") == "captured from a quarantined step"]
    resumed_b = [e["iteration"] for e in events_of(blackbox, "resume", t_ev)]
    # both anomalous batches ran from iteration bad[0] * n_seg (the first
    # one's update was undone), so their saves share one iteration
    check(len(rejected) >= 1 and resumed_b == [bad[0] * n_seg],
          f"10a: with a CheckpointListener, {len(rejected)} saves rejected as captured from a "
          f"quarantined step (expected at least 1) and the rollback restored {resumed_b} "
          f"(expected {[bad[0] * n_seg]})")
    check(sorted(sent.tainted_iterations) == list(range(bad[0] * n_seg + 1,
                                                        (bad[0] + 1) * n_seg + 1)),
          f"10a: tainted iterations {sorted(sent.tainted_iterations)}")
    clean = build()
    clean.fit(feed(DataSetIterator, DataSet, [data[i] for i in kept]), async_prefetch=False)
    rec["listener"] = {"rejected": [e["checkpoint"] for e in rejected],
                       "restored_iteration": resumed_b[0],
                       "bit_equal_clean": nets_equal(torch, net, clean)}
    check(rec["listener"]["bit_equal_clean"],
          "10a: the listener run is not bit-equal to the clean fit")
    shutil.rmtree(SENTINEL_DIR, ignore_errors=True)
    print(f"  10a char-LSTM ({TRAIN_B}x{TRAIN_T}, TBPTT {TBPTT}, {SENTINEL_BATCHES} batches, NaN "
          f"at {SENTINEL_NAN}, rollback_after 2, checkpoint after batch {SENTINEL_SAVE_AFTER}): "
          f"{rec['verdicts']} nonfinite_loss verdicts, {rec['quarantined']} quarantines, "
          f"{rec['rollbacks']} rollback to iteration {rec['restored_iteration']}, replay skipped "
          f"batches {[b + 1 for b in skipped]}; undo bit-equal to the clone "
          f"{all(u['bit_equal'] for u in rec['undo'])}, fit_graph_captures_total "
          f"{st['captures0']:.0f} before and {[u['captures'] for u in rec['undo']]} after the "
          f"undos; final params bit-equal to the clean fit {same}; K1/K3 launches "
          f"{launches.get('lstm_sequence', 0)}/{launches.get('lstm_sequence_backward', 0)}; "
          f"{wall:.2f} s; with a CheckpointListener: {len(rejected)} saves rejected as captured "
          f"from a quarantined step, restored iteration {resumed_b[0]}, bit-equal "
          f"{rec['listener']['bit_equal_clean']}, on {card}")
    return rec


def resnet_batches(torch, F, DataSet, seed, n, b, size=224, classes=1000):
    g = torch.Generator(device="cuda").manual_seed(seed)
    out = []
    for _ in range(n):
        x = torch.randn((b, size, size, 3), generator=g, device="cuda")
        lab = torch.randint(0, classes, (b,), generator=g, device="cuda")
        out.append(DataSet(x, F.one_hot(lab, classes).float()))
    return out


def tree_bytes(tree) -> int:
    from deeplearning4j_tpu_torch.utils.model_serializer import tree_leaves

    return sum(t.numel() * t.element_size() for t in tree_leaves(tree))


def sentinel_cost_phase(torch, F, counts, resnet50_network, DataSet, DataSetIterator,
                        seed, card):
    """10b: what the sentinel costs the ResNet-50 step (bf16, batch 128,
    cudnn.deterministic), and the frozen-gradient cost on the phase-9
    transfer net."""
    from deeplearning4j_tpu_torch.data import ExistingDataSetIterator
    from deeplearning4j_tpu_torch.train import sentinel as sentinel_mod
    from deeplearning4j_tpu_torch.train.sentinel import DivergenceSentinel

    det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        data = resnet_batches(torch, F, DataSet, seed + 110, 2, RESNET_BATCH)
        # off, on, on, off: the host's drift between runs shows as the gap
        # between the two runs of one kind
        runs, nets, by_kernel = {}, {}, {}
        for name in ("off", "on", "on2", "off2"):
            net = resnet50_network(precision="bf16", seed=seed, learning_rate=RESNET_LR)
            if name.startswith("on"):
                net.set_sentinel(DivergenceSentinel())
            clock = SyncClock(torch, DataSetIterator, data, SENTINEL_RESNET_STEPS // 2)
            counts.reset()
            net.fit(clock.it, async_prefetch=False)
            launched = counts.read()
            st = dispatch_times(clock, 1)[1:]
            busy, wall, rows = profiled(torch, lambda: net.fit(
                ExistingDataSetIterator(data[:1]), async_prefetch=False))
            runs[name] = {"step_s": quantiles(st), "busy_share": busy / wall,
                          "device_ms": busy * 1e3, "launches": launched}
            by_kernel[name] = rows
            nets[name] = net
            if name == "on2":
                on = nets.pop("on")
                same = nets_equal(torch, on, nets.pop("off"))
                check(same, "10b: the sentinel-on ResNet-50 run is not bit-equal to the "
                      "sentinel-off run")
                clone_bytes = sum(tree_bytes(getattr(on, n))
                                  for n in ("params_list", "state_list", "upd_state"))
                clone_ms = device_ms(torch, lambda: sentinel_mod.pre_step(on), reps=5)
                judge_s, pre_s = [], []
                for _ in range(5):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    sentinel_mod.pre_step(on)
                    pre_s.append(time.perf_counter() - t0)
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    on._sentinel.judge(on)
                    judge_s.append(time.perf_counter() - t0)
                del on
                torch.cuda.empty_cache()
        check(nets_equal(torch, nets["on2"], nets["off2"]),
              "10b: the second sentinel-on run is not bit-equal to the second off run")
        del nets
        torch.cuda.empty_cache()
        for k, per in resnet_per_step(RESNET_BATCH).items():
            check(runs["on"]["launches"].get(k, 0) == per * SENTINEL_RESNET_STEPS,
                  f"10b: {k} launched {runs['on']['launches'].get(k, 0)} times with the "
                  f"sentinel, expected {per * SENTINEL_RESNET_STEPS}")
        # the graphed step the sentinel gives up
        fused = resnet50_network(precision="bf16", seed=seed, learning_rate=RESNET_LR)
        fused.set_fused_steps(SENTINEL_FUSED_K)
        fdata = resnet_batches(torch, F, DataSet, seed + 111, SENTINEL_FUSED_K, RESNET_BATCH)
        clock = SyncClock(torch, DataSetIterator, fdata, 4, per=SENTINEL_FUSED_K)
        fused.fit(clock.it, async_prefetch=False)
        groups = dispatch_times(clock, SENTINEL_FUSED_K)
        graphed = [g / SENTINEL_FUSED_K for g in groups[2:]]
        check(len(fused.fit_graphs()) == 1, f"10b: fused graphs {fused.fit_graphs()}")
        del fused, fdata
        torch.cuda.empty_cache()
    finally:
        torch.backends.cudnn.deterministic = det
    frozen = sentinel_frozen_cost(torch, F, counts, DataSet, DataSetIterator, seed, card)
    # where a profiled sentinel step's extra device time goes
    extra = sorted(((by_kernel["on"].get(k, 0.0) - by_kernel["off"].get(k, 0.0), k)
                    for k in set(by_kernel["on"]) | set(by_kernel["off"])), reverse=True)[:5]
    rec = {"extra_device_ms": [{"kernel": k, "ms": d} for d, k in extra],
           "runs": runs, "bit_equal": same, "clone_bytes": clone_bytes,
           "clone_device_ms": clone_ms, "clone_host_s": quantiles(pre_s),
           "judge_s": quantiles(judge_s),
           "graphed_step_s": quantiles(graphed), "frozen": frozen,
           "launches": runs["on"]["launches"]}
    transfer = " ".join(f"{frozen[n + '_s']['p50'] * 1e3:.2f}"
                        for n in ("off", "on", "on2", "off2"))
    steps = "; ".join(
        f"{n} p50 {r['step_s']['p50'] * 1e3:.2f} ms p99 {r['step_s']['p99'] * 1e3:.2f} ms busy "
        f"{r['busy_share']:.3f}" for n, r in runs.items())
    print(f"  10b ResNet-50 bf16 b{RESNET_BATCH}, cudnn.deterministic, {SENTINEL_RESNET_STEPS} "
          f"steps a run, the sentinel off, on, on, off: {steps}; params bit-equal "
          f"{same}; the pre-step copy {clone_bytes / 1e6:.2f} MB, "
          f"{clone_ms:.3f} ms of device and {rec['clone_host_s']['p50'] * 1e3:.3f} ms of host "
          f"(p50) a step; judge p50 {rec['judge_s']['p50'] * 1e6:.1f} us; "
          f"graphed set_fused_steps({SENTINEL_FUSED_K}) step (no sentinel) p50 "
          f"{rec['graphed_step_s']['p50'] * 1e3:.2f} ms; phase-9 transfer (batch "
          f"{RESNET_TRANSFER_BATCH}) step p50 off, on, on, off {transfer} ms (on: the frozen "
          f"gradients taken), on {card}")
    print("  10b a profiled step's device ms, on minus off, largest: " + "; ".join(
        f"{d:+.3f} {k[:60]}" for d, k in extra))
    return rec


def sentinel_frozen_cost(torch, F, counts, DataSet, DataSetIterator, seed, card):
    """The price of decision 2: the phase-9 ResNet-50 transfer net's step
    without a sentinel (frozen leaves out of autograd) and with one (the
    frozen gradients taken, for the norm only)."""
    from deeplearning4j_tpu_torch.models.resnet import resnet50_network
    from deeplearning4j_tpu_torch.nn.transferlearning import GraphTransferLearning
    from deeplearning4j_tpu_torch.train.sentinel import DivergenceSentinel

    def build():
        src = resnet50_network(image_size=PHASE9_IMAGE, precision="bf16", seed=seed,
                               learning_rate=RESNET_LR)
        return (GraphTransferLearning(src)
                .fine_tune_configuration(updater="nesterovs", learning_rate=TRANSFER_LR,
                                         momentum=0.9)
                .set_feature_extractor(RESNET_TRANSFER_FREEZE)
                .n_out_replace("out", TRANSFER_CLASSES, weight_init="xavier").build())

    data = vgg_batches(torch, F, DataSet, seed + 112, 2, RESNET_TRANSFER_BATCH, TRANSFER_CLASSES)
    out = {}
    for name in ("off", "on", "on2", "off2"):
        net = build()
        if name.startswith("on"):
            net.set_sentinel(DivergenceSentinel())
        clock = SyncClock(torch, DataSetIterator, data, SENTINEL_TRANSFER_STEPS // 2)
        counts.reset()
        net.fit(clock.it, async_prefetch=False)
        out[name + "_s"] = quantiles(dispatch_times(clock, 1)[1:])
        out[name + "_launches"] = counts.read()
        out[name + "_gnorm"] = float(net._step_diag[1])
        del net
        torch.cuda.empty_cache()
    check(out["on_gnorm"] > out["off_gnorm"],
          f"10b: the transfer net's norm with frozen leaves {out['on_gnorm']} is not above "
          f"the trainable one {out['off_gnorm']}")
    return out


def solver_phase(torch, counts, seed, card):
    """10c: LeNet under each line-search solver, 5 batches on the card;
    the first step against the same step on the CPU."""
    import copy

    from deeplearning4j_tpu_torch.data import DataSet, ExistingDataSetIterator
    from deeplearning4j_tpu_torch.data.mnist import MnistDataFetcher, MnistDataSetIterator
    from deeplearning4j_tpu_torch.models.lenet import lenet_conf
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork

    os.environ["DL4J_TPU_DATA"] = os.path.join(HERE, "_no_mnist_cache")
    it = MnistDataSetIterator(LENET_BATCH, train=True, seed=seed + 120,
                              num_examples=LENET_BATCH * SOLVER_STEPS,
                              fetcher=MnistDataFetcher(allow_download=False))
    batches = list(it)
    whole = DataSet.concat(batches)
    rec = {}
    for algo in SOLVERS:
        conf = lenet_conf(seed=seed)
        conf.net_conf.optimization_algo = algo
        card_net = MultiLayerNetwork(conf, device="cuda").init()
        cpu_net = MultiLayerNetwork(copy.deepcopy(conf), device="cpu").init()
        s0 = card_net.score(whole)
        counts.reset()
        steps = []
        for i, b in enumerate(batches):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            card_net.fit(ExistingDataSetIterator([b]), async_prefetch=False)
            torch.cuda.synchronize()
            steps.append(time.perf_counter() - t0)
            if i == 0:
                cpu_net.fit(ExistingDataSetIterator([b]), async_prefetch=False)
                err = max(_close_rel(torch, p[k], q[k])
                          for p, q in zip(card_net.params_list, cpu_net.params_list) for k in p)
        launched = counts.read()
        s1 = card_net.score(whole)
        check(err <= SOLVER_RTOL, f"10c {algo}: first step card vs CPU {err:.2e} > {SOLVER_RTOL}")
        check(math.isfinite(s1) and s1 < s0, f"10c {algo}: score {s0} -> {s1}")
        check(sum(launched.values()) == 0, f"10c {algo}: kernels launched {launched}")
        check(card_net._step_diag is None, f"10c {algo}: a diagnostic on the line-search path")
        rec[algo] = {"first_step_rel": err, "score_before": s0, "score_after": s1,
                     "step_s": quantiles(steps[1:]), "launches": launched}
        print(f"  10c LeNet {algo}, {SOLVER_STEPS} batches of {LENET_BATCH}: the score over them "
              f"{s0:.4f} -> {s1:.4f}; first step card vs CPU {err:.1e} of each tensor's "
              f"largest entry (tolerance {SOLVER_RTOL}); step p50 "
              f"{rec[algo]['step_s']['p50'] * 1e3:.2f} ms (synced), no kernel launches, on {card}")
    rec["launches"] = {k: sum(rec[a]["launches"].get(k, 0) for a in SOLVERS)
                       for k in rec[SOLVERS[0]]["launches"]}
    return rec


def import_phase(torch, counts, seed, card):
    """10d: the two fixture zips onto the card (the model zip of the JAX
    package's format v1, and the DL4J-format graph zip through the DL4J
    importer), outputs held to the fixtures' expected values, then one
    Adam step from the imported updater state against the same on the
    CPU."""
    from deeplearning4j_tpu_torch.data import DataSet, ExistingDataSetIterator
    from deeplearning4j_tpu_torch.modelimport.dl4j import (
        import_dl4j_computation_graph,
        updater_state_to_flat,
    )
    from deeplearning4j_tpu_torch.utils.model_serializer import load_model

    fx = os.path.join(HERE, "tests", "fixtures")
    loaders = {"mln_adam_v1": lambda d: load_model(os.path.join(fx, "mln_adam_v1.zip"),
                                                   device=d),
               "cg_adam_v1": lambda d: import_dl4j_computation_graph(
                   os.path.join(fx, "cg_adam_v1.zip"), device=d)}
    rec = {}
    counts.reset()
    for name, load in loaders.items():
        exp = np.load(os.path.join(fx, f"{name}_expected.npz"))
        net, cpu = load("cuda"), load("cpu")
        check(next(iter(net.params_list[0].values())).is_cuda, f"10d {name}: not on the card")
        out = net.output(exp["x"]).cpu().numpy()
        gap = float(np.max(np.abs(out - exp["out"]) - IMPORT_RTOL * np.abs(exp["out"])))
        check(gap <= IMPORT_ATOL, f"10d {name}: output off the fixture by {gap:.2e} beyond "
              f"rtol {IMPORT_RTOL}")
        check(net.iteration == int(exp["iteration"]), f"10d {name}: iteration {net.iteration}")
        if "updater_state" in exp.files:
            order = [(net._pidx[n], net.conf.vertices[n].layer) for n in ("b", "a", "out")]
            check(np.array_equal(updater_state_to_flat(net, indexed_layer_confs=order),
                                 exp["updater_state"]), f"10d {name}: updater state")
        rng = np.random.default_rng(seed + 130)
        k = exp["out"].shape[1]
        ds = DataSet(exp["x"], np.eye(k, dtype=np.float32)[rng.integers(0, k, len(exp["x"]))])
        for n in (net, cpu):
            n.fit(ExistingDataSetIterator([ds]), async_prefetch=False)
        err = max(_close_rel(torch, p[kk], q[kk])
                  for p, q in zip(net.params_list, cpu.params_list) for kk in p)
        check(err <= IMPORT_STEP_RTOL, f"10d {name}: Adam step card vs CPU {err:.2e}")
        rec[name] = {"output_gap": gap, "step_rel": err}
        print(f"  10d {name}: on the card, output vs the fixture within rtol {IMPORT_RTOL} "
              f"atol {IMPORT_ATOL} (excess {gap:.1e}); one Adam step from the imported state, "
              f"card vs CPU {err:.1e} of each tensor's largest entry (tolerance "
              f"{IMPORT_STEP_RTOL}), on {card}")
    # the model zip's MLN has a BatchNormalization layer: its training step
    # takes the BN pullback kernels (K7, K8), as any BN layer does
    rec["launches"] = counts.read()
    return rec


# -- phase 11: the embeddings stack (nlp/, graph/, native/) ---------------------

# scratch for phase 11's corpus files and zip, inside the checkout
# (gitignored), removed when the phase ends
NLP_DIR = os.path.join(HERE, "_nlp_smoke")
# corpus A: bench.py's Zipf generator (bench.py:462-469: vocab 10,000,
# p ~ 1/rank, sentences of 40 words) at 20,000 sentences, 800k tokens: a
# real corpus's width, its depth cut for the script's time
ZIPF_VOCAB, ZIPF_SENTS, ZIPF_LEN = 10_000, 20_000, 40
# corpus B: the two-topic corpus of tests/test_word2vec.py:23-30
TOPIC_SENTS, TOPIC_LEN = 400, 8
ANIMALS = ["cat", "dog", "horse", "cow", "sheep"]
TECH = ["cpu", "gpu", "ram", "disk", "cache"]
W2V_HOLD_GROUPS = 4      # 11a: card vs CPU through this many groups
W2V_PROFILE_GROUPS = 8   # 11a: the profiled window
CORPUS_HOLD_SENTS = 2_000  # 11b: card vs CPU over one epoch of this prefix
PV_EPOCHS = 12
# card vs CPU, f32: a whole fit of at most 20 device calls (groups, or
# the chunks of one corpus epoch) elementwise to rtol 1e-4 / atol 1e-6,
# since index_add_ sums duplicate rows in another order on the card; one
# step would be 1e-5 / 1e-7
NLP_FIT_RTOL, NLP_FIT_ATOL = 1e-4, 1e-6
NLP_LOSS_RTOL = 1e-5


def zipf_corpus(seed):
    """Corpus A as sentence strings (one draw of the whole corpus from
    bench.py's distribution)."""
    rng = np.random.default_rng(seed)
    p = 1.0 / np.arange(1, ZIPF_VOCAB + 1)
    p /= p.sum()
    words = np.asarray([f"w{i}" for i in range(ZIPF_VOCAB)])
    ids = rng.choice(ZIPF_VOCAB, p=p, size=(ZIPF_SENTS, ZIPF_LEN))
    return [" ".join(words[row]) for row in ids]


def topic_corpus(seed):
    """Corpus B: (sentences, topic of each: 0 animals, 1 tech)."""
    rng = np.random.default_rng(seed)
    sents, topics = [], []
    for _ in range(TOPIC_SENTS):
        t = int(rng.random() >= 0.5)
        sents.append(" ".join(rng.choice(TECH if t else ANIMALS, size=TOPIC_LEN)))
        topics.append(t)
    return sents, np.asarray(topics)


def allclose_excess(torch, got, want, rtol, atol) -> float:
    """max(|got - want| - rtol * |want|) over the entries: <= atol is
    np.allclose(got, want, rtol, atol)."""
    g, w = got.detach().double().cpu(), want.detach().double().cpu()
    return float(((g - w).abs() - rtol * w.abs()).max())


def step_counter(step, calls):
    def run(*a, **k):
        calls.append(1)
        return step(*a, **k)
    return run


def timed_train(torch, model):
    """Wrap model.train_indexed to record its synced wall seconds."""
    orig, spent = model.train_indexed, []

    def run(indexed):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        orig(indexed)
        torch.cuda.synchronize()
        spent.append(time.perf_counter() - t0)

    model.train_indexed = run
    return spent


def top_ops(rows, n=5):
    total = sum(rows.values()) or 1.0
    return [(k, ms, ms / total) for k, ms in sorted(rows.items(), key=lambda kv: -kv[1])[:n]]


def fmt_ops(ops, per=1) -> str:
    """The top ops, each op's device ms over `per` (a group) and share."""
    return "; ".join(f"{k.replace('void ', '')[:48]} {ms / per:.3f} ms ({share:.0%})"
                     for k, ms, share in ops)


def w2v_phase(torch, corpus_a, seed, card):
    """11a: Word2Vec at VectorsConfiguration's defaults on corpus A,
    skip-gram then CBOW (the batched path): the user's fit, a profiled
    window, and card vs CPU through W2V_HOLD_GROUPS groups from the same
    tables."""
    from deeplearning4j_tpu_torch.nlp import InMemoryLookupTable, SequenceVectors, Word2Vec
    from deeplearning4j_tpu_torch.nlp.learning import make_embedding_scan_step

    rec = {}
    for algo in ("skipgram", "cbow"):
        w2v = Word2Vec.Builder().seed(seed).elements_learning_algorithm(algo) \
            .iterate(corpus_a).build()
        conf = w2v.conf
        calls = []
        w2v._scan_step = step_counter(make_embedding_scan_step(
            use_hs=conf.use_hierarchic_softmax, negative=conf.negative, with_doc=False), calls)
        spent = timed_train(torch, w2v)
        t0 = time.perf_counter()
        w2v.fit()
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
        indexed = w2v._index_sentences(w2v._sequences)
        words = sum(int(s.size) for s in indexed)
        train_s, groups = spent[0], len(calls)
        check(np.isfinite(w2v.last_loss), f"11a {algo}: loss {w2v.last_loss}")
        check(w2v.lookup.syn0.is_cuda, f"11a {algo}: the tables are not on the card")
        # the profiled window: the first W2V_PROFILE_GROUPS groups' worth
        per_word = conf.window + 1 if algo == "skipgram" else 1
        n_sents = max(1, W2V_PROFILE_GROUPS * conf.scan_size * conf.batch_size
                      // (ZIPF_LEN * per_word))
        calls.clear()
        busy, wall, by_kernel = profiled(torch, lambda: w2v.train_indexed(indexed[:n_sents]))
        pg = len(calls)
        # card vs CPU through W2V_HOLD_GROUPS groups, from the same tables
        n_hold = max(1, W2V_HOLD_GROUPS * conf.scan_size * conf.batch_size
                     // (ZIPF_LEN * per_word))
        models = {}
        for dev in ("cuda", "cpu"):
            m = SequenceVectors(conf, vocab=w2v.vocab, device=dev)
            m.build_vocab()
            models[dev] = m
        models["cpu"].lookup = InMemoryLookupTable.from_numpy(
            w2v.vocab, models["cuda"].lookup.syn0.cpu().numpy(),
            models["cuda"].lookup.syn1.cpu().numpy(), device="cpu")
        hold_calls = []
        for dev, m in models.items():
            m._scan_step = step_counter(make_embedding_scan_step(
                use_hs=True, negative=0, with_doc=False), hold_calls)
            m.train_indexed(indexed[:n_hold])
        torch.cuda.synchronize()
        hold_groups = len(hold_calls) // 2
        excess = max(allclose_excess(torch, getattr(models["cuda"].lookup, t),
                                     getattr(models["cpu"].lookup, t), NLP_FIT_RTOL, 0.0)
                     for t in ("syn0", "syn1"))
        loss_rel = abs(models["cuda"].last_loss - models["cpu"].last_loss) / abs(
            models["cpu"].last_loss)
        check(hold_groups <= 20, f"11a {algo}: the hold ran {hold_groups} groups")
        check(excess <= NLP_FIT_ATOL, f"11a {algo}: card vs CPU after {hold_groups} groups "
              f"exceeds rtol {NLP_FIT_RTOL} by {excess:.2e} > atol {NLP_FIT_ATOL}")
        check(loss_rel <= NLP_LOSS_RTOL, f"11a {algo}: loss card vs CPU {loss_rel:.2e}")
        rec[algo] = {
            "words": words, "vocab": w2v.vocab.num_words(), "fit_s": fit_s, "train_s": train_s,
            "words_per_s": words / train_s, "groups": groups, "loss": w2v.last_loss,
            "group_s": train_s / groups,
            "profiled": {"groups": pg, "wall_s": wall, "device_s": busy, "busy": busy / wall,
                         "host_s_per_group": wall / pg, "device_s_per_group": busy / pg,
                         "top_ops": top_ops(by_kernel)},
            "hold": {"groups": hold_groups, "excess": excess, "loss_rel": loss_rel},
            "model": w2v,
        }
        r = rec[algo]
        print(f"  11a Word2Vec {algo} at the defaults (layer 100, window 5, min frequency 5, "
              f"HS, batch 2048, scan 16, lr 0.025), corpus A ({words} words, vocab "
              f"{r['vocab']}): {r['words_per_s']:.0f} words/s ({train_s:.2f} s of train_indexed, "
              f"{groups} groups, {r['group_s'] * 1e3:.2f} ms a group synced; fit with vocab "
              f"{fit_s:.2f} s), loss {w2v.last_loss:.4f}, on {card}")
        p = r["profiled"]
        print(f"      profiled {pg} groups: host {p['host_s_per_group'] * 1e3:.2f} ms a group beside "
              f"device {p['device_s_per_group'] * 1e3:.2f} ms, busy {p['busy']:.3f}; top device "
              f"ops of one group: {fmt_ops(p['top_ops'], pg)}")
        print(f"      card vs CPU through {hold_groups} groups from the same tables: within "
              f"rtol {NLP_FIT_RTOL} / atol {NLP_FIT_ATOL} (worst excess over rtol·|cpu| "
              f"{excess:.1e}), loss {loss_rel:.1e} apart (tolerance {NLP_LOSS_RTOL})")
    return rec


def clip_ms(torch, table, idx):
    """Device ms of one dense trust-region clip (learning._scatter_clipped)
    of `table` at the scatter indices `idx`."""
    from deeplearning4j_tpu_torch.nlp.learning import _scatter_clipped

    t = table.clone()
    delta = torch.randn(idx.shape[0], t.shape[1], device=t.device) * 1e-3
    w = torch.ones(idx.shape[0], device=t.device)
    return device_ms(torch, lambda: _scatter_clipped(t, idx, delta, w, 0.25))


def corpus_phase(torch, tokens_a, seed, card):
    """11b: the corpus-resident skip-gram path at bench_word2vec's
    configuration on corpus A: words/s over 3 timed epochs after a
    warm-up, the busy share, the dense clip's share of the device time,
    and one epoch on the card with injected draws against the same on
    the CPU."""
    from deeplearning4j_tpu_torch.nlp import SequenceVectors, VectorsConfiguration
    from deeplearning4j_tpu_torch.nlp.batching import keep_probabilities, subsample
    from deeplearning4j_tpu_torch.nlp.devicegen import (
        _chunk_pairs, live_length, make_corpus_skipgram_step, pack_corpus)

    conf = VectorsConfiguration(layer_size=128, window=5, min_word_frequency=1, epochs=1,
                                negative=5, use_hierarchic_softmax=False, batch_size=8192,
                                sampling=1e-3, seed=seed)
    sv = SequenceVectors(conf, tokens_a)
    sv.build_vocab()
    indexed = sv._index_sentences(tokens_a)
    words = sum(int(s.size) for s in indexed)
    sv.train_indexed(indexed)  # warm-up epoch
    times = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sv.train_indexed(indexed)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    check(np.isfinite(sv.last_loss), f"11b: loss {sv.last_loss}")
    dt = statistics.median(times)
    busy, wall, by_kernel = profiled(torch, lambda: sv.train_indexed(indexed))
    # the dense clip at this run's shapes: a live chunk's scatter indices
    n_centers = conf.batch_size // (2 * conf.window)
    keep = keep_probabilities(sv.vocab.counts(), conf.sampling)
    flat = pack_corpus([subsample(s, keep, np.random.default_rng(seed)) for s in indexed],
                       conf.window)
    live = live_length(flat)
    n_live = -(-live // n_centers)
    corpus = torch.from_numpy(flat).cuda().long()
    gen = torch.Generator(device="cuda").manual_seed(seed)
    b = torch.randint(0, conf.window, (n_centers,), generator=gen, device="cuda")
    ins, tgt, _ = _chunk_pairs(corpus, 0, n_centers, conf.window, b)
    unigram = sv._unigram_dev()
    r = torch.randint(0, unigram.shape[0], (ins.shape[0], conf.negative), generator=gen,
                      device="cuda")
    idx1 = torch.cat([tgt.clamp_min(0)[:, None], unigram[r]], 1).reshape(-1)
    ms0 = clip_ms(torch, sv.lookup.syn0, ins.clamp_min(0))
    ms1 = clip_ms(torch, sv.lookup.syn1neg, idx1)
    clip_share = n_live * (ms0 + ms1) / (busy * 1e3)
    # one epoch over a prefix of corpus A, card vs CPU, the same draws
    sents = [subsample(s, keep, np.random.default_rng(seed + 1))
             for s in indexed[:CORPUS_HOLD_SENTS]]
    hflat = pack_corpus(sents, conf.window)
    hlive = live_length(hflat)
    cgen = torch.Generator().manual_seed(seed + 2)
    n_pairs = n_centers * 2 * conf.window
    draws = [(torch.randint(0, conf.window, (n_centers,), generator=cgen),
              torch.randint(0, unigram.shape[0], (n_pairs, conf.negative), generator=cgen))
             for _ in range(-(-hlive // n_centers))]
    step = make_corpus_skipgram_step(negative=conf.negative, window=conf.window,
                                     pairs_per_batch=conf.batch_size)
    out = {}
    for dev in ("cuda", "cpu"):
        out[dev] = step(sv.lookup.syn0.to(dev, copy=True), sv.lookup.syn1neg.to(dev, copy=True),
                        unigram.to(dev), torch.from_numpy(hflat).to(dev).long(),
                        conf.learning_rate, conf.min_learning_rate, float(hlive * 6),
                        torch.zeros((), device=dev), live=hlive, draws=lambda i: draws[i])
    torch.cuda.synchronize()
    excess = max(allclose_excess(torch, out["cuda"][k], out["cpu"][k], NLP_FIT_RTOL, 0.0)
                 for k in (0, 1))
    loss_rel = abs(float(out["cuda"][2]) - float(out["cpu"][2])) / abs(float(out["cpu"][2]))
    check(float(out["cuda"][3]) == float(out["cpu"][3]), "11b: pairs counted differ")
    check(excess <= NLP_FIT_ATOL, f"11b: card vs CPU epoch exceeds rtol {NLP_FIT_RTOL} by "
          f"{excess:.2e} > atol {NLP_FIT_ATOL}")
    check(loss_rel <= NLP_LOSS_RTOL, f"11b: loss card vs CPU {loss_rel:.2e}")
    rec = {"words": words, "vocab": sv.vocab.num_words(), "epoch_s": times,
           "words_per_s": words / dt, "trained_tokens": int(np.sum(flat >= 0)),
           "chunks": n_live, "loss": sv.last_loss,
           "profiled": {"wall_s": wall, "device_s": busy, "busy": busy / wall,
                        "top_ops": top_ops(by_kernel)},
           "clip_ms": [ms0, ms1], "clip_share": clip_share,
           "hold": {"sentences": CORPUS_HOLD_SENTS, "chunks": len(draws), "excess": excess,
                    "loss_rel": loss_rel, "pairs": float(out["cpu"][3])}}
    print(f"  11b corpus-resident skip-gram, bench_word2vec's configuration (layer 128, window "
          f"5, negative 5, no HS, sample 1e-3, batch 8192), corpus A ({words} words, "
          f"{rec['trained_tokens']} after subsampling, {n_live} chunks): {words / dt:.0f} words/s "
          f"(epochs {', '.join(f'{t:.3f}' for t in times)} s after a warm-up), loss "
          f"{sv.last_loss:.4f}, on {card}")
    print(f"      profiled epoch: {busy * 1e3:.1f} ms of device in {wall * 1e3:.1f} ms, busy "
          f"{busy / wall:.3f}; the dense clip {ms0:.4f} + {ms1:.4f} ms a chunk (syn0, syn1neg), "
          f"{clip_share:.0%} of the device time; top device ops: {fmt_ops(top_ops(by_kernel))}")
    print(f"      one epoch over the first {CORPUS_HOLD_SENTS} sentences ({len(draws)} chunks), "
          f"the same draws: card vs CPU within rtol {NLP_FIT_RTOL} / atol {NLP_FIT_ATOL} "
          f"(worst excess {excess:.1e}), loss {loss_rel:.1e} apart, pairs equal")
    return rec


def doc_separation(dv, topics) -> tuple:
    """Mean cosine of doc vectors within a topic and across topics."""
    n = dv / np.linalg.norm(dv, axis=1, keepdims=True)
    sims = n @ n.T
    same = topics[:, None] == topics[None, :]
    off = ~np.eye(len(topics), dtype=bool)
    return float(sims[same & off].mean()), float(sims[~same].mean())


def pv_phase(torch, corpus_b, topics, seed, card):
    """11c: ParagraphVectors DM and DBOW (layer 100, HS, a label per
    sentence) on corpus B: doc vectors separate by topic; infer_vector on
    the card against the CPU from the same tables."""
    from deeplearning4j_tpu_torch.nlp import (InMemoryLookupTable, ParagraphVectors,
                                              VectorsConfiguration)

    conf = VectorsConfiguration(layer_size=100, window=4, min_word_frequency=1,
                                epochs=PV_EPOCHS, learning_rate=0.05,
                                use_hierarchic_softmax=True, negative=0, batch_size=256,
                                seed=seed)
    labels = [f"doc_{i}" for i in range(len(corpus_b))]
    text = " ".join(["cat", "dog", "cow"] * 3)
    rec = {}
    for algo in ("dm", "dbow"):
        pv = ParagraphVectors(conf, corpus_b, labels, sequence_learning_algorithm=algo)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pv.fit()
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
        within, across = doc_separation(pv.doc_vectors.cpu().numpy(), topics)
        check(within > across, f"11c {algo}: doc vectors within {within:.3f} <= across "
              f"{across:.3f}")
        cpu = ParagraphVectors(conf, corpus_b, labels, sequence_learning_algorithm=algo,
                               device="cpu")
        cpu.build_vocab()
        cpu.lookup = InMemoryLookupTable.from_numpy(
            cpu.vocab, pv.lookup.syn0.cpu().numpy(), pv.lookup.syn1.cpu().numpy(),
            device="cpu")
        cpu.set_doc_vectors(pv.doc_vectors.cpu().numpy())
        v_card, v_cpu = pv.infer_vector(text), cpu.infer_vector(text)
        gap = float(np.max(np.abs(v_card - v_cpu) - NLP_FIT_RTOL * np.abs(v_cpu)))
        check(gap <= NLP_FIT_ATOL, f"11c {algo}: infer_vector card vs CPU excess {gap:.2e}")
        hits = int(sum(topics[int(l.split("_")[1])] == 0
                       for l, _ in pv.nearest_labels(v_card, 10)))
        words = len(corpus_b) * TOPIC_LEN * PV_EPOCHS
        rec[algo] = {"fit_s": fit_s, "words_per_s": words / fit_s, "within": within,
                     "across": across, "infer_excess": gap, "nearest_animal_docs": hits}
        print(f"  11c ParagraphVectors {algo.upper()} (layer 100, HS, {PV_EPOCHS} epochs, "
              f"{len(labels)} labelled sentences of corpus B): fit {fit_s:.2f} s "
              f"({words / fit_s:.0f} words/s), doc cosine within a topic {within:.3f} vs across "
              f"{across:.3f}; infer_vector card vs CPU within rtol {NLP_FIT_RTOL} / atol "
              f"{NLP_FIT_ATOL} (excess {gap:.1e}); {hits}/10 nearest labels of an animal text "
              f"are animal docs, on {card}")
    return rec


def glove_graph_phase(torch, corpus_a, corpus_b, seed, card):
    """11d: GloVe.fit_file through the port's native corpus build, on
    corpus A (the loss falls) and corpus B (the topics separate), and
    DeepWalk on two joined cliques (the communities separate)."""
    import logging

    from deeplearning4j_tpu_torch import native
    from deeplearning4j_tpu_torch.graph import DeepWalk, Graph
    from deeplearning4j_tpu_torch.nlp import Glove, VectorsConfiguration

    check(native.native_available(), "11d: the port's native corpus library did not build")
    losses = []

    class Losses(logging.Handler):
        def emit(self, record):
            if record.getMessage().startswith("GloVe epoch"):
                losses.append(float(record.getMessage().split()[-1]))

    log = logging.getLogger("deeplearning4j_tpu_torch.nlp")
    handler, level = Losses(), log.level
    log.addHandler(handler)
    log.setLevel(logging.INFO)
    rec = {}
    try:
        for name, corpus, conf in (
                ("A", corpus_a, VectorsConfiguration(learning_rate=0.05, epochs=2, seed=seed)),
                ("B", corpus_b, VectorsConfiguration(layer_size=100, window=4,
                                                     min_word_frequency=1, epochs=25,
                                                     learning_rate=0.05, batch_size=1024,
                                                     seed=seed, x_max=10.0))):
            path = os.path.join(NLP_DIR, f"corpus_{name}.txt")
            with open(path, "w") as f:
                f.write("\n".join(corpus) + "\n")
            losses.clear()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            g = Glove(conf).fit_file(path)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            check(g.lookup.syn0.is_cuda and len(losses) == conf.epochs
                  and all(np.isfinite(losses)), f"11d GloVe {name}: losses {losses}")
            rec[name] = {"fit_s": dt, "vocab": g.vocab.num_words(), "losses": list(losses)}
            if name == "A":
                check(losses[-1] < losses[0], f"11d GloVe A: loss {losses} does not fall")
                print(f"  11d GloVe.fit_file on corpus A (layer 100, window 5, min frequency 5, "
                      f"batch 2048, lr 0.05, 2 epochs; native vocab and co-occurrences): "
                      f"{dt:.2f} s, vocab {g.vocab.num_words()}, loss a pair "
                      f"{' -> '.join(f'{x:.4f}' for x in losses)}, on {card}")
            else:
                near = {w for w, _ in g.words_nearest("cat", 4)}
                sim_in, sim_out = g.similarity("cat", "dog"), g.similarity("cat", "gpu")
                check(near == set(ANIMALS) - {"cat"} and sim_in > sim_out,
                      f"11d GloVe B: nearest of cat {near}, cat~dog {sim_in} cat~gpu {sim_out}")
                rec[name].update(near=sorted(near), sim_in=sim_in, sim_out=sim_out)
                print(f"  11d GloVe.fit_file on corpus B (layer 100, 25 epochs): {dt:.2f} s; "
                      f"cat's 4 nearest are the other animals; cat~dog {sim_in:.3f}, cat~gpu "
                      f"{sim_out:.3f}")
    finally:
        log.removeHandler(handler)
        log.setLevel(level)
    k = 6
    graph = Graph(2 * k)
    for base in (0, k):
        for i in range(k):
            for j in range(i + 1, k):
                graph.add_edge(base + i, base + j)
    graph.add_edge(k - 1, k)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    vec = DeepWalk(vector_size=100, window_size=4, walks_per_vertex=8, learning_rate=0.05,
                   seed=seed, batch_size=512).fit(graph, walk_length=20)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    intra = np.mean([vec.similarity(a, b) for a in range(4) for b in range(1, 4) if a != b])
    inter = np.mean([vec.similarity(a, b) for a in range(4) for b in range(k, k + 4)])
    near = vec.verts_nearest(1, top_n=3)
    check(intra > inter and all(v < k for v in near),
          f"11d DeepWalk: intra {intra:.3f} inter {inter:.3f}, nearest of 1 {near}")
    rec["deepwalk"] = {"fit_s": dt, "intra": float(intra), "inter": float(inter)}
    print(f"  11d DeepWalk (vector 100, window 4, 8 walks of 20 a vertex) on two joined "
          f"{k}-cliques: {dt:.2f} s; cosine within a clique {intra:.3f} vs across "
          f"{inter:.3f}; vertex 1's 3 nearest {near}")
    return rec


def nlp_zip_phase(torch, model, card):
    """11e: a full-model zip written on the card, read back on the CPU."""
    from deeplearning4j_tpu_torch.nlp import WordVectorSerializer

    path = os.path.join(NLP_DIR, "word2vec.zip")
    WordVectorSerializer.write_full_model(model, path)
    back = WordVectorSerializer.read_full_model(path, device="cpu")
    same = (back.vocab.words() == model.vocab.words()
            and np.array_equal(back.vocab.counts(), model.vocab.counts())
            and all(torch.equal(getattr(back.lookup, t), getattr(model.lookup, t).cpu())
                    for t in ("syn0", "syn1")))
    check(same, "11e: the zip read on the CPU differs from the card's tables")
    size = os.path.getsize(path)
    print(f"  11e full-model zip of 11a's skip-gram model, written on the card, read on the "
          f"CPU: {size / 1e6:.2f} MB, vocab, counts, syn0 and syn1 equal, on {card}")
    return {"bytes": size, "equal": same}


def embeddings_phase(torch, counts, seed, card):
    """Phase 11: the embeddings stack on the card; no kernel of K1-K8 lies
    on its path (the JAX package computes it with XLA ops)."""
    import shutil

    t0 = time.perf_counter()
    shutil.rmtree(NLP_DIR, ignore_errors=True)
    os.makedirs(NLP_DIR)
    try:
        corpus_a = zipf_corpus(seed)
        corpus_b, topics = topic_corpus(seed)
        print(f"  corpora: A {ZIPF_SENTS} Zipf sentences of {ZIPF_LEN} over {ZIPF_VOCAB} words, "
              f"B {TOPIC_SENTS} two-topic sentences of {TOPIC_LEN} "
              f"({time.perf_counter() - t0:.2f} s)")
        counts.reset()
        rec = {"w2v": w2v_phase(torch, corpus_a, seed, card)}
        rec["corpus"] = corpus_phase(torch, [s.split() for s in corpus_a], seed, card)
        rec["pv"] = pv_phase(torch, corpus_b, topics, seed, card)
        rec["glove_graph"] = glove_graph_phase(torch, corpus_a, corpus_b, seed, card)
        rec["zip"] = nlp_zip_phase(torch, rec["w2v"]["skipgram"].pop("model"), card)
        rec["w2v"]["cbow"].pop("model")
        torch.cuda.synchronize()
        rec["launches"] = counts.read()
    finally:
        shutil.rmtree(NLP_DIR, ignore_errors=True)
    check(sum(rec["launches"].values()) == 0, f"11: kernels launched {rec['launches']}")
    rec["seconds"] = time.perf_counter() - t0
    print(f"  phase 11: {rec['seconds']:.1f} s, no kernel of K1-K8 launched (none lies on "
          f"this path)")
    return rec


# -- phase 12: scale-out ----------------------------------------------------------------

SCALE_DIR = os.path.join(HERE, "_scale_smoke")
SCALE_RANKS = 2            # processes on the one card, joined by gloo
SCALE_GROUP_TIMEOUT = 300  # every collective of the ranks' group (s)
SCALE_JOIN_TIMEOUT = 600   # the ranks' whole run (s)
NCCL_PROBE_TIMEOUT = 90    # the two-NCCL-ranks-on-one-card probe (s)
VGG_SCALE_BATCH, VGG_SCALE_STEPS = 32, 2
RESNET_SCALE_BATCH, RESNET_SCALE_STEPS = 128, 2
SCALE_IMAGE = 224          # ResNet-50's image side in 12b and 12c
LSTM_SCALE_T = 100         # two TBPTT segments of 50 at char-LSTM's width
VGG16_PARAMS = 138_357_544
SCALE_TIMED_STEPS = 3      # steps timed after the compared ones (warm), for step p50
# 2 ranks against 1 process in bf16. A data-parallel bf16 gradient is the
# f32 sum of the ranks' partial gradients, each rounded to bf16 (8
# significant bits) before the sum, where one process rounds the whole
# batch's gradient once. On random-label noise images the examples'
# gradients nearly cancel, so a partial's rounding is of the order of the
# sum, and the two runs' parameters part by a good fraction of a step
# (VGG16 after 2 steps: median 0.27, worst 0.37 of the step's own motion
# on an H100 80GB HBM3 at 700 W). The witness with the same rounding is one process
# taking its batch as SCALE_RANKS half-batch losses in one autograd
# (`split_step`): the ranks compute the same partials and sum them in the
# all-reduce instead of in autograd. 12a holds VGG16's parameters to that
# witness, VGG_SPLIT_MEDIAN / VGG_SPLIT_WORST of each tensor's motion
# (max |a - b| / max |b - p0|), and the scores to one process,
# VGG_SCALE_SCORE_RTOL; the distance from one process is reported.
VGG_SPLIT_MEDIAN, VGG_SPLIT_WORST, VGG_SCALE_SCORE_RTOL = 1e-3, 1e-2, 1e-2
# ResNet-50 in bf16 (12b, 2 x 64 against 128): its BN statistics are
# global, so no one-process split reproduces the ranks' rounding; the
# first step's score (the forward from the same parameters: the BN sums
# summed in two halves and across the ranks) is held to
# RESNET_BF16_SCORE_RTOL and the rest reported. Phase 6's tolerances
# hold in f32 (12b', 2 x 16 against 32, one Nesterovs step from init, as
# phase 6's lockstep): the score RESNET_SCORE_RTOL, the BN running
# statistics RESNET_STATE_RTOL of each tensor's largest entry, and the
# parameters, whose f32 gradient at init is ill-conditioned (phase 6),
# within SCALE_WITNESS times the distance of one process from itself
# with the batch's rows reversed (the same sums in another order).
RESNET_BF16_SCORE_RTOL = 1e-3
SCALE_WITNESS = 10.0
# 12d at the JAX tests' shapes and tolerances, on the card in f32 (TF32
# off): the TP stack 2e-5 / 2e-6, the pipeline 2e-5 / 1e-6, ring attention
# values 2e-5 / 2e-6 and gradients 5e-5 / 5e-6, bf16 values 0.05 / 0.02
TP_RTOL, TP_ATOL = 2e-5, 2e-6
PIPE_RTOL, PIPE_ATOL = 2e-5, 1e-6
RING_RTOL, RING_ATOL, RING_GRAD_RTOL, RING_GRAD_ATOL = 2e-5, 2e-6, 5e-5, 5e-6
RING_BF16_RTOL, RING_BF16_ATOL = 0.05, 0.02


def _scale_setup(rank, world, root, backend="gloo"):
    """A rank's process: the card, the port on the path, TF32 off, and the
    group (every collective bounded by SCALE_GROUP_TIMEOUT)."""
    import datetime

    os.environ.setdefault("DISABLE_CUPTI_LAZY_REINIT", "1")
    # the explicit meshes below only: no fit of a rank meshes by itself
    os.environ["DL4J_AUTO_MESH"] = "0"
    import torch
    import torch.distributed as dist

    torch.cuda.set_device(0)
    sys.path.insert(0, HERE)
    from deeplearning4j_tpu_torch.common.dtypes import default_policy

    default_policy().apply()
    dist.init_process_group(backend, init_method="file://" + os.path.join(root, "store"),
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=SCALE_GROUP_TIMEOUT))
    return torch, dist


def nccl_probe_rank(rank, world, root):
    """Two NCCL ranks on one card: records what NCCL does (it refuses a
    second rank on a GPU it already serves)."""
    torch, dist = _scale_setup(rank, world, root, backend="nccl")
    t = torch.ones(4, device="cuda")
    dist.all_reduce(t)  # raises here when NCCL refuses (no teardown of a failed group)
    torch.cuda.synchronize()
    dist.destroy_process_group()
    return float(t[0])


def _run_ranks(torch, fn, root, args=(), timeout=SCALE_JOIN_TIMEOUT, nprocs=SCALE_RANKS):
    """Spawn `nprocs` processes running fn(rank, nprocs, root, *args); each
    writes its result to root/rank<r>.json. A rank that raises makes this
    raise (torch.multiprocessing's ProcessRaisedException); ranks still
    running at the deadline are terminated and this raises."""
    import torch.multiprocessing as mp

    ctx = mp.start_processes(_rank_entry, args=(fn, nprocs, root, args), nprocs=nprocs,
                             join=False, start_method="spawn")
    deadline = time.monotonic() + timeout
    try:
        while not ctx.join(timeout=max(1.0, deadline - time.monotonic())):
            if time.monotonic() >= deadline:
                raise SmokeFailure(f"ranks of {fn.__name__} still running after {timeout} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.terminate()
                p.join(10)
    out = []
    for r in range(nprocs):
        with open(os.path.join(root, f"rank{r}.json")) as f:
            out.append(json.load(f))
    return out


def _rank_entry(rank, fn, world, root, args):
    res = fn(rank, world, root, *args)
    with open(os.path.join(root, f"rank{rank}.json"), "w") as f:
        json.dump(res, f)


def _host_copy(t):
    """A host copy of t (a copy also when t already lies on the host)."""
    return t.detach().to("cpu", copy=True)


def _flat_leaves(tree):
    from deeplearning4j_tpu_torch.utils.model_serializer import tree_leaves

    return tree_leaves(tree)


def _exact_sum(torch, tensors) -> int:
    """An order-free checksum of tensors' bits (int64 sum of their 32-bit
    or 16-bit words): equal replicas give equal sums."""
    tot = 0
    for t in tensors:
        t = t.detach().contiguous()
        w = t.view(torch.int32) if t.element_size() == 4 else t.view(torch.int16)
        tot += int(w.to(torch.int64).sum())
    return tot


def _step_dist(torch, got, ref, p0) -> tuple:
    """Per tensor max |got - ref| over max |ref - p0| (the reference's own
    motion): (median, worst)."""
    d = []
    for a, b, c in zip(got, ref, p0):
        b = b.to(a.device)
        motion = (b.double() - c.to(a.device).double()).abs().max().clamp_min(1e-30)
        d.append(float((a.double() - b.double()).abs().max() / motion))
    return float(np.median(d)), max(d)


def _rel_max(torch, got, ref) -> float:
    """Per tensor max |got - ref| over max |ref|, the worst."""
    return max(float((a.double() - b.to(a.device).double()).abs().max()
                     / b.double().abs().max().clamp_min(1e-30)) for a, b in zip(got, ref))


def _timed_steps(torch, IterationListener, net, data, steps=SCALE_TIMED_STEPS):
    """Synced seconds of each of `steps` more steps of `net` on `data`
    (warm: after the compared ones)."""
    from deeplearning4j_tpu_torch.data import ExistingDataSetIterator

    log = _StepLog(torch, IterationListener)
    net.set_listeners(log.listener)
    net.fit(ExistingDataSetIterator((data * steps)[:steps]), epochs=1, async_prefetch=False)
    return log.steps()


class _StepLog:
    """Scores (device tensors, read at the end) and synced step times."""

    def __init__(self, torch, IterationListener):
        log = self

        class L(IterationListener):
            def iteration_done(self, model, iteration, info):
                torch.cuda.synchronize()
                log.times.append(time.perf_counter())
                log.scores.append(info["score"]())

        self.listener, self.scores, self.times = L(), [], [time.perf_counter()]

    def values(self):
        return [float(s) for s in self.scores]

    def steps(self):
        return list(np.diff(self.times))


def split_step(torch, net, ds, parts=SCALE_RANKS):
    """One optimizer step of `net` on `ds` with the batch taken as `parts`
    equal slices whose losses (each its share of the batch mean) are summed
    in one autograd: the same bf16-rounded partial gradients the ranks of
    a data-parallel step sum, in one process. Returns the score."""
    x, y = ds.features, ds.labels
    b = x.shape[0] // parts

    def builder(p, states, data, rng):
        total = 0.0
        for i in range(parts):
            loss, st = net._loss(p, states, x[i * b:(i + 1) * b], y[i * b:(i + 1) * b],
                                 None, None, rng)
            total = total + loss / parts
        return total, st

    _, score = net._run_step(builder, (x, y, None, None))
    return score


def scale_rank(rank, world, root, seed):
    """One rank of phase 12 (12a VGG16, 12b ResNet-50 and the char-LSTM on
    the data-parallel step, 12d TP, pipeline and ring attention), over
    gloo with CUDA tensors. Returns its records; rank 0 also saves the
    parameters the main process compares."""
    torch, dist = _scale_setup(rank, world, root)
    try:
        return _scale_rank_body(torch, dist, rank, world, root, seed)
    finally:
        dist.destroy_process_group()


def _scale_rank_body(torch, dist, rank, world, root, seed):
    import torch.nn.functional as F

    from deeplearning4j_tpu_torch.data import DataSet, ExistingDataSetIterator
    from deeplearning4j_tpu_torch.models.charlstm import char_lstm_network
    from deeplearning4j_tpu_torch.models.resnet import resnet50_network
    from deeplearning4j_tpu_torch.models.vgg16 import vgg16_network
    from deeplearning4j_tpu_torch.ops import fused_conv_bn as fcb
    from deeplearning4j_tpu_torch.ops import fused_lstm as fl
    from deeplearning4j_tpu_torch.parallel.mesh import data_parallel_mesh
    from deeplearning4j_tpu_torch.parallel.sharded import MeshPlan
    from deeplearning4j_tpu_torch.train.listeners import IterationListener
    from deeplearning4j_tpu_torch.utils.metrics import get_registry

    reg = get_registry()
    books = {"bytes": reg.counter("allreduce_bytes_total", "").labels(),
             "estimate": reg.counter("train_step_collective_seconds", "",
                                     ("source",)).labels("estimate"),
             "measured": reg.counter("train_step_collective_seconds", "",
                                     ("source",)).labels("measured")}
    mesh = data_parallel_mesh()
    counts = LaunchCounts(fl, fcb)
    out = {"rank": rank}
    counts.reset()   # the main path's count starts here

    def delta(before):
        now = counts.read()
        return {k: now[k] - before.get(k, 0) for k in now}

    # 12a: VGG16, full width, bf16, global batch 32: 16 rows a rank
    data = vgg_batches(torch, F, DataSet, seed + 120, 1, VGG_SCALE_BATCH, 1000)
    runs, mono = {}, None
    for name, kw in (("monolithic", {"bucket_bytes": 0}), ("bucketed", {}),
                     ("bf16_wire", {"grad_dtype": "bf16"})):
        net = vgg16_network(image_size=PHASE9_IMAGE, seed=seed)
        plan = MeshPlan(mesh, sample_every=VGG_SCALE_STEPS, **kw)
        net.set_mesh(plan=plan)
        log = _StepLog(torch, IterationListener)
        net.set_listeners(log.listener)
        b0 = {k: c.value for k, c in books.items()}
        mesh.stats.reset()
        net.fit(ExistingDataSetIterator(data), epochs=VGG_SCALE_STEPS, async_prefetch=False)
        leaves = _flat_leaves(net.params_list)
        rec = {"scores": log.values(), "first_steps_s": log.steps(),
               "books": {k: c.value - b0[k] for k, c in books.items()},
               "payload": plan.grad_payload_bytes(net),
               "describe": plan.collective_describe(net),
               "stats": mesh.stats.snapshot(), "checksum": _exact_sum(torch, leaves),
               "n_params": sum(v.numel() for v in leaves)}
        if name == "monolithic":
            mono = [_host_copy(v) for v in leaves]
        elif name == "bucketed":
            rec["bit_equal_monolithic"] = all(torch.equal(a.cpu(), b)
                                              for a, b in zip(leaves, mono))
            if rank == 0:
                torch.save([_host_copy(v) for v in leaves], os.path.join(root, "vgg_rank0.pt"))
        else:
            rec["bf16_vs_f32_rel"] = _rel_max(torch, leaves, mono)
        plan.sample_every = 0
        rec["step_s"] = _timed_steps(torch, IterationListener, net, data)
        runs[name] = rec
        del net, plan
        torch.cuda.empty_cache()
    out["vgg16"] = runs
    del mono, data

    # 12b: ResNet-50, full width, bf16, global batch 128: 64 rows a rank
    data = resnet_batches(torch, F, DataSet, seed + 121, RESNET_SCALE_STEPS, RESNET_SCALE_BATCH,
                          size=SCALE_IMAGE)
    net = resnet50_network(image_size=SCALE_IMAGE, precision="bf16", seed=seed,
                           learning_rate=RESNET_LR)
    net.set_mesh(plan=MeshPlan(mesh, sample_every=0))
    log = _StepLog(torch, IterationListener)
    net.set_listeners(log.listener)
    b0 = {k: c.value for k, c in books.items()}
    mesh.stats.reset()
    c0 = counts.read()
    net.fit(ExistingDataSetIterator(data), epochs=1, async_prefetch=False)
    launches = delta(c0)
    stats = mesh.stats.snapshot()
    rn = {"scores": log.values(), "first_steps_s": log.steps(), "launches": launches,
          "books": {k: c.value - b0[k] for k, c in books.items()}, "stats": stats,
          "checksum": _exact_sum(torch, _flat_leaves([net.params_list, net.state_list]))}
    saved = {"bf16": {"params": [_host_copy(v) for v in _flat_leaves(net.params_list)],
                      "state": [_host_copy(v) for v in _flat_leaves(net.state_list)]}}
    rn["step_s"] = _timed_steps(torch, IterationListener, net, data)
    # a fused group on a gloo mesh: gloo's collectives cannot be captured,
    # so the group runs eagerly and counts a stated decline
    declined = reg.counter("fit_graph_declined_total", "", ("reason",)).labels("collective")
    d0 = declined.value
    net.set_listeners()
    net.set_fused_steps(RESNET_SCALE_STEPS)
    net.fit(ExistingDataSetIterator(data), epochs=1, async_prefetch=False)
    net.set_fused_steps(1)
    rn["fused_declined_collective"] = declined.value - d0
    # one more step under the profiler: the per-BN all-reduces' host and
    # device time (gloo: the copies to and from pinned host memory)
    from torch.profiler import ProfilerActivity, profile

    net.set_listeners()
    torch.cuda.synchronize()
    mesh.stats.reset()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        net.fit(ExistingDataSetIterator(data[:1]), epochs=1, async_prefetch=False)
        torch.cuda.synchronize()
    # host ms: the blocking all-reduce calls on the host clock (mesh.stats);
    # device ms: the profiler's device time under each collective's range
    # (its CPU and its GPU-annotation rows: the larger)
    host = mesh.stats.snapshot()
    rows = {}
    for e in prof.key_averages():
        if e.key.startswith("collective/"):
            site = e.key.split("/", 1)[1]
            r = rows.setdefault(e.key, {"calls": host.get(site, {}).get("calls", 0),
                                        "host_ms": host.get(site, {}).get("seconds", 0) * 1e3,
                                        "device_ms": 0.0})
            r["device_ms"] = max(r["device_ms"], getattr(e, "device_time_total", 0.0) / 1e3)
    rn["profile"] = rows
    del net, data
    torch.cuda.empty_cache()
    # 12b': f32, 2 x 16 against one process at 32, one step from init
    data = resnet_batches(torch, F, DataSet, seed + 124, 1, LOCKSTEP_BATCH, size=SCALE_IMAGE)
    net = resnet50_network(image_size=SCALE_IMAGE, precision="f32", seed=seed,
                           learning_rate=RESNET_LR)
    net.set_mesh(plan=MeshPlan(mesh, sample_every=0))
    log = _StepLog(torch, IterationListener)
    net.set_listeners(log.listener)
    net.fit(ExistingDataSetIterator(data), epochs=1, async_prefetch=False)
    rn["f32"] = {"scores": log.values()}
    saved["f32"] = {"params": [_host_copy(v) for v in _flat_leaves(net.params_list)],
                    "state": [_host_copy(v) for v in _flat_leaves(net.state_list)]}
    if rank == 0:
        torch.save(saved, os.path.join(root, "resnet_rank0.pt"))
    out["resnet50"] = rn
    del net, data, saved
    torch.cuda.empty_cache()

    # the char-LSTM at full width: one batch of [32, 100, 77], two TBPTT
    # segments of 50, 16 rows a rank
    g = torch.Generator(device="cuda").manual_seed(seed + 122)
    idx = torch.randint(0, VOCAB, (TRAIN_B, LSTM_SCALE_T + 1), generator=g, device="cuda")
    eye = torch.eye(VOCAB, device="cuda")
    lstm_data = [DataSet(eye[idx[:, :-1]], eye[idx[:, 1:]])]
    net = char_lstm_network(vocab_size=VOCAB, hidden=HIDDEN, layers=LAYERS, seed=seed,
                            learning_rate=TRAIN_LR)
    net.set_mesh()
    log = _StepLog(torch, IterationListener)
    net.set_listeners(log.listener)
    c0 = counts.read()
    net.fit(ExistingDataSetIterator(lstm_data), epochs=1, async_prefetch=False)
    out["charlstm"] = {"scores": log.values(), "launches": delta(c0)}
    del net
    out["launches"] = counts.read()   # the main path's count, read just after it ran

    # 12d: tensor, pipeline and sequence parallelism on the card
    out["parallel"] = _scale_parallel_checks(torch, rank, world)
    out["staged_bytes"] = mesh.staged_bytes
    out["transport"] = mesh.backend
    return out


def _scale_parallel_checks(torch, rank, world):
    """12d on this rank: the TP dense stack against the unsharded net,
    pipeline_apply against sequential_apply, ring attention against full
    attention (values and gradients). Point-to-point and all-gather of CUDA
    tensors stage through pinned host memory on gloo."""
    from deeplearning4j_tpu_torch.nn.conf import (
        DenseLayer, NeuralNetConfiguration, OutputLayer, Updater)
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    from deeplearning4j_tpu_torch.nn.params import flat_to_params
    from deeplearning4j_tpu_torch.parallel import mesh_2d, shard_params_tp
    from deeplearning4j_tpu_torch.parallel.mesh import Mesh, all_gather
    from deeplearning4j_tpu_torch.parallel.pipeline import (
        pipeline_apply, pipeline_parallel_mesh, sequential_apply, shard_stage_params)
    from deeplearning4j_tpu_torch.parallel.sequence import (
        SEQ_AXIS, full_attention, ring_attention_sharded)

    res = {}
    # TP: the JAX test's Dense stack, Adam, 2 epochs of 2 batches of 32
    conf = (NeuralNetConfiguration.builder().seed(11).updater(Updater.ADAM)
            .learning_rate(0.01).weight_init("xavier").list()
            .layer(DenseLayer(n_in=12, n_out=32, activation="tanh"))
            .layer(DenseLayer(n_in=32, n_out=16, activation="tanh"))
            .layer(OutputLayer(n_in=16, n_out=4, activation="softmax", loss="mcxent"))
            .build())
    g = torch.Generator().manual_seed(9)
    x = torch.randn((64, 12), generator=g).numpy()
    y = np.eye(4, dtype=np.float32)[torch.randint(0, 4, (64,), generator=g).numpy()]
    ref = MultiLayerNetwork(conf).init()
    ref.fit(x, y, batch_size=32, epochs=2, async_prefetch=False)
    tp = MultiLayerNetwork(conf).init()
    shard_params_tp(tp, mesh_2d(1, world))
    local = [tuple(p["W"].shape) for p in tp.params_list]
    tp.fit(x, y, batch_size=32, epochs=2, async_prefetch=False)
    glob = flat_to_params(tp.layer_confs, tp._global_params()[0], tp.params())
    ok = all(torch.allclose(a, b, rtol=TP_RTOL, atol=TP_ATOL)
             for a, b in zip(_flat_leaves(glob), _flat_leaves(ref.params_list)))
    res["tp"] = {"ok": ok, "local_w_shapes": local,
                 "max_abs": max(float((a - b).abs().max()) for a, b in
                                zip(_flat_leaves(glob), _flat_leaves(ref.params_list)))}

    # pipeline: 2 stages, 4 microbatches, D 16, B 32 (values and gradients)
    S, M, D, B = world, 4, 16, 32
    g = torch.Generator(device="cuda").manual_seed(4)
    W = torch.randn((S, D, D), generator=g, device="cuda") / D ** 0.5
    b = torch.randn((S, D), generator=g, device="cuda") * 0.1
    xp = torch.randn((B, D), generator=g, device="cuda")
    yp = torch.randn((B, D), generator=g, device="cuda")

    def stage(p, v):
        return torch.tanh(v @ p["W"] + p["b"])

    pmesh = pipeline_parallel_mesh()
    mine = shard_stage_params({"W": W, "b": b}, pmesh)
    for v in mine.values():
        v.requires_grad_(True)
    got = pipeline_apply(stage, mine, xp, mesh=pmesh, n_microbatches=M)
    gW, gb = torch.autograd.grad(((got - yp) ** 2).mean(), [mine["W"], mine["b"]])
    full = {"W": W.clone().requires_grad_(True), "b": b.clone().requires_grad_(True)}
    want = sequential_apply(stage, full, xp)
    rW, rb = torch.autograd.grad(((want - yp) ** 2).mean(), [full["W"], full["b"]])
    s = pmesh.axis_index("stage")
    res["pipeline"] = {
        "values_ok": bool(torch.allclose(got, want, rtol=PIPE_RTOL, atol=PIPE_ATOL)),
        "grads_ok": bool(torch.allclose(gW, rW[s:s + 1], rtol=PIPE_RTOL, atol=PIPE_ATOL)
                         and torch.allclose(gb, rb[s:s + 1], rtol=PIPE_RTOL, atol=PIPE_ATOL)),
        "max_abs": float((got - want).detach().abs().max())}

    # ring attention: B 2, T 16, H 4, D 8, causal and not, f32 and bf16
    smesh = Mesh(np.arange(world), (SEQ_AXIS,))
    Bq, T, H, Dh = 2, 16, 4, 8
    g = torch.Generator(device="cuda").manual_seed(5)
    q, k, v = (torch.randn((Bq, T, H, Dh), generator=g, device="cuda") * 0.5 for _ in range(3))
    Tl = T // world
    sl = slice(rank * Tl, (rank + 1) * Tl)
    ring = {}
    for causal in (False, True):
        fq, fk, fv = (t.clone().requires_grad_(True) for t in (q, k, v))
        fo = full_attention(fq, fk, fv, causal=causal)
        fgrads = torch.autograd.grad(fo.square().sum(), [fq, fk, fv])
        for dt in (torch.float32, torch.bfloat16):
            blocks = [t[:, sl].to(dt).detach().requires_grad_(True) for t in (q, k, v)]
            o = ring_attention_sharded(*blocks, mesh=smesh, causal=causal)
            whole = all_gather(o.transpose(0, 1).contiguous(), smesh, SEQ_AXIS).transpose(0, 1)
            grads = torch.autograd.grad(whole.float().square().sum(), blocks)
            key = f"{'causal' if causal else 'full'}_{str(dt)[6:]}"
            if dt == torch.float32:
                ok = bool(torch.allclose(whole, fo, rtol=RING_RTOL, atol=RING_ATOL)) and all(
                    torch.allclose(a, w[:, sl], rtol=RING_GRAD_RTOL, atol=RING_GRAD_ATOL)
                    for a, w in zip(grads, fgrads))
            else:
                ok = bool(torch.allclose(whole.float(), fo, rtol=RING_BF16_RTOL,
                                         atol=RING_BF16_ATOL)) and all(
                    bool(torch.isfinite(a).all()) for a in grads)
            ring[key] = {"ok": ok, "max_abs": float((whole.float() - fo).detach().abs().max())}
    res["ring"] = ring
    res["staged_bytes"] = smesh.staged_bytes + pmesh.staged_bytes
    return res


def nccl_world1_phase(torch, resnet50_network, F, DataSet, seed, root):
    """12c: a world-1 NCCL group. MeshPlan.reduce_grads on ResNet-50's
    bucketed gradients, eagerly and captured in a CUDA graph (after the
    eager call warmed the communicator): both return their input
    bit-equal. A world-1 meshed fit issues no collective and books 0
    bytes."""
    import datetime

    import torch.distributed as dist
    from torch.profiler import ProfilerActivity, profile

    from deeplearning4j_tpu_torch.data import ExistingDataSetIterator
    from deeplearning4j_tpu_torch.parallel.mesh import data_parallel_mesh
    from deeplearning4j_tpu_torch.parallel.sharded import MeshPlan
    from deeplearning4j_tpu_torch.utils.metrics import get_registry

    dist.init_process_group("nccl", init_method="file://" + os.path.join(root, "nccl1"),
                            rank=0, world_size=1,
                            timeout=datetime.timedelta(seconds=SCALE_GROUP_TIMEOUT))
    try:
        mesh = data_parallel_mesh()
        net = resnet50_network(image_size=SCALE_IMAGE, precision="bf16", seed=seed,
                               learning_rate=RESNET_LR)
        plan = MeshPlan(mesh).place_net(net)
        batch = resnet_batches(torch, F, DataSet, seed + 123, 1, 16, size=SCALE_IMAGE)[0]
        keys = [list(p) for p in net.params_list]
        leaves = [p[k] for p, ks in zip(net.params_list, keys) for k in ks]
        for v in leaves:
            v.requires_grad_(True)
        s_, _ = net._loss(net.params_list, net.state_list, [batch.features], [batch.labels],
                          None, None, None)
        flat = torch.autograd.grad(s_, leaves)
        for v in leaves:
            v.requires_grad_(False)
        it = iter(flat)
        grads = [{k: next(it).detach() for k in ks} for ks in keys]
        want = [{k: g.clone() for k, g in d.items()} for d in grads]
        score = s_.detach().float()

        def call():
            live = [dict(d) for d in grads]
            return plan.reduce_grads(net, live, score)

        eager, eager_score = call()
        eager_equal = all(torch.equal(eager[i][k], want[i][k]) for i in range(len(want))
                          for k in want[i]) and bool(torch.equal(eager_score, score))
        torch.cuda.synchronize()
        graph = torch.cuda.CUDAGraph()
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side), torch.cuda.graph(graph, stream=side):
            captured, captured_score = call()
        torch.cuda.current_stream().wait_stream(side)
        graph.replay()
        torch.cuda.synchronize()
        graph_equal = all(torch.equal(captured[i][k], want[i][k]) for i in range(len(want))
                          for k in want[i]) and bool(torch.equal(captured_score, score))
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            graph.replay()
            torch.cuda.synchronize()
        kernels = sorted({e.key[:60] for e in prof.key_averages()
                          if getattr(e, "self_device_time_total", 0) > 0})
        buckets = plan.collective_describe(net)["n_buckets"]
        # a world-1 meshed fit: no collective, 0 bytes
        ctr = get_registry().counter("allreduce_bytes_total", "").labels()
        b0 = ctr.value
        net.set_mesh(mesh)
        mesh.stats.reset()
        net.fit(ExistingDataSetIterator([batch]), epochs=1, async_prefetch=False)
        torch.cuda.synchronize()
        fit_books, fit_calls = ctr.value - b0, mesh.stats.snapshot()
        return {"eager_bit_equal": eager_equal, "graph_bit_equal": graph_equal,
                "graph_kernels": kernels, "nccl_kernels": [k for k in kernels if "nccl" in k.lower()],
                "buckets": buckets, "fit_books": fit_books, "fit_collectives": fit_calls,
                "transport": mesh.backend}
    finally:
        dist.destroy_process_group()


def scale_summary(p12) -> dict:
    """Phase 12's numbers for its JSON line: step p50s, books, collective
    seconds by source, the BN all-reduces' times, the distances from one
    process, and the transport of each."""
    v, r = p12["vgg16"], p12["resnet50"]
    prof = r["profile"]
    return {
        "transport": v["transport"], "ranks": SCALE_RANKS,
        "vgg16": {n: {"step_p50_s": float(np.median(x["step_s"])),
                      "allreduce_bytes_per_step": x["books"]["bytes"] / VGG_SCALE_STEPS,
                      "collective_seconds_estimate_per_step":
                          x["books"]["estimate"] / VGG_SCALE_STEPS,
                      "collective_seconds_measured_per_step":
                          x["books"]["measured"] / VGG_SCALE_STEPS}
                  for n, x in v["runs"].items()},
        "vgg16_one_process_step_p50_s": float(np.median(v["reference_step_s"])),
        "vgg16_vs_one_process": v["vs_one_process"],
        "resnet50": {"step_p50_s": float(np.median(r["step_s"])),
                     "one_process_step_p50_s": float(np.median(r["reference_step_s"])),
                     "launches_per_step": r["launches_per_step"],
                     "bn_allreduce": prof.get("collective/bn_stats"),
                     "grad_allreduce": prof.get("collective/grads"),
                     "vs_one_process": r["vs_one_process"], "witness": r["witness"],
                     "f32_vs_one_process": r["f32_vs_one_process"],
                     "f32_witness": r["f32_witness"]},
        "vgg16_vs_split_witness": v["vs_split"],
        "nccl_world1": {k: p12["nccl_world1"][k] for k in
                        ("eager_bit_equal", "graph_bit_equal", "nccl_kernels", "fit_books")},
        "nccl_two_ranks_one_gpu": p12["nccl_two_ranks_one_gpu"]["outcome"],
        "seconds": p12["seconds"]}


def scale_out_phase(torch, F, counts, metrics, seed, card):
    """12: the data-parallel step and the parallel helpers on the one card.
    The ranks are processes joined by gloo with CUDA tensors (NCCL takes
    one rank a GPU, 12c's probe records how it refuses a second); NCCL is
    held as one rank (12c). Scratch files go to _scale_smoke/, removed at
    the end."""
    import shutil

    from deeplearning4j_tpu_torch.data import DataSet, ExistingDataSetIterator
    from deeplearning4j_tpu_torch.models.charlstm import char_lstm_network
    from deeplearning4j_tpu_torch.models.resnet import resnet50_network
    from deeplearning4j_tpu_torch.models.vgg16 import vgg16_network
    from deeplearning4j_tpu_torch.train.listeners import IterationListener

    t_phase = time.perf_counter()
    shutil.rmtree(SCALE_DIR, ignore_errors=True)
    os.makedirs(SCALE_DIR)
    rec = {}
    try:
        # 12c first: two NCCL ranks on the one card (an observation: NCCL
        # takes one rank a GPU)
        probe = os.path.join(SCALE_DIR, "probe")
        os.makedirs(probe)
        try:
            _run_ranks(torch, nccl_probe_rank, probe, timeout=NCCL_PROBE_TIMEOUT)
            rec["nccl_two_ranks_one_gpu"] = {"outcome": "ran"}
        except Exception as e:  # the expected outcome: NCCL refuses
            msg = str(e)
            dup = "Duplicate GPU" in msg
            rec["nccl_two_ranks_one_gpu"] = {
                "outcome": "refused" if dup else "failed",
                "error": [ln for ln in msg.splitlines() if ln.strip()][-4:]}
        print(f"  12c two NCCL ranks on one card: {rec['nccl_two_ranks_one_gpu']}")

        # the one-process references, on this process
        leaves = _flat_leaves
        net = vgg16_network(image_size=PHASE9_IMAGE, seed=seed)
        p0 = [_host_copy(v) for v in leaves(net.params_list)]
        data = vgg_batches(torch, F, DataSet, seed + 120, 1, VGG_SCALE_BATCH, 1000)
        log = _StepLog(torch, IterationListener)
        net.set_listeners(log.listener)
        net.fit(ExistingDataSetIterator(data), epochs=VGG_SCALE_STEPS, async_prefetch=False)
        vgg_ref = {"scores": log.values(),
                   "params": [_host_copy(v) for v in leaves(net.params_list)]}
        vgg_ref["step_s"] = _timed_steps(torch, IterationListener, net, data)
        del net
        net = vgg16_network(image_size=PHASE9_IMAGE, seed=seed)
        split_scores = [float(split_step(torch, net, data[0])) for _ in range(VGG_SCALE_STEPS)]
        vgg_split = [_host_copy(v) for v in leaves(net.params_list)]
        del net, data
        torch.cuda.empty_cache()

        def resnet_ref(precision, batch, steps, seed_off, reverse):
            d = resnet_batches(torch, F, DataSet, seed + seed_off, steps, batch,
                               size=SCALE_IMAGE)
            if reverse:
                d = [DataSet(b.features.flip(0), b.labels.flip(0)) for b in d]
            n = resnet50_network(image_size=SCALE_IMAGE, precision=precision, seed=seed,
                                 learning_rate=RESNET_LR)
            p_init = [_host_copy(v) for v in leaves(n.params_list)]
            lg = _StepLog(torch, IterationListener)
            n.set_listeners(lg.listener)
            n.fit(ExistingDataSetIterator(d), epochs=1, async_prefetch=False)
            r = {"scores": lg.values(), "p0": p_init,
                 "params": [_host_copy(v) for v in leaves(n.params_list)],
                 "state": [_host_copy(v) for v in leaves(n.state_list)]}
            if not reverse:
                r["step_s"] = _timed_steps(torch, IterationListener, n, d)
            del n, d
            torch.cuda.empty_cache()
            return r

        rn_ref = resnet_ref("bf16", RESNET_SCALE_BATCH, RESNET_SCALE_STEPS, 121, False)
        rn_wit = resnet_ref("bf16", RESNET_SCALE_BATCH, RESNET_SCALE_STEPS, 121, True)
        f32_ref = resnet_ref("f32", LOCKSTEP_BATCH, 1, 124, False)
        f32_wit = resnet_ref("f32", LOCKSTEP_BATCH, 1, 124, True)
        g = torch.Generator(device="cuda").manual_seed(seed + 122)
        idx = torch.randint(0, VOCAB, (TRAIN_B, LSTM_SCALE_T + 1), generator=g, device="cuda")
        eye = torch.eye(VOCAB, device="cuda")
        lnet = char_lstm_network(vocab_size=VOCAB, hidden=HIDDEN, layers=LAYERS, seed=seed,
                                 learning_rate=TRAIN_LR)
        lg = _StepLog(torch, IterationListener)
        lnet.set_listeners(lg.listener)
        lnet.fit(ExistingDataSetIterator([DataSet(eye[idx[:, :-1]], eye[idx[:, 1:]])]),
                 epochs=1, async_prefetch=False)
        lstm_ref = lg.values()
        del lnet
        torch.cuda.empty_cache()
        torch.cuda.synchronize()

        # the ranks
        t0 = time.perf_counter()
        ranks = _run_ranks(torch, scale_rank, SCALE_DIR, args=(seed,))
        rec["ranks_seconds"] = time.perf_counter() - t0
        r0 = ranks[0]

        # 12a
        a = {name: r0["vgg16"][name] for name in r0["vgg16"]}
        f32_bytes = 4 * VGG16_PARAMS
        vgg_rank0 = torch.load(os.path.join(SCALE_DIR, "vgg_rank0.pt"), map_location="cuda")
        one = _step_dist(torch, vgg_rank0, vgg_ref["params"], p0)
        split = _step_dist(torch, vgg_rank0, vgg_split, p0)
        split_one = _step_dist(torch, [v.to("cuda") for v in vgg_split], vgg_ref["params"], p0)
        srel = max(abs(x - y) / abs(y) for x, y in zip(a["bucketed"]["scores"],
                                                       vgg_ref["scores"]))
        del vgg_rank0, p0, vgg_split
        rec["vgg16"] = {
            "runs": {n: {k: v for k, v in r.items() if k != "checksum"} for n, r in a.items()},
            "reference_scores": vgg_ref["scores"], "reference_step_s": vgg_ref["step_s"],
            "split_scores": split_scores,
            "vs_one_process": {"param_median": one[0], "param_worst": one[1], "score_rel": srel},
            "vs_split": {"param_median": split[0], "param_worst": split[1]},
            "split_vs_one_process": {"param_median": split_one[0], "param_worst": split_one[1]},
            "transport": r0["transport"]}
        for name, r in a.items():
            st = r["step_s"]
            print(f"  12a VGG16 {name}: 2 ranks x 16 (gloo, CUDA tensors, 2 processes on one "
                  f"card), step p50 {np.median(st):.3f} s (the first of the compared steps "
                  f"{r['first_steps_s'][0]:.3f} s), books "
                  f"{r['books']['bytes'] / VGG_SCALE_STEPS / 1e6:.2f} MB a step, "
                  f"{r['describe'].get('n_buckets', 1)} bucket(s), collective seconds a step: "
                  f"estimate {r['books']['estimate'] / VGG_SCALE_STEPS:.5f} (NVLink's figure; "
                  f"no link is crossed here), measured "
                  f"{r['books']['measured'] / VGG_SCALE_STEPS:.4f} (gloo, host loopback), "
                  f"on {card}")
        print(f"  12a bucketed == monolithic bit for bit: {a['bucketed']['bit_equal_monolithic']}; "
              f"bf16 vs f32 wire params max rel {a['bf16_wire']['bf16_vs_f32_rel']:.2e}; 2 ranks "
              f"vs the split witness: params median {split[0]:.2e} worst {split[1]:.2e}; vs 1 "
              f"process (batch 32, step p50 {np.median(vgg_ref['step_s']):.3f} s): params "
              f"median {one[0]:.2e} worst {one[1]:.2e} (the split witness itself {split_one[0]:.2e}"
              f" / {split_one[1]:.2e}), score rel {srel:.2e}")
        for name in a:
            check(all(r["vgg16"][name]["checksum"] == a[name]["checksum"] for r in ranks),
                  f"12a: the ranks' VGG16 parameters differ after the {name} run")
        check(a["bucketed"]["bit_equal_monolithic"] and
              a["bucketed"]["scores"] == a["monolithic"]["scores"],
              "12a: the bucketed run is not bit-equal to the monolithic one")
        check(a["monolithic"]["n_params"] == VGG16_PARAMS,
              f"12a: VGG16 has {a['monolithic']['n_params']} parameters")
        for name in ("monolithic", "bucketed"):
            check(a[name]["books"]["bytes"] == f32_bytes * VGG_SCALE_STEPS,
                  f"12a: {name} booked {a[name]['books']['bytes']} bytes, expected "
                  f"{f32_bytes} a step")
        check(a["bf16_wire"]["books"]["bytes"] * 2 == a["bucketed"]["books"]["bytes"],
              "12a: the bf16 wire does not halve the books")
        check(split[0] <= VGG_SPLIT_MEDIAN and split[1] <= VGG_SPLIT_WORST
              and srel <= VGG_SCALE_SCORE_RTOL,
              f"12a: 2 ranks vs the split witness: params median {split[0]:.2e} worst "
              f"{split[1]:.2e} (bounds {VGG_SPLIT_MEDIAN}, {VGG_SPLIT_WORST}); score rel to 1 "
              f"process {srel:.2e} (bound {VGG_SCALE_SCORE_RTOL})")

        # 12b
        b = r0["resnet50"]
        got = torch.load(os.path.join(SCALE_DIR, "resnet_rank0.pt"), map_location="cuda")

        def dists(run, ref):
            return {"score": max(abs(x - y) / abs(y) for x, y in zip(run["scores"],
                                                                     ref["scores"])),
                    "first_score": abs(run["scores"][0] - ref["scores"][0]) / abs(
                        ref["scores"][0]),
                    "state": _rel_max(torch, run["state"], ref["state"]),
                    "params": _step_dist(torch, run["params"], ref["params"], ref["p0"])}

        mine = dists({"scores": b["scores"], **got["bf16"]}, rn_ref)
        wit = dists(rn_wit, rn_ref)
        mine32 = dists({"scores": b["f32"]["scores"], **got["f32"]}, f32_ref)
        wit32 = dists(f32_wit, f32_ref)
        del got
        prof = b["profile"]
        rec["resnet50"] = {"launches_per_step": {k: v / RESNET_SCALE_STEPS
                                                 for k, v in b["launches"].items()},
                           "step_s": b["step_s"], "reference_step_s": rn_ref["step_s"],
                           "vs_one_process": mine, "witness": wit,
                           "f32_vs_one_process": mine32, "f32_witness": wit32,
                           "profile": prof, "stats": b["stats"], "books": b["books"],
                           "fused_declined_collective": b["fused_declined_collective"],
                           "transport": r0["transport"]}
        pb = prof.get("collective/bn_stats", {})
        pg = prof.get("collective/grads", {})
        print(f"  12b ResNet-50 bf16 2 ranks x 64 (gloo): step p50 {np.median(b['step_s']):.3f} s "
              f"vs 1 process at 128 {np.median(rn_ref['step_s']):.3f} s; K4-K8 a step a rank "
              f"{rec['resnet50']['launches_per_step']}; a profiled step's {pb.get('calls')} BN "
              f"all-reduces: host {pb.get('host_ms', 0):.1f} ms, device "
              f"{pb.get('device_ms', 0):.2f} ms; {pg.get('calls')} gradient all-reduces: host "
              f"{pg.get('host_ms', 0):.1f} ms, device {pg.get('device_ms', 0):.2f} ms (gloo: "
              f"copies through pinned host memory), on {card}")
        print(f"  12b bf16 2 ranks vs 1 process {mine}; witness (rows reversed) {wit}")
        print(f"  12b' f32 2 ranks x 16 vs 1 process at {LOCKSTEP_BATCH}, one step {mine32}; "
              f"witness {wit32}")
        check(all(r["resnet50"]["checksum"] == b["checksum"] for r in ranks),
              "12b: the ranks' ResNet-50 parameters or BN statistics differ")
        # a rank's 64 rows route as a 64-row step (the coverage table)
        per_rank = resnet_per_step(RESNET_SCALE_BATCH // 2, "bf16", SCALE_IMAGE)
        for k, per in per_rank.items():
            check(b["launches"].get(k, 0) == per * RESNET_SCALE_STEPS,
                  f"12b: {k} launched {b['launches'].get(k, 0)} times a rank in "
                  f"{RESNET_SCALE_STEPS} steps, expected {per} a step")
        # a BN after a covered conv all-reduces twice a step (K6's sums,
        # K7's), one after a declined conv three times (the builtin
        # forward's mean, then its sums about it; K7's)
        n_bn, n_k6 = per_rank["bn_backward_apply"], per_rank["bn_apply"]
        bn_per_step = 2 * n_k6 + 3 * (n_bn - n_k6)
        bn_calls = b["stats"].get("bn_stats", {}).get("calls", 0)
        check(bn_calls == bn_per_step * RESNET_SCALE_STEPS,
              f"12b: {bn_calls} BN all-reduces, expected {bn_per_step} a step")
        check(pb.get("calls") == bn_per_step,
              f"12b: the profile shows {pb} for the BN all-reduces")
        check(b["fused_declined_collective"] == 1,
              f"12b: a fused group on the gloo mesh counted "
              f"{b['fused_declined_collective']} collective declines, expected 1")
        check(mine["first_score"] <= RESNET_BF16_SCORE_RTOL,
              f"12b: bf16 first score rel {mine['first_score']:.2e} "
              f"(bound {RESNET_BF16_SCORE_RTOL})")
        check(mine32["score"] <= RESNET_SCORE_RTOL and mine32["state"] <= RESNET_STATE_RTOL
              and mine32["params"][0] <= SCALE_WITNESS * max(wit32["params"][0], 1e-6)
              and mine32["params"][1] <= SCALE_WITNESS * max(wit32["params"][1], 1e-6),
              f"12b': f32 2 ranks vs 1 process {mine32}; witness {wit32} (score "
              f"{RESNET_SCORE_RTOL}, statistics {RESNET_STATE_RTOL}, parameters "
              f"{SCALE_WITNESS} x the witness)")
        # the char-LSTM on the data-parallel step
        c = r0["charlstm"]
        for k in ("lstm_sequence", "lstm_sequence_backward"):
            check(c["launches"].get(k, 0) == 2 * LAYERS,
                  f"12b: char-LSTM {k} launched {c['launches'].get(k, 0)} times a rank in 2 "
                  f"segments, expected {LAYERS} a segment")
        lrel = abs(c["scores"][0] - lstm_ref[0]) / abs(lstm_ref[0])
        check(lrel <= TRAIN_SCORE_RTOL and all(math.isfinite(s) for s in c["scores"]),
              f"12b: char-LSTM first score 2 ranks {c['scores'][0]} vs 1 process "
              f"{lstm_ref[0]} (rel {lrel:.2e})")
        rec["charlstm"] = {"scores": c["scores"], "reference_scores": lstm_ref,
                           "first_score_rel": lrel, "launches": c["launches"]}
        print(f"  12b char-LSTM 2 ranks x 16, 2 TBPTT segments: K1/K3 {c['launches']}; "
              f"first score rel to 1 process {lrel:.1e}")

        # 12d
        for r in ranks:
            p = r["parallel"]
            check(p["tp"]["ok"], f"12d: TP vs unsharded on rank {r['rank']}: {p['tp']}")
            check(p["pipeline"]["values_ok"] and p["pipeline"]["grads_ok"],
                  f"12d: pipeline vs sequential on rank {r['rank']}: {p['pipeline']}")
            for k, v in p["ring"].items():
                check(v["ok"], f"12d: ring attention {k} on rank {r['rank']}: {v}")
            check(p["staged_bytes"] > 0, "12d: no point-to-point was staged on gloo")
        rec["parallel"] = r0["parallel"]
        print(f"  12d TP (1x2) max |diff| {r0['parallel']['tp']['max_abs']:.1e}, pipeline "
              f"(S 2, M 4) {r0['parallel']['pipeline']['max_abs']:.1e}, ring "
              + ", ".join(f"{k} {v['max_abs']:.1e}" for k, v in r0["parallel"]["ring"].items())
              + f"; {r0['parallel']['staged_bytes']} bytes staged through pinned host memory")

        # 12c: one NCCL rank
        torch.cuda.empty_cache()
        n1 = nccl_world1_phase(torch, resnet50_network, F, DataSet, seed, SCALE_DIR)
        check(n1["eager_bit_equal"] and n1["graph_bit_equal"],
              f"12c: reduce_grads on one NCCL rank did not return its input: {n1}")
        check(n1["fit_books"] == 0 and not n1["fit_collectives"],
              f"12c: a world-1 meshed fit booked {n1['fit_books']} bytes, "
              f"{n1['fit_collectives']}")
        rec["nccl_world1"] = n1
        print(f"  12c one NCCL rank: reduce_grads over {n1['buckets']} buckets bit-equal eager "
              f"and replayed from a CUDA graph; NCCL kernels in the replay "
              f"{n1['nccl_kernels'] or 'none'}; a world-1 meshed fit booked "
              f"{n1['fit_books']:.0f} bytes and issued {len(n1['fit_collectives'])} collectives")
        rec["launches"] = r0["launches"]
        rec["seconds"] = time.perf_counter() - t_phase
        print(f"  phase 12 took {rec['seconds']:.1f} s ({rec['ranks_seconds']:.1f} s in the ranks)")
        return rec
    finally:
        shutil.rmtree(SCALE_DIR, ignore_errors=True)


# -- phase 13: the serving front end -------------------------------------------------------

SERVE_T = 100              # the char-LSTM requests' sequence length (13a, 13c)
SERVE_MAX_BATCH = 32       # ParallelInference max_batch_size; buckets 1, 2, 4, ..., 32
SERVE_CLIENTS = 16         # client threads (13a /predict, 13b)
SERVE_PREDICTS = 128       # 13a /predict requests
SERVE_SLOTS = 8            # 13a decode slots
POOL_REQUESTS = 192        # 13b requests through the ReplicaPool
POOL_REPLICAS = 2
POOL_IMAGE = 224
OVERLOAD_SECONDS = 3.0     # 13c
OVERLOAD_DEADLINE_MS = 100.0
OVERLOAD_QUEUE = 64
OVERLOAD_PROBE_SECONDS = 1.0  # 13c's closed-loop capacity probe, before the overload
SERVE_GEN_CLIENTS = 8      # 13a /generate client threads, beside the /predict ones
SERVE_HTTP_TIMEOUT = 120


def request_sizes(rng, n, top=SERVE_MAX_BATCH):
    """`n` request sizes in 1..top drawn with weight 1/size (bench.py's
    serving profile: small requests dominate)."""
    sizes = np.arange(1, top + 1)
    p = 1.0 / sizes
    return [int(s) for s in rng.choice(sizes, size=n, p=p / p.sum())]


def prometheus_parses(text: str) -> int:
    """The number of samples in a Prometheus text exposition; raises if a
    line is neither a comment nor `name{labels} value`."""
    import re

    pat = re.compile(r'^[a-zA-Z_:][a-zA-Z0-9_:]*(\{([a-zA-Z_][a-zA-Z0-9_]*="(\\.|[^"\\])*",?)*\})?'
                     r' (-?[0-9.eE+-]+|NaN|[+-]Inf)$')
    n = 0
    for line in text.splitlines():
        if not line or line.startswith("#"):
            continue
        check(pat.match(line) is not None, f"13a: unparsable Prometheus line {line!r}")
        float(line.rsplit(" ", 1)[1])
        n += 1
    return n


def latency_stats(lat, wall, examples) -> dict:
    lat = sorted(lat)
    return {"requests": len(lat), "examples": examples, "seconds": wall,
            "requests_per_s": len(lat) / wall, "examples_per_s": examples / wall,
            "p50_ms": float(np.percentile(lat, 50)) * 1e3 if lat else None,
            "p99_ms": float(np.percentile(lat, 99)) * 1e3 if lat else None}


def bucket_device_share(torch, net, make_x, bucket_hits, wall) -> dict:
    """Device ms of one warm forward at each bucket that traffic hit
    (torch.profiler, device activity only) and its synced host wall, and
    the device's busy share over the traffic's wall estimated from them:
    sum over buckets of hits x device ms, over the wall."""
    rows, busy_ms = {}, 0.0
    for b, hits in bucket_hits.items():
        if not hits:
            continue
        x = make_x(int(b))
        dev = device_ms(torch, lambda: net.output(x), reps=5)
        t = time.perf_counter()
        for _ in range(5):
            net.output(x)
        torch.cuda.synchronize()
        rows[str(b)] = {"hits": hits, "device_ms": dev,
                        "host_ms": (time.perf_counter() - t) / 5 * 1e3}
        busy_ms += hits * (dev or 0.0)
    return {"by_bucket": rows, "device_s": busy_ms / 1e3,
            "busy_share_est": busy_ms / 1e3 / wall}


def run_clients(n_clients, jobs, fn):
    """`jobs` spread over `n_clients` threads, each taking the next job
    index until none is left; fn(i) per job. Returns (per-job results or
    exceptions, wall seconds)."""
    import threading

    out = [None] * len(jobs)
    nxt = [0]
    lock = threading.Lock()

    def worker():
        while True:
            with lock:
                i = nxt[0]
                nxt[0] += 1
            if i >= len(jobs):
                return
            try:
                out[i] = fn(i)
            except Exception as e:  # recorded; the caller decides
                out[i] = e

    threads = [threading.Thread(target=worker, name=f"smoke-client-{k}", daemon=True)
               for k in range(n_clients)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    check(not any(t.is_alive() for t in threads), "13: a client thread hung")
    return out, time.perf_counter() - t0


def post_json(url, payload, headers=None, timeout=SERVE_HTTP_TIMEOUT):
    import urllib.request

    req = urllib.request.Request(url, data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json",
                                          **(headers or {})})
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        return resp.status, resp.read()


def get_body(url, timeout=SERVE_HTTP_TIMEOUT):
    import urllib.request

    with urllib.request.urlopen(url, timeout=timeout) as resp:
        return resp.read()


def charlstm_server_phase(torch, counts, metrics, seed, card, device="cuda"):
    """13a: the full-width char-LSTM behind InferenceServer, /predict and
    /generate traffic at once over HTTP on 127.0.0.1."""
    import threading

    from deeplearning4j_tpu_torch.models.charlstm import char_lstm_network
    from deeplearning4j_tpu_torch.serving import InferenceServer
    from deeplearning4j_tpu_torch.utils import resourcemeter

    rng = np.random.default_rng(seed + 13)
    net = char_lstm_network(vocab_size=VOCAB, hidden=HIDDEN, layers=LAYERS, seed=seed,
                            device=device)
    resourcemeter.enable()
    t0 = time.perf_counter()
    server = InferenceServer(net, port=0, max_batch_size=SERVE_MAX_BATCH,
                             warmup_shape=(SERVE_T, VOCAB), decode_slots=SERVE_SLOTS,
                             decode_tenant_weights={"a": 3.0, "b": 1.0})
    t_warm = time.perf_counter() - t0
    eng = server.decode
    port = server.start()
    base = f"http://127.0.0.1:{port}"
    try:
        warm_compiles = net.output_compile_count
        captures0 = dict(eng.metrics()["captures"])
        check(warm_compiles == len(server.inference.buckets),
              f"13a: warm-up made {warm_compiles} forward-cache entries for "
              f"{len(server.inference.buckets)} buckets")
        sizes = request_sizes(rng, SERVE_PREDICTS)
        tokens = [rng.integers(0, VOCAB, (n, SERVE_T)) for n in sizes]
        eye = np.eye(VOCAB, dtype=np.int8)
        # phase 4's generate mix: prompts of 1-32 tokens, 32-64 new tokens,
        # tenants a:b = 3:1 by X-Tenant, one request streamed
        grng = np.random.default_rng(seed + 1)
        gens = [(grng.integers(0, VOCAB, size=int(grng.integers(1, 33))).tolist(),
                 int(grng.integers(32, 65)), "a" if i % 4 else "b") for i in range(24)]
        stream_idx = 5
        lat = {"predict": [None] * len(sizes), "generate": [None] * len(gens)}

        def predict(i):
            body = {"features": eye[tokens[i]].tolist()}
            t = time.perf_counter()
            status, raw = post_json(f"{base}/predict", body)
            lat["predict"][i] = time.perf_counter() - t
            check(status == 200, f"13a: /predict answered {status}")
            return np.asarray(json.loads(raw)["predictions"], np.float32)

        def generate(i):
            prompt, mx, tenant = gens[i]
            body = {"prompt": prompt, "max_tokens": mx, "stream": i == stream_idx}
            t = time.perf_counter()
            status, raw = post_json(f"{base}/generate", body, headers={"X-Tenant": tenant})
            lat["generate"][i] = time.perf_counter() - t
            check(status == 200, f"13a: /generate answered {status}")
            if i != stream_idx:
                return json.loads(raw)["tokens"]
            lines = [json.loads(ln) for ln in raw.decode().splitlines() if ln]
            streamed = [ln["token"] for ln in lines[:-1]]
            check(lines[-1].get("done") and lines[-1]["tokens"] == streamed,
                  f"13a: the NDJSON stream's tokens and its closing line disagree: {lines[-1]}")
            return streamed

        counts.reset()
        hits0 = decode_hits(metrics)
        # the /generate clients run beside the /predict clients, so decode
        # steps interleave with bucket forwards on the card
        gen_res = {}
        gen_thread = threading.Thread(
            target=lambda: gen_res.update(zip(("out", "wall"), run_clients(
                SERVE_GEN_CLIENTS, list(range(len(gens))), generate))),
            name="smoke-generate-clients", daemon=True)
        gen_thread.start()
        preds, wall = run_clients(SERVE_CLIENTS, list(range(len(sizes))), predict)
        gen_thread.join(timeout=600)
        check(not gen_thread.is_alive(), "13a: the /generate clients hung")
        if device == "cuda":
            torch.cuda.synchronize()
        launches = counts.read()
        hits = decode_hits(metrics) - hits0
        gen_out = gen_res["out"]
        bad = [repr(o) for o in list(preds) + list(gen_out) if isinstance(o, Exception)]
        check(not bad, f"13a: requests failed: {bad[:3]}")
        pm = json.loads(get_body(f"{base}/metrics"))
        tenants = json.loads(get_body(f"{base}/tenants"))
        prom = get_body(f"{base}/metrics?format=prometheus").decode()
        health = json.loads(get_body(f"{base}/health"))
        em = eng.metrics()
        after_compiles = net.output_compile_count
    finally:
        server.stop()
        resourcemeter.disable()
    # holds
    check(after_compiles == warm_compiles,
          f"13a: traffic added {after_compiles - warm_compiles} forward-cache entries after warm-up")
    check(sum(pm["bucket_hits"].values()) == pm["batches"],
          f"13a: bucket hits {pm['bucket_hits']} do not sum to {pm['batches']} batches")
    check(pm["admitted"] == pm["completed"] == len(sizes) and pm["conservation_ok"],
          f"13a: /predict books {pm}")
    check(em["captures"] == captures0 == {1: 2},
          f"13a: decode captures {captures0} at warm-up, {em['captures']} after traffic")
    check(tenants["conservation"]["ok"], f"13a: /tenants conservation {tenants['conservation']}")
    for tier, books in tenants["books_by_tier"].items():
        for t, b in books.items():
            check(b["conservation_ok"], f"13a: tier {tier} tenant {t} books {b}")
    spent = {t: rec["device_seconds"] for t, rec in tenants["tenants"].items()}
    check(spent.get("a", {}).get("decode", 0) > 0 and spent.get("b", {}).get("decode", 0) > 0,
          f"13a: decode spend by tenant {spent}")
    n_prom = prometheus_parses(prom)
    # K1: one launch per GravesLSTM layer per bucket forward; K2: one per
    # layer per decode step replay (K = 1), as many lstm_decode_step hits
    k1, k2 = launches["lstm_sequence"], launches["lstm_step"]
    if device == "cuda":
        check(k1 == LAYERS * pm["batches"],
              f"13a: {k1} K1 launches for {pm['batches']} forwards of {LAYERS} layers")
        check(k2 == LAYERS * em["steps"] == hits and k2 > 0,
              f"13a: {k2} K2 launches, {hits} lstm_decode_step hits, {em['steps']} steps")
    # every /generate equals the sequential greedy rnn_time_step loop
    bad = [i for i, (p, mx, _) in enumerate(gens)
           if gen_out[i] != greedy_reference(torch, net, p, mx)]
    check(not bad, f"13a: /generate tokens differ from the sequential loop for {bad}")
    # every /predict row against output() of that request alone
    errs, bit_equal = [], 0
    for i, n in enumerate(sizes):
        ref = net.output(np.eye(VOCAB, dtype=np.float32)[tokens[i]]).float().cpu().numpy()
        err = float(np.abs(preds[i] - ref).max())
        errs.append(err)
        bit_equal += int(np.array_equal(preds[i], ref))
    check(max(errs) <= SLICE_ATOL,
          f"13a: a /predict row differs from its own output() by {max(errs)} > {SLICE_ATOL}")
    n_ex = sum(sizes)
    share = None
    if device == "cuda":
        share = bucket_device_share(
            torch, net, lambda b: torch.from_numpy(
                np.eye(VOCAB, dtype=np.float32)[rng.integers(0, VOCAB, (b, SERVE_T))]).cuda(),
            pm["bucket_hits"], wall)
    rec = {"warmup_s": t_warm, "forward_compiles": warm_compiles,
           "compiles_after_traffic": after_compiles - warm_compiles,
           "batches": pm["batches"], "bucket_hits": pm["bucket_hits"],
           "decode_captures": em["captures"], "decode_steps": em["steps"],
           "k1_launches": k1, "k2_launches": k2, "launches": launches,
           "predict_max_abs_err": max(errs), "predict_rows_bit_equal": bit_equal,
           "predict_requests": len(sizes), "prometheus_samples": n_prom,
           "server_latency_ms": pm["latency_ms"], "device": share,
           "health": health["status"],
           "tenants": {t: {"device_seconds": v["device_seconds"], "tokens": v["tokens"],
                           "books": v["books"]} for t, v in tenants["tenants"].items()},
           "predict": latency_stats(lat["predict"], wall, n_ex),
           "generate": {**latency_stats(lat["generate"], gen_res["wall"],
                                        sum(len(g) for g in gen_out)),
                        "tokens": sum(len(g) for g in gen_out)},
           "wall_s": wall}
    print(f"  13a /predict: {len(sizes)} requests ({n_ex} examples, sizes 1-{SERVE_MAX_BATCH} "
          f"weighted 1/n) from {SERVE_CLIENTS} client threads over HTTP, beside 24 /generate "
          f"from {SERVE_GEN_CLIENTS}, {wall:.2f} s: {rec['predict']['requests_per_s']:.1f} requests/s, "
          f"{rec['predict']['examples_per_s']:.1f} examples/s, p50 "
          f"{rec['predict']['p50_ms']:.1f} ms p99 {rec['predict']['p99_ms']:.1f} ms on {card}")
    print(f"  13a /generate: {rec['generate']['tokens']} tokens, p50 "
          f"{rec['generate']['p50_ms']:.1f} ms p99 {rec['generate']['p99_ms']:.1f} ms; tokens equal "
          f"the sequential loop (one streamed as NDJSON)")
    print(f"  13a holds: rows vs own output() max abs {max(errs):.3e} (tolerance {SLICE_ATOL}), "
          f"{bit_equal}/{len(sizes)} bit-equal; forward-cache entries after warm-up "
          f"{after_compiles - warm_compiles}; {pm['batches']} batches = bucket hits "
          f"{pm['bucket_hits']}; K1 {k1} = {LAYERS} x forwards, K2 {k2} = {LAYERS} x "
          f"{em['steps']} steps; decode captures {em['captures']} before and after; "
          f"books conserve per tenant and tier; {n_prom} Prometheus samples parse")
    print(f"  13a where the time goes: in-server /predict latency (admission to result) p50 "
          f"{pm['latency_ms']['p50_ms']} ms p99 {pm['latency_ms']['p99_ms']} ms against the "
          f"clients' {rec['predict']['p50_ms']:.1f} / {rec['predict']['p99_ms']:.1f} ms (the rest "
          f"is JSON and HTTP on the host); bucket forwards "
          + (", ".join(f"{b}: {v['device_ms']:.3f} ms device / {v['host_ms']:.3f} ms host"
                       for b, v in share["by_bucket"].items())
             + f"; device busy ~{share['busy_share_est']:.4f} of the wall" if share else "")
          + f" on {card}")
    del net
    return rec


def resnet_pool_phase(torch, counts, seed, card, device="cuda", image=POOL_IMAGE):
    """13b: ResNet-50 (bf16) through a ReplicaPool of two replicas sharing
    the weights, in-process; one eviction in mid-run."""
    import threading

    from deeplearning4j_tpu_torch.models.resnet import resnet50_network
    from deeplearning4j_tpu_torch.parallel.inference import ReplicaPool

    rng = np.random.default_rng(seed + 15)
    net = resnet50_network(precision="bf16", image_size=image, seed=seed, device=device)
    pool = ReplicaPool(net, n_replicas=POOL_REPLICAS, max_batch_size=SERVE_MAX_BATCH,
                       component_prefix="smoke_pool")
    try:
        t0 = time.perf_counter()
        pool.warmup((image, image, 3))
        t_warm = time.perf_counter() - t0
        warm_compiles = net.output_compile_count
        images = rng.standard_normal((SERVE_MAX_BATCH, image, image, 3)).astype(np.float32)
        sizes = request_sizes(rng, POOL_REQUESTS)
        offs = [int(rng.integers(0, SERVE_MAX_BATCH - n + 1)) for n in sizes]
        lat = [None] * len(sizes)
        done = [0]
        lock = threading.Lock()
        evictor = threading.Thread(target=lambda: pool.evict(0, "evicted in mid-run"),
                                   name="smoke-evictor", daemon=True)

        def call(i):
            x = images[offs[i]:offs[i] + sizes[i]]
            t = time.perf_counter()
            try:
                return pool.output(x)
            finally:
                lat[i] = time.perf_counter() - t
                with lock:
                    done[0] += 1
                    if done[0] == len(sizes) // 2:
                        evictor.start()  # on its own thread, while traffic runs

        counts.reset()
        out, wall = run_clients(SERVE_CLIENTS, list(range(len(sizes))), call)
        evictor.join(timeout=120)
        check(not evictor.is_alive(), "13b: the mid-run eviction did not finish")
        if device == "cuda":
            torch.cuda.synchronize()
        launches = counts.read()
        m = pool.metrics()
        after_compiles = net.output_compile_count
    finally:
        pool.shutdown()
    errors = [(i, o) for i, o in enumerate(out) if isinstance(o, Exception)]
    for i, e in errors:
        check(isinstance(e, RuntimeError) and "in flight" in str(e),
              f"13b: request {i} saw {e!r}, not the in-flight group's failure")
    check(len(errors) <= SERVE_MAX_BATCH and sum(sizes[i] for i, _ in errors) <= SERVE_MAX_BATCH,
          f"13b: {len(errors)} failures are more than the one group in flight")
    check(m["admitted"] == m["completed"] + m["shed"] + m["failed"],
          f"13b: books {m['admitted']} admitted != {m['completed']} + {m['shed']} + {m['failed']}")
    # the books count attempts: a request queued on the evicted replica is
    # booked failed there and served by its sibling (ReplicaPool resubmits
    # it), so failed >= the failures callers saw, and completed == served
    check(m["completed"] == len(sizes) - len(errors) and m["failed"] >= len(errors)
          and m["shed"] == 0,
          f"13b: books {m['completed']} completed / {m['failed']} failed / {m['shed']} shed, "
          f"{len(errors)} errors seen of {len(sizes)}")
    check(m["evictions"] == 1 and m["respawns"] == 1 and m["in_rotation"] == POOL_REPLICAS,
          f"13b: evictions {m['evictions']}, respawns {m['respawns']}, "
          f"in rotation {m['in_rotation']}")
    check(after_compiles == warm_compiles,
          f"13b: {after_compiles - warm_compiles} forward-cache entries after warm-up")
    conv_bn = {k: launches.get(k, 0) for k in ("conv1x1_stats", "conv_kxk_stats", "bn_apply",
                                               "bn_backward_reduce", "bn_backward_apply")}
    # inference declines K4/K5 ("inference", ops/fused_conv_bn.py, as in the
    # JAX package) and BN normalises with its running statistics (no K6),
    # and nothing runs backward (K7/K8)
    check(not any(conv_bn.values()), f"13b: conv/BN kernels launched while serving: {conv_bn}")
    # rows against each request's own output(), bf16 rule
    worst = 0.0
    bit_equal = 0
    for i, o in enumerate(out):
        if isinstance(o, Exception):
            continue
        x = images[offs[i]:offs[i] + sizes[i]]
        ref = net.output(torch.from_numpy(x).to(device)).float().cpu().numpy()
        excess = float((np.abs(o - ref) / np.maximum(1.0, np.abs(ref))).max())
        worst = max(worst, excess)
        bit_equal += int(np.array_equal(o, ref))
    check(worst <= BF16_ULP, f"13b: a served row differs from its own output() by "
                             f"{worst} x max(1, |v|) > {BF16_ULP}")
    served = [lat[i] for i, o in enumerate(out) if not isinstance(o, Exception)]
    n_ex = sum(sizes[i] for i, o in enumerate(out) if not isinstance(o, Exception))
    share = None
    if device == "cuda":
        share = bucket_device_share(
            torch, net, lambda b: torch.from_numpy(images[:b]).cuda(), m["bucket_hits"], wall)
    rec = {"warmup_s": t_warm, "forward_compiles": warm_compiles, "batches": m["batches"],
           "bucket_hits": {str(k): v for k, v in m["bucket_hits"].items()},
           "failed_in_flight": len(errors), "evictions": m["evictions"],
           "respawns": m["respawns"], "launches": launches, "conv_bn_launches": conv_bn,
           "max_rel_err": worst, "rows_bit_equal": bit_equal, "device": share,
           "books": {k: m[k] for k in ("admitted", "completed", "shed", "failed", "rejected")},
           "predict": latency_stats(served, wall, n_ex)}
    print(f"  13b ResNet-50 bf16 {image}x{image}x3 through ReplicaPool({POOL_REPLICAS}): "
          f"{len(sizes)} requests ({n_ex} images served), {SERVE_CLIENTS} clients, "
          f"{wall:.2f} s: {rec['predict']['requests_per_s']:.1f} requests/s, "
          f"{rec['predict']['examples_per_s']:.1f} images/s, p50 {rec['predict']['p50_ms']:.1f} ms "
          f"p99 {rec['predict']['p99_ms']:.1f} ms on {card}")
    print(f"  13b holds: evict(0) in mid-run -> {len(errors)} in-flight failures, 1 respawn, "
          f"books {rec['books']}; rows vs own output() {worst:.3e} x max(1,|v|) "
          f"(tolerance {BF16_ULP}), {bit_equal} bit-equal; K4-K8 launches {conv_bn} "
          f"(inference declines the conv kernels; BN uses running statistics)")
    if share:
        print("  13b where the time goes: bucket forwards "
              + ", ".join(f"{b}: {v['device_ms']:.3f} ms device / {v['host_ms']:.3f} ms host"
                          for b, v in share["by_bucket"].items())
              + f"; device busy ~{share['busy_share_est']:.4f} of the wall on {card}")
    del net
    return rec


def overload_phase(torch, counts, seed, card, device="cuda"):
    """13c: the char-LSTM pipeline of 13a in-process under about twice the
    load it can serve within the deadline, for OVERLOAD_SECONDS."""
    import threading

    from deeplearning4j_tpu_torch.models.charlstm import char_lstm_network
    from deeplearning4j_tpu_torch.parallel.inference import (
        _WAIT_SHED_GRACE,
        DeadlineExceeded,
        ParallelInference,
        RequestRejected,
    )

    rng = np.random.default_rng(seed + 16)
    net = char_lstm_network(vocab_size=VOCAB, hidden=HIDDEN, layers=LAYERS, seed=seed,
                            device=device)
    eye = np.eye(VOCAB, dtype=np.float32)
    pool_x = [eye[rng.integers(0, VOCAB, (n, SERVE_T))] for n in request_sizes(rng, 64)]
    pi = ParallelInference(net, max_batch_size=SERVE_MAX_BATCH, queue_capacity=OVERLOAD_QUEUE,
                           component_prefix="smoke_overload")
    try:
        pi.warmup((SERVE_T, VOCAB))

        def closed_loop(n_clients, seconds, deadline_ms):
            stop = threading.Event()
            lat, shed, fails = [], [0], []
            lock = threading.Lock()
            depth = [0]

            def client(k):
                j = k
                while not stop.is_set():
                    x = pool_x[j % len(pool_x)]
                    j += n_clients
                    t = time.perf_counter()
                    try:
                        pi.output(x, deadline_ms=deadline_ms)
                        with lock:
                            lat.append(time.perf_counter() - t)
                    except (DeadlineExceeded, RequestRejected) as e:
                        with lock:
                            shed[0] += 1
                        # a client backs off as a 429's Retry-After says
                        time.sleep(min(max(0.002, e.retry_after),
                                       OVERLOAD_DEADLINE_MS / 1e3))
                    except Exception as e:
                        with lock:
                            fails.append(repr(e))

            threads = [threading.Thread(target=client, args=(k,), daemon=True,
                                        name=f"smoke-overload-{k}") for k in range(n_clients)]
            t0 = time.perf_counter()
            for t in threads:
                t.start()
            while time.perf_counter() - t0 < seconds:
                depth[0] = max(depth[0], pi._q.qsize())
                time.sleep(0.005)
            stop.set()
            for t in threads:
                t.join(timeout=60)
            check(not any(t.is_alive() for t in threads), "13c: a client hung")
            return lat, shed[0], fails, depth[0], time.perf_counter() - t0

        # capacity: SERVE_CLIENTS closed-loop clients, no deadline
        lat0, _, fails0, _, wall0 = closed_loop(SERVE_CLIENTS, OVERLOAD_PROBE_SECONDS, None)
        check(not fails0 and lat0, f"13c: the capacity probe failed: {fails0[:3]}")
        capacity = len(lat0) / wall0
        # twice what the pipeline can finish within one deadline, kept in
        # flight by as many closed-loop clients
        n_clients = int(min(256, max(2 * SERVE_CLIENTS,
                                     math.ceil(2 * capacity * OVERLOAD_DEADLINE_MS / 1e3))))
        m0 = pi.metrics()
        counts.reset()
        lat, shed, fails, depth, wall = closed_loop(n_clients, OVERLOAD_SECONDS,
                                                    OVERLOAD_DEADLINE_MS)
        if device == "cuda":
            torch.cuda.synchronize()
        launches = counts.read()
        m = pi.metrics()
    finally:
        pi.shutdown()
    check(not fails, f"13c: requests failed under overload: {fails[:3]}")
    d = {k: m[k] - m0[k] for k in ("admitted", "completed", "shed", "failed", "rejected")}
    check(m["conservation_ok"] and d["admitted"] == d["completed"] + d["shed"] + d["failed"],
          f"13c: books {d}")
    check(depth <= OVERLOAD_QUEUE, f"13c: queue depth {depth} > capacity {OVERLOAD_QUEUE}")
    offered = d["admitted"] + d["rejected"]
    shed_rate = (d["shed"] + d["rejected"]) / max(1, offered)
    p99 = float(np.percentile(lat, 99)) * 1e3 if lat else None
    bound_ms = OVERLOAD_DEADLINE_MS + _WAIT_SHED_GRACE * 1e3
    check(lat and p99 <= bound_ms + 1000.0,
          f"13c: admitted p99 {p99} ms past the deadline + wait grace {bound_ms} ms")
    if device == "cuda":
        check(launches["lstm_sequence"] == LAYERS * (m["batches"] - m0["batches"]),
              f"13c: K1 launches {launches['lstm_sequence']} for "
              f"{m['batches'] - m0['batches']} forwards")
    rec = {"capacity_requests_per_s": capacity, "clients": n_clients, "seconds": wall,
           "books": d, "shed_rate": shed_rate, "shed_by": m["shed_by"],
           "completed_per_s": d["completed"] / wall,
           "admitted_p50_ms": float(np.percentile(lat, 50)) * 1e3, "admitted_p99_ms": p99,
           "deadline_ms": OVERLOAD_DEADLINE_MS, "max_queue_depth": depth,
           "queue_capacity": OVERLOAD_QUEUE, "launches": launches}
    print(f"  13c overload: closed-loop capacity {capacity:.1f} requests/s with "
          f"{SERVE_CLIENTS} clients; {n_clients} clients for {wall:.2f} s with deadline "
          f"{OVERLOAD_DEADLINE_MS:.0f} ms, queue capacity {OVERLOAD_QUEUE}: shed rate "
          f"{shed_rate:.3f} ({d['shed']} shed + {d['rejected']} refused of {offered}), "
          f"admitted p50 {rec['admitted_p50_ms']:.1f} ms p99 {p99:.1f} ms vs the "
          f"{OVERLOAD_DEADLINE_MS:.0f} ms deadline, largest queue depth {depth} of "
          f"{OVERLOAD_QUEUE}, books {d} conserve; on {card}")
    del net
    return rec


def serving_phase(torch, counts, metrics, seed, card, device="cuda"):
    """13: the serving front end (InferenceServer, ParallelInference,
    ReplicaPool) at full width."""
    t_phase = time.perf_counter()
    rec = {"charlstm_server": charlstm_server_phase(torch, counts, metrics, seed, card, device)}
    if device == "cuda":
        torch.cuda.empty_cache()
    rec["resnet_pool"] = resnet_pool_phase(torch, counts, seed, card, device)
    if device == "cuda":
        torch.cuda.empty_cache()
    rec["overload"] = overload_phase(torch, counts, seed, card, device)
    rec["seconds"] = time.perf_counter() - t_phase
    print(f"  phase 13 took {rec['seconds']:.1f} s")
    return rec


def serving_summary(p13, card) -> dict:
    a, b, c = p13["charlstm_server"], p13["resnet_pool"], p13["overload"]
    return {"card": card,
            "13a_charlstm_predict": a["predict"], "13a_charlstm_generate": a["generate"],
            "13b_resnet50_pool": b["predict"],
            "13c_overload": {k: c[k] for k in ("capacity_requests_per_s", "clients",
                                               "shed_rate", "admitted_p99_ms", "deadline_ms",
                                               "max_queue_depth", "queue_capacity")}}


# -- phase 14: the parameter-server path and the run ledger --------------------

# 14a: bench.py's bench_recsys configuration, not cut (vocab 800,000 x dim
# 64 = a 195.3 MB f32 table on 2 in-process endpoints)
RECSYS_VOCAB, RECSYS_DIM, RECSYS_HIDDEN, RECSYS_BATCH = 800_000, 64, 192, 1024
RECSYS_WARMUP, RECSYS_STEPS, RECSYS_ENDPOINTS = 6, 40, 2
RECSYS_CACHE_ROWS, RECSYS_ALPHA, RECSYS_LR = 65536, 1.1, 0.05
RECSYS_LAT_MS = (10.0, 60.0)   # the injected pull latency: clamp(compute_ms, 10, 60)
RECSYS_HOLD_STEPS = 8          # card against CPU: the synchronous arm's first steps
RECSYS_RTOL, RECSYS_ATOL = 1e-4, 1e-6   # f32, TF32 off (phase 11's bound)
RECSYS_TENANT = "recsys"
RECSYS_DIR = os.path.join(HERE, "_recsys_smoke")
# 14b: the recsys preset's defaults (vocab 100,000, dim 64, hidden 128),
# the table on the card
FIT14_BATCHES, FIT14_BATCH, FIT14_HOLD_STEPS, FIT14_ALPHA = 20, 1024, 3, 1.2
# 14c: the char-LSTM entry points with a ledger
LEDGER_PI_CALLS, LEDGER_DECODE_REQUESTS, LEDGER_HTTP_REQUESTS = 32, 8, 8
LEDGER_T, LEDGER_MAX_BATCH, LEDGER_DEADLINE_MS = 50, 8, 5000.0
# thread names the parameter-server path must not leave behind
PS_THREAD_PREFIXES = ("dl4j-sparse", "dl4j-ps-", "dl4j-paramserver")


def _close_excess(torch, got, want, rtol, atol) -> float:
    """max(|got - want| - rtol * |want|) - atol: <= 0 when they agree."""
    got, want = torch.as_tensor(got).double().cpu(), torch.as_tensor(want).double().cpu()
    return float(((got - want).abs() - rtol * want.abs()).max()) - atol


def _ledger_delta(runledger, path, prefix) -> float:
    samples = list(runledger.iter_samples(runledger.read_ledger(path)))
    total = [sum(v for k, v in vals.items() if k.startswith(prefix) and ":" not in k)
             for _, vals in samples]
    return total[-1] - total[0]


def recsys_ps_phase(torch, seed, card):
    """14a: the recsys tower over the sharded parameter server at
    bench_recsys's configuration, pipelined (cache + prefetch) and
    synchronous (neither) under one injected pull latency, with a run
    ledger and its SLO rules attached; then the synchronous arm's first
    steps on the card against the CPU."""
    import contextlib
    import shutil
    import threading

    from torch.profiler import ProfilerActivity, profile

    from deeplearning4j_tpu_torch.analysis import slo
    from deeplearning4j_tpu_torch.data.recsys import zipf_cdf, zipf_ids
    from deeplearning4j_tpu_torch.models.recsys import (
        TOWER_KEYS,
        tower_init,
        tower_step,
        train_over_paramserver,
    )
    from deeplearning4j_tpu_torch.utils import faultpoints, resourcemeter, runledger
    from deeplearning4j_tpu_torch.utils.metrics import get_registry

    cdf = zipf_cdf(RECSYS_VOCAB, RECSYS_ALPHA)
    n_batches = RECSYS_WARMUP + RECSYS_STEPS + 1
    batches = [zipf_ids(RECSYS_BATCH, RECSYS_VOCAB, RECSYS_ALPHA, seed=seed * 1000 + k,
                        cdf=cdf) for k in range(n_batches)]
    labels = [(ids & 1).astype(np.int64) for ids in batches]
    p0 = tower_init(RECSYS_DIM, RECSYS_HIDDEN, generator=torch.Generator().manual_seed(seed),
                    device="cuda")

    # calibrate: the injected latency tracks the tower's measured step
    emb0 = torch.zeros((RECSYS_BATCH, RECSYS_DIM), device="cuda")
    y0 = torch.zeros(RECSYS_BATCH, dtype=torch.int64, device="cuda")
    tower_step(p0, emb0, y0, RECSYS_LR)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(5):
        tower_step(p0, emb0, y0, RECSYS_LR)
    torch.cuda.synchronize()
    compute_ms = (time.perf_counter() - t0) / 5 * 1e3
    lat_ms = float(min(RECSYS_LAT_MS[1], max(RECSYS_LAT_MS[0], compute_ms)))

    shutil.rmtree(RECSYS_DIR, ignore_errors=True)
    os.makedirs(RECSYS_DIR)
    was_metered = resourcemeter.is_enabled()
    resourcemeter.enable()
    device_us = []
    try:
        sample_every = 0.5
        rules = slo.default_rule_pack(sample_every=sample_every,
                                      tenants={RECSYS_TENANT: 1.0})
        rules.append(slo.SLORule(
            name="paramserver_push_dropped", kind="rate_of_change",
            series="paramserver_client_push_dropped_total", op=">", value=0.0,
            severity=slo.ERROR, component="paramserver", for_seconds=0.0))
        rules.append(slo.SLORule(
            name="sparse_prefetch_unhealthy", kind="threshold",
            series='component_health{component="sparse_prefetch"}', op=">=", value=2.0,
            severity=slo.ERROR, component="sparse_prefetch", for_seconds=0.0))
        ledger = runledger.RunLedger(os.path.join(RECSYS_DIR, "recsys.jsonl"),
                                     sample_every=sample_every, rules=rules)
        runledger.attach(ledger)

        @contextlib.contextmanager
        def profiled_window():
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                yield
            device_us.append(sum(getattr(e, "self_device_time_total", 0.0)
                                 for e in prof.key_averages()))

        def arm(prefetch, cache_rows, window=contextlib.nullcontext):
            out = train_over_paramserver(
                np.zeros((RECSYS_VOCAB, RECSYS_DIM), np.float32), batches, labels, p0,
                lr=RECSYS_LR, warmup=RECSYS_WARMUP, endpoints=RECSYS_ENDPOINTS,
                cache_rows=cache_rows, prefetch=prefetch, tenant=RECSYS_TENANT,
                window=window)
            pulls = out["pull_seconds"]
            out.update(
                examples_per_s=out["examples"] / out["seconds"],
                step_ms=out["seconds"] / RECSYS_STEPS * 1e3,
                pull_p50_ms=float(np.percentile(pulls, 50)) * 1e3,
                pull_p99_ms=float(np.percentile(pulls, 99)) * 1e3,
                hit_rate=out["stats"]["hit_rate"])
            return out

        plan = faultpoints.FaultPlan(seed=seed).add(
            "paramserver_rpc", "latency", p=1.0, latency_ms=lat_ms)
        reg = get_registry()
        with faultpoints.active(plan):
            piped = arm(True, RECSYS_CACHE_ROWS, profiled_window)
            sync = arm(False, 0)
        cons = resourcemeter.conservation(reg.scalar_values())
        ledger.close()
        spend = resourcemeter.spend_table(reg.scalar_values())
    finally:
        runledger.detach()
        if not was_metered:
            resourcemeter.disable()
    fired_errors = ledger.rules.ever_fired(slo.ERROR)
    leaked = [t.name for t in threading.enumerate() if t.name.startswith(PS_THREAD_PREFIXES)]
    busy = device_us[0] / 1e6 / piped["seconds"]

    for name, a in (("pipelined", piped), ("synchronous", sync)):
        st = a["stats"]
        check(st["pull_rows"] == st["cache_hit"] + st["cache_miss"],
              f"14a: the {name} arm's books do not conserve: {st}")
    check(sync["stats"]["cache_hit"] == 0, "14a: the synchronous arm hit a cache")
    tower_equal = all(torch.equal(piped["params"][k], sync["params"][k]) for k in TOWER_KEYS)
    tables_equal = all(np.array_equal(a.view(np.uint32), b.view(np.uint32))
                       for a, b in zip(piped["tables"], sync["tables"]))
    check(tower_equal, "14a: the tower differs between the pipelined and synchronous arms")
    check(tables_equal, "14a: the endpoints' tables differ between the arms after flush")
    check(not leaked, f"14a: threads left behind: {leaked}")
    check(cons["ok"], f"14a: tenant spend does not conserve: {cons}")
    check(not fired_errors, f"14a: error-severity SLO rules fired: {fired_errors}")
    ratio = piped["examples_per_s"] / sync["examples_per_s"]
    print(f"  14a: recsys over {RECSYS_ENDPOINTS} endpoints, vocab {RECSYS_VOCAB} x dim "
          f"{RECSYS_DIM} ({RECSYS_VOCAB * RECSYS_DIM * 4 / 2 ** 20:.1f} MB f32), hidden "
          f"{RECSYS_HIDDEN}, batch {RECSYS_BATCH}, {RECSYS_WARMUP} + {RECSYS_STEPS} steps, "
          f"zipf {RECSYS_ALPHA}: tower compute_ms {compute_ms:.4f} (host clock, synced), "
          f"injected pull latency {lat_ms:.1f} ms on {card}")
    for name, a in (("pipelined", piped), ("synchronous", sync)):
        print(f"    {name}: {a['examples_per_s']:.1f} examples/s, step {a['step_ms']:.3f} ms, "
              f"pull p50 {a['pull_p50_ms']:.3f} ms p99 {a['pull_p99_ms']:.3f} ms, hit rate "
              f"{a['hit_rate']:.4f}; books {a['stats']}")
    print(f"    pipelined/synchronous {ratio:.3f}; pipelined busy share {busy:.5f} "
          f"({device_us[0] / 1e3:.3f} ms of device under torch.profiler over "
          f"{piped['seconds']:.3f} s); tower and tables byte-equal {tower_equal and tables_equal};"
          f" no thread left; spend conserves; SLO fired {ledger.rules.ever_fired()}, "
          f"errors {fired_errors}")

    # card against CPU: the synchronous arm's first steps, no injected latency
    hold = {}
    for dev in ("cuda", "cpu"):
        hold[dev] = train_over_paramserver(
            np.zeros((RECSYS_VOCAB, RECSYS_DIM), np.float32), batches, labels,
            {k: v.to(dev) for k, v in p0.items()}, lr=RECSYS_LR, steps=RECSYS_HOLD_STEPS,
            endpoints=RECSYS_ENDPOINTS)
    touched = np.unique(np.concatenate(batches[:RECSYS_HOLD_STEPS]))
    owner = touched % RECSYS_ENDPOINTS
    tower_x = max(_close_excess(torch, hold["cuda"]["params"][k], hold["cpu"]["params"][k],
                                RECSYS_RTOL, RECSYS_ATOL) for k in TOWER_KEYS)
    rows_x = max(_close_excess(torch, hold["cuda"]["tables"][s][touched[owner == s]],
                               hold["cpu"]["tables"][s][touched[owner == s]],
                               RECSYS_RTOL, RECSYS_ATOL) for s in range(RECSYS_ENDPOINTS))
    check(tower_x <= 0 and rows_x <= 0,
          f"14a: card vs CPU after {RECSYS_HOLD_STEPS} synchronous steps: tower excess "
          f"{tower_x:.3g}, rows excess {rows_x:.3g} over rtol {RECSYS_RTOL} atol {RECSYS_ATOL}")
    print(f"    card vs CPU, the synchronous arm's first {RECSYS_HOLD_STEPS} steps: tower and "
          f"{touched.size} touched rows within rtol {RECSYS_RTOL} / atol {RECSYS_ATOL} (worst "
          f"excess tower {tower_x:.3g}, rows {rows_x:.3g}; TF32 off)")
    shutil.rmtree(RECSYS_DIR, ignore_errors=True)

    def summary(a):
        return {k: a[k] for k in ("examples_per_s", "step_ms", "pull_p50_ms", "pull_p99_ms",
                                  "hit_rate", "seconds", "examples", "stats")}

    return {"compute_ms": compute_ms, "injected_latency_ms": lat_ms,
            "pipelined": summary(piped), "synchronous": summary(sync),
            "ratio": ratio, "busy_share": busy, "device_ms": device_us[0] / 1e3,
            "byte_equal": tower_equal and tables_equal, "slo_fired": ledger.rules.ever_fired(),
            "tenant_spend": spend.get(RECSYS_TENANT), "conservation_ok": cons["ok"],
            "hold_excess": {"tower": tower_x, "rows": rows_x}}


def recsys_fit_phase(torch, seed, card):
    """14b: the recsys preset (table on the card) through the normal fit
    with a run ledger and a PerformanceListener; its first steps against
    the CPU."""
    import shutil

    from deeplearning4j_tpu_torch.data import DataSet, ExistingDataSetIterator
    from deeplearning4j_tpu_torch.data.recsys import zipf_batches
    from deeplearning4j_tpu_torch.models.recsys import recsys_conf, recsys_network
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    from deeplearning4j_tpu_torch.train.listeners import PerformanceListener
    from deeplearning4j_tpu_torch.utils import runledger

    net = recsys_network(host_resident=False, seed=seed, device="cuda")
    vocab = net.layer_confs[0].n_in
    stream = zipf_batches(FIT14_BATCH, vocab, FIT14_ALPHA, seed=seed)
    data = []
    for _ in range(FIT14_BATCHES):
        ids, lab = next(stream)
        data.append(DataSet(ids.reshape(-1, 1).astype(np.float32),
                            np.eye(2, dtype=np.float32)[lab]))

    # card against CPU: the first steps from the same initial parameters
    twins = {}
    for dev in ("cuda", "cpu"):
        tw = MultiLayerNetwork(recsys_conf(host_resident=False, seed=seed), device=dev).init()
        tw.params_list = [{k: v.detach().to(dev).clone() for k, v in p.items()}
                          for p in net.params_list]
        tw.fit(ExistingDataSetIterator(data[:FIT14_HOLD_STEPS]), async_prefetch=False)
        twins[dev] = tw
    hold_x = max(_close_excess(torch, twins["cuda"].params_list[i][k],
                               twins["cpu"].params_list[i][k], RECSYS_RTOL, RECSYS_ATOL)
                 for i, p in enumerate(net.params_list) for k in p)
    check(hold_x <= 0, f"14b: card vs CPU after {FIT14_HOLD_STEPS} steps: worst excess "
                       f"{hold_x:.3g} over rtol {RECSYS_RTOL} atol {RECSYS_ATOL}")
    del twins

    shutil.rmtree(RECSYS_DIR, ignore_errors=True)
    os.makedirs(RECSYS_DIR)
    path = os.path.join(RECSYS_DIR, "fit.jsonl")
    lines = []
    net.set_listeners(PerformanceListener(frequency=5, print_fn=lines.append))
    t0 = time.perf_counter()
    net.fit(ExistingDataSetIterator(data), run_ledger=path)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    man = runledger.read_ledger(path)["manifest"]
    steps = _ledger_delta(runledger, path, "fit_step_total")
    mfus = [float(ln.rsplit("mfu ", 1)[1].split()[0]) for ln in lines if "mfu " in ln]
    shutil.rmtree(RECSYS_DIR, ignore_errors=True)
    check(runledger.current() is None, "14b: the fit left its ledger attached")
    check(steps == FIT14_BATCHES, f"14b: the ledger's fit_step_total grew by {steps}, "
                                  f"expected {FIT14_BATCHES}")
    check(man["devices"].get("platform") == "gpu"
          and man["devices"].get("device_kind") == torch.cuda.get_device_name(0),
          f"14b: the manifest names {man['devices']}")
    check(man.get("flops_source") == "analytic", f"14b: flops_source {man.get('flops_source')}")
    check(mfus and all(0 < m <= 1 for m in mfus), f"14b: the listener's mfu: {lines}")
    flops, _ = net.model_flops_per_example()
    print(f"  14b: recsys_network(host_resident=False) vocab {vocab}, fit {FIT14_BATCHES} x "
          f"{FIT14_BATCH} with run_ledger= and PerformanceListener: {wall:.3f} s "
          f"({FIT14_BATCHES * FIT14_BATCH / wall:.0f} examples/s with the first step's "
          f"set-up); ledger fit_step_total +{steps:.0f}, device {man['devices']['device_kind']},"
          f" flops_source {man['flops_source']} ({flops:.0f} FLOP an example); listener: "
          f"{' | '.join(lines)}")
    print(f"    card vs CPU after {FIT14_HOLD_STEPS} steps: within rtol {RECSYS_RTOL} / atol "
          f"{RECSYS_ATOL} (worst excess {hold_x:.3g}) on {card}")
    return {"seconds": wall, "examples_per_s": FIT14_BATCHES * FIT14_BATCH / wall,
            "ledger_fit_steps": steps, "device_kind": man["devices"]["device_kind"],
            "flops_source": man["flops_source"], "flops_per_example": flops,
            "listener": lines, "mfu": mfus, "hold_excess": hold_x}


def ledger_serving_phase(torch, counts, seed, card):
    """14c: ParallelInference, DecodeEngine and InferenceServer, each with
    run_ledger=<path>, on the full-width char-LSTM."""
    import shutil

    from deeplearning4j_tpu_torch.analysis import slo
    from deeplearning4j_tpu_torch.models.charlstm import char_lstm_network
    from deeplearning4j_tpu_torch.parallel.inference import ParallelInference
    from deeplearning4j_tpu_torch.serving import InferenceServer
    from deeplearning4j_tpu_torch.serving.decode import DecodeEngine
    from deeplearning4j_tpu_torch.utils import runledger

    rng = np.random.default_rng(seed + 14)
    net = char_lstm_network(vocab_size=VOCAB, hidden=HIDDEN, layers=LAYERS, seed=seed,
                            device="cuda")
    eye = np.eye(VOCAB, dtype=np.float32)
    serving = {"default_deadline_ms": LEDGER_DEADLINE_MS, "queue_capacity": 64}
    pack = slo.default_rule_pack(serving=serving)
    shutil.rmtree(RECSYS_DIR, ignore_errors=True)
    os.makedirs(RECSYS_DIR)
    paths = {k: os.path.join(RECSYS_DIR, f"{k}.jsonl") for k in ("pi", "decode", "server")}
    out = {}
    counts.reset()
    try:
        pi = ParallelInference(net, max_batch_size=LEDGER_MAX_BATCH,
                               queue_capacity=serving["queue_capacity"],
                               default_deadline_ms=LEDGER_DEADLINE_MS, run_ledger=paths["pi"])
        try:
            for n in request_sizes(rng, LEDGER_PI_CALLS, LEDGER_MAX_BATCH):
                y = np.asarray(pi.output(eye[rng.integers(0, VOCAB, (n, LEDGER_T))]))
                check(y.shape == (n, LEDGER_T, VOCAB) and np.isfinite(y).all(),
                      f"14c: output() gave {y.shape}")
        finally:
            pi.shutdown()
        eng = DecodeEngine(net, n_slots=SERVE_SLOTS, run_ledger=paths["decode"]).warmup()
        try:
            futs = [eng.generate(rng.integers(0, VOCAB, 4).tolist(), max_new_tokens=16)
                    for _ in range(LEDGER_DECODE_REQUESTS)]
            check(all(len(f.result(timeout=SERVE_HTTP_TIMEOUT)) == 16 for f in futs),
                  "14c: a decode request did not finish")
        finally:
            eng.shutdown()
        server = InferenceServer(net, port=0, max_batch_size=LEDGER_MAX_BATCH,
                                 warmup_shape=(LEDGER_T, VOCAB),
                                 queue_capacity=serving["queue_capacity"],
                                 default_deadline_ms=LEDGER_DEADLINE_MS,
                                 run_ledger=paths["server"])
        base = f"http://127.0.0.1:{server.start()}"
        try:
            for _ in range(LEDGER_HTTP_REQUESTS):
                body = {"features": eye[rng.integers(0, VOCAB, (1, LEDGER_T))].tolist()}
                status, _ = post_json(f"{base}/predict", body)
                check(status == 200, f"14c: /predict answered {status}")
            alerts = json.loads(get_body(f"{base}/alerts"))
        finally:
            server.stop()
        torch.cuda.synchronize()
        launches = counts.read()
        check(sorted(alerts) == ["firing", "ledger", "rules", "run_id", "transitions"],
              f"14c: /alerts keys {sorted(alerts)}")
        check(sorted(r["rule"] for r in alerts["rules"]) == sorted(r.name for r in pack),
              f"14c: /alerts rules {[r['rule'] for r in alerts['rules']]}")
        check(alerts["ledger"] == paths["server"], f"14c: /alerts ledger {alerts['ledger']}")
        for name, series, sent in (("pi", "serving_requests_total", LEDGER_PI_CALLS),
                                   ("decode", "decode_requests_total", LEDGER_DECODE_REQUESTS),
                                   ("server", "serving_requests_total", LEDGER_HTTP_REQUESTS)):
            grew = _ledger_delta(runledger, paths[name], series)
            # each recorded ledger replayed through the serving rule pack
            verdict = slo.evaluate_ledger(
                runledger.iter_samples(runledger.read_ledger(paths[name])), pack)
            check(grew == sent, f"14c: {name}'s ledger shows {series} +{grew}, sent {sent}")
            check(verdict["ok"], f"14c: {name}'s ledger fired error rules "
                                 f"{verdict['ever_fired_errors']}")
            out[name] = {"series": series, "grew": grew, "sent": sent,
                         "samples": verdict["samples"], "ever_fired": verdict["ever_fired"]}
        live_fired = [r["rule"] for r in alerts["rules"]
                      if r["fired_total"] and r["severity"] == slo.ERROR]
        check(not live_fired, f"14c: the server's live rules fired {live_fired}")
        check(runledger.current() is None, "14c: a ledger was left attached")
        check(launches["lstm_sequence"] > 0 and launches["lstm_step"] > 0,
              f"14c: the char-LSTM entry points launched {launches}")
    finally:
        shutil.rmtree(RECSYS_DIR, ignore_errors=True)
    print("  14c: the char-LSTM with run_ledger=: "
          + "; ".join(f"{k} {v['series']} +{v['grew']:.0f} of {v['sent']} in "
                      f"{v['samples']} samples, fired {v['ever_fired']}" for k, v in out.items())
          + f"; /alerts keys {sorted(alerts)} with {len(alerts['rules'])} rules, firing "
          f"{alerts['firing']}; launches K1 {launches['lstm_sequence']} K2 "
          f"{launches['lstm_step']} on {card}")
    return {"ledgers": out, "alerts_rules": [r["rule"] for r in alerts["rules"]],
            "launches": launches}


def mfu_phase(torch, tr, fu, card):
    """14d: MFU for the record, from utils/flops's analytic count over the
    card's dense bf16 peak: phase 8's graphed ResNet-50 bf16 batch-128 step
    and phase 5's char-LSTM step. Not a gate, except that a value above 1
    is a fault in the count."""
    from deeplearning4j_tpu_torch.models.charlstm import char_lstm_conf
    from deeplearning4j_tpu_torch.models.resnet import resnet50_conf
    from deeplearning4j_tpu_torch.utils import flops

    peak = flops.peak_flops_per_chip()
    check(peak is not None, f"14d: no peak figure for {torch.cuda.get_device_name(0)}")
    rn_flops, _ = flops.analytic_step_flops_per_example(resnet50_conf())
    # the char-LSTM conf has no fixed timestep count: price one token
    tok_flops = 3.0 * flops.forward_flops(char_lstm_conf(vocab_size=VOCAB, hidden=HIDDEN,
                                                         layers=LAYERS))
    rn_ips = fu["resnet50"]["graphed_images_per_s"]
    rn_mfu = [rn_flops * v / peak for v in rn_ips]
    lstm_tps = {"fit_tokens_per_s": tr["tokens_per_s"],
                "step_p50_tokens_per_s": TRAIN_B * TBPTT / tr["step_p50_s"]}
    lstm_mfu = {k: tok_flops * v / peak for k, v in lstm_tps.items()}
    for v in rn_mfu + list(lstm_mfu.values()):
        check(0 < v <= 1, f"14d: an MFU of {v}: the FLOP count is wrong")
    print(f"  14d: MFU against the dense bf16 peak {peak:.4g} FLOP/s (utils/flops; an f32 net "
          f"is stated against it too), on {card}:")
    print(f"    ResNet-50 bf16 batch {RESNET_BATCH}, graphed (phase 8): {rn_flops:.6g} FLOP an "
          f"image x {' / '.join(f'{v:.1f}' for v in rn_ips)} images/s = MFU "
          f"{' / '.join(f'{v:.4g}' for v in rn_mfu)}")
    print(f"    char-LSTM f32 (phase 5): {tok_flops:.6g} FLOP a token; "
          + "; ".join(f"{k} {lstm_tps[k]:.1f} = MFU {v:.4g}" for k, v in lstm_mfu.items()))
    return {"peak_flops": peak, "resnet50": {"flops_per_image": rn_flops,
                                             "images_per_s": rn_ips, "mfu": rn_mfu},
            "charlstm": {"flops_per_token": tok_flops, "tokens_per_s": lstm_tps,
                         "mfu": lstm_mfu}}


def recsys_ledger_phase(torch, counts, seed, card, tr, fu):
    """Phase 14: 14a-14d in turn. The recsys path (14a, 14b) launches none
    of K1-K8; 14c's char-LSTM serving launches K1 and K2."""
    t0 = time.perf_counter()
    counts.reset()
    p14 = {"recsys_ps": recsys_ps_phase(torch, seed, card)}
    torch.cuda.empty_cache()
    p14["recsys_fit"] = recsys_fit_phase(torch, seed, card)
    torch.cuda.synchronize()
    p14["launches"] = counts.read()
    check(not any(p14["launches"].values()),
          f"14a/14b: the recsys path launched {p14['launches']}")
    torch.cuda.empty_cache()
    p14["ledger_serving"] = ledger_serving_phase(torch, counts, seed, card)
    p14["mfu"] = mfu_phase(torch, tr, fu, card)
    p14["seconds"] = time.perf_counter() - t0
    print(f"  phase 14: {p14['seconds']:.1f} s")
    return p14


def recsys_summary(p14, card) -> dict:
    a = p14["recsys_ps"]
    arms = {arm: {k: a[arm][k] for k in ("examples_per_s", "step_ms", "pull_p50_ms",
                                         "pull_p99_ms", "hit_rate")}
            for arm in ("pipelined", "synchronous")}
    return {"card": card,
            "14a_recsys_ps": {**{k: a[k] for k in ("compute_ms", "injected_latency_ms",
                                                   "ratio", "busy_share", "byte_equal")},
                              **arms},
            "14b_recsys_fit": {k: p14["recsys_fit"][k] for k in ("examples_per_s", "mfu")},
            "14d_mfu": {"resnet50": p14["mfu"]["resnet50"]["mfu"],
                        "charlstm": p14["mfu"]["charlstm"]["mfu"]},
            "seconds": p14["seconds"]}


# -- phase 15: device observability and static analysis --------------------------

# PERF.md section 5's graphed ResNet-50 bf16 b128 step (run 1, PR 9: 36.0 ms
# synced, 34.67 ms of device), printed beside this run's phase 8 measure
PR9_GRAPHED_STEP_MS, PR9_GRAPHED_DEVICE_MS = 36.0, 34.67
OBS_IMAGE = 224
OBS_DEVPROF_STEPS, OBS_SAMPLE_EVERY = 12, 4
# 15c: the sampled step time against the synced one, relative
OBS_STEP_RTOL = 0.25
OBS_PROFILE_STEPS = 3          # 15d: ResNet-50 steps in the ProfilerListener window
OBS_LSTM_T = 2 * TBPTT         # 15d: char-LSTM batches of two TBPTT segments ...
OBS_LSTM_BATCHES = 2           # ... of which two are in the window
OBS_KERNEL_FAMILIES = ("K4 conv1x1_stats", "K5 conv_kxk_stats", "K6 bn_apply",
                       "K7 bn_backward_reduce", "K8 bn_backward_apply")
OBS_LSTM_FAMILIES = ("K1 lstm_sequence", "K3 lstm_sequence_bwd")
OBS_DIR = os.path.join(HERE, "_obs_smoke")
# 15a': the graphed ResNet-50 step routed by the planning table (the JAX
# package's economic stage: compute-bound convs declined to cuDNN) against
# the shipped structural routing, in this call: rounds of each arm, groups
# of 2 steps a dispatch (the first two groups of a net warm up and capture)
OBS_AB_ROUNDS, OBS_AB_GROUPS = 2, 6


def routing_ab(torch, F, fcb, helpers, cuda_build, seed, card):
    """15a': ResNet-50 bf16 b128 under set_fused_steps(2), one net routed by
    the shipped probe (the structural stage: every conv on K4/K5) and one
    by the planning verdict (conv_decision(planning=True): the
    compute-bound convs declined to cuDNN, their BNs on the builtin
    forward), alternated in rounds: the synced step and the device time a
    step under the profiler, and each replay's launches."""
    from deeplearning4j_tpu_torch.analysis import kernelcoverage as kc
    from deeplearning4j_tpu_torch.data import DataSet, DataSetIterator, ExistingDataSetIterator
    from deeplearning4j_tpu_torch.models.resnet import resnet50_conf, resnet50_network

    gen = torch.Generator(device="cuda").manual_seed(seed + 152)
    data = []
    for _ in range(2):
        x = torch.randn((RESNET_BATCH, OBS_IMAGE, OBS_IMAGE, 3), generator=gen, device="cuda")
        lab = torch.randint(0, 1000, (RESNET_BATCH,), generator=gen, device="cuda")
        data.append(DataSet(x, F.one_hot(lab, 1000).float()))
    h = helpers._HELPERS["conv2d"]
    shipped = h.supported

    def planned(*, device=None, **ctx):
        return (fcb.conv_decision(planning=True, **ctx)["status"] == "covered"
                and cuda_build.on_hopper(device))

    nets = {arm: resnet50_network(image_size=OBS_IMAGE, precision="bf16", seed=seed,
                                  learning_rate=RESNET_LR).set_fused_steps(2)
            for arm in ("economic", "structural")}
    res = {arm: {"step_s": [], "device_ms": []} for arm in nets}
    try:
        for _ in range(OBS_AB_ROUNDS):
            for arm, net in nets.items():
                h.supported = planned if arm == "economic" else shipped
                clock = SyncClock(torch, DataSetIterator, data, OBS_AB_GROUPS, per=2)
                net.fit(clock.it, async_prefetch=False)
                res[arm]["step_s"] += [t / 2 for t in dispatch_times(clock, 2)[2:]]
                busy, _, _ = profiled(torch, lambda: net.fit(ExistingDataSetIterator(data),
                                                             async_prefetch=False))
                res[arm]["device_ms"].append(busy * 1e3 / 2)
    finally:
        h.supported = shipped
    for arm, net in nets.items():
        [prog] = list(net._programs.values())
        res[arm]["launches_per_replay"] = prog.conv_launches
        res[arm]["step_p50_ms"] = float(np.median(res[arm]["step_s"])) * 1e3
    plan = kc.launches_per_step(kc.coverage_table(resnet50_conf(image_size=OBS_IMAGE),
                                                  RESNET_BATCH, torch.bfloat16))
    plan.update(bn_backward_reduce=53, bn_backward_apply=53)
    want = {"economic": {k: 2 * v for k, v in plan.items()},
            "structural": {k: 2 * v
                           for k, v in resnet_per_step(RESNET_BATCH, image=OBS_IMAGE).items()}}
    for arm in nets:
        check(res[arm]["launches_per_replay"] == want[arm],
              f"15a': {arm} launches per replay {res[arm]['launches_per_replay']}, "
              f"expected {want[arm]}")
    e, st = res["economic"], res["structural"]
    print(f"  15a': graphed ResNet-50 bf16 b{RESNET_BATCH}, set_fused_steps(2), in this call "
          f"({OBS_AB_ROUNDS} rounds each): the planning table's routing (launches a replay "
          f"{e['launches_per_replay']}) step p50 {e['step_p50_ms']:.2f} ms synced, device "
          f"{' '.join(f'{v:.2f}' for v in e['device_ms'])} ms a step; shipped, structural "
          f"({st['launches_per_replay']}) {st['step_p50_ms']:.2f} ms, device "
          f"{' '.join(f'{v:.2f}' for v in st['device_ms'])} ms, on {card}")
    del nets, data
    torch.cuda.empty_cache()
    return res


def observability_phase(torch, F, fcb, helpers, cuda_build, counts, fu, seed, card):
    """15: kernel coverage, the step cost model, the sampled device
    profiler with OOM forensics, and the profiler's family summary, on the
    card (analysis/kernelcoverage.py, analysis/costmodel.py,
    utils/devprof.py, utils/profiler.py)."""
    import shutil

    from deeplearning4j_tpu_torch.analysis import costmodel
    from deeplearning4j_tpu_torch.analysis import kernelcoverage as kc
    from deeplearning4j_tpu_torch.data import DataSet, ExistingDataSetIterator
    from deeplearning4j_tpu_torch.models.charlstm import char_lstm_network
    from deeplearning4j_tpu_torch.models.resnet import resnet50_conf, resnet50_network
    from deeplearning4j_tpu_torch.parallel import ParallelInference
    from deeplearning4j_tpu_torch.train.listeners import IterationListener
    from deeplearning4j_tpu_torch.utils import blackbox, devprof
    from deeplearning4j_tpu_torch.utils import faultpoints as fp
    from deeplearning4j_tpu_torch.utils import flops
    from deeplearning4j_tpu_torch.utils import profiler as prof_mod
    from deeplearning4j_tpu_torch.utils.metrics import get_registry

    t_phase = time.perf_counter()
    out = {}
    counts.reset()

    out["routing_ab"] = routing_ab(torch, F, fcb, helpers, cuda_build, seed, card)
    counts.reset()  # the A/B's two arms are not the shipped path

    # 15a: the coverage table, planned (the JAX package's economic stage on
    # the H100 SXM figures) and as this process routes (structural)
    conf = resnet50_conf(image_size=OBS_IMAGE)
    rows = kc.coverage_table(conf, RESNET_BATCH, torch.bfloat16)
    s = kc.coverage_summary(rows)
    routed = kc.coverage_summary(kc.coverage_table(conf, RESNET_BATCH, torch.bfloat16,
                                                   planning=False))
    per = resnet_per_step(RESNET_BATCH, image=OBS_IMAGE)
    for summary in (s, routed):
        check(summary["total"] == 53 and summary["unsupported"] == 0
              and summary["covered"] + summary["declined"] == 53,
              f"15a: coverage {summary}: every conv covered or declined with a verdict")
    declined = sorted({f"{'x'.join(map(str, r['kernel']))}/s{r['stride'][0]} at "
                       f"{r['x_shape'][1]}^2 ({r['x_shape'][3]}->{r['n_out']})"
                       for r in rows if r["status"] == "declined"})
    g = fu["resnet50"]
    out["coverage"] = {**s, "routed": routed, "per_step": per, "declined": declined,
                       "graphed_step_ms": g["graphed_step_s"]["p50"] * 1e3,
                       "graphed_device_ms": g["graphed_profiled"]["device_ms_per_step"]}
    print(f"  15a: ResNet-50 at batch {RESNET_BATCH} in bf16: {s['total']} conv instances; "
          f"planned (the economic stage on the H100 SXM figures) {s['covered']} covered, "
          f"{s['declined']} declined (compute-bound), {s['unsupported']} unsupported (the "
          f"JAX instance functions: 34 / 19); routed on {card} (structural) "
          f"{routed['covered']} covered, {routed['declined']} declined; a step launches {per}")
    print(f"  15a: planned declines: {'; '.join(declined)}")
    print(f"  15a: the graphed ResNet-50 step of phase 8 in this run: "
          f"{out['coverage']['graphed_step_ms']:.2f} ms synced, "
          f"{out['coverage']['graphed_device_ms']:.2f} ms of device, on {card}; PERF.md "
          f"section 5 (another run, PR 9): "
          f"{PR9_GRAPHED_STEP_MS} ms / {PR9_GRAPHED_DEVICE_MS} ms")

    # 15b: the step cost model of ResNet-50 b128 bf16 and the char-LSTM
    def batches(n, b):
        gen = torch.Generator(device="cuda").manual_seed(seed + 150)
        res = []
        for _ in range(n):
            x = torch.randn((b, OBS_IMAGE, OBS_IMAGE, 3), generator=gen, device="cuda")
            lab = torch.randint(0, 1000, (b,), generator=gen, device="cuda")
            res.append(DataSet(x, F.one_hot(lab, 1000).float()))
        return res

    def cost(name, net, batch, timesteps, one_step):
        t0 = time.perf_counter()
        m, counted, findings = costmodel.check_network(net, batch_size=batch,
                                                       timesteps=timesteps)
        trace_s = time.perf_counter() - t0
        analytic, _ = flops.train_step_flops_for(net, batch, timesteps=timesteps,
                                                 prefer_cost_model=False)
        roof = m.roofline()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        one_step()
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
        rec = {"model_flops": m.model_flops, "analytic_flops": analytic,
               "counter_flops": counted, "counter_comparable_flops": m.counter_comparable_flops,
               "flops_total": m.flops_total, "bytes_total": m.bytes_total,
               "step_lower_bound_ms": roof["step_time_lower_bound_seconds"] * 1e3,
               "bound": roof["bound"], "mfu_ceiling": roof["mfu_ceiling"],
               "activation_peak_bytes": m.activation_peak_bytes,
               "resident_bytes": m.resident_bytes, "param_bytes": m.param_bytes,
               "updater_bytes": m.updater_bytes,
               "max_memory_allocated": peak, "allocated_before_step": base,
               "findings": [f.name for f in findings], "trace_s": trace_s}
        check(not findings, f"15b: {name}: findings {[f.format() for f in findings]} "
                            "(JX007 against FlopCounterMode, JX008 at the card's memory)")
        check(counted and abs(m.counter_comparable_flops - counted) <= 0.10 * counted,
              f"15b: {name}: model {m.counter_comparable_flops} vs FlopCounterMode {counted}")
        print(f"  15b: {name}: model FLOPs {m.model_flops:.6g} (valid taps), analytic "
              f"{analytic:.6g} (ratio {m.model_flops / analytic:.4f}); JX007: "
              f"{m.counter_comparable_flops:.6g} vs FlopCounterMode {counted:.6g}; roofline on "
              f"the card's figures: lower bound {rec['step_lower_bound_ms']:.3f} ms "
              f"({roof['bound']}-bound), MFU ceiling {roof['mfu_ceiling']:.4f}; static: activation "
              f"peak {m.activation_peak_bytes / 2**30:.3f} GiB, resident (params, updater, the "
              f"batch and the peak) {m.resident_bytes / 2**30:.3f} GiB; one eager step: "
              f"max_memory_allocated {peak / 2**30:.3f} GiB, {(peak - base) / 2**30:.3f} GiB "
              f"above the {base / 2**30:.3f} GiB allocated before it (this phase's other nets "
              f"and batches); traced in {trace_s:.2f} s on fake tensors")
        return m, rec

    net = resnet50_network(image_size=OBS_IMAGE, precision="bf16", seed=seed,
                           learning_rate=RESNET_LR)
    data = batches(4, RESNET_BATCH)
    rn_cm, out["resnet50_cost"] = cost(
        f"ResNet-50 bf16 b{RESNET_BATCH}", net, RESNET_BATCH, 16,
        lambda: net.fit(ExistingDataSetIterator(data[:1]), async_prefetch=False))
    lstm = char_lstm_network(vocab_size=VOCAB, hidden=HIDDEN, layers=LAYERS, seed=seed)
    ldata = [DataSet(np.ascontiguousarray(w.features[:, :OBS_LSTM_T]),
                     np.ascontiguousarray(w.labels[:, :OBS_LSTM_T]))
             for w in corpus_batches(DataSet, seed + 151, OBS_LSTM_BATCHES + 1)]
    lstm_cm, out["charlstm_cost"] = cost(
        f"char-LSTM full width, batch {TRAIN_B}, one TBPTT segment of {TBPTT}", lstm,
        TRAIN_B, TBPTT,
        lambda: lstm.fit(ExistingDataSetIterator(ldata[:1]), async_prefetch=False))

    # 15c: the sampled device profiler over a ResNet-50 fit, the cost model
    # attached. The same steps are timed on the device clock: a CUDA event
    # recorded after each step's launches (no sync), read after the fit
    reg = get_registry()
    net.attach_cost_model(rn_cm, batch=RESNET_BATCH)
    epochs = OBS_DEVPROF_STEPS // len(data)

    class Events(IterationListener):
        def __init__(self):
            self.events = []

        def iteration_done(self, model, iteration, info):
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self.events.append(ev)

    evs = Events()
    net.set_listeners(evs)
    prev = devprof.get_profiler().sample_every
    devprof.configure(OBS_SAMPLE_EVERY)
    try:
        s0 = reg.scalar_values().get("devprof_samples_total", 0.0)
        net.fit(ExistingDataSetIterator(data), epochs=epochs, async_prefetch=False)
        sv = reg.scalar_values()
    finally:
        devprof.configure(prev)
        net.set_listeners()
    torch.cuda.synchronize()
    step_dev = sv.get("step_device_seconds", 0.0)
    # the last sample window: the steps after the second-last sample
    w = OBS_SAMPLE_EVERY
    synced = evs.events[-1 - w].elapsed_time(evs.events[-1]) / 1e3 / w
    mems = {k: sv.get(f'device_memory_bytes{{kind="{k}"}}', 0.0)
            for k in ("params", "updater", "activations_est", "live")}
    mfu = sv.get('step_mfu{source="costmodel"}')
    rel = abs(step_dev - synced) / synced
    out["devprof"] = {"step_device_seconds": step_dev, "synced_step_seconds": synced,
                      "rel": rel, "samples": sv.get("devprof_samples_total", 0.0) - s0,
                      "step_mfu_costmodel": mfu,
                      "flops_per_second": sv.get('step_flops_per_second{source="costmodel"}'),
                      "device_memory_bytes": mems}
    print(f"  15c: ResNet-50 bf16 b{RESNET_BATCH}, {OBS_DEVPROF_STEPS} steps, sample_every "
          f"{OBS_SAMPLE_EVERY}: step_device_seconds {step_dev * 1e3:.2f} ms (the last resolved "
          f"window, on the dispatch timeline's events) vs {synced * 1e3:.2f} ms a step between the CUDA events "
          f"recorded after the same steps, rel {rel:.3f}; step_mfu{{costmodel}} {mfu}; "
          f"device_memory_bytes {mems}; on {card}")
    check(out["devprof"]["samples"] >= OBS_DEVPROF_STEPS // OBS_SAMPLE_EVERY - 1,
          f"15c: {out['devprof']['samples']} samples")
    check(rel <= OBS_STEP_RTOL, f"15c: sampled {step_dev} s vs synced {synced} s a step")
    check(mfu is not None and 0 < mfu <= 1, f"15c: step_mfu{{costmodel}} {mfu}")
    check(all(v > 0 for v in mems.values()), f"15c: device_memory_bytes {mems}")

    # injected OOM: mid-fit, and in a ParallelInference forward
    oom = {}
    for where in ("fit", "serving_forward"):
        n0 = reg.scalar_values().get(f'oom_total{{where="{where}"}}', 0.0)
        plan = fp.FaultPlan(seed=seed)
        if where == "fit":
            plan.add("train_step", "oom", every_nth=2, max_fires=1)
            with fp.active(plan):
                try:
                    net.fit(ExistingDataSetIterator(data), async_prefetch=False)
                    raised = None
                except fp.InjectedOOM as e:
                    raised = e
        else:
            pi = ParallelInference(lstm, max_batch_size=4, batch_timeout_ms=1.0,
                                   component_prefix="obs15")
            try:
                pi.warmup((OBS_LSTM_T, VOCAB))
                plan.add("replica_forward", "oom", every_nth=1, max_fires=1)
                with fp.active(plan):
                    try:
                        pi.output(np.zeros((2, OBS_LSTM_T, VOCAB), np.float32))
                        raised = None
                    except Exception as e:  # the group's failure, as a client sees it
                        raised = e
            finally:
                pi.shutdown()
        path = blackbox.get_recorder().last_dump_path
        with open(path) as f:
            doc = json.load(f)
        ev = [e for e in doc["events"] if e.get("kind") == "oom"][-1]
        cuda_top = [b for b in ev["top_buffers"] if b["device"].startswith("cuda")]
        n1 = reg.scalar_values().get(f'oom_total{{where="{where}"}}', 0.0)
        oom[where] = {"raised": type(raised).__name__, "dump": os.path.basename(path),
                      "where": ev["where"], "top_buffers": ev["top_buffers"][:3],
                      "static": {k: v for k, v in ev["static"].items()
                                 if k != "largest_activation"},
                      "oom_total_delta": n1 - n0}
        check(raised is not None and devprof.is_oom(raised),
              f"15c: the {where} oom fault raised {raised!r}")
        check(ev["where"] == where and len(cuda_top) == len(ev["top_buffers"]) > 0,
              f"15c: the {where} dump names {ev['top_buffers'][:3]}")
        check(n1 - n0 == 1, f"15c: oom_total{{where={where}}} +{n1 - n0}")
        print(f"  15c: injected oom in {where}: forensics dump {os.path.basename(path)} names "
              f"{len(ev['top_buffers'])} live CUDA tensors, the largest "
              f"{ev['top_buffers'][0]['nbytes'] / 2**20:.1f} MiB "
              f"{ev['top_buffers'][0]['dtype']}{list(ev['top_buffers'][0]['shape'])}, live "
              f"{ev['static'].get('live_bytes', 0) / 2**30:.3f} GiB, static activation "
              f"estimate {(ev['static'].get('activation_peak_bytes') or 0) / 2**30:.3f} GiB; "
              f"oom_total{{where=\"{where}\"}} +{n1 - n0:.0f}")
    out["oom"] = oom

    # 15d: ProfilerListener over ResNet-50 steps and char-LSTM TBPTT batches
    shutil.rmtree(OBS_DIR, ignore_errors=True)
    prof_out = {}
    try:
        # the window opens after the fit's first ResNet-50 step, and after
        # the first char-LSTM batch (two TBPTT segments, two iterations)
        for name, model, fit_data, m, offset, steps, fams in (
                ("resnet50", net, data[:OBS_PROFILE_STEPS + 1], rn_cm, 0, OBS_PROFILE_STEPS,
                 OBS_KERNEL_FAMILIES),
                ("charlstm", lstm, ldata, lstm_cm, 1, 2 * OBS_LSTM_BATCHES,
                 OBS_LSTM_FAMILIES)):
            d = os.path.join(OBS_DIR, name)
            lst = prof_mod.ProfilerListener(d, start_iteration=model.iteration + offset,
                                            n_iterations=steps, print_fn=lambda _: None)
            model.set_listeners(lst)
            model.fit(ExistingDataSetIterator(fit_data), async_prefetch=False)
            model.set_listeners()
            payload = prof_mod.write_profile_json(d, os.path.join(d, "profile.json"),
                                                  meta={"card": card, "steps": steps},
                                                  cost_model=m.to_dict(), steps=steps)
            cols = payload["families"]
            missing = [f for f in fams if f not in cols or "bound_ms" not in cols[f]]
            check(payload["device"] and not missing,
                  f"15d: {name}'s family summary lacks {missing}: {sorted(cols)}")
            prof_out[name] = {"steps": steps, "device_ms": payload["total_device_sec"] * 1e3,
                              "families": {f: {k: c[k] for k in ("ms", "bound_ms",
                                                                 "cost_model_family")
                                               if k in c}
                                           for f, c in cols.items()}}
            print(f"  15d: {name}, {steps} steps under ProfilerListener: "
                  f"{payload['total_device_sec'] * 1e3:.2f} ms of device; by family (ms, "
                  f"cost-model bound ms): "
                  + "; ".join(f"{f} {c['ms']:.3f}"
                              + (f" / {c['bound_ms']:.3f}" if "bound_ms" in c else "")
                              for f, c in sorted(cols.items(), key=lambda kv: -kv[1]["ms"])))
    finally:
        shutil.rmtree(OBS_DIR, ignore_errors=True)
    out["profile"] = prof_out
    torch.cuda.synchronize()
    out["launches"] = counts.read()
    for k in ("conv1x1_stats", "conv_kxk_stats", "bn_apply", "bn_backward_reduce",
              "bn_backward_apply", "lstm_sequence", "lstm_sequence_backward"):
        check(out["launches"].get(k, 0) > 0, f"15: {k} launched {out['launches']}")
    out["seconds"] = time.perf_counter() - t_phase
    print(f"  15: launches {out['launches']}; {out['seconds']:.1f} s")
    del net, lstm, data
    torch.cuda.empty_cache()
    return out


def observability_summary(p15, card) -> dict:
    c = p15["coverage"]
    return {"card": card,
            "15a_coverage": {k: c[k] for k in ("total", "covered", "declined", "unsupported",
                                               "routed", "per_step", "graphed_step_ms",
                                               "graphed_device_ms")},
            "15a_routing_ab": {arm: {k: r[k] for k in ("step_p50_ms", "device_ms")}
                               for arm, r in p15["routing_ab"].items()},
            "15b_cost": {n: {k: p15[n][k] for k in ("model_flops", "analytic_flops",
                                                    "counter_flops", "step_lower_bound_ms",
                                                    "mfu_ceiling", "activation_peak_bytes",
                                                    "resident_bytes", "max_memory_allocated")}
                         for n in ("resnet50_cost", "charlstm_cost")},
            "15c_devprof": {k: p15["devprof"][k] for k in ("step_device_seconds",
                                                           "synced_step_seconds", "rel",
                                                           "step_mfu_costmodel")},
            "15d_device_ms": {n: p["device_ms"] for n, p in p15["profile"].items()},
            "seconds": p15["seconds"]}

# -- 16: the training UI and the clustering stack ----------------------------

UI_DIR = os.path.join(HERE, "_ui_smoke")
UI_STEPS = 8               # 16a: ResNet-50 steps under StatsListener (2 batches x 4 epochs)
UI_HIST_BINS, UI_HIST_EVERY = 20, 4
UI_D2H_MAX = 5             # 16a: device-to-host copies of one report step without histograms
UI_DATA_ROUTES = ("/train/overview/data", "/train/histogram/data", "/train/activations/data",
                  "/train/model/data", "/train/model/graph", "/train/flow/data",
                  "/train/system/data", "/train/alerts/data", "/train/tsne/data",
                  "/train/sessions/current", "/train/sessions/all")
CONV_UI_BATCH, CONV_UI_STEPS = 32, 3   # 16b: VGG16 bf16
CONV_UI_ATOL = 1e-2        # 16b: the card's bf16 grid against the CPU's f32 one, in [0, 1]
KERAS_UI_N, KERAS_UI_BATCH = 32, 16    # 16c: /fit examples and batch size
WORDS_N, WORDS_DIM, WORDS_K = 100_000, 300, 100   # 16d: word2vec's width, 100 clusters
WORDS_SIGMA = 0.5          # each cluster's spread about its N(0, 1) centre
KM_ITERS = 50
KM_CENTRE_TOL = 1e-4       # first Lloyd step, card vs CPU, of the centres' largest entry
KM_TIE = 1e-5              # a row's best two distances "within rounding": relative gap
TSNE_N, TSNE_PERPLEXITY, TSNE_ITERS = 10_000, 30.0, 1000
TSNE_HOLD_N, TSNE_HOLD_ITERS = 2_000, 1000  # card against CPU, the same y0
TSNE_P_ATOL = 1e-5         # conditional P after the search, card vs CPU
TSNE_KL_RTOL = 0.05
TSNE_UI_N = 2_000          # /tsne/compute's vectors
KNN_CLIENTS, KNN_K = 16, 10
KNN_POOL = 64              # distinct /knn indices and /knnvector vectors in each arm
# of each route, per arm; the host tree visits most points in 300
# dimensions (0.4 s a query under 16 clients on the H100), so
# its arm is cut to 32 of each
KNN_REQUESTS = {"cosinesimilarity": 512, "euclidean": 32}
KNN_TIE = 1e-6


def one_step_d2h(torch, net, ds, ExistingDataSetIterator, listeners):
    """One fit step with `listeners` under the profiler: its device-to-host
    copies, and its kernel launches by the port's kernel families."""
    from torch.profiler import ProfilerActivity, profile

    from deeplearning4j_tpu_torch.utils.profiler import op_family

    net.set_listeners(*listeners)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        net.fit(ExistingDataSetIterator([ds]), async_prefetch=False)
        torch.cuda.synchronize()
    net.set_listeners()
    events = prof.key_averages()
    fams = collections.Counter()
    for e in events:
        if op_family(e.key).startswith("K"):
            fams[op_family(e.key)] += e.count
    return int(sum(e.count for e in events if "Memcpy DtoH" in e.key)), dict(fams)


def stats_listener_phase(torch, F, counts, storage, port, seed, card):
    """16a: ResNet-50 bf16 b128 with StatsListener through the remote
    router into the UIServer on `port`, over the FileStatsStorage
    `storage`."""
    from deeplearning4j_tpu_torch.data import DataSet, ExistingDataSetIterator
    from deeplearning4j_tpu_torch.models.resnet import resnet50_network
    from deeplearning4j_tpu_torch.train.listeners import IterationListener
    from deeplearning4j_tpu_torch.ui import (FileStatsStorage, InMemoryStatsStorage,
                                             RemoteUIStatsStorageRouter, StatsListener)

    class Steps(IterationListener):
        """The fit's own scores, each step's K4-K8 launches, synced step times."""

        def __init__(self):
            self.scores, self.launches, self.times = [], [], [time.perf_counter()]
            self.last = counts.read()

        def iteration_done(self, model, iteration, info):
            torch.cuda.synchronize()
            self.times.append(time.perf_counter())
            self.scores.append(float(info["score"]()))
            now = counts.read()
            self.launches.append({k: now.get(k, 0) - self.last.get(k, 0) for k in now})
            self.last = now

    out = {}
    net = resnet50_network(precision="bf16", seed=seed, learning_rate=RESNET_LR)
    net.set_collect_stats(True)
    n_leaves = sum(len(p) for p in net.params_list)
    data = resnet_batches(torch, F, DataSet, seed + 161, 2, RESNET_BATCH)
    per = resnet_per_step(RESNET_BATCH)
    path = storage.path
    router = RemoteUIStatsStorageRouter(f"http://127.0.0.1:{port}")
    sid = "resnet50-ui"
    try:
        lst = StatsListener(router, session_id=sid, frequency=1, histogram_bins=UI_HIST_BINS,
                            histogram_frequency=UI_HIST_EVERY)
        with_l = Steps()
        net.set_listeners(lst, with_l)
        net.fit(ExistingDataSetIterator(data), epochs=UI_STEPS // len(data),
                async_prefetch=False)
        router.flush(timeout=60.0)
        without = Steps()
        net.set_listeners(without)
        net.fit(ExistingDataSetIterator(data), epochs=UI_STEPS // len(data),
                async_prefetch=False)
        net.set_listeners()
        ups = storage.get_updates(sid)
        static = storage.get_static_info(sid) or {}
        check(len(ups) == UI_STEPS == len(with_l.scores),
              f"16a: {len(ups)} records for {len(with_l.scores)} steps")
        keys = {f"{li}_{n}" for li, p in enumerate(net.params_list) for n in p}
        for u, score, ln in zip(ups, with_l.scores, with_l.launches):
            check(u["score"] == score, f"16a: record score {u['score']} != the fit's {score}")
            for g in ("grad_mm", "update_mm", "param_mm"):
                check(set(u[g]) == keys, f"16a: {g} covers {len(u[g])} of {len(keys)} leaves")
            check(u.get("memory", {}).get("device0", {}).get("bytes_in_use", 0) > 0,
                  f"16a: memory {u.get('memory')}")
            for k in ("conv1x1_stats", "conv_kxk_stats", "bn_apply", "bn_backward_reduce",
                      "bn_backward_apply"):
                check(ln.get(k, 0) == per[k] > 0,
                      f"16a: a step launched {k} {ln.get(k, 0)} times, expected {per[k]}")
        sizes = {f"{li}_{n}": v.numel() for li, p in enumerate(net.params_list)
                 for n, v in p.items()}
        hist_its = [u["iteration"] for u in ups if "hists" in u]
        check(len(hist_its) == UI_STEPS // UI_HIST_EVERY, f"16a: histograms at {hist_its}")
        for u in ups:
            for k, h in u.get("hists", {}).items():
                check(sum(h["counts"]) == sizes[k] and len(h["edges"]) == UI_HIST_BINS + 1,
                      f"16a: {k}'s histogram counts {sum(h['counts'])} of {sizes[k]}")
        check(static.get("device") == torch.cuda.get_device_name(0)
              and static.get("backend") == "cuda", f"16a: static {static.get('device')}")
        codes = {}
        for route in UI_DATA_ROUTES:
            import urllib.request

            with urllib.request.urlopen(f"http://127.0.0.1:{port}{route}", timeout=60) as r:
                json.loads(r.read())
                codes[route] = r.status
        check(all(c == 200 for c in codes.values()), f"16a: routes {codes}")
        cold = FileStatsStorage(path)
        check(cold.get_updates(sid) == ups and cold.get_static_info(sid) == static,
              "16a: the stats file read cold differs from the server's records")
        step_with = np.diff(with_l.times)[1:]
        step_without = np.diff(without.times)[1:]
        out.update(
            steps=UI_STEPS, leaves=n_leaves, records=len(ups), histogram_iterations=hist_its,
            per_step_launches={k: with_l.launches[-1].get(k, 0) for k in per},
            step_p50_ms_with_listener=float(np.median(step_with)) * 1e3,
            step_p50_ms_without=float(np.median(step_without)) * 1e3,
            step_ms_with_listener=[float(s) * 1e3 for s in np.diff(with_l.times)],
            step_ms_without=[float(s) * 1e3 for s in np.diff(without.times)],
            file_bytes=os.path.getsize(path), routes=codes)
        # the copies one report step makes, against a step with no listener
        mem = InMemoryStatsStorage()
        out["d2h_no_listener"], _ = one_step_d2h(torch, net, data[0],
                                                 ExistingDataSetIterator, [])
        out["d2h_report"], fams = one_step_d2h(
            torch, net, data[0], ExistingDataSetIterator,
            [StatsListener(mem, session_id="p", histogram_bins=0, report_memory=True)])
        out["d2h_report_histograms"], _ = one_step_d2h(
            torch, net, data[0], ExistingDataSetIterator,
            [StatsListener(mem, session_id="q", histogram_bins=UI_HIST_BINS)])
        out["profiled_report_step_kernels"] = fams
        check(all(fams.get(f, 0) > 0 for f in OBS_KERNEL_FAMILIES),
              f"16a: the profiled report step ran kernels {fams}")
        check(out["d2h_report"] <= UI_D2H_MAX,
              f"16a: a report step made {out['d2h_report']} device-to-host copies "
              f"(at most {UI_D2H_MAX}, where a read per leaf would make {3 * n_leaves})")
        print(f"  16a: ResNet-50 bf16 b{RESNET_BATCH}, {UI_STEPS} steps, StatsListener(frequency=1,"
              f" histograms of {UI_HIST_BINS} bins every {UI_HIST_EVERY}th report) -> remote "
              f"router -> UIServer over a FileStatsStorage ({out['file_bytes']} bytes): every "
              f"record's score is the fit's, mm groups cover all {n_leaves} leaves, histogram "
              f"counts sum to each leaf's size, device0 in use "
              f"{ups[-1].get('memory', {}).get('device0', {}).get('bytes_in_use', 0) / 2**30:.2f}"
              f" GiB, static device "
              f"{static['device']!r}; K4-K8 a step {out['per_step_launches']}; {len(codes)} data "
              f"routes 200; the cold file equals the server's records")
        print(f"  16a: step p50 synced, collect_stats on: {out['step_p50_ms_with_listener']:.2f} ms"
              f" with the listener (histogram steps included), {out['step_p50_ms_without']:.2f} "
              f"ms without; device-to-host copies in one step: {out['d2h_no_listener']} without a "
              f"listener, {out['d2h_report']} with a report, {out['d2h_report_histograms']} with "
              f"a report and histograms; the profiled report step's kernels {fams}, on {card}")
    finally:
        router.close()
    del net, data
    torch.cuda.empty_cache()
    return out


def conv_listener_phase(torch, F, seed, card):
    """16b: ConvolutionalIterationListener on VGG16 bf16, the grid held
    to the same grid computed on the CPU in f32 from the same parameters
    and batch."""
    from deeplearning4j_tpu_torch.data import DataSet, ExistingDataSetIterator
    from deeplearning4j_tpu_torch.models.vgg16 import vgg16_network
    from deeplearning4j_tpu_torch.ui import (ConvolutionalIterationListener,
                                             InMemoryStatsStorage, UIServer)

    net = vgg16_network(image_size=PHASE9_IMAGE, seed=seed)
    data = vgg_batches(torch, F, DataSet, seed + 162, CONV_UI_STEPS, CONV_UI_BATCH, 1000)
    storage = InMemoryStatsStorage()
    lst = ConvolutionalIterationListener(storage, "vgg16-acts", frequency=1)
    net.set_listeners(lst)
    t0 = time.perf_counter()
    net.fit(ExistingDataSetIterator(data), async_prefetch=False)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    net.set_listeners()
    server = UIServer(storage, port=0)
    port = server.start()
    try:
        import urllib.request

        with urllib.request.urlopen(f"http://127.0.0.1:{port}/train/activations/data",
                                    timeout=60) as r:
            d = json.loads(r.read())
    finally:
        server.stop()
    grid = np.asarray(d["activations"]["channels"], np.float64)
    check(d["iteration"] == CONV_UI_STEPS - 1 and grid.ndim == 3 and grid.shape[0] <= 12
          and max(grid.shape[1:]) <= 24 and grid.min() >= 0.0 and grid.max() <= 1.0,
          f"16b: activation grid {grid.shape} in [{grid.min()}, {grid.max()}]")
    # the same grid on the CPU: the first conv layer's parameters after the
    # last step, the last batch, in f32
    cpu = vgg16_network(image_size=PHASE9_IMAGE, precision="f32", seed=seed, device="cpu")
    ci = d["activations"]["layer"]
    cpu.params_list[ci] = {k: v.detach().float().cpu() for k, v in net.params_list[ci].items()}
    ref = InMemoryStatsStorage()
    ds = data[-1]
    ConvolutionalIterationListener(ref, "cpu", frequency=1).iteration_done(
        cpu, CONV_UI_STEPS - 1, {"batch": lambda: DataSet(ds.features[:1].float().cpu(),
                                                          ds.labels[:1].cpu())})
    want = np.asarray(ref.get_updates("cpu")[0]["activations"]["channels"], np.float64)
    err = float(np.abs(grid - want).max())
    check(grid.shape == want.shape and err <= CONV_UI_ATOL,
          f"16b: the card's grid is {err:.2e} from the CPU's (at most {CONV_UI_ATOL})")
    print(f"  16b: VGG16 bf16 b{CONV_UI_BATCH}, {CONV_UI_STEPS} steps ({wall:.2f} s) with "
          f"ConvolutionalIterationListener(frequency=1): /train/activations/data holds "
          f"{grid.shape[0]} channels of {grid.shape[1]}x{grid.shape[2]} from layer {ci} in "
          f"[0, 1], {err:.2e} from the CPU's f32 grid (at most {CONV_UI_ATOL}) on {card}")
    del net, cpu, data
    torch.cuda.empty_cache()
    return {"channels": grid.shape[0], "hw": list(grid.shape[1:]), "max_abs_vs_cpu": err,
            "fit_seconds": wall}


def keras_backend_phase(torch, seed, card):
    """16c: KerasBackendServer /fit and /evaluate with the published VGG16
    widths."""
    from deeplearning4j_tpu_torch.keras_backend import KerasBackendServer
    from deeplearning4j_tpu_torch.models.vgg16 import vgg16_keras_config

    rng = np.random.default_rng(seed + 163)
    x = rng.standard_normal((KERAS_UI_N, PHASE9_IMAGE, PHASE9_IMAGE, 3), np.float32)
    y = np.eye(1000, dtype=np.float32)[rng.integers(0, 1000, KERAS_UI_N)]
    xp, yp = os.path.join(UI_DIR, "x.npy"), os.path.join(UI_DIR, "y.npy")
    np.save(xp, x)
    np.save(yp, y)
    server = KerasBackendServer(port=0)
    port = server.start()
    try:
        t0 = time.perf_counter()
        code, body = post_json(f"http://127.0.0.1:{port}/fit", {
            "model_config": vgg16_keras_config(1000, PHASE9_IMAGE), "features_path": xp,
            "labels_path": yp, "batch_size": KERAS_UI_BATCH, "nb_epoch": 1})
        fit_s = time.perf_counter() - t0
        fit = json.loads(body)
        code_e, body_e = post_json(f"http://127.0.0.1:{port}/evaluate",
                                   {"features_path": xp, "labels_path": yp})
        ev = json.loads(body_e)
        devices = {t.device.type for p in server._net.params_list for t in p.values()}
        n_params = sum(t.numel() for p in server._net.params_list for t in p.values())
        iters = server._net.iteration
    finally:
        server.stop()
        server._net = None
    check(code == 200 and math.isfinite(fit["score"]), f"16c: /fit {code} {fit}")
    check(devices == {"cuda"} and iters == KERAS_UI_N // KERAS_UI_BATCH,
          f"16c: the fitted net's parameters on {devices}, {iters} steps")
    check(code_e == 200 and set(ev) == {"accuracy", "f1"}, f"16c: /evaluate {code_e} {ev}")
    print(f"  16c: KerasBackendServer POST /fit with vgg16_keras_config(1000, {PHASE9_IMAGE}) "
          f"({n_params / 1e6:.1f}M parameters, f32), {KERAS_UI_N} examples at batch "
          f"{KERAS_UI_BATCH}, one epoch: {fit_s:.2f} s, score {fit['score']:.4f}; /evaluate "
          f"{ev} on {card}")
    torch.cuda.empty_cache()
    return {"fit_seconds": fit_s, "score": fit["score"], "evaluate": ev, "params": n_params}


def word_vectors(torch, seed):
    """WORDS_N x WORDS_DIM f32 from a mixture of WORDS_K Gaussian clusters,
    made on the card; the host copy is what the numpy entry points take."""
    g = torch.Generator(device="cuda").manual_seed(seed + 164)
    centres = torch.randn((WORDS_K, WORDS_DIM), generator=g, device="cuda")
    lab = torch.randint(0, WORDS_K, (WORDS_N,), generator=g, device="cuda")
    x = centres[lab] + WORDS_SIGMA * torch.randn((WORDS_N, WORDS_DIM), generator=g,
                                                 device="cuda")
    return x, x.cpu().numpy()


def kmeans_phase(torch, x, points, seed, card):
    from deeplearning4j_tpu_torch.clustering import KMeansClustering
    from deeplearning4j_tpu_torch.clustering.distances import is_similarity, pairwise
    from deeplearning4j_tpu_torch.clustering.kmeans import _lloyd_step

    out = {}
    cpu_pts = torch.from_numpy(points)
    for dist in ("euclidean", "cosinesimilarity"):
        km = KMeansClustering(WORDS_K, KM_ITERS, dist, seed=seed)
        c0 = km._init_centers(x)
        cc, ac, _ = _lloyd_step(x, c0, dist)
        cr, ar, _ = _lloyd_step(cpu_pts, c0.cpu(), dist)
        d = pairwise(cpu_pts, c0.cpu(), dist)
        top2 = torch.topk(d, 2, dim=1, largest=is_similarity(dist)).values
        tied = (top2[:, 0] - top2[:, 1]).abs() <= KM_TIE * top2[:, 0].abs().clamp_min(1.0)
        diff = ac.cpu() != ar
        cerr = float((cc.cpu() - cr).abs().max() / cr.abs().max())
        check(bool((~diff | tied).all()) and cerr <= KM_CENTRE_TOL,
              f"16d: {dist} first Lloyd step: {int(diff.sum())} assignments differ "
              f"({int((diff & ~tied).sum())} not tied), centres {cerr:.2e} of the largest")
        # ms a Lloyd step, by CUDA events over back-to-back steps
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        c = c0
        torch.cuda.synchronize()
        start.record()
        for _ in range(20):
            c, _, _ = _lloyd_step(x, c, dist)
        end.record()
        torch.cuda.synchronize()
        step_ms = start.elapsed_time(end) / 20
        runs = []
        for _ in range(2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            runs.append(KMeansClustering(WORDS_K, KM_ITERS, dist, seed=seed).apply_to(points))
            runs[-1].wall = time.perf_counter() - t0
        a, b = runs
        check(np.array_equal(a.centers, b.centers) and np.array_equal(a.assignments, b.assignments)
              and a.iterations == b.iterations,
              f"16d: two {dist} k-means runs on the card differ")
        out[dist] = {"lloyd_step_ms": step_ms, "iterations": a.iterations,
                     "apply_seconds": [a.wall, b.wall], "first_step_differs": int(diff.sum()),
                     "first_step_tied_rows": int(tied.sum()), "centre_rel_err": cerr}
        print(f"  16d k-means {dist}, k={WORDS_K} on [{WORDS_N}, {WORDS_DIM}]: first Lloyd step "
              f"card vs CPU from the same centres: {int(diff.sum())} assignments differ "
              f"({int(tied.sum())} rows tied within {KM_TIE}), centres {cerr:.2e} of the "
              f"largest; {step_ms:.3f} ms a Lloyd step; {a.iterations} iterations, "
              f"apply_to {a.wall:.2f} / {b.wall:.2f} s, two runs bit-equal, on {card}")
    return out


def tsne_phase(torch, x, seed, card):
    from deeplearning4j_tpu_torch.clustering import Tsne
    from deeplearning4j_tpu_torch.clustering import tsne as tsne_mod

    out = {}
    # P of a TSNE_HOLD_N subset after the perplexity search, card vs CPU
    sub = x[:TSNE_HOLD_N]
    target = float(np.log2(TSNE_PERPLEXITY))
    pc = tsne_mod._binary_search_beta(tsne_mod._pairwise_sq(sub),
                                     torch.full((TSNE_HOLD_N,), target, device="cuda"))
    sub_cpu = sub.cpu()
    pr = tsne_mod._binary_search_beta(tsne_mod._pairwise_sq(sub_cpu),
                                     torch.full((TSNE_HOLD_N,), target))
    perr = float((pc.cpu() - pr).abs().max())
    check(perr <= TSNE_P_ATOL, f"16d: t-SNE P card vs CPU {perr:.2e} (at most {TSNE_P_ATOL})")
    # card and CPU from the same y0 at TSNE_HOLD_N
    gen = torch.Generator().manual_seed(seed)
    y0 = 1e-4 * torch.randn((TSNE_HOLD_N, 2), generator=gen)
    kls = {}
    for name, dev in (("card", "cuda"), ("cpu", "cpu")):
        t = Tsne(perplexity=TSNE_PERPLEXITY, n_iter=TSNE_HOLD_ITERS, seed=seed, device=dev)
        t0 = time.perf_counter()
        t.fit_transform(sub_cpu.numpy(), y0=y0)
        kls[name] = (t.kl_, time.perf_counter() - t0)
    kl_rel = abs(kls["card"][0] - kls["cpu"][0]) / kls["cpu"][0]
    check(kl_rel <= TSNE_KL_RTOL, f"16d: t-SNE at n={TSNE_HOLD_N}: kl_ card {kls['card'][0]} "
          f"CPU {kls['cpu'][0]} ({kl_rel:.3f} apart, at most {TSNE_KL_RTOL})")
    # the dashboard's scale on the card
    big = x[:TSNE_N]
    t = Tsne(perplexity=TSNE_PERPLEXITY, n_iter=TSNE_ITERS, seed=seed)
    p_sym = tsne_mod._joint_probabilities(big, TSNE_PERPLEXITY)
    yb0 = 1e-4 * torch.randn((TSNE_N, 2), generator=torch.Generator().manual_seed(seed))
    kl0 = float(tsne_mod._kl_divergence(p_sym, yb0.to(big.device)))
    del p_sym
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    emb = t.fit_transform(big.cpu().numpy(), y0=yb0)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    check(emb.shape == (TSNE_N, 2) and np.isfinite(emb).all() and math.isfinite(t.kl_)
          and t.kl_ < kl0, f"16d: t-SNE at n={TSNE_N}: kl_ {t.kl_} from {kl0}")
    out.update(p_max_abs_err=perr, hold_n=TSNE_HOLD_N, hold_iters=TSNE_HOLD_ITERS,
               kl_card=kls["card"][0], kl_cpu=kls["cpu"][0], kl_rel=kl_rel,
               hold_seconds_card=kls["card"][1], hold_seconds_cpu=kls["cpu"][1],
               n=TSNE_N, iters=TSNE_ITERS, wall_seconds=wall, kl=t.kl_, kl0=kl0,
               peak_bytes=torch.cuda.max_memory_allocated())
    print(f"  16d t-SNE: P after the perplexity search at n={TSNE_HOLD_N}, card vs CPU "
          f"{perr:.2e} (at most {TSNE_P_ATOL}); {TSNE_HOLD_ITERS} iterations from the same y0: "
          f"kl_ card {kls['card'][0]:.4f} ({kls['card'][1]:.2f} s), CPU {kls['cpu'][0]:.4f} "
          f"({kls['cpu'][1]:.2f} s), {kl_rel:.3f} apart; n={TSNE_N}, perplexity "
          f"{TSNE_PERPLEXITY:g}, {TSNE_ITERS} iterations: {wall:.2f} s wall, kl_ {t.kl_:.4f} "
          f"(from {kl0:.4f}), peak {out['peak_bytes'] / 2**30:.2f} GiB, on {card}")
    return out


def knn_tolerance(ref_d, sq_norm_bound, distance):
    """Per-entry tolerance of a server distance against the CPU's
    brute-force one: rtol 1e-5, plus for euclidean the matmul form's
    cancellation: ||q||^2 + ||p||^2 - 2 q.p is off by up to e2 = 4 eps
    (||q||^2 + ||p||^2), and |sqrt(a) - sqrt(a - e2)| is at most
    min(sqrt(e2), e2 / sqrt(a)), the reference distance being sqrt(a)."""
    tol = 1e-5 * np.abs(ref_d) + 1e-6
    if distance == "euclidean":
        e2 = 4 * np.finfo(np.float32).eps * sq_norm_bound
        tol = tol + np.minimum(np.sqrt(e2), e2 / np.maximum(ref_d, 1e-30))
    return tol


def knn_agrees(got, ref_idx, ref_d, sq_norm_bound, distance) -> tuple:
    """(ok, tied positions): indices equal to the reference's except where
    the reference ties (its k+1-th included), distances within
    knn_tolerance."""
    gi = np.array([r["index"] for r in got["results"]])
    gd = np.array([r["distance"] for r in got["results"]])
    k = len(gi)
    if k != KNN_K:
        return False, 0
    tol = knn_tolerance(ref_d, sq_norm_bound, distance)
    tie = np.zeros(k, bool)
    for j in range(k):
        # a tie within KNN_TIE, or within the comparison's own rounding
        # (the host tree's distances against the CPU's matmul form)
        within = max(KNN_TIE * max(1.0, abs(ref_d[j])), tol[j])
        tie[j] = (np.abs(ref_d - ref_d[j]) <= within).sum() > 1
    ok_idx = (gi == ref_idx[:k]) | tie
    ok_d = np.abs(gd - ref_d[:k]) <= tol[:k]
    return bool(ok_idx.all() and ok_d.all()), int(((gi != ref_idx[:k]) & tie).sum())


def knn_phase(torch, points, seed, card):
    from deeplearning4j_tpu_torch.clustering.distances import brute_force_knn
    from deeplearning4j_tpu_torch.serving import NearestNeighborsServer

    rng = np.random.default_rng(seed + 165)
    idx_pool = rng.choice(WORDS_N, KNN_POOL, replace=False)
    vec_pool = (points[rng.choice(WORDS_N, KNN_POOL, replace=False)]
                + WORDS_SIGMA * rng.standard_normal((KNN_POOL, WORDS_DIM))).astype(np.float32)
    queries = np.concatenate([points[idx_pool], vec_pool])
    sq = float((points.astype(np.float64) ** 2).sum(axis=1).max()
               + (queries.astype(np.float64) ** 2).sum(axis=1).max())
    out = {}
    for dist, n_req in KNN_REQUESTS.items():
        t0 = time.perf_counter()
        server = NearestNeighborsServer(points, dist, port=0)
        build_s = time.perf_counter() - t0
        port = server.start()
        ri, rd = brute_force_knn(points, queries, KNN_K + 1, dist, device="cpu")
        jobs = ([("/knn", {"k": KNN_K, "inputIndex": int(idx_pool[i % KNN_POOL])}, i % KNN_POOL)
                 for i in range(n_req)]
                + [("/knnvector", {"k": KNN_K, "vector": vec_pool[i % KNN_POOL].tolist()},
                    KNN_POOL + i % KNN_POOL) for i in range(n_req)])
        jobs = [jobs[i] for i in rng.permutation(len(jobs))]

        def call(i):
            route, payload, _ = jobs[i]
            t = time.perf_counter()
            code, body = post_json(f"http://127.0.0.1:{port}{route}", payload)
            return code, json.loads(body), time.perf_counter() - t

        try:
            res, wall = run_clients(KNN_CLIENTS, jobs, call)
        finally:
            server.stop()
        bad = [r for r in res if isinstance(r, Exception) or r[0] != 200]
        check(not bad, f"16d: k-NN {dist}: {len(bad)} failed requests, e.g. {bad[:1]}")
        ties, wrong = 0, []
        for (route, _, q), (_, body, _) in zip(jobs, res):
            ok, t = knn_agrees(body, ri[q], rd[q], sq, dist)
            ties += t
            if not ok:
                wrong.append((route, q))
        check(not wrong, f"16d: k-NN {dist}: {len(wrong)} answers differ from the CPU's brute "
              f"force, e.g. {wrong[:3]}")
        st = latency_stats([r[2] for r in res], wall, len(res))
        st.update(build_seconds=build_s, tied_positions=ties,
                  path="flat" if server.tree._points_dev is not None else "tree")
        out[dist] = st
        print(f"  16d k-NN server, {dist} ({st['path']} path, built in {build_s:.2f} s) over "
              f"[{WORDS_N}, {WORDS_DIM}]: {KNN_CLIENTS} clients, {n_req} /knn + {n_req} "
              f"/knnvector, k={KNN_K}: {st['requests_per_s']:.1f} requests/s, p50 "
              f"{st['p50_ms']:.2f} ms, p99 {st['p99_ms']:.2f} ms; every answer equals the CPU's "
              f"brute force ({ties} positions tied within {KNN_TIE}), on {card}")
    return out


def tsne_ui_phase(ui_port, points, card):
    """The dashboard's /tsne/compute on TSNE_UI_N of the vectors."""
    t0 = time.perf_counter()
    code, body = post_json(f"http://127.0.0.1:{ui_port}/tsne/compute", {
        "vectors": points[:TSNE_UI_N].tolist(),
        "words": [f"w{i}" for i in range(TSNE_UI_N)]})
    wall = time.perf_counter() - t0
    d = json.loads(get_body(f"http://127.0.0.1:{ui_port}/tsne/data"))
    check(code == 200 and len(d["coords"]) == TSNE_UI_N == len(d["words"])
          and all(len(c) == 2 and math.isfinite(c[0]) and math.isfinite(c[1])
                  for c in d["coords"]),
          f"16d: /tsne/compute {code}, /tsne/data {len(d['coords'])} pairs")
    print(f"  16d UIServer /tsne/compute on {TSNE_UI_N} vectors of {WORDS_DIM} (perplexity 20, "
          f"300 iterations, the route's defaults): 200 in {wall:.2f} s; /tsne/data holds "
          f"{len(d['coords'])} coordinate pairs, on {card}")
    return {"seconds": wall, "pairs": len(d["coords"])}


def ui_phase(torch, F, counts, seed, card):
    """16: the training UI (StatsListener, the conv-activation listener,
    the dashboard), the Keras backend entry point, and the clustering
    stack (k-means, t-SNE, the k-NN server) on the card at full width."""
    import shutil

    from deeplearning4j_tpu_torch.ui import FileStatsStorage, UIServer

    t_phase = time.perf_counter()
    shutil.rmtree(UI_DIR, ignore_errors=True)
    os.makedirs(UI_DIR)
    counts.reset()
    out = {}
    server = UIServer(FileStatsStorage(os.path.join(UI_DIR, "stats.bin")), port=0)
    port = server.start()
    try:
        out["stats_listener"] = stats_listener_phase(torch, F, counts, server.storage, port,
                                                     seed, card)
        out["conv_listener"] = conv_listener_phase(torch, F, seed, card)
        out["keras_backend"] = keras_backend_phase(torch, seed, card)
        x, points = word_vectors(torch, seed)
        out["kmeans"] = kmeans_phase(torch, x, points, seed, card)
        out["tsne"] = tsne_phase(torch, x, seed, card)
        del x
        torch.cuda.empty_cache()
        out["knn"] = knn_phase(torch, points, seed, card)
        out["tsne_ui"] = tsne_ui_phase(port, points, card)
    finally:
        server.stop()
        shutil.rmtree(UI_DIR, ignore_errors=True)
    torch.cuda.synchronize()
    out["launches"] = counts.read()
    for k in ("conv1x1_stats", "conv_kxk_stats", "bn_apply", "bn_backward_reduce",
              "bn_backward_apply"):
        check(out["launches"].get(k, 0) > 0, f"16: {k} launched {out['launches']}")
    out["seconds"] = time.perf_counter() - t_phase
    print(f"  16: launches {out['launches']}; {out['seconds']:.1f} s")
    torch.cuda.empty_cache()
    return out


def ui_summary(p16, card) -> dict:
    s = p16["stats_listener"]
    return {"card": card,
            "16a_stats_listener": {k: s[k] for k in (
                "step_p50_ms_with_listener", "step_p50_ms_without", "d2h_no_listener",
                "d2h_report", "d2h_report_histograms", "leaves", "records")},
            "16b_conv_listener": p16["conv_listener"],
            "16c_keras_backend": {k: p16["keras_backend"][k] for k in ("fit_seconds", "score")},
            "16d_kmeans": {d: {k: r[k] for k in ("lloyd_step_ms", "iterations")}
                           for d, r in p16["kmeans"].items()},
            "16d_tsne": {k: p16["tsne"][k] for k in ("wall_seconds", "kl", "kl_card", "kl_cpu",
                                                     "p_max_abs_err")},
            "16d_knn": {d: {k: r[k] for k in ("requests_per_s", "p50_ms", "p99_ms", "path")}
                        for d, r in p16["knn"].items()},
            "16d_tsne_ui_seconds": p16["tsne_ui"]["seconds"],
            "seconds": p16["seconds"]}



# -- 17: the operator CLI and the lock audit -----------------------------------

CLI_DIR = os.path.join(HERE, "_cli_smoke")
CLI_SERVER_START = 300      # 17a: seconds for the CLI's server to load, warm up and listen
LOCK_TIMED_STEPS = 32       # 17b: graphed ResNet-50 steps timed armed, then unarmed
LOCK_FUSED_K = 4            # 17b: set_fused_steps
LENET_CSV_ROWS = 1024       # 17c: synthetic 28x28 digits, one CSV row each
CHILD_TIMEOUT = 600
PROFILE_BOUND_RATIO = 20    # 17d: a kernel's time at most this many times its own bound
K4_K8 = ("conv1x1_stats", "conv_kxk_stats", "bn_apply", "bn_backward_reduce",
         "bn_backward_apply")


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def helper_hits(prom: str) -> dict:
    """helper_hit_total by op, summed over helpers and families, from a
    Prometheus text page."""
    out = collections.Counter()
    for line in prom.splitlines():
        if line.startswith("helper_hit_total{") and 'op="' in line:
            labels, value = line.rsplit(" ", 1)
            out[labels.split('op="', 1)[1].split('"', 1)[0]] += float(value)
    return dict(out)


def run_port_cli(argv):
    """The port's CLI in this process, its standard output captured:
    (exit code, stdout)."""
    import contextlib
    import io

    from deeplearning4j_tpu_torch.cli import main as cli_main

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli_main(list(argv))
    return rc, buf.getvalue()


def run_script_child(mode, seed, out, env_extra=None, timeout=CHILD_TIMEOUT) -> dict:
    """This script again as `--child <mode>`; its JSON record."""
    env = dict(os.environ, PYTHONPATH=HERE, **(env_extra or {}))
    res = subprocess.run([sys.executable, os.path.join(HERE, "chip_smoke.py"),
                          "--child", mode, "--seed", str(seed), "--out", out],
                         cwd=HERE, env=env, capture_output=True, text=True,
                         timeout=timeout)
    for line in res.stdout.splitlines():
        print(f"    | {line}")
    check(res.returncode == 0,
          f"17: the {mode} child exited {res.returncode}: {res.stderr[-3000:]}")
    with open(out) as f:
        return json.load(f)


def resnet_data(torch, F, DataSet, seed, n):
    g = torch.Generator(device="cuda").manual_seed(seed)
    data = []
    for _ in range(n):
        x = torch.randn((RESNET_BATCH, 224, 224, 3), generator=g, device="cuda")
        lab = torch.randint(0, 1000, (RESNET_BATCH,), generator=g, device="cuda")
        data.append(DataSet(x, F.one_hot(lab, 1000).float()))
    return data


def cli_server_phase(torch, seed, card, p13):
    """17a: the CLI's inference-server in a child process on phase 3's
    char-LSTM zip, phase 13a's traffic over HTTP; the child counts the
    kernels' launches from the moment it is ready, and `cli metrics --url`
    reads the server's helper hits (a check that K1 and K2 were reached)."""
    import signal
    import threading

    from deeplearning4j_tpu_torch.models.charlstm import char_lstm_network
    from deeplearning4j_tpu_torch.utils.model_serializer import load_model, save_model

    zpath = os.path.join(CLI_DIR, "charlstm.zip")
    save_model(char_lstm_network(vocab_size=VOCAB, hidden=HIDDEN, layers=LAYERS, seed=seed),
               zpath)
    net = load_model(zpath)  # the reference: the zip the server loads, in this process
    port = free_port()
    base = f"http://127.0.0.1:{port}"
    log_path = os.path.join(CLI_DIR, "server.log")
    counts_path = os.path.join(CLI_DIR, "server_launches.json")
    t0 = time.perf_counter()
    with open(log_path, "w") as log:
        proc = subprocess.Popen(
            [sys.executable, os.path.join(HERE, "chip_smoke.py"), "--child", "server",
             "--model-path", zpath, "--port", str(port), "--out", counts_path],
            cwd=HERE, env=dict(os.environ, PYTHONPATH=HERE), stdout=log,
            stderr=subprocess.STDOUT)

    def log_tail():
        with open(log_path) as f:
            return f.read()[-3000:]

    rc = None
    try:
        while not os.path.exists(counts_path + ".ready"):
            if proc.poll() is not None or time.perf_counter() - t0 > CLI_SERVER_START:
                raise SmokeFailure(f"17a: the CLI's server did not come up "
                                   f"(exit {proc.poll()}): {log_tail()}")
            time.sleep(0.5)
        t_up = time.perf_counter() - t0
        rng = np.random.default_rng(seed + 13)
        sizes = request_sizes(rng, SERVE_PREDICTS)
        tokens = [rng.integers(0, VOCAB, (n, SERVE_T)) for n in sizes]
        eye = np.eye(VOCAB, dtype=np.int8)
        grng = np.random.default_rng(seed + 1)
        gens = [(grng.integers(0, VOCAB, size=int(grng.integers(1, 33))).tolist(),
                 int(grng.integers(32, 65)), "a" if i % 4 else "b") for i in range(24)]
        lat = {"predict": [None] * len(sizes), "generate": [None] * len(gens)}

        def predict(i):
            t = time.perf_counter()
            status, raw = post_json(f"{base}/predict", {"features": eye[tokens[i]].tolist()})
            lat["predict"][i] = time.perf_counter() - t
            check(status == 200, f"17a: /predict answered {status}")
            return np.asarray(json.loads(raw)["predictions"], np.float32)

        def generate(i):
            prompt, mx, tenant = gens[i]
            t = time.perf_counter()
            status, raw = post_json(f"{base}/generate", {"prompt": prompt, "max_tokens": mx},
                                    headers={"X-Tenant": tenant})
            lat["generate"][i] = time.perf_counter() - t
            check(status == 200, f"17a: /generate answered {status}")
            return json.loads(raw)["tokens"]

        gen_res = {}
        gen_thread = threading.Thread(
            target=lambda: gen_res.update(zip(("out", "wall"), run_clients(
                SERVE_GEN_CLIENTS, list(range(len(gens))), generate))),
            name="smoke-cli-generate-clients", daemon=True)
        gen_thread.start()
        preds, wall = run_clients(SERVE_CLIENTS, list(range(len(sizes))), predict)
        gen_thread.join(timeout=600)
        check(not gen_thread.is_alive(), "17a: the /generate clients hung")
        bad = [repr(o) for o in list(preds) + list(gen_res["out"]) if isinstance(o, Exception)]
        check(not bad, f"17a: requests failed: {bad[:3]}")
        pm = json.loads(get_body(f"{base}/metrics"))
        prom_path = os.path.join(CLI_DIR, "metrics.prom")
        rc, _ = run_port_cli(["metrics", "--url", base, "--format", "prometheus",
                              "--output", prom_path])
        check(rc == 0, f"17a: cli metrics --url exited {rc}")
        with open(prom_path) as f:
            hits = helper_hits(f.read())
        proc.send_signal(signal.SIGTERM)
        rc = proc.wait(60)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(30)
    check(rc == 0 and os.path.exists(counts_path),
          f"17a: the server child exited {rc} at SIGTERM: {log_tail()}")
    with open(counts_path) as f:
        launches = {k: v for k, v in json.load(f).items() if v}
    h1, h2 = hits.get("lstm_sequence", 0.0), hits.get("lstm_decode_step", 0.0)
    check(h1 > 0 and h2 > 0, f"17a: the server's helper_hit_total shows K1 {h1}, K2 {h2}")
    k1, k2 = launches.get("lstm_sequence", 0), launches.get("lstm_step", 0)
    check(k1 > 0 and k2 > 0 and set(launches) <= {"lstm_sequence", "lstm_step"},
          f"17a: the server launched {launches} while it served")
    check(pm["admitted"] == pm["completed"] == len(sizes) and pm["conservation_ok"],
          f"17a: /predict books {pm}")
    errs = []
    for i, n in enumerate(sizes):
        ref = net.output(np.eye(VOCAB, dtype=np.float32)[tokens[i]]).float().cpu().numpy()
        errs.append(float(np.abs(preds[i] - ref).max()))
    check(max(errs) <= SLICE_ATOL,
          f"17a: a /predict row differs from in-process output() by {max(errs)} > {SLICE_ATOL}")
    gen_out = gen_res["out"]
    badg = [i for i, (p, mx, _) in enumerate(gens)
            if gen_out[i] != greedy_reference(torch, net, p, mx)]
    check(not badg, f"17a: /generate tokens differ from the greedy rnn_time_step loop for {badg}")
    n_ex = sum(sizes)
    rec = {"server_up_s": t_up, "predict": latency_stats(lat["predict"], wall, n_ex),
           "generate": latency_stats(lat["generate"], gen_res["wall"],
                                     sum(len(g) for g in gen_out)),
           "predict_max_abs_err": max(errs), "batches": pm["batches"],
           "helper_hits": hits, "launches": launches,
           "phase13_requests_per_s": p13["charlstm_server"]["predict"]["requests_per_s"]}
    print(f"  17a: cli inference-server (a child process, up in {t_up:.1f} s): "
          f"{len(sizes)} /predict from {SERVE_CLIENTS} clients beside 24 /generate: "
          f"{rec['predict']['requests_per_s']:.2f} requests/s (phase 13a in-process "
          f"{rec['phase13_requests_per_s']:.2f}), p50 {rec['predict']['p50_ms']:.1f} ms p99 "
          f"{rec['predict']['p99_ms']:.1f} ms; rows vs output() max abs {max(errs):.3e} "
          f"(tolerance {SLICE_ATOL}); /generate equals the greedy loop; launches counted in "
          f"the server from readiness to SIGTERM: K1 {k1}, K2 {k2}; cli metrics --url: "
          f"helper_hit_total lstm_sequence {h1:.0f}, lstm_decode_step {h2:.0f} on {card}")
    return rec


def server_child(model_path, port, out) -> int:
    """17a's server, in a process of its own: the CLI's entry point,
    `cli.main(["inference-server", ...])`, on phase 3's char-LSTM zip.
    Once /health answers (the server's warm-ups and decode captures are
    done by then) every kernel's launch count is set to 0 and a
    `<out>.ready` file appears; at SIGTERM the counts go to `out` and the
    server shuts down as on Ctrl-C."""
    import signal
    import threading

    from deeplearning4j_tpu_torch import cli
    from deeplearning4j_tpu_torch.ops import fused_conv_bn as fcb
    from deeplearning4j_tpu_torch.ops import fused_lstm as fl

    counts = LaunchCounts(fl, fcb)

    def ready():
        while True:
            try:
                get_body(f"http://127.0.0.1:{port}/health", timeout=5)
                break
            except OSError:
                time.sleep(0.2)
        counts.reset()
        with open(out + ".ready", "w") as f:
            f.write("ready\n")

    def on_term(signum, frame):
        with open(out, "w") as f:
            json.dump(counts.read(), f)
        raise KeyboardInterrupt  # the server's main stops it and returns

    signal.signal(signal.SIGTERM, on_term)
    threading.Thread(target=ready, name="smoke-server-ready", daemon=True).start()
    return cli.main(["inference-server", "--model-path", model_path, "--port", str(port),
                     "--max-batch-size", str(SERVE_MAX_BATCH),
                     "--warmup-shape", f"{SERVE_T},{VOCAB}",
                     "--decode-slots", str(SERVE_SLOTS)])


def locks_child(seed, out) -> int:
    """17b, in a process started with DL4J_LOCKCHECK=1: the graphed
    ResNet-50, the decode engine and the lock-audit smoke under the
    armed sanitizer, then the same ResNet-50 and a decode engine
    unarmed."""
    import torch
    import torch.nn.functional as F

    from deeplearning4j_tpu_torch.analysis import concurrency_audit as ca
    from deeplearning4j_tpu_torch.data import DataSet, DataSetIterator, ExistingDataSetIterator
    from deeplearning4j_tpu_torch.models.charlstm import char_lstm_network
    from deeplearning4j_tpu_torch.models.resnet import resnet50_network
    from deeplearning4j_tpu_torch.ops import fused_conv_bn as fcb
    from deeplearning4j_tpu_torch.ops import fused_lstm as fl
    from deeplearning4j_tpu_torch.serving.decode import DecodeEngine
    from deeplearning4j_tpu_torch.utils import locktrace, metrics

    check(locktrace.enabled(), "17b: DL4J_LOCKCHECK=1 did not arm the sanitizer at import")
    counts = LaunchCounts(fl, fcb)
    data = resnet_data(torch, F, DataSet, seed + 171, LOCK_FUSED_K)
    net = resnet50_network(precision="bf16", seed=seed,
                           learning_rate=RESNET_LR).set_fused_steps(LOCK_FUSED_K)

    def timed_steps():
        clock = SyncClock(torch, DataSetIterator, data, LOCK_TIMED_STEPS // LOCK_FUSED_K)
        net.fit(clock.it, async_prefetch=False)
        return quantiles([t / LOCK_FUSED_K for t in dispatch_times(clock, LOCK_FUSED_K)])

    lstm = char_lstm_network(vocab_size=VOCAB, hidden=HIDDEN, layers=LAYERS, seed=seed)
    rng = np.random.default_rng(seed + 1)
    reqs = [(rng.integers(0, VOCAB, size=int(rng.integers(1, 33))).tolist(),
             int(rng.integers(32, 65)), "a" if i % 4 else "b") for i in range(24)]
    waves = [reqs[:12], reqs[12:]]
    v2 = [{k: t * 1.01 for k, t in p.items()} for p in lstm.params_list]

    counts.reset()
    # armed: the warm-up (an eager group, then the capture), the timed replays
    net.fit(ExistingDataSetIterator(data * 2), async_prefetch=False)
    armed = {"resnet_step_s": timed_steps()}
    toks_armed, armed["decode"] = serve(torch, DecodeEngine, metrics, lstm, waves, v2, 1)
    smoke = ca.smoke(device="cuda")
    torch.cuda.synchronize()
    launches = counts.read()
    doc = ca.report(runtime=True)
    names = ca.finding_names(doc)
    with open(os.path.join(HERE, "deeplearning4j_tpu_torch", "analysis",
                           "lock_baseline.txt")) as f:
        baseline = sorted({ln.strip() for ln in f if ln.strip() and not ln.startswith("#")})
    n_runtime = sum(1 for e in doc["edges"] if e["origin"] != "static")
    rec = {"smoke": smoke, "names": names, "baseline": baseline,
           "lock_classes": len(doc["lock_classes"]), "edges": len(doc["edges"]),
           "runtime_edges": n_runtime, "launches": launches, "armed": armed,
           "findings": [f.to_dict() for f in doc["findings"]]}
    locktrace.uninstall()
    unarmed = {"resnet_step_s": timed_steps()}
    toks_unarmed, unarmed["decode"] = serve(torch, DecodeEngine, metrics, lstm, waves, v2, 1)
    rec["unarmed"] = unarmed
    rec["decode_tokens_equal"] = toks_armed == toks_unarmed
    with open(out, "w") as f:
        json.dump(rec, f, indent=1, default=str)
    print(f"armed: ResNet-50 step p50 {armed['resnet_step_s']['p50'] * 1e3:.2f} ms, decode "
          f"step p50 {armed['decode']['step_p50_s'] * 1e3:.4f} ms; unarmed: "
          f"{unarmed['resnet_step_s']['p50'] * 1e3:.2f} ms, "
          f"{unarmed['decode']['step_p50_s'] * 1e3:.4f} ms; {rec['lock_classes']} lock "
          f"classes, {rec['edges']} edges ({n_runtime} witnessed); CN names {names}")
    return 0


def chaos_child(seed, out) -> int:
    """17e, in a fresh process (a chaos verdict reads every health
    component of its process): `cli chaos` decode and divergence, each
    twice with one seed, and `cli trace` on each run's export."""
    from deeplearning4j_tpu_torch.ops import fused_conv_bn as fcb
    from deeplearning4j_tpu_torch.ops import fused_lstm as fl

    counts = LaunchCounts(fl, fcb)
    counts.reset()
    rec = {}
    for preset in ("decode", "divergence"):
        runs = []
        for i in range(2):
            rep_path = os.path.join(CLI_DIR, f"chaos_{preset}_{i}.json")
            trace_path = os.path.join(CLI_DIR, f"chaos_{preset}_{i}.jsonl")
            t0 = time.perf_counter()
            rc, _ = run_port_cli(["chaos", "--preset", preset, "--seed", str(seed),
                                  "--json", rep_path, "--trace-out", trace_path])
            wall = time.perf_counter() - t0
            with open(rep_path) as f:
                doc = json.load(f)
            trc, text = run_port_cli(["trace", trace_path, "--top", "3"])
            runs.append({"rc": rc, "verdict": doc["verdict"], "outcome": doc["outcome"],
                         "events": doc["events"], "wall_s": wall, "trace_rc": trc,
                         "trace_lines": len(text.splitlines()),
                         "lock_audit": doc.get("lock_audit")})
        rec[preset] = runs
    rec["launches"] = counts.read()
    with open(out, "w") as f:
        json.dump(rec, f, indent=1, default=str)
    for preset in ("decode", "divergence"):
        r = rec[preset]
        print(f"{preset}: exit codes {[x['rc'] for x in r]}, verdicts "
              f"{[x['verdict'] for x in r]}, {len(r[0]['events'])} fault(s), events equal "
              f"{r[0]['events'] == r[1]['events']}, wall {[round(x['wall_s'], 2) for x in r]} s, "
              f"cli trace exit codes {[x['trace_rc'] for x in r]}")
    return 0


def cli_train_phase(torch, counts, seed, card):
    """17c: `cli train` on LeNet over a CSV of synthetic digits, `cli
    evaluate`, then `cli resume` on a checkpoint of two graphed
    ResNet-50 steps."""
    import torch.nn.functional as F

    from deeplearning4j_tpu_torch.data import DataSet, ExistingDataSetIterator
    from deeplearning4j_tpu_torch.data.mnist import synthetic_mnist
    from deeplearning4j_tpu_torch.data.records import CSVRecordReader, RecordReaderDataSetIterator
    from deeplearning4j_tpu_torch.models.lenet import lenet_network
    from deeplearning4j_tpu_torch.models.resnet import resnet50_network
    from deeplearning4j_tpu_torch.train.checkpoint import CheckpointListener
    from deeplearning4j_tpu_torch.utils.model_serializer import load_model, save_model

    images, lab = synthetic_mnist(LENET_CSV_ROWS, seed=seed)
    flat = images.reshape(LENET_CSV_ROWS, -1).astype(np.float32) / 255.0
    csv_path = os.path.join(CLI_DIR, "digits.csv")
    np.savetxt(csv_path, np.concatenate([flat, lab[:, None].astype(np.float32)], axis=1),
               delimiter=",", fmt="%.6g")
    spec = f"csv:{csv_path}:{flat.shape[1]}:10"
    start, trained = os.path.join(CLI_DIR, "lenet.zip"), os.path.join(CLI_DIR, "lenet_out.zip")
    save_model(lenet_network(seed=seed), start)
    t0 = time.perf_counter()
    rc_train, _ = run_port_cli(["train", "--model-path", start, "--data", spec, "--epochs", "2",
                                "--batch-size", "64", "--print-every", "1000",
                                "--output", trained])
    t_train = time.perf_counter() - t0
    rc_eval, printed = run_port_cli(["evaluate", "--model-path", trained, "--data", spec])
    check(rc_train == 0 and rc_eval == 0,
          f"17c: cli train exited {rc_train}, cli evaluate {rc_eval}")
    net = load_model(trained)
    ev = net.evaluate(RecordReaderDataSetIterator(CSVRecordReader(csv_path), 128,
                                                  label_index=flat.shape[1], num_classes=10))
    check(printed.strip() == ev.stats().strip(),
          f"17c: the saved zip scores {ev.stats()!r}, cli evaluate printed {printed!r}")
    check(net.iteration == 2 * LENET_CSV_ROWS // 64, f"17c: {net.iteration} LeNet steps")

    data = resnet_data(torch, F, DataSet, seed + 173, 2)
    rn = resnet50_network(precision="bf16", seed=seed, learning_rate=RESNET_LR).set_fused_steps(2)
    rn.fit(ExistingDataSetIterator(data), async_prefetch=False)  # the eager warm-up group
    counts.reset()
    rn.fit(ExistingDataSetIterator(data), async_prefetch=False)  # captured, then replayed
    torch.cuda.synchronize()
    launches = counts.read()
    check(all(launches[k] > 0 for k in K4_K8), f"17c: the graphed steps launched {launches}")
    # a listener would turn the graphed group back into the per-step loop:
    # the listener's own save runs after the group
    ckdir = os.path.join(CLI_DIR, "ckpt")
    ckl = CheckpointListener(ckdir, every_n_iterations=None, every_n_epochs=None,
                             async_save=False)
    t0 = time.perf_counter()
    ckl.save(rn, reason="graphed")
    ckl.close()
    t_save = time.perf_counter() - t0
    t0 = time.perf_counter()
    rc_resume, text = run_port_cli(["resume", ckdir])
    t_resume = time.perf_counter() - t0
    check(rc_resume == 0 and "integrity: ok" in text and "loads OK" in text,
          f"17c: cli resume exited {rc_resume}: {text}")
    acc = float(ev.accuracy())
    rec = {"train_s": t_train, "lenet_steps": net.iteration, "accuracy": acc,
           "save_s": t_save, "resume_s": t_resume, "resnet_iteration": rn.iteration,
           "launches": launches}
    print(f"  17c: cli train LeNet ({LENET_CSV_ROWS} CSV rows, 2 epochs, b64) {t_train:.2f} s; "
          f"cli evaluate: accuracy {acc:.4f}, equal to the saved zip's own evaluation; two "
          f"graphed ResNet-50 steps (launches {launches}), checkpoint saved in {t_save:.2f} s; "
          f"cli resume: integrity ok, loads, {t_resume:.2f} s on {card}")
    del rn
    return rec


def cli_profile_phase(torch, counts, p15, seed, card):
    """17d: `cli profile` over a utils.profiler.trace of two graphed
    ResNet-50 steps; `cli perf --json` against phase 15's FLOP count."""
    import torch.nn.functional as F

    from deeplearning4j_tpu_torch.data import DataSet, ExistingDataSetIterator
    from deeplearning4j_tpu_torch.models.resnet import resnet50_network
    from deeplearning4j_tpu_torch.utils import profiler

    data = resnet_data(torch, F, DataSet, seed + 174, 2)
    rn = resnet50_network(precision="bf16", seed=seed, learning_rate=RESNET_LR).set_fused_steps(2)
    for _ in range(2):  # the eager warm-up group, then the capture
        rn.fit(ExistingDataSetIterator(data), async_prefetch=False)
    log_dir = os.path.join(CLI_DIR, "profile")
    counts.reset()
    with profiler.trace(log_dir):
        rn.fit(ExistingDataSetIterator(data), async_prefetch=False)  # one replay, two steps
    launches = counts.read()
    del rn
    prof_json = os.path.join(CLI_DIR, "profile.json")
    rc, _ = run_port_cli(["profile", "--log-dir", log_dir, "--json", prof_json, "--preset",
                          "resnet50", "--batch", str(RESNET_BATCH), "--steps", "2",
                          "--precision", "bf16"])
    with open(prof_json) as f:
        doc = json.load(f)
    fams = doc.get("families") or {}
    named = {n: fams.get(n) for n in OBS_KERNEL_FAMILIES}
    check(rc == 0 and doc["device"], f"17d: cli profile exited {rc}, device {doc.get('device')}")
    check(all(r is not None and r.get("ms", 0) > 0 and r.get("bound_of") == "kernel"
              for r in named.values()),
          f"17d: cli profile named {sorted(fams)}; K4-K8 rows {named}")
    # each kernel's bound prices the launches this capture made, and its
    # time lies at or above that floor, within PROFILE_BOUND_RATIO of it
    bad = {n: r for n, r in named.items()
           if r["launches"] != launches[n.split(" ", 1)[1]]
           or not r["bound_ms"] <= r["ms"] <= PROFILE_BOUND_RATIO * r["bound_ms"]}
    check(not bad, f"17d: K4-K8 against their own bounds (launches counted {launches}): {bad}")
    perf_json = os.path.join(CLI_DIR, "perf.json")
    t0 = time.perf_counter()
    rc_perf, _ = run_port_cli(["perf", "--preset", "resnet50", "--batch", str(RESNET_BATCH),
                               "--precision", "bf16", "--json", perf_json])
    t_perf = time.perf_counter() - t0
    with open(perf_json) as f:
        perf = json.load(f)
    flops = perf["cost_model"]["model_flops"]
    want = p15["resnet50_cost"]["model_flops"]
    check(rc_perf == 0 and flops == want,
          f"17d: cli perf exited {rc_perf}, FLOPs a step {flops} vs phase 15's {want}")
    rec = {"families": {n: {k: (r or {}).get(k) for k in ("ms", "bound_ms", "flops", "bytes",
                                                          "launches", "bound_of")}
                        for n, r in named.items()},
           "total_device_ms": doc["total_device_sec"] * 1e3, "launches": launches,
           "perf_model_flops": flops, "phase15_model_flops": want, "perf_s": t_perf,
           "vs_prior": perf.get("vs_prior")}
    print(f"  17d: cli profile over two graphed steps ({rec['total_device_ms']:.2f} ms of "
          f"device), each kernel against the bound of its own {RESNET_BATCH}-image work: "
          + ", ".join(f"{n} {r['ms']} ms (bound {r['bound_ms']}, {r['launches']} launches)"
                      for n, r in rec["families"].items())
          + f"; cli perf --json: {flops:.6g} FLOPs a step = phase 15's, {t_perf:.1f} s on {card}")
    return rec


def cli_locks_phase(torch, counts, p13, p15, seed, card):
    import shutil

    t0 = time.perf_counter()
    shutil.rmtree(CLI_DIR, ignore_errors=True)
    os.makedirs(CLI_DIR)
    out = {}
    try:
        out["server"] = cli_server_phase(torch, seed, card, p13)
        torch.cuda.empty_cache()
        t1 = time.perf_counter()
        lk = run_script_child("locks", seed, os.path.join(CLI_DIR, "locks.json"),
                       env_extra={"DL4J_LOCKCHECK": "1"})
        lk["wall_s"] = time.perf_counter() - t1
        check(lk["names"] == lk["baseline"],
              f"17b: the armed run's CN names {lk['names']} != lock_baseline.txt "
              f"{lk['baseline']}: {lk['findings']}")
        check(all(lk["launches"][k] > 0 for k in ("lstm_step",) + K4_K8),
              f"17b: launches while armed {lk['launches']}")
        check(lk["smoke"]["decode_ok"] and lk["smoke"]["sparse_ok"] and lk["runtime_edges"] > 0,
              f"17b: the audit smoke {lk['smoke']}, {lk['runtime_edges']} witnessed edges")
        check(lk["decode_tokens_equal"], "17b: the armed decode's tokens differ from unarmed")
        out["locks"] = lk
        a, u = lk["armed"], lk["unarmed"]
        print(f"  17b: DL4J_LOCKCHECK=1 child: ResNet-50 bf16 b{RESNET_BATCH} "
              f"set_fused_steps({LOCK_FUSED_K}) step p50 {a['resnet_step_s']['p50'] * 1e3:.2f} ms "
              f"armed / {u['resnet_step_s']['p50'] * 1e3:.2f} ms unarmed; decode step p50 "
              f"{a['decode']['step_p50_s'] * 1e3:.4f} / {u['decode']['step_p50_s'] * 1e3:.4f} ms; "
              f"{lk['lock_classes']} traced lock classes, {lk['edges']} edges "
              f"({lk['runtime_edges']} witnessed); CN names = lock_baseline.txt "
              f"({lk['names']}); launches armed {lk['launches']}; {lk['wall_s']:.1f} s on {card}")
        torch.cuda.empty_cache()
        out["train"] = cli_train_phase(torch, counts, seed, card)
        torch.cuda.empty_cache()
        out["profile"] = cli_profile_phase(torch, counts, p15, seed, card)
        torch.cuda.empty_cache()
        t1 = time.perf_counter()
        ch = run_script_child("chaos", seed, os.path.join(CLI_DIR, "chaos.json"))
        ch["wall_s"] = time.perf_counter() - t1
        for preset in ("decode", "divergence"):
            r = ch[preset]
            check([x["rc"] for x in r] == [0, 0] and [x["verdict"] for x in r] == ["ok", "ok"],
                  f"17e: chaos {preset}: {[(x['rc'], x['verdict'], x['outcome']) for x in r]}")
            check(r[0]["events"] == r[1]["events"] and r[0]["events"],
                  f"17e: chaos {preset}'s two runs injected {r[0]['events']} and {r[1]['events']}")
            check([x["trace_rc"] for x in r] == [0, 0] and r[0]["trace_lines"] > 3,
                  f"17e: cli trace on the {preset} exports: {r}")
        check(ch["launches"]["lstm_step"] > 0, f"17e: the decode preset launched {ch['launches']}")
        out["chaos"] = ch
        print(f"  17e: cli chaos decode and divergence, twice each with seed {seed}: verdicts ok, "
              f"events equal ({len(ch['decode'][0]['events'])} and "
              f"{len(ch['divergence'][0]['events'])} faults), cli trace renders each export; "
              f"K2 launches {ch['launches']['lstm_step']}; {ch['wall_s']:.1f} s")
    finally:
        shutil.rmtree(CLI_DIR, ignore_errors=True)
    # each path's count from zero: 17a's, 17b's and 17e's from their
    # children (the server's from its readiness on), 17c's and 17d's here
    out["launches"] = {"cli_serving": out["server"]["launches"],
                       "lock_audit": out["locks"]["launches"],
                       "cli_resume": out["train"]["launches"],
                       "cli_profile": out["profile"]["launches"],
                       "cli_chaos": out["chaos"]["launches"]}
    out["seconds"] = time.perf_counter() - t0
    print(f"  phase 17: {out['seconds']:.1f} s")
    return out


def cli_locks_summary(p17, card) -> dict:
    lk = p17["locks"]
    return {"card": card,
            "17a_requests_per_s": p17["server"]["predict"]["requests_per_s"],
            "17a_phase13_requests_per_s": p17["server"]["phase13_requests_per_s"],
            "17a_predict_p50_ms": p17["server"]["predict"]["p50_ms"],
            "17a_helper_hits": p17["server"]["helper_hits"],
            "17b_resnet_step_p50_ms": {arm: lk[arm]["resnet_step_s"]["p50"] * 1e3
                                       for arm in ("armed", "unarmed")},
            "17b_decode_step_p50_ms": {arm: lk[arm]["decode"]["step_p50_s"] * 1e3
                                       for arm in ("armed", "unarmed")},
            "17b_lock_classes": lk["lock_classes"], "17b_edges": lk["edges"],
            "17b_runtime_edges": lk["runtime_edges"], "17b_names": lk["names"],
            "17c_accuracy": p17["train"]["accuracy"],
            "17d_families": p17["profile"]["families"],
            "17d_model_flops": p17["profile"]["perf_model_flops"],
            "17e_faults": {p: len(p17["chaos"][p][0]["events"]) for p in ("decode", "divergence")},
            "launches": p17["launches"], "seconds": p17["seconds"]}


SHARD_DEVICES = ("cuda:0", "cuda:0")  # 18a: two shards on the one card
SHARD_MAX_BATCH = 16       # 18a: buckets 1, 2, 4, 8, 16; requests of 1-16 rows
SHARD_REQUESTS = 1024      # 18a: requests in each arm's round
SHARD_ROUNDS = 2           # 18a: the arms alternate, default then sharded, this many times
SHARD_RTOL, SHARD_ATOL = 1e-5, 1e-6  # 18a: a served row against its own output()
SCAN_FUSED_K = 4           # 18b: batches, eager steps before the holds; set_fused_steps(4) ...
SCAN_GROUPS = 3            # ... warm-up, capture + replay, replay: the held groups
SCAN_ROUNDS = 2            # 18b: the timed arms alternate, unrolled then scanned, this many times
SCAN_EAGER_EPOCHS = 3      # ... each round SCAN_FUSED_K x this eager steps timed (24 an arm)
SCAN_TIMED_GROUPS = 12     # ... each round this many graphed groups timed (24 replays an arm)
SCAN_BODIES = (12, 4)      # 18b: graph_block, ResNet-50 unrolled and scanned


def expected_traces(buckets, n_shards) -> int:
    """Distinct forward shapes once every bucket is padded to a multiple of
    the shard count (the JAX package's serving test's `_expected_traces`)."""
    return len({b + (-b) % n_shards for b in buckets})


def shard_arm(torch, counts, devices, sizes, tokens, seed, card):
    """One arm of 18a: a fresh full-width char-LSTM behind ParallelInference
    with `devices`, warmed, then every request from SERVE_CLIENTS threads;
    then the model's parameters change (set_params) and one request must
    read the new ones on every shard."""
    from deeplearning4j_tpu_torch.models.charlstm import char_lstm_network
    from deeplearning4j_tpu_torch.parallel import ParallelInference

    net = char_lstm_network(vocab_size=VOCAB, hidden=HIDDEN, layers=LAYERS, seed=seed)
    eye = np.eye(VOCAB, dtype=np.float32)
    xs = [eye[t] for t in tokens]
    pi = ParallelInference(net, max_batch_size=SHARD_MAX_BATCH, devices=devices)
    lat = [None] * len(xs)
    try:
        pi.warmup((SERVE_T, VOCAB))
        warm = net.output_compile_count
        torch.cuda.synchronize()
        counts.reset()

        def call(i):
            t = time.perf_counter()
            out = pi.output(xs[i])
            lat[i] = time.perf_counter() - t
            return out

        outs, wall = run_clients(SERVE_CLIENTS, list(range(len(xs))), call)
        torch.cuda.synchronize()
        launches = counts.read()
        m = pi.metrics()
        after = net.output_compile_count
        n_shards = pi.n_shards
        big = int(np.argmax(sizes))
        net.set_params(net.params() * 0.5)
        changed = pi.output(xs[big])
    finally:
        pi.shutdown()
    bad = [repr(o) for o in outs if isinstance(o, Exception)]
    check(not bad, f"18a: requests failed: {bad[:3]}")
    want = expected_traces(pi.buckets, n_shards)
    check(warm == want and after == warm,
          f"18a: {n_shards} shards: {warm} forward-cache entries at warm-up, {after} after "
          f"traffic, expected {want}")
    check(launches["lstm_sequence"] == LAYERS * n_shards * m["batches"],
          f"18a: {launches['lstm_sequence']} K1 launches for {m['batches']} groups of "
          f"{n_shards} shards x {LAYERS} layers")

    def excess_and_err(out, x):
        ref = net.output(x).float().cpu().numpy()
        return (float((np.abs(out - ref) - SHARD_ATOL - SHARD_RTOL * np.abs(ref)).max()),
                float(np.abs(out - ref).max()))

    changed_excess, changed_err = excess_and_err(changed, xs[big])
    check(changed_excess <= 0,
          f"18a: {n_shards} shards: after set_params a request differs from output() by "
          f"{changed_err}: a shard served the old parameters")
    net.set_params(net.params() * 2.0)
    excess, err = 0.0, 0.0
    for x, out in zip(xs, outs):
        e, a = excess_and_err(out, x)
        excess, err = max(excess, e), max(err, a)
    check(excess <= 0, f"18a: {n_shards} shards: a row differs from its own output() by "
                       f"{err} (beyond rtol {SHARD_RTOL}, atol {SHARD_ATOL})")
    rec = {"devices": [str(d) for d in pi.devices], "n_shards": n_shards,
           "forward_compiles": warm, "expected_traces": want,
           "batches": m["batches"], "bucket_hits": m["bucket_hits"],
           "k1_launches": launches["lstm_sequence"], "launches": launches,
           "max_abs_err": err, "after_set_params_err": changed_err,
           **latency_stats(lat, wall, sum(len(x) for x in xs))}
    print(f"  18a {n_shards} shard(s) on {rec['devices']}: {len(xs)} requests "
          f"({rec['examples']} rows) from {SERVE_CLIENTS} threads, {wall:.3f} s: "
          f"{rec['requests_per_s']:.1f} requests/s, p50 {rec['p50_ms']:.2f} ms p99 "
          f"{rec['p99_ms']:.2f} ms; K1 {rec['k1_launches']} = {LAYERS} layers x {n_shards} x "
          f"{m['batches']} groups; output_compile_count {warm} = _expected_traces "
          f"{want}; rows vs own output() max abs {err:.3e}, after set_params "
          f"{changed_err:.3e} (tolerance rtol {SHARD_RTOL}, atol {SHARD_ATOL}) on {card}")
    del net
    return rec


def shard_arms(torch) -> list:
    """18a's arms: the default (one shard), two shards on the one card and,
    where the process sees several cards, one shard on each."""
    arms = [("default", None), ("sharded", list(SHARD_DEVICES))]
    n = torch.cuda.device_count()
    if n > 1:
        arms.append(("cards", [f"cuda:{i}" for i in range(n)]))
    return arms


def shards_phase(torch, counts, seed, card):
    """18a: the full-width char-LSTM behind ParallelInference split over two
    shards of the one card (and over every card, where there are several),
    against the default (one shard); the arms alternate SHARD_ROUNDS times."""
    rng = np.random.default_rng(seed + 18)
    sizes = request_sizes(rng, SHARD_REQUESTS, top=SHARD_MAX_BATCH)
    tokens = [rng.integers(0, VOCAB, (n, SERVE_T)) for n in sizes]
    arms = shard_arms(torch)
    out = {arm: [] for arm, _ in arms}
    for _ in range(SHARD_ROUNDS):
        for arm, devices in arms:
            out[arm].append(shard_arm(torch, counts, devices, sizes, tokens, seed, card))
            torch.cuda.empty_cache()
    shards = {arm: {r["n_shards"] for r in rounds} for arm, rounds in out.items()}
    check(shards["default"] == {1} and shards["sharded"] == {2},
          f"18a: shards {shards}")
    return out


def graph_block_count(metrics) -> float:
    return metrics.get_registry().counter(
        "compile_total", "forward-cache insertions (new shapes)",
        ("kind",)).labels("graph_block").value


def block_scan_phase(torch, F, counts, metrics, seed, card):
    """18b: ResNet-50 bf16 at batch 128, unrolled against scanned runs, eager
    and graphed (set_fused_steps(4))."""
    from deeplearning4j_tpu_torch.data import DataSet, DataSetIterator, ExistingDataSetIterator
    from deeplearning4j_tpu_torch.models.resnet import resnet50_network

    data = resnet_batches(torch, F, DataSet, seed + 180, SCAN_FUSED_K, RESNET_BATCH)
    per_step = resnet_per_step(RESNET_BATCH)
    det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True

    def network(mode, k=1):
        return resnet50_network(precision="bf16", seed=seed,
                                learning_rate=RESNET_LR).set_block_scan(mode).set_fused_steps(k)

    def timed(nets, epochs, per):
        """Each arm's synced step seconds, the arms alternating SCAN_ROUNDS
        times, `epochs` passes over the batches a round."""
        steps = {mode: [] for mode in nets}
        for _ in range(SCAN_ROUNDS):
            for mode, net in nets.items():
                clock = SyncClock(torch, DataSetIterator, data, epochs)
                net.fit(clock.it, async_prefetch=False)
                steps[mode] += [t / per for t in dispatch_times(clock, per)]
        return {mode: quantiles(ts) for mode, ts in steps.items()}

    rec = {}
    try:
        nets, eager = {}, {}
        for mode in ("unroll", "scan"):
            net = nets[mode] = network(mode)
            with torch.no_grad():
                out = net.output(data[0].features)
            torch.cuda.synchronize()
            c0 = graph_block_count(metrics)
            counts.reset()
            net.fit(ExistingDataSetIterator(data), async_prefetch=False)
            torch.cuda.synchronize()
            eager[mode] = {"output": out, "launches": counts.read(),
                           "graph_block": graph_block_count(metrics) - c0}
        u, s = eager["unroll"], eager["scan"]
        same = nets_equal(torch, nets["unroll"], nets["scan"])
        check(torch.equal(u["output"], s["output"]),
              "18b: output() differs between the unrolled and the scanned ResNet-50")
        check(same, "18b: eager steps differ between unrolled and scanned (params, Nesterovs "
                    "v or BN statistics)")
        want = {n: v * len(data) for n, v in per_step.items()}
        for mode in ("unroll", "scan"):
            got = {n: eager[mode]["launches"][n] for n in K4_K8}
            check(got == want, f"18b: {mode} eager K4-K8 launches {got}, expected {want}")
        check((u["graph_block"], s["graph_block"]) == SCAN_BODIES,
              f"18b: graph_block {u['graph_block']} unrolled, {s['graph_block']} scanned, "
              f"expected {SCAN_BODIES}")
        rec["eager"] = {"bit_equal": same, "launches": want,
                        "graph_block": {"unroll": u["graph_block"], "scan": s["graph_block"]}}
        rec["launches"] = {"block_scan": s["launches"]}
        print(f"  18b eager: {len(data)} steps, output() and params/Nesterovs v/BN statistics "
              f"bit-equal {same}; K4-K8 launches {want} in both; graph_block "
              f"{u['graph_block']:.0f} unrolled, {s['graph_block']:.0f} scanned, on {card}")
        rec["eager"]["step_s"] = timed(nets, SCAN_EAGER_EPOCHS, 1)
        q = rec["eager"]["step_s"]
        print(f"  18b eager step p50 {q['unroll']['p50'] * 1e3:.2f} ms unrolled, "
              f"{q['scan']['p50'] * 1e3:.2f} ms scanned; p99 {q['unroll']['p99'] * 1e3:.2f} / "
              f"{q['scan']['p99'] * 1e3:.2f} ms ({q['scan']['n']} synced steps an arm, "
              f"{SCAN_ROUNDS} alternating rounds) on {card}")
        del nets, eager, u, s
        torch.cuda.empty_cache()
        k = SCAN_FUSED_K
        nets, launches = {}, {}
        for mode in ("unroll", "scan"):
            net = nets[mode] = network(mode, k)
            counts.reset()
            net.fit(ExistingDataSetIterator(data * SCAN_GROUPS), async_prefetch=False)
            torch.cuda.synchronize()
            launches[mode] = counts.read()
            prog = list(net._programs.values())
            check(len(prog) == 1 and prog[0].replays == SCAN_GROUPS - 1,
                  f"18b: {mode} graphed programs {[(p.key, p.replays) for p in prog]}")
        same = nets_equal(torch, nets["unroll"], nets["scan"])
        want = {n: v * k * SCAN_GROUPS for n, v in per_step.items()}
        check(same, "18b: graphed steps differ between unrolled and scanned")
        got = {m: {n: launches[m][n] for n in K4_K8} for m in launches}
        check(got["unroll"] == got["scan"] == want,
              f"18b: graphed K4-K8 launches {got}, expected {want}")
        rec["graphed"] = {"bit_equal": same, "launches": want}
        rec["launches"]["block_scan_graphed"] = launches["scan"]
        rec["graphed"]["step_s"] = timed(nets, SCAN_TIMED_GROUPS, k)
        for mode, net in nets.items():
            rec["graphed"][f"{mode}_pool_bytes"] = sum(g["pool_bytes"]
                                                       for g in net.fit_graphs())
        q = rec["graphed"]["step_s"]
        print(f"  18b graphed (set_fused_steps({k}), {SCAN_GROUPS} groups: warm-up, capture, "
              f"replay): bit-equal {same}; K4-K8 launches {want} in both; step p50 "
              f"{q['unroll']['p50'] * 1e3:.3f} ms unrolled, {q['scan']['p50'] * 1e3:.3f} ms "
              f"scanned, p99 {q['unroll']['p99'] * 1e3:.3f} / {q['scan']['p99'] * 1e3:.3f} ms "
              f"({q['scan']['n']} replays an arm, {SCAN_ROUNDS} alternating rounds, host clock "
              f"synced a group); graph pools "
              f"{rec['graphed']['unroll_pool_bytes'] / 2 ** 30:.2f} / "
              f"{rec['graphed']['scan_pool_bytes'] / 2 ** 30:.2f} GiB on {card}")
        del nets
    finally:
        torch.backends.cudnn.deterministic = det
    return rec


def gaps_phase(torch, F, counts, metrics, seed, card, only_shards=False):
    t0 = time.perf_counter()
    out = {"shards": shards_phase(torch, counts, seed, card)}
    torch.cuda.empty_cache()
    out["launches"] = {"sharded_serving": out["shards"]["sharded"][0]["launches"]}
    if not only_shards:
        out["block_scan"] = block_scan_phase(torch, F, counts, metrics, seed, card)
        torch.cuda.empty_cache()
        out["launches"].update(out["block_scan"]["launches"])
    out["seconds"] = time.perf_counter() - t0
    print(f"  phase 18: {out['seconds']:.1f} s")
    return out


def gaps_summary(p18, card) -> dict:
    keys = ("devices", "n_shards", "forward_compiles", "expected_traces", "k1_launches",
            "requests", "seconds", "requests_per_s", "p50_ms", "p99_ms", "max_abs_err",
            "after_set_params_err")
    out = {"card": card,
           "18a": {arm: [{k: r[k] for k in keys} for r in rounds]
                   for arm, rounds in p18["shards"].items()},
           "launches": p18["launches"], "seconds": p18["seconds"]}
    bs = p18.get("block_scan")
    if bs is not None:
        out["18b_graph_block"] = bs["eager"]["graph_block"]
        for kind in ("eager", "graphed"):
            out[f"18b_{kind}_step_ms"] = {
                m: {k: (v * 1e3 if k != "n" else v) for k, v in q.items()}
                for m, q in bs[kind]["step_s"].items()}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=os.path.join("chiprun_out", "chip_smoke.json"))
    ap.add_argument("--child", choices=["charlstm", "server", "locks", "chaos"], default=None,
                    help="run phase 7a's killed fit, 17a's server, 17b's armed run or "
                         "17e's chaos runs (started by the script itself)")
    ap.add_argument("--ckpt-dir", default=None, help="the child's checkpoint directory")
    ap.add_argument("--model-path", default=None, help="the server child's model zip")
    ap.add_argument("--port", type=int, default=None, help="the server child's port")
    ap.add_argument("--only", choices=["18", "18a"], default=None,
                    help="build the kernels, then run this phase (or 18a, the sharded "
                         "serving, over every visible card) alone and print its JSON "
                         "line (not the result lines)")
    args = ap.parse_args(argv)
    if args.child == "charlstm":
        return charlstm_child(args.ckpt_dir, args.seed)
    if args.child == "server":
        return server_child(args.model_path, args.port, args.out)
    if args.child == "locks":
        return locks_child(args.seed, args.out)
    if args.child == "chaos":
        return chaos_child(args.seed, args.out)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    from deeplearning4j_tpu_torch.common.dtypes import default_policy
    from deeplearning4j_tpu_torch.data import DataSet, ExistingDataSetIterator
    import torch.nn.functional as F

    from deeplearning4j_tpu_torch.models.charlstm import char_lstm_network
    from deeplearning4j_tpu_torch.models.resnet import resnet50_network
    from deeplearning4j_tpu_torch.ops import cuda_build, helpers
    from deeplearning4j_tpu_torch.ops import fused_conv_bn as fcb
    from deeplearning4j_tpu_torch.ops import fused_lstm as fl
    from deeplearning4j_tpu_torch.serving.decode import DecodeEngine
    from deeplearning4j_tpu_torch.train.listeners import IterationListener
    from deeplearning4j_tpu_torch.utils import metrics

    t_start = time.perf_counter()
    default_policy().apply()  # no TF32 anywhere, library yardsticks included
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    print(f"[1] device: {card} ({kind}); torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}")
    t0 = time.perf_counter()
    info = cuda_build.build_all(variants=[(n, d) for n in ("bn_apply", "bn_backward")
                                          for d in BN_SWEEP]
                                + [("lstm_step", d) for d in STEP_SWEEP])
    print(f"  kernels built in {time.perf_counter() - t0:.2f} s")
    for name, rec in info.items():
        if name not in cuda_build.SOURCES:
            continue  # a swept variant: its registers are in the json record
        fn = ""
        for line in rec["log"].splitlines():
            if "Compiling entry function" in line:
                fn = kernel_name(line)
            elif "registers" in line or "spill" in line:
                print(f"  {name} {fn}: {line.split(':', 1)[-1].strip()}")
    hgmma = tensor_core_check(cuda_build)
    if args.only is not None:
        p18 = gaps_phase(torch, F, LaunchCounts(fl, fcb), metrics, args.seed, card,
                         only_shards=args.only == "18a")
        print(json.dumps({"gaps": gaps_summary(p18, card)}))
        return 0

    print(f"[2] kernels vs plain versions (tolerance: f32 {F32_ATOL} abs; "
          f"bf16 {BF16_ULP}*max(1, |plain|))")
    print("  LSTM kernels at char-LSTM's widths")
    rows = kernel_phase(torch, fl, args.seed)
    rows["lstm_sequence"] = sequence_phase(torch, fl, args.seed)
    print(f"  backward kernel: f32 {F32_ATOL} abs, {F32_ATOL}*sqrt(T*B) for "
          f"the sums dRW and dp; bf16 as above")
    rows["lstm_sequence_backward"] = backward_phase(torch, fl, args.seed)
    print(f"  conv/BN kernels at ResNet-50's widths, batch {RESNET_BATCH} (tolerance: y "
          f"f32 {F32_ATOL}*sqrt(Cin*kh*kw) abs, bf16 as above; s1, s2 and "
          f"K7's sums {SUMS_RTOL}*sqrt(M) of the exact sums; BN passes as above)")
    rows.update(conv_bn_kernel_phase(torch, F, fcb, args.seed))

    def lstm_path(fn):
        """An LSTM phase, with the conv/BN counts read from zero around it."""
        fcb.reset_launch_counts()
        out = fn()
        out["launches"] = {**out["launches"], **fcb.launch_counts()}
        return out

    print("[3] slice: output() at full width")
    net = char_lstm_network(vocab_size=VOCAB, hidden=HIDDEN, layers=LAYERS,
                            seed=args.seed)
    sl = lstm_path(lambda: slice_phase(torch, fl, helpers, net, args.seed))

    print("[4] serve: DecodeEngine(n_slots=8), 24 requests, one swap, K=1 and K=4")
    sv = lstm_path(lambda: serve_phase(torch, fl, DecodeEngine, metrics, net,
                                       args.seed, card))

    print(f"[5] train: fit {TRAIN_BATCHES} batches of [{TRAIN_B}, {TRAIN_T}, "
          f"{VOCAB}] at full width, TBPTT {TBPTT}, RMSProp lr {TRAIN_LR}")
    tr = lstm_path(lambda: train_phase(
        torch, fl, helpers, char_lstm_network, DataSet, ExistingDataSetIterator,
        IterationListener, args.seed, card))

    print(f"[6] train ResNet-50: bf16, batch {RESNET_BATCH}, 224x224x3, Nesterovs "
          f"lr {RESNET_LR}")
    del net
    fl.reset_launch_counts()
    rn = resnet_phase(torch, F, fcb, helpers, resnet50_network, DataSet,
                      ExistingDataSetIterator, IterationListener, args.seed, card)
    rn["launches"] = {**rn["launches"], **fl.launch_counts()}

    print(f"[7] checkpoint, resume, evaluate, serve from a zip: char-LSTM and "
          f"ResNet-50 at full width, {CKPT_EPOCHS} epochs each")
    ck = checkpoint_phase(torch, F, fl, fcb, char_lstm_network, resnet50_network,
                          DecodeEngine, metrics, args.seed, card)

    print("[8] the fused dispatch as CUDA graphs: char-LSTM (fused TBPTT, then "
          f"set_fused_steps({FUSED_LSTM_K})) and ResNet-50 (set_fused_steps("
          f"{FUSED_RESNET_K})) against the eager loop; prefetch on and off")
    from deeplearning4j_tpu_torch.data import DataSetIterator, ListDataSetIterator

    torch.cuda.empty_cache()
    fl.reset_launch_counts()
    fcb.reset_launch_counts()
    fu = {"charlstm": fused_lstm_phase(torch, fl, char_lstm_network, DataSet,
                                       ExistingDataSetIterator, DataSetIterator,
                                       IterationListener, args.seed, card)}
    torch.cuda.empty_cache()
    fu["resnet50"] = fused_resnet_phase(torch, F, fcb, resnet50_network, DataSet,
                                        ExistingDataSetIterator, DataSetIterator,
                                        IterationListener, args.seed, card)
    torch.cuda.empty_cache()
    fu["prefetch"] = fused_prefetch_phase(torch, char_lstm_network, DataSet,
                                          ListDataSetIterator, args.seed, card)
    torch.cuda.synchronize()
    fu["launches"] = {**fl.launch_counts(), **fcb.launch_counts()}

    print("[9] LeNet, the second layer slice on the card, VGG16 through the Keras "
          "importer, transfer learning (VGG16 and ResNet-50)")
    counts = LaunchCounts(fl, fcb)

    def clocked(batches, epochs=1, net=None, per=1):
        return SyncClock(torch, DataSetIterator, batches, epochs, net=net, per=per)

    torch.cuda.empty_cache()
    counts.reset()
    p9 = {"lenet": lenet_phase(torch, counts, metrics, IterationListener, clocked,
                               args.seed, card)}
    p9["layers"] = layers_phase(torch, args.seed, card)
    torch.cuda.empty_cache()
    counts.reset()
    p9["vgg16"] = vgg_phase(torch, F, counts, metrics, DataSet, IterationListener, clocked,
                            args.seed, card)
    counts.reset()
    p9["resnet50_transfer"] = resnet_transfer_phase(
        torch, F, counts, helpers, metrics, DataSet, IterationListener, clocked,
        args.seed, card)

    print("[10] the divergence sentinel (quarantine and rollback), the line-search "
          "solvers, the DL4J-format importer")
    torch.cuda.empty_cache()
    p10 = {"rollback": sentinel_rollback_phase(torch, fl, char_lstm_network, DataSet,
                                               DataSetIterator, metrics, args.seed, card)}
    torch.cuda.empty_cache()
    p10["cost"] = sentinel_cost_phase(torch, F, counts, resnet50_network, DataSet,
                                      DataSetIterator, args.seed, card)
    torch.cuda.empty_cache()
    p10["solvers"] = solver_phase(torch, counts, args.seed, card)
    p10["import"] = import_phase(torch, counts, args.seed, card)

    print("[11] the embeddings stack: Word2Vec, ParagraphVectors, GloVe, DeepWalk, the "
          "serializer")
    torch.cuda.empty_cache()
    p11 = embeddings_phase(torch, counts, args.seed, card)

    print(f"[12] scale-out: the data-parallel step over {SCALE_RANKS} processes on the card "
          "(gloo, CUDA tensors): VGG16 and ResNet-50 at full width, the char-LSTM; TP, "
          "pipeline and ring attention; one NCCL rank")
    torch.cuda.empty_cache()
    p12 = scale_out_phase(torch, F, counts, metrics, args.seed, card)

    print("[13] the serving front end: the char-LSTM behind InferenceServer (/predict "
          "and /generate over HTTP), ResNet-50 through a ReplicaPool with one eviction, "
          "overload shedding")
    torch.cuda.empty_cache()
    p13 = serving_phase(torch, counts, metrics, args.seed, card)

    print("[14] the parameter-server path and the run ledger: the recsys tower over the "
          "sharded EmbeddingParameterServer (pipelined and synchronous), the recsys preset's "
          "fit with run_ledger=, the serving entry points with ledgers, MFU")
    torch.cuda.empty_cache()
    p14 = recsys_ledger_phase(torch, counts, args.seed, card, tr, fu)

    print("[15] device observability and static analysis: the conv kernel coverage, the "
          "step cost model, the sampled device profiler with OOM forensics, the profiler's "
          "family summary")
    torch.cuda.empty_cache()
    p15 = observability_phase(torch, F, fcb, helpers, cuda_build, counts, fu, args.seed,
                              card)

    print("[16] the training UI and the clustering stack: StatsListener through the remote "
          "router into the dashboard on ResNet-50, the conv-activation listener on VGG16, the "
          "Keras backend server, k-means, t-SNE and the k-NN server at word2vec's width")
    torch.cuda.empty_cache()
    p16 = ui_phase(torch, F, counts, args.seed, card)

    print("[17] the operator CLI and the lock audit: cli inference-server in a child process, "
          "the graphed ResNet-50, the decode engine and the audit smoke under DL4J_LOCKCHECK=1, "
          "cli train/evaluate/resume, cli profile and perf, cli chaos and trace")
    torch.cuda.empty_cache()
    p17 = cli_locks_phase(torch, counts, p13, p15, args.seed, card)

    print(f"[18] ParallelInference over several devices and the scan over identical blocks: "
          f"the char-LSTM split over {SHARD_DEVICES} against one shard, ResNet-50 bf16 "
          f"b{RESNET_BATCH} unrolled against looped runs, eager and set_fused_steps("
          f"{SCAN_FUSED_K})")
    torch.cuda.empty_cache()
    p18 = gaps_phase(torch, F, counts, metrics, args.seed, card)

    # each main path's count, read just after it ran from zero
    by_path = {"output": sl["launches"], "serve": sv["launches"],
               "train": tr["launches"], "train_resnet": rn["launches"],
               "checkpoint": ck["launches"], "fused": fu["launches"],
               "lenet": p9["lenet"]["launches"], "vgg16": p9["vgg16"]["train"]["launches"],
               "resnet50_transfer": p9["resnet50_transfer"]["launches"],
               "sentinel_charlstm": p10["rollback"]["launches"],
               "sentinel_resnet": p10["cost"]["launches"],
               "solvers": p10["solvers"]["launches"], "dl4j_import": p10["import"]["launches"],
               "embeddings": p11["launches"], "scale_out": p12["launches"],
               "serving": p13["charlstm_server"]["launches"],
               "serving_resnet": p13["resnet_pool"]["launches"],
               "serving_overload": p13["overload"]["launches"],
               "recsys": p14["launches"],
               "ledger_serving": p14["ledger_serving"]["launches"],
               "observability": p15["launches"], "ui": p16["launches"],
               **p17["launches"], **p18["launches"]}
    main_launches = {name: sum(c.get(name, 0) for c in by_path.values())
                     for name in rows}
    meta = {
        "lstm_step": ("deeplearning4j_tpu_torch/csrc/lstm_step.cu",
                      "deeplearning4j_tpu/ops/pallas_lstm.py:287"),
        "lstm_sequence": ("deeplearning4j_tpu_torch/csrc/lstm_sequence.cu",
                          "deeplearning4j_tpu/ops/pallas_lstm.py:133"),
        "lstm_sequence_backward": (
            "deeplearning4j_tpu_torch/csrc/lstm_sequence_bwd.cu",
            "deeplearning4j_tpu/ops/pallas_lstm.py:178"),
        "conv1x1_stats": ("deeplearning4j_tpu_torch/csrc/conv1x1_stats.cu",
                          "deeplearning4j_tpu/ops/pallas_conv_bn.py:188"),
        "conv_kxk_stats": ("deeplearning4j_tpu_torch/csrc/conv_kxk_stats.cu",
                           "deeplearning4j_tpu/ops/pallas_conv_bn.py:301"),
        "bn_apply": ("deeplearning4j_tpu_torch/csrc/bn_apply.cu",
                     "deeplearning4j_tpu/ops/pallas_conv_bn.py:416"),
        "bn_backward_reduce": ("deeplearning4j_tpu_torch/csrc/bn_backward.cu",
                               "deeplearning4j_tpu/ops/pallas_conv_bn.py:479"),
        "bn_backward_apply": ("deeplearning4j_tpu_torch/csrc/bn_backward.cu",
                              "deeplearning4j_tpu/ops/pallas_conv_bn.py:502"),
    }
    kernels = [{
        "name": name, "route": "cuda", "source": meta[name][0],
        "replaces": meta[name][1], "launches": main_launches[name],
        "launches_by_path": {p: c.get(name, 0) for p, c in by_path.items()},
        "max_abs_err": r["err_f32"], "max_abs_err_bf16": r["err_bf16"],
        "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
        "bound_by": r["bound_by"], "library_ms": r["library_ms"],
        "ms_source": r["ms_source"], "call_ms": r.get("call_ms"),
        "shape": r["shape"],
        **{k: r[k] for k in ("stats_rel_err", "unrounded_gap_min", "library_both_passes_ms",
                             "shapes", "variant", "grid_ms", "us_per_step", "err_by_variant",
                             "prologue", "sweep", "by_batch", "limits")
           if k in r},
    } for name, r in rows.items()]
    record = {"card": card, "kind": kind, "seed": args.seed,
              "kernels": kernels, "hgmma_per_kernel": hgmma, "slice": sl, "serve": sv,
              "train": tr,
              "train_resnet": rn,
              "checkpoint": ck,
              "fused": fu,
              "phase9": p9,
              "phase10": p10,
              "phase11": p11,
              "phase12": p12,
              "phase13": p13,
              "phase14": p14,
              "phase15": p15,
              "phase16": p16,
              "phase17": p17,
              "phase18": p18,
              "build": {k: v["seconds"] for k, v in info.items()},
              "ptxas": {k: v["log"] for k, v in info.items() if k not in cuda_build.SOURCES},
              "seconds": time.perf_counter() - t_start}
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(record, f, indent=2)
    print(json.dumps({"scale_out": scale_summary(p12)}))
    print(json.dumps({"serving": serving_summary(p13, card)}))
    print(json.dumps({"recsys": recsys_summary(p14, card)}))
    print(json.dumps({"observability": observability_summary(p15, card)}))
    print(json.dumps({"ui": ui_summary(p16, card)}))
    print(json.dumps({"cli_locks": cli_locks_summary(p17, card)}))
    print(json.dumps({"gaps": gaps_summary(p18, card)}))
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
