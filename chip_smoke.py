#!/usr/bin/env python3
"""On-card smoke test of lightgbm_tpu_torch, the PyTorch/CUDA port.

Run from the root of a checkout, with one CUDA GPU:

    python3 chip_smoke.py

It imports nothing of JAX and nothing of the JAX package. It builds the
port's CUDA kernels from ``lightgbm_tpu_torch/csrc`` (into ``build/``)
and runs thirty-nine phases, each of which raises on failure (phase 36
runs right after phase 4 and phase 3 after phase 36, phase 7 right
before phase 15, phases 37-39 last):

1. B1 ``build_histograms_cuda`` against its plain PyTorch version on the
   card, at the main path's shapes: the root call (10.5M rows, 42 leaf
   slots) and a compacted child call (row_gather + num_rows, ~R/2 rows,
   21 slots), with bf16-rounded f32, plain f32 and int8 gradients.
2. B2 ``fused_build_best_splits`` against its plain version at the same
   shapes (plain, monotone + path smoothing, int8-quantized), with and
   without the emitted histogram, plus a small synthetic stream with a
   NaN bin and a one-hot categorical feature.
3. Small-scale training parity: 2**16 rows x 1 tree trained on the
   card with the kernels and on the CPU with the plain path; tree
   structure and AUC. The CPU legs of this phase, of phase 7 (and of
   phase 15's and 16's card-against-CPU checks), of phase 13's L2
   parity and of phase 26's linear model run in two workers started
   as soon as the Higgs and the Covertype rows exist, beside the card
   phases (``start_early_legs``, ``start_covtype_legs``).
4. Full-scale training of the Higgs-shaped model (28 features, max_bin
   63, 255 leaves, leaf_batch 21) at 10.5M rows through the default
   training step (one CUDA-graph replay an iteration): 20 iterations
   with fused_split at its default (kernel B2), then 3 with
   fused_split=off (kernel B1); predict, and a save/load round trip with
   zero difference.
5. B3 ``build_root_histograms_classes`` (the tensor-core kernel) at the
   Covertype-shaped root (581,012 rows, 54 features, 7 classes): against
   its plain version and B1's root launch of each class (int8 exact,
   bf16-rounded and plain f32 within rtol 1e-4 of the channel scale),
   bit-identical across two launches, and the errors of the kernel, the
   plain version and B1 against a float64 sum; its plan and the M-tiles
   it issues per feature.
6. B1 and B2 at the class-batched call of the Covertype-shaped model:
   the compacted (class, row) stream of a round's smaller children over
   K x W = 147 folded slots, with row_gather and num_rows, against their
   plain versions (int8 exact, f32/bf16 within rtol 1e-4, B2's winners
   up to near ties; B2's int8 case with each class's own scales in its
   slots, [147, 2], as the quantized class-batched build passes them),
   bit-identical across two launches, and timed.
7. Multiclass parity: 2**14 Covertype-shaped rows x 1 iteration trained
   on the card class-batched, on the card per class (class_batch=off)
   and on the CPU plain path, and quantized class-batched on the card
   and on the CPU; tree structure and valid multi_logloss.
8. Full-scale multiclass training of the Covertype-shaped model (7
   classes, 255 leaves, leaf_batch 21, max_bin 255) at 581,012 rows:
   20 class-batched iterations (B3 + B2), 3 per-class iterations (B2);
   predict, and a save/load round trip with zero difference.
9. ``[step]``: the captured training step (iteration 0 eager, then the
   body captured into a CUDA graph and replayed once an iteration)
   against the eager loop (fused_train=false), in turns, at full scale:
   Higgs through B2 (5 iterations, captured / eager / eager /
   captured) and B1 (3), Higgs with bagging (bagging_fraction 0.8,
   bagging_freq 5; 6 iterations, the host draws timed apart), and
   Covertype class-batched (5, in four turns) and per class (3).
   Trees and final scores must be bit-identical and the replays'
   launch counts equal the eager loop's; each arm prints its
   training-alone ms/iteration, host syncs, peak memory, capture time
   and launches.
10. ``[quant]``: quantized training (``use_quantized_grad``) of the
    Higgs-shaped model at 10.5M rows: 20 iterations with valid AUC
    beside the float run's (``quant_auc_delta``), every B2 launch int8
    (17 a tree); then captured against eager, bit-identical, for 5
    trees after iteration 0 through B2 and through B1, and 3 with
    ``quant_train_renew_leaf``, beside a float captured arm.
11. ``[quant-mc]``: quantized class-batched training of the
    Covertype-shaped model, captured against eager (10 iterations):
    one int8 B3 launch and 16 int8 B2 launches an iteration.
12. ``[goss]``: GOSS (top_rate 0.2, other_rate 0.1, learning rate 0.1,
    so it samples from iteration 10) on the Higgs-shaped model, 14
    trees captured against eager, bit-identical across the start
    iteration (two graphs), ms/tree before and after it.
13. ``[regression]``: the YearPredictionMSD-shaped model (515,345 rows x
    90 features at the dataset's own 463,715 / 51,630 split, integer
    years 1922-2011; objective regression, 255 leaves, max_bin 255):
    20 iterations with a falling valid l2, 11 captured against eager;
    then 2 iterations of each other objective at that shape, captured
    against eager, the timed iterations under
    ``torch.cuda.set_sync_debug_mode("error")``.
14. ``[parity]`` for quantized binary (Higgs-shaped, 1 tree) and L2
    (Year-shaped, 1) at 2^16 rows: the card against the CPU, as phase 3.
15. ``[efb]``: the Covertype shape at default parameters, where EFB
    bundles the one-hot columns into 12 columns: B1 over the bundled
    matrix at the bundle lattice's bins against its plain version (the
    class-batched child call, the class-batched root of one slot a
    class over every (class, row) pair, and 256 bins with values up to
    255); 20
    class-batched iterations against phase 8's enable_bundle=false run
    (trees equal up to a near tie, multi_logloss within 1e-4 over the
    first 5 iterations, the difference after 20 reported);
    class-batched (5 iterations after iteration 0), per-class (3) and
    quantized class-batched (5) captured against eager, every histogram
    launch B1 in bundle space (no B2, no B3); card against CPU at 2^14
    rows.
16. ``[cat]``: the same rows in Covertype's own 12-column form, its
    Wilderness_Area and Soil_Type columns categorical: B3 over these
    12 columns at full rows against its plain version; class-batched,
    B3 at the root and B1 below, Soil_Type on the sorted-subset path; 20
    iterations with a falling valid multi_logloss, 5 captured against
    eager, card against CPU at 2^14 rows.
17. ``[serve]``: the predict and serving path on the card, with phase
    4's Higgs model (20 trees, 255 leaves) and phase 8's Covertype
    model (140 trees) saved to model files. On 2^14 valid rows of each,
    ``pred_leaf``, the ``CompiledEnsemble`` (f32 walk) and the session
    (plain and with ``pred_early_stop``) on the card against a
    ``device_type="cpu"`` load of the same file: leaves equal,
    ``CompiledEnsemble.predict`` bit-equal, sessions within 1e-12;
    ``pred_contrib`` local accuracy on 64 Higgs rows; ms per
    ``CompiledEnsemble.predict`` call at each rung of the server's
    ladder (16-1024 rows) and the kernels one call launches (from
    ``torch.profiler``); ``Booster.predict`` rows/s over the 2^20 Higgs
    valid rows and its peak memory. Then bench.py's serving traffic
    (``serve_bench``, ``fleet_bench``) through a ``PredictionServer`` on
    the card: 16-row npy requests, ``max_batch_rows=1024``,
    ``max_wait_us=2000``, 1/8/64 keep-alive clients with
    ``max(8, 128 // clients)`` requests each (rows/s, p99, mean batch);
    a mid-burst ``/models/swap`` to the 10-iteration model under 8
    clients x 32 requests with 0 failed and 0 mixed results; then
    ``compiled_predict=True`` with 1 and 2 replicas under 64 clients x 4
    requests. The path launches none of B1-B3 (their counts are reset
    before it and read after).
18. ``[dart]``: DART on the Higgs-shaped model at 10.5M rows (phase
    4's Dataset) at its defaults (drop_rate 0.1, skip_drop 0.5,
    max_drop 50; 10 iterations) and with ``xgboost_dart_mode`` (5),
    through the eager loop with B2 (17 launches a tree): valid AUC each
    iteration, rising; the dropped trees' replays over train and valid
    timed; predictions equal the live valid scores.
19. ``[rf]``: RF on the same Dataset (bagging 0.632 every iteration,
    feature_fraction 0.8), 3 iterations with B2: the averaged valid
    AUC above the first tree's, a save/load round trip (the
    ``average_output`` line) with zero difference, the host bagging
    draw's time.
20. ``[rank]``: the MS LTR-shaped lambdarank cell (``make_mslr_like``:
    2,270,296 rows x 137 dense features in 18,919 queries, the widest
    1,251; 1,000 valid queries): the bucket plan and its largest
    lattice temporary against the budget; the gradient's device ms; B2
    at the root and a compacted child call (F = 137, B = 255) against
    its plain version, timed, and B1 at the same two calls against its
    plain version, timed beside ``index_add_``; 20 iterations through
    the captured step
    with valid NDCG@10 rising, 17 B2 launches a tree; captured against
    eager, bit-identical, under ``torch.cuda.set_sync_debug_mode
    ("error")``: lambdarank (5 iterations), ``rank_xendcg`` and
    ``bagging_by_query`` (3 each), and B1 (``fused_split=off``, 3);
    position-bias lambdarank, 3 eager iterations with 10 position ids,
    factors finite and changing.
21. ``[parity]`` for lambdarank (~2^14 rows in the first queries, 1
    iteration), DART and RF (2^14 Higgs rows, 2): the card against
    ``device_type="cpu"``, trees equal up to a noise-level near tie,
    valid NDCG@10 / AUC within 1e-3.
22. ``[opts]``: the single-device builder options on phase 4's Dataset
    (10.5M rows + the 2^20 valid rows). B2 at the root and child calls
    with a per-slot [L, F] feature mask and intermediate monotone
    bounds against its plain version. Captured against eager,
    bit-identical, 3 iterations after iteration 0 (intermediate
    monotone 1) under
    ``torch.cuda.set_sync_debug_mode("error")``: per-node sampling 0.8
    under two interaction groups (B2, 17 a tree), extra_trees with
    feature_contri (B1, 17) and intermediate monotone on four features
    (B2, 255 a tree: one split a round). Eager, 3 trees: advanced
    monotone (B1, 255), CEGB with split, coupled and lazy costs (B1,
    17; a [10.5M, 28] paid mask) and a three-level forced-split file
    (B1, 255). Each arm's valid AUC and launches a tree; the monotone
    arms' predictions move with each constraint on a 1-D sweep. Then
    Covertype class-batched with per-node sampling and extra-trees
    (per-class keys), captured against eager: B3 1 + B1 16 an
    iteration.
23. ``[parity]`` for each ``[opts]`` arm at 2^14 Higgs rows, 1
    iteration: the card against ``device_type="cpu"``. The CPU legs of
    the Higgs parities (DART, RF and these) run in a worker process
    started right after phase 22, beside the phases that follow.
24. ``[wide]``: max_bin 1023 (int16 bin columns; LightGBM's tuning
    guide's "Use large max_bin"). B1 and B2 at the Higgs root and child
    calls (10.5M rows, 42 / 21 slots, F = 28, B = 1,021) against their
    plain versions in bf16, f32 and int8 (int8 exact, f32 within rtol
    1e-4, B2's winners equal beyond a 1e-4 gain gap), two launches
    bit-identical, timed beside ``index_add_``; B3 at the Covertype
    root the same way. The captured step against the eager loop,
    bit-identical: Higgs through B2 (5 iterations after iteration 0)
    and B1 (``fused_split=off``, 3), Covertype class-batched (3); card
    trees against CPU trees at 2^16 Higgs rows.
25. ``[wide-efb]``: 2^21 rows x 64 mutually exclusive sparse columns at
    max_bin 255 and ``max_bundle_bins=1024``: the JAX package's 16
    bundles, of 953-1,010 bins; B1 at the bundle lattice's root and
    child calls against its plain version (gradients at a mid-training
    score), timed; 5 iterations captured against eager (B1, 17 a
    tree); card against CPU at 2^16 rows.
26. ``[linear]``: the Year-shaped regression with ``linear_tree=true,
    linear_lambda=0.01``, 5 iterations through the eager loop (B2, 17
    launches a tree): a falling valid l2 below the constant-leaf run's
    after 5 iterations, a save/load round trip with zero difference;
    at 2^15 rows x 2 trees the card's trees and linear models equal the
    CPU's
    (coefficients within rtol 1e-9; a noise-level near tie may end the
    comparison early), and the CPU's linear model predicts on the card
    within 1e-12 of its host ``Tree.predict``.

27. ``[fobj]``: 5 trees on phase 4's Dataset with a custom objective
    (``fobj``) that computes the port's own Binary gradients on the card
    from the scores it is handed (the eager loop, B2 17 a tree), against
    5 trees of the built-in binary objective with
    ``boost_from_average=false`` through the captured step: trees
    bit-identical; then 2 fobj trees with ``fused_split=off`` (B1 17 a
    tree); ms/tree of the fobj arm and the captured one.
28. ``[mc-fobj]``: 2 class-batched iterations on phase 8's Covertype
    Dataset with a custom objective computing the port's softmax
    gradients on the card in the [n, K] layout, against the built-in
    multiclass objective without the average: trees bit-identical, B3
    once an iteration and B2 16 times.
29. ``[continue]``: phase 4's model file continued for 5 trees with
    ``init_model`` on a Higgs Dataset that keeps its raw rows, with
    snapshots every 2 iterations kept to 2: 25 trees, the live train
    scores within 2e-4 of ``predict``, valid AUC no lower than the base
    model's; only the snapshots of the continued run's iterations 2 and
    4 (files ``snapshot_iter_22`` and ``_24``) stay, reload with their
    tree counts, and the newer one continues. Then RF, 3 trees continued
    for 2, predicting the mean of the 5 trees within 1e-6.
30. ``[cv]``: ``cv`` with nfold 3, 5 rounds and ``early_stopping_round``
    2 on the first 2^21 Higgs rows, the fold Datasets on the card: one
    fold's trees bit-identical to ``train`` of that fold with its valid
    set, each round's means equal to the mean of the fold metrics.
31. ``[refit]``: phase 4's model refit on 2^19 valid rows on the card
    and, from its model file, on the CPU in the port: structures
    unchanged, leaf values within rtol 1e-9 of each other.

32. ``[sparse]``: the Allstate-shaped CSR (128 one-hot variables x 16
    levels = 2,048 columns, 2^20 rows, 134M nonzeros; Allstate is the
    reference's own EFB experiment, cut from 13.2M rows) built into a
    Dataset on the card from its CSC nonzeros (never densified): bins
    bit-equal to the port's CPU bins of the same CSR, at most 2 x 128
    bundles; the construction's seconds, host resident peak and device
    peak; B1 at the bundle lattice's root and child calls against its
    plain version under weighted L2 gradients (6 launches each
    bit-identical), timed beside ``index_add_``, and 11 launches each
    bit-identical under the boost-from-average gradients (one constant
    hessian); 5 regression trees
    (255 leaves, min_data_in_leaf 100, learning rate 0.1) through the
    captured step, B1 17 launches a tree.
33. ``[cli]``: the Higgs-shaped data at 2^18 rows written as a CSV with a
    header; ``python -m lightgbm_tpu_torch config=train.conf
    num_trees=5`` (bench.py's Higgs model) as a subprocess on the card,
    its model text equal to an in-process ``train`` on a Dataset of the
    same file (B2, 85 launches in 5 trees); ``task=predict`` equal to
    ``Booster.predict``; ``task=save_binary`` and 5 trees from the
    ``.bin`` equal to the CSV's; ``task=convert_model`` compiled with
    gcc, its raw scores on 1,000 rows within 1e-12 of the port's; 2
    trees from a LibSVM file of phase 32's first 2^14 rows; the parse
    rate and each task's seconds.

34. ``[ooc]``: the Higgs-shaped model (10.5M rows, max_bin 63, 255
    leaves, leaf_batch 16) out of core, 2 trees an arm: ``out_of_core=
    on`` with a 64 MiB staging budget (9 chunks of 1,196,032 rows a
    sweep through the pinned double buffer, B1 with a carried
    accumulator a chunk, never B2), its trees equal the resident
    captured run's up to a noise-level near tie (leaf values within
    1e-5 of the tree's largest); int8 without subtraction, bit-identical to the resident
    captured step at those settings (B1); ``out_of_core=auto`` under
    ``LIGHTGBM_TPU_DEVICE_MEM_GB`` at half the resident working set,
    which warns and streams. B1
    at a chunk call with ``init`` against its plain version (weighted
    L2 gradients, 6 launches bit-identical, int8 exact), timed beside
    ``index_add_``; ms a tree, host-to-device GB/s, the overlap and the
    peak device bytes against the resident run's.
35. ``[resume]``: 2^20 Higgs-shaped rows, 10 iterations through the
    captured step with ``resume=auto``, ``nan_guard=rollback`` and
    ``on_device_loss=degrade``: a subprocess signalled after iteration
    5 writes its checkpoint and exits 0 and a second run finishes it; a
    NaN at iteration 5 rolls back; a device loss at iteration 7 retries
    on the same card; each model text byte-equal to the clean run's;
    the checkpoint's bytes, write and restore ms. Then ``python -m
    lightgbm_tpu_torch ingest`` of phase 33's CSV into shards, 2 trees
    from them (chunked), their bins equal to an in-memory Dataset's of
    the CSV with the same mappers.
36. ``[telemetry]``: phase 4's model, 8 captured iterations at
    eval_period 2 with valid AUC, three times: bare; with
    ``telemetry_port=0`` and ``event_log``, /metrics and /events scraped
    at every sync point; and again with a ``/trace?duration_ms=300``
    capture asked by a helper thread once /healthz shows iteration 3.
    A fourth run, bare again, gives the bare ms/tree's spread. Each
    run's trees equal phase 4's first 8 and its host syncs the bare
    run's, B2 17 a tree; /metrics holds every family of the JAX
    package's session, ``device_hbm_bytes_peak{device="cuda:0"}`` within
    the allocator's peak, ``xla_compiles_total`` (the step's graph
    captures) 1 at the last three syncs; the log passes
    ``check_records``; the trace's summary names B2's
    ``slot_accum_kernel`` and ``split_epilogue_kernel`` with device ms;
    the server is gone after ``train``. Then 3 eager ``fused_split=off``
    iterations (B1 17 a tree) whose log holds the four training phases.
    Prints ms/tree with and without telemetry, the trace window's busy
    share and a /trace call's seconds.
37. ``[parallel]`` (last): the Higgs-shaped model as the two ranks of
    one torch.distributed group on the one card (gloo), started by
    ``python -m lightgbm_tpu_torch.launch -n 2``, each rank holding its
    block of the 10.5M rows (all of them for the feature learner),
    ``boost_from_average=false``, 2 eager trees an arm: quantized data
    at both merges, float data at both, feature, voting at ``top_k``
    20 and 5. Both ranks' models equal; the quantized arms byte-equal
    to a serial eager ``fused_split=off`` run in this process, float
    reduce-scatter to allreduce, feature to the serial float run, voting
    20 the data plan's trees (leaves within 1e-5), voting 5's AUC within
    0.01 of serial; B1 17 launches a tree a rank, B2 and B3 none; B1 at
    a rank's root call (5.25M rows) against its plain version, timed.
    Then, on the same group, the rest of the combinations, quantized,
    each byte-equal to its serial eager run: GOSS, DART and RF (3
    trees), a custom objective (it must see the rank's own rows) and
    ``init_model`` from phase 4's model file (2); lambdarank with
    ``bagging_by_query`` on the MS LTR cell, each rank holding its block
    of the queries (``pre_partition=true``, 3 iterations, the gathered
    NDCG@10 the serial run's); and an elastic cell: the ranks checkpoint
    at iteration 2 of 4, this process resumes serially on the card from
    that directory and must end with the serial run's 4 trees and a
    ``reshard`` record. B1 at a rank's MS LTR root call (~1.135M rows,
    F = 137) against its plain version, timed. The serial references
    run while the ranks set up. Prints each arm's ms/tree beside the
    serial eager one, its collectives and bytes a tree by kind, the
    host staging and each arm's seconds.
38. ``[doctor]``: the trace doctor (``lightgbm_tpu_torch/analysis``) on
    the card. First, alone on the card, phase 4's Higgs booster at full
    width: its step body once more under the op recorder and
    ``set_sync_debug_mode("error")`` with no host sync, one build span
    and two deferred flags, its launches those its graph recorded; and
    20 further iterations under ``CaptureGuard(max_captures=0)``: no
    capture, B2 17 an iteration, their ms timed. Then ``run_doctor``
    over its seven canonical configs (serial), every target clean but
    TD007 on B2, a warning (the port's B2 passes its lattice through
    HBM, ROADMAP B.5) whose negative control, the two-pass arm, must
    show the lattice.
39. ``[chaos]``: ``scripts/torch_chaos_train.py --cell fused/serial
    --kills 5`` and ``--elastic --cell elastic/4ar-serial1`` on the card,
    started together with phase 38's canonical configs (kill, corrupt,
    poison and splice flows; a 4-rank world killed and resumed
    serially): both exit 0.
    Prints the checks passed, each run's seconds and the launches of
    its finished children.

The kernels' launch counts in the JSON line come from phases 4, 8, 10,
11 and 15, which run the captured step: a replay adds the launches its
capture recorded; B1's ``bundle_*`` fields are its bundle-space call
and launches (phase 15). ``launches_int8`` counts the launches made with int8
gradients (quantized training) and ``ms_int8`` times the kernel at its
quantized call. ``launches_rank``, ``launches_dart`` and
``launches_rf`` are the launches of phases 20, 18 and 19, each run
named beside them; B1's and B2's ``rank_*`` fields are their MS
LTR-shaped calls (phase 20). ``launches_opts`` are the launches of the
phase 22 arms, each by name. ``launches_wide`` are the launches of the
runs of phases 24-26, by name; the ``wide_*`` fields are each kernel's
phase 24 calls, and B1's ``wide_efb_*`` its phase 25 root call.
``launches_a6a`` are the launches of the runs of phases 27-30, by name,
and ``launches_a6b`` those of phases 32 and 33; B1's ``sparse_*`` fields
are its phase 32 calls. ``launches_a7`` are the launches of the runs of
phases 34 and 35, by name, and B1's ``ooc_*`` fields its phase 34 chunk
call. ``launches_telemetry`` are the launches of phase 36's traced run
and its eager arm; ``launches_parallel`` the launches a tree of rank 0
in each phase 37 arm, and B1's ``parallel_*`` and ``parallel_rank_*``
fields its Higgs and MS LTR calls there. ``launches_doctor`` are phase
38's (the recorded Higgs step body, the 20 steady iterations, the
fused-split target's two arms) and ``launches_chaos`` phase 39's.
Each phase's start time is printed on a ``[time]`` line.

Output: per-phase lines, then the card's name and power limit, then one
JSON line with every kernel's launches, error and times, and last
``{"ok": true, "device": {...}}``. Exits non-zero, printing no result,
when no CUDA device is visible or the port is not beside the script.
"""

import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12       # H100 SXM HBM3 (NVIDIA data sheet)
F32_FLOPS = 67e12               # H100 SXM f32 outside the tensor cores
BF16_TC_FLOPS = 989e12          # H100 SXM dense bf16 tensor cores

HIGGS_ROWS = 10_500_000
VALID_ROWS = 1 << 20
PARAMS = dict(objective="binary", metric="auc", num_leaves=255,
              learning_rate=0.1, max_bin=63, leaf_batch=21,
              min_data_in_leaf=100, verbosity=-1)

# Covertype (UCI; the covtype dataset of NVIDIA's gbm-bench): 581,012
# rows x 54 features, 7 classes. The earlier phases train it with
# enable_bundle=false, the path on which B2 and B3 run; [efb] trains the
# default, where EFB bundles the 44 one-hot columns, and [cat] the
# dataset's own 12-column form with its two categorical columns.
COVTYPE_ROWS = 581_012
COVTYPE_VALID = 1 << 17
NUM_CLASS = 7
COVTYPE_PRIORS = (0.365, 0.488, 0.062, 0.005, 0.016, 0.030, 0.035)
MC_PARAMS = dict(objective="multiclass", num_class=NUM_CLASS,
                 metric="multi_logloss", num_leaves=255, leaf_batch=21,
                 learning_rate=0.1, max_bin=255, min_data_in_leaf=20,
                 enable_bundle=False, verbosity=-1)
QUANT = dict(use_quantized_grad=True)
# Covertype at default parameters: EFB on (the JAX package's default)
EFB_PARAMS = {k: v for k, v in MC_PARAMS.items() if k != "enable_bundle"}
# covtype.info: Wilderness_Area (4) and Soil_Type (40) are qualitative
CAT_COLUMNS = [10, 11]
# GOSS with learning rate 0.1: it samples from iteration int(1/0.1) = 10
GOSS = dict(data_sample_strategy="goss", top_rate=0.2, other_rate=0.1)

# YearPredictionMSD (UCI; the year dataset of NVIDIA's gbm-bench):
# 515,345 rows x 90 continuous features, split at the dataset's own
# 463,715 train / 51,630 test rows; the label is a year in 1922-2011.
YEAR_ROWS = 515_345
YEAR_TRAIN = 463_715
YEAR_PARAMS = dict(objective="regression", metric="l2", num_leaves=255,
                   leaf_batch=21, learning_rate=0.1, max_bin=255,
                   min_data_in_leaf=20, verbosity=-1)
OTHER_OBJECTIVES = ("regression_l1", "huber", "fair", "poisson", "quantile",
                    "mape", "gamma", "tweedie", "cross_entropy",
                    "cross_entropy_lambda")

# MS LTR (MSLR-WEB30K, the ranking task of LightGBM's published
# comparison, docs/Experiments.rst): 2,270,296 rows x 137 dense
# continuous features in 18,919 queries of up to 1,251 documents,
# relevance labels 0-4. The parameters are the other cells' with
# LightGBM's ranking defaults (truncation 30, lambdarank_norm, label
# gain 2^i - 1).
MSLR_ROWS = 2_270_296
MSLR_QUERIES = 18_919
MSLR_VALID_QUERIES = 1_000
MSLR_FEATURES = 137
MSLR_MAX_QUERY = 1_251
RANK_PARAMS = dict(objective="lambdarank", metric="ndcg", eval_at=[10],
                   num_leaves=255, leaf_batch=21, learning_rate=0.1,
                   max_bin=255, min_data_in_leaf=20, verbosity=-1)
# DART at its defaults (drop_rate 0.1, skip_drop 0.5, max_drop 50) and
# RF with bagging, on the Higgs-shaped model
DART_PARAMS = dict(PARAMS, boosting="dart")
# their iterations: 10 and 5, cut from 20 and 10 to fit the script's
# time limit
DART_ITERS = 10
RF_ITERS = 3
RF_PARAMS = dict(PARAMS, boosting="rf", bagging_freq=1,
                 bagging_fraction=0.632, feature_fraction=0.8)
# the mode and [opts] parities' rows, cut from 2^15 for the time limit
MODE_PARITY_ROWS = 1 << 14
# Wide bins: LightGBM's tuning guide's first lever for accuracy ("Use
# large max_bin", docs/Parameters-Tuning.rst) at 1023, on the Higgs and
# Covertype shapes; EFB bundles of up to 1,024 bins over mutually
# exclusive sparse columns; linear trees on the Year shape.
WIDE_BINS = 1023
SPARSE_ROWS = 1 << 21
SPARSE_COLS = 64
SPARSE_PARAMS = dict(PARAMS, max_bin=255, max_bundle_bins=1024)
# the bundles the JAX package forms from make_sparse_like(SPARSE_ROWS) at
# SPARSE_PARAMS (lightgbm_tpu.Dataset(...).construct().bundle_plan on the
# CPU: 16 bundles of 953-1,010 bins); tests/test_torch_wide_bins.py
# holds the port's plan of the same generator to the JAX package's
SPARSE_JAX_BUNDLES = 16
LINEAR_PARAMS = dict(YEAR_PARAMS, linear_tree=True, linear_lambda=0.01)
# Allstate (the reference's own EFB experiment, docs/Experiments.rst):
# 13.2M rows of one-hot categorical variables, here 128 variables x 16
# levels (2,048 columns), cut to 2^20 rows; regression at the Higgs
# cell's tree settings
ALLSTATE_ROWS = 1 << 20
ALLSTATE_VARS = 128
ALLSTATE_LEVELS = 16
SPARSE_ALLSTATE_PARAMS = dict(objective="regression", metric="l2",
                              num_leaves=255, leaf_batch=21,
                              learning_rate=0.1, max_bin=63,
                              min_data_in_leaf=100, verbosity=-1)
# the CLI's train.conf: bench.py's Higgs model
CLI_PARAMS = dict(PARAMS)
# [cli]'s CSV (2^18) and [refit]'s rows (2^17), cut from 2^20 to keep
# the script inside its time limit; the CPU parse and the CPU refit take
# most of those phases
CLI_ROWS = 1 << 18
REFIT_ROWS = 1 << 17
# the card-against-CPU parities: 2^16 rows, and 2^14 for the multiclass
# ones (cut from 2^17 and 2^16 for the time limit); their CPU legs are
# most of each phase's time
SMALL_PARITY_ROWS = 1 << 16
MC_PARITY_ROWS = 1 << 14
# the [cli] LibSVM train's rows of [sparse]'s CSR (cut from 2^16)
LIBSVM_ROWS = 1 << 14
C_MAIN = r"""
#include <stdio.h>
#include <stdlib.h>
int main(int argc, char** argv) {
  int nf = atoi(argv[1]), j;
  double* f = malloc(sizeof(double) * nf);
  double out[NUM_CLASS];
  for (;;) {
    for (j = 0; j < nf; ++j)
      if (scanf("%lf", f + j) != 1) return 0;
    PredictRaw(f, out);
    printf("%.17g\n", out[0]);
  }
}
"""


def log(msg):
    print(msg, flush=True)


def make_higgs_like(n_rows, n_feat=28, seed=7):
    """Higgs-shaped synthetic data (a copy of bench.py's generator):
    dense floats, a nonlinear decision surface, balanced classes."""
    import numpy as np
    rng = np.random.RandomState(seed)
    X = rng.normal(size=(n_rows, n_feat)).astype(np.float32)
    w = rng.normal(size=n_feat) / np.sqrt(n_feat)
    logit = (X @ w + 0.7 * X[:, 0] * X[:, 1]
             - 0.4 * X[:, 2] ** 2 + 0.3 * np.abs(X[:, 3]))
    y = (logit + rng.logistic(size=n_rows) * 0.5 > 0).astype(np.float32)
    return X, y


def make_covtype_like(n_rows, seed=11):
    """Covertype-shaped synthetic data: 10 integer quantitative columns
    at the real ranges (elevation, aspect, slope, four distances, three
    hillshades), 4 one-hot wilderness areas and 40 one-hot soil types;
    7 classes from a nonlinear surface (elevation bands, aspect, area
    and soil affinities), biased to Covertype's class shares."""
    import numpy as np
    rng = np.random.RandomState(seed)
    n = n_rows
    q = np.stack([
        rng.normal(2960, 280, n).clip(1859, 3858),      # elevation
        rng.uniform(0, 360, n),                          # aspect
        rng.gamma(3.0, 4.7, n).clip(0, 66),              # slope
        rng.exponential(270, n).clip(0, 1397),           # hydrology h
        rng.normal(46, 58, n).clip(-173, 601),           # hydrology v
        rng.exponential(2350, n).clip(0, 7117),          # roadways
        rng.normal(212, 27, n).clip(0, 254),             # hillshade 9am
        rng.normal(223, 20, n).clip(0, 254),             # hillshade noon
        rng.normal(142, 38, n).clip(0, 254),             # hillshade 3pm
        rng.exponential(1980, n).clip(0, 7173),          # fire points
    ], 1).round()
    wild = rng.choice(4, n, p=[0.45, 0.05, 0.44, 0.06])
    z = (q[:, 0] - 2960) / 280
    soil_p = rng.dirichlet(np.full(40, 0.5))
    soil = (rng.choice(40, n, p=soil_p) + (z > 1).astype(int) * 7) % 40
    X = np.zeros((n, 54), np.float32)
    X[:, :10] = q
    X[np.arange(n), 10 + wild] = 1
    X[np.arange(n), 14 + soil] = 1
    K = NUM_CLASS
    centre = np.linspace(-1.8, 1.8, K)
    aff_w = rng.normal(size=(4, K))
    aff_s = rng.normal(scale=0.8, size=(40, K))
    logits = (-1.5 * (z[:, None] - centre[None, :]) ** 2
              + 0.4 * np.sin(np.deg2rad(q[:, 1]))[:, None] * rng.normal(size=K)
              + 0.3 * (q[:, 2] / 20)[:, None] * rng.normal(size=K)
              - 0.2 * (q[:, 5] / 2350)[:, None] * rng.normal(size=K)
              + aff_w[wild] + aff_s[soil])
    logits += rng.gumbel(size=(n, K))
    target = np.asarray(COVTYPE_PRIORS) / sum(COVTYPE_PRIORS)
    bias = np.zeros(K)
    for _ in range(40):                   # match the class shares
        share = np.bincount((logits + bias).argmax(1), minlength=K) / n
        bias += 0.7 * np.log(target / np.maximum(share, 1e-6))
    y = (logits + bias).argmax(1).astype(np.float32)
    return X, y


def make_sparse_like(n_rows, n_cols=SPARSE_COLS, seed=19):
    """Mutually exclusive sparse float columns, as the bundling data of
    tests/test_torch_binning.py at scale: each row has one non-zero
    column, drawn at random, holding a normal value; a binary label from
    that value times its column's weight, with logistic noise."""
    import numpy as np
    rng = np.random.RandomState(seed)
    col = rng.randint(0, n_cols, n_rows)
    val = rng.normal(size=n_rows).astype(np.float32)
    X = np.zeros((n_rows, n_cols), np.float32)
    X[np.arange(n_rows), col] = val
    w = rng.normal(size=n_cols)
    y = (w[col] * val + 0.5 * rng.logistic(size=n_rows) > 0) \
        .astype(np.float32)
    return X, y


def make_year_like(n_rows, seed=13):
    """YearPredictionMSD-shaped synthetic data: 90 continuous columns
    (12 timbre means and 78 timbre covariances in the real file, on
    scales from ones to thousands, correlated through a few shared
    factors) and an integer year label in 1922-2011 from a nonlinear
    surface, skewed toward the 2000s as the real labels are (median
    ~2002, a long tail back to the 1920s)."""
    import numpy as np
    rng = np.random.RandomState(seed)
    F = 90
    scale = np.concatenate([rng.uniform(5, 50, 12),
                            rng.uniform(10, 3000, F - 12)]).astype(np.float32)
    z = rng.standard_normal((n_rows, F)).astype(np.float32)
    fac = rng.standard_normal((n_rows, 6)).astype(np.float32)
    X = (z + fac @ (rng.normal(size=(6, F)).astype(np.float32) * 0.6)) * scale
    w = (rng.normal(size=F) / np.sqrt(F)).astype(np.float32)
    t = z @ w + 0.5 * np.tanh(fac[:, 0] * fac[:, 1]) + 0.3 * z[:, 0] * z[:, 1]
    t = (t - t.mean()) / t.std()
    back = np.exp(2.2 + 0.8 * (0.8 * t + 0.6 * rng.standard_normal(n_rows)))
    y = np.clip(np.round(2011 - back), 1922, 2011).astype(np.float32)
    return X, y


def year_label(y, objective):
    """The Year label in each objective's domain: positive for the log
    links, in [0, 1] for the cross-entropies, centred for fair (which
    has no init score: from 0, every residual of ~2000 would sit in
    Fair's flat tail), the year itself else."""
    if objective in ("poisson", "gamma", "tweedie"):
        return (y - 1921.0) / 10.0
    if objective.startswith("cross_entropy"):
        return (y - 1922.0) / 89.0
    if objective == "fair":
        return y - 1998.0
    return y


def reset_peak():
    """Start a peak-memory window; returns the bytes allocated at its
    start, so a run's peak is reported above what was already live."""
    import torch
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    return torch.cuda.memory_allocated()


def cuda_ms(fn, reps, warmup=1):
    """Mean device time of ``fn`` over ``reps`` launches (CUDA events)."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    s = torch.cuda.Event(enable_timing=True)
    e = torch.cuda.Event(enable_timing=True)
    s.record()
    for _ in range(reps):
        fn()
    e.record()
    torch.cuda.synchronize()
    return s.elapsed_time(e) / reps


def check_close(name, got, want, rtol):
    """|got - want| <= rtol * (|want| + max|want| of the channel): the
    f32 sums run over millions of addends in another order, and the
    gradient channel cancels, so the error is measured against the
    channel's scale."""
    import torch
    g, w = got.double(), want.double()
    scale = w.abs().amax(dim=tuple(range(w.dim() - 1)), keepdim=True)
    err = (g - w).abs()
    bad = err > rtol * (w.abs() + scale)
    if bool(bad.any()):
        raise AssertionError(f"{name}: {int(bad.sum())} cells outside "
                             f"rtol {rtol}; max abs err "
                             f"{float(err.max()):.3g}")
    return float(err.max())


def gradients(y_dev):
    """Binary gradients at the boost-from-average init score."""
    import torch
    p = y_dev.mean()
    g = p - y_dev
    h = torch.full_like(y_dev, float(p * (1 - p)))
    return g, h


def quantize(g, h):
    """int8 grid values and their (g_scale, h_scale), 4 gradient bins."""
    import torch
    gs = g.abs().max() / 2
    hs = h.abs().max() / 4
    qg = torch.round(g / gs).clamp(-2, 2).to(torch.int8)
    qh = torch.round(h / hs).clamp(0, 4).to(torch.int8)
    return qg, qh, torch.stack([gs, hs]).to(torch.float32)


def compact(row_leaf, small_ids, R):
    """The tree builder's compacted stream of the rows in small_ids."""
    import torch
    dev = row_leaf.device
    m = torch.isin(row_leaf, small_ids)
    mi = m.to(torch.int32)
    pos = torch.cumsum(mi, 0, dtype=torch.int32) - 1
    n = mi.sum(dtype=torch.int32)
    c_idx = torch.zeros(R + 1, dtype=torch.int32, device=dev)
    c_idx.scatter_(0, torch.where(m, pos, R).long(),
                   torch.arange(R, dtype=torch.int32, device=dev))
    c_idx = c_idx[:R]
    rl_c = torch.where(torch.arange(R, device=dev) < n,
                       row_leaf[c_idx.long()], -1).to(torch.int32)
    return c_idx, rl_c, n


def bound_of(nbytes, ops):
    """The least time for the work (ms) and what sets it: bytes over the
    HBM rate or f32 operations over the f32 peak."""
    t_b, t_o = nbytes / HBM_BYTES_PER_S, ops / F32_FLOPS
    return max(t_b, t_o) * 1e3, "bytes" if t_b >= t_o else "operations"


def hist_bytes(rows, F, gh_bytes, gather, L, B, bin_bytes=1):
    per_row = F * bin_bytes + gh_bytes + 4 + (4 if gather else 0)
    return rows * per_row + L * 4 + L * F * B * 3 * 4


def index_add_ms(bins, gh, rl, ids, B, n_live, row_gather=None):
    """The library call for B1's scatter: one index_add_ over
    precomputed flat (slot, feature, bin) indices and bf16-rounded
    addends of the stream's live prefix; its time by CUDA events."""
    import torch
    dev = bins.device
    R, F, L = gh.shape[0], bins.shape[1], ids.shape[0]
    eq = rl[:, None] == ids[None, :]
    live = torch.arange(R, device=dev) < n_live
    slot = torch.where(eq.any(1) & live, eq.to(torch.uint8).argmax(1), L)
    del eq
    bb = bins[row_gather.long()] if row_gather is not None else bins[:R]
    flat = ((slot[:, None] * F + torch.arange(F, device=dev)) * B
            + bb.long()).reshape(-1)
    del bb, slot
    vals = gh.to(torch.bfloat16).float()[:, None, :] \
        .expand(R, F, 3).reshape(-1, 3)
    acc = torch.zeros(((L + 1) * F * B, 3), device=dev)
    ms = cuda_ms(lambda: acc.index_add_(0, flat, vals), 3)
    del flat, vals, acc
    torch.cuda.empty_cache()
    return ms


def mid_gradients(y_dev):
    """Binary gradients at a mid-training score: the boost-from-average
    logit plus N(0, 0.5) a row, so that g and h vary from row to row.
    A bin of millions of rows at the init score sums one constant
    hessian, and the plain version's 65,536-row f32 chains drift from
    the exact sum (by ~1 in a bundle's default bin of 2M rows)."""
    import torch
    gen = torch.Generator(device=y_dev.device).manual_seed(3)
    p0 = y_dev.mean()
    s = torch.log(p0 / (1 - p0)) + 0.5 * torch.randn(
        y_dev.shape, generator=gen, device=y_dev.device)
    p = torch.sigmoid(s)
    return p - y_dev, p * (1 - p)


def weighted_l2_gradients(y_dev):
    """Weighted L2 regression gradients at a mid-training score: the
    label's mean plus N(0, 0.5) a row, and a row weight w in [0.5, 1.5)
    (g = w (score - y), h = w), so that the g and h sums both depend on
    their order. At one constant hessian (the boost-from-average
    gradients of a regression label) the plain version's long f32
    chains drift from the exact sum by ~3e-4 of it at 65,536 rows."""
    import torch
    gen = torch.Generator(device=y_dev.device).manual_seed(3)
    s = y_dev.mean() + 0.5 * torch.randn(y_dev.shape, generator=gen,
                                         device=y_dev.device)
    w = 0.5 + torch.rand(y_dev.shape, generator=gen, device=y_dev.device)
    return w * (s - y_dev), w


def b1_repeats(ds, y_dev, CH, B, grads, reps, tag):
    """B1 at the root and child calls, bf16 and f32, launched 1 +
    ``reps`` times, each launch bit-identical to the first (no plain
    version: ``grads`` may be one the plain version sums with drift)."""
    import torch
    gh_f, _, rl0, root_ids, c_idx, rl_c, n_small, small = \
        higgs_streams(ds, y_dev, grads)
    calls = (("root", (ds.bins, gh_f, rl0, root_ids), {}),
             ("child", (ds.bins, gh_f[c_idx.long()].contiguous(), rl_c,
                        small), dict(row_gather=c_idx, num_rows=n_small)))
    for cname, args, kw in calls:
        for hd in ("bfloat16", "float32"):
            k = CH.build_histograms_cuda(*args, num_bins=B, hist_dtype=hd,
                                         **kw)
            for _ in range(reps):
                if not torch.equal(k, CH.build_histograms_cuda(
                        *args, num_bins=B, hist_dtype=hd, **kw)):
                    raise AssertionError(f"{tag}B1 {cname} {hd}: launches "
                                         f"differ under {grads.__name__}")
    log(f"{tag}[B1] root and child, bf16 and f32, under "
        f"{grads.__name__}: {1 + reps} launches each bit-identical")


def higgs_streams(ds, y_dev, grads=gradients):
    """The Higgs-shaped calls of B1/B2 on the main path: the root (2W
    slots, slot 0 live, gradients at the boost-from-average score, or
    from ``grads``) and a compacted child call (every row in one of 2W
    leaves at random, leaves 0..W-1 the smaller children, row_gather +
    num_rows)."""
    import torch
    dev = ds.bins.device
    R = ds.bins.shape[0]
    g, h = grads(y_dev)
    cnt = torch.ones_like(g)
    gh_f = torch.stack([g, h, cnt], 1).contiguous()
    qg, qh, _ = quantize(g, h)
    gh_q = torch.stack([qg, qh, cnt.to(torch.int8)], 1).contiguous()
    W = PARAMS["leaf_batch"]
    root_ids = torch.full((2 * W,), -2, dtype=torch.int32, device=dev)
    root_ids[0] = 0
    rl0 = torch.zeros(R, dtype=torch.int32, device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    rl = torch.randint(0, 2 * W, (R,), generator=gen, device=dev,
                       dtype=torch.int32)
    small = torch.arange(W, dtype=torch.int32, device=dev)
    c_idx, rl_c, n_small = compact(rl, small, R)
    return gh_f, gh_q, rl0, root_ids, c_idx, rl_c, n_small, small


def phase_b1(ds, y_dev, CH, H, results, tag="", B=None, grads=gradients,
             reps=1):
    """B1 at the Higgs root and child calls against its plain version,
    bit-identical across 1 + ``reps`` launches, and timed; ``tag``
    prefixes the lines (the [wide] phases run it over int16 bins),
    ``B`` replaces the dataset's bin count (a bundle lattice's) and
    ``grads`` the gradients."""
    import torch
    bins = ds.bins
    R, F = bins.shape
    B = B or ds.max_num_bin
    bb = bins.element_size()
    streams = higgs_streams(ds, y_dev, grads)
    gh_f, gh_q, rl0, root_ids, c_idx, rl_c, n_small, small = streams
    n_small_host = int(n_small)
    out = {}
    for label, gh, hd in (("bf16", gh_f, "bfloat16"),
                          ("f32", gh_f, "float32"),
                          ("int8", gh_q, "bfloat16")):
        gh_c = gh[c_idx.long()].contiguous()
        calls = {
            "root": dict(args=(bins, gh, rl0, root_ids), kw={}),
            "child": dict(args=(bins, gh_c, rl_c, small),
                          kw=dict(row_gather=c_idx, num_rows=n_small)),
        }
        for cname, c in calls.items():
            k = CH.build_histograms_cuda(*c["args"], num_bins=B,
                                         hist_dtype=hd, **c["kw"])
            for _ in range(reps):
                k2 = CH.build_histograms_cuda(*c["args"], num_bins=B,
                                              hist_dtype=hd, **c["kw"])
                if not torch.equal(k, k2):
                    raise AssertionError(f"B1 {cname} {label}: two launches "
                                         "differ (summation order must be "
                                         "fixed)")
            p = H.build_histograms(*c["args"], num_bins=B, hist_dtype=hd,
                                   **c["kw"])
            torch.cuda.synchronize()
            if label == "int8":
                if not torch.equal(k, p):
                    raise AssertionError(f"B1 {cname} int8 not exact")
                err = 0.0
            else:
                err = check_close(f"B1 {cname} {label}", k, p, 1e-4)
            log(f"{tag}[B1] {cname:5s} {label:4s} "
                f"L={c['args'][3].shape[0]} max_abs_err={err:.3g} "
                f"deterministic=True ({1 + reps} launches)")
            out[(cname, label)] = err
    # times at the main path's dtype (bf16-rounded f32 gradients)
    rows = {"root": R, "child": n_small_host}
    for cname, args, kw in (
            ("root", (bins, gh_f, rl0, root_ids), {}),
            ("child", (bins, gh_f[c_idx.long()].contiguous(), rl_c, small),
             dict(row_gather=c_idx, num_rows=n_small))):
        L = args[3].shape[0]
        ms = cuda_ms(lambda: CH.build_histograms_cuda(
            *args, num_bins=B, hist_dtype="bfloat16", **kw), 10)
        plain_ms = cuda_ms(lambda: H.build_histograms(
            *args, num_bins=B, hist_dtype="bfloat16", **kw), 2)
        lib_ms = index_add_ms(bins, *args[1:], B, rows[cname],
                              kw.get("row_gather"))
        bound, by = bound_of(hist_bytes(rows[cname], F, 12,
                                        cname == "child", L, B, bb),
                             3 * rows[cname] * F)
        log(f"{tag}[B1] {cname:5s} rows={rows[cname]} L={L} F={F} B={B}: "
            f"{ms:.3f} ms (bound {bound:.3f} ms by {by}; plain "
            f"{plain_ms:.3f} ms; index_add_ {lib_ms:.3f} ms)")
        results["B1"][cname] = dict(ms=ms, plain_ms=plain_ms,
                                    library_ms=lib_ms, bound_ms=bound,
                                    bound_by=by, rows=rows[cname], L=L)
    # times at the quantized call: int8 gh (3 bytes a row), int32 sums
    for cname, args, kw in (
            ("root", (bins, gh_q, rl0, root_ids), {}),
            ("child", (bins, gh_q[c_idx.long()].contiguous(), rl_c, small),
             dict(row_gather=c_idx, num_rows=n_small))):
        L = args[3].shape[0]
        ms8 = cuda_ms(lambda: CH.build_histograms_cuda(
            *args, num_bins=B, **kw), 10)
        bound8, by8 = bound_of(hist_bytes(rows[cname], F, 3,
                                          cname == "child", L, B, bb),
                               3 * rows[cname] * F)
        log(f"{tag}[B1] {cname:5s} int8 rows={rows[cname]} L={L}: {ms8:.3f} ms "
            f"(int8 bound {bound8:.3f} ms by {by8})")
        results["B1"][cname].update(ms_int8=ms8, bound_int8_ms=bound8)
    results["B1"]["max_abs_err"] = max(out[("root", "bf16")],
                                       out[("child", "bf16")])
    return streams


def compare_best(name, got, want, rtol=1e-4):
    """Winner fields equal wherever the gain gap is above ``rtol``
    relative; gains and sums within ``rtol`` of their scale. A net gain
    is a difference of G^2/H terms, so its scale is |gain| plus the
    children's G^2/H, from the plain version's winner."""
    import torch
    gk, gp = got["gain"].double(), want["gain"].double()
    fin = torch.isfinite(gp)
    if not torch.equal(torch.isfinite(gk), fin):
        raise AssertionError(f"{name}: splittable slots differ")
    key_k = torch.stack([got["feature"].long(), got["threshold"].long(),
                         got["default_left"].long()], 1)
    key_p = torch.stack([want["feature"].long(), want["threshold"].long(),
                         want["default_left"].long()], 1)
    same = (key_k == key_p).all(1)
    ls, rs = want["left_sum"].double(), want["right_sum"].double()
    scale = (gp.abs() + ls[:, 0] ** 2 / ls[:, 1].abs().clamp(min=1e-12)
             + rs[:, 0] ** 2 / rs[:, 1].abs().clamp(min=1e-12))
    gap_ok = (gk - gp).abs() <= rtol * scale
    if bool((fin & ~same & ~gap_ok).any()):
        raise AssertionError(f"{name}: winners differ beyond a near tie")
    if bool((fin & ~gap_ok).any()):
        raise AssertionError(f"{name}: gains differ beyond rtol {rtol}")
    n_flip = int((fin & ~same).sum())
    err = float((gk - gp)[fin].abs().max()) if bool(fin.any()) else 0.0
    rows = fin & same
    for k in ("left_sum", "right_sum"):
        if bool(rows.any()):
            check_close(f"{name} {k}", got[k][rows], want[k][rows], rtol)
    return err, n_flip


def phase_b2(ds, CH, SP, streams, results, y_dev, tag=""):
    """B2 at the Higgs root and child calls against its plain version
    (plain, monotone + smoothing, int8), bit-identical across two
    launches, and timed; ``tag`` prefixes the lines."""
    import numpy as np
    import torch
    gh_f, gh_q, rl0, root_ids, c_idx, rl_c, n_small, small = streams
    bins = ds.bins
    dev = bins.device
    R, F = bins.shape
    B = ds.max_num_bin
    bb = bins.element_size()
    meta = dict(
        num_bins_pf=torch.from_numpy(ds.per_feature_num_bins()).to(dev),
        nan_bin_pf=torch.from_numpy(ds.per_feature_nan_bins()).to(dev),
        is_cat_pf=torch.from_numpy(ds.per_feature_is_categorical()).to(dev))
    _, _, qs = quantize(*gradients(y_dev))
    errs = []
    rng = np.random.RandomState(1)
    for cfgn in ("plain", "mono_smooth", "quant"):
        extra = ({"path_smooth": 2.0, "monotone_penalty": 0.5}
                 if cfgn == "mono_smooth" else {})
        sp = SP.SplitParams(min_data_in_leaf=100.0,
                            min_sum_hessian_in_leaf=1e-3, **extra)
        gh = gh_q if cfgn == "quant" else gh_f
        for cname, ids, rl, kw in (
                ("root", root_ids, rl0, {}),
                ("child", small, rl_c,
                 dict(row_gather=c_idx, num_rows=n_small))):
            L = ids.shape[0]
            ghs = gh if cname == "root" else gh[c_idx.long()].contiguous()
            fk = dict(meta, feature_mask=torch.ones(F, dtype=torch.bool,
                                                    device=dev))
            if cfgn == "mono_smooth":
                mono = np.zeros(F, np.int32)
                mono[0], mono[3] = 1, -1
                depth = torch.from_numpy(
                    rng.randint(1, 6, size=L).astype(np.int32)).to(dev)
                fk.update(
                    mono_type=torch.from_numpy(mono).to(dev),
                    leaf_lo=torch.full((L,), -2.0, device=dev),
                    leaf_hi=torch.full((L,), 2.0, device=dev),
                    parent_output=torch.from_numpy(rng.normal(
                        size=L).astype(np.float32) * 0.1).to(dev),
                    mono_pen=SP.monotone_penalty_factor(depth, 0.5))
            if cfgn == "quant":
                fk["quant_scales"] = qs
            for emit in (True, False):
                bk, hk = CH.fused_build_best_splits(
                    bins, ghs, rl, ids, num_bins=B, params=sp,
                    emit_hist=emit, **kw, **fk)
                bp, hp = CH.fused_build_best_splits_plain(
                    bins, ghs, rl, ids, num_bins=B, params=sp,
                    emit_hist=emit, **kw, **fk)
                if emit:
                    bk2, hk2 = CH.fused_build_best_splits(
                        bins, ghs, rl, ids, num_bins=B, params=sp,
                        emit_hist=True, **kw, **fk)
                    if not (torch.equal(hk, hk2) and all(
                            torch.equal(bk[k], bk2[k]) for k in bk)):
                        raise AssertionError(f"B2 {cfgn} {cname}: two "
                                             "launches differ")
                    del bk2, hk2
                torch.cuda.synchronize()
                err, flips = compare_best(f"B2 {cfgn} {cname}", bk, bp)
                if emit:
                    if cfgn == "quant":
                        if not torch.equal(hk, hp):
                            raise AssertionError("B2 int8 hist not exact")
                    else:
                        check_close(f"B2 {cfgn} {cname} hist", hk, hp, 1e-4)
                log(f"{tag}[B2] {cname:5s} {cfgn:11s} emit_hist={emit!s:5s} "
                    f"gain max_abs_err={err:.3g} near-tie flips={flips}")
                if cfgn != "quant":
                    errs.append(err)
    # a small synthetic stream: NaN bin, one-hot categorical, all configs
    small_errs = phase_b2_synthetic(CH, SP, dev)
    log(f"{tag}[B2] synthetic NaN/categorical stream: max gain err "
        f"{max(small_errs):.3g}")
    # times at the main path's call (plain config, emitted histogram)
    sp = SP.SplitParams(min_data_in_leaf=100.0)
    fk = dict(meta, feature_mask=torch.ones(F, dtype=torch.bool, device=dev))
    rows = {"root": R, "child": int(n_small)}
    for cname, ids, rl, kw in (
            ("root", root_ids, rl0, {}),
            ("child", small, rl_c, dict(row_gather=c_idx, num_rows=n_small))):
        L = ids.shape[0]
        ghs = gh_f if cname == "root" else gh_f[c_idx.long()].contiguous()

        def run(fn):
            return lambda: fn(bins, ghs, rl, ids, num_bins=B, params=sp,
                              emit_hist=True, **kw, **fk)
        ms = cuda_ms(run(CH.fused_build_best_splits), 10)
        plain_ms = cuda_ms(run(CH.fused_build_best_splits_plain), 2)
        bound, by = bound_of(hist_bytes(rows[cname], F, 12,
                                        cname == "child", L, B, bb),
                             3 * rows[cname] * F + 2 * L * F * B * 60)
        log(f"{tag}[B2] {cname:5s} rows={rows[cname]} L={L}: {ms:.3f} ms (bound "
            f"{bound:.3f} ms by {by}; plain {plain_ms:.3f} ms)")
        results["B2"][cname] = dict(ms=ms, plain_ms=plain_ms,
                                    library_ms=None, bound_ms=bound,
                                    bound_by=by, rows=rows[cname], L=L)
        ghq = gh_q if cname == "root" else gh_q[c_idx.long()].contiguous()
        ms8 = cuda_ms(lambda: CH.fused_build_best_splits(
            bins, ghq, rl, ids, num_bins=B, params=sp, emit_hist=True,
            quant_scales=qs, **kw, **fk), 10)
        bound8, _ = bound_of(hist_bytes(rows[cname], F, 3, cname == "child",
                                        L, B, bb),
                             3 * rows[cname] * F + 2 * L * F * B * 60)
        log(f"{tag}[B2] {cname:5s} int8 rows={rows[cname]} L={L}: {ms8:.3f} ms "
            f"(int8 bound {bound8:.3f} ms)")
        results["B2"][cname].update(ms_int8=ms8, bound_int8_ms=bound8)
    results["B2"]["max_abs_err"] = max(errs + small_errs)


def phase_b2_synthetic(CH, SP, dev):
    import numpy as np
    import torch
    rng = np.random.RandomState(0)
    R, F, B, L = 4096, 8, 16, 6
    bins = rng.randint(0, B - 1, size=(R, F)).astype(np.uint8)
    bins[rng.rand(R) < 0.1, 2] = B - 1
    rl = rng.randint(-1, L, size=R).astype(np.int32)
    g = rng.normal(size=R).astype(np.float32)
    gh = np.stack([g, np.abs(g) + 0.5, np.ones(R, np.float32)], 1)
    gh[rl < 0] = 0
    t = {k: torch.from_numpy(v).to(dev) for k, v in
         dict(bins=bins, gh=gh, rl=rl,
              ids=np.arange(L, dtype=np.int32)).items()}
    meta = dict(num_bins_pf=torch.full((F,), B, dtype=torch.int32,
                                       device=dev),
                nan_bin_pf=torch.from_numpy(np.where(
                    np.arange(F) == 2, B - 1, -1).astype(np.int32)).to(dev),
                is_cat_pf=torch.from_numpy(np.arange(F) == 5).to(dev))
    errs = []
    for extra in ({}, {"path_smooth": 2.0}, {"max_delta_step": 0.3,
                                             "lambda_l1": 0.5}):
        sp = SP.SplitParams(min_data_in_leaf=5.0, **extra)
        kw = dict(meta, parent_output=torch.zeros(L, device=dev))
        bk, _ = CH.fused_build_best_splits(t["bins"], t["gh"], t["rl"],
                                           t["ids"], num_bins=B, params=sp,
                                           hist_dtype="float32", **kw)
        bp, _ = CH.fused_build_best_splits_plain(
            t["bins"], t["gh"], t["rl"], t["ids"], num_bins=B, params=sp,
            hist_dtype="float32", **kw)
        torch.cuda.synchronize()
        errs.append(compare_best(f"B2 synthetic {extra}", bk, bp)[0])
    return errs


def tree_key(t):
    return (t.num_leaves, tuple(t.split_feature), tuple(t.threshold_bin),
            tuple(t.decision_type), tuple(t.left_child),
            tuple(t.right_child))


def small_parity_leg(lgt, X, y, nv, params, devtype, trees=1):
    """One leg of :func:`phase_small_parity` on ``devtype``: (trees, the
    valid metric, seconds, the binned matrix)."""
    from lightgbm_tpu_torch.config import Config
    from lightgbm_tpu_torch.metrics import AUC, L2
    n = SMALL_PARITY_ROWS
    p = dict(params, device_type=devtype)
    tr = lgt.Dataset(X[:n], label=y[:n], params=p)
    va = lgt.Dataset(X[n:n + nv], label=y[n:n + nv], reference=tr)
    t0 = time.perf_counter()
    bst = lgt.train(p, tr, trees, valid_sets=[va], valid_names=["valid"])
    secs = time.perf_counter() - t0
    raw = bst.predict(X[n:n + nv], raw_score=True)
    m = (L2 if params["objective"] == "regression" else AUC)(Config({}))
    m.init(y[n:n + nv], None)
    return (list(bst._trees), m.eval(raw)[0][1], secs,
            tr.bins.cpu().numpy())


def phase_small_parity(lgt, X, y, nv, params=PARAMS, what="binary",
                       trees=1, cpu=None):
    """SMALL_PARITY_ROWS rows x ``trees`` trees on the card (the kernels)
    and on the CPU (the plain path): tree structures compared, the
    valid metric (AUC, or l2 for a regression model) within 1e-3
    (relative for l2). ``cpu`` is the CPU leg when a worker made it
    (:func:`small_parity_leg`)."""
    import numpy as np
    regression = params["objective"] == "regression"
    tc, auc_c, sc, bins_c = small_parity_leg(lgt, X, y, nv, params, "cuda",
                                             trees)
    tp, auc_p, sp_, bins_p = (cpu if cpu is not None else small_parity_leg(
        lgt, X, y, nv, params, "cpu", trees))
    if not np.array_equal(bins_c, bins_p):
        raise AssertionError("device binning differs from the numpy path")
    same = [tree_key(a) == tree_key(b) for a, b in zip(tc, tp)]
    msg = f"{sum(same)}/{len(same)} trees structurally identical"
    if not all(same):
        i = same.index(False)
        a, b = tc[i], tp[i]
        k = next((j for j in range(min(len(a.split_feature),
                                       len(b.split_feature)))
                  if (a.split_feature[j], a.threshold_bin[j])
                  != (b.split_feature[j], b.threshold_bin[j])), None)
        msg += f"; first difference in tree {i}"
        if k is not None:
            msg += (f", split {k}: card gain {a.split_gain[k]:.6g} vs cpu "
                    f"{b.split_gain[k]:.6g}")
    name = "l2" if regression else "AUC"
    diff = abs(auc_c - auc_p) / (abs(auc_p) if regression else 1.0)
    log(f"[parity] {what} {SMALL_PARITY_ROWS} rows x {trees} trees: {msg}; valid {name} card "
        f"{auc_c:.6f} cpu {auc_p:.6f} (|diff| {diff:.2e}"
        f"{' relative' if regression else ''}); card {sc:.1f} s, "
        f"cpu {sp_:.1f} s" + (" (a worker, 2 threads)" if cpu else ""))
    if diff > 1e-3:
        raise AssertionError(f"[parity] {what}: card and CPU {name} differ "
                             "by more than 1e-3")
    return auc_c


def phase_full(lgt, CH, X, y, Xv, yv):
    import numpy as np
    import torch
    t0 = time.perf_counter()
    tr = lgt.Dataset(X, label=y, params=dict(PARAMS))
    va = lgt.Dataset(Xv, label=yv, reference=tr)
    tr.construct()
    va.construct()
    log(f"[full] Dataset {tr.num_data} x {tr.num_features} uint8 on "
        f"{tr.bins.device}, max_bin {PARAMS['max_bin']} -> B="
        f"{tr.max_num_bin}; binned in {time.perf_counter() - t0:.1f} s")
    runs = {}
    for mode, iters in (("auto", 20), ("off", 3)):
        # the main path with evaluation every iteration (eval_period 1)
        p = dict(PARAMS, fused_split=mode)
        hist = {}
        base = reset_peak()
        CH.reset_launch_counts()
        t0 = time.perf_counter()
        bst = lgt.train(p, tr, iters, valid_sets=[va], valid_names=["valid"],
                        callbacks=[lgt.record_evaluation(hist)])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(CH.LAUNCHES)
        aucs = hist["valid"]["auc"]
        runs[mode] = dict(bst=bst, launches=launches, wall=wall, aucs=aucs,
                          syncs=bst._gbdt.host_sync_count / iters,
                          peak=torch.cuda.max_memory_allocated() - base)
        log(f"[full] fused_split={mode}: {iters} trees with valid AUC every "
            f"iteration in {wall:.2f} s ({wall / iters * 1e3:.1f} ms/tree "
            f"incl. host AUC on {len(yv)} rows); host syncs/tree "
            f"{runs[mode]['syncs']:.2f}; peak device memory above the start "
            f"{runs[mode]['peak'] / 2**30:.2f} GiB; launches {launches}")
        log(f"[full] fused_split={mode} valid AUC per iteration: "
            + " ".join(f"{a:.5f}" for a in aucs))
        if not all(np.isfinite(aucs)) or aucs[-1] < 0.7:
            raise AssertionError(f"valid AUC {aucs[-1]} is not healthy")
        # training alone: trees stay on the device until the last
        # iteration (eval_period = iterations), no valid set
        n_it = 10 if mode == "auto" else 3
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tb = lgt.train(dict(p, eval_period=n_it), tr, n_it)
        torch.cuda.synchronize()
        ms_tree = (time.perf_counter() - t0) / n_it * 1e3
        runs[mode].update(ms_tree=ms_tree,
                          train_syncs=tb._gbdt.host_sync_count / n_it)
        log(f"[full] fused_split={mode}: training alone {n_it} trees "
            f"(iteration 0 and the step's capture included): "
            f"ms/tree {ms_tree:.1f}; row-trees/s "
            f"{tr.num_data / (ms_tree / 1e3):.4g}; host syncs/tree "
            f"{runs[mode]['train_syncs']:.2f}")
    if runs["auto"]["launches"]["fused_build_best_splits"] <= 0:
        raise AssertionError("the default path never launched B2")
    if runs["off"]["launches"]["build_histograms_cuda"] <= 0:
        raise AssertionError("fused_split=off never launched B1")
    bst = runs["auto"]["bst"]
    raw = bst.predict(Xv, raw_score=True)
    live = bst._gbdt.eval_scores(0)[:, 0]
    d_live = float(np.abs(raw - live).max())
    if not (np.isfinite(raw).all() and raw.shape == (len(yv),)):
        raise AssertionError("predictions are not finite / wrong shape")
    if d_live > 1e-4:
        raise AssertionError(f"predict differs from the training-time "
                             f"valid scores by {d_live}")
    out_dir = os.path.join(HERE, "build", "chip_smoke")
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, "model.txt")
    bst.save_model(path)
    b2 = lgt.Booster(model_file=path)
    raw2 = b2.predict(Xv, raw_score=True)
    rt = float(np.abs(raw2 - raw).max())
    log(f"[full] predict {len(yv)} rows: finite, |predict - live valid "
        f"scores| {d_live:.2e}; save/load round trip max diff {rt}")
    if rt != 0.0:
        raise AssertionError("save/load round trip changed predictions")
    return runs, tr, va


# the families the JAX package's TelemetrySession registers
# (lightgbm_tpu/telemetry/__init__.py, telemetry/device.py)
JAX_TELEMETRY_FAMILIES = (
    "train_iterations_total", "train_trees_total", "train_ms_per_tree",
    "train_iteration", "train_eval_metric", "train_phase_seconds_total",
    "train_host_syncs_total", "train_nan_guard_total",
    "train_checkpoints_total", "train_uptime_seconds",
    "train_fused_flops_per_iter", "train_fused_bytes_per_iter",
    "train_achieved_tflops", "train_mfu", "device_hbm_bytes_in_use",
    "device_hbm_bytes_peak", "xla_compiles_total",
    "xla_compile_seconds_total", "train_collective_hist_bytes_per_tree",
    "train_collective_hist_bytes_total")
TELEMETRY_ITERS = 8
TRACE_MS = 300


def http_get(port, path, timeout=120):
    import http.client
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    try:
        conn.request("GET", path)
        r = conn.getresponse()
        return r.status, r.read().decode()
    finally:
        conn.close()


def metric_value(text, name):
    """The value of the one series ``name`` (with its labels) in a
    Prometheus text render."""
    for ln in text.splitlines():
        if ln.startswith(name + " "):
            return float(ln.split()[-1])
    raise AssertionError(f"no series {name!r} in the scrape")


def telemetry_run(lgt, CH, tr, va, params, trace=False):
    """One ``[telemetry]`` run: TELEMETRY_ITERS iterations with valid AUC at
    eval_period 2, a host clock read at each sync point (ms/tree over
    iterations 3-12, after the capture). With ``telemetry_port`` set, a
    callback on the training thread scrapes /metrics and /events at each
    sync; with ``trace`` a helper thread takes a 1 ms capture as soon as
    the server is up (the process's first, which starts CUPTI; the sync
    of iteration 2 waits for it), then asks for the /trace of the phase
    once /healthz shows iteration >= 3; the sync of iteration 4 waits
    until /healthz shows the window open, and the sync of iteration 10
    until the trace has answered."""
    import json as _json
    import threading
    import torch
    from lightgbm_tpu_torch.telemetry import active_session
    marks, scrapes, out = {}, [], {}
    done, warm = threading.Event(), threading.Event()

    def tracer():
        while not done.is_set():
            sess = active_session()
            if sess is None or sess.port is None:
                time.sleep(0.005)
                continue
            if not warm.is_set():
                t0 = time.perf_counter()
                st, body = http_get(sess.port, "/trace?duration_ms=1")
                out["first"] = (st, _json.loads(body),
                                time.perf_counter() - t0)
                warm.set()
            elif _json.loads(http_get(sess.port, "/healthz")[1])[
                    "iteration"] >= 3:
                t0 = time.perf_counter()
                out["trace_at"] = t0
                st, body = http_get(sess.port,
                                    f"/trace?duration_ms={TRACE_MS}")
                out["trace_s"] = time.perf_counter() - t0
                out["trace"] = (st, _json.loads(body))
                return
            else:
                time.sleep(0.005)

    def at_sync(env):
        torch.cuda.synchronize()
        marks[env.iteration + 1] = time.perf_counter()
        sess = active_session()
        if sess is not None and sess.port is not None:
            out["port"] = sess.port
            st, text = http_get(sess.port, "/metrics")
            st2, ev = http_get(sess.port, "/events?n=4")
            if st != 200 or st2 != 200:
                raise AssertionError(f"[telemetry] scrape answered {st} / "
                                     f"{st2}")
            scrapes.append(text)
        if trace and env.iteration + 1 == 2:
            warm.wait(timeout=300)
        if trace and env.iteration + 1 == 4:
            # hold the loop until the window is open: CUPTI records the
            # kernels of launches made while it traces, so iterations
            # 5-6 must launch inside it
            t_end = time.perf_counter() + 120
            while th.is_alive() and time.perf_counter() < t_end and \
                    not _json.loads(http_get(sess.port, "/healthz")[1])[
                        "capturing"]:
                time.sleep(0.001)
        if trace and env.iteration + 1 == 10:
            th.join(timeout=300)
    th = threading.Thread(target=tracer, daemon=True)
    if trace:
        th.start()
    CH.reset_launch_counts()
    try:
        bst = lgt.train(params, tr, TELEMETRY_ITERS, valid_sets=[va],
                        valid_names=["valid"], callbacks=[at_sync])
    finally:
        done.set()
    torch.cuda.synchronize()
    out.update(bst=bst, launches=dict(CH.LAUNCHES), scrapes=scrapes,
               marks=marks,
               syncs=bst._gbdt.host_sync_count,
               ms=(marks[TELEMETRY_ITERS] - marks[2])
               / (TELEMETRY_ITERS - 2) * 1e3)
    return out


def phase_telemetry(lgt, CH, tr, va, full_trees, full_ms, smi):
    """``[telemetry]``: the Higgs-shaped model through the captured step
    with telemetry on (the exporter on a free port, the event log under
    ``build/chip_smoke/telemetry``), against a bare run: trees
    bit-identical to phase 4's first 8, the bare run's host syncs, B2
    17 a tree; every JAX family in /metrics, the memory gauge within the
    allocator's peak, one graph capture; the log passes check_records;
    a /trace capture names B2's kernels with device ms; the server is
    gone after train. Then 3 eager iterations at ``fused_split=off``
    whose log holds the four training phases (B1 17 a tree)."""
    import re
    import shutil
    import torch
    from lightgbm_tpu_torch.telemetry import active_session
    from lightgbm_tpu_torch.telemetry.events import check_records, read_events
    out_dir = os.path.join(HERE, "build", "chip_smoke", "telemetry")
    shutil.rmtree(out_dir, ignore_errors=True)
    os.makedirs(out_dir)
    base = dict(PARAMS, eval_period=2)
    n = TELEMETRY_ITERS
    runs = {"bare": telemetry_run(lgt, CH, tr, va, base)}
    for key, trace in (("telemetry", False), ("traced", True)):
        p = dict(base, telemetry_port=0,
                 event_log=os.path.join(out_dir, f"{key}.events.jsonl"))
        runs[key] = telemetry_run(lgt, CH, tr, va, p, trace=trace)
        # the allocator's peak since the process started (nothing resets
        # it during the run), which the gauge samples
        runs[key]["peak"] = torch.cuda.max_memory_allocated()
    # bare, telemetry, (traced), bare: the two bare runs give the spread
    runs["bare again"] = telemetry_run(lgt, CH, tr, va, base)
    for key, r in runs.items():
        if not same_trees(r["bst"]._trees, full_trees[:n]):
            raise AssertionError(f"[telemetry] {key}: trees differ from "
                                 f"phase 4's first {n}")
        if r["syncs"] != runs["bare"]["syncs"]:
            raise AssertionError(
                f"[telemetry] {key}: {r['syncs']} host syncs, the bare "
                f"run {runs['bare']['syncs']}")
        want = {"build_histograms_cuda": 0, "fused_build_best_splits": 17 * n,
                "build_root_histograms_classes": 0}
        if r["launches"] != want:
            raise AssertionError(f"[telemetry] {key}: launches "
                                 f"{r['launches']}, want {want}")
    r = runs["traced"]
    st0, first, s0 = r.get("first", (None, {}, 0.0))
    log(f"[telemetry] the process's first capture (1 ms): {st0} in "
        f"{s0:.2f} s, profiler start {first.get('profiler_start_ms')} ms, "
        f"stop {first.get('profiler_stop_ms')} ms; sync points at "
        + ", ".join(f"{i}: {(t - r.get('trace_at', t)) * 1e3:.0f}"
                    for i, t in sorted(r["marks"].items()))
        + " ms from the /trace request")
    last = r["scrapes"][-1]
    fams = {ln.split()[2] for ln in last.splitlines()
            if ln.startswith("# TYPE ")}
    missing = set(JAX_TELEMETRY_FAMILIES) - fams
    if missing:
        raise AssertionError(f"[telemetry] /metrics lacks {sorted(missing)}")
    hbm = metric_value(last, 'device_hbm_bytes_peak{device="cuda:0"}')
    # the render prints 9 significant digits (telemetry/core.py): hold
    # the gauge to the allocator's peak at that precision
    if not 0 < hbm <= float(f"{r['peak']:.9g}"):
        raise AssertionError(f"[telemetry] device_hbm_bytes_peak {hbm} not "
                             f"in (0, {r['peak']}]")
    caps = [metric_value(s, "xla_compiles_total") for s in r["scrapes"][-3:]]
    if caps != [1.0] * 3:
        raise AssertionError(f"[telemetry] captures at the last three "
                             f"syncs {caps}, want 1 each")
    recs = read_events(os.path.join(out_dir, "traced.events.jsonl"))
    probs = check_records(recs)
    its = [x for x in recs if x["event"] == "iteration"]
    log(f"[telemetry] host ms/iteration by phase at the last sync: "
        + ", ".join(f"{k} {v['s_per_iter'] * 1e3:.2f}"
                    for k, v in sorted(its[-1]["phase_s"].items())))
    if probs or [x["iter"] for x in its] != list(range(2, n + 1, 2)) or \
            not all(x["ms_per_tree"] > 0 for x in its):
        raise AssertionError(f"[telemetry] event log: {probs}, "
                             f"{[(x['event'], x.get('iter')) for x in recs]}")
    st, summ = r.get("trace", (None, {}))
    if st != 200:
        raise AssertionError(f"[telemetry] /trace answered {st}: {summ}")
    kern = summ["kernels"]
    b2 = {}
    for k in ("slot_accum_kernel", "split_epilogue_kernel"):
        hit = [v for name, v in kern.items() if k in name]
        b2[k] = (sum(v["ms"] for v in hit), sum(v["n"] for v in hit))
        if not b2[k][0] > 0:
            raise AssertionError(f"[telemetry] the trace does not name {k}: "
                                 f"{list(kern)[:20]}")
    if active_session() is not None:
        raise AssertionError("[telemetry] a session outlived train")
    try:
        http_get(r["port"], "/healthz", timeout=5)
    except OSError:
        pass
    else:
        raise AssertionError("[telemetry] the server outlived train")
    cost = [x for x in recs if x["event"] == "cost_model"]
    log(f"[telemetry] {n} captured trees at eval_period 2 with valid AUC: "
        f"ms/tree (iterations 3-{n}, host AUC included) bare "
        f"{runs['bare']['ms']:.2f}, with telemetry (scraped at each sync) "
        f"{runs['telemetry']['ms']:.2f}, bare again "
        f"{runs['bare again']['ms']:.2f} (phase 4's training alone "
        f"{full_ms:.1f}); host "
        f"syncs {r['syncs']} each; trees equal phase 4's; B2 {17 * n}, B1 "
        f"0; {len(fams)} families; device_hbm_bytes_peak {hbm:.0f} B "
        f"(allocator peak {r['peak']} B); captures 1; {len(recs)} log "
        f"records, check_records clean; cost_model {cost[:1]}")
    top = sorted(kern.items(), key=lambda kv: -kv[1]["ms"])[:6]
    log(f"[telemetry] /trace?duration_ms={TRACE_MS} answered in "
        f"{r['trace_s']:.2f} s (profiler start {summ['profiler_start_ms']} "
        f"ms, stop {summ['profiler_stop_ms']} ms): window "
        f"{summ['window_ms']:.1f} ms, device "
        f"busy {summ['device_busy_ms']:.1f} ms (share "
        f"{summ['device_busy_share']:.4f}), {summ['steps']} boost_iter "
        f"ranges, {summ['graph_launches']} graph replays, "
        f"{summ['graph_kernels']} kernels from them of "
        f"{sum(v['n'] for v in kern.values())}; phase ms "
        f"{summ['phase_device_ms']}; host phase ranges "
        f"{summ['host_phase_ranges']}")
    for name, v in top:
        short = re.sub(r"^void |\(anonymous namespace\)::", "", name)
        log(f"[telemetry]   {v['ms']:9.3f} ms x{v['n']:<5} "
            f"{short.split('(')[0][:70]}")
    log("[telemetry] B2's kernels in the window: "
        + ", ".join(f"{k} {ms:.3f} ms x{cnt}" for k, (ms, cnt) in b2.items()))
    # the eager loop (fused_split=off, B1): the phases' host seconds
    p = dict(PARAMS, fused_split="off", fused_train=False, eval_period=1,
             event_log=os.path.join(out_dir, "eager.events.jsonl"))
    CH.reset_launch_counts()
    lgt.train(p, tr, 3)
    eager_launches = dict(CH.LAUNCHES)
    recs = read_events(p["event_log"])
    its = [x for x in recs if x["event"] == "iteration"]
    seen = set().union(*(x["phase_s"] for x in its))
    if check_records(recs) or not {"grads", "sampling", "build",
                                   "update"} <= seen:
        raise AssertionError(f"[telemetry] eager log phases {seen}")
    if eager_launches["build_histograms_cuda"] != 51 or \
            eager_launches["fused_build_best_splits"] != 0:
        raise AssertionError(f"[telemetry] eager launches {eager_launches}")
    log("[telemetry] eager fused_split=off, 3 trees: host ms/iteration "
        + ", ".join(f"{k} {v['s_per_iter'] * 1e3:.2f}"
                    for k, v in sorted(its[-1]["phase_s"].items()))
        + f" (the last); launches {eager_launches}; {smi}")
    return dict(launches=runs["traced"]["launches"],
                eager_launches=eager_launches, ms=runs["telemetry"]["ms"],
                bare_ms=(runs["bare"]["ms"], runs["bare again"]["ms"]),
                busy=summ["device_busy_share"], trace_s=r["trace_s"])


def mc_gradients(y_dev, R_pad):
    """[K, R_pad, 3] softmax gradients at a mid-training score (the
    log class shares plus N(0, 0.5) per row and class, as after a few
    trees), count 1 on real rows and 0 on padded ones. At the
    boost-from-average score the hessian is one constant per class, and
    a long f32 chain of one constant drifts systematically: there the
    plain version (65,536-row chains) and B1 (32-row group sums)
    disagreed by ~1e-3 relative in a one-hot column's full bin."""
    import torch
    K = NUM_CLASS
    n = y_dev.shape[0]
    dev = y_dev.device
    yk = torch.nn.functional.one_hot(y_dev.long(), K).T.float()   # [K, n]
    gen = torch.Generator(device=dev).manual_seed(2)
    score = (torch.log(yk.mean(dim=1, keepdim=True))
             + 0.5 * torch.randn((K, n), generator=gen, device=dev))
    p = torch.softmax(score, dim=0)
    gh = torch.zeros((K, R_pad, 3), device=dev)
    gh[:, :n, 0] = p - yk
    gh[:, :n, 1] = K / (K - 1.0) * p * (1 - p)
    gh[:, :n, 2] = 1.0
    return gh.contiguous()


def f64_root_sums(bins, gh, live, B, hd):
    """[K, F, B, 3] float64 sums of the addends the kernel is asked for
    (bf16-rounded, f32 or int8), by one float64 index_add_ per feature:
    a measuring stick for this script only, never used by the port."""
    import torch
    R, F = bins.shape
    K = gh.shape[0]
    v = gh.to(torch.bfloat16) if hd == "bfloat16" and gh.is_floating_point() \
        else gh
    v = v.double().permute(1, 0, 2).reshape(R, K * 3)
    v = torch.where(live[:, None], v, 0.0)
    out = torch.zeros((F, B + 1, K * 3), dtype=torch.float64,
                      device=bins.device)
    for f in range(F):
        idx = bins[:, f].long().clamp(max=B)       # bins >= B are dropped
        out[f].index_add_(0, idx, v)
    return out[:, :B].reshape(F, B, K, 3).permute(2, 0, 1, 3)


def root_inputs(bins_n):
    """The root as the builder lays it out: the [n, C] bins padded to a
    multiple of 256 rows, row_leaf 0 on real rows and -1 on padded
    ones. Returns (bins [R, C], row_leaf [R], R)."""
    import torch
    dev = bins_n.device
    n, C = bins_n.shape
    R = -(-n // 256) * 256
    bins = torch.zeros((R, C), dtype=bins_n.dtype, device=dev)
    bins[:n] = bins_n
    rl0 = torch.full((R,), -1, dtype=torch.int32, device=dev)
    rl0[:n] = 0
    return bins, rl0, R


def int8_gh(gh_f):
    """[..., 3] f32 gh -> int8 grid values with the count channel."""
    import torch
    qg, qh, _ = quantize(gh_f[..., 0], gh_f[..., 1])
    return torch.stack([qg, qh, gh_f[..., 2].to(torch.int8)],
                       -1).contiguous()


def against_plain(tag, kernel, plain):
    """Two launches of ``kernel()`` equal each other; bf16 and f32 within
    rtol 1e-4 of ``plain(hd)``, int8 (int32 sums) exactly. ``kernel`` and
    ``plain`` take (gh kind, hist_dtype). Returns {label: max_abs_err}."""
    import torch
    errs = {}
    for label, kind, hd in (("bf16", "f", "bfloat16"),
                            ("f32", "f", "float32"),
                            ("int8", "q", "bfloat16")):
        k1, k2 = kernel(kind, hd), kernel(kind, hd)
        p = plain(kind, hd)
        torch.cuda.synchronize()
        if not torch.equal(k1, k2):
            raise AssertionError(f"{tag} {label}: two launches differ")
        if label == "int8":
            if not torch.equal(k1, p):
                raise AssertionError(f"{tag} int8 not exact")
            errs[label] = 0.0
        else:
            errs[label] = check_close(f"{tag} {label}", k1, p, 1e-4)
        del k1, k2, p
    return errs


def phase_b3(ds, y_dev, CH, H, results, tag=""):
    """B3 at the Covertype root, as the class-batched build calls it:
    rows padded to a multiple of 256 (row_leaf -1); ``tag`` prefixes
    the lines."""
    import torch
    dev = ds.bins.device
    n, F = ds.bins.shape
    bins, rl0, R = root_inputs(ds.bins)
    B = ds.max_num_bin
    bb = bins.element_size()
    K = NUM_CLASS
    W2 = 2 * MC_PARAMS["leaf_batch"]
    gh_f = mc_gradients(y_dev, R)
    gh_q = int8_gh(gh_f)
    # B1's root launch as the per-class builder makes it (2W slots)
    root_ids = torch.full((W2,), -2, dtype=torch.int32, device=dev)
    root_ids[0] = 0
    errs = {}
    for label, gh, hd in (("bf16", gh_f, "bfloat16"),
                          ("f32", gh_f, "float32"),
                          ("int8", gh_q, "bfloat16")):
        kw = dict(num_bins=B, hist_dtype=hd)
        k1 = CH.build_root_histograms_classes(bins, gh, rl0, **kw)
        k2 = CH.build_root_histograms_classes(bins, gh, rl0, **kw)
        p = CH.build_root_histograms_classes_plain(bins, gh, rl0, **kw)
        b1 = torch.stack([
            CH.build_histograms_cuda(bins, gh[k].contiguous(), rl0,
                                     root_ids, **kw)[0] for k in range(K)])
        torch.cuda.synchronize()
        if not torch.equal(k1, k2):
            raise AssertionError(f"B3 {label}: two launches differ")
        if label == "int8":
            if not torch.equal(k1, p):
                raise AssertionError("B3 int8 not exact")
            if not torch.equal(k1, b1):
                raise AssertionError("B3 int8 differs from B1's root launch")
            err = err_b1 = 0.0
        else:
            err = check_close(f"B3 {label}", k1, p, 1e-4)
            err_b1 = check_close(f"B3 {label} vs B1 root", k1, b1, 1e-4)
        # which side is closer to the exact sum
        ex = f64_root_sums(bins, gh, rl0 == 0, B, hd)
        scale = ex.abs().amax(dim=(0, 1, 2))
        e_k = (k1.double() - ex).abs().amax(dim=(0, 1, 2))
        e_p = (p.double() - ex).abs().amax(dim=(0, 1, 2))
        e_b = (b1.double() - ex).abs().amax(dim=(0, 1, 2))
        del ex

        def fmt(e):
            return "/".join(f"{float(v):.3g}" for v in e)
        log(f"{tag}[B3] root {label:4s} K={K} R={R} F={F} B={B} "
            f"max_abs_err vs plain={err:.3g} vs B1 root x{K}={err_b1:.3g} "
            f"deterministic=True; vs the f64 sum, max abs err per channel "
            f"(g/h/count) kernel {fmt(e_k)}, plain {fmt(e_p)}, B1 "
            f"{fmt(e_b)}; channel scale {fmt(scale)}")
        errs[label] = err
    kw = dict(num_bins=B, hist_dtype="bfloat16")
    ms = cuda_ms(lambda: CH.build_root_histograms_classes(bins, gh_f, rl0,
                                                          **kw), 10)
    plain_ms = cuda_ms(lambda: CH.build_root_histograms_classes_plain(
        bins, gh_f, rl0, **kw), 2)
    # the library call: one index_add_ over precomputed flat
    # (feature, bin) indices of the root rows, K x 3 lanes per row
    live = rl0 == 0
    flat = torch.where(live[:, None],
                       torch.arange(F, device=dev) * B + bins.long(),
                       F * B).reshape(-1)
    vals = gh_f.to(torch.bfloat16).float().permute(1, 0, 2) \
        .reshape(R, 1, K * 3).expand(R, F, K * 3).reshape(-1, K * 3)
    acc = torch.zeros((F * B + 1, K * 3), device=dev)
    lib_ms = cuda_ms(lambda: acc.index_add_(0, flat, vals), 3)
    del flat, vals, acc
    bound, by = bound_of(R * (F * bb + 12 * K + 4) + K * F * B * 12,
                         3 * K * n * F)
    # the M-tiles the kernel issued, counted by the kernel itself
    plan = CH.class_mma_plan(F, K, B, R, "bfloat16", bin_bytes=bb)
    tiles = torch.zeros(F, dtype=torch.int64, device=dev)
    CH.build_root_histograms_classes(bins, gh_f, rl0, mtiles=tiles, **kw)
    n_mma = int(tiles.sum()) * plan["n_tiles"]
    n_steps = plan["n_ktiles"] * R // 16
    log(f"{tag}[B3] plan {plan}")
    log(f"{tag}[B3] M-tiles issued per 16-row step, by feature (of "
        f"{(B + 15) // 16}), counted on the device: " + " ".join(
            f"{float(v) / n_steps:.2f}" for v in tiles.cpu()))
    log(f"{tag}[B3] root rows={R} K={K} F={F} B={B}: {ms:.3f} ms (bound "
        f"{bound:.4f} ms by {by}; plain {plain_ms:.3f} ms; index_add_ "
        f"{lib_ms:.3f} ms); {n_mma} m16n8k16 products at bf16 counted, "
        f"{n_mma * 2 * 16 * 8 * 16 / BF16_TC_FLOPS * 1e3:.4f} ms of them "
        f"at the dense tensor-core peak (a model, not a time)")
    ms8 = cuda_ms(lambda: CH.build_root_histograms_classes(bins, gh_q, rl0,
                                                           **kw), 10)
    bound8, _ = bound_of(R * (F * bb + 3 * K + 4) + K * F * B * 12,
                         3 * K * n * F)
    log(f"{tag}[B3] root int8 rows={R} K={K}: {ms8:.3f} ms (int8 bound "
        f"{bound8:.4f} ms)")
    results["B3"]["root"] = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                                 bound_ms=bound, bound_by=by, rows=R, L=K,
                                 ms_int8=ms8, bound_int8_ms=bound8)
    results["B3"]["max_abs_err"] = errs["bf16"]     # the main path's dtype


def mc_stream(ds, y_dev):
    """B1/B2's class-batched call: the compacted stream of the (class,
    row) pairs in the smaller children of a round, K x W = 147 folded
    slots (class k's leaf l is k(L+1) + l), bins rows through
    row_gather = pair % R, num_rows on the device, mid-training softmax
    gradients (f32, and int8 with its scales). Every row of every class
    sits in one of 2W leaves at random (a picture of a mid-tree round);
    leaves 0..W-1 are the smaller children."""
    import torch
    dev = ds.bins.device
    n = ds.bins.shape[0]
    K, W = NUM_CLASS, MC_PARAMS["leaf_batch"]
    L1 = MC_PARAMS["num_leaves"] + 1
    gen = torch.Generator(device=dev).manual_seed(3)
    kk = torch.arange(K, device=dev, dtype=torch.int32)[:, None]
    leaf = torch.randint(0, 2 * W, (K, n), generator=gen, device=dev,
                         dtype=torch.int32)
    folded = (kk * L1 + leaf).reshape(-1)
    ids = (kk * L1 + torch.arange(W, device=dev, dtype=torch.int32)
           ).reshape(-1).contiguous()
    c_idx, rl_c, n_small = compact(folded, ids, K * n)
    del folded, leaf
    gather = (c_idx % n).to(torch.int32)
    gh_k = mc_gradients(y_dev, n)
    gh_f = gh_k.reshape(K * n, 3)[c_idx.long()].contiguous()
    # int8 as the class-batched build quantizes: per-class scales, here
    # set apart by a factor 2 a class, folded into the K x W slots
    # (slot s holds class s // W) as [K * W, 2]
    qgh = []
    for k in range(K):
        m = 2.0 ** (k - K // 2)
        qgh.append(quantize(gh_k[k, :, 0] * m, gh_k[k, :, 1] * m))
    gh_q = torch.stack([torch.stack([qg for qg, _, _ in qgh]),
                        torch.stack([qh for _, qh, _ in qgh]),
                        gh_k[..., 2].to(torch.int8)], 2)
    gh_q = gh_q.reshape(K * n, 3)[c_idx.long()].contiguous()
    qs = torch.stack([q for _, _, q in qgh]).repeat_interleave(W, 0)
    return gh_f, gh_q, qs.contiguous(), rl_c, ids, gather, n_small


def phase_mc_stream(ds, y_dev, CH, H, SP, results):
    """B1 and B2 at the class-batched call (:func:`mc_stream`); B2's
    int8 case descales each slot by its class's scales."""
    import torch
    dev = ds.bins.device
    bins = ds.bins
    n, F = bins.shape
    B = ds.max_num_bin
    K = NUM_CLASS
    gh_f, gh_q, qs, rl_c, ids, gather, n_small = mc_stream(ds, y_dev)
    L = ids.shape[0]
    rows = int(n_small)
    kw = dict(row_gather=gather, num_rows=n_small)
    errs = {}
    for label, gh, hd in (("bf16", gh_f, "bfloat16"),
                          ("f32", gh_f, "float32"),
                          ("int8", gh_q, "bfloat16")):
        k1 = CH.build_histograms_cuda(bins, gh, rl_c, ids, num_bins=B,
                                      hist_dtype=hd, **kw)
        k2 = CH.build_histograms_cuda(bins, gh, rl_c, ids, num_bins=B,
                                      hist_dtype=hd, **kw)
        p = H.build_histograms(bins, gh, rl_c, ids, num_bins=B,
                               hist_dtype=hd, **kw)
        torch.cuda.synchronize()
        if not torch.equal(k1, k2):
            raise AssertionError(f"B1 class-batched {label}: two launches "
                                 "differ")
        if label == "int8":
            if not torch.equal(k1, p):
                raise AssertionError("B1 class-batched int8 not exact")
            err = 0.0
        else:
            err = check_close(f"B1 class-batched {label}", k1, p, 1e-4)
        errs[label] = err
        log(f"[B1] mc    {label:4s} L={L} rows={rows} of {K * n} "
            f"max_abs_err={err:.3g} deterministic=True")
    del k1, k2, p
    meta = dict(
        num_bins_pf=torch.from_numpy(ds.per_feature_num_bins()).to(dev),
        nan_bin_pf=torch.from_numpy(ds.per_feature_nan_bins()).to(dev),
        is_cat_pf=torch.from_numpy(ds.per_feature_is_categorical()).to(dev),
        feature_mask=torch.ones(F, dtype=torch.bool, device=dev))
    sp = SP.SplitParams(min_data_in_leaf=float(MC_PARAMS["min_data_in_leaf"]),
                        min_sum_hessian_in_leaf=1e-3)
    b2_errs = []
    for cfgn, gh in (("plain", gh_f), ("quant", gh_q)):
        fk = dict(meta, quant_scales=qs if cfgn == "quant" else None)
        (bk, hk), (bk2, hk2) = [CH.fused_build_best_splits(
            bins, gh, rl_c, ids, num_bins=B, params=sp, emit_hist=True,
            **kw, **fk) for _ in range(2)]
        bp, hp = CH.fused_build_best_splits_plain(
            bins, gh, rl_c, ids, num_bins=B, params=sp, emit_hist=True,
            **kw, **fk)
        torch.cuda.synchronize()
        if not (torch.equal(hk, hk2) and all(
                torch.equal(bk[k], bk2[k]) for k in bk)):
            raise AssertionError(f"B2 class-batched {cfgn}: two launches "
                                 "differ")
        err, flips = compare_best(f"B2 class-batched {cfgn}", bk, bp)
        if cfgn == "quant":
            if not torch.equal(hk, hp):
                raise AssertionError("B2 class-batched int8 hist not exact")
            # the check sees the slot-to-class map: the plain version
            # with the classes' scales rotated finds other gains
            bw, _ = CH.fused_build_best_splits_plain(
                bins, gh, rl_c, ids, num_bins=B, params=sp, **kw,
                **dict(fk, quant_scales=qs.roll(L // K, 0)))
            if torch.equal(bw["gain"], bp["gain"]):
                raise AssertionError("B2 class-batched int8: the class "
                                     "scales do not reach the gains")
            log(f"[B2] mc    quant g_scale per class "
                f"{qs[::L // K, 0].tolist()}")
        else:
            check_close(f"B2 class-batched {cfgn} hist", hk, hp, 1e-4)
            b2_errs.append(err)
        log(f"[B2] mc    {cfgn:5s} L={L} gain max_abs_err={err:.3g} "
            f"near-tie flips={flips} deterministic=True")
    del bk, hk, bk2, hk2, bp, hp
    # times at the main path's dtype (bf16-rounded f32 gradients)
    b1_args = (bins, gh_f, rl_c, ids)
    ms = cuda_ms(lambda: CH.build_histograms_cuda(
        *b1_args, num_bins=B, hist_dtype="bfloat16", **kw), 10)
    plain_ms = cuda_ms(lambda: H.build_histograms(
        *b1_args, num_bins=B, hist_dtype="bfloat16", **kw), 2)
    lib_ms = index_add_ms(bins, gh_f, rl_c, ids, B, rows, gather)
    bound, by = bound_of(hist_bytes(rows, F, 12, True, L, B), 3 * rows * F)
    log(f"[B1] mc    rows={rows} L={L} F={F} B={B}: {ms:.3f} ms (bound "
        f"{bound:.3f} ms by {by}; plain {plain_ms:.3f} ms; index_add_ "
        f"{lib_ms:.3f} ms)")
    results["B1"]["mc"] = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                               bound_ms=bound, bound_by=by, rows=rows, L=L)

    def b2(fn):
        return lambda: fn(*b1_args, num_bins=B, params=sp, emit_hist=True,
                          **kw, **meta)
    ms = cuda_ms(b2(CH.fused_build_best_splits), 10)
    plain_ms = cuda_ms(b2(CH.fused_build_best_splits_plain), 2)
    bound, by = bound_of(hist_bytes(rows, F, 12, True, L, B),
                         3 * rows * F + 2 * L * F * B * 60)
    log(f"[B2] mc    rows={rows} L={L}: {ms:.3f} ms (bound {bound:.3f} ms "
        f"by {by}; plain {plain_ms:.3f} ms)")
    results["B2"]["mc"] = dict(ms=ms, plain_ms=plain_ms, library_ms=None,
                               bound_ms=bound, bound_by=by, rows=rows, L=L)
    results["B1"]["max_abs_err"] = max(results["B1"]["max_abs_err"],
                                       errs["bf16"])
    results["B2"]["max_abs_err"] = max([results["B2"]["max_abs_err"]]
                                       + b2_errs)


def mc_logloss(raw, y):
    import numpy as np
    z = raw - raw.max(axis=1, keepdims=True)
    lp = z - np.log(np.exp(z).sum(axis=1, keepdims=True))
    return float(-lp[np.arange(len(y)), y.astype(np.int64)].mean())


def tree_parity(tag, name, got, ref, K=NUM_CLASS):
    """Tree lists compared structurally: equal, or equal up to the first
    difference, which must be a noise-level near tie (the gap of the two
    split gains within 1e-4 of the tree's largest gain); later trees
    grow from other scores. ``K`` trees an iteration. Returns the
    message for the log line."""
    import numpy as np
    same = [tree_key(a) == tree_key(b) for a, b in zip(got, ref)]
    msg = f"{sum(same)}/{len(same)} trees structurally identical"
    if not all(same):
        i = same.index(False)
        a, b = got[i], ref[i]
        k = next((j for j in range(min(len(a.split_feature),
                                       len(b.split_feature)))
                  if (a.split_feature[j], a.threshold_bin[j])
                  != (b.split_feature[j], b.threshold_bin[j])), None)
        msg += f"; first difference in tree {i}" + (
            f" (class {i % K})" if K > 1 else "")
        if k is None:
            raise AssertionError(f"{tag} {name}: {msg}, not at a split")
        # a gain is a difference of G^2/H terms bounded by the root's:
        # measure the gap against the tree's largest gain
        ga, gb = a.split_gain[k], b.split_gain[k]
        scale = max(np.max(np.abs(a.split_gain)),
                    np.max(np.abs(b.split_gain)), 1e-12)
        gap = abs(ga - gb) / scale
        msg += (f", split {k}: gain {ga:.7g} vs {gb:.7g} (gap {gap:.2e} "
                f"of the tree's largest gain {scale:.5g})")
        if gap > 1e-4:
            raise AssertionError(f"{tag} {name}: {msg}: not a near tie")
    return msg


MC_PARITY_ARMS = (("card batched", {}, "cpu"),
                  ("card per-class", {"class_batch": "off"}, "cpu"),
                  ("cpu", {"device_type": "cpu"}, None),
                  ("card batched quantized", QUANT, "cpu quantized"),
                  ("cpu quantized", dict(QUANT, device_type="cpu"), None))


def mc_parity_leg(lgt, X, y, nv, params, iters, ds_kw=None):
    """One arm of :func:`phase_mc_parity` under ``params``: (trees, the
    valid multi_logloss, seconds, the binned matrix)."""
    n = MC_PARITY_ROWS
    tr = lgt.Dataset(X[:n], label=y[:n], params=params, **(ds_kw or {}))
    t0 = time.perf_counter()
    bst = lgt.train(params, tr, iters)
    secs = time.perf_counter() - t0
    raw = bst.predict(X[n:n + nv], raw_score=True)
    return (list(bst._trees), mc_logloss(raw, y[n:n + nv]), secs,
            tr.bins.cpu())


def phase_mc_parity(lgt, X, y, nv, params=MC_PARAMS, arms=MC_PARITY_ARMS,
                    tag="[mc-parity]", iters=5, ds_kw=None, cpu_runs=None):
    """MC_PARITY_ROWS rows x ``iters`` iterations: by default
    class-batched on the card, per class on the card, and the CPU plain
    path; and quantized class-batched on the card (B3 and B2 int8,
    per-class scales) against the CPU. ``arms`` are (name, extra
    params, reference arm); each arm's binned matrix must equal its
    reference's. ``cpu_runs`` holds the arms a worker ran
    (:func:`mc_parity_leg`), by name."""
    import torch
    runs = dict(cpu_runs or {})
    for name, extra, _ in arms:
        if name not in runs:
            runs[name] = mc_parity_leg(lgt, X, y, nv, dict(params, **extra),
                                       iters, ds_kw)
    for name, _, ref_name in arms:
        if ref_name is None:
            continue
        ref, ll_ref, ref_secs, ref_bins = runs[ref_name]
        trees, ll, secs, bins = runs[name]
        if not torch.equal(bins, ref_bins):
            raise AssertionError(f"{tag} {name}: the card's binned (or "
                                 "bundled) matrix differs from the CPU's")
        msg = tree_parity(tag, name, trees, ref)
        log(f"{tag} {MC_PARITY_ROWS} rows x {iters} iterations, {name} vs {ref_name}: "
            f"{msg}; valid multi_logloss {ll:.7f} vs {ll_ref:.7f} (|diff| "
            f"{abs(ll - ll_ref):.2e}); {secs:.1f} s (cpu {ref_secs:.1f} s"
            + (", a worker)" if ref_name in (cpu_runs or {}) else ")"))
        if abs(ll - ll_ref) > 1e-4:
            raise AssertionError("card and CPU multi_logloss differ by "
                                 "more than 1e-4")
    return runs


def phase_mc_full(lgt, CH, X, y, Xv, yv):
    import numpy as np
    import torch
    t0 = time.perf_counter()
    tr = lgt.Dataset(X, label=y, params=dict(MC_PARAMS))
    va = lgt.Dataset(Xv, label=yv, reference=tr)
    tr.construct()
    va.construct()
    log(f"[mc-full] Dataset {tr.num_data} x {tr.num_features} uint8, "
        f"max_bin {MC_PARAMS['max_bin']} -> B={tr.max_num_bin}; binned in "
        f"{time.perf_counter() - t0:.1f} s")
    prior = np.bincount(y.astype(np.int64), minlength=NUM_CLASS) / len(y)
    ll0 = float(-np.log(prior[yv.astype(np.int64)]).mean())
    rounds = 16
    runs = {}
    for mode, iters in (("auto", 20), ("off", 3)):
        p = dict(MC_PARAMS, class_batch=mode)
        hist = {}
        base = reset_peak()
        CH.reset_launch_counts()
        t0 = time.perf_counter()
        bst = lgt.train(p, tr, iters, valid_sets=[va], valid_names=["valid"],
                        callbacks=[lgt.record_evaluation(hist)])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(CH.LAUNCHES)
        lls = hist["valid"]["multi_logloss"]
        runs[mode] = dict(bst=bst, launches=launches, wall=wall, lls=lls,
                          peak=torch.cuda.max_memory_allocated() - base)
        log(f"[mc-full] class_batch={mode}: {iters} iterations x "
            f"{NUM_CLASS} trees with valid multi_logloss every iteration in "
            f"{wall:.2f} s ({wall / iters * 1e3:.1f} ms/iteration); host "
            f"syncs/iteration {bst._gbdt.host_sync_count / iters:.2f}; peak "
            f"device memory above the start {runs[mode]['peak'] / 2**30:.2f}"
            f" GiB; launches "
            f"{launches}")
        log(f"[mc-full] class_batch={mode} valid multi_logloss per "
            f"iteration (boost-from-average {ll0:.5f}): "
            + " ".join(f"{v:.5f}" for v in lls))
        if not all(np.isfinite(lls)) or lls[-1] >= ll0:
            raise AssertionError(f"valid multi_logloss {lls[-1]} did not "
                                 f"fall below {ll0}")
        want = ({"build_root_histograms_classes": iters,
                 "fused_build_best_splits": rounds * iters,
                 "build_histograms_cuda": 0} if mode == "auto" else
                {"build_root_histograms_classes": 0,
                 "fused_build_best_splits": (rounds + 1) * NUM_CLASS * iters,
                 "build_histograms_cuda": 0})
        if launches != want:
            raise AssertionError(f"class_batch={mode}: launches {launches}, "
                                 f"expected {want}")
        # training alone: trees stay on the device until the last
        # iteration (eval_period = iterations), no valid set
        n_it = 10 if mode == "auto" else 3
        base = reset_peak()
        t0 = time.perf_counter()
        tb = lgt.train(dict(p, eval_period=n_it), tr, n_it)
        torch.cuda.synchronize()
        ms_it = (time.perf_counter() - t0) / n_it * 1e3
        runs[mode].update(ms_it=ms_it,
                          train_syncs=tb._gbdt.host_sync_count / n_it,
                          train_peak=torch.cuda.max_memory_allocated() - base)
        log(f"[mc-full] class_batch={mode}: training alone {n_it} "
            f"iterations (iteration 0 and the step's capture included): "
            f"ms/iteration {ms_it:.1f}; row-iterations/s "
            f"{tr.num_data / (ms_it / 1e3):.4g}; host syncs/iteration "
            f"{runs[mode]['train_syncs']:.2f}; peak device memory above the "
            f"start {runs[mode]['train_peak'] / 2**30:.2f} GiB")
    bst = runs["auto"]["bst"]
    raw = bst.predict(Xv, raw_score=True)
    live = bst._gbdt.eval_scores(0)
    d_live = float(np.abs(raw - live).max())
    if not (np.isfinite(raw).all() and raw.shape == (len(yv), NUM_CLASS)):
        raise AssertionError("predictions are not finite / wrong shape")
    if d_live > 1e-4:
        raise AssertionError(f"predict differs from the training-time "
                             f"valid scores by {d_live}")
    out_dir = os.path.join(HERE, "build", "chip_smoke")
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, "model_multiclass.txt")
    bst.save_model(path)
    raw2 = lgt.Booster(model_file=path).predict(Xv, raw_score=True)
    rt = float(np.abs(raw2 - raw).max())
    log(f"[mc-full] predict {len(yv)} x {NUM_CLASS}: finite, |predict - live "
        f"valid scores| {d_live:.2e}; save/load round trip max diff {rt}")
    if rt != 0.0:
        raise AssertionError("save/load round trip changed predictions")
    return runs, tr


def run_arm(lgt, CH, tr, params, n_it, fused, split_at=None, debug=False,
            valid=None, keep=False):
    """One arm of ``[step]``: iteration 0 (with the captured step the
    body runs eagerly and is then captured), then ``n_it`` iterations
    timed with one host sync at the end (training alone, no valid set).
    ``split_at`` (GOSS's start iteration) also times the iterations
    before it, it alone (the second graph's eager run and capture) and
    the ones after it, with a device sync between the windows.
    ``debug`` runs the timed iterations under
    ``torch.cuda.set_sync_debug_mode("error")``: any host sync in them
    raises. ``valid`` (a Dataset) adds a valid set, whose first metric
    is returned as ``valid_metric``. Returns the trees, the final scores
    and the arm's numbers; the booster is dropped, with its graph,
    unless ``keep``."""
    import torch
    p = dict(params, fused_train=fused)
    base = reset_peak()
    bst = lgt.Booster(params=p, train_set=tr)
    if valid is not None:
        bst.add_valid(valid, "valid")
    t0 = time.perf_counter()
    bst.update(defer=True)
    torch.cuda.synchronize()
    first = time.perf_counter() - t0
    g = bst._gbdt
    if g.fused_train_ok != fused or (g._graph is not None) != fused:
        raise AssertionError(f"fused_train={fused}: the step "
                             f"{'was not' if fused else 'was'} captured "
                             f"({g.fused_train_reason!r})")
    syncs0, bag0 = g.host_sync_count, g.bag_draw_seconds
    CH.reset_launch_counts()
    marks = {}
    t0 = time.perf_counter()
    if debug:
        torch.cuda.set_sync_debug_mode("error")
    try:
        for i in range(1, n_it + 1):
            bst.update(defer=True)
            if split_at is not None and i in (split_at - 1, split_at):
                torch.cuda.synchronize()
                marks[i] = time.perf_counter()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    g.sync()
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    ms = (t1 - t0) / n_it * 1e3
    out = dict(trees=list(bst._trees), scores=g.scores.cpu(), ms=ms,
               first_s=first, capture_s=g.capture_seconds,
               syncs=(g.host_sync_count - syncs0) / n_it,
               launches=dict(CH.LAUNCHES), int8=dict(CH.INT8_LAUNCHES),
               graph_launches=g._graph_launches, graphs=len(g._graphs),
               bag_s=g.bag_draw_seconds - bag0, bag_total_s=g.bag_draw_seconds,
               peak=torch.cuda.max_memory_allocated() - base)
    if split_at is not None:
        a, b = marks[split_at - 1], marks[split_at]
        out.update(ms_before=(a - t0) / (split_at - 1) * 1e3,
                   split_s=b - a, ms_after=(t1 - b) / (n_it - split_at) * 1e3)
    if valid is not None:
        out["valid_metric"] = bst.eval_valid()[0][2]
    if keep:
        out["bst"] = bst
    del bst, g
    torch.cuda.empty_cache()
    return out


def same_trees(a, b):
    """Bit-identical tree lists: structure, thresholds, leaf values and
    gains."""
    import numpy as np
    if len(a) != len(b):
        return False
    fields = ("split_feature", "threshold_bin", "decision_type", "left_child",
              "right_child", "leaf_value", "split_gain", "internal_value")
    return all(x.num_leaves == y.num_leaves and all(
        np.array_equal(getattr(x, f), getattr(y, f)) for f in fields)
        for x, y in zip(a, b))


def phase_step(lgt, CH, cells, tag="[step]"):
    """``[step]``: each cell trained captured (one CUDA-graph replay an
    iteration) and eager (fused_train=false), in turns; trees and final
    scores must be bit-identical, and the replays' launch counts (all
    and int8) equal the eager loop's. A cell is (name, dataset, params,
    iterations after iteration 0, the arms' order[, run_arm options])."""
    import torch
    out = {}
    for name, tr, params, n_it, order, *opts in cells:
        runs = []
        for fused in order:
            r = run_arm(lgt, CH, tr, params, n_it, fused,
                        **(opts[0] if opts else {}))
            runs.append((fused, r))
            arm = "captured" if fused else "eager"
            extra = ""
            if fused:
                extra = (f"; capture {r['capture_s']:.2f} s; launches "
                         f"captured per replay {r['graph_launches']}")
            if params.get("bagging_freq", 0) > 0:
                draws = -(-(n_it + 1) // params["bagging_freq"])
                extra += (f"; host bagging draws {r['bag_total_s'] * 1e3:.1f}"
                          f" ms in {draws} draws ({r['bag_s'] * 1e3:.1f} ms "
                          f"inside the timed iterations)")
            if any(r["int8"].values()):
                extra += f"; int8 launches {r['int8']}"
            if "ms_before" in r:
                extra += (f"; ms/iteration before the split iteration "
                          f"{r['ms_before']:.1f}, the split iteration "
                          f"{r['split_s'] * 1e3:.1f} ms, after it "
                          f"{r['ms_after']:.1f}; graphs {r['graphs']}")
            log(f"{tag} {name} {arm:8s}: training alone {n_it} iterations "
                f"after iteration 0 ({r['first_s']:.2f} s): ms/iteration "
                f"{r['ms']:.1f}; host syncs/iteration {r['syncs']:.2f}; peak "
                f"device memory above the start {r['peak'] / 2**30:.2f} GiB; "
                f"launches {r['launches']}{extra}")
        ref = runs[0][1]
        for fused, r in runs[1:]:
            if not same_trees(ref["trees"], r["trees"]):
                raise AssertionError(f"{tag} {name}: captured and eager "
                                     "trees differ")
            if not torch.equal(ref["scores"], r["scores"]):
                raise AssertionError(f"{tag} {name}: captured and eager "
                                     "scores differ")
            if (r["launches"], r["int8"]) != (ref["launches"], ref["int8"]):
                raise AssertionError(f"{tag} {name}: launches "
                                     f"{r['launches']} {r['int8']} != "
                                     f"{ref['launches']} {ref['int8']}")
        cap = [r["ms"] for f, r in runs if f]
        eag = [r["ms"] for f, r in runs if not f]
        log(f"{tag} {name}: {len(ref['trees'])} trees bit-identical across "
            f"{len(runs)} runs; ms/iteration captured "
            + " / ".join(f"{v:.1f}" for v in cap) + ", eager "
            + " / ".join(f"{v:.1f}" for v in eag))
        out[name] = runs
    return out


def phase_quant(lgt, CH, tr, va, f32_auc):
    """``[quant]``: quantized training of the Higgs-shaped model. 20
    iterations with valid AUC every iteration (every B2 launch int8, 17
    a tree; the AUC beside the float run's), then captured against
    eager through B2 and B1, and with leaf renewal, beside a float
    captured arm."""
    import numpy as np
    import torch
    p = dict(PARAMS, **QUANT)
    hist = {}
    CH.reset_launch_counts()
    t0 = time.perf_counter()
    lgt.train(p, tr, 20, valid_sets=[va], valid_names=["valid"],
              callbacks=[lgt.record_evaluation(hist)])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, int8 = dict(CH.LAUNCHES), dict(CH.INT8_LAUNCHES)
    aucs = hist["valid"]["auc"]
    delta = aucs[-1] - f32_auc
    log(f"[quant] 20 trees with valid AUC every iteration in {wall:.2f} s; "
        f"launches {launches}, int8 {int8}; valid AUC per iteration: "
        + " ".join(f"{a:.5f}" for a in aucs))
    log(f"[quant] valid AUC after 20 trees: quantized {aucs[-1]:.6f}, float "
        f"{f32_auc:.6f}; quant_auc_delta {delta:+.6f}")
    if int8["fused_build_best_splits"] != 17 * 20 or launches != int8:
        raise AssertionError("[quant]: not every launch was an int8 B2 "
                             "launch, 17 a tree")
    if not all(np.isfinite(aucs)) or abs(delta) > 0.01:
        raise AssertionError(f"[quant]: valid AUC {aucs[-1]} is not within "
                             f"0.01 of the float run's {f32_auc}")
    out = phase_step(lgt, CH, [
        ("higgs float B2", tr, PARAMS, 5, (True,)),
        ("higgs quantized B2", tr, p, 5, (True, False, False, True)),
        ("higgs quantized B1", tr, dict(p, fused_split="off"), 5,
         (True, False)),
        ("higgs quantized renew", tr, dict(p, quant_train_renew_leaf=True), 3,
         (True, False)),
    ], tag="[quant]")
    for name, kname in (("higgs quantized B2", "fused_build_best_splits"),
                        ("higgs quantized B1", "build_histograms_cuda"),
                        ("higgs quantized renew", "fused_build_best_splits")):
        n_it = len(out[name][0][1]["trees"]) - 1
        for _, r in out[name]:
            if r["int8"][kname] != 17 * n_it or r["launches"] != r["int8"]:
                raise AssertionError(f"[quant] {name}: int8 launches "
                                     f"{r['int8']} are not 17 {kname} a tree")
    f32 = out["higgs float B2"][0][1]["ms"]
    q = [r["ms"] for f, r in out["higgs quantized B2"] if f]
    log(f"[quant] captured ms/tree: float {f32:.1f}, quantized "
        + " / ".join(f"{v:.1f}" for v in q))
    return dict(auc_delta=delta, launches_b2=int8["fused_build_best_splits"],
                launches_b1=out["higgs quantized B1"][0][1]["int8"][
                    "build_histograms_cuda"])


def phase_quant_mc(lgt, CH, cov_tr):
    """``[quant-mc]``: quantized class-batched training of the
    Covertype-shaped model, captured against eager: one int8 B3 launch
    and 16 int8 B2 launches an iteration."""
    n_it = 10
    out = phase_step(lgt, CH, [("covtype quantized class-batched", cov_tr,
                                dict(MC_PARAMS, **QUANT), n_it,
                                (True, False))], tag="[quant-mc]")
    r = out["covtype quantized class-batched"][0][1]
    want = {"build_histograms_cuda": 0, "fused_build_best_splits": 16 * n_it,
            "build_root_histograms_classes": n_it}
    if r["int8"] != want or r["launches"] != want:
        raise AssertionError(f"[quant-mc]: launches {r['launches']}, int8 "
                             f"{r['int8']}; want {want}")
    return r["int8"]


def phase_goss(lgt, tr, CH):
    """``[goss]``: GOSS on the Higgs-shaped model, 14 trees captured
    against eager across its start iteration (10), timed on each side."""
    import numpy as np
    p = dict(PARAMS, **GOSS)
    start = int(1.0 / p["learning_rate"])
    out = phase_step(lgt, CH, [("higgs goss", tr, p, 13, (True, False),
                                dict(split_at=start))], tag="[goss]")
    runs = out["higgs goss"]
    cap = runs[0][1]
    if cap["graphs"] != 2:
        raise AssertionError(f"[goss]: {cap['graphs']} graphs, want 2")
    counts = [t.internal_count[0] for t in cap["trees"]]
    n = tr.num_data
    if not (all(c == n for c in counts[:start])
            and all(c < n for c in counts[start:])):
        raise AssertionError(f"[goss]: root counts {counts} do not drop "
                             f"below {n} from iteration {start}")
    log(f"[goss] root rows per tree: {counts[0]} before iteration {start}, "
        f"then {int(np.mean(counts[start:]))} on average (top_rate "
        f"{p['top_rate']} + other_rate {p['other_rate']} of {n})")
    return runs


def phase_year(lgt, CH):
    """``[regression]``: the Year-shaped regression model (L2): 20
    iterations with a falling valid l2, captured against eager; then 3
    iterations of each other objective at the same shape, captured
    against eager under the sync debug mode."""
    import numpy as np
    import torch
    t0 = time.perf_counter()
    X, y = make_year_like(YEAR_ROWS)
    tr = lgt.Dataset(X[:YEAR_TRAIN], label=y[:YEAR_TRAIN],
                     params=dict(YEAR_PARAMS))
    va = lgt.Dataset(X[YEAR_TRAIN:], label=y[YEAR_TRAIN:], reference=tr)
    tr.construct()
    va.construct()
    log(f"[regression] Year-shaped {tr.num_data} + {va.num_data} rows x "
        f"{tr.num_features} made and binned in "
        f"{time.perf_counter() - t0:.1f} s (B={tr.max_num_bin}); label "
        f"{y.min():.0f}-{y.max():.0f}, median {np.median(y):.0f}")
    hist = {}
    t0 = time.perf_counter()
    bst = lgt.train(dict(YEAR_PARAMS), tr, 20, valid_sets=[va],
                    valid_names=["valid"],
                    callbacks=[lgt.record_evaluation(hist)])
    torch.cuda.synchronize()
    l2 = hist["valid"]["l2"]
    log(f"[regression] 20 trees with valid l2 every iteration in "
        f"{time.perf_counter() - t0:.2f} s; valid l2 per iteration: "
        + " ".join(f"{v:.3f}" for v in l2))
    if not (all(np.isfinite(l2)) and all(b < a for a, b in zip(l2, l2[1:]))):
        raise AssertionError("[regression]: valid l2 is not falling")
    raw = bst.predict(X[YEAR_TRAIN:], raw_score=True)
    d_live = float(np.abs(raw - bst._gbdt.eval_scores(0)[:, 0]).max())
    if d_live > 1e-2:
        raise AssertionError(f"[regression]: predict differs from the live "
                             f"valid scores by {d_live}")
    cells = [("year regression", tr, YEAR_PARAMS, 10, (True, False))]
    for obj in OTHER_OBJECTIVES:
        tro = lgt.Dataset(X[:YEAR_TRAIN],
                          label=year_label(y[:YEAR_TRAIN], obj), reference=tr)
        cells.append((f"year {obj}", tro, dict(YEAR_PARAMS, objective=obj),
                      1, (True, False), dict(debug=True)))
    return phase_step(lgt, CH, cells, tag="[regression]"), X, y


def phase_b1_bundle(ds, y_dev, CH, H, results):
    """B1 in bundle space: the class-batched call of :func:`mc_stream`
    (147 folded slots, compacted (class, row) pairs) over the bundled
    [R, G] matrix at the bundle lattice's bins, against its plain
    version (bf16, f32, int8) and timed; then the lattice's edge, 256
    bins, with uint8 values up to 255."""
    import numpy as np
    import torch
    dev = ds.bins.device
    bins = ds.bins
    n, G = bins.shape
    Bb = ds.bundle_plan.max_bundle_bins
    gh_f, gh_q, _, rl_c, ids, gather, n_small = mc_stream(ds, y_dev)
    L = ids.shape[0]
    rows = int(n_small)
    kw = dict(row_gather=gather, num_rows=n_small)
    errs = {}
    for label, gh, hd in (("bf16", gh_f, "bfloat16"),
                          ("f32", gh_f, "float32"),
                          ("int8", gh_q, "bfloat16")):
        k1, k2 = [CH.build_histograms_cuda(bins, gh, rl_c, ids, num_bins=Bb,
                                           hist_dtype=hd, **kw)
                  for _ in range(2)]
        p = H.build_histograms(bins, gh, rl_c, ids, num_bins=Bb,
                               hist_dtype=hd, **kw)
        torch.cuda.synchronize()
        if not torch.equal(k1, k2):
            raise AssertionError(f"B1 bundle {label}: two launches differ")
        if label == "int8":
            if not torch.equal(k1, p):
                raise AssertionError("B1 bundle int8 not exact")
            errs[label] = 0.0
        else:
            errs[label] = check_close(f"B1 bundle {label}", k1, p, 1e-4)
        log(f"[B1] bundle {label:4s} L={L} G={G} Bb={Bb} rows={rows} "
            f"max_abs_err={errs[label]:.3g} deterministic=True")
    del k1, k2, p
    args = (bins, gh_f, rl_c, ids)
    ms = cuda_ms(lambda: CH.build_histograms_cuda(
        *args, num_bins=Bb, hist_dtype="bfloat16", **kw), 10)
    plain_ms = cuda_ms(lambda: H.build_histograms(
        *args, num_bins=Bb, hist_dtype="bfloat16", **kw), 2)
    lib_ms = index_add_ms(bins, gh_f, rl_c, ids, Bb, rows, gather)
    bound, by = bound_of(hist_bytes(rows, G, 12, True, L, Bb), 3 * rows * G)
    log(f"[B1] bundle rows={rows} L={L} G={G} Bb={Bb}: {ms:.3f} ms (bound "
        f"{bound:.3f} ms by {by}; plain {plain_ms:.3f} ms; index_add_ "
        f"{lib_ms:.3f} ms)")
    # the lattice's edge: 256 bins, values up to 255, on as many warps a
    # block as at 253 bins
    plan = {b: CH.slot_hist_plan(G, 2 * MC_PARAMS["leaf_batch"], b,
                                 1 << 20)["warps"] for b in (253, 256)}
    if plan[253] != plan[256]:
        raise AssertionError(f"B1 plan warps at 253 / 256 bins: {plan}")
    rng = np.random.RandomState(4)
    Re, Le = 1 << 20, 2 * MC_PARAMS["leaf_batch"]
    eb = rng.randint(0, 256, size=(Re, G)).astype(np.uint8)
    eb[rng.rand(Re) < 0.2, 0] = 255
    erl = rng.randint(-1, Le, size=Re).astype(np.int32)
    g = rng.normal(size=Re).astype(np.float32)
    egh = np.stack([g, np.abs(g) + 0.5, np.ones(Re, np.float32)], 1)
    eq = np.stack([rng.randint(-3, 4, size=Re), rng.randint(0, 5, size=Re),
                   np.ones(Re)], 1).astype(np.int8)
    t = [torch.from_numpy(a).to(dev)
         for a in (eb, egh, eq, erl, np.arange(Le, dtype=np.int32))]
    for label, gh in (("f32", t[1]), ("int8", t[2])):
        k = CH.build_histograms_cuda(t[0], gh, t[3], t[4], num_bins=256,
                                     hist_dtype="float32")
        p = H.build_histograms(t[0], gh, t[3], t[4], num_bins=256,
                               hist_dtype="float32")
        torch.cuda.synchronize()
        if not bool(k[:, 0, 255, 2].sum() > 0):
            raise AssertionError("B1 at 256 bins: bin 255 is empty")
        err = 0.0
        if label == "int8":
            if not torch.equal(k, p):
                raise AssertionError("B1 at 256 bins: int8 not exact")
        else:
            err = check_close("B1 at 256 bins f32", k, p, 1e-4)
        log(f"[B1] bundle edge Bb=256 {label:4s} L={Le} G={G} rows={Re} "
            f"(values 0..255): max_abs_err={err:.3g}; warps a block at "
            f"253 / 256 bins {plan[253]} / {plan[256]}")
    # the class-batched root under EFB (B3 is not called there): one
    # slot a class, every (class, row) pair of the padded K x R stream,
    # bins rows through row_gather = pair % R
    K, L1 = NUM_CLASS, MC_PARAMS["num_leaves"] + 1
    rbins, rl0, R = root_inputs(bins)
    kk = torch.arange(K, dtype=torch.int32, device=dev)
    rids = (kk * L1).contiguous()
    rl_r = torch.where(rl0[None, :] >= 0, kk[:, None] * L1, -1) \
        .reshape(-1).to(torch.int32).contiguous()
    gat_r = (torch.arange(K * R, device=dev) % R).to(torch.int32)
    ghr = {"f": mc_gradients(y_dev, R).reshape(K * R, 3).contiguous()}
    ghr["q"] = int8_gh(ghr["f"])
    rkw = dict(num_bins=Bb, row_gather=gat_r)
    rerrs = against_plain(
        "B1 bundle root",
        lambda kind, hd: CH.build_histograms_cuda(
            rbins, ghr[kind], rl_r, rids, hist_dtype=hd, **rkw),
        lambda kind, hd: H.build_histograms(
            rbins, ghr[kind], rl_r, rids, hist_dtype=hd, **rkw))
    log(f"[B1] bundle root L={K} G={G} Bb={Bb} (class, row) pairs={K * R} "
        f"max_abs_err bf16 {rerrs['bf16']:.3g} f32 {rerrs['f32']:.3g} "
        f"int8 exact; deterministic=True")
    del rl_r, gat_r, ghr, rbins
    results["B1"]["bundle"] = dict(
        ms=ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bound,
        bound_by=by, rows=rows, L=L, G=G, Bb=Bb, max_abs_err=errs["bf16"],
        root_max_abs_err=rerrs["bf16"])


def expect_launches(tag, name, r, want, int8=False):
    """A [step] run's launches (and int8 launches) are ``want``."""
    got = r["int8"] if int8 else r["launches"]
    full = dict(dict.fromkeys(("build_histograms_cuda",
                               "fused_build_best_splits",
                               "build_root_histograms_classes"), 0), **want)
    if got != full or (int8 and r["launches"] != full):
        raise AssertionError(f"{tag} {name}: launches {r['launches']} "
                             f"(int8 {r['int8']}), expected {full}")


def phase_efb(lgt, CH, H, X, y, Xv, yv, mc_runs, results, cpu_runs=None):
    """``[efb]``: the Covertype shape at default parameters, EFB on.
    The port's 12 bundles; B1 in bundle space against its plain
    version; 20 class-batched iterations with valid multi_logloss
    against [mc-full]'s enable_bundle=false run (trees equal up to a
    near tie, multi_logloss within 1e-4 over the first 5 iterations, the
    difference after 20 reported); class-batched, per-class and
    quantized class-batched captured against eager, every histogram
    launch B1 over the [R, G] bundled matrix at the bundle lattice's
    bins (B2 and B3 never launch); card against CPU at 2^14 rows."""
    import numpy as np
    import torch
    from lightgbm_tpu_torch.boosting.tree_builder import max_rounds_for
    p = dict(EFB_PARAMS)
    per_tree = 1 + max_rounds_for(p["num_leaves"], p["leaf_batch"])
    t0 = time.perf_counter()
    tr = lgt.Dataset(X, label=y, params=p)
    va = lgt.Dataset(Xv, label=yv, reference=tr)
    tr.construct()
    va.construct()
    bp = tr.bundle_plan
    if bp is None or tr.bins.shape[1] != bp.num_bundles:
        raise AssertionError("[efb]: the default Covertype Dataset formed "
                             "no bundles")
    G, Bb = bp.num_bundles, bp.max_bundle_bins
    F, B = tr.num_features, tr.max_num_bin
    log(f"[efb] Dataset {tr.num_data} + {va.num_data} rows x {F} features "
        f"-> G={G} bundle columns ({tr.bins.dtype}) in "
        f"{time.perf_counter() - t0:.1f} s; lattice G x Bb = {G} x {Bb} = "
        f"{G * Bb} cells against F x B = {F} x {B} = {F * B}; bundle bins "
        + " ".join(str(int(b)) for b in bp.bundle_num_bins))
    if G != 12:
        raise AssertionError(f"[efb]: {G} bundles, the JAX package forms "
                             "12 at this shape")
    y_dev = torch.from_numpy(y).to("cuda")
    phase_b1_bundle(tr, y_dev, CH, H, results)
    del y_dev
    torch.cuda.empty_cache()

    seen = set()
    b1 = CH.build_histograms_cuda

    def b1_seen(bins, *a, num_bins, **k):
        seen.add((bins.shape[1], int(num_bins)))
        return b1(bins, *a, num_bins=num_bins, **k)
    CH.build_histograms_cuda = b1_seen
    try:
        hist = {}
        CH.reset_launch_counts()
        t0 = time.perf_counter()
        bst = lgt.train(p, tr, 20, valid_sets=[va], valid_names=["valid"],
                        callbacks=[lgt.record_evaluation(hist)])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(CH.LAUNCHES)
        g = bst._gbdt
        if g.fused_split_reason != "EFB bundles unbundle the full histogram":
            raise AssertionError(f"[efb]: fused gate {g.fused_split_reason!r}")
        want = {"build_histograms_cuda": per_tree * 20,
                "fused_build_best_splits": 0,
                "build_root_histograms_classes": 0}
        if launches != want:
            raise AssertionError(f"[efb]: launches {launches}, want {want}")
        lls = hist["valid"]["multi_logloss"]
        ref = mc_runs["auto"]
        msg = tree_parity("[efb]", "vs enable_bundle=false", bst._trees,
                          ref["bst"]._trees)
        # after a tie the two runs grow different models, whose losses
        # drift apart: the 1e-4 bound holds over [mc-parity]'s 5
        # iterations; the difference after 20 is reported
        d_ll = [abs(a - b) for a, b in zip(lls, ref["lls"])]
        log(f"[efb] class-batched 20 iterations with valid multi_logloss in "
            f"{wall:.2f} s ({wall / 20 * 1e3:.1f} ms/iteration); launches "
            f"{launches}; against [mc-full]'s enable_bundle=false run: "
            f"{msg}; valid multi_logloss after 20 iterations {lls[-1]:.6f} "
            f"vs {ref['lls'][-1]:.6f} (|diff| {d_ll[-1]:.2e}), |diff| per "
            "iteration " + " ".join(f"{d:.1e}" for d in d_ll))
        log("[efb] valid multi_logloss per iteration: "
            + " ".join(f"{v:.5f}" for v in lls))
        if not all(np.isfinite(lls)) or max(d_ll[:5]) > 1e-4:
            raise AssertionError("[efb]: multi_logloss differs from the "
                                 "unbundled run's by more than 1e-4 within "
                                 "5 iterations")
        raw = bst.predict(Xv, raw_score=True)
        d_live = float(np.abs(raw - g.eval_scores(0)).max())
        if d_live > 1e-4:
            raise AssertionError(f"[efb]: predict differs from the live "
                                 f"valid scores by {d_live}")
        del bst, g
        n_it = 5
        out = phase_step(lgt, CH, [
            ("covtype EFB class-batched", tr, p, n_it, (True, False)),
            ("covtype EFB per-class", tr, dict(p, class_batch="off"), 3,
             (True, False)),
            ("covtype EFB quantized class-batched", tr, dict(p, **QUANT),
             n_it, (True, False)),
        ], tag="[efb]")
    finally:
        CH.build_histograms_cuda = b1
    for name, per, int8 in (("covtype EFB class-batched", per_tree, False),
                            ("covtype EFB per-class", per_tree * NUM_CLASS,
                             False),
                            ("covtype EFB quantized class-batched", per_tree,
                             True)):
        for _, r in out[name]:
            n_done = len(r["trees"]) // NUM_CLASS - 1
            expect_launches("[efb]", name, r,
                            {"build_histograms_cuda": per * n_done}, int8)
    if seen != {(G, Bb)}:
        raise AssertionError(f"[efb]: B1 launched over (columns, bins) "
                             f"{sorted(seen)}, want only {(G, Bb)}")
    log(f"[efb] every B1 launch over the bundled matrix: (columns, bins) "
        f"{sorted(seen)}; B2 and B3 launched 0 times")
    phase_mc_parity(lgt, X, y, 1 << 15, params=p, tag="[efb]", iters=1,
                    arms=(("card batched", {}, "cpu"),
                          ("cpu", {"device_type": "cpu"}, None)),
                    cpu_runs=cpu_runs)
    r = out["covtype EFB class-batched"][0][1]
    return dict(launches=r["launches"]["build_histograms_cuda"], ms=r["ms"],
                G=G, Bb=Bb)


def covtype_12(X):
    """Covertype's own 12-column form (covtype.info): the 10
    quantitative columns, then the Wilderness_Area (0-3) and Soil_Type
    (0-39) indices of the one-hot blocks."""
    import numpy as np
    return np.concatenate([X[:, :10], X[:, 10:14].argmax(1)[:, None],
                           X[:, 14:54].argmax(1)[:, None]],
                          1).astype(np.float32)


def phase_cat(lgt, CH, X, y, Xv, yv, results, cpu_runs=None):
    """``[cat]``: the Covertype rows in their 12-column form with the two
    categorical columns (``categorical_feature=[10, 11]``), class-batched:
    B3 at the root, B1 below (sorted-subset categoricals send the split
    search to the two-pass arm). B3 over these bins at full rows against
    its plain version; 20 iterations with valid multi_logloss; captured
    against eager at full size; card against CPU at 2^14 rows."""
    import numpy as np
    import torch
    from lightgbm_tpu_torch.boosting.tree_builder import max_rounds_for
    p = dict(EFB_PARAMS)
    rounds = max_rounds_for(p["num_leaves"], p["leaf_batch"])
    X12, Xv12 = covtype_12(X), covtype_12(Xv)
    t0 = time.perf_counter()
    tr = lgt.Dataset(X12, label=y, params=p, categorical_feature=CAT_COLUMNS)
    va = lgt.Dataset(Xv12, label=yv, reference=tr)
    tr.construct()
    va.construct()
    nb = tr.per_feature_num_bins()
    t1 = time.perf_counter()
    # B3 at this root: K=7, F=12, B as the 12-column Dataset bins it
    bins, rl0, R = root_inputs(tr.bins)
    B = tr.max_num_bin
    gh = {"f": mc_gradients(torch.from_numpy(y).to("cuda"), R)}
    gh["q"] = int8_gh(gh["f"])
    errs = against_plain(
        "[cat] B3",
        lambda kind, hd: CH.build_root_histograms_classes(
            bins, gh[kind], rl0, num_bins=B, hist_dtype=hd),
        lambda kind, hd: CH.build_root_histograms_classes_plain(
            bins, gh[kind], rl0, num_bins=B, hist_dtype=hd))
    log(f"[cat] B3 root K={NUM_CLASS} R={R} F={bins.shape[1]} B={B} "
        f"max_abs_err vs plain bf16 {errs['bf16']:.3g} f32 "
        f"{errs['f32']:.3g} int8 exact; deterministic=True; plan "
        f"{CH.class_mma_plan(bins.shape[1], NUM_CLASS, B, R, 'bfloat16')}")
    results["B3"]["cat_max_abs_err"] = errs["bf16"]
    del bins, rl0, gh
    hist = {}
    CH.reset_launch_counts()
    t1 = time.perf_counter()
    bst = lgt.train(p, tr, 20, valid_sets=[va], valid_names=["valid"],
                    callbacks=[lgt.record_evaluation(hist)])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t1
    g = bst._gbdt
    csm = g._cat_sorted_mask
    log(f"[cat] Dataset {tr.num_data} + {va.num_data} rows x "
        f"{tr.num_features} (categorical columns {CAT_COLUMNS}: "
        f"{nb[CAT_COLUMNS[0]]} and {nb[CAT_COLUMNS[1]]} bins) in "
        f"{t1 - t0:.1f} s; B={tr.max_num_bin}; sorted-subset features "
        f"{[] if csm is None else np.nonzero(csm.cpu().numpy())[0].tolist()};"
        f" bundled: {tr.bundle_plan is not None}")
    if csm is None or not bool(csm[CAT_COLUMNS[1]]):
        raise AssertionError("[cat]: Soil_Type is not on the sorted path")
    if g.fused_split_reason != \
            "sorted-subset categoricals reorder histogram bins":
        raise AssertionError(f"[cat]: fused gate {g.fused_split_reason!r}")
    launches = dict(CH.LAUNCHES)
    want = {"build_histograms_cuda": rounds * 20,
            "fused_build_best_splits": 0,
            "build_root_histograms_classes": 20}
    if launches != want:
        raise AssertionError(f"[cat]: launches {launches}, want {want}")
    lls = hist["valid"]["multi_logloss"]
    multi = [t.num_cat for t in bst._trees]
    words = sum(len(t.cat_threshold) for t in bst._trees)
    log(f"[cat] class-batched 20 iterations with valid multi_logloss in "
        f"{wall:.2f} s ({wall / 20 * 1e3:.1f} ms/iteration); launches "
        f"{launches}; categorical splits {sum(multi)} in {len(multi)} trees "
        f"({words} bitset words); valid multi_logloss per iteration: "
        + " ".join(f"{v:.5f}" for v in lls))
    if not (all(np.isfinite(lls)) and lls[-1] < lls[0]) or sum(multi) == 0:
        raise AssertionError("[cat]: no categorical split, or valid "
                             "multi_logloss did not fall")
    del bst, g
    out = phase_step(lgt, CH, [("covtype categorical class-batched", tr, p,
                                5, (True, False))], tag="[cat]")
    for _, r in out["covtype categorical class-batched"]:
        n_done = len(r["trees"]) // NUM_CLASS - 1
        expect_launches("[cat]", "class-batched", r,
                        {"build_histograms_cuda": rounds * n_done,
                         "build_root_histograms_classes": n_done})
    phase_mc_parity(lgt, covtype_12(X), y, 1 << 15, params=p, tag="[cat]",
                    iters=1, ds_kw=dict(categorical_feature=CAT_COLUMNS),
                    arms=(("card batched", {}, "cpu"),
                          ("cpu", {"device_type": "cpu"}, None)),
                    cpu_runs=cpu_runs)
    return out["covtype categorical class-batched"][0][1]["ms"]


SERVE_LADDER = (16, 32, 64, 128, 256, 512, 1024)
SERVE_ROWS_PER_REQ = 16


def http_burst(port, body, rows_per_req, clients, reqs_each, on_resp=None):
    """``reqs_each`` sequential requests from each of ``clients``
    keep-alive connections against /predict (bench.py's _http_burst);
    returns (rows/s, p99 ms, errors)."""
    import http.client
    import threading
    import numpy as np
    lat, errors = [], []
    lock = threading.Lock()

    def client():
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
        try:
            for _ in range(reqs_each):
                t0 = time.perf_counter()
                conn.request("POST", "/predict", body=body, headers={
                    "Content-Type": "application/x-npy"})
                r = conn.getresponse()
                data = r.read()
                dt = time.perf_counter() - t0
                if r.status != 200:
                    raise RuntimeError(f"status {r.status}: {data[:200]}")
                with lock:
                    lat.append(dt)
                if on_resp is not None:
                    on_resp(data)
        except Exception as e:  # noqa: BLE001 — counted, and fails the phase
            with lock:
                errors.append(f"{type(e).__name__}: {e}")
        finally:
            conn.close()

    threads = [threading.Thread(target=client) for _ in range(clients)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    wall = time.perf_counter() - t0
    rps = len(lat) * rows_per_req / wall
    p99 = float(np.percentile(lat, 99)) * 1e3 if lat else float("nan")
    return rps, p99, errors


def device_launches(fn):
    """(kernels, copies, device ms) the card ran during one call of
    ``fn``, from torch.profiler's device events (device ms: the sum of
    their durations); (None, None, None) when the profiler records no
    device activity. The port's ``start_profile`` keeps CUPTI attached
    after the window, so that its teardown cannot land in a later
    phase's graph capture."""
    import torch
    from lightgbm_tpu_torch.profiler import start_profile
    torch.cuda.synchronize()
    prof = start_profile(cuda=True)
    try:
        fn()
        torch.cuda.synchronize()
    finally:
        prof.stop()
    ev = [e for e in prof.events()
          if e.device_type == torch.autograd.DeviceType.CUDA]
    if not ev:
        return None, None, None
    copies = sum(1 for e in ev if e.name.startswith(("Memcpy", "Memset")))
    busy = sum(e.time_range.elapsed_us() for e in ev) / 1e3
    return len(ev) - copies, copies, busy


def serve_card_vs_cpu(lgt, tag, path, X, shap_rows=0):
    """(a): the card's pred_leaf, CompiledEnsemble and session against a
    device_type="cpu" load of the same file; (b) with ``shap_rows``:
    pred_contrib's local accuracy (host TreeSHAP: ~0.3 s a 255-leaf tree
    at 256 rows, so Higgs's 20 trees and not Covertype's 140)."""
    import numpy as np
    from lightgbm_tpu_torch.codegen import CompiledEnsemble
    card = lgt.Booster(model_file=path)
    cpu = lgt.Booster(model_file=path, params={"device_type": "cpu"})
    t0 = time.perf_counter()
    leaf = card.predict(X, pred_leaf=True)
    if not np.array_equal(leaf, cpu.predict(X, pred_leaf=True)):
        raise AssertionError(f"[serve] {tag}: pred_leaf differs card/CPU")
    ce_card, ce_cpu = CompiledEnsemble(card), CompiledEnsemble(cpu)
    if not np.array_equal(ce_card.predict_leaf(X), ce_cpu.predict_leaf(X)):
        raise AssertionError(f"[serve] {tag}: CompiledEnsemble leaves "
                             "differ card/CPU")
    if not np.array_equal(ce_card.predict(X), ce_cpu.predict(X)):
        raise AssertionError(f"[serve] {tag}: CompiledEnsemble.predict "
                             "is not bit-equal card/CPU")
    dev_err = float(np.abs(ce_card.predict_device(X)
                           - ce_card.predict(X)).max())
    errs = {}
    for name, kw in (("session", {"raw_score": True}),
                     ("early stop", {"raw_score": True,
                                     "pred_early_stop": True,
                                     "pred_early_stop_freq": 2,
                                     "pred_early_stop_margin": 1.0})):
        a = card.predict_session(**kw).predict(X)
        b = cpu.predict_session(**kw).predict(X)
        errs[name] = float(np.abs(a - b).max())
        if not (errs[name] <= 1e-12 and np.isfinite(a).all()):
            raise AssertionError(f"[serve] {tag}: {name} card/CPU differ "
                                 f"by {errs[name]}")
    log(f"[serve] {tag} {len(X)} rows x {card.num_trees()} trees (depth "
        f"{ce_card.depth}): pred_leaf and CompiledEnsemble leaves equal "
        f"card/CPU, CompiledEnsemble.predict bit-equal; session |card - "
        f"cpu| {errs['session']:.2e}, early stop {errs['early stop']:.2e}; "
        f"predict_device (f32 sums) vs predict {dev_err:.2e}; compared in "
        f"{time.perf_counter() - t0:.1f} s")
    if shap_rows:
        t0 = time.perf_counter()
        Xs = X[:shap_rows]
        contrib = card.predict(Xs, pred_contrib=True)
        raw = card.predict(Xs, raw_score=True).reshape(len(Xs), -1)
        K = raw.shape[1]
        acc = float(np.abs(contrib.reshape(len(Xs), K, -1).sum(axis=2)
                           - raw).max())
        if not acc <= 1e-9:
            raise AssertionError(f"[serve] {tag}: pred_contrib rows miss "
                                 f"the raw score by {acc}")
        log(f"[serve] {tag} pred_contrib on {len(Xs)} rows: local accuracy "
            f"{acc:.2e} in {time.perf_counter() - t0:.1f} s")
    return card, ce_card


def serve_rungs(tag, ce, X):
    """ms per CompiledEnsemble.predict call at each ladder rung, and the
    launches of one call."""
    import numpy as np
    out = {}
    for r in SERVE_LADDER:
        Z = np.ascontiguousarray(X[:r])
        ce.predict(Z)                                 # warm
        reps = 20
        t0 = time.perf_counter()
        for _ in range(reps):
            ce.predict(Z)
        ms = (time.perf_counter() - t0) / reps * 1e3
        out[r] = (ms,) + device_launches(lambda: ce.predict(Z))
    log(f"[serve] {tag} CompiledEnsemble.predict by rung (rows: ms/call, "
        f"kernels + copies a call, their device ms): " + "; ".join(
            f"{r}: {ms:.2f}, {k} + {c}, "
            + ("not measured" if d is None else f"{d:.3f}")
            for r, (ms, k, c, d) in out.items()))
    return out


def phase_serve(lgt, CH, higgs_bst, Xv, mc_bst, Xcv):
    """[serve]: the predict and serving path on the card (phase 17)."""
    import io
    import threading
    import numpy as np
    import torch
    from lightgbm_tpu_torch.serving import PredictionServer
    t_phase = time.perf_counter()
    out_dir = os.path.join(HERE, "build", "chip_smoke")
    os.makedirs(out_dir, exist_ok=True)
    full = os.path.join(out_dir, "serve_higgs.txt")
    half = os.path.join(out_dir, "serve_higgs_10.txt")
    mc = os.path.join(out_dir, "serve_covtype.txt")
    higgs_bst.save_model(full)
    higgs_bst.save_model(half, num_iteration=10)
    mc_bst.save_model(mc)
    CH.reset_launch_counts()
    n_cmp = 1 << 14
    card, ce = serve_card_vs_cpu(lgt, "higgs", full, Xv[:n_cmp],
                                 shap_rows=64)
    _, ce_mc = serve_card_vs_cpu(lgt, "covtype", mc, Xcv[:n_cmp])
    rungs = serve_rungs("higgs", ce, Xv)
    serve_rungs("covtype", ce_mc, Xcv)

    base = reset_peak()
    t0 = time.perf_counter()
    card.predict(Xv)
    secs = time.perf_counter() - t0
    log(f"[serve] Booster.predict on {len(Xv)} Higgs valid rows: "
        f"{len(Xv) / secs:.4g} rows/s ({secs * 1e3:.1f} ms); peak device "
        f"memory above the start {(torch.cuda.max_memory_allocated() - base) / 2**20:.1f} MiB")
    base = reset_peak()
    mc_card = lgt.Booster(model_file=mc)
    t0 = time.perf_counter()
    mc_card.predict(Xcv)
    secs = time.perf_counter() - t0
    log(f"[serve] Booster.predict on {len(Xcv)} Covertype valid rows x "
        f"{mc_card.num_trees()} trees: {len(Xcv) / secs:.4g} rows/s; peak "
        f"device memory above the start "
        f"{(torch.cuda.max_memory_allocated() - base) / 2**20:.1f} MiB")

    # (c) bench.py's serve_bench / fleet_bench traffic
    Xq = np.ascontiguousarray(Xv[:SERVE_ROWS_PER_REQ], np.float64)
    buf = io.BytesIO()
    np.save(buf, Xq)
    body = buf.getvalue()
    exp1 = lgt.Booster(model_file=full).predict_session().predict(Xq)
    exp2 = lgt.Booster(model_file=half).predict_session().predict(Xq)
    if np.allclose(exp1, exp2):
        raise AssertionError("[serve] the 10-iteration model predicts as "
                             "the full one: the swap would be invisible")
    base = reset_peak()
    srv = PredictionServer(port=0, max_batch_rows=1024, max_wait_us=2000)
    try:
        srv.registry.register("default", full)
        port = srv.start()
        first = []
        http_burst(port, body, SERVE_ROWS_PER_REQ, 2, 3,
                   on_resp=lambda d: first.append(np.load(io.BytesIO(d))))
        if not all(np.array_equal(g, exp1) for g in first):
            raise AssertionError("[serve] HTTP npy answer is not bit-equal "
                                 "to the session")
        stats = {}
        for clients in (1, 8, 64):
            reqs = max(8, 128 // clients)
            b0, r0 = srv.metrics.batches_total.value, srv.metrics.rows_total.value
            rps, p99, errors = http_burst(port, body, SERVE_ROWS_PER_REQ,
                                          clients, reqs)
            nb = srv.metrics.batches_total.value - b0
            mean_rows = (srv.metrics.rows_total.value - r0) / max(nb, 1)
            stats[clients] = (rps, p99)
            log(f"[serve] session server, {clients} clients x {reqs} "
                f"requests of {SERVE_ROWS_PER_REQ} rows: {rps:.0f} rows/s, "
                f"p99 {p99:.2f} ms, mean batch {mean_rows:.1f} rows")
            if errors:
                raise AssertionError(f"[serve] {len(errors)} failed "
                                     f"requests: {errors[:3]}")
        mixed = [0]

        def check(data):
            got = np.load(io.BytesIO(data))
            if not (np.array_equal(got, exp1) or np.array_equal(got, exp2)):
                mixed[0] += 1

        swap_err = []

        def swapper():
            import http.client
            time.sleep(0.15)
            try:
                conn = http.client.HTTPConnection("127.0.0.1", port,
                                                  timeout=120)
                conn.request("POST", "/models/swap", body=json.dumps(
                    {"name": "default", "file": half}).encode())
                r = conn.getresponse()
                r.read()
                if r.status != 200:
                    swap_err.append(f"swap status {r.status}")
                conn.close()
            except Exception as e:  # noqa: BLE001 — fails the phase below
                swap_err.append(repr(e))

        sw = threading.Thread(target=swapper)
        sw.start()
        _, _, errors = http_burst(port, body, SERVE_ROWS_PER_REQ, 8, 32,
                                  on_resp=check)
        sw.join()
        version = srv.registry.resolve("default").version
        log(f"[serve] mid-burst /models/swap to the 10-iteration model, 8 "
            f"clients x 32 requests: {len(errors)} failed, {mixed[0]} mixed "
            f"results, active version {version}; mean batch over the run "
            f"{srv.metrics.mean_batch_rows():.1f} rows in "
            f"{srv.metrics.batches_total.value} batches; peak device memory "
            f"above the start "
            f"{(torch.cuda.max_memory_allocated() - base) / 2**20:.1f} MiB")
        if errors or mixed[0] or swap_err or version != 2:
            raise AssertionError(f"[serve] swap probe: {errors[:3]} "
                                 f"{mixed[0]} mixed {swap_err}")
    finally:
        srv.stop()
    for replicas in (1, 2):
        srv = PredictionServer(port=0, max_batch_rows=1024, max_wait_us=2000,
                               compiled_predict=True, replicas=replicas)
        try:
            mv = srv.registry.register("default", full)
            if mv.compiled is None:
                raise AssertionError(f"[serve] no CompiledEnsemble: "
                                     f"{mv.compiled_fallback}")
            want = mv.compiled.predict(Xq)
            port = srv.start()
            got = []
            http_burst(port, body, SERVE_ROWS_PER_REQ, 2, 3,
                       on_resp=lambda d: got.append(np.load(io.BytesIO(d))))
            if not all(np.array_equal(g, want) for g in got):
                raise AssertionError("[serve] the compiled fleet's answer "
                                     "differs from its CompiledEnsemble")
            rps, p99, errors = http_burst(port, body, SERVE_ROWS_PER_REQ,
                                          64, 4)
            log(f"[serve] compiled_predict replicas={replicas} on "
                f"{sorted({str(r.device) for r in mv.replicas.replicas})}, "
                f"64 clients x 4 requests: {rps:.0f} rows/s, p99 "
                f"{p99:.2f} ms, mean batch "
                f"{srv.metrics.mean_batch_rows():.1f} rows")
            if errors:
                raise AssertionError(f"[serve] {len(errors)} failed "
                                     f"requests: {errors[:3]}")
        finally:
            srv.stop()
    launches = dict(CH.LAUNCHES)
    if any(launches.values()):
        raise AssertionError(f"[serve] the serving path launched "
                             f"histogram kernels: {launches}")
    log(f"[serve] B1/B2/B3 launches during [serve]: {launches} (the "
        f"serving path runs none of them); phase took "
        f"{time.perf_counter() - t_phase:.1f} s")
    return dict(rungs=rungs, http=stats)


# -- the ranking, DART and RF paths --------------------------------------
def mslr_sizes(rng, nq, total=None, s_max=MSLR_MAX_QUERY):
    """``nq`` query sizes from a skewed (log-normal) draw with MS LTR's
    mean (~120 documents), clipped to [1, s_max]; at least one query
    is exactly ``s_max`` wide, and with ``total`` the sizes are nudged
    one document at a time until they sum to it."""
    import numpy as np
    mean = MSLR_ROWS / MSLR_QUERIES
    s = rng.lognormal(0.0, 0.7, size=nq)
    s = np.clip(np.round(s / s.mean() * mean), 1, s_max).astype(np.int64)
    widest = rng.randint(nq)
    s[widest] = s_max
    while total is not None and int(s.sum()) != total:
        d = total - int(s.sum())
        idx = rng.choice(nq, size=min(abs(d), nq), replace=False)
        idx = idx[idx != widest]
        s[idx] = np.clip(s[idx] + np.sign(d), 1, s_max)
    return s


def make_mslr_like(seed=17):
    """MS LTR-shaped synthetic data (MSLR-WEB30K as BASELINE.md gives
    it): 2,270,296 rows x 137 dense continuous features in 18,919
    queries (:func:`mslr_sizes`, the widest 1,251 documents), and a
    valid set of 1,000 more queries drawn the same way. Relevance labels
    0-4, mostly 0 and 1 (shares ~0.52 / 0.32 / 0.12 / 0.03 / 0.01, as
    in the real file), rising with four of the features and a
    per-query offset. Returns (X, y, sizes, Xv, yv, valid sizes)."""
    import numpy as np
    rng = np.random.RandomState(seed)
    sizes = mslr_sizes(rng, MSLR_QUERIES, MSLR_ROWS)
    vsizes = mslr_sizes(rng, MSLR_VALID_QUERIES)
    all_sizes = np.concatenate([sizes, vsizes])
    n = int(all_sizes.sum())
    g = np.random.default_rng(seed)
    X = g.standard_normal((n, MSLR_FEATURES), dtype=np.float32)
    # columns on the real file's mixed scales (counts, tf-idf, BM25, ...)
    X *= np.exp(g.uniform(0, 6, MSLR_FEATURES)).astype(np.float32)
    qoff = g.standard_normal(len(all_sizes), dtype=np.float32)
    z = X[:, :4] / X[:, :4].std(axis=0)
    r = (0.9 * z[:, 0] + 0.6 * z[:, 1] + 0.4 * np.tanh(z[:, 2] * z[:, 3])
         + 0.6 * np.repeat(qoff, all_sizes)
         + 0.8 * g.standard_normal(n, dtype=np.float32))
    y = np.digitize(r, np.quantile(r, [0.52, 0.84, 0.96, 0.99])).astype(
        np.float32)
    k = MSLR_ROWS
    return X[:k], y[:k], sizes, X[k:], y[k:], vsizes


def per_tree(params):
    """Histogram launches a tree: the root and one a round (17 at 255
    leaves, leaf_batch 21)."""
    from lightgbm_tpu_torch.boosting.tree_builder import max_rounds_for
    return 1 + max_rounds_for(params["num_leaves"], params["leaf_batch"])


def rank_plan_line(obj):
    """The bucket plan of a ranking objective: buckets, queries and
    chunks per width, and the largest [Q_c, S_b, S_b] f32 temporary."""
    from collections import Counter
    from lightgbm_tpu_torch.ranking import LATTICE_BUDGET_BYTES
    chunks, queries, pairs = Counter(), Counter(), 0
    big = 0
    single = obj.num_queries * obj.max_query ** 2 * 4
    for c in obj.chunks:
        q, w = c.rows.shape
        chunks[w] += 1
        queries[w] += q
        pairs += q * w * w
        big = max(big, q * w * w * 4)
    return ("widths " + ", ".join(f"{w}: {queries[w]} queries in "
                                   f"{chunks[w]} chunks"
                                   for w in sorted(chunks))
            + f"; {pairs / 1e9:.3f}G pairwise lanes; largest f32 "
            f"temporary {big / 2**20:.1f} MiB (budget "
            f"{LATTICE_BUDGET_BYTES / 2**20:.0f} MiB; one [Q, S_max, S_max]"
            f" lattice would take {single / 1e9:.1f} GB)"), big


def phase_b2_rank(tr, CH, SP, H, g, h, results):
    """B2 at the MS LTR-shaped ranking cell's calls (F = 137, B = 255):
    the root (2W slots, slot 0 live) and a compacted child call (every
    row in one of 2W leaves at random, leaves 0..W-1 the smaller
    children), with lambdarank's iteration-0 gradients, against the
    plain version; then timed. B1 at the same two calls likewise, with
    index_add_ beside it."""
    import torch
    bins = tr.bins
    dev = bins.device
    R, F = bins.shape
    B = tr.max_num_bin
    gh = torch.stack([g, h, torch.ones_like(g)], 1).contiguous()
    W = RANK_PARAMS["leaf_batch"]
    root_ids = torch.full((2 * W,), -2, dtype=torch.int32, device=dev)
    root_ids[0] = 0
    rl0 = torch.zeros(R, dtype=torch.int32, device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    rl = torch.randint(0, 2 * W, (R,), generator=gen, device=dev,
                       dtype=torch.int32)
    small = torch.arange(W, dtype=torch.int32, device=dev)
    c_idx, rl_c, n_small = compact(rl, small, R)
    fk = dict(num_bins_pf=torch.from_numpy(
                  tr.per_feature_num_bins()).to(dev),
              nan_bin_pf=torch.from_numpy(tr.per_feature_nan_bins()).to(dev),
              is_cat_pf=torch.from_numpy(
                  tr.per_feature_is_categorical()).to(dev),
              feature_mask=torch.ones(F, dtype=torch.bool, device=dev))
    sp = SP.SplitParams(min_data_in_leaf=float(RANK_PARAMS[
        "min_data_in_leaf"]))
    rows = {"root": R, "child": int(n_small)}
    errs = []
    for cname, ids, rlx, kw in (
            ("root", root_ids, rl0, {}),
            ("child", small, rl_c, dict(row_gather=c_idx,
                                        num_rows=n_small))):
        L = ids.shape[0]
        ghs = gh if cname == "root" else gh[c_idx.long()].contiguous()

        def run(fn):
            return lambda: fn(bins, ghs, rlx, ids, num_bins=B, params=sp,
                              emit_hist=True, **kw, **fk)
        bk, hk = run(CH.fused_build_best_splits)()
        bp, hp = run(CH.fused_build_best_splits_plain)()
        torch.cuda.synchronize()
        err, flips = compare_best(f"B2 rank {cname}", bk, bp)
        herr = check_close(f"B2 rank {cname} hist", hk, hp, 1e-4)
        errs.append(err)
        ms = cuda_ms(run(CH.fused_build_best_splits), 10)
        plain_ms = cuda_ms(run(CH.fused_build_best_splits_plain), 2)
        bound, by = bound_of(hist_bytes(rows[cname], F, 12, cname == "child",
                                        L, B),
                             3 * rows[cname] * F + 2 * L * F * B * 60)
        log(f"[rank] [B2] {cname:5s} rows={rows[cname]} F={F} B={B} L={L}: "
            f"gain max_abs_err={err:.3g} near-tie flips={flips}, hist max "
            f"abs err {herr:.3g}; {ms:.3f} ms (bound {bound:.3f} ms by {by};"
            f" plain {plain_ms:.3f} ms)")
        results["B2"]["rank_" + cname] = dict(
            ms=ms, plain_ms=plain_ms, library_ms=None, bound_ms=bound,
            bound_by=by, rows=rows[cname], L=L, F=F, B=B)
    results["B2"]["rank_max_abs_err"] = max(errs)
    # B1 (the two-pass arm's accumulation) at the same two calls:
    # against its plain version, deterministic, timed beside index_add_
    b1_errs = []
    for cname, ids, rlx, kw in (
            ("root", root_ids, rl0, {}),
            ("child", small, rl_c, dict(row_gather=c_idx,
                                        num_rows=n_small))):
        L = ids.shape[0]
        ghs = gh if cname == "root" else gh[c_idx.long()].contiguous()
        args = (bins, ghs, rlx, ids)
        k1 = CH.build_histograms_cuda(*args, num_bins=B, **kw)
        k2 = CH.build_histograms_cuda(*args, num_bins=B, **kw)
        pl = H.build_histograms(*args, num_bins=B, **kw)
        torch.cuda.synchronize()
        if not torch.equal(k1, k2):
            raise AssertionError(f"[rank] B1 {cname}: two launches differ")
        b1_errs.append(check_close(f"[rank] B1 {cname}", k1, pl, 1e-4))
        del k1, k2, pl
        ms = cuda_ms(lambda: CH.build_histograms_cuda(*args, num_bins=B,
                                                      **kw), 10)
        plain_ms = cuda_ms(lambda: H.build_histograms(*args, num_bins=B,
                                                      **kw), 2)
        lib_ms = index_add_ms(bins, ghs, rlx, ids, B, rows[cname],
                              kw.get("row_gather"))
        bound, by = bound_of(hist_bytes(rows[cname], F, 12,
                                        cname == "child", L, B),
                             3 * rows[cname] * F)
        log(f"[rank] [B1] {cname:5s} rows={rows[cname]} F={F} B={B} L={L}: "
            f"max_abs_err={b1_errs[-1]:.3g} deterministic=True; {ms:.3f} ms"
            f" (bound {bound:.3f} ms by {by}; plain {plain_ms:.3f} ms; "
            f"index_add_ {lib_ms:.3f} ms)")
        results["B1"]["rank_" + cname] = dict(
            ms=ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bound,
            bound_by=by, rows=rows[cname], L=L, F=F, B=B)
    results["B1"]["rank_max_abs_err"] = max(b1_errs)


def phase_rank(lgt, CH, SP, H, results):
    """``[rank]``: the MS LTR-shaped lambdarank cell through the captured
    step, with B2 at F = 137, B = 255."""
    import numpy as np
    import torch
    t_phase = time.perf_counter()
    t0 = time.perf_counter()
    X, y, sizes, Xv, yv, vsizes = make_mslr_like()
    log(f"[rank] MS LTR-shaped {len(y)} rows x {X.shape[1]} in {len(sizes)} "
        f"queries (sizes {sizes.min()}-{sizes.max()}, mean "
        f"{sizes.mean():.1f}, {int((sizes == MSLR_MAX_QUERY).sum())} at "
        f"{MSLR_MAX_QUERY}) + valid {len(yv)} rows in {len(vsizes)} queries "
        f"made in {time.perf_counter() - t0:.1f} s; label shares "
        + " ".join(f"{v:.3f}" for v in np.bincount(y.astype(np.int64),
                                                   minlength=5) / len(y)))
    t0 = time.perf_counter()
    tr = lgt.Dataset(X, label=y, group=sizes, params=dict(RANK_PARAMS))
    va = lgt.Dataset(Xv, label=yv, group=vsizes, reference=tr)
    tr.construct()
    va.construct()
    B = tr.max_num_bin
    log(f"[rank] binned in {time.perf_counter() - t0:.1f} s: F="
        f"{tr.num_features}, B={B}, EFB bundles "
        f"{'none' if tr.bundle_plan is None else tr.bundle_plan.num_bundles}")
    if tr.bundle_plan is not None or tr.num_features != MSLR_FEATURES:
        raise AssertionError("[rank]: dense columns must form no bundle")
    # the lambdarank gradients at iteration 0 (all scores tied), timed
    bst = lgt.Booster(params=dict(RANK_PARAMS), train_set=tr)
    bst._ensure_gbdt()
    g0 = bst._gbdt
    line, big = rank_plan_line(g0.objective)
    log(f"[rank] bucket plan: {line}")
    from lightgbm_tpu_torch.ranking import LATTICE_BUDGET_BYTES
    if big > LATTICE_BUDGET_BYTES:
        raise AssertionError("[rank]: a lattice temporary exceeds the budget")
    g, h = g0._grads(g0.scores)
    base = reset_peak()
    grad_ms = cuda_ms(lambda: g0._grads(g0.scores), 3)
    grad_peak = torch.cuda.max_memory_allocated() - base
    n = tr.num_data
    if not (torch.isfinite(g).all() and torch.isfinite(h).all()):
        raise AssertionError("[rank]: gradients are not finite")
    phase_b2_rank(tr, CH, SP, H, g[0, :n].contiguous(),
                  h[0, :n].contiguous(), results)
    del bst, g0, g, h
    torch.cuda.empty_cache()

    # 20 iterations through the captured step, valid NDCG@10 each one
    hist = {}
    base = reset_peak()
    CH.reset_launch_counts()
    t0 = time.perf_counter()
    bst = lgt.train(dict(RANK_PARAMS), tr, 20, valid_sets=[va],
                    valid_names=["valid"],
                    callbacks=[lgt.record_evaluation(hist)])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(CH.LAUNCHES)
    peak = torch.cuda.max_memory_allocated() - base
    nd = hist["valid"]["ndcg@10"]
    gb = bst._gbdt
    log(f"[rank] lambdarank: 20 iterations with valid NDCG@10 every "
        f"iteration in {wall:.2f} s ({wall / 20 * 1e3:.1f} ms/iteration "
        f"incl. host NDCG on {len(yv)} rows); captured "
        f"{gb._graph is not None}; peak device memory above the start "
        f"{peak / 2**30:.2f} GiB; launches {launches} "
        f"({launches['fused_build_best_splits'] / 20:.1f} B2 a tree)")
    log("[rank] valid NDCG@10 per iteration: "
        + " ".join(f"{v:.5f}" for v in nd))
    if gb._graph is None or not gb.fused_split_ok:
        raise AssertionError("[rank]: lambdarank did not run the captured "
                             "step with B2")
    k = per_tree(RANK_PARAMS)
    if launches != {"build_histograms_cuda": 0,
                    "fused_build_best_splits": k * 20,
                    "build_root_histograms_classes": 0}:
        raise AssertionError(f"[rank]: launches {launches}, expected {k} "
                             "B2 launches a tree")
    if not (all(np.isfinite(nd)) and nd[-1] > nd[0] + 0.01):
        raise AssertionError("[rank]: valid NDCG@10 is not rising")
    g = bst._gbdt
    grad_ms_late = cuda_ms(lambda: g._grads(g.scores), 3)
    del bst, g, gb
    torch.cuda.empty_cache()
    bx = lgt.Booster(params=dict(RANK_PARAMS, objective="rank_xendcg"),
                     train_set=tr)
    bx._ensure_gbdt()
    gx = bx._gbdt
    xe_ms = cuda_ms(lambda: gx._grads(gx.scores), 3)
    del bx, gx
    torch.cuda.empty_cache()
    log(f"[rank] gradient device ms (CUDA events): lambdarank "
        f"{grad_ms:.2f} at iteration 0 (all tied), {grad_ms_late:.2f} "
        f"after 20 iterations; rank_xendcg {xe_ms:.2f} (its [Q, S_max] "
        f"draw of {len(sizes) * int(sizes.max())} included); peak memory "
        f"of one gradient call {grad_peak / 2**30:.2f} GiB")

    # captured against eager: bit-identical, the captured iterations
    # under the sync debug mode
    step = phase_step(lgt, CH, [
        ("mslr lambdarank", tr, RANK_PARAMS, 5, (True, False),
         dict(debug=True)),
        ("mslr rank_xendcg", tr, dict(RANK_PARAMS, objective="rank_xendcg"),
         2, (True, False), dict(debug=True)),
        ("mslr bagging_by_query", tr,
         dict(RANK_PARAMS, bagging_freq=1, bagging_fraction=0.5,
              bagging_by_query=True), 2, (True, False), dict(debug=True)),
        ("mslr B1", tr, dict(RANK_PARAMS, fused_split="off"), 2,
         (True, False)),
    ], tag="[rank]")
    cap = step["mslr lambdarank"][0][1]
    expect_launches("[rank]", "mslr lambdarank", cap,
                    {"fused_build_best_splits": k * 5})
    b1 = step["mslr B1"][0][1]
    expect_launches("[rank]", "mslr B1", b1, {"build_histograms_cuda": k * 2})

    # position bias: eager, 10 position ids
    pos = np.concatenate([np.arange(s) % 10 for s in sizes])
    tr.set_field("position", pos)
    try:
        bp = lgt.Booster(params=dict(RANK_PARAMS), train_set=tr)
        facs = []
        t0 = time.perf_counter()
        for _ in range(3):
            bp.update()
            facs.append(bp._gbdt.objective.pos_biases.cpu().numpy().copy())
        ms_pb = (time.perf_counter() - t0) / 3 * 1e3
        reason = bp._gbdt.fused_train_reason
    finally:
        tr.set_field("position", None)
    del bp
    torch.cuda.empty_cache()
    log(f"[rank] position bias (10 ids), eager ({reason!r}): "
        f"{ms_pb:.1f} ms/iteration; factors after iterations 1 and 3: "
        + " ".join(f"{v:.4f}" for v in facs[0]) + " | "
        + " ".join(f"{v:.4f}" for v in facs[-1]))
    if reason != "position-bias estimation updates host state":
        raise AssertionError(f"[rank]: position bias ran {reason!r}")
    if not (np.isfinite(facs).all() and facs[0].shape == (10,)
            and np.abs(facs[-1] - facs[0]).max() > 0):
        raise AssertionError("[rank]: position-bias factors are not finite "
                             "or do not change")
    log(f"[rank] phase took {time.perf_counter() - t_phase:.1f} s")
    return dict(launches=cap["launches"], b1_launches=b1["launches"],
                data=(X, y, sizes, Xv, yv, vsizes), ms=cap["ms"])


def mode_auc(bst, yv):
    """The valid AUC of a booster's live valid scores."""
    return mode_auc_of(bst._gbdt.eval_scores(0)[:, 0], yv)


def phase_dart(lgt, CH, tr, va, Xv, yv):
    """``[dart]``: DART on the Higgs-shaped model at 10.5M rows, at its
    defaults (DART_ITERS iterations) and in xgboost mode (5), through the
    eager
    loop with B2; each dropped tree replayed over the train and valid
    rows."""
    import numpy as np
    import torch
    out = {}
    for name, extra, iters in (("defaults", {}, DART_ITERS),
                               ("xgboost_dart_mode",
                                {"xgboost_dart_mode": True}, 5)):
        bst = lgt.Booster(params=dict(DART_PARAMS, **extra), train_set=tr)
        bst.add_valid(va, "valid")
        bst._ensure_gbdt()
        g = bst._gbdt
        replay = [0.0, 0]
        orig = g._tree_preds

        def timed(it, orig=orig, replay=replay):
            torch.cuda.synchronize()
            t = time.perf_counter()
            r = orig(it)
            torch.cuda.synchronize()
            replay[0] += time.perf_counter() - t
            replay[1] += 1
            return r
        g._tree_preds = timed
        CH.reset_launch_counts()
        aucs, train_s = [], 0.0
        for _ in range(iters):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            bst.update()
            torch.cuda.synchronize()
            train_s += time.perf_counter() - t0
            aucs.append(mode_auc(bst, yv))
        launches = dict(CH.LAUNCHES)
        reason = g.fused_train_reason
        raw = bst.predict(Xv, raw_score=True)
        d_live = float(np.abs(raw - g.eval_scores(0)[:, 0]).max())
        log(f"[dart] {name}: {iters} iterations ({reason!r}) at "
            f"{train_s / iters * 1e3:.1f} ms/iteration (host AUC apart); "
            f"{replay[1]} dropped trees replayed over train + valid in "
            f"{replay[0] * 1e3:.1f} ms ({replay[0] / iters * 1e3:.1f} "
            f"ms/iteration); tree weights "
            + " ".join(f"{w:.4f}" for w in g._tree_weight)
            + f"; launches {launches}; |predict - live valid scores| "
            f"{d_live:.2e}")
        log(f"[dart] {name} valid AUC per iteration: "
            + " ".join(f"{a:.5f}" for a in aucs))
        if reason != "boosting mode overrides the iteration loop":
            raise AssertionError(f"[dart]: ran {reason!r}")
        if launches != {"build_histograms_cuda": 0,
                        "fused_build_best_splits": per_tree(PARAMS) * iters,
                        "build_root_histograms_classes": 0}:
            raise AssertionError(f"[dart]: launches {launches}")
        if not (np.isfinite(aucs).all() and aucs[-1] > aucs[0]):
            raise AssertionError("[dart]: valid AUC is not rising")
        if replay[1] == 0 and name == "defaults":
            raise AssertionError("[dart]: no tree was dropped")
        if d_live > 1e-4:
            raise AssertionError("[dart]: predict differs from the live "
                                 "valid scores")
        out[name] = dict(launches=launches, ms=train_s / iters * 1e3,
                         replay_ms=replay[0] / iters * 1e3)
        del bst, g
        torch.cuda.empty_cache()
    return out


def phase_rf(lgt, CH, tr, va, Xv, yv):
    """``[rf]``: RF on the Higgs-shaped model at 10.5M rows (bagging
    0.632 each iteration, feature_fraction 0.8): RF_ITERS iterations with
    the
    valid AUC of the averaged scores, a save/load round trip and the
    host bagging draw's seconds."""
    import numpy as np
    import torch
    bst = lgt.Booster(params=dict(RF_PARAMS), train_set=tr)
    bst.add_valid(va, "valid")
    bst._ensure_gbdt()
    g = bst._gbdt
    CH.reset_launch_counts()
    aucs, train_s = [], 0.0
    for _ in range(RF_ITERS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        bst.update()
        torch.cuda.synchronize()
        train_s += time.perf_counter() - t0
        aucs.append(mode_auc(bst, yv))
    launches = dict(CH.LAUNCHES)
    raw = bst.predict(Xv, raw_score=True)
    d_live = float(np.abs(raw - g.eval_scores(0)[:, 0]).max())
    out_dir = os.path.join(HERE, "build", "chip_smoke")
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, "rf.txt")
    bst.save_model(path)
    back = lgt.Booster(model_file=path)
    rt = float(np.abs(back.predict(Xv, raw_score=True) - raw).max())
    log(f"[rf] {RF_ITERS} iterations ({g.fused_train_reason!r}) at "
        f"{train_s / RF_ITERS * 1e3:.1f} ms/iteration (host AUC apart), of "
        f"which the host bagging draws "
        f"{g.bag_draw_seconds / RF_ITERS * 1e3:.1f} "
        f"ms/iteration; launches {launches}; average_output "
        f"{bst._average_output}; |predict - live valid scores| "
        f"{d_live:.2e}; save/load round trip max diff {rt}")
    log("[rf] valid AUC per iteration: " + " ".join(f"{a:.5f}"
                                                     for a in aucs))
    if launches != {"build_histograms_cuda": 0,
                    "fused_build_best_splits": per_tree(PARAMS) * RF_ITERS,
                    "build_root_histograms_classes": 0}:
        raise AssertionError(f"[rf]: launches {launches}")
    if not (np.isfinite(aucs).all() and max(aucs[1:]) > aucs[0]
            and aucs[-1] > aucs[0]):
        raise AssertionError("[rf]: valid AUC is not above the first "
                             "tree's")
    if not back._average_output or rt != 0.0 or d_live > 1e-4:
        raise AssertionError("[rf]: the averaged model does not round-trip")
    out = dict(launches=launches, ms=train_s / RF_ITERS * 1e3,
               bag_s=g.bag_draw_seconds)
    del bst, g, back
    torch.cuda.empty_cache()
    return out


def train_leg(lgt, p, iters, metric, trk, vak):
    """One leg of a ``[parity]`` check: ``iters`` iterations under ``p``
    on the train and valid Dataset kwargs ``trk``/``vak``; the trees,
    the last valid ``metric`` and the seconds."""
    tr = lgt.Dataset(**trk, params=p)
    va = lgt.Dataset(**vak, reference=tr)
    hist = {}
    t0 = time.perf_counter()
    bst = lgt.train(p, tr, iters, valid_sets=[va], valid_names=["v"],
                    callbacks=[lgt.record_evaluation(hist)])
    return list(bst._trees), hist["v"][metric][-1], time.perf_counter() - t0


def higgs_parity_jobs(opts_params, Xh, yh):
    """The Higgs ``[parity]`` checks at MODE_PARITY_ROWS rows as (name,
    params, iterations, metric, train kwargs, valid kwargs): DART and RF
    (2 iterations) and each ``[opts]`` arm (1, through the eager loop:
    one iteration captures nothing worth its capture; phase 22 holds
    the captured step to the eager loop)."""
    n = MODE_PARITY_ROWS
    trk = dict(data=Xh[:n], label=yh[:n])
    vak = dict(data=Xh[n:], label=yh[n:])
    return [("dart", DART_PARAMS, 2, "auc", trk, vak),
            ("rf", RF_PARAMS, 2, "auc", trk, vak),
            *((name, dict(p0, fused_train=False), 1, "auc", trk, vak)
              for name, p0 in opts_params.items())]


def legs_child(job_path):
    """The CPU legs pickled in ``job_path`` by :func:`start_legs`, in a
    process of their own on two threads (:func:`start_child`): each
    job is (key, a function of this module, its kwargs), and its result
    is pickled under its key. A job with ``year=True`` gets the
    Year-shaped train rows as ``X``/``y``, made here from their seed."""
    import pickle
    import torch
    torch.set_num_threads(2)
    import lightgbm_tpu_torch as lgt
    with open(job_path, "rb") as f:
        jobs = pickle.load(f)
    year, out = None, {}
    for key, func, kw in jobs:
        kw = dict(kw)
        if kw.pop("year", False):
            if year is None:
                X, y = make_year_like(YEAR_ROWS)
                year = (X[:YEAR_TRAIN], y[:YEAR_TRAIN])
            kw["X"], kw["y"] = year
        out[key] = globals()[func](lgt, **kw)
    with open(job_path + ".out", "wb") as f:
        pickle.dump(out, f)
    return 0


def start_legs(name, jobs):
    """:func:`legs_child` started in the background on ``jobs``."""
    import pickle
    d = os.path.join(HERE, "build", "chip_smoke", name)
    os.makedirs(d, exist_ok=True)
    path = os.path.join(d, "jobs.pkl")
    with open(path, "wb") as f:
        pickle.dump(jobs, f)
    return start_child("legs_child", path)


def start_cpu_legs(jobs):
    """The CPU legs of the Higgs ``[parity]`` ``jobs``
    (:func:`higgs_parity_jobs`) in a worker: each job's trees, valid
    metric and seconds."""
    return start_legs("cpu_legs", [
        (name, "train_leg", dict(p=dict(params, device_type="cpu"),
                                 iters=iters, metric=metric, trk=trk,
                                 vak=vak))
        for name, params, iters, metric, trk, vak in jobs])


def start_early_legs(X, y):
    """The CPU legs of the small ``[parity]`` checks (binary, quantized,
    and the Year L2 model) and of ``[linear]``'s card-against-CPU check,
    in a worker started as soon as the Higgs rows exist."""
    n = SMALL_PARITY_ROWS + (1 << 15)
    leg = dict(X=X[:n].copy(), y=y[:n].copy(), nv=1 << 15, devtype="cpu")
    return start_legs("early_legs", [
        ("binary", "small_parity_leg", dict(leg, params=dict(PARAMS))),
        ("quantized binary", "small_parity_leg",
         dict(leg, params=dict(PARAMS, **QUANT))),
        ("regression (L2)", "small_parity_leg",
         dict(year=True, nv=1 << 15, devtype="cpu",
              params=dict(YEAR_PARAMS))),
        ("linear", "linear_leg", dict(year=True, devtype="cpu"))])


def start_covtype_legs(X, y):
    """The CPU arms of ``[mc-parity]`` (float and quantized), ``[efb]``
    and ``[cat]``, in a worker started as soon as the Covertype rows
    exist."""
    n = MC_PARITY_ROWS + (1 << 15)
    Xs, ys = X[:n].copy(), y[:n].copy()
    cpu = {"device_type": "cpu"}
    leg = dict(X=Xs, y=ys, nv=1 << 15, iters=1)
    return start_legs("covtype_legs", [
        ("cpu", "mc_parity_leg", dict(leg, params=dict(MC_PARAMS, **cpu))),
        ("cpu quantized", "mc_parity_leg",
         dict(leg, params=dict(MC_PARAMS, **QUANT, **cpu))),
        ("efb", "mc_parity_leg", dict(leg, params=dict(EFB_PARAMS, **cpu))),
        ("cat", "mc_parity_leg",
         dict(leg, X=covtype_12(Xs), params=dict(EFB_PARAMS, **cpu),
              ds_kw=dict(categorical_feature=CAT_COLUMNS)))])


def phase_mode_parity(lgt, rank_data, jobs, cpu_legs):
    """``[parity]`` for lambdarank (1 iteration: its CPU leg takes ~9 s
    an iteration at F = 137, B = 255) at ~2^14 rows, and for the Higgs
    ``jobs`` (:func:`higgs_parity_jobs`): the card against
    ``device_type="cpu"``; trees equal up to a noise-level near tie, the
    valid NDCG@10 / AUC within 1e-3. The Higgs jobs' CPU legs come from
    ``cpu_legs``, the worker started after ``[opts]``
    (:func:`start_cpu_legs`), which ran beside the phases since."""
    import numpy as np
    X, y, sizes, Xv, yv, vsizes = rank_data
    nq = int(np.searchsorted(np.cumsum(sizes), MODE_PARITY_ROWS,
                             side="right"))
    nr, nvq = int(sizes[:nq].sum()), 200
    nvr = int(vsizes[:nvq].sum())
    rank_job = ("lambdarank", RANK_PARAMS, 1, "ndcg@10",
                dict(data=X[:nr], label=y[:nr], group=sizes[:nq]),
                dict(data=Xv[:nvr], label=yv[:nvr], group=vsizes[:nvq]))
    runs = {}
    for name, params, iters, metric, trk, vak in (rank_job, *jobs):
        runs[name] = [train_leg(lgt, dict(params, device_type="cuda"),
                                iters, metric, trk, vak)]
    runs["lambdarank"].append(train_leg(
        lgt, dict(RANK_PARAMS, device_type="cpu"), *rank_job[2:]))
    for name, leg in child_result(cpu_legs, "[parity]").items():
        runs[name].append(leg)
    for name, _, iters, metric, _, _ in (rank_job, *jobs):
        (tc, mc, sc), (tp, mp, sp_) = runs[name]
        msg = tree_parity("[parity]", name, tc, tp, K=1)
        rows = (f"{nr} rows in {nq} queries" if name == "lambdarank"
                else f"{MODE_PARITY_ROWS} rows")
        log(f"[parity] {name} {rows} x {iters} iterations: {msg}; valid "
            f"{metric} card {mc:.6f} cpu {mp:.6f} (|diff| "
            f"{abs(mc - mp):.2e}); card {sc:.1f} s, cpu {sp_:.1f} s"
            + ("" if name == "lambdarank" else " (a worker, 2 threads)"))
        if abs(mc - mp) > 1e-3:
            raise AssertionError(f"[parity] {name}: card and CPU {metric} "
                                 "differ by more than 1e-3")


# -- this slice: custom objectives, continued training, cv, refit --------
CV_ROWS = 1 << 20


def card_binary_fobj(tr):
    """A custom objective computing the port's own Binary gradients, on
    the Dataset's device (the card), from the scores it is handed: the
    built-in objective's arithmetic, so the trees must equal its."""
    import numpy as np
    import torch
    from lightgbm_tpu_torch.config import Config
    from lightgbm_tpu_torch.objectives import Binary
    y = tr.get_label()
    obj = Binary(Config(dict(objective="binary")))
    obj.init(np.asarray(y, np.float64), None)
    lab = torch.from_numpy(np.asarray(y, np.float32)).to(tr.device)

    def fobj(preds, dataset):
        s = torch.from_numpy(np.asarray(preds, np.float32)).to(tr.device)
        return obj.get_gradients(s, lab, None)
    return fobj


def card_softmax_fobj(tr, K):
    """The port's MulticlassSoftmax gradients on the Dataset's device,
    returned in the [n, K] layout."""
    import numpy as np
    import torch
    from lightgbm_tpu_torch.config import Config
    from lightgbm_tpu_torch.objectives import MulticlassSoftmax
    y = tr.get_label()
    obj = MulticlassSoftmax(Config(dict(objective="multiclass",
                                        num_class=K)))
    obj.init(np.asarray(y, np.float64), None)
    lab = torch.from_numpy(np.asarray(y, np.float32)).to(tr.device)

    def fobj(preds, dataset):
        s = torch.from_numpy(np.ascontiguousarray(preds.T, np.float32))
        g, h = obj.get_gradients(s.to(tr.device), lab, None)
        return g.T, h.T
    return fobj


def fobj_arm(lgt, CH, tr, params, n_it, fobj=None):
    """``n_it`` iterations of one booster, with ``fobj`` (the eager loop,
    a sync an iteration) or through the captured step (deferred, one
    sync at the end). Returns the trees, the launches of all ``n_it``
    iterations (iteration 0 counted as it runs, each replay by what its
    capture recorded) and the ms an iteration after iteration 0."""
    import torch
    bst = lgt.Booster(params=dict(params), train_set=tr)
    CH.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    bst.update(fobj=fobj, defer=fobj is None)
    bst._sync_trees()
    torch.cuda.synchronize()
    first = time.perf_counter() - t0
    t0 = time.perf_counter()
    for _ in range(n_it - 1):
        bst.update(fobj=fobj, defer=fobj is None)
    bst._sync_trees()
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) / max(1, n_it - 1) * 1e3
    out = dict(trees=list(bst._trees), launches=dict(CH.LAUNCHES), ms=ms,
               first_s=first, reason=bst._gbdt.fused_train_reason,
               captured=bst._gbdt._graph is not None,
               batched=bst._gbdt.class_batch_ok)
    del bst
    torch.cuda.empty_cache()
    return out


def phase_fobj(lgt, CH, tr):
    """``[fobj]``: 5 trees on the Higgs-shaped Dataset with a custom
    objective computing the port's Binary gradients on the card (the
    eager loop, B2 17 a tree) against 5 trees of the built-in binary
    objective without the average through the captured step: trees
    bit-identical. Then 2 fobj trees with fused_split=off (B1)."""
    fobj = card_binary_fobj(tr)
    custom = fobj_arm(lgt, CH, tr, dict(PARAMS, objective="custom"), 5,
                      fobj)
    builtin = fobj_arm(lgt, CH, tr, dict(PARAMS, boost_from_average=False),
                       5)
    b1 = fobj_arm(lgt, CH, tr, dict(PARAMS, objective="custom",
                                    fused_split="off"), 2, fobj)
    nt = per_tree(PARAMS)
    for name, r in (("fobj", custom), ("built-in captured", builtin),
                    ("fobj fused_split=off", b1)):
        log(f"[fobj] {name}: {len(r['trees'])} trees "
            f"({r['reason'] or 'the captured step'}); iteration 0 "
            f"{r['first_s']:.2f} s, then {r['ms']:.1f} ms/tree; launches "
            f"{r['launches']}")
    same = same_trees(custom["trees"], builtin["trees"])
    log(f"[fobj] fobj trees against the built-in objective's: "
        f"{'bit-identical' if same else 'DIFFERENT'} (structure, "
        f"thresholds, leaf values, gains); ms/tree fobj (eager) "
        f"{custom['ms']:.1f} vs captured {builtin['ms']:.1f}")
    if custom["reason"] != "custom objective gradients are host-supplied":
        raise AssertionError(f"[fobj]: ran {custom['reason']!r}")
    if not builtin["captured"]:
        raise AssertionError("[fobj]: the built-in arm was not captured")
    if not same:
        raise AssertionError("[fobj]: fobj trees differ from the built-in "
                             "objective's")
    for r, kernel, n in ((custom, "fused_build_best_splits", 5),
                         (builtin, "fused_build_best_splits", 5),
                         (b1, "build_histograms_cuda", 2)):
        want = dict.fromkeys(CH.LAUNCHES, 0)
        want[kernel] = nt * n
        if r["launches"] != want:
            raise AssertionError(f"[fobj]: launches {r['launches']}, "
                                 f"expected {want}")
    return dict(launches=custom["launches"], b1_launches=b1["launches"],
                ms=custom["ms"], captured_ms=builtin["ms"], b1_ms=b1["ms"])


def phase_mc_fobj(lgt, CH, tr):
    """``[mc-fobj]``: 2 class-batched iterations on the Covertype-shaped
    Dataset with a custom objective computing the port's softmax
    gradients on the card in the [n, K] layout, against the built-in
    multiclass objective without the average: trees bit-identical, B3
    once an iteration and B2 16 times."""
    fobj = card_softmax_fobj(tr, NUM_CLASS)
    custom = fobj_arm(lgt, CH, tr, dict(MC_PARAMS, objective="custom"), 2,
                      fobj)
    builtin = fobj_arm(lgt, CH, tr, dict(MC_PARAMS,
                                         boost_from_average=False), 2)
    for name, r in (("fobj", custom), ("built-in captured", builtin)):
        log(f"[mc-fobj] {name}: {len(r['trees'])} trees, class-batched "
            f"{r['batched']} ({r['reason'] or 'the captured step'}); "
            f"iteration 0 {r['first_s']:.2f} s, then {r['ms']:.1f} "
            f"ms/iteration; launches {r['launches']}")
    same = same_trees(custom["trees"], builtin["trees"])
    log(f"[mc-fobj] fobj trees against the built-in objective's: "
        f"{'bit-identical' if same else 'DIFFERENT'}")
    if not (same and custom["batched"]):
        raise AssertionError("[mc-fobj]: fobj trees differ from the "
                             "built-in objective's, or not class-batched")
    rounds = per_tree(MC_PARAMS) - 1
    want = {"build_histograms_cuda": 0,
            "fused_build_best_splits": rounds * 2,
            "build_root_histograms_classes": 2}
    for r in (custom, builtin):
        if r["launches"] != want:
            raise AssertionError(f"[mc-fobj]: launches {r['launches']}, "
                                 f"expected {want}")
    return dict(launches=custom["launches"], ms=custom["ms"],
                captured_ms=builtin["ms"])


def phase_continue(lgt, CH, X, y, Xv, yv, base_path):
    """``[continue]``: the ``[full]`` model file continued for 5 trees
    with ``init_model`` on a Higgs Dataset that keeps its raw rows,
    snapshots every 2 iterations kept to 2: 25 trees, the live train
    scores within 2e-4 of ``predict``, the valid AUC no lower than the
    base model's; the snapshots of the continued run's iterations 2 and
    4 alone stay, reload with their tree counts, and the newer one
    continues. Then RF: 3 trees, continued for 2, predicting the mean
    of the 5 trees within 1e-6."""
    import tempfile
    import numpy as np
    import torch
    t0 = time.perf_counter()
    tr = lgt.Dataset(X, label=y, params=dict(PARAMS), free_raw_data=False)
    va = lgt.Dataset(Xv, label=yv, reference=tr, free_raw_data=False)
    tr.construct()
    va.construct()
    build_s = time.perf_counter() - t0
    base = lgt.Booster(model_file=base_path,
                       params={"device_type": tr.device.type})
    nb = base.num_trees()
    base_auc = mode_auc_of(base.predict(Xv, raw_score=True), yv)
    with tempfile.TemporaryDirectory(dir=os.path.join(HERE, "build")) as tmp:
        out_model = os.path.join(tmp, "m.txt")
        p = dict(PARAMS, snapshot_freq=2, snapshot_keep=2,
                 output_model=out_model)
        CH.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        cont = lgt.train(p, tr, 5, valid_sets=[va], init_model=base_path)
        torch.cuda.synchronize()
        cont_s = time.perf_counter() - t0
        launches = dict(CH.LAUNCHES)
        t0 = time.perf_counter()
        raw = cont.predict(X, raw_score=True)
        predict_s = time.perf_counter() - t0
        d_train = float(np.abs(cont._gbdt.eval_scores(-1)[:, 0] - raw).max())
        auc = mode_auc(cont, yv)
        snaps = sorted((int(f.rsplit("_", 1)[1]), f) for f in os.listdir(tmp)
                       if ".snapshot_iter_" in f)
        counts = {i: lgt.Booster(model_file=os.path.join(tmp, f)).num_trees()
                  for i, f in snaps}
        newest = os.path.join(tmp, snaps[-1][1])
        t0 = time.perf_counter()
        again = lgt.train(dict(PARAMS), tr, 1, init_model=newest)
        again_s = time.perf_counter() - t0
        same_last = same_trees(again._all_trees()[-1:],
                               cont._all_trees()[nb + 4:nb + 5])
    log(f"[continue] Higgs Dataset with its raw rows binned in "
        f"{build_s:.1f} s; base model {nb} trees, valid AUC "
        f"{base_auc:.5f}; continued 5 trees in {cont_s:.2f} s (base "
        f"predictions on {len(y)} + {len(yv)} rows included; "
        f"{cont._gbdt.fused_train_reason or 'the captured step'}): "
        f"{cont.num_trees()} trees, valid AUC {auc:.5f}; launches "
        f"{launches}; |live train scores - predict| {d_train:.2e} "
        f"(predict of {len(y)} rows x {cont.num_trees()} trees "
        f"{predict_s:.2f} s)")
    log(f"[continue] snapshots kept (snapshot_freq 2, snapshot_keep 2): "
        f"{[f for _, f in snaps]} with {counts} trees; the newest "
        f"continued by 1 tree in {again_s:.2f} s: {again.num_trees()} "
        f"trees, its last tree {'equals' if same_last else 'differs from'}"
        f" the continued run's (its scores start from predict's f64 sums "
        f"rounded to f32)")
    if cont.num_trees() != nb + 5 or d_train > 2e-4:
        raise AssertionError("[continue]: wrong tree count or live scores "
                             "apart from predict")
    if not auc >= base_auc:
        raise AssertionError(f"[continue]: valid AUC {auc} below the "
                             f"base's {base_auc}")
    if [i for i, _ in snaps] != [nb + 2, nb + 4] or any(
            counts[i] != i for i in counts):
        raise AssertionError(f"[continue]: snapshots {snaps} {counts}")
    if again.num_trees() != nb + 5:
        raise AssertionError("[continue]: the snapshot did not continue")
    if launches != {"build_histograms_cuda": 0,
                    "fused_build_best_splits": per_tree(PARAMS) * 5,
                    "build_root_histograms_classes": 0}:
        raise AssertionError(f"[continue]: launches {launches}")
    del cont, again
    torch.cuda.empty_cache()
    # RF: 3 trees, then 2 more from that booster
    t0 = time.perf_counter()
    rf3 = lgt.train(dict(RF_PARAMS), tr, 3)
    CH.reset_launch_counts()
    rf5 = lgt.train(dict(RF_PARAMS), tr, 2, valid_sets=[va],
                    init_model=rf3)
    torch.cuda.synchronize()
    rf_s = time.perf_counter() - t0
    rf_launches = dict(CH.LAUNCHES)
    got = rf5.predict(Xv, raw_score=True)
    # each tree's output alone (a one-tree window averages over 1)
    mean = np.mean([rf5.predict(Xv, raw_score=True, start_iteration=i,
                                num_iteration=1) for i in range(5)], axis=0)
    d_rf = float(np.abs(got - mean).max())
    live = float(np.abs(rf5._gbdt.eval_scores(0)[:, 0] - got).max())
    log(f"[continue] RF 3 + 2 trees in {rf_s:.2f} s: {rf5.num_trees()} "
        f"trees, average_output {rf5._average_output}, init score "
        f"{rf5._gbdt._init_scores[0]:.6f}; |predict - mean of the 5 "
        f"trees| {d_rf:.2e}, |live valid scores - predict| {live:.2e}; "
        f"continued launches {rf_launches}; valid AUC "
        f"{mode_auc_of(got, yv):.5f}")
    if rf5.num_trees() != 5 or d_rf > 1e-6 or live > 1e-4:
        raise AssertionError("[continue]: continued RF does not average "
                             "its 5 trees")
    out = dict(launches=launches, rf_launches=rf_launches, cont_s=cont_s,
               rf_s=rf_s)
    del rf3, rf5, tr, va
    torch.cuda.empty_cache()
    return out


def mode_auc_of(raw, y):
    """The AUC of raw scores against labels."""
    from lightgbm_tpu_torch.config import Config
    from lightgbm_tpu_torch.metrics import AUC
    m = AUC(Config({}))
    m.init(y, None)
    return m.eval(raw)[0][1]


def phase_cv(lgt, CH, X, y):
    """``[cv]``: ``cv`` with nfold 3, 5 rounds and early_stopping_round 2
    on the first 2^21 Higgs rows (each fold copies its raw rows on the
    host, so the rows are cut to keep that small). The folds' Datasets
    are built on the card; one fold's trees equal ``train`` of that
    fold with its valid set, and each round's means equal the mean of
    the fold metrics read from the fold boosters."""
    import numpy as np
    import torch
    n = CV_ROWS
    p = dict(PARAMS, early_stopping_round=2)
    per_round = []

    def fold_means(env):
        vals = [b.eval_valid()[0][2] for b in env.model.boosters]
        per_round.append(float(np.mean(vals)))
    fold_means.order = 5
    CH.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ds = lgt.Dataset(X[:n], label=y[:n], params=dict(PARAMS),
                     free_raw_data=False)
    res = lgt.cv(p, ds, 5, nfold=3, return_cvbooster=True,
                 callbacks=[fold_means])
    torch.cuda.synchronize()
    cv_s = time.perf_counter() - t0
    launches = dict(CH.LAUNCHES)
    cvb = res.pop("cvbooster")
    means = res["valid auc-mean"]
    b = cvb.boosters[0]
    dev = {str(bst.train_set.bins.device) for bst in cvb.boosters}
    n_it = len(b._trees)
    t0 = time.perf_counter()
    solo = lgt.train(dict(PARAMS), b.train_set, n_it,
                     valid_sets=[b._valid_sets[0]])
    solo_s = time.perf_counter() - t0
    same = same_trees(solo._trees, b._trees)
    d_mean = float(np.abs(np.asarray(means)
                          - np.asarray(per_round[:len(means)])).max())
    log(f"[cv] nfold 3 x 5 rounds on {n} rows in {cv_s:.2f} s (fold "
        f"Datasets on {dev}); best_iteration {cvb.best_iteration}; valid "
        f"AUC mean " + " ".join(f"{v:.5f}" for v in means) + " stdv "
        + " ".join(f"{v:.5f}" for v in res["valid auc-stdv"])
        + f"; launches {launches}; fold 0 ({b.train_set.num_data} rows) "
        f"against train of that fold ({solo_s:.2f} s): {n_it} trees "
        f"{'bit-identical' if same else 'DIFFERENT'}; |cv mean - mean of "
        f"the fold metrics| {d_mean:.2e}")
    if dev != {str(ds.device)}:
        raise AssertionError(f"[cv]: fold Datasets on {dev}")
    if not same or d_mean > 1e-12:
        raise AssertionError("[cv]: a fold differs from train, or the "
                             "means from the fold metrics")
    if launches["fused_build_best_splits"] != (
            per_tree(PARAMS) * sum(len(bst._trees)
                                   for bst in cvb.boosters)):
        raise AssertionError(f"[cv]: launches {launches}")
    out = dict(launches=launches, s=cv_s)
    del cvb, b, solo
    torch.cuda.empty_cache()
    return out


def phase_refit(lgt, bst, path, Xv, yv):
    """``[refit]``: the ``[full]`` model refit on 2^19 valid rows on
    the card and, from its model file, in the port on the CPU: tree
    structures unchanged, leaf values within rtol 1e-9 of each other."""
    import numpy as np
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    card = bst.refit(Xv, yv, decay_rate=0.5)
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    cpu = lgt.Booster(model_file=path, params={"device_type": "cpu"}) \
        .refit(Xv, yv, decay_rate=0.5)
    cpu_s = time.perf_counter() - t0
    def structure(t):      # model text carries thresholds, not bins
        return (t.num_leaves, tuple(t.split_feature), tuple(t.threshold),
                tuple(t.decision_type), tuple(t.left_child),
                tuple(t.right_child))
    rel, moved = 0.0, 0.0
    for a, b, o in zip(card._all_trees(), cpu._all_trees(),
                       bst._all_trees()):
        if structure(a) != structure(o) or structure(b) != structure(o):
            raise AssertionError("[refit]: a tree structure changed")
        # relative to each value, or to a millionth of the tree's
        # largest where a value is near 0
        den = np.maximum(np.abs(b.leaf_value),
                         1e-6 * np.abs(b.leaf_value).max() + 1e-300)
        rel = max(rel, float(np.max(np.abs(a.leaf_value - b.leaf_value)
                                    / den)))
        moved = max(moved, float(np.abs(a.leaf_value - o.leaf_value).max()))
    auc0 = mode_auc_of(bst.predict(Xv, raw_score=True), yv)
    auc1 = mode_auc_of(card.predict(Xv, raw_score=True), yv)
    log(f"[refit] {card.num_trees()} trees refit on {len(yv)} rows "
        f"(decay 0.5): card {card_s:.2f} s, CPU {cpu_s:.2f} s; leaf values "
        f"card against CPU max relative difference {rel:.2e}; largest "
        f"leaf move {moved:.4g}; valid AUC {auc0:.5f} -> {auc1:.5f} (the "
        f"rows it was refit on)")
    if rel > 1e-9:
        raise AssertionError(f"[refit]: card and CPU leaf values differ by "
                             f"{rel:.3g} relative")
    if not moved > 0:
        raise AssertionError("[refit]: no leaf value moved")
    return dict(card_s=card_s, cpu_s=cpu_s, rel=rel)


# [opts]: the single-device builder options on the Higgs-shaped model
OPTS_GROUPS = [list(range(0, 16)), list(range(12, 28))]
OPTS_MONO_FEATURES = (4, 5, 6, 7)
OPTS_FORCED = {"feature": 0, "threshold": 0.0,
               "left": {"feature": 1, "threshold": -0.5,
                        "left": {"feature": 2, "threshold": 0.25}},
               "right": {"feature": 3, "threshold": 0.5}}


def opts_params(X, y):
    """The [opts] arms' parameters over PARAMS. The monotone arms
    constrain four linear features, each in the direction of its
    correlation with the label; the forced-split file (three levels)
    goes under build/."""
    import numpy as np
    n = 1 << 18
    mono = [0] * X.shape[1]
    for f in OPTS_MONO_FEATURES:
        mono[f] = int(np.sign(np.corrcoef(X[:n, f], y[:n])[0, 1]))
    out_dir = os.path.join(HERE, "build", "chip_smoke")
    os.makedirs(out_dir, exist_ok=True)
    forced = os.path.join(out_dir, "forced.json")
    with open(forced, "w") as fh:
        json.dump(OPTS_FORCED, fh)
    contri = [1.0] * X.shape[1]
    contri[0], contri[2], contri[5] = 0.5, 0.7, 0.3
    return {
        "bynode_interaction": dict(PARAMS, feature_fraction_bynode=0.8,
                                   interaction_constraints=OPTS_GROUPS),
        "extra_trees_contri": dict(PARAMS, extra_trees=True,
                                   feature_contri=contri),
        "intermediate": dict(PARAMS, monotone_constraints=mono,
                             monotone_constraints_method="intermediate"),
        "advanced": dict(PARAMS, monotone_constraints=mono,
                         monotone_constraints_method="advanced"),
        "cegb": dict(PARAMS, cegb_tradeoff=0.5, cegb_penalty_split=1e-6,
                     cegb_penalty_feature_coupled=[0.0, 50.0] * 14,
                     cegb_penalty_feature_lazy=[1e-4] * 28),
        "forced": dict(PARAMS, forcedsplits_filename=forced),
    }, mono


def monotone_sweep(tag, bst, X, mono):
    """Predictions on a 1-D sweep of each constrained feature, from 64
    rows: each must move with its constraint's sign."""
    import numpy as np
    grid = np.linspace(-3, 3, 61, dtype=np.float32)
    worst = 0.0
    for f, sign in enumerate(mono):
        if sign == 0:
            continue
        rows = np.repeat(X[:64], len(grid), axis=0)
        rows[:, f] = np.tile(grid, 64)
        pred = bst.predict(rows, raw_score=True).reshape(64, len(grid))
        steps = np.diff(pred, axis=1) * sign
        worst = min(worst, float(steps.min()))
        if steps.min() < -1e-9:
            raise AssertionError(f"{tag}: predictions move against the "
                                 f"constraint of feature {f}")
    return worst


def phase_b2_opts(tr, CH, SP, y_dev, mono):
    """B2 at the Higgs root and compacted child calls with a per-slot
    [L, F] feature mask (per-node sampling under interaction
    constraints) and intermediate monotone bounds per slot, against its
    plain version."""
    import numpy as np
    import torch
    gh_f, _, rl0, root_ids, c_idx, rl_c, n_small, small = higgs_streams(
        tr, y_dev)
    bins, dev = tr.bins, tr.bins.device
    F, B = bins.shape[1], tr.max_num_bin
    rng = np.random.RandomState(5)
    meta = dict(
        num_bins_pf=torch.from_numpy(tr.per_feature_num_bins()).to(dev),
        nan_bin_pf=torch.from_numpy(tr.per_feature_nan_bins()).to(dev),
        is_cat_pf=torch.from_numpy(tr.per_feature_is_categorical()).to(dev),
        mono_type=torch.tensor(mono, dtype=torch.int32, device=dev))
    sp = SP.SplitParams(min_data_in_leaf=100.0)
    errs = []
    for cname, ids, rl, kw in (
            ("root", root_ids, rl0, {}),
            ("child", small, rl_c, dict(row_gather=c_idx,
                                        num_rows=n_small))):
        L = ids.shape[0]
        ghs = gh_f if cname == "root" else gh_f[c_idx.long()].contiguous()
        lo = -rng.uniform(0.0, 0.05, size=L).astype(np.float32)
        fk = dict(meta, feature_mask=torch.from_numpy(
                      rng.rand(L, F) < 0.7).to(dev),
                  leaf_lo=torch.from_numpy(lo).to(dev),
                  leaf_hi=torch.from_numpy(lo + 0.08).to(dev))
        bk, _ = CH.fused_build_best_splits(bins, ghs, rl, ids, num_bins=B,
                                           params=sp, **kw, **fk)
        bp, _ = CH.fused_build_best_splits_plain(bins, ghs, rl, ids,
                                                 num_bins=B, params=sp,
                                                 **kw, **fk)
        torch.cuda.synchronize()
        err, flips = compare_best(f"[opts] B2 {cname}", bk, bp)
        errs.append(err)
        log(f"[opts] [B2] {cname:5s} L={L} per-slot [{L}, {F}] mask, "
            f"intermediate leaf_lo/leaf_hi: gain max_abs_err={err:.3g} "
            f"near-tie flips={flips}")
    return max(errs)


OPTS_ARM_KERNEL = {"bynode_interaction": "fused_build_best_splits",
                   "extra_trees_contri": "build_histograms_cuda",
                   "intermediate": "fused_build_best_splits",
                   "advanced": "build_histograms_cuda",
                   "cegb": "build_histograms_cuda",
                   "forced": "build_histograms_cuda"}


# the eager [opts] arms' trees: the one-split-a-round arms take 2-4 s a
# tree at 10.5M rows, so they run one
OPTS_EAGER_TREES = {"advanced": 1, "cegb": 3, "forced": 1}


def phase_opts(lgt, CH, SP, tr, va, Xv, yv):
    """``[opts]``: the builder options on the Higgs-shaped model at
    10.5M rows. Captured against eager (4 trees each, the timed
    iterations under the sync debug mode): per-node sampling under two
    interaction groups (B2), extra-trees with feature_contri (B1) and
    intermediate monotone on four features (B2, one split a round).
    Eager arms (OPTS_EAGER_TREES trees): advanced monotone, CEGB (split,
    coupled and lazy costs) and a three-level forced-split file (B1). Each arm
    prints its valid AUC and its launches a tree; the monotone arms'
    predictions are checked along each constrained feature."""
    import numpy as np
    import torch
    t_phase = time.perf_counter()
    params, mono = opts_params(Xv, yv)
    y_dev = torch.from_numpy(tr.get_label().astype(np.float32)).to("cuda")
    b2_err = phase_b2_opts(tr, CH, SP, y_dev, mono)
    del y_dev
    launches = {}
    cells = [(name, tr, params[name], 1 if name == "intermediate" else 3,
              (True, False),
              dict(debug=True, valid=va, keep=name == "intermediate"))
             for name in ("bynode_interaction", "extra_trees_contri",
                          "intermediate")]
    out = phase_step(lgt, CH, cells, tag="[opts]")
    for name, runs in out.items():
        r = runs[0][1]
        n_trees = len(r["trees"])
        per = {k: v / (n_trees - 1) for k, v in r["launches"].items()}
        launches[name] = r["launches"]
        want = per_tree(dict(params[name], leaf_batch=1)
                        if name == "intermediate" else params[name])
        log(f"[opts] {name}: valid AUC {r['valid_metric']:.5f} after "
            f"{n_trees} trees; launches a tree {per}")
        if per[OPTS_ARM_KERNEL[name]] != want or sum(per.values()) != want:
            raise AssertionError(f"[opts] {name}: launches {per}, want "
                                 f"{want} of {OPTS_ARM_KERNEL[name]}")
        if not 0.5 < r["valid_metric"] <= 1.0:
            raise AssertionError(f"[opts] {name}: valid AUC "
                                 f"{r['valid_metric']}")
    bst = out["intermediate"][0][1].pop("bst")
    worst = monotone_sweep("[opts] intermediate", bst, Xv, mono)
    log(f"[opts] intermediate: predictions monotone along features "
        f"{OPTS_MONO_FEATURES} on a 61-point sweep of 64 rows (least "
        f"step x sign {worst:.3g})")
    del bst, out
    torch.cuda.empty_cache()
    for name, n_trees in OPTS_EAGER_TREES.items():
        p = dict(params[name], fused_train=False)
        bst = lgt.Booster(params=p, train_set=tr)
        bst.add_valid(va, "valid")
        CH.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n_trees):
            bst.update()
        torch.cuda.synchronize()
        secs = (time.perf_counter() - t0) / n_trees
        g = bst._gbdt
        auc = bst.eval_valid()[0][2]
        per = {k: v / n_trees for k, v in CH.LAUNCHES.items()}
        launches[name] = dict(CH.LAUNCHES)
        want = per_tree(dict(p, leaf_batch=1) if name != "cegb" else p)
        extra = ""
        if name == "cegb":
            extra = (f"; features used {int(g._cegb_feat_used.sum())}, "
                     f"rows x features paid "
                     f"{int(g._cegb_used_rows.sum())} of "
                     f"{g._cegb_used_rows.numel()} "
                     f"({g._cegb_used_rows.numel() / 2**20:.0f} MiB mask)")
        if name == "forced":
            roots = {(t.split_feature[0], t.split_feature[t.left_child[0]],
                      t.split_feature[t.right_child[0]]) for t in bst._trees}
            extra = f"; (root, left, right) split features {roots}"
            if roots != {(0, 1, 3)}:
                raise AssertionError(f"[opts] forced: prefix {roots}")
        if name == "advanced":
            worst = monotone_sweep("[opts] advanced", bst, Xv, mono)
            extra = f"; monotone sweep least step x sign {worst:.3g}"
        log(f"[opts] {name} eager ({g.fused_train_reason or 'fused_train'}"
            f", {g.fused_split_reason!r}): valid AUC {auc:.5f} after "
            f"{n_trees} trees, {secs * 1e3:.0f} ms a tree; launches a tree "
            f"{per}"
            f"{extra}")
        if per[OPTS_ARM_KERNEL[name]] != want or sum(per.values()) != want:
            raise AssertionError(f"[opts] {name}: launches {per}, want "
                                 f"{want} of {OPTS_ARM_KERNEL[name]}")
        if not 0.5 < auc <= 1.0:
            raise AssertionError(f"[opts] {name}: valid AUC {auc}")
        del bst, g
        torch.cuda.empty_cache()
    log(f"[opts] phase took {time.perf_counter() - t_phase:.1f} s")
    return dict(launches=launches, b2_err=b2_err, params=params)


def wide_kernel_line(res, key, cname):
    """A [wide] call's numbers for the kernels JSON line."""
    r = res[key][cname]
    return dict(ms=r["ms"], plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
                bound_by=r["bound_by"], library_ms=r["library_ms"],
                rows=r["rows"], L=r["L"])


def phase_wide(lgt, CH, H, SP):
    """``[wide]``: max_bin 1023 (int16 bin columns, B = 1,024). B1 and
    B2 at the Higgs root and child calls (10.5M rows, 42 / 21 slots,
    F = 28) against their plain versions in bf16, f32 and int8, two
    launches bit-identical, timed; B3 at the Covertype root the same
    way. The captured step against the eager loop, bit-identical: Higgs
    through B2 (5 iterations after iteration 0) and B1
    (``fused_split=off``, 3), Covertype class-batched (3); card trees
    against CPU trees at 2^17 Higgs rows."""
    import torch
    res = {"B1": {}, "B2": {}, "B3": {}}
    t0 = time.perf_counter()
    X_all, y_all = make_higgs_like(HIGGS_ROWS + VALID_ROWS)
    X, y = X_all[:HIGGS_ROWS], y_all[:HIGGS_ROWS]
    wp = dict(PARAMS, max_bin=WIDE_BINS)
    ds = lgt.Dataset(X, label=y, params=wp).construct()
    if ds.bins.dtype != torch.int16 or ds.max_num_bin <= 256:
        raise AssertionError(f"[wide] bins {ds.bins.dtype}, B "
                             f"{ds.max_num_bin}")
    res["B"] = ds.max_num_bin
    plan = CH.slot_hist_plan(ds.num_features, 2 * wp["leaf_batch"],
                             ds.max_num_bin, ds.num_data)
    log(f"[wide] Higgs-shaped {ds.num_data} rows x {ds.num_features} at "
        f"max_bin {WIDE_BINS}: {ds.bins.dtype} bins, B={ds.max_num_bin}, "
        f"made and binned in {time.perf_counter() - t0:.1f} s; B1 plan at "
        f"the root {plan}")
    y_dev = torch.from_numpy(y).to("cuda")
    streams = phase_b1(ds, y_dev, CH, H, res, tag="[wide] ")
    phase_b2(ds, CH, SP, streams, res, y_dev, tag="[wide] ")
    del streams, y_dev
    torch.cuda.empty_cache()
    n = per_tree(wp)
    steps = phase_step(lgt, CH, [
        ("higgs max_bin 1023 B2", ds, wp, 5, (True, False)),
        ("higgs max_bin 1023 B1", ds, dict(wp, fused_split="off"), 3,
         (True, False))], tag="[wide]")
    r_b2 = steps["higgs max_bin 1023 B2"][0][1]
    r_b1 = steps["higgs max_bin 1023 B1"][0][1]
    expect_launches("[wide]", "higgs B2", r_b2,
                    {"fused_build_best_splits": 5 * n})
    expect_launches("[wide]", "higgs B1", r_b1,
                    {"build_histograms_cuda": 3 * n})
    del ds, steps
    torch.cuda.empty_cache()
    phase_small_parity(lgt, X, y, 1 << 15, wp, "wide binary (max_bin 1023)")
    del X_all, X, y
    Xc, yc = make_covtype_like(COVTYPE_ROWS)
    cp = dict(MC_PARAMS, max_bin=WIDE_BINS)
    dsc = lgt.Dataset(Xc, label=yc, params=cp).construct()
    log(f"[wide] Covertype-shaped {dsc.num_data} rows x {dsc.num_features}"
        f" at max_bin {WIDE_BINS}: {dsc.bins.dtype} bins, "
        f"B={dsc.max_num_bin}")
    if dsc.bins.dtype != torch.int16:
        raise AssertionError(f"[wide] Covertype bins {dsc.bins.dtype}")
    res["B_cov"] = dsc.max_num_bin
    phase_b3(dsc, torch.from_numpy(yc).to("cuda"), CH, H, res,
             tag="[wide] ")
    cov = phase_step(lgt, CH, [("covtype max_bin 1023 class-batched", dsc,
                                cp, 3, (True, False))], tag="[wide]")
    r_c = cov["covtype max_bin 1023 class-batched"][0][1]
    expect_launches("[wide]", "covtype class-batched", r_c,
                    {"build_root_histograms_classes": 3,
                     "fused_build_best_splits": 3 * (per_tree(cp) - 1)})
    del dsc, cov, Xc, yc
    torch.cuda.empty_cache()
    res["launches"] = {"higgs_b2": r_b2["launches"],
                       "higgs_b1": r_b1["launches"],
                       "covtype_class_batched": r_c["launches"]}
    res["ms_per_iteration"] = {"higgs_b2": r_b2["ms"],
                               "higgs_b1": r_b1["ms"],
                               "covtype_class_batched": r_c["ms"]}
    return res


def phase_wide_efb(lgt, CH, H):
    """``[wide-efb]``: 2^21 rows x 64 mutually exclusive sparse columns
    at max_bin 255 and ``max_bundle_bins=1024``: the JAX package's 16
    bundles, of more than 256 bins, in int16 columns; B1 at the bundle
    lattice's root and child calls against its plain version, timed;
    5 iterations after iteration 0 captured against eager (B1 only, 17
    launches a tree); card trees against CPU trees at 2^17 rows."""
    import torch
    t0 = time.perf_counter()
    X, y = make_sparse_like(SPARSE_ROWS)
    p = dict(SPARSE_PARAMS)
    ds = lgt.Dataset(X, label=y, params=p).construct()
    bp = ds.bundle_plan
    log(f"[wide-efb] {ds.num_data} rows x {SPARSE_COLS} sparse columns made "
        f"and binned in {time.perf_counter() - t0:.1f} s: "
        f"{bp.num_bundles} bundles of "
        f"{int(bp.bundle_num_bins.min())}-{bp.max_bundle_bins} bins, "
        f"{ds.bins.dtype} columns (the JAX package forms "
        f"{SPARSE_JAX_BUNDLES})")
    if (bp.num_bundles != SPARSE_JAX_BUNDLES or bp.max_bundle_bins <= 256
            or ds.bins.dtype != torch.int16):
        raise AssertionError("[wide-efb] bundle plan differs from the JAX "
                             "package's")
    res = {"B1": {}, "Bb": bp.max_bundle_bins, "G": bp.num_bundles}
    y_dev = torch.from_numpy(y).to("cuda")
    phase_b1(ds, y_dev, CH, H, res, tag="[wide-efb] ",
             B=bp.max_bundle_bins, grads=mid_gradients)
    del y_dev
    torch.cuda.empty_cache()
    steps = phase_step(lgt, CH, [("sparse bundles", ds, p, 5,
                                  (True, False))], tag="[wide-efb]")
    r = steps["sparse bundles"][0][1]
    expect_launches("[wide-efb]", "sparse bundles", r,
                    {"build_histograms_cuda": 5 * per_tree(p)})
    del ds, steps
    torch.cuda.empty_cache()
    phase_small_parity(lgt, X, y, 1 << 15, p,
                       "wide EFB (bundles of ~1,000 bins)")
    res["launches"] = r["launches"]
    res["ms_per_iteration"] = r["ms"]
    return res


def tree_linear_close(a, b):
    """Two linear trees: structure and feature lists equal, leaf and
    node values within 1e-5 (f32 sums in another order); the largest
    relative difference of their constants and coefficients, or None."""
    import numpy as np
    if tree_key(a) != tree_key(b) or a.leaf_features != b.leaf_features:
        return None
    for f in ("leaf_value", "internal_value"):
        x, y = getattr(a, f), getattr(b, f)
        if not np.allclose(x, y, rtol=1e-5, atol=1e-5 * np.abs(y).max()):
            return None
    worst = 0.0
    for x, y in [(a.leaf_const, b.leaf_const)] + list(zip(a.leaf_coeff,
                                                         b.leaf_coeff)):
        x, y = np.asarray(x, float), np.asarray(y, float)
        if x.size:
            d = np.abs(x - y) / np.maximum(np.abs(y), 1e-300)
            d = d[np.abs(x - y) > 1e-15]
            worst = max(worst, float(d.max()) if d.size else 0.0)
    return worst


def linear_leg(lgt, X, y, devtype):
    """The ``[linear]`` card-against-CPU leg on ``devtype``: 2 linear
    trees at 2^15 of the Year rows; (trees, model text, seconds)."""
    n = 1 << 15
    p = dict(LINEAR_PARAMS, device_type=devtype)
    t0 = time.perf_counter()
    bst = lgt.train(p, lgt.Dataset(X[:n], label=y[:n], params=p), 2)
    return list(bst._trees), bst.model_to_string(), time.perf_counter() - t0


def phase_linear(lgt, CH, cpu=None):
    """``[linear]``: the Year-shaped regression (515,345 rows x 90, 255
    leaves) with ``linear_tree=true, linear_lambda=0.01``, 5 iterations
    through the eager loop (each tree to the host, its 255 leaves fitted
    on the card in float64), B2 17 launches a tree; valid l2 below the
    constant-leaf run's at every iteration; a save/load round trip with
    zero difference. At 2^15 rows the card's trees equal the CPU's
    (structure exact, leaf values within 1e-5, linear constants and
    coefficients within rtol 1e-9) up to a noise-level near tie; the
    CPU's linear model predicted on the card within 1e-12 of its host
    ``Tree.predict``."""
    import os
    import tempfile
    import numpy as np
    import torch
    X, y = make_year_like(YEAR_ROWS)
    Xt, yt = X[:YEAR_TRAIN], y[:YEAR_TRAIN]
    Xv, yv = X[YEAR_TRAIN:], y[YEAR_TRAIN:]
    runs = {}
    for name, params in (("linear", LINEAR_PARAMS),
                         ("constant", YEAR_PARAMS)):
        tr = lgt.Dataset(Xt, label=yt, params=dict(params)).construct()
        va = lgt.Dataset(Xv, label=yv, reference=tr).construct()
        hist = {}
        CH.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        bst = lgt.train(dict(params), tr, 5, valid_sets=[va],
                        valid_names=["valid"],
                        callbacks=[lgt.record_evaluation(hist)])
        torch.cuda.synchronize()
        runs[name] = dict(bst=bst, l2=hist["valid"]["l2"],
                          s=time.perf_counter() - t0,
                          launches=dict(CH.LAUNCHES))
        log(f"[linear] Year-shaped {name} leaves: 5 trees in "
            f"{runs[name]['s']:.2f} s with valid l2 every iteration "
            + " ".join(f"{v:.3f}" for v in runs[name]["l2"])
            + f"; launches {runs[name]['launches']}; "
            f"{bst._gbdt.fused_train_reason or 'the captured step'}")
    lin = runs["linear"]
    g = lin["bst"]._gbdt
    if g.fused_train_reason != "linear leaves solve on host raw values":
        raise AssertionError(f"[linear] arm {g.fused_train_reason!r}")
    want = {"build_histograms_cuda": 0, "build_root_histograms_classes": 0,
            "fused_build_best_splits": 5 * per_tree(LINEAR_PARAMS)}
    if lin["launches"] != want:
        raise AssertionError(f"[linear] launches {lin['launches']}")
    n_lin = sum(t.is_linear for t in lin["bst"]._trees)
    n_coef = sum(len(c) for t in lin["bst"]._trees for c in t.leaf_coeff)
    if n_lin != 5 or any(not (b < a) for a, b in zip(lin["l2"],
                                                      lin["l2"][1:])):
        raise AssertionError("[linear] not 5 linear trees with a falling "
                             "valid l2")
    if not all(a < b for a, b in zip(lin["l2"], runs["constant"]["l2"])):
        raise AssertionError("[linear] valid l2 not below the constant "
                             "run's at every iteration")
    lin_ms = lin["s"] / 5 * 1e3
    log(f"[linear] {n_lin} linear trees, {n_coef} coefficients; valid l2 "
        f"after 5: linear {lin['l2'][-1]:.4f} < constant "
        f"{runs['constant']['l2'][-1]:.4f}; ms/iteration linear "
        f"{lin['s'] / 5 * 1e3:.1f}, constant (captured; both with their "
        f"first iteration and the valid l2 each iteration) "
        f"{runs['constant']['s'] / 5 * 1e3:.1f}")
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "linear.txt")
        lin["bst"].save_model(path)
        again = lgt.Booster(model_file=path)
        d = float(np.abs(again.predict(Xv) - lin["bst"].predict(Xv)).max())
    if d != 0.0:
        raise AssertionError(f"[linear] save/load round trip differs by {d}")
    del runs, lin, g, again
    torch.cuda.empty_cache()
    # card against CPU at 2^15 rows (the CPU leg: ``cpu``, a worker's)
    nv = 1 << 13
    tc, text_c, card_s = linear_leg(lgt, Xt, yt, "cuda")
    tp, text_p, cpu_s = (cpu if cpu is not None
                         else linear_leg(lgt, Xt, yt, "cpu"))
    same, worst = 0, 0.0
    for a, b in zip(tc, tp):
        w = tree_linear_close(a, b)
        if w is None:
            break
        same += 1
        worst = max(worst, w)
    if same == 0 or worst > 1e-9:
        raise AssertionError(f"[linear] card against CPU: {same} trees "
                             f"equal, coefficients within {worst:.3g}")
    msg = f"{same}/{len(tc)} trees equal in structure and linear models"
    if same < len(tc):
        a, b = tc[same], tp[same]
        k = next((j for j in range(min(len(a.split_feature),
                                       len(b.split_feature)))
                  if (a.split_feature[j], a.threshold_bin[j])
                  != (b.split_feature[j], b.threshold_bin[j])), None)
        if k is None:
            raise AssertionError(f"[linear] tree {same}: equal splits, "
                                 "values or linear features differ")
        gap = abs(a.split_gain[k] - b.split_gain[k]) / abs(b.split_gain[k])
        if gap > 1e-5:
            raise AssertionError(f"[linear] tree {same} split {k} differs "
                                 f"beyond a near tie ({gap:.3g})")
        msg += f" (tree {same} split {k}: a near tie, gap {gap:.2e})"
    same_text = (text_c.split("parameters:")[0]
                 == text_p.split("parameters:")[0])
    log(f"[linear] card against CPU at 2^15 rows x 2 trees: {msg}; "
        f"coefficients within {worst:.3g} (relative); model texts "
        f"{'equal' if same_text else 'differ in the last digits'}; "
        f"card {card_s:.1f} s, cpu {cpu_s:.1f} s"
        + (" (a worker, 2 threads)" if cpu else ""))
    # C2: the CPU's linear model, predicted on the card
    on_card = lgt.Booster(model_str=text_p)
    raw = on_card.predict(Xv[:nv], raw_score=True)
    host = np.zeros(nv)
    for t in tp:
        host += t.predict(Xv[:nv].astype(np.float64))
    d = float(np.abs(raw - host).max())
    log(f"[linear] the CPU's linear model predicted on the card against "
        f"its host Tree.predict: max |diff| {d:.3g} over {nv} rows")
    if d > 1e-12:
        raise AssertionError(f"[linear] card predict of a linear model off "
                             f"by {d}")
    return dict(launches=want, ms_per_iteration=lin_ms)


def make_allstate_like(n_rows, n_vars=ALLSTATE_VARS, card=ALLSTATE_LEVELS,
                       seed=23):
    """Allstate-shaped one-hot CSR (tests/test_wide_sparse.py::
    _one_hot_sparse, built straight into CSR arrays): ``n_vars``
    categorical variables of ``card`` levels, one nonzero column of each
    variable a row, so ``n_vars * card`` columns and ``n_rows * n_vars``
    nonzeros; a regression label from each variable's level-0 weight."""
    import numpy as np
    import scipy.sparse as sps
    rng = np.random.RandomState(seed)
    cats = rng.randint(0, card, size=(n_rows, n_vars)).astype(np.int32)
    indices = (cats + np.arange(n_vars, dtype=np.int32)[None, :] * card)
    indptr = np.arange(0, n_rows * n_vars + 1, n_vars, dtype=np.int64)
    X = sps.csr_matrix((np.ones(n_rows * n_vars), indices.ravel(), indptr),
                       shape=(n_rows, n_vars * card))
    w = rng.normal(size=n_vars)
    y = (cats == 0) @ w + 0.1 * rng.normal(size=n_rows)
    return X, y


class HostPeak:
    """The peak resident set size of this process above its size at
    entry, sampled from /proc/self/statm every 5 ms on a thread while the
    block runs (``peak`` in bytes, after exit)."""

    def __enter__(self):
        import threading
        self._page = os.sysconf("SC_PAGE_SIZE")
        self._base = self.peak = self._rss()
        self._done = threading.Event()
        self._t = threading.Thread(target=self._poll, daemon=True)
        self._t.start()
        return self

    def _rss(self):
        with open("/proc/self/statm") as f:
            return int(f.read().split()[1]) * self._page

    def _poll(self):
        while not self._done.wait(0.005):
            self.peak = max(self.peak, self._rss())

    def __exit__(self, *exc):
        self._done.set()
        self._t.join()
        self.peak = max(self.peak, self._rss()) - self._base


def sparse_cpu_bins_child(path):
    """The port's CPU bins of ``[sparse]``'s CSR, made anew from its seed
    in a process of its own on four threads (:func:`start_child`): the
    bins and the Dataset's seconds."""
    import pickle
    import torch
    torch.set_num_threads(4)
    import lightgbm_tpu_torch as lgt
    X, y = make_allstate_like(ALLSTATE_ROWS)
    t0 = time.perf_counter()
    cpu = lgt.Dataset(X, label=y, params=dict(SPARSE_ALLSTATE_PARAMS,
                                              device_type="cpu"))
    cpu.construct()
    secs = time.perf_counter() - t0
    with open(path + ".out", "wb") as f:
        pickle.dump((cpu.bins.numpy(), secs), f)
    return 0


def phase_sparse(lgt, CH, H, results, cpu_bins):
    """``[sparse]``: the Allstate-shaped CSR (2^20 rows x 2,048 one-hot
    columns, 134M nonzeros) built into a Dataset on the card from its
    CSC nonzeros, bins bit-equal to the port's CPU bins of the same CSR
    and at most 2 x 128 bundles; the construction's seconds, host peak
    (resident set above its size before) and device peak; B1 at the
    bundle lattice's root and child calls against its plain version
    under weighted L2 gradients, bit-identical over 6 launches, timed
    beside ``index_add_``, and bit-identical over 11 launches under the
    boost-from-average gradients; 5 regression trees through the
    captured step (B1 17 launches a tree over the bundles), ms/tree.
    The CPU bins come from ``cpu_bins``, the worker of
    :func:`sparse_cpu_bins_child` started at ``[wide]``."""
    import numpy as np
    import torch
    t0 = time.perf_counter()
    X, y = make_allstate_like(ALLSTATE_ROWS)
    log(f"[sparse] Allstate-shaped CSR {X.shape[0]} x {X.shape[1]}, "
        f"{X.nnz} nonzeros, made in {time.perf_counter() - t0:.1f} s")
    p = dict(SPARSE_ALLSTATE_PARAMS)
    base = reset_peak()
    t0 = time.perf_counter()
    with HostPeak() as hp:
        ds = lgt.Dataset(X, label=y, params=p).construct()
        torch.cuda.synchronize()
    card_s = time.perf_counter() - t0
    host_peak = hp.peak
    dev_peak = torch.cuda.max_memory_allocated() - base
    cpu, cpu_s = child_result(cpu_bins, "[sparse]")
    bp = ds.bundle_plan
    equal = np.array_equal(ds.bins.cpu().numpy(), cpu)
    log(f"[sparse] Dataset on the card in {card_s:.2f} s (host resident "
        f"peak {host_peak / 2**30:.2f} GiB, device peak "
        f"{dev_peak / 2**30:.2f} GiB; the dense f64 matrix would be "
        f"{X.shape[0] * X.shape[1] * 8 / 2**30:.1f} GiB): "
        f"{bp.num_bundles} bundles of up to {bp.max_bundle_bins} bins, "
        f"{tuple(ds.bins.shape)} {ds.bins.dtype}; on the CPU in "
        f"{cpu_s:.2f} s (a worker, 4 threads, from [wide] on); bins equal "
        f"card against CPU: {equal}")
    if not equal or bp.num_bundles > 2 * ALLSTATE_VARS:
        raise AssertionError("[sparse] card bins differ from the CPU's or "
                             "too many bundles")
    del cpu
    res = {"B1": {}}
    y_dev = torch.from_numpy(y.astype(np.float32)).to("cuda")
    phase_b1(ds, y_dev, CH, H, res, tag="[sparse] ",
             B=bp.max_bundle_bins, grads=weighted_l2_gradients, reps=5)
    # the inputs of the one failed two-launch check (PERF.md section 7)
    b1_repeats(ds, y_dev, CH, bp.max_bundle_bins, gradients, 10,
               "[sparse] ")
    del y_dev
    torch.cuda.empty_cache()
    CH.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    bst = lgt.train(p, ds, 5)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    launches = dict(CH.LAUNCHES)
    g = bst._gbdt
    log(f"[sparse] 5 trees in {train_s:.2f} s ({train_s / 5 * 1e3:.1f} "
        f"ms/tree, the first with its capture); launches {launches}; "
        f"{g.fused_split_reason}; captured: {g.fused_train_ok}")
    expect_launches("[sparse]", "5 trees", dict(launches=launches),
                    {"build_histograms_cuda": 5 * per_tree(p)})
    if not g.fused_train_ok:
        raise AssertionError(f"[sparse] not the captured step: "
                             f"{g.fused_train_reason!r}")
    pred = bst.predict(X[:1 << 14])
    if not np.isfinite(pred).all():
        raise AssertionError("[sparse] predictions not finite")
    out = dict(B1=res["B1"], launches=launches, G=bp.num_bundles,
               Bb=bp.max_bundle_bins, card_s=card_s, cpu_s=cpu_s,
               host_peak=host_peak, dev_peak=dev_peak,
               ms_per_tree=train_s / 5 * 1e3, X=X[:LIBSVM_ROWS],
               y=y[:LIBSVM_ROWS])
    del bst, g, ds
    torch.cuda.empty_cache()
    return out


def write_csv(path, header, M, decimals=6):
    """``M`` as CSV text with a header line: each value fixed-point with
    ``decimals`` digits after the point and a sign, formatted with numpy
    digit arithmetic (no per-value Python)."""
    import numpy as np
    q = np.rint(np.asarray(M, np.float64) * 10 ** decimals).astype(np.int64)
    a = np.abs(q)
    n_int = max(1, len(str(int(a.max()) // 10 ** decimals)))
    width = 1 + n_int + 1 + decimals
    chars = np.empty(q.shape + (width + 1,), np.uint8)
    chars[..., 0] = np.where(q < 0, ord("-"), ord("+"))
    digits = n_int + decimals
    pos = [1 + i if i < n_int else 2 + i for i in range(digits)]
    for i, c in enumerate(pos):
        chars[..., c] = ord("0") + a // 10 ** (digits - 1 - i) % 10
    chars[..., 1 + n_int] = ord(".")
    chars[..., width] = ord(",")
    chars[:, -1, width] = ord("\n")
    with open(path, "wb") as f:
        f.write((",".join(header) + "\n").encode())
        f.write(chars.tobytes())


def write_libsvm(path, X, y):
    """A CSR and its labels as LibSVM lines ``label idx:value ...``."""
    with open(path, "w") as f:
        for i in range(X.shape[0]):
            lo, hi = X.indptr[i], X.indptr[i + 1]
            f.write(" ".join([repr(float(y[i]))] + [
                f"{j}:{v!r}" for j, v in zip(X.indices[lo:hi].tolist(),
                                             X.data[lo:hi].tolist())])
                    + "\n")


def start_proc(argv, cwd=HERE, env=None, timeout=600, group=False):
    """``argv`` started in the background, its output to a temporary
    file; a thread records its seconds when it exits (or kills it at
    ``timeout``). ``group`` starts it in a process group of its own, so
    that a kill reaches the processes it starts too. The handle for
    :func:`wait_proc` and :func:`kill_procs`."""
    import tempfile
    import threading
    out = tempfile.TemporaryFile()
    t0 = time.perf_counter()
    p = subprocess.Popen(argv, stdout=out, stderr=subprocess.STDOUT,
                         cwd=cwd, env=env, start_new_session=group)
    h = {"p": p, "argv": argv, "out": out, "group": group}

    def waiter():
        try:
            p.wait(timeout=timeout)
        except subprocess.TimeoutExpired:
            _kill(h)
            p.wait()
        h["s"] = time.perf_counter() - t0
    h["t"] = threading.Thread(target=waiter, daemon=True)
    h["t"].start()
    return h


def proc_output(h):
    h["out"].seek(0)
    return h["out"].read().decode(errors="replace")


def wait_proc(h, tag):
    """The seconds of a :func:`start_proc` process; a non-zero exit
    raises with the end of its output."""
    h["t"].join()
    if h["p"].returncode != 0:
        raise AssertionError(f"{tag} {' '.join(h['argv'][1:])} exited "
                             f"{h['p'].returncode}: "
                             f"{proc_output(h)[-3000:]}")
    return h["s"]


def _kill(h):
    """SIGKILL a :func:`start_proc` process (its group, if it has one)."""
    import signal
    try:
        if h.get("group"):
            os.killpg(h["p"].pid, signal.SIGKILL)
        else:
            h["p"].kill()
    except ProcessLookupError:
        pass


def kill_procs(handles):
    """Kill whatever of ``handles`` still runs (a phase that failed),
    and what a grouped one started."""
    for h in handles:
        if h["p"].poll() is None or h.get("group"):
            _kill(h)
            h["p"].wait()


def start_cli(*args):
    """``python -m lightgbm_tpu_torch`` with ``args`` on the card,
    started in the background (:func:`start_proc`)."""
    return start_proc([sys.executable, "-m", "lightgbm_tpu_torch", *args])


def start_child(func, path):
    """``chip_smoke.<func>(path)`` started in a process of its own
    (:func:`start_proc`), killed at exit if it still runs; it pickles
    its result to ``path + ".out"`` (:func:`child_result`)."""
    import atexit
    if os.path.exists(path + ".out"):
        os.unlink(path + ".out")
    h = start_proc([sys.executable, "-c", "import sys; sys.path.insert(0, "
                    f"{HERE!r}); import chip_smoke; sys.exit("
                    f"chip_smoke.{func}({path!r}))"], timeout=900)
    h["path"] = path
    atexit.register(kill_procs, [h])
    return h


def child_result(h, tag):
    """What a :func:`start_child` process pickled, once it exits 0."""
    import pickle
    wait_proc(h, tag)
    with open(h["path"] + ".out", "rb") as f:
        return pickle.load(f)


def phase_cli(lgt, CH, sparse_rows):
    """``[cli]``: the Higgs-shaped data at 2^19 rows written as a CSV with
    a header, and ``python -m lightgbm_tpu_torch config=train.conf
    num_trees=5`` on the card (the model of bench.py's Higgs cell): the
    model text equal to an in-process ``train`` on a Dataset of the same
    file (B2, 17 launches a tree); ``task=predict`` equal to
    ``Booster.predict``; ``task=save_binary`` and 5 trees from the
    ``.bin`` equal to the CSV's; ``task=convert_model`` compiled with gcc,
    its raw scores on 1,000 rows within 1e-12 of ``predict``; and 2
    trees from a LibSVM file of ``[sparse]``'s first 2^14 rows through
    the CLI's ``run``. The parse rate and each task's seconds."""
    import numpy as np
    from lightgbm_tpu_torch import io
    d = os.path.join(HERE, "build", "chip_smoke", "cli")
    os.makedirs(d, exist_ok=True)
    X, y = make_higgs_like(CLI_ROWS)
    csv = os.path.join(d, "train.csv")
    t0 = time.perf_counter()
    write_csv(csv, ["label"] + [f"f{i}" for i in range(X.shape[1])],
              np.column_stack([y, X]))
    write_s = time.perf_counter() - t0
    conf = os.path.join(d, "train.conf")
    with open(conf, "w") as f:
        f.write("task = train\ndata = train.csv\nheader = true\n"
                "output_model = model.txt\n" + "".join(
                    f"{k} = {v}\n" for k, v in CLI_PARAMS.items()))
    t0 = time.perf_counter()
    loaded = io.load_data_file(csv, lgt.Config({"header": True}))
    parse_s = time.perf_counter() - t0
    Xf = loaded.X
    # the CLI's train and save_binary run beside the in-process train,
    # then its predict and convert_model beside the train from the .bin:
    # each task's seconds are its process's, the others running
    procs = {"train": start_cli(f"config={conf}", "num_trees=5",
                                f"output_model={d}/model.txt"),
             "save_binary": start_cli(f"config={conf}", "task=save_binary")}
    try:
        return _cli_checks(lgt, CH, d, conf, csv, Xf, procs, write_s,
                           parse_s, sparse_rows)
    finally:
        kill_procs(procs.values())


def _cli_checks(lgt, CH, d, conf, csv, Xf, procs, write_s, parse_s,
                sparse_rows):
    """The rest of ``[cli]``, with its background CLI tasks ``procs``."""
    import shutil
    import numpy as np
    import torch
    from lightgbm_tpu_torch import cli
    # the same parameters in process, on a Dataset of the same file
    params = cli._parse_argv([f"config={conf}", "num_trees=5",
                              f"output_model={d}/model.txt"])
    params.pop("_conf_dir")
    ep = {k: v for k, v in params.items()
          if lgt.Config.canonical_name(k) not in cli._ENGINE_DROP}
    CH.reset_launch_counts()
    bst = lgt.train(ep, lgt.Dataset(csv, params=ep), 5)
    torch.cuda.synchronize()
    launches = dict(CH.LAUNCHES)
    expect_launches("[cli]", "in-process train", dict(launches=launches),
                    {"fused_build_best_splits": 5 * per_tree(CLI_PARAMS)})
    secs = {"train": wait_proc(procs["train"], "[cli]")}
    with open(os.path.join(d, "model.txt")) as f:
        if f.read() != bst.model_to_string():
            raise AssertionError("[cli] the CLI's model text differs from "
                                 "the in-process train's")
    procs["predict"] = start_cli(f"config={conf}", "task=predict",
                                 f"input_model={d}/model.txt",
                                 f"output_result={d}/pred.txt")
    procs["convert_model"] = start_cli(
        f"config={conf}", "task=convert_model", f"input_model={d}/model.txt",
        f"convert_model={d}/model.c")
    secs["save_binary"] = wait_proc(procs["save_binary"], "[cli]")
    from_bin = lgt.train(ep, lgt.Dataset(csv + ".bin", params=ep), 5)
    if not same_trees(from_bin._trees, bst._trees):
        raise AssertionError("[cli] trees from the .bin differ from the "
                             "CSV's")
    secs["predict"] = wait_proc(procs["predict"], "[cli]")
    want = bst.predict(Xf)
    got = np.loadtxt(os.path.join(d, "pred.txt"))
    if not np.array_equal(got, want):
        raise AssertionError(f"[cli] task=predict differs from predict by "
                             f"{np.abs(got - want).max()}")
    secs["convert_model"] = wait_proc(procs["convert_model"], "[cli]")
    if not shutil.which("gcc"):
        raise AssertionError("[cli] no gcc on PATH: the convert_model C "
                             "cannot be held against the port")
    with open(os.path.join(d, "model.c")) as f:
        src = f.read()
    with open(os.path.join(d, "main.c"), "w") as f:
        f.write(src + C_MAIN)
    subprocess.run(["gcc", "-O1", "-o", os.path.join(d, "pred"),
                    os.path.join(d, "main.c"), "-lm"], check=True,
                   timeout=300)
    rows = Xf[:1000]
    r = subprocess.run([os.path.join(d, "pred"), str(rows.shape[1])],
                       input="\n".join(" ".join(repr(v) for v in row)
                                       for row in rows.tolist()),
                       capture_output=True, text=True, check=True,
                       timeout=60)
    c = np.array([float(v) for v in r.stdout.split()])
    c_err = float(np.abs(c - bst.predict(rows, raw_score=True)).max())
    if c.shape != (1000,) or c_err > 1e-12:
        raise AssertionError(f"[cli] convert_model C off by {c_err}")
    # 2 trees from a LibSVM file of [sparse]'s first rows
    svm = os.path.join(d, "allstate.svm")
    write_libsvm(svm, *sparse_rows)
    t0 = time.perf_counter()
    cli.run(cli._parse_argv([
        "task=train", f"data={svm}", "num_trees=2", f"output_model={d}/svm.txt",
        *(f"{k}={v}" for k, v in SPARSE_ALLSTATE_PARAMS.items())]))
    secs["libsvm_train"] = time.perf_counter() - t0
    if lgt.Booster(model_file=os.path.join(d, "svm.txt")).num_trees() != 2:
        raise AssertionError("[cli] LibSVM train did not write 2 trees")
    rate = Xf.shape[0] / parse_s
    log(f"[cli] CSV of {Xf.shape[0]} rows x {Xf.shape[1] + 1} columns "
        f"({os.path.getsize(csv) / 2**20:.0f} MiB) written in "
        f"{write_s:.1f} s, parsed in {parse_s:.2f} s ({rate:,.0f} rows/s); "
        "seconds of each task: " + ", ".join(f"{k} {v:.1f}"
                                             for k, v in secs.items())
        + f" (a subprocess each, two at a time beside the in-process "
        "work, but libsvm_train, in process); launches "
        f"of the in-process train {launches}; CLI model text equal, "
        f"predict equal, .bin trees equal, C raw scores within {c_err}")
    del bst, from_bin
    torch.cuda.empty_cache()
    return dict(launches=launches, secs=secs, parse_s=parse_s,
                rows_per_s=rate, c_err=c_err, csv=csv)


# [ooc]: the Higgs model trained out of core (ROADMAP A7): the bins stay
# on the host and stream in chunks of a 64 MiB staging budget (two
# uint8 [C, 28] buffers: C = 1,196,032 rows at the JAX package's block of
# 16,384 rows, 9 chunks a sweep)
OOC_PARAMS = dict(PARAMS, leaf_batch=16, out_of_core="on", chunk_budget_mb=64)
OOC_TREES = 2
OOC_QUANT = dict(use_quantized_grad=True, hist_subtraction=False)
# [resume]: every fault-tolerance knob at once, so that each arm's model
# text (its parameters included) is byte-equal to the clean run's
RESUME_ROWS = 1 << 20
RESUME_ITERS = 10
RESUME_PARAMS = dict(PARAMS, leaf_batch=16, snapshot_freq=3,
                     snapshot_keep=10, resume="auto", nan_guard="rollback",
                     on_device_loss="degrade", output_model="m.txt")


def ooc_b1_call(ds, y, CH, H, B):
    """B1 at an out-of-core chunk call: chunk 0's rows of the host bins
    on the card, the root's 2W slots, and ``init`` the sums of chunk 1
    (the accumulator a sweep carries), under weighted-L2 gradients
    (order-dependent g and h, as ``[sparse]`` uses): 6 launches
    bit-identical, int8 exact against the plain version, f32 within rtol
    1e-4 of each channel's scale; timed beside the plain version and
    ``index_add_``."""
    import torch
    W = OOC_PARAMS["leaf_batch"]
    from lightgbm_tpu_torch.boosting.gbdt import block_rows_for
    from lightgbm_tpu_torch.data.prefetch import chunk_rows_for
    F = ds.bins.shape[1]
    C = chunk_rows_for(ds.num_data, F, 1, OOC_PARAMS["chunk_budget_mb"],
                       block_rows_for(ds.num_data, F, B))
    dev = torch.device("cuda")
    y_dev = torch.from_numpy(y[:2 * C]).to(dev)
    g, h = weighted_l2_gradients(y_dev)
    gh_f = torch.stack([g, h, torch.ones_like(g)], 1).contiguous()
    qg, qh, _ = quantize(g, h)
    gh_q = torch.stack([qg, qh, torch.ones_like(qg)], 1).contiguous()
    ids = torch.full((2 * W,), -2, dtype=torch.int32, device=dev)
    ids[0] = 0
    rl = torch.zeros(C, dtype=torch.int32, device=dev)
    chunk0 = ds.bins[:C].to(dev)
    chunk1 = ds.bins[C:2 * C].to(dev)
    rl1 = rl[:chunk1.shape[0]]
    errs = {}
    for label, gh, hd in (("bf16", gh_f, "bfloat16"),
                          ("f32", gh_f, "float32"),
                          ("int8", gh_q, "bfloat16")):
        init = CH.build_histograms_cuda(chunk1, gh[C:].contiguous(), rl1,
                                        ids, num_bins=B, hist_dtype=hd)
        args = (chunk0, gh[:C].contiguous(), rl, ids)
        k = CH.build_histograms_cuda(*args, num_bins=B, hist_dtype=hd,
                                     init=init)
        for _ in range(5):
            if not torch.equal(k, CH.build_histograms_cuda(
                    *args, num_bins=B, hist_dtype=hd, init=init)):
                raise AssertionError(f"[ooc] B1 with init {label}: two "
                                     "launches differ")
        p = H.build_histograms(*args, num_bins=B, hist_dtype=hd, init=init)
        torch.cuda.synchronize()
        if label == "int8":
            if not torch.equal(k, p):
                raise AssertionError("[ooc] B1 with init int8 not exact")
            errs[label] = 0.0
        else:
            errs[label] = check_close(f"[ooc] B1 with init {label}", k, p,
                                      1e-4)
    init = CH.build_histograms_cuda(chunk1, gh_f[C:].contiguous(), rl1,
                                    ids, num_bins=B)
    args = (chunk0, gh_f[:C].contiguous(), rl, ids)
    ms = cuda_ms(lambda: CH.build_histograms_cuda(
        *args, num_bins=B, init=init), 10)
    plain_ms = cuda_ms(lambda: H.build_histograms(
        *args, num_bins=B, init=init), 2)
    lib_ms = index_add_ms(chunk0, *args[1:], B, C)
    L = 2 * W
    # the chunk's bins, gh and row_leaf read once, init read, out written
    bound, by = bound_of(hist_bytes(C, F, 12, False, L, B)
                         + L * F * B * 3 * 4, 3 * C * F)
    log(f"[ooc] [B1] chunk call with init: rows={C} L={L} F={F} B={B}, "
        f"weighted L2 gradients: 6 launches bit-identical; max_abs_err "
        f"bf16 {errs['bf16']:.3g} f32 {errs['f32']:.3g} int8 0 (exact); "
        f"{ms:.3f} ms (bound {bound:.3f} ms by {by}; plain {plain_ms:.3f} "
        f"ms; index_add_ {lib_ms:.3f} ms)")
    del chunk0, chunk1, init, gh_f, gh_q
    torch.cuda.empty_cache()
    return dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bound,
                bound_by=by, rows=C, L=L, max_abs_err=errs["bf16"],
                errs=errs)


def timed_train(lgt, CH, params, ds, trees):
    """``trees`` trees (no valid set) with the launch counts zeroed just
    before and read just after: ``train`` of the first (iteration 0,
    and the step's capture on a resident run), then ``update`` of the
    others, timed, with one sync at the end. The booster, ms a tree
    after the first, launches, int8 launches and the peak device bytes
    above the start."""
    import torch
    base = reset_peak()
    CH.reset_launch_counts()
    bst = lgt.train(dict(params), ds, 1)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(trees - 1):
        bst.update(defer=True)
    bst._gbdt.sync()
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) / max(1, trees - 1) * 1e3
    return dict(bst=bst, ms=ms, launches=dict(CH.LAUNCHES),
                int8=dict(CH.INT8_LAUNCHES),
                peak=torch.cuda.max_memory_allocated() - base)


def phase_ooc(lgt, CH, H, X, y):
    """``[ooc]``: the Higgs-shaped model (10.5M rows x 28, max_bin 63,
    255 leaves, leaf_batch 16) trained out of core, 3 trees an arm: (a)
    ``out_of_core=on``, the bins binned in row blocks into a host matrix
    and streamed in 64 MiB-budget chunks through the pinned double
    buffer, B1 with a carried accumulator a chunk (never B2); (b) the
    same with int8 gradients and no subtraction, bit-identical to the
    resident captured step at those settings (B1, ``fused_split=off``);
    (c) ``out_of_core=auto`` under ``LIGHTGBM_TPU_DEVICE_MEM_GB`` below
    the working set, which warns and trains chunked. The float arm's
    trees equal the resident run's up to a noise-level near tie, leaf
    values within 1e-5 of the tree's largest. B1 at a chunk call against its plain
    version. Prints chunk rows and chunks a sweep, B1 launches a tree,
    host-to-device GB/s and the overlap, ms a tree against the resident
    captured tree, and the peak device bytes of each."""
    import numpy as np
    import torch
    from lightgbm_tpu_torch import log as lgt_log
    rp = {k: v for k, v in OOC_PARAMS.items()
          if k not in ("out_of_core", "chunk_budget_mb")}
    base = reset_peak()
    t0 = time.perf_counter()
    ds_r = lgt.Dataset(X, label=y, params=dict(rp)).construct()
    res_build_s = time.perf_counter() - t0
    build_peak = torch.cuda.max_memory_allocated() - base
    res_f = timed_train(lgt, CH, rp, ds_r, OOC_TREES)
    res_q = timed_train(lgt, CH, dict(rp, fused_split="off", **OOC_QUANT),
                        ds_r, OOC_TREES)
    for r in (res_f, res_q):
        r["peak"] = max(r["peak"], build_peak)
    del ds_r
    torch.cuda.empty_cache()

    base = reset_peak()
    t0 = time.perf_counter()
    ds_c = lgt.Dataset(X, label=y, params=dict(OOC_PARAMS)).construct()
    ooc_build_s = time.perf_counter() - t0
    build_peak = torch.cuda.max_memory_allocated() - base
    if ds_c.bins.device.type != "cpu":
        raise AssertionError("[ooc] the out-of-core Dataset's bins are on "
                             f"{ds_c.bins.device}, not the host")
    arm_a = timed_train(lgt, CH, OOC_PARAMS, ds_c, OOC_TREES)
    arm_b = timed_train(lgt, CH, dict(OOC_PARAMS, **OOC_QUANT), ds_c,
                        OOC_TREES)
    for r in (arm_a, arm_b):
        r["peak"] = max(r["peak"], build_peak)
    gb = arm_a["bst"]._gbdt
    pref = gb._prefetcher
    stats = pref.sync_stats()
    per_tree_b1 = {}
    for name, r in (("a", arm_a), ("b", arm_b)):
        if not r["bst"]._gbdt.chunked:
            raise AssertionError(f"[ooc] arm {name} did not train chunked")
        if (r["launches"]["fused_build_best_splits"]
                or r["launches"]["build_root_histograms_classes"]
                or r["launches"]["build_histograms_cuda"] <= 0):
            raise AssertionError(f"[ooc] arm {name}: launches "
                                 f"{r['launches']} (B1 only, a chunk)")
        per_tree_b1[name] = r["launches"]["build_histograms_cuda"] \
            / OOC_TREES
    if arm_b["int8"]["build_histograms_cuda"] != \
            arm_b["launches"]["build_histograms_cuda"]:
        raise AssertionError("[ooc] arm b: a B1 launch without int8")
    if not same_trees(arm_b["bst"]._trees, res_q["bst"]._trees):
        raise AssertionError("[ooc] int8 chunked trees differ from the "
                             "resident captured step's")
    msg = tree_parity("[ooc]", "float chunked vs resident",
                      arm_a["bst"]._trees, res_f["bst"]._trees, K=1)
    # a leaf value is a ratio of f32 sums whose gradient sum cancels:
    # each is held to rtol 1e-5 of its tree's largest leaf value
    leaf_err = 0.0
    for a, b in zip(arm_a["bst"]._trees, res_f["bst"]._trees):
        if tree_key(a) != tree_key(b):
            break
        scale = float(np.abs(b.leaf_value).max())
        leaf_err = max(leaf_err, float(np.abs(np.asarray(a.leaf_value)
                                              - b.leaf_value).max()) / scale)
    if leaf_err > 1e-5:
        raise AssertionError(f"[ooc] float chunked leaf values off by "
                             f"{leaf_err:.3g} of the tree's largest")
    msg += f"; leaf values within {leaf_err:.3g} of each tree's largest"
    # (c) the capacity gate degrades with a warning
    warned = []

    class Collect:
        def info(self, m):
            pass

        def warning(self, m):
            warned.append(m)
    # half the resident working set
    from lightgbm_tpu_torch.dataset import estimate_device_bytes
    budget_gb = estimate_device_bytes(len(y), X.shape[1], 1,
                                      rp["num_leaves"], 64, True) / 2 / 2**30
    os.environ["LIGHTGBM_TPU_DEVICE_MEM_GB"] = f"{budget_gb:.4f}"
    lgt_log.register_logger(Collect())
    try:
        auto = dict(rp, verbosity=0)
        ds_auto = lgt.Dataset(X, label=y, params=dict(auto)).construct()
        arm_c = timed_train(lgt, CH, auto, ds_auto, 2)
    finally:
        del os.environ["LIGHTGBM_TPU_DEVICE_MEM_GB"]
        lgt_log._State.logger = None
    if ds_auto.bins.device.type != "cpu" or not arm_c["bst"]._gbdt.chunked \
            or not any("streaming it in row chunks" in m for m in warned):
        raise AssertionError(f"[ooc] out_of_core=auto over capacity: bins "
                             f"on {ds_auto.bins.device}, chunked "
                             f"{arm_c['bst']._gbdt.chunked}, warnings "
                             f"{warned}")
    del ds_auto
    b1 = ooc_b1_call(ds_c, y, CH, H, ds_c.max_num_bin)
    gbs = stats.bytes / max(stats.copy_ms, 1e-9) / 1e6
    log(f"[ooc] chunks of {pref.chunk_rows} rows, {pref.num_chunks} a "
        f"sweep ({gb.train_dd.r_pad} padded rows); Dataset binned in row "
        f"blocks on the card into host bins in {ooc_build_s:.1f} s "
        f"(resident {res_build_s:.1f} s)")
    log(f"[ooc] (a) float chunked: {arm_a['ms']:.1f} ms/tree against the "
        f"resident captured tree's {res_f['ms']:.1f} (trees 2-3; the first "
        f"carries the capture); B1 {per_tree_b1['a']:.0f} launches a tree, 0 B2; "
        f"host-to-device {stats.bytes / 2**30:.2f} GiB at {gbs:.2f} GB/s "
        f"(copy {stats.copy_ms:.1f} ms, the compute stream stalled "
        f"{stats.stall_ms:.1f} ms): overlap_fraction "
        f"{stats.overlap_fraction():.4f}; the host waited "
        f"{stats.wait_s * 1e3:.1f} ms for staged chunks ({stats.stage_s * 1e3:.1f}"
        f" ms staging); {msg}")
    log(f"[ooc] (b) int8, no subtraction: {arm_b['ms']:.1f} ms/tree "
        f"against resident captured {res_q['ms']:.1f}; trees "
        f"bit-identical; B1 {per_tree_b1['b']:.0f} int8 launches a tree")
    log(f"[ooc] (c) out_of_core=auto under LIGHTGBM_TPU_DEVICE_MEM_GB="
        f"{budget_gb:.4f} (half the resident working set): warned and "
        f"trained chunked ({arm_c['ms']:.1f} ms/tree)")
    log(f"[ooc] peak device bytes above the start (Dataset construction "
        f"included): chunked {arm_a['peak']} (a), {arm_b['peak']} (b); "
        f"resident {res_f['peak']} (float), {res_q['peak']} (int8)")
    out = dict(b1=b1, launches={
        "float_chunked": arm_a["launches"], "int8_chunked": arm_b["launches"],
        "auto_over_capacity": arm_c["launches"]},
        ms=arm_a["ms"], resident_ms=res_f["ms"], ms_int8=arm_b["ms"],
        resident_ms_int8=res_q["ms"], overlap=stats.overlap_fraction(),
        gbs=gbs, chunk_rows=pref.chunk_rows, chunks=pref.num_chunks,
        b1_per_tree=per_tree_b1, peak=arm_a["peak"],
        resident_peak=res_f["peak"])
    for r in (res_f, res_q, arm_a, arm_b, arm_c):
        r.pop("bst")
    del ds_c
    torch.cuda.empty_cache()
    return out


def resume_data():
    return make_higgs_like(RESUME_ROWS, seed=23)


def resume_child() -> int:
    """The preempted run of ``[resume]`` (a subprocess, its cwd the
    arm's directory, LIGHTGBM_TPU_CHAOS_KILL_ITER=5 and _SIGNAL=TERM in
    its environment): it writes its checkpoint at the signal and exits
    0, as the CLI's train task does."""
    sys.path.insert(0, HERE)
    import lightgbm_tpu_torch as lgt
    from lightgbm_tpu_torch.resilience import TrainingPreempted
    X, y = resume_data()
    try:
        lgt.train(dict(RESUME_PARAMS), lgt.Dataset(X, label=y),
                  RESUME_ITERS)
    except TrainingPreempted as e:
        print(f"[resume] child: {e}", flush=True)
        return 0
    print("[resume] child: no preemption", flush=True)
    return 3


def phase_resume(lgt, CH, csv):
    """``[resume]``: preemption, resume, rollback and degrade through the
    captured step, Higgs-shaped at 2^20 rows (a cut in rows only, for the
    subprocess's start), 10 iterations, checkpoints every 3, every knob
    on (``resume=auto``, ``nan_guard=rollback``,
    ``on_device_loss=degrade``). The clean run's model text is the
    reference; each arm's must be byte-equal to it: a subprocess
    signalled (SIGTERM) after iteration 5 writes its checkpoint and
    exits 0, and a second run finishes it; a NaN injected at iteration 5
    rolls back to the iteration-3 checkpoint; an injected device loss at
    iteration 7 restores and retries on the same card. The checkpoint's
    bytes, write and restore ms. Then ``python -m lightgbm_tpu_torch
    ingest`` of the ``[cli]`` CSV into shards, 2 trees from the shard
    directory (chunked: B1 only), and the shards' bins equal to those of
    an in-memory Dataset of the same CSV binned with the shards'
    mappers."""
    import shutil
    root = os.path.join(HERE, "build", "chip_smoke", "resume")
    shutil.rmtree(root, ignore_errors=True)
    # the preempted child and the ingest run beside the in-process arms
    # (each one's seconds are taken with the others running)
    pre = os.path.join(root, "preempted")
    os.makedirs(pre, exist_ok=True)
    env = dict(os.environ, LIGHTGBM_TPU_CHAOS_KILL_ITER="5",
               LIGHTGBM_TPU_CHAOS_KILL_SIGNAL="TERM")
    shards = os.path.join(root, "shards")
    procs = [start_proc(
        [sys.executable, "-c", "import sys; sys.path.insert(0, "
         f"{HERE!r}); import chip_smoke; sys.exit(chip_smoke.resume_child())"],
        cwd=pre, env=env, timeout=300),
        start_cli("ingest", f"data={csv}", f"out={shards}", "header=true",
                  f"ingest_rows_per_shard={CLI_ROWS // 4}")]
    try:
        return _resume_arms(lgt, CH, csv, root, procs)
    finally:
        kill_procs(procs)


def _resume_arms(lgt, CH, csv, root, procs):
    """The rest of ``[resume]``, with its preempted child and its ingest
    ``procs`` running."""
    import torch
    from lightgbm_tpu_torch.resilience import (read_checkpoint,
                                               restore_training_checkpoint,
                                               write_training_checkpoint)
    X, y = resume_data()
    cwd = os.getcwd()
    texts, launches, secs = {}, {}, {}

    def arm(name, env):
        d = os.path.join(root, name)
        os.makedirs(d, exist_ok=True)
        os.chdir(d)
        old = {k: os.environ.get(k) for k in env}
        os.environ.update(env)
        try:
            CH.reset_launch_counts()
            t0 = time.perf_counter()
            bst = lgt.train(dict(RESUME_PARAMS), lgt.Dataset(X, label=y),
                            RESUME_ITERS)
            torch.cuda.synchronize()
            secs[name] = time.perf_counter() - t0
            launches[name] = dict(CH.LAUNCHES)
            texts[name] = bst.model_to_string()
            return bst
        finally:
            for k, v in old.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v
            os.chdir(cwd)

    clean = arm("clean", {})
    if not clean._gbdt.fused_train_ok or not clean._gbdt._graphs:
        raise AssertionError("[resume] the clean run did not run the "
                             "captured step")
    ck = os.path.join(root, "clean", "m.txt.ckpt_iter_9")
    ck_bytes = os.path.getsize(ck)
    t0 = time.perf_counter()
    write_training_checkpoint(os.path.join(root, "probe.ckpt"), clean, [],
                              begin_iteration=0, end_iteration=RESUME_ITERS,
                              params=dict(RESUME_PARAMS))
    write_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    restore_training_checkpoint(clean, [], *read_checkpoint(ck))
    torch.cuda.synchronize()
    restore_ms = (time.perf_counter() - t0) * 1e3
    # the preempted subprocess, then the run that finishes it
    pre = os.path.join(root, "preempted")
    procs[0]["t"].join()
    secs["child"] = procs[0]["s"]
    if procs[0]["p"].returncode != 0 or not os.path.exists(
            os.path.join(pre, "m.txt.ckpt_iter_5")):
        raise AssertionError(f"[resume] the preempted child exited "
                             f"{procs[0]['p'].returncode} without its "
                             f"checkpoint: {proc_output(procs[0])[-5000:]}")
    arm("preempted", {})
    arm("rollback", {"LIGHTGBM_TPU_CHAOS_POISON_ITER": "5",
                     "LIGHTGBM_TPU_CHAOS_POISON_ONCE":
                     os.path.join(root, "poison.marker")})
    arm("degrade", {"LIGHTGBM_TPU_CHAOS_DEVLOSS_ITER": "7",
                    "LIGHTGBM_TPU_CHAOS_DEVLOSS_ONCE":
                    os.path.join(root, "devloss.marker")})
    for m in ("poison.marker", "devloss.marker"):
        if not os.path.exists(os.path.join(root, m)):
            raise AssertionError(f"[resume] {m}: the fault never fired")
    for name in ("preempted", "rollback", "degrade"):
        if texts[name] != texts["clean"]:
            raise AssertionError(f"[resume] {name}: model text differs "
                                 "from the clean run's")
    log(f"[resume] {RESUME_ROWS} rows x {RESUME_ITERS} iterations, captured"
        f" step: preempted child exited 0 with m.txt.ckpt_iter_5 "
        f"({secs['child']:.1f} s), resumed, rolled back (NaN at 5) and "
        f"degraded (device loss at 7, retried on the same card): model text"
        f" byte-equal to the clean run's in all three; checkpoint "
        f"{ck_bytes} B, write {write_ms:.1f} ms, restore {restore_ms:.1f}"
        f" ms; seconds " + ", ".join(f"{k} {v:.1f}" for k, v in secs.items())
        + f"; launches of the clean run {launches['clean']}")
    # ingest: the [cli] CSV into shards on the card, 2 trees from them
    shards = os.path.join(root, "shards")
    ingest_s = wait_proc(procs[1], "[resume]")
    sd = lgt.Dataset(shards, params=dict(PARAMS, leaf_batch=16))
    CH.reset_launch_counts()
    t0 = time.perf_counter()
    sb = lgt.train(dict(PARAMS, leaf_batch=16), sd, 2)
    torch.cuda.synchronize()
    shard_s = time.perf_counter() - t0
    launches["shards"] = dict(CH.LAUNCHES)
    if not sb._gbdt.chunked or launches["shards"][
            "fused_build_best_splits"] or not launches["shards"][
            "build_histograms_cuda"]:
        raise AssertionError(f"[resume] shard training: chunked "
                             f"{sb._gbdt.chunked}, launches "
                             f"{launches['shards']}")
    mem = lgt.Dataset(csv, params={"header": True, "verbosity": -1},
                      bin_mappers=sd.bin_mappers).construct()
    if not torch.equal(mem.bins.cpu(), sd.bins):
        raise AssertionError("[resume] shard bins differ from the "
                             "in-memory Dataset's of the same CSV")
    log(f"[resume] ingest of the [cli] CSV ({sd.num_data} rows) into "
        f"{len(os.listdir(shards)) - 1} shards in {ingest_s:.1f} s (a "
        f"subprocess on the card, beside the arms); 2 trees from the "
        f"shard directory, chunked, in {shard_s:.1f} s, launches {launches['shards']}; "
        "shard bins equal to the in-memory Dataset's with the same mappers")
    del clean, sb, sd, mem
    torch.cuda.empty_cache()
    return dict(launches=launches, ck_bytes=ck_bytes, write_ms=write_ms,
                restore_ms=restore_ms, secs=secs, ingest_s=ingest_s)



# [parallel]: the Higgs cell through the parallel learners, as two ranks
# of one torch.distributed group on the one card (gloo: NCCL refuses two
# ranks on one device), started by `python -m lightgbm_tpu_torch.launch
# -n 2`; each rank holds its np.array_split block of the 10.5M rows
# (all of them for the feature learner). boost_from_average is off: a
# parallel run's automatic init score is the mean of the ranks' (the
# reference's GlobalSyncUpByMean), not the serial run's.
PARALLEL_RANKS = 2
PARALLEL_TREES = 2
PAR_PARAMS = dict(PARAMS, boost_from_average=False,
                  eval_period=PARALLEL_TREES)
PARALLEL_ARMS = (
    ("quant_allreduce", dict(tree_learner="data",
                             dp_hist_merge="allreduce", **QUANT)),
    ("quant_reduce_scatter", dict(tree_learner="data",
                                  dp_hist_merge="reduce_scatter", **QUANT)),
    ("float_allreduce", dict(tree_learner="data",
                             dp_hist_merge="allreduce")),
    ("float_reduce_scatter", dict(tree_learner="data",
                                  dp_hist_merge="reduce_scatter")),
    ("feature", dict(tree_learner="feature")),
    ("voting_top20", dict(tree_learner="voting", top_k=20,
                          dp_hist_merge="allreduce")),
    ("voting_top5", dict(tree_learner="voting", top_k=5)),
)
PARALLEL_TIMEOUT_S = 600
# the rest of the combinations under a plan (data, reduce-scatter),
# quantized so that each is the serial run's model byte for byte:
# (name, params, trees). GOSS at learning rate 0.5 samples from its
# third tree; DART drops at rate 0.5 with no skip
PARALLEL_MODE_ARMS = (
    ("goss", dict(tree_learner="data", learning_rate=0.5, **GOSS, **QUANT),
     3),
    ("dart", dict(tree_learner="data", boosting="dart", drop_rate=0.5,
                  skip_drop=0.0, **QUANT), 3),
    ("rf", dict(tree_learner="data", boosting="rf", bagging_freq=1,
                bagging_fraction=0.632, **QUANT), 3),
    ("custom", dict(tree_learner="data", objective="custom", **QUANT), 2),
    ("init_model", dict(tree_learner="data", **QUANT), 2),
)
# lambdarank with bagging_by_query on the [rank] cell: each rank holds
# its np.array_split block of the queries (pre_partition=true)
PARALLEL_RANK_PARAMS = dict(RANK_PARAMS, tree_learner="data",
                            pre_partition=True, bagging_by_query=True,
                            bagging_freq=1, bagging_fraction=0.5, **QUANT)
PARALLEL_RANK_ITERS = 3
# the elastic cell: the ranks checkpoint at iteration 2 of 4, and this
# process resumes serially from that directory
ELASTIC_TREES = 4
ELASTIC_PARAMS = dict(PAR_PARAMS, tree_learner="data", snapshot_freq=2,
                      resume="auto", fused_split="off", **QUANT)


def model_trees(text):
    """A model text less its parameters block."""
    return text.split("end of trees")[0]


def tree_blocks(text, n=None):
    """The ``Tree=`` blocks of a model text, the first ``n`` of them."""
    return model_trees(text).split("Tree=")[1:][:n]


def tree_fields(text):
    """Per-tree (structure lines, leaf values) of a model text."""
    out = []
    for block in text.split("Tree=")[1:]:
        kv = dict(ln.split("=", 1) for ln in block.splitlines()
                  if "=" in ln)
        out.append(({k: kv.get(k) for k in (
            "split_feature", "threshold", "decision_type", "left_child",
            "right_child")}, [float(v) for v in kv["leaf_value"].split()]))
    return out


def query_block(X, y, sizes, r, world=PARALLEL_RANKS):
    """Rank r's np.array_split block of the queries: (X, y, sizes)."""
    import numpy as np
    qb = np.concatenate([[0], np.cumsum(sizes)])
    qs = np.array_split(np.arange(len(sizes)), world)[r]
    lo, hi = int(qb[qs[0]]), int(qb[qs[-1] + 1])
    return X[lo:hi], y[lo:hi], sizes[qs]


def rank_arm(lgt, CH, outdir, me, name, params, tr, va, rounds, **kw):
    """One arm on this rank: ``rounds`` trees with the valid metric at
    the end; writes the model text and returns its record (ms a tree,
    launches, metrics, sha, the collective record and the staging)."""
    import hashlib
    import torch
    hist = {}
    torch.cuda.synchronize()
    CH.reset_launch_counts()
    t0 = time.perf_counter()
    bst = lgt.train(params, tr, rounds, valid_sets=[va],
                    valid_names=["valid"],
                    callbacks=[lgt.record_evaluation(hist)], **kw)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(CH.LAUNCHES)
    gb = bst._gbdt
    rep = gb.plan.comm.report
    text = model_trees(bst.model_to_string())
    with open(os.path.join(outdir, f"{name}.rank{me}.txt"), "w") as fh:
        fh.write(text)
    rec = dict(
        ms_tree=wall / rounds * 1e3, launches=launches, rounds=rounds,
        metrics=hist["valid"], auc=hist["valid"].get("auc", [None])[-1],
        sha=hashlib.sha256(text.encode()).hexdigest(),
        plan=[gb.plan.parallel_mode, gb.plan.hist_merge],
        reasons=[gb.fused_train_reason, gb.fused_split_reason],
        trees=rep.trees,
        bytes_by_kind={k: v / rep.trees
                       for k, v in rep.bytes_by_kind().items()},
        hist_bytes_per_tree=rep.hist_bytes_per_tree_measured(),
        hist_kinds=sorted({o.kind for o in rep.hist_ops}),
        collectives_per_tree=rep.count() / rep.trees,
        staged_bytes=rep.staged_bytes, staged_ms=rep.staged_ms,
        backend=gb.plan.comm.backend, num_data=int(tr.num_data))
    del bst, gb
    torch.cuda.empty_cache()
    return rec


def save_arrays(outdir, name, arrays):
    """``arrays`` as ``{name}_{i}.npy`` under ``outdir``: the ranks map
    this process's data instead of making it again."""
    import numpy as np
    for i, a in enumerate(arrays):
        np.save(os.path.join(outdir, f"{name}_{i}.npy"), a)


def load_arrays(outdir, name, count):
    """The arrays :func:`save_arrays` wrote, memory-mapped."""
    import numpy as np
    return [np.load(os.path.join(outdir, f"{name}_{i}.npy"), mmap_mode="r")
            for i in range(count)]


def parallel_rank(outdir) -> int:
    """One rank of ``[parallel]`` (under the launcher's environment):
    the learners' arms (PARALLEL_TREES trees each), the boosting modes,
    a custom objective and init_model on the Higgs cell, lambdarank
    with bagging_by_query on this rank's queries of the [rank] cell, and
    the elastic cell's checkpointed run; writes each model text and a
    JSON of launches, ms, metrics, the collective record and staging."""
    sys.path.insert(0, HERE)
    import pickle
    import torch
    import lightgbm_tpu_torch as lgt
    from lightgbm_tpu_torch.ops import cuda_histogram as CH
    from lightgbm_tpu_torch.parallel import distributed as pdist
    pdist.init_distributed()
    me = pdist.rank()
    CH.load_library()
    t0 = time.perf_counter()
    X, y, Xv, yv = load_arrays(outdir, "higgs", 4)
    sets = {}
    for kind in ("data", "feature"):
        p = dict(PAR_PARAMS, tree_learner=kind)
        # the data sets keep the raw rows: init_model predicts its base
        # scores from this rank's block of them
        keep = kind == "data"
        tr = lgt.Dataset(X, label=y, params=p, free_raw_data=not keep)
        sets[kind] = (tr, lgt.Dataset(Xv, label=yv, reference=tr,
                                      free_raw_data=not keep))
        sets[kind][0].construct()
        sets[kind][1].construct()
    del X, Xv
    out = {"rank": me, "setup_s": time.perf_counter() - t0,
           "device": str(sets["data"][0].device),
           "rows": {k: int(v[0].num_data) for k, v in sets.items()},
           "arms": {}, "arm_s": {}}
    for name, extra in PARALLEL_ARMS:
        tr, va = sets["feature" if extra["tree_learner"] == "feature"
                      else "data"]
        out["arms"][name] = rank_arm(lgt, CH, outdir, me, name,
                                     dict(PAR_PARAMS, **extra), tr, va,
                                     PARALLEL_TREES)
    tr, va = sets["data"]
    for name, extra, rounds in PARALLEL_MODE_ARMS:
        t0 = time.perf_counter()
        kw = {}
        if name == "custom":
            fobj = card_binary_fobj(tr)
            seen = []

            def counted(preds, dataset, fobj=fobj, seen=seen):
                seen.append(len(preds))
                return fobj(preds, dataset)
            kw["fobj"] = counted
        elif name == "init_model":
            kw["init_model"] = os.path.join(outdir, "base.txt")
        out["arms"][name] = rank_arm(lgt, CH, outdir, me, name,
                                     dict(PAR_PARAMS, **extra), tr, va,
                                     rounds, **kw)
        if name == "custom":
            out["arms"][name]["fobj_rows"] = sorted(set(seen))
        out["arm_s"][name] = time.perf_counter() - t0
    # the elastic cell: 4 trees, checkpoints at 2 and 4; rank 0 then
    # deletes the one at 4, as if the run had stopped after 2
    t0 = time.perf_counter()
    ed = os.path.join(outdir, "elastic")
    p = dict(ELASTIC_PARAMS, output_model=os.path.join(ed, "m.txt"),
             event_log=os.path.join(ed, f"run{me}.events.jsonl"))
    out["arms"]["elastic"] = rank_arm(lgt, CH, outdir, me, "elastic", p, tr,
                                      va, ELASTIC_TREES)
    torch.distributed.barrier()
    if me == 0:
        for f in os.listdir(ed):
            if ".ckpt_iter_" in f and int(f.rsplit("_", 1)[1]) > 2:
                os.remove(os.path.join(ed, f))
    out["arm_s"]["elastic"] = time.perf_counter() - t0
    del sets, tr, va
    torch.cuda.empty_cache()
    # lambdarank on this rank's queries
    t0 = time.perf_counter()
    Xr, yr, sizes, Xrv, yrv, vsizes = load_arrays(outdir, "mslr", 6)
    Xr, yr, sizes = query_block(Xr, yr, sizes, me)
    Xrv, yrv, vsizes = query_block(Xrv, yrv, vsizes, me)
    p = dict(PARALLEL_RANK_PARAMS)
    tr = lgt.Dataset(Xr, label=yr, group=sizes, params=p)
    va = lgt.Dataset(Xrv, label=yrv, group=vsizes, reference=tr)
    tr.construct()
    va.construct()
    del Xr, Xrv
    out["rank_setup_s"] = time.perf_counter() - t0
    out["rank_rows"] = int(tr.num_data)
    if me == 0:
        with open(os.path.join(outdir, "mslr_mappers.pkl"), "wb") as fh:
            pickle.dump([m.state_arrays() for m in tr.bin_mappers], fh)
    t0 = time.perf_counter()
    out["arms"]["lambdarank"] = rank_arm(lgt, CH, outdir, me, "lambdarank",
                                         p, tr, va, PARALLEL_RANK_ITERS)
    out["arm_s"]["lambdarank"] = time.perf_counter() - t0
    with open(os.path.join(outdir, f"rank{me}.json"), "w") as fh:
        json.dump(out, fh)
    return 0


def serial_ref(lgt, CH, params, tr, va, rounds, **kw):
    """A serial eager ``fused_split=off`` run of the same bins: the
    reference a plan's arm is held to (model text, metrics, ms/tree)."""
    import torch
    hist = {}
    p = dict(params, tree_learner="serial", fused_train=False,
             fused_split="off")
    p.pop("pre_partition", None)
    torch.cuda.synchronize()
    CH.reset_launch_counts()
    t0 = time.perf_counter()
    if "init_scores" in kw:
        # continued training from scores predicted here (the raw rows
        # are gone): what train(init_model=...) does with them
        base, scores, vscores = kw.pop("init_scores")
        bst = lgt.Booster(params=p, train_set=tr)
        bst.add_valid(va, "valid")
        bst._set_init_model(base, scores, [vscores])
        for _ in range(rounds):
            bst.update()
        hist = {"valid": {k: [v] for _, k, v, _ in bst.eval_valid()}}
    else:
        bst = lgt.train(p, tr, rounds, valid_sets=[va],
                        valid_names=["valid"],
                        callbacks=[lgt.record_evaluation(hist)], **kw)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    out = dict(text=model_trees(bst.model_to_string()),
               metrics=hist["valid"], auc=hist["valid"].get("auc", [None])[-1],
               ms_tree=wall / rounds * 1e3, launches=dict(CH.LAUNCHES))
    del bst
    torch.cuda.empty_cache()
    return out


def b1_rank_root(CH, H, bins, label, B, tag):
    """B1 at a rank's root call (its rows, 2W slots): checked against
    the plain version and timed with it, ``index_add_`` and its bound."""
    import numpy as np
    import torch
    n = bins.shape[0]
    y_dev = torch.from_numpy(np.asarray(label, np.float32)).cuda()
    g, h = gradients(y_dev)
    gh = torch.stack([g, h, torch.ones_like(g)], 1).contiguous()
    W = PARAMS["leaf_batch"]
    ids = torch.full((2 * W,), -2, dtype=torch.int32, device="cuda")
    ids[0] = 0
    rl0 = torch.zeros(n, dtype=torch.int32, device="cuda")
    F = bins.shape[1]
    k = CH.build_histograms_cuda(bins, gh, rl0, ids, num_bins=B)
    want = H.build_histograms(bins, gh, rl0, ids, num_bins=B)
    torch.cuda.synchronize()
    err = check_close(f"[parallel] B1 {tag} rank root", k, want, 1e-4)
    ms = cuda_ms(lambda: CH.build_histograms_cuda(bins, gh, rl0, ids,
                                                  num_bins=B), 10)
    plain_ms = cuda_ms(lambda: H.build_histograms(bins, gh, rl0, ids,
                                                  num_bins=B), 2)
    lib_ms = index_add_ms(bins, gh, rl0, ids, B, n)
    bound, by = bound_of(hist_bytes(n, F, 12, False, 2 * W, B), 3 * n * F)
    log(f"[parallel] [B1] {tag} rank root rows={n} L={2 * W} F={F} B={B}: "
        f"{ms:.3f} ms (bound {bound:.3f} ms by {by}; plain {plain_ms:.3f} "
        f"ms; index_add_ {lib_ms:.3f} ms); max_abs_err {err:.3g}")
    return dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                bound_ms=bound, bound_by=by, max_abs_err=err, rows=n,
                L=2 * W, F=F, B=B)


def phase_parallel(lgt, CH, H, tr, va, higgs, rank_data, base_model):
    """``[parallel]``: serial eager card runs of the Higgs and MS LTR
    cells (the references), the two ranks' arms, the contracts, the
    elastic cell's serial resume, and B1 at a rank's root calls (5.25M
    Higgs rows; ~1.135M MS LTR rows). ``higgs`` is the Higgs cell's
    (X, y, Xv, yv), ``rank_data`` the [rank] cell's arrays,
    ``base_model`` the model file init_model continues."""
    import pickle
    import shutil
    import numpy as np
    import signal
    import torch
    from lightgbm_tpu_torch.binning import BinMapper
    t_phase = time.perf_counter()
    outdir = os.path.join(HERE, "build", "chip_smoke", "parallel")
    shutil.rmtree(outdir, ignore_errors=True)
    os.makedirs(os.path.join(outdir, "elastic"))
    shutil.copy(base_model, os.path.join(outdir, "base.txt"))
    t0 = time.perf_counter()
    save_arrays(outdir, "higgs", higgs)
    save_arrays(outdir, "mslr", rank_data)
    save_s = time.perf_counter() - t0
    script = os.path.join(outdir, "rank.py")
    with open(script, "w") as fh:
        fh.write(f"import sys\nsys.path.insert(0, {HERE!r})\n"
                 f"import chip_smoke\n"
                 f"sys.exit(chip_smoke.parallel_rank({outdir!r}))\n")
    t0 = time.perf_counter()
    p = subprocess.Popen(
        [sys.executable, "-m", "lightgbm_tpu_torch.launch", "-n",
         str(PARALLEL_RANKS), script], cwd=HERE,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        start_new_session=True)
    # the serial references run while the ranks set up
    refs = {}
    X, y, Xv, yv = higgs
    t_refs = time.perf_counter()
    for name, extra, rounds in (
            ("quant", dict(QUANT), ELASTIC_TREES),
            ("float", {}, PARALLEL_TREES),
            *PARALLEL_MODE_ARMS):
        kw = {}
        if name == "custom":
            kw["fobj"] = card_binary_fobj(tr)
        elif name == "init_model":
            base = lgt.Booster(model_file=base_model,
                               params={"device_type": "cuda"})
            kw["init_scores"] = (base, base.predict(X, raw_score=True),
                                 base.predict(Xv, raw_score=True))
        refs[name] = serial_ref(lgt, CH, dict(PAR_PARAMS, **extra), tr, va,
                                rounds, **kw)
        log(f"[parallel] serial eager {name} (fused_split=off): "
            f"{refs[name]['ms_tree']:.1f} ms/tree, valid AUC "
            f"{refs[name]['auc']:.6f}, launches {refs[name]['launches']}")
    refs_s = time.perf_counter() - t_refs
    try:
        text, _ = p.communicate(timeout=max(
            1.0, PARALLEL_TIMEOUT_S - (time.perf_counter() - t0)))
    except subprocess.TimeoutExpired:
        os.killpg(p.pid, signal.SIGKILL)
        text, _ = p.communicate()
        raise AssertionError("[parallel] ranks hung past "
                             f"{PARALLEL_TIMEOUT_S} s: "
                             + text.decode()[-3000:])
    group_s = time.perf_counter() - t0
    if p.returncode != 0:
        raise AssertionError(f"[parallel] ranks exited {p.returncode}: "
                             + text.decode()[-4000:])
    ranks = []
    for r in range(PARALLEL_RANKS):
        with open(os.path.join(outdir, f"rank{r}.json")) as fh:
            ranks.append(json.load(fh))

    def text_of(name, r=0):
        with open(os.path.join(outdir, f"{name}.rank{r}.txt")) as fh:
            return fh.read()
    log(f"[parallel] {PARALLEL_RANKS} ranks on {ranks[0]['device']} "
        f"({ranks[0]['arms']['float_allreduce']['backend']}), group "
        f"{group_s:.1f} s (set-up {ranks[0]['setup_s']:.1f} s: data, "
        f"mapper sync, binning; MS LTR set-up "
        f"{ranks[0]['rank_setup_s']:.1f} s); rows a rank "
        f"{ranks[0]['rows']}, MS LTR {ranks[0]['rank_rows']} / "
        f"{ranks[1]['rank_rows']}; serial references {refs_s:.1f} s "
        f"beside the ranks' set-up; the data saved for the ranks in "
        f"{save_s:.1f} s")
    for f in os.listdir(outdir):
        if f.endswith(".npy"):
            os.remove(os.path.join(outdir, f))
    # lambdarank: the serial run on every query, on the ranks' mappers
    Xr, yr, sizes, Xrv, yrv, vsizes = rank_data
    with open(os.path.join(outdir, "mslr_mappers.pkl"), "rb") as fh:
        maps = [BinMapper.from_state_arrays(*a) for a in pickle.load(fh)]
    rp = dict(PARALLEL_RANK_PARAMS)
    rtr = lgt.Dataset(Xr, label=yr, group=sizes, params=rp,
                      bin_mappers=maps)
    rva = lgt.Dataset(Xrv, label=yrv, group=vsizes, reference=rtr)
    refs["lambdarank"] = serial_ref(lgt, CH, rp, rtr, rva,
                                    PARALLEL_RANK_ITERS)
    per_tree_launches = {}
    arms = ([(n, PARALLEL_TREES) for n, _ in PARALLEL_ARMS]
            + [(n, r) for n, _, r in PARALLEL_MODE_ARMS]
            + [("elastic", ELASTIC_TREES),
               ("lambdarank", PARALLEL_RANK_ITERS)])
    for name, rounds in arms:
        a = [rk["arms"][name] for rk in ranks]
        if a[0]["sha"] != a[1]["sha"]:
            raise AssertionError(f"[parallel] {name}: the ranks' models "
                                 "differ")
        b1 = [x["launches"]["build_histograms_cuda"] / rounds for x in a]
        if (b1[0] != b1[1] or b1[0] <= 0
                or any(x["launches"]["fused_build_best_splits"]
                       or x["launches"]["build_root_histograms_classes"]
                       for x in a)):
            raise AssertionError(f"[parallel] {name}: launches "
                                 f"{[x['launches'] for x in a]}")
        per_tree_launches[name] = b1[0]
        ref = refs.get(name, refs["quant" if "quant" in name
                                   or name == "elastic" else "float"])
        log(f"[parallel] {name}: {a[0]['ms_tree']:.1f} / "
            f"{a[1]['ms_tree']:.1f} ms/tree (ranks 0 / 1; serial eager "
            f"{ref['ms_tree']:.1f}), valid {a[0]['metrics']}; B1 "
            f"{b1[0]:.0f} a tree a rank; collectives a tree "
            f"{a[0]['collectives_per_tree']:.0f}, bytes a tree by kind "
            f"{a[0]['bytes_by_kind']}, histogram "
            f"{a[0]['hist_bytes_per_tree']:.0f} ({a[0]['hist_kinds']}); "
            f"staged {a[0]['staged_bytes']} B in {a[0]['staged_ms']:.1f} ms"
            f"; models sha {a[0]['sha'][:12]} on both ranks")
    quant_ref = tree_blocks(refs["quant"]["text"], PARALLEL_TREES)
    for name in ("quant_allreduce", "quant_reduce_scatter"):
        if tree_blocks(text_of(name)) != quant_ref:
            raise AssertionError(f"[parallel] {name}: trees differ from "
                                 "the serial quantized run's")
    if text_of("float_reduce_scatter") != text_of("float_allreduce"):
        raise AssertionError("[parallel] float reduce-scatter differs "
                             "from allreduce")
    if text_of("feature") != refs["float"]["text"]:
        raise AssertionError("[parallel] feature-parallel trees differ "
                             "from the serial run's")
    # voting with 2 * top_k >= F elects every column: the data plan's
    # trees; its subtraction cache holds the ranks' local sums, so the
    # sibling's f32 sums add in another order (leaves within 1e-5)
    got = tree_fields(text_of("voting_top20"))
    want = tree_fields(text_of("float_allreduce"))
    for (sg, lg), (sw, lw) in zip(got, want):
        if sg != sw:
            raise AssertionError("[parallel] voting top_k=20 trees differ "
                                 "from data-parallel")
        np.testing.assert_allclose(lg, lw, rtol=1e-5,
                                   atol=1e-5 * max(map(abs, lw)))
    d_auc = abs(ranks[0]["arms"]["voting_top5"]["auc"] - refs["float"]["auc"])
    if d_auc > 0.01:
        raise AssertionError(f"[parallel] voting top_k=5 AUC off by {d_auc}")
    # GOSS, DART, RF, the custom objective and init_model: the serial
    # model byte for byte, the same valid AUC
    for name, _, _ in PARALLEL_MODE_ARMS:
        if text_of(name) != refs[name]["text"]:
            raise AssertionError(f"[parallel] {name}: trees differ from "
                                 "the serial run's")
        if ranks[0]["arms"][name]["auc"] != refs[name]["auc"]:
            raise AssertionError(f"[parallel] {name}: valid AUC "
                                 f"{ranks[0]['arms'][name]['auc']} against "
                                 f"serial {refs[name]['auc']}")
    for rk in ranks:
        if rk["arms"]["custom"]["fobj_rows"] != [rk["rows"]["data"]]:
            raise AssertionError("[parallel] custom: the objective saw "
                                 f"{rk['arms']['custom']['fobj_rows']} "
                                 f"rows, the rank holds {rk['rows']['data']}")
    rs, ar = (ranks[0]["arms"][f"float_{m}"] for m in ("reduce_scatter",
                                                       "allreduce"))
    log(f"[parallel] quantized data-parallel = serial at both merges; "
        f"float reduce-scatter = allreduce; feature = serial; voting "
        f"top_k=20 = data-parallel (structure, leaves within 1e-5); "
        f"top_k=5 AUC {d_auc:.2e} from serial; GOSS, DART, RF, the custom "
        f"objective (its rows: this rank's) and init_model = serial; "
        f"histogram bytes a tree reduce-scatter / allreduce "
        f"{rs['hist_bytes_per_tree'] / ar['hist_bytes_per_tree']:.4f}")

    # the elastic cell: resume serially from the ranks' checkpoint at 2
    ed = os.path.join(outdir, "elastic")
    t0 = time.perf_counter()
    ev_log = os.path.join(ed, "run0.events.jsonl")   # rank 0's fingerprint
    bst = lgt.train(dict(ELASTIC_PARAMS, tree_learner="serial",
                         output_model=os.path.join(ed, "m.txt"),
                         event_log=ev_log), tr, ELASTIC_TREES,
                    valid_sets=[va], valid_names=["valid"])
    torch.cuda.synchronize()
    resume_s = time.perf_counter() - t0
    with open(ev_log) as fh:
        evs = [json.loads(ln) for ln in fh if ln.strip()]
    resh = [e for e in evs if e["event"] == "reshard"]
    resumed = [e for e in evs if e["event"] == "resume"]
    if tree_blocks(bst.model_to_string()) != tree_blocks(
            refs["quant"]["text"]):
        raise AssertionError("[parallel] elastic: the resumed trees differ "
                             "from the serial run's")
    if not (resh and resumed and resumed[-1]["iter"] == 2
            and resh[-1]["from"]["num_shards"] == PARALLEL_RANKS
            and resh[-1]["to"]["tree_learner"] == "serial"):
        raise AssertionError(f"[parallel] elastic: resume {resumed}, "
                             f"reshard {resh}")
    del bst
    torch.cuda.empty_cache()
    log(f"[parallel] elastic: {PARALLEL_RANKS} ranks checkpointed at "
        f"iteration 2 of {ELASTIC_TREES}; this process resumed serially "
        f"on the card in {resume_s:.2f} s; {ELASTIC_TREES} trees = the "
        f"serial run's; reshard {resh[-1]['from']['parallel_mode']} x "
        f"{resh[-1]['from']['num_shards']} -> serial")

    got = ranks[0]["arms"]["lambdarank"]
    nd_s = refs["lambdarank"]["metrics"]["ndcg@10"]
    nd_p = got["metrics"]["ndcg@10"]
    if text_of("lambdarank") != refs["lambdarank"]["text"]:
        raise AssertionError("[parallel] lambdarank: trees differ from the "
                             "serial run's")
    if abs(nd_p[-1] - nd_s[-1]) > 1e-6:
        raise AssertionError(f"[parallel] lambdarank: gathered NDCG@10 "
                             f"{nd_p} against serial {nd_s}")
    log(f"[parallel] lambdarank with bagging_by_query, "
        f"{PARALLEL_RANK_ITERS} iterations: {got['ms_tree']:.1f} / "
        f"{ranks[1]['arms']['lambdarank']['ms_tree']:.1f} ms/iteration "
        f"(ranks 0 / 1; serial eager {refs['lambdarank']['ms_tree']:.1f}); "
        f"= serial, gathered valid NDCG@10 {nd_p[-1]:.6f} (serial "
        f"{nd_s[-1]:.6f})")
    log("[parallel] seconds an arm on rank 0 (set-up excluded): "
        + ", ".join(f"{k} {v:.1f}" for k, v in ranks[0]["arm_s"].items()))
    # B1 at a rank's root calls: 5.25M Higgs rows; its MS LTR queries
    n = ranks[0]["rows"]["data"]
    b1 = b1_rank_root(CH, H, tr.bins[:n], tr.get_label()[:n],
                      tr.max_num_bin, "Higgs")
    nr = ranks[0]["rank_rows"]
    b1_rank = b1_rank_root(CH, H, rtr.bins[:nr], rtr.get_label()[:nr],
                           rtr.max_num_bin, "MS LTR")
    del rtr, rva
    torch.cuda.empty_cache()
    log(f"[parallel] phase took {time.perf_counter() - t_phase:.1f} s")
    return dict(launches=per_tree_launches, ranks=ranks, refs=refs,
                b1=b1, b1_rank=b1_rank)


# -- this slice: the trace doctor and the chaos harness on the card --------
DOCTOR_ITERS = 20
CHAOS_RUNS = (("fused/serial", ["--cell", "fused/serial", "--kills", "5"]),
              ("elastic/4ar-serial1", ["--elastic", "--cell",
                                       "elastic/4ar-serial1"]))


def start_chaos():
    """The two ``[chaos]`` runs of ``scripts/torch_chaos_train.py`` on the
    card, started together in the background (each in a process group
    of its own, killed at exit if it still runs)."""
    import atexit
    script = os.path.join(HERE, "scripts", "torch_chaos_train.py")
    procs = {name: start_proc([sys.executable, script, *args],
                              timeout=600, group=True)
             for name, args in CHAOS_RUNS}
    atexit.register(kill_procs, list(procs.values()))
    return procs


def verdict(rep):
    """One report's verdict and finding counts, for the log."""
    n = {sev: sum(1 for f in rep.findings if f.severity == sev)
         for sev in ("error", "warn", "info")}
    waived = sum(1 for f in rep.findings if f.waived)
    state = "clean" if rep.ok and not n["warn"] else (
        "warn" if rep.ok else "FAIL")
    return (f"{rep.label}: {state} ({n['error']} error, {n['warn']} warn, "
            f"{n['info']} info, {waived} waived)")


def phase_doctor_full(CH, higgs_bst):
    """``[doctor]`` at full width, alone on the card (before the
    ``[chaos]`` runs start): the step of phase 4's Higgs booster (10.5M
    rows x 28) once more under the recorder and
    ``set_sync_debug_mode("error")``: no host sync (TD002), one build
    span (TD005), two deferred flags (TD006); then a
    ``CaptureGuard(max_captures=0)`` over DOCTOR_ITERS further
    iterations: 0 captures, each replay the captured launches."""
    import torch
    from lightgbm_tpu_torch.analysis import (CaptureGuard,
                                             count_deferred_flags,
                                             merge_errors)
    from lightgbm_tpu_torch.analysis import doctor as D
    from lightgbm_tpu_torch.analysis.op_lint import host_syncs
    t0 = time.perf_counter()
    gb = higgs_bst._gbdt
    out = {}
    reps = D.doctor_fused_step(higgs_bst, label="fused_step[higgs full]",
                               deferred_guard=True, out=out)
    tr = out["trace"]
    for r in reps:
        log("[doctor] " + verdict(r))
    flags = count_deferred_flags(gb._layout)
    syncs = host_syncs(tr)
    builds = tr.phase_totals.count("build")
    log(f"[doctor] Higgs step at {gb.train_dd.r_pad} rows: {len(tr.ops)} "
        f"aten ops, {len(syncs)} host syncs (sync debug mode: "
        f"{tr.sync_error or 'no sync refused'}), {builds} build span, "
        f"{flags} deferred flags, launches {tr.launches}, "
        f"{time.perf_counter() - t0:.1f} s")
    if merge_errors(reps) or syncs or tr.sync_error or builds != 1 \
            or flags != 2:
        raise AssertionError("[doctor] the full-width step is not clean")
    if tr.launches != dict(gb._graph_launches):
        raise AssertionError(f"[doctor] the body launched {tr.launches}, "
                             f"its graph {dict(gb._graph_launches)}")
    torch.cuda.synchronize()
    CH.reset_launch_counts()
    t1 = time.perf_counter()
    with CaptureGuard(max_captures=0, boosters=[higgs_bst],
                      label="higgs steady state") as g:
        for _ in range(DOCTOR_ITERS):
            higgs_bst.update(defer=True)
        gb.sync()
    torch.cuda.synchronize()
    steady_s = time.perf_counter() - t1
    launches = dict(CH.LAUNCHES)
    want = {k: DOCTOR_ITERS * v for k, v in gb._graph_launches.items()}
    log(f"[doctor] {DOCTOR_ITERS} further iterations under "
        f"CaptureGuard(max_captures=0), alone on the card: {g.captures} "
        f"captures, {g.loads} library loads, launches {launches} "
        f"({DOCTOR_ITERS} x {dict(gb._graph_launches)}), "
        f"{steady_s / DOCTOR_ITERS * 1e3:.1f} ms/iteration")
    if launches != want:
        raise AssertionError(f"[doctor] launches {launches}, want {want}")
    return dict(launches=launches, body_launches=tr.launches,
                full_s=time.perf_counter() - t0)


def phase_doctor(lgt, CH):
    """``[doctor]``'s battery, beside the ``[chaos]`` runs: ``run_doctor``
    over the seven canonical configs (serial): every target clean, but
    TD007 on B2, reported as a warning (the port's B2 passes its lattice
    through HBM, ROADMAP B.5) while its negative control, the two-pass
    arm, shows the lattice."""
    from lightgbm_tpu_torch.analysis import merge_errors, run_doctor
    from lightgbm_tpu_torch.analysis import doctor as D
    t0 = time.perf_counter()
    reports = run_doctor(modes=["serial"], device="cuda")
    for r in reports:
        log("[doctor] " + verdict(r))
    errs = merge_errors(reports)
    if errs:
        raise AssertionError("[doctor] errors: " + "; ".join(
            f.render() for f in errs))
    warns = [f for r in reports for f in r.findings if f.severity == "warn"]
    if [(f.rule, f.label) for f in warns] != [("TD007", "fused_split")] \
            or "ROADMAP B.5" not in warns[0].message:
        raise AssertionError(f"[doctor] warnings {[f.render() for f in warns]}"
                             ", want TD007 on B2 alone")
    log(f"[doctor] TD007 on B2: {warns[0].render()}")
    split = {}
    D.doctor_fused_split(device="cuda", out=split)
    log(f"[doctor] fused_split arms' launches: fused {split['fused'].launches}"
        f", two-pass (the negative control) {split['two_pass'].launches}")
    return dict(split_launches={k: v.launches for k, v in split.items()},
                battery_s=time.perf_counter() - t0)


def phase_chaos(procs):
    """``[chaos]``: the two harness runs started by :func:`start_chaos`
    must exit 0; prints the checks each passed, its seconds and the
    kernel launches of its finished children."""
    out = {"launches": {}}
    for name, h in procs.items():
        secs = wait_proc(h, f"[chaos] {name}")
        text = proc_output(h)
        ok = [ln.strip()[4:] for ln in text.splitlines()
              if ln.startswith("  ok  ")]
        tail = [ln for ln in text.splitlines()
                if ln.startswith("torch_chaos_train:")]
        for ln in tail:
            if "kernel launches" in ln:
                for k, n in json.loads(ln.split("runs ", 1)[1]).items():
                    out["launches"][k] = out["launches"].get(k, 0) + n
        log(f"[chaos] {name}: exit 0 in {secs:.1f} s; {len(ok)} checks "
            f"passed: " + "; ".join(ok))
        log(f"[chaos] {name}: " + " | ".join(tail))
        out[name] = secs
    return out


def main():
    if not os.path.isdir(os.path.join(HERE, "lightgbm_tpu_torch")):
        print("chip_smoke.py: lightgbm_tpu_torch is not beside this script",
              file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke.py: no CUDA device visible", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    import lightgbm_tpu_torch as lgt
    from lightgbm_tpu_torch.ops import cuda_histogram as CH
    from lightgbm_tpu_torch.ops import histogram as H
    from lightgbm_tpu_torch.ops import split as SP
    t_start = time.perf_counter()

    def mark(what):
        log(f"[time] {what} starts at {time.perf_counter() - t_start:.1f} s")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    log(f"torch {torch.__version__} cuda {torch.version.cuda}; "
        f"{torch.cuda.get_device_name(0)}")
    # nvcc builds the kernels while this process makes the Higgs data
    import threading
    build = {}

    def _build():
        t = time.perf_counter()
        try:
            CH.load_library()
        except Exception as e:          # re-raised below, on this thread
            build["error"] = e
        build["s"] = time.perf_counter() - t
    build_thread = threading.Thread(target=_build, daemon=True)
    build_thread.start()
    t0 = time.perf_counter()
    X_all, y_all = make_higgs_like(HIGGS_ROWS + VALID_ROWS)
    X, y = X_all[:HIGGS_ROWS], y_all[:HIGGS_ROWS]
    Xv, yv = X_all[HIGGS_ROWS:], y_all[HIGGS_ROWS:]
    log(f"[data] Higgs-shaped {HIGGS_ROWS} + {VALID_ROWS} rows x 28 made in "
        f"{time.perf_counter() - t0:.1f} s (beside the kernels' build)")
    # the CPU legs of the small [parity] checks and of [linear] run from
    # here on, beside the card phases, in a worker
    early_legs = start_early_legs(X, y)
    build_thread.join()
    if "error" in build:
        raise build["error"]
    log(f"[build] kernels built in {build['s']:.1f} s: "
        f"{CH.BUILD_INFO.get('nvcc', 'cached library')}")
    for ln in CH.BUILD_INFO.get("log", "").splitlines():
        if "registers" in ln or "Compiling entry" in ln:
            log("[build] " + ln.strip())

    results = {"B1": {}, "B2": {}}
    ds = lgt.Dataset(X, label=y, params=dict(PARAMS)).construct()
    y_dev = torch.from_numpy(y).to("cuda")
    streams = phase_b1(ds, y_dev, CH, H, results)
    phase_b2(ds, CH, SP, streams, results, y_dev)
    del streams, ds
    torch.cuda.empty_cache()

    mark("[full]")
    runs, higgs_tr, higgs_va = phase_full(lgt, CH, X, y, Xv, yv)
    mark("[telemetry]")
    tele = phase_telemetry(lgt, CH, higgs_tr, higgs_va,
                           runs["auto"]["bst"]._trees, runs["auto"]["ms_tree"],
                           smi)
    mark("[parity]")
    early = child_result(early_legs, "[parity]")
    phase_small_parity(lgt, X, y, 1 << 15, cpu=early["binary"])
    phase_small_parity(lgt, X, y, 1 << 15, dict(PARAMS, **QUANT),
                       "quantized binary", cpu=early["quantized binary"])
    higgs_valid, higgs_yv = Xv.copy(), yv.copy()   # [serve], [dart], [rf]
    n_par = MODE_PARITY_ROWS + (MODE_PARITY_ROWS >> 1)
    higgs_small = (X[:n_par].copy(), y[:n_par].copy())    # [parity]
    higgs_rows = (X.copy(), y.copy())             # [continue], [cv]
    del X_all, X, y, Xv, yv
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    Xc_all, yc_all = make_covtype_like(COVTYPE_ROWS + COVTYPE_VALID)
    Xc, yc = Xc_all[:COVTYPE_ROWS], yc_all[:COVTYPE_ROWS]
    Xcv, ycv = Xc_all[COVTYPE_ROWS:], yc_all[COVTYPE_ROWS:]
    log(f"[data] Covertype-shaped {COVTYPE_ROWS} + {COVTYPE_VALID} rows x 54"
        f" made in {time.perf_counter() - t0:.1f} s; class shares "
        + " ".join(f"{v:.4f}" for v in np.bincount(
            yc.astype(np.int64), minlength=NUM_CLASS) / len(yc)))
    # the CPU arms of [mc-parity], [efb] and [cat], in a worker
    covtype_legs = start_covtype_legs(Xc, yc)
    results["B3"] = {}
    ds = lgt.Dataset(Xc, label=yc, params=dict(MC_PARAMS)).construct()
    yc_dev = torch.from_numpy(yc).to("cuda")
    mark("[B3]")
    phase_b3(ds, yc_dev, CH, H, results)
    phase_mc_stream(ds, yc_dev, CH, H, SP, results)
    del ds, yc_dev
    torch.cuda.empty_cache()
    mark("[mc-full]")
    mc_runs, cov_tr = phase_mc_full(lgt, CH, Xc, yc, Xcv, ycv)

    mark("[step]")
    # the captured step against the eager loop, in turns, at full scale
    phase_step(lgt, CH, [
        ("higgs B2", higgs_tr, PARAMS, 5, (True, False, False, True)),
        ("higgs B1", higgs_tr, dict(PARAMS, fused_split="off"), 3,
         (True, False)),
        ("higgs bagging", higgs_tr,
         dict(PARAMS, bagging_fraction=0.8, bagging_freq=5), 6,
         (True, False)),
        ("covtype class-batched", cov_tr, MC_PARAMS, 5,
         (True, False, False, True)),
        ("covtype per-class", cov_tr, dict(MC_PARAMS, class_batch="off"), 3,
         (True, False)),
    ])
    mark("[quant]")
    quant = phase_quant(lgt, CH, higgs_tr, higgs_va, runs["auto"]["aucs"][-1])
    mark("[goss]")
    phase_goss(lgt, higgs_tr, CH)
    mark("[dart]")
    dart = phase_dart(lgt, CH, higgs_tr, higgs_va, higgs_valid, higgs_yv)
    mark("[rf]")
    rf = phase_rf(lgt, CH, higgs_tr, higgs_va, higgs_valid, higgs_yv)
    mark("[fobj]")
    fobj = phase_fobj(lgt, CH, higgs_tr)
    mark("[mc-fobj]")
    mc_fobj = phase_mc_fobj(lgt, CH, cov_tr)
    mark("[continue]")
    full_model = os.path.join(HERE, "build", "chip_smoke", "model.txt")
    cont = phase_continue(lgt, CH, *higgs_rows, higgs_valid, higgs_yv,
                          full_model)
    mark("[cv]")
    cvr = phase_cv(lgt, CH, *higgs_rows)
    mark("[ooc]")
    ooc = phase_ooc(lgt, CH, H, *higgs_rows)
    mark("[refit]")
    refit = phase_refit(lgt, runs["auto"]["bst"], full_model,
                        higgs_valid[:REFIT_ROWS], higgs_yv[:REFIT_ROWS])
    log(f"[A6a] ms/tree fobj (eager) {fobj['ms']:.1f} against captured "
        f"{fobj['captured_ms']:.1f}; Covertype fobj ms/iteration "
        f"{mc_fobj['ms']:.1f} against captured {mc_fobj['captured_ms']:.1f};"
        f" continued 5 trees {cont['cont_s']:.2f} s, RF 3 + 2 "
        f"{cont['rf_s']:.2f} s; cv {cvr['s']:.2f} s; refit card "
        f"{refit['card_s']:.2f} s, CPU {refit['cpu_s']:.2f} s")
    mark("[opts]")
    opts = phase_opts(lgt, CH, SP, higgs_tr, higgs_va, higgs_valid, higgs_yv)
    # the CPU legs of the Higgs [parity] checks run from here on, beside
    # the card phases, in a worker; phase 23 collects them
    parity_jobs = higgs_parity_jobs(opts["params"], *higgs_small)
    cpu_legs = start_cpu_legs(parity_jobs)
    mark("[quant-mc]")
    quant_mc = phase_quant_mc(lgt, CH, cov_tr)
    # [opts] on Covertype: per-class keys, B3's root, then B1
    cov_opts = phase_step(lgt, CH, [
        ("covtype bynode + extra_trees class-batched", cov_tr,
         dict(MC_PARAMS, feature_fraction_bynode=0.8, extra_trees=True), 2,
         (True, False), dict(debug=True))], tag="[opts]")
    r = next(iter(cov_opts.values()))[0][1]
    opts["launches"]["covtype_bynode_extra_trees"] = r["launches"]
    per_it = {k: v // 2 for k, v in r["launches"].items()}
    log(f"[opts] covtype bynode + extra_trees class-batched: launches an "
        f"iteration {per_it}")
    if per_it != {"build_histograms_cuda": per_tree(MC_PARAMS) - 1,
                  "fused_build_best_splits": 0,
                  "build_root_histograms_classes": 1}:
        raise AssertionError(f"[opts] covtype: launches {per_it}")
    del cov_tr, cov_opts, r
    torch.cuda.empty_cache()
    mark("[mc-parity]")
    cov_cpu = child_result(covtype_legs, "[mc-parity]")
    phase_mc_parity(lgt, Xc, yc, 1 << 15, iters=1, cpu_runs={
        k: cov_cpu[k] for k in ("cpu", "cpu quantized")})
    mark("[efb]")
    efb = phase_efb(lgt, CH, H, Xc, yc, Xcv, ycv, mc_runs, results,
                    cpu_runs={"cpu": cov_cpu["efb"]})
    mark("[cat]")
    cat_ms = phase_cat(lgt, CH, Xc, yc, Xcv, ycv, results,
                       cpu_runs={"cpu": cov_cpu["cat"]})
    log(f"[efb] [cat] captured ms/iteration: EFB class-batched "
        f"{efb['ms']:.1f}, categorical class-batched {cat_ms:.1f}")
    cov_valid = Xcv.copy()                     # for [serve]
    del Xc_all, Xc, yc, Xcv, ycv
    torch.cuda.empty_cache()
    mark("[regression]")
    _, Xy, yy = phase_year(lgt, CH)
    phase_small_parity(lgt, Xy, yy, 1 << 15, YEAR_PARAMS, "regression (L2)",
                       trees=1, cpu=early["regression (L2)"])
    del Xy, yy
    torch.cuda.empty_cache()
    mark("[rank]")
    rank = phase_rank(lgt, CH, SP, H, results)
    mark("[parity] modes")
    rank_data = rank.pop("data")                  # [parallel] too
    phase_mode_parity(lgt, rank_data, parity_jobs, cpu_legs)
    torch.cuda.empty_cache()
    mark("[serve]")
    phase_serve(lgt, CH, runs["auto"]["bst"], higgs_valid,
                mc_runs["auto"]["bst"], cov_valid)
    higgs_bst = runs["auto"]["bst"]                # [doctor]
    for rr in (*runs.values(), *mc_runs.values()):
        rr.pop("bst", None)                # free the models' device state
    del cov_valid
    torch.cuda.empty_cache()
    mark("[wide]")
    # [sparse]'s CPU bins are made from here on, beside the card phases
    os.makedirs(os.path.join(HERE, "build", "chip_smoke"), exist_ok=True)
    sparse_cpu = start_child("sparse_cpu_bins_child", os.path.join(
        HERE, "build", "chip_smoke", "sparse_cpu_bins"))
    wide = phase_wide(lgt, CH, H, SP)
    mark("[wide-efb]")
    wide_efb = phase_wide_efb(lgt, CH, H)
    mark("[linear]")
    linear = phase_linear(lgt, CH, cpu=early["linear"])
    mark("[sparse]")
    sparse = phase_sparse(lgt, CH, H, results, sparse_cpu)
    mark("[cli]")
    cli_res = phase_cli(lgt, CH, (sparse.pop("X"), sparse.pop("y")))
    mark("[resume]")
    resume = phase_resume(lgt, CH, cli_res["csv"])
    mark("[parallel]")
    par = phase_parallel(lgt, CH, H, higgs_tr, higgs_va,
                         (*higgs_rows, higgs_valid, higgs_yv), rank_data,
                         full_model)
    del higgs_tr, higgs_va, higgs_rows, higgs_valid, rank_data
    torch.cuda.empty_cache()
    mark("[doctor]")
    t_new = time.perf_counter()
    doctor = phase_doctor_full(CH, higgs_bst)
    del higgs_bst
    torch.cuda.empty_cache()
    chaos_procs = start_chaos()        # beside the battery, on the card
    doctor.update(phase_doctor(lgt, CH))
    mark("[chaos]")
    chaos = phase_chaos(chaos_procs)
    log(f"[doctor] [chaos] {time.perf_counter() - t_new:.1f} s together "
        f"(battery {doctor['battery_s']:.1f} s, full width "
        f"{doctor['full_s']:.1f} s; chaos runs " + ", ".join(
            f"{n} {chaos[n]:.1f} s" for n, _ in CHAOS_RUNS) + ")")
    mark("the kernels line")
    wide_runs = ("[wide] Higgs max_bin 1023 captured, B2 5 and B1 "
                 "(fused_split=off) 3 iterations after iteration 0; "
                 "Covertype max_bin 1023 class-batched captured, 3; "
                 "[wide-efb] 2^21 x 64 sparse columns in 16 bundles "
                 "captured, 5; [linear] Year linear_tree, 5 (eager loop)")

    def launches_wide(name):
        return dict(
            higgs_b2=wide["launches"]["higgs_b2"][name],
            higgs_b1=wide["launches"]["higgs_b1"][name],
            covtype_class_batched=wide["launches"][
                "covtype_class_batched"][name],
            efb=wide_efb["launches"][name],
            linear=linear["launches"][name])

    a6a_runs = ("[fobj] Higgs fobj, 5 trees (eager loop); [fobj] "
                "fused_split=off, 2; [mc-fobj] Covertype fobj "
                "class-batched, 2 iterations; [continue] the [full] model "
                "continued 5 trees (captured); [continue] RF continued 2 "
                "(eager loop); [cv] 3 folds x 5 rounds (captured)")

    def launches_a6a(name):
        return dict(fobj=fobj["launches"][name],
                    fobj_fused_split_off=fobj["b1_launches"][name],
                    mc_fobj=mc_fobj["launches"][name],
                    continue_gbdt=cont["launches"][name],
                    continue_rf=cont["rf_launches"][name],
                    cv=cvr["launches"][name])

    a6b_runs = ("[sparse] Allstate-shaped CSR, 5 regression trees "
                "(captured, B1 over EFB bundles); [cli] the in-process "
                "train on the CLI's CSV, 5 trees (captured, B2)")

    def launches_a6b(name):
        return dict(sparse=sparse["launches"][name],
                    cli=cli_res["launches"][name])

    a7_runs = ("[ooc] float_chunked and int8_chunked: 3 Higgs trees each "
               "out of core (B1 a chunk, never B2), auto_over_capacity: 2; "
               "[resume] clean, preempted (the resumed run), rollback and "
               "degrade: 10 iterations at 2^20 rows through the captured "
               "step (B2), shards: 2 trees from the ingested shards "
               "(chunked, B1)")

    def launches_a7(name):
        out = {k: v[name] for k, v in ooc["launches"].items()}
        out.update({f"resume_{k}": v[name]
                    for k, v in resume["launches"].items()})
        return out

    tele_runs = ("[telemetry] Higgs captured with telemetry_port, "
                 f"event_log and a /trace capture, {TELEMETRY_ITERS} "
                 "iterations; eager "
                 "fused_split=off with an event log, 3")
    par_runs = (f"[parallel] {PARALLEL_RANKS} ranks on one card (gloo), "
                "eager, launches a tree a rank: Higgs "
                + ", ".join(f"{n} ({PARALLEL_TREES})"
                            for n, _ in PARALLEL_ARMS) + ", "
                + ", ".join(f"{n} ({r})" for n, _, r in PARALLEL_MODE_ARMS)
                + f", elastic ({ELASTIC_TREES}, checkpointed at 2); MS "
                f"LTR lambdarank ({PARALLEL_RANK_ITERS})")

    def launches_parallel(name):
        arms = par["ranks"][0]["arms"]
        return {arm: a["launches"][name] / a["rounds"]
                for arm, a in arms.items()}

    doctor_runs = ("[doctor] the Higgs [full] step body under the recorder "
                   f"(body), {DOCTOR_ITERS} further captured iterations "
                   "(steady), the fused_split target's fused and two-pass "
                   "arms")
    chaos_runs = ("[chaos] the finished children of torch_chaos_train.py "
                  "--cell fused/serial --kills 5 and --elastic --cell "
                  "elastic/4ar-serial1 (rank 0's), summed")

    def launches_doctor(name):
        return dict(body=doctor["body_launches"][name],
                    steady=doctor["launches"][name],
                    fused_split=doctor["split_launches"]["fused"][name],
                    two_pass=doctor["split_launches"]["two_pass"][name])

    if "jax" in sys.modules or "lightgbm_tpu" in sys.modules:
        raise AssertionError("the port pulled in jax or lightgbm_tpu")
    src = "lightgbm_tpu_torch/csrc/histogram.cu"
    kernels = []
    for name, key, replaces, run, n8 in (
            ("build_histograms_cuda", "B1",
             "lightgbm_tpu/ops/pallas_histogram.py:199", "off",
             quant["launches_b1"]),
            ("fused_build_best_splits", "B2",
             "lightgbm_tpu/ops/pallas_histogram.py:460", "auto",
             quant["launches_b2"])):
        r = results[key]["root"]
        c = results[key]["child"]
        m = results[key]["mc"]
        extra = dict(
            launches_rank=rank["b1_launches" if key == "B1"
                               else "launches"][name],
            launches_rank_run=(
                "[rank] MS LTR-shaped lambdarank captured, "
                + ("fused_split=off, 2" if key == "B1" else "10")
                + " iterations after iteration 0"),
            launches_dart=dart["defaults"]["launches"][name],
            launches_dart_run="[dart] Higgs-shaped DART at its defaults, "
                              f"{DART_ITERS} iterations (eager loop)",
            launches_rf=rf["launches"][name],
            launches_rf_run=f"[rf] Higgs-shaped RF, {RF_ITERS} "
                            "iterations (eager loop)",
            launches_a6a=launches_a6a(name),
            launches_a6a_run=a6a_runs,
            launches_a6b=launches_a6b(name),
            launches_a6b_run=a6b_runs,
            launches_a7=launches_a7(name),
            launches_a7_run=a7_runs,
            launches_telemetry=dict(
                captured=tele["launches"][name],
                eager_fused_split_off=tele["eager_launches"][name]),
            launches_telemetry_run=tele_runs,
            launches_parallel=launches_parallel(name),
            launches_parallel_run=par_runs,
            launches_doctor=launches_doctor(name),
            launches_doctor_run=doctor_runs,
            launches_chaos=chaos["launches"].get(name, 0),
            launches_chaos_run=chaos_runs)
        if key == "B1":
            b = par["b1"]
            extra.update(
                parallel_ms=b["ms"], parallel_plain_ms=b["plain_ms"],
                parallel_bound_ms=b["bound_ms"],
                parallel_bound_by=b["bound_by"],
                parallel_library_ms=b["library_ms"],
                parallel_max_abs_err=b["max_abs_err"],
                parallel_shape=f"[parallel] a rank's root call: "
                               f"{b['rows']} rows, {b['L']} slots, F=28 "
                               "x B=63, uint8")
            b = par["b1_rank"]
            extra.update(
                parallel_rank_ms=b["ms"], parallel_rank_plain_ms=b["plain_ms"],
                parallel_rank_bound_ms=b["bound_ms"],
                parallel_rank_bound_by=b["bound_by"],
                parallel_rank_library_ms=b["library_ms"],
                parallel_rank_max_abs_err=b["max_abs_err"],
                parallel_rank_shape=f"[parallel] a rank's MS LTR root call: "
                                    f"{b['rows']} rows, {b['L']} slots, "
                                    f"F={b['F']} x B={b['B']}, uint8")
            o = ooc["b1"]
            extra.update(
                ooc_ms=o["ms"], ooc_plain_ms=o["plain_ms"],
                ooc_bound_ms=o["bound_ms"], ooc_bound_by=o["bound_by"],
                ooc_library_ms=o["library_ms"],
                ooc_max_abs_err=o["max_abs_err"],
                ooc_shape=f"[ooc] chunk call with init: {o['rows']} rows, "
                          f"{o['L']} slots, F=28 x B=63, uint8")
        if key == "B2":
            rr, rc = results["B2"]["rank_root"], results["B2"]["rank_child"]
            extra.update(
                rank_ms=rr["ms"], rank_plain_ms=rr["plain_ms"],
                rank_bound_ms=rr["bound_ms"], rank_bound_by=rr["bound_by"],
                rank_library_ms=None,
                rank_max_abs_err=results["B2"]["rank_max_abs_err"],
                rank_shape=f"MS LTR-shaped root: {rr['rows']} rows, "
                           f"{rr['L']} slots, F={rr['F']} x B={rr['B']}",
                rank_child_ms=rc["ms"], rank_child_plain_ms=rc["plain_ms"],
                rank_child_bound_ms=rc["bound_ms"],
                rank_child_shape=f"MS LTR-shaped compacted child call: "
                                 f"{rc['rows']} rows, {rc['L']} slots")
        extra.update(
            launches_opts={arm: n[name]
                           for arm, n in opts["launches"].items()},
            launches_opts_run="[opts] arms at the Higgs shape: captured "
                              "bynode_interaction, extra_trees_contri and "
                              "intermediate (3 iterations after iteration "
                              "0), eager advanced (1), cegb (3) and forced "
                              "(1); "
                              "covtype_bynode_extra_trees class-batched "
                              "captured (2 after iteration 0)")
        if key == "B2":
            extra["opts_max_abs_err"] = opts["b2_err"]
        wr, wc = wide[key]["root"], wide[key]["child"]
        extra.update(
            wide_ms=wr["ms"], wide_plain_ms=wr["plain_ms"],
            wide_bound_ms=wr["bound_ms"], wide_bound_by=wr["bound_by"],
            wide_library_ms=wr["library_ms"],
            wide_max_abs_err=wide[key]["max_abs_err"],
            wide_ms_int8=wr["ms_int8"], wide_bound_int8_ms=wr["bound_int8_ms"],
            wide_shape=f"[wide] Higgs root at max_bin 1023: {wr['rows']} "
                       f"rows, {wr['L']} slots, F=28 x B={wide['B']}, int16 "
                       "bins",
            wide_child_ms=wc["ms"], wide_child_plain_ms=wc["plain_ms"],
            wide_child_bound_ms=wc["bound_ms"],
            wide_child_library_ms=wc["library_ms"],
            wide_child_shape=f"[wide] compacted child call: {wc['rows']} "
                             f"rows, {wc['L']} slots",
            launches_wide=launches_wide(name), launches_wide_run=wide_runs)
        if key == "B1":
            sr, sc = sparse["B1"]["root"], sparse["B1"]["child"]
            extra.update(
                sparse_ms=sr["ms"], sparse_plain_ms=sr["plain_ms"],
                sparse_bound_ms=sr["bound_ms"],
                sparse_bound_by=sr["bound_by"],
                sparse_library_ms=sr["library_ms"],
                sparse_max_abs_err=sparse["B1"]["max_abs_err"],
                sparse_shape=f"[sparse] root: {sr['rows']} rows, {sr['L']} "
                             f"slots, {sparse['G']} bundle columns x "
                             f"{sparse['Bb']} bins",
                sparse_child_ms=sc["ms"],
                sparse_child_bound_ms=sc["bound_ms"],
                sparse_child_plain_ms=sc["plain_ms"],
                sparse_child_library_ms=sc["library_ms"])
            we, wec = wide_efb["B1"]["root"], wide_efb["B1"]["child"]
            extra.update(
                wide_efb_ms=we["ms"], wide_efb_plain_ms=we["plain_ms"],
                wide_efb_bound_ms=we["bound_ms"],
                wide_efb_bound_by=we["bound_by"],
                wide_efb_library_ms=we["library_ms"],
                wide_efb_max_abs_err=wide_efb["B1"]["max_abs_err"],
                wide_efb_shape=f"[wide-efb] root: {we['rows']} rows, "
                               f"{we['L']} slots, {wide_efb['G']} bundle "
                               f"columns x {wide_efb['Bb']} bins, int16",
                wide_efb_child_ms=wec["ms"],
                wide_efb_child_bound_ms=wec["bound_ms"],
                wide_efb_child_plain_ms=wec["plain_ms"],
                wide_efb_child_library_ms=wec["library_ms"])
        if key == "B1":
            rr, rc = results["B1"]["rank_root"], results["B1"]["rank_child"]
            extra.update(
                rank_ms=rr["ms"], rank_plain_ms=rr["plain_ms"],
                rank_bound_ms=rr["bound_ms"], rank_bound_by=rr["bound_by"],
                rank_library_ms=rr["library_ms"],
                rank_max_abs_err=results["B1"]["rank_max_abs_err"],
                rank_shape=f"MS LTR-shaped root: {rr['rows']} rows, "
                           f"{rr['L']} slots, F={rr['F']} x B={rr['B']}",
                rank_child_ms=rc["ms"], rank_child_plain_ms=rc["plain_ms"],
                rank_child_bound_ms=rc["bound_ms"],
                rank_child_library_ms=rc["library_ms"],
                rank_child_shape=f"MS LTR-shaped compacted child call: "
                                 f"{rc['rows']} rows, {rc['L']} slots")
            b = results["B1"]["bundle"]
            extra.update(
                bundle_ms=b["ms"], bundle_plain_ms=b["plain_ms"],
                bundle_library_ms=b["library_ms"],
                bundle_bound_ms=b["bound_ms"], bundle_bound_by=b["bound_by"],
                bundle_max_abs_err=b["max_abs_err"],
                bundle_root_max_abs_err=b["root_max_abs_err"],
                bundle_shape=f"EFB class-batched Covertype call: {b['rows']}"
                             f" live (class, row) pairs, {b['L']} slots, "
                             f"{b['G']} bundle columns x {b['Bb']} bins",
                launches_bundle=efb["launches"],
                launches_bundle_run="[efb] Covertype class-batched captured,"
                                    " 10 iterations after iteration 0")
        kernels.append(dict(**extra,
            name=name, route="cuda", source=src, replaces=replaces,
            launches=runs[run]["launches"][name],
            max_abs_err=results[key]["max_abs_err"], ms=r["ms"],
            plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
            bound_by=r["bound_by"], library_ms=r["library_ms"],
            shape=f"root call: {r['rows']} rows, {r['L']} slots",
            child_ms=c["ms"], child_bound_ms=c["bound_ms"],
            child_plain_ms=c["plain_ms"], child_library_ms=c["library_ms"],
            child_shape=f"compacted child call: {c['rows']} rows, "
                        f"{c['L']} slots",
            mc_ms=m["ms"], mc_bound_ms=m["bound_ms"],
            mc_plain_ms=m["plain_ms"], mc_library_ms=m["library_ms"],
            mc_shape=f"class-batched Covertype call: {m['rows']} live "
                     f"(class, row) pairs, {m['L']} slots",
            launches_run=f"Higgs fused_split={run} training run",
            launches_multiclass=mc_runs["auto"]["launches"][name],
            launches_int8=n8, ms_int8=r["ms_int8"],
            bound_int8_ms=r["bound_int8_ms"], child_ms_int8=c["ms_int8"],
            child_bound_int8_ms=c["bound_int8_ms"],
            launches_int8_run=(f"[quant] Higgs fused_split={run}, "
                               + ("20 trees" if run == "auto"
                                  else "10 trees after iteration 0")),
            launches_int8_multiclass=quant_mc[name]))
    r = results["B3"]["root"]
    kernels.append(dict(
        name="build_root_histograms_classes", route="cuda", source=src,
        replaces="lightgbm_tpu/ops/pallas_histogram.py:766",
        launches=mc_runs["auto"]["launches"]["build_root_histograms_classes"],
        max_abs_err=results["B3"]["max_abs_err"], ms=r["ms"],
        plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
        bound_by=r["bound_by"], library_ms=r["library_ms"],
        shape=f"Covertype root: {r['rows']} rows, {r['L']} classes",
        cat_max_abs_err=results["B3"]["cat_max_abs_err"],
        cat_shape="[cat] 12-column Covertype root (F=12)",
        launches_run="Covertype class_batch=auto training run",
        launches_int8=quant_mc["build_root_histograms_classes"],
        ms_int8=r["ms_int8"], bound_int8_ms=r["bound_int8_ms"],
        launches_int8_run="[quant-mc] Covertype class-batched, 10 "
                          "iterations after iteration 0",
        launches_opts={arm: n["build_root_histograms_classes"]
                       for arm, n in opts["launches"].items()},
        launches_opts_run="[opts] arms (see B1)",
        wide_ms=wide["B3"]["root"]["ms"],
        wide_plain_ms=wide["B3"]["root"]["plain_ms"],
        wide_bound_ms=wide["B3"]["root"]["bound_ms"],
        wide_bound_by=wide["B3"]["root"]["bound_by"],
        wide_library_ms=wide["B3"]["root"]["library_ms"],
        wide_max_abs_err=wide["B3"]["max_abs_err"],
        wide_ms_int8=wide["B3"]["root"]["ms_int8"],
        wide_shape=f"[wide] Covertype root at max_bin 1023: "
                   f"{wide['B3']['root']['rows']} rows, 7 classes, F=54 x "
                   f"B={wide['B_cov']}, int16 bins",
        launches_wide=launches_wide("build_root_histograms_classes"),
        launches_wide_run=wide_runs,
        launches_a6a=launches_a6a("build_root_histograms_classes"),
        launches_a6a_run=a6a_runs,
        launches_a6b=launches_a6b("build_root_histograms_classes"),
        launches_a6b_run=a6b_runs,
        launches_a7=launches_a7("build_root_histograms_classes"),
        launches_a7_run=a7_runs,
        launches_telemetry=dict(
            captured=tele["launches"]["build_root_histograms_classes"],
            eager_fused_split_off=tele["eager_launches"][
                "build_root_histograms_classes"]),
        launches_telemetry_run=tele_runs,
        launches_parallel=launches_parallel(
            "build_root_histograms_classes"),
        launches_parallel_run=par_runs,
        launches_doctor=launches_doctor("build_root_histograms_classes"),
        launches_doctor_run=doctor_runs,
        launches_chaos=chaos["launches"].get(
            "build_root_histograms_classes", 0),
        launches_chaos_run=chaos_runs))
    log(f"[A6b] [sparse] construct card {sparse['card_s']:.2f} s, CPU "
        f"{sparse['cpu_s']:.2f} s, host peak {sparse['host_peak']} B, "
        f"device peak {sparse['dev_peak']} B, {sparse['ms_per_tree']:.1f} "
        f"ms/tree; [cli] parse {cli_res['rows_per_s']:,.0f} rows/s, tasks "
        + ", ".join(f"{k} {v:.1f} s" for k, v in cli_res["secs"].items()))
    log(f"[A7] [ooc] {ooc['ms']:.1f} ms/tree chunked against "
        f"{ooc['resident_ms']:.1f} resident (int8 {ooc['ms_int8']:.1f} "
        f"against {ooc['resident_ms_int8']:.1f}), overlap "
        f"{ooc['overlap']:.4f}, {ooc['gbs']:.2f} GB/s, peak "
        f"{ooc['peak']} B against {ooc['resident_peak']} B; [resume] "
        f"checkpoint {resume['ck_bytes']} B, write {resume['write_ms']:.1f}"
        f" ms, restore {resume['restore_ms']:.1f} ms, ingest "
        f"{resume['ingest_s']:.1f} s")
    log(f"[A8] [telemetry] ms/tree with telemetry {tele['ms']:.2f} against "
        f"bare {tele['bare_ms'][0]:.2f} / {tele['bare_ms'][1]:.2f}; trace "
        f"busy share {tele['busy']:.4f}; a /trace call "
        f"{tele['trace_s']:.2f} s")
    log(f"[done] all phases passed in {time.perf_counter() - t_start:.1f} s")
    print(smi, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
