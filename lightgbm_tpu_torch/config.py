"""Parameter/config system.

TPU-native analog of the reference config layer (LightGBM
``include/LightGBM/config.h:39`` ``struct Config``, ``src/io/config.cpp``
``Config::Set`` and the generated alias table in ``src/io/config_auto.cpp``).

PyTorch port: a copy of ``lightgbm_tpu/config.py`` whose ``device_type``
defaults to ``"cuda"`` and is checked against ``cpu|cuda``;
:func:`resolve_device` turns it into a ``torch.device`` and raises
instead of carrying on on the CPU when no GPU is visible.

Differences from the reference, by design:
- Pure Python: a registry of :class:`Param` entries replaces the generated
  C++ parse members; aliases resolve through one table like
  ``ParameterAlias::KeyAliasTransform``.
- Only parameters that are meaningful for the TPU build are registered.
  Unknown keys raise (same spirit as LightGBM's strict parsing) unless they
  start with an underscore.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

__all__ = ["Config", "ParamSpec", "PARAMS", "ALIASES", "parse_params",
           "resolve_device"]


@dataclasses.dataclass
class ParamSpec:
    name: str
    default: Any
    typ: type
    aliases: Tuple[str, ...] = ()
    check: Optional[Callable[[Any], bool]] = None
    doc: str = ""


def _p(name, default, typ, aliases=(), check=None, doc=""):
    return ParamSpec(name, default, typ, tuple(aliases), check, doc)


# Registry. Aliases mirror config_auto.cpp's table for the supported subset.
PARAMS: Dict[str, ParamSpec] = {
    p.name: p
    for p in [
        # -- core (config.h "Core Parameters") --
        _p("objective", "regression", str,
           aliases=("objective_type", "app", "application", "loss"),
           doc="regression | regression_l1 | huber | fair | poisson | quantile"
               " | mape | gamma | tweedie | binary | multiclass | multiclassova"
               " | cross_entropy | cross_entropy_lambda | lambdarank"
               " | rank_xendcg | custom"),
        _p("boosting", "gbdt", str, aliases=("boosting_type", "boost"),
           doc="gbdt | dart | rf | goss (alias for data_sample_strategy)"),
        _p("data_sample_strategy", "bagging", str),
        _p("num_iterations", 100, int,
           aliases=("num_iteration", "n_iter", "num_tree", "num_trees",
                    "num_round", "num_rounds", "nrounds", "num_boost_round",
                    "n_estimators", "max_iter")),
        _p("learning_rate", 0.1, float, aliases=("shrinkage_rate", "eta"),
           check=lambda v: v > 0),
        _p("num_leaves", 31, int, aliases=("num_leaf", "max_leaves", "max_leaf",
                                           "max_leaf_nodes"),
           check=lambda v: 1 < v <= 131072),
        _p("tree_learner", "auto", str,
           aliases=("tree", "tree_type", "tree_learner_type"),
           doc="auto | serial | data | feature | voting — auto scales to "
               "every local device (data-parallel) when more than one is "
               "visible; serial pins one device"),
        # -- accepted no-ops (documented, not silently wrong):
        # num_threads/force_*_wise tune OpenMP & CPU histogram layout —
        # the port's kernels own scheduling; feature_pre_filter,
        # precise_float_parser, parser_config_file, time_out concern the
        # reference's CPU parser/socket stack.
        _p("num_threads", 0, int, aliases=("num_thread", "nthread", "nthreads",
                                           "n_jobs")),
        _p("device_type", "cuda", str, aliases=("device",),
           check=lambda v: v in ("cpu", "cuda"),
           doc="cuda (default): data, trees and kernels live on the GPU "
               "and the entry points raise when none is visible; cpu: "
               "the plain PyTorch versions of every kernel run on the "
               "host (the tests use it)"),
        _p("seed", 0, int, aliases=("random_seed", "random_state")),
        _p("deterministic", False, bool),
        # -- learning control --
        _p("force_col_wise", False, bool),
        _p("force_row_wise", False, bool),
        _p("max_depth", -1, int),
        _p("min_data_in_leaf", 20, int,
           aliases=("min_data_per_leaf", "min_data", "min_child_samples",
                    "min_samples_leaf"),
           check=lambda v: v >= 0),
        _p("min_sum_hessian_in_leaf", 1e-3, float,
           aliases=("min_sum_hessian_per_leaf", "min_sum_hessian",
                    "min_hessian", "min_child_weight")),
        _p("bagging_fraction", 1.0, float,
           aliases=("sub_row", "subsample", "bagging"),
           check=lambda v: 0 < v <= 1),
        _p("bagging_freq", 0, int, aliases=("subsample_freq",)),
        _p("pos_bagging_fraction", 1.0, float,
           aliases=("pos_sub_row", "pos_subsample", "pos_bagging"),
           check=lambda v: 0 < v <= 1),
        _p("neg_bagging_fraction", 1.0, float,
           aliases=("neg_sub_row", "neg_subsample", "neg_bagging"),
           check=lambda v: 0 < v <= 1),
        _p("bagging_by_query", False, bool),
        _p("bagging_seed", 3, int, aliases=("bagging_fraction_seed",)),
        _p("feature_fraction", 1.0, float,
           aliases=("sub_feature", "colsample_bytree"),
           check=lambda v: 0 < v <= 1),
        _p("feature_fraction_bynode", 1.0, float,
           aliases=("sub_feature_bynode", "colsample_bynode"),
           check=lambda v: 0 < v <= 1),
        _p("feature_fraction_seed", 2, int),
        _p("extra_trees", False, bool, aliases=("extra_tree",)),
        _p("extra_seed", 6, int),
        _p("early_stopping_round", 0, int,
           aliases=("early_stopping_rounds", "early_stopping",
                    "n_iter_no_change")),
        _p("early_stopping_min_delta", 0.0, float),
        _p("first_metric_only", False, bool),
        _p("max_delta_step", 0.0, float,
           aliases=("max_tree_output", "max_leaf_output")),
        _p("lambda_l1", 0.0, float, aliases=("reg_alpha", "l1_regularization"),
           check=lambda v: v >= 0),
        _p("lambda_l2", 0.0, float, aliases=("reg_lambda", "lambda",
                                             "l2_regularization"),
           check=lambda v: v >= 0),
        _p("linear_lambda", 0.0, float, check=lambda v: v >= 0),
        _p("min_gain_to_split", 0.0, float,
           aliases=("min_split_gain",), check=lambda v: v >= 0),
        # dart
        _p("drop_rate", 0.1, float, aliases=("rate_drop",)),
        _p("max_drop", 50, int),
        _p("skip_drop", 0.5, float),
        _p("xgboost_dart_mode", False, bool),
        _p("uniform_drop", False, bool),
        _p("drop_seed", 4, int),
        # goss
        _p("top_rate", 0.2, float),
        _p("other_rate", 0.1, float),
        _p("min_data_per_group", 100, int),
        _p("max_cat_threshold", 32, int),
        _p("cat_l2", 10.0, float),
        _p("cat_smooth", 10.0, float),
        _p("max_cat_to_onehot", 4, int),
        _p("top_k", 20, int, aliases=("topk",)),
        _p("feature_shard_storage", False, bool,
           doc="with tree_learner=feature: store only each device's "
               "feature shard of the bin matrix ([R, F/devices] per "
               "chip instead of a replicated [R, F]) — the TPU-native "
               "answer to datasets whose dense matrix exceeds one "
               "chip's HBM (the reference instead has per-feature "
               "sparse storage, sparse_bin.hpp). Split finding is "
               "already feature-local; the partition step resolves "
               "each row's split-feature bin with a one-hot psum over "
               "the feature axis"),
        _p("monotone_constraints", [], list,
           aliases=("mc", "monotone_constraint", "monotonic_cst")),
        _p("monotone_constraints_method", "basic", str,
           aliases=("monotone_constraining_method", "mc_method")),
        _p("monotone_penalty", 0.0, float, aliases=("monotone_splits_penalty",
                                                    "ms_penalty", "mc_penalty")),
        _p("feature_contri", [], list, aliases=("feature_contrib", "fc",
                                                "fp", "feature_penalty")),
        _p("interaction_constraints", [], list),
        _p("refit_decay_rate", 0.9, float),
        _p("cegb_tradeoff", 1.0, float),
        _p("cegb_penalty_split", 0.0, float),
        _p("cegb_penalty_feature_lazy", [], list),
        _p("cegb_penalty_feature_coupled", [], list),
        _p("path_smooth", 0.0, float, check=lambda v: v >= 0),
        _p("verbosity", 1, int, aliases=("verbose",)),
        _p("use_quantized_grad", False, bool),
        _p("num_grad_quant_bins", 4, int),
        _p("quant_train_renew_leaf", False, bool),
        _p("stochastic_rounding", True, bool),
        # -- TPU-specific learning control (no reference analog) --
        _p("fused_train", True, bool,
           doc="drive training with the boosting step (grads+bagging+"
               "build+update over static buffers; on CUDA captured once "
               "into a CUDA graph and replayed once an iteration; trees "
               "materialized in batches at eval points). false pins the "
               "eager loop (the same ops launched one by one from the "
               "host). LIGHTGBM_TPU_FUSED_TRAIN=0 pins the eager loop "
               "from the env"),
        _p("eval_period", 1, int, aliases=("eval_freq",),
           check=lambda v: v >= 1,
           doc="engine.train eval cadence: callbacks and early stopping "
               "observe metrics every eval_period iterations (plus the "
               "final one). 1 = reference-parity per-iteration "
               "evaluation; larger values let the fused trainer run "
               "dispatch-ahead with zero host syncs between eval "
               "points"),
        _p("class_batch", "auto", str,
           check=lambda v: v in ("auto", "on", "off"),
           doc="multiclass tree construction: auto/on grow all "
               "num_class per-class trees of an iteration in ONE "
               "class-batched build (the class axis rides the "
               "histogram kernel's leaf-slot axis, so trace size and "
               "compile time stop scaling with num_class and every "
               "histogram dispatch gets K x more MXU work); off pins "
               "the sequential per-class loop. Configs the batched "
               "build cannot express (linear trees, forced splits, "
               "CEGB, feature-parallel learners) fall back "
               "automatically; results are bit-identical either way. "
               "LIGHTGBM_TPU_CLASS_BATCH=0/1 pins from the env"),
        _p("fused_split", "auto", str,
           check=lambda v: v in ("auto", "on", "off"),
           doc="fused histogram+split-find Pallas kernel: auto/on run "
               "the per-(leaf, feature-chunk) gain epilogue inside the "
               "histogram kernel's VMEM-resident accumulator and emit "
               "only best-split candidate records, eliminating the "
               "[F,B,3] HBM histogram round-trip between the hist and "
               "split phases; off pins the two-pass histogram-only "
               "kernel + find_best_splits scan. Configs the epilogue "
               "cannot express fall back automatically (non-pallas "
               "hist_impl, categorical sorted-subset, extra-trees "
               "random thresholds, forced splits, CEGB, advanced "
               "monotone, EFB bundles, feature/data-parallel plans, "
               "chunked out-of-core, unaligned chunk plans); auto "
               "additionally requires the fused probe to compile on "
               "this backend. LIGHTGBM_TPU_FUSED_SPLIT=0/1 pins from "
               "the env"),
        _p("dp_hist_merge", "auto", str,
           check=lambda v: v in ("auto", "allreduce", "reduce_scatter"),
           doc="histogram merge collective for tree_learner=data/voting "
               "on a multi-chip mesh: reduce_scatter (each chip "
               "receives only its F/n feature-slot block of the merged "
               "histogram, finds its local best split, and winners sync "
               "SplitInfo-sized — the reference Network::ReduceScatter "
               "algorithm; ~2x less wire traffic and 1/n the per-chip "
               "histogram HBM of allreduce), allreduce (full-histogram "
               "psum, replicated split finding — the ablation "
               "baseline), or auto (reduce_scatter when the mesh has "
               ">1 device). LIGHTGBM_TPU_DP_HIST_MERGE overrides from "
               "the env; forced splits pin allreduce"),
        _p("leaf_batch", 16, int,
           doc="Leaves split per on-device round; 1 = exact best-first"
               " (reference semantics), >1 batches frontier growth to keep the"
               " MXU histogram matmul wide. See ops/histogram.py."),
        _p("hist_dtype", "bfloat16", str,
           doc="matmul input dtype for histogram accumulation: bfloat16 "
               "(default; f32 accumulate) or float32 (exact)"),
        _p("hist_impl", "auto", str,
           check=lambda v: v in ("auto", "matmul", "scatter", "pallas",
                                 "native"),
           doc="accepted for the JAX package's parameter sets and "
               "read by nothing: the port has one histogram kernel a "
               "device (the CUDA kernels on the card, the plain PyTorch "
               "sums on the CPU), and every value sums under the same "
               "contract, so every value trains the same trees (a "
               "deliberate deviation: in the JAX package it picks "
               "matmul, scatter, pallas or native)"),
        _p("hist_subtraction", True, bool,
           doc="histogram the smaller child only and derive the sibling "
               "by parent-minus-child subtraction from a per-leaf cache "
               "(serial_tree_learner.cpp:567 Subtract analog); "
               "auto-disabled when the cache exceeds "
               "histogram_pool_size"),
        _p("histogram_pool_size", -1.0, float,
           aliases=("hist_pool_size",),
           doc="MB budget for the per-leaf histogram cache "
               "(config.h histogram_pool_size analog); <=0 means an "
               "automatic 512 MB device budget"),
        # -- IO / dataset --
        _p("max_bin", 255, int, aliases=("max_bins",), check=lambda v: v > 1),
        _p("max_bin_by_feature", [], list),
        _p("min_data_in_bin", 3, int, check=lambda v: v > 0),
        _p("bin_construct_sample_cnt", 200000, int,
           aliases=("subsample_for_bin",), check=lambda v: v > 0),
        _p("data_random_seed", 1, int, aliases=("data_seed",)),
        _p("is_enable_sparse", True, bool,
           aliases=("is_sparse", "enable_sparse", "sparse")),
        _p("enable_bundle", True, bool, aliases=("is_enable_bundle", "bundle")),
        _p("max_conflict_rate", 0.0, float, check=lambda v: 0 <= v < 1),
        _p("max_bundle_bins", 256, int, check=lambda v: v >= 4,
           doc="TPU EFB cap: total bins per bundle column (256 keeps "
               "uint8 storage; also the histogram lattice width unit)"),
        _p("use_missing", True, bool),
        _p("zero_as_missing", False, bool),
        _p("feature_pre_filter", True, bool),
        _p("pre_partition", False, bool, aliases=("is_pre_partition",)),
        _p("two_round", False, bool, aliases=("two_round_loading",
                                              "use_two_round_loading")),
        _p("header", False, bool, aliases=("has_header",)),
        _p("label_column", "", str, aliases=("label",)),
        _p("weight_column", "", str, aliases=("weight",)),
        _p("group_column", "", str, aliases=("group", "group_id",
                                             "query_column", "query",
                                             "query_id")),
        _p("ignore_column", "", str, aliases=("ignore_feature",
                                              "blacklist")),
        _p("categorical_feature", "", str, aliases=("cat_feature",
                                                    "categorical_column",
                                                    "cat_column")),
        _p("forcedbins_filename", "", str),
        _p("forcedsplits_filename", "", str,
           aliases=("fs", "forced_splits_filename", "forced_splits_file",
                    "forced_splits")),
        _p("save_binary", False, bool, aliases=("is_save_binary",
                                                "is_save_binary_file")),
        _p("precise_float_parser", False, bool),
        _p("parser_config_file", "", str),
        # -- out-of-core ingest / chunked training (data/) --
        _p("out_of_core", "auto", str,
           check=lambda v: v in ("auto", "on", "off"),
           doc="chunked (non-device-resident) training from .lgbtpu "
               "shard datasets: auto streams row chunks only when the "
               "device capacity check rejects the resident layout, on "
               "forces streaming, off always materializes (raising if "
               "the device can't hold it)"),
        _p("chunk_budget_mb", 64.0, float, check=lambda v: v > 0,
           doc="per-buffer byte budget for streamed bin-matrix chunks; "
               "the chunked trainer double-buffers, so peak staged "
               "bytes are ~2x this and host RSS stays O(chunk), not "
               "O(dataset)"),
        _p("ingest_rows_per_shard", 262144, int, check=lambda v: v > 0,
           doc="row count per .lgbtpu shard written by `python -m "
               "lightgbm_tpu ingest` (fixed partition: retries of an "
               "interrupted ingest rewrite only missing/invalid "
               "shards)"),
        _p("sketch_capacity", 65536, int, check=lambda v: v >= 2,
           doc="distinct values kept per feature by the ingest "
               "quantile sketch before deterministic mantissa-"
               "truncation coarsening (data/sketch.py documents the "
               "2^(level-52) relative accuracy bound)"),
        # -- predict --
        _p("start_iteration_predict", 0, int),
        _p("num_iteration_predict", -1, int),
        _p("predict_raw_score", False, bool, aliases=("is_predict_raw_score",
                                                      "predict_rawscore",
                                                      "raw_score")),
        _p("predict_leaf_index", False, bool, aliases=("is_predict_leaf_index",
                                                       "leaf_index")),
        _p("predict_contrib", False, bool, aliases=("is_predict_contrib",
                                                    "contrib")),
        _p("predict_disable_shape_check", False, bool),
        _p("pred_early_stop", False, bool),
        _p("pred_early_stop_freq", 10, int, check=lambda v: v > 0),
        _p("pred_early_stop_margin", 10.0, float, check=lambda v: v >= 0),
        # -- objective --
        _p("num_class", 1, int, aliases=("num_classes",),
           check=lambda v: v > 0),
        _p("is_unbalance", False, bool, aliases=("unbalance",
                                                 "unbalanced_sets")),
        _p("scale_pos_weight", 1.0, float, check=lambda v: v > 0),
        _p("sigmoid", 1.0, float, check=lambda v: v > 0),
        _p("boost_from_average", True, bool),
        _p("reg_sqrt", False, bool),
        _p("alpha", 0.9, float, check=lambda v: v > 0),
        _p("fair_c", 1.0, float, check=lambda v: v > 0),
        _p("poisson_max_delta_step", 0.7, float, check=lambda v: v > 0),
        _p("tweedie_variance_power", 1.5, float,
           check=lambda v: 1 <= v < 2),
        _p("lambdarank_truncation_level", 30, int, check=lambda v: v > 0),
        _p("lambdarank_norm", True, bool),
        _p("label_gain", [], list),
        _p("lambdarank_position_bias_regularization", 0.0, float),
        _p("objective_seed", 5, int),
        # -- metric --
        _p("metric", [], list, aliases=("metrics", "metric_types")),
        _p("metric_freq", 1, int, aliases=("output_freq",)),
        _p("is_provide_training_metric", False, bool,
           aliases=("training_metric", "is_training_metric",
                    "train_metric")),
        _p("eval_at", [1, 2, 3, 4, 5], list,
           aliases=("ndcg_eval_at", "ndcg_at", "map_eval_at", "map_at")),
        _p("multi_error_top_k", 1, int, check=lambda v: v > 0),
        _p("auc_mu_weights", [], list),
        # -- network (reference: machines/ports; here: a jax mesh) --
        _p("num_machines", 1, int, aliases=("num_machine",)),
        _p("local_listen_port", 12400, int, aliases=("local_port", "port")),
        _p("time_out", 120, int),
        _p("machine_list_filename", "", str,
           aliases=("machine_list_file", "machine_list", "mlist")),
        _p("machines", "", str, aliases=("workers", "nodes")),
        # -- misc application-level --
        _p("task", "train", str, aliases=("task_type",)),
        _p("data", "", str, aliases=("train", "train_data", "train_data_file",
                                     "data_filename")),
        _p("valid", [], list, aliases=("test", "valid_data", "valid_data_file",
                                       "test_data", "test_data_file",
                                       "valid_filenames")),
        _p("input_model", "", str, aliases=("model_input", "model_in")),
        _p("convert_model", "gbdt_prediction.cpp", str,
           aliases=("convert_model_file",)),
        _p("convert_model_language", "", str),
        _p("output_model", "LightGBM_model.txt", str,
           aliases=("model_output", "model_out")),
        _p("saved_feature_importance_type", 0, int),
        _p("snapshot_freq", -1, int, aliases=("save_period",)),
        _p("snapshot_keep", 3, int, check=lambda v: v >= 1,
           doc="retention for snapshot_freq artifacts: keep only the "
               "newest N *.snapshot_iter_/*.ckpt_iter_ files per "
               "output_model so long runs stop accumulating unbounded "
               "snapshots"),
        # -- fault tolerance (resilience subsystem, no reference analog)
        _p("resume", "off", str,
           check=lambda v: v in ("off", "auto") or bool(v),
           doc="preemption-safe resume: auto scans output_model for the "
               "newest VALID *.ckpt_iter_ full-state checkpoint "
               "(corrupt/truncated files are rejected by checksum and "
               "the previous one used) and continues bit-identically to "
               "an uninterrupted run; a path resumes from that exact "
               "checkpoint; off (default) disables checkpoint writes "
               "and scanning. Enabling resume also arms the "
               "SIGTERM/SIGINT preemption handler: the first signal "
               "drains pending device work, writes a final checkpoint, "
               "and exits cleanly"),
        # -- runtime telemetry (telemetry subsystem, no reference analog)
        _p("telemetry_port", -1, int,
           doc="opt-in live introspection server during training "
               "(telemetry/exporter.py): >= 0 binds 127.0.0.1:<port> "
               "(0 picks a free port) serving /metrics (Prometheus), "
               "/events tail, /healthz and /trace?duration_ms= (an "
               "on-demand torch.profiler capture of every thread, CPU "
               "and CUDA activities, answered with device ms per kernel "
               "and per phase and the device's busy share; the Chrome "
               "trace is kept under <event_log dir>/traces); -1 "
               "(default) disables. The LIGHTGBM_TPU_TELEMETRY_PORT env "
               "var is the no-code-change spelling and applies when the "
               "param is unset. Scrapes read host-side state only — the "
               "training loop gains zero host syncs"),
        _p("event_log", "", str,
           doc="structured run-event log (telemetry/events.py): a path "
               "writes append-only JSONL records (run header, "
               "eval-point iterations with per-phase seconds, "
               "checkpoint write/restore, preemption, nan-guard, "
               "warnings) emitted only at existing sync points, in the "
               "JAX package's schema; 'auto' derives "
               "<output_model>.events.jsonl; empty (default) disables. "
               "Render with `python -m lightgbm_tpu_torch monitor`"),
        _p("nan_guard", "off", str,
           check=lambda v: v in ("off", "raise", "rollback"),
           doc="sync-free NaN/Inf detection on gradients/scores, "
               "carried through the fused step as a deferred device "
               "flag next to the no-split stop (zero extra host syncs "
               "between eval points): raise surfaces "
               "NumericDivergenceError; rollback (restore the newest "
               "valid checkpoint and re-run) is refused by the port "
               "until checkpoints are ported; off skips the check"),
        _p("on_device_loss", "fail", str,
           check=lambda v: v in ("fail", "degrade"),
           doc="what engine.train does when a boosting step dies with "
               "a typed DeviceLossError (an XLA/collective runtime "
               "failure — a device went away): fail (default) "
               "surfaces the error; degrade hands the run to the "
               "supervising driver (resilience/supervisor.py), which "
               "restores the newest checkpoint, retries with "
               "exponential backoff, and after a repeat loss rebuilds "
               "the plan on the surviving device set "
               "(tree_learner=serial as the floor) — every transition "
               "recorded in the telemetry event log as "
               "degraded/reshard records. Forces resume=auto"),
        _p("linear_tree", False, bool, aliases=("linear_trees",)),
        _p("output_result", "LightGBM_predict_result.txt", str,
           aliases=("predict_result", "prediction_result", "predict_name",
                    "prediction_name", "pred_name", "name_pred")),
    ]
}

ALIASES: Dict[str, str] = {}
for _spec in PARAMS.values():
    for _a in _spec.aliases:
        ALIASES[_a] = _spec.name


_TRUE = {"true", "1", "yes", "on", "+"}
_FALSE = {"false", "0", "no", "off", "-"}


def _coerce(spec: ParamSpec, value: Any) -> Any:
    if spec.typ is bool:
        if isinstance(value, str):
            lv = value.strip().lower()
            if lv in _TRUE:
                return True
            if lv in _FALSE:
                return False
            raise ValueError(f"cannot parse bool param {spec.name}={value!r}")
        return bool(value)
    if spec.typ is int:
        return int(value)
    if spec.typ is float:
        return float(value)
    if spec.typ is list:
        if isinstance(value, str):
            if not value:
                return []
            return [_auto_num(tok) for tok in value.replace(" ", ",").split(",")
                    if tok != ""]
        if isinstance(value, (list, tuple)):
            return list(value)
        return [value]
    if spec.typ is str:
        return str(value)
    return value


def _auto_num(tok: str):
    try:
        return int(tok)
    except ValueError:
        try:
            return float(tok)
        except ValueError:
            return tok


def parse_params(params: Optional[Dict[str, Any]]) -> Dict[str, Any]:
    """Resolve aliases + coerce types. Analog of ``Config::Set``."""
    out: Dict[str, Any] = {}
    if not params:
        return out
    for key, value in params.items():
        canon = ALIASES.get(key, key)
        if canon not in PARAMS:
            if key.startswith("_"):
                out[key] = value
                continue
            raise ValueError(f"Unknown parameter: {key}")
        spec = PARAMS[canon]
        if canon in out and out[canon] != value:
            # first occurrence of the canonical name wins over later aliases,
            # matching LightGBM's duplicate-alias warning behavior.
            continue
        coerced = _coerce(spec, value)
        if spec.check is not None and not spec.check(coerced):
            raise ValueError(f"Invalid value for {canon}: {value!r}")
        out[canon] = coerced
    return out


_OBJECTIVE_ALIASES = {
    # objective name aliases, mirroring objective_function.cpp factory names
    "regression_l2": "regression", "l2": "regression", "mean_squared_error":
    "regression", "mse": "regression", "l2_root": "regression",
    "root_mean_squared_error": "regression", "rmse": "regression",
    "regression_l1": "regression_l1", "l1": "regression_l1",
    "mean_absolute_error": "regression_l1", "mae": "regression_l1",
    "mean_absolute_percentage_error": "mape",
    "lambda_rank": "lambdarank", "rank_xendcg": "rank_xendcg",
    "xendcg": "rank_xendcg", "xe_ndcg": "rank_xendcg",
    "xe_ndcg_mart": "rank_xendcg", "xendcg_mart": "rank_xendcg",
    "multiclass": "multiclass", "softmax": "multiclass",
    "multiclassova": "multiclassova", "multiclass_ova": "multiclassova",
    "ova": "multiclassova", "ovr": "multiclassova",
    "xentropy": "cross_entropy", "cross_entropy": "cross_entropy",
    "xentlambda": "cross_entropy_lambda",
    "cross_entropy_lambda": "cross_entropy_lambda",
    "none": "custom", "null": "custom", "custom": "custom", "na": "custom",
}


class Config:
    """Validated parameter bag. ``cfg.<name>`` returns value or default."""

    def __init__(self, params: Optional[Dict[str, Any]] = None):
        self._values = parse_params(params)
        self._apply_special_rules()
        self.check_param_conflict()

    @staticmethod
    def canonical_name(key: str) -> str:
        """Alias -> canonical param name (KeyAliasTransform analog)."""
        return ALIASES.get(key, key)

    def _apply_special_rules(self):
        v = self._values
        obj = v.get("objective")
        if obj is not None:
            # rmse/l2_root are plain aliases of L2 (reg_sqrt is separate)
            v["objective"] = _OBJECTIVE_ALIASES.get(obj, obj)
        boosting = v.get("boosting", "gbdt")
        if boosting == "goss":
            # LightGBM 4.x: boosting=goss is sugar for
            # boosting=gbdt + data_sample_strategy=goss (config.cpp).
            v["boosting"] = "gbdt"
            v["data_sample_strategy"] = "goss"

    def check_param_conflict(self):
        """Analog of Config::CheckParamConflict (config.h:1167)."""
        v = self._values
        if v.get("boosting") == "rf" \
                and self.data_sample_strategy == "bagging":
            # rf.hpp Init: with the bagging strategy, bagging OR feature
            # sampling qualifies; the goss strategy is accepted as-is
            has_bag = (self.bagging_freq > 0
                       and 0 < self.bagging_fraction < 1)
            has_ff = 0 < self.feature_fraction < 1
            if not (has_bag or has_ff):
                raise ValueError(
                    "rf boosting requires bagging (bagging_freq > 0 and "
                    "0 < bagging_fraction < 1) or feature_fraction < 1")
        if self.linear_tree:
            # config.cpp:429-444 linear tree restrictions
            if self.zero_as_missing:
                raise ValueError(
                    "zero_as_missing must be false when fitting linear "
                    "trees")
            if self.objective == "regression_l1":
                raise ValueError(
                    "Cannot use regression_l1 objective when fitting "
                    "linear trees")
            if v.get("boosting") == "dart":
                # DART's drop/restore replays constant leaf values; the
                # linear per-row outputs would corrupt running scores
                raise ValueError(
                    "linear_tree is not supported with boosting=dart")
        if v.get("lambdarank_position_bias_regularization", 0.0) < 0:
            raise ValueError(
                "lambdarank_position_bias_regularization must be >= 0")
        if self.objective in ("multiclass", "multiclassova") \
                and self.num_class < 2:
            raise ValueError("num_class must be >= 2 for multiclass objective")
        # a custom objective may train K > 1 models an iteration
        # (config.cpp CheckParamConflict: objective "custom" with
        # num_class > 1 is multiclass); the JAX package refuses it here
        # although its booster takes [K * n] and [n, K] custom gradients
        if self.objective not in ("multiclass", "multiclassova", "custom") \
                and self.num_class != 1:
            raise ValueError("num_class must be 1 for non-multiclass objective")

    def __getattr__(self, name: str):
        if name.startswith("_"):
            raise AttributeError(name)
        values = object.__getattribute__(self, "_values")
        if name in values:
            return values[name]
        spec = PARAMS.get(name)
        if spec is None:
            raise AttributeError(f"No such parameter: {name}")
        return spec.default

    def get(self, name, default=None):
        try:
            return getattr(self, name)
        except AttributeError:
            return default

    def set(self, **kwargs):
        self._values.update(parse_params(kwargs))

    def to_dict(self) -> Dict[str, Any]:
        out = {name: spec.default for name, spec in PARAMS.items()}
        out.update(self._values)
        return out

    def explicit(self) -> Dict[str, Any]:
        return dict(self._values)

    @property
    def is_set_objective(self) -> bool:
        return "objective" in self._values

    def __repr__(self):
        return f"Config({self._values!r})"


def resolve_device(device_type: str = "cuda"):
    """``device_type`` -> ``torch.device``. ``"cuda"`` without a visible
    GPU raises: the port never falls back to the CPU on its own."""
    import torch
    if device_type == "cpu":
        return torch.device("cpu")
    if device_type != "cuda":
        raise ValueError(f"device_type must be cpu or cuda, got "
                         f"{device_type!r}")
    if not torch.cuda.is_available():
        raise RuntimeError(
            "device_type='cuda' (the default) but torch sees no CUDA "
            "device; pass device_type='cpu' to run the plain PyTorch "
            "path on the host")
    return torch.device("cuda", torch.cuda.current_device())
