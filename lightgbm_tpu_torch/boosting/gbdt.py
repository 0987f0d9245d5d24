"""GBDT training loop on the device.

Port of ``lightgbm_tpu/boosting/gbdt.py`` restricted to this slice's
path (the reference's ``gbdt.cpp`` Train/TrainOneIter/BoostFromAverage/
UpdateScore):

- ``_DeviceData``: the binned matrix, padded to a row multiple, with the
  root ``row_leaf`` (0 live, -1 padded);
- ``boost_from_average`` init scores, folded into the first tree
  (AddBias, gbdt.cpp:416);
- per iteration, the fused step of ``_fused_step_impl``
  (``gbdt.py:1554``): gradients -> bagging or GOSS -> quantization ->
  tree builds -> leaf renewal -> score updates (only for the classes
  whose tree grew) and the finite flag.
  Scores are [K, R] (K = models per iteration). With K > 1 the
  class-batched build (``_class_batch_reason``, ``gbdt.py:1181``) grows
  all K trees in one build: one B3 launch for the K roots, then one B2
  (or B1) launch per round for all classes; ``class_batch=off`` keeps
  the per-class loop (``gbdt.py:1632-1665``);
- the step (``_fused_gate_reason``, ``gbdt.py:1523``): a host part
  draws the bagging and feature masks (the reference's host RNG streams,
  in its order) into buffers allocated once, then runs the body
  :meth:`GBDT._step_impl`, which reads those buffers and the score
  buffers and writes its results back into them in place. On CUDA,
  iteration 0 runs the body eagerly (it loads the kernels' library and
  allocates the static output); the body is then captured once into a
  CUDA graph, and every later iteration is one ``replay()``. On the CPU
  the same body runs over the same buffers without a graph. The
  iteration number reaches the body through a device buffer, from
  which GOSS and quantization derive their threefry keys on the
  device; GOSS is off before iteration ``int(1/learning_rate)``, so a
  GOSS run holds two graphs, one for each side of that threshold, and
  the host part picks one;
- GOSS (``_goss_impl``, ``gbdt.py:862``): the top ``top_rate`` rows by
  sum_k |g*h| (a stable descending sort: ties keep the lower row
  first, as ``lax.top_k``), and a threefry sample of the rest;
- quantized training (``_quantize_impl``, ``gbdt.py:1353``):
  stochastic rounding of g and h onto the int8 grid, per-class scales;
  the builder sums int8 into int32 histograms (kernels B1, B2 and B3 in
  their int8 modes) and descales for split finding; with
  ``quant_train_renew_leaf`` the leaves are renewed from the float
  sums (``_renew_leaf_impl``, ``gbdt.py:1394``) in an order fixed by
  the data, so the card's renewal is deterministic;
  ``fused_train=false`` (or ``LIGHTGBM_TPU_FUSED_TRAIN=0``) keeps the
  eager loop: the same arithmetic, op by op from the host;
- built trees stay on the device in a pending ring, one flat tensor an
  iteration; :meth:`GBDT.sync` moves every pending tree to the host in
  ONE transfer and runs the deferred checks: the NaN guard's finite
  flag, then the no-split stop;
- ``_fused_split_reason``: the configuration reasons of
  ``gbdt.py:1141-1168``. On CUDA ``fused_split=auto|on`` launches kernel
  B2 and ``off`` kernel B1; there is no probe and no quiet fallback.
  EFB bundles and sorted-subset categoricals send the build to the
  two-pass arm (B1, then ``find_best_splits``), as in the JAX package;
- EFB (``gbdt.py:144-157``): with a bundled train set the builder gets
  the per-feature (bundle, offset, most-frequent bin) and the bundle
  lattice's bin count; the subtraction-cache and capacity gates size
  the bundle lattice G x bundle_bins;
- sorted-subset categoricals (``gbdt.py:538-549``): categorical features
  with more than ``max_cat_to_onehot`` bins take the sorted-subset
  search (``ops/cat_split.py``);
- ranking (``gbdt.py:443-449``, ``:836-837``): the objective gets the
  query boundaries and positions; the step passes it the iteration
  number as ``_it_buf``; ``bagging_by_query`` draws whole queries
  (``gbdt.py:926-939``). Position-bias lambdarank updates host state
  each iteration and runs the eager loop;
- Metadata ``init_score`` (``gbdt.py:495-520``): per-row base scores
  for the train and each valid set, in place of ``boost_from_average``;
- continued training (``init_model``; ``gbdt.py:115-125``, ``:473-490``):
  the base model's per-row raw scores start the train and valid scores,
  ahead of ``init_score`` and with no ``boost_from_average``;
  ``num_init_iteration`` counts the base model's iterations;
- custom objectives (``objective`` None; ``gbdt.py:980-997``, ``:1825``):
  the caller's gradients (:meth:`GBDT._prep_custom_gh`) take the
  objective's place ahead of bagging, GOSS and quantization, in the
  eager loop (``_fused_gate_reason``: "custom objective gradients are
  host-supplied"); the class-batched build still applies;
- the subclasses DART and RF (``dart.py``, ``rf.py``) run the eager
  loop (``keep_device_trees`` keeps each tree's device arrays for
  DART's replays); ``rollback_one_iter`` undoes the newest iteration;
- the single-device builder options (gbdt.py:565-700): per-node
  feature sampling and extra-trees thresholds from a threefry tree key
  folded with the iteration (read on the device) and the class,
  interaction constraints, intermediate and advanced monotone
  constraints, ``feature_contri``, CEGB and forced splits. The kernel
  arm follows ``_fused_split_reason``; CEGB runs the eager loop and,
  with forced splits, the per-class loop;
- linear trees (``linear_tree``; gbdt.py:1423-1501, :1939-2044): the
  eager loop, per class (:meth:`GBDT._train_one_iter_linear`). Each
  tree comes to the host after its build; its leaves get ridge fits on
  the Dataset's raw values, summed on the device in float64 over the
  rows of each leaf in row order and solved there in one batch
  (:meth:`GBDT._fit_linear_leaves`); the scores move by the per-row
  linear outputs (``ops.predict_ensemble.linear_outputs``), computed in
  float64 and rounded to float32 before the add.

- out-of-core training (``out_of_core``; gbdt.py:93-130, :312-386,
  :1010-1020): with ``on``, with a shard dataset under ``auto``, or when
  the resident working set does not fit the device under ``auto`` (the
  capacity gate then degrades with a warning instead of raising), a run
  the chunked builder can grow (:meth:`GBDT._chunked_gate_reason`)
  keeps its bin matrix on the host and streams it through
  ``data.prefetch.ChunkPrefetcher`` into ``data.chunked.
  ChunkedTreeBuilder``, B1 with a carried accumulator a chunk. Only
  ``row_leaf``, gh and the scores live on the device. It runs the eager
  loop, one class at a time;
- checkpoints (:meth:`GBDT.training_state`,
  :meth:`GBDT.load_training_state`; gbdt.py:2108, :2148): the
  iteration, both host RandomState streams, the score buffers and the
  bagging mask; the threefry draws are stateless ``fold_in`` keys of
  the iteration. A restore writes into the step's own buffers;
- the fault-injection hooks of the JAX package
  (``LIGHTGBM_TPU_CHAOS_POISON_ITER``/``_ONCE``,
  ``LIGHTGBM_TPU_CHAOS_DEVLOSS_ITER``/``_ONCE``), and CUDA runtime
  errors escaping a step or the sync turned into ``DeviceLossError``.

- the parallel learners (``tree_learner=data|feature|voting``;
  gbdt.py:191-300): in a ``torch.distributed`` group of more than one
  process, ``auto`` and ``data`` train data-parallel, ``feature`` and
  ``voting`` their learners (``parallel/data_parallel.py``), each rank
  running the builder's plan branches on its own block of rows (all
  rows for ``feature``) through the eager loop. The bagging masks, the
  quantization's draws and scales are drawn over the GLOBAL rows and
  sliced, so a quantized data-parallel run trains the serial model;
  the automatic init score is the mean of the ranks'
  (``global_mean_init_scores``), the reference's GlobalSyncUpByMean.

Combinations a plan does not take raise ``NotImplementedError`` at
construction with their reason (ROADMAP A): GOSS, DART, RF, ranking,
custom objectives, continued training and out-of-core runs under a
plan.
"""

from __future__ import annotations

import gc
import os
import time
from typing import List, NamedTuple, Optional, Sequence

import numpy as np
import torch

from .. import phases
from ..config import Config
from ..dataset import Dataset, check_device_capacity
from ..objectives import Objective
from ..ops import cuda_histogram as CH
from ..ops import threefry
from ..ops.predict import predict_bins_value
from ..ops.predict_ensemble import (linear_outputs, linear_tables,
                                    pack_ensemble, walk)
from ..ops.split import SplitParams, calc_output
from ..parallel import data_parallel as dp
from ..parallel import distributed as pdist
from ..profiler import phase
from ..resilience.guards import DeviceLossError, NumericDivergenceError
from ..tree import Tree
from .tree_builder import TreeArrays, build_tree, build_tree_class_batched

__all__ = ["GBDT"]

kEpsilon = 1e-15
_ROW_BLOCK = 256


def block_rows_for(num_rows: int, num_features: int, num_bins: int) -> int:
    """The JAX package's row block (``ops/histogram.py:104-115``): the
    largest power of two in [256, 65536] whose bf16 one-hot block of
    ``num_features x num_bins`` lanes stays within 64 MiB. Its padded
    layout sets which rows enter the quantization scales."""
    blk = (1 << 26) // max(1, num_features * num_bins * 2)
    blk = int(2 ** np.floor(np.log2(max(blk, 256))))
    return max(min(blk, 1 << 16), 256)
_NP_DTYPES = {torch.bool: np.bool_, torch.int32: np.int32,
              torch.int64: np.int64, torch.float32: np.float32}


class _DeviceData:
    """Device-resident binned matrix + root partition of one dataset.

    Rows are padded to a multiple of 256. ``ref_block`` (the JAX
    package's row block, given for quantized training only) adds one
    more block of padding where only the JAX layout would have padded
    rows, so that a padded row exists in both packages or in neither:
    the quantization scales are maxima over every row, padded ones
    included (``gbdt.py:1361``)."""

    def __init__(self, ds: Dataset, block: int = _ROW_BLOCK,
                 ref_block: Optional[int] = None, plan=None,
                 unbundle: bool = False):
        self.num_data = ds.num_data
        self.r_pad = -(-ds.num_data // block) * block
        if (ref_block is not None and self.r_pad == ds.num_data
                and ds.num_data % ref_block):
            self.r_pad += block
        if plan is not None and plan.rows_sharded:
            # every rank pads its row block to one size (gbdt.py:75-77)
            self.r_pad = plan.local_rows(plan.pad_to(ds.num_data, block))
        bins = (torch.from_numpy(ds.unbundled_bins()) if unbundle
                else ds.bins).to(ds.device)
        pad = self.r_pad - ds.num_data
        if pad:
            bins = torch.cat([bins, torch.zeros(
                (pad, bins.shape[1]), dtype=bins.dtype, device=bins.device)])
        self.bins = bins.contiguous()
        rl0 = torch.zeros(self.r_pad, dtype=torch.int32, device=bins.device)
        rl0[ds.num_data:] = -1
        self.row_leaf0 = rl0


class _ChunkedDeviceData:
    """The row bookkeeping of :class:`_DeviceData` for the out-of-core
    trainer, without a resident matrix (``bins`` is None: the prefetcher
    streams it). Rows follow the prefetcher's chunk lattice, so the
    [R]-shaped scores and gradients line up with the streamed chunks
    (gbdt.py:93-107)."""

    def __init__(self, ds: Dataset, prefetcher, device: torch.device):
        self.num_data = ds.num_data
        self.r_pad = int(prefetcher.padded_rows)
        self.bins = None
        rl0 = torch.zeros(self.r_pad, dtype=torch.int32, device=device)
        rl0[ds.num_data:] = -1
        self.row_leaf0 = rl0


# CUDA errors after which the process's context is unusable
_STICKY_CUDA = ("illegal memory access", "illegal address",
                "unspecified launch failure", "misaligned address",
                "illegal instruction", "device-side assert",
                "hardware stack error", "uncorrectable ECC",
                "an illegal", "launch timed out")


def _device_loss(it: int, e: BaseException) -> Optional[DeviceLossError]:
    """``e`` as a :class:`DeviceLossError` when it is a CUDA runtime
    error (``torch.AcceleratorError``, or a RuntimeError naming one;
    the kernels' launch checks report a ``cudaError_t``), else None. It
    is sticky when its message names an error that poisons the context,
    or when the card no longer takes a synchronize."""
    acc = getattr(torch, "AcceleratorError", None)
    msg = str(e)
    if not ((acc is not None and isinstance(e, acc))
            or (isinstance(e, RuntimeError)
                and ("CUDA error" in msg or "cudaError_t" in msg))):
        return None
    sticky = any(k in msg for k in _STICKY_CUDA)
    if not sticky and torch.cuda.is_available():
        try:
            torch.cuda.synchronize()
        except RuntimeError:
            sticky = True
    return DeviceLossError(it, detail=msg.strip().splitlines()[0]
                           if msg.strip() else type(e).__name__,
                           sticky=sticky)


class _Quantized(NamedTuple):
    """An iteration's quantized gradients: int8 grid values [K, R],
    per-class (g_scale, h_scale) [K, 2] and the int8 count channel."""
    g: torch.Tensor
    h: torch.Tensor
    scales: torch.Tensor
    count: torch.Tensor


def _pad_rows(a: np.ndarray, n: int) -> np.ndarray:
    return np.pad(a, (0, n - a.shape[0])) if a.shape[0] != n else a


def _leaf_sums(row_leaf: torch.Tensor, v: torch.Tensor, L1: int
               ) -> torch.Tensor:
    """[K, L1] sums of v [K, R] over each class's leaves (row_leaf
    [K, R], dead rows -1), in an order fixed by the data: on CUDA
    ``index_put_`` with accumulate sorts the rows by leaf, stably, and
    sums each leaf's run in one fixed order (no float atomics); on the
    CPU ``index_add_`` sums in row order, as the JAX package's
    ``.at[].add`` (the CPU's ``index_put_`` with accumulate does not:
    past about 1e5 rows its sums part from the sequential ones)."""
    K = v.shape[0]
    seg = (row_leaf.clamp(0, L1 - 1) + torch.arange(
        K, device=v.device)[:, None] * L1).reshape(-1).long()
    v = torch.where(row_leaf < 0, 0.0, v).reshape(-1)
    z = torch.zeros(K * L1, dtype=torch.float32, device=v.device)
    if z.is_cuda:
        return z.index_put_((seg,), v, accumulate=True).view(K, L1)
    return z.index_add_(0, seg, v).view(K, L1)


def _bagging_active(cfg: Config) -> bool:
    """gbdt.py:892: bagging draws no mask under GOSS."""
    balanced = (cfg.pos_bagging_fraction < 1.0
                or cfg.neg_bagging_fraction < 1.0)
    return (cfg.data_sample_strategy != "goss" and cfg.bagging_freq > 0
            and (cfg.bagging_fraction < 1.0 or balanced))


def _leaf_paths(tree: Tree) -> List[List[int]]:
    """Each leaf's split features along its root path, global ids in
    first-use order (gbdt.py:1438-1449)."""
    paths: List[List[int]] = [[] for _ in range(tree.num_leaves)]
    if tree.num_leaves > 1:
        stack = [(0, [])]
        while stack:
            node, feats = stack.pop()
            if node < 0:
                paths[~node] = feats
                continue
            f = int(tree.split_feature[node])
            nf = feats if f in feats else feats + [f]
            stack.append((int(tree.left_child[node]), nf))
            stack.append((int(tree.right_child[node]), nf))
    return paths


def _tree_depth(tree: Tree) -> int:
    """Edges on the longest root-to-leaf path of a host tree: the levels
    a binned walk (``ops/predict.py``) needs."""
    depth, stack = 0, ([(0, 1)] if tree.num_leaves > 1 else [])
    while stack:
        node, d = stack.pop()
        for c in (tree.left_child[node], tree.right_child[node]):
            if c < 0:
                depth = max(depth, d)
            else:
                stack.append((int(c), d + 1))
    return depth


class GBDT:
    # DART replays stored trees: keep each tree's device arrays
    keep_device_trees = False

    def __init__(self, config: Config, train_set: Dataset,
                 objective: Optional[Objective],
                 valid_sets: Sequence[Dataset] = (),
                 init_row_scores: Optional[np.ndarray] = None,
                 valid_init_row_scores: Sequence[np.ndarray] = (),
                 num_init_iteration: int = 0):
        self.config = config
        pdist.maybe_init_distributed(config)
        self.train_set = train_set.construct()
        self.device = self.train_set.device
        self._quant = bool(config.use_quantized_grad)
        if self._quant:
            nbq = int(config.num_grad_quant_bins)
            if not 2 <= nbq <= 127:
                raise ValueError(
                    "num_grad_quant_bins must be in [2, 127] (int8 grid)")
            # int32 accumulator bound: a leaf's hessian bin sum can reach
            # rows * nb (gbdt.py:615-629)
            if self.train_set.num_data * nbq >= 2 ** 31:
                raise ValueError(
                    "use_quantized_grad: num_data * num_grad_quant_bins "
                    "overflows the int32 histogram accumulator; lower "
                    "num_grad_quant_bins")
        self.objective = objective
        self.iter_ = 0
        self.num_init_iteration = int(num_init_iteration)
        self.models: List[Tree] = []
        self.K = int(objective.num_model_per_iteration
                     if objective is not None else max(1, config.num_class))
        self.shrinkage = config.learning_rate
        F = self.train_set.num_features
        self.B = int(self.train_set.max_num_bin)
        # EFB: the builder histograms the bundled [R, G] matrix over the
        # bundle lattice and unbundles to per-feature space
        # (gbdt.py:144-157)
        bp = self.train_set.bundle_plan
        self._bundle_meta = None
        self._bundle_bins = 0
        if bp is not None:
            self._bundle_meta = tuple(
                torch.from_numpy(np.asarray(a, np.int32)).to(self.device)
                for a in (bp.feat_bundle, bp.feat_offset, bp.feat_mfb))
            self._bundle_bins = int(bp.max_bundle_bins)
            cols, col_bins = bp.num_bundles, self._bundle_bins
        else:
            cols, col_bins = F, self.B
        # the parallel learner (gbdt.py:191-300); feature-parallel
        # decodes EFB storage to per-feature columns
        self.plan = None
        self._unbundle_feature = False
        self._init_plan(valid_sets, objective, init_row_scores)
        if self._unbundle_feature:
            cols, col_bins = F, self.B
        lattice = cols * col_bins
        # the JAX package's row block: the quantization scales see its
        # row layout, and the out-of-core chunks are cut to it
        jax_block = block_rows_for(self.train_set.num_data, cols, col_bins)
        ref_block = jax_block if self._quant else None

        # feature_contri: each feature's split-gain factor
        # (feature_histogram.hpp:174; gbdt.py:642-653)
        self._gain_scale = None
        if config.feature_contri:
            fc = np.asarray(config.feature_contri, np.float32)
            ntf = self.train_set.num_total_features
            if len(fc) != ntf:
                raise ValueError(
                    f"feature_contri has {len(fc)} entries but the "
                    f"dataset has {ntf} features")
            self._gain_scale = torch.from_numpy(
                fc[self.train_set.used_features]).to(self.device)
        # forced splits (SerialTreeLearner::ForceSplits; gbdt.py:660-663)
        self._forced_splits = None
        if config.forcedsplits_filename:
            self._forced_splits = self._parse_forced_splits(
                config.forcedsplits_filename)
        # CEGB (gbdt.py:666-700; cost_effective_gradient_boosting.hpp
        # IsEnable): the features any tree used and, with lazy costs,
        # the features each row paid for; model-level state carried
        # from tree to tree
        self._cegb = None
        self._cegb_feat_used = None
        self._cegb_used_rows = None
        if (config.cegb_tradeoff < 1.0 or config.cegb_penalty_split > 0.0
                or config.cegb_penalty_feature_coupled
                or config.cegb_penalty_feature_lazy):
            uf = self.train_set.used_features

            def per_feat(vals, name):
                if not vals:
                    return None
                vals = np.asarray(vals, np.float32)
                if len(vals) != self.train_set.num_total_features:
                    raise ValueError(f"{name} should be the same size as "
                                     "feature number")
                return torch.from_numpy(vals[uf]).to(self.device)
            coupled = per_feat(config.cegb_penalty_feature_coupled,
                               "cegb_penalty_feature_coupled")
            lazy = per_feat(config.cegb_penalty_feature_lazy,
                            "cegb_penalty_feature_lazy")
            self._cegb = (float(config.cegb_tradeoff),
                          float(config.cegb_penalty_split), coupled, lazy)
            self._cegb_feat_used = torch.zeros(F, dtype=torch.bool,
                                               device=self.device)

        # out-of-core (gbdt.py:312-336): out_of_core=on, or a shard
        # dataset under auto, trains chunked unless a feature of the run
        # pins the resident path (on then raises the reason)
        self.chunked = False
        self._chunk_source = None
        self._prefetcher = None
        self._chunked_builder = None
        oc = str(config.out_of_core)
        chunk_reason = self._chunked_gate_reason()
        shard_src = self.train_set.chunk_source
        if oc == "on" or (oc == "auto" and shard_src is not None):
            if chunk_reason:
                if oc == "on":
                    raise ValueError(
                        "out_of_core=on but chunked training cannot "
                        f"drive this run: {chunk_reason}")
            else:
                self.chunked = True
                self._chunk_source = shard_src
        # class-batched multiclass build, decided before the pool gate:
        # the batched builder keeps K per-leaf histogram caches
        self.class_batch_reason = self._class_batch_reason()
        self.class_batch_ok = not self.class_batch_reason
        batched_k = self.K if self.class_batch_ok and self.K > 1 else 1
        pool = (config.histogram_pool_size
                if config.histogram_pool_size > 0 else 512.0)
        # the JAX rule (gbdt.py:162-175, :296-299, re-gated at K x the
        # lattice for the batched build at :699-706), so both packages
        # decide alike
        cache_mb = (batched_k * (config.num_leaves + 1) * lattice * 3 * 4
                    / 2 ** 20)
        self._hist_sub = bool(config.hist_subtraction) and cache_mb <= pool
        if bool(config.hist_subtraction) and not self._hist_sub:
            from .. import log
            log.warning(f"per-leaf histogram cache would need {cache_mb:.0f}"
                        f" MB (> histogram_pool_size budget {pool:.0f} MB);"
                        " disabling histogram subtraction")
        if not self.chunked:
            # the G stored columns under EFB, at the bundle lattice's
            # bins; a run the chunked builder can grow degrades to
            # streaming row chunks instead of failing (gbdt.py:350-373)
            bins = self.train_set.bins
            try:
                check_device_capacity(
                    self.train_set.num_data, bins.shape[1],
                    bins.element_size(), config.num_leaves,
                    self._bundle_bins or self.B, self._hist_sub,
                    self.device, num_class=self.K, hist_caches=batched_k)
            except MemoryError:
                if oc == "off" or chunk_reason:
                    raise
                from .. import log
                log.warning("binned matrix exceeds device capacity; "
                            "streaming it in row chunks (out_of_core) "
                            "instead")
                self.chunked = True
                # one class a build: the pool gate at one cache
                self.class_batch_reason = self._class_batch_reason()
                self.class_batch_ok = False
                self._hist_sub = bool(config.hist_subtraction) and (
                    (config.num_leaves + 1) * lattice * 3 * 4 / 2 ** 20
                    <= pool)
        if self.chunked:
            from ..data.chunked import ArraySource
            from ..data.prefetch import ChunkPrefetcher, chunk_rows_for
            src = self._chunk_source
            if src is None:
                src = self._chunk_source = ArraySource(self.train_set.bins)
            # the JAX package's chunk geometry: its block, and its bin
            # width (uint8, or int32 above 256 bins)
            c_rows = chunk_rows_for(
                self.train_set.num_data, src.num_features,
                1 if self.B <= 256 else 4, config.chunk_budget_mb,
                jax_block)
            self._prefetcher = ChunkPrefetcher(src, c_rows, self.device)
            self.train_dd = _ChunkedDeviceData(self.train_set,
                                               self._prefetcher, self.device)
        else:
            self.train_dd = _DeviceData(
                self.train_set, ref_block=ref_block, plan=self.plan,
                unbundle=self._unbundle_feature)
        if self._cegb is not None and self._cegb[3] is not None:
            self._cegb_used_rows = torch.zeros(
                (self.train_dd.r_pad, F), dtype=torch.bool,
                device=self.device)
        # in-bag count channel without bagging: 1 for real rows
        self._count_mask = (self.train_dd.row_leaf0 >= 0).to(torch.float32)
        self.valid_sets = [v.construct() for v in valid_sets]
        self.valid_dd = [_DeviceData(v, plan=self.plan,
                                     unbundle=self._unbundle_feature)
                         for v in self.valid_sets]
        # the global row layout of a row-sharded plan: every rank's
        # count, this rank's offset, and whether the serial layout of
        # the global rows pads (a quantized run's scales read it)
        self._n_global = self.train_dd.num_data
        self._row_off = 0
        self._serial_pads = self.train_dd.r_pad > self.train_dd.num_data
        if self.plan is not None and self.plan.rows_sharded:
            counts = self.plan.row_counts(self.train_dd.num_data)
            self._n_global = int(counts.sum())
            self._row_off = int(counts[:self.plan.rank].sum())
            r_ser = -(-self._n_global // _ROW_BLOCK) * _ROW_BLOCK
            if (ref_block is not None and r_ser == self._n_global
                    and self._n_global % ref_block):
                r_ser += _ROW_BLOCK
            self._serial_pads = r_ser > self._n_global
        self._linear = bool(config.linear_tree)
        if self._linear:
            # gbdt.py:182-191
            for ds_ in (self.train_set, *self.valid_sets):
                if ds_.raw_values is None:
                    raise ValueError(
                        "linear_tree needs raw feature values for every "
                        "dataset; construct the Datasets with "
                        "linear_tree set")

        dev = self.device
        R = self.train_dd.r_pad
        lbl = self.train_set.get_label()
        w = self.train_set.get_weight()
        self.weight_dev = None if w is None else torch.from_numpy(
            _pad_rows(np.asarray(w, np.float32), R)).to(dev)
        if objective is not None:
            okw = {}
            if objective.is_ranking and self.train_set.position is not None:
                okw["position"] = self.train_set.position
            objective.init(lbl, w, self.train_set.query_boundaries(), **okw)
            if objective.is_ranking:
                # the query lattice's index tensors, on the device once
                objective.bind(dev, R)
            # init() may retarget training to a transformed label
            # (reg_sqrt trains on sign(y)*sqrt(|y|)): the gradients see
            # the label the init score was derived from (gbdt.py:450-456)
            lbl = objective.label
        self.label_dev = torch.from_numpy(_pad_rows(
            np.asarray(lbl, np.float32), R)).to(dev)
        self._init_scores = np.zeros(self.K)
        if init_row_scores is not None:
            # continued training: the base model's per-row raw scores,
            # ahead of Metadata init_score and with no boost_from_average
            # (gbdt.cpp boosts from the average only with no models)
            self.scores = self._row_scores(init_row_scores, self.train_dd)
            self.valid_scores = [self._row_scores(v, dd) for v, dd in
                                 zip(valid_init_row_scores, self.valid_dd)]
        elif self.train_set.get_init_score() is not None:
            # Metadata init_score: per-row base scores before any
            # boosting (gbdt.py:495-520); no boost_from_average and no
            # AddBias, so predictions exclude the offset, as in the
            # reference. A valid set without its own starts at zero.
            self.scores = self._field_init_scores(
                self.train_set.get_init_score(), self.train_set.num_data, R)
            self.valid_scores = [
                self._field_init_scores(v.get_init_score(), v.num_data,
                                        dd.r_pad)
                if v.get_init_score() is not None else
                torch.zeros((self.K, dd.r_pad), dtype=torch.float32,
                            device=dev)
                for v, dd in zip(self.valid_sets, self.valid_dd)]
        else:
            if config.boost_from_average and objective is not None:
                self._init_scores = np.resize(np.asarray(
                    objective.boost_from_score(), np.float64).reshape(-1),
                    self.K)
                if self.plan is not None and self.plan.rows_sharded:
                    # Network::GlobalSyncUpByMean in BoostFromAverage
                    # (gbdt.cpp:313; gbdt.py:460-467)
                    self._init_scores = pdist.global_mean_init_scores(
                        self._init_scores, self.plan.comm)
            base = torch.from_numpy(
                self._init_scores.astype(np.float32)[:, None]).to(dev)
            self.scores = base.expand(self.K, R).contiguous()
            self.valid_scores = [base.expand(self.K, dd.r_pad).contiguous()
                                 for dd in self.valid_dd]

        ts = self.train_set
        self.num_bins_pf = torch.from_numpy(ts.per_feature_num_bins()).to(dev)
        self.nan_bin_pf = torch.from_numpy(ts.per_feature_nan_bins()).to(dev)
        is_cat = ts.per_feature_is_categorical()
        self.is_cat_pf = torch.from_numpy(is_cat).to(dev)
        self._has_cat = bool(is_cat.any())
        # sorted-subset categorical splits: features with more than
        # max_cat_to_onehot bins leave the one-hot path (gbdt.py:538-549,
        # feature_histogram.cpp:172); the scan's bound is their widest
        nb_pf = ts.per_feature_num_bins()
        csm = is_cat & (nb_pf > int(config.max_cat_to_onehot))
        self._cat_sorted_mask = (torch.from_numpy(csm).to(dev)
                                 if csm.any() else None)
        self._max_sorted_bins = int(nb_pf[csm].max()) if csm.any() else 0
        self.split_params = SplitParams(
            lambda_l1=float(config.lambda_l1),
            lambda_l2=float(config.lambda_l2),
            min_data_in_leaf=float(config.min_data_in_leaf),
            min_sum_hessian_in_leaf=float(config.min_sum_hessian_in_leaf),
            min_gain_to_split=float(config.min_gain_to_split),
            cat_l2=float(config.cat_l2),
            cat_smooth=float(config.cat_smooth),
            max_delta_step=float(config.max_delta_step),
            path_smooth=float(config.path_smooth),
            monotone_penalty=float(config.monotone_penalty),
            extra_trees=bool(config.extra_trees),
            max_cat_threshold=int(config.max_cat_threshold),
            max_cat_to_onehot=int(config.max_cat_to_onehot),
            min_data_per_group=float(config.min_data_per_group))
        self.mono_type_pf = self._parse_monotone_constraints()
        self.interaction_groups = self._parse_interaction_constraints()
        # the key of per-node feature sampling and extra-trees thresholds
        # (gbdt.py:570-576); each tree folds in its iteration, then its
        # class
        self._ffbn = float(config.feature_fraction_bynode)
        self._tree_key = None
        if self._ffbn < 1.0 or config.extra_trees:
            self._tree_key = threefry.prng_key(
                (int(config.feature_fraction_seed) * 2654435761
                 + int(config.extra_seed)) & 0x7FFFFFFF, dev)
        self._rng_feature = np.random.RandomState(
            config.feature_fraction_seed)
        self._rng_bagging = np.random.RandomState(config.bagging_seed)
        self._bagging = _bagging_active(config)
        self._goss = config.data_sample_strategy == "goss"
        if self._goss and config.top_rate + config.other_rate > 1.0:
            raise ValueError("top_rate + other_rate must be <= 1")
        self._goss_start = int(1.0 / config.learning_rate)
        self._renew = self._quant and bool(config.quant_train_renew_leaf)
        # the threefry keys of GOSS's sample and of the stochastic
        # rounding (gbdt.py:631, :1574); each iteration folds in its
        # number on the device
        self._goss_key = (threefry.prng_key(config.bagging_seed, dev)
                          if self._goss else None)
        self._quant_key = (threefry.prng_key(
            (int(config.data_random_seed) * 65537 + 17) & 0x7FFFFFFF, dev)
            if self._quant else None)
        self._nan_guard = str(config.nan_guard)
        # the pending ring: (iteration, shrinkage, flat f64 tensor of the
        # iteration's K trees, grew [K] and finite flag), see _flatten
        self._pending: List[tuple] = []
        # (device TreeArrays, shrinkage) of every kept tree, with
        # keep_device_trees
        self.device_trees: List[tuple] = []
        self.host_sync_count = 0
        self.bag_draw_seconds = 0.0      # host time of the bagging draws
        self.fused_split_reason = self._fused_split_reason()
        self.fused_split_ok = not self.fused_split_reason
        self.fused_train_reason = self._fused_gate_reason()
        self.fused_train_ok = not self.fused_train_reason

        # The step's inputs and outputs, each in a buffer allocated once
        # (with self.scores and self.valid_scores): a replayed CUDA graph
        # reads and writes these very buffers, so the host part writes
        # its inputs into them and the body writes its outputs back in
        # place (the JAX package donates the same buffers).
        self._bag_buf = (torch.zeros(R, dtype=torch.uint8, device=dev)
                         if self._bagging else None)
        self._bag_drawn = False
        self._fmask_buf = torch.ones(F, dtype=torch.bool, device=dev)
        self._lr_buf = torch.zeros((), dtype=torch.float32, device=dev)
        self._it_buf = torch.zeros((), dtype=torch.int64, device=dev)
        self._true = torch.ones((), dtype=torch.bool, device=dev)
        self._step_out: Optional[torch.Tensor] = None
        self._layout: Optional[list] = None
        # one captured graph per GOSS phase (False before the start
        # iteration, True after; a run without GOSS has only False);
        # _graph and _graph_launches are the last one dispatched
        self._graphs: dict = {}
        self._graph = None
        self._graph_launches: dict = {}
        self.capture_seconds: Optional[float] = None
        self.capture_count = 0
        if self.chunked:
            from ..data.chunked import ChunkedTreeBuilder
            self._chunked_builder = ChunkedTreeBuilder(
                num_bins_pf=self.num_bins_pf, nan_bin_pf=self.nan_bin_pf,
                is_cat_pf=self.is_cat_pf, num_leaves=config.num_leaves,
                leaf_batch=config.leaf_batch, max_depth=config.max_depth,
                num_bins=self.B, split_params=self.split_params,
                hist_dtype=config.hist_dtype, hist_sub=self._hist_sub,
                has_cat=self._has_cat,
                cat_sorted_mask=self._cat_sorted_mask,
                max_sorted_bins=self._max_sorted_bins)

    # ------------------------------------------------------------------
    def _init_plan(self, valid_sets, objective, init_row_scores) -> None:
        """Choose the parallel learner (gbdt.py:191-300) and check what
        it cannot take. Sets ``plan`` (None: serial), and with
        ``tree_learner=feature`` over EFB storage, ``_unbundle_feature``
        (the device holds per-feature columns; training is that of the
        bundled run's features)."""
        from .. import log
        cfg = self.config
        W = pdist.world_size()
        tl = str(cfg.tree_learner)
        serial_why = dp.serial_reason(cfg)
        if W > 1 and tl != "serial" and serial_why:
            log.warning(serial_why)
            if bool(cfg.pre_partition):
                # a rank that trains alone must hold every row
                pdist.check_replicas_identical(
                    [self.train_set] + [v.construct() for v in valid_sets])
        cls = dp.learner_class(cfg, W)
        if cls is None:
            if W <= 1 and tl not in ("serial", "auto"):
                log.warning(f"tree_learner={tl} needs a torch.distributed "
                            "group of more than one process (world size "
                            f"{W}); training serial")
            if cfg.feature_shard_storage:
                log.warning(
                    "feature_shard_storage needs tree_learner=feature and "
                    f"more than one device ({W} visible); storing the "
                    "matrix unsharded")
            return
        why = self._plan_unsupported(objective, init_row_scores)
        if why:
            raise NotImplementedError(
                f"tree_learner={cls.parallel_mode} does not take {why} in "
                "lightgbm_tpu_torch yet (ROADMAP A)")
        kw = {}
        if cls is dp.FeatureParallelPlan:
            kw["shard_storage"] = bool(cfg.feature_shard_storage)
            if self._bundle_meta is not None:
                # feature mode shards FEATURES: decode the bundles (every
                # rank holds every row, the reference's model)
                self._bundle_meta = None
                self._bundle_bins = 0
                self._unbundle_feature = True
        else:
            if cfg.feature_shard_storage:
                log.warning("feature_shard_storage only applies with "
                            "tree_learner=feature; ignoring")
            hm = str(cfg.dp_hist_merge)
            if cfg.forcedsplits_filename and hm != "allreduce":
                # the forced gather reads full-feature rows of the cache
                if hm == "reduce_scatter":
                    log.warning("forced splits need the full-histogram "
                                "merge; pinning dp_hist_merge=allreduce")
                hm = "allreduce"
            kw["hist_merge"] = hm
        # a Comm of the run's own over the default group: its report is
        # this run's record of collectives (telemetry's gauges read it)
        from ..parallel.comms import Comm
        self.plan = cls(Comm(None, label=cls.parallel_mode),
                        top_k=int(cfg.top_k), **kw)
        if cls is dp.FeatureParallelPlan:
            for ds_ in (self.train_set, *[v.construct()
                                          for v in valid_sets]):
                if getattr(ds_, "auto_partitioned", False):
                    raise ValueError(
                        "tree_learner=feature across machines requires "
                        "every worker to load the FULL dataset")
            pdist.check_replicas_identical(
                [self.train_set] + [v.construct() for v in valid_sets],
                self.plan.comm)

    def _plan_unsupported(self, objective, init_row_scores) -> str:
        """What a parallel plan cannot take in the port ('' = none)."""
        cfg = self.config
        if type(self) is not GBDT:
            return f"boosting={cfg.boosting}"
        if cfg.data_sample_strategy == "goss":
            return "GOSS (its top-k needs the global score order)"
        if objective is None:
            return "custom objectives"
        if objective.is_ranking:
            return "ranking objectives (queries per rank)"
        if init_row_scores is not None:
            return "continued training (init_model)"
        if (str(cfg.out_of_core) == "on"
                or self.train_set.chunk_source is not None):
            return "out-of-core training"
        if cfg.bagging_by_query:
            return "bagging_by_query"
        if cfg.forcedsplits_filename and cfg.tree_learner in ("feature",
                                                              "voting"):
            return "forced splits (they read full-feature histograms)"
        return ""

    def global_rows(self, a):
        """A per-row host field (label, weight) of this rank's rows ->
        the global rows, in rank order, under a row-sharded plan."""
        if a is None or self.plan is None or not self.plan.rows_sharded:
            return a
        return self.plan.gather_rows(np.asarray(a))

    def _row_scores(self, a, dd: _DeviceData) -> torch.Tensor:
        """Per-row raw scores [n] or [n, K] -> [K, r_pad] f32 on the
        device, padded rows 0 (continued training's base scores)."""
        a = np.asarray(a, np.float32)
        if a.ndim == 1:
            a = a[:, None]
        out = np.zeros((self.K, dd.r_pad), np.float32)
        out[:, :dd.num_data] = a.T
        return torch.from_numpy(out).to(self.device)

    def _field_init_scores(self, init, n: int, r_pad: int) -> torch.Tensor:
        """Metadata init_score -> [K, r_pad] f32 on the device: [n],
        [n, K], or flat [n*K] laid out class-major (the reference's
        per-class contiguous blocks, metadata.cpp:120-129)."""
        a = np.asarray(init, np.float32)
        if a.ndim == 2:
            a = a.T
        elif a.size == n * self.K and self.K > 1:
            a = a.reshape(self.K, n)
        else:
            if a.size != n:
                raise ValueError(
                    f"init_score size {a.size} does not match num_data {n}"
                    f" (num_model_per_iteration={self.K})")
            a = np.broadcast_to(a.reshape(1, n), (self.K, n))
        out = np.zeros((self.K, r_pad), np.float32)
        out[:, :n] = a
        return torch.from_numpy(out).to(self.device)

    def _parse_monotone_constraints(self) -> Optional[torch.Tensor]:
        mc = self.config.monotone_constraints
        if not mc:
            return None
        mc = np.asarray(list(mc), np.int32)
        ts = self.train_set
        if len(mc) != ts.num_total_features:
            raise ValueError(
                f"monotone_constraints has {len(mc)} entries but the "
                f"dataset has {ts.num_total_features} features")
        if not np.isin(mc, (-1, 0, 1)).all():
            raise ValueError("monotone_constraints values must be in "
                             "{-1, 0, 1}")
        used = mc[ts.used_features]
        if not used.any():
            return None
        if (used != 0)[ts.per_feature_is_categorical()].any():
            raise ValueError("monotone_constraints cannot be used with "
                             "categorical features")
        method = self.config.monotone_constraints_method
        if method not in ("basic", "intermediate", "advanced"):
            raise ValueError(f"unknown monotone_constraints_method {method}")
        return torch.from_numpy(used).to(self.device)

    def _parse_interaction_constraints(self) -> Optional[torch.Tensor]:
        """[G, F] bool group matrix over the used features, or None
        (gbdt.py:789-821; col_sampler.hpp:28). A string is read as JSON
        with ( ) for [ ]; a flat list is one group."""
        ic = self.config.interaction_constraints
        if not ic:
            return None
        if isinstance(ic, str):
            import json
            txt = ic.strip().replace("(", "[").replace(")", "]")
            try:
                parsed = json.loads(txt)
            except json.JSONDecodeError:
                parsed = json.loads("[" + txt + "]")
            if parsed and all(isinstance(x, (int, float)) for x in parsed):
                parsed = [parsed]
            ic = parsed
        groups = [list(g) for g in ic]
        ntf = self.train_set.num_total_features
        used_pos = {int(f): i
                    for i, f in enumerate(self.train_set.used_features)}
        mat = np.zeros((len(groups), len(used_pos)), bool)
        for gi, g in enumerate(groups):
            for f in g:
                f = int(f)
                if f < 0 or f >= ntf:
                    raise ValueError(
                        f"interaction_constraints feature index {f} out of "
                        f"range [0, {ntf})")
                if f in used_pos:
                    mat[gi, used_pos[f]] = True
        return torch.from_numpy(mat).to(self.device)

    def _parse_forced_splits(self, path: str) -> tuple:
        """The forced-split JSON tree -> (parents, is_right, features,
        threshold bins, is_categorical), host tuples in BFS order
        (gbdt.py:1289-1352, the ForceSplits queue). Each node names its
        parent's index (-1 at the root); the builder resolves the slots
        as the splits apply, so a dropped node drops its subtree.
        Features are original column ids; thresholds map through the
        feature's BinMapper. A categorical node forces the one-hot split
        on its category; a category unseen in training gets bin -1,
        which the builder drops."""
        import json
        from collections import deque
        with open(path) as fh:
            root = json.load(fh)
        uf = [int(f) for f in self.train_set.used_features]
        parents, isright, feats, thrs, iscat = [], [], [], [], []
        q = deque([(root, -1, False)])
        while q:
            node, pj, is_r = q.popleft()
            if not node:
                continue
            f_orig = int(node["feature"])
            if f_orig not in uf:
                raise ValueError(f"forced split feature {f_orig} is not a "
                                 "used feature of the dataset")
            m = self.train_set.bin_mappers[f_orig]
            if m.bin_type == "categorical":
                cv = int(float(node["threshold"]))
                thr_bin = m._cat_to_bin.get(cv, -1) if cv >= 0 else -1
                if thr_bin < 0:
                    from .. import log
                    log.warning(
                        "Invalid categorical threshold split: category "
                        f"{cv} of feature {f_orig} was not seen in "
                        "training; the forced node will be skipped")
            else:
                thr_bin = int(m.values_to_bins(
                    np.asarray([float(node["threshold"])]))[0])
            me = len(parents)
            parents.append(pj)
            isright.append(is_r)
            feats.append(uf.index(f_orig))
            thrs.append(thr_bin)
            iscat.append(m.bin_type == "categorical")
            if node.get("left"):
                q.append((node["left"], me, False))
            if node.get("right"):
                q.append((node["right"], me, True))
        return (tuple(parents), tuple(isright), tuple(feats), tuple(thrs),
                tuple(iscat))

    def _class_batch_reason(self) -> str:
        """Why the class-batched build cannot drive this run ('' = it
        can): the reasons of gbdt.py:1181 that apply to the port. With
        ``class_batch=auto|on`` it clears for every K > 1; one model per
        iteration batches only with ``class_batch=on``. DART and RF run
        their own per-class loops; forced splits assign node slots one
        split at a time and CEGB carries model state from one class's
        tree to the next, so both build per class; linear trees fit
        each class's leaves on the host's copy of its tree. The JAX
        package's other reasons (feature-parallel plans, multi-process
        meshes) name options the port rejects at construction."""
        env = os.environ.get("LIGHTGBM_TPU_CLASS_BATCH", "")
        if env == "0":
            return "LIGHTGBM_TPU_CLASS_BATCH=0"
        if self.chunked:
            return "out-of-core training streams row chunks per tree"
        mode = "on" if env == "1" else str(self.config.class_batch)
        if mode == "off":
            return "class_batch=off"
        if self.K <= 1 and mode != "on":
            return "single model per iteration"
        if type(self) is not GBDT:
            return "boosting mode overrides the iteration loop"
        if bool(self.config.linear_tree):
            return "linear leaves solve per-class on host raw values"
        if self._forced_splits is not None:
            return "forced splits assign node slots sequentially"
        if self._cegb is not None:
            return "CEGB threads per-class model state across builds"
        if self.plan is not None and self.plan.parallel_mode == "feature":
            return "feature-parallel plan builds per-class"
        if self.plan is not None:
            return "multi-process meshes place per-host blocks"
        return ""

    def _fused_gate_reason(self) -> str:
        """Why the step cannot drive this run ('' = it can): the
        reasons of gbdt.py:1523 that apply to the port. CEGB's
        model-level state is handed from one build to the next on the
        host, so it runs the eager loop, and so do custom objectives,
        whose gradients the caller computes from the scores each
        iteration. The JAX package's others name per-iteration host work
        that the port refuses at construction (out-of-core chunks,
        parallel plans). Linear trees bring each tree to the host for
        its leaf fits. The host-drawn
        bagging and feature masks do not pin the eager loop: they are
        inputs of the step."""
        if os.environ.get("LIGHTGBM_TPU_FUSED_TRAIN", "") == "0":
            return "LIGHTGBM_TPU_FUSED_TRAIN=0"
        if not bool(self.config.fused_train):
            return "fused_train=false"
        if self.chunked:
            return "out-of-core chunk sweeps are host-driven"
        if type(self) is not GBDT:
            return "boosting mode overrides the iteration loop"
        if self.objective is None:
            return "custom objective gradients are host-supplied"
        if bool(self.config.linear_tree):
            return "linear leaves solve on host raw values"
        if self._cegb is not None:
            return "CEGB threads model-level host state"
        if self.plan is not None:
            # a gloo collective is a host call: no CUDA graph holds it
            return "multi-process meshes place per-host blocks"
        if self.objective.is_ranking and getattr(
                self.objective, "num_position_ids", 0):
            return "position-bias estimation updates host state"
        return ""

    def _chunked_gate_reason(self) -> str:
        """Why the out-of-core chunked builder cannot grow this run's
        trees ('' = it can): the reasons of gbdt.py:1093-1124, read from
        the raw config (it runs at the capacity gate). The chunked
        builder replays the serial round body over streamed chunks;
        anything that bends it pins the resident path."""
        cfg = self.config
        if type(self) is not GBDT:
            return "boosting mode replays resident device trees"
        if self._bundle_meta is not None:
            return "EFB bundles bin in device bundle space"
        if bool(cfg.linear_tree):
            return "linear leaves read resident raw feature values"
        if cfg.monotone_constraints:
            return "monotone constraints propagate cross-leaf bounds"
        if cfg.interaction_constraints:
            return "interaction constraints thread per-node ancestry"
        if cfg.forcedsplits_filename:
            return "forced splits assign node slots sequentially"
        if (cfg.cegb_tradeoff < 1.0 or cfg.cegb_penalty_split > 0.0
                or cfg.cegb_penalty_feature_coupled
                or cfg.cegb_penalty_feature_lazy):
            return "CEGB tracks per-row feature-use device state"
        if float(cfg.feature_fraction_bynode) < 1.0:
            return "per-node feature sampling draws inside the builder"
        if bool(cfg.extra_trees):
            return "extra-trees thresholds draw inside the builder"
        return ""

    def _fused_split_reason(self) -> str:
        """Why kernel B2 cannot drive this run's split search ('' = it
        can): the configuration reasons of gbdt.py:1141-1168, in their
        order. Each sends the build to the two-pass arm (B1, then
        ``find_best_splits``)."""
        cfg = self.config
        env = os.environ.get("LIGHTGBM_TPU_FUSED_SPLIT", "")
        if env == "0":
            return "LIGHTGBM_TPU_FUSED_SPLIT=0"
        mode = "on" if env == "1" else str(cfg.fused_split)
        if mode == "off":
            return "fused_split=off"
        if self.chunked:
            return "chunked rounds accumulate histograms across chunks"
        if self.plan is not None:
            return "parallel plans merge full histograms"
        if self._bundle_meta is not None:
            return "EFB bundles unbundle the full histogram"
        if bool(cfg.extra_trees):
            return "extra-trees thresholds sample the full lattice"
        if self._forced_splits is not None:
            return "forced splits gather arbitrary (feature, bin) cells"
        if self._cegb is not None:
            return "CEGB rescales gains outside the kernel"
        if self._gain_scale is not None:
            return "feature_contri rescales gains outside the kernel"
        if self._cat_sorted_mask is not None:
            return "sorted-subset categoricals reorder histogram bins"
        if (self.mono_type_pf is not None
                and cfg.monotone_constraints_method == "advanced"):
            return "advanced monotone re-reads sibling histograms"
        return ""

    # ------------------------------------------------------------------
    def _grads(self, scores: torch.Tensor):
        """[K, R] grad and hess at ``scores`` [K, R]. A ranking objective
        also reads the iteration number, from ``_it_buf`` on the device
        (gbdt.py:836-837)."""
        if self.K > 1:
            return self.objective.get_gradients(scores, self.label_dev,
                                                self.weight_dev)
        kw = {"it": self._it_buf} if self.objective.is_ranking else {}
        g, h = self.objective.get_gradients(scores[0], self.label_dev,
                                            self.weight_dev, **kw)
        return g[None, :], h[None, :]

    def _stack_gh_k(self, g, h, count_mask):
        """[K, R, 3] gh for the class-batched build (gbdt.py:1282)."""
        return torch.stack([g, h, count_mask.expand_as(g)], dim=2)

    @staticmethod
    def _update_score_impl(scores_k, leaf_values, row_leaf, lr):
        """scores + lr * leaf value of each live row; [R] or [K, R]
        scores with [L+1] or [K, L+1] leaf values."""
        rlc = torch.where(row_leaf >= 0, row_leaf,
                          leaf_values.shape[-1] - 1).long()
        add = torch.gather(leaf_values, -1, rlc) * lr
        return scores_k + torch.where(row_leaf >= 0, add, 0.0)

    def _host_bag_mask(self, it: int) -> Optional[np.ndarray]:
        """The bagging mask [R] uint8 when iteration ``it`` draws a new
        one, else None (bagging off, or the last mask still holds):
        gbdt.py:899, plain, balanced (bagging.hpp:146-165) and by query
        (whole queries, bagging.hpp:36,169), with the reference's
        RandomState(bagging_seed) stream, so the masks are bit-equal to
        its masks."""
        cfg = self.config
        if not self._bagging or (self._bag_drawn
                                 and it % cfg.bagging_freq != 0):
            return None
        t0 = time.perf_counter()
        self._bag_drawn = True
        # a row-sharded plan draws the mask of the GLOBAL rows, the
        # serial run's, and keeps its own block of it
        n = self._n_global
        m = np.zeros(max(n, self.train_dd.r_pad), np.uint8)
        if cfg.pos_bagging_fraction < 1.0 or cfg.neg_bagging_fraction < 1.0:
            lbl = np.asarray(self._global_label())[:n]
            for rows, frac in ((np.nonzero(lbl > 0)[0],
                                cfg.pos_bagging_fraction),
                               (np.nonzero(lbl <= 0)[0],
                                cfg.neg_bagging_fraction)):
                if len(rows):
                    cnt = max(1, int(len(rows) * frac))
                    m[self._rng_bagging.choice(rows, cnt,
                                               replace=False)] = 1
        elif cfg.bagging_by_query:
            bounds = self.train_set.query_boundaries()
            if bounds is None:
                raise ValueError("bagging_by_query needs query/group data "
                                 "on the training Dataset")
            nq = len(bounds) - 1
            cnt = max(1, int(nq * cfg.bagging_fraction))
            for q in self._rng_bagging.choice(nq, cnt, replace=False):
                m[bounds[q]:bounds[q + 1]] = 1
        else:
            # choice(n, cnt) permutes all n rows on the host: the
            # reference's stream, timed apart in bag_draw_seconds
            cnt = max(1, int(n * cfg.bagging_fraction))
            m[self._rng_bagging.choice(n, cnt, replace=False)] = 1
        if n != self.train_dd.num_data:
            loc = np.zeros(self.train_dd.r_pad, np.uint8)
            loc[:self.train_dd.num_data] = m[
                self._row_off:self._row_off + self.train_dd.num_data]
            m = loc
        self.bag_draw_seconds += time.perf_counter() - t0
        return m

    def _global_label(self) -> np.ndarray:
        """The train set's labels over the global rows (gathered once
        under a row-sharded plan)."""
        if getattr(self, "_glabel", None) is None:
            self._glabel = self.global_rows(
                np.asarray(self.train_set.get_label()))
        return self._glabel

    def _feature_mask(self) -> Optional[np.ndarray]:
        """This iteration's feature mask [F] bool from the reference's
        RandomState(feature_fraction_seed) stream, or None when every
        feature is used (the buffer holds all ones)."""
        cfg = self.config
        if cfg.feature_fraction >= 1.0:
            return None
        F = self.train_set.num_features
        k = max(1, int(F * cfg.feature_fraction))
        m = np.zeros(F, bool)
        m[self._rng_feature.choice(F, k, replace=False)] = True
        return m

    @staticmethod
    def _put(buf: torch.Tensor, a: np.ndarray) -> None:
        """Host array -> static device buffer, on the current stream,
        without a host sync: on CUDA through a fresh pinned copy, which
        the caching host allocator keeps until the copy has run."""
        t = torch.from_numpy(a)
        if buf.is_cuda:
            t = t.pin_memory()
        buf.copy_(t, non_blocking=True)

    def _draw_inputs(self, it: int) -> None:
        """The host part's inputs of iteration ``it`` (gbdt.py:1735):
        the masks drawn on the host, in the reference's order, and the
        learning rate, written into the step's static buffers (outside
        any captured region). A change of ``shrinkage`` reaches the
        next replay through ``_lr_buf``."""
        m = self._host_bag_mask(it)
        if m is not None:
            self._put(self._bag_buf, m)
        fm = self._feature_mask()
        if fm is not None:
            self._put(self._fmask_buf, fm)
        self._lr_buf.fill_(float(self.shrinkage))
        self._it_buf.fill_(it)

    def _goss_on(self, it: int) -> bool:
        """GOSS samples from iteration int(1/learning_rate) on
        (goss.hpp; gbdt.py:1572-1585)."""
        return self._goss and it >= self._goss_start

    def _goss_impl(self, g, h, key):
        """GOSS mask and amplification (gbdt.py:862, goss.hpp Helper):
        keep the top ``top_rate`` rows by sum_k |g*h|, sample
        ``other_rate`` of the rest from ``uniform(key, (R,))``, amplify
        the sampled rows. The top set is the head of a stable
        descending sort, so among tied scores the lower row wins, as
        with ``lax.top_k``; padded rows score -inf and are never
        chosen."""
        cfg = self.config
        R = g.shape[1]
        n_real = self.train_dd.num_data
        real = self.train_dd.row_leaf0 >= 0
        score = torch.where(real, torch.abs(g * h).sum(dim=0),
                            float("-inf"))
        top_k = max(1, int(n_real * cfg.top_rate))
        other_k = max(1, int(n_real * cfg.other_rate))
        top_idx = torch.sort(score, descending=True,
                             stable=True).indices[:top_k]
        is_top = torch.zeros(R, dtype=torch.bool, device=g.device)
        is_top.index_fill_(0, top_idx, True)
        u = threefry.uniform(key, (R,))
        p_keep = other_k / max(1, n_real - top_k)
        sampled = ~is_top & real & (u < p_keep)
        amp = (1.0 - cfg.top_rate) / cfg.other_rate
        mask = is_top.to(torch.float32) + sampled.to(torch.float32)
        scale = torch.where(sampled, amp, 1.0) * mask
        return g * scale[None, :], h * scale[None, :], mask

    def _sample(self, g, h, goss: bool):
        """(g, h, in-bag count mask [R]): gbdt.py:1572-1587. The
        bagging mask crosses to the device as uint8 and is cast here."""
        if goss:
            return self._goss_impl(g, h, threefry.fold_in(self._goss_key,
                                                          self._it_buf))
        if self._bagging:
            m = self._bag_buf.to(torch.float32)
            return g * m, h * m, m
        return g, h, self._count_mask

    def _quantize_impl(self, g, h, key):
        """Stochastic rounding onto the int8 grid (gbdt.py:1353,
        gradient_discretizer.cpp:68-140): g, h [K, R] -> int8 grid
        values and per-class scales [K, 2] (g_scale, h_scale). The
        draws are made at [K, num_data] and padded with 0.5, as the
        JAX package draws them. The scales are the maxima over all R
        rows, the padded ones included, as the JAX package takes them
        over its padded layout (a padded row's gradient is the
        objective's at label 0 and the initial score)."""
        nb = int(self.config.num_grad_quant_bins)
        K, R = g.shape
        sharded = self.plan is not None and self.plan.rows_sharded
        if not sharded:
            ga = torch.abs(g).amax(dim=1, keepdim=True)
            ha = torch.abs(h).amax(dim=1, keepdim=True)
        else:
            # the serial run's maxima: over the global real rows, and
            # over the padded rows only where the serial layout of the
            # global rows pads (every rank holds a padded row, whose
            # gradient is the same on every rank)
            real = (self.train_dd.row_leaf0 >= 0)[None, :]
            amax = torch.stack([
                torch.where(real, torch.abs(v), 0.0).amax(1)
                for v in (g, h)] + [
                torch.where(real, 0.0, torch.abs(v)).amax(1)
                for v in (g, h)])
            amax = self.plan.comm.all_reduce(amax, "max", phase="quant")
            pads = self._serial_pads
            ga = (torch.maximum(amax[0], amax[2]) if pads
                  else amax[0])[:, None]
            ha = (torch.maximum(amax[1], amax[3]) if pads
                  else amax[1])[:, None]
        gs = torch.clamp_min(ga, 1e-30) / (nb // 2)
        hs = torch.clamp_min(ha, 1e-30) / nb
        n = min(self.train_dd.num_data, R)
        if bool(self.config.stochastic_rounding):
            def draws(salt):
                if sharded:
                    # the serial run's draws of the global rows, this
                    # rank's block of them
                    u = threefry.uniform(threefry.fold_in(key, salt),
                                         (K, self._n_global))
                    u = u[:, self._row_off:self._row_off + n]
                else:
                    u = threefry.uniform(threefry.fold_in(key, salt),
                                         (K, n))
                return torch.nn.functional.pad(u, (0, R - n), value=0.5)
            u1, u2 = draws(0), draws(1)
        else:
            u1 = u2 = torch.full_like(g, 0.5)
        # the int8 cast truncates toward zero; the random offset is
        # applied away from zero (gradient_discretizer.cpp:124-131)
        qg = torch.trunc(g / gs + torch.where(g >= 0, u1, -u1))
        qh = torch.trunc(h / hs + u2)
        return (qg.to(torch.int8), qh.to(torch.int8),
                torch.cat([gs, hs], dim=1))

    def _prep_custom_gh(self, gradients, hessians):
        """A custom objective's gradients and hessians -> [K, R] f32 on
        the device, padded rows 0 (gbdt.py:980-997). Each is flat
        [K * num_data], class-major (the LGBM_BoosterUpdateOneIterCustom
        layout), or [num_data, K]. Host arrays cross in one pinned copy;
        tensors move to the device as they are."""
        K, n, R = self.K, self.train_dd.num_data, self.train_dd.r_pad

        def kn(a):
            return a.reshape(K, n) if a.ndim == 1 else a.T
        if isinstance(gradients, torch.Tensor):
            return tuple(torch.nn.functional.pad(
                kn(a.to(self.device, torch.float32)), (0, R - n))
                for a in (gradients, hessians))
        both = np.zeros((2, K, R), np.float32)
        for i, a in enumerate((gradients, hessians)):
            both[i, :, :n] = kn(np.asarray(a, np.float32))
        t = torch.from_numpy(both)
        if self.device.type == "cuda":
            t = t.pin_memory()
        t = t.to(self.device, non_blocking=True)
        return t[0], t[1]

    def _prepare(self, scores, goss: bool, custom=None):
        """Gradients, sampling and quantization of one iteration:
        (g, h, count [R], quant), ``quant`` a :class:`_Quantized` for a
        quantized run, else None. ``custom`` is a custom objective's
        (g, h) [K, R], which takes the objective's place."""
        with phase(phases.GRADS):
            g, h = self._grads(scores) if custom is None else custom
        with phase(phases.SAMPLING):
            g, h, count = self._sample(g, h, goss)
            if not self._quant:
                return g, h, count, None
            qg, qh, qs = self._quantize_impl(
                g, h, threefry.fold_in(self._quant_key, self._it_buf))
            return g, h, count, _Quantized(qg, qh, qs,
                                           count.to(torch.int8))

    def _renew_leaf_impl(self, t: TreeArrays, row_leaf, g, h) -> TreeArrays:
        """RenewIntGradTreeOutput (gbdt.py:1394,
        gradient_discretizer.cpp:208-258): after a quantized build each
        leaf's output is recomputed from the float g and h sums of its
        rows (:func:`_leaf_sums`, deterministic on the card). Fields
        carry a leading class axis K; row_leaf, g and h are [K, R]."""
        sp = self.split_params
        K, L1 = t.leaf_values.shape
        dev = g.device
        sum_g = _leaf_sums(row_leaf, g, L1)
        sum_h = _leaf_sums(row_leaf, h, L1)
        # no path smoothing: the reference renews with USE_SMOOTHING=false
        out = calc_output(sum_g, sum_h, sp.lambda_l1, sp.lambda_l2,
                          sp.max_delta_step)
        live = ((torch.arange(L1, device=dev)[None, :]
                 < t.num_leaves[:, None]) & (sum_h > 0))
        leaf_values = torch.where(live, out, t.leaf_values)
        l2n = t.leaf2node.long()
        node_value = t.node_value.scatter(1, l2n, torch.where(
            live, leaf_values, torch.gather(t.node_value, 1, l2n)))
        return t._replace(leaf_values=leaf_values, node_value=node_value)

    def _tree_keys(self, k=0) -> Optional[torch.Tensor]:
        """The builder's threefry key of this iteration's class ``k``
        tree, ``fold_in(fold_in(tree_key, it), k)`` (gbdt.py:1027-1031),
        or with ``k`` a [K] tensor the [K, 2] keys of the class-batched
        build (``_class_batch_keys``, gbdt.py:1219-1228). The iteration
        is read on the device from ``_it_buf``; None when per-node
        sampling and extra-trees are off."""
        if self._tree_key is None:
            return None
        return threefry.fold_in(threefry.fold_in(self._tree_key,
                                                 self._it_buf), k)

    def _build_one_tree(self, gh: torch.Tensor, fmask: torch.Tensor,
                        batched: bool = False, quant_scales=None,
                        k: int = 0):
        """One tree from gh [R, 3] (class ``k``), or with ``batched``
        the K trees of an iteration from gh [K, R, 3] (gbdt.py:1230);
        int8 ``gh`` comes with ``quant_scales`` [2] (batched: [K, 2]).
        Intermediate and advanced monotone constraints and forced splits
        grow one split a round (gbdt.py:1058-1070); a CEGB build hands
        its state on to the next tree (gbdt.py:1085-1088)."""
        cfg = self.config
        if self.chunked:
            # out-of-core: stream the bin matrix through the chunked
            # builder (gbdt.py:1010-1020); its gate pinned every option
            # the resident kw below would add
            return self._chunked_builder.build(
                self._prefetcher, gh, self.train_dd.row_leaf0, fmask,
                quant_scales=quant_scales, gain_scale=self._gain_scale,
                valid_bins=tuple(dd.bins for dd in self.valid_dd),
                valid_row_leaf0=tuple(dd.row_leaf0 for dd in self.valid_dd))
        builder = build_tree_class_batched if batched else build_tree
        kw = {}
        if self._cat_sorted_mask is not None:
            kw.update(cat_sorted_mask=self._cat_sorted_mask,
                      max_sorted_bins=self._max_sorted_bins)
        if self._bundle_meta is not None:
            kw.update(bundle_meta=self._bundle_meta,
                      bundle_bins=self._bundle_bins)
        mono_method = (cfg.monotone_constraints_method
                       if self.mono_type_pf is not None else "basic")
        leaf_batch = cfg.leaf_batch
        if mono_method in ("intermediate", "advanced"):
            leaf_batch = 1
        if self._forced_splits is not None:
            kw["forced"] = self._forced_splits
            leaf_batch = 1
        if self._cegb is not None:
            kw["cegb"] = (*self._cegb, self._cegb_feat_used,
                          self._cegb_used_rows)
        if self.plan is not None:
            kw.update(self.plan.builder_kwargs())
        keys = self._tree_keys(
            torch.arange(self.K, device=self.device) if batched else k)
        out = builder(
            self.train_dd.bins, gh, self.train_dd.row_leaf0,
            self.num_bins_pf, self.nan_bin_pf, self.is_cat_pf, fmask,
            num_leaves=cfg.num_leaves, leaf_batch=leaf_batch,
            max_depth=cfg.max_depth, num_bins=self.B,
            split_params=self.split_params, hist_dtype=cfg.hist_dtype,
            valid_bins=tuple(dd.bins for dd in self.valid_dd),
            valid_row_leaf0=tuple(dd.row_leaf0 for dd in self.valid_dd),
            mono_type_pf=self.mono_type_pf, hist_sub=self._hist_sub,
            fused_split=self.fused_split_ok, has_cat=self._has_cat,
            quant_scales=quant_scales,
            interaction_groups=self.interaction_groups, rng_key=keys,
            feature_fraction_bynode=self._ffbn, gain_scale=self._gain_scale,
            mono_method=mono_method, **kw)
        if "cegb" in kw:
            *out, (self._cegb_feat_used, self._cegb_used_rows) = out
        return tuple(out)

    def _build_update(self, g, h, count, fmask, lr, quant=None):
        """The K trees of an iteration and the scores they give: returns
        (trees with a leading K axis, grew [K], new train scores [K, R],
        new valid scores), all new tensors; ``lr`` is a float or a 0-d
        device tensor (one f32 product either way). ``quant`` is
        ``_prepare``'s: the trees then grow from the int8 grid, and with
        ``quant_train_renew_leaf`` their leaves are renewed from the
        float g and h."""
        if self.class_batch_ok:
            # one build for all K classes (gbdt.py:1596-1631): per-class
            # rows are independent, so the batched where() equals the
            # sequential per-class updates
            if quant is None:
                gh_k, qs = self._stack_gh_k(g, h, count), None
            else:
                gh_k = self._stack_gh_k(quant.g, quant.h, quant.count)
                qs = quant.scales
            with phase(phases.BUILD):
                trees, row_leaf_k, valid_rls_k = self._build_one_tree(
                    gh_k, fmask, batched=True, quant_scales=qs)
                if self._renew:
                    trees = self._renew_leaf_impl(trees, row_leaf_k, g, h)
            grew = trees.num_leaves > 1                      # [K]
            with phase(phases.UPDATE):
                scores = torch.where(grew[:, None], self._update_score_impl(
                    self.scores, trees.leaf_values, row_leaf_k, lr),
                    self.scores)
                valid = [torch.where(grew[:, None], self._update_score_impl(
                    vs, trees.leaf_values, vrl_k, lr), vs)
                    for vs, vrl_k in zip(self.valid_scores, valid_rls_k)]
            return trees, grew, scores, valid
        # the per-class loop (gbdt.py:1632-1665)
        per_class, rows = [], []
        vrows = [[] for _ in self.valid_scores]
        for k in range(self.K):
            if quant is None:
                gh, qs = torch.stack([g[k], h[k], count], dim=1), None
            else:
                gh = torch.stack([quant.g[k], quant.h[k], quant.count],
                                 dim=1)
                qs = quant.scales[k]
            with phase(phases.BUILD):
                tree, row_leaf, valid_rls = self._build_one_tree(
                    gh, fmask, quant_scales=qs, k=k)
                if self._renew:
                    tree = TreeArrays(*(f[0] for f in self._renew_leaf_impl(
                        TreeArrays(*(f[None] for f in tree)), row_leaf[None],
                        g[k][None], h[k][None])))
            grew_k = tree.num_leaves > 1
            with phase(phases.UPDATE):
                rows.append(torch.where(grew_k, self._update_score_impl(
                    self.scores[k], tree.leaf_values, row_leaf, lr),
                    self.scores[k]))
                for vi, vrl in enumerate(valid_rls):
                    vs = self.valid_scores[vi][k]
                    vrows[vi].append(torch.where(
                        grew_k, self._update_score_impl(
                            vs, tree.leaf_values, vrl, lr), vs))
            per_class.append(tree)
        trees = TreeArrays(*(torch.stack(f) for f in zip(*per_class)))
        return (trees, trees.num_leaves > 1, torch.stack(rows),
                [torch.stack(r) for r in vrows])

    def _flatten(self, trees: TreeArrays, grew, finite) -> torch.Tensor:
        """An iteration's trees, grew [K] and finite flag as ONE flat
        f64 tensor (ints, bools and the uint32 bitset words are exact in
        f64); the layout is recorded once for :meth:`sync`."""
        fields = (*trees, grew, finite)
        if self._layout is None:
            self._layout = [(tuple(f.shape), f.dtype) for f in fields]
        return torch.cat([f.reshape(-1).to(torch.float64) for f in fields])

    def _step_impl(self, goss: bool = False) -> None:
        """The step body (``_fused_step_impl``, gbdt.py:1554) over the
        static buffers: reads the scores, the bagging and feature masks,
        the learning rate and the iteration number; writes the new
        scores and the flat output in place. ``goss`` (fixed per
        graph) says whether GOSS samples. The finite flag covers g and
        h, then the new scores (gbdt.py:1593, :1629, :1664). On CUDA
        this is what the graph holds: it allocates only its own
        temporaries, and reads no device value on the host. There its
        phase spans open only when the body runs (iteration 0 and the
        capture), as the JAX fused step's run only at trace time: a
        replayed iteration records none."""
        g, h, count, quant = self._prepare(self.scores, goss)
        finite = torch.isfinite(g).all() & torch.isfinite(h).all()
        trees, grew, scores, valid = self._build_update(
            g, h, count, self._fmask_buf, self._lr_buf, quant)
        finite = finite & torch.isfinite(scores).all()
        # in place, never rebound: a replay writes these buffers
        self.scores.copy_(scores)
        for dst, src in zip(self.valid_scores, valid):
            dst.copy_(src)
        flat = self._flatten(trees, grew, finite)
        if self._step_out is None:      # iteration 0, outside any graph
            self._step_out = torch.empty_like(flat)
        self._step_out.copy_(flat)

    def _capture(self, goss: bool) -> None:
        """Record the step body into a CUDA graph, once per GOSS phase,
        after the phase's first iteration ran it eagerly (the library is
        loaded and the static output allocated). ``torch.cuda.graph``
        captures on a side stream; the capture runs no kernel. A failed
        capture raises: there is no eager fallback. Python's cyclic
        collector is off for the capture: a dead reference cycle that
        holds another step's CUDA graph (an older booster) would destroy
        that graph mid-capture, and ``cudaGraphExecDestroy`` is illegal
        while a stream captures, so this capture would fail. The capture
        is thread-local: another thread of the process (the telemetry
        server starting or stopping a profiler, a prefetch worker) may
        make a CUDA call that is illegal during a capture, and in the
        default global mode that call would invalidate this one."""
        t0 = time.perf_counter()
        graph = torch.cuda.CUDAGraph()
        collecting = gc.isenabled()
        gc.disable()
        try:
            with CH.captured_launches() as recorded:
                with torch.cuda.graph(graph,
                                      capture_error_mode="thread_local"):
                    self._step_impl(goss)
        finally:
            if collecting:
                gc.enable()
        self._graphs[goss] = (graph, recorded)
        self._graph, self._graph_launches = graph, recorded
        self.capture_count += 1
        self.capture_seconds = ((self.capture_seconds or 0.0)
                                + time.perf_counter() - t0)

    def _step_dispatch(self) -> None:
        """The step's host part (``_fused_dispatch``, gbdt.py:1724):
        draw the inputs, replay the graph of this iteration's GOSS
        phase (or run the body and capture it), and clone the static
        output into the ring. Without the clone every pending entry
        would alias the last replay's output."""
        it = self.iter_
        goss = self._goss_on(it)
        self._draw_inputs(it)
        if goss in self._graphs:
            self._graph, self._graph_launches = self._graphs[goss]
            self._graph.replay()
            CH.count_replay(self._graph_launches)
        else:
            self._step_impl(goss)
            if self.device.type == "cuda":
                self._capture(goss)
        self._pending.append((it, float(self.shrinkage),
                              self._step_out.clone()))
        self.iter_ += 1

    def _train_one_iter_eager(self, custom=None) -> bool:
        """The eager loop (``fused_train=false``; the reference's legacy
        loop, gbdt.py:1919): the step's arithmetic op by op from the
        host, writing the score tensors in place (a captured step reads
        these buffers when custom gradients come between its replays).
        ``custom`` is a custom objective's (g, h). With the NaN guard
        armed it drains the ring and checks g and h before the build
        (gbdt.py:1929), a host sync. True when that drain found the
        no-split stop."""
        if self._linear:
            return self._train_one_iter_linear(custom)
        it = self.iter_
        guard = self._nan_guard != "off"
        if guard and self.sync():
            return True
        self._draw_inputs(it)
        g, h, count, quant = self._prepare(self.scores, self._goss_on(it),
                                           custom)
        if guard:
            self.host_sync_count += 1
            fin = torch.isfinite(g).all() & torch.isfinite(h).all()
            if self.plan is not None:
                # every rank stops together, or none
                fin = self.plan.comm.all_reduce(fin.reshape(1), "min",
                                                phase="nan_guard")[0]
            if not bool(fin):
                raise NumericDivergenceError(it)
        lr = float(self.shrinkage)
        trees, grew, scores, valid = self._build_update(
            g, h, count, self._fmask_buf, lr, quant)
        self.scores.copy_(scores)
        for dst, src in zip(self.valid_scores, valid):
            dst.copy_(src)
        if self.keep_device_trees:
            for k in range(self.K):
                ta = TreeArrays(*(f[k] for f in trees))
                bias = self._init_scores[k]
                if it == 0 and abs(bias) > kEpsilon:
                    ta = self._bias_adjust_device(ta, bias, lr)
                self.device_trees.append((ta, lr))
        self._pending.append((it, lr, self._flatten(trees, grew,
                                                     self._true)))
        self.iter_ += 1
        return False

    def _train_one_iter_linear(self, custom=None) -> bool:
        """One iteration of a linear-tree run (gbdt.py:1939-2044): per
        class, build the tree, bring it to the host (a sync a tree, as in
        the JAX package), fit its leaves (:meth:`_fit_linear_leaves`) and
        add its per-row linear outputs to the train and valid scores.
        The first tree carries the init score in ``leaf_const`` too
        (AddBias). True when no class split: the iteration is dropped
        (gbdt.cpp:441-447)."""
        it = self.iter_
        self._draw_inputs(it)
        g, h, count, quant = self._prepare(self.scores, self._goss_on(it),
                                           custom)
        if self._nan_guard != "off":
            self.host_sync_count += 1
            if not bool(torch.isfinite(g).all() & torch.isfinite(h).all()):
                raise NumericDivergenceError(it)
        lr = float(self.shrinkage)
        bm, uf = self.train_set.bin_mappers, self.train_set.used_features
        grew = False
        for k in range(self.K):
            if quant is None:
                gh, qs = torch.stack([g[k], h[k], count], dim=1), None
            else:
                gh = torch.stack([quant.g[k], quant.h[k], quant.count],
                                 dim=1)
                qs = quant.scales[k]
            with phase(phases.BUILD):
                ta, row_leaf, valid_rls = self._build_one_tree(
                    gh, self._fmask_buf, quant_scales=qs, k=k)
                if self._renew:
                    ta = TreeArrays(*(f[0] for f in self._renew_leaf_impl(
                        TreeArrays(*(f[None] for f in ta)), row_leaf[None],
                        g[k][None], h[k][None])))
            self.host_sync_count += 1
            tree = Tree.from_device(TreeArrays(*(f.cpu().numpy()
                                                 for f in ta)), bm, uf, lr)
            if tree.num_leaves > 1:
                grew = True
                self._fit_linear_leaves(tree, row_leaf, g[k], h[k], lr)
                with phase(phases.UPDATE):
                    self.scores[k] += self._linear_delta(
                        tree, self.train_set.raw_values, row_leaf,
                        self.train_dd.r_pad)
                    for vs, v, vrl, dd in zip(self.valid_scores,
                                              self.valid_sets, valid_rls,
                                              self.valid_dd):
                        vs[k] += self._linear_delta(tree, v.raw_values,
                                                    vrl, dd.r_pad)
            bias = self._init_scores[k]
            if it == 0 and abs(bias) > kEpsilon:
                tree.leaf_value += bias
                tree.internal_value += bias
                if tree.is_linear:
                    tree.leaf_const += bias
            self.models.append(tree)
        if not grew and it > 0:
            del self.models[-self.K:]
            return True
        self.iter_ += 1
        return False

    def _fit_linear_leaves(self, tree: Tree, row_leaf: torch.Tensor,
                           g: torch.Tensor, h: torch.Tensor,
                           shrink: float) -> None:
        """Per-leaf ridge fits on raw feature values (gbdt.py:1423,
        LinearTreeLearner::CalculateLinear): each leaf regresses -g on
        the raw values of the features along its path, weighted by h,
        with ridge ``linear_lambda`` on the feature diagonal, over its
        rows without a NaN in those features. The sums run on the device
        in float64 over each leaf's rows in row order (a stable sort of
        ``row_leaf``); the (d+1)^2 systems are solved in one batch, each
        padded to the widest by an identity block, which leaves its
        solution as it is. A leaf keeps its constant with fewer clean
        rows than d + 1, or a singular or non-finite solve (the JAX
        package's LinAlgError); coefficients of |beta| <= 1e-35 drop."""
        raw = self.train_set.raw_values
        n = self.train_set.num_data
        lam = float(self.config.linear_lambda)
        nl = tree.num_leaves
        paths = _leaf_paths(tree)
        tree.is_linear = True
        tree.leaf_const = np.asarray(tree.leaf_value, np.float64).copy()
        tree.leaf_features = [[] for _ in range(nl)]
        tree.leaf_coeff = [[] for _ in range(nl)]
        rl = row_leaf[:n].long()
        order = torch.sort(rl, stable=True).indices
        cnt = torch.bincount(rl + 1, minlength=nl + 1).cpu().numpy()
        # leaf s's rows are order[start[s]:start[s + 1]] (dead rows first)
        start = np.cumsum(cnt)
        fit = [s for s in range(nl) if paths[s] and cnt[s + 1] > 0]
        if not fit:
            return
        dev = raw.device
        f64 = torch.float64
        D = max(len(paths[s]) for s in fit)
        A = torch.eye(D + 1, dtype=f64, device=dev).repeat(len(fit), 1, 1)
        b = torch.zeros((len(fit), D + 1), dtype=f64, device=dev)
        n_ok = []
        g64, h64 = g[:n].to(f64), h[:n].to(f64)
        for i, s in enumerate(fit):
            feats = paths[s]
            d = len(feats)
            rows = order[start[s]:start[s + 1]]
            fidx = torch.tensor(feats, dtype=torch.int64, device=dev)
            vals = raw[rows[:, None], fidx[None, :]].to(f64)
            ok = ~torch.isnan(vals).any(dim=1)
            rk = rows[ok]
            X = torch.cat([vals[ok], torch.ones((rk.shape[0], 1),
                                                dtype=f64, device=dev)], 1)
            As = (X * h64[rk][:, None]).T @ X
            As[range(d), range(d)] += lam
            A[i, :d + 1, :d + 1] = As
            b[i, :d + 1] = X.T @ g64[rk]
            n_ok.append(rk.shape[0])
        sol, info = torch.linalg.solve_ex(A, b)
        beta = (-sol).cpu().numpy()
        info = info.cpu().numpy()
        for i, s in enumerate(fit):
            feats = paths[s]
            d = len(feats)
            bs = beta[i, :d + 1]
            if n_ok[i] < d + 1 or info[i] != 0 or not np.isfinite(bs).all():
                continue
            keep = np.abs(bs[:d]) > 1e-35          # kZeroThreshold
            tree.leaf_features[s] = [feats[j] for j in range(d) if keep[j]]
            tree.leaf_coeff[s] = [float(bs[j] * shrink) for j in range(d)
                                  if keep[j]]
            tree.leaf_const[s] = float(bs[d] * shrink)

    def _linear_delta(self, tree: Tree, raw: torch.Tensor,
                      row_leaf: torch.Tensor, r_pad: int) -> torch.Tensor:
        """[r_pad] float32 per-row (shrunk) outputs of a linear tree over
        the rows of ``raw`` in leaves ``row_leaf`` (gbdt.py:1483): float64
        arithmetic, rounded to float32; padded and dead rows add 0."""
        n = raw.shape[0]
        dev = raw.device
        _, lconst, lfeat, lcoef, _ = linear_tables([tree], tree.num_leaves)
        tabs = [torch.from_numpy(a).to(dev) for a in (
            np.asarray(tree.leaf_value, np.float64)[None], lconst, lfeat,
            lcoef)]
        rl = row_leaf[:n].long()
        out = linear_outputs(raw, rl.clamp(min=0)[:, None], *tabs)[:, 0]
        out = torch.where(rl >= 0, out, 0.0).to(torch.float32)
        return torch.nn.functional.pad(out, (0, r_pad - n))

    def _replay_linear(self, tree: Tree, raw: torch.Tensor,
                       r_pad: int) -> torch.Tensor:
        """[r_pad] float32 outputs of a linear tree walked over raw
        values (rollback's replay, gbdt.py:2079-2085: the binned walk
        cannot give the per-row linear outputs)."""
        ens = pack_ensemble([tree], raw.device)
        out = torch.zeros(r_pad, dtype=torch.float32, device=raw.device)
        step = 1 << 18
        for r0 in range(0, raw.shape[0], step):
            xr = raw[r0:r0 + step].to(torch.float64)
            out[r0:r0 + xr.shape[0]] = walk(ens, xr)[:, 0].to(torch.float32)
        return out

    def train_one_iter(self, gradients=None, hessians=None, *,
                       defer: bool = False):
        """One boosting iteration: gradients -> K trees -> score
        updates, all on the device, through the step (or the eager loop
        when ``fused_train_reason`` says so). ``defer=True`` leaves the
        trees pending (no host sync) until :meth:`sync`; otherwise syncs
        and returns True when training must stop (no class could
        split). Custom ``gradients``/``hessians`` (gbdt.py:1825) drain
        the ring first and run the eager loop, and sync either way."""
        if (gradients is None) != (hessians is None):
            raise ValueError("custom gradients need both gradients "
                             "and hessians")
        self._maybe_chaos_poison()
        try:
            self._maybe_chaos_devloss()
            if gradients is not None:
                if self.sync() or self._train_one_iter_eager(
                        self._prep_custom_gh(gradients, hessians)):
                    return True
                return self.sync()
            if self.fused_train_ok:
                self._step_dispatch()
            elif self._train_one_iter_eager():
                return True
        except RuntimeError as e:
            # a CUDA runtime error escaping the step is device loss, not
            # a fault of the program: typed, so that
            # on_device_loss=degrade can restore and retry
            loss = _device_loss(self.iter_, e)
            if loss is None:
                raise
            raise loss from e
        if defer:
            return None
        return self.sync()

    def _maybe_chaos_poison(self) -> None:
        """Fault-injection hook (gbdt.py:1861-1882): with
        LIGHTGBM_TPU_CHAOS_POISON_ITER set, write NaN into one score, in
        place, before that iteration runs; the NaN reaches the gradients
        and the divergence guard must catch it. A marker file
        (LIGHTGBM_TPU_CHAOS_POISON_ONCE) makes the fault transient, so a
        rollback's re-run succeeds. Two environment reads otherwise."""
        it_s = os.environ.get("LIGHTGBM_TPU_CHAOS_POISON_ITER")
        if it_s is None or self.iter_ != int(it_s):
            return
        marker = os.environ.get("LIGHTGBM_TPU_CHAOS_POISON_ONCE")
        if marker:
            if os.path.exists(marker):
                return
            with open(marker, "w") as f:
                f.write("poisoned\n")
        self.scores[0, 0:1].fill_(float("nan"))

    def _maybe_chaos_devloss(self) -> None:
        """Fault-injection hook (gbdt.py:1884-1910): with
        LIGHTGBM_TPU_CHAOS_DEVLOSS_ITER set, raise the error a lost
        device raises (``torch.AcceleratorError``, a CUDA error) at that
        iteration, through the same classification a real one takes.
        LIGHTGBM_TPU_CHAOS_DEVLOSS_ONCE (a marker file) makes it
        transient. The JAX package's ``_DEVLOSS_MODE=mesh`` fires only
        under a parallel plan, which the port has not: it never fires
        here."""
        it_s = os.environ.get("LIGHTGBM_TPU_CHAOS_DEVLOSS_ITER")
        if it_s is None or self.iter_ != int(it_s):
            return
        if os.environ.get("LIGHTGBM_TPU_CHAOS_DEVLOSS_MODE") == "mesh":
            return
        marker = os.environ.get("LIGHTGBM_TPU_CHAOS_DEVLOSS_ONCE")
        if marker:
            if os.path.exists(marker):
                return
            with open(marker, "w") as f:
                f.write("device lost\n")
        err = getattr(torch, "AcceleratorError", RuntimeError)
        raise err("CUDA error: chaos: injected device loss")

    def sync(self) -> bool:
        """Materialize every pending iteration's K trees with ONE
        device-to-host transfer and run the deferred checks
        (gbdt.py:1762): with ``nan_guard`` armed, a false finite flag
        raises :class:`NumericDivergenceError` BEFORE the no-split check
        (NaN gradients build no-split trees, which would read as a clean
        stop) and rewinds ``iter_`` to the last good iteration. Returns
        True when an iteration in which no class grew was found: it and
        everything dispatched after it are dropped (their score updates
        were device no-ops). A class that did not grow in a kept
        iteration keeps its one-leaf tree."""
        if not self._pending:
            return False
        pending, self._pending = self._pending, []
        try:
            host = torch.cat([flat for (_, _, flat) in pending]
                             ).cpu().numpy()
        except RuntimeError as e:
            # an error of the queued work surfaces at the ring's drain
            loss = _device_loss(pending[0][0], e)
            if loss is None:
                raise
            raise loss from e
        self.host_sync_count += 1
        per = host.size // len(pending)
        bm = self.train_set.bin_mappers
        uf = self.train_set.used_features
        stop = False
        kept = 0
        for i, (it, shrink, _) in enumerate(pending):
            arrs, off = [], i * per
            for shape, dt in self._layout:
                n = int(np.prod(shape))
                arrs.append(host[off:off + n].reshape(shape)
                            .astype(_NP_DTYPES[dt]))
                off += n
            *tree_f, grew, finite = arrs
            if self._nan_guard != "off" and not bool(finite):
                self.iter_ = pending[0][0] + kept
                raise NumericDivergenceError(it)
            if not bool(grew.any()) and it > 0:
                stop = True
                break
            for k in range(self.K):
                tree = Tree.from_device(TreeArrays(*(a[k] for a in tree_f)),
                                        bm, uf, shrink)
                bias = self._init_scores[k]
                if it == 0 and abs(bias) > kEpsilon:
                    # AddBias (gbdt.cpp:416): fold each class's init
                    # score into its first tree (gbdt.py:1812-1819)
                    tree.leaf_value += bias
                    tree.internal_value += bias
                self.models.append(tree)
            kept += 1
        self.iter_ = pending[0][0] + kept
        if self.keep_device_trees and kept < len(pending):
            # the dropped iterations' device trees (the eager loop,
            # which alone keeps them, syncs every iteration)
            del self.device_trees[-(len(pending) - kept) * self.K:]
        return stop

    # ------------------------------------------------------------------
    @staticmethod
    def _bias_adjust_device(tree_arrays: TreeArrays, bias: float,
                            shrink: float) -> TreeArrays:
        """Fold an output bias into a stored device tree so that
        weight * node_value includes it (AddBias; gbdt.py:1503)."""
        adj = float(np.float32(bias / shrink))
        return tree_arrays._replace(
            node_value=tree_arrays.node_value + adj,
            leaf_values=tree_arrays.leaf_values + adj)

    def predict_device_tree(self, idx: int, which: int = -1
                            ) -> torch.Tensor:
        """[R] unshrunk per-row output of stored tree ``idx`` on the
        train (which=-1) or a valid set's binned rows (gbdt.py:2047),
        walked for the tree's own depth."""
        tree_arrays, _ = self.device_trees[idx]
        dd = self.train_dd if which < 0 else self.valid_dd[which]
        return predict_bins_value(tree_arrays, self.nan_bin_pf, dd.bins,
                                  _tree_depth(self.models[idx]),
                                  bundle_meta=self._bundle_meta,
                                  num_bins_pf=self.num_bins_pf)

    def _replay_host(self, tree: Tree, dd: _DeviceData) -> torch.Tensor:
        """[R] f32 output of a host tree over ``dd``'s binned rows,
        padded rows included (Tree.predict_binned: the builder's
        threshold_bin decisions)."""
        bins = self.train_set.feature_bins_of(dd.bins)
        pred = tree.predict_binned(bins, self.train_set.used_features,
                                   self.nan_bin_pf.cpu().numpy())
        return torch.from_numpy(np.asarray(pred, np.float32)).to(self.device)

    def rollback_one_iter(self) -> None:
        """RollbackOneIter (gbdt.cpp:454; gbdt.py:2058): subtract the
        newest iteration's trees from every score, in place (the step's
        graph reads these buffers), and drop them."""
        self.sync()
        if self.iter_ <= 0:
            return
        if self.chunked:
            raise NotImplementedError(
                "rollback_one_iter replays trees over the resident "
                "binned matrix, which out-of-core chunked training "
                "never materializes")
        for k in range(self.K):
            tree = self.models[-(self.K - k)]
            if tree.is_linear:
                self.scores[k] += -self._replay_linear(
                    tree, self.train_set.raw_values, self.train_dd.r_pad)
                for vs, v, dd in zip(self.valid_scores, self.valid_sets,
                                     self.valid_dd):
                    vs[k] += -self._replay_linear(tree, v.raw_values,
                                                  dd.r_pad)
                continue
            self.scores[k] += -self._replay_host(tree, self.train_dd)
            for vs, dd in zip(self.valid_scores, self.valid_dd):
                vs[k] += -self._replay_host(tree, dd)
        del self.models[-self.K:]
        if self.keep_device_trees:
            del self.device_trees[-self.K:]
        self.iter_ -= 1

    # ------------------------------------------------------------------
    # full-state checkpoints (resilience/checkpoint.py)
    # ------------------------------------------------------------------
    def training_state(self):
        """The mutable training state of a bit-identical resume, in the
        JAX package's keys (gbdt.py:2108): the iteration, the two host
        RandomState streams, the score buffers and the bagging mask
        (float32, as the JAX package holds it). Drains the pending ring
        first, so ``iter_`` equals the trees and the host draws made.
        The threefry draws (GOSS, quantization, per-node sampling) are
        ``fold_in`` keys of the iteration number: nothing to capture."""
        if self.plan is not None:
            raise NotImplementedError(
                "full-state checkpoints of a parallel run (each rank "
                "holds its own rows and scores) wait for elastic resume "
                "(ROADMAP A)")
        self.sync()
        if self.keep_device_trees:
            raise NotImplementedError(
                "full-state checkpoints do not capture per-tree device "
                "state (boosting=dart/goss with kept device trees); "
                "disable resume for this boosting mode")
        from ..resilience.checkpoint import _rng_state_to_json
        state = {
            "iter": int(self.iter_),
            "rng_bagging": _rng_state_to_json(
                self._rng_bagging.get_state()),
            "rng_feature": _rng_state_to_json(
                self._rng_feature.get_state()),
            "has_bag_mask": bool(self._bagging and self._bag_drawn),
            "num_data": int(self.train_dd.num_data),
            "valid_num_data": [int(dd.num_data) for dd in self.valid_dd],
        }
        self.host_sync_count += 1
        arrays = {"scores": self.scores.cpu().numpy()}
        for vi, vs in enumerate(self.valid_scores):
            arrays[f"valid_scores_{vi}"] = vs.cpu().numpy()
        if state["has_bag_mask"]:
            arrays["bag_mask"] = self._bag_buf.to(
                torch.float32).cpu().numpy()
        return state, arrays

    def load_training_state(self, state: dict, arrays: dict,
                            trees: List[Tree]) -> None:
        """Restore a :meth:`training_state` capture, the port's or the
        JAX package's (gbdt.py:2148). Trees replace ``models`` in place
        (the Booster aliases the list). The scores and the bagging mask
        are copied INTO the step's own buffers and the pending ring is
        cleared: a captured CUDA graph replays those very buffers, so
        rebinding them would replay the pre-restore state. A capture's
        padding depends on the package that wrote it (the JAX package
        pads to its row block, the port to 256 rows or its chunk
        lattice); padded rows never change from their initial values,
        so the saved real rows are kept and the padding is this
        instance's own."""
        from ..resilience.checkpoint import _rng_state_from_json
        self._pending.clear()
        self.models[:] = trees
        self.iter_ = int(state["iter"])
        self._rng_bagging.set_state(
            _rng_state_from_json(state["rng_bagging"]))
        self._rng_feature.set_state(
            _rng_state_from_json(state["rng_feature"]))
        n = int(self.train_dd.num_data)
        rec_n = state.get("num_data")
        if rec_n is not None and int(rec_n) != n:
            raise ValueError(
                f"checkpoint was written for {rec_n} training rows, "
                f"this run has {n}: same config fingerprint but a "
                "different dataset")

        def restore_into(buf: torch.Tensor, saved, rows: int) -> None:
            saved = np.asarray(saved, np.float32)
            merged = buf.cpu().numpy().copy()
            merged[..., :rows] = saved[..., :rows]
            buf.copy_(torch.from_numpy(merged))

        restore_into(self.scores, arrays["scores"], n)
        for vi, (vs, dd) in enumerate(zip(self.valid_scores,
                                          self.valid_dd)):
            restore_into(vs, arrays[f"valid_scores_{vi}"], dd.num_data)
        if state.get("has_bag_mask") and "bag_mask" in arrays \
                and self._bag_buf is not None:
            m = np.zeros(self.train_dd.r_pad, np.uint8)
            m[:n] = np.asarray(arrays["bag_mask"])[:n] != 0
            self._bag_buf.copy_(torch.from_numpy(m))
            self._bag_drawn = True
        else:
            self._bag_drawn = False

    # ------------------------------------------------------------------
    def get_training_scores(self) -> np.ndarray:
        """[num_data, K] scores handed to a custom objective
        (GetTrainingScore, gbdt.py:2249; DART drops its trees first)."""
        return self.eval_scores(-1)

    def eval_scores(self, which: int = -1) -> np.ndarray:
        """[num_data, K] raw scores of the train (-1) or a valid set;
        under a row-sharded plan those of the global rows, every rank's
        block in rank order, so that every rank evaluates every metric
        over the same rows."""
        if which < 0:
            s, n = self.scores, self.train_dd.num_data
        else:
            s, n = self.valid_scores[which], self.valid_dd[which].num_data
        self.host_sync_count += 1
        return self.global_rows(s[:, :n].T.cpu().numpy().astype(np.float64))

    def current_iteration(self) -> int:
        return self.iter_
