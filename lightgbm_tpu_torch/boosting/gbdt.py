"""GBDT training loop on the device.

Port of ``lightgbm_tpu/boosting/gbdt.py`` restricted to this slice's
path (the reference's ``gbdt.cpp`` Train/TrainOneIter/BoostFromAverage/
UpdateScore):

- ``_DeviceData``: the binned matrix, padded to a row multiple, with the
  root ``row_leaf`` (0 live, -1 padded);
- ``boost_from_average`` init scores, folded into the first tree
  (AddBias, gbdt.cpp:416);
- per iteration, the arithmetic of ``_fused_step_impl``
  (``gbdt.py:1554``): gradients -> tree builds -> score updates (only
  for the classes whose tree grew), run eagerly op by op on the device.
  Scores are [K, R] (K = models per iteration). With K > 1 the
  class-batched build (``_class_batch_reason``, ``gbdt.py:1181``) grows
  all K trees in one build: one B3 launch for the K roots, then one B2
  (or B1) launch per round for all classes; ``class_batch=off`` keeps
  the per-class loop (``gbdt.py:1632-1665``). Built trees stay on the
  device in a pending ring; :meth:`GBDT.sync` moves every pending tree
  to the host in ONE transfer and runs the deferred no-split stop
  check, so iterations between eval points cost no host sync;
- ``_fused_split_reason``: the configuration reasons of
  ``gbdt.py:1141-1168``. On CUDA ``fused_split=auto|on`` launches kernel
  B2 and ``off`` kernel B1; there is no probe and no quiet fallback.

Boosting features the port has not reached raise ``NotImplementedError``
at construction (ROADMAP A): bagging, GOSS, quantized gradients, EFB,
parallel learners, linear trees, CEGB, forced splits, interaction
constraints, per-node sampling, extra-trees and sorted-subset
categoricals.
"""

from __future__ import annotations

import os
from typing import List, Optional, Sequence

import numpy as np
import torch

from ..config import Config
from ..dataset import Dataset, check_device_capacity
from ..objectives import Objective
from ..ops.split import SplitParams
from ..tree import Tree
from .tree_builder import TreeArrays, build_tree, build_tree_class_batched

__all__ = ["GBDT"]

kEpsilon = 1e-15
_ROW_BLOCK = 256
_NP_DTYPES = {torch.bool: np.bool_, torch.int32: np.int32,
              torch.int64: np.int64, torch.float32: np.float32}


class _DeviceData:
    """Device-resident binned matrix + root partition of one dataset."""

    def __init__(self, ds: Dataset, block: int = _ROW_BLOCK):
        self.num_data = ds.num_data
        self.r_pad = -(-ds.num_data // block) * block
        bins = ds.bins
        pad = self.r_pad - ds.num_data
        if pad:
            bins = torch.cat([bins, torch.zeros(
                (pad, bins.shape[1]), dtype=bins.dtype, device=bins.device)])
        self.bins = bins.contiguous()
        rl0 = torch.zeros(self.r_pad, dtype=torch.int32, device=bins.device)
        rl0[ds.num_data:] = -1
        self.row_leaf0 = rl0


def _pad_rows(a: np.ndarray, n: int) -> np.ndarray:
    return np.pad(a, (0, n - a.shape[0])) if a.shape[0] != n else a


def _unsupported(cfg: Config, train_set: Dataset) -> List[str]:
    """Configuration the port cannot train yet (ROADMAP A)."""
    out = []
    if cfg.boosting != "gbdt":
        out.append(f"boosting={cfg.boosting}")
    if cfg.data_sample_strategy == "goss":
        out.append("GOSS")
    if cfg.bagging_freq > 0 and (cfg.bagging_fraction < 1.0
                                 or cfg.pos_bagging_fraction < 1.0
                                 or cfg.neg_bagging_fraction < 1.0):
        out.append("bagging")
    checks = [
        (cfg.use_quantized_grad, "use_quantized_grad"),
        (cfg.linear_tree, "linear_tree"),
        (cfg.extra_trees, "extra_trees"),
        (cfg.feature_fraction_bynode < 1.0, "feature_fraction_bynode"),
        (bool(cfg.interaction_constraints), "interaction_constraints"),
        (bool(cfg.forcedsplits_filename), "forced splits"),
        (bool(cfg.feature_contri), "feature_contri"),
        (cfg.cegb_tradeoff < 1.0 or cfg.cegb_penalty_split > 0.0
         or bool(cfg.cegb_penalty_feature_coupled)
         or bool(cfg.cegb_penalty_feature_lazy), "CEGB"),
        (cfg.tree_learner not in ("auto", "serial"),
         f"tree_learner={cfg.tree_learner}"),
        (cfg.num_machines > 1, "num_machines > 1"),
    ]
    out += [name for cond, name in checks if cond]
    if cfg.monotone_constraints and \
            cfg.monotone_constraints_method != "basic":
        out.append("monotone_constraints_method="
                   + cfg.monotone_constraints_method)
    cat = train_set.per_feature_is_categorical()
    nb = train_set.per_feature_num_bins()
    if (cat & (nb > int(cfg.max_cat_to_onehot))).any():
        out.append("sorted-subset categorical splits")
    return out


class GBDT:
    def __init__(self, config: Config, train_set: Dataset,
                 objective: Optional[Objective],
                 valid_sets: Sequence[Dataset] = ()):
        self.config = config
        self.train_set = train_set.construct()
        self.device = self.train_set.device
        if objective is None:
            raise NotImplementedError("custom objectives are not ported "
                                      "yet (ROADMAP A)")
        bad = _unsupported(config, self.train_set)
        if bad:
            raise NotImplementedError(
                "not ported to lightgbm_tpu_torch yet (ROADMAP A): "
                + ", ".join(bad))
        self.objective = objective
        self.iter_ = 0
        self.models: List[Tree] = []
        self.K = int(objective.num_model_per_iteration)
        self.shrinkage = config.learning_rate
        F = self.train_set.num_features
        self.B = int(self.train_set.max_num_bin)

        # class-batched multiclass build, decided before the pool gate:
        # the batched builder keeps K per-leaf histogram caches
        self.class_batch_reason = self._class_batch_reason()
        self.class_batch_ok = not self.class_batch_reason
        batched_k = self.K if self.class_batch_ok and self.K > 1 else 1
        pool = (config.histogram_pool_size
                if config.histogram_pool_size > 0 else 512.0)
        # the JAX rule (gbdt.py:162-175, re-gated at K x the lattice for
        # the batched build at :699-706), so both packages decide alike
        cache_mb = (batched_k * (config.num_leaves + 1) * F * self.B * 3 * 4
                    / 2 ** 20)
        self._hist_sub = bool(config.hist_subtraction) and cache_mb <= pool
        if bool(config.hist_subtraction) and not self._hist_sub:
            from .. import log
            log.warning(f"per-leaf histogram cache would need {cache_mb:.0f}"
                        f" MB (> histogram_pool_size budget {pool:.0f} MB);"
                        " disabling histogram subtraction")
        bins = self.train_set.bins
        check_device_capacity(self.train_set.num_data, bins.shape[1],
                              bins.element_size(), config.num_leaves,
                              self.B, self._hist_sub, self.device,
                              num_class=self.K, hist_caches=batched_k)
        self.train_dd = _DeviceData(self.train_set)
        # in-bag count channel: 1 for real rows (no bagging yet)
        self._count_mask = (self.train_dd.row_leaf0 >= 0).to(torch.float32)
        self.valid_sets = [v.construct() for v in valid_sets]
        self.valid_dd = [_DeviceData(v) for v in self.valid_sets]

        dev = self.device
        R = self.train_dd.r_pad
        lbl = self.train_set.get_label()
        self.label_dev = torch.from_numpy(
            _pad_rows(np.asarray(lbl, np.float32), R)).to(dev)
        w = self.train_set.get_weight()
        self.weight_dev = None if w is None else torch.from_numpy(
            _pad_rows(np.asarray(w, np.float32), R)).to(dev)
        objective.init(lbl, w, None)
        self._init_scores = np.zeros(self.K)
        if config.boost_from_average:
            self._init_scores = np.resize(np.asarray(
                objective.boost_from_score(), np.float64).reshape(-1), self.K)
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
        self._rng_feature = np.random.RandomState(
            config.feature_fraction_seed)
        self._pending: List[tuple] = []
        self.host_sync_count = 0
        self.fused_split_reason = self._fused_split_reason()
        self.fused_split_ok = not self.fused_split_reason

    # ------------------------------------------------------------------
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
        return torch.from_numpy(used).to(self.device)

    def _class_batch_reason(self) -> str:
        """Why the class-batched build cannot drive this run ('' = it
        can): the reasons of gbdt.py:1181 that apply to the port. With
        ``class_batch=auto|on`` it clears for every K > 1; one model per
        iteration batches only with ``class_batch=on``. The per-class
        host state it guards against in the JAX package (forced splits,
        CEGB, linear trees, feature-parallel plans, multi-process meshes,
        other boosting modes) is rejected by the port at construction."""
        env = os.environ.get("LIGHTGBM_TPU_CLASS_BATCH", "")
        if env == "0":
            return "LIGHTGBM_TPU_CLASS_BATCH=0"
        mode = "on" if env == "1" else str(self.config.class_batch)
        if mode == "off":
            return "class_batch=off"
        if self.K <= 1 and mode != "on":
            return "single model per iteration"
        return ""

    def _fused_split_reason(self) -> str:
        """Why kernel B2 cannot drive this run's split search ('' = it
        can): the configuration reasons of gbdt.py:1141-1168. Most of
        them name features this port rejects anyway; they stay so the
        gate reads as the JAX package's."""
        cfg = self.config
        env = os.environ.get("LIGHTGBM_TPU_FUSED_SPLIT", "")
        if env == "0":
            return "LIGHTGBM_TPU_FUSED_SPLIT=0"
        mode = "on" if env == "1" else str(cfg.fused_split)
        if mode == "off":
            return "fused_split=off"
        if bool(cfg.extra_trees):
            return "extra-trees thresholds sample the full lattice"
        if cfg.forcedsplits_filename:
            return "forced splits gather arbitrary (feature, bin) cells"
        if bool(cfg.feature_contri):
            return "feature_contri rescales gains outside the kernel"
        if (self.mono_type_pf is not None
                and cfg.monotone_constraints_method == "advanced"):
            return "advanced monotone re-reads sibling histograms"
        return ""

    # ------------------------------------------------------------------
    def _grads(self, scores: torch.Tensor):
        """[K, R] grad and hess at ``scores`` [K, R]."""
        if self.K > 1:
            return self.objective.get_gradients(scores, self.label_dev,
                                                self.weight_dev)
        g, h = self.objective.get_gradients(scores[0], self.label_dev,
                                            self.weight_dev)
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

    def _feature_mask(self) -> torch.Tensor:
        cfg = self.config
        F = self.train_set.num_features
        if cfg.feature_fraction >= 1.0:
            m = np.ones(F, bool)
        else:
            k = max(1, int(F * cfg.feature_fraction))
            m = np.zeros(F, bool)
            m[self._rng_feature.choice(F, k, replace=False)] = True
        return torch.from_numpy(m).to(self.device)

    def _build_one_tree(self, gh: torch.Tensor, fmask: torch.Tensor,
                        batched: bool = False):
        """One tree from gh [R, 3], or with ``batched`` the K trees of an
        iteration from gh [K, R, 3] (gbdt.py:1230)."""
        cfg = self.config
        builder = build_tree_class_batched if batched else build_tree
        return builder(
            self.train_dd.bins, gh, self.train_dd.row_leaf0,
            self.num_bins_pf, self.nan_bin_pf, self.is_cat_pf, fmask,
            num_leaves=cfg.num_leaves, leaf_batch=cfg.leaf_batch,
            max_depth=cfg.max_depth, num_bins=self.B,
            split_params=self.split_params, hist_dtype=cfg.hist_dtype,
            valid_bins=tuple(dd.bins for dd in self.valid_dd),
            valid_row_leaf0=tuple(dd.row_leaf0 for dd in self.valid_dd),
            mono_type_pf=self.mono_type_pf, hist_sub=self._hist_sub,
            fused_split=self.fused_split_ok, has_cat=self._has_cat)

    def train_one_iter(self, *, defer: bool = False):
        """One boosting iteration: gradients -> K trees -> score
        updates, all on the device. ``defer=True`` leaves the trees
        pending (no host sync) until :meth:`sync`; otherwise syncs and
        returns True when training must stop (no class could split)."""
        g, h = self._grads(self.scores)
        fmask = self._feature_mask()
        lr = float(self.shrinkage)
        if self.class_batch_ok:
            # one build for all K classes (gbdt.py:1596-1631): per-class
            # rows are independent, so the batched where() equals the
            # sequential per-class updates
            trees, row_leaf_k, valid_rls_k = self._build_one_tree(
                self._stack_gh_k(g, h, self._count_mask), fmask,
                batched=True)
            grew = trees.num_leaves > 1                      # [K]
            upd = self._update_score_impl(self.scores, trees.leaf_values,
                                          row_leaf_k, lr)
            self.scores = torch.where(grew[:, None], upd, self.scores)
            for vi, vrl_k in enumerate(valid_rls_k):
                vupd = self._update_score_impl(
                    self.valid_scores[vi], trees.leaf_values, vrl_k, lr)
                self.valid_scores[vi] = torch.where(
                    grew[:, None], vupd, self.valid_scores[vi])
        else:
            # the per-class loop (gbdt.py:1632-1665)
            per_class = []
            for k in range(self.K):
                gh = torch.stack([g[k], h[k], self._count_mask], dim=1)
                tree, row_leaf, valid_rls = self._build_one_tree(gh, fmask)
                grew_k = tree.num_leaves > 1
                upd = self._update_score_impl(self.scores[k],
                                              tree.leaf_values, row_leaf, lr)
                self.scores[k] = torch.where(grew_k, upd, self.scores[k])
                for vi, vrl in enumerate(valid_rls):
                    vupd = self._update_score_impl(
                        self.valid_scores[vi][k], tree.leaf_values, vrl, lr)
                    self.valid_scores[vi][k] = torch.where(
                        grew_k, vupd, self.valid_scores[vi][k])
                per_class.append(tree)
            trees = TreeArrays(*(torch.stack(f) for f in zip(*per_class)))
            grew = trees.num_leaves > 1
        self._pending.append((self.iter_, lr, trees, grew))
        self.iter_ += 1
        if defer:
            return None
        return self.sync()

    def sync(self) -> bool:
        """Materialize every pending iteration's K trees with ONE
        device-to-host transfer and run the deferred stop check
        (gbdt.py:1762). Returns True when an iteration in which no class
        grew was found: it and everything dispatched after it are
        dropped (their score updates were device no-ops). A class that
        did not grow in a kept iteration keeps its one-leaf tree."""
        if not self._pending:
            return False
        pending, self._pending = self._pending, []
        fields = [f for (_, _, tree, grew) in pending
                  for f in (*tree, grew)]
        flat = torch.cat([f.reshape(-1).to(torch.float64) for f in fields])
        host = flat.cpu().numpy()
        self.host_sync_count += 1
        trees_h, off = [], 0
        for f in fields:
            n = f.numel()
            a = host[off:off + n].reshape(tuple(f.shape))
            trees_h.append(a.astype(_NP_DTYPES[f.dtype]))
            off += n
        per = len(TreeArrays._fields) + 1
        bm = self.train_set.bin_mappers
        uf = self.train_set.used_features
        stop = False
        kept = 0
        for i, (it, shrink, _, _) in enumerate(pending):
            arrs = trees_h[i * per:(i + 1) * per]
            if not bool(arrs[-1].any()) and it > 0:
                stop = True
                break
            for k in range(self.K):
                tree = Tree.from_device(TreeArrays(*(a[k] for a in
                                                     arrs[:-1])),
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
        return stop

    # ------------------------------------------------------------------
    def eval_scores(self, which: int = -1) -> np.ndarray:
        """[num_data, K] raw scores of the train (-1) or a valid set."""
        if which < 0:
            s, n = self.scores, self.train_dd.num_data
        else:
            s, n = self.valid_scores[which], self.valid_dd[which].num_data
        self.host_sync_count += 1
        return s[:, :n].T.cpu().numpy().astype(np.float64)

    def current_iteration(self) -> int:
        return self.iter_
