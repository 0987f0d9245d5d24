"""Random forest mode.

Port of ``lightgbm_tpu/boosting/rf.py`` (the reference's ``rf.hpp``):
no shrinkage, bagging or feature sampling required, gradients computed
once at the constant init score (no boosting), every grown tree carries
the init-score bias (AddBias), and the tracked score is the running
average of the trees' outputs (``rf.hpp:158-160``), so metrics and
predictions use the mean output (``average_output``).

RF runs the eager loop (``_fused_gate_reason``: "boosting mode
overrides the iteration loop"): each tree comes to the host when it is
built, since whether it grew decides its bias and its score update.
Continued training (``num_init_iteration > 0``; ``rf.py:47-75``)
recomputes the init score with ``boost_from_average`` and keeps the
base model's averaged scores; the running average then counts the base
model's iterations too. Custom objectives and gradients are refused.
"""

from __future__ import annotations

import numpy as np
import torch

from ..parallel import distributed as pdist
from ..tree import Tree
from .gbdt import GBDT, kEpsilon
from .tree_builder import TreeArrays

__all__ = ["RF"]


class RF(GBDT):
    average_output = True

    def __init__(self, config, train_set, objective, valid_sets=(),
                 **kwargs):
        if objective is None:
            raise ValueError("RF mode does not support custom objective "
                             "(rf.hpp Boosting check)")
        if config.data_sample_strategy == "bagging" and not (
                (config.bagging_freq > 0 and 0 < config.bagging_fraction < 1)
                or 0 < config.feature_fraction < 1):
            # rf.hpp Init: the bagging strategy needs actual subsampling;
            # the goss strategy is accepted as it is
            raise ValueError(
                "RF needs bagging (bagging_freq > 0 and bagging_fraction "
                "< 1) or feature_fraction < 1 (rf.hpp Init check)")
        super().__init__(config, train_set, objective, valid_sets, **kwargs)
        self.shrinkage = 1.0
        if self.num_init_iteration > 0 and config.boost_from_average:
            # rf.hpp Boosting recomputes BoostFromAverage whatever
            # num_init_iteration is: continued RF takes its gradients at
            # the label-average init score and its new trees carry it
            # (GBDT.__init__ zeroes _init_scores for base scores)
            self._init_scores = np.resize(np.asarray(
                self.objective.boost_from_score(), np.float64).reshape(-1),
                self.K)
            if self._sharded:
                self._init_scores = pdist.global_mean_init_scores(
                    self._init_scores, self.plan.comm)
        # constant gradients at the init score (rf.hpp Boosting): RF
        # never boosts, every tree fits the same residuals
        init = torch.from_numpy(
            self._init_scores.astype(np.float32)[:, None]).to(self.device)
        self._g0, self._h0 = self._grads(torch.zeros_like(self.scores)
                                         + init)
        # scores hold the running average of the trees' outputs; they
        # start from zero (the bias rides inside each tree). A continued
        # run's base scores are an average_output model's, already
        # averages, and stand as they are (rf.hpp Init MultiplyScore)
        if self.num_init_iteration == 0:
            self.scores.zero_()
            for vs in self.valid_scores:
                vs.zero_()

    def train_one_iter(self, gradients=None, hessians=None, *,
                       defer: bool = False) -> bool:
        """One RF iteration; ``defer`` is accepted and ignored. RF never
        stops early (rf.hpp TrainOneIter)."""
        if gradients is not None or hessians is not None:
            raise ValueError("RF mode does not support custom gradients")
        it = self.iter_
        self._draw_inputs(it)
        g, h, count = self._sample(self._g0, self._h0, self._goss_on(it))
        n = float(it + self.num_init_iteration)
        bm = self.train_set.bin_mappers
        uf = self.train_set.used_features
        for k in range(self.K):
            gh = torch.stack([g[k], h[k], count], dim=1)
            tree_arrays, row_leaf, valid_rls = self._build_one_tree(
                gh, self._fmask_buf, k=k)
            host = TreeArrays(*(f.cpu().numpy() for f in tree_arrays))
            self.host_sync_count += 1
            bias = float(self._init_scores[k])
            tree = Tree.from_device(host, bm, uf, 1.0)
            grew = int(host.num_leaves) > 1
            # rf.hpp:148-176: grown trees always carry the init bias
            # (AddBias); a no-split iteration stores the constant init
            # tree the first time only, later ones a zero tree that
            # leaves the running average alone
            if abs(bias) > kEpsilon and (grew or it == 0):
                tree.leaf_value += bias
                tree.internal_value += bias
                tree_arrays = self._bias_adjust_device(tree_arrays, bias,
                                                       1.0)
            if grew or it == 0:
                # the running average with the iteration count as weight
                # (rf.hpp:158-160 MultiplyScore(n), add,
                # MultiplyScore(1/(n+1)))
                lv = tree_arrays.leaf_values
                self.scores[k] = self._update_score_impl(
                    self.scores[k] * n, lv, row_leaf, 1.0) / (n + 1.0)
                for vs, vrl in zip(self.valid_scores, valid_rls):
                    vs[k] = self._update_score_impl(
                        vs[k] * n, lv, vrl, 1.0) / (n + 1.0)
            self.models.append(tree)
        self.iter_ += 1
        return False

    def rollback_one_iter(self) -> None:
        """RF::RollbackOneIter (rf.hpp:184-203): the scores are running
        averages, so undoing iteration n is
        scores = (scores * n - tree output) / (n - 1)."""
        if self.iter_ <= 0:
            return
        n = float(self.iter_ + self.num_init_iteration)
        for k in range(self.K):
            tree = self.models[-(self.K - k)]
            for vs, dd in ((self.scores, self.train_dd),
                           *zip(self.valid_scores, self.valid_dd)):
                pred = self._replay_host(tree, dd)
                vs[k] = ((vs[k] * n - pred) / (n - 1.0) if n > 1
                         else torch.zeros_like(vs[k]))
        del self.models[-self.K:]
        self.iter_ -= 1
