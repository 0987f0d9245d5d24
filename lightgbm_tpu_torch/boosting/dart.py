"""DART boosting (Dropouts meet Multiple Additive Regression Trees).

Port of ``lightgbm_tpu/boosting/dart.py`` (the reference's
``dart.hpp``): each iteration drops a random subset of the existing
trees (their contribution leaves the training scores before the
gradients), trains the new tree at shrinkage lr/(1+k) (xgboost mode:
lr/(lr+k)), and rescales the dropped trees by k/(k+1) (resp.
k/(lr+k)) so the ensemble stays normalized.

The drop draws come from the host ``RandomState(drop_seed)`` in the
reference's order. A dropped tree is replayed over the train and valid
rows from its device arrays (``ops/predict.py`` ``predict_bins_value``,
once per iteration, cached for the restore). DART runs the eager loop
(``_fused_gate_reason``: "boosting mode overrides the iteration loop")
and syncs every iteration: the normalization rescales host trees.

Under a parallel plan every rank draws the same drops from the same
stream and replays them over its own rows (train and the co-partitioned
valid sets); the normalization is the serial run's.

A custom objective's gradients are taken at the dropped ensemble's
scores: :meth:`DART.get_training_scores` drops first (dart.hpp
GetTrainingScore; the JAX package's ``dart.py:100-118``). Continued
training keeps the tree weights of DART's own trees only; the base
model's trees are never dropped, as in the JAX package.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np

from .gbdt import GBDT

__all__ = ["DART"]


class DART(GBDT):
    keep_device_trees = True   # drop/restore replays stored trees

    def __init__(self, config, train_set, objective, valid_sets=(),
                 **kwargs):
        super().__init__(config, train_set, objective, valid_sets, **kwargs)
        self._rng_drop = np.random.RandomState(config.drop_seed)
        self._tree_weight: List[float] = []   # per-iteration weights
        self._sum_weight = 0.0
        self._dropped: Optional[tuple] = None  # (drop, preds) this iter

    # -- dart.hpp DroppingTrees ----------------------------------------
    def _select_drop(self) -> List[int]:
        cfg = self.config
        n = self.iter_
        drop: List[int] = []
        if self._rng_drop.rand() >= cfg.skip_drop and n > 0:
            drop_rate = cfg.drop_rate
            max_drop = cfg.max_drop if cfg.max_drop > 0 else np.inf
            if not cfg.uniform_drop:
                inv_avg = n / self._sum_weight
                if cfg.max_drop > 0:
                    drop_rate = min(
                        drop_rate,
                        cfg.max_drop * inv_avg / self._sum_weight)
                for i in range(n):
                    if self._rng_drop.rand() < \
                            drop_rate * self._tree_weight[i] * inv_avg:
                        drop.append(i)
                        if len(drop) >= max_drop:
                            break
            else:
                if cfg.max_drop > 0:
                    drop_rate = min(drop_rate, cfg.max_drop / n)
                for i in range(n):
                    if self._rng_drop.rand() < drop_rate:
                        drop.append(i)
                        if len(drop) >= max_drop:
                            break
        k = len(drop)
        if not cfg.xgboost_dart_mode:
            self.shrinkage = cfg.learning_rate / (1.0 + k)
        else:
            self.shrinkage = (cfg.learning_rate if k == 0 else
                              cfg.learning_rate / (cfg.learning_rate + k))
        return drop

    def _tree_preds(self, it: int):
        """Per-row unshrunk outputs of iteration ``it``'s K trees on the
        train and every valid set (each walked once an iteration)."""
        train = [self.predict_device_tree(it * self.K + k, -1)
                 for k in range(self.K)]
        valids = [[self.predict_device_tree(it * self.K + k, vi)
                   for k in range(self.K)]
                  for vi in range(len(self.valid_dd))]
        return train, valids

    def _ensure_dropped(self):
        """Drop once per iteration (dart.hpp GetTrainingScore)."""
        if self._dropped is not None:
            return
        drop = self._select_drop()
        preds = {}
        for it in drop:
            preds[it] = self._tree_preds(it)
            w = self._tree_weight[it]
            tr, _ = preds[it]
            for ki in range(self.K):
                self.scores[ki] += -w * tr[ki]
        self._dropped = (drop, preds)

    def get_training_scores(self) -> np.ndarray:
        self._ensure_dropped()
        return super().get_training_scores()

    def train_one_iter(self, gradients=None, hessians=None, *,
                       defer: bool = False) -> bool:
        """One DART iteration; ``defer`` is accepted and ignored (the
        normalization rescales host trees, so every iteration syncs)."""
        cfg = self.config
        self._ensure_dropped()
        drop, preds = self._dropped
        self._dropped = None
        k = float(len(drop))

        if super().train_one_iter(gradients, hessians):
            # restore the dropped contributions; the iteration was a no-op
            for it in drop:
                w = self._tree_weight[it]
                tr, _ = preds[it]
                for ki in range(self.K):
                    self.scores[ki] += w * tr[ki]
            return True

        # normalize (dart.hpp Normalize)
        if k > 0:
            factor = (k / (k + 1.0) if not cfg.xgboost_dart_mode
                      else k / (k + cfg.learning_rate))
            for it in drop:
                w = self._tree_weight[it]
                new_w = w * factor
                tr, vas = preds[it]
                for ki in range(self.K):
                    # train: fully dropped, so add back at the new weight
                    self.scores[ki] += new_w * tr[ki]
                    for vi, vs in enumerate(self.valid_scores):
                        vs[ki] += -(w - new_w) * vas[vi][ki]
                    self.models[it * self.K + ki].scale(factor)
                self._sum_weight -= w * (1.0 - factor)
                self._tree_weight[it] = new_w

        self._tree_weight.append(self.shrinkage)
        self._sum_weight += self.shrinkage
        return False
