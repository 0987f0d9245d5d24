"""Objective functions: score -> (grad, hess), init score, output link.

Port of ``lightgbm_tpu/objectives.py``: ``Binary`` (``objectives.py:279``;
the reference's ``binary_objective.hpp``), ``MulticlassSoftmax``
(``:327``) and ``MulticlassOVA`` (``:372``; ``multiclass_objective.hpp``)
with the JAX package's arithmetic in float32 tensors.
``create_objective`` raises ``NotImplementedError`` for every other
registered objective (ROADMAP A, objectives).

Scores and gradients of a multiclass objective are [K, R] (class-major,
the layout of the booster's score rows); the JAX objectives take [R, K]
and the JAX booster transposes around them (``gbdt.py:831-834``).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from .config import Config

__all__ = ["Objective", "Binary", "MulticlassSoftmax", "MulticlassOVA",
           "create_objective"]


class Objective:
    """Bundle of (get_gradients, boost_from_score, convert_output)."""

    name: str = "custom"
    num_model_per_iteration: int = 1
    is_ranking: bool = False
    needs_convert: bool = False

    def __init__(self, cfg: Config):
        self.cfg = cfg

    def init(self, label: np.ndarray, weight: Optional[np.ndarray],
             query_boundaries: Optional[np.ndarray] = None):
        self.label = label
        self.weight = weight
        self.query_boundaries = query_boundaries

    def get_gradients(self, score: torch.Tensor, label: torch.Tensor,
                      weight: Optional[torch.Tensor]
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
        raise NotImplementedError

    def boost_from_score(self) -> np.ndarray:
        return np.zeros(self.num_model_per_iteration)

    def convert_output(self, raw: np.ndarray) -> np.ndarray:
        return raw

    def _wmean(self):
        if self.weight is None:
            return float(np.mean(self.label))
        return float(np.average(self.label, weights=self.weight))


class Binary(Objective):
    name = "binary"
    needs_convert = True

    def __init__(self, cfg):
        super().__init__(cfg)
        self.sig = cfg.sigmoid

    def init(self, label, weight, query_boundaries=None):
        u = np.unique(label[~np.isnan(label)])
        if not np.all(np.isin(u, [0.0, 1.0])):
            raise ValueError("binary objective requires labels in {0, 1}")
        super().init(label, weight, query_boundaries)
        npos = float((label == 1).sum())
        nneg = float(len(label) - npos)
        if self.cfg.is_unbalance and npos > 0 and nneg > 0:
            if npos > nneg:
                self.pos_w, self.neg_w = 1.0, npos / nneg
            else:
                self.pos_w, self.neg_w = nneg / npos, 1.0
        else:
            self.pos_w, self.neg_w = self.cfg.scale_pos_weight, 1.0

    def get_gradients(self, score, label, weight):
        sig = self.sig
        p = 1.0 / (1.0 + torch.exp(-(sig * score)))
        lw = torch.where(label > 0, self.pos_w, self.neg_w).to(score.dtype)
        g = sig * (p - label) * lw
        h = sig * sig * p * (1.0 - p) * lw
        if weight is not None:
            g, h = g * weight, h * weight
        return g, h

    def boost_from_score(self):
        if not self.cfg.boost_from_average:
            return np.zeros(1)
        pbar = self._wmean()
        pbar = min(max(pbar, 1e-15), 1 - 1e-15)
        return np.asarray([np.log(pbar / (1.0 - pbar)) / self.sig])

    def convert_output(self, raw):
        return 1.0 / (1.0 + np.exp(-self.sig * raw))


def _one_hot_k(label: torch.Tensor, K: int, dtype) -> torch.Tensor:
    """[K, R] one-hot of integer labels (class-major)."""
    iota = torch.arange(K, device=label.device)[:, None]
    return (label.to(torch.int64)[None, :] == iota).to(dtype)


def _class_counts(label, weight, K) -> np.ndarray:
    return np.bincount(label.astype(np.int64), weights=weight,
                       minlength=K).astype(np.float64)


class MulticlassSoftmax(Objective):
    name = "multiclass"
    needs_convert = True

    def __init__(self, cfg):
        super().__init__(cfg)
        self.num_class = cfg.num_class
        self.num_model_per_iteration = cfg.num_class

    def init(self, label, weight, query_boundaries=None):
        lab = label.astype(np.int64)
        if lab.min() < 0 or lab.max() >= self.num_class:
            raise ValueError("multiclass labels must be in "
                             f"[0, {self.num_class})")
        super().init(label, weight, query_boundaries)

    def get_gradients(self, score, label, weight):
        # score [K, R]: softmax over the class axis, hessian scaled by
        # K/(K-1) (multiclass_objective.hpp:31 factor_)
        e = torch.exp(score - score.amax(dim=0, keepdim=True))
        p = e / e.sum(dim=0, keepdim=True)
        g = p - _one_hot_k(label, self.num_class, score.dtype)
        factor = self.num_class / max(self.num_class - 1.0, 1.0)
        h = factor * p * (1.0 - p)
        if weight is not None:
            g, h = g * weight, h * weight
        return g, h

    def boost_from_score(self):
        if not self.cfg.boost_from_average:
            return np.zeros(self.num_class)
        counts = _class_counts(self.label, self.weight, self.num_class)
        return np.log(np.maximum(counts / counts.sum(), 1e-15))

    def convert_output(self, raw):
        raw = raw - raw.max(axis=-1, keepdims=True)
        e = np.exp(raw)
        return e / e.sum(axis=-1, keepdims=True)


class MulticlassOVA(Objective):
    name = "multiclassova"
    needs_convert = True

    def __init__(self, cfg):
        super().__init__(cfg)
        self.num_class = cfg.num_class
        self.num_model_per_iteration = cfg.num_class
        self.sig = cfg.sigmoid

    def get_gradients(self, score, label, weight):
        sig = self.sig
        y = _one_hot_k(label, self.num_class, score.dtype)
        p = 1.0 / (1.0 + torch.exp(-(sig * score)))
        g = sig * (p - y)
        h = sig * sig * p * (1.0 - p)
        if weight is not None:
            g, h = g * weight, h * weight
        return g, h

    def boost_from_score(self):
        if not self.cfg.boost_from_average:
            return np.zeros(self.num_class)
        counts = _class_counts(self.label, self.weight, self.num_class)
        p = np.clip(counts / counts.sum(), 1e-15, 1 - 1e-15)
        return np.log(p / (1 - p)) / self.sig

    def convert_output(self, raw):
        return 1.0 / (1.0 + np.exp(-self.sig * raw))


_REGISTRY = {"binary": Binary, "multiclass": MulticlassSoftmax,
             "multiclassova": MulticlassOVA}
# registered in the JAX package, not ported yet
_PENDING = ("regression", "regression_l1", "huber", "fair", "poisson",
            "quantile", "mape", "gamma", "tweedie", "cross_entropy",
            "cross_entropy_lambda", "lambdarank", "rank_xendcg")


def create_objective(cfg: Config) -> Optional[Objective]:
    """Factory (objective_function.cpp:20 analog). None for custom fobj."""
    name = cfg.objective
    if name == "custom":
        return None
    if name in _PENDING:
        raise NotImplementedError(
            f"objective {name!r} is not ported to lightgbm_tpu_torch yet "
            "(ROADMAP A, objectives); the port trains binary, "
            "multiclass and multiclassova")
    if name not in _REGISTRY:
        raise ValueError(f"Unknown objective: {name}")
    return _REGISTRY[name](cfg)
