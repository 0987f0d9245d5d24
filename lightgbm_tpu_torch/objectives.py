"""Objective functions: score -> (grad, hess), init score, output link.

Port of ``lightgbm_tpu/objectives.py`` with the JAX package's
arithmetic in float32 tensors: the regression family (``:77-255``;
the reference's ``regression_objective.hpp``), ``Binary`` (``:279``;
``binary_objective.hpp``), ``MulticlassSoftmax`` (``:327``) and
``MulticlassOVA`` (``:372``; ``multiclass_objective.hpp``) and the
cross-entropies (``:409-455``; ``xentropy_objective.hpp``).
``boost_from_score`` runs on the host in numpy, as in the JAX package
(weighted median and quantile included). Every ``get_gradients`` is a
fixed sequence of elementwise tensor ops: it reads no device value on
the host, so the training step's CUDA graph can hold it.
The ranking objectives ``lambdarank`` and ``rank_xendcg`` live in
``ranking.py`` (the JAX package's ``ranking.py``); their
``get_gradients`` also takes the iteration number ``it``.

Two quirks of the reference are kept: ``Mape.init`` reweights the rows
by 1/max(1, |y|) for ``boost_from_score`` only (the booster takes the
gradient weights from the Dataset), and ``RegressionL2`` with
``reg_sqrt`` retargets ``self.label`` to sign(y)*sqrt(|y|), which the
booster uploads in place of the Dataset's label.

Scores and gradients of a multiclass objective are [K, R] (class-major,
the layout of the booster's score rows); the JAX objectives take [R, K]
and the JAX booster transposes around them (``gbdt.py:831-834``).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from .config import Config

__all__ = ["Objective", "RegressionL2", "RegressionL1", "Huber", "Fair",
           "Poisson", "Quantile", "Mape", "Gamma", "Tweedie", "Binary",
           "MulticlassSoftmax", "MulticlassOVA", "CrossEntropy",
           "CrossEntropyLambda", "create_objective"]


class Objective:
    """Bundle of (get_gradients, boost_from_score, convert_output)."""

    name: str = "custom"
    num_model_per_iteration: int = 1
    is_ranking: bool = False
    needs_convert: bool = False

    def __init__(self, cfg: Config):
        self.cfg = cfg

    def init(self, label: np.ndarray, weight: Optional[np.ndarray],
             query_boundaries: Optional[np.ndarray] = None,
             position: Optional[np.ndarray] = None):
        """``position`` (per-row result positions) is read by the
        ranking objectives only."""
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


def _weighted(g, h, weight):
    if weight is not None:
        return g * weight, h * weight
    return g, h


def _weighted_quantile(lab, w, q):
    """Label at the first cumulative weight >= q of the total."""
    order = np.argsort(lab)
    cw = np.cumsum(w[order])
    idx = np.searchsorted(cw, q * cw[-1])
    return lab[order[min(idx, len(lab) - 1)]]


# -- regression family (regression_objective.hpp) --------------------------
class RegressionL2(Objective):
    name = "regression"

    def __init__(self, cfg):
        super().__init__(cfg)
        self.sqrt = bool(cfg.reg_sqrt)
        # sqrt mode trains in sqrt-space; predictions square back
        self.needs_convert = self.sqrt

    def init(self, label, weight, query_boundaries=None):
        if self.sqrt:
            label = np.sign(label) * np.sqrt(np.abs(label))
        super().init(label, weight, query_boundaries)

    def get_gradients(self, score, label, weight):
        return _weighted(score - label, torch.ones_like(score), weight)

    def boost_from_score(self):
        if not self.cfg.boost_from_average:
            return np.zeros(1)
        return np.asarray([self._wmean()])

    def convert_output(self, raw):
        if self.sqrt:
            return np.sign(raw) * raw * raw
        return raw


class RegressionL1(Objective):
    name = "regression_l1"

    def get_gradients(self, score, label, weight):
        return _weighted(torch.sign(score - label), torch.ones_like(score),
                         weight)

    def boost_from_score(self):
        if not self.cfg.boost_from_average:
            return np.zeros(1)
        # the (weighted) median of the labels
        if self.weight is None:
            return np.asarray([np.median(self.label)])
        return np.asarray([_weighted_quantile(self.label, self.weight,
                                              0.5)])


class Huber(Objective):
    name = "huber"

    def get_gradients(self, score, label, weight):
        a = self.cfg.alpha
        return _weighted(torch.clamp(score - label, -a, a),
                         torch.ones_like(score), weight)

    def boost_from_score(self):
        return np.asarray([self._wmean()]) if self.cfg.boost_from_average \
            else np.zeros(1)


class Fair(Objective):
    name = "fair"

    def get_gradients(self, score, label, weight):
        c = self.cfg.fair_c
        x = score - label
        g = c * x / (torch.abs(x) + c)
        h = c * c / (torch.abs(x) + c) ** 2
        return _weighted(g, h, weight)


class Poisson(Objective):
    name = "poisson"
    needs_convert = True

    def get_gradients(self, score, label, weight):
        # loss = exp(score) - label * score (log link)
        g = torch.exp(score) - label
        h = torch.exp(score + self.cfg.poisson_max_delta_step)
        return _weighted(g, h, weight)

    def boost_from_score(self):
        return np.asarray([np.log(max(self._wmean(), 1e-20))])

    def convert_output(self, raw):
        return np.exp(raw)


class Quantile(Objective):
    name = "quantile"

    def get_gradients(self, score, label, weight):
        a = self.cfg.alpha
        g = torch.where(score >= label, 1.0 - a, -a).to(score.dtype)
        return _weighted(g, torch.ones_like(score), weight)

    def boost_from_score(self):
        if not self.cfg.boost_from_average:
            return np.zeros(1)
        a = self.cfg.alpha
        if self.weight is None:
            return np.asarray([np.quantile(self.label, a)])
        return np.asarray([_weighted_quantile(self.label, self.weight, a)])


class Mape(Objective):
    name = "mape"

    def init(self, label, weight, query_boundaries=None):
        super().init(label, weight, query_boundaries)
        # rows are reweighted by 1/max(1, |label|); the booster's
        # gradient weights stay the Dataset's (a quirk of the reference)
        scale = 1.0 / np.maximum(1.0, np.abs(label))
        self.weight = scale if weight is None else weight * scale

    def get_gradients(self, score, label, weight):
        return _weighted(torch.sign(score - label), torch.ones_like(score),
                         weight)

    def boost_from_score(self):
        if not self.cfg.boost_from_average:
            return np.zeros(1)
        w = (self.weight if self.weight is not None
             else np.ones(len(self.label)))
        return np.asarray([_weighted_quantile(self.label, w, 0.5)])


class Gamma(Objective):
    name = "gamma"
    needs_convert = True

    def get_gradients(self, score, label, weight):
        # gamma deviance with log link
        e = torch.exp(-score)
        return _weighted(1.0 - label * e, label * e, weight)

    def boost_from_score(self):
        return np.asarray([np.log(max(self._wmean(), 1e-20))])

    def convert_output(self, raw):
        return np.exp(raw)


class Tweedie(Objective):
    name = "tweedie"
    needs_convert = True

    def get_gradients(self, score, label, weight):
        rho = self.cfg.tweedie_variance_power
        a = torch.exp((1.0 - rho) * score)
        b = torch.exp((2.0 - rho) * score)
        g = -label * a + b
        h = -label * (1.0 - rho) * a + (2.0 - rho) * b
        return _weighted(g, h, weight)

    def boost_from_score(self):
        return np.asarray([np.log(max(self._wmean(), 1e-20))])

    def convert_output(self, raw):
        return np.exp(raw)


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


# -- cross entropy on [0, 1] labels (xentropy_objective.hpp) ---------------
class CrossEntropy(Objective):
    name = "cross_entropy"
    needs_convert = True

    def get_gradients(self, score, label, weight):
        p = 1.0 / (1.0 + torch.exp(-score))
        return _weighted(p - label, p * (1.0 - p), weight)

    def boost_from_score(self):
        pbar = min(max(self._wmean(), 1e-15), 1 - 1e-15)
        return np.asarray([np.log(pbar / (1.0 - pbar))])

    def convert_output(self, raw):
        return 1.0 / (1.0 + np.exp(-raw))


class CrossEntropyLambda(Objective):
    name = "cross_entropy_lambda"
    needs_convert = True

    # log-link intensity: p = 1 - exp(-exp(s))
    def get_gradients(self, score, label, weight):
        el = torch.exp(score)
        expel = torch.expm1(el)                  # e^{e^s} - 1
        g = el * (1.0 - label * (1.0 + 1.0 / torch.clamp_min(expel, 1e-30)))
        h = el * (1.0 - label) + label * el * (el * (1.0 + expel)
                                               - expel) \
            / torch.clamp_min(expel, 1e-30) ** 2 * el
        h = torch.clamp_min(h, 1e-15)
        return _weighted(g, h, weight)

    def boost_from_score(self):
        pbar = min(max(self._wmean(), 1e-15), 1 - 1e-15)
        return np.asarray([np.log(-np.log(1.0 - pbar))])

    def convert_output(self, raw):
        return 1.0 - np.exp(-np.exp(raw))


# ranking (rank_objective.hpp): a module of its own, as in the JAX package
from .ranking import LambdaRank, RankXENDCG  # noqa: E402

_REGISTRY = {"regression": RegressionL2, "regression_l1": RegressionL1,
             "huber": Huber, "fair": Fair, "poisson": Poisson,
             "quantile": Quantile, "mape": Mape, "gamma": Gamma,
             "tweedie": Tweedie, "binary": Binary,
             "multiclass": MulticlassSoftmax,
             "multiclassova": MulticlassOVA, "cross_entropy": CrossEntropy,
             "cross_entropy_lambda": CrossEntropyLambda,
             "lambdarank": LambdaRank, "rank_xendcg": RankXENDCG}


def create_objective(cfg: Config) -> Optional[Objective]:
    """Factory (objective_function.cpp:20 analog). None for custom fobj."""
    name = cfg.objective
    if name == "custom":
        return None
    if name not in _REGISTRY:
        raise ValueError(f"Unknown objective: {name}")
    return _REGISTRY[name](cfg)
