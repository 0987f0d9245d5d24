"""Evaluation metrics.

TPU-native analog of the reference metric layer
(``include/LightGBM/metric.h`` interface; ``src/metric/regression_metric.hpp``,
``binary_metric.hpp``, ``multiclass_metric.hpp``, ``rank_metric.hpp``,
``map_metric.hpp``, ``xentropy_metric.hpp``; factory ``src/metric/metric.cpp``).

Metrics run on host NumPy in float64: evaluation touches each row once per
``metric_freq`` iterations and is bandwidth-trivial next to histogram
construction, so device kernels would buy nothing; float64 keeps AUC/NDCG
comparable to the reference bit-for-bit-ish. Each metric reports
``(name, value, bigger_is_better)`` like ``factor_to_bigger_better``.
"""

from __future__ import annotations

import numpy as np
from typing import List, Tuple

from .config import Config

__all__ = ["Metric", "create_metrics", "METRIC_ALIASES"]


class Metric:
    name: str = ""
    bigger_is_better: bool = False

    def __init__(self, cfg: Config):
        self.cfg = cfg

    def init(self, label, weight, query_boundaries=None):
        self.label = label
        self.weight = weight
        self.query_boundaries = query_boundaries

    def eval(self, pred: np.ndarray) -> List[Tuple[str, float, bool]]:
        """pred: converted output (probabilities for binary/multiclass,
        raw for regression/ranking)."""
        raise NotImplementedError

    def _avg(self, per_row: np.ndarray) -> float:
        if self.weight is None:
            return float(np.mean(per_row))
        return float(np.sum(per_row * self.weight) / np.sum(self.weight))


# -- regression (regression_metric.hpp) ------------------------------------
class _Pointwise(Metric):
    def eval(self, pred):
        return [(self.name, self._avg(self.point(pred, self.label)),
                 self.bigger_is_better)]


class L2(_Pointwise):
    name = "l2"

    def point(self, p, y):
        return (p - y) ** 2


class RMSE(_Pointwise):
    name = "rmse"

    def eval(self, pred):
        mse = self._avg((pred - self.label) ** 2)
        return [(self.name, float(np.sqrt(mse)), False)]


class L1(_Pointwise):
    name = "l1"

    def point(self, p, y):
        return np.abs(p - y)


class QuantileMetric(_Pointwise):
    name = "quantile"

    def point(self, p, y):
        a = self.cfg.alpha
        d = y - p
        return np.where(d >= 0, a * d, (a - 1) * d)


class HuberMetric(_Pointwise):
    name = "huber"

    def point(self, p, y):
        a = self.cfg.alpha
        d = np.abs(p - y)
        return np.where(d <= a, 0.5 * d * d, a * (d - 0.5 * a))


class FairMetric(_Pointwise):
    name = "fair"

    def point(self, p, y):
        c = self.cfg.fair_c
        x = np.abs(p - y)
        return c * x - c * c * np.log1p(x / c)


class PoissonMetric(_Pointwise):
    name = "poisson"

    def point(self, p, y):
        eps = 1e-10
        return p - y * np.log(np.maximum(p, eps))


class MAPEMetric(_Pointwise):
    name = "mape"

    def point(self, p, y):
        return np.abs(p - y) / np.maximum(1.0, np.abs(y))


class GammaMetric(_Pointwise):
    name = "gamma"

    def point(self, p, y):
        eps = 1e-10
        p = np.maximum(p, eps)
        # negative log-likelihood of Gamma with unit shape (reference form)
        return y / p + np.log(p)


class GammaDeviance(_Pointwise):
    name = "gamma_deviance"

    def point(self, p, y):
        eps = 1e-10
        r = y / np.maximum(p, eps)
        return 2.0 * (np.log(np.maximum(1.0 / np.maximum(r, eps), eps))
                      + r - 1.0)


class TweedieMetric(_Pointwise):
    name = "tweedie"

    def point(self, p, y):
        rho = self.cfg.tweedie_variance_power
        eps = 1e-10
        p = np.maximum(p, eps)
        return -y * np.power(p, 1 - rho) / (1 - rho) \
            + np.power(p, 2 - rho) / (2 - rho)


# -- binary (binary_metric.hpp) ---------------------------------------------
class BinaryLogloss(_Pointwise):
    name = "binary_logloss"

    def point(self, p, y):
        eps = 1e-15
        p = np.clip(p, eps, 1 - eps)
        return -(y * np.log(p) + (1 - y) * np.log(1 - p))


class BinaryError(_Pointwise):
    name = "binary_error"

    def point(self, p, y):
        return ((p > 0.5) != (y > 0)).astype(np.float64)


class AUC(Metric):
    name = "auc"
    bigger_is_better = True

    def eval(self, pred):
        y = self.label > 0
        w = self.weight if self.weight is not None else np.ones(len(y))
        order = np.argsort(pred, kind="mergesort")
        p, ys, ws = pred[order], y[order], w[order]
        # tie-aware trapezoid accumulation (binary_metric.hpp AUCMetric)
        wpos = np.where(ys, ws, 0.0)
        wneg = np.where(~ys, ws, 0.0)
        cpos, cneg = np.cumsum(wpos), np.cumsum(wneg)
        # group boundaries where prediction changes
        newv = np.empty(len(p), dtype=bool)
        newv[0] = True
        newv[1:] = p[1:] != p[:-1]
        idx = np.nonzero(newv)[0]
        # per-group sums
        ends = np.append(idx[1:] - 1, len(p) - 1)
        pos_end, neg_end = cpos[ends], cneg[ends]
        pos_start = np.append([0.0], pos_end[:-1])
        neg_start = np.append([0.0], neg_end[:-1])
        g_pos = pos_end - pos_start
        g_neg = neg_end - neg_start
        # positives in a group tie with negatives in the same group: 0.5
        area = np.sum(g_pos * (neg_start + 0.5 * g_neg))
        tot_pos, tot_neg = cpos[-1], cneg[-1]
        if tot_pos <= 0 or tot_neg <= 0:
            return [(self.name, 0.5, True)]
        return [(self.name, float(area / (tot_pos * tot_neg)), True)]


class AveragePrecision(Metric):
    name = "average_precision"
    bigger_is_better = True

    def eval(self, pred):
        y = (self.label > 0).astype(np.float64)
        w = self.weight if self.weight is not None else np.ones(len(y))
        order = np.argsort(-pred, kind="mergesort")
        ys, ws = y[order], w[order]
        tp = np.cumsum(ys * ws)
        denom = np.cumsum(ws)
        prec = tp / denom
        total_pos = tp[-1]
        if total_pos <= 0:
            return [(self.name, 0.0, True)]
        ap = np.sum(prec * ys * ws) / total_pos
        return [(self.name, float(ap), True)]


# -- multiclass (multiclass_metric.hpp) -------------------------------------
class MultiLogloss(Metric):
    name = "multi_logloss"

    def eval(self, pred):
        y = self.label.astype(np.int64)
        eps = 1e-15
        p = np.clip(pred[np.arange(len(y)), y], eps, 1.0)
        return [(self.name, self._avg(-np.log(p)), False)]


class AucMu(Metric):
    """AUC-mu (multiclass_metric.hpp:183, Kleiman & Page 2019): mean over
    class pairs (i, j) of the AUC of samples of those classes ranked by
    their distance from the pair's separating direction,
    ``dist = (v_i - v_j) * (v . raw_score)`` with
    ``v = weights[i] - weights[j]``. Supports the ``auc_mu_weights``
    K*K matrix (row-major, like config.cpp:220-232); default is all-ones
    with a zero diagonal. Ranks raw scores (needs_raw_score), exactly as
    the reference does.
    """
    name = "auc_mu"
    bigger_is_better = True
    needs_raw_score = True

    def _weights_matrix(self, K: int) -> np.ndarray:
        wm = self.cfg.auc_mu_weights
        if wm:
            wm = np.asarray(wm, np.float64)
            if wm.size != K * K:
                raise ValueError(
                    f"auc_mu_weights must have {K * K} entries, got "
                    f"{wm.size}")
            return wm.reshape(K, K)
        out = np.ones((K, K))
        np.fill_diagonal(out, 0.0)
        return out

    def eval(self, score):
        y = self.label.astype(np.int64)
        score = np.asarray(score, np.float64)
        if score.ndim == 1:
            score = score[:, None]
        K = score.shape[1]
        if K < 2:
            raise ValueError(
                "auc_mu requires a multiclass model (num_class >= 2); "
                f"got {K} score column(s)")
        W = self._weights_matrix(K)
        w = self.weight
        ans = 0.0
        for i in range(K):
            mi = y == i
            if not mi.any():
                continue
            for j in range(i + 1, K):
                mj = y == j
                if not mj.any():
                    continue
                v = W[i] - W[j]
                t1 = v[i] - v[j]
                di = t1 * (score[mi] @ v)
                dj = t1 * (score[mj] @ v)
                wi = w[mi] if w is not None else np.ones(int(mi.sum()))
                wj = w[mj] if w is not None else np.ones(int(mj.sum()))
                order = np.argsort(dj, kind="stable")
                djs = dj[order]
                cw = np.concatenate([[0.0], np.cumsum(wj[order])])
                left = np.searchsorted(djs, di, side="left")
                right = np.searchsorted(djs, di, side="right")
                # class-j weight strictly below + half the tied weight
                s = np.sum(wi * (cw[left] + 0.5 * (cw[right] - cw[left])))
                ans += s / (wi.sum() * wj.sum())
        ans = 2.0 * ans / (K * (K - 1))
        return [(self.name, float(ans), True)]


class MultiError(Metric):
    name = "multi_error"

    def eval(self, pred):
        y = self.label.astype(np.int64)
        k = self.cfg.multi_error_top_k
        if k <= 1:
            err = (np.argmax(pred, axis=1) != y).astype(np.float64)
        else:
            topk = np.argpartition(-pred, min(k, pred.shape[1] - 1),
                                   axis=1)[:, :k]
            err = (~(topk == y[:, None]).any(axis=1)).astype(np.float64)
        return [(self.name, self._avg(err), False)]


# -- cross entropy (xentropy_metric.hpp) ------------------------------------
class XentropyMetric(_Pointwise):
    name = "cross_entropy"

    def point(self, p, y):
        eps = 1e-15
        p = np.clip(p, eps, 1 - eps)
        return -(y * np.log(p) + (1 - y) * np.log(1 - p))


class XentLambdaMetric(_Pointwise):
    name = "cross_entropy_lambda"

    def point(self, p, y):
        # NLL in the lambda parameterization: p = 1 - exp(-el), el = e^s;
        # -y log p - (1-y) log(1-p)  =  el - y*log(expm1(el))
        eps = 1e-15
        p = np.clip(p, eps, 1 - eps)
        el = -np.log1p(-p)
        return el - y * np.log(np.expm1(el))


class KullbackLeibler(_Pointwise):
    name = "kldiv"

    def point(self, p, y):
        eps = 1e-15
        p = np.clip(p, eps, 1 - eps)
        yc = np.clip(y, eps, 1 - eps)
        return (yc * np.log(yc / p)
                + (1 - yc) * np.log((1 - yc) / (1 - p)))


# -- ranking (rank_metric.hpp, map_metric.hpp) ------------------------------
class NDCG(Metric):
    name = "ndcg"
    bigger_is_better = True

    def init(self, label, weight, query_boundaries=None):
        super().init(label, weight, query_boundaries)
        if query_boundaries is None:
            raise ValueError("ndcg metric requires query information")
        lg = list(self.cfg.label_gain)
        max_label = int(np.max(label)) if len(label) else 0
        if not lg:
            lg = [(1 << i) - 1 for i in range(max(max_label + 1, 2))]
        self.label_gain = np.asarray(lg, dtype=np.float64)

    def _dcg_at(self, gains_sorted, k):
        top = gains_sorted[:k]
        return np.sum(top / np.log2(np.arange(2, 2 + len(top))))

    def eval(self, pred):
        qb = self.query_boundaries
        ks = [int(k) for k in (self.cfg.eval_at or [1, 2, 3, 4, 5])]
        sums = np.zeros(len(ks))
        nq = len(qb) - 1
        wsum = 0.0
        for q in range(nq):
            lo, hi = qb[q], qb[q + 1]
            y = self.label[lo:hi].astype(np.int64)
            gains = self.label_gain[y]
            order = np.argsort(-pred[lo:hi], kind="mergesort")
            ideal = np.sort(gains)[::-1]
            w = 1.0
            wsum += w
            for i, k in enumerate(ks):
                idcg = self._dcg_at(ideal, k)
                if idcg > 0:
                    sums[i] += w * self._dcg_at(gains[order], k) / idcg
                else:
                    sums[i] += w  # reference counts all-zero queries as 1
        return [(f"ndcg@{k}", float(sums[i] / max(wsum, 1)), True)
                for i, k in enumerate(ks)]


class MAP(Metric):
    name = "map"
    bigger_is_better = True

    def init(self, label, weight, query_boundaries=None):
        super().init(label, weight, query_boundaries)
        if query_boundaries is None:
            raise ValueError("map metric requires query information")

    def eval(self, pred):
        qb = self.query_boundaries
        ks = [int(k) for k in (self.cfg.eval_at or [1, 2, 3, 4, 5])]
        sums = np.zeros(len(ks))
        nq = len(qb) - 1
        for q in range(nq):
            lo, hi = qb[q], qb[q + 1]
            y = (self.label[lo:hi] > 0).astype(np.float64)
            order = np.argsort(-pred[lo:hi], kind="mergesort")
            ys = y[order]
            cum = np.cumsum(ys)
            prec = cum / np.arange(1, len(ys) + 1)
            for i, k in enumerate(ks):
                kk = min(k, len(ys))
                npos = cum[kk - 1]
                if npos > 0:
                    sums[i] += np.sum(prec[:kk] * ys[:kk]) / min(
                        kk, max(1, int(y.sum())))
        return [(f"map@{k}", float(sums[i] / max(nq, 1)), True)
                for i, k in enumerate(ks)]


_REGISTRY = {
    "l2": L2, "mse": L2, "mean_squared_error": L2, "regression": L2,
    "regression_l2": L2,
    "rmse": RMSE, "root_mean_squared_error": RMSE, "l2_root": RMSE,
    "l1": L1, "mae": L1, "mean_absolute_error": L1, "regression_l1": L1,
    "quantile": QuantileMetric,
    "huber": HuberMetric,
    "fair": FairMetric,
    "poisson": PoissonMetric,
    "mape": MAPEMetric, "mean_absolute_percentage_error": MAPEMetric,
    "gamma": GammaMetric,
    "gamma_deviance": GammaDeviance,
    "tweedie": TweedieMetric,
    "binary_logloss": BinaryLogloss, "binary": BinaryLogloss,
    "binary_error": BinaryError,
    "auc": AUC,
    "average_precision": AveragePrecision,
    "multi_logloss": MultiLogloss, "multiclass": MultiLogloss,
    "softmax": MultiLogloss, "multiclassova": MultiLogloss,
    "multi_error": MultiError,
    "auc_mu": AucMu,
    "cross_entropy": XentropyMetric, "xentropy": XentropyMetric,
    "cross_entropy_lambda": XentLambdaMetric, "xentlambda": XentLambdaMetric,
    "kldiv": KullbackLeibler, "kullback_leibler": KullbackLeibler,
    "ndcg": NDCG, "lambdarank": NDCG, "rank_xendcg": NDCG, "xendcg": NDCG,
    "map": MAP, "mean_average_precision": MAP,
}

METRIC_ALIASES = _REGISTRY

_DEFAULT_FOR_OBJECTIVE = {
    "regression": "l2", "regression_l1": "l1", "huber": "huber",
    "fair": "fair", "poisson": "poisson", "quantile": "quantile",
    "mape": "mape", "gamma": "gamma", "tweedie": "tweedie",
    "binary": "binary_logloss", "multiclass": "multi_logloss",
    "multiclassova": "multi_logloss", "cross_entropy": "cross_entropy",
    "cross_entropy_lambda": "cross_entropy_lambda",
    "lambdarank": "ndcg", "rank_xendcg": "ndcg",
}


def create_metrics(cfg: Config) -> List[Metric]:
    """Factory (metric.cpp analog); defaults to the objective's metric."""
    names = cfg.metric
    if isinstance(names, str):
        names = [names] if names else []
    names = [n for n in names if n not in ("", "None", "na", "null",
                                           "custom")]
    if not names:
        default = _DEFAULT_FOR_OBJECTIVE.get(cfg.objective)
        names = [default] if default else []
    out, seen = [], set()
    for n in names:
        if n in ("none",):
            continue
        if n not in _REGISTRY:
            raise ValueError(f"Unknown metric: {n}")
        cls = _REGISTRY[n]
        if cls in seen:
            continue
        seen.add(cls)
        out.append(cls(cfg))
    return out
