"""scikit-learn estimator API.

Port of ``lightgbm_tpu/sklearn.py`` (the reference's
``python-package/lightgbm/sklearn.py`` — ``LGBMModel`` :486,
``LGBMClassifier`` :1314, ``LGBMRegressor`` :1424, ``LGBMRanker``
:1678): the same constructor surface (sklearn-style aliases like
``n_estimators``/``min_child_samples`` resolve through the Config alias
table), fit/predict contract, fitted attributes, eval-set and
early-stopping behavior, and sklearn-style metrics and objectives
wrapped into the engine's ``feval``/``fobj``, driving the port's
Booster. The estimators train on ``device_type`` (a keyword argument;
default ``cuda``, which raises without a GPU). scikit-learn is needed at
import, so the package exports these classes only where it is
installed.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Union

import numpy as np

from sklearn.base import BaseEstimator, ClassifierMixin, RegressorMixin
from sklearn.preprocessing import LabelEncoder

from .callback import record_evaluation
from .dataset import Dataset
from .engine import Booster, train

__all__ = ["LGBMModel", "LGBMClassifier", "LGBMRegressor", "LGBMRanker"]


def _to_array(X):
    if hasattr(X, "values") and hasattr(X, "columns"):
        return X.values
    return np.asarray(X)


class LGBMModel(BaseEstimator):
    """Base estimator (sklearn.py:486 analog)."""

    def __init__(self, boosting_type: str = "gbdt", num_leaves: int = 31,
                 max_depth: int = -1, learning_rate: float = 0.1,
                 n_estimators: int = 100, subsample_for_bin: int = 200000,
                 objective: Optional[Union[str, Callable]] = None,
                 class_weight: Optional[Union[Dict, str]] = None,
                 min_split_gain: float = 0.0, min_child_weight: float = 1e-3,
                 min_child_samples: int = 20, subsample: float = 1.0,
                 subsample_freq: int = 0, colsample_bytree: float = 1.0,
                 reg_alpha: float = 0.0, reg_lambda: float = 0.0,
                 random_state: Optional[int] = None,
                 n_jobs: Optional[int] = None,
                 importance_type: str = "split", **kwargs):
        self.boosting_type = boosting_type
        self.num_leaves = num_leaves
        self.max_depth = max_depth
        self.learning_rate = learning_rate
        self.n_estimators = n_estimators
        self.subsample_for_bin = subsample_for_bin
        self.objective = objective
        self.class_weight = class_weight
        self.min_split_gain = min_split_gain
        self.min_child_weight = min_child_weight
        self.min_child_samples = min_child_samples
        self.subsample = subsample
        self.subsample_freq = subsample_freq
        self.colsample_bytree = colsample_bytree
        self.reg_alpha = reg_alpha
        self.reg_lambda = reg_lambda
        self.random_state = random_state
        self.n_jobs = n_jobs
        self.importance_type = importance_type
        self._other_params: Dict[str, Any] = dict(kwargs)
        for k, v in kwargs.items():
            setattr(self, k, v)

    # -- sklearn plumbing ---------------------------------------------
    def get_params(self, deep: bool = True) -> Dict[str, Any]:
        params = super().get_params(deep=deep)
        params.update(self._other_params)
        return params

    def set_params(self, **params):
        for k, v in params.items():
            setattr(self, k, v)
            if k not in self._sk_ctor_names():
                self._other_params[k] = v
        return self

    @classmethod
    def _sk_ctor_names(cls):
        import inspect
        return set(inspect.signature(LGBMModel.__init__).parameters) - \
            {"self", "kwargs"}

    def _process_params(self, default_objective: str) -> Dict[str, Any]:
        params = self.get_params()
        params.pop("importance_type", None)
        params.pop("n_estimators", None)
        params.pop("class_weight", None)
        obj = params.pop("objective", None) or default_objective
        if callable(obj):
            self._fobj_callable = obj
            obj = "custom"
        else:
            self._fobj_callable = None
        params["objective"] = obj
        params.pop("n_jobs", None)  # the card sets the parallelism
        rs = params.pop("random_state", None)
        if rs is not None:
            if isinstance(rs, np.random.RandomState):
                params["seed"] = int(rs.randint(2 ** 31))
            elif isinstance(rs, getattr(np.random, "Generator", ())):
                params["seed"] = int(rs.integers(2 ** 31))
            else:
                params["seed"] = int(rs)
        params["boosting"] = params.pop("boosting_type", "gbdt")
        params.setdefault("verbosity", -1)
        # sklearn names that Config resolves via aliases: subsample,
        # colsample_bytree, reg_alpha, reg_lambda, min_child_samples,
        # min_child_weight, min_split_gain, subsample_for_bin pass through
        return {k: v for k, v in params.items() if v is not None}

    # -- fit ----------------------------------------------------------
    def fit(self, X, y, sample_weight=None, init_score=None, group=None,
            eval_set=None, eval_names=None, eval_sample_weight=None,
            eval_init_score=None, eval_group=None, eval_metric=None,
            feature_name="auto", categorical_feature="auto",
            callbacks=None, init_model=None):
        params = self._process_params(self._default_objective())
        if eval_metric is not None and not callable(eval_metric):
            params["metric"] = eval_metric
        y_arr = self._prepare_targets(np.asarray(_to_array(y)).reshape(-1),
                                      params)

        sw = sample_weight
        if getattr(self, "_class_weight_arr", None) is not None:
            cw = self._class_weight_arr[self._le.transform(
                np.asarray(_to_array(y)).reshape(-1))]
            sw = cw if sw is None else np.asarray(sw) * cw

        train_set = Dataset(X, label=y_arr, weight=sw, group=group,
                            init_score=init_score, feature_name=feature_name,
                            categorical_feature=categorical_feature,
                            params=dict(params), free_raw_data=False)
        valid_sets: List[Dataset] = []
        names: List[str] = []
        if eval_set is not None:
            if isinstance(eval_set, tuple):
                eval_set = [eval_set]
            for i, (vx, vy) in enumerate(eval_set):
                vy_arr = np.asarray(_to_array(vy)).reshape(-1)
                if hasattr(self, "_le"):
                    vy_arr = self._le.transform(vy_arr)
                vw = (eval_sample_weight[i]
                      if eval_sample_weight is not None else None)
                vis = (eval_init_score[i]
                       if eval_init_score is not None else None)
                vg = eval_group[i] if eval_group is not None else None
                valid_sets.append(Dataset(
                    vx, label=vy_arr, weight=vw, group=vg, init_score=vis,
                    reference=train_set))
                names.append(eval_names[i] if eval_names and
                             i < len(eval_names) else f"valid_{i}")

        callbacks = list(callbacks or [])
        self._evals_result: Dict = {}
        if valid_sets:
            callbacks.append(record_evaluation(self._evals_result))

        feval = None
        if callable(eval_metric):
            feval = _wrap_sklearn_metric(eval_metric)

        fobj = None
        if self._fobj_callable is not None:
            fobj = _wrap_sklearn_objective(self._fobj_callable)

        self._Booster = train(
            params, train_set, num_boost_round=self.n_estimators,
            valid_sets=valid_sets or None, valid_names=names or None,
            callbacks=callbacks, feval=feval, fobj=fobj,
            init_model=init_model)
        self._n_features = train_set.num_total_features
        self._feature_name = list(train_set.feature_name)
        self.fitted_ = True
        return self

    def _default_objective(self) -> str:
        return "regression"

    def _prepare_targets(self, y: np.ndarray, params: Dict) -> np.ndarray:
        return np.asarray(y, np.float64)

    # -- predict ------------------------------------------------------
    def predict(self, X, raw_score: bool = False, start_iteration: int = 0,
                num_iteration: Optional[int] = None, pred_leaf: bool = False,
                pred_contrib: bool = False, **kwargs):
        self._check_fitted()
        return self._Booster.predict(
            X, raw_score=raw_score, start_iteration=start_iteration,
            num_iteration=num_iteration, pred_leaf=pred_leaf,
            pred_contrib=pred_contrib, **kwargs)

    def _check_fitted(self):
        if not getattr(self, "fitted_", False):
            raise _NotFittedError(
                f"This {type(self).__name__} instance is not fitted yet. "
                "Call 'fit' with appropriate arguments before using this "
                "estimator.")

    # -- fitted attributes (sklearn.py:940-1030 analog) ---------------
    @property
    def booster_(self) -> Booster:
        self._check_fitted()
        return self._Booster

    @property
    def evals_result_(self) -> Dict:
        self._check_fitted()
        return self._evals_result

    @property
    def n_features_(self) -> int:
        self._check_fitted()
        return self._n_features

    @property
    def n_features_in_(self) -> int:
        return self.n_features_

    @property
    def best_iteration_(self) -> int:
        self._check_fitted()
        return self._Booster.best_iteration

    @property
    def best_score_(self) -> Dict:
        self._check_fitted()
        return self._Booster.best_score

    @property
    def feature_importances_(self) -> np.ndarray:
        self._check_fitted()
        return self._Booster.feature_importance(self.importance_type)

    @property
    def feature_name_(self) -> List[str]:
        self._check_fitted()
        return self._feature_name

    @property
    def n_estimators_(self) -> int:
        self._check_fitted()
        return self._Booster.current_iteration()

    @property
    def n_iter_(self) -> int:
        return self.n_estimators_


class _NotFittedError(ValueError, AttributeError):
    """sklearn.exceptions.NotFittedError-compatible."""


try:
    from sklearn.exceptions import NotFittedError as _NotFittedError  # noqa
except ImportError:  # pragma: no cover
    pass


def _wrap_sklearn_metric(func):
    """Adapt sklearn-style feval(y_true, y_pred) -> engine feval."""
    def feval(preds, dataset):
        y_true = dataset.get_label()
        res = func(y_true, preds)
        if isinstance(res, tuple) and len(res) == 3:
            return res
        return [r for r in res]
    return feval


def _wrap_sklearn_objective(func):
    """Adapt sklearn-style fobj(y_true, y_pred) -> engine fobj."""
    def fobj(preds, dataset):
        return func(dataset.get_label(), preds)
    return fobj


class LGBMRegressor(RegressorMixin, LGBMModel):
    """sklearn.py:1424 analog."""

    def _default_objective(self) -> str:
        return "regression"

    def fit(self, X, y, sample_weight=None, init_score=None, eval_set=None,
            eval_names=None, eval_sample_weight=None, eval_init_score=None,
            eval_metric=None, feature_name="auto",
            categorical_feature="auto", callbacks=None, init_model=None):
        return super().fit(
            X, y, sample_weight=sample_weight, init_score=init_score,
            eval_set=eval_set, eval_names=eval_names,
            eval_sample_weight=eval_sample_weight,
            eval_init_score=eval_init_score, eval_metric=eval_metric,
            feature_name=feature_name,
            categorical_feature=categorical_feature, callbacks=callbacks,
            init_model=init_model)


class LGBMClassifier(ClassifierMixin, LGBMModel):
    """sklearn.py:1314 analog: label encoding, predict_proba, classes_."""

    def _default_objective(self) -> str:
        return "binary"

    def _prepare_targets(self, y: np.ndarray, params: Dict) -> np.ndarray:
        self._le = LabelEncoder().fit(y)
        self._classes = self._le.classes_
        self._n_classes = len(self._classes)
        if self._n_classes > 2:
            if params.get("objective") in (None, "binary", "custom"):
                if params.get("objective") != "custom":
                    params["objective"] = "multiclass"
            params["num_class"] = self._n_classes
        elif params.get("objective") not in ("custom",):
            params.setdefault("objective", "binary")
        # class_weight='balanced' or dict -> per-class sample weights
        cw = self.class_weight
        if cw is not None:
            from sklearn.utils.class_weight import compute_class_weight
            if isinstance(cw, str):
                arr = compute_class_weight(cw, classes=self._classes, y=y)
            else:
                arr = np.asarray([cw.get(c, 1.0) for c in self._classes],
                                 np.float64)
            self._class_weight_arr = arr
        else:
            self._class_weight_arr = None
        return self._le.transform(y).astype(np.float64)

    def fit(self, X, y, sample_weight=None, init_score=None, eval_set=None,
            eval_names=None, eval_sample_weight=None, eval_init_score=None,
            eval_metric=None, feature_name="auto",
            categorical_feature="auto", callbacks=None, init_model=None):
        return super().fit(
            X, y, sample_weight=sample_weight, init_score=init_score,
            eval_set=eval_set, eval_names=eval_names,
            eval_sample_weight=eval_sample_weight,
            eval_init_score=eval_init_score, eval_metric=eval_metric,
            feature_name=feature_name,
            categorical_feature=categorical_feature, callbacks=callbacks,
            init_model=init_model)

    def predict(self, X, raw_score: bool = False, start_iteration: int = 0,
                num_iteration: Optional[int] = None, pred_leaf: bool = False,
                pred_contrib: bool = False, **kwargs):
        result = self.predict_proba(
            X, raw_score=raw_score, start_iteration=start_iteration,
            num_iteration=num_iteration, pred_leaf=pred_leaf,
            pred_contrib=pred_contrib, **kwargs)
        if raw_score or pred_leaf or pred_contrib:
            return result
        if result.ndim == 1:  # binary probabilities of class 1
            idx = (result >= 0.5).astype(int)
        else:
            idx = np.argmax(result, axis=1)
        return self._classes[idx]

    def predict_proba(self, X, raw_score: bool = False,
                      start_iteration: int = 0,
                      num_iteration: Optional[int] = None,
                      pred_leaf: bool = False, pred_contrib: bool = False,
                      **kwargs):
        self._check_fitted()
        res = self._Booster.predict(
            X, raw_score=raw_score, start_iteration=start_iteration,
            num_iteration=num_iteration, pred_leaf=pred_leaf,
            pred_contrib=pred_contrib, **kwargs)
        if raw_score or pred_leaf or pred_contrib:
            return res
        if res.ndim == 1:
            return np.stack([1.0 - res, res], axis=1) \
                if self._n_classes <= 2 else res
        return res

    @property
    def classes_(self) -> np.ndarray:
        self._check_fitted()
        return self._classes

    @property
    def n_classes_(self) -> int:
        self._check_fitted()
        return self._n_classes


class LGBMRanker(LGBMModel):
    """sklearn.py:1678 analog (lambdarank)."""

    def _default_objective(self) -> str:
        return "lambdarank"

    def fit(self, X, y, sample_weight=None, init_score=None, group=None,
            eval_set=None, eval_names=None, eval_sample_weight=None,
            eval_init_score=None, eval_group=None, eval_metric=None,
            eval_at=(1, 2, 3, 4, 5), feature_name="auto",
            categorical_feature="auto", callbacks=None, init_model=None):
        if group is None:
            raise ValueError("Should set group for ranking task")
        if eval_set is not None and eval_group is None:
            raise ValueError("Eval_group cannot be None when eval_set is "
                             "not None")
        self._other_params["eval_at"] = list(eval_at)
        return super().fit(
            X, y, sample_weight=sample_weight, init_score=init_score,
            group=group, eval_set=eval_set, eval_names=eval_names,
            eval_sample_weight=eval_sample_weight,
            eval_init_score=eval_init_score, eval_group=eval_group,
            eval_metric=eval_metric, feature_name=feature_name,
            categorical_feature=categorical_feature, callbacks=callbacks,
            init_model=init_model)
