"""Booster + train()/cv() — the user-facing entry points.

Port of ``lightgbm_tpu/engine.py``: ``train`` (``engine.py:1239``) with
its eval-cadence contract, custom objectives (``fobj``, or a callable
``objective``), continued training (``init_model``), periodic
snapshots (``snapshot_freq``), full-state checkpoints and ``resume``,
the preemption drain, ``nan_guard=rollback`` and the
``on_device_loss=degrade`` supervisor (``:1266-1560``; the telemetry
hooks are not ported); ``Booster`` (``:78``) with ``update(train_set, fobj)``
(``:213``), ``predict`` (``:355``, the device walk of
``ops/predict_ensemble.py``), ``pred_leaf``/``pred_contrib``/
``pred_early_stop``, ``model_to_string`` (``:761``), ``dump_model``
(``:814``), ``save_model`` (``:868``), loading from
``model_file``/``model_str``, ``reset_parameter`` (``:246``),
``rollback_one_iter`` (``:252``), ``refit`` (``:260``) and the model
methods of ``:986-1111``; ``PredictSession`` (``:1114``); ``cv`` and
``CVBooster`` (``:1628-1792``). The booster comes from
``create_boosting`` (GBDT, DART or RF); an RF model predicts the mean of
its trees (``average_output``, written into and read from the model
text). Model text is the JAX package's LightGBM-v4 format, so either
package loads the other's models.

Training and prediction run on ``device_type`` (default ``cuda``, which
raises without a GPU; ``cpu`` runs the plain PyTorch versions).
"""

from __future__ import annotations

import collections
import copy
import json
import os
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from . import log, profiler
from .boosting import GBDT, create_boosting
from .callback import CallbackEnv, EarlyStopException
from .config import Config, parse_params, resolve_device
from .dataset import (Dataset, _data_from_pandas, _is_pandas_df, _is_sparse,
                      _json_scalar, _to_2d_float)
from .metrics import Metric, create_metrics
from .objectives import Objective, create_objective
from .ops.predict_ensemble import (pack_ensemble, predict_leaf, predict_raw,
                                   predict_raw_early_stop)
from .ops.split import leaf_output
from .tree import Tree

__all__ = ["Booster", "CVBooster", "PredictSession", "cv", "train"]

# dense bytes of one row block of a sparse predict or refit input
_SPARSE_BLOCK_BYTES = 64 << 20


class Booster:
    """Trained/trainable model handle (basic.py:3586 analog)."""

    # what reset_parameter may change once the Booster is built
    _RESETTABLE = ("learning_rate",)

    def __init__(self, params: Optional[Dict] = None,
                 train_set: Optional[Dataset] = None,
                 model_file: Optional[str] = None,
                 model_str: Optional[str] = None):
        self.params = dict(params or {})
        self.best_iteration = -1
        self.best_score: Dict = {}
        self._model_version = 0
        self._pack = None            # ((version, lo, hi, device), packed)
        self._device = None
        self._average_output = False  # RF mode (rf.hpp average_output_)
        self._valid_names: List[str] = []
        self._valid_sets: List[Dataset] = []
        self._gbdt: Optional[GBDT] = None
        self._trees: List[Tree] = []
        # continued training (init_model): the base model's trees and
        # the per-row raw scores the booster starts from
        self._base_trees: List[Tree] = []
        self._pending_init_scores = None
        self._pending_valid_init_scores: List = []
        self._num_class = 1
        self._objective_name = "regression"
        self._feature_names: List[str] = []
        self._feature_infos: List[str] = []
        self._max_feature_idx = 0
        self._metrics: List[Metric] = []
        self._pandas_categorical = None
        if model_file is not None:
            with open(model_file) as f:
                self._load_from_string(f.read())
            return
        if model_str is not None:
            self._load_from_string(model_str)
            return
        if train_set is None:
            raise ValueError("Booster needs train_set, model_file or "
                             "model_str")
        if not isinstance(train_set, Dataset):
            raise TypeError("train_set should be a Dataset instance")
        self.config = Config(self.params)
        # the Dataset resolves the device (and raises without a GPU
        # unless device_type="cpu"); training runs where it lives
        train_set.params = {**self.params, **train_set.params}
        train_set.construct()
        self._objective: Optional[Objective] = create_objective(self.config)
        self._objective_name = (self._objective.name if self._objective
                                else "custom")
        self._num_class = self.config.num_class
        self.train_set = train_set
        self._metrics = create_metrics(self.config)
        self._feature_names = list(train_set.feature_name)
        self._max_feature_idx = train_set.num_total_features - 1
        self._pandas_categorical = train_set.pandas_categorical

    # -- training ------------------------------------------------------
    def _set_init_model(self, base: "Booster", train_scores=None,
                        valid_scores=None):
        """Continued training from ``base`` (engine.py:149-175): the
        scores start from its raw predictions, given (``train`` predicts
        them before construction frees the raw data) or predicted here
        from Datasets built with ``free_raw_data=False``."""
        if self._gbdt is not None:
            raise RuntimeError("init_model must be set before training")

        def raw_of(ds: Dataset, what: str):
            if ds._raw_data is None:
                raise ValueError(
                    f"Continued training needs the {what} raw data; "
                    "construct the Dataset with free_raw_data=False")
            return ds._raw_data
        if train_scores is None:
            train_scores = base.predict(raw_of(self.train_set, "training"),
                                        raw_score=True)
        if valid_scores is None:
            valid_scores = [
                base.predict(raw_of(vs, "validation"), raw_score=True)
                for vs in self._valid_sets]
        self._pending_init_scores = train_scores
        self._pending_valid_init_scores = list(valid_scores)
        self._base_trees = [copy.deepcopy(t) for t in base._all_trees()]
        self._average_output = base._average_output

    def _ensure_gbdt(self):
        if self._gbdt is None:
            self._gbdt = create_boosting(
                self.config, self.train_set, self._objective,
                self._valid_sets,
                init_row_scores=self._pending_init_scores,
                valid_init_row_scores=self._pending_valid_init_scores,
                num_init_iteration=(len(self._base_trees)
                                    // max(1, self._num_class)))
            if not self._base_trees:
                self._average_output = getattr(self._gbdt, "average_output",
                                               False)
            self._trees = self._gbdt.models
            # under a row-sharded plan every rank evaluates the global
            # rows (eval_scores gathers them), so every rank sees the
            # same metric values and early stopping stops every rank at
            # the same iteration
            rows = self._gbdt.global_rows
            self._train_metrics_ready = False
            self._valid_metrics = []
            for vs in self._valid_sets:
                ms = create_metrics(self.config)
                for m in ms:
                    m.init(rows(vs.get_label()), rows(vs.get_weight()),
                           vs.query_boundaries())
                self._valid_metrics.append(ms)

    def add_valid(self, data: Dataset, name: str):
        if self._gbdt is not None:
            raise RuntimeError("add_valid must be called before training "
                               "starts")
        data.reference = self.train_set
        data.params = {**self.params, **data.params}
        data.construct()
        self._valid_sets.append(data)
        self._valid_names.append(name)
        return self

    def update(self, train_set=None, fobj: Optional[Callable] = None, *,
               defer: bool = False):
        """One boosting iteration; True if stopped (no more splits).
        ``defer=True`` leaves the tree on the device until the next sync
        point (returns None). ``fobj(preds, train_set)`` returns the
        gradients and hessians of a custom objective (``objective=
        "custom"``), flat class-major or [n, K]; its iteration runs the
        eager loop and syncs."""
        self._ensure_gbdt()
        self._model_version += 1
        if fobj is not None:
            if self._objective is not None:
                raise ValueError(
                    "Custom objective requires objective='custom' in params "
                    "(c_api LGBM_BoosterUpdateOneIterCustom contract)")
            grad, hess = fobj(self._current_pred_for_fobj(), self.train_set)
            return self._gbdt.train_one_iter(grad, hess)
        return self._gbdt.train_one_iter(defer=defer)

    def _current_pred_for_fobj(self):
        """The scores a custom objective sees: [n], or [n, K] with K > 1
        (DART drops its trees first; dart.hpp GetTrainingScore)."""
        return self._gbdt.get_training_scores().squeeze()

    def reset_parameter(self, params: Dict):
        """Change parameters for the iterations to come (engine.py:
        246-250; the ``reset_parameter`` callback calls it before an
        iteration). The learning rate reaches the next tree through the
        booster's shrinkage, which the step rereads into its
        learning-rate buffer before each replay. Every other parameter
        is fixed once the Booster is built (the objective, metrics and
        Dataset read it at construction, and the step bakes it into its
        graph and static buffers): changing one raises
        NotImplementedError naming it, and nothing is applied."""
        new = parse_params(params)
        fixed = sorted(k for k, v in new.items()
                       if k not in self._RESETTABLE
                       and not k.startswith("_")
                       and self.config.get(k) != v)
        if fixed:
            raise NotImplementedError(
                "reset_parameter cannot change " + ", ".join(fixed)
                + " once the Booster is built; only "
                + ", ".join(self._RESETTABLE) + " can change")
        self.params.update(params)
        self.config.set(**params)
        if self._gbdt is not None:
            self._gbdt.shrinkage = self.config.learning_rate

    def _sync_trees(self):
        if self._gbdt is not None:
            self._gbdt.sync()

    def rollback_one_iter(self):
        """Undo the newest iteration (LGBM_BoosterRollbackOneIter,
        gbdt.cpp:454)."""
        self._ensure_gbdt()
        self._gbdt.rollback_one_iter()
        self._model_version += 1
        return self

    def refit(self, data, label, decay_rate: Optional[float] = None,
              **kwargs) -> "Booster":
        """A new Booster with this model's tree structures and leaf
        values refit to ``data``/``label`` (engine.py:260-311; gbdt.cpp:
        258 RefitTree): tree by tree, the objective's gradients at the
        running score, per-leaf sums and the new outputs, all on the
        device in float64 (the JAX package takes its gradients in
        float32), over the leaves of the device walk; new output =
        decay * old + (1 - decay) * shrinkage * leaf_output."""
        cfg = Config(self.params)
        if decay_rate is None:
            decay_rate = float(cfg.refit_decay_rate)
        if isinstance(data, Dataset):
            raise TypeError("Cannot refit on a Dataset; pass the raw matrix")
        y = np.asarray(label, np.float64).reshape(-1)
        objective = create_objective(cfg)
        if objective is None:
            raise ValueError("Cannot refit with a custom objective")
        new_booster = Booster(model_str=self.model_to_string(),
                              params=dict(self.params))
        trees = new_booster._all_trees()
        K = max(1, self._num_class)
        objective.init(y, kwargs.get("weight"), None)
        dev = new_booster._predict_device()
        f64 = torch.float64
        packed = pack_ensemble(trees, dev)
        leaves = torch.cat([predict_leaf(packed, torch.from_numpy(X).to(dev))
                            for X in self._row_blocks(data)]).long()
        y_dev = torch.from_numpy(y).to(dev)
        scores = torch.zeros((K, leaves.shape[0]), dtype=f64, device=dev)
        for it in range(len(trees) // K):
            # gradients at the running score (the RefitTree loop)
            for k in range(K):
                i = it * K + k
                tree = trees[i]
                if K > 1:
                    g, h = objective.get_gradients(scores, y_dev, None)
                    g, h = g[k], h[k]
                else:
                    g, h = objective.get_gradients(scores[0], y_dev, None)
                lf = leaves[:, i]
                nl = tree.num_leaves
                sg = torch.zeros(nl, dtype=f64, device=dev).index_add_(
                    0, lf, g)
                sh = torch.zeros(nl, dtype=f64, device=dev).index_add_(
                    0, lf, h) + 1e-15
                new_out = leaf_output(sg, sh, cfg.lambda_l1, cfg.lambda_l2,
                                      cfg.max_delta_step) * tree.shrinkage
                tree.leaf_value = (decay_rate * tree.leaf_value
                                   + (1.0 - decay_rate)
                                   * new_out.cpu().numpy())
                scores[k] += torch.from_numpy(tree.leaf_value).to(dev)[lf]
        return new_booster

    # -- evaluation ----------------------------------------------------
    def _converted(self, raw: np.ndarray) -> np.ndarray:
        if self._objective is not None and self._objective.needs_convert:
            return self._objective.convert_output(raw)
        return raw

    def eval_train(self, feval=None):
        return self._eval_set(-1, "training", feval)

    def eval_valid(self, feval=None):
        out = []
        for i in range(len(self._valid_sets)):
            out.extend(self._eval_set(i, self._valid_names[i], feval))
        return out

    def _eval_set(self, which: int, name: str, feval=None):
        self._ensure_gbdt()
        raw = self._gbdt.eval_scores(which)
        if raw.shape[1] == 1:
            raw = raw[:, 0]
        pred = self._converted(raw)
        if which < 0 and not self._train_metrics_ready:
            # the training metrics read the train set's labels, gathered
            # under a row-sharded plan: only once one is asked for
            rows = self._gbdt.global_rows
            for m in self._metrics:
                m.init(rows(self.train_set.get_label()),
                       rows(self.train_set.get_weight()),
                       self.train_set.query_boundaries())
            self._train_metrics_ready = True
        metrics = self._metrics if which < 0 else self._valid_metrics[which]
        out = []
        for m in metrics:
            # auc_mu ranks raw scores; every other metric reads the
            # converted output
            inp = raw if getattr(m, "needs_raw_score", False) else pred
            for mname, value, bigger in m.eval(np.asarray(inp, np.float64)):
                out.append((name, mname, value, bigger))
        if feval is not None:
            ds = self.train_set if which < 0 else self._valid_sets[which]
            for fm in (feval if isinstance(feval, list) else [feval]):
                res = fm(raw, ds)
                for mname, value, bigger in (res if isinstance(res, list)
                                             else [res]):
                    out.append((name, mname, value, bigger))
        return out

    # -- prediction ----------------------------------------------------
    def _all_trees(self) -> List[Tree]:
        """The model's trees: continued training's base trees, then the
        trees trained here."""
        return self._base_trees + self._trees

    def _predict_device(self) -> torch.device:
        """The device predictions run on, resolved once: the CUDA
        current device is thread-local, and batcher threads predict."""
        if self._device is None:
            self._device = (self._gbdt.device if self._gbdt is not None
                            else resolve_device(
                                Config(self.params).device_type))
        return self._device

    def _window(self, start_iteration: int, num_iteration: Optional[int],
                n_trees: int):
        """Tree slice ``(lo, hi)`` of an iteration window (shared by
        predict, PredictSession and CompiledEnsemble)."""
        K = max(1, self._num_class)
        if num_iteration is None or num_iteration < 0:
            num_iteration = (self.best_iteration if self.best_iteration > 0
                             else n_trees // K)
        lo = start_iteration * K
        return lo, min(n_trees, (start_iteration + num_iteration) * K)

    def predict(self, data, start_iteration: int = 0,
                num_iteration: Optional[int] = None,
                raw_score: bool = False, pred_leaf: bool = False,
                pred_contrib: bool = False, **kwargs) -> np.ndarray:
        """Batch prediction on raw features (gbdt_prediction.cpp /
        predictor.hpp analog): every tree walks on the device in float64;
        per-class sums in float64. ``pred_leaf`` gives the walk's [n, T]
        leaf indices; ``pred_contrib`` TreeSHAP on the host."""
        self._sync_trees()
        if _is_sparse(data):
            return np.concatenate([
                self.predict(X, start_iteration, num_iteration, raw_score,
                             pred_leaf, pred_contrib, **kwargs)
                for X in self._row_blocks(data)])
        X = self._as_matrix(data)
        if X.shape[1] != self._max_feature_idx + 1 and not (
                kwargs.get("predict_disable_shape_check")
                or self.params.get("predict_disable_shape_check")):
            raise ValueError(
                f"The number of features in data ({X.shape[1]}) is not the "
                f"same as it was in training data "
                f"({self._max_feature_idx + 1}).")
        K = max(1, self._num_class)
        version = self._model_version
        trees = self._all_trees()
        lo, hi = self._window(start_iteration, num_iteration, len(trees))
        use = trees[lo:hi]
        if pred_leaf:
            if not use:
                return np.zeros((X.shape[0], 0), np.int32)
            dev = self._predict_device()
            return predict_leaf(self._packed_for(use, lo, version),
                                torch.from_numpy(X).to(dev)).cpu().numpy()
        if pred_contrib:
            # TreeSHAP (tree.h:141 PredictContrib), host numpy as in the
            # JAX package: per-class [n, n_features+1] blocks, last
            # column = expected value
            nf = X.shape[1]
            out = np.zeros((X.shape[0], K * (nf + 1)))
            for i, t in enumerate(use):
                k = (lo + i) % K
                out[:, k * (nf + 1):(k + 1) * (nf + 1)] += \
                    t.predict_contrib(X)
            if self._average_output and use:
                out /= len(use) // K
            return out
        raw = self._predict_raw_scores(X, use, lo, K, version,
                                       self._early_stop_config(kwargs))
        return self._finalize_scores(raw, use, K, raw_score)

    def _row_blocks(self, data):
        """The rows of a predict or refit input as [n_i, F] float64
        blocks, in order: a scipy sparse matrix in CSR row blocks of
        ``_SPARSE_BLOCK_BYTES`` dense (the whole matrix never is), any
        other input in
        one block (:meth:`_as_matrix`)."""
        if not _is_sparse(data):
            yield self._as_matrix(data)
            return
        csr = data.tocsr()
        step = max(1, _SPARSE_BLOCK_BYTES // (8 * max(1, csr.shape[1])))
        for i in range(0, max(1, csr.shape[0]), step):
            yield csr[i:i + step].toarray()

    def _as_matrix(self, data) -> np.ndarray:
        """[n, F] float64 of a dense predict or refit input
        (engine.py:736): a data file (predictor.hpp:30; read with this
        Booster's ``header`` and column parameters, the label column
        dropped and a LibSVM file padded to the model's width), a
        DataFrame (its category columns aligned to the model's training
        lists; a model trained without pandas aligns against none, so a
        categorical frame raises), a pyarrow Table or an array. Sparse
        input goes through :meth:`_row_blocks`."""
        if isinstance(data, Dataset):
            raise TypeError("Cannot predict on a Dataset; pass the raw "
                            "matrix")
        if isinstance(data, (str, os.PathLike)):
            from .io import load_data_file
            return load_data_file(
                data, Config(self.params),
                num_features_hint=len(self._feature_names)).X
        if _is_pandas_df(data):
            return _data_from_pandas(data, self._pandas_categorical or [])[0]
        return _to_2d_float(data)

    def _finalize_scores(self, raw, use, K, raw_score):
        """RAW [n, K] -> user-facing predictions: RF averaging, class
        squeeze, objective transform (shared with PredictSession and
        CompiledEnsemble)."""
        if self._average_output and use:
            raw /= len(use) // K
        if K == 1:
            raw = raw[:, 0]
        if raw_score:
            return raw
        return self._converted(raw)

    def _packed_for(self, use, lo: int, version: int):
        """The packed ensemble of ``use`` on the predict device, cached
        under ``(version, lo, hi, device)``. Key and pack are published
        as ONE tuple, so a thread never pairs a matched key with another
        thread's newer pack."""
        dev = self._predict_device()
        key = (version, lo, lo + len(use), str(dev))
        got = self._pack
        if got is None or got[0] != key:
            got = (key, pack_ensemble(use, dev))
            self._pack = got
        return got[1]

    # objectives whose predictions tolerate early stopping — the ones
    # overriding NeedAccuratePrediction() to false (binary_objective.hpp
    # :188, multiclass_objective.hpp:153,259, rank_objective.hpp:108)
    _EARLY_STOP_OBJECTIVES = ("binary", "multiclass", "multiclassova",
                              "lambdarank", "rank_xendcg")

    def _early_stop_config(self, kwargs):
        """(freq, margin) when pred_early_stop applies, else None."""
        def get(name, default):
            if name in kwargs:
                return kwargs[name]
            return self.params.get(name, default)
        if not get("pred_early_stop", False):
            return None
        if self._objective_name not in self._EARLY_STOP_OBJECTIVES:
            return None
        freq = int(get("pred_early_stop_freq", 10))
        margin = float(get("pred_early_stop_margin", 10.0))
        if freq <= 0 or margin < 0:
            raise ValueError(
                "pred_early_stop_freq must be > 0 and "
                "pred_early_stop_margin >= 0")
        return freq, margin

    def _predict_raw_scores(self, X: np.ndarray, use, lo: int, K: int,
                            version: int, early_stop=None) -> np.ndarray:
        """[n, K] float64 raw scores of the trees ``use`` (``lo`` is the
        first one's index; ``version`` keys the pack cache)."""
        if not use:
            return np.zeros((X.shape[0], K))
        ens = self._packed_for(use, lo, version)
        Xd = torch.from_numpy(X).to(self._predict_device())
        cls = np.arange(lo, lo + len(use)) % K
        if early_stop is not None and len(use) >= K:
            raw = predict_raw_early_stop(ens, Xd, cls, K, *early_stop)
        else:
            raw = predict_raw(ens, Xd, cls, K)
        return raw.cpu().numpy()

    def predict_session(self, **kwargs) -> "PredictSession":
        """A persistent :class:`PredictSession` bound to this model —
        the serving entry point for repeated predict() calls."""
        return PredictSession(self, **kwargs)

    # -- model IO (gbdt_model_text.cpp analog) -------------------------
    def model_to_string(self, num_iteration: Optional[int] = None,
                        start_iteration: int = 0,
                        importance_type: str = "split") -> str:
        self._sync_trees()
        K = max(1, self._num_class)
        trees = self._all_trees()
        if num_iteration is not None and num_iteration > 0:
            trees = trees[: num_iteration * K]
        header = [
            "tree",
            "version=v4",
            f"num_class={self._num_class}",
            f"num_tree_per_iteration={K}",
            "label_index=0",
            f"max_feature_idx={self._max_feature_idx}",
            f"objective={self._objective_text()}",
        ]
        if self._average_output:
            header.append("average_output")  # the RF marker line
        header += [
            "feature_names=" + " ".join(self._feature_names),
            "feature_infos=" + " ".join(self._feature_infos_list()),
            "",
        ]
        blocks = [t.to_text(i) for i, t in enumerate(trees)]
        sizes = [len(b.encode()) + 1 for b in blocks]
        header.insert(-1, "tree_sizes=" + " ".join(str(s) for s in sizes))
        body = "\n".join(blocks)
        tail = ["", "end of trees", ""]
        imp = self.feature_importance(importance_type)
        order = np.argsort(-imp, kind="stable")
        tail.append("feature_importances:")
        for i in order:
            if imp[i] > 0:
                tail.append(f"{self._feature_names[i]}={imp[i]:g}")
        tail += ["", "parameters:"]
        for key, val in sorted(self.params.items()):
            tail.append(f"[{key}: {val}]")
        pc = (json.dumps(self._pandas_categorical, default=_json_scalar)
              if self._pandas_categorical else "null")
        tail += ["end of parameters", "", "pandas_categorical:" + pc, ""]
        return "\n".join(header) + "\n" + body + "\n".join(tail)

    def dump_model(self, num_iteration: Optional[int] = None,
                   start_iteration: int = 0,
                   importance_type: str = "split") -> Dict[str, Any]:
        """The model as a JSON-ready dict (GBDT::DumpModel; the JAX
        package's engine.py:814-866, the reference Python package's
        schema)."""
        self._sync_trees()
        K = max(1, self._num_class)
        trees = self._all_trees()
        start_iteration = min(max(start_iteration, 0), len(trees) // K)
        start = start_iteration * K
        end = len(trees)
        if num_iteration is not None and num_iteration > 0:
            end = min(start + num_iteration * K, end)
        feature_infos = {}
        for name, info in zip(self._feature_names,
                              self._feature_infos_list()):
            if info == "none":
                continue
            if info.startswith("["):
                lo, hi = info[1:-1].split(":")
                feature_infos[name] = {"min_value": float(lo),
                                       "max_value": float(hi),
                                       "values": []}
            else:
                vals = [int(v) for v in info.split(":")]
                feature_infos[name] = {"min_value": min(vals),
                                       "max_value": max(vals),
                                       "values": vals}
        imp = self.feature_importance(importance_type)
        return {
            "name": "tree",
            "version": "v4",
            "num_class": self._num_class,
            "num_tree_per_iteration": K,
            "label_index": 0,
            "max_feature_idx": self._max_feature_idx,
            "objective": self._objective_text(),
            "average_output": bool(self._average_output),
            "feature_names": list(self._feature_names),
            "monotone_constraints": [
                int(v) for v in
                (Config(self.params).monotone_constraints or [])],
            "feature_infos": feature_infos,
            "tree_info": [
                dict(tree_index=i, **t.to_json())
                for i, t in enumerate(trees[start:end], start=start)],
            "feature_importances": {
                self._feature_names[i]: float(imp[i])
                for i in np.argsort(-imp, kind="stable") if imp[i] > 0},
            "pandas_categorical": self._pandas_categorical,
        }

    def save_model(self, filename: str, num_iteration: Optional[int] = None,
                   start_iteration: int = 0,
                   importance_type: Optional[str] = None):
        if importance_type is None:
            importance_type = ("gain" if int(Config(self.params)
                               .saved_feature_importance_type) == 1
                               else "split")
        text = self.model_to_string(num_iteration, start_iteration,
                                    importance_type)
        tmp = f"{filename}.tmp{os.getpid()}"
        with open(tmp, "w") as f:
            f.write(text)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, filename)
        return self

    def model_from_string(self, model_str: str):
        self._load_from_string(model_str)
        return self

    def _objective_text(self) -> str:
        name = self._objective_name
        if name == "binary":
            return f"binary sigmoid:{Config(self.params).sigmoid:g}"
        if name == "multiclass":
            return f"multiclass num_class:{self._num_class}"
        if name == "multiclassova":
            return (f"multiclassova num_class:{self._num_class} "
                    f"sigmoid:{Config(self.params).sigmoid:g}")
        if name == "regression" and Config(self.params).reg_sqrt:
            # RegressionL2loss::ToString appends " sqrt"; without it a
            # reload would not square the outputs back
            return "regression sqrt"
        return name

    def _feature_infos_list(self) -> List[str]:
        if self._feature_infos:
            return self._feature_infos
        if hasattr(self, "train_set") and self.train_set._constructed:
            return [m.feature_info_str()
                    for m in self.train_set.bin_mappers]
        return ["none"] * (self._max_feature_idx + 1)

    def _load_from_string(self, s: str):
        lines = s.splitlines()
        header: Dict[str, str] = {}
        i = 0
        while i < len(lines) and not lines[i].startswith("Tree="):
            ln = lines[i]
            if "=" in ln:
                k, v = ln.split("=", 1)
                header[k] = v
            elif ln.strip() == "average_output":
                header["average_output"] = "1"
            i += 1
        self._average_output = "average_output" in header
        for ln in reversed(lines[-8:]):
            if ln.startswith("pandas_categorical:"):
                try:
                    self._pandas_categorical = json.loads(ln.split(":", 1)[1])
                except ValueError:
                    self._pandas_categorical = None
                break
        self._num_class = int(header.get("num_class", "1"))
        self._max_feature_idx = int(header.get("max_feature_idx", "0"))
        obj = header.get("objective", "regression").split()
        self._objective_name = obj[0] if obj else "regression"
        self._feature_names = header.get("feature_names", "").split()
        self._feature_infos = header.get("feature_infos", "").split()
        self.params.setdefault("objective", self._objective_name)
        # the objective's suffix tokens carry the state its output
        # transform needs: "sigmoid:2", "sqrt", "tweedie_variance_power:p"
        for tok in obj[1:]:
            if tok == "sqrt":
                self.params.setdefault("reg_sqrt", True)
            elif ":" in tok:
                k, v = tok.split(":", 1)
                if k in ("sigmoid", "tweedie_variance_power", "alpha",
                         "fair_c", "poisson_max_delta_step"):
                    try:
                        self.params.setdefault(k, float(v))
                    except ValueError:
                        pass
        if self._num_class > 1:
            self.params["num_class"] = self._num_class
        self.config = Config(dict(self.params))
        self._objective = (create_objective(self.config)
                           if self._objective_name != "custom" else None)
        rest = "\n".join(lines[i:])
        self._trees = [Tree.from_text("Tree=" + b.split("end of trees")[0])
                       for b in rest.split("Tree=")[1:]]
        # the version moves only once the new trees are in place: a
        # predict racing the load packs the old trees under the old
        # version, never under the new one (the JAX package bumps first)
        self._model_version += 1

    # -- introspection -------------------------------------------------
    def num_trees(self) -> int:
        self._sync_trees()
        return len(self._all_trees())

    def current_iteration(self) -> int:
        return self.num_trees() // max(1, self._num_class)

    def num_feature(self) -> int:
        return self._max_feature_idx + 1

    def num_model_per_iteration(self) -> int:
        """LGBM_BoosterNumModelPerIteration."""
        return max(1, self._num_class)

    def get_leaf_output(self, tree_id: int, leaf_id: int) -> float:
        """LGBM_BoosterGetLeafValue (shrinkage included)."""
        self._sync_trees()
        return float(self._all_trees()[tree_id].leaf_value[leaf_id])

    def set_leaf_output(self, tree_id: int, leaf_id: int,
                        value: float) -> "Booster":
        """LGBM_BoosterSetLeafValue: overwrite one leaf's output; the
        model version moves, so the next predict repacks the trees."""
        self._sync_trees()
        self._all_trees()[tree_id].leaf_value[leaf_id] = float(value)
        self._model_version += 1
        return self

    def shuffle_models(self, start_iteration: int = 0,
                       end_iteration: int = -1) -> "Booster":
        """Permute the iterations in [start, end) at random with
        ``np.random`` (LGBM_BoosterShuffleModels); a multiclass
        iteration moves as one group of K trees."""
        self._sync_trees()
        K = max(1, self._num_class)
        trees = self._all_trees()
        n_iter = len(trees) // K
        lo = max(0, start_iteration)
        hi = n_iter if end_iteration < 0 else min(end_iteration, n_iter)
        if hi - lo > 1:
            order = np.arange(lo, hi)
            np.random.shuffle(order)
            groups = [trees[i * K:(i + 1) * K] for i in range(n_iter)]
            shuffled = (groups[:lo] + [groups[i] for i in order]
                        + groups[hi:])
            flat = [t for g in shuffled for t in g]
            nb = len(self._base_trees)
            self._base_trees = flat[:nb]
            self._trees[:] = flat[nb:]
            self._model_version += 1
        return self

    def lower_bound(self) -> float:
        """The least raw output: the sum of each tree's smallest leaf
        value (LGBM_BoosterGetLowerBoundValue)."""
        self._sync_trees()
        return float(sum(t.leaf_value.min() for t in self._all_trees()
                         if t.num_leaves > 0))

    def upper_bound(self) -> float:
        """The largest raw output (LGBM_BoosterGetUpperBoundValue)."""
        self._sync_trees()
        return float(sum(t.leaf_value.max() for t in self._all_trees()
                         if t.num_leaves > 0))

    def trees_to_dataframe(self):
        """The model's nodes as a pandas DataFrame, built on
        :meth:`dump_model` with the reference's columns and node names
        (engine.py:1036-1087). pandas is imported here only."""
        import pandas as pd
        dump = self.dump_model()
        feat_names = dump["feature_names"]
        rows = []
        for tinfo in dump["tree_info"]:
            ti = tinfo["tree_index"]
            stack = [(tinfo["tree_structure"], 1, None)]
            while stack:
                node, depth_, parent_name = stack.pop()
                if "split_index" in node:
                    my = f"{ti}-S{node['split_index']}"

                    def cname(c):
                        return (f"{ti}-S{c['split_index']}"
                                if "split_index" in c
                                else f"{ti}-L{c.get('leaf_index', 0)}")
                    rows.append(dict(
                        tree_index=ti, node_depth=depth_, node_index=my,
                        left_child=cname(node["left_child"]),
                        right_child=cname(node["right_child"]),
                        parent_index=parent_name,
                        split_feature=feat_names[node["split_feature"]],
                        split_gain=node["split_gain"],
                        threshold=node["threshold"],
                        decision_type=node["decision_type"],
                        missing_direction=("left" if node["default_left"]
                                           else "right"),
                        missing_type=node["missing_type"],
                        value=node["internal_value"],
                        weight=node["internal_weight"],
                        count=node["internal_count"]))
                    stack.append((node["right_child"], depth_ + 1, my))
                    stack.append((node["left_child"], depth_ + 1, my))
                else:
                    rows.append(dict(
                        tree_index=ti, node_depth=depth_,
                        node_index=f"{ti}-L{node.get('leaf_index', 0)}",
                        left_child=None, right_child=None,
                        parent_index=parent_name, split_feature=None,
                        split_gain=None, threshold=None,
                        decision_type=None, missing_direction=None,
                        missing_type=None,
                        value=node["leaf_value"],
                        weight=node.get("leaf_weight"),
                        count=node.get("leaf_count")))
        return pd.DataFrame(rows)

    def feature_name(self) -> List[str]:
        return list(self._feature_names)

    def feature_importance(self, importance_type: str = "split",
                           iteration: Optional[int] = None) -> np.ndarray:
        nf = self._max_feature_idx + 1
        out = np.zeros(nf)
        for t in self._all_trees():
            if importance_type == "gain":
                out += t.feature_importance_gain(nf)
            else:
                out += t.feature_importance_split(nf)
        return out

    def free_dataset(self):
        return self

    def __copy__(self):
        return self.__deepcopy__(None)

    def __deepcopy__(self, memo):
        return Booster(model_str=self.model_to_string(),
                       params=dict(self.params))


class PredictSession:
    """Persistent prediction handle for the serving pattern: many
    ``predict()`` calls against one (slowly-mutating) model
    (``lightgbm_tpu/engine.py:1114``).

    It caches the resolved tree window and, through the Booster's
    version-keyed pack cache, the packed device ensemble; both rebuild
    on the first ``predict()`` after the model version moves (training,
    model reload).

    Thread-safety contract (the serving micro-batcher relies on it):
    every version-dependent piece of state — model version, class
    count, window offset, tree slice — lives in ONE immutable snapshot
    tuple. ``predict()`` reads that reference exactly once and serves
    the whole call from it; ``_refresh()`` builds a complete new tuple
    and publishes it with a single reference assignment (atomic under
    the GIL). Concurrent ``predict()`` calls racing a version movement
    each resolve to one WHOLE snapshot, never an old window over new
    trees. The snapshot's tree list is a slice copy, so later mutations
    of the Booster's tree list cannot reach it.
    """

    def __init__(self, booster: Booster, *, start_iteration: int = 0,
                 num_iteration: Optional[int] = None,
                 raw_score: bool = False, pred_leaf: bool = False,
                 pred_contrib: bool = False, **kwargs):
        self.booster = booster
        self._start_iteration = start_iteration
        self._num_iteration = num_iteration
        self._raw_score = raw_score
        self._pred_leaf = pred_leaf
        self._pred_contrib = pred_contrib
        self._extra = dict(kwargs)
        self._refresh()

    def _refresh(self):
        """Resolve the tree window against the current model into a
        fresh ``(version, K, lo, trees)`` snapshot; publish and return
        it. Reads the version FIRST: if the model moves mid-build, the
        stale snapshot self-heals on the next predict's version check
        (worst case one extra refresh, never a mixed window)."""
        b = self.booster
        b._sync_trees()
        version = b._model_version
        K = max(1, b._num_class)
        trees = b._all_trees()
        lo, hi = b._window(self._start_iteration, self._num_iteration,
                           len(trees))
        snap = (version, K, lo, trees[lo:hi])
        self._snapshot = snap
        return snap

    def warmup(self, n_rows: int = 1024) -> "PredictSession":
        """Build every lazy cache now (packed ensemble on the device) so
        the first real request pays nothing."""
        self.predict(np.zeros((n_rows, self.booster._max_feature_idx + 1),
                              np.float32))
        return self

    def predict(self, data) -> np.ndarray:
        b = self.booster
        snap = self._snapshot          # ONE read; see class contract
        if b._model_version != snap[0]:
            snap = self._refresh()
        version, K, lo, use = snap
        fast = (not self._pred_leaf and not self._pred_contrib
                and isinstance(data, np.ndarray) and data.ndim == 2
                and data.dtype in (np.float32, np.float64)
                and data.shape[1] == b._max_feature_idx + 1
                and b._early_stop_config(self._extra) is None)
        if fast:
            # the packed device walk over the snapshot's trees, keyed by
            # the snapshot's version (f32 widens to f64 exactly)
            raw = b._predict_raw_scores(
                np.ascontiguousarray(data, np.float64), use, lo, K, version)
            return b._finalize_scores(raw, use, K, self._raw_score)
        return b.predict(data, start_iteration=self._start_iteration,
                         num_iteration=self._num_iteration,
                         raw_score=self._raw_score,
                         pred_leaf=self._pred_leaf,
                         pred_contrib=self._pred_contrib, **self._extra)

    __call__ = predict


def train(params: Dict, train_set: Dataset, num_boost_round: int = 100,
          valid_sets: Optional[Sequence[Dataset]] = None,
          valid_names: Optional[Sequence[str]] = None, feval=None,
          init_model=None, keep_training_booster: bool = False,
          callbacks: Optional[Sequence[Callable]] = None,
          fobj: Optional[Callable] = None) -> Booster:
    """Main training loop (engine.py:1239 analog).

    Eval-cadence contract of the JAX package: callbacks and early
    stopping observe metrics every ``eval_period`` iterations (default 1)
    and at the last one. Between eval points the trees stay on the
    device and iterations run with no host sync. A snapshot iteration
    (``snapshot_freq``) is a sync point too: the model is saved to
    ``{output_model}.snapshot_iter_{i}`` and the snapshots are pruned to
    the newest ``snapshot_keep`` (engine.py:1531-1537, :1605-1612).

    ``fobj`` (or a callable ``objective``) is a custom objective, called
    each iteration as ``fobj(preds, train_set)``. ``init_model`` (a
    Booster or a model file) continues training from its predictions on
    the train and valid raw data; iterations then count from its last
    one, so ``best_iteration`` indexes the whole ensemble.
    ``keep_training_booster`` is accepted and changes nothing, as in
    the JAX package.

    Fault tolerance (engine.py:1362-1560): with ``resume`` (``auto``
    scans ``{output_model}.ckpt_iter_N`` for the newest valid checkpoint
    of this config; a path resumes from that file) every snapshot
    iteration also writes a full-state checkpoint, the run continues
    bit-identically from a restored one, and SIGTERM/SIGINT drain the
    pending trees, write a final checkpoint and raise
    ``TrainingPreempted``. ``nan_guard=rollback`` restores the newest
    checkpoint on a divergence (twice at most), and
    ``on_device_loss=degrade`` retries the run on the same device from
    its newest checkpoint (``resilience/supervisor.py``).

    Telemetry (engine.py:1369-1624): ``event_log`` writes the run-event
    log and ``telemetry_port`` (or ``LIGHTGBM_TPU_TELEMETRY_PORT``)
    serves /metrics, /events, /healthz and /trace while the run trains
    (``telemetry/``). Every hook runs where the loop has already synced,
    so such a run makes the host syncs of a bare one and trains the same
    trees.
    """
    params = dict(params or {})
    cfg = Config(params)
    log.set_verbosity(int(cfg.verbosity))
    if str(cfg.on_device_loss) == "degrade":
        # each attempt re-enters train() with on_device_loss=fail (set
        # by the supervisor), so this gate fires once per call
        from .resilience.supervisor import supervised_train
        return supervised_train(
            train, params, train_set, num_boost_round,
            valid_sets=valid_sets, valid_names=valid_names, feval=feval,
            init_model=init_model,
            keep_training_booster=keep_training_booster,
            callbacks=callbacks, fobj=fobj)
    if "num_iterations" in cfg.explicit():
        num_boost_round = cfg.num_iterations
    if callable(params.get("objective")):
        fobj = params["objective"]
        params["objective"] = "custom"

    # continued training: predict the base scores before construction
    # frees the raw matrices (engine.py:1286-1309)
    base = base_train_scores = base_valid_scores = None
    if init_model is not None:
        base = (init_model if isinstance(init_model, Booster) else
                Booster(model_file=str(init_model),
                        params={"device_type": cfg.device_type}))
        if train_set._raw_data is None:
            raise ValueError(
                "init_model needs the training Dataset's raw data; use "
                "free_raw_data=False or an unconstructed Dataset")
        base_train_scores = base.predict(train_set._raw_data,
                                         raw_score=True)
        base_valid_scores = []
        for vs in (valid_sets or []):
            if vs is train_set:
                continue
            if vs._raw_data is None:
                raise ValueError(
                    "init_model needs each validation Dataset's raw data; "
                    "use free_raw_data=False or an unconstructed Dataset")
            base_valid_scores.append(base.predict(vs._raw_data,
                                                  raw_score=True))

    booster = Booster(params=params, train_set=train_set)
    if valid_sets:
        valid_names = list(valid_names or [])
        for i, vs in enumerate(valid_sets):
            if vs is train_set:
                continue
            name = valid_names[i] if i < len(valid_names) else f"valid_{i}"
            booster.add_valid(vs, name)
    if base is not None:
        booster._set_init_model(base, base_train_scores, base_valid_scores)
    callbacks = list(callbacks or [])
    if cfg.early_stopping_round and cfg.early_stopping_round > 0:
        from .callback import early_stopping
        callbacks.append(early_stopping(
            cfg.early_stopping_round,
            first_metric_only=cfg.first_metric_only,
            min_delta=cfg.early_stopping_min_delta))
    before = sorted((cb for cb in callbacks
                     if getattr(cb, "before_iteration", False)),
                    key=lambda cb: getattr(cb, "order", 0))
    after = sorted((cb for cb in callbacks
                    if not getattr(cb, "before_iteration", False)),
                   key=lambda cb: getattr(cb, "order", 0))
    eval_consumers = [cb for cb in after if getattr(cb, "needs_eval", True)]
    train_metric_consumers = [
        cb for cb in after if getattr(cb, "consumes_train_metrics", True)]
    eval_period = max(1, int(cfg.eval_period))
    # continued training runs [init_iteration, init_iteration + rounds)
    # (engine.py:1353-1358)
    begin = booster.current_iteration()
    end_iteration = begin + num_boost_round

    from .resilience import (NumericDivergenceError, PreemptionGuard,
                             TrainingPreempted, checkpoint_path,
                             config_fingerprint, find_resume_checkpoint,
                             prune_numbered, read_checkpoint,
                             restore_training_checkpoint,
                             topology_descriptor,
                             write_training_checkpoint)
    from .telemetry import TelemetrySession
    resume = str(cfg.resume)
    resume_on = resume != "off"
    nan_guard = str(cfg.nan_guard)
    # None unless telemetry_port/event_log (or the env var) opt in
    tele = TelemetrySession.from_config(cfg, params)
    fingerprint = (config_fingerprint(params)
                   if resume_on or tele is not None else None)
    # the eval and snapshot cadence stays anchored at the original run's
    # first iteration across a resume (engine.py:1386-1391)
    cadence_base = begin
    reshard_from = None   # the checkpoint's topology, when it differed

    def _restore(state, arrays, texts):
        nonlocal cadence_base, end_iteration, reshard_from
        booster._ensure_gbdt()
        restore_training_checkpoint(booster, callbacks, state, arrays,
                                    texts)
        cadence_base = int(state.get("begin_iteration", cadence_base))
        rec_end = int(state.get("end_iteration", end_iteration))
        if rec_end != end_iteration:
            log.info(f"resume: continuing to the original run's "
                     f"end_iteration={rec_end} (num_boost_round ignored)")
            end_iteration = rec_end
        # a checkpoint written on another device (the CPU, another card
        # count) restores as it is; the event log records the move
        rec_topo = state.get("topology")
        if rec_topo and rec_topo != topology_descriptor(booster._gbdt):
            reshard_from = rec_topo

    # a failed periodic checkpoint write (ENOSPC, EROFS) warns and
    # backs off; three in a row, or a failed final write, raise
    # (engine.py:1420-1456)
    ckpt_fail = {"streak": 0, "skip": 0}

    def _write_ckpt(iteration: int, final: bool = False):
        if ckpt_fail["skip"] > 0 and not final:
            ckpt_fail["skip"] -= 1
            return None
        path = checkpoint_path(cfg.output_model, iteration)
        try:
            write_training_checkpoint(
                path, booster, callbacks, begin_iteration=cadence_base,
                end_iteration=end_iteration, params=params)
        except OSError as e:
            ckpt_fail["streak"] += 1
            if final or ckpt_fail["streak"] >= 3:
                raise
            ckpt_fail["skip"] = ckpt_fail["streak"] - 1
            log.warning(f"checkpoint write failed ({e}); continuing and "
                        "retrying at a later snapshot boundary "
                        f"({ckpt_fail['streak']}/3 consecutive failures "
                        "before this becomes fatal)")
            if tele is not None:
                tele.on_checkpoint("write", iteration, path, ok=False)
            return None
        ckpt_fail["streak"] = ckpt_fail["skip"] = 0
        prune_numbered(cfg.output_model + ".ckpt_iter_", cfg.snapshot_keep)
        if tele is not None:
            tele.on_checkpoint("write", iteration, path)
        return path

    resumed_from = None
    if resume_on:
        if init_model is not None:
            raise ValueError(
                "resume cannot be combined with init_model: the "
                "checkpoint already carries the full ensemble and "
                "training state")
        ckpt = (find_resume_checkpoint(cfg.output_model, fingerprint)
                if resume == "auto" else resume)
        if ckpt is not None:
            _restore(*read_checkpoint(ckpt))
            resumed_from = (str(ckpt), booster.current_iteration())
            log.info(f"resume: restored {ckpt} at iteration "
                     f"{booster.current_iteration()}")
    elif nan_guard == "rollback":
        log.warning("nan_guard=rollback needs resume checkpoints to "
                    "roll back to (resume=off); divergence will raise "
                    "instead")

    if tele is not None:
        # after any restore: begin_run splices the event log to the
        # restored iteration and re-emits the run header
        tele.begin_run(booster, cfg, params, fingerprint,
                       resumed_from=resumed_from)
        if reshard_from is not None:
            tele.on_reshard(booster.current_iteration(), reshard_from,
                            topology_descriptor(booster._gbdt))

    # fault-injection hook (engine.py:1488-1500): signal this process
    # right after an iteration's work, checkpoint writes included
    kill_at = os.environ.get("LIGHTGBM_TPU_CHAOS_KILL_ITER")
    kill_at = int(kill_at) if kill_at is not None else None

    def _chaos_kill(iteration: int) -> None:
        if kill_at is None or iteration + 1 != kill_at:
            return
        import signal
        sig = (signal.SIGTERM
               if os.environ.get("LIGHTGBM_TPU_CHAOS_KILL_SIGNAL",
                                 "KILL") == "TERM" else signal.SIGKILL)
        os.kill(os.getpid(), sig)

    rollback_budget = 2
    guard = PreemptionGuard(enabled=resume_on)
    ok = False
    try:
        with guard:
            i = booster.current_iteration()
            while i < end_iteration:
                if guard.fired:
                    # the handler only latched the signal: drain the
                    # pending trees (the capture syncs), persist, exit
                    path = _write_ckpt(booster.current_iteration(),
                                       final=True)
                    if guard.deadline_exceeded():
                        log.warning("preemption drain exceeded the "
                                    f"{guard.deadline_s:g}s deadline")
                    if tele is not None:
                        tele.on_preemption(guard.signum,
                                           booster.current_iteration())
                    raise TrainingPreempted(guard.signum,
                                            booster.current_iteration(),
                                            path)
                for cb in before:
                    cb(CallbackEnv(booster, params, i, cadence_base,
                                   end_iteration, None))
                snapshot_here = (cfg.snapshot_freq > 0
                                 and (i + 1) % cfg.snapshot_freq == 0)
                sync_here = ((i - cadence_base + 1) % eval_period == 0
                             or i == end_iteration - 1 or snapshot_here)
                try:
                    # step range for torch.profiler traces (the
                    # per-iteration timing hook of gbdt.cpp:246-249)
                    with profiler.step_annotation("boost_iter",
                                                  step_num=i):
                        stop = booster.update(fobj=fobj,
                                              defer=not sync_here)
                except NumericDivergenceError as e:
                    it_bad = getattr(e, "iteration", i + 1)
                    if nan_guard != "rollback" or not resume_on:
                        if tele is not None:
                            tele.on_nan_guard(it_bad, nan_guard, "raise")
                        raise
                    ckpt = find_resume_checkpoint(cfg.output_model,
                                                  fingerprint)
                    if ckpt is None or rollback_budget <= 0:
                        log.warning("nan_guard: no checkpoint to roll back"
                                    " to" if ckpt is None else
                                    "nan_guard: rollback budget exhausted "
                                    "(deterministic divergence)")
                        if tele is not None:
                            tele.on_nan_guard(it_bad, nan_guard, "raise")
                        raise
                    rollback_budget -= 1
                    _restore(*read_checkpoint(ckpt))
                    log.warning(f"nan_guard incident: {e}; rolled back to "
                                f"{ckpt} (iteration "
                                f"{booster.current_iteration()}) and "
                                "re-running")
                    if tele is not None:
                        tele.on_nan_guard(it_bad, nan_guard, "rollback")
                        tele.on_checkpoint("restore",
                                           booster.current_iteration(),
                                           str(ckpt))
                    i = booster.current_iteration()
                    continue
                if not (sync_here or stop):
                    _chaos_kill(i)
                    i += 1
                    continue
                evals = []
                if eval_consumers or cfg.early_stopping_round > 0:
                    with profiler.phase("eval"):
                        if cfg.is_provide_training_metric and (
                                train_metric_consumers or not after):
                            evals.extend(booster.eval_train(feval))
                        evals.extend(booster.eval_valid(feval))
                if tele is not None:
                    # the eval-cadence sync point: update just drained
                    # the ring and the evals are host floats
                    tele.on_sync(i + 1, evals)
                env = CallbackEnv(booster, params, i, cadence_base,
                                  end_iteration, evals)
                try:
                    for cb in after:
                        cb(env)
                except EarlyStopException as e:
                    booster.best_iteration = e.best_iteration + 1
                    for name, metric, value, _ in (e.best_score or []):
                        booster.best_score.setdefault(name, {})[
                            metric] = value
                    if tele is not None:
                        tele.on_early_stop(i + 1, booster.best_iteration)
                    break
                if snapshot_here:
                    # periodic snapshot (gbdt.cpp:250-254): a model file
                    # that init_model resumes from, kept to the newest
                    # snapshot_keep; with resume, a full-state checkpoint
                    booster.save_model(
                        f"{cfg.output_model}.snapshot_iter_{i + 1}")
                    prune_numbered(cfg.output_model + ".snapshot_iter_",
                                   cfg.snapshot_keep)
                    if resume_on:
                        _write_ckpt(i + 1)
                _chaos_kill(i)
                if stop:
                    break
                i += 1
        ok = True
    finally:
        if tele is not None:
            # ended=False (a fault unwinding) suppresses train_end so
            # the fault record stays the log's last word
            tele.close(ended=ok)
    return booster


class CVBooster:
    """The per-fold boosters of :func:`cv` (engine.py:1628): a method
    call is made on every fold's booster and returns the list of
    results."""

    def __init__(self):
        self.boosters: List[Booster] = []
        self.best_iteration = -1

    def append(self, booster: Booster):
        self.boosters.append(booster)

    def __getattr__(self, name):
        def handler(*args, **kwargs):
            return [getattr(b, name)(*args, **kwargs)
                    for b in self.boosters]
        return handler


def cv(params: Dict, train_set: Dataset, num_boost_round: int = 100,
       folds=None, nfold: int = 5, stratified: bool = True,
       shuffle: bool = True, metrics=None, seed: int = 0, callbacks=None,
       eval_train_metric: bool = False,
       return_cvbooster: bool = False) -> Dict[str, List[float]]:
    """K-fold cross-validation (engine.py:1645-1792): the folds of the
    JAX package from ``RandomState(seed)`` (whole queries with a group,
    stratified by class for binary and multiclass objectives, else
    plain; or the caller's ``folds``), each fold's Datasets built on the
    port's device from the train set's raw rows (``free_raw_data=
    False``), the fold boosters stepped in lockstep, and the callbacks
    (early stopping among them) fed the folds' mean metrics. Returns
    "{set} {metric}-mean"/"-stdv" lists, with the CVBooster under
    "cvbooster" when ``return_cvbooster``."""
    params = dict(params or {})
    if metrics is not None:
        params["metric"] = metrics
    train_set.construct()
    label = train_set.get_label()
    n = train_set.num_data
    rng = np.random.RandomState(seed)
    weight = train_set.get_weight()
    group = train_set.get_group()
    init_score = train_set.get_init_score()

    if folds is None:
        if group is not None:
            # whole queries per fold (GroupKFold semantics for ranking)
            qb = train_set.query_boundaries()
            qidx = np.arange(len(group))
            if shuffle:
                rng.shuffle(qidx)
            qparts = np.array_split(qidx, nfold)
            folds = []
            for f in range(nfold):
                te = np.concatenate([np.arange(qb[q], qb[q + 1])
                                     for q in np.sort(qparts[f])])
                folds.append((np.setdiff1d(np.arange(n), te), te))
        elif stratified and Config(params).objective in (
                "binary", "multiclass", "multiclassova"):
            idx = np.arange(n)
            folds_idx = [[] for _ in range(nfold)]
            for cls in np.unique(label):
                ci = idx[label == cls]
                if shuffle:
                    rng.shuffle(ci)
                for f in range(nfold):
                    folds_idx[f].extend(ci[f::nfold])
            folds = [(np.setdiff1d(idx, np.asarray(te)), np.asarray(te))
                     for te in folds_idx]
        else:
            idx = np.arange(n)
            if shuffle:
                rng.shuffle(idx)
            parts = np.array_split(idx, nfold)
            folds = [(np.concatenate([parts[j] for j in range(nfold)
                                      if j != f]), parts[f])
                     for f in range(nfold)]

    raw = train_set._raw_data
    if raw is None:
        raise ValueError("cv requires train_set with free_raw_data=False")
    if hasattr(raw, "iloc"):
        def X_rows(ix):     # keep the frame: category dtypes survive
            return raw.iloc[ix]
    else:
        _X = np.asarray(raw, dtype=np.float64)

        def X_rows(ix):
            return _X[ix]

    def group_sizes(row_idx):
        if group is None:
            return None
        qb = train_set.query_boundaries()
        qid = np.searchsorted(qb, row_idx, side="right") - 1
        return np.unique(qid, return_counts=True)[1]

    def part(a, ix):
        return None if a is None else a[ix]

    cvb = CVBooster()
    for tr_idx, te_idx in folds:
        dtrain = Dataset(X_rows(tr_idx), label=label[tr_idx],
                         weight=part(weight, tr_idx),
                         group=group_sizes(tr_idx),
                         init_score=part(init_score, tr_idx),
                         params=dict(train_set.params))
        dvalid = Dataset(X_rows(te_idx), label=label[te_idx],
                         weight=part(weight, te_idx),
                         group=group_sizes(te_idx),
                         init_score=part(init_score, te_idx),
                         reference=dtrain)
        bst = Booster(dict(params), dtrain)
        bst.add_valid(dvalid, "valid")
        cvb.append(bst)

    cbs = list(callbacks or [])
    cfg = Config(params)
    if cfg.early_stopping_round and cfg.early_stopping_round > 0 \
            and not any(getattr(c, "order", 0) == 30 for c in cbs):
        from .callback import early_stopping
        cbs.append(early_stopping(cfg.early_stopping_round,
                                  first_metric_only=bool(
                                      cfg.first_metric_only),
                                  min_delta=cfg.early_stopping_min_delta))
    cbs = sorted(cbs, key=lambda c: getattr(c, "order", 0))
    cbs_before = [c for c in cbs if getattr(c, "before_iteration", False)]
    cbs_after = [c for c in cbs if not getattr(c, "before_iteration",
                                               False)]
    results: Dict[str, List[float]] = {}
    name_map = {"training": "train"}
    for it in range(num_boost_round):
        for cb in cbs_before:
            cb(CallbackEnv(cvb, params, it, 0, num_boost_round, None))
        finished = True
        for bst in cvb.boosters:
            finished = bst.update() and finished
        # mean and standard deviation of each (set, metric) over folds
        agg = collections.OrderedDict()
        for bst in cvb.boosters:
            res = list(bst.eval_valid())
            if eval_train_metric:
                res = list(bst.eval_train()) + res
            for nm, metric, value, bigger in res:
                nm = name_map.get(nm, nm)
                agg.setdefault((nm, metric), ([], bigger))[0].append(value)
        eval_list = []
        for (nm, metric), (vals, bigger) in agg.items():
            mean, std = float(np.mean(vals)), float(np.std(vals))
            results.setdefault(f"{nm} {metric}-mean", []).append(mean)
            results.setdefault(f"{nm} {metric}-stdv", []).append(std)
            eval_list.append(("cv_agg", f"{nm} {metric}", mean, bigger))
        try:
            for cb in cbs_after:
                cb(CallbackEnv(cvb, params, it, 0, num_boost_round,
                               eval_list))
        except EarlyStopException as e:
            cvb.best_iteration = e.best_iteration + 1
            for k in list(results):
                results[k] = results[k][:cvb.best_iteration]
            for bst in cvb.boosters:
                bst.best_iteration = cvb.best_iteration
            break
        if finished:
            break
    if return_cvbooster:
        results["cvbooster"] = cvb
    return results
