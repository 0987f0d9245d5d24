"""PyTorch port, the DART and RF boosting modes, ``rollback_one_iter``
and Metadata ``init_score`` on the CPU, against the JAX package on data
made from a seeded numpy RNG, with the JAX package's bin mappers
carried across:

- DART (``boosting/dart.py``) at its defaults and with
  ``xgboost_dart_mode``, ``uniform_drop`` and ``max_drop``: the same
  drop sets, tree structures and tree weights (exact: host float
  arithmetic on the same RandomState stream), training and valid scores
  within 1e-6 of their scale;
- RF (``boosting/rf.py``), binary and multiclass: tree structures
  equal, averaged predictions within 1e-6, the model text's
  ``average_output`` round trip exact, and the bagging check raised as
  in the JAX package;
- ``rollback_one_iter`` of GBDT, DART and RF: scores after two
  rollbacks within 1e-6 of the JAX package's, and training goes on to
  the same trees;
- JAX-trained DART and RF model texts predict in the port within 1e-12;
- ``init_score`` on the train and valid sets (binary [n], multiclass
  [n, K]): trees equal, scores within 1e-6.

Multiclass cases run at ``hist_dtype=float32`` (ROADMAP C: XLA's and
PyTorch's ``exp`` differ in the last bit).
"""

import jax
import numpy as np
import pytest

import lightgbm_tpu as lgb
import lightgbm_tpu_torch as lgt
from lightgbm_tpu_torch import convert
import torch


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread for these small tensors: the same results,
    and far less CPU time when several test workers share the host."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


CPU = {"device_type": "cpu"}
BASE = {"num_leaves": 15, "leaf_batch": 4, "max_bin": 16,
        "min_data_in_leaf": 10, "learning_rate": 0.2, "verbosity": -1}
TASKS = {
    "regression": {"objective": "regression", "metric": "l2"},
    "binary": {"objective": "binary", "metric": "auc"},
    "multiclass": {"objective": "multiclass", "num_class": 3,
                   "metric": "multi_logloss", "hist_dtype": "float32"},
}


def _data(rng, task, n=3000, nv=800, f=6):
    X = rng.normal(size=(n + nv, f))
    s = X[:, 0] * 1.5 - X[:, 1] ** 2 * 0.7 + np.sin(X[:, 2])
    noise = rng.normal(scale=0.5, size=n + nv)
    if task == "regression":
        y = s + noise
    elif task == "binary":
        y = (s + noise > 0).astype(float)
    else:
        y = np.digitize(s + noise, [-0.5, 0.8]).astype(float)
    return X[:n], y[:n], X[n:], y[n:]


def _sync_replays(gbdt):
    """Wait for each of a JAX DART booster's tree replays before its
    next op. jaxlib 0.9.0's CPU client can abort when an op is
    dispatched while a replay's ``while_loop`` still runs asynchronously
    (4 aborts in 72 parallel runs of ``tests/test_boosting_modes.py``,
    none in 48 with this wait); the values do not change."""
    orig = gbdt.predict_device_tree

    def blocked(idx, which=-1):
        return jax.block_until_ready(orig(idx, which))
    gbdt.predict_device_tree = blocked


def _pair(rng, task, extra, rounds, init=None, record_drops=False):
    """The JAX package's and the port's boosters on the same data and
    bin mappers; ``init`` = (train, valid) init scores."""
    X, y, Xv, yv = _data(rng, task)
    p = {**BASE, **TASKS[task], **extra}
    jp = {**p, "tree_learner": "serial", "hist_impl": "scatter"}
    isc, isv = init if init is not None else (None, None)
    jtr = lgb.Dataset(X, label=y, init_score=isc, params=jp).construct()
    jva = lgb.Dataset(Xv, label=yv, init_score=isv, reference=jtr)
    tp = {**p, **CPU}
    tr = lgt.Dataset(X, label=y, init_score=isc, params=tp,
                     bin_mappers=convert.bin_mappers_from_state(
                         m.state_arrays() for m in jtr.bin_mappers))
    va = lgt.Dataset(Xv, label=yv, init_score=isv, reference=tr)
    jb = lgb.Booster(params=jp, train_set=jtr)
    jb.add_valid(jva, "v")
    tb = lgt.Booster(params=tp, train_set=tr)
    tb.add_valid(va, "v")
    jb._ensure_gbdt()
    tb._ensure_gbdt()
    if p.get("boosting") == "dart":
        _sync_replays(jb._gbdt)
    drops = ([], [])
    if record_drops:
        for b, out in zip((jb, tb), drops):
            g = b._gbdt
            orig = g._select_drop

            def rec(orig=orig, out=out):
                d = orig()
                out.append(list(d))
                return d
            g._select_drop = rec
    for _ in range(rounds):
        jb.update()
        tb.update()
    return jb, tb, drops, (X, Xv)


def _same_trees(jt, tt):
    assert len(jt) == len(tt)
    for a, b in zip(jt, tt):
        assert a.num_leaves == b.num_leaves
        np.testing.assert_array_equal(a.split_feature, b.split_feature)
        np.testing.assert_array_equal(a.threshold_bin, b.threshold_bin)
        np.testing.assert_array_equal(a.left_child, b.left_child)
        np.testing.assert_array_equal(a.right_child, b.right_child)
        assert a.shrinkage == pytest.approx(b.shrinkage, rel=1e-12)


def _same_scores(jb, tb, tol=1e-6):
    jg, tg = jb._gbdt, tb._gbdt
    pairs = [(jg.scores, tg.scores, jg.train_dd.num_data)]
    pairs += [(jv, tv, dd.num_data) for jv, tv, dd in
              zip(jg.valid_scores, tg.valid_scores, tg.valid_dd)]
    for j, t, n in pairs:
        j = np.asarray(j)[:, :n]
        t = t.numpy()[:, :n]
        scale = max(1.0, float(np.abs(j).max()))
        np.testing.assert_allclose(t, j, rtol=0, atol=tol * scale)


DART = {
    "defaults": {},
    "xgboost_dart_mode": {"xgboost_dart_mode": True, "skip_drop": 0.2,
                          "drop_rate": 0.3},
    "uniform_drop": {"uniform_drop": True, "skip_drop": 0.0,
                     "drop_rate": 0.4},
    "max_drop": {"max_drop": 2, "skip_drop": 0.0, "drop_rate": 0.6},
}


@pytest.mark.parametrize("case,task", [(c, "regression") for c in DART]
                         + [("defaults", "multiclass")])
def test_dart_matches_jax(rng, monkeypatch, case, task):
    jb, tb, (jd, td), _ = _pair(rng, task, {"boosting": "dart",
                                            **DART[case]}, 12,
                                record_drops=True)
    monkeypatch.delenv("LIGHTGBM_TPU_FUSED_TRAIN", raising=False)
    assert tb._gbdt._fused_gate_reason() == \
        "boosting mode overrides the iteration loop"
    assert td == jd
    assert sum(len(d) for d in td) > 0
    if case == "max_drop":
        assert max(len(d) for d in td) == 2
    assert tb._gbdt._tree_weight == jb._gbdt._tree_weight
    _same_trees(jb._gbdt.models, tb._trees)
    _same_scores(jb, tb)
    assert len(tb._gbdt.device_trees) == len(tb._trees)


@pytest.mark.parametrize("task", ["binary", "multiclass"])
def test_rf_matches_jax(rng, task, tmp_path):
    extra = {"boosting": "rf", "bagging_freq": 1, "bagging_fraction": 0.632,
             "feature_fraction": 0.8}
    jb, tb, _, (X, Xv) = _pair(rng, task, extra, 8)
    assert tb._average_output and tb._gbdt.class_batch_reason in (
        "boosting mode overrides the iteration loop",
        "single model per iteration")
    _same_trees(jb._gbdt.models, tb._trees)
    _same_scores(jb, tb)
    for raw in (True, False):
        np.testing.assert_allclose(tb.predict(Xv, raw_score=raw),
                                   jb.predict(Xv, raw_score=raw),
                                   rtol=0, atol=1e-6)
    path = str(tmp_path / "rf.txt")
    tb.save_model(path)
    assert "\naverage_output\n" in open(path).read()
    back = lgt.Booster(model_file=path, params=CPU)
    assert back._average_output
    assert (back.predict(Xv) == tb.predict(Xv)).all()


def test_rf_needs_bagging(rng):
    X, y, _, _ = _data(rng, "binary")
    p = {**BASE, **TASKS["binary"], "boosting": "rf"}
    with pytest.raises(ValueError, match="(?i)rf"):
        lgb.train(p, lgb.Dataset(X, label=y), 1)
    with pytest.raises(ValueError, match="(?i)rf"):
        lgt.train({**p, **CPU}, lgt.Dataset(X, label=y, params=CPU), 1)


ROLLBACK = {
    "gbdt": ("binary", {}),
    "dart": ("regression", {"boosting": "dart", "skip_drop": 0.0,
                            "drop_rate": 0.5}),
    "rf": ("binary", {"boosting": "rf", "bagging_freq": 1,
                      "bagging_fraction": 0.632}),
}


@pytest.mark.parametrize("mode", list(ROLLBACK))
def test_rollback_one_iter_matches_jax(rng, mode):
    task, extra = ROLLBACK[mode]
    jb, tb, _, _ = _pair(rng, task, extra, 5)
    for _ in range(2):
        jb.rollback_one_iter()
        tb.rollback_one_iter()
    assert tb.current_iteration() == jb.current_iteration() == 3
    _same_scores(jb, tb)
    for _ in range(2):
        jb.update()
        tb.update()
    _same_trees(jb._gbdt.models, tb._trees)
    _same_scores(jb, tb)


@pytest.mark.parametrize("mode", ["dart", "rf"])
def test_jax_model_text_predicts_in_port(rng, mode):
    task, extra = ROLLBACK[mode]
    X, y, Xv, _ = _data(rng, task)
    p = {**BASE, **TASKS[task], **extra}
    jb = lgb.Booster(params=p, train_set=lgb.Dataset(X, label=y))
    jb._ensure_gbdt()
    if mode == "dart":
        _sync_replays(jb._gbdt)
    for _ in range(8):
        jb.update()
    text = jb.model_to_string()
    port = convert.booster_from_model_string(text, params=CPU)
    assert port._average_output == (mode == "rf")
    for raw in (True, False):
        np.testing.assert_allclose(port.predict(Xv, raw_score=raw),
                                   jb.predict(Xv, raw_score=raw),
                                   rtol=0, atol=1e-12)
    # and back: the port's text loads in the JAX package
    back = lgb.Booster(model_str=port.model_to_string())
    np.testing.assert_allclose(back.predict(Xv), jb.predict(Xv), rtol=0,
                               atol=1e-12)


@pytest.mark.parametrize("task", ["binary", "multiclass"])
def test_init_score_matches_jax(rng, task):
    X, _, Xv, _ = _data(rng, task)
    K = 3 if task == "multiclass" else 1
    shape = (len(X), K) if K > 1 else (len(X),)
    vshape = (len(Xv), K) if K > 1 else (len(Xv),)
    init = (rng.normal(scale=0.3, size=shape),
            rng.normal(scale=0.3, size=vshape))
    jb, tb, _, _ = _pair(rng, task, {}, 6, init=init)
    np.testing.assert_array_equal(tb._gbdt._init_scores, np.zeros(K))
    _same_trees(jb._gbdt.models, tb._trees)
    _same_scores(jb, tb)
