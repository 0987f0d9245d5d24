"""PyTorch port, linear trees (``linear_tree``) on the CPU against the
JAX package (the JAX tests of tests/test_linear_tree.py, and parity):

- a linear model that the JAX package trained predicts in the port
  within 1e-12 of ``lightgbm_tpu.Booster.predict`` (the port's walk
  once returned each leaf's constant, up to 1.19 off on this model);
- piecewise-linear data: linear leaves beat constant ones; the model
  text round trip (``is_linear=1``, ``leaf_coeff=``) predicts the same;
  a NaN in a leaf's feature falls back to the leaf's constant;
- the parameter conflicts (``regression_l1``, ``zero_as_missing``,
  DART) raise;
- training on the same data and bin mappers as the JAX package, for
  regression and per-class multiclass: trees equal (structure exact,
  values within 1e-5), linear constants and coefficients within rtol
  1e-9 (float64 solves over f32 raw values, sums in another order;
  multiclass within 1e-4, since the packages' float32 softmax gradients
  differ by rounding), predictions
  within rtol 1e-6; the gates name linear trees;
- ``rollback_one_iter`` on a linear model undoes its last iteration's
  per-row linear outputs, as the JAX package does.
"""

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


def _linear_data(rng, n=2000):
    X = rng.normal(size=(n, 5))
    # piecewise-LINEAR target: constant leaves can only staircase this
    y = np.where(X[:, 0] > 0, 2.0 * X[:, 1] + 1.0, -1.5 * X[:, 1] - 0.5)
    y += rng.normal(scale=0.05, size=n)
    return X, y


def _host_raw(trees, X, K=1):
    """Raw scores from the host trees' own ``Tree.predict``."""
    out = np.zeros((len(X), K))
    for i, t in enumerate(trees):
        out[:, i % K] += t.predict(X)
    return out[:, 0] if K == 1 else out


def test_jax_linear_model_predicts_in_port(rng):
    X, y = _linear_data(rng)
    jb = lgb.train({"objective": "regression", "num_leaves": 6,
                    "linear_tree": True, "verbosity": -1},
                   lgb.Dataset(X, label=y, free_raw_data=False), 4)
    text = jb.model_to_string()
    tb = lgt.Booster(model_str=text, params=CPU)
    want = jb.predict(X)
    np.testing.assert_allclose(tb.predict(X), want, rtol=0, atol=1e-12)
    sess = tb.predict_session()
    np.testing.assert_allclose(sess.predict(X), want, rtol=0, atol=1e-12)
    # the leaves' constants alone are far from it: the linear models are
    # what the walk adds
    const = lgt.Booster(model_str=text, params=CPU)
    for t in const._trees:
        t.is_linear = False
    assert np.abs(const.predict(X) - want).max() > 0.5


def test_linear_beats_constant_on_piecewise_linear(rng):
    X, y = _linear_data(rng)
    base = {"objective": "regression", "num_leaves": 8, "verbosity": -1,
            "learning_rate": 0.5, "min_data_in_leaf": 20, **CPU}
    const = lgt.train(base, lgt.Dataset(X, label=y, params=base), 10)
    lp = dict(base, linear_tree=True, linear_lambda=0.01)
    lin = lgt.train(lp, lgt.Dataset(X, label=y, params=lp), 10)
    mse_const = np.mean((const.predict(X) - y) ** 2)
    mse_lin = np.mean((lin.predict(X) - y) ** 2)
    assert mse_lin < mse_const * 0.5, (mse_lin, mse_const)


def test_linear_tree_text_roundtrip(rng):
    X, y = _linear_data(rng, n=800)
    p = {"objective": "regression", "num_leaves": 6, "linear_tree": True,
         "verbosity": -1, **CPU}
    bst = lgt.train(p, lgt.Dataset(X, label=y, params=p), 4)
    assert bst._gbdt.models[0].is_linear
    txt = bst.model_to_string()
    assert "is_linear=1" in txt and "leaf_coeff=" in txt
    bst2 = lgt.Booster(model_str=txt, params=CPU)
    assert np.array_equal(bst.predict(X), bst2.predict(X))
    np.testing.assert_allclose(bst.predict(X), _host_raw(bst._trees, X),
                               rtol=0, atol=1e-12)
    leaf = bst._trees[0].to_json()["tree_structure"]
    while "leaf_index" not in leaf:
        leaf = leaf["left_child"]
    assert "leaf_const" in leaf and "leaf_coeff" in leaf


def test_linear_nan_falls_back_to_constant(rng):
    X, y = _linear_data(rng, n=1000)
    p = {"objective": "regression", "num_leaves": 6, "linear_tree": True,
         "verbosity": -1, **CPU}
    bst = lgt.train(p, lgt.Dataset(X, label=y, params=p), 3)
    Xt = X[:50].copy()
    Xt[:, 1] = np.nan  # a leaf feature now missing
    pred = bst.predict(Xt)
    assert np.isfinite(pred).all()
    np.testing.assert_allclose(pred, _host_raw(bst._trees, Xt), rtol=0,
                               atol=1e-12)
    # rows whose leaf reads feature 1 take that leaf's constant value
    t = bst._trees[0]
    leaves = t.predict_leaf_index(Xt)
    uses = np.array([1 in t.leaf_features[s] for s in leaves])
    assert uses.any()
    np.testing.assert_array_equal(t.predict(Xt)[uses],
                                  t.leaf_value[leaves[uses]])


@pytest.mark.parametrize("extra,match", [
    ({"objective": "regression_l1"}, "regression_l1"),
    ({"zero_as_missing": True}, "zero_as_missing"),
    ({"boosting": "dart"}, "dart"),
])
def test_linear_tree_param_conflicts(extra, match):
    p = {"objective": "regression", "linear_tree": True, "verbosity": -1,
         **CPU, **extra}
    with pytest.raises(ValueError, match=match):
        lgt.train(p, lgt.Dataset(np.zeros((50, 2)), label=np.zeros(50),
                                 params=p), 1)


def _tree_equal(a, b, rtol=1e-9):
    """Structure exact, values within 1e-5; linear constants within
    ``rtol`` and each leaf's coefficients within ``rtol`` of its largest
    (a leaf whose rows share one gradient gets coefficients of ~1e-16,
    rounding noise of its solve); the feature lists equal at rtol
    1e-9."""
    assert a.num_leaves == b.num_leaves and a.is_linear == b.is_linear
    for k in ("split_feature", "threshold", "decision_type", "left_child",
              "right_child", "leaf_count"):
        assert np.array_equal(getattr(a, k), getattr(b, k)), k
    np.testing.assert_allclose(a.leaf_value, b.leaf_value, rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(a.leaf_const, b.leaf_const, rtol=rtol,
                               atol=1e-12)
    for s in range(a.num_leaves):
        ma = dict(zip(a.leaf_features[s], a.leaf_coeff[s]))
        mb = dict(zip(b.leaf_features[s], b.leaf_coeff[s]))
        if rtol <= 1e-9:
            assert a.leaf_features[s] == b.leaf_features[s], s
        # a coefficient of rounding noise may land exactly on 0 (and
        # drop) in one package only: compare with 0 for a missing one
        keys = sorted(set(ma) | set(mb))
        if keys:
            ca = np.array([ma.get(k, 0.0) for k in keys])
            cb = np.array([mb.get(k, 0.0) for k in keys])
            np.testing.assert_allclose(
                ca, cb, rtol=rtol, atol=rtol * np.abs(cb).max() + 1e-12)


def _train_both(rng, task, rounds=4, extra=None):
    X, y = _linear_data(rng, n=3000)
    X[rng.rand(len(X)) < 0.03, 2] = np.nan
    p = {"objective": "regression", "num_leaves": 8, "linear_tree": True,
         "linear_lambda": 0.01, "min_data_in_leaf": 20, "verbosity": -1,
         **(extra or {})}
    if task == "multiclass":
        y = np.digitize(y, [-0.5, 1.0]).astype(float)
        p.update(objective="multiclass", num_class=3)
    Xv, yv = X[2500:], y[2500:]
    X, y = X[:2500], y[:2500]
    jp = {**p, "tree_learner": "serial", "hist_impl": "scatter"}
    jtr = lgb.Dataset(X, label=y, params=jp, free_raw_data=False)
    jva = lgb.Dataset(Xv, label=yv, reference=jtr, free_raw_data=False)
    jb = lgb.train(jp, jtr, rounds, valid_sets=[jva], valid_names=["v"])
    tp = {**p, **CPU}
    mappers = convert.bin_mappers_from_state(
        m.state_arrays() for m in jtr.bin_mappers)
    ttr = lgt.Dataset(X, label=y, params=tp, bin_mappers=mappers)
    tva = lgt.Dataset(Xv, label=yv, reference=ttr)
    tb = lgt.train(tp, ttr, rounds, valid_sets=[tva], valid_names=["v"])
    return jb, tb, X, Xv


@pytest.mark.parametrize("task", ["regression", "multiclass"])
def test_linear_training_matches_jax(rng, task, monkeypatch):
    monkeypatch.delenv("LIGHTGBM_TPU_FUSED_TRAIN", raising=False)
    jb, tb, X, Xv = _train_both(rng, task)
    g = tb._gbdt
    assert g.fused_train_reason == "linear leaves solve on host raw values"
    assert g.class_batch_reason == (
        "linear leaves solve per-class on host raw values"
        if task == "multiclass" else "single model per iteration")
    assert len(jb._gbdt.models) == len(tb._trees)
    assert sum(t.is_linear for t in tb._trees) > len(tb._trees) // 2
    for a, b in zip(jb._gbdt.models, tb._trees):
        # the softmax's float32 gradients differ between the packages by
        # rounding (XLA's exp and PyTorch's), which the solves carry into
        # the fits; L2 gradients are exact
        _tree_equal(b, a, rtol=1e-4 if task == "multiclass" else 1e-9)
    for data in (X, Xv):
        np.testing.assert_allclose(tb.predict(data, raw_score=True),
                                   jb.predict(data, raw_score=True),
                                   rtol=1e-6, atol=1e-9)
    # the running scores: the per-row linear outputs, float32
    for got, want in ((g.scores, jb._gbdt.scores),
                      (g.valid_scores[0], jb._gbdt.valid_scores[0])):
        n = min(got.shape[1], np.asarray(want).shape[1])
        np.testing.assert_allclose(got[:, :n].numpy(),
                                   np.asarray(want)[:, :n], rtol=1e-5,
                                   atol=1e-5)


def test_linear_rollback_matches_jax(rng):
    jb, tb, X, Xv = _train_both(rng, "regression", rounds=4)
    before = tb._gbdt.eval_scores(0).copy()
    jb.rollback_one_iter()
    tb.rollback_one_iter()
    assert tb.current_iteration() == 3 == len(tb._trees)
    assert jb._gbdt.iter_ == 3
    last = tb._gbdt.eval_scores(0)
    # the valid scores lost the fourth tree's linear outputs
    np.testing.assert_allclose(last, tb.predict(Xv, raw_score=True)[:, None],
                               rtol=1e-5, atol=1e-5)
    assert np.abs(before - last).max() > 1e-4
    # and the train scores are the JAX package's after its rollback
    n = jb._gbdt.train_dd.num_data
    np.testing.assert_allclose(
        tb._gbdt.scores[0, :n].numpy(),
        np.asarray(jb._gbdt.scores)[0, :n], rtol=1e-5, atol=1e-5)
