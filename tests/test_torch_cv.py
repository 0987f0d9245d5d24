"""PyTorch port, ``cv`` and ``CVBooster`` on the CPU, against the JAX
package (mirrors ``tests/test_cv.py``) on data made from a seeded numpy
RNG. Each fold fits its own bin mappers in both packages (bit-equal,
``tests/test_torch_binning.py``), so the folds, trees and metrics line
up: the result dicts within 1e-6 of the JAX package's, the folds equal
(plain, stratified, group-aware and the caller's), early stopping on the
aggregated metric at the same iteration, ``eval_train_metric``, and
``return_cvbooster`` broadcasting calls to every fold."""

import numpy as np
import pytest
import torch

import lightgbm_tpu as lgb
import lightgbm_tpu_torch as lgt

CPU = {"device_type": "cpu"}
JAX = {"tree_learner": "serial", "hist_impl": "scatter"}
BIN = {"objective": "binary", "metric": "auc", "num_leaves": 7,
       "verbosity": -1}


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread for these small tensors: the same results,
    and far less CPU time when several test workers share the host."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _bin_data(rng, n=1200):
    X = rng.normal(size=(n, 6))
    y = (X[:, 0] + 0.6 * X[:, 1] ** 2 + rng.normal(scale=0.4, size=n)
         > 0.4).astype(float)
    return X, y


def _both(params, X, y, group=None, **kw):
    """cv in both packages on the same rows: (JAX result, port result)."""
    jr = lgb.cv({**params, **JAX},
                lgb.Dataset(X, label=y, group=group, free_raw_data=False),
                **kw)
    tr = lgt.cv({**params, **CPU},
                lgt.Dataset(X, label=y, group=group, params=CPU,
                            free_raw_data=False), **kw)
    return jr, tr


def _same_results(jr, tr, tol=1e-6):
    keys = sorted(k for k in jr if k != "cvbooster")
    assert keys == sorted(k for k in tr if k != "cvbooster")
    for k in keys:
        assert len(tr[k]) == len(jr[k])
        np.testing.assert_allclose(tr[k], jr[k], rtol=0, atol=tol)


def _same_folds(jr, tr):
    jb, tb = jr["cvbooster"].boosters, tr["cvbooster"].boosters
    assert len(jb) == len(tb)
    for a, b in zip(jb, tb):
        assert b.train_set.num_data == a.train_set.num_data
        np.testing.assert_array_equal(b._valid_sets[0].get_label(),
                                      a._valid_sets[0].get_label())


@pytest.mark.parametrize("stratified,shuffle", [(True, True), (False, True),
                                                (False, False)])
def test_cv_matches_jax(rng, stratified, shuffle):
    X, y = _bin_data(rng)
    jr, tr = _both(BIN, X, y, num_boost_round=8, nfold=3, seed=1,
                   stratified=stratified, shuffle=shuffle,
                   return_cvbooster=True)
    assert set(tr) == {"valid auc-mean", "valid auc-stdv", "cvbooster"}
    assert len(tr["valid auc-mean"]) == 8
    assert tr["valid auc-mean"][-1] > 0.85
    _same_results(jr, tr)
    _same_folds(jr, tr)
    # a fold's booster is the train() of that fold with its valid set
    b = tr["cvbooster"].boosters[1]
    vs = b._valid_sets[0]
    solo = lgt.train({**BIN, **CPU}, b.train_set, 8)
    assert [t.num_leaves for t in solo._trees] == \
        [t.num_leaves for t in b._trees]
    for s, t in zip(solo._trees, b._trees):
        np.testing.assert_array_equal(s.split_feature, t.split_feature)
        np.testing.assert_array_equal(s.leaf_value, t.leaf_value)
    assert vs.num_data == len(X) - b.train_set.num_data


def test_cv_stratified_balances_folds(rng):
    X, y = _bin_data(rng)
    y[:] = 0.0
    y[:120] = 1.0
    jr, tr = _both({**BIN, "metric": "binary_logloss"}, X, y,
                   num_boost_round=5, nfold=4, stratified=True, seed=3,
                   return_cvbooster=True)
    for bst in tr["cvbooster"].boosters:
        assert 0.05 < bst._valid_sets[0].get_label().mean() < 0.2
    _same_folds(jr, tr)
    _same_results(jr, tr)


def test_cv_group_aware_folds(rng):
    nq, per = 40, 12
    n = nq * per
    X = rng.normal(size=(n, 5))
    rel = (X[:, 0] > 0).astype(float) * 2 + (X[:, 1] > 0.4)
    grp = np.full(nq, per)
    jr, tr = _both({"objective": "lambdarank", "metric": "ndcg",
                    "eval_at": [5], "num_leaves": 7, "verbosity": -1},
                   X, rel, group=grp, num_boost_round=5, nfold=4, seed=7,
                   return_cvbooster=True)
    assert "valid ndcg@5-mean" in tr
    for bst in tr["cvbooster"].boosters:
        assert bst._valid_sets[0].num_data % per == 0
        assert (bst.train_set.get_group() == per).all()
    _same_folds(jr, tr)
    _same_results(jr, tr)


@pytest.mark.parametrize("how", ["callback", "param"])
def test_cv_early_stopping_aggregated(rng, how):
    X, y = _bin_data(rng)
    params = {**BIN, "learning_rate": 0.5}
    if how == "param":
        params["early_stopping_rounds"] = 5
    jr = lgb.cv({**params, **JAX}, lgb.Dataset(X, label=y,
                                               free_raw_data=False),
                num_boost_round=200, nfold=3, seed=5, return_cvbooster=True,
                callbacks=([lgb.early_stopping(5, verbose=False)]
                           if how == "callback" else None))
    tr = lgt.cv({**params, **CPU}, lgt.Dataset(X, label=y, params=CPU,
                                               free_raw_data=False),
                num_boost_round=200, nfold=3, seed=5, return_cvbooster=True,
                callbacks=([lgt.early_stopping(5, verbose=False)]
                           if how == "callback" else None))
    cvb = tr["cvbooster"]
    assert 0 < cvb.best_iteration < 200
    assert cvb.best_iteration == jr["cvbooster"].best_iteration
    assert len(tr["valid auc-mean"]) == cvb.best_iteration
    assert all(b.best_iteration == cvb.best_iteration
               for b in cvb.boosters)
    _same_results(jr, tr)


def test_cv_eval_train_metric(rng):
    X, y = _bin_data(rng)
    jr, tr = _both({**BIN, "metric": "binary_logloss"}, X, y,
                   num_boost_round=5, nfold=3, eval_train_metric=True)
    assert "train binary_logloss-mean" in tr
    assert tr["train binary_logloss-mean"][-1] \
        <= tr["valid binary_logloss-mean"][-1] + 1e-9
    _same_results(jr, tr)


def test_cv_custom_folds_and_return_cvbooster(rng):
    X, y = _bin_data(rng, n=900)
    idx = np.arange(900)
    folds = [(idx[300:], idx[:300]),
             (np.concatenate([idx[:300], idx[600:]]), idx[300:600]),
             (idx[:600], idx[600:])]
    jr, tr = _both(BIN, X, y, num_boost_round=4, folds=folds,
                   return_cvbooster=True)
    cvb = tr["cvbooster"]
    assert len(cvb.boosters) == 3
    preds = cvb.predict(X)
    assert len(preds) == 3 and all(p.shape == (900,) for p in preds)
    for p, q in zip(preds, jr["cvbooster"].predict(X)):
        np.testing.assert_allclose(p, q, atol=1e-6)
    for bst, (tr_idx, _) in zip(cvb.boosters, folds):
        assert bst.train_set.num_data == len(tr_idx)
    _same_results(jr, tr)


def test_cv_record_evaluation_and_frame_input(rng):
    X, y = _bin_data(rng)
    hist = {}
    res = lgt.cv({**BIN, **CPU},
                 lgt.Dataset(X, label=y, params=CPU, free_raw_data=False),
                 num_boost_round=6, nfold=3,
                 callbacks=[lgt.record_evaluation(hist)])
    assert "cv_agg" in hist and len(hist["cv_agg"]["valid auc"]) == 6
    np.testing.assert_array_equal(hist["cv_agg"]["valid auc"],
                                  res["valid auc-mean"])
    pd = pytest.importorskip("pandas")
    df = pd.DataFrame(X, columns=[f"f{i}" for i in range(X.shape[1])])
    framed = lgt.cv({**BIN, **CPU},
                    lgt.Dataset(df, label=y, params=CPU,
                                free_raw_data=False),
                    num_boost_round=6, nfold=3)
    np.testing.assert_array_equal(framed["valid auc-mean"],
                                  res["valid auc-mean"])
    with pytest.raises(ValueError, match="free_raw_data=False"):
        lgt.cv({**BIN, **CPU}, lgt.Dataset(X, label=y, params=CPU), 2)
