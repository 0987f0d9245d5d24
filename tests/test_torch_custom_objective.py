"""PyTorch port, custom objectives on the CPU, against the JAX package
(``tests/test_engine.py:130``, ``tests/test_boosting_modes.py:111-123``)
on data made from a seeded numpy RNG, with the JAX package's bin mappers
carried across. Contract: tree structures equal (``_tree_key``), leaf
values within rtol 1e-5, raw predictions within 1e-5.

- a binary logloss ``fobj`` through ``train``, through
  ``Booster.update(fobj=)`` and as a callable ``objective``; the trees
  equal the built-in binary objective's with ``boost_from_average=false``;
- a multiclass ``fobj`` in both array layouts (flat class-major and
  [n, K]), class-batched, at ``hist_dtype=float32`` (ROADMAP C: XLA's and
  PyTorch's ``exp`` differ in the last bit);
- DART's ``fobj`` sees the dropped scores;
- RF refuses custom objectives and ``update(fobj=)`` without
  ``objective="custom"`` raises, with the JAX package's ``ValueError``s.
"""

import numpy as np
import pytest
import torch

import lightgbm_tpu as lgb
import lightgbm_tpu_torch as lgt
from lightgbm_tpu_torch import convert

CPU = {"device_type": "cpu"}
BASE = {"num_leaves": 15, "leaf_batch": 4, "max_bin": 16,
        "min_data_in_leaf": 10, "learning_rate": 0.2, "verbosity": -1}
K = 3


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread for these small tensors: the same results,
    and far less CPU time when several test workers share the host."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _data(rng, task, n=3000, nv=800, f=6):
    X = rng.normal(size=(n + nv, f))
    s = X[:, 0] * 1.5 - X[:, 1] ** 2 * 0.7 + np.sin(X[:, 2])
    noise = rng.normal(scale=0.5, size=n + nv)
    if task == "binary":
        y = (s + noise > 0).astype(float)
    else:
        y = np.digitize(s + noise, [-0.5, 0.8]).astype(float)
    return X[:n], y[:n], X[n:], y[n:]


def _tree_key(t):
    return (t.num_leaves, tuple(t.split_feature), tuple(t.threshold_bin),
            tuple(t.decision_type), tuple(t.left_child),
            tuple(t.right_child))


def _same_trees(jt, tt):
    assert len(jt) == len(tt)
    for a, b in zip(jt, tt):
        assert _tree_key(a) == _tree_key(b)
        np.testing.assert_allclose(b.leaf_value, a.leaf_value, rtol=1e-5,
                                   atol=1e-7)


def _datasets(X, y, Xv, yv, params):
    jp = {**params, "tree_learner": "serial", "hist_impl": "scatter"}
    jtr = lgb.Dataset(X, label=y, params=jp, free_raw_data=False)
    jtr.construct()
    jva = lgb.Dataset(Xv, label=yv, reference=jtr)
    tp = {**params, **CPU}
    tr = lgt.Dataset(X, label=y, params=tp, free_raw_data=False,
                     bin_mappers=convert.bin_mappers_from_state(
                         m.state_arrays() for m in jtr.bin_mappers))
    va = lgt.Dataset(Xv, label=yv, reference=tr)
    return (jp, jtr, jva), (tp, tr, va)


def logloss_fobj(preds, dataset):
    lab = dataset.get_label()
    p = 1.0 / (1.0 + np.exp(-preds))
    return p - lab, p * (1.0 - p)


def softmax_fobj(layout):
    """Softmax gradients of [n, K] preds, returned [n, K] or flat
    class-major [K * n]."""
    def fobj(preds, dataset):
        lab = dataset.get_label().astype(np.int64)
        e = np.exp(preds - preds.max(axis=1, keepdims=True))
        p = e / e.sum(axis=1, keepdims=True)
        onehot = np.eye(preds.shape[1])[lab]
        # the hessian factor K / (K - 1) of multiclass_objective.hpp:31
        k = preds.shape[1]
        g, h = p - onehot, k / (k - 1.0) * p * (1.0 - p)
        if layout == "flat":
            return g.T.reshape(-1), h.T.reshape(-1)
        return g, h
    return fobj


@pytest.mark.parametrize("how", ["train", "update", "callable"])
def test_binary_fobj_matches_jax(rng, monkeypatch, how):
    X, y, Xv, yv = _data(rng, "binary")
    params = {**BASE, "objective": "custom", "metric": "auc"}
    (jp, jtr, jva), (tp, tr, va) = _datasets(X, y, Xv, yv, params)
    rounds = 6
    if how == "train":
        jb = lgb.train(jp, jtr, rounds, valid_sets=[jva],
                       fobj=logloss_fobj)
        tb = lgt.train(tp, tr, rounds, valid_sets=[va], fobj=logloss_fobj)
    elif how == "callable":
        jb = lgb.train({**jp, "objective": logloss_fobj}, jtr, rounds,
                       valid_sets=[jva])
        tb = lgt.train({**tp, "objective": logloss_fobj}, tr, rounds,
                       valid_sets=[va])
        assert "objective=custom" in tb.model_to_string()
    else:
        jb = lgb.Booster(params=jp, train_set=jtr)
        tb = lgt.Booster(params=tp, train_set=tr)
        for _ in range(rounds):
            jb.update(fobj=logloss_fobj)
            assert tb.update(fobj=logloss_fobj) is False
    assert tb._objective is None
    monkeypatch.delenv("LIGHTGBM_TPU_FUSED_TRAIN", raising=False)
    assert tb._gbdt._fused_gate_reason() == \
        "custom objective gradients are host-supplied"
    _same_trees(jb._all_trees(), tb._trees)
    np.testing.assert_allclose(tb.predict(Xv, raw_score=True),
                               jb.predict(Xv, raw_score=True), atol=1e-5)
    # no objective: predict returns the raw scores
    np.testing.assert_array_equal(tb.predict(Xv),
                                  tb.predict(Xv, raw_score=True))
    # the same gradients as the built-in objective without the average
    bb = lgt.train({**tp, "objective": "binary",
                    "boost_from_average": False},
                   lgt.Dataset(X, label=y, params=tp,
                               bin_mappers=tr.bin_mappers), rounds)
    assert [_tree_key(t) for t in bb._trees] == \
        [_tree_key(t) for t in tb._trees]
    np.testing.assert_allclose(bb.predict(Xv, raw_score=True),
                               tb.predict(Xv, raw_score=True), atol=1e-6)


@pytest.mark.parametrize("layout", ["flat", "n_by_k"])
def test_multiclass_fobj_matches_jax(rng, layout):
    """The JAX package's Config refuses ``objective="custom"`` with
    ``num_class > 1`` (the reference accepts it), so its side hands the
    same gradients to its booster's ``train_one_iter`` under the
    built-in multiclass objective without the average: the build and
    score updates are the custom-gradient path's."""
    X, y, Xv, yv = _data(rng, "multiclass")
    params = {**BASE, "objective": "custom", "num_class": K,
              "hist_dtype": "float32"}
    jparams = {**params, "objective": "multiclass",
               "boost_from_average": False}
    (jp, jtr, jva), _ = _datasets(X, y, Xv, yv, jparams)
    tp = {**params, **CPU}
    tr = lgt.Dataset(X, label=y, params=tp,
                     bin_mappers=convert.bin_mappers_from_state(
                         m.state_arrays() for m in jtr.bin_mappers))
    fobj = softmax_fobj(layout)
    jb = lgb.Booster(params=jp, train_set=jtr)
    jb._ensure_gbdt()
    for _ in range(3):
        jb._model_version += 1
        jb._gbdt.train_one_iter(*fobj(jb._gbdt.get_training_scores(), jtr))
    tb = lgt.train(tp, tr, 3, fobj=fobj)
    assert tb._gbdt.class_batch_ok and tb.num_model_per_iteration() == K
    _same_trees(jb._all_trees(), tb._trees)
    np.testing.assert_allclose(tb.predict(Xv, raw_score=True),
                               jb.predict(Xv, raw_score=True), atol=1e-5)
    assert tb.predict(Xv).shape == (len(Xv), K)
    # the built-in multiclass objective without the average: the same
    # trees from the port's own softmax gradients
    bb = lgt.train({**tp, "objective": "multiclass",
                    "boost_from_average": False},
                   lgt.Dataset(X, label=y, params=tp,
                               bin_mappers=tr.bin_mappers), 3)
    assert [_tree_key(t) for t in bb._trees] == \
        [_tree_key(t) for t in tb._trees]


def test_dart_fobj_sees_dropped_scores(rng):
    X, y, Xv, yv = _data(rng, "binary")
    params = {**BASE, "objective": "custom", "boosting": "dart",
              "drop_rate": 0.4, "skip_drop": 0.0}
    (jp, jtr, jva), (tp, tr, va) = _datasets(X, y, Xv, yv, params)
    seen = {"jax": [], "port": []}

    def recording(key):
        def fobj(preds, dataset):
            seen[key].append(np.array(preds))
            return logloss_fobj(preds, dataset)
        return fobj
    jb = lgb.train(jp, jtr, 8, fobj=recording("jax"))
    tb = lgt.train(tp, tr, 8, fobj=recording("port"))
    assert tb._gbdt._tree_weight == jb._gbdt._tree_weight
    assert len(set(tb._gbdt._tree_weight)) > 1       # trees were dropped
    _same_trees(jb._all_trees(), tb._trees)
    for a, b in zip(seen["jax"], seen["port"]):
        np.testing.assert_allclose(b, a, rtol=0, atol=1e-6)
    # the model and the live scores agree (the JAX test's contract)
    np.testing.assert_allclose(tb.predict(X, raw_score=True),
                               tb._gbdt.eval_scores(-1)[:, 0], rtol=2e-4,
                               atol=2e-4)


def test_rf_refuses_custom_objective(rng):
    X, y, _, _ = _data(rng, "binary")
    p = {**BASE, "objective": "custom", "boosting": "rf",
         "bagging_freq": 1, "bagging_fraction": 0.7}
    for pkg, extra in ((lgb, {}), (lgt, CPU)):
        with pytest.raises(ValueError, match="custom objective"):
            pkg.train({**p, **extra},
                      pkg.Dataset(X, label=y, params={**p, **extra}), 2,
                      fobj=logloss_fobj)
    # and custom gradients handed to an RF booster directly
    pb = {**p, "objective": "binary", **CPU}
    bst = lgt.Booster(params=pb, train_set=lgt.Dataset(X, label=y,
                                                       params=pb))
    bst._ensure_gbdt()
    with pytest.raises(ValueError, match="custom gradients"):
        bst._gbdt.train_one_iter(np.zeros(len(y)), np.ones(len(y)))


def test_update_fobj_needs_custom_objective(rng):
    X, y, _, _ = _data(rng, "binary")
    p = {**BASE, "objective": "binary"}
    for pkg, extra in ((lgb, {}), (lgt, CPU)):
        bst = pkg.Booster(params={**p, **extra},
                          train_set=pkg.Dataset(X, label=y,
                                                params={**p, **extra}))
        with pytest.raises(ValueError, match="objective='custom'"):
            bst.update(fobj=logloss_fobj)
