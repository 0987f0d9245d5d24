"""PyTorch port, the predict path on the CPU: ``Booster.predict`` (raw and
converted scores, ``pred_leaf``, ``pred_contrib``, ``pred_early_stop``)
and ``PredictSession`` against the JAX package's ``Booster.predict`` on
the same model text, with models trained by both packages (binary with
NaN, a categorical bitset with NaN missing and zero_as_missing by the
JAX package; 7-class multiclass, regression and a binary model under
the ``application`` alias by the port).

Contracts: leaf indices exactly equal; scores, SHAP values and
early-stopped scores within 1e-12 (both sides walk in f64 and add the
trees in tree order; on these models they agree bit for bit); SHAP rows
sum to the raw score within 1e-9. Feature values sit on a 1/8 grid, as in
``tests/test_compiled_predict.py``. Every comparison keeps rows x trees
below 2^16, where the JAX package predicts in f64 on the host (or its
native f64 route), never in its f32 device walk.
"""

import numpy as np
import pytest

import lightgbm_tpu as lgb
import lightgbm_tpu_torch as lgt

CPU = {"device_type": "cpu"}
BASE = {"verbosity": -1, "num_leaves": 15, "min_data_in_leaf": 5,
        "learning_rate": 0.2}
ROUNDS = 10


def _grid(rng, n, f):
    return np.round(rng.normal(size=(n, f)) * 8) / 8.0


def _make(kind, rng, n=900, f=6):
    X = _grid(rng, n, f)
    ds_kw = {}
    params = {"objective": "binary"}
    if kind == "binary_nan":
        X[rng.rand(n, f) < 0.1] = np.nan
        y = (np.nan_to_num(X[:, 0]) + 0.5 * np.nan_to_num(X[:, 1])
             > 0).astype(float)
    elif kind == "categorical_nan":
        X[rng.rand(n, f) < 0.1] = np.nan
        X[:, 0] = rng.randint(0, 8, size=n).astype(np.float64)
        X[rng.rand(n) < 0.1, 0] = np.nan
        y = ((np.nan_to_num(X[:, 1]) + np.isin(X[:, 0], [1, 3, 6]))
             > 0.2).astype(float)
        ds_kw = {"categorical_feature": [0]}
        params = {"objective": "binary", "min_data_per_group": 5,
                  "cat_smooth": 1.0}
    elif kind == "zero_as_missing":
        X[rng.rand(n, f) < 0.25] = 0.0
        y = (X[:, 0] + 0.5 * X[:, 1] > 0).astype(float)
        params = {"objective": "binary", "zero_as_missing": True}
    elif kind == "multiclass7":
        y = (X[:, :7 - 1].sum(1) * 1.5 + rng.normal(size=n)).clip(
            -3.4, 3.4)
        y = np.floor(y + 3.5).astype(float)        # 7 classes, 0..6
        params = {"objective": "multiclass", "num_class": 7,
                  "num_leaves": 7}
    elif kind == "regression":
        X[rng.rand(n, f) < 0.05] = np.nan
        y = np.nan_to_num(X[:, 0]) * 2 + np.sin(np.nan_to_num(X[:, 1]))
        params = {"objective": "regression"}
    elif kind == "binary_alias":
        y = (X[:, 0] - X[:, 2] > 0).astype(float)
        params = {"application": "binary"}
    return X, y, {**BASE, **params}, ds_kw


JAX_TRAINED = ("binary_nan", "categorical_nan", "zero_as_missing")
PORT_TRAINED = ("multiclass7", "regression", "binary_alias")
KINDS = JAX_TRAINED + PORT_TRAINED


@pytest.fixture(scope="module")
def models():
    """kind -> (X, JAX Booster, port Booster) over one model text."""
    out = {}
    for i, kind in enumerate(KINDS):
        X, y, params, ds_kw = _make(kind, np.random.RandomState(100 + i))
        if kind in JAX_TRAINED:
            jb = lgb.train(params, lgb.Dataset(X, label=y, **ds_kw), ROUNDS)
            tb = lgt.Booster(model_str=jb.model_to_string(), params=CPU)
        else:
            p = {**params, **CPU}
            tb = lgt.train(p, lgt.Dataset(X, label=y, params=p, **ds_kw),
                           ROUNDS)
            jb = lgb.Booster(model_str=tb.model_to_string())
        out[kind] = (X, jb, tb)
    trees = {k: v[2]._all_trees() for k, v in out.items()}
    # the models reach what they are here for: bitsets over several
    # categories, NaN and zero missing types, K trees an iteration
    assert any(len(t.cat_threshold) and t.num_cat
               for t in trees["categorical_nan"])
    assert any(((np.asarray(t.decision_type) >> 2) & 3 == 2).any()
               for t in trees["binary_nan"])
    assert any(((np.asarray(t.decision_type) >> 2) & 3 == 1).any()
               for t in trees["zero_as_missing"])
    assert len(trees["multiclass7"]) == 7 * ROUNDS
    return out


@pytest.mark.parametrize("kind", KINDS)
def test_scores_match_jax(models, kind):
    X, jb, tb = models[kind]
    sess = tb.predict_session()
    raw_sess = tb.predict_session(raw_score=True)
    for raw_score, got_sess in ((False, sess), (True, raw_sess)):
        want = jb.predict(X, raw_score=raw_score)
        got = tb.predict(X, raw_score=raw_score)
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)
        np.testing.assert_allclose(got_sess.predict(X), want, rtol=0,
                                   atol=1e-12)
    # iteration windows resolve to the same trees
    np.testing.assert_allclose(
        tb.predict(X, start_iteration=2, num_iteration=3, raw_score=True),
        jb.predict(X, start_iteration=2, num_iteration=3, raw_score=True),
        rtol=0, atol=1e-12)


@pytest.mark.parametrize("kind", KINDS)
def test_pred_leaf_matches_jax(models, kind):
    X, jb, tb = models[kind]
    want = jb.predict(X, pred_leaf=True)
    got = tb.predict(X, pred_leaf=True)
    assert got.dtype == np.int32 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        tb.predict_session(pred_leaf=True).predict(X), want)
    np.testing.assert_array_equal(
        tb.predict(X, pred_leaf=True, start_iteration=1, num_iteration=2),
        jb.predict(X, pred_leaf=True, start_iteration=1, num_iteration=2))


@pytest.mark.parametrize("kind", KINDS)
def test_pred_contrib_matches_jax(models, kind):
    X, jb, tb = models[kind]
    Xs = X[:200]
    want = jb.predict(Xs, pred_contrib=True)
    got = tb.predict(Xs, pred_contrib=True)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)
    # local accuracy: each class block sums to that class's raw score
    raw = tb.predict(Xs, raw_score=True).reshape(len(Xs), -1)
    K = raw.shape[1]
    blocks = got.reshape(len(Xs), K, X.shape[1] + 1).sum(axis=2)
    np.testing.assert_allclose(blocks, raw, rtol=0, atol=1e-9)


@pytest.mark.parametrize("kind,margin", [("binary_nan", 1.5),
                                         ("multiclass7", 1.0),
                                         ("binary_alias", 1.0)])
def test_pred_early_stop_matches_jax(models, kind, margin):
    X, jb, tb = models[kind]
    kw = dict(raw_score=True, pred_early_stop=True, pred_early_stop_freq=2,
              pred_early_stop_margin=margin)
    full = tb.predict(X, raw_score=True)
    got = tb.predict(X, **kw)
    np.testing.assert_allclose(got, jb.predict(X, **kw), rtol=0, atol=1e-12)
    np.testing.assert_allclose(tb.predict_session(**kw).predict(X), got,
                               rtol=0, atol=1e-12)
    n = len(X)
    stopped = np.abs(full.reshape(n, -1) - got.reshape(n, -1)
                     ).max(axis=1) > 1e-9
    assert stopped.any(), "the margin must stop confident rows early"
    # every frozen row had cleared the margin when it stopped
    es = got.reshape(n, -1)[stopped]
    if es.shape[1] == 1:
        m = 2 * np.abs(es[:, 0])
    else:
        srt = np.sort(es, axis=1)
        m = srt[:, -1] - srt[:, -2]
    assert (m > margin).all()
    # an unreachable margin stops nothing
    np.testing.assert_allclose(
        tb.predict(X, raw_score=True, pred_early_stop=True,
                   pred_early_stop_margin=1e9), full, rtol=0, atol=1e-12)


@pytest.mark.parametrize("kind", ["binary_nan", "categorical_nan"])
def test_contrib_matches_recursive_oracle(models, kind):
    """The vectorized TreeSHAP agrees with the per-row recursion (the
    direct transcription of tree.cpp TreeSHAP), tree by tree."""
    X, _, tb = models[kind]
    for tree in tb._all_trees():
        np.testing.assert_allclose(
            tree.predict_contrib(X[:40]),
            tree.predict_contrib_reference(X[:40]), rtol=1e-9, atol=1e-12)


def test_packed_ensemble_depth_clamp():
    """pack_ensemble's depth bounds the device walk: the clamp never
    truncates a walk (the walk equals the host per-tree walk exactly),
    and it covers the deepest leaf."""
    from lightgbm_tpu_torch.ops.predict_ensemble import pack_ensemble, walk
    import torch
    rng = np.random.RandomState(3)
    X = rng.normal(size=(2000, 6))
    y = X[:, 0] * 2 + np.sin(3 * X[:, 1])
    p = {"objective": "regression", "num_leaves": 63, "min_data_in_leaf": 5,
         "verbosity": -1, **CPU}
    trees = lgt.train(p, lgt.Dataset(X, label=y, params=p), 4)._all_trees()
    ens = pack_ensemble(trees, "cpu")
    # a 63-leaf tree needs depth in [log2(63), 62]
    assert 6 <= ens.max_depth <= max(t.num_leaves for t in trees) - 1
    host = np.stack([t.predict(X) for t in trees], axis=1)
    np.testing.assert_array_equal(walk(ens, torch.from_numpy(X)).numpy(),
                                  host)


def test_pred_early_stop_ignored_for_regression(models):
    X, jb, tb = models["regression"]
    kw = dict(pred_early_stop=True, pred_early_stop_margin=0.0)
    np.testing.assert_array_equal(tb.predict(X, **kw), tb.predict(X))
    np.testing.assert_allclose(tb.predict(X, **kw), jb.predict(X, **kw),
                               rtol=0, atol=1e-12)
    with pytest.raises(ValueError):
        models["binary_nan"][2].predict(X, pred_early_stop=True,
                                        pred_early_stop_freq=0)


def test_session_cache_invalidation_on_version_move():
    """A PredictSession keeps serving across model mutations: its
    snapshot and the Booster's pack rebuild on the first predict after
    the version moves (training, model reload), and results always
    match a fresh Booster."""
    X, y, params, _ = _make("binary_nan", np.random.RandomState(7), n=600)
    p = {**params, **CPU}
    bst = lgt.train(p, lgt.Dataset(X, label=y, params=p), 4)
    Xf = np.ascontiguousarray(X, np.float32)
    sess = bst.predict_session(raw_score=True)
    p1 = sess.predict(Xf)
    v1, key1 = sess._snapshot[0], bst._pack[0]
    assert key1 == (v1, 0, 4, "cpu")
    np.testing.assert_array_equal(p1, sess.predict(Xf))     # stable cache
    assert bst._pack[0] == key1                            # no churn
    text1 = bst.model_to_string()

    bst.update()                                           # model moves
    p2 = sess.predict(Xf)
    assert sess._snapshot[0] != v1, "session did not see the new model"
    assert bst._pack[0] != key1, "the pack was not rebuilt"
    assert not np.allclose(p1, p2)
    fresh = lgt.Booster(model_str=bst.model_to_string(), params=CPU)
    np.testing.assert_array_equal(p2, fresh.predict(X, raw_score=True))

    bst.model_from_string(text1)                           # reload
    np.testing.assert_array_equal(sess.predict(Xf), p1)
    # f32 input widens exactly; a non-contiguous matrix copies
    np.testing.assert_array_equal(sess.predict(np.asfortranarray(Xf)), p1)


def test_reload_never_caches_old_trees_under_new_version(models,
                                                        monkeypatch):
    """A predict that runs while a model text loads (here: from inside
    the parse) packs the old trees under the old version, so the first
    predict after the load repacks and answers with the new trees, even
    when both models have the same tree count (the pack key's window)."""
    from lightgbm_tpu_torch import engine
    X, jb_a, tb_a = models["binary_nan"]
    _, jb_b, tb_b = models["zero_as_missing"]
    assert len(tb_a._trees) == len(tb_b._trees)
    want_a = tb_a.predict(X, raw_score=True)
    bst = lgt.Booster(model_str=jb_b.model_to_string(), params=CPU)
    sess = bst.predict_session(raw_score=True)
    before = sess.predict(X)
    real = engine.Tree.from_text
    seen = []

    def from_text(block):
        if not seen:
            seen.append(sess.predict(X))         # a reader mid-load
        return real(block)

    monkeypatch.setattr(engine.Tree, "from_text", staticmethod(from_text))
    bst.model_from_string(jb_a.model_to_string())
    np.testing.assert_array_equal(seen[0], before)
    np.testing.assert_array_equal(sess.predict(X), want_a)


def test_predict_refuses_default_device_without_gpu(models):
    """A model file loaded with the default device_type raises at the
    first predict on a host where torch sees no GPU (the port never
    moves to the CPU on its own)."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("a GPU is visible")
    X, jb, _ = models["binary_nan"]
    with pytest.raises(RuntimeError, match="device_type"):
        lgt.Booster(model_str=jb.model_to_string()).predict(X)
