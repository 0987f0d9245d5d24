"""PyTorch port, the scikit-learn estimators and the plotting functions on
the CPU, against the JAX package (``tests/test_sklearn.py`` and the
plotting cases of ``tests/test_aux.py``):

- ``LGBMRegressor``, ``LGBMClassifier`` (binary with class weights,
  multiclass on string labels) and ``LGBMRanker``: predictions equal to
  the port's ``train`` with the estimator's parameters, and the trees
  of the JAX estimators (structures equal, predictions within 1e-5);
  ``predict_proba``/``classes_``, eval sets with sklearn-style metrics,
  a callable objective, a DataFrame with a category column, sklearn's
  clone/get_params protocol and the not-fitted error;
- ``create_tree_digraph`` gives the JAX package's DOT source on the same
  model text; ``plot_importance``, ``plot_metric``,
  ``plot_split_value_histogram`` and ``plot_tree`` draw (matplotlib's
  Agg backend);
- ``import lightgbm_tpu_torch`` imports none of pandas, pyarrow,
  scikit-learn, matplotlib, graphviz and scipy, and succeeds with them
  blocked.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import lightgbm_tpu as lgb
import lightgbm_tpu_torch as lgt

sklearn = pytest.importorskip("sklearn")
matplotlib = pytest.importorskip("matplotlib")
matplotlib.use("Agg")

CPU = {"device_type": "cpu"}
KW = {"num_leaves": 15, "leaf_batch": 4, "max_bin": 16, "n_estimators": 4,
      "learning_rate": 0.2, "min_child_samples": 10,
      "tree_learner": "serial", "hist_impl": "scatter"}
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _data(seed=0, n=1200):
    rng = np.random.RandomState(seed)
    X = rng.normal(size=(n, 5))
    s = X[:, 0] * 1.5 - X[:, 1] ** 2 * 0.7 + np.sin(X[:, 2])
    return X, s + rng.normal(scale=0.4, size=n)


def _tree_key(t):
    return (t.num_leaves, tuple(t.split_feature), tuple(t.threshold_bin),
            tuple(t.decision_type), tuple(t.left_child),
            tuple(t.right_child))


def _same_trees(port_est, jax_est):
    a, b = port_est.booster_._trees, jax_est.booster_._trees
    assert [_tree_key(t) for t in a] == [_tree_key(t) for t in b]


def _l2(y_true, y_pred):
    return "my_l2", float(np.mean((y_true - y_pred) ** 2)), False


def _estimators(name):
    X, s = _data()
    y_cls = (s > 0).astype(int)
    if name == "regressor":
        return (lgt.LGBMRegressor, lgb.LGBMRegressor, X, s, {},
                {"objective": "regression"})
    if name == "classifier":
        return (lgt.LGBMClassifier, lgb.LGBMClassifier, X, y_cls,
                {}, {"objective": "binary"})
    if name == "multiclass":
        labels = np.array(["lo", "mid", "hi"])[np.digitize(s, [-0.5, 0.8])]
        return (lgt.LGBMClassifier, lgb.LGBMClassifier, X, labels, {},
                {"objective": "multiclass", "num_class": 3})
    groups = [40] * (len(X) // 40)
    rel = np.clip(np.round(s), 0, 3)
    return (lgt.LGBMRanker, lgb.LGBMRanker, X, rel, {"group": groups},
            {"objective": "lambdarank"})


@pytest.mark.parametrize("name", ["regressor", "classifier", "multiclass",
                                  "ranker"])
def test_estimator_matches_train_and_jax(name):
    PortEst, JaxEst, X, y, fit_kw, obj = _estimators(name)
    est = PortEst(**KW, **CPU).fit(X, y, **fit_kw)
    jax = JaxEst(**KW).fit(X, y, **fit_kw)
    _same_trees(est, jax)
    raw = est.predict(X, raw_score=True)
    np.testing.assert_allclose(raw, jax.predict(X, raw_score=True),
                               rtol=1e-5, atol=1e-9)
    # the estimator is train() with its parameters
    p = {**obj, "num_leaves": 15, "leaf_batch": 4, "max_bin": 16,
         "learning_rate": 0.2, "min_data_in_leaf": 10, "verbosity": -1,
         "tree_learner": "serial", "hist_impl": "scatter", **CPU}
    label = y
    if name == "multiclass":
        label = est._le.transform(y)
    ds = lgt.Dataset(X, label=label, group=fit_kw.get("group"), params=p)
    bst = lgt.train(p, ds, KW["n_estimators"])
    assert np.array_equal(bst.predict(X, raw_score=True), raw)
    if name in ("classifier", "multiclass"):
        proba = est.predict_proba(X)
        assert proba.shape == (len(X), len(est.classes_))
        np.testing.assert_allclose(proba.sum(1), 1.0)
        assert set(est.predict(X)) <= set(est.classes_)
        np.testing.assert_allclose(proba, jax.predict_proba(X), rtol=1e-5,
                                   atol=1e-9)


def test_fit_options():
    X, s = _data(1)
    Xv, sv = _data(2, n=400)
    reg = lgt.LGBMRegressor(**KW, **CPU).fit(
        X, s, eval_set=[(Xv, sv)], eval_names=["v"], eval_metric=_l2)
    jreg = lgb.LGBMRegressor(**KW).fit(
        X, s, eval_set=[(Xv, sv)], eval_names=["v"], eval_metric=_l2)
    np.testing.assert_allclose(reg.evals_result_["v"]["my_l2"],
                               jreg.evals_result_["v"]["my_l2"], rtol=1e-6)
    assert reg.n_features_in_ == 5 and reg.n_estimators_ == 4
    assert reg.feature_importances_.sum() > 0
    # class weights, and a callable objective (the binary gradients)
    y = (s > 0.8).astype(int)
    cw = lgt.LGBMClassifier(**KW, **CPU, class_weight="balanced").fit(X, y)
    jcw = lgb.LGBMClassifier(**KW, class_weight="balanced").fit(X, y)
    _same_trees(cw, jcw)

    def logloss(y_true, y_pred):
        p = 1.0 / (1.0 + np.exp(-y_pred))
        return p - y_true, p * (1.0 - p)
    fo = lgt.LGBMRegressor(**KW, **CPU, objective=logloss).fit(X, y)
    jfo = lgb.LGBMRegressor(**KW, objective=logloss).fit(X, y)
    _same_trees(fo, jfo)
    # a category column through the estimator (fault C4's path)
    pd = pytest.importorskip("pandas")
    df = pd.DataFrame(X, columns=list("abcde"))
    df["k"] = pd.Categorical(np.where(s > 0, "p", "n"))
    cat = lgt.LGBMRegressor(**KW, **CPU).fit(df, s)
    assert cat.booster_._pandas_categorical == [["n", "p"]]
    assert cat.feature_name_ == ["a", "b", "c", "d", "e", "k"]
    np.testing.assert_allclose(
        cat.predict(df), lgb.LGBMRegressor(**KW).fit(df, s).predict(df),
        rtol=1e-5, atol=1e-9)


def test_sklearn_protocol():
    from sklearn.base import clone
    est = lgt.LGBMRegressor(**KW, **CPU)
    c = clone(est)
    assert c.get_params()["device_type"] == "cpu"
    assert c.get_params()["num_leaves"] == 15
    with pytest.raises(ValueError, match="not fitted"):
        c.predict(np.zeros((2, 5)))


@pytest.fixture(scope="module")
def booster():
    X, s = _data(3)
    Xv, sv = _data(4, n=300)
    evals = {}
    p = {"objective": "regression", "num_leaves": 15, "leaf_batch": 4,
         "max_bin": 16, "metric": ["l2", "l1"], "verbosity": -1, **CPU}
    ds = lgt.Dataset(X, label=s, params=p)
    bst = lgt.train(p, ds, 4, valid_sets=[lgt.Dataset(Xv, label=sv,
                                                       reference=ds)],
                    callbacks=[lgt.record_evaluation(evals)])
    return bst, evals


def test_plots(booster):
    import matplotlib.pyplot as plt
    bst, evals = booster
    ax = lgt.plot_importance(bst)
    assert len(ax.patches) > 0
    lgt.plot_importance(bst, importance_type="gain", max_num_features=2)
    ax = lgt.plot_metric(evals, metric="l1")
    assert ax.get_ylabel() == "l1" and len(ax.lines) == 1
    with pytest.raises(TypeError):
        lgt.plot_metric(bst)       # a Booster keeps no eval history
    used = int(bst._trees[0].split_feature[0])
    ax = lgt.plot_split_value_histogram(bst, used)
    assert len(ax.patches) > 0
    plt.close("all")


def test_tree_digraph_matches_jax(booster):
    bst, _ = booster
    jb = lgb.Booster(model_str=bst.model_to_string())
    for i in range(bst.num_trees()):
        for info in ((), ("split_gain", "internal_count", "leaf_count")):
            a = lgt.create_tree_digraph(bst, tree_index=i, show_info=info)
            b = lgb.create_tree_digraph(jb, tree_index=i, show_info=info)
            assert a.source == b.source
    assert a.source.startswith("digraph Tree {")
    with pytest.raises(IndexError):
        lgt.create_tree_digraph(bst, tree_index=99)
    import shutil
    if shutil.which("dot"):
        import matplotlib.pyplot as plt
        lgt.plot_tree(bst, tree_index=0)
        plt.close("all")


def test_import_needs_no_optional_package():
    """The package imports with pandas, pyarrow, scikit-learn,
    matplotlib, graphviz and scipy blocked, and loads none of them when
    they are there; the estimators then need scikit-learn."""
    code = r"""
import importlib.abc, sys
BLOCK = ("pandas", "pyarrow", "sklearn", "matplotlib", "graphviz", "scipy",
         "jax", "lightgbm_tpu.")
class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if (name + ".").startswith(BLOCK) or name in BLOCK:
            raise ImportError("blocked: " + name)
sys.meta_path.insert(0, Block())
import lightgbm_tpu_torch as lgt
import lightgbm_tpu_torch.cli, lightgbm_tpu_torch.io
assert not any(m.split(".")[0] in ("pandas", "pyarrow", "sklearn",
               "matplotlib", "graphviz", "scipy", "jax", "lightgbm_tpu")
               for m in sys.modules), sorted(sys.modules)
assert "LGBMClassifier" not in lgt.__all__
try:
    lgt.LGBMClassifier
except AttributeError as e:
    assert "scikit-learn" in str(e)
else:
    raise AssertionError("LGBMClassifier without scikit-learn")
print("ok")
"""
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=120, cwd=REPO,
                       env=dict(os.environ, PYTHONPATH=REPO))
    assert r.returncode == 0 and r.stdout.strip() == "ok", r.stderr[-2000:]
