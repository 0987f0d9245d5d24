"""PyTorch port, the Booster's model methods on the CPU, against the JAX
package on the same model text (a JAX-trained model loaded in both
packages), on data made from a seeded numpy RNG:

- ``refit``: tree structures unchanged, leaf values within rtol 1e-6 of
  the JAX package's (1e-4 multiclass: XLA's and PyTorch's ``exp`` differ
  in the last bit, ROADMAP C), ``decay_rate=1`` a no-op, a refit toward
  new labels fits them better;
- ``dump_model`` equal, ``trees_to_dataframe`` frames equal;
- ``get_leaf_output``/``set_leaf_output`` (the prediction moves after a
  set), ``shuffle_models`` under the same ``np.random.seed``,
  ``lower_bound``/``upper_bound``, ``num_model_per_iteration``,
  ``free_dataset``, and ``copy``/``deepcopy`` giving the same model
  text.
"""

import copy

import numpy as np
import pytest
import torch

import lightgbm_tpu as lgb
import lightgbm_tpu_torch as lgt

CPU = {"device_type": "cpu"}
BASE = {"num_leaves": 15, "leaf_batch": 4, "max_bin": 16,
        "min_data_in_leaf": 10, "learning_rate": 0.2, "verbosity": -1,
        "tree_learner": "serial", "hist_impl": "scatter"}
TASKS = {
    "binary": ({"objective": "binary"}, 1e-6),
    "regression": ({"objective": "regression", "lambda_l1": 0.1,
                    "lambda_l2": 1.0}, 1e-6),
    "multiclass": ({"objective": "multiclass", "num_class": 3}, 1e-4),
}


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread for these small tensors: the same results,
    and far less CPU time when several test workers share the host."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _data(rng, task, n=2000, f=6):
    X = rng.normal(size=(n, f))
    X[rng.rand(n) < 0.05, 3] = np.nan
    s = X[:, 0] * 1.5 - X[:, 1] ** 2 * 0.7 + np.sin(X[:, 2])
    noise = rng.normal(scale=0.5, size=n)
    if task == "regression":
        return X, s + noise
    if task == "binary":
        return X, (s + noise > 0).astype(float)
    return X, np.digitize(s + noise, [-0.5, 0.8]).astype(float)


def _models(rng, task, rounds=6):
    """A JAX-trained model loaded in both packages, and its data."""
    X, y = _data(rng, task)
    p = {**BASE, **TASKS[task][0]}
    jb = lgb.train(p, lgb.Dataset(X, label=y, params=p), rounds)
    text = jb.model_to_string()
    return (lgb.Booster(model_str=text, params=p),
            lgt.Booster(model_str=text, params={**p, **CPU}), X, y)


def _tree_key(t):
    return (t.num_leaves, tuple(t.split_feature), tuple(t.threshold_bin),
            tuple(t.decision_type), tuple(t.left_child),
            tuple(t.right_child))


@pytest.mark.parametrize("task", list(TASKS))
def test_refit_matches_jax(rng, task):
    jb, tb, X, y = _models(rng, task, rounds=3 if task == "multiclass"
                           else 6)
    X2, y2 = _data(np.random.RandomState(99), task)
    if task == "binary":
        y2 = 1.0 - y2
    elif task == "multiclass":
        y2 = (y2 + 1) % 3
    else:
        y2 = -y2
    jr = jb.refit(X2, y2, decay_rate=0.1)
    tr = tb.refit(X2, y2, decay_rate=0.1)
    rtol = TASKS[task][1]
    assert tr.num_trees() == tb.num_trees()
    for a, b, orig in zip(jr._all_trees(), tr._all_trees(),
                          tb._all_trees()):
        assert _tree_key(b) == _tree_key(orig)
        np.testing.assert_allclose(b.leaf_value, a.leaf_value, rtol=rtol,
                                   atol=1e-9)
    assert not np.allclose(tr._all_trees()[3].leaf_value,
                           tb._all_trees()[3].leaf_value)
    # decay 1.0 keeps every value; the source model is untouched
    same = tb.refit(X2, y2, decay_rate=1.0)
    np.testing.assert_allclose(same.predict(X, raw_score=True),
                               tb.predict(X, raw_score=True), rtol=1e-12)
    np.testing.assert_allclose(tb.predict(X2, raw_score=True),
                               jb.predict(X2, raw_score=True), atol=1e-9)
    if task == "binary":
        eps = 1e-7

        def ll(b):
            p = b.predict(X2)
            return -np.mean(y2 * np.log(p + eps)
                            + (1 - y2) * np.log(1 - p + eps))
        assert ll(tr) < ll(tb)


def test_refit_default_decay_and_trained_booster(rng):
    X, y = _data(rng, "binary")
    p = {**BASE, "objective": "binary", **CPU}
    bst = lgt.train(p, lgt.Dataset(X, label=y, params=p), 4)
    a = bst.refit(X, y)                             # refit_decay_rate 0.9
    b = bst.refit(X, y, decay_rate=0.9)
    for s, t in zip(a._all_trees(), b._all_trees()):
        np.testing.assert_array_equal(s.leaf_value, t.leaf_value)
    with pytest.raises(ValueError, match="custom objective"):
        lgt.Booster(model_str=bst.model_to_string().replace(
            "objective=binary sigmoid:1", "objective=custom"),
            params=CPU).refit(X, y)


@pytest.mark.parametrize("task", ["binary", "multiclass"])
def test_dump_model_and_dataframe_match_jax(rng, task):
    jb, tb, X, y = _models(rng, task)
    assert tb.dump_model() == jb.dump_model()
    assert tb.dump_model(num_iteration=2, start_iteration=1) == \
        jb.dump_model(num_iteration=2, start_iteration=1)
    assert tb.dump_model(importance_type="gain") == \
        jb.dump_model(importance_type="gain")
    pd = pytest.importorskip("pandas")
    pd.testing.assert_frame_equal(tb.trees_to_dataframe(),
                                  jb.trees_to_dataframe())


def test_leaf_output_round_trip(rng):
    jb, tb, X, y = _models(rng, "binary")
    for tree_id, leaf in ((0, 0), (3, 5), (5, 2)):
        assert tb.get_leaf_output(tree_id, leaf) == \
            jb.get_leaf_output(tree_id, leaf)
    before = tb.predict(X, raw_score=True)
    leaves = tb.predict(X, pred_leaf=True)
    old = tb.get_leaf_output(2, 4)
    for b in (jb, tb):
        b.set_leaf_output(2, 4, old + 1.5)
    after = tb.predict(X, raw_score=True)
    moved = leaves[:, 2] == 4
    assert moved.any()
    np.testing.assert_allclose(after[moved] - before[moved], 1.5,
                               rtol=1e-12)
    np.testing.assert_array_equal(after[~moved], before[~moved])
    np.testing.assert_allclose(after, jb.predict(X, raw_score=True),
                               atol=1e-9)
    assert tb.get_leaf_output(2, 4) == old + 1.5


@pytest.mark.parametrize("task,window", [("binary", (0, -1)),
                                         ("binary", (1, 5)),
                                         ("multiclass", (0, -1))])
def test_shuffle_models_matches_jax(rng, task, window):
    jb, tb, X, y = _models(rng, task)
    before = [_tree_key(t) for t in tb._all_trees()]
    for b in (jb, tb):
        np.random.seed(3)
        b.shuffle_models(*window)
    after = [_tree_key(t) for t in tb._all_trees()]
    assert after == [_tree_key(t) for t in jb._all_trees()]
    assert after != before and sorted(after) == sorted(before)
    np.testing.assert_allclose(tb.predict(X, raw_score=True),
                               jb.predict(X, raw_score=True), atol=1e-9)


@pytest.mark.parametrize("task", list(TASKS))
def test_bounds_and_model_counts_match_jax(rng, task):
    jb, tb, X, y = _models(rng, task)
    assert tb.lower_bound() == jb.lower_bound()
    assert tb.upper_bound() == jb.upper_bound()
    assert tb.num_model_per_iteration() == jb.num_model_per_iteration()
    if task != "multiclass":      # the bounds sum over every class's trees
        raw = tb.predict(X, raw_score=True)
        assert tb.lower_bound() <= raw.min()
        assert raw.max() <= tb.upper_bound()
    assert tb.free_dataset() is tb


def test_copy_gives_same_model_text(rng):
    jb, tb, X, y = _models(rng, "binary")
    for f in (copy.copy, copy.deepcopy):
        tc, jc = f(tb), f(jb)
        assert tc is not tb
        assert tc.model_to_string() == f(tc).model_to_string()
        np.testing.assert_array_equal(tc.predict(X), tb.predict(X))
        # the tree section is the JAX package's copy's, line for line
        tt = tc.model_to_string().split("end of trees")[0]
        jt = jc.model_to_string().split("end of trees")[0]
        assert tt == jt
    # a copy of a trained booster carries its trees
    p = {**BASE, "objective": "binary", **CPU}
    bst = lgt.train(p, lgt.Dataset(X, label=y, params=p), 3)
    dup = copy.deepcopy(bst)
    assert dup.num_trees() == 3
    np.testing.assert_array_equal(dup.predict(X), bst.predict(X))
