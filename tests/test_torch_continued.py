"""PyTorch port, continued training on the CPU, against the JAX package
(mirrors ``tests/test_continued.py``) on data made from a seeded numpy
RNG, with the JAX package's bin mappers carried across. Contract: tree
structures equal (``_tree_key``), leaf values within rtol 1e-5, raw
predictions within 1e-5; internal scores within 2e-4 of ``predict``
(``tests/test_continued.py:35-38``).

- ``init_model`` as a Booster and as a model file, each continuing a
  JAX-trained base model's text in both packages;
- the "raw data" errors of a freed train or valid Dataset;
- early stopping on a continued run offsets ``best_iteration`` by the
  base model's iterations;
- continued RF recomputes ``boost_from_average`` and averages over all
  the trees; continued DART keeps its own tree weights only;
- ``rollback_one_iter`` on a continued model;
- snapshots (fault C3): ``snapshot_freq`` writes
  ``{output_model}.snapshot_iter_{i}`` pruned to ``snapshot_keep``, and
  ``init_model`` continues from one.
"""

import os

import numpy as np
import pytest
import torch

import lightgbm_tpu as lgb
import lightgbm_tpu_torch as lgt
from lightgbm_tpu_torch import convert

CPU = {"device_type": "cpu"}
PARAMS = {"objective": "binary", "num_leaves": 15, "leaf_batch": 4,
          "max_bin": 16, "min_data_in_leaf": 10, "verbosity": -1,
          "metric": "binary_logloss"}
JAX = {"tree_learner": "serial", "hist_impl": "scatter"}


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread for these small tensors: the same results,
    and far less CPU time when several test workers share the host."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _data(rng, n=3000, f=8):
    X = rng.normal(size=(n, f))
    logit = X[:, 0] * 1.2 - 0.8 * X[:, 1] ** 2 + np.sin(X[:, 2])
    y = (logit + 0.3 * rng.normal(size=n) > 0).astype(np.float64)
    return X, y


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


class Pair:
    """Datasets of both packages on the JAX package's bin mappers."""

    def __init__(self, X, y, params):
        self.jp = {**params, **JAX}
        self.tp = {**params, **CPU}
        ref = lgb.Dataset(X, label=y, params=self.jp).construct()
        self.states = [m.state_arrays() for m in ref.bin_mappers]

    def jax(self, X, y, reference=None):
        return lgb.Dataset(X, label=y, params=self.jp, free_raw_data=False,
                           reference=reference)

    def port(self, X, y, reference=None):
        if reference is not None:
            return lgt.Dataset(X, label=y, free_raw_data=False,
                               reference=reference)
        return lgt.Dataset(X, label=y, params=self.tp, free_raw_data=False,
                           bin_mappers=convert.bin_mappers_from_state(
                               self.states))


def _jax_base(pair, X, y, rounds):
    jb = lgb.train(pair.jp, pair.jax(X, y), rounds)
    return jb.model_to_string()


@pytest.mark.parametrize("how", ["booster", "file"])
def test_init_model_continues_jax_model(rng, tmp_path, how):
    X, y = _data(rng)
    pair = Pair(X, y, PARAMS)
    text = _jax_base(pair, X, y, 10)
    if how == "file":
        path = str(tmp_path / "base.txt")
        with open(path, "w") as f:
            f.write(text)
        jinit = tinit = path
    else:
        jinit = lgb.Booster(model_str=text)
        tinit = convert.booster_from_model_string(text, params=CPU)
    jc = lgb.train(pair.jp, pair.jax(X, y), 10, init_model=jinit)
    tc = lgt.train(pair.tp, pair.port(X, y), 10, init_model=tinit)
    assert tc.num_trees() == 20 and tc.current_iteration() == 20
    assert tc._gbdt.num_init_iteration == 10
    _same_trees(jc._all_trees(), tc._all_trees())
    raw = tc.predict(X, raw_score=True)
    np.testing.assert_allclose(raw, jc.predict(X, raw_score=True),
                               atol=1e-5)
    np.testing.assert_allclose(tc._gbdt.eval_scores(-1)[:, 0], raw,
                               rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(tc._gbdt.eval_scores(-1),
                               np.asarray(jc._gbdt.eval_scores(-1)),
                               atol=1e-5)
    # the base trees lead the saved model, and it reloads whole
    back = lgt.Booster(model_str=tc.model_to_string(), params=CPU)
    assert back.num_trees() == 20
    np.testing.assert_array_equal(back.predict(X, raw_score=True), raw)


def test_init_model_requires_raw(rng):
    X, y = _data(rng, n=600)
    pair = Pair(X, y, PARAMS)
    text = _jax_base(pair, X, y, 3)
    base = convert.booster_from_model_string(text, params=CPU)
    ds = lgt.Dataset(X, label=y, params=pair.tp).construct()  # raw freed
    with pytest.raises(ValueError, match="raw data"):
        lgt.train(pair.tp, ds, 3, init_model=base)
    jds = lgb.Dataset(X, label=y, params=pair.jp).construct()
    with pytest.raises(ValueError, match="raw data"):
        lgb.train(pair.jp, jds, 3, init_model=lgb.Booster(model_str=text))
    tr = pair.port(X, y)
    va = lgt.Dataset(X[:100], label=y[:100], reference=tr).construct()
    with pytest.raises(ValueError, match="raw data"):
        lgt.train(pair.tp, tr, 3, valid_sets=[va], init_model=base)
    # the Booster's own path predicts from Datasets that kept their rows
    bst = lgt.Booster(params=pair.tp, train_set=lgt.Dataset(
        X, label=y, params=pair.tp))
    with pytest.raises(ValueError, match="raw data"):
        bst._set_init_model(base)


def test_continued_early_stopping_offsets_best_iteration(rng):
    X, y = _data(rng)
    Xv, yv = _data(np.random.RandomState(7))
    params = {**PARAMS, "learning_rate": 0.5}
    pair = Pair(X, y, params)
    text = _jax_base(pair, X, y, 5)
    params = {"early_stopping_round": 3}
    jtr = pair.jax(X, y)
    jc = lgb.train({**pair.jp, **params}, jtr, 30,
                   valid_sets=[pair.jax(Xv, yv, reference=jtr)],
                   init_model=lgb.Booster(model_str=text))
    ttr = pair.port(X, y)
    tc = lgt.train({**pair.tp, **params}, ttr, 30,
                   valid_sets=[pair.port(Xv, yv, reference=ttr)],
                   init_model=convert.booster_from_model_string(
                       text, params=CPU))
    assert tc.best_iteration == jc.best_iteration
    assert 5 < tc.best_iteration < tc.num_trees() < 35     # it stopped
    pred = tc.predict(X, raw_score=True)
    np.testing.assert_array_equal(
        pred, tc.predict(X, raw_score=True,
                         num_iteration=tc.best_iteration))
    base = lgt.Booster(model_str=text, params=CPU)
    new = sum(t.predict(X) for t in tc._trees[:tc.best_iteration - 5])
    np.testing.assert_allclose(pred, base.predict(X, raw_score=True) + new,
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(pred, jc.predict(X, raw_score=True),
                               atol=1e-5)


RF = {"objective": "binary", "boosting": "rf", "num_leaves": 15,
      "leaf_batch": 4, "max_bin": 16, "bagging_freq": 1,
      "bagging_fraction": 0.7, "verbosity": -1}


def test_continued_rf_uses_boost_from_average(rng):
    X, y = _data(rng, n=1500)
    pair = Pair(X, y, RF)
    text = _jax_base(pair, X, y, 3)
    jc = lgb.train(pair.jp, pair.jax(X, y), 3,
                   init_model=lgb.Booster(model_str=text))
    tc = lgt.train(pair.tp, pair.port(X, y), 3,
                   init_model=convert.booster_from_model_string(
                       text, params=CPU))
    assert tc.num_trees() == 6 and tc._average_output
    assert abs(tc._gbdt._init_scores[0]) > 1e-6
    np.testing.assert_allclose(tc._gbdt._init_scores, jc._gbdt._init_scores,
                               rtol=1e-12)
    _same_trees(jc._all_trees(), tc._all_trees())
    internal = tc._gbdt.eval_scores(-1)[:, 0]
    avg = np.mean([t.predict(X) for t in tc._all_trees()], axis=0)
    np.testing.assert_allclose(internal, avg, rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(tc.predict(X, raw_score=True),
                               jc.predict(X, raw_score=True), atol=1e-5)
    # rollback keeps the average over the base and the remaining trees
    tc.rollback_one_iter()
    jc.rollback_one_iter()
    assert tc.num_trees() == 5
    np.testing.assert_allclose(tc._gbdt.eval_scores(-1),
                               np.asarray(jc._gbdt.eval_scores(-1)),
                               atol=1e-5)


def test_continued_dart_keeps_own_weights(rng):
    X, y = _data(rng, n=1500)
    params = {**PARAMS, "boosting": "dart", "drop_rate": 0.5,
              "skip_drop": 0.0}
    pair = Pair(X, y, params)
    text = _jax_base(pair, X, y, 4)
    jc = lgb.train(pair.jp, pair.jax(X, y), 6,
                   init_model=lgb.Booster(model_str=text))
    tc = lgt.train(pair.tp, pair.port(X, y), 6,
                   init_model=convert.booster_from_model_string(
                       text, params=CPU))
    assert len(tc._gbdt._tree_weight) == 6
    assert tc._gbdt._tree_weight == jc._gbdt._tree_weight
    _same_trees(jc._all_trees(), tc._all_trees())
    np.testing.assert_allclose(tc._gbdt.eval_scores(-1)[:, 0],
                               tc.predict(X, raw_score=True), rtol=2e-4,
                               atol=2e-4)


def test_rollback_on_continued_model(rng):
    X, y = _data(rng)
    pair = Pair(X, y, PARAMS)
    text = _jax_base(pair, X, y, 5)
    jc = lgb.train(pair.jp, pair.jax(X, y), 4,
                   init_model=lgb.Booster(model_str=text))
    tc = lgt.train(pair.tp, pair.port(X, y), 4,
                   init_model=convert.booster_from_model_string(
                       text, params=CPU))
    for b in (jc, tc):
        b.rollback_one_iter()
        b.rollback_one_iter()
    assert tc.num_trees() == 7 and tc.current_iteration() == 7
    after = tc._gbdt.eval_scores(-1)[:, 0]
    np.testing.assert_allclose(after, tc.predict(X, raw_score=True),
                               rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(after, np.asarray(
        jc._gbdt.eval_scores(-1))[:, 0], atol=1e-5)
    jc.update()
    tc.update()
    _same_trees(jc._all_trees(), tc._all_trees())
    # a rollback never reaches into the base model
    for _ in range(5):
        tc.rollback_one_iter()
    assert tc.num_trees() == 5


def test_snapshots_and_resume(rng, tmp_path):
    """Fault C3: the port's train wrote no snapshot. ``snapshot_freq=3``
    over 9 iterations writes iterations 3, 6 and 9 (the JAX package's
    files, trees equal), ``snapshot_keep`` prunes the oldest, and
    ``init_model`` continues from a snapshot."""
    X, y = _data(rng, n=1500)
    params = {**PARAMS, "bagging_fraction": 0.8, "bagging_freq": 1,
              "bagging_seed": 7, "snapshot_freq": 3}
    pair = Pair(X, y, params)
    for pkg, d in (("jax", "j"), ("port", "t")):
        os.makedirs(tmp_path / d)
    jmodel, tmodel = str(tmp_path / "j" / "m.txt"), str(tmp_path / "t" /
                                                       "m.txt")
    lgb.train({**pair.jp, "output_model": jmodel}, pair.jax(X, y), 9)
    full = lgt.train({**pair.tp, "output_model": tmodel}, pair.port(X, y), 9)
    snaps = sorted(f for f in os.listdir(tmp_path / "t")
                   if ".snapshot_iter_" in f)
    assert [int(s.rsplit("_", 1)[1]) for s in snaps] == [3, 6, 9]
    for it in (3, 6, 9):
        jm = lgb.Booster(model_file=f"{jmodel}.snapshot_iter_{it}")
        tm = lgt.Booster(model_file=f"{tmodel}.snapshot_iter_{it}",
                         params=CPU)
        assert tm.num_trees() == it
        _same_trees(jm._all_trees(), tm._all_trees())

    snap6 = tmodel + ".snapshot_iter_6"
    mid = lgt.Booster(model_file=snap6, params=CPU)
    cont = lgt.train({**pair.tp, "output_model": tmodel}, pair.port(X, y),
                     3, init_model=snap6)
    assert cont.num_trees() == 9 and cont.current_iteration() == 9
    mid_trees = mid.model_to_string().split("Tree=0", 1)[1] \
                                     .split("end of trees")[0]
    assert "Tree=0" + mid_trees in cont.model_to_string()
    # the restarted bagging stream draws other masks for trees 7-9
    assert cont.model_to_string() != full.model_to_string()

    # snapshot_keep prunes to the newest files
    kmodel = str(tmp_path / "k" / "m.txt")
    os.makedirs(tmp_path / "k")
    lgt.train({**pair.tp, "output_model": kmodel, "snapshot_freq": 2,
               "snapshot_keep": 2}, pair.port(X, y), 9)
    assert sorted(os.listdir(tmp_path / "k")) == [
        "m.txt.snapshot_iter_6", "m.txt.snapshot_iter_8"]
