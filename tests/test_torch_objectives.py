"""PyTorch port, the regression and cross-entropy objectives on the CPU.

Each of the eleven objectives (``regression`` also with ``reg_sqrt``)
against the JAX package's, on arrays and data made from a seeded numpy
RNG, with the JAX package's bin mappers carried across:

- ``get_gradients`` within 1e-6 relative to each array's largest
  magnitude (XLA's CPU ``exp``, ``expm1`` and divisions differ from
  PyTorch's in the last bit for some inputs, and ``1 - y*exp(-s)``
  cancels), ``boost_from_score`` within 1e-12, with and without weights;
- 10 rounds of ``train``: tree structures equal, raw predictions within
  1e-5 of their scale (max(1, largest |prediction|): absolute at unit
  scale, relative for the labels of scale 30; the exp-link objectives
  train at ``hist_dtype=float32``), the default metric within 1e-4
  relative;
- a JAX-trained model predicts in the port within 1e-6 (raw and
  converted), and the port's model text round-trips exactly (``regression
  sqrt`` included) and loads in the JAX package.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lightgbm_tpu as lgb
import lightgbm_tpu_torch as lgt
from lightgbm_tpu.config import Config as JaxConfig
from lightgbm_tpu.objectives import create_objective as jax_objective
from lightgbm_tpu_torch import convert
from lightgbm_tpu_torch.config import Config
from lightgbm_tpu_torch.objectives import create_objective

CPU = {"device_type": "cpu"}
BASE = {"num_leaves": 15, "leaf_batch": 4, "max_bin": 16,
        "min_data_in_leaf": 10, "learning_rate": 0.2, "verbosity": -1}
# name -> (params, label kind); each objective's own parameter
# (alpha, fair_c, tweedie_variance_power, reg_sqrt) is set away from its
# default
OBJECTIVES = {
    "regression": ({"objective": "regression"}, "real"),
    "regression_sqrt": ({"objective": "regression", "reg_sqrt": True},
                        "real"),
    "regression_l1": ({"objective": "regression_l1"}, "real"),
    "huber": ({"objective": "huber", "alpha": 2.0}, "real"),
    "fair": ({"objective": "fair", "fair_c": 10.0}, "real"),
    "poisson": ({"objective": "poisson"}, "count"),
    "quantile": ({"objective": "quantile", "alpha": 0.3}, "real"),
    "mape": ({"objective": "mape"}, "real"),
    "gamma": ({"objective": "gamma"}, "positive"),
    "tweedie": ({"objective": "tweedie", "tweedie_variance_power": 1.3},
                "positive"),
    "cross_entropy": ({"objective": "cross_entropy"}, "unit"),
    "cross_entropy_lambda": ({"objective": "cross_entropy_lambda"}, "unit"),
}
EXP_LINK = ("poisson", "gamma", "tweedie", "cross_entropy_lambda")


def _label(rng, signal, kind):
    if kind == "real":
        return signal * 10.0 + 3.0
    if kind == "count":
        return rng.poisson(np.exp(0.5 * signal)).astype(float)
    if kind == "positive":
        return np.exp(0.5 * signal) + 0.1
    return 1.0 / (1.0 + np.exp(-signal))               # "unit": [0, 1]


def _data(rng, kind, n=4000, f=8):
    X = rng.normal(size=(n, f))
    X[rng.rand(n) < 0.05, 2] = np.nan
    signal = (X[:, 0] * 1.5 - np.nan_to_num(X[:, 1]) ** 2 * 0.7
              + rng.normal(scale=0.5, size=n))
    y = _label(rng, signal, kind)
    w = rng.uniform(0.5, 2.0, size=n)
    return X[:3000], y[:3000], w[:3000], X[3000:], y[3000:], w[3000:]


def _params(name):
    p = {**BASE, **OBJECTIVES[name][0]}
    if name in EXP_LINK:
        p["hist_dtype"] = "float32"
    return p


def _tree_key(t):
    return (t.num_leaves, tuple(t.split_feature), tuple(t.threshold_bin),
            tuple(t.decision_type), tuple(t.left_child),
            tuple(t.right_child))


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("name", list(OBJECTIVES))
def test_gradients_and_init_score_match_jax(rng, name, weighted):
    params, kind = OBJECTIVES[name]
    n = 5000
    signal = rng.normal(size=n)
    y = _label(rng, signal, kind)
    w = rng.uniform(0.5, 2.0, size=n) if weighted else None
    jo = jax_objective(JaxConfig(dict(params)))
    to = create_objective(Config(dict(params)))
    jo.init(y, w)
    to.init(y, w)
    # the label the booster uploads (reg_sqrt retargets it)
    lab = np.asarray(to.label, np.float32)
    assert np.array_equal(lab, np.asarray(jo.label, np.float32))
    score = (rng.normal(size=n) * (0.5 if kind != "real" else 10.0)
             ).astype(np.float32)
    w32 = None if w is None else w.astype(np.float32)
    jg, jh = jo.get_gradients(jnp.asarray(score), jnp.asarray(lab),
                              None if w32 is None else jnp.asarray(w32))
    tg, th = to.get_gradients(torch.from_numpy(score), torch.from_numpy(lab),
                              None if w32 is None else torch.from_numpy(w32))
    assert tg.dtype == th.dtype == torch.float32
    for got, want in ((tg.numpy(), np.asarray(jg)),
                      (th.numpy(), np.asarray(jh))):
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=1e-6 * np.abs(want).max())
    np.testing.assert_allclose(to.boost_from_score(), jo.boost_from_score(),
                               rtol=0, atol=1e-12)
    raw = rng.normal(size=7)
    np.testing.assert_allclose(to.convert_output(raw),
                               jo.convert_output(raw), rtol=1e-15)
    assert to.needs_convert == jo.needs_convert


def _jax_train(p, X, y, w, Xv, yv, wv, rounds):
    rec = {}
    jp = {**p, "tree_learner": "serial", "hist_impl": "scatter"}
    tr = lgb.Dataset(X, label=y, weight=w, params=jp)
    va = lgb.Dataset(Xv, label=yv, weight=wv, reference=tr)
    bst = lgb.train(jp, tr, rounds, valid_sets=[va], valid_names=["v"],
                    callbacks=[lgb.record_evaluation(rec)])
    return bst, tr, rec


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("name", list(OBJECTIVES))
def test_train_matches_jax(rng, name, weighted):
    X, y, w, Xv, yv, wv = _data(rng, OBJECTIVES[name][1])
    if not weighted:
        w = wv = None
    p = _params(name)
    jb, jtr, jrec = _jax_train(p, X, y, w, Xv, yv, wv, 10)
    tp = {**p, **CPU}
    tr = lgt.Dataset(X, label=y, weight=w, params=tp,
                     bin_mappers=convert.bin_mappers_from_state(
                         m.state_arrays() for m in jtr.bin_mappers))
    va = lgt.Dataset(Xv, label=yv, weight=wv, reference=tr)
    trec = {}
    tb = lgt.train(tp, tr, 10, valid_sets=[va], valid_names=["v"],
                   callbacks=[lgt.record_evaluation(trec)])
    jt, tt = jb._all_trees(), tb._trees
    assert len(jt) == len(tt) == 10
    for a, b in zip(jt, tt):
        assert _tree_key(a) == _tree_key(b)
    pj = jb.predict(Xv, raw_score=True)
    pt = tb.predict(Xv, raw_score=True)
    np.testing.assert_allclose(pt, pj, rtol=0,
                               atol=1e-5 * max(1.0, np.abs(pj).max()))
    np.testing.assert_allclose(tb.predict(Xv), jb.predict(Xv), rtol=1e-5,
                               atol=1e-5)
    (metric,) = jrec["v"]
    assert list(trec["v"]) == [metric]
    np.testing.assert_allclose(trec["v"][metric], jrec["v"][metric],
                               rtol=1e-4)
    # the model learns: the metric of the last round beats the first's
    assert trec["v"][metric][-1] < trec["v"][metric][0]


@pytest.mark.parametrize("name", list(OBJECTIVES))
def test_jax_model_predicts_in_port(rng, name):
    X, y, _, Xv, _, _ = _data(rng, OBJECTIVES[name][1])
    p = {**_params(name), "tree_learner": "serial", "hist_impl": "scatter"}
    jb = lgb.train(p, lgb.Dataset(X, label=y, params=p), 4)
    port = convert.booster_from_model_string(jb.model_to_string(),
                                             params=CPU)
    for raw in (True, False):
        np.testing.assert_allclose(port.predict(Xv, raw_score=raw),
                                   jb.predict(Xv, raw_score=raw),
                                   rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("name", list(OBJECTIVES))
def test_save_load_round_trip(rng, name, tmp_path):
    X, y, _, Xv, _, _ = _data(rng, OBJECTIVES[name][1])
    p = {**_params(name), **CPU}
    bst = lgt.train(p, lgt.Dataset(X, label=y, params=p), 4)
    path = tmp_path / "model.txt"
    bst.save_model(str(path))
    text = path.read_text()
    want = ("regression sqrt" if name == "regression_sqrt"
            else p["objective"])
    assert f"objective={want}\n" in text
    again = lgt.Booster(model_file=str(path), params=CPU)
    for raw in (True, False):
        assert np.array_equal(again.predict(Xv, raw_score=raw),
                              bst.predict(Xv, raw_score=raw))
    trees = again.model_to_string().split("end of trees")[0]
    assert trees == bst.model_to_string().split("end of trees")[0]
    # the JAX package reads the port's model text too
    np.testing.assert_allclose(lgb.Booster(model_file=str(path)).predict(Xv),
                               bst.predict(Xv), rtol=1e-6, atol=1e-6)
