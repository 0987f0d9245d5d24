"""PyTorch port, the tensorized ensemble on the CPU: every case of
``tests/test_compiled_predict.py`` against the JAX package's
``CompiledEnsemble`` on the same model text — categorical bitsets, NaN
missing, zero_as_missing, multiclass, leaf indices, iteration windows,
the warmed ladder — plus a 255-leaf tree whose packed int16 child fields
must sign-extend through PyTorch's shifts.

Contracts: leaf indices exactly equal; ``predict`` bit-equal (the same
leaves, then f64 sums in tree order, then the same finalize);
``predict_device`` within rtol 1e-6 of ``predict`` (f32 sums). Feature
values are grid-quantized (multiples of 1/8) so f32 and f64 thresholds
never straddle a sample: the f32 walk then also agrees bit for bit with
the port's f64 ``PredictSession``.
"""

import numpy as np
import pytest

import lightgbm_tpu as lgb
import lightgbm_tpu_torch as lgt
from lightgbm_tpu.codegen import CompiledEnsemble as JaxCompiled
from lightgbm_tpu_torch.codegen import CompiledEnsemble, tensorize_ensemble
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
_BASE = {"verbosity": -1, "num_leaves": 15, "min_data_in_leaf": 5,
         "learning_rate": 0.2}


def _grid(rng, n, f):
    return np.round(rng.normal(size=(n, f)) * 8) / 8.0


def _train(params, X, y, rounds=5, **ds_kw):
    """JAX-trained model and its port twin over one model text."""
    jb = lgb.train(dict(_BASE, **params),
                   lgb.Dataset(X, label=y, free_raw_data=False, **ds_kw),
                   num_boost_round=rounds)
    return jb, lgt.Booster(model_str=jb.model_to_string(), params=CPU)


def _port_train(params, X, y, rounds=5):
    """Port-trained model and its JAX twin over one model text."""
    p = dict(_BASE, **params, **CPU)
    tb = lgt.train(p, lgt.Dataset(X, label=y, params=p), rounds)
    return lgb.Booster(model_str=tb.model_to_string()), tb


def _cat_nan_data(seed=3, n=600, f=6):
    rng = np.random.RandomState(seed)
    X = _grid(rng, n, f)
    X[rng.rand(n, f) < 0.1] = np.nan
    X[:, 0] = rng.randint(0, 8, size=n).astype(np.float64)
    X[rng.rand(n) < 0.1, 0] = np.nan
    y = ((np.nan_to_num(X[:, 1]) + (X[:, 0] == 3)) > 0.2).astype(float)
    return X, y


def _assert_parity(jb, tb, X, **kw):
    got = CompiledEnsemble(tb, **kw).predict(X)
    want = JaxCompiled(jb, **kw).predict(X)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, tb.predict_session(**kw).predict(X))
    return got


def test_parity_categorical_nan_missing():
    X, y = _cat_nan_data()
    jb, tb = _train({"objective": "binary"}, X, y, categorical_feature=[0])
    assert any(t.num_cat for t in tb._all_trees())
    _assert_parity(jb, tb, X)


def test_parity_zero_as_missing():
    rng = np.random.RandomState(5)
    X = _grid(rng, 500, 5)
    X[rng.rand(500, 5) < 0.25] = 0.0   # exact zeros route as missing
    y = (X[:, 0] + 0.5 * X[:, 1] > 0).astype(float)
    jb, tb = _train({"objective": "binary", "zero_as_missing": True}, X, y)
    _assert_parity(jb, tb, X)


@pytest.mark.parametrize("trained_by", ["jax", "port"])
def test_parity_multiclass_and_raw_score(trained_by):
    rng = np.random.RandomState(7)
    X = _grid(rng, 600, 6)
    y = (X[:, :3] + 0.5 * rng.normal(size=(600, 3))).argmax(1) \
        .astype(float)
    params = {"objective": "multiclass", "num_class": 3, "num_leaves": 7}
    jb, tb = (_train if trained_by == "jax" else _port_train)(params, X, y)
    _assert_parity(jb, tb, X)
    _assert_parity(jb, tb, X, raw_score=True)


@pytest.fixture(scope="module")
def binary_model():
    rng = np.random.RandomState(11)
    X = _grid(rng, 500, 5)
    y = (X[:, 0] + 0.5 * X[:, 1] > 0).astype(float)
    return (X,) + _train({"objective": "binary"}, X, y)


def test_parity_leaf_index(binary_model):
    X, jb, tb = binary_model
    got = _assert_parity(jb, tb, X, pred_leaf=True)
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, jb.predict(X, pred_leaf=True))


def test_ladder_warm_places_once(binary_model):
    """Warming the batch ladder places the tables once and runs every
    rung; replaying the rungs afterwards places nothing new and stays
    bit-equal to the session (nothing compiles in eager PyTorch, so the
    placement count stands in for the JAX test's compile count)."""
    X, jb, tb = binary_model
    ce = CompiledEnsemble(tb)
    rungs = (8, 16, 32)
    ce.warm(rungs)
    d = ce.describe()
    assert d["warmed_rungs"] == list(rungs) and d["placed_devices"] == 1
    sess = tb.predict_session()
    for r in rungs:
        Z = np.ascontiguousarray(X[:r])
        np.testing.assert_array_equal(ce.predict(Z), sess.predict(Z))
    assert ce.describe()["placed_devices"] == 1


def test_window_and_version_guard():
    """start/num_iteration windows match the JAX view, and a mutated
    booster invalidates the compiled snapshot (own booster, trained by
    the port so that it can take another iteration)."""
    rng = np.random.RandomState(13)
    X = _grid(rng, 300, 4)
    y = (X[:, 0] > 0).astype(float)
    jb, tb = _port_train({"objective": "binary", "num_leaves": 7}, X, y)
    _assert_parity(jb, tb, X, start_iteration=1, num_iteration=2)
    ce = CompiledEnsemble(tb, start_iteration=1, num_iteration=2)
    tb.update()
    with pytest.raises(RuntimeError):
        ce.predict(X[:8])


def test_predict_device_within_f32(binary_model):
    X, jb, tb = binary_model
    ce = CompiledEnsemble(tb, raw_score=True)
    dev = ce.predict_device(X)
    np.testing.assert_allclose(dev, ce.predict(X), rtol=1e-6, atol=1e-9)
    np.testing.assert_allclose(dev, JaxCompiled(jb, raw_score=True)
                               .predict_device(X), rtol=1e-6, atol=1e-9)


def test_refuses_what_it_cannot_tensorize(binary_model):
    X, jb, tb = binary_model
    with pytest.raises(ValueError, match="pred_contrib"):
        CompiledEnsemble(tb, pred_contrib=True)
    with pytest.raises(ValueError, match="early"):
        CompiledEnsemble(tb, pred_early_stop=True)
    with pytest.raises(ValueError):
        CompiledEnsemble(tb).predict(X[:, :3])


def test_255_leaf_tree_sign_extends_children():
    """A 255-leaf tree: leaf references ~0..~254 are negative int16
    halves of the packed children word, which must sign-extend through
    PyTorch's int32 shifts; leaves equal the JAX walk's and the port's
    f64 walk's."""
    rng = np.random.RandomState(17)
    n = 2000
    X = _grid(rng, n, 6)
    y = X[:, 0] * 2 + np.sin(3 * X[:, 1]) + X[:, 2] * X[:, 3]
    jb, tb = _train({"objective": "regression", "num_leaves": 255,
                     "min_data_in_leaf": 2, "max_bin": 255}, X, y,
                    rounds=2)
    assert max(t.num_leaves for t in tb._all_trees()) == 255
    tables, _ = tensorize_ensemble(tb._all_trees())
    right = (tables.children << 16) >> 16
    assert (right < -200).any() and ((tables.children >> 16) < -200).any()
    got = _assert_parity(jb, tb, X, pred_leaf=True)
    assert got.max() > 200
    np.testing.assert_array_equal(got, tb.predict(X, pred_leaf=True))
    _assert_parity(jb, tb, X)
