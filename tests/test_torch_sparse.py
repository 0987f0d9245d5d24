"""PyTorch port, scipy sparse input on the CPU, against the JAX package
(the cases of ``tests/test_wide_sparse.py`` at a small size):

- a Dataset from a CSR or CSC matrix (an Allstate-shaped one-hot block,
  and random sparse floats with NaN, negative and explicit-zero
  entries; bundled and with ``enable_bundle=false``, and with a binning
  sample smaller than the rows): bins and bundle plan bit-equal to the
  JAX ``Dataset``'s on the same matrix and to the port's own bins of
  ``X.toarray()``; a valid set of a CSR against it likewise;
- training through the EFB bundles of a one-hot CSR gives the trees of
  the ``enable_bundle=false`` run, and the JAX package's trees;
- ``Booster.predict`` on CSR and CSC equals the dense prediction, and
  ``predict`` and ``refit`` in several sparse row blocks equal the same
  calls on the dense matrix;
- ``linear_tree`` on sparse input raises, as in the JAX package.
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import lightgbm_tpu as lgb
import lightgbm_tpu_torch as lgt

CPU = {"device_type": "cpu"}
BASE = {"num_leaves": 15, "leaf_batch": 4, "max_bin": 16,
        "min_data_in_leaf": 10, "learning_rate": 0.2, "verbosity": -1,
        "tree_learner": "serial", "hist_impl": "scatter"}


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _one_hot(rng, n_rows, n_vars, card):
    """tests/test_wide_sparse.py::_one_hot_sparse: n_vars categorical
    variables one-hot into ``card`` columns each."""
    cats = rng.randint(0, card, size=(n_rows, n_vars))
    cols = (cats + np.arange(n_vars)[None, :] * card).ravel()
    rows = np.repeat(np.arange(n_rows), n_vars)
    X = sp.csr_matrix((np.ones(n_rows * n_vars), (rows, cols)),
                      shape=(n_rows, n_vars * card))
    return X, cats


def _random_sparse(rng, n_rows=3000, n_cols=30):
    X = sp.random(n_rows, n_cols, density=0.15, format="csr",
                  random_state=rng, data_rvs=lambda k: rng.normal(size=k))
    X.data[::13] = np.nan
    X.data[::7] *= -4.0
    X.data[::29] = 0.0             # explicit zeros stay stored
    return X


CASES = {
    "one_hot": lambda rng: _one_hot(rng, 3000, 12, 8)[0],
    "one_hot_csc": lambda rng: _one_hot(rng, 3000, 12, 8)[0].tocsc(),
    "random_nan": _random_sparse,
    "random_csc": lambda rng: _random_sparse(rng).tocsc(),
}


@pytest.mark.parametrize("extra", [{}, {"enable_bundle": False},
                                   {"bin_construct_sample_cnt": 1000}],
                         ids=["bundled", "unbundled", "sampled"])
@pytest.mark.parametrize("case", list(CASES))
def test_sparse_bins_equal_jax_and_dense(rng, case, extra):
    X = CASES[case](rng)
    y = rng.normal(size=X.shape[0])
    p = {**BASE, **extra}
    jd = lgb.Dataset(X, label=y, params=p).construct()
    td = lgt.Dataset(X, label=y, params={**p, **CPU}).construct()
    dd = lgt.Dataset(X.toarray(), label=y, params={**p, **CPU}).construct()
    assert np.array_equal(td.bins.numpy(), jd.bins)
    assert np.array_equal(td.bins.numpy(), dd.bins.numpy())
    assert td.bins.dtype == dd.bins.dtype
    assert (td.bundle_plan is None) == (jd.bundle_plan is None)
    if td.bundle_plan is not None:
        for a, b in zip(td.bundle_plan.state_arrays(),
                        jd.bundle_plan.state_arrays()):
            assert np.array_equal(a, b)
    for a, b in zip(td.bin_mappers, jd.bin_mappers):
        for x, z in zip(a.state_arrays(), b.state_arrays()):
            assert np.array_equal(x, z)
    if case.startswith("one_hot") and not extra:
        assert td.bundle_plan.num_bundles <= 2 * 12
    # a valid set of CSR rows, encoded into the train set's layout
    Xv = X[:500]
    jv = lgb.Dataset(Xv, label=y[:500], reference=jd, params=p).construct()
    tv = lgt.Dataset(Xv, label=y[:500], reference=td,
                     params={**p, **CPU}).construct()
    assert np.array_equal(tv.bins.numpy(), jv.bins)


@pytest.fixture(scope="module")
def one_hot_runs():
    """EFB, unbundled and JAX runs on one one-hot CSR, 3 trees each."""
    rng = np.random.RandomState(3)
    X, cats = _one_hot(rng, 4000, 16, 8)
    w = rng.normal(size=16)
    y = (w[None, :] * (cats <= 1)).sum(axis=1) + 0.05 * rng.normal(size=4000)
    p = {**BASE, "objective": "regression"}
    efb = lgt.train({**p, **CPU}, lgt.Dataset(X, label=y,
                                              params={**p, **CPU}), 3)
    plain = lgt.train({**p, **CPU, "enable_bundle": False}, lgt.Dataset(
        X, label=y, params={**p, **CPU, "enable_bundle": False}), 3)
    jax = lgb.train(p, lgb.Dataset(X, label=y, params=p), 3)
    return X, efb, plain, jax


def _tree_key(t):
    return (t.num_leaves, tuple(t.split_feature), tuple(t.decision_type),
            tuple(t.left_child), tuple(t.right_child))


def test_efb_trees_equal_unbundled_and_jax(one_hot_runs):
    X, efb, plain, jax = one_hot_runs
    assert efb.train_set.bundle_plan is not None
    assert plain.train_set.bundle_plan is None
    keys = [_tree_key(t) for t in efb._trees]
    assert keys == [_tree_key(t) for t in plain._trees]
    assert keys == [_tree_key(t) for t in jax._trees]
    for a, b in zip(efb._trees, jax._trees):
        np.testing.assert_allclose(a.threshold, b.threshold)
        np.testing.assert_allclose(a.leaf_value, b.leaf_value, rtol=1e-5,
                                   atol=1e-12)


@pytest.mark.parametrize("fmt", ["csr", "csc"])
def test_predict_sparse_equals_dense(one_hot_runs, fmt):
    X, efb, _, jax = one_hot_runs
    Xs = X.asformat(fmt)
    dense = efb.predict(X.toarray())
    assert np.array_equal(efb.predict(Xs), dense)
    assert np.array_equal(efb.predict(Xs, pred_leaf=True),
                          efb.predict(X.toarray(), pred_leaf=True))
    np.testing.assert_allclose(dense, jax.predict(X), rtol=1e-5, atol=1e-9)


@pytest.mark.parametrize("fmt", ["csr", "csc"])
def test_sparse_row_blocks_predict_and_refit(one_hot_runs, fmt,
                                             monkeypatch):
    """Sparse predict and refit in row blocks of 500 rows (8 blocks)
    equal the same calls on the dense matrix."""
    from lightgbm_tpu_torch import engine
    X, efb, _, _ = one_hot_runs
    monkeypatch.setattr(engine, "_SPARSE_BLOCK_BYTES", 8 * X.shape[1] * 500)
    Xs, Xd = X.asformat(fmt), X.toarray()
    assert np.array_equal(efb.predict(Xs, raw_score=True),
                          efb.predict(Xd, raw_score=True))
    y2 = np.sin(np.arange(X.shape[0]) * 0.01)
    assert (efb.refit(Xs, y2, decay_rate=0.3).model_to_string()
            == efb.refit(Xd, y2, decay_rate=0.3).model_to_string())


def test_linear_tree_on_sparse_raises(rng):
    X = _random_sparse(rng, 500, 10)
    p = {**BASE, **CPU, "linear_tree": True}
    with pytest.raises(ValueError, match="sparse"):
        lgt.Dataset(X, label=rng.normal(size=500), params=p).construct()
