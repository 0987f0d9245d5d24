"""PyTorch port, GOSS on the CPU, against the JAX package.

- ``_goss_impl``: the in-bag mask and the amplified g and h are
  bit-equal to the JAX package's on the same g, h and key, also where
  most scores tie (``regression_l1``: |g*h| takes two values), which the
  top set breaks toward the lower row as ``lax.top_k`` does;
- ``train`` with ``data_sample_strategy=goss`` and ``learning_rate=0.5``
  (GOSS from iteration 2 on), 8 rounds, binary, multiclass (two data
  draws, the second with noise-level splits screened by
  ``min_gain_to_split``) and ``regression_l1``: tree structures equal,
  raw predictions within 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lightgbm_tpu as lgb
import lightgbm_tpu_torch as lgt
from lightgbm_tpu_torch import convert
from lightgbm_tpu_torch.ops import threefry

@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread for these small tensors: the same results,
    and far less CPU time when several test workers share the host."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


CPU = {"device_type": "cpu"}
GOSS = {"num_leaves": 15, "leaf_batch": 4, "max_bin": 16,
        "min_data_in_leaf": 10, "learning_rate": 0.5, "verbosity": -1,
        "data_sample_strategy": "goss", "top_rate": 0.2, "other_rate": 0.3}
CASES = {
    "binary": ({"objective": "binary"}, "binary"),
    "multiclass": ({"objective": "multiclass", "num_class": 3,
                    "hist_dtype": "float32"}, "multiclass"),
    "regression_l1": ({"objective": "regression_l1"}, "real"),
    # classes cut at the terciles of a noisy score: unscreened, this
    # draw takes a split of gain 6.7e-6 (the tree's largest 7.1) in
    # tree 10 at another threshold in each package, a tie at the noise
    # level; min_gain_to_split screens such splits
    "multiclass_terciles": ({"objective": "multiclass", "num_class": 3,
                             "hist_dtype": "float32",
                             "min_gain_to_split": 1e-3}, "terciles"),
}


def _data(rng, kind, n=4000, f=8):
    X = rng.normal(size=(n, f))
    X[rng.rand(n) < 0.05, 2] = np.nan
    if kind == "multiclass":       # tests/test_torch_multiclass.py's data
        logits = np.stack([X[:, 0] * 1.5, np.nan_to_num(X[:, 1]) ** 2 - 0.5,
                           X[:, 3] - X[:, 4]], 1)
        y = (logits + rng.normal(scale=0.7, size=(n, 3))).argmax(1)
    else:
        y = (X[:, 0] * 1.5 - np.nan_to_num(X[:, 1]) ** 2 * 0.7
             + rng.normal(scale=0.5, size=n))
        if kind == "binary":
            y = y > 0
        elif kind == "terciles":
            y = np.digitize(y, np.quantile(y, [1 / 3, 2 / 3]))
    y = y.astype(float)
    return X[:3000], y[:3000], X[3000:], y[3000:]


def _tree_key(t):
    return (t.num_leaves, tuple(t.split_feature), tuple(t.threshold_bin),
            tuple(t.decision_type), tuple(t.left_child),
            tuple(t.right_child))


def _pad(a, R):
    return np.pad(a, ((0, 0), (0, R - a.shape[1])))


@pytest.mark.parametrize("case", list(CASES))
def test_goss_sample_matches_jax(rng, case):
    extra, kind = CASES[case]
    X, y, _, _ = _data(rng, kind)
    p = {**GOSS, **extra}
    jp = {**p, "tree_learner": "serial", "hist_impl": "scatter"}
    jtr = lgb.Dataset(X, label=y, params=jp)
    jg = lgb.train(jp, jtr, 1)._gbdt
    tb = lgt.Booster(params={**p, **CPU}, train_set=lgt.Dataset(
        X, label=y, params=CPU, bin_mappers=convert.bin_mappers_from_state(
            m.state_arrays() for m in jtr.bin_mappers)))
    tb._ensure_gbdt()
    tg = tb._gbdt
    n, K = len(X), tg.K
    # the objective's own gradients at random scores: under
    # regression_l1 g is the sign of the residual, so scores tie
    score = rng.normal(size=(K, n)).astype(np.float32)
    g, h = tg._grads(torch.from_numpy(_pad(score, tg.train_dd.r_pad)))
    g, h = g[:, :n].numpy(), h[:, :n].numpy()
    if kind == "real":
        assert len(np.unique(np.abs(g * h))) <= 2
    key_j = jax.random.fold_in(jax.random.PRNGKey(3), 7)
    key_t = threefry.fold_in(threefry.prng_key(3), torch.tensor(7))
    Rj, Rt = jg.train_dd.row_leaf0.shape[0], tg.train_dd.r_pad
    jgo, jho, jm = jg._goss_impl(jnp.asarray(_pad(g, Rj)),
                                 jnp.asarray(_pad(h, Rj)), key_j)
    tgo, tho, tm = tg._goss_impl(torch.from_numpy(_pad(g, Rt)),
                                 torch.from_numpy(_pad(h, Rt)), key_t)
    assert np.array_equal(tm[:n].numpy(), np.asarray(jm)[:n])
    assert np.array_equal(tgo[:, :n].numpy(), np.asarray(jgo)[:, :n])
    assert np.array_equal(tho[:, :n].numpy(), np.asarray(jho)[:, :n])
    assert not tm[n:].any()
    # the top_rate rows, and a sample of the rest
    assert set(np.unique(tm.numpy())) == {0.0, 1.0}
    assert int(n * GOSS["top_rate"]) < tm.sum() < n


@pytest.mark.parametrize("case", list(CASES))
def test_goss_train_matches_jax(rng, case):
    extra, kind = CASES[case]
    X, y, Xv, _ = _data(rng, kind)
    p = {**GOSS, **extra}
    jp = {**p, "tree_learner": "serial", "hist_impl": "scatter"}
    jtr = lgb.Dataset(X, label=y, params=jp)
    jb = lgb.train(jp, jtr, 8)
    tp = {**p, **CPU}
    tb = lgt.train(tp, lgt.Dataset(
        X, label=y, params=tp, bin_mappers=convert.bin_mappers_from_state(
            m.state_arrays() for m in jtr.bin_mappers)), 8)
    assert tb._gbdt._goss and tb._gbdt._goss_start == 2
    jt, tt = jb._all_trees(), tb._trees
    assert len(jt) == len(tt) == 8 * tb._gbdt.K
    for a, b in zip(jt, tt):
        assert _tree_key(a) == _tree_key(b)
        np.testing.assert_allclose(b.leaf_value, a.leaf_value, rtol=1e-5,
                                   atol=1e-5 * np.abs(a.leaf_value).max())
    # GOSS samples from iteration 2 on: the root counts fall below n
    counts = [t.internal_count[0] for t in tt[::tb._gbdt.K]]
    assert counts[0] == counts[1] == len(X) and counts[2] < len(X)
    np.testing.assert_allclose(tb.predict(Xv, raw_score=True),
                               jb.predict(Xv, raw_score=True), atol=1e-5)
