"""PyTorch port, the training step on the CPU.

The port's step (``GBDT._step_impl`` over static buffers, the
counterpart of the JAX package's ``_fused_step_impl``) against its eager
loop (``fused_train=false``) and against the JAX package:

- bagging, plain and balanced, with ``feature_fraction=0.7``: the port's
  trees equal the JAX package's (the same host RNG streams), raw
  predictions within 1e-5;
- the step against the eager loop: bit-identical trees and final train
  and valid scores for binary, class-batched, per-class, bagging, GOSS
  (crossing its start iteration inside the run), quantized training
  (both split arms, class-batched and per-class, with leaf renewal),
  regression objectives, EFB-bundled one-hot blocks, a sorted-subset
  categorical column (each also under GOSS) and a learning rate changed
  between iterations;
- a deferred run (``eval_period`` = iterations) against an eager run
  synced every iteration: trees equal one by one (each pending entry is
  a copy of the step's static output, not an alias of it);
- ``nan_guard=raise`` with the scores poisoned in place: the port raises
  ``NumericDivergenceError`` at the iteration the JAX package raises at,
  from the step at any ``eval_period`` and from the eager loop; ``off``
  does not raise;
- the step's gate reasons, and ``nan_guard=rollback`` /
  ``bagging_by_query`` refused at construction.

tests/conftest.py pins the JAX package's legacy loop through
``LIGHTGBM_TPU_FUSED_TRAIN=0``, which the port reads too; these tests
set it per test.
"""

import numpy as np
import pytest
import torch

import lightgbm_tpu as lgb
import lightgbm_tpu_torch as lgt
from lightgbm_tpu.resilience.guards import \
    NumericDivergenceError as JaxDivergence
from lightgbm_tpu_torch import convert
from lightgbm_tpu_torch.resilience.guards import NumericDivergenceError

@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread for these small tensors: the same results,
    and far less CPU time when several test workers share the host."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


CPU = {"device_type": "cpu"}
BINARY = {"objective": "binary", "metric": "auc", "num_leaves": 15,
          "leaf_batch": 4, "max_bin": 16, "min_data_in_leaf": 10,
          "learning_rate": 0.2, "verbosity": -1}
MULTI = {**BINARY, "objective": "multiclass", "num_class": 3,
         "metric": "multi_logloss", "hist_dtype": "float32"}
BAGGING = {"bagging_freq": 2, "bagging_fraction": 0.6,
           "feature_fraction": 0.7}


def _data(rng, n=3000, f=8, multiclass=False, kind=None):
    X = rng.normal(size=(n, f))
    X[rng.rand(n) < 0.05, 2] = np.nan
    if kind == "onehot":
        # an 8-way and a 4-way one-hot block: EFB bundles them
        X = np.concatenate([X, np.eye(8)[rng.randint(0, 8, size=n)],
                            np.eye(4)[rng.randint(0, 4, size=n)]], 1)
        X[:, 0] += X[:, f + 1] - X[:, f + 9]
    elif kind == "categorical":
        # a 30-category column (sorted-subset path)
        X[:, 5] = rng.randint(0, 30, size=n)
        X[:, 0] += rng.normal(size=30)[X[:, 5].astype(int)]
    if multiclass:
        logits = np.stack([X[:, 0] * 1.5, np.nan_to_num(X[:, 1]) ** 2 - 0.5,
                           X[:, 3] - X[:, 4]], 1)
        y = (logits + rng.normal(scale=0.7, size=(n, 3))).argmax(1)
    else:
        y = (X[:, 0] * 1.5 - np.nan_to_num(X[:, 1]) ** 2 * 0.7
             + rng.normal(scale=0.5, size=n) > 0)
    y = y.astype(float)
    cut = n * 3 // 4
    return X[:cut], y[:cut], X[cut:], y[cut:]


def _tree_key(t):
    return (t.num_leaves, tuple(t.split_feature), tuple(t.threshold_bin),
            tuple(t.decision_type), tuple(t.left_child),
            tuple(t.right_child))


def _port_train(params, X, y, Xv, yv, rounds, fused, monkeypatch,
                bin_mappers=None, callbacks=()):
    monkeypatch.setenv("LIGHTGBM_TPU_FUSED_TRAIN", "1" if fused else "0")
    p = {**params, **CPU}
    tr = lgt.Dataset(X, label=y, params=p, bin_mappers=bin_mappers)
    va = lgt.Dataset(Xv, label=yv, reference=tr)
    buffers = set()

    def record_buffers(env):
        gbdt = env.model._gbdt
        if fused and env.iteration > 0:
            buffers.add((gbdt.scores.data_ptr(), gbdt._step_out.data_ptr(),
                         *(v.data_ptr() for v in gbdt.valid_scores)))
    record_buffers.needs_eval = False
    bst = lgt.train(p, tr, rounds, valid_sets=[va], valid_names=["v"],
                    callbacks=list(callbacks) + [record_buffers])
    assert bst._gbdt.fused_train_ok == fused
    if fused:
        # the step writes its buffers in place and never rebinds them
        # (on the card a replayed graph writes exactly these)
        assert len(buffers) == 1
    return bst


def _assert_same_run(a, b):
    """Bit-identical trees and live train/valid scores."""
    ta, tb = a._trees, b._trees
    assert len(ta) == len(tb)
    for x, y in zip(ta, tb):
        assert _tree_key(x) == _tree_key(y)
        assert np.array_equal(x.leaf_value, y.leaf_value)
        assert np.array_equal(x.split_gain, y.split_gain)
    assert torch.equal(a._gbdt.scores, b._gbdt.scores)
    for va, vb in zip(a._gbdt.valid_scores, b._gbdt.valid_scores):
        assert torch.equal(va, vb)


@pytest.mark.parametrize("kind", ["plain", "balanced"])
def test_bagging_matches_jax(rng, monkeypatch, kind):
    X, y, Xv, yv = _data(rng)
    bag = dict(BAGGING) if kind == "plain" else {
        "bagging_freq": 2, "pos_bagging_fraction": 0.7,
        "neg_bagging_fraction": 0.4, "feature_fraction": 0.7}
    p = {**BINARY, **bag}
    jp = {**p, "tree_learner": "serial", "hist_impl": "scatter"}
    jtr = lgb.Dataset(X, label=y, params=jp)
    jb = lgb.train(jp, jtr, 6)
    tb = _port_train(p, X, y, Xv, yv, 6, True, monkeypatch,
                     bin_mappers=convert.bin_mappers_from_state(
                         m.state_arrays() for m in jtr.bin_mappers))
    assert tb._gbdt._bagging
    jt, tt = jb._all_trees(), tb._trees
    assert len(jt) == len(tt) == 6
    for a, b in zip(jt, tt):
        assert _tree_key(a) == _tree_key(b)
        np.testing.assert_allclose(b.leaf_value, a.leaf_value, rtol=1e-5,
                                   atol=1e-7)
        np.testing.assert_allclose(b.internal_count, a.internal_count)
    np.testing.assert_allclose(tb.predict(Xv, raw_score=True),
                               jb.predict(Xv, raw_score=True), atol=1e-5)


GOSS = {"data_sample_strategy": "goss", "learning_rate": 0.5}  # from it 2
QUANT = {"use_quantized_grad": True}
CASES = {
    "binary": (BINARY, False),
    "class_batched": (MULTI, True),
    "per_class": ({**MULTI, "class_batch": "off"}, True),
    "bagging": ({**BINARY, **BAGGING}, False),
    "multiclass_bagging": ({**MULTI, **BAGGING, "bagging_freq": 1}, True),
    "goss": ({**BINARY, **GOSS}, False),
    "goss_class_batched": ({**MULTI, **GOSS}, True),
    "quantized": ({**BINARY, **QUANT}, False),
    "quantized_b1_renew": ({**BINARY, **QUANT, "fused_split": "off",
                            "quant_train_renew_leaf": True}, False),
    "quantized_class_batched_renew": ({**MULTI, **QUANT,
                                       "quant_train_renew_leaf": True}, True),
    "quantized_per_class": ({**MULTI, **QUANT, "class_batch": "off"}, True),
    "goss_quantized": ({**BINARY, **GOSS, **QUANT}, False),
    "regression_l1": ({**BINARY, "objective": "regression_l1",
                       "metric": "l1"}, False),
    "poisson": ({**BINARY, "objective": "poisson", "metric": "poisson"},
                False),
    # EFB (the bundled matrix, B1 in bundle space, unbundled histograms)
    # and sorted-subset categoricals, through the step and the eager loop
    "efb_class_batched": (MULTI, True, "onehot"),
    "efb_quantized": ({**BINARY, **QUANT}, False, "onehot"),
    "cat_sorted_binary": ({**BINARY, "categorical_feature": "5"}, False,
                          "categorical"),
    "cat_sorted_class_batched": ({**MULTI, "categorical_feature": "5"},
                                 True, "categorical"),
    "efb_goss": ({**BINARY, **GOSS}, False, "onehot"),
    "cat_sorted_goss_class_batched": (
        {**MULTI, **GOSS, "categorical_feature": "5"}, True, "categorical"),
}


@pytest.mark.parametrize("case", list(CASES))
def test_step_matches_eager_loop(rng, monkeypatch, case):
    params, mc, *kind = CASES[case]
    X, y, Xv, yv = _data(rng, multiclass=mc, kind=kind[0] if kind else None)
    step = _port_train(params, X, y, Xv, yv, 5, True, monkeypatch)
    eager = _port_train(params, X, y, Xv, yv, 5, False, monkeypatch)
    assert step._gbdt.class_batch_ok == (mc and
                                         params.get("class_batch") != "off")
    if step._gbdt._goss:
        assert step._gbdt._goss_start == 2     # crossed inside the run
    if kind:
        g = step._gbdt
        assert (g._bundle_meta is not None) == (kind[0] == "onehot")
        assert (g._cat_sorted_mask is not None) == (kind[0] == "categorical")
    _assert_same_run(step, eager)


def test_step_reads_a_changed_learning_rate(rng, monkeypatch):
    """A shrinkage set between iterations reaches the step's next run
    through its learning-rate buffer, as it reaches the eager loop."""
    X, y, Xv, yv = _data(rng)

    def decay(env):
        env.model._ensure_gbdt()
        env.model._gbdt.shrinkage = 0.2 * 0.5 ** env.iteration
    decay.before_iteration = True
    step = _port_train(BINARY, X, y, Xv, yv, 4, True, monkeypatch,
                       callbacks=[decay])
    eager = _port_train(BINARY, X, y, Xv, yv, 4, False, monkeypatch,
                        callbacks=[decay])
    _assert_same_run(step, eager)
    assert [t.shrinkage for t in step._trees] == [0.2, 0.1, 0.05, 0.025]


@pytest.mark.parametrize("case", ["binary", "class_batched"])
def test_deferred_ring_holds_each_iteration(rng, monkeypatch, case):
    """eval_period = iterations: every tree stays pending until the end
    and comes back in one transfer, each equal to the eager run's."""
    params, mc = CASES[case]
    X, y, Xv, yv = _data(rng, multiclass=mc)
    n = 6
    step = _port_train({**params, "eval_period": n}, X, y, Xv, yv, n, True,
                       monkeypatch)
    eager = _port_train(params, X, y, Xv, yv, n, False, monkeypatch)
    assert step._gbdt.host_sync_count == 1      # one tree transfer
    assert len({_tree_key(t) for t in step._trees}) > 1
    _assert_same_run(step, eager)


def _jax_divergence_iteration(X, y, Xv, yv, params, poison_at, fused,
                              monkeypatch):
    monkeypatch.setenv("LIGHTGBM_TPU_FUSED_TRAIN", "1" if fused else "0")
    monkeypatch.setenv("LIGHTGBM_TPU_CHAOS_POISON_ITER", str(poison_at))
    p = {**params, "tree_learner": "serial", "hist_impl": "scatter"}
    tr = lgb.Dataset(X, label=y, params=p)
    with pytest.raises(JaxDivergence) as e:
        lgb.train(p, tr, 8, valid_sets=[lgb.Dataset(Xv, label=yv,
                                                    reference=tr)])
    monkeypatch.delenv("LIGHTGBM_TPU_CHAOS_POISON_ITER")
    return e.value.iteration


@pytest.mark.parametrize("fused,eval_period", [(True, 1), (True, 3),
                                               (False, 1)])
def test_nan_guard_raise_matches_jax(rng, monkeypatch, fused, eval_period):
    X, y, Xv, yv = _data(rng)
    poison_at = 4
    params = {**BINARY, "nan_guard": "raise", "eval_period": eval_period}
    want = _jax_divergence_iteration(X, y, Xv, yv, params, poison_at, True,
                                     monkeypatch)
    seen = {}

    def poison(env):
        env.model._ensure_gbdt()
        seen["gbdt"] = env.model._gbdt
        if env.iteration == poison_at:
            # in place: the step reads (and a graph replays over) the
            # score buffer itself
            env.model._gbdt.scores[0, 0] = float("nan")
    poison.before_iteration = True
    with pytest.raises(NumericDivergenceError) as e:
        _port_train(params, X, y, Xv, yv, 8, fused, monkeypatch,
                    callbacks=[poison])
    assert e.value.iteration == want == poison_at
    gbdt = seen["gbdt"]
    assert gbdt.iter_ == poison_at          # rewound to the last good one
    assert len(gbdt.models) == poison_at


@pytest.mark.parametrize("fused", [True, False])
def test_nan_guard_off_does_not_raise(rng, monkeypatch, fused):
    X, y, Xv, yv = _data(rng)

    def poison(env):
        if env.iteration == 2:
            env.model._gbdt.scores[0, 0] = float("nan")
    poison.before_iteration = True
    bst = _port_train(BINARY, X, y, Xv, yv, 5, fused, monkeypatch,
                      callbacks=[poison])
    assert bst._gbdt.current_iteration() >= 2


def test_step_gate_reasons(rng, monkeypatch):
    X, y, _, _ = _data(rng)

    def gbdt(**extra):
        b = lgt.Booster(params={**BINARY, **CPU, **extra},
                        train_set=lgt.Dataset(X, label=y))
        b._ensure_gbdt()
        return b._gbdt
    monkeypatch.delenv("LIGHTGBM_TPU_FUSED_TRAIN", raising=False)
    assert gbdt().fused_train_reason == ""
    assert gbdt(**BAGGING).fused_train_reason == ""     # masks are inputs
    assert gbdt(fused_train=False).fused_train_reason == "fused_train=false"
    monkeypatch.setenv("LIGHTGBM_TPU_FUSED_TRAIN", "0")
    assert gbdt().fused_train_reason == "LIGHTGBM_TPU_FUSED_TRAIN=0"
    monkeypatch.setenv("LIGHTGBM_TPU_FUSED_TRAIN", "1")
    assert gbdt(fused_train=False).fused_train_reason == "fused_train=false"
    # nan_guard=rollback keeps the step (train rolls back through its
    # checkpoints); an out-of-core run's sweeps are host-driven
    assert gbdt(nan_guard="rollback").fused_train_reason == ""
    assert gbdt(out_of_core="on").fused_train_reason == \
        "out-of-core chunk sweeps are host-driven"
    # bagging by query is an input of the step too; it needs queries
    g = gbdt(bagging_by_query=True, **BAGGING)
    assert g.fused_train_reason == "" and g._bagging
    with pytest.raises(ValueError, match="query/group"):
        g._host_bag_mask(0)
    assert gbdt(boosting="dart").fused_train_reason == \
        "boosting mode overrides the iteration loop"
    # bagging_by_query without active bagging samples nothing: accepted
    assert not gbdt(bagging_by_query=True)._bagging
