"""PyTorch port, forced splits (``forcedsplits_filename``;
SerialTreeLearner::ForceSplits) on the CPU against the JAX package, the
JAX tests of tests/test_forced_splits.py less its data-parallel case:
a BFS-forced prefix applies regardless of gain rank, missing values of
a forced numerical node go left, a categorical node is one-hot on its
category, and a node that fails its checks (starved side, no gain, the
depth limit, a category unseen in training) drops with its forced
subtree. Forced splits run the two-pass arm (B1), one split a round,
and the per-class loop. The same seeded data trains through
lightgbm_tpu.train and lightgbm_tpu_torch.train on the same bin mappers;
the model texts' trees are equal in structure and thresholds, with leaf
and internal values within 1e-5 (absolute) and split gains within 1e-4
(relative): f32 sums in another order. The gates return the JAX
package's reasons."""

import json

import numpy as np
import pytest

import lightgbm_tpu as lgb
import lightgbm_tpu_torch as lgt
from lightgbm_tpu_torch import convert
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
BASE = {"num_leaves": 15, "max_bin": 16, "min_data_in_leaf": 10,
        "learning_rate": 0.2, "verbosity": -1}
EXACT_KEYS = ("num_leaves", "num_cat", "split_feature", "threshold",
              "decision_type", "left_child", "right_child", "leaf_count",
              "internal_count", "cat_boundaries", "cat_threshold",
              "shrinkage", "is_linear")
VALUE_KEYS = ("leaf_value", "internal_value", "leaf_weight",
              "internal_weight")


def _data(rng, n=1500, f=6, task="binary"):
    X = rng.normal(size=(n, f))
    X[rng.rand(n) < 0.05, 2] = np.nan
    z = X[:, 0] * 1.5 - np.nan_to_num(X[:, 1]) ** 2 * 0.7 + X[:, 3]
    if task == "multiclass":
        y = (X[:, :3] + 0.5 * rng.normal(size=(n, 3))).argmax(1)
    elif task == "regression":
        y = z + 0.3 * rng.normal(size=n)
    else:
        y = z + rng.normal(scale=0.5, size=n) > 0
    return X, y.astype(float)


def _trees_of(text):
    """Model text -> [{key: value string}] per tree."""
    body = text.split("end of trees")[0]
    out = []
    for block in body.split("Tree=")[1:]:
        kv = {}
        for line in block.splitlines()[1:]:
            if "=" in line:
                k, v = line.split("=", 1)
                kv[k] = v
        out.append(kv)
    return out


def assert_model_text_equal(jtext, ttext):
    jt, tt = _trees_of(jtext), _trees_of(ttext)
    assert len(jt) == len(tt)
    for i, (a, b) in enumerate(zip(jt, tt)):
        for k in EXACT_KEYS:
            assert a.get(k) == b.get(k), (i, k, a.get(k), b.get(k))
        for k in VALUE_KEYS:
            if k in a:
                np.testing.assert_allclose(
                    np.array(b[k].split(), float),
                    np.array(a[k].split(), float), rtol=0, atol=1e-5,
                    err_msg=f"tree {i} {k}")
        if "split_gain" in a:
            np.testing.assert_allclose(
                np.array(b["split_gain"].split(), float),
                np.array(a["split_gain"].split(), float), rtol=1e-4,
                atol=1e-6, err_msg=f"tree {i} split_gain")


def train_both(rng, extra, rounds=3, task="binary", port_extra=None,
               X=None, y=None):
    """(JAX booster, port booster) on the same data and bin mappers."""
    if X is None:
        X, y = _data(rng, task=task)
    p = {**BASE, **extra, "objective": task}
    if task == "multiclass":
        p["num_class"] = 3
    jp = {**p, "tree_learner": "serial", "hist_impl": "scatter"}
    jtr = lgb.Dataset(X, label=y, params=jp)
    jb = lgb.train(jp, jtr, rounds)
    mappers = [m.state_arrays() for m in jtr.bin_mappers]
    tp = {**p, **CPU, **(port_extra or {})}
    tb = lgt.train(tp, lgt.Dataset(
        X, label=y, params=tp,
        bin_mappers=convert.bin_mappers_from_state(mappers)), rounds)
    return jb, tb, X


SPECS = {
    # feature 2 has NaNs: they go left of the forced root
    "structure": {"feature": 2, "threshold": 0.0,
                  "left": {"feature": 0, "threshold": -0.5},
                  "right": {"feature": 0, "threshold": 0.5,
                            "right": {"feature": 1, "threshold": 0.2}}},
    # a starved root drops, and its forced subtree with it
    "dropped_subtree": {"feature": 3, "threshold": 1e9,
                        "left": {"feature": 0, "threshold": 0.0}},
    # the chain passes max_depth=2: the deeper nodes drop
    "max_depth": {"feature": 0, "threshold": 0.0,
                  "left": {"feature": 1, "threshold": 0.0,
                           "left": {"feature": 3, "threshold": 0.0,
                                    "left": {"feature": 5,
                                             "threshold": 0.0}}}},
    # one-hot on category 2 of feature 4; category 9 was never seen
    "categorical": {"feature": 4, "threshold": 2,
                    "left": {"feature": 0, "threshold": 0.0},
                    "right": {"feature": 4, "threshold": 9}},
}


def _forced_file(tmp_path, spec):
    path = tmp_path / "forced.json"
    path.write_text(json.dumps(spec))
    return str(path)


@pytest.mark.parametrize("case,task", [
    ("structure", "regression"), ("dropped_subtree", "regression"),
    ("max_depth", "binary"), ("categorical", "regression"),
    ("structure", "multiclass")])
def test_forced_matches_jax(rng, tmp_path, case, task):
    X, y = _data(rng, task=task)
    extra = {"forcedsplits_filename": _forced_file(tmp_path, SPECS[case])}
    if case == "categorical":
        X[:, 4] = rng.randint(0, 4, size=len(X))
        X[:, 0] += X[:, 4] == 2
        extra["categorical_feature"] = "4"
    if case == "max_depth":
        extra["max_depth"] = 2
    jb, tb, _ = train_both(rng, extra, task=task, X=X, y=y)
    g = tb._gbdt
    assert g.fused_split_reason == \
        "forced splits gather arbitrary (feature, bin) cells"
    assert not g.class_batch_ok
    assert_model_text_equal(jb.model_to_string(), tb.model_to_string())
    trees = tb._trees
    if case == "structure":
        for t in trees:
            # decision_type bit 1: default_left (missing values go left)
            assert t.split_feature[0] == 2 and t.decision_type[0] & 2
            for child in (t.left_child[0], t.right_child[0]):
                assert child >= 0 and t.split_feature[child] == 0
    elif case == "dropped_subtree":
        for t in trees:
            assert t.num_leaves > 1 and t.threshold[0] < 1e8
    elif case == "max_depth":
        assert all(t.split_feature[0] == 0 for t in trees)
    elif case == "categorical":
        for t in trees:
            assert t.split_feature[0] == 4 and t.num_cat > 0


def test_gate_reasons_match_jax(rng, tmp_path, monkeypatch):
    """_fused_split_reason, _class_batch_reason and _fused_gate_reason
    name what the JAX package's name (its Pallas arm requested; 8
    features give its kernel an aligned chunk plan)."""
    monkeypatch.delenv("LIGHTGBM_TPU_FUSED_TRAIN", raising=False)
    X, y = _data(rng, n=600, f=8, task="multiclass")
    p = {**BASE, "objective": "multiclass", "num_class": 3,
         "fused_split": "on",
         "forcedsplits_filename": _forced_file(tmp_path,
                                               SPECS["structure"])}
    jbst = lgb.Booster(params={**p, "hist_impl": "pallas",
                               "tree_learner": "serial"},
                       train_set=lgb.Dataset(X, label=y))
    jbst._ensure_gbdt()
    tbst = lgt.Booster(params={**p, **CPU},
                       train_set=lgt.Dataset(X, label=y, params=CPU))
    tbst._ensure_gbdt()
    j, t = jbst._gbdt, tbst._gbdt
    assert t.fused_split_reason == j.fused_split_reason
    assert t.class_batch_reason == j.class_batch_reason == \
        "forced splits assign node slots sequentially"
    assert t.fused_train_reason == j.fused_reason == ""
    assert t._forced_splits == j._forced_splits


def test_forced_split_file_errors(rng, tmp_path):
    X, y = _data(rng, n=300)
    p = {**BASE, **CPU, "objective": "binary",
         "forcedsplits_filename": _forced_file(
             tmp_path, {"feature": 17, "threshold": 0.0})}
    with pytest.raises(ValueError, match="not a used feature"):
        lgt.train(p, lgt.Dataset(X, label=y, params=p), 1)
