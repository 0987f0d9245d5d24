"""PyTorch port, the builder's gain operands on the CPU against the JAX
package: CEGB (cost-effective gradient boosting: split, coupled and lazy
feature penalties, with its model-level state carried from tree to
tree) and ``feature_contri`` (per-feature gain scales), the JAX tests
of tests/test_cegb.py. Both run the two-pass arm (B1, then
``find_best_splits`` with the ``gain_penalty``/``gain_scale``
operands); CEGB runs the eager loop and the per-class loop. The same
seeded data trains through lightgbm_tpu.train and
lightgbm_tpu_torch.train on the same bin mappers; the model texts'
trees are equal in structure and thresholds, with leaf and internal
values within 1e-5 (absolute) and split gains within 1e-4 (relative):
f32 sums in another order. The gates return the JAX package's
reasons."""

import numpy as np
import pytest

import lightgbm_tpu as lgb
import lightgbm_tpu_torch as lgt
from lightgbm_tpu_torch import convert

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


CEGB = {"cegb_tradeoff": 0.5, "cegb_penalty_split": 0.002,
        "cegb_penalty_feature_coupled": [0.0, 2.0, 2.0, 0.5, 5.0, 5.0],
        "cegb_penalty_feature_lazy": [0.001, 0.0, 0.002, 0.001, 0.0,
                                      0.003]}
CONTRI = {"feature_contri": [1.0, 0.5, 1.0, 0.8, 1.0, 0.3]}
CASES = {
    "cegb_regression": (CEGB, "regression"),
    "cegb_multiclass": ({"cegb_penalty_split": 0.01,
                         "cegb_penalty_feature_coupled":
                             [0.0, 1.0, 1.0, 0.0, 3.0, 3.0]}, "multiclass"),
    "feature_contri_binary": (CONTRI, "binary"),
    "feature_contri_multiclass": (CONTRI, "multiclass"),
    "cegb_feature_contri": ({**CEGB, **CONTRI}, "binary"),
}
REASONS = {"cegb": "CEGB rescales gains outside the kernel",
           "feature_contri": "feature_contri rescales gains outside the "
                             "kernel"}


@pytest.mark.parametrize("case", list(CASES))
def test_options_match_jax(rng, case):
    extra, task = CASES[case]
    jb, tb, _ = train_both(rng, extra, rounds=4, task=task)
    g = tb._gbdt
    assert g.fused_split_reason == REASONS[case.split("_")[0]
                                           if case.startswith("cegb")
                                           else "feature_contri"]
    cegb = case.startswith("cegb")
    assert g.class_batch_ok == (task == "multiclass" and not cegb)
    assert_model_text_equal(jb.model_to_string(), tb.model_to_string())
    assert sum(t.num_leaves for t in tb._trees) > 3 * len(tb._trees)
    if cegb:
        # the model-level state after the last tree: the features any
        # tree split on, and (lazy) the rows that paid for each
        used = {int(f) for t in tb._trees for f in t.split_feature}
        assert set(np.nonzero(g._cegb_feat_used.numpy())[0]) == used
        ju = np.asarray(jb._gbdt._cegb_feat_used)
        assert np.array_equal(g._cegb_feat_used.numpy(), ju)
        if "cegb_penalty_feature_lazy" in extra:
            # the real rows (the packages pad to other row multiples)
            n = g.train_dd.num_data
            assert np.array_equal(g._cegb_used_rows.numpy()[:n],
                                  np.asarray(jb._gbdt._cegb_used_rows)[:n])
            assert g._cegb_used_rows[:n].any()


def test_coupled_penalty_concentrates_splits(rng):
    """A large one-time cost on all but feature 0 keeps every split on
    it (test_cegb.py's coupled case)."""
    X, y = _data(rng, task="regression")
    p = {**BASE, **CPU, "objective": "regression",
         "cegb_penalty_feature_coupled": [0.0] + [1e6] * 5}
    tb = lgt.train(p, lgt.Dataset(X, label=y, params=p), 3)
    assert {int(f) for t in tb._trees for f in t.split_feature} == {0}


def test_gate_reasons_match_jax(rng, monkeypatch):
    """_fused_split_reason, _class_batch_reason and _fused_gate_reason
    name what the JAX package's name (its Pallas arm requested; 8
    features give its kernel an aligned chunk plan)."""
    monkeypatch.delenv("LIGHTGBM_TPU_FUSED_TRAIN", raising=False)
    X, y = _data(rng, n=600, f=8, task="multiclass")
    pad = {k: (v + [0.0, 0.0] if isinstance(v, list) else v)
           for k, v in {**CEGB, **CONTRI}.items()}
    for keys in (("cegb_tradeoff", "cegb_penalty_split",
                  "cegb_penalty_feature_coupled",
                  "cegb_penalty_feature_lazy"), ("feature_contri",)):
        p = {**BASE, **{k: pad[k] for k in keys},
             "objective": "multiclass", "num_class": 3, "fused_split": "on"}
        jbst = lgb.Booster(params={**p, "hist_impl": "pallas",
                                   "tree_learner": "serial"},
                           train_set=lgb.Dataset(X, label=y))
        jbst._ensure_gbdt()
        tbst = lgt.Booster(params={**p, **CPU},
                           train_set=lgt.Dataset(X, label=y, params=CPU))
        tbst._ensure_gbdt()
        j, t = jbst._gbdt, tbst._gbdt
        assert t.fused_split_reason == j.fused_split_reason != ""
        assert t.class_batch_reason == j.class_batch_reason
        assert t.fused_train_reason == j.fused_reason
    assert t.class_batch_reason == t.fused_train_reason == ""
