"""PyTorch port, the builder's sampling and constraint options on the CPU
against the JAX package: per-node feature sampling
(``feature_fraction_bynode``), interaction constraints, extra-trees and
the intermediate and advanced monotone methods (the JAX tests of
tests/test_constraints.py). The same seeded data trains through
lightgbm_tpu.train and lightgbm_tpu_torch.train on the same bin mappers;
the model texts' trees are equal in structure and thresholds, with leaf
and internal values within 1e-5 (absolute) and split gains within 1e-4
(relative): f32 sums in another order. The draws alone (the per-slot
[2W, F] feature masks and extra-trees thresholds) are bit-equal to the
JAX package's, for one tree's key and for the class-batched build's
per-class keys, and the three gates return the JAX package's reasons."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lightgbm_tpu as lgb
import lightgbm_tpu_torch as lgt
from lightgbm_tpu_torch import convert
from lightgbm_tpu_torch.boosting.tree_builder import (slot_feature_masks,
                                                      tree_draws)
from lightgbm_tpu_torch.ops import threefry

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


def train_both(rng, extra, rounds=3, task="binary", port_extra=None):
    """(JAX booster, port booster) on the same data and bin mappers."""
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


MONO = [1, 0, 0, -1, 0, 0]
CASES = {
    # the fused arm (B2) with a per-slot mask, and the two-pass arm
    "bynode_interaction": ({"feature_fraction_bynode": 0.6,
                            "interaction_constraints": [[0, 1, 2],
                                                        [2, 3, 4, 5]]},
                           "binary"),
    "extra_trees": ({"extra_trees": True, "feature_fraction": 0.8},
                    "binary"),
    "intermediate": ({"monotone_constraints": MONO,
                      "monotone_constraints_method": "intermediate",
                      "monotone_penalty": 0.3, "max_depth": 5},
                     "regression"),
    "advanced": ({"monotone_constraints": MONO,
                  "monotone_constraints_method": "advanced"}, "regression"),
    # class-batched: per-class keys, B3's root
    "bynode_extra_trees_multiclass": ({"feature_fraction_bynode": 0.7,
                                       "extra_trees": True}, "multiclass"),
    "interaction_intermediate_multiclass": (
        {"interaction_constraints": [[0, 1, 2], [2, 3, 4, 5]],
         "monotone_constraints": MONO,
         "monotone_constraints_method": "intermediate"}, "multiclass"),
}
ARMS = {"bynode_interaction": "",
        "extra_trees": "extra-trees thresholds sample the full lattice",
        "intermediate": "",
        "advanced": "advanced monotone re-reads sibling histograms",
        "bynode_extra_trees_multiclass":
            "extra-trees thresholds sample the full lattice",
        "interaction_intermediate_multiclass": ""}


@pytest.mark.parametrize("case", list(CASES))
def test_options_match_jax(rng, case):
    extra, task = CASES[case]
    jb, tb, X = train_both(rng, extra, task=task)
    g = tb._gbdt
    assert g.fused_split_reason == ARMS[case]
    assert g.class_batch_ok == (task == "multiclass")
    assert_model_text_equal(jb.model_to_string(), tb.model_to_string())
    assert sum(t.num_leaves for t in tb._trees) > 3 * len(tb._trees)
    if "monotone_constraints" in extra:
        # the predictions move with each constrained feature's sign on
        # a 1-D sweep of it
        grid = np.linspace(-3, 3, 41)
        for f, sign in enumerate(MONO):
            if sign == 0:
                continue
            rows = np.repeat(X[:20], len(grid), axis=0)
            rows[:, f] = np.tile(grid, 20)
            pred = tb.predict(rows, raw_score=True).reshape(20, len(grid),
                                                            -1)
            steps = np.diff(pred, axis=1) * sign
            assert (steps >= -1e-12).all()


def test_bynode_interaction_arms_agree(rng):
    """The fused arm (B2's plain version with a per-slot mask) and the
    two-pass arm grow the same trees from the same draws."""
    extra = CASES["bynode_interaction"][0]
    X, y = _data(rng)
    models = []
    for fs in ("auto", "off"):
        p = {**BASE, **extra, **CPU, "objective": "binary",
             "fused_split": fs}
        models.append(lgt.train(p, lgt.Dataset(X, label=y, params=p), 3)
                      .model_to_string().split("parameters:")[0])
    assert models[0] == models[1]


def _jax_slot_masks(fmask, used, groups, key, S, ffbn, rand, nnb, is_cat):
    """tree_builder.py:626-658 of the JAX package, for one key."""
    F = fmask.shape[0]
    f32 = jnp.float32
    fm = jnp.broadcast_to(fmask[None, :], (S, F))
    if groups is not None:
        viol = used.astype(f32) @ (~groups).astype(f32).T
        allowed = ((viol == 0).astype(f32) @ groups.astype(f32)) > 0
        fm = fm & allowed
    if ffbn < 1.0:
        n_tree = fmask.sum().astype(f32)
        n_allow = fm.sum(axis=1).astype(f32)
        k = jnp.floor(n_tree * ffbn + 0.5)
        k = jnp.minimum(jnp.maximum(k, 1.0), n_allow)
        k = jnp.maximum(k, jnp.minimum(1.0, n_allow)).astype(jnp.int32)
        u = jax.random.uniform(jax.random.fold_in(key, 1), (S, F))
        score = jnp.where(fm, u, -1.0)
        kth = jnp.take_along_axis(-jnp.sort(-score, axis=1),
                                  jnp.maximum(k - 1, 0)[:, None], axis=1)
        fm = fm & (score >= kth)
    rb = None
    if rand:
        u2 = jax.random.uniform(jax.random.fold_in(key, 2), (S, F))
        n_opt = jnp.where(is_cat, jnp.maximum(nnb, 1),
                          jnp.maximum(nnb - 1, 1)).astype(f32)
        rb = jnp.floor(u2 * n_opt[None, :]).astype(jnp.int32)
    return np.asarray(fm), None if rb is None else np.asarray(rb)


@pytest.mark.parametrize("K", [1, 3])
def test_draws_match_jax(rng, K):
    """The [2W, F] bynode masks (under interaction constraints) and the
    extra-trees thresholds of one round, bit-equal to the JAX package's
    for each class's key fold_in(fold_in(fold_in(tree_key, it), k),
    r)."""
    F, W, it, r = 11, 4, 7, 3
    seed = (2 * 2654435761 + 6) & 0x7FFFFFFF
    fmask = rng.rand(F) < 0.8
    groups = rng.rand(3, F) < 0.5
    used = rng.rand(K, 2 * W, F) < 0.2
    nnb = rng.randint(1, 30, size=F).astype(np.int32)
    is_cat = rng.rand(F) < 0.2
    tkey = threefry.fold_in(threefry.prng_key(seed), it)
    u1, u2 = tree_draws(threefry.fold_in(tkey, torch.arange(K)), r + 1,
                        2 * W, F, True, True)
    got_m, got_b = slot_feature_masks(
        torch.from_numpy(fmask), torch.zeros((K, 2 * W), dtype=torch.int32),
        (u1[:, r], u2[:, r]), used_feat=torch.from_numpy(used),
        interaction_groups=torch.from_numpy(groups),
        feature_fraction_bynode=0.55, extra_trees=True,
        nnb_pf=torch.from_numpy(nnb), is_cat_pf=torch.from_numpy(is_cat))
    jkey = jax.random.fold_in(jax.random.PRNGKey(seed), it)
    for k in range(K):
        kk = jax.random.fold_in(jax.random.fold_in(jkey, k), r)
        want_m, want_b = _jax_slot_masks(
            jnp.asarray(fmask), jnp.asarray(used[k]), jnp.asarray(groups),
            kk, 2 * W, 0.55, True, jnp.asarray(nnb), jnp.asarray(is_cat))
        rows = slice(k * 2 * W, (k + 1) * 2 * W)
        assert np.array_equal(got_m[rows].numpy(), want_m)
        assert np.array_equal(got_b[rows].numpy(), want_b)
        assert want_m.sum() > 0


GATE_CASES = {
    "bynode": {"feature_fraction_bynode": 0.5},
    "interaction": {"interaction_constraints": [[0, 1], [2, 3, 4, 5]]},
    "extra_trees": {"extra_trees": True},
    "intermediate": {"monotone_constraints": MONO + [0, 0],
                     "monotone_constraints_method": "intermediate"},
    "advanced": {"monotone_constraints": MONO + [0, 0],
                 "monotone_constraints_method": "advanced"},
}


def test_gate_reasons_match_jax(rng, monkeypatch):
    """_fused_split_reason, _class_batch_reason and _fused_gate_reason
    name what the JAX package's name (its Pallas arm requested, so that
    its kernel-availability reasons stay out of the way: 8 features
    give its kernel an aligned chunk plan)."""
    monkeypatch.delenv("LIGHTGBM_TPU_FUSED_TRAIN", raising=False)
    X, y = _data(rng, n=600, f=8, task="multiclass")
    for name, extra in GATE_CASES.items():
        p = {**BASE, **extra, "objective": "multiclass", "num_class": 3,
             "fused_split": "on"}
        jbst = lgb.Booster(params={**p, "hist_impl": "pallas",
                                   "tree_learner": "serial"},
                           train_set=lgb.Dataset(X, label=y))
        jbst._ensure_gbdt()
        tbst = lgt.Booster(params={**p, **CPU},
                           train_set=lgt.Dataset(X, label=y, params=CPU))
        tbst._ensure_gbdt()
        j, t = jbst._gbdt, tbst._gbdt
        assert t.fused_split_reason == j.fused_split_reason, name
        assert t.class_batch_reason == j.class_batch_reason == "", name
        assert t.fused_train_reason == j.fused_reason == "", name
