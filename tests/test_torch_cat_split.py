"""PyTorch port, sorted-subset categorical splits on the CPU, against the
JAX package.

- ``find_best_cat_sorted`` against ``lightgbm_tpu.ops.cat_split`` on
  seeded histograms, over ``max_cat_threshold``, ``min_data_per_group``,
  ``cat_smooth`` and a case of tied CTR keys: winners and member masks
  equal, gains within rtol 1e-6 (their prefix sums are f32 in both
  packages, in different orders);
- ``find_best_splits`` with ``cat_sorted_mask`` (the one-hot lattice
  excludes those features, sorted winners merge into the per-slot best):
  winner fields and the multi-word ``cat_bitset`` equal;
- training with a 40-category column (sorted path) and a 4-category one
  (one-hot path) against ``lightgbm_tpu.train``: binary and
  class-batched, quantized (exact int32 histograms), float and GOSS;
  every tree equal node for node (category sets, row counts, leaf
  values within rtol 1e-5) up to a tie: a sorted feature whose
  categories at a node are all candidates scores a subset and its
  complement equally in exact arithmetic, and each package's f32 sum
  order picks one, so such a node may hold the complementary set with
  its children swapped (equal gains to f32 rounding, the same rows);
  raw predictions on the training and held-out rows within 1e-5;
- the model text: every line equal to the JAX package's but the f32
  split gains (rtol 1e-5), a JAX model's text written back by the port
  byte for byte, and the port's text round-trips byte for byte.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lightgbm_tpu as lgb
import lightgbm_tpu_torch as lgt
from lightgbm_tpu.ops.cat_split import find_best_cat_sorted as jax_cat
from lightgbm_tpu.ops.split import SplitParams as JSP
from lightgbm_tpu.ops.split import find_best_splits as jax_best
from lightgbm_tpu_torch import convert
from lightgbm_tpu_torch.ops.cat_split import find_best_cat_sorted
from lightgbm_tpu_torch.ops.split import SplitParams as TSP
from lightgbm_tpu_torch.ops.split import find_best_splits

CPU = {"device_type": "cpu"}
PARAMS = {"objective": "binary", "num_leaves": 15, "leaf_batch": 4,
          "max_bin": 63, "min_data_in_leaf": 10, "learning_rate": 0.2,
          "min_data_per_group": 20, "cat_smooth": 5.0, "verbosity": -1}
MULTI = {**PARAMS, "objective": "multiclass", "num_class": 3,
         "hist_dtype": "float32"}
GOSS = {"data_sample_strategy": "goss", "learning_rate": 0.5}
L, F, B = 6, 5, 48
SORTED = np.array([True, False, True, True, False])   # feature 1 one-hot


def _hist(r, tied):
    n = r.poisson(r.uniform(5, 80, size=(L, F, B))).astype(np.float32)
    if tied:
        # integer gradients over a hessian proportional to the count:
        # many categories share a ratio g / (h + cat_smooth)
        g = np.round(n * r.normal(0, 0.5, size=n.shape) / 4) * 4
        h = n * 0.25
    else:
        g = n * r.normal(0, 0.5, size=n.shape)
        h = n * r.uniform(0.1, 0.3, size=n.shape)
    return np.stack([g, h, n], -1).astype(np.float32)


SEARCH_CASES = {
    "defaults": dict(max_cat_threshold=32, min_data_per_group=100.0,
                     cat_smooth=10.0),
    "threshold4": dict(max_cat_threshold=4, min_data_per_group=100.0,
                       cat_smooth=10.0),
    "group10_smooth1": dict(max_cat_threshold=32, min_data_per_group=10.0,
                            cat_smooth=1.0),
    "group50_smooth25": dict(max_cat_threshold=8, min_data_per_group=50.0,
                             cat_smooth=25.0),
    "tied_ctr": dict(max_cat_threshold=32, min_data_per_group=20.0,
                     cat_smooth=10.0, tied=True),
}


@pytest.mark.parametrize("case", list(SEARCH_CASES))
def test_cat_sorted_search_matches_jax(case):
    kw = dict(SEARCH_CASES[case])
    tied = kw.pop("tied", False)
    kw.update(min_data_in_leaf=5.0, lambda_l2=0.5, lambda_l1=0.1)
    r = np.random.RandomState(sorted(SEARCH_CASES).index(case))
    for _ in range(4):
        hist = _hist(r, tied)
        nb = r.randint(10, B + 1, size=F).astype(np.int32)
        fm = r.rand(L, F) < 0.9
        pg = r.uniform(0, 5, size=(L, F)).astype(np.float32)
        want = jax_cat(jnp.asarray(hist), jnp.asarray(nb),
                       jnp.asarray(SORTED), JSP(**kw), jnp.asarray(pg),
                       feature_mask=jnp.asarray(fm))
        got = find_best_cat_sorted(
            torch.from_numpy(hist), torch.from_numpy(nb),
            torch.from_numpy(SORTED), TSP(**kw), torch.from_numpy(pg),
            feature_mask=torch.from_numpy(fm),
            max_sorted_bins=int(nb[SORTED].max()))
        wg = np.asarray(want["gain"])
        assert np.isfinite(wg).any()
        np.testing.assert_array_equal(np.isfinite(got["gain"].numpy()),
                                      np.isfinite(wg))
        np.testing.assert_allclose(got["gain"].numpy(), wg, rtol=1e-6)
        for k in ("feature", "member"):
            np.testing.assert_array_equal(got[k].numpy(),
                                          np.asarray(want[k]), err_msg=k)
        for k in ("left_sum", "right_sum", "left_out", "right_out"):
            np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                       rtol=1e-5, atol=1e-5, err_msg=k)
        assert got["member"].sum(1).max() > 1      # multi-category sets


@pytest.mark.parametrize("tied", [False, True])
def test_find_best_splits_merges_sorted_winners(tied):
    r = np.random.RandomState(5 + tied)
    kw = dict(min_data_in_leaf=5.0, min_data_per_group=20.0, cat_smooth=5.0)
    is_cat = SORTED.copy()
    is_cat[1] = True
    nan = np.full(F, -1, np.int32)
    for _ in range(3):
        hist = _hist(r, tied)
        nb = np.full(F, B, np.int32)
        nb[1] = 4                                    # one-hot path
        want = jax_best(jnp.asarray(hist), jnp.asarray(nb), jnp.asarray(nan),
                        jnp.asarray(is_cat), JSP(**kw),
                        cat_sorted_mask=jnp.asarray(SORTED))
        got = find_best_splits(
            torch.from_numpy(hist), torch.from_numpy(nb),
            torch.from_numpy(nan), torch.from_numpy(is_cat), TSP(**kw),
            cat_sorted_mask=torch.from_numpy(SORTED), max_sorted_bins=B)
        assert bool(np.asarray(want["is_cat_split"]).all())
        for k in ("feature", "threshold", "default_left", "is_cat_split"):
            np.testing.assert_array_equal(got[k].numpy(),
                                          np.asarray(want[k]), err_msg=k)
        np.testing.assert_array_equal(
            got["cat_bitset"].numpy(),
            np.asarray(want["cat_bitset"]).astype(np.int64))
        np.testing.assert_allclose(got["gain"].numpy(),
                                   np.asarray(want["gain"]), rtol=1e-6)
    assert got["cat_bitset"].shape[1] == 2           # two words at B = 48


def test_quantized_scales_refuse_sorted_mask():
    hist = torch.zeros((L, F, B, 3), dtype=torch.int32)
    nb = torch.full((F,), B, dtype=torch.int32)
    with pytest.raises(ValueError, match="incompatible"):
        find_best_splits(hist, nb, torch.full((F,), -1),
                         torch.ones(F, dtype=torch.bool), TSP(),
                         quant_scales=torch.ones(2),
                         cat_sorted_mask=torch.from_numpy(SORTED))


# -- training ----------------------------------------------------------------

def _data(rng, multiclass, n=4000):
    X = rng.normal(size=(n, 6))
    X[:, 1] = rng.randint(0, 40, size=n)             # 40 categories
    X[:, 2] = rng.randint(0, 4, size=n)              # 4: one-hot
    eff = rng.normal(size=40)
    c = X[:, 1].astype(int)
    logit = X[:, 0] + eff[c] + 0.5 * (X[:, 2] == 1) - X[:, 3]
    if multiclass:
        y = (np.stack([logit, -logit, X[:, 4] + eff[c] ** 2], 1)
             + rng.normal(size=(n, 3))).argmax(1)
    else:
        y = logit + rng.normal(size=n) > 0
    y = y.astype(float)
    return X[:3000], y[:3000], X[3000:]


def _train_pair(rng, params, multiclass, rounds=6):
    X, y, Xv = _data(rng, multiclass)
    jp = {**params, "tree_learner": "serial", "hist_impl": "scatter"}
    jtr = lgb.Dataset(X, label=y, params=jp, categorical_feature=[1, 2])
    jb = lgb.train(jp, jtr, rounds)
    tp = {**params, **CPU}
    tb = lgt.train(tp, lgt.Dataset(
        X, label=y, params=tp, categorical_feature=[1, 2],
        bin_mappers=convert.bin_mappers_from_state(
            m.state_arrays() for m in jtr.bin_mappers)), rounds)
    return jb, tb, X, Xv


TRAIN_CASES = {
    "binary": (PARAMS, False),
    "binary_quant": ({**PARAMS, "use_quantized_grad": True}, False),
    "class_batched_quant": ({**MULTI, "use_quantized_grad": True}, True),
    "class_batched_f32": (MULTI, True),
    # GOSS from iteration int(1 / 0.5) = 2 of 6
    "binary_goss": ({**PARAMS, **GOSS}, False),
    "class_batched_goss": ({**MULTI, **GOSS}, True),
}


@pytest.mark.parametrize("case", list(TRAIN_CASES))
def test_cat_sorted_train_matches_jax(rng, case):
    params, mc = TRAIN_CASES[case]
    jb, tb, X, Xv = _train_pair(rng, params, mc)
    g = tb._gbdt
    assert g._cat_sorted_mask.tolist() == [False, True] + [False] * 4
    assert g.fused_split_reason == \
        "sorted-subset categoricals reorder histogram bins"
    assert g.class_batch_ok == mc
    if g._goss:
        assert g._goss_start == 2     # crossed inside the run
    jt, tt = jb._all_trees(), tb._trees
    assert len(jt) == len(tt)
    assert max(t.num_cat for t in tt) > 1
    # multi-category subsets of the 40-category feature, in model text
    assert any(len(t.cat_threshold) > t.num_cat for t in tt)
    for a, b in zip(jt, tt):
        _assert_same_tree(a, b)
    # the same model as a function of the training rows: raw predictions
    # on them, and on held-out rows, agree
    for Z in (X, Xv):
        np.testing.assert_allclose(tb.predict(Z, raw_score=True),
                                   jb.predict(Z, raw_score=True), atol=1e-5)


def _split_of(t, j):
    """Node j's decision: feature, kind, and its threshold (bin and
    value) or category words."""
    dt = int(t.decision_type[j])
    if dt & 1:
        c = int(t.threshold[j])
        lo, hi = t.cat_boundaries[c], t.cat_boundaries[c + 1]
        return (int(t.split_feature[j]), dt, tuple(t.cat_threshold[lo:hi]))
    return (int(t.split_feature[j]), dt, int(t.threshold_bin[j]),
            float(t.threshold[j]))


def _members(t, j):
    """The category bins of categorical node j's set."""
    _, _, words = _split_of(t, j)
    return {32 * w + b for w, word in enumerate(words) for b in range(32)
            if (int(word) >> b) & 1}


def _assert_same_tree(a, b):
    """``b`` is the reference tree ``a``, node for node from the root,
    up to ties of a sorted-subset split: a node may send the other side
    of the same partition of its rows left. A feature whose categories
    at a node are all candidates scores a subset and its complement
    equally in exact arithmetic, and each package's f32 sum order picks
    one. Such a node has the same feature and kind, a category set
    disjoint from the reference's, a gain equal to f32 rounding of the
    tree's largest, the same row count, and children that match the
    reference's swapped. Leaves match in row count and value (rtol
    1e-5). Returns the number of swapped nodes."""
    assert a.num_leaves == b.num_leaves
    scale = np.abs(a.split_gain).max() if a.num_leaves > 1 else 0.0
    atol = 1e-5 * np.abs(a.leaf_value).max()
    swapped = []

    def walk(i, j):
        if i < 0 or j < 0:
            assert i < 0 and j < 0
            assert a.leaf_count[~i] == b.leaf_count[~j]
            np.testing.assert_allclose(b.leaf_value[~j], a.leaf_value[~i],
                                       rtol=1e-5, atol=atol)
            return
        assert a.internal_count[i] == b.internal_count[j]
        ca = (a.left_child[i], a.right_child[i])
        cb = (b.left_child[j], b.right_child[j])
        sa, sb = _split_of(a, i), _split_of(b, j)
        if sa != sb:
            assert sa[:2] == sb[:2] and sa[1] & 1
            assert not _members(a, i) & _members(b, j)
            assert abs(a.split_gain[i] - b.split_gain[j]) <= 1e-6 * scale
            cb = cb[::-1]
            swapped.append(i)
        walk(ca[0], cb[0])
        walk(ca[1], cb[1])

    walk(0, 0) if a.num_leaves > 1 else walk(-1, -1)
    return len(swapped)


def _lines(text):
    return text.split("end of trees")[0].split("Tree=0", 1)[1].splitlines()


def test_cat_sorted_model_text_matches_jax(rng):
    jb, tb, _, Xv = _train_pair(rng, PARAMS, False)
    s_jax, s_port = jb.model_to_string(), tb.model_to_string()
    assert "cat_threshold=" in s_port
    lj, lt = _lines(s_jax), _lines(s_port)
    assert len(lj) == len(lt)
    for a, b in zip(lj, lt):
        if a.startswith("split_gain="):
            np.testing.assert_allclose(
                np.asarray(b.split("=")[1].split(), float),
                np.asarray(a.split("=")[1].split(), float), rtol=1e-5)
        else:
            assert a == b
    # the JAX package's model, loaded by the port, is written back as
    # the JAX package writes it; the port's text round-trips
    via_port = convert.booster_from_model_string(s_jax)
    assert via_port.model_to_string() == \
        lgb.Booster(model_str=s_jax).model_to_string()
    # (a loaded model writes no training parameters: compare the trees,
    # and a second load -> save byte for byte, as test_torch_binning)
    s_again = lgt.Booster(model_str=s_port).model_to_string()
    assert s_again.split("end of trees")[0] == \
        s_port.split("end of trees")[0]
    assert lgt.Booster(model_str=s_again).model_to_string() == s_again
    again = lgt.Booster(model_str=s_port, params=CPU)
    np.testing.assert_array_equal(again.predict(Xv), tb.predict(Xv))
    np.testing.assert_allclose(
        convert.booster_from_model_string(s_jax, params=CPU).predict(Xv),
        jb.predict(Xv), atol=1e-12)
