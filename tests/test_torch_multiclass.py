"""PyTorch port, multiclass on the CPU, held against the JAX package.

- MulticlassSoftmax / MulticlassOVA gradients within 1e-6 of the JAX
  objectives ([K, R] in the port, [R, K] in the JAX package) and
  boost_from_score exactly equal;
- the plain version of kernel B3 (``build_root_histograms_classes``)
  against the JAX Pallas kernel in interpret mode: int8 exact, f32 and
  bf16-rounded within 1e-5 of the channel scale; and equal to K plain
  B1 root calls;
- ``build_tree_class_batched`` against K ``build_tree`` calls: structure
  exact, leaf values within rtol 1e-5;
- ``lgt.train`` multiclass against ``lgb.train`` with ``class_batch`` on
  and off (bin mappers carried over by ``convert``): tree keys equal,
  leaf values rtol 1e-5, raw predictions atol 1e-5, multi_logloss atol
  1e-5;
- a JAX multiclass model predicts in the port within 1e-6, and the
  port's multiclass model text loads in the JAX package.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lightgbm_tpu as lgb
import lightgbm_tpu_torch as lgt
from lightgbm_tpu import objectives as JO
from lightgbm_tpu.config import Config as JConfig
from lightgbm_tpu.ops import pallas_histogram as PH
from lightgbm_tpu_torch import convert
from lightgbm_tpu_torch import objectives as TO
from lightgbm_tpu_torch.boosting import tree_builder as TTB
from lightgbm_tpu_torch.config import Config as TConfig
from lightgbm_tpu_torch.ops import cuda_histogram as CH
from lightgbm_tpu_torch.ops.histogram import build_histograms
from lightgbm_tpu_torch.ops.split import SplitParams as TSP

CPU = {"device_type": "cpu"}
K = 3
PARAMS = {"objective": "multiclass", "num_class": K,
          "metric": "multi_logloss", "num_leaves": 15, "leaf_batch": 4,
          "max_bin": 16, "min_data_in_leaf": 10, "learning_rate": 0.2,
          "verbosity": -1}


def _data(rng, n=4000, f=8):
    X = rng.normal(size=(n, f))
    X[rng.rand(n) < 0.05, 2] = np.nan
    logits = np.stack([X[:, 0] * 1.5, np.nan_to_num(X[:, 1]) ** 2 - 0.5,
                       X[:, 3] - X[:, 4]], 1)
    y = (logits + rng.normal(scale=0.7, size=(n, K))).argmax(1)
    y = y.astype(float)
    return X[:3000], y[:3000], X[3000:], y[3000:]


def _tree_key(t):
    return (t.num_leaves, tuple(t.split_feature), tuple(t.threshold_bin),
            tuple(t.decision_type), tuple(t.left_child),
            tuple(t.right_child))


# -- objectives -------------------------------------------------------------

@pytest.mark.parametrize("name", ["multiclass", "multiclassova"])
@pytest.mark.parametrize("weighted", [False, True])
def test_objective_matches_jax(rng, name, weighted):
    R = 500
    label = rng.randint(0, K, size=R).astype(np.float32)
    score = rng.normal(size=(K, R)).astype(np.float32)
    w = rng.uniform(0.5, 2.0, size=R).astype(np.float32) if weighted \
        else None
    params = {"objective": name, "num_class": K, "sigmoid": 1.3}
    jo = JO.create_objective(JConfig(params))
    to = TO.create_objective(TConfig(params))
    jo.init(label, w)
    to.init(label, w)
    jg, jh = jo.get_gradients(jnp.asarray(score.T), jnp.asarray(label),
                              None if w is None else jnp.asarray(w))
    tg, th = to.get_gradients(torch.from_numpy(score),
                              torch.from_numpy(label),
                              None if w is None else torch.from_numpy(w))
    assert tuple(tg.shape) == (K, R)
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg).T, atol=1e-6)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh).T, atol=1e-6)
    assert np.array_equal(to.boost_from_score(), jo.boost_from_score())
    raw = rng.normal(size=(7, K))
    np.testing.assert_array_equal(to.convert_output(raw),
                                  jo.convert_output(raw))


# -- kernel B3 (plain version) ---------------------------------------------

R3, F3, B3 = 1536, 6, 16


def _root_stream(rng, quant):
    bins = rng.randint(0, B3, size=(R3, F3)).astype(np.uint8)
    rl = np.zeros(R3, np.int32)
    rl[-45:] = -1                                   # padded rows
    rl[rng.rand(R3) < 0.05] = 3                     # rows of another leaf
    if quant:
        gh = np.stack([rng.randint(-4, 5, size=(K, R3)),
                       rng.randint(0, 5, size=(K, R3)),
                       np.ones((K, R3))], 2).astype(np.int8)
    else:
        g = rng.normal(size=(K, R3)).astype(np.float32)
        gh = np.stack([g, np.abs(g) + 0.25, np.ones((K, R3), np.float32)],
                      2)
    gh[:, rl < 0, 2] = 0
    return bins, gh, rl


@pytest.mark.parametrize("case", ["f32", "bf16", "int8"])
def test_b3_plain_matches_pallas(rng, case):
    bins, gh, rl = _root_stream(rng, case == "int8")
    hd = "float32" if case == "f32" else "bfloat16"
    got = CH.build_root_histograms_classes(
        torch.from_numpy(bins), torch.from_numpy(gh), torch.from_numpy(rl),
        num_bins=B3, hist_dtype=hd)
    want = np.asarray(PH.build_root_histograms_classes(
        jnp.asarray(bins), jnp.asarray(gh), jnp.asarray(rl), num_bins=B3,
        hist_dtype=hd, interpret=True))
    assert tuple(got.shape) == (K, F3, B3, 3) == want.shape
    if case == "int8":
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)
    else:
        scale = np.abs(want).max(axis=(0, 1, 2), keepdims=True)
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=1e-5 * float(scale.max()))
        assert (np.abs(got.numpy() - want) <= 1e-5 * scale).all()


@pytest.mark.parametrize("quant", [False, True])
def test_b3_plain_equals_b1_root_calls(rng, quant):
    bins, gh, rl = map(torch.from_numpy, _root_stream(rng, quant))
    got = CH.build_root_histograms_classes(bins, gh, rl, num_bins=B3)
    ids = torch.full((8,), -2, dtype=torch.int32)
    ids[0] = 0
    for k in range(K):
        want = build_histograms(bins, gh[k], rl, ids, num_bins=B3)[0]
        assert torch.equal(got[k], want)


# -- the class-batched builder ---------------------------------------------

def _builder_problem(rng, R=2048, F=8, B=16):
    bins = rng.randint(0, B - 1, size=(R, F)).astype(np.uint8)
    bins[rng.rand(R) < 0.1, 2] = B - 1              # NaN bin of feature 2
    bins[:, 5] = rng.randint(0, 4, size=R)          # one-hot categorical
    base = np.stack([bins[:, 0] / B, 0.3 * (bins[:, 1] > 7),
                     0.2 * (bins[:, 5] == 2)], 1)
    y = (base + rng.normal(scale=0.2, size=(R, K))).argmax(1)
    p = np.full((R, K), 1.0 / K)
    g = (p - np.eye(K)[y]).T.astype(np.float32)
    h = (1.5 * p * (1 - p)).T.astype(np.float32)
    rl0 = np.zeros(R, np.int32)
    rl0[-37:] = -1
    cnt = np.ones((K, R), np.float32)
    cnt[:, -37:] = 0
    gh = np.stack([g, h, cnt], 2)
    meta = dict(num_bins_pf=np.where(np.arange(F) == 5, 4, B).astype(np.int32),
                nan_bin_pf=np.where(np.arange(F) == 2, B - 1, -1)
                .astype(np.int32),
                is_cat_pf=np.arange(F) == 5,
                feature_mask=np.arange(F) != 6)
    vb = rng.randint(0, B - 1, size=(300, F)).astype(np.uint8)
    return bins, gh, rl0, meta, vb


@pytest.mark.parametrize("fused", [True, False], ids=["B2", "B1"])
@pytest.mark.parametrize("hist_sub", [True, False])
def test_class_batched_builder_matches_sequential(rng, fused, hist_sub):
    bins, gh, rl0, meta, vb = _builder_problem(rng)
    args = [torch.from_numpy(meta[k]) for k in
            ("num_bins_pf", "nan_bin_pf", "is_cat_pf", "feature_mask")]
    kw = dict(num_leaves=15, leaf_batch=4, max_depth=-1, num_bins=16,
              split_params=TSP(min_data_in_leaf=10, lambda_l2=0.5),
              hist_sub=hist_sub, fused_split=fused,
              valid_bins=(torch.from_numpy(vb),),
              valid_row_leaf0=(torch.zeros(300, dtype=torch.int32),))
    tb, rl_b, vrl_b = TTB.build_tree_class_batched(
        torch.from_numpy(bins), torch.from_numpy(gh), torch.from_numpy(rl0),
        *args, **kw)
    assert tuple(rl_b.shape) == (K, 2048)
    for k in range(K):
        ts, rl_s, vrl_s = TTB.build_tree(
            torch.from_numpy(bins), torch.from_numpy(gh[k]),
            torch.from_numpy(rl0), *args, **kw)
        n = int(ts.num_nodes)
        assert int(tb.num_leaves[k]) == int(ts.num_leaves) >= 5
        for f in ("split_feature", "threshold_bin", "default_left",
                  "is_cat", "left_child", "right_child"):
            assert torch.equal(getattr(tb, f)[k][:n], getattr(ts, f)[:n]), f
        torch.testing.assert_close(tb.leaf_values[k], ts.leaf_values,
                                   rtol=1e-5, atol=1e-7)
        assert torch.equal(rl_b[k], rl_s)
        assert torch.equal(vrl_b[0][k], vrl_s[0])


def test_root_hist_seam_is_two_pass(rng):
    """A given root histogram replaces the root build: the same tree as
    the two-pass arm's."""
    bins, gh, rl0, meta, _ = _builder_problem(rng)
    args = [torch.from_numpy(meta[k]) for k in
            ("num_bins_pf", "nan_bin_pf", "is_cat_pf", "feature_mask")]
    kw = dict(num_leaves=15, leaf_batch=4, max_depth=-1, num_bins=16,
              split_params=TSP(min_data_in_leaf=10), fused_split=False)
    b, g, r = (torch.from_numpy(a) for a in (bins, gh[1], rl0))
    root = build_histograms(b, g, r, torch.zeros(1, dtype=torch.int32),
                            num_bins=16)[0]
    seam, rl_a, _ = TTB.build_tree(b, g, r, *args, root_hist=root, **kw)
    plain, rl_b, _ = TTB.build_tree(b, g, r, *args, **kw)
    for f in seam._fields:
        assert torch.equal(getattr(seam, f), getattr(plain, f)), f
    assert torch.equal(rl_a, rl_b)


# -- end to end against lgb.train -------------------------------------------

def _jax_train(X, y, Xv, yv, rounds, class_batch, **extra):
    rec = {}
    p = {**PARAMS, **extra, "tree_learner": "serial", "hist_impl": "scatter",
         "class_batch": class_batch}
    tr = lgb.Dataset(X, label=y, params=p)
    va = lgb.Dataset(Xv, label=yv, reference=tr)
    bst = lgb.train(p, tr, rounds, valid_sets=[va], valid_names=["v"],
                    callbacks=[lgb.record_evaluation(rec)])
    return bst, tr, rec


# XLA's and PyTorch's CPU exp differ in the last bit for ~1 in 10
# inputs, so the two packages' softmax gradients differ by an f32 ulp.
# With bf16-rounded addends a gradient on a rounding boundary moves by a
# bf16 ulp, and a small leaf's value by ~1e-4 relative (same trees), so
# this comparison sums f32 addends; a leaf value near zero is a
# cancelling sum, hence the 1e-6 absolute floor beside rtol 1e-5.
F32_HIST = {"hist_dtype": "float32"}


@pytest.mark.parametrize("fused_split", ["auto", "off"])
@pytest.mark.parametrize("class_batch", ["on", "off"])
def test_train_matches_jax(rng, class_batch, fused_split):
    X, y, Xv, yv = _data(rng)
    jb, jtr, jrec = _jax_train(X, y, Xv, yv, 5, class_batch, **F32_HIST)
    p = {**PARAMS, **CPU, **F32_HIST, "fused_split": fused_split,
         "class_batch": class_batch}
    tr = lgt.Dataset(X, label=y, params=p,
                     bin_mappers=convert.bin_mappers_from_state(
                         m.state_arrays() for m in jtr.bin_mappers))
    va = lgt.Dataset(Xv, label=yv, reference=tr)
    trec = {}
    tb = lgt.train(p, tr, 5, valid_sets=[va], valid_names=["v"],
                   callbacks=[lgt.record_evaluation(trec)])
    assert tb._gbdt.class_batch_ok == (class_batch == "on")
    assert jb._gbdt.class_batch_ok == (class_batch == "on")
    jt, tt = jb._all_trees(), tb._trees
    assert len(jt) == len(tt) == 5 * K
    for a, b in zip(jt, tt):
        assert _tree_key(a) == _tree_key(b)
        np.testing.assert_allclose(b.leaf_value, a.leaf_value, rtol=1e-5,
                                   atol=1e-6)
    raw_t = tb.predict(Xv, raw_score=True)
    assert raw_t.shape == (len(Xv), K)
    np.testing.assert_allclose(raw_t, jb.predict(Xv, raw_score=True),
                               atol=1e-5)
    np.testing.assert_allclose(trec["v"]["multi_logloss"],
                               jrec["v"]["multi_logloss"], atol=1e-5)
    assert trec["v"]["multi_logloss"][-1] < trec["v"]["multi_logloss"][0]


def test_ova_train_matches_jax(rng):
    X, y, Xv, yv = _data(rng)
    extra = {"objective": "multiclassova", "sigmoid": 1.5, **F32_HIST}
    jb, jtr, _ = _jax_train(X, y, Xv, yv, 3, "on", **extra)
    p = {**PARAMS, **extra, **CPU}
    tr = lgt.Dataset(X, label=y, params=p,
                     bin_mappers=convert.bin_mappers_from_state(
                         m.state_arrays() for m in jtr.bin_mappers))
    tb = lgt.train(p, tr, 3)
    for a, b in zip(jb._all_trees(), tb._trees):
        assert _tree_key(a) == _tree_key(b)
    np.testing.assert_allclose(tb.predict(Xv), jb.predict(Xv), atol=1e-5)
    assert "multiclassova num_class:3 sigmoid:1.5" in tb.model_to_string()


def test_models_cross_load(rng, tmp_path):
    X, y, Xv, yv = _data(rng)
    jb, _, _ = _jax_train(X, y, Xv, yv, 4, "on")
    port = convert.booster_from_model_string(jb.model_to_string(),
                                             params=CPU)
    for raw in (True, False):
        np.testing.assert_allclose(port.predict(Xv, raw_score=raw),
                                   jb.predict(Xv, raw_score=raw), atol=1e-6)
    tb = lgt.train({**PARAMS, **CPU}, lgt.Dataset(X, label=y, params=CPU), 4)
    path = tmp_path / "mc.txt"
    tb.save_model(str(path))
    assert "objective=multiclass num_class:3" in path.read_text()
    again = lgt.Booster(model_file=str(path), params=CPU)
    assert np.array_equal(again.predict(Xv), tb.predict(Xv))
    np.testing.assert_allclose(lgb.Booster(model_file=str(path)).predict(Xv),
                               tb.predict(Xv), atol=1e-6)


def test_class_batch_gate(rng, monkeypatch):
    X, y, _, _ = _data(rng)

    def reason(**extra):
        p = {**PARAMS, **CPU, **extra}
        b = lgt.Booster(params=p, train_set=lgt.Dataset(X, label=y,
                                                        params=CPU))
        b._ensure_gbdt()
        return b._gbdt.class_batch_reason
    assert reason() == ""
    assert reason(class_batch="off") == "class_batch=off"
    yb = (y > 0).astype(float)
    bin_p = {"objective": "binary", "num_class": 1, "metric": "auc"}
    b = lgt.Booster(params={**PARAMS, **CPU, **bin_p},
                    train_set=lgt.Dataset(X, label=yb, params=CPU))
    b._ensure_gbdt()
    assert b._gbdt.class_batch_reason == "single model per iteration"
    monkeypatch.setenv("LIGHTGBM_TPU_CLASS_BATCH", "0")
    assert reason() == "LIGHTGBM_TPU_CLASS_BATCH=0"


def test_binary_class_batch_on_matches_default(rng):
    """K = 1 through the batched builder (class_batch=on): the same
    trees as the default binary path."""
    X, y, Xv, _ = _data(rng)
    yb = (y > 0).astype(float)
    p = {**PARAMS, **CPU, "objective": "binary", "num_class": 1,
         "metric": "auc"}
    a = lgt.train(p, lgt.Dataset(X, label=yb, params=CPU), 4)
    b = lgt.train({**p, "class_batch": "on"},
                  lgt.Dataset(X, label=yb, params=CPU), 4)
    assert b._gbdt.class_batch_ok and not a._gbdt.class_batch_ok
    for s, t in zip(a._trees, b._trees):
        assert _tree_key(s) == _tree_key(t)
    np.testing.assert_allclose(a.predict(Xv), b.predict(Xv), atol=1e-6)


def test_no_split_iteration_stops_all_classes(rng):
    """Training stops only at an iteration where no class grew."""
    X, y, _, _ = _data(rng)
    p = {**PARAMS, **CPU, "min_data_in_leaf": 2000}
    b = lgt.train(p, lgt.Dataset(X, label=y, params=CPU), 3)
    assert b.num_trees() == K                 # the first iteration is kept
    assert all(t.num_leaves == 1 for t in b._trees)
