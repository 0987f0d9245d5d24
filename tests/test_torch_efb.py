"""PyTorch port, EFB (exclusive feature bundling) on the CPU, against the
JAX package.

- the plan (``plan_bundles``), ``encode_bundles`` / ``encode_rows``
  (numpy and torch forms) and ``decode_feature_bins`` are bit-equal to
  ``lightgbm_tpu.efb``'s on one-hot blocks, a dense column and a
  conflicting pair;
- ``Dataset.bins`` of a train set and of its valid set (encoded into the
  train set's layout), and ``unbundled_bins``, equal the JAX
  ``Dataset``'s, also on the Covertype shape of ``chip_smoke.py``, which
  forms the JAX package's 12 bundles from 54 features;
- ``unbundle_histograms`` equals the JAX builder's ``unbundle`` on random
  int32 histograms, exactly;
- training through the bundled matrix matches ``lightgbm_tpu.train``
  (binary, class-batched and per-class multiclass): quantized, tree
  structures identical; at ``hist_dtype=float32`` too; leaf values and
  valid scores within 1e-5 relative (the two-pass arm scans descaled f32
  sums whose prefix-sum order differs between XLA and PyTorch, as on
  the unbundled quantized path);
- a bundled quantized run's trees equal the same data's
  ``enable_bundle=false`` run's, and ``_fused_split_reason`` names EFB;
- one tree built on the bundled matrix by both builders: equal
  structure and partition, and the binned walk with the EFB decode
  (``predict_bins_value(..., bundle_meta)``) lands rows where the
  builder put them and where the JAX walk does.
"""

import importlib.util
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lightgbm_tpu as lgb
import lightgbm_tpu_torch as lgt
from lightgbm_tpu import efb as JE
from lightgbm_tpu.boosting import tree_builder as JTB
from lightgbm_tpu.ops.predict import predict_bins_leaf as jax_leaf
from lightgbm_tpu.ops.split import SplitParams as JSP
from lightgbm_tpu_torch import convert
from lightgbm_tpu_torch import efb as TE
from lightgbm_tpu_torch.boosting.tree_builder import (build_tree,
                                                      unbundle_histograms)
from lightgbm_tpu_torch.ops.predict import (predict_bins_leaf,
                                            predict_bins_value)
from lightgbm_tpu_torch.ops.split import SplitParams as TSP

@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread for these small tensors: the same results,
    and far less CPU time when several test workers share the host."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


CPU = {"device_type": "cpu"}
PARAMS = {"objective": "binary", "num_leaves": 15, "leaf_batch": 4,
          "max_bin": 16, "min_data_in_leaf": 10, "learning_rate": 0.2,
          "verbosity": -1}
MULTI = {**PARAMS, "objective": "multiclass", "num_class": 3,
         "hist_dtype": "float32"}
GOSS = {"data_sample_strategy": "goss", "learning_rate": 0.5}


def _data(rng, n=4000, multiclass=False):
    """A dense column, an integer column, an 8-way and a 4-way one-hot
    block, a conflicting sparse pair (rows where both are non-zero) and
    two more dense columns: 17 columns that bundle into fewer."""
    X = np.zeros((n, 17))
    X[:, 0] = rng.normal(size=n)
    X[:, 1] = rng.randint(0, 30, size=n)
    a = rng.randint(0, 8, size=n)
    X[np.arange(n), 2 + a] = 1.0
    b = rng.randint(0, 4, size=n)
    X[np.arange(n), 10 + b] = 1.0
    pair = rng.rand(n)
    X[:, 14] = np.where(pair < 0.2, rng.uniform(1, 2, size=n), 0.0)
    X[:, 15] = np.where((pair > 0.18) & (pair < 0.4),
                        rng.uniform(1, 2, size=n), 0.0)
    X[:, 16] = rng.normal(size=n)
    logit = (X[:, 0] + 0.1 * X[:, 1] - 2 * X[:, 3] + X[:, 5] - X[:, 16]
             + X[:, 11] - 0.7 * X[:, 14] + 0.5 * X[:, 15])
    if multiclass:
        y = (np.stack([logit, -logit, X[:, 16] + X[:, 12]], 1)
             + rng.normal(size=(n, 3))).argmax(1)
    else:
        y = logit + rng.normal(size=n) > 0
    y = y.astype(float)
    return X[:3000], y[:3000], X[3000:], y[3000:]


def _chip_smoke():
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _tree_key(t):
    return (t.num_leaves, tuple(t.split_feature), tuple(t.threshold_bin),
            tuple(t.decision_type), tuple(t.left_child),
            tuple(t.right_child))


def _pair(X, y, params, Xv=None, yv=None):
    """The JAX Dataset (and valid set) and the port's on its mappers."""
    jp = {**params, "tree_learner": "serial", "hist_impl": "scatter"}
    jtr = lgb.Dataset(X, label=y, params=jp)
    tp = {**params, **CPU}
    ttr = lgt.Dataset(X, label=y, params=tp,
                      bin_mappers=convert.bin_mappers_from_state(
                          m.state_arrays()
                          for m in jtr.construct().bin_mappers))
    jva = tva = None
    if Xv is not None:
        jva = lgb.Dataset(Xv, label=yv, reference=jtr).construct()
        tva = lgt.Dataset(Xv, label=yv, reference=ttr).construct()
    return jp, jtr, jva, tp, ttr.construct(), tva


# -- the planner, the encoders and the decode -------------------------------

@pytest.mark.parametrize("conflict_rate", [0.0, 0.05])
@pytest.mark.parametrize("max_bundle_bins", [256, 48])
def test_plan_encode_decode_match_jax(rng, conflict_rate, max_bundle_bins):
    X, _, _, _ = _data(rng)
    nb = np.asarray([int(len(np.unique(X[:, f]))) if f >= 2 else 16
                     for f in range(X.shape[1])])
    nb = np.minimum(nb, 16)
    # per-feature bins: the dense columns quantised, the sparse ones by
    # value rank; most-frequent bins as a binner would give them
    bins = np.stack([np.unique(np.round(X[:, f], 1), return_inverse=True)[1]
                     % nb[f] for f in range(X.shape[1])], 1).astype(np.int64)
    mfb = np.asarray([np.bincount(bins[:, f]).argmax()
                      for f in range(X.shape[1])])
    kw = dict(max_conflict_rate=conflict_rate,
              max_bundle_bins=max_bundle_bins)
    jp = JE.plan_bundles(bins, nb, mfb, **kw)
    tp = TE.plan_bundles(bins, nb, mfb, **kw)
    for f in ("feat_bundle", "feat_offset", "feat_mfb", "bundle_num_bins"):
        np.testing.assert_array_equal(getattr(tp, f), getattr(jp, f), f)
    assert (tp.num_bundles, tp.max_bundle_bins) == (jp.num_bundles,
                                                    jp.max_bundle_bins)
    assert tp.num_bundles < X.shape[1]
    cols = [(f, bins[:, f]) for f in range(X.shape[1])]
    want = JE.encode_bundles(jp, iter(cols), len(bins))
    np.testing.assert_array_equal(TE.encode_bundles(tp, iter(cols),
                                                    len(bins)), want)
    got_t = TE.encode_bundles_torch(
        tp, ((f, torch.from_numpy(c)) for f, c in cols), len(bins), "cpu")
    np.testing.assert_array_equal(got_t.numpy(), want)
    # the streaming encoders, a batch at an offset into a wider matrix
    out_j = np.full((len(bins) + 7, tp.num_bundles), 9, want.dtype)
    out_n, out_t = out_j.copy(), torch.from_numpy(out_j.copy())
    JE.encode_rows(jp, bins[100:900], out_j, 5)
    TE.encode_rows(tp, bins[100:900], out_n, 5)
    TE.encode_rows_torch(tp, torch.from_numpy(bins[100:900]), out_t, 5)
    np.testing.assert_array_equal(out_n, out_j)
    np.testing.assert_array_equal(out_t.numpy(), out_j)
    # the decode: every feature's bins come back, in both forms
    raw = want[:, tp.feat_bundle].astype(np.int64)
    args = (tp.feat_offset[None, :], nb[None, :], tp.feat_mfb[None, :])
    dec_j = np.asarray(JE.decode_feature_bins(
        jnp.asarray(raw), *map(jnp.asarray, args), xp=jnp))
    dec_n = TE.decode_feature_bins(raw, *args)
    dec_t = TE.decode_feature_bins(torch.from_numpy(raw),
                                   *map(torch.from_numpy, args), xp=torch)
    np.testing.assert_array_equal(dec_n, dec_j)
    np.testing.assert_array_equal(dec_t.numpy(), dec_j)
    if conflict_rate == 0.0:
        np.testing.assert_array_equal(dec_n, bins)


@pytest.mark.parametrize("shape", ["synthetic", "covtype"])
def test_dataset_bins_match_jax(rng, shape):
    if shape == "covtype":
        cs = _chip_smoke()
        X_all, y_all = cs.make_covtype_like(8000)
        X, y, Xv, yv = X_all[:6000], y_all[:6000], X_all[6000:], \
            y_all[6000:]
        params = {"objective": "multiclass", "num_class": 7,
                  "verbosity": -1}
    else:
        X, y, Xv, yv = _data(rng)
        params = dict(PARAMS)
    jp, jtr, jva, tp, ttr, tva = _pair(X, y, params, Xv, yv)
    jbp, tbp = jtr.bundle_plan, ttr.bundle_plan
    assert jbp is not None and tbp is not None
    assert tbp.num_bundles == jbp.num_bundles
    if shape == "covtype":
        assert (tbp.num_bundles, ttr.num_features) == (12, 54)
    assert ttr.bins.dtype == torch.uint8
    assert ttr.bins.shape == (len(X), tbp.num_bundles)
    np.testing.assert_array_equal(ttr.bins.numpy(), jtr.bins)
    assert tva.bundle_plan is tbp
    np.testing.assert_array_equal(tva.bins.numpy(), jva.bins)
    np.testing.assert_array_equal(ttr.unbundled_bins(), jtr.unbundled_bins())
    np.testing.assert_array_equal(tva.unbundled_bins(), jva.unbundled_bins())
    # per-feature metadata stays in feature space
    np.testing.assert_array_equal(ttr.per_feature_num_bins(),
                                  jtr.per_feature_num_bins())


# -- the unbundle ------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1])
def test_unbundle_matches_jax(rng, monkeypatch, seed):
    """Random int32 bundle-space histograms, unbundled by the port and by
    the JAX builder's ``unbundle`` (reached through ``_build_tree_impl``
    with unit quantization scales: ``build_histograms`` returns the
    histogram, ``find_best_splits`` receives the unbundled one)."""
    X, y, _, _ = _data(rng)
    _, _, _, _, ttr, _ = _pair(X, y, dict(PARAMS))
    bp = ttr.bundle_plan
    G, bb = bp.num_bundles, bp.max_bundle_bins
    nbpf = ttr.per_feature_num_bins()
    F, B = len(nbpf), int(ttr.max_num_bin)
    W = 4
    r = np.random.RandomState(seed)
    hraw = r.randint(-2 ** 20, 2 ** 20, size=(2 * W, G, bb, 3)) \
        .astype(np.int32)
    seen = {}

    def fake_hist(*a, **k):
        assert k["num_bins"] == bb
        return jnp.asarray(hraw)

    class Stop(Exception):
        pass

    def capture(hist, *a, **k):
        seen["hist"] = np.asarray(hist)
        raise Stop
    monkeypatch.setattr(JTB, "build_histograms", fake_hist)
    monkeypatch.setattr(JTB, "find_best_splits", capture)
    meta = tuple(jnp.asarray(a) for a in (bp.feat_bundle, bp.feat_offset,
                                          bp.feat_mfb))
    R = 256
    with pytest.raises(Stop):
        JTB._build_tree_impl(
            jnp.zeros((R, G), jnp.uint8), jnp.zeros((R, 3), jnp.int8),
            jnp.zeros((R,), jnp.int32), jnp.asarray(nbpf),
            jnp.full((F,), -1, jnp.int32), jnp.zeros((F,), bool),
            jnp.ones((F,), bool), num_leaves=2 * W, leaf_batch=W,
            max_depth=-1, num_bins=B, split_params=JSP(),
            hist_impl="scatter", bundle_meta=meta, bundle_bins=bb,
            quant_scales=jnp.ones((2,), jnp.float32), hist_sub=False)
    want = seen["hist"]
    got = unbundle_histograms(
        torch.from_numpy(hraw),
        tuple(torch.from_numpy(a) for a in (bp.feat_bundle, bp.feat_offset,
                                            bp.feat_mfb)),
        bb, torch.from_numpy(nbpf), B)
    assert got.dtype == torch.int32 and got.shape == (2 * W, F, B, 3)
    # the JAX side unbundles the descaled (f32) histogram: integers below
    # 2^24 in magnitude, so exact
    assert np.abs(want).max() < 2 ** 24
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))


# -- training ----------------------------------------------------------------

# class-batched (B3 skipped: its roots are one B1 launch over the folded
# slots) and per-class multiclass, binary; quantized (int32 histograms,
# exact in both packages) and float32
TRAIN_CASES = {
    "binary_quant": ({**PARAMS, "use_quantized_grad": True}, False),
    "class_batched_quant": ({**MULTI, "use_quantized_grad": True}, True),
    "per_class_quant": ({**MULTI, "use_quantized_grad": True,
                         "class_batch": "off"}, True),
    "binary_f32": ({**PARAMS, "hist_dtype": "float32"}, False),
    "class_batched_f32": (MULTI, True),
    "per_class_f32": ({**MULTI, "class_batch": "off"}, True),
    # GOSS from iteration int(1 / 0.5) = 2 of 8
    "binary_goss_quant": ({**PARAMS, **GOSS, "use_quantized_grad": True},
                          False),
    "class_batched_goss_f32": ({**MULTI, **GOSS}, True),
}


@pytest.mark.parametrize("case", list(TRAIN_CASES))
def test_efb_train_matches_jax(rng, case):
    params, mc = TRAIN_CASES[case]
    X, y, Xv, yv = _data(rng, multiclass=mc)
    jp, jtr, jva, tp, ttr, tva = _pair(X, y, params, Xv, yv)
    assert ttr.bundle_plan is not None
    jb = lgb.train(jp, jtr, 8, valid_sets=[jva])
    tb = lgt.train(tp, ttr, 8, valid_sets=[tva])
    g = tb._gbdt
    assert g._bundle_meta is not None
    assert g.fused_split_reason == "EFB bundles unbundle the full histogram"
    assert g.class_batch_ok == (mc and params.get("class_batch") != "off")
    if g._goss:
        assert g._goss_start == 2     # crossed inside the run
    jt, tt = jb._all_trees(), tb._trees
    assert len(jt) == len(tt) == 8 * g.K
    for a, b in zip(jt, tt):
        assert _tree_key(a) == _tree_key(b)
        np.testing.assert_allclose(
            b.leaf_value, a.leaf_value, rtol=1e-5,
            atol=1e-5 * np.abs(a.leaf_value).max())
    # importance counts splits per input feature, not per bundle column
    imp = tb.feature_importance()
    assert imp.shape == (X.shape[1],) and imp.sum() > 0
    np.testing.assert_array_equal(imp, jb.feature_importance())
    # valid scores, updated through the relabel of the bundled valid bins
    jv, tv = jb._gbdt.eval_scores(0), g.eval_scores(0)
    np.testing.assert_allclose(tv, jv, rtol=1e-5, atol=1e-5 * np.abs(jv).max())
    np.testing.assert_allclose(tb.predict(Xv, raw_score=True), tv.squeeze(),
                               atol=1e-5 * np.abs(jv).max())


@pytest.mark.parametrize("multiclass", [False, True])
def test_efb_trees_equal_unbundled_run(rng, multiclass):
    """Quantized: the histograms are exact int32 and the unbundled
    per-feature histogram equals the directly built one, so bundling
    changes no tree."""
    X, y, _, _ = _data(rng, multiclass=multiclass)
    p = {**(MULTI if multiclass else PARAMS), **CPU,
         "use_quantized_grad": True}
    tb = lgt.train(p, lgt.Dataset(X, label=y, params=p), 6)
    pu = {**p, "enable_bundle": False}
    ub = lgt.train(pu, lgt.Dataset(X, label=y, params=pu), 6)
    assert tb._gbdt._bundle_meta is not None and ub._gbdt._bundle_meta is None
    assert ub._gbdt.fused_split_reason == ""
    for a, b in zip(tb._trees, ub._trees):
        assert _tree_key(a) == _tree_key(b)
        np.testing.assert_allclose(a.leaf_value, b.leaf_value, rtol=1e-5,
                                   atol=1e-5 * np.abs(b.leaf_value).max())


def test_bundled_build_and_walk_match_jax(rng):
    """One tree built on the bundled matrix by the port's builder and by
    the JAX package's (int8 gh, so the histograms are exact): equal
    structure and partition; the binned walk with the EFB decode
    (``predict_bins_value(..., bundle_meta)``) lands every row in its
    builder leaf, equal to the walk over the unbundled matrix and to the
    JAX walk."""
    X, y, _, _ = _data(rng)
    _, _, _, _, ttr, _ = _pair(X, y, dict(PARAMS))
    bp = ttr.bundle_plan
    R = ttr.num_data
    bins = ttr.bins.numpy()
    gh = np.stack([rng.randint(-3, 4, size=R), rng.randint(1, 5, size=R),
                   np.ones(R)], 1).astype(np.int8)
    rl0 = np.zeros(R, np.int32)
    meta = [ttr.per_feature_num_bins(), ttr.per_feature_nan_bins(),
            ttr.per_feature_is_categorical(),
            np.ones(ttr.num_features, bool)]
    bmeta = (bp.feat_bundle, bp.feat_offset, bp.feat_mfb)
    kw = dict(num_leaves=15, leaf_batch=4, max_depth=-1,
              num_bins=int(ttr.max_num_bin), bundle_bins=bp.max_bundle_bins)
    qs = np.asarray([0.1, 0.05], np.float32)
    t, rl, _ = build_tree(
        *(torch.from_numpy(a) for a in (bins, gh, rl0, *meta)),
        split_params=TSP(min_data_in_leaf=10.0),
        bundle_meta=tuple(map(torch.from_numpy, bmeta)),
        quant_scales=torch.from_numpy(qs), **kw)
    j, rl_j, _ = JTB.build_tree(
        *(jnp.asarray(a) for a in (bins, gh, rl0, *meta)),
        split_params=JSP(min_data_in_leaf=10.0),
        bundle_meta=tuple(map(jnp.asarray, bmeta)),
        quant_scales=jnp.asarray(qs), hist_impl="scatter", **kw)
    assert int(t.num_leaves) == int(j.num_leaves) > 4
    for f in ("split_feature", "threshold_bin", "is_cat", "left_child",
              "right_child"):
        np.testing.assert_array_equal(getattr(t, f).numpy(),
                                      np.asarray(getattr(j, f)), f)
    np.testing.assert_array_equal(rl.numpy(), np.asarray(rl_j))
    nan = torch.from_numpy(meta[1])
    nbpf = torch.from_numpy(meta[0])
    got = predict_bins_value(t, nan, torch.from_numpy(bins), 15,
                             tuple(map(torch.from_numpy, bmeta)), nbpf)
    np.testing.assert_array_equal(got.numpy(),
                                  t.leaf_values.numpy()[rl.numpy()])
    flat = predict_bins_value(t, nan, torch.from_numpy(ttr.unbundled_bins()),
                              15)
    np.testing.assert_array_equal(got.numpy(), flat.numpy())
    # the JAX walk lands every row on the same node (leaf values agree
    # to f32 rounding: the descaled sums are f32 in both packages)
    leaf = predict_bins_leaf(t, nan, torch.from_numpy(bins), 15,
                             tuple(map(torch.from_numpy, bmeta)), nbpf)
    want = jax_leaf(j.split_feature, j.threshold_bin, j.default_left,
                    j.is_cat, j.left_child, j.right_child, j.cat_bitset,
                    jnp.asarray(meta[1]), jnp.asarray(bins),
                    bundle_meta=tuple(map(jnp.asarray, bmeta)),
                    num_bins_pf=jnp.asarray(meta[0]))
    np.testing.assert_array_equal(leaf.numpy(), np.asarray(want))
