"""PyTorch port, quantized training on the CPU, against the JAX package.

- ``_quantize_impl``: the int8 grid values and the per-class scales are
  bit-equal to the JAX package's on the same g, h and key, with
  stochastic rounding (the port's threefry draws) and without;
- int8 gh summed into int32: the plain B1 (full and compacted streams)
  and B3 histograms equal the JAX package's exactly, and the split
  search over them with per-slot scales (the class-batched build's
  folded slots) equals the JAX package's ``find_best_splits``;
- ``train`` with ``use_quantized_grad`` (binary, class-batched and
  per-class multiclass; ``fused_split`` on and off; leaf renewal on and
  off; deterministic rounding): tree structures equal, leaf values within
  1e-5 relative, raw predictions within 1e-5. The port's fused arm scans
  the int32 sums and descales at gain time (kernel B2's epilogue), so it
  is held against the JAX package's fused arm, whose Pallas kernels run
  in interpret mode as its own tests run them
  (``tests/test_fused_split.py``); the two-pass arm against the JAX
  package's scatter path, which descales before the scan;
- the range and int32-overflow guards raise ``ValueError`` with the JAX
  package's messages.
"""

import functools as ft

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lightgbm_tpu as lgb
import lightgbm_tpu_torch as lgt
from lightgbm_tpu.ops import histogram as JH
from lightgbm_tpu.ops import pallas_histogram as PH
from lightgbm_tpu.ops.histogram import build_histograms as jax_hist
from lightgbm_tpu.ops.split import SplitParams as JaxSplitParams
from lightgbm_tpu.ops.split import find_best_splits as jax_best
from lightgbm_tpu_torch import convert
from lightgbm_tpu_torch.ops import cuda_histogram as CH
from lightgbm_tpu_torch.ops import threefry
from lightgbm_tpu_torch.ops.histogram import build_histograms
from lightgbm_tpu_torch.ops.split import SplitParams, find_best_splits

@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread for these small tensors: the same results,
    and far less CPU time when several test workers share the host."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


CPU = {"device_type": "cpu"}
BINARY = {"objective": "binary", "num_leaves": 15, "leaf_batch": 4,
          "max_bin": 16, "min_data_in_leaf": 10, "learning_rate": 0.2,
          "verbosity": -1, "use_quantized_grad": True}
MULTI = {**BINARY, "objective": "multiclass", "num_class": 3,
         "hist_dtype": "float32"}


@pytest.fixture
def interp(monkeypatch):
    """The JAX package's Pallas kernels through the interpreter, its
    probe verdicts forgotten on both sides (tests/test_fused_split.py's
    fixture)."""
    JH._reset_pallas_probe()
    for name in ("fused_build_best_splits", "build_histograms_pallas",
                 "build_root_histograms_classes"):
        monkeypatch.setattr(PH, name, ft.partial(getattr(PH, name),
                                                 interpret=True))
    yield
    JH._reset_pallas_probe()


def _jax_params(params):
    """The JAX side of a case: its fused arm (interpreted Pallas) for
    the port's fused arm, its scatter path for the two-pass arm."""
    jp = {**params, "tree_learner": "serial"}
    if params.get("fused_split") == "off":
        return {**jp, "hist_impl": "scatter"}
    return {**jp, "hist_impl": "pallas", "fused_split": "on"}


def _data(rng, n=4000, f=8, multiclass=False, offset=None, n_train=3000):
    X = rng.normal(size=(n, f))
    X[rng.rand(n) < 0.05, 2] = np.nan
    if offset is not None:
        # a regression label far from 0: a padded row's gradient (label
        # 0 at the initial score) then sets the quantization scale
        y = offset + 3.0 * X[:, 0] + rng.normal(size=n)
    elif multiclass:
        logits = np.stack([X[:, 0] * 1.5, np.nan_to_num(X[:, 1]) ** 2 - 0.5,
                           X[:, 3] - X[:, 4]], 1)
        y = (logits + rng.normal(scale=0.7, size=(n, 3))).argmax(1)
    else:
        y = (X[:, 0] * 1.5 - np.nan_to_num(X[:, 1]) ** 2 * 0.7
             + rng.normal(scale=0.5, size=n) > 0)
    y = y.astype(float)
    return X[:n_train], y[:n_train], X[n_train:], y[n_train:]


def _tree_key(t):
    return (t.num_leaves, tuple(t.split_feature), tuple(t.threshold_bin),
            tuple(t.decision_type), tuple(t.left_child),
            tuple(t.right_child))


def _gbdts(rng, params, multiclass=False):
    """The JAX package's booster after one round and the port's, built
    on the same data and bin mappers."""
    X, y, _, _ = _data(rng, multiclass=multiclass)
    jp = {**params, "tree_learner": "serial", "hist_impl": "scatter"}
    jtr = lgb.Dataset(X, label=y, params=jp)
    jb = lgb.train(jp, jtr, 1)
    tp = {**params, **CPU}
    tb = lgt.Booster(params=tp, train_set=lgt.Dataset(
        X, label=y, params=tp, bin_mappers=convert.bin_mappers_from_state(
            m.state_arrays() for m in jtr.bin_mappers)))
    tb._ensure_gbdt()
    return jb._gbdt, tb._gbdt


@pytest.mark.parametrize("stochastic", [True, False])
@pytest.mark.parametrize("K", [1, 3])
def test_quantize_matches_jax(rng, K, stochastic):
    params = {**(MULTI if K > 1 else BINARY),
              "stochastic_rounding": stochastic, "num_grad_quant_bins": 6}
    jg, tg = _gbdts(rng, params, multiclass=K > 1)
    n, R = tg.train_dd.num_data, tg.train_dd.r_pad
    assert R > n                          # the port pads the rows
    g = rng.normal(size=(K, R)).astype(np.float32)
    h = rng.uniform(0.05, 1.0, size=(K, R)).astype(np.float32)
    g[:, n:] *= 4.0                       # padded rows hold the maxima
    h[:, n:] *= 1.5
    g[0, 5] = 0.0                         # a zero grad rounds up
    key_j = jax.random.fold_in(jax.random.PRNGKey(11), 4)
    key_t = threefry.fold_in(threefry.prng_key(11), torch.tensor(4))
    qg_j, qh_j, gs_j, hs_j = jg._quantize_impl(jnp.asarray(g),
                                               jnp.asarray(h), key_j)
    qg_t, qh_t, qs_t = tg._quantize_impl(torch.from_numpy(g),
                                         torch.from_numpy(h), key_t)
    assert qg_t.dtype == qh_t.dtype == torch.int8
    assert np.array_equal(qg_t.numpy(), np.asarray(qg_j))
    assert np.array_equal(qh_t.numpy(), np.asarray(qh_j))
    assert np.array_equal(qs_t[:, 0].numpy(), np.asarray(gs_j))
    assert np.array_equal(qs_t[:, 1].numpy(), np.asarray(hs_j))
    assert np.abs(qg_t.numpy()).max() <= 3 and qh_t.numpy().min() >= 0


def test_int32_histograms_and_split_search_match_jax(rng):
    R, F, B, L = 2048, 5, 16, 6
    bins = rng.randint(0, B, size=(R, F)).astype(np.uint8)
    gh = np.stack([rng.randint(-2, 3, size=R), rng.randint(0, 5, size=R),
                   rng.randint(0, 2, size=R)], axis=1).astype(np.int8)
    rl = rng.randint(-1, L, size=R).astype(np.int32)
    lids = np.arange(L, dtype=np.int32)
    ref = np.asarray(jax_hist(jnp.asarray(bins), jnp.asarray(gh),
                              jnp.asarray(rl), jnp.asarray(lids),
                              num_bins=B, impl="scatter"))
    assert ref.dtype == np.int32
    t = [torch.from_numpy(a) for a in (bins, gh, rl, lids)]
    got = build_histograms(*t, num_bins=B)
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), ref)
    # the compacted stream: rows gathered, a device-side live count
    perm = rng.permutation(R).astype(np.int32)
    n_live = torch.tensor(1500, dtype=torch.int32)
    rl_c = np.where(np.arange(R) < 1500, rl[perm], -1).astype(np.int32)
    got_c = build_histograms(t[0], t[1][perm], torch.from_numpy(rl_c),
                             t[3], num_bins=B,
                             row_gather=torch.from_numpy(perm),
                             num_rows=n_live)
    want_c = np.asarray(jax_hist(jnp.asarray(bins[perm]),
                                 jnp.asarray(gh[perm]), jnp.asarray(rl_c),
                                 jnp.asarray(lids), num_bins=B,
                                 impl="scatter"))
    assert np.array_equal(got_c.numpy(), want_c)
    # B3's plain version: each class's root histogram, int32
    gh_k = np.stack([gh, gh[::-1].copy()])
    rl0 = np.where(rl >= 0, 0, -1).astype(np.int32)
    roots = CH.build_root_histograms_classes(
        t[0], torch.from_numpy(gh_k), torch.from_numpy(rl0), num_bins=B)
    for k in range(2):
        want = np.asarray(jax_hist(jnp.asarray(bins), jnp.asarray(gh_k[k]),
                                   jnp.asarray(rl0),
                                   jnp.asarray(np.zeros(1, np.int32)),
                                   num_bins=B, impl="scatter"))[0]
        assert np.array_equal(roots[k].numpy(), want)
    # split search on the raw sums with per-slot scales, and B2's plain
    # version with the same scales
    qs = rng.uniform(0.01, 0.2, size=(L, 2)).astype(np.float32)
    nbpf = np.full(F, B, np.int32)
    nan = np.full(F, -1, np.int32)
    nan[1] = B - 1
    cat = np.zeros(F, bool)
    kw = dict(lambda_l1=0.1, lambda_l2=1.0, min_data_in_leaf=5.0,
              min_sum_hessian_in_leaf=1e-3)
    want = jax_best(jnp.asarray(ref), jnp.asarray(nbpf), jnp.asarray(nan),
                    jnp.asarray(cat), JaxSplitParams(**kw),
                    quant_scales=jnp.asarray(qs))
    meta = [torch.from_numpy(a) for a in (nbpf, nan, cat)]
    got_b = find_best_splits(got, *meta, SplitParams(**kw),
                             quant_scales=torch.from_numpy(qs))
    fused, _ = CH.fused_build_best_splits(
        *t, num_bins=B, params=SplitParams(**kw), num_bins_pf=meta[0],
        nan_bin_pf=meta[1], is_cat_pf=meta[2],
        quant_scales=torch.from_numpy(qs))
    for best in (got_b, fused):
        for k in ("gain", "feature", "threshold", "default_left",
                  "left_sum", "right_sum", "left_out", "right_out"):
            np.testing.assert_array_equal(best[k].numpy(),
                                          np.asarray(want[k]), err_msg=k)


# each build (binary, class-batched, per class) through both arms, leaf
# renewal on each build, and deterministic rounding; the fused arm's JAX
# side runs interpreted Pallas, the costly part of this file, so
# renewal rides along.
# Deterministic rounding's coarse grid makes exact gain ties common: the
# fused arm scans int32 in both packages (order-free, exact), while the
# two-pass arm's f32 scan of descaled sums breaks such ties by XLA's and
# PyTorch's rounding orders, which differ (ROADMAP C).
# The offset regression cases hold the scales' maxima over the padded
# rows to the JAX package's; in the second, 2048 rows are a multiple of
# the port's 256-row padding but not of the JAX package's 65,536-row
# block at 4 features x 63 bins, so only the JAX layout pads unless the
# port pads one more block.
TRAIN_CASES = {
    "binary": (BINARY, False),
    "regression_offset": ({**BINARY, "objective": "regression"}, None),
    "regression_offset_block": (
        {**BINARY, "objective": "regression", "max_bin": 63}, None,
        dict(n=3000, f=4, n_train=2048)),
    "binary_b1_renew": ({**BINARY, "fused_split": "off",
                         "quant_train_renew_leaf": True}, False),
    "binary_deterministic": ({**BINARY, "stochastic_rounding": False,
                              "num_grad_quant_bins": 8}, False),
    "class_batched": (MULTI, True),
    "class_batched_b1_renew": ({**MULTI, "fused_split": "off",
                                "quant_train_renew_leaf": True}, True),
    "per_class_renew": ({**MULTI, "class_batch": "off",
                         "quant_train_renew_leaf": True}, True),
    "per_class_b1": ({**MULTI, "class_batch": "off", "fused_split": "off"},
                     True),
}


@pytest.mark.parametrize("case", list(TRAIN_CASES))
def test_quantized_train_matches_jax(rng, interp, case):
    params, mc, *data_kw = TRAIN_CASES[case]
    X, y, Xv, _ = _data(rng, multiclass=bool(mc),
                        offset=100.0 if mc is None else None,
                        **(data_kw[0] if data_kw else {}))
    jp = _jax_params(params)
    jtr = lgb.Dataset(X, label=y, params=jp)
    jb = lgb.train(jp, jtr, 8)
    assert jb._gbdt.fused_split_ok == (params.get("fused_split") != "off")
    tp = {**params, **CPU}
    tb = lgt.train(tp, lgt.Dataset(
        X, label=y, params=tp, bin_mappers=convert.bin_mappers_from_state(
            m.state_arrays() for m in jtr.bin_mappers)), 8)
    g = tb._gbdt
    jd = jb._gbdt.train_dd
    # a padded row in both packages, or in neither
    assert (g.train_dd.r_pad > len(X)) == (jd.r_pad > len(X))
    assert g._quant and g._renew == bool(
        params.get("quant_train_renew_leaf", False))
    assert g.class_batch_ok == (bool(mc)
                                and params.get("class_batch") != "off")
    assert g.fused_split_ok == (params.get("fused_split") != "off")
    jt, tt = jb._all_trees(), tb._trees
    assert len(jt) == len(tt) == 8 * g.K
    for a, b in zip(jt, tt):
        assert _tree_key(a) == _tree_key(b)
        np.testing.assert_allclose(
            b.leaf_value, a.leaf_value, rtol=1e-5,
            atol=1e-5 * np.abs(a.leaf_value).max())
    np.testing.assert_allclose(tb.predict(Xv, raw_score=True),
                               jb.predict(Xv, raw_score=True), atol=1e-5)


def test_quantized_guards_raise_as_jax(rng, monkeypatch):
    X, y, _, _ = _data(rng)
    for nbq in (1, 128):
        p = {**BINARY, "num_grad_quant_bins": nbq}
        with pytest.raises(ValueError, match=r"must be in \[2, 127\]"):
            lgb.train({**p, "tree_learner": "serial"},
                      lgb.Dataset(X, label=y), 1)
        with pytest.raises(ValueError, match=r"must be in \[2, 127\]"):
            lgt.train({**p, **CPU}, lgt.Dataset(X, label=y, params=CPU), 1)

    def booster(num_data):
        tr = lgt.Dataset(X, label=y, params=CPU).construct()
        monkeypatch.setattr(tr, "num_data", num_data)
        b = lgt.Booster(params={**BINARY, **CPU}, train_set=tr)
        b._ensure_gbdt()
    # num_grad_quant_bins 4: the hessian sums reach num_data * 4
    with pytest.raises(ValueError, match="overflows the int32 histogram"):
        booster(2 ** 29)
    booster(len(X))
