"""PyTorch port: one tree from the port's builder against the JAX
package's build_tree, at leaf_batch 1 and 4, with the histogram
subtraction cache on and off, through both of the port's arms (B2 fused
and B1 two-pass, their plain versions on the CPU). Features, thresholds,
default_left and leaf count are equal; leaf values within rtol 1e-5.
One case also runs the JAX fused Pallas arm in interpret mode."""

import functools as ft

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lightgbm_tpu.boosting import tree_builder as JTB
from lightgbm_tpu.ops import histogram as JH
from lightgbm_tpu.ops import pallas_histogram as PH
from lightgbm_tpu.ops.split import SplitParams as JSP
from lightgbm_tpu_torch.boosting import tree_builder as TTB
from lightgbm_tpu_torch.ops.predict import predict_bins_value
from lightgbm_tpu_torch.ops.split import SplitParams as TSP

@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread for these small tensors: the same results,
    and far less CPU time when several test workers share the host."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


R, F, B, NL = 2048, 8, 16, 15


def _problem(rng):
    bins = rng.randint(0, B - 1, size=(R, F)).astype(np.uint8)
    bins[rng.rand(R) < 0.1, 2] = B - 1              # NaN bin of feature 2
    bins[:, 5] = rng.randint(0, 4, size=R)          # one-hot categorical
    y = (bins[:, 0].astype(float) / B + 0.3 * (bins[:, 1] > 7)
         + 0.2 * (bins[:, 5] == 2) + rng.normal(scale=0.2, size=R) > 0.7)
    p = 0.4
    g = (p - y).astype(np.float32)
    h = np.full(R, p * (1 - p), np.float32)
    gh = np.stack([g, h, np.ones(R, np.float32)], axis=1)
    rl0 = np.zeros(R, np.int32)
    rl0[-37:] = -1                                  # padded rows
    gh[-37:, 2] = 0.0
    meta = dict(num_bins_pf=np.where(np.arange(F) == 5, 4, B).astype(np.int32),
                nan_bin_pf=np.where(np.arange(F) == 2, B - 1, -1)
                .astype(np.int32),
                is_cat_pf=np.arange(F) == 5,
                feature_mask=np.arange(F) != 6)
    return bins, gh, rl0, meta


SP = dict(min_data_in_leaf=10, min_sum_hessian_in_leaf=1e-3, lambda_l2=0.5)
ORDER = ("num_bins_pf", "nan_bin_pf", "is_cat_pf", "feature_mask")


def _jax_tree(bins, gh, rl0, meta, leaf_batch, hist_sub, **kw):
    t, rl, _ = JTB.build_tree(
        jnp.asarray(bins), jnp.asarray(gh), jnp.asarray(rl0),
        *(jnp.asarray(meta[k]) for k in ORDER), num_leaves=NL,
        leaf_batch=leaf_batch, max_depth=-1, num_bins=B,
        split_params=JSP(**SP), hist_sub=hist_sub,
        hist_impl=kw.pop("hist_impl", "scatter"), **kw)
    return t, np.asarray(rl)


def _torch_tree(bins, gh, rl0, meta, leaf_batch, hist_sub, fused):
    t, rl, _ = TTB.build_tree(
        *(torch.from_numpy(a) for a in (bins, gh, rl0)),
        *(torch.from_numpy(meta[k]) for k in ORDER), num_leaves=NL,
        leaf_batch=leaf_batch, max_depth=-1, num_bins=B,
        split_params=TSP(**SP), hist_sub=hist_sub, fused_split=fused)
    return t, rl.numpy()


def _assert_same_tree(t, j, rl_t, rl_j, min_leaves=5):
    n = int(j.num_nodes)
    assert int(t.num_leaves) == int(j.num_leaves) >= min_leaves
    assert int(t.num_nodes) == n
    for k in ("split_feature", "threshold_bin", "default_left", "is_cat",
              "left_child", "right_child", "leaf2node"):
        a = getattr(t, k).numpy()
        b = np.asarray(getattr(j, k))
        m = n if k != "leaf2node" else int(j.num_leaves)
        np.testing.assert_array_equal(a[:m], b[:m], err_msg=k)
    np.testing.assert_array_equal(t.cat_bitset.numpy()[:n],
                                  np.asarray(j.cat_bitset)[:n]
                                  .astype(np.int64))
    for k in ("node_value", "node_count", "node_hess", "gain"):
        np.testing.assert_allclose(getattr(t, k).numpy()[:n],
                                   np.asarray(getattr(j, k))[:n],
                                   rtol=1e-5, atol=1e-6, err_msg=k)
    np.testing.assert_array_equal(rl_t, rl_j)


@pytest.mark.parametrize("fused", [True, False], ids=["B2", "B1"])
@pytest.mark.parametrize("hist_sub", [True, False])
@pytest.mark.parametrize("leaf_batch", [1, 4])
def test_tree_matches_jax(rng, leaf_batch, hist_sub, fused):
    bins, gh, rl0, meta = _problem(rng)
    j, rl_j = _jax_tree(bins, gh, rl0, meta, leaf_batch, hist_sub)
    t, rl_t = _torch_tree(bins, gh, rl0, meta, leaf_batch, hist_sub, fused)
    _assert_same_tree(t, j, rl_t, rl_j)


def test_tree_matches_jax_fused_pallas_arm(rng, monkeypatch):
    """Against the JAX fused Pallas arm (interpret mode), which the TPU
    runs by default."""
    JH._reset_pallas_probe()
    for name in ("fused_build_best_splits", "build_histograms_pallas"):
        monkeypatch.setattr(PH, name, ft.partial(getattr(PH, name),
                                                 interpret=True))
    bins, gh, rl0, meta = _problem(rng)
    j, rl_j = _jax_tree(bins, gh, rl0, meta, 4, True, hist_impl="pallas",
                        fused_split=True)
    t, rl_t = _torch_tree(bins, gh, rl0, meta, 4, True, True)
    _assert_same_tree(t, j, rl_t, rl_j)
    JH._reset_pallas_probe()


def test_masked_rounds_are_no_ops(rng):
    """Rounds past the last possible split (the JAX loop's exit) leave
    every real slot untouched: a tree that stops early is the same tree
    whatever the round budget."""
    bins, gh, rl0, meta = _problem(rng)
    big = dict(SP, min_data_in_leaf=400)     # few splits possible
    t, rl, _ = TTB.build_tree(
        *(torch.from_numpy(a) for a in (bins, gh, rl0)),
        *(torch.from_numpy(meta[k]) for k in ORDER), num_leaves=NL,
        leaf_batch=1, max_depth=-1, num_bins=B, split_params=TSP(**big))
    j, rl_j, _ = JTB.build_tree(
        jnp.asarray(bins), jnp.asarray(gh), jnp.asarray(rl0),
        *(jnp.asarray(meta[k]) for k in ORDER), num_leaves=NL,
        leaf_batch=1, max_depth=-1, num_bins=B, split_params=JSP(**big),
        hist_impl="scatter")
    assert 1 < int(t.num_leaves) < NL
    _assert_same_tree(t, j, rl.numpy(), np.asarray(rl_j), min_leaves=2)


def test_binned_walk_lands_rows_in_their_leaves(rng):
    """ops/predict.py walks the device tree over binned rows to the leaf
    the builder's partition put each row in."""
    bins, gh, rl0, meta = _problem(rng)
    t, rl = _torch_tree(bins, gh, rl0, meta, 4, True, True)
    got = predict_bins_value(t, torch.from_numpy(meta["nan_bin_pf"]),
                             torch.from_numpy(bins), max_levels=NL)
    live = rl >= 0
    np.testing.assert_array_equal(got.numpy()[live],
                                  t.leaf_values.numpy()[rl[live]])
