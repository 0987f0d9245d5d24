"""PyTorch port: the plain histogram (kernel B1's contract,
lightgbm_tpu_torch/ops/histogram.py) against the JAX package's Pallas
kernel in interpret mode and its XLA scatter path: f32, bf16-rounded
addends, exact int8, and a compacted stream with row_gather + num_rows.
f32 sums match within rtol 1e-5 (summation order differs from the
one-hot matmul); int8 is exact. Also the CPU dispatch of the CUDA
wrappers and the kernel's tile plan."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lightgbm_tpu.ops import histogram as JH
from lightgbm_tpu.ops import pallas_histogram as PH
from lightgbm_tpu_torch.boosting import tree_builder as TB
from lightgbm_tpu_torch.ops import cuda_histogram as CH
from lightgbm_tpu_torch.ops.histogram import build_histograms
from lightgbm_tpu_torch.ops.split import SplitParams

R, F, B, L = 1024, 8, 16, 6


def _stream(rng, quant=False):
    bins = rng.randint(0, B, size=(R, F)).astype(np.uint8)
    rl = rng.randint(-1, L, size=R).astype(np.int32)
    if quant:
        gh = np.stack([rng.randint(-3, 4, size=R), rng.randint(0, 5, size=R),
                       np.ones(R)], axis=1).astype(np.int8)
    else:
        g = rng.normal(size=R).astype(np.float32)
        gh = np.stack([g, np.abs(g) + 0.5, np.ones(R, np.float32)], axis=1)
        gh[rl < 0] = 0.0
    lids = np.array([3, 0, -2, 5, 1, -2], np.int32)   # pads are -2
    return bins, gh, rl, lids


def _compacted(rng, bins, gh, rl, lids):
    """The builder's stream: rows of the chosen slots first (original
    order), num_rows live, the rest dead."""
    live = np.isin(rl, lids[lids >= 0][:2])
    order = np.concatenate([np.nonzero(live)[0], np.nonzero(~live)[0]])
    n = int(live.sum())
    rl_c = np.where(np.arange(R) < n, rl[order], -1).astype(np.int32)
    return order.astype(np.int32), rl_c, gh[order], n


def _torch(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


@pytest.mark.parametrize("case", ["f32", "bf16", "int8", "compacted"])
def test_plain_histogram_matches_jax(rng, case):
    bins, gh, rl, lids = _stream(rng, quant=case == "int8")
    hd = "float32" if case == "f32" else "bfloat16"
    kw_j, kw_t = {}, {}
    if case == "compacted":
        order, rl, gh, n = _compacted(rng, bins, gh, rl, lids)
        kw_j = dict(row_gather=jnp.asarray(order),
                    num_rows=jnp.asarray(n, jnp.int32))
        kw_t = dict(row_gather=torch.from_numpy(order),
                    num_rows=torch.tensor(n, dtype=torch.int32))
    got = build_histograms(*_torch(bins, gh, rl, lids), num_bins=B,
                           hist_dtype=hd, **kw_t).numpy()
    scatter = np.asarray(JH.build_histograms(
        jnp.asarray(bins), jnp.asarray(gh), jnp.asarray(rl),
        jnp.asarray(lids), num_bins=B, impl="scatter", hist_dtype=hd,
        **kw_j))
    mat_bins = bins if case != "compacted" else bins[order]
    pallas = np.asarray(PH.build_histograms_pallas(
        jnp.asarray(mat_bins), jnp.asarray(gh), jnp.asarray(rl),
        jnp.asarray(lids), num_bins=B, hist_dtype=hd, interpret=True,
        num_rows=kw_j.get("num_rows")))
    if case == "int8":
        assert got.dtype == np.int32
        np.testing.assert_array_equal(got, scatter)
        np.testing.assert_array_equal(got, pallas)
    else:
        # row-order scatter sums: the same order as the XLA scatter
        np.testing.assert_array_equal(got, scatter)
        np.testing.assert_allclose(got, pallas, rtol=1e-5, atol=1e-5)
    assert not got[2].any() and not got[5].any()      # pad slots stay 0


def test_plain_histogram_init_and_blocks(rng):
    bins, gh, rl, lids = _stream(rng)
    t = _torch(bins, gh, rl, lids)
    one = build_histograms(*t, num_bins=B)
    blocked = build_histograms(*t, num_bins=B, block_rows=100)
    np.testing.assert_allclose(blocked.numpy(), one.numpy(), rtol=1e-5,
                               atol=1e-5)
    seeded = build_histograms(*t, num_bins=B, init=one)
    np.testing.assert_allclose(seeded.numpy(), 2 * one.numpy(), rtol=1e-6)


def test_wrappers_take_plain_version_on_cpu(rng):
    """CPU tensors go to the plain versions, and no launch is counted."""
    CH.reset_launch_counts()
    bins, gh, rl, lids = _stream(rng)
    t = _torch(bins, gh, rl, lids)
    np.testing.assert_array_equal(
        CH.build_histograms_cuda(*t, num_bins=B).numpy(),
        build_histograms(*t, num_bins=B).numpy())
    best, hist = CH.fused_build_best_splits(
        *t, num_bins=B, params=SplitParams(min_data_in_leaf=5),
        num_bins_pf=torch.full((F,), B, dtype=torch.int32),
        nan_bin_pf=torch.full((F,), -1, dtype=torch.int32),
        is_cat_pf=torch.zeros(F, dtype=torch.bool), emit_hist=True)
    np.testing.assert_array_equal(hist.numpy(),
                                  build_histograms(*t, num_bins=B).numpy())
    gh_k = torch.stack([t[1], t[1] * 2])
    roots = CH.build_root_histograms_classes(t[0], gh_k, t[2], num_bins=B)
    np.testing.assert_array_equal(
        roots.numpy(), CH.build_root_histograms_classes_plain(
            t[0], gh_k, t[2], num_bins=B).numpy())
    assert CH.LAUNCHES == {"build_histograms_cuda": 0,
                           "fused_build_best_splits": 0,
                           "build_root_histograms_classes": 0}


@pytest.mark.parametrize("F_,L_,B_", [(28, 42, 63), (28, 21, 63),
                                       (8, 6, 16), (3, 300, 16),
                                       (5, 3, 256)])
def test_kernel_tile_plan_fits_shared_memory(F_, L_, B_):
    p = CH.hist_plan(F_, L_, B_, R=10_500_000, acc_bytes=4)
    assert p["smem"] <= 232448 - 1024
    assert p["n_ftiles"] * p["fc"] >= F_
    assert p["n_stiles"] * p["Ls"] >= L_
    assert p["threads"] >= 32 * p["fc"] and p["threads"] <= 1024
    assert p["n_chunks"] >= 1


def test_builder_leaf_ids_are_distinct(rng):
    """The kernels may rely on it: every histogram call the tree builder
    makes names each real leaf id at most once (pads are -2)."""
    seen = []

    def spy(fn):
        def wrapped(bins, gh, rl, ids, **kw):
            seen.append(ids.clone())
            return fn(bins, gh, rl, ids, **kw)
        return wrapped
    orig = (CH.build_histograms_cuda, CH.fused_build_best_splits)
    X = rng.randint(0, B, size=(R, F)).astype(np.uint8)
    g = rng.normal(size=R).astype(np.float32)
    gh = torch.from_numpy(np.stack([g, np.ones(R, np.float32),
                                    np.ones(R, np.float32)], 1))
    try:
        CH.build_histograms_cuda = spy(orig[0])
        CH.fused_build_best_splits = spy(orig[1])
        for fused in (True, False):
            TB.build_tree(
                torch.from_numpy(X), gh, torch.zeros(R, dtype=torch.int32),
                torch.full((F,), B, dtype=torch.int32),
                torch.full((F,), -1, dtype=torch.int32),
                torch.zeros(F, dtype=torch.bool),
                torch.ones(F, dtype=torch.bool), num_leaves=15,
                leaf_batch=4, max_depth=-1, num_bins=B,
                split_params=SplitParams(min_data_in_leaf=5),
                fused_split=fused, has_cat=False)
    finally:
        CH.build_histograms_cuda, CH.fused_build_best_splits = orig
    assert len(seen) > 4
    for ids in seen:
        real = ids[ids >= 0]
        assert len(torch.unique(real)) == len(real)
        assert bool(((ids >= 0) | (ids == -2)).all())
