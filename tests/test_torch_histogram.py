"""PyTorch port: the plain histogram (kernel B1's contract,
lightgbm_tpu_torch/ops/histogram.py) against the JAX package's Pallas
kernel in interpret mode and its XLA scatter path: f32, bf16-rounded
addends, exact int8, and a compacted stream with row_gather + num_rows.
f32 sums match within rtol 1e-5 (summation order differs from the
one-hot matmul); int8 is exact. Also the CPU dispatch of the CUDA
wrappers, the kernels' plans and the f32 addend split of B3's
tensor-core kernel."""

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


@pytest.mark.parametrize("F_,L_,B_,R_", [
    (28, 42, 63, 10_500_000),     # Higgs root: 2W slots, one live
    (28, 21, 63, 10_500_000),     # Higgs compacted child call
    (54, 147, 253, 4_067_084),    # class-batched Covertype, K x W slots
    (40, 6, 64, 1_000_000),       # F > 32: two feature tiles
    (5, 3, 256, 2_000_000),       # B = 256
    (8, 1, 16, 3_000),            # one slot
    (3, 300, 16, 500_000)])       # 300 slots
def test_slot_hist_plan_fits_and_bounds_the_grid(F_, L_, B_, R_):
    """B1's plan: shared memory of the items and of the pre-pass within
    the card's, features tiled a lane each, and a grid of
    ceil(R / S) + L items that covers every row in one slot and rows
    spread over all slots, with its partial buffer counted."""
    p = CH.slot_hist_plan(F_, L_, B_, R_)
    assert p["smem"] <= 232448 - 1024 and p["pre_smem"] <= 232448 - 1024
    assert p["smem"] == p["warps"] * (3 * B_ * 32 * 4 + 64 * 16)
    assert p["threads"] == 32 * p["warps"] <= 1024
    assert p["fc"] <= 32 and p["n_ftiles"] * p["fc"] >= F_
    assert p["n_ftiles"] == -(-F_ // 32)
    S = p["rows_per_item"]
    assert S % 32 == 0 and p["n_items"] == -(-R_ // S) + L_
    assert p["n_items"] * S >= R_                     # one slot
    rng = np.random.RandomState(L_)
    for spread in (np.ones(L_), rng.dirichlet(np.full(L_, 0.3))):
        rows = np.floor(spread / spread.sum() * R_).astype(np.int64)
        rows[0] += R_ - rows.sum()
        assert int((-(-rows // S)).sum()) <= p["n_items"]
    # fold segments of 32 items, for slots of more than 32 only
    for items in ([p["n_items"] - L_ + 1] + [0] * (L_ - 1),
                  [33] * (p["n_items"] // 33)):
        segs = sum(-(-i // 32) for i in items if i > 32)
        assert segs <= p["n_segs"]
    assert p["partial_bytes"] == ((p["n_items"] + p["n_segs"])
                                  * p["n_ftiles"] * 3 * B_ * 128)
    assert p["n_wchunks"] * p["chunk_rows"] >= R_
    assert p["meta_ints"] == 6 * L_ + 2 + L_ * p["n_wchunks"]
    assert p["record_bytes"] == 16 * R_
    # a stream in one slot fills the card several times over
    assert -(-R_ // S) * p["n_ftiles"] >= min(132 * p["per_sm"],
                                             -(-R_ // (32 * p["warps"])))


def test_slot_hist_plan_takes_overrides():
    """warps= and rows= fix the block width and S, so that two plans
    time at one shape; settings the card cannot take are refused."""
    p = CH.slot_hist_plan(28, 42, 63, 10_500_000, warps=4, rows=8192)
    assert (p["warps"], p["rows_per_item"]) == (4, 8192)
    assert p["n_items"] == -(-10_500_000 // 8192) + 42
    for bad in (dict(warps=0), dict(warps=9, B=253), dict(rows=0),
                dict(B=0), dict(L=0)):
        kw = dict(F=28, L=42, B=63, R=1000)
        kw.update(bad)
        with pytest.raises(ValueError):
            CH.slot_hist_plan(**kw)


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


@pytest.mark.parametrize("hd", ["bfloat16", "float32", "int8"])
@pytest.mark.parametrize("F_,K_,B_,R_", [(54, 7, 253, 581_120),
                                         (28, 1, 63, 10_500_000),
                                         (54, 11, 253, 581_120)])
def test_class_mma_plan_fits_the_card(F_, K_, B_, R_, hd):
    """B3's plan at the Covertype root, the Higgs shape with one class
    and eleven classes (two class tiles): shared memory, registers,
    the register chain and the grid stay within the H100's limits."""
    p = CH.class_mma_plan(F_, K_, B_, R_, hd)
    assert p["smem"] <= 232448 - 1024
    assert p["acc_regs"] <= 64                    # of 128 a thread
    assert p["tile_rows"] == 16 * p["steps"] <= 1024
    assert p["n_ftiles"] * p["n_ktiles"] * p["n_chunks"] >= 132
    assert p["n_ftiles"] * p["fc"] >= F_ and p["n_ktiles"] * p["kc"] >= K_
    assert p["kc"] * 3 <= 8 * p["n_tiles"] <= 24
    assert p["wpf"] * 4 * 16 >= B_
    assert p["threads"] <= 512                    # the launch bound
    assert p["fc"] * p["wpf"] <= 2 * p["threads"] // 32   # units a warp
    assert p["per_sm"] * p["threads"] >= 16 * 32 or p["fc"] * p["wpf"] < 16
    assert p["terms"] == (3 if hd == "float32" else 1)


@pytest.mark.parametrize("warps", [8, 16])
def test_class_mma_plan_fixes_the_block_width(warps):
    """A plan of a given block width keeps its features a block whatever
    the chain length, so that chain lengths compare at one block shape;
    out-of-range settings are refused."""
    a, b = (CH.class_mma_plan(54, 7, 253, 581_120, "bfloat16",
                              warps=warps, steps=s) for s in (16, 32))
    assert a["threads"] == b["threads"] == 32 * warps
    assert a["fc"] == b["fc"] == warps // 2
    assert (a["tile_rows"], b["tile_rows"]) == (256, 512)
    assert max(a["smem"], b["smem"]) <= 232448 - 1024
    for bad in (dict(warps=32), dict(steps=0), dict(steps=65)):
        with pytest.raises(ValueError):
            CH.class_mma_plan(54, 7, 253, 581_120, "bfloat16", **bad)


def test_b3_plan_and_mtiles_are_card_only():
    bins = torch.zeros((32, 2), dtype=torch.uint8)
    gh = torch.ones((2, 32, 3))
    rl = torch.zeros(32, dtype=torch.int32)
    for kw in (dict(plan={}), dict(mtiles=torch.zeros(2, dtype=torch.int64))):
        with pytest.raises(ValueError):
            CH.build_root_histograms_classes(bins, gh, rl, num_bins=4, **kw)


def test_bf16_split3_is_exact_over_exponents():
    """hi + mid + lo == x for f32 addends with exponents -100..100, the
    recipe B3's kernel follows to push f32 through bf16 products."""
    rng = np.random.RandomState(3)
    e = np.repeat(np.arange(-100, 101), 200)
    m = rng.uniform(1.0, 2.0, size=e.size) * rng.choice([-1.0, 1.0], e.size)
    x = torch.from_numpy((m * 2.0 ** e).astype(np.float32))
    x[::7] = torch.from_numpy(rng.randint(-128, 128, size=x[::7].numel())
                              .astype(np.float32))  # int8 grid values
    hi, mid, lo = CH.bf16_split3(x)
    assert hi.dtype == mid.dtype == lo.dtype == torch.bfloat16
    total = hi.double() + mid.double() + lo.double()
    assert torch.equal(total, x.double())
    # past the stated range the residual is no longer representable
    tiny = torch.tensor([1.2345678e-35], dtype=torch.float32)   # ~2^-116
    assert not torch.equal(sum(t.double() for t in CH.bf16_split3(tiny)),
                           tiny.double())
