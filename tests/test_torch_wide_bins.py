"""PyTorch port, wide bins on the CPU against the JAX package: max_bin
above 255 and EFB bundles of more than 256 bins.

- the binned matrix of a Dataset at max_bin 511 and 1023 (int16 in the
  port, int32 in the JAX package) and of a ``max_bundle_bins=512``
  bundle plan holds the JAX package's values, valid sets included; so
  does the plan of ``chip_smoke.py``'s ``[wide-efb]`` data (64 sparse
  columns at ``max_bundle_bins=1024``), at 2^17 of its rows;
- the plain B1 and B2 (``build_histograms``,
  ``fused_build_best_splits``) at B = 1,024 against the JAX package's
  Pallas kernels in interpret mode: f32 within rtol 1e-5, int8 exact,
  winner fields equal;
- training at max_bin 511 through B2's arm and the two-pass arm
  (``fused_split=off``), class-batched multiclass, quantized, and over
  a wide bundle plan: trees equal to the JAX package's (structure and
  thresholds exact, values within 1e-5 absolute or relative (hessian
  weights run to hundreds), split gains within rtol 1e-4: f32 sums in
  another order);
- the kernels' plans at wide B fit the card: B1/B2 tile the bins, B3
  covers them in ranges once a feature's accumulator no longer fits.
"""

import importlib.util
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lightgbm_tpu as lgb
import lightgbm_tpu_torch as lgt
from lightgbm_tpu.ops import pallas_histogram as PH
from lightgbm_tpu.ops import split as JS
from lightgbm_tpu_torch import convert
from lightgbm_tpu_torch.ops import cuda_histogram as CH
from lightgbm_tpu_torch.ops import split as TS
from lightgbm_tpu_torch.ops.histogram import build_histograms

@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread for these small tensors: the same results,
    and far less CPU time when several test workers share the host."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


CPU = {"device_type": "cpu"}
BASE = {"num_leaves": 15, "min_data_in_leaf": 10, "learning_rate": 0.2,
        "verbosity": -1, "max_bin": 511}
EXACT_KEYS = ("num_leaves", "num_cat", "split_feature", "threshold",
              "decision_type", "left_child", "right_child", "leaf_count",
              "internal_count", "cat_boundaries", "cat_threshold",
              "shrinkage", "is_linear")
VALUE_KEYS = ("leaf_value", "internal_value", "leaf_weight",
              "internal_weight")


def _dense(rng, n=4000, f=6, task="binary"):
    X = rng.normal(size=(n, f))
    X[rng.rand(n) < 0.05, 2] = np.nan
    z = X[:, 0] * 1.5 - np.nan_to_num(X[:, 1]) ** 2 * 0.7 + X[:, 3]
    if task == "multiclass":
        y = (X[:, :3] + 0.5 * rng.normal(size=(n, 3))).argmax(1)
    else:
        y = z + rng.normal(scale=0.5, size=n) > 0
    return X, y.astype(float)


def _sparse(rng, n=6000, f=8):
    """Mutually exclusive sparse float columns (one non-zero a row), as
    tests/test_torch_binning.py's bundling data, with a label that
    reads them."""
    X = np.zeros((n, f))
    for j in range(f):
        rows = np.arange(j, n, f)
        X[rows, j] = rng.normal(size=len(rows))
    y = (X.sum(1) + 0.3 * rng.normal(size=n) > 0).astype(float)
    return X, y


def _trees_of(text):
    """Model text -> [{key: value string}] per tree."""
    out = []
    for block in text.split("end of trees")[0].split("Tree=")[1:]:
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
                    np.array(a[k].split(), float), rtol=1e-5, atol=1e-5,
                    err_msg=f"tree {i} {k}")
        if "split_gain" in a:
            np.testing.assert_allclose(
                np.array(b["split_gain"].split(), float),
                np.array(a["split_gain"].split(), float), rtol=1e-4,
                atol=1e-6, err_msg=f"tree {i} split_gain")


@pytest.mark.parametrize("max_bin", [511, 1023])
def test_wide_bins_value_equal(rng, max_bin):
    X, y = _dense(rng, n=8000)
    params = {"max_bin": max_bin, "enable_bundle": False}
    jds = lgb.Dataset(X, label=y, params=params).construct()
    tds = lgt.Dataset(X, label=y, params={**params, **CPU}).construct()
    assert jds.max_num_bin > 256 and tds.max_num_bin == jds.max_num_bin
    assert tds.bins.dtype == torch.int16
    np.testing.assert_array_equal(tds.bins.numpy(), jds.bins)
    vds = lgt.Dataset(X[:700], label=y[:700], reference=tds).construct()
    jvd = lgb.Dataset(X[:700], label=y[:700], reference=jds).construct()
    np.testing.assert_array_equal(vds.bins.numpy(), jvd.bins)


def test_wide_bundle_plan_value_equal(rng):
    X, y = _sparse(rng)
    params = {"max_bin": 255, "max_bundle_bins": 512}
    jds = lgb.Dataset(X, label=y, params=params).construct()
    tds = lgt.Dataset(X, label=y, params={**params, **CPU}).construct()
    jp, tp = jds.bundle_plan, tds.bundle_plan
    assert jp.max_bundle_bins > 256
    assert (tp.num_bundles, tp.max_bundle_bins) == (jp.num_bundles,
                                                    jp.max_bundle_bins)
    for k in ("feat_bundle", "feat_offset", "feat_mfb", "bundle_num_bins"):
        np.testing.assert_array_equal(getattr(tp, k), getattr(jp, k))
    assert tds.bins.dtype == torch.int16
    np.testing.assert_array_equal(tds.bins.numpy(), jds.bins)
    np.testing.assert_array_equal(tds.unbundled_bins(), jds.unbundled_bins())
    vds = lgt.Dataset(X[:900], label=y[:900], reference=tds).construct()
    jvd = lgb.Dataset(X[:900], label=y[:900], reference=jds).construct()
    np.testing.assert_array_equal(vds.bins.numpy(), jvd.bins)


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_chip_smoke_sparse_plan_matches_jax():
    """``[wide-efb]`` checks the port's bundle count on the card against
    the JAX package's at 2^21 rows (``SPARSE_JAX_BUNDLES``); the same
    generator at 2^17 rows plans equally in both packages, with bundles
    of more than 256 bins."""
    cs = _chip_smoke()
    X, y = cs.make_sparse_like(1 << 17)
    params = {k: cs.SPARSE_PARAMS[k] for k in ("max_bin", "max_bundle_bins")}
    jds = lgb.Dataset(X, label=y, params=params).construct()
    tds = lgt.Dataset(X, label=y, params={**params, **CPU}).construct()
    jp, tp = jds.bundle_plan, tds.bundle_plan
    assert tp.num_bundles == jp.num_bundles == cs.SPARSE_JAX_BUNDLES
    assert tp.max_bundle_bins == jp.max_bundle_bins > 256
    np.testing.assert_array_equal(tp.feat_bundle, jp.feat_bundle)
    np.testing.assert_array_equal(tds.bins.numpy(), jds.bins)


R, F, B, L = 1024, 4, 1024, 3


def _stream(rng, quant):
    bins = rng.randint(0, B - 1, size=(R, F)).astype(np.int32)
    bins[:, 1] = rng.randint(300, 340, size=R)      # a narrow range
    bins[rng.rand(R) < 0.1, 2] = B - 1              # the NaN bin
    rl = rng.randint(-1, L, size=R).astype(np.int32)
    if quant:
        gh = np.stack([rng.randint(-3, 4, size=R), rng.randint(0, 5, size=R),
                       np.ones(R)], axis=1).astype(np.int8)
    else:
        g = rng.normal(size=R).astype(np.float32)
        gh = np.stack([g, np.abs(g) + 0.5, np.ones(R, np.float32)], axis=1)
        gh[rl < 0] = 0.0
    return bins, gh, rl, np.arange(L, dtype=np.int32)


META = dict(num_bins_pf=np.full((F,), B, np.int32),
            nan_bin_pf=np.where(np.arange(F) == 2, B - 1, -1).astype(np.int32),
            is_cat_pf=np.zeros(F, bool))


@pytest.mark.parametrize("mode", ["float32", "int8"])
def test_plain_histogram_wide_matches_pallas(rng, mode):
    bins, gh, rl, lids = _stream(rng, mode == "int8")
    got = build_histograms(
        torch.from_numpy(bins.astype(np.int16)), torch.from_numpy(gh),
        torch.from_numpy(rl), torch.from_numpy(lids), num_bins=B,
        hist_dtype="float32").numpy()
    want = np.asarray(PH.build_histograms_pallas(
        jnp.asarray(bins), jnp.asarray(gh), jnp.asarray(rl),
        jnp.asarray(lids), num_bins=B, hist_dtype="float32",
        interpret=True))
    if mode == "int8":
        assert got.dtype == np.int32
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    assert got[:, 1, 340:].sum() == 0 and got[:, 1, 300:340].any()


@pytest.mark.parametrize("mode", ["float32", "int8"])
def test_plain_fused_wide_matches_pallas(rng, mode):
    quant = mode == "int8"
    bins, gh, rl, lids = _stream(rng, quant)
    sp = dict(min_data_in_leaf=5, min_sum_hessian_in_leaf=1e-3)
    ops = dict(META, feature_mask=np.ones((F,), bool))
    if quant:
        ops["quant_scales"] = np.asarray([0.25, 0.5], np.float32)
    want, whist = PH.fused_build_best_splits(
        jnp.asarray(bins), jnp.asarray(gh), jnp.asarray(rl),
        jnp.asarray(lids), num_bins=B, params=JS.SplitParams(**sp),
        hist_dtype="float32", emit_hist=True, interpret=True,
        **{k: jnp.asarray(v) for k, v in ops.items()})
    got, ghist = CH.fused_build_best_splits(
        *(torch.from_numpy(a) for a in (bins.astype(np.int16), gh, rl,
                                        lids)), num_bins=B,
        params=TS.SplitParams(**sp), hist_dtype="float32", emit_hist=True,
        **{k: torch.from_numpy(np.array(v)) for k, v in ops.items()})
    assert set(got) == set(want)
    for k in want:
        a, b = got[k].numpy(), np.asarray(want[k])
        if b.dtype.kind == "f":
            np.testing.assert_allclose(a, b, rtol=3e-6, atol=3e-6,
                                       err_msg=f"field {k!r}")
        else:
            np.testing.assert_array_equal(a.astype(b.dtype), b,
                                          err_msg=f"field {k!r}")
    if quant:
        np.testing.assert_array_equal(ghist.numpy(), np.asarray(whist))
    else:
        np.testing.assert_allclose(ghist.numpy(), np.asarray(whist),
                                   rtol=1e-5, atol=1e-5)
    assert int(got["threshold"].max()) > 255       # a wide winner


CASES = {
    "binary_b2": ({}, "binary", ""),
    "binary_b1": ({"fused_split": "off"}, "binary", "fused_split=off"),
    "multiclass": ({"num_class": 3}, "multiclass", ""),
    "quantized": ({"use_quantized_grad": True}, "binary", ""),
    "efb": ({"max_bin": 255, "max_bundle_bins": 1024}, "sparse",
            "EFB bundles unbundle the full histogram"),
}


@pytest.mark.parametrize("case", list(CASES))
def test_wide_training_matches_jax(rng, case):
    extra, task, arm = CASES[case]
    if task == "sparse":
        X, y = _sparse(rng)
        task = "binary"
    else:
        X, y = _dense(rng, task=task)
    p = {**BASE, **extra, "objective": task}
    jp = {**p, "tree_learner": "serial", "hist_impl": "scatter"}
    jtr = lgb.Dataset(X, label=y, params=jp)
    jb = lgb.train(jp, jtr, 3)
    tp = {**p, **CPU}
    mappers = [m.state_arrays() for m in jtr.bin_mappers]
    ttr = lgt.Dataset(X, label=y, params=tp,
                      bin_mappers=convert.bin_mappers_from_state(mappers))
    tb = lgt.train(tp, ttr, 3)
    g = tb._gbdt
    assert ttr.bins.dtype == torch.int16
    wide = g._bundle_bins if case == "efb" else g.B
    assert wide > 256
    if case == "efb":
        assert ttr.bundle_plan.num_bundles == jtr.bundle_plan.num_bundles
    assert g.fused_split_reason == arm
    assert g.class_batch_ok == (task == "multiclass")
    assert_model_text_equal(jb.model_to_string(), tb.model_to_string())
    assert sum(t.num_leaves for t in tb._trees) > 3 * len(tb._trees)
    np.testing.assert_allclose(tb.predict(X[:500], raw_score=True),
                               jb.predict(X[:500], raw_score=True),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("B_,L_", [(1024, 42), (1024, 21), (511, 147),
                                   (4096, 42), (256, 42)])
def test_slot_hist_plan_tiles_wide_bins(B_, L_):
    """B1's plan at wide B: balanced tiles of at most 64 bins past 256
    (one tile up to 256), each a block's histogram within the card's
    shared memory, the partials sized for all B bins, and a grid that
    still fills the card."""
    p = CH.slot_hist_plan(28, L_, B_, 10_500_000)
    assert p["n_btiles"] == (1 if B_ <= 256 else -(-B_ // 64))
    assert p["bin_tile"] * p["n_btiles"] >= B_
    assert p["bin_tile"] <= (B_ if B_ <= 256 else 64)
    assert p["smem"] == p["warps"] * (3 * p["bin_tile"] * 128 + 64 * 16)
    assert p["smem"] <= 232448 - 1024 and p["warps"] >= 2
    assert p["partial_bytes"] == ((p["n_items"] + p["n_segs"])
                                  * p["n_ftiles"] * 3 * B_ * 128)
    grid = (p["n_items"] - L_) * p["n_ftiles"] * p["n_btiles"]
    assert grid >= 132 * p["per_sm"]


@pytest.mark.parametrize("hd", ["bfloat16", "float32", "int8"])
@pytest.mark.parametrize("B_,bb", [(1024, 2), (2048, 2), (40000, 4)])
def test_class_mma_plan_covers_wide_bins(hd, B_, bb):
    """B3's plan at wide B: a block's [fc, 16 mtb, N] accumulator and
    staged bins of their own width fit; the ranges cover every bin; a
    warp's units still cover the block's M-tiles."""
    p = CH.class_mma_plan(54, 7, B_, 581_120, hd, bin_bytes=bb)
    assert p["smem"] <= 232448 - 1024
    assert p["mtb"] * p["n_btiles"] * 16 >= B_
    assert p["wpf"] * 4 >= p["mtb"]
    assert p["bin_bytes"] == bb
    if B_ == 1024:
        assert p["n_btiles"] == 1
    if B_ == 40000 or (B_ == 2048 and hd == "float32"):
        assert p["n_btiles"] > 1
    assert p["n_ftiles"] * p["n_btiles"] * p["n_chunks"] >= 132
