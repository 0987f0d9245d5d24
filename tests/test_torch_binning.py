"""PyTorch port: BinMapper bounds, the binned matrix and model text are
bit-equal to the JAX package's (lightgbm_tpu_torch vs lightgbm_tpu, on
the CPU)."""

import numpy as np
import pytest
import torch

import lightgbm_tpu as lgb
import lightgbm_tpu_torch as lgt
from lightgbm_tpu.binning import BinMapper as JaxBinMapper
from lightgbm_tpu_torch import convert
from lightgbm_tpu_torch.binning import BinMapper

@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread for these small tensors: the same results,
    and far less CPU time when several test workers share the host."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


CPU = {"device_type": "cpu"}


def _columns(rng, n=3000):
    normal = rng.normal(size=n)
    with_nan = rng.normal(size=n)
    with_nan[rng.rand(n) < 0.1] = np.nan
    zeros = np.where(rng.rand(n) < 0.3, 0.0, rng.exponential(size=n))
    mixed = np.where(rng.rand(n) < 0.5, -rng.exponential(size=n),
                     rng.exponential(size=n))
    mixed[rng.rand(n) < 0.2] = 0.0
    heavy = np.round(rng.normal(size=n), 1)          # < 256 distinct
    cat = rng.randint(0, 9, size=n).astype(float)
    return dict(normal=normal, with_nan=with_nan, zeros=zeros, mixed=mixed,
                heavy=heavy, cat=cat)


@pytest.mark.parametrize("max_bin", [16, 63, 255])
@pytest.mark.parametrize("column", ["normal", "with_nan", "zeros", "mixed",
                                    "heavy", "cat"])
def test_bin_mapper_bit_equal(rng, column, max_bin):
    v = _columns(rng)[column]
    kw = dict(max_bin=max_bin, min_data_in_bin=3,
              bin_type="categorical" if column == "cat" else "numerical")
    want = JaxBinMapper.from_values(v, **kw)
    got = BinMapper.from_values(v, **kw)
    for a, b in zip(got.state_arrays(), want.state_arrays()):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(got.values_to_bins(v),
                                  want.values_to_bins(v))


def test_binned_matrix_bit_equal(rng):
    cols = _columns(rng, n=5000)
    X = np.stack([cols[k] for k in ("normal", "with_nan", "zeros", "mixed",
                                    "heavy")], axis=1)
    y = (rng.rand(len(X)) < 0.5).astype(float)
    params = {"max_bin": 31, "bin_construct_sample_cnt": 2000}
    jds = lgb.Dataset(X, label=y, params=params).construct()
    tds = lgt.Dataset(X, label=y, params={**params, **CPU}).construct()
    np.testing.assert_array_equal(tds.bins.numpy(), jds.bins)
    np.testing.assert_array_equal(tds.used_features, jds.used_features)
    # mappers carried over from the JAX package bin identically too
    cds = lgt.Dataset(X, label=y, params={**params, **CPU},
                      bin_mappers=convert.bin_mappers_from_state(
                          m.state_arrays() for m in jds.bin_mappers)) \
        .construct()
    np.testing.assert_array_equal(cds.bins.numpy(), jds.bins)
    # a valid set against the train set reuses its mappers
    vds = lgt.Dataset(X[:500], label=y[:500], reference=tds).construct()
    np.testing.assert_array_equal(vds.bins.numpy(), jds.bins[:500])


def test_bundling_data_raises(rng):
    """Data the JAX package bundles is bundled bit-equally by the port
    (EFB is ported); so is a plan of more than 256 bins a bundle, which
    the JAX package stores as int32 columns and the port as int16 ones
    of the same values (the port refused such plans before its kernels
    read wide columns; the name is kept)."""
    n, F = 2000, 8
    X = np.zeros((n, F))
    for f in range(F):          # mutually exclusive sparse columns
        rows = np.arange(f, n, F)
        X[rows, f] = rng.normal(size=len(rows))
    y = (rng.rand(n) < 0.5).astype(float)
    jds = lgb.Dataset(X, label=y).construct()
    assert jds.bundle_plan is not None
    tds = lgt.Dataset(X, label=y, params=CPU).construct()
    assert tds.bundle_plan.num_bundles == jds.bundle_plan.num_bundles
    np.testing.assert_array_equal(tds.bins.numpy(), jds.bins)
    wide = {"max_bundle_bins": 512, "max_bin": 63}
    jw = lgb.Dataset(X, label=y, params=wide).construct()
    assert jw.bundle_plan.max_bundle_bins > 256
    tw = lgt.Dataset(X, label=y, params={**CPU, **wide}).construct()
    assert tw.bundle_plan.max_bundle_bins == jw.bundle_plan.max_bundle_bins
    assert tw.bins.dtype == torch.int16
    np.testing.assert_array_equal(tw.bins.numpy(), jw.bins)
    np.testing.assert_array_equal(tw.unbundled_bins(), jw.unbundled_bins())
    lgt.Dataset(X, label=y, params={**CPU, **wide, "enable_bundle": False}) \
        .construct()


def _train_pair(rng):
    X = rng.normal(size=(1500, 6))
    y = (X[:, 0] + 0.5 * X[:, 1] ** 2 + rng.normal(scale=0.3, size=1500)
         > 0.5).astype(float)
    params = {"objective": "binary", "num_leaves": 7, "max_bin": 16,
              "verbosity": -1}
    jb = lgb.train({**params, "tree_learner": "serial",
                    "hist_impl": "scatter"}, lgb.Dataset(X, label=y), 3)
    tb = lgt.train({**params, **CPU}, lgt.Dataset(X, label=y), 3)
    return X, jb, tb


def test_model_text_round_trip_byte_equal(rng):
    X, jb, tb = _train_pair(rng)
    s_jax = jb.model_to_string()
    # the JAX package's model loads into the port and writes back the
    # same bytes the JAX package writes for it
    via_port = convert.booster_from_model_string(s_jax)
    via_jax = lgb.Booster(model_str=s_jax)
    assert via_port.model_to_string() == via_jax.model_to_string()
    # the port's own text survives load -> save unchanged
    s_port = tb.model_to_string()
    again = lgt.Booster(model_str=s_port).model_to_string()
    assert lgt.Booster(model_str=again).model_to_string() == again
    # tree blocks are byte-equal between the packages
    assert s_port.split("end of trees")[0].split("Tree=0")[1] == \
        s_jax.split("end of trees")[0].split("Tree=0")[1]
