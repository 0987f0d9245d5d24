"""PyTorch port: find_best_splits / eval_split_lattice against the JAX
package's on the tests/test_fused_split.py stream shapes, in the plain,
monotone + path-smoothing and int8-quantized configurations. Integer and
bool fields are equal; float fields match within rtol/atol 3e-6 (the
documented f32 contraction variance of _assert_parity)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lightgbm_tpu.ops import histogram as JH
from lightgbm_tpu.ops import split as JS
from lightgbm_tpu_torch.ops import split as TS

R, F, B, L = 512, 8, 16, 6


def _stream(rng, quant=False):
    """The _stream of test_fused_split.py: a NaN bin on feature 2, a
    one-hot categorical feature 5, dead rows, int8 grid values."""
    bins = rng.randint(0, B - 1, size=(R, F)).astype(np.uint8)
    bins[rng.rand(R) < 0.1, 2] = B - 1
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
            is_cat_pf=np.arange(F) == 5)


def _case(rng, config):
    """(histogram, SplitParams, per-slot operands) for one config."""
    quant = config == "quant"
    bins, gh, rl, lids = _stream(rng, quant)
    hist = np.array(JH.build_histograms(
        jnp.asarray(bins), jnp.asarray(gh), jnp.asarray(rl),
        jnp.asarray(lids), num_bins=B, impl="scatter",
        hist_dtype="float32"))
    extra = ({"path_smooth": 2.0, "monotone_penalty": 0.5}
             if config == "mono_smooth" else {})
    sp = dict(min_data_in_leaf=5, min_sum_hessian_in_leaf=1e-3, **extra)
    ops = dict(feature_mask=np.ones((L, F), bool))
    if config == "mono_smooth":
        mono = np.zeros(F, np.int32)
        mono[0], mono[3] = 1, -1
        ops.update(mono_type=mono,
                   leaf_lo=np.full((L,), -2.0, np.float32),
                   leaf_hi=np.full((L,), 2.0, np.float32),
                   parent_output=rng.normal(size=L).astype(np.float32),
                   slot_depth=rng.randint(1, 4, size=L).astype(np.int32))
    if quant:
        ops["quant_scales"] = np.asarray([0.25, 0.5], np.float32)
    return hist, sp, ops


def assert_parity(got, want, keys=None):
    for k in keys or want:
        a = got[k].numpy() if isinstance(got[k], torch.Tensor) else got[k]
        b = np.asarray(want[k])
        if b.dtype.kind == "f":
            np.testing.assert_allclose(a, b, rtol=3e-6, atol=3e-6,
                                       err_msg=f"field {k!r}")
        else:
            np.testing.assert_array_equal(a.astype(b.dtype), b,
                                          err_msg=f"field {k!r}")


@pytest.mark.parametrize("config", ["plain", "mono_smooth", "quant"])
def test_find_best_splits_matches_jax(rng, config):
    hist, sp, ops = _case(rng, config)
    want = jax.jit(lambda h: JS.find_best_splits(
        h, *(jnp.asarray(META[k]) for k in ("num_bins_pf", "nan_bin_pf",
                                            "is_cat_pf")),
        JS.SplitParams(**sp),
        **{k: jnp.asarray(v) for k, v in ops.items()}))(jnp.asarray(hist))
    got = TS.find_best_splits(
        torch.from_numpy(hist),
        *(torch.from_numpy(META[k]) for k in ("num_bins_pf", "nan_bin_pf",
                                              "is_cat_pf")),
        TS.SplitParams(**sp),
        **{k: torch.from_numpy(v) for k, v in ops.items()})
    assert_parity(got, want)
    assert np.isfinite(np.asarray(want["gain"])).any()


@pytest.mark.parametrize("config", ["plain", "mono_smooth", "quant"])
def test_eval_split_lattice_matches_jax(rng, config):
    hist, sp, ops = _case(rng, config)
    depth = ops.pop("slot_depth", None)
    if depth is not None:
        ops["mono_pen"] = np.asarray(JS.monotone_penalty_factor(
            jnp.asarray(depth), sp["monotone_penalty"]))
    want = JS.eval_split_lattice(
        jnp.asarray(hist), *(jnp.asarray(META[k]) for k in
                             ("num_bins_pf", "nan_bin_pf", "is_cat_pf")),
        JS.SplitParams(**sp), **{k: jnp.asarray(v) for k, v in ops.items()})
    got = TS.eval_split_lattice(
        torch.from_numpy(hist), *(torch.from_numpy(META[k]) for k in
                                  ("num_bins_pf", "nan_bin_pf", "is_cat_pf")),
        TS.SplitParams(**sp),
        **{k: torch.from_numpy(v) for k, v in ops.items()})
    net_w, net_g = np.asarray(want["net"]), got["net"].numpy()
    np.testing.assert_array_equal(np.isfinite(net_g), np.isfinite(net_w))
    fin = np.isfinite(net_w)
    # right = totals - left cancels: differences are measured against
    # the lattice's scale, not element by element
    for k in ("net", "left", "right", "totals", "pg"):
        a, b = got[k].numpy(), np.asarray(want[k])
        if k == "net":
            a, b = a[fin], b[fin]
        np.testing.assert_allclose(a, b, rtol=3e-6,
                                   atol=3e-6 * max(1.0, np.abs(b).max()),
                                   err_msg=f"field {k!r}")


def test_leaf_math_matches_jax(rng):
    g = rng.normal(size=64).astype(np.float32)
    h = np.abs(rng.normal(size=64)).astype(np.float32)
    n = rng.randint(1, 50, size=64).astype(np.float32)
    po = rng.normal(size=64).astype(np.float32)
    tg, th, tn, tp = (torch.from_numpy(a) for a in (g, h, n, po))
    for l1, l2, mds, ps in ((0.0, 0.0, 0.0, 0.0), (0.5, 1.0, 0.3, 2.0)):
        want = JS.calc_output(jnp.asarray(g), jnp.asarray(h), l1, l2, mds, ps,
                              jnp.asarray(n), jnp.asarray(po))
        got = TS.calc_output(tg, th, l1, l2, mds, ps, tn, tp)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)
        np.testing.assert_allclose(
            TS.leaf_gain(tg, th, l1, l2).numpy(),
            np.asarray(JS.leaf_gain(jnp.asarray(g), jnp.asarray(h), l1, l2)),
            rtol=1e-6)
    depth = np.arange(6, dtype=np.int32)
    for pen in (0.3, 1.0, 2.5):
        np.testing.assert_allclose(
            TS.monotone_penalty_factor(torch.from_numpy(depth), pen).numpy(),
            np.asarray(JS.monotone_penalty_factor(jnp.asarray(depth), pen)),
            rtol=1e-6)
    member = rng.rand(5, 70) < 0.3
    np.testing.assert_array_equal(
        TS.pack_member_bitset(torch.from_numpy(member)).numpy(),
        np.asarray(JS.pack_member_bitset(jnp.asarray(member)))
        .astype(np.int64))


def test_unported_operands_raise(rng):
    """The voting-parallel learner's operand is not ported."""
    hist, sp, _ = _case(rng, "plain")
    with pytest.raises(NotImplementedError):
        TS.find_best_splits(torch.from_numpy(hist),
                            *(torch.from_numpy(META[k]) for k in
                              ("num_bins_pf", "nan_bin_pf", "is_cat_pf")),
                            TS.SplitParams(**sp), return_feature_gain=True)


def _option_operands(rng, names):
    ops = {}
    if "rand_bin" in names:
        ops["rand_bin"] = rng.randint(0, B - 2, size=(L, F)).astype(np.int32)
    if "gain_scale" in names:
        ops["gain_scale"] = rng.uniform(0.3, 1.0, size=F).astype(np.float32)
    if "gain_penalty" in names:
        ops["gain_penalty"] = rng.uniform(0.0, 0.5, size=(L, F)).astype(
            np.float32)
    if "adv_bounds" in names:
        lo = -rng.uniform(0.0, 0.3, size=(2, L, F, B)).astype(np.float32)
        hi = rng.uniform(0.0, 0.3, size=(2, L, F, B)).astype(np.float32)
        ops["adv_bounds"] = (lo[0], hi[0], lo[1], hi[1])
    return ops


@pytest.mark.parametrize("names,config", [
    (("rand_bin",), "plain"), (("gain_scale", "gain_penalty"), "plain"),
    (("rand_bin", "gain_scale"), "quant"), (("adv_bounds",), "mono_smooth"),
])
def test_option_operands_match_jax(rng, names, config):
    """The builder options' lattice operands (extra-trees thresholds,
    feature_contri scales, CEGB penalties, advanced monotone bounds)
    against the JAX package's find_best_splits."""
    hist, sp, ops = _case(rng, config)
    extra = _option_operands(rng, names)
    meta = ("num_bins_pf", "nan_bin_pf", "is_cat_pf")

    def conv(v, f):
        return tuple(map(f, v)) if isinstance(v, tuple) else f(v)
    want = JS.find_best_splits(
        jnp.asarray(hist), *(jnp.asarray(META[k]) for k in meta),
        JS.SplitParams(**sp),
        **{k: conv(v, jnp.asarray) for k, v in {**ops, **extra}.items()})
    got = TS.find_best_splits(
        torch.from_numpy(hist), *(torch.from_numpy(META[k]) for k in meta),
        TS.SplitParams(**sp),
        **{k: conv(v, torch.from_numpy) for k, v in {**ops, **extra}.items()})
    assert_parity(got, want)
    assert np.isfinite(np.asarray(want["gain"])).any()
