"""PyTorch port: the plain version of kernel B2 (histogram + split search,
lightgbm_tpu_torch/ops/cuda_histogram.py) against the JAX package's
fused Pallas kernel in interpret mode, for the plain, monotone +
path-smoothing and int8-quantized configurations, with and without the
emitted histogram. Winner fields are equal; floats within rtol/atol
3e-6 (_assert_parity of tests/test_fused_split.py); histograms within
rtol 1e-5 (exact for int8)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lightgbm_tpu.ops import pallas_histogram as PH
from lightgbm_tpu.ops import split as JS
from lightgbm_tpu_torch.ops import cuda_histogram as CH
from lightgbm_tpu_torch.ops import split as TS

R, F, B, L = 512, 8, 16, 6


def _stream(rng, quant=False):
    bins = rng.randint(0, B - 1, size=(R, F)).astype(np.uint8)
    bins[rng.rand(R) < 0.1, 2] = B - 1            # NaN bin rows (feat 2)
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


@pytest.mark.parametrize("emit_hist", [True, False])
@pytest.mark.parametrize("config", ["plain", "mono_smooth", "quant"])
def test_plain_fused_matches_pallas_interpret(rng, config, emit_hist):
    quant = config == "quant"
    bins, gh, rl, lids = _stream(rng, quant)
    extra = ({"path_smooth": 2.0, "monotone_penalty": 0.5}
             if config == "mono_smooth" else {})
    sp = dict(min_data_in_leaf=5, min_sum_hessian_in_leaf=1e-3, **extra)
    ops = dict(META, feature_mask=np.ones((F,), bool))
    if config == "mono_smooth":
        mono = np.zeros(F, np.int32)
        mono[0], mono[3] = 1, -1
        depth = rng.randint(1, 4, size=L).astype(np.int32)
        ops.update(mono_type=mono,
                   leaf_lo=np.full((L,), -2.0, np.float32),
                   leaf_hi=np.full((L,), 2.0, np.float32),
                   parent_output=rng.normal(size=L).astype(np.float32),
                   mono_pen=np.asarray(JS.monotone_penalty_factor(
                       jnp.asarray(depth), 0.5)))
    if quant:
        ops["quant_scales"] = np.asarray([0.25, 0.5], np.float32)
    want, whist = PH.fused_build_best_splits(
        jnp.asarray(bins), jnp.asarray(gh), jnp.asarray(rl),
        jnp.asarray(lids), num_bins=B, params=JS.SplitParams(**sp),
        hist_dtype="float32", emit_hist=emit_hist, interpret=True,
        **{k: jnp.asarray(v) for k, v in ops.items()})
    got, ghist = CH.fused_build_best_splits(
        *(torch.from_numpy(a) for a in (bins, gh, rl, lids)), num_bins=B,
        params=TS.SplitParams(**sp), hist_dtype="float32",
        emit_hist=emit_hist,
        **{k: torch.from_numpy(np.array(v)) for k, v in ops.items()})
    assert set(got) == set(want)
    for k in want:
        a, b = got[k].numpy(), np.asarray(want[k])
        if b.dtype.kind == "f":
            np.testing.assert_allclose(a, b, rtol=3e-6, atol=3e-6,
                                       err_msg=f"field {k!r} ({config})")
        else:
            np.testing.assert_array_equal(a.astype(b.dtype), b,
                                          err_msg=f"field {k!r} ({config})")
    assert np.isfinite(np.asarray(want["gain"])).any()
    if emit_hist:
        if quant:
            np.testing.assert_array_equal(ghist.numpy(), np.asarray(whist))
        else:
            np.testing.assert_allclose(ghist.numpy(), np.asarray(whist),
                                       rtol=1e-5, atol=1e-5)
    else:
        assert ghist is None and whist is None


def test_plain_fused_compacted_stream(rng):
    """row_gather + num_rows (the builder's child call) equals the same
    search over the materialised, truncated stream."""
    bins, gh, rl, lids = _stream(rng)
    perm = rng.permutation(R).astype(np.int32)
    n = R // 3
    rl_c = np.where(np.arange(R) < n, rl[perm], -1).astype(np.int32)
    gh_c = gh[perm]
    sp = TS.SplitParams(min_data_in_leaf=3)
    meta = {k: torch.from_numpy(v) for k, v in META.items()}
    a, ha = CH.fused_build_best_splits(
        torch.from_numpy(bins), torch.from_numpy(gh_c),
        torch.from_numpy(rl_c), torch.from_numpy(lids), num_bins=B,
        params=sp, row_gather=torch.from_numpy(perm),
        num_rows=torch.tensor(n, dtype=torch.int32), emit_hist=True, **meta)
    b, hb = CH.fused_build_best_splits(
        torch.from_numpy(bins[perm[:n]]), torch.from_numpy(gh_c[:n]),
        torch.from_numpy(rl_c[:n]), torch.from_numpy(lids), num_bins=B,
        params=sp, emit_hist=True, **meta)
    np.testing.assert_array_equal(ha.numpy(), hb.numpy())
    for k in a:
        np.testing.assert_array_equal(a[k].numpy(), b[k].numpy())
