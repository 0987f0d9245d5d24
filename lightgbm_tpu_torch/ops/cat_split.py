"""Sorted-subset categorical split search, in plain PyTorch.

Port of ``lightgbm_tpu/ops/cat_split.py:39`` (the reference's
``feature_histogram.cpp:239-360`` FindBestThresholdCategoricalInner,
sorted-subset branch). Per (leaf slot, feature) of the features in
``cat_sorted_mask``:

- candidate bins: enough data (count >= ``cat_smooth``) inside the
  feature's range;
- the CTR sort: candidates ascending by g / (h + ``cat_smooth``),
  non-candidates last. ``jnp.argsort`` is stable, so this is a stable
  ``torch.sort`` on the same key: categories with equal ratios keep
  their bin order in both packages;
- subset sums as prefix sums over the sorted order, from the low end
  and from the high end (total minus a shifted prefix);
- the reference's ``cnt_cur_group`` rule: a subset counts only once it
  adds at least ``min_data_per_group`` rows since the last counted one,
  and the scan stops for good where the right side fails its minimums.
  The reset makes it serial: a Python loop over the positions, bounded
  by ``max_sorted_bins``; the stop is a cumulative OR;
- gains with ``cat_l2`` added to ``lambda_l2`` (the parent gain ``pg``
  is the lattice's, plain l2), up to ``max_cat_threshold`` categories.

The winner's subset comes back as a bin-space mask [L, B] for the tree's
bitset. Every op matches the JAX function's in order and dtype.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from .split import NEG_INF, SplitParams, calc_output, gain_given_output

__all__ = ["find_best_cat_sorted"]


def find_best_cat_sorted(hist: torch.Tensor, num_bins_per_feat: torch.Tensor,
                         cat_sorted_mask: torch.Tensor, params: SplitParams,
                         pg: torch.Tensor,
                         feature_mask: Optional[torch.Tensor] = None,
                         leaf_lo: Optional[torch.Tensor] = None,
                         leaf_hi: Optional[torch.Tensor] = None,
                         parent_output: Optional[torch.Tensor] = None,
                         max_sorted_bins: Optional[int] = None,
                         rand_bin: Optional[torch.Tensor] = None
                         ) -> Dict[str, torch.Tensor]:
    """Best sorted-subset categorical split per leaf slot.

    hist [L, F, B, 3] f32; num_bins_per_feat and cat_sorted_mask [F] or
    [L, F]; pg [L, F] the parent gain of the main lattice;
    feature_mask [F] or [L, F]; leaf_lo/leaf_hi [L] monotone bounds
    (outputs are clamped); parent_output [L] for path smoothing;
    ``max_sorted_bins`` (host int, default B) bounds the serial scan:
    no position at or past it can hold a candidate; ``rand_bin`` [L, F]
    (extra-trees) keeps one subset size per feature, taken modulo the
    feature's largest (cat_split.py:183-185).

    Returns gain [L] (net; -inf if none), feature [L], left_sum /
    right_sum [L, 3], left_out / right_out [L] and member [L, B] (the
    bins that go left).
    """
    L, F, B, _ = hist.shape
    dev = hist.device
    f32 = torch.float32
    l1 = params.lambda_l1
    l2c = params.lambda_l2 + params.cat_l2
    mds = params.max_delta_step
    mdl = params.min_data_in_leaf
    msh = params.min_sum_hessian_in_leaf
    mdpg = params.min_data_per_group
    iota = torch.arange(B, dtype=torch.int32, device=dev)

    g, h, n = hist[..., 0], hist[..., 1], hist[..., 2]
    nb2 = num_bins_per_feat if num_bins_per_feat.dim() == 2 \
        else num_bins_per_feat[None, :]
    cs2 = cat_sorted_mask if cat_sorted_mask.dim() == 2 \
        else cat_sorted_mask[None, :]
    cand = ((n >= params.cat_smooth) & (iota[None, None, :] < nb2[:, :, None])
            & cs2[:, :, None].to(torch.bool))                    # [L, F, B]
    used_bin = cand.sum(dim=2, dtype=torch.int32)                # [L, F]

    # CTR sort ascending, non-candidates last; stable, as jnp.argsort
    ctr = g / (h + params.cat_smooth)
    key = torch.where(cand, ctr, float("inf"))
    order = torch.sort(key, dim=2, stable=True).indices          # pos -> bin
    inv = torch.empty_like(order).scatter_(
        2, order, torch.arange(B, device=dev).expand(L, F, B))   # bin -> pos

    def by_pos(a):
        return torch.gather(torch.where(cand, a, 0.0), 2, order)

    P_g = torch.cumsum(by_pos(g), dim=2)
    P_h = torch.cumsum(by_pos(h), dim=2)
    P_n = torch.cumsum(by_pos(n), dim=2)
    # totals over ALL bins of the feature: subsets split the whole leaf
    tot = hist.sum(dim=2)                                        # [L, F, 3]
    T_g, T_h, T_n = tot[..., 0], tot[..., 1], tot[..., 2]

    # position i takes i+1 bins from the low end (direction 0) or the
    # high end of the candidate order (direction 1)
    iexp = iota.long()[None, None, :].expand(L, F, B)
    lo_sums = (P_g, P_h, P_n)
    j = used_bin.long()[:, :, None] - 2 - iexp                   # prefix end
    jc = j.clamp(0, B - 1)
    ub1 = (used_bin.long()[:, :, None] - 1).clamp(0, B - 1)
    hi_sums = tuple(
        torch.gather(P, 2, ub1) - torch.where(j >= 0, torch.gather(P, 2, jc),
                                              0.0)
        for P in (P_g, P_h, P_n))
    lg, lh, lc = (torch.stack([a, b], dim=3)
                  for a, b in zip(lo_sums, hi_sums))             # [L,F,B,2]
    rg = T_g[:, :, None, None] - lg
    rh = T_h[:, :, None, None] - lh
    rc = T_n[:, :, None, None] - lc

    # -- the cnt_cur_group rule (feature_histogram.cpp:276-316)
    max_num_cat = torch.clamp(
        torch.div(used_bin + 1, 2, rounding_mode="floor"),
        max=params.max_cat_threshold)                            # [L, F]
    i4 = iexp[..., None]
    in_range = ((i4 < used_bin[:, :, None, None])
                & (i4 < max_num_cat[:, :, None, None]))
    left_ok = (lc >= mdl) & (lh >= msh)
    right_fail = (rc < mdl) | (rc < mdpg) | (rh < msh)
    # the scan's stop flag is sticky: a cumulative OR over positions
    broken = torch.cummax((right_fail & in_range).to(torch.int32),
                          dim=2).values.to(torch.bool)
    ok = (left_ok & in_range & ~broken).permute(3, 0, 1, 2)      # [2,L,F,B]
    lc2 = lc.permute(3, 0, 1, 2)
    steps = lc2 - torch.nn.functional.pad(lc2[..., :B - 1], (1, 0))
    elig = torch.zeros((2, L, F, B), dtype=torch.bool, device=dev)
    cnt_cur = torch.zeros((2, L, F), dtype=f32, device=dev)
    for i in range(min(B, max_sorted_bins or B)):
        cnt_cur = cnt_cur + steps[..., i]
        e = ok[..., i] & (cnt_cur >= mdpg)
        cnt_cur = torch.where(e, 0.0, cnt_cur)
        elig[..., i] = e
    elig = elig.permute(1, 2, 3, 0)                              # [L,F,B,2]
    if rand_bin is not None:     # extra_trees: one subset size a feature
        rpos = torch.remainder(rand_bin, max_num_cat.clamp(min=1))
        elig = elig & (i4 == rpos[:, :, None, None].long())

    # -- gains (output-based, cat_l2-regularised)
    sm_l, sm_r = {}, {}
    if params.path_smooth > 0.0:
        po = parent_output[:, None, None, None]
        sm_l = dict(path_smooth=params.path_smooth, count=lc,
                    parent_output=po)
        sm_r = dict(path_smooth=params.path_smooth, count=rc,
                    parent_output=po)
    out_l = calc_output(lg, lh, l1, l2c, mds, **sm_l)
    out_r = calc_output(rg, rh, l1, l2c, mds, **sm_r)
    if leaf_lo is not None:
        lo = leaf_lo[:, None, None, None]
        hi = leaf_hi[:, None, None, None]
        out_l = torch.minimum(torch.maximum(out_l, lo), hi)
        out_r = torch.minimum(torch.maximum(out_r, lo), hi)
    gain = (gain_given_output(lg, lh, l1, l2c, out_l)
            + gain_given_output(rg, rh, l1, l2c, out_r))
    net = gain - pg[:, :, None, None] - params.min_gain_to_split
    net = torch.where(elig & (net > 1e-10), net, NEG_INF)
    if feature_mask is not None:
        fm = feature_mask if feature_mask.dim() == 2 else feature_mask[None]
        net = torch.where(fm[:, :, None, None].to(torch.bool), net, NEG_INF)

    # -- first maximum over (F, B, 2)
    flat = net.reshape(L, F * B * 2)
    best = torch.argmax(flat, dim=1)
    best_gain = torch.gather(flat, 1, best[:, None])[:, 0]
    feat = torch.div(best, B * 2, rounding_mode="floor")
    pos = torch.div(best, 2, rounding_mode="floor") % B
    dir_hi = best % 2

    def take(a):
        return torch.gather(a.reshape(L, F * B * 2), 1, best[:, None])[:, 0]

    l_sum = torch.stack([take(lg), take(lh), take(lc)], dim=1)
    r_sum = torch.stack([take(rg), take(rh), take(rc)], dim=1)

    # -- the winning subset as a bin-space membership mask
    fsel = feat[:, None, None].expand(L, 1, B)
    inv_f = torch.gather(inv, 1, fsel)[:, 0]                     # [L, B]
    cand_f = torch.gather(cand, 1, fsel)[:, 0]
    ub_f = torch.gather(used_bin, 1, feat[:, None])[:, 0].long()
    member_lo = inv_f <= pos[:, None]
    member_hi = inv_f >= (ub_f[:, None] - 1 - pos[:, None])
    member = cand_f & torch.where(dir_hi[:, None] == 1, member_hi, member_lo)
    member = member & torch.isfinite(best_gain)[:, None]
    return {"gain": best_gain, "feature": feat.to(torch.int32),
            "left_sum": l_sum, "right_sum": r_sum,
            "left_out": take(out_l), "right_out": take(out_r),
            "member": member}
