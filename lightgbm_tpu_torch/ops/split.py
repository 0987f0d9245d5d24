"""Best-split search over histograms, in plain PyTorch.

Port of ``lightgbm_tpu/ops/split.py`` (the reference's
``feature_histogram.hpp:165`` ``FindBestThreshold``): for each (leaf,
feature) scan every bin threshold in both missing-direction variants
over a dense ``[leaves, features, bins, 2]`` lattice and keep the
first maximum. The gain math is the JAX module's term for term (see its
docstring): regularised outputs, ``max_delta_step`` clip, path
smoothing, basic monotone clamp, direction-violation zeroing and depth
penalty, NaN bins, one-hot categoricals, and int8 ``quant_scales``
scanned exactly in int32. Categorical features in ``cat_sorted_mask``
(more than ``max_cat_to_onehot`` bins) leave the one-hot lattice for the
sorted-subset search (``ops/cat_split.py``), whose winners merge into
the per-slot best.

The builder options' operands (split.py:136-338): extra-trees
thresholds (``rand_bin``, one bin per slot and feature), feature_contri
scales (``gain_scale``), CEGB penalties (``gain_penalty``) and advanced
monotone bounds (``adv_bounds``, per-threshold output bounds that
replace the per-slot clip). Per-node sampling and interaction
constraints arrive in a per-slot [L, F] ``feature_mask``.

This lattice is also the plain version of the fused kernel's epilogue
(``ops/cuda_histogram.py``), which takes none of those four operands:
the builder sends such runs to the two-pass arm. An operand of the JAX
package that the port has not reached (the voting-parallel
``return_feature_gain``) raises.

Bitsets are int64 tensors holding uint32 words (torch has few uint32
ops); the values are those of the JAX package's uint32 words.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional

import torch

__all__ = ["SplitParams", "find_best_splits", "leaf_output", "leaf_gain",
           "gain_given_output", "calc_output", "monotone_penalty_factor",
           "eval_split_lattice", "pack_member_bitset", "NEG_INF"]

NEG_INF = float("-inf")
K_EPS = 1e-15


class SplitParams(NamedTuple):
    lambda_l1: float = 0.0
    lambda_l2: float = 0.0
    min_data_in_leaf: float = 20.0
    min_sum_hessian_in_leaf: float = 1e-3
    min_gain_to_split: float = 0.0
    cat_l2: float = 10.0
    cat_smooth: float = 10.0
    max_delta_step: float = 0.0
    path_smooth: float = 0.0
    monotone_penalty: float = 0.0
    extra_trees: bool = False
    max_cat_threshold: int = 32
    max_cat_to_onehot: int = 4
    min_data_per_group: float = 100.0


def _threshold_l1(s, l1):
    if l1 <= 0.0:
        return s
    return torch.sign(s) * torch.clamp(s.abs() - l1, min=0.0)


def leaf_gain(g, h, l1, l2):
    t = _threshold_l1(g, l1)
    return torch.where(h + l2 > 0, t * t / (h + l2), 0.0)


def leaf_output(g, h, l1, l2, max_delta_step=0.0):
    out = torch.where(h + l2 > 0, -_threshold_l1(g, l1) / (h + l2), 0.0)
    if max_delta_step > 0.0:
        out = torch.clamp(out, -max_delta_step, max_delta_step)
    return out


def calc_output(g, h, l1, l2, max_delta_step=0.0, path_smooth=0.0,
                count=None, parent_output=None):
    """CalculateSplittedLeafOutput (feature_histogram.hpp:717-740)."""
    out = leaf_output(g, h, l1, l2, max_delta_step)
    if path_smooth > 0.0:
        sm = count / path_smooth
        out = out * sm / (sm + 1.0) + parent_output / (sm + 1.0)
    return out


def gain_given_output(g, h, l1, l2, out):
    """GetLeafGainGivenOutput (feature_histogram.hpp:820-831)."""
    t = _threshold_l1(g, l1)
    return -(2.0 * t * out + (h + l2) * out * out)


def monotone_penalty_factor(depth, penalization):
    """ComputeMonotoneSplitGainPenalty (monotone_constraints.hpp:357)."""
    depth = depth.to(torch.float32)
    pen_le1 = 1.0 - penalization / torch.exp2(depth) + K_EPS
    pen_gt1 = 1.0 - torch.exp2(penalization - 1.0 - depth) + K_EPS
    pen = pen_le1 if penalization <= 1.0 else pen_gt1
    return torch.where(penalization >= depth + 1.0, K_EPS, pen)


def pack_member_bitset(member: torch.Tensor) -> torch.Tensor:
    """[L, B] bool membership -> [L, ceil(B/32)] uint32 words (held in
    int64), the tree.h categorical bitset layout."""
    L, B = member.shape
    BW = (B + 31) // 32
    pad = BW * 32 - B
    m = torch.nn.functional.pad(member.to(torch.int64), (0, pad))
    weights = torch.bitwise_left_shift(
        torch.ones(32, dtype=torch.int64, device=member.device),
        torch.arange(32, device=member.device))
    return (m.reshape(L, BW, 32) * weights).sum(dim=2)


def _reject(unsupported):
    """The JAX lattice's operands this port has not reached (the
    parallel learners' ``return_feature_gain``)."""
    bad = [k for k, v in unsupported.items() if v is not None]
    if bad:
        raise NotImplementedError(
            f"split operands not ported yet: {bad} (ROADMAP A)")


def _2d(a):
    return a if a is None or a.dim() == 2 else a[None, :]


def _sum(x, dim):
    """Sum keeping the input dtype (torch widens int32 to int64)."""
    return x.sum(dim=dim, dtype=x.dtype)


def eval_split_lattice(hist: torch.Tensor, num_bins_per_feat, nan_bin,
                       is_cat, params: SplitParams,
                       feature_mask: Optional[torch.Tensor] = None,
                       mono_type: Optional[torch.Tensor] = None,
                       leaf_lo: Optional[torch.Tensor] = None,
                       leaf_hi: Optional[torch.Tensor] = None,
                       parent_output: Optional[torch.Tensor] = None,
                       mono_pen: Optional[torch.Tensor] = None,
                       quant_scales: Optional[torch.Tensor] = None,
                       cat_sorted_mask: Optional[torch.Tensor] = None,
                       rand_bin: Optional[torch.Tensor] = None,
                       gain_scale: Optional[torch.Tensor] = None,
                       gain_penalty: Optional[torch.Tensor] = None,
                       adv_bounds: Optional[tuple] = None,
                       **unsupported) -> Dict[str, torch.Tensor]:
    """Dense gain lattice (split.py:136): everything up to the argmax.

    hist [L, F, B, 3] f32, or raw int32 sums with ``quant_scales`` [2]
    or per-slot [L, 2] (g_scale, h_scale). Per-feature metadata is [F]
    or per-slot [L, F]. Features in ``cat_sorted_mask`` have no valid
    cell here (the one-hot branch excludes them). ``rand_bin`` [L, F]
    leaves one threshold per (slot, feature); ``gain_scale`` [F] or
    [L, F] multiplies and ``gain_penalty`` [L, F] then lowers each
    feature's net gain; ``adv_bounds`` = (lo_l, hi_l, lo_r, hi_r), each
    [L, F, B], clip the children's outputs per threshold in place of
    ``leaf_lo``/``leaf_hi``.
    Returns net [L, F, B, 2] (-inf where invalid), left/right
    [L, F, B, 2, 3], out_l/out_r [L, F, B, 2], pg [L, F], totals
    [L, F, 3] and is_cat2 [M, F].
    """
    _reject(unsupported)
    L, F, B, _ = hist.shape
    dev = hist.device
    l1, l2 = params.lambda_l1, params.lambda_l2
    mds = params.max_delta_step
    use_mono = mono_type is not None
    use_smooth = params.path_smooth > 0.0
    bins_iota = torch.arange(B, dtype=torch.int32, device=dev)

    nbpf = _2d(num_bins_per_feat).to(torch.int32)
    nan2 = _2d(nan_bin).to(torch.int32)
    cat2 = _2d(is_cat).to(torch.bool)
    mono2 = _2d(mono_type) if use_mono else None

    has_nan = nan2 >= 0
    nan_mask = ((bins_iota[None, None, :] == nan2[:, :, None])
                & has_nan[:, :, None])                         # [M, F, B]
    zero = torch.zeros((), dtype=hist.dtype, device=dev)
    hist_nonan = torch.where(nan_mask[:, :, :, None], zero, hist)
    nan_sum = _sum(hist * nan_mask[:, :, :, None].to(hist.dtype), 2)

    totals = _sum(hist_nonan, 2) + nan_sum                     # [L, F, 3]
    cum = torch.cumsum(hist_nonan, dim=2, dtype=hist.dtype)

    # option 0: missing right; option 1: missing left
    num_left = torch.stack([cum, cum + nan_sum[:, :, None, :]], dim=3)
    tot = totals[:, :, None, :]
    num_right = tot[:, :, :, None, :] - num_left

    nnb = nbpf - has_nan.to(torch.int32)
    t_valid = bins_iota[None, None, :] < (nnb[:, :, None] - 1)
    opt_valid = torch.stack([torch.ones_like(has_nan), has_nan], dim=-1)
    num_valid = (t_valid[:, :, :, None] & opt_valid[:, :, None, :]
                 & (~cat2)[:, :, None, None])                  # [M,F,B,2]

    # one-hot categorical: left = {bin == t}, missing-right option only
    cat_left = hist[:, :, :, None, :]
    cat_right = tot[:, :, :, None, :] - cat_left
    # sorted-path features are excluded here (the reference picks ONE
    # path by bin count, not the best of both)
    onehot_f = (cat2 & ~_2d(cat_sorted_mask).to(torch.bool)
                if cat_sorted_mask is not None else cat2)
    cat_ok = ((bins_iota[None, None, :] < nnb[:, :, None])
              & onehot_f[:, :, None])
    opt0 = torch.arange(2, device=dev) == 0
    cat_valid = cat_ok[:, :, :, None] & opt0

    catsel = cat2[:, :, None, None, None]
    left = torch.where(catsel, cat_left, num_left)
    right = torch.where(catsel, cat_right, num_right)
    valid = torch.where(cat2[:, :, None, None], cat_valid, num_valid)
    if rand_bin is not None:     # extra_trees: one threshold a feature
        valid = valid & (bins_iota[None, None, :, None]
                         == rand_bin[:, :, None, None])

    if quant_scales is not None:
        # exact integer scan, grid-value rescale at gain time; the count
        # channel scales by 1 so min_data thresholds stay exact
        qs = quant_scales.to(torch.float32).reshape(-1, 2)
        qv = torch.cat([qs, torch.ones((qs.shape[0], 1),
                                       dtype=torch.float32, device=dev)],
                       1)                                      # [1|L, 3]
        left = left.to(torch.float32) * qv[:, None, None, None, :]
        right = right.to(torch.float32) * qv[:, None, None, None, :]
        totals = totals.to(torch.float32) * qv[:, None, :]

    gL, hL, nL = left[..., 0], left[..., 1], left[..., 2]
    gR, hR, nR = right[..., 0], right[..., 1], right[..., 2]

    sm_l, sm_r = {}, {}
    if use_smooth:
        po = parent_output[:, None, None, None]
        sm_l = dict(path_smooth=params.path_smooth, count=nL,
                    parent_output=po)
        sm_r = dict(path_smooth=params.path_smooth, count=nR,
                    parent_output=po)
    out_l = calc_output(gL, hL, l1, l2, mds, **sm_l)
    out_r = calc_output(gR, hR, l1, l2, mds, **sm_r)
    if adv_bounds is not None:
        a_lo_l, a_hi_l, a_lo_r, a_hi_r = adv_bounds
        out_l = torch.minimum(torch.maximum(out_l, a_lo_l[..., None]),
                              a_hi_l[..., None])
        out_r = torch.minimum(torch.maximum(out_r, a_lo_r[..., None]),
                              a_hi_r[..., None])
    elif use_mono:
        lo = leaf_lo[:, None, None, None]
        hi = leaf_hi[:, None, None, None]
        out_l = torch.minimum(torch.maximum(out_l, lo), hi)
        out_r = torch.minimum(torch.maximum(out_r, lo), hi)

    gain = (gain_given_output(gL, hL, l1, l2, out_l)
            + gain_given_output(gR, hR, l1, l2, out_r))
    if use_mono:
        mt = mono2[:, :, None, None]
        viol = (((mt > 0) & (out_l > out_r)) | ((mt < 0) & (out_l < out_r)))
        gain = torch.where(viol, 0.0, gain)

    md, mh = params.min_data_in_leaf, params.min_sum_hessian_in_leaf
    ok = valid & (nL >= md) & (nR >= md) & (hL >= mh) & (hR >= mh)

    g_tot, h_tot, n_tot = totals[..., 0], totals[..., 1], totals[..., 2]
    if use_smooth:
        p_out_num = calc_output(g_tot, h_tot, l1, l2, mds,
                                params.path_smooth, n_tot,
                                parent_output[:, None])
        p_out = torch.where(cat2, parent_output[:, None], p_out_num)
        pg = gain_given_output(g_tot, h_tot, l1, l2, p_out)
    elif mds > 0.0:
        p_out = calc_output(g_tot, h_tot, l1, l2, mds)
        pg = gain_given_output(g_tot, h_tot, l1, l2, p_out)
    else:
        pg = leaf_gain(g_tot, h_tot, l1, l2)

    net = gain - pg[:, :, None, None] - params.min_gain_to_split
    net = torch.where(ok & (net > 1e-10), net, NEG_INF)

    if use_mono and params.monotone_penalty > 0.0:
        mt = mono2[:, :, None, None]
        net = torch.where(mt != 0, net * mono_pen[:, None, None, None], net)

    if gain_scale is not None:
        net = torch.where(torch.isfinite(net),
                          net * _2d(gain_scale)[:, :, None, None], net)
    if gain_penalty is not None:
        net = torch.where(torch.isfinite(net),
                          net - gain_penalty[:, :, None, None], net)
    if gain_scale is not None or gain_penalty is not None:
        # scaled or penalised gains at or below zero no longer split
        net = torch.where(net > 1e-10, net, NEG_INF)

    if feature_mask is not None:
        fm = _2d(feature_mask).to(torch.bool)
        net = torch.where(fm[:, :, None, None], net, NEG_INF)

    return {"net": net, "left": left, "right": right, "out_l": out_l,
            "out_r": out_r, "pg": pg, "totals": totals, "is_cat2": cat2}


def find_best_splits(hist: torch.Tensor, num_bins_per_feat, nan_bin,
                     is_cat, params: SplitParams,
                     feature_mask: Optional[torch.Tensor] = None,
                     mono_type: Optional[torch.Tensor] = None,
                     leaf_lo: Optional[torch.Tensor] = None,
                     leaf_hi: Optional[torch.Tensor] = None,
                     parent_output: Optional[torch.Tensor] = None,
                     slot_depth: Optional[torch.Tensor] = None,
                     quant_scales: Optional[torch.Tensor] = None,
                     cat_sorted_mask: Optional[torch.Tensor] = None,
                     max_sorted_bins: Optional[int] = None,
                     rand_bin: Optional[torch.Tensor] = None,
                     gain_scale: Optional[torch.Tensor] = None,
                     gain_penalty: Optional[torch.Tensor] = None,
                     adv_bounds: Optional[tuple] = None,
                     **unsupported) -> Dict[str, torch.Tensor]:
    """Best split per leaf slot (split.py:338): first maximum of the
    lattice's net gain over flat (feature, bin, direction). The
    options' operands are :func:`eval_split_lattice`'s.

    ``cat_sorted_mask`` [F] bool (split.py:348-377): those categorical
    features take the sorted-subset search (with ``rand_bin`` one subset
    size a feature; its gains take the same ``gain_scale`` and
    ``gain_penalty``), and its winner replaces the
    lattice's where its gain is strictly greater. It needs descaled
    (f32) histograms, so it does not combine with ``quant_scales``.
    ``max_sorted_bins`` (a host int, at least the bins of every sorted
    feature) bounds that search's serial scan.

    Returns gain [L] (net; -inf when no valid split), feature,
    threshold, default_left, left_sum/right_sum [L, 3],
    left_out/right_out, is_cat_split and cat_bitset [L, ceil(B/32)].
    """
    _reject(unsupported)
    if quant_scales is not None and cat_sorted_mask is not None:
        raise ValueError("quant_scales is incompatible with cat_sorted_mask")
    L, F, B, _ = hist.shape
    mono_pen = None
    if mono_type is not None and params.monotone_penalty > 0.0:
        mono_pen = monotone_penalty_factor(slot_depth,
                                           params.monotone_penalty)
    lat = eval_split_lattice(
        hist, num_bins_per_feat, nan_bin, is_cat, params,
        feature_mask=feature_mask, mono_type=mono_type, leaf_lo=leaf_lo,
        leaf_hi=leaf_hi, parent_output=parent_output, mono_pen=mono_pen,
        quant_scales=quant_scales, cat_sorted_mask=cat_sorted_mask,
        rand_bin=rand_bin, gain_scale=gain_scale, gain_penalty=gain_penalty,
        adv_bounds=adv_bounds)
    flat = lat["net"].reshape(L, F * B * 2)
    best = torch.argmax(flat, dim=1)
    out = _winner_fields(lat, best, B)
    if cat_sorted_mask is None:
        return out
    from .cat_split import find_best_cat_sorted
    srt = find_best_cat_sorted(
        hist, num_bins_per_feat, cat_sorted_mask, params, lat["pg"],
        feature_mask=feature_mask, leaf_lo=leaf_lo, leaf_hi=leaf_hi,
        parent_output=parent_output, max_sorted_bins=max_sorted_bins,
        rand_bin=rand_bin)
    if gain_scale is not None or gain_penalty is not None:
        # sorted-subset candidates compete against scaled and penalised
        # gains: charge them the same (split.py:478-489)
        sg = srt["gain"]
        sf = srt["feature"][:, None].long()
        if gain_scale is not None:
            gs = _2d(gain_scale).expand(L, F)
            sg = torch.where(torch.isfinite(sg),
                             sg * torch.gather(gs, 1, sf)[:, 0], sg)
        if gain_penalty is not None:
            sg = torch.where(torch.isfinite(sg),
                             sg - torch.gather(gain_penalty, 1, sf)[:, 0],
                             sg)
        srt["gain"] = torch.where(sg > 1e-10, sg, NEG_INF)
    pick = srt["gain"] > out["gain"]
    zero = torch.zeros((), dtype=out["threshold"].dtype, device=hist.device)
    out["gain"] = torch.where(pick, srt["gain"], out["gain"])
    out["feature"] = torch.where(pick, srt["feature"], out["feature"])
    out["threshold"] = torch.where(pick, zero, out["threshold"])
    out["default_left"] = out["default_left"] & ~pick
    for k in ("left_sum", "right_sum"):
        out[k] = torch.where(pick[:, None], srt[k], out[k])
    for k in ("left_out", "right_out"):
        out[k] = torch.where(pick, srt[k], out[k])
    out["is_cat_split"] = out["is_cat_split"] | pick
    out["cat_bitset"] = torch.where(pick[:, None],
                                    pack_member_bitset(srt["member"]),
                                    out["cat_bitset"])
    return out


def _winner_fields(lat, best, B):
    """Gather the winner's record at flat index ``best`` [L]."""
    L = best.shape[0]
    net = lat["net"]
    F = net.shape[1]
    flat = net.reshape(L, F * B * 2)
    best_gain = torch.gather(flat, 1, best[:, None])[:, 0]
    feat = torch.div(best, B * 2, rounding_mode="floor").to(torch.int32)
    thr = (torch.div(best, 2, rounding_mode="floor") % B).to(torch.int32)
    opt = (best % 2).to(torch.int32)

    def take3(a):
        af = a.reshape(L, F * B * 2, 3)
        return torch.gather(af, 1, best[:, None, None].expand(L, 1, 3))[:, 0]

    def take1(a):
        return torch.gather(a.reshape(L, F * B * 2), 1, best[:, None])[:, 0]

    cat2 = lat["is_cat2"].expand(L, F)
    is_cat_split = torch.gather(cat2, 1, feat[:, None].long())[:, 0]
    bins_iota = torch.arange(B, dtype=torch.int32, device=net.device)
    member = ((bins_iota[None, :] == thr[:, None])
              & is_cat_split[:, None]
              & torch.isfinite(best_gain)[:, None])
    return {
        "gain": best_gain,
        "feature": feat,
        "threshold": thr,
        "default_left": opt == 1,
        "left_sum": take3(lat["left"]),
        "right_sum": take3(lat["right"]),
        "left_out": take1(lat["out_l"]),
        "right_out": take1(lat["out_r"]),
        "is_cat_split": is_cat_split,
        "cat_bitset": pack_member_bitset(member),
    }
