"""Leaf-wise tree growth on the device.

Port of the serial ``_build_tree_impl`` of
``lightgbm_tpu/boosting/tree_builder.py:155`` (the reference's
``serial_tree_learner.cpp:179`` Train). The tree lives in SoA node
arrays sized ``2*num_leaves - 1`` (+1 dummy scatter slot), and every
round:

1. pops the top-``leaf_batch`` cached splits (``lax.top_k`` order: ties
   to the lower leaf slot, via a stable descending sort),
2. records them in the node arrays and relabels ``row_leaf`` with one
   vectorized pass (the DataPartition::Split analog),
3. histograms the SMALLER child of each split over a compacted row
   stream bounded by a device-side live-row count, and derives the
   sibling by parent-minus-child subtraction from a per-leaf cache
   (``hist_sub``),
4. finds the children's best splits and scatters them into the per-leaf
   caches.

Two arms, as in the JAX package: the fused arm calls kernel B2
(``fused_build_best_splits``: histogram and split search in one call),
the two-pass arm calls kernel B1 (``build_histograms_cuda``) and then
``find_best_splits``. Both wrappers take their plain PyTorch versions
for CPU tensors.

The JAX ``lax.while_loop`` becomes a Python loop over exactly
``max_rounds_for(num_leaves, leaf_batch)`` rounds. A round with no valid
split is a masked no-op that writes only the dummy slots — exactly the
state the JAX loop stops in — so growth needs no host sync at all.

Not ported yet (``build_tree`` raises): the native CPU partition
(``hist_perm_for``), parallel modes, EFB bundles, forced splits, CEGB,
interaction constraints, per-node feature sampling, extra-trees,
sorted-subset categoricals, intermediate/advanced monotone methods and
int8-quantized gradients.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from ..ops import cuda_histogram as CH
from ..ops.histogram import HIST_CH
from ..ops.predict import row_feature_gather
from ..ops.split import (NEG_INF, SplitParams, find_best_splits,
                         leaf_output, monotone_penalty_factor)

__all__ = ["TreeArrays", "build_tree", "max_rounds_for"]

F32_MAX = 3.4e38  # monotone bounds start effectively unconstrained


class TreeArrays(NamedTuple):
    """SoA tree (tree.h:135 analog); arrays sized 2L-1 (+1 dummy)."""
    split_feature: torch.Tensor   # [N] int32, -1 => leaf
    threshold_bin: torch.Tensor   # [N] int32
    default_left: torch.Tensor    # [N] bool
    is_cat: torch.Tensor          # [N] bool
    left_child: torch.Tensor      # [N] int32
    right_child: torch.Tensor     # [N] int32
    gain: torch.Tensor            # [N] f32
    node_value: torch.Tensor      # [N] f32 (unshrunk)
    node_count: torch.Tensor      # [N] f32
    node_hess: torch.Tensor       # [N] f32
    cat_bitset: torch.Tensor      # [N, ceil(B/32)] int64 (uint32 words)
    leaf2node: torch.Tensor       # [L+1] int32
    leaf_values: torch.Tensor     # [L+1] f32 (unshrunk)
    num_leaves: torch.Tensor      # scalar int32
    num_nodes: torch.Tensor       # scalar int32


def max_rounds_for(num_leaves: int, leaf_batch: int) -> int:
    cur, r = 1, 0
    while cur < num_leaves:
        cur += min(leaf_batch, cur, num_leaves - cur)
        r += 1
    return r


def _top_w(gains: torch.Tensor, W: int):
    """lax.top_k semantics: the W largest, ties to the lower index."""
    order = torch.sort(gains, descending=True, stable=True).indices[:W]
    return gains[order], order.to(torch.int32)


def build_tree(bins: torch.Tensor, gh: torch.Tensor, row_leaf0: torch.Tensor,
               num_bins_pf: torch.Tensor, nan_bin_pf: torch.Tensor,
               is_cat_pf: torch.Tensor, feature_mask: torch.Tensor, *,
               num_leaves: int, leaf_batch: int, max_depth: int,
               num_bins: int, split_params: SplitParams,
               hist_dtype: str = "bfloat16",
               valid_bins: Tuple[torch.Tensor, ...] = (),
               valid_row_leaf0: Tuple[torch.Tensor, ...] = (),
               mono_type_pf: Optional[torch.Tensor] = None,
               hist_sub: bool = True, fused_split: bool = False,
               has_cat: bool = True, **unsupported):
    """Grow one tree. Returns (TreeArrays, row_leaf, valid_row_leafs).

    bins [R, F] uint8, gh [R, 3] f32 (grad, hess, in-bag count),
    row_leaf0 [R] int32 (0 = live, -1 = padded), per-feature metadata
    [F], feature_mask [F] bool. ``has_cat`` (host bool) lets the
    relabel skip the bitset test when no feature is categorical.
    """
    bad = [k for k, v in unsupported.items() if v is not None]
    if bad:
        raise NotImplementedError(
            f"tree builder options not ported yet: {bad} (ROADMAP A)")
    if gh.dtype == torch.int8:
        raise NotImplementedError("quantized training is not ported yet "
                                  "(ROADMAP A, slice 2)")
    dev = gh.device
    R = bins.shape[0]
    F = num_bins_pf.shape[0]
    L = num_leaves
    W = max(1, min(leaf_batch, L - 1))
    MAXN = 2 * L - 1
    B = num_bins
    DUMMY_LEAF = L
    DUMMY_NODE = MAXN
    BW = (B + 31) // 32
    sp = split_params
    use_mono = mono_type_pf is not None
    use_smooth = sp.path_smooth > 0.0
    pen_on = use_mono and sp.monotone_penalty > 0.0
    use_fused = bool(fused_split)
    f32, i32, i64 = torch.float32, torch.int32, torch.int64

    def full(shape, v, dt):
        return torch.full(shape, v, dtype=dt, device=dev)

    def ar(n, dt=i32):
        return torch.arange(n, dtype=dt, device=dev)

    def hist_raw_for(slots, rl, gh_in=None, row_gather=None, num_rows=None):
        return CH.build_histograms_cuda(
            bins, gh if gh_in is None else gh_in, rl, slots, num_bins=B,
            hist_dtype=hist_dtype, row_gather=row_gather, num_rows=num_rows)

    def fmask_for(S):
        return feature_mask[None, :].expand(S, F)

    def best_for(hist2w, slot_depth, slot_valid, slots_c, t, leaf_lo,
                 leaf_hi):
        lo = leaf_lo[slots_c] if use_mono else None
        hi = leaf_hi[slots_c] if use_mono else None
        parent_out = t.node_value[t.leaf2node[slots_c].long()]
        bs = find_best_splits(
            hist2w, num_bins_pf, nan_bin_pf, is_cat_pf, sp,
            feature_mask=fmask_for(slots_c.shape[0]),
            mono_type=mono_type_pf, leaf_lo=lo, leaf_hi=hi,
            parent_output=parent_out, slot_depth=slot_depth)
        g = bs["gain"]
        if max_depth > 0:
            g = torch.where(slot_depth < max_depth, g, NEG_INF)
        bs["gain"] = torch.where(slot_valid, g, NEG_INF)
        return bs

    def fused_call(slots, fmask_s, depth_s, lo, hi, po, rl, gh_in=None,
                   row_gather=None, num_rows=None, emit_hist=False):
        pen = (monotone_penalty_factor(depth_s, sp.monotone_penalty)
               if pen_on else None)
        return CH.fused_build_best_splits(
            bins, gh if gh_in is None else gh_in, rl, slots, num_bins=B,
            params=sp, num_bins_pf=num_bins_pf, nan_bin_pf=nan_bin_pf,
            is_cat_pf=is_cat_pf, feature_mask=fmask_s,
            mono_type=mono_type_pf, leaf_lo=lo, leaf_hi=hi,
            parent_output=po, mono_pen=pen, hist_dtype=hist_dtype,
            num_rows=num_rows, emit_hist=emit_hist, row_gather=row_gather)

    def compact_small(row_leaf, small_slots):
        """Stream of the rows whose leaf is in ``small_slots``: the row
        order (c_idx, live prefix first), their leaves and gh, and the
        live count — all on the device."""
        is_small = torch.zeros(L + 2, dtype=torch.bool, device=dev)
        is_small[small_slots.clamp(-1, L).long() + 1] = True
        is_small[0] = False
        m = is_small[row_leaf.clamp(-1, L).long() + 1]
        mi = m.to(i32)
        pos = torch.cumsum(mi, 0, dtype=i32) - 1
        n_small = mi.sum(dtype=i32)
        c_idx = torch.zeros(R + 1, dtype=i32, device=dev)
        c_idx.scatter_(0, torch.where(m, pos, R).long(), ar(R))
        c_idx = c_idx[:R]
        rl_c = torch.where(ar(R) < n_small, row_leaf[c_idx.long()], -1)
        gh_c = gh[c_idx.long()]
        return c_idx, rl_c.to(i32), gh_c, n_small

    # ---------------- state ----------------
    t = TreeArrays(
        split_feature=full((MAXN + 1,), -1, i32),
        threshold_bin=full((MAXN + 1,), 0, i32),
        default_left=full((MAXN + 1,), False, torch.bool),
        is_cat=full((MAXN + 1,), False, torch.bool),
        left_child=full((MAXN + 1,), -1, i32),
        right_child=full((MAXN + 1,), -1, i32),
        gain=full((MAXN + 1,), 0.0, f32),
        node_value=full((MAXN + 1,), 0.0, f32),
        node_count=full((MAXN + 1,), 0.0, f32),
        node_hess=full((MAXN + 1,), 0.0, f32),
        cat_bitset=full((MAXN + 1, BW), 0, i64),
        leaf2node=full((L + 1,), DUMMY_NODE, i32),
        leaf_values=full((L + 1,), 0.0, f32),
        num_leaves=full((), 1, i32),
        num_nodes=full((), 1, i32))
    t.leaf2node[0] = 0
    bs_gain = full((L + 1,), NEG_INF, f32)
    bs_feat = full((L + 1,), 0, i32)
    bs_thr = full((L + 1,), 0, i32)
    bs_dl = full((L + 1,), False, torch.bool)
    bs_cat = full((L + 1,), False, torch.bool)
    bs_left = full((L + 1, HIST_CH), 0.0, f32)
    bs_right = full((L + 1, HIST_CH), 0.0, f32)
    bs_bits = full((L + 1, BW), 0, i64)
    bs_lout = full((L + 1,), 0.0, f32)
    bs_rout = full((L + 1,), 0.0, f32)
    leaf_depth = full((L + 1,), 0, i32)
    leaf_lo = full((L + 1,), -F32_MAX, f32)
    leaf_hi = full((L + 1,), F32_MAX, f32)
    row_leaf = row_leaf0
    valid_row_leaf = list(valid_row_leaf0)
    hist_cache = None

    # ---------------- root ----------------
    root_slots = full((2 * W,), -2, i32)
    root_slots[0] = 0
    root_c = root_slots.clamp(min=0)
    fused_root = use_fused and not use_smooth
    bs0 = None
    if fused_root:
        bs0, hraw0 = fused_call(
            root_slots, fmask_for(2 * W), full((2 * W,), 0, i32),
            leaf_lo[root_c] if use_mono else None,
            leaf_hi[root_c] if use_mono else None, None, row_leaf0,
            emit_hist=hist_sub)
    else:
        hraw0 = hist_raw_for(root_slots, row_leaf0)
    if fused_root and not hist_sub:
        root_sums = bs0["slot_totals"][0]
    else:
        if hist_sub:
            hist_cache = torch.zeros((L + 1,) + tuple(hraw0.shape[1:]),
                                     dtype=hraw0.dtype, device=dev)
            hist_cache[0] = hraw0[0]
        root_sums = hraw0[0, 0].sum(dim=0)
    root_val = leaf_output(root_sums[0], root_sums[1], sp.lambda_l1,
                           sp.lambda_l2, sp.max_delta_step)
    t.node_value[0] = root_val
    t.node_count[0] = root_sums[2]
    t.node_hess[0] = root_sums[1]
    t.leaf_values[0] = root_val
    if bs0 is None:
        slot_valid0 = torch.zeros(2 * W, dtype=torch.bool, device=dev)
        slot_valid0[0] = True
        bs0 = best_for(hraw0, full((2 * W,), 0, i32), slot_valid0, root_c,
                       t, leaf_lo, leaf_hi)
    bs_gain[0] = bs0["gain"][0]
    bs_feat[0] = bs0["feature"][0]
    bs_thr[0] = bs0["threshold"][0]
    bs_dl[0] = bs0["default_left"][0]
    bs_cat[0] = bs0["is_cat_split"][0]
    bs_left[0] = bs0["left_sum"][0]
    bs_right[0] = bs0["right_sum"][0]
    bs_bits[0] = bs0["cat_bitset"][0]
    bs_lout[0] = bs0["left_out"][0]
    bs_rout[0] = bs0["right_out"][0]

    iw = ar(W)
    for _ in range(max_rounds_for(L, W)):
        cur = t.num_leaves
        nodes = t.num_nodes
        # -- 1. pop the top-W cached splits
        gains, sel = _top_w(bs_gain[:L], W)
        valid = torch.isfinite(gains) & (iw < L - cur)
        vi = valid.to(i32)
        n_valid = vi.sum(dtype=i32)
        pos = torch.cumsum(vi, 0, dtype=i32) - 1
        sel_s = torch.where(valid, sel, DUMMY_LEAF)
        right_slot = torch.where(valid, cur + pos, DUMMY_LEAF).to(i32)
        ln = torch.where(valid, nodes + 2 * pos, DUMMY_NODE).to(i32)
        rn = torch.where(valid, nodes + 2 * pos + 1, DUMMY_NODE).to(i32)
        sl = sel_s.long()
        rsl = right_slot.long()
        parent = torch.where(valid, t.leaf2node[sl], DUMMY_NODE).long()
        sfeat, sthr = bs_feat[sl], bs_thr[sl]
        sdl, scat = bs_dl[sl], bs_cat[sl]
        sgain = bs_gain[sl]
        slsum, srsum = bs_left[sl], bs_right[sl]
        sbits = bs_bits[sl]
        lval, rval = bs_lout[sl], bs_rout[sl]

        # -- 2. record the splits in the node arrays
        t.split_feature[parent] = sfeat
        t.threshold_bin[parent] = sthr
        t.default_left[parent] = sdl
        t.is_cat[parent] = scat
        t.left_child[parent] = ln
        t.right_child[parent] = rn
        t.gain[parent] = sgain
        t.node_value[ln.long()] = lval
        t.node_value[rn.long()] = rval
        t.node_count[ln.long()] = slsum[:, 2]
        t.node_count[rn.long()] = srsum[:, 2]
        t.node_hess[ln.long()] = slsum[:, 1]
        t.node_hess[rn.long()] = srsum[:, 1]
        t.cat_bitset[parent] = sbits
        t.leaf2node[sl] = ln
        t.leaf2node[rsl] = rn
        t.leaf_values[sl] = lval
        t.leaf_values[rsl] = rval
        t = t._replace(num_leaves=cur + n_valid,
                       num_nodes=nodes + 2 * n_valid)
        new_depth = leaf_depth[sl] + 1
        leaf_depth[sl] = new_depth
        leaf_depth[rsl] = new_depth

        # -- 2b. basic monotone bounds (monotone_constraints.hpp:488)
        if use_mono:
            mid = (lval + rval) * 0.5
            mt_s = mono_type_pf[sfeat.long()]
            upd = valid & ~scat & (mt_s != 0)
            lo_p, hi_p = leaf_lo[sl], leaf_hi[sl]
            hi_l = torch.where(upd & (mt_s > 0), torch.minimum(hi_p, mid),
                               hi_p)
            lo_l = torch.where(upd & (mt_s < 0), torch.maximum(lo_p, mid),
                               lo_p)
            lo_r = torch.where(upd & (mt_s > 0), torch.maximum(lo_p, mid),
                               lo_p)
            hi_r = torch.where(upd & (mt_s < 0), torch.minimum(hi_p, mid),
                               hi_p)
            leaf_lo[sl] = lo_l
            leaf_lo[rsl] = lo_r
            leaf_lo[DUMMY_LEAF] = -F32_MAX
            leaf_hi[sl] = hi_l
            leaf_hi[rsl] = hi_r
            leaf_hi[DUMMY_LEAF] = F32_MAX

        # -- 3. partition update (DataPartition::Split analog)
        pend_active = torch.zeros(L + 1, dtype=torch.bool, device=dev)
        pend_active[sl] = valid
        pend_active[DUMMY_LEAF] = False
        pend_feat = full((L + 1,), 0, i32)
        pend_feat[sl] = sfeat
        pend_thr = full((L + 1,), 0, i32)
        pend_thr[sl] = sthr
        pend_dl = torch.zeros(L + 1, dtype=torch.bool, device=dev)
        pend_dl[sl] = sdl
        pend_right = full((L + 1,), 0, i32)
        pend_right[sl] = right_slot
        if has_cat:
            pend_cat = torch.zeros(L + 1, dtype=torch.bool, device=dev)
            pend_cat[sl] = scat
            pend_bits = full((L + 1, BW), 0, i64)
            pend_bits[sl] = sbits

        def relabel(bmat, rl):
            rlc = torch.where(rl < 0, DUMMY_LEAF, rl).long()
            active = pend_active[rlc]
            feat = pend_feat[rlc]
            binv = row_feature_gather(bmat, feat)
            thr = pend_thr[rlc]
            nb = nan_bin_pf[feat.long()]
            isnan = (binv == nb) & (nb >= 0)
            go_left = binv <= thr
            if has_cat:
                cat_row = pend_cat[rlc]
                word = (binv >> 5).clamp(0, BW - 1).long()
                wval = pend_bits[rlc].gather(1, word[:, None])[:, 0]
                in_set = ((wval >> (binv & 31).long()) & 1) == 1
                go_left = torch.where(cat_row, in_set, go_left)
                isnan = isnan & ~cat_row
            go_left = torch.where(isnan, pend_dl[rlc], go_left)
            return torch.where(active & ~go_left, pend_right[rlc], rl)

        row_leaf = relabel(bins, row_leaf)
        valid_row_leaf = [relabel(vb, vrl)
                          for vb, vrl in zip(valid_bins, valid_row_leaf)]

        # -- 4. children histograms + best splits
        slots2w = torch.cat([torch.where(valid, sel_s, -2),
                             torch.where(valid, right_slot, -2)]).to(i32)
        slots2w_c = torch.where(slots2w >= 0, slots2w, DUMMY_LEAF).long()
        depth2w = leaf_depth[torch.cat([sl, rsl])]
        valid2w = torch.cat([valid, valid])
        if hist_sub:
            rlc_n = torch.where(row_leaf < 0, DUMMY_LEAF, row_leaf).long()
            raw_cnt = torch.bincount(rlc_n, minlength=L + 1)
            small_is_left = (raw_cnt[sel_s.clamp(0, L).long()]
                             <= raw_cnt[right_slot.clamp(0, L).long()])
            small_slots = torch.where(
                valid, torch.where(small_is_left, sel_s, right_slot),
                -2).to(i32)
            idx_small = torch.where(small_is_left, iw, W + iw).long()
            idx_big = torch.where(small_is_left, W + iw, iw).long()
            c_idx, rl_c, gh_c, n_small = compact_small(row_leaf,
                                                       small_slots)
        if use_fused:
            fmask2w = fmask_for(2 * W)
            lo2w = leaf_lo[slots2w_c] if use_mono else None
            hi2w = leaf_hi[slots2w_c] if use_mono else None
            po2w = t.node_value[t.leaf2node[slots2w_c].long()]
            if not hist_sub:
                bs, _ = fused_call(slots2w, fmask2w, depth2w, lo2w, hi2w,
                                   po2w, row_leaf)
            else:
                def lane(a, idx):
                    return None if a is None else a[idx]
                bs_s, hsmall = fused_call(
                    small_slots, lane(fmask2w, idx_small),
                    lane(depth2w, idx_small), lane(lo2w, idx_small),
                    lane(hi2w, idx_small), lane(po2w, idx_small), rl_c,
                    gh_in=gh_c, row_gather=c_idx, num_rows=n_small,
                    emit_hist=True)
                parent_raw = hist_cache[sel_s.clamp(0, L).long()]
                hbig = parent_raw - hsmall
                sil = small_is_left[:, None, None, None]
                hist_cache[torch.where(valid, sel_s, DUMMY_LEAF).long()] = \
                    torch.where(sil, hsmall, hbig)
                hist_cache[torch.where(valid, right_slot,
                                       DUMMY_LEAF).long()] = \
                    torch.where(sil, hbig, hsmall)
                bs_b = find_best_splits(
                    hbig, num_bins_pf, nan_bin_pf, is_cat_pf, sp,
                    feature_mask=lane(fmask2w, idx_big),
                    mono_type=mono_type_pf, leaf_lo=lane(lo2w, idx_big),
                    leaf_hi=lane(hi2w, idx_big),
                    parent_output=lane(po2w, idx_big),
                    slot_depth=lane(depth2w, idx_big))

                def mix(ks, kb):
                    s_ = small_is_left.reshape((W,) + (1,) * (ks.dim() - 1))
                    return torch.cat([torch.where(s_, ks, kb),
                                      torch.where(s_, kb, ks)])
                bs = {k: mix(bs_s[k], bs_b[k]) for k in bs_b}
            g = bs["gain"]
            if max_depth > 0:
                g = torch.where(depth2w < max_depth, g, NEG_INF)
            bs["gain"] = torch.where(valid2w, g, NEG_INF)
        else:
            if hist_sub:
                hsmall = hist_raw_for(small_slots, rl_c, gh_in=gh_c,
                                      row_gather=c_idx, num_rows=n_small)
                parent_raw = hist_cache[sel_s.clamp(0, L).long()]
                hbig = parent_raw - hsmall
                sil = small_is_left[:, None, None, None]
                left_raw = torch.where(sil, hsmall, hbig)
                right_raw = torch.where(sil, hbig, hsmall)
                hist_cache[torch.where(valid, sel_s, DUMMY_LEAF).long()] = \
                    left_raw
                hist_cache[torch.where(valid, right_slot,
                                       DUMMY_LEAF).long()] = right_raw
                hist2w = torch.cat([left_raw, right_raw])
            else:
                hist2w = hist_raw_for(slots2w, row_leaf)
            bs = best_for(hist2w, depth2w, valid2w, slots2w_c, t, leaf_lo,
                          leaf_hi)

        bs_gain[slots2w_c] = bs["gain"]
        bs_gain[DUMMY_LEAF] = NEG_INF
        bs_feat[slots2w_c] = bs["feature"]
        bs_thr[slots2w_c] = bs["threshold"]
        bs_dl[slots2w_c] = bs["default_left"]
        bs_cat[slots2w_c] = bs["is_cat_split"]
        bs_left[slots2w_c] = bs["left_sum"]
        bs_right[slots2w_c] = bs["right_sum"]
        bs_bits[slots2w_c] = bs["cat_bitset"]
        bs_lout[slots2w_c] = bs["left_out"]
        bs_rout[slots2w_c] = bs["right_out"]

    return t, row_leaf, tuple(valid_row_leaf)
