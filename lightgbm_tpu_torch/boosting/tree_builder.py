"""Leaf-wise tree growth on the device.

Port of the serial ``_build_tree_impl`` of
``lightgbm_tpu/boosting/tree_builder.py:155`` (the reference's
``serial_tree_learner.cpp:179`` Train) and of its class-batched form
``_build_tree_class_batched`` (``:1839``). The tree lives in SoA node
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

All builder state carries a leading class axis K. ``build_tree`` grows
one tree (K = 1); ``build_tree_class_batched`` grows the K per-class
trees of a multiclass iteration together, the port's counterpart of the
JAX ``vmap``: the class axis is folded into the slot axis of the
existing kernels. Class k's leaf ``l`` is slot ``k*(L+1) + l``; the
smaller children of all K classes form ONE compacted stream over
(class, row) pairs (rows gathered from ``bins`` by ``idx % R``, gh from
the flattened [K*R, 3]) with one device-side row count; the histogram
cache is [K*(L+1), F, B, 3]. Each round is one B2 (or B1) launch for all
K classes, and the root is one B3 launch (``root_hist`` seam: a given
root histogram is split two-pass, as ``tree_builder.py:1184-1190``).

The JAX ``lax.while_loop`` becomes a Python loop over exactly
``max_rounds_for(num_leaves, leaf_batch)`` rounds. A round with no valid
split is a masked no-op that writes only the dummy slots — exactly the
state the JAX loop stops in, and the state a finished class freezes in
under the JAX batched loop — so growth needs no host sync at all, and
on CUDA the whole build can be captured into a CUDA graph (the training
step, ``boosting/gbdt.py``): every shape is fixed by the arguments, no
op here reads a device value on the host, and none copies a host value
to the device (scalars are written with ``fill_``/``index_fill_``: on a
CUDA tensor, ``t[i] = 0`` copies a host scalar, a host sync eagerly and
an error under capture).

Quantized training (``quant_scales``; the JAX package's
``tree_builder.py:509-586``):
``gh`` is int8 grid values and every histogram is a raw int32 sum —
B3's roots, B1's and B2's children and the per-leaf cache, so the
parent-minus-child subtraction stays exact. The two-pass arm descales
the raw histogram by (g_scale, h_scale, 1) before the split search
(``hist_finish``); the fused arm hands the scales to kernel B2, whose
epilogue scans the int32 sums and descales at gain time, and the
sibling's search does the same (``find_best_splits(...,
quant_scales)``). With the class axis folded into the slot axis each
slot takes its class's scales.

EFB (``bundle_meta``, ``bundle_bins``; the JAX package's
``tree_builder.py:270-315, 527-590``): ``bins`` is the bundled [R, G]
matrix. Raw histograms (B1, the per-leaf cache, the parent-minus-child
subtraction) live in bundle space, [S, G, bundle_bins, 3], exact int32
when quantized; ``hist_finish`` descales, then unbundles to per-feature
[S, F, B, 3], rebuilding each feature's most-frequent bin as the leaf
total (bundle column 0's sum) minus the feature's other bins. The
relabel decodes a row's feature bin from its bundle column
(``ops.predict.feature_bins``). The class-batched build does not call
B3 under EFB, because the JAX package's gate does not
(``tree_builder.py:1899-1906``: its one-pass class root is kept to
unbundled single-device plans), so both packages build the roots alike:
the K roots are one B1 launch of K slots over the folded (class, row)
stream. (The port's B3 would take the bundled matrix as it is.)

Sorted-subset categoricals (``cat_sorted_mask``): every split search
takes the mask (``ops/split.py``, ``ops/cat_split.py``); winners become
multi-category bitsets in the same ``cat_bitset`` words.

Not ported yet (``build_tree`` raises): the native CPU partition
(``hist_perm_for``), parallel modes, forced splits, CEGB, interaction
constraints, per-node feature sampling, extra-trees and
intermediate/advanced monotone methods.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from ..ops import cuda_histogram as CH
from ..ops.histogram import HIST_CH
from ..ops.predict import feature_bins
from ..ops.split import (NEG_INF, SplitParams, find_best_splits,
                         leaf_output, monotone_penalty_factor)

__all__ = ["TreeArrays", "build_tree", "build_tree_class_batched",
           "max_rounds_for", "unbundle_histograms"]

F32_MAX = 3.4e38  # monotone bounds start effectively unconstrained


class TreeArrays(NamedTuple):
    """SoA tree (tree.h:135 analog); arrays sized 2L-1 (+1 dummy). The
    class-batched builder returns every field with a leading K axis."""
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


def build_tree(bins: torch.Tensor, gh: torch.Tensor, row_leaf0: torch.Tensor,
               num_bins_pf: torch.Tensor, nan_bin_pf: torch.Tensor,
               is_cat_pf: torch.Tensor, feature_mask: torch.Tensor, *,
               root_hist: Optional[torch.Tensor] = None, **kw):
    """Grow one tree. Returns (TreeArrays, row_leaf, valid_row_leafs).

    bins [R, F] uint8, gh [R, 3] f32 (grad, hess, in-bag count), or
    int8 grid values with ``quant_scales`` [2] (g_scale, h_scale),
    row_leaf0 [R] int32 (0 = live, -1 = padded), per-feature metadata
    [F], feature_mask [F] bool. ``has_cat`` (host bool) lets the
    relabel skip the bitset test when no feature is categorical.
    ``root_hist`` [F, B, 3], when given, is the root's histogram: the
    root split is then found two-pass on it.
    """
    t, rl, vrls = _grow(bins, gh[None], row_leaf0, num_bins_pf, nan_bin_pf,
                        is_cat_pf, feature_mask,
                        root_hist=None if root_hist is None
                        else root_hist[None], **kw)
    return (TreeArrays(*(f[0] for f in t)), rl[0],
            tuple(v[0] for v in vrls))


def build_tree_class_batched(bins: torch.Tensor, gh_k: torch.Tensor,
                             row_leaf0: torch.Tensor, num_bins_pf, nan_bin_pf,
                             is_cat_pf, feature_mask, **kw):
    """Grow the K per-class trees of one iteration together.

    ``gh_k`` is [K, R, 3] (int8 with ``quant_scales`` [K, 2]);
    everything else is shared across classes, as ``build_tree``'s. The
    K root histograms come from ONE B3 launch that streams ``bins``
    once; on a bundled matrix (``bundle_meta``) B3 is skipped, as the
    JAX gate does (``tree_builder.py:1899-1906``), and the roots are
    one B1 launch of K slots. Returns (TreeArrays with a
    leading K on every field, row_leaf [K, R], tuple of valid
    row_leafs [K, Rv])."""
    root_hist = None
    if kw.get("bundle_meta") is None:
        root_hist = CH.build_root_histograms_classes(
            bins, gh_k, row_leaf0, num_bins=kw["num_bins"],
            hist_dtype=kw.get("hist_dtype", "bfloat16"))
    return _grow(bins, gh_k, row_leaf0, num_bins_pf, nan_bin_pf, is_cat_pf,
                 feature_mask, root_hist=root_hist, **kw)


def _sum(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Sum keeping the input dtype (torch widens int32 to int64)."""
    return x.sum(dim=dim, dtype=x.dtype)


def unbundle_histograms(hg: torch.Tensor, bundle_meta, bundle_bins: int,
                        num_bins_pf: torch.Tensor, num_bins: int
                        ) -> torch.Tensor:
    """[S, G, bundle_bins, 3] bundle-space sums -> [S, F, num_bins, 3]
    per feature (``unbundle``, tree_builder.py:279-303), f32 or raw
    int32 alike. ``bundle_meta`` = (bundle, offset, most-frequent bin)
    [F] per feature. Each feature's bins are gathered from its bundle
    column's range, bins past its own count are zero, and its
    most-frequent bin, which the bundle does not store, is rebuilt as
    ``totals - (sum_all - at_mfb)`` in the reference's op order
    (FixHistogram, dataset.cpp:1488), ``totals`` being bundle column 0's
    bin sum: every row lands in one bin of every column."""
    S, G = hg.shape[0], hg.shape[1]
    F, B, nb = num_bins_pf.shape[0], num_bins, bundle_bins
    dev = hg.device
    b_gof, b_off, b_mfb = (m.long() for m in bundle_meta)
    bi = torch.arange(B, dtype=torch.int64, device=dev)
    idx = (b_gof[:, None] * nb + b_off[:, None] + bi[None, :]).clamp(
        0, G * nb - 1)                                         # [F, B]
    valid = (bi[None, :] < num_bins_pf.long()[:, None])[None, :, :, None]
    mfb_oh = (bi[None, :] == b_mfb[:, None])[None, :, :, None]
    zero = torch.zeros((), dtype=hg.dtype, device=dev)
    hf = hg.reshape(S, G * nb, HIST_CH)[:, idx.reshape(-1)].reshape(
        S, F, B, HIST_CH)
    hf = torch.where(valid, hf, zero)
    totals = _sum(hg[:, 0], 1)                                # [S, 3]
    sum_all = _sum(hf, 2)
    at_mfb = _sum(torch.where(mfb_oh, hf, zero), 2)
    mfb_val = totals[:, None, :] - (sum_all - at_mfb)
    return torch.where(mfb_oh & valid, mfb_val[:, :, None, :], hf)


def _leaf_counts(ids: torch.Tensor, n: int) -> torch.Tensor:
    """Exact count of each value in [0, n) of the int32 ``ids``.
    ``torch.bincount`` sizes its output from the ids' maximum, which on
    CUDA it copies to the host: a sync that no CUDA graph can hold. On
    CUDA ``torch.histc`` over the int32 ids takes its place (its range
    is given, so it reads nothing back; integer bins and int32 counts
    are exact)."""
    if ids.is_cuda:
        return torch.histc(ids, bins=n, min=0, max=n)
    return torch.bincount(ids, minlength=n)


def _grow(bins, gh_k, row_leaf0, num_bins_pf, nan_bin_pf, is_cat_pf,
          feature_mask, *, num_leaves: int, leaf_batch: int, max_depth: int,
          num_bins: int, split_params: SplitParams,
          hist_dtype: str = "bfloat16",
          valid_bins: Tuple[torch.Tensor, ...] = (),
          valid_row_leaf0: Tuple[torch.Tensor, ...] = (),
          mono_type_pf: Optional[torch.Tensor] = None,
          hist_sub: bool = True, fused_split: bool = False,
          has_cat: bool = True, root_hist: Optional[torch.Tensor] = None,
          quant_scales: Optional[torch.Tensor] = None,
          cat_sorted_mask: Optional[torch.Tensor] = None,
          max_sorted_bins: Optional[int] = None,
          bundle_meta: Optional[Tuple[torch.Tensor, ...]] = None,
          bundle_bins: int = 0, **unsupported):
    """The builder over a class axis: gh_k [K, R, 3] (int8 with
    ``quant_scales`` [K, 2]); root_hist [K, F, B, 3] or None (the root
    is then built here: K = 1 as the serial build does, K > 1 by one
    B1 launch of K slots over the folded stream). ``bundle_meta`` =
    (bundle, offset, most-frequent bin) [F] int32 per feature of a
    bundled ``bins``, whose lattice has ``bundle_bins`` bins."""
    bad = [k for k, v in unsupported.items() if v is not None]
    if bad:
        raise NotImplementedError(
            f"tree builder options not ported yet: {bad} (ROADMAP A)")
    quant = gh_k.dtype == torch.int8
    if quant != (quant_scales is not None):
        raise ValueError("int8 gh needs quant_scales, and only int8 gh "
                         "takes them")
    dev = gh_k.device
    K, R = gh_k.shape[0], gh_k.shape[1]
    F = num_bins_pf.shape[0]     # per-FEATURE count (bins may be bundled)
    L = num_leaves
    L1 = L + 1
    W = max(1, min(leaf_batch, L - 1))
    MAXN = 2 * L - 1
    N1 = MAXN + 1
    B = num_bins
    DUMMY_LEAF = L
    DUMMY_NODE = MAXN
    BW = (B + 31) // 32
    sp = split_params
    use_mono = mono_type_pf is not None
    use_smooth = sp.path_smooth > 0.0
    pen_on = use_mono and sp.monotone_penalty > 0.0
    # the fused arm's epilogue scans the feature-space lattice in the
    # kernel: EFB and sorted-subset categoricals need the full histogram
    # (the JAX gate, tree_builder.py:501-507)
    use_fused = (bool(fused_split) and bundle_meta is None
                 and cat_sorted_mask is None)
    f32, i32, i64 = torch.float32, torch.int32, torch.int64

    def full(shape, v, dt):
        return torch.full(shape, v, dtype=dt, device=dev)

    def ar(n, dt=i32):
        return torch.arange(n, dtype=dt, device=dev)

    kk = ar(K)[:, None]                          # [K, 1] class index

    def fold(idx, n):
        """Per-class local index [K, ...] -> flat index into [K * n]."""
        return (kk * n + idx).long()

    gh_flat = gh_k.reshape(K * R, HIST_CH)
    if quant:
        qs_k = quant_scales.to(f32).reshape(K, 2)
        dq_k = torch.cat([qs_k, torch.ones((K, 1), dtype=f32, device=dev)],
                         1)

    def slot_scales(n):
        """Each of the K*n class-major slots' (g_scale, h_scale)."""
        return qs_k.repeat_interleave(n, 0) if quant else None

    def dequant(h):
        """Raw [K*n, F|G, B|bb, 3] sums -> f32: int32 times its class's
        (g_scale, h_scale, 1)."""
        if not quant:
            return h
        n = h.shape[0] // K
        return h.to(f32) * dq_k.repeat_interleave(n, 0)[:, None, None, :]

    use_bundle = bundle_meta is not None
    nb_in = bundle_bins if use_bundle else B

    def hist_finish(hraw):
        """Raw -> per-feature f32 split-finding space (hist_finish,
        tree_builder.py:580-590): descale, then unbundle."""
        h = dequant(hraw)
        if not use_bundle:
            return h
        return unbundle_histograms(h, bundle_meta, nb_in, num_bins_pf, B)

    def hist_raw_for(slots, rl, gh_in, row_gather=None, num_rows=None):
        """The RAW histogram of ``slots``: bundle space under EFB, int32
        when quantized; parent-minus-child subtraction happens here."""
        return CH.build_histograms_cuda(
            bins, gh_in, rl, slots, num_bins=nb_in, hist_dtype=hist_dtype,
            row_gather=row_gather, num_rows=num_rows)

    def fmask_for(S):
        return feature_mask[None, :].expand(S, F)

    def best_for(hist, slot_depth, slot_valid, slots_f, t, leaf_lo,
                 leaf_hi):
        """find_best_splits over the flat (folded) slots ``slots_f``,
        class-major."""
        lo = leaf_lo.view(-1)[slots_f] if use_mono else None
        hi = leaf_hi.view(-1)[slots_f] if use_mono else None
        parent_out = t.node_value.view(-1)[
            fold(t.leaf2node.view(-1)[slots_f].view(K, -1), N1).reshape(-1)]
        bs = find_best_splits(
            hist, num_bins_pf, nan_bin_pf, is_cat_pf, sp,
            feature_mask=fmask_for(slots_f.shape[0]),
            mono_type=mono_type_pf, leaf_lo=lo, leaf_hi=hi,
            parent_output=parent_out, slot_depth=slot_depth,
            **sorted_kw)
        g = bs["gain"]
        if max_depth > 0:
            g = torch.where(slot_depth < max_depth, g, NEG_INF)
        bs["gain"] = torch.where(slot_valid, g, NEG_INF)
        return bs

    sorted_kw = ({} if cat_sorted_mask is None else
                 dict(cat_sorted_mask=cat_sorted_mask,
                      max_sorted_bins=max_sorted_bins))

    def fused_call(slots, fmask_s, depth_s, lo, hi, po, rl, gh_in,
                   row_gather=None, num_rows=None, emit_hist=False):
        pen = (monotone_penalty_factor(depth_s, sp.monotone_penalty)
               if pen_on else None)
        return CH.fused_build_best_splits(
            bins, gh_in, rl, slots, num_bins=B,
            params=sp, num_bins_pf=num_bins_pf, nan_bin_pf=nan_bin_pf,
            is_cat_pf=is_cat_pf, feature_mask=fmask_s,
            mono_type=mono_type_pf, leaf_lo=lo, leaf_hi=hi,
            parent_output=po, mono_pen=pen, hist_dtype=hist_dtype,
            num_rows=num_rows, emit_hist=emit_hist, row_gather=row_gather,
            quant_scales=slot_scales(slots.shape[0] // K))

    def kernel_ids(local, pad):
        """[K, n] per-class leaf ids -> the kernels' flat [K*n] ids:
        class k's leaf l is k*(L+1)+l; negative ids become ``pad``."""
        return torch.where(local >= 0, kk * L1 + local,
                           pad).reshape(-1).to(i32)

    def full_stream(row_leaf):
        """Every (class, row) pair: (row_leaf, gh, row_gather)."""
        if K == 1:
            return row_leaf[0].contiguous(), gh_k[0], None
        return kernel_ids(row_leaf, -1), gh_flat, ar(K * R) % R

    def compact_small(row_leaf, small_slots):
        """Stream of the (class, row) pairs whose leaf is in their
        class's ``small_slots`` [K, W]: pair order (c_idx, live prefix
        first), folded leaves, gh, the bins row of each pair and the
        live count — all on the device."""
        KR = K * R
        is_small = torch.zeros(K * (L + 2), dtype=torch.bool, device=dev)
        is_small.index_fill_(
            0, fold(small_slots.clamp(-1, L) + 1, L + 2).reshape(-1), True)
        is_small.view(K, L + 2)[:, 0].fill_(False)
        m = is_small[fold(row_leaf.clamp(-1, L) + 1, L + 2)].reshape(-1)
        mi = m.to(i32)
        pos = torch.cumsum(mi, 0, dtype=i32) - 1
        n_small = mi.sum(dtype=i32)
        c_idx = torch.zeros(KR + 1, dtype=i32, device=dev)
        c_idx.scatter_(0, torch.where(m, pos, KR).long(), ar(KR))
        c_idx = c_idx[:KR]
        ci = c_idx.long()
        rl_c = torch.where(ar(KR) < n_small, kernel_ids(row_leaf, -1)[ci],
                           -1)
        gh_c = gh_flat[ci]
        gather = c_idx if K == 1 else c_idx % R
        return gather, rl_c.to(i32), gh_c, n_small

    # ---------------- state ----------------
    t = TreeArrays(
        split_feature=full((K, N1), -1, i32),
        threshold_bin=full((K, N1), 0, i32),
        default_left=full((K, N1), False, torch.bool),
        is_cat=full((K, N1), False, torch.bool),
        left_child=full((K, N1), -1, i32),
        right_child=full((K, N1), -1, i32),
        gain=full((K, N1), 0.0, f32),
        node_value=full((K, N1), 0.0, f32),
        node_count=full((K, N1), 0.0, f32),
        node_hess=full((K, N1), 0.0, f32),
        cat_bitset=full((K, N1, BW), 0, i64),
        leaf2node=full((K, L1), DUMMY_NODE, i32),
        leaf_values=full((K, L1), 0.0, f32),
        num_leaves=full((K,), 1, i32),
        num_nodes=full((K,), 1, i32))
    t.leaf2node[:, 0].fill_(0)
    bs_gain = full((K, L1), NEG_INF, f32)
    bs_feat = full((K, L1), 0, i32)
    bs_thr = full((K, L1), 0, i32)
    bs_dl = full((K, L1), False, torch.bool)
    bs_cat = full((K, L1), False, torch.bool)
    bs_left = full((K, L1, HIST_CH), 0.0, f32)
    bs_right = full((K, L1, HIST_CH), 0.0, f32)
    bs_bits = full((K, L1, BW), 0, i64)
    bs_lout = full((K, L1), 0.0, f32)
    bs_rout = full((K, L1), 0.0, f32)
    leaf_depth = full((K, L1), 0, i32)
    leaf_lo = full((K, L1), -F32_MAX, f32)
    leaf_hi = full((K, L1), F32_MAX, f32)
    row_leaf = row_leaf0[None].expand(K, R)
    valid_row_leaf = [v[None].expand(K, v.shape[0]) for v in valid_row_leaf0]
    hist_cache = None
    root_f = (kk[:, 0] * L1).long()              # each class's leaf 0

    # ---------------- root ----------------
    bs0 = None
    hraw0 = None
    if root_hist is not None:
        # the root histograms were built by the caller (one B3 launch
        # for all classes): the root split is found two-pass
        hroot = root_hist
    elif K > 1:
        # class-batched under EFB: the K roots in one B1 launch over the
        # folded (class, row) stream, one slot a class (its leaf 0)
        rl_s, gh_s, gat = full_stream(row_leaf0[None].expand(K, R))
        hroot = hist_raw_for(kernel_ids(full((K, 1), 0, i32), -2), rl_s,
                             gh_s, row_gather=gat)
    else:
        root_slots = full((2 * W,), -2, i32)
        root_slots[0].fill_(0)
        root_c = root_slots.clamp(min=0).long()
        fused_root = use_fused and not use_smooth
        if fused_root:
            bs0, hraw0 = fused_call(
                root_slots, fmask_for(2 * W), full((2 * W,), 0, i32),
                leaf_lo[0, root_c] if use_mono else None,
                leaf_hi[0, root_c] if use_mono else None, None,
                row_leaf0, gh_k[0], emit_hist=hist_sub)
            bs0 = {k: v[:1] for k, v in bs0.items()}
        else:
            hraw0 = hist_raw_for(root_slots, row_leaf0, gh_k[0])
        hroot = None if hraw0 is None else hraw0[:1]
    if bs0 is not None and not hist_sub:
        root_sums = bs0["slot_totals"]
    else:
        if hist_sub:
            hist_cache = torch.zeros((K * L1,) + tuple(hroot.shape[1:]),
                                     dtype=hroot.dtype, device=dev)
            hist_cache[root_f] = hroot
        # all rows land in feature 0's bins
        root_sums = hist_finish(hroot)[:, 0].sum(dim=1)
    root_val = leaf_output(root_sums[:, 0], root_sums[:, 1], sp.lambda_l1,
                           sp.lambda_l2, sp.max_delta_step)
    t.node_value[:, 0] = root_val
    t.node_count[:, 0] = root_sums[:, 2]
    t.node_hess[:, 0] = root_sums[:, 1]
    t.leaf_values[:, 0] = root_val
    if bs0 is None and (root_hist is not None or K > 1):
        bs0 = best_for(hist_finish(hroot), full((K,), 0, i32),
                       torch.ones(K, dtype=torch.bool, device=dev), root_f,
                       t, leaf_lo, leaf_hi)
    elif bs0 is None:
        slot_valid0 = torch.zeros(2 * W, dtype=torch.bool, device=dev)
        slot_valid0[0].fill_(True)
        bs0 = best_for(hist_finish(hraw0), full((2 * W,), 0, i32),
                       slot_valid0, root_c, t, leaf_lo, leaf_hi)
        bs0 = {k: v[:1] for k, v in bs0.items()}
    bs_gain[:, 0] = bs0["gain"]
    bs_feat[:, 0] = bs0["feature"]
    bs_thr[:, 0] = bs0["threshold"]
    bs_dl[:, 0] = bs0["default_left"]
    bs_cat[:, 0] = bs0["is_cat_split"]
    bs_left[:, 0] = bs0["left_sum"]
    bs_right[:, 0] = bs0["right_sum"]
    bs_bits[:, 0] = bs0["cat_bitset"]
    bs_lout[:, 0] = bs0["left_out"]
    bs_rout[:, 0] = bs0["right_out"]

    iw = ar(W)[None, :]
    for _ in range(max_rounds_for(L, W)):
        cur = t.num_leaves
        nodes = t.num_nodes
        # -- 1. pop each class's top-W cached splits (ties to the lower
        #    slot, as lax.top_k)
        srt = torch.sort(bs_gain[:, :L], dim=1, descending=True,
                         stable=True)
        gains = srt.values[:, :W]
        sel = srt.indices[:, :W].to(i32)
        valid = torch.isfinite(gains) & (iw < (L - cur)[:, None])
        vi = valid.to(i32)
        n_valid = vi.sum(dim=1, dtype=i32)
        pos = torch.cumsum(vi, 1, dtype=i32) - 1
        sel_s = torch.where(valid, sel, DUMMY_LEAF)
        right_slot = torch.where(valid, cur[:, None] + pos,
                                 DUMMY_LEAF).to(i32)
        ln = torch.where(valid, nodes[:, None] + 2 * pos, DUMMY_NODE).to(i32)
        rn = torch.where(valid, nodes[:, None] + 2 * pos + 1,
                         DUMMY_NODE).to(i32)
        sl = fold(sel_s, L1)
        rsl = fold(right_slot, L1)
        parent = fold(torch.where(valid, t.leaf2node.view(-1)[sl],
                                  DUMMY_NODE), N1)
        lnf, rnf = fold(ln, N1), fold(rn, N1)
        sfeat, sthr = bs_feat.view(-1)[sl], bs_thr.view(-1)[sl]
        sdl, scat = bs_dl.view(-1)[sl], bs_cat.view(-1)[sl]
        sgain = bs_gain.view(-1)[sl]
        slsum = bs_left.view(K * L1, HIST_CH)[sl]
        srsum = bs_right.view(K * L1, HIST_CH)[sl]
        sbits = bs_bits.view(K * L1, BW)[sl]
        lval, rval = bs_lout.view(-1)[sl], bs_rout.view(-1)[sl]

        # -- 2. record the splits in the node arrays
        t.split_feature.view(-1)[parent] = sfeat
        t.threshold_bin.view(-1)[parent] = sthr
        t.default_left.view(-1)[parent] = sdl
        t.is_cat.view(-1)[parent] = scat
        t.left_child.view(-1)[parent] = ln
        t.right_child.view(-1)[parent] = rn
        t.gain.view(-1)[parent] = sgain
        t.node_value.view(-1)[lnf] = lval
        t.node_value.view(-1)[rnf] = rval
        t.node_count.view(-1)[lnf] = slsum[..., 2]
        t.node_count.view(-1)[rnf] = srsum[..., 2]
        t.node_hess.view(-1)[lnf] = slsum[..., 1]
        t.node_hess.view(-1)[rnf] = srsum[..., 1]
        t.cat_bitset.view(K * N1, BW)[parent] = sbits
        t.leaf2node.view(-1)[sl] = ln
        t.leaf2node.view(-1)[rsl] = rn
        t.leaf_values.view(-1)[sl] = lval
        t.leaf_values.view(-1)[rsl] = rval
        t = t._replace(num_leaves=cur + n_valid,
                       num_nodes=nodes + 2 * n_valid)
        new_depth = leaf_depth.view(-1)[sl] + 1
        leaf_depth.view(-1)[sl] = new_depth
        leaf_depth.view(-1)[rsl] = new_depth

        # -- 2b. basic monotone bounds (monotone_constraints.hpp:488)
        if use_mono:
            mid = (lval + rval) * 0.5
            mt_s = mono_type_pf[sfeat.long()]
            upd = valid & ~scat & (mt_s != 0)
            lo_p, hi_p = leaf_lo.view(-1)[sl], leaf_hi.view(-1)[sl]
            hi_l = torch.where(upd & (mt_s > 0), torch.minimum(hi_p, mid),
                               hi_p)
            lo_l = torch.where(upd & (mt_s < 0), torch.maximum(lo_p, mid),
                               lo_p)
            lo_r = torch.where(upd & (mt_s > 0), torch.maximum(lo_p, mid),
                               lo_p)
            hi_r = torch.where(upd & (mt_s < 0), torch.minimum(hi_p, mid),
                               hi_p)
            leaf_lo.view(-1)[sl] = lo_l
            leaf_lo.view(-1)[rsl] = lo_r
            leaf_lo[:, DUMMY_LEAF].fill_(-F32_MAX)
            leaf_hi.view(-1)[sl] = hi_l
            leaf_hi.view(-1)[rsl] = hi_r
            leaf_hi[:, DUMMY_LEAF].fill_(F32_MAX)

        # -- 3. partition update (DataPartition::Split analog), per class
        pend_active = torch.zeros(K * L1, dtype=torch.bool, device=dev)
        pend_active[sl] = valid
        pend_active.view(K, L1)[:, DUMMY_LEAF].fill_(False)
        pend_feat = full((K * L1,), 0, i32)
        pend_feat[sl] = sfeat
        pend_thr = full((K * L1,), 0, i32)
        pend_thr[sl] = sthr
        pend_dl = torch.zeros(K * L1, dtype=torch.bool, device=dev)
        pend_dl[sl] = sdl
        pend_right = full((K * L1,), 0, i32)
        pend_right[sl] = right_slot
        if has_cat:
            pend_cat = torch.zeros(K * L1, dtype=torch.bool, device=dev)
            pend_cat[sl] = scat
            pend_bits = full((K * L1, BW), 0, i64)
            pend_bits[sl] = sbits

        def relabel(bmat, rl):
            """rl [K, Rx] -> the rows' leaves after this round's splits."""
            rlc = fold(torch.where(rl < 0, DUMMY_LEAF, rl), L1)
            active = pend_active[rlc]
            feat = pend_feat[rlc]
            # under EFB decoded from the bundle column (feature_bin_of,
            # tree_builder.py:305-310)
            binv = feature_bins(bmat, feat, bundle_meta, num_bins_pf)
            thr = pend_thr[rlc]
            nb = nan_bin_pf[feat.long()]
            isnan = (binv == nb) & (nb >= 0)
            go_left = binv <= thr
            if has_cat:
                cat_row = pend_cat[rlc]
                word = (binv >> 5).clamp(0, BW - 1).long()
                wval = pend_bits.view(-1)[rlc * BW + word]
                in_set = ((wval >> (binv & 31).long()) & 1) == 1
                go_left = torch.where(cat_row, in_set, go_left)
                isnan = isnan & ~cat_row
            go_left = torch.where(isnan, pend_dl[rlc], go_left)
            return torch.where(active & ~go_left, pend_right[rlc], rl)

        row_leaf = relabel(bins, row_leaf)
        valid_row_leaf = [relabel(vb, vrl)
                          for vb, vrl in zip(valid_bins, valid_row_leaf)]

        # -- 4. children histograms + best splits; slot lanes are
        #    [K, 2W] (left children, then right), flattened class-major
        slots2w = torch.cat([torch.where(valid, sel_s, -2),
                             torch.where(valid, right_slot, -2)], 1).to(i32)
        s2f = fold(torch.where(slots2w >= 0, slots2w, DUMMY_LEAF),
                   L1).reshape(-1)
        depth2w = leaf_depth.view(-1)[s2f]
        valid2w = torch.cat([valid, valid], 1).reshape(-1)

        def lane(a, idx):
            """[K*2W] per-slot values -> the [K*W] lanes at idx [K, W]."""
            if a is None:
                return None
            return torch.gather(a.view(K, 2 * W), 1, idx).reshape(-1)

        if hist_sub:
            rl_n = torch.where(row_leaf < 0, DUMMY_LEAF, row_leaf) + kk * L1
            raw_cnt = _leaf_counts(rl_n.reshape(-1), K * L1)
            small_is_left = (raw_cnt[fold(sel_s.clamp(0, L), L1)]
                             <= raw_cnt[fold(right_slot.clamp(0, L), L1)])
            small_slots = torch.where(
                valid, torch.where(small_is_left, sel_s, right_slot),
                -2).to(i32)
            small_f = kernel_ids(small_slots, -2)
            idx_small = torch.where(small_is_left, iw, W + iw).long()
            idx_big = torch.where(small_is_left, W + iw, iw).long()
            c_gather, rl_c, gh_c, n_small = compact_small(row_leaf,
                                                          small_slots)
            sil = small_is_left.reshape(-1)[:, None, None, None]
            left_f = fold(torch.where(valid, sel_s, DUMMY_LEAF),
                          L1).reshape(-1)
            right_f = fold(torch.where(valid, right_slot, DUMMY_LEAF),
                           L1).reshape(-1)
            parent_f = fold(sel_s.clamp(0, L), L1).reshape(-1)
        if use_fused:
            fmask2w = fmask_for(K * 2 * W)
            lo2w = leaf_lo.view(-1)[s2f] if use_mono else None
            hi2w = leaf_hi.view(-1)[s2f] if use_mono else None
            po2w = t.node_value.view(-1)[
                fold(t.leaf2node.view(-1)[s2f].view(K, 2 * W), N1)
                .reshape(-1)]
            if not hist_sub:
                rl_s, gh_s, gat = full_stream(row_leaf)
                bs, _ = fused_call(kernel_ids(slots2w, -2), fmask2w,
                                   depth2w, lo2w, hi2w, po2w, rl_s, gh_s,
                                   row_gather=gat)
            else:
                bs_s, hsmall = fused_call(
                    small_f, fmask_for(K * W), lane(depth2w, idx_small),
                    lane(lo2w, idx_small), lane(hi2w, idx_small),
                    lane(po2w, idx_small), rl_c, gh_c,
                    row_gather=c_gather, num_rows=n_small, emit_hist=True)
                hbig = hist_cache[parent_f] - hsmall
                hist_cache[left_f] = torch.where(sil, hsmall, hbig)
                hist_cache[right_f] = torch.where(sil, hbig, hsmall)
                bs_b = find_best_splits(
                    hbig, num_bins_pf, nan_bin_pf, is_cat_pf, sp,
                    feature_mask=fmask_for(K * W),
                    mono_type=mono_type_pf, leaf_lo=lane(lo2w, idx_big),
                    leaf_hi=lane(hi2w, idx_big),
                    parent_output=lane(po2w, idx_big),
                    slot_depth=lane(depth2w, idx_big),
                    quant_scales=slot_scales(W))

                def mix(ks, kb):
                    tail = tuple(ks.shape[1:])
                    s_ = small_is_left.reshape((K, W) + (1,) * len(tail))
                    ks = ks.reshape((K, W) + tail)
                    kb = kb.reshape((K, W) + tail)
                    return torch.cat([torch.where(s_, ks, kb),
                                      torch.where(s_, kb, ks)],
                                     1).reshape((K * 2 * W,) + tail)
                bs = {k: mix(bs_s[k], bs_b[k]) for k in bs_b}
            g = bs["gain"]
            if max_depth > 0:
                g = torch.where(depth2w < max_depth, g, NEG_INF)
            bs["gain"] = torch.where(valid2w, g, NEG_INF)
        else:
            if hist_sub:
                hsmall = hist_raw_for(small_f, rl_c, gh_c,
                                      row_gather=c_gather, num_rows=n_small)
                hbig = hist_cache[parent_f] - hsmall
                left_raw = torch.where(sil, hsmall, hbig)
                right_raw = torch.where(sil, hbig, hsmall)
                hist_cache[left_f] = left_raw
                hist_cache[right_f] = right_raw
                tail = tuple(left_raw.shape[1:])
                hist2w = torch.cat([left_raw.view((K, W) + tail),
                                    right_raw.view((K, W) + tail)],
                                   1).reshape((K * 2 * W,) + tail)
            else:
                rl_s, gh_s, gat = full_stream(row_leaf)
                hist2w = hist_raw_for(kernel_ids(slots2w, -2), rl_s,
                                      gh_s, row_gather=gat)
            bs = best_for(hist_finish(hist2w), depth2w, valid2w, s2f, t,
                          leaf_lo, leaf_hi)

        bs_gain.view(-1)[s2f] = bs["gain"]
        bs_gain[:, DUMMY_LEAF].fill_(NEG_INF)
        bs_feat.view(-1)[s2f] = bs["feature"]
        bs_thr.view(-1)[s2f] = bs["threshold"]
        bs_dl.view(-1)[s2f] = bs["default_left"]
        bs_cat.view(-1)[s2f] = bs["is_cat_split"]
        bs_left.view(K * L1, HIST_CH)[s2f] = bs["left_sum"]
        bs_right.view(K * L1, HIST_CH)[s2f] = bs["right_sum"]
        bs_bits.view(K * L1, BW)[s2f] = bs["cat_bitset"]
        bs_lout.view(-1)[s2f] = bs["left_out"]
        bs_rout.view(-1)[s2f] = bs["right_out"]

    return t, row_leaf, tuple(valid_row_leaf)

