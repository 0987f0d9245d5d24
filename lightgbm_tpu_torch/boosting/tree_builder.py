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

The single-device options (the JAX package's ``tree_builder.py:316-
783``, ``:1298-1591``, ``:1697-1704``): per-node feature sampling and
interaction constraints give each slot its own [S, F] feature mask,
which kernel B2 takes as it is; extra-trees draws one threshold per
(slot, feature) and feature_contri and CEGB rescale and lower the gains,
all on the two-pass arm. The draws are the JAX package's threefry
``uniform`` at its shapes, one key per class (``rng_key`` [K, 2]).
Intermediate and advanced monotone constraints keep each leaf's bin box
and grow one split a round: intermediate pushes each new output onto
the leaves adjacent along a monotone feature and clamps stale cached
outputs; advanced recomputes per-threshold bounds over the live leaves
(B1). Forced splits (one class, one split a round) apply a BFS list of
(feature, bin) nodes from the slot's histogram, their slots resolved on
the device, so a dropped node drops its subtree. CEGB (one class)
carries the used features, and with lazy costs the rows' paid features,
from tree to tree.

The parallel learners (``comm``, ``parallel_mode``, ``hist_merge``,
``top_k``; the JAX package's ``tree_builder.py:388-620``, ``:829-870``):
each rank of ``comm`` (``parallel/comms.py``) holds its own rows and
runs kernel B1 on them; the fused arm and B3 are off, as the JAX gates
keep them to builds without a merge (``:501-506``, ``:1895-1906``).

- ``data`` with ``allreduce``: the local histograms merge after B1
  (``ops.histogram.merge_histograms``) and every rank runs the same
  split search on the full sums.
- ``data`` with ``reduce_scatter``: each rank receives its F_pad/W
  feature-slot block of the merged sums, searches only it, and the
  winners merge in ``_sync_best`` (max gain, then the lowest rank, then
  a masked sum of the winner's fields); the subtraction cache holds the
  rank's block. Under EFB the scatter runs along the BUNDLE axis and
  each rank unbundles its block (``unbundle_shard``): a feature-space
  scatter would not be bit-stable (the most-frequent bin is rebuilt by
  a difference).
- ``feature``: every rank holds every row and histograms its F_pad/W
  feature block; no histogram crosses ranks, only the winners.
- ``voting``: local histograms; each rank votes its top-``top_k``
  features a slot, the votes are summed, and only the elected 2*top_k
  columns merge, under the same ``hist_merge`` choice.

The smaller child of each split is chosen from the global row counts,
so every rank streams the same child. The root's sums come from global
feature 0's merged column, broadcast by the rank that holds it, so
every rank holds the same tree.

Not ported (``build_tree`` raises): the native CPU partition
(``hist_perm_for``) and linear trees.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from ..ops import cuda_histogram as CH
from ..ops import threefry
from ..ops.histogram import HIST_CH, merge_histograms
from ..ops.predict import feature_bins
from ..phases import WINNER_SYNC
from ..ops.split import (NEG_INF, SplitParams, calc_output,
                         find_best_splits, leaf_gain, leaf_output,
                         monotone_penalty_factor)

__all__ = ["TreeArrays", "build_tree", "build_tree_class_batched",
           "max_rounds_for", "slot_feature_masks", "tree_draws",
           "unbundle_histograms"]

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
    root split is then found two-pass on it. ``rng_key`` [2] is the
    tree's key. With ``cegb`` the result has a fourth member, the
    model-level CEGB state after this tree (features used, and the
    rows' paid features or None).
    """
    if kw.get("rng_key") is not None:
        kw["rng_key"] = kw["rng_key"][None]
    t, rl, vrls, *cegb_out = _grow(
        bins, gh[None], row_leaf0, num_bins_pf, nan_bin_pf, is_cat_pf,
        feature_mask, root_hist=None if root_hist is None
        else root_hist[None], **kw)
    return (TreeArrays(*(f[0] for f in t)), rl[0],
            tuple(v[0] for v in vrls), *cegb_out)


def build_tree_class_batched(bins: torch.Tensor, gh_k: torch.Tensor,
                             row_leaf0: torch.Tensor, num_bins_pf, nan_bin_pf,
                             is_cat_pf, feature_mask, **kw):
    """Grow the K per-class trees of one iteration together.

    ``gh_k`` is [K, R, 3] (int8 with ``quant_scales`` [K, 2]),
    ``rng_key`` [K, 2] the classes' keys (``_class_batch_keys``,
    gbdt.py:1219-1228); everything else is shared across classes, as
    ``build_tree``'s. The
    K root histograms come from ONE B3 launch that streams ``bins``
    once; on a bundled matrix (``bundle_meta``) B3 is skipped, as the
    JAX gate does (``tree_builder.py:1899-1906``), and the roots are
    one B1 launch of K slots. Returns (TreeArrays with a
    leading K on every field, row_leaf [K, R], tuple of valid
    row_leafs [K, Rv])."""
    root_hist = None
    if kw.get("bundle_meta") is None and kw.get("comm") is None:
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


def tree_draws(rng_key: torch.Tensor, n_keys: int, rows: int, F: int,
               bynode: bool, extra_trees: bool):
    """Every per-node sampling and extra-trees draw of a tree, made at
    once: ``uniform(fold_in(fold_in(rng_key, r), 1 | 2), (rows, F))`` for
    each round key r < ``n_keys`` (0 the root; tree_builder.py:1165,
    :1722), with ``rng_key`` [K, 2] one key a class. Returns (sampling
    draws, threshold draws), each [K, n_keys, rows, F] or None. The draws
    depend on the keys alone, so making them up front gives the bits of
    a draw a round, in two threefry passes instead of one a round."""
    keys = threefry.fold_in(rng_key[:, None, :], torch.arange(
        n_keys, dtype=torch.int32, device=rng_key.device)[None, :])
    return tuple(threefry.uniform(threefry.fold_in(keys, salt), (rows, F))
                 if on else None
                 for salt, on in ((1, bynode), (2, extra_trees)))


def slot_feature_masks(feature_mask: torch.Tensor, slots: torch.Tensor,
                       uniforms: tuple, *,
                       used_feat: Optional[torch.Tensor] = None,
                       interaction_groups: Optional[torch.Tensor] = None,
                       feature_fraction_bynode: float = 1.0,
                       extra_trees: bool = False,
                       nnb_pf: Optional[torch.Tensor] = None,
                       is_cat_pf: Optional[torch.Tensor] = None):
    """Per-slot candidate features and extra-trees thresholds
    (``slot_masks_and_bins``, tree_builder.py:626-658) of K classes'
    local ``slots`` [K, S]: ([K*S, F] bool, [K*S, F] int32 or None).

    ``feature_mask`` [F] is the tree's mask; ``used_feat`` [K, S, F] the
    features on each slot's path (interaction constraints:
    ``interaction_groups`` [G, F] bool, a feature is open when some
    group holds it and every used feature). Per-node sampling keeps the
    ``round(n_tree * feature_fraction_bynode)`` open features of the
    highest draws (col_sampler.hpp:190-205); extra-trees draws one
    threshold per feature among its non-NaN bins (``nnb_pf`` [F]).
    ``uniforms`` = (sampling draws, threshold draws), each [K, S, F] or
    None: the first S rows of the round's :func:`tree_draws`."""
    K, S = slots.shape
    F = feature_mask.shape[0]
    f32 = torch.float32
    fm = feature_mask[None, None, :].expand(K, S, F)
    if interaction_groups is not None:
        # a group is open iff no used feature lies outside it
        viol = (used_feat[:, :, None, :]
                & ~interaction_groups[None, None]).any(-1)      # [K, S, G]
        allowed = ((~viol)[:, :, :, None]
                   & interaction_groups[None, None]).any(2)
        fm = fm & allowed
    if feature_fraction_bynode < 1.0:
        n_tree = feature_mask.sum().to(f32)
        n_allow = fm.sum(-1).to(f32)                            # [K, S]
        k = torch.floor(n_tree * feature_fraction_bynode + 0.5)
        k = torch.minimum(torch.clamp(k, min=1.0), n_allow)
        k = torch.maximum(k, torch.clamp(n_allow, max=1.0)).to(torch.int64)
        score = torch.where(fm, uniforms[0], -1.0)
        kth = torch.gather(torch.sort(score, dim=-1, descending=True).values,
                           -1, (k - 1).clamp(min=0)[..., None])
        fm = fm & (score >= kth)
    rand_bin = None
    if extra_trees:
        u2 = uniforms[1]
        n_opt = torch.where(is_cat_pf.to(torch.bool),
                            torch.clamp(nnb_pf, min=1),
                            torch.clamp(nnb_pf - 1, min=1)).to(f32)
        rand_bin = torch.floor(u2 * n_opt).to(torch.int32).reshape(K * S, F)
    return fm.reshape(K * S, F), rand_bin


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
          bundle_bins: int = 0,
          interaction_groups: Optional[torch.Tensor] = None,
          rng_key: Optional[torch.Tensor] = None,
          feature_fraction_bynode: float = 1.0,
          gain_scale: Optional[torch.Tensor] = None,
          cegb: Optional[tuple] = None, mono_method: str = "basic",
          forced: Optional[tuple] = None, comm=None,
          parallel_mode: str = "data", hist_merge: str = "allreduce",
          top_k: int = 20, **unsupported):
    """The builder over a class axis: gh_k [K, R, 3] (int8 with
    ``quant_scales`` [K, 2]); root_hist [K, F, B, 3] or None (the root
    is then built here: K = 1 as the serial build does, K > 1 by one
    B1 launch of K slots over the folded stream). ``bundle_meta`` =
    (bundle, offset, most-frequent bin) [F] int32 per feature of a
    bundled ``bins``, whose lattice has ``bundle_bins`` bins.
    ``rng_key`` is [K, 2], one key a class; ``cegb`` and ``forced``
    take K = 1 (their callers build per class). ``comm`` (a
    ``parallel.comms.Comm``) runs the build as one rank of the
    ``parallel_mode`` learner (the module docstring)."""
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
    use_mono_inter = use_mono and mono_method == "intermediate"
    use_mono_adv = use_mono and mono_method == "advanced"
    use_boxes = use_mono_inter or use_mono_adv
    use_forced = forced is not None and len(forced[0]) > 0
    if (use_boxes or use_forced) and leaf_batch != 1:
        raise ValueError("intermediate/advanced monotone constraints and "
                         "forced splits need leaf_batch=1 (one split "
                         "applied at a time)")
    use_inter = interaction_groups is not None
    use_bynode = feature_fraction_bynode < 1.0
    use_rand = bool(sp.extra_trees)
    if (use_bynode or use_rand) and rng_key is None:
        raise ValueError("feature_fraction_bynode/extra_trees need rng_key")
    use_cegb = cegb is not None
    if (use_cegb or use_forced) and K != 1:
        raise ValueError("CEGB and forced splits build one class at a time")
    use_bundle = bundle_meta is not None
    # the parallel learners (tree_builder.py:388-470)
    mode = parallel_mode if comm is not None else "data"
    n_sh = comm.world_size if comm is not None else 1
    me = comm.rank if comm is not None else 0
    rs = comm is not None and hist_merge == "reduce_scatter" and n_sh > 1
    rs_data = rs and mode == "data"
    rs_vote = rs and mode == "voting"
    if comm is not None:
        if use_cegb:
            raise NotImplementedError(
                "CEGB is single-device only (the reference ties it to "
                "the serial tree learner too)")
        if rs_data and use_forced:
            raise ValueError(
                "forced splits need hist_merge=allreduce under "
                "tree_learner=data (full-feature histogram gather)")
        if use_forced and mode != "data":
            raise NotImplementedError(
                "forced splits read full-feature histograms; under "
                f"tree_learner={mode} a rank holds only its own block "
                "(ROADMAP A)")
        if use_bundle and mode == "feature":
            raise ValueError(
                "feature-parallel requires an unbundled bin matrix "
                "(caller must decode EFB storage first)")
        comm.begin_tree()
    # the fused arm's epilogue scans the feature-space lattice in the
    # kernel with a per-slot mask and per-slot bounds: EFB, sorted-subset
    # categoricals, extra-trees thresholds, gain scales and penalties,
    # advanced monotone bounds and forced gathers need the full
    # histogram (the JAX gate, tree_builder.py:501-507)
    use_fused = (bool(fused_split) and bundle_meta is None
                 and comm is None
                 and cat_sorted_mask is None and not use_rand
                 and not use_cegb and not use_forced and not use_mono_adv
                 and gain_scale is None)
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

    nb_in = bundle_bins if use_bundle else B

    def padf(a, n, v):
        """Pad the last axis of ``a`` to ``n`` with ``v``."""
        return torch.nn.functional.pad(a, (0, n - a.shape[-1]), value=v)

    # the feature and (unbundled) reduce-scatter learners' block: this
    # rank's [f0, f0 + F_loc) of the feature axis padded to a multiple
    # of the world size; pad features are trivial (1 bin, masked out)
    # and never selected (tree_builder.py:404-416)
    F_loc = -(-F // n_sh)
    f0 = me * F_loc

    def feat_block(a, v):
        """A per-feature array [..., F] at this rank's feature block,
        padded with ``v``."""
        return padf(a, F_loc * n_sh, v)[..., f0:f0 + F_loc]

    mat = bins
    if mode == "feature":
        mat = feat_block(bins, 0).contiguous()
        loc_nbpf = feat_block(num_bins_pf, 1)
        loc_nan = feat_block(nan_bin_pf, -1)
        loc_cat = feat_block(is_cat_pf.to(torch.bool), False)
        loc_fmask = feat_block(feature_mask.to(torch.bool), False)
    elif rs_data and use_bundle:
        # EFB: the scatter slots along the bundle axis; this rank owns
        # bundle columns [gl0, gl0 + G_loc) and their features
        G_loc = -(-bins.shape[1] // n_sh)
        gl0 = me * G_loc
        b_gof = bundle_meta[0]
        rs_own = (b_gof >= gl0) & (b_gof < gl0 + G_loc)          # [F]

    def unbundle_shard(hg):
        """``unbundle`` of this rank's [S, G_loc, bb, 3] block of the
        MERGED bundle-space sums (tree_builder.py:432-463): [S, F, B, 3]
        feature space, zero outside the features it owns. The leaf
        totals (bundle column 0's bin sum) are broadcast by rank 0,
        bundle 0's owner, so every rebuilt value has the bits the
        allreduce path gives it."""
        S = hg.shape[0]
        dev_ = hg.device
        b_off, b_mfb = bundle_meta[1].long(), bundle_meta[2].long()
        bi = torch.arange(B, dtype=torch.int64, device=dev_)
        gof_loc = (b_gof.long() - gl0).clamp(0, G_loc - 1)
        idx = (gof_loc[:, None] * nb_in + b_off[:, None]
               + bi[None, :]).clamp(0, G_loc * nb_in - 1)
        bvalid = ((bi[None, :] < num_bins_pf.long()[:, None])
                  & rs_own[:, None])[None, :, :, None]
        zero = torch.zeros((), dtype=hg.dtype, device=dev_)
        hf = hg.reshape(S, -1, HIST_CH)[:, idx.reshape(-1)].reshape(
            S, F, B, HIST_CH)
        hf = torch.where(bvalid, hf, zero)
        totals = comm.broadcast(_sum(hg[:, 0], 1), src=0,
                                phase="unbundle_totals")
        mfb_oh = (bi[None, :] == b_mfb[:, None])[None, :, :, None]
        sum_all = _sum(hf, 2)
        at_mfb = _sum(torch.where(mfb_oh, hf, zero), 2)
        mfb_val = totals[:, None, :] - (sum_all - at_mfb)
        return torch.where(mfb_oh & bvalid, mfb_val[:, :, None, :], hf)

    def hist_finish(hraw):
        """Raw -> per-feature f32 split-finding space (hist_finish,
        tree_builder.py:580-590): descale, then unbundle (this rank's
        bundle block under reduce-scatter)."""
        h = dequant(hraw)
        if not use_bundle:
            return h
        if rs_data:
            return unbundle_shard(h)
        return unbundle_histograms(h, bundle_meta, nb_in, num_bins_pf, B)

    def hist_raw_for(slots, rl, gh_in, row_gather=None, num_rows=None):
        """The RAW histogram of ``slots``: bundle space under EFB, int32
        when quantized; parent-minus-child subtraction happens here.
        The data learner merges it across ranks (its block only, under
        reduce-scatter); the feature and voting learners keep it local
        (tree_builder.py:556-578)."""
        h = CH.build_histograms_cuda(
            mat, gh_in, rl, slots, num_bins=nb_in, hist_dtype=hist_dtype,
            row_gather=row_gather, num_rows=num_rows)
        if comm is None or mode != "data":
            return h
        return merge_histograms(
            h, comm, "reduce_scatter" if rs_data else "allreduce")

    def _sync_best(bs):
        """Merge the ranks' best splits (SyncUpGlobalBestSplit,
        parallel_tree_learner.h:209; tree_builder.py:594-620): the
        largest gain, ties to the lowest rank, and that rank's fields
        by a masked sum, all fields packed into one f64 all-reduce
        (ints, bools, f32 and the uint32 bitset words are exact in
        f64)."""
        from .. import profiler
        with profiler.phase(WINNER_SYNC):
            gain = bs["gain"]
            gmax = comm.all_reduce(gain, "max", phase=WINNER_SYNC)
            mine = torch.where((gain == gmax) & torch.isfinite(gain),
                               torch.full_like(gain, me, dtype=i32),
                               torch.full_like(gain, 1 << 30, dtype=i32))
            win = comm.all_reduce(mine, "min", phase=WINNER_SYNC)
            is_win = (win == me)[:, None]
            keys = [k for k in bs if k != "gain"]
            cols = [bs[k].reshape(gain.shape[0], -1) for k in keys]
            # -0.0 is the additive identity (x + -0.0 == x, -0.0 too):
            # the winner's fields arrive with every bit, sign included
            packed = torch.cat([torch.where(is_win, c.to(torch.float64),
                                            -0.0) for c in cols], 1)
            packed = comm.all_reduce(packed, "sum", phase=WINNER_SYNC)
            out, o = {}, 0
            for k, c in zip(keys, cols):
                v = packed[:, o:o + c.shape[1]]
                o += c.shape[1]
                v = v > 0 if bs[k].dtype == torch.bool else v.to(
                    bs[k].dtype)
                out[k] = v.reshape(bs[k].shape)
            out["gain"] = gmax
            return out

    def gather_slots(a, slots):
        """a [K, L1, ...] per-class leaf state at local ``slots`` [K, S]
        -> [K, S, ...]."""
        tail = tuple(a.shape[2:])
        ix = slots.long().reshape(slots.shape + (1,) * len(tail))
        return torch.gather(a, 1, ix.expand(slots.shape + tail))

    nnb_pf = num_bins_pf - (nan_bin_pf >= 0).to(i32)

    u_draws = (tree_draws(rng_key, max_rounds_for(L, W) + 1, 2 * W, F,
                          use_bynode, use_rand)
               if rng_key is not None else (None, None))

    def slot_masks_and_bins(slots, r_key):
        """The local ``slots`` [K, S]' masks and thresholds, from the
        current ``used_feat`` and the draws of key ``r_key``."""
        S = slots.shape[1]
        return slot_feature_masks(
            feature_mask, slots, tuple(
                None if u is None else u[:, r_key, :S] for u in u_draws),
            used_feat=gather_slots(used_feat, slots) if use_inter else None,
            interaction_groups=interaction_groups,
            feature_fraction_bynode=feature_fraction_bynode,
            extra_trees=use_rand, nnb_pf=nnb_pf, is_cat_pf=is_cat_pf)

    if use_cegb:
        (c_trade, c_split, c_coupled, c_lazy, cegb_feat_used,
         cegb_used_rows) = cegb
        cegb_feat_used = cegb_feat_used.clone()
        if c_lazy is not None:
            cegb_used_rows = cegb_used_rows.clone()

    def cegb_penalty_for(slots, rl, t):
        """[S, F] CEGB DeltaGain (cegb_penalty_for,
        tree_builder.py:660-684; cost_effective_gradient_boosting.hpp:
        80-98) of the local ``slots`` [1, S]: the split cost scaled by
        the leaf's count, the coupled cost of a feature no tree used
        yet, the lazy cost of the leaf's rows that have not paid for the
        feature. The lazy per-leaf sums run in row order on the CPU (as
        the JAX package's segment_sum); on CUDA each leaf's count of
        unpaid rows is summed exactly in int32 and scaled by the cost
        once, so the sums are deterministic without a sort of the [R, F]
        costs (they may differ from the row-order sums by f32
        rounding)."""
        s0 = slots[0].long()
        n_leaf = t.node_count[0][t.leaf2node[0][s0].long()]
        delta = (c_trade * c_split * n_leaf)[:, None] * torch.ones(
            (1, F), dtype=f32, device=dev)
        if c_coupled is not None:
            delta = delta + c_trade * torch.where(
                cegb_feat_used[None, :], 0.0, c_coupled[None, :])
        if c_lazy is not None:
            seg = torch.where(rl[0] < 0, L, rl[0]).long()
            if dev.type == "cuda":
                cnt = torch.zeros((L1, F), dtype=i32, device=dev)
                cnt.index_add_(0, seg, (~cegb_used_rows).to(i32))
                per_leaf = cnt.to(f32) * c_lazy[None, :]
            else:
                unused = torch.where(cegb_used_rows, 0.0, c_lazy[None, :])
                per_leaf = torch.zeros((L1, F), dtype=f32,
                                       device=dev).index_add_(0, seg, unused)
            delta = delta + c_trade * per_leaf[s0.clamp(0, L)]
        return delta

    if use_mono_adv:
        m_pos = mono_type_pf > 0
        m_neg = mono_type_pf < 0
        t_io = ar(B)
        cat_q = is_cat_pf.to(torch.bool)[None, None, None, :, None]

    def adv_bounds_for(slots, t):
        """Advanced monotone bounds of the local ``slots`` [K, S]
        (adv_bounds_for, tree_builder.py:687-783): ((lo_l, hi_l, lo_r,
        hi_r) [K*S, F, B], lo_s, hi_s [K*S]), recomputed from the live
        leaves' outputs and boxes. A live leaf separated from the slot's
        box along exactly one monotone dim bounds the candidate children
        whose box still faces it; the [K, S, V, F, B] reduction over
        the leaves V runs in chunks of leaves (min/max carried), so its
        temporaries stay near 2^23 cells."""
        S = slots.shape[1]
        v_out = t.leaf_values                                    # [K, V]
        live = t.leaf2node != DUMMY_NODE
        s_lo = gather_slots(box_lo, slots)                       # [K, S, F]
        s_hi = gather_slots(box_hi, slots)
        ovl = ((box_lo[:, None] <= s_hi[:, :, None])
               & (s_lo[:, :, None] <= box_hi[:, None]))          # [K,S,V,F]
        nno = (~ovl).sum(3)
        selfm = slots[:, :, None] == ar(L1)[None, None, :]
        base = (nno == 1) & live[:, None, :] & ~selfm            # [K, S, V]
        above = box_lo[:, None] > s_hi[:, :, None]
        below = box_hi[:, None] < s_lo[:, :, None]
        sep = base[..., None] & ~ovl
        hi_d = sep & ((above & m_pos) | (below & m_neg))
        lo_d = sep & ((below & m_pos) | (above & m_neg))
        Vc = max(1, min(L1, (1 << 23) // max(1, K * S * F * B)))

        def reduce_bounds(mask_d, lowest, init):
            red = torch.minimum if lowest else torch.maximum
            cnt = mask_d.sum(3, dtype=i32)                       # [K, S, V]
            any_ex = (cnt[..., None] - mask_d.to(i32)) > 0
            b_l = full((K, S, F, B), init, f32)
            b_r = full((K, S, F, B), init, f32)
            b_s = full((K, S), init, f32)
            for v0 in range(0, L1, Vc):
                md = mask_d[:, :, v0:v0 + Vc]
                ae = any_ex[:, :, v0:v0 + Vc]
                blo = box_lo[:, None, v0:v0 + Vc, :, None]
                bhi = box_hi[:, None, v0:v0 + Vc, :, None]
                vo = v_out[:, None, v0:v0 + Vc]                  # [K, 1, Vc]
                l_ok = (blo <= t_io) | cat_q
                r_ok = (bhi >= t_io + 1) | cat_q
                m_l = md[..., None] | (ae[..., None] & l_ok)
                m_r = md[..., None] | (ae[..., None] & r_ok)

                def agg(m, vals):
                    x = torch.where(m, vals, init)
                    return x.amin(2) if lowest else x.amax(2)
                b_l = red(b_l, agg(m_l, vo[..., None, None]))
                b_r = red(b_r, agg(m_r, vo[..., None, None]))
                b_s = red(b_s, agg(md.any(3), vo))
            return b_l, b_r, b_s
        hi_l, hi_r, hi_s = reduce_bounds(hi_d, True, F32_MAX)
        lo_l, lo_r, lo_s = reduce_bounds(lo_d, False, -F32_MAX)
        adv = tuple(a.reshape(K * S, F, B) for a in (lo_l, hi_l, lo_r, hi_r))
        return adv, lo_s.reshape(-1), hi_s.reshape(-1)

    def best_for(hist, slot_depth, slot_valid, slots, t, leaf_lo, leaf_hi,
                 r_key, rl):
        """find_best_splits over the local ``slots`` [K, S], folded
        class-major (best_for, tree_builder.py:784)."""
        slots_f = fold(slots, L1).reshape(-1)
        lo = leaf_lo.view(-1)[slots_f] if use_mono else None
        hi = leaf_hi.view(-1)[slots_f] if use_mono else None
        adv = None
        if use_mono_adv:
            adv, lo, hi = adv_bounds_for(slots, t)
        parent_out = t.node_value.view(-1)[
            fold(t.leaf2node.view(-1)[slots_f].view(K, -1), N1).reshape(-1)]
        fmask_s, rand_bin = slot_masks_and_bins(slots, r_key)
        common = dict(leaf_lo=lo, leaf_hi=hi, parent_output=parent_out,
                      slot_depth=slot_depth)
        if mode == "feature" or (rs_data and not use_bundle):
            # the search over this rank's feature block: the masks, draws
            # and bounds are the same on every rank, each takes its
            # window (tree_builder.py:801-836, :922-955)
            def blk(a, v):
                return None if a is None else feat_block(a, v)
            csm = blk(cat_sorted_mask, False)
            kw_s = ({} if csm is None else
                    dict(cat_sorted_mask=csm,
                         max_sorted_bins=max_sorted_bins))
            if mode == "feature":
                meta = (loc_nbpf, loc_nan, loc_cat)
                fm = blk(fmask_s, False) & loc_fmask[None, :]
            else:
                meta = (blk(num_bins_pf, 1), blk(nan_bin_pf, -1),
                        blk(is_cat_pf.to(torch.bool), False))
                fm = blk(fmask_s, False)
            bs = find_best_splits(
                hist, *meta, sp, feature_mask=fm,
                mono_type=blk(mono_type_pf, 0), rand_bin=blk(rand_bin, 0),
                adv_bounds=(None if adv is None else tuple(
                    blk(a.transpose(1, 2), 0).transpose(1, 2)
                    for a in adv)), **common, **kw_s)
            bs["feature"] = bs["feature"] + f0
        elif mode == "voting":
            bs = vote_best(hist, fmask_s, rand_bin, adv, common)
        else:
            if rs_data:
                # scattered EFB block: unbundled to full feature space,
                # zero outside the owned features, searched with the
                # ownership mask (tree_builder.py:908-921)
                fmask_s = fmask_s & rs_own[None, :]
            bs = find_best_splits(
                hist, num_bins_pf, nan_bin_pf, is_cat_pf, sp,
                feature_mask=fmask_s, mono_type=mono_type_pf,
                rand_bin=rand_bin, gain_scale=gain_scale,
                gain_penalty=(cegb_penalty_for(slots, rl, t) if use_cegb
                              else None),
                adv_bounds=adv, **common, **sorted_kw)
        g = bs["gain"]
        if max_depth > 0:
            g = torch.where(slot_depth < max_depth, g, NEG_INF)
        bs["gain"] = torch.where(slot_valid, g, NEG_INF)
        if mode == "feature" or rs_data or rs_vote:
            bs = _sync_best(bs)
        return bs

    def vote_best(hist, fmask_s, rand_bin, adv, common):
        """PV-Tree's search (tree_builder.py:837-906): local gains per
        (slot, feature), one ballot for each of a slot's top-k viable
        features, the ballots summed over ranks, the global top-2k
        elected (ties to the lower feature id), and only their columns
        merged, slot-sharded under reduce-scatter."""
        S = hist.shape[0]
        fg = find_best_splits(
            hist, num_bins_pf, nan_bin_pf, is_cat_pf, sp,
            feature_mask=fmask_s, mono_type=mono_type_pf,
            rand_bin=rand_bin, adv_bounds=adv, return_feature_gain=True,
            **common, **sorted_kw)["feature_gain"]                # [S, F]
        k, k2 = min(top_k, F), min(2 * top_k, F)
        # lax.top_k order: descending, ties to the lower index
        top = torch.sort(fg, dim=1, descending=True, stable=True)
        votes = torch.zeros((S, F), dtype=f32, device=dev).scatter_add_(
            1, top.indices[:, :k], (top.values[:, :k] > NEG_INF).to(f32))
        votes = comm.all_reduce(votes, "sum", phase="vote")
        score = votes * (F + 1.0) - ar(F, f32)[None, :]
        elected = torch.sort(score, dim=1, descending=True,
                             stable=True).indices[:, :k2]
        sub = torch.gather(hist, 1, elected[:, :, None, None].expand(
            S, k2, hist.shape[2], HIST_CH))
        lane_ok = None
        if rs_vote:
            k2p = -(-k2 // n_sh) * n_sh
            k2_loc = k2p // n_sh
            o = me * k2_loc
            sub = merge_histograms(sub, comm, "reduce_scatter")
            # a pad lane points at feature 0 with its mask off (its
            # scattered block is zero anyway)
            elected = padf(elected, k2p, 0)[:, o:o + k2_loc]
            lane_ok = (ar(k2p) < k2)[o:o + k2_loc][None, :]
        else:
            sub = merge_histograms(sub, comm, "allreduce")
        el = elected.long()
        fm = torch.gather(fmask_s, 1, el)
        if lane_ok is not None:
            fm = fm & lane_ok
        kw_s = ({} if cat_sorted_mask is None else
                dict(cat_sorted_mask=cat_sorted_mask[el],
                     max_sorted_bins=max_sorted_bins))
        bs = find_best_splits(
            sub, num_bins_pf[el], nan_bin_pf[el], is_cat_pf[el], sp,
            feature_mask=fm,
            mono_type=None if mono_type_pf is None else mono_type_pf[el],
            rand_bin=(None if rand_bin is None
                      else torch.gather(rand_bin, 1, el)),
            adv_bounds=(None if adv is None else tuple(
                torch.gather(a, 1, el[:, :, None].expand(
                    S, el.shape[1], a.shape[2])) for a in adv)),
            **common, **kw_s)
        bs["feature"] = torch.gather(
            elected, 1, bs["feature"][:, None].long())[:, 0].to(i32)
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
    if use_boxes:
        # each leaf's inclusive bin box in feature space
        box_lo = full((K, L1, F), 0, i32)
        box_hi = full((K, L1, F), B - 1, i32)
    if use_inter:
        used_feat = full((K, L1, F), False, torch.bool)
    if use_forced:
        # each forced node's record: applied, at which slot, and the
        # slot its right child received
        f_parent, f_isright, f_feats, f_thrs, f_iscat = forced
        n_forced = len(f_parent)
        f_ok = full((n_forced,), False, torch.bool)
        f_slot_rec = full((n_forced,), 0, i32)
        f_rslot = full((n_forced,), 0, i32)

    def forced_round(r, t, row_leaf, cur, leaf_depth, sel_s, valid, sfeat,
                     sthr, sdl, scat, sgain, slsum, srsum, sbits, lval,
                     rval):
        """Round r's forced node (K = W = 1): its slot resolves from its
        parent's record, its sums come from that slot's histogram
        (GatherInfoForThreshold: missing values go left with
        default_left, a categorical node is one-hot on its category),
        and lane 0 takes it where it passes the node's checks. The
        round's records are written in place."""
        pj, is_r = f_parent[r], f_isright[r]
        f_feat, f_thr, f_cat = f_feats[r], f_thrs[r], f_iscat[r]
        if pj < 0:
            parent_ok = torch.ones((), dtype=torch.bool, device=dev)
            f_slot = torch.zeros((), dtype=i32, device=dev)
        else:
            parent_ok = f_ok[pj]
            f_slot = (f_rslot if is_r else f_slot_rec)[pj]
        # [1]-shaped indices throughout: indexing with a 0-d tensor
        # reads it on the host
        fs = f_slot.clamp(0, L).long().reshape(1)
        if hist_sub:
            # the forced leaf's histogram is in the cache
            hfs = hist_finish(hist_cache.index_select(0, fs))[0]
        else:
            fslots = full((2 * W,), -2, i32)
            fslots[0] = f_slot
            hfs = hist_finish(hist_raw_for(fslots, row_leaf[0],
                                           gh_k[0]))[0]
        hrow = hfs[f_feat]                                       # [B, 3]
        nb_f = nan_bin_pf[f_feat]
        bval = ar(B) != torch.where(nb_f >= 0, nb_f, -1)
        tc = min(max(f_thr, 0), B - 1)
        if f_cat:
            lsum = hrow[tc]
        else:
            # the right side accumulates from the top bin down, skipping
            # the NaN bin: missing rows land left
            cum = torch.cumsum(torch.where(bval[:, None], hrow, 0.0), 0)
            nan_row = torch.where(nb_f >= 0, hrow.index_select(
                0, nb_f.clamp(0, B - 1).long().reshape(1))[0], 0.0)
            lsum = cum[tc] + nan_row
        tot = hrow.sum(0)
        rsum = tot - lsum
        l1, l2, mds = sp.lambda_l1, sp.lambda_l2, sp.max_delta_step
        node_f = t.leaf2node[0].index_select(0, fs)              # [1]
        sm = {}
        if use_smooth:
            sm = dict(path_smooth=sp.path_smooth,
                      parent_output=t.node_value[0].index_select(
                          0, node_f.long())[0])
        f_lout = calc_output(lsum[0], lsum[1], l1, l2, mds,
                             count=lsum[2] if sm else None, **sm)
        f_rout = calc_output(rsum[0], rsum[1], l1, l2, mds,
                             count=rsum[2] if sm else None, **sm)
        # net gain; at or below zero the node is dropped (hpp:562)
        f_gain = (leaf_gain(lsum[0], lsum[1], l1, l2)
                  + leaf_gain(rsum[0], rsum[1], l1, l2)
                  - leaf_gain(tot[0], tot[1], l1, l2)
                  - sp.min_gain_to_split)
        md, mh = sp.min_data_in_leaf, sp.min_sum_hessian_in_leaf
        # (cur < L) stands for the JAX loop's budget stop
        ok_f = (parent_ok & (lsum[2] >= md) & (rsum[2] >= md)
                & (lsum[1] >= mh) & (rsum[1] >= mh) & (f_gain > 0)
                & (node_f[0] != DUMMY_NODE) & (cur[0] < L))
        if max_depth > 0:
            ok_f = ok_f & (leaf_depth[0].index_select(0, fs)[0] < max_depth)
        if f_cat and f_thr < 0:
            ok_f = ok_f & False          # a category unseen in training
        f_ok[r] = ok_f
        f_slot_rec[r] = f_slot
        f_rslot[r] = cur[0]
        f_bits = full((BW,), 0, i64)
        if f_cat and f_thr >= 0:
            f_bits[f_thr >> 5].fill_(1 << (f_thr & 31))

        def ov(a, v):
            return torch.where(ok_f, v, a)
        return (ov(sel_s, f_slot), valid | ok_f, ov(sfeat, f_feat),
                ov(sthr, f_thr), ov(sdl, not f_cat), ov(scat, f_cat),
                ov(sgain, f_gain), ov(slsum, lsum), ov(srsum, rsum),
                ov(sbits, f_bits), ov(lval, f_lout), ov(rval, f_rout))

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
            fmask0, _ = slot_masks_and_bins(root_c[None], 0)
            bs0, hraw0 = fused_call(
                root_slots, fmask0, full((2 * W,), 0, i32),
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
        if mode == "voting":
            # local histograms: the global root sums are their sum
            # (the Allreduce of data_parallel_tree_learner.cpp:160-219)
            root_sums = comm.all_reduce(root_sums, "sum", phase="root_sums")
        elif mode == "feature" or rs_data:
            # one rank holds global feature 0's column (its bundle's
            # owner under EFB) and broadcasts its sums
            # (tree_builder.py:1221-1237)
            owner = (int(bundle_meta[0][0]) // G_loc
                     if rs_data and use_bundle else 0)
            root_sums = comm.broadcast(root_sums, src=owner,
                                       phase="root_sums")
    root_val = leaf_output(root_sums[:, 0], root_sums[:, 1], sp.lambda_l1,
                           sp.lambda_l2, sp.max_delta_step)
    t.node_value[:, 0] = root_val
    t.node_count[:, 0] = root_sums[:, 2]
    t.node_hess[:, 0] = root_sums[:, 1]
    t.leaf_values[:, 0] = root_val
    if bs0 is None and (root_hist is not None or K > 1):
        # one slot a class: the first row of the root's draws
        bs0 = best_for(hist_finish(hroot), full((K,), 0, i32),
                       torch.ones(K, dtype=torch.bool, device=dev),
                       full((K, 1), 0, i32), t, leaf_lo, leaf_hi, 0,
                       row_leaf)
    elif bs0 is None:
        slot_valid0 = torch.zeros(2 * W, dtype=torch.bool, device=dev)
        slot_valid0[0].fill_(True)
        bs0 = best_for(hist_finish(hraw0), full((2 * W,), 0, i32),
                       slot_valid0, root_c[None], t, leaf_lo, leaf_hi, 0,
                       row_leaf)
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
    # A fixed number of rounds: the JAX loop's stop conditions (no leaf
    # budget, no finite cached gain) leave a round a masked no-op here.
    # Its ``r < n_forced`` clause (tree_builder.py:1261-1264), which runs
    # a forced round even when no cached split is finite, needs no
    # counterpart: every round runs, and round r < n_forced applies its
    # forced node whenever the node's own checks (and the leaf budget)
    # pass.
    for r in range(max_rounds_for(L, W)):
        if comm is not None:
            comm.round = r
        cur = t.num_leaves
        nodes = t.num_nodes
        # -- 1. pop each class's top-W cached splits (ties to the lower
        #    slot, as lax.top_k)
        srt = torch.sort(bs_gain[:, :L], dim=1, descending=True,
                         stable=True)
        gains = srt.values[:, :W]
        sel = srt.indices[:, :W].to(i32)
        valid = torch.isfinite(gains) & (iw < (L - cur)[:, None])
        sel_s = torch.where(valid, sel, DUMMY_LEAF)
        sl = fold(sel_s, L1)
        sfeat, sthr = bs_feat.view(-1)[sl], bs_thr.view(-1)[sl]
        sdl, scat = bs_dl.view(-1)[sl], bs_cat.view(-1)[sl]
        sgain = bs_gain.view(-1)[sl]
        slsum = bs_left.view(K * L1, HIST_CH)[sl]
        srsum = bs_right.view(K * L1, HIST_CH)[sl]
        sbits = bs_bits.view(K * L1, BW)[sl]
        lval, rval = bs_lout.view(-1)[sl], bs_rout.view(-1)[sl]

        if use_forced and r < n_forced:
            # ForceSplits (tree_builder.py:1298-1430): lane 0 takes the
            # forced node computed from its slot's histogram; a dropped
            # node keeps this round's normal pop and poisons its forced
            # descendants
            (sel_s, valid, sfeat, sthr, sdl, scat, sgain, slsum, srsum,
             sbits, lval, rval) = forced_round(
                r, t, row_leaf, cur, leaf_depth, sel_s, valid, sfeat, sthr,
                sdl, scat, sgain, slsum, srsum, sbits, lval, rval)
            sel_s = torch.where(valid, sel_s, DUMMY_LEAF)
            sl = fold(sel_s, L1)
        vi = valid.to(i32)
        n_valid = vi.sum(dim=1, dtype=i32)
        pos = torch.cumsum(vi, 1, dtype=i32) - 1
        right_slot = torch.where(valid, cur[:, None] + pos,
                                 DUMMY_LEAF).to(i32)
        ln = torch.where(valid, nodes[:, None] + 2 * pos, DUMMY_NODE).to(i32)
        rn = torch.where(valid, nodes[:, None] + 2 * pos + 1,
                         DUMMY_NODE).to(i32)
        rsl = fold(right_slot, L1)
        parent = fold(torch.where(valid, t.leaf2node.view(-1)[sl],
                                  DUMMY_NODE), N1)
        lnf, rnf = fold(ln, N1), fold(rn, N1)

        if use_mono_inter:
            # stale cache: neighbours may have tightened this leaf's
            # bounds since its split was cached (tree_builder.py:
            # 1431-1439)
            lo_s, hi_s = leaf_lo.view(-1)[sl], leaf_hi.view(-1)[sl]
            lval = torch.minimum(torch.maximum(lval, lo_s), hi_s)
            rval = torch.minimum(torch.maximum(rval, lo_s), hi_s)
        if use_mono_adv:
            # the winner's bounds recomputed against the current outputs
            # (tree_builder.py:1440-1466)
            advw, lo_sw, hi_sw = adv_bounds_for(sel_s, t)
            fw = sfeat.reshape(-1).long()
            tw = sthr.reshape(-1).long()
            kw_ = ar(K * W, i64)

            def at_win(a):
                return a[kw_, fw, tw].view(K, W)
            lo_sw, hi_sw = lo_sw.view(K, W), hi_sw.view(K, W)
            lval = torch.minimum(
                torch.maximum(lval, torch.where(scat, lo_sw,
                                                at_win(advw[0]))),
                torch.where(scat, hi_sw, at_win(advw[1])))
            rval = torch.minimum(
                torch.maximum(rval, torch.where(scat, lo_sw,
                                                at_win(advw[2]))),
                torch.where(scat, hi_sw, at_win(advw[3])))
            # the split feature's own direction, if clamping crossed the
            # pair
            mt_w = mono_type_pf[sfeat.long()]
            lo_pair = torch.minimum(lval, rval)
            hi_pair = torch.maximum(lval, rval)
            lval, rval = (
                torch.where(mt_w > 0, lo_pair,
                            torch.where(mt_w < 0, hi_pair, lval)),
                torch.where(mt_w > 0, hi_pair,
                            torch.where(mt_w < 0, lo_pair, rval)))

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
        if use_mono and not use_boxes:
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
        if use_boxes:
            # the children's boxes (tree_builder.py:1511-1526)
            num_upd = (valid & ~scat)[..., None]
            blo, bhi = box_lo.view(K * L1, F), box_hi.view(K * L1, F)
            par_lo, par_hi = blo[sl], bhi[sl]                    # [K, W, F]
            fone = ar(F)[None, None, :] == sfeat[..., None]
            l_hi = torch.where(fone & num_upd,
                               torch.minimum(par_hi, sthr[..., None]),
                               par_hi)
            r_lo = torch.where(fone & num_upd,
                               torch.maximum(par_lo, sthr[..., None] + 1),
                               par_lo)
            blo[sl] = par_lo
            blo[rsl] = r_lo
            bhi[sl] = l_hi
            bhi[rsl] = par_hi
            box_lo[:, DUMMY_LEAF].fill_(0)
            box_hi[:, DUMMY_LEAF].fill_(B - 1)
        if use_mono_inter:
            # push the new outputs onto every adjacent leaf
            # (tree_builder.py:1527-1570): the right child clones the
            # parent's bounds, then a live leaf separated from a new
            # leaf along exactly one monotone dim absorbs its output
            leaf_lo.view(-1)[rsl] = leaf_lo.view(-1)[sl]
            leaf_hi.view(-1)[rsl] = leaf_hi.view(-1)[sl]
            u_slots = torch.cat([sel_s, right_slot], 1)          # [K, 2W]
            u_out = torch.cat([lval, rval], 1)
            u_ok = torch.cat([valid, valid], 1)
            u_lo = gather_slots(box_lo, u_slots)                 # [K,2W,F]
            u_hi = gather_slots(box_hi, u_slots)
            ovl = ((box_lo[:, None] <= u_hi[:, :, None])
                   & (u_lo[:, :, None] <= box_hi[:, None]))      # [K,2W,V,F]
            nno = (~ovl).sum(3)
            above = box_lo[:, None] > u_hi[:, :, None]
            below = box_hi[:, None] < u_lo[:, :, None]
            m_p = mono_type_pf > 0
            m_n = mono_type_pf < 0
            live = (t.leaf2node != DUMMY_NODE)[:, None, :, None]
            cnd = ((nno == 1)[..., None] & ~ovl
                   & u_ok[:, :, None, None] & live)
            raise_lo = (cnd & ((above & m_p) | (below & m_n))).any(3)
            drop_hi = (cnd & ((below & m_p) | (above & m_n))).any(3)
            leaf_lo = torch.maximum(leaf_lo, torch.where(
                raise_lo, u_out[:, :, None], -F32_MAX).amax(1))
            leaf_hi = torch.minimum(leaf_hi, torch.where(
                drop_hi, u_out[:, :, None], F32_MAX).amin(1))
            leaf_lo[:, DUMMY_LEAF].fill_(-F32_MAX)
            leaf_hi[:, DUMMY_LEAF].fill_(F32_MAX)

        # -- 2c. CEGB: applied splits mark their feature used by the
        #    model (tree_builder.py:1574-1581); interaction constraints:
        #    each child inherits its parent's used features plus the
        #    split's (:1582-1591)
        if use_cegb or use_inter:
            fbit = ((ar(F)[None, None, :] == sfeat[..., None])
                    & valid[..., None])
        if use_cegb:
            cegb_feat_used |= fbit.any(1)[0]
        if use_inter:
            uf = used_feat.view(K * L1, F)
            new_used = uf[sl] | fbit
            uf[sl] = new_used
            uf[rsl] = new_used
            used_feat[:, DUMMY_LEAF].fill_(False)

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

        if use_cegb and c_lazy is not None:
            # the rows of split leaves have paid for their split feature
            # (tree_builder.py:1697-1704)
            rlc0 = fold(torch.where(row_leaf < 0, DUMMY_LEAF, row_leaf),
                        L1)[0]
            rows = ar(R, i64)
            f_r = pend_feat[rlc0].long()
            cegb_used_rows[rows, f_r] = (cegb_used_rows[rows, f_r]
                                         | pend_active[rlc0])
        row_leaf = relabel(bins, row_leaf)
        valid_row_leaf = [relabel(vb, vrl)
                          for vb, vrl in zip(valid_bins, valid_row_leaf)]

        # -- 4. children histograms + best splits; slot lanes are
        #    [K, 2W] (left children, then right), flattened class-major
        slots2w = torch.cat([torch.where(valid, sel_s, -2),
                             torch.where(valid, right_slot, -2)], 1).to(i32)
        slots2w_c = torch.where(slots2w >= 0, slots2w, DUMMY_LEAF)
        s2f = fold(slots2w_c, L1).reshape(-1)
        depth2w = leaf_depth.view(-1)[s2f]
        valid2w = torch.cat([valid, valid], 1).reshape(-1)

        def lane(a, idx):
            """[K*2W, ...] per-slot values -> the [K*W, ...] lanes at
            idx [K, W]."""
            if a is None:
                return None
            tail = tuple(a.shape[1:])
            ix = idx.reshape((K, W) + (1,) * len(tail))
            return torch.gather(a.view((K, 2 * W) + tail), 1,
                                ix.expand((K, W) + tail)).reshape(
                                    (K * W,) + tail)

        if hist_sub:
            rl_n = torch.where(row_leaf < 0, DUMMY_LEAF, row_leaf) + kk * L1
            raw_cnt = _leaf_counts(rl_n.reshape(-1), K * L1)
            if comm is not None and mode != "feature":
                # every rank streams the same child: the choice reads
                # the global counts (tree_builder.py:1764-1769)
                raw_cnt = comm.all_reduce(raw_cnt.to(i64), "sum",
                                          phase="row_counts")
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
            # the per-slot masks are drawn once on the 2W lattice and
            # sliced (fused_children, tree_builder.py:1001-1015)
            fmask2w, _ = slot_masks_and_bins(slots2w_c, r + 1)
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
                    small_f, lane(fmask2w, idx_small),
                    lane(depth2w, idx_small),
                    lane(lo2w, idx_small), lane(hi2w, idx_small),
                    lane(po2w, idx_small), rl_c, gh_c,
                    row_gather=c_gather, num_rows=n_small, emit_hist=True)
                hbig = hist_cache[parent_f] - hsmall
                hist_cache[left_f] = torch.where(sil, hsmall, hbig)
                hist_cache[right_f] = torch.where(sil, hbig, hsmall)
                bs_b = find_best_splits(
                    hbig, num_bins_pf, nan_bin_pf, is_cat_pf, sp,
                    feature_mask=lane(fmask2w, idx_big),
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
            bs = best_for(hist_finish(hist2w), depth2w, valid2w, slots2w_c,
                          t, leaf_lo, leaf_hi, r + 1, row_leaf)

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

    out = (t, row_leaf, tuple(valid_row_leaf))
    if use_cegb:
        out += ((cegb_feat_used,
                 cegb_used_rows if c_lazy is not None else None),)
    return out
