"""Exclusive Feature Bundling (EFB).

PyTorch port of ``lightgbm_tpu/efb.py`` (the reference's
``dataset_loader.cpp`` FindGroups / ``feature_group.h`` FeatureGroup):
features that are (almost) never simultaneously non-default share one
storage column. The planner, the encoders and the decode formula are
the JAX package's; each encoder has a numpy form (host binning) and a
torch form (columns binned on the device).

Encoding (per bundle g with members f_1..f_m at offsets o_1..o_m):
- bundle bin 0 = every member at its most-frequent bin;
- bundle bin o_j + b = member f_j at bin b (b != mfb_j); when two members
  are non-default in the same row (a conflict, bounded by
  ``max_conflict_rate``) the LAST member in bundle order wins;
- a singleton bundle stores its feature's bins directly at offset 0.

The tree builder histograms the bundled [R, G] matrix over the bundle
lattice and unbundles to per-feature histograms, rebuilding each
feature's most-frequent bin as the leaf total minus its other bins
(``boosting/tree_builder.py``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Sequence

import numpy as np
import torch

__all__ = ["BundlePlan", "plan_bundles", "encode_bundles",
           "encode_bundles_torch", "decode_feature_bins", "encode_rows",
           "encode_rows_torch", "bin_dtype", "np_bin_dtype"]


def bin_dtype(num_bins: int) -> torch.dtype:
    """Storage type of a bin (or bundle) column of up to ``num_bins``
    bins: uint8 up to 256, int16 up to 32,768, int32 above. The JAX
    package stores int32 above 256; int16 holds the same values in half
    the bytes, which the histogram kernels are bound by (int16 rather
    than uint16, whose operator coverage in PyTorch is partial)."""
    if num_bins <= 256:
        return torch.uint8
    return torch.int16 if num_bins <= 32768 else torch.int32


def np_bin_dtype(num_bins: int):
    """:func:`bin_dtype` as a numpy dtype."""
    return {torch.uint8: np.uint8, torch.int16: np.int16,
            torch.int32: np.int32}[bin_dtype(num_bins)]


def decode_feature_bins(raw, off, nb, mfb, xp=np):
    """Bundle-column value -> a feature's own bin id (efb.py:40).

    The one decode formula (the builder's relabel, the binned predict
    walk and host decoding all call it): inside the feature's range ->
    raw - offset; outside -> the feature's most-frequent bin. Singleton
    bundles use offset 0 and store every row directly, so the fallback
    never fires for them. ``xp`` is numpy or torch.
    """
    return xp.where((raw >= off) & (raw < off + nb), raw - off, mfb)


@dataclass
class BundlePlan:
    """Static bundling layout shared by train/valid datasets."""
    # per original (used) feature:
    feat_bundle: np.ndarray     # [F] int32 bundle column id
    feat_offset: np.ndarray     # [F] int32 offset of the feature's range
    feat_mfb: np.ndarray        # [F] int32 most-frequent (default) bin
    # layout:
    num_bundles: int
    bundle_num_bins: np.ndarray  # [G] int32 (1 + sum of member bins)
    max_bundle_bins: int         # B_g for the histogram lattice

    def state_arrays(self):
        """Flat arrays of the plan for the binary Dataset cache
        (efb.py:68)."""
        return (self.feat_bundle, self.feat_offset, self.feat_mfb,
                self.bundle_num_bins,
                np.asarray([self.num_bundles, self.max_bundle_bins]))

    @classmethod
    def from_state_arrays(cls, fb, fo, fm, bnb, scal) -> "BundlePlan":
        return cls(feat_bundle=fb, feat_offset=fo, feat_mfb=fm,
                   num_bundles=int(scal[0]), bundle_num_bins=bnb,
                   max_bundle_bins=int(scal[1]))


_POP8 = np.array([bin(i).count("1") for i in range(256)], np.uint8)


def _popcounts(words: np.ndarray) -> np.ndarray:
    """Set bits of each row of a [n, W] uint64 array (int64 [n])."""
    if hasattr(np, "bitwise_count"):
        return np.bitwise_count(words).sum(axis=-1, dtype=np.int64)
    return _POP8[words.view(np.uint8)].sum(axis=-1, dtype=np.int64)


def plan_bundles(sample_bins: np.ndarray, num_bins: Sequence[int],
                 most_freq: Sequence[int], *,
                 max_conflict_rate: float = 0.0,
                 max_bundle_bins: int = 256) -> BundlePlan:
    """Greedy conflict-bounded packing (dataset_loader FindGroups; the
    JAX package's efb.py:84).

    sample_bins: [S, F] int bins of a row sample (a column-major array
    packs fastest); num_bins/most_freq per feature. Features are
    ordered by non-default count (descending) and placed into the first
    bundle whose accumulated conflicts and bin budget allow, else open a
    new bundle. The JAX package tests the bundles one by one; here a
    feature's conflicts with every open bundle are counted in one
    vectorised pass, and the first bundle that fits is taken, which is
    the same plan.
    """
    S, F = sample_bins.shape
    nb = np.asarray(num_bins, np.int64)
    mfb = np.asarray(most_freq, np.int64)
    nondef = sample_bins != mfb[None, :]                    # [S, F]
    nz_count = nondef.sum(axis=0)
    packed = np.packbits(nondef.T, axis=1)                  # [F, S/8]
    # as 64-bit words (zero-padded): 8x fewer elements to AND and count
    packed = np.pad(packed, ((0, 0), (0, -packed.shape[1] % 8)))
    packed = np.ascontiguousarray(packed).view(np.uint64)   # [F, S/64]
    max_conflicts = int(max_conflict_rate * S)
    # dense-ish features (no realistic exclusivity) go solo, and no
    # feature joins a bundle that holds one of them alone
    dense = nz_count * 2 > S

    order = np.argsort(-nz_count, kind="stable")
    bits = np.zeros_like(packed)       # [G, S/8] each bundle's rows
    conflicts = np.zeros(F, np.int64)
    bins = np.zeros(F, np.int64)
    closed = np.zeros(F, bool)         # a dense feature's own bundle
    members: List[List[int]] = []
    for f in order:
        G = len(members)
        g = -1
        if not (dense[f] or nb[f] + 1 > max_bundle_bins) and G:
            ok = ~closed[:G] & (bins[:G] + nb[f] <= max_bundle_bins)
            if ok.any():
                c = _popcounts(bits[:G] & packed[f])
                fits = np.flatnonzero(ok & (conflicts[:G] + c
                                            <= max_conflicts))
                if len(fits):
                    g = int(fits[0])
                    members[g].append(int(f))
                    bits[g] |= packed[f]
                    conflicts[g] += c[g]
                    bins[g] += nb[f]
        if g < 0:
            members.append([int(f)])
            bits[G] = packed[f]
            bins[G] = 1 + nb[f]
            closed[G] = dense[f]

    feat_bundle = np.zeros(F, np.int32)
    feat_offset = np.zeros(F, np.int32)
    bundle_bins = []
    for g, mem in enumerate(members):
        if len(mem) == 1:
            # singleton: store raw bins at offset 0 (no shared
            # all-default slot) — keeps a 256-bin feature inside uint8
            f = mem[0]
            feat_bundle[f] = g
            feat_offset[f] = 0
            bundle_bins.append(int(nb[f]))
            continue
        off = 1
        for f in mem:
            feat_bundle[f] = g
            feat_offset[f] = off
            off += int(nb[f])
        bundle_bins.append(off)
    return BundlePlan(
        feat_bundle=feat_bundle, feat_offset=feat_offset,
        feat_mfb=mfb.astype(np.int32), num_bundles=len(members),
        bundle_num_bins=np.asarray(bundle_bins, np.int32),
        max_bundle_bins=int(max(bundle_bins)) if bundle_bins else 1)


def encode_bundles(plan: BundlePlan, col_bins_iter,
                   num_rows: int) -> np.ndarray:
    """[R, G] bundled bin matrix from per-feature bin columns (efb.py:155).

    col_bins_iter yields (feature_index, bins[R]). Later members of a
    bundle overwrite earlier ones on conflict rows (bounded by
    max_conflict_rate).
    """
    dtype = np_bin_dtype(plan.max_bundle_bins)
    out = np.zeros((num_rows, plan.num_bundles), dtype)
    for f, col in col_bins_iter:
        g = plan.feat_bundle[f]
        off = plan.feat_offset[f]
        if off == 0:            # singleton bundle: raw bins
            out[:, g] = col.astype(dtype)
            continue
        nz = col != plan.feat_mfb[f]
        out[nz, g] = (off + col[nz]).astype(dtype)
    return out


def _write_column_torch(plan: BundlePlan, out: torch.Tensor, f: int,
                        col: torch.Tensor) -> None:
    """One feature's bins into its bundle column of ``out`` (in place),
    with the numpy encoders' arithmetic and overwrite order; a masked
    ``where`` in place of boolean indexing, so no host sync."""
    g = int(plan.feat_bundle[f])
    off = int(plan.feat_offset[f])
    if off == 0:
        out[:, g] = col.to(out.dtype)
        return
    col = col.to(torch.int64)
    out[:, g] = torch.where(col != int(plan.feat_mfb[f]),
                            (col + off).to(out.dtype), out[:, g])


def encode_bundles_torch(plan: BundlePlan, col_bins_iter, num_rows: int,
                         device) -> torch.Tensor:
    """:func:`encode_bundles` for columns that are torch tensors, into a
    [R, G] tensor on ``device`` (of :func:`bin_dtype`); bit-equal to the
    numpy form."""
    dtype = bin_dtype(plan.max_bundle_bins)
    out = torch.zeros((num_rows, plan.num_bundles), dtype=dtype,
                      device=device)
    for f, col in col_bins_iter:
        _write_column_torch(plan, out, f, col)
    return out


def encode_rows(plan: BundlePlan, batch_bins: np.ndarray,
                out: np.ndarray, row0: int) -> None:
    """Encode a [r, F] per-feature bin batch into out[row0:row0+r, G]
    (efb.py:178)."""
    r = batch_bins.shape[0]
    view = out[row0:row0 + r]
    view[:] = 0
    for f in range(batch_bins.shape[1]):
        g = plan.feat_bundle[f]
        off = plan.feat_offset[f]
        col = batch_bins[:, f]
        if off == 0:
            view[:, g] = col.astype(out.dtype)
            continue
        nz = col != plan.feat_mfb[f]
        view[nz, g] = (off + col[nz]).astype(out.dtype)


def encode_rows_torch(plan: BundlePlan, batch_bins: torch.Tensor,
                      out: torch.Tensor, row0: int) -> None:
    """:func:`encode_rows` for a torch batch and a torch ``out``."""
    r = batch_bins.shape[0]
    view = out[row0:row0 + r]
    view.zero_()
    for f in range(batch_bins.shape[1]):
        _write_column_torch(plan, view, f, batch_bins[:, f])
