"""Exclusive Feature Bundling (EFB) planner.

PyTorch port: ``plan_bundles`` and ``BundlePlan`` copied from
``lightgbm_tpu/efb.py``. The port does not train on bundled matrices
yet; ``Dataset`` runs the planner only to decide whether the JAX package
would bundle this data, and raises ``NotImplementedError`` when it
would (ROADMAP A, EFB). Dense data such as Higgs forms no bundles.

Greedy conflict-bounded packing of features that are (almost) never
simultaneously non-default (the reference's dataset_loader FindGroups).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Sequence

import numpy as np

__all__ = ["BundlePlan", "plan_bundles"]


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


def _popcount(x: np.ndarray) -> int:
    return int(np.unpackbits(x).sum())


def plan_bundles(sample_bins: np.ndarray, num_bins: Sequence[int],
                 most_freq: Sequence[int], *,
                 max_conflict_rate: float = 0.0,
                 max_bundle_bins: int = 256) -> BundlePlan:
    """Greedy conflict-bounded packing (dataset_loader FindGroups).

    sample_bins: [S, F] int bins of a row sample; num_bins/most_freq per
    feature. Features are ordered by non-default count (descending) and
    placed into the first bundle whose accumulated conflicts and bin
    budget allow, else open a new bundle.
    """
    S, F = sample_bins.shape
    nb = np.asarray(num_bins, np.int64)
    mfb = np.asarray(most_freq, np.int64)
    nondef = sample_bins != mfb[None, :]                    # [S, F]
    nz_count = nondef.sum(axis=0)
    packed = [np.packbits(nondef[:, f]) for f in range(F)]
    max_conflicts = int(max_conflict_rate * S)

    order = np.argsort(-nz_count, kind="stable")
    bundles: List[dict] = []   # {members, bits, conflicts, bins}
    for f in order:
        placed = False
        # dense-ish features (no realistic exclusivity) go solo fast
        if nz_count[f] * 2 > S or nb[f] + 1 > max_bundle_bins:
            bundles.append(dict(members=[int(f)], bits=packed[f].copy(),
                                conflicts=0, bins=1 + int(nb[f])))
            continue
        for bd in bundles:
            if len(bd["members"]) == 1 and \
                    nz_count[bd["members"][0]] * 2 > S:
                continue  # don't co-bundle with dense columns
            if bd["bins"] + nb[f] > max_bundle_bins:
                continue
            c = _popcount(np.bitwise_and(bd["bits"], packed[f]))
            if bd["conflicts"] + c <= max_conflicts:
                bd["members"].append(int(f))
                bd["bits"] |= packed[f]
                bd["conflicts"] += c
                bd["bins"] += int(nb[f])
                placed = True
                break
        if not placed:
            bundles.append(dict(members=[int(f)], bits=packed[f].copy(),
                                conflicts=0, bins=1 + int(nb[f])))

    feat_bundle = np.zeros(F, np.int32)
    feat_offset = np.zeros(F, np.int32)
    bundle_bins = []
    for g, bd in enumerate(bundles):
        if len(bd["members"]) == 1:
            # singleton: store raw bins at offset 0 (no shared
            # all-default slot) — keeps a 256-bin feature inside uint8
            f = bd["members"][0]
            feat_bundle[f] = g
            feat_offset[f] = 0
            bundle_bins.append(int(nb[f]))
            continue
        off = 1
        for f in bd["members"]:
            feat_bundle[f] = g
            feat_offset[f] = off
            off += int(nb[f])
        bundle_bins.append(off)
    return BundlePlan(
        feat_bundle=feat_bundle, feat_offset=feat_offset,
        feat_mfb=mfb.astype(np.int32), num_bundles=len(bundles),
        bundle_num_bins=np.asarray(bundle_bins, np.int32),
        max_bundle_bins=int(max(bundle_bins)) if bundle_bins else 1)
