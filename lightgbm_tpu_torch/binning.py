"""Feature quantization: value -> bin mapping.

TPU-native analog of the reference BinMapper (LightGBM
``include/LightGBM/bin.h:85``, ``src/io/bin.cpp`` ``BinMapper::FindBin`` /
``GreedyFindBin``). Runs on host in NumPy: binning is a one-time O(n)
preprocessing step; the per-row mapping is vectorized `searchsorted`.

Semantics kept from the reference:
- Equal-count greedy bin boundaries over sampled distinct values, with
  "big" values (count >= mean bin size) getting dedicated bins
  (bin.cpp ``GreedyFindBin``).
- A dedicated zero bin spanning [-kZeroThreshold, kZeroThreshold] when zeros
  are present (bin.cpp ``FindBinWithZeroAsOneBin``).
- ``missing_type`` in {None, Zero, NaN} (bin.h ``MissingType``): NaN gets the
  last bin when present and ``use_missing``; ``zero_as_missing`` folds NaN
  and zero into the zero bin.
- ``min_data_in_bin`` merging for low-count distinct values.
- Trivial features (one effective bin) are excluded from training.
- Categorical: categories sorted by count desc, one bin each (most frequent
  first), capped at max_bin; rare/unseen values map to bin 0.

Deviations (documented): boundaries are midpoints between distinct sample
values like the reference, but tie-breaking/epsilon details are not
bit-identical; parity tests are statistical (metric levels), not bitwise.

PyTorch port: a copy of ``lightgbm_tpu/binning.py`` without its native C
fast paths. The greedy loop runs over plain Python lists and the row
mapping is numpy ``searchsorted`` (``Dataset`` bins on the device with
``torch.searchsorted`` when it lives on the GPU); both give bounds and
bins bit-equal to the JAX package's (tests/test_torch_binning.py).
"""

from __future__ import annotations

import numpy as np
from typing import List, Optional

__all__ = ["BinMapper", "kZeroThreshold", "MISSING_NONE", "MISSING_ZERO",
           "MISSING_NAN"]

kZeroThreshold = 1e-35

MISSING_NONE = 0
MISSING_ZERO = 1
MISSING_NAN = 2

_MISSING_NAMES = {MISSING_NONE: "none", MISSING_ZERO: "zero",
                  MISSING_NAN: "nan"}


def _greedy_find_bin(distinct_values: np.ndarray, counts: np.ndarray,
                     max_bin: int, total_cnt: int,
                     min_data_in_bin: int) -> List[float]:
    """Equal-count greedy boundaries; returns upper bounds, last == +inf."""
    nd = len(distinct_values)
    if nd == 0:
        return [np.inf]
    # plain Python scalars: the loop below runs ~10x faster over lists
    # than over numpy element access, with identical IEEE arithmetic
    # (counts are exact integers far below 2**53)
    distinct_values = distinct_values.tolist()
    counts = np.asarray(counts).tolist()
    bounds: List[float] = []
    if nd <= max_bin:
        cur = 0
        for i in range(nd - 1):
            cur += counts[i]
            if cur >= min_data_in_bin:
                bounds.append((distinct_values[i] + distinct_values[i + 1])
                              / 2.0)
                cur = 0
        bounds.append(np.inf)
        return bounds
    # More distinct values than bins: dedicate bins to heavy hitters, then
    # greedily fill the rest to ~equal counts.
    max_bin = max(1, max_bin)
    mean_bin_size = total_cnt / max_bin
    is_big = [c >= mean_bin_size for c in counts]
    n_big = sum(is_big)
    rest_cnt = total_cnt - sum(c for c, b in zip(counts, is_big) if b)
    rest_bins = max(1, max_bin - n_big)
    rest_bin_size = rest_cnt / rest_bins
    half = max(1.0, rest_bin_size / 2)
    cur = 0
    n_bins = 0
    for i in range(nd - 1):
        if not is_big[i]:
            cur += counts[i]
        if is_big[i] or cur >= rest_bin_size or \
                (i + 1 < nd and is_big[i + 1] and cur >= half):
            bounds.append((distinct_values[i] + distinct_values[i + 1]) / 2.0)
            n_bins += 1
            cur = 0
            if n_bins >= max_bin - 1:
                break
    bounds.append(np.inf)
    return bounds


def _distinct(values: np.ndarray):
    v = np.sort(values)
    distinct, counts = np.unique(v, return_counts=True)
    return distinct, counts


class BinMapper:
    """Per-feature value->bin quantizer (bin.h:85 analog)."""

    def __init__(self):
        self.num_bin: int = 1
        self.is_trivial: bool = True
        self.missing_type: int = MISSING_NONE
        self.bin_type: str = "numerical"  # or "categorical"
        self.bin_upper_bound: Optional[np.ndarray] = None  # numerical
        self.categories: Optional[np.ndarray] = None  # categorical, by bin
        self._cat_to_bin: Optional[dict] = None
        self.most_freq_bin: int = 0
        self.default_bin: int = 0  # bin of value 0.0 (bin.h GetDefaultBin)

    # -- construction ------------------------------------------------------
    @classmethod
    def from_values(cls, values: np.ndarray, max_bin: int = 255,
                    min_data_in_bin: int = 3, bin_type: str = "numerical",
                    use_missing: bool = True, zero_as_missing: bool = False,
                    total_cnt: Optional[int] = None,
                    forced_bounds: Optional[list] = None) -> "BinMapper":
        values = np.asarray(values, dtype=np.float64)
        nan_mask = np.isnan(values)
        n_nan = int(nan_mask.sum())
        dv, cnts = _distinct(values[~nan_mask])
        return cls.from_distinct(
            dv, cnts, n_nan, max_bin=max_bin,
            min_data_in_bin=min_data_in_bin, bin_type=bin_type,
            use_missing=use_missing, zero_as_missing=zero_as_missing,
            forced_bounds=forced_bounds)

    @classmethod
    def from_distinct(cls, distinct_values: np.ndarray, counts: np.ndarray,
                      n_nan: int = 0, max_bin: int = 255,
                      min_data_in_bin: int = 3, bin_type: str = "numerical",
                      use_missing: bool = True, zero_as_missing: bool = False,
                      forced_bounds: Optional[list] = None) -> "BinMapper":
        """Fit from a (sorted-distinct non-NaN values, counts, n_nan)
        multiset summary — bit-identical to :meth:`from_values` on the
        same multiset. This is the entry point the out-of-core quantile
        sketch uses (``data/sketch.py``): the whole greedy pipeline only
        ever consumes distinct values with multiplicities, so a merged
        sketch that preserves the exact multiset reproduces the
        in-memory mapper exactly."""
        m = cls()
        m.bin_type = bin_type
        dv = np.asarray(distinct_values, dtype=np.float64)
        cnts = np.asarray(counts, dtype=np.int64)
        if bin_type == "categorical":
            m._construct_categorical_distinct(dv, cnts, max_bin,
                                              min_data_in_bin)
            return m

        if zero_as_missing and use_missing:
            m.missing_type = MISSING_ZERO
        elif n_nan > 0 and use_missing:
            m.missing_type = MISSING_NAN
        else:
            m.missing_type = MISSING_NONE
            # without use_missing, NaN is treated as zero (bin.cpp semantics)

        n_zero = int(cnts[np.abs(dv) <= kZeroThreshold].sum())
        if m.missing_type == MISSING_ZERO:
            n_zero += n_nan

        effective_max_bin = max_bin
        if m.missing_type == MISSING_NAN:
            effective_max_bin = max_bin - 1  # last bin reserved for NaN

        if n_zero > 0 or m.missing_type == MISSING_ZERO:
            # dedicated zero bin: greedy left of -eps, [-eps, eps], right
            neg_sel = dv < -kZeroThreshold
            pos_sel = dv > kZeroThreshold
            n_neg = int(cnts[neg_sel].sum())
            n_pos = int(cnts[pos_sel].sum())
            budget = max(1, effective_max_bin - 1)
            if n_neg + n_pos > 0:
                left_max = int(round(budget * n_neg / (n_neg + n_pos)))
                left_max = min(max(left_max, 1 if n_neg else 0), budget - (1 if n_pos else 0))
                right_max = budget - left_max
            else:
                left_max, right_max = 0, 0
            bounds: List[float] = []
            if n_neg:
                b = _greedy_find_bin(dv[neg_sel], cnts[neg_sel],
                                     max(1, left_max), n_neg,
                                     min_data_in_bin)
                b[-1] = -kZeroThreshold
                bounds.extend(b)
            else:
                bounds.append(-kZeroThreshold)
            bounds.append(kZeroThreshold)  # zero bin upper bound
            if n_pos:
                bounds.extend(_greedy_find_bin(dv[pos_sel], cnts[pos_sel],
                                               max(1, right_max),
                                               n_pos, min_data_in_bin))
            else:
                bounds.append(np.inf)
            if bounds[-1] != np.inf:
                bounds.append(np.inf)
        else:
            bounds = _greedy_find_bin(dv, cnts, effective_max_bin,
                                      int(cnts.sum()), min_data_in_bin)
        ub = np.asarray(bounds, dtype=np.float64)
        if forced_bounds:
            # forcedbins_filename (dataset_loader.cpp GetForcedBins):
            # user-specified boundaries are guaranteed to exist; greedy
            # bounds fill around them (bin count may exceed max_bin by
            # up to len(forced_bounds) — a documented simplification)
            ub = np.concatenate([ub, np.asarray(forced_bounds,
                                                np.float64)])
        # dedupe (can collapse when greedy produced adjacent equal bounds)
        ub = np.unique(ub)
        m.bin_upper_bound = ub
        m.num_bin = len(ub) + (1 if m.missing_type == MISSING_NAN else 0)
        m.default_bin = int(np.searchsorted(ub, 0.0, side="left"))
        # most_freq_bin: counts-weighted histogram of the distinct values'
        # bins, NaN rows landing on the NaN/default bin exactly as
        # values_to_bins sends them (counts are exact in f64 up to 2^53)
        if int(cnts.sum()) + n_nan > 0:
            bc = np.bincount(m.values_to_bins(dv),
                             weights=cnts.astype(np.float64),
                             minlength=m.num_bin)
            nb = (m.num_bin - 1 if m.missing_type == MISSING_NAN
                  else m.default_bin)
            bc[nb] += n_nan
            m.most_freq_bin = int(bc.argmax())
        m.is_trivial = (len(ub) <= 1 and m.missing_type != MISSING_NAN) or \
            m.num_bin <= 1
        return m

    def _construct_categorical(self, values: np.ndarray, max_bin: int,
                               min_data_in_bin: int):
        dv, cnts = _distinct(values)
        self._construct_categorical_distinct(dv, cnts, max_bin,
                                             min_data_in_bin)

    def _construct_categorical_distinct(self, dv: np.ndarray,
                                        cnts: np.ndarray, max_bin: int,
                                        min_data_in_bin: int):
        # negative categorical values are treated as missing (reference
        # warns and maps them out); categories sorted by count desc.
        sel = dv >= 0
        ivals = dv[sel].astype(np.int64)
        icnts = cnts[sel]
        # distinct floats can collapse onto one integer category — sum
        # their multiplicities (unique returns ascending categories, so
        # the stable count-desc sort ties out exactly like from_values)
        cats, inverse = np.unique(ivals, return_inverse=True)
        counts = np.zeros(len(cats), np.int64)
        np.add.at(counts, inverse, icnts)
        order = np.argsort(-counts, kind="stable")
        cats, counts = cats[order], counts[order]
        # cut rare categories: keep while count > 0 and within max_bin
        keep = min(len(cats), max_bin)
        # drop categories so rare they can't satisfy min_data_in_bin? The
        # reference cuts by cnt_in_bin; we keep all with count >= 1 up to cap.
        cats = cats[:keep]
        self.categories = cats
        self._cat_to_bin = {int(c): i for i, c in enumerate(cats)}
        self.num_bin = max(1, len(cats))
        self.most_freq_bin = 0
        self.default_bin = self._cat_to_bin.get(0, 0)
        self.missing_type = MISSING_NONE
        self.is_trivial = len(cats) <= 1

    # -- mapping -----------------------------------------------------------
    def values_to_bins(self, values: np.ndarray) -> np.ndarray:
        """Vectorized ValueToBin (bin.h:173)."""
        values = np.asarray(values, dtype=np.float64)
        if self.bin_type == "categorical":
            out = np.zeros(len(values), dtype=np.int32)
            # vectorized dict lookup
            if len(self.categories):
                sorter = np.argsort(self.categories)
                sc = self.categories[sorter]
                vi = np.where(np.isfinite(values), values, -1).astype(np.int64)
                pos = np.searchsorted(sc, vi)
                pos = np.clip(pos, 0, len(sc) - 1)
                hit = sc[pos] == vi
                out = np.where(hit, sorter[pos], 0).astype(np.int32)
            return out
        nb = (self.num_bin - 1 if self.missing_type == MISSING_NAN
              else self.default_bin)
        nan_mask = np.isnan(values)
        x = np.where(nan_mask, 0.0, values)
        bins = np.searchsorted(self.bin_upper_bound, x,
                               side="left").astype(np.int32)
        return np.where(nan_mask, nb, bins).astype(np.int32)

    @property
    def nan_bin(self) -> int:
        """Bin holding NaN rows, or -1 if none."""
        return self.num_bin - 1 if self.missing_type == MISSING_NAN else -1

    def bin_to_threshold_value(self, bin_idx: int) -> float:
        """Real-valued split threshold for 'go left iff value <= t'.

        The reference stores the bin upper bound as the tree threshold
        (tree.cpp RecomputeMaxDepth / threshold_ arrays).
        """
        if self.bin_type == "categorical":
            return float(self.categories[bin_idx])
        ub = self.bin_upper_bound
        i = min(int(bin_idx), len(ub) - 1)
        v = ub[i]
        if np.isinf(v):
            v = np.finfo(np.float64).max
        return float(v)

    # -- (de)serialization used by the model text format -------------------
    def feature_info_str(self) -> str:
        """LightGBM model 'feature_infos' entry ([min:max] or cat list)."""
        if self.bin_type == "categorical":
            return ":".join(str(int(c)) for c in self.categories) \
                if len(self.categories) else "none"
        if self.is_trivial:
            return "none"
        ub = self.bin_upper_bound
        lo = ub[0] if len(ub) else 0.0
        hi = ub[-2] if len(ub) > 1 else lo
        return f"[{lo:g}:{hi:g}]"

    def __repr__(self):
        return (f"BinMapper({self.bin_type}, num_bin={self.num_bin}, "
                f"missing={_MISSING_NAMES[self.missing_type]}, "
                f"trivial={self.is_trivial})")

    # -- binary dataset cache serialization (SaveBinaryFile analog) -------
    def state_arrays(self):
        """(scalars int64[6], upper_bounds f64[*], categories i64[*]) —
        flat arrays for the Dataset binary cache."""
        scalars = np.asarray(
            [self.num_bin, int(self.is_trivial), self.missing_type,
             int(self.bin_type == "categorical"), self.most_freq_bin,
             self.default_bin], np.int64)
        ub = (self.bin_upper_bound if self.bin_upper_bound is not None
              else np.empty(0, np.float64))
        cats = (self.categories.astype(np.int64)
                if self.categories is not None else np.empty(0, np.int64))
        return scalars, ub, cats

    @classmethod
    def from_state_arrays(cls, scalars, ub, cats) -> "BinMapper":
        m = cls()
        m.num_bin = int(scalars[0])
        m.is_trivial = bool(scalars[1])
        m.missing_type = int(scalars[2])
        m.bin_type = "categorical" if scalars[3] else "numerical"
        m.most_freq_bin = int(scalars[4])
        m.default_bin = int(scalars[5])
        if m.bin_type == "categorical":
            m.categories = np.asarray(cats, np.int64)
            m._cat_to_bin = {int(c): i for i, c in enumerate(m.categories)}
        else:
            m.bin_upper_bound = np.asarray(ub, np.float64)
        return m
