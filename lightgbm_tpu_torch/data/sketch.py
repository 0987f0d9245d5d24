"""Mergeable per-feature quantile sketches for out-of-core binning (a
copy of ``lightgbm_tpu/data/sketch.py`` over the port's
``binning.BinMapper``).

The reference's ``DatasetLoader`` streams text through per-feature
bin-boundary sketches so dataset size is decoupled from host RAM.
This module is built around one invariant that makes distributed ingest trivial to reason about:

    **the sketch state is a pure function of the value multiset.**

A sketch holds the exact ``(distinct values, counts, n_nan)`` summary
of everything fed to it, up to ``capacity`` distinct values.  Past
capacity it coarsens deterministically by truncating low IEEE-754
mantissa bits — ``trunc_l(trunc_k(v)) == trunc_l(v)`` for ``l >= k``
(zeroing low bits nests), and the truncation level is defined as the
*smallest* level at which the multiset fits in ``capacity``.  Both the
level and the coarsened multiset are therefore functions of the total
multiset alone, never of arrival order, so:

- merges are exactly **associative and commutative**: shards sketched
  by different processes in any grouping produce bit-identical state;
- when the sketch never overflows (``level == 0``) the summary is the
  exact multiset and :meth:`BinMapper.from_distinct` is bit-identical
  to the in-memory :meth:`BinMapper.from_values` on the same rows.

Accuracy bound (documented contract): truncating ``k`` low mantissa
bits perturbs a value ``v`` by less than ``2**(k-52) * |v|``.  Bin
upper bounds are midpoints of adjacent distinct values, so every
boundary produced from an overflowed sketch lies within relative error
``2**(level-52)`` of a boundary the exact mapper could produce from a
multiset within that same perturbation; with the default capacity
(65536 distinct values per feature against ``max_bin <= 65535``) the
level stays 0 for integer-ish features and a handful of bits for
continuous ones (level 12 still means < 2.4e-13 relative error).
Counts are always exact — only value resolution coarsens, and NaN is
counted out-of-band so missing handling is unaffected.

Categorical features are sketched exactly (integer category → count;
never truncated): category ordering by count must match the in-memory
fit bit-for-bit, and categorical cardinality is already capped by
``max_bin`` downstream.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Set

import numpy as np

from ..binning import BinMapper

__all__ = ["FeatureSketch", "SketchSet", "truncate_mantissa",
           "DEFAULT_CAPACITY", "MAX_LEVEL"]

DEFAULT_CAPACITY = 1 << 16
MAX_LEVEL = 52  # whole mantissa; beyond this only exponents distinguish


def truncate_mantissa(values: np.ndarray, level: int) -> np.ndarray:
    """Zero the ``level`` low mantissa bits (toward zero, sign kept).

    Nested: ``truncate(truncate(v, k), l) == truncate(v, l)`` for
    ``l >= k``.  ``-0.0`` canonicalizes to ``+0.0`` (subnormals can
    truncate to a signed zero) so the state stays a pure function of
    the multiset under IEEE equality.
    """
    v = np.ascontiguousarray(values, dtype=np.float64)
    if level <= 0:
        return v + 0.0
    mask = np.uint64(~np.uint64((1 << level) - 1))
    out = (v.view(np.uint64) & mask).view(np.float64)
    return out + 0.0


def _merge_distinct(va, ca, vb, cb):
    """Union two sorted-distinct (values, counts) arrays exactly."""
    if not len(va):
        return vb.copy(), cb.copy()
    if not len(vb):
        return va.copy(), ca.copy()
    v = np.concatenate([va, vb])
    c = np.concatenate([ca, cb])
    uv, inverse = np.unique(v, return_inverse=True)
    uc = np.zeros(len(uv), np.int64)
    np.add.at(uc, inverse, c)
    return uv, uc


class FeatureSketch:
    """Order-independent distinct-value/count summary of one feature."""

    __slots__ = ("capacity", "exact", "level", "values", "counts",
                 "n_nan")

    def __init__(self, capacity: int = DEFAULT_CAPACITY,
                 exact: bool = False):
        if capacity < 2:
            raise ValueError("sketch capacity must be >= 2")
        self.capacity = int(capacity)
        self.exact = bool(exact)  # categorical: never coarsen
        self.level = 0
        self.values = np.empty(0, np.float64)
        self.counts = np.empty(0, np.int64)
        self.n_nan = 0

    # -- updates -------------------------------------------------------
    def update(self, column: np.ndarray) -> "FeatureSketch":
        col = np.asarray(column, dtype=np.float64).ravel()
        nan_mask = np.isnan(col)
        self.n_nan += int(nan_mask.sum())
        v = truncate_mantissa(col[~nan_mask], self.level)
        dv, cnts = np.unique(v, return_counts=True)
        self.values, self.counts = _merge_distinct(
            self.values, self.counts, dv, cnts.astype(np.int64))
        self._compact()
        return self

    def merge(self, other: "FeatureSketch") -> "FeatureSketch":
        if self.capacity != other.capacity or self.exact != other.exact:
            raise ValueError("cannot merge sketches with different "
                             "capacity/exactness")
        self.n_nan += other.n_nan
        level = max(self.level, other.level)
        self._retruncate(level)
        ov, oc = other.values, other.counts
        if level > other.level:
            ov, oc = _regroup(ov, oc, level)
        self.values, self.counts = _merge_distinct(
            self.values, self.counts, ov, oc)
        self._compact()
        return self

    def _retruncate(self, level: int) -> None:
        if level > self.level:
            self.values, self.counts = _regroup(self.values, self.counts,
                                                level)
            self.level = level

    def _compact(self) -> None:
        if self.exact:
            return
        while len(self.values) > self.capacity and self.level < MAX_LEVEL:
            self._retruncate(self.level + 1)

    # -- consumption ---------------------------------------------------
    @property
    def total_count(self) -> int:
        return int(self.counts.sum()) + self.n_nan

    def to_mapper(self, **kwargs) -> BinMapper:
        """Fit a :class:`BinMapper` — bit-identical to ``from_values``
        over the same rows whenever ``level == 0``."""
        return BinMapper.from_distinct(self.values, self.counts,
                                       self.n_nan, **kwargs)

    # -- serialization -------------------------------------------------
    def state(self) -> Dict[str, np.ndarray]:
        meta = np.asarray([self.capacity, int(self.exact), self.level,
                           self.n_nan], np.int64)
        return {"meta": meta, "values": self.values,
                "counts": self.counts}

    @classmethod
    def from_state(cls, meta, values, counts) -> "FeatureSketch":
        s = cls(capacity=int(meta[0]), exact=bool(meta[1]))
        s.level = int(meta[2])
        s.n_nan = int(meta[3])
        s.values = np.asarray(values, np.float64)
        s.counts = np.asarray(counts, np.int64)
        return s

    def __repr__(self):
        return (f"FeatureSketch(n_distinct={len(self.values)}, "
                f"level={self.level}, n_nan={self.n_nan}, "
                f"total={self.total_count})")


def _regroup(values: np.ndarray, counts: np.ndarray, level: int):
    tv = truncate_mantissa(values, level)
    uv, inverse = np.unique(tv, return_inverse=True)
    uc = np.zeros(len(uv), np.int64)
    np.add.at(uc, inverse, counts)
    return uv, uc


class SketchSet:
    """One :class:`FeatureSketch` per column of a [R, F] stream."""

    def __init__(self, num_features: int,
                 capacity: int = DEFAULT_CAPACITY,
                 cat_idx: Optional[Set[int]] = None):
        cat_idx = set() if cat_idx is None else set(cat_idx)
        self.num_features = int(num_features)
        self.cat_idx = cat_idx
        self.sketches: List[FeatureSketch] = [
            FeatureSketch(capacity=capacity, exact=(f in cat_idx))
            for f in range(num_features)]
        self.num_rows = 0

    def update(self, block: np.ndarray) -> "SketchSet":
        block = np.asarray(block, dtype=np.float64)
        if block.ndim == 1:
            block = block[None, :]
        if block.shape[1] != self.num_features:
            raise ValueError(
                f"block has {block.shape[1]} features, sketch set has "
                f"{self.num_features}")
        self.num_rows += block.shape[0]
        for f, sk in enumerate(self.sketches):
            sk.update(block[:, f])
        return self

    def merge(self, other: "SketchSet") -> "SketchSet":
        if other.num_features != self.num_features:
            raise ValueError("feature count mismatch in sketch merge")
        self.num_rows += other.num_rows
        for sk, o in zip(self.sketches, other.sketches):
            sk.merge(o)
        return self

    @property
    def max_level(self) -> int:
        return max((s.level for s in self.sketches), default=0)

    def fit_mappers(self, cfg) -> List[BinMapper]:
        """Per-feature mappers, mirroring ``Dataset._fit_mappers``
        (max_bin_by_feature + forcedbins_filename honored)."""
        mbf = list(cfg.max_bin_by_feature or [])
        if mbf and len(mbf) != self.num_features:
            raise ValueError(
                f"max_bin_by_feature has {len(mbf)} entries but the "
                f"dataset has {self.num_features} features")
        forced: Dict[int, list] = {}
        if cfg.forcedbins_filename:
            import json as _json
            with open(cfg.forcedbins_filename) as fh:
                for item in _json.load(fh):
                    forced[int(item["feature"])] = [
                        float(x) for x in item["bin_upper_bound"]]
        mappers = []
        for f, sk in enumerate(self.sketches):
            bt = "categorical" if f in self.cat_idx else "numerical"
            mappers.append(sk.to_mapper(
                max_bin=int(mbf[f]) if mbf else cfg.max_bin,
                min_data_in_bin=cfg.min_data_in_bin, bin_type=bt,
                use_missing=cfg.use_missing,
                zero_as_missing=cfg.zero_as_missing,
                forced_bounds=forced.get(f)))
        return mappers

    # -- serialization (flat arrays, npz/shard-header friendly) --------
    def state_arrays(self) -> Dict[str, np.ndarray]:
        metas = np.stack([s.state()["meta"] for s in self.sketches])
        vals = [s.values for s in self.sketches]
        cnts = [s.counts for s in self.sketches]
        offs = np.concatenate(
            [[0], np.cumsum([len(v) for v in vals])]).astype(np.int64)
        return {
            "sketch_meta": metas,
            "sketch_values": (np.concatenate(vals) if vals
                              else np.empty(0, np.float64)),
            "sketch_counts": (np.concatenate(cnts) if cnts
                              else np.empty(0, np.int64)),
            "sketch_offsets": offs,
            "sketch_rows": np.asarray([self.num_rows], np.int64),
            "sketch_cat_idx": np.asarray(sorted(self.cat_idx), np.int64),
        }

    @classmethod
    def from_state_arrays(cls, arrays) -> "SketchSet":
        metas = np.asarray(arrays["sketch_meta"], np.int64)
        offs = np.asarray(arrays["sketch_offsets"], np.int64)
        cat_idx = set(int(c) for c in arrays["sketch_cat_idx"])
        ss = cls(len(metas), capacity=int(metas[0][0]) if len(metas)
                 else DEFAULT_CAPACITY, cat_idx=cat_idx)
        for f in range(len(metas)):
            lo, hi = int(offs[f]), int(offs[f + 1])
            ss.sketches[f] = FeatureSketch.from_state(
                metas[f], arrays["sketch_values"][lo:hi],
                arrays["sketch_counts"][lo:hi])
        ss.num_rows = int(np.asarray(arrays["sketch_rows"]).ravel()[0])
        return ss


def sketch_stream(blocks: Sequence[np.ndarray], num_features: int,
                  capacity: int = DEFAULT_CAPACITY,
                  cat_idx: Optional[Set[int]] = None) -> SketchSet:
    """Sketch an iterable of [r, F] blocks (convenience for tests)."""
    ss = SketchSet(num_features, capacity=capacity, cat_idx=cat_idx)
    for b in blocks:
        ss.update(b)
    return ss
