"""Dataset: binned feature matrix + metadata, resident on the device.

Port of the in-memory numpy path of ``lightgbm_tpu/dataset.py``
(``DatasetLoader::ConstructFromSampleData`` of the reference): sample
rows -> fit ``BinMapper``s -> map every row. The binned matrix lives on
the device as uint8, as int16 above 256 bins a column and as int32 above
32,768 (``efb.bin_dtype``; the JAX package stores int32 above 256, with
the same values).

Differences from the JAX package:
- Only dense numpy-like input (arrays, lists, DataFrames of numeric
  columns) is accepted; files, Sequences, sparse matrices, Arrow and
  shard directories are not ported yet.
- There is one process: the multi-host row/feature partitioning of the
  JAX package (``process_index``/``process_count``) does not apply.
- The device comes from ``device_type`` (default ``cuda``, which raises
  without a GPU). On a GPU the rows are binned there with
  ``torch.searchsorted``, bit-equal to numpy's ``searchsorted``.

EFB (``efb.py``; the JAX package's ``dataset.py:428-455``): with
``enable_bundle`` and more than 4 used features, mutually exclusive
sparse columns are planned into bundles from the binning sample, and
the plan is kept when it shrinks the matrix to at most 3/4 of the
columns. ``bins`` is then the bundled [R, G] matrix (its type set by the
widest bundle, ``max_bundle_bins``). A valid set built with
``reference=`` is encoded into its train set's bundle layout. The
per-feature metadata (``per_feature_*``) stays in feature space;
``unbundled_bins`` decodes the matrix on the host.

Linear trees (``linear_tree``): the Dataset also keeps ``raw_values``,
the [R, F_total] float32 feature matrix (the JAX package's
``dataset.py:476-487``), on its device; a valid set keeps it when its
train set trains linear trees, and ``subset`` takes its rows.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional

import numpy as np
import torch

from .binning import BinMapper, MISSING_NAN
from .config import Config, resolve_device
from .efb import bin_dtype, np_bin_dtype

__all__ = ["Dataset", "estimate_device_bytes", "check_device_capacity"]


def estimate_device_bytes(num_rows: int, width: int, itemsize: int,
                          num_leaves: int, max_bin: int,
                          hist_cache: bool, num_class: int = 1,
                          hist_caches: int = 1) -> int:
    """Bytes of the training working set on the device: the bin matrix,
    the per-row gh/scores/row_leaf vectors of each of ``num_class``
    score rows and ``hist_caches`` per-leaf histogram caches (K for the
    class-batched build, 1 otherwise)."""
    bins_b = num_rows * width * itemsize
    per_row = 4 * 4 * num_rows * num_class
    cache_b = (hist_caches * (num_leaves + 1) * width * max_bin * 3 * 4
               if hist_cache else 0)
    return int(bins_b + per_row + cache_b)


def check_device_capacity(num_rows: int, width: int, itemsize: int,
                          num_leaves: int, max_bin: int, hist_cache: bool,
                          device: torch.device, num_class: int = 1,
                          hist_caches: int = 1,
                          headroom: float = 0.85) -> None:
    """Raise MemoryError with sized guidance when the working set cannot
    fit the device. The budget is the GPU's free memory
    (``torch.cuda.mem_get_info``), or ``LIGHTGBM_TPU_DEVICE_MEM_GB``;
    CPU runs skip the check."""
    env = os.environ.get("LIGHTGBM_TPU_DEVICE_MEM_GB")
    if env:
        budget = float(env) * (1 << 30)
    elif device.type == "cuda":
        budget = float(torch.cuda.mem_get_info(device)[0])
    else:
        return
    need = estimate_device_bytes(num_rows, width, itemsize, num_leaves,
                                 max_bin, hist_cache, num_class, hist_caches)
    if need <= budget * headroom:
        return
    gib = 1 << 30
    raise MemoryError(
        f"training working set ~{need / gib:.1f} GiB exceeds "
        f"{budget * headroom / gib:.1f} GiB available ({num_rows:,} rows x "
        f"{width:,} columns x {itemsize} B); lower max_bin to keep uint8 "
        "columns, or reduce rows/features")


def _to_2d_float(data) -> np.ndarray:
    if hasattr(data, "values") and hasattr(data, "columns"):  # DataFrame
        arr = data.values
    else:
        arr = np.asarray(data)
    if arr.ndim == 1:
        arr = arr[:, None]
    return np.ascontiguousarray(arr, dtype=np.float64)


class Dataset:
    """Binned training data (dataset.h:487 analog)."""

    def __init__(self, data, label=None, weight=None, group=None,
                 init_score=None, feature_name="auto",
                 categorical_feature="auto", params: Optional[Dict] = None,
                 reference: Optional["Dataset"] = None,
                 free_raw_data: bool = True,
                 bin_mappers: Optional[List[BinMapper]] = None,
                 position=None):
        if isinstance(data, (str, os.PathLike)) or hasattr(data, "tocsr"):
            raise NotImplementedError(
                "lightgbm_tpu_torch takes in-memory dense arrays; file, "
                "shard and sparse inputs are not ported yet (ROADMAP A)")
        self.params = dict(params or {})
        self.config = Config(self.params)
        self._raw_data = data
        self.label = None if label is None else np.asarray(
            label, dtype=np.float64).reshape(-1)
        self.weight = None if weight is None else np.asarray(
            weight, dtype=np.float64).reshape(-1)
        self.group = None if group is None else np.asarray(
            group, dtype=np.int64).reshape(-1)
        self.init_score = None if init_score is None else np.asarray(
            init_score, dtype=np.float64)
        # per-row result positions for unbiased lambdarank
        # (Metadata::positions; ids or names)
        self.position = (None if position is None
                         else np.asarray(position).reshape(-1))
        self.feature_name = feature_name
        self.categorical_feature = categorical_feature
        self.reference = reference
        self.free_raw_data = free_raw_data
        self.bin_mappers: List[BinMapper] = list(bin_mappers or [])
        self._given_mappers = bin_mappers is not None
        # [num_data, F] on the device, or [num_data, G] under EFB
        self.bins: Optional[torch.Tensor] = None
        self.device: Optional[torch.device] = None
        self.num_data = 0
        self.num_total_features = 0
        self.used_features: Optional[np.ndarray] = None
        self.max_num_bin = 0
        self.bundle_plan = None
        # [R, F_total] float32 on the device, kept for linear_tree
        self.raw_values: Optional[torch.Tensor] = None
        self.pandas_categorical = None
        self._constructed = False

    def construct(self) -> "Dataset":
        if self._constructed:
            return self
        self.config = Config(self.params)
        cfg = self.config
        if self.reference is not None:
            # a valid set lives where its train set lives unless told
            self.reference.construct()
        if (self.reference is not None
                and "device_type" not in cfg.explicit()):
            self.device = self.reference.device
        else:
            self.device = resolve_device(cfg.device_type)
        data = _to_2d_float(self._raw_data)
        if (self.reference is not None
                and data.shape[1] != self.reference.num_total_features):
            raise ValueError(
                f"validation data has {data.shape[1]} features but "
                f"training data has {self.reference.num_total_features}")
        self.num_data, self.num_total_features = data.shape
        if isinstance(self.feature_name, (list, tuple)) and self.feature_name:
            names = list(self.feature_name)
        elif hasattr(self._raw_data, "columns"):
            names = [str(c) for c in self._raw_data.columns]
        else:
            names = [f"Column_{i}" for i in range(self.num_total_features)]
        self.feature_name = names
        cat_idx = self._resolve_categoricals(names)

        if self.reference is not None:
            ref = self.reference
            self.bin_mappers = ref.bin_mappers
            self.used_features = ref.used_features
            self.max_num_bin = ref.max_num_bin
            self.bundle_plan = ref.bundle_plan
        else:
            sample_cnt = min(cfg.bin_construct_sample_cnt, self.num_data)
            if sample_cnt < self.num_data:
                rng = np.random.RandomState(cfg.data_random_seed)
                sample = data[rng.choice(self.num_data, sample_cnt,
                                         replace=False)]
            else:
                sample = data
            if self._given_mappers:
                if len(self.bin_mappers) != self.num_total_features:
                    raise ValueError("bin_mappers must hold one mapper per "
                                     "feature")
                self._finish_mappers()
            else:
                self._fit_mappers(sample, cat_idx, cfg)
            self.bundle_plan = self._plan_bundles(sample, cfg)

        F = len(self.used_features)
        bp = self.bundle_plan
        dtype = bin_dtype(self.max_num_bin)
        if self.device.type == "cuda":
            cols = self._device_columns(data, dtype)
            if bp is not None:
                from .efb import encode_bundles_torch
                self.bins = encode_bundles_torch(bp, cols, self.num_data,
                                                 self.device)
            else:
                self.bins = torch.empty((self.num_data, F), dtype=dtype,
                                        device=self.device)
                for j, col in cols:
                    self.bins[:, j] = col
        elif bp is not None:
            from .efb import encode_bundles
            self.bins = torch.from_numpy(encode_bundles(bp, (
                (j, self.bin_mappers[f].values_to_bins(data[:, f])
                 .astype(np.int64))
                for j, f in enumerate(self.used_features)), self.num_data))
        else:
            out = np.empty((self.num_data, F), np_bin_dtype(self.max_num_bin))
            for j, f in enumerate(self.used_features):
                out[:, j] = self.bin_mappers[f].values_to_bins(data[:, f])
            self.bins = torch.from_numpy(out)
        # linear trees regress on raw feature values: keep them resident
        # (the reference keeps raw data when linear_tree, dataset.cpp)
        ref_cfg = (self.reference.config if self.reference is not None
                   else None)
        if cfg.linear_tree or (ref_cfg is not None and ref_cfg.linear_tree):
            self.raw_values = torch.from_numpy(
                np.ascontiguousarray(data, np.float32)).to(self.device)
        if self.label is None:
            raise ValueError("Dataset has no label")
        if self.group is not None and int(self.group.sum()) != self.num_data:
            raise ValueError(
                f"sum of group sizes ({int(self.group.sum())}) does not "
                f"match num_data ({self.num_data})")
        if self.free_raw_data:
            self._raw_data = None
        self._constructed = True
        return self

    def _device_columns(self, data: np.ndarray, dtype):
        """Yield (j, bins of used feature j) on the device: ValueToBin
        per column with torch.searchsorted (side=left, the numpy call
        values_to_bins makes), NaN to the NaN/default bin; categorical
        columns are mapped on the host."""
        dev = self.device
        x_all = torch.from_numpy(data).to(dev)
        for j, f in enumerate(self.used_features):
            m = self.bin_mappers[f]
            if m.bin_type == "categorical":
                yield j, torch.from_numpy(
                    m.values_to_bins(data[:, f])).to(dev, dtype)
                continue
            x = x_all[:, f]
            nan = torch.isnan(x)
            ub = torch.from_numpy(m.bin_upper_bound).to(dev)
            b = torch.searchsorted(ub, torch.where(nan, 0.0, x))
            nb = (m.num_bin - 1 if m.missing_type == MISSING_NAN
                  else m.default_bin)
            yield j, torch.where(nan, nb, b).to(dtype)

    def _fit_mappers(self, sample: np.ndarray, cat_idx: set, cfg) -> None:
        """Fit per-feature BinMappers from a row sample (the JAX
        package's _fit_mappers, single process)."""
        mbf = list(cfg.max_bin_by_feature or [])
        if mbf and len(mbf) != self.num_total_features:
            raise ValueError(
                f"max_bin_by_feature has {len(mbf)} entries but the "
                f"dataset has {self.num_total_features} features")
        forced: Dict[int, list] = {}
        if cfg.forcedbins_filename:
            import json
            with open(cfg.forcedbins_filename) as fh:
                for item in json.load(fh):
                    forced[int(item["feature"])] = [
                        float(x) for x in item["bin_upper_bound"]]
        self.bin_mappers = [
            BinMapper.from_values(
                sample[:, f],
                max_bin=int(mbf[f]) if mbf else cfg.max_bin,
                min_data_in_bin=cfg.min_data_in_bin,
                bin_type="categorical" if f in cat_idx else "numerical",
                use_missing=cfg.use_missing,
                zero_as_missing=cfg.zero_as_missing,
                forced_bounds=forced.get(f))
            for f in range(self.num_total_features)]
        self._finish_mappers()

    def _finish_mappers(self) -> None:
        self.used_features = np.asarray(
            [f for f, m in enumerate(self.bin_mappers) if not m.is_trivial],
            dtype=np.int32)
        if len(self.used_features) == 0:
            raise ValueError("Cannot construct Dataset: all features are "
                             "trivial (single value)")
        self.max_num_bin = max(
            self.bin_mappers[f].num_bin for f in self.used_features)

    def _plan_bundles(self, sample: np.ndarray, cfg):
        """The JAX package's EFB plan (dataset.py:441-455), or None: with
        ``enable_bundle`` and more than 4 used features, kept only when
        it shrinks the matrix to at most 3/4 of the columns."""
        F = len(self.used_features)
        if not (cfg.enable_bundle and F > 4):
            return None
        from .efb import plan_bundles
        uf = self.used_features
        sample_bins = np.stack(
            [self.bin_mappers[f].values_to_bins(sample[:, f]) for f in uf],
            axis=1)
        plan = plan_bundles(
            sample_bins, [self.bin_mappers[f].num_bin for f in uf],
            [self.bin_mappers[f].most_freq_bin for f in uf],
            max_conflict_rate=cfg.max_conflict_rate,
            max_bundle_bins=cfg.max_bundle_bins)
        if plan.num_bundles > int(0.75 * F):
            return None
        return plan

    def _resolve_categoricals(self, names) -> set:
        cat = self.categorical_feature
        if cat == "auto" or cat is None:
            cfg_cat = self.config.categorical_feature
            if not cfg_cat:
                return set()
            cat = [tok for tok in str(cfg_cat).split(",") if tok]
        out = set()
        for c in cat:
            if isinstance(c, str) and not c.lstrip("-").isdigit():
                if c in names:
                    out.add(names.index(c))
            else:
                out.add(int(c))
        return out

    # -- accessors used by the trainer ----------------------------------
    @property
    def num_features(self) -> int:
        return len(self.used_features)

    def per_feature_num_bins(self) -> np.ndarray:
        return np.asarray([self.bin_mappers[f].num_bin
                           for f in self.used_features], dtype=np.int32)

    def unbundled_bins(self) -> np.ndarray:
        """[R, F] per-feature bins on the host, decoded from the EFB
        bundle columns (dataset.py:741); the matrix itself when it is
        not bundled."""
        return self.feature_bins_of(self.bins)

    def feature_bins_of(self, bins: torch.Tensor) -> np.ndarray:
        """[R, F] per-feature bins on the host of a matrix in this
        dataset's layout (``bins`` itself, or a padded copy)."""
        bins = bins.cpu().numpy()
        bp = self.bundle_plan
        if bp is None:
            return bins
        from .efb import decode_feature_bins
        nb = self.per_feature_num_bins()
        R, F = bins.shape[0], len(nb)
        out = np.empty((R, F), np_bin_dtype(int(nb.max())))
        # row blocks: the int32 intermediates take ~8 bytes a cell
        blk = max(1, (64 << 20) // max(1, 8 * F))
        for r0 in range(0, R, blk):
            raw = bins[r0:r0 + blk, bp.feat_bundle].astype(np.int32)
            out[r0:r0 + blk] = decode_feature_bins(
                raw, bp.feat_offset[None, :], nb[None, :],
                bp.feat_mfb[None, :])
        return out

    def per_feature_nan_bins(self) -> np.ndarray:
        return np.asarray([self.bin_mappers[f].nan_bin
                           for f in self.used_features], dtype=np.int32)

    def per_feature_is_categorical(self) -> np.ndarray:
        return np.asarray([self.bin_mappers[f].bin_type == "categorical"
                           for f in self.used_features], dtype=bool)

    def get_label(self):
        return self.label

    def get_weight(self):
        return self.weight

    def get_group(self):
        return self.group

    def get_init_score(self):
        return self.init_score

    def query_boundaries(self) -> Optional[np.ndarray]:
        """Cumulative query boundaries from the per-query sizes
        (Metadata query_boundaries_, dataset.h:48)."""
        if self.group is None:
            return None
        return np.concatenate([[0], np.cumsum(self.group)]).astype(np.int64)

    def set_field(self, name, value):
        if name == "label":
            self.label = np.asarray(value, dtype=np.float64).reshape(-1)
        elif name == "weight":
            self.weight = None if value is None else np.asarray(
                value, dtype=np.float64).reshape(-1)
        elif name == "group":
            self.group = None if value is None else np.asarray(
                value, dtype=np.int64).reshape(-1)
        elif name == "init_score":
            self.init_score = None if value is None else np.asarray(
                value, dtype=np.float64)
        elif name == "position":
            self.position = (None if value is None
                             else np.asarray(value).reshape(-1))
        else:
            raise ValueError(f"Unknown field {name}")

    def subset(self, used_indices, params: Optional[Dict] = None
               ) -> "Dataset":
        """Row-subset view sharing this dataset's bin mappers
        (Dataset::CopySubrow): the child is already constructed, on this
        dataset's device, and keeps the rows' group, position and
        init_score."""
        self.construct()
        idx = np.sort(np.asarray(used_indices, np.int64))
        child = Dataset.__new__(Dataset)
        child.params = {**self.params, **(params or {})}
        child.config = Config(child.params)
        child._raw_data = None
        child.feature_name = list(self.feature_name)
        child.categorical_feature = self.categorical_feature
        child.reference = self
        child.free_raw_data = True
        child.bin_mappers = self.bin_mappers
        child.bundle_plan = self.bundle_plan
        child.used_features = self.used_features
        child.max_num_bin = self.max_num_bin
        child.num_total_features = self.num_total_features
        child.device = self.device
        rows = torch.from_numpy(idx).to(self.device)
        child.bins = self.bins[rows]
        child.raw_values = (None if self.raw_values is None
                            else self.raw_values[rows])
        child.num_data = len(idx)
        child.label = None if self.label is None else self.label[idx]
        child.weight = None if self.weight is None else self.weight[idx]
        child.init_score = None
        if self.init_score is not None:
            isc = np.asarray(self.init_score)
            child.init_score = isc[idx] if isc.ndim == 1 else isc[idx, :]
        child.group = None
        if self.group is not None:
            # the sizes of the queries the kept rows fall in, in order
            bounds = self.query_boundaries()
            qid = np.searchsorted(bounds, idx, side="right") - 1
            change = np.nonzero(np.diff(qid))[0] + 1
            child.group = np.diff(np.concatenate(
                [[0], change, [len(idx)]])).astype(np.int64)
        child.position = (None if self.position is None
                          else self.position[idx])
        child.pandas_categorical = self.pandas_categorical
        child._constructed = True
        return child

    def __len__(self):
        return self.num_data
