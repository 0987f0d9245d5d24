"""Dataset: binned feature matrix + metadata, resident on the device.

Port of ``lightgbm_tpu/dataset.py`` (``DatasetLoader::
ConstructFromSampleData`` of the reference): sample rows -> fit
``BinMapper``s -> map every row. The binned matrix lives on the device
as uint8, as int16 above 256 bins a column and as int32 above 32,768
(``efb.bin_dtype``; the JAX package stores int32 above 256, with the
same values).

Inputs, as in the JAX package: dense arrays and lists; pandas
DataFrames (``category`` columns become their codes and categorical
features, ``pandas_categorical`` keeps their category lists, and a
valid set aligns to its train set's lists); pyarrow Tables (names from
``column_names``); a CSV/TSV/LibSVM file path with its sidecars
(``io.load_data_file``); a binary Dataset cache written by
``save_binary`` (the JAX package's npz layout, so either package loads
the other's); scipy CSR/CSC matrices; and :class:`Sequence` objects,
streamed in row batches. pandas and pyarrow are imported only by the
code that reads them.

Sparse input never becomes a dense [R, F] matrix: only the binning
sample is densified into bins, and each column's bins are built on the
device from its CSC nonzeros (a column's zero entries all share one
bin), O(nnz) apart from the bundle columns that store a feature whose
zero bin is not its most frequent one. The JAX package densifies each
column in full on the host; the bins and bundle plan are bit-equal.

Out-of-core data (the JAX package's ``data/``): a ``.lgbtpu`` shard
directory (``python -m lightgbm_tpu_torch ingest``, or the JAX
package's) restores its mappers from the shard headers and keeps its
rows mmap-backed behind ``chunk_source`` for the chunked trainer
(``_construct_from_shards``). A train set whose run will train chunked
(``out_of_core=on``, or ``auto`` with a working set over the device's
capacity) is binned in row blocks into a host matrix, so neither the
raw float64 matrix nor the bins are ever whole on the device; on the
card each block is binned there, bit-equal to the resident path.

Differences from the JAX package:
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
``unbundled_bins`` decodes the matrix on the host. Sequence input trains
unbundled, as in the JAX package.

Linear trees (``linear_tree``): the Dataset also keeps ``raw_values``,
the [R, F_total] float32 feature matrix (the JAX package's
``dataset.py:476-487``), on its device; a valid set keeps it when its
train set trains linear trees, and ``subset`` takes its rows. Sparse,
Sequence and binary-cache inputs have no dense raw values and raise.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional

import numpy as np
import torch

from .binning import BinMapper, MISSING_NAN
from .config import Config, resolve_device
from .efb import bin_dtype, np_bin_dtype

__all__ = ["Dataset", "Sequence", "estimate_device_bytes",
           "check_device_capacity", "bin_rows"]


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


def values_to_bins_torch(m: BinMapper, x: torch.Tensor,
                         x_host: np.ndarray) -> torch.Tensor:
    """``m.values_to_bins`` of the values ``x`` on their device (int64):
    ``torch.searchsorted`` (side=left, the numpy call values_to_bins
    makes), NaN to the NaN/default bin; ``x_host`` is the same values on
    the host, which categorical mappers read."""
    if m.bin_type == "categorical":
        return torch.from_numpy(m.values_to_bins(x_host)).to(
            x.device, torch.int64)
    nan = torch.isnan(x)
    ub = torch.from_numpy(m.bin_upper_bound).to(x.device)
    b = torch.searchsorted(ub, torch.where(nan, 0.0, x))
    nb = (m.num_bin - 1 if m.missing_type == MISSING_NAN
          else m.default_bin)
    return torch.where(nan, nb, b)


def bin_rows(X: np.ndarray, mappers, used_features, dtype,
             device: torch.device, out: Optional[np.ndarray] = None
             ) -> np.ndarray:
    """[r, F_used] bins of the raw rows ``X`` as a host array of numpy
    ``dtype`` (written into ``out`` when given), binned where ``device``
    says: on the card in row blocks (each block's raw values staged
    there, never the whole matrix), on the CPU by ``values_to_bins``;
    the two are bit-equal."""
    X = np.asarray(X, np.float64)
    if out is None:
        out = np.empty((X.shape[0], len(used_features)), dtype)
    if device.type != "cuda":
        for j, f in enumerate(used_features):
            out[:, j] = mappers[f].values_to_bins(X[:, f])
        return out
    tdt = torch.from_numpy(out[:0]).dtype
    # 64 MiB of raw values a block; its bins fill one device block
    blk = max(1, (64 << 20) // max(1, 8 * X.shape[1]))
    ob = torch.empty((min(blk, X.shape[0]), len(used_features)), dtype=tdt,
                     device=device)
    for r0 in range(0, X.shape[0], blk):
        xh = np.ascontiguousarray(X[r0:r0 + blk])
        xd = torch.from_numpy(xh).to(device)
        n = xh.shape[0]
        for j, f in enumerate(used_features):
            ob[:n, j] = values_to_bins_torch(mappers[f], xd[:, f], xh[:, f])
        out[r0:r0 + n] = ob[:n].cpu().numpy()
    return out


class Sequence:
    """Generic batched-row data access (dataset.py:104; the reference's
    basic.py Sequence).

    Subclass and implement ``__getitem__`` (int -> 1-D row, slice -> 2-D
    batch) and ``__len__``. Dataset streams rows through it in
    ``batch_size`` chunks, so the raw matrix never materializes.
    """

    batch_size = 4096

    def __getitem__(self, idx):
        raise NotImplementedError("Sequence must implement __getitem__")

    def __len__(self):
        raise NotImplementedError("Sequence must implement __len__")


# row block of the Sequence stream (data/reader.py DEFAULT_CHUNK_ROWS)
_SEQUENCE_CHUNK_ROWS = 65536


def _is_sequence_input(data) -> bool:
    if isinstance(data, Sequence):
        return True
    return (isinstance(data, list) and len(data) > 0
            and all(isinstance(s, Sequence) for s in data))


def _is_sparse(data) -> bool:
    return hasattr(data, "tocsc") and hasattr(data, "tocsr")


def _is_arrow(data) -> bool:
    return hasattr(data, "column_names") and hasattr(data, "num_rows")


def _is_pandas_df(data) -> bool:
    return (hasattr(data, "dtypes") and hasattr(data, "columns")
            and hasattr(data, "values") and not _is_arrow(data))


def _data_from_pandas(df, align_categories=None):
    """DataFrame -> (f64 matrix, category column indices, category
    lists) (dataset.py:143; the reference's basic.py
    ``_data_from_pandas``): ``category`` columns map to their codes
    (missing -> NaN), every other column must be int/float/bool, and
    with ``align_categories`` (a valid set's or a predict frame's) the
    codes are aligned to the training category lists."""
    import pandas as pd

    def _is_cat(dt):
        return isinstance(dt, pd.CategoricalDtype) or str(dt) == "category"

    cat_idx = [i for i, dt in enumerate(df.dtypes) if _is_cat(dt)]
    bad = [str(c) for c, dt in zip(df.columns, df.dtypes)
           if not _is_cat(dt) and getattr(dt, "kind", "O") not in "iufb"]
    if bad:
        raise ValueError(
            "DataFrame.dtypes for data must be int, float or bool.\n"
            "Did not expect the data types in the following fields: "
            + ", ".join(bad))
    if align_categories is not None and len(align_categories) != len(
            cat_idx):
        raise ValueError(
            "train and valid dataset categorical_feature do not match.")
    out = np.empty(df.shape, np.float64)
    cats_out = []
    j = 0
    for i, col in enumerate(df.columns):
        s = df.iloc[:, i]
        if i in cat_idx:
            if align_categories is not None:
                s = s.cat.set_categories(align_categories[j])
            cats_out.append(list(s.cat.categories))
            codes = np.asarray(s.cat.codes, np.float64)
            codes[codes < 0] = np.nan
            out[:, i] = codes
            j += 1
        else:
            out[:, i] = np.asarray(s, np.float64)
    return out, cat_idx, cats_out


def _to_2d_float(data) -> np.ndarray:
    if _is_arrow(data):
        # a pyarrow Table: column by column, chunked arrays concatenate
        cols = [np.asarray(data.column(i).to_numpy(zero_copy_only=False),
                           dtype=np.float64)
                for i in range(data.num_columns)]
        return np.ascontiguousarray(np.column_stack(cols))
    if hasattr(data, "values") and hasattr(data, "columns"):  # DataFrame
        arr = data.values
    else:
        arr = np.asarray(data)
    if arr.ndim == 1:
        arr = arr[:, None]
    return np.ascontiguousarray(arr, dtype=np.float64)


def _json_scalar(o):
    """JSON form of the numpy scalars a category list may hold."""
    if isinstance(o, np.integer):
        return int(o)
    if isinstance(o, np.floating):
        return float(o)
    if isinstance(o, np.bool_):
        return bool(o)
    return str(o)


def _column_multiset(vals: np.ndarray, n_zero: int):
    """(sorted distinct non-NaN values, counts, NaN count) of a sparse
    column: its stored values plus ``n_zero`` implicit zeros; the
    summary ``BinMapper.from_values`` takes of the dense column."""
    nan = np.isnan(vals)
    dv, cnt = np.unique(vals[~nan], return_counts=True)
    if n_zero:
        pos = int(np.searchsorted(dv, 0.0))
        if pos < len(dv) and dv[pos] == 0.0:
            cnt[pos] += n_zero
        else:
            dv = np.insert(dv, pos, 0.0)
            cnt = np.insert(cnt, pos, n_zero)
    return dv, cnt.astype(np.int64), int(nan.sum())


class _SequenceReader:
    """Row blocks and sampled rows of Sequence objects
    (data/reader.py:317 SequenceChunkReader)."""

    def __init__(self, seqs):
        self.seqs = list(seqs) if isinstance(seqs, (list, tuple)) \
            else [seqs]
        lens = [len(s) for s in self.seqs]
        self.num_rows = int(sum(lens))
        self._starts = np.concatenate([[0], np.cumsum(lens)])
        first = np.asarray(self.seqs[0][0], dtype=np.float64)
        self.num_features = int(first.reshape(-1).shape[0])

    @staticmethod
    def _as_block(batch) -> np.ndarray:
        batch = np.asarray(batch, dtype=np.float64)
        if batch.ndim == 1:
            batch = batch[None, :]
        return np.ascontiguousarray(batch)

    def iter_blocks(self, chunk_rows: int):
        for s in self.seqs:
            bs = int(getattr(s, "batch_size", 0) or chunk_rows)
            bs = min(max(1, bs), chunk_rows)
            for lo in range(0, len(s), bs):
                yield self._as_block(s[lo:lo + bs])

    def read_rows_at(self, global_idx: np.ndarray) -> np.ndarray:
        """Gather rows, one slice call per run of consecutive rows of
        an owning sequence."""
        global_idx = np.asarray(global_idx, np.int64)
        out = np.empty((len(global_idx), self.num_features), np.float64)
        owner = np.searchsorted(self._starts, global_idx, side="right") - 1
        for si in np.unique(owner):
            sel = np.nonzero(owner == si)[0]
            local = global_idx[sel] - int(self._starts[si])
            seq = self.seqs[int(si)]
            runs = np.split(sel, np.nonzero(np.diff(local) != 1)[0] + 1)
            for run in runs:
                lo = int(local[np.searchsorted(sel, run[0])])
                out[run] = self._as_block(seq[lo:lo + len(run)])
        return out


class Dataset:
    """Binned training data (dataset.h:487 analog)."""

    def __init__(self, data, label=None, weight=None, group=None,
                 init_score=None, feature_name="auto",
                 categorical_feature="auto", params: Optional[Dict] = None,
                 reference: Optional["Dataset"] = None,
                 free_raw_data: bool = True,
                 bin_mappers: Optional[List[BinMapper]] = None,
                 position=None):
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
        # True when the loader kept only this rank's block of the rows
        # (a row-sharded parallel learner without pre_partition)
        self.auto_partitioned = False
        # shard-backed row stream (data/chunked.py ShardSource)
        self.chunk_source = None
        # [num_data, F] on the device, or [num_data, G] under EFB; on the
        # host for a run that trains chunked
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

    @property
    def bins(self) -> Optional[torch.Tensor]:
        """The binned matrix. A shard-backed dataset streams its rows
        from disk (``chunk_source``) and materializes them here, on the
        host, only when something asks for the whole matrix."""
        if self._bins is None and self.chunk_source is not None:
            src = self.chunk_source
            self._bins = torch.from_numpy(np.ascontiguousarray(
                src.read_rows(0, src.num_rows)))
        return self._bins

    @bins.setter
    def bins(self, value) -> None:
        self._bins = value

    def construct(self) -> "Dataset":
        if self._constructed:
            return self
        self.config = Config(self.params)
        cfg = self.config
        from .parallel.distributed import maybe_init_distributed
        maybe_init_distributed(cfg)
        if self.reference is not None:
            # a valid set lives where its train set lives unless told
            self.reference.construct()
        if (self.reference is not None
                and "device_type" not in cfg.explicit()):
            self.device = self.reference.device
        else:
            self.device = resolve_device(cfg.device_type)
        if _is_sequence_input(self._raw_data):
            return self._construct_from_sequences()
        file_names: Optional[List[str]] = None
        from_file = isinstance(self._raw_data, (str, os.PathLike))
        if from_file:
            from .data.shardfile import is_shard_path
            if is_shard_path(self._raw_data):
                return self._construct_from_shards(self._raw_data)
        if from_file and self._is_binary_file(self._raw_data):
            # the binary cache restores the constructed state directly
            self._load_binary(self._raw_data)
            sl = self._partition_slice(self.num_data)
            if sl is not None:
                self.bins = self.bins[sl.start:sl.stop]
                self._apply_partition(sl)
            return self._finish()
        if from_file:
            from .io import load_data_file
            hint = (self.reference.num_total_features
                    if self.reference is not None else 0)
            loaded = load_data_file(self._raw_data, cfg,
                                    num_features_hint=hint)
            self._raw_data = loaded.X
            file_names = loaded.feature_names
            for fld in ("label", "weight", "group", "init_score",
                        "position"):
                if getattr(self, fld) is None:
                    setattr(self, fld, getattr(loaded, fld))
        sparse = _is_sparse(self._raw_data)
        pd_cat_idx = None
        if sparse:
            data = self._raw_data.tocsr()
        elif _is_pandas_df(self._raw_data):
            # a valid set aligns to its train set's category lists; a
            # train set built without pandas gives [], so a categorical
            # frame against it raises the mismatch error
            ref_cats = None
            if self.reference is not None:
                ref_cats = self.reference.pandas_categorical or []
            data, pd_cat_idx, self.pandas_categorical = _data_from_pandas(
                self._raw_data, ref_cats)
        else:
            data = _to_2d_float(self._raw_data)
        if (self.reference is not None
                and data.shape[1] != self.reference.num_total_features):
            if from_file and data.shape[1] < \
                    self.reference.num_total_features:
                # a LibSVM valid file whose widest index is below the
                # train set's: absent entries are zero (CreateValid)
                pad = self.reference.num_total_features - data.shape[1]
                data = np.concatenate(
                    [data, np.zeros((data.shape[0], pad))], axis=1)
            else:
                raise ValueError(
                    f"validation data has {data.shape[1]} features but "
                    f"training data has {self.reference.num_total_features}")
        self.num_data, self.num_total_features = data.shape
        if isinstance(self.feature_name, (list, tuple)) and self.feature_name:
            names = list(self.feature_name)
        elif _is_arrow(self._raw_data):
            names = [str(c) for c in self._raw_data.column_names]
        elif hasattr(self._raw_data, "columns"):
            names = [str(c) for c in self._raw_data.columns]
        elif file_names and len(file_names) == self.num_total_features:
            names = file_names
        else:
            names = [f"Column_{i}" for i in range(self.num_total_features)]
        self.feature_name = names
        cat_idx = self._resolve_categoricals(names)
        if pd_cat_idx and self.categorical_feature in ("auto", None):
            # categorical_feature='auto': pandas category columns become
            # categorical features
            cat_idx = cat_idx | set(pd_cat_idx)

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
            if sparse:
                sample = sample.tocsc()
            owned = self._owned_features()
            if self._given_mappers:
                if len(self.bin_mappers) != self.num_total_features:
                    raise ValueError("bin_mappers must hold one mapper per "
                                     "feature")
                self._finish_mappers()
            elif sparse:
                self._fit_mappers(lambda f: _column_multiset(
                    sample.data[sample.indptr[f]:sample.indptr[f + 1]],
                    sample.shape[0] - int(sample.indptr[f + 1]
                                          - sample.indptr[f])),
                    cat_idx, cfg, owned)
            else:
                self._fit_mappers(lambda f: sample[:, f], cat_idx, cfg,
                                  owned)
            # the sample's bins column-major: each column's bits pack
            # from contiguous memory
            self.bundle_plan = None if (owned is not None
                                        and cfg.pre_partition) else \
                self._plan_bundles(
                    lambda: self._sparse_sample_bins(sample) if sparse else
                    np.stack([self.bin_mappers[f].values_to_bins(
                        sample[:, f]) for f in self.used_features]).T, cfg)
        sl = self._partition_slice(self.num_data)
        if sl is not None:
            data = data[sl.start:sl.stop]
            self._apply_partition(sl)

        if sparse:
            self._linear_unsupported("sparse")
            self.bins = self._sparse_bins(data.tocsc())
            return self._finish()
        F = len(self.used_features)
        bp = self.bundle_plan
        dtype = bin_dtype(self.max_num_bin)
        if bp is None and self._trains_chunked(F, dtype):
            # the run streams row chunks: bin in row blocks into a host
            # matrix (the chunked trainer's ArraySource), pinned on the
            # card's host so that chunks copy straight from it
            self.bins = torch.empty(
                (self.num_data, F), dtype=dtype,
                pin_memory=self.device.type == "cuda")
            bin_rows(data, self.bin_mappers, self.used_features,
                     np_bin_dtype(self.max_num_bin), self.device,
                     out=self.bins.numpy())
        elif self.device.type == "cuda":
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
        if self._trains_linear():
            # linear trees regress on raw feature values: keep them
            # resident (the reference keeps raw data, dataset.cpp)
            self.raw_values = torch.from_numpy(
                np.ascontiguousarray(data, np.float32)).to(self.device)
        return self._finish()

    def _finish(self) -> "Dataset":
        """The checks every construction path ends with."""
        if self.label is None and not self.params.get("_allow_no_label"):
            raise ValueError("Dataset has no label")
        if self.group is not None and int(self.group.sum()) != self.num_data:
            raise ValueError(
                f"sum of group sizes ({int(self.group.sum())}) does not "
                f"match num_data ({self.num_data})")
        if self.free_raw_data:
            self._raw_data = None
        self._constructed = True
        return self

    def _trains_chunked(self, width: int, dtype) -> bool:
        """This train set's run will stream row chunks (the JAX
        package's out-of-core gate, ``gbdt.py:312-386``, as far as the
        Dataset can see it): ``out_of_core=on``, or ``auto`` with a
        working set over the device's capacity. The trainer makes the
        final call and moves the matrix to the device if it trains
        resident after all."""
        cfg = self.config
        if self.reference is not None or str(cfg.out_of_core) == "off":
            return False
        if str(cfg.out_of_core) == "on":
            return True
        itemsize = torch.empty((), dtype=dtype).element_size()
        try:
            check_device_capacity(
                self.num_data, width, itemsize, int(cfg.num_leaves),
                self.max_num_bin, bool(cfg.hist_subtraction), self.device,
                num_class=max(1, int(cfg.num_class)))
        except MemoryError:
            return True
        return False

    def _construct_from_shards(self, path) -> "Dataset":
        """Construct from a ``.lgbtpu`` shard directory (the JAX
        package's ``_construct_from_shards``, ``dataset.py:493-528``):
        every shard is validated (checksum and set completeness), the
        BinMappers restore from the shard headers, and the binned rows
        stay mmap-backed behind ``chunk_source`` for the chunked
        trainer."""
        from .data.chunked import ShardSource
        from .data.shardfile import open_shard_dir
        if self.reference is not None:
            raise ValueError("a shard dataset cannot be a validation set; "
                             "validate on in-memory data")
        readers, h0 = open_shard_dir(str(path))
        self.bin_mappers = readers[0].mappers()
        self.num_total_features = int(h0["num_total_features"])
        self.used_features = np.asarray(h0["used_features"], np.int32)
        self.max_num_bin = int(h0["max_num_bin"])
        if not (isinstance(self.feature_name, (list, tuple))
                and self.feature_name):
            self.feature_name = list(h0["feature_names"])
        self.num_data = int(h0["total_rows"])
        if self.label is None and h0.get("has_label"):
            self.label = np.concatenate(
                [np.asarray(r.label, np.float64) for r in readers])
        if self.weight is None and h0.get("has_weight"):
            self.weight = np.concatenate(
                [np.asarray(r.weight, np.float64) for r in readers])
        self.bundle_plan = None   # shards store unbundled feature space
        self.chunk_source = ShardSource(readers)
        self._linear_unsupported("shard")
        self.raw_values = None
        return self._finish()

    def _trains_linear(self) -> bool:
        """This set, or the train set it validates, trains linear trees."""
        ref = self.reference
        return bool(self.config.linear_tree
                    or (ref is not None and ref.config.linear_tree))

    def _linear_unsupported(self, what: str) -> None:
        if self._trains_linear():
            raise ValueError(f"linear_tree needs dense raw feature values; "
                             f"{what} input is not supported with linear "
                             "trees")

    def _construct_from_sequences(self) -> "Dataset":
        """Two-round load from Sequence objects (dataset.py:533): a
        sampled read fits the mappers, then row blocks stream through
        and are binned block by block, so the raw matrix never exists.
        The streamed train set stays unbundled; a valid set is encoded
        into its train set's bundle layout."""
        cfg = self.config
        reader = _SequenceReader(self._raw_data)
        self.num_data = reader.num_rows
        self.num_total_features = reader.num_features
        ref = self.reference
        if ref is not None:
            if self.num_total_features != ref.num_total_features:
                raise ValueError(
                    f"validation data has {self.num_total_features} "
                    f"features but training data has "
                    f"{ref.num_total_features}")
            self.bin_mappers = ref.bin_mappers
            self.used_features = ref.used_features
            self.max_num_bin = ref.max_num_bin
            self.bundle_plan = ref.bundle_plan
            self.feature_name = list(ref.feature_name)
        else:
            self.feature_name = [f"Column_{i}"
                                 for i in range(self.num_total_features)]
            cat_idx = self._resolve_categoricals(self.feature_name)
            sample_cnt = min(cfg.bin_construct_sample_cnt, self.num_data)
            rng = np.random.RandomState(cfg.data_random_seed)
            sample = reader.read_rows_at(np.sort(rng.choice(
                self.num_data, sample_cnt, replace=False)))
            self._fit_mappers(lambda f: sample[:, f], cat_idx, cfg)
            self.bundle_plan = None
        self._linear_unsupported("Sequence")
        bp = self.bundle_plan
        F = len(self.used_features)
        if bp is not None:
            from .efb import encode_rows
            out = np.zeros((self.num_data, bp.num_bundles),
                           np_bin_dtype(bp.max_bundle_bins))
        else:
            out = np.empty((self.num_data, F), np_bin_dtype(self.max_num_bin))
        row0 = 0
        for batch in reader.iter_blocks(_SEQUENCE_CHUNK_ROWS):
            r = batch.shape[0]
            bb = np.empty((r, F), np.int64)
            for j, f in enumerate(self.used_features):
                bb[:, j] = self.bin_mappers[f].values_to_bins(batch[:, f])
            if bp is not None:
                encode_rows(bp, bb, out, row0)
            else:
                out[row0:row0 + r] = bb
            row0 += r
        self.bins = torch.from_numpy(out).to(self.device)
        return self._finish()

    def _device_columns(self, data: np.ndarray, dtype):
        """Yield (j, bins of used feature j) on the device: ValueToBin
        per column with torch.searchsorted (side=left, the numpy call
        values_to_bins makes), NaN to the NaN/default bin; categorical
        columns are mapped on the host."""
        dev = self.device
        x_all = torch.from_numpy(data).to(dev)
        for j, f in enumerate(self.used_features):
            yield j, values_to_bins_torch(self.bin_mappers[f], x_all[:, f],
                                          data[:, f]).to(dtype)

    def _sparse_sample_bins(self, sample) -> np.ndarray:
        """[S, F] bins (column-major) of the CSC binning sample: each
        column's zero bin, then its stored values' bins."""
        out = np.empty((len(self.used_features), sample.shape[0]),
                       np_bin_dtype(self.max_num_bin))
        for j, f in enumerate(self.used_features):
            m = self.bin_mappers[f]
            lo, hi = sample.indptr[f], sample.indptr[f + 1]
            out[j] = m.values_to_bins(np.zeros(1))[0]
            out[j, sample.indices[lo:hi]] = m.values_to_bins(
                sample.data[lo:hi])
        return out.T

    def _sparse_bins(self, csc) -> torch.Tensor:
        """The [R, F] (or bundled [R, G]) bin matrix of a CSC matrix,
        built on the device from each used column's nonzeros: the
        column's zero bin everywhere, then its stored values' bins at
        their rows. A bundle member whose zero bin is its most frequent
        bin writes only its rows off that bin, as the dense encoder
        (efb.encode_bundles) does; any other member is written whole."""
        from .efb import _write_column_torch
        dev, R = self.device, self.num_data
        bp = self.bundle_plan
        width = len(self.used_features) if bp is None else bp.num_bundles
        dtype = bin_dtype(self.max_num_bin if bp is None
                          else bp.max_bundle_bins)
        out = torch.zeros((R, width), dtype=dtype, device=dev)
        rows_all = torch.from_numpy(csc.indices).to(dev)
        vals_all = torch.from_numpy(
            np.ascontiguousarray(csc.data, np.float64)).to(dev)
        ptr = csc.indptr
        for j, f in enumerate(self.used_features):
            m = self.bin_mappers[f]
            lo, hi = int(ptr[f]), int(ptr[f + 1])
            rows = rows_all[lo:hi].long()
            b = values_to_bins_torch(m, vals_all[lo:hi], csc.data[lo:hi])
            zero_bin = int(m.values_to_bins(np.zeros(1))[0])
            g = j if bp is None else int(bp.feat_bundle[j])
            off = 0 if bp is None else int(bp.feat_offset[j])
            if off == 0:
                out[:, g] = zero_bin
                out[rows, g] = b.to(dtype)
            elif zero_bin == int(bp.feat_mfb[j]):
                out[rows, g] = torch.where(b != zero_bin, (b + off).to(dtype),
                                           out[rows, g])
            else:
                col = torch.full((R,), zero_bin, dtype=torch.int64,
                                 device=dev)
                col[rows] = b
                _write_column_torch(bp, out, j, col)
        return out

    def _fit_mappers(self, column, cat_idx: set, cfg,
                     owned: Optional[set] = None) -> None:
        """Fit per-feature BinMappers from a row sample (the JAX
        package's _fit_mappers, dataset.py:619-665). ``column(f)`` is
        the sample's column f: its values, or the (distinct values,
        counts, NaN count) multiset of a sparse column. With ``owned``
        (a parallel run) this process fits only those features and
        ``sync_bin_mappers`` gathers the rest from their owners
        (dataset_loader.cpp:1070)."""
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
        self.bin_mappers = []
        for f in range(self.num_total_features):
            if owned is not None and f not in owned:
                self.bin_mappers.append(BinMapper())   # filled by sync
                continue
            kw = dict(
                max_bin=int(mbf[f]) if mbf else cfg.max_bin,
                min_data_in_bin=cfg.min_data_in_bin,
                bin_type="categorical" if f in cat_idx else "numerical",
                use_missing=cfg.use_missing,
                zero_as_missing=cfg.zero_as_missing,
                forced_bounds=forced.get(f))
            col = column(f)
            self.bin_mappers.append(
                BinMapper.from_distinct(*col, **kw) if isinstance(col, tuple)
                else BinMapper.from_values(col, **kw))
        if owned is not None:
            from .parallel.distributed import sync_bin_mappers
            self.bin_mappers = sync_bin_mappers(self.bin_mappers)
        self._finish_mappers()

    def _parallel_learner(self):
        """The plan class of this run in its process group, or None; a
        valid set follows its train set's learner."""
        from .parallel.data_parallel import learner_class
        from .parallel.distributed import world_size
        cfg = (self.reference.config if self.reference is not None
               else self.config)
        return learner_class(cfg, world_size())

    def _owned_features(self) -> Optional[set]:
        """The features this process fits under a parallel learner
        (``feature_blocks``), or None (it fits them all)."""
        if self._parallel_learner() is None:
            return None
        from .parallel.distributed import feature_blocks, rank, world_size
        return set(int(f) for f in feature_blocks(
            self.num_total_features, world_size())[rank()])

    def _partition_slice(self, n: int) -> Optional[slice]:
        """The rows this rank keeps when the caller did not pre-partition
        under a row-sharded learner: its ``np.array_split`` block, the
        loader's rank/num_machines split (dataset_loader.cpp:203;
        dataset.py:698-722). Valid sets take the same rule, so they are
        co-partitioned with the train set."""
        cls = self._parallel_learner()
        if (cls is None or not cls.rows_sharded
                or bool(self.config.pre_partition)):
            return None
        if self.group is not None:
            raise NotImplementedError(
                "multi-process auto-partition does not split query/group "
                "data; pre-partition queries per rank and set "
                "pre_partition=true")
        from .parallel.distributed import feature_blocks, rank, world_size
        blk = feature_blocks(n, world_size())[rank()]
        self.auto_partitioned = True
        lo = int(blk[0]) if len(blk) else n
        return slice(lo, lo + len(blk))

    def _apply_partition(self, sl: slice) -> None:
        for fld in ("label", "weight", "position", "init_score"):
            v = getattr(self, fld)
            if v is not None:
                setattr(self, fld, np.asarray(v)[sl])
        self.num_data = sl.stop - sl.start

    def _finish_mappers(self) -> None:
        self.used_features = np.asarray(
            [f for f, m in enumerate(self.bin_mappers) if not m.is_trivial],
            dtype=np.int32)
        if len(self.used_features) == 0:
            raise ValueError("Cannot construct Dataset: all features are "
                             "trivial (single value)")
        self.max_num_bin = max(
            self.bin_mappers[f].num_bin for f in self.used_features)

    def _plan_bundles(self, sample_bins, cfg):
        """The JAX package's EFB plan (dataset.py:441-455) from the [S, F]
        bins of the binning sample (``sample_bins()``), or None: with
        ``enable_bundle`` and more than 4 used features, kept only when
        it shrinks the matrix to at most 3/4 of the columns."""
        F = len(self.used_features)
        if not (cfg.enable_bundle and F > 4):
            return None
        from .efb import plan_bundles
        uf = self.used_features
        plan = plan_bundles(
            sample_bins(), [self.bin_mappers[f].num_bin for f in uf],
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

    def add_features_from(self, other: "Dataset") -> "Dataset":
        """Append ``other``'s features to this dataset in place
        (dataset.py:867; Dataset::AddFeaturesFrom). Both must be
        constructed with the same ``num_data`` and unbundled; ``other``'s
        label, weight and group are discarded, and a colliding name gets
        the first free ``_1``, ``_2``, ... suffix."""
        self.construct()
        other.construct()
        if self.num_data != other.num_data:
            raise ValueError(
                f"cannot add features: num_data differs "
                f"({self.num_data} vs {other.num_data})")
        if self.bundle_plan is not None or other.bundle_plan is not None:
            raise ValueError(
                "add_features_from does not support EFB-bundled datasets "
                "(set enable_bundle=false on both)")
        base = self.num_total_features
        self.max_num_bin = max(self.max_num_bin, other.max_num_bin)
        dtype = bin_dtype(self.max_num_bin)
        self.bins = torch.cat([self.bins.to(dtype),
                               other.bins.to(self.device, dtype)], dim=1)
        self.bin_mappers = list(self.bin_mappers) + list(other.bin_mappers)
        self.used_features = np.concatenate(
            [self.used_features, other.used_features + base])
        names = list(self.feature_name)
        taken = set(names)
        for nm in other.feature_name:
            new, i = nm, 1
            while new in taken:
                new = f"{nm}_{i}"
                i += 1
            taken.add(new)
            names.append(new)
        self.feature_name = names
        self.num_total_features = base + other.num_total_features
        if self.raw_values is not None and other.raw_values is not None:
            self.raw_values = torch.cat(
                [self.raw_values, other.raw_values.to(self.device)], dim=1)
        else:
            self.raw_values = None
        return self

    # -- binary dataset cache (dataset.py:914-1016; SaveBinaryFile /
    # LoadFromBinFile): the constructed state, bins + mappers + metadata,
    # in the JAX package's npz layout and key, its bins uint8 or int32
    _BINARY_KEY = "lightgbm_tpu_dataset_v1"

    def save_binary(self, filename) -> "Dataset":
        self.construct()
        bins = self.bins.cpu().numpy()
        if bins.dtype != np.uint8:
            bins = bins.astype(np.int32)
        payload = {
            self._BINARY_KEY: np.asarray(1),
            "bins": bins,
            "used_features": self.used_features,
            "max_num_bin": np.asarray(self.max_num_bin),
            "feature_name": np.asarray(self.feature_name),
        }
        for fld in ("label", "weight", "group", "init_score", "position"):
            v = getattr(self, fld)
            if v is not None:
                payload[fld] = v
        if self.pandas_categorical is not None:
            import json
            payload["pandas_categorical"] = np.asarray(json.dumps(
                self.pandas_categorical, default=_json_scalar))
        scal, ubs, cats = [], [], []
        ub_off, cat_off = [0], [0]
        for m in self.bin_mappers:
            s, ub, ct = m.state_arrays()
            scal.append(s)
            ubs.append(ub)
            cats.append(ct)
            ub_off.append(ub_off[-1] + len(ub))
            cat_off.append(cat_off[-1] + len(ct))
        payload.update(
            mapper_scalars=np.stack(scal),
            mapper_ub=np.concatenate(ubs) if ubs else np.empty(0),
            mapper_ub_off=np.asarray(ub_off, np.int64),
            mapper_cats=(np.concatenate(cats) if cats
                         else np.empty(0, np.int64)),
            mapper_cat_off=np.asarray(cat_off, np.int64))
        if self.bundle_plan is not None:
            fb, fo, fm, bnb, bscal = self.bundle_plan.state_arrays()
            payload.update(efb_feat_bundle=fb, efb_feat_offset=fo,
                           efb_feat_mfb=fm, efb_bundle_bins=bnb,
                           efb_scalars=bscal)
        with open(filename, "wb") as f:
            np.savez_compressed(f, **payload)
        return self

    @staticmethod
    def _is_binary_file(path) -> bool:
        try:
            with open(path, "rb") as f:
                return f.read(2) == b"PK"  # npz = zip container
        except OSError:
            return False

    def _load_binary(self, path) -> None:
        """Restore the state :meth:`save_binary` wrote (either package's
        file): the bins move to this dataset's device in the port's
        column type (``efb.bin_dtype``)."""
        self._linear_unsupported("binary cache")
        with np.load(path, allow_pickle=False) as z:
            if self._BINARY_KEY not in z:
                raise ValueError(
                    f"{path} is not a lightgbm_tpu binary dataset")
            bins = z["bins"]
            self.used_features = z["used_features"]
            self.max_num_bin = int(z["max_num_bin"])
            self.feature_name = [str(s) for s in z["feature_name"]]
            for fld in ("label", "weight", "group", "init_score",
                        "position"):
                if fld in z and getattr(self, fld) is None:
                    setattr(self, fld, z[fld])
            if "pandas_categorical" in z:
                import json
                self.pandas_categorical = json.loads(
                    str(z["pandas_categorical"]))
            scal = z["mapper_scalars"]
            ub, ub_off = z["mapper_ub"], z["mapper_ub_off"]
            cats, cat_off = z["mapper_cats"], z["mapper_cat_off"]
            self.bundle_plan = None
            if "efb_scalars" in z:
                from .efb import BundlePlan
                self.bundle_plan = BundlePlan.from_state_arrays(
                    z["efb_feat_bundle"], z["efb_feat_offset"],
                    z["efb_feat_mfb"], z["efb_bundle_bins"],
                    z["efb_scalars"])
        self.bin_mappers = [
            BinMapper.from_state_arrays(
                scal[i], ub[ub_off[i]:ub_off[i + 1]],
                cats[cat_off[i]:cat_off[i + 1]])
            for i in range(scal.shape[0])]
        width = (self.max_num_bin if self.bundle_plan is None
                 else self.bundle_plan.max_bundle_bins)
        self.bins = torch.from_numpy(
            bins.astype(np_bin_dtype(width), copy=False)).to(self.device)
        self.num_data = bins.shape[0]
        self.num_total_features = len(self.bin_mappers)
        self._raw_data = None
