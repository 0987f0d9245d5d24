"""Chunked row-block readers: stream [r, F] blocks, never the matrix (a
copy of ``lightgbm_tpu/data/reader.py`` over the port's ``io.py``).

The in-memory loader (:func:`lightgbm_tpu_torch.io.load_data_file`)
materializes the full dense matrix; these readers yield fixed-size row
blocks instead so the ingest pipeline (sketch pass + shard writer) and
the Sequence construction path run in O(chunk) host memory.  Column
semantics (label/weight/ignore specs, header handling, NaN tokens,
delimiter autodetect) reuse ``io.py``'s helpers verbatim so a file
ingested chunked bins identically to one loaded whole.

Readers:

- :class:`CsvChunkReader` — delimited text; first block fixes the
  width/column layout, later blocks must agree (ragged tails raise).
  LibSVM needs a global max-feature-index pass and stays on the
  in-memory loader.
- :class:`NpyChunkReader` — ``.npy`` via ``np.load(mmap_mode="r")``
  (zero-copy) and ``.npz`` members via a sequential stream over the
  zip entry, so a compressed archive never decompresses whole.
- :class:`ArrayChunkReader` — an in-RAM array, sliced (used when an
  already-constructed Dataset falls back to the chunked trainer).
- :class:`SequenceChunkReader` — ``Dataset`` Sequence
  objects; also provides the random-row gather the sampled mapper fit
  needs (grouped per sequence, one ``__getitem__`` batch per run).
"""

from __future__ import annotations

import os
import zipfile
from typing import Iterator, List, NamedTuple, Optional

import numpy as np

__all__ = ["Chunk", "ChunkReader", "CsvChunkReader", "NpyChunkReader",
           "ArrayChunkReader", "SequenceChunkReader", "open_chunk_reader",
           "DEFAULT_CHUNK_ROWS"]

DEFAULT_CHUNK_ROWS = 65536


class Chunk(NamedTuple):
    row0: int
    X: np.ndarray                  # [r, F] float64 raw values
    label: Optional[np.ndarray]    # [r] float64 or None
    weight: Optional[np.ndarray]   # [r] float64 or None


class ChunkReader:
    """Base: ``iter_chunks`` yields :class:`Chunk` blocks in row order."""

    num_features: int = 0
    num_rows: Optional[int] = None   # None until a full pass (CSV)
    feature_names: Optional[List[str]] = None
    has_label: bool = False

    def iter_chunks(self, chunk_rows: int) -> Iterator[Chunk]:
        raise NotImplementedError


class CsvChunkReader(ChunkReader):
    """Delimited text file, parsed ``chunk_rows`` lines at a time."""

    def __init__(self, path: str, config=None):
        from ..config import Config
        from ..io import (_detect_delimiter, _is_libsvm, _load_sidecar,
                          _parse_column_spec, _parse_index_list)
        self.path = str(path)
        if not os.path.exists(self.path):
            raise FileNotFoundError(f"data file not found: {self.path}")
        cfg = config if config is not None else Config({})
        self.has_header = bool(getattr(cfg, "header", False))
        # probe the first data line for format detection (parser.cpp:317)
        with open(self.path, "r", encoding="utf-8") as f:
            first = ""
            probe = ""
            for ln in f:
                ln = ln.rstrip("\r\n")
                if not ln.strip():
                    continue
                if not first:
                    first = ln
                    if not self.has_header:
                        probe = ln
                        break
                else:
                    probe = ln
                    break
            if not first:
                raise ValueError(f"data file is empty: {self.path}")
            if not probe:
                probe = first
        self.delim = _detect_delimiter(probe)
        if _is_libsvm(probe, self.delim):
            raise NotImplementedError(
                "chunked ingest does not support LibSVM (the dense "
                "width needs a global max-feature-index pass); load "
                "it through lightgbm_tpu_torch.io.load_data_file instead")
        names: List[str] = []
        if self.has_header:
            names = [t.strip() for t in first.split(self.delim)]
        width = len(first.split(self.delim)) if names else \
            len(probe.split(self.delim))
        if not names:
            names = [f"Column_{i}" for i in range(width)]
        label_idx = _parse_column_spec(
            getattr(cfg, "label_column", ""), names,
            counts_label=True, label_idx=-1)
        if label_idx is None:
            label_idx = 0
        weight_idx = _parse_column_spec(
            getattr(cfg, "weight_column", ""), names,
            counts_label=False, label_idx=label_idx)
        group_idx = _parse_column_spec(
            getattr(cfg, "group_column", ""), names,
            counts_label=False, label_idx=label_idx)
        if group_idx is not None:
            raise NotImplementedError(
                "chunked ingest does not support a group column "
                "(ranking shards are not in the v1 format)")
        ignore = _parse_index_list(
            getattr(cfg, "ignore_column", ""), names, label_idx)
        drop = {label_idx}
        if weight_idx is not None:
            drop.add(weight_idx)
        drop.update(ignore)
        self._width = width
        self._label_idx = label_idx
        self._weight_idx = weight_idx
        self._keep = [j for j in range(width) if j not in drop]
        self.feature_names = [names[j] for j in self._keep]
        self.num_features = len(self._keep)
        self.has_label = True
        # .weight sidecar beats an in-file weight column, matching
        # load_data_file's override order (metadata.cpp:632)
        self._sidecar_weight = _load_sidecar(self.path + ".weight",
                                             np.float64)
        for ext in (".query", ".group"):
            if os.path.exists(self.path + ext):
                raise NotImplementedError(
                    "chunked ingest does not support query/group "
                    f"sidecars ({self.path + ext})")

    def iter_chunks(self, chunk_rows: int) -> Iterator[Chunk]:
        row0 = 0
        buf: List[str] = []
        with open(self.path, "r", encoding="utf-8") as f:
            skip = self.has_header
            for ln in f:
                if skip:
                    skip = False
                    continue
                ln = ln.rstrip("\r\n")
                if not ln.strip():
                    continue
                buf.append(ln)
                if len(buf) >= chunk_rows:
                    yield self._emit(row0, buf)
                    row0 += len(buf)
                    buf = []
            if buf:
                yield self._emit(row0, buf)
                row0 += len(buf)
        self.num_rows = row0

    def _emit(self, row0: int, lines: List[str]) -> Chunk:
        from ..io import _parse_delimited
        mat = _parse_delimited([ln.encode("utf-8") for ln in lines],
                               self.delim)
        if mat.shape[1] > self._width:
            raise ValueError(
                f"ragged CSV: row block at {row0} has {mat.shape[1]} "
                f"columns, expected {self._width}")
        if mat.shape[1] < self._width:
            pad = np.full((mat.shape[0], self._width - mat.shape[1]),
                          np.nan)
            mat = np.concatenate([mat, pad], axis=1)
        label = mat[:, self._label_idx].copy()
        weight = None
        if self._sidecar_weight is not None:
            weight = self._sidecar_weight[row0:row0 + mat.shape[0]]
        elif self._weight_idx is not None:
            weight = mat[:, self._weight_idx].copy()
        return Chunk(row0, np.ascontiguousarray(mat[:, self._keep]),
                     label, weight)


def _stream_npz_member(zf: zipfile.ZipFile, name: str, chunk_rows: int):
    """Yield [r, F] blocks of a 2-D npz member without loading it whole.

    Reads the npy stream sequentially through the zip decompressor —
    peak memory is one chunk regardless of archive size."""
    with zf.open(name) as fp:
        version = np.lib.format.read_magic(fp)
        shape, fortran, dtype = np.lib.format._read_array_header(
            fp, version)
        if fortran:
            raise NotImplementedError(
                f"npz member {name!r} is Fortran-ordered; chunked "
                "streaming needs C row-major")
        if len(shape) != 2:
            raise ValueError(f"npz member {name!r} is not 2-D: {shape}")
        rows, cols = shape
        rowbytes = cols * dtype.itemsize
        done = 0
        while done < rows:
            take = min(chunk_rows, rows - done)
            raw = fp.read(take * rowbytes)
            if len(raw) != take * rowbytes:
                raise ValueError(f"npz member {name!r} truncated")
            yield np.frombuffer(raw, dtype=dtype).reshape(take, cols)
            done += take


def _npz_member_shape(zf: zipfile.ZipFile, name: str):
    with zf.open(name) as fp:
        version = np.lib.format.read_magic(fp)
        shape, _, dtype = np.lib.format._read_array_header(fp, version)
    return shape, dtype


class NpyChunkReader(ChunkReader):
    """``.npy`` (mmap) or ``.npz`` (streamed members) reader.

    For ``.npz`` the data member is ``X``/``data``/the first 2-D array;
    the label member is ``y``/``label``/``labels`` when present.  For
    ``.npy`` a label array can be supplied separately (``label=``)."""

    _X_KEYS = ("X", "x", "data", "features")
    _Y_KEYS = ("y", "label", "labels", "target")

    def __init__(self, path: str, label=None):
        self.path = str(path)
        self._npz = self.path.endswith(".npz")
        self._label_full = None
        if self._npz:
            self._zf = zipfile.ZipFile(self.path, "r")
            members = {os.path.splitext(n)[0]: n
                       for n in self._zf.namelist() if n.endswith(".npy")}
            self._xname = next(
                (members[k] for k in self._X_KEYS if k in members), None)
            if self._xname is None:
                for key, n in members.items():
                    shape, _ = _npz_member_shape(self._zf, n)
                    if len(shape) == 2:
                        self._xname = n
                        break
            if self._xname is None:
                raise ValueError(f"no 2-D array member found in {path}")
            shape, _ = _npz_member_shape(self._zf, self._xname)
            self.num_rows, self.num_features = int(shape[0]), int(shape[1])
            yname = next(
                (members[k] for k in self._Y_KEYS if k in members), None)
            if yname is not None:
                with self._zf.open(yname) as fp:
                    self._label_full = np.asarray(
                        np.lib.format.read_array(fp),
                        np.float64).ravel()
        else:
            self._mm = np.load(self.path, mmap_mode="r")
            if self._mm.ndim != 2:
                raise ValueError(f"{path} is not a 2-D array")
            self.num_rows, self.num_features = map(int, self._mm.shape)
        if label is not None:
            if isinstance(label, (str, os.PathLike)):
                label = np.load(str(label))
            self._label_full = np.asarray(label, np.float64).ravel()
        if self._label_full is not None:
            if len(self._label_full) != self.num_rows:
                raise ValueError(
                    f"label length {len(self._label_full)} != num rows "
                    f"{self.num_rows}")
            self.has_label = True
        self.feature_names = [f"Column_{i}"
                              for i in range(self.num_features)]

    def iter_chunks(self, chunk_rows: int) -> Iterator[Chunk]:
        def lab(lo, r):
            return (self._label_full[lo:lo + r]
                    if self._label_full is not None else None)
        if self._npz:
            row0 = 0
            for block in _stream_npz_member(self._zf, self._xname,
                                            chunk_rows):
                X = np.asarray(block, np.float64)
                yield Chunk(row0, X, lab(row0, X.shape[0]), None)
                row0 += X.shape[0]
        else:
            for lo in range(0, self.num_rows, chunk_rows):
                hi = min(lo + chunk_rows, self.num_rows)
                X = np.asarray(self._mm[lo:hi], np.float64)
                yield Chunk(lo, X, lab(lo, hi - lo), None)


class ArrayChunkReader(ChunkReader):
    """Slice an in-RAM array into chunks (fallback-path source)."""

    def __init__(self, X: np.ndarray, label=None, weight=None):
        self.X = X
        self.num_rows, self.num_features = map(int, X.shape)
        self._label = (np.asarray(label, np.float64).ravel()
                       if label is not None else None)
        self._weight = (np.asarray(weight, np.float64).ravel()
                        if weight is not None else None)
        self.has_label = self._label is not None
        self.feature_names = [f"Column_{i}"
                              for i in range(self.num_features)]

    def iter_chunks(self, chunk_rows: int) -> Iterator[Chunk]:
        for lo in range(0, self.num_rows, chunk_rows):
            hi = min(lo + chunk_rows, self.num_rows)
            yield Chunk(
                lo, np.asarray(self.X[lo:hi], np.float64),
                self._label[lo:hi] if self._label is not None else None,
                self._weight[lo:hi] if self._weight is not None else None)


class SequenceChunkReader(ChunkReader):
    """Stream ``Dataset`` Sequence objects as row blocks.

    ``__getitem__`` results pass through ``np.asarray`` so sequences
    returning non-contiguous views/strided slices are handled; each
    block is one slice call per sequence (the reference's push-rows
    batching), not a per-row gather."""

    def __init__(self, seqs):
        self.seqs = list(seqs) if isinstance(seqs, (list, tuple)) \
            else [seqs]
        self._lens = [len(s) for s in self.seqs]
        self.num_rows = int(sum(self._lens))
        self._starts = np.concatenate([[0], np.cumsum(self._lens)])
        first = np.asarray(self.seqs[0][0], dtype=np.float64)
        self.num_features = int(first.reshape(-1).shape[0])
        self.feature_names = [f"Column_{i}"
                              for i in range(self.num_features)]

    @staticmethod
    def _as_block(batch) -> np.ndarray:
        batch = np.asarray(batch, dtype=np.float64)
        if batch.ndim == 1:
            batch = batch[None, :]
        return np.ascontiguousarray(batch)

    def iter_chunks(self, chunk_rows: int) -> Iterator[Chunk]:
        row0 = 0
        for s in self.seqs:
            bs = int(getattr(s, "batch_size", 0) or chunk_rows)
            bs = min(max(1, bs), chunk_rows)
            for lo in range(0, len(s), bs):
                block = self._as_block(s[lo:lo + bs])
                yield Chunk(row0, block, None, None)
                row0 += block.shape[0]

    def read_rows_at(self, global_idx: np.ndarray) -> np.ndarray:
        """Gather arbitrary rows, batched per owning sequence (the
        sampled mapper fit calls this with a sorted random subset)."""
        global_idx = np.asarray(global_idx, np.int64)
        out = np.empty((len(global_idx), self.num_features), np.float64)
        owner = np.searchsorted(self._starts, global_idx,
                                side="right") - 1
        for si in np.unique(owner):
            sel = np.nonzero(owner == si)[0]
            local = global_idx[sel] - int(self._starts[si])
            seq = self.seqs[int(si)]
            # one __getitem__ per run of consecutive local rows: a
            # sorted sample is mostly runs, so this stays O(runs) calls
            runs = np.split(sel, np.nonzero(np.diff(local) != 1)[0] + 1)
            for run in runs:
                lo = int(local[np.searchsorted(sel, run[0])])
                block = self._as_block(seq[lo:lo + len(run)])
                out[run] = block
        return out


def open_chunk_reader(source, config=None, label=None) -> ChunkReader:
    """Dispatch a data source to its chunked reader."""
    if isinstance(source, (str, os.PathLike)):
        p = str(source)
        if p.endswith(".npy") or p.endswith(".npz"):
            return NpyChunkReader(p, label=label)
        return CsvChunkReader(p, config=config)
    if isinstance(source, np.ndarray):
        return ArrayChunkReader(source, label=label)
    from ..dataset import Sequence
    if isinstance(source, Sequence) or (
            isinstance(source, (list, tuple)) and source
            and all(isinstance(s, Sequence) for s in source)):
        return SequenceChunkReader(source)
    raise TypeError(
        f"no chunked reader for source type {type(source).__name__}")
