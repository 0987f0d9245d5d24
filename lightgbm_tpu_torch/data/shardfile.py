"""The ``.lgbtpu`` binned shard format (a copy of
``lightgbm_tpu/data/shardfile.py``: the bytes are the JAX package's, so
either package reads the other's shards).

One shard = one contiguous global row range, already binned.  A
directory of shards is a dataset: every shard is self-describing
(mapper state, feature layout, global row extent), so any subset can
be validated or rebuilt independently — the property the crash-safe
ingest retry and the multi-process loaders lean on.

Layout (little-endian)::

    [0:8)    magic  b"LGBTPU1\\0"
    [8:16)   uint64 header JSON length
    [16:..)  header JSON (utf-8), then zero padding to 64-byte
             alignment
    sections 64-byte aligned, each described in the header as
             {"offset", "dtype", "shape"}:
               bins            uint8/int32 [num_rows, F_used] row-major
               label           float64 [num_rows]      (optional)
               weight          float64 [num_rows]      (optional)
               mapper_scalars  int64  [F_total, 6]  (BinMapper.state_arrays)
               mapper_ub       float64 flat + mapper_ub_offsets
               mapper_cats     int64  flat  + mapper_cats_offsets
    [-32:]   SHA-256 of everything before it

The header also carries a ``row_blocks`` index — ``[row_start,
byte_offset]`` pairs every ``rows_per_block`` rows into the bins
section — so a consumer can mmap the file and address any row block
without arithmetic on trust; ``ShardReader.bins`` returns a view over
the mmap, so touching one chunk faults in only that chunk.

Writes go through ``resilience.atomic_io.atomic_write_bytes``
(mkstemp + fsync + rename): a SIGKILL mid-ingest can only ever leave
complete, checksum-valid shards plus ignorable temp files.
"""

from __future__ import annotations

import glob
import hashlib
import json
import os
import re
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..binning import BinMapper

__all__ = ["SHARD_MAGIC", "SHARD_VERSION", "SHARD_SUFFIX", "ShardReader",
           "write_shard", "shard_name", "list_shards", "is_shard_path",
           "ShardFormatError"]

SHARD_MAGIC = b"LGBTPU1\x00"
SHARD_VERSION = 1
SHARD_SUFFIX = ".lgbtpu"
_ALIGN = 64
_DIGEST = 32  # sha256

_NAME_RE = re.compile(r"^shard-(\d{5})-of-(\d{5})\.lgbtpu$")


class ShardFormatError(ValueError):
    """Raised for missing magic, bad checksum, or malformed headers."""


def shard_name(index: int, num_shards: int) -> str:
    return f"shard-{index:05d}-of-{num_shards:05d}{SHARD_SUFFIX}"


def list_shards(directory: str) -> List[str]:
    """Shard paths in ``directory``, ordered by shard index."""
    out = []
    for p in glob.glob(os.path.join(directory, "*" + SHARD_SUFFIX)):
        m = _NAME_RE.match(os.path.basename(p))
        if m:
            out.append((int(m.group(1)), p))
    return [p for _, p in sorted(out)]


def is_shard_path(path) -> bool:
    """True for a ``.lgbtpu`` file or a directory holding shards."""
    if not isinstance(path, (str, os.PathLike)):
        return False
    p = str(path)
    if p.endswith(SHARD_SUFFIX):
        return os.path.isfile(p)
    return os.path.isdir(p) and bool(list_shards(p))


def _align(n: int) -> int:
    return (n + _ALIGN - 1) // _ALIGN * _ALIGN


def _mapper_state_sections(mappers: List[BinMapper]):
    scalars, ubs, cats = [], [], []
    for m in mappers:
        s, u, c = m.state_arrays()
        scalars.append(s)
        ubs.append(u)
        cats.append(c)
    ub_off = np.concatenate(
        [[0], np.cumsum([len(u) for u in ubs])]).astype(np.int64)
    cat_off = np.concatenate(
        [[0], np.cumsum([len(c) for c in cats])]).astype(np.int64)
    return {
        "mapper_scalars": np.stack(scalars).astype(np.int64),
        "mapper_ub": (np.concatenate(ubs) if ubs
                      else np.empty(0, np.float64)),
        "mapper_ub_offsets": ub_off,
        "mapper_cats": (np.concatenate(cats).astype(np.int64) if cats
                        else np.empty(0, np.int64)),
        "mapper_cats_offsets": cat_off,
    }


def mappers_from_sections(sections: Dict[str, np.ndarray]) \
        -> List[BinMapper]:
    scal = np.asarray(sections["mapper_scalars"], np.int64)
    ub = np.asarray(sections["mapper_ub"], np.float64)
    uo = np.asarray(sections["mapper_ub_offsets"], np.int64)
    cats = np.asarray(sections["mapper_cats"], np.int64)
    co = np.asarray(sections["mapper_cats_offsets"], np.int64)
    return [BinMapper.from_state_arrays(
        scal[f], ub[uo[f]:uo[f + 1]], cats[co[f]:co[f + 1]])
        for f in range(len(scal))]


def write_shard(path: str, *, bins: np.ndarray,
                mappers: List[BinMapper],
                used_features: np.ndarray,
                feature_names: List[str],
                row0: int, shard_index: int, num_shards: int,
                total_rows: int,
                label: Optional[np.ndarray] = None,
                weight: Optional[np.ndarray] = None,
                fingerprint: Optional[dict] = None,
                rows_per_block: int = 4096) -> str:
    """Serialize one shard and atomically publish it at ``path``."""
    from ..resilience.atomic_io import atomic_write_bytes
    bins = np.ascontiguousarray(bins)
    if bins.dtype not in (np.dtype(np.uint8), np.dtype(np.int32)):
        raise ValueError(f"bins dtype must be uint8/int32, got "
                         f"{bins.dtype}")
    num_rows, width = bins.shape
    arrays: Dict[str, np.ndarray] = {"bins": bins}
    if label is not None:
        arrays["label"] = np.ascontiguousarray(label, np.float64)
        if len(arrays["label"]) != num_rows:
            raise ValueError("label length != shard rows")
    if weight is not None:
        arrays["weight"] = np.ascontiguousarray(weight, np.float64)
        if len(arrays["weight"]) != num_rows:
            raise ValueError("weight length != shard rows")
    arrays.update(_mapper_state_sections(mappers))

    rowbytes = width * bins.dtype.itemsize
    row_blocks = [[int(r), int(r * rowbytes)]
                  for r in range(0, max(num_rows, 1), rows_per_block)]
    header = {
        "version": SHARD_VERSION,
        "num_rows": int(num_rows),
        "row0": int(row0),
        "shard_index": int(shard_index),
        "num_shards": int(num_shards),
        "total_rows": int(total_rows),
        "num_total_features": len(mappers),
        "used_features": [int(f) for f in used_features],
        "feature_names": list(feature_names),
        "max_num_bin": int(max(
            (mappers[f].num_bin for f in used_features), default=1)),
        "bin_dtype": bins.dtype.name,
        "rows_per_block": int(rows_per_block),
        "row_blocks": row_blocks,
        "has_label": label is not None,
        "has_weight": weight is not None,
        "fingerprint": fingerprint or {},
        "sections": {},
    }
    # lay out sections: offsets depend on the header length, which
    # depends on the offsets — fix by padding the header to a stable
    # size first (offsets only shrink the pad, never move sections)
    probe = dict(header)
    probe["sections"] = {
        k: {"offset": 2 ** 62, "dtype": a.dtype.name,
            "shape": list(a.shape)} for k, a in arrays.items()}
    hdr_len = len(json.dumps(probe).encode()) + _ALIGN
    base = _align(16 + hdr_len)
    off = base
    for k, a in arrays.items():
        header["sections"][k] = {"offset": off, "dtype": a.dtype.name,
                                 "shape": list(a.shape)}
        off = _align(off + a.nbytes)
    hdr = json.dumps(header).encode()
    if len(hdr) > hdr_len:  # can't happen: real offsets print shorter
        raise AssertionError("shard header overflow")
    buf = bytearray(off + _DIGEST)
    buf[0:8] = SHARD_MAGIC
    buf[8:16] = np.uint64(len(hdr)).tobytes()
    buf[16:16 + len(hdr)] = hdr
    for k, a in arrays.items():
        o = header["sections"][k]["offset"]
        buf[o:o + a.nbytes] = a.tobytes()
    buf[-_DIGEST:] = hashlib.sha256(bytes(buf[:-_DIGEST])).digest()
    atomic_write_bytes(path, bytes(buf))
    return path


def verify_shard(path: str) -> bool:
    """True iff the file is a complete, checksum-valid shard."""
    try:
        ShardReader(path, verify=True).close()
        return True
    except (ShardFormatError, OSError, ValueError):
        return False


class ShardReader:
    """mmap-backed reader for one ``.lgbtpu`` file."""

    def __init__(self, path: str, verify: bool = True):
        self.path = str(path)
        size = os.path.getsize(self.path)
        if size < 16 + _DIGEST:
            raise ShardFormatError(f"{path}: too short to be a shard")
        self._mm = np.memmap(self.path, dtype=np.uint8, mode="r")
        if bytes(self._mm[0:8]) != SHARD_MAGIC:
            raise ShardFormatError(f"{path}: bad magic")
        hdr_len = int(np.frombuffer(self._mm[8:16], np.uint64)[0])
        if 16 + hdr_len > size - _DIGEST:
            raise ShardFormatError(f"{path}: header overruns file")
        try:
            self.header = json.loads(bytes(self._mm[16:16 + hdr_len]))
        except ValueError as e:
            raise ShardFormatError(f"{path}: bad header: {e}") from None
        if self.header.get("version") != SHARD_VERSION:
            raise ShardFormatError(
                f"{path}: unsupported shard version "
                f"{self.header.get('version')}")
        if verify:
            h = hashlib.sha256()
            step = 1 << 24
            for lo in range(0, size - _DIGEST, step):
                h.update(self._mm[lo:min(lo + step, size - _DIGEST)])
            if h.digest() != bytes(self._mm[-_DIGEST:]):
                raise ShardFormatError(f"{path}: checksum mismatch")
        for name, sec in self.header["sections"].items():
            nbytes = int(np.prod(sec["shape"]) *
                         np.dtype(sec["dtype"]).itemsize)
            if sec["offset"] + nbytes > size - _DIGEST:
                raise ShardFormatError(
                    f"{path}: section {name} overruns file")

    # -- section access ------------------------------------------------
    def _section(self, name: str) -> Optional[np.ndarray]:
        sec = self.header["sections"].get(name)
        if sec is None:
            return None
        dt = np.dtype(sec["dtype"])
        n = int(np.prod(sec["shape"]))
        o = int(sec["offset"])
        flat = self._mm[o:o + n * dt.itemsize].view(dt)
        return flat.reshape(sec["shape"])

    @property
    def num_rows(self) -> int:
        return int(self.header["num_rows"])

    @property
    def row0(self) -> int:
        return int(self.header["row0"])

    @property
    def bins(self) -> np.ndarray:
        """[num_rows, F_used] mmap-backed view (no copy)."""
        return self._section("bins")

    def read_rows(self, lo: int, hi: int) -> np.ndarray:
        """Copy of shard-local rows [lo, hi)."""
        return np.array(self.bins[lo:hi])

    @property
    def label(self) -> Optional[np.ndarray]:
        return self._section("label")

    @property
    def weight(self) -> Optional[np.ndarray]:
        return self._section("weight")

    def mappers(self) -> List[BinMapper]:
        return mappers_from_sections(
            {k: self._section(k) for k in
             ("mapper_scalars", "mapper_ub", "mapper_ub_offsets",
              "mapper_cats", "mapper_cats_offsets")})

    def close(self) -> None:
        mm = getattr(self, "_mm", None)
        if mm is not None:
            del self._mm


def open_shard_dir(path: str, verify: bool = True) \
        -> Tuple[List[ShardReader], dict]:
    """Open every shard of a dataset directory (or a single file).

    Validates that the set is complete and mutually consistent: all
    indices present, row extents contiguous, identical fingerprints.
    Returns (readers ordered by row0, shared header of shard 0)."""
    paths = [str(path)] if str(path).endswith(SHARD_SUFFIX) \
        else list_shards(str(path))
    if not paths:
        raise ShardFormatError(f"no {SHARD_SUFFIX} shards under {path}")
    readers = [ShardReader(p, verify=verify) for p in paths]
    readers.sort(key=lambda r: r.row0)
    h0 = readers[0].header
    n = int(h0["num_shards"])
    seen = sorted(int(r.header["shard_index"]) for r in readers)
    if seen != list(range(n)):
        raise ShardFormatError(
            f"{path}: incomplete shard set — have indices {seen}, "
            f"expected 0..{n - 1}")
    row = 0
    for r in readers:
        if r.row0 != row:
            raise ShardFormatError(
                f"{r.path}: row0 {r.row0} != expected {row}")
        if r.header["fingerprint"] != h0["fingerprint"] or \
                r.header["used_features"] != h0["used_features"]:
            raise ShardFormatError(
                f"{r.path}: shard metadata disagrees with "
                f"{readers[0].path}")
        row += r.num_rows
    if row != int(h0["total_rows"]):
        raise ShardFormatError(
            f"{path}: shards cover {row} rows, header says "
            f"{h0['total_rows']}")
    return readers, h0
