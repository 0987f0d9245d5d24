"""Two-pass out-of-core ingest: stream → sketch → binned shards (a port
of ``lightgbm_tpu/data/ingest.py``; the shards are byte-for-byte the
JAX package's format).

``python -m lightgbm_tpu_torch ingest data=<csv|npy|npz> out=<dir>``
runs:

1. **Sketch pass** (phase ``ingest_sketch``): stream fixed-size row
   blocks through a :class:`~.sketch.SketchSet`, then fit
   ``BinMapper``s via :meth:`BinMapper.from_distinct`.  The fitted
   mapper state (+ an ingest fingerprint) is saved atomically to
   ``_mappers.npz`` in the output directory.
2. **Write pass** (phase ``ingest_write``): stream again, bin each
   block, and cut fixed ``ingest_rows_per_shard`` partitions into
   ``.lgbtpu`` shards (``shardfile.write_shard``; atomic rename).

Crash safety / idempotence: the partition is a pure function of
(total_rows, rows_per_shard), every shard write is atomic, and the
mapper sidecar is written before any shard.  A SIGKILL at any point
leaves only complete checksum-valid artifacts; re-running the same
ingest validates what exists (fingerprint + checksum) and rewrites
ONLY missing or invalid shards — completed shards are not touched.

Host memory is O(chunk): the raw matrix never materializes, binned
rows buffer at most one shard (``rows_per_shard × F`` bytes of uint8).

The write pass bins each block where ``device_type`` says (default
``cuda``, which raises without a GPU): on the card each block's values
go through ``torch.searchsorted``, bit-equal to the host's numpy
``searchsorted``. The sketch pass runs on the host in both cases.
"""

from __future__ import annotations

import io as _io
import os
from typing import Dict, List, Optional

import numpy as np

from .reader import ChunkReader, open_chunk_reader
from .shardfile import (SHARD_VERSION, ShardReader, list_shards,
                        shard_name, write_shard)
from .sketch import SketchSet

__all__ = ["ingest", "MAPPERS_SIDECAR", "resolve_categoricals",
           "ingest_fingerprint", "load_mappers_sidecar"]

MAPPERS_SIDECAR = "_mappers.npz"


def resolve_categoricals(cfg, names: List[str]) -> set:
    """``categorical_feature`` spec → raw feature indices (the
    Dataset._resolve_categoricals rules, minus pandas 'auto')."""
    spec = cfg.categorical_feature
    if not spec:
        return set()
    out = set()
    for tok in str(spec).split(","):
        tok = tok.strip()
        if not tok:
            continue
        if not tok.lstrip("-").isdigit():
            if tok in names:
                out.add(names.index(tok))
        else:
            out.add(int(tok))
    return out


def ingest_fingerprint(cfg, num_features: int, cat_idx: set) -> dict:
    """Binning-relevant parameters a shard set must agree on; reuse of
    sidecars/shards across runs is gated on an exact match."""
    return {
        "format_version": SHARD_VERSION,
        "num_features": int(num_features),
        "max_bin": int(cfg.max_bin),
        "max_bin_by_feature": [int(v) for v in
                               (cfg.max_bin_by_feature or [])],
        "min_data_in_bin": int(cfg.min_data_in_bin),
        "use_missing": bool(cfg.use_missing),
        "zero_as_missing": bool(cfg.zero_as_missing),
        "sketch_capacity": int(cfg.sketch_capacity),
        "rows_per_shard": int(cfg.ingest_rows_per_shard),
        "categorical": sorted(int(c) for c in cat_idx),
    }


def _save_mappers_sidecar(path: str, mappers, fingerprint: dict,
                          total_rows: int, sketch: SketchSet) -> None:
    import json
    from ..resilience.atomic_io import atomic_write_bytes
    from .shardfile import _mapper_state_sections
    payload = dict(_mapper_state_sections(mappers))
    payload["fingerprint_json"] = np.frombuffer(
        json.dumps(fingerprint, sort_keys=True).encode(), np.uint8)
    payload["total_rows"] = np.asarray([total_rows], np.int64)
    payload["max_level"] = np.asarray([sketch.max_level], np.int64)
    buf = _io.BytesIO()
    np.savez(buf, **payload)
    atomic_write_bytes(path, buf.getvalue())


def load_mappers_sidecar(path: str, fingerprint: Optional[dict] = None):
    """(mappers, total_rows, max_level) from ``_mappers.npz``, or None
    when missing/corrupt/fingerprint-mismatched."""
    import json
    from .shardfile import mappers_from_sections
    try:
        with np.load(path) as z:
            payload = {k: z[k] for k in z.files}
        got_fp = json.loads(bytes(
            payload["fingerprint_json"].tobytes()).decode())
        if fingerprint is not None and got_fp != json.loads(
                json.dumps(fingerprint, sort_keys=True)):
            return None
        mappers = mappers_from_sections(payload)
        return (mappers, int(payload["total_rows"][0]),
                int(payload["max_level"][0]))
    except (OSError, KeyError, ValueError):
        return None


def _valid_existing_shard(path: str, fingerprint: dict, row0: int,
                          num_rows: int) -> bool:
    try:
        r = ShardReader(path, verify=True)
    except Exception:
        return False
    ok = (r.header["fingerprint"] == fingerprint
          and r.row0 == row0 and r.num_rows == num_rows)
    r.close()
    return ok




def ingest(source, out_dir: str, params: Optional[Dict] = None,
           label=None, chunk_rows: Optional[int] = None,
           verbose: bool = True) -> dict:
    """Run the two-pass ingest; returns a summary dict."""
    import time

    from .. import phases
    from ..config import Config, resolve_device
    from ..dataset import bin_rows
    from ..profiler import phase
    from ..telemetry import events as _events

    cfg = Config(dict(params or {}))
    device = resolve_device(cfg.device_type)
    os.makedirs(out_dir, exist_ok=True)
    reader: ChunkReader = open_chunk_reader(source, cfg, label=label)
    F = reader.num_features
    names = reader.feature_names or [f"Column_{i}" for i in range(F)]
    cat_idx = resolve_categoricals(cfg, names)
    fingerprint = ingest_fingerprint(cfg, F, cat_idx)
    rows_per_shard = int(cfg.ingest_rows_per_shard)
    if chunk_rows is None:
        chunk_rows = max(1, min(rows_per_shard, 65536))
    sidecar = os.path.join(out_dir, MAPPERS_SIDECAR)

    def _say(msg):
        if verbose:
            print(f"[ingest] {msg}", flush=True)

    # -- pass 1: sketch (skipped when a matching sidecar exists) ------
    t0 = time.perf_counter()
    cached = load_mappers_sidecar(sidecar, fingerprint)
    if cached is not None:
        mappers, total_rows, max_level = cached
        _say(f"sketch pass skipped: reusing valid {MAPPERS_SIDECAR} "
             f"({total_rows} rows)")
    else:
        sketch = SketchSet(F, capacity=int(cfg.sketch_capacity),
                           cat_idx=cat_idx)
        with phase(phases.INGEST_SKETCH):
            for chunk in reader.iter_chunks(chunk_rows):
                sketch.update(chunk.X)
        total_rows = sketch.num_rows
        if total_rows == 0:
            raise ValueError("ingest source has no rows")
        mappers = sketch.fit_mappers(cfg)
        max_level = sketch.max_level
        _save_mappers_sidecar(sidecar, mappers, fingerprint,
                              total_rows, sketch)
        _say(f"sketch pass: {total_rows} rows, {F} features, "
             f"coarsen level {max_level} "
             f"({time.perf_counter() - t0:.2f}s)")
    used_features = np.asarray(
        [f for f, m in enumerate(mappers) if not m.is_trivial],
        np.int32)
    if len(used_features) == 0:
        raise ValueError("cannot ingest: all features are trivial "
                         "(single value)")
    max_num_bin = max(mappers[f].num_bin for f in used_features)
    dtype = np.uint8 if max_num_bin <= 256 else np.int32

    # -- pass 2: bin + write fixed partitions -------------------------
    num_shards = (total_rows + rows_per_shard - 1) // rows_per_shard
    reuse = []
    for si in range(num_shards):
        row0 = si * rows_per_shard
        nrows = min(rows_per_shard, total_rows - row0)
        p = os.path.join(out_dir, shard_name(si, num_shards))
        reuse.append(_valid_existing_shard(p, fingerprint, row0, nrows))
    written = 0
    t1 = time.perf_counter()
    if all(reuse):
        _say(f"write pass skipped: all {num_shards} shards valid")
    else:
        # per-shard accumulators: a chunk is split along shard
        # boundaries and only sub-ranges of NON-reused shards are
        # binned/buffered; a shard writes (atomically) the moment its
        # rows complete, so at most two partial shards are ever pending
        acc: Dict[int, dict] = {}
        chaos_kill = os.environ.get("LIGHTGBM_TPU_CHAOS_KILL_SHARD")
        chaos_kill = int(chaos_kill) if chaos_kill is not None else None

        def _write(si: int, ent: dict) -> None:
            nonlocal written
            row0 = si * rows_per_shard
            write_shard(
                os.path.join(out_dir, shard_name(si, num_shards)),
                bins=np.concatenate(ent["b"]), mappers=mappers,
                used_features=used_features, feature_names=names,
                row0=row0, shard_index=si, num_shards=num_shards,
                total_rows=total_rows,
                label=(np.concatenate(ent["l"]) if ent["l"] else None),
                weight=(np.concatenate(ent["w"]) if ent["w"] else None),
                fingerprint=fingerprint)
            written += 1
            if chaos_kill is not None and written == chaos_kill:
                # fault-injection hook (LIGHTGBM_TPU_CHAOS_KILL_SHARD): die
                # right after the Nth shard of this run lands — atomic
                # rename means nothing partial can survive us
                import signal as _signal
                os.kill(os.getpid(), _signal.SIGKILL)

        with phase(phases.INGEST_WRITE):
            seen_rows = 0
            for chunk in reader.iter_chunks(chunk_rows):
                r = chunk.X.shape[0]
                pos = 0
                while pos < r:
                    grow = chunk.row0 + pos
                    if grow >= total_rows:
                        raise ValueError(
                            "ingest source grew between passes: "
                            f"sketch saw {total_rows} rows")
                    si = grow // rows_per_shard
                    s_end = min((si + 1) * rows_per_shard, total_rows)
                    take = min(r - pos, s_end - grow)
                    if not reuse[si]:
                        ent = acc.setdefault(
                            si, {"b": [], "l": [], "w": [], "n": 0})
                        ent["b"].append(bin_rows(
                            chunk.X[pos:pos + take], mappers,
                            used_features, dtype, device))
                        if chunk.label is not None:
                            ent["l"].append(np.asarray(
                                chunk.label[pos:pos + take], np.float64))
                        if chunk.weight is not None:
                            ent["w"].append(np.asarray(
                                chunk.weight[pos:pos + take],
                                np.float64))
                        ent["n"] += take
                        if ent["n"] == s_end - si * rows_per_shard:
                            _write(si, acc.pop(si))
                    pos += take
                seen_rows += r
            if seen_rows != total_rows or acc:
                raise ValueError(
                    f"ingest source changed between passes: sketch "
                    f"saw {total_rows} rows, write pass saw "
                    f"{seen_rows} ({len(acc)} shards incomplete)")
        _say(f"write pass: {written}/{num_shards} shards written "
             f"({sum(reuse)} reused, "
             f"{time.perf_counter() - t1:.2f}s)")

    run_log = _events.active()
    if run_log is not None:
        run_log.append("ingest", action="complete", rows=int(total_rows),
                       shards=int(num_shards))
    return {
        "out_dir": out_dir,
        "total_rows": int(total_rows),
        "num_features": int(F),
        "num_used_features": int(len(used_features)),
        "num_shards": int(num_shards),
        "shards_written": int(written),
        "shards_reused": int(sum(reuse)),
        "max_num_bin": int(max_num_bin),
        "sketch_level": int(max_level),
        "rows_per_shard": rows_per_shard,
        "paths": list_shards(out_dir),
    }
