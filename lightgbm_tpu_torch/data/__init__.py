"""Out-of-core data of the port (``lightgbm_tpu/data/``):

- :mod:`.reader` — chunked readers (CSV/TSV, ``.npy``/``.npz``, arrays,
  ``Sequence`` objects) yielding fixed-size row blocks;
- :mod:`.sketch` — mergeable per-feature quantile sketches, feeding
  ``BinMapper.from_distinct``;
- :mod:`.shardfile` — the versioned, checksummed, mmap-able ``.lgbtpu``
  binned shard format (the JAX package's bytes);
- :mod:`.ingest` — the two-pass (sketch, then bin and write) ingest
  behind ``python -m lightgbm_tpu_torch ingest``;
- :mod:`.prefetch` — the pinned-host double buffer that stages row
  chunks onto the card on a stream of its own;
- :mod:`.chunked` — the chunk sources and the chunked tree builder
  (kernel B1 with a carried accumulator a chunk).
"""

from .chunked import ArraySource, ChunkedTreeBuilder, ShardSource
from .ingest import ingest
from .prefetch import ChunkPrefetcher, PrefetchStats, chunk_rows_for
from .reader import open_chunk_reader
from .shardfile import (SHARD_SUFFIX, ShardFormatError, ShardReader,
                        is_shard_path, list_shards, open_shard_dir,
                        write_shard)
from .sketch import FeatureSketch, SketchSet

__all__ = ["ArraySource", "ChunkedTreeBuilder", "ShardSource", "ingest",
           "ChunkPrefetcher", "PrefetchStats", "chunk_rows_for",
           "open_chunk_reader", "SHARD_SUFFIX", "ShardFormatError",
           "ShardReader", "is_shard_path", "list_shards", "open_shard_dir",
           "write_shard", "FeatureSketch", "SketchSet"]
