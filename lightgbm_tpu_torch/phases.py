"""Canonical profiler phase names — ONE source of truth (a copy of
``lightgbm_tpu/phases.py``: the same names and :data:`KNOWN_PHASES`,
so both packages' event logs and traces name their phases alike).

``profiler.phase`` emits these as ``torch.profiler.record_function``
ranges and checks membership in :data:`KNOWN_PHASES` when a span opens,
so a renamed phase is an immediate ValueError instead of a span that no
consumer (the ``/trace`` summary's phase table, the event log's
``phase_s``) can account for. The collective phases are opened by
``ops.histogram.merge_histograms`` and the builder's ``_sync_best``,
and name the calls of ``parallel/comms.py``'s record.
"""

from __future__ import annotations

__all__ = ["GRADS", "SAMPLING", "BUILD", "UPDATE", "EVAL",
           "INGEST_SKETCH", "INGEST_WRITE", "PREFETCH",
           "HIST_MERGE", "WINNER_SYNC", "TRAIN_PHASES",
           "INGEST_PHASES", "COLLECTIVE_PHASES", "KNOWN_PHASES"]

# training phases (both drivers, boosting/gbdt.py + engine.train's eval)
GRADS = "grads"
SAMPLING = "sampling"
BUILD = "build"
UPDATE = "update"
EVAL = "eval"

# out-of-core ingest/streaming phases (data/ingest.py sketch + shard
# write passes; data/prefetch.py host->device staging during chunked
# training)
INGEST_SKETCH = "ingest_sketch"
INGEST_WRITE = "ingest_write"
PREFETCH = "prefetch"

# collective phases (the JAX package's ops/histogram.merge_histograms,
# boosting/tree_builder._sync_best)
HIST_MERGE = "hist_merge"
WINNER_SYNC = "winner_sync"

TRAIN_PHASES = frozenset({GRADS, SAMPLING, BUILD, UPDATE, EVAL})
INGEST_PHASES = frozenset({INGEST_SKETCH, INGEST_WRITE, PREFETCH})
COLLECTIVE_PHASES = frozenset({HIST_MERGE, WINNER_SYNC})
KNOWN_PHASES = TRAIN_PHASES | INGEST_PHASES | COLLECTIVE_PHASES
