"""The parallel tree learners' plans (the port of
``lightgbm_tpu/parallel/data_parallel.py``; the reference's
``data_parallel_tree_learner.cpp``, ``feature_parallel_tree_learner.cpp``
and ``voting_parallel_tree_learner.cpp``; SURVEY.md 2.3-2.4).

The JAX package shards one array over the devices of a mesh and runs a
``shard_map`` program; the port runs one process a rank
(``torch.distributed``), and each rank holds its own block of the rows.
A plan says how the rows are laid out and which collectives the builder
(``boosting/tree_builder.py``) issues, through ``parallel/comms.py``:

- ``DataParallelPlan`` (``tree_learner=data``): rows sharded, every
  rank builds its local ``[L, F, B, 3]`` histograms with kernel B1 and
  the histograms merge (``ops.histogram.merge_histograms``):
  ``allreduce`` gives every rank the full histogram and a replicated
  split search; ``reduce_scatter`` (the default at world > 1, the
  reference's algorithm) gives each rank its F_pad/W feature-slot
  block, which it searches alone, and the winners merge SplitInfo-sized
  (``_sync_best``).
- ``VotingParallelPlan`` (PV-Tree): rows sharded, local histograms;
  each rank votes its top-``top_k`` features a leaf, the votes are
  all-reduced and only the 2*top_k elected columns merge, under the
  same ``hist_merge`` choice.
- ``FeatureParallelPlan``: every rank holds every row, histograms only
  its feature block and no histogram collective runs; the winners merge.

A rank holds exactly the row block that the JAX ``shard_rows`` gives the
device of its index, so its local histograms, and the merged float
sums, are the JAX plan's. A rank's ``Dataset`` already holds that block
on the rank's device, so the JAX plans' placement helpers
(``shard_rows``, ``shard_bins``, ``shard_scores``,
``host_local_cols``), which assemble global arrays over a mesh, have no
counterpart here; ``gather_rows`` gives the global rows where a metric
needs them.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np

from .distributed import default_comm

__all__ = ["resolve_hist_merge", "HIST_MERGE_MODES", "DataParallelPlan",
           "VotingParallelPlan", "FeatureParallelPlan", "plan_class",
           "serial_reason", "learner_class"]

HIST_MERGE_MODES = ("auto", "allreduce", "reduce_scatter")


def resolve_hist_merge(mode: str, n_shards: int) -> str:
    """``dp_hist_merge`` -> a collective. ``LIGHTGBM_TPU_DP_HIST_MERGE``
    overrides the parameter; ``auto`` is ``reduce_scatter`` at world
    > 1 and ``allreduce`` on one rank (where both are no-ops)."""
    env = os.environ.get("LIGHTGBM_TPU_DP_HIST_MERGE", "")
    if env:
        mode = env
    if mode not in HIST_MERGE_MODES:
        raise ValueError(f"dp_hist_merge must be one of {HIST_MERGE_MODES},"
                         f" got {mode!r}")
    if mode == "auto":
        return "reduce_scatter" if n_shards > 1 else "allreduce"
    return mode


def plan_class(tree_learner: str):
    """``tree_learner`` -> the plan class (``auto`` and ``data``: the
    data-parallel plan), or None for ``serial``."""
    if tree_learner == "serial":
        return None
    return {"feature": FeatureParallelPlan,
            "voting": VotingParallelPlan}.get(tree_learner,
                                              DataParallelPlan)


def serial_reason(config) -> str:
    """The warning of an option that pins the serial learner ('' for
    none): CEGB and feature_contri (gbdt.py:200-210, the reference ties
    them to SerialTreeLearner) and linear trees (config.cpp:429)."""
    if (config.cegb_tradeoff < 1.0 or config.cegb_penalty_split > 0.0
            or config.cegb_penalty_feature_coupled
            or config.cegb_penalty_feature_lazy or config.feature_contri):
        return ("CEGB/feature_contri require the serial tree learner; "
                "forcing tree_learner=serial")
    if bool(config.linear_tree):
        return ("linear_tree requires the serial tree learner; forcing "
                "tree_learner=serial")
    return ""


def learner_class(config, world: int):
    """The plan class a run of ``config`` takes in a group of ``world``
    processes, or None (serial). ``Dataset`` reads it to decide whether
    a rank keeps only its block of rows, ``GBDT`` to build the plan."""
    if world <= 1 or serial_reason(config):
        return None
    return plan_class(str(config.tree_learner))


class DataParallelPlan:
    """Rows sharded over the ranks of ``comm`` (the default group when
    None), local histograms merged by ``hist_merge``."""

    parallel_mode = "data"
    rows_sharded = True

    def __init__(self, comm=None, top_k: int = 20,
                 hist_merge: str = "auto"):
        self.comm = comm if comm is not None else default_comm()
        self.num_shards = self.comm.world_size
        self.rank = self.comm.rank
        self.top_k = int(top_k)
        self.hist_merge = resolve_hist_merge(hist_merge, self.num_shards)

    def builder_kwargs(self) -> dict:
        return dict(comm=self.comm, parallel_mode=self.parallel_mode,
                    hist_merge=self.hist_merge, top_k=self.top_k)

    # -- row layout ----------------------------------------------------
    def pad_to(self, num_rows: int, block: int) -> int:
        """The GLOBAL padded row count, ``W x`` the local one. Every rank
        pads its block to the same size, with at least one padded row
        (a quantized run reads the padded rows' gradient, which the
        serial layout may hold, for its scales)."""
        local = (int(num_rows) // block + 1) * block
        if self.num_shards > 1:
            local = int(self.comm.gather_rows(
                np.asarray([local], np.int64)).max())
        return local * self.num_shards

    def local_rows(self, r_pad: int) -> int:
        """Rows of this rank in a ``r_pad``-row global layout."""
        return r_pad // self.num_shards

    def row_counts(self, num_rows: int) -> np.ndarray:
        """Every rank's real row count, in rank order."""
        return self.comm.gather_rows(np.asarray([num_rows], np.int64))

    def gather_rows(self, a: np.ndarray) -> np.ndarray:
        """Every rank's rows of ``a`` (axis 0), in rank order: the
        global array of a row-sharded field."""
        return self.comm.gather_rows(np.asarray(a))


class VotingParallelPlan(DataParallelPlan):
    """PV-Tree voting-parallel (voting_parallel_tree_learner.cpp:16-120):
    the data plan's row sharding; per round only votes and the elected
    columns cross ranks, O(top_k * B) instead of O(F * B)."""
    parallel_mode = "voting"


class FeatureParallelPlan:
    """Feature-parallel (feature_parallel_tree_learner.cpp:38-77): every
    rank holds ALL rows, histograms and searches its feature block, and
    the winner merges by a gain argmax across ranks, then every rank
    applies it. No histogram collective; one SplitInfo-sized merge a
    round."""

    parallel_mode = "feature"
    rows_sharded = False

    def __init__(self, comm=None, top_k: int = 20,
                 shard_storage: bool = False):
        self.comm = comm if comm is not None else default_comm()
        self.num_shards = self.comm.world_size
        self.rank = self.comm.rank
        self.top_k = int(top_k)
        self.hist_merge = ""
        self.shard_storage = bool(shard_storage)
        if self.num_shards > 1 and self.shard_storage:
            # the JAX package's rule: column sharding across processes
            # would need each process to load only its columns; every
            # worker holds the full matrix, as the reference's
            raise NotImplementedError(
                "feature_shard_storage is single-host; multi-host "
                "feature-parallel replicates the full matrix per "
                "worker (set feature_shard_storage=false)")

    def builder_kwargs(self) -> dict:
        return dict(comm=self.comm, parallel_mode="feature")

    def pad_to(self, num_rows: int, block: int) -> int:
        return -(-int(num_rows) // block) * block

    def local_rows(self, r_pad: int) -> int:
        return r_pad

    def row_counts(self, num_rows: int) -> np.ndarray:
        return np.asarray([num_rows], np.int64)

    def gather_rows(self, a: np.ndarray) -> np.ndarray:
        return np.asarray(a)
