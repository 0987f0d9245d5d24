"""Distributed training on ``torch.distributed`` (SURVEY.md 2.3-2.4):
the data, feature and voting learners' plans, the process bootstrap and
the collective layer with its record of every call."""

from .comms import Comm, CommReport, hist_bytes_per_tree, render_table
from .data_parallel import (DataParallelPlan, FeatureParallelPlan,
                            VotingParallelPlan, resolve_hist_merge)
from .distributed import (init_distributed, maybe_init_distributed, rank,
                          world_size)

__all__ = ["Comm", "CommReport", "DataParallelPlan", "FeatureParallelPlan",
           "VotingParallelPlan", "hist_bytes_per_tree", "init_distributed",
           "maybe_init_distributed", "rank", "render_table",
           "resolve_hist_merge", "world_size"]
