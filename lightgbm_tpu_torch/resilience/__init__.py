"""Resilience pieces of the port (a copy of what it needs from
``lightgbm_tpu/resilience/``)."""

from .checkpoint import prune_numbered
from .guards import NumericDivergenceError

__all__ = ["NumericDivergenceError", "prune_numbered"]
