"""Resilience pieces of the port (a copy of what it needs from
``lightgbm_tpu/resilience/``)."""

from .guards import NumericDivergenceError

__all__ = ["NumericDivergenceError"]
